"""Port parity: the cross-silo wire (``fedml_tpu_torch/comm``) and the
secure-aggregation primitives (``fedml_tpu_torch/trust/secagg``) against
``fedml_tpu/comm`` and ``fedml_tpu/trust/secagg``.

Everything here is exact: frames are byte-identical, the field, Shamir,
mask and ring-packing primitives bitwise equal on the same seeds (both
packages run the same numpy code).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _flax_resnet20_tree():
    """Full-width ResNet-20 variables from the reference's flax init, as the
    numpy tree the wire carries."""
    import jax

    from fedml_tpu.models import resnet as flax_resnet

    model = flax_resnet.resnet20(10)
    variables = model.init(jax.random.PRNGKey(3), np.zeros((1, 32, 32, 3), np.float32),
                           train=False)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(dict(variables)))


def _control(msg, round_idx=2):
    msg.add_params("round_idx", round_idx)
    msg.add_params("num_samples", 12500.0)
    msg.add_params("client_idx", 3)
    msg.add_params("secagg_meta", {"codec": "dense", "ring_bits": 31, "frac_bits": 16,
                                   "length": 269722, "delta": False})
    msg.add_params("pk_table", {"1": [11, 12], "2": [21, 22]})
    return msg


def test_model_message_bytes_equal_the_reference():
    """A model message (flax-layout ResNet-20 weights carried through the
    port's layout and back) encodes to the reference's bytes, and each
    package decodes the other's frame."""
    from fedml_tpu.comm.message import Message as RefMessage
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.comm.message import Message

    flax_tree = _flax_resnet20_tree()
    port_tree = weights.to_torch(weights.flax_to_torch(flax_tree))
    wire_tree = weights.torch_to_flax(weights.to_numpy(port_tree))

    ref = _control(RefMessage(2, 0, 3))
    ref.add_params("model_params", flax_tree)
    msg = _control(Message(2, 0, 3))
    msg.add_params("model_params", wire_tree)
    data = msg.encode()
    assert data == ref.encode()

    got = RefMessage.decode(data)
    assert got.get_type() == 2 and got.get_receiver_id() == 3
    back = Message.decode(ref.encode())
    assert back.wire_nbytes == len(data)
    assert back.get_control("secagg_meta")["length"] == 269722
    assert back.get_control("model_params") is None  # tensors stay lazy
    import jax

    for a, b in zip(jax.tree_util.tree_leaves(back.get("model_params")),
                    jax.tree_util.tree_leaves(flax_tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("payload", ["u32_ring", "int64_field", "control_only", "mixed_tree"])
def test_secagg_message_bytes_equal_the_reference(payload):
    """The other frames of the protocol: a packed ring upload, a buffer-all
    int64 upload, a control-only status message, a tree of int arrays."""
    from fedml_tpu.comm.message import Message as RefMessage
    from fedml_tpu_torch.comm.message import Message

    rs = np.random.RandomState(5)
    value = {
        "u32_ring": rs.randint(0, 2**31 - 1, size=4099).astype("<u4"),
        "int64_field": rs.randint(0, 2**31 - 1, size=1000).astype(np.int64),
        "control_only": "ONLINE",
        "mixed_tree": {"b": [np.arange(3, dtype=np.int32), np.float32(2.5) * np.ones((2, 2))],
                       "a": (np.zeros(0, np.float32), np.array(7, np.int64))},
    }[payload]
    frames = []
    for cls in (RefMessage, Message):
        m = cls(14, 2, 0)
        m.add_params("value", value)
        m.add_params("round_idx", 0)
        frames.append(m.encode())
    assert frames[0] == frames[1]
    back = Message.decode(frames[0])
    got = back.get("value")
    if payload == "control_only":
        assert got == "ONLINE"
    elif payload == "mixed_tree":
        assert np.array_equal(got["b"][0], value["b"][0]) and got["a"][1] == 7
        assert got["a"][0].shape == (0,) and isinstance(got["a"], tuple)
    else:
        assert got.dtype == value.dtype and np.array_equal(got, value)


def test_wire_frames_and_refusals():
    """``encode_pytree`` bytes equal the reference's; a v2 (compressed-leaf)
    frame encodes to the reference's bytes and decodes as the reference
    decodes it; a truncated frame, an unknown version and a tensor leaf
    raise."""
    from fedml_tpu.comm import wire as ref_wire
    from fedml_tpu_torch.comm import wire

    tree = {"z": np.arange(6, dtype=np.float32).reshape(2, 3), "a": [np.int64(4)]}
    data = wire.encode_pytree(tree)
    assert data == ref_wire.encode_pytree(tree)
    assert wire.flatten_with_skeleton(tree)[0] == ref_wire.flatten_with_skeleton(tree)[0]
    out = wire.decode_pytree(data)
    assert np.array_equal(out["z"], tree["z"]) and out["a"][0] == 4
    with pytest.raises(ValueError, match="payload length"):
        wire.decode_header(data[:-1])
    compressed = ref_wire.encode_pytree(
        {"w": ref_wire.CompressedLeaf("qsgd8", "float32", (4,), {"blocks": 1, "length": 4},
                                      (np.ones(1, np.float32), np.zeros(1024, np.int8)))})
    assert wire.encode_pytree(
        {"w": wire.CompressedLeaf("qsgd8", "float32", (4,), {"blocks": 1, "length": 4},
                                  (np.ones(1, np.float32), np.zeros(1024, np.int8)))}) == compressed
    header, _ = wire.decode_header(compressed)
    assert header["version"] == 2 and header["leaves"][0]["codec"] == "qsgd8"
    got, want = wire.decode_pytree(compressed)["w"], ref_wire.decode_pytree(compressed)["w"]
    assert got.dtype == want.dtype and np.array_equal(got, want) and got.shape == (4,)
    bad = bytearray(data)
    bad[4:4 + len(b'{"version":1')] = b'{"version":3'
    with pytest.raises(ValueError, match="unsupported wire version 3"):
        wire.decode_header(bytes(bad))
    with pytest.raises(TypeError, match="numpy"):
        wire.encode_pytree({"w": torch.zeros(3)})


def test_backoff_and_codec_config_match_the_reference():
    from fedml_tpu.comm import base as ref_base
    from fedml_tpu_torch.comm import base, codecs
    from fedml_tpu_torch.arguments import Config

    assert base.BACKOFF_PURPOSE_STATUS_PROBE == ref_base.BACKOFF_PURPOSE_STATUS_PROBE
    for attempt in range(6):
        kw = dict(base=0.1, cap=1.0, purpose=base.BACKOFF_PURPOSE_STATUS_PROBE)
        assert base.backoff_delay(attempt, **kw) == ref_base.backoff_delay(attempt, **kw)
    assert codecs.codec_from_config(Config()) is None
    assert codecs.codec_from_config(Config(extra={"comm_compression": "off"})) is None
    for name in ("qsgd8", "topk"):
        assert codecs.codec_from_config(Config(extra={"comm_compression": name})) == name
        assert codecs.codec_from_config(Config(extra={"comm_compression": name.upper()})) == name
    with pytest.raises(ValueError, match="unknown comm_compression"):
        codecs.codec_from_config(Config(extra={"comm_compression": "zstd"}))


# -- the secure-aggregation primitives ------------------------------------------

def test_field_quantize_and_inverse_bitwise():
    from fedml_tpu.trust.secagg import field as ref
    from fedml_tpu_torch.trust.secagg import field

    x = np.random.default_rng(0).normal(0, 3, 5000).astype(np.float32)
    for bits in (8, 16, 20):
        q = field.quantize_to_field(x, bits=bits)
        assert q.dtype == np.int64 and np.array_equal(q, ref.quantize_to_field(x, bits=bits))
        for n in (1, 4):
            assert np.array_equal(field.dequantize_from_field(q * n, n, bits=bits),
                                  ref.dequantize_from_field(q * n, n, bits=bits))
    for a in (1, 2, 12345, 2**31 - 2):
        assert field.mod_inverse(a) == ref.mod_inverse(a)


def test_shamir_share_reconstruct_and_masks_bitwise():
    from fedml_tpu.trust.secagg import shamir as ref
    from fedml_tpu_torch.trust.secagg import shamir

    for secret, n, t in ((123456789, 4, 3), (2**31 - 5, 7, 4), (0, 3, 2)):
        a = shamir.shamir_share(secret, n, t, np.random.RandomState(9))
        b = ref.shamir_share(secret, n, t, np.random.RandomState(9))
        assert a == b
        assert shamir.shamir_reconstruct(a[:t]) == ref.shamir_reconstruct(b[:t]) == secret
        assert shamir.shamir_reconstruct(a[-t:]) == secret
    d = 3001
    x = np.random.RandomState(1).randint(0, 2**31 - 1, size=d).astype(np.int64)
    assert np.array_equal(shamir.pairwise_mask(77, d), ref.pairwise_mask(77, d))
    seeds = {1: 11, 3: 13, 4: 14}
    masked = {u: shamir.masked_input(x + u, u, {v: 100 + u * v for v in (1, 2, 3) if v != u},
                                     500 + u) for u in (1, 2, 3)}
    for u in (1, 2, 3):
        assert np.array_equal(masked[u], ref.masked_input(
            x + u, u, {v: 100 + u * v for v in (1, 2, 3) if v != u}, 500 + u))
    self_seeds = {u: 500 + u for u in (1, 2, 3)}
    total = shamir.unmask_sum(masked, self_seeds, {})
    assert np.array_equal(total, ref.unmask_sum(masked, self_seeds, {}))
    assert np.array_equal(total, (3 * x + 6) % (2**31 - 1))  # the masks cancel
    dropped = {(4, 1): 21, (4, 3): 23}
    assert np.array_equal(shamir.unmask_sum(masked, seeds, dropped),
                          ref.unmask_sum(masked, seeds, dropped))


@pytest.mark.parametrize("bits", [8, 16, 19, 24, 31, 32])
def test_pack_unpack_ring_every_width_bitwise(bits):
    from fedml_tpu.trust.secagg import stream as ref
    from fedml_tpu_torch.trust.secagg import stream

    length = 2053
    vec = np.random.RandomState(bits).randint(0, 2**bits, size=length, dtype=np.int64)
    packed = stream.pack_ring(vec, bits)
    want = ref.pack_ring(vec, bits)
    assert packed.dtype == want.dtype and packed.tobytes() == want.tobytes()
    assert packed.nbytes == length * {8: 1, 16: 2, 19: 3, 24: 3, 31: 4, 32: 4}[bits]
    back = stream.unpack_ring(packed, bits, length)
    assert np.array_equal(back, vec) and np.array_equal(back, ref.unpack_ring(want, bits, length))
    with pytest.raises(ValueError):
        stream.unpack_ring(packed, bits, length + 1)


def test_ring_masks_and_streaming_sum_bitwise():
    """``ring_for`` / ``ring_mask`` / ``mask_vector`` / ``unmask_ring_total``
    and ``StreamingMaskedSum`` with a dropout: bitwise the reference's, and
    the unmasked total is the plain sum."""
    from fedml_tpu.trust.secagg import stream as ref
    from fedml_tpu_torch.trust.secagg import stream

    for codec in (None, "qsgd8"):
        a = stream.ring_for(codec, 4, q_bits=16, q8_frac_bits=7)
        b = ref.ring_for(codec, 4, q_bits=16, q8_frac_bits=7)
        assert (a.codec, a.modulus, a.bits, a.frac_bits) == (b.codec, b.modulus, b.bits,
                                                             b.frac_bits)
        assert a.meta(10) == b.meta(10) and a.matches(b.meta(10))
    ring = stream.ring_for(None, 4, q_bits=16, q8_frac_bits=7)
    rref = ref.ring_for(None, 4, q_bits=16, q8_frac_bits=7)
    d, mod = 4097, ring.modulus
    assert np.array_equal(stream.ring_mask(42, d, mod), ref.ring_mask(42, d, mod))
    rs = np.random.RandomState(2)
    xs = {u: rs.randint(-2**20, 2**20, size=d).astype(np.int64) % mod for u in (1, 2, 3, 4)}
    pair = {(u, v): 1000 * min(u, v) + max(u, v) for u in xs for v in xs if u != v}
    masked = {}
    for u, x in xs.items():
        peers = {v: pair[(u, v)] for v in xs if v != u}
        masked[u] = stream.mask_vector(x, u, peers, 700 + u, mod)
        assert np.array_equal(masked[u], ref.mask_vector(x, u, peers, 700 + u, mod))
    survivors = (1, 2, 4)  # client 3 dropped before its upload
    port, want = stream.StreamingMaskedSum(d, ring), ref.StreamingMaskedSum(d, rref)
    for u in survivors:
        port.fold(masked[u])
        want.fold(masked[u])
    assert np.array_equal(port.masked_total(), want.masked_total())
    self_seeds = {u: 700 + u for u in survivors}
    dropped = {(3, v): pair[(3, v)] for v in survivors}
    total = port.finalize(self_seeds, dropped)
    assert np.array_equal(total, want.finalize(self_seeds, dropped))
    plain = sum(np.where(xs[u] > mod // 2, xs[u] - mod, xs[u]) for u in survivors)
    assert np.array_equal(total, plain)
    assert port.peak_buffered == want.peak_buffered == 2
    raw = stream.unmask_ring_total(port.masked_total(), self_seeds, dropped, mod)
    assert np.array_equal(raw, ref.unmask_ring_total(want.masked_total(), self_seeds, dropped,
                                                     mod))


def test_field_stream_accumulator_lazy_reduction_bitwise():
    from fedml_tpu.parallel.stream_fold import FieldStreamAccumulator as Ref
    from fedml_tpu_torch.trust.secagg.stream import FieldStreamAccumulator

    mod = 2**31 - 1
    rs = np.random.RandomState(4)
    leaves = [rs.randint(0, mod, size=(7, 5)).astype(np.int64),
              rs.randint(0, mod, size=11).astype(np.int64)]
    a = FieldStreamAccumulator([np.zeros(l.shape) for l in leaves], mod)
    b = Ref([np.zeros(l.shape) for l in leaves], mod)
    a._reduce_every = b._reduce_every = 3  # exercise the lazy reduce
    for k in range(7):
        for i, leaf in enumerate(leaves):
            a.fold_leaf(i, (leaf * (k + 1)) % mod)
            b.fold_leaf(i, (leaf * (k + 1)) % mod)
    for x, y, leaf in zip(a.host_sums(), b.host_sums(), leaves):
        assert np.array_equal(x, y) and np.array_equal(x, (leaf * 28) % mod)
