"""Port parity: wire v2 and the upload codecs (``fedml_tpu_torch/comm/wire.py``,
``fedml_tpu_torch/comm/codecs.py``) against ``fedml_tpu/comm``.

Tolerances:

- frames (v1, v2, chunked, streamed): **byte-identical**; decodes bitwise.
- ``compress_pytree`` qsgd8, the reference's uniform draws handed in: the
  frame is **byte-identical** to the reference's ``compress_pytree`` with the
  reference's quantizer as its eager jnp oracle (``quantize_int8_reference``,
  IEEE divides, as the port's plain version and CUDA kernel divide).  The
  reference's own path runs its Pallas kernel in interpret mode on the CPU,
  where XLA turns ``amax / 127.0`` into a multiply by the reciprocal: against
  it the scales are held to one ulp and the int8 levels to +-1, with at most
  0.1% of them differing (``tests/test_torch_quantize.py`` measured 4.2% of
  scales one ulp apart and no level moved).
- ``topk``: byte-identical over 3 rounds with the residual carried, and the
  residuals bitwise, ties at the k-th place included.
- payload stats and counters: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _torch_tree(seed=0):
    """A small model-shaped tree in the port's layout: a 2304-element conv
    kernel (OIHW; flax HWIO), a dense kernel of 1280 and small leaves that
    ride raw (a bias, BN statistics, an integer counter)."""
    rs = np.random.RandomState(seed)
    return {
        "params": {
            "conv": {"kernel": torch.from_numpy((rs.randn(16, 16, 3, 3) * 0.05).astype(np.float32))},
            "dense": {"kernel": torch.from_numpy((rs.randn(10, 128) * np.exp(rs.randn(10, 128)))
                                                 .astype(np.float32)),
                      "bias": torch.from_numpy(rs.randn(10).astype(np.float32))},
        },
        "batch_stats": {"bn": {"mean": torch.from_numpy(rs.randn(16).astype(np.float32)),
                               "var": torch.from_numpy(rs.rand(16).astype(np.float32))}},
        "steps": torch.tensor([7], dtype=torch.int32),
    }


def _flax_numpy(tree):
    from fedml_tpu_torch import weights

    return {k: (weights.torch_to_flax({"params": v})["params"] if k == "params" else
                {m: {n: t.numpy() for n, t in d.items()} for m, d in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in tree.items()}


def _flax_tensors(tree):
    from fedml_tpu_torch import weights

    return weights.tensors_to_flax(tree)


class _RefUniform:
    """The reference's draw of leaf ``i``: ``uniform(fold_in(key, i), (blocks,
    8, 128))``, as ``_quantize_impl`` draws it, for the port's hook."""

    def __init__(self, key):
        self.key, self.calls = key, []

    def __call__(self, i, shape, device):
        self.calls.append((i, tuple(shape)))
        u = jax.random.uniform(jax.random.fold_in(self.key, i), shape, jnp.float32)
        return torch.from_numpy(np.array(u)).to(device)


def _mixed_tree():
    """Segments of each codec, made from a seed, as both packages'
    ``CompressedLeaf``s."""
    rs = np.random.RandomState(4)
    q = dict(codec="qsgd8", dtype="float32", shape=(50, 50),
             meta={"blocks": 3, "length": 2500},
             segments=(rs.rand(3).astype(np.float32) * 1e-2,
                       rs.randint(-127, 128, 3 * 1024).astype(np.int8)))
    k = dict(codec="topk", dtype="float32", shape=(40, 30), meta={"size": 1200, "k": 12},
             segments=(np.sort(rs.choice(1200, 12, replace=False)).astype(np.int32),
                       rs.randn(12).astype(np.float32)))
    raw = {"b": rs.randn(7).astype(np.float32), "n": np.int64(3)}
    return q, k, raw


def _build(wire_mod, q, k, raw):
    return {"model_params": {"a": wire_mod.CompressedLeaf(q["codec"], q["dtype"], q["shape"],
                                                          q["meta"], q["segments"]),
                             "z": [wire_mod.CompressedLeaf(k["codec"], k["dtype"], k["shape"],
                                                           k["meta"], k["segments"]),
                                   raw["b"]],
                             "n": raw["n"]}}


def test_v2_frames_byte_identical_and_decode_bitwise():
    """A tree with qsgd8, topk and raw leaves: the same segments give the
    reference's bytes; each package decodes the other's frame bitwise; the
    segments come back undecoded; a plain tree stays v1."""
    from fedml_tpu.comm import wire as ref_wire
    from fedml_tpu.comm.message import Message as RefMessage
    from fedml_tpu_torch.comm import wire
    from fedml_tpu_torch.comm.message import Message

    q, k, raw = _mixed_tree()
    data = wire.encode_pytree(_build(wire, q, k, raw))
    assert data == ref_wire.encode_pytree(_build(ref_wire, q, k, raw))
    header, _ = wire.decode_header(data)
    assert header["version"] == 2
    assert [s["codec"] for s in header["leaves"]] == ["qsgd8", "raw", "topk", "raw"]
    got, want = wire.decode_pytree(data), ref_wire.decode_pytree(data)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    segs = {i: s for i, _, s in wire.iter_leaf_segments(data)}
    assert np.array_equal(segs[0][0], q["segments"][0]) and np.array_equal(segs[0][1],
                                                                          q["segments"][1])
    assert np.array_equal(segs[2][0], k["segments"][0]) and np.array_equal(segs[2][1],
                                                                          k["segments"][1])
    cl = wire.CompressedLeaf(q["codec"], q["dtype"], q["shape"], q["meta"], q["segments"])
    assert np.array_equal(cl.dense(), want["model_params"]["a"])

    # messages: the port's carry the reference's bytes, its tensor section
    # stays lazy for control reads and both streaming views
    msgs = []
    for cls, mod in ((RefMessage, ref_wire), (Message, wire)):
        m = cls(3, 2, 0)
        for key, v in _build(mod, q, k, raw).items():
            m.add_params(key, v)
        m.add_params("model_is_delta", True)
        m.add_params("num_samples", 12.0)
        msgs.append(m.encode())
    assert msgs[0] == msgs[1]
    back = Message.decode(msgs[0])
    assert back.get_control("model_is_delta") is True
    assert back.get_control("model_params") is None
    header, frame = back.tensor_frame()
    assert all(np.array_equal(a, b) for (_, _, a), b in
               zip(frame, jax.tree_util.tree_leaves(want)))
    assert back.tensor_segments() is not None
    assert np.array_equal(back.get("model_params")["a"], want["model_params"]["a"])
    assert back.tensor_frame() is None and back.tensor_segments() is None

    plain = {"w": np.arange(6, dtype=np.float32), "c": [np.int32(1)]}
    v1 = wire.encode_pytree(plain)
    assert v1 == ref_wire.encode_pytree(plain) and wire.decode_header(v1)[0]["version"] == 1
    assert "codec" not in v1.decode("latin-1")


@pytest.mark.parametrize("chunk_bytes", [7, 100, 1 << 20])
def test_chunked_encode_and_stream_decoder(chunk_bytes):
    """``encode_pytree_chunks`` yields the header then pieces of at most
    ``chunk_bytes`` that join to the reference's frame;
    ``PytreeStreamDecoder`` fed 7-byte chunks gives the same leaves, bitwise,
    as the reference's decoder."""
    from fedml_tpu.comm import wire as ref_wire
    from fedml_tpu_torch.comm import wire

    q, k, raw = _mixed_tree()
    tree = _build(wire, q, k, raw)
    chunks = [bytes(c) for c in wire.encode_pytree_chunks(tree, chunk_bytes=chunk_bytes)]
    assert all(len(c) <= chunk_bytes for c in chunks[1:])
    data = b"".join(chunks)
    assert data == ref_wire.encode_pytree(_build(ref_wire, q, k, raw))
    assert chunks == [bytes(c) for c in ref_wire.encode_pytree_chunks(
        _build(ref_wire, q, k, raw), chunk_bytes=chunk_bytes)]
    dec, ref_dec = wire.PytreeStreamDecoder(), ref_wire.PytreeStreamDecoder()
    seen, ref_seen = [], []
    for s in range(0, len(data), 7):
        seen += dec.feed(data[s:s + 7])
        ref_seen += ref_dec.feed(data[s:s + 7])
    assert dec.complete and len(seen) == len(ref_seen) == 4
    for (i, _, a), (j, _, b) in zip(seen, ref_seen):
        assert i == j and a.dtype == b.dtype and np.array_equal(a, b)
    got = dec.result()
    assert np.array_equal(got["model_params"]["z"][0], ref_dec.result()["model_params"]["z"][0])
    with pytest.raises(ValueError, match="trailing"):
        wire.PytreeStreamDecoder().feed(data + b"\0")
    quiet = wire.PytreeStreamDecoder(retain_leaves=False)
    quiet.feed(data)
    with pytest.raises(ValueError, match="retain_leaves"):
        quiet.result()


@pytest.mark.parametrize("case", ["version", "truncated", "codec", "short", "header"])
def test_corrupt_frames_raise_as_the_reference(case):
    """Each corruption raises the reference's exception, with its message."""
    from fedml_tpu.comm import wire as ref_wire
    from fedml_tpu_torch.comm import wire

    q, k, raw = _mixed_tree()
    data = ref_wire.encode_pytree(_build(ref_wire, q, k, raw))
    bad, match = {
        "version": (data.replace(b'"version":2', b'"version":9'), "unsupported wire version"),
        "truncated": (data[:-4], "length mismatch"),
        "codec": (data.replace(b'"codec":"qsgd8"', b'"codec":"qsgd9"'), "unknown wire codec"),
        "short": (data[:3], "too short"),
        "header": (data[:40], "header truncated"),
    }[case]
    for mod in (ref_wire, wire):
        with pytest.raises(ValueError, match=match):
            mod.decode_pytree(bad)


def _ref_compress(monkeypatch, tree, codec, eager, **kw):
    """The reference's ``compress_pytree``; ``eager`` swaps its Pallas
    quantizer for its own eager jnp oracle (same draw, IEEE divides)."""
    from fedml_tpu.comm import codecs as ref_codecs
    from fedml_tpu.ops.pallas import quantize as ref_q

    if eager:
        monkeypatch.setattr(ref_q, "quantize_int8_stochastic",
                            lambda vec, key, interpret=False: ref_q.quantize_int8_reference(vec,
                                                                                            key))
    try:
        return ref_codecs.compress_pytree(tree, codec, **kw)
    finally:
        monkeypatch.undo()


def _ref_counts(codec):
    from fedml_tpu.comm import codecs as ref_codecs

    return (ref_codecs.PAYLOAD_BYTES.value(codec=codec),
            ref_codecs.PAYLOAD_RAW_BYTES.value(codec=codec))


def _port_counts(codec):
    from fedml_tpu_torch.comm import codecs

    c = codecs.payload_counters().get(codec, {})
    return c.get("wire_bytes", 0), c.get("raw_bytes", 0)


def test_compress_pytree_qsgd8_frames_equal_the_reference(monkeypatch):
    """The port's ``compress_pytree`` (plain path, the reference's draws
    handed in) of a tree with a 2304-element conv kernel in torch layout,
    relaid to flax on its device: byte-identical to the reference's frame
    of the flax tree; the stats and the counters move as the reference's."""
    from fedml_tpu.comm import wire as ref_wire
    from fedml_tpu_torch.comm import codecs, wire

    tree = _torch_tree()
    flax = _flax_numpy(tree)
    key = jax.random.PRNGKey(11)
    uniform = _RefUniform(key)
    before, ref_before = _port_counts("qsgd8"), _ref_counts("qsgd8")
    out, res, stats = codecs.compress_pytree(_flax_tensors(tree), "qsgd8", key=(5,),
                                             uniform=uniform)
    want, ref_res, ref_stats = _ref_compress(monkeypatch, flax, "qsgd8", True, key=key)
    assert res == [None] * 6 and ref_res == [None] * 6
    # leaves in wire order: bn mean, bn var, conv kernel, dense bias, dense kernel, steps
    assert uniform.calls == [(2, (3, 8, 128)), (4, (2, 8, 128))]
    frame = wire.encode_pytree({"model_params": out})
    assert frame == ref_wire.encode_pytree({"model_params": want})
    assert stats == ref_stats and stats["wire_bytes"] == 3 * 1028 + 2 * 1028 + (16 + 16 + 10 + 1) * 4
    after, ref_after = _port_counts("qsgd8"), _ref_counts("qsgd8")
    assert (after[0] - before[0], after[1] - before[1]) == (
        ref_after[0] - ref_before[0], ref_after[1] - ref_before[1]) == (
        stats["wire_bytes"], stats["raw_bytes"])
    # the layout matters: blocking the torch layout gives other scales
    plain, _, _ = codecs.compress_pytree(tree, "qsgd8", key=(5,), uniform=uniform)
    assert wire.encode_pytree({"model_params": plain}) != frame

    # against the reference's own path (the interpret kernel): scales one
    # ulp at most, levels +-1 on at most 0.1% of them
    ref_out, _, _ = _ref_compress(monkeypatch, flax, "qsgd8", False, key=key)
    for leaf, ref_leaf in ((out["params"]["conv"]["kernel"], ref_out["params"]["conv"]["kernel"]),
                           (out["params"]["dense"]["kernel"],
                            ref_out["params"]["dense"]["kernel"])):
        s, rs_ = leaf.segments[0], ref_leaf.segments[0]
        assert (np.abs(s - rs_) <= np.spacing(rs_)).all()
        dv = np.abs(leaf.segments[1].astype(np.int16) - ref_leaf.segments[1])
        assert dv.max() <= 1 and (dv > 0).mean() <= 1e-3


def test_compress_pytree_qsgd8_default_draw_is_keyed_per_leaf():
    """Without the hook leaf ``i`` draws from ``fold_in(key, i)`` on its
    device: the same key gives the same frame, another key another one; a
    leaf under ``min_elems`` rides raw."""
    from fedml_tpu_torch.comm import codecs, wire
    from fedml_tpu_torch.core import rng

    tree = _flax_tensors(_torch_tree(1))
    frames = [wire.encode_pytree({"m": codecs.compress_pytree(tree, "qsgd8", key=k)[0]})
              for k in ((1, 2), (1, 2), (1, 3))]
    assert frames[0] == frames[1] != frames[2]
    from fedml_tpu_torch.ops import quantize as q

    u = torch.rand(q.noise_shape(2304), generator=rng.generator(rng.fold_in((1, 2), 2)))
    values, scales, _ = q.quantize_int8_reference(tree["params"]["conv"]["kernel"].reshape(-1), u)
    out = codecs.compress_pytree(tree, "qsgd8", key=(1, 2))[0]
    assert np.array_equal(out["params"]["conv"]["kernel"].segments[1], values.reshape(-1).numpy())
    big, _, stats = codecs.compress_pytree(tree, "qsgd8", key=(1, 2), min_elems=2000)
    assert isinstance(big["params"]["dense"]["kernel"], np.ndarray)
    assert stats["wire_bytes"] == 3 * 1028 + (16 + 16 + 10 + 1280 + 1) * 4
    off, same, stats = codecs.compress_pytree(tree, None)
    assert stats["ratio"] == 1.0 and same is None
    assert np.array_equal(off["params"]["conv"]["kernel"],
                          tree["params"]["conv"]["kernel"].numpy())


def test_compress_pytree_topk_three_rounds_equal_the_reference(monkeypatch):
    """``topk`` at ratio 0.01 over 3 rounds with the residual carried:
    frames byte-identical and residuals bitwise the reference's; the conv
    delta of round 0 has ties at the k-th place (values from a small set,
    with signs), which ``jax.lax.top_k`` breaks to the lower index."""
    from fedml_tpu.comm import wire as ref_wire
    from fedml_tpu_torch.comm import codecs, wire

    rs = np.random.RandomState(2)
    res = ref_res = None
    for r in range(3):
        tree = _torch_tree(10 + r)
        if r == 0:
            vals = rs.choice([0.5, 0.25, 0.125], size=2304) * rs.choice([-1, 1], size=2304)
            tree["params"]["conv"]["kernel"] = torch.from_numpy(
                vals.reshape(16, 16, 3, 3).astype(np.float32))
        flax = _flax_numpy(tree)
        before, ref_before = _port_counts("topk"), _ref_counts("topk")
        out, res, stats = codecs.compress_pytree(_flax_tensors(tree), "topk", residuals=res,
                                                 ratio=0.01)
        want, ref_res, ref_stats = _ref_compress(monkeypatch, flax, "topk", False,
                                                 key=jax.random.PRNGKey(0), residuals=ref_res,
                                                 ratio=0.01)
        assert wire.encode_pytree({"m": out}) == ref_wire.encode_pytree({"m": want})
        assert stats == ref_stats
        assert [r_ is None for r_ in res] == [r_ is None for r_ in ref_res]
        for a, b in zip(res, ref_res):
            if a is not None:
                assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b)
        after, ref_after = _port_counts("topk"), _ref_counts("topk")
        assert (after[0] - before[0], after[1] - before[1]) == (
            ref_after[0] - ref_before[0], ref_after[1] - ref_before[1])
        if r == 0:
            idx = out["params"]["conv"]["kernel"].segments[0]
            corrected = np.abs(flax["params"]["conv"]["kernel"].reshape(-1))
            kth = np.sort(np.abs(out["params"]["conv"]["kernel"].segments[1]))[0]
            assert (corrected >= kth).sum() > len(idx)  # the k-th place is a tie


def test_topk_order_breaks_ties_to_the_lower_index():
    """The pair order is ``jax.lax.top_k``'s on a vector of ties."""
    from fedml_tpu_torch.comm.codecs import _topk_order

    x = np.array([1.0, -3.0, 3.0, 2.0, -2.0, 3.0, 0.0, -0.0, 2.0], np.float32)
    for k in (1, 3, 4, 6, 9):
        _, want = jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)
        got = _topk_order(torch.from_numpy(x).abs(), k)
        assert got.tolist() == np.asarray(want).tolist()


# -- SecAgg quantize-then-mask (comm_compression qsgd8 under secagg_stream) --

def test_quantize_then_mask_upload_bitwise_the_reference():
    """The same delta and seeds: the port's int8 grid, masked ring vector,
    u16 packing and meta are bitwise the reference's composition
    (``secagg_shamir.py``'s client branch); ``dequantize_sum`` too."""
    from fedml_tpu.trust.secagg import stream as ref_stream
    from fedml_tpu_torch.cross_silo import secagg_shamir as sa
    from fedml_tpu_torch.trust.secagg import stream

    from .test_torch_secagg import _Cohort

    rs = np.random.RandomState(8)
    base = rs.randn(5000).astype(np.float32)
    flat = (base + rs.randn(5000) * np.exp(2 * rs.randn(5000) - 3)).astype(np.float32)
    ring = stream.ring_for("qsgd8", 4, q_bits=16, q8_frac_bits=7)
    ref_ring = ref_stream.ring_for("qsgd8", 4, q_bits=16, q8_frac_bits=7)
    assert (ring.bits, ring.modulus) == (ref_ring.bits, ref_ring.modulus) == (11, 2048)
    seed = [0, 1, 2]
    delta = flat.astype(np.float64) - base.astype(np.float64)
    q = stream.quantize_stochastic_int8(delta, 7, seed)
    want_q = ref_stream.quantize_stochastic_int8(delta, 7, seed)
    assert q.dtype == want_q.dtype and np.array_equal(q, want_q)
    assert q.min() == -127 and q.max() == 127 and len(np.unique(q)) > 100  # clipped and not
    cohort = _Cohort(t=2)
    peers, self_seed = cohort.seeds(2, round_idx=1)
    packed, meta = sa.mask_upload(flat, 2, peers, self_seed, 16, ring, base=base, seed=seed)
    want = ref_stream.pack_ring(ref_stream.mask_vector(np.mod(want_q, ref_ring.modulus), 2, peers,
                                                       self_seed, ref_ring.modulus), ref_ring.bits)
    assert packed.dtype == want.dtype == np.dtype("<u2")
    assert packed.tobytes() == want.tobytes() and packed.nbytes == 2 * 5000
    assert meta == dict(ref_ring.meta(5000), delta=True)
    total = q * 3
    assert np.array_equal(stream.dequantize_sum(total, ring, 3),
                          ref_stream.dequantize_sum(total, ref_ring, 3))


def test_quantize_then_mask_run_matches_the_reference(tmp_path, monkeypatch):
    """Two rounds of Shamir SecAgg with ``secagg_stream`` and ``qsgd8``: the
    reference's ``run_shamir_secagg_process_group`` and the port's
    ``FedMLRunner(cfg, device="cpu")`` on a fused ResNet of one block a
    stage, 4 silos, the initial global and the permutations carried across.
    The ring is 11 bits (u16 on the wire) on both.  Both sides round with
    ``u`` from the same numpy seed, so a grid value moves only where the two
    deltas (local SGD is not bitwise between XLA and PyTorch) straddle a
    rounding boundary: at most 0.1% of the values move, by one step, and
    the global is held to one grid step (``2**-7`` over the 4 survivors)
    per moved value at that element and is bitwise the reference's where no
    value moved in either round."""
    import fedml_tpu
    import fedml_tpu.trust.secagg.stream as ref_stream
    import fedml_tpu_torch
    import fedml_tpu_torch.trust.secagg.stream as port_stream
    from fedml_tpu.cross_silo.secagg_shamir import run_shamir_secagg_process_group
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import resnet as flax_resnet
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.comm import codecs
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.runner import FedMLRunner

    from .test_torch_secagg import JaxPerms, _cfgs, _port_as_flax, _ref_aggregator_init, _ref_flat

    grids = {}
    for name, mod in (("ref", ref_stream), ("port", port_stream)):
        inner = mod.quantize_stochastic_int8

        def recording(flat, frac_bits, seed, inner=inner, name=name):
            q = inner(flat, frac_bits, seed)
            grids[(name, tuple(seed))] = q
            return q

        monkeypatch.setattr(mod, "quantize_stochastic_int8", recording)
    ref_cfg, cfg = _cfgs(tmp_path, "sa_q8", extra={"fused_blocks": True,
                                                  "comm_compression": "qsgd8"})
    fedml_tpu.init(ref_cfg)
    ref_model = flax_resnet.CifarResNet(num_blocks=1, fused=True)
    ref_hist, ref_srv = run_shamir_secagg_process_group(ref_cfg, ref_loader.load(ref_cfg),
                                                        ref_model, timeout=300.0)
    init = jax.tree_util.tree_map(np.asarray, _ref_aggregator_init(ref_cfg, ref_model))

    before = codecs.payload_counters().get("secagg_qsgd8", {"wire_bytes": 0})["wire_bytes"]
    runner = FedMLRunner(fedml_tpu_torch.init(cfg), model=resnet.CifarResNet(1, fused=True),
                         device="cpu")
    group = runner.runner
    group.global_vars = weights.to_torch(weights.flax_to_torch(init))
    group.perms = JaxPerms(cfg.random_seed)
    hist = runner.run()
    agg = group.server.aggregator
    assert agg.ring.bits == ref_srv.aggregator.ring.bits == 11 and agg.ring.codec == "qsgd8"
    assert agg.field_stream and agg.peak_buffered_updates <= 2 and not agg.stream_mode
    dim = agg.model_dim
    wire_bytes = codecs.payload_counters()["secagg_qsgd8"]["wire_bytes"] - before
    assert wire_bytes == 2 * 4 * 2 * dim  # u16, 4 silos, 2 rounds
    assert [h["round"] for h in hist] == [0, 1] and len(ref_hist) == 2
    assert all(np.isfinite(h["test_loss"]) for h in hist)

    seeds = sorted({s for _, s in grids})
    assert len(seeds) == 8 and all(("port", s) in grids and ("ref", s) in grids for s in seeds)
    moved = np.zeros(dim, np.int64)
    for s in seeds:
        d = grids[("port", s)] - grids[("ref", s)]
        assert np.abs(d).max() <= 1
        moved += d != 0
    assert moved.sum() <= 1e-3 * dim * len(seeds), int(moved.sum())
    got = _ref_flat(_port_as_flax(agg.global_vars))
    want = _ref_flat(ref_srv.aggregator.global_vars)
    start = _ref_flat(init)
    step = 2.0**-7 / 4
    assert (np.abs(got - want) <= moved * step + np.spacing(np.abs(want))).all()
    assert np.array_equal(got[moved == 0], want[moved == 0])
    assert np.abs(want - start).max() >= 2.0**-7 / 4  # the grid moved the weights
