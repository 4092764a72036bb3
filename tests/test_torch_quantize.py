"""Port parity: block-int8 quantization (``ops/quantize.py``), the gradient
compressors (``ops/compression.py``) and the reference-layout flat vector
(``weights.flatten_reference``).

Inputs are seeded numpy vectors spanning several orders of magnitude; the
uniform draws are the reference's own (``jax.random.uniform`` from a key)
handed to the port.  Tolerances:

- quantize / dequantize: int8 values, scales and dequantized vectors
  **bitwise** equal to the jnp oracle ``quantize_int8_reference`` run eagerly
  (op by op, IEEE divides), at lengths 1, 1023, 1024, 1025, 4096 and the tiny
  ResNet's flat length.
- Against the Pallas interpret kernel: XLA:CPU compiles it and rewrites
  ``amax / 127.0`` (a divide by a constant) into a multiply by the f32
  reciprocal, so a scale may differ by one ulp.  Measured on 1.4M elements
  (1,374 blocks, lengths 1 to 2^20): 58 scales (4.2%) one ulp apart, no int8
  level different.  The test holds scales to 1 ulp, levels to +-1 with at
  most 0.1% of them differing, and dequantized values to one level's scale.
- ``compress``: ``topk`` / ``eftopk`` / ``quantize`` / ``qsgd_int8`` bitwise
  against the eager reference; ``qsgd`` bitwise on a dyadic input (its l2
  norm is then exact in any summation order) and within one quantization
  level (``norm / levels``) on a random one, where torch and XLA sum the
  norm in different orders.
- the reference-layout flatten of ResNet-20 weights: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _vec(n, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n) * np.exp(rs.randn(n) * 3)).astype(np.float32)


def _tiny_resnet_flat_length():
    from fedml_tpu.models import resnet as flax_resnet

    m = flax_resnet.CifarResNet(num_blocks=1)
    k = jax.random.PRNGKey(0)
    v = m.init({"params": k, "dropout": k}, np.zeros((1, 8, 8, 3), np.float32), train=True)
    return sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(v["params"]))


LENGTHS = [1, 1023, 1024, 1025, 4096, "resnet_blocks1"]


def _length(n):
    return _tiny_resnet_flat_length() if n == "resnet_blocks1" else n


def _reference_draw(key, n):
    from fedml_tpu_torch.ops.quantize import noise_shape

    return np.array(jax.random.uniform(key, noise_shape(n), jnp.float32))


@pytest.mark.parametrize("n", LENGTHS)
def test_quantize_bitwise_vs_jnp_oracle(n):
    """Plain quantize == quantize_int8_reference (eager) given the same u."""
    from fedml_tpu.ops.pallas import quantize as jq
    from fedml_tpu_torch.ops import quantize as q

    n = _length(n)
    x, key = _vec(n, seed=n % 97), jax.random.PRNGKey(n)
    rv, rsc, rn = jq.quantize_int8_reference(jnp.asarray(x), key)
    q.reset_launch_counts()
    pv, psc, pn = q.quantize_int8_stochastic(torch.from_numpy(x),
                                             torch.from_numpy(_reference_draw(key, n)))
    assert pn == rn == n
    assert pv.dtype == torch.int8 and tuple(pv.shape) == tuple(rv.shape)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(psc.numpy(), np.asarray(rsc))
    assert all(v == 0 for v in q.launch_counts().values())  # CPU: plain version


@pytest.mark.parametrize("n", LENGTHS)
def test_quantize_vs_interpret_kernel_and_dequantize_bitwise(n):
    """Against the Pallas kernel in interpret mode: scales within 1 ulp,
    levels within +-1 at <= 0.1% of elements; dequantize bitwise on the same
    (values, scales)."""
    from fedml_tpu.ops.pallas import quantize as jq
    from fedml_tpu_torch.ops import quantize as q

    n = _length(n)
    x, key = _vec(n, seed=n % 89), jax.random.PRNGKey(7 * n)
    iv, isc, _ = jq.quantize_int8_stochastic(jnp.asarray(x), key, interpret=True)
    pv, psc, pn = q.quantize_int8_stochastic(torch.from_numpy(x),
                                             torch.from_numpy(_reference_draw(key, n)))
    ulps = np.abs(np.asarray(isc).view(np.int32).astype(np.int64)
                  - psc.numpy().view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    levels = np.abs(np.asarray(iv).astype(np.int32) - pv.numpy().astype(np.int32))
    assert levels.max() <= 1 and (levels != 0).mean() <= 1e-3
    got = q.dequantize_int8(pv, psc, pn)
    want = jq.dequantize_int8(jnp.asarray(pv.numpy()), jnp.asarray(psc.numpy()), pn,
                              interpret=True)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        q.dequantize_int8_reference(pv, psc, pn).numpy(), got.numpy())


def test_qsgd_int8_round_trip_bitwise_and_unbiased():
    """qsgd_int8 == dequantize(quantize_int8_reference) of the reference;
    the error is below one level of each block's scale."""
    from fedml_tpu.ops.pallas import quantize as jq
    from fedml_tpu_torch.ops import quantize as q

    n = 5000
    x, key = _vec(n, 3), jax.random.PRNGKey(5)
    rv, rsc, rn = jq.quantize_int8_reference(jnp.asarray(x), key)
    want = np.asarray(rv, np.float32).reshape(-1)[:n] * np.repeat(np.asarray(rsc), 1024)[:n]
    got = q.qsgd_int8(torch.from_numpy(x), torch.from_numpy(_reference_draw(key, n)))
    np.testing.assert_array_equal(got.numpy(), want)
    scale_of = np.repeat(np.asarray(rsc), 1024)[:n]
    assert np.all(np.abs(got.numpy() - x) <= scale_of * 1.0001)


def test_quantize_edge_values():
    """All-zero blocks (scale 1e-12, values 0), exact multiples, a ragged
    tail, and a NaN propagating into its block's scale, as the oracle."""
    from fedml_tpu.ops.pallas import quantize as jq
    from fedml_tpu_torch.ops import quantize as q

    x = np.zeros(3000, np.float32)
    x[1024:2048] = np.linspace(-127, 127, 1024, dtype=np.float32)
    x[2048:] = 1.5
    x[2999] = np.nan
    key = jax.random.PRNGKey(1)
    rv, rsc, _ = jq.quantize_int8_reference(jnp.asarray(x), key)
    pv, psc, _ = q.quantize_int8_stochastic(torch.from_numpy(x),
                                            torch.from_numpy(_reference_draw(key, 3000)))
    np.testing.assert_array_equal(psc.numpy(), np.asarray(rsc))
    assert np.isnan(float(psc[2])) and float(psc[0]) == float(np.float32(1e-12))
    np.testing.assert_array_equal(pv[:2].numpy(), np.asarray(rv)[:2])


def test_wrappers_refuse_other_devices():
    from fedml_tpu_torch.ops import quantize as q

    x = torch.zeros(10, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        q.quantize_int8_stochastic(x, torch.zeros(q.noise_shape(10), device="meta"))
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        q.dequantize_int8(torch.zeros((1, 8, 128), dtype=torch.int8, device="meta"),
                          torch.zeros(1, device="meta"), 10)
    assert q.noise_shape(1) == (1, 8, 128) and q.noise_shape(269722) == (264, 8, 128)


# -- the kernels' variant (pure Python) ---------------------------------------

@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4, 8])
def test_variant_follows_the_operands_alignment(offset):
    """The vector variant only when every operand is 16-byte aligned: f32
    x and u and int8 values at ``offset`` elements into an aligned buffer."""
    from fedml_tpu_torch.ops import build

    f32, i8 = torch.empty(64), torch.empty(64, dtype=torch.int8)
    assert f32.data_ptr() % 16 == 0 and i8.data_ptr() % 16 == 0
    x, values = f32[offset:], i8[offset:]
    assert build.aligned16((x.data_ptr(), f32.data_ptr(), i8.data_ptr())) == (offset % 4 == 0)
    assert build.aligned16((values.data_ptr(), f32.data_ptr())) == (offset % 16 == 0)


def test_kernel_constants_match_the_source():
    """The wrapper's quantization block is the .cu source's."""
    import re

    from fedml_tpu_torch.ops import build
    from fedml_tpu_torch.ops import quantize as q

    src = build.SOURCES["quantize"].read_text()
    assert re.search(r"constexpr int kBlock = (\d+);", src).group(1) == str(q.BLOCK)


def test_cpu_path_counts_no_launch_or_variant():
    from fedml_tpu_torch.ops import quantize as q

    q.reset_launch_counts()
    x = torch.from_numpy(_vec(3000, 2))
    values, scales, n = q.quantize_int8_stochastic(x, torch.rand(q.noise_shape(3000)))
    q.dequantize_int8(values, scales, n)
    q.qsgd_int8_lanes(torch.stack([x, x]), torch.rand((2,) + q.noise_shape(3000)))
    kernels = q.KERNELS + q.LANE_KERNELS
    assert q.launch_counts() == {k.name: 0 for k in kernels}
    assert q.variant_counts() == {k.name: {"vector": 0, "scalar": 0} for k in kernels}


def test_quantize_ablation_copies_patch_the_kernel_source():
    """obs/ablate_quant.py changes one thing in each copy: u after the max,
    the threads of a quantization block, 4-byte loads, a kernel's load or
    store policy, the words a dequantize lane, the threads of a dequantize
    block or consecutive values a dequantize thread; and keeps the replaced
    kernels."""
    from fedml_tpu_torch.obs import ablate_quant as a
    from fedml_tpu_torch.ops import build

    src = build.SOURCES["quantize"].read_text()
    copies = a.variants(src)
    assert copies["final"] == src
    assert set(copies) == {"final", "was", "u_late", "loads4", "ldg", "dq_ldcs", "plain_stores",
                           "contig16", "t32", "t64", "t128", "dq2", "dq4", "dq_t64", "dq_t128"}
    late = copies["u_late"]
    assert late.index(a.SCALE) < late.index(a.U_LOADS) and late.count(a.U_LOADS) == 1
    for t in (32, 64, 128):
        assert f"constexpr int kThreads = {t};" in copies[f"t{t}"]
        assert t == 32 or f"constexpr int kDqThreads = {t};" in copies[f"dq_t{t}"]
    assert a.VEC_LOAD not in copies["loads4"]
    assert a.LD not in copies["ldg"] and a.LD_DQ in copies["ldg"]
    assert a.LD_DQ not in copies["dq_ldcs"] and a.LD in copies["dq_ldcs"]
    assert a.STREAM_STORE not in copies["plain_stores"] and a.STORE in copies["plain_stores"]
    for w in (2, 4):
        assert f"constexpr int kDqWords = {w};" in copies[f"dq{w}"]
    assert a.CONTIG16_KERNEL in copies["contig16"] and "kDqWords = 4;" in copies["contig16"]
    assert "__syncthreads" in copies["was"] and "quantize_int8" in copies["was"]
    for name, text in copies.items():
        assert name in ("final", "was") or text != src, name
    with pytest.raises(RuntimeError, match="has no"):
        a.variants(src.replace(a.DQ_END, "bool aligned(", 1))


def test_quantize_ablation_times_each_copy_where_it_changes_a_kernel():
    """Every copy is timed as the quantize, the dequantize or both: where it
    changes something (the unchanged kernel of a copy is not timed again)."""
    from fedml_tpu_torch.obs import ablate_quant as a
    from fedml_tpu_torch.ops import build

    copies = a.variants(build.SOURCES["quantize"].read_text())
    quant, dequant = a._calls({name: None for name in copies})
    assert set(quant) == {"final", "was", "u_late", "loads4", "ldg", "t32", "t64", "t128"}
    assert set(dequant) == {"final", "was", "dq_ldcs", "plain_stores", "contig16", "dq2", "dq4",
                            "dq_t64", "dq_t128"}


# -- compression branches ----------------------------------------------------

def _compress_both(name, x, key, residual=None, ratio=0.01, level=8):
    from fedml_tpu.ops import compression as jc
    from fedml_tpu_torch.ops import compression as comp

    ref, ref_res = jc.compress(name, jnp.asarray(x), key=key,
                               residual=None if residual is None else jnp.asarray(residual),
                               ratio=ratio, quantize_level=level)
    shape = comp.draw_shape(name, x.shape[0])
    noise = None if shape is None else torch.from_numpy(
        np.array(jax.random.uniform(key, shape, jnp.float32)))
    got, got_res = comp.compress(name, torch.from_numpy(x), noise=noise,
                                 residual=None if residual is None else torch.from_numpy(residual),
                                 ratio=ratio, quantize_level=level)
    return (np.asarray(ref), None if ref_res is None else np.asarray(ref_res),
            got.numpy(), None if got_res is None else got_res.numpy())


@pytest.mark.parametrize("name,ratio", [("topk", 0.01), ("topk", 0.3), ("quantize", 0.01),
                                        ("no", 0.01)])
def test_compress_stateless_bitwise(name, ratio):
    x = _vec(3001, 11)
    x[::7] = x[3]  # ties at and around the top-k threshold
    ref, _, got, _ = _compress_both(name, x, jax.random.PRNGKey(2), ratio=ratio)
    np.testing.assert_array_equal(got, ref)
    if name == "topk":
        assert (got != 0).sum() >= max(1, int(ratio * x.size))


def test_compress_eftopk_bitwise_over_rounds():
    """Three rounds of error feedback: sent vector and residual bitwise."""
    res_ref = res_got = np.zeros(2000, np.float32)
    for r in range(3):
        x = _vec(2000, 20 + r)
        ref, res_ref, got, res_got = _compress_both("eftopk", x, None, residual=res_ref,
                                                    ratio=0.05)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(res_got, res_ref)
        np.testing.assert_array_equal(got + res_got, ref + res_ref)
    assert np.abs(res_got).sum() > 0


def test_compress_qsgd():
    """Bitwise on a dyadic input (exact norm); within one level otherwise."""
    rs = np.random.RandomState(4)
    dyadic = (rs.randint(-64, 64, 4096) / 8.0).astype(np.float32)
    ref, _, got, _ = _compress_both("qsgd", dyadic, jax.random.PRNGKey(3))
    np.testing.assert_array_equal(got, ref)
    x = _vec(4096, 5)
    ref, _, got, _ = _compress_both("qsgd", x, jax.random.PRNGKey(4))
    level = np.linalg.norm(x.astype(np.float64)) / 256
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0001 * level
    # the norms differ by an ulp: every entry moves by ~1e-7 relative; a
    # stochastic-rounding flip (a whole level) at most at 0.1% of entries
    assert (diff > 1e-5 * np.abs(ref)).mean() <= 1e-3


def test_compress_qsgd_int8():
    """Bitwise against the reference's oracle composition; against the
    reference's ``compress`` (the interpret kernel) within one level of the
    block's scale."""
    from fedml_tpu.ops.pallas import quantize as jq

    n = 3000
    x, key = _vec(n, 6), jax.random.PRNGKey(9)
    ref, _, got, _ = _compress_both("qsgd_int8", x, key)
    rv, rsc, _ = jq.quantize_int8_reference(jnp.asarray(x), key)
    scale_of = np.repeat(np.asarray(rsc), 1024)[:n]
    np.testing.assert_array_equal(got, np.asarray(rv, np.float32).reshape(-1)[:n] * scale_of)
    assert np.all(np.abs(got - ref) <= scale_of * 1.0001)


def test_compress_unknown_raises():
    from fedml_tpu_torch.ops import compression as comp

    with pytest.raises(ValueError, match="unknown compression"):
        comp.compress("zip", torch.zeros(4))
    assert comp.draw_shape("topk", 10) is None and comp.draw_shape("qsgd", 10) == (10,)


# -- the reference's flat layout -----------------------------------------------

@pytest.mark.parametrize("num_blocks", [1, 3])
def test_flatten_reference_bitwise_for_resnet(num_blocks):
    """flatten_reference of the port's ResNet weights (flax weights through
    flax_to_torch) == the JAX package's tree_flatten_to_vector of the flax
    tree; unravel inverts it bitwise, layouts and dtypes included."""
    from fedml_tpu.core import pytree as ref_pt
    from fedml_tpu.models import resnet as flax_resnet
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt

    m = flax_resnet.CifarResNet(num_blocks=num_blocks)
    k = jax.random.PRNGKey(num_blocks)
    v = jax.tree_util.tree_map(np.asarray, m.init({"params": k, "dropout": k},
                                                  np.zeros((1, 8, 8, 3), np.float32), train=True))
    for tree in (v["params"], v):
        ref, _ = ref_pt.tree_flatten_to_vector(tree)
        ported = weights.to_torch(weights.flax_to_torch(tree))
        flat, unravel = weights.flatten_reference(ported)
        np.testing.assert_array_equal(flat.numpy(), np.asarray(ref))
        back = unravel(flat)
        for a, b in zip(pt.tree_leaves(back), pt.tree_leaves(ported)):
            assert a.shape == b.shape and a.dtype == b.dtype and a.is_contiguous()
            assert torch.equal(a, b)
    if num_blocks == 3:
        assert flat.numel() == 271098  # params + batch_stats; params alone 269,722
        assert weights.flatten_reference(ported["params"])[0].numel() == 269722
    # the port's own flatten keeps OIHW: another vector, same multiset
    own, _ = pt.tree_flatten_to_vector(ported)
    assert not torch.equal(own, flat)
    assert torch.equal(own.sort().values, flat.sort().values)
