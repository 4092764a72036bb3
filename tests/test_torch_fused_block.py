"""Port parity: the fused BasicBlock epilogue (``ops/fused_block.py``).

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
JAX side runs the Pallas kernels in interpret mode, as
``tests/test_pallas.py`` does.  C = 24 is in every sweep: it does not
divide 128, so the JAX wrapper takes its jnp reference there while the
port's kernel takes any C.

Tolerances:
- forward f32: bitwise.  XLA:CPU contracts the kernel's ``y * s + b`` into
  one FMA (one rounding where the plain version rounds twice), so the
  bitwise comparison with the interpret kernel uses power-of-two scales,
  whose products are exact and make both forms round once; with general
  scales the port is bitwise the JAX reference evaluated op by op and
  within 1 ulp (rtol 2**-23) of the contracted kernel;
- grads: dy / dr to rtol 1e-6, d_scale / d_shift to rtol/atol 1e-5 (f32
  sums in another order);
- bf16: within 1e-2 of each other and of the f32 ground truth, as in
  ``tests/test_pallas.py``.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SHAPES = [(3, 7, 9, 16), (2, 5, 5, 24), (4, 8, 8, 16)]


def _inputs(shape, seed=0, pow2_scale=False):
    rs = np.random.RandomState(seed)
    y = rs.randn(*shape).astype(np.float32)
    r = rs.randn(*shape).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    c = shape[-1]
    if pow2_scale:
        s = (rs.choice([-1.0, 1.0], c) * 2.0 ** rs.randint(-3, 4, c)).astype(np.float32)
    else:
        s = rs.randn(c).astype(np.float32)
    b = rs.randn(c).astype(np.float32)
    return y, r, g, s, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_bitwise_vs_interpret_kernel(shape):
    """(c) forward: the port equals fused_bn_relu / fused_bn_residual_relu
    (interpret=True) bitwise in f32."""
    from fedml_tpu.ops.pallas import fused_bn_relu as jax_relu
    from fedml_tpu.ops.pallas import fused_bn_residual_relu as jax_res
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, _, s, b = _inputs(shape, pow2_scale=True)
    ref = np.asarray(jax.jit(partial(jax_res, interpret=True))(y, s, b, r))
    ref2 = np.asarray(jax.jit(partial(jax_relu, interpret=True))(y, s, b))
    ty, tr, ts, tb = _t(y, r, s, b)
    np.testing.assert_array_equal(fb.fused_bn_residual_relu(ty, ts, tb, tr).numpy(), ref)
    np.testing.assert_array_equal(fb.fused_bn_relu(ty, ts, tb).numpy(), ref2)
    np.testing.assert_array_equal(fb.fused_block_reference(ty, ts, tb, tr).numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_general_scales(shape):
    """General scales: bitwise the JAX reference op by op, 1 ulp of the
    FMA-contracted interpret kernel."""
    from fedml_tpu.ops.pallas import fused_block_reference as jax_ref
    from fedml_tpu.ops.pallas import fused_bn_residual_relu as jax_res
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, _, s, b = _inputs(shape, seed=1)
    ty, tr, ts, tb = _t(y, r, s, b)
    got = fb.fused_bn_residual_relu(ty, ts, tb, tr).numpy()
    with jax.disable_jit():
        eager = np.asarray(jax_ref(y, s, b, r))
    np.testing.assert_array_equal(got, eager)
    kern = np.asarray(jax.jit(partial(jax_res, interpret=True))(y, s, b, r))
    np.testing.assert_allclose(got, kern, rtol=2.0 ** -23, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("residual", [False, True])
def test_grads_match_jax(shape, residual):
    """(c) gradients through the autograd.Function vs jax.grad of the
    interpret kernel's custom_vjp."""
    from fedml_tpu.ops.pallas import fused_bn_relu as jax_relu
    from fedml_tpu.ops.pallas import fused_bn_residual_relu as jax_res
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _inputs(shape, seed=2, pow2_scale=True)
    if residual:
        loss = lambda y, s, b, r: jnp.sum(jax_res(y, s, b, r, interpret=True) * g)  # noqa: E731
        ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(y, s, b, r)
    else:
        loss = lambda y, s, b: jnp.sum(jax_relu(y, s, b, interpret=True) * g)  # noqa: E731
        ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(y, s, b)
    leaves = [t.requires_grad_(True) for t in _t(y, s, b, r)[: 4 if residual else 3]]
    out = fb.fused_bn_residual_relu(*leaves) if residual else fb.fused_bn_relu(*leaves)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    names = ["dy", "d_scale", "d_shift", "dr"]
    for name, a, e in zip(names, got, ref):
        e = np.asarray(e)
        assert a.dtype == torch.float32 and tuple(a.shape) == e.shape, name
        if name in ("d_scale", "d_shift"):
            np.testing.assert_allclose(a.numpy(), e, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), e, rtol=1e-6, atol=0, err_msg=name)


def test_bwd_reference_matches_autograd_of_forward():
    """The explicit-mask backward equals autograd through the plain forward
    (the inputs have no exact zeros of the pre-activation)."""
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _t(*_inputs((2, 5, 5, 24), seed=3))
    leaves = [t.clone().requires_grad_(True) for t in (y, s, b, r)]
    out = fb.fused_block_reference(*leaves)
    ref = torch.autograd.grad((out * g).sum(), leaves)
    dy, ds, db, dr = fb.fused_block_bwd_reference(g, y, s, out.detach(), True)
    torch.testing.assert_close(dy, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(dr, ref[3], rtol=0, atol=0)
    torch.testing.assert_close(ds, ref[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db, ref[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (2, 5, 5, 24)])
def test_bf16_tolerance(shape):
    """(c) bf16 activations, f32 math inside, one cast at the end."""
    from fedml_tpu.ops.pallas import fused_bn_residual_relu as jax_res
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _inputs(shape, seed=4)
    y16, r16 = jnp.asarray(y, jnp.bfloat16), jnp.asarray(r, jnp.bfloat16)
    ref = np.asarray(jax.jit(partial(jax_res, interpret=True))(y16, s, b, r16), np.float32)
    ty = torch.from_numpy(np.array(y16.astype(jnp.float32))).to(torch.bfloat16)
    tr = torch.from_numpy(np.array(r16.astype(jnp.float32))).to(torch.bfloat16)
    ts, tb = _t(s, b)
    out = fb.fused_bn_residual_relu(ty, ts, tb, tr)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-2, atol=1e-2)
    truth = fb.fused_block_reference(ty.float(), ts, tb, tr.float()).numpy()
    np.testing.assert_allclose(out.float().numpy(), truth, rtol=1e-2, atol=1e-2)
    ty.requires_grad_(True)
    dy, = torch.autograd.grad(fb.fused_bn_residual_relu(ty, ts, tb, tr).float().sum(), [ty])
    assert dy.dtype == torch.bfloat16 and bool(torch.isfinite(dy.float()).all())


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    """On a CPU tensor the wrapper takes the plain version (no launch is
    counted); a device without a kernel raises instead of falling back."""
    from fedml_tpu_torch.ops import fused_block as fb

    fb.reset_launch_counts()
    y, r, g, s, b = _t(*_inputs((2, 4, 4, 16), seed=5))
    fb.fused_bn_residual_relu(y, s, b, r)
    assert set(fb.launch_counts()) == {k.name for k in fb.KERNELS + fb.LANE_KERNELS}
    assert all(v == 0 for v in fb.launch_counts().values())
    with pytest.raises(RuntimeError, match="no kernel"):
        fb.fused_block_forward(y.to("meta"), s.to("meta"), b.to("meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        fb.fused_block_backward(g.to("meta"), y.to("meta"), s.to("meta"), y.to("meta"), False)


def test_kernel_operand_checks():
    """The kernel wrapper takes only a contiguous NHWC f32/bf16 tensor with
    matching f32 per-channel vectors, and raises on anything else."""
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, _, s, b = _t(*_inputs((2, 4, 4, 16), seed=6))
    fb._check(y, (s, b), (r,))
    with pytest.raises(ValueError, match="contiguous NHWC"):
        fb._check(y.permute(0, 3, 1, 2), (s, b), ())
    with pytest.raises(ValueError, match="contiguous NHWC"):
        fb._check(y.reshape(-1, 16), (s, b), ())
    with pytest.raises(TypeError):
        fb._check(y.double(), (s, b), ())
    with pytest.raises(ValueError, match="per-channel"):
        fb._check(y, (s[:8], b), ())
    with pytest.raises(ValueError, match="per-channel"):
        fb._check(y, (s.to(torch.bfloat16), b), ())
    with pytest.raises(ValueError, match="match"):
        fb._check(y, (s, b), (r.to(torch.bfloat16),))


# -- the kernels' geometry (ops/fused_block.fwd_geometry / bwd_geometry) -----
# The CUDA kernels' thread -> data map, written out: block (bx, by), thread
# t = j * cg + lc takes channels [(by * cg + lc) * vec, ... + vec) and rows
# bx * rows_per_block + j, + rb, ... up to the block's end.

FLAGSHIP_STAGES = [(128, 32, 32, 16), (128, 16, 16, 32), (128, 8, 8, 64)]
GEOMETRY_CASES = [(math.prod(s[:-1]), s[-1]) for s in FLAGSHIP_STAGES] + [
    (rows, c) for c in (1, 3, 12, 16, 24, 64, 300) for rows in (70, 1000)]


def _coverage(geo):
    """How many times the kernel's threads visit each (row, channel)."""
    counts = np.zeros(geo.rows * geo.c, np.int64)
    for by in range(geo.channel_blocks):
        chans = np.array([ch for lc in range(geo.cg)
                          for ch in range((by * geo.cg + lc) * geo.vec,
                                          (by * geo.cg + lc + 1) * geo.vec) if ch < geo.c])
        for bx in range(geo.row_blocks):
            r0 = bx * geo.rows_per_block
            r1 = min(geo.rows, r0 + geo.rows_per_block)
            rows = np.concatenate([np.arange(r0 + j, r1, geo.rb) for j in range(geo.rb)])
            counts += np.bincount((rows[:, None] * geo.c + chans[None, :]).ravel(),
                                  minlength=counts.size)
    return counts


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,c", GEOMETRY_CASES)
def test_bwd_geometry_covers_every_element_once(rows, c, itemsize):
    """Every row and channel exactly once, on 1-4 simulated SMs, aligned or
    not; the launch fits the kernel's limits, every block has rows, and the
    last block folds at most FOLD_FLOATS partials."""
    from fedml_tpu_torch.ops import fused_block as fb

    for sm_count in (1, 2, 3, 4):
        for blocks_per_sm in (1, 8):
            for aligned in (True, False):
                geo = fb.bwd_geometry(rows, c, itemsize, aligned, sm_count, blocks_per_sm)
                assert (geo.rows, geo.c) == (rows, c)
                assert np.array_equal(_coverage(geo), np.ones(rows * c, np.int64)), geo
                assert geo.cg * geo.rb <= fb.THREADS and geo.channel_blocks <= 65535
                assert 32 % geo.cg or geo.cg * geo.rb % 32 == 0  # whole warps for the shuffles
                assert geo.row_blocks <= max(1, sm_count * blocks_per_sm // geo.channel_blocks)
                assert (geo.row_blocks - 1) * geo.rows_per_block < rows
                assert geo.scratch_floats == geo.row_blocks * 2 * c
                assert geo.row_blocks == 1 or geo.scratch_floats <= fb.FOLD_FLOATS


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,c", GEOMETRY_CASES)
def test_fwd_geometry_covers_every_element_once(rows, c, itemsize):
    """The forward's geometry: every row and channel exactly once, on 1-4
    simulated SMs, aligned or not; at most one resident wave, every block
    has rows, and no cap by partials (the forward folds nothing)."""
    from fedml_tpu_torch.ops import fused_block as fb

    for sm_count in (1, 2, 3, 4):
        for blocks_per_sm in (1, 8):
            for aligned in (True, False):
                geo = fb.fwd_geometry(rows, c, itemsize, aligned, sm_count, blocks_per_sm)
                assert (geo.rows, geo.c) == (rows, c)
                assert geo.vec == fb.vector_width(c, itemsize, aligned)
                assert np.array_equal(_coverage(geo), np.ones(rows * c, np.int64)), geo
                assert geo.cg * geo.rb <= fb.THREADS and geo.channel_blocks <= 65535
                wave = max(1, sm_count * blocks_per_sm // geo.channel_blocks)
                assert geo.row_blocks <= wave
                assert (geo.row_blocks - 1) * geo.rows_per_block < rows
                # no more blocks than rows for each block's threads, nor
                # than the wave
                assert geo.rows_per_block == -(-rows // min(wave, -(-rows // geo.rb)))


def test_fwd_geometry_fills_the_card_once():
    """On an H100 (132 SMs, 8 resident blocks of 256 threads) the forward's
    grid at the flagship's stage shapes is one resident wave capped by the
    rows, with no block without rows and no cap by partials."""
    from fedml_tpu_torch.ops import fused_block as fb

    s1 = fb.fwd_geometry(128 * 32 * 32, 16, 2, True, 132, 8)  # stage 1, bf16
    assert (s1.vec, s1.cg, s1.rb, s1.channel_blocks) == (8, 2, 128, 1)
    assert s1.row_blocks == 1024 and s1.rows_per_block == 128  # a row a thread, < 1,056
    s3 = fb.fwd_geometry(128 * 8 * 8, 64, 2, True, 132, 8)  # stage 3, bf16: capped by rows
    assert (s3.vec, s3.cg, s3.rb) == (8, 8, 32)
    assert s3.row_blocks == 256 and s3.rows_per_block == 32
    s2 = fb.fwd_geometry(128 * 16 * 16, 32, 4, True, 132, 8)  # stage 2, f32
    assert (s2.vec, s2.cg, s2.rb, s2.row_blocks) == (4, 8, 32, 1024)
    wide = fb.bwd_geometry(128 * 8 * 8, 64, 2, True, 132, 8)  # the backward's fold cap
    assert wide.row_blocks == 64 and fb.fwd_geometry(128 * 8 * 8, 64, 2, True, 132, 2) != wide


def test_bwd_geometry_fills_the_card_once():
    """On an H100 (132 SMs) the grid is at most one resident wave, with no
    thread left without a row, and at most FOLD_FLOATS partials to fold."""
    from fedml_tpu_torch.ops import fused_block as fb

    geo = fb.bwd_geometry(128 * 16 * 16, 32, 2, True, 100, 1)  # stage 2, bf16
    assert (geo.vec, geo.cg, geo.rb) == (8, 4, 64)
    assert geo.row_blocks == 100 and geo.rows_per_block == 328  # the wave
    wide = fb.bwd_geometry(128 * 8 * 8, 64, 2, True, 132, 2)  # stage 3, bf16
    assert wide.row_blocks == 64 and wide.scratch_floats == fb.FOLD_FLOATS
    thin = fb.bwd_geometry(2048, 16, 4, True, 132, 8)  # a row a thread
    assert thin.row_blocks == 32 and thin.rows_per_block == 64 == thin.rb
    small = fb.bwd_geometry(100, 16, 2, True, 132, 8)  # capped by the rows
    assert small.row_blocks == 1 and small.rows_per_block == 100


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
def test_vector_variant_exactly_when_divisible_and_aligned(itemsize):
    """16-byte loads (VEC = 16 / itemsize channels a thread) exactly when C
    is a multiple of VEC and every pointer is 16-byte aligned; the scalar
    variant otherwise."""
    from fedml_tpu_torch.ops import fused_block as fb

    vec = 16 // itemsize
    for c in list(range(1, 70)) + [128, 300, 301]:
        for aligned in (True, False):
            want = vec if c % vec == 0 and aligned else 1
            assert fb.vector_width(c, itemsize, aligned) == want
            assert fb.bwd_geometry(64, c, itemsize, aligned, 2, 4).vec == want
    dtype = {4: torch.float32, 2: torch.bfloat16}[itemsize]
    base = torch.zeros(4096, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    for k in range(3 * vec):
        view = base[k:k + 64].view(4, 16)
        assert view.is_contiguous()
        assert fb.aligned16([base.data_ptr(), view.data_ptr()]) == (k * itemsize % 16 == 0)


def test_cpu_backward_counts_no_variant():
    """The CPU path launches nothing: every variant count, the backward's
    and the forward's, stays 0."""
    from fedml_tpu_torch.ops import fused_block as fb

    fb.reset_launch_counts()
    y, r, g, s, b = _t(*_inputs((2, 4, 4, 16), seed=7))
    out = fb.fused_block_forward(y, s, b, r)
    fb.fused_block_backward(g, y, s, out, True)
    assert fb.variant_counts() == {"vector": 0, "scalar": 0, "fwd_vector": 0, "fwd_scalar": 0}


def test_ticket_slots_under_threads(monkeypatch):
    """Ticket slots handed out from many threads at once: a stream keeps
    one slot, every stream and every capture gets a slot no other holds,
    and running out raises."""
    import sys
    import threading

    from fedml_tpu_torch.ops import fused_block as fb

    monkeypatch.setattr(fb, "_SLOTS", {})
    monkeypatch.setattr(fb, "_NEXT_SLOT", {})
    got, errors = {}, []

    def work(w):
        try:
            mine = []
            for k in range(50):
                mine.append((("stream", w % 4), fb._ticket_slot(0, 1000 + w % 4)))
                owner = ("capture", w * 50 + k, 1000 + w % 4)
                mine.append((("captured", w, k), fb._ticket_slot(0, owner)))
            got[w] = mine
        except Exception as e:  # surfaced below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,)) for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    slots = {}
    for mine in got.values():
        for key, slot in mine:
            slots.setdefault(key, set()).add(slot)
    assert all(len(v) == 1 for v in slots.values())  # a stream keeps its slot
    owners = [next(iter(v)) for v in slots.values()]
    assert len(owners) == 4 + 16 * 50 == len(set(owners))  # no slot shared
    assert fb._ticket_slot(1, 7) == 0  # per device
    monkeypatch.setitem(fb._NEXT_SLOT, 1, fb.TICKET_SLOTS)
    with pytest.raises(RuntimeError, match="ticket slots"):
        fb._ticket_slot(1, ("capture", 1, 7))


def test_captured_calls_take_one_slot_per_capture(monkeypatch):
    """Backward calls captured into a CUDA graph (capture faked):
    TICKET_SLOTS + 4 calls of one capture on one stream take one slot; a
    second capture takes a second, a second stream of the same capture a
    third, and the eager stream keeps its own."""
    from fedml_tpu_torch.ops import fused_block as fb

    monkeypatch.setattr(fb, "_SLOTS", {})
    monkeypatch.setattr(fb, "_NEXT_SLOT", {})
    capture = {"id": 11}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(fb, "_capture_id", lambda stream: capture["id"])
    cpu = torch.device("cpu")
    slots = {fb._workspace(cpu, 500, 64)[0] for _ in range(fb.TICKET_SLOTS + 4)}
    assert len(slots) == 1
    capture["id"] = 12
    second = {fb._workspace(cpu, 500, 64)[0] for _ in range(100)}
    other_stream = fb._workspace(cpu, 501, 64)[0]
    assert len(second) == 1 and second.isdisjoint(slots) and other_stream not in slots | second
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    eager, scratch = fb._workspace(cpu, 500, 64)
    assert eager not in slots | second | {other_stream} and scratch.numel() == 64
    assert fb._NEXT_SLOT[None] == 4


def test_ablation_copies_patch_the_kernel_source():
    """obs/ablate_bwd.py cuts the kernel at marked places of its source;
    each cut-down copy differs from the source where it should."""
    from fedml_tpu_torch.obs import ablate_bwd
    from fedml_tpu_torch.ops import build

    src = build.SOURCES["fused_block"].read_text()
    copies = ablate_bwd.variants(src)
    assert copies["full"] == src
    for name in ("no_fold", "no_reduction"):
        assert copies[name].count(ablate_bwd.EXIT.strip()) == 1
        assert copies[name].index(ablate_bwd.EXIT.strip()) < copies[name].index(
            ablate_bwd.FOLD_START.strip())
    assert copies["no_reduction"].index(ablate_bwd.EXIT.strip()) < copies["no_reduction"].index(
        ablate_bwd.REDUCTION_START.strip())
    assert "constexpr int kUnroll = 4;" in copies["unroll4"]
    with pytest.raises(RuntimeError, match="has no"):
        ablate_bwd.variants(src.replace(ablate_bwd.FOLD_START, ""))


def test_forward_ablation_copies_patch_the_kernel_source():
    """obs/ablate_fwd.py changes one thing of the forward kernel in each
    copy: the unroll depth, the load policy, the row order or the loads of
    the per-channel vectors (inside the forward kernel only)."""
    from fedml_tpu_torch.obs import ablate_fwd
    from fedml_tpu_torch.ops import build

    src = build.SOURCES["fused_block"].read_text()
    copies = ablate_fwd.variants(src)
    assert copies["full"] == src
    depth = ablate_fwd.UNROLL.search(src).group(1)
    for d in {"1", "2", "4"} - {depth}:
        assert f"constexpr int kFwdUnroll = {d};" in copies[f"unroll{d}"]
    assert f"unroll{depth}" not in copies
    tail = src.split(ablate_fwd.KERNEL_END)[1]
    for name in ("ldg", "flat", "vectors_late", "const_vectors"):
        head, rest = copies[name].split(ablate_fwd.KERNEL_END)
        assert rest == tail and head != src.split(ablate_fwd.KERNEL_END)[0], name
    assert ablate_fwd.EVICT_FIRST not in copies["ldg"].split(ablate_fwd.KERNEL_END)[0]
    assert ablate_fwd.LDG not in copies["plain_loads"]
    assert ablate_fwd.FLAT_ROWS in copies["flat"] and "r + u * step" in copies["flat"]
    assert "load_channels" not in copies["const_vectors"].split(ablate_fwd.KERNEL_START)[1].split(
        ablate_fwd.KERNEL_END)[0]
    with pytest.raises(RuntimeError, match="has no"):
        ablate_fwd.variants(src.replace("constexpr int kFwdUnroll", "constexpr int kUnrollFwd"))
    with pytest.raises(RuntimeError, match="has no"):
        ablate_fwd.variants(src.replace(ablate_fwd.EVICT_FIRST, "load_pack<T, VEC>"))


def _lane_inputs(lanes, shape, seed):
    """``lanes`` lane-major copies of ``_inputs`` with per-lane scale and
    shift (lane 1's differ the most)."""
    parts = [_inputs(shape, seed=seed + k) for k in range(lanes)]
    return [np.stack([p[i] for p in parts]) for i in range(5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (2, 3, 3, 300)])
def test_lane_plain_versions_equal_a_per_lane_loop(shape, dtype):
    """The plain versions given (L, C) scale and shift and lane-major
    activations: out, dy and dr bitwise a loop of the single-lane plain
    versions over the lanes; d_scale / d_shift (L, C) within 1e-5 *
    sum|terms| of theirs (sums over each lane's pixels, in another order)."""
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _t(*_lane_inputs(3, shape, seed=20))
    y, r, g = y.to(dtype), r.to(dtype), g.to(dtype)
    for residual in (False, True):
        res = r if residual else None
        out = fb.fused_block_reference(y, s, b, res)
        got = fb.fused_block_bwd_reference(g, y, s, out, residual)
        assert got[1].shape == got[2].shape == s.shape
        for lane in range(3):
            one = fb.fused_block_reference(y[lane], s[lane], b[lane],
                                           None if res is None else r[lane])
            assert torch.equal(one, out[lane])
            want = fb.fused_block_bwd_reference(g[lane], y[lane], s[lane], one, residual)
            assert torch.equal(got[0][lane], want[0])
            assert not residual or torch.equal(got[3][lane], want[3])
            gm = g[lane].float() * (one > 0).float()
            for i, terms in ((1, (gm * y[lane].float()).abs()), (2, gm.abs())):
                bound = 1e-5 * terms.reshape(-1, shape[-1]).sum(0) + 1e-30
                assert bool(((got[i][lane] - want[i]).abs() <= bound).all()), i


@pytest.mark.parametrize("residual", [False, True])
def test_lane_grads_match_jax_vmap(residual):
    """The lane form through the autograd.Function against ``jax.vmap`` of
    the interpret kernel's ``custom_vjp`` (Pallas's batching rule: a lane
    axis in front, per-lane scale and shift), as ``test_grads_match_jax``
    holds one lane."""
    from fedml_tpu.ops.pallas import fused_bn_relu as jax_relu
    from fedml_tpu.ops.pallas import fused_bn_residual_relu as jax_res
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _lane_inputs(3, (2, 4, 4, 16), seed=30)
    s = np.sign(s) * 2.0 ** np.round(np.log2(np.abs(s) + 1e-3)).astype(np.float32)
    if residual:
        def loss(y, s, b, r):
            out = jax.vmap(partial(jax_res, interpret=True))(y, s, b, r)
            return jnp.sum(out * g)
        args = (y, s, b, r)
    else:
        def loss(y, s, b):
            return jnp.sum(jax.vmap(partial(jax_relu, interpret=True))(y, s, b) * g)
        args = (y, s, b)
    ref = jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(*args)
    leaves = [t.requires_grad_(True) for t in _t(*args)]
    out = fb.fused_bn_residual_relu(*leaves) if residual else fb.fused_bn_relu(*leaves)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for name, a, e in zip(["dy", "d_scale", "d_shift", "dr"], got, ref):
        e = np.asarray(e)
        assert tuple(a.shape) == e.shape, name
        tol = 1e-5 if name in ("d_scale", "d_shift") else 1e-6
        np.testing.assert_allclose(a.numpy(), e, rtol=tol, atol=tol if tol == 1e-5 else 0,
                                   err_msg=name)


def test_lane_operand_checks():
    """The lane form takes lane-major contiguous (L, N, H, W, C) with
    contiguous f32 (L, C) vectors, and raises on anything else."""
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, _, s, b = _t(*_lane_inputs(3, (2, 4, 4, 16), seed=40))
    assert fb._check(y, (s, b), (r,)) == 3
    assert fb._check(y[0], (s[0], b[0]), (r[0],)) == 0
    with pytest.raises(ValueError, match="lane-major"):
        fb._check(y[0], (s, b), ())
    with pytest.raises(ValueError, match="per-channel vector"):
        fb._check(y, (s[:2], b[:2]), ())
    with pytest.raises(ValueError, match="per-channel vector"):
        fb._check(y, (s.t().contiguous().t(), b), ())
    with pytest.raises(ValueError, match="must match"):
        fb._check(y, (s, b), (r[:2],))


def test_ticket_slots_take_one_a_lane(monkeypatch):
    """A launch of L lanes takes L consecutive ticket slots of its owner; a
    later launch of more lanes takes a new, wider range past every slot
    handed out, and single-lane launches reuse the owner's first slot."""
    from fedml_tpu_torch.ops import fused_block as fb

    monkeypatch.setattr(fb, "_SLOTS", {})
    monkeypatch.setattr(fb, "_NEXT_SLOT", {})
    assert fb._ticket_slot(0, "a") == 0
    assert fb._ticket_slot(0, "b", 64) == 1
    assert fb._ticket_slot(0, "b") == 1 and fb._ticket_slot(0, "b", 64) == 1
    assert fb._ticket_slot(0, "a", 3) == 65 and fb._ticket_slot(0, "a") == 65
    assert fb._NEXT_SLOT[0] == 68
    monkeypatch.setitem(fb._NEXT_SLOT, 0, fb.TICKET_SLOTS - 2)
    with pytest.raises(RuntimeError, match="ticket slots"):
        fb._ticket_slot(0, "c", 3)
    assert fb._ticket_slot(0, "c", 2) == fb.TICKET_SLOTS - 2
