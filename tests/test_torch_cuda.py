"""The port's kernels on the card (marker ``cuda``; skipped without one).

This file imports only torch and the port, so it also runs on the machine
with the card, where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: f32 forward and dy / dr bitwise against the plain versions, bf16
to one bf16 ulp (the same f32 math and rounding), and the forward's variants
bitwise in bf16 too (one rounding of the same f32 value), d_scale / d_shift to rtol
1e-5 / atol 1e-4 (f32 sums of up to ~10k terms in another order), and at the
flagship's stage shapes (up to 131k terms a channel) within 1e-5 * sum|terms|
per channel, as ``chip_smoke.py`` holds them; the lane-batched variants
(L = 64 lane-major activations, per-lane scale and shift, one launch) every
lane bitwise the single-lane launch on its slice, d_scale / d_shift included
(the same fold in the same order), and against the plain version as above; the backward bitwise equal to
itself over calls, under CUDA-graph replay and from two streams; the fused
ResNet step on the card against the CPU to rtol 1e-3 / atol 1e-4 (cuDNN and
CPU convolutions, TF32 off).  The int8 quantize / dequantize kernels:
values, scales and the dequantized vector bitwise against the plain
versions on the card and on the CPU (IEEE divides, order-free max), in
both variants (16-byte and scalar accesses), a NaN scale as a NaN; the
lane-batched quantize and dequantize (16 lanes, one launch each) bitwise per
lane.  A MESH round on the card against the same round on the CPU to rtol
1e-3 / atol 1e-4, each fused site launched once a batched step.  The
central-DP noise kernel: bitwise against its plain version on the card and
on the CPU (the multiply, then the add, each rounded), in both variants.  A Shamir SecAgg
finalize on the card against the CPU: bitwise without DP; with central DP
the clip's norm sums in another order, so one ulp plus 1e-5 of the clipped
delta's largest element (two ulps after the noise).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips without one.  Decided at run time, so
    every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(shape, dtype, device, seed=7):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    y, r, g = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device, dtype)
               for _ in range(3))
    s, b = (torch.from_numpy(rs.randn(c).astype(np.float32)).to(device) for _ in range(2))
    return y, r, g, s, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32, 32, 16), (4, 7, 9, 24), (8, 8, 8, 64), (2, 3, 3, 300)])
def test_kernels_match_plain_versions(shape, dtype, cuda_device):
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _inputs(shape, dtype, cuda_device)
    ulp = 0.0 if dtype == torch.float32 else 2.0 ** -8
    for residual in (None, r):
        before = fb.launch_counts()
        out = fb.fused_block_forward(y, s, b, residual)
        torch.testing.assert_close(out, fb.fused_block_reference(y, s, b, residual),
                                   rtol=ulp, atol=0)
        got = fb.fused_block_backward(g, y, s, out, residual is not None)
        want = fb.fused_block_bwd_reference(g, y, s, out, residual is not None)
        torch.testing.assert_close(got[0], want[0], rtol=ulp, atol=0)
        if residual is not None:
            torch.testing.assert_close(got[3], want[3], rtol=ulp, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-4)
        after = fb.launch_counts()
        fwd, bwd = (fb.FWD_RES, fb.BWD_RES) if residual is not None else (fb.FWD, fb.BWD)
        assert after[fwd.name] == before[fwd.name] + 1
        assert after[bwd.name] == before[bwd.name] + 1


@pytest.mark.cuda
def test_backward_reduction_is_deterministic(cuda_device):
    """No atomics: the same inputs give bitwise the same d_scale / d_shift."""
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _inputs((64, 16, 16, 32), torch.bfloat16, cuda_device)
    out = fb.fused_block_forward(y, s, b, r)
    first = fb.fused_block_backward(g, y, s, out, True)
    for _ in range(3):
        again = fb.fused_block_backward(g, y, s, out, True)
        for a, e in zip(again, first):
            assert torch.equal(a, e)


STAGES = [(128, 32, 32, 16), (128, 16, 16, 32), (128, 8, 8, 64)]


def _assert_bwd_matches(got, want, g, y, out, residual):
    """dy / dr bitwise in f32, one bf16 ulp in bf16; d_scale / d_shift
    within 1e-5 * sum|terms| per channel."""
    ulp = 0.0 if y.dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got[0], want[0], rtol=ulp, atol=0)
    if residual:
        torch.testing.assert_close(got[3], want[3], rtol=ulp, atol=0)
    gm = g.float() * (out > 0).float()
    c = y.shape[-1]
    for i, terms in ((1, (gm * y.float()).abs()), (2, gm.abs())):
        bound = 1e-5 * terms.reshape(-1, c).sum(0) + 1e-30
        assert bool(((got[i] - want[i]).abs() <= bound).all()), i


def _bwd_case(shape, dtype, device, residual, seed=11):
    """``(g, y, scale, out)`` of one backward call."""
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _inputs(shape, dtype, device, seed)
    return g, y, s, fb.fused_block_reference(y, s, b, r if residual else None)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STAGES)
def test_backward_matches_plain_at_stage_shapes(shape, dtype, residual, cuda_device):
    """The one-launch backward at the flagship's three stage shapes, on the
    vector variant (C = 16, 32, 64 are multiples of 4 and 8)."""
    from fedml_tpu_torch.ops import fused_block as fb

    g, y, s, out = _bwd_case(shape, dtype, cuda_device, residual)
    before, variants = fb.launch_counts(), fb.variant_counts()
    got = fb.fused_block_backward(g, y, s, out, residual)
    want = fb.fused_block_bwd_reference(g, y, s, out, residual)
    _assert_bwd_matches(got, want, g, y, out, residual)
    kernel = fb.BWD_RES if residual else fb.BWD
    assert fb.launch_counts()[kernel.name] == before[kernel.name] + 1
    assert fb.variant_counts()["vector"] == variants["vector"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STAGES)
def test_lane_kernels_bitwise_per_lane_at_stage_shapes(shape, dtype, residual, cuda_device):
    """The lane-batched forward and backward at the MESH round's 64 lanes
    and the three stage shapes: one launch each, every lane bitwise the
    single-lane launch on its slice, and the plain version's tolerances."""
    from fedml_tpu_torch.ops import fused_block as fb

    lanes = 64
    y, r, g, s, b = _inputs((lanes,) + shape, dtype, cuda_device, seed=13)
    s, b = (torch.randn((lanes, shape[-1]), device=cuda_device) for _ in range(2))
    res = r if residual else None
    before = fb.launch_counts()
    out = fb.fused_block_forward(y, s, b, res)
    got = fb.fused_block_backward(g, y, s, out, residual)
    after = fb.launch_counts()
    fwd, bwd = (fb.FWD_RES_LANES, fb.BWD_RES_LANES) if residual else (fb.FWD_LANES, fb.BWD_LANES)
    assert after[fwd.name] == before[fwd.name] + 1 and after[bwd.name] == before[bwd.name] + 1
    assert torch.equal(out, fb.fused_block_reference(y, s, b, res))
    want = fb.fused_block_bwd_reference(g, y, s, out, residual)
    ulp = 0.0 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got[0], want[0], rtol=ulp, atol=0)
    gm = g.float() * (out > 0).float()
    for i, terms in ((1, (gm * y.float()).abs()), (2, gm.abs())):
        bound = 1e-5 * terms.reshape(lanes, -1, shape[-1]).sum(1) + 1e-30
        assert bool(((got[i] - want[i]).abs() <= bound).all()), i
    for lane in range(lanes):
        one = fb.fused_block_forward(y[lane], s[lane], b[lane], None if res is None else res[lane])
        assert torch.equal(one, out[lane])
        single = fb.fused_block_backward(g[lane], y[lane], s[lane], one, residual)
        for a, e in zip(single, got):
            assert (a is None and e is None) or torch.equal(a, e[lane])


@pytest.mark.cuda
def test_lane_kernels_take_consecutive_ticket_slots(cuda_device):
    """A lane-batched backward takes one ticket slot a lane on its stream
    and leaves every ticket reset: a single-lane call after it on the same
    stream, and the same lane call again, are bitwise as before."""
    from fedml_tpu_torch.ops import fused_block as fb

    lanes = 5
    y, r, g, s, b = _inputs((lanes, 8, 16, 16, 32), torch.bfloat16, cuda_device, seed=17)
    s = s.expand(lanes, -1).contiguous()
    out = fb.fused_block_forward(y, s, b.expand(lanes, -1).contiguous(), r)
    first = fb.fused_block_backward(g, y, s, out, True)
    single = fb.fused_block_backward(g[2], y[2], s[2], out[2], True)
    again = fb.fused_block_backward(g, y, s, out, True)
    for a, e in zip(again, first):
        assert torch.equal(a, e)
    for a, e in zip(single, first):
        assert torch.equal(a, e[2])


def _misaligned(t):
    """A contiguous copy of t that starts one element past a 16-byte line."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = base[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("case,variant", [
    ("c12_bf16", "scalar"), ("c6_f32", "scalar"), ("c300_bf16", "scalar"),
    ("c300_f32", "vector"), ("misaligned_y_bf16", "scalar"), ("misaligned_g_f32", "scalar")])
def test_backward_variant_choice(case, variant, cuda_device):
    """C % VEC != 0 (VEC = 8 bf16, 4 f32) or an operand at an odd storage
    offset take the scalar variant of the same kernel; C = 300 in bf16 also
    puts channel tiles on blockIdx.y, and in f32 (a multiple of 4) takes the
    vector variant with 75 channel groups a row.  Each matches the plain
    version, and the wrapper reports the variant it chose."""
    from fedml_tpu_torch.ops import fused_block as fb

    shape, dtype = {"c12_bf16": ((4, 7, 9, 12), torch.bfloat16),
                    "c6_f32": ((4, 7, 9, 6), torch.float32),
                    "c300_bf16": ((2, 3, 3, 300), torch.bfloat16),
                    "c300_f32": ((2, 3, 3, 300), torch.float32),
                    "misaligned_y_bf16": ((8, 8, 8, 16), torch.bfloat16),
                    "misaligned_g_f32": ((8, 8, 8, 16), torch.float32)}[case]
    g, y, s, out = _bwd_case(shape, dtype, cuda_device, True)
    if case.startswith("misaligned_y"):
        y = _misaligned(y)
    if case.startswith("misaligned_g"):
        g = _misaligned(g)
    before = fb.variant_counts()
    got = fb.fused_block_backward(g, y, s, out, True)
    want = dict(before)
    want[variant] += 1
    assert fb.variant_counts() == want
    _assert_bwd_matches(got, fb.fused_block_bwd_reference(g, y, s, out, True), g, y, out, True)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
def test_backward_bitwise_over_ten_calls(residual, cuda_device):
    """At (128, 32, 32, 16) bf16 the grid is ~a thousand blocks that finish
    in a different order each call; the fold order is fixed by the geometry,
    so every output is bitwise the same."""
    from fedml_tpu_torch.ops import fused_block as fb

    g, y, s, out = _bwd_case(STAGES[0], torch.bfloat16, cuda_device, residual)
    first = fb.fused_block_backward(g, y, s, out, residual)
    for _ in range(9):
        again = fb.fused_block_backward(g, y, s, out, residual)
        for a, e in zip(again, first):
            assert (a is None and e is None) or torch.equal(a, e)


@pytest.mark.cuda
def test_backward_cuda_graph_replay_matches_eager(cuda_device):
    """A backward captured in a CUDA graph and replayed 3 times equals the
    eager call bitwise: its tickets were zero at capture and are reset by
    each launch.  The outputs are poisoned before each replay, so a replay
    that never reached its last block would show."""
    from fedml_tpu_torch.ops import fused_block as fb

    g, y, s, out = _bwd_case(STAGES[1], torch.bfloat16, cuda_device, True)
    want = fb.fused_block_backward(g, y, s, out, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fb.fused_block_backward(g, y, s, out, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fb.fused_block_backward(g, y, s, out, True)
    for _ in range(3):
        for t in got:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for a, e in zip(got, want):
            assert torch.equal(a, e)


@pytest.mark.cuda
def test_backward_two_streams_at_once_match_serial(cuda_device):
    """Two threads, each on its own stream (its own ticket slot and
    scratch), run backward calls at once: every result is bitwise the same
    call made serially."""
    import threading

    from fedml_tpu_torch.ops import fused_block as fb

    cases = [_bwd_case(STAGES[0], torch.bfloat16, cuda_device, True, seed=21),
             _bwd_case(STAGES[2], torch.float32, cuda_device, False, seed=22)]
    serial = [fb.fused_block_backward(*args, residual)
              for args, residual in zip(cases, (True, False))]
    torch.cuda.synchronize()
    results, errors = [[], []], []

    def work(i, residual):
        try:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.default_stream())
            with torch.cuda.stream(stream):
                for _ in range(20):
                    results[i].append(fb.fused_block_backward(*cases[i], residual))
            stream.synchronize()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i, r)) for i, r in enumerate((True, False))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i in range(2):
        assert len(results[i]) == 20
        for res in results[i]:
            for a, e in zip(res, serial[i]):
                assert (a is None and e is None) or torch.equal(a, e)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STAGES)
def test_forward_vector_variant_at_stage_shapes(shape, dtype, residual, cuda_device):
    """The forward at the flagship's three stage shapes takes the vector
    variant (16-byte loads; C = 16, 32, 64) and equals the plain version
    bitwise in f32 and bf16."""
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, _, s, b = _inputs(shape, dtype, cuda_device, seed=31)
    res = r if residual else None
    before, variants = fb.launch_counts(), fb.variant_counts()
    out = fb.fused_block_forward(y, s, b, res)
    assert torch.equal(out, fb.fused_block_reference(y, s, b, res))
    kernel = fb.FWD_RES if residual else fb.FWD
    assert fb.launch_counts()[kernel.name] == before[kernel.name] + 1
    want = dict(variants)
    want["fwd_vector"] += 1
    assert fb.variant_counts() == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,variant", [
    ("c12", {torch.float32: "fwd_vector", torch.bfloat16: "fwd_scalar"}),
    ("c3", "fwd_scalar"), ("c300", {torch.float32: "fwd_vector", torch.bfloat16: "fwd_scalar"}),
    ("misaligned_y", "fwd_scalar"), ("misaligned_r", "fwd_scalar"),
    ("misaligned_scale", "fwd_scalar")])
def test_forward_variant_choice(case, variant, dtype, cuda_device):
    """C % VEC != 0 (VEC = 8 bf16, 4 f32) or an operand at an odd offset
    takes the forward's scalar variant; C = 300 also puts channel tiles on
    blockIdx.y.  Each equals the plain version bitwise, with and without
    the residual, and the wrapper reports the variant it chose."""
    from fedml_tpu_torch.ops import fused_block as fb

    shape = {"c12": (4, 7, 9, 12), "c3": (4, 7, 9, 3), "c300": (2, 3, 3, 300)}.get(
        case, (8, 8, 8, 16))
    y, r, _, s, b = _inputs(shape, dtype, cuda_device, seed=32)
    if case == "misaligned_y":
        y = _misaligned(y)
    if case == "misaligned_r":
        r = _misaligned(r)
    if case == "misaligned_scale":
        s = _misaligned(s)
    name = variant if isinstance(variant, str) else variant[dtype]
    for res in ((None, r) if case != "misaligned_r" else (r,)):
        before = fb.variant_counts()
        out = fb.fused_block_forward(y, s, b, res)
        want = dict(before)
        want[name] += 1
        assert fb.variant_counts() == want
        assert torch.equal(out, fb.fused_block_reference(y, s, b, res))


@pytest.mark.cuda
def test_forward_cuda_graph_replay_matches_eager(cuda_device):
    """Forward calls of both kernels and dtypes captured in one CUDA graph
    and replayed 3 times equal the eager calls bitwise (outputs poisoned
    before each replay)."""
    from fedml_tpu_torch.ops import fused_block as fb

    cases = [_inputs(STAGES[k], dtype, cuda_device, seed=33 + k)
             for k, dtype in enumerate((torch.bfloat16, torch.float32, torch.bfloat16))]
    calls = [(y, s, b, res) for y, r, _, s, b in cases for res in (None, r)]
    want = [fb.fused_block_forward(*c) for c in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            fb.fused_block_forward(*c)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = [fb.fused_block_forward(*c) for c in calls]
    for _ in range(3):
        for t in got:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for a, e in zip(got, want):
            assert torch.equal(a, e)


@pytest.mark.cuda
def test_backward_graph_of_many_calls_takes_one_slot(cuda_device):
    """One CUDA graph holding more than TICKET_SLOTS backward calls (both
    kernels, alternating) captures with one ticket slot, not one a call, and
    each replay equals the eager calls bitwise."""
    from fedml_tpu_torch.ops import fused_block as fb

    cases = [(_bwd_case((2, 4, 4, 16), torch.bfloat16, cuda_device, residual, seed=40 + residual),
              residual) for residual in (False, True)]
    want = [fb.fused_block_backward(*args, residual) for args, residual in cases]
    calls = fb.TICKET_SLOTS + 4
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args, residual in cases:
            fb.fused_block_backward(*args, residual)
    torch.cuda.current_stream().wait_stream(side)
    slots = fb._NEXT_SLOT.get(0, 0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = [fb.fused_block_backward(*cases[k % 2][0], cases[k % 2][1]) for k in range(calls)]
    assert fb._NEXT_SLOT.get(0, 0) - slots == 1
    for _ in range(2):
        for out in got:
            for t in out:
                if t is not None:
                    t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for k, out in enumerate(got):
            for a, e in zip(out, want[k % 2]):
                assert (a is None and e is None) or torch.equal(a, e)


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_and_wrong_dtype(cuda_device):
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _inputs((2, 4, 4, 16), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        fb.fused_block_forward(y.permute(0, 3, 1, 2), s, b)
    with pytest.raises(TypeError):
        fb.fused_block_forward(y.half(), s, b)
    with pytest.raises(ValueError):
        fb.fused_block_forward(y, s.cpu(), b)


@pytest.mark.cuda
def test_fused_resnet_step_card_matches_cpu(cuda_device):
    """A fused resnet20 train step (f32) on the card equals the same step on
    the CPU: logits, grads and new batch stats."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import resnet

    model = resnet.resnet20(10, torch.float32, fused=True)
    gen = torch.Generator().manual_seed(0)
    variables = model.init(gen)
    x = torch.randn((4, 32, 32, 3), generator=gen)
    outs = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().to(dev, copy=True).requires_grad_(True)
                  for t in pt.tree_leaves(variables["params"])]
        params = pt.tree_unflatten_like(variables["params"], leaves)
        stats = pt.tree_map(lambda t: t.to(dev), variables["batch_stats"])
        logits, new_stats = model.apply({"params": params, "batch_stats": stats}, x.to(dev), True)
        grads = torch.autograd.grad((logits - 1.0).square().mean(), leaves)
        outs[str(dev)] = [t.detach().cpu() for t in [logits, *grads, *pt.tree_leaves(new_stats)]]
    for a, b in zip(outs["cpu"], outs[str(cuda_device)]):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 5000, 269722, 2**20 + 3])
def test_quantize_kernels_match_plain_versions(n, cuda_device):
    from fedml_tpu_torch.ops import quantize as qz

    rs = np.random.RandomState(n % 1000)
    x = (rs.randn(n) * np.exp(3 * rs.randn(n))).astype(np.float32)
    u = rs.rand(*qz.noise_shape(n)).astype(np.float32)
    xd, ud = torch.from_numpy(x).to(cuda_device), torch.from_numpy(u).to(cuda_device)
    before = qz.launch_counts()
    values, scales, length = qz.quantize_int8_stochastic(xd, ud)
    want = qz.quantize_int8_reference(xd, ud)
    cpu = qz.quantize_int8_reference(torch.from_numpy(x), torch.from_numpy(u))
    assert length == n and values.dtype == torch.int8 and values.shape == want[0].shape
    for got, ref in ((values, want[0]), (scales, want[1])):
        assert torch.equal(got, ref)
    assert torch.equal(values.cpu(), cpu[0]) and torch.equal(scales.cpu(), cpu[1])
    out = qz.dequantize_int8(values, scales, length)
    assert out.shape == (n,)
    assert torch.equal(out, qz.dequantize_int8_reference(values, scales, length))
    assert torch.equal(out.cpu(), qz.dequantize_int8_reference(cpu[0], cpu[1], n))
    after = qz.launch_counts()
    assert after[qz.QUANTIZE.name] == before[qz.QUANTIZE.name] + 1
    assert after[qz.DEQUANTIZE.name] == before[qz.DEQUANTIZE.name] + 1


# ragged lengths of 1 to 9 blocks (the last the flagship gradient's tail),
# the gradient itself and 2^24 with the same tail
QUANT_RAGGED = [1, 3, 1023, 1024, 1025, 4098, 8 * 1024 + 410, 269722, 2**24 + 410]


def _assert_bitwise(got, want):
    """Equal bit for bit, a NaN as a NaN."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if not got.is_floating_point():
        assert torch.equal(got, want)
        return
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _quantize_both_variants(qz, x, u, misaligned):
    """Quantize and dequantize x through the wrappers, the operands one
    element off a 16-byte line when ``misaligned``; checks each launch ran
    the variant the alignment asks for and returns (values, scales, out)."""
    n = x.numel()
    if misaligned:
        x, u = _misaligned(x), _misaligned(u)
    variant = "scalar" if misaligned else "vector"
    before = qz.variant_counts()
    values, scales, length = qz.quantize_int8_stochastic(x, u)
    want = qz.quantize_int8_reference(x, u)
    assert length == n
    _assert_bitwise(values, want[0])
    _assert_bitwise(scales, want[1])
    if misaligned:
        values = _misaligned(values)
    out = qz.dequantize_int8(values, scales, n)
    _assert_bitwise(out, qz.dequantize_int8_reference(values, scales, n))
    expected = {k: dict(v) for k, v in before.items()}
    expected[qz.QUANTIZE.name][variant] += 1
    expected[qz.DEQUANTIZE.name][variant] += 1
    assert qz.variant_counts() == expected
    return values, scales, out


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("n", QUANT_RAGGED)
def test_quantize_variants_match_plain_versions(n, misaligned, cuda_device):
    """Both variants of both kernels (the scalar one on operands one element
    off a 16-byte line) bitwise the plain versions on the card, at ragged
    lengths up to 2^24 + 410; each launch counted under its variant."""
    from fedml_tpu_torch.ops import quantize as qz

    g = torch.Generator(device=cuda_device)
    g.manual_seed(n % 1000 + misaligned)
    x = torch.randn(n, generator=g, device=cuda_device) * torch.exp(
        3 * torch.randn(n, generator=g, device=cuda_device))
    u = torch.rand(qz.noise_shape(n), generator=g, device=cuda_device)
    _quantize_both_variants(qz, x, u, misaligned)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
def test_quantize_special_blocks_match_plain_versions(misaligned, cuda_device):
    """A block with a NaN (NaN scale, levels as PyTorch casts a NaN), one
    with +-inf (inf scale), an all-zero block and a block of -0.0 (scale
    1e-12, levels 0), then a ragged tail: both variants bitwise the plain
    versions."""
    from fedml_tpu_torch.ops import quantize as qz

    n = 4 * 1024 + 410
    rs = np.random.RandomState(5)
    x = (rs.randn(n) * 10).astype(np.float32)
    x[300] = np.nan
    x[1024 + 5], x[1024 + 900] = np.inf, -np.inf
    x[2048:3072] = 0.0
    x[3072:4096] = -0.0
    u = rs.rand(*qz.noise_shape(n)).astype(np.float32)
    _, scales, _ = _quantize_both_variants(qz, torch.from_numpy(x).to(cuda_device),
                                           torch.from_numpy(u).to(cuda_device), misaligned)
    assert scales[0].isnan() and scales[1].isinf()
    assert float(scales[2]) == float(scales[3]) == float(np.float32(1e-12))


@pytest.mark.cuda
def test_quantize_cuda_tensors_never_reach_the_plain_versions(cuda_device, monkeypatch):
    """With the plain versions made to raise, the wrappers and the round
    trip, single-lane and lane-batched, still run on CUDA tensors, through
    the kernels (launches counted)."""
    from fedml_tpu_torch.ops import quantize as qz

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    x = torch.randn(5000, device=cuda_device)
    u = torch.rand(qz.noise_shape(5000), device=cuda_device)
    want = qz.qsgd_int8(x, u)
    monkeypatch.setattr(qz, "quantize_int8_reference", refuse)
    monkeypatch.setattr(qz, "dequantize_int8_reference", refuse)
    before = qz.launch_counts()
    got = qz.qsgd_int8(x, u)
    values, scales, n = qz.quantize_int8_stochastic(_misaligned(x), _misaligned(u))
    qz.dequantize_int8(_misaligned(values), scales, n)
    assert torch.equal(got, want)
    lanes = qz.qsgd_int8_lanes(torch.stack([x, x]), torch.stack([u, u]))
    assert torch.equal(lanes[1], want)
    after = qz.launch_counts()
    assert all(after[k.name] == before[k.name] + 2 for k in qz.KERNELS)
    assert all(after[k.name] == before[k.name] + 1 for k in qz.LANE_KERNELS)


@pytest.mark.cuda
def test_quantize_vector_entry_refuses_misaligned_operands(cuda_device):
    """The C entries refuse the vector variant on operands off a 16-byte
    line, and an empty length (they do not launch)."""
    from fedml_tpu_torch.ops import quantize as qz

    x = torch.randn(2049, device=cuda_device)
    u = torch.rand(qz.noise_shape(2048), device=cuda_device)
    values = torch.empty(qz.noise_shape(2048), dtype=torch.int8, device=cuda_device)
    scales = torch.empty(2, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    lib = qz._lib()
    assert lib.quantize_int8(x[1:].data_ptr(), u.data_ptr(), values.data_ptr(), scales.data_ptr(),
                             2048, 1, stream) != 0
    assert lib.quantize_int8(x.data_ptr(), u.data_ptr(), values.data_ptr(), scales.data_ptr(),
                             0, 0, stream) != 0
    assert lib.dequantize_int8(values[0, 0, 1:].data_ptr(), scales.data_ptr(), x.data_ptr(), 100,
                               1, stream) != 0
    assert lib.dequantize_int8(values.data_ptr(), scales.data_ptr(), x.data_ptr(), 0, 0,
                               stream) != 0


@pytest.mark.cuda
def test_quantize_cuda_graph_replay_matches_eager(cuda_device):
    """Quantize and dequantize calls of both variants captured in one CUDA
    graph and replayed 3 times equal the eager calls bitwise (outputs
    poisoned before each replay)."""
    from fedml_tpu_torch.ops import quantize as qz

    g = torch.Generator(device=cuda_device)
    g.manual_seed(3)
    cases = []
    for n, misaligned in ((269722, False), (269722, True), (1025, False)):
        x = torch.randn(n, generator=g, device=cuda_device)
        u = torch.rand(qz.noise_shape(n), generator=g, device=cuda_device)
        cases.append((_misaligned(x), _misaligned(u)) if misaligned else (x, u))

    def calls():
        outs = []
        for x, u in cases:
            values, scales, n = qz.quantize_int8_stochastic(x, u)
            outs += [values, scales, qz.dequantize_int8(values, scales, n)]
        return outs

    want = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = calls()
    for _ in range(3):
        for t in got:
            t.fill_(-3)
        graph.replay()
        torch.cuda.synchronize()
        for a, e in zip(got, want):
            assert torch.equal(a, e)


@pytest.mark.cuda
def test_quantize_kernel_rejects_bad_operands(cuda_device):
    from fedml_tpu_torch.ops import quantize as qz

    x = torch.randn(3000, device=cuda_device)
    u = torch.rand(qz.noise_shape(3000), device=cuda_device)
    with pytest.raises(ValueError, match="noise must be"):
        qz.quantize_int8_stochastic(x, u[:2])
    with pytest.raises(ValueError, match="noise must be"):
        qz.quantize_int8_stochastic(x, u.double())
    with pytest.raises(ValueError):
        qz.quantize_int8_stochastic(x, u.cpu())
    with pytest.raises(ValueError, match="flat vector"):
        qz.quantize_int8_stochastic(x[:0], u[:0])
    values, scales, n = qz.quantize_int8_stochastic(x, u)
    with pytest.raises(ValueError):
        qz.dequantize_int8(values, scales[:2], n)
    with pytest.raises(ValueError):
        qz.dequantize_int8(values, scales, 5000)


@pytest.mark.cuda
def test_fedsgd_qsgd_int8_round_launches_the_kernels(cuda_device, tmp_path):
    """A tiny FedSGD qsgd_int8 run on the card: on MESH (the default) one
    lane-batched quantize and dequantize launch a round for all clients, on
    sp one launch per client per round; finite metrics."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.ops import quantize as qz
    from fedml_tpu_torch.runner import FedMLRunner

    for backend, per_client, per_round in (("MESH", 0, 2), ("sp", 8, 0)):
        cfg = fedml_tpu_torch.init(Config(
            dataset="cifar10", model="resnet20", client_num_in_total=4, client_num_per_round=4,
            comm_round=2, batch_size=8, synthetic_train_size=64, synthetic_test_size=40,
            partition_method="homo", federated_optimizer="FedSGD", compression="qsgd_int8",
            frequency_of_the_test=2, compute_dtype="bfloat16", data_cache_dir=str(tmp_path),
            backend_sim=backend))
        runner = FedMLRunner(cfg, device=cuda_device)
        qz.reset_launch_counts()
        hist = runner.run()
        assert qz.launch_counts() == {
            qz.QUANTIZE.name: per_client, qz.DEQUANTIZE.name: per_client,
            qz.QUANTIZE_LANES.name: per_round, qz.DEQUANTIZE_LANES.name: per_round}
        assert np.isfinite(hist[-1]["test_loss"])


@pytest.mark.cuda
def test_lane_quantize_bitwise_per_lane(cuda_device):
    """16 lanes of the FedSGD gradient's 269,722 elements: one quantize and
    one dequantize launch, every lane bitwise its own single-lane calls and
    the plain versions."""
    from fedml_tpu_torch.ops import quantize as qz

    lanes, n = 16, 269722
    g = torch.Generator(device=cuda_device)
    g.manual_seed(3)
    x = torch.randn((lanes, n), generator=g, device=cuda_device) * torch.exp(
        3 * torch.randn((lanes, n), generator=g, device=cuda_device))
    u = torch.rand((lanes,) + qz.noise_shape(n), generator=g, device=cuda_device)
    before = qz.launch_counts()
    values, scales, length = qz.quantize_int8_lanes(x, u)
    deq = qz.dequantize_int8_lanes(values, scales, length)
    after = qz.launch_counts()
    assert all(after[k.name] == before[k.name] + 1 for k in qz.LANE_KERNELS)
    want = qz.quantize_int8_lanes_reference(x, u)
    assert torch.equal(values, want[0]) and torch.equal(scales, want[1])
    assert torch.equal(deq, qz.dequantize_int8_lanes_reference(values, scales, length))
    for lane in range(lanes):
        v1, s1, _ = qz.quantize_int8_stochastic(x[lane], u[lane])
        assert torch.equal(v1, values[lane]) and torch.equal(s1, scales[lane])
        assert torch.equal(qz.dequantize_int8(v1, s1, n), deq[lane])


@pytest.mark.cuda
def test_mesh_round_card_matches_cpu(cuda_device, tmp_path):
    """A fused f32 MESH round (ResNet, one block a stage, 3 of 4 clients)
    on the card against the same round on the CPU, rtol 1e-3 / atol 1e-4
    (cuDNN and CPU convolutions, TF32 off); each fused site launched in its
    lanes variant once a batched step, the single-lane backward never."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.ops import fused_block as fb
    from fedml_tpu_torch.runner import FedMLRunner

    sims = {}
    for dev in ("cpu", cuda_device):
        cfg = fedml_tpu_torch.init(Config(
            dataset="cifar10", model="resnet20", client_num_in_total=4, client_num_per_round=3,
            comm_round=1, batch_size=8, synthetic_train_size=64, synthetic_test_size=40,
            partition_method="hetero", partition_alpha=0.5, frequency_of_the_test=0,
            compute_dtype="float32", data_cache_dir=str(tmp_path), extra={"fused_blocks": True}))
        runner = FedMLRunner(cfg, model=resnet.CifarResNet(1, fused=True), device=dev)
        fb.reset_launch_counts()
        runner.run()
        sims[str(dev)] = runner.runner
    sim = sims[str(cuda_device)]
    counts = sim.counts[sim.sampler.sample(0)]
    steps = int(min(sim.hp.local_steps, -(-counts.max() // cfg.batch_size)))
    launched = fb.launch_counts()
    assert launched[fb.FWD_LANES.name] == launched[fb.BWD_LANES.name] == 4 * steps
    assert launched[fb.FWD_RES_LANES.name] == launched[fb.BWD_RES_LANES.name] == 3 * steps
    assert launched[fb.BWD.name] == launched[fb.BWD_RES.name] == 0
    for a, b in zip(pt.tree_leaves(sims["cpu"].global_vars), pt.tree_leaves(sim.global_vars)):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 4097, 271098, 2**20 + 3])
def test_noise_kernel_matches_plain_version(n, cuda_device):
    """Bitwise at the slice's DP sigma and at 0.25; sigma 0 is the identity;
    one launch per call."""
    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.trust.dp.dp import gaussian_sigma

    rs = np.random.RandomState(n % 997)
    x = torch.from_numpy(rs.randn(n).astype(np.float32)).to(cuda_device)
    noise = torch.from_numpy(rs.randn(*nz.noise_shape(n)).astype(np.float32)).to(cuda_device)
    for sigma in (gaussian_sigma(50.0, 1e-5, 0.01), 0.25):
        before = nz.launch_counts()[nz.NOISE.name]
        out = nz.apply_gaussian_noise(x, noise, sigma)
        assert nz.launch_counts()[nz.NOISE.name] == before + 1
        assert out.shape == (n,) and out.device == x.device
        assert torch.equal(out, nz.apply_gaussian_noise_reference(x, noise, sigma))
        assert torch.equal(out.cpu(), nz.apply_gaussian_noise_reference(x.cpu(), noise.cpu(),
                                                                        sigma))
    assert torch.equal(nz.apply_gaussian_noise(x, noise, 0.0), x)


@pytest.mark.cuda
def test_noise_kernel_rejects_bad_operands(cuda_device):
    from fedml_tpu_torch.ops import noise as nz

    x = torch.randn(3000, device=cuda_device)
    noise = torch.randn(nz.noise_shape(3000), device=cuda_device)
    with pytest.raises(ValueError, match="noise must be"):
        nz.apply_gaussian_noise(x, noise[:2], 0.1)
    with pytest.raises(ValueError, match="noise must be"):
        nz.apply_gaussian_noise(x, noise.double(), 0.1)
    with pytest.raises(ValueError, match="noise on"):
        nz.apply_gaussian_noise(x, noise.cpu(), 0.1)
    with pytest.raises(ValueError, match="flat vector"):
        nz.apply_gaussian_noise(x[:0], noise[:0], 0.1)


# 1 to 5 float4 groups, ragged draw blocks, the SecAgg vector (n % 4 = 2)
# and 2^24 with the same remainder
NOISE_RAGGED = [1, 3, 4, 5, 1023, 1024, 1025, 4098, 271098, 2**24 + 6]


def _noise_variant(nz, x, noise, sigma, variant):
    """The wrapper's output, bitwise the plain version, and one launch of
    ``variant``."""
    before = nz.variant_counts()
    out = nz.apply_gaussian_noise(x, noise, sigma)
    _assert_bitwise(out, nz.apply_gaussian_noise_reference(x, noise, sigma))
    expected = {k: dict(v) for k, v in before.items()}
    expected[nz.NOISE.name][variant] += 1
    assert nz.variant_counts() == expected
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("n", NOISE_RAGGED)
def test_noise_variants_match_plain_version(n, misaligned, cuda_device):
    """Both variants (the scalar one on x one element off a 16-byte line)
    bitwise the plain version on the card, at the DP sigma and at 0.25, at
    ragged lengths up to 2^24 + 6; each launch counted under its variant."""
    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.trust.dp.dp import gaussian_sigma

    g = torch.Generator(device=cuda_device)
    g.manual_seed(n % 1000 + misaligned)
    x = torch.randn(n, generator=g, device=cuda_device) * torch.exp(
        3 * torch.randn(n, generator=g, device=cuda_device))
    noise = torch.randn(nz.noise_shape(n), generator=g, device=cuda_device)
    if misaligned:
        x = _misaligned(x)
    for sigma in (gaussian_sigma(50.0, 1e-5, 0.01), 0.25):
        _noise_variant(nz, x, noise, sigma, "scalar" if misaligned else "vector")


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
def test_noise_special_values_match_plain_version(misaligned, cuda_device):
    """NaN, +-inf and -0.0 in x, in whole groups and in the group that
    straddles the end, at the DP sigma and at 0: both variants bitwise."""
    from fedml_tpu_torch.ops import noise as nz

    n = 2 * 1024 + 762
    rs = np.random.RandomState(5)
    x = rs.randn(n).astype(np.float32)
    x[[0, 300, n - 1]] = np.nan
    x[[5, 1024 + 900]] = np.inf
    x[[6, n - 2]] = -np.inf
    x[2048:2100] = -0.0
    x[[7, n - 3]] = -0.0
    x = torch.from_numpy(x).to(cuda_device)
    noise = torch.from_numpy(rs.randn(*nz.noise_shape(n)).astype(np.float32)).to(cuda_device)
    if misaligned:
        x = _misaligned(x)
    for sigma in (0.000968961, 0.0):
        _noise_variant(nz, x, noise, sigma, "scalar" if misaligned else "vector")


@pytest.mark.cuda
def test_noise_vector_entry_refuses_misaligned_operands(cuda_device):
    """The C entry refuses the vector variant on an operand off a 16-byte
    line, and an empty length (it does not launch)."""
    from fedml_tpu_torch.ops import build
    from fedml_tpu_torch.ops import noise as nz

    x = torch.randn(2049, device=cuda_device)
    noise = torch.randn(nz.noise_shape(2049), device=cuda_device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    lib = build.load_library("noise", nz._SIGNATURES)
    for ptrs in ((x[1:].data_ptr(), noise.data_ptr(), out.data_ptr()),
                 (x.data_ptr(), noise.view(-1)[1:].data_ptr(), out.data_ptr()),
                 (x.data_ptr(), noise.data_ptr(), out[1:].data_ptr())):
        assert lib.gaussian_noise(ptrs[0], ptrs[1], 0.1, ptrs[2], 2048, 1, stream) != 0
    assert lib.gaussian_noise(x.data_ptr(), noise.data_ptr(), 0.1, out.data_ptr(), 0, 0,
                              stream) != 0


@pytest.mark.cuda
def test_noise_cuda_graph_replay_matches_eager(cuda_device):
    """Noise calls of both variants captured in one CUDA graph and replayed
    3 times equal the eager calls bitwise (outputs poisoned before each
    replay)."""
    from fedml_tpu_torch.ops import noise as nz

    g = torch.Generator(device=cuda_device)
    g.manual_seed(4)
    cases = []
    for n, misaligned in ((271098, False), (271098, True), (1025, False)):
        x = torch.randn(n, generator=g, device=cuda_device)
        noise = torch.randn(nz.noise_shape(n), generator=g, device=cuda_device)
        cases.append((_misaligned(x) if misaligned else x, noise))

    def calls():
        return [nz.apply_gaussian_noise(x, noise, 0.25) for x, noise in cases]

    want = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = calls()
    for _ in range(3):
        for t in got:
            t.fill_(-3)
        graph.replay()
        torch.cuda.synchronize()
        for a, e in zip(got, want):
            assert torch.equal(a, e)


@pytest.mark.cuda
def test_noise_cuda_tensors_never_reach_the_plain_version(cuda_device, monkeypatch):
    """With the plain version made to raise, the wrapper still runs on CUDA
    vectors of both variants, through the kernel (launches counted)."""
    from fedml_tpu_torch.ops import noise as nz

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    x = torch.randn(5000, device=cuda_device)
    noise = torch.randn(nz.noise_shape(5000), device=cuda_device)
    want = nz.apply_gaussian_noise_reference(x, noise, 0.25)
    monkeypatch.setattr(nz, "apply_gaussian_noise_reference", refuse)
    nz.reset_launch_counts()
    assert torch.equal(nz.apply_gaussian_noise(x, noise, 0.25), want)
    nz.apply_gaussian_noise(_misaligned(x), noise, 0.25)
    assert nz.variant_counts() == {nz.NOISE.name: {"vector": 1, "scalar": 1}}
    assert nz.launch_counts() == {nz.NOISE.name: 2}


class _FixedNoise:
    """The same N(0, 1) draw for every device (made with numpy)."""

    def __init__(self):
        self.calls = 0

    def gaussian(self, round_idx, shape, device):
        self.calls += 1
        rs = np.random.RandomState(1000 + round_idx)
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device)


def _secagg_finalize(device, dp: bool):
    """One streamed Shamir SecAgg round of 4 silos (client 4 drops out
    before its upload) finalized by ``SAAggregator`` on ``device``; returns
    ``(new global flat, clipped global flat or None)`` on the CPU."""
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.cross_silo import secagg_shamir as sa
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.trust.secagg.shamir import shamir_share

    p = 2**31 - 1
    kw = dict(enable_dp=True, dp_solution_type="cdp", epsilon=50.0, delta=1e-5,
              sensitivity=0.01, clipping_norm=1.0) if dp else {}
    cfg = Config(dataset="cifar10", model="resnet20", client_num_in_total=4,
                 client_num_per_round=4, training_type="cross_silo", enable_secagg=True,
                 extra={"secagg_method": "shamir", "secagg_stream": True,
                        "secagg_privacy_t": 2}, **kw)
    model = resnet.resnet20(10)
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    test = (np.zeros((32, 32, 32, 3), np.float32), np.zeros(32, np.int64), 32)
    agg = sa.SAAggregator(cfg, model, test, device, global_vars=init, noise_sampler=_FixedNoise())
    base = weights.flatten_reference(init)[0].numpy()
    rs = np.random.RandomState(3)
    s_sk = {u: int(rs.randint(2, p - 1)) for u in (1, 2, 3, 4)}
    agg.s_pk_table = {u: pow(sa.DH_G, k, p) for u, k in s_sk.items()}
    b = {u: int(rs.randint(0, 2**31)) for u in (1, 2, 3, 4)}
    b_sh = {u: shamir_share(b[u], 4, 3, rs) for u in b}
    sk_sh = {u: shamir_share(s_sk[u], 4, 3, rs) for u in b}
    survivors = (1, 2, 3)
    for u in survivors:
        flat = (base + rs.normal(0, 0.01, base.size)).astype(np.float32)
        peers = {v: sa.derive_round_seed(sa.dh_agree(s_sk[u], agg.s_pk_table[v]), 0)
                 for v in b if v != u}
        packed, meta = sa.mask_upload(flat, u, peers, sa.derive_round_seed(b[u], 0), 16, agg.ring)
        agg.add_masked_upload(u, packed, 1.0, meta)
    for v in survivors:
        agg.add_reveal(v, {str(u): b_sh[u][v - 1][1] for u in survivors},
                       {"4": sk_sh[4][v - 1][1]})
    agg.aggregate(0)
    assert agg.noise_sampler.calls == int(dp) and 4 in agg.compromised
    pre = agg.dp_pre_noise.cpu().numpy() if dp else None
    return weights.flatten_reference(agg.global_vars)[0].cpu().numpy(), pre, base


@pytest.mark.cuda
@pytest.mark.parametrize("dp", [False, True])
def test_secagg_finalize_card_matches_cpu(dp, cuda_device):
    """The same uploads and reveals finalized on the card and on the CPU:
    without DP bitwise (the field math is the host's, the mean is copied to
    the device once); with central DP the clip's norm sums in another order
    on the card: within one ulp plus 1e-5 of the clipped delta's largest
    element, then the noise kernel adds one more rounding of the same
    operands (two ulps)."""
    from fedml_tpu_torch.ops import noise as nz

    before = nz.launch_counts()[nz.NOISE.name]
    got, pre_card, base = _secagg_finalize(cuda_device, dp)
    assert nz.launch_counts()[nz.NOISE.name] == before + int(dp)
    want, pre_cpu, _ = _secagg_finalize("cpu", dp)
    if not dp:
        assert np.array_equal(got, want)
        return
    scale = np.abs(pre_cpu - base).max()
    assert np.linalg.norm((pre_cpu - base).astype(np.float64)) == pytest.approx(1.0, rel=1e-4)
    assert (np.abs(pre_card - pre_cpu) <= np.spacing(np.abs(pre_cpu)) + 1e-5 * scale).all()
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want)) + 1e-5 * scale).all()
    assert not np.array_equal(got, pre_card)
