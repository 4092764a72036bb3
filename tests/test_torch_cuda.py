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
on the CPU (the multiply, then the add, each rounded), in both variants.
SCAFFOLD's batched local step with the fused lane kernels against each lane
trained alone, rtol 2e-4 / atol 2e-5 (its ``c_i`` times ``1 / (K lr)``),
and the client Adam's per-lane state bitwise a lane run alone.  A Shamir SecAgg
finalize on the card against the CPU: bitwise without DP; with central DP
the clip's norm sums in another order, so one ulp plus 1e-5 of the clipped
delta's largest element (two ulps after the noise).  Compressed uploads: a
ResNet-20 delta's qsgd8 and topk frames built on the card byte-identical to
the CPU's (the same draws; ties at topk's k-th place), and the server's
device fold of qsgd8 / topk / raw frames bitwise numpy's host fold.
Slice 15: the noise kernel at Turbo-Aggregate's group length (16 x
271,098) bitwise, a masked group ring through it (one launch a non-empty
group, each group's rows bitwise the plain version), and a DSGD lane step
from per-lane variables against each lane alone at rtol 2e-4 / atol 2e-5.
Slice 16 (no kernel): one lane-batched step of FedGKT's clients (the
GroupNorm ResNet-56 halves), FedNAS and FedSeg against each lane alone at
rtol 2e-4 / atol 2e-5, FedGAN's (Adam) within 1e-3 relative L2 of each
lane's movement, and the UNet's ConvTranspose (kernel
flipped) on the card against ``out[2m + a, 2p + b] = x[m, p] k[1 - a, 1 -
b] + bias`` in f64 within 1e-5.
Slice 17: a chunk-reassembled qsgd8 upload folded on the card (the
dequantize kernel) bitwise the whole frame's fold on the CPU; a second
derivative through the fused kernels raises the port's refusal while the
first-order gradient through them launches; Soteria's mask on the card
against the CPU's (rtol 1e-5 on the sensitivity, the mask equal).
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
def test_scaffold_batched_step_on_card_matches_lanes_alone(cuda_device):
    """SCAFFOLD's corrected local SGD for 3 lanes of a fused f32 ResNet on
    the card (the lane-batched kernels), budgets 2, 6 and 4 steps (counts
    5, 20, 13; not in budget order), each lane its own ``c_i``: each lane
    within rtol 2e-4 / atol 2e-5 of the lane trained alone (the single-lane
    kernels), its new ``c_i`` within that times ``1 / (K lr)`` (K its
    budget, lr 0.05), each fused site once a batched step."""
    from fedml_tpu_torch.algorithms.scaffold import Scaffold
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.types import HParams
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.ops import fused_block as fb

    hp = HParams(batch_size=8, steps_per_epoch=3, epochs=2, learning_rate=0.05)
    model = resnet.CifarResNet(1, fused=True)
    variables = pt.tree_map(lambda t: t.to(cuda_device),
                            model.init(torch.Generator().manual_seed(0)))
    rs = np.random.RandomState(0)

    def dev(a):
        return torch.from_numpy(a).to(cuda_device)

    x = dev(rs.randn(3, 24, 8, 8, 3).astype(np.float32))
    y = dev(rs.randint(0, 10, (3, 24))).long()
    perms = dev(np.stack([np.stack([rs.permutation(24) for _ in range(2)]) for _ in range(3)]))
    c = pt.tree_map(lambda t: dev(rs.randn(*t.shape).astype(np.float32)), variables["params"])
    c_lanes = pt.tree_map(lambda t: dev(rs.randn(3, *t.shape).astype(np.float32)),
                          variables["params"])
    algo = Scaffold(hp).build(model)
    clients, counts = torch.tensor([2, 0, 1], device=cuda_device), np.array([5, 20, 13])
    fb.reset_launch_counts()
    out = algo.client_update_lanes(variables, c_lanes, c, x, y, clients, counts,
                                   perms=perms[[2, 0, 1]])
    launched = fb.launch_counts()
    assert launched[fb.FWD_LANES.name] == launched[fb.BWD_LANES.name] == 4 * 6
    assert launched[fb.FWD_RES_LANES.name] == launched[fb.BWD_RES_LANES.name] == 3 * 6
    assert launched[fb.BWD.name] == 0
    for lane, (ci, k) in enumerate(zip([2, 0, 1], [2, 6, 4])):
        own = pt.tree_map(lambda t, lane=lane: t[lane], c_lanes)
        alone = algo.client_update(variables, own, c, x[ci], y[ci], int(counts[lane]), None,
                                   perms=perms[ci])
        got = pt.tree_map(lambda t, lane=lane: t[lane], out.contribution["variables"])
        for a, b in zip(pt.tree_leaves(alone.contribution["variables"]), pt.tree_leaves(got)):
            torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-5)
        scale = 1.0 / (k * hp.learning_rate)
        for a, b in zip(pt.tree_leaves(alone.client_state), pt.tree_leaves(out.client_state)):
            torch.testing.assert_close(b[lane], a, rtol=2e-4 * scale, atol=2e-5 * scale)


@pytest.mark.cuda
def test_adam_lanes_keep_a_spent_lanes_state_on_card(cuda_device):
    """The client Adam on the card over 3 lane-stacked trees, the active
    lanes a shrinking prefix (3, 3, 2, 1): each lane's count, moments and
    parameters bitwise the lane run alone on the card for its own steps."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.optim import Adam

    opt = Adam(0.01, weight_decay=0.1)
    rs = np.random.RandomState(1)
    p0 = torch.from_numpy(rs.randn(3, 4, 5).astype(np.float32)).to(cuda_device)
    grads = [torch.from_numpy(rs.randn(3, 4, 5).astype(np.float32)).to(cuda_device)
             for _ in range(4)]
    params = {"w": p0.clone()}
    state = opt.init(params, lanes=3)
    for g, n in zip(grads, (3, 3, 2, 1)):
        new_p, new_s = opt.update({"w": g[:n]}, pt.tree_head(state, n), pt.tree_head(params, n))
        pt.tree_set_head_(params, n, new_p)
        pt.tree_set_head_(state, n, new_s)
    assert state["count"].tolist() == [4, 3, 2]
    for lane, steps in enumerate((4, 3, 2)):
        p = {"w": p0[lane].clone()}
        s = opt.init(p)
        for g in grads[:steps]:
            p, s = opt.update({"w": g[lane]}, s, p)
        assert int(s["count"]) == steps
        assert torch.equal(params["w"][lane], p["w"])
        assert torch.equal(state["mu"]["w"][lane], s["mu"]["w"])
        assert torch.equal(state["nu"]["w"][lane], s["nu"]["w"])


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


def _resnet20_delta(device, seed=3):
    """A ResNet-20 delta in flax layout on ``device`` (the upload's input):
    the conv kernels' values from a small set, so topk meets ties."""
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.models import resnet

    v = resnet.resnet20(10).init(rng.generator((seed,)), "cpu")
    rs = np.random.RandomState(seed)
    delta = pt.tree_map(lambda t: torch.from_numpy(
        (rs.choice([-2.0, -1.0, 1.0, 2.0], size=tuple(t.shape)) * 1e-3).astype(np.float32)), v)
    return weights.tensors_to_flax(pt.tree_map(lambda t: t.to(device), delta))


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["qsgd8", "topk"])
def test_upload_frame_card_matches_cpu(codec, cuda_device):
    """A ResNet-20 delta compressed on the card and on the CPU from the same
    draws: the same wire bytes; qsgd8 launches the quantize kernel once a
    conv kernel (18), topk never."""
    from fedml_tpu_torch.comm import codecs, wire
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.ops import quantize as qz

    gen, draws = torch.Generator().manual_seed(5), {}

    def uniform(i, shape, device):
        if i not in draws:
            draws[i] = torch.rand(shape, generator=gen)
        return draws[i].to(device)

    delta = _resnet20_delta(cuda_device)
    frames, launches = [], []
    for tree in (delta, pt.tree_map(lambda t: t.cpu(), delta)):
        before = qz.launch_counts()[qz.QUANTIZE.name]
        out, res, stats = codecs.compress_pytree(tree, codec, uniform=uniform)
        launches.append(qz.launch_counts()[qz.QUANTIZE.name] - before)
        frames.append((wire.encode_pytree({"m": out}), stats["wire_bytes"]))
    assert frames[0] == frames[1]
    assert frames[0][1] == {"qsgd8": 288784, "topk": 36680}[codec]
    assert launches == ([18, 0] if codec == "qsgd8" else [0, 0])


@pytest.mark.cuda
def test_stream_fold_card_matches_numpy(cuda_device):
    """qsgd8, topk and raw ResNet-20 frames folded by the server's device
    accumulator on the card: the sums and the finalized leaves bitwise the
    reference's numpy host fold of the same frames (decoded by
    ``wire``'s numpy decoder), the dequantize kernel once a qsgd8 leaf."""
    from fedml_tpu_torch.comm import codecs, wire
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.ops import quantize as qz
    from fedml_tpu_torch.parallel.stream_fold import DeviceStreamAccumulator, decode_leaf

    base = _resnet20_delta("cpu", seed=9)
    base = pt.tree_map(lambda t: t * 300.0, base)
    frames = []
    for cid, codec in ((1, "qsgd8"), (2, "topk"), (3, None), (4, "qsgd8")):
        delta = _resnet20_delta("cpu", seed=cid)
        if codec is None:
            payload = pt.tree_map(lambda a, d: (a + d).numpy(), base, delta)
        else:
            payload = codecs.compress_pytree(delta, codec, key=(cid,))[0]
        m = Message(3, cid, 0)
        m.add_params("model_params", payload)
        m.add_params("num_samples", 100.0 + cid)
        frames.append((100.0 + cid, codec is not None, Message.decode(m.encode())))
    _, tmpl = wire.flatten_with_skeleton({"model_params": base})
    acc = DeviceStreamAccumulator([t.to(cuda_device) for t in tmpl], cuda_device)
    sums = [np.zeros(tuple(t.shape), np.float32) for t in tmpl]
    before = qz.launch_counts()[qz.DEQUANTIZE.name]
    w_total = w_delta = 0.0
    for w, is_delta, msg in frames:
        w32 = acc.scalar(w)
        for i, spec, segs in msg.tensor_segments()[1]:
            acc.fold_leaf(i, w32, decode_leaf(spec, segs, cuda_device))
        for i, _, arr in msg.tensor_frame()[1]:
            sums[i] += np.float32(w) * np.asarray(arr, np.float32)
        w_total += w
        w_delta += w if is_delta else 0.0
    assert qz.launch_counts()[qz.DEQUANTIZE.name] - before == 2 * 18
    for got, want in zip(acc.sums(), sums):
        assert np.array_equal(got.cpu().numpy(), want)
    out = acc.finalize([t.to(cuda_device) for t in tmpl], w_delta, w_total)
    for got, want, t in zip(out, sums, tmpl):
        t = t.numpy()
        want = ((want + np.float32(w_delta) * t) / np.float32(w_total)).astype(t.dtype)
        assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 64])
def test_local_dp_one_launch_with_a_flat_draw(m, cuda_device):
    """Local DP over an (m, 271,098) matrix (the flagship's 64 lanes at
    most): one launch of the noise kernel on the flattened matrix with the
    flat draw, bitwise the plain version on the card and on the CPU."""
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.trust.dp.dp import FedMLDifferentialPrivacy

    d = 271098
    dp = FedMLDifferentialPrivacy(Config(enable_dp=True, dp_solution_type="ldp", epsilon=50.0,
                                         delta=1e-5, sensitivity=0.01))
    g = torch.Generator(device=cuda_device)
    g.manual_seed(m)
    mat = torch.randn(m, d, generator=g, device=cuda_device)
    draw = torch.randn(m * d, generator=g, device=cuda_device)
    before = nz.variant_counts()[nz.NOISE.name]["vector"]
    out = dp.add_local_noise(mat, draw)
    assert nz.variant_counts()[nz.NOISE.name]["vector"] == before + 1
    want = nz.apply_gaussian_noise_reference(mat.reshape(-1), draw, dp.sigma()).view(m, d)
    assert out.shape == (m, d) and torch.equal(out, want)
    assert torch.equal(out.cpu(), dp.add_local_noise(mat.cpu(), draw.cpu()))


@pytest.mark.cuda
def test_trust_hooks_card_match_cpu(cuda_device):
    """One defense-hook round, card against CPU, on 16 lane-stacked
    ResNet-20 trees with the same draws: byzantine_random, multikrum, local
    and central DP.  Krum's selection bitwise; contributions and the global
    within 1e-5 of their scale (norms and the Gram matrix sum in another
    order); the noise kernel launched for both DP sites."""
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.trust.dp.dp import NoiseSampler
    from fedml_tpu_torch.trust.pipeline import build_trust_pipeline
    from fedml_tpu_torch.weights import flatten_reference

    class HostDraws(NoiseSampler):
        """The default streams, drawn on the CPU and copied: the same
        values on either device."""

        def _draw(self, round_idx, tag, kind, shape, device):
            return super()._draw(round_idx, tag, kind, shape, "cpu").to(device)

    cfg = Config(enable_attack=True, attack_type="byzantine_random",
                 poisoned_client_list=(1, 6, 11), enable_defense=True, defense_type="multikrum",
                 byzantine_client_num=3, krum_param_m=8, enable_dp=True,
                 dp_solution_type="nbafl", epsilon=50.0, delta=1e-5, sensitivity=0.01,
                 clipping_norm=1.0)
    glob = resnet.CifarResNet(3).init(rng.generator(rng.root_key(0)), "cpu")
    gen = torch.Generator().manual_seed(5)
    stacked = pt.tree_map(lambda t: t.unsqueeze(0) + 0.01 * torch.randn(
        (16,) + tuple(t.shape), generator=gen), glob)
    sampled = np.arange(16)
    weights = torch.arange(1.0, 17.0)
    outs = {}
    for dev in (torch.device("cpu"), cuda_device):
        tp = build_trust_pipeline(cfg, sampler=HostDraws(0))
        g = pt.tree_map(lambda t: t.to(dev), glob)
        before = nz.launch_counts()[nz.NOISE.name]
        c, w = tp.on_client_outputs(pt.tree_map(lambda t: t.to(dev), stacked),
                                    weights.to(dev), sampled, g, 2)
        c, w, agg = tp.on_aggregation(c, w, g, 2)
        assert agg is None
        new = tp.on_after_aggregation(pt.tree_weighted_mean(c, w), g, 2)
        outs[dev.type] = (pt.stacked_tree_to_matrix(c).cpu(), w.cpu(),
                          flatten_reference(new)[0].cpu())
        launched = nz.launch_counts()[nz.NOISE.name] - before
        assert launched == (2 if dev.type == "cuda" else 0)
    (mc, wc, nc), (mh, wh, nh) = outs["cuda"], outs["cpu"]
    assert torch.equal(wc, wh) and int((wh > 0).sum()) == 8
    for a, b in ((mc, mh), (nc, nh)):
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))


@pytest.mark.cuda
def test_lane_quantize_bitwise_per_lane_at_the_femnist_cnn_length(cuda_device):
    """FedSGD ``qsgd_int8`` on FEMNIST's FedAvg CNN: 16 lanes of 1,690,046
    elements (1,651 blocks a lane), one quantize and one dequantize launch,
    every lane bitwise its own single-lane calls and the plain versions."""
    from fedml_tpu_torch.ops import quantize as qz

    lanes, n = 16, 1690046
    g = torch.Generator(device=cuda_device)
    g.manual_seed(5)
    x = torch.randn((lanes, n), generator=g, device=cuda_device) * torch.exp(
        3 * torch.randn((lanes, n), generator=g, device=cuda_device))
    u = torch.rand((lanes,) + qz.noise_shape(n), generator=g, device=cuda_device)
    assert qz.noise_shape(n)[0] == 1651
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


def _lanes_of(variables, n, seed):
    from fedml_tpu_torch.core import pytree as pt

    g = torch.Generator().manual_seed(seed)
    return pt.tree_map(lambda t: torch.stack([t + 0.05 * torch.randn(t.shape, generator=g)
                                              for _ in range(n)]), variables)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["char", "word"])
def test_lstm_lanes_on_card_match_each_lane_alone(model, cuda_device):
    """The LSTMs' lane form (one gather, one ``torch.bmm`` a gate product)
    on the card: 4 lanes against each model alone, f32 with TF32 off, the
    logits within rtol 1e-5 / atol 1e-6 and each gradient leaf within 1e-5
    of its largest entry (cuBLAS may sum a batch of 4 in another order than
    a batch of 1: measured 5.7e-6 absolute, rel 3.1e-5, on one element of
    the word LSTM's), and the card against the CPU."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import rnn

    m = rnn.CharLSTM(90, 8, 64) if model == "char" else rnn.WordLSTM(500, 16, 48)
    lanes = _lanes_of(m.init(torch.Generator().manual_seed(0)), 4, 1)
    tokens = torch.randint(0, m.vocab_size, (4, 6, 20), generator=torch.Generator().manual_seed(2))
    dev = pt.tree_map(lambda t: t.to(cuda_device).requires_grad_(True), lanes)
    both, _ = m.apply(dev, tokens.to(cuda_device), True)
    grads = torch.autograd.grad(both.square().sum(), pt.tree_leaves(dev))
    for lane in range(4):
        one = pt.tree_map(lambda t: t[lane].detach().clone().requires_grad_(True), dev)
        alone, _ = m.apply(one, tokens[lane].to(cuda_device), True)
        torch.testing.assert_close(both[lane], alone, rtol=1e-5, atol=1e-6)
        for a, b in zip(grads, torch.autograd.grad(alone.square().sum(), pt.tree_leaves(one))):
            torch.testing.assert_close(a[lane], b, rtol=0, atol=1e-5 * float(b.abs().max()))
    cpu, _ = m.apply(lanes, tokens, True)
    torch.testing.assert_close(both.detach().cpu(), cpu, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_conv_lanes_on_card_match_each_lane_alone(dtype, cuda_device):
    """``conv2d_lanes`` with ``L * C`` groups (the zoo's depthwise convs) on
    the card, channels_last, 8 lanes of 5x5 stride-2 over 72 channels:
    each lane against the conv of that lane alone (one lane, 72 groups)
    within rtol 1e-5 / atol 1e-6 in
    f32 (in bf16 within one bf16 ulp of the larger magnitude: the two
    convs may sum their 25 taps in other orders before the one rounding),
    and against the CPU's f32 conv of the same operands (in bf16 one ulp,
    or two at the output's RMS where the sum cancels)."""
    from fedml_tpu_torch.models.resnet import conv2d_lanes

    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 16, 15, 15, 72, generator=g)
    k = torch.randn(8, 72, 1, 5, 5, generator=g)
    got = conv2d_lanes(x.to(cuda_device), k.to(cuda_device), 2, dtype, groups=72)
    assert got.shape == (8, 16, 8, 8, 72) and got.dtype == dtype
    for lane in range(8):
        alone = conv2d_lanes(x[lane:lane + 1].to(cuda_device), k[lane:lane + 1].to(cuda_device), 2,
                             dtype, groups=72)[0]
        if dtype == torch.float32:
            torch.testing.assert_close(got[lane], alone, rtol=1e-5, atol=1e-6)
        else:
            assert _bf16_ulps(got[lane], alone).max() <= 1
    # the CPU in f32 from the same (bf16-rounded) operands
    cpu = conv2d_lanes(x.to(dtype).float(), k.to(dtype).float(), 2, torch.float32, groups=72)
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), cpu, rtol=1e-5, atol=1e-5)
    else:  # one rounding of the f32 sum: within one ulp, or two at the RMS where it cancels
        rms_ulp = 2.0 ** (torch.floor(torch.log2(cpu.square().mean().sqrt())) - 7)
        near = (got.float().cpu() - cpu).abs() <= 2 * rms_ulp
        assert bool(((_bf16_ulps(got.cpu(), cpu) <= 1) | near).all())


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 ulps of the larger magnitude (2^(e - 7))."""
    a, b = a.float().cpu(), b.float().cpu()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [2, 8])
def test_group_norm_lanes_on_card_match_each_lane_alone(groups, cuda_device):
    """``group_norm`` of 6 lanes (per-lane scale and bias) on the card
    against each lane alone, within 1e-6 in f32 (a lane's statistics reduce
    over its own slice, maybe in another order), and against the CPU
    within 1e-5; bf16 to one ulp."""
    from fedml_tpu_torch.models.resnet import group_norm

    g = torch.Generator().manual_seed(4)
    x = torch.randn(6, 16, 8, 8, 64, generator=g) * 3 + 1
    p = {"scale": torch.randn(6, 64, generator=g), "bias": torch.randn(6, 64, generator=g)}
    dev = {k: v.to(cuda_device) for k, v in p.items()}
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(cuda_device, dtype)
        got = group_norm(xd, dev, groups)
        for lane in range(6):
            alone = group_norm(xd[lane], {k: v[lane] for k, v in dev.items()}, groups)
            if dtype == torch.float32:
                torch.testing.assert_close(got[lane], alone, rtol=1e-6, atol=1e-6)
            else:
                assert _bf16_ulps(got[lane], alone).max() <= 1
    cpu = group_norm(x, p, groups)
    torch.testing.assert_close(group_norm(x.to(cuda_device), dev, groups).cpu(), cpu, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_noise_at_a_turboaggregate_group_length(cuda_device):
    """Kernel 7 at Turbo-Aggregate's group length, 16 x 271,098 =
    4,337,568 elements with a flat draw and sigma 10: one launch, bitwise
    the plain version on the card and on the CPU."""
    from fedml_tpu_torch.ops import noise as nz

    n = 16 * 271098
    g = torch.Generator(device=cuda_device)
    g.manual_seed(15)
    x = torch.randn(n, generator=g, device=cuda_device) * 1e-2
    draw = torch.randn(n, generator=g, device=cuda_device)
    before = nz.launch_counts()[nz.NOISE.name]
    out = nz.apply_gaussian_noise(x, draw, 10.0)
    assert nz.launch_counts()[nz.NOISE.name] == before + 1
    assert torch.equal(out, nz.apply_gaussian_noise_reference(x, draw, 10.0))
    assert torch.equal(out.cpu(), nz.apply_gaussian_noise(x.cpu(), draw.cpu(), 10.0))


@pytest.mark.cuda
def test_turboaggregate_group_masks_through_the_kernel(cuda_device):
    """The masked group ring on the card (``sim/turboaggregate.py``) over 10
    survivors of ResNet-20's 271,098-element rows in 4 groups (one left
    empty by the split of 3): one kernel launch a non-empty group, each
    group's masked rows bitwise the plain ``x * w + noise * 10``, and the
    aggregate within f32 rounding of the mask sums of the weighted mean."""
    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.sim.turboaggregate import TASampler, TurboAggregateSimulator

    d, m = 271098, 10
    sim = TurboAggregateSimulator.__new__(TurboAggregateSimulator)
    sim.sampler = TASampler(0, m, m)
    sim.last_round = {}
    g = torch.Generator(device=cuda_device)
    g.manual_seed(3)
    flat = torch.randn(m, d, generator=g, device=cuda_device) * 0.1
    w = torch.rand(m, generator=g, device=cuda_device) + 0.5
    w = w / w.sum()
    groups = [np.arange(0, 4), np.arange(4, 7), np.array([], np.int64), np.arange(7, 10)]
    before = nz.launch_counts()[nz.NOISE.name]
    agg = sim._ring_aggregate(flat, w, groups, 0)
    assert nz.launch_counts()[nz.NOISE.name] == before + 3
    assert sim.last_round["lengths"] == [4 * d, 3 * d, 3 * d]
    for g, members in enumerate(groups):
        if not len(members):
            continue
        rows = torch.from_numpy(members).to(cuda_device)
        x = flat.index_select(0, rows) * w.index_select(0, rows)[:, None]
        noise = sim.sampler.ta_masks(0, g, tuple(x.shape), cuda_device)  # the same draw again
        want = x + noise * x.new_full((), 10.0)
        masked = torch.from_numpy(np.stack(sim.observed_by_group[g][:-1]))
        assert torch.equal(masked, want.cpu())
    mean = (flat.double() * w.double()[:, None]).sum(0)
    assert float((agg.double() - mean).norm() / mean.norm()) < 5e-4
    assert [len(o) for o in sim.observed_by_group] == [5, 4, 0, 4]


@pytest.mark.cuda
def test_dsgd_lane_step_on_card_matches_each_lane_alone(cuda_device):
    """One DSGD local step on the card: 4 lanes of a fused f32 ResNet, each
    from its own variables (a gossip round's starting point), one batched
    step against each lane trained alone (the single-lane kernels) within
    rtol 2e-4 / atol 2e-5; each fused site launched once in its lanes
    variant."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import make_batched_local_train_fn, make_local_train_fn
    from fedml_tpu_torch.fl.types import HParams
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.ops import fused_block as fb

    hp = HParams(batch_size=8, steps_per_epoch=1, epochs=1, learning_rate=0.05)
    model = resnet.CifarResNet(1, fused=True)
    base = model.init(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)

    def dev(a):
        return torch.from_numpy(a).to(cuda_device)

    lanes = pt.tree_map(lambda t: dev((t.numpy()[None] + 0.01 * rs.randn(4, *t.shape))
                                      .astype(t.numpy().dtype)), base)
    x = dev(rs.randn(4, 8, 8, 8, 3).astype(np.float32))
    y = dev(rs.randint(0, 10, (4, 8))).long()
    perms = dev(np.stack([rs.permutation(8)[None] for _ in range(4)]))
    counts = np.array([8, 5, 8, 3])
    batched = make_batched_local_train_fn(model, hp)
    alone = make_local_train_fn(model, hp)
    fb.reset_launch_counts()
    got, _ = batched(lanes, x, y, torch.arange(4, device=cuda_device), counts, perms)
    launched = fb.launch_counts()
    assert launched[fb.FWD_LANES.name] == launched[fb.BWD_LANES.name] == 4
    assert launched[fb.FWD_RES_LANES.name] == launched[fb.BWD_RES_LANES.name] == 3
    for lane in range(4):
        own = pt.tree_map(lambda t, lane=lane: t[lane], lanes)
        want, _ = alone(own, x[lane], y[lane], int(counts[lane]), None, perms=perms[lane])
        for a, b in zip(pt.tree_leaves(want), pt.tree_leaves(got)):
            torch.testing.assert_close(b[lane], a, rtol=2e-4, atol=2e-5)


def _own_net_sim(device, opt, dataset, **kw):
    """One of the simulators that build their own networks on ``device``,
    built through the runner at a tiny size."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.runner import FedMLRunner

    extra = kw.pop("extra", {})
    base = dict(federated_optimizer=opt, dataset=dataset, client_num_in_total=4,
                client_num_per_round=4, comm_round=1, batch_size=4, synthetic_train_size=32,
                synthetic_test_size=8, partition_method="homo", learning_rate=0.05,
                momentum=0.9, random_seed=0, norm="group")
    base.update(kw)
    cfg = Config(**base, extra=extra)
    fedml_tpu_torch.init(cfg)
    return FedMLRunner(cfg, device=device).runner


def _lanes_match_alone(batched, alone_fn, lanes, start=None):
    """Each lane of a lane-batched result's trees against the same lane run
    alone, within rtol 2e-4 / atol 2e-5; given the lanes' ``start`` trees,
    within 1e-3 relative L2 of the lane's movement from it instead (Adam's
    first step moves an element by ``lr * g / (|g| + eps)``, about ``lr``
    for any gradient near zero, whatever its rounding)."""
    from fedml_tpu_torch.core import pytree as pt

    for lane in range(lanes):
        for k, (got, want) in enumerate(zip(batched, alone_fn(lane))):
            pairs = list(zip(pt.tree_leaves(want), pt.tree_leaves(got)))
            if start is None:
                for a, b in pairs:
                    torch.testing.assert_close(b[lane], a[0], rtol=2e-4, atol=2e-5)
                continue
            s0 = pt.tree_leaves(start[k])
            diff = sum(float((b[lane] - a[0]).double().square().sum()) for a, b in pairs)
            moved = sum(float((a[0] - s[lane]).double().square().sum())
                        for (a, _), s in zip(pairs, s0))
            assert diff <= 1e-6 * moved, (lane, k, diff, moved)


@pytest.mark.cuda
def test_fedgkt_client_lanes_on_card_match_each_lane_alone(cuda_device):
    from fedml_tpu_torch.core import pytree as pt

    sim = _own_net_sim(cuda_device, "FedGKT", "cifar10")
    params = {"bottom": sim.client_bottoms["params"], "head": sim.client_heads["params"]}
    rs = np.random.RandomState(2)
    params = pt.tree_map(lambda t: t + 0.01 * torch.from_numpy(
        rs.randn(*t.shape).astype(np.float32)).to(t.device), params)
    perms = torch.from_numpy(rs.randint(0, sim.capacity, (4, 1, 4))).to(cuda_device)
    teacher = torch.randn(4, sim.probe, sim.n_classes, device=cuda_device)
    got, _ = sim.client_phase(params, sim._lanes, perms, teacher)
    _lanes_match_alone((got,), lambda lane: (sim.client_phase(
        pt.tree_map(lambda t: t[lane:lane + 1], params), sim._lanes[lane:lane + 1],
        perms[lane:lane + 1], teacher[lane:lane + 1])[0],), 4)


@pytest.mark.cuda
def test_fedgan_lanes_on_card_match_each_lane_alone(cuda_device):
    sim = _own_net_sim(cuda_device, "FedGan", "mnist", learning_rate=1e-3,
                       extra={"gan_z_dim": 16})
    sampled = np.arange(4)
    idx, z1, z2 = (torch.stack(t).to(cuda_device) for t in zip(*[
        sim.sampler.gan_draws(0, c, 1, sim.capacity, 4, sim.z_dim) for c in sampled]))
    got = sim.local_train(sampled, idx, z1, z2)[:2]
    from fedml_tpu_torch.sim.own_nets import lane_copies

    start = (lane_copies(sim.g_vars, 4), lane_copies(sim.d_vars, 4))
    _lanes_match_alone(got, lambda lane: sim.local_train(
        sampled[lane:lane + 1], idx[lane:lane + 1], z1[lane:lane + 1], z2[lane:lane + 1])[:2], 4,
        start)


@pytest.mark.cuda
def test_fednas_lanes_on_card_match_each_lane_alone(cuda_device):
    sim = _own_net_sim(cuda_device, "FedNAS", "cifar10", extra={"nas_features": 4})
    sampled = np.arange(4)
    iw, ia = (torch.stack(t).to(cuda_device) for t in zip(*[
        sim.sampler.nas_indices(0, c, 1, sim.half, sim.capacity, 4) for c in sampled]))
    got = sim.local_search(sampled, iw, ia)[:2]
    _lanes_match_alone(got, lambda lane: sim.local_search(
        sampled[lane:lane + 1], iw[lane:lane + 1], ia[lane:lane + 1])[:2], 4)


@pytest.mark.cuda
def test_fedseg_lanes_on_card_match_each_lane_alone(cuda_device):
    sim = _own_net_sim(cuda_device, "FedSeg", "fets2021", extra={"seg_base": 4})
    sampled = np.arange(4)
    idx = torch.stack([sim.sampler.seg_indices(0, c, 1, sim.capacity, 4)
                       for c in sampled]).to(cuda_device)
    got = sim.local_train(sampled, idx)[:1]
    _lanes_match_alone(got, lambda lane: sim.local_train(sampled[lane:lane + 1],
                                                         idx[lane:lane + 1])[:1], 4)


@pytest.mark.cuda
def test_conv_transpose_flip_on_card(cuda_device):
    """flax's unflipped 2x2 stride-2 ConvTranspose as the port applies it,
    2 lanes with asymmetric kernels, against the formula in f64."""
    from fedml_tpu_torch.models.segmentation import conv_transpose_lanes

    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 4, 5, 6)
    k = rs.randn(2, 2, 2, 6, 7)  # flax (kh, kw, I, O) a lane
    k[:, 0, 1] += 2.0
    bias = rs.randn(2, 7)
    want = np.zeros((2, 3, 8, 10, 7))
    for a in range(2):
        for b in range(2):
            want[:, :, a::2, b::2] = np.einsum("lnhwi,lio->lnhwo", x, k[:, 1 - a, 1 - b])
    want += bias[:, None, None, None, :]
    p = {"kernel": torch.from_numpy(k.transpose(0, 4, 3, 1, 2).astype(np.float32)).to(cuda_device),
         "bias": torch.from_numpy(bias.astype(np.float32)).to(cuda_device)}
    got = conv_transpose_lanes(p, torch.from_numpy(x.astype(np.float32)).to(cuda_device))
    np.testing.assert_allclose(got.cpu().double().numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_chunked_qsgd8_upload_folds_on_card_like_the_cpu(cuda_device):
    from fedml_tpu_torch.comm import wire
    from fedml_tpu_torch.comm.message import ChunkAssembler, Message
    from fedml_tpu_torch.ops import quantize as qz
    from fedml_tpu_torch.parallel.stream_fold import DeviceStreamAccumulator, decode_leaf

    rs = np.random.RandomState(3)
    leaves = {"a": rs.randn(9216).astype(np.float32), "b": rs.randn(300).astype(np.float32)}
    tree = {}
    for k, v in leaves.items():
        vec = torch.from_numpy(v)
        values, scales, n = qz.quantize_int8_reference(
            vec, torch.from_numpy(rs.rand(*qz.noise_shape(v.size)).astype(np.float32)))
        tree[k] = wire.CompressedLeaf("qsgd8", np.float32, v.shape,
                                      {"blocks": int(scales.shape[0]), "length": int(n)},
                                      (scales.numpy(), values.reshape(-1).numpy()))
    m = Message(3, 1, 0)
    m.add_params("model_params", tree)
    data = m.encode()
    asm = ChunkAssembler()
    got = None
    for frame in wire.encode_chunk_frames(data, stream_id="1.0", sender=1, chunk_bytes=4096):
        got, err, _ = asm.feed(frame)
        assert err is None
    whole = Message.decode(data)
    sums = {}
    for msg, dev in ((got, cuda_device), (whole, torch.device("cpu"))):
        header, segs = msg.tensor_segments()
        segs = list(segs)
        acc = DeviceStreamAccumulator([torch.zeros(s["shape"]) for _, s, _ in segs], dev)
        before = qz.launch_counts()[qz.DEQUANTIZE.name]
        for i, spec, parts in segs:
            acc.fold_leaf(i, acc.scalar(64.0), decode_leaf(spec, parts, dev))
        if dev.type == "cuda":
            assert qz.launch_counts()[qz.DEQUANTIZE.name] - before == len(segs)
        sums[dev.type] = [t.cpu() for t in acc.sums()]
    for a, b in zip(sums["cuda"], sums["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_second_order_through_fused_kernels_refused_on_card(cuda_device):
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _inputs((2, 8, 8, 16), torch.float32, cuda_device)
    y.requires_grad_(True)
    before = fb.launch_counts()
    out = fb.fused_bn_residual_relu(y, s, b, r)
    (gy,) = torch.autograd.grad((out * g).sum(), y)
    counts = fb.launch_counts()
    assert counts[fb.FWD_RES.name] > before[fb.FWD_RES.name]
    assert counts[fb.BWD_RES.name] > before[fb.BWD_RES.name]
    out = fb.fused_bn_relu(y, s, b)
    with pytest.raises(RuntimeError) as info:
        torch.autograd.grad((out * g).sum(), y, create_graph=True)
    assert str(info.value) == fb.SECOND_ORDER_REFUSAL


@pytest.mark.cuda
def test_soteria_mask_on_card_matches_the_cpu(cuda_device):
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.models import model_hub
    from fedml_tpu_torch.trust.defense import soteria_mask

    cfg = fedml_tpu_torch.init(Config(model="lr", dataset="synthetic", compute_dtype="float32"))
    model = model_hub.create(cfg, 100, input_shape=(60,))
    variables = model.init(rng.generator(rng.root_key(3)), "cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(60).astype(np.float32))
    want_mask, want = soteria_mask(model, variables, x, 10.0)
    card = {k: {n: t.to(cuda_device) for n, t in v.items()}
            for k, v in variables["params"].items()}
    mask, sens = soteria_mask(model, {"params": card}, x.to(cuda_device), 10.0)
    np.testing.assert_allclose(sens.cpu().numpy(), want.numpy(), rtol=1e-5)
    assert torch.equal(mask.cpu(), want_mask) and int((mask == 0).sum()) == 10
