#!/usr/bin/env python3
"""Drive the PyTorch port (``fedml_tpu_torch``) on one NVIDIA card.

Run from the repository root:  ``python3 chip_smoke.py``

Phases (any failure exits non-zero; no phase is caught):
1. Print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from ``fedml_tpu_torch/csrc/`` with nvcc for sm_90a (one nvcc
   per source, all started together).
2. Hold each of the four fused BasicBlock kernels against its plain PyTorch
   version on the card at the three flagship shapes in f32 and bf16 (TF32
   off): the forward bitwise in both dtypes, dy / dr bitwise in f32 and
   within one bf16 ulp in bf16, d_scale / d_shift within
   ``1e-5 * sum|terms|`` per channel (f32 sums in another order); each line
   names the variant that ran (16-byte "vector" loads or "scalar", the
   forward's prefixed "fwd_"), each forward line also gives the device time
   of the PyTorch elementwise op that moves the same bytes (``torch.relu(y)``
   beside the forward without the residual, ``torch.add(y, r)`` beside the
   one with it: the card's streaming yardstick, ``stream_ms``), and each
   fused kernel gets a line of its device time and bound over a local step,
   weighted by its launches at the three shapes.  The forward's scalar
   variant (odd C, a misaligned operand) is held bitwise too.  Hold the int8
   quantize and dequantize kernels against theirs at the FedSGD gradient's
   length (269,722 elements, 264 blocks) and at 2^24 elements: int8 values,
   scales and the dequantized vector bitwise; each line names the variant
   that ran and gives the same-bytes stream (``torch.lt(x, u)``,
   ``values.to(float32)``); then at 1,025 (vector) and at 269,722 with x
   one element off a 16-byte line (the scalar variant, checked), bitwise.
   Hold the central-DP noise kernel against its plain
   version at the SecAgg vector's length (271,098: ResNet-20's parameters
   and BN statistics) and at 2^24, bitwise, at the slice's DP sigma, at
   0.25 and at 0 (the identity); each line names the variant that ran;
   then at 271,098 with x one element off a 16-byte line (the scalar
   variant, checked).  Time each kernel and its plain version
   with CUDA events over CUDA-graph replays (device time; each kernel's
   inputs rotated through more than twice the 50 MB L2) and as eager calls (host overhead
   included), next to its bound (bytes at 3.35 TB/s vs operations at 67
   TFLOP/s); for the noise kernel also the one PyTorch call that computes
   the same function, ``torch.add(x, noise, alpha=sigma)``, also in 7
   alternating runs each (median, min and max).  The lane-batched
   variants (``*_lanes``: one launch for all lanes of the MESH round): the
   four fused kernels at L = 64 and the three stage shapes, f32 and bf16,
   every lane bitwise the single-lane kernel on its slice and each held
   against the plain version with the tolerances above; the quantize and
   dequantize at 16 x 269,722, bitwise per lane and against the plain
   versions; each with device time (CUDA-graph replays), eager time and
   bound.  Then a fused ResNet-20 step and one FedSGD client gradient on
   the card against the same on the CPU.
3. The FedAvg path: the flagship recipe
   ``examples/sp_fedavg_cifar10_resnet20/fedml_config.yaml`` through
   ``fedml_tpu_torch.init`` and ``FedMLRunner(cfg).run()`` with only
   ``comm_round``, ``frequency_of_the_test`` and ``extra.fused_blocks``
   overridden: 128 clients, 64 a round, batch 128, bf16, full-width
   ResNet-20 on the synthetic CIFAR-10 (50,000 / 10,000 images), on its
   default MESH backend: the 64 sampled clients are the lanes of one
   batched round.  Every kernel's launch count is zeroed just before and
   read just after; each fused kernel must launch in its lanes variant,
   each fused site once a batched step (never once a client; the
   single-lane backward never), the lane-steps computed must equal the
   lanes' own step budgets, and every loss must be finite.  Each round
   prints its time, trained samples/s, lane-steps, launches and
   ``max_memory_allocated``.  Then fused against unfused MESH rounds, the
   same rounds alternating after a warm-up round each; then one f32 round
   (TF32 off) of the same recipe with 8 of its 128 clients on ``sp`` and on
   MESH from the same initial weights, the globals held to the reference's
   own MESH-vs-SP tolerance (rtol 2e-4, atol 2e-5) and the largest
   difference printed.
4. The FedSGD path: ``examples/sp_fedsgd_eftopk_cifar10_resnet20`` the same
   way with only ``comm_round``, ``frequency_of_the_test`` and
   ``compression: qsgd_int8`` overridden: 16 clients, all 16 a round, one
   full-shard gradient each, batch 128, bf16, full-width ResNet-20, on
   MESH: the 16 lanes' gradients in lane-batched steps.  The counts are
   zeroed before and read after: the lane-batched quantize and dequantize
   must launch once a round for all 16 lanes (the single-lane ones never),
   and every test metric and weight must be finite.  Then one round on
   ``sp`` (the single-lane quantize and dequantize once a client: 16 each),
   then one MESH round of the recipe's own ``eftopk``, after which every
   client's residual must be non-zero.
5. The cross-silo path: the flagship recipe through ``fedml_tpu_torch.init``
   and ``FedMLRunner(cfg).run()`` with ``training_type: cross_silo``,
   ``role: server``, ``backend: INPROC``, 4 silos all in every round, 3
   rounds, Shamir SecAgg with the streaming field fold
   (``extra.secagg_method: shamir``, ``extra.secagg_stream: true``),
   central DP (Gaussian, epsilon 50, delta 1e-5, sensitivity 0.01, clip 1.0)
   and ``extra.fused_blocks``: the server and 4 clients are threads of this
   process on the in-process fabric.  The counts are zeroed before and read
   after: the noise kernel must launch once per round, in its vector
   variant, each fused kernel must launch, the fold must keep at most 2
   updates, every test metric and weight must be finite, and round 0's
   noised global must be bitwise the plain version applied to its clipped
   global with the same draw (and differ from it).  After each round (outside
   its timed finalize) it prints the round delta's L2 norm before the clip,
   the BN running statistics' share of its squared norm, and its norm after
   the clip.

The line before the last is the ``{"kernels": [...]}`` JSON (each kernel's
launches from its own path's run: the lane-batched kernels from the MESH
rounds of phases 3-4, the single-lane fused kernels from phase 5, the
single-lane quantize kernels from phase 4's sp round); the last line is
``{"ok": true,
"device": {...}}``.  ``--kernels-only`` stops after phase 2 and prints
neither.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

FLAGSHIP = "examples/sp_fedavg_cifar10_resnet20/fedml_config.yaml"
FEDSGD = "examples/sp_fedsgd_eftopk_cifar10_resnet20/fedml_config.yaml"
SHAPES = [(128, 32, 32, 16), (128, 16, 16, 32), (128, 8, 8, 64)]
# launches of each fused kernel per local step at each of SHAPES (ResNet-20:
# the stem and each block's first BN + ReLU without a residual, each block's
# second with one; the backward mirrors the forward)
STEP_LAUNCHES = {"fused_bn_relu_fwd": (4, 3, 3), "fused_bn_residual_relu_fwd": (3, 3, 3),
                 "fused_bn_relu_bwd": (4, 3, 3), "fused_bn_residual_relu_bwd": (3, 3, 3)}
GRAD_LENGTH = 269722  # ResNet-20's parameters: the FedSGD gradient
QUANT_LENGTHS = [GRAD_LENGTH, 2**24]
SECAGG_LENGTH = 271098  # ResNet-20's parameters and BN statistics: the SecAgg vector
NOISE_LENGTHS = [SECAGG_LENGTH, 2**24]
# the cross-silo path's central DP (the reference's own CDP test values)
DP = dict(enable_dp=True, dp_solution_type="cdp", mechanism_type="gaussian", epsilon=50.0,
          delta=1e-5, sensitivity=0.01, clipping_norm=1.0)
SILOS = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
L2_BYTES = 50e6
ROUNDS = 3
NOISE_RUNS = 7  # alternating timings of the noise kernel and torch.add
LANES = 64  # the flagship's clients a round: the lanes of its MESH round
FEDSGD_LANES = 16  # the FedSGD recipe's clients a round
# ResNet-20's fused sites a local step: the stem and each block's first
# epilogue without a residual, each block's second with one (either direction)
SITES = {name: sum(w) for name, w in STEP_LAUNCHES.items()}
AB_PAIRS = 3  # alternating fused / unfused MESH rounds
SP_CHECK_CLIENTS = 8  # the f32 MESH-vs-sp round's clients
MESH_SP_RTOL, MESH_SP_ATOL = 2e-4, 2e-5  # the reference's own (tests/test_m0_fedavg.py)
# a whole f32 round of ResNet-20 moves by as much as MESH and sp differ when
# its initial weights move by one ulp (PERF.md §6): the round is held to
# that spread, with room for the draw of the perturbation
ROUND_SPREADS = 2


def _gen(shape, dtype, device, seed):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)


def _eager_ms(fn, arg_sets, iters=100, repeats=10, warmup=20):
    """Per-call time of eager calls back to back (CUDA events): what the
    main path pays, host launch overhead included.  The least of
    ``repeats`` runs of ``iters`` calls: the host is shared, and other work
    on it only adds time."""
    import torch

    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return min(runs)


def _device_ms(fn, arg_sets, replays=25):
    """Per-call device time: one call per input set captured in a CUDA graph,
    replayed (CUDA events), so host launch overhead drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(arg_sets))


def _kernel_cases(fb):
    """name -> (kernel call, plain call, operand maker, bytes(n, C, item), flops(n),
    the same-bytes PyTorch stream or None)."""
    def fwd_args(y, r, g, s, b):
        return y, s, b

    def fwd_res_args(y, r, g, s, b):
        return y, s, b, r

    def bwd_args(y, r, g, s, b):
        out = fb.fused_block_reference(y, s, b)
        return g, y, s, out

    def bwd_res_args(y, r, g, s, b):
        out = fb.fused_block_reference(y, s, b, r)
        return g, y, s, out

    import torch

    return {
        fb.FWD.name: (lambda y, s, b: fb.fused_block_forward(y, s, b),
                      lambda y, s, b: fb.fused_block_reference(y, s, b),
                      fwd_args, lambda n, c, it: 2 * n * it + 2 * c * 4, lambda n: 3 * n,
                      lambda y, s, b: torch.relu(y)),
        fb.FWD_RES.name: (lambda y, s, b, r: fb.fused_block_forward(y, s, b, r),
                          lambda y, s, b, r: fb.fused_block_reference(y, s, b, r),
                          fwd_res_args, lambda n, c, it: 3 * n * it + 2 * c * 4, lambda n: 4 * n,
                          lambda y, s, b, r: torch.add(y, r)),
        fb.BWD.name: (lambda g, y, s, o: fb.fused_block_backward(g, y, s, o, False),
                      lambda g, y, s, o: fb.fused_block_bwd_reference(g, y, s, o, False),
                      bwd_args, lambda n, c, it: 4 * n * it + 3 * c * 4, lambda n: 6 * n, None),
        fb.BWD_RES.name: (lambda g, y, s, o: fb.fused_block_backward(g, y, s, o, True),
                          lambda g, y, s, o: fb.fused_block_bwd_reference(g, y, s, o, True),
                          bwd_res_args, lambda n, c, it: 5 * n * it + 3 * c * 4, lambda n: 6 * n,
                          None),
    }


def _compare(name, got, want, operands, dtype):
    """Max abs error of one call against the plain version; raises past the
    stated tolerance."""
    import torch

    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None and b is None:
            continue
        a32, b32 = a.float(), b.float()
        err = max(err, float((a32 - b32).abs().max()))
        is_reduction = name.endswith("_bwd") and i in (1, 2)
        if is_reduction:
            g, y, s, out = operands
            gm = g.float() * (out > 0).float()
            terms = (gm * y.float()).abs() if i == 1 else gm.abs()
            # per channel, and per lane for (L, C) sums
            lead = tuple(a32.shape[:-1])
            bound = 1e-5 * terms.reshape(lead + (-1, terms.shape[-1])).sum(-2) + 1e-30
            if not bool(((a32 - b32).abs() <= bound).all()):
                raise AssertionError(f"{name} output {i} {dtype}: reduction beyond 1e-5*sum|terms|")
        elif dtype == torch.float32 or name.endswith("_fwd"):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} output {i} {dtype}: not bitwise equal to the "
                                     "plain version")
        else:
            tol = 2.0 ** -8 * b32.abs()  # one bf16 ulp
            if not bool(((a32 - b32).abs() <= tol).all()):
                raise AssertionError(f"{name} output {i} bf16: beyond one bf16 ulp")
    return err


def phase_kernels(fb):
    import torch

    dev = torch.device("cuda")
    cases = _kernel_cases(fb)
    results = {name: {"max_abs_err": 0.0} for name in cases}
    rows = {}  # (name, dtype) -> [(ms, bound_ms, stream_ms)] in the order of SHAPES
    for shape in SHAPES:
        c = shape[-1]
        n = math.prod(shape)
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.tensor([], dtype=dtype).element_size()
            # each kernel reads at least y (n * item bytes) a call, so every
            # kernel's operands rotate through more than twice the L2
            n_sets = max(2, int(2 * L2_BYTES // (n * item)) + 1)
            base = [(_gen(shape, dtype, dev, 10 * k + 1), _gen(shape, dtype, dev, 10 * k + 2),
                     _gen(shape, dtype, dev, 10 * k + 3), _gen((c,), torch.float32, dev, 10 * k + 4),
                     _gen((c,), torch.float32, dev, 10 * k + 5)) for k in range(n_sets)]
            for name, (kern, plain, build_args, nbytes, nflops, stream) in cases.items():
                arg_sets = [build_args(*b) for b in base]
                variants = fb.variant_counts()
                got, want = kern(*arg_sets[0]), plain(*arg_sets[0])
                torch.cuda.synchronize()
                variant = [k for k, v in fb.variant_counts().items() if v > variants[k]]
                err = _compare(name, got, want, arg_sets[0], dtype)
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
                ms, plain_ms = _device_ms(kern, arg_sets), _device_ms(plain, arg_sets)
                eager_ms = _eager_ms(kern, arg_sets)
                stream_ms = _device_ms(stream, arg_sets) if stream is not None else None
                bytes_ms = nbytes(n, c, item) / HBM_BYTES_PER_S * 1e3
                ops_ms = nflops(n) / F32_FLOPS_PER_S * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                       "ms": ms, "plain_ms": plain_ms, "eager_ms": eager_ms, "bound_ms": bound_ms,
                       "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                       "max_abs_err": err, "stream_ms": stream_ms}
                yardstick = "" if stream is None else (
                    f", same-bytes stream {stream_ms * 1e3:.2f} us ({ms / stream_ms:.2f}x)")
                print(f"kernel {name} {row['dtype']} {tuple(shape)}: ok, device {ms * 1e3:.2f} us "
                      f"(plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us, "
                      f"{100 * bound_ms / ms:.1f}% of bound{yardstick}), eager call "
                      f"{eager_ms * 1e3:.2f} us, max_abs_err {err:.3g}"
                      + (f", {variant[0]} variant" if variant else ""))
                rows.setdefault((name, row["dtype"]), []).append((ms, bound_ms, stream_ms))
                if shape == SHAPES[0] and dtype == torch.bfloat16:
                    results[name].update({k: row[k] for k in
                                          ("ms", "plain_ms", "bound_ms", "bound_by")})
                    if stream is not None:
                        results[name]["stream_ms"] = stream_ms
    for (name, dtype), times in rows.items():
        weights = STEP_LAUNCHES[name]
        ms = sum(w * t for w, (t, _, _) in zip(weights, times))
        bound_ms = sum(w * b for w, (_, b, _) in zip(weights, times))
        yardstick = "" if times[0][2] is None else (
            f", same-bytes stream {sum(w * x for w, (_, _, x) in zip(weights, times)) * 1e3:.2f} us")
        print(f"kernel {name} {dtype} over a local step ({sum(weights)} launches, "
              f"{'/'.join(map(str, weights))} at the three shapes): device {ms * 1e3:.2f} us, "
              f"bound {bound_ms * 1e3:.2f} us, {100 * bound_ms / ms:.1f}% of bound{yardstick}")
    phase_fwd_scalar(fb)
    return results


def _misaligned(t):
    """A contiguous copy of t that starts one element past a 16-byte line."""
    base = t.new_empty(t.numel() + 1)
    view = base[1:].view(t.shape)
    view.copy_(t)
    return view


def phase_fwd_scalar(fb):
    """The forward's scalar variant (C not a multiple of the 16-byte width,
    or an operand off a 16-byte line) against the plain version, bitwise,
    in f32 and bf16, with and without the residual; the variant that ran is
    checked."""
    import torch

    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for what, shape in (("C=3", (128, 16, 16, 3)), ("C=300", (8, 8, 8, 300)),
                            ("misaligned y", SHAPES[1])):
            c = shape[-1]
            y, r = _gen(shape, dtype, dev, 41), _gen(shape, dtype, dev, 42)
            s, b = _gen((c,), torch.float32, dev, 43), _gen((c,), torch.float32, dev, 44)
            if what.startswith("misaligned"):
                y = _misaligned(y)
            want = "fwd_vector" if c % (16 // y.element_size()) == 0 and not what.startswith(
                "misaligned") else "fwd_scalar"
            for res in (None, r):
                before = fb.variant_counts()[want]
                got = fb.fused_block_forward(y, s, b, res)
                torch.cuda.synchronize()
                if fb.variant_counts()[want] != before + 1:
                    raise AssertionError(f"forward {what} {dtype}: {want} did not run")
                if not torch.equal(got, fb.fused_block_reference(y, s, b, res)):
                    raise AssertionError(f"forward {what} {dtype} residual={res is not None}: "
                                         "not bitwise equal to the plain version")
            print(f"kernel forward {what} {str(dtype).replace('torch.', '')} {shape}: ok "
                  f"(bitwise, with and without the residual), {want} variant")


def _equal_outputs(a, b) -> bool:
    """Whether two kernel results (a tensor, or a tuple with Nones) are
    bitwise equal."""
    import torch

    if not isinstance(a, tuple):
        a, b = (a,), (b,)
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def phase_lane_kernels(fb):
    """Rows 1-4 lane-batched (``*_lanes``: one launch for L lane-major
    activations with per-lane scale and shift) at the MESH round's L = 64
    and the three stage shapes, f32 and bf16: every lane bitwise the
    single-lane kernel on its slice (all outputs, d_scale and d_shift too:
    each lane keeps the single-lane fold order), each held against the plain
    version with phase 2's tolerances (sums per lane and channel), device
    time from CUDA-graph replays and eager time, next to the bound."""
    import torch

    dev = torch.device("cuda")
    cases = _kernel_cases(fb)
    lane_kernel = {k.name: lk for k, lk in zip(fb.KERNELS, fb.LANE_KERNELS)}
    results = {k.name: {"max_abs_err": 0.0} for k in fb.LANE_KERNELS}
    rows = {}
    for shape in SHAPES:
        lshape, c = (LANES,) + shape, shape[-1]
        n = math.prod(lshape)
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.tensor([], dtype=dtype).element_size()
            n_sets = max(2, int(2 * L2_BYTES // (n * item)) + 1)
            base = [(_gen(lshape, dtype, dev, 10 * k + 1), _gen(lshape, dtype, dev, 10 * k + 2),
                     _gen(lshape, dtype, dev, 10 * k + 3),
                     _gen((LANES, c), torch.float32, dev, 10 * k + 4),
                     _gen((LANES, c), torch.float32, dev, 10 * k + 5)) for k in range(n_sets)]
            for name, (kern, plain, build_args, nbytes, nflops, stream) in cases.items():
                lk = lane_kernel[name]
                arg_sets = [build_args(*b) for b in base]
                before = fb.launch_counts()[lk.name]
                got, want = kern(*arg_sets[0]), plain(*arg_sets[0])
                torch.cuda.synchronize()
                if fb.launch_counts()[lk.name] != before + 1:
                    raise AssertionError(f"{lk.name}: a lane-major call did not launch it once")
                err = _compare(name, got, want, arg_sets[0], dtype)
                results[lk.name]["max_abs_err"] = max(results[lk.name]["max_abs_err"], err)
                for lane in range(LANES):
                    one = kern(*(a[lane] for a in arg_sets[0]))
                    mine = tuple(None if t is None else t[lane] for t in got) if isinstance(
                        got, tuple) else got[lane]
                    if not _equal_outputs(mine, one):
                        raise AssertionError(f"{lk.name} {dtype} {lshape}: lane {lane} is not "
                                             "bitwise the single-lane kernel on its slice")
                ms, plain_ms = _device_ms(kern, arg_sets), _device_ms(plain, arg_sets)
                eager_ms = _eager_ms(kern, arg_sets, iters=20, repeats=5, warmup=5)
                stream_ms = _device_ms(stream, arg_sets) if stream is not None else None
                bytes_ms = nbytes(n, LANES * c, item) / HBM_BYTES_PER_S * 1e3
                ops_ms = nflops(n) / F32_FLOPS_PER_S * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                dt = str(dtype).replace("torch.", "")
                yardstick = "" if stream is None else (
                    f", same-bytes stream {stream_ms * 1e3:.2f} us ({ms / stream_ms:.2f}x)")
                print(f"kernel {lk.name} {dt} {lshape}: ok (every lane bitwise the single-lane "
                      f"kernel), device {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, bound "
                      f"{bound_ms * 1e3:.2f} us, {100 * bound_ms / ms:.1f}% of bound{yardstick}), "
                      f"eager call {eager_ms * 1e3:.2f} us, max_abs_err {err:.3g}")
                rows.setdefault((lk.name, name, dt), []).append((ms, bound_ms))
                if shape == SHAPES[0] and dtype == torch.bfloat16:
                    results[lk.name].update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                             "bound_by": "bytes" if bytes_ms >= ops_ms
                                             else "operations"})
                    if stream is not None:
                        results[lk.name]["stream_ms"] = stream_ms
            del base, arg_sets, got, want
    for (lname, name, dt), times in rows.items():
        weights = STEP_LAUNCHES[name]
        ms = sum(w * t for w, (t, _) in zip(weights, times))
        bound_ms = sum(w * b for w, (_, b) in zip(weights, times))
        print(f"kernel {lname} {dt} over a batched step of {LANES} lanes ({sum(weights)} launches): "
              f"device {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us, "
              f"{100 * bound_ms / ms:.1f}% of bound")
    return results


def _quant_bytes(n):
    """Bytes each function must move: (quantize, dequantize)."""
    b = -(-n // 1024)
    return 4 * n + 4 * b * 1024 + b * 1024 + 4 * b, b * 1024 + 4 * b + 4 * n


def _variant_ran(mod, before):
    """kernel name -> the variant its launches since ``before`` ran (``mod``:
    a kernel module with ``variant_counts()``)."""
    ran = {}
    for name, counts in mod.variant_counts().items():
        moved = [v for v, c in counts.items() if c > before[name][v]]
        ran[name] = moved[0] if len(moved) == 1 else "none" if not moved else "both"
    return ran


def _check_quant(qz, x, u, what, variant):
    """Quantize and dequantize x on the card, bitwise against the plain
    versions, and check that ``variant`` ran (the values handed to the
    dequantize one byte off a 16-byte line for the scalar variant)."""
    import torch

    n = x.numel()
    before = qz.variant_counts()
    got, want = qz.quantize_int8_stochastic(x, u), qz.quantize_int8_reference(x, u)
    values = _misaligned(got[0]) if variant == "scalar" else got[0]
    deq = qz.dequantize_int8(values, got[1], n)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == want[2]):
        bad = int((got[0] != want[0]).sum())
        raise AssertionError(f"quantize kernel at {what}: {bad} values differ, scales equal "
                             f"{torch.equal(got[1], want[1])}: not bitwise the plain version")
    if not torch.equal(deq, qz.dequantize_int8_reference(values, got[1], n)) or deq.shape != (n,):
        raise AssertionError(f"dequantize kernel at {what}: not bitwise the plain version")
    singles = {k.name for k in qz.KERNELS}
    ran = {k: v for k, v in _variant_ran(qz, before).items() if k in singles}
    if set(ran.values()) != {variant}:
        raise AssertionError(f"quantize kernels at {what}: ran {ran}, expected {variant}")
    return ran


def phase_quantize(qz):
    """The int8 quantize / dequantize kernels against their plain versions:
    values, scales and the dequantized vector bitwise; each line names the
    variant that ran and the same-bytes stream (``torch.lt(x, u)``: reads
    x and u, writes a byte each; ``values.to(float32)``: reads a byte,
    writes four)."""
    import torch

    dev = torch.device("cuda")
    results = {k.name: {"max_abs_err": 0.0} for k in qz.KERNELS}
    for n in QUANT_LENGTHS:
        shape = qz.noise_shape(n)
        q_bytes, dq_bytes = _quant_bytes(n)
        n_sets = max(2, int(3 * L2_BYTES // q_bytes) + 1)
        sets = []
        for k in range(n_sets):
            g = torch.Generator(device=dev)
            g.manual_seed(100 + k)
            x = torch.randn(n, generator=g, device=dev) * torch.exp(
                3 * torch.randn(n, generator=g, device=dev))
            sets.append((x, torch.rand(shape, generator=g, device=dev)))
        ran = _check_quant(qz, *sets[0], f"n={n}", "vector")
        dq_sets = [qz.quantize_int8_stochastic(*a) for a in sets]

        def q_stream(x, u, n=n):
            return torch.lt(x, u.view(-1)[:n])

        def dq_stream(values, scales, n):
            return values.view(-1)[:n].to(torch.float32)

        cases = [(qz.QUANTIZE, qz.quantize_int8_stochastic, qz.quantize_int8_reference, sets,
                  q_bytes, 7 * shape[0] * 1024, q_stream),
                 (qz.DEQUANTIZE, qz.dequantize_int8, qz.dequantize_int8_reference, dq_sets,
                  dq_bytes, n, dq_stream)]
        for kern, fn, plain, arg_sets, nbytes, nops, stream in cases:
            ms, plain_ms = _device_ms(fn, arg_sets), _device_ms(plain, arg_sets)
            stream_ms = _device_ms(stream, arg_sets)
            eager_ms = _eager_ms(fn, arg_sets)
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            print(f"kernel {kern.name} n={n} ({shape[0]} blocks): ok (bitwise), device "
                  f"{ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us, "
                  f"{100 * bound_ms / ms:.1f}% of bound, same-bytes stream {stream_ms * 1e3:.2f} us "
                  f"({ms / stream_ms:.2f}x)), eager call {eager_ms * 1e3:.2f} us, "
                  f"{ran[kern.name]} variant")
            if n == GRAD_LENGTH:
                results[kern.name].update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                           "stream_ms": stream_ms,
                                           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
    for n, misaligned in ((1025, False), (GRAD_LENGTH, True)):
        g = torch.Generator(device=dev)
        g.manual_seed(150 + n)
        x = torch.randn(n, generator=g, device=dev) * torch.exp(
            3 * torch.randn(n, generator=g, device=dev))
        u = torch.rand(qz.noise_shape(n), generator=g, device=dev)
        what = f"n={n}" + (" with x off a 16-byte line" if misaligned else "")
        ran = _check_quant(qz, _misaligned(x) if misaligned else x, u, what,
                           "scalar" if misaligned else "vector")
        print(f"kernel quantize / dequantize {what}: ok (bitwise), {ran[qz.QUANTIZE.name]} variant")
    return results


def phase_lane_quantize(qz):
    """Rows 5-6 lane-batched (``*_lanes``: the L lanes padded to whole
    blocks and laid end to end, one launch each) at the FedSGD round's 16
    lanes of 269,722: every lane's values, scales and dequantized vector
    bitwise the single-lane kernels' on that lane and the plain versions';
    device time of each kernel from CUDA-graph replays on the laid-out
    operands (and of the wrapper, the pad's copy included), eager time and
    bound."""
    import torch

    dev = torch.device("cuda")
    n, lanes = GRAD_LENGTH, FEDSGD_LANES
    shape = (lanes,) + qz.noise_shape(n)
    q_bytes, dq_bytes = (lanes * b for b in _quant_bytes(n))
    sets = []
    for k in range(max(2, int(2 * L2_BYTES // min(q_bytes, dq_bytes)) + 1)):
        g = torch.Generator(device=dev)
        g.manual_seed(300 + k)
        x = torch.randn((lanes, n), generator=g, device=dev) * torch.exp(
            3 * torch.randn((lanes, n), generator=g, device=dev))
        sets.append((x, torch.rand(shape, generator=g, device=dev)))
    x, u = sets[0]
    before = qz.launch_counts()
    values, scales, length = qz.quantize_int8_lanes(x, u)
    deq = qz.dequantize_int8_lanes(values, scales, length)
    torch.cuda.synchronize()
    after = qz.launch_counts()
    for k in qz.LANE_KERNELS:
        if after[k.name] != before[k.name] + 1:
            raise AssertionError(f"{k.name}: {lanes} lanes did not take one launch")
    want = qz.quantize_int8_lanes_reference(x, u)
    if not (torch.equal(values, want[0]) and torch.equal(scales, want[1]) and torch.equal(
            deq, qz.dequantize_int8_lanes_reference(values, scales, length))):
        raise AssertionError("lane-batched quantize kernels: not bitwise the plain versions")
    for lane in range(lanes):
        v1, s1, _ = qz.quantize_int8_stochastic(x[lane], u[lane])
        if not (torch.equal(v1, values[lane]) and torch.equal(s1, scales[lane])
                and torch.equal(qz.dequantize_int8(v1, s1, n), deq[lane])):
            raise AssertionError(f"lane-batched quantize kernels: lane {lane} is not bitwise "
                                 "the single-lane kernels on its vector")
    laid_out = [qz.lanes_end_to_end(*a)[:2] for a in sets]
    dq_laid_out = [qz.quantize_int8_reference(*a) for a in laid_out]
    wrapped = {qz.QUANTIZE_LANES.name: (qz.quantize_int8_lanes, sets),
               qz.DEQUANTIZE_LANES.name: (qz.dequantize_int8_lanes,
                                          [qz.quantize_int8_lanes(*a) for a in sets])}
    results = {}
    for kern, fn, plain, arg_sets, nbytes, nops, stream in (
            (qz.QUANTIZE_LANES, lambda x, u: qz._quantize_cuda(x, u, qz.QUANTIZE_LANES),
             qz.quantize_int8_reference, laid_out, q_bytes, 7 * shape[1] * 1024 * lanes,
             lambda x, u: torch.lt(x, u.view(-1))),
            (qz.DEQUANTIZE_LANES,
             lambda v, s, m: qz._dequantize_cuda(v, s, m, qz.DEQUANTIZE_LANES),
             qz.dequantize_int8_reference, dq_laid_out, dq_bytes, n * lanes,
             lambda v, s, m: v.view(-1).to(torch.float32))):
        ms, plain_ms = _device_ms(fn, arg_sets), _device_ms(plain, arg_sets)
        stream_ms = _device_ms(stream, arg_sets)
        wrapper_fn, wrapper_sets = wrapped[kern.name]
        wrapper_ms = _device_ms(wrapper_fn, wrapper_sets)
        eager_ms = _eager_ms(wrapper_fn, wrapper_sets)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"kernel {kern.name} {lanes} x {n}: ok (bitwise, every lane the single-lane "
              f"kernels'), device {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, bound "
              f"{bound_ms * 1e3:.2f} us, {100 * bound_ms / ms:.1f}% of bound, same-bytes stream "
              f"{stream_ms * 1e3:.2f} us ({ms / stream_ms:.2f}x); the wrapper with its layout "
              f"{wrapper_ms * 1e3:.2f} us), eager call {eager_ms * 1e3:.2f} us")
        results[kern.name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "stream_ms": stream_ms,
                              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    return results


def _check_noise(nz, x, noise, sigmas, what, variant):
    """The noise kernel on x at each sigma, bitwise against the plain
    version, and a check that ``variant`` ran; returns the variant."""
    import torch

    n = x.numel()
    before = nz.variant_counts()
    for s in sigmas:
        got, want = nz.apply_gaussian_noise(x, noise, s), nz.apply_gaussian_noise_reference(
            x, noise, s)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or got.shape != (n,):
            bad = int((got != want).sum())
            raise AssertionError(f"noise kernel at {what}, sigma={s}: {bad} elements not "
                                 "bitwise the plain version")
    ran = _variant_ran(nz, before)[nz.NOISE.name]
    if ran != variant:
        raise AssertionError(f"noise kernel at {what}: ran {ran}, expected {variant}")
    return ran


def phase_noise(nz):
    """The central-DP noise kernel against its plain version: bitwise at the
    DP sigma, at 0.25 and at 0 (the identity); each line names the variant
    that ran.  Then at the SecAgg vector's length with x off a 16-byte line
    (the scalar variant, checked)."""
    import torch

    from fedml_tpu_torch.trust.dp.dp import gaussian_sigma

    dev = torch.device("cuda")
    sigma = gaussian_sigma(DP["epsilon"], DP["delta"], DP["sensitivity"])
    results = {nz.NOISE.name: {"max_abs_err": 0.0}}
    for n in NOISE_LENGTHS:
        shape = nz.noise_shape(n)
        nbytes = 12 * n  # read x, read the first n noise values, write out
        sets = []
        for k in range(max(2, int(3 * L2_BYTES // nbytes) + 1)):
            g = torch.Generator(device=dev)
            g.manual_seed(200 + k)
            sets.append((torch.randn(n, generator=g, device=dev),
                         torch.randn(shape, generator=g, device=dev), sigma))
        x, noise, _ = sets[0]
        ran = _check_noise(nz, x, noise, (sigma, 0.25, 0.0), f"n={n}", "vector")
        if not torch.equal(nz.apply_gaussian_noise(x, noise, 0.0), x):
            raise AssertionError(f"noise kernel at n={n}: sigma 0 is not the identity")

        def library(x, noise, s, n=n):
            return torch.add(x, noise.view(-1)[:n], alpha=s)

        ms = _device_ms(nz.apply_gaussian_noise, sets)
        plain_ms = _device_ms(nz.apply_gaussian_noise_reference, sets)
        library_ms = _device_ms(library, sets)
        eager_ms = _eager_ms(nz.apply_gaussian_noise, sets)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, 2 * n / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"kernel {nz.NOISE.name} n={n} ({shape[0]} blocks): ok (bitwise at sigma "
              f"{sigma:.6g}, 0.25, 0), device {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, "
              f"torch.add {library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us, "
              f"{100 * bound_ms / ms:.1f}% of bound), eager call {eager_ms * 1e3:.2f} us, "
              f"{ran} variant")
        # the kernel against torch.add in alternating runs: a median and its
        # spread, where one run of each cannot tell a gap from the noise
        runs = {"kernel": [], "torch.add": []}
        for _ in range(NOISE_RUNS):
            runs["kernel"].append(_device_ms(nz.apply_gaussian_noise, sets))
            runs["torch.add"].append(_device_ms(library, sets))
        print(f"kernel {nz.NOISE.name} n={n} against torch.add, {NOISE_RUNS} alternating runs: "
              + ", ".join(f"{k} median {statistics.median(v) * 1e3:.3f} us (min {min(v) * 1e3:.3f}, "
                          f"max {max(v) * 1e3:.3f})" for k, v in runs.items()))
        if n == SECAGG_LENGTH:
            results[nz.NOISE.name].update({
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "library_ms": library_ms,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
    g = torch.Generator(device=dev)
    g.manual_seed(250)
    x = torch.randn(SECAGG_LENGTH, generator=g, device=dev)
    noise = torch.randn(nz.noise_shape(SECAGG_LENGTH), generator=g, device=dev)
    ran = _check_noise(nz, _misaligned(x), noise, (sigma, 0.25), "the SecAgg vector off a "
                       "16-byte line", "scalar")
    print(f"kernel {nz.NOISE.name} n={SECAGG_LENGTH} with x off a 16-byte line: ok (bitwise at "
          f"sigma {sigma:.6g}, 0.25), {ran} variant")
    return results


def phase_fedsgd_check():
    """One FedSGD client gradient (ResNet-20, f32, a 16-sample shard in
    batches of 8) on the card against the same on the CPU, then quantized
    with the same draw on both: int8 levels at most one apart."""
    import torch

    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import make_full_grad_fn
    from fedml_tpu_torch.fl.types import HParams
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.ops import quantize

    model = resnet.resnet20(10, torch.float32)
    gen = torch.Generator()
    gen.manual_seed(1)
    variables = model.init(gen, "cpu")
    x, y = torch.randn((16, 32, 32, 3), generator=gen), torch.randint(0, 10, (16,), generator=gen)
    full_grad = make_full_grad_fn(model, HParams(batch_size=8))
    flats, sent = {}, {}
    for dev in ("cpu", "cuda"):
        v = pt.tree_map(lambda t: t.to(dev), variables)
        flats[dev], _ = weights.flatten_reference(full_grad(v, x.to(dev), y.to(dev)))
    noise = torch.rand(quantize.noise_shape(flats["cpu"].numel()), generator=gen)
    for dev in ("cpu", "cuda"):
        sent[dev] = [t.cpu() for t in quantize.quantize_int8_stochastic(flats[dev], noise.to(dev))[:2]]
    a, b = flats["cpu"], flats["cuda"].cpu()
    if not torch.allclose(b, a, rtol=1e-3, atol=1e-4):
        raise AssertionError(f"FedSGD gradient on the card disagrees with the CPU "
                             f"(max abs diff {float((a - b).abs().max()):.3g})")
    levels = (sent["cuda"][0].int() - sent["cpu"][0].int()).abs()
    if int(levels.max()) > 1 or not torch.allclose(sent["cuda"][1], sent["cpu"][1], rtol=1e-3):
        raise AssertionError("qsgd_int8 of the card's gradient: a level apart by more than one")
    print(f"fedsgd check: resnet20 f32 gradient of 16 samples, card vs CPU within rtol 1e-3 / "
          f"atol 1e-4 (max abs diff {float((a - b).abs().max()):.3g}); quantized with the same "
          f"draw: {int((levels > 0).sum())} of {a.numel()} int8 levels one apart")


def phase_model_check(fb):
    """One fused ResNet-20 train step (f32, batch 8) on the card against the
    same step on the CPU: logits, grads and new batch stats."""
    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import resnet

    model = resnet.resnet20(10, torch.float32, fused=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    var_cpu = model.init(gen, "cpu")
    x = torch.randn((8, 32, 32, 3), generator=gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev, copy=True).requires_grad_(True)
                  for t in pt.tree_leaves(var_cpu["params"])]
        params = pt.tree_unflatten_like(var_cpu["params"], leaves)
        stats = pt.tree_map(lambda t: t.to(dev), var_cpu["batch_stats"])
        logits, new_stats = model.apply({"params": params, "batch_stats": stats}, x.to(dev), True)
        loss = (logits.float() - 1.0).square().mean()
        grads = torch.autograd.grad(loss, leaves)
        outs[dev] = [logits, *grads, *pt.tree_leaves(new_stats)]
    worst = 0.0
    for a, b in zip(outs["cpu"], outs["cuda"]):
        a, b = a.detach(), b.detach().cpu()
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-4):
            raise AssertionError("fused resnet20 step on the card disagrees with the CPU "
                                 f"(max abs diff {float((a - b).abs().max()):.3g})")
        worst = max(worst, float((a - b).abs().max()))
    print(f"model check: fused resnet20 f32 step, card vs CPU within rtol 1e-3 / atol 1e-4 "
          f"(max abs diff {worst:.3g}); launches {fb.launch_counts()}")


class _RoundProbe:
    """Wraps the simulator's metrics logger: at each logged round it records
    the cumulative kernel launch counts and the peak device memory."""

    def __init__(self, inner, counts):
        self.inner, self.counts, self.rows = inner, counts, []

    def log(self, metrics, step=None):
        import torch

        torch.cuda.synchronize()
        self.rows.append((dict(metrics), self.counts(), torch.cuda.max_memory_allocated()))
        self.inner.log(metrics, step)


def _all_counts(mods):
    return {k: v for m in mods for k, v in m.launch_counts().items()}


def _reset_counts(mods):
    for m in mods:
        m.reset_launch_counts()


def _check_finite(sim, history, keys):
    import torch

    from fedml_tpu_torch.core import pytree as pt

    for metrics in history:
        for key in keys:
            if not math.isfinite(metrics[key]):
                raise AssertionError(f"round {metrics['round']}: {key} = {metrics[key]}")
    for leaf in pt.tree_leaves(sim.global_vars):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError("non-finite global variables after training")


def _own_steps(sim, round_idx):
    """The sampled lanes' own step budgets in a round (``step_mode`` match:
    ``epochs * ceil(count / batch)``, at most the local steps), from the
    host's sampling and counts."""
    import numpy as np

    counts = sim.counts[np.asarray(sim.sampler.sample(round_idx))]
    own = sim.hp.epochs * -(-counts // sim.cfg.batch_size)
    return np.minimum(own, sim.hp.local_steps)


def _flagship(dataset=None, **overrides):
    """The flagship recipe through ``fedml_tpu_torch.init`` and
    ``FedMLRunner`` with ``overrides`` (attributes, ``fused_blocks`` to
    ``extra``); ``dataset`` reuses an earlier run's data."""
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    cfg.extra["fused_blocks"] = overrides.pop("fused_blocks", True)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return FedMLRunner(cfg, dataset=dataset)


def phase_main_path(mods):
    """The flagship on MESH, fused: every fused kernel in its lanes variant,
    each fused site once a batched step (the steps the longest lane budget
    takes), never once a client; the single-lane backward never."""
    import torch

    fb = mods[0]
    t0 = time.perf_counter()
    runner = _flagship(comm_round=ROUNDS, frequency_of_the_test=1)
    sim, cfg = runner.runner, runner.cfg
    print(f"main path: set-up {time.perf_counter() - t0:.1f} s (data {sim.dataset.train_num}/"
          f"{sim.dataset.test_num}, {sim.dataset.n_clients} clients, capacity {sim.capacity}, "
          f"{cfg.client_num_per_round}/round, batch {cfg.batch_size}, {cfg.compute_dtype}, "
          f"backend {sim.backend}, fused)")
    if sim.backend != "MESH":
        raise AssertionError(f"the flagship recipe ran on {sim.backend}, not MESH")
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(mods)
    history = runner.run()
    torch.cuda.synchronize()
    counts = _all_counts(mods)
    prev = {k: 0 for k in counts}
    for metrics, cum, mem in probe.rows:
        r = metrics["round"]
        own = _own_steps(sim, r)
        steps = int(own.max())
        computed = metrics["num_steps"] * cfg.client_num_per_round
        delta = {k: cum[k] - prev[k] for k in cum}
        prev = cum
        print(f"round {r}: {metrics['round_time_s']:.3f} s, "
              f"{int(own.sum()) * cfg.batch_size / metrics['round_time_s']:.0f} trained samples/s, "
              f"{steps} batched steps of up to {len(own)} lanes, lane-steps computed "
              f"{computed:.0f} against the lanes' own steps {int(own.sum())} (every lane every "
              f"step: {len(own) * sim.hp.local_steps}), train_loss {metrics['train_loss']:.4f}, "
              f"test_acc {metrics.get('test_acc', float('nan')):.4f}, max_memory_allocated "
              f"{mem / 2**30:.2f} GiB, launches {delta}")
        if round(computed) != int(own.sum()):
            raise AssertionError(f"round {r}: {computed} lane-steps, the budgets sum to "
                                 f"{int(own.sum())}")
        for k, lk in zip(fb.KERNELS, fb.LANE_KERNELS):
            if delta[lk.name] != SITES[k.name] * steps:
                raise AssertionError(f"round {r}: {lk.name} launched {delta[lk.name]} times, "
                                     f"expected {SITES[k.name]} sites x {steps} batched steps")
        for k in (fb.BWD, fb.BWD_RES):
            if delta[k.name]:
                raise AssertionError(f"round {r}: {k.name} launched {delta[k.name]} times: "
                                     "a client trained alone")
    if len(history) != ROUNDS:
        raise AssertionError(f"expected {ROUNDS} rounds, got {len(history)}")
    _check_finite(sim, history, ("train_loss", "test_loss", "test_acc"))
    return counts, runner.dataset


def phase_fused_ab(dataset):
    """Fused against unfused MESH rounds of the flagship, the host bound
    gone: after a warm-up round each, AB_PAIRS pairs of the same rounds
    (same data, sampling and initial weights), the order alternating."""
    import statistics

    import torch

    sims = {fused: _flagship(dataset, fused_blocks=fused, metrics_jsonl_path="").runner
            for fused in (True, False)}
    for sim in sims.values():
        sim.run_round()
    torch.cuda.synchronize()
    times = {True: [], False: []}
    for i in range(AB_PAIRS):
        for fused in ((True, False) if i % 2 == 0 else (False, True)):
            sim = sims[fused]
            steps = int(_own_steps(sim, sim.round_idx).max())
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics = sim.run_round()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            times[fused].append(dt / steps)
            print(f"fused A/B pair {i} fused={fused} round {sim.round_idx - 1}: {dt:.3f} s, "
                  f"{steps} batched steps, {dt / steps * 1e3:.2f} ms a batched step, train_loss "
                  f"{metrics['train_loss']:.4f}, max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for fused, per_step in times.items():
        print(f"fused A/B fused={fused}: median {statistics.median(per_step) * 1e3:.2f} ms a "
              f"batched step over {AB_PAIRS} rounds (min {min(per_step) * 1e3:.2f}, max "
              f"{max(per_step) * 1e3:.2f})")


def _largest_difference(a, b):
    """(largest |a - b| over the leaves, the largest excess over the MESH-vs-sp
    tolerance)."""
    from fedml_tpu_torch.core import pytree as pt

    worst, excess = 0.0, -math.inf
    for x, y in zip(pt.tree_leaves(a), pt.tree_leaves(b)):
        diff = (x - y).abs()
        worst = max(worst, float(diff.max()))
        excess = max(excess, float((diff - MESH_SP_ATOL - MESH_SP_RTOL * y.abs()).max()))
    return worst, excess


def phase_mesh_vs_sp(dataset):
    """MESH against sp in f32 (TF32 off) at full width and data, with
    SP_CHECK_CLIENTS of the flagship's clients sampled.  First one local step
    of each sampled client: the lanes' one batched step against each client's
    single-lane step from the same weights and batch, held to the
    reference's own MESH-vs-SP tolerance.  Then one whole round on each
    backend from the same initial weights, and beside it the sp round from
    initial weights one f32 ulp apart (each weight scaled by 1 +- 2^-23): the
    round's f32 trajectory moves by as much as MESH and sp differ, so the
    round is held to that spread, and the largest difference printed."""
    import dataclasses

    import torch

    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import make_batched_local_train_fn, make_local_train_fn

    sims = {}
    for name, backend in (("sp", "sp"), ("MESH", "MESH"), ("sp, weights an ulp apart", "sp")):
        sim = _flagship(dataset, backend_sim=backend, compute_dtype="float32",
                        client_num_per_round=SP_CHECK_CLIENTS, metrics_jsonl_path="").runner
        if name.startswith("sp, "):
            gen = torch.Generator(device=sim.device)
            gen.manual_seed(7)
            sim.global_vars = pt.tree_map(lambda t: t * (1 + 2.0 ** -23 * (2 * torch.randint(
                0, 2, t.shape, generator=gen, device=t.device) - 1)), sim.global_vars)
        sims[name] = sim

    sim = sims["MESH"]
    sampled = sim.sampler.sample(0)
    clients = torch.as_tensor(sampled, device=sim.device)
    perms = torch.stack([sim.sampler.perms(0, int(c), sim.hp.epochs, sim.capacity)
                         for c in sampled]).to(sim.device)
    one_step = dataclasses.replace(sim.hp, steps_per_epoch=1)
    lanes = pt.tree_map(lambda t: t.unsqueeze(0).expand((len(sampled),) + t.shape),
                        sim.global_vars)
    batched, _ = make_batched_local_train_fn(sim.model, one_step)(
        lanes, *sim._data, clients, sim.counts[sampled], perms)
    single = make_local_train_fn(sim.model, one_step)
    step_worst, step_excess = 0.0, -math.inf
    for lane, c in enumerate(sampled):
        alone, _ = single(sim.global_vars, sim._data[0][c], sim._data[1][c], int(sim.counts[c]),
                          None, perms=perms[lane])
        worst, excess = _largest_difference(pt.tree_map(lambda t: t[lane], batched), alone)
        step_worst, step_excess = max(step_worst, worst), max(step_excess, excess)
    print(f"mesh vs sp: one local step of {len(sampled)} lanes batched against each alone: "
          f"largest difference {step_worst:.3g} (rtol {MESH_SP_RTOL}, atol {MESH_SP_ATOL}: "
          f"{'within' if step_excess <= 0 else 'BEYOND'})")
    if step_excess > 0:
        raise AssertionError(f"a batched local step differs from the lanes' own steps by "
                             f"{step_worst:.3g}, beyond rtol {MESH_SP_RTOL} / atol {MESH_SP_ATOL}")

    for name, sim in sims.items():
        t0 = time.perf_counter()
        metrics = sim.run_round()
        torch.cuda.synchronize()
        print(f"mesh vs sp: {name}: f32 round of {SP_CHECK_CLIENTS} clients "
              f"{time.perf_counter() - t0:.3f} s, train_loss {metrics['train_loss']:.6f}")
    worst, excess = _largest_difference(sims["MESH"].global_vars, sims["sp"].global_vars)
    spread, _ = _largest_difference(sims["sp, weights an ulp apart"].global_vars,
                                    sims["sp"].global_vars)
    print(f"mesh vs sp: one round: largest difference of the globals {worst:.3g} (rtol "
          f"{MESH_SP_RTOL}, atol {MESH_SP_ATOL}: {'within' if excess <= 0 else 'beyond'}); sp "
          f"against itself from weights an ulp apart: {spread:.3g}")
    if excess > 0 and worst > ROUND_SPREADS * spread:
        raise AssertionError(f"MESH and sp globals differ by {worst:.3g} after a round, beyond "
                             f"rtol {MESH_SP_RTOL} / atol {MESH_SP_ATOL} and beyond "
                             f"{ROUND_SPREADS} x sp's own one-ulp spread {spread:.3g}")


def _fedsgd(dataset=None, **overrides):
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(argv=["--cf", FEDSGD])
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return FedMLRunner(cfg, dataset=dataset)


def phase_fedsgd(mods, qz):
    """FedSGD on MESH with ``qsgd_int8``: the 16 lanes' gradients in
    lane-batched steps, quantize and dequantize once a round for all of
    them; then one sp round (the single-lane kernels, once a client), then
    one MESH round of the recipe's own ``eftopk``.  Returns the counts of
    the MESH rounds and of the sp round."""
    import torch

    t0 = time.perf_counter()
    runner = _fedsgd(comm_round=ROUNDS, frequency_of_the_test=1, compression="qsgd_int8")
    sim, cfg = runner.runner, runner.cfg
    clients = cfg.client_num_per_round
    batches = clients * (sim.capacity // cfg.batch_size)
    print(f"fedsgd path: set-up {time.perf_counter() - t0:.1f} s (data {sim.dataset.train_num}/"
          f"{sim.dataset.test_num}, {sim.dataset.n_clients} clients, capacity {sim.capacity}, "
          f"{clients}/round, batch {cfg.batch_size}, {cfg.compute_dtype}, compression "
          f"{cfg.compression}, backend {sim.backend}, {sim.capacity // cfg.batch_size} batched "
          f"steps of {clients} lanes a round)")
    if sim.backend != "MESH":
        raise AssertionError(f"the FedSGD recipe ran on {sim.backend}, not MESH")
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(mods)
    history = runner.run()
    torch.cuda.synchronize()
    counts = _all_counts(mods)
    prev = {k: 0 for k in counts}
    for metrics, cum, mem in probe.rows:
        delta = {k: cum[k] - prev[k] for k in cum}
        prev = cum
        print(f"round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"{batches * cfg.batch_size / metrics['round_time_s']:.0f} gradient samples/s, "
              f"test_loss {metrics['test_loss']:.4f}, test_acc {metrics['test_acc']:.4f}, "
              f"max_memory_allocated {mem / 2**30:.2f} GiB, launches {delta}")
        for k in qz.LANE_KERNELS:
            if delta[k.name] != 1:
                raise AssertionError(f"{k.name}: {delta[k.name]} launches in round "
                                     f"{metrics['round']}, expected 1 for all {clients} lanes")
        for k in qz.KERNELS:
            if delta[k.name]:
                raise AssertionError(f"{k.name}: a client quantized alone in round "
                                     f"{metrics['round']}")
    if len(history) != ROUNDS:
        raise AssertionError(f"expected {ROUNDS} rounds, got {len(history)}")
    _check_finite(sim, history, ("test_loss", "test_acc"))

    sp = _fedsgd(runner.dataset, comm_round=1, frequency_of_the_test=1, compression="qsgd_int8",
                 backend_sim="sp")
    _reset_counts(mods)
    t0 = time.perf_counter()
    history = sp.run()
    torch.cuda.synchronize()
    sp_counts = _all_counts(mods)
    print(f"fedsgd sp (the sequential twin): 1 round in {time.perf_counter() - t0:.3f} s, "
          f"test_loss {history[-1]['test_loss']:.4f}, launches {sp_counts}")
    for k in qz.KERNELS:
        if sp_counts[k.name] != clients:
            raise AssertionError(f"{k.name}: {sp_counts[k.name]} launches in the sp round, "
                                 f"expected {clients}")
    _check_finite(sp.runner, history, ("test_loss", "test_acc"))

    runner = _fedsgd(runner.dataset, comm_round=1, frequency_of_the_test=1)
    t0 = time.perf_counter()
    history = runner.run()
    torch.cuda.synchronize()
    sim = runner.runner
    _check_finite(sim, history, ("test_loss", "test_acc"))
    rows = sim.client_states.abs().sum(1)
    if not bool((rows > 0).all()) or not bool(torch.isfinite(sim.client_states).all()):
        raise AssertionError("eftopk: a client's residual is zero or not finite after its round")
    print(f"fedsgd eftopk (the recipe's own, {sim.backend}): 1 round in "
          f"{time.perf_counter() - t0:.3f} s, test_loss {history[-1]['test_loss']:.4f}, "
          f"test_acc {history[-1]['test_acc']:.4f}, residuals {tuple(sim.client_states.shape)} "
          f"non-zero for all {rows.numel()} clients")
    return counts, sp_counts


class _SecAggProbe(_RoundProbe):
    """The round probe of the cross-silo server: also the round's payload
    counters, the noise kernel's launches by variant, the round delta
    before its clip (its L2 norm and the BN running statistics' share of
    its squared norm) and after it (its norm), read after the timed
    finalize, and at round 0 the clipped global before its noise and the
    noised global (flat, on the card)."""

    def __init__(self, inner, counts, aggregator, nz):
        import torch

        from fedml_tpu_torch import weights

        super().__init__(inner, counts)
        self.aggregator, self.nz, self.payload, self.round0 = aggregator, nz, [], None
        self.variants, self.deltas = [], []
        self.prev = weights.flatten_reference(aggregator.global_vars)[0].clone()
        # sorted keys put the BN statistics first in the reference's flat layout
        stats = weights.flatten_reference({"batch_stats": aggregator.global_vars["batch_stats"]})[0]
        if not torch.equal(self.prev[:stats.numel()], stats):
            raise AssertionError("the BN statistics are not the head of the flat global")
        self.n_stats = stats.numel()

    def log(self, metrics, step=None):
        from fedml_tpu_torch import weights
        from fedml_tpu_torch.comm import codecs

        agg = self.aggregator
        self.payload.append(codecs.payload_counters().get("secagg_dense", {}).get("wire_bytes", 0))
        self.variants.append(self.nz.variant_counts()[self.nz.NOISE.name])
        delta = agg.dp_delta.double()
        sq = float(delta.square().sum())
        self.deltas.append((sq ** 0.5, float(delta[:self.n_stats].square().sum()) / sq,
                            float((agg.dp_pre_noise - self.prev).double().norm())))
        flat = weights.flatten_reference(agg.global_vars)[0]
        if self.round0 is None:
            self.round0 = (agg.dp_pre_noise.clone(), flat.clone())
        self.prev = flat.clone()
        super().log(metrics, step)


def phase_cross_silo(mods, nz):
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.comm import codecs
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.runner import FedMLRunner

    t0 = time.perf_counter()
    cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    cfg.training_type, cfg.role, cfg.backend = "cross_silo", "server", "INPROC"
    cfg.client_num_in_total = cfg.client_num_per_round = SILOS
    cfg.comm_round = ROUNDS
    cfg.frequency_of_the_test = 1
    cfg.enable_secagg = True
    for k, v in DP.items():
        setattr(cfg, k, v)
    cfg.extra.update(secagg_method="shamir", secagg_stream=True, fused_blocks=True)
    runner = FedMLRunner(cfg)
    group = runner.runner
    t1 = time.perf_counter()
    group.setup()
    torch.cuda.synchronize()
    server, clients = group.server, group.clients
    agg = server.aggregator
    steps = sum(c.trainer.trained_samples for c in clients) // cfg.batch_size
    print(f"cross-silo path: set-up {time.perf_counter() - t0:.1f} s (data and model "
          f"{t1 - t0:.1f} s, server + {len(clients)} silos to the card "
          f"{time.perf_counter() - t1:.1f} s; data {runner.dataset.train_num}/"
          f"{runner.dataset.test_num}, silo shards {[c.trainer.count for c in clients]}, "
          f"{steps} local steps a round, batch {cfg.batch_size}, {cfg.compute_dtype}, "
          f"SecAgg T={agg.t} over {agg.model_dim} elements ({agg.ring.bits}-bit ring, "
          f"{agg.ring.frac_bits} fractional bits), DP sigma {agg._dp.sigma():.6g})")
    probe = _SecAggProbe(server.logger, lambda: _all_counts(mods + (nz,)), agg, nz)
    server.logger = probe
    torch.cuda.reset_peak_memory_stats()
    before = codecs.payload_counters().get("secagg_dense", {}).get("wire_bytes", 0)
    _reset_counts(mods + (nz,))
    history = runner.run()
    torch.cuda.synchronize()
    counts = _all_counts(mods + (nz,))
    prev, prev_bytes = {k: 0 for k in counts}, before
    samples = sum(c.trainer.trained_samples for c in clients)
    prev_vector = 0
    for (metrics, cum, mem), wire, variants, (norm, bn_share, clipped) in zip(
            probe.rows, probe.payload, probe.variants, probe.deltas):
        delta = {k: cum[k] - prev[k] for k in cum}
        prev = cum
        print(f"round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"{samples / metrics['round_time_s']:.0f} trained samples/s, test_loss "
              f"{metrics['test_loss']:.4f}, test_acc {metrics['test_acc']:.4f}, finalize "
              f"(unmask + clip + noise) {1e3 * metrics['finalize_time_s']:.1f} ms, uploads "
              f"{wire - prev_bytes} bytes (frames {metrics['upload_bytes']}), "
              f"max_memory_allocated {mem / 2**30:.2f} GiB, launches {delta}")
        print(f"round {metrics['round']} delta: L2 norm before the clip {norm:.6g}, BN "
              f"statistics' share of its squared norm {bn_share:.6g} ({probe.n_stats} of "
              f"{agg.model_dim} elements), after the clip {clipped:.6g} (clip "
              f"{DP['clipping_norm']})")
        prev_bytes = wire
        if delta[nz.NOISE.name] != 1 or variants["vector"] != prev_vector + 1:
            raise AssertionError(f"round {metrics['round']}: {delta[nz.NOISE.name]} noise "
                                 f"launches ({variants}), expected 1 of the vector variant")
        prev_vector = variants["vector"]
    print(f"payload counters: {codecs.payload_counters()}")
    if len(history) != ROUNDS or counts[nz.NOISE.name] != ROUNDS:
        raise AssertionError(f"expected {ROUNDS} rounds and noise launches, got "
                             f"{len(history)} and {counts[nz.NOISE.name]}")
    bad = [k.name for k in mods[0].KERNELS if counts[k.name] == 0]
    if bad:
        raise AssertionError(f"fused kernels never launched on the cross-silo path: {bad}")
    if not agg.field_stream or agg.peak_buffered_updates > 2:
        raise AssertionError(f"streaming fold: field_stream {agg.field_stream}, peak buffered "
                             f"{agg.peak_buffered_updates}")
    for metrics in history:
        for key in ("test_loss", "test_acc"):
            if not math.isfinite(metrics[key]):
                raise AssertionError(f"round {metrics['round']}: {key} = {metrics[key]}")
    if not all(bool(torch.isfinite(leaf).all()) for leaf in pt.tree_leaves(agg.global_vars)):
        raise AssertionError("non-finite global variables after the cross-silo run")
    pre, post = probe.round0
    draw = agg.noise_sampler.gaussian(0, nz.noise_shape(pre.numel()), pre.device)
    if not torch.equal(post, nz.apply_gaussian_noise_reference(pre, draw, agg._dp.sigma())):
        raise AssertionError("round 0: the noised global is not the plain version's")
    if torch.equal(post, pre):
        raise AssertionError("round 0: the noise did not land (noised == clip-only global)")
    print(f"cross-silo check: round 0's global bitwise the plain noise of its clipped global, "
          f"max |noise| applied {float((post - pre).abs().max()):.3g}; peak buffered "
          f"{agg.peak_buffered_updates}; every client trained {[c.rounds_trained for c in clients]}")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building and checking the kernels (phases 1-2)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from fedml_tpu_torch.ops import build
    from fedml_tpu_torch.ops import fused_block as fb
    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.ops import quantize as qz

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    report = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(report) or 'nothing (cached)'}")
    for name, rec in report.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")

    mods = (fb, qz)
    kernel_rows = {**phase_kernels(fb), **phase_lane_kernels(fb), **phase_quantize(qz),
                   **phase_lane_quantize(qz), **phase_noise(nz)}
    phase_model_check(fb)
    phase_fedsgd_check()
    if args.kernels_only:
        return 0
    fedavg_counts, dataset = phase_main_path(mods)
    phase_fused_ab(dataset)
    phase_mesh_vs_sp(dataset)
    del dataset
    fedsgd_counts, fedsgd_sp_counts = phase_fedsgd(mods, qz)
    silo_counts = phase_cross_silo(mods, nz)
    # each kernel's launches on its own path: the lane-batched kernels on
    # the MESH rounds, the single-lane fused kernels on the cross-silo
    # silos, the single-lane quantize kernels on the FedSGD sp round
    counts = {**{k.name: fedavg_counts[k.name] for k in fb.LANE_KERNELS},
              **{k.name: silo_counts[k.name] for k in fb.KERNELS},
              **{k.name: fedsgd_counts[k.name] for k in qz.LANE_KERNELS},
              **{k.name: fedsgd_sp_counts[k.name] for k in qz.KERNELS},
              **{k.name: silo_counts[k.name] for k in nz.KERNELS}}

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": m.SOURCE, "replaces": k.replaces,
         "launches": counts[k.name], "max_abs_err": kernel_rows[k.name]["max_abs_err"],
         "ms": kernel_rows[k.name]["ms"], "plain_ms": kernel_rows[k.name]["plain_ms"],
         "bound_ms": kernel_rows[k.name]["bound_ms"], "bound_by": kernel_rows[k.name]["bound_by"],
         "library_ms": kernel_rows[k.name].get("library_ms"),
         **({"stream_ms": kernel_rows[k.name]["stream_ms"]}
            if "stream_ms" in kernel_rows[k.name] else {})}
        for m in (fb, qz, nz) for k in m.KERNELS + getattr(m, "LANE_KERNELS", ())]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
