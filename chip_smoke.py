#!/usr/bin/env python3
"""Drive the PyTorch port (``fedml_tpu_torch``) on one NVIDIA card.

Run from the repository root:  ``python3 chip_smoke.py``

Phases (any failure exits non-zero; no phase is caught):
1. Print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from ``fedml_tpu_torch/csrc/`` with nvcc for sm_90a (one nvcc
   per source, all started together).
2. Hold each of the four fused BasicBlock kernels against its plain PyTorch
   version on the card at the three flagship shapes in f32 and bf16 (TF32
   off): forward f32 bitwise, dy / dr bitwise, d_scale / d_shift within
   ``1e-5 * sum|terms|`` per channel (f32 sums in another order), bf16
   within one bf16 ulp.  Hold the int8 quantize and dequantize kernels
   against theirs at the FedSGD gradient's length (269,722 elements, 264
   blocks) and at 2^24 elements: int8 values, scales and the dequantized
   vector bitwise.  Hold the central-DP noise kernel against its plain
   version at the SecAgg vector's length (271,098: ResNet-20's parameters
   and BN statistics) and at 2^24, bitwise, at the slice's DP sigma, at
   0.25 and at 0 (the identity).  Time each kernel and its plain version
   with CUDA events over CUDA-graph replays (device time; inputs rotated
   through more than the 50 MB L2) and as eager calls (host overhead
   included), next to its bound (bytes at 3.35 TB/s vs operations at 67
   TFLOP/s); for the noise kernel also the one PyTorch call that computes
   the same function, ``torch.add(x, noise, alpha=sigma)``.  Then a fused
   ResNet-20 step and one FedSGD client gradient on the card against the
   same on the CPU.
3. The FedAvg path: the flagship recipe
   ``examples/sp_fedavg_cifar10_resnet20/fedml_config.yaml`` through
   ``fedml_tpu_torch.init`` and ``FedMLRunner(cfg).run()`` with only
   ``comm_round``, ``frequency_of_the_test`` and ``extra.fused_blocks``
   overridden: 128 clients, 64 a round, batch 128, bf16, full-width
   ResNet-20 on the synthetic CIFAR-10 (50,000 / 10,000 images).  Every
   kernel's launch count is zeroed just before and read just after; each
   fused kernel must have launched and every loss must be finite.
4. The FedSGD path: ``examples/sp_fedsgd_eftopk_cifar10_resnet20`` the same
   way with only ``comm_round``, ``frequency_of_the_test`` and
   ``compression: qsgd_int8`` overridden: 16 clients, all 16 a round, one
   full-shard gradient each, batch 128, bf16, full-width ResNet-20.  The
   counts are zeroed before and read after: quantize and dequantize must
   launch once per client per round (48 each over 3 rounds), and every
   test metric and weight must be finite.  Then one round of the recipe's
   own ``eftopk``, after which every client's residual must be non-zero.
5. The cross-silo path: the flagship recipe through ``fedml_tpu_torch.init``
   and ``FedMLRunner(cfg).run()`` with ``training_type: cross_silo``,
   ``role: server``, ``backend: INPROC``, 4 silos all in every round, 3
   rounds, Shamir SecAgg with the streaming field fold
   (``extra.secagg_method: shamir``, ``extra.secagg_stream: true``),
   central DP (Gaussian, epsilon 50, delta 1e-5, sensitivity 0.01, clip 1.0)
   and ``extra.fused_blocks``: the server and 4 clients are threads of this
   process on the in-process fabric.  The counts are zeroed before and read
   after: the noise kernel must launch once per round, each fused kernel
   must launch, the fold must keep at most 2 updates, every test metric and
   weight must be finite, and round 0's noised global must be bitwise the
   plain version applied to its clipped global with the same draw (and
   differ from it).

The line before the last is the ``{"kernels": [...]}`` JSON (each kernel's
launches from its own path's run); the last line is ``{"ok": true,
"device": {...}}``.  ``--kernels-only`` stops after phase 2 and prints
neither.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

FLAGSHIP = "examples/sp_fedavg_cifar10_resnet20/fedml_config.yaml"
FEDSGD = "examples/sp_fedsgd_eftopk_cifar10_resnet20/fedml_config.yaml"
SHAPES = [(128, 32, 32, 16), (128, 16, 16, 32), (128, 8, 8, 64)]
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
    """name -> (kernel call, plain call, operand maker, bytes(n, C, item), flops(n))."""
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

    return {
        fb.FWD.name: (lambda y, s, b: fb.fused_block_forward(y, s, b),
                      lambda y, s, b: fb.fused_block_reference(y, s, b),
                      fwd_args, lambda n, c, it: 2 * n * it + 2 * c * 4, lambda n: 3 * n),
        fb.FWD_RES.name: (lambda y, s, b, r: fb.fused_block_forward(y, s, b, r),
                          lambda y, s, b, r: fb.fused_block_reference(y, s, b, r),
                          fwd_res_args, lambda n, c, it: 3 * n * it + 2 * c * 4, lambda n: 4 * n),
        fb.BWD.name: (lambda g, y, s, o: fb.fused_block_backward(g, y, s, o, False),
                      lambda g, y, s, o: fb.fused_block_bwd_reference(g, y, s, o, False),
                      bwd_args, lambda n, c, it: 4 * n * it + 3 * c * 4, lambda n: 6 * n),
        fb.BWD_RES.name: (lambda g, y, s, o: fb.fused_block_backward(g, y, s, o, True),
                          lambda g, y, s, o: fb.fused_block_bwd_reference(g, y, s, o, True),
                          bwd_res_args, lambda n, c, it: 5 * n * it + 3 * c * 4, lambda n: 6 * n),
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
            bound = 1e-5 * terms.reshape(-1, terms.shape[-1]).sum(0) + 1e-30
            if not bool(((a32 - b32).abs() <= bound).all()):
                raise AssertionError(f"{name} output {i} {dtype}: reduction beyond 1e-5*sum|terms|")
        elif dtype == torch.float32:
            if not torch.equal(a, b):
                raise AssertionError(f"{name} output {i} f32: not bitwise equal to the plain version")
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
    for shape in SHAPES:
        c = shape[-1]
        n = math.prod(shape)
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.tensor([], dtype=dtype).element_size()
            n_sets = max(2, int(3 * L2_BYTES // (5 * n * item)) + 1)
            base = [(_gen(shape, dtype, dev, 10 * k + 1), _gen(shape, dtype, dev, 10 * k + 2),
                     _gen(shape, dtype, dev, 10 * k + 3), _gen((c,), torch.float32, dev, 10 * k + 4),
                     _gen((c,), torch.float32, dev, 10 * k + 5)) for k in range(n_sets)]
            for name, (kern, plain, build_args, nbytes, nflops) in cases.items():
                arg_sets = [build_args(*b) for b in base]
                got, want = kern(*arg_sets[0]), plain(*arg_sets[0])
                torch.cuda.synchronize()
                err = _compare(name, got, want, arg_sets[0], dtype)
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
                ms, plain_ms = _device_ms(kern, arg_sets), _device_ms(plain, arg_sets)
                eager_ms = _eager_ms(kern, arg_sets)
                bytes_ms = nbytes(n, c, item) / HBM_BYTES_PER_S * 1e3
                ops_ms = nflops(n) / F32_FLOPS_PER_S * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                       "ms": ms, "plain_ms": plain_ms, "eager_ms": eager_ms, "bound_ms": bound_ms,
                       "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                       "max_abs_err": err}
                print(f"kernel {name} {row['dtype']} {tuple(shape)}: ok, device {ms * 1e3:.2f} us "
                      f"(plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us, "
                      f"{100 * bound_ms / ms:.1f}% of bound), eager call {eager_ms * 1e3:.2f} us, "
                      f"max_abs_err {err:.3g}")
                if shape == SHAPES[0] and dtype == torch.bfloat16:
                    results[name].update({k: row[k] for k in
                                          ("ms", "plain_ms", "bound_ms", "bound_by")})
    return results


def _quant_bytes(n):
    """Bytes each function must move: (quantize, dequantize)."""
    b = -(-n // 1024)
    return 4 * n + 4 * b * 1024 + b * 1024 + 4 * b, b * 1024 + 4 * b + 4 * n


def phase_quantize(qz):
    """The int8 quantize / dequantize kernels against their plain versions:
    values, scales and the dequantized vector bitwise."""
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
        got, want = qz.quantize_int8_stochastic(*sets[0]), qz.quantize_int8_reference(*sets[0])
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == want[2]):
            bad = int((got[0] != want[0]).sum())
            raise AssertionError(f"quantize kernel at n={n}: {bad} values / scales equal "
                                 f"{torch.equal(got[1], want[1])}: not bitwise the plain version")
        dq_sets = [qz.quantize_int8_stochastic(*a) for a in sets]
        deq, deq_plain = qz.dequantize_int8(*dq_sets[0]), qz.dequantize_int8_reference(*dq_sets[0])
        torch.cuda.synchronize()
        if not torch.equal(deq, deq_plain) or deq.shape != (n,):
            raise AssertionError(f"dequantize kernel at n={n}: not bitwise the plain version")
        cases = [(qz.QUANTIZE, qz.quantize_int8_stochastic, qz.quantize_int8_reference, sets,
                  q_bytes, 7 * shape[0] * 1024),
                 (qz.DEQUANTIZE, qz.dequantize_int8, qz.dequantize_int8_reference, dq_sets,
                  dq_bytes, n)]
        for kern, fn, plain, arg_sets, nbytes, nops in cases:
            ms, plain_ms = _device_ms(fn, arg_sets), _device_ms(plain, arg_sets)
            eager_ms = _eager_ms(fn, arg_sets)
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            print(f"kernel {kern.name} n={n} ({shape[0]} blocks): ok (bitwise), device "
                  f"{ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us, "
                  f"{100 * bound_ms / ms:.1f}% of bound), eager call {eager_ms * 1e3:.2f} us")
            if n == GRAD_LENGTH:
                results[kern.name].update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
    return results


def phase_noise(nz):
    """The central-DP noise kernel against its plain version: bitwise at the
    DP sigma, at 0.25 and at 0 (the identity)."""
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
        for s in (sigma, 0.25, 0.0):
            got, want = nz.apply_gaussian_noise(x, noise, s), nz.apply_gaussian_noise_reference(
                x, noise, s)
            torch.cuda.synchronize()
            if not torch.equal(got, want) or got.shape != (n,):
                bad = int((got != want).sum())
                raise AssertionError(f"noise kernel at n={n}, sigma={s}: {bad} elements not "
                                     "bitwise the plain version")
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
              f"{100 * bound_ms / ms:.1f}% of bound), eager call {eager_ms * 1e3:.2f} us")
        if n == SECAGG_LENGTH:
            results[nz.NOISE.name].update({
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "library_ms": library_ms,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
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


def phase_main_path(mods):
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    t0 = time.perf_counter()
    cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    cfg.comm_round = ROUNDS
    cfg.frequency_of_the_test = 1
    cfg.extra["fused_blocks"] = True
    runner = FedMLRunner(cfg)
    sim = runner.runner
    print(f"main path: set-up {time.perf_counter() - t0:.1f} s (data {sim.dataset.train_num}/"
          f"{sim.dataset.test_num}, {sim.dataset.n_clients} clients, capacity {sim.capacity}, "
          f"{cfg.client_num_per_round}/round, batch {cfg.batch_size}, {cfg.compute_dtype})")
    probe = _RoundProbe(sim.logger, lambda: _all_counts(mods))
    sim.logger = probe
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(mods)
    history = runner.run()
    torch.cuda.synchronize()
    counts = _all_counts(mods)
    prev = {k: 0 for k in counts}
    for metrics, cum, mem in probe.rows:
        samples = metrics["num_steps"] * cfg.client_num_per_round * cfg.batch_size
        delta = {k: cum[k] - prev[k] for k in cum}
        prev = cum
        print(f"round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"{samples / metrics['round_time_s']:.0f} trained samples/s, train_loss "
              f"{metrics['train_loss']:.4f}, test_acc {metrics.get('test_acc', float('nan')):.4f}, "
              f"max_memory_allocated {mem / 2**30:.2f} GiB, launches {delta}")
    if len(history) != ROUNDS:
        raise AssertionError(f"expected {ROUNDS} rounds, got {len(history)}")
    bad = [k.name for k in mods[0].KERNELS if counts[k.name] == 0]
    if bad:
        raise AssertionError(f"kernels never launched on the FedAvg path: {bad}")
    _check_finite(sim, history, ("train_loss", "test_loss", "test_acc"))
    return counts


def phase_fedsgd(mods, qz):
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    t0 = time.perf_counter()
    cfg = fedml_tpu_torch.init(argv=["--cf", FEDSGD])
    cfg.comm_round = ROUNDS
    cfg.frequency_of_the_test = 1
    cfg.compression = "qsgd_int8"
    runner = FedMLRunner(cfg)
    sim = runner.runner
    clients = cfg.client_num_per_round
    batches = clients * (sim.capacity // cfg.batch_size)
    print(f"fedsgd path: set-up {time.perf_counter() - t0:.1f} s (data {sim.dataset.train_num}/"
          f"{sim.dataset.test_num}, {sim.dataset.n_clients} clients, capacity {sim.capacity}, "
          f"{clients}/round, batch {cfg.batch_size}, {cfg.compute_dtype}, compression "
          f"{cfg.compression}, {batches} gradient batches a round)")
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
        for k in qz.KERNELS:
            if delta[k.name] != clients:
                raise AssertionError(f"{k.name}: {delta[k.name]} launches in round "
                                     f"{metrics['round']}, expected {clients}")
    if len(history) != ROUNDS:
        raise AssertionError(f"expected {ROUNDS} rounds, got {len(history)}")
    if any(counts[k.name] != ROUNDS * clients for k in qz.KERNELS):
        raise AssertionError(f"expected {ROUNDS * clients} launches of each quantize kernel, "
                             f"got {qz.launch_counts()}")
    _check_finite(sim, history, ("test_loss", "test_acc"))

    cfg = fedml_tpu_torch.init(argv=["--cf", FEDSGD])
    cfg.comm_round = 1
    cfg.frequency_of_the_test = 1
    runner = FedMLRunner(cfg)
    t0 = time.perf_counter()
    history = runner.run()
    torch.cuda.synchronize()
    sim = runner.runner
    _check_finite(sim, history, ("test_loss", "test_acc"))
    rows = sim.client_states.abs().sum(1)
    if not bool((rows > 0).all()) or not bool(torch.isfinite(sim.client_states).all()):
        raise AssertionError("eftopk: a client's residual is zero or not finite after its round")
    print(f"fedsgd eftopk (the recipe's own): 1 round in {time.perf_counter() - t0:.3f} s, "
          f"test_loss {history[-1]['test_loss']:.4f}, test_acc {history[-1]['test_acc']:.4f}, "
          f"residuals {tuple(sim.client_states.shape)} non-zero for all {rows.numel()} clients")
    return counts


class _SecAggProbe(_RoundProbe):
    """The round probe of the cross-silo server: also the round's payload
    counters and, at round 0, the clipped global before its noise and the
    noised global (flat, on the card)."""

    def __init__(self, inner, counts, aggregator):
        super().__init__(inner, counts)
        self.aggregator, self.payload, self.round0 = aggregator, [], None

    def log(self, metrics, step=None):
        from fedml_tpu_torch import weights
        from fedml_tpu_torch.comm import codecs

        self.payload.append(codecs.payload_counters().get("secagg_dense", {}).get("wire_bytes", 0))
        if self.round0 is None:
            self.round0 = (self.aggregator.dp_pre_noise.clone(),
                           weights.flatten_reference(self.aggregator.global_vars)[0].clone())
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
    probe = _SecAggProbe(server.logger, lambda: _all_counts(mods + (nz,)), agg)
    server.logger = probe
    torch.cuda.reset_peak_memory_stats()
    before = codecs.payload_counters().get("secagg_dense", {}).get("wire_bytes", 0)
    _reset_counts(mods + (nz,))
    history = runner.run()
    torch.cuda.synchronize()
    counts = _all_counts(mods + (nz,))
    prev, prev_bytes = {k: 0 for k in counts}, before
    samples = sum(c.trainer.trained_samples for c in clients)
    for (metrics, cum, mem), wire in zip(probe.rows, probe.payload):
        delta = {k: cum[k] - prev[k] for k in cum}
        prev = cum
        print(f"round {metrics['round']}: {metrics['round_time_s']:.3f} s, "
              f"{samples / metrics['round_time_s']:.0f} trained samples/s, test_loss "
              f"{metrics['test_loss']:.4f}, test_acc {metrics['test_acc']:.4f}, finalize "
              f"(unmask + clip + noise) {1e3 * metrics['finalize_time_s']:.1f} ms, uploads "
              f"{wire - prev_bytes} bytes (frames {metrics['upload_bytes']}), "
              f"max_memory_allocated {mem / 2**30:.2f} GiB, launches {delta}")
        prev_bytes = wire
        if delta[nz.NOISE.name] != 1:
            raise AssertionError(f"round {metrics['round']}: {delta[nz.NOISE.name]} noise "
                                 "launches, expected 1")
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
    kernel_rows = {**phase_kernels(fb), **phase_quantize(qz), **phase_noise(nz)}
    phase_model_check(fb)
    phase_fedsgd_check()
    if args.kernels_only:
        return 0
    fedavg_counts, fedsgd_counts = phase_main_path(mods), phase_fedsgd(mods, qz)
    silo_counts = phase_cross_silo(mods, nz)
    # each kernel's launches on its own path
    counts = {**{k.name: fedavg_counts[k.name] for k in fb.KERNELS},
              **{k.name: fedsgd_counts[k.name] for k in qz.KERNELS},
              **{k.name: silo_counts[k.name] for k in nz.KERNELS}}

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": m.SOURCE, "replaces": k.replaces,
         "launches": counts[k.name], "max_abs_err": kernel_rows[k.name]["max_abs_err"],
         "ms": kernel_rows[k.name]["ms"], "plain_ms": kernel_rows[k.name]["plain_ms"],
         "bound_ms": kernel_rows[k.name]["bound_ms"], "bound_by": kernel_rows[k.name]["bound_by"],
         "library_ms": kernel_rows[k.name].get("library_ms")}
        for m in (fb, qz, nz) for k in m.KERNELS]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
