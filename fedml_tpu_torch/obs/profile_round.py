#!/usr/bin/env python3
"""Where one simulation round of the PyTorch port spends its time.

Run from the repository root on a machine with an NVIDIA card:

    python3 -m fedml_tpu_torch.obs.profile_round [--fused 0|1] [--backend MESH|sp]
    python3 -m fedml_tpu_torch.obs.profile_round --cf RECIPE [--compression NAME]
    python3 -m fedml_tpu_torch.obs.profile_round --ab 4

Builds a recipe (default: the flagship, examples/sp_fedavg_cifar10_resnet20)
through ``fedml_tpu_torch.init`` + ``FedMLRunner``, runs one warm-up round,
times one round without the profiler, then profiles one round with
``torch.profiler`` (CPU + CUDA).  Prints the card, the round wall time, the
summed device time of all kernels, the device busy and idle shares (busy =
union of kernel intervals over the window), the kernel launches per batch
(a FedAvg local step, or one batch of a FedSGD full-shard gradient) as the
port counts them and as ``cudaLaunchKernel`` calls, and the top operators by
host (self CPU) time and by device time.  ``--fused``,
``--compression`` and ``--backend`` override the recipe's
``extra.fused_blocks``, ``compression`` and ``backend_sim`` (MESH, the
default: the round's clients as the lanes of batched steps; or ``sp``, one
client after another); without them the recipe runs unchanged.  On MESH it
also gives the batched steps of the round (the longest lane budget; FedSGD:
its batches) and the launches and device events a batched step.

``--ab PAIRS`` instead builds the recipe twice, with and without
``extra.fused_blocks`` (same seed, so the same data, sampling and initial
weights), warms both up, and times PAIRS rounds of each without the
profiler, alternating the order (fused first in even pairs): the fused vs
unfused A/B of round time on one card.

``--convs`` instead times the MESH round's convolutions alone, bf16, at
the flagship's 64 lanes of batch 128 and each conv shape of ResNet-20
(stride 1 at the three stages, the two stride-2 convs, the stem), forward
and forward + backward, with CUDA events: the lanes' one grouped conv as
``models/resnet.conv2d_lanes`` runs it (the layout copies included), the
grouped conv alone on operands already in its layout, and the 64 lanes one
after another through the single-lane ``conv2d_nhwc``.

``--silos`` instead builds the cross-silo path of ``chip_smoke.py`` phase 5
(the flagship recipe as 4 fused silos) and times the silos' local SGD of one
round, without the wire and SecAgg: the 4 trainers one after another on one
thread, then on 4 threads at once as the cross-silo run drives them (with
Python's default GIL switch interval of 5 ms, then 0.5 ms), then the
threaded round once more under the profiler (device busy and idle shares).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

FLAGSHIP = "examples/sp_fedavg_cifar10_resnet20/fedml_config.yaml"
TOP = 25  # rows of each operator table


def _busy_us(events) -> float:
    """Union of device kernel intervals (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _batches(sim, metrics) -> float:
    """Forward+backward batches of a round: local steps for the FedAvg
    family, ``capacity // batch`` per client for FedSGD's full gradient."""
    clients = sim.cfg.client_num_per_round
    if sim.algorithm.name == "FedSGD":
        return clients * (sim.capacity // sim.cfg.batch_size)
    return metrics["num_steps"] * clients


def _batched_steps(sim, round_idx: int) -> int:
    """Steps of a MESH round, each one batched forward and backward of the
    active lanes: the longest lane budget (FedSGD: a shard's batches)."""
    import numpy as np

    if sim.algorithm.name == "FedSGD":
        return sim.capacity // sim.cfg.batch_size
    counts = sim.counts[np.asarray(sim.sampler.sample(round_idx))]
    return int(min(sim.hp.local_steps, sim.hp.epochs * -(-int(counts.max()) // sim.cfg.batch_size)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cf", default=FLAGSHIP, help="recipe YAML")
    ap.add_argument("--fused", type=int, default=None, help="override extra.fused_blocks")
    ap.add_argument("--compression", default=None, help="override compression (FedSGD)")
    ap.add_argument("--backend", default=None, help="override backend_sim (MESH or sp)")
    ap.add_argument("--ab", type=int, default=0, help="pairs of fused/unfused rounds to time")
    ap.add_argument("--convs", action="store_true",
                    help="time the MESH round's grouped convs against the lanes one by one")
    ap.add_argument("--silos", action="store_true",
                    help="time the cross-silo silos' local SGD, one thread vs four")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    import fedml_tpu_torch
    from fedml_tpu_torch.ops import fused_block as fb
    from fedml_tpu_torch.ops import quantize as qz
    from fedml_tpu_torch.runner import FedMLRunner

    if not torch.cuda.is_available():
        print("profile_round: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    if args.ab:
        return _ab(args.ab)
    if args.silos:
        return _silos()
    if args.convs:
        return _convs()
    cfg = fedml_tpu_torch.init(argv=["--cf", args.cf])
    if args.fused is not None:
        cfg.extra["fused_blocks"] = bool(args.fused)
    if args.compression is not None:
        cfg.compression = args.compression
    if args.backend is not None:
        cfg.backend_sim = args.backend
    cfg.metrics_jsonl_path = ""
    sim = FedMLRunner(cfg).runner
    what = (f"{cfg.federated_optimizer} {sim.backend} fused={bool(sim.hp.fused_blocks)} "
            f"compression={getattr(sim.algorithm, 'compression', None)}")
    sim.run_round()  # warm-up: cuDNN autotuning, kernel build, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = sim.run_round()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_steps = _batches(sim, plain)
    print(f"{what} unprofiled round: {plain_s:.3f} s, {plain_steps:.0f} batches, "
          f"{plain_s / plain_steps * 1e3:.2f} ms/batch, "
          f"{plain_steps * cfg.batch_size / plain_s:.0f} samples/s")
    fb.reset_launch_counts()
    qz.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    profiled_round = sim.round_idx
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled = sim.run_round()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    steps = _batches(sim, profiled)
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    kernel_us = sum(e.time_range.end - e.time_range.start for e in events)
    busy_us = _busy_us(events)
    print(f"{what} profiled round wall {wall_s:.3f} s, batches {steps:.0f}, "
          f"{wall_s / steps * 1e3:.2f} ms/batch wall")
    print(f"device: {len(events)} kernel/memcpy events, summed {kernel_us / 1e6:.3f} s, busy "
          f"{busy_us / 1e6:.3f} s = {100 * busy_us / (wall_s * 1e6):.1f}% of wall, idle "
          f"{100 * (1 - busy_us / (wall_s * 1e6)):.1f}%; {len(events) / steps:.0f} device events/batch")
    print(f"kernel launches (profiled round): {fb.launch_counts()} {qz.launch_counts()}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    batched = _batched_steps(sim, profiled_round) if sim.backend != "sp" else None
    if batched:
        print(f"MESH: {batched} batched steps, {wall_s / batched * 1e3:.2f} ms a batched step "
              f"wall, {len(events) / batched:.0f} device events a batched step")
    ka = prof.key_averages()
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
        calls = sum(e.count for e in ka if e.key == name)
        print(f"{name}: {calls} calls, {calls / steps:.1f} a batch"
              + (f", {calls / batched:.1f} a batched step" if batched else ""))
    print("top operators by self CPU time:")
    print(ka.table(sort_by="self_cpu_time_total", row_limit=TOP, max_name_column_width=60))
    print("top operators by device time:")
    print(ka.table(sort_by="self_device_time_total", row_limit=TOP, max_name_column_width=60))
    return 0


def _ab(pairs: int) -> int:
    import statistics

    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    sims = {}
    for fused in (True, False):
        cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
        cfg.extra["fused_blocks"] = fused
        cfg.metrics_jsonl_path = ""
        sims[fused] = FedMLRunner(cfg).runner
        sims[fused].run_round()  # warm-up
    torch.cuda.synchronize()
    times = {True: [], False: []}
    for i in range(pairs):
        for fused in ((True, False) if i % 2 == 0 else (False, True)):
            sim = sims[fused]
            t0 = time.perf_counter()
            m = sim.run_round()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            steps = m["num_steps"] * sim.cfg.client_num_per_round
            times[fused].append((dt, steps))
            print(f"pair {i} fused={fused} round {sim.round_idx - 1}: {dt:.3f} s, {steps:.0f} steps, "
                  f"{dt / steps * 1e3:.2f} ms/step, train_loss {m['train_loss']:.4f}")
    for fused in (True, False):
        per_step = [dt / st * 1e3 for dt, st in times[fused]]
        print(f"fused={fused}: median {statistics.median(per_step):.2f} ms/step over {pairs} rounds "
              f"(min {min(per_step):.2f}, max {max(per_step):.2f})")
    return 0


def _convs(lanes: int = 64, batch: int = 128, reps: int = 10) -> int:
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.models import resnet

    dev, dtype = torch.device("cuda"), torch.bfloat16
    # (H = W, Cin, Cout, stride) of ResNet-20's convs
    shapes = [(32, 3, 16, 1), (32, 16, 16, 1), (32, 16, 32, 2), (16, 32, 32, 1),
              (16, 32, 64, 2), (8, 64, 64, 1)]

    def timed(fn):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for hw, cin, cout, stride in shapes:
        x = torch.randn((lanes, batch, hw, hw, cin), device=dev).to(dtype)
        k = torch.randn((lanes, cout, cin, 3, 3), device=dev) * 0.1
        xg = x.permute(1, 2, 3, 0, 4).reshape(batch, hw, hw, lanes * cin).permute(0, 3, 1, 2)
        wg = k.to(dtype).reshape(lanes * cout, cin, 3, 3).contiguous(
            memory_format=torch.channels_last)
        pad = 1 if stride == 1 else 0
        if stride == 2:
            xg = F.pad(xg, (0, 1, 0, 1))
        cases = {
            "lanes (conv2d_lanes)": (lambda x, k: resnet.conv2d_lanes(x, k, stride, dtype),
                                     (x, k)),
            "grouped conv alone": (lambda xg, wg: F.conv2d(xg, wg, stride=stride, padding=pad,
                                                           groups=lanes), (xg, wg)),
            "lanes one by one": (lambda x, k: [resnet.conv2d_nhwc(x[i], k[i], stride, dtype)
                                               for i in range(lanes)], (x, k)),
        }
        rows = {}
        for name, (fwd, operands) in cases.items():
            def forward(fwd=fwd, operands=operands):
                with torch.no_grad():
                    fwd(*operands)

            def forward_backward(fwd=fwd, operands=operands):
                leaves = [t.detach().requires_grad_(True) for t in operands]
                outs = fwd(*leaves)
                outs = outs if isinstance(outs, list) else [outs]
                torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])

            rows[name] = (timed(forward), timed(forward_backward))
        print(f"conv {lanes} lanes x ({batch}, {hw}, {hw}, {cin}) -> {cout}, stride {stride}: "
              + "; ".join(f"{n} forward {f:.3f} ms, forward + backward {fb:.3f} ms"
                          for n, (f, fb) in rows.items()))
    return 0


def _silos() -> int:
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    import fedml_tpu_torch
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    cfg.training_type, cfg.role, cfg.backend = "cross_silo", "server", "INPROC"
    cfg.client_num_in_total = cfg.client_num_per_round = 4
    cfg.extra["fused_blocks"] = True
    cfg.metrics_jsonl_path = ""
    group = FedMLRunner(cfg).runner
    group.setup()
    trainers = [c.trainer for c in group.clients]
    global_vars, seed = group.server.aggregator.global_vars, rng.root_key(cfg.random_seed)
    steps = sum(t.trained_samples for t in trainers) // cfg.batch_size

    def in_turn(r):
        for i, t in enumerate(trainers):
            t.train(global_vars, r, seed, i)

    def threaded(r):
        threads = [threading.Thread(target=t.train, args=(global_vars, r, seed, i))
                   for i, t in enumerate(trainers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def timed(fn, r):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(r)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    default = sys.getswitchinterval()
    print(f"silos: shards {[t.count for t in trainers]}, {steps} local steps a round, batch "
          f"{cfg.batch_size}, {cfg.compute_dtype}, fused; warm-up {timed(in_turn, 0):.3f} s")
    for r, (name, fn, interval) in enumerate((
            ("one thread, silos in turn", in_turn, default),
            ("four threads at once", threaded, default),
            ("four threads at once, switch interval 0.5 ms", threaded, 5e-4),
            ("one thread, silos in turn", in_turn, default)), start=1):
        sys.setswitchinterval(interval)
        dt = timed(fn, r)
        print(f"{name}: {dt:.3f} s, {dt / steps * 1e3:.2f} ms/step")
    sys.setswitchinterval(default)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = timed(threaded, 5)
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = _busy_us(events)
    print(f"four threads at once, profiled: wall {wall_s:.3f} s, device busy "
          f"{busy_us / 1e6:.3f} s = {100 * busy_us / (wall_s * 1e6):.1f}% of wall, idle "
          f"{100 * (1 - busy_us / (wall_s * 1e6)):.1f}%; {len(events) / steps:.0f} device "
          "events/step")
    print("top operators by self CPU time:")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=TOP,
                                    max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
