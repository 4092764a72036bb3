"""Round times of two checkouts of the port on one card, in the
configurations of ``chip_smoke.py``'s phases 3 and 14.

    python3 fedml_tpu_torch/obs/round_ab.py --root PARENT --root CHANGE [--rounds 5]

Each checkout runs in a fresh process of its own, in the order A, B, B, A
(the first ``--root`` is A), with its working directory at the checkout,
so each imports and builds its own package.  A process runs two cells:

- ``mesh``: phase 3's path, the flagship recipe on MESH with fused blocks
  (50,000 synthetic images, 64 clients a round, bf16): a warm-up round,
  then ``--rounds`` rounds, each one ``run_rounds(1)`` timed on the host
  to its sync;
- ``silo``: phase 14's path without its chaos and journals, the flagship
  as a cross-silo job over loopback TCP (4 silos, 1,600 images, fused,
  qsgd8 uploads folded as they land, central DP, 64 KiB chunk frames, a
  test evaluation every round): ``--rounds`` + 1 rounds, the first left
  out, each its server's ``round_time_s``.

Both checkouts draw the same data, sampling and weights from the recipe's
seed, so the same rounds run in each.  Prints each process's round times,
then one JSON line: each cell's mean round time by checkout, over both of
its processes.  Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

FLAGSHIP = "examples/sp_fedavg_cifar10_resnet20/fedml_config.yaml"
SILOS = 4
SILO_TRAIN = 1600
DP = dict(enable_dp=True, dp_solution_type="cdp", mechanism_type="gaussian", epsilon=50.0,
          delta=1e-5, sensitivity=0.01, clipping_norm=1.0)


def _mesh(rounds: int) -> list:
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    cfg.extra["fused_blocks"] = True
    cfg.comm_round, cfg.frequency_of_the_test = rounds + 1, 0
    sim = FedMLRunner(cfg).runner
    sim.run_rounds(1)
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run_rounds(1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _silo(rounds: int) -> list:
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(argv=["--cf", FLAGSHIP])
    cfg.training_type, cfg.role, cfg.backend = "cross_silo", "server", "TCP"
    cfg.client_num_in_total = cfg.client_num_per_round = SILOS
    cfg.synthetic_train_size = SILO_TRAIN
    cfg.comm_round, cfg.frequency_of_the_test = rounds + 1, 1
    cfg.run_id = "round_ab"
    for k, v in DP.items():
        setattr(cfg, k, v)
    cfg.extra.update(fused_blocks=True, tcp_base_port=0, comm_chunk_bytes=65536,
                     comm_compression="qsgd8", streaming_aggregation=True)
    history = FedMLRunner(cfg).run()
    return [m["round_time_s"] for m in history[1:]]


def child(rounds: int) -> int:
    sys.path[0] = os.getcwd()  # this checkout's package, not the script's folder
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"mesh": _mesh(rounds), "silo": _silo(rounds)}
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout of the repository (give two: A, then B)")
    ap.add_argument("--rounds", type=int, default=5, help="timed rounds a cell")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.rounds)
    if len(args.root) != 2:
        ap.error("give --root twice: A, then B")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    roots = [os.path.abspath(r) for r in args.root]
    runs = {0: [], 1: []}
    for i in (0, 1, 1, 0):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "--root",
                               roots[i], "--rounds", str(args.rounds)],
                              cwd=roots[i], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"round_ab: the run of {roots[i]} exited {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[i].append(res)
        print(f"{'AB'[i]} ({roots[i]}): " + "; ".join(
            f"{cell} rounds " + ", ".join(f"{t:.4f}" for t in ts) + " s"
            for cell, ts in res.items()))
    summary = {cell: {"AB"[i]: statistics.mean(t for r in runs[i] for t in r[cell])
                      for i in (0, 1)} for cell in ("mesh", "silo")}
    print(json.dumps({"card": smi, "mean_round_s": summary,
                      "b_over_a": {c: v["B"] / v["A"] for c, v in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
