"""One party of a cross-silo run over TCP as a process of its own (the port
of ``fedml_tpu/cross_silo/soak_worker.py``)::

    python -m fedml_tpu_torch.cross_silo.soak_worker <cfg.json> <role> <rank> <workdir> [device]

``cfg.json`` holds ``Config`` fields (backend TCP, a nonzero
``extra.tcp_base_port``); ``role`` is ``server`` (rank 0) or ``client``.
The party is built and run the way a user starts one:
``fedml_tpu_torch.init`` and ``FedMLRunner(cfg, device=device)``, whose
cross-silo runner builds the server alone or the silo of ``rank`` alone.
``device`` is the card unless ``cpu`` is named (then one host thread).
The soak's supervisor SIGKILLs workers mid-run and starts the same command
again: recovery is the journals' work.  The wall-clock bound is
``$SOAK_WORKER_TIMEOUT_S`` (600 s).

What the worker leaves in ``workdir`` (each written to a temporary file
and renamed onto its name):

- ``boot_r<rank>_<pid>.json`` at a silo's start: ``{"rank", "pid",
  "restart", "resumed"}`` (``restart``: an earlier boot file of the rank
  exists; ``resumed``: the client journal gave a warm resume);
- ``server_summary.json`` when the server's run ends: its
  ``async_summary()``, ``completed`` and, under chaos, the wrapper's
  injections (its presence tells the supervisor the run completed);
- ``report_r<rank>_<pid>.json`` at every clean exit: the role, the device
  and its name, whether ``jax`` or ``fedml_tpu`` were ever imported, the
  uploads trained (a silo) or the arrivals by path and virtual rounds (the
  server), and this process's launch counts of the three kernel modules,
  so launches are summed over processes.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import tempfile


def _atomic_write_json(path: str, obj: dict) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp_")
    with os.fdopen(fd, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _report(workdir: str, rank: int, role: str, device, extra: dict) -> None:
    import torch

    from ..ops import fused_block, noise, quantize

    launches = {k: v for m in (fused_block, quantize, noise) for k, v in m.launch_counts().items()}
    _atomic_write_json(os.path.join(workdir, f"report_r{rank}_{os.getpid()}.json"), {
        "rank": rank, "pid": os.getpid(), "role": role, "device": str(device),
        "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "jax_loaded": "jax" in sys.modules,
        "fedml_tpu_loaded": any(m == "fedml_tpu" or m.startswith("fedml_tpu.")
                                for m in sys.modules),
        "launches": launches, **extra})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg_path, role, rank, workdir = argv[0], argv[1], int(argv[2]), argv[3]
    device_arg = argv[4] if len(argv) > 4 else None
    timeout_s = float(os.environ.get("SOAK_WORKER_TIMEOUT_S", "600"))
    import torch

    if device_arg == "cpu":
        torch.set_num_threads(1)
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.runner import FedMLRunner

    with open(cfg_path) as f:
        fields = json.load(f)
    cfg = fedml_tpu_torch.init(Config(**{**fields, "role": role, "rank": rank}))
    runner = FedMLRunner(cfg, device=device_arg)
    group = runner.runner
    group.timeout = timeout_s
    group.setup()
    if role == "server":
        from fedml_tpu_torch.comm.chaos import ChaosCommManager

        server = group.server
        try:
            runner.run()
            ok = True
        except TimeoutError:
            ok = False
        summary = {**server.async_summary(), "completed": ok}
        if isinstance(server.com_manager, ChaosCommManager):
            summary["chaos"] = {"injected": dict(server.com_manager.injected),
                                "silent_losses": int(server.com_manager.silent_losses())}
        _atomic_write_json(os.path.join(workdir, "server_summary.json"), summary)
        _report(workdir, rank, role, runner.device,
                {"arrivals_by_path": dict(server.arrivals_by_path),
                 "virtual_rounds": len(server.history)})
        return 0 if ok else 3
    client = group.clients[0]
    prior_boots = glob.glob(os.path.join(workdir, f"boot_r{rank}_*.json"))
    _atomic_write_json(os.path.join(workdir, f"boot_r{rank}_{os.getpid()}.json"),
                       {"rank": rank, "pid": os.getpid(), "restart": bool(prior_boots),
                        "resumed": bool(client.resumed_from_journal)})
    try:
        runner.run()
    except TimeoutError:
        return 3
    if runner.device.type == "cuda":
        torch.cuda.synchronize(runner.device)
    _report(workdir, rank, role, runner.device, {"rounds_trained": client.rounds_trained})
    return 0


if __name__ == "__main__":
    sys.exit(main())
