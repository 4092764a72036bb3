"""Port parity: the cross-silo roles as OS processes of their own
(``fedml_tpu_torch/cross_silo/__init__.py`` role dispatch,
``comm/tcp_backend.py`` fixed ports), against the port's in-process group
and the reference's group on the CPU.

The ``cross_silo_horizontal_lr`` recipe (cut to 3 rounds on 800 / 200
images) runs as one ``role: server`` process and four ``role: client``
processes over TCP, each started with ``sys.executable`` through
``fedml_tpu_torch.init(argv=["--cf", ..., "--role", ..., "--rank", ...])``
and ``FedMLRunner(cfg, device="cpu")``, silo 2 addressed as ``127.0.0.2``
(Linux routes all of 127/8 to the loopback; listeners bind ``0.0.0.0``).
The reference's initial weights and per-epoch permutations are handed to
every run (to the processes through a file, since a worker imports no
``jax``).  The recipe takes the buffer-all path, whose aggregate is in rank
order, so:

- the processes' final global is bitwise the port's in-process TCP group's
  (``tcp_base_port: 0``) on the same seed, weights and permutations, with
  the same history;
- and within ``RUN_TOL`` of the reference's group (local SGD is not
  bitwise between XLA and PyTorch: the LR's ~1e-7 differences, as in
  ``tests/test_torch_transport.py``).

Every child asserts it never imported ``jax`` or ``fedml_tpu``, has a
wall-clock bound, and all are killed at the end.  The refusals that stay
(a silo over the in-process fabric, under SecAgg too; the FHE silo's
journal; multi-process silos; ``tcp_base_port: 0`` across processes) raise.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from .test_torch_secagg import JaxPerms
from .test_torch_transport import _ref_run

torch.set_num_threads(1)

RUN_TOL = 2e-6
RECIPE = Path(__file__).resolve().parent.parent / "examples" / "cross_silo_horizontal_lr" / \
    "fedml_config.yaml"
CUT = dict(comm_round=3, synthetic_train_size=800, synthetic_test_size=200,
           frequency_of_the_test=1)
CHILD_TIMEOUT_S = 120.0

# A party of the run: init + FedMLRunner as a user starts one, the parity
# hooks from the hooks file, then the run; the server writes its history
# and final global.
CHILD = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import fedml_tpu_torch
from fedml_tpu_torch import weights
from fedml_tpu_torch.runner import FedMLRunner

recipe, role, rank, port, hooks_path, out_path, cut = sys.argv[1:8]
cfg = fedml_tpu_torch.init(argv=["--cf", recipe, "--role", role, "--rank", rank])
for k, v in json.loads(cut).items():
    setattr(cfg, k, v)
cfg.backend = "TCP"
cfg.extra.update(tcp_base_port=int(port), tcp_ip_config={"2": "127.0.0.2"})
runner = FedMLRunner(cfg, device="cpu")
hooks = np.load(hooks_path)
tree = {}
for key in hooks.files:
    if key.startswith("global/"):
        node = tree
        *path, leaf = key.split("/")[1:]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = hooks[key]
runner.runner.global_vars = weights.to_torch(weights.flax_to_torch(tree))
runner.runner.perms = lambda r, c, epochs, cap: torch.from_numpy(hooks[f"perm/{r}/{c}"])
hist = runner.run()
assert "jax" not in sys.modules
assert not any(m == "fedml_tpu" or m.startswith("fedml_tpu.") for m in sys.modules)
if role == "server":
    g = weights.torch_to_flax(weights.to_numpy(runner.runner.server.aggregator.global_vars))
    flat = {}
    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(g, "")
    np.savez(out_path, **flat)
    with open(out_path + ".json", "w") as f:
        json.dump(hist, f)
'''


def _port_cfg(**extra):
    import fedml_tpu_torch

    cfg = fedml_tpu_torch.init(argv=["--cf", str(RECIPE)])
    for k, v in CUT.items():
        setattr(cfg, k, v)
    cfg.extra.update(extra)
    return cfg


def _reference_run():
    """The reference's group of the cut recipe (INPROC, threads): its
    history, final and initial globals."""
    import fedml_tpu

    ref_cfg = fedml_tpu.init(argv=["--cf", str(RECIPE)])
    for k, v in CUT.items():
        setattr(ref_cfg, k, v)
    ref_cfg.run_id = "silo_process_ref"
    hist, glob, init, _srv = _ref_run(ref_cfg)
    return hist, glob, init


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _hooks_file(tmp_path, init, cfg):
    """The initial global and every client's per-epoch permutations of the
    cut recipe (the reference's), for the processes."""
    from fedml_tpu_torch.data import loader

    ds = loader.load(cfg)
    perms = JaxPerms(cfg.random_seed)
    arrays = {f"global/{k}": v for k, v in _flat(init).items()}
    for r in range(cfg.comm_round):
        for c in range(cfg.client_num_in_total):
            n = len(ds.client_idx[c])
            cap = -(-n // cfg.batch_size) * cfg.batch_size
            arrays[f"perm/{r}/{c}"] = perms(r, c, cfg.epochs, cap).numpy()
    path = tmp_path / "hooks.npz"
    np.savez(path, **arrays)
    return path, perms


def _start(role, rank, port, hooks, out, log_dir):
    from fedml_tpu_torch.cross_silo.async_soak import soak_worker_env

    with open(log_dir / f"{role}_{rank}.log", "wb") as log:
        return subprocess.Popen(
            [sys.executable, "-c", CHILD, str(RECIPE), role, str(rank), str(port), str(hooks),
             str(out), json.dumps(CUT)],
            stdout=log, stderr=subprocess.STDOUT, env=soak_worker_env(),
            cwd=str(Path(__file__).resolve().parent.parent))


def test_processes_match_the_inprocess_group_and_the_reference(tmp_path):
    import fedml_tpu_torch
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo.async_soak import _free_port_block, _tail
    from fedml_tpu_torch.runner import FedMLRunner

    ref_hist, ref_global, init = _reference_run()
    cfg = _port_cfg()
    hooks, perms = _hooks_file(tmp_path, init, cfg)

    # the port's in-process group over TCP (ephemeral ports), same hooks
    group_cfg = _port_cfg(tcp_base_port=0)
    group_cfg.backend = "TCP"
    group_cfg.run_id = "silo_process_group"
    runner = FedMLRunner(fedml_tpu_torch.init(group_cfg), device="cpu")
    runner.runner.global_vars = weights.to_torch(weights.flax_to_torch(init))
    runner.runner.perms = perms
    group_hist = runner.run()
    group_global = weights.torch_to_flax(
        weights.to_numpy(runner.runner.server.aggregator.global_vars))

    # the processes: four silos, then the server
    port = _free_port_block(cfg.client_num_in_total + 1)
    out = tmp_path / "server_out.npz"
    procs = [_start("client", r, port, hooks, out, tmp_path)
             for r in range(1, cfg.client_num_in_total + 1)]
    procs.append(_start("server", 0, port, hooks, out, tmp_path))
    try:
        for p in procs:
            rc = p.wait(timeout=CHILD_TIMEOUT_S)
            assert rc == 0, "\n".join(_tail(str(f)) for f in sorted(tmp_path.glob("*.log")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    got = dict(np.load(out))
    with open(str(out) + ".json") as f:
        proc_hist = json.load(f)

    want_group = _flat(group_global)
    assert sorted(got) == sorted(want_group)
    for k in got:
        assert np.array_equal(got[k], want_group[k]), k
    drop = ("round_time_s", "aggregate_time_s")
    assert [{k: v for k, v in h.items() if k not in drop} for h in proc_hist] == \
        [{k: v for k, v in h.items() if k not in drop} for h in group_hist]
    want_ref = _flat(ref_global)
    for k in got:
        np.testing.assert_allclose(got[k], want_ref[k], rtol=0, atol=RUN_TOL, err_msg=k)
    assert [h["round"] for h in proc_hist] == [h["round"] for h in ref_hist] == [0, 1, 2]
    np.testing.assert_allclose([h["test_acc"] for h in proc_hist],
                               [h["test_acc"] for h in ref_hist], atol=1e-6)


@pytest.mark.parametrize("case", ["client_secagg", "client_fhe", "multiprocess_silo",
                                  "port_zero_client", "client_inproc", "remote_in_process",
                                  "client_rank", "role", "async_secagg"])
def test_refusals_that_stay(case):
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = _port_cfg(tcp_base_port=31000)
    cfg.backend = "TCP"
    exc, match = NotImplementedError, "Queue 1 item 7"
    if case == "client_secagg":
        cfg.role, cfg.rank, cfg.enable_secagg = "client", 1, True
        cfg.backend = "INPROC"
    elif case == "client_fhe":
        # the FHE silo runs as a process of its own; its journal waits
        cfg.role, cfg.rank, cfg.enable_fhe = "client", 1, True
        cfg.extra["client_journal_dir"] = "/nonexistent/journal"
    elif case == "multiprocess_silo":
        cfg.role, cfg.rank = "client", 1
        cfg.extra["coordinator_address"] = "localhost:1234"
        match = "Queue 1 item 8"
    elif case == "port_zero_client":
        cfg.role, cfg.rank = "client", 1
        cfg.extra["tcp_base_port"] = 0
        exc, match = ValueError, "tcp_base_port"
    elif case == "client_inproc":
        cfg.role, cfg.rank, cfg.backend = "client", 1, "INPROC"
    elif case == "remote_in_process":
        cfg.extra.update(tcp_base_port=0, tcp_ip_config={"3": "10.1.2.3"})
        match = "role 'client'"
    elif case == "client_rank":
        cfg.role, cfg.rank = "client", 5
        exc, match = ValueError, "rank in 1..4"
    elif case == "role":
        cfg.role = "edge"
        exc, match = ValueError, "role"
    elif case == "async_secagg":
        cfg.backend, cfg.enable_secagg = "INPROC", True
        cfg.extra.update(async_aggregation=True, secagg_method="shamir")
        exc, match = ValueError, "async_aggregation"
    with pytest.raises(exc, match=match):
        FedMLRunner(cfg, device="cpu")


def test_lone_roles_build_one_endpoint_on_their_fixed_port():
    """A lone server and a silo build their one endpoint, listening on
    ``tcp_base_port + rank`` (the server's TCP transport, a silo's shard of
    the partition), and a peer named outside the loopback is accepted."""
    from fedml_tpu_torch.comm.tcp_backend import TCPCommManager
    from fedml_tpu_torch.cross_silo.async_soak import _free_port_block
    from fedml_tpu_torch.runner import FedMLRunner

    base = _free_port_block(5)
    built = []
    try:
        for role, rank in (("server", 0), ("client", 3)):
            cfg = _port_cfg(tcp_base_port=base, tcp_ip_config={"2": "127.0.0.2", "3": "10.0.0.3"})
            cfg.backend, cfg.role, cfg.rank = "TCP", role, rank
            group = FedMLRunner(cfg, device="cpu").runner
            group.setup()
            ep = group.server if role == "server" else group.clients[0]
            built.append(ep)
            assert isinstance(ep.com_manager, TCPCommManager)
            assert ep.com_manager.listen_port == base + rank
            if role == "client":
                assert group.server is None and ep.rank == 3
                assert ep.trainer.count == len(group.dataset.client_idx[2])
                assert ep.com_manager._address(2) == ("127.0.0.2", base + 2)
            else:
                assert group.clients == []
    finally:
        for ep in built:
            ep.finish()
