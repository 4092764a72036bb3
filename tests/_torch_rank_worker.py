"""Ranks of the port's gloo process group for the CPU parity tests.

The tests spawn each rank with ``torch.multiprocessing``'s ``spawn`` method
(:func:`spawn_ranks`), a fresh interpreter that imports only the port (no
JAX): the payload (configs as field dicts, the reference's initial weights,
sampled ids and permutation tables, inputs) goes through a pickle file,
and each rank writes its results to ``result_<rank>.pkl``.  Every rank has
one torch thread, a free coordinator port and a wall-clock limit; a rank
that fails or outlives it fails the test.
"""

import os
import pickle
import socket
import time
import traceback

import numpy as np


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class TableSampler:
    """A port sampler hook from tables: the sampled ids of each round and
    each ``(round, client)``'s permutation table."""

    def __init__(self, sampled: dict, perms: dict):
        self.sampled, self.perm_tables = sampled, perms

    def sample(self, r):
        return np.asarray(self.sampled[r])

    def perms(self, r, client, epochs, cap):
        import torch

        return torch.from_numpy(np.asarray(self.perm_tables[(r, int(client))]))


class TablePerms:
    """A silo trainer's ``perms`` hook from ``{(round, client): table}``."""

    def __init__(self, perms: dict):
        self.tables = perms

    def __call__(self, r, client, epochs, cap):
        import torch

        return torch.from_numpy(np.asarray(self.tables[(r, int(client))]))


def _dist_cfg(fields: dict, rank: int, world: int, port: int):
    from fedml_tpu_torch.arguments import Config

    extra = dict(fields.get("extra") or {})
    extra.update(coordinator_address=f"localhost:{port}", num_processes=world, process_id=rank)
    return Config(**{**fields, "extra": extra})


def _job_engine(rank, world, port, payload):
    """``MeshSimulator`` under MULTIPROCESS from the reference's weights and
    draws; the global (flax layout) and the history; then, on rank 0 alone,
    the same on MESH, the group still up (``one_process``)."""
    import dataclasses

    import fedml_tpu_torch
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub
    from fedml_tpu_torch.sim.engine import MeshSimulator

    cfg = fedml_tpu_torch.init(_dist_cfg(payload["cfg"], rank, world, port))
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    out = {}
    runs = [("global", cfg)] + ([("one_process", dataclasses.replace(cfg, backend_sim="MESH"))]
                                if rank == 0 else [])
    for key, c in runs:
        sim = MeshSimulator(c, ds, model, device="cpu", sampler=payload["sampler"])
        sim.global_vars = weights.to_torch(weights.flax_to_torch(payload["init"]))
        sim.server_state = sim.algorithm.init_server_state(sim.global_vars)
        history = sim.run()
        out[key] = weights.torch_to_flax(weights.to_numpy(sim.global_vars))
        out.setdefault("history", history)
    return out


def _job_silo(rank, world, port, payload):
    """A silo spanning the ranks (``role: client``, rank 1) against the
    test's server over TCP; rank 0 reports its rounds, the follower its."""
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(_dist_cfg(payload["cfg"], rank, world, port))
    runner = FedMLRunner(cfg, device="cpu")
    group = runner.runner
    group.perms = payload["perms"]
    group.timeout = payload.get("timeout", 50.0)
    runner.run()
    return {"follower": group.follower,
            "rounds": None if group.follower else group.clients[0].rounds_trained}


def _job_ring(rank, world, port, payload):
    """Ring attention over every rank: this rank's block of the output and
    of the gradients of ``sum(out * g)``, for each case."""
    import torch

    from fedml_tpu_torch.ops.ring_attention import Ring, ring_attention
    from fedml_tpu_torch.parallel import multihost

    multihost.ensure_initialized(_dist_cfg({}, rank, world, port))
    ring = Ring(range(world), rank)
    out = {}
    for name, case in payload["cases"].items():
        s = case["q"].shape[1] // world
        blk = slice(rank * s, (rank + 1) * s)
        q, k, v = (torch.from_numpy(case[n][:, blk]).requires_grad_(True) for n in "qkv")
        o = ring_attention(q, k, v, ring, causal=case["causal"])
        o.backward(torch.from_numpy(case["g"][:, blk]))
        out[name] = {"out": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                     "dv": v.grad.numpy()}
    return out


def _job_llm(rank, world, port, payload):
    """``LLMTrainer`` over a mesh of the ranks: each step's loss, then the
    whole parameters (and, with ``grads``, one step's logits and gradient
    without an update)."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.llm.train import LLMTrainArgs, LLMTrainer
    from fedml_tpu_torch.parallel import mesh as meshlib
    from fedml_tpu_torch.parallel import multihost

    multihost.ensure_initialized(_dist_cfg({}, rank, world, port))
    names, sizes = payload["mesh"]
    trainer = LLMTrainer(payload["tcfg"], LLMTrainArgs(**payload["args"]),
                         mesh=meshlib.make_mesh(names, sizes), seq_axis=payload.get("seq_axis"),
                         device="cpu", params=payload["params"])
    out = {}
    if payload.get("grads"):
        loss, grads, logits = trainer.forward_backward(*payload["batches"][0])
        out["grad_loss"] = float(loss)
        out["logits"] = logits.numpy()
        out["grads"] = [g.numpy() for g in grads]
    out["losses"] = [trainer.step(t, y)["loss"] for t, y in payload["batches"]]
    out["params"] = pt.tree_map(lambda t: t.numpy(), trainer.whole_params())
    out["local_numel"] = sum(t.numel() for t in pt.tree_leaves(trainer.params))
    out["moment_numel"] = sum(t.numel() for t in pt.tree_leaves(trainer.opt_state["mu"]))
    return out


def _job_engine_refusals(rank, world, port, payload):
    """What the multi-process round refuses, and a second ``init``'s no-op."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub
    from fedml_tpu_torch.parallel import multihost
    from fedml_tpu_torch.sim.engine import MeshSimulator

    cfg = fedml_tpu_torch.init(_dist_cfg(payload["cfg"], rank, world, port))
    out = {"second_init": multihost.ensure_initialized(cfg) is multihost.is_multiprocess()
           and multihost.is_initialized()}
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    for key, value in (("population_store", {"population_store": payload["tmp"]}),
                       ("checkpoint_dir", None)):
        fields = dict(payload["cfg"])
        if value is None:
            fields["checkpoint_dir"] = payload["tmp"]
        else:
            fields["extra"] = {**(fields.get("extra") or {}), **value}
        try:
            MeshSimulator(Config(**fields), ds, model, device="cpu")
        except NotImplementedError as e:
            out[key] = "population mode" if "population" in str(e) else (
                "every rank would write" if "every rank would write" in str(e) else str(e))
    return out


JOBS = {"engine": _job_engine, "engine_refusals": _job_engine_refusals, "silo": _job_silo,
        "ring": _job_ring, "llm": _job_llm}


def _rank_main(rank, job, world, port, workdir):
    import torch

    torch.set_num_threads(1)
    from fedml_tpu_torch.parallel import multihost

    with open(os.path.join(workdir, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    try:
        result = {"ok": True, "value": JOBS[job](rank, world, port, payload)}
    except BaseException:
        result = {"ok": False, "error": traceback.format_exc()}
    finally:
        multihost.shutdown()
    with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(job: str, world: int, workdir, payload: dict, timeout: float = 60.0,
                port=None) -> list:
    """Run ``job`` in ``world`` spawned ranks; each rank's result, in rank
    order.  Fails when a rank raises, exits badly or outlives ``timeout``."""
    import torch.multiprocessing as mp

    workdir = str(workdir)
    with open(os.path.join(workdir, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    port = port or free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, job, world, port, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(5.0)
    assert not alive, f"{len(alive)} of {world} ranks outlived {timeout} s"
    results = []
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"result_{r}.pkl"), "rb") as f:
            res = pickle.load(f)
        assert res["ok"], f"rank {r}:\n{res['error']}"
        assert p.exitcode == 0, f"rank {r} exited {p.exitcode}"
        results.append(res["value"])
    return results
