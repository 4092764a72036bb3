"""Multi-process execution: the MULTIPROCESS / MPI backend (the port of
``fedml_tpu/parallel/multihost.py``).

The reference runs the same program on every process over
``jax.distributed``; its global mesh spans the processes' devices and GSPMD
inserts the collectives.  Here every process is a rank of one
``torch.distributed`` process group on **gloo**, and the collectives are
explicit.  One card holds every rank (NCCL refuses two ranks on one
device), so each collective goes over host copies: ``.cpu()``, the gloo
collective, then back to the tensor's device.  Gloo has no reduce-scatter:
a sum that a rank needs only a slice of is an all-reduce, then a slice.

Configuration, as the reference reads it (its L68-79): ``extra.
coordinator_address`` (``host:port``), ``extra.num_processes`` and
``extra.process_id``, or the environment's ``JAX_COORDINATOR_ADDRESS`` /
``COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``.
Rank 0 hosts the rendezvous (a ``TCPStore`` at the coordinator's address);
every other rank only connects to it, so no rank but 0 starts one.  Every
rank's group has a timeout of its own (``timeout_s``): a collective that a
peer never joins fails with an error instead of hanging the run.  A second
:func:`ensure_initialized` is a no-op.

How to run two ranks on the CPU: start the same script twice with
``process_id`` 0 and 1, ``num_processes`` 2 and one free
``coordinator_address`` (``tests/test_torch_multiprocess.py`` spawns them
with ``torch.multiprocessing``'s ``spawn`` method).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch

from ..core.flags import cfg_extra

log = logging.getLogger("fedml_tpu_torch.parallel.multihost")

#: a rank's bound on the rendezvous and on every collective
DEFAULT_TIMEOUT_S = 300.0

#: the reference's refusal of an explicit multi-process backend without a
#: coordinator (``fedml_tpu/__init__.py:52-58``), word for word
MULTIPROCESS_REFUSAL = (
    "backend_sim=MULTIPROCESS requires coordinator config: set "
    "cfg.extra coordinator_address/num_processes/process_id or "
    "the JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID "
    "environment variables on every host")


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def coordinator(cfg=None) -> Optional[str]:
    """The coordinator's ``host:port`` from ``cfg`` or the environment, or
    None."""
    return (cfg_extra(cfg, "coordinator_address") or os.environ.get("JAX_COORDINATOR_ADDRESS")
            or os.environ.get("COORDINATOR_ADDRESS"))


def configured_processes(cfg=None) -> tuple[int, int]:
    """``(num_processes, process_id)`` from ``cfg`` or the environment;
    ``ValueError`` when either is missing (``torch.distributed`` does not
    discover them, as ``jax.distributed`` may)."""
    nproc = int(cfg_extra(cfg, "num_processes") or os.environ.get("JAX_NUM_PROCESSES") or 0)
    # extra.process_id first: ``Config`` has a ``process_id`` field (0 by
    # default) that ``cfg_extra`` would read in its place, so every process
    # would be process 0 and start the rendezvous (the reference's two-process
    # hang, ROADMAP Queue 3); then the environment, then the field
    pid = (getattr(cfg, "extra", None) or {}).get("process_id")
    if pid is None:
        pid = os.environ.get("JAX_PROCESS_ID")
    if pid is None and cfg is not None:
        pid = getattr(cfg, "process_id", None)
    if nproc < 1 or pid is None:
        raise ValueError(f"coordinator {coordinator(cfg)!r} needs num_processes and process_id "
                         f"(got {nproc or None} and {pid})")
    return nproc, int(pid)


def ensure_initialized(cfg=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Bring up the gloo process group from ``cfg`` / the environment if a
    coordinator is named and no group is up yet.  Returns True when it
    brought the group up, else whether the run is multi-process (the
    reference's return); a no-op on a second call and without a
    coordinator."""
    if is_initialized():
        return is_multiprocess()
    coord = coordinator(cfg)
    if not coord:
        return False
    nproc, pid = configured_processes(cfg)
    host, _, port = coord.rpartition(":")
    dist = _dist()
    timeout = datetime.timedelta(seconds=float(timeout_s))
    store = dist.TCPStore(host or "localhost", int(port), nproc, is_master=pid == 0,
                          timeout=timeout)
    dist.init_process_group("gloo", store=store, world_size=nproc, rank=pid, timeout=timeout)
    log.info("torch.distributed up: process %d/%d over gloo at %s", pid, nproc, coord)
    return True


def shutdown() -> None:
    """Tear the process group down (a rank's last call)."""
    if is_initialized():
        _dist().destroy_process_group()


def new_group(ranks):
    """A gloo subgroup over ``ranks`` (every rank of the world must make
    every subgroup, in the same order); the world's group when ``ranks`` is
    all of it."""
    ranks = [int(r) for r in ranks]
    if ranks == list(range(process_count())):
        return None
    return _dist().new_group(ranks, backend="gloo")


def _host_buffer(like: torch.Tensor) -> torch.Tensor:
    """An empty host tensor of ``like``'s shape and dtype: page-locked when
    ``like`` is on a card (copies to and from it run at the link's rate, and
    the caching host allocator reuses it)."""
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=like.device.type == "cuda")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` of its own (the collectives write into it)."""
    return _host_buffer(t).copy_(t.detach())


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (the world when None), on
    ``t``'s device; ``t`` itself is left as it was."""
    if not is_multiprocess():
        return t
    h = _host(t)
    _dist().all_reduce(h, group=group)
    return h.to(t.device)


def all_gather(t: torch.Tensor, group=None) -> list:
    """Every rank's ``t`` (the same shape on each), in rank order, on
    ``t``'s device."""
    if not is_multiprocess():
        return [t]
    dist = _dist()
    h = _host(t)
    out = [_host_buffer(h if t.device.type == "cpu" else t)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, h, group=group)
    return [o.to(t.device) for o in out]


def broadcast_one_to_all(tree, group=None):
    """Rank 0's value of ``tree`` (numpy arrays, numbers, nested
    containers) on every rank; the value given on the others is ignored."""
    if not is_multiprocess():
        return tree
    box = [tree if process_index() == 0 else None]
    _dist().broadcast_object_list(box, src=0, group=group)
    return box[0]


def sync_global_devices(tag: str = "fedml_tpu_torch") -> None:
    """A barrier of every rank (``tag`` names it in the log)."""
    if is_multiprocess():
        log.debug("barrier %s", tag)
        _dist().barrier()


def send_recv(t: torch.Tensor, dst: int, src: int, group=None) -> torch.Tensor:
    """Send ``t`` to rank ``dst`` and receive the same shape from ``src``,
    both at once (a ring's step); the received tensor on ``t``'s device.
    Ranks are global."""
    dist = _dist()
    h = _host(t)
    got = _host_buffer(t)
    reqs = [dist.isend(h, dst, group=group), dist.irecv(got, src, group=group)]
    for r in reqs:
        r.wait()
    return got.to(t.device)


class AllReduceSum(torch.autograd.Function):
    """``all_reduce_sum`` that autograd goes through: the gradient of each
    rank's input is the sum over the ranks of the gradients of the output,
    since every rank's output is the same sum of every rank's input."""

    @staticmethod
    def forward(ctx, x, group=None):
        ctx.group = group
        out = all_reduce_sum(x, group)
        return out.clone() if out is x else out

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


def contiguous_block(n: int, parts: int, index: int) -> tuple[int, int]:
    """``[start, stop)`` of block ``index`` when ``n`` items are cut into
    ``parts`` contiguous blocks, the first ``n % parts`` one longer
    (``np.array_split``'s rule)."""
    base, extra = divmod(int(n), int(parts))
    start = index * base + min(index, extra)
    return start, start + base + (1 if index < extra else 0)


def gather_rows(t: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """Every rank's rows of ``t`` concatenated in rank order, where rank
    ``i`` holds block ``i`` of ``n`` rows (:func:`contiguous_block`): the
    blocks are padded to the longest for the collective and cut after."""
    if not is_multiprocess():
        return t
    world = process_count()
    longest = max(b - a for a, b in (contiguous_block(n, world, i) for i in range(world)))
    pad = longest - t.shape[0]
    padded = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))]) if pad else t
    blocks = all_gather(padded, group)
    return torch.cat([blk[:b - a] for blk, (a, b) in
                      zip(blocks, (contiguous_block(n, world, i) for i in range(world)))])


def tree_gather_rows(tree, n: int):
    """:func:`gather_rows` over every leaf of a tree of row-stacked tensors
    (None stays None)."""
    from ..core import pytree as pt

    if tree is None:
        return None
    return pt.tree_map(lambda t: gather_rows(t, n), tree)

