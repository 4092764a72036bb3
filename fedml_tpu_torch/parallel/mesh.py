"""Meshes over ranks (the port of ``fedml_tpu/parallel/mesh.py``).

The reference lays its devices out as a ``jax.sharding.Mesh`` with named
axes and lets GSPMD place arrays on it.  The port has one card and several
processes, so a mesh here is host logic over **ranks**: an array of rank
ids with the reference's axis names, and each rank takes its own block of
a sharded array by its coordinates (:func:`shard_leading_axis`,
``parallel/sharding.py``).  The shapes, the axis arithmetic, the padding
and the refusals are the reference's, bitwise:

- the axis names ``clients``, ``data``, ``silo``, ``model``, ``seq``;
- :func:`make_mesh` (sizes with one ``-1``; "needs N devices" past the
  ranks there are), :func:`parse_mesh_shape`, :func:`mesh_from_config`
  (``cfg.mesh_shape``);
- :func:`round_up` and :func:`pad_leading_axis_np` (zero pad rows);
- :class:`SubmeshPlan`, :func:`carve_submeshes` and
  :func:`submesh_plan_from_config` (``extra.mt_submesh_shape`` /
  ``mt_submesh_jobs``, with the logged fall-back to None).

A mesh's "devices" default to the ranks of the process group
(``parallel/multihost.py``), ``range(1)`` in a run of one process.
"""

from __future__ import annotations

import logging
import warnings
from typing import Optional, Sequence

import numpy as np

AXIS_CLIENTS = "clients"
AXIS_DATA = "data"
AXIS_SILO = "silo"
AXIS_MODEL = "model"  # storage sharding of the LLM trainer (llm/train.py)
AXIS_SEQ = "seq"  # sequence parallelism (ring attention)


class Mesh:
    """Named axes over an array of ranks (``devices``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of rank {self.devices.ndim} with axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> dict:
        """``rank``'s coordinate on each axis."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh {self.devices.tolist()}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_ranks(self, axis: str, rank: int) -> list:
        """The ranks along ``axis`` through ``rank`` (its other coordinates
        held), in axis order."""
        c = self.coords(rank)
        idx = tuple(slice(None) if a == axis else c[a] for a in self.axis_names)
        return [int(r) for r in np.asarray(self.devices[idx]).ravel()]

    def ranks_except(self, axis: str, rank: int) -> list:
        """The ranks that share ``rank``'s coordinate on ``axis`` (every other
        axis free), in rank order."""
        c = self.coords(rank)[axis]
        i = self.axis_names.index(axis)
        return sorted(int(r) for r in np.take(self.devices, c, axis=i).ravel())

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _ranks(devices) -> list:
    if devices is not None:
        return list(devices)
    from .multihost import process_count

    return list(range(process_count()))


def make_mesh(axis_names: Sequence[str] = (AXIS_CLIENTS,),
              axis_sizes: Optional[Sequence[int]] = None,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over ``devices`` (the process group's ranks by default).  With
    ``axis_sizes`` None the first axis takes them all; a ``-1`` size takes
    the rest (as a reshape)."""
    devs = _ranks(devices)
    n = len(devs)
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    sizes = list(axis_sizes)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {dict(zip(axis_names, sizes))} needs {total} devices, have {n}")
    return Mesh(np.array(devs[:total]).reshape(sizes), tuple(axis_names))


def parse_mesh_shape(spec: str) -> tuple[list[str], list[int]]:
    """Parse ``"clients:8"`` / ``"silo:2,data:4"`` from ``Config.mesh_shape``."""
    names, sizes = [], []
    for part in spec.split(","):
        name, _, size = part.strip().partition(":")
        names.append(name)
        sizes.append(int(size) if size else -1)
    return names, sizes


def mesh_from_config(cfg, devices=None) -> Mesh:
    if getattr(cfg, "mesh_shape", ""):
        names, sizes = parse_mesh_shape(cfg.mesh_shape)
        return make_mesh(names, sizes, devices)
    return make_mesh((AXIS_CLIENTS,), None, devices)


class SubmeshPlan:
    """A partition of the ranks into disjoint meshes of one shape, a job a
    lease (the reference's class)."""

    def __init__(self, submeshes: Sequence[Mesh], axis_names: Sequence[str],
                 axis_sizes: Sequence[int]):
        if not submeshes:
            raise ValueError("SubmeshPlan needs at least one submesh")
        self.submeshes = list(submeshes)
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)

    def __len__(self) -> int:
        return len(self.submeshes)

    def lease(self, index: int) -> Mesh:
        return self.submeshes[index % len(self.submeshes)]

    def describe(self) -> dict:
        return {
            "jobs": len(self.submeshes),
            "shape": dict(zip(self.axis_names, self.axis_sizes)),
            "devices_per_job": int(np.prod(self.axis_sizes)),
        }


def carve_submeshes(axis_names: Sequence[str], axis_sizes: Sequence[int], n_jobs: int,
                    devices: Optional[Sequence[int]] = None) -> SubmeshPlan:
    """``n_jobs`` disjoint contiguous meshes of shape ``axis_names x
    axis_sizes`` cut from the ranks; ``ValueError`` when they do not tile."""
    devs = _ranks(devices)
    sizes = [int(s) for s in axis_sizes]
    if any(s <= 0 for s in sizes):
        raise ValueError(
            f"submesh shape {dict(zip(axis_names, sizes))} must be concrete "
            "(no -1 / zero axes) to tile the fleet")
    per = int(np.prod(sizes))
    n_jobs = int(n_jobs)
    if n_jobs < 1:
        raise ValueError(f"n_jobs must be >= 1, got {n_jobs}")
    if per * n_jobs > len(devs):
        raise ValueError(
            f"{n_jobs} submeshes of {per} devices need {per * n_jobs}, "
            f"fleet has {len(devs)}")
    subs = [Mesh(np.array(devs[i * per:(i + 1) * per]).reshape(sizes), tuple(axis_names))
            for i in range(n_jobs)]
    return SubmeshPlan(subs, axis_names, sizes)


def submesh_plan_from_config(cfg, devices=None) -> Optional[SubmeshPlan]:
    """The plan of ``extra.mt_submesh_shape`` / ``mt_submesh_jobs``, or None
    (logged) when unset or when the shapes do not tile the ranks."""
    from ..core.flags import cfg_extra

    spec = cfg_extra(cfg, "mt_submesh_shape")
    if not spec:
        return None
    names, sizes = parse_mesh_shape(spec)
    devs = _ranks(devices)
    n_jobs = cfg_extra(cfg, "mt_submesh_jobs")
    try:
        if n_jobs is None:
            per = int(np.prod([s for s in sizes if s > 0]))
            if any(s <= 0 for s in sizes) or per <= 0:
                raise ValueError(
                    f"submesh shape {spec!r} must be concrete to derive "
                    "mt_submesh_jobs")
            n_jobs = len(devs) // per
        return carve_submeshes(names, sizes, n_jobs, devs)
    except ValueError as e:
        logging.getLogger("fedml_tpu_torch.parallel.mesh").warning(
            "mt_submesh_shape=%r rejected (%s); falling back to the "
            "time-sliced round gate", spec, e)
        return None


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= ``n``."""
    return -(-n // multiple) * multiple


def _tree_map_np(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map_np(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_np(fn, v) for v in tree)
    return fn(tree)


def pad_leading_axis_np(tree, n_target: int):
    """Zero-pad every leaf's leading axis to ``n_target`` rows (host
    numpy); a leaf already that long or longer stays as it is."""

    def pad(a):
        a = np.asarray(a)
        if n_target <= a.shape[0]:
            return a
        extra = np.zeros((n_target - a.shape[0],) + a.shape[1:], a.dtype)
        return np.concatenate([a, extra])

    return _tree_map_np(pad, tree)


_undivisible_warned: set = set()


def shard_leading_axis(tree, mesh: Mesh, axis: str = AXIS_CLIENTS, warn: bool = True,
                       rank: Optional[int] = None):
    """This rank's contiguous rows of every leaf (numpy or torch) whose
    leading dim divides over ``axis``; a leaf whose leading dim does not is
    kept whole (replicated), with the reference's warning once per ``(dim,
    size)``.  A mesh without a ``clients`` axis shards the default axis over
    its first (warned); any other absent axis raises ``KeyError``."""
    if axis not in mesh.shape:
        if axis != AXIS_CLIENTS:
            raise KeyError(
                f"mesh has no axis {axis!r} (axes: {mesh.axis_names}); "
                "pass one of the mesh's axes"
            )
        warnings.warn(
            f"shard_leading_axis: mesh has no {AXIS_CLIENTS!r} axis; "
            f"sharding the stacked-client dim over {mesh.axis_names[0]!r} "
            f"(the outer axis of {dict(mesh.shape)})",
            stacklevel=3,
        )
        axis = mesh.axis_names[0]
    size = mesh.shape[axis]
    if rank is None:
        from .multihost import process_index

        rank = process_index()
    at = mesh.coords(rank)[axis]

    def put(x):
        ndim = len(getattr(x, "shape", ()))
        if ndim >= 1 and x.shape[0] % size == 0:
            per = x.shape[0] // size
            return x[at * per:(at + 1) * per]
        if warn and ndim >= 1 and x.shape[0] > 1 and size > 1:
            key = (int(x.shape[0]), int(size))
            if key not in _undivisible_warned:
                _undivisible_warned.add(key)
                warnings.warn(
                    f"shard_leading_axis: leading dim {x.shape[0]} is not "
                    f"divisible by mesh axis {axis!r} size {size}; "
                    "REPLICATING instead — all parallelism over this axis "
                    "is lost for these arrays. Pad the client stack to a "
                    f"multiple of {size} (e.g. round client_num_per_round "
                    "up) to regain it.",
                    stacklevel=3,
                )
        return x

    return _tree_map_np(put, tree)
