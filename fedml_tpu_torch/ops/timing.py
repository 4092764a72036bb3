"""Per-kernel time of the port's eager kernel launches.

The port of ``fedml_tpu/ops/pallas/timing.py``.  Every hand-written kernel
records its launches into the process-global ``fedml_pallas_kernel_seconds``
histogram, labeled by the reference's kernel names, so reports read both
packages alike: ``fused_bn_relu``, ``fused_bn_residual_relu``,
``fused_bn_relu_bwd``, ``fused_bn_residual_relu_bwd``,
``quantize_int8_stochastic``, ``dequantize_int8`` and
``apply_gaussian_noise``.  A lane-batched launch records under its kernel's
label.

How a launch is timed:

- On the card: each ``ops/*`` wrapper takes a pair of CUDA events from
  :func:`launch_begin` and passes them to its kernel's C entry point, which
  records the first on the launch's stream just before the launch and the
  second just after it (one ctypes call launches and times); the wrapper
  then hands the pair to :func:`launch_end`, and nothing on the launch path
  waits for the card.  A pair is resolved later: those already done every
  ``POLL_EVERY`` launches, and all of them in :func:`kernel_time_summary`
  and in the registry's ``render()`` / ``snapshot()`` (a collect hook),
  which wait for the card.  The events are ``libcuda``'s, created through
  ctypes (:func:`_cu`); resolved ones are reused.
- What the figure measures: the time between the two events completing on
  the stream, which is from dispatch to done less any wait behind queued
  work.  The first event completes when the stream reaches it: at once on
  an idle stream, so the figure then includes the launch's own submission
  (a few microseconds for a kernel of a few), and after the work queued
  before it otherwise, which the figure leaves out.
- Under CUDA-graph stream capture (``torch.cuda.is_current_stream_capturing``)
  nothing is observed: the port's form of the reference's "traced".
- On the CPU (:func:`observe_eager` around the plain version): host wall
  time with ``perf_counter``, as the reference times interpret mode.
- :func:`set_observing` switches the observation off (and on again): off,
  a launch takes no events and a plain version's call is not timed.

The reference observes eager calls only, blocking on each one's outputs
(its hot path runs inside ``jit``, where nothing is observed).  The port's
hot path is eager, so every launch outside capture is observed: more calls
than the reference counts, a decided difference (``ROADMAP.md`` Queue 3).

Sinks ``fn(kernel_name, seconds)`` (:func:`add_sink`) see each observation
when it is resolved.
"""

from __future__ import annotations

import ctypes
import threading
import time
from collections import deque

from ..obs import registry as obsreg

PALLAS_KERNEL_TIME = obsreg.REGISTRY.histogram(
    "fedml_pallas_kernel_seconds",
    "Wall time of eagerly-invoked Pallas kernels (dispatch to ready), "
    "labeled by kernel.",
    labels=("kernel",),
)

#: extra per-observation sinks ``fn(kernel_name, seconds)``
_sinks: list = []
# (label, start event, stop event) of launches not resolved yet, in launch
# order; guarded by _lock
_pending: deque = deque()
_lock = threading.Lock()
# resolved events (raw CUevent handles), reused: creating and destroying a
# CUDA event a launch costs more than the launch
_free_events: list = []
_LIBCUDA: list = []  # libcuda.so.1, loaded at first use
_NOT_READY = 600  # CUDA_ERROR_NOT_READY
# label -> observations timed on the host (observe_eager); guarded by _lock
_host_counts: dict = {}
#: launches between two polls of the pending pairs
POLL_EVERY = 64
#: the token of a launch that is not observed
UNOBSERVED = (None, None, None)
_observing = [True]


def set_observing(on: bool) -> bool:
    """Observe launches and plain-version calls (``on``, the default) or
    not; returns the previous setting."""
    prev = _observing[0]
    _observing[0] = bool(on)
    return prev


def add_sink(fn):
    _sinks.append(fn)
    return fn


def remove_sink(fn) -> None:
    try:
        _sinks.remove(fn)
    except ValueError:
        pass


def _record(name: str, seconds: float) -> None:
    PALLAS_KERNEL_TIME.observe(seconds, kernel=name)
    for sink in list(_sinks):
        try:
            sink(name, seconds)
        except Exception:
            pass  # telemetry must never take down the kernel path


def _cu():
    """``libcuda.so.1`` (the CUDA library every runtime in the process sits
    on) with the event calls declared."""
    if not _LIBCUDA:
        lib = ctypes.CDLL("libcuda.so.1")
        p, u = ctypes.c_void_p, ctypes.c_uint
        for fn, args in (("cuEventCreate", [ctypes.POINTER(p), u]),
                         ("cuEventSynchronize", [p]),
                         ("cuEventElapsedTime", [ctypes.POINTER(ctypes.c_float), p, p])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _LIBCUDA.append(lib)
    return _LIBCUDA[0]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"kernel timing: {what} failed with CUDA error {err} (libcuda)")


def _take_done(wait: bool) -> list:
    """Pop the pending pairs that have finished (all of them, waiting for
    the card, with ``wait``); returns ``[(label, seconds)]``."""
    cu = _cu()
    elapsed, ms = cu.cuEventElapsedTime, ctypes.c_float()
    done = []
    with _lock:
        while _pending:
            name, start, stop = _pending[0]
            if wait:
                _check(cu.cuEventSynchronize(stop), "cuEventSynchronize")
            err = elapsed(ctypes.byref(ms), start, stop)
            if err == _NOT_READY:  # the stop event has not completed
                break
            _check(err, "cuEventElapsedTime")
            _pending.popleft()
            done.append((name, ms.value / 1e3))
            _free_events.extend((start, stop))
    return done


def resolve_pending(wait: bool = True) -> int:
    """Record every pending launch that has finished (every one, waiting for
    the card, with ``wait``); returns how many were recorded.  Does nothing
    under stream capture, where waiting for an event is not allowed."""
    import torch

    if not _pending or torch.cuda.is_current_stream_capturing():
        return 0
    done = _take_done(wait)
    for name, seconds in done:
        _record(name, seconds)
    return len(done)


obsreg.REGISTRY.add_collect_hook(resolve_pending)


def _event(cu) -> int:
    try:
        return _free_events.pop()
    except IndexError:
        ev = ctypes.c_void_p()
        _check(cu.cuEventCreate(ctypes.byref(ev), 0), "cuEventCreate")  # timing on
        return ev.value


def launch_begin(name: str) -> tuple:
    """Before a kernel's launch on the card: the token ``(start, stop,
    name)``, whose two events the kernel's C entry point records around the
    launch; :data:`UNOBSERVED` (no events) under stream capture or with the
    observation off."""
    import torch

    if not _observing[0] or torch.cuda.is_current_stream_capturing():
        return UNOBSERVED
    cu = _cu()
    return _event(cu), _event(cu), name


def launch_end(token: tuple, err: int = 0) -> None:
    """After the launch (``err`` the entry point's return code): queue the
    pair (reuse it if the launch failed); every ``POLL_EVERY`` launches the
    pairs that have finished are recorded (no wait)."""
    start, stop, name = token
    if start is None:
        return
    with _lock:
        if err != 0:
            _free_events.extend((start, stop))
            return
        _pending.append((name, start, stop))
        poll = len(_pending) % POLL_EVERY == 0
    if poll:
        for done_name, seconds in _take_done(wait=False):
            _record(done_name, seconds)


def observe_eager(name: str, fn, *args):
    """Run ``fn(*args)`` (a plain version on the CPU), time it to completion
    with the host clock and record under ``name`` (while observing)."""
    if not _observing[0]:
        return fn(*args)
    t0 = time.perf_counter()
    out = fn(*args)
    _record(name, time.perf_counter() - t0)
    with _lock:
        _host_counts[name] = _host_counts.get(name, 0) + 1
    return out


def host_observation_counts() -> dict:
    """``{label: n}`` of the observations timed on the host (the plain
    versions' calls on the CPU): the family's count less these is the
    kernels' launches observed on the card."""
    with _lock:
        return dict(_host_counts)


def pending_count() -> int:
    with _lock:
        return len(_pending)


def kernel_time_summary() -> dict:
    """{kernel: {count, total_s, mean_s}} from the process-global histogram,
    every pending launch resolved first (waits for the card)."""
    resolve_pending()
    out = {}
    with PALLAS_KERNEL_TIME._lock:
        children = {k: dict(v) for k, v in PALLAS_KERNEL_TIME._children.items()}
    for key, child in sorted(children.items()):
        n = int(child["count"])
        total = float(child["sum"])
        out[key[0]] = {
            "count": n,
            "total_s": round(total, 6),
            "mean_s": round(total / n, 6) if n else 0.0,
        }
    return out

