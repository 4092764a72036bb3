"""Per-program device-time attribution over a window of rounds.

The port of ``fedml_tpu/obs/profiler.py``.  A :class:`ProgramTimeAttributor`
opens a ``torch.profiler`` window (CPU and CUDA activities) around rounds
``k..k+n`` (behind ``extra.profile_rounds`` / ``profile_dir``), exports its
trace (``<name>.<pid>.trace.json``, the chrome trace format) and splits the
window's time into

- **compile**: the port's first-use kernel builds (``ops/build.py``: the
  union of the ``nvcc`` runs inside the window) plus any host event of the
  trace named like a compile step (``_COMPILE_NAME_FRAGMENTS``).  cuDNN's
  set-up has no event of its own in the trace (CUPTI records the CUDA
  runtime and device API calls, not cuDNN's), so it falls into host-gap and
  device-compute, where its kernels run;
- **h2d**: data movement on the device, the trace's ``gpu_memcpy`` events
  (category ``memcpy``), plus the reference's copy categories;
- **device-compute**: every other device event (``kernel``, ``memset``);
- **host-gap**: window wall time not covered by the above.

Device events are the trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events.  They are aggregated by category (``kernel``, ``memcpy``,
``memset``) and by kernel name, the port's form of the reference's
``by_source`` rows (XLA source lines); the port keeps
:data:`BY_SOURCE_ROWS` of them, since a name covers less work than a source
line.  The trace carries no FLOPs or bytes, so those columns are 0 and
``trace_model_flops`` is None.

The engine notes every program that ran in the window with its FLOPs
(``fedml_program_flops``: ``torch.utils.flop_counter.FlopCounterMode`` on a
round's first execution, ``sim/engine.py``), so the attribution joins those
FLOPs against measured device time: ``mfu_cost_model`` (FLOPs /
device-compute time / the card's peak) beside ``sim_mfu_gauge`` (the same
FLOPs over host wall time).  The attribution JSON has the reference's keys
(``_attribute``), so the reference's report readers read it.

:func:`parse_profile_rounds`, :func:`split_time_buckets` and
:func:`bucket_rows` are the reference's host code on dicts, with one decided
difference: ``memcpy`` is an h2d category (the reference's trace names its
copies otherwise).  Everything degrades to a warning and a window without
attribution, never an exception into the round path; a caller that needs the
attribution (``chip_smoke.py``) checks :attr:`attribution` itself.  Gating
is absolute: :func:`profiler_from_config` returns ``None`` unless
``extra.profile_rounds`` parses.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import tempfile
import time
from typing import Any, Optional

from ..core.flags import cfg_extra
from . import registry as obsreg

log = logging.getLogger("fedml_tpu_torch.obs.profiler")

__all__ = [
    "ProgramTimeAttributor", "profiler_from_config", "parse_profile_rounds",
    "load_trace", "aggregate_device_events", "split_time_buckets", "bucket_rows",
]

PROFILE_WINDOWS = obsreg.REGISTRY.counter(
    "fedml_profile_windows_total",
    "Programmatic profiler trace windows completed, by outcome (attributed "
    "= trace parsed; unparsed = window closed but no readable trace).",
    labels=("outcome",),
)
PROFILE_DEVICE_SECONDS = obsreg.REGISTRY.gauge(
    "fedml_profile_device_seconds",
    "Window time split by the attributor: compile / h2d / device_compute / "
    "host_gap seconds of the last completed profile window.",
    labels=("category",),
)
PROFILE_MFU = obsreg.REGISTRY.gauge(
    "fedml_profile_mfu",
    "MFU cross-checked from the profile window: cost-model program FLOPs "
    "over measured device-compute time over chip peak (compare against "
    "fedml_sim_mfu, whose denominator is host-inclusive wall time).",
)

#: categories / event-name fragments that are data movement, not compute:
#: the reference's, and the port's ``memcpy``
_H2D_CATEGORIES = ("copy", "infeed", "outfeed", "host send", "host recv", "memcpy")
_H2D_NAME_FRAGMENTS = ("transferto", "transferfrom", "copy")
_COMPILE_NAME_FRAGMENTS = ("compile", "nvrtc", "cudnnfind")
#: chrome-trace categories of device events -> the attribution's categories
_DEVICE_CATEGORIES = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
#: rows of ``by_category`` and of ``by_source`` (kernel names) kept
BY_CATEGORY_ROWS = 8
BY_SOURCE_ROWS = 32


def parse_profile_rounds(value: Any) -> Optional[tuple[int, int]]:
    """``'n'`` -> rounds ``[0, n)``; ``'k:n'`` -> ``[k, k+n)``; ``None`` /
    unparseable / empty window -> ``None`` (the gate)."""
    if value is None:
        return None
    try:
        text = str(value).strip()
        if not text:
            return None
        if ":" in text:
            k_s, n_s = text.split(":", 1)
            k, n = int(k_s), int(n_s)
        else:
            k, n = 0, int(text)
        if n <= 0 or k < 0:
            return None
        return (k, k + n)
    except (TypeError, ValueError):
        log.warning("profiler: unparseable profile_rounds %r — disabled", value)
        return None


# ---------------------------------------------------------------------------
# trace parsing


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def aggregate_device_events(trace: dict) -> dict:
    """Aggregate the trace's device events (``X`` events of the kernel,
    memcpy and memset categories) by category and by name:
    ``{key: [duration_ps, flops, bytes, n]}`` per bucket (FLOPs and bytes
    are 0: the trace carries neither), plus the host events' compile time
    (``compile_ps``)."""
    cat: dict = collections.defaultdict(lambda: [0, 0, 0, 0])
    src: dict = collections.defaultdict(lambda: [0, 0, 0, 0])
    compile_ps = 0
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        # chrome-trace durations are microseconds
        d = int(round(float(e.get("dur", 0)) * 1e6))
        category = _DEVICE_CATEGORIES.get(str(e.get("cat", "")).lower())
        if category is not None:
            for bucket, key in ((cat, category), (src, str(e.get("name", "?")))):
                bucket[key][0] += d
                bucket[key][3] += 1
        elif any(f in str(e.get("name", "")).lower() for f in _COMPILE_NAME_FRAGMENTS):
            compile_ps += d
    return {"by_category": dict(cat), "by_source": dict(src), "compile_ps": compile_ps}


def split_time_buckets(aggregated: dict, wall_s: float) -> dict:
    """The four-way split: compile / h2d / device_compute / host_gap
    seconds over a window of ``wall_s`` wall seconds."""
    h2d_ps = 0
    compute_ps = 0
    for key, (d, _fl, _by, _n) in aggregated.get("by_category", {}).items():
        k = str(key).lower()
        if any(f in k for f in _H2D_CATEGORIES) or any(
                f in k for f in _H2D_NAME_FRAGMENTS):
            h2d_ps += d
        else:
            compute_ps += d
    compile_s = aggregated.get("compile_ps", 0) / 1e12
    h2d_s = h2d_ps / 1e12
    compute_s = compute_ps / 1e12
    host_gap_s = max(0.0, float(wall_s) - compile_s - h2d_s - compute_s)
    return {"compile_s": round(compile_s, 6), "h2d_s": round(h2d_s, 6),
            "device_compute_s": round(compute_s, 6),
            "host_gap_s": round(host_gap_s, 6)}


def bucket_rows(bucket: dict, top: int) -> list[dict]:
    """Render one aggregation bucket as sorted report rows (achieved
    TFLOP/s and GB/s per key)."""
    out = []
    for k, (d, fl, by, n) in sorted(bucket.items(), key=lambda kv: -kv[1][0])[:top]:
        out.append({
            "key": k, "ms": round(d / 1e9, 2), "n": n,
            "tflops": round(fl / (d / 1e12) / 1e12, 2) if d else 0,
            "gbps": round(by / (d / 1e12) / 1e9, 1) if d else 0,
        })
    return out


# ---------------------------------------------------------------------------


class ProgramTimeAttributor:
    """One profile window around rounds ``[start, end)``: trace, parse,
    attribute, cross-check MFU, write the attribution JSON."""

    def __init__(self, out_dir: str, *, window: tuple[int, int],
                 name: str = "sim",
                 registry: Optional[obsreg.MetricsRegistry] = None,
                 peak_flops: Optional[float] = None):
        self.out_dir = os.path.abspath(str(out_dir))
        os.makedirs(self.out_dir, exist_ok=True)
        self.name = str(name)
        self.window = (int(window[0]), int(window[1]))
        self.registry = registry or obsreg.REGISTRY
        self.peak_flops = peak_flops
        self.attribution: Optional[dict] = None
        self.attribution_path: Optional[str] = None
        self._programs: list[dict] = []
        self._active = False
        self._done = False
        self._prof = None
        self._wall_start = 0.0

    # -- window lifecycle (the engine drives these around rounds) -----------
    def maybe_start(self, round_idx: int) -> bool:
        """Open the trace when ``round_idx`` enters the window.  Returns
        whether the window is active after the call."""
        if self._active:
            return True
        if self._done or not (self.window[0] <= int(round_idx) < self.window[1]):
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()  # the window holds only its own device work
            self._prof = profile(activities=activities)
            self._prof.start()
        except Exception as e:
            log.warning("profiler: start failed (%s: %s) — window disabled",
                        type(e).__name__, e)
            self._done = True
            return False
        self._active = True
        self._wall_start = time.time()
        return True

    def note_program(self, program: str, *, flops: Optional[float] = None,
                     rounds: Optional[int] = None) -> None:
        """Record one program execution inside the window (the join key
        against the cost-model gauges)."""
        if not self._active:
            return
        self._programs.append({
            "program": str(program),
            "flops": float(flops) if flops else None,
            "rounds": int(rounds) if rounds else None,
        })

    def maybe_stop(self, next_round_idx: int) -> Optional[dict]:
        """Close the window once the next round falls past its end;
        returns the attribution (``None`` while still open / unparsed)."""
        if not self._active or int(next_round_idx) < self.window[1]:
            return None
        return self.finalize()

    def finalize(self) -> Optional[dict]:
        """Stop the trace (if open), parse, attribute, export gauges."""
        if not self._active:
            return self.attribution
        self._active = False
        self._done = True
        trace_file = os.path.join(self.out_dir, f"{self.name}.{os.getpid()}.trace.json")
        try:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the window's device work is done
            wall_end = time.time()
            self._prof.stop()
            self._prof.export_chrome_trace(trace_file)
        except Exception as e:
            log.warning("profiler: stop failed (%s: %s)", type(e).__name__, e)
            PROFILE_WINDOWS.inc(outcome="unparsed")
            return None
        finally:
            self._prof = None
        self.attribution = self._attribute(self._wall_start, wall_end, trace_file)
        outcome = "attributed" if self.attribution is not None else "unparsed"
        PROFILE_WINDOWS.inc(outcome=outcome)
        return self.attribution

    # -- attribution ----------------------------------------------------------
    def _attribute(self, t0: float, t1: float, trace_file: str) -> Optional[dict]:
        from ..ops import build

        wall_s = t1 - t0
        try:
            aggregated = aggregate_device_events(load_trace(trace_file))
        except Exception as e:
            log.warning("profiler: trace %s unparseable (%s: %s)",
                        trace_file, type(e).__name__, e)
            return None
        aggregated["compile_ps"] += int(round(build.build_seconds_within(t0, t1) * 1e12))
        buckets = split_time_buckets(aggregated, wall_s)
        for category, seconds in buckets.items():
            PROFILE_DEVICE_SECONDS.set(seconds,
                                       category=category.rsplit("_s", 1)[0])
        compute_s = buckets["device_compute_s"]
        cost_flops = sum(p["flops"] for p in self._programs if p["flops"])
        programs = []
        for p in self._programs:
            row = dict(p)
            if p["flops"] and cost_flops and compute_s:
                share = p["flops"] / cost_flops
                row["share_device_s"] = round(share * compute_s, 6)
            programs.append(row)
        mfu_cost_model = None
        if cost_flops and compute_s and self.peak_flops:
            mfu_cost_model = cost_flops / compute_s / float(self.peak_flops)
            PROFILE_MFU.set(mfu_cost_model)
        sim_mfu = None
        fam = self.registry.get("fedml_sim_mfu")
        if fam is not None:
            with contextlib.suppress(Exception):
                sim_mfu = float(fam.value())
        attribution = {
            "window": {"start_round": self.window[0],
                       "end_round": self.window[1],
                       "wall_s": round(wall_s, 6)},
            "buckets": buckets,
            "by_category": bucket_rows(aggregated["by_category"], BY_CATEGORY_ROWS),
            "by_source": bucket_rows(aggregated["by_source"], BY_SOURCE_ROWS),
            "programs": programs,
            "cost_model_flops": cost_flops or None,
            "trace_model_flops": None,
            "chip_peak_flops": self.peak_flops,
            "mfu_cost_model": round(mfu_cost_model, 6) if mfu_cost_model else None,
            "mfu_trace": None,
            "sim_mfu_gauge": round(sim_mfu, 6) if sim_mfu else None,
            "trace_file": trace_file,
        }
        self.attribution_path = self._write(attribution)
        return attribution

    def _write(self, attribution: dict) -> Optional[str]:
        path = os.path.join(
            self.out_dir, f"{self.name}.{os.getpid()}.attribution.json")
        try:
            fd, tmp = tempfile.mkstemp(dir=self.out_dir, prefix=".tmp_",
                                       suffix=".json")
            with os.fdopen(fd, "w") as f:
                json.dump(attribution, f, sort_keys=True, indent=1, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return path
        except OSError as e:
            log.warning("profiler: attribution write failed (%s)", e)
            return None


def profiler_from_config(cfg, *, name: str = "sim",
                         peak_flops: Optional[float] = None
                         ) -> Optional[ProgramTimeAttributor]:
    """The one gate: ``extra.profile_rounds`` unset/unparseable ->
    ``None`` (no trace, no window, the default path unchanged)."""
    if cfg is None:
        return None
    window = parse_profile_rounds(cfg_extra(cfg, "profile_rounds"))
    if window is None:
        return None
    out_dir = cfg_extra(cfg, "profile_dir") or os.path.join(
        os.getcwd(), "profile_traces")
    try:
        return ProgramTimeAttributor(str(out_dir), window=window, name=name,
                                     peak_flops=peak_flops)
    except OSError as e:
        log.warning("profiler: dir %s unusable (%s) — running without the "
                    "attributor", out_dir, e)
        return None
