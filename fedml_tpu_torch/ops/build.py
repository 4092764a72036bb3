"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``fedml_tpu_torch/csrc/`` compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds).  Libraries land in
``fedml_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source and flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing here runs at import time.

Thread-safe: cross-silo clients run as threads that launch the same kernels,
so the launch counts and the build-and-load cache are under locks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"fused_block": _PKG / "csrc" / "fused_block.cu",
           "quantize": _PKG / "csrc" / "quantize.cu",
           "noise": _PKG / "csrc" / "noise.cu"}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> loaded CDLL (a process-wide cache, like an import), and the lock
# that makes check-build-load one step: two threads that first use a kernel
# together run nvcc once (reentrant: load_library holds it around build)
_LOADED: dict = {}
_BUILD_LOCK = threading.RLock()


class Kernel:
    """One CUDA kernel of the port: its name, the TPU kernel it replaces
    (``file:line``) and its launches on the card (counted under a lock:
    ``launches += 1`` from several threads loses counts)."""

    def __init__(self, name: str, replaces: str):
        self.name = name
        self.replaces = replaces
        self.launches = 0
        self._lock = threading.Lock()

    def count_launch(self) -> None:
        with self._lock:
            self.launches += 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0


def current_stream(device, what: str) -> int:
    """The current stream of the current device, which must hold the
    operands: a kernel launches only into a stream of the current device."""
    import torch

    stream = torch.cuda.current_stream()
    if stream.device != device:
        raise ValueError(f"{what}: operands on {device}, current device is "
                         f"{stream.device} (use torch.cuda.set_device)")
    return stream.cuda_stream


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the port's CUDA kernels build on the machine with the card")
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` process each, all started together.  Returns ``{name:
    {"seconds": wall, "log": ptxas output}}`` for what was compiled; raises
    with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    with _BUILD_LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out, time.perf_counter())
        report = {}
        failures = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, out)  # readers see no library or a complete one
            report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """The built library ``name`` (built now if missing), with ``argtypes``
    and ``restype`` declared from ``signatures``: ``{fn: (restype,
    [argtypes])}``."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LOADED[name] = lib
    return lib
