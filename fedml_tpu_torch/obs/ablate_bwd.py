#!/usr/bin/env python3
"""Where the fused backward kernel's device time goes, by ablation.

Run from the repository root on a machine with an NVIDIA card:

    python3 -m fedml_tpu_torch.obs.ablate_bwd

Builds ``csrc/fused_block.cu`` as it is and three cut-down copies of it (one
``nvcc`` each, all started together, under ``fedml_tpu_torch/_build/``):

- ``no_fold``: every block writes its row of partials and exits; no ticket
  is drawn and no block folds the rows into d_scale / d_shift;
- ``no_reduction``: every block exits after its rows (dy and dr written, no
  in-block fold, no partials): the streaming floor of the kernel;
- ``unroll4``: the full kernel with four rows' loads a thread in flight
  instead of two.

Each is timed as ``chip_smoke.py`` times the kernels (CUDA-graph replays of
one call per input set, the sets rotated through more than the 50 MB L2) at
the flagship's three stage shapes, in bf16 and f32, with and without the
residual, on the geometry the wrapper gives the full kernel.  The full
kernel's output is checked against the plain version.  Prints the card, each
copy's registers, and one line per case: the bound and each copy's device
time.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import time

SHAPES = [(128, 32, 32, 16), (128, 16, 16, 32), (128, 8, 8, 64)]
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
# the places in the source that the cut-down copies patch
FOLD_START = "  // Cross-block fold: the block that draws the last ticket folds every"
REDUCTION_START = "\n  // In-block fold: the threads' sums as an (rb, 2 * tile) matrix in shared"
UNROLL = "constexpr int kUnroll = 2;"
# an early exit the compiler cannot prove is taken (slots are < 65536)
EXIT = "  if (a.slot < 100000) return;\n"


def variants(src: str) -> dict:
    for mark in (FOLD_START, REDUCTION_START, UNROLL):
        if mark not in src:
            raise RuntimeError(f"ablate_bwd: the kernel source has no {mark.strip()!r}")
    return {"full": src,
            "no_fold": src.replace(FOLD_START, EXIT + FOLD_START),
            "no_reduction": src.replace(REDUCTION_START, "\n" + EXIT.rstrip() + REDUCTION_START, 1),
            "unroll4": src.replace(UNROLL, UNROLL.replace("2", "4"))}


def _build(sources: dict, signatures=None, subdir: str = "ablate") -> dict:
    """Build each source (one nvcc each, all started together) under
    ``_build/<subdir>``; ``signatures``: copy name -> its C functions'
    signatures (default: the fused block library's)."""
    from fedml_tpu_torch.ops import build, fused_block as fb

    out = build.BUILD_DIR / subdir
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate_bwd: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, (restype, argtypes) in (signatures or {}).get(name, fb._SIGNATURES).items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
        used = [line.split("Used")[1].strip() for line in log.splitlines() if "Used" in line]
        print(f"{name}: ptxas {used}")
    return libs


def _device_ms(call, arg_sets, replays=25):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            call(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            call(*args)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(arg_sets))


def _case(libs, shape, dtype, residual, sms):
    import torch

    from fedml_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    c, n = shape[-1], math.prod(shape)
    code, item = fb._DTYPE_CODES[dtype], dtype.itemsize
    blocks = ctypes.c_int(0)
    if libs["full"].fused_blocks_per_sm(1, code, fb.vector_width(c, item, True), int(residual),
                                        ctypes.byref(blocks)) != 0:
        raise RuntimeError("ablate_bwd: occupancy query failed")
    geo = fb.bwd_geometry(n // c, c, item, True, sms, blocks.value)
    geo_args = (ctypes.c_int * 9)(code, *geo)
    gen = torch.Generator(device=dev)
    sets = []
    for k in range(max(2, int(3 * L2_BYTES // (5 * n * item)) + 1)):
        gen.manual_seed(300 + k)
        y, r, g = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
        s, b = (torch.randn(c, generator=gen, device=dev) for _ in range(2))
        out = fb.fused_block_reference(y, s, b, r if residual else None)
        sets.append((g, y, s, out, torch.empty_like(y), torch.empty_like(y) if residual else None,
                     torch.empty((2, c), device=dev),
                     torch.empty(geo.scratch_floats, device=dev)))

    def launcher(lib):
        def call(g, y, s, out, dy, dr, dss, scratch):
            err = lib.fused_bwd(geo_args, g.data_ptr(), y.data_ptr(), s.data_ptr(),
                                out.data_ptr(), dy.data_ptr(),
                                dr.data_ptr() if dr is not None else None, dss.data_ptr(),
                                scratch.data_ptr(), 0, torch.cuda.current_stream().cuda_stream,
                                None, None)
            if err != 0:
                raise RuntimeError(f"ablate_bwd: launch failed with error {err}")
        return call

    times = {name: _device_ms(launcher(lib), sets) for name, lib in libs.items()}
    g, y, s, out, dy, dr, dss, _ = sets[0]
    launcher(libs["full"])(*sets[0])
    want = fb.fused_block_bwd_reference(g, y, s, out, residual)
    torch.cuda.synchronize()
    if not (torch.equal(dy, want[0]) and (dr is None or torch.equal(dr, want[3]))
            and torch.allclose(dss, torch.stack(want[1:3]), rtol=1e-4, atol=1e-3)):
        raise AssertionError(f"ablate_bwd: full kernel disagrees with the plain version at {shape}")
    bound_ms = ((5 if residual else 4) * n * item + 3 * c * 4) / HBM_BYTES_PER_S * 1e3
    return geo, bound_ms, times


def main() -> int:
    import torch

    from fedml_tpu_torch.ops import build

    if not torch.cuda.is_available():
        print("ablate_bwd: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    t0 = time.perf_counter()
    libs = _build(variants(build.SOURCES["fused_block"].read_text()))
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(libs)}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for residual in (False, True):
                geo, bound_ms, times = _case(libs, shape, dtype, residual, sms)
                cells = ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in times.items())
                print(f"{shape} {str(dtype).replace('torch.', '')} residual={int(residual)} "
                      f"({geo.row_blocks} row blocks): bound {bound_ms * 1e3:.2f} us; {cells}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
