#!/usr/bin/env python3
"""The fused forward kernel against simple variants of its design, on the card.

Run from the repository root on a machine with an NVIDIA card:

    python3 -m fedml_tpu_torch.obs.ablate_fwd

Builds ``csrc/fused_block.cu`` as it is and copies of it that change one
thing in the forward kernel (one ``nvcc`` each, all started together, under
``fedml_tpu_torch/_build/``):

- ``unroll1`` / ``unroll2`` / ``unroll4`` (those the source does not
  use): the loads of that many rows a thread in flight before the first use;
- ``ldg`` / ``plain_loads``: the operand loads through the read-only path
  (``__ldg``) or as plain loads, instead of with the evict-first policy
  (``__ldcs``);
- ``flat``: the rows dealt out grid-stride (block ``bx``'s threads take rows
  ``bx * rb + j``, then ``+ gridDim.x * rb``, ...) instead of a contiguous
  range a block: a flat 16-byte grid-stride whose stride is a multiple of
  the row;
- ``vectors_late``: scale and shift loaded after the rows' loads are issued;
- ``const_vectors`` (a diagnostic, not the function): no loads of scale and
  shift at all;

each on one resident wave of its own occupancy, and the kernel as it is and
the other of unroll 1 and 2 also on as many blocks as a row a thread needs
(``*_no_wave``).
Each is timed as ``chip_smoke.py`` times the kernels (CUDA-graph replays of
one call per input set, the sets rotated through more than twice the 50 MB L2,
the output allocated by each call as the wrapper does) at the flagship's
three stage shapes, in bf16 and f32, with and without the residual, beside
the PyTorch elementwise op that moves the same bytes (``torch.relu(y)`` or
``torch.add(y, r)``).  Every copy's output but the diagnostic's is checked
bitwise against the plain version.  Prints the card, each copy's registers,
and one line per case: the bound, the stream and each copy's device time
(with its row blocks), then the kernel as it is, ``ldg`` and the stream
with one input set in every call ("warm": the operands in the L2, as on the
path, where y is the conv output just written).
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
import time

from fedml_tpu_torch.obs.ablate_bwd import HBM_BYTES_PER_S, L2_BYTES, SHAPES, _build, _device_ms

UNROLL = re.compile(r"constexpr int kFwdUnroll = (\d+);")
EVICT_FIRST = "load_pack<T, VEC, true>"
LDG = "__ldg(q)"
KERNEL_START = "fwd_kernel(const T* __restrict__ y,"
KERNEL_END = "// W consecutive floats of a scratch row"
ROWS = """  const unsigned r_begin = blockIdx.x * a.rows_per_block;
  const unsigned r_end = min(a.rows, r_begin + a.rows_per_block);
  for (unsigned r = r_begin + threadIdx.y; r < r_end; r += kFwdUnroll * rb) {"""
FLAT_ROWS = """  const unsigned r_end = a.rows, step = gridDim.x * rb;
  for (unsigned r = blockIdx.x * rb + threadIdx.y; r < r_end; r += kFwdUnroll * step) {"""
ROW_OF_U = "const unsigned rr = r + u * rb;"
VECTORS = """  float s[VEC], b[VEC];
  load_channels<VEC>(scale + c0, s);
  load_channels<VEC>(shift + c0, b);
"""
FIRST_USE = "#pragma unroll\n    for (int u = 0; u < kFwdUnroll; ++u) {\n      const unsigned rr = r + u * rb;\n      if (rr < r_end) {\n        Pack<T, VEC> po;"
# copies whose output is not the function: timed only, never checked
DIAGNOSTIC = ("const_vectors",)


def variants(src: str) -> dict:
    unroll = UNROLL.search(src)
    for mark in (LDG, KERNEL_START, KERNEL_END):
        if mark not in src or unroll is None:
            raise RuntimeError(f"ablate_fwd: the kernel source has no {mark.strip()!r}")
    i, j = src.index(KERNEL_START), src.index(KERNEL_END)
    kernel = src[i:j]
    for mark in (EVICT_FIRST, ROWS, VECTORS, FIRST_USE):
        if mark not in kernel:
            raise RuntimeError(f"ablate_fwd: the forward kernel has no {mark.strip()!r}")

    def fwd(k):
        return src[:i] + k + src[j:]

    flat = kernel.replace(ROWS, FLAT_ROWS).replace(ROW_OF_U, ROW_OF_U.replace("rb", "step"))
    late = kernel.replace(VECTORS, "").replace(FIRST_USE, VECTORS.replace("  ", "    ", 1).replace(
        "\n  ", "\n    ") + FIRST_USE)
    const = kernel.replace(VECTORS, """  float s[VEC], b[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) { s[v] = 1.f; b[v] = 0.f; }
""")
    ldg = fwd(kernel.replace(EVICT_FIRST, EVICT_FIRST.replace("true", "false")))
    copies = {"full": src}
    for depth in ("1", "2", "4"):
        if depth != unroll.group(1):
            copies[f"unroll{depth}"] = UNROLL.sub(f"constexpr int kFwdUnroll = {depth};", src)
    return {**copies, "ldg": ldg, "plain_loads": ldg.replace(LDG, "*q"), "flat": fwd(flat),
            "vectors_late": fwd(late), "const_vectors": fwd(const)}


def _case(libs, shape, dtype, residual, sms):
    import torch

    from fedml_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    c, n = shape[-1], math.prod(shape)
    code, item = fb._DTYPE_CODES[dtype], dtype.itemsize
    vec = fb.vector_width(c, item, True)

    def occupancy(lib):
        blocks = ctypes.c_int(0)
        if lib.fused_blocks_per_sm(0, code, vec, int(residual), ctypes.byref(blocks)) != 0:
            raise RuntimeError("ablate_fwd: occupancy query failed")
        return blocks.value

    gen = torch.Generator(device=dev)
    sets = []
    for k in range(max(2, int(2 * L2_BYTES // (n * item)) + 1)):
        gen.manual_seed(400 + k)
        y, r = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(2))
        s, b = (torch.randn(c, generator=gen, device=dev) for _ in range(2))
        sets.append((y, s, b, r if residual else None))

    def launcher(lib, g):
        args = (ctypes.c_int * 9)(code, *g)

        def call(y, s, b, r):
            out = torch.empty_like(y)  # as the wrapper allocates it
            err = lib.fused_fwd(args, y.data_ptr(), s.data_ptr(), b.data_ptr(),
                                r.data_ptr() if r is not None else None, out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream, None, None)
            if err != 0:
                raise RuntimeError(f"ablate_fwd: launch failed with error {err}")
            return out
        return call

    # each copy on the wave of its own occupancy; the full kernel and
    # unroll1 also on as many blocks as a row a thread needs
    geos = {name: fb.fwd_geometry(n // c, c, item, True, sms, occupancy(lib))
            for name, lib in libs.items()}
    calls = {name: launcher(lib, geos[name]) for name, lib in libs.items()}
    for name in ("full", "unroll1" if "unroll1" in libs else "unroll2"):
        geos[f"{name}_no_wave"] = fb.fwd_geometry(n // c, c, item, True, sms, 2**20)
        calls[f"{name}_no_wave"] = launcher(libs[name], geos[f"{name}_no_wave"])
    y, s, b, r = sets[0]
    want = fb.fused_block_reference(y, s, b, r)
    for name, call in calls.items():
        got = call(*sets[0])
        torch.cuda.synchronize()
        if name not in DIAGNOSTIC and not torch.equal(got, want):
            raise AssertionError(f"ablate_fwd: {name} disagrees with the plain version at {shape}")
    times = {name: _device_ms(call, sets) for name, call in calls.items()}
    if residual:
        stream = lambda y, s, b, r: torch.add(y, r)  # noqa: E731
    else:
        stream = lambda y, s, b, r: torch.relu(y)  # noqa: E731
    stream_ms = _device_ms(stream, sets)
    # warm: the first input set in every call of the graph, so the operands
    # come from the L2, as on the path, where y is the conv output just
    # written
    same = sets[:1] * len(sets)
    warm = {name: _device_ms(calls[name], same) for name in ("full", "ldg")}
    warm["stream"] = _device_ms(stream, same)
    bound_ms = ((3 if residual else 2) * n * item + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
    return geos, bound_ms, stream_ms, times, warm


def main() -> int:
    import torch

    from fedml_tpu_torch.ops import build

    if not torch.cuda.is_available():
        print("ablate_fwd: needs an NVIDIA card", file=sys.stderr)
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
                geos, bound_ms, stream_ms, times, warm = _case(libs, shape, dtype, residual,
                                                               sms)
                cells = ", ".join(f"{k} {v * 1e3:.2f} us ({geos[k].row_blocks})"
                                  for k, v in times.items())
                print(f"{shape} {str(dtype).replace('torch.', '')} residual={int(residual)}: "
                      f"bound {bound_ms * 1e3:.2f} us, stream {stream_ms * 1e3:.2f} us; "
                      f"{cells}; warm: " + ", ".join(f"{k} {v * 1e3:.2f} us"
                                                      for k, v in warm.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
