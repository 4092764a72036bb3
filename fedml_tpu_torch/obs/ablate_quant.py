#!/usr/bin/env python3
"""The int8 quantize and dequantize kernels against variants of their design, on the card.

Run from the repository root on a machine with an NVIDIA card:

    python3 -m fedml_tpu_torch.obs.ablate_quant [--against DIR]

Builds ``csrc/quantize.cu`` as it is and copies that change one thing (one
``nvcc`` each, all started together, under ``fedml_tpu_torch/_build/``):

- ``was``: the design these kernels replaced, kept here as source
  (:data:`WAS_SOURCE`): a 256-thread block per quantization block, 4
  elements a thread in 4-byte ``__ldg`` loads, the max across the 8 warps
  in shared memory between two barriers and folded by one thread, u loaded
  after the max, a byte store an element; the dequantize a thread per
  element;
- ``u_late``: u loaded after the max (two round trips a block);
- ``t32`` / ``t64`` / ``t128`` (those the source does not use): a
  quantization block's thread block of that many threads (1 / 2 / 4 warps,
  8 / 4 / 2 float4 of x and of u a thread; ``t32`` is a warp per
  quantization block);
- ``loads4``: x and u in 4-byte loads (the stores still packed);
- ``ldg``: the quantize's loads through the read-only path (``__ldg``)
  instead of evict-first (``__ldcs``);
- ``dq_ldcs``: the dequantize's loads evict-first instead of through the
  read-only path;
- ``plain_stores``: the dequantize's float4 stores without the evict-first
  policy (``__stcs``);
- ``dq2`` / ``dq4`` (those the source does not use): the dequantize at 2 / 4
  words of 4 values a lane (8 / 16 values a thread, a warp's loads and
  stores still contiguous);
- ``contig16``: the dequantize at 16 consecutive values a thread (one
  16-byte load, four float4 stores 64 bytes apart across the lanes);
- ``dq_t64`` / ``dq_t128`` (those the source does not use): the dequantize
  on thread blocks of 64 / 128 threads.

Each is timed as ``chip_smoke.py`` times the kernels (CUDA-graph replays
of one call per input set, the sets rotated through more than twice the 50
MB L2, the outputs allocated by each call as the wrappers do) at the FedSGD gradient's 269,722 elements and at
2^24, in :data:`PASSES` passes over the copies in turn (median and spread),
beside the same-bytes stream (``torch.lt(x, u)`` and ``values.to(float32)``).
Every copy is checked bitwise against the plain version before it is timed.
Prints the card, each copy's registers, and one line per kernel and length.

``--against DIR`` also times the wrappers' eager calls (host included, as
the path pays them) at 269,722 against those of the tree unpacked at
``DIR`` (its ``fedml_tpu_torch/ops/quantize.py`` and the kernels it
builds), in :data:`EAGER_RUNS` alternating runs, each the least of 10 runs
of 100 calls back to back; it prints each side's median and spread.
"""

from __future__ import annotations

import argparse
import importlib
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

from fedml_tpu_torch.obs.ablate_bwd import HBM_BYTES_PER_S, L2_BYTES, _build, _device_ms

LENGTHS = [269722, 2**24]
PASSES = 7
EAGER_RUNS = 9
# the places in the source that the copies patch
LD = "T ld(const T* p) { return __ldcs(p); }"
LD_DQ = "T ld_dq(const T* p) { return __ldg(p); }"
STREAM_STORE = "__stcs(reinterpret_cast<float4*>(out + e), make_float4(v[0], v[1], v[2], v[3]));"
STORE = "*reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2], v[3]);"
VEC_LOAD = "  if (VEC) return ld(reinterpret_cast<const float4*>(p));\n"
U_LOADS = ("#pragma unroll\n  for (int k = 0; k < kPerThread; ++k) uv[k] = "
           "load4<VEC>(u + base + 4 * kThreads * k);\n")
SCALE = "  const float scale = __fadd_rn(__fdiv_rn(amax, 127.f), 1e-12f);\n"
THREADS = re.compile(r"constexpr int kThreads = (\d+);")
DQ_WORDS = re.compile(r"constexpr int kDqWords = (\d+);")
DQ_THREADS = re.compile(r"constexpr int kDqThreads = (\d+);")
DQ_START = ("template <bool VEC>\n__global__ void __launch_bounds__(kDqThreads)\n"
            "dequantize_kernel(")
DQ_END = "bool aligned16("
CONTIG16_KERNEL = r"""template <bool VEC>
__global__ void __launch_bounds__(kDqThreads)
dequantize_kernel(const signed char* __restrict__ values, const float* __restrict__ scales,
                  float* __restrict__ out, unsigned length) {
  const unsigned e = (blockIdx.x * blockDim.x + threadIdx.x) * 16;
  if (e >= length) return;
  unsigned w[4];
  if (VEC) {
    const uint4 t = ld_dq(reinterpret_cast<const uint4*>(values + e));
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j / 4] |= (unsigned)(unsigned char)ld_dq(values + e + j) << (8 * (j % 4));
  }
  const float scale = ld_dq(scales + e / kBlock);
  float v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = __fmul_rn((float)(signed char)(w[j / 4] >> (8 * (j % 4))), scale);
  if (VEC && e + 16 <= length) {
#pragma unroll
    for (int j = 0; j < 16; j += 4)
      __stcs(reinterpret_cast<float4*>(out + e + j), make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]));
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (e + j < length) __stcs(out + e + j, v[j]);
  }
}

"""
# The kernels these replaced: one 256-thread block per quantization block.
WAS_SOURCE = r"""#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;  // elements per quantization block (8 x 128)
constexpr int kThreads = 256;
constexpr int kPerThread = kBlock / kThreads;
constexpr int kWarps = kThreads / 32;

// max that propagates NaN (jnp.max / torch.amax)
__device__ __forceinline__ float nanmax(float a, float b) { return (a > b || a != a) ? a : b; }

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ u,
                signed char* __restrict__ values, float* __restrict__ scales,
                unsigned length) {
  __shared__ float s_warp[kWarps];
  __shared__ float s_scale;
  const unsigned t = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * kBlock;
  float xv[kPerThread];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const size_t i = base + t + (size_t)k * kThreads;
    xv[k] = i < length ? __ldg(x + i) : 0.f;
    amax = nanmax(amax, fabsf(xv[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nanmax(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((t & 31) == 0) s_warp[t >> 5] = amax;
  __syncthreads();
  if (t == 0) {
    float m = s_warp[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = nanmax(m, s_warp[w]);
    const float scale = __fadd_rn(__fdiv_rn(m, 127.f), 1e-12f);
    s_scale = scale;
    scales[blockIdx.x] = scale;
  }
  __syncthreads();
  const float scale = s_scale;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const size_t i = base + t + (size_t)k * kThreads;
    float q = floorf(__fadd_rn(__fdiv_rn(xv[k], scale), __ldg(u + i)));
    q = fminf(fmaxf(q, -127.f), 127.f);
    values[i] = (signed char)(int)q;
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const signed char* __restrict__ values, const float* __restrict__ scales,
                  float* __restrict__ out, unsigned length) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i < length) out[i] = __fmul_rn((float)values[i], __ldg(scales + i / kBlock));
}

}  // namespace

extern "C" {

// The entry points take the arguments of today's (the variant flag unused).
// x: `length` floats; u: blocks * 1024 floats; values: blocks * 1024 int8;
// scales: `blocks` floats, blocks = ceil(length / 1024).
int quantize_int8(const void* x, const void* u, void* values, void* scales, int length, int,
                  void* stream) {
  if (length <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (length + kBlock - 1) / kBlock;
  quantize_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)u, (signed char*)values, (float*)scales,
      (unsigned)length);
  return (int)cudaGetLastError();
}

// values: at least `length` int8 (blocks * 1024); scales: ceil(length / 1024)
// floats; out: `length` floats.
int dequantize_int8(const void* values, const void* scales, void* out, int length, int,
                    void* stream) {
  if (length <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (length + kThreads - 1) / kThreads;
  dequantize_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const signed char*)values, (const float*)scales, (float*)out, (unsigned)length);
  return (int)cudaGetLastError();
}

}  // extern "C"
"""


def variants(src: str) -> dict:
    """copy name -> source: the kernels as they are (``final``) and the
    copies that each change one thing."""
    threads, words, dq_threads = THREADS.search(src), DQ_WORDS.search(src), DQ_THREADS.search(src)
    for mark in (LD, LD_DQ, STREAM_STORE, VEC_LOAD, U_LOADS, SCALE, DQ_START, DQ_END):
        if mark not in src or threads is None or words is None or dq_threads is None:
            raise RuntimeError(f"ablate_quant: the kernel source has no {mark.strip()!r}")
    i, j = src.index(DQ_START), src.index(DQ_END)
    copies = {"final": src, "was": WAS_SOURCE,
              "u_late": src.replace(U_LOADS, "").replace(SCALE, SCALE + U_LOADS),
              "loads4": src.replace(VEC_LOAD, ""),
              "ldg": src.replace(LD, LD.replace("__ldcs", "__ldg")),
              "dq_ldcs": src.replace(LD_DQ, LD_DQ.replace("__ldg", "__ldcs")),
              "plain_stores": src.replace(STREAM_STORE, STORE),
              "contig16": DQ_WORDS.sub("constexpr int kDqWords = 4;",
                                       src[:i] + CONTIG16_KERNEL + src[j:])}
    for t in ("32", "64", "128"):
        if t != threads.group(1):
            copies[f"t{t}"] = THREADS.sub(f"constexpr int kThreads = {t};", src)
    for w in ("2", "4"):
        if w != words.group(1):
            copies[f"dq{w}"] = DQ_WORDS.sub(f"constexpr int kDqWords = {w};", src)
    for t in ("64", "128", "256"):
        if t != dq_threads.group(1):
            copies[f"dq_t{t}"] = DQ_THREADS.sub(f"constexpr int kDqThreads = {t};", src)
    return copies


def _quantize_call(lib):
    """A quantize call as the wrapper makes it (the vector variant)."""
    import torch

    from fedml_tpu_torch.ops import quantize as qz

    def call(x, u):
        n = x.numel()
        shape = qz.noise_shape(n)
        values = torch.empty(shape, dtype=torch.int8, device=x.device)
        scales = torch.empty(shape[0], dtype=torch.float32, device=x.device)
        err = lib.quantize_int8(x.data_ptr(), u.data_ptr(), values.data_ptr(), scales.data_ptr(),
                                n, 1, torch.cuda.current_stream().cuda_stream, None, None)
        if err != 0:
            raise RuntimeError(f"ablate_quant: quantize launch failed with error {err}")
        return values, scales, n
    return call


def _dequantize_call(lib):
    """A dequantize call as the wrapper makes it (the vector variant)."""
    import torch

    def call(values, scales, n):
        out = torch.empty(n, dtype=torch.float32, device=values.device)
        err = lib.dequantize_int8(values.data_ptr(), scales.data_ptr(), out.data_ptr(), n, 1,
                                  torch.cuda.current_stream().cuda_stream, None, None)
        if err != 0:
            raise RuntimeError(f"ablate_quant: dequantize launch failed with error {err}")
        return out
    return call


# the copies that change only the dequantize, or only the quantize
DQ_ONLY = re.compile(r"dq.*|contig16|plain_stores")
Q_ONLY = re.compile(r"u_late|loads4|ldg|t\d+")


def _calls(libs):
    """(quantize calls, dequantize calls): name -> call, each copy where it
    changes a kernel."""
    quant = {name: _quantize_call(lib) for name, lib in libs.items()
             if not DQ_ONLY.fullmatch(name)}
    dequant = {name: _dequantize_call(lib) for name, lib in libs.items()
               if not Q_ONLY.fullmatch(name)}
    return quant, dequant


def _timed(calls, sets, stream):
    """name -> [device ms of each pass], the copies in turn in each pass,
    and the stream's under "stream"."""
    times = {name: [] for name in calls}
    times["stream"] = []
    for _ in range(PASSES):
        for name, call in calls.items():
            times[name].append(_device_ms(call, sets))
        times["stream"].append(_device_ms(stream, sets))
    return times


def _line(what, n, bound_ms, times):
    cells = []
    for name, runs in times.items():
        med = statistics.median(runs)
        cells.append(f"{name} {med * 1e3:.2f} us "
                     f"({min(runs) * 1e3:.2f}-{max(runs) * 1e3:.2f}, "
                     f"{100 * bound_ms / med:.1f}% of bound)")
    print(f"{what} n={n}: bound {bound_ms * 1e3:.2f} us; " + "; ".join(cells))


def _case(quant, dequant, n):
    import torch

    from fedml_tpu_torch.ops import quantize as qz

    dev = torch.device("cuda")
    shape = qz.noise_shape(n)
    blocks = shape[0]
    q_bytes = 4 * n + 4 * blocks * 1024 + blocks * 1024 + 4 * blocks
    dq_bytes = blocks * 1024 + 4 * blocks + 4 * n
    sets = []
    for k in range(max(2, int(3 * L2_BYTES // q_bytes) + 1)):
        g = torch.Generator(device=dev)
        g.manual_seed(500 + k)
        x = torch.randn(n, generator=g, device=dev) * torch.exp(
            3 * torch.randn(n, generator=g, device=dev))
        sets.append((x, torch.rand(shape, generator=g, device=dev)))
    dq_sets = [qz.quantize_int8_reference(*s) for s in sets]
    want_q = dq_sets[0]
    want_dq = qz.dequantize_int8_reference(*want_q)
    for name, call in quant.items():
        got = call(*sets[0])
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want_q[0]) and torch.equal(got[1], want_q[1])):
            raise AssertionError(f"ablate_quant: quantize {name} disagrees with the plain "
                                 f"version at n={n}")
    for name, call in dequant.items():
        got = call(*want_q)
        torch.cuda.synchronize()
        if not torch.equal(got, want_dq):
            raise AssertionError(f"ablate_quant: dequantize {name} disagrees with the plain "
                                 f"version at n={n}")
    q_times = _timed(quant, sets, lambda x, u: torch.lt(x, u.view(-1)[:n]))
    dq_times = _timed(dequant, dq_sets, lambda v, s, m: v.view(-1)[:m].to(torch.float32))
    _line("quantize", n, q_bytes / HBM_BYTES_PER_S * 1e3, q_times)
    _line("dequantize", n, dq_bytes / HBM_BYTES_PER_S * 1e3, dq_times)


def _eager_ms(fn, arg_sets, iters=100, repeats=10, warmup=20):
    """Per-call time of eager calls back to back (CUDA events), host launch
    overhead included: the least of ``repeats`` runs of ``iters`` calls."""
    import torch

    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return min(runs)


def _tree_ops(root: Path, module: str):
    """The ``fedml_tpu_torch/ops/<module>.py`` of the tree at ``root``, as a
    module of a package of another name (its ``__init__`` not run), so that
    it loads beside this tree's; it builds its kernels under that tree."""
    pkg = root / "fedml_tpu_torch"
    for name, path in (("against_tree", pkg), ("against_tree.ops", pkg / "ops")):
        if name not in sys.modules:
            mod = types.ModuleType(name)
            mod.__path__ = [str(path)]
            sys.modules[name] = mod
    return importlib.import_module(f"against_tree.ops.{module}")


def _eager_against(root: Path):
    """Eager calls of both wrappers, this tree's against ``root``'s, at the
    FedSGD gradient's length, in alternating runs; bitwise checked first."""
    import torch

    from fedml_tpu_torch.ops import quantize as qz

    other = _tree_ops(root, "quantize")
    n, dev = LENGTHS[0], torch.device("cuda")
    sets = []
    for k in range(8):
        g = torch.Generator(device=dev)
        g.manual_seed(700 + k)
        sets.append((torch.randn(n, generator=g, device=dev),
                     torch.rand(qz.noise_shape(n), generator=g, device=dev)))
    trees = {"this": qz, "against": other}
    for name, mod in trees.items():
        got = mod.quantize_int8_stochastic(*sets[0])
        want = qz.quantize_int8_reference(*sets[0])
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and torch.equal(mod.dequantize_int8(*got), qz.dequantize_int8_reference(*want))):
            raise AssertionError(f"ablate_quant: {name} tree's kernels disagree with the plain "
                                 "versions")
    dq_sets = [qz.quantize_int8_reference(*s) for s in sets]
    times = {(kern, name): [] for kern in ("quantize", "dequantize") for name in trees}
    for r in range(EAGER_RUNS):
        for name in (("this", "against") if r % 2 else ("against", "this")):
            mod = trees[name]
            times["quantize", name].append(_eager_ms(mod.quantize_int8_stochastic, sets))
            times["dequantize", name].append(_eager_ms(mod.dequantize_int8, dq_sets))
    for kern in ("quantize", "dequantize"):
        print(f"eager {kern} n={n}, {EAGER_RUNS} alternating runs: " + "; ".join(
            f"{name} tree median {statistics.median(v) * 1e3:.2f} us "
            f"({min(v) * 1e3:.2f}-{max(v) * 1e3:.2f})"
            for (k, name), v in times.items() if k == kern))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="also time the wrappers' eager calls against this tree's")
    args = ap.parse_args(argv)

    import torch

    from fedml_tpu_torch.ops import build
    from fedml_tpu_torch.ops import quantize as qz

    if not torch.cuda.is_available():
        print("ablate_quant: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    t0 = time.perf_counter()
    sources = variants(build.SOURCES["quantize"].read_text())
    libs = _build(sources, {name: qz._SIGNATURES for name in sources}, "ablate_quant")
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(libs)}")
    quant, dequant = _calls(libs)
    for n in LENGTHS:
        _case(quant, dequant, n)
    if args.against is not None:
        _eager_against(args.against)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
