#!/usr/bin/env python3
"""The central-DP noise kernel against variants of its design, on the card.

Run from the repository root on a machine with an NVIDIA card:

    python3 -m fedml_tpu_torch.obs.ablate_noise [--against DIR] [--lengths [N ...]]

Builds ``csrc/noise.cu`` as it is and copies that change one thing (one
``nvcc`` each, all started together, under ``fedml_tpu_torch/_build/``):

- ``was``: the kernel this one replaced, kept here as source
  (:data:`WAS_SOURCE`): a thread per element in 256-thread blocks, 4-byte
  ``__ldg`` loads, a plain store;
- ``k1`` / ``k2`` / ``k4`` (those the source does not use): 1 / 2 / 4
  float4 groups a thread;
- ``wave``: a grid of one resident wave (SMs x the occupancy of a thread
  block) that walks the tiles with a grid stride, in place of one pass (a
  thread block a tile);
- ``loads4``: x and noise in 4-byte loads (the stores still float4);
- ``ldcs`` / ``ldg`` / ``ld`` (those the source does not use): the loads
  evict-first (``__ldcs``), through the read-only path (``__ldg``) or
  plain (cached at every level, as PyTorch's elementwise kernels load);
- ``stcs`` / ``plain_stores`` (the one the source does not use): the
  stores evict-first (``__stcs``) or plain.

Beside them ``scalar`` (the source's scalar variant on the same aligned
operands) and the same-bytes stream, ``torch.add(x, noise, alpha=sigma)``,
the one PyTorch call that computes the same function.  Each is timed as
``chip_smoke.py`` times the kernels (CUDA-graph replays of one call per
input set, the sets rotated through more than twice the 50 MB L2, the
output allocated by each call as the wrapper does) at the SecAgg vector's
271,098 elements and at 2^24 (or at ``--lengths``), in :data:`PASSES`
passes over the copies in turn (median and spread).  Every copy is checked
bitwise against the plain version at each length before it is timed.
Prints the card, each copy's registers, and one line per length.

Then the path case: the launch and what reads its output next on the
cross-silo path, timed for the kernel against its copy with the other store
policy.  On the path, the flat model the kernel writes is unravelled into
the global's leaves (a copy of each convolution kernel, permuted back) and
the broadcast copies every leaf to the host.  One CUDA graph holds that for
each input set (the host buffers page-locked), at ResNet-20's 271,098
elements, in :data:`PASSES` alternating passes, the host copies checked
bitwise each pass.  A store that keeps ``out`` in the L2 would show here
as a shorter path.

``--against DIR`` also times the wrapper's eager calls (host included, as
the path pays them) at 271,098 against those of the tree unpacked at
``DIR`` (its ``fedml_tpu_torch/ops/noise.py`` and the kernel it builds),
in :data:`EAGER_RUNS` alternating runs, each the least of 10 runs of 100
calls back to back; it prints each side's median and spread.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

from fedml_tpu_torch.obs.ablate_bwd import HBM_BYTES_PER_S, L2_BYTES, _build, _device_ms
from fedml_tpu_torch.obs.ablate_quant import _eager_ms, _tree_ops

LENGTHS = [271098, 2**24]
PASSES = 7
EAGER_RUNS = 9
# the places in the source that the copies patch
GROUPS = re.compile(r"constexpr int kGroups = (\d+);")
LOADS = {"ldcs": "T ld(const T* p) { return __ldcs(p); }",
         "ldg": "T ld(const T* p) { return __ldg(p); }",
         "ld": "T ld(const T* p) { return *p; }"}
STORES = {"stcs": "void st(T* p, T v) { __stcs(p, v); }",
          "plain_stores": "void st(T* p, T v) { *p = v; }"}
VEC_LOAD = "  if (VEC) return ld(reinterpret_cast<const float4*>(p));\n"
ONE_PASS_GRID = "unsigned noise_grid(unsigned length) { return (length + kTile - 1) / kTile; }"
WAVE_GRID = """unsigned noise_grid(unsigned length) {
  static unsigned wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, (const void*)gaussian_noise_kernel<true>, kThreads, 0);
    wave = (unsigned)(sms * per_sm);
  }
  const unsigned tiles = (length + kTile - 1) / kTile;
  return tiles < wave ? tiles : wave;
}"""
# The kernel this one replaced: a thread per element.
WAS_SOURCE = r"""#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gaussian_noise_kernel(const float* __restrict__ x, const float* __restrict__ noise, float sigma,
                      float* __restrict__ out, unsigned length) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i < length) out[i] = __fadd_rn(__ldg(x + i), __fmul_rn(__ldg(noise + i), sigma));
}

}  // namespace

extern "C" {

// The entry point takes the arguments of today's (the variant flag unused).
// x, out: `length` floats; noise: at least `length` floats (the padded draw).
int gaussian_noise(const void* x, const void* noise, float sigma, void* out, int length, int,
                   void* stream) {
  if (length <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (length + kThreads - 1) / kThreads;
  gaussian_noise_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)noise, sigma, (float*)out, (unsigned)length);
  return (int)cudaGetLastError();
}

}  // extern "C"
"""


def variants(src: str) -> dict:
    """copy name -> source: the kernel as it is (``final``), the replaced
    one (``was``) and the copies that each change one thing."""
    groups = GROUPS.search(src)
    loads = [name for name, text in LOADS.items() if text in src]
    stores = [name for name, text in STORES.items() if text in src]
    if groups is None or len(loads) != 1 or len(stores) != 1 or any(
            mark not in src for mark in (VEC_LOAD, ONE_PASS_GRID)):
        raise RuntimeError("ablate_noise: the kernel source lacks a place the copies patch "
                           "(kGroups, a known load or store policy, the vector load or the "
                           "one-pass grid)")
    copies = {"final": src, "was": WAS_SOURCE, "loads4": src.replace(VEC_LOAD, ""),
              "wave": src.replace(ONE_PASS_GRID, WAVE_GRID)}
    for k in ("1", "2", "4"):
        if k != groups.group(1):
            copies[f"k{k}"] = GROUPS.sub(f"constexpr int kGroups = {k};", src)
    for name, text in LOADS.items():
        if name != loads[0]:
            copies[name] = src.replace(LOADS[loads[0]], text)
    for name, text in STORES.items():
        if name != stores[0]:
            copies[name] = src.replace(STORES[stores[0]], text)
    return copies


def _noise_call(lib, vec=1):
    """A call as the wrapper makes it (the vector variant unless ``vec`` is
    0)."""
    import torch

    def call(x, noise, sigma):
        out = torch.empty_like(x)
        err = lib.gaussian_noise(x.data_ptr(), noise.data_ptr(), sigma, out.data_ptr(), x.numel(),
                                 vec, torch.cuda.current_stream().cuda_stream, None, None)
        if err != 0:
            raise RuntimeError(f"ablate_noise: launch failed with error {err}")
        return out
    return call


def _sets(n, seed):
    import torch

    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.trust.dp.dp import gaussian_sigma

    dev = torch.device("cuda")
    sigma = gaussian_sigma(50.0, 1e-5, 0.01)  # the cross-silo path's DP sigma
    sets = []
    for k in range(max(2, int(3 * L2_BYTES // (12 * n)) + 1)):
        g = torch.Generator(device=dev)
        g.manual_seed(seed + k)
        sets.append((torch.randn(n, generator=g, device=dev),
                     torch.randn(nz.noise_shape(n), generator=g, device=dev), sigma))
    return sets


def _case(calls, n):
    import torch

    from fedml_tpu_torch.ops import noise as nz

    sets = _sets(n, 900)
    want = nz.apply_gaussian_noise_reference(*sets[0])
    for name, call in calls.items():
        got = call(*sets[0])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"ablate_noise: {name} disagrees with the plain version at n={n}")
    calls = {**calls, "torch.add": lambda x, noise, s: torch.add(x, noise.view(-1)[:n], alpha=s)}
    times = {name: [] for name in calls}
    for _ in range(PASSES):
        for name, call in calls.items():
            times[name].append(_device_ms(call, sets))
    bound_ms = 12 * n / HBM_BYTES_PER_S * 1e3
    cells = []
    for name, runs in times.items():
        med = statistics.median(runs)
        cells.append(f"{name} {med * 1e3:.3f} us ({min(runs) * 1e3:.3f}-{max(runs) * 1e3:.3f}, "
                     f"{100 * bound_ms / med:.1f}% of bound)")
    print(f"noise n={n}: bound {bound_ms * 1e3:.2f} us; " + "; ".join(cells))


def _path(calls):
    """The launch and its readers on the cross-silo path (the unravel, then
    also the host copy), for the kernel (``final``) and its copy with the
    other store policy, in alternating passes; each pass with the host copy
    checks it bitwise."""
    import torch

    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core.pytree import tree_leaves
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.ops import noise as nz

    names = [name for name in ("final", *STORES) if name in calls]
    tree = resnet.resnet20().init(torch.Generator().manual_seed(0), torch.device("cuda"))
    flat, unravel = weights.flatten_reference(tree)
    n = flat.numel()
    host = torch.empty(n)
    if torch.cuda.cudart().cudaHostRegister(host.data_ptr(), 4 * n, 0) != 0:
        raise RuntimeError("ablate_noise: cannot page-lock the host buffer")
    offsets = [0]
    for leaf in tree_leaves(unravel(flat)):
        offsets.append(offsets[-1] + leaf.numel())
    views = [host[a:b] for a, b in zip(offsets, offsets[1:])]

    def path(call, to_host):
        def run(x, noise, sigma):
            leaves = tree_leaves(unravel(call(x, noise, sigma)))
            if to_host:
                for view, leaf in zip(views, leaves):
                    view.copy_(leaf.reshape(-1), non_blocking=True)
        return run

    sets = _sets(n, 970)
    want = torch.cat([t.reshape(-1) for t in
                      tree_leaves(unravel(nz.apply_gaussian_noise_reference(*sets[-1])))]).cpu()
    cases = [(name, to_host) for to_host in (False, True) for name in names]
    times = {case: [] for case in cases}
    for r in range(PASSES):
        for name, to_host in (cases if r % 2 else cases[::-1]):
            times[name, to_host].append(_device_ms(path(calls[name], to_host), sets))
            if to_host and not torch.equal(host, want):
                raise AssertionError(f"ablate_noise: the path through {name} disagrees with the "
                                     "plain version")
    torch.cuda.cudart().cudaHostUnregister(host.data_ptr())
    for to_host in (False, True):
        what = f"launch, unravel{f', {len(views)} leaves to the host' if to_host else ''}"
        print(f"noise path n={n} ({what}): " + "; ".join(
            f"{name} {statistics.median(v) * 1e3:.3f} us ({min(v) * 1e3:.3f}-"
            f"{max(v) * 1e3:.3f})" for (name, h), v in times.items() if h == to_host))

def _eager_against(root: Path):
    """Eager calls of the wrapper, this tree's against ``root``'s, at the
    SecAgg vector's length, in alternating runs; bitwise checked first."""
    import torch

    from fedml_tpu_torch.ops import noise as nz

    trees = {"this": nz, "against": _tree_ops(root, "noise")}
    n = LENGTHS[0]
    sets = _sets(n, 950)[:8]
    want = nz.apply_gaussian_noise_reference(*sets[0])
    for name, mod in trees.items():
        if not torch.equal(mod.apply_gaussian_noise(*sets[0]), want):
            raise AssertionError(f"ablate_noise: {name} tree's kernel disagrees with the plain "
                                 "version")
    times = {name: [] for name in trees}
    for r in range(EAGER_RUNS):
        for name in (("this", "against") if r % 2 else ("against", "this")):
            times[name].append(_eager_ms(trees[name].apply_gaussian_noise, sets))
    print(f"eager noise n={n}, {EAGER_RUNS} alternating runs: " + "; ".join(
        f"{name} tree median {statistics.median(v) * 1e3:.2f} us "
        f"({min(v) * 1e3:.2f}-{max(v) * 1e3:.2f})" for name, v in times.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="also time the wrapper's eager calls against this tree's")
    ap.add_argument("--lengths", type=int, nargs="*", default=LENGTHS,
                    help=f"vector lengths to time (default {LENGTHS}; none: the path case "
                         "alone)")
    args = ap.parse_args(argv)

    import torch

    from fedml_tpu_torch.ops import build
    from fedml_tpu_torch.ops import noise as nz

    if not torch.cuda.is_available():
        print("ablate_noise: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    t0 = time.perf_counter()
    sources = variants(build.SOURCES["noise"].read_text())
    libs = _build(sources, {name: nz._SIGNATURES for name in sources}, "ablate_noise")
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(libs)}")
    calls = {name: _noise_call(lib) for name, lib in libs.items()}
    calls["scalar"] = _noise_call(libs["final"], vec=0)
    for n in args.lengths:
        _case(calls, n)
    _path(calls)
    if args.against is not None:
        _eager_against(args.against)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
