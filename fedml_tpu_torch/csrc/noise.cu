// Central-DP Gaussian noise for Hopper (sm_90a): the one noise draw that
// streaming Shamir SecAgg adds to the unmasked aggregate at finalize.
//
// Replaces the Pallas TPU kernel of fedml_tpu/ops/pallas/noise.py:
//   gaussian_noise  <- _noise_kernel  (L33, pallas_call in _noise_impl L64)
//
// Semantics: out[i] = x[i] + noise[i] * sigma for i < length, the multiply
// rounded, then the add (the reference's written order and its eager jnp
// oracle's result).  `noise` is the padded (blocks, 8, 128) N(0, 1) draw,
// read flat; only its first `length` elements are read.  The reference pads
// x with zeros and slices the output, so the kernel needs no padded copy of
// x.  `sigma` arrives as an f32 by value (the Python float rounded to f32,
// as jnp.float32(sigma) does).
//
// Bound.  One multiply and one add per element; device memory bounds it.  It
// reads x and the first `length` noise values and writes out: 12 * length
// bytes, 0.97 us at the SecAgg vector (271,098 elements: ResNet-20's
// parameters and BN statistics) and 60.1 us at 2^24 at the H100's 3.35 TB/s.
// At the vector's size one launch is mostly launch latency and one round
// trip to device memory, not bandwidth.
//
// Design (each choice measured on an H100 SXM at 700 W against copies that
// change it, fedml_tpu_torch/obs/ablate_noise.py).
// - 16-byte accesses: a thread owns kGroups float4 groups of x, of noise and
//   of out.  Group k of thread t of a tile starts at element
//   4 * (t + kThreads * k), so each 16-byte access of a warp covers 512
//   contiguous bytes (stores too: a warp's store fills whole lines).
// - Loads issued together: every x and noise load of a thread goes out
//   before the first multiply, 32 * kGroups bytes in flight a thread, one
//   round trip to device memory a tile.
// - Launch geometry in the C entry (noise_grid): one pass, a tile of
//   4 * kThreads * kGroups elements a thread block.  The kernel walks tiles
//   with a grid stride, so a grid smaller than the tile count (one
//   resident wave) is the same code.
// - A whole tile takes the unguarded path; the tile that holds the end of
//   the vector checks each group, and the group that straddles the end is
//   read and written element by element (271,098 = 4 * 67,774 + 2).
// - A vector variant (float4 accesses; x, noise and out 16-byte aligned)
//   and a scalar one of the same template (4-byte accesses) for operands
//   off a 16-byte line, e.g. x a view into a larger buffer; the wrapper
//   picks.
// - Numerics: __fmul_rn / __fadd_rn keep nvcc from contracting the pair
//   into an FMA (no --use_fast_math), so the result equals the plain
//   PyTorch version bitwise.
// - Cache policy: every byte is touched once, so the loads and the stores
//   are evict-first (__ldcs, __stcs) at every length.
//
// Interface: plain C, loaded with ctypes.  The entry point takes device
// pointers and the CUDA stream as void*, sizes its launch from the length,
// launches on that stream without synchronising or allocating (so a CUDA
// graph can capture it), and returns cudaGetLastError().  It also takes two
// CUDA events, start and stop (ops/timing.py's pair, or both null), and
// records them on the stream just before and just after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                           // threads a thread block
constexpr int kGroups = 2;                              // float4 groups a thread
constexpr unsigned kTile = 4u * kThreads * kGroups;     // elements a thread block

// an operand load: each byte is read once, so evict-first
template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldcs(p); }

// an output store: each byte is written once, so evict-first
template <typename T>
__device__ __forceinline__ void st(T* p, T v) { __stcs(p, v); }

// p[0..3]: one 16-byte load in the vector variant (p 16-byte aligned)
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p) {
  if (VEC) return ld(reinterpret_cast<const float4*>(p));
  return make_float4(ld(p), ld(p + 1), ld(p + 2), ld(p + 3));
}

// p[e..e+3]; an element at or past `length` is not read (0)
template <bool VEC, bool WHOLE>
__device__ __forceinline__ float4 load_group(const float* p, unsigned e, unsigned length) {
  if (WHOLE || e + 4 <= length) return load4<VEC>(p + e);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (e < length) v.x = ld(p + e);
  if (e + 1 < length) v.y = ld(p + e + 1);
  if (e + 2 < length) v.z = ld(p + e + 2);
  return v;
}

// out[e..e+3] = v, the elements before `length` only
template <bool VEC, bool WHOLE>
__device__ __forceinline__ void store_group(float* p, unsigned e, unsigned length, float4 v) {
  if (WHOLE || e + 4 <= length) {
    if (VEC) {
      st(reinterpret_cast<float4*>(p + e), v);
    } else {
      st(p + e, v.x);
      st(p + e + 1, v.y);
      st(p + e + 2, v.z);
      st(p + e + 3, v.w);
    }
    return;
  }
  if (e < length) st(p + e, v.x);
  if (e + 1 < length) st(p + e + 1, v.y);
  if (e + 2 < length) st(p + e + 2, v.z);
}

__device__ __forceinline__ float noised(float x, float n, float sigma) {
  return __fadd_rn(x, __fmul_rn(n, sigma));
}

// One tile of kTile elements from `first`; WHOLE: the tile lies before
// `length`.
template <bool VEC, bool WHOLE>
__device__ __forceinline__ void noise_tile(const float* __restrict__ x,
                                           const float* __restrict__ noise, float sigma,
                                           float* __restrict__ out, unsigned first,
                                           unsigned length) {
  const unsigned base = first + 4 * threadIdx.x;
  float4 xv[kGroups], nv[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k)
    xv[k] = load_group<VEC, WHOLE>(x, base + 4 * kThreads * k, length);
#pragma unroll
  for (int k = 0; k < kGroups; ++k)
    nv[k] = load_group<VEC, WHOLE>(noise, base + 4 * kThreads * k, length);
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const float4 v = make_float4(noised(xv[k].x, nv[k].x, sigma), noised(xv[k].y, nv[k].y, sigma),
                                 noised(xv[k].z, nv[k].z, sigma), noised(xv[k].w, nv[k].w, sigma));
    store_group<VEC, WHOLE>(out, base + 4 * kThreads * k, length, v);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gaussian_noise_kernel(const float* __restrict__ x, const float* __restrict__ noise, float sigma,
                      float* __restrict__ out, unsigned length) {
  const unsigned tiles = (length + kTile - 1) / kTile;
  for (unsigned tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if ((tile + 1) * kTile <= length)
      noise_tile<VEC, true>(x, noise, sigma, out, tile * kTile, length);
    else
      noise_tile<VEC, false>(x, noise, sigma, out, tile * kTile, length);
  }
}

bool aligned16(const void* a, const void* b, const void* c) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15u) == 0;
}

// thread blocks of a launch over `length` elements: one pass
unsigned noise_grid(unsigned length) { return (length + kTile - 1) / kTile; }

template <bool VEC>
int launch(const void* x, const void* noise, float sigma, void* out, unsigned length,
           cudaStream_t stream, cudaEvent_t start, cudaEvent_t stop) {
  if (start) {
    const cudaError_t err = cudaEventRecord(start, stream);
    if (err != cudaSuccess) return (int)err;
  }
  gaussian_noise_kernel<VEC><<<noise_grid(length), kThreads, 0, stream>>>(
      (const float*)x, (const float*)noise, sigma, (float*)out, length);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !stop) return (int)err;
  return (int)cudaEventRecord(stop, stream);
}

}  // namespace

extern "C" {

// x, out: `length` floats; noise: at least `length` floats (the padded
// draw).  vec != 0 takes the vector variant (x, noise and out 16-byte
// aligned).
int gaussian_noise(const void* x, const void* noise, float sigma, void* out, int length, int vec,
                   void* stream, void* start, void* stop) {
  if (length <= 0 || (vec && !aligned16(x, noise, out))) return (int)cudaErrorInvalidValue;
  const unsigned n = (unsigned)length;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaEvent_t e0 = (cudaEvent_t)start, e1 = (cudaEvent_t)stop;
  return vec ? launch<true>(x, noise, sigma, out, n, s, e0, e1)
             : launch<false>(x, noise, sigma, out, n, s, e0, e1);
}

}  // extern "C"
