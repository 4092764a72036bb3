// Block-scaled stochastic int8 quantization for Hopper (sm_90a): the
// FedSGD `qsgd_int8` gradient compressor.
//
// Replaces the two Pallas TPU kernels of fedml_tpu/ops/pallas/quantize.py:
//   quantize_int8    <- _quantize_kernel    (L37, pallas_call in _quantize_impl L75)
//   dequantize_int8  <- _dequantize_kernel  (L50, pallas_call in _dequantize_impl L107)
//
// Semantics (per block of 1024 elements, the TPU's (8, 128) f32 tile):
//   amax  = max |x|                      (x zero past `length`)
//   scale = amax / 127 + 1e-12
//   q     = clip(floor(x / scale + u), -127, 127) as int8,  u ~ U[0, 1) given
//   out   = float(q) * scale[block]      (dequantize, first `length` elements)
//
// Bound.  Both are single passes that do a few flops per element, so device
// memory bounds them.  Quantize reads x (4 * length bytes) and u (4 * B * 1024)
// and writes the int8 values (B * 1024) and the scales (4 * B); dequantize
// reads values and scales and writes 4 * length.  At the ResNet-20 gradient
// (269,722 elements, B = 264) that is 2.43 MB and 1.35 MB: 0.73 us and
// 0.40 us at the H100's 3.35 TB/s, so one launch there is latency; at 2^24
// elements it is 45 us and 25 us of bandwidth.
//
// Design (each choice measured on an H100 SXM at 700 W against copies that
// change it, fedml_tpu_torch/obs/ablate_quant.py).
// - Quantize: a 256-thread block per quantization block, a float4 of x and
//   a float4 of u a thread (each 16-byte load of a warp covers 512
//   contiguous bytes), both issued before the first use: a block pays one
//   round trip to device memory, not one for x and then one for u.  amax
//   is a butterfly of warp shuffles, then the 8 warps' maxima through
//   shared memory behind one barrier, folded by every thread in the same
//   order; max is exact in any order, so the scale does not depend on the
//   reduction order.  The max propagates NaN like torch.amax.  Elements at
//   or past `length` read as 0 (no padded copy of x; the float4 that
//   straddles it is read element by element); u and the values cover whole
//   blocks.  Each float4's four int8 go out as one 32-bit store.  Many
//   small thread blocks keep the per-thread work short: one warp a
//   quantization block (32 elements and divides a lane) took 5.9 us at the
//   FedSGD gradient (269,722 elements), this 2.7 us.
// - Dequantize: a warp per 128 values, 256-thread blocks; lane l loads the
//   word of 4 int8 at 4 * l (128 contiguous bytes a warp) and stores their
//   float4 (512 contiguous bytes).  16 consecutive values a thread (one
//   16-byte load, four float4 stores 64 bytes apart across the lanes) ran
//   at 45% of the bound at 2^24, this at 80%: the stores must be contiguous
//   across the warp.  More words a lane (2, 4) and smaller thread blocks
//   measured the same or slower.
// - Each kernel has a vector variant (float4 loads and stores, packed int8
//   words; the operands must be 16-byte aligned) and a scalar one of the
//   same template (4-byte float loads, byte loads and stores) for operands
//   off a 16-byte line; the wrapper picks.
// - Numerics: scale and x / scale are IEEE-rounded divides (__fdiv_rn), the
//   add is __fadd_rn and the dequantize multiply __fmul_rn, so nvcc can
//   neither approximate nor contract them (no --use_fast_math): with the
//   same u, values, scales and the dequantized vector equal the plain
//   PyTorch version bitwise.  The clip keeps a NaN (as torch.clamp does),
//   and a NaN level converts to 0, as PyTorch's cast to int8 gives it.
// - Cache policy: every operand is read once and the dequantized vector
//   is not read back by the kernel, so the quantize's loads and the
//   dequantize's stores are evict-first (__ldcs, __stcs).  Through the
//   read-only path (__ldg) the quantize took 2.93 against 2.75 us at the
//   FedSGD gradient and 51.9 against 47.8 us at 2^24.  The dequantize's
//   loads go through the read-only path (__ldg), chosen at the gradient's
//   length, the one a path runs: 1.53 us against 1.60 and 1.54 evict-first
//   in two runs; at 2^24, which no path runs, evict-first is 0.3 us (1%)
//   faster in both.
//
// Interface: plain C, loaded with ctypes.  Every entry point takes device
// pointers and the CUDA stream as void*, sizes as int, sizes its launch
// from the length, launches on that stream without synchronising or
// allocating (so a CUDA graph can capture it), and returns
// cudaGetLastError().  Each also takes two CUDA events, start and stop
// (ops/timing.py's pair, or both null), and records them on the stream just
// before and just after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;                  // elements per quantization block (8 x 128)
constexpr int kThreads = 256;                 // threads of a quantization block's thread block
constexpr int kPerThread = kBlock / (4 * kThreads);  // float4 of x (and of u) a thread
constexpr int kWarps = kThreads / 32;
constexpr int kDqWords = 1;                   // 4-value words a dequantize thread
constexpr int kDqSpan = 128 * kDqWords;       // values a dequantize warp
constexpr int kDqThreads = 256;               // threads a dequantize thread block
static_assert(kPerThread >= 1 && kBlock % kDqSpan == 0, "a warp's values share one scale");

// max that propagates NaN (jnp.max / torch.amax)
__device__ __forceinline__ float nanmax(float a, float b) { return (a > b || a != a) ? a : b; }

// a quantize operand load: each byte is read once, so evict-first
template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldcs(p); }

// a dequantize operand load, through the read-only path
template <typename T>
__device__ __forceinline__ T ld_dq(const T* p) { return __ldg(p); }

// p[0..3]: one 16-byte load in the vector variant (p 16-byte aligned)
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p) {
  if (VEC) return ld(reinterpret_cast<const float4*>(p));
  return make_float4(ld(p), ld(p + 1), ld(p + 2), ld(p + 3));
}

// x[e..e+3], zero at or past `length`: the float4 that straddles it is read
// element by element
template <bool VEC>
__device__ __forceinline__ float4 load_x(const float* x, unsigned e, unsigned length) {
  if (e + 4 <= length) return load4<VEC>(x + e);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (e < length) v.x = ld(x + e);
  if (e + 1 < length) v.y = ld(x + e + 1);
  if (e + 2 < length) v.z = ld(x + e + 2);
  return v;
}

// clip(floor(x / scale + u), -127, 127) as the int8's byte; the clip keeps a
// NaN and the cast takes it to 0
__device__ __forceinline__ unsigned level(float x, float u, float scale) {
  float q = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  q = q < -127.f ? -127.f : (q > 127.f ? 127.f : q);
  return (unsigned)(unsigned char)(signed char)(q == q ? (int)q : 0);
}

// the four levels of x / u at p: one 32-bit store in the vector variant
template <bool VEC>
__device__ __forceinline__ void store4(signed char* p, float4 x, float4 u, float scale) {
  const unsigned q0 = level(x.x, u.x, scale), q1 = level(x.y, u.y, scale),
                 q2 = level(x.z, u.z, scale), q3 = level(x.w, u.w, scale);
  if (VEC) {
    *reinterpret_cast<unsigned*>(p) = q0 | q1 << 8 | q2 << 16 | q3 << 24;
  } else {
    p[0] = (signed char)q0;
    p[1] = (signed char)q1;
    p[2] = (signed char)q2;
    p[3] = (signed char)q3;
  }
}

// A thread block per quantization block; thread t holds the float4 at
// 4 * (t + kThreads * k), k < kPerThread.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ u,
                signed char* __restrict__ values, float* __restrict__ scales,
                unsigned length) {
  const unsigned t = threadIdx.x, qb = blockIdx.x;
  const unsigned base = qb * kBlock + 4 * t;
  float4 xv[kPerThread], uv[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) xv[k] = load_x<VEC>(x, base + 4 * kThreads * k, length);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) uv[k] = load4<VEC>(u + base + 4 * kThreads * k);
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    amax = nanmax(amax, fabsf(xv[k].x));
    amax = nanmax(amax, fabsf(xv[k].y));
    amax = nanmax(amax, fabsf(xv[k].z));
    amax = nanmax(amax, fabsf(xv[k].w));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nanmax(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if constexpr (kWarps > 1) {
    // every thread folds the warps' maxima in the same order
    __shared__ float s_warp[kWarps];
    if ((t & 31) == 0) s_warp[t >> 5] = amax;
    __syncthreads();
    amax = s_warp[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) amax = nanmax(amax, s_warp[w]);
  }
  const float scale = __fadd_rn(__fdiv_rn(amax, 127.f), 1e-12f);
  if (t == 0) scales[qb] = scale;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    store4<VEC>(values + base + 4 * kThreads * k, xv[k], uv[k], scale);
}

// A warp per kDqSpan values; lane l takes the words of 4 values at
// base + 4 * (l + 32 * k), k < kDqWords, so each load of the warp covers
// 128 contiguous bytes and each store 512.
template <bool VEC>
__global__ void __launch_bounds__(kDqThreads)
dequantize_kernel(const signed char* __restrict__ values, const float* __restrict__ scales,
                  float* __restrict__ out, unsigned length) {
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const unsigned base = warp * kDqSpan + 4 * (threadIdx.x & 31);
  if (base >= length) return;
  // values cover whole blocks, so every word is there to load
  unsigned w[kDqWords];
#pragma unroll
  for (int k = 0; k < kDqWords; ++k) {
    const signed char* p = values + base + 128 * k;
    if (VEC) {
      w[k] = ld_dq(reinterpret_cast<const unsigned*>(p));
    } else {
      w[k] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) w[k] |= (unsigned)(unsigned char)ld_dq(p + j) << (8 * j);
    }
  }
  const float scale = ld_dq(scales + warp * kDqSpan / kBlock);
#pragma unroll
  for (int k = 0; k < kDqWords; ++k) {
    const unsigned e = base + 128 * k;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __fmul_rn((float)(signed char)(w[k] >> (8 * j)), scale);
    if (VEC && e + 4 <= length) {
      __stcs(reinterpret_cast<float4*>(out + e), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e + j < length) __stcs(out + e + j, v[j]);
    }
  }
}

bool aligned16(const void* a, const void* b, const void* c) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15u) == 0;
}

// thread blocks of a launch over `length` elements
unsigned quantize_grid(unsigned length) { return (length + kBlock - 1) / kBlock; }
unsigned dequantize_grid(unsigned length) {
  return ((length + kDqSpan - 1) / kDqSpan * 32 + kDqThreads - 1) / kDqThreads;
}

// Records event (where given) on stream.
cudaError_t record(void* event, void* stream) {
  return event ? cudaEventRecord((cudaEvent_t)event, (cudaStream_t)stream) : cudaSuccess;
}

// The launch's error, then stop recorded after it.
int launched(void* stream, void* stop) {
  const cudaError_t err = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : record(stop, stream));
}

}  // namespace

extern "C" {

// x: `length` floats; u: ceil(length / 1024) * 1024 floats; values as many
// int8; scales: ceil(length / 1024) floats.  vec != 0 takes the vector
// variant (x, u and values 16-byte aligned).
int quantize_int8(const void* x, const void* u, void* values, void* scales, int length, int vec,
                  void* stream, void* start, void* stop) {
  if (length <= 0 || (vec && !aligned16(x, u, values))) return (int)cudaErrorInvalidValue;
  const unsigned grid = quantize_grid((unsigned)length);
  const cudaError_t err = record(start, stream);
  if (err != cudaSuccess) return (int)err;
  if (vec)
    quantize_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)u, (signed char*)values, (float*)scales, (unsigned)length);
  else
    quantize_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)u, (signed char*)values, (float*)scales, (unsigned)length);
  return launched(stream, stop);
}

// values: ceil(length / 1024) * 1024 int8; scales: ceil(length / 1024)
// floats; out: `length` floats.  vec != 0 takes the vector variant (values
// and out 16-byte aligned).
int dequantize_int8(const void* values, const void* scales, void* out, int length, int vec,
                    void* stream, void* start, void* stop) {
  if (length <= 0 || (vec && !aligned16(values, out, nullptr))) return (int)cudaErrorInvalidValue;
  const unsigned grid = dequantize_grid((unsigned)length);
  const cudaError_t err = record(start, stream);
  if (err != cudaSuccess) return (int)err;
  if (vec)
    dequantize_kernel<true><<<grid, kDqThreads, 0, (cudaStream_t)stream>>>(
        (const signed char*)values, (const float*)scales, (float*)out, (unsigned)length);
  else
    dequantize_kernel<false><<<grid, kDqThreads, 0, (cudaStream_t)stream>>>(
        (const signed char*)values, (const float*)scales, (float*)out, (unsigned)length);
  return launched(stream, stop);
}

}  // extern "C"
