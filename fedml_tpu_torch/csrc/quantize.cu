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
// 0.40 us at the H100's 3.35 TB/s, so one launch is latency, not bandwidth.
//
// Design.
// - Quantize: one thread block per quantization block, 256 threads, each
//   holding 4 elements in registers (strided by 256, so a warp's loads are
//   coalesced).  Elements at or past `length` read as 0: no padded copy of x
//   is built.  amax is a warp-shuffle max, then a max over the 8 warps in
//   shared memory; max is exact in any order, so the block's scale does not
//   depend on the reduction order.  The max propagates NaN like jnp.max and
//   torch.amax.  scale and x / scale are IEEE-rounded divides (__fdiv_rn) and
//   the add is __fadd_rn, so nvcc can neither approximate nor contract them:
//   with the same u, values and scales equal the plain PyTorch version
//   bitwise.  (No --use_fast_math.)
// - Dequantize: one thread per output element i < length, reading the int8
//   value and scale[i / 1024]; it writes the sliced output directly.
//
// Interface: plain C, loaded with ctypes.  Every entry point takes device
// pointers and the CUDA stream as void*, sizes as int, launches on that
// stream without synchronising, and returns cudaGetLastError().

#include <cuda_runtime.h>

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

// x: `length` floats; u: blocks * 1024 floats; values: blocks * 1024 int8;
// scales: `blocks` floats.  blocks must be ceil(length / 1024).
int quantize_int8(const void* x, const void* u, void* values, void* scales, int length,
                  int blocks, void* stream) {
  if (length <= 0 || blocks != (length + kBlock - 1) / kBlock) return (int)cudaErrorInvalidValue;
  quantize_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)u, (signed char*)values, (float*)scales,
      (unsigned)length);
  return (int)cudaGetLastError();
}

// values: at least `length` int8 (blocks * 1024); scales: ceil(length / 1024)
// floats; out: `length` floats.
int dequantize_int8(const void* values, const void* scales, void* out, int length,
                    void* stream) {
  if (length <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (length + kThreads - 1) / kThreads;
  dequantize_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const signed char*)values, (const float*)scales, (float*)out, (unsigned)length);
  return (int)cudaGetLastError();
}

}  // extern "C"
