// Central-DP Gaussian noise for Hopper (sm_90a): the one noise draw that
// streaming Shamir SecAgg adds to the unmasked aggregate at finalize.
//
// Replaces the Pallas TPU kernel of fedml_tpu/ops/pallas/noise.py:
//   gaussian_noise  <- _noise_kernel  (L33, pallas_call in _noise_impl L64)
//
// Semantics: out[i] = x[i] + noise[i] * sigma for i < length, the multiply
// rounded, then the add (the reference's written order and its eager jnp
// oracle's result).  `noise` is the padded (blocks, 8, 128) N(0, 1) draw,
// read flat; only its first `length` elements are used.  The reference pads x
// with zeros and slices the output, so the kernel needs no padded copy of x.
// `sigma` arrives as an f32 by value (the Python float rounded to f32, as
// jnp.float32(sigma) does).
//
// Bound.  One multiply and one add per element; device memory bounds it.  It
// reads x and the first `length` noise values and writes out: 12 * length
// bytes, 0.97 us at the ResNet-20 aggregate (269,722 elements) and 60 us at
// 2^24 at the H100's 3.35 TB/s.  At the aggregate's size one launch is
// launch latency, not bandwidth.
//
// Design.  One thread per element, 256 threads a block, neighbouring threads
// on neighbouring addresses (coalesced 4-byte loads).  __fmul_rn / __fadd_rn
// keep nvcc from contracting the pair into an FMA (no --use_fast_math), so
// the result equals the plain PyTorch version bitwise.  16-byte vector loads
// are later work: at the main path's size the launch dominates.
//
// Interface: plain C, loaded with ctypes.  The entry point takes device
// pointers and the CUDA stream as void*, launches on that stream without
// synchronising, and returns cudaGetLastError().

#include <cuda_runtime.h>

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

// x, out: `length` floats; noise: at least `length` floats (the padded draw).
int gaussian_noise(const void* x, const void* noise, float sigma, void* out, int length,
                   void* stream) {
  if (length <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (length + kThreads - 1) / kThreads;
  gaussian_noise_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)noise, sigma, (float*)out, (unsigned)length);
  return (int)cudaGetLastError();
}

}  // extern "C"
