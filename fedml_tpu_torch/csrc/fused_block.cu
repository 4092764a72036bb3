// Fused BasicBlock epilogue kernels for Hopper (sm_90a): BN scale/shift
// apply, optional residual add, ReLU, and their backward passes.
//
// Replaces the four Pallas TPU kernels of fedml_tpu/ops/pallas/fused_block.py:
//   fused_fwd (no residual)  <- _fwd_kernel      (L91, pallas_call in _fwd_call L108)
//   fused_fwd (residual)     <- _fwd_res_kernel  (L85, pallas_call in _fwd_call L108)
//   fused_bwd (no residual)  <- _bwd_kernel      (L142, pallas_call in _bwd_call L187)
//   fused_bwd (residual)     <- _bwd_res_kernel  (L126, pallas_call in _bwd_call L173)
//
// Bound.  All four are elementwise passes over an NHWC activation with a
// per-channel vector, so device memory bounds them, not arithmetic: at the
// flagship stage-1 shape (128, 32, 32, 16) in bf16 the forward moves 8.4 MB
// (12.6 MB with the residual) and the backward 16.8 MB (21.0 MB with dr):
// 2.5 us to 6.3 us at the H100's 3.35 TB/s.  A few flops per element are far
// below the 67 TFLOP/s f32 rate.
//
// Design.
// - Forward: one grid-stride pass over the flat tensor; the channel of flat
//   element i is i % C for any C (NHWC), and scale/shift are read as f32
//   through the read-only cache.  The f32 math is __fadd_rn(__fmul_rn(y, s), b)
//   (+ r), so nvcc cannot contract it into an FMA: the result equals the
//   plain PyTorch version (y * s + b, two roundings) bitwise.
// - Backward: the TPU kernel summed d_scale / d_shift into one tile across a
//   grid that runs in order.  GPU blocks run concurrently, so the reduction is
//   two-staged and uses no atomics, which keeps gradients identical from run
//   to run.  Stage 1: each block owns a contiguous range of rows (pixels) and
//   a tile of at most 256 channels; a thread keeps one channel for its whole
//   life (the block's thread count is a multiple of the tile width), writes
//   dy (and dr) elementwise, and accumulates its channel's partial sums in
//   registers; the block folds its threads' sums in shared memory in a fixed
//   order and writes a (blocks, C) f32 scratch row.  Stage 2: one block per
//   channel sums the scratch column in a fixed order (strided loop + tree).
//   The ReLU mask is out > 0, read from the saved output; no mask is stored.
//
// Interface: plain C, loaded with ctypes.  Every entry point takes device
// pointers and the CUDA stream as void*, sizes as int, launches on that
// stream without synchronising, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFwdBlocks = 132 * 16;
constexpr int kMaxRowBlocks = 1024;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// relu that propagates NaN like jnp.maximum / torch.relu
__device__ __forceinline__ float relu_f32(float z) { return (z > 0.f || z != z) ? z : 0.f; }

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ y, const float* __restrict__ scale,
           const float* __restrict__ shift, const T* __restrict__ res,
           T* __restrict__ out, unsigned n, unsigned C) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const unsigned c = i % C;
    float z = __fadd_rn(__fmul_rn(to_f32(y[i]), __ldg(scale + c)), __ldg(shift + c));
    if (kResidual) z = __fadd_rn(z, to_f32(res[i]));
    out[i] = from_f32<T>(relu_f32(z));
  }
}

// Stage 1.  Block (bx, by) covers rows [bx * rows_per_block, ...) and
// channels [by * cb, by * cb + cb); blockDim.x == cb * rb, so thread t keeps
// channel by * cb + t % cb and walks rows t / cb, t / cb + rb, ...
template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
bwd_partial_kernel(const T* __restrict__ g, const T* __restrict__ y,
                   const float* __restrict__ scale, const T* __restrict__ out,
                   T* __restrict__ dy, T* __restrict__ dr,
                   float* __restrict__ partial, unsigned rows, unsigned C,
                   unsigned cb, unsigned rows_per_block) {
  __shared__ float s_scale[kThreads];
  __shared__ float s_shift[kThreads];
  const unsigned t = threadIdx.x;
  const unsigned rb = blockDim.x / cb;
  const unsigned lc = t % cb;
  const unsigned c = blockIdx.y * cb + lc;
  float acc_s = 0.f, acc_b = 0.f;
  if (c < C) {
    const float s = __ldg(scale + c);
    const unsigned r0 = blockIdx.x * rows_per_block;
    const unsigned r1 = min(rows, r0 + rows_per_block);
    for (unsigned r = r0 + t / cb; r < r1; r += rb) {
      const size_t i = (size_t)r * C + c;
      const float m = to_f32(out[i]) > 0.f ? 1.f : 0.f;
      const float gm = __fmul_rn(to_f32(g[i]), m);
      dy[i] = from_f32<T>(__fmul_rn(gm, s));
      if (kResidual) dr[i] = from_f32<T>(gm);
      acc_s = __fadd_rn(acc_s, __fmul_rn(gm, to_f32(y[i])));
      acc_b = __fadd_rn(acc_b, gm);
    }
  }
  s_scale[t] = acc_s;
  s_shift[t] = acc_b;
  __syncthreads();
  if (t < cb && c < C) {
    float sum_s = 0.f, sum_b = 0.f;
    for (unsigned j = 0; j < rb; ++j) {
      sum_s += s_scale[j * cb + t];
      sum_b += s_shift[j * cb + t];
    }
    partial[(size_t)blockIdx.x * C + c] = sum_s;
    partial[((size_t)gridDim.x + blockIdx.x) * C + c] = sum_b;
  }
}

// Stage 2.  grid (C, 2): blockIdx.y 0 reduces d_scale, 1 reduces d_shift.
__global__ void __launch_bounds__(kThreads)
bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                  float* __restrict__ dshift, unsigned nblocks, unsigned C) {
  __shared__ float s_acc[kThreads];
  const unsigned c = blockIdx.x;
  const float* p = partial + (size_t)blockIdx.y * nblocks * C;
  float acc = 0.f;
  for (unsigned b = threadIdx.x; b < nblocks; b += blockDim.x) acc += p[(size_t)b * C + c];
  s_acc[threadIdx.x] = acc;
  __syncthreads();
  for (unsigned s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) s_acc[threadIdx.x] += s_acc[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) (blockIdx.y == 0 ? dscale : dshift)[c] = s_acc[0];
}

struct BwdGeometry {
  unsigned rows, cb, rb, row_blocks, channel_blocks, rows_per_block;
};

BwdGeometry bwd_geometry(int n, int C) {
  BwdGeometry geo;
  geo.rows = (unsigned)(n / C);
  geo.cb = (unsigned)(C < kThreads ? C : kThreads);
  geo.rb = kThreads / geo.cb;
  unsigned want = (geo.rows + geo.rb - 1) / geo.rb;
  geo.row_blocks = want < 1 ? 1 : (want > kMaxRowBlocks ? kMaxRowBlocks : want);
  geo.channel_blocks = (C + geo.cb - 1) / geo.cb;
  geo.rows_per_block = (geo.rows + geo.row_blocks - 1) / geo.row_blocks;
  return geo;
}

template <typename T>
void launch_fwd(const void* y, const void* scale, const void* shift, const void* res,
                void* out, int n, int C, cudaStream_t stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxFwdBlocks) blocks = kMaxFwdBlocks;
  if (res != nullptr) {
    fwd_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        (const T*)y, (const float*)scale, (const float*)shift, (const T*)res, (T*)out,
        (unsigned)n, (unsigned)C);
  } else {
    fwd_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        (const T*)y, (const float*)scale, (const float*)shift, nullptr, (T*)out,
        (unsigned)n, (unsigned)C);
  }
}

template <typename T>
void launch_bwd(const void* g, const void* y, const void* scale, const void* out,
                void* dy, void* dr, void* partial, void* dscale, void* dshift, int n,
                int C, cudaStream_t stream) {
  const BwdGeometry geo = bwd_geometry(n, C);
  const dim3 grid(geo.row_blocks, geo.channel_blocks);
  const unsigned threads = geo.cb * geo.rb;
  if (dr != nullptr) {
    bwd_partial_kernel<T, true><<<grid, threads, 0, stream>>>(
        (const T*)g, (const T*)y, (const float*)scale, (const T*)out, (T*)dy, (T*)dr,
        (float*)partial, geo.rows, (unsigned)C, geo.cb, geo.rows_per_block);
  } else {
    bwd_partial_kernel<T, false><<<grid, threads, 0, stream>>>(
        (const T*)g, (const T*)y, (const float*)scale, (const T*)out, (T*)dy, nullptr,
        (float*)partial, geo.rows, (unsigned)C, geo.cb, geo.rows_per_block);
  }
  bwd_reduce_kernel<<<dim3(C, 2), kThreads, 0, stream>>>(
      (const float*)partial, (float*)dscale, (float*)dshift, geo.row_blocks, (unsigned)C);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  res may be null (no residual).
int fused_fwd(int dtype, const void* y, const void* scale, const void* shift,
              const void* res, void* out, int n, int C, void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) launch_fwd<float>(y, scale, shift, res, out, n, C, s);
  else if (dtype == 1) launch_fwd<__nv_bfloat16>(y, scale, shift, res, out, n, C, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// partial: 2 * 1024 * C floats of scratch (kMaxRowBlocks rows per output; a
// launch uses the first 2 * row_blocks * C).  dr may be null (no residual).
// dscale / dshift: C floats each.
int fused_bwd(int dtype, const void* g, const void* y, const void* scale, const void* out,
              void* dy, void* dr, void* partial, void* dscale, void* dshift, int n, int C,
              void* stream) {
  if (n <= 0 || C <= 0 || n % C != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) launch_bwd<float>(g, y, scale, out, dy, dr, partial, dscale, dshift, n, C, s);
  else if (dtype == 1)
    launch_bwd<__nv_bfloat16>(g, y, scale, out, dy, dr, partial, dscale, dshift, n, C, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
