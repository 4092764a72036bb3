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
// below the 67 TFLOP/s f32 rate.  At the stage-2 and stage-3 shapes the
// backward's bound falls to 1.3-3.1 us, where one launch and one DRAM round
// trip are a large share of the time.
//
// Forward: one grid-stride pass over the flat tensor; the channel of flat
// element i is i % C for any C (NHWC), and scale/shift are read as f32
// through the read-only cache.  The f32 math is __fadd_rn(__fmul_rn(y, s), b)
// (+ r), so nvcc cannot contract it into an FMA: the result equals the plain
// PyTorch version (y * s + b, two roundings) bitwise.
//
// Backward: one launch.  gm = g * [out > 0] (the ReLU mask is read from the
// saved output), dy = gm * scale[c], dr = gm, d_scale[c] = sum gm * y and
// d_shift[c] = sum gm over every pixel.  The TPU kernel carried the sums in
// one tile across a grid that runs in order; here blocks run concurrently,
// and the sums stay deterministic without float atomics:
// - Vector width.  VEC = 16 / sizeof(T) (8 bf16, 4 f32) when C % VEC == 0
//   and every operand is 16-byte aligned, else VEC = 1 (the same template:
//   the wrapper picks the variant from shape and pointers before the
//   launch).  A thread owns VEC consecutive channels for its whole life, so
//   C / VEC threads cover a row, neighbouring threads read neighbouring
//   16-byte chunks, and a warp moves 512 contiguous bytes of each operand
//   per load instruction.  It walks rows with a stride of rb = blockDim /
//   (C / VEC), issues the loads of kUnroll rows before using any, and keeps
//   2 * VEC f32 sums in registers (staging the rows through shared memory
//   with cp.async instead was measured no faster).  Channel tiles wider than
//   a block go on blockIdx.y.
// - Grid.  blockIdx.x takes a contiguous range of rows; the number of row
//   blocks is what fills the card once (SMs x resident blocks, from the
//   occupancy API), capped by the rows and by the partials one block can
//   fold in one batch of loads (row_blocks * 2 * C <= 8,192 floats).  The
//   geometry is computed by the Python wrapper (ops/fused_block.bwd_geometry)
//   and passed in.
// - In-block fold.  The threads' sums go to shared memory as a matrix of
//   thread rows, folded in a fixed order by the same routine as the blocks'
//   rows below; the block writes one row of 2 * C partials.
// - Cross-block fold in the same launch, the "last block done" pattern of
//   the CUDA samples' threadFenceReduction: after its row is written
//   (__syncthreads), one thread of each block draws a ticket with a
//   device-scope acquire-release atomic (one release a block, no per-thread
//   __threadfence); the block that draws the last ticket folds all rows in
//   block order (16-byte loads issued together, then a fixed tree) into
//   d_scale / d_shift and resets the ticket.  The atomic orders only the
//   tickets, never a value: the fold order is fixed by the geometry, so the
//   gradients are bitwise the same from run to run whichever block finishes
//   last.
// - Workspace.  The tickets live in a device array of this module (zero at
//   load; each last block resets the ticket it drew), in a slot the wrapper
//   assigns per stream, or per call captured into a CUDA graph: no memset,
//   in a graph or out of one.  The scratch rows need no zeroing (each is
//   written before it is read) and come from PyTorch's allocator.
// - dy / dr keep the explicit __fmul_rn: bitwise the plain version in f32,
//   and the same f32 value rounded once to bf16.
//
// Interface: plain C, loaded with ctypes.  Every entry point takes device
// pointers and the CUDA stream as void*, launches on that stream without
// synchronising, and returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it does not take, without launching).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFwdBlocks = 132 * 16;
constexpr int kUnroll = 2;
constexpr int kFoldBatch = 8;
// The backward's tickets, one a slot: zero when the module loads on a
// device, and reset to zero by the block that draws the last ticket, so zero
// between launches with no memset.  The wrapper gives each stream its own
// slot, and each call captured into a CUDA graph a slot of its own.
constexpr int kTicketSlots = 4096;
__device__ unsigned g_tickets[kTicketSlots];

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

// VEC consecutive values, moved as one 16-, 8-, 4- or 2-byte access.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <int kBytes> struct RawWord;
template <> struct RawWord<16> { using type = uint4; };
template <> struct RawWord<8> { using type = uint2; };
template <> struct RawWord<4> { using type = unsigned int; };
template <> struct RawWord<2> { using type = unsigned short; };

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  using W = typename RawWord<sizeof(Pack<T, VEC>)>::type;
  const W w = __ldg(reinterpret_cast<const W*>(p));
  Pack<T, VEC> r;
  memcpy(&r, &w, sizeof(r));
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& r) {
  using W = typename RawWord<sizeof(Pack<T, VEC>)>::type;
  W w;
  memcpy(&w, &r, sizeof(w));
  *reinterpret_cast<W*>(p) = w;
}

// W consecutive floats of a scratch row, moved as one access.
template <int W> struct Floats { float v[W]; };

// Rows written by other blocks of this launch are read past L1 (__ldcg).
template <int W, bool kOtherBlocks>
__device__ __forceinline__ Floats<W> load_floats(const float* p) {
  Floats<W> r;
  if constexpr (W == 4) {
    const float4 q = kOtherBlocks ? __ldcg(reinterpret_cast<const float4*>(p))
                                  : *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
    r.v[0] = kOtherBlocks ? __ldcg(p) : *p;
  }
  return r;
}

// dst[col] = sum over i < nrows of src[i * ncols + col], for col < ncols
// (a multiple of W; src 4W-byte aligned), in an order fixed by (blockDim,
// nrows, ncols): `lanes` threads per unit of W columns sum rows lane,
// lane + lanes, ... in turn (the loads of kFoldBatch rows issued before the
// first add), then a fixed tree over the lanes in `buf` (blockDim * W
// floats of shared memory, apart from src).  dst may be src's first row.
template <int W, bool kOtherBlocks>
__device__ void fold_rows(const float* src, unsigned nrows, unsigned ncols, float* dst,
                          float* buf) {
  const unsigned t = threadIdx.x, T = blockDim.x;
  const unsigned nunits = ncols / W;
  for (unsigned base = 0; base < nunits; base += T) {
    const unsigned units = min(nunits - base, T);
    const unsigned lanes = T / units;  // threads per unit
    const unsigned u = t % units, lane = t / units;
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.f;
    if (lane < lanes) {
      const float* col = src + (size_t)(base + u) * W;
      // kFoldBatch rows' loads in flight before the first add; the adds
      // still run in row order
      for (unsigned i0 = lane; i0 < nrows; i0 += kFoldBatch * lanes) {
        Floats<W> x[kFoldBatch];
#pragma unroll
        for (int k = 0; k < kFoldBatch; ++k) {
          const unsigned i = i0 + k * lanes;
          if (i < nrows) x[k] = load_floats<W, kOtherBlocks>(col + (size_t)i * ncols);
        }
#pragma unroll
        for (int k = 0; k < kFoldBatch; ++k) {
          if (i0 + k * lanes < nrows) {
#pragma unroll
            for (int w = 0; w < W; ++w) acc[w] += x[k].v[w];
          }
        }
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) buf[t * W + w] = acc[w];
    __syncthreads();
    unsigned top = 1;
    while (top < lanes) top <<= 1;
    for (unsigned s = top / 2; s > 0; s >>= 1) {
      if (lane < s && lane + s < lanes) {
#pragma unroll
        for (int w = 0; w < W; ++w) buf[t * W + w] += buf[(t + s * units) * W + w];
      }
      __syncthreads();
    }
    if (lane == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) dst[(base + u) * W + w] = buf[u * W + w];
    }
    __syncthreads();
  }
}

// Draws a ticket with release and acquire semantics at device scope: the
// writes this block made before the draw (ordered by __syncthreads) are
// visible to the block that draws the last ticket, and that block sees
// every other block's.  Returns the count before the draw.
__device__ __forceinline__ unsigned draw_ticket(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

struct BwdArgs {
  unsigned rows, C, cg, rows_per_block, slot;
};

// Block (bx, by): rows [bx * rows_per_block, ...) and channel groups
// [by * cg, by * cg + cg) of VEC channels each; blockDim.x == cg * rb, thread
// t keeps group by * cg + t % cg and walks rows t / cg, t / cg + rb, ...
// work: gridDim.x rows of 2 * C partials (d_scale then d_shift).  dss:
// d_scale then d_shift.
template <typename T, int VEC, bool kResidual>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* __restrict__ g, const T* __restrict__ y, const float* __restrict__ scale,
           const T* __restrict__ out, T* __restrict__ dy, T* __restrict__ dr,
           float* __restrict__ dss, float* __restrict__ work, BwdArgs a) {
  __shared__ __align__(16) float s_red[2 * kThreads * VEC];  // the block's sums
  __shared__ __align__(16) float s_fold[4 * kThreads];       // fold_rows' lanes
  __shared__ bool s_last;
  const unsigned t = threadIdx.x;
  const unsigned C = a.C, cg = a.cg, rb = blockDim.x / cg;
  const unsigned lc = t % cg, j = t / cg;
  const unsigned grp = blockIdx.y * cg + lc;
  const unsigned c0 = grp * VEC;
  const unsigned tile = cg * VEC;  // channels of a block
  float acc_s[VEC], acc_b[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc_s[v] = acc_b[v] = 0.f;

  if (c0 < C) {
    float s[VEC];
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int v = 0; v < VEC; v += 4) {
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + c0 + v));
        s[v] = s4.x; s[v + 1] = s4.y; s[v + 2] = s4.z; s[v + 3] = s4.w;
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) s[v] = __ldg(scale + c0 + v);
    }
    const unsigned r_begin = blockIdx.x * a.rows_per_block;
    const unsigned r_end = min(a.rows, r_begin + a.rows_per_block);
    for (unsigned r = r_begin + j; r < r_end; r += kUnroll * rb) {
      Pack<T, VEC> pg[kUnroll], py[kUnroll], po[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned rr = r + u * rb;
        if (rr < r_end) {
          const unsigned i = rr * C + c0;
          pg[u] = load_pack<T, VEC>(g + i);
          py[u] = load_pack<T, VEC>(y + i);
          po[u] = load_pack<T, VEC>(out + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned rr = r + u * rb;
        if (rr < r_end) {
          const unsigned i = rr * C + c0;
          Pack<T, VEC> pdy, pdr;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float m = to_f32(po[u].v[v]) > 0.f ? 1.f : 0.f;
            const float gm = __fmul_rn(to_f32(pg[u].v[v]), m);
            pdy.v[v] = from_f32<T>(__fmul_rn(gm, s[v]));
            if (kResidual) pdr.v[v] = from_f32<T>(gm);
            acc_s[v] = __fadd_rn(acc_s[v], __fmul_rn(gm, to_f32(py[u].v[v])));
            acc_b[v] = __fadd_rn(acc_b[v], gm);
          }
          store_pack<T, VEC>(dy + i, pdy);
          if (kResidual) store_pack<T, VEC>(dr + i, pdr);
        }
      }
    }
  }

  // In-block fold: the threads' sums as an (rb, 2 * tile) matrix in shared
  // memory, a row a thread row (d_scale's tile, then d_shift's), folded like
  // the blocks' rows below into its first row: the block's row of partials.
  const unsigned row_len = 2 * C, width = 2 * tile;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    s_red[j * width + lc * VEC + v] = acc_s[v];
    s_red[j * width + tile + lc * VEC + v] = acc_b[v];
  }
  __syncthreads();
  if (width % 4 == 0) fold_rows<4, false>(s_red, rb, width, s_red, s_fold);
  else fold_rows<1, false>(s_red, rb, width, s_red, s_fold);
  float* partial = work;
  for (unsigned e = t; e < tile; e += blockDim.x) {
    const unsigned c = blockIdx.y * tile + e;
    if (c < C) {
      partial[(size_t)blockIdx.x * row_len + c] = s_red[e];
      partial[(size_t)blockIdx.x * row_len + C + c] = s_red[tile + e];
    }
  }

  // Cross-block fold: the block that draws the last ticket folds every
  // block's row, in block order, and resets the ticket.
  unsigned* ticket = g_tickets + a.slot;
  __syncthreads();
  if (t == 0) s_last = draw_ticket(ticket) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  if (row_len % 4 == 0) fold_rows<4, true>(partial, gridDim.x, row_len, dss, s_fold);
  else fold_rows<1, true>(partial, gridDim.x, row_len, dss, s_fold);
  if (t == 0) *ticket = 0;
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

template <typename T, int VEC, bool kResidual>
const void* bwd_symbol() {
  return reinterpret_cast<const void*>(&bwd_kernel<T, VEC, kResidual>);
}

// The kernel instance for (dtype, vec, residual), or null.
const void* bwd_instance(int dtype, int vec, bool residual) {
  if (dtype == 0 && vec == 4)
    return residual ? bwd_symbol<float, 4, true>() : bwd_symbol<float, 4, false>();
  if (dtype == 0 && vec == 1)
    return residual ? bwd_symbol<float, 1, true>() : bwd_symbol<float, 1, false>();
  if (dtype == 1 && vec == 8)
    return residual ? bwd_symbol<__nv_bfloat16, 8, true>() : bwd_symbol<__nv_bfloat16, 8, false>();
  if (dtype == 1 && vec == 1)
    return residual ? bwd_symbol<__nv_bfloat16, 1, true>() : bwd_symbol<__nv_bfloat16, 1, false>();
  return nullptr;
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

// Resident blocks of kThreads threads per SM for the backward instance
// (dtype, vec, residual != 0), written to *blocks.
int fused_bwd_blocks_per_sm(int dtype, int vec, int residual, int* blocks) {
  const void* fn = bwd_instance(dtype, vec, residual != 0);
  if (fn == nullptr || blocks == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, 0);
}

// geo: {dtype, rows, C, vec, cg, rb, row_blocks, channel_blocks,
// rows_per_block} (dtype, then ops/fused_block.BwdGeometry).  dr may be null
// (no residual).  dss: 2 * C floats (d_scale, d_shift), 16-byte aligned.
// work: row_blocks * 2 * C floats of scratch, 16-byte aligned (no zeroing:
// every row is written before it is read).  slot: the ticket slot, <
// kTicketSlots.
int fused_bwd(const int* geo, const void* g, const void* y, const void* scale,
              const void* out, void* dy, void* dr, void* dss, void* work, int slot,
              void* stream) {
  const int dtype = geo[0], rows = geo[1], C = geo[2], vec = geo[3], cg = geo[4], rb = geo[5];
  const int row_blocks = geo[6], channel_blocks = geo[7], rows_per_block = geo[8];
  const void* fn = bwd_instance(dtype, vec, dr != nullptr);
  if (fn == nullptr || rows <= 0 || C <= 0 || C % vec != 0 || cg <= 0 || rb <= 0 ||
      cg * rb > kThreads || (32 % cg == 0 && cg * rb % 32 != 0) || row_blocks <= 0 ||
      channel_blocks <= 0 || channel_blocks > 65535 ||
      (long long)channel_blocks * cg * vec < C || (long long)row_blocks * rows_per_block < rows ||
      slot < 0 || slot >= kTicketSlots || ((size_t)dss | (size_t)work) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{(unsigned)rows, (unsigned)C, (unsigned)cg, (unsigned)rows_per_block,
            (unsigned)slot};
  void* args[] = {(void*)&g, (void*)&y, (void*)&scale, (void*)&out, (void*)&dy,
                  (void*)&dr, (void*)&dss, (void*)&work, (void*)&a};
  const cudaError_t err = cudaLaunchKernel(fn, dim3(row_blocks, channel_blocks), dim3(cg * rb),
                                           args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
