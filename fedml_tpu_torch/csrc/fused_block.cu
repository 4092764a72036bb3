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
// Forward: a pure stream (read y [and r], write out: 2-3 bytes moved per
// byte of y), so its bound is bytes at 3.35 TB/s: 2.5 / 1.3 / 0.6 us without
// and 3.8 / 1.9 / 0.9 us with the residual at the three stage shapes in
// bf16.  At stages 2-3 a launch's fixed cost is of the same size: on an
// H100 even PyTorch's elementwise kernel moving the same bytes takes ~1.5 us
// above the bound in a CUDA graph (PERF.md), so that stream, not the bound,
// is the yardstick there.  What the design does about it:
// - Vector width and channel groups, as in the backward below: VEC = 16 /
//   sizeof(T) channels a thread when C % VEC == 0 and every operand is
//   16-byte aligned (one 16-byte load of y [and r] and one store a row),
//   else VEC = 1; a thread keeps its channel group for its whole life and
//   loads its scale and shift once, into registers (no per-element i % C,
//   no per-element load of the vectors).
// - Geometry: one resident wave of row blocks (SMs x resident blocks of the
//   instance, capped by the rows; channel tiles wider than a block on
//   blockIdx.y), computed by ops/fused_block.fwd_geometry; blocks of (cg,
//   rb) threads, so a thread finds its channel group and first row with no
//   integer division.  A thread takes kFwdUnroll = 1 row at a time: the
//   wave gives a thread one or two rows at the flagship shapes, and deeper
//   unrolls (loads of 2 or 4 rows issued before the first use) cost
//   registers, hence resident blocks, and measured slower
//   (obs/ablate_fwd.py).
// - y and r are read once here (y again only in the backward), with the
//   evict-first policy (__ldcs), so the L2 keeps what the stream writes; out
//   is stored with the default policy: the next conv reads it at once.
// - The f32 math is __fadd_rn(__fmul_rn(y, s), b) (+ r), so nvcc cannot
//   contract it into an FMA, then relu, then one rounding to T: the result
//   equals the plain PyTorch version (y * s + b, two roundings) bitwise in
//   f32, and in bf16 (the same f32 value rounded once).
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
//   assigns per stream, or per capture into a CUDA graph and its stream
//   (the captured calls of one stream run in the graph's fixed order, so
//   they share it): no memset, in a graph or out of one.  The scratch rows need no zeroing (each is
//   written before it is read) and come from PyTorch's allocator.
// - dy / dr keep the explicit __fmul_rn: bitwise the plain version in f32,
//   and the same f32 value rounded once to bf16.
//
// Lanes.  The simulator's MESH round runs every sampled client of a round
// as one lane of a batched step, so each fused site sees L lane-major
// activations (L, N, H, W, C), contiguous, and per-lane (L, C) scale and
// shift (each client's own BN statistics).  fused_fwd_lanes and
// fused_bwd_lanes launch the same kernels once for all lanes with the lane
// on blockIdx.z: a block offsets every operand by its lane (rows * C
// elements, C per-channel floats, 2 * C outputs and row_blocks * 2 * C
// scratch floats) and keeps the single-lane geometry within it, and the
// backward's last-block fold runs per lane on a ticket of its own (slot +
// lane).  So a lane's outputs are bitwise those of the single-lane launch on
// its slice, d_scale and d_shift included (the same fold in the same order),
// and with L = 1 the launch is the single-lane one.  This is the
// TPU kernels' batching rule under jax.vmap (a leading grid axis, per-lane
// scale and shift).  The grid is L waves of row blocks, not one: a simple
// form first (bound at L = 64, stage 1, bf16: the forward moves 2 x 268 MB,
// ~160 us at 3.35 TB/s).
//
// Interface: plain C, loaded with ctypes.  Every entry point takes device
// pointers and the CUDA stream as void*, launches on that stream without
// synchronising, and returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it does not take, without launching).  A launch entry point
// also takes two CUDA events, start and stop (ops/timing.py's pair, or
// both null): it records start on the stream just before the launch and
// stop just after, so one call from Python launches and times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kFwdUnroll = 1;
constexpr int kUnroll = 2;
constexpr int kFoldBatch = 8;
// The backward's tickets, one a slot: zero when the module loads on a
// device, and reset to zero by the block that draws the last ticket, so zero
// between launches with no memset.  The wrapper gives each stream its own
// slots, and each stream of each capture into a CUDA graph slots of its own:
// one a lane, consecutive.
constexpr int kTicketSlots = 65536;
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

// kEvictFirst: an operand read once (__ldcs, evict first), else the
// read-only path (__ldg).
template <typename T, int VEC, bool kEvictFirst = false>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  using W = typename RawWord<sizeof(Pack<T, VEC>)>::type;
  const W* q = reinterpret_cast<const W*>(p);
  const W w = kEvictFirst ? __ldcs(q) : __ldg(q);
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

// The VEC per-channel floats of a thread's channel group (16-byte loads
// when VEC is a multiple of 4: p is then 16-byte aligned).
template <int VEC>
__device__ __forceinline__ void load_channels(const float* p, float (&r)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int v = 0; v < VEC; v += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + v));
      r[v] = q.x; r[v + 1] = q.y; r[v + 2] = q.z; r[v + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) r[v] = __ldg(p + v);
  }
}

// A launch's cover of a (rows, C) activation (ops/fused_block.Geometry):
// block (bx, by) takes rows [bx * rows_per_block, ...) and channel groups
// [by * cg, by * cg + cg) of VEC channels each, with cg * rb threads; thread
// (lc, j) keeps group by * cg + lc and walks rows j, j + rb, ... of the
// block's range.  The forward's blocks are (cg, rb): lc = threadIdx.x, j =
// threadIdx.y; the backward's are flat: lc = t % cg, j = t / cg.
struct RowArgs {
  unsigned rows, C, cg, rows_per_block;
  unsigned slot;  // the backward's ticket slot (unused by the forward)
};

template <typename T, int VEC, bool kResidual>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ y, const float* __restrict__ scale,
           const float* __restrict__ shift, const T* __restrict__ res,
           T* __restrict__ out, RowArgs a) {
  const unsigned C = a.C, rb = blockDim.y;
  const unsigned c0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= C) return;
  // this block's lane: its activation and its per-channel vectors
  const size_t lane_elems = (size_t)blockIdx.z * a.rows * C;
  y += lane_elems;
  out += lane_elems;
  if (kResidual) res += lane_elems;
  scale += (size_t)blockIdx.z * C;
  shift += (size_t)blockIdx.z * C;
  float s[VEC], b[VEC];
  load_channels<VEC>(scale + c0, s);
  load_channels<VEC>(shift + c0, b);
  const unsigned r_begin = blockIdx.x * a.rows_per_block;
  const unsigned r_end = min(a.rows, r_begin + a.rows_per_block);
  for (unsigned r = r_begin + threadIdx.y; r < r_end; r += kFwdUnroll * rb) {
    Pack<T, VEC> py[kFwdUnroll], pr[kFwdUnroll];
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      const unsigned rr = r + u * rb;
      if (rr < r_end) {
        py[u] = load_pack<T, VEC, true>(y + rr * C + c0);
        if (kResidual) pr[u] = load_pack<T, VEC, true>(res + rr * C + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      const unsigned rr = r + u * rb;
      if (rr < r_end) {
        Pack<T, VEC> po;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float z = __fadd_rn(__fmul_rn(to_f32(py[u].v[v]), s[v]), b[v]);
          if (kResidual) z = __fadd_rn(z, to_f32(pr[u].v[v]));
          po.v[v] = from_f32<T>(relu_f32(z));
        }
        store_pack<T, VEC>(out + rr * C + c0, po);
      }
    }
  }
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

// Rows and channel groups as in fwd_kernel (RowArgs), lanes on blockIdx.z.
// work: gridDim.x rows of 2 * C partials (d_scale then d_shift) a lane.  dss:
// d_scale then d_shift, a lane after the other.
template <typename T, int VEC, bool kResidual>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* __restrict__ g, const T* __restrict__ y, const float* __restrict__ scale,
           const T* __restrict__ out, T* __restrict__ dy, T* __restrict__ dr,
           float* __restrict__ dss, float* __restrict__ work, RowArgs a) {
  __shared__ __align__(16) float s_red[2 * kThreads * VEC];  // the block's sums
  __shared__ __align__(16) float s_fold[4 * kThreads];       // fold_rows' lanes
  __shared__ bool s_last;
  const unsigned t = threadIdx.x;
  const unsigned C = a.C, cg = a.cg, rb = blockDim.x / cg;
  const unsigned lc = t % cg, j = t / cg;
  const unsigned grp = blockIdx.y * cg + lc;
  const unsigned c0 = grp * VEC;
  const unsigned tile = cg * VEC;  // channels of a block
  // this block's lane: its activations, scale, outputs, scratch and ticket
  const size_t lane_elems = (size_t)blockIdx.z * a.rows * C;
  g += lane_elems;
  y += lane_elems;
  out += lane_elems;
  dy += lane_elems;
  if (kResidual) dr += lane_elems;
  scale += (size_t)blockIdx.z * C;
  dss += (size_t)blockIdx.z * 2 * C;
  work += (size_t)blockIdx.z * gridDim.x * 2 * C;
  float acc_s[VEC], acc_b[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc_s[v] = acc_b[v] = 0.f;

  if (c0 < C) {
    float s[VEC];
    load_channels<VEC>(scale + c0, s);
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
  // block's row, in block order, and resets the ticket (each lane on its
  // own ticket, over its own rows).
  unsigned* ticket = g_tickets + a.slot + blockIdx.z;
  __syncthreads();
  if (t == 0) s_last = draw_ticket(ticket) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  if (row_len % 4 == 0) fold_rows<4, true>(partial, gridDim.x, row_len, dss, s_fold);
  else fold_rows<1, true>(partial, gridDim.x, row_len, dss, s_fold);
  if (t == 0) *ticket = 0;
}

template <typename T, int VEC, bool kResidual>
const void* symbol(bool backward) {
  return backward ? reinterpret_cast<const void*>(&bwd_kernel<T, VEC, kResidual>)
                  : reinterpret_cast<const void*>(&fwd_kernel<T, VEC, kResidual>);
}

// The kernel instance for (direction, dtype, vec, residual), or null.
const void* instance(bool backward, int dtype, int vec, bool residual) {
  if (dtype == 0 && vec == 4)
    return residual ? symbol<float, 4, true>(backward) : symbol<float, 4, false>(backward);
  if (dtype == 0 && vec == 1)
    return residual ? symbol<float, 1, true>(backward) : symbol<float, 1, false>(backward);
  if (dtype == 1 && vec == 8)
    return residual ? symbol<__nv_bfloat16, 8, true>(backward)
                    : symbol<__nv_bfloat16, 8, false>(backward);
  if (dtype == 1 && vec == 1)
    return residual ? symbol<__nv_bfloat16, 1, true>(backward)
                    : symbol<__nv_bfloat16, 1, false>(backward);
  return nullptr;
}

// The geometry array both directions take: {dtype, rows, C, vec, cg, rb,
// row_blocks, channel_blocks, rows_per_block} (dtype, then
// ops/fused_block.Geometry).
struct Geo {
  int dtype, rows, C, vec, cg, rb, row_blocks, channel_blocks, rows_per_block;
};

// Whether geo covers its (rows, C) in a launch the kernels take.
bool geo_ok(const Geo& g) {
  return g.rows > 0 && g.C > 0 && g.vec > 0 && g.C % g.vec == 0 && g.cg > 0 && g.rb > 0 &&
         g.cg * g.rb <= kThreads && g.row_blocks > 0 && g.channel_blocks > 0 &&
         g.channel_blocks <= 65535 && (long long)g.channel_blocks * g.cg * g.vec >= g.C &&
         (long long)g.row_blocks * g.rows_per_block >= g.rows;
}

// Launches fn on stream between the records of start and stop (where
// given).
cudaError_t launch(const void* fn, const Geo& g, int lanes, dim3 block, void** args,
                   void* stream, void* start, void* stop) {
  cudaError_t err = start ? cudaEventRecord((cudaEvent_t)start, (cudaStream_t)stream)
                          : cudaSuccess;
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(fn, dim3(g.row_blocks, g.channel_blocks, lanes), block, args, 0,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || !stop) return err;
  return cudaEventRecord((cudaEvent_t)stop, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Resident blocks of kThreads threads per SM for the instance (backward != 0
// for the backward, else the forward; dtype 0 = float32, 1 = bfloat16; vec;
// residual != 0), written to *blocks.
int fused_blocks_per_sm(int backward, int dtype, int vec, int residual, int* blocks) {
  const void* fn = instance(backward != 0, dtype, vec, residual != 0);
  if (fn == nullptr || blocks == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, 0);
}

// geo: the geometry array (ops/fused_block.fwd_geometry) of one lane.  lanes
// (1..65535): lane-major operands of `lanes` (rows, C) activations and (C,)
// vectors each.  res may be null (no residual).  With vec > 1 every pointer
// must be 16-byte aligned.
int fused_fwd_lanes(const int* geo, int lanes, const void* y, const void* scale,
                    const void* shift, const void* res, void* out, void* stream, void* start,
                    void* stop) {
  Geo g;
  memcpy(&g, geo, sizeof(g));
  const void* fn = instance(false, g.dtype, g.vec, res != nullptr);
  if (fn == nullptr || !geo_ok(g) || lanes < 1 || lanes > 65535 ||
      (g.vec > 1 && ((size_t)y | (size_t)scale | (size_t)shift | (size_t)res | (size_t)out) % 16))
    return (int)cudaErrorInvalidValue;
  RowArgs a{(unsigned)g.rows, (unsigned)g.C, (unsigned)g.cg, (unsigned)g.rows_per_block, 0u};
  void* args[] = {(void*)&y, (void*)&scale, (void*)&shift, (void*)&res, (void*)&out, (void*)&a};
  return (int)launch(fn, g, lanes, dim3(g.cg, g.rb), args, stream, start, stop);
}

// One lane (fused_fwd_lanes with lanes = 1).
int fused_fwd(const int* geo, const void* y, const void* scale, const void* shift,
              const void* res, void* out, void* stream, void* start, void* stop) {
  return fused_fwd_lanes(geo, 1, y, scale, shift, res, out, stream, start, stop);
}

// geo: the geometry array (ops/fused_block.bwd_geometry) of one lane.  lanes
// (1..65535): lane-major operands as in fused_fwd_lanes.  dr may be null (no
// residual).  dss: lanes * 2 * C floats (each lane's d_scale, d_shift),
// 16-byte aligned.  work: lanes * row_blocks * 2 * C floats of scratch,
// 16-byte aligned (no zeroing: every row is written before it is read).
// slot: the first of the `lanes` ticket slots, slot + lanes <= kTicketSlots.
int fused_bwd_lanes(const int* geo, int lanes, const void* g, const void* y, const void* scale,
                    const void* out, void* dy, void* dr, void* dss, void* work, int slot,
                    void* stream, void* start, void* stop) {
  Geo o;
  memcpy(&o, geo, sizeof(o));
  const void* fn = instance(true, o.dtype, o.vec, dr != nullptr);
  if (fn == nullptr || !geo_ok(o) || (32 % o.cg == 0 && o.cg * o.rb % 32 != 0) || lanes < 1 ||
      lanes > 65535 || slot < 0 || slot > kTicketSlots - lanes ||
      ((size_t)dss | (size_t)work) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  RowArgs a{(unsigned)o.rows, (unsigned)o.C, (unsigned)o.cg, (unsigned)o.rows_per_block,
            (unsigned)slot};
  void* args[] = {(void*)&g, (void*)&y, (void*)&scale, (void*)&out, (void*)&dy,
                  (void*)&dr, (void*)&dss, (void*)&work, (void*)&a};
  return (int)launch(fn, o, lanes, dim3(o.cg * o.rb), args, stream, start, stop);
}

// One lane (fused_bwd_lanes with lanes = 1).
int fused_bwd(const int* geo, const void* g, const void* y, const void* scale,
              const void* out, void* dy, void* dr, void* dss, void* work, int slot,
              void* stream, void* start, void* stop) {
  return fused_bwd_lanes(geo, 1, g, y, scale, out, dy, dr, dss, work, slot, stream, start,
                         stop);
}

// The id of the capture that `stream` is capturing into a CUDA graph,
// written to *id (the backward's ticket slot of a captured call is keyed by
// it); cudaErrorInvalidValue if the stream is not capturing.
int fused_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status;
  const cudaError_t err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, id);
  if (err != cudaSuccess) return (int)err;
  return status == cudaStreamCaptureStatusActive ? 0 : (int)cudaErrorInvalidValue;
}

}  // extern "C"
