// Host emulation of the CUDA features that fedml_tpu_torch/csrc/fused_block.cu,
// csrc/quantize.cu and csrc/noise.cu use, for tests/test_torch_fused_block_emu.py,
// tests/test_torch_quantize_emu.py and tests/test_torch_noise_emu.py (g++
// -std=c++20, no card).
// A block runs as blockDim.x std::threads; __syncthreads is a std::barrier,
// __shfl_xor_sync exchanges through a per-block array between two barriers,
// __shared__ variables are statics (blocks run one after another, in an
// order the test chooses), and loads and fences are plain.
#pragma once
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline std::barrier<>* emu_barrier = nullptr;
inline float emu_lanes[1024];
inline std::mutex emu_atomic;

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline void __threadfence() {}
inline float __shfl_xor_sync(unsigned, float v, unsigned off) {
  emu_lanes[threadIdx.x] = v;
  __syncthreads();
  const float r = emu_lanes[threadIdx.x ^ off];
  __syncthreads();
  return r;
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  std::lock_guard<std::mutex> lock(emu_atomic);
  const unsigned old = *p;
  *p = old + v;
  return old;
}
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline T __ldcs(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }

typedef int cudaError_t;
typedef void* cudaStream_t;
typedef void* cudaEvent_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaEventRecord(cudaEvent_t, cudaStream_t) { return cudaSuccess; }
inline cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t, cudaStream_t) {
  return cudaSuccess;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, const void*, int, size_t) {
  *b = 1;
  return cudaSuccess;
}
// a card of 2 SMs, so that a grid of one resident wave walks several tiles
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
enum cudaStreamCaptureStatus { cudaStreamCaptureStatusNone = 0, cudaStreamCaptureStatusActive = 1 };
inline cudaError_t cudaStreamGetCaptureInfo(cudaStream_t, cudaStreamCaptureStatus* s,
                                            unsigned long long*) {
  *s = cudaStreamCaptureStatusNone;
  return cudaSuccess;
}

// thread blocks 0..n-1 in an order shuffled by `seed`
inline std::vector<unsigned> emu_shuffled(unsigned n, unsigned seed) {
  std::vector<unsigned> order(n);
  for (unsigned i = 0; i < n; ++i) order[i] = i;
  std::mt19937 rng(seed);
  std::shuffle(order.begin(), order.end(), rng);
  return order;
}

// Runs body() as every thread of every block of grid x block (block.x *
// block.y threads), the blocks one after another in `order` (linear ids
// (z * grid.y + y) * grid.x + x).
template <class F>
void emu_launch(dim3 grid, dim3 block, const std::vector<unsigned>& order, F body) {
  gridDim = grid;
  blockDim = block;
  const unsigned nthreads = block.x * block.y;
  for (unsigned id : order) {
    std::barrier<> bar(nthreads);
    emu_barrier = &bar;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < nthreads; ++t)
      threads.emplace_back([&, t] {
        threadIdx = dim3(t % block.x, t / block.x);
        blockIdx = dim3(id % grid.x, id / grid.x % grid.y, id / grid.x / grid.y);
        body();
      });
    for (auto& th : threads) th.join();
  }
}
