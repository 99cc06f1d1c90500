// A CPU stand-in for the parts of the CUDA runtime and device intrinsics
// that csrc/pinned.cu uses, for tests/test_torch_ring_emulated.py: a
// launch runs its blocks one after another, each block as blockDim.x
// threads; a warp's shuffles and reductions exchange values through a
// per-warp table between two barriers of the warp's threads, so they
// behave as full-warp collectives; __syncthreads is a barrier of the block.
// Shared variables become function statics (one block runs at a time).
// Only the kernels' semantics are modelled, not their speed.
#pragma once
#include <algorithm>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 2 };
inline int cudaGetLastError() { return 0; }
template <class F>
int cudaFuncSetAttribute(F, int, int) { return 0; }

namespace emu {
struct Barrier {
  std::mutex mu;
  std::condition_variable cv;
  int n = 0, count = 0;
  long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lock(mu);
    const long g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
      return;
    }
    cv.wait(lock, [&] { return gen != g; });
  }
};
struct Block {
  Barrier block;
  Barrier warp[32];
  unsigned table[32][32];
};
inline Block* blk = nullptr;
inline std::mutex atomic_mu;
inline uint2 dynamic_shared[32 * 512];
}  // namespace emu

inline dim3 blockDim;
inline thread_local dim3 threadIdx, blockIdx;

inline unsigned emu_exchange(unsigned v, int src) {
  const int w = threadIdx.x / 32;
  emu::blk->table[w][threadIdx.x % 32] = v;
  emu::blk->warp[w].wait();
  const unsigned r = emu::blk->table[w][src & 31];
  emu::blk->warp[w].wait();
  return r;
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src) { return emu_exchange(v, src); }
inline unsigned __shfl_up_sync(unsigned, unsigned v, int d) {
  const int lane = threadIdx.x % 32;
  return emu_exchange(v, lane >= d ? lane - d : lane);
}
inline int __shfl_xor_sync(unsigned, int v, int o) {
  return (int)emu_exchange((unsigned)v, (threadIdx.x % 32) ^ o);
}
inline int __reduce_max_sync(unsigned, int v) {
  const int w = threadIdx.x / 32;
  emu::blk->table[w][threadIdx.x % 32] = (unsigned)v;
  emu::blk->warp[w].wait();
  const int lanes = (int)std::min(32u, blockDim.x - 32u * w);
  int m = (int)emu::blk->table[w][0];
  for (int i = 1; i < lanes; ++i) m = std::max(m, (int)emu::blk->table[w][i]);
  emu::blk->warp[w].wait();
  return m;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, int s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
inline void __syncthreads() { emu::blk->block.wait(); }
inline void __syncwarp() { emu::blk->warp[threadIdx.x / 32].wait(); }
inline int atomicAdd(int* p, int v) {
  std::lock_guard<std::mutex> lock(emu::atomic_mu);
  const int old = *p;
  *p += v;
  return old;
}

template <class K, class... A>
void emu_launch(dim3 grid, dim3 block, K kernel, A... args) {
  blockDim = block;
  for (unsigned b = 0; b < grid.x; ++b) {
    emu::Block state;
    state.block.n = (int)block.x;
    for (unsigned w = 0; w < (block.x + 31) / 32; ++w) {
      state.warp[w].n = (int)std::min(32u, block.x - 32 * w);
    }
    emu::blk = &state;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t) {
      threads.emplace_back([=] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        kernel(args...);
      });
    }
    for (auto& th : threads) th.join();
  }
}
