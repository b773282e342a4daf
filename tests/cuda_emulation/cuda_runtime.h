// A stand-in for <cuda_runtime.h> that runs the FAST and dense BRIEF kernels
// on the CPU, for tests of their logic where there is no card: one block at
// a time, one std::thread per CUDA thread, `__shared__` as a
// function-local static (blocks run one after another, so the threads of a
// block share it), barriers for __syncthreads and, per warp, for the
// lock-step intrinsics.  Only what csrc/fast_*.cu and brief_planes.cu use
// is here.  A launch `k<<<grid, block, 0, s>>>(a)` has to be rewritten to
// `emu_launch(grid, block, k, a)` before compiling (`emulate.py` does it).
// Nothing here is timed or tuned.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(...)
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local int emu_tid;    // the thread's index in its block
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { return *d = 0; }
// few "SMs", so that small test images fall on both sides of choose_rows
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 4; return 0; }

struct EmuBlock {
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<int> slot;
  std::atomic<int> count{0};
  explicit EmuBlock(int nt) : all(nt), slot(nt) {
    for (int w = 0; w < nt / 32; ++w)
      warp.emplace_back(new std::barrier<>(32));
  }
};
inline EmuBlock* emu_block;

inline void __syncthreads() { emu_block->all.arrive_and_wait(); }
inline void __syncwarp() { emu_block->warp[emu_tid / 32]->arrive_and_wait(); }
inline int __syncthreads_count(int p) {
  __syncthreads();
  if (emu_tid == 0) emu_block->count = 0;
  __syncthreads();
  if (p) emu_block->count++;
  __syncthreads();
  return emu_block->count.load();
}
inline unsigned __ballot_sync(unsigned, int p) {
  const int t = emu_tid, w = t / 32;
  emu_block->slot[t] = p != 0;
  __syncwarp();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (unsigned)emu_block->slot[w * 32 + l] << l;
  __syncwarp();
  return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
using std::max;
using std::min;

template <class Kernel, class... Args>
void emu_launch(dim3 grid, dim3 block, Kernel kernel, Args... args) {
  const int nt = block.x * block.y * block.z;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        EmuBlock b(nt);
        emu_block = &b;
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t)
          threads.emplace_back([=] {
            emu_tid = t;
            threadIdx = dim3(t % block.x, t / block.x % block.y,
                             t / (block.x * block.y));
            blockIdx = dim3(x, y, z);
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}
