// CPU stand-in for the parts of the CUDA runtime and device language that
// karpenter_tpu_torch/solver/csrc/pack_solve.cu uses, so that its kernels can
// be compiled with a host C++20 compiler and run in the CPU tests.
//
// A launch runs the grid's blocks one after another. Each block runs one OS
// thread per CUDA thread; __syncthreads is a barrier over the block, and a
// warp shuffle is an exchange through a buffer between two barriers over the
// warp. __shared__ variables become function statics, which is sound because
// only one block runs at a time. Kernel launches are rewritten from
// `kernel<<<grid, block, smem, stream>>>(args);` to
// `emu_launch(kernel, grid, block, smem, stream, args);` before compiling.
#pragma once
#include <math.h>

#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(x)

struct emu_uint3 {
  unsigned x, y, z;
};
inline thread_local emu_uint3 threadIdx;
inline emu_uint3 blockIdx, blockDim;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }

struct EmuBlock {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<uint32_t> lanes;
};
inline EmuBlock* emu_block;

inline void __syncthreads() { emu_block->block->arrive_and_wait(); }

// Lane `src` of the caller's warp sends its value; src < 0 keeps the caller's.
template <class T>
T emu_shfl(T v, int src) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  const int warp = threadIdx.x >> 5;
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  emu_block->lanes[threadIdx.x] = bits;
  emu_block->warps[warp]->arrive_and_wait();
  const uint32_t got = src < 0 ? bits : emu_block->lanes[(warp << 5) | src];
  emu_block->warps[warp]->arrive_and_wait();
  T out;
  std::memcpy(&out, &got, 4);
  return out;
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  return emu_shfl(v, static_cast<int>(threadIdx.x & 31) ^ mask);
}
template <class T>
T __shfl_up_sync(unsigned, T v, int delta) {
  const int lane = threadIdx.x & 31;
  return emu_shfl(v, lane >= delta ? lane - delta : -1);
}

inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, 4);
  return i;
}
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }

template <class Kernel, class Args>
void emu_launch(Kernel kernel, dim3 grid, int block, int, cudaStream_t, Args args) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      EmuBlock b;
      b.block = std::make_unique<std::barrier<>>(block);
      for (int w = 0; w < block / 32; ++w) b.warps.push_back(std::make_unique<std::barrier<>>(32));
      b.lanes.resize(block);
      emu_block = &b;
      blockIdx = {bx, by, 0};
      blockDim = {static_cast<unsigned>(block), 1, 1};
      std::vector<std::thread> threads;
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&, t] {
          threadIdx = {static_cast<unsigned>(t), 0, 0};
          kernel(args);
        });
      for (auto& th : threads) th.join();
    }
}
