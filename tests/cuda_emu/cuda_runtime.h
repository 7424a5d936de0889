// CPU stand-in for the parts of the CUDA runtime and device language that
// the kernels under karpenter_tpu_torch/solver/csrc/ use, so that they can be
// compiled with a host C++20 compiler and run in the CPU tests.
//
// A launch runs the grid's blocks one after another, over all three grid
// axes. Each block runs one OS
// thread per CUDA thread; __syncthreads is a barrier over the block, and a
// warp shuffle is an exchange through a buffer between two barriers over the
// warp. __shared__ variables become function statics, which is sound because
// only one block runs at a time. Kernel launches are rewritten from
// `kernel<<<grid, block, smem, stream>>>(args);` to
// `emu_launch(kernel, grid, block, smem, stream, args);` before compiling. A
// launch that asks for more dynamic shared memory than the kernel may have
// is refused, as the card refuses it.
//
// Streams, events and devices: launches and copies run when they are
// issued, so issue order is the only order there is, and every stream, event
// and device call is a stand-in that succeeds.
#pragma once
#include <math.h>

#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
// a kernel parameter read in place from the parameter space; here every
// parameter is the launch's own copy, which the kernel only reads
#define __grid_constant__

struct emu_uint3 {
  unsigned x, y, z;
};
inline thread_local emu_uint3 threadIdx;
inline emu_uint3 blockIdx, blockDim, gridDim;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

struct float4 {
  float x, y, z, w;
};
struct int4 {
  int x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};

typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorMemoryAllocation = 2,
  cudaErrorInvalidDevice = 101,
  cudaErrorPeerAccessAlreadyEnabled = 704,
};
// the launch errors the runtime would report, kept until cudaGetLastError
inline cudaError_t emu_last_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  const cudaError_t err = emu_last_error;
  emu_last_error = cudaSuccess;
  return err;
}
inline const char* cudaGetErrorString(cudaError_t err) {
  return err == cudaSuccess ? "no error" : err == cudaErrorInvalidValue ? "invalid argument" : "invalid device ordinal";
}
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }

inline cudaError_t cudaDeviceEnablePeerAccess(int, unsigned) { return cudaSuccess; }

constexpr unsigned cudaEventDisableTiming = 2;
typedef struct EmuEvent* cudaEvent_t;
struct EmuEvent {};
inline cudaError_t cudaEventCreateWithFlags(cudaEvent_t* e, unsigned) {
  *e = new EmuEvent;
  return cudaSuccess;
}
inline cudaError_t cudaEventDestroy(cudaEvent_t e) {
  delete e;
  return cudaSuccess;
}
inline cudaError_t cudaEventRecord(cudaEvent_t, cudaStream_t = nullptr) { return cudaSuccess; }
inline cudaError_t cudaStreamWaitEvent(cudaStream_t, cudaEvent_t, unsigned = 0) { return cudaSuccess; }

inline cudaError_t cudaMemcpyPeerAsync(void* dst, int, const void* src, int, size_t bytes, cudaStream_t) {
  std::memcpy(dst, src, bytes);
  return cudaSuccess;
}

// Shared memory limits as on an H100: a block may opt in to 232448 bytes,
// static and dynamic together, and without opting in has 48 KiB. Every
// kernel is taken to hold emu_static_smem() bytes of static shared memory, a
// stand-in for ptxas's figure, so that a plan that leaves it out fails here
// as it fails on the card.
constexpr int kEmuOptin = 232448;
constexpr int kEmuDefaultSmem = 48 * 1024;
extern "C" __attribute__((used)) inline int emu_static_smem() { return 1984; }

enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin };
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = kEmuOptin;
  return cudaSuccess;
}
struct cudaFuncAttributes {
  size_t sharedSizeBytes;
};
template <class Kernel>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* attr, Kernel) {
  attr->sharedSizeBytes = static_cast<size_t>(emu_static_smem());
  return cudaSuccess;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline std::mutex emu_attr_mu;
inline std::map<const void*, int> emu_max_dynamic;  // by kernel, what cudaFuncSetAttribute allowed
template <class Kernel>
cudaError_t cudaFuncSetAttribute(Kernel kernel, cudaFuncAttribute, int bytes) {
  if (bytes < 0 || bytes + emu_static_smem() > kEmuOptin) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> hold(emu_attr_mu);
  emu_max_dynamic[reinterpret_cast<const void*>(kernel)] = bytes;
  return cudaSuccess;
}
template <class Kernel>
int emu_dynamic_limit(Kernel kernel) {
  std::lock_guard<std::mutex> hold(emu_attr_mu);
  const auto it = emu_max_dynamic.find(reinterpret_cast<const void*>(kernel));
  return it != emu_max_dynamic.end() ? it->second : kEmuDefaultSmem - emu_static_smem();
}

struct EmuBlock {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<uint32_t> lanes;
  std::vector<uint64_t> smem;  // dynamic shared memory, 8-byte aligned
};
inline EmuBlock* emu_block;

inline void __syncthreads() { emu_block->block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_block->warps[threadIdx.x >> 5]->arrive_and_wait(); }
inline unsigned char* emu_dynamic_smem() { return reinterpret_cast<unsigned char*>(emu_block->smem.data()); }

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
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicOr(int* p, int v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }
// redux.sync: every lane gets the warp's reduction of its lanes' values
template <class T, class F>
T emu_reduce(T v, F op) {
  static_assert(sizeof(T) == 4, "32-bit reductions only");
  const int warp = threadIdx.x >> 5;
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  emu_block->lanes[threadIdx.x] = bits;
  emu_block->warps[warp]->arrive_and_wait();
  T out{};
  for (int l = 0; l < 32; ++l) {
    T x;
    const uint32_t got = emu_block->lanes[(warp << 5) | l];
    std::memcpy(&x, &got, 4);
    out = l == 0 ? x : op(out, x);
  }
  emu_block->warps[warp]->arrive_and_wait();
  return out;
}
inline int __reduce_min_sync(unsigned, int v) { return emu_reduce(v, [](int a, int b) { return a < b ? a : b; }); }
inline int __reduce_max_sync(unsigned, int v) { return emu_reduce(v, [](int a, int b) { return a > b ? a : b; }); }
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  return emu_reduce(v, [](unsigned a, unsigned b) { return a + b; });
}
inline int __reduce_add_sync(unsigned, int v) {
  return static_cast<int>(__reduce_add_sync(0u, static_cast<unsigned>(v)));
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return emu_reduce(v, [](unsigned a, unsigned b) { return a | b; });
}

template <class Kernel, class Args>
void emu_launch(Kernel kernel, dim3 grid, int block, size_t smem, cudaStream_t, Args args) {
  if (smem > static_cast<size_t>(emu_dynamic_limit(kernel))) {
    emu_last_error = cudaErrorInvalidValue;  // refused: more shared memory than allowed
    return;
  }
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {static_cast<unsigned>(block), 1, 1};
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        EmuBlock b;
        b.block = std::make_unique<std::barrier<>>(block);
        for (int w = 0; w < block / 32; ++w) b.warps.push_back(std::make_unique<std::barrier<>>(32));
        b.lanes.resize(block);
        b.smem.assign((smem + 7) / 8, 0xA5A5A5A5A5A5A5A5ull);
        emu_block = &b;
        blockIdx = {bx, by, bz};
        std::vector<std::thread> threads;
        for (int t = 0; t < block; ++t)
          threads.emplace_back([&, t] {
            threadIdx = {static_cast<unsigned>(t), 0, 0};
            kernel(args);
          });
        for (auto& th : threads) th.join();
      }
}
