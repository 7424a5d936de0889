// Staging kernels for device residency and fleet dispatch, hand-written for
// Hopper (sm_90a).
//
//   stage_patch  <- DeviceStager._patch (karpenter_tpu/solver/staging.py:200-235):
//                   the scatter `old.at[idx].set(new[idx])` that writes a
//                   churned cell's changed axis-0 rows into its resident leaf
//   fleet_stack  <- the device-side stack of _stage_fleet_chunk
//                   (karpenter_tpu/solver/solver.py:1283-1309): jnp.stack of B
//                   resident problem rows and the pad row, for every leaf
//
// Both are copies of byte rows: they know nothing of dtypes. The plain
// PyTorch versions (index_copy_ and torch.stack) live beside the wrappers in
// solver/staging.py.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kCopyThreads = 256;
constexpr long long kMaxBlocks = 1024;  // grid-stride past this many blocks per row

// True when p, q and n are all multiples of 4: the copy then moves words.
__device__ __forceinline__ bool word_aligned(const void* p, const void* q, long long n) {
  return ((reinterpret_cast<size_t>(p) | reinterpret_cast<size_t>(q) | static_cast<size_t>(n)) & 3) == 0;
}

struct PatchArgs {
  unsigned char* dst;        // [rows, row_bytes] resident leaf
  const unsigned char* src;  // [n, row_bytes] churned rows, in idx order
  const long long* idx;      // [n] destination rows; repeats carry equal bytes
  long long n, row_bytes;
};

// stage_patch: dst[idx[j]] = src[j] for the n churned rows, one thread per
// word (or byte, for rows that are not whole words). The index set is padded
// to a power of two with repeats of its first row, whose bytes are equal, so
// the result does not depend on which repeat writes last. Bound: bytes, the
// n rows read and written once (a few rows of a few hundred bytes for a
// churned cell, so the launch itself dominates). The indices must lie in the
// leaf: the stager checks them on the host before it uploads them.
__global__ void __launch_bounds__(kCopyThreads) k_stage_patch(PatchArgs a) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (word_aligned(a.dst, a.src, a.row_bytes)) {
    const long long rw = a.row_bytes / 4;
    unsigned* dst = reinterpret_cast<unsigned*>(a.dst);
    const unsigned* src = reinterpret_cast<const unsigned*>(a.src);
    for (long long i = first; i < a.n * rw; i += stride) dst[a.idx[i / rw] * rw + i % rw] = src[i];
  } else {
    for (long long i = first; i < a.n * a.row_bytes; i += stride)
      a.dst[a.idx[i / a.row_bytes] * a.row_bytes + i % a.row_bytes] = a.src[i];
  }
}

struct StackArgs {
  const long long* table;  // [n, 3]: source address, destination address, bytes
  int n;
};

// fleet_stack: one block row (blockIdx.y) per table entry copies that entry's
// bytes, grid-striding over blockIdx.x; one launch builds every [B, ...] leaf
// of a fleet chunk from its B resident rows and the once-staged pad row.
// Bound: bytes, each row read once and written once (about 30 KB a row on the
// 500k-pod fleet's bucket), so at B=16 a few microseconds of bandwidth; the
// launch and the table's copy to the card dominate.
__global__ void __launch_bounds__(kCopyThreads) k_fleet_stack(StackArgs a) {
  const long long* e = a.table + 3 * static_cast<size_t>(blockIdx.y);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(static_cast<size_t>(e[0]));
  unsigned char* dst = reinterpret_cast<unsigned char*>(static_cast<size_t>(e[1]));
  const long long nbytes = e[2];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (word_aligned(src, dst, nbytes)) {
    const unsigned* s = reinterpret_cast<const unsigned*>(src);
    unsigned* d = reinterpret_cast<unsigned*>(dst);
    for (long long i = first; i < nbytes / 4; i += stride) d[i] = s[i];
  } else {
    for (long long i = first; i < nbytes; i += stride) dst[i] = src[i];
  }
}

unsigned blocks_for(long long units) {
  const long long b = (units + kCopyThreads - 1) / kCopyThreads;
  return static_cast<unsigned>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface: each entry launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 when the launch was accepted).
// ---------------------------------------------------------------------------

extern "C" {

int kts_stage_patch(void* dst, const void* src, const long long* idx, long long n,
                    long long row_bytes, void* stream) {
  PatchArgs a{static_cast<unsigned char*>(dst), static_cast<const unsigned char*>(src), idx, n,
              row_bytes};
  const unsigned grid = blocks_for(n * row_bytes);
  k_stage_patch<<<grid, kCopyThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// max_bytes: the largest entry's byte count, which sizes the grid's x axis.
int kts_fleet_stack(const long long* table, int n, long long max_bytes, void* stream) {
  StackArgs a{table, n};
  dim3 grid(blocks_for(max_bytes), static_cast<unsigned>(n));
  k_fleet_stack<<<grid, kCopyThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
