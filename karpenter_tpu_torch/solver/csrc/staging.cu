// Staging kernels for device residency and fleet dispatch, hand-written for
// Hopper (sm_90a).
//
//   stage_patch  <- DeviceStager._patch (karpenter_tpu/solver/staging.py:200-235):
//                   the scatter `old.at[idx].set(new[idx])` that writes a
//                   churned cell's changed axis-0 rows into its resident leaf,
//                   here for every leaf of one stage() call at once
//   fleet_stack  <- the device-side stack of _stage_fleet_chunk
//                   (karpenter_tpu/solver/solver.py:1283-1309): jnp.stack of B
//                   resident problem rows and the pad row, for every leaf
//
// Both are copies of byte rows: they know nothing of dtypes. The plain
// PyTorch versions (index_copy_ and torch.stack) live beside the wrappers in
// solver/staging.py.
//
// Both are bound by the launch, not by their bytes: a restage moves a few
// rows of a few hundred bytes, a B=16 stack under a megabyte. So each takes
// its whole work list as one __grid_constant__ kernel parameter (CUDA 12.1
// and later allow 32,764 bytes of parameters on sm_70 and later): no table
// crosses to the card by a copy of its own, a block reads its entries from
// the constant bank in place, and one launch does all the work of a call.
// The grid is sized by the bytes: the work is cut into 16-byte units (one
// unit a row chunk; a row's last chunk may be shorter), each block takes a
// balanced, contiguous share of the units, and a thread finds the entry of
// its unit by the entries' prefix of units. A unit moves as one 16-byte
// vector where its source, destination and length allow, else as words or
// bytes.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kCopyThreads = 256;
constexpr long long kUnitsPerBlock = 2 * kCopyThreads;  // 8 KB of a block's share
constexpr long long kMaxBlocks = 2048;  // past this, the shares grow
constexpr int kMaxPatches = 128;        // entries of one stage_patch launch
constexpr int kMaxStackSegs = 64;       // leaf segments of one fleet_stack launch
constexpr int kMaxStackRows = 3800;     // row sources of one fleet_stack launch
constexpr size_t kMaxParamBytes = 32764;

struct PatchEntry {
  unsigned char* dst;        // [rows, row_bytes] resident leaf
  const long long* idx;      // [n] destination rows; repeats carry equal bytes
  const unsigned char* src;  // [n, row_bytes] churned rows, in idx order
  long long row_bytes;
  long long first;           // units of the entries before this one
};

struct PatchTable {
  long long units;  // all entries' units
  int n;
  PatchEntry e[kMaxPatches];
};

struct StackSeg {
  unsigned char* dst;  // the segment's first output row; rows follow at row_bytes
  long long row_bytes;
  long long first;     // units of the segments before this one
  long long src0;      // index in StackTable::src of the segment's first row
};

struct StackTable {
  long long units;
  int n;
  StackSeg s[kMaxStackSegs];
  const unsigned char* src[kMaxStackRows];  // each row's source, segment by segment
};

static_assert(sizeof(PatchTable) <= 8192, "a stage_patch table is a few KB of parameters");
static_assert(sizeof(StackTable) <= kMaxParamBytes, "a fleet_stack table must fit the parameter space");

__device__ __forceinline__ long long chunks_of(long long row_bytes) { return (row_bytes + 15) >> 4; }

// Copy len (<= 16) bytes: one vector where both ends and the length are
// 16-byte multiples, words where they are 4-byte multiples, else bytes.
__device__ __forceinline__ void copy_unit(unsigned char* d, const unsigned char* s, long long len) {
  const size_t a = reinterpret_cast<size_t>(d) | reinterpret_cast<size_t>(s) | static_cast<size_t>(len);
  if ((a & 15) == 0) {
    *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
  } else if ((a & 3) == 0) {
    for (long long i = 0; i < len; i += 4)
      *reinterpret_cast<unsigned*>(d + i) = *reinterpret_cast<const unsigned*>(s + i);
  } else {
    for (long long i = 0; i < len; ++i) d[i] = s[i];
  }
}

// The block's balanced share [lo, hi) of `units`.
__device__ __forceinline__ void block_share(long long units, long long* lo, long long* hi) {
  *lo = units * blockIdx.x / gridDim.x;
  *hi = units * (blockIdx.x + 1) / gridDim.x;
}

// The last entry whose prefix `first` is at most u (entries ascend by first).
template <class Entry>
__device__ __forceinline__ int entry_of(const Entry* e, int n, long long u) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (e[mid].first <= u) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// stage_patch: dst[idx[j]] = src[j] for every entry's churned rows. A unit
// is a 16-byte chunk of one row; the thread walks its units in ascending
// order, so it moves from entry to entry forward. Bound: bytes, the rows
// read and written once and the indices read once (a few KB for a churned
// cell), so the launch itself is the floor. The indices must lie in their
// leaf: the stager checks them on the host before it uploads them.
__global__ void __launch_bounds__(kCopyThreads) k_stage_patch(const __grid_constant__ PatchTable t) {
  long long lo, hi;
  block_share(t.units, &lo, &hi);
  long long u = lo + threadIdx.x;
  if (u >= hi) return;
  int e = entry_of(t.e, t.n, u);
  for (; u < hi; u += blockDim.x) {
    while (e + 1 < t.n && t.e[e + 1].first <= u) ++e;
    const PatchEntry& p = t.e[e];
    const long long cpr = chunks_of(p.row_bytes);
    const long long j = (u - p.first) / cpr;
    const long long off = (u - p.first - j * cpr) << 4;
    const long long len = p.row_bytes - off < 16 ? p.row_bytes - off : 16;
    copy_unit(p.dst + p.idx[j] * p.row_bytes + off, p.src + j * p.row_bytes + off, len);
  }
}

// fleet_stack: every [B, ...] leaf of a fleet chunk from its B resident rows
// and the once-staged pad row. A segment is one leaf's run of output rows;
// a unit is a 16-byte chunk of one row. Bound: bytes, each row read once and
// written once (about 30 KB a row on the 500k-pod fleet's bucket, some
// 670 KB at B=16), so a few microseconds at most: the launch is the floor.
__global__ void __launch_bounds__(kCopyThreads) k_fleet_stack(const __grid_constant__ StackTable t) {
  long long lo, hi;
  block_share(t.units, &lo, &hi);
  long long u = lo + threadIdx.x;
  if (u >= hi) return;
  int s = entry_of(t.s, t.n, u);
  for (; u < hi; u += blockDim.x) {
    while (s + 1 < t.n && t.s[s + 1].first <= u) ++s;
    const StackSeg& g = t.s[s];
    const long long cpr = chunks_of(g.row_bytes);
    const long long b = (u - g.first) / cpr;
    const long long off = (u - g.first - b * cpr) << 4;
    const long long len = g.row_bytes - off < 16 ? g.row_bytes - off : 16;
    copy_unit(g.dst + b * g.row_bytes + off, t.src[g.src0 + b] + off, len);
  }
}

unsigned blocks_for(long long units) {
  const long long b = (units + kUnitsPerBlock - 1) / kUnitsPerBlock;
  return static_cast<unsigned>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

long long units_of(long long rows, long long row_bytes) { return rows * ((row_bytes + 15) >> 4); }

}  // namespace

// ---------------------------------------------------------------------------
// C interface: each entry launches on `stream`, allocates nothing, adds the
// launches the runtime accepted to *launches, and returns cudaGetLastError()
// (0 when every launch was accepted). A work list past one table's room is
// split over launches.
// ---------------------------------------------------------------------------

extern "C" {

// patches: [n, 5] of (destination leaf, indices, source rows, rows, row
// bytes), addresses as integers; entries of no rows or no bytes are skipped.
int kts_stage_patch(const long long* patches, int n, void* stream, int* launches) {
  static thread_local PatchTable t;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  t.n = 0;
  t.units = 0;
  for (int i = 0; i <= n; ++i) {
    const bool last = i == n;
    if (t.n && (last || t.n == kMaxPatches)) {
      k_stage_patch<<<blocks_for(t.units), kCopyThreads, 0, st>>>(t);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      ++*launches;
      t.n = 0;
      t.units = 0;
    }
    if (last) break;
    const long long* p = patches + 5 * static_cast<size_t>(i);
    const long long units = units_of(p[3], p[4]);
    if (units <= 0) continue;
    PatchEntry& e = t.e[t.n++];
    e.dst = reinterpret_cast<unsigned char*>(static_cast<size_t>(p[0]));
    e.idx = reinterpret_cast<const long long*>(static_cast<size_t>(p[1]));
    e.src = reinterpret_cast<const unsigned char*>(static_cast<size_t>(p[2]));
    e.row_bytes = p[4];
    e.first = t.units;
    t.units += units;
  }
  return 0;
}

// leaves: [n, 2] of (output base, row bytes); srcs: [n, B], leaf k's row b's
// source at srcs[k * B + b]. Leaves of no bytes are skipped.
int kts_fleet_stack(const long long* leaves, const long long* srcs, int n, int B, void* stream,
                    int* launches) {
  static thread_local StackTable t;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  t.n = 0;
  t.units = 0;
  long long rows = 0;  // sources in t.src
  auto flush = [&]() -> cudaError_t {
    if (!t.n) return cudaSuccess;
    k_fleet_stack<<<blocks_for(t.units), kCopyThreads, 0, st>>>(t);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++*launches;
    t.n = 0;
    t.units = 0;
    rows = 0;
    return err;
  };
  for (int k = 0; k < n; ++k) {
    const long long row_bytes = leaves[2 * k + 1];
    if (row_bytes <= 0) continue;
    for (int b0 = 0; b0 < B;) {
      if (t.n == kMaxStackSegs || rows == kMaxStackRows) {
        const cudaError_t err = flush();
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      const long long room = kMaxStackRows - rows;
      const int b1 = B - b0 < room ? B : b0 + static_cast<int>(room);
      StackSeg& g = t.s[t.n++];
      g.dst = reinterpret_cast<unsigned char*>(static_cast<size_t>(leaves[2 * k] + b0 * row_bytes));
      g.row_bytes = row_bytes;
      g.first = t.units;
      g.src0 = rows;
      for (int b = b0; b < b1; ++b)
        t.src[rows++] = reinterpret_cast<const unsigned char*>(
            static_cast<size_t>(srcs[static_cast<size_t>(k) * B + b]));
      t.units += units_of(b1 - b0, row_bytes);
      b0 = b1;
    }
  }
  return static_cast<int>(flush());
}

}  // extern "C"
