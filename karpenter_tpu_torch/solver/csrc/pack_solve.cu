// Packing kernels for the portfolio solve, hand-written for Hopper (sm_90a).
//
// Three kernels replace the XLA program of karpenter_tpu/solver/jax_solver.py:
//
//   K1 shared_precompute  <- _shared_precompute (jax_solver.py:193-281),
//                            launched as two kernels: k1_units (the unit
//                            counts and partial minima, grid wide) then
//                            k1_val_pair (lam, units_rsv and the table)
//   K2 pack_member        <- _pack_member under vmap (jax_solver.py:295-535),
//                            launched once per search phase as two kernels:
//                            k2_prices (the lookahead members' prices, grid
//                            wide) then k2_scan (one block per member)
//   K3 pack_epilogue      <- the argmin and buffer packing of
//                            _pack_solve_fused_impl (jax_solver.py:538-604)
//
// One solve is K1, K2, K2, K3 on one stream and one copy of the result buffer
// to the host. The plain PyTorch versions of all three live beside their
// wrappers in solver/torch_solver.py.
//
// The meshed tier's kernels (the 2D mesh's option shards and the 1D mesh's
// member argmin, replacing what XLA partitions for _get_jit(..., mesh=...),
// jax_solver.py:842-900) follow K3; their wrappers, plain versions and the
// exchanges between shards are in solver/meshed.py.
//
// Batch axis. Every entry takes B stacked problems of one shape and solves
// them in the same four launches: this is the fleet dispatch of the sharded
// round (pack_solve_fleet, jax_solver.py:615-643, which runs the B=1 program
// under vmap). Each block finds its row b (blockIdx.z for K1's two passes and
// k2_prices, blockIdx.y for k2_scan's (K, B) grid and K3's (tiles, B) grid)
// and offsets every input, output and scratch pointer by that row's
// size_t stride (k1_row, k2_row, k3_row); the rest is the B=1 code, so row b of
// a batch computes what a B=1 launch of problem b computes, bit for bit.
// Nothing is shared between rows: phase 2 takes the argmin of its own row's
// phase-1 costs, and K3 reads only its own row's members.
//
// Numerics. Build with --fmad=false and without --use_fast_math: IEEE division,
// no flush to zero, and no multiply-add contraction the source does not ask
// for. XLA does contract five multiply-adds of the reference program (the
// residual `alloc - units*d`, the slot updates `rem - n*d`, the lookahead price
// `price - 0.9*val`, the mixed cost `n_full*price + tail` and the member cost
// `sum + unplaced*penalty`); those are written here as explicit __fmaf_rn so
// that every rounding matches. Every float literal carries its `f`. Ceil
// division of non-negative ints is (a + b - 1) / b: C++ `/` truncates toward
// zero. Every argmin/argmax resolves ties to the lower index, as jnp does, and
// the argmins over member costs pick the first NaN before any number, as
// jnp.argmin and torch.argmin do (argmin_before).

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>
#include <new>

namespace {

constexpr float kInf = 1e30f;            // jax_solver.INF
constexpr int kIBig = 1 << 30;           // jax_solver.IBIG
constexpr float kIBigF = 1073741824.0f;  // IBIG as f32 (exact)
constexpr float kEps = 1e-4f;            // fit epsilon, biased toward placing
constexpr float kTiny = 1e-30f;          // divisor guard
constexpr float kTieBand = 1.0001f;      // _argmin_tiebreak candidate band
constexpr float kDiscount = 0.9f;        // LOOKAHEAD_DISCOUNT
constexpr float kFloor = 0.25f;          // LOOKAHEAD_FLOOR
constexpr float kPenalty = 1e6f;         // UNPLACED_PENALTY
constexpr int kMaxR = 8;
constexpr int kMaxZ = 32;
constexpr int kMaxZb = kMaxZ + 1;
constexpr int kMaxSeg = 2 * kMaxZb;
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kK1Threads = 256;
constexpr int kK2Threads = 1024;       // K2's scan: one block per (member, row)
constexpr int kK2PriceThreads = 256;   // K2's lookahead prices
constexpr int kK3Threads = 256;       // K3: one 16-byte copy a thread
constexpr int kK3Tile = 4 * kK3Threads;  // K3: ints of the buffer a block writes

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// ---------------------------------------------------------------------------
// Block-wide helpers. blockDim.x is a multiple of 32. Each helper ends with a
// barrier, so its shared scratch is free again on return.
// ---------------------------------------------------------------------------

struct Scratch {
  int i[33];
  float f[33];
};

__device__ __forceinline__ int warp_sum(int v) {
  unsigned x = static_cast<unsigned>(v);  // wraps like XLA's int32 sums
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return static_cast<int>(x);
}

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// (v, i) beats the incumbent when larger, or equal with a lower index.
__device__ __forceinline__ void arg_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// (v2, i2) comes before (v, i) under jnp.argmin and torch.argmin: the first
// NaN, else the first minimum. With unique indices this orders any set of
// candidates totally, so a scan in index order and a warp's butterfly
// reduction pick the same one.
__device__ __forceinline__ bool argmin_before(float v2, int i2, float v, int i) {
  const bool nan2 = v2 != v2, nan = v != v;
  if (nan2 != nan) return nan2;
  return nan2 ? i2 < i : v2 < v || (v2 == v && i2 < i);
}

// The warp's argmin_before-first index among cost(0..n-1), on every lane.
template <class F>
__device__ __forceinline__ int warp_argmin(F cost, int n) {
  float v = 0.0f;
  int i = kIntMax;  // no candidate yet
  for (int j = threadIdx.x & 31; j < n; j += 32) {
    const float c = cost(j);
    if (i == kIntMax || argmin_before(c, j, v, i)) {
      v = c;
      i = j;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, v, o);
    const int i2 = __shfl_xor_sync(kFull, i, o);
    if (i2 != kIntMax && (i == kIntMax || argmin_before(v2, i2, v, i))) {
      v = v2;
      i = i2;
    }
  }
  return i;
}

__device__ int block_sum(int v, Scratch& sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) sh.i[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int x = lane < nw ? sh.i[lane] : 0;
    x = warp_sum(x);
    if (lane == 0) sh.i[32] = x;
  }
  __syncthreads();
  const int r = sh.i[32];
  __syncthreads();
  return r;
}

__device__ float block_sum_f(float v, Scratch& sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum_f(v);
  if (lane == 0) sh.f[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float x = lane < nw ? sh.f[lane] : 0.0f;
    x = warp_sum_f(x);
    if (lane == 0) sh.f[32] = x;
  }
  __syncthreads();
  const float r = sh.f[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }  // a >= 0, b >= 1

// Whole pods of per-pod demand d that fit in capacity c (jax_solver._units).
__device__ __forceinline__ int fit_units(const float* c, const float* d, int R) {
  float m = kInf;
  for (int r = 0; r < R; ++r) {
    const float s = d[r] > 0.0f ? c[r] / fmaxf(d[r], kTiny) : kInf;
    m = r == 0 ? s : fminf(m, s);
  }
  const float u = floorf(m + kEps);
  return static_cast<int>(fminf(fmaxf(u, 0.0f), kIBigF));
}

// ---------------------------------------------------------------------------
// K1: shared precompute
// ---------------------------------------------------------------------------

struct K1Args {
  const float* demand;        // [G, R]
  const float* demand_units;  // [G, R]
  const int* count;           // [G]
  const int* node_cap;        // [G]
  const int* quota;           // [G, Z]
  const bool* colocate;       // [G]
  const bool* compat;         // [G, O]
  const float* alloc;         // [O, R]
  const float* price;         // [O]
  const bool* opt_valid;      // [O]
  const bool* ex_compat;      // [G, E]
  const bool* ex_valid;       // [E]
  int* units;                 // [G, O]
  int* units_rsv;             // [G, O]
  bool* rsv_group;            // [G]
  float* lam;                 // [G]
  bool* zone_limited;         // [G]
  float* val_pair;            // [G, O, G]
  bool* exok_pad;             // [G, E+S]
  bool* is_new;               // [E+S]
  float* part_min;            // [G, k1_tiles(O)] out: each k1_units block's rate minimum
  int* part_fit;              // [G, k1_tiles(O)] out: and whether an option fits the reserve
  int G, O, E, R, Z, S;
  int pair_rows;              // groups g a k1_val_pair block takes (k1_pair_rows)
};

// k1_units' tiles of the option axis: runs of whole blocks' worth of
// options, at most kK1MaxTiles of them, so that one warp's lanes reduce a
// group's partials.
constexpr int kK1MaxTiles = 32;

// Shards a meshed launch's table names at most (solver/meshed.py).
constexpr int kMeshMaxShards = 64;

// The buffers of k1_units' partials that K1's finish on an option shard
// reduces (k1_val_pair_shards, meshed.py), one a shard, each read in place:
// [2][B][G][k1_tiles(O)] words, the rate minima as f32 bits, then the
// reserve fits.
struct K1Parts {
  const int* p[kMeshMaxShards];
  int n;
};

struct K1PairArgs {
  K1Args k1;
  K1Parts parts;
};
__host__ __device__ __forceinline__ int k1_span(int O) {
  const int blocks = (O + kK1Threads - 1) / kK1Threads;
  return kK1Threads * ((blocks + kK1MaxTiles - 1) / kK1MaxTiles);
}
__host__ __device__ __forceinline__ int k1_tiles(int O) { return (O + k1_span(O) - 1) / k1_span(O); }

// K1Args of batch row b: every array advanced by b times its per-row size.
__device__ __forceinline__ K1Args k1_row(K1Args a, size_t b) {
  const size_t G = a.G, O = a.O, E = a.E, R = a.R, Z = a.Z, NS = a.E + a.S, NT = k1_tiles(a.O);
  a.demand += b * G * R;
  a.demand_units += b * G * R;
  a.count += b * G;
  a.node_cap += b * G;
  a.quota += b * G * Z;
  a.colocate += b * G;
  a.compat += b * G * O;
  a.alloc += b * O * R;
  a.price += b * O;
  a.opt_valid += b * O;
  a.ex_compat += b * G * E;
  a.ex_valid += b * E;
  a.units += b * G * O;
  a.units_rsv += b * G * O;
  a.rsv_group += b * G;
  a.lam += b * G;
  a.zone_limited += b * G;
  a.val_pair += b * G * O * G;
  a.exok_pad += b * G * NS;
  a.is_new += b * NS;
  a.part_min += b * G * NT;
  a.part_fit += b * G * NT;
  return a;
}

__device__ __forceinline__ int finish_units(int un, bool ok, int cap, bool coloc, int cnt) {
  un = min(un, cap);
  if (!ok) un = 0;
  if (coloc && un < cnt) un = 0;
  return un;
}

// A read-only load through the non-coherent global path: the compiler may
// issue it ahead of shared-memory stores, so that a block's loads fly
// together. For data the kernel does not write (or wrote in an earlier
// launch).
template <class T>
__device__ __forceinline__ T ldg(const T* p) { return __ldg(p); }
__device__ __forceinline__ bool ldg(const bool* p) {
  return __ldg(reinterpret_cast<const unsigned char*>(p)) != 0;
}

// fit_units on a row, unrolled over kMaxR, so that no row lands in local
// memory: the same operations.
__device__ __forceinline__ int fit_units_r(const float* c, const float (&d)[kMaxR], int R) {
  float m = kInf;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r < R) {
      const float s = d[r] > 0.0f ? c[r] / fmaxf(d[r], kTiny) : kInf;
      m = r == 0 ? s : fminf(m, s);
    }
  }
  const float u = floorf(m + kEps);
  return static_cast<int>(fminf(fmaxf(u, 0.0f), kIBigF));
}

// K1a replaces _shared_precompute's per-group part (jax_solver.py:206-243).
// Grid (tiles of O, G, B), one option a thread (a tile is one block's worth
// of options up to 8,192 options, a few beyond), so the whole card takes
// the G*O unit counts. A block issues every load it needs in one round
// (its options' alloc rows coalesced into shared memory); it writes units
// (finished: it does not depend on row_fits) and the raw reserve-sized
// count, and one partial rate minimum and one partial "fits the reserve"
// flag for its (b, g, tile), which k1_val_pair reduces. fminf and OR are
// exact and order-free, so any split gives the same lam and row_fits bit
// for bit, and the scratch needs no atomics and no initialisation. The
// blocks of a row g also write its exok_pad row (and those of g = 0
// is_new), grid-stride over the row's tiles; the last tile's last warp
// writes zone_limited and rsv_group. Bound: the [G, O] compat reads and the
// two [G, O] unit writes, ~1 MB at 50k_full; on the card a launch and one
// round of loads take more (PERF.md, K1 findings).
template <int kR>  // R when it is kR (> 0), so that its loops unroll; any R when 0
__global__ void __launch_bounds__(kK1Threads) k1_units(K1Args p) {
  __shared__ float s_alloc[kK1Threads * kMaxR];
  __shared__ float s_min[32];
  __shared__ unsigned s_fit[32];
  const K1Args a = k1_row(p, blockIdx.z);
  const int tile = blockIdx.x, nt = gridDim.x, g = blockIdx.y;
  const int O = a.O, R = kR > 0 ? kR : a.R, Z = a.Z, tid = threadIdx.x, BT = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = BT >> 5;
  float d[kMaxR], du[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    d[r] = r < R ? ldg(a.demand + (size_t)g * R + r) : 0.0f;
    du[r] = r < R ? ldg(a.demand_units + (size_t)g * R + r) : 0.0f;
  }
  const int cap = ldg(a.node_cap + g), cnt = ldg(a.count + g);
  const bool coloc = ldg(a.colocate + g);
  // the last tile's last warp: zone_limited and rsv_group (Z <= 32)
  const bool flags = tile == nt - 1 && wid == nw - 1;
  const unsigned zl = flags && lane < Z && ldg(a.quota + (size_t)g * Z + lane) < kIBig ? 1u : 0u;
  const int span = k1_span(O), o_end = min(O, (tile + 1) * span);
  float rate = kInf;
  unsigned fits = 0;
  for (int o0 = tile * span; o0 < o_end; o0 += BT) {
    const int n = min(BT, o_end - o0);
    // every load first, each into a register of its own, so that they fly
    // together; then the stores to shared memory
    constexpr int kSlots = kR > 0 ? kR : kMaxR;  // alloc words a thread stages
    float av[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int i = tid + k * BT;
      av[k] = i < n * R ? ldg(a.alloc + (size_t)o0 * R + i) : 0.0f;
    }
    const int o = o0 + tid;
    const size_t go = (size_t)g * O + o;
    const bool live = tid < n;
    const bool comp = live && ldg(a.compat + go), valid = live && ldg(a.opt_valid + o);
    const float pr = live ? ldg(a.price + o) : 0.0f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int i = tid + k * BT;
      if (i < n * R) s_alloc[i] = av[k];
    }
    const bool ok = comp & valid;
    __syncthreads();
    if (live) {
      const float* c = s_alloc + tid * R;
      const int ur = fit_units_r(c, d, R), uv = fit_units_r(c, du, R);
      fits |= uv > 0 && ok ? 1u : 0u;
      const int un = finish_units(ur, ok, cap, coloc, cnt);
      a.units[go] = un;
      a.units_rsv[go] = uv;  // raw: k1_val_pair finishes it once row_fits is known
      if (un > 0) rate = fminf(rate, pr / fmaxf(static_cast<float>(un), 1.0f));
    }
    __syncthreads();  // s_alloc restages
  }
  rate = warp_min(rate);
  fits = __reduce_or_sync(kFull, fits);
  if (lane == 0) {
    s_min[wid] = rate;
    s_fit[wid] = fits;
  }
  const int NS = a.E + a.S;
  for (int s = tile * BT + tid; s < NS; s += nt * BT) {
    a.exok_pad[(size_t)g * NS + s] =
        s < a.E && (ldg(a.ex_compat + (size_t)g * a.E + s) & ldg(a.ex_valid + s));
    if (g == 0) a.is_new[s] = s >= a.E;
  }
  if (flags) {
    unsigned diff = 0;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) diff |= r < R && du[r] != d[r] ? 1u : 0u;
    const unsigned limited = __reduce_or_sync(kFull, zl);
    if (lane == 0) {
      a.zone_limited[g] = limited != 0;
      a.rsv_group[g] = diff != 0;
    }
  }
  __syncthreads();
  if (wid == 0) {
    rate = warp_min(lane < nw ? s_min[lane] : kInf);
    fits = __reduce_or_sync(kFull, lane < nw ? s_fit[lane] : 0u);
    if (lane == 0) {
      a.part_min[(size_t)g * nt + tile] = rate;
      a.part_fit[(size_t)g * nt + tile] = static_cast<int>(fits);
    }
  }
}

// k1_val_pair's blocks: kK1PairTile options by kK1PairRows groups g, the
// groups g' staged kK1PairChunk at a time.
constexpr int kK1PairTile = 64;
constexpr int kK1PairRows = kK1Threads / kK1PairTile;  // a thread finishes one (g, o) of units_rsv
constexpr int kK1PairChunk = 32;
constexpr int kK1OkStride = kK1PairChunk + 4;  // bytes an option's staged compat row takes
constexpr int kK1Warps = kK1Threads / 32;
static_assert(kK1PairRows * kK1PairTile == kK1Threads && kK1MaxTiles <= 32, "k1_val_pair's staging");
// what a thread stages: residual words, compat bytes, demand words, and
// partial minima (one warp's lanes hold one group's)
constexpr int kK1OkPer = (kK1PairTile * kK1PairChunk + kK1Threads - 1) / kK1Threads;
constexpr int kK1LamPer = (kK1PairChunk + kK1Warps - 1) / kK1Warps;
// k1_val_pair takes kK1PairRows groups g a block, so that they share the
// staged g' data, once that leaves at least this many blocks; else one, so
// that a small problem still spreads over the card
constexpr int kK1PairRowsFrom = 256;

int k1_pair_rows(int B, int G, int O) {
  const long long tiles = (O + kK1PairTile - 1) / kK1PairTile;
  return tiles * ((G + kK1PairRows - 1) / kK1PairRows) * B >= kK1PairRowsFrom ? kK1PairRows : 1;
}

// K1b replaces the lookahead value table (jax_solver.py:245-264):
// val_pair[g, o, g'] = whole pods of g' that fit in the residual of one (g, o)
// node, times g''s cheapest per-pod rate. Grid (tiles of O, blocks of
// k1_pair_rows groups g, B). A block loads, through the read-only path so
// that the loads fly together: the residual inputs of each of its (g, o)
// (the residual is computed once per (g, o), from the units k1_units
// wrote), units_rsv and the row_fits partials of its rows, and for a chunk
// of groups g' their partial minima (lam), demand, node_cap and the tile's
// compat, each read coalesced along its fastest axis; the g' data serve
// all its rows. It then reduces lam (its tile-0 blocks write lam[g]),
// finishes units_rsv of its (g, o) now that row_fits is known, and writes,
// row by row, its [tile, G'] slabs of the table with g' fastest, as the
// table lies, coalesced and cached: k2_prices reads it from L2 next. Each
// thread keeps one g', whose demand, cap and lam stay in registers. Bound:
// the table's bytes (16.8 MB at 50k_full, ~0.005 ms), below what holds it
// on the card: each block's prologue, thousands of cycles of instruction
// latency (which 4 groups a block share), and the instruction path of each
// element (PERF.md, K1 findings). Every quotient stays a correctly rounded
// division; an element whose option g' cannot use, or whose lam is +0, is
// 0 whatever the quotients give, and skips them.
//
// Two kernels share this body. k1_val_pair (K1) reads a group's tiles of
// partials from K1's own scratch, a lane a tile. k1_val_pair_shards (K1's
// finish on an option shard, meshed.py) reads every shard's buffer through
// its K1Parts table, a lane a tile too: the first shard's with the round's
// other loads, the others' in a loop after them, through pointers uniform
// across the block. fminf and OR are exact and order-free, so this is K1's
// reduction. A lane a (shard, tile) pair instead kept a per-lane pointer
// live and took 116 registers against K1's 80 (PERF.md, row 5), and the
// table folded into K1's own kernel cost it 2.6 us of its 29, so K1 keeps
// the code it had.
template <int kR, bool kTable>  // kR as k1_units'; kTable: the partials through `parts`
__device__ __forceinline__ void k1_val_pair_body(const K1Args& p, const K1Parts& parts) {
  __shared__ float s_resid[kK1PairRows * kK1PairTile * kMaxR];  // [row][o][r]
  __shared__ float s_d[kK1PairChunk * kMaxR];
  __shared__ float s_cap[kK1PairChunk], s_lam[kK1PairChunk];
  __shared__ bool s_ok[kK1PairTile * kK1OkStride];  // [o][g'] compat && opt_valid
  __shared__ int s_row_fits[kK1PairRows];
  const K1Args a = k1_row(p, blockIdx.z);
  const int O = a.O, G = a.G, R = kR > 0 ? kR : a.R;
  const int tid = threadIdx.x, BT = blockDim.x, lane = tid & 31, wid = tid >> 5;
  const int o0 = blockIdx.x * kK1PairTile, n = min(kK1PairTile, O - o0), nt1 = k1_tiles(O);
  const int g0 = blockIdx.y * a.pair_rows, rows = min(a.pair_rows, G - g0);
  // with the table: each buffer holds the B rows' minima, then (`half`
  // further) their fits; this row's start at row0
  const size_t half = (size_t)gridDim.z * G * nt1, row0 = (size_t)blockIdx.z * G * nt1;
  // this thread's (g, o) of units_rsv
  const int gr_f = tid / kK1PairTile, ol_f = tid % kK1PairTile;
  const int g_f = g0 + gr_f, o_f = o0 + ol_f;
  const bool own = gr_f < rows && ol_f < n;
  const size_t go_f = (size_t)g_f * O + o_f;
  const int uv_raw = own ? a.units_rsv[go_f] : 0;
  const bool ok_f = own && (ldg(a.compat + go_f) & ldg(a.opt_valid + o_f));
  const int cap_f = own ? ldg(a.node_cap + g_f) : 0, cnt_f = own ? ldg(a.count + g_f) : 0;
  const bool coloc_f = own && ldg(a.colocate + g_f);
  // every load of the block first, each into a register of its own, so
  // that they fly together; then the stores to shared memory. First the
  // block's rows: their row_fits partials and the inputs of their residuals
  constexpr int RR = kR > 0 ? kR : kMaxR;
  constexpr int kResid = (kK1PairRows * kK1PairTile * RR + kK1Threads - 1) / kK1Threads;
  constexpr int kDemand = (kK1PairChunk * RR + kK1Threads - 1) / kK1Threads;
  constexpr int kFit = (kK1PairRows + kK1Warps - 1) / kK1Warps;
  unsigned fv[kFit];
#pragma unroll
  for (int k = 0; k < kFit; ++k) {
    const int gr = wid + k * kK1Warps;
    if constexpr (kTable)
      fv[k] = gr < rows && lane < nt1
                  ? static_cast<unsigned>(ldg(parts.p[0] + row0 + half + (size_t)(g0 + gr) * nt1 + lane))
                  : 0u;
    else
      fv[k] = gr < rows && lane < nt1 ? static_cast<unsigned>(ldg(a.part_fit + (size_t)(g0 + gr) * nt1 + lane))
                                      : 0u;
  }
  const int span = n * R;  // residual words of a row
  float ru[kResid], rd[kResid], ra[kResid];
  int ri[kResid];  // where each goes in s_resid, or -1
#pragma unroll
  for (int k = 0; k < kResid; ++k) {
    const int i = tid + k * BT;
    ri[k] = -1;
    ru[k] = rd[k] = ra[k] = 0.0f;
    if (i < rows * span) {
      const int gr = i / span, w = i - gr * span, ol = w / R;
      const int g = g0 + gr;
      ri[k] = gr * kK1PairTile * kMaxR + w;
      ru[k] = static_cast<float>(ldg(a.units + (size_t)g * O + o0 + ol));
      rd[k] = ldg(a.demand + (size_t)g * R + (w - ol * R));
      ra[k] = ldg(a.alloc + (size_t)o0 * R + w);
    }
  }
  // this thread's option of the tile and its first group g' of a chunk
  const int ol_s = tid % kK1PairTile, j_s = tid / kK1PairTile, j_step = BT / kK1PairTile;
  const bool valid_s = ol_s < n && ldg(a.opt_valid + o0 + ol_s);
  for (int c0 = 0; c0 < G; c0 += kK1PairChunk) {
    const int gc = min(kK1PairChunk, G - c0);
    // then the chunk's groups g': partial minima, compat, demand, node_cap
    float pm[kK1LamPer];
#pragma unroll
    for (int k = 0; k < kK1LamPer; ++k) {
      const int j = wid + k * kK1Warps;
      if constexpr (kTable)
        pm[k] = j < gc && lane < nt1 ? __int_as_float(ldg(parts.p[0] + row0 + (size_t)(c0 + j) * nt1 + lane))
                                     : kInf;
      else
        pm[k] = j < gc && lane < nt1 ? ldg(a.part_min + (size_t)(c0 + j) * nt1 + lane) : kInf;
    }
    bool okv[kK1OkPer];
#pragma unroll
    for (int k = 0; k < kK1OkPer; ++k) {
      const int j = j_s + k * j_step;
      okv[k] = j < gc && ol_s < n && ldg(a.compat + (size_t)(c0 + j) * O + o0 + ol_s);
    }
    float dv[kDemand];
#pragma unroll
    for (int k = 0; k < kDemand; ++k) {
      const int i = tid + k * BT;
      dv[k] = i < gc * R ? ldg(a.demand + (size_t)c0 * R + i) : 0.0f;
    }
    const float capv = tid < gc ? static_cast<float>(ldg(a.node_cap + c0 + tid)) : 0.0f;
    // the table's other shards' partials, each lane its tile of each
    for (int q = 1; kTable && q < parts.n && lane < nt1; ++q) {
      const int* pq = parts.p[q] + row0 + lane;
#pragma unroll
      for (int k = 0; k < kK1LamPer; ++k) {
        const int j = wid + k * kK1Warps;
        if (j < gc) pm[k] = fminf(pm[k], __int_as_float(ldg(pq + (size_t)(c0 + j) * nt1)));
      }
#pragma unroll
      for (int k = 0; k < kFit; ++k) {
        const int gr = wid + k * kK1Warps;
        if (c0 == 0 && gr < rows) fv[k] |= static_cast<unsigned>(ldg(pq + half + (size_t)(g0 + gr) * nt1));
      }
    }
    // the stores
    if (c0 == 0) {
#pragma unroll
      for (int k = 0; k < kResid; ++k)
        if (ri[k] >= 0) s_resid[ri[k]] = __fmaf_rn(-ru[k], rd[k], ra[k]);
#pragma unroll
      for (int k = 0; k < kFit; ++k) {
        const int gr = wid + k * kK1Warps;
        const unsigned fits = __reduce_or_sync(kFull, fv[k]);
        if (lane == 0 && gr < rows) s_row_fits[gr] = fits != 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kK1OkPer; ++k) {
      const int j = j_s + k * j_step;
      if (j < gc && ol_s < n) s_ok[ol_s * kK1OkStride + j] = valid_s & okv[k];
    }
#pragma unroll
    for (int k = 0; k < kDemand; ++k) {
      const int i = tid + k * BT;
      if (i < gc * R) s_d[i] = dv[k];
    }
    if (tid < gc) s_cap[tid] = capv;
#pragma unroll
    for (int k = 0; k < kK1LamPer; ++k) {
      const int j = wid + k * kK1Warps;
      const float m = warp_min(pm[k]);
      if (lane == 0 && j < gc) {
        const float lam = m < kInf ? m : 0.0f;
        s_lam[j] = lam;
        if (blockIdx.x == 0 && c0 + j >= g0 && c0 + j < g0 + rows) a.lam[c0 + j] = lam;
      }
    }
    __syncthreads();
    if (c0 == 0 && own) {
      // units_rsv of (g, o): an option that cannot hold one provider pod
      // plus its reserve stays 0 for reserve members, unless no option fits
      // the reserve at all
      int uv = uv_raw;
      if (s_row_fits[gr_f] == 0) {
        float d[kMaxR];
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) d[r] = r < R ? ldg(a.demand + (size_t)g_f * R + r) : 0.0f;
        const int ur = fit_units_r(a.alloc + (size_t)o_f * R, d, R);
        if (ur > 0) uv = ur;
      }
      a.units_rsv[go_f] = finish_units(uv, ok_f, cap_f, coloc_f, cnt_f);
    }
    // each thread keeps one g' j, so that its demand, cap and lam stay in
    // registers: the chunk's groups padded to a power of two, which divides
    // the block, and threads past the chunk idle
    int jp = 1;
    while (jp < gc) jp <<= 1;
    const int j = tid & (jp - 1), step_o = BT / jp;
    const float lam = j < gc ? s_lam[j] : 0.0f, cap = j < gc ? s_cap[j] : 0.0f;
    float dj[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) dj[r] = r < R && j < gc ? s_d[j * R + r] : 0.0f;
    const bool live = __float_as_int(lam) != 0;
    for (int gr = 0; gr < rows && j < gc; ++gr) {
      const float* res = s_resid + gr * kK1PairTile * kMaxR;
      float* out = a.val_pair + ((size_t)(g0 + gr) * O + o0) * G + c0 + j;
      for (int ol = tid / jp; ol < n; ol += step_o) {
        float v = 0.0f;
        if (live && s_ok[ol * kK1OkStride + j]) {
          const float* rs = res + ol * R;
          float u2 = kInf;
#pragma unroll
          for (int r = 0; r < RR; ++r) {
            if (r < R) {
              const float ur = dj[r] > 0.0f ? floorf(rs[r] / fmaxf(dj[r], kTiny) + kEps) : kInf;
              u2 = r == 0 ? ur : fminf(u2, ur);
            }
          }
          u2 = fminf(fminf(fmaxf(u2, 0.0f), kIBigF), cap);
          if (u2 > 0.0f) v = u2 * lam;
        }
        out[ol * G] = v;
      }
    }
    __syncthreads();  // the next chunk restages
  }
}

template <int kR>  // as k1_units'
__global__ void __launch_bounds__(kK1Threads) k1_val_pair(K1Args p) {
  k1_val_pair_body<kR, false>(p, K1Parts{});
}

template <int kR>  // as k1_units'
__global__ void __launch_bounds__(kK1Threads) k1_val_pair_shards(const __grid_constant__ K1PairArgs pa) {
  k1_val_pair_body<kR, true>(pa.k1, pa.parts);
}

// ---------------------------------------------------------------------------
// K2: one phase of portfolio members
// ---------------------------------------------------------------------------

struct K2Args {
  const float* demand;          // [G, R]
  const float* demand_units;    // [G, R]
  const int* count;             // [G]
  const int* node_cap;          // [G]
  const bool* colocate;         // [G]
  const bool* compat;           // [G, O]
  const float* alloc;           // [O, R]
  const float* price;           // [O]
  const int* opt_zone;          // [O]
  const float* ex_rem;          // [E, R]
  const int* ex_zone;           // [E]
  const bool* ex_valid;         // [E]
  const int* rel_set;           // [G]
  const int* rel_host_forbid;   // [G]
  const int* rel_host_need;     // [G]
  const int* rel_zone_forbid;   // [G]
  const int* rel_zone_need;     // [G]
  const int* rel_slot_bits;     // [E]
  const int* rel_zone_bits;     // [Z]
  const int* units;             // [G, O]
  const int* units_rsv;         // [G, O]
  const bool* rsv_group;        // [G]
  const int* quota;             // [G, Z]
  const bool* zone_limited;     // [G]
  const float* val_pair;        // [G, O, G]
  const bool* exok_pad;         // [G, E+S]
  const int* orders;            // [K, G]
  const float* alphas;          // [K]
  const bool* looks;            // [K]
  const bool* rsvs;             // [K]
  const int* swaps;             // [K, G] (phase 2 only)
  const float* seed_costs;      // [K] phase-1 costs, or null for phase 1
  float* cost;                  // [K]
  int* unplaced;                // [K]
  bool* exhausted;              // [K]
  int* new_opt;                 // [K, S]
  bool* new_active;             // [K, S]
  int* ys;                      // [K, T=G, E+S]
  float* price_t;               // scratch [K, G, O], written for lookahead members only
  unsigned char* state;         // scratch [K, k2_scratch_bytes], or null when spill is 0
  int spill;                    // what the scan keeps in global scratch (k2_plan)
  int K, G, O, E, R, Z, S;
};

// Per-group words staged in shared memory by the scan's prologue.
enum { kGiCount, kGiCap, kGiColoc, kGiHostForbid, kGiHostNeed, kGiZoneForbid, kGiZoneNeed,
       kGiSet, kGiZoneLimited, kGiRsvGroup, kGi };

__host__ __device__ __forceinline__ size_t round16(size_t b) { return (b + 15) & ~static_cast<size_t>(15); }

// Words of one slot's record in the scan's per-step state: opt, zone, bits,
// fit, place, active, then rem[R].
enum { kSlOpt, kSlZone, kSlBits, kSlFit, kSlPlace, kSlAct, kSlRem };

// The scan's memory is three regions, in this order: the per-warp partials of
// the option rounds, the staged groups (with the scan order), and the
// per-step state. The partials are always in dynamic shared memory; what
// does not fit beside them under the card's limit goes to global scratch,
// the state first (spill 1), then the groups too (spill 2), and the same
// code runs on it (k2_plan).
__host__ __device__ __forceinline__ size_t k2_partial_bytes(int Z, int nw) {
  return static_cast<size_t>(nw) * (Z + 1) * 12 * 4;
}

__host__ __device__ __forceinline__ size_t k2_group_bytes(int G, int R, int Z) {
  return round16(static_cast<size_t>(G) * (1 + kGi + 2 * R + Z) * 4);
}

// One member's per-step state: the step's option scores [O][lump (then tail),
// rate] f32, each written and read by the thread that owns the option (o =
// tid + j * blockDim); then the slots' records [NS][kSlRem + R].
__host__ __device__ __forceinline__ size_t k2_state_bytes(int NS, int R, int O) {
  return round16(8 * static_cast<size_t>(O)) + round16(static_cast<size_t>(NS) * (kSlRem + R) * 4);
}

// One member's global scratch under a spill level.
__host__ __device__ __forceinline__ size_t k2_scratch_bytes(int spill, int G, int O, int R, int Z,
                                                            int NS) {
  return (spill >= 2 ? k2_group_bytes(G, R, Z) : 0) + (spill >= 1 ? k2_state_bytes(NS, R, O) : 0);
}

// K2Args of batch row b: every array advanced by b times its per-row size.
// Phase 1 passes null swaps and seed_costs, and a scan with nothing in global
// scratch a null state; those stay null.
__device__ __forceinline__ K2Args k2_row(K2Args a, size_t b) {
  const size_t K = a.K, G = a.G, O = a.O, E = a.E, R = a.R, Z = a.Z, S = a.S, NS = a.E + a.S;
  a.demand += b * G * R;
  a.demand_units += b * G * R;
  a.count += b * G;
  a.node_cap += b * G;
  a.colocate += b * G;
  a.compat += b * G * O;
  a.alloc += b * O * R;
  a.price += b * O;
  a.opt_zone += b * O;
  a.ex_rem += b * E * R;
  a.ex_zone += b * E;
  a.ex_valid += b * E;
  a.rel_set += b * G;
  a.rel_host_forbid += b * G;
  a.rel_host_need += b * G;
  a.rel_zone_forbid += b * G;
  a.rel_zone_need += b * G;
  a.rel_slot_bits += b * E;
  a.rel_zone_bits += b * Z;
  a.units += b * G * O;
  a.units_rsv += b * G * O;
  a.rsv_group += b * G;
  a.quota += b * G * Z;
  a.zone_limited += b * G;
  a.val_pair += b * G * O * G;
  a.exok_pad += b * G * NS;
  a.orders += b * K * G;
  a.alphas += b * K;
  a.looks += b * K;
  a.rsvs += b * K;
  if (a.swaps != nullptr) a.swaps += b * K * G;
  if (a.seed_costs != nullptr) a.seed_costs += b * K;
  a.cost += b * K;
  a.unplaced += b * K;
  a.exhausted += b * K;
  a.new_opt += b * K * S;
  a.new_active += b * K * S;
  a.ys += b * K * G * NS;
  a.price_t += b * K * G * O;
  if (a.state != nullptr) a.state += b * K * k2_scratch_bytes(a.spill, a.G, a.O, a.R, a.Z, NS);
  return a;
}

// The member whose scoring config member k runs under: k itself in phase 1,
// the phase-1 winner in phase 2 (the first NaN, else the first minimum, as
// torch.argmin picks it in phase2_members).
__device__ __forceinline__ int k2_source(const K2Args& a, int k) {
  if (a.seed_costs == nullptr) return k;
  float best = a.seed_costs[0];
  int src = 0;
  for (int j = 1; j < a.K; ++j)
    if (argmin_before(a.seed_costs[j], j, best, src)) {
      best = a.seed_costs[j];
      src = j;
    }
  return src;
}

// Member k's group at step t: phase 2 permutes the winner's order by swaps[k].
__device__ __forceinline__ int k2_order(const K2Args& a, int k, int src, int t) {
  return a.seed_costs != nullptr ? a.orders[(size_t)src * a.G + a.swaps[(size_t)k * a.G + t]]
                                 : a.orders[(size_t)k * a.G + t];
}

// Issue a load of one line into L1 and go on: the next step's option rows
// arrive while this step works.
__device__ __forceinline__ void prefetch_l1(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

// A float's bits as an int of the same order (the kernels make no NaN), so
// that a warp's min and max are one redux.sync each.
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) { return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff); }

__device__ __forceinline__ float warp_min_r(float v) {
  return unordered(__reduce_min_sync(kFull, ordered(v)));
}

// The warp's largest (v, i), lowest i on ties: what arg_better keeps.
__device__ __forceinline__ void warp_argmax_r(float& v, int& i) {
  const int m = __reduce_max_sync(kFull, ordered(v));
  i = __reduce_min_sync(kFull, ordered(v) == m ? i : kIntMax);
  v = unordered(m);
}

// Inclusive prefix sums over the warp; unsigned, so they wrap like XLA's int32 sums.
template <class T>
__device__ __forceinline__ T warp_scan(T x) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}


// K2a replaces the lookahead prices of _pack_member (jax_solver.py:318-328):
// price_t[k, t, o] = max(price[o] - 0.9 * max over the groups g' after step t
// of val_pair[order[t], o, g'], 0.25 * price[o]). Grid (tiles of T*O, K, B),
// one thread per (t, o). Each block derives its member's scan order and
// positions itself, in dynamic shared memory; the blocks of members that do
// not look ahead return at once, and the scan then reads price directly.
// Bound: bytes, the val_pair rows of the lookahead members (16.8 MB each at
// 50k_full), which K1 has just written and the 50 MB L2 still holds; read by
// the whole card rather than through one SM per member.
__global__ void __launch_bounds__(kK2PriceThreads) k2_prices(K2Args p) {
  extern __shared__ __align__(16) unsigned char k2p_dyn[];
  __shared__ int s_src, s_look;
  const K2Args a = k2_row(p, blockIdx.z);
  const int k = blockIdx.y, G = a.G, O = a.O;
  if (threadIdx.x == 0) {
    const int src = k2_source(a, k);
    s_src = src;
    s_look = a.looks[src];
  }
  __syncthreads();
  if (!s_look) return;
  const int src = s_src;
  int* order = reinterpret_cast<int*>(k2p_dyn);
  int* pos = order + G;
  for (int t = threadIdx.x; t < G; t += blockDim.x) order[t] = k2_order(a, k, src, t);
  __syncthreads();
  for (int t = threadIdx.x; t < G; t += blockDim.x) pos[order[t]] = t;
  __syncthreads();
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)G * O) return;
  const int t = static_cast<int>(i / O), o = static_cast<int>(i % O);
  const float pr = a.price[o];
  const float* vp = a.val_pair + ((size_t)order[t] * O + o) * G;
  float m = 0.0f;
  if ((G & 3) == 0) {
    for (int g2 = 0; g2 < G; g2 += 4) {
      const float4 v = *reinterpret_cast<const float4*>(vp + g2);
      if (pos[g2] > t) m = fmaxf(m, v.x);
      if (pos[g2 + 1] > t) m = fmaxf(m, v.y);
      if (pos[g2 + 2] > t) m = fmaxf(m, v.z);
      if (pos[g2 + 3] > t) m = fmaxf(m, v.w);
    }
  } else {
    for (int g2 = 0; g2 < G; ++g2)
      if (pos[g2] > t) m = fmaxf(m, vp[g2]);
  }
  a.price_t[(size_t)k * G * O + i] = fmaxf(__fmaf_rn(m, -kDiscount, pr), kFloor * pr);
}

// ---------------------------------------------------------------------------
// The slot code of a K2 step, shared by k2_scan and the meshed tier's
// k2m_kernel, so that one change reaches both and they stay bit for bit
// equal. Each thread of a block owns the slots [s0, s1); slot s's record is
// the W = kSlRem + R words at slots + s * W. Loops over a thread's slots
// only, apart from k2_zone_clip, which has a barrier.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int* slot_at(int* slots, int W, int s) { return slots + (size_t)s * W; }
__device__ __forceinline__ float* slot_rem(int* slots, int W, int s) {
  return reinterpret_cast<float*>(slots + (size_t)s * W + kSlRem);
}

// The slots before step 0: the existing nodes with their remaining capacity,
// zone, validity and relation bits; the fresh slots closed and empty.
__device__ __forceinline__ void k2_init_slots(int* slots, int W, int s0, int s1, int E, int R,
                                              const float* ex_rem, const int* ex_zone,
                                              const bool* ex_valid, const int* rel_slot_bits) {
  for (int s = s0; s < s1; ++s) {
    const bool ex = s < E;
    int* sl = slot_at(slots, W, s);
    float* rs = slot_rem(slots, W, s);
    for (int r = 0; r < R; ++r) rs[r] = ex ? ex_rem[(size_t)s * R + r] : 0.0f;
    sl[kSlOpt] = -1;
    sl[kSlZone] = ex ? ex_zone[s] : 0;
    sl[kSlAct] = ex ? static_cast<int>(ex_valid[s]) : 0;
    sl[kSlBits] = ex ? rel_slot_bits[s] : 0;
  }
}

// Slot s's fit for the step's group: the pods its remaining capacity takes
// (dfit a pod), at most the group's node cap, when the slot admits the group
// (comp) and its host and zone relation bits allow it.
__device__ __forceinline__ void k2_slot_fit(int* slots, int W, int s, bool comp, int hf, int hn,
                                            bool rel, int zf, int zn, const int* zbits, int Z,
                                            const float* dfit, int R, int cap) {
  int* sl = slot_at(slots, W, s);
  if (comp) {
    const int sb = sl[kSlBits];
    comp = (sb & hf) == 0 && (sb & hn) == hn;
    if (comp && rel) {
      const int zb = zbits[min(max(sl[kSlZone], 0), Z - 1)];
      comp = (zb & zf) == 0 && (zb & zn) == zn;
    }
  }
  sl[kSlFit] = comp ? min(fit_units(slot_rem(slots, W, s), dfit, R), cap) : 0;
}

// Zone quotas: a slot takes at most what its zone's quota (quota_of(z))
// leaves after the slots before it in that zone; one scan for every zone at
// once, the warps' partials in zpart ([nw][Z]). Has a barrier.
template <class Quota>
__device__ __forceinline__ void k2_zone_clip(int* slots, int W, int s0, int s1, int Z,
                                             unsigned* zpart, Quota quota_of) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int z = 0; z < Z; ++z) {
    unsigned v = 0;
    for (int s = s0; s < s1; ++s)
      if (slot_at(slots, W, s)[kSlZone] == z) v += static_cast<unsigned>(slot_at(slots, W, s)[kSlFit]);
    const unsigned incl = warp_scan(v);
    if (lane == 31) zpart[wid * Z + z] = incl;
    unsigned run = incl - v;
    for (int s = s0; s < s1; ++s) {
      int* sl = slot_at(slots, W, s);
      if (sl[kSlZone] == z) {
        sl[kSlPlace] = static_cast<int>(run);  // the slots before s in zone z, within the warp
        run += static_cast<unsigned>(sl[kSlFit]);
      }
    }
  }
  __syncthreads();
  for (int s = s0; s < s1; ++s) {
    int* sl = slot_at(slots, W, s);
    const int z = sl[kSlZone];
    if (z < 0 || z >= Z) {
      sl[kSlFit] = 0;
      continue;
    }
    unsigned before = static_cast<unsigned>(sl[kSlPlace]);
    for (int j = 0; j < wid; ++j) before += zpart[j * Z + z];
    const int allow = static_cast<int>(static_cast<unsigned>(quota_of(z)) - before);
    sl[kSlFit] = min(sl[kSlFit], max(allow, 0));
  }
}

// Colocated groups take a slot only whole. The thread's fit sum (lf, which
// wraps like the int32 cumsum), the OR of its fits, and its free slots.
__device__ __forceinline__ void k2_fit_sums(int* slots, int W, int s0, int s1, int E, bool coloc,
                                            int cnt, unsigned& lf, unsigned& high, int& lfree) {
  lf = high = 0;
  lfree = 0;
  for (int s = s0; s < s1; ++s) {
    int* sl = slot_at(slots, W, s);
    int f = sl[kSlFit];
    if (coloc) f = f >= cnt ? cnt : 0;
    sl[kSlFit] = f;
    lf += static_cast<unsigned>(f);
    high |= static_cast<unsigned>(f);
    lfree += (s >= E && !sl[kSlAct]) ? 1 : 0;
  }
}

// Greedy fill front to back: each slot takes what of the group's cnt pods
// the fits before it leave (before: the fits of the threads before this
// one), its capacity drops by the pods' demand d, and zone-limited groups
// count their placements per zone. Returns the thread's placed pods.
__device__ __forceinline__ unsigned k2_fill(int* slots, int W, int s0, int s1, unsigned before, int cnt,
                                            const float* d, int R, bool zl, int Z, int* placed_z) {
  unsigned placed = 0;
  for (int s = s0; s < s1; ++s) {
    int* sl = slot_at(slots, W, s);
    const int f = sl[kSlFit];
    const int pl = min(max(static_cast<int>(static_cast<unsigned>(cnt) - before), 0), f);
    before += static_cast<unsigned>(f);
    sl[kSlPlace] = pl;
    placed += static_cast<unsigned>(pl);
    if (pl != 0) {
      float* rs = slot_rem(slots, W, s);
      for (int r = 0; r < R; ++r) rs[r] = __fmaf_rn(static_cast<float>(pl), -d[r], rs[r]);
      const int z = sl[kSlZone];
      if (zl && z >= 0 && z < Z) atomicAdd(&placed_z[z], pl);
    }
  }
  return placed;
}

// An option's scores for a want of w pods in its bucket (inb), u pods a node
// at price pr: the lump (whole nodes for the want) and the rate (price a
// pod, for options no larger than the want).
__device__ __forceinline__ float lump_score(bool inb, int w, int u, float pr) {
  return inb && u > 0 ? static_cast<float>(ceil_div(w, u)) * pr : kInf;
}
__device__ __forceinline__ float rate_score(bool inb, int w, int u, float pr) {
  return inb && u > 0 && u <= w ? pr / fmaxf(static_cast<float>(u), 1.0f) : kInf;
}

// A bucket's two segments from its choices: the lump's or the rate option's
// full nodes (c_a pods a node, want_a pods), then the tail option's
// remainder (c_t, want_t; empty unless the rate mix wins). c_lump, b_rate
// and b_tail are the minima, c_rate and pe_rate the rate option's units and
// effective price, u_lump and u_tail the lump's and tail option's units.
// Returns whether the lump wins.
__device__ __forceinline__ bool k2_bucket_segments(int want, float c_lump, float b_rate, int c_rate,
                                                   float pe_rate, float b_tail, int u_lump, int u_tail,
                                                   int& c_a, int& want_a, int& c_t, int& want_t) {
  const int n_full = want / max(c_rate, 1);
  const int rem_w = want - n_full * c_rate;
  const float tail_cost = rem_w > 0 ? b_tail : 0.0f;
  const float cost_mixed = b_rate < kInf ? __fmaf_rn(static_cast<float>(n_full), pe_rate, tail_cost) : kInf;
  const bool lump = c_lump <= cost_mixed;
  const bool feasible = want > 0 && fminf(c_lump, cost_mixed) < kInf;
  c_a = max(lump ? u_lump : c_rate, 1);
  want_a = feasible ? (lump ? want : n_full * c_rate) : 0;
  c_t = max(u_tail, 1);
  want_t = feasible && !lump ? rem_w : 0;
  return lump;
}

// Slot s opened on an option with alloc row c, taking fill pods of demand d.
__device__ __forceinline__ void k2_open_slot(int* slots, int W, int s, int fill, const float* d, int R,
                                             const float* c, int opt, int zone) {
  float* rs = slot_rem(slots, W, s);
  for (int r = 0; r < R; ++r) rs[r] = __fmaf_rn(static_cast<float>(fill), -d[r], c[r]);
  int* sl = slot_at(slots, W, s);
  sl[kSlOpt] = opt;
  sl[kSlZone] = zone;
  sl[kSlAct] = 1;
}

// Allocate the free slots to the segments in rank order (r0: the 0-based
// rank of this thread's first free slot): a free slot of rank below
// total_open joins the segment its rank falls in, open(s, sid, fill) opening
// it on that segment's option; then the step's placements go to yrow, and a
// slot that took pods publishes the group's presence bits sm on itself and
// its zone.
template <class Open>
__device__ __forceinline__ void k2_open_slots(int* slots, int W, int s0, int s1, int E, int Z, int r0,
                                              int total_open, int nseg, const int* seg_start,
                                              const int* seg_c, const int* seg_want, int sm, int* zbits,
                                              int* yrow, Open open) {
  for (int s = s0; s < s1; ++s) {
    int* sl = slot_at(slots, W, s);
    int fill = 0;
    if (s >= E && !sl[kSlAct]) {
      if (r0 < total_open) {
        int sid = -1;  // segment starts <= rank, minus one: skips empty segments
        for (int j = 0; j < nseg; ++j) sid += r0 >= seg_start[j] ? 1 : 0;
        sid = min(max(sid, 0), nseg - 1);
        const int c_i = seg_c[sid];
        const unsigned used = static_cast<unsigned>(r0 - seg_start[sid]) * static_cast<unsigned>(c_i);
        fill = min(max(static_cast<int>(static_cast<unsigned>(seg_want[sid]) - used), 0), c_i);
        open(s, sid, fill);
      }
      ++r0;
    }
    const int y = sl[kSlPlace] + fill;
    yrow[s] = y;
    if (y > 0) {
      sl[kSlBits] |= sm;
      const int z = sl[kSlZone];
      if (sm != 0 && z >= 0 && z < Z) atomicOr(&zbits[z], sm);
    }
  }
}

// The member's fresh slots (new_opt, new_active: its S entries) and the f32
// sum of their prices (price_of(s, opt)) over this thread's slots, which the
// caller sums over the block: k2_scan's partition and order.
template <class Price>
__device__ __forceinline__ float k2_member_slots(int* slots, int W, int s0, int s1, int E, int* new_opt,
                                                 bool* new_active, Price price_of) {
  float csum = 0.0f;
  for (int s = max(s0, E); s < s1; ++s) {
    const int* sl = slot_at(slots, W, s);
    const int so = sl[kSlOpt];
    const bool act = sl[kSlAct] && so >= 0;
    new_opt[s - E] = so;
    new_active[s - E] = act;
    if (act) csum += price_of(s, so);
  }
  return csum;
}

// K2b replaces the scan of _pack_member (jax_solver.py:330-535): one block per
// (member k, batch row b) runs the T steps. Bound: latency, T dependent steps
// of block-wide rounds on K*B SMs (the bytes it must move take ~2 us at
// 50k_full); on the card each step costs the length of its instruction path,
// every warp walking it (PERF.md, K2 findings). What the design does about it:
//  - state on chip: each thread owns a contiguous run of slots, whose records
//    only it touches, in dynamic shared memory (in global scratch through the
//    same code when they do not fit); the groups' scalars, demand and quota
//    rows are staged in shared memory once, so no step waits on a global load
//    before its first round, and the next step's option rows are prefetched.
//    Groups too many for shared memory are staged in global scratch by the
//    instance kGroupsShared = false, the same code with generic pointers to
//    them (which in the other instance would cost registers and spills);
//  - one barrier per round, never a broadcast: a round writes per-warp
//    partials, and after its barrier every warp reduces them itself, lanes
//    over warps, each reduction one redux.sync; every thread derives the
//    wants, and the placed and opened counts, from the rounds' totals. A step
//    with pods is one scan of (fit, free) over the slots, the lump and rate
//    minima of every bucket, their argmaxes, the tail's minimum and argmax
//    (only when a bucket has a remainder), and the segments (warp 0): 6
//    barriers, 4 without a tail (and a zone-quota scan and a placed-per-zone
//    sum for zone-limited groups, a barrier before reading zone bits for
//    relation groups), where a block reduction per choice took ~48;
//  - a short path: the four option rounds are one loop, emitted once, and the
//    minimum rounds keep each option's scores so that the argmax rounds
//    divide nothing.
// Every min, argmax and int32 sum is exact and order-free, so the outputs
// are the plain version's bit for bit; the member cost is an f32 sum in
// block order.
template <bool kGroupsShared>
__global__ void __launch_bounds__(kK2Threads) k2_scan(K2Args p) {
  extern __shared__ __align__(16) unsigned char k2_dyn[];
  __shared__ Scratch sh;
  __shared__ int zbits[kMaxZ], placed_z[kMaxZ];
  __shared__ int seg_opt[kMaxSeg], seg_c[kMaxSeg], seg_want[kMaxSeg], seg_start[kMaxSeg];
  __shared__ unsigned s_scan_f[32];
  __shared__ int s_scan_free[32], s_scan_high[32];
  __shared__ int s_src, s_look, s_rsv, s_total_open, s_opened;
  __shared__ float s_alpha;

  const K2Args a = k2_row(p, blockIdx.y);
  const int k = blockIdx.x, tid = threadIdx.x, BT = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = BT >> 5;
  const int G = a.G, O = a.O, E = a.E, R = a.R, Z = a.Z, Zb = a.Z + 1;
  const int NS = a.E + a.S, nseg = 2 * Zb;

  // ---- carve the dynamic shared memory ----
  // per-warp partials of the option rounds, [lump and rate, then tail][nw][Zb][2]:
  // the minima, and the argmaxes' values and indices
  float* pmin = reinterpret_cast<float*>(k2_dyn);
  float* pargv = pmin + (size_t)nw * Zb * 4;
  int* pargi = reinterpret_cast<int*>(pargv + (size_t)nw * Zb * 4);
  unsigned* zpart = reinterpret_cast<unsigned*>(pmin);  // [nw][Z], the zone-quota scan's partials
  auto pidx = [&](int w, int b, int j) { return (w * Zb + b) * 2 + j; };
  // the groups and the state follow in shared memory, or start this member's
  // global scratch as far as they spill
  unsigned char* gl = a.state != nullptr ? a.state + (size_t)k * k2_scratch_bytes(a.spill, G, O, R, Z, NS)
                                         : nullptr;
  unsigned char* groups = kGroupsShared ? k2_dyn + k2_partial_bytes(Z, nw) : gl;
  unsigned char* state = a.spill == 1 ? gl : groups + k2_group_bytes(G, R, Z);
  int* order = reinterpret_cast<int*>(groups);
  int* gi = order + G;
  float* gd = reinterpret_cast<float*>(gi + (size_t)G * kGi);
  float* gdu = gd + (size_t)G * R;
  int* gq = reinterpret_cast<int*>(gdu + (size_t)G * R);
  float* sc = reinterpret_cast<float*>(state);  // [O][lump or tail, rate]
  int* slots = reinterpret_cast<int*>(state + round16(8 * static_cast<size_t>(O)));
  const int W = kSlRem + R;
  auto slot = [&](int s) { return slot_at(slots, W, s); };
  // this thread's slots [s0, s1): NS/BT of them or one more, so every warp
  // holds slots however small NS is
  const int s0 = static_cast<int>((long long)tid * NS / BT);
  const int s1 = static_cast<int>((long long)(tid + 1) * NS / BT);

  // ---- prologue: scoring config, staged groups, slot state, scan order ----
  if (tid == 0) {
    const int src = k2_source(a, k);
    s_src = src;
    s_alpha = a.alphas[src];
    s_look = a.looks[src];
    s_rsv = a.rsvs[src];
  }
  for (int g = tid; g < G; g += BT) {
    int* w = gi + (size_t)g * kGi;
    w[kGiCount] = a.count[g];
    w[kGiCap] = a.node_cap[g];
    w[kGiColoc] = a.colocate[g];
    w[kGiHostForbid] = a.rel_host_forbid[g];
    w[kGiHostNeed] = a.rel_host_need[g];
    w[kGiZoneForbid] = a.rel_zone_forbid[g];
    w[kGiZoneNeed] = a.rel_zone_need[g];
    w[kGiSet] = a.rel_set[g];
    w[kGiZoneLimited] = a.zone_limited[g];
    w[kGiRsvGroup] = a.rsv_group[g];
  }
  for (int i = tid; i < G * R; i += BT) {
    gd[i] = a.demand[i];
    gdu[i] = a.demand_units[i];
  }
  for (int i = tid; i < G * Z; i += BT) gq[i] = a.quota[i];
  for (int z = tid; z < Z; z += BT) zbits[z] = a.rel_zone_bits[z];
  k2_init_slots(slots, W, s0, s1, E, R, a.ex_rem, a.ex_zone, a.ex_valid, a.rel_slot_bits);
  __syncthreads();
  const int src = s_src;
  const bool look = s_look, rsv = s_rsv, prefer_big = s_alpha >= 1.0f;
  for (int t = tid; t < G; t += BT) order[t] = k2_order(a, k, src, t);
  __syncthreads();

  const int* units_base = rsv ? a.units_rsv : a.units;
  const float* price_k = a.price_t + (size_t)k * G * O;
  int unplaced = 0;  // thread 0's
  bool exhausted = false;

  // ---- the scan over groups ----
  for (int t = 0; t < G; ++t) {
    const int g = order[t];
    const int* w = gi + (size_t)g * kGi;
    const int cnt = w[kGiCount];
    int* yrow = a.ys + ((size_t)k * G + t) * NS;
    if (t + 1 < G) {
      // the next step's units, prices and compat rows, one line per thread
      const int gn = order[t + 1];
      const int l4 = (O + 31) / 32, l1 = (O + 127) / 128;
      const int* un = units_base + (size_t)gn * O;
      const float* pn = look ? price_k + (size_t)(t + 1) * O : a.price;
      const bool* cn = a.compat + (size_t)gn * O;
      for (int l = tid; l < 2 * l4 + l1; l += BT)
        prefetch_l1(l < l4 ? static_cast<const void*>(un + (size_t)l * 32)
                    : l < 2 * l4 ? static_cast<const void*>(pn + (size_t)(l - l4) * 32)
                                 : static_cast<const void*>(cn + (size_t)(l - 2 * l4) * 128));
    }
    if (cnt == 0) {
      // a group with no pods places, wants and opens nothing
      for (int s = s0; s < s1; ++s) yrow[s] = 0;
      continue;
    }
    const int cap = w[kGiCap], hf = w[kGiHostForbid], hn = w[kGiHostNeed];
    const int zf = w[kGiZoneForbid], zn = w[kGiZoneNeed], sm = w[kGiSet];
    const bool coloc = w[kGiColoc] != 0, rel = (zf | zn) != 0;
    const bool zl = w[kGiZoneLimited] != 0 || rel;
    const float* d = gd + (size_t)g * R;
    const float* dfit = rsv && w[kGiRsvGroup] ? gdu + (size_t)g * R : d;
    const int* urow = units_base + (size_t)g * O;
    const float* pe = look ? price_k + (size_t)t * O : a.price;
    const int* qrow = gq + (size_t)g * Z;
    if (rel) __syncthreads();  // the zone bits the last step published
    if (tid < Z) placed_z[tid] = 0;
    // relation-eligible zones (no forbidden bit, every needed bit) keep their quota
    auto quota_of = [&](int z) -> int {
      if (!rel) return qrow[z];
      const int zb = zbits[z];
      return (zb & zf) == 0 && (zb & zn) == zn ? qrow[z] : 0;
    };

    // ---- fit open capacity: per-slot fit under compat and relation bits ----
    for (int s = s0; s < s1; ++s) {
      bool comp;
      if (s >= E) {
        const int so = slot(s)[kSlOpt];
        comp = so >= 0 && slot(s)[kSlAct] && a.compat[(size_t)g * O + min(max(so, 0), O - 1)];
      } else {
        comp = a.exok_pad[(size_t)g * NS + s];
      }
      k2_slot_fit(slots, W, s, comp, hf, hn, rel, zf, zn, zbits, Z, dfit, R, cap);
    }
    if (zl) k2_zone_clip(slots, W, s0, s1, Z, zpart, quota_of);
    unsigned lf, high;
    int lfree;
    k2_fit_sums(slots, W, s0, s1, E, coloc, cnt, lf, high, lfree);
    // ---- round 1: one scan of (fit, free) over the slots ----
    const unsigned xf = warp_scan(lf);
    const int xfree = warp_scan(lfree);
    // when no fit and no thread's sum reaches 2^21, no sum over the block
    // (of at most 1024 threads) reaches 2^31
    const unsigned high_w = __reduce_or_sync(kFull, (lf | high) >> 21);
    if (lane == 31) {
      s_scan_f[wid] = xf;
      s_scan_free[wid] = xfree;
      s_scan_high[wid] = high_w;
    }
    __syncthreads();
    unsigned before_f, tot_f;
    int before_free, n_free;
    bool wraps;
    {
      const unsigned pf = lane < nw ? s_scan_f[lane] : 0u;
      const int pfree = lane < nw ? s_scan_free[lane] : 0;
      before_f = xf - lf + __reduce_add_sync(kFull, lane < wid ? pf : 0u);
      tot_f = __reduce_add_sync(kFull, pf);
      before_free = xfree - lfree + __reduce_add_sync(kFull, lane < wid ? pfree : 0);
      n_free = __reduce_add_sync(kFull, pfree);
      wraps = __reduce_or_sync(kFull, lane < nw ? static_cast<unsigned>(s_scan_high[lane]) : 0u) != 0;
    }
    const unsigned placed_local = k2_fill(slots, W, s0, s1, before_f, cnt, d, R, zl, Z, placed_z);
    // without wrap-around the greedy fill places min(cnt, total fit); with
    // it, the places are summed as the plain version sums them
    const int placed = !wraps ? min(cnt, static_cast<int>(tot_f))
                           : static_cast<int>(block_sum(static_cast<int>(placed_local), sh));
    if (zl) __syncthreads();  // placed_z
    const int left = cnt - placed;
    // want of bucket b (zone buckets, then the unrestricted one), taken in
    // bucket order: acc carries the zone wants before b
    auto want_of = [&](int b, unsigned& acc) -> int {
      if (hn != 0) return 0;  // hostname-need groups cannot open fresh nodes
      if (!zl) return b == Z ? left : 0;
      if (b == Z) return 0;
      const int wz = min(max(quota_of(b) - placed_z[b], 0), left);
      const int r = max(min(wz, static_cast<int>(static_cast<unsigned>(left) - acc)), 0);
      acc += static_cast<unsigned>(wz);
      return r;
    };
    auto in_bucket = [&](int b, int o) { return b == Z || a.opt_zone[o] == b; };
    const int b_first = zl ? 0 : Z;  // other groups want only in the unrestricted bucket
    // a round's block-wide value: every warp reduces the per-warp partials
    auto red_min = [&](const float* part, int b, int j) {
      return warp_min_r(lane < nw ? part[pidx(lane, b, j)] : kInf);
    };
    auto red_arg = [&](const float* pv, const int* pi, int b, int j) {
      float v = lane < nw ? pv[pidx(lane, b, j)] : neg_inf();
      int i = lane < nw ? pi[pidx(lane, b, j)] : kIntMax;
      warp_argmax_r(v, i);
      return i;
    };
    // the remainder of the rate option's full nodes in bucket b
    auto tail_want = [&](int b, int want) {
      const int c_rate = urow[red_arg(pargv, pargi, b, 1)];
      return want - (want / max(c_rate, 1)) * c_rate;
    };

    // ---- rounds 2-5 over the options: the lump and rate minima of every
    // bucket with a want, their argmaxes within the tie band, the tail's
    // minimum and argmax where a bucket has a remainder. One loop, so its
    // code is emitted once and the per-step path stays short. The minimum
    // rounds keep each option's scores in
    // the per-step state (an option lies in at most one bucket with a
    // want), so the argmax rounds divide nothing ----
    bool tails = false;
    for (int round = 0; round < 4; ++round) {
      const bool argmax = (round & 1) != 0, tail = round >= 2;
      const size_t half = tail ? (size_t)nw * Zb * 2 : 0;
      float* pm = pmin + half;
      float* pv = pargv + half;
      int* pi = pargi + half;
      bool any = false;
      unsigned acc = 0;
      for (int b = b_first; b < Zb; ++b) {
        int w = want_of(b, acc);
        if (w <= 0) continue;
        if (tail) {
          w = tail_want(b, w);
          if (w <= 0) continue;
        }
        any = true;
        const float band0 = argmax ? red_min(pm, b, 0) * kTieBand : 0.0f;
        const float band1 = argmax && !tail ? red_min(pm, b, 1) * kTieBand : 0.0f;
        float a0 = argmax ? neg_inf() : kInf, a1 = a0;
        int i0 = kIntMax, i1 = kIntMax;
        for (int o = tid; o < O; o += BT) {
          const int u = urow[o];
          const bool inb = in_bucket(b, o);
          if (!argmax) {
            const float pr = pe[o];
            const float s0 = lump_score(inb, w, u, pr);
            const float s1 = !tail ? rate_score(inb, w, u, pr) : kInf;
            if (inb) {
              sc[2 * o] = s0;
              sc[2 * o + 1] = s1;
            }
            a0 = fminf(a0, s0);
            a1 = fminf(a1, s1);
          } else {
            const float pref = prefer_big ? static_cast<float>(u) : -static_cast<float>(u);
            arg_better(a0, i0, inb && sc[2 * o] <= band0 ? pref : -kInf, o);
            arg_better(a1, i1, inb && sc[2 * o + 1] <= band1 ? pref : -kInf, o);
          }
        }
        if (!argmax) {
          a0 = warp_min_r(a0);
          a1 = warp_min_r(a1);
          if (lane == 0) {
            pm[pidx(wid, b, 0)] = a0;
            pm[pidx(wid, b, 1)] = a1;
          }
        } else {
          warp_argmax_r(a0, i0);
          warp_argmax_r(a1, i1);
          if (lane == 0) {
            pv[pidx(wid, b, 0)] = a0;
            pi[pidx(wid, b, 0)] = i0;
            pv[pidx(wid, b, 1)] = a1;
            pi[pidx(wid, b, 1)] = i1;
          }
        }
      }
      if (round == 2) tails = any;
      if (!any) break;  // no bucket wants (round 0) or has a remainder (round 2)
      __syncthreads();
    }

    // ---- segments: (full or lump) + tail per bucket, by warp 0, lane b
    // for bucket b; the warp-wide reductions go one bucket with a want at a
    // time ----
    if (wid == 0) {
      for (int b0 = 0; b0 < Zb; b0 += 32) {
        int want = 0, o_lump = 0, o_rate = 0, o_tail = 0;
        float c_lump = kInf, b_rate = kInf, b_tail = kInf;
        unsigned acc = 0;
        for (int b = b_first; b < min(Zb, b0 + 32); ++b) {
          const int wb = want_of(b, acc);
          if (b < b0 || wb <= 0) continue;
          const float cl = red_min(pmin, b, 0), br = red_min(pmin, b, 1);
          const int ol = red_arg(pargv, pargi, b, 0), orr = red_arg(pargv, pargi, b, 1);
          float bt = kInf;
          int ot = 0;
          if (tails && tail_want(b, wb) > 0) {
            const size_t half = (size_t)nw * Zb * 2;
            bt = red_min(pmin + half, b, 0);
            ot = red_arg(pargv + half, pargi + half, b, 0);
          }
          if (lane == b - b0) {
            want = wb;
            c_lump = cl;
            b_rate = br;
            o_lump = ol;
            o_rate = orr;
            b_tail = bt;
            o_tail = ot;
          }
        }
        const int b = b0 + lane;
        if (b < Zb) {
          const bool lump = k2_bucket_segments(want, c_lump, b_rate, urow[o_rate], pe[o_rate], b_tail,
                                               urow[o_lump], urow[o_tail], seg_c[b], seg_want[b],
                                               seg_c[Zb + b], seg_want[Zb + b]);
          seg_opt[b] = lump ? o_lump : o_rate;
          seg_opt[Zb + b] = o_tail;
        }
      }
      __syncwarp();
      // starts in rank order, and what the free slots take of each segment
      int carry = 0, opened = 0;
      for (int j0 = 0; j0 < nseg; j0 += 32) {
        const int j = j0 + lane;
        const int n = j < nseg ? ceil_div(seg_want[j], seg_c[j]) : 0;
        const int start = carry + warp_scan(n) - n;
        int took = 0;
        if (j < nseg) {
          seg_start[j] = start;
          const long long taken = min(max(n_free - start, 0), n);
          took = static_cast<int>(min(static_cast<long long>(seg_want[j]), taken * seg_c[j]));
        }
        carry += __reduce_add_sync(kFull, n);
        opened += __reduce_add_sync(kFull, took);
      }
      if (lane == 0) {
        s_total_open = carry;
        s_opened = opened;
      }
    }
    __syncthreads();

    // ---- allocate free slots to segments, in rank order ----
    const int total_open = s_total_open;
    k2_open_slots(slots, W, s0, s1, E, Z, before_free, total_open, nseg, seg_start, seg_c, seg_want,
                  sm, zbits, yrow, [&](int s, int sid, int fill) {
                    const int o_i = seg_opt[sid];
                    k2_open_slot(slots, W, s, fill, d, R, a.alloc + (size_t)o_i * R, o_i, a.opt_zone[o_i]);
                  });
    if (tid == 0) {
      const int l2 = left - s_opened;
      unplaced += l2;
      // exhaustion compares against the free count before this step's take
      if (l2 > 0 && total_open > n_free) exhausted = true;
    }
  }

  // ---- member result ----
  const float csum = k2_member_slots(slots, W, s0, s1, E, a.new_opt + (size_t)k * a.S,
                                     a.new_active + (size_t)k * a.S,
                                     [&](int, int so) { return a.price[min(max(so, 0), O - 1)]; });
  const float total = block_sum_f(csum, sh);
  if (tid == 0) {
    a.cost[k] = __fmaf_rn(static_cast<float>(unplaced), kPenalty, total);
    a.unplaced[k] = unplaced;
    a.exhausted[k] = exhausted;
  }
}

// ---------------------------------------------------------------------------
// K3: epilogue
// ---------------------------------------------------------------------------

struct K3Args {
  const float* c1; const int* u1; const bool* ex1; const int* no1; const bool* na1; const int* ys1;
  const float* c2; const int* u2; const bool* ex2; const int* no2; const bool* na2; const int* ys2;
  int* buf;  // [4 + 2K + 2K + S + S + T*NS]
  int K, T, NS, S;
};

// K3Args of batch row b: every array advanced by b times its per-row size.
__device__ __forceinline__ K3Args k3_row(K3Args a, size_t b) {
  const size_t K = a.K, S = a.S, Y = (size_t)a.K * a.T * a.NS;
  a.c1 += b * K;
  a.u1 += b * K;
  a.ex1 += b * K;
  a.no1 += b * K * S;
  a.na1 += b * K * S;
  a.ys1 += b * Y;
  a.c2 += b * K;
  a.u2 += b * K;
  a.ex2 += b * K;
  a.no2 += b * K * S;
  a.na2 += b * K * S;
  a.ys2 += b * Y;
  a.buf += b * (4 + 4 * K + 2 * S + (size_t)a.T * a.NS);
  return a;
}

// Copy n ints with the block: 16-byte loads and stores where the two ends
// lie alike modulo 16 bytes (scalars before the first aligned int4 and after
// the last), one int a thread where they do not.
__device__ __forceinline__ void block_copy(int* dst, const int* src, int n) {
  const int tid = threadIdx.x, BT = blockDim.x;
  const size_t da = reinterpret_cast<size_t>(dst), sa = reinterpret_cast<size_t>(src);
  const int head = ((da ^ sa) & 15) == 0 ? min(n, static_cast<int>(((16 - (da & 15)) & 15) / 4)) : n;
  for (int i = tid; i < head; i += BT) dst[i] = src[i];
  const int n4 = (n - head) / 4;
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (int i = tid; i < n4; i += BT) d4[i] = s4[i];
  for (int i = head + 4 * n4 + tid; i < n; i += BT) dst[i] = src[i];
}

// K3 replaces the tail of _pack_solve_fused_impl (jax_solver.py:585-604): the
// argmin over both phases' 2K costs and the result buffer in that
// function's layout, costs as f32 bits. Grid (tiles of the buffer, B): every
// warp derives the winner itself from the 2K costs (the first NaN, else the
// first minimum, as torch.argmin), so no block and no warp waits on another,
// and each block writes its kK3Tile ints of the row: the head, costs, flags,
// new_opt and new_active one int a thread, the winner's ys by block_copy.
// Bound: the copy of the winner's ys (T*(E+S) int32, 262 KB at 50k_full),
// read and written once across the card.
__global__ void __launch_bounds__(kK3Threads) k3_pack_epilogue(K3Args p) {
  const K3Args a = k3_row(p, blockIdx.y);
  const int K = a.K, S = a.S;
  const size_t off = 4 + 4 * (size_t)K, ys_off = off + 2 * (size_t)S;
  const size_t len = ys_off + (size_t)a.T * a.NS;
  const size_t p0 = (size_t)blockIdx.x * kK3Tile, p1 = p0 + kK3Tile < len ? p0 + kK3Tile : len;
  const int best = warp_argmin([&](int j) { return j < K ? a.c1[j] : a.c2[j - K]; }, 2 * K);
  const bool p2 = best >= K;
  const int bk = p2 ? best - K : best;
  int* buf = a.buf;
  if (p0 < ys_off) {
    const int b1 = p0 < 4 ? warp_argmin([&](int j) { return a.c1[j]; }, K) : 0;
    const int* no = p2 ? a.no2 : a.no1;
    const bool* na = p2 ? a.na2 : a.na1;
    for (size_t q = p0 + threadIdx.x; q < p1 && q < ys_off; q += blockDim.x) {
      int v;
      if (q < 4) {
        v = q == 0 ? static_cast<int>(p2) : q == 1 ? b1 : q == 2 ? bk : (p2 ? a.u2 : a.u1)[bk];
      } else if (q < 4 + 2 * (size_t)K) {
        const int j = static_cast<int>(q - 4);
        v = __float_as_int(j < K ? a.c1[j] : a.c2[j - K]);
      } else if (q < off) {
        const int j = static_cast<int>(q - 4 - 2 * (size_t)K);
        v = (j < K ? a.ex1[j] : a.ex2[j - K]) ? 1 : 0;
      } else if (q < off + S) {
        v = no[(size_t)bk * S + (q - off)];
      } else {
        v = na[(size_t)bk * S + (q - off - S)] ? 1 : 0;
      }
      buf[q] = v;
    }
  }
  if (p1 > ys_off) {
    const size_t q0 = p0 > ys_off ? p0 : ys_off;
    const int* ys = (p2 ? a.ys2 : a.ys1) + (size_t)bk * a.T * a.NS;
    block_copy(buf + q0, ys + (q0 - ys_off), static_cast<int>(p1 - q0));
  }
}

// K2's memory plan. The card's opt-in limit of shared memory a block caps a
// kernel's static and dynamic shared memory together, so each kernel's
// dynamic limit is the opt-in limit less its static bytes (ptxas's figure,
// read back from the runtime). Both are read, and each kernel's attribute set
// to its whole dynamic limit, once per device; a launch then needs no
// attribute call, and concurrent launches of different sizes cannot undo
// each other's setting.
struct K2Limits {
  size_t optin, scan_static, prices_static;  // scan_static: the larger of k2_scan's two instances
};

constexpr int kMaxDevices = 64;

cudaError_t k2_limits(K2Limits* out) {
  static std::mutex mu;
  static K2Limits cache[kMaxDevices];
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  if (!ready[dev]) {
    int optin = 0;
    cudaFuncAttributes scan, scan_g, prices;
    if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (err = cudaFuncGetAttributes(&scan, k2_scan<true>)) ||
        (err = cudaFuncGetAttributes(&scan_g, k2_scan<false>)) ||
        (err = cudaFuncGetAttributes(&prices, k2_prices)))
      return err;
    const K2Limits lim{static_cast<size_t>(optin),
                       scan.sharedSizeBytes > scan_g.sharedSizeBytes ? scan.sharedSizeBytes
                                                                     : scan_g.sharedSizeBytes,
                       prices.sharedSizeBytes};
    const int scan_dyn = static_cast<int>(lim.optin - lim.scan_static);
    if ((err = cudaFuncSetAttribute(k2_scan<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_dyn)) ||
        (err = cudaFuncSetAttribute(k2_scan<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_dyn)) ||
        (err = cudaFuncSetAttribute(k2_prices, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(lim.optin - lim.prices_static))))
      return err;
    cache[dev] = lim;
    ready[dev] = true;
  }
  *out = cache[dev];
  return cudaSuccess;
}

// k2_prices' dynamic shared memory: its member's scan order and positions.
size_t k2_price_bytes(int G) { return 2 * sizeof(int) * static_cast<size_t>(G); }

struct K2Plan {
  int spill;    // 0: all in shared memory; 1: the state in global scratch; 2: the groups too
  size_t smem;  // the scan's dynamic shared memory a block
};

// The least spill whose shared part fits beside k2_scan's static shared
// memory under `smem_limit` (the card's opt-in limit when 0); false when
// none does or k2_prices' order and positions do not fit.
bool k2_plan(const K2Limits& lim, int G, int O, int R, int Z, int NS, int smem_limit,
             K2Plan* out) {
  const size_t limit = smem_limit > 0 ? static_cast<size_t>(smem_limit) : lim.optin;
  if (k2_price_bytes(G) + lim.prices_static > lim.optin) return false;
  const size_t part = k2_partial_bytes(Z, kK2Threads / 32), groups = k2_group_bytes(G, R, Z);
  const size_t shared[3] = {part + groups + k2_state_bytes(NS, R, O), part + groups, part};
  for (int spill = 0; spill < 3; ++spill) {
    if (shared[spill] + lim.scan_static <= limit) {
      *out = K2Plan{spill, shared[spill]};
      return true;
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// The meshed tier: kernels of one shard of a device mesh (solver/meshed.py)
// ---------------------------------------------------------------------------
//
// These replace what XLA partitions for the JAX package's meshed programs
// (_get_jit(..., mesh=...), _pin and mesh_constraints, jax_solver.py:140-190,
// 842-900). Shards exchange between launches, ordered by events: a shard
// reads the other shards' buffers in place where they share memory (one
// card, or cards with peer access to each other), else copies of them made
// first (meshed.py); a K2 phase's regions alike, issued by the phase entry
// from C (kts_k2m_phase). No kernel waits on another shard inside a launch.
// A kernel that reads several shards' buffers takes their device pointers
// as a table in its parameters (__grid_constant__, read from the constant
// bank in place), so that one launch a shard does the cross-shard step and
// no table or buffer crosses by a copy of its own.
//
//   k1_val_pair_shards
//                    K1's finish on an option shard: the K1 partials of
//                    every shard (the rate minima, a min; the reserve fits,
//                    an any) read through its K1Parts table and reduced as
//                    K1 reduces its own, then the value table over the
//                    shard's columns (k1_val_pair's body); k1_units runs
//                    unchanged
//   k2m_kernel       one stage of one step of K2 on an option shard, with
//                    each member's slot state in global memory, replicated
//                    on every shard (kStInit, kStFill .. kStTailPick, kStEnd)
//   mesh_seed, mesh_final_pick
//                    the 1D mesh's cross-shard member argmin
//
// Every cross-shard value is a min, an OR, or an argmax or argmin with a
// fixed tie rule, so a meshed chain's outputs equal the un-meshed chain's
// bit for bit; the member cost is summed by k2m_kernel's end stage with
// k2_scan's thread partition and block reduction, in the same order.

constexpr int kMeshThreads = 256;       // mesh_seed, mesh_final_pick
constexpr int kMeshTile = 4 * kMeshThreads;  // mesh_final_pick: ints of the buffer a block writes

struct K2MLayout {  // word offsets of one member's state (k2m_layout)
  size_t order, scal, zbits, want, cmin, rec, slots, sprice, scomp, sc, words;
};

constexpr int kK2MRegions = 4;  // exchange regions: one a stage of a step

struct K2MArgs {
  const float* demand;          // [G, R]
  const float* demand_units;    // [G, R]
  const int* count;             // [G]
  const int* node_cap;          // [G]
  const bool* colocate;         // [G]
  const bool* compat;           // [G, O] the shard's columns
  const float* alloc;           // [O, R]
  const float* price;           // [O]
  const int* opt_zone;          // [O]
  const float* ex_rem;          // [E, R]
  const int* ex_zone;           // [E]
  const bool* ex_valid;         // [E]
  const int* rel_set;           // [G]
  const int* rel_host_forbid;   // [G]
  const int* rel_host_need;     // [G]
  const int* rel_zone_forbid;   // [G]
  const int* rel_zone_need;     // [G]
  const int* rel_slot_bits;     // [E]
  const int* rel_zone_bits;     // [Z]
  const int* units;             // [G, O]
  const int* units_rsv;         // [G, O]
  const bool* rsv_group;        // [G]
  const int* quota;             // [G, Z]
  const bool* zone_limited;     // [G]
  const float* val_pair;        // [G, O, G]
  const bool* exok_pad;         // [G, E+S]
  const int* orders;            // [K, G]
  const float* alphas;          // [K]
  const bool* looks;            // [K]
  const bool* rsvs;             // [K]
  const int* swaps;             // [K, G] (phase 2 only)
  const float* seed_costs;      // [K] phase-1 costs, or null for phase 1
  float* price_t;               // [K, G, O] lookahead prices (k2_prices, the shard's columns)
  unsigned char* state;         // [B][K][k2m_state_bytes] per-member state
  // The exchange regions, one a stage, each [n][B][K][k2m_region_words]
  // ints: row j is shard j's, which this shard reads (its own, j = self, it
  // writes). The shards of a phase may share one region (each reads the
  // others' rows in place), or each hold its own copy of every row.
  int* xa;  // fill: the shard's lump and rate minima (f32 bits), [2 Zb]
  int* xb;  // pick: its lump and rate records, [2][Zb][RW]
  int* xc;  // tail: its tail minima, [Zb]
  int* xd;  // tail_pick: its tail records, [Zb][RW]
  K2MLayout lay;                // the state's layout, set by the host: read from the parameters
  int* ys;                      // [K, G, E+S]
  float* cost;                  // [K]
  int* unplaced;                // [K]
  bool* exhausted;              // [K]
  int* new_opt;                 // [K, S]
  bool* new_active;             // [K, S]
  int B, K, G, O, E, R, Z, S, c0, n, self, t;
};

enum { kStInit = -1, kStFill = 0, kStPick = 1, kStTail = 2, kStTailPick = 3, kStEnd = 4 };
// state scalars
enum { kScLook, kScRsv, kScAlpha, kScLeft, kScFree, kScUnplaced, kScExhausted, kSc = 8 };
// an exchanged option record: value, global index, units, effective price,
// price, zone, then the alloc row and the compat column (bit g of word g / 32:
// whether group g may use the option)
enum { kRcValue, kRcIdx, kRcUnits, kRcPe, kRcPrice, kRcZone, kRcAlloc };

__host__ __device__ __forceinline__ int k2m_compat_words(int G) { return (G + 31) / 32; }
__host__ __device__ __forceinline__ int k2m_rec_words(int G, int R) { return kRcAlloc + R + k2m_compat_words(G); }

__host__ __device__ __forceinline__ K2MLayout k2m_layout(int G, int O, int E, int R, int Z, int S) {
  const size_t NS = (size_t)E + S, Zb = Z + 1, RW = k2m_rec_words(G, R), W = kSlRem + R;
  K2MLayout l;
  size_t w = 0;
  l.order = w; w += G;
  l.scal = w; w += kSc;
  l.zbits = w; w += Z;
  l.want = w; w += Zb;
  l.cmin = w; w += 3 * Zb;          // per bucket: lump, rate and tail minima
  l.rec = w; w += 3 * Zb * RW;      // the lump, rate and tail choices
  l.slots = w; w += NS * W;
  l.sprice = w; w += NS;            // an opened slot's option price
  l.scomp = w; w += (size_t)S * k2m_compat_words(G);  // a fresh slot's option's compat column
  l.sc = w; w += 2 * (size_t)O;     // the shard's option scores
  l.words = w;
  return l;
}

__host__ __device__ __forceinline__ size_t k2m_state_bytes(int G, int O, int E, int R, int Z, int S) {
  return round16(4 * k2m_layout(G, O, E, R, Z, S).words);
}

// Ints a member's row holds in exchange region r (the stage that writes it).
__host__ __device__ __forceinline__ size_t k2m_region_words(int r, int G, int R, int Z) {
  const size_t Zb = Z + 1, RW = k2m_rec_words(G, R);
  const size_t words[kK2MRegions] = {2 * Zb, 2 * Zb * RW, Zb, Zb * RW};
  return words[r];
}

// K2MArgs of batch row b: inputs, prices and outputs advanced by row b (the
// state and the exchange regions are indexed by row where they are read).
__device__ __forceinline__ K2MArgs k2m_row(K2MArgs a, size_t b) {
  const size_t K = a.K, G = a.G, O = a.O, E = a.E, R = a.R, Z = a.Z, S = a.S, NS = a.E + a.S;
  a.demand += b * G * R;
  a.demand_units += b * G * R;
  a.count += b * G;
  a.node_cap += b * G;
  a.colocate += b * G;
  a.compat += b * G * O;
  a.alloc += b * O * R;
  a.price += b * O;
  a.opt_zone += b * O;
  a.ex_rem += b * E * R;
  a.ex_zone += b * E;
  a.ex_valid += b * E;
  a.rel_set += b * G;
  a.rel_host_forbid += b * G;
  a.rel_host_need += b * G;
  a.rel_zone_forbid += b * G;
  a.rel_zone_need += b * G;
  a.rel_slot_bits += b * E;
  a.rel_zone_bits += b * Z;
  a.units += b * G * O;
  a.units_rsv += b * G * O;
  a.rsv_group += b * G;
  a.quota += b * G * Z;
  a.zone_limited += b * G;
  a.exok_pad += b * G * NS;
  a.orders += b * K * G;
  a.alphas += b * K;
  a.looks += b * K;
  a.rsvs += b * K;
  if (a.swaps != nullptr) a.swaps += b * K * G;
  if (a.seed_costs != nullptr) a.seed_costs += b * K;
  a.price_t += b * K * G * O;
  a.ys += b * K * G * NS;
  a.cost += b * K;
  a.unplaced += b * K;
  a.exhausted += b * K;
  a.new_opt += b * K * S;
  a.new_active += b * K * S;
  return a;
}

__device__ float block_min_f(float v, Scratch& sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_min(v);
  if (lane == 0) sh.f[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float x = warp_min(lane < nw ? sh.f[lane] : kInf);
    if (lane == 0) sh.f[32] = x;
  }
  __syncthreads();
  const float r = sh.f[32];
  __syncthreads();
  return r;
}

// The block's largest (v, i), lowest i on ties, on every thread.
__device__ void block_argmax(float& v, int& i, Scratch& sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  warp_argmax_r(v, i);
  if (lane == 0) {
    sh.f[wid] = v;
    sh.i[wid] = i;
  }
  __syncthreads();
  if (wid == 0) {
    float x = lane < nw ? sh.f[lane] : neg_inf();
    int j = lane < nw ? sh.i[lane] : kIntMax;
    warp_argmax_r(x, j);
    if (lane == 0) {
      sh.f[32] = x;
      sh.i[32] = j;
    }
  }
  __syncthreads();
  v = sh.f[32];
  i = sh.i[32];
  __syncthreads();
}

// The exclusive prefix of v over the block's threads in thread order, and
// the total; unsigned, so that sums wrap like XLA's int32 sums.
__device__ unsigned block_scan(unsigned v, unsigned* part, unsigned& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned x = warp_scan(v);
  if (lane == 31) part[wid] = x;
  __syncthreads();
  const unsigned pf = lane < nw ? part[lane] : 0u;
  const unsigned before = x - v + __reduce_add_sync(kFull, lane < wid ? pf : 0u);
  total = __reduce_add_sync(kFull, pf);
  __syncthreads();
  return before;
}

// k2m_kernel replaces one stage of a step of _pack_member (jax_solver.py:
// 330-535) as XLA partitions it over the options axis: grid (K, B), one
// block of kK2Threads per member, which owns the slots [tid * NS / BT,
// (tid + 1) * NS / BT) as k2_scan's threads do. The computations on slots
// are k2_scan's own functions (k2_init_slots .. k2_member_slots), on state
// in global memory, replicated on every shard; the option rounds run over
// the shard's columns and exchange minima and records. A step is four
// launches, each followed by an exchange: fill (the last step's segments
// and opened slots from the gathered tail records, then this step's fit,
// place and wants, and the shard's lump and rate minima), pick (the in-band
// argmaxes), tail (the choices, the tail minima) and tail_pick (the tail
// argmax); the end stage opens the last step's slots and sums the member.
// A record carries its option's compat column (a bit a group), which a
// slot opened on it keeps, so that every shard knows which open slots admit
// the next group without an exchange of its own. Bound: latency, a few
// block-wide rounds a launch. One instance a stage, so that each is
// allocated registers for its own code; one block an SM is all the
// (K, B) grid needs, so ptxas may give each thread the 64 registers 1,024
// threads leave (left to itself it took 32 for some stages, and spilled).
template <int kStage>
__global__ void __launch_bounds__(kK2Threads, 1) k2m_kernel(K2MArgs p) {
  __shared__ Scratch sh;
  __shared__ unsigned s_part[32];
  __shared__ unsigned s_zpart[32 * kMaxZ];
  __shared__ int s_placed_z[kMaxZ];
  __shared__ int seg_rec[kMaxSeg], seg_c[kMaxSeg], seg_want[kMaxSeg], seg_start[kMaxSeg];
  __shared__ int s_total_open, s_opened;

  const int b = blockIdx.y, k = blockIdx.x;
  const K2MArgs a = k2m_row(p, b);
  const int tid = threadIdx.x, BT = blockDim.x;
  const int G = a.G, O = a.O, E = a.E, R = a.R, Z = a.Z, S = a.S, Zb = Z + 1, NS = E + S;
  const int CW = k2m_compat_words(G), RW = k2m_rec_words(G, R), W = kSlRem + R, nseg = 2 * Zb;
  const K2MLayout& L = p.lay;
  int* st = reinterpret_cast<int*>(a.state + ((size_t)b * a.K + k) * round16(4 * L.words));
  int* order = st + L.order;
  int* scal = st + L.scal;
  int* zbits = st + L.zbits;
  int* want = st + L.want;
  float* cmin = reinterpret_cast<float*>(st + L.cmin);
  int* rec = st + L.rec;  // [3][Zb][RW]: lump, rate, tail
  int* slots = st + L.slots;
  float* sprice = reinterpret_cast<float*>(st + L.sprice);
  int* scomp = st + L.scomp;  // [S][CW]: a fresh slot's option's compat column
  float* sc = reinterpret_cast<float*>(st + L.sc);
  auto slot = [&](int s) { return slot_at(slots, W, s); };
  const int s0 = static_cast<int>((long long)tid * NS / BT);
  const int s1 = static_cast<int>((long long)(tid + 1) * NS / BT);
  // this member's part of row j of exchange region x, which stage r writes
  auto region = [&](int* x, int r, int j) {
    return x + (((size_t)j * a.B + b) * a.K + k) * k2m_region_words(r, G, R, Z);
  };

  if (kStage == kStInit) {
    // the scoring config: member k's own, or the phase-1 winner's in phase 2
    int src = k;
    if (a.seed_costs != nullptr) {
      float best = a.seed_costs[0];
      src = 0;
      for (int j = 1; j < a.K; ++j)
        if (argmin_before(a.seed_costs[j], j, best, src)) {
          best = a.seed_costs[j];
          src = j;
        }
    }
    if (tid == 0) {
      scal[kScLook] = a.looks[src];
      scal[kScRsv] = a.rsvs[src];
      scal[kScAlpha] = __float_as_int(a.alphas[src]);
      scal[kScUnplaced] = 0;
      scal[kScExhausted] = 0;
    }
    for (int t = tid; t < G; t += BT)
      order[t] = a.seed_costs != nullptr ? a.orders[(size_t)src * G + a.swaps[(size_t)k * G + t]]
                                         : a.orders[(size_t)k * G + t];
    for (int z = tid; z < Z; z += BT) zbits[z] = a.rel_zone_bits[z];
    k2_init_slots(slots, W, s0, s1, E, R, a.ex_rem, a.ex_zone, a.ex_valid, a.rel_slot_bits);
    for (int s = s0; s < s1; ++s) sprice[s] = 0.0f;
    return;
  }

  // the winning record over every shard's: largest value, lowest index
  auto combine = [&](int* x, int stage, size_t off, int* dst) {
    const int* q = region(x, stage, 0) + off;
    for (int j = 1; j < a.n; ++j) {
      const int* r = region(x, stage, j) + off;
      const float v = __int_as_float(r[kRcValue]), bv = __int_as_float(q[kRcValue]);
      if (v > bv || (v == bv && r[kRcIdx] < q[kRcIdx])) q = r;
    }
    for (int w = 0; w < RW; ++w) dst[w] = q[w];
  };
  auto tail_want = [&](int bk) {
    const int w = want[bk];
    const int c_rate = rec[(Zb + bk) * RW + kRcUnits];
    return w - (w / max(c_rate, 1)) * c_rate;
  };

  // Step tp's segments and opened slots, from the tail records every shard
  // offered (the fill stage of step tp + 1 runs it first, the end stage for
  // the last step); ends with a barrier.
  auto apply = [&](int tp) {
    const int gp = order[tp];
    if (a.count[gp] == 0) return;
    const float* d = a.demand + (size_t)gp * R;
    for (int bk = tid; bk < Zb; bk += BT)
      if (want[bk] > 0 && tail_want(bk) > 0) combine(a.xd, kStTailPick, (size_t)bk * RW, rec + (2 * (size_t)Zb + bk) * RW);
    __syncthreads();
    const int left = scal[kScLeft], n_free = scal[kScFree];
    if (tid == 0) {
      // segments: (full or lump) + tail per bucket; seg_rec names the record
      // (0 lump, 1 rate, 2 tail) whose option the segment opens
      for (int bk = 0; bk < Zb; ++bk) {
        const int w = want[bk];
        seg_rec[bk] = seg_rec[Zb + bk] = 0;
        seg_c[bk] = seg_c[Zb + bk] = 1;
        seg_want[bk] = seg_want[Zb + bk] = 0;
        if (w <= 0) continue;
        const int* rl = rec + (size_t)bk * RW;
        const int* rr = rec + ((size_t)Zb + bk) * RW;
        const int* rt = rec + (2 * (size_t)Zb + bk) * RW;
        // the tail record was chosen only where the bucket has a remainder
        const bool tail = tail_want(bk) > 0;
        const bool lump = k2_bucket_segments(w, cmin[3 * bk], cmin[3 * bk + 1], rr[kRcUnits],
                                             __int_as_float(rr[kRcPe]), tail ? cmin[3 * bk + 2] : kInf,
                                             rl[kRcUnits], tail ? rt[kRcUnits] : 1, seg_c[bk],
                                             seg_want[bk], seg_c[Zb + bk], seg_want[Zb + bk]);
        seg_rec[bk] = lump ? 0 : 1;
        seg_rec[Zb + bk] = 2;
      }
      // starts in rank order, and what the free slots take of each segment
      int carry = 0, opened = 0;
      for (int j = 0; j < nseg; ++j) {
        const int nj = ceil_div(seg_want[j], seg_c[j]);
        seg_start[j] = carry;
        const long long taken = min(max(n_free - carry, 0), nj);
        opened += static_cast<int>(min(static_cast<long long>(seg_want[j]), taken * seg_c[j]));
        carry += nj;
      }
      s_total_open = carry;
      s_opened = opened;
    }
    unsigned lfree = 0, n_free_u;
    for (int s = s0; s < s1; ++s) lfree += (s >= E && !slot(s)[kSlAct]) ? 1u : 0u;
    const int r0 = static_cast<int>(block_scan(lfree, s_part, n_free_u));  // also orders thread 0's segments
    const int total_open = s_total_open;
    k2_open_slots(slots, W, s0, s1, E, Z, r0, total_open, nseg, seg_start, seg_c, seg_want, a.rel_set[gp],
                  zbits, a.ys + ((size_t)k * G + tp) * NS, [&](int s, int sid, int fill) {
                    const int* r = rec + ((size_t)seg_rec[sid] * Zb + sid % Zb) * RW;
                    k2_open_slot(slots, W, s, fill, d, R, reinterpret_cast<const float*>(r + kRcAlloc),
                                 r[kRcIdx], r[kRcZone]);
                    sprice[s] = __int_as_float(r[kRcPrice]);
                    for (int q = 0; q < CW; ++q) scomp[(size_t)(s - E) * CW + q] = r[kRcAlloc + R + q];
                  });
    if (tid == 0) {
      const int l2 = left - s_opened;
      scal[kScUnplaced] += l2;
      if (l2 > 0 && total_open > n_free) scal[kScExhausted] = 1;
    }
    __syncthreads();  // the opened slots and zone bits, for the next step's fit
  };

  if (kStage == kStEnd) {
    apply(G - 1);
    // the member result: k2_scan's partition and block sum of the prices
    const float csum = k2_member_slots(slots, W, s0, s1, E, a.new_opt + (size_t)k * S,
                                       a.new_active + (size_t)k * S,
                                       [&](int s, int) { return sprice[s]; });
    const float total = block_sum_f(csum, sh);
    if (tid == 0) {
      a.cost[k] = __fmaf_rn(static_cast<float>(scal[kScUnplaced]), kPenalty, total);
      a.unplaced[k] = scal[kScUnplaced];
      a.exhausted[k] = scal[kScExhausted] != 0;
    }
    return;
  }

  const int t = a.t;
  if (kStage == kStFill && t > 0) apply(t - 1);
  const int g = order[t];
  const int cnt = a.count[g];
  const bool look = scal[kScLook] != 0, rsv = scal[kScRsv] != 0;
  const bool prefer_big = __int_as_float(scal[kScAlpha]) >= 1.0f;
  const int* urow = (rsv ? a.units_rsv : a.units) + (size_t)g * O;
  const float* pe = look ? a.price_t + ((size_t)k * G + t) * O : a.price;
  const int zf = a.rel_zone_forbid[g], zn = a.rel_zone_need[g];
  const bool rel = (zf | zn) != 0;
  const bool zl = a.zone_limited[g] || rel;
  const int hn = a.rel_host_need[g];
  auto in_bucket = [&](int bk, int o) { return bk == Z || a.opt_zone[o] == bk; };
  // a shard's in-band argmax over its columns: value, global index
  auto pick = [&](int bk, int j, float band, float& v, int& i) {
    v = neg_inf();
    i = kIntMax;
    for (int o = tid; o < O; o += BT) {
      const int u = urow[o];
      const float pref = prefer_big ? static_cast<float>(u) : -static_cast<float>(u);
      arg_better(v, i, in_bucket(bk, o) && sc[2 * o + j] <= band ? pref : -kInf, a.c0 + o);
    }
    block_argmax(v, i, sh);
  };
  // the record of option i (this shard's): warp 0 writes it, a lane a
  // group of each compat word
  auto put_record = [&](int* r, float v, int i) {
    const int o = i - a.c0;
    const int lane = tid & 31;
    if (tid == 0) {
      r[kRcValue] = __float_as_int(v);
      r[kRcIdx] = i;
      r[kRcUnits] = urow[o];
      r[kRcPe] = __float_as_int(pe[o]);
      r[kRcPrice] = __float_as_int(a.price[o]);
      r[kRcZone] = a.opt_zone[o];
      for (int q = 0; q < R; ++q) r[kRcAlloc + q] = __float_as_int(a.alloc[(size_t)o * R + q]);
    }
    for (int q = 0; q < CW; ++q) {
      const int gg = 32 * q + lane;
      const unsigned bits = __reduce_or_sync(kFull, gg < G && a.compat[(size_t)gg * O + o] ? 1u << lane : 0u);
      if (tid == 0) r[kRcAlloc + R + q] = static_cast<int>(bits);
    }
  };

  if (kStage == kStFill) {
    int* yrow = a.ys + ((size_t)k * G + t) * NS;
    if (cnt == 0) {
      // a group with no pods places, wants and opens nothing
      for (int s = s0; s < s1; ++s) yrow[s] = 0;
      return;
    }
    const int cap = a.node_cap[g], hf = a.rel_host_forbid[g];
    const bool coloc = a.colocate[g];
    const float* d = a.demand + (size_t)g * R;
    const float* dfit = rsv && a.rsv_group[g] ? a.demand_units + (size_t)g * R : d;
    const int* qrow = a.quota + (size_t)g * Z;
    auto quota_of = [&](int z) -> int {
      if (!rel) return qrow[z];
      const int zb = zbits[z];
      return (zb & zf) == 0 && (zb & zn) == zn ? qrow[z] : 0;
    };
    if (tid < Z) s_placed_z[tid] = 0;
    // fit open capacity: an open fresh slot admits g when its option's
    // compat column says so
    for (int s = s0; s < s1; ++s) {
      const bool comp = s >= E ? slot(s)[kSlAct] && ((scomp[(size_t)(s - E) * CW + (g >> 5)] >> (g & 31)) & 1) != 0
                               : a.exok_pad[(size_t)g * NS + s];
      k2_slot_fit(slots, W, s, comp, hf, hn, rel, zf, zn, zbits, Z, dfit, R, cap);
    }
    if (zl) k2_zone_clip(slots, W, s0, s1, Z, s_zpart, quota_of);
    unsigned lf, high, tot_f, n_free;
    int lfree;
    k2_fit_sums(slots, W, s0, s1, E, coloc, cnt, lf, high, lfree);
    const unsigned before_f = block_scan(lf, s_part, tot_f);
    block_scan(static_cast<unsigned>(lfree), s_part, n_free);
    const unsigned placed_local = k2_fill(slots, W, s0, s1, before_f, cnt, d, R, zl, Z, s_placed_z);
    const int placed = block_sum(static_cast<int>(placed_local), sh);
    const int left = cnt - placed;
    if (tid == 0) {
      scal[kScLeft] = left;
      scal[kScFree] = static_cast<int>(n_free);
      // the wants, bucket by bucket (zone buckets, then the unrestricted one)
      unsigned acc = 0;
      for (int bk = 0; bk < Zb; ++bk) {
        int w = 0;
        if (hn != 0) {
          w = 0;  // hostname-need groups cannot open fresh nodes
        } else if (!zl) {
          w = bk == Z ? left : 0;
        } else if (bk < Z) {
          const int wz = min(max(quota_of(bk) - s_placed_z[bk], 0), left);
          w = max(min(wz, static_cast<int>(static_cast<unsigned>(left) - acc)), 0);
          acc += static_cast<unsigned>(wz);
        }
        want[bk] = w;
      }
    }
    __syncthreads();
    // the shard's lump and rate minima of every bucket with a want
    int* xa = region(a.xa, kStFill, a.self);
    for (int bk = 0; bk < Zb; ++bk) {
      const int w = want[bk];
      float a0 = kInf, a1 = kInf;
      if (w > 0) {
        for (int o = tid; o < O; o += BT) {
          const int u = urow[o];
          const bool inb = in_bucket(bk, o);
          const float v0 = lump_score(inb, w, u, pe[o]);
          const float v1 = rate_score(inb, w, u, pe[o]);
          if (inb) {
            sc[2 * o] = v0;
            sc[2 * o + 1] = v1;
          }
          a0 = fminf(a0, v0);
          a1 = fminf(a1, v1);
        }
        a0 = block_min_f(a0, sh);
        a1 = block_min_f(a1, sh);
      }
      if (tid == 0) {
        xa[2 * bk] = __float_as_int(a0);
        xa[2 * bk + 1] = __float_as_int(a1);
      }
    }
    return;
  }
  if (cnt == 0) return;

  if (kStage == kStPick) {
    // the global minima, then the shard's in-band argmaxes
    int* xb = region(a.xb, kStPick, a.self);
    for (int bk = 0; bk < Zb; ++bk) {
      if (want[bk] <= 0) continue;
      float m0 = kInf, m1 = kInf;
      for (int j = 0; j < a.n; ++j) {
        const int* x = region(a.xa, kStFill, j);
        m0 = fminf(m0, __int_as_float(x[2 * bk]));
        m1 = fminf(m1, __int_as_float(x[2 * bk + 1]));
      }
      if (tid == 0) {
        cmin[3 * bk] = m0;
        cmin[3 * bk + 1] = m1;
      }
      for (int j = 0; j < 2; ++j) {
        float v;
        int i;
        pick(bk, j, (j == 0 ? m0 : m1) * kTieBand, v, i);
        if (tid < 32) put_record(xb + ((size_t)j * Zb + bk) * RW, v, i);
      }
    }
  }

  if (kStage == kStTail) {
    // the global lump and rate choices, then the shard's tail minima
    for (int q = tid; q < 2 * Zb; q += BT) {
      const int j = q / Zb, bk = q % Zb;
      if (want[bk] > 0) combine(a.xb, kStPick, ((size_t)j * Zb + bk) * RW, rec + ((size_t)j * Zb + bk) * RW);
    }
    __syncthreads();
    int* xc = region(a.xc, kStTail, a.self);
    for (int bk = 0; bk < Zb; ++bk) {
      const int w = want[bk] > 0 ? tail_want(bk) : 0;
      float a0 = kInf;
      if (w > 0) {
        for (int o = tid; o < O; o += BT) {
          const int u = urow[o];
          const bool inb = in_bucket(bk, o);
          const float v0 = lump_score(inb, w, u, pe[o]);
          if (inb) sc[2 * o] = v0;
          a0 = fminf(a0, v0);
        }
        a0 = block_min_f(a0, sh);
      }
      if (tid == 0) xc[bk] = __float_as_int(a0);
    }
  }

  if (kStage == kStTailPick) {
    int* xd = region(a.xd, kStTailPick, a.self);
    for (int bk = 0; bk < Zb; ++bk) {
      if (want[bk] <= 0 || tail_want(bk) <= 0) continue;
      float m = kInf;
      for (int j = 0; j < a.n; ++j) m = fminf(m, __int_as_float(region(a.xc, kStTail, j)[bk]));
      if (tid == 0) cmin[3 * bk + 2] = m;
      float v;
      int i;
      pick(bk, 0, m * kTieBand, v, i);
      if (tid < 32) put_record(xd + (size_t)bk * RW, v, i);
    }
  }
}

struct SeedShard {       // one shard's phase-1 members, read in place
  const float* cost;     // [B, kl] its phase-1 costs
  const int* orders;     // [B, kl, G]
  const float* alphas;   // [B, kl]
  const bool* looks;     // [B, kl]
  const bool* rsvs;      // [B, kl]
};

struct SeedTable {
  SeedShard s[kMeshMaxShards];  // shard i's members are the global members i kl .. (i + 1) kl - 1
  const int* swaps;      // [B, kl, G] this shard's phase-2 members
  int* orders2;          // [B, kl, G]
  float* alphas2;        // [B, kl]
  bool* looks2;          // [B, kl]
  bool* rsvs2;           // [B, kl]
  int* b1;               // [B] the seed's global index
  int n, B, kl, G;
};

// The member argmin's seed (1D mesh), one launch a shard after phase 1 of
// K2: per row, the seed over all n kl members of the portfolio (the first
// NaN, else the lowest cost, the lowest global index on ties: jnp.argmin),
// then this shard's phase-2 members, orders2[k] = seed order[swaps[k]]
// under the seed's alpha, look and rsv, the winner's order row read in
// place from the shard that holds it. Grid (B); every warp finds the seed
// (the same one, with no barrier: n kl is a few dozen costs). Bound: the
// launch; its bytes are the n kl costs, one order row, the swaps and the
// phase-2 members.
__global__ void __launch_bounds__(kMeshThreads) mesh_seed(const __grid_constant__ SeedTable t) {
  const int b = blockIdx.x, kl = t.kl;
  const int j = warp_argmin([&](int q) { return t.s[q / kl].cost[(size_t)b * kl + q % kl]; }, t.n * kl);
  const SeedShard& w = t.s[j / kl];
  const size_t m = (size_t)b * kl + j % kl, KG = (size_t)kl * t.G;
  const int* order = w.orders + m * t.G;
  for (size_t i = threadIdx.x; i < KG; i += blockDim.x)
    t.orders2[b * KG + i] = order[t.swaps[b * KG + i]];
  for (int q = threadIdx.x; q < kl; q += blockDim.x) {
    t.alphas2[(size_t)b * kl + q] = w.alphas[m];
    t.looks2[(size_t)b * kl + q] = w.looks[m];
    t.rsvs2[(size_t)b * kl + q] = w.rsvs[m];
  }
  if (threadIdx.x == 0) t.b1[b] = j;
}

struct FinalTable {
  const int* bufs[kMeshMaxShards];  // each shard's K3 buffer [B][Ll] over its kl members, read in place
  const int* b1;                    // [B] the global phase-1 seed
  int* out;                         // [B][L] the whole portfolio's buffer
  int n, B, Ll, kl;
};

// The member argmin over the 2K costs (1D mesh, on the root), one launch a
// chain: every block finds the row's winner among the shards' K3 winners
// (the first NaN, else the lowest cost, the lowest global index on ties)
// and writes its kMeshTile ints of the row: the head, the costs and flags
// in global member order, the winner's rows, each read in place from the
// shard that holds it. Grid (tiles, B). Bound: the launch; its bytes are
// the row it writes and reads once.
__global__ void __launch_bounds__(kMeshThreads) mesh_final_pick(const __grid_constant__ FinalTable t) {
  const int b = blockIdx.y, kl = t.kl, K = t.n * kl;
  const size_t Ll = t.Ll, L = Ll + 4 * (size_t)kl * (t.n - 1);
  auto buf = [&](int s) { return t.bufs[s] + (size_t)b * Ll; };
  int best = 0, bg = 0;
  float bv = 0.0f;
  for (int s = 0; s < t.n; ++s) {
    const int* q = buf(s);
    const int ph = q[0], bk = q[2];
    const float v = __int_as_float(q[4 + ph * kl + bk]);
    const int gi = ph * K + s * kl + bk;
    if (s == 0 || argmin_before(v, gi, bv, bg)) {
      best = s;
      bv = v;
      bg = gi;
    }
  }
  const int* w = buf(best);
  int* out = t.out + (size_t)b * L;
  const size_t p0 = (size_t)blockIdx.x * kMeshTile, p1 = p0 + kMeshTile < L ? p0 + kMeshTile : L;
  for (size_t q = p0 + threadIdx.x; q < p1; q += blockDim.x) {
    int v;
    if (q == 0) {
      v = w[0];
    } else if (q == 1) {
      v = t.b1[b];
    } else if (q == 2) {
      v = best * kl + w[2];
    } else if (q == 3) {
      v = w[3];
    } else if (q < 4 + 4 * (size_t)K) {
      const int j = static_cast<int>(q - 4), part = j / K, m = j % K;  // part: c1, c2, ex1, ex2
      v = buf(m / kl)[4 + part * kl + m % kl];
    } else {
      v = w[q - 4 * (size_t)K + 4 * (size_t)kl];
    }
    out[q] = v;
  }
}

static_assert(sizeof(SeedTable) <= 4096 && sizeof(FinalTable) <= 4096 && sizeof(K1PairArgs) <= 4096,
              "a meshed launch's table is a few KB of parameters");

// ---------------------------------------------------------------------------
// The meshed K2 phase entry's host side (kts_k2m_phase): a phase's launches
// and exchanges issued from C
// ---------------------------------------------------------------------------

constexpr int kK2MPtrs = 44;  // kts_k2m's pointers, in K2MArgs' order
constexpr int kK2MDims = 11;  // and its dims: B K G O E R Z S c0 n self

// K2MArgs from kts_k2m's arrays; false when a width is over the kernel's
// limits.
bool k2m_from(const void* const* p, const int* d, K2MArgs* out) {
  K2MArgs a{};
  int i = 0;
  auto next = [&]() { return const_cast<void*>(p[i++]); };
  a.demand = static_cast<const float*>(next());
  a.demand_units = static_cast<const float*>(next());
  a.count = static_cast<const int*>(next());
  a.node_cap = static_cast<const int*>(next());
  a.colocate = static_cast<const bool*>(next());
  a.compat = static_cast<const bool*>(next());
  a.alloc = static_cast<const float*>(next());
  a.price = static_cast<const float*>(next());
  a.opt_zone = static_cast<const int*>(next());
  a.ex_rem = static_cast<const float*>(next());
  a.ex_zone = static_cast<const int*>(next());
  a.ex_valid = static_cast<const bool*>(next());
  a.rel_set = static_cast<const int*>(next());
  a.rel_host_forbid = static_cast<const int*>(next());
  a.rel_host_need = static_cast<const int*>(next());
  a.rel_zone_forbid = static_cast<const int*>(next());
  a.rel_zone_need = static_cast<const int*>(next());
  a.rel_slot_bits = static_cast<const int*>(next());
  a.rel_zone_bits = static_cast<const int*>(next());
  a.units = static_cast<const int*>(next());
  a.units_rsv = static_cast<const int*>(next());
  a.rsv_group = static_cast<const bool*>(next());
  a.quota = static_cast<const int*>(next());
  a.zone_limited = static_cast<const bool*>(next());
  a.val_pair = static_cast<const float*>(next());
  a.exok_pad = static_cast<const bool*>(next());
  a.orders = static_cast<const int*>(next());
  a.alphas = static_cast<const float*>(next());
  a.looks = static_cast<const bool*>(next());
  a.rsvs = static_cast<const bool*>(next());
  a.swaps = static_cast<const int*>(next());
  a.seed_costs = static_cast<const float*>(next());
  a.price_t = static_cast<float*>(next());
  a.state = static_cast<unsigned char*>(next());
  a.xa = static_cast<int*>(next());
  a.xb = static_cast<int*>(next());
  a.xc = static_cast<int*>(next());
  a.xd = static_cast<int*>(next());
  a.ys = static_cast<int*>(next());
  a.cost = static_cast<float*>(next());
  a.unplaced = static_cast<int*>(next());
  a.exhausted = static_cast<bool*>(next());
  a.new_opt = static_cast<int*>(next());
  a.new_active = static_cast<bool*>(next());
  a.B = d[0], a.K = d[1], a.G = d[2], a.O = d[3], a.E = d[4], a.R = d[5], a.Z = d[6], a.S = d[7];
  a.c0 = d[8], a.n = d[9], a.self = d[10];
  a.lay = k2m_layout(a.G, a.O, a.E, a.R, a.Z, a.S);
  *out = a;
  return a.R <= kMaxR && a.Z <= kMaxZ && a.n >= 1 && a.self >= 0 && a.self < a.n;
}

// Ints of one shard's row of region r: B rows of K members.
size_t k2m_row_words(const K2MArgs& a, int r) { return (size_t)a.B * a.K * k2m_region_words(r, a.G, a.R, a.Z); }

int* k2m_region(const K2MArgs& a, int r) {
  int* const x[kK2MRegions] = {a.xa, a.xb, a.xc, a.xd};
  return x[r];
}

// One kts_k2m launch: k2m_kernel's `stage` of step t (kStInit: k2_prices
// first).
cudaError_t k2m_launch(K2MArgs a, int stage, int t, cudaStream_t st) {
  a.t = t;
  if (stage == kStInit) {
    K2Limits lim;
    cudaError_t err = k2_limits(&lim);
    if (err != cudaSuccess) return err;
    if (k2_price_bytes(a.G) + lim.prices_static > lim.optin) return cudaErrorInvalidValue;
    const K2Args pa{a.demand, a.demand_units, a.count, a.node_cap, a.colocate, a.compat, a.alloc,
                    a.price, a.opt_zone, a.ex_rem, a.ex_zone, a.ex_valid, a.rel_set,
                    a.rel_host_forbid, a.rel_host_need, a.rel_zone_forbid, a.rel_zone_need,
                    a.rel_slot_bits, a.rel_zone_bits, a.units, a.units_rsv, a.rsv_group, a.quota,
                    a.zone_limited, a.val_pair, a.exok_pad, a.orders, a.alphas, a.looks, a.rsvs,
                    a.swaps, a.seed_costs, a.cost, a.unplaced, a.exhausted, a.new_opt,
                    a.new_active, a.ys, a.price_t, nullptr, 0, a.K, a.G, a.O, a.E, a.R, a.Z, a.S};
    const size_t tiles = ((size_t)a.G * a.O + kK2PriceThreads - 1) / kK2PriceThreads;
    k2_prices<<<dim3(static_cast<unsigned>(tiles), a.K, a.B), kK2PriceThreads, k2_price_bytes(a.G), st>>>(pa);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  void (*const stages[])(K2MArgs) = {k2m_kernel<kStInit>, k2m_kernel<kStFill>, k2m_kernel<kStPick>,
                                      k2m_kernel<kStTail>, k2m_kernel<kStTailPick>, k2m_kernel<kStEnd>};
  void (*kernel)(K2MArgs) = stages[stage - kStInit];
  kernel<<<dim3(a.K, a.B), kK2Threads, 0, st>>>(a);
  return cudaGetLastError();
}

struct K2MShard {
  K2MArgs a;
  int device;
  cudaStream_t stream;  // the shard's own (the caller's)
  cudaEvent_t event;    // the phase's own, for its exchanges
};

// Issue a phase on the shards' streams exactly as the per-stage path does
// from Python: each shard's begin, the G steps of four stages with an
// exchange after each stage, each shard's end, then every stream waits on
// every other's end. An exchange records each shard's event and makes every
// other shard's stream wait on it; where the shards hold copies of the
// regions, it then copies the sender's row into each receiver's copy
// (cudaMemcpyPeerAsync on the receiver's stream). `launches` counts the
// k2m_launch calls the runtime accepted, in the units of kts_k2m.
cudaError_t k2m_issue(K2MShard* sh, int n, bool shared, long long* launches) {
  const int G = sh[0].a.G;
  cudaError_t err = cudaSuccess;
  auto ok = [&](cudaError_t e) { return (err = e) == cudaSuccess; };
  int current = -1;  // the device made current last
  auto on = [&](int device) {
    if (device == current) return true;
    current = device;
    return ok(cudaSetDevice(device));
  };
  auto exchange = [&](int r) {  // r < 0: order only
    if (n == 1) return true;
    for (int i = 0; i < n; ++i)
      if (!on(sh[i].device) || !ok(cudaEventRecord(sh[i].event, sh[i].stream))) return false;
    for (int j = 0; j < n; ++j) {
      K2MShard& rx = sh[j];
      if (!on(rx.device)) return false;
      for (int i = 0; i < n; ++i) {
        if (i == j) continue;
        if (!ok(cudaStreamWaitEvent(rx.stream, sh[i].event, 0))) return false;
        if (r >= 0 && !shared) {
          const size_t w = k2m_row_words(rx.a, r);
          if (!ok(cudaMemcpyPeerAsync(k2m_region(rx.a, r) + i * w, rx.device, k2m_region(sh[i].a, r) + i * w,
                                      sh[i].device, w * sizeof(int), rx.stream)))
            return false;
        }
      }
    }
    return true;
  };
  auto launch = [&](int stage, int t) {
    for (int i = 0; i < n; ++i) {
      if (!on(sh[i].device) || !ok(k2m_launch(sh[i].a, stage, t, sh[i].stream))) return false;
      ++*launches;
    }
    return true;
  };
  if (!launch(kStInit, 0)) return err;
  for (int t = 0; t < G; ++t)
    for (int stage = kStFill; stage <= kStTailPick; ++stage)
      if (!launch(stage, t) || !exchange(stage)) return err;
  if (!launch(kStEnd, 0) || !exchange(-1)) return err;
  return cudaSuccess;
}

// One phase: peer access enabled where shards on distinct cards share their
// regions (each reads the others' rows in place), an event a shard where
// there are shards to exchange with, the issue. The events are destroyed on
// return: the runtime frees each once the work before its last record is
// done, and the waits already issued stand.
cudaError_t k2m_phase(K2MShard* sh, int n, long long* launches) {
  bool one_card = true, shared = true;
  for (int i = 1; i < n; ++i) {
    one_card = one_card && sh[i].device == sh[0].device;
    for (int r = 0; r < kK2MRegions; ++r) shared = shared && k2m_region(sh[i].a, r) == k2m_region(sh[0].a, r);
  }
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < n && shared && !one_card && err == cudaSuccess; ++i)
    for (int j = 0; j < n && err == cudaSuccess; ++j) {
      if (sh[i].device == sh[j].device) continue;
      err = cudaSetDevice(sh[i].device);
      if (err == cudaSuccess) err = cudaDeviceEnablePeerAccess(sh[j].device, 0);
      if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();
        err = cudaSuccess;
      }
    }
  int made = 0;
  while (err == cudaSuccess && n > 1 && made < n) {
    err = cudaSetDevice(sh[made].device);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&sh[made].event, cudaEventDisableTiming);
    if (err == cudaSuccess) ++made;
  }
  if (err == cudaSuccess) err = k2m_issue(sh, n, shared, launches);
  for (int i = 0; i < made; ++i) {
    cudaSetDevice(sh[i].device);
    cudaEventDestroy(sh[i].event);
  }
  return err;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface: each entry launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 when the launches were accepted). B is the batch
// axis: every array holds B rows of the per-row shapes named in the Args
// structs, back to back.
// ---------------------------------------------------------------------------

extern "C" {

const char* kts_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Bytes of scratch kts_shared_precompute needs for B rows of G groups and O
// options: k1_units' partial minima and flags.
long long kts_shared_precompute_scratch(int B, int G, int O) {
  return 2LL * B * G * k1_tiles(O) * 4;
}

int kts_shared_precompute(
    const float* demand, const float* demand_units, const int* count, const int* node_cap,
    const int* quota, const bool* colocate, const bool* compat, const float* alloc,
    const float* price, const bool* opt_valid, const bool* ex_compat, const bool* ex_valid,
    int* units, int* units_rsv, bool* rsv_group, float* lam, bool* zone_limited,
    float* val_pair, bool* exok_pad, bool* is_new, void* scratch, int B, int G, int O, int E,
    int R, int Z, int S, void* stream) {
  float* part_min = static_cast<float*>(scratch);
  int* part_fit = reinterpret_cast<int*>(part_min + (size_t)B * G * k1_tiles(O));
  const int rows = k1_pair_rows(B, G, O);
  K1Args a{demand, demand_units, count, node_cap, quota, colocate, compat, alloc, price,
           opt_valid, ex_compat, ex_valid, units, units_rsv, rsv_group, lam, zone_limited,
           val_pair, exok_pad, is_new, part_min, part_fit, G, O, E, R, Z, S, rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // three resources (cpu, memory, pods) is every configuration's width
  void (*units_k)(K1Args) = R == 3 ? k1_units<3> : k1_units<0>;
  void (*pair_k)(K1Args) = R == 3 ? k1_val_pair<3> : k1_val_pair<0>;
  units_k<<<dim3(k1_tiles(O), G, B), kK1Threads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((O + kK1PairTile - 1) / kK1PairTile, (G + rows - 1) / rows, B);
  pair_k<<<grid, kK1Threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int kts_pack_member(
    const float* demand, const float* demand_units, const int* count, const int* node_cap,
    const bool* colocate, const bool* compat, const float* alloc, const float* price,
    const int* opt_zone, const float* ex_rem, const int* ex_zone, const bool* ex_valid,
    const int* rel_set, const int* rel_host_forbid, const int* rel_host_need,
    const int* rel_zone_forbid, const int* rel_zone_need, const int* rel_slot_bits,
    const int* rel_zone_bits, const int* units, const int* units_rsv, const bool* rsv_group,
    const int* quota, const bool* zone_limited, const float* val_pair, const bool* exok_pad,
    const int* orders, const float* alphas, const bool* looks, const bool* rsvs,
    const int* swaps, const float* seed_costs, float* cost, int* unplaced, bool* exhausted,
    int* new_opt, bool* new_active, int* ys, float* price_t, unsigned char* state,
    int B, int K, int G, int O, int E, int R, int Z, int S, int smem_limit, void* stream) {
  K2Limits lim;
  cudaError_t err = k2_limits(&lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  K2Plan plan;
  if (!k2_plan(lim, G, O, R, Z, E + S, smem_limit, &plan) || (plan.spill != 0 && state == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  K2Args a{demand, demand_units, count, node_cap, colocate, compat, alloc, price, opt_zone,
           ex_rem, ex_zone, ex_valid, rel_set, rel_host_forbid, rel_host_need,
           rel_zone_forbid, rel_zone_need, rel_slot_bits, rel_zone_bits, units, units_rsv,
           rsv_group, quota, zone_limited, val_pair, exok_pad, orders, alphas, looks, rsvs,
           swaps, seed_costs, cost, unplaced, exhausted, new_opt, new_active, ys, price_t,
           plan.spill != 0 ? state : nullptr, plan.spill, K, G, O, E, R, Z, S};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t tiles = ((size_t)G * O + kK2PriceThreads - 1) / kK2PriceThreads;
  k2_prices<<<dim3(static_cast<unsigned>(tiles), K, B), kK2PriceThreads, k2_price_bytes(G), st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  void (*scan)(K2Args) = plan.spill >= 2 ? k2_scan<false> : k2_scan<true>;
  scan<<<dim3(K, B), kK2Threads, plan.smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of global scratch one member of K2 needs at these widths (0 when the
// scan keeps everything in shared memory), planned against `smem_limit`
// bytes of shared memory a block, or the card's opt-in limit when it is 0;
// -1 when the card's limits cannot be read, -2 when no plan fits (the
// lookahead prices' 8 bytes a group, or the scan's partials, over the limit).
long long kts_pack_member_scratch(int G, int O, int R, int Z, int NS, int smem_limit) {
  K2Limits lim;
  if (k2_limits(&lim) != cudaSuccess) return -1;
  K2Plan plan;
  if (!k2_plan(lim, G, O, R, Z, NS, smem_limit, &plan)) return -2;
  return static_cast<long long>(k2_scratch_bytes(plan.spill, G, O, R, Z, NS));
}

int kts_pack_epilogue(
    const float* c1, const int* u1, const bool* ex1, const int* no1, const bool* na1,
    const int* ys1, const float* c2, const int* u2, const bool* ex2, const int* no2,
    const bool* na2, const int* ys2, int* buf, int B, int K, int T, int NS, int S,
    void* stream) {
  K3Args a{c1, u1, ex1, no1, na1, ys1, c2, u2, ex2, no2, na2, ys2, buf, K, T, NS, S};
  const size_t len = 4 + 4 * (size_t)K + 2 * (size_t)S + (size_t)T * NS;
  const dim3 grid(static_cast<unsigned>((len + kK3Tile - 1) / kK3Tile), B);
  k3_pack_epilogue<<<grid, kK3Threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The meshed tier's entries (solver/meshed.py): each launches on `stream`
// for one shard; the exchanges between shards are the caller's.
// ---------------------------------------------------------------------------

// Columns of k1_units' partials for O options.
long long kts_k1_tiles(int O) { return k1_tiles(O); }

// K1's part on one option shard: k1_units over its O columns, the partial
// minima and fits into `part` ([2][B][G][k1_tiles(O)] words).
int kts_k1_part(
    const float* demand, const float* demand_units, const int* count, const int* node_cap,
    const int* quota, const bool* colocate, const bool* compat, const float* alloc,
    const float* price, const bool* opt_valid, const bool* ex_compat, const bool* ex_valid,
    int* units, int* units_rsv, bool* rsv_group, bool* zone_limited, bool* exok_pad,
    bool* is_new, void* part, int B, int G, int O, int E, int R, int Z, int S, void* stream) {
  float* part_min = static_cast<float*>(part);
  int* part_fit = reinterpret_cast<int*>(part_min + (size_t)B * G * k1_tiles(O));
  K1Args a{demand, demand_units, count, node_cap, quota, colocate, compat, alloc, price,
           opt_valid, ex_compat, ex_valid, units, units_rsv, rsv_group, nullptr, zone_limited,
           nullptr, exok_pad, is_new, part_min, part_fit, G, O, E, R, Z, S, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*units_k)(K1Args) = R == 3 ? k1_units<3> : k1_units<0>;
  units_k<<<dim3(k1_tiles(O), G, B), kK1Threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K1's finish on one option shard: k1_val_pair_shards over the shard's O
// columns, the n shards' partials (`parts`: n device pointers, each
// [2][B][G][tiles] words) read in place through its table; k1_pair_rows'
// groups g a block (at 50k_full's 4,096, 2,048 and 1,024 columns the card
// ran the rule's choice fastest, PERF.md, row 5).
int kts_k1_finish(
    const float* demand, const float* demand_units, const int* count, const int* node_cap,
    const bool* colocate, const bool* compat, const float* alloc, const bool* opt_valid,
    const int* units, int* units_rsv, float* lam, float* val_pair, const void* const* parts,
    int n, int B, int G, int O, int E, int R, int Z, int S, void* stream) {
  if (n < 1 || n > kMeshMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = k1_pair_rows(B, G, O);
  K1Args a{demand, demand_units, count, node_cap, nullptr, colocate, compat, alloc, nullptr,
           opt_valid, nullptr, nullptr, const_cast<int*>(units), units_rsv, nullptr, lam, nullptr,
           val_pair, nullptr, nullptr, nullptr, nullptr, G, O, E, R, Z, S, rows};
  K1PairArgs pa{a, {}};
  for (int i = 0; i < n; ++i) pa.parts.p[i] = static_cast<const int*>(parts[i]);
  pa.parts.n = n;
  void (*pair_k)(K1PairArgs) = R == 3 ? k1_val_pair_shards<3> : k1_val_pair_shards<0>;
  const dim3 grid((O + kK1PairTile - 1) / kK1PairTile, (G + rows - 1) / rows, B);
  pair_k<<<grid, kK1Threads, 0, static_cast<cudaStream_t>(stream)>>>(pa);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of one member's state in k2m_kernel at these widths (O: the shard's columns).
long long kts_k2m_state_bytes(int G, int O, int E, int R, int Z, int S) {
  return static_cast<long long>(k2m_state_bytes(G, O, E, R, Z, S));
}

// K2 on one option shard: stage -1 starts a phase (k2_prices over the
// shard's columns, then the member state), 0-3 run stage `stage` of step t,
// 4 ends it (the last step's slots, the member results). `ptrs`: the 44
// pointers in K2MArgs' order; `dims`: B K G O E R Z S c0 n self.
int kts_k2m(const void* const* ptrs, const int* dims, int stage, int t, void* stream) {
  K2MArgs a;
  if (!k2m_from(ptrs, dims, &a) || stage < kStInit || stage > kStEnd)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(k2m_launch(a, stage, t, static_cast<cudaStream_t>(stream)));
}

// The phase entry: one call issues a whole meshed K2 phase over n shards
// (each shard's begin, the G steps of the four stages with an exchange after
// each, each shard's end). `ptrs` and `dims`: n blocks of kts_k2m's arrays,
// shard i's i-th; `devices[i]`, `streams[i]`: its card and stream.
// `launches`: the kts_k2m launches it issued, also when it fails part way.
// The caller's device is kept.
int kts_k2m_phase(int n, const void* const* ptrs, const int* dims, const int* devices,
                  void* const* streams, long long* launches) {
  *launches = 0;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  K2MShard* sh = new (std::nothrow) K2MShard[n]();
  if (sh == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    K2MShard& s = sh[i];
    if (!k2m_from(ptrs + (size_t)i * kK2MPtrs, dims + (size_t)i * kK2MDims, &s.a) || s.a.self != i ||
        s.a.n != n || s.a.G != sh[0].a.G)
      err = cudaErrorInvalidValue;
    s.device = devices[i];
    s.stream = static_cast<cudaStream_t>(streams[i]);
  }
  int caller = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&caller);
  if (err == cudaSuccess) {
    err = k2m_phase(sh, n, launches);
    const cudaError_t back = cudaSetDevice(caller);
    if (err == cudaSuccess) err = back;
  }
  delete[] sh;
  return static_cast<int>(err);
}

// The 1D mesh's member argmin on one shard: the seed over the n shards'
// phase-1 members (`members`: n blocks of 5 device pointers, cost, orders,
// alphas, looks, rsvs, each [B, kl, ...]) and this shard's phase-2 members.
int kts_mesh_seed(const void* const* members, const int* swaps, int* orders2, float* alphas2,
                  bool* looks2, bool* rsvs2, int* b1, int n, int B, int kl, int G, void* stream) {
  if (n < 1 || n > kMeshMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  SeedTable t{};
  for (int i = 0; i < n; ++i) {
    const void* const* m = members + 5 * static_cast<size_t>(i);
    t.s[i] = SeedShard{static_cast<const float*>(m[0]), static_cast<const int*>(m[1]),
                       static_cast<const float*>(m[2]), static_cast<const bool*>(m[3]),
                       static_cast<const bool*>(m[4])};
  }
  t.swaps = swaps;
  t.orders2 = orders2;
  t.alphas2 = alphas2;
  t.looks2 = looks2;
  t.rsvs2 = rsvs2;
  t.b1 = b1;
  t.n = n, t.B = B, t.kl = kl, t.G = G;
  mesh_seed<<<B, kMeshThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// The winner over the 2K costs from the n shards' K3 buffers (`bufs`: n
// device pointers, each [B][Ll] over kl members) into out ([B][Ll + 4 kl (n - 1)]).
int kts_final_pick(const void* const* bufs, const int* b1, int* out, int n, int B, int Ll, int kl,
                   void* stream) {
  if (n < 1 || n > kMeshMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  FinalTable t{};
  for (int i = 0; i < n; ++i) t.bufs[i] = static_cast<const int*>(bufs[i]);
  t.b1 = b1;
  t.out = out;
  t.n = n, t.B = B, t.Ll = Ll, t.kl = kl;
  const size_t L = (size_t)Ll + 4 * (size_t)kl * (n - 1);
  const dim3 grid(static_cast<unsigned>((L + kMeshTile - 1) / kMeshTile), B);
  mesh_final_pick<<<grid, kMeshThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
