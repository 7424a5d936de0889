// Packing kernels for the portfolio solve, hand-written for Hopper (sm_90a).
//
// Three kernels replace the XLA program of karpenter_tpu/solver/jax_solver.py:
//
//   K1 shared_precompute  <- _shared_precompute (jax_solver.py:193-281)
//   K2 pack_member        <- _pack_member under vmap (jax_solver.py:295-535),
//                            launched once per search phase
//   K3 pack_epilogue      <- the argmin and buffer packing of
//                            _pack_solve_fused_impl (jax_solver.py:538-604)
//
// One solve is K1, K2, K2, K3 on one stream and one copy of the result buffer
// to the host. The plain PyTorch versions of all three live beside their
// wrappers in solver/torch_solver.py.
//
// Batch axis. Every entry takes B stacked problems of one shape and solves
// them in the same four launches: this is the fleet dispatch of the sharded
// round (pack_solve_fleet, jax_solver.py:615-643, which runs the B=1 program
// under vmap). Each block finds its row b (blockIdx.z for K1's two passes,
// blockIdx.y for K2's (K, B) grid, blockIdx.x for K3's B blocks) and offsets
// every input, output and scratch pointer by that row's size_t stride
// (k1_row, k2_row, k3_row); the rest of the code is the B=1 code, so row b of
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
// zero. Every argmin/argmax resolves ties to the lower index, as jnp does.

#include <cuda_runtime.h>
#include <stddef.h>

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
constexpr int kK2Threads = 1024;
constexpr int kK3Threads = 1024;

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

__device__ float block_min(float v, Scratch& sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_min(v);
  if (lane == 0) sh.f[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float x = lane < nw ? sh.f[lane] : kInf;
    x = warp_min(x);
    if (lane == 0) sh.f[32] = x;
  }
  __syncthreads();
  const float r = sh.f[32];
  __syncthreads();
  return r;
}

// Index of the largest value, lowest index on ties.
__device__ int block_argmax(float v, int i, Scratch& sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, v, o);
    const int i2 = __shfl_xor_sync(kFull, i, o);
    arg_better(v, i, v2, i2);
  }
  if (lane == 0) {
    sh.f[wid] = v;
    sh.i[wid] = i;
  }
  __syncthreads();
  if (wid == 0) {
    float x = lane < nw ? sh.f[lane] : neg_inf();
    int j = lane < nw ? sh.i[lane] : kIntMax;
    for (int o = 16; o > 0; o >>= 1) {
      const float x2 = __shfl_xor_sync(kFull, x, o);
      const int j2 = __shfl_xor_sync(kFull, j, o);
      arg_better(x, j, x2, j2);
    }
    if (lane == 0) sh.i[32] = j;
  }
  __syncthreads();
  const int r = sh.i[32];
  __syncthreads();
  return r;
}

// Inclusive prefix sum over the block; *total gets the block's sum.
__device__ int block_scan(int v, Scratch& sh, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  unsigned x = static_cast<unsigned>(v);
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh.i[wid] = static_cast<int>(x);
  __syncthreads();
  if (wid == 0) {
    unsigned w = lane < nw ? static_cast<unsigned>(sh.i[lane]) : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    sh.i[lane] = static_cast<int>(w);
  }
  __syncthreads();
  if (wid > 0) x += static_cast<unsigned>(sh.i[wid - 1]);
  *total = sh.i[nw - 1];
  __syncthreads();
  return static_cast<int>(x);
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
  int G, O, E, R, Z, S;
};

// K1Args of batch row b: every array advanced by b times its per-row size.
__device__ __forceinline__ K1Args k1_row(K1Args a, size_t b) {
  const size_t G = a.G, O = a.O, E = a.E, R = a.R, Z = a.Z, NS = a.E + a.S;
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
  return a;
}

__device__ __forceinline__ int finish_units(int un, bool ok, int cap, bool coloc, int cnt) {
  un = min(un, cap);
  if (!ok) un = 0;
  if (coloc && un < cnt) un = 0;
  return un;
}

// K1a replaces _shared_precompute's per-group part (jax_solver.py:206-243):
// one block per (group row g, batch row b) loops over the O options for the raw and
// reserve-sized unit counts, reduces row_fits over O, finishes both, and
// reduces lam as a row min. Bound: the [G, O] reads of compat and the two
// [G, O] unit writes, ~0.5 MB at 50k_full (G=32, O=4096), well under a
// microsecond of bandwidth; the block's own latency dominates. The val_pair
// table needs every group's lam, so it is a second pass (K1b).
__global__ void __launch_bounds__(kK1Threads) k1_units(K1Args p) {
  __shared__ Scratch sh;
  const K1Args a = k1_row(p, blockIdx.z);
  const int g = blockIdx.x;
  const int O = a.O, R = a.R;
  float d[kMaxR], du[kMaxR];
  for (int r = 0; r < R; ++r) {
    d[r] = a.demand[(size_t)g * R + r];
    du[r] = a.demand_units[(size_t)g * R + r];
  }
  const int cnt = a.count[g], cap = a.node_cap[g];
  const bool coloc = a.colocate[g];
  int fits = 0;
  for (int o = threadIdx.x; o < O; o += blockDim.x) {
    const float* c = a.alloc + (size_t)o * R;
    const int ur = fit_units(c, d, R);
    const int uv = fit_units(c, du, R);
    const bool ok = a.compat[(size_t)g * O + o] && a.opt_valid[o];
    fits |= (uv > 0 && ok) ? 1 : 0;
    a.units[(size_t)g * O + o] = ur;
    a.units_rsv[(size_t)g * O + o] = uv;
  }
  // an option that cannot hold one provider pod plus its reserve stays 0 for
  // reserve members, unless no option fits the reserve at all
  const bool row_fits = block_sum(fits, sh) > 0;
  float lmin = kInf;
  for (int o = threadIdx.x; o < O; o += blockDim.x) {
    const size_t go = (size_t)g * O + o;
    const bool ok = a.compat[go] && a.opt_valid[o];
    int ur = a.units[go], uv = a.units_rsv[go];
    if (!row_fits && ur > 0) uv = ur;
    ur = finish_units(ur, ok, cap, coloc, cnt);
    uv = finish_units(uv, ok, cap, coloc, cnt);
    a.units[go] = ur;
    a.units_rsv[go] = uv;
    if (ur > 0) lmin = fminf(lmin, a.price[o] / fmaxf(static_cast<float>(ur), 1.0f));
  }
  const float lam_raw = block_min(lmin, sh);
  if (threadIdx.x == 0) {
    a.lam[g] = lam_raw < kInf ? lam_raw : 0.0f;
    bool zl = false;
    for (int z = 0; z < a.Z; ++z) zl |= a.quota[(size_t)g * a.Z + z] < kIBig;
    a.zone_limited[g] = zl;
    bool rg = false;
    for (int r = 0; r < R; ++r) rg |= a.demand_units[(size_t)g * R + r] != a.demand[(size_t)g * R + r];
    a.rsv_group[g] = rg;
  }
  const int NS = a.E + a.S;
  for (int s = threadIdx.x; s < NS; s += blockDim.x)
    a.exok_pad[(size_t)g * NS + s] =
        s < a.E && a.ex_compat[(size_t)g * a.E + s] && a.ex_valid[s];
}

// K1b replaces the lookahead value table (jax_solver.py:245-264):
// val_pair[g, o, g'] = whole pods of g' that fit in the residual of one (g, o)
// node, times g''s cheapest per-pod rate. One thread per (o, g') element of a
// row g of batch row b (blockIdx.z), so the 16 MB table at 50k_full is written once, coalesced, by the
// whole card. Bound: those bytes (about 5 us at 3.35 TB/s); the
// G*O*G'*R divisions are far below the f32 rate.
__global__ void __launch_bounds__(kK1Threads) k1_val_pair(K1Args p) {
  const K1Args a = k1_row(p, blockIdx.z);
  const int g = blockIdx.y;
  const int O = a.O, G = a.G, R = a.R;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)O * G) return;
  const int o = static_cast<int>(i / G), g2 = static_cast<int>(i % G);
  const float uf = static_cast<float>(a.units[(size_t)g * O + o]);
  float u2 = kInf;
  for (int r = 0; r < R; ++r) {
    const float resid = __fmaf_rn(-uf, a.demand[(size_t)g * R + r], a.alloc[(size_t)o * R + r]);
    const float dr = a.demand[(size_t)g2 * R + r];
    const float ur = dr > 0.0f ? floorf(resid / fmaxf(dr, kTiny) + kEps) : kInf;
    u2 = r == 0 ? ur : fminf(u2, ur);
  }
  u2 = fminf(fmaxf(u2, 0.0f), kIBigF);
  u2 = fminf(u2, static_cast<float>(a.node_cap[g2]));
  const bool ok2 = a.compat[(size_t)g2 * O + o] && a.opt_valid[o];
  a.val_pair[(size_t)g * O * G + i] = (ok2 && u2 > 0.0f) ? u2 * a.lam[g2] : 0.0f;
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
  int* order_s;                 // scratch [K, G]
  int* pos_s;                   // scratch [K, G]
  float* price_t;               // scratch [K, G, O]
  float* slot_rem;              // scratch [K, E+S, R]
  int* slot_i;                  // scratch [K, 6, E+S]
  int K, G, O, E, R, Z, S;
};

// K2Args of batch row b: every array advanced by b times its per-row size.
// Phase 1 passes null swaps and seed_costs, which stay null.
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
  a.order_s += b * K * G;
  a.pos_s += b * K * G;
  a.price_t += b * K * G * O;
  a.slot_rem += b * K * NS * R;
  a.slot_i += b * K * 6 * NS;
  return a;
}

// K2 replaces _pack_member (jax_solver.py:295-535) for K members at once:
// one block per (member k, batch row b). The prologue derives the member's scan order (phase
// 2: orders[argmin(phase-1 costs)][swaps[k]], on the device, so the phases
// need no host sync) and builds price_t[T, O] (:318-328) into global scratch;
// then the block runs the T steps of the scan with slot state in global
// scratch. Cumsums over slots are chunked block scans with a carried prefix;
// each argmin is a min reduction then a (value, index) argmax over the
// candidates, lower index on ties.
//
// Bound: bytes, by the prologue's read of val_pair[order] (16 MB per member at
// 50k_full, read only by lookahead members); the scan itself is latency-bound
// -- T dependent steps of block reductions on K*B of the 132 SMs. What the
// design does about that: members and batch rows run concurrently, one block
// per SM, so a fleet of B rows costs about what one row costs while K*B <= 132; steps of
// groups with no pods, buckets with no want and tails with no remainder are
// skipped (their results are never read); the step state is kept to a few
// small vectors so each step is a handful of barriers.
__global__ void __launch_bounds__(kK2Threads) k2_pack_member(K2Args p) {
  __shared__ Scratch sh;
  __shared__ float s_d[kMaxR], s_dfit[kMaxR];
  __shared__ int s_q[kMaxZ], s_zone_bits[kMaxZ], s_placed_z[kMaxZ], s_zhit[kMaxZ];
  __shared__ int s_want[kMaxZb];
  __shared__ int s_o_lump[kMaxZb], s_o_rate[kMaxZb], s_o_tail[kMaxZb];
  __shared__ float s_c_lump[kMaxZb], s_b_rate[kMaxZb], s_b_tail[kMaxZb];
  __shared__ int s_seg_opt[kMaxSeg], s_seg_c[kMaxSeg], s_seg_want[kMaxSeg], s_seg_start[kMaxSeg];
  __shared__ int s_g, s_cnt, s_cap, s_coloc, s_hf, s_hn, s_zf, s_zn, s_zl, s_sm;
  __shared__ int s_left, s_total_open, s_src, s_look, s_rsv, s_unplaced, s_exhausted;
  __shared__ float s_alpha;

  const K2Args a = k2_row(p, blockIdx.y);
  const int k = blockIdx.x, tid = threadIdx.x, B = blockDim.x;
  const int G = a.G, O = a.O, E = a.E, R = a.R, Z = a.Z, Zb = a.Z + 1;
  const int NS = a.E + a.S, nseg = 2 * Zb;
  const bool phase2 = a.seed_costs != nullptr;
  int* order = a.order_s + (size_t)k * G;
  int* pos = a.pos_s + (size_t)k * G;
  float* price_t = a.price_t + (size_t)k * G * O;
  float* rem = a.slot_rem + (size_t)k * NS * R;
  int* sopt = a.slot_i + (size_t)k * 6 * NS;
  int* szone = sopt + NS;
  int* sact = szone + NS;
  int* sbits = sact + NS;
  int* sfit = sbits + NS;
  int* splace = sfit + NS;
  int* ys = a.ys + (size_t)k * G * NS;

  // ---- prologue: scan order, scoring config, lookahead prices, slot state ----
  if (tid == 0) {
    int src = k;
    if (phase2) {  // phase-1 winner: argmin, first index on ties
      float best = a.seed_costs[0];
      src = 0;
      for (int j = 1; j < a.K; ++j)
        if (a.seed_costs[j] < best) {
          best = a.seed_costs[j];
          src = j;
        }
    }
    s_src = src;
    s_alpha = a.alphas[src];
    s_look = a.looks[src];
    s_rsv = a.rsvs[src];
    s_unplaced = 0;
    s_exhausted = 0;
  }
  __syncthreads();
  const int src = s_src;
  const bool look = s_look, rsv = s_rsv;
  const float alpha = s_alpha;
  for (int t = tid; t < G; t += B) {
    order[t] = phase2 ? a.orders[(size_t)src * G + a.swaps[(size_t)k * G + t]]
                      : a.orders[(size_t)k * G + t];
    pos[t] = 0;
  }
  __syncthreads();
  for (int t = tid; t < G; t += B) pos[order[t]] = t;
  __syncthreads();
  for (size_t i = tid; i < (size_t)G * O; i += B) {
    const int t = static_cast<int>(i / O), o = static_cast<int>(i % O);
    const float p = a.price[o];
    float v = p;
    if (look) {
      // price minus the discounted residual value to groups later in the order
      const float* vp = a.val_pair + ((size_t)order[t] * O + o) * G;
      float m = 0.0f;
      for (int g2 = 0; g2 < G; ++g2)
        if (pos[g2] > t) m = fmaxf(m, vp[g2]);
      v = fmaxf(__fmaf_rn(m, -kDiscount, p), kFloor * p);
    }
    price_t[i] = v;
  }
  for (int s = tid; s < NS; s += B) {
    const bool ex = s < E;
    for (int r = 0; r < R; ++r) rem[(size_t)s * R + r] = ex ? a.ex_rem[(size_t)s * R + r] : 0.0f;
    sopt[s] = -1;
    szone[s] = ex ? a.ex_zone[s] : 0;
    sact[s] = ex ? static_cast<int>(a.ex_valid[s]) : 0;
    sbits[s] = ex ? a.rel_slot_bits[s] : 0;
  }
  for (int z = tid; z < Z; z += B) s_zone_bits[z] = a.rel_zone_bits[z];
  __syncthreads();

  // ---- the scan over groups ----
  for (int t = 0; t < G; ++t) {
    if (tid == 0) {
      const int g = order[t];
      s_g = g;
      s_cnt = a.count[g];
      s_cap = a.node_cap[g];
      s_coloc = a.colocate[g];
      s_hf = a.rel_host_forbid[g];
      s_hn = a.rel_host_need[g];
      s_zf = a.rel_zone_forbid[g];
      s_zn = a.rel_zone_need[g];
      s_sm = a.rel_set[g];
      const bool fit_rsv = rsv && a.rsv_group[g];
      for (int r = 0; r < R; ++r) {
        s_d[r] = a.demand[(size_t)g * R + r];
        s_dfit[r] = fit_rsv ? a.demand_units[(size_t)g * R + r] : s_d[r];
      }
      // relation-eligible zones: no forbidden bits, every needed bit present
      for (int z = 0; z < Z; ++z) {
        const int zb = s_zone_bits[z];
        const bool rel_ok = (zb & s_zf) == 0 && (zb & s_zn) == s_zn;
        s_q[z] = rel_ok ? a.quota[(size_t)g * Z + z] : 0;
        s_placed_z[z] = 0;
        s_zhit[z] = 0;
      }
      s_zl = a.zone_limited[g] || s_zf != 0 || s_zn != 0;
    }
    __syncthreads();
    const int g = s_g, cnt = s_cnt;
    int* yrow = ys + (size_t)t * NS;
    if (cnt == 0) {
      // a group with no pods places, wants and opens nothing
      for (int s = tid; s < NS; s += B) yrow[s] = 0;
      __syncthreads();
      continue;
    }
    const int cap = s_cap, hf = s_hf, hn = s_hn, zf = s_zf, zn = s_zn;
    const bool coloc = s_coloc, zl = s_zl;
    const int* urow = (rsv ? a.units_rsv : a.units) + (size_t)g * O;
    const float* pe = price_t + (size_t)t * O;

    // ---- fill open capacity: per-slot fit under compat and relation bits ----
    for (int s = tid; s < NS; s += B) {
      bool comp;
      if (s >= E) {
        const int so = sopt[s];
        comp = so >= 0 && sact[s] && a.compat[(size_t)g * O + min(max(so, 0), O - 1)];
      } else {
        comp = a.exok_pad[(size_t)g * NS + s];
      }
      if (comp) {
        const int sb = sbits[s];
        const int zb = s_zone_bits[min(max(szone[s], 0), Z - 1)];
        comp = (sb & hf) == 0 && (sb & hn) == hn && (zb & zf) == 0 && (zb & zn) == zn;
      }
      sfit[s] = comp ? min(fit_units(rem + (size_t)s * R, s_dfit, R), cap) : 0;
    }
    __syncthreads();
    if (zl) {
      // zone quotas: a slot takes at most what its zone's quota leaves after
      // the slots before it in that zone
      for (int z = 0; z < Z; ++z) {
        int carry = 0;
        for (int base = 0; base < NS; base += B) {
          const int s = base + tid;
          const bool in = s < NS && szone[s] == z;
          const int f = in ? sfit[s] : 0;
          int tot;
          const int incl = block_scan(f, sh, &tot);
          if (in) sfit[s] = min(f, max(s_q[z] - (carry + incl - f), 0));
          carry += tot;
        }
      }
      for (int s = tid; s < NS; s += B)
        if (szone[s] < 0 || szone[s] >= Z) sfit[s] = 0;
      __syncthreads();
    }
    // greedy fill front to back; colocated groups take a slot only whole
    int placed_local = 0;
    {
      int carry = 0;
      for (int base = 0; base < NS; base += B) {
        const int s = base + tid;
        int f = 0;
        if (s < NS) {
          f = sfit[s];
          if (coloc) f = f >= cnt ? cnt : 0;
        }
        int tot;
        const int incl = block_scan(f, sh, &tot);
        if (s < NS) {
          const int p = min(max(cnt - (carry + incl - f), 0), f);
          splace[s] = p;
          placed_local += p;
          if (p != 0) {
            float* rs = rem + (size_t)s * R;
            for (int r = 0; r < R; ++r) rs[r] = __fmaf_rn(static_cast<float>(p), -s_d[r], rs[r]);
            const int z = szone[s];
            if (z >= 0 && z < Z) atomicAdd(&s_placed_z[z], p);
          }
        }
        carry += tot;
      }
    }
    const int placed = block_sum(placed_local, sh);

    // ---- bucket wants: zone buckets, then the unrestricted bucket ----
    if (tid == 0) {
      const int left = cnt - placed;
      int acc = 0;
      for (int z = 0; z < Z; ++z) {
        const int w = min(max(s_q[z] - s_placed_z[z], 0), left);
        s_want[z] = max(min(w, left - acc), 0);
        acc += w;
      }
      if (zl) {
        s_want[Z] = 0;
      } else {
        for (int z = 0; z < Z; ++z) s_want[z] = 0;
        s_want[Z] = left;
      }
      // hostname-need groups cannot open fresh nodes
      if (hn != 0)
        for (int b = 0; b < Zb; ++b) s_want[b] = 0;
      s_left = left;
    }
    __syncthreads();

    // ---- per-bucket option choice: lump vs mixed ----
    for (int b = 0; b < Zb; ++b) {
      const int want = s_want[b];
      if (want <= 0) {
        // no want: the bucket's segments are empty and never read
        if (tid == 0) {
          s_o_lump[b] = 0;
          s_c_lump[b] = kInf;
          s_o_rate[b] = 0;
          s_b_rate[b] = kInf;
          s_o_tail[b] = 0;
          s_b_tail[b] = kInf;
        }
        continue;
      }
      // lump: ceil(want / u) nodes of one option
      float m = kInf;
      for (int o = tid; o < O; o += B) {
        const int u = urow[o];
        if (u > 0 && (b == Z || a.opt_zone[o] == b))
          m = fminf(m, static_cast<float>(ceil_div(want, u)) * pe[o]);
      }
      const float best_l = block_min(m, sh);
      float v = neg_inf();
      int vi = kIntMax;
      for (int o = tid; o < O; o += B) {
        const int u = urow[o];
        const float sc = (u > 0 && (b == Z || a.opt_zone[o] == b))
                             ? static_cast<float>(ceil_div(want, u)) * pe[o]
                             : kInf;
        const float pref = alpha >= 1.0f ? static_cast<float>(u) : -static_cast<float>(u);
        arg_better(v, vi, sc <= best_l * kTieBand ? pref : -kInf, o);
      }
      const int o_lump = block_argmax(v, vi, sh);
      // mixed: full nodes of the rate-best option that fits in the want
      m = kInf;
      for (int o = tid; o < O; o += B) {
        const int u = urow[o];
        if (u > 0 && u <= want && (b == Z || a.opt_zone[o] == b))
          m = fminf(m, pe[o] / fmaxf(static_cast<float>(u), 1.0f));
      }
      const float best_r = block_min(m, sh);
      v = neg_inf();
      vi = kIntMax;
      for (int o = tid; o < O; o += B) {
        const int u = urow[o];
        const float sc = (u > 0 && u <= want && (b == Z || a.opt_zone[o] == b))
                             ? pe[o] / fmaxf(static_cast<float>(u), 1.0f)
                             : kInf;
        const float pref = alpha >= 1.0f ? static_cast<float>(u) : -static_cast<float>(u);
        arg_better(v, vi, sc <= best_r * kTieBand ? pref : -kInf, o);
      }
      const int o_rate = block_argmax(v, vi, sh);
      const int c_rate = urow[o_rate];
      const int rem_w = want - (want / max(c_rate, 1)) * c_rate;
      // ... plus one tail of the remainder
      int o_tail = 0;
      float best_t = kInf;
      if (rem_w > 0) {
        m = kInf;
        for (int o = tid; o < O; o += B) {
          const int u = urow[o];
          if (u > 0 && (b == Z || a.opt_zone[o] == b))
            m = fminf(m, static_cast<float>(ceil_div(rem_w, u)) * pe[o]);
        }
        best_t = block_min(m, sh);
        v = neg_inf();
        vi = kIntMax;
        for (int o = tid; o < O; o += B) {
          const int u = urow[o];
          const float sc = (u > 0 && (b == Z || a.opt_zone[o] == b))
                               ? static_cast<float>(ceil_div(rem_w, u)) * pe[o]
                               : kInf;
          const float pref = alpha >= 1.0f ? static_cast<float>(u) : -static_cast<float>(u);
          arg_better(v, vi, sc <= best_t * kTieBand ? pref : -kInf, o);
        }
        o_tail = block_argmax(v, vi, sh);
      }
      if (tid == 0) {
        s_o_lump[b] = o_lump;
        s_c_lump[b] = best_l;
        s_o_rate[b] = o_rate;
        s_b_rate[b] = best_r;
        s_o_tail[b] = o_tail;
        s_b_tail[b] = best_t;
      }
    }
    __syncthreads();

    // ---- segments: (full or lump) + tail per bucket ----
    if (tid == 0) {
      int seg_n[kMaxSeg];
      for (int b = 0; b < Zb; ++b) {
        const int want = s_want[b];
        const int o_rate = s_o_rate[b];
        const int c_rate = urow[o_rate];
        const int n_full = want / max(c_rate, 1);
        const int rem_w = want - n_full * c_rate;
        const float tail_cost = rem_w > 0 ? s_b_tail[b] : 0.0f;
        const float cost_mixed =
            s_b_rate[b] < kInf ? __fmaf_rn(static_cast<float>(n_full), pe[o_rate], tail_cost) : kInf;
        const float cost_lump = s_c_lump[b];
        const bool lump = cost_lump <= cost_mixed;
        const bool feasible = want > 0 && fminf(cost_lump, cost_mixed) < kInf;
        const int a_opt = lump ? s_o_lump[b] : o_rate;
        const int a_c = max(urow[a_opt], 1);
        const int a_want = feasible ? (lump ? want : n_full * c_rate) : 0;
        s_seg_opt[b] = a_opt;
        s_seg_c[b] = a_c;
        s_seg_want[b] = a_want;
        seg_n[b] = ceil_div(a_want, a_c);
        const int t_opt = s_o_tail[b];
        const int t_c = max(urow[t_opt], 1);
        const int t_want = (feasible && !lump) ? rem_w : 0;
        s_seg_opt[Zb + b] = t_opt;
        s_seg_c[Zb + b] = t_c;
        s_seg_want[Zb + b] = t_want;
        seg_n[Zb + b] = ceil_div(t_want, t_c);
      }
      int acc = 0;
      for (int j = 0; j < nseg; ++j) {
        s_seg_start[j] = acc;
        acc += seg_n[j];
      }
      s_total_open = acc;
    }
    __syncthreads();

    // ---- allocate free slots to segments, in rank order ----
    const int total_open = s_total_open;
    int opened_local = 0;
    int n_free = 0;
    for (int base = 0; base < NS; base += B) {
      const int s = base + tid;
      const int is_free = (s < NS && s >= E && !sact[s]) ? 1 : 0;
      int tot;
      const int fr = n_free + block_scan(is_free, sh, &tot);  // 1-based rank
      n_free += tot;
      if (s < NS) {
        int fill = 0;
        if (is_free && fr <= total_open) {
          const int r0 = fr - 1;
          int sid = -1;  // segment starts <= rank, minus one: skips empty segments
          for (int j = 0; j < nseg; ++j) sid += r0 >= s_seg_start[j] ? 1 : 0;
          sid = min(max(sid, 0), nseg - 1);
          const int o_i = s_seg_opt[sid], c_i = s_seg_c[sid];
          fill = min(max(s_seg_want[sid] - (r0 - s_seg_start[sid]) * c_i, 0), c_i);
          const float* c = a.alloc + (size_t)o_i * R;
          float* rs = rem + (size_t)s * R;
          for (int r = 0; r < R; ++r) rs[r] = __fmaf_rn(static_cast<float>(fill), -s_d[r], c[r]);
          sopt[s] = o_i;
          szone[s] = a.opt_zone[o_i];
          sact[s] = 1;
        }
        opened_local += fill;
        const int y = splace[s] + fill;
        yrow[s] = y;
        if (y > 0) {
          // publish the group's presence bits on its slots and zones
          sbits[s] |= s_sm;
          const int z = szone[s];
          if (z >= 0 && z < Z) s_zhit[z] = 1;
        }
      }
    }
    const int opened = block_sum(opened_local, sh);
    if (tid == 0) {
      const int left = s_left - opened;
      s_unplaced += left;
      // exhaustion compares against the free count before this step's take
      if (left > 0 && total_open > n_free) s_exhausted = 1;
      for (int z = 0; z < Z; ++z)
        if (s_zhit[z]) s_zone_bits[z] |= s_sm;
    }
    __syncthreads();
  }

  // ---- member result ----
  float csum = 0.0f;
  for (int s = E + tid; s < NS; s += B) {
    const int so = sopt[s];
    const bool act = sact[s] && so >= 0;
    a.new_opt[(size_t)k * a.S + (s - E)] = so;
    a.new_active[(size_t)k * a.S + (s - E)] = act;
    if (act) csum += a.price[min(max(so, 0), O - 1)];
  }
  const float total = block_sum_f(csum, sh);
  if (tid == 0) {
    a.cost[k] = __fmaf_rn(static_cast<float>(s_unplaced), kPenalty, total);
    a.unplaced[k] = s_unplaced;
    a.exhausted[k] = s_exhausted != 0;
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

// K3 replaces the tail of _pack_solve_fused_impl (jax_solver.py:585-604): the
// argmin over both phases' 2K costs (first index wins) and the result buffer
// in that function's layout, costs as f32 bits. One block per batch row.
// Bound: the copy of
// the winner's ys (T*(E+S) int32, 262 KB at 50k_full), a fraction of a
// microsecond of bandwidth; one block's copy rate and the launch dominate.
__global__ void __launch_bounds__(kK3Threads) k3_pack_epilogue(K3Args p) {
  __shared__ int s_phase, s_b1, s_bk;
  const K3Args a = k3_row(p, blockIdx.x);
  const int K = a.K;
  if (threadIdx.x == 0) {
    int best = 0, b1 = 0;
    float bc = a.c1[0], b1c = a.c1[0];
    for (int j = 1; j < K; ++j)
      if (a.c1[j] < b1c) {
        b1c = a.c1[j];
        b1 = j;
      }
    for (int j = 1; j < 2 * K; ++j) {
      const float c = j < K ? a.c1[j] : a.c2[j - K];
      if (c < bc) {
        bc = c;
        best = j;
      }
    }
    s_phase = best >= K ? 1 : 0;
    s_b1 = b1;
    s_bk = best >= K ? best - K : best;
  }
  __syncthreads();
  const bool p2 = s_phase != 0;
  const int bk = s_bk;
  const int* no = p2 ? a.no2 : a.no1;
  const bool* na = p2 ? a.na2 : a.na1;
  const int* ys = p2 ? a.ys2 : a.ys1;
  int* buf = a.buf;
  if (threadIdx.x == 0) {
    buf[0] = s_phase;
    buf[1] = s_b1;
    buf[2] = bk;
    buf[3] = (p2 ? a.u2 : a.u1)[bk];
  }
  for (int j = threadIdx.x; j < 2 * K; j += blockDim.x) {
    buf[4 + j] = __float_as_int(j < K ? a.c1[j] : a.c2[j - K]);
    buf[4 + 2 * K + j] = (j < K ? a.ex1[j] : a.ex2[j - K]) ? 1 : 0;
  }
  const size_t off = 4 + 4 * (size_t)K;
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) {
    buf[off + s] = no[(size_t)bk * a.S + s];
    buf[off + a.S + s] = na[(size_t)bk * a.S + s] ? 1 : 0;
  }
  const size_t n = (size_t)a.T * a.NS;
  const int* src = ys + (size_t)bk * n;
  int* dst = buf + off + 2 * (size_t)a.S;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
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

int kts_shared_precompute(
    const float* demand, const float* demand_units, const int* count, const int* node_cap,
    const int* quota, const bool* colocate, const bool* compat, const float* alloc,
    const float* price, const bool* opt_valid, const bool* ex_compat, const bool* ex_valid,
    int* units, int* units_rsv, bool* rsv_group, float* lam, bool* zone_limited,
    float* val_pair, bool* exok_pad, int B, int G, int O, int E, int R, int Z, int S,
    void* stream) {
  K1Args a{demand, demand_units, count, node_cap, quota, colocate, compat, alloc, price,
           opt_valid, ex_compat, ex_valid, units, units_rsv, rsv_group, lam, zone_limited,
           val_pair, exok_pad, G, O, E, R, Z, S};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k1_units<<<dim3(G, 1, B), kK1Threads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t row = (size_t)O * G;
  dim3 grid(static_cast<unsigned>((row + kK1Threads - 1) / kK1Threads), static_cast<unsigned>(G),
            static_cast<unsigned>(B));
  k1_val_pair<<<grid, kK1Threads, 0, st>>>(a);
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
    int* new_opt, bool* new_active, int* ys, int* order_s, int* pos_s, float* price_t,
    float* slot_rem, int* slot_i, int B, int K, int G, int O, int E, int R, int Z, int S,
    void* stream) {
  K2Args a{demand, demand_units, count, node_cap, colocate, compat, alloc, price, opt_zone,
           ex_rem, ex_zone, ex_valid, rel_set, rel_host_forbid, rel_host_need,
           rel_zone_forbid, rel_zone_need, rel_slot_bits, rel_zone_bits, units, units_rsv,
           rsv_group, quota, zone_limited, val_pair, exok_pad, orders, alphas, looks, rsvs,
           swaps, seed_costs, cost, unplaced, exhausted, new_opt, new_active, ys, order_s,
           pos_s, price_t, slot_rem, slot_i, K, G, O, E, R, Z, S};
  k2_pack_member<<<dim3(K, B), kK2Threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int kts_pack_epilogue(
    const float* c1, const int* u1, const bool* ex1, const int* no1, const bool* na1,
    const int* ys1, const float* c2, const int* u2, const bool* ex2, const int* no2,
    const bool* na2, const int* ys2, int* buf, int B, int K, int T, int NS, int S,
    void* stream) {
  K3Args a{c1, u1, ex1, no1, na1, ys1, c2, u2, ex2, no2, na2, ys2, buf, K, T, NS, S};
  k3_pack_epilogue<<<B, kK3Threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
