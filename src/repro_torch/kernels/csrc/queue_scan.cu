// The work ledger for Hopper (sm_90a): a bounded, deadline-aged deferral
// queue served hour by hour. Four kernels.
//
// They replace no Pallas kernel. The reference runs the ledger as a
// lax.scan (repro/kernels/queue_scan.py:94 queue_scan, :170
// workload_fleet_scan) that XLA compiles into one loop on the device; a
// Python loop of PyTorch operations would be ~70 launches an hour here
// (~10 us each on this card's host). So the hour loop runs inside the
// kernels, and the Python hour loops (repro_torch.kernels.ref) are their
// plain versions.
//
// One hour of the ledger (ref.queue_hour_step), with the queue kept
// oldest first, o[0] one hour from expiry and o[d-1] arrived last hour:
// the waiting work w = [o[0], ..., o[d-1], a] is served oldest first,
// serve_i = clip(cap - (sum of w before i), 0, w_i), the oldest unserved
// bucket drops (deadline expiry), and the survivors u_1..u_d age one hour
// and re-queue while the bound has room, keep_j = clip(bound - (sum of
// survivors before j), 0, u_{j+1}); the rest drops. The soft form
// replaces each clip by smoothclip, tau (softplus(z / tau) - softplus((z -
// w) / tau)).
//
//   workload_ledger_kernel (hard, "workload_ledger_fwd"): one thread a
//     (row, draw) lane, whole rows in a block (G draws a row, 32 / G rows
//     a block, or one row of G <= 1024 threads), the hours in windows of
//     W (16; 4 in blocks above 256 threads). A window's prices (the row's,
//     read through market_idx) and demand sit in registers, loaded while
//     the window before ran (and prefetched into L2 four windows ahead):
//     at a window's start the next window's loads are issued, then the
//     window's W shutdown states are computed from
//     its prices and the carried state alone (off if p > p_off, else on
//     if p <= p_on, else carried; starting on: the comparisons of
//     ref.hard_hour_step), so neither loads nor states wait on the queue.
//     Each hour serves the draw's arrivals dt * demand[g, t] with the
//     hour's realised capacity cap_mwh * (lvl + (1 - lvl) on) in closed
//     form (hard_hour): the queue is kept as its inclusive prefix sums
//     and every bucket's new sum is 3 operations from the old ones, all
//     buckets at once; it adds served, dropped, backlog and served * p
//     into float32 sums hour by hour, the reference's order. With
//     telemetry each hour's arrivals, served, dropped and backlog go into
//     a shared-memory ring of W hours (two rings, alternate windows); at
//     a window's end one barrier (__syncwarp in a one-warp block), then
//     the block's lanes share out the window's 4 x rows x W sums over the
//     draws, each in draw order (in a full warp of a power-of-2 G, a lane
//     sums a (row, hour)'s four quantities from one float4 load a draw),
//     each (quantity, row) stored as a run of hours: no barrier inside a
//     window. The prefix sums live in registers for d <= 8 (a kernel for
//     each d) and device memory above (loaded kMaxRegD at a time).
//
// The soft pair runs [B, T] demand and capacity (MWh), hard or smoothclip
// at tau (a device scalar), float32 or float64, with a row's d + 1 slots
// (oldest first, the arrivals last) on a segment of S lanes of one warp,
// K consecutive slots a lane (seg_plan: S the power of 2 >= d + 1 and
// K = 1 up to d = 31, a whole warp and K = 2, 4 or 8 slots a lane in
// registers up to d = 255, and above that K slots a lane in a device
// scratch). Every slot's clip of an hour runs at once: the sum of the
// work before a slot is a segmented inclusive scan (__shfl_up_sync,
// log2 S steps, Hillis-Steele) over the lanes' running sums, minus the
// slot's own value.
//
//   soft_ledger_fwd_kernel: a segment a row. Each hour: the arrivals
//     enter slot d; the serve scan, every slot's serve clip; the survivors
//     u = w - serve (slot 0's drops); their scan, every keep clip; the
//     queue ages one slot down (__shfl_down_sync). Demand, capacity and
//     prices are loaded a window of W hours ahead, off the chain. Each
//     lane adds its slots' served, dropped, backlog and served cost into
//     its own sums, reduced over the segment (__shfl_xor_sync, a fixed
//     tree) once at the end, or every hour for the [3, B, T] hourly
//     series when they are asked for. Writes the four sums, the queue
//     entering every hour ([T, B, d], youngest first: the plain version's
//     layout, the backward's residual) and the final queue.
//   soft_ledger_coef_kernel + soft_ledger_chain_kernel (the backward):
//     the coefficient kernel, a segment a (row, hour), recomputes each
//     hour's forward from the saved queue and writes its smoothclip
//     derivatives (dz1, dw1 of the serve clip at every slot, dz2, dw2 of
//     the keep clip at slots 1..d) into a [hours, B, d + 1, 4] scratch,
//     all hours in parallel; the chain kernel, a segment a row, runs
//     reverse time through the linear adjoint only (ref.soft_ledger_bwd_ref
//     has the formulas: the two reverse exclusive sums are segmented
//     suffix scans, __shfl_down_sync), its coefficients loaded hours
//     ahead, and writes d cap [B, T] and d demand [B, T]. The scratch
//     holds at most kCoefBytes: longer runs take windows of hours, latest
//     first, the queue's adjoint carried between them in [B, d].
//
// Float32 exp / log1p of the smoothclips and their sigmoids are CUDA's
// float32 functions (expf / log1pf, not the fast intrinsics); float64's
// are exp / log1p. The file is compiled with -fmad=false
// (build.SOURCE_FLAGS), so every float operation rounds once, as the
// plain versions' and the mirrors (ref.workload_ledger_seg_ref,
// ref.soft_ledger_fwd_seg_ref / soft_ledger_bwd_seg_ref: the closed form,
// scans, trees and sums in the kernels' order) do. The hard ledger agrees
// with its plain version bit for bit on integer-valued work, the soft pair
// to rounding.
//
// Bound on an H100 SXM: the serial chain of T hours (each hour waits on
// the last one's queue). The hard kernel's hour is 3 dependent float32
// operations deep and ~14 + 3 d issue slots a lane (one warp an SM at the
// benchmark's 2048 lanes). The soft forward's hour is two smoothclips and
// two scans of log2 S shuffles deep; the backward's reverse chain is
// linear (no transcendental), four scans and a shuffle deep. Bytes (the
// [B, T] inputs read once, the outputs written once) at 3.35 TB/s are
// far below the chain at the shapes the ledger runs.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>
#include <utility>

namespace {

// Kernels this library has launched in this process, counted on the host
// where each launch is issued; kernels_launched() reads it.
std::atomic<unsigned long long> g_launched{0};

constexpr int kMaxRegD = 8;       // d above this keeps the queue in memory
constexpr int kMaxDraws = 1024;   // one row's draws fit one block
constexpr int kSegThreads = 32;   // a block of the row kernels: one warp
constexpr int kCoefThreads = 128; // a block of the coefficient kernel
constexpr int kLaneSlots = 8;     // slots a lane keeps in registers
constexpr long long kCoefBytes = 128LL << 20;  // the backward's scratch
constexpr unsigned kFull = 0xffffffffu;

// A per-lane array of n values: registers when n is a compile-time
// constant (N > 0), device memory otherwise (element i at base[i * stride]).
template <typename T, int N>
struct Arr {
  T v[N > 0 ? N : 1];
  __device__ __forceinline__ T& operator[](int i) { return v[i]; }
};

template <typename T>
struct Mem {
  T* base;
  long long stride;
  __device__ __forceinline__ T& operator[](int i) {
    return base[(long long)i * stride];
  }
};

template <typename T>
__device__ __forceinline__ T exp_t(T x);
template <>
__device__ __forceinline__ float exp_t(float x) {
  return expf(x);
}
template <>
__device__ __forceinline__ double exp_t(double x) {
  return exp(x);
}

template <typename T>
__device__ __forceinline__ T log1p_t(T x);
template <>
__device__ __forceinline__ float log1p_t(float x) {
  return log1pf(x);
}
template <>
__device__ __forceinline__ double log1p_t(double x) {
  return log1p(x);
}

// softplus(x) = max(x, 0) + log1p(exp(-|x|)), jax.nn.softplus's value
template <typename T>
__device__ __forceinline__ T softplus(T x) {
  const T z = T(0);
  return (x > z ? x : z) + log1p_t(exp_t(-(x < z ? -x : x)));
}

template <typename T>
__device__ __forceinline__ T sigmoid(T x) {
  return T(1) / (T(1) + exp_t(-x));
}

// clip(z, 0, w), or its smoothclip relaxation at tau
template <bool HARD, typename T>
__device__ __forceinline__ T clip(T z, T w, T tau) {
  if (HARD) {
    const T lo = z > T(0) ? z : T(0);
    return lo < w ? lo : w;
  }
  return tau * (softplus(z / tau) - softplus((z - w) / tau));
}

// One hour of the hard ledger in closed form, on the queue's inclusive
// prefix sums P[j] = o[0] + ... + o[j] (oldest first; j < d), in place.
// The waiting work's inclusive sums are C_j = P[j] (j < d) and C_d = P[d-1]
// + a. Served oldest first, the unserved work of buckets 0..j sums to
// max(C_j, cap) - cap, so the survivors' running sum is A_j = max(C_j,
// cap) - max(C_0, cap) and the kept prefix is min(bound, A_j): the new
// queue's prefix sums, P'[j-1] for j = 1..d. served = min(cap, C_d),
// backlog = P'[d-1], dropped = (C_d - served) - backlog. cap and bnd come
// in floored at 0; A_j >= 0 needs no floor, since C is nondecreasing in j
// (work is >= 0) and max and rounding are monotone. Every j is independent
// of the others: the hour is 3 operations deep, not a pass over the
// buckets.
template <int D, class Q>
__device__ __forceinline__ void hard_hour(Q& P, int d, float a, float cap,
                                          float bnd, float& served,
                                          float& dropped, float& backlog) {
  if (D >= 0) d = D;
  const float cd = d > 0 ? P[d - 1] + a : a;
  const float y0 = fmaxf(d > 0 ? P[0] : cd, cap);
  float bl = 0.f;
  if constexpr (D >= 0) {
#pragma unroll
    for (int j = 1; j <= D; ++j) {
      const float c = j < D ? P[j] : cd;
      bl = fminf(bnd, fmaxf(c, cap) - y0);
      P[j - 1] = bl;
    }
  } else {
    // the queue in device memory: a chunk of loads at a time, then the
    // chunk's stores
    for (int j0 = 1; j0 <= d; j0 += kMaxRegD) {
      float c[kMaxRegD];
#pragma unroll
      for (int i = 0; i < kMaxRegD; ++i) {
        const int j = j0 + i;
        c[i] = j < d ? P[j] : cd;
      }
#pragma unroll
      for (int i = 0; i < kMaxRegD; ++i) {
        const int j = j0 + i;
        if (j <= d) {
          bl = fminf(bnd, fmaxf(c[i], cap) - y0);
          P[j - 1] = bl;
        }
      }
    }
  }
  served = fminf(cap, cd);
  backlog = bl;
  dropped = (cd - served) - bl;
}

template <int D>
using HardQueue = typename std::conditional<(D >= 0), Arr<float, D>,
                                            Mem<float>>::type;

// An L2 prefetch of the line holding p (an address inside the data).
__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Hours a window of the hard kernel: kWin in a block of at most
// kWinThreads (no register cap below 255), kWinBig in larger blocks (one
// row of > 256 draws: 64 registers a thread at 1024).
constexpr int kWin = 16;
constexpr int kWinBig = 4;
constexpr int kWinThreads = 256;
constexpr int kPrefetchWindows = 4;  // L2 prefetch distance, in windows

// Floats a lane takes in a telemetry ring of W hours: W float4 slots
// (arrivals, served, dropped, backlog), padded to an odd count of slots so
// that the lanes' float4 stores and the sums' reads miss no bank.
__host__ __device__ constexpr int ring_floats(int W) { return 4 * (W | 1); }

// One of a window's telemetry sums, k (< 4 W rows a block; hour fastest,
// then the quantity, then the row), from the ring rb: over the draws in
// draw order from 0. A sum of a row past B, or of an hour past the n the
// window holds, is not stored.
template <int W>
__device__ __forceinline__ void ring_sum(const float* rb, int k, int G,
                                         int rows_per_block, int B, int T,
                                         int t0, int n,
                                         float* __restrict__ hourly) {
  constexpr int LS = ring_floats(W);
  const int h = k % W, qq = (k / W) & 3, rr = k / (4 * W);
  const int orow = blockIdx.x * rows_per_block + rr;
  if (h >= n || orow >= B) return;
  const float* x = rb + rr * G * LS + 4 * h + qq;
  float acc = 0.f;
  for (int j = 0; j < G; ++j) acc = acc + x[j * LS];
  hourly[((long long)qq * B + orow) * T + t0 + h] = acc;
}

// The same sums in a block of one full warp with G = GC draws a row, GC a
// power of 2 (32 / GC whole rows, kWin-hour windows): lane l takes the
// (row, hour) pairs (l / 16 + 2 i, l % 16), i < 16 / GC (at GC 32 the
// lanes l < 16 one pair), and sums the hour's four quantities at once, one
// float4 load a draw from an immediate offset off one base; the pairs'
// chains of GC adds interleave. GUARD: the block's last rows or the
// window's last hours may be missing (a branch a sum); otherwise every sum
// is stored.
template <int GC, bool GUARD>
__device__ __forceinline__ void ring_sums_warp(const float* rb, int lane,
                                               int rows_per_block, int B,
                                               int T, int t0, int n,
                                               float* __restrict__ hourly) {
  constexpr int LS = ring_floats(kWin), NP = GC < 16 ? 16 / GC : 1;
  const int h = lane % kWin, r0 = lane / kWin;
  if (GC == 32 && r0 > 0) return;
  const float* x = rb + r0 * GC * LS + 4 * h;
  const long long row0 = (long long)blockIdx.x * rows_per_block + r0;
  const long long BT = (long long)B * T;
  float* y = hourly + row0 * T + t0 + h;
  float4 acc[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(x + (2 * i * GC + j) * LS);
      acc[i].x = acc[i].x + v.x;
      acc[i].y = acc[i].y + v.y;
      acc[i].z = acc[i].z + v.z;
      acc[i].w = acc[i].w + v.w;
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (GUARD && (h >= n || row0 + 2 * i >= B)) continue;
    float* yi = y + 2 * i * (long long)T;
    yi[0] = acc[i].x;
    yi[BT] = acc[i].y;
    yi[2 * BT] = acc[i].z;
    yi[3 * BT] = acc[i].w;
  }
}

template <int D, bool TELEM, int W>
__global__ void __launch_bounds__(W == kWin ? kWinThreads : kMaxDraws)
    workload_ledger_kernel(const float* __restrict__ prices,
                           const long long* __restrict__ market_idx,
                           const float* __restrict__ p_on,
                           const float* __restrict__ p_off,
                           const float* __restrict__ off_level,
                           const float* __restrict__ cap_mwh,
                           const float* __restrict__ dt,
                           const float* __restrict__ demand, float bound,
                           int B, int N, int G, int T, int d,
                           int rows_per_block, float* __restrict__ out,
                           float* __restrict__ hourly,
                           float* __restrict__ scratch) {
  // with telemetry: two rings of W hours, [2][blockDim.x][ring_floats(W)]
  extern __shared__ float4 ring4[];
  constexpr int LS = ring_floats(W);
  const int lane = threadIdx.x, nt = blockDim.x;
  const int r_local = lane / G, g = lane - r_local * G;
  const int row = blockIdx.x * rows_per_block + r_local;
  const bool active = r_local < rows_per_block && row < B;
  // a lane past the last row reads row 0's inputs, meets every barrier and
  // writes nothing (in the memory form it skips the hours: the scratch
  // holds no queue of its own)
  const int rw = active ? row : 0;
  const bool runs = D >= 0 || active;
  long long src = rw;
  if (market_idx != nullptr) {
    src = market_idx[rw];
    if (src < 0 || src >= N) __trap();
  }
  const float* prow = prices + src * (long long)T;
  const float* drow = demand + (long long)g * T;
  const float lo = p_on[rw], hi = p_off[rw], lvl = off_level[rw];
  const float cmwh = cap_mwh[rw], dtb = dt[rw];
  // the hour's realised capacity cap_mwh (lvl + (1 - lvl) on) for on = 1
  // and 0 (ref.hard_hour_step's operations), floored at 0 as the clip's
  // room is; the bound too
  const float cap_on = fmaxf(cmwh * (lvl + (1.f - lvl)), 0.f);
  const float cap_off = fmaxf(cmwh * lvl, 0.f);
  const float bnd = fmaxf(bound, 0.f);
  const long long lanes = (long long)B * G, me = (long long)rw * G + g;
  HardQueue<D> P;
  if constexpr (D < 0) {
    P.base = scratch + me;
    P.stride = lanes;
  }
  if (runs)
    for (int i = 0; i < (D >= 0 ? D : d); ++i) P[i] = 0.f;
  const unsigned wmask = nt >= 32 ? kFull : (1u << nt) - 1u;
  float* ring = reinterpret_cast<float*>(ring4);
  int buf = 0;

  // the shutdown state, carried as the hour's capacity (on: cap_on)
  float cap = cap_on, s_acc = 0.f, d_acc = 0.f, b_acc = 0.f, c_acc = 0.f;
  // the next window's prices and demand, loaded a window ahead
  float pn[W], dn[W];
#pragma unroll
  for (int h = 0; h < W; ++h) {
    pn[h] = h < T ? prow[h] : 0.f;
    dn[h] = h < T ? drow[h] : 0.f;
  }
  // Window [t0, t0 + n): its loads were issued a window ago; the next
  // window's are issued first, then the window's shutdown states (its
  // prices and the carried state only), then its hours, each only the
  // queue's chain. With telemetry each hour's four values go to the ring,
  // summed over the draws once at the window's end.
  auto window = [&](auto full, int t0, int n) {
    constexpr bool FULL = decltype(full)::value;
    float pc[W], dc[W], cw[W];
#pragma unroll
    for (int h = 0; h < W; ++h) {
      pc[h] = pn[h];
      dc[h] = dn[h];
    }
    const int t1 = t0 + W, tp = t0 + kPrefetchWindows * W;
#pragma unroll
    for (int h = 0; h < W; ++h) {
      const int t = t1 + h;
      pn[h] = t < T ? prow[t] : 0.f;
      dn[h] = t < T ? drow[t] : 0.f;
    }
    if (tp < T) {
      prefetch_l2(prow + tp);
      prefetch_l2(drow + tp);
    }
#pragma unroll
    for (int h = 0; h < W; ++h) {
      // a decisive hour (p > p_off: off, tested first; p <= p_on: on) sets
      // the state, any other carries it: one select an hour on the chain
      const bool off = pc[h] > hi, decisive = off || pc[h] <= lo;
      cap = decisive ? (off ? cap_off : cap_on) : cap;
      cw[h] = cap;
    }
    float* mine = ring + ((long long)buf * nt + lane) * LS;
#pragma unroll
    for (int h = 0; h < W; ++h) {
      if ((FULL || h < n) && runs) {
        const float a = dtb * dc[h];
        float served, dropped, bl;
        hard_hour<D>(P, d, a, cw[h], bnd, served, dropped, bl);
        s_acc = s_acc + served;
        d_acc = d_acc + dropped;
        b_acc = b_acc + bl;
        c_acc = c_acc + served * pc[h];
        if (TELEM)
          *reinterpret_cast<float4*>(mine + 4 * h) =
              make_float4(a, served, dropped, bl);
      }
    }
    if (TELEM) {
      if (nt <= 32)
        __syncwarp(wmask);
      else
        __syncthreads();
      // 4 x rows_per_block x W sums, hour fastest, each (quantity, row)
      // stored as a run of hours
      const float* rb = ring + (long long)buf * nt * LS;
      const int total = 4 * W * rows_per_block;
      // the one-warp form for a power-of-2 G (32 / G rows), else a sum at a
      // time
      const bool guard = !FULL || (blockIdx.x + 1) * rows_per_block > B;
      auto warp_sums = [&](auto gc) {
        constexpr int GC = decltype(gc)::value;
        if (guard)
          ring_sums_warp<GC, true>(rb, lane, rows_per_block, B, T, t0, n,
                                   hourly);
        else
          ring_sums_warp<GC, false>(rb, lane, rows_per_block, B, T, t0, n,
                                    hourly);
      };
      using std::integral_constant;
      switch (W == kWin && nt == 32 ? G : 0) {
        case 1: warp_sums(integral_constant<int, 1>{}); break;
        case 2: warp_sums(integral_constant<int, 2>{}); break;
        case 4: warp_sums(integral_constant<int, 4>{}); break;
        case 8: warp_sums(integral_constant<int, 8>{}); break;
        case 16: warp_sums(integral_constant<int, 16>{}); break;
        case 32: warp_sums(integral_constant<int, 32>{}); break;
        default:
          for (int k = lane; k < 4 * W * rows_per_block; k += nt)
            ring_sum<W>(rb, k, G, rows_per_block, B, T, t0, n, hourly);
      }
      buf ^= 1;
    }
  };
  const int full_end = T - T % W;
  for (int t0 = 0; t0 < full_end; t0 += W)
    window(std::true_type{}, t0, W);
  if (full_end < T) window(std::false_type{}, full_end, T - full_end);
  if (active) {
    out[me] = s_acc;
    out[lanes + me] = d_acc;
    out[2 * lanes + me] = b_acc;
    out[3 * lanes + me] = c_acc;
  }
}

// ---------------------------------------------------------------------------
// the soft pair: a row's slots on the lanes of a segment
// ---------------------------------------------------------------------------

// The slots of deadline d on a segment: S lanes (a power of 2, <= 32), K
// consecutive slots a lane (lane l holds slots l K .. l K + K - 1), Kt the
// kernels' template K (-1: the slots in a device scratch).
struct SegPlan {
  int S, K, Kt;
};

SegPlan seg_plan(int d) {
  const int n = d + 1;
  SegPlan p{1, 1, 1};
  if (n <= 32) {
    while (p.S < n) p.S <<= 1;
    return p;
  }
  p.S = 32;
  p.K = (n + 31) / 32;
  int k = 1;
  while (k < p.K) k <<= 1;
  if (k <= kLaneSlots) p.K = k;
  p.Kt = k <= kLaneSlots ? k : -1;
  return p;
}

// a lane's K slots: registers (K > 0) or the scratch (K = -1)
template <typename T, int K>
using Slots = typename std::conditional<(K > 0), Arr<T, K>, Mem<T>>::type;

// Inclusive sum over the lanes at and below this one in the segment.
template <typename T>
__device__ __forceinline__ T seg_scan(T v, int lane, int S) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off >= S) break;
    const T o = __shfl_up_sync(kFull, v, off, S);
    if (lane >= off) v = v + o;
  }
  return v;
}

// Inclusive sum over the lanes at and above this one in the segment.
template <typename T>
__device__ __forceinline__ T seg_rscan(T v, int lane, int S) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off >= S) break;
    const T o = __shfl_down_sync(kFull, v, off, S);
    if (lane + off < S) v = v + o;
  }
  return v;
}

// The segment's sum on every lane: a butterfly, the halves' sums first.
template <typename T>
__device__ __forceinline__ T seg_sum(T v, int S) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    if (off < S) v = v + __shfl_xor_sync(kFull, v, off, S);
  return v;
}

// The sum of the slots before each of this lane's: loc[k] holds the
// lane's running sum up to slot k (its own included), x[k] the slot's
// value. Returns through loc: the exclusive sum over the segment, as the
// inclusive one minus x (the plain version's cumsum - w).
template <typename T, int K, class A>
__device__ __forceinline__ void seg_excl(A& loc, A& x, int kn, int lane,
                                         int S) {
  const T incl = seg_scan(loc[kn - 1], lane, S);
  if (K == 1) {
    loc[0] = incl - x[0];
    return;
  }
  T pre = __shfl_up_sync(kFull, incl, 1, S);
  if (lane == 0) pre = T(0);
#pragma unroll
  for (int k = 0; k < kn; ++k) loc[k] = (pre + loc[k]) - x[k];
}

// The same from above: loc[k] holds the lane's running sum from its last
// slot down to slot k, incl the lane total's seg_rscan and post that of
// the lane above (0 at the top); returns the sum over slot k and the
// slots after it.
template <typename T, int K, class A>
__device__ __forceinline__ T seg_rincl(A& loc, int k, T incl, T post) {
  return K == 1 ? incl : post + loc[k];
}

template <typename T, int K, bool HARD>
__global__ void __launch_bounds__(kSegThreads) soft_ledger_fwd_kernel(
    const T* __restrict__ demand, const T* __restrict__ cap,
    const T* __restrict__ prices, const T* __restrict__ tau_p, T bound, int B,
    int T_, int d, int S, int Kn, T* __restrict__ sums, T* __restrict__ hist,
    T* __restrict__ q_final, T* __restrict__ hourly, T* __restrict__ scratch) {
  // hours of inputs loaded ahead: 8 float32 or 4 float64 slot-hours a
  // lane (each hour's clips are unrolled over the window)
  constexpr int kV = sizeof(T) == 4 ? 8 : 4;
  constexpr int W = K < 2 ? kV : (kV / K > 0 ? kV / K : 1);
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gt / S, lane = gt % S;       // S divides 32
  const bool active = row < B;
  const long long base = (long long)(active ? row : B - 1) * T_;
  const int kn = K > 0 ? K : Kn;
  const int m0 = lane * kn;                    // this lane's first slot
  const T tau = HARD ? T(0) : tau_p[0];
  Slots<T, K> w, c;
  if constexpr (K < 0) {
    const long long n = (long long)gridDim.x * blockDim.x;
    w.base = scratch + gt;
    w.stride = n;
    c.base = scratch + (long long)kn * n + gt;
    c.stride = n;
  }
#pragma unroll
  for (int k = 0; k < kn; ++k) w[k] = T(0);
  T acc_s = T(0), acc_d = T(0), acc_b = T(0), acc_c = T(0);
  T na[W], nc[W], np[W];   // the next window's arrivals, capacity, prices
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const long long i = base + (t0 + j < T_ ? t0 + j : T_ - 1);
      na[j] = demand[i];
      nc[j] = cap[i];
      np[j] = prices != nullptr ? prices[i] : T(0);
    }
  };
  load(0);
  for (int t0 = 0; t0 < T_; t0 += W) {
    T ia[W], ic[W], ip[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      ia[j] = na[j];
      ic[j] = nc[j];
      ip[j] = np[j];
    }
    load(t0 + W);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int t = t0 + j;
      if (t >= T_) break;
      if (hist != nullptr && active) {
#pragma unroll
        for (int k = 0; k < kn; ++k)
          if (m0 + k < d)
            hist[((long long)t * B + row) * d + (d - 1 - m0 - k)] = w[k];
      }
      // serve: every slot's clip of the room the older work leaves
#pragma unroll
      for (int k = 0; k < kn; ++k) {
        if (m0 + k == d) w[k] = ia[j];
        c[k] = k == 0 ? w[k] : c[k - 1] + w[k];
      }
      seg_excl<T, K>(c, w, kn, lane, S);
      T srv = T(0), drp = T(0), bkl = T(0);
#pragma unroll
      for (int k = 0; k < kn; ++k) {
        const T s = clip<HARD>(ic[j] - c[k], w[k], tau);
        const T u = w[k] - s;
        acc_s = acc_s + s;
        acc_c = acc_c + s * ip[j];
        srv = srv + s;
        if (m0 + k == 0) {   // the oldest bucket's rest expires
          acc_d = acc_d + u;
          drp = drp + u;
        }
        w[k] = m0 + k == 0 ? T(0) : u;   // the survivors
      }
      // re-queue: every survivor's clip of the room the older ones leave
#pragma unroll
      for (int k = 0; k < kn; ++k) c[k] = k == 0 ? w[k] : c[k - 1] + w[k];
      seg_excl<T, K>(c, w, kn, lane, S);
#pragma unroll
      for (int k = 0; k < kn; ++k) {
        const T keep = clip<HARD>(bound - c[k], w[k], tau);
        acc_d = acc_d + (w[k] - keep);
        acc_b = acc_b + keep;
        drp = drp + (w[k] - keep);
        bkl = bkl + keep;
        c[k] = keep;
      }
      // age: slot m takes slot m + 1's keep; slot d waits for the arrivals
      const T up = __shfl_down_sync(kFull, c[0], 1, S);
#pragma unroll
      for (int k = 0; k < kn; ++k)
        w[k] = m0 + k < d ? (k + 1 < kn ? c[k + 1] : up) : T(0);
      if (hourly != nullptr) {
        srv = seg_sum(srv, S);
        drp = seg_sum(drp, S);
        bkl = seg_sum(bkl, S);
        if (active && lane == 0) {
          hourly[base + t] = srv;
          hourly[(long long)B * T_ + base + t] = drp;
          hourly[2LL * B * T_ + base + t] = bkl;
        }
      }
    }
  }
  acc_s = seg_sum(acc_s, S);
  acc_d = seg_sum(acc_d, S);
  acc_b = seg_sum(acc_b, S);
  acc_c = seg_sum(acc_c, S);
  if (!active) return;
  if (lane == 0) {
    sums[row] = acc_s;
    sums[B + row] = acc_d;
    sums[2 * B + row] = acc_b;
    sums[3 * B + row] = acc_c;
  }
#pragma unroll
  for (int k = 0; k < kn; ++k)
    if (m0 + k < d) q_final[(long long)row * d + (d - 1 - m0 - k)] = w[k];
}

// The smoothclip derivatives of one slot's hour: dz1, dw1 of its serve
// clip; dz2, dw2 of its keep clip (0 at slot 0, whose rest drops).
template <typename T>
struct Coef {
  T dz1, dw1, dz2, dw2;
};

template <typename T>
__device__ __forceinline__ Coef<T> load_coef(const T* p);
template <>
__device__ __forceinline__ Coef<float> load_coef(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
}
template <>
__device__ __forceinline__ Coef<double> load_coef(const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  return {a.x, a.y, b.x, b.y};
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, T x, T y);
template <>
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store_pair(double* p, double x, double y) {
  *reinterpret_cast<double2*>(p) = make_double2(x, y);
}

// The backward's coefficient pass: a segment a (row, hour) of the hours
// [t0, t0 + tw), row fastest. Recomputes the hour's forward from the
// queue entering it (hist [T, B, d], youngest first) and writes coef
// [tw, B, d + 1, 4]: sigma(z / tau) - sigma((z - w) / tau) and sigma((z -
// w) / tau) of the serve clip (z the room, w the slot's work) and of the
// keep clip (z the bound's room, w the survivor).
template <typename T, int K>
__global__ void __launch_bounds__(kCoefThreads) soft_ledger_coef_kernel(
    const T* __restrict__ demand, const T* __restrict__ cap,
    const T* __restrict__ tau_p, T bound, int B, int T_, int d, int S, int Kn,
    int t0, int tw, const T* __restrict__ hist, T* __restrict__ coef,
    T* __restrict__ scratch) {
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long seg = gt / S;
  const int lane = (int)(gt % S);
  const bool active = seg < (long long)tw * B;
  const long long sg = active ? seg : 0;
  const int tt = (int)(sg / B), row = (int)(sg % B), t = t0 + tt;
  const int kn = K > 0 ? K : Kn;
  const int m0 = lane * kn;
  const T tau = tau_p[0];
  Slots<T, K> w, c;
  if constexpr (K < 0) {
    const long long n = (long long)gridDim.x * blockDim.x;
    w.base = scratch + gt;
    w.stride = n;
    c.base = scratch + (long long)kn * n + gt;
    c.stride = n;
  }
  const long long hq = ((long long)t * B + row) * d;
#pragma unroll
  for (int k = 0; k < kn; ++k) {
    const int m = m0 + k;
    w[k] = m < d ? hist[hq + (d - 1 - m)]
                 : (m == d ? demand[(long long)row * T_ + t] : T(0));
    c[k] = k == 0 ? w[k] : c[k - 1] + w[k];
  }
  const T capv = cap[(long long)row * T_ + t];
  seg_excl<T, K>(c, w, kn, lane, S);
  T* out = coef + ((long long)tt * B + row) * (d + 1) * 4;
#pragma unroll
  for (int k = 0; k < kn; ++k) {
    const int m = m0 + k;
    const T z = capv - c[k];
    const T u = w[k] - clip<false>(z, w[k], tau);
    const T sw = sigmoid((z - w[k]) / tau);
    if (active && m <= d) store_pair(out + 4 * m, sigmoid(z / tau) - sw, sw);
    w[k] = m == 0 ? T(0) : u;
  }
#pragma unroll
  for (int k = 0; k < kn; ++k) c[k] = k == 0 ? w[k] : c[k - 1] + w[k];
  seg_excl<T, K>(c, w, kn, lane, S);
#pragma unroll
  for (int k = 0; k < kn; ++k) {
    const int m = m0 + k;
    const T z = bound - c[k];
    const T sw = sigmoid((z - w[k]) / tau);
    if (active && m <= d)
      store_pair(out + 4 * m + 2, m == 0 ? T(0) : sigmoid(z / tau) - sw,
                 m == 0 ? T(0) : sw);
  }
}

// One hour of the reverse chain on a lane's slots (ref.soft_ledger_bwd_ref's
// formulas). a holds the adjoint of the queue the hour leaves (slot m at
// the lane's slot m, 0 at slots >= d) and returns that of the queue
// entering it; cf(k) the hour's coefficients of slot m0 + k; gst the
// served MWh's cotangent g_served + g_cost p_t.
template <typename T, int K, class A, class CF>
__device__ __forceinline__ void hour_chain(A& a, A& r, CF cf, int kn, int m0,
                                           int lane, int S, int d, T gst,
                                           T g_d, T g_b, T& dcap, T& ddem) {
  // gk: the adjoint of the keep at slot m, the queue's slot m - 1
  const T below = __shfl_up_sync(kFull, a[kn - 1], 1, S);
#pragma unroll
  for (int k = kn - 1; k >= 0; --k) a[k] = (k > 0 ? a[k - 1] : below) + g_b - g_d;
  // g_u = g_d + gk dw2 - sum over the later slots of gk dz2
  T run = T(0);
#pragma unroll
  for (int k = kn - 1; k >= 0; --k) {
    const T x = a[k] * cf(k).dz2;
    run = k == kn - 1 ? x : run + x;
    r[k] = run;
  }
  T incl = seg_rscan(run, lane, S);
  T post = T(0);
  if (K != 1) {
    post = __shfl_down_sync(kFull, incl, 1, S);
    if (lane == S - 1) post = T(0);
  }
#pragma unroll
  for (int k = 0; k < kn; ++k) {
    const Coef<T> q = cf(k);
    const T x = a[k] * q.dz2;
    const T later = seg_rincl<T, K>(r, k, incl, post) - x;
    r[k] = m0 + k == 0 ? g_d : g_d + a[k] * q.dw2 - later;
  }
  // g_room = (gst - g_u) dz1; g_w = g_u + (gst - g_u) dw1 - the later
  // slots' g_room
#pragma unroll
  for (int k = kn - 1; k >= 0; --k) {
    const T x = (gst - r[k]) * cf(k).dz1;
    run = k == kn - 1 ? x : run + x;
    a[k] = run;
  }
  incl = seg_rscan(run, lane, S);
  if (K != 1) {
    post = __shfl_down_sync(kFull, incl, 1, S);
    if (lane == S - 1) post = T(0);
  }
#pragma unroll
  for (int k = 0; k < kn; ++k) {
    const int m = m0 + k;
    const Coef<T> q = cf(k);
    const T gs = gst - r[k];
    const T x = gs * q.dz1;
    const T all = seg_rincl<T, K>(a, k, incl, post);
    const T gw = r[k] + gs * q.dw1 - (all - x);
    if (m == 0) dcap = all;   // every slot's g_room
    if (m == d) ddem = gw;
    a[k] = m < d ? gw : T(0);
  }
}

// The backward's reverse chain over the hours [t0, t0 + tw): a segment a
// row. lam [B, d] carries the adjoint of the queue leaving the window's
// last hour in (unless first) and that of the queue entering its first
// hour out.
template <typename T, int K>
__global__ void __launch_bounds__(kSegThreads) soft_ledger_chain_kernel(
    const T* __restrict__ prices, const T* __restrict__ g, int B, int T_,
    int d, int S, int Kn, int t0, int tw, const T* __restrict__ coef,
    T* __restrict__ lam, int first, T* __restrict__ d_cap,
    T* __restrict__ d_dem, T* __restrict__ scratch) {
  // hours of coefficients loaded ahead: about 8 float32 or 4 float64
  // slot-hours a lane
  constexpr int kV = sizeof(T) == 4 ? 8 : 4;
  constexpr int W = K > 0 && kV / K > 0 ? kV / K : 1;
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gt / S, lane = gt % S;
  const bool active = row < B;
  const int rr = active ? row : B - 1;
  const int kn = K > 0 ? K : Kn;
  const int m0 = lane * kn;
  const T g_s = g[rr], g_d = g[B + rr], g_b = g[2 * B + rr],
          g_c = g[3 * B + rr];
  Slots<T, K> a, r;
  if constexpr (K < 0) {
    const long long n = (long long)gridDim.x * blockDim.x;
    a.base = scratch + gt;
    a.stride = n;
    r.base = scratch + (long long)kn * n + gt;
    r.stride = n;
  }
#pragma unroll
  for (int k = 0; k < kn; ++k)
    a[k] = !first && m0 + k < d ? lam[(long long)rr * d + m0 + k] : T(0);
  const long long row_t = (long long)rr * T_;
  auto at = [&](int tt, int m) {
    return coef + (((long long)tt * B + rr) * (d + 1) + m) * 4;
  };
  T dcap = T(0), ddem = T(0);
  if constexpr (K < 0) {
    for (int tt = tw - 1; tt >= 0; --tt) {
      const int t = t0 + tt;
      const T gst = prices != nullptr ? g_s + g_c * prices[row_t + t] : g_s;
      auto cf = [&](int k) {
        return m0 + k <= d ? load_coef(at(tt, m0 + k)) : Coef<T>{};
      };
      hour_chain<T, K>(a, r, cf, kn, m0, lane, S, d, gst, g_d, g_b, dcap,
                       ddem);
      if (active && m0 == 0) d_cap[row_t + t] = dcap;
      if (active && d_dem != nullptr && m0 <= d && d < m0 + kn)
        d_dem[row_t + t] = ddem;
    }
  } else {
    Coef<T> nq[W][K];   // the next window's coefficients and prices
    T npr[W];
    auto load = [&](int hi) {   // hours hi, hi - 1, ..., hi - W + 1
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int tt = hi - j >= 0 ? hi - j : 0;
        npr[j] = prices != nullptr ? prices[row_t + t0 + tt] : T(0);
#pragma unroll
        for (int k = 0; k < K; ++k)
          nq[j][k] = m0 + k <= d ? load_coef(at(tt, m0 + k)) : Coef<T>{};
      }
    };
    load(tw - 1);
    for (int hi = tw - 1; hi >= 0; hi -= W) {
      Coef<T> q[W][K];
      T pr[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        pr[j] = npr[j];
#pragma unroll
        for (int k = 0; k < K; ++k) q[j][k] = nq[j][k];
      }
      load(hi - W);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int tt = hi - j;
        if (tt < 0) break;
        const int t = t0 + tt;
        const T gst = prices != nullptr ? g_s + g_c * pr[j] : g_s;
        auto cf = [&](int k) { return q[j][k]; };
        hour_chain<T, K>(a, r, cf, kn, m0, lane, S, d, gst, g_d, g_b, dcap,
                         ddem);
        if (active && m0 == 0) d_cap[row_t + t] = dcap;
        if (active && d_dem != nullptr && m0 <= d && d < m0 + kn)
          d_dem[row_t + t] = ddem;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < kn; ++k)
      if (m0 + k < d) lam[(long long)row * d + m0 + k] = a[k];
  }
}

// f(std::integral_constant<int, D>) for d's kernel: D = d for d <= 8, the
// memory form (D = -1) above
template <class F, int... Ds>
int with_d(int d, F&& f, std::integer_sequence<int, Ds...>) {
  int rc = 0;
  bool hit = false;
  ((d == Ds ? (rc = f(std::integral_constant<int, Ds>{}), hit = true)
            : false),
   ...);
  return hit ? rc : f(std::integral_constant<int, -1>{});
}

template <class F>
int with_d(int d, F&& f) {
  return with_d(d, f, std::make_integer_sequence<int, kMaxRegD + 1>{});
}

// f(std::integral_constant<int, K>) for a plan's template K
template <class F>
int with_k(int kt, F&& f) {
  switch (kt) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return f(std::integral_constant<int, -1>{});
  }
}

// threads of the grid that gives each of n segments S lanes, in blocks
// of `block`
long long seg_threads(long long n, int S, int block) {
  return (n * S + block - 1) / block * block;
}

// hours a window of the backward (its coefficients within kCoefBytes)
int bwd_window(int B, int T, int d, int itemsize) {
  const long long per_hour = (long long)B * (d + 1) * 4 * itemsize;
  const long long tw = kCoefBytes / per_hour;
  return (int)(tw < 1 ? 1 : (tw > T ? T : tw));
}

long long fwd_scratch(int B, int d) {
  const SegPlan p = seg_plan(d);
  return p.Kt > 0 ? 0 : 2LL * p.K * seg_threads(B, p.S, kSegThreads);
}

// the backward's scratch: the window's coefficients, the carried adjoint
// [B, d], and the slots of the memory form
long long bwd_scratch(int B, int T, int d, int itemsize) {
  const SegPlan p = seg_plan(d);
  const long long tw = bwd_window(B, T, d, itemsize);
  long long n = tw * B * (d + 1) * 4 + (long long)B * d;
  if (p.Kt < 0) {
    const long long a = seg_threads(B, p.S, kSegThreads);
    const long long b = seg_threads(tw * B, p.S, kCoefThreads);
    n += 2LL * p.K * (a > b ? a : b);
  }
  return n;
}

template <typename T>
int soft_fwd(const T* demand, const T* cap, const T* prices, const T* tau,
             T bound, int B, int T_, int d, int hard, T* sums, T* hist,
             T* q_final, T* hourly, T* scratch, void* stream) {
  if (B <= 0 || T_ <= 0 || d < 0 || (!hard && tau == nullptr))
    return (int)cudaErrorInvalidValue;
  const SegPlan p = seg_plan(d);
  if (p.Kt < 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(seg_threads(B, p.S, kSegThreads) / kSegThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_k(p.Kt, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    if (hard)
      soft_ledger_fwd_kernel<T, K, true><<<blocks, kSegThreads, 0, s>>>(
          demand, cap, prices, tau, bound, B, T_, d, p.S, p.K, sums, hist,
          q_final, hourly, scratch);
    else
      soft_ledger_fwd_kernel<T, K, false><<<blocks, kSegThreads, 0, s>>>(
          demand, cap, prices, tau, bound, B, T_, d, p.S, p.K, sums, hist,
          q_final, hourly, scratch);
    ++g_launched;
    return (int)cudaGetLastError();
  });
}

template <typename T>
int soft_bwd(const T* demand, const T* cap, const T* prices, const T* tau,
             T bound, int B, int T_, int d, const T* hist, const T* g,
             T* d_cap, T* d_dem, T* scratch, void* stream) {
  if (B <= 0 || T_ <= 0 || d < 0 || tau == nullptr || scratch == nullptr ||
      (d > 0 && hist == nullptr))
    return (int)cudaErrorInvalidValue;
  const SegPlan p = seg_plan(d);
  const int tw = bwd_window(B, T_, d, (int)sizeof(T));
  T* coef = scratch;
  T* lam = coef + (long long)tw * B * (d + 1) * 4;
  T* mem = lam + (long long)B * d;
  const int chain_blocks =
      (int)(seg_threads(B, p.S, kSegThreads) / kSegThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_k(p.Kt, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    for (int hi = T_; hi > 0; hi -= tw) {   // windows, the latest first
      const int t0 = hi > tw ? hi - tw : 0, len = hi - t0;
      const int coef_blocks =
          (int)(seg_threads((long long)len * B, p.S, kCoefThreads) /
                kCoefThreads);
      soft_ledger_coef_kernel<T, K><<<coef_blocks, kCoefThreads, 0, s>>>(
          demand, cap, tau, bound, B, T_, d, p.S, p.K, t0, len, hist, coef,
          mem);
      ++g_launched;
      int err = (int)cudaGetLastError();
      if (err != 0) return err;
      soft_ledger_chain_kernel<T, K><<<chain_blocks, kSegThreads, 0, s>>>(
          prices, g, B, T_, d, p.S, p.K, t0, len, coef, lam, hi == T_, d_cap,
          d_dem, mem);
      ++g_launched;
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
    return 0;
  });
}

}  // namespace

extern "C" unsigned long long kernels_launched() { return g_launched.load(); }

extern "C" {

// Rows a block of the hard ledger kernel for G draws: whole rows in one
// warp, or one row a block.
int workload_ledger_rows_per_block(int G) { return G <= 32 ? 32 / G : 1; }
int ledger_max_reg_d() { return kMaxRegD; }

// prices: [N, T] float32 row-major; market_idx: [B] int64 in [0, N), or
// null (then N == B); p_on, p_off, off_level, cap_mwh, dt: [B]; demand:
// [G, T]; out: [4, B, G] (served, dropped, backlog, served cost); hourly:
// [4, B, T] or null (no telemetry); scratch: [d, B, G] when d > 8, else
// null. One launch on `stream`; returns cudaGetLastError().
int workload_ledger_f32(const float* prices, const long long* market_idx,
                        const float* p_on, const float* p_off,
                        const float* off_level, const float* cap_mwh,
                        const float* dt, const float* demand, float bound,
                        int B, int N, int G, int T, int d, float* out,
                        float* hourly, float* scratch, void* stream) {
  if (B <= 0 || N <= 0 || T <= 0 || G <= 0 || G > kMaxDraws || d < 0 ||
      (market_idx == nullptr && N != B) ||
      (d > kMaxRegD && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int rpb = workload_ledger_rows_per_block(G);
  const int threads = rpb * G, blocks = (B + rpb - 1) / rpb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, int W) {
    const size_t shm = hourly != nullptr
                           ? 2 * (size_t)threads * ring_floats(W) * sizeof(float)
                           : 0;
    if (shm > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<blocks, threads, shm, s>>>(prices, market_idx, p_on, p_off,
                                        off_level, cap_mwh, dt, demand, bound,
                                        B, N, G, T, d, rpb, out, hourly,
                                        scratch);
    ++g_launched;
    return (int)cudaGetLastError();
  };
  return with_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if (threads <= kWinThreads)
      return hourly != nullptr
                 ? launch(workload_ledger_kernel<D, true, kWin>, kWin)
                 : launch(workload_ledger_kernel<D, false, kWin>, kWin);
    return hourly != nullptr
               ? launch(workload_ledger_kernel<D, true, kWinBig>, kWinBig)
               : launch(workload_ledger_kernel<D, false, kWinBig>, kWinBig);
  });
}

// The soft pair's scratch, in values of the pair's type: the forward's at
// deadline d (0 below d = 256: its slots live in registers), the
// backward's for [B, T] rows (itemsize 4 or 8).
long long soft_ledger_fwd_scratch(int B, int d) { return fwd_scratch(B, d); }
long long soft_ledger_bwd_scratch(int B, int T, int d, int itemsize) {
  return bwd_scratch(B, T, d, itemsize);
}

// demand, cap, prices (or null): [B, T]; tau: [1] on the device (unread
// when hard); sums: [4, B]; hist: [T, B, d] (the queue entering each hour,
// youngest first) or null; q_final: [B, d] youngest first;
// hourly: [3, B, T] or null; scratch: soft_ledger_fwd_scratch(B, d)
// values, or null when that is 0. One launch on `stream`.
int soft_ledger_fwd_f32(const float* demand, const float* cap,
                        const float* prices, const float* tau, float bound,
                        int B, int T, int d, int hard, float* sums,
                        float* hist, float* q_final, float* hourly,
                        float* scratch, void* stream) {
  return soft_fwd<float>(demand, cap, prices, tau, bound, B, T, d, hard,
                         sums, hist, q_final, hourly, scratch, stream);
}
int soft_ledger_fwd_f64(const double* demand, const double* cap,
                        const double* prices, const double* tau, double bound,
                        int B, int T, int d, int hard, double* sums,
                        double* hist, double* q_final, double* hourly,
                        double* scratch, void* stream) {
  return soft_fwd<double>(demand, cap, prices, tau, bound, B, T, d, hard,
                          sums, hist, q_final, hourly, scratch, stream);
}

// g: [4, B] cotangents of the forward's sums; d_cap: [B, T]; d_dem: [B, T]
// or null; scratch: soft_ledger_bwd_scratch(B, T, d, itemsize) values.
// Two launches a window of hours (coefficients, then the chain), one
// window where the coefficients fit kCoefBytes.
int soft_ledger_bwd_f32(const float* demand, const float* cap,
                        const float* prices, const float* tau, float bound,
                        int B, int T, int d, const float* hist,
                        const float* g, float* d_cap, float* d_dem,
                        float* scratch, void* stream) {
  return soft_bwd<float>(demand, cap, prices, tau, bound, B, T, d, hist, g,
                         d_cap, d_dem, scratch, stream);
}
int soft_ledger_bwd_f64(const double* demand, const double* cap,
                        const double* prices, const double* tau,
                        double bound, int B, int T, int d,
                        const double* hist, const double* g, double* d_cap,
                        double* d_dem, double* scratch, void* stream) {
  return soft_bwd<double>(demand, cap, prices, tau, bound, B, T, d, hist, g,
                          d_cap, d_dem, scratch, stream);
}

}  // extern "C"
