// The work ledger for Hopper (sm_90a): a bounded, deadline-aged deferral
// queue served hour by hour. Three kernels.
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
// w) / tau)). Each hour is one pass over the d + 1 buckets, serving
// bucket i and re-queueing survivor i - 1 together, from running sums in
// the kernel's type (an inclusive sum c and c - w, as the plain version's
// cumsum - w), so a thread holds no temporaries but the queue.
//
//   workload_ledger_kernel (hard, "workload_ledger_fwd"): one thread a
//     (row, draw) lane, whole rows in a block (G draws a row, 32 / G rows
//     a block, or one row of G <= 1024 threads). Each thread recomputes
//     its row's shutdown state machine inline (off if p > p_off, else on
//     if p <= p_on, else carried; starting on: the comparisons of
//     ref.hard_hour_step) on the row's prices read through market_idx,
//     serves its draw's arrivals dt * demand[g, t] with the hour's
//     realised capacity cap_mwh * (lvl + (1 - lvl) on), and adds served,
//     dropped, backlog and served * p into float32 sums hour by hour, the
//     reference's order. With telemetry it also writes each row's hourly
//     sums over its draws ([4, B, T], added in draw order through shared
//     memory, two barriers an hour); nothing else changes.
//   soft_ledger_fwd_kernel: one thread a row of [B, T] demand and
//     capacity (MWh), hard or smoothclip at tau (a device scalar), float32
//     or float64. Writes the four sums (served, dropped, backlog, served
//     cost), the queue entering every hour ([T, d, B], the backward's
//     residual), the final queue and, optionally, the [3, B, T] hourly
//     series.
//   soft_ledger_bwd_kernel: one thread a row, reverse time. Each hour
//     recomputes its forward from the saved queue into d + 1 bucket
//     arrays, then runs the adjoint of both exclusive sums and both
//     smoothclips (ref.soft_ledger_bwd_ref has the formulas): d cap [B, T]
//     and d demand [B, T].
//
// The queue and the backward's bucket arrays are registers for d <= 8
// (a kernel for each d, the loops unrolled) and device memory above (a
// scratch the wrapper allocates, bucket i of lane l at i * lanes + l).
// Float32 exp / log1p of the smoothclip and its sigmoids are taken in
// float64 and rounded once, as the plain version's _exp_rn / _log1p_rn;
// the file is compiled with -fmad=false (build.SOURCE_FLAGS), so every
// float operation rounds once as the plain version's do. Sums over the
// buckets of an hour are taken in bucket order here and by torch's cumsum
// and sum there, so the two agree bit for bit where the work is
// integer-valued and to rounding otherwise.
//
// Bound on an H100 SXM: the serial chain of T hours (each hour waits on
// the last one's queue), ~(d + 1) x 10 dependent float operations an hour;
// bytes (the [N, T] prices, [G, T] demand and [B, T] inputs read once, the
// outputs written once) at 3.35 TB/s are far below it at the shapes the
// ledger runs. A first, simple design: one thread a lane, no overlap of
// one lane's hours, and only B x G (hard) or B (soft) lanes in flight.

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
constexpr int kSoftThreads = 64;  // threads a block of the soft kernels
constexpr int kMaxDraws = 1024;   // one row's draws fit one block

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
__device__ __forceinline__ T exp_rn(T x);
template <>
__device__ __forceinline__ float exp_rn(float x) {
  return (float)exp((double)x);
}
template <>
__device__ __forceinline__ double exp_rn(double x) {
  return exp(x);
}

template <typename T>
__device__ __forceinline__ T log1p_rn(T x);
template <>
__device__ __forceinline__ float log1p_rn(float x) {
  return (float)log1p((double)x);
}
template <>
__device__ __forceinline__ double log1p_rn(double x) {
  return log1p(x);
}

// softplus(x) = max(x, 0) + log1p(exp(-|x|)), jax.nn.softplus's value
template <typename T>
__device__ __forceinline__ T softplus(T x) {
  const T z = T(0);
  return (x > z ? x : z) + log1p_rn(exp_rn(-(x < z ? -x : x)));
}

template <typename T>
__device__ __forceinline__ T sigmoid(T x) {
  return T(1) / (T(1) + exp_rn(-x));
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

// One hour of the ledger on the oldest-first queue o of d buckets
// (in place): arrivals a, capacity cap. Returns served, dropped and the
// backlog left (the sum of the new queue).
template <bool HARD, int D, typename T, class Q>
__device__ __forceinline__ void hour_fwd(Q& o, int d, T a, T cap, T bound,
                                         T tau, T& served, T& dropped,
                                         T& backlog) {
  if (D >= 0) d = D;
  T c = T(0), ca = T(0), srv = T(0), dsum = T(0), bl = T(0), u0 = T(0);
#pragma unroll
  for (int i = 0; i <= (D >= 0 ? D : d); ++i) {
    const T w = i < d ? o[i] : a;
    c = c + w;
    const T s = clip<HARD>(cap - (c - w), w, tau);
    srv = srv + s;
    const T u = w - s;
    if (i == 0) {
      u0 = u;
    } else {
      ca = ca + u;
      const T keep = clip<HARD>(bound - (ca - u), u, tau);
      dsum = dsum + (u - keep);
      bl = bl + keep;
      o[i - 1] = keep;
    }
  }
  served = srv;
  dropped = u0 + dsum;
  backlog = bl;
}

template <int D>
using HardQueue = typename std::conditional<(D >= 0), Arr<float, D>,
                                            Mem<float>>::type;

template <int D, bool TELEM>
__global__ void workload_ledger_kernel(
    const float* __restrict__ prices, const long long* __restrict__ market_idx,
    const float* __restrict__ p_on, const float* __restrict__ p_off,
    const float* __restrict__ off_level, const float* __restrict__ cap_mwh,
    const float* __restrict__ dt, const float* __restrict__ demand,
    float bound, int B, int N, int G, int T, int d, int rows_per_block,
    float* __restrict__ out, float* __restrict__ hourly,
    float* __restrict__ scratch) {
  extern __shared__ float tel[];  // [4][blockDim.x] with telemetry
  const int lane = threadIdx.x, nt = blockDim.x;
  const int r_local = lane / G, g = lane % G;
  const int row = blockIdx.x * rows_per_block + r_local;
  const bool active = r_local < rows_per_block && row < B;
  const int rw = active ? row : 0;
  long long src = rw;
  if (market_idx != nullptr) {
    src = market_idx[rw];
    if (src < 0 || src >= N) __trap();
  }
  const float* prow = prices + src * (long long)T;
  const float* drow = demand + (long long)g * T;
  const float lo = p_on[rw], hi = p_off[rw], lvl = off_level[rw];
  const float cmwh = cap_mwh[rw], dtb = dt[rw];
  const long long lanes = (long long)B * G, me = (long long)rw * G + g;
  HardQueue<D> q;
  if constexpr (D < 0) {
    q.base = scratch + me;
    q.stride = lanes;
  }
  if (active)
    for (int i = 0; i < (D >= 0 ? D : d); ++i) q[i] = 0.f;
  float on = 1.f, s_acc = 0.f, d_acc = 0.f, b_acc = 0.f, c_acc = 0.f;
  for (int t = 0; t < T; ++t) {
    float a = 0.f, served = 0.f, dropped = 0.f, bl = 0.f;
    if (active) {
      const float p = prow[t];
      on = p > hi ? 0.f : (p <= lo ? 1.f : on);
      const float cap = lvl + (1.f - lvl) * on;
      a = dtb * drow[t];
      hour_fwd<true, D>(q, d, a, cmwh * cap, bound, 0.f, served, dropped,
                        bl);
      s_acc = s_acc + served;
      d_acc = d_acc + dropped;
      b_acc = b_acc + bl;
      c_acc = c_acc + served * p;
    }
    if (TELEM) {
      tel[lane] = a;
      tel[nt + lane] = served;
      tel[2 * nt + lane] = dropped;
      tel[3 * nt + lane] = bl;
      __syncthreads();
      for (int k = lane; k < 4 * rows_per_block; k += nt) {
        const int rr = k >> 2, qq = k & 3;
        const int orow = blockIdx.x * rows_per_block + rr;
        if (orow < B) {
          float s = 0.f;
          for (int j = 0; j < G; ++j) s = s + tel[qq * nt + rr * G + j];
          hourly[((long long)qq * B + orow) * T + t] = s;
        }
      }
      __syncthreads();
    }
  }
  if (active) {
    out[me] = s_acc;
    out[lanes + me] = d_acc;
    out[2 * lanes + me] = b_acc;
    out[3 * lanes + me] = c_acc;
  }
}

template <typename T, int D>
using SoftQueue = typename std::conditional<(D >= 0), Arr<T, D>,
                                            Mem<T>>::type;

template <typename T, int D, bool HARD>
__global__ void soft_ledger_fwd_kernel(
    const T* __restrict__ demand, const T* __restrict__ cap,
    const T* __restrict__ prices, const T* __restrict__ tau_p, T bound, int B,
    int T_, int d, T* __restrict__ sums, T* __restrict__ hist,
    T* __restrict__ q_final, T* __restrict__ hourly, T* __restrict__ scratch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T tau = HARD ? T(0) : tau_p[0];
  const int dd = D >= 0 ? D : d;
  SoftQueue<T, D> q;
  if constexpr (D < 0) {
    q.base = scratch + b;
    q.stride = B;
  }
#pragma unroll
  for (int i = 0; i < dd; ++i) q[i] = T(0);
  const long long base = (long long)b * T_;
  T s_acc = T(0), d_acc = T(0), b_acc = T(0), c_acc = T(0);
  for (int t = 0; t < T_; ++t) {
    if (hist != nullptr) {
#pragma unroll
      for (int i = 0; i < dd; ++i)
        hist[((long long)t * dd + i) * B + b] = q[i];
    }
    T served, dropped, bl;
    hour_fwd<HARD, D>(q, d, demand[base + t], cap[base + t], bound, tau,
                      served, dropped, bl);
    const T p = prices != nullptr ? prices[base + t] : T(0);
    s_acc = s_acc + served;
    d_acc = d_acc + dropped;
    b_acc = b_acc + bl;
    c_acc = c_acc + served * p;
    if (hourly != nullptr) {
      hourly[base + t] = served;
      hourly[(long long)B * T_ + base + t] = dropped;
      hourly[2LL * B * T_ + base + t] = bl;
    }
  }
  sums[b] = s_acc;
  sums[B + b] = d_acc;
  sums[2 * B + b] = b_acc;
  sums[3 * B + b] = c_acc;
#pragma unroll
  for (int k = 0; k < dd; ++k) q_final[(long long)b * dd + k] = q[dd - 1 - k];
}

template <typename T, int D>
using BwdArr = typename std::conditional<(D >= 0), Arr<T, D + 1>,
                                         Mem<T>>::type;

// The adjoint of one hour (ref.soft_ledger_bwd_ref's formulas). o: the
// queue entering the hour (oldest first); lam: on entry the adjoint of the
// queue the hour leaves, on return that of the queue entering it (both
// oldest first).
template <typename T, int D, class A>
__device__ __forceinline__ void hour_bwd(Mem<T>& o, A& w, A& room, A& aged,
                                         A& za, A& gu, A& lam, int d, T a,
                                         T capv, T bound, T tau, T g_s,
                                         T g_d, T g_b, T& d_cap, T& d_dem) {
  if (D >= 0) d = D;
  T c = T(0), ca = T(0);
#pragma unroll
  for (int i = 0; i <= (D >= 0 ? D : d); ++i) {
    const T wi = i < d ? o[i] : a;
    c = c + wi;
    const T rm = capv - (c - wi);
    const T u = wi - clip<false>(rm, wi, tau);
    w[i] = wi;
    room[i] = rm;
    if (i > 0) {
      ca = ca + u;
      aged[i - 1] = u;
      za[i - 1] = bound - (ca - u);
    }
  }
  T r = T(0);
#pragma unroll
  for (int j = (D >= 0 ? D : d) - 1; j >= 0; --j) {
    const T gk = lam[j] + g_b - g_d;
    const T s_w = sigmoid((za[j] - aged[j]) / tau);
    const T dz = sigmoid(za[j] / tau) - s_w;
    gu[j + 1] = g_d + gk * s_w - r;
    r = r + gk * dz;
  }
  gu[0] = g_d;
  T r2 = T(0), gc = T(0);
#pragma unroll
  for (int i = (D >= 0 ? D : d); i >= 0; --i) {
    const T s_w = sigmoid((room[i] - w[i]) / tau);
    const T dz = sigmoid(room[i] / tau) - s_w;
    const T g_serve = g_s - gu[i];
    const T g_room = g_serve * dz;
    const T g_w = gu[i] + g_serve * s_w - r2;
    r2 = r2 + g_room;
    gc = gc + g_room;
    if (i < d)
      lam[i] = g_w;
    else
      d_dem = g_w;
  }
  d_cap = gc;
}

template <typename T, int D>
__global__ void soft_ledger_bwd_kernel(
    const T* __restrict__ demand, const T* __restrict__ cap,
    const T* __restrict__ prices, const T* __restrict__ tau_p, T bound, int B,
    int T_, int d, const T* __restrict__ hist, const T* __restrict__ g,
    T* __restrict__ d_cap, T* __restrict__ d_dem, T* __restrict__ scratch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T tau = tau_p[0];
  const int dd = D >= 0 ? D : d;
  const T g_s0 = g[b], g_d = g[B + b], g_b = g[2 * B + b], g_c = g[3 * B + b];
  BwdArr<T, D> w, room, aged, za, gu, lam;
  if constexpr (D < 0) {
    const long long n = (long long)(d + 1) * B;
    BwdArr<T, D>* arrs[6] = {&w, &room, &aged, &za, &gu, &lam};
    for (int k = 0; k < 6; ++k) {
      arrs[k]->base = scratch + k * n + b;
      arrs[k]->stride = B;
    }
  }
#pragma unroll
  for (int i = 0; i < dd; ++i) lam[i] = T(0);
  const long long base = (long long)b * T_;
  for (int t = T_ - 1; t >= 0; --t) {
    Mem<T> o{const_cast<T*>(hist) + (long long)t * dd * B + b, B};
    const T g_s =
        prices != nullptr ? g_s0 + g_c * prices[base + t] : g_s0;
    T dc, dm;
    hour_bwd<T, D>(o, w, room, aged, za, gu, lam, d, demand[base + t],
                   cap[base + t], bound, tau, g_s, g_d, g_b, dc, dm);
    d_cap[base + t] = dc;
    if (d_dem != nullptr) d_dem[base + t] = dm;
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

template <typename T>
int soft_fwd(const T* demand, const T* cap, const T* prices, const T* tau,
             T bound, int B, int T_, int d, int hard, T* sums, T* hist,
             T* q_final, T* hourly, T* scratch, void* stream) {
  if (B <= 0 || T_ <= 0 || d < 0 || (d > kMaxRegD && scratch == nullptr) ||
      (!hard && tau == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kSoftThreads - 1) / kSoftThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if (hard)
      soft_ledger_fwd_kernel<T, D, true><<<blocks, kSoftThreads, 0, s>>>(
          demand, cap, prices, tau, bound, B, T_, d, sums, hist, q_final,
          hourly, scratch);
    else
      soft_ledger_fwd_kernel<T, D, false><<<blocks, kSoftThreads, 0, s>>>(
          demand, cap, prices, tau, bound, B, T_, d, sums, hist, q_final,
          hourly, scratch);
    ++g_launched;
    return (int)cudaGetLastError();
  });
}

template <typename T>
int soft_bwd(const T* demand, const T* cap, const T* prices, const T* tau,
             T bound, int B, int T_, int d, const T* hist, const T* g,
             T* d_cap, T* d_dem, T* scratch, void* stream) {
  if (B <= 0 || T_ <= 0 || d < 0 || (d > kMaxRegD && scratch == nullptr) ||
      (d > 0 && hist == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kSoftThreads - 1) / kSoftThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    soft_ledger_bwd_kernel<T, D><<<blocks, kSoftThreads, 0, s>>>(
        demand, cap, prices, tau, bound, B, T_, d, hist, g, d_cap, d_dem,
        scratch);
    ++g_launched;
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" unsigned long long kernels_launched() { return g_launched.load(); }

extern "C" {

// Rows a block and threads a block of the hard ledger kernel for G draws.
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
  const size_t shm = hourly != nullptr ? 4 * threads * sizeof(float) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if (hourly != nullptr)
      workload_ledger_kernel<D, true><<<blocks, threads, shm, s>>>(
          prices, market_idx, p_on, p_off, off_level, cap_mwh, dt, demand,
          bound, B, N, G, T, d, rpb, out, hourly, scratch);
    else
      workload_ledger_kernel<D, false><<<blocks, threads, 0, s>>>(
          prices, market_idx, p_on, p_off, off_level, cap_mwh, dt, demand,
          bound, B, N, G, T, d, rpb, out, hourly, scratch);
    ++g_launched;
    return (int)cudaGetLastError();
  });
}

// demand, cap, prices (or null): [B, T]; tau: [1] on the device (unread
// when hard); sums: [4, B]; hist: [T, d, B] (the queue entering each hour,
// oldest first) or null; q_final: [B, d] youngest first;
// hourly: [3, B, T] or null; scratch: [d, B] when d > 8, else null.
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
// or null; scratch: [6, d + 1, B] when d > 8, else null.
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
