// Batched two-threshold hysteresis scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fleet_scan.py::_fleet_kernel
// (the hot loop of repro.fleet.engine.backtest). Per row b of a float32
// price block and its four parameters, starting on:
//
//   on_t = 0 if p_t > p_off, 1 if p_t <= p_on, else on_{t-1}
//
// (off tested first, the rule of repro_torch.kernels.ref.hard_hour_step, so
// an inverted band p_on > p_off gives what the plain version gives),
// reduced to four sums: sum draw_t p_t, sum cap_t, #starts, sum start_t p_t.
// Row b reads its prices from row market_idx[b] of an [N, T] market block,
// or from row b of a [B, T] block where no index is given; an index
// outside [0, N) traps (the error surfaces at the next synchronisation).
//
// Design: one launch a call, one block of kThreads (NT) threads a row, no
// scratch. The TPU kernel removes the time recurrence with a running max:
// each decisive hour is coded 2t + on (-1 for an hour that decides
// nothing), so the largest code at or before an hour is its last decisive
// event, whose low bit is the state. Here that max-scan runs across the
// threads of the block. Each thread owns L consecutive hours of a window of
// W = NT x L hours; L is a compile-time constant, one kernel for each of
// kSegs, the fewest that cover T in one window (the tuner's 2190 hours:
// 256 x 9; the backtest's 8760: 256 x 36, the last 12 threads idle), or
// the most, in windows. Per window:
//   1. each thread finds its run's last decisive event, reading its hours
//      from the last one back (the last hour decides in most runs);
//   2. an exclusive max-scan of those codes across the block (warp
//      shuffles, then a fold of the warp totals) gives each run its
//      entering state: the code's low bit, or the window's entering state
//      (1 before the row's first hour) where no event came earlier; the
//      largest code of all gives the next window's entering state;
//   3. each thread replays its hours from its entering state, 16 bytes a
//      load where the rows are 16-byte aligned and L % 4 == 0 (4 bytes
//      otherwise), and adds the four terms of hard_hour_step into float32
//      sums of its own.
// At the end a fixed-order tree adds the threads' sums in float64 (within
// each warp by shuffles, lanes l and l + st for st = 16, ..., 1; then the
// warps' sums the same way) and writes out[4, B] rounded once. No
// atomics: every launch gives the same bits. ref.fleet_scan_seg_ref does
// exactly what this kernel does; the file is compiled with -fmad=false
// (build.SOURCE_FLAGS) so that every float32 operation rounds once, as the
// mirror's do, and the two agree bit for bit on the card.
//
// Measured on the card (scan_probe.py, PERF.md): staging each window in
// shared memory with coalesced loads was slower than each thread loading
// its own run, and so were holding a run's hours in registers for the
// replay, finding the last event from a run's front, 128 or 512 threads a
// row and other register caps. Without its replay the kernel keeps about
// 2/3 of its time at 8192 x 8760, where every row reads its market's 35 KB
// from L2.
//
// Bound on an H100 SXM. Indexed (the backtest): the kernel must read the
// [N, T] market block once (16 x 8760 x 4 B = 0.56 MB, which stays in the
// 50 MB L2 for every row that reads it), the index and the parameters, and
// write [4, B]; ~10 float32 operations a row-hour (compares, selects,
// adds) at 67 TFLOP/s set the bound: 1.34 us at 1024 x 8760. Gathered (the
// tuner's hard re-scoring, [B, T]): the B x T x 4 bytes of prices at 3.35
// TB/s set it. No single PyTorch call computes this function (a sequential
// state machine), so there is no library yardstick. The design this
// replaces ran two launches (a pass per (row, 256-hour chunk) that scanned
// its chunk from both entering states, then a stitch) with one serial
// thread per (row, chunk) and a scratch buffer between them.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

// Kernels this library has launched in this process, counted on the host
// where each launch is issued; kernels_launched() reads it, and the
// wrappers count a call's launches on the card as its difference.
std::atomic<unsigned long long> g_launched{0};

constexpr int kThreads = 256;   // NT: threads a block, one block a row
// the hours a thread may own in a window (L), each a kernel of its own
#define FLEET_SEGS 1, 2, 4, 9, 18, 36
constexpr int kSegs[] = {FLEET_SEGS};
constexpr int kMinBlocks = 4;    // blocks an SM: caps the registers
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

struct Row {
  float p_on, p_off, cap_on, cap_off, draw_on, draw_off;
};

// The exclusive max-scan of the threads' codes across the block. Returns
// the largest code of the threads before this one (-1 if none); all
// becomes the largest code of the block. Holds one __syncthreads; the
// caller synchronises again before tot is written anew.
__device__ __forceinline__ int block_exclusive_max(int code, int& all,
                                                   int* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kAll, code, d);
    if (lane >= d) code = max(code, v);
  }
  int before = __shfl_up_sync(kAll, code, 1);
  if (lane == 0) before = -1;
  if (lane == 31) tot[warp] = code;
  __syncthreads();
  all = -1;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    if (k < warp) before = max(before, tot[k]);
    all = max(all, tot[k]);
  }
  return before;
}

// x over lanes l and l + st for st = 16, ..., 1 (st < width): lane 0 ends
// with the sum of the first `width` lanes' values in that fixed order
__device__ __forceinline__ double warp_tree(double x, int width) {
#pragma unroll
  for (int st = 16; st > 0; st >>= 1)
    if (st < width) x += __shfl_down_sync(kAll, x, st);
  return x;
}

// The code of the last decisive hour among the m hours at src, a run
// starting at window hour k0 (2k for off, 2k + 1 for on, -1 if none), read
// from the run's end.
__device__ __forceinline__ int last_event(const float* __restrict__ src,
                                          int k0, int m, const Row& q) {
  for (int j = m - 1; j >= 0; --j) {
    const float x = __ldg(src + j);
    if (x > q.p_off) return 2 * (k0 + j);
    if (x <= q.p_on) return 2 * (k0 + j) + 1;
  }
  return -1;
}

struct Sums {
  float dp = 0.0f, cap = 0.0f, st = 0.0f, sp = 0.0f;
};

// One hour of hard_hour_step from state on, its four terms added to a
// (cap and draw picked from their values at on = 1 and on = 0: the bits
// hard_hour_step gives them).
__device__ __forceinline__ void replay_hour(float x, float& on, Sums& a,
                                            const Row& q) {
  const float now = x > q.p_off ? 0.0f : (x <= q.p_on ? 1.0f : on);
  const float start = fmaxf(now - on, 0.0f);
  const bool up = now != 0.0f;
  a.dp += (up ? q.draw_on : q.draw_off) * x;
  a.cap += up ? q.cap_on : q.cap_off;
  a.st += start;
  a.sp += start * x;
  on = now;
}

// V: the rows are 16-byte aligned and L a multiple of 4, so a run loads
// its hours four at a time. The replay is one loop with a test an hour
// (j < m): with a second copy of it for full runs, without the tests,
// nvcc's optimised build replayed hours past m (a build with -G did not).
template <int L, bool V>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fleet_scan_kernel(
    const float* __restrict__ prices, const long long* __restrict__ market_idx,
    const float* __restrict__ p_on, const float* __restrict__ p_off,
    const float* __restrict__ off_level, const float* __restrict__ idle_frac,
    float* __restrict__ out, int B, int N, int T) {
  __shared__ int tot[kWarps];
  __shared__ double wsum[4][kWarps];
  const int row = blockIdx.x;
  long long src = row;
  if (market_idx != nullptr) {
    src = market_idx[row];
    if (src < 0 || src >= N) __trap();
  }
  const float* p_row = prices + (size_t)src * T;
  Row q;
  {
    const float lvl = off_level[row], idle = idle_frac[row];
    q.p_on = p_on[row];
    q.p_off = p_off[row];
    // cap and draw of hard_hour_step at on = 1 and on = 0
    q.cap_on = lvl + (1.0f - lvl) * 1.0f;
    q.cap_off = lvl + (1.0f - lvl) * 0.0f;
    q.draw_on = q.cap_on + idle * (1.0f - q.cap_on);
    q.draw_off = q.cap_off + idle * (1.0f - q.cap_off);
  }
  constexpr int W = kThreads * L;
  const int k0 = threadIdx.x * L;
  float carry = 1.0f;  // the state entering the window: on at hour 0
  Sums acc;
  for (int t0 = 0; t0 < T; t0 += W) {
    const int n = min(W, T - t0);
    const int m = max(0, min(L, n - k0));  // this run's hours
    const float* r = p_row + t0 + k0;
    int all;
    const int before = block_exclusive_max(last_event(r, k0, m, q), all, tot);
    float on = before >= 0 ? (float)(before & 1) : carry;
    carry = all >= 0 ? (float)(all & 1) : carry;
    if constexpr (V) {
#pragma unroll
      for (int j = 0; j < L; j += 4) {
        float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (j + 4 <= m) {
          c = __ldg(reinterpret_cast<const float4*>(r + j));
        } else if (j < m) {
          c.x = __ldg(r + j);
          if (j + 1 < m) c.y = __ldg(r + j + 1);
          if (j + 2 < m) c.z = __ldg(r + j + 2);
        }
        if (j < m) replay_hour(c.x, on, acc, q);
        if (j + 1 < m) replay_hour(c.y, on, acc, q);
        if (j + 2 < m) replay_hour(c.z, on, acc, q);
        if (j + 3 < m) replay_hour(c.w, on, acc, q);
      }
    } else {
#pragma unroll
      for (int j = 0; j < L; ++j)
        if (j < m) replay_hour(__ldg(r + j), on, acc, q);
    }
    if (t0 + W < T) __syncthreads();  // tot is written anew
  }
  // the block's sums in a fixed order, in float64: within each warp
  // (lanes l and l + st, st = 16, ..., 1), then over the warps' sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double x[4] = {(double)acc.dp, (double)acc.cap, (double)acc.st,
                 (double)acc.sp};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x[c] = warp_tree(x[c], 32);
    if (lane == 0) wsum[c][warp] = x[c];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const double y = warp_tree(lane < kWarps ? wsum[c][lane] : 0.0, kWarps);
      if (lane == 0) out[(size_t)c * B + row] = (float)y;
    }
  }
}

// L: the fewest hours of kSegs a thread that cover T in one window, or
// the most, in as many windows as it takes
int seg_len(int T) {
  for (int L : kSegs)
    if ((long long)kThreads * L >= T) return L;
  return kSegs[sizeof(kSegs) / sizeof(int) - 1];
}

template <int L, bool V>
int launch(const float* prices, const long long* market_idx,
           const float* p_on, const float* p_off, const float* off_level,
           const float* idle_frac, float* out, int B, int N, int T,
           cudaStream_t s) {
  fleet_scan_kernel<L, V><<<B, kThreads, 0, s>>>(
      prices, market_idx, p_on, p_off, off_level, idle_frac, out, B, N, T);
  ++g_launched;
  return (int)cudaGetLastError();
}

// the kernel of L hours a thread, with 16-byte loads where vec and L % 4 == 0
template <int... Ls>
int launch_seg(int L, bool vec, const float* prices,
               const long long* market_idx, const float* p_on,
               const float* p_off, const float* off_level,
               const float* idle_frac, float* out, int B, int N, int T,
               cudaStream_t s) {
  int rc = (int)cudaErrorInvalidValue;
  ((L == Ls ? (rc = vec ? launch<Ls, Ls % 4 == 0>(prices, market_idx, p_on,
                                                  p_off, off_level, idle_frac,
                                                  out, B, N, T, s)
                        : launch<Ls, false>(prices, market_idx, p_on, p_off,
                                            off_level, idle_frac, out, B, N,
                                            T, s),
                0)
              : 0),
   ...);
  return rc;
}

}  // namespace

extern "C" unsigned long long kernels_launched() {
  return g_launched.load();
}

extern "C" {

// The kernel's layout: threads a row, and the hours a thread owns in a
// window of a row of T hours (ref.fleet_scan_seg_ref takes the same two
// numbers).
int fleet_scan_threads() { return kThreads; }
int fleet_scan_seg(int T) { return seg_len(T); }

// prices: [N, T] row-major float32; market_idx: [B] int64 with values in
// [0, N), or null (then N == B and row b reads prices row b); p_on, p_off,
// off_level, idle_frac: [B]; out: [4, B]. Launches one kernel on `stream`
// and returns cudaGetLastError().
int fleet_scan_f32(const float* prices, const long long* market_idx,
                   const float* p_on, const float* p_off,
                   const float* off_level, const float* idle_frac, float* out,
                   int B, int N, int T, void* stream) {
  if (B <= 0 || N <= 0 || T <= 0 || (market_idx == nullptr && N != B))
    return (int)cudaErrorInvalidValue;
  const bool vec =
      T % 4 == 0 && reinterpret_cast<std::uintptr_t>(prices) % 16 == 0;
  return launch_seg<FLEET_SEGS>(seg_len(T), vec, prices, market_idx, p_on,
                                p_off, off_level, idle_frac, out, B, N, T,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
