// Relaxed (temperature-tau) hysteresis scan and its VJP for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair of repro/kernels/soft_scan_vjp.py:
// _fwd_kernel (forward, :185) and _bwd_kernel (backward, :216), the hot
// loop of every step of repro.tune. Per row b of a [B, T] float32 price
// block, with sigmoid gates a_t = sig((p_on - p_t) / tau),
// f_t = sig((p_t - p_off) / tau) (sig(x) = 1 / (1 + expf(-x)), the form of
// repro_torch.kernels.ref):
//
//   forward   s_t = alpha_t s_{t-1} + beta_t,  alpha = (1 - a)(1 - f),
//             beta = a, s_{-1} = 1; outputs s [B, T] and the state entering
//             each block of `chunk` hours, carries [B, n_chunks] (the only
//             residual the backward needs);
//   backward  given g = dL/ds [B, T]: the adjoint u_t = g_t + alpha_{t+1}
//             u_{t+1} and the per-hour chain rule of ref.soft_gate_grad;
//             outputs d_p [B, T] (optional) and per-row sums of d_p_on,
//             d_p_off and d_inv_tau, [3, B].
//
// Design: one launch a call, one block of kThreads (NT) threads a row.
// Each thread owns L consecutive hours of a window of W = NT x L hours;
// L <= kSeg is set from T alone (as few windows as fit, then the shortest
// L): the tuner's 2190 hours are one window of 256 x 9, 8760 hours three of
// 256 x 12. Each thread loads its own run of L hours straight from the row
// (the first touch of a line brings it to L1 for its neighbours); staging
// the window in shared memory with coalesced loads (kStage) was slower on
// the card, 12 hours a thread at most faster than 8 or 16, and 256 threads
// a row faster than 128 or 512 at the tuner's shape (scan_probe.py, PERF.md).
// Per window:
//   forward:  each thread evaluates its hours' gates once, keeps a_t and
//             alpha_t in registers and composes its segment's map
//             s -> A s + Bc in float64; one block-wide inclusive scan of
//             the maps (warp shuffles, then the warp totals folded in order
//             from the window's entering state) gives each thread its
//             entering state, rounded once to float32; the thread reruns its hours
//             in float32 into shared memory, writes the carries it holds,
//             and the block stores s coalesced. The window's exit state
//             carries to the next window in float64.
//   backward: windows from the last to the first. Gates once into
//             registers; compose both the forward maps and the adjoint
//             maps w -> A w + Q (w = alpha_{t1} u_{t1} handed back
//             by the hour after the segment) in float64, and scan both in
//             one pass: a prefix scan from the window's entering state, a
//             suffix scan from the later window's seed (0 after T - 1).
//             The entering state is the carry where the window starts on a
//             block boundary (always, at NT = 256 and a chunk dividing
//             256 L: the tuner's 256); elsewhere the block sweeps forward
//             from the carry of the block the window starts in, in pieces
//             of W hours (compose and scan only; quadratic in the windows
//             of one block, which only a chunk above W gives). Each thread
//             reruns its states in float32, walks its hours backwards,
//             applies soft_gate_grad, writes d_p through shared memory and
//             adds the three sums in float64. At the end a tree in shared
//             memory, in a fixed order, reduces the sums over the block.
// No scratch, no atomics: every launch gives the same bits (the
// checkpointed tuner's resume contract). ref.soft_scan_fwd_seg_ref and
// soft_scan_bwd_seg_ref do exactly what these kernels do; this file is
// compiled with -fmad=false (build.SOURCE_FLAGS) so that every float32 and
// float64 operation rounds once, as those mirrors' do, and the two agree
// bit for bit on the card. The gates keep the plain versions' bits (expf
// and IEEE division, no fast-math intrinsics).
//
// Bound on an H100 SXM: bytes. The forward reads the prices once and writes
// the states once (8 B a row-hour: 4.49 MB at 256 x 2190, 1.34 us at 3.35
// TB/s; 71.8 MB at 1024 x 8760, 21.4 us); the backward reads prices and g
// and writes d_p when asked (8 or 12 B a row-hour). Each row-hour costs
// ~20 (forward) to ~45 (backward) float32 operations, far below 67 TFLOP/s.
// At 256 x 2190 the time is one launch's fixed cost (5.2 us on an H100 SXM
// at 700 W for both kernels returning at once: scan_probe.py's empty
// kernels) plus one block's serial path: a load, 9 hours of gates, a
// 5-step shuffle scan and an 8-warp fold, 9 hours of rerun, a store. The
// design this replaces ran 3 (forward) and 4
// (backward) launches on a (2, 9) grid of 128 threads, 2304 threads at
// 256 x 2190 each walking 256 hours serially, and evaluated each
// row-hour's gates 2 (forward) and 4 (backward) times; this one runs
// 65536 threads at that shape, evaluates the gates once a row-hour (plus
// the sweep's hours where a window starts inside a block) and launches
// once.
//
// Budget at NT = 256: L <= 12 hours a thread in registers (a_t, alpha_t in
// the forward; a_t, f_t and s_{t-1} in the backward): ptxas reports 80
// (forward) and 125 (backward) registers a thread, so an SM holds three
// and two blocks; shared memory 4 (W + W / 32 + 1) bytes for a window's
// outputs (12.4 KB at W = 3072; with kStage the inputs too), plus the warp
// totals (2 or 4 doubles a warp) and the backward's tree (3 x NT doubles,
// 6 KB).

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

// Kernels this library has launched in this process, counted on the host
// where each launch is issued; kernels_launched() reads it, and the
// wrappers count a call's launches on the card as its difference.
std::atomic<unsigned long long> g_launched{0};

constexpr int kThreads = 256;  // NT: threads a block, one block a row
constexpr int kSeg = 12;        // the most hours a thread owns in a window
constexpr bool kStage = false;  // inputs through shared memory (coalesced)
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float sig(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// a staged hour's place in shared memory: one float of padding every 32,
// so that a thread's run of L hours and its neighbours' fall in other banks
__host__ __device__ __forceinline__ int slot(int k) { return k + (k >> 5); }

__host__ __device__ __forceinline__ int staged_floats(int w) {
  return slot(w) + 1;
}

// dst[slot(i)] = src[i] for i < n (n <= kThreads x kSeg), coalesced: every
// load of the window in flight at once, then the stores
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
  if (!kStage) return;
  float v[kSeg];
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < n) v[j] = __ldg(src + i);
  }
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < n) dst[slot(i)] = v[j];
  }
}

// stage() of two rows at once (the backward's prices and g)
__device__ __forceinline__ void stage2(float* dst0,
                                       const float* __restrict__ src0,
                                       float* dst1,
                                       const float* __restrict__ src1, int n) {
  if (!kStage) return;
  float v0[kSeg], v1[kSeg];
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < n) {
      v0[j] = __ldg(src0 + i);
      v1[j] = __ldg(src1 + i);
    }
  }
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < n) {
      dst0[slot(i)] = v0[j];
      dst1[slot(i)] = v1[j];
    }
  }
}

// the input at hour k of the window: staged, or straight from the row
__device__ __forceinline__ float input(const float* sh,
                                       const float* __restrict__ src, int k) {
  return kStage ? sh[slot(k)] : __ldg(src + k);
}

__device__ __forceinline__ void store(float* __restrict__ dst, const float* src,
                                      int n) {
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < n) dst[i] = src[slot(i)];
  }
}

// The maps compose as (A, B) after (Ap, Bp) = (A Ap, A Bp + B), for the
// forward's s -> A s + B and the adjoint's w -> A w + Q alike. Inclusive
// Kogge-Stone scans over a warp: in lane order (the forward: a lane's map
// after its lower lanes'), or against it (the adjoint: after its higher).
__device__ __forceinline__ void warp_prefix(double& A, double& B, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double ap = __shfl_up_sync(kAll, A, d);
    const double bp = __shfl_up_sync(kAll, B, d);
    if (lane >= d) {
      B = A * bp + B;
      A = A * ap;
    }
  }
}

__device__ __forceinline__ void warp_suffix(double& A, double& B, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double ap = __shfl_down_sync(kAll, A, d);
    const double bp = __shfl_down_sync(kAll, B, d);
    if (lane + d < 32) {
      B = A * bp + B;
      A = A * ap;
    }
  }
}

// The forward scan of one window. In: the thread's segment map (A, B) and
// the window's entering state s. Returns the state entering the thread's
// segment; s becomes the window's exit state. Holds one __syncthreads.
__device__ __forceinline__ double block_prefix(double A, double B, double& s,
                                               double* totA, double* totB) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_prefix(A, B, lane);
  double ae = __shfl_up_sync(kAll, A, 1), be = __shfl_up_sync(kAll, B, 1);
  if (lane == 0) {
    ae = 1.0;
    be = 0.0;
  }
  if (lane == 31) {
    totA[warp] = A;
    totB[warp] = B;
  }
  __syncthreads();
  double x = s, xw = s;
  for (int k = 0; k < kWarps; ++k) {
    if (k == warp) xw = x;
    x = totA[k] * x + totB[k];
  }
  s = x;
  return ae * xw + be;
}

// The adjoint scan of one window: as block_prefix, against the lane order,
// from the seed w handed back by the later window; w becomes what this
// window hands back (alpha_{t0} u_{t0}).
__device__ __forceinline__ double block_suffix(double A, double Q, double& w,
                                               double* totA, double* totQ) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_suffix(A, Q, lane);
  double ae = __shfl_down_sync(kAll, A, 1), qe = __shfl_down_sync(kAll, Q, 1);
  if (lane == 31) {
    ae = 1.0;
    qe = 0.0;
  }
  if (lane == 0) {
    totA[warp] = A;
    totQ[warp] = Q;
  }
  __syncthreads();
  double x = w, xw = w;
  for (int k = kWarps - 1; k >= 0; --k) {
    if (k == warp) xw = x;
    x = totA[k] * x + totQ[k];
  }
  w = x;
  return ae * xw + qe;
}

struct Row {
  float p_on, p_off, itau;
  __device__ __forceinline__ void gates(float p, float& a, float& f) const {
    a = sig((p_on - p) * itau);
    f = sig((p - p_off) * itau);
  }
};

// The forward map of the n hours at src (n <= W), composed and scanned by
// the block from s, which becomes the state after them (the backward's
// sweep from a carry to a window that starts inside a block).
__device__ void sweep(const float* __restrict__ src, int n, int L,
                      const Row& q, float* sp, double& s, double* totA,
                      double* totB) {
  stage(sp, src, n);
  __syncthreads();
  const int k0 = threadIdx.x * L;
  double A = 1.0, B = 0.0;
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    if (j < L && k0 + j < n) {
      float a, f;
      q.gates(input(sp, src, k0 + j), a, f);
      const double al = (double)((1.0f - a) * (1.0f - f));
      A = al * A;
      B = al * B + (double)a;
    }
  }
  block_prefix(A, B, s, totA, totB);
}

// ---- forward -------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) soft_fwd_kernel(
    const float* __restrict__ prices, const float* __restrict__ p_on,
    const float* __restrict__ p_off, const float* __restrict__ itau,
    float* __restrict__ s_out, float* __restrict__ carries, int T, int chunk,
    int L, int nc) {
  extern __shared__ float sp[];  // a window's prices, then its states
  __shared__ double totA[kWarps], totB[kWarps];
  const int row = blockIdx.x;
  const Row q = {p_on[row], p_off[row], itau[0]};
  const float* src_row = prices + (size_t)row * T;
  float* out_row = s_out + (size_t)row * T;
  float* carr_row = carries + (size_t)row * nc;
  const int W = kThreads * L;
  const int k0 = threadIdx.x * L;
  if (threadIdx.x == 0) carr_row[0] = 1.0f;
  double s_in = 1.0;  // s_{-1}
  for (int t0 = 0; t0 < T; t0 += W) {
    const int n = min(W, T - t0);
    const float* src = src_row + t0;
    stage(sp, src, n);
    __syncthreads();
    float a[kSeg], al[kSeg];
    double A = 1.0, B = 0.0;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      if (j < L && k0 + j < n) {
        float f;
        q.gates(input(sp, src, k0 + j), a[j], f);
        al[j] = (1.0f - a[j]) * (1.0f - f);
        A = (double)al[j] * A;
        B = (double)al[j] * B + (double)a[j];
      }
    }
    float s = (float)block_prefix(A, B, s_in, totA, totB);
    // the last hour of the block holding this thread's first hour
    const long long h0 = (long long)t0 + k0;
    long long hb = (h0 / chunk + 1) * chunk - 1;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      if (j < L && k0 + j < n) {
        s = al[j] * s + a[j];
        sp[slot(k0 + j)] = s;
        if (h0 + j == hb) {
          if (hb + 1 < T) carr_row[(hb + 1) / chunk] = s;
          hb += chunk;
        }
      }
    }
    __syncthreads();
    store(out_row + t0, sp, n);
    __syncthreads();
  }
}

// ---- backward ------------------------------------------------------------

// d_p may be null (prices need no gradient)
__global__ void __launch_bounds__(kThreads) soft_bwd_kernel(
    const float* __restrict__ prices, const float* __restrict__ g,
    const float* __restrict__ p_on, const float* __restrict__ p_off,
    const float* __restrict__ itau, const float* __restrict__ carries,
    float* __restrict__ d_p, float* __restrict__ sums, int B, int T,
    int chunk, int L, int nc) {
  extern __shared__ float smem[];
  __shared__ double totA[kWarps], totB[kWarps], totC[kWarps], totQ[kWarps];
  __shared__ double red[3][kThreads];
  const int row = blockIdx.x;
  const Row q = {p_on[row], p_off[row], itau[0]};
  const int W = kThreads * L;
  float* sp = smem;                     // (prices, then) d_p
  float* sg = smem + staged_floats(W);  // g, where staged
  const float* p_row = prices + (size_t)row * T;
  const float* g_row = g + (size_t)row * T;
  const float* carr_row = carries + (size_t)row * nc;
  const int k0 = threadIdx.x * L;
  const int nw = (T + W - 1) / W;
  double w_in = 0.0;  // alpha_{t1} u_{t1} from the later window
  double acc_on = 0.0, acc_off = 0.0, acc_it = 0.0;
  for (int wi = nw - 1; wi >= 0; --wi) {
    const int t0 = wi * W;
    const int n = min(W, T - t0);
    // the state entering the window: its block's carry, swept forward to
    // t0 where the window starts inside the block
    const int c = t0 / chunk;
    double s_in = (double)carr_row[c];
    for (long long h = (long long)c * chunk; h < t0; h += W)
      sweep(p_row + h, (int)min((long long)W, t0 - h), L, q, sp, s_in, totA,
            totB);
    const float* psrc = p_row + t0;
    const float* gsrc = g_row + t0;
    stage2(sp, psrc, sg, gsrc, n);
    __syncthreads();
    float a[kSeg], f[kSeg], sprev[kSeg];
    double A = 1.0, Bc = 0.0;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      if (j < L && k0 + j < n) {
        q.gates(input(sp, psrc, k0 + j), a[j], f[j]);
        const double al = (double)((1.0f - a[j]) * (1.0f - f[j]));
        A = al * A;
        Bc = al * Bc + (double)a[j];
      }
    }
    double Aa = 1.0, Q = 0.0;
#pragma unroll
    for (int j = kSeg - 1; j >= 0; --j) {
      if (j < L && k0 + j < n) {
        const double al = (double)((1.0f - a[j]) * (1.0f - f[j]));
        const double u = (double)input(sg, gsrc, k0 + j) + Q;
        Q = al * u;
        Aa = al * Aa;
      }
    }
    float s = (float)block_prefix(A, Bc, s_in, totA, totB);
    float w = (float)block_suffix(Aa, Q, w_in, totC, totQ);
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      if (j < L && k0 + j < n) {
        sprev[j] = s;
        s = ((1.0f - a[j]) * (1.0f - f[j])) * s + a[j];
      }
    }
#pragma unroll
    for (int j = kSeg - 1; j >= 0; --j) {
      if (j < L && k0 + j < n) {
        const float p = input(sp, psrc, k0 + j);
        const float u = input(sg, gsrc, k0 + j) + w;
        // ref.soft_gate_grad, term for term
        const float d_alpha = u * sprev[j];
        const float d_a = u - d_alpha * (1.0f - f[j]);
        const float d_f = -d_alpha * (1.0f - a[j]);
        const float d_zon = d_a * a[j] * (1.0f - a[j]);
        const float d_zoff = d_f * f[j] * (1.0f - f[j]);
        acc_on += (double)(d_zon * q.itau);
        acc_off += (double)(-d_zoff * q.itau);
        acc_it += (double)(d_zon * (q.p_on - p) + d_zoff * (p - q.p_off));
        w = ((1.0f - a[j]) * (1.0f - f[j])) * u;
        sp[slot(k0 + j)] = (d_zoff - d_zon) * q.itau;
      }
    }
    __syncthreads();
    if (d_p != nullptr) store(d_p + (size_t)row * T + t0, sp, n);
    __syncthreads();
  }
  // the block's sums, in a fixed order
  red[0][threadIdx.x] = acc_on;
  red[1][threadIdx.x] = acc_off;
  red[2][threadIdx.x] = acc_it;
  __syncthreads();
  for (int st = kThreads / 2; st > 0; st >>= 1) {
    if (threadIdx.x < st) {
      red[0][threadIdx.x] += red[0][threadIdx.x + st];
      red[1][threadIdx.x] += red[1][threadIdx.x + st];
      red[2][threadIdx.x] += red[2][threadIdx.x + st];
    }
    __syncthreads();
  }
  if (threadIdx.x < 3) sums[(size_t)threadIdx.x * B + row] =
      (float)red[threadIdx.x][0];
}

// L: as few windows of at most kThreads x kSeg hours as cover T, then the
// fewest hours a thread that still covers T in that many windows
int seg_len(int T) {
  const long long nw = (T + (long long)kThreads * kSeg - 1) / (kThreads * kSeg);
  return (int)((T + nw * kThreads - 1) / (nw * kThreads));
}

bool bad_shape(int B, int T, int chunk) {
  return B <= 0 || T <= 0 || chunk <= 0;
}

}  // namespace

extern "C" unsigned long long kernels_launched() {
  return g_launched.load();
}

extern "C" {

// prices: [B, T] row-major float32; p_on, p_off: [B]; itau: [1] (1 / tau);
// s: [B, T]; carries: [B, ceil(T / chunk)]; chunk: any positive number of
// hours. Launches one kernel on `stream`, returns cudaGetLastError().
int soft_scan_fwd_f32(const float* prices, const float* p_on,
                      const float* p_off, const float* itau, float* s,
                      float* carries, int B, int T, int chunk, void* stream) {
  if (bad_shape(B, T, chunk)) return (int)cudaErrorInvalidValue;
  const int L = seg_len(T);
  const int nc = (int)(((long long)T + chunk - 1) / chunk);
  const size_t smem = sizeof(float) * staged_floats(kThreads * L);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(soft_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  soft_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      prices, p_on, p_off, itau, s, carries, T, chunk, L, nc);
  ++g_launched;
  return (int)cudaGetLastError();
}

// prices, g: [B, T] row-major float32; p_on, p_off: [B]; itau: [1];
// carries: [B, ceil(T / chunk)] from soft_scan_fwd_f32 with the same chunk;
// d_p: [B, T] or null; sums: [3, B] (d_p_on, d_p_off, d_inv_tau per row).
// Launches one kernel on `stream`, returns cudaGetLastError().
int soft_scan_bwd_f32(const float* prices, const float* g, const float* p_on,
                      const float* p_off, const float* itau,
                      const float* carries, float* d_p, float* sums, int B,
                      int T, int chunk, void* stream) {
  if (bad_shape(B, T, chunk)) return (int)cudaErrorInvalidValue;
  const int L = seg_len(T);
  const int nc = (int)(((long long)T + chunk - 1) / chunk);
  // d_p through shared memory; g beside it where the inputs are staged
  const size_t smem =
      (kStage ? 2 : 1) * sizeof(float) * staged_floats(kThreads * L);
  cudaError_t err = cudaSuccess;
  if (smem + sizeof(double) * (4 * kWarps + 3 * kThreads) > 48 * 1024)
    err = cudaFuncSetAttribute(soft_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  soft_bwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      prices, g, p_on, p_off, itau, carries, d_p, sums, B, T, chunk, L, nc);
  ++g_launched;
  return (int)cudaGetLastError();
}

}  // extern "C"
