// Relaxed (temperature-tau) hysteresis scan and its VJP for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair of repro/kernels/soft_scan_vjp.py:
// _fwd_kernel (forward) and _bwd_kernel (backward), the hot loop of every
// step of repro.tune. Per row b of a [B, T] float32 price block, with
// sigmoid gates a_t = sig((p_on - p_t) / tau), f_t = sig((p_t - p_off) / tau)
// (sig(x) = 1 / (1 + expf(-x)), the form of repro_torch.kernels.ref):
//
//   forward   s_t = alpha_t s_{t-1} + beta_t,  alpha = (1 - a)(1 - f),
//             beta = a, s_{-1} = 1; outputs s [B, T] and the state entering
//             each chunk of `chunk` hours, carries [B, n_chunks] (the only
//             residual the backward needs);
//   backward  given g = dL/ds [B, T]: the adjoint u_t = g_t + alpha_{t+1}
//             u_{t+1} and the per-hour chain rule of ref.soft_gate_grad;
//             outputs d_p [B, T] (optional) and per-row sums of d_p_on,
//             d_p_off and d_inv_tau, [3, B].
//
// Design. The TPU grid walks time blocks in order with the state in VMEM;
// CUDA blocks run in no order. The recurrence is affine, so a chunk of
// hours composes to one map s -> A s + B, and both directions run in three
// stages over (row tile of 128, chunk):
//   forward:  1 compose each chunk's (A, B) in float64; 2 one thread per
//             row stitches the chunks in order from s = 1 and writes the
//             carries; 3 rerun each chunk from its carry and write s.
//   backward: 1 compose each chunk's adjoint map w -> A w + alpha_t0 Q_t0
//             (A is the chunk's alpha product, Q the adjoint from a zero
//             seed), walking the chunk backwards; 2 stitch the seeds from
//             the last chunk to the first; 3 per chunk: recompute the
//             states from the carry (their 32-hour sub-tile entry states go
//             to scratch on a forward walk, then each sub-tile is rerun into
//             registers), run the adjoint backwards, apply soft_gate_grad,
//             write d_p and the chunk's partial sums; 4 reduce the partial
//             sums per row, last chunk first (the reference's order).
// Sums and composed maps are float64 and every reduction runs in a fixed
// order: no atomics, so every launch gives the same bits (the checkpointed
// tuner's resume contract).
//
// Coalescing: as in fleet_scan.cu, each block stages [128 rows x 32 hours]
// tiles of the row-major block through shared memory (row pitch 33 floats,
// no bank conflicts); outputs leave through the same tile, transposed back.
//
// Bound on an H100 SXM: bytes. The forward must read the prices once and
// write the states once (8 B per row-hour: 71.8 MB at 1024 x 8760, 21 us at
// 3.35 TB/s); the backward reads prices and g and writes d_p (12 B per
// row-hour). Each row-hour costs about 25 float32 operations (two expf,
// the gates, the recurrence), far below 67 TFLOP/s. The design reads the
// price block twice in the forward and three times in the backward (the
// compose pass, then the apply pass), so ~2x the bytes of the bound; the
// repeat reads come from L2 where the block fits.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

// Kernels this library has launched in this process, counted on the host
// where each launch is issued; kernels_launched() reads it, and the
// wrappers count a call's launches on the card as its difference.
std::atomic<unsigned long long> g_launched{0};

constexpr int kRows = 128;  // rows per block = threads per block
constexpr int kTile = 32;   // hours staged through shared memory at a time

__device__ __forceinline__ float sig(float x) {
  return 1.0f / (1.0f + expf(-x));
}

struct RowGates {
  float p_on, p_off, itau;
  __device__ __forceinline__ void at(float p, float& a, float& f) const {
    a = sig((p_on - p) * itau);
    f = sig((p - p_off) * itau);
  }
};

// tile[r][lane] = src[(r0 + r) * T + h0 + lane], zero outside [0,B)x[h0,t1)
__device__ __forceinline__ void load_tile(float (*tile)[kTile + 1],
                                          const float* __restrict__ src,
                                          int r0, int h0, int t1, int B,
                                          int T) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = h0 + lane;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const int r = warp * 32 + j;
    const int g = r0 + r;
    tile[r][lane] = (g < B && t < t1) ? src[(size_t)g * T + t] : 0.0f;
  }
}

__device__ __forceinline__ void store_tile(float (*tile)[kTile + 1],
                                           float* __restrict__ dst, int r0,
                                           int h0, int t1, int B, int T) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = h0 + lane;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const int r = warp * 32 + j;
    const int g = r0 + r;
    if (g < B && t < t1) dst[(size_t)g * T + t] = tile[r][lane];
  }
}

__device__ __forceinline__ RowGates row_gates(const float* p_on,
                                              const float* p_off,
                                              const float* itau, int row,
                                              bool live) {
  RowGates q = {0.f, 0.f, itau[0]};
  if (live) {
    q.p_on = p_on[row];
    q.p_off = p_off[row];
  }
  return q;
}

// ---- forward -------------------------------------------------------------

// maps: [n_chunks][2][B] doubles, the chunk's s -> A s + Bc
__global__ void __launch_bounds__(kRows) soft_fwd_compose(
    const float* __restrict__ prices, const float* __restrict__ p_on,
    const float* __restrict__ p_off, const float* __restrict__ itau,
    double* __restrict__ maps, int B, int T, int chunk) {
  __shared__ float tile[kRows][kTile + 1];
  const int r0 = blockIdx.x * kRows;
  const int row = r0 + threadIdx.x;
  const int c = blockIdx.y;
  const int t0 = c * chunk;
  const int t1 = min(t0 + chunk, T);
  const bool live = row < B;
  const RowGates q = row_gates(p_on, p_off, itau, row, live);
  double A = 1.0, Bc = 0.0;
  for (int h0 = t0; h0 < t1; h0 += kTile) {
    load_tile(tile, prices, r0, h0, t1, B, T);
    __syncthreads();
    const int n = min(kTile, t1 - h0);
    for (int k = 0; k < n; ++k) {
      float a, f;
      q.at(tile[threadIdx.x][k], a, f);
      const double alpha = (double)((1.0f - a) * (1.0f - f));
      A = alpha * A;
      Bc = alpha * Bc + (double)a;
    }
    __syncthreads();
  }
  if (live) {
    maps[((size_t)c * 2 + 0) * B + row] = A;
    maps[((size_t)c * 2 + 1) * B + row] = Bc;
  }
}

// carries: [B][n_chunks], the state entering each chunk
__global__ void soft_fwd_stitch(const double* __restrict__ maps,
                                float* __restrict__ carries, int B,
                                int n_chunks) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  double s = 1.0;
  for (int c = 0; c < n_chunks; ++c) {
    carries[(size_t)row * n_chunks + c] = (float)s;
    s = maps[((size_t)c * 2 + 0) * B + row] * s +
        maps[((size_t)c * 2 + 1) * B + row];
  }
}

__global__ void __launch_bounds__(kRows) soft_fwd_apply(
    const float* __restrict__ prices, const float* __restrict__ p_on,
    const float* __restrict__ p_off, const float* __restrict__ itau,
    const float* __restrict__ carries, float* __restrict__ s_out, int B,
    int T, int chunk, int n_chunks) {
  __shared__ float tile[kRows][kTile + 1];
  const int r0 = blockIdx.x * kRows;
  const int row = r0 + threadIdx.x;
  const int c = blockIdx.y;
  const int t0 = c * chunk;
  const int t1 = min(t0 + chunk, T);
  const bool live = row < B;
  const RowGates q = row_gates(p_on, p_off, itau, row, live);
  float s = live ? carries[(size_t)row * n_chunks + c] : 1.0f;
  for (int h0 = t0; h0 < t1; h0 += kTile) {
    load_tile(tile, prices, r0, h0, t1, B, T);
    __syncthreads();
    const int n = min(kTile, t1 - h0);
    for (int k = 0; k < n; ++k) {
      float a, f;
      q.at(tile[threadIdx.x][k], a, f);
      s = ((1.0f - a) * (1.0f - f)) * s + a;
      tile[threadIdx.x][k] = s;
    }
    __syncthreads();
    store_tile(tile, s_out, r0, h0, t1, B, T);
    __syncthreads();
  }
}

// ---- backward ------------------------------------------------------------

// maps: [n_chunks][2][B] doubles, the chunk's seed map w -> A w + Bc, where
// w is alpha_{t1} u_{t1}, what the hour after the chunk hands back
__global__ void __launch_bounds__(kRows) soft_bwd_compose(
    const float* __restrict__ prices, const float* __restrict__ g,
    const float* __restrict__ p_on, const float* __restrict__ p_off,
    const float* __restrict__ itau, double* __restrict__ maps, int B, int T,
    int chunk) {
  __shared__ float ptile[kRows][kTile + 1];
  __shared__ float gtile[kRows][kTile + 1];
  const int r0 = blockIdx.x * kRows;
  const int row = r0 + threadIdx.x;
  const int c = blockIdx.y;
  const int t0 = c * chunk;
  const int t1 = min(t0 + chunk, T);
  const bool live = row < B;
  const RowGates q = row_gates(p_on, p_off, itau, row, live);
  double A = 1.0, w = 0.0;  // w: alpha_t u_t of the hour just walked
  const int last = t0 + ((t1 - 1 - t0) / kTile) * kTile;
  for (int h0 = last; h0 >= t0; h0 -= kTile) {
    load_tile(ptile, prices, r0, h0, t1, B, T);
    load_tile(gtile, g, r0, h0, t1, B, T);
    __syncthreads();
    const int n = min(kTile, t1 - h0);
    for (int k = n - 1; k >= 0; --k) {
      float a, f;
      q.at(ptile[threadIdx.x][k], a, f);
      const double alpha = (double)((1.0f - a) * (1.0f - f));
      const double u = (double)gtile[threadIdx.x][k] + w;
      w = alpha * u;
      A = alpha * A;
    }
    __syncthreads();
  }
  if (live) {
    maps[((size_t)c * 2 + 0) * B + row] = A;
    maps[((size_t)c * 2 + 1) * B + row] = w;
  }
}

// seeds: [n_chunks][B] doubles, the w entering each chunk from the right
__global__ void soft_bwd_stitch(const double* __restrict__ maps,
                                double* __restrict__ seeds, int B,
                                int n_chunks) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  double w = 0.0;  // no hours after T - 1
  for (int c = n_chunks - 1; c >= 0; --c) {
    seeds[(size_t)c * B + row] = w;
    w = maps[((size_t)c * 2 + 0) * B + row] * w +
        maps[((size_t)c * 2 + 1) * B + row];
  }
}

// sub: [n_chunks * chunk / 32][B] floats of scratch (sub-tile entry
// states); part: [3][n_chunks][B] doubles (per-chunk partial sums);
// d_p may be null (prices need no gradient)
__global__ void __launch_bounds__(kRows) soft_bwd_apply(
    const float* __restrict__ prices, const float* __restrict__ g,
    const float* __restrict__ p_on, const float* __restrict__ p_off,
    const float* __restrict__ itau, const float* __restrict__ carries,
    const double* __restrict__ seeds, float* __restrict__ sub,
    double* __restrict__ part, float* __restrict__ d_p, int B, int T,
    int chunk, int n_chunks) {
  __shared__ float ptile[kRows][kTile + 1];
  __shared__ float gtile[kRows][kTile + 1];
  const int r0 = blockIdx.x * kRows;
  const int row = r0 + threadIdx.x;
  const int c = blockIdx.y;
  const int t0 = c * chunk;
  const int t1 = min(t0 + chunk, T);
  const bool live = row < B;
  const RowGates q = row_gates(p_on, p_off, itau, row, live);
  const int n_sub = chunk / kTile;
  const size_t sub0 = (size_t)c * n_sub;

  // forward walk: the state entering each 32-hour sub-tile
  float s = live ? carries[(size_t)row * n_chunks + c] : 1.0f;
  for (int h0 = t0, k = 0; h0 < t1; h0 += kTile, ++k) {
    if (live) sub[(sub0 + k) * B + row] = s;
    load_tile(ptile, prices, r0, h0, t1, B, T);
    __syncthreads();
    const int n = min(kTile, t1 - h0);
    for (int j = 0; j < n; ++j) {
      float a, f;
      q.at(ptile[threadIdx.x][j], a, f);
      s = ((1.0f - a) * (1.0f - f)) * s + a;
    }
    __syncthreads();
  }

  // backward walk, sub-tile by sub-tile from the last
  float w = live ? (float)seeds[(size_t)c * B + row] : 0.0f;
  double acc_on = 0.0, acc_off = 0.0, acc_it = 0.0;
  const int last = (t1 - 1 - t0) / kTile;
  for (int k = last; k >= 0; --k) {
    const int h0 = t0 + k * kTile;
    const int n = min(kTile, t1 - h0);
    load_tile(ptile, prices, r0, h0, t1, B, T);
    load_tile(gtile, g, r0, h0, t1, B, T);
    __syncthreads();
    float sp[kTile];  // s_{t-1} of each hour of the sub-tile
    float st = live ? sub[(sub0 + k) * B + row] : 1.0f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      sp[j] = st;
      float a, f;
      q.at(ptile[threadIdx.x][j], a, f);
      st = ((1.0f - a) * (1.0f - f)) * st + a;
    }
#pragma unroll
    for (int j = kTile - 1; j >= 0; --j) {
      float dp = 0.0f;
      if (j < n) {
        const float p = ptile[threadIdx.x][j];
        float a, f;
        q.at(p, a, f);
        const float u = gtile[threadIdx.x][j] + w;
        // ref.soft_gate_grad, term for term
        const float d_alpha = u * sp[j];
        const float d_a = u - d_alpha * (1.0f - f);
        const float d_f = -d_alpha * (1.0f - a);
        const float d_zon = d_a * a * (1.0f - a);
        const float d_zoff = d_f * f * (1.0f - f);
        dp = (d_zoff - d_zon) * q.itau;
        acc_on += (double)(d_zon * q.itau);
        acc_off += (double)(-d_zoff * q.itau);
        acc_it += (double)(d_zon * (q.p_on - p) + d_zoff * (p - q.p_off));
        w = ((1.0f - a) * (1.0f - f)) * u;
      }
      ptile[threadIdx.x][j] = dp;
    }
    __syncthreads();
    if (d_p != nullptr) store_tile(ptile, d_p, r0, h0, t1, B, T);
    __syncthreads();
  }
  if (live) {
    part[((size_t)0 * n_chunks + c) * B + row] = acc_on;
    part[((size_t)1 * n_chunks + c) * B + row] = acc_off;
    part[((size_t)2 * n_chunks + c) * B + row] = acc_it;
  }
}

// sums: [3][B] floats, the chunks' partial sums added last chunk first
__global__ void soft_bwd_reduce(const double* __restrict__ part,
                                float* __restrict__ sums, int B,
                                int n_chunks) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  for (int q = 0; q < 3; ++q) {
    double acc = 0.0;
    for (int c = n_chunks - 1; c >= 0; --c)
      acc += part[((size_t)q * n_chunks + c) * B + row];
    sums[(size_t)q * B + row] = (float)acc;
  }
}

bool bad_shape(int B, int T, int chunk) {
  if (B <= 0 || T <= 0 || chunk <= 0 || chunk % kTile != 0) return true;
  return (T + chunk - 1) / chunk > 65535;
}

}  // namespace

extern "C" unsigned long long kernels_launched() {
  return g_launched.load();
}

extern "C" {

// Doubles of scratch soft_scan_fwd_f32 needs.
long long soft_scan_fwd_scratch_doubles(int B, int T, int chunk) {
  return 2LL * ((T + chunk - 1) / chunk) * B;
}

// Doubles of scratch soft_scan_bwd_f32 needs: compose maps, seeds, partial
// sums, and (as floats packed into doubles) the sub-tile entry states.
long long soft_scan_bwd_scratch_doubles(int B, int T, int chunk) {
  const long long nc = (T + chunk - 1) / chunk;
  const long long sub_floats = nc * (chunk / kTile) * B;
  return 2 * nc * B + nc * B + 3 * nc * B + (sub_floats + 1) / 2;
}

// prices: [B, T] row-major float32; p_on, p_off: [B]; itau: [1] (1 / tau);
// s: [B, T]; carries: [B, ceil(T / chunk)]; chunk: a positive multiple of
// 32. Launches the three forward stages on `stream`, returns
// cudaGetLastError().
int soft_scan_fwd_f32(const float* prices, const float* p_on,
                      const float* p_off, const float* itau, double* scratch,
                      float* s, float* carries, int B, int T, int chunk,
                      void* stream) {
  if (bad_shape(B, T, chunk)) return (int)cudaErrorInvalidValue;
  const int nc = (T + chunk - 1) / chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kRows - 1) / kRows, nc);
  soft_fwd_compose<<<grid, kRows, 0, st>>>(prices, p_on, p_off, itau, scratch,
                                           B, T, chunk);
  ++g_launched;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  soft_fwd_stitch<<<(B + 255) / 256, 256, 0, st>>>(scratch, carries, B, nc);
  ++g_launched;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  soft_fwd_apply<<<grid, kRows, 0, st>>>(prices, p_on, p_off, itau, carries,
                                         s, B, T, chunk, nc);
  ++g_launched;
  return (int)cudaGetLastError();
}

// prices, g: [B, T] row-major float32; p_on, p_off: [B]; itau: [1];
// carries: [B, ceil(T / chunk)] from soft_scan_fwd_f32 with the same chunk;
// d_p: [B, T] or null; sums: [3, B] (d_p_on, d_p_off, d_inv_tau per row).
// Launches the four backward stages on `stream`, returns cudaGetLastError().
int soft_scan_bwd_f32(const float* prices, const float* g, const float* p_on,
                      const float* p_off, const float* itau,
                      const float* carries, double* scratch, float* d_p,
                      float* sums, int B, int T, int chunk, void* stream) {
  if (bad_shape(B, T, chunk)) return (int)cudaErrorInvalidValue;
  const int nc = (T + chunk - 1) / chunk;
  double* maps = scratch;                        // [nc][2][B]
  double* seeds = maps + 2 * (size_t)nc * B;     // [nc][B]
  double* part = seeds + (size_t)nc * B;         // [3][nc][B]
  float* sub = reinterpret_cast<float*>(part + 3 * (size_t)nc * B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kRows - 1) / kRows, nc);
  soft_bwd_compose<<<grid, kRows, 0, st>>>(prices, g, p_on, p_off, itau, maps,
                                           B, T, chunk);
  ++g_launched;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  soft_bwd_stitch<<<(B + 255) / 256, 256, 0, st>>>(maps, seeds, B, nc);
  ++g_launched;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  soft_bwd_apply<<<grid, kRows, 0, st>>>(prices, g, p_on, p_off, itau,
                                         carries, seeds, sub, part, d_p, B, T,
                                         chunk, nc);
  ++g_launched;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  soft_bwd_reduce<<<(B + 255) / 256, 256, 0, st>>>(part, sums, B, nc);
  ++g_launched;
  return (int)cudaGetLastError();
}

}  // extern "C"
