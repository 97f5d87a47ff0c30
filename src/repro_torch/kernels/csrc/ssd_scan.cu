// The Mamba2 SSD (state-space duality) chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel
// (entry repro.kernels.ops.ssd_scan, reached from every SSM prefill through
// repro.models.ssm.ssd_chunked(impl="pallas")). Computes what
// repro_torch.kernels.ref.ssd_scan_plain computes: for every batch row b
// and head h (reading B/C group h / (H / G)), over chunks of L positions,
//
//   cum     = cumsum(dt a)                                  per chunk [L]
//   y       = ((C B^T) o Lmat) (x dt) + (C h_in) exp(cum)   [L, P]
//   h_out   = h_in exp(cum_last) + B^T (x dt exp(cum_last - cum))
//
// with Lmat[i, j] = exp(cum_i - cum_j) for j <= i and 0 above the diagonal,
// where the exponent is positive and exp would overflow: it is taken only
// where j <= i. Every input is converted to float32 on load; y and the
// final state are float32. S must be a multiple of L (the wrapper's caller
// zero-pads: a padded dt of 0 decays nothing and adds nothing).
//
// Design. The TPU kernel runs one grid step per (b, h, chunk) in order and
// carries the [N, P] state from chunk to chunk in scratch memory; its
// whole chunk (B and C 128 KB each in float32 at L 256, N 128, the L x L
// scores 256 KB) sits in VMEM. On the H100 neither holds: blocks run in no
// order, and a block has at most 227 KB of shared memory. And one block per
// (b, h) would fill 64 of the 132 SMs at batch 1. So the scan is split in
// three launches, each with many blocks:
//   1. ssd_chunk_state: per (b, h, chunk, 64 x 64 tile of the state): the
//      chunk's cum (a warp scan, written to scratch for the later passes)
//      and the state the chunk adds, B^T (x dt exp(cum_last - cum)),
//      summed over the chunk's positions in slabs of 32;
//   2. ssd_state_pass: per (b, h, state element): the short sequential
//      pass over the chunks, in place: chunk c's slot is overwritten by
//      the state entering chunk c, h <- h exp(cum_last) + chunk c's state;
//      the last h is the final state;
//   3. ssd_chunk_out: per (b, h, chunk, 64-row tile, 64 columns of P): the
//      tile's rows against the key tiles j <= i only, as the flash kernel
//      tiles queries and keys: the 64 x 64 scores C_i B_j^T (N in slabs of
//      32), times Lmat, into shared memory, then their product with the key
//      tile's x dt; then (C_i h_in) exp(cum_i).
// The split costs the states' round trip through device memory (32 KB a
// chunk and head at P 64, N 128) and recomputes C B^T for every head of a
// group where it could be shared; at mamba2-1.3b's serving shape it gives
// 512 + 64 + 1024 blocks for a 1024-token prefill instead of 64. The state
// is carried as [B, H, P, N], the model's layout, so no transposes surround
// the call. x, B, C and dt are read in the model's [B, S, ...] layouts
// through their strides; y is written as [B, S, H, P].
//
// Each block has 256 threads in a 16 x 16 grid, each owning a 4 x 4 patch
// of the 64 x 64 output tile, read from shared memory four floats at a
// time. All products are float32 FMAs on the CUDA cores.
//
// Bound on an H100 SXM: the operations (C B^T once per group and chunk on
// the lower triangle, the scores times x dt, C h_in and B^T (x dt decay)
// for each head) at the 67 TFLOP/s float32 peak, or the bytes of x, dt, B,
// C, y and the states at 3.35 TB/s, whichever is larger; at the serving
// shape the operations bound it. This first kernel recomputes C B^T per
// head, keeps its products off the tensor cores (bf16 C and B would give
// exact float32 products through mma) and does not overlap its loads with
// its arithmetic: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

// Kernels this library has launched in this process, counted on the host
// where each launch is issued; kernels_launched() reads it, and the
// wrappers count a call's launches on the card as its difference.
std::atomic<unsigned long long> g_launched{0};

constexpr int TILE = 64;      // positions / state rows / columns per tile
constexpr int KS = 32;        // contraction slab
constexpr int PAD = TILE + 4; // shared row length (16-byte aligned rows)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Dims {
  int B, S, H, G, P, N, L, nc;
  long long xs0, xs1, xs2;          // x [B, S, H, P], last dim contiguous
  long long ds0, ds1, ds2;          // dt [B, S, H]
  long long bs0, bs1, bs2;          // b [B, S, G, N], last dim contiguous
  long long cs0, cs1, cs2;          // c [B, S, G, N], last dim contiguous
};

// The chunk's da = dt a and its inclusive cumsum, by warp 0: each lane sums
// a run of ceil(L / 32) positions in order, a shuffle scan adds the runs
// before it. Leaves dt in dts[0, L) and cum in cums[0, L).
__device__ void chunk_cum(const float* __restrict__ dt, float a_h,
                          const Dims& d, int b, int h, int s0, float* dts,
                          float* cums) {
  for (int i = threadIdx.x; i < d.L; i += blockDim.x)
    dts[i] = dt[b * d.ds0 + (long long)(s0 + i) * d.ds1 + h * d.ds2];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int run = (d.L + 31) / 32;
    const int lo = min(lane * run, d.L), hi = min(lo + run, d.L);
    float sum = 0.f;
    for (int i = lo; i < hi; ++i) {
      sum += dts[i] * a_h;
      cums[i] = sum;
    }
    float incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const float before = incl - sum;
    for (int i = lo; i < hi; ++i) cums[i] += before;
  }
  __syncthreads();
}

// ---- pass 1: the state each chunk adds -----------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a, const T* __restrict__ bm,
                       float* __restrict__ cum, float* __restrict__ st,
                       Dims d) {
  extern __shared__ __align__(16) float dyn[];
  float* dts = dyn;                  // [L]
  float* cums = dyn + d.L;           // [L]
  __shared__ __align__(16) float ws[KS][PAD];   // x dt decay, positions x p
  __shared__ __align__(16) float bs[KS][PAD];   // B, positions x n
  const int bh = blockIdx.z, b = bh / d.H, h = bh % d.H;
  const int g = h / (d.H / d.G), c = blockIdx.y;
  const int n_tiles_n = (d.N + TILE - 1) / TILE;
  const int n0 = (blockIdx.x % n_tiles_n) * TILE;
  const int p0 = (blockIdx.x / n_tiles_n) * TILE;
  const int s0 = c * d.L;
  chunk_cum(dt, a[h], d, b, h, s0, dts, cums);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < d.L; i += blockDim.x)
      cum[(long long)bh * d.S + s0 + i] = cums[i];
  const float last = cums[d.L - 1];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int l0 = 0; l0 < d.L; l0 += KS) {
    for (int e = threadIdx.x; e < KS * TILE; e += THREADS) {
      const int l = e / TILE, k = e % TILE, pos = l0 + l;
      float w = 0.f, bv = 0.f;
      if (pos < d.L) {
        const long long row = (long long)(s0 + pos);
        if (p0 + k < d.P)
          w = to_f(x[b * d.xs0 + row * d.xs1 + h * d.xs2 + p0 + k]) *
              dts[pos] * expf(last - cums[pos]);
        if (n0 + k < d.N)
          bv = to_f(bm[b * d.bs0 + row * d.bs1 + g * d.bs2 + n0 + k]);
      }
      ws[l][k] = w;
      bs[l][k] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int l = 0; l < KS; ++l) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[l][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[l][tx * 4]);
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += wr[i] * br[j];
    }
    __syncthreads();
  }
  float* out = st + ((long long)bh * d.nc + c) * d.P * d.N;
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= d.P) continue;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < d.N) out[(long long)p * d.N + n] = acc[i][j];
    }
  }
}

// ---- pass 2: the state entering each chunk, in place -----------------------

__global__ void __launch_bounds__(THREADS)
ssd_state_pass_kernel(const float* __restrict__ cum,
                      const float* __restrict__ h0, float* __restrict__ st,
                      float* __restrict__ h_last, Dims d) {
  const long long pn = (long long)d.P * d.N;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int bh = blockIdx.y;
  if (e >= pn) return;
  float h = h0 ? h0[bh * pn + e] : 0.f;
  for (int c = 0; c < d.nc; ++c) {
    float* slot = st + ((long long)bh * d.nc + c) * pn + e;
    const float add = *slot;
    *slot = h;
    h = h * expf(cum[(long long)bh * d.S + (c + 1) * d.L - 1]) + add;
  }
  h_last[bh * pn + e] = h;
}

// ---- pass 3: the outputs ---------------------------------------------------

// C's rows [i0, i0 + 64) of the chunk, n in [k0, k0 + 32), transposed into
// cs[n][i] (zero past L or N).
template <typename T>
__device__ void load_rows_t(const T* __restrict__ m, long long s0_,
                            long long s1_, long long s2_, const Dims& d,
                            int b, int g, int s0, int r0, int k0,
                            float (*dst)[PAD]) {
  for (int e = threadIdx.x; e < KS * TILE; e += THREADS) {
    const int k = e % KS, r = e / KS;
    float v = 0.f;
    if (r0 + r < d.L && k0 + k < d.N)
      v = to_f(m[b * s0_ + (long long)(s0 + r0 + r) * s1_ + g * s2_ + k0 + k]);
    dst[k][r] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_out_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ cum,
                     const float* __restrict__ dt,
                     const float* __restrict__ h_in, float* __restrict__ y,
                     Dims d) {
  extern __shared__ __align__(16) float dyn[];
  float(*cs)[PAD] = reinterpret_cast<float(*)[PAD]>(dyn);          // [KS]
  float(*bs)[PAD] = reinterpret_cast<float(*)[PAD]>(dyn + KS * PAD);
  float(*ss)[PAD] = reinterpret_cast<float(*)[PAD]>(dyn + 2 * KS * PAD);
  float(*xs)[PAD] =
      reinterpret_cast<float(*)[PAD]>(dyn + 2 * KS * PAD + TILE * PAD);
  float* cums = dyn + 2 * KS * PAD + 2 * TILE * PAD;                 // [L]
  float* dts = cums + d.L;                                           // [L]
  const int bh = blockIdx.z, b = bh / d.H, h = bh % d.H;
  const int g = h / (d.H / d.G), c = blockIdx.y;
  const int n_tiles_i = (d.L + TILE - 1) / TILE;
  const int it = blockIdx.x % n_tiles_i, i0 = it * TILE;
  const int p0 = (blockIdx.x / n_tiles_i) * TILE;
  const int s0 = c * d.L;
  const int i_end = min(i0 + TILE, d.L);
  for (int i = threadIdx.x; i < i_end; i += THREADS) {
    cums[i] = cum[(long long)bh * d.S + s0 + i];
    dts[i] = dt[b * d.ds0 + (long long)(s0 + i) * d.ds1 + h * d.ds2];
  }
  __syncthreads();
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float yacc[4][4] = {};
  for (int j0 = 0; j0 <= i0; j0 += TILE) {
    // scores C_i B_j^T over N in slabs
    float sacc[4][4] = {};
    for (int k0 = 0; k0 < d.N; k0 += KS) {
      load_rows_t(cm, d.cs0, d.cs1, d.cs2, d, b, g, s0, i0, k0, cs);
      load_rows_t(bm, d.bs0, d.bs1, d.bs2, d, b, g, s0, j0, k0, bs);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KS; ++k) {
        const float4 cv = *reinterpret_cast<const float4*>(&cs[k][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] += cr[i] * br[j];
      }
      __syncthreads();
    }
    // times Lmat, exp only on and below the diagonal; stored as ss[j][i]
    for (int i = 0; i < 4; ++i) {
      const int ii = i0 + ty * 4 + i;
      for (int j = 0; j < 4; ++j) {
        const int jj = j0 + tx * 4 + j;
        float v = 0.f;
        if (jj <= ii && ii < d.L) v = sacc[i][j] * expf(cums[ii] - cums[jj]);
        ss[tx * 4 + j][ty * 4 + i] = v;
      }
    }
    // the key tile's x dt
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int r = e / TILE, k = e % TILE, pos = j0 + r;
      float v = 0.f;
      if (pos < d.L && p0 + k < d.P)
        v = to_f(x[b * d.xs0 + (long long)(s0 + pos) * d.xs1 + h * d.xs2 +
                   p0 + k]) * dts[pos];
      xs[r][k] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < TILE; ++j) {
      const float4 sv = *reinterpret_cast<const float4*>(&ss[j][ty * 4]);
      const float4 xv = *reinterpret_cast<const float4*>(&xs[j][tx * 4]);
      const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) yacc[i][q] += sr[i] * xr[q];
    }
    __syncthreads();
  }
  // the carried-in state: (C_i h_in^T) exp(cum_i); h_in is [P, N]
  const float* hs = h_in + ((long long)bh * d.nc + c) * d.P * d.N;
  float oacc[4][4] = {};
  for (int k0 = 0; k0 < d.N; k0 += KS) {
    load_rows_t(cm, d.cs0, d.cs1, d.cs2, d, b, g, s0, i0, k0, cs);
    for (int e = threadIdx.x; e < KS * TILE; e += THREADS) {
      const int k = e % KS, r = e / KS;
      float v = 0.f;
      if (p0 + r < d.P && k0 + k < d.N)
        v = hs[(long long)(p0 + r) * d.N + k0 + k];
      bs[k][r] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KS; ++k) {
      const float4 cv = *reinterpret_cast<const float4*>(&cs[k][ty * 4]);
      const float4 hv = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
      const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) oacc[i][q] += cr[i] * hr[q];
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int ii = i0 + ty * 4 + i;
    if (ii >= d.L) continue;
    const float e = expf(cums[ii]);
    float* row = y + ((long long)b * d.S + s0 + ii) * d.H * d.P +
                 (long long)h * d.P;
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + tx * 4 + q;
      if (p < d.P) row[p] = yacc[i][q] + oacc[i][q] * e;
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* b,
           const void* c, const float* h0, float* y, float* h_last,
           float* cum, float* st, const Dims& d, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  const int bh = d.B * d.H;
  const int tiles_p = (d.P + TILE - 1) / TILE;
  const int tiles_n = (d.N + TILE - 1) / TILE;
  const int tiles_i = (d.L + TILE - 1) / TILE;
  const size_t smem1 = 2 * d.L * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_state_kernel<T><<<dim3(tiles_n * tiles_p, d.nc, bh), THREADS,
                              smem1, stream>>>(xt, dt, a, bt, cum, st, d);
  ++g_launched;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long pn = (long long)d.P * d.N;
  ssd_state_pass_kernel<<<dim3((unsigned)((pn + THREADS - 1) / THREADS), bh),
                          THREADS, 0, stream>>>(cum, h0, st, h_last, d);
  ++g_launched;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem3 =
      (2 * KS * PAD + 2 * TILE * PAD + 2 * d.L) * sizeof(float);
  err = cudaFuncSetAttribute(ssd_chunk_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem3);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_out_kernel<T><<<dim3(tiles_i * tiles_p, d.nc, bh), THREADS,
                            smem3, stream>>>(xt, bt, ct, cum, dt, st, y, d);
  ++g_launched;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" unsigned long long kernels_launched() {
  return g_launched.load();
}

// x: [B, S, H, P] (dtype 0 float32, 1 bfloat16; the last dimension
// contiguous), dt: [B, S, H] float32, a: [H] float32, b and c: [B, S, G, N]
// in x's dtype (last dimension contiguous), h0: [B, H, P, N] float32
// contiguous or null. Writes y [B, S, H, P] and h_last [B, H, P, N]
// (float32, contiguous); cum [B, H, S] and st [B, H, S / L, P, N] are
// float32 scratch. S must be a multiple of L. Returns the CUDA error of the
// launches (0 on success).
extern "C" int ssd_scan_fwd(
    const void* x, const float* dt, const float* a, const void* b,
    const void* c, const float* h0, float* y, float* h_last, float* cum,
    float* st, int dtype, int B, int S, int H, int G, int P, int N, int L,
    long long xs0, long long xs1, long long xs2, long long ds0,
    long long ds1, long long ds2, long long bs0, long long bs1,
    long long bs2, long long cs0, long long cs1, long long cs2,
    void* stream) {
  Dims d{B,   S,   H,   G,   P,   N,   L,   S / L, xs0, xs1, xs2,
         ds0, ds1, ds2, bs0, bs1, bs2, cs0, cs1,   cs2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a, b, c, h0, y, h_last, cum, st, d, s);
  return launch<__nv_bfloat16>(x, dt, a, b, c, h0, y, h_last, cum, st, d, s);
}
