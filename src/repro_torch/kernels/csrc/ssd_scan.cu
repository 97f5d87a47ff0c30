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
// Three launches, each with many blocks (blocks run in no order and a
// block has at most 227 KB of shared memory, so the TPU kernel's one
// sequential grid over (b, h, chunk) with the state in VMEM does not
// carry over):
//   1. chunk states: per (b, h, chunk, 64 columns of P): the chunk's cum
//      (a warp scan, written to scratch for the later passes) and the
//      state the chunk adds, B^T (x dt exp(cum_last - cum)), stored as
//      [N, P];
//   2. ssd_state_pass: per (b, h, 32 x 32 tile of the state): the short
//      sequential pass over the chunks, in place: chunk c's slot is
//      overwritten by the state entering chunk c, h <- h exp(cum_last) +
//      chunk c's state (a batch of chunks' loads issued before the
//      recurrence needs them); the last h is the final state, transposed
//      through shared memory to the model's [P, N];
//   3. chunk outputs: per (b, chunk, 64-row tile i, 64 columns of P, a set
//      of HS heads of one group): y for the set's heads.
//
// What bounds it, and the design. The work is products: at mamba2-1.3b's
// serving shape (64 heads of P 64, one group of N 128, chunk 256) C B^T
// is 1% of the operations the function needs, the products with x dt,
// C h_in and B^T (x dt decay) the rest; the bytes (x, B, C, y, the
// states) take ~8 us at 3.35 TB/s. The first kernel of this scan issued
// twice the needed operations, because every head recomputed its group's
// C B^T, all as float32 FMAs on the CUDA cores, at 11% of the float32
// peak. Now:
//   - C B^T once per head set: a pass-3 block forms S_j = C_i B_j^T once
//     for each key tile j <= i and shares it among the HS heads of its set
//     (one group of threads a head, all at once); each head applies its
//     decay exp(cum_i - cum_j) and dt_j (only where j <= i) and multiplies
//     by its x tile; the carried-in (C_i h_in) exp(cum_i) comes first, so
//     y accumulates in registers across the key tiles. HS (kHeads, 2) was
//     chosen by measurement (scan_probe.py builds 1 and 4): with S_j on
//     the tensor cores the sharing saves little, and larger sets leave
//     fewer blocks to fill the card.
//   - With bf16 x, B and C (as the model gives them), every product runs
//     on the tensor cores (mma.sync m16n8k16, bf16 operands, float32
//     accumulators; the fragments of csrc/attention.cu, in mma.cuh). C B^T,
//     with two bf16 operands, is exact in one product. The other products
//     have one bf16 operand (x, B, C) and one float32 operand (the scores,
//     x dt decay, h_in), which is taken in three bf16 parts hi + lo + lo2
//     (split_pack): each part's product is exact in float32 and the parts
//     carry all 24 bits of the float32 mantissa, so the three products
//     give float32 accuracy at three times the tensor-core work, still a
//     fraction of the float32 CUDA cores' time. The scores never leave
//     registers: a warp forms its 16 rows' scores from S_j and packs them
//     straight into A fragments, as the flash kernel packs p. Operand
//     tiles come by 16-byte cp.async one key tile (pass 3) or one slab of
//     64 positions (pass 1) ahead. Blocks whose row tile has the most key
//     tiles start first.
//   - Float32 inputs, and bf16 inputs whose rows do not take 16-byte
//     copies, with N > 128 or P % 8 != 0 (no model the port serves has
//     such shapes), run passes 1 and 3 on the CUDA cores in float32, C B^T
//     included (bf16 parts of a float32 x, B or C would need nine
//     products): every operand converted on load, 4 x 4 outputs a thread
//     from 16-byte shared loads, every shared tile stored along its rows,
//     the next tiles' loads in registers during each product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace {

// Kernels this library has launched in this process, counted on the host
// where each launch is issued; kernels_launched() reads it, and the
// wrappers count a call's launches on the card as its difference.
std::atomic<unsigned long long> g_launched{0};

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;      // positions / state rows / columns per tile
constexpr int KS = 32;        // contraction slab of the float32 products
constexpr int PAD = TILE + 4; // float row pitch: 16-byte rows, 17 groups
constexpr int BPAD = TILE + 8;  // bf16 row pitch of an mma slab (ldmatrix)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kHeads = 2;     // heads a pass-3 block (by measurement)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0.0f);
}
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

struct Dims {
  int B, S, H, G, P, N, L, nc;
  long long xs0, xs1, xs2;          // x [B, S, H, P], last dim contiguous
  long long ds0, ds1, ds2;          // dt [B, S, H]
  long long bs0, bs1, bs2;          // b [B, S, G, N], last dim contiguous
  long long cs0, cs1, cs2;          // c [B, S, G, N], last dim contiguous
  int has_h0;                       // h0 given (else chunk 0 enters at 0)
  int mma;                          // passes 1 and 3 on the tensor cores
};

// acc[r][q] += sum_k a[k][ty 4 + r] b[k][tx 4 + q] over k < kn: the
// 4 x 4 outputs of thread (ty, tx) of a group of 256, two 16-byte shared
// loads a k.
__device__ __forceinline__ void mac_4x4(float (&acc)[4][4], float (*a)[PAD],
                                        float (*b)[PAD], int kn) {
  const int lt = threadIdx.x % THREADS, ty = lt / 16, tx = lt % 16;
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&a[k][ty * 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&b[k][tx * 4]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
  }
}

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

// ---- pass 1: the state each chunk adds, as [N, P] ------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a, const T* __restrict__ bm,
                       float* __restrict__ cum, float* __restrict__ st,
                       Dims d) {
  extern __shared__ __align__(16) float dyn[];
  float* dts = dyn;                  // [L]
  float* cums = dyn + d.L;           // [L]
  __shared__ __align__(16) float bs[KS][PAD];   // B, positions x n
  __shared__ __align__(16) float ws[KS][PAD];   // x dt decay, positions x p
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
  const T* xb = x + b * d.xs0 + h * d.xs2 + p0;
  const T* bb = bm + b * d.bs0 + g * d.bs2 + n0;
  // a slab's x and B, 8 + 8 elements a thread (consecutive threads on
  // consecutive columns), loaded into registers ahead of its use
  constexpr int PER = KS * TILE / THREADS;
  T xr[PER], br[PER];
  auto fetch = [&](int l0) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + q * THREADS, l = e / TILE, k = e % TILE;
      const int pos = l0 + l;
      const long long row = (long long)(s0 + pos);
      xr[q] = pos < d.L && p0 + k < d.P ? xb[row * d.xs1 + k] : zero_of<T>();
      br[q] = pos < d.L && n0 + k < d.N ? bb[row * d.bs1 + k] : zero_of<T>();
    }
  };
  fetch(0);
  float acc[4][4] = {};
  for (int l0 = 0; l0 < d.L; l0 += KS) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + q * THREADS, l = e / TILE, k = e % TILE;
      const int pos = l0 + l;
      ws[l][k] = pos < d.L ? to_f(xr[q]) * dts[pos] * expf(last - cums[pos])
                           : 0.f;
      bs[l][k] = to_f(br[q]);
    }
    __syncthreads();
    if (l0 + KS < d.L) fetch(l0 + KS);
    mac_4x4(acc, bs, ws, KS);
    __syncthreads();
  }
  // rows n, columns p: the [N, P] layout pass 3 reads along p
  float* out = st + ((long long)bh * d.nc + c) * d.P * d.N;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= d.N) continue;
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      if (p < d.P) out[(long long)n * d.P + p] = acc[i][j];
    }
  }
}

// The three bf16 parts of (a, b), packed as mma operands (a in the low
// half): p[0] = hi, p[1] = lo, p[2] = lo2, with hi + lo + lo2 = (a, b) to
// float32 accuracy: each remainder is exact in float32, and the three
// parts carry the 24 bits of a float32 mantissa. A product with a bf16
// operand then takes three mma, each exact in float32.
__device__ __forceinline__ void split_pack(float a, float b,
                                           uint32_t (&p)[3]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float ra = a - __low2float(h), rb = b - __high2float(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(ra, rb);
  const __nv_bfloat162 l2 =
      __floats2bfloat162_rn(ra - __low2float(l), rb - __high2float(l));
  p[0] = *reinterpret_cast<const uint32_t*>(&h);
  p[1] = *reinterpret_cast<const uint32_t*>(&l);
  p[2] = *reinterpret_cast<const uint32_t*>(&l2);
}

// ---- pass 1 on the tensor cores (bf16 x and B, N <= 128) -------------------

// One block a (b, h, chunk, 64 columns of P), all N rows of the state: the
// state the chunk adds, st^T = B^T (x dt exp(cum_last - cum)), with B (bf16)
// the A operand, read by ldmatrix.trans from B's rows, and the float32
// x dt exp(cum_last - cum) in three bf16 parts. Warp w holds rows 16 w ..
// + 15 (n) and the 64 columns as mma accumulators; the positions come in
// slabs of 64, B's by cp.async a slab ahead, x's in registers a slab
// ahead.
constexpr int NB = 2 * TILE + 8;   // bf16 pitch of a B slab (N <= 128)

size_t state_mma_smem_bytes(int L) {
  // dt and cum [L] each (rounded up to 16 bytes), two B slabs [64][NB],
  // the three parts of a slab of x dt decay [64][BPAD]
  return sizeof(float) * ((2 * (size_t)L + 3) / 4 * 4) +
         sizeof(bf16) * (2 * TILE * NB + 3 * TILE * BPAD);
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_state_mma_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ a,
                           const bf16* __restrict__ bm,
                           float* __restrict__ cum, float* __restrict__ st,
                           Dims d) {
  extern __shared__ __align__(16) float dyn[];
  float* dts = dyn;                  // [L]
  float* cums = dyn + d.L;           // [L]
  bf16* bsl = reinterpret_cast<bf16*>(dyn + (2 * d.L + 3) / 4 * 4);
  bf16* wsp = bsl + 2 * TILE * NB;   // three parts [64][BPAD]
  const int bh = blockIdx.z, b = bh / d.H, h = bh % d.H;
  const int g = h / (d.H / d.G), c = blockIdx.y;
  const int p0 = blockIdx.x * TILE, s0 = c * d.L;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bf16* bb = bm + b * d.bs0 + (long long)s0 * d.bs1 + g * d.bs2;
  const bf16* xb = x + b * d.xs0 + (long long)s0 * d.xs1 + h * d.xs2 + p0;
  // B's rows [l0, l0 + 64) into slab buffer k
  auto issue_b = [&](int l0, int k) {
    bf16* dst = bsl + k * TILE * NB;
    for (int e = threadIdx.x; e < TILE * (2 * TILE / 8); e += THREADS) {
      const int r = e / (2 * TILE / 8), c8 = (e % (2 * TILE / 8)) * 8;
      const bool full = l0 + r < d.L && c8 < d.N;
      cp_async16(smem_u32(dst + r * NB + c8),
                 full ? bb + (long long)(l0 + r) * d.bs1 + c8 : bb, full);
    }
    cp_async_commit();
  };
  // x's rows [l0, l0 + 64), 8 columns a load, two loads a thread
  uint4 xr[2];
  auto fetch_x = [&](int l0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = threadIdx.x + q * THREADS, r = e / 8, c8 = (e % 8) * 8;
      xr[q] = l0 + r < d.L && p0 + c8 < d.P
                  ? *reinterpret_cast<const uint4*>(
                        xb + (long long)(l0 + r) * d.xs1 + c8)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  issue_b(0, 0);
  fetch_x(0);
  chunk_cum(dt, a[h], d, b, h, s0, dts, cums);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < d.L; i += blockDim.x)
      cum[(long long)bh * d.S + s0 + i] = cums[i];
  const float last = cums[d.L - 1];
  float acc[8][4] = {};
  for (int l0 = 0, k = 0; l0 < d.L; l0 += TILE, k ^= 1) {
    // x dt exp(last - cum), in three parts
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = threadIdx.x + q * THREADS, r = e / 8, c8 = (e % 8) * 8;
      const int l = l0 + r;
      const float f = l < d.L ? dts[l] * expf(last - cums[l]) : 0.f;
      const bf16* xv = reinterpret_cast<const bf16*>(&xr[q]);
      uint32_t part[4][3];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        split_pack(__bfloat162float(xv[2 * m]) * f,
                   __bfloat162float(xv[2 * m + 1]) * f, part[m]);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        *reinterpret_cast<uint4*>(wsp + (t * TILE + r) * BPAD + c8) =
            make_uint4(part[0][t], part[1][t], part[2][t], part[3][t]);
    }
    cp_async_wait<0>();
    __syncthreads();            // this slab's B and parts are in
    if (l0 + TILE < d.L) {      // the next slab's B and x fly meanwhile
      issue_b(l0 + TILE, k ^ 1);
      fetch_x(l0 + TILE);
    }
    if (16 * w < d.N) {
      const bf16* bs = bsl + k * TILE * NB;
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4_t(af, bs + (kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) *
                               NB +
                          16 * w + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp)
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            uint32_t vb[4];
            ldsm_x4_t(vb, wsp + (t * TILE + kk * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * BPAD +
                              dp * 16 + (lane >> 4) * 8);
            mma_bf16(acc[2 * dp], af, vb[0], vb[1]);
            mma_bf16(acc[2 * dp + 1], af, vb[2], vb[3]);
          }
      }
    }
    __syncthreads();            // every warp is done with the slab
  }
  // rows n = 16 w + lane / 4 (+ 8), columns 8 t + 2 (lane % 4) (+ 1)
  float* out = st + ((long long)bh * d.nc + c) * d.P * d.N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = 16 * w + (lane >> 2) + 8 * half;
    if (n >= d.N) continue;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int p = p0 + t * 8 + 2 * (lane & 3);
      if (p < d.P)
        *reinterpret_cast<float2*>(out + (long long)n * d.P + p) =
            make_float2(acc[t][2 * half], acc[t][2 * half + 1]);
    }
  }
}

// ---- pass 2: the state entering each chunk, in place -----------------------

// A 32 (n) x 32 (p) tile of the state per block, 4 rows a thread: the slots
// ([N, P]) are read and written along p; h0 and h_last ([P, N]) along n,
// through a transposing shared tile.
__global__ void __launch_bounds__(THREADS)
ssd_state_pass_kernel(const float* __restrict__ cum,
                      const float* __restrict__ h0, float* __restrict__ st,
                      float* __restrict__ h_last, Dims d) {
  __shared__ float tile[32][33];
  const long long pn = (long long)d.P * d.N;
  const int tiles_p = (d.P + 31) / 32;
  const int n0 = (blockIdx.x / tiles_p) * 32, p0 = (blockIdx.x % tiles_p) * 32;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;   // 32 x 8
  float h[4];
  // h0 [P, N]: read along n, transposed
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + ty + 8 * r, n = n0 + tx;
    tile[ty + 8 * r][tx] =
        h0 && p < d.P && n < d.N ? h0[bh * pn + (long long)p * d.N + n] : 0.f;
  }
  __syncthreads();
  for (int r = 0; r < 4; ++r) h[r] = tile[tx][ty + 8 * r];
  // the chunks in batches of 4: every load of a batch is issued before
  // the recurrence needs the first
  const bool in[4] = {n0 + ty < d.N && p0 + tx < d.P,
                      n0 + ty + 8 < d.N && p0 + tx < d.P,
                      n0 + ty + 16 < d.N && p0 + tx < d.P,
                      n0 + ty + 24 < d.N && p0 + tx < d.P};
  for (int c0 = 0; c0 < d.nc; c0 += 4) {
    float e[4], add[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = min(c0 + k, d.nc - 1);
      e[k] = cum[(long long)bh * d.S + (c + 1) * d.L - 1];
      const float* slots = st + ((long long)bh * d.nc + c) * pn;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        add[k][r] = in[r] ? slots[(long long)(n0 + ty + 8 * r) * d.P + p0 +
                                  tx]
                          : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= d.nc) break;
      const float decay = expf(e[k]);
      float* slots = st + ((long long)bh * d.nc + c0 + k) * pn;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (in[r]) slots[(long long)(n0 + ty + 8 * r) * d.P + p0 + tx] = h[r];
        h[r] = h[r] * decay + add[k][r];
      }
    }
  }
  __syncthreads();
  for (int r = 0; r < 4; ++r) tile[ty + 8 * r][tx] = h[r];
  __syncthreads();
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + ty + 8 * r, n = n0 + tx;
    if (p < d.P && n < d.N)
      h_last[bh * pn + (long long)p * d.N + n] = tile[tx][ty + 8 * r];
  }
}

// ---- pass 3: the outputs ---------------------------------------------------

// Rows [0, 64) of a [rows, N] slice (row stride rs, contiguous n) at
// columns [n0, n0 + KS), transposed into dst[k][r] as float32; zero at
// rows >= n_rows and columns >= N. Consecutive threads take consecutive
// rows, so the shared stores meet no bank conflict.
template <typename T>
__device__ __forceinline__ void load_slab_t(const T* __restrict__ src,
                                            long long rs, int n_rows, int n0,
                                            int N, float (*dst)[PAD]) {
  for (int e = threadIdx.x; e < TILE * KS; e += blockDim.x) {
    const int r = e % TILE, k = e / TILE;
    dst[k][r] = r < n_rows && n0 + k < N ? to_f(src[r * rs + n0 + k]) : 0.f;
  }
}

// S_j^T = B_j C_i^T on the CUDA cores in float32, by the block's first
// 256 threads: rows j, columns i, N in slabs of KS, staged in `stage` (two
// KS x PAD slabs, free until the scores are formed).
template <typename T>
__device__ void scores_t(const T* __restrict__ ci, const T* __restrict__ bj,
                         long long cs, long long bs, int rows_i, int rows_j,
                         int N, float (*sT)[PAD], float (*stage)[PAD]) {
  float (*bt)[PAD] = stage;
  float (*ct)[PAD] = stage + KS;
  const bool mine = threadIdx.x < THREADS;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += KS) {
    if (n0 > 0) __syncthreads();
    load_slab_t(bj, bs, rows_j, n0, N, bt);
    load_slab_t(ci, cs, rows_i, n0, N, ct);
    __syncthreads();
    if (mine) mac_4x4(acc, bt, ct, min(KS, N - n0));
  }
  if (mine) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(&sT[ty * 4 + r][tx * 4]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

size_t out_smem_bytes(int hs) {
  // S_j^T and, for each head of the set, its scores and its x: 1 + 2 HS
  // [64][PAD] tiles; cum at the rows and at the key tile and dt at the
  // key tile, [HS][64] each
  return sizeof(float) * ((1 + 2 * (size_t)hs) * TILE * PAD +
                          3 * (size_t)hs * TILE);
}

// One block a (b, chunk, row tile i, 64 columns of P, set of HS heads of
// one group): HS groups of 256 threads, group h taking the set's head h;
// S_j is formed once and shared by the groups.
template <typename T, int HS>
__global__ void __launch_bounds__(THREADS * HS, HS == 1 ? 2 : 1)
ssd_chunk_out_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ cum,
                     const float* __restrict__ dt,
                     const float* __restrict__ h_in, float* __restrict__ y,
                     Dims d) {
  constexpr int NT = THREADS * HS;            // the block's threads
  extern __shared__ __align__(16) float dyn[];
  const int hh = threadIdx.x / THREADS;       // this thread's head of the set
  const int lt = threadIdx.x % THREADS;       // its thread in the group
  float(*sT)[PAD] = reinterpret_cast<float(*)[PAD]>(dyn);   // S_j^T [j][i]
  float(*ssT)[PAD] = sT + TILE * (1 + 2 * hh);  // the head's scores^T [j][i]
  float(*xs)[PAD] = ssT + TILE;                 // the head's x tile [j][p]
  float* cum_i = dyn + (1 + 2 * HS) * TILE * PAD;  // [HS][64]
  float* cum_j = cum_i + HS * TILE;                // [HS][64]
  float* dt_j = cum_j + HS * TILE;                 // [HS][64]

  const int R = d.H / d.G;
  const int n_sets = (R + HS - 1) / HS;
  const int tiles_p = (d.P + TILE - 1) / TILE;
  const int pt = blockIdx.x % tiles_p;
  const int set = (blockIdx.x / tiles_p) % n_sets;
  const int g = blockIdx.x / tiles_p / n_sets;
  const int b = blockIdx.y / d.nc, c = blockIdx.y % d.nc;
  const int it = gridDim.z - 1 - blockIdx.z;   // the longest row tiles first
  const int i0 = it * TILE, p0 = pt * TILE, s0 = c * d.L;
  const int rows_i = min(TILE, d.L - i0);
  const int h_first = g * R + set * HS;
  const int n_heads = min(HS, R - set * HS);
  const bool active = hh < n_heads;            // a ragged set's idle group
  const int h = h_first + hh;
  const int ty = lt / 16, tx = lt % 16;
  const T* ci = cm + b * d.cs0 + (long long)(s0 + i0) * d.cs1 + g * d.cs2;
  auto b_rows = [&](int j) {
    return bm + b * d.bs0 + (long long)(s0 + j * TILE) * d.bs1 + g * d.bs2;
  };
  // the first key tile's cum and dt in flight during the carried-in
  // state's products
  float cjr = 0.f, djr = 0.f;                  // thread e < HS 64's element
  auto fetch_cd = [&](int j) {
    const int e = threadIdx.x, eh = e / TILE, r = e % TILE;
    const long long row = (long long)(s0 + j * TILE + r);
    const bool ok = e < HS * TILE && eh < n_heads && r < d.L - j * TILE;
    cjr = ok ? cum[((long long)b * d.H + h_first + eh) * d.S + row] : 0.f;
    djr = ok ? dt[b * d.ds0 + row * d.ds1 + (h_first + eh) * d.ds2] : 0.f;
  };
  fetch_cd(0);
  for (int e = threadIdx.x; e < HS * TILE; e += NT) {
    const int eh = e / TILE, r = e % TILE;
    cum_i[e] = eh < n_heads && r < rows_i
                   ? cum[((long long)b * d.H + h_first + eh) * d.S + s0 +
                         i0 + r]
                   : 0.f;
  }
  float acc[4][4] = {};

  // 1. the carried-in state: acc = (C_i h_in) exp(cum_i), h_in [N, P];
  //    chunk 0 without h0 enters at 0. N in slabs of KS: C_i's slab
  //    transposed into slab_a (shared, over sT), the head's h_in slab into
  //    slab_b (over its scores), the next slabs' loads in flight (in
  //    registers) during each product.
  if (c > 0 || d.has_h0) {
    float(*slab_a)[PAD] = sT;
    float(*slab_b)[PAD] = ssT;
    constexpr int PC = KS * TILE / NT, PH = KS * TILE / THREADS;
    T cr[PC];
    float hr[PH];
    const float* hs =
        h_in + (((long long)b * d.H + h) * d.nc + c) * d.P * d.N;
    auto fetch = [&](int n0) {
#pragma unroll
      for (int q = 0; q < PC; ++q) {
        const int e = threadIdx.x + q * NT, r = e % TILE, k = e / TILE;
        cr[q] = r < rows_i && n0 + k < d.N ? ci[r * d.cs1 + n0 + k]
                                           : zero_of<T>();
      }
#pragma unroll
      for (int q = 0; q < PH; ++q) {
        const int e = lt + q * THREADS, k = e / TILE, p = e % TILE;
        hr[q] = active && n0 + k < d.N && p0 + p < d.P
                    ? hs[(long long)(n0 + k) * d.P + p0 + p]
                    : 0.f;
      }
    };
    fetch(0);
    for (int n0 = 0; n0 < d.N; n0 += KS) {
#pragma unroll
      for (int q = 0; q < PC; ++q) {
        const int e = threadIdx.x + q * NT;
        slab_a[e / TILE][e % TILE] = to_f(cr[q]);
      }
#pragma unroll
      for (int q = 0; q < PH; ++q) {
        const int e = lt + q * THREADS;
        slab_b[e / TILE][e % TILE] = hr[q];
      }
      __syncthreads();
      if (n0 + KS < d.N) fetch(n0 + KS);
      if (active) mac_4x4(acc, slab_a, slab_b, min(KS, d.N - n0));
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = expf(cum_i[hh * TILE + ty * 4 + r]);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] *= e;
    }
  }

  // 2. the key tiles j <= i: S_j once for the set, then each group its
  //    head's scores and x tile
  constexpr int PX = TILE * TILE / THREADS;    // x elements a thread
  T xr[PX];
  auto fetch_x = [&](int j) {
    const T* xp = x + b * d.xs0 + (long long)(s0 + j * TILE) * d.xs1 +
                  h * d.xs2 + p0;
    const int rows = active ? min(TILE, d.L - j * TILE) : 0;
#pragma unroll
    for (int q = 0; q < PX; ++q) {
      const int e = lt + q * THREADS, r = e / TILE, k = e % TILE;
      xr[q] = r < rows && p0 + k < d.P ? xp[r * d.xs1 + k] : zero_of<T>();
    }
  };
  fetch_x(0);
  for (int j = 0; j <= it; ++j) {
    const int j0 = j * TILE, rows_j = min(TILE, d.L - j0);
    if (threadIdx.x < HS * TILE) {
      cum_j[threadIdx.x] = cjr;
      dt_j[threadIdx.x] = djr;
    }
    if (j < it) fetch_cd(j + 1);
    scores_t(ci, b_rows(j), d.cs1, d.bs1, rows_i, rows_j, d.N, sT,
             sT + TILE);
    __syncthreads();          // S_j^T, cum_j and dt_j in; the slabs read
    // the head's scores^T: S_j^T o exp(cum_i - cum_j) dt_j, j <= i
    for (int e = lt; e < TILE * TILE / 4; e += THREADS) {
      const int jj = e / (TILE / 4), i4 = (e % (TILE / 4)) * 4;
      const float4 sv = *reinterpret_cast<const float4*>(&sT[jj][i4]);
      const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
      const float cj = cum_j[hh * TILE + jj], dj = dt_j[hh * TILE + jj];
      float o[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int ii = i4 + m;
        o[m] = jj < rows_j && ii < rows_i && (j < it || jj <= ii)
                   ? sr[m] * expf(cum_i[hh * TILE + ii] - cj) * dj
                   : 0.f;
      }
      *reinterpret_cast<float4*>(&ssT[jj][i4]) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
#pragma unroll
    for (int q = 0; q < PX; ++q) {
      const int e = lt + q * THREADS;
      xs[e / TILE][e % TILE] = to_f(xr[q]);
    }
    __syncthreads();
    if (j < it) fetch_x(j + 1);   // the next x tile's loads fly meanwhile
    // on the diagonal tile warp w's rows (8 w .. 8 w + 7) need keys below
    // 8 w + 8 only
    const int kn = j < it ? rows_j : min(rows_j, (lt / 32) * 8 + 8);
    if (active) mac_4x4(acc, ssT, xs, kn);
    __syncthreads();
  }

  // 3. y [B, S, H, P]
  if (!active) return;
  for (int r = 0; r < 4; ++r) {
    const int ii = ty * 4 + r;
    if (ii >= rows_i) continue;
    float* row = y + ((long long)b * d.S + s0 + i0 + ii) * d.H * d.P +
                 (long long)h * d.P;
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + tx * 4 + q;
      if (p < d.P) row[p] = acc[r][q];
    }
  }
}

template <typename T, int HS>
int launch_out(const T* x, const T* b, const T* c, const float* cum,
               const float* dt, const float* st, float* y, const Dims& d,
               cudaStream_t stream) {
  const int tiles_p = (d.P + TILE - 1) / TILE;
  const int tiles_i = (d.L + TILE - 1) / TILE;
  const int n_sets = (d.H / d.G + HS - 1) / HS;
  const size_t smem = out_smem_bytes(HS);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_out_kernel<T, HS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_out_kernel<T, HS>
      <<<dim3(tiles_p * n_sets * d.G, d.B * d.nc, tiles_i), THREADS * HS,
         smem, stream>>>(x, b, c, cum, dt, st, y, d);
  ++g_launched;
  return (int)cudaGetLastError();
}

// ---- pass 3 on the tensor cores (bf16 x, B and C) -------------------------

// One block a (b, chunk, row tile i, 64 columns of P, set of HS heads of
// one group), as the CUDA-core kernel, with every product on mma.sync:
// S_j = C_i B_j^T once for the set (bf16 operands), then for each head the
// scores S_j o exp(cum_i - cum_j) dt_j (float32) times its x tile (bf16),
// and first (C_i h_in) exp(cum_i). The float32 operand of those two
// products (the scores, h_in) is taken in three bf16 parts hi + lo + lo2,
// each product exact in float32, so the sum keeps float32 accuracy (the
// three parts carry 24 bits of the 24-bit mantissa) at three mma each. A
// head is 4 warps; warp w holds rows 16 w .. + 15 of the tile and all 64
// columns of P as mma accumulators, and forms its own rows' scores in
// registers as the A operand (no shared round trip); x tiles come by
// cp.async, a key tile ahead, and are read by ldmatrix.trans.
constexpr int MT = 128;        // threads a head
constexpr int kMmaSlabs = 2;   // slabs of 64 columns of N: N <= 128
constexpr size_t kMmaGroupBytes = 2 * kMmaSlabs * TILE * BPAD * sizeof(bf16);

// Rows [0, 64) x columns [n0, n0 + 64) of a bf16 [rows, N] slice into an
// mma slab of pitch BPAD by 16-byte cp.async copies, zero past n_rows and
// N (the caller commits and waits).
__device__ __forceinline__ void load_mma_slab(bf16* dst,
                                              const bf16* __restrict__ src,
                                              long long rs, int n_rows,
                                              int n0, int N) {
  for (int e = threadIdx.x; e < TILE * (TILE / 8); e += blockDim.x) {
    const int r = e / (TILE / 8), c = (e % (TILE / 8)) * 8;
    const bool full = r < n_rows && n0 + c < N;
    cp_async16(smem_u32(dst + r * BPAD + c),
               full ? src + r * rs + n0 + c : src, full);
  }
}

// A key tile's C_i and B_j slabs, every column of N, into `pf` (slab k's
// C at 2 k, its B at 2 k + 1), as one commit group: issued while the
// block works on the key tile before.
__device__ __forceinline__ void issue_mma_group(
    bf16* pf, const bf16* __restrict__ ci, const bf16* __restrict__ bj,
    long long cs, long long bs, int rows_i, int rows_j, int N) {
  for (int k = 0; k * TILE < N; ++k) {
    bf16* cb = pf + 2 * k * TILE * BPAD;
    load_mma_slab(cb, ci, cs, rows_i, k * TILE, N);
    load_mma_slab(cb + TILE * BPAD, bj, bs, rows_j, k * TILE, N);
  }
  cp_async_commit();
}

// S_j = C_i B_j^T from the slabs in `pf` (bf16 operands, float32
// accumulators), by the block's first NW warps (4, 8 or 16): warp w owns
// rows 16 (w % 4) .. + 15 of S and 256 / NW columns from (256 / NW)
// (w / 4). Waits for the block's copies; stores S along its rows into
// `out` (pitch ld).
template <int NW>
__device__ void scores_mma(const bf16* pf, int N, float* out, int ld) {
  constexpr int CW = 4 * TILE / NW;          // columns a warp: 64, 32, 16
  constexpr int NP = CW / 16;                // ldmatrix.x4 a k-step
  static_assert(NW == 4 || NW == 8 || NW == 16, "4, 8 or 16 warps form S");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool mine = warp < NW;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * CW;
  float s[2 * NP][4] = {};
  cp_async_wait<0>();
  __syncthreads();
  for (int k = 0; k * TILE < N && mine; ++k) {
    const bf16* cb = pf + 2 * k * TILE * BPAD;
    const bf16* bb = cb + TILE * BPAD;
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, cb + (r0 + (lane & 15)) * BPAD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, bb + (c0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                             BPAD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], af, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], af, kb[2], kb[3]);
      }
    }
  }
  // thread l holds rows l/4 (+ 8), columns 2 (l % 4) (+ 1) of each 16 x 8
  // tile; at pitch 72 the stores of a warp meet no bank conflict
  if (mine) {
#pragma unroll
    for (int t = 0; t < 2 * NP; ++t)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int row = r0 + (lane >> 2) + 8 * (e >> 1);
        const int col = c0 + t * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + row * ld + col) =
            make_float2(s[t][e], s[t][e + 1]);
      }
  }
}
constexpr int SP = TILE + 8;   // float pitch of S_j [i][j]: a warp's
                               // fragment rows start in distinct banks

size_t out_mma_smem_bytes(int hs) {
  // S_j [64][SP] and cum_i, cum_j, dt_j [HS][64] float; the C and B slabs;
  // two x tiles a head
  return sizeof(float) * (TILE * SP + 3 * (size_t)hs * TILE) +
         kMmaGroupBytes + (size_t)hs * 2 * TILE * BPAD * sizeof(bf16);
}

template <int HS>
__global__ void __launch_bounds__(MT * HS, HS == 4 ? 1 : 2)
ssd_chunk_out_mma_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ bm,
                         const bf16* __restrict__ cm,
                         const float* __restrict__ cum,
                         const float* __restrict__ dt,
                         const float* __restrict__ h_in,
                         float* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) float dyn[];
  float* sS = dyn;                                   // [64][SP]
  float* cum_i = sS + TILE * SP;                     // [HS][64]
  float* cum_j = cum_i + HS * TILE;                  // [HS][64]
  float* dt_j = cum_j + HS * TILE;                   // [HS][64]
  bf16* pf = reinterpret_cast<bf16*>(dt_j + HS * TILE);
  bf16* xt = pf + kMmaGroupBytes / sizeof(bf16);     // [HS][2][64][BPAD]
  const int hh = threadIdx.x / MT, lt = threadIdx.x % MT;
  const int lane = threadIdx.x & 31, w = lt >> 5;
  bf16* xh = xt + (size_t)hh * 2 * TILE * BPAD;      // the head's x tiles

  const int R = d.H / d.G;
  const int n_sets = (R + HS - 1) / HS;
  const int tiles_p = (d.P + TILE - 1) / TILE;
  const int pt = blockIdx.x % tiles_p;
  const int set = (blockIdx.x / tiles_p) % n_sets;
  const int g = blockIdx.x / tiles_p / n_sets;
  const int b = blockIdx.y / d.nc, c = blockIdx.y % d.nc;
  const int it = gridDim.z - 1 - blockIdx.z;   // the longest row tiles first
  const int i0 = it * TILE, p0 = pt * TILE, s0 = c * d.L;
  const int rows_i = min(TILE, d.L - i0);
  const int h_first = g * R + set * HS;
  const int n_heads = min(HS, R - set * HS);
  const bool active = hh < n_heads;
  const int h = h_first + hh;
  const int row0 = 16 * w + (lane >> 2), t2 = 2 * (lane & 3);
  const bf16* ci = cm + b * d.cs0 + (long long)(s0 + i0) * d.cs1 + g * d.cs2;
  auto b_rows = [&](int j) {
    return bm + b * d.bs0 + (long long)(s0 + j * TILE) * d.bs1 + g * d.bs2;
  };
  // key tile j's x rows for this head, into its buffer j % 2
  auto issue_x = [&](int j) {
    bf16* dst = xh + (j & 1) * TILE * BPAD;
    const bf16* src = x + b * d.xs0 + (long long)(s0 + j * TILE) * d.xs1 +
                      h * d.xs2 + p0;
    const int rows = active ? min(TILE, d.L - j * TILE) : 0;
    for (int e = lt; e < TILE * (TILE / 8); e += MT) {
      const int r = e / (TILE / 8), c8 = (e % (TILE / 8)) * 8;
      const bool full = r < rows && p0 + c8 < d.P;
      cp_async16(smem_u32(dst + r * BPAD + c8),
                 full ? src + r * d.xs1 + c8 : src, full);
    }
  };
  // the first key tile's C and B slabs and x, and its cum and dt, in
  // flight during the carried-in state's products
  issue_mma_group(pf, ci, b_rows(0), d.cs1, d.bs1, rows_i, min(TILE, d.L),
                  d.N);
  issue_x(0);
  cp_async_commit();
  float cjr = 0.f, djr = 0.f;                  // thread e < HS 64's element
  auto fetch_cd = [&](int j) {
    const int e = threadIdx.x, eh = e / TILE, r = e % TILE;
    const long long row = (long long)(s0 + j * TILE + r);
    const bool ok = e < HS * TILE && eh < n_heads && r < d.L - j * TILE;
    cjr = ok ? cum[((long long)b * d.H + h_first + eh) * d.S + row] : 0.f;
    djr = ok ? dt[b * d.ds0 + row * d.ds1 + (h_first + eh) * d.ds2] : 0.f;
  };
  fetch_cd(0);
  for (int e = threadIdx.x; e < HS * TILE; e += MT * HS) {
    const int eh = e / TILE, r = e % TILE;
    cum_i[e] = eh < n_heads && r < rows_i
                   ? cum[((long long)b * d.H + h_first + eh) * d.S + s0 +
                         i0 + r]
                   : 0.f;
  }
  float acc[8][4] = {};

  // 1. the carried-in state: acc = (C_i h_in) exp(cum_i), h_in [N, P];
  //    chunk 0 without h0 enters at 0. N in steps of 16: the head's h_in
  //    rows split in three bf16 parts over its second x tile, C_i's
  //    fragments from the slabs in pf.
  if (c > 0 || d.has_h0) {
    bf16* hsplit = xh + TILE * BPAD;            // three [16][BPAD] parts
    const float* hs =
        h_in + (((long long)b * d.H + h) * d.nc + c) * d.P * d.N;
    float4 hr[2];
    auto fetch_h = [&](int n0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = lt + q * MT, r = e / 16, c4 = (e % 16) * 4;
        hr[q] = active && n0 + r < d.N && p0 + c4 < d.P
                    ? *reinterpret_cast<const float4*>(
                          hs + (long long)(n0 + r) * d.P + p0 + c4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    fetch_h(0);
    cp_async_wait<0>();
    __syncthreads();                           // C_i's slabs are in
    for (int n0 = 0; n0 < d.N; n0 += 16) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = lt + q * MT, r = e / 16, c4 = (e % 16) * 4;
        uint32_t lo[3], hi[3];
        split_pack(hr[q].x, hr[q].y, lo);
        split_pack(hr[q].z, hr[q].w, hi);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<uint2*>(hsplit + (k * 16 + r) * BPAD + c4) =
              make_uint2(lo[k], hi[k]);
      }
      __syncthreads();
      if (n0 + 16 < d.N) fetch_h(n0 + 16);
      if (active) {
        uint32_t af[4];
        ldsm_x4(af, pf + 2 * (n0 / TILE) * TILE * BPAD +
                        (16 * w + (lane & 15)) * BPAD + n0 % TILE +
                        (lane >> 4) * 8);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp)
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            uint32_t vb[4];
            ldsm_x4_t(vb, hsplit + (k * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * BPAD +
                              dp * 16 + (lane >> 4) * 8);
            mma_bf16(acc[2 * dp], af, vb[0], vb[1]);
            mma_bf16(acc[2 * dp + 1], af, vb[2], vb[3]);
          }
      }
      __syncthreads();
    }
    const float e0 = expf(cum_i[hh * TILE + row0]);
    const float e1 = expf(cum_i[hh * TILE + row0 + 8]);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      acc[t][0] *= e0;
      acc[t][1] *= e0;
      acc[t][2] *= e1;
      acc[t][3] *= e1;
    }
  }

  // 2. the key tiles j <= i: S_j once for the set; then each warp its
  //    rows' scores, in registers, times its head's x tile
  for (int j = 0; j <= it; ++j) {
    const int rows_j = min(TILE, d.L - j * TILE);
    if (threadIdx.x < HS * TILE) {
      cum_j[threadIdx.x] = cjr;
      dt_j[threadIdx.x] = djr;
    }
    if (j < it) fetch_cd(j + 1);
    scores_mma<4 * HS>(pf, d.N, sS, SP);
    __syncthreads();          // S_j, cum_j, dt_j and x_j in; the slabs read
    if (j < it) {             // the next key tile's slabs and x fly meanwhile
      issue_mma_group(pf, ci, b_rows(j + 1), d.cs1, d.bs1, rows_i,
                      min(TILE, d.L - (j + 1) * TILE), d.N);
      issue_x(j + 1);
      cp_async_commit();
    }
    if (active) {
      const bf16* xb = xh + (j & 1) * TILE * BPAD;
      const float ci0 = cum_i[hh * TILE + row0];
      const float ci1 = cum_i[hh * TILE + row0 + 8];
      // on the diagonal tile warp w's rows need keys below 16 w + 16
      const int kk_end = j < it ? TILE / 16 : w + 1;
      for (int kk = 0; kk < kk_end; ++kk) {
        float v[2][4];
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          const int col = kk * 16 + tt * 8 + t2;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = row0 + 8 * half;
            const float2 sv =
                *reinterpret_cast<const float2*>(sS + row * SP + col);
            const float cr = half ? ci1 : ci0;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const int cc = col + m;
              const bool ok = cc < rows_j && row < rows_i &&
                              (j < it || cc <= row);
              v[tt][2 * half + m] =
                  ok ? (m ? sv.y : sv.x) *
                           expf(cr - cum_j[hh * TILE + cc]) *
                           dt_j[hh * TILE + cc]
                     : 0.f;
            }
          }
        }
        // A fragments: rows g and g + 8, keys 16 kk + t2 (+1) and + 8
        uint32_t q0[3], q1[3], q2[3], q3[3];
        split_pack(v[0][0], v[0][1], q0);
        split_pack(v[0][2], v[0][3], q1);
        split_pack(v[1][0], v[1][1], q2);
        split_pack(v[1][2], v[1][3], q3);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t vb[4];
          ldsm_x4_t(vb, xb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 BPAD +
                            dp * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const uint32_t af[4] = {q0[k], q1[k], q2[k], q3[k]};
            mma_bf16(acc[2 * dp], af, vb[0], vb[1]);
            mma_bf16(acc[2 * dp + 1], af, vb[2], vb[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // 3. y [B, S, H, P]: rows row0 and row0 + 8, columns 8 t + t2 (+1)
  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= rows_i) continue;
    float* yr = y + ((long long)b * d.S + s0 + i0 + row) * d.H * d.P +
                (long long)h * d.P + p0;
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (p0 + t * 8 + t2 < d.P)
        *reinterpret_cast<float2*>(yr + t * 8 + t2) =
            make_float2(acc[t][2 * half], acc[t][2 * half + 1]);
  }
}

template <int HS>
int launch_out_mma(const bf16* x, const bf16* b, const bf16* c,
                   const float* cum, const float* dt, const float* st,
                   float* y, const Dims& d, cudaStream_t stream) {
  const int tiles_p = (d.P + TILE - 1) / TILE;
  const int tiles_i = (d.L + TILE - 1) / TILE;
  const int n_sets = (d.H / d.G + HS - 1) / HS;
  const size_t smem = out_mma_smem_bytes(HS);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_out_mma_kernel<HS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_out_mma_kernel<HS>
      <<<dim3(tiles_p * n_sets * d.G, d.B * d.nc, tiles_i), MT * HS, smem,
         stream>>>(x, b, c, cum, dt, st, y, d);
  ++g_launched;
  return (int)cudaGetLastError();
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
  cudaError_t err;
  if (std::is_same<T, bf16>::value && d.mma) {
    const size_t smem1 = state_mma_smem_bytes(d.L);
    err = cudaFuncSetAttribute(ssd_chunk_state_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem1);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_state_mma_kernel<<<dim3(tiles_p, d.nc, bh), THREADS, smem1,
                                 stream>>>(
        reinterpret_cast<const bf16*>(xt), dt, a,
        reinterpret_cast<const bf16*>(bt), cum, st, d);
  } else {
    const size_t smem1 = 2 * d.L * sizeof(float);
    err = cudaFuncSetAttribute(ssd_chunk_state_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem1);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_state_kernel<T><<<dim3(tiles_n * tiles_p, d.nc, bh), THREADS,
                                smem1, stream>>>(xt, dt, a, bt, cum, st, d);
  }
  ++g_launched;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_state_pass_kernel<<<dim3(((d.P + 31) / 32) * ((d.N + 31) / 32), bh),
                          THREADS, 0, stream>>>(cum, h0, st, h_last, d);
  ++g_launched;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (std::is_same<T, bf16>::value) {
    if (d.mma)
      return launch_out_mma<kHeads>(xt, bt, ct, cum, dt, st, y, d, stream);
  }
  return launch_out<T, kHeads>(xt, bt, ct, cum, dt, st, y, d, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" unsigned long long kernels_launched() {
  return g_launched.load();
}

// x: [B, S, H, P] (dtype 0 float32, 1 bfloat16; the last dimension
// contiguous), dt: [B, S, H] float32, a: [H] float32, b and c: [B, S, G, N]
// in x's dtype (last dimension contiguous), h0: [B, H, P, N] float32
// contiguous or null. Writes y [B, S, H, P] and h_last [B, H, P, N]
// (float32, contiguous); cum [B, H, S] and st [B, H, S / L, N, P] are
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
  // the tensor-core kernels take bf16 x, B and C rows in 16-byte copies
  // (every row starting on a 16-byte boundary) and C's and B's columns in
  // one group of slabs; other inputs take the CUDA-core kernels
  const bool mma = dtype == 1 && aligned16(x) && aligned16(b) &&
                   aligned16(c) && N % 8 == 0 && N <= kMmaSlabs * TILE &&
                   P % 8 == 0 && xs0 % 8 == 0 && xs1 % 8 == 0 &&
                   xs2 % 8 == 0 && bs0 % 8 == 0 && bs1 % 8 == 0 &&
                   bs2 % 8 == 0 && cs0 % 8 == 0 && cs1 % 8 == 0 &&
                   cs2 % 8 == 0;
  Dims d{B,   S,   H,   G,   P,   N,   L,   S / L, xs0, xs1, xs2,
         ds0, ds1, ds2, bs0, bs1, bs2, cs0, cs1,   cs2, h0 != nullptr,
         mma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a, b, c, h0, y, h_last, cum, st, d, s);
  return launch<bf16>(x, dt, a, b, c, h0, y, h_last, cum, st, d, s);
}
