// Relaxed (entropic) cross-site water-fill for Hopper (sm_90a): its forward
// with and without the residuals of the fused VJP, and the reversed-time
// backward.
//
// Replaces the Pallas TPU kernels of repro/kernels/soft_dispatch.py:
//   _soft_dispatch_kernel (the forward)             -> soft_dispatch_f32
//   _fused_fwd_kernel     (the forward + residuals) -> soft_dispatch_fused_fwd_f32
//   _fused_bwd_kernel     (the per-hour adjoint)    -> soft_dispatch_fused_bwd_f32
// The first two launch one kernel, soft_fwd_kernel: the same machine code
// whether or not it writes the residuals, so their allocations are equal
// bit for bit. Each hour computes what
// repro_torch.kernels.ref.soft_dispatch_hour_parts (forward) and
// soft_dispatch_hour_grad (backward) compute:
//   widths   w = [locked | held - locked | avail - held], held = min(prev,
//            avail), locked = sigmoid((dwell - 1/2) / tau_cnt) held;
//   level    the hard level (the key at which the sorted widths' inclusive
//            prefix reaches the demand) brackets the root of
//            sum_j w_j sigmoid((lam - key_j) / tau) = demand within
//            +-40 tau; n_bisect bisection steps, then one Newton step;
//   fill     x_j = w_j sigmoid((lam - key_j) / tau), renormalised to the
//            demand; alloc_s = x_s + x_{S+s} + x_{2S+s};
//   dwell'   sigmoid reset at the MW temperature, softplus countdown.
//
// Design. The allocation is a recurrence over hours, and the sites are
// coupled every hour through the water level: one instance is one serial
// chain. The TPU carries (prev, dwell) in VMEM down a sequential time
// grid; here ONE block per instance loops over the hours, thread s owns
// site s and its three segments, and keeps prev and dwell (forward) or
// their adjoints (backward) in registers. Every reduction over the 3S
// segments is a float64 sum in a fixed order (each thread adds its three
// float32 terms, a butterfly of shuffles inside the warp, then the warps'
// partials in warp order), so every thread holds the same bits, each
// bisection comparison is taken identically by all threads, and the
// kernels give the same result on every run: no atomics. A block of one
// warp (S <= 32, the tuner's fleet) needs no barrier inside an hour; a
// wider block pays one __syncthreads per reduction (partials alternate
// between two halves of a buffer). The hard level that seeds the bracket
// is one thread's sequential float64 walk over the sorted widths, in the
// plain version's order, to the first prefix that reaches the demand
// (loads only, so they pipeline; no store sits between them).
//
// Arithmetic. Per-element math is float32, built without contraction into
// fused multiply-adds (build.py passes -fmad=false for this source), so
// each operation rounds as in the plain version; exp and log1p are taken
// in float64 and rounded once, the correctly rounded float32 value the
// plain version computes too. What still differs is the order of the
// float64 sums, which moves a result only where one rounds to float32
// differently. This matters more than usual: in an hour whose demand
// equals a prefix of the sorted widths (with dwell locks and a flat
// demand, every hour), the level lies in a gap between segment keys, the
// Newton step divides by a vanishing slope and is clipped at 40 tau, and
// the last bit of the residual decides where the load goes.
//
// Loads and stores. keys and order [T, 3S] are time-major; avail, the
// residuals and the cotangent [S, T] are site-major. Each tile of up to 32
// hours is staged through shared memory (keys/order as one contiguous
// block, [S, T] arrays as rows of consecutive hours, pitch H + 1), and the
// outputs leave the same way. H shrinks (32, 16, ...) until a tile fits
// the shared memory of a block. The backward stages the allocation from
// the hour before the tile, since hour h's entering allocation is the
// output of hour h - 1.
//
// Bounds on an H100 SXM. Bytes: the forward must read avail, keys, order,
// demand and write alloc (and dwin, lam), ~36 S T bytes: 20 MB at
// S = 64, T = 8760, 6 us at 3.35 TB/s. Operations are ~100 S T n_bisect
// float32 flops, far below the card's rate. What bounds this design is the
// serial chain: T x (n_bisect + 3) dependent block-wide float64 reductions
// (each a few hundred cycles) on one SM. chip_smoke.py states that floor
// beside the times. No PyTorch call computes this function.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxTile = 32;            // hours staged per tile, at most
constexpr int kMaxThreads = 1024;
constexpr size_t kSmemMax = 225 * 1024; // of the 227 KB a block may use
constexpr unsigned kFull = 0xffffffffu;
constexpr float kDwellEventMw = 1e-3f;  // DWELL_EVENT_MW
constexpr float kCntScale = 0.05f;      // _DWELL_CNT_SCALE
constexpr float kSpan = 40.0f;          // _WL_SIGMA_SPAN
constexpr float kTinyF = 1e-30f;        // _WL_TINY
constexpr double kTiny = 1e-30;
constexpr int kRedDoubles = 2 * 2 * 32; // two halves of [2 values][32 warps]

// exp and log1p evaluated in float64 and rounded once: the correctly
// rounded float32 value, the one the plain version computes on the host
// (expf and the host's exp differ in the last bit, enough to send the
// recurrence down another path in a degenerate hour; see above).
__device__ __forceinline__ float exp_rn(float x) {
  return (float)exp((double)x);
}

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + exp_rn(-x));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + (float)log1p((double)exp_rn(-fabsf(x)));
}

// Share of the cotangent of min(a, b) that goes to a (ties split).
__device__ __forceinline__ float tie_share(float a, float b) {
  return a < b ? 1.0f : (a > b ? 0.0f : 0.5f);
}

__device__ __forceinline__ void barrier(int nw) {
  if (nw == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Sums v[0..N) over the block; every thread receives the same bits.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* red,
                                          int nw, int& parity) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(kFull, v[i], o);
  }
  if (nw == 1) return;
  double* b = red + parity * 64;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) b[i * 32 + wid] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    double s = 0.0;
    for (int q = 0; q < nw; ++q) s += b[i * 32 + q];
    v[i] = s;
  }
  parity ^= 1;
}

__device__ __forceinline__ double block_sum1(double x, double* red, int nw,
                                             int& parity) {
  double v[1] = {x};
  block_sum<1>(v, red, nw, parity);
  return v[0];
}

// One thread's three segments.
struct Seg {
  float w[3];
  float key[3];
};

// The differentiable part of an hour at a fixed level lam_hat: Newton
// step and renormalised fill (soft_water_level_fixed and the fill of
// soft_dispatch_hour_fixed), with the intermediates the backward needs.
struct Fill {
  float s0[3], sg[3], fill0[3];
  float denom, step, c1, lam, r;
  double f_sum, floor, den, r64;
};

__device__ __forceinline__ Fill fixed_fill(const Seg& g, float lam_hat,
                                           double d64, float it, float span,
                                           double* red, int nw,
                                           int& parity) {
  Fill f;
  double v[2] = {0.0, 0.0};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    f.s0[j] = sigm((lam_hat - g.key[j]) * it);
    const float ws = g.w[j] * f.s0[j];
    v[0] += (double)ws;
    v[1] += (double)(ws * (1.0f - f.s0[j]));
  }
  block_sum<2>(v, red, nw, parity);
  f.denom = fmaxf((float)v[1] * it, kTinyF);
  f.step = ((float)d64 - (float)v[0]) / f.denom;  // residual in float32
  f.c1 = fmaxf(f.step, -span);
  f.lam = lam_hat + fminf(f.c1, span);
  double fs = 0.0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    f.sg[j] = sigm((f.lam - g.key[j]) * it);
    f.fill0[j] = g.w[j] * f.sg[j];
    fs += (double)f.fill0[j];
  }
  f.f_sum = block_sum1(fs, red, nw, parity);
  f.floor = 1e-9 * d64 + kTiny;
  f.den = fmax(f.f_sum, f.floor);
  f.r64 = d64 / f.den;
  f.r = (float)f.r64;
  return f;
}

__device__ __forceinline__ Seg widths(float prev, float dwell, float av,
                                      float itc, bool locks, float& held,
                                      float& gate) {
  Seg g;
  held = fminf(prev, av);
  gate = locks ? sigm((dwell - 0.5f) * itc) : 0.0f;
  const float locked = gate * held;
  g.w[0] = locked;
  g.w[1] = held - locked;
  g.w[2] = av - held;
  return g;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

size_t fwd_smem(int S, int H) {
  // reduction halves, the level's broadcast; keys + order tiles [H][3S];
  // avail -> alloc and dwell-in tiles [S][H + 1]; demand, level [H];
  // widths by segment [3S]
  return sizeof(double) * kRedDoubles +
         sizeof(float) * (4 + (size_t)2 * H * 3 * S + (size_t)2 * S * (H + 1) +
                          2 * (size_t)H + 3 * (size_t)S);
}

size_t bwd_smem(int S, int H) {
  // reduction halves; keys -> d keys tile [H][3S]; avail -> d avail, g,
  // dwell-in and alloc (hours h0 - 1 ..) tiles [S][H + 1]; demand, level,
  // d demand [H]
  return sizeof(double) * kRedDoubles +
         sizeof(float) * ((size_t)H * 3 * S + (size_t)4 * S * (H + 1) +
                          3 * (size_t)H);
}

template <typename F>
int tile_hours(int S, F smem) {
  int h = kMaxTile;
  while (h > 1 && smem(S, h) > kSmemMax) h >>= 1;
  return h;
}

template <bool kLocks>
__global__ void __launch_bounds__(kMaxThreads) soft_fwd_kernel(
    const float* __restrict__ avail, const float* __restrict__ keys,
    const int* __restrict__ order, const float* __restrict__ demand,
    const float* __restrict__ itau, const float* __restrict__ itaumw,
    float* __restrict__ alloc, float* __restrict__ dwin_out,
    float* __restrict__ lam_out, int S, int T, int min_dwell, int n_bisect,
    int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n3 = 3 * S, pitch = H + 1;
  double* red = reinterpret_cast<double*>(smem_raw);
  float* bcast = reinterpret_cast<float*>(red + kRedDoubles);      // [1]
  float* keys_t = bcast + 4;                                       // [H][3S]
  int* ord_t = reinterpret_cast<int*>(keys_t + (size_t)H * n3);    // [H][3S]
  float* tile = reinterpret_cast<float*>(ord_t + (size_t)H * n3);  // [S][H+1]
  float* dwt = tile + (size_t)S * pitch;                           // [S][H+1]
  float* dem = dwt + (size_t)S * pitch;                            // [H]
  float* lamt = dem + H;                                           // [H]
  float* wseg = lamt + H;                                          // [3S]
  const int tid = threadIdx.x;
  const int nt = blockDim.x, nw = nt >> 5;
  const bool valid = tid < S;
  const bool residuals = dwin_out != nullptr;
  const float it = itau[0], itm = itaumw[0];
  const float itc = it / kCntScale;
  const float span = kSpan / it;
  const float fm = (float)min_dwell;
  int parity = 0;
  float prev = 0.0f, dwell = 0.0f;

  for (int h0 = 0; h0 < T; h0 += H) {
    const int hv = min(H, T - h0);
    __syncthreads();  // the previous tile's write-out has read the tiles
    const float* ksrc = keys + (size_t)h0 * n3;
    const int* osrc = order + (size_t)h0 * n3;
    for (int e = tid; e < hv * n3; e += nt) {
      keys_t[e] = ksrc[e];
      ord_t[e] = osrc[e];
    }
    for (int e = tid; e < S * H; e += nt) {
      const int s = e / H, k = e - s * H;
      if (k < hv) tile[s * pitch + k] = avail[(size_t)s * T + h0 + k];
    }
    for (int k = tid; k < hv; k += nt) dem[k] = demand[h0 + k];
    __syncthreads();

    for (int k = 0; k < hv; ++k) {
      const float* kk = keys_t + (size_t)k * n3;
      const int* oo = ord_t + (size_t)k * n3;
      const double d64 = (double)dem[k];
      Seg g = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
      float held = 0.0f, gate = 0.0f;
      if (nw == 1) __syncwarp();  // last hour's reads of wseg are done
      if (valid) {
        g = widths(prev, dwell, tile[tid * pitch + k], itc, kLocks, held,
                   gate);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          g.key[j] = kk[j * S + tid];
          wseg[j * S + tid] = g.w[j];
        }
      }
      barrier(nw);

      // the hard level: the key of the first sorted segment whose
      // inclusive prefix (float64, in sorted order) reaches the demand,
      // or of the last segment
      float lam0 = 0.0f;
      if (tid == 0) {
        double cum = 0.0;
        int p = 0;
        for (; p < n3 - 1; ++p) {
          cum += (double)wseg[oo[p]];
          if (!(cum < d64)) break;
        }
        lam0 = kk[oo[p]];
      }
      if (nw == 1) {
        lam0 = __shfl_sync(kFull, lam0, 0);
      } else {
        if (tid == 0) *bcast = lam0;
        __syncthreads();
        lam0 = *bcast;
      }

      // bisection of the level from the bracket lam0 +- 40 tau
      float lo = lam0 - span, hi = lam0 + span;
      for (int b = 0; b < n_bisect; ++b) {
        const float mid = 0.5f * (lo + hi);
        double fv = 0.0;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          fv += (double)(g.w[j] * sigm((mid - g.key[j]) * it));
        fv = block_sum1(fv, red, nw, parity);
        if (fv < d64) {
          lo = mid;
        } else {
          hi = mid;
        }
      }
      const float lam_hat = 0.5f * (lo + hi);

      const Fill f = fixed_fill(g, lam_hat, d64, it, span, red, nw, parity);
      if (valid) {
        const float a = (f.fill0[0] * f.r + f.fill0[1] * f.r) +
                        f.fill0[2] * f.r;
        if (residuals) dwt[tid * pitch + k] = dwell;  // entering dwell
        tile[tid * pitch + k] = a;
        if (kLocks) {
          const float mi = sigm(((a - prev) - kDwellEventMw) * itm);
          const float cd = softplus((dwell - 1.0f) * itc) / itc;
          dwell = mi * fm + (1.0f - mi) * cd;
        }
        prev = a;
      }
      if (tid == 0) lamt[k] = lam_hat;
    }
    __syncthreads();
    for (int e = tid; e < S * H; e += nt) {
      const int s = e / H, k = e - s * H;
      if (k < hv) {
        alloc[(size_t)s * T + h0 + k] = tile[s * pitch + k];
        if (residuals) dwin_out[(size_t)s * T + h0 + k] = dwt[s * pitch + k];
      }
    }
    if (residuals)
      for (int k = tid; k < hv; k += nt) lam_out[h0 + k] = lamt[k];
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <bool kLocks>
__global__ void __launch_bounds__(kMaxThreads) soft_bwd_kernel(
    const float* __restrict__ avail, const float* __restrict__ keys,
    const float* __restrict__ demand, const float* __restrict__ alloc,
    const float* __restrict__ dwin, const float* __restrict__ lam,
    const float* __restrict__ gin, const float* __restrict__ itau,
    const float* __restrict__ itaumw, float* __restrict__ d_avail,
    float* __restrict__ d_keys, float* __restrict__ d_demand,
    double* __restrict__ sums, int S, int T, int min_dwell, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n3 = 3 * S, pitch = H + 1;
  double* red = reinterpret_cast<double*>(smem_raw);
  float* keys_t = reinterpret_cast<float*>(red + kRedDoubles);  // [H][3S]
  float* at = keys_t + (size_t)H * n3;   // [S][H+1] avail -> d avail
  float* gt = at + (size_t)S * pitch;    // [S][H+1] cotangent of alloc
  float* dwt = gt + (size_t)S * pitch;   // [S][H+1] entering dwell
  float* al = dwt + (size_t)S * pitch;   // [S][H+1] alloc, hours h0-1 ..
  float* dem = al + (size_t)S * pitch;   // [H]
  float* lamt = dem + H;                 // [H]
  float* ddem = lamt + H;                // [H]
  const int tid = threadIdx.x;
  const int nt = blockDim.x, nw = nt >> 5;
  const bool valid = tid < S;
  const bool want_keys = d_keys != nullptr;
  const float it = itau[0], itm = itaumw[0];
  const float itc = it / kCntScale;
  const float span = kSpan / it;
  const float fm = (float)min_dwell;
  int parity = 0;
  float u_prev = 0.0f, u_dwell = 0.0f;
  double acc_it = 0.0, acc_itm = 0.0;

  const int n_tiles = (T + H - 1) / H;
  for (int ti = n_tiles - 1; ti >= 0; --ti) {
    const int h0 = ti * H, hv = min(H, T - h0);
    __syncthreads();
    const float* ksrc = keys + (size_t)h0 * n3;
    for (int e = tid; e < hv * n3; e += nt) keys_t[e] = ksrc[e];
    for (int e = tid; e < S * pitch; e += nt) {
      const int s = e / pitch, k = e - s * pitch;
      const size_t src = (size_t)s * T + h0 + k;
      if (k < hv) {
        at[e] = avail[src];
        gt[e] = gin[src];
        dwt[e] = dwin[src];
      }
      if (k <= hv) al[e] = (h0 + k > 0) ? alloc[src - 1] : 0.0f;
    }
    for (int k = tid; k < hv; k += nt) {
      dem[k] = demand[h0 + k];
      lamt[k] = lam[h0 + k];
    }
    __syncthreads();

    for (int k = hv - 1; k >= 0; --k) {
      const float* kk = keys_t + (size_t)k * n3;
      const double d64 = (double)dem[k];
      const float lam_hat = lamt[k];
      Seg g = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
      float held = 0.0f, gate = 0.0f, p = 0.0f, av = 0.0f, dw = 0.0f;
      float ua = 0.0f;
      if (valid) {
        av = at[tid * pitch + k];
        p = al[tid * pitch + k];
        dw = dwt[tid * pitch + k];
        ua = gt[tid * pitch + k] + u_prev;
        g = widths(p, dw, av, itc, kLocks, held, gate);
#pragma unroll
        for (int j = 0; j < 3; ++j) g.key[j] = kk[j * S + tid];
      }
      const Fill f = fixed_fill(g, lam_hat, d64, it, span, red, nw, parity);

      // the dwell update
      float d_prev = 0.0f, d_dwell = kLocks ? 0.0f : u_dwell;
      double d_itc = 0.0;
      if (kLocks && valid) {
        const float a = (f.fill0[0] * f.r + f.fill0[1] * f.r) +
                        f.fill0[2] * f.r;
        const float xm = (a - p) - kDwellEventMw;
        const float mi = sigm(xm * itm);
        const float zc = (dw - 1.0f) * itc;
        const float cd = softplus(zc) / itc;
        const float d_mi = u_dwell * (fm - cd);
        const float d_cd = u_dwell * (1.0f - mi);
        const float d_zm = d_mi * mi * (1.0f - mi);
        ua = ua + d_zm * itm;
        d_prev = -(d_zm * itm);
        acc_itm += (double)(d_zm * xm);
        const float d_zc = (d_cd / itc) * sigm(zc);
        d_dwell = d_zc * itc;
        d_itc += (double)(-(d_cd * cd) / itc + d_zc * (dw - 1.0f));
      }

      // the renormalisation, in float64
      double dr = 0.0;
      if (valid) {
#pragma unroll
        for (int j = 0; j < 3; ++j) dr += (double)ua * (double)f.fill0[j];
      }
      dr = block_sum1(dr, red, nw, parity);
      double dd = dr / f.den;
      const double d_den = -dr * f.r64 / f.den;
      const double share = (double)(f.floor < f.f_sum
                                        ? 1.0f
                                        : (f.floor > f.f_sum ? 0.0f : 0.5f));
      dd = dd + 1e-9 * d_den * (1.0 - share);
      const float d_f = (float)(d_den * share);

      float dwj[3], dk[3];
      double dzs = 0.0, dit = 0.0;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float dfill0 = ua * f.r + d_f;
        dwj[j] = dfill0 * f.sg[j];
        const float dz = dfill0 * g.w[j] * f.sg[j] * (1.0f - f.sg[j]);
        dk[j] = -(dz * it);
        if (valid) {
          dzs += (double)dz;
          dit += (double)(dz * (f.lam - g.key[j]));
        }
      }
      const float d_lam = (float)block_sum1(dzs, red, nw, parity) * it;

      // the clip min(max(step, -span), span)
      const float to_c1 = tie_share(f.c1, span);
      const float dc1 = d_lam * to_c1;
      float d_span = d_lam * (1.0f - to_c1);
      const float to_step = 1.0f - tie_share(f.step, -span);
      const float d_step = dc1 * to_step;
      d_span = d_span - dc1 * (1.0f - to_step);
      if (tid == 0) acc_it += (double)(d_span * (-span / it));

      // the Newton step
      const float q = d_step / f.denom;
      dd = dd + (double)q;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        dwj[j] = dwj[j] + (-q) * f.s0[j];
        const float dz0 = (-q) * g.w[j] * f.s0[j] * (1.0f - f.s0[j]);
        dk[j] = dk[j] - dz0 * it;
        if (valid) dit += (double)(dz0 * (lam_hat - g.key[j]));
      }

      // the widths and held = min(prev, avail)
      if (valid) {
        float d_av = dwj[2];
        float d_held;
        if (kLocks) {
          const float d_locked = dwj[0] - dwj[1];
          d_held = (dwj[1] - dwj[2]) + d_locked * gate;
          const float d_zg = d_locked * held * gate * (1.0f - gate);
          d_dwell = d_dwell + d_zg * itc;
          d_itc += (double)(d_zg * (dw - 0.5f));
        } else {
          d_held = dwj[1] - dwj[2];
        }
        const float to_prev = tie_share(p, av);
        d_prev = d_prev + d_held * to_prev;
        d_av = d_av + d_held * (1.0f - to_prev);
        acc_it += dit + d_itc / (double)kCntScale;
        at[tid * pitch + k] = d_av;
        if (want_keys) {
#pragma unroll
          for (int j = 0; j < 3; ++j) keys_t[(size_t)k * n3 + j * S + tid] = dk[j];
        }
      }
      if (tid == 0) ddem[k] = (float)dd;
      u_prev = d_prev;
      u_dwell = d_dwell;
    }
    __syncthreads();
    for (int e = tid; e < S * H; e += nt) {
      const int s = e / H, k = e - s * H;
      if (k < hv) d_avail[(size_t)s * T + h0 + k] = at[s * pitch + k];
    }
    if (want_keys) {
      float* kdst = d_keys + (size_t)h0 * n3;
      for (int e = tid; e < hv * n3; e += nt) kdst[e] = keys_t[e];
    }
    for (int k = tid; k < hv; k += nt) d_demand[h0 + k] = ddem[k];
  }
  double v[2] = {acc_it, acc_itm};
  block_sum<2>(v, red, nw, parity);
  if (tid == 0) {
    sums[0] = v[0];
    sums[1] = v[1];
  }
}

int threads_for(int S) { return ((S + 31) / 32) * 32; }

template <bool kLocks>
int launch_fwd(const float* avail, const float* keys, const int* order,
               const float* demand, const float* itau, const float* itaumw,
               float* alloc, float* dwin, float* lam, int S, int T,
               int min_dwell, int n_bisect, cudaStream_t stream) {
  const int H = tile_hours(S, fwd_smem);
  const size_t smem = fwd_smem(S, H);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      soft_fwd_kernel<kLocks>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  soft_fwd_kernel<kLocks><<<1, threads_for(S), smem, stream>>>(
      avail, keys, order, demand, itau, itaumw, alloc, dwin, lam, S, T,
      min_dwell, n_bisect, H);
  return (int)cudaGetLastError();
}

template <bool kLocks>
int launch_bwd(const float* avail, const float* keys, const float* demand,
               const float* alloc, const float* dwin, const float* lam,
               const float* g, const float* itau, const float* itaumw,
               float* d_avail, float* d_keys, float* d_demand, double* sums,
               int S, int T, int min_dwell, cudaStream_t stream) {
  const int H = tile_hours(S, bwd_smem);
  const size_t smem = bwd_smem(S, H);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      soft_bwd_kernel<kLocks>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  soft_bwd_kernel<kLocks><<<1, threads_for(S), smem, stream>>>(
      avail, keys, demand, alloc, dwin, lam, g, itau, itaumw, d_avail,
      d_keys, d_demand, sums, S, T, min_dwell, H);
  return (int)cudaGetLastError();
}

bool bad_shape(int S, int T, int min_dwell) {
  return S <= 0 || S > kMaxThreads || T <= 0 || min_dwell < 0;
}

int fwd(const float* avail, const float* keys, const int* order,
        const float* demand, const float* itau, const float* itaumw,
        float* alloc, float* dwin, float* lam, int S, int T, int min_dwell,
        int n_bisect, void* stream) {
  if (bad_shape(S, T, min_dwell) || n_bisect < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return min_dwell > 0
             ? launch_fwd<true>(avail, keys, order, demand, itau, itaumw,
                                alloc, dwin, lam, S, T, min_dwell, n_bisect,
                                st)
             : launch_fwd<false>(avail, keys, order, demand, itau, itaumw,
                                 alloc, dwin, lam, S, T, min_dwell, n_bisect,
                                 st);
}

}  // namespace

// The forward alone (the port of _soft_dispatch_kernel).
extern "C" int soft_dispatch_f32(const float* avail, const float* keys,
                                 const int* order, const float* demand,
                                 const float* itau, const float* itaumw,
                                 float* alloc, int S, int T, int min_dwell,
                                 int n_bisect, void* stream) {
  return fwd(avail, keys, order, demand, itau, itaumw, alloc, nullptr,
             nullptr, S, T, min_dwell, n_bisect, stream);
}

// The forward with the residuals of the fused VJP (the port of
// _fused_fwd_kernel): the entering dwell [S, T] and the level [T].
extern "C" int soft_dispatch_fused_fwd_f32(
    const float* avail, const float* keys, const int* order,
    const float* demand, const float* itau, const float* itaumw,
    float* alloc, float* dwin, float* lam, int S, int T, int min_dwell,
    int n_bisect, void* stream) {
  if (dwin == nullptr || lam == nullptr) return (int)cudaErrorInvalidValue;
  return fwd(avail, keys, order, demand, itau, itaumw, alloc, dwin, lam, S,
             T, min_dwell, n_bisect, stream);
}

// The reversed-time backward (the port of _fused_bwd_kernel). d_keys may
// be null; sums receives the float64 totals of d inv_tau and d inv_tau_mw.
extern "C" int soft_dispatch_fused_bwd_f32(
    const float* avail, const float* keys, const float* demand,
    const float* alloc, const float* dwin, const float* lam, const float* g,
    const float* itau, const float* itaumw, float* d_avail, float* d_keys,
    float* d_demand, double* sums, int S, int T, int min_dwell,
    void* stream) {
  if (bad_shape(S, T, min_dwell)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return min_dwell > 0
             ? launch_bwd<true>(avail, keys, demand, alloc, dwin, lam, g, itau,
                                itaumw, d_avail, d_keys, d_demand, sums, S, T,
                                min_dwell, st)
             : launch_bwd<false>(avail, keys, demand, alloc, dwin, lam, g,
                                 itau, itaumw, d_avail, d_keys, d_demand, sums,
                                 S, T, min_dwell, st);
}
