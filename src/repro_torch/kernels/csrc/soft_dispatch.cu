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
// bit for bit. The third launches two kernels, soft_bwd_coef_kernel then
// soft_bwd_chain_kernel. Each hour computes what
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
// chain, run by ONE block that loops over the hours. A group of
// ceil(S / 32) warps holds the S sites, thread s of the group site s and
// its three segments. Every reduction over the 3S segments is a float64
// sum in a fixed order (each thread adds its three float32 terms in
// segment order, a butterfly of shuffles xor 16 .. 1 inside the warp, then
// the warps' partials in warp order), so every thread of a group holds the
// same bits, and the kernels give the same result on every run: no
// atomics.
//
// The forward's hour is one dependent chain: the widths, the hard level,
// n_bisect bisection steps, the two sums of the Newton step and the fill,
// the dwell update. The bisection was most of it (30 of the hour's 33
// sums), so the block holds 2^k - 1 groups and takes k levels of the
// bisection tree a round: from the round's bracket (lo, hi), group j
// evaluates node j + 1 of the tree (heap order), whose bracket it forms by
// replaying the node's path with the same float32 mid = 0.5f (lo + hi),
// and leaves its warps' partials in shared memory; after one block barrier
// every thread walks the k decisions down the tree, summing each node's
// partials in warp order. Every midpoint is the float32 the sequential
// bisection would have formed on that branch and every sum has the
// sequential order, so every comparison, and with it the level, the
// allocation and the dwell, equals the one-step-at-a-time bisection's bit
// for bit. Each evaluation is three float64 exps a thread, and the warps
// of a round share one SM's float64 pipes: a round of 16 or more warps
// takes longer than the levels it saves, so k (levels_for) is the most
// whose groups hold at most kRoundWarps = 16 warps -- 4 at S <= 32 (8
// rounds for 30 steps), 3 at S <= 64, 2 at S <= 160 -- and at least 2
// wherever three groups fit in the block (S <= 320), 1 beyond. (Spreading the
// groups over a cluster of SMs would lift the float64 limit, but a
// cluster barrier costs ~0.6 us on the H100, more than a round saves.)
// The rest of the hour is group 0's: the widths (written by segment, and
// by sorted position through the tile's inverted order), the Newton step
// and the fill (named barrier 1 between its warps), the dwell update;
// while one more warp walks to the hard level (one thread's sequential
// float64 prefix over the sorted widths, in the plain version's order;
// eight widths loaded at a time, the adds one chain, the stop found after
// them), group 0 takes the dwell countdown, which depends on the entering
// dwell alone, and the other groups load the widths.
//
// The backward's hour, reversed, depends on the adjoint of (prev alloc,
// dwell) only through two sums (the renormalisation's and the level's) and
// linear arithmetic around them. Everything else -- the widths, the lock
// gate, the Newton step and the fill, the dwell factors -- depends only on
// the forward's residuals. So one call is two launches: the coefficient
// kernel recomputes those per hour, all hours at once (one group per hour,
// a few hours a block, the grid over every SM), with the forward's
// arithmetic and sum order, and writes them hour-major (with the
// cotangent, transposed) to a scratch buffer the wrapper allocates; the
// chain kernel (one block, one group) walks the hours in reverse with the
// adjoint in registers, reading each hour's coefficients from shared
// memory: tiles of hours arrive by cp.async, the next tile in flight while
// the current one runs. Its float64 divisions by the hour's denominator
// take the reciprocal from the coefficient pass and one fma correction
// (div_rn: the correctly rounded quotient, as the division gives).
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
// residuals and the cotangent [S, T] are site-major. The forward stages
// each tile of up to 32 hours through shared memory with every thread of
// the block (keys, order and its inverse as blocks [H][3S], [S, T] arrays
// as rows of consecutive hours, pitch H + 1), and the outputs leave the
// same way. H shrinks (32, 16, ...) until a tile fits the shared memory of
// a block. The backward's scratch is [T][stride] floats: each hour's
// scalars (float64 den, r64, floor share, 1 / den; float32 r, Newton
// denominator, clip shares), then its per-site coefficients [c][S]; stride
// = 12 + 28 S (20 S without locks) rounded up to 4, so 4 T (12 + 28 S)
// bytes: 8.0 MB at S = 32, T = 2190, 63 MB at 64 x 8760, 1.0 GB at the
// widest, 1024 x 8760 (a chain over chunks of hours would bound it). Blocks
// of up to kSmallBlock threads are built for that size, which leaves a
// thread up to 128 registers (64 in a block of 1024 spill).
//
// Bounds on an H100 SXM. Bytes: the forward must read avail, keys, order,
// demand and write alloc (and dwin, lam), ~36 S T bytes: 20 MB at
// S = 64, T = 8760, 6 us at 3.35 TB/s. Operations are ~100 S T n_bisect
// float32 flops, far below the card's rate. What bounds the design is the
// serial chain: the forward's T x (ceil(n_bisect / k) + 2) dependent
// group-wide float64 sums (each a butterfly of ~90 ns) and a block barrier
// after each round, the backward's T x 2 sums; chip_smoke.py states those
// floors beside the times. No PyTorch call computes this function.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

// Kernels this library has launched in this process, counted on the host
// where each launch is issued; kernels_launched() reads it, and the
// wrappers count a call's launches on the card as its difference.
std::atomic<unsigned long long> g_launched{0};

constexpr int kMaxTile = 32;            // hours staged per tile, at most
constexpr int kMaxThreads = 1024;
// blocks of at most this many threads are built for it, which leaves them
// up to 128 registers a thread (a 1024-thread block, 64)
constexpr int kSmallBlock = 512;
constexpr int kRoundWarps = 16;         // warps a bisection round, at most
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

// A group of warps that reduces together: nw warps, this thread's warp
// wig among them, and the barrier between them (0: __syncthreads, the
// whole block; otherwise a named barrier of the group's nw * 32 threads).
struct Grp {
  int nw, wig, bar;
};

__device__ __forceinline__ void grp_sync(const Grp& gp) {
  if (gp.bar == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(gp.bar), "r"(gp.nw * 32)
                 : "memory");
  }
}

// Sums v[0..N) over the group; every thread of it receives the same bits.
// A group of one warp needs no shared memory and no barrier; a wider one
// alternates between two halves of red.
template <int N>
__device__ __forceinline__ void group_sum(double (&v)[N], double* red,
                                          const Grp& gp, int& parity) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(kFull, v[i], o);
  }
  if (gp.nw == 1) return;
  double* b = red + parity * 64;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) b[i * 32 + gp.wig] = v[i];
  }
  grp_sync(gp);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    double s = 0.0;
    for (int q = 0; q < gp.nw; ++q) s += b[i * 32 + q];
    v[i] = s;
  }
  parity ^= 1;
}

__device__ __forceinline__ double group_sum1(double x, double* red,
                                             const Grp& gp, int& parity) {
  double v[1] = {x};
  group_sum<1>(v, red, gp, parity);
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
                                           double* red, const Grp& gp,
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
  group_sum<2>(v, red, gp, parity);
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
  f.f_sum = group_sum1(fs, red, gp, parity);
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

__host__ __device__ int warps_for(int S) { return (S + 31) / 32; }

template <typename F>
int tile_hours(int S, F smem) {
  int h = kMaxTile;
  while (h > 1 && smem(S, h) > kSmemMax) h >>= 1;
  return h;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// The bisection levels a round: the most whose tree of 2^k - 1 nodes, a
// group of ceil(S / 32) warps each, holds at most kRoundWarps warps (more
// contend for one SM's float64 pipes: measured at 32 and 64 sites), and at
// least two wherever three groups fit in the block's 32 warps.
int levels_for(int S) {
  const int gw = warps_for(S);
  int k = 1;
  while (((2 << k) - 1) * gw <= kRoundWarps) ++k;
  if (k == 1 && 3 * gw <= 32) k = 2;
  return k;
}

// The block: the groups, and one more warp to walk to the hard level while
// they load the widths, where it fits.
int fwd_threads(int S) {
  const int w = ((1 << levels_for(S)) - 1) * warps_for(S);
  return (w < 32 ? w + 1 : w) * 32;
}

// The sorted widths are read eight at a time; their buffer is padded.
__host__ __device__ int seg_pad(int S) { return (3 * S + 7) / 8 * 8 + 8; }

// The sorted position of the hard level: of the first segment whose
// inclusive prefix of the sorted widths (summed in float64, in order)
// reaches the demand, or of the last segment. One thread; the widths are
// loaded eight at a time (the buffer is padded), the adds are one chain and
// the stop is found after them.
__device__ __forceinline__ int hard_level_pos(const float* wsort, int n3,
                                              double d64) {
  const int last = n3 - 1;
  double cum = 0.0;
  for (int p0 = 0;; p0 += 8) {
    const float4 a = *reinterpret_cast<const float4*>(wsort + p0);
    const float4 b = *reinterpret_cast<const float4*>(wsort + p0 + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    double c[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      cum += (double)v[i];
      c[i] = cum;
    }
    int stop = 8;
#pragma unroll
    for (int i = 7; i >= 0; --i)
      if (p0 + i >= last || !(c[i] < d64)) stop = i;
    if (stop < 8) return p0 + stop;
  }
}

size_t fwd_smem(int S, int H) {
  // the Newton step's reduction halves, the rounds' partials [2][32]; the
  // level's broadcast; widths by sorted position and by segment; keys,
  // order and its inverse tiles [H][3S]; avail -> alloc and dwell-in tiles
  // [S][H + 1]; demand, level [H]
  return sizeof(double) * (kRedDoubles + 64) +
         sizeof(float) * (4 + 2 * (size_t)seg_pad(S) +
                          (size_t)3 * H * 3 * S + (size_t)2 * S * (H + 1) +
                          2 * (size_t)H);
}

template <bool kLocks, int kThreads>
__global__ void __launch_bounds__(kThreads, 1) soft_fwd_kernel(
    const float* __restrict__ avail, const float* __restrict__ keys,
    const int* __restrict__ order, const float* __restrict__ demand,
    const float* __restrict__ itau, const float* __restrict__ itaumw,
    float* __restrict__ alloc, float* __restrict__ dwin_out,
    float* __restrict__ lam_out, int S, int T, int min_dwell, int n_bisect,
    int H, int levels) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n3 = 3 * S, pitch = H + 1, npad = seg_pad(S);
  double* red = reinterpret_cast<double*>(smem_raw);               // group 0
  double* rred = red + kRedDoubles;                                // [2][32]
  float* bcast = reinterpret_cast<float*>(rred + 64);              // [4]
  float* wsort = bcast + 4;                                        // [npad]
  float* wseg = wsort + npad;                                      // [npad]
  float* keys_t = wseg + npad;                                     // [H][3S]
  int* ord_t = reinterpret_cast<int*>(keys_t + (size_t)H * n3);    // [H][3S]
  int* rank_t = ord_t + (size_t)H * n3;                            // [H][3S]
  float* tile = reinterpret_cast<float*>(rank_t + (size_t)H * n3); // [S][H+1]
  float* dwt = tile + (size_t)S * pitch;                           // [S][H+1]
  float* dem = dwt + (size_t)S * pitch;                            // [H]
  float* lamt = dem + H;                                           // [H]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int gw = warps_for(S);              // warps a group
  const int groups = (1 << levels) - 1;
  const int grp = (tid >> 5) / gw;          // this thread's group
  const int site = tid - grp * gw * 32;     // its site within the group
  const bool valid = grp < groups && site < S;
  const bool owner = grp == 0 && valid;     // group 0 carries the state
  // the walk to the hard level: the warp after the groups, or thread 0
  const int walker = nt > groups * gw * 32 ? groups * gw * 32 : 0;
  const Grp g0 = {gw, tid >> 5, nt > gw * 32 ? 1 : 0};
  const bool residuals = dwin_out != nullptr;
  const float it = itau[0], itm = itaumw[0];
  const float itc = it / kCntScale;
  const float span = kSpan / it;
  const float fm = (float)min_dwell;
  int parity = 0, rpar = 0;
  float prev = 0.0f, dwell = 0.0f;
  for (int e = tid; e < npad; e += nt) wsort[e] = 0.0f;

  for (int h0 = 0; h0 < T; h0 += H) {
    const int hv = min(H, T - h0);
    __syncthreads();  // the previous tile's write-out has read the tiles
    const float* ksrc = keys + (size_t)h0 * n3;
    const int* osrc = order + (size_t)h0 * n3;
    for (int e = tid; e < hv * n3; e += nt) {
      const int o = osrc[e];
      keys_t[e] = ksrc[e];
      ord_t[e] = o;
      const int k = e / n3;
      rank_t[k * n3 + o] = e - k * n3;
    }
    for (int e = tid; e < S * H; e += nt) {
      const int s = e / H, k = e - s * H;
      if (k < hv) tile[s * pitch + k] = avail[(size_t)s * T + h0 + k];
    }
    for (int k = tid; k < hv; k += nt) dem[k] = demand[h0 + k];
    __syncthreads();

    for (int k = 0; k < hv; ++k) {
      const float* kk = keys_t + (size_t)k * n3;
      const double d64 = (double)dem[k];
      Seg g = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
      float held = 0.0f, gate = 0.0f, cd = 0.0f;
      if (owner) {
        const int* rk = rank_t + (size_t)k * n3;
        g = widths(prev, dwell, tile[site * pitch + k], itc, kLocks, held,
                   gate);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          g.key[j] = kk[j * S + site];
          wseg[j * S + site] = g.w[j];
          wsort[rk[j * S + site]] = g.w[j];
        }
      }
      __syncthreads();

      // the hard level: the key of the first sorted segment whose
      // inclusive prefix (float64, in sorted order) reaches the demand, or
      // of the last segment; meanwhile the other groups load the widths,
      // and group 0 takes the dwell update's countdown, which depends on
      // the entering dwell alone
      if (tid == walker) {
        const int p = hard_level_pos(wsort, n3, d64);
        bcast[0] = kk[ord_t[(size_t)k * n3 + p]];
      } else if (grp > 0 && valid) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          g.w[j] = wseg[j * S + site];
          g.key[j] = kk[j * S + site];
        }
      }
      if (kLocks && owner) cd = softplus((dwell - 1.0f) * itc) / itc;
      __syncthreads();
      const float lam0 = bcast[0];

      // the bisection from the bracket lam0 +- 40 tau, k levels a round:
      // group j evaluates node j + 1 of the round's tree and leaves its
      // warps' partials; every thread then walks the round's decisions
      float lo = lam0 - span, hi = lam0 + span;
      for (int b = 0; b < n_bisect; b += levels) {
        const int nl = min(levels, n_bisect - b);
        double* part = rred + rpar * 32;
        if (grp < (1 << nl) - 1) {
          const int node = grp + 1;
          float l = lo, u = hi;
          for (int d = 30 - __clz(node); d >= 0; --d) {
            const float m = 0.5f * (l + u);
            if ((node >> d) & 1) {
              l = m;
            } else {
              u = m;
            }
          }
          const float mid = 0.5f * (l + u);
          double fv = 0.0;
#pragma unroll
          for (int j = 0; j < 3; ++j)
            fv += (double)(g.w[j] * sigm((mid - g.key[j]) * it));
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            fv += __shfl_xor_sync(kFull, fv, o);
          if ((tid & 31) == 0) part[tid >> 5] = fv;  // [node - 1][warp]
        }
        __syncthreads();
        int node = 1;
        for (int d = 0; d < nl; ++d) {
          const float mid = 0.5f * (lo + hi);
          double fv;
          if (gw == 1) {
            fv = part[node - 1];
          } else {
            fv = 0.0;
            for (int q = 0; q < gw; ++q) fv += part[(node - 1) * gw + q];
          }
          if (fv < d64) {
            lo = mid;
            node = 2 * node + 1;
          } else {
            hi = mid;
            node = 2 * node;
          }
        }
        rpar ^= 1;
      }
      const float lam_hat = 0.5f * (lo + hi);

      if (grp == 0) {
        const Fill f = fixed_fill(g, lam_hat, d64, it, span, red, g0, parity);
        if (valid) {
          const float a = (f.fill0[0] * f.r + f.fill0[1] * f.r) +
                          f.fill0[2] * f.r;
          if (residuals) dwt[site * pitch + k] = dwell;  // entering dwell
          tile[site * pitch + k] = a;
          if (kLocks) {
            const float mi = sigm(((a - prev) - kDwellEventMw) * itm);
            dwell = mi * fm + (1.0f - mi) * cd;
          }
          prev = a;
        }
        if (tid == 0) lamt[k] = lam_hat;
      }
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

// An hour's record in the scratch buffer: float64 den, r64, the floor's
// share, 1 / den, float32 r, the Newton denominator, the clip's shares
// to c1 and to the step; then each coefficient c of the sites at
// kHead + c S + s.
constexpr int kHead = 12;
enum Coef {
  kG = 0,       // the cotangent of the allocation
  kW = 1,       // the widths, 3
  kS0 = 4,      // sigmoid at lam_hat, 3
  kSg = 7,      // sigmoid at the Newton level, 3
  kF0 = 10,     // the fill before renormalisation, 3
  kLk = 13,     // Newton level - key, 3
  kL0k = 16,    // lam_hat - key, 3
  kToPrev = 19, // tie share of min(prev, avail) to prev
  kGate = 20,   // with locks: the gate, held, and the dwell update's
  kHeld = 21,   // mi, cd, xm, sigmoid(zc), dwell - 1, dwell - 1/2
  kMi = 22,
  kCd = 23,
  kXm = 24,
  kSz = 25,
  kDw1 = 26,
  kDwh = 27,
};

__host__ __device__ int coefs(bool locks) { return locks ? 28 : 20; }

// floats per hour, a multiple of four (16-byte cp.async chunks)
__host__ __device__ int rec_stride(int S, bool locks) {
  return (kHead + coefs(locks) * S + 3) / 4 * 4;
}

int coef_hours_per_block(int S) {
  const int w = warps_for(S);
  return w < 8 ? 8 / w : 1;
}

template <bool kLocks>
__global__ void __launch_bounds__(kMaxThreads) soft_bwd_coef_kernel(
    const float* __restrict__ avail, const float* __restrict__ keys,
    const float* __restrict__ demand, const float* __restrict__ alloc,
    const float* __restrict__ dwin, const float* __restrict__ lam,
    const float* __restrict__ gin, const float* __restrict__ itau,
    const float* __restrict__ itaumw, float* __restrict__ coef, int S, int T,
    int stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int gw = warps_for(S), n3 = 3 * S;
  const int grp = (tid >> 5) / gw;
  const int site = tid - grp * gw * 32;
  double* red = reinterpret_cast<double*>(smem_raw) + grp * kRedDoubles;
  const Grp gp = {gw, (tid >> 5) - grp * gw, 0};
  const int h = blockIdx.x * (blockDim.x / (gw * 32)) + grp;
  const bool hour = h < T;          // every group runs the same barriers
  const bool valid = hour && site < S;
  const float it = itau[0], itm = itaumw[0];
  const float itc = it / kCntScale;
  const float span = kSpan / it;
  int parity = 0;

  Seg g = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  float held = 0.0f, gate = 0.0f, p = 0.0f, av = 0.0f, dw = 0.0f;
  if (valid) {
    const size_t at = (size_t)site * T + h;
    av = avail[at];
    p = h > 0 ? alloc[at - 1] : 0.0f;
    dw = dwin[at];
    g = widths(p, dw, av, itc, kLocks, held, gate);
#pragma unroll
    for (int j = 0; j < 3; ++j) g.key[j] = keys[(size_t)h * n3 + j * S + site];
  }
  const float lam_hat = hour ? lam[h] : 0.0f;
  const double d64 = hour ? (double)demand[h] : 0.0;
  const Fill f = fixed_fill(g, lam_hat, d64, it, span, red, gp, parity);
  if (!hour) return;
  float* rec = coef + (size_t)h * stride;
  if (valid) {
    float* c = rec + kHead + site;
    c[kG * S] = gin[(size_t)site * T + h];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c[(kW + j) * S] = g.w[j];
      c[(kS0 + j) * S] = f.s0[j];
      c[(kSg + j) * S] = f.sg[j];
      c[(kF0 + j) * S] = f.fill0[j];
      c[(kLk + j) * S] = f.lam - g.key[j];
      c[(kL0k + j) * S] = lam_hat - g.key[j];
    }
    c[kToPrev * S] = tie_share(p, av);
    if (kLocks) {
      const float a = (f.fill0[0] * f.r + f.fill0[1] * f.r) +
                      f.fill0[2] * f.r;
      const float xm = (a - p) - kDwellEventMw;
      const float zc = (dw - 1.0f) * itc;
      c[kGate * S] = gate;
      c[kHeld * S] = held;
      c[kMi * S] = sigm(xm * itm);
      c[kCd * S] = softplus(zc) / itc;
      c[kXm * S] = xm;
      c[kSz * S] = sigm(zc);
      c[kDw1 * S] = dw - 1.0f;
      c[kDwh * S] = dw - 0.5f;
    }
  }
  if (tid == grp * gw * 32) {
    double* d = reinterpret_cast<double*>(rec);
    d[0] = f.den;
    d[1] = f.r64;
    d[2] = (double)(f.floor < f.f_sum ? 1.0f
                                      : (f.floor > f.f_sum ? 0.0f : 0.5f));
    d[3] = 1.0 / f.den;
    rec[8] = f.r;
    rec[9] = f.denom;
    rec[10] = tie_share(f.c1, span);
    rec[11] = 1.0f - tie_share(f.step, -span);
  }
}

// x / y correctly rounded, from ry = 1 / y correctly rounded: q = x ry is
// within an ulp of x / y, the remainder x - q y is exact with one fma, and
// one more fma rounds q + r ry to the quotient x / y would round to
// (Markstein's theorem, for quotients that neither overflow nor underflow;
// an exact q is kept, with the sign of a zero). Three dependent operations
// where the division is a longer sequence, on the chain's path.
__device__ __forceinline__ double div_rn(double x, double y, double ry) {
  const double q = x * ry;
  const double r = fma(-q, y, x);
  return r == 0.0 ? q : fma(r, ry, q);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

size_t chain_smem(int S, int H, bool locks, int stages) {
  // reduction halves; the records of a tile of H hours, per stage; the
  // d avail tile [S][H + 1]
  return sizeof(double) * kRedDoubles +
         sizeof(float) * ((size_t)stages * H * rec_stride(S, locks) +
                          (size_t)S * (H + 1));
}

template <bool kLocks, int kThreads>
__global__ void __launch_bounds__(kThreads, 1) soft_bwd_chain_kernel(
    const float* __restrict__ coef, const float* __restrict__ itau,
    const float* __restrict__ itaumw, float* __restrict__ d_avail,
    float* __restrict__ d_keys, float* __restrict__ d_demand,
    double* __restrict__ sums, int S, int T, int min_dwell, int H,
    int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n3 = 3 * S, pitch = H + 1;
  const int stride = rec_stride(S, kLocks);
  double* red = reinterpret_cast<double*>(smem_raw);
  float* stage = reinterpret_cast<float*>(red + kRedDoubles);  // [st][H][.]
  float* at = stage + (size_t)stages * H * stride;             // [S][H+1]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const Grp gp = {nt >> 5, tid >> 5, 0};
  const bool valid = tid < S;
  const bool want_keys = d_keys != nullptr;
  const float it = itau[0], itm = itaumw[0];
  const float itc = it / kCntScale;
  const float span = kSpan / it;
  const float fm = (float)min_dwell;
  int parity = 0;
  float u_prev = 0.0f, u_dwell = 0.0f;
  double acc_it = 0.0, acc_itm = 0.0;

  // copies tile ti's records into stage st (16 bytes a thread a step)
  auto fetch = [&](int ti, int st) {
    const int h0 = ti * H, hv = min(H, T - h0);
    const float4* src =
        reinterpret_cast<const float4*>(coef + (size_t)h0 * stride);
    float4* dst = reinterpret_cast<float4*>(stage + (size_t)st * H * stride);
    const int n = hv * stride / 4;
    for (int e = tid; e < n; e += nt) cp_async16(dst + e, src + e);
    cp_async_commit();
  };

  const int n_tiles = (T + H - 1) / H;
  int st = 0;
  if (stages == 2) fetch(n_tiles - 1, 0);
  for (int ti = n_tiles - 1; ti >= 0; --ti, st ^= stages - 1) {
    const int h0 = ti * H, hv = min(H, T - h0);
    if (stages == 1) {
      fetch(ti, 0);
      cp_async_wait<0>();
    } else if (ti > 0) {
      fetch(ti - 1, st ^ 1);  // the next tile, in flight while this one runs
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this tile have landed

    for (int k = hv - 1; k >= 0; --k) {
      const float* rec = stage + ((size_t)st * H + k) * stride;
      const double* rd = reinterpret_cast<const double*>(rec);
      const double den = rd[0], r64 = rd[1], share = rd[2], rden = rd[3];
      const float r = rec[8], denom = rec[9];
      const float* c = rec + kHead + tid;
      float cf[kDwh + 1];
#pragma unroll
      for (int i = 0; i <= (kLocks ? kDwh : kToPrev); ++i)
        cf[i] = valid ? c[i * S] : 0.0f;
      float ua = 0.0f;
      if (valid) ua = cf[kG] + u_prev;

      // the dwell update
      float d_prev = 0.0f, d_dwell = kLocks ? 0.0f : u_dwell;
      double d_itc = 0.0;
      if (kLocks && valid) {
        const float mi = cf[kMi], cd = cf[kCd];
        const float d_mi = u_dwell * (fm - cd);
        const float d_cd = u_dwell * (1.0f - mi);
        const float d_zm = d_mi * mi * (1.0f - mi);
        ua = ua + d_zm * itm;
        d_prev = -(d_zm * itm);
        acc_itm += (double)(d_zm * cf[kXm]);
        const float d_zc = (d_cd / itc) * cf[kSz];
        d_dwell = d_zc * itc;
        d_itc += (double)(-(d_cd * cd) / itc + d_zc * cf[kDw1]);
      }

      // the renormalisation, in float64
      double dr = 0.0;
      if (valid) {
#pragma unroll
        for (int j = 0; j < 3; ++j) dr += (double)ua * (double)cf[kF0 + j];
      }
      dr = group_sum1(dr, red, gp, parity);
      double dd = div_rn(dr, den, rden);
      const double d_den = div_rn(-dr * r64, den, rden);
      dd = dd + 1e-9 * d_den * (1.0 - share);
      const float d_f = (float)(d_den * share);

      float dwj[3], dk[3];
      double dzs = 0.0, dit = 0.0;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float sg = cf[kSg + j];
        const float dfill0 = ua * r + d_f;
        dwj[j] = dfill0 * sg;
        const float dz = dfill0 * cf[kW + j] * sg * (1.0f - sg);
        dk[j] = -(dz * it);
        if (valid) {
          dzs += (double)dz;
          dit += (double)(dz * cf[kLk + j]);
        }
      }
      const float d_lam = (float)group_sum1(dzs, red, gp, parity) * it;

      // the clip min(max(step, -span), span)
      const float to_c1 = rec[10];
      const float dc1 = d_lam * to_c1;
      float d_span = d_lam * (1.0f - to_c1);
      const float to_step = rec[11];
      const float d_step = dc1 * to_step;
      d_span = d_span - dc1 * (1.0f - to_step);
      if (tid == 0) acc_it += (double)(d_span * (-span / it));

      // the Newton step
      const float q = d_step / denom;
      dd = dd + (double)q;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float s0 = cf[kS0 + j];
        dwj[j] = dwj[j] + (-q) * s0;
        const float dz0 = (-q) * cf[kW + j] * s0 * (1.0f - s0);
        dk[j] = dk[j] - dz0 * it;
        if (valid) dit += (double)(dz0 * cf[kL0k + j]);
      }

      // the widths and held = min(prev, avail)
      if (valid) {
        float d_av = dwj[2];
        float d_held;
        if (kLocks) {
          const float gate = cf[kGate];
          const float d_locked = dwj[0] - dwj[1];
          d_held = (dwj[1] - dwj[2]) + d_locked * gate;
          const float d_zg = d_locked * cf[kHeld] * gate * (1.0f - gate);
          d_dwell = d_dwell + d_zg * itc;
          d_itc += (double)(d_zg * cf[kDwh]);
        } else {
          d_held = dwj[1] - dwj[2];
        }
        const float to_prev = cf[kToPrev];
        d_prev = d_prev + d_held * to_prev;
        d_av = d_av + d_held * (1.0f - to_prev);
        acc_it += dit + div_rn(d_itc, (double)kCntScale, 1.0 / kCntScale);
        at[tid * pitch + k] = d_av;
        if (want_keys) {
          float* kd = d_keys + (size_t)(h0 + k) * n3 + tid;
#pragma unroll
          for (int j = 0; j < 3; ++j) kd[j * S] = dk[j];
        }
      }
      if (tid == 0) d_demand[h0 + k] = (float)dd;
      u_prev = d_prev;
      u_dwell = d_dwell;
    }
    __syncthreads();  // the tile's records are read and its d avail written
    for (int e = tid; e < S * H; e += nt) {
      const int s = e / H, k = e - s * H;
      if (k < hv) d_avail[(size_t)s * T + h0 + k] = at[s * pitch + k];
    }
  }
  double v[2] = {acc_it, acc_itm};
  group_sum<2>(v, red, gp, parity);
  if (tid == 0) {
    sums[0] = v[0];
    sums[1] = v[1];
  }
}

template <bool kLocks, int kThreads>
int launch_fwd_block(const float* avail, const float* keys, const int* order,
                     const float* demand, const float* itau,
                     const float* itaumw, float* alloc, float* dwin,
                     float* lam, int S, int T, int min_dwell, int n_bisect,
                     cudaStream_t stream) {
  const int H = tile_hours(S, fwd_smem);
  const size_t smem = fwd_smem(S, H);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      soft_fwd_kernel<kLocks, kThreads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  soft_fwd_kernel<kLocks, kThreads><<<1, fwd_threads(S), smem, stream>>>(
      avail, keys, order, demand, itau, itaumw, alloc, dwin, lam, S, T,
      min_dwell, n_bisect, H, levels_for(S));
  ++g_launched;
  return (int)cudaGetLastError();
}

template <bool kLocks>
int launch_fwd(const float* avail, const float* keys, const int* order,
               const float* demand, const float* itau, const float* itaumw,
               float* alloc, float* dwin, float* lam, int S, int T,
               int min_dwell, int n_bisect, cudaStream_t stream) {
  return fwd_threads(S) <= kSmallBlock
             ? launch_fwd_block<kLocks, kSmallBlock>(
                   avail, keys, order, demand, itau, itaumw, alloc, dwin, lam,
                   S, T, min_dwell, n_bisect, stream)
             : launch_fwd_block<kLocks, kMaxThreads>(
                   avail, keys, order, demand, itau, itaumw, alloc, dwin, lam,
                   S, T, min_dwell, n_bisect, stream);
}

template <bool kLocks, int kThreads>
int launch_chain(const float* scratch, const float* itau,
                 const float* itaumw, float* d_avail, float* d_keys,
                 float* d_demand, double* sums, int S, int T, int min_dwell,
                 cudaStream_t stream) {
  int stages = 2;
  auto smem2 = [](int s, int h) { return chain_smem(s, h, kLocks, 2); };
  int H = tile_hours(S, smem2);
  if (smem2(S, H) > kSmemMax) {
    stages = 1;
    H = tile_hours(S, [](int s, int h) { return chain_smem(s, h, kLocks, 1); });
  }
  const size_t smem = chain_smem(S, H, kLocks, stages);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      soft_bwd_chain_kernel<kLocks, kThreads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  soft_bwd_chain_kernel<kLocks, kThreads>
      <<<1, warps_for(S) * 32, smem, stream>>>(scratch, itau, itaumw, d_avail,
                                               d_keys, d_demand, sums, S, T,
                                               min_dwell, H, stages);
  ++g_launched;
  return (int)cudaGetLastError();
}

template <bool kLocks>
int launch_bwd(const float* avail, const float* keys, const float* demand,
               const float* alloc, const float* dwin, const float* lam,
               const float* g, const float* itau, const float* itaumw,
               float* d_avail, float* d_keys, float* d_demand, double* sums,
               float* scratch, int S, int T, int min_dwell,
               cudaStream_t stream) {
  const int stride = rec_stride(S, kLocks);
  const int hb = coef_hours_per_block(S);
  const int coef_threads = hb * warps_for(S) * 32;
  const size_t coef_smem = sizeof(double) * kRedDoubles * hb;
  soft_bwd_coef_kernel<kLocks>
      <<<(T + hb - 1) / hb, coef_threads, coef_smem, stream>>>(
          avail, keys, demand, alloc, dwin, lam, g, itau, itaumw, scratch,
          S, T, stride);
  ++g_launched;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return warps_for(S) * 32 <= kSmallBlock
             ? launch_chain<kLocks, kSmallBlock>(scratch, itau, itaumw,
                                                 d_avail, d_keys, d_demand,
                                                 sums, S, T, min_dwell, stream)
             : launch_chain<kLocks, kMaxThreads>(scratch, itau, itaumw,
                                                 d_avail, d_keys, d_demand,
                                                 sums, S, T, min_dwell, stream);
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

extern "C" unsigned long long kernels_launched() {
  return g_launched.load();
}

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

// The bisection levels the forward takes a round at S sites, and its
// block's threads.
extern "C" int soft_dispatch_fwd_levels(int S) { return levels_for(S); }
extern "C" int soft_dispatch_fwd_threads(int S) { return fwd_threads(S); }

// Floats of the backward's scratch buffer for S sites and T hours.
extern "C" long long soft_dispatch_bwd_scratch_floats(int S, int T,
                                                      int min_dwell) {
  return (long long)T * rec_stride(S, min_dwell > 0);
}

// The reversed-time backward (the port of _fused_bwd_kernel): the
// coefficient kernel, then the chain kernel, on the stream. d_keys may be
// null; sums receives the float64 totals of d inv_tau and d inv_tau_mw;
// scratch holds soft_dispatch_bwd_scratch_floats(S, T, min_dwell) floats,
// 16-byte aligned.
extern "C" int soft_dispatch_fused_bwd_f32(
    const float* avail, const float* keys, const float* demand,
    const float* alloc, const float* dwin, const float* lam, const float* g,
    const float* itau, const float* itaumw, float* d_avail, float* d_keys,
    float* d_demand, double* sums, float* scratch, int S, int T,
    int min_dwell, void* stream) {
  if (bad_shape(S, T, min_dwell) || scratch == nullptr ||
      reinterpret_cast<size_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return min_dwell > 0
             ? launch_bwd<true>(avail, keys, demand, alloc, dwin, lam, g, itau,
                                itaumw, d_avail, d_keys, d_demand, sums,
                                scratch, S, T, min_dwell, st)
             : launch_bwd<false>(avail, keys, demand, alloc, dwin, lam, g,
                                 itau, itaumw, d_avail, d_keys, d_demand, sums,
                                 scratch, S, T, min_dwell, st);
}
