// Hour-by-hour feasible cross-site dispatch for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/dispatch_scan.py::_dispatch_kernel (the hot loop of
// repro.dispatch.dispatch). Computes what
// repro_torch.kernels.ref.dispatch_alloc_hour computes, chained over T
// hours from an empty fleet: each hour, site s offers three capacity
// segments (locked | held - locked | avail - held, with held =
// min(prev, avail) and locked = held where a dwell lock is live), the 3S
// segments are filled greedily in price order up to the hour's demand,
// and each site's allocation and dwell counter carry to the next hour.
//
// Design. The allocation is a true recurrence over hours (the previous
// hour's placement prices retention, the dwell counters gate migration),
// and one instance has no other axis to split: its sites are coupled
// through the shared water level every hour. So ONE block per instance
// loops over the hours; each thread owns one site (a few when S exceeds
// the block) and keeps its prev and dwell in registers. The price sort
// never depends on the running state, so it is precomputed on the host as
// rank [T, 3S] (the inverse of the sort permutation): writing segment j's
// width to sorted position rank[h, j] is the gather by order. Per hour:
//   A. each site thread forms its three widths and scatters them to
//      sw[rank[h, j]]; a width that is negative (or NaN) raises a flag;
//   B. thread 0 walks sw in sorted order, summing the exclusive prefix
//      sequentially in float64 and writing it to pre; it stops at the
//      demand (below) and publishes where;
//   C. each site thread fills clamp(demand - pre[rank[h, j]], 0, width_j)
//      with pre rounded to float32, adds its three fills and updates its
//      dwell counter.
//
// What bounds it is the serial chain on one SM: every hour, the walk's
// dependent float64 additions plus the barriers around it (the bytes are
// 20 S T + 4 T, microseconds at 3.35 TB/s). The design shortens the chain
// three ways:
//   - The walk stops at the demand. The exclusive prefix over the sorted
//     widths never decreases, and neither does its float32 rounding, when
//     every width is >= 0; so once the float64 prefix at sorted position
//     i is >= the demand d (then so is its rounding, d being a float32),
//     every segment at i or later fills min(max(d - pre, 0), w) = 0. The
//     walk sums runs of 8 positions and tests the sum once a run: it
//     stops at the end of the first run whose sum reaches d, and phase C
//     takes +inf for pre at ranks at or past that end, which gives the same 0
//     through the same operations (and where the walk ran past the first
//     such position, pre there is >= d and gives that 0 too). An hour with
//     a negative or NaN width (a caller may pass a negative avail) walks
//     to the end.
//   - The walk runs from registers and does nothing but sum: the sorted
//     widths are read 8 at a time (the next run's loads issued before
//     this run's sums) and the prefix written 8 at a time, from arrays
//     declared not to alias, so no load waits on the store before it.
//     Both arrays hold float64 (where they fit in shared memory): phase A
//     converts each width, phase C each prefix it reads, spread over the
//     site threads, so no conversion (a quarter-rate instruction on this
//     card) is on thread 0's chain. Above ~3000 sites they hold float32
//     and thread 0 converts.
//   - The fixed work of an hour is off the chain: prev and dwell live in
//     registers, the next hour's ranks, availability and demand are read
//     into registers before the barrier, tiles of hours are copied in
//     with cp.async one tile ahead, and when S <= 32 the hour runs in one
//     warp with __syncwarp in place of block barriers.
//
// The summation order, shared bit for bit with the plain version
// (dispatch_alloc_hour, and dispatch_alloc_hour_cut, the mirror of this
// walk): the exclusive prefix is summed sequentially in sorted order in
// float64 and rounded to float32 once; the fills add as (locked + retain)
// + fresh; the dwell rearm compares alloc > prev + 1e-3f in float32. The
// kernel's float arithmetic is additions, subtractions, min and max only:
// there is no multiplication, so no contraction into a fused multiply-add
// can change a result, and none is disabled.
//
// Loads and stores. Each tile of up to 32 hours copies rank [H][3S] (one
// contiguous block of global memory), avail [S][H] (rows of H consecutive
// hours, pitch H + 1 against bank conflicts) and demand [H] into shared
// memory with 4-byte cp.async, into one of two buffers while the other is
// in use; the allocation is written to an [S][H + 1] tile and leaves in
// runs of H consecutive floats. H shrinks (32, 16, ...) until the tiles
// fit the shared memory of a block; if two buffers do not fit even at one
// hour, one buffer is used. The ragged last tile is masked.
//
// No single PyTorch call computes this function, so there is no library
// yardstick. Batching many instances (one block each) is later work.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "mma.cuh"

namespace {

// Kernels this library has launched in this process, counted on the host
// where each launch is issued; kernels_launched() reads it, and the
// wrappers count a call's launches on the card as its difference.
std::atomic<unsigned long long> g_launched{0};

constexpr int kMaxTile = 32;          // hours staged per tile, at most
constexpr int kMaxThreads = 1024;
constexpr size_t kSmemMax = 225 * 1024;  // of the 227 KB a block may use
constexpr float kDwellEventMw = 1e-3f;   // DWELL_EVENT_MW
constexpr unsigned kFull = 0xffffffffu;

// The walk sums runs of 8 positions and tests the sum once a run; the
// sorted widths and the prefix are padded to whole runs.
__host__ __device__ inline int walk_pad(int n3) { return (n3 + 7) / 8 * 8; }

__host__ __device__ inline size_t tile_bytes(int S, int H) {
  // rank [H][3S] int, avail [S][H + 1] float, demand [H] float
  return sizeof(int) * (size_t)H * 3 * S +
         sizeof(float) * ((size_t)S * (H + 1) + H);
}

// floats of the alloc tile [S][H + 1], rounded up to 16 bytes
__host__ __device__ inline size_t otile_floats(int S, int H) {
  return ((size_t)S * (H + 1) + 3) / 4 * 4;
}

size_t smem_bytes(int S, int H, int nbuf, size_t acc_bytes) {
  // nbuf input tiles (each rounded up to 16 bytes), the alloc tile, sw and
  // pre [walk_pad(3S)] of acc_bytes each, the cut
  return nbuf * ((tile_bytes(S, H) + 15) / 16 * 16) +
         sizeof(float) * otile_floats(S, H) +
         2 * acc_bytes * (size_t)walk_pad(3 * S) + 16;
}

// Eight consecutive values as float64, and back.
__device__ __forceinline__ void load8(const double* __restrict__ p,
                                      double (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double2 t = reinterpret_cast<const double2*>(p)[i];
    v[2 * i] = t.x;
    v[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      double (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 t = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = t.x;
    v[4 * i + 1] = t.y;
    v[4 * i + 2] = t.z;
    v[4 * i + 3] = t.w;
  }
}
__device__ __forceinline__ void store8(double* __restrict__ p,
                                       const double (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<double2*>(p)[i] = make_double2(v[2 * i], v[2 * i + 1]);
}
__device__ __forceinline__ void store8(float* __restrict__ p,
                                       const double (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4((float)v[4 * i], (float)v[4 * i + 1], (float)v[4 * i + 2],
                    (float)v[4 * i + 3]);
}

// Thread 0's walk: the exclusive prefix of sw [n3], summed sequentially in
// float64, into pre, in runs of 8 positions with one test of the sum a
// run. Unless `to_end`, it stops at the end of the first run whose sum
// reaches d64 and returns that position; else (or where no run does) it
// returns n3. pre is written below the returned position. The next run's
// loads are issued before this run's sums. sw is zero past n3 up to
// walk_pad(n3).
template <typename Acc>
__device__ __forceinline__ int walk(const Acc* __restrict__ sw,
                                    Acc* __restrict__ pre, int n3,
                                    double d64, bool to_end) {
  double acc = 0.0;
  double cur[8], next[8], pr[8];
  load8(sw, cur);
  for (int p0 = 0;; p0 += 8) {
    const bool more = p0 + 8 < n3;
    if (more) load8(sw + p0 + 8, next);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      pr[i] = acc;
      acc += cur[i];
    }
    store8(pre + p0, pr);
    if (!more) return n3;
    if (!to_end && acc >= d64) return p0 + 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) cur[i] = next[i];
  }
}

// One block per instance. kWarp: S <= 32, one warp, __syncwarp in place
// of block barriers. SPT: sites per thread (S <= SPT * blockDim). Acc: the
// storage of the sorted widths and the prefix (double, or float where
// double does not fit).
template <bool kWarp, int SPT, typename Acc>
__global__ void __launch_bounds__(kMaxThreads) dispatch_scan_kernel(
    const float* __restrict__ avail, const int* __restrict__ rank,
    const float* __restrict__ demand, float* __restrict__ out, int S, int T,
    int min_dwell, int H, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n3 = 3 * S, pitch = H + 1, npad = walk_pad(n3);
  const size_t tb = (tile_bytes(S, H) + 15) / 16 * 16;
  unsigned char* bufs = smem_raw;                                  // [nbuf]
  float* otile = reinterpret_cast<float*>(bufs + nbuf * tb);       // [S][H+1]
  Acc* sw = reinterpret_cast<Acc*>(otile + otile_floats(S, H));    // [npad]
  Acc* pre = sw + npad;                                            // [npad]
  int* cut_s = reinterpret_cast<int*>(pre + npad);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool locks = min_dwell > 0;

  auto rank_of = [&](int buf) {
    return reinterpret_cast<const int*>(bufs + buf * tb);
  };
  auto avail_of = [&](int buf) {
    return reinterpret_cast<const float*>(bufs + buf * tb +
                                          sizeof(int) * (size_t)H * n3);
  };
  // copy tile `t` (hours t H .. ) into buffer `buf`
  auto issue = [&](int t, int buf) {
    const int h0 = t * H, hv = min(H, T - h0);
    unsigned char* base = bufs + buf * tb;
    int* rk = reinterpret_cast<int*>(base);
    float* av = reinterpret_cast<float*>(base + sizeof(int) * (size_t)H * n3);
    float* dm = av + (size_t)S * pitch;
    const int* rsrc = rank + (size_t)h0 * n3;
    for (int e = tid; e < hv * n3; e += nt) cp_async4(rk + e, rsrc + e);
    for (int e = tid; e < S * hv; e += nt) {
      const int s = e / hv, k = e - s * hv;
      cp_async4(av + s * pitch + k, avail + (size_t)s * T + h0 + k);
    }
    for (int k = tid; k < hv; k += nt) cp_async4(dm + k, demand + h0 + k);
  };
  auto sync = [&]() {
    if (kWarp)
      __syncwarp();
    else
      __syncthreads();
  };

  for (int i = n3 + tid; i < npad; i += nt) sw[i] = Acc(0);
  float prev[SPT], dwell[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) prev[q] = dwell[q] = 0.0f;

  const int n_tiles = (T + H - 1) / H;
  if (nbuf == 2) {
    issue(0, 0);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int h0 = t * H, hv = min(H, T - h0);
    const int buf = nbuf == 2 ? (t & 1) : 0;
    if (nbuf == 2) {
      if (t + 1 < n_tiles) issue(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      issue(t, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    sync();  // the tile is in; the last tile's alloc tile has been read
    const int* rk_t = rank_of(buf);
    const float* av_t = avail_of(buf);
    const float* dm_t = av_t + (size_t)S * pitch;

    // this hour's ranks, availability and demand, in registers
    int rk[SPT][3];
    float av[SPT];
    float d = dm_t[0];
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const int s = tid + q * nt;
      if (s < S) {
        av[q] = av_t[s * pitch];
#pragma unroll
        for (int j = 0; j < 3; ++j) rk[q][j] = rk_t[j * S + s];
      }
    }

    for (int k = 0; k < hv; ++k) {
      // A: scatter the widths into sorted order
      bool neg = false;
      float w[SPT][3];
#pragma unroll
      for (int q = 0; q < SPT; ++q) {
        const int s = tid + q * nt;
        if (s < S) {
          const float held = fminf(prev[q], av[q]);
          const float locked = (locks && dwell[q] > 0.0f) ? held : 0.0f;
          w[q][0] = locked;
          w[q][1] = held - locked;
          w[q][2] = av[q] - held;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            sw[rk[q][j]] = (Acc)w[q][j];
            neg |= !(w[q][j] >= 0.0f);
          }
        }
      }
      // the next hour's inputs, read before the barrier
      int nrk[SPT][3];
      float nav[SPT];
      float nd = d;
      if (k + 1 < hv) {
        nd = dm_t[k + 1];
#pragma unroll
        for (int q = 0; q < SPT; ++q) {
          const int s = tid + q * nt;
          if (s < S) {
            nav[q] = av_t[s * pitch + k + 1];
#pragma unroll
            for (int j = 0; j < 3; ++j)
              nrk[q][j] = rk_t[(size_t)(k + 1) * n3 + j * S + s];
          }
        }
      }
      int cut = 0;
      if (kWarp) {
        __syncwarp();
        const bool to_end = __any_sync(kFull, neg);
        if (tid == 0) cut = walk(sw, pre, n3, (double)d, to_end);
        __syncwarp();
        cut = __shfl_sync(kFull, cut, 0);
      } else {
        const bool to_end = __syncthreads_or(neg);
        // B: the prefix, up to the demand
        if (tid == 0) *cut_s = walk(sw, pre, n3, (double)d, to_end);
        __syncthreads();
        cut = *cut_s;
      }
      // C: fill, add the three fills, update the dwell ledger
#pragma unroll
      for (int q = 0; q < SPT; ++q) {
        const int s = tid + q * nt;
        if (s < S) {
          float f[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float before = rk[q][j] < cut
                                     ? (float)pre[rk[q][j]]
                                     : __int_as_float(0x7f800000);
            f[j] = fminf(fmaxf(d - before, 0.0f), w[q][j]);
          }
          const float a = (f[0] + f[1]) + f[2];
          if (locks) {
            dwell[q] = a > prev[q] + kDwellEventMw
                           ? (float)min_dwell
                           : fmaxf(dwell[q] - 1.0f, 0.0f);
          }
          prev[q] = a;
          otile[s * pitch + k] = a;
        }
      }
      if (k + 1 < hv) {
        d = nd;
#pragma unroll
        for (int q = 0; q < SPT; ++q) {
          av[q] = nav[q];
#pragma unroll
          for (int j = 0; j < 3; ++j) rk[q][j] = nrk[q][j];
        }
      }
    }
    sync();  // every site's alloc of the tile is in otile
    for (int e = tid; e < S * hv; e += nt) {
      const int s = e / hv, k = e - s * hv;
      out[(size_t)s * T + h0 + k] = otile[s * pitch + k];
    }
  }
}

template <bool kWarp, int SPT, typename Acc>
int start(const float* avail, const int* rank, const float* demand,
          float* out, int S, int T, int min_dwell, int H, int nbuf,
          size_t smem, int threads, cudaStream_t stream) {
  auto kernel = dispatch_scan_kernel<kWarp, SPT, Acc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, threads, smem, stream>>>(avail, rank, demand, out, S, T,
                                       min_dwell, H, nbuf);
  ++g_launched;
  return (int)cudaGetLastError();
}

// The launch's tile hours H, buffers and shared memory for storage of
// acc_bytes: two buffers at the largest H that fits, else one; false if
// not even one hour fits.
bool plan(int S, size_t acc_bytes, int* H, int* nbuf, size_t* smem) {
  for (int nb = 2; nb >= 1; --nb) {
    int h = kMaxTile;
    while (h > 1 && smem_bytes(S, h, nb, acc_bytes) > kSmemMax) h >>= 1;
    if (smem_bytes(S, h, nb, acc_bytes) <= kSmemMax) {
      *H = h;
      *nbuf = nb;
      *smem = smem_bytes(S, h, nb, acc_bytes);
      return true;
    }
  }
  return false;
}

template <typename Acc>
int start_acc(const float* avail, const int* rank, const float* demand,
              float* out, int S, int T, int min_dwell, int H, int nbuf,
              size_t smem, cudaStream_t st) {
  if (S <= 32)
    return start<true, 1, Acc>(avail, rank, demand, out, S, T, min_dwell, H,
                               nbuf, smem, 32, st);
  const int threads = S < kMaxThreads ? (S + 31) / 32 * 32 : kMaxThreads;
  const int spt = (S + threads - 1) / threads;
  if (spt == 1)
    return start<false, 1, Acc>(avail, rank, demand, out, S, T, min_dwell,
                                H, nbuf, smem, threads, st);
  if (spt == 2)
    return start<false, 2, Acc>(avail, rank, demand, out, S, T, min_dwell,
                                H, nbuf, smem, threads, st);
  if (spt <= 4)
    return start<false, 4, Acc>(avail, rank, demand, out, S, T, min_dwell,
                                H, nbuf, smem, threads, st);
  if (spt <= 8)
    return start<false, 8, Acc>(avail, rank, demand, out, S, T, min_dwell,
                                H, nbuf, smem, threads, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" unsigned long long kernels_launched() {
  return g_launched.load();
}

extern "C" int dispatch_scan_f32(const float* avail, const int* rank,
                                 const float* demand, float* out, int S,
                                 int T, int min_dwell, void* stream) {
  if (S <= 0 || T <= 0 || min_dwell < 0) return (int)cudaErrorInvalidValue;
  int H, nbuf;
  size_t smem;
  cudaStream_t st = (cudaStream_t)stream;
  if (plan(S, sizeof(double), &H, &nbuf, &smem))
    return start_acc<double>(avail, rank, demand, out, S, T, min_dwell, H,
                             nbuf, smem, st);
  if (plan(S, sizeof(float), &H, &nbuf, &smem))
    return start_acc<float>(avail, rank, demand, out, S, T, min_dwell, H,
                            nbuf, smem, st);
  return (int)cudaErrorInvalidValue;
}
