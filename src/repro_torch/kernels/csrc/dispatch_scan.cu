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
// through the shared water level every hour. The TPU carries prev and
// dwell in VMEM down a sequential time grid; on Hopper blocks run in no
// order, so ONE block per instance loops over the hours and keeps prev
// and dwell [S] in shared memory, owned by the site's thread. The price
// sort never depends on the running state, so it is precomputed on the
// host as rank [T, 3S] (the inverse of the sort permutation): writing
// segment j's width to sorted position rank[h, j] is the gather by order,
// so the kernel reads rank and never order. Per hour:
//   A. each thread (one per site, looping when S > blockDim) forms its
//      three widths and scatters them to sw[rank[h, j]];   __syncthreads
//   B. thread 0 walks sw in sorted order and writes the exclusive prefix
//      pre[i] (MW at strictly cheaper segments);            __syncthreads
//   C. each site thread reads before_j = pre[rank[h, j]], fills
//      clamp(demand - before_j, 0, width_j), adds its three fills and
//      updates its dwell counter.
// C reads only pre and the thread's own state, so the next hour's A may
// overwrite sw at once: two barriers per hour.
//
// The summation order, shared bit for bit with the plain version
// (dispatch_alloc_hour): the exclusive prefix is summed sequentially in
// sorted order in float64 and rounded to float32 once; the fills add as
// (locked + retain) + fresh; the dwell rearm compares alloc > prev +
// 1e-3f in float32. The kernel's float arithmetic is additions,
// subtractions, min and max only: there is no multiplication, so no
// contraction into a fused multiply-add can change a result, and none is
// disabled.
//
// Loads and stores. Each tile of up to 32 hours stages rank [H][3S]
// (one contiguous block of global memory), avail [S][H] (rows of H
// consecutive hours, pitch H + 1 against bank conflicts) and demand [H]
// through shared memory; the allocation overwrites avail in place and
// leaves as [S][H] rows, so the [S, T] output is written in runs of H
// consecutive floats, not one strided float per thread per hour. H
// shrinks (32, 16, ...) until the tile fits the shared memory of a block
// (S = 512 runs 16-hour tiles). The ragged last tile is masked; nothing
// is written past T.
//
// Bound on an H100 SXM: the function must read avail and rank and write
// alloc, 20 S T + 4 T bytes (11.2 MB at S = 64, T = 8760: 3.35 us at
// 3.35 TB/s; order, 12 S T more, is redundant given rank). What bounds
// this design is the serial chain on one SM: T hours, each at least 3S
// dependent float64 additions in thread 0 plus two barriers (chip_smoke.py
// times a chain of dependent float64 additions on the card to state that
// floor). No single PyTorch call computes this function, so there is no
// library yardstick. Batching many instances (one block each) is a later
// PR's work.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

// Kernels this library has launched in this process, counted on the host
// where each launch is issued; kernels_launched() reads it, and the
// wrappers count a call's launches on the card as its difference.
std::atomic<unsigned long long> g_launched{0};

constexpr int kMaxTile = 32;          // hours staged per tile, at most
constexpr int kMaxThreads = 1024;
constexpr size_t kSmemMax = 225 * 1024;  // of the 227 KB a block may use
constexpr float kDwellEventMw = 1e-3f;   // DWELL_EVENT_MW

size_t smem_bytes(int S, int H) {
  // rank tile [H][3S] int; avail/alloc tile [S][H + 1], demand [H],
  // sorted widths [3S], prefix [3S], prev [S], dwell [S] float
  return sizeof(int) * (size_t)H * 3 * S +
         sizeof(float) * ((size_t)S * (H + 1) + H + 8 * (size_t)S);
}

int tile_hours(int S) {
  int h = kMaxTile;
  while (h > 1 && smem_bytes(S, h) > kSmemMax) h >>= 1;
  return h;
}

__global__ void __launch_bounds__(kMaxThreads) dispatch_scan_kernel(
    const float* __restrict__ avail, const int* __restrict__ rank,
    const float* __restrict__ demand, float* __restrict__ out, int S, int T,
    int min_dwell, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n3 = 3 * S;
  const int pitch = H + 1;
  int* rank_t = reinterpret_cast<int*>(smem_raw);                  // [H][3S]
  float* tile = reinterpret_cast<float*>(rank_t + (size_t)H * n3);  // [S][H+1]
  float* dem = tile + (size_t)S * pitch;                            // [H]
  float* sw = dem + H;                                              // [3S]
  float* pre = sw + n3;                                             // [3S]
  float* prev = pre + n3;                                           // [S]
  float* dwell = prev + S;                                          // [S]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool locks = min_dwell > 0;

  for (int s = tid; s < S; s += nt) {
    prev[s] = 0.0f;
    dwell[s] = 0.0f;
  }

  for (int h0 = 0; h0 < T; h0 += H) {
    const int hv = min(H, T - h0);
    __syncthreads();  // the previous tile's write-out has read `tile`
    const int* rsrc = rank + (size_t)h0 * n3;
    for (int e = tid; e < hv * n3; e += nt) rank_t[e] = rsrc[e];
    for (int e = tid; e < S * H; e += nt) {
      const int s = e / H, k = e - s * H;
      if (k < hv) tile[s * pitch + k] = avail[(size_t)s * T + h0 + k];
    }
    for (int k = tid; k < hv; k += nt) dem[k] = demand[h0 + k];
    __syncthreads();

    for (int k = 0; k < hv; ++k) {
      const int* rk = rank_t + k * n3;
      // A: scatter the widths into sorted order
      for (int s = tid; s < S; s += nt) {
        const float av = tile[s * pitch + k];
        const float held = fminf(prev[s], av);
        const float locked = (locks && dwell[s] > 0.0f) ? held : 0.0f;
        sw[rk[s]] = locked;
        sw[rk[S + s]] = held - locked;
        sw[rk[2 * S + s]] = av - held;
      }
      __syncthreads();
      // B: exclusive prefix, sequential in float64, rounded once
      if (tid == 0) {
        double acc = 0.0;
#pragma unroll 8
        for (int i = 0; i < n3; ++i) {
          pre[i] = (float)acc;
          acc += (double)sw[i];
        }
      }
      __syncthreads();
      // C: fill, add the three fills, update the dwell ledger
      const float d = dem[k];
      for (int s = tid; s < S; s += nt) {
        const float av = tile[s * pitch + k];
        const float p = prev[s];
        const float held = fminf(p, av);
        const float locked = (locks && dwell[s] > 0.0f) ? held : 0.0f;
        const float f_lock = fminf(fmaxf(d - pre[rk[s]], 0.0f), locked);
        const float f_keep =
            fminf(fmaxf(d - pre[rk[S + s]], 0.0f), held - locked);
        const float f_new =
            fminf(fmaxf(d - pre[rk[2 * S + s]], 0.0f), av - held);
        const float a = (f_lock + f_keep) + f_new;
        if (locks) {
          dwell[s] = a > p + kDwellEventMw ? (float)min_dwell
                                           : fmaxf(dwell[s] - 1.0f, 0.0f);
        }
        prev[s] = a;
        tile[s * pitch + k] = a;
      }
    }
    __syncthreads();
    for (int e = tid; e < S * H; e += nt) {
      const int s = e / H, k = e - s * H;
      if (k < hv) out[(size_t)s * T + h0 + k] = tile[s * pitch + k];
    }
  }
}

}  // namespace

extern "C" unsigned long long kernels_launched() {
  return g_launched.load();
}

extern "C" int dispatch_scan_f32(const float* avail, const int* rank,
                                 const float* demand, float* out, int S,
                                 int T, int min_dwell, void* stream) {
  if (S <= 0 || T <= 0 || min_dwell < 0) return (int)cudaErrorInvalidValue;
  const int H = tile_hours(S);
  const size_t smem = smem_bytes(S, H);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dispatch_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((S + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  dispatch_scan_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      avail, rank, demand, out, S, T, min_dwell, H);
  ++g_launched;
  return (int)cudaGetLastError();
}
