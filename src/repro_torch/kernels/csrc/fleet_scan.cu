// Batched two-threshold hysteresis scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fleet_scan.py::_fleet_kernel
// (the hot loop of repro.fleet.engine.backtest). Per row b of a [B, T]
// float32 price block and its four parameters, starting on:
//
//   on_t = 0 if p_t > p_off, 1 if p_t <= p_on, else on_{t-1}
//
// (off tested first, the rule of repro_torch.kernels.ref.hard_hour_step),
// reduced to four sums: sum draw_t p_t, sum cap_t, #starts, sum start_t p_t.
//
// Design. The TPU grid walks time blocks in order with the carry in VMEM;
// here blocks run in no order, so nothing can carry between them. The
// carry is one bit, so time is cut into chunks of `chunk` hours:
//   pass 1 (fleet_scan_chunks): one thread per (row, chunk) scans its chunk
//     twice in registers, once from each entering state, and writes for
//     each the chunk's four partial sums and its exit state (5 floats);
//   pass 2 (fleet_scan_stitch): one thread per row walks its chunks in
//     order from state 1, picks each chunk's record for the current state
//     and adds up the sums.
// At B = 1024, T = 8760 and 256-hour chunks pass 1 runs 8 x 35 blocks of
// 128 threads, where one program per row block would fill 8 blocks.
//
// Coalescing: the [B, T] block stays row-major (no transposed copy). Each
// block stages a [128 rows x 32 hours] tile through shared memory: a warp
// reads 32 consecutive hours of one row per load (128 B), and the tile's
// row pitch of 33 floats keeps the per-thread row reads free of bank
// conflicts. The cost is one __syncthreads pair per 32 hours and 16.5 KB
// of shared memory per block.
//
// Bound on an H100 SXM: the kernel must read the price block once,
// B*T*4 bytes (35.9 MB at 1024 x 8760, 10.7 us at 3.35 TB/s); the pass-1
// records (B * ceil(T/chunk) * 10 floats, 1.4 MB) are small beside it.
// No single PyTorch call computes this function (a sequential state
// machine), so there is no library yardstick.

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
constexpr int kRec = 5;     // floats per chunk record: 4 sums + exit state

struct Acc {
  float on, draw_price, cap, starts, start_price;
};

struct RowParams {
  float p_on, p_off, cap_on, cap_off, draw_on, draw_off;
};

__device__ __forceinline__ void hour_step(Acc& a, float p,
                                          const RowParams& q) {
  const float on = p > q.p_off ? 0.0f : (p <= q.p_on ? 1.0f : a.on);
  const float start = fmaxf(on - a.on, 0.0f);
  const bool up = on != 0.0f;
  a.draw_price += (up ? q.draw_on : q.draw_off) * p;
  a.cap += up ? q.cap_on : q.cap_off;
  a.starts += start;
  a.start_price += start * p;
  a.on = on;
}

__device__ __forceinline__ void put_record(float* rec, const Acc& a,
                                           size_t base, int B) {
  rec[base] = a.draw_price;
  rec[base + B] = a.cap;
  rec[base + 2 * (size_t)B] = a.starts;
  rec[base + 3 * (size_t)B] = a.start_price;
  rec[base + 4 * (size_t)B] = a.on;
}

// rec: [n_chunks][2 entering states][kRec][B]
__global__ void __launch_bounds__(kRows) fleet_scan_chunks(
    const float* __restrict__ prices, const float* __restrict__ p_on,
    const float* __restrict__ p_off, const float* __restrict__ off_level,
    const float* __restrict__ idle_frac, float* __restrict__ rec, int B,
    int T, int chunk) {
  __shared__ float tile[kRows][kTile + 1];
  const int r0 = blockIdx.x * kRows;
  const int row = r0 + threadIdx.x;
  const int t0 = blockIdx.y * chunk;
  const int t1 = min(t0 + chunk, T);
  const bool live = row < B;

  RowParams q = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    const float lvl = off_level[row];
    const float idle = idle_frac[row];
    q.p_on = p_on[row];
    q.p_off = p_off[row];
    // cap and draw of hard_hour_step at on = 1 and on = 0
    q.cap_on = lvl + (1.0f - lvl) * 1.0f;
    q.cap_off = lvl + (1.0f - lvl) * 0.0f;
    q.draw_on = q.cap_on + idle * (1.0f - q.cap_on);
    q.draw_off = q.cap_off + idle * (1.0f - q.cap_off);
  }
  Acc from_off = {0.f, 0.f, 0.f, 0.f, 0.f};
  Acc from_on = {1.f, 0.f, 0.f, 0.f, 0.f};

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int h0 = t0; h0 < t1; h0 += kTile) {
    const int t = h0 + lane;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int r = warp * 32 + j;
      const int g = r0 + r;
      tile[r][lane] =
          (g < B && t < t1) ? prices[(size_t)g * T + t] : 0.0f;
    }
    __syncthreads();
    const int n = min(kTile, t1 - h0);
    for (int k = 0; k < n; ++k) {
      const float p = tile[threadIdx.x][k];
      hour_step(from_off, p, q);
      hour_step(from_on, p, q);
    }
    __syncthreads();
  }
  if (live) {
    const size_t base0 = ((size_t)blockIdx.y * 2 + 0) * kRec * B + row;
    const size_t base1 = ((size_t)blockIdx.y * 2 + 1) * kRec * B + row;
    put_record(rec, from_off, base0, B);
    put_record(rec, from_on, base1, B);
  }
}

// out: [4][B]
__global__ void fleet_scan_stitch(const float* __restrict__ rec,
                                  float* __restrict__ out, int B,
                                  int n_chunks) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  int state = 1;  // every row starts on
  float draw_price = 0.f, cap = 0.f, starts = 0.f, start_price = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t base = ((size_t)c * 2 + state) * kRec * B + row;
    draw_price += rec[base];
    cap += rec[base + B];
    starts += rec[base + 2 * (size_t)B];
    start_price += rec[base + 3 * (size_t)B];
    state = rec[base + 4 * (size_t)B] != 0.0f ? 1 : 0;
  }
  out[row] = draw_price;
  out[B + row] = cap;
  out[2 * (size_t)B + row] = starts;
  out[3 * (size_t)B + row] = start_price;
}

}  // namespace

extern "C" unsigned long long kernels_launched() {
  return g_launched.load();
}

extern "C" {

// Floats of pass-1 scratch that fleet_scan_f32 needs for B rows and
// n_chunks = ceil(T / chunk) chunks.
long long fleet_scan_scratch_floats(int B, int n_chunks) {
  return (long long)n_chunks * 2 * kRec * B;
}

// prices: [B, T] row-major float32; p_on, p_off, off_level, idle_frac: [B];
// scratch: fleet_scan_scratch_floats(B, ceil(T/chunk)) floats; out: [4, B];
// chunk: a positive multiple of the 32-hour tile. Launches both passes on
// `stream` and returns cudaGetLastError().
int fleet_scan_f32(const float* prices, const float* p_on, const float* p_off,
                   const float* off_level, const float* idle_frac,
                   float* scratch, float* out, int B, int T, int chunk,
                   void* stream) {
  if (B <= 0 || T <= 0 || chunk <= 0 || chunk % kTile != 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (T + chunk - 1) / chunk;
  if (n_chunks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1((B + kRows - 1) / kRows, n_chunks);
  fleet_scan_chunks<<<grid1, kRows, 0, s>>>(prices, p_on, p_off, off_level,
                                            idle_frac, scratch, B, T, chunk);
  ++g_launched;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fleet_scan_stitch<<<(B + 255) / 256, 256, 0, s>>>(scratch, out, B,
                                                    n_chunks);
  ++g_launched;
  return (int)cudaGetLastError();
}

}  // extern "C"
