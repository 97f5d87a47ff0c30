// The two attention kernels of the serving path for Hopper (sm_90a): the
// FlashAttention forward of every prefill (flash_attention_fwd) and the
// single-token attention of every decode step (decode_attention_fwd).
// Each has two designs: at bfloat16, the type the model serves in, the
// matrix products run on the tensor cores (mma.sync m16n8k16, bf16
// operands, float32 accumulators) and the tiles arrive by asynchronous
// copies (cp.async); at float32 they run on the CUDA cores (TF32 tensor
// cores would round the operands to 10 bits of mantissa, far outside the
// float32 tolerance of 2e-5).
//
// ---- flash_attention_fwd --------------------------------------------------
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::_flash_kernel (entry
// repro.kernels.ops.flash_attention, reached from every prefill through
// repro.models.attention.blockwise_attention). Computes what
// repro_torch.kernels.ref.flash_attention_plain computes: softmax(q k^T
// * Dh^-0.5, masked) v for every query row, with grouped-query heads (head
// h reads KV group h / (H / G)), positional causal and sliding-window
// masks, query positions shifted by q_offset (chunked prefill), and the
// masked score NEG_INF = -2^30 rather than -inf (a fully masked row stays
// finite). q, k and v are read in the model's [B, S, heads, Dh] layout
// through their strides; the output is written as [B, Sq, H, Dh].
//
// Both designs: one block of 128 threads (4 warps) per (64-row query
// tile, head, batch row), walking the KV tiles of 64 keys in order and
// skipping a tile that the causal, window and length masks empty for the
// whole query tile (the reference's `relevant` test, with the same tile
// sizes on both sides, so the plain version mirrors the kernel). Per
// tile: scores in float32, scale and mask, the online softmax (row max m,
// p = exp(s - m_new), the row sum l of the unrounded p, alpha =
// exp(m_prev - m_new)), p rounded to V's type (the reference casts p to
// v.dtype before p.v), acc = acc * alpha + p v in float32. At the end the
// output is acc / max(l, 1e-37) in the inputs' type.
//
// Bound on an H100 SXM: the matrix products, 4 Sq Skv' H Dh operations
// (Skv' the keys each row attends to), at the 989 TFLOP/s bf16
// tensor-core peak: 4.4 us for the causal 1024 x 1024 prefill of
// qwen2.5-3b (16 heads, Dh 128); its bytes take 2.8 us at 3.35 TB/s.
//
// bf16 design (flash_mma_kernel), FlashAttention-2 on mma.sync:
//   - each warp owns 16 query rows. The Q tile is copied to shared memory
//     once (rows padded by 16 bytes, so that ldmatrix's eight 16-byte
//     row reads fall in distinct banks) and held in registers as the A
//     fragments of m16n8k16, Dh / 16 k-steps. Its shared copy takes the
//     place of the second K stage, so a block needs 4 x 64 padded rows
//     (68 KB at Dh 128) and three blocks share an SM;
//   - K and V come through a two-stage shared ring by cp.async.cg 16-byte
//     copies, each thread's copies of a tile one unrolled run. Tile t+1's
//     copies are issued after tile t's scores: the copies take issue
//     slots in the load/store pipe that ldmatrix needs, and issuing them
//     there cost less (PERF.md). One __syncthreads per tile. Views that
//     are not 16-byte aligned are copied element by element into the same
//     layout;
//   - S = Q K^T by mma.sync with K's B fragments from ldmatrix on the
//     [keys, Dh] tile; the mask only on a tile that a mask cuts (the
//     diagonal, the window's edge, the ragged end);
//   - the softmax stays in registers, in base 2: a row lives in the four
//     threads of a quad, reduced by two shuffles; m is the running max of
//     the scores times Dh^-0.5 log2(e), and p = 2^(s Dh^-0.5 log2(e) - m)
//     is one FFMA and one MUFU.EX2 (the same p as exp(s Dh^-0.5 - m') up
//     to float32 rounding). O is rescaled only when a row max of the warp
//     moved (alpha = 1 exactly otherwise). p rounded to bf16 is packed
//     straight into the A fragments of P V (the m16n8 accumulator layout
//     is the m16n8k16 A layout), with no shared-memory round trip;
//   - O += P V by mma.sync with V's B fragments from ldmatrix.trans; O
//     stays in float32 registers (Dh / 2 floats a thread);
//   - the query tiles are launched last first, so that the longest
//     blocks of a causal prefill start first.
// A product of two bf16 values is exact in float32, so the tensor cores
// compute what the reference computes (q and k cast to float32); only the
// order of the float32 sums differs. What still holds it back: a warp's
// tile is one dependent chain (scores, softmax, P V) with 16 rows of work,
// so few warps hide little latency; wgmma on 64-row warpgroup tiles, with
// TMA copies, is the next design (ROADMAP.md).
//
// float32 design (flash_fwd_kernel), on the CUDA cores: the Q tile in
// shared memory as float32; K and V copied synchronously; each thread
// computes 4 rows x 8 columns of the 64 x 64 scores by fmaf; the softmax
// one warp per 16 rows through shared memory; acc 4 rows x Dh / 8
// columns a thread in registers.
//
// ---- decode_attention_fwd ----------------------------------------------
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py::_decode_kernel (entry
// repro.kernels.ops.decode_attention, reached from every decode step
// through repro.models.attention._decode_attention). Computes what
// repro_torch.kernels.ref.decode_attention_plain computes: for each batch
// row b and KV group g, the R = H / G query heads of the group (heads
// g R .. g R + R - 1) attend to the cache's W slots of that group, slots
// whose int8 validity is 0 scored NEG_INF = -2^30 (one mask serves
// rolling and linear caches).
//
// Both designs: one block of 128 threads per (group, batch row, split of
// 256 cache slots), ceil(W / 256) splits (flash-decoding): 128 blocks at
// the serving pool (8 slots x 2048, 2 groups), one an SM. A block reads
// its split's validity bytes first; a 64-slot tile with no valid slot is
// skipped whole (a block-uniform __syncthreads_or), so a cache filled to
// n slots costs the K/V bytes of about n / 64 tiles. Each K/V byte is
// read once and serves the R heads of its group. A split's online softmax
// over its tiles gives (m, l, acc); the splits are folded in the same
// launch: each block stores its (m, l, acc), fences and takes a ticket on
// its (b, g) counter (atomicAdd); the block that draws the last ticket
// folds the n splits in split order, M = max m_j, w_j = exp(m_j - M), out
// = sum_j w_j acc_j / max(sum_j w_j l_j, 1e-37), writes the output and
// resets the counter to 0 for the next call. A split with no valid slot
// stores only m = NEG_INF, l = 0, and the fold passes over its acc (it
// would add 0). With one split the block writes the output itself. The
// fold is a chain of L2 round trips, so fewer, longer splits (256 slots,
// 8 at W = 2048) beat many short ones (64 slots: 32 splits, a 10 us fold).
//
// Skipping a tile of invalid slots changes no row that has a valid slot:
// visited before the row's first valid tile, such a tile would leave m =
// NEG_INF and be scaled by alpha = exp(NEG_INF - m_new) = 0; visited
// after, its p = exp(NEG_INF - m) = 0. So a skipped split weighs
// exp(NEG_INF - M) = 0 in the fold. A row with no valid slot at all
// comes out 0 (and finite). The plain version skips the same tiles, so
// they agree on every row.
//
// Bound on an H100 SXM: the bytes, the K and V of the valid slots read
// once (4 n G Dh at bf16 for n valid slots over the batch: 16.8 MB for a
// full cache at B = 8, W = 2048, G = 2, Dh = 128, 5.0 us at 3.35 TB/s),
// plus the mask, q and o.
//
// bf16 design (decode_mma_kernel): q's R rows are copied first; then every
// live tile of the split has a stage of its own, so all of the split's
// K/V bytes are in flight at once, as cp.async.cg 16-byte copies in
// commit groups K0, V0, K1, V1, ...: a tile's K group is waited on before
// its scores, its V group only before p v, so V lands while the scores
// are computed. The R heads are the M rows of mma.sync m16n8k16, padded
// to 16 (two row tiles for R > 16): each warp computes the scores of 16
// slots for all R heads; the row max and sum cross the four warps through
// shared memory; p, rounded to bf16, goes through a small shared tile to
// become the A fragments of P V, where each warp owns Dh / 4 columns of
// acc in registers.
//
// float32 design (decode_kernel): K and V copied synchronously, a tile at
// a time; the R x 64 scores one Dh-long dot product (four partial sums) a
// thread and entry; the softmax one warp per row; acc[R][Dh] in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace {

// Kernels this library has launched in this process, counted on the host
// where each launch is issued; kernels_launched() reads it, and the
// wrappers count a call's launches on the card as its difference.
std::atomic<unsigned long long> g_launched{0};

using bf16 = __nv_bfloat16;

constexpr int kBKV = 64;        // keys (cache slots) per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1073741824.0f;  // -2^30, NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, bf16* out) {
  *out = __float2bfloat16(x);
}
// x rounded to T and back: the reference's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  T t;
  from_f(x, &t);
  return to_f(t);
}

// Shared row pitch of a T tile of width DH: one 32-bit word of padding.
template <typename T, int DH>
__host__ __device__ constexpr int pitch() {
  return DH + (int)(4 / sizeof(T));
}

// Copies rows [0, n_rows) of a strided [rows, DH] slice into a shared
// tile with row pitch LD, zero-filling rows at or past n_valid. With vec,
// each thread moves 16 bytes a load (the wrapper checked the alignment).
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long stride, int n_rows,
                                          int n_valid, bool vec) {
  constexpr int LD = pitch<T, DH>();
  if (vec) {
    constexpr int PER = 16 / (int)sizeof(T);
    constexpr int CH = DH / PER;
    for (int i = threadIdx.x; i < n_rows * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * PER;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_valid)
        raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
      // LD keeps every row 4-byte aligned: store as 32-bit words
      uint32_t* d32 = reinterpret_cast<uint32_t*>(dst + r * LD + c);
      d32[0] = raw.x;
      d32[1] = raw.y;
      d32[2] = raw.z;
      d32[3] = raw.w;
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * DH; i += blockDim.x) {
      const int r = i / DH, c = i % DH;
      T val;
      from_f(0.0f, &val);
      if (r < n_valid) val = src[r * stride + c];
      dst[r * LD + c] = val;
    }
  }
}

// ---- the bf16 kernels' building blocks (cp.async, ldmatrix, mma.sync)
// are in mma.cuh ----

// 2^x by the special function unit (MUFU.EX2), denormal results flushed
// to 0: exp(s - m) of the softmax as 2^((s - m) log2(e)), the same p up to
// float32 rounding
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// lo and hi rounded to bf16 (to nearest even, as p.astype(bfloat16)),
// lo in the low half: two neighbouring columns of an mma operand.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Launches kernel(a) on stream with smem bytes of dynamic shared memory
// (above 48 KB only once the kernel's limit is raised); a cudaError_t.
template <typename A>
int start(void (*kernel)(A), dim3 grid, size_t smem, cudaStream_t stream,
          const A& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  ++g_launched;
  return (int)cudaGetLastError();
}

// Copies rows [0, n_rows) of a strided [rows, DH] bf16 slice into a
// shared tile of pitch mma_pitch<DH>(), rows at or past n_valid zero.
// With vec (16-byte aligned rows, checked by the wrapper), 16-byte
// cp.async copies that the caller commits and waits on; otherwise element
// copies, complete when the caller's next __syncthreads returns.
template <int DH>
__device__ __forceinline__ void copy_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          long long stride, int n_rows,
                                          int n_valid, bool vec) {
  constexpr int LD = mma_pitch<DH>(), CH = DH / 8;
  if (vec) {
    for (int i = threadIdx.x; i < n_rows * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool full = r < n_valid;
      cp_async16(smem_u32(dst + r * LD + c),
                 full ? src + r * stride + c : src, full);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * DH; i += blockDim.x) {
      const int r = i / DH, c = i % DH;
      dst[r * LD + c] = r < n_valid ? src[r * stride + c]
                                    : __float2bfloat16(0.0f);
    }
  }
}

// copy_tile for a tile of ROWS rows (a multiple of kThreads / (DH / 8)):
// thread i copies the 16-byte chunk column i % (DH / 8) of rows i / (DH /
// 8), + kThreads / (DH / 8), ...: an unrolled run of copies one address
// step apart, so that issuing a tile's copies costs few instructions.
template <int DH, int ROWS>
__device__ __forceinline__ void copy_tile_fixed(bf16* dst,
                                                const bf16* __restrict__ src,
                                                long long stride, int n_valid,
                                                bool vec) {
  constexpr int LD = mma_pitch<DH>(), CH = DH / 8, STEP = kThreads / CH;
  static_assert(kThreads % CH == 0 && ROWS % STEP == 0, "whole steps");
  if (!vec) {
    copy_tile<DH>(dst, src, stride, ROWS, n_valid, false);
    return;
  }
  const int r0 = threadIdx.x / CH, c = (threadIdx.x % CH) * 8;
  const uint32_t d = smem_u32(dst + r0 * LD + c);
  const bf16* g = src + r0 * stride + c;
  const long long g_step = STEP * stride;
#pragma unroll
  for (int k = 0; k < ROWS / STEP; ++k) {
    const bool full = r0 + k * STEP < n_valid;
    cp_async16(d + k * STEP * LD * (int)sizeof(bf16),
               full ? g + k * g_step : src, full);
  }
}

// ---- flash_attention_fwd ----------------------------------------------

namespace flash {

constexpr int kBQ = 64;         // query rows per block

template <typename T, int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (DH + 1) + kBQ * (kBKV + 1) + 3 * kBQ) +
         sizeof(T) * 2 * kBKV * pitch<T, DH>();
}

// the bf16 kernel: two stages of K and V; the Q tile shares the second
// stage's K (it is in registers before that stage is first filled)
template <int DH>
constexpr size_t mma_smem_bytes() {
  static_assert(kBQ == kBKV, "Q takes a K stage's place");
  return sizeof(bf16) * 4 * kBKV * mma_pitch<DH>();
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, H, G;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window, q_offset, vec;
  float scale;
};

// The float32 kernel, on the CUDA cores.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args a) {
  constexpr int QLD = DH + 1;
  constexpr int KLD = pitch<T, DH>();
  constexpr int SLD = kBKV + 1;
  constexpr int CPT = DH / 8;       // accumulator columns per thread
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);       // [kBQ][QLD]
  float* ss = qs + kBQ * QLD;                          // [kBQ][SLD]
  float* m_s = ss + kBQ * SLD;                         // [kBQ]
  float* l_s = m_s + kBQ;
  float* alpha_s = l_s + kBQ;
  T* ks = reinterpret_cast<T*>(alpha_s + kBQ);         // [kBKV][KLD]
  T* vs = ks + kBKV * KLD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    qs[r * QLD + d] = q0 + r < a.Sq ? to_f(qp[(q0 + r) * a.q_ss + d]) : 0.0f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }

  // thread tile: rows r0..r0+3; score columns cg + 8 j; acc columns cg + 8 j
  const int r0 = (tid >> 3) * 4, cg = tid & 7;
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;

  const int q_start = a.q_offset + q0, q_end = q_start + kBQ - 1;
  const int n_kv = (a.Skv + kBKV - 1) / kBKV;
  for (int t = 0; t < n_kv; ++t) {
    const int k_start = t * kBKV;
    bool relevant = a.causal ? k_start <= min(q_end, a.Skv - 1) : true;
    if (a.window)
      relevant = relevant && k_start + kBKV - 1 > q_start - a.window;
    if (!relevant) continue;                 // uniform across the block
    __syncthreads();                         // last tile's reads are done
    const int n_valid = min(kBKV, a.Skv - k_start);
    load_tile<T, DH>(ks, kp + k_start * a.k_ss, a.k_ss, kBKV, n_valid, a.vec);
    load_tile<T, DH>(vs, vp + k_start * a.v_ss, a.v_ss, kBKV, n_valid, a.vec);
    __syncthreads();

    // 2. scores
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(r0 + i) * QLD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = to_f(ks[(cg + 8 * j) * KLD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + r0 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k_start + cg + 8 * j;
        bool ok = kpos < a.Skv;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window) ok = ok && kpos > qpos - a.window;
        ss[(r0 + i) * SLD + cg + 8 * j] = ok ? s[i][j] * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // 3. online softmax, one warp per 16 rows, two columns per lane
    for (int rr = 0; rr < kBQ / 4; ++rr) {
      const int r = warp * (kBQ / 4) + rr;
      const float s0 = ss[r * SLD + lane], s1 = ss[r * SLD + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss[r * SLD + lane] = round_to<T>(p0);
      ss[r * SLD + lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = alpha_s[r0 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(r0 + i) * SLD + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = to_f(vs[c * KLD + cg + 8 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();                           // l_s complete, even with no tile

  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= a.Sq) continue;
    const float l = fmaxf(l_s[r0 + i], 1e-37f);
    T* orow = op + (((long long)b * a.Sq + row) * a.H + h) * DH;
#pragma unroll
    for (int j = 0; j < CPT; ++j) from_f(acc[i][j] / l, orow + cg + 8 * j);
  }
}

// The bf16 kernel, on the tensor cores. Warp w owns query rows 16 w ..
// 16 w + 15 of the tile; thread l of it rows 16 w + l/4 and + 8.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const Args a) {
  constexpr int LD = mma_pitch<DH>();
  constexpr int KT = DH / 16;     // k-steps of q k^T
  constexpr int NT = kBKV / 8;    // 8-key column tiles of s
  constexpr int DT = DH / 8;      // 8-column tiles of o
  extern __shared__ float4 smem_f4[];
  bf16* ks = reinterpret_cast<bf16*>(smem_f4);   // [2][kBKV][LD]
  bf16* vs = ks + 2 * kBKV * LD;                  // [2][kBKV][LD]
  bf16* qs = ks + kBKV * LD;                      // [kBQ][LD], K stage 1

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // last tile first
  const int h = blockIdx.y, b = blockIdx.z, g = h / (a.H / a.G);
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + g * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + g * a.v_sh;
  const bool vec = a.vec;

  // the relevant KV tiles form one run [t_lo, t_hi]: the causal test
  // drops a suffix, the window test a prefix
  const int q_start = a.q_offset + q0, q_end = q_start + kBQ - 1;
  const int n_kv = (a.Skv + kBKV - 1) / kBKV;
  auto relevant = [&](int t) {
    const int k_start = t * kBKV;
    bool r = a.causal ? k_start <= min(q_end, a.Skv - 1) : true;
    if (a.window) r = r && k_start + kBKV - 1 > q_start - a.window;
    return r;
  };
  int t_lo = 0;
  while (t_lo < n_kv && !relevant(t_lo)) ++t_lo;
  int t_hi = n_kv - 1;
  while (t_hi >= t_lo && !relevant(t_hi)) --t_hi;

  auto load_kv = [&](int t, int stage) {
    const int k_start = t * kBKV, n_valid = min(kBKV, a.Skv - k_start);
    copy_tile_fixed<DH, kBKV>(ks + stage * kBKV * LD, kp + k_start * a.k_ss,
                              a.k_ss, n_valid, vec);
    copy_tile_fixed<DH, kBKV>(vs + stage * kBKV * LD, vp + k_start * a.v_ss,
                              a.v_ss, n_valid, vec);
  };

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  const float scale2 = a.scale * 1.4426950408889634f;   // Dh^-0.5 log2(e)
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.0f, 0.0f};
  uint32_t qf[KT][4];
  const int r_lo = warp * 16 + (lane >> 2), tig = lane & 3;

  if (t_lo <= t_hi) {
    copy_tile_fixed<DH, kBQ>(qs, qp + q0 * a.q_ss, a.q_ss,
                             min(kBQ, a.Sq - q0), vec);
    load_kv(t_lo, 0);
    cp_async_commit();
  }
  for (int t = t_lo; t <= t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    cp_async_wait<0>();
    __syncthreads();          // tile t is in; every warp is done with t - 1
    if (t == t_lo) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
    }
    const bf16* kt = ks + st * kBKV * LD;
    const bf16* vt = vs + st * kBKV * LD;

    // S = Q K^T: column tiles 2 np and 2 np + 1 from one ldmatrix.x4
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // tile t + 1 flies while t is computed (issued after the scores'
    // ldmatrix, which share the load/store pipe with the copies)
    if (t < t_hi) {
      if (t == t_lo) __syncthreads();        // every warp's q is in registers
      load_kv(t + 1, st ^ 1);
      cp_async_commit();
    }

    // the mask, only where one cuts this tile; the scores stay unscaled
    // (the scale is folded into the exponent below)
    const int k_start = t * kBKV;
    const bool cut = k_start + kBKV > a.Skv ||
                     (a.causal && k_start + kBKV - 1 > q_start) ||
                     (a.window && k_start <= q_end - a.window);
    if (cut) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k_start + j * 8 + tig * 2 + (e & 1);
          const int qpos = q_start + r_lo + (e >> 1) * 8;
          bool ok = kpos < a.Skv;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window) ok = ok && kpos > qpos - a.window;
          if (!ok) s[j][e] = kNegInf;
        }
      }
    }

    // online softmax in registers, in base 2 (a row lives in the 4
    // threads of a quad): m is the running max of s Dh^-0.5 log2(e), the
    // scaled max of the raw scores (a positive scale keeps their order),
    // and p = 2^(s Dh^-0.5 log2(e) - m) is one FFMA and one MUFU.EX2
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(m_r[i], mx[i] * scale2);
      alpha[i] = ex2(m_r[i] - mx[i]);
      m_r[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], scale2, -mx[e >> 1]));
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_r[i] = l_r[i] * alpha[i] + sum[i];
    }
    // alpha is exactly 1 where the row max did not move: skip the
    // rescale when it did not move for any row of the warp
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
    }

    // O += P V: p rounded to bf16 in place as the A fragments (keys
    // 16 kk .. 16 kk + 15 are column tiles 2 kk and 2 kk + 1 of s)
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  bf16* op = static_cast<bf16*>(a.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    if (row >= a.Sq) continue;
    const float inv_l = 1.0f / fmaxf(l_r[i], 1e-37f);
    bf16* orow = op + (((long long)b * a.Sq + row) * a.H + h) * DH + tig * 2;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(o[j][2 * i] * inv_l, o[j][2 * i + 1] * inv_l);
  }
}

template <typename T, int DH>
int launch(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  if constexpr (std::is_same<T, bf16>::value)
    return start(flash_mma_kernel<DH>, grid, mma_smem_bytes<DH>(), stream, a);
  else
    return start(flash_fwd_kernel<T, DH>, grid, smem_bytes<T, DH>(), stream,
                 a);
}

template <typename T>
int launch_dh(const Args& a, int B, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
}  // namespace flash

// ---- decode_attention_fwd ---------------------------------------------

namespace decode {

constexpr int kMaxRep = 32;     // query heads per KV group, at most
constexpr int kSplit = 256;     // cache slots per block (a split)
constexpr int kMaxSplit = 6144; // splits per call, at most
constexpr int kFold = 32;       // splits the fold stages at a time
constexpr int kRound = 8;       // splits whose acc loads fly together
static_assert(kSplit % kBKV == 0, "a split is whole tiles");

template <typename T, int DH>
size_t smem_bytes(int R) {
  return sizeof(float) * ((size_t)R * (DH + 1) + (size_t)R * (kBKV + 1) +
                          (size_t)R * DH + 3 * (size_t)R) +
         kBKV + sizeof(T) * 2 * kBKV * pitch<T, DH>();
}

// the bf16 kernel: q's rows padded to 16 or 32, K and V of every tile of
// the split, p, the cross-warp row maxima and sums, the validity bytes
template <int DH>
size_t mma_smem_bytes(int R) {
  const size_t rows = R > 16 ? 32 : 16;
  return sizeof(bf16) * (rows * mma_pitch<DH>() +
                         2 * (size_t)kSplit * mma_pitch<DH>() +
                         rows * (kBKV + 8)) +
         sizeof(float) * 2 * 4 * 32 + kSplit;
}

// the fold, in the same shared memory once a block's split is done
template <int DH>
size_t fold_smem_bytes(int R) {
  return sizeof(float) * ((size_t)R * DH + (size_t)R * (2 + 2 * kFold));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int8_t* valid;
  void* o;
  float* part_m;      // [B, G, n_split, R]      (n_split > 1 only)
  float* part_l;      // [B, G, n_split, R]
  float* part_acc;    // [B, G, n_split, R, DH], 16-byte aligned
  int* counters;      // [B, G] tickets, 0 between calls
  int W, H, G, n_split;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, m_sb;
  int vec;
  float scale;
};

// Called by every block of a call with n_split > 1 once its (m, l, acc)
// are stored (and no copy into shared memory is in flight): the block
// that takes the last of the n_split tickets of (b, g) folds the splits
// in split order, M = max_j m_j, w_j = exp(m_j - M), out = sum_j w_j
// acc_j / max(sum_j w_j l_j, 1e-37) (decode_attention_plain's fold),
// writes the output and resets the counter. A split with l_j = 0 had no
// valid slot and stored no acc; its term is 0 and is passed over. Each
// thread folds 4 columns of two rows at a time, with the loads of kRound
// splits in flight together: the fold is a chain of L2 round trips.
template <typename T, int DH>
__device__ void fold_if_last(const Args& a, int b, int g, float* sm) {
  constexpr int C4 = DH / 4;     // float4 columns of a row
  __shared__ int last_s;
  __threadfence();               // this block's partials, before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last_s = atomicAdd(a.counters + b * a.G + g, 1) == a.n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();               // the others' partials, after their tickets
  const int R = a.H / a.G, n = a.n_split, n4 = R * C4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)(b * a.G + g) * n;   // split 0's row
  float4* x_s = reinterpret_cast<float4*>(sm);           // [R][C4]
  float* big_m = sm + R * DH;                            // [R]
  float* tot_l = big_m + R;                              // [R]
  float* w_s = tot_l + R;                                // [R][kFold]
  float* l_s = w_s + R * kFold;                          // [R][kFold]
  const float4* acc4 = reinterpret_cast<const float4*>(a.part_acc);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = warp; r < R; r += kThreads / 32) {
    float M = kNegInf;
    for (int j = lane; j < n; j += 32)
      M = fmaxf(M, __ldcg(a.part_m + (base + j) * R + r));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    if (lane == 0) {
      big_m[r] = M;
      tot_l[r] = 0.0f;
    }
  }
  for (int i = tid; i < n4; i += kThreads) x_s[i] = zero;
  for (int j0 = 0; j0 < n; j0 += kFold) {
    const int cnt = min(kFold, n - j0);
    __syncthreads();             // M ready; the last chunk's w_s read
    for (int i = tid; i < R * cnt; i += kThreads) {
      const int r = i / cnt, jj = i % cnt;
      const long long row = (base + j0 + jj) * R + r;
      w_s[r * kFold + jj] = expf(__ldcg(a.part_m + row) - big_m[r]);
      l_s[r * kFold + jj] = __ldcg(a.part_l + row);
    }
    __syncthreads();
    for (int i0 = tid; i0 < n4; i0 += 2 * kThreads) {  // x_s[i]: one thread
      int r[2];
      bool on[2];
      float4 x[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = i0 + k * kThreads;
        on[k] = i < n4;
        r[k] = on[k] ? i / C4 : 0;
        x[k] = on[k] ? x_s[i] : zero;
      }
      for (int jr = 0; jr < cnt; jr += kRound) {
        float4 v[2][kRound];
#pragma unroll
        for (int u = 0; u < kRound; ++u)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int jj = jr + u;
            const bool use = on[k] && jj < cnt &&
                             l_s[r[k] * kFold + jj] != 0.0f;
            v[k][u] = use ? __ldcg(acc4 + ((base + j0 + jj) * R + r[k]) * C4 +
                                   (i0 + k * kThreads) % C4)
                          : zero;
          }
#pragma unroll
        for (int u = 0; u < kRound; ++u)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (jr + u >= cnt) continue;
            const float w = w_s[r[k] * kFold + jr + u];
            x[k].x = x[k].x + v[k][u].x * w;
            x[k].y = x[k].y + v[k][u].y * w;
            x[k].z = x[k].z + v[k][u].z * w;
            x[k].w = x[k].w + v[k][u].w * w;
          }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (on[k]) x_s[i0 + k * kThreads] = x[k];
    }
    if (tid < R) {
      float L = tot_l[tid];
      for (int jj = 0; jj < cnt; ++jj)
        L = L + l_s[tid * kFold + jj] * w_s[tid * kFold + jj];
      tot_l[tid] = L;
    }
  }
  __syncthreads();
  T* op = static_cast<T*>(a.o) + ((long long)b * a.H + g * R) * DH;
  const float* xs = sm;
  for (int i = tid; i < R * DH; i += kThreads)
    from_f(xs[i] / fmaxf(tot_l[i / DH], 1e-37f), op + i);
  if (tid == 0) a.counters[b * a.G + g] = 0;   // ready for the next call
}

// The float32 kernel, on the CUDA cores. One block per (group, batch
// row, split of kSplit slots).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const Args a) {
  constexpr int QLD = DH + 1;
  constexpr int KLD = pitch<T, DH>();
  constexpr int SLD = kBKV + 1;
  const int R = a.H / a.G;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);       // [R][QLD]
  float* ss = qs + R * QLD;                            // [R][SLD]
  float* acc = ss + R * SLD;                           // [R][DH]
  float* m_s = acc + R * DH;                           // [R]
  float* l_s = m_s + R;
  float* alpha_s = l_s + R;
  int8_t* ok_s = reinterpret_cast<int8_t*>(alpha_s + R);   // [kBKV]
  T* ks = reinterpret_cast<T*>(ok_s + kBKV);           // [kBKV][KLD]
  T* vs = ks + kBKV * KLD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + g * R * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  const int8_t* mp = a.valid + b * a.m_sb;

  for (int i = tid; i < R * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    qs[r * QLD + d] = to_f(qp[r * a.q_sh + d]);
    acc[i] = 0.0f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }

  const int n_kv = (a.W + kBKV - 1) / kBKV;
  const int t_end = min(n_kv, (split + 1) * (kSplit / kBKV));
  for (int t = split * (kSplit / kBKV); t < t_end; ++t) {
    const int k_start = t * kBKV;
    const int n_valid = min(kBKV, a.W - k_start);
    __syncthreads();                         // last tile's reads are done
    // slots past W are padding, masked like invalid slots
    const bool ok = tid < n_valid && mp[k_start + tid] != 0;
    if (tid < kBKV) ok_s[tid] = ok;
    // 1. a tile with no valid slot is skipped, its K/V never read
    if (!__syncthreads_or(ok)) continue;
    load_tile<T, DH>(ks, kp + k_start * a.k_ss, a.k_ss, kBKV, n_valid, a.vec);
    load_tile<T, DH>(vs, vp + k_start * a.v_ss, a.v_ss, kBKV, n_valid, a.vec);
    __syncthreads();

    // 2. scores, four partial sums per dot product
    for (int i = tid; i < R * kBKV; i += kThreads) {
      const int r = i / kBKV, c = i % kBKV;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        const float* qr = qs + r * QLD + d;
        const T* kr = ks + c * KLD + d;
        s0 = fmaf(qr[0], to_f(kr[0]), s0);
        s1 = fmaf(qr[1], to_f(kr[1]), s1);
        s2 = fmaf(qr[2], to_f(kr[2]), s2);
        s3 = fmaf(qr[3], to_f(kr[3]), s3);
      }
      ss[r * SLD + c] = ok_s[c] ? ((s0 + s1) + (s2 + s3)) * a.scale : kNegInf;
    }
    __syncthreads();

    // 3. online softmax, one warp per row, two slots per lane
    for (int r = warp; r < R; r += kThreads / 32) {
      const float s0 = ss[r * SLD + lane], s1 = ss[r * SLD + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss[r * SLD + lane] = round_to<T>(p0);
      ss[r * SLD + lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p v, four partial sums per entry
    for (int i = tid; i < R * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const float* pr = ss + r * SLD;
      float x0 = acc[i] * alpha_s[r], x1 = 0.0f, x2 = 0.0f, x3 = 0.0f;
#pragma unroll 4
      for (int c = 0; c < kBKV; c += 4) {
        x0 = fmaf(pr[c], to_f(vs[c * KLD + d]), x0);
        x1 = fmaf(pr[c + 1], to_f(vs[(c + 1) * KLD + d]), x1);
        x2 = fmaf(pr[c + 2], to_f(vs[(c + 2) * KLD + d]), x2);
        x3 = fmaf(pr[c + 3], to_f(vs[(c + 3) * KLD + d]), x3);
      }
      acc[i] = (x0 + x1) + (x2 + x3);
    }
  }
  __syncthreads();

  if (a.n_split == 1) {                      // one split: the output itself
    T* op = static_cast<T*>(a.o) + ((long long)b * a.H + g * R) * DH;
    for (int i = tid; i < R * DH; i += kThreads)
      from_f(acc[i] / fmaxf(l_s[i / DH], 1e-37f), op + i);
    return;
  }
  const long long row = ((long long)(b * a.G + g) * a.n_split + split) * R;
  for (int r = tid; r < R; r += kThreads) {
    a.part_m[row + r] = m_s[r];
    a.part_l[row + r] = l_s[r];
  }
  for (int i = tid; i < R * DH; i += kThreads)
    a.part_acc[row * DH + i] = acc[i];
  __syncthreads();                           // acc read before the fold
  fold_if_last<T, DH>(a, b, g, reinterpret_cast<float*>(smem_f4));
}

// Waits until at most n (0 .. 7) of this thread's commit groups are in
// flight: the decode kernel's count of groups depends on its live tiles.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// The bf16 kernel, on the tensor cores. The split's NT tiles each have a
// stage of shared memory, so every live tile's K and V copies are issued
// at once (commit groups K0, V0, K1, V1, ...); tile c waits for its K
// before the scores and for its V only before p v. The R heads are rows
// of m16n8k16 (padded to 16 per row tile, MT tiles); warp w scores slots
// 16 w .. 16 w + 15 of a tile for every head and owns columns
// 8 (w + 4 j) .. + 7 of acc. Thread l of a warp holds rows l/4 and
// l/4 + 8 of each row tile. An online softmax carries (m, l, acc) across
// the split's live tiles, in order.
template <int DH>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const Args a) {
  constexpr int LD = mma_pitch<DH>(), PLD = kBKV + 8;
  constexpr int KT = DH / 16;          // k-steps of q k^T
  constexpr int DT = DH / 8;           // 8-column tiles of acc
  constexpr int DW = (DT + 3) / 4;     // ... per warp, at most
  constexpr int NT = kSplit / kBKV;    // tiles of a split
  static_assert(2 * NT <= 8 && kSplit <= 2 * kThreads, "see the waits");
  const int R = a.H / a.G, MT = R > 16 ? 2 : 1;
  extern __shared__ float4 smem_f4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_f4);   // [16 MT][LD]
  bf16* ks = qs + 16 * MT * LD;                   // [NT][kBKV][LD]
  bf16* vs = ks + NT * kBKV * LD;                 // [NT][kBKV][LD]
  bf16* ps = vs + NT * kBKV * LD;                 // [16 MT][PLD]
  float* red_m = reinterpret_cast<float*>(ps + 16 * MT * PLD);  // [4][32]
  float* red_l = red_m + 4 * 32;                                // [4][32]
  int8_t* ok_s = reinterpret_cast<int8_t*>(red_l + 4 * 32);     // [kSplit]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb +
                   g * R * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + g * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + g * a.v_sh;
  const int8_t* mp = a.valid + b * a.m_sb;
  const int s_start = split * kSplit;
  const bool vec = a.vec;

  // q first (the oldest commit group), then the split's validity bytes
  // (slots past W are padding, masked like invalid slots) and which of its
  // tiles hold a valid slot
  copy_tile<DH>(qs, qp, a.q_sh, 16 * MT, R, vec);
  cp_async_commit();
  for (int i = tid; i < kSplit; i += kThreads)
    ok_s[i] = s_start + i < a.W && mp[s_start + i] != 0;
  __syncthreads();
  int live = 0, n_live = 0;
  for (int t = 0; t < NT; ++t)
    if (__syncthreads_or(tid < kBKV && ok_s[t * kBKV + tid])) {
      live |= 1 << t;
      ++n_live;
    }
  // every live tile's K and V at once; a tile with no valid slot is never
  // read
  for (int t = 0; t < NT; ++t) {
    if (!(live >> t & 1)) continue;
    const int k_start = s_start + t * kBKV;
    const int n_valid = min(kBKV, a.W - k_start);
    copy_tile_fixed<DH, kBKV>(ks + t * kBKV * LD, kp + k_start * a.k_ss,
                              a.k_ss, n_valid, vec);
    cp_async_commit();
    copy_tile_fixed<DH, kBKV>(vs + t * kBKV * LD, vp + k_start * a.v_ss,
                              a.v_ss, n_valid, vec);
    cp_async_commit();
  }

  float m_r[2][2], l_r[2][2], o[2][DW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_r[mt][i] = kNegInf;
      l_r[mt][i] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < DW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.0f;
  }

  for (int t = 0, c = 0; t < NT; ++t) {
    if (!(live >> t & 1)) continue;          // uniform across the block
    const bf16* kt = ks + t * kBKV * LD;
    const bf16* vt = vs + t * kBKV * LD;
    const int8_t* okt = ok_s + t * kBKV;
    cp_async_wait_dyn(2 * (n_live - c) - 1);     // q and this tile's K
    __syncthreads();                         // ... and the last tile's reads

    // scores of slots 16 warp .. + 15 (column tiles 0 and 1)
    float s[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, kt + (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                      kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < MT) {
          uint32_t qa[4];
          ldsm_x4(qa, qs + (mt * 16 + (lane & 15)) * LD + kk * 16 +
                          (lane >> 4) * 8);
          mma_bf16(s[mt][0], qa, kb[0], kb[1]);
          mma_bf16(s[mt][1], qa, kb[2], kb[3]);
        }
      }
    }
    // scale and the validity mask; this warp's row maxima
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= MT) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = warp * 16 + j * 8 + tig * 2 + (e & 1);
          s[mt][j][e] = okt[col] ? s[mt][j][e] * a.scale : kNegInf;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(fmaxf(s[mt][0][2 * i], s[mt][0][2 * i + 1]),
                         fmaxf(s[mt][1][2 * i], s[mt][1][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (tig == 0) red_m[warp * 32 + mt * 16 + gq + 8 * i] = mx;
      }
    }
    __syncthreads();
    // m_new over the four warps; p = exp(s - m_new), its row sums, p
    // rounded to bf16 into the shared P tile; acc and l scaled by alpha
    float alpha_r[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= MT) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = mt * 16 + gq + 8 * i;
        float m = m_r[mt][i];
#pragma unroll
        for (int w = 0; w < 4; ++w) m = fmaxf(m, red_m[w * 32 + r]);
        const float alpha = expf(m_r[mt][i] - m);
        m_r[mt][i] = m;
        alpha_r[mt][i] = alpha;
#pragma unroll
        for (int j = 0; j < DW; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) o[mt][j][2 * i + e] *= alpha;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p0 = expf(s[mt][j][2 * i] - m);
          const float p1 = expf(s[mt][j][2 * i + 1] - m);
          sum += p0 + p1;
          *reinterpret_cast<uint32_t*>(ps + r * PLD + warp * 16 + j * 8 +
                                       tig * 2) = pack_bf16(p0, p1);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (tig == 0) red_l[warp * 32 + r] = sum;
      }
    }
    cp_async_wait_dyn(2 * (n_live - c) - 2);     // this tile's V
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = mt * 16 + gq + 8 * i;
        if (mt < MT)
          l_r[mt][i] = l_r[mt][i] * alpha_r[mt][i] +
                       ((red_l[r] + red_l[32 + r]) +
                        (red_l[64 + r] + red_l[96 + r]));
      }

    // acc += p v over the tile's 64 slots, this warp's column tiles
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= MT) continue;
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        uint32_t pa[4];
        ldsm_x4(pa, ps + (mt * 16 + (lane & 15)) * PLD + kk * 16 +
                        (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < DW; ++j) {
          const int dt = warp + 4 * j;
          if (dt < DT) {
            uint32_t vb[2];
            ldsm_x2_t(vb, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   LD + dt * 8);
            mma_bf16(o[mt][j], pa, vb[0], vb[1]);
          }
        }
      }
    }
    ++c;
  }
  cp_async_wait<0>();          // a split with no live tile: q's copies

  if (a.n_split == 1) {                      // one split: the output itself
    bf16* op = static_cast<bf16*>(a.o) + ((long long)b * a.H + g * R) * DH;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = mt * 16 + gq + 8 * i;
        if (mt >= MT || r >= R) continue;
        const float l = fmaxf(l_r[mt][i], 1e-37f);
#pragma unroll
        for (int j = 0; j < DW; ++j) {
          const int dt = warp + 4 * j;
          if (dt < DT)
            *reinterpret_cast<uint32_t*>(op + r * DH + dt * 8 + tig * 2) =
                pack_bf16(o[mt][j][2 * i] / l, o[mt][j][2 * i + 1] / l);
        }
      }
    return;
  }
  const long long row0 = ((long long)(b * a.G + g) * a.n_split + split) * R;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = mt * 16 + gq + 8 * i;
      if (mt >= MT || r >= R) continue;
      if (warp == 0 && tig == 0) {
        a.part_m[row0 + r] = m_r[mt][i];
        a.part_l[row0 + r] = l_r[mt][i];
      }
      if (!live) continue;                   // the fold passes over acc
#pragma unroll
      for (int j = 0; j < DW; ++j) {
        const int dt = warp + 4 * j;
        if (dt < DT)
          *reinterpret_cast<float2*>(a.part_acc + (row0 + r) * DH + dt * 8 +
                                     tig * 2) =
              make_float2(o[mt][j][2 * i], o[mt][j][2 * i + 1]);
      }
    }
  __syncthreads();                           // shared reads done
  fold_if_last<bf16, DH>(a, b, g, reinterpret_cast<float*>(smem_f4));
}

template <typename T, int DH>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int R = a.H / a.G;
  const dim3 grid(a.G, B, a.n_split);
  const size_t fold = a.n_split > 1 ? fold_smem_bytes<DH>(R) : 0;
  if constexpr (std::is_same<T, bf16>::value)
    return start(decode_mma_kernel<DH>, grid,
                 std::max(mma_smem_bytes<DH>(R), fold), stream, a);
  else
    return start(decode_kernel<T, DH>, grid,
                 std::max(smem_bytes<T, DH>(R), fold), stream, a);
}

template <typename T>
int launch_dh(const Args& a, int B, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
}  // namespace decode

}  // namespace

extern "C" unsigned long long kernels_launched() {
  return g_launched.load();
}

// q [B, Sq, H, Dh], k and v [B, Skv, G, Dh], read through their strides
// (elements; the last dimension contiguous); o [B, Sq, H, Dh] contiguous.
// vec: every row of q, k and v starts on a 16-byte boundary. dtype 0 is
// float32, 1 is bfloat16; scale is Dh^-0.5 rounded to float32, as the
// reference multiplies by it. Returns a cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int H, int G, int Dh, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    int q_offset, int vec, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || G <= 0 || H % G != 0 || window < 0 ||
      q_offset < 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  flash::Args a{q, k, v, o, Sq, Skv, H, G, q_sb, q_ss, q_sh, k_sb,
                k_ss, k_sh, v_sb, v_ss, v_sh, causal, window, q_offset,
                vec, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return flash::launch_dh<float>(a, B, Dh, s);
  if (dtype == 1) return flash::launch_dh<bf16>(a, B, Dh, s);
  return (int)cudaErrorInvalidValue;
}

// q [B, 1, H, Dh] and k, v [B, W, G, Dh] read through their strides
// (elements; the last dimension contiguous); valid [B, W] int8 with row
// stride m_sb; o [B, 1, H, Dh] contiguous. With n = ceil(W / 256) > 1
// splits: part_m, part_l [B, G, n, R] and part_acc [B, G, n, R, Dh]
// (16-byte aligned) float32 scratch, and counters [B, G] int32, all 0
// before the call and left at 0 by it (a stream's calls may share them,
// two concurrent calls may not); with n = 1 they are unused and may be
// null. vec: every row of
// q, k and v starts on a 16-byte boundary. dtype 0 is float32, 1 is
// bfloat16; scale is Dh^-0.5 rounded to float32. Returns a cudaError_t.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* valid, void* o,
    void* part_m, void* part_l, void* part_acc, void* counters, int dtype,
    int B, int W, int H, int G, int Dh, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long m_sb, int vec, float scale,
    void* stream) {
  if (B <= 0 || W <= 0 || G <= 0 || H % G != 0 ||
      H / G > decode::kMaxRep || G > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_split = (W + decode::kSplit - 1) / decode::kSplit;
  if (n_split > decode::kMaxSplit ||
      (n_split > 1 && (!part_m || !part_l || !part_acc || !counters)))
    return (int)cudaErrorInvalidValue;
  decode::Args a{q, k, v, static_cast<const int8_t*>(valid), o,
                 static_cast<float*>(part_m), static_cast<float*>(part_l),
                 static_cast<float*>(part_acc), static_cast<int*>(counters),
                 W, H, G, n_split, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                 v_sh, m_sb, vec, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return decode::launch_dh<float>(a, B, Dh, s);
  if (dtype == 1) return decode::launch_dh<bf16>(a, B, Dh, s);
  return (int)cudaErrorInvalidValue;
}
