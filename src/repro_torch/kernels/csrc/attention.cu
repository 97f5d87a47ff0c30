// The two attention kernels of the serving path for Hopper (sm_90a): the
// FlashAttention forward of every prefill (flash_attention_fwd) and the
// single-token attention of every decode step (decode_attention_fwd).
// They share their element conversions, their rounding of p to V's type
// and their shared-memory tile loads, defined once below.
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
// finite).
//
// Design. One block of 128 threads per (64-row query tile, head, batch
// row). The block stages its query tile in shared memory as float32,
// then walks the KV tiles of 64 keys in order, skipping a tile that the
// causal, window and length masks empty for the whole query tile (the
// reference's `relevant` test, with the same tile sizes on both sides).
// Per tile:
//   1. K and V (64 x Dh, in the inputs' type: bf16 or f32) are copied to
//      shared memory, 16 bytes a load where the strides allow;
//   2. the 64 x 64 scores in float32 on the CUDA cores: each thread owns
//      4 rows x 8 columns, a Dh-long dot product each; then scale and
//      mask;
//   3. the online softmax, one warp per 16 rows: the row max by
//      shuffles, p = exp(s - m_new), the row sum of p in float32, alpha
//      = exp(m_prev - m_new); p is rounded to V's type (the reference
//      casts p to v.dtype before p.v);
//   4. acc = acc * alpha + p v, each thread owning 4 rows x Dh/8 columns
//      of the float32 accumulator in registers.
// At the end the output is acc / max(l, 1e-37), cast to the inputs'
// type, written in the model's [B, S, H, Dh] layout. q, k and v are read
// in that layout through their strides: the reference's transposes and
// block padding exist for the TPU only. Shared rows are padded by one
// word against bank conflicts.
//
// Bound on an H100 SXM: the matrix products, 4 Sq Skv' H Dh operations
// (Skv' the keys each row attends to), at the 989 TFLOP/s bf16 tensor-core
// peak, or the bytes of q, k, v and o at 3.35 TB/s, whichever is larger.
// This first kernel computes on the CUDA cores in float32 (67 TFLOP/s at
// best) and does not overlap its loads with its arithmetic; wgmma, TMA
// and warp specialisation are later work. The library yardstick is
// torch.nn.functional.scaled_dot_product_attention, which the port never
// calls.
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
// Design. One block of 128 threads per (group, batch row, split of 64
// cache slots): a single block per (b, g) would fill 16 of the 132 SMs at
// the serving shape (8 slots x 2 groups), and a block walks its tiles one
// after another with its loads not overlapped, so the cache is split
// (flash-decoding) into ceil(W / 64) parts of one tile each, 512 blocks
// at W = 2048, several resident on an SM at once. Each block stages the
// group's R query rows in shared memory as float32 and walks its part of
// the cache in tiles of 64 slots, in order, with an online softmax:
//   1. the tile's validity bytes are read first; a tile with no valid
//      slot is skipped whole (a block-uniform __syncthreads_or), so a
//      cache filled to n slots costs the K/V bytes of ceil(n / 64) tiles.
//      Otherwise K and V (64 x Dh, bf16 or f32) are copied to shared
//      memory, 16 bytes a load where the strides allow: each K/V byte is
//      read once and serves all R heads of the group (the reference's
//      grouped [R, bkv] product);
//   2. the R x 64 scores in float32, one Dh-long dot product (four
//      partial sums) per thread and entry, then scale and the validity
//      mask;
//   3. the online softmax, one warp per row: m, l and alpha in float32; p
//      rounded to V's type for p.v, as the reference casts it;
//   4. acc[R][Dh] = acc * alpha + p v, float32, in shared memory (R is a
//      run-time count), each entry owned by one thread.
// With one split the block writes acc / max(l, 1e-37) in the inputs' type
// as [B, 1, H, Dh]; otherwise it writes its (m, l, acc) to scratch and a
// second kernel folds the splits in order: M = max m_j, w_j = exp(m_j -
// M), out = sum w_j acc_j / max(sum w_j l_j, 1e-37).
//
// Skipping a tile of invalid slots changes no row that has a valid slot:
// visited before the row's first valid tile, such a tile would leave m =
// NEG_INF and be scaled by alpha = exp(NEG_INF - m_new) = 0; visited
// after, its p = exp(NEG_INF - m) = 0. So a skipped split carries m =
// NEG_INF, l = 0, acc = 0 and weighs exp(NEG_INF - M) = 0 in the fold. A
// row with no valid slot at all comes out 0 (and finite). The plain
// version skips the same tiles, so they agree on every row.
//
// Bound on an H100 SXM: the bytes, the K and V of the valid slots read
// once (4 n G Dh at bf16 for n valid slots over the batch: 16.8 MB for a
// full cache at B = 8, W = 2048, G = 2, Dh = 128, 5.0 us at 3.35 TB/s),
// plus the mask, q and o. This kernel does not overlap its loads with its
// arithmetic and computes on the CUDA cores. The library yardstick is
// torch.nn.functional.scaled_dot_product_attention with a boolean mask,
// which the port never calls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBKV = 64;        // keys (cache slots) per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1073741824.0f;  // -2^30, NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) {
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

// ---- flash_attention_fwd ----------------------------------------------

namespace flash {

constexpr int kBQ = 64;         // query rows per block

template <typename T, int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (DH + 1) + kBQ * (kBKV + 1) + 3 * kBQ) +
         sizeof(T) * 2 * kBKV * pitch<T, DH>();
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

template <typename T, int DH>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
constexpr int kSplit = 64;      // cache slots per block (a split)
constexpr int kMaxSplit = 6144; // the fold's m, l in 48 KB of shared memory

template <typename T, int DH>
size_t smem_bytes(int R) {
  return sizeof(float) * ((size_t)R * (DH + 1) + (size_t)R * (kBKV + 1) +
                          (size_t)R * DH + 3 * (size_t)R) +
         kBKV + sizeof(T) * 2 * kBKV * pitch<T, DH>();
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int8_t* valid;
  void* o;
  float* part_m;      // [B, G, n_split, R]      (n_split > 1 only)
  float* part_l;      // [B, G, n_split, R]
  float* part_acc;    // [B, G, n_split, R, DH]
  int W, H, G, n_split;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, m_sb;
  int vec;
  float scale;
};

// One block per (group, batch row, split of kSplit slots).
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
}

// Folds the splits of one (batch row, head): M = max_j m_j, w_j =
// exp(m_j - M), out = sum_j w_j acc_j / max(sum_j w_j l_j, 1e-37), summed
// in split order. One block of Dh threads per (b, g, r) row.
// The splits' m and l are staged in shared memory, so that the loop over
// acc issues independent loads.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* o, int n_split, int R, int Dh) {
  extern __shared__ float fold_s[];
  float* w_s = fold_s;                           // [n_split]: m_j, then w_j
  float* l_s = fold_s + n_split;                 // [n_split]
  const int row = blockIdx.x, d = threadIdx.x;   // row = (b G + g) R + r
  const int bg = row / R, r = row % R;
  const long long base = (long long)bg * n_split * R + r;
  for (int j = d; j < n_split; j += blockDim.x) {
    w_s[j] = part_m[base + j * R];
    l_s[j] = part_l[base + j * R];
  }
  __syncthreads();
  float M = kNegInf;
  for (int j = 0; j < n_split; ++j) M = fmaxf(M, w_s[j]);
  __syncthreads();                               // every M read its m_j
  for (int j = d; j < n_split; j += blockDim.x) w_s[j] = expf(w_s[j] - M);
  __syncthreads();
  float L = 0.0f, x = 0.0f;
#pragma unroll 8
  for (int j = 0; j < n_split; ++j) {
    L = L + l_s[j] * w_s[j];
    x = x + part_acc[(base + j * R) * Dh + d] * w_s[j];
  }
  from_f(x / fmaxf(L, 1e-37f), o + (long long)row * Dh + d);
}

template <typename T, int DH>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH>(a.H / a.G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T, DH><<<dim3(a.G, B, a.n_split), kThreads, smem, stream>>>(
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return (int)err;
  decode_combine_kernel<T>
      <<<B * a.H, DH, 2 * sizeof(float) * a.n_split, stream>>>(
      a.part_m, a.part_l, a.part_acc, static_cast<T*>(a.o), a.n_split,
      a.H / a.G, DH);
  return (int)cudaGetLastError();
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

// q [B, Sq, H, Dh], k and v [B, Skv, G, Dh], read through their strides
// (elements; the last dimension contiguous); o [B, Sq, H, Dh] contiguous.
// dtype 0 is float32, 1 is bfloat16; scale is Dh^-0.5 rounded to float32,
// as the reference multiplies by it. Returns a cudaError_t.
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
  if (dtype == 1) return flash::launch_dh<__nv_bfloat16>(a, B, Dh, s);
  return (int)cudaErrorInvalidValue;
}

// q [B, 1, H, Dh] and k, v [B, W, G, Dh] read through their strides
// (elements; the last dimension contiguous); valid [B, W] int8 with row
// stride m_sb; o [B, 1, H, Dh] contiguous; part_m, part_l [B, G, n, R]
// and part_acc [B, G, n, R, Dh] float32 scratch for the n = ceil(W / 64)
// splits (unused, may be null, when n = 1). dtype 0 is float32, 1 is
// bfloat16; scale is Dh^-0.5 rounded to float32. Returns a cudaError_t.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* valid, void* o,
    void* part_m, void* part_l, void* part_acc, int dtype, int B, int W,
    int H, int G, int Dh, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long m_sb, int vec, float scale, void* stream) {
  if (B <= 0 || W <= 0 || G <= 0 || H % G != 0 ||
      H / G > decode::kMaxRep || G > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_split = (W + decode::kSplit - 1) / decode::kSplit;
  if (n_split > decode::kMaxSplit ||
      (n_split > 1 && (!part_m || !part_l || !part_acc)))
    return (int)cudaErrorInvalidValue;
  decode::Args a{q, k, v, static_cast<const int8_t*>(valid), o,
                 static_cast<float*>(part_m), static_cast<float*>(part_l),
                 static_cast<float*>(part_acc), W, H, G, n_split, q_sb,
                 q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, m_sb, vec, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return decode::launch_dh<float>(a, B, Dh, s);
  if (dtype == 1) return decode::launch_dh<__nv_bfloat16>(a, B, Dh, s);
  return (int)cudaErrorInvalidValue;
}
