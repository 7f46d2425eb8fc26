// Flash attention for training on Hopper (sm_90a): the forward, and the
// float32 backward. The bfloat16 backward (the training path's) is
// flash_backward.cu: wgmma tiles fed by TMA.
//
// Replaces: trlx_tpu/ops/pallas_attention.py
//   - flash_fwd      <- _flash_fwd_kernel (launched by _flash_forward)
//   - flash_bwd_dq_f32   <- _flash_bwd_dq_kernel and the jnp line for D
//     before it (launched by _flash_backward), for float32 inputs
//   - flash_bwd_dkv_f32  <- _flash_bwd_dkv_kernel, for float32 inputs
// They compute softmax(q k^T / sqrt(hd) + bias) v with the bias built
// from the raw [B, T] key mask (0 or -1e9) plus, when causal, -1e9 above
// the diagonal, and its gradients, recomputing the probabilities from
// the saved logsumexp: no [T, T] tensor is written in either direction.
//
// Layout. q, k, v, dO and O are read and written in the trunk's own
// [B, T, H, hd] layout (one head's row is hd contiguous elements), so
// the wrapper makes no transposed copy; lse and D = rowsum(dO * O) are
// float32 [B, H, T]; outputs come out in the inputs' dtype, rounded once
// from float32 sums. The forward takes float32 or bfloat16.
//
// What bounds the forward: bytes at the training slice (B 32, T 576,
// H 12, hd 64, bf16): it must move about 114 MB (~34 us at 3.35 TB/s)
// against about 18 GFLOP of live causal tiles (~18 us at 989 TF/s). At
// T 2048 operations bound it.
//
// Common to all kernels:
//   - forward and dq: one block per (batch * head, 64-row query tile),
//     looping over 64-key tiles staged in shared memory; tiles wholly
//     above the diagonal are never visited; dk/dv: one block per
//     (batch * head, 64-key tile), looping over query tiles from the
//     first that can see the tile;
//   - no atomics: every output element is written by one thread of one
//     block, so results are deterministic;
//   - the ragged edge (T not a tile multiple) loads zeros with mask 0,
//     as the TPU wrapper pads; rows past T are never written;
//   - a pad query row (left padding) sees only -1e9 keys: its max stays
//     finite and l is floored at 1e-30, so it is the finite near-uniform
//     average, never NaN.
//
// For float32 inputs all three kernels run their products as float32
// FMA on the CUDA cores (67 TF/s peak; 256 threads as a 16 x 16 grid,
// each owning 4 x 4 scores, [64][hd + 1] float tiles). They stay there
// on purpose: the tensor cores would round their operands to TF32, which
// misses the float32 parity (1e-5 on O and lse, 2e-4 on the gradients
// against the dense oracle, and the fp32 train step). The float32 dq
// first computes D for its rows (a warp a row over the staged dO tile
// and O's rows), writes it for dk/dv and keeps it in registers.
// For float32 at hd 256 the block owns 32 query (or key) rows instead of
// 64 (fma_rows): four 64-row [257]-float tiles would not fit one block.
//
// For bfloat16 inputs the forward runs on the tensor cores:
//   - 128 threads, 4 warps; each warp owns 16 query rows of the tile;
//   - every product is mma.sync m16n8k16 with bf16 operands fetched by
//     ldmatrix (.trans for an operand stored [k][n]) and float32
//     accumulators in registers: S = Q K^T, O += P V. P never touches
//     shared memory: the accumulator pair of n-tiles 2 j, 2 j + 1 is the
//     A fragment of k-step j once rounded to bf16 (2^-9 relative);
//   - bf16 tiles [64][hd + 8] (the pad keeps ldmatrix free of bank
//     conflicts) filled by 16-byte cp.async; Q is loaded once and kept
//     as A fragments in registers for the whole key loop, K, V and the
//     key mask are double-buffered: tile n + 1 loads while tile n is
//     computed;
//   - scale multiplies S in float32, so q is rounded once; the key-mask
//     bias sits in shared memory and the causal test runs on the
//     diagonal tile only;
//   - the online softmax runs on the S accumulators: a row lives in the
//     4 lanes of a quad (max by two shuffles, the sum a per-lane partial
//     reduced once at the end), exponentials are exp2f with log2(e), and
//     the running max starts finite so a fully left-padded row stays a
//     finite near-uniform average;
//   - O (divided once by the row sum) is rounded once to bf16, staged in
//     the warp's own rows of the finished Q tile and written with 16-byte
//     stores; lse = m + log(l) is float32;
//   - at hd 256 (gpt-j-6B) a warp holding all 256 columns of O's float32
//     accumulator would need 128 registers a lane for it alone, so the
//     block runs 8 warps: a pair of warps per 16-row strip, both forming
//     the strip's whole S over the full head dim, so both hold the same
//     softmax statistics, each keeping the accumulators of its own 128
//     output columns (1.5x the forward's mma); the tiles, 5 x 33.8 KB,
//     leave one block an SM.
// What bounds the bf16 forward on this card: shared-memory reads and the
// mma.sync issue rate, not device memory (about 32 ldmatrix.x4 against
// 64 mma per warp and 64 x 64 tile pair at hd 64). Its move to wgmma and
// TMA, as flash_backward.cu made for the backward, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr float kNegInf = -1e9f;

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reductions over the 16 lanes of a half warp (one score row)
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// element offset of (b, t, h, 0) in a [B, T, H, HD] tensor
template <int HD>
__device__ __forceinline__ size_t row_at(int b, int t, int T, int H, int h) {
  return ((static_cast<size_t>(b) * T + t) * H + h) * HD;
}

// rows of the block's own tile in the float32 kernels (query rows in the
// forward and dq, key rows in dk/dv): 64, or 32 at HD 256, where four
// [64][HD + 1] float tiles would pass the 227 KB a block may use
template <int HD>
__host__ __device__ constexpr int fma_rows() { return HD > 128 ? 32 : 64; }

// stage rows [t0, t0 + ROWS) of head (b, h) as float32 times `mul` into a
// [ROWS][HD + 1] shared tile; rows past T are zeros
template <typename T, int HD, int ROWS = 64>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int t0, int Tlen, int H, int h,
                                          float mul) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    const int t = t0 + r;
    float x = 0.f;
    if (t < Tlen) x = to_f32<T>(src[row_at<HD>(b, t, Tlen, H, h) + d]) * mul;
    dst[r * LD + d] = x;
  }
}

// the key-mask bias of keys [k0, k0 + 64): 0 for a real key, -1e9 for a
// masked one or one past T
__device__ __forceinline__ void load_key_bias(float* dst,
                                              const int32_t* mask, int b,
                                              int k0, int Tlen) {
  for (int c = threadIdx.x; c < kBK; c += kThreads) {
    const int t = k0 + c;
    dst[c] = (t < Tlen && mask[static_cast<size_t>(b) * Tlen + t] > 0)
                 ? 0.f
                 : kNegInf;
  }
}

// ------------------------------------------------------------------ //
// forward
// ------------------------------------------------------------------ //

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int Tlen,
                 int H, int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int PLD = kBK + 1;
  constexpr int NJ = HD / 16;
  constexpr int BQ = fma_rows<HD>();
  constexpr int RI = BQ / 16;  // query rows a thread owns
  extern __shared__ float smem[];
  float* q_s = smem;                 // [BQ][HD + 1], scaled
  float* k_s = q_s + BQ * LD;        // [BK][HD + 1]
  float* v_s = k_s + kBK * LD;       // [BK][HD + 1]
  float* p_s = v_s + kBK * LD;       // [BQ][BK + 1]
  float* kb_s = p_s + BQ * PLD;      // [BK] key-mask bias

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, HD, BQ>(q_s, q, b, q0, Tlen, H, h, scale);

  float m[RI], l[RI], acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int n_k = (Tlen + kBK - 1) / kBK;
  const int n_live = causal ? min(n_k, (q0 + BQ + kBK - 1) / kBK) : n_k;
  for (int jt = 0; jt < n_live; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(k_s, k, b, k0, Tlen, H, h, 1.f);
    load_tile<T, HD>(v_s, v, b, k0, Tlen, H, h, 1.f);
    load_key_bias(kb_s, mask, b, k0, Tlen);
    __syncthreads();

    float s[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RI], kv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float bias = kb_s[c];
        if (causal && qpos < k0 + c) bias += kNegInf;
        s[i][j] += bias;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = max16(mt);
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[r * PLD + tx + 16 * j] = p;
        rs += p;
      }
      rs = sum16(rs);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncwarp();  // a row's probabilities come from its own half warp

    for (int c = 0; c < kBK; ++c) {
      float vv[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) vv[jj] = v_s[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = p_s[(ty + 16 * i) * PLD + c];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tlen) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const size_t off = row_at<HD>(b, row, Tlen, H, h);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      out[off + tx + 16 * jj] = from_f32<T>(acc[i][jj] / l_safe);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * Tlen + row] = m[i] + logf(l_safe);
  }
}

// ------------------------------------------------------------------ //
// backward, float32 inputs: dq (and D) on the CUDA cores
// ------------------------------------------------------------------ //

// Also computes D = rowsum(dO * O) of its rows first, writes it to `dD`
// for dk/dv and uses it from registers.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fma_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ g,
                        const float* __restrict__ o,
                        const float* __restrict__ lse,
                        const int32_t* __restrict__ mask,
                        float* __restrict__ dq, float* __restrict__ dD,
                        int Tlen, int H, int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int PLD = kBK + 1;
  constexpr int NJ = HD / 16;
  constexpr int BQ = fma_rows<HD>();
  constexpr int RI = BQ / 16;  // query rows a thread owns
  extern __shared__ float smem[];
  float* q_s = smem;               // [BQ][HD + 1], scaled
  float* g_s = q_s + BQ * LD;      // [BQ][HD + 1]
  float* k_s = g_s + BQ * LD;      // [BK][HD + 1]
  float* v_s = k_s + kBK * LD;     // [BK][HD + 1]
  float* ds_s = v_s + kBK * LD;    // [BQ][BK + 1]
  float* kb_s = ds_s + BQ * PLD;   // [BK]
  float* d_s = kb_s + kBK;         // [BQ] D

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<float, HD, BQ>(q_s, q, b, q0, Tlen, H, h, scale);
  load_tile<float, HD, BQ>(g_s, g, b, q0, Tlen, H, h, 1.f);
  __syncthreads();
  // D = rowsum(dO * O), a warp a row
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < BQ; r += kThreads / 32) {
    const int row = q0 + r;
    float d = 0.f;
    if (row < Tlen) {
      const float* orow = o + row_at<HD>(b, row, Tlen, H, h);
      for (int c = lane; c < HD; c += 32)
        d = fmaf(g_s[r * LD + c], orow[c], d);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    if (lane == 0) {
      d_s[r] = d;
      if (row < Tlen) dD[static_cast<size_t>(bh) * Tlen + row] = d;
    }
  }
  __syncthreads();
  float lse_r[RI], d_r[RI], acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < Tlen;
    lse_r[i] = in ? lse[static_cast<size_t>(bh) * Tlen + row] : 0.f;
    d_r[i] = d_s[ty + 16 * i];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int n_k = (Tlen + kBK - 1) / kBK;
  const int n_live = causal ? min(n_k, (q0 + BQ + kBK - 1) / kBK) : n_k;
  for (int jt = 0; jt < n_live; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();
    load_tile<float, HD>(k_s, k, b, k0, Tlen, H, h, 1.f);
    load_tile<float, HD>(v_s, v, b, k0, Tlen, H, h, 1.f);
    load_key_bias(kb_s, mask, b, k0, Tlen);
    __syncthreads();

    float s[RI][4], dp[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RI], gv[RI], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = q_s[(ty + 16 * i) * LD + d];
        gv[i] = g_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(tx + 16 * j) * LD + d];
        vv[j] = v_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float bias = kb_s[c];
        if (causal && qpos < k0 + c) bias += kNegInf;
        const float p = expf(s[i][j] + bias - lse_r[i]);
        ds_s[r * PLD + c] = p * (dp[i][j] - d_r[i]);
      }
    }
    __syncwarp();

    for (int c = 0; c < kBK; ++c) {
      float kv[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) kv[jj] = k_s[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float ds = ds_s[(ty + 16 * i) * PLD + c];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(ds, kv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tlen) continue;
    const size_t off = row_at<HD>(b, row, Tlen, H, h);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dq[off + tx + 16 * jj] = acc[i][jj] * scale;
  }
}

// ------------------------------------------------------------------ //
// backward, float32 inputs: dk, dv on the CUDA cores
// ------------------------------------------------------------------ //

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ dD,
                     const int32_t* __restrict__ mask,
                     float* __restrict__ dk, float* __restrict__ dv, int Tlen,
                     int H, int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int PLD = kBQ + 1;
  constexpr int NJ = HD / 16;
  constexpr int BK = fma_rows<HD>();
  constexpr int RI = BK / 16;  // key rows a thread owns
  extern __shared__ float smem[];
  float* k_s = smem;               // [BK][HD + 1]
  float* v_s = k_s + BK * LD;      // [BK][HD + 1]
  float* q_s = v_s + BK * LD;      // [BQ][HD + 1], scaled
  float* g_s = q_s + kBQ * LD;     // [BQ][HD + 1]
  float* p_s = g_s + kBQ * LD;     // [BK][BQ + 1]  P^T
  float* ds_s = p_s + BK * PLD;    // [BK][BQ + 1]  dS^T
  float* lse_s = ds_s + BK * PLD;  // [BQ]
  float* d_s = lse_s + kBQ;        // [BQ]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<float, HD, BK>(k_s, k, b, k0, Tlen, H, h, 1.f);
  load_tile<float, HD, BK>(v_s, v, b, k0, Tlen, H, h, 1.f);
  float kbias[RI], dk_acc[RI][NJ], dv_acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = k0 + ty + 16 * i;
    kbias[i] = (t < Tlen && mask[static_cast<size_t>(b) * Tlen + t] > 0)
                   ? 0.f
                   : kNegInf;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;
  }

  const int n_q = (Tlen + kBQ - 1) / kBQ;
  const int first = causal ? k0 / kBQ : 0;
  for (int it = first; it < n_q; ++it) {
    const int q0 = it * kBQ;
    __syncthreads();
    load_tile<float, HD>(q_s, q, b, q0, Tlen, H, h, scale);
    load_tile<float, HD>(g_s, g, b, q0, Tlen, H, h, 1.f);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const int row = q0 + r;
      const bool in = row < Tlen;
      lse_s[r] = in ? lse[static_cast<size_t>(bh) * Tlen + row] : 0.f;
      d_s[r] = in ? dD[static_cast<size_t>(bh) * Tlen + row] : 0.f;
    }
    __syncthreads();

    float st[RI][4], dpt[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[RI], vv[RI], qv[4], gv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        kv[i] = k_s[(ty + 16 * i) * LD + d];
        vv[i] = v_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = q_s[(tx + 16 * j) * LD + d];
        gv[j] = g_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
          dpt[i][j] = fmaf(gv[j], vv[i], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int c = ty + 16 * i;  // key row of this tile
      const int kpos = k0 + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;  // query column
        float bias = kbias[i];
        if (causal && q0 + r < kpos) bias += kNegInf;
        const float p = expf(st[i][j] + bias - lse_s[r]);
        p_s[c * PLD + r] = p;
        ds_s[c * PLD + r] = p * (dpt[i][j] - d_s[r]);
      }
    }
    __syncwarp();

    for (int r = 0; r < kBQ; ++r) {
      float gv[NJ], qv[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        gv[jj] = g_s[r * LD + tx + 16 * jj];
        qv[jj] = q_s[r * LD + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = p_s[(ty + 16 * i) * PLD + r];
        const float ds = ds_s[(ty + 16 * i) * PLD + r];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          dv_acc[i][jj] = fmaf(p, gv[jj], dv_acc[i][jj]);
          dk_acc[i][jj] = fmaf(ds, qv[jj], dk_acc[i][jj]);
        }
      }
    }
  }

  // dk is taken against the pre-scaled q, so it needs no extra factor
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Tlen) continue;
    const size_t off = row_at<HD>(b, row, Tlen, H, h);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      dk[off + tx + 16 * jj] = dk_acc[i][jj];
      dv[off + tx + 16 * jj] = dv_acc[i][jj];
    }
  }
}

// ------------------------------------------------------------------ //
// bfloat16 inputs: tensor-core tiles (the forward; the bf16 backward is
// flash_backward.cu)
// ------------------------------------------------------------------ //

constexpr int kTcThreads = 128;  // 4 warps; each owns 16 rows of a tile
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// padded row of a bf16 shared tile: HD + 8 elements, so the eight 16-byte
// rows one ldmatrix reads fall in distinct banks
template <int HD>
__host__ __device__ constexpr int tc_ld() { return HD + 8; }

template <int HD>
__host__ __device__ constexpr int tc_tile() { return kBQ * tc_ld<HD>(); }

// warps that share one 16-row strip of the tile: 1, or 2 at HD 256, where
// a warp holding all HD columns of O's float32 accumulator would need 128
// registers a lane for it alone. The warps of a pair both form the
// strip's whole S over the full head dim, so both hold the same softmax
// statistics, and each keeps the accumulators of its own HD / 2 output
// columns.
template <int HD>
__host__ __device__ constexpr int tc_split() { return HD > 128 ? 2 : 1; }

template <int HD>
__host__ __device__ constexpr int tc_threads() {
  return kTcThreads * tc_split<HD>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (cg) and 4-byte (ca) async copies; a source of 0 bytes fills
// the destination with zeros (the ragged edge)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded once to bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment offsets (elements) into a [64][HD + 8] tile, for lane l:
//  - A operand, rows m0 .. m0 + 15 by columns k0 .. k0 + 15 of a
//    row-major tile (also B through ldmatrix.trans when the tile is
//    stored [k][n]): r0..r3 = a0..a3, or b0, b1 of n-tiles n0, n0 + 8;
//  - B operand stored [n][k] (a K or Q tile for S = Q K^T): rows
//    n0 .. n0 + 15, columns k0 .. k0 + 15; r0, r1 = b0, b1 of n-tile n0
//    and r2, r3 of n-tile n0 + 8.
template <int HD>
__device__ __forceinline__ int frag_a(int lane, int m0, int k0) {
  return (m0 + (lane & 15)) * tc_ld<HD>() + k0 + ((lane >> 4) << 3);
}

template <int HD>
__device__ __forceinline__ int frag_b(int lane, int n0, int k0) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * tc_ld<HD>() + k0 +
         (((lane >> 3) & 1) << 3);
}

// rows [t0, t0 + 64) of head (b, h) into a bf16 [64][HD + 8] tile by
// 16-byte async copies from all threads; rows past T are zeros
template <int HD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int b, int t0, int Tlen,
                                                int H, int h) {
  constexpr int CH = HD / 8;
  for (int idx = threadIdx.x; idx < kBQ * CH; idx += blockDim.x) {
    const int r = idx / CH;
    const int c = idx - r * CH;
    const int t = t0 + r;
    const bool ok = t < Tlen;
    cp_async16(smem_u32(dst + r * tc_ld<HD>() + c * 8),
               src + row_at<HD>(b, ok ? t : Tlen - 1, Tlen, H, h) + c * 8,
               ok);
  }
}

// 64 consecutive 4-byte values src[t0 .. t0 + 64) (zeros past T) by
// threads [first, first + 64)
__device__ __forceinline__ void load_row_async(void* dst, const void* src,
                                               int t0, int Tlen, int first) {
  const int c = static_cast<int>(threadIdx.x) - first;
  if (c < 0 || c >= kBK) return;
  const int t = t0 + c;
  const bool ok = t < Tlen;
  cp_async4(smem_u32(static_cast<uint32_t*>(dst) + c),
            static_cast<const uint32_t*>(src) + (ok ? t : 0), ok);
}

// a warp's 16 rows of float32 accumulators [NT][4] (output columns
// c0 .. c0 + 8 NT), times `mul`, rounded once to bf16, staged in the
// warp's own rows and columns of `stage` and stored to rows t0 .. t0 + 15
// (those below T) with 16-byte stores
template <int HD, int NT>
__device__ __forceinline__ void store_rows(bf16* out, bf16* stage,
                                           const float (&acc)[NT][4],
                                           float mul, int lane, int b, int t0,
                                           int Tlen, int H, int h, int c0) {
  constexpr int LD = tc_ld<HD>();
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = c0 + nt * 8 + tq * 2;
    *reinterpret_cast<uint32_t*>(stage + gq * LD + c) =
        pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (gq + 8) * LD + c) =
        pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * NT; idx += 32) {
    const int r = idx / NT;
    const int c = c0 + (idx - r * NT) * 8;
    if (t0 + r < Tlen)
      *reinterpret_cast<uint4*>(out + row_at<HD>(b, t0 + r, Tlen, H, h) +
                                c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

// ------------------------------------------------------------------ //
// forward, bfloat16 inputs: tensor-core tiles
// ------------------------------------------------------------------ //

// one block per (batch * head, 64-row query tile), heaviest causal tiles
// first; warp w owns query rows 16 (w % 4) .. + 15 and, at HD 256, output
// columns (w / 4) HD / 2 .. + HD / 2 of O. Q is loaded once and
// kept as A fragments in registers; K, V and the key mask stream through
// two stages. The online softmax runs on the S accumulators in
// registers: each row lives in the 4 lanes of a quad, so its max takes
// two shuffles, and its sum stays a per-lane partial until the end
// (every lane rescales by the same row max). P, rounded once to bf16, is
// the A operand of O += P V.
template <int HD>
__global__ void __launch_bounds__(tc_threads<HD>())
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const int32_t* __restrict__ mask, bf16* __restrict__ out,
                     float* __restrict__ lse, int Tlen, int H, int causal,
                     float scale) {
  constexpr int TILE = tc_tile<HD>();
  constexpr int SPLIT = tc_split<HD>();
  constexpr int NT = HD / 8 / SPLIT;  // accumulator n-tiles a warp keeps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);      // [64][HD + 8]
  bf16* k_s = q_s + TILE;                              // [2][64][HD + 8]
  bf16* v_s = k_s + 2 * TILE;                          // [2][64][HD + 8]
  int32_t* m_s = reinterpret_cast<int32_t*>(v_s + 2 * TILE);  // [2][64]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int iq = gridDim.y - 1 - blockIdx.y;
  const int q0 = iq * kBQ;
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16;
  const int c0 = (threadIdx.x >> 7) * (HD / SPLIT);
  const int gq = lane >> 2, tq = lane & 3;
  const size_t mrow = static_cast<size_t>(b) * Tlen;

  const int n_k = (Tlen + kBK - 1) / kBK;
  const int n_live = causal ? min(n_k, iq + 1) : n_k;

  load_tile_async<HD>(q_s, q, b, q0, Tlen, H, h);
  load_tile_async<HD>(k_s, k, b, 0, Tlen, H, h);
  load_tile_async<HD>(v_s, v, b, 0, Tlen, H, h);
  load_row_async(m_s, mask + mrow, 0, Tlen, 0);
  cp_async_commit();

  // rows gq and gq + 8 of the warp: running max (finite from the start,
  // below any biased score), per-lane partial sums, O accumulators
  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  uint32_t qa[HD / 16][4];

  for (int jt = 0; jt < n_live; ++jt) {
    const int st = jt & 1;
    if (jt + 1 < n_live) {
      const int k1 = (jt + 1) * kBK;
      load_tile_async<HD>(k_s + (st ^ 1) * TILE, k, b, k1, Tlen, H, h);
      load_tile_async<HD>(v_s + (st ^ 1) * TILE, v, b, k1, Tlen, H, h);
      load_row_async(m_s + (st ^ 1) * kBK, mask + mrow, k1, Tlen, 0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (jt == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldsm_x4(smem_u32(q_s + frag_a<HD>(lane, r0, kk * 16)), qa[kk]);
    }
    const bf16* ks = k_s + st * TILE;
    const bf16* vs = v_s + st * TILE;
    const int32_t* ms = m_s + st * kBK;

    // S = Q K^T, 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t kb[4];
        ldsm_x4(smem_u32(ks + frag_b<HD>(lane, nn * 16, kk * 16)), kb);
        mma_bf16(s[2 * nn], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * nn + 1], qa[kk], kb[2], kb[3]);
      }

    // scale and bias in float32, then the tile's row max
    const bool diag = causal && jt == iq;  // q0 == k0 on the diagonal
    float mt[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + tq * 2 + (e & 1);
        const int i = e >> 1;
        float bias = ms[c] > 0 ? 0.f : kNegInf;
        if (diag && r0 + gq + 8 * i < c) bias += kNegInf;
        s[j][e] = fmaf(s[j][e], scale, bias);
        mt[i] = fmaxf(mt[i], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      alpha[i] = exp2f((m_r[i] - mt[i]) * kLog2e);
      m_r[i] = mt[i];
      l_r[i] *= alpha[i];
    }

    // P in registers, rounded to bf16 A fragments: the accumulators of
    // n-tiles 2 kk, 2 kk + 1 are A's k-step kk
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        p[e] = exp2f((s[j][e] - m_r[i]) * kLog2e);
        l_r[i] += p[e];
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }

    // O += P V for the warp's output columns: V is stored [key][d], so B
    // comes by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nd = 0; nd < NT / 2; ++nd) {
        uint32_t vb[4];
        ldsm_x4_t(smem_u32(vs + frag_a<HD>(lane, kk * 16, c0 + nd * 16)),
                  vb);
        mma_bf16(acc[2 * nd], pa[kk], vb[0], vb[1]);
        mma_bf16(acc[2 * nd + 1], pa[kk], vb[2], vb[3]);
      }
    __syncthreads();  // every warp is done with this stage
  }

  // the row sums of the quad, O divided once, lse = m + log(l)
  float l_safe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_safe[i] = fmaxf(l, 1e-30f);
    const int row = q0 + r0 + gq + 8 * i;
    if (tq == 0 && c0 == 0 && row < Tlen)
      lse[static_cast<size_t>(bh) * Tlen + row] = m_r[i] + logf(l_safe[i]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] /= l_safe[0];
    acc[nt][1] /= l_safe[0];
    acc[nt][2] /= l_safe[1];
    acc[nt][3] /= l_safe[1];
  }
  // the warp's own rows and columns of the Q tile are free now (every
  // warp loaded its Q fragments before the loop's last barrier): stage O
  // there
  store_rows<HD, NT>(out, q_s + r0 * tc_ld<HD>(), acc, 1.f, lane, b,
                     q0 + r0, Tlen, H, h, c0);
}

// ------------------------------------------------------------------ //
// launch helpers
// ------------------------------------------------------------------ //

// float32 forward: [HD + 1]-float rows of the Q tile (fma_rows), K and
// V (64 each), the score tile and the key-mask bias
template <int HD>
constexpr size_t fwd_fma_smem() {
  constexpr size_t R = fma_rows<HD>();
  return sizeof(float) *
         ((R + 2 * kBK) * (HD + 1) + R * (kBK + 1) + kBK);
}

// bf16 forward: five [64][HD + 8] bf16 tiles (Q, then K and V x two
// stages) and two stages of the key mask
template <int HD>
constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * 5 * static_cast<size_t>(tc_tile<HD>()) +
         sizeof(int32_t) * 2 * kBK;
}

// float32 backward: [HD + 1]-float rows of the block's own two tiles
// (fma_rows each) and of the two streamed ones (64 each), score tiles,
// row vectors
template <int HD>
constexpr size_t dq_fma_smem() {
  constexpr size_t R = fma_rows<HD>();
  return sizeof(float) *
         ((2 * R + 2 * kBK) * (HD + 1) + R * (kBK + 1) + kBK + R);
}

template <int HD>
constexpr size_t dkv_fma_smem() {
  constexpr size_t R = fma_rows<HD>();
  return sizeof(float) *
         ((2 * R + 2 * kBQ) * (HD + 1) + 2 * R * (kBQ + 1) + 2 * kBQ);
}

// raise a kernel's dynamic shared-memory ceiling once (not on every
// launch, so launches can be captured into a CUDA graph)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool* done) {
  if (*done || smem <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  *done = err == cudaSuccess;
  return err;
}

// the float32 instantiations run the CUDA-core bodies, bf16 the tensor
// cores
template <typename T, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* lse, int B, int Tlen,
                       int H, int causal, float scale, cudaStream_t st) {
  constexpr bool f32 = std::is_same<T, float>::value;
  auto kernel = [] {
    if constexpr (std::is_same<T, float>::value)
      return flash_fwd_kernel<float, HD>;
    else return flash_fwd_mma_kernel<HD>;
  }();
  const size_t smem = f32 ? fwd_fma_smem<HD>() : fwd_mma_smem<HD>();
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  const int rows = f32 ? fma_rows<HD>() : kBQ;
  dim3 grid(B * H, (Tlen + rows - 1) / rows);
  kernel<<<grid, f32 ? kThreads : tc_threads<HD>(), smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(mask),
      static_cast<T*>(out), static_cast<float*>(lse), Tlen, H, causal, scale);
  return cudaGetLastError();
}

// the float32 backward (the bf16 one is flash_backward.cu)
template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const void* o, const void* lse,
                      const void* mask, void* dq, void* dD, int B, int Tlen,
                      int H, int causal, float scale, cudaStream_t st) {
  auto kernel = flash_bwd_dq_fma_kernel<HD>;
  const size_t smem = dq_fma_smem<HD>();
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tlen + fma_rows<HD>() - 1) / fma_rows<HD>());
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(o), static_cast<const float*>(lse),
      static_cast<const int32_t*>(mask), static_cast<float*>(dq),
      static_cast<float*>(dD), Tlen, H, causal, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* dD,
                       const void* mask, void* dk, void* dv, int B, int Tlen,
                       int H, int causal, float scale, cudaStream_t st) {
  auto kernel = flash_bwd_dkv_fma_kernel<HD>;
  const size_t smem = dkv_fma_smem<HD>();
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tlen + fma_rows<HD>() - 1) / fma_rows<HD>());
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(dD),
      static_cast<const int32_t*>(mask), static_cast<float*>(dk),
      static_cast<float*>(dv), Tlen, H, causal, scale);
  return cudaGetLastError();
}

bool shape_ok(int B, int T, int H, int hd, int dtype) {
  return B > 0 && T > 0 && H > 0 && (dtype == kF32 || dtype == kBF16) &&
         (hd == 16 || hd == 32 || hd == 64 || hd == 128 || hd == 256);
}

// dispatch on (dtype, hd) to F<T, HD>::run(args...)
#define FLASH_DISPATCH(LAUNCH, ...)                                       \
  do {                                                                    \
    if (dtype == kF32) {                                                  \
      switch (hd) {                                                       \
        case 16: return static_cast<int>(LAUNCH<float, 16>(__VA_ARGS__)); \
        case 32: return static_cast<int>(LAUNCH<float, 32>(__VA_ARGS__)); \
        case 64: return static_cast<int>(LAUNCH<float, 64>(__VA_ARGS__)); \
        case 128: return static_cast<int>(LAUNCH<float, 128>(__VA_ARGS__));\
        default: return static_cast<int>(LAUNCH<float, 256>(__VA_ARGS__));\
      }                                                                   \
    }                                                                     \
    switch (hd) {                                                         \
      case 16: return static_cast<int>(LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__));  \
      case 32: return static_cast<int>(LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__));  \
      case 64: return static_cast<int>(LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__));  \
      case 128: return static_cast<int>(LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__)); \
      default: return static_cast<int>(LAUNCH<__nv_bfloat16, 256>(__VA_ARGS__)); \
    }                                                                     \
  } while (0)

// dispatch on hd to F<HD>(args...)
#define F32_DISPATCH(LAUNCH, ...)                                  \
  do {                                                             \
    switch (hd) {                                                  \
      case 16: return static_cast<int>(LAUNCH<16>(__VA_ARGS__));   \
      case 32: return static_cast<int>(LAUNCH<32>(__VA_ARGS__));   \
      case 64: return static_cast<int>(LAUNCH<64>(__VA_ARGS__));   \
      case 128: return static_cast<int>(LAUNCH<128>(__VA_ARGS__)); \
      default: return static_cast<int>(LAUNCH<256>(__VA_ARGS__));  \
    }                                                              \
  } while (0)

}  // namespace

// Plain C entry points (bound with ctypes). flash_fwd: dtype 0 float32,
// 1 bfloat16 (q, k, v and O share it); the backward here takes float32
// only (flash_bwd_dq_f32 writes dq and D = rowsum(dO * O), which
// flash_bwd_dkv_f32 reads; the bf16 backward is flash_backward.cu). hd
// one of 16, 32, 64, 128, 256; mask int32 [B, T]; lse and D float32
// [B, H, T]; the bf16 forward reads and writes 16-byte rows, so its
// tensors start 16-byte aligned. Each returns cudaGetLastError() after
// its launch (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* out, void* lse, int B, int T,
                         int H, int hd, int causal, int dtype, float scale,
                         void* stream) {
  if (!shape_ok(B, T, H, hd, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, mask, out, lse, B, T, H, causal, scale,
                 st);
}

extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* g, const void* o, const void* lse,
                                const void* mask, void* dq, void* dD, int B,
                                int T, int H, int hd, int causal, float scale,
                                void* stream) {
  if (!shape_ok(B, T, H, hd, kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  F32_DISPATCH(launch_dq, q, k, v, g, o, lse, mask, dq, dD, B, T, H, causal,
               scale, st);
}

extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* dD, const void* mask, void* dk,
                                 void* dv, int B, int T, int H, int hd,
                                 int causal, float scale, void* stream) {
  if (!shape_ok(B, T, H, hd, kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  F32_DISPATCH(launch_dkv, q, k, v, g, lse, dD, mask, dk, dv, B, T, H,
               causal, scale, st);
}
