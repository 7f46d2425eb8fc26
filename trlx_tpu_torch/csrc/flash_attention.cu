// Flash attention for training on Hopper (sm_90a): the forward and the
// two backward kernels.
//
// Replaces: trlx_tpu/ops/pallas_attention.py
//   - flash_fwd      <- _flash_fwd_kernel (launched by _flash_forward)
//   - flash_bwd_dq   <- _flash_bwd_dq_kernel (launched by _flash_backward)
//   - flash_bwd_dkv  <- _flash_bwd_dkv_kernel (launched by _flash_backward)
// They compute softmax(q k^T / sqrt(hd) + bias) v with the bias built
// from the raw [B, T] key mask (0 or -1e9) plus, when causal, -1e9 above
// the diagonal, and its gradients, recomputing the probabilities from
// the saved logsumexp: no [T, T] tensor is written in either direction.
//
// Layout. q, k, v, dO and O are read and written in the trunk's own
// [B, T, H, hd] layout (one head's row is hd contiguous elements), so
// the wrapper makes no transposed copy; lse and D = rowsum(dO * O) are
// float32 [B, H, T]; dq, dk, dv come out float32 [B, T, H, hd]. Inputs
// are float32 or bfloat16; all arithmetic is float32, as on the TPU.
//
// What bounds them: bytes. At the training slice (B 32, T 576, H 12,
// hd 64, bf16) the forward must move about 114 MB (~34 us at 3.35 TB/s)
// against about 18 GFLOP of live causal tiles (~18 us at 989 TF/s); the
// backward pair reads the same inputs twice more and writes float32
// gradients. These first kernels are far from either bound: they run
// the products as float32 FMA on the CUDA cores (67 TF/s peak), not on
// the tensor cores.
//
// Design. The TPU kernels stage a whole head's K/V (or Q/dO) in VMEM and
// walk a sequential grid axis; here a loop inside the block walks tiles:
//   - forward and dq: one block per (batch * head, 64-row query tile),
//     looping over 64-key tiles staged in shared memory; tiles wholly
//     above the diagonal are never visited;
//   - dk/dv: one block per (batch * head, 64-key tile), looping over
//     query tiles from the first that can see the tile;
//   - 256 threads as a 16 x 16 grid; each thread owns 4 x 4 scores
//     (rows ty + 16 i, columns tx + 16 j) and 4 rows x hd/16 columns of
//     the accumulator; row max and sum reduce over the 16 lanes of a
//     half warp by shuffles; shared rows are padded to hd + 1 floats so
//     the column walks hit distinct banks;
//   - no atomics: every output element is written by one thread of one
//     block, so results are deterministic;
//   - the ragged edge (T not a tile multiple) loads zeros with mask 0,
//     as the TPU wrapper pads; rows past T are never written;
//   - a pad query row (left padding) sees only -1e9 keys: its max stays
//     finite and l is floored at 1e-30, so it is the finite near-uniform
//     average, never NaN.
// Not done yet (later work): tensor-core products (mma / wgmma), TMA
// and double buffering of the tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// stage rows [t0, t0 + 64) of head (b, h) as float32 times `mul` into a
// [64][HD + 1] shared tile; rows past T are zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int t0, int Tlen, int H, int h,
                                          float mul) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < 64 * HD; idx += kThreads) {
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
  extern __shared__ float smem[];
  float* q_s = smem;                 // [BQ][HD + 1], scaled
  float* k_s = q_s + kBQ * LD;       // [BK][HD + 1]
  float* v_s = k_s + kBK * LD;       // [BK][HD + 1]
  float* p_s = v_s + kBK * LD;       // [BQ][BK + 1]
  float* kb_s = p_s + kBQ * PLD;     // [BK] key-mask bias

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, HD>(q_s, q, b, q0, Tlen, H, h, scale);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int n_k = (Tlen + kBK - 1) / kBK;
  const int n_live = causal ? min(n_k, (q0 + kBQ + kBK - 1) / kBK) : n_k;
  for (int jt = 0; jt < n_live; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(k_s, k, b, k0, Tlen, H, h, 1.f);
    load_tile<T, HD>(v_s, v, b, k0, Tlen, H, h, 1.f);
    load_key_bias(kb_s, mask, b, k0, Tlen);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * PLD + c];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
// backward: dq
// ------------------------------------------------------------------ //

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ dD,
                    const int32_t* __restrict__ mask, float* __restrict__ dq,
                    int Tlen, int H, int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int PLD = kBK + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // [BQ][HD + 1], scaled
  float* g_s = q_s + kBQ * LD;     // [BQ][HD + 1]
  float* k_s = g_s + kBQ * LD;     // [BK][HD + 1]
  float* v_s = k_s + kBK * LD;     // [BK][HD + 1]
  float* ds_s = v_s + kBK * LD;    // [BQ][BK + 1]
  float* kb_s = ds_s + kBQ * PLD;  // [BK]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, HD>(q_s, q, b, q0, Tlen, H, h, scale);
  load_tile<T, HD>(g_s, g, b, q0, Tlen, H, h, 1.f);
  float lse_r[4], d_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < Tlen;
    lse_r[i] = in ? lse[static_cast<size_t>(bh) * Tlen + row] : 0.f;
    d_r[i] = in ? dD[static_cast<size_t>(bh) * Tlen + row] : 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int n_k = (Tlen + kBK - 1) / kBK;
  const int n_live = causal ? min(n_k, (q0 + kBQ + kBK - 1) / kBK) : n_k;
  for (int jt = 0; jt < n_live; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();
    load_tile<T, HD>(k_s, k, b, k0, Tlen, H, h, 1.f);
    load_tile<T, HD>(v_s, v, b, k0, Tlen, H, h, 1.f);
    load_key_bias(kb_s, mask, b, k0, Tlen);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty + 16 * i) * LD + d];
        gv[i] = g_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(tx + 16 * j) * LD + d];
        vv[j] = v_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
      for (int i = 0; i < 4; ++i) {
        const float ds = ds_s[(ty + 16 * i) * PLD + c];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(ds, kv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tlen) continue;
    const size_t off = row_at<HD>(b, row, Tlen, H, h);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dq[off + tx + 16 * jj] = acc[i][jj] * scale;
  }
}

// ------------------------------------------------------------------ //
// backward: dk, dv
// ------------------------------------------------------------------ //

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ dD,
                     const int32_t* __restrict__ mask,
                     float* __restrict__ dk, float* __restrict__ dv, int Tlen,
                     int H, int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int PLD = kBQ + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;               // [BK][HD + 1]
  float* v_s = k_s + kBK * LD;     // [BK][HD + 1]
  float* q_s = v_s + kBK * LD;     // [BQ][HD + 1], scaled
  float* g_s = q_s + kBQ * LD;     // [BQ][HD + 1]
  float* p_s = g_s + kBQ * LD;     // [BK][BQ + 1]  P^T
  float* ds_s = p_s + kBK * PLD;   // [BK][BQ + 1]  dS^T
  float* lse_s = ds_s + kBK * PLD; // [BQ]
  float* d_s = lse_s + kBQ;        // [BQ]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kBK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, HD>(k_s, k, b, k0, Tlen, H, h, 1.f);
  load_tile<T, HD>(v_s, v, b, k0, Tlen, H, h, 1.f);
  float kbias[4], dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
    load_tile<T, HD>(q_s, q, b, q0, Tlen, H, h, scale);
    load_tile<T, HD>(g_s, g, b, q0, Tlen, H, h, 1.f);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const int row = q0 + r;
      const bool in = row < Tlen;
      lse_s[r] = in ? lse[static_cast<size_t>(bh) * Tlen + row] : 0.f;
      d_s[r] = in ? dD[static_cast<size_t>(bh) * Tlen + row] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = k_s[(ty + 16 * i) * LD + d];
        vv[i] = v_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = q_s[(tx + 16 * j) * LD + d];
        gv[j] = g_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
          dpt[i][j] = fmaf(gv[j], vv[i], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
      for (int i = 0; i < 4; ++i) {
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
  for (int i = 0; i < 4; ++i) {
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
// launch helpers
// ------------------------------------------------------------------ //

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * (HD + 1) +
          static_cast<size_t>(kBQ) * (kBK + 1) + kBK);
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (static_cast<size_t>(2 * kBQ + 2 * kBK) * (HD + 1) +
          static_cast<size_t>(kBQ) * (kBK + 1) + kBK);
}

template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (static_cast<size_t>(2 * kBK + 2 * kBQ) * (HD + 1) +
          2 * static_cast<size_t>(kBK) * (kBQ + 1) + 2 * kBQ);
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

template <typename T, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* lse, int B, int Tlen,
                       int H, int causal, float scale, cudaStream_t st) {
  auto kernel = flash_fwd_kernel<T, HD>;
  const size_t smem = fwd_smem<HD>();
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tlen + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(mask),
      static_cast<T*>(out), static_cast<float*>(lse), Tlen, H, causal, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* dD,
                      const void* mask, void* dq, int B, int Tlen, int H,
                      int causal, float scale, cudaStream_t st) {
  auto kernel = flash_bwd_dq_kernel<T, HD>;
  const size_t smem = dq_smem<HD>();
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tlen + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(dD),
      static_cast<const int32_t*>(mask), static_cast<float*>(dq), Tlen,
      H, causal, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* dD,
                       const void* mask, void* dk, void* dv, int B, int Tlen,
                       int H, int causal, float scale, cudaStream_t st) {
  auto kernel = flash_bwd_dkv_kernel<T, HD>;
  const size_t smem = dkv_smem<HD>();
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tlen + kBK - 1) / kBK);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(dD),
      static_cast<const int32_t*>(mask), static_cast<float*>(dk),
      static_cast<float*>(dv), Tlen, H, causal, scale);
  return cudaGetLastError();
}

bool shape_ok(int B, int T, int H, int hd, int dtype) {
  return B > 0 && T > 0 && H > 0 && (dtype == kF32 || dtype == kBF16) &&
         (hd == 16 || hd == 32 || hd == 64 || hd == 128);
}

// dispatch on (dtype, hd) to F<T, HD>::run(args...)
#define FLASH_DISPATCH(LAUNCH, ...)                                       \
  do {                                                                    \
    if (dtype == kF32) {                                                  \
      switch (hd) {                                                       \
        case 16: return static_cast<int>(LAUNCH<float, 16>(__VA_ARGS__)); \
        case 32: return static_cast<int>(LAUNCH<float, 32>(__VA_ARGS__)); \
        case 64: return static_cast<int>(LAUNCH<float, 64>(__VA_ARGS__)); \
        default: return static_cast<int>(LAUNCH<float, 128>(__VA_ARGS__));\
      }                                                                   \
    }                                                                     \
    switch (hd) {                                                         \
      case 16: return static_cast<int>(LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__));  \
      case 32: return static_cast<int>(LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__));  \
      case 64: return static_cast<int>(LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__));  \
      default: return static_cast<int>(LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__)); \
    }                                                                     \
  } while (0)

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 float32, 1 bfloat16
// (q, k, v, dO and O share it); hd one of 16, 32, 64, 128; mask int32
// [B, T]; lse and D float32 [B, H, T]; dq, dk, dv float32 [B, T, H, hd].
// Each returns cudaGetLastError() after its launch (0 = launched).
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

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* g, const void* lse, const void* dD,
                            const void* mask, void* dq, int B, int T, int H,
                            int hd, int causal, int dtype, float scale,
                            void* stream) {
  if (!shape_ok(B, T, H, hd, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, g, lse, dD, mask, dq, B, T, H, causal,
                 scale, st);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* g, const void* lse, const void* dD,
                             const void* mask, void* dk, void* dv, int B,
                             int T, int H, int hd, int causal, int dtype,
                             float scale, void* stream) {
  if (!shape_ok(B, T, H, hd, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, g, lse, dD, mask, dk, dv, B, T, H,
                 causal, scale, st);
}
