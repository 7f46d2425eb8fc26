// Flash attention for training on Hopper (sm_90a), float32 inputs: the
// forward and the backward on the CUDA cores. The bfloat16 forward (the
// training path's) is flash_forward.cu and the bfloat16 backward
// flash_backward.cu: wgmma tiles fed by TMA.
//
// Replaces, for float32 inputs: trlx_tpu/ops/pallas_attention.py
//   - flash_fwd_f32      <- _flash_fwd_kernel (launched by _flash_forward)
//   - flash_bwd_dq_f32   <- _flash_bwd_dq_kernel and the jnp line for D
//     before it (launched by _flash_backward)
//   - flash_bwd_dkv_f32  <- _flash_bwd_dkv_kernel
// They compute softmax(q k^T / sqrt(hd) + bias) v with the bias built
// from the raw [B, T] key mask (0 or -1e9) plus, when causal, -1e9 above
// the diagonal, and its gradients, recomputing the probabilities from
// the saved logsumexp: no [T, T] tensor is written in either direction.
//
// Layout. q, k, v, dO and O are read and written in the trunk's own
// [B, T, H, hd] layout (one head's row is hd contiguous elements), so
// the wrapper makes no transposed copy; lse and D = rowsum(dO * O) are
// float32 [B, H, T].
//
// What bounds them: the float32 FMA rate of the CUDA cores (67 TF/s
// peak). They stay there on purpose: the tensor cores would round their
// operands to TF32, which misses the float32 parity (1e-5 on O and lse,
// 2e-4 on the gradients against the dense oracle, and the fp32 train
// step).
//
// Common to all three kernels:
//   - forward and dq: one block per (batch * head, query tile), looping
//     over 64-key tiles staged in shared memory; tiles wholly above the
//     diagonal are never visited; dk/dv: one block per (batch * head, key
//     tile), looping over 64-row query tiles from the first that can see
//     the tile;
//   - 256 threads as a 16 x 16 grid, each owning 4 x 4 scores, [rows][hd
//     + 1] float tiles; a block owns 64 query (or key) rows, or 32 at hd
//     256 (fma_rows), where four 64-row [257]-float tiles would not fit;
//   - no atomics: every output element is written by one thread of one
//     block, so results are deterministic;
//   - the ragged edge (T not a tile multiple) loads zeros with mask 0,
//     as the TPU wrapper pads; rows past T are never written;
//   - a pad query row (left padding) sees only -1e9 keys: its max stays
//     finite and l is floored at 1e-30, so it is the finite near-uniform
//     average, never NaN.
// The dq kernel first computes D for its rows (a warp a row over the
// staged dO tile and O's rows), writes it for dk/dv and keeps it in
// registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr float kNegInf = -1e9f;

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

// rows of the block's own tile (query rows in the forward and dq, key
// rows in dk/dv): 64, or 32 at HD 256, where four [64][HD + 1] float
// tiles would pass the 227 KB a block may use
template <int HD>
__host__ __device__ constexpr int fma_rows() { return HD > 128 ? 32 : 64; }

// stage rows [t0, t0 + ROWS) of head (b, h) as float32 times `mul` into a
// [ROWS][HD + 1] shared tile; rows past T are zeros
template <int HD, int ROWS = 64>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b,
                                          int t0, int Tlen, int H, int h,
                                          float mul) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    const int t = t0 + r;
    float x = 0.f;
    if (t < Tlen) x = src[row_at<HD>(b, t, Tlen, H, h) + d] * mul;
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int32_t* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse, int Tlen,
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

  load_tile<HD, BQ>(q_s, q, b, q0, Tlen, H, h, scale);

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
    load_tile<HD>(k_s, k, b, k0, Tlen, H, h, 1.f);
    load_tile<HD>(v_s, v, b, k0, Tlen, H, h, 1.f);
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
      out[off + tx + 16 * jj] = acc[i][jj] / l_safe;
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

  load_tile<HD, BQ>(q_s, q, b, q0, Tlen, H, h, scale);
  load_tile<HD, BQ>(g_s, g, b, q0, Tlen, H, h, 1.f);
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
    load_tile<HD>(k_s, k, b, k0, Tlen, H, h, 1.f);
    load_tile<HD>(v_s, v, b, k0, Tlen, H, h, 1.f);
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

  load_tile<HD, BK>(k_s, k, b, k0, Tlen, H, h, 1.f);
  load_tile<HD, BK>(v_s, v, b, k0, Tlen, H, h, 1.f);
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
    load_tile<HD>(q_s, q, b, q0, Tlen, H, h, scale);
    load_tile<HD>(g_s, g, b, q0, Tlen, H, h, 1.f);
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
// launch helpers
// ------------------------------------------------------------------ //

// forward: [HD + 1]-float rows of the Q tile (fma_rows), K and
// V (64 each), the score tile and the key-mask bias
template <int HD>
constexpr size_t fwd_fma_smem() {
  constexpr size_t R = fma_rows<HD>();
  return sizeof(float) *
         ((R + 2 * kBK) * (HD + 1) + R * (kBK + 1) + kBK);
}

// backward: [HD + 1]-float rows of the block's own two tiles
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

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* lse, int B, int Tlen,
                       int H, int causal, float scale, cudaStream_t st) {
  auto kernel = flash_fwd_kernel<HD>;
  const size_t smem = fwd_fma_smem<HD>();
  static bool smem_set = false;
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tlen + fma_rows<HD>() - 1) / fma_rows<HD>());
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(mask),
      static_cast<float*>(out), static_cast<float*>(lse), Tlen, H, causal,
      scale);
  return cudaGetLastError();
}

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

bool shape_ok(int B, int T, int H, int hd) {
  return B > 0 && T > 0 && H > 0 &&
         (hd == 16 || hd == 32 || hd == 64 || hd == 128 || hd == 256);
}

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

// Plain C entry points (bound with ctypes), float32 only: flash_fwd_f32
// writes O and lse; flash_bwd_dq_f32 writes dq and D = rowsum(dO * O),
// which flash_bwd_dkv_f32 reads. hd one of 16, 32, 64, 128, 256; q, k, v,
// dO, O and the gradients float32 [B, T, H, hd]; mask int32 [B, T]; lse
// and D float32 [B, H, T]; every tensor contiguous. Each returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             const void* mask, void* out, void* lse, int B,
                             int T, int H, int hd, int causal, float scale,
                             void* stream) {
  if (!shape_ok(B, T, H, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  F32_DISPATCH(launch_fwd, q, k, v, mask, out, lse, B, T, H, causal, scale,
               st);
}

extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* g, const void* o, const void* lse,
                                const void* mask, void* dq, void* dD, int B,
                                int T, int H, int hd, int causal, float scale,
                                void* stream) {
  if (!shape_ok(B, T, H, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  F32_DISPATCH(launch_dq, q, k, v, g, o, lse, mask, dq, dD, B, T, H, causal,
               scale, st);
}

extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* dD, const void* mask, void* dk,
                                 void* dv, int B, int T, int H, int hd,
                                 int causal, float scale, void* stream) {
  if (!shape_ok(B, T, H, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  F32_DISPATCH(launch_dkv, q, k, v, g, lse, dD, mask, dk, dv, B, T, H,
               causal, scale, st);
}
