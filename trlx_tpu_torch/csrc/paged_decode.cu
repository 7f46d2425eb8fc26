// Paged-attention DECODE kernel for Hopper (sm_90a).
//
// Replaces: trlx_tpu/ops/paged_attention.py::_decode_kernel (Pallas TPU,
// launched by paged_decode_attention and make_paged_decode_fn). It
// computes one decode step of paged attention: for every slot s and
// query head, softmax(q . K^T * rsqrt(hd) + bias) . V over the slot's
// logical context, whose KV lives in fixed-size pages of a global pool
// named by page_table[s, :]. Page ids >= num_pages are the host
// allocator's sentinel (2**30); they clamp into [0, num_pages) before
// any address math (64-bit offsets throughout) and their positions
// carry the finite -1e9 bias, so they add exactly zero probability.
// The int8 tier stores codes + one f32 scale per (token, kv-head) and
// is dequantized here, as the TPU kernel does, to q's dtype.
//
// What bounds it: bytes. At the serving shape (16 slots x 12 kv-heads
// x 64 dims, 4 pages of 16 tokens, bf16) one layer's step reads about
// 3.1 MB of K/V, ~0.94 us at 3.35 TB/s; a full 1024-token context over
// 16 slots reads ~50 MB, ~15 us. The arithmetic (4 * hd flops per
// token and query head) is far below the card's rates.
//
// Design. The TPU kernel walks pages as a SEQUENTIAL grid axis that
// carries the running max / denominator / accumulator in VMEM scratch.
// Blocks on Hopper run in no order, so that axis becomes a loop inside
// the block:
//   - one thread block per (slot, kv-head);
//   - the block first scans the slot's bias row and marks which pages
//     hold any unmasked position; when the row has one, pages with none
//     are skipped (their probabilities underflow to exactly 0 in f32,
//     so skipping changes no bit) — the block reads only the pages the
//     slot really uses, which is what the byte bound counts;
//   - each K/V page tile is staged ONCE in shared memory (coalesced:
//     consecutive threads read consecutive head dims) and shared by the
//     G = H / Hkv query heads of the group (GQA);
//   - running max, denominator and accumulator are float32; all
//     arithmetic is float32, the output is rounded to q's dtype once.
// A fully masked row (a free slot) visits every page and comes out as
// the finite uniform average, like the plain version, never NaN: the
// running max starts at 2 * -1e9 and the denominator is floored at
// 1e-30. Not done yet (later work): wgmma, TMA, split-K across pages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;  // tokens staged per shared-memory tile
constexpr float kNegInf = -1e9f;
constexpr float kMaskedBelow = -5e8f;  // bias <= this counts as masked

enum DType { kF32 = 0, kBF16 = 1, kInt8 = 2 };

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

// one K/V element as float, from a pool of type KV (float, bf16, or int8
// codes times the row scale, rounded to q's dtype QT first)
template <typename QT, int KV>
__device__ __forceinline__ float load_kv(const void* pool, const float* scales,
                                         size_t elem, size_t row) {
  if (KV == kF32) return static_cast<const float*>(pool)[elem];
  if (KV == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(pool)[elem]);
  const float x = static_cast<float>(static_cast<const int8_t*>(pool)[elem]) *
                  scales[row];
  return to_f32<QT>(from_f32<QT>(x));
}

template <typename QT, int KV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const void* __restrict__ k_pool,
                    const void* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ page_table,
                    const float* __restrict__ bias, QT* __restrict__ out,
                    int H, int Hkv, int hd, int num_pages, int page_size,
                    int max_pages, float scale) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int G = H / Hkv;
  const int T = max_pages * page_size;
  const int ld = hd + 1;  // padded K/V row: no bank conflicts across t

  extern __shared__ float smem[];
  float* q_s = smem;                  // [G][hd]
  float* acc_s = q_s + G * hd;        // [G][hd]
  float* k_s = acc_s + G * hd;        // [kChunk][hd + 1]
  float* v_s = k_s + kChunk * ld;     // [kChunk][hd + 1]
  float* p_s = v_s + kChunk * ld;     // [G][kChunk] scores, then probs
  float* m_s = p_s + G * kChunk;      // [G] running max
  float* l_s = m_s + G;               // [G] running denominator
  float* a_s = l_s + G;               // [G] rescale factor of this tile
  int* live_s = reinterpret_cast<int*>(a_s + G);  // [max_pages]

  const size_t q_row = (static_cast<size_t>(s) * H + static_cast<size_t>(h) * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = to_f32<QT>(q[q_row + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = 2.f * kNegInf;
    l_s[g] = 0.f;
  }
  for (int p = tid; p < max_pages; p += kThreads) live_s[p] = 0;
  __syncthreads();

  const float* bias_row = bias + static_cast<size_t>(s) * T;
  int any_live = 0;
  for (int i = tid; i < T; i += kThreads) {
    if (bias_row[i] > kMaskedBelow) {
      live_s[i / page_size] = 1;
      any_live = 1;
    }
  }
  const int row_live = __syncthreads_or(any_live);

  for (int p = 0; p < max_pages; ++p) {
    if (row_live && !live_s[p]) continue;  // block-uniform branch
    long long pid = page_table[static_cast<size_t>(s) * max_pages + p];
    pid = pid < 0 ? 0 : (pid >= num_pages ? num_pages - 1 : pid);
    for (int c0 = 0; c0 < page_size; c0 += kChunk) {
      const int n = min(kChunk, page_size - c0);
      for (int i = tid; i < n * hd; i += kThreads) {
        const int t = i / hd;
        const int d = i - t * hd;
        const size_t row =
            (static_cast<size_t>(pid) * page_size + c0 + t) * Hkv + h;
        const size_t elem = row * hd + d;
        k_s[t * ld + d] = load_kv<QT, KV>(k_pool, k_scale, elem, row);
        v_s[t * ld + d] = load_kv<QT, KV>(v_pool, v_scale, elem, row);
      }
      __syncthreads();
      for (int i = tid; i < G * n; i += kThreads) {
        const int g = i / n;
        const int t = i - g * n;
        const float* qg = q_s + g * hd;
        const float* kt = k_s + t * ld;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qg[d] * kt[d];
        p_s[g * kChunk + t] = dot * scale + bias_row[p * page_size + c0 + t];
      }
      __syncthreads();
      for (int g = tid; g < G; g += kThreads) {
        float* pg = p_s + g * kChunk;
        const float m_prev = m_s[g];
        float m_new = m_prev;
        for (int t = 0; t < n; ++t) m_new = fmaxf(m_new, pg[t]);
        const float alpha = expf(m_prev - m_new);
        float sum = 0.f;
        for (int t = 0; t < n; ++t) {
          const float e = expf(pg[t] - m_new);
          pg[t] = e;
          sum += e;
        }
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
      __syncthreads();
      for (int i = tid; i < G * hd; i += kThreads) {
        const int g = i / hd;
        const int d = i - g * hd;
        const float* pg = p_s + g * kChunk;
        float o = acc_s[i] * a_s[g];
        for (int t = 0; t < n; ++t) o += pg[t] * v_s[t * ld + d];
        acc_s[i] = o;
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    out[q_row + i] = from_f32<QT>(acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename QT, int KV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* page_table, const void* bias, void* out, int S,
                   int H, int Hkv, int hd, int num_pages, int page_size,
                   int max_pages, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t floats = 2 * static_cast<size_t>(G) * hd +
                        2 * static_cast<size_t>(kChunk) * (hd + 1) +
                        static_cast<size_t>(G) * kChunk + 3 * G;
  const size_t smem = floats * sizeof(float) + max_pages * sizeof(int);
  auto kernel = paged_decode_kernel<QT, KV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(S, Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(page_table), static_cast<const float*>(bias),
      static_cast<QT*>(out), H, Hkv, hd, num_pages, page_size, max_pages,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype codes: 0 float32,
// 1 bfloat16, 2 int8 (kv only, with k_scale/v_scale). Supported:
// q bf16 with a bf16 or int8 pool; q f32 with an f32, bf16 or int8 pool.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* bias, void* out,
    int S, int H, int Hkv, int hd, int num_pages, int page_size, int max_pages,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || Hkv <= 0 || H % Hkv != 0 || hd <= 0 || num_pages <= 0 ||
      page_size <= 0 || max_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch<__nv_bfloat16, kBF16>(q, k, v, k_scale, v_scale, page_table,
                                        bias, out, S, H, Hkv, hd, num_pages,
                                        page_size, max_pages, scale, st);
  if (q_dtype == kBF16 && kv_dtype == kInt8)
    return launch<__nv_bfloat16, kInt8>(q, k, v, k_scale, v_scale, page_table,
                                        bias, out, S, H, Hkv, hd, num_pages,
                                        page_size, max_pages, scale, st);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch<float, kF32>(q, k, v, k_scale, v_scale, page_table, bias,
                               out, S, H, Hkv, hd, num_pages, page_size,
                               max_pages, scale, st);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return launch<float, kBF16>(q, k, v, k_scale, v_scale, page_table, bias,
                                out, S, H, Hkv, hd, num_pages, page_size,
                                max_pages, scale, st);
  if (q_dtype == kF32 && kv_dtype == kInt8)
    return launch<float, kInt8>(q, k, v, k_scale, v_scale, page_table, bias,
                                out, S, H, Hkv, hd, num_pages, page_size,
                                max_pages, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
