// Paged-attention DECODE kernel for Hopper (sm_90a), split-K
// flash-decoding.
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
// token and query head) is far below the card's rates. Reaching the
// byte bound takes enough loads in flight on every SM, which one block
// per (slot, kv-head) walking all of its pages in a loop cannot give.
//
// Design. The TPU kernel walks pages as a SEQUENTIAL grid axis that
// carries the running max / denominator / accumulator in VMEM scratch.
// Here the context is split instead (flash-decoding):
//   - grid (slot, kv-head x head group, partition): the wrapper picks
//     the partition count P (ops/paged_attention.py decode_partitions),
//     each partition a whole number of pages; a block serves GT of the
//     G = H / Hkv query heads of its kv-head, which share every K/V row
//     it reads (GQA);
//   - the block first loads its pages' clamped ids and scans the slot's
//     bias row: when the row has an unmasked position, pages with none
//     are skipped (their probabilities are exactly 0 in f32, so skipping
//     changes no bit); a fully masked row (a free slot) visits every
//     page and comes out as the finite uniform average, like the plain
//     version, never NaN;
//   - the 4 warps split the partition's tokens; a K or V row is read as
//     16-byte vectors (8 bf16, 16 int8 codes or 4 f32 per lane, so
//     hd * bytes / 16 lanes per row; a row of more than 32 vectors, a
//     float32 row at hd 256, gives each lane two, 32 vectors apart) and
//     its dot product with q comes
//     from shuffles among the lanes that hold it; each lane keeps a
//     running max, sum and accumulator in float32 registers for the
//     tokens of its row slot, merged across the warp by shuffles and
//     across the warps once, in shared memory, at the end;
//   - P = 1: the block writes the output, rounded once to q's dtype,
//     so the serving shape is one launch; P > 1: each block writes
//     float32 partials (m, l, acc) to scratch the wrapper allocates, and
//     a small combine kernel reads a (slot, head)'s P partials in a fixed
//     order: no atomics, so results are deterministic. A partition with
//     no live page contributes l = 0.
// Exponentials are exp2f with log2(e); running maxima start at -1e30,
// finite and below any biased score. Not done yet: TMA, and overlapping
// one iteration's loads with the previous iteration's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskedBelow = -5e8f;  // bias <= this counts as masked
constexpr float kMaxInit = -1e30f;     // finite, below any biased score
constexpr float kLog2e = 1.4426950408889634f;

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

template <int KV>
__host__ __device__ constexpr int elem_bytes() {
  return KV == kF32 ? 4 : (KV == kBF16 ? 2 : 1);
}

// 16 bytes of one K/V row as float into x[0 .. 16 / bytes): float32 as
// is, bf16 widened, int8 codes times the row scale rounded to q's dtype
// QT first
template <typename QT, int KV>
__device__ __forceinline__ void widen(const uint4& raw, float sc, float* x) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (KV == kF32) {
      x[i] = __uint_as_float(w[i]);
    } else if constexpr (KV == kBF16) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c = static_cast<float>(
            static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
        x[4 * i + j] = to_f32<QT>(from_f32<QT>(c * sc));
      }
    }
  }
}

// 16-byte vectors of a row of HD elements a lane holds: 1, or more once
// the row has more than 32
template <int KV, int HD>
__host__ __device__ constexpr int chunks_per_lane() {
  constexpr int ch = HD * elem_bytes<KV>() / 16;
  return ch > 32 ? ch / 32 : 1;
}

// Rows a lane loads per iteration (U) for a row of HD elements: aim for
// 16 tokens per warp iteration, at most 4 16-byte K vectors in flight
// per lane.
template <int KV, int HD>
__host__ __device__ constexpr int loads_per_lane() {
  constexpr int cpl = chunks_per_lane<KV, HD>();
  constexpr int lpr = HD * elem_bytes<KV>() / 16 / cpl;
  constexpr int rpw = 32 / lpr;
  constexpr int u = rpw >= 16 ? 1 : (16 / rpw > 4 ? 4 : 16 / rpw);
  return u * cpl > 4 ? 4 / cpl : u;
}

// one block per (slot, kv-head x head group, partition); module comment
template <typename QT, int KV, int HD, int GT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q,
                    const unsigned char* __restrict__ k_pool,
                    const unsigned char* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ page_table,
                    const float* __restrict__ bias, QT* __restrict__ out,
                    float* __restrict__ part, int H, int Hkv, int num_pages,
                    int page_size, int max_pages, int pages_per,
                    float scale) {
  constexpr int EB = elem_bytes<KV>();
  constexpr int E16 = 16 / EB;     // elements of a 16-byte vector
  constexpr int CPL = chunks_per_lane<KV, HD>();  // vectors a lane holds
  constexpr int VEC = CPL * E16;   // elements a lane holds of a row
  constexpr int LPR = HD / VEC;    // lanes per row
  constexpr int RPW = 32 / LPR;    // rows per warp load
  constexpr int U = loads_per_lane<KV, HD>();
  constexpr int TPI = RPW * U;     // tokens per warp iteration
  constexpr int RED = HD + 2;      // m, l, acc[HD]
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row split");
  // a lane's element i lies in vector cc + (i / E16) LPR of its row

  const int s = blockIdx.x;
  const int G = H / Hkv;
  const int n_gt = G / GT;
  const int kvh = blockIdx.y / n_gt;
  const int h0 = kvh * G + (blockIdx.y - kvh * n_gt) * GT;
  const int T = max_pages * page_size;
  const int pg0 = blockIdx.z * pages_per;
  const int n_pg = min(pages_per, max_pages - pg0);
  const int t0 = pg0 * page_size;
  const int t1 = t0 + n_pg * page_size;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                          // [GT][HD]
  float* red_s = q_s + GT * HD;               // [kWarps][GT][HD + 2]
  int* pid_s = reinterpret_cast<int*>(red_s + kWarps * GT * RED);  // [n_pg]
  int* live_s = pid_s + pages_per;            // [n_pg]

  for (int i = tid; i < n_pg; i += kThreads) live_s[i] = 0;
  __syncthreads();

  // q, the partition's clamped page ids, and the bias row's live pages
  const size_t q_row = (static_cast<size_t>(s) * H + h0) * HD;
  for (int i = tid; i < GT * HD; i += kThreads) q_s[i] = to_f32<QT>(q[q_row + i]);
  const int32_t* pt_row = page_table + static_cast<size_t>(s) * max_pages + pg0;
  for (int i = tid; i < n_pg; i += kThreads) {
    long long pid = pt_row[i];
    pid = pid < 0 ? 0 : (pid >= num_pages ? num_pages - 1 : pid);
    pid_s[i] = static_cast<int>(pid);
  }
  const float* bias_row = bias + static_cast<size_t>(s) * T;
  int any_live = 0;
  for (int i = tid; i < T; i += kThreads) {
    if (bias_row[i] > kMaskedBelow) {
      any_live = 1;
      if (i >= t0 && i < t1) live_s[(i - t0) / page_size] = 1;
    }
  }
  const int row_live = __syncthreads_or(any_live);

  const int warp = tid >> 5, lane = tid & 31;
  const int rr = lane / LPR;        // row of a warp load
  const int cc = lane - rr * LPR;   // first 16-byte column of that row
  float qr[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qr[g][e] = q_s[g * HD + (cc + (e / E16) * LPR) * E16 + e % E16];
  float m[GT], l[GT], acc[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kMaxInit;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const size_t row_bytes = static_cast<size_t>(HD) * EB;
  for (int base = t0 + warp * TPI; base < t1; base += kWarps * TPI) {
    uint4 kr[U][CPL], vr[U][CPL];
    float bu[U], ks[U], vs[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * RPW + rr;
      const int pi = (t - t0) / page_size;
      ok[u] = t < t1 && (!row_live || live_s[pi]);
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        kr[u][j] = vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
      bu[u] = 0.f;
      ks[u] = vs[u] = 1.f;
      if (ok[u]) {
        const size_t row =
            (static_cast<size_t>(pid_s[pi]) * page_size +
             (t - (pg0 + pi) * page_size)) * Hkv + kvh;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const size_t off = row * row_bytes + (cc + j * LPR) * 16;
          kr[u][j] = __ldg(reinterpret_cast<const uint4*>(k_pool + off));
          vr[u][j] = __ldg(reinterpret_cast<const uint4*>(v_pool + off));
        }
        bu[u] = bias_row[t];
        if constexpr (KV == kInt8) {
          ks[u] = k_scale[row];
          vs[u] = v_scale[row];
        }
      }
    }

    // scores: a row's dot product from the LPR lanes that hold it
    float x[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
#pragma unroll
      for (int j = 0; j < CPL; ++j) widen<QT, KV>(kr[u][j], ks[u], kf + j * E16);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        x[u][g] = ok[u] ? fmaf(d, scale, bu[u]) : -INFINITY;
      }
    }

    // online softmax of this lane's row slot over its U tokens
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mn = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mn = fmaxf(mn, x[u][g]);
      const float a = exp2f((m[g] - mn) * kLog2e);
      m[g] = mn;
      l[g] *= a;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= a;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f((x[u][g] - mn) * kLog2e);  // 0 if skipped
        x[u][g] = p;
        l[g] += p;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
#pragma unroll
      for (int j = 0; j < CPL; ++j) widen<QT, KV>(vr[u][j], vs[u], vf + j * E16);
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] = fmaf(x[u][g], vf[e], acc[g][e]);
    }
  }

  // merge the warp's row slots (lanes LPR apart hold the same columns)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float a = exp2f((m[g] - mn) * kLog2e);
      const float b = exp2f((mo - mn) * kLog2e);
      l[g] = l[g] * a + lo * b;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] = acc[g][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[g][e], o) * b;
      m[g] = mn;
    }
  if (rr == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float* red = red_s + (warp * GT + g) * RED;
      if (cc == 0) {
        red[0] = m[g];
        red[1] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        red[2 + (cc + (e / E16) * LPR) * E16 + e % E16] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps: the output (P = 1) or this partition's partials
  const int P = gridDim.z;
  for (int i = tid; i < GT * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i - g * HD;
    float M = kMaxInit;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      M = fmaxf(M, red_s[(w * GT + g) * RED]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* red = red_s + (w * GT + g) * RED;
      const float f = exp2f((red[0] - M) * kLog2e);
      L = fmaf(red[1], f, L);
      A = fmaf(red[2 + d], f, A);
    }
    if (P == 1) {
      out[q_row + i] = from_f32<QT>(A / fmaxf(L, 1e-30f));
    } else {
      float* pp = part + ((static_cast<size_t>(s) * H + h0 + g) * P +
                          blockIdx.z) * RED;
      if (d == 0) {
        pp[0] = M;
        pp[1] = L;
      }
      pp[2 + d] = A;
    }
  }
}

// one block per (slot, head): the P partials merged in partition order
template <typename QT>
__global__ void paged_decode_combine_kernel(const float* __restrict__ part,
                                            QT* __restrict__ out, int P,
                                            int HD) {
  const int RED = HD + 2;
  const float* pp = part + static_cast<size_t>(blockIdx.x) * P * RED;
  float M = kMaxInit;
  for (int p = 0; p < P; ++p) M = fmaxf(M, pp[p * RED]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int p = 0; p < P; ++p) {
      const float f = exp2f((pp[p * RED] - M) * kLog2e);
      L = fmaf(pp[p * RED + 1], f, L);
      A = fmaf(pp[p * RED + 2 + d], f, A);
    }
    out[static_cast<size_t>(blockIdx.x) * HD + d] =
        from_f32<QT>(A / fmaxf(L, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *page_table, *bias;
  void *out, *part;
  int S, H, Hkv, hd, num_pages, page_size, max_pages, partitions;
  float scale;
  cudaStream_t stream;
};

template <typename QT, int KV, int HD, int GT>
cudaError_t launch(const Args& a) {
  const int pages_per = (a.max_pages + a.partitions - 1) / a.partitions;
  const size_t smem = sizeof(float) * (GT * HD + kWarps * GT * (HD + 2)) +
                      sizeof(int) * 2 * static_cast<size_t>(pages_per);
  auto kernel = paged_decode_kernel<QT, KV, HD, GT>;
  // raised only when a larger block needs it, so launches can be captured
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  dim3 grid(a.S, a.Hkv * (a.H / a.Hkv / GT), a.partitions);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const unsigned char*>(a.k),
      static_cast<const unsigned char*>(a.v),
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int32_t*>(a.page_table),
      static_cast<const float*>(a.bias), static_cast<QT*>(a.out),
      static_cast<float*>(a.part), a.H, a.Hkv, a.num_pages, a.page_size,
      a.max_pages, pages_per, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.partitions == 1) return err;
  paged_decode_combine_kernel<QT><<<a.S * a.H, a.hd, 0, a.stream>>>(
      static_cast<const float*>(a.part), static_cast<QT*>(a.out),
      a.partitions, a.hd);
  return cudaGetLastError();
}

// the head group GT: 4, 2 or 1 query heads of a kv-head per block
template <typename QT, int KV, int HD>
cudaError_t launch_gt(const Args& a) {
  const int G = a.H / a.Hkv;
  if (G % 4 == 0) return launch<QT, KV, HD, 4>(a);
  if (G % 2 == 0) return launch<QT, KV, HD, 2>(a);
  return launch<QT, KV, HD, 1>(a);
}

template <typename QT, int KV>
cudaError_t launch_hd(const Args& a) {
  switch (a.hd) {
    case 16: return launch_gt<QT, KV, 16>(a);
    case 32: return launch_gt<QT, KV, 32>(a);
    case 64: return launch_gt<QT, KV, 64>(a);
    case 128: return launch_gt<QT, KV, 128>(a);
    default: return launch_gt<QT, KV, 256>(a);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype codes: 0 float32,
// 1 bfloat16, 2 int8 (kv only, with k_scale/v_scale). Supported:
// q bf16 with a bf16 or int8 pool; q f32 with an f32, bf16 or int8 pool;
// hd one of 16, 32, 64, 128, 256; q and the pools start 16-byte aligned.
// ``partitions`` splits the max_pages pages into parts of
// ceil(max_pages / partitions) pages, none empty; above 1, ``partials``
// is float32 scratch of S * H * partitions * (hd + 2). Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* bias, void* out,
    void* partials, int S, int H, int Hkv, int hd, int num_pages,
    int page_size, int max_pages, int partitions, int q_dtype, int kv_dtype,
    float scale, void* stream) {
  if (S <= 0 || Hkv <= 0 || H % Hkv != 0 || num_pages <= 0 ||
      page_size <= 0 || max_pages <= 0 || partitions <= 0 ||
      partitions > max_pages)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pages_per = (max_pages + partitions - 1) / partitions;
  if ((partitions - 1) * pages_per >= max_pages ||
      (partitions > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, k_scale, v_scale, page_table, bias, out, partials,
               S, H, Hkv, hd, num_pages, page_size, max_pages, partitions,
               scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return static_cast<int>(launch_hd<__nv_bfloat16, kBF16>(a));
  if (q_dtype == kBF16 && kv_dtype == kInt8)
    return static_cast<int>(launch_hd<__nv_bfloat16, kInt8>(a));
  if (q_dtype == kF32 && kv_dtype == kF32)
    return static_cast<int>(launch_hd<float, kF32>(a));
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return static_cast<int>(launch_hd<float, kBF16>(a));
  if (q_dtype == kF32 && kv_dtype == kInt8)
    return static_cast<int>(launch_hd<float, kInt8>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}
