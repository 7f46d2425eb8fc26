// Paged-attention DECODE kernel for Hopper (sm_90a): pages streamed by
// TMA through an mbarrier ring by a producer warp, and the split-K merge
// inside a thread-block cluster, one launch at every shape.
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
// What bounds it: bytes, and at serving contexts the latency of the
// first ones. At the serving shape (16 slots x 12 kv-heads x 64 dims, 4
// pages of 16 tokens, bf16) one layer's step reads about 3.2 MB of K/V,
// ~0.95 us at 3.35 TB/s; a full 1024-token context over 16 slots reads
// ~50 MB, ~15 us. The arithmetic (4 * hd flops per token and query head,
// about 2 a byte) stays on the CUDA cores.
//
// Design. One block per (slot, kv-head x head group, partition): the
// wrapper cuts the slot's pages into P partitions of whole pages (P <= 8,
// ops/paged_attention.py decode_partitions), and the P blocks of one
// (slot, head group) form a thread-block cluster of dims (1, 1, P). A
// block serves GT of the G = H / Hkv query heads of its kv-head, which
// share every K/V row it reads (GQA). It runs four consumer warps and one
// producer warp, which streams the partition's pages through a ring of
// stages in shared memory: a page's page_size rows of this kv-head are
// one TMA box {hd, 1, page_size} of the pool viewed as [num_pages *
// page_size, Hkv, hd] for K and one for V (tensor maps built on the host
// at each launch and passed by value, so a captured launch keeps its
// own), completing on the stage's full mbarrier by transaction count; int8 scales travel in the
// same stage by 4-byte cp.async that the barrier also waits for (a scale
// row's stride, Hkv * 4 bytes, is no TMA stride at Hkv 3 or 6), and so do
// the page's bias words in the direct ring below. The ring's depth is the launch's
// (ring_stages): every page of the partition where the SM's shared
// memory holds that for all the blocks it runs at once. Then
//   - (direct) the producer issues each page into its own stage as soon
//     as the page ids have landed, one lane a page, with no other step
//     before: the serving contexts, where latency is what costs. Pages
//     with no live position are read and add exactly nothing (their
//     scores carry the -1e9 bias, so once the row's running max is a
//     live score their share underflows to 0); a free row comes out as
//     the finite uniform average;
//   - (compact, where the ring wraps) the producer first loads the
//     partition's page ids and bias words together, keeps the bias words
//     in shared memory for the consumers and marks the pages with a live
//     position; a partition with none learns through the
//     cluster whether any partition of the row has one: then it uses no
//     page (its share is exactly 0), else the row is free and every page
//     is used. It compacts the used pages once and streams them, waiting
//     on each stage's empty mbarrier before it reuses it. A finished
//     slot's row of sentinels reads the last page again and again;
//   - a page's rows are cut into units of a warp's round (RowSplit: up to
//     4 rows a lane, at most 16 a round), and the units of ring stage st
//     go to consumer warps (st upp + c) mod 4 in turn: at hd 64 a page of
//     16 is one warp's and the warps take stages in turn, at hd 256 each
//     warp takes 4 of every page's rows. So each stage always has the
//     same warps, which wait for every one of its phases in order (a warp
//     that skipped a phase could not tell the next from the one after by
//     parity). A lane holds 16 bytes (or two 16-byte vectors, 32 apart,
//     of a float32 row at hd 256) of a row, the row's dot product with q
//     comes from shuffles among its lanes, and each lane keeps a running
//     max, sum and accumulator in float32 registers for its row slot
//     (exp2f with log2(e); maxima start at -1e30, finite and below any
//     biased score); each warp that took part hands the stage back on its
//     empty mbarrier;
//   - the block merges its warps' (m, l, acc) in shared memory. With
//     P = 1 that is the output, rounded once to q's dtype. With P > 1,
//     after a cluster barrier, each block merges an equal share of the
//     output's columns from every partition's shared memory
//     (distributed shared memory), in partition order, and writes them
//     once: no atomics, deterministic.
// Measured and left out (NVIDIA H100 80GB HBM3 at 700 W; PERF.md): a
// programmatic dependent launch, the prologue under the kernel before it
// (tools/paged_decode_ablation.py's "with PDL": slower at every timed
// shape after the serve step's scatter into the pool, a plain launch);
// TMA prefetches warming L2 a ring ahead; one cp.async.bulk a row in
// place of a TMA box a page (both slower at the serving shapes in the
// runs that tried them); a prefetch of the tensor maps at the producer's
// start (no change at any timed shape).

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the producer warp
constexpr int kMaxPartitions = 8;  // the portable cluster size
constexpr int kMaxStages = 16;  // at most 32: a direct ring is a lane a page
constexpr int kPidWords = 2;    // page ids a producer lane loads up front
constexpr int kBiasWords = 16;  // bias words a producer lane loads up front
constexpr float kMaskedBelow = -5e8f;  // bias <= this counts as masked
constexpr float kMaxInit = -1e30f;     // finite, below any biased score

enum DType { kF32 = 0, kBF16 = 1, kInt8 = 2 };

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int elem_bytes(int kv) {
  return kv == kF32 ? 4 : (kv == kBF16 ? 2 : 1);
}

// How a warp reads K/V rows of HD elements: each lane 16 bytes (CPL
// vectors once a row has more than 32), LPR lanes a row, RPW rows a warp
// load, U rows a lane in one round (up to 4 vectors of K in flight a
// lane, and a round of no more than 16 rows, a page of the serve path),
// so UNIT = RPW U rows a warp's round.
template <int KV, int HD>
struct RowSplit {
  static constexpr int ROW = HD * elem_bytes(KV);  // bytes of a row
  static constexpr int E16 = 16 / elem_bytes(KV);  // elements of a vector
  static constexpr int CH = ROW / 16;              // vectors of a row
  static constexpr int CPL = CH > 32 ? CH / 32 : 1;
  static constexpr int VEC = CPL * E16;  // elements a lane holds
  static constexpr int LPR = CH / CPL;
  static constexpr int RPW = 32 / LPR;
  static constexpr int U0 = 16 / RPW < 4 / CPL ? 16 / RPW : 4 / CPL;
  static constexpr int U = U0 < 1 ? 1 : U0;
  static constexpr int UNIT = RPW * U;
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row split");
};

__host__ __device__ constexpr int up16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int up128(int x) { return (x + 127) & ~127; }

// Byte offsets in a block's dynamic shared memory: full[stages] and
// empty[stages] mbarriers, the partition's live flag and used-page count,
// a word a page twice (its clamped id and live flag, then the used pages'
// first pool rows and first bias words), the partition's bias words (the
// compact ring's), each consumer warp's (m, l, acc) per head, the block's
// merged (m, l, acc) per head, and the ring (from the next 128-byte
// boundary of the shared window, which the last 128 bytes leave room
// for): a stage is one page's K rows, its V rows (from `vrows`), each box
// 128-byte aligned as TMA writes it, then its bias words (from `words`,
// the direct ring's) and, for int8, its rows' K and V scales.
struct Layout {
  int flag, rows, toks, bias, red, part, ring, vrows, words, stage, total;
};

__host__ __device__ inline Layout layout(int gt, int hd, int row, int ps,
                                         int per, int stages, bool scales) {
  Layout o{};
  o.flag = 16 * stages;
  o.rows = o.flag + 16;
  o.toks = o.rows + 4 * per;
  o.bias = o.toks + 4 * per;
  o.red = up16(o.bias + 4 * per * ps);
  o.part = o.red + 4 * kConsumerWarps * gt * (hd + 2);
  o.ring = up16(o.part + 4 * gt * (hd + 2));
  o.vrows = up128(ps * row);
  o.words = 2 * o.vrows;
  o.stage = up128(o.words + 4 * ps * (scales ? 3 : 1));
  o.total = o.ring + stages * o.stage + 128;
  return o;
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
      // a code plus 128 as the low byte of 2^23 is 2^23 + 128 + code
      const uint32_t biased = w[i] ^ 0x80808080u;
      float c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + j)) -
               8388736.f;
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        if constexpr (sizeof(QT) == 4) {
          x[4 * i + j] = c[j] * sc;
          x[4 * i + j + 1] = c[j + 1] * sc;
        } else {  // rounded to bf16 two at a time
          const __nv_bfloat162 h = __floats2bfloat162_rn(c[j] * sc,
                                                         c[j + 1] * sc);
          const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
          x[4 * i + j] = __uint_as_float(u << 16);
          x[4 * i + j + 1] = __uint_as_float(u & 0xffff0000u);
        }
      }
    }
  }
}

// N consecutive elements of q (16-byte aligned) as float
template <typename QT, int N>
__device__ __forceinline__ void load_q(const QT* p, float* x) {
  constexpr int PER = 16 / sizeof(QT);
#pragma unroll
  for (int c = 0; c < N / PER; ++c) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + c * PER);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(QT) == 4) {
        x[c * PER + i] = __uint_as_float(w[i]);
      } else {
        x[c * PER + 2 * i] = __uint_as_float(w[i] << 16);
        x[c * PER + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

// named barrier `id` of `n` threads: wait for all, or arrive only
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// One unit of an arrived page, its rows r0 .. r0 + UNIT - 1: the lane's
// U rows of it folded into its running (m, l, acc) for each of the GT
// heads
template <typename QT, int KV, int HD, int GT>
__device__ __forceinline__ void consume_rows(
    const unsigned char* kst, const Layout& lay, const float* brow,
    int page_size, int r0, int rr, int cc, float scale,
    const float (&qr)[GT][RowSplit<KV, HD>::VEC], float (&m)[GT],
    float (&l)[GT], float (&acc)[GT][RowSplit<KV, HD>::VEC]) {
  using R = RowSplit<KV, HD>;
  constexpr int VEC = R::VEC;
  const unsigned char* const vst = kst + lay.vrows;
  const float* const ks_s =
      reinterpret_cast<const float*>(kst + lay.words) + page_size;
  const float* const vs_s = ks_s + page_size;
  uint4 kr[R::U][R::CPL], vr[R::U][R::CPL];
  float bu[R::U], ks[R::U], vs[R::U];
  bool ok[R::U];
#pragma unroll
  for (int u = 0; u < R::U; ++u) {
    const int r = r0 + u * R::RPW + rr;
    ok[u] = r < page_size;
#pragma unroll
    for (int j = 0; j < R::CPL; ++j)
      kr[u][j] = vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
    bu[u] = 0.f;
    ks[u] = vs[u] = 1.f;
    if (ok[u]) {
#pragma unroll
      for (int j = 0; j < R::CPL; ++j) {
        const int off = r * R::ROW + (cc + j * R::LPR) * 16;
        kr[u][j] = *reinterpret_cast<const uint4*>(kst + off);
        vr[u][j] = *reinterpret_cast<const uint4*>(vst + off);
      }
      bu[u] = brow[r];
      if constexpr (KV == kInt8) {
        ks[u] = ks_s[r];
        vs[u] = vs_s[r];
      }
    }
  }

  // scores: a row's dot product from the LPR lanes that hold it
  float x[R::U][GT];
#pragma unroll
  for (int u = 0; u < R::U; ++u) {
    float kf[VEC];
#pragma unroll
    for (int j = 0; j < R::CPL; ++j)
      widen<QT, KV>(kr[u][j], ks[u], kf + j * R::E16);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
      for (int o = 1; o < R::LPR; o <<= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      x[u][g] = ok[u] ? fmaf(d, scale, bu[u]) : -INFINITY;
    }
  }

  // online softmax of this lane's row slot over its U rows
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float mn = m[g];
#pragma unroll
    for (int u = 0; u < R::U; ++u) mn = fmaxf(mn, x[u][g]);
    const float a = exp2f((m[g] - mn) * kLog2e);
    m[g] = mn;
    l[g] *= a;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] *= a;
#pragma unroll
    for (int u = 0; u < R::U; ++u) {
      const float p = exp2f((x[u][g] - mn) * kLog2e);  // 0 past the page
      x[u][g] = p;
      l[g] += p;
    }
  }
#pragma unroll
  for (int u = 0; u < R::U; ++u) {
    float vf[VEC];
#pragma unroll
    for (int j = 0; j < R::CPL; ++j)
      widen<QT, KV>(vr[u][j], vs[u], vf + j * R::E16);
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] = fmaf(x[u][g], vf[e], acc[g][e]);
  }
}

// P > 1: the partitions' (m, l, acc) merged through the cluster's shared
// memory. The block of partition `part` takes an equal share of the
// output's GT * HD columns and reads each partition's row for them, in
// partition order; the last barrier keeps every block's shared memory
// alive until no block reads it. `pending`: this thread arrived for the
// cluster's liveness phase and has not waited for it yet.
template <typename QT, int HD, int GT>
__device__ __forceinline__ void merge_partitions(const float* part_s,
                                                 QT* out_rows, int P,
                                                 int part, bool pending) {
  constexpr int RED = HD + 2;
  constexpr int E = GT * HD;
  if (pending) cluster_wait();
  cluster_arrive();  // this block's merged row is written
  cluster_wait();
  const int share = (E + P - 1) / P;
  const int e1 = min(E, (part + 1) * share);
  for (int i = part * share + static_cast<int>(threadIdx.x); i < e1;
       i += kThreads) {
    const int g = i / HD;
    const int d = i - g * HD;
    const float* row = part_s + g * RED;
    float mq[kMaxPartitions], lq[kMaxPartitions], aq[kMaxPartitions];
#pragma unroll
    for (int p = 0; p < kMaxPartitions; ++p) {
      if (p < P) {
        mq[p] = ld_cluster(row, p);
        lq[p] = ld_cluster(row + 1, p);
        aq[p] = ld_cluster(row + 2 + d, p);
      }
    }
    float M = kMaxInit;
#pragma unroll
    for (int p = 0; p < kMaxPartitions; ++p)
      if (p < P) M = fmaxf(M, mq[p]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxPartitions; ++p) {
      if (p < P) {
        const float f = exp2f((mq[p] - M) * kLog2e);
        L = fmaf(lq[p], f, L);
        A = fmaf(aq[p], f, A);
      }
    }
    out_rows[i] = from_f32<QT>(A / fmaxf(L, 1e-30f));
  }
  cluster_arrive();
  cluster_wait();
}

// A page's words into its ring stage at `words`: each producer lane's
// share of its bias words (from `brow`, where not null) and, for int8,
// of its rows' K and V scales (pool rows row0 ..), by 4-byte cp.async,
// then the lane's arrive on the stage's full barrier once they have
// landed (one of the 32 arrivals the barrier then counts besides the
// TMA's)
template <int KV>
__device__ __forceinline__ void put_words(uint32_t words, uint32_t fb,
                                          const float* brow,
                                          const float* k_scale,
                                          const float* v_scale, int row0,
                                          int kvh, int Hkv, int page_size,
                                          int lane) {
  for (int r = lane; r < page_size; r += 32) {
    if (brow != nullptr) cp_async4(words + 4 * r, brow + r, true);
    if constexpr (KV == kInt8) {
      const size_t at = (static_cast<size_t>(row0) + r) * Hkv + kvh;
      cp_async4(words + 4 * (page_size + r), k_scale + at, true);
      cp_async4(words + 4 * (2 * page_size + r), v_scale + at, true);
    }
  }
  cp_async_arrive_noinc(fb);
}

// one block per (slot, kv-head x head group, partition); module comment
template <typename QT, int KV, int HD, int GT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ page_table,
                    const float* __restrict__ bias, QT* __restrict__ out,
                    int H, int Hkv, int num_pages, int page_size,
                    int max_pages, int pages_per, int stages, float scale) {
  using R = RowSplit<KV, HD>;
  constexpr int VEC = R::VEC;
  constexpr int RED = HD + 2;  // m, l, acc[HD]

  const int s = blockIdx.x;
  const int G = H / Hkv;
  const int n_gt = G / GT;
  const int kvh = blockIdx.y / n_gt;
  const int h0 = kvh * G + (blockIdx.y - kvh * n_gt) * GT;
  const int T = max_pages * page_size;
  const int P = gridDim.z;
  const int part = blockIdx.z;  // the block's rank in its cluster
  const int pg0 = part * pages_per;
  const int n_pg = min(pages_per, max_pages - pg0);
  const int n_tok = n_pg * page_size;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // every page of the partition has a stage of its own (the same in
  // every block of the grid, so the cluster's phases agree)
  const bool direct = pages_per <= stages;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(GT, HD, R::ROW, page_size, pages_per, stages,
                            KV == kInt8);
  const uint32_t full = smem_u32(smem);
  const uint32_t empty = full + 8 * stages;
  float* const flag_s = reinterpret_cast<float*>(smem + lay.flag);
  int* const n_used_s = reinterpret_cast<int*>(smem + lay.flag + 4);
  // compact: the used pages in order, each one's first pool row and first
  // token of the partition (written over the clamped page ids and live
  // flags they come from)
  int* const row_s = reinterpret_cast<int*>(smem + lay.rows);
  int* const tok_s = reinterpret_cast<int*>(smem + lay.toks);
  float* const bias_s = reinterpret_cast<float*>(smem + lay.bias);
  float* const red_s = reinterpret_cast<float*>(smem + lay.red);
  float* const part_s = reinterpret_cast<float*>(smem + lay.part);
  const uint32_t ring = up128(full + lay.ring);

  // units a page, and the consumer warps that take part in each page
  const int upp = (page_size + R::UNIT - 1) / R::UNIT;
  // the producer lanes' cp.async arrivals each stage's full barrier
  // counts: the direct ring's bias words, the int8 scales
  const bool words = direct || KV == kInt8;
  bool waited = false;  // for the cluster's liveness phase

  if (warp == kConsumerWarps) {
    // producer
    const int32_t* pt_row =
        page_table + static_cast<size_t>(s) * max_pages + pg0;
    const float* bias_row =
        bias + static_cast<size_t>(s) * T + static_cast<size_t>(pg0) * page_size;
    // the first page ids (and, compact, bias words) in flight at once,
    // before anything waits
    int pw[kPidWords];
    float bw[kBiasWords];
#pragma unroll
    for (int u = 0; u < kPidWords; ++u) {
      const int i = lane + 32 * u;
      pw[u] = i < n_pg ? pt_row[i] : 0;
    }
    if (!direct) {
#pragma unroll
      for (int u = 0; u < kBiasWords; ++u) {
        const int i = lane + 32 * u;
        bw[u] = i < n_tok ? bias_row[i] : kNegInf;
      }
    }
    if (lane == 0) {
      for (int st = 0; st < stages; ++st) {
        bar_init(full + 8 * st, words ? 1 + 32 : 1);  // TMA's expect, lanes
        bar_init(empty + 8 * st, min(upp, kConsumerWarps));
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    if (direct) {
      named_arrive(1, kThreads);  // the ring's barriers are initialised
      // each page into its own stage: lane k the boxes of page k, then
      // every lane its words of each page
      const int pid = pw[0] < 0 ? 0 : (pw[0] >= num_pages ? num_pages - 1
                                                          : pw[0]);
      if (lane < n_pg) {
        const uint32_t fb = full + 8 * lane;
        const uint32_t dst = ring + lane * lay.stage;
        bar_expect(fb, 2 * page_size * R::ROW);
        tma_3d(dst, &tm_k, fb, 0, kvh, pid * page_size);
        tma_3d(dst + lay.vrows, &tm_v, fb, 0, kvh, pid * page_size);
      }
      for (int k = 0; k < n_pg; ++k)
        put_words<KV>(ring + k * lay.stage + lay.words, full + 8 * k,
                      bias_row + k * page_size, k_scale, v_scale,
                      __shfl_sync(0xffffffffu, pid, k) * page_size, kvh,
                      Hkv, page_size, lane);
    } else {
      // a page's clamped id and live flag until the list replaces them
      int* const live_s = tok_s;
#pragma unroll
      for (int u = 0; u < kPidWords; ++u) {
        const int i = lane + 32 * u;
        if (i < n_pg) {
          row_s[i] = pw[u] < 0 ? 0 : (pw[u] >= num_pages ? num_pages - 1
                                                         : pw[u]);
          live_s[i] = 0;
        }
      }
      for (int i = lane + 32 * kPidWords; i < n_pg; i += 32) {
        const int pid = pt_row[i];
        row_s[i] = pid < 0 ? 0 : (pid >= num_pages ? num_pages - 1 : pid);
        live_s[i] = 0;
      }
      __syncwarp();
      int any = 0;
#pragma unroll
      for (int u = 0; u < kBiasWords; ++u) {
        const int i = lane + 32 * u;
        if (i < n_tok) {
          bias_s[i] = bw[u];
          if (bw[u] > kMaskedBelow) {
            live_s[i / page_size] = 1;
            any = 1;
          }
        }
      }
      for (int i = lane + 32 * kBiasWords; i < n_tok; i += 32) {
        const float b = bias_row[i];
        bias_s[i] = b;
        if (b > kMaskedBelow) {
          live_s[i / page_size] = 1;
          any = 1;
        }
      }
      const bool part_live = __any_sync(0xffffffffu, any);
      // 0: no page (the row is live elsewhere), 1: the live pages, 2:
      // every page (a free row)
      int mode = part_live ? 1 : 2;
      if (P > 1) {
        if (lane == 0) flag_s[0] = part_live ? 1.f : 0.f;
        cluster_arrive();
        if (!part_live) {
          cluster_wait();
          waited = true;
          for (int p = 0; p < P; ++p)
            if (p != part && ld_cluster(flag_s, p) != 0.f) mode = 0;
        }
      }
      // the used pages compacted in order, 32 at a time: each chunk's
      // flags and ids are read before any of its entries is written
      __syncwarp();
      int n_used = 0;
      for (int c = 0; c < n_pg && mode != 0; c += 32) {
        const int pi = c + lane;
        const bool use = pi < n_pg && (mode == 2 || live_s[pi]);
        const int pid = use ? row_s[pi] : 0;
        const uint32_t ballot = __ballot_sync(0xffffffffu, use);
        __syncwarp();
        if (use) {
          const int k = n_used + __popc(ballot & ((1u << lane) - 1u));
          row_s[k] = pid * page_size;
          tok_s[k] = pi * page_size;
        }
        n_used += __popc(ballot);
        __syncwarp();
      }
      if (lane == 0) n_used_s[0] = n_used;
      __syncwarp();
      named_arrive(1, kThreads);

      // the used pages in order, each into the next ring stage
      int st = 0;
      uint32_t phase = 0;  // of the current round of the ring
      for (int k = 0; k < n_used; ++k) {
        const uint32_t fb = full + 8 * st;
        if (k >= stages) bar_wait(empty + 8 * st, phase ^ 1);
        const uint32_t dst = ring + st * lay.stage;
        const int row0 = row_s[k];
        if (lane == 0) {
          bar_expect(fb, 2 * page_size * R::ROW);
          tma_3d(dst, &tm_k, fb, 0, kvh, row0);
          tma_3d(dst + lay.vrows, &tm_v, fb, 0, kvh, row0);
        }
        if constexpr (KV == kInt8)
          put_words<KV>(dst + lay.words, fb, nullptr, k_scale, v_scale, row0,
                        kvh, Hkv, page_size, lane);
        if (++st == stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    if (P > 1 && !direct) cluster_arrive();  // the liveness phase
    const int rr = lane / R::LPR;  // row of a warp load
    const int cc = lane - rr * R::LPR;  // first 16-byte column of that row
    float qr[GT][VEC];
    const size_t q_row = (static_cast<size_t>(s) * H + h0) * HD;
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int j = 0; j < R::CPL; ++j)
        load_q<QT, R::E16>(q + q_row + g * HD + (cc + j * R::LPR) * R::E16,
                           qr[g] + j * R::E16);
    float m[GT], l[GT], acc[GT][VEC];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m[g] = kMaxInit;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
    }

    named_sync(1, kThreads);  // the ring's barriers (and, compact, the list)
    const int n_used = direct ? n_pg : n_used_s[0];
    // unit c of a page in stage st is warp (st upp + c) mod 4's: the
    // stage's first unit moves on by upp warps a stage
    int st = 0, lead = 0;
    uint32_t phase = 0;
    for (int k = 0; k < n_used; ++k) {
      const int first = (warp - lead) & (kConsumerWarps - 1);
      if (first < upp) {
        bar_wait(full + 8 * st, phase);
        const unsigned char* const kst = smem + (ring - full) + st * lay.stage;
        const float* const brow =
            direct ? reinterpret_cast<const float*>(kst + lay.words)
                   : bias_s + tok_s[k];
        for (int c = first; c < upp; c += kConsumerWarps)
          consume_rows<QT, KV, HD, GT>(kst, lay, brow, page_size,
                                       c * R::UNIT, rr, cc, scale, qr, m, l,
                                       acc);
        __syncwarp();
        if (lane == 0) bar_arrive(empty + 8 * st);
      }
      lead = (lead + upp) & (kConsumerWarps - 1);
      if (++st == stages) {
        st = 0;
        lead = 0;
        phase ^= 1;
      }
    }

    // merge the warp's row slots (lanes LPR apart hold the same columns)
#pragma unroll
    for (int o = R::LPR; o < 32; o <<= 1)
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
          red[2 + (cc + (e / R::E16) * R::LPR) * R::E16 + e % R::E16] =
              acc[g][e];
      }
    }
  }
  __syncthreads();

  // merge the warps: the output (P = 1) or the partition's row
  const size_t q_row = (static_cast<size_t>(s) * H + h0) * HD;
  for (int i = tid; i < GT * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i - g * HD;
    float M = kMaxInit;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w)
      M = fmaxf(M, red_s[(w * GT + g) * RED]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) {
      const float* red = red_s + (w * GT + g) * RED;
      const float f = exp2f((red[0] - M) * kLog2e);
      L = fmaf(red[1], f, L);
      A = fmaf(red[2 + d], f, A);
    }
    if (P == 1) {
      out[q_row + i] = from_f32<QT>(A / fmaxf(L, 1e-30f));
    } else {
      float* row = part_s + g * RED;
      if (d == 0) {
        row[0] = M;
        row[1] = L;
      }
      row[2 + d] = A;
    }
  }
  if (P > 1)
    merge_partitions<QT, HD, GT>(part_s, out + q_row, P, part,
                                 !direct && !waited);
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *page_table, *bias;
  void* out;
  int S, H, Hkv, hd, num_pages, page_size, max_pages, partitions;
  float scale;
  cudaStream_t stream;
};

// a [num_pages, page_size, Hkv, hd] pool as dims (hd, Hkv, num_pages *
// page_size), box (hd, 1, page_size): one page of one kv-head, unswizzled
template <int KV>
bool map_pages(CUtensorMap* map, const void* pool, int num_pages,
               int page_size, int Hkv, int hd) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * elem_bytes(KV);
  const cuuint64_t dims[3] = {
      static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(Hkv),
      static_cast<cuuint64_t>(num_pages) * page_size};
  const cuuint64_t strides[2] = {row, row * Hkv};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(hd), 1,
                             static_cast<cuuint32_t>(page_size)};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      KV == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : (KV == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_UINT8);
  return encode(map, type, 3, const_cast<void*>(pool), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__host__ inline int gcd_int(int a, int b) {
  return b == 0 ? a : gcd_int(b, a % b);
}

// The ring's depth in pages: as many as the SM's shared memory holds for
// every block it runs at once (the grid, one wave of them where
// decode_partitions splits), at most kMaxStages and the partition's pages
// (then the ring is direct); where the ring wraps, a multiple of the
// consumer warps' period, so they share its pages evenly. 0 when a ring
// of one stage does not fit one block.
template <int KV, int HD>
int ring_stages(int gt, int blocks, int page_size, int pages_per) {
  using R = RowSplit<KV, HD>;
  int dev = 0, sms = 0, sm_bytes = 0, block_bytes = 0, reserved = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaDeviceGetAttribute(&sm_bytes,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) ||
      cudaDeviceGetAttribute(&block_bytes,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) ||
      cudaDeviceGetAttribute(&reserved,
                             cudaDevAttrReservedSharedMemoryPerBlock, dev))
    return 0;
  const int per_sm = (blocks + sms - 1) / sms;
  const int share = std::min(block_bytes, sm_bytes / per_sm - reserved);
  auto bytes = [&](int stages) {
    return layout(gt, HD, R::ROW, page_size, pages_per, stages, KV == kInt8)
        .total;
  };
  int stages = std::min(pages_per, kMaxStages);
  while (stages > 1 && bytes(stages) > share) --stages;
  const int upp = (page_size + R::UNIT - 1) / R::UNIT;
  const int period = kConsumerWarps / gcd_int(upp, kConsumerWarps);
  if (stages < pages_per && stages > period) stages -= stages % period;
  return bytes(stages) <= block_bytes ? stages : 0;
}

template <typename QT, int KV, int HD, int GT>
cudaError_t launch(const Args& a) {
  const int pages_per = (a.max_pages + a.partitions - 1) / a.partitions;
  const dim3 grid(a.S, a.Hkv * (a.H / a.Hkv / GT), a.partitions);
  const int stages = ring_stages<KV, HD>(GT, grid.x * grid.y * grid.z,
                                         a.page_size, pages_per);
  if (stages == 0) return cudaErrorInvalidValue;
  const int smem = layout(GT, HD, RowSplit<KV, HD>::ROW, a.page_size,
                          pages_per, stages, KV == kInt8)
                       .total;
  CUtensorMap tm_k, tm_v;
  if (!map_pages<KV>(&tm_k, a.k, a.num_pages, a.page_size, a.Hkv, HD) ||
      !map_pages<KV>(&tm_v, a.v, a.num_pages, a.page_size, a.Hkv, HD))
    return cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<QT, KV, HD, GT>;
  // raised only when a larger block needs it, so launches can be captured
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = a.partitions;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const QT*>(a.q), tm_k, tm_v,
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int32_t*>(a.page_table),
      static_cast<const float*>(a.bias), static_cast<QT*>(a.out), a.H, a.Hkv,
      a.num_pages, a.page_size, a.max_pages, pages_per, stages, a.scale);
  return launched;
}

// the head group GT: 4, 2 or 1 query heads of a kv-head per block
__host__ inline int head_group(int H, int Hkv) {
  const int G = H / Hkv;
  return G % 4 == 0 ? 4 : (G % 2 == 0 ? 2 : 1);
}

template <typename QT, int KV, int HD>
cudaError_t launch_gt(const Args& a) {
  switch (head_group(a.H, a.Hkv)) {
    case 4: return launch<QT, KV, HD, 4>(a);
    case 2: return launch<QT, KV, HD, 2>(a);
    default: return launch<QT, KV, HD, 1>(a);
  }
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

bool head_dim_ok(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 128 || hd == 256;
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype codes: 0 float32,
// 1 bfloat16, 2 int8 (kv only, with k_scale/v_scale). Supported:
// q bf16 with a bf16 or int8 pool; q f32 with an f32, bf16 or int8 pool;
// hd one of 16, 32, 64, 128, 256; page_size at most 256 (a TMA box
// side) and num_pages * page_size below 2**31 (a TMA coordinate); q and
// the pools start 16-byte aligned.
// ``partitions`` (1 to 8, the blocks of one cluster) splits the max_pages
// pages into parts of ceil(max_pages / partitions) pages, none empty.
// Returns the launch's error (0 = launched); cudaErrorInvalidValue also
// for a shape whose block does not fit the card's shared memory with a
// ring of one stage.
extern "C" int paged_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* bias, void* out,
    int S, int H, int Hkv, int hd, int num_pages, int page_size,
    int max_pages, int partitions, int q_dtype, int kv_dtype, float scale,
    void* stream) {
  if (S <= 0 || Hkv <= 0 || H % Hkv != 0 || num_pages <= 0 ||
      page_size <= 0 || page_size > 256 || max_pages <= 0 || partitions <= 0 ||
      partitions > kMaxPartitions || partitions > max_pages ||
      !head_dim_ok(hd))
    return static_cast<int>(cudaErrorInvalidValue);
  const int pages_per = (max_pages + partitions - 1) / partitions;
  // a pool row is a TMA coordinate: int32
  if ((partitions - 1) * pages_per >= max_pages ||
      static_cast<long long>(num_pages) * page_size > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, k_scale, v_scale, page_table, bias, out,
               S, H, Hkv, hd, num_pages, page_size, max_pages, partitions,
               scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return static_cast<int>(launch_hd<bf16, kBF16>(a));
  if (q_dtype == kBF16 && kv_dtype == kInt8)
    return static_cast<int>(launch_hd<bf16, kInt8>(a));
  if (q_dtype == kF32 && kv_dtype == kF32)
    return static_cast<int>(launch_hd<float, kF32>(a));
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return static_cast<int>(launch_hd<float, kBF16>(a));
  if (q_dtype == kF32 && kv_dtype == kInt8)
    return static_cast<int>(launch_hd<float, kInt8>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}
