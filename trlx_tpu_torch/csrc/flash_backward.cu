// Flash attention backward for bfloat16 on Hopper (sm_90a): dq, which
// also computes D = rowsum(dO * O), and dk/dv, both on wgmma with tiles
// brought in by TMA.
//
// Replaces: trlx_tpu/ops/pallas_attention.py
//   - flash_bwd_dq_wgmma_kernel  <- _flash_bwd_dq_kernel (pallas_call :385),
//     plus the jnp line that computes D before it (:355-360);
//   - flash_bwd_dkv_wgmma_kernel <- _flash_bwd_dkv_kernel (pallas_call :404).
// Both launched by _flash_backward. They compute what the TPU kernels
// compute: p = exp(s + bias - lse) with s = q k^T / sqrt(hd) and the bias
// 0 / -1e9 from the raw [B, T] key mask plus -1e9 above the diagonal,
// ds = p (dO v^T - D), dq = ds k scale, dv = p^T dO, dk = ds^T q scale.
// q, k, v, dO and O are [B, T, H, hd] bf16; lse and D float32 [B, H, T];
// dq, dk, dv come out bf16, rounded once from float32 sums. The float32
// backward stays on the CUDA cores in flash_attention.cu.
//
// What bounds them on an H100. At the training shape (B 32, T 576, H 12,
// hd 64) each must move about 172 MB (dq: q, k, v, dO, O in, dq out; dk/
// dv: q, k, v, dO in, dk, dv out; ~51 us at 3.35 TB/s) against 24.5 and
// 32.7 GFLOP of live causal products (~25 and ~33 us at 989 TF/s): bytes
// bound both; at T 2048 and at hd 256 operations come close. Beyond the
// bytes, three things cost time here: the streamed tiles each block
// reads again from L2 (a query block reads its head's K and V up to its
// diagonal), the serial chain of a tile (first products, then the
// softmax terms, then the second products) that a warpgroup cannot
// overlap with itself, and the hi + lo second products, twice the
// tensor work of rounding P and dS once.
//
// Design (both kernels):
//   - one block per (batch * head, 64-row slice): query rows in dq, key
//     rows in dk/dv (wgmma's M). A head's blocks are neighbours in the
//     grid, heaviest causal slice first, so the blocks on the card at
//     once share their heads' streamed tiles in the 50 MB L2; ordered
//     head-minor, as the mma.sync kernels were, hundreds of heads' tiles
//     are in flight and the streamed tiles come from device memory again
//     and again (tools/flash_backward_ablation.py measures both orders).
//   - consumer warpgroups compute; a producer warpgroup keeps few
//     registers and hands the rest to them (setmaxnreg, Plan below). The
//     producer's first warp streams; its lane 0 issues every tile load as
//     a TMA copy of a 4-D box (tensor maps over [B, T, H, hd]: dims (hd,
//     H, T, B), box (min(hd, 64), 1, 64, 1), built on the host per call
//     and passed by value as __grid_constant__, so the launch can be
//     captured in a CUDA graph); the swizzle is the box row's width (128 B
//     from hd 64, 64 B at hd 32, 32 B at hd 16), the layout wgmma reads
//     without a bank conflict. Rows past T come back as zeros (TMA's
//     out-of-bounds fill) and are never written.
//   - the block's own tiles (Q and dO in dq; K and V in dk/dv) are
//     loaded once behind one mbarrier; the streamed tiles (K, V and the
//     key mask in dq; Q, dO, lse and D in dk/dv) go through a ring of
//     stages (four to hd 64, two beyond), each guarded by a full barrier
//     (the producer's expect_tx, the copies' bytes) and an empty one (one
//     arrival per consumer warp), so later tiles land while this one is
//     computed. The key mask, lse and D rows (64 values a tile, 0 past T)
//     the producer warp's lanes copy by 4-byte cp.async that the full
//     barrier also waits for (cp.async.mbarrier.arrive): a row of T
//     4-byte values starts 16-byte aligned only when T is a multiple of
//     4, and a TMA box's start must be.
//   - the first products (S = Q K^T and dP = dO V^T in dq; S^T = K Q^T
//     and dP^T = V dO^T in dk/dv) are wgmma m64n64k16 with both operands
//     in shared memory, K-major, the two chains interleaved. P and dS
//     stay in registers: exp2 of one FMA (scale and lse folded into log2
//     units; the causal test only on the diagonal tile), and the
//     accumulators of n-tiles 2 j, 2 j + 1 are the A fragment of k-step
//     j, split into a bf16 pair hi + lo (2^-17 relative; rounded once, dS
//     put dq past the plain version's atol 1e-2 + rtol 1e-2 on ILQL's
//     layout). The second products (dq += dS K; dV += P^T dO, dK += dS^T
//     Q) are wgmma with A from registers and B read MN-major (trans-b)
//     from the same tiles, hi then lo.
//   - dq's prologue computes D for its own rows from the dO tile and O's
//     rows (read once with plain 16-byte loads, issued before the dO tile
//     lands: a third own tile would cost dq its second block an SM at hd
//     128), uses it from registers and writes it to a float32 [B, H, T]
//     buffer that dk/dv then streams: the backward seam launches exactly
//     these two kernels.
//   - one consumer warpgroup keeps all output columns where its float32
//     accumulators fit (dq to hd 128; dk/dv, which keeps two, to hd 64):
//     a block of 256 threads launches with 128 registers a thread, so two
//     blocks share an SM and one's loads and epilogue overlap the
//     other's products. Beyond (dq at hd 256; dk/dv at hd 128 and 256,
//     where 64 x 256 float32 of dK and of dV are 128 registers a thread
//     each) two consumer warpgroups share the slice and split the output
//     columns, both forming the slice's whole S and dP (1.33x the tensor
//     work of the hi + lo backward), one block an SM.
//   - no atomics: each output element is written by one thread of one
//     block, so results are deterministic; causal tiles wholly above the
//     diagonal are never loaded; a left-pad query row sees only -1e9 keys
//     and stays finite.
// ptxas (-Xptxas -v, printed by chip_smoke.py at build time) gives each
// instance's registers and spills: 168 (two consumers) or 128 (one) at
// launch, the consumers' 232 after setmaxnreg, no spills and no
// serialized wgmma. Tried and measured slower (dropped): a second S / dP
// register set so tile j + 1's first products run under tile j's softmax
// terms (ptxas serialized the wgmmas for want of registers), and dk/dv
// issuing dV's product before forming dS.

#include "hopper.cuh"

namespace {

// A block's plan for one kernel (DKV: dk/dv, else dq) at head dim HD. The
// block owns one 64-row slice (query rows in dq, key rows in dk/dv). One
// consumer warpgroup keeps all output columns while its accumulators fit
// (dq to hd 128: 64 rows x 128 float32 is 64 registers a thread; dk/dv,
// two of them, to hd 64); beyond, two consumer warpgroups share the slice
// and split the columns (SPLIT 2), both forming its whole S and dP.
// Registers are granted in groups of four warps: a block of one consumer
// warpgroup and the producer one launches with 128 a thread, so two
// blocks share an SM and one's loads or epilogue overlap the other's
// products; with two consumers, 168 (one block an SM). The producer keeps
// 24 or 40 and the consumers take the rest: 232 each either way.
template <int HD, bool DKV>
struct Plan {
  static constexpr int SPLIT = (DKV ? HD > 64 : HD > 128) ? 2 : 1;
  static constexpr int CONSUMERS = SPLIT;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int BLOCKS = CONSUMERS == 1 ? 2 : 1;  // an SM
  static constexpr int LAUNCH_REGS = CONSUMERS == 1 ? 128 : 168;
  static constexpr int PRODUCER_REGS = CONSUMERS == 1 ? 24 : 40;
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int COLS = HD / SPLIT;           // output columns kept
  static constexpr int NW = COLS < 64 ? COLS : 64;  // N of a second product
  static constexpr int NPART = COLS / NW;
  static_assert(BLOCKS * THREADS * LAUNCH_REGS <= 65536, "register file");
  static_assert(PRODUCER_REGS + CONSUMERS * CONSUMER_REGS ==
                    (CONSUMERS + 1) * LAUNCH_REGS,
                "the producer frees what the consumers take");
};

// stages of the ring of streamed tiles: four while the tiles are small
// (two blocks an SM still fit), else two
template <int HD>
__host__ __device__ constexpr int stages() { return HD <= 64 ? 4 : 2; }

// dynamic shared memory of each kernel: 1 KB to align the tiles to the
// 128 B swizzle's 1024 B period, the block's own tiles (Q, dO; K, V),
// the stages of the streamed ones (K, V; Q, dO) and of their rows
// (the key-mask bias; lse and D), dq's D, the mbarriers
template <int HD>
constexpr int dq_smem() {
  using B = Box<HD>;
  constexpr int NS = stages<HD>();
  return 1024 + 2 * B::TILE + 2 * NS * B::TILE + NS * kTile * 4 +
         kTile * 4 + 8 * (2 * NS + 1);
}

template <int HD>
constexpr int dkv_smem() {
  using B = Box<HD>;
  constexpr int NS = stages<HD>();
  return 1024 + 2 * B::TILE + 2 * NS * B::TILE + 2 * NS * kTile * 4 +
         8 * (2 * NS + 1);
}

static_assert(dq_smem<256>() <= 232448, "dq at hd 256 exceeds a block");
static_assert(dkv_smem<256>() <= 232448, "dk/dv at hd 256 exceeds a block");
// two blocks an SM where one consumer warpgroup leaves the registers for
// two: 228 KB an SM, 1 KB of it reserved for each block
static_assert(2 * (dq_smem<128>() + 1024) <= 233472, "two dq blocks");
static_assert(2 * (dkv_smem<64>() + 1024) <= 233472, "two dk/dv blocks");
static_assert(2 * (dq_smem<64>() + 1024) <= 233472, "two dq blocks");

// the N threads of the consumer warpgroups (named barrier 1)
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// two floats as the bf16 pair nearest them (hi) and the bf16 pair of
// what hi leaves (lo), the lower column in the low half: hi + lo is
// within 2^-17 of each value
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// sum of the products of eight bf16 pairs, in float32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s[i] = fmaf(u.x, v.x, u.y * v.y);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// A warpgroup's float32 accumulators [NPART][NW / 2] of 64 rows (row0 ..
// row0 + 63 of head (b, h)) by columns c0 .. c0 + COLS, times `mul`,
// rounded once to bf16 and stored, rows below T only. Thread layout of a
// wgmma accumulator: warp w holds rows 16 w .. 16 w + 15; n-tile j of
// 8 columns gives it (row g, cols 2 t, 2 t + 1) and the same at row g + 8
// (g = lane / 4, t = lane % 4).
template <int HD, class P>
__device__ __forceinline__ void store_acc(
    bf16* out, const float (&acc)[P::NPART][P::NW / 2], float mul, int warp,
    int lane, int b, int row0, int Tlen, int H, int h, int c0) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + warp * 16 + gq + 8 * i;
    if (t >= Tlen) continue;
    bf16* dst = out + ((static_cast<size_t>(b) * Tlen + t) * H + h) * HD;
#pragma unroll
    for (int p = 0; p < P::NPART; ++p)
#pragma unroll
      for (int j = 0; j < P::NW / 8; ++j) {
        const int c = c0 + p * P::NW + j * 8 + tq * 2;
        *reinterpret_cast<uint32_t*>(dst + c) =
            pack_bf16(acc[p][j * 4 + 2 * i] * mul,
                      acc[p][j * 4 + 2 * i + 1] * mul);
      }
  }
}

// issue the first products of one tile, d0 = A0 B0^T and d1 = A1 B1^T
// over the head dim (all four 64-row tiles K-major in shared memory), as
// one wgmma group, two chains interleaved; the caller waits for it
template <int HD>
__device__ __forceinline__ void first_products(float (&d0)[32],
                                               float (&d1)[32], uint32_t a0,
                                               uint32_t b0, uint32_t a1,
                                               uint32_t b1) {
#pragma unroll
  for (int e = 0; e < 32; ++e) d0[e] = d1[e] = 0.f;
  keep(d0);
  keep(d1);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wgmma_ss_n64(d0, tile_k<HD>(a0, kk), tile_k<HD>(b0, kk));
    wgmma_ss_n64(d1, tile_k<HD>(a1, kk), tile_k<HD>(b1, kk));
  }
  wg_commit();
}

// ------------------------------------------------------------------ //
// dq (and D)
// ------------------------------------------------------------------ //

// dS = P (dP - D) of one 64 x 64 tile as A fragments hi + lo (n-tiles
// 2 kk, 2 kk + 1 are k-step kk): row r = warp 16 + g + 8 i of the slice,
// column c of the key tile; DIAG masks c > r
template <bool DIAG>
__device__ __forceinline__ void dq_scores(const float (&s)[32],
                                          const float (&dp)[32],
                                          const int32_t* ms, float sl,
                                          const float (&lse2)[2],
                                          const float (&d_r)[2], int row,
                                          int tq, uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 8 + tq * 2 + (e & 1);
      const int i = e >> 1;
      const float bias2 = ms[c] > 0 ? 0.f : kNegInf * kLog2e;
      float p = exp2_approx(fmaf(s[j * 4 + e], sl, bias2 - lse2[i]));
      if (DIAG && row + 8 * i < c) p = 0.f;
      ds[e] = p * (dp[j * 4 + e] - d_r[i]);
    }
    const int f = (j & 1) * 2;
    split_bf16(ds[0], ds[1], hi[j >> 1][f], lo[j >> 1][f]);
    split_bf16(ds[2], ds[3], hi[j >> 1][f + 1], lo[j >> 1][f + 1]);
  }
}

// One block per (batch * head, 64 query rows). Shared memory: Q and dO
// of the block's rows, then the stages of K, V and the key mask, D of the
// block's rows, the barriers (full[NS], empty[NS], own). O, needed for D
// alone, is read once by the consumers' own loads: a third own tile would
// leave room for one block an SM at hd 128.
template <int HD>
__global__ void __launch_bounds__(Plan<HD, false>::THREADS,
                                  Plan<HD, false>::BLOCKS)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_g,
                          const bf16* __restrict__ o,
                          const int32_t* __restrict__ mask,
                          const float* __restrict__ lse,
                          float* __restrict__ dD, bf16* __restrict__ dq,
                          int Tlen, int H, int causal, float scale) {
  using G = Box<HD>;
  using P = Plan<HD, false>;
  constexpr int NS = stages<HD>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sp = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t g_s = q_s + G::TILE;
  const uint32_t k_s = g_s + G::TILE;
  const uint32_t v_s = k_s + NS * G::TILE;
  const uint32_t m_off = v_s + NS * G::TILE - base;  // [NS][64]
  const uint32_t d_off = m_off + NS * kTile * 4;     // [64]
  const uint32_t full = base + d_off + kTile * 4;
  const uint32_t empty = full + 8 * NS;
  const uint32_t own = empty + 8 * NS;

  // a head's query tiles are neighbouring blocks, heaviest first, so the
  // blocks on the card at once share their heads' K and V in L2
  const int n_k = (Tlen + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_k;
  const int b = bh / H;
  const int h = bh - b * H;
  const int iq = n_k - 1 - (blockIdx.x - bh * n_k);
  const int q0 = iq * kTile;
  const int n_live = causal ? iq + 1 : n_k;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, P::CONSUMERS * 4);
    }
    bar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == P::CONSUMERS) {
    // producer: its first warp streams; lane 0 issues every TMA copy
    regs_dec<P::PRODUCER_REGS>();
    if (threadIdx.x >= P::CONSUMERS * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      bar_expect(own, 2 * G::TILE);
      for (int c = 0; c < G::NBOX; ++c) {
        const uint32_t off = c * G::BOX;
        tma_4d(q_s + off, &tm_q, own, c * G::BOXW, h, q0, b);
        tma_4d(g_s + off, &tm_g, own, c * G::BOXW, h, q0, b);
      }
    }
    for (int jt = 0; jt < n_live; ++jt) {
      const int st = jt % NS;
      bar_wait(empty + 8 * st, ((jt / NS) & 1) ^ 1);
      // the tile's 64 key-mask entries (0 past T) by 4-byte cp.async
      // that the full barrier also waits for: a row of a [B, T] int32
      // array starts 16-byte aligned only when T is a multiple of 4,
      // which a TMA box's start needs
      const uint32_t bar = full + 8 * st;
      for (int c = lane; c < kTile; c += 32) {
        const int t = jt * kTile + c;
        cp_async4(base + m_off + (st * kTile + c) * 4,
                  mask + static_cast<size_t>(b) * Tlen + (t < Tlen ? t : 0),
                  t < Tlen);
      }
      cp_async_arrive(bar);
      __syncwarp();
      if (lane == 0) {
        bar_expect(bar, 2 * G::TILE);
        for (int c = 0; c < G::NBOX; ++c) {
          const uint32_t off = st * G::TILE + c * G::BOX;
          tma_4d(k_s + off, &tm_k, bar, c * G::BOXW, h, jt * kTile, b);
          tma_4d(v_s + off, &tm_v, bar, c * G::BOXW, h, jt * kTile, b);
        }
      }
    }
    return;
  }
  regs_inc<P::CONSUMER_REGS>();

  // consumers: warpgroup wg keeps output columns c0 .. c0 + COLS of the
  // block's 64 query rows
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int c0 = wg * P::COLS;
  float* d_sm = reinterpret_cast<float*>(sp + d_off);
  const int row = warp * 16 + gq;  // and row + 8
  const float sl = scale * kLog2e;
  float lse2[2], d_r[2];
  {
    // D = rowsum(dO * O) of the block's rows, TPR consumer threads a row
    // (neighbouring lanes), each over every TPR-th 16-byte chunk: O's
    // chunks by plain loads issued before the dO tile has landed, dO's
    // where the 128 / 64 / 32 B swizzle put them (bits 4.. of the offset
    // XOR bits 7..)
    constexpr int TPR = P::CONSUMERS * 128 / kTile;
    constexpr int CH = G::RW / 16 / TPR;  // chunks of a box a thread takes
    const int u = wg * 128 + tid;
    const int r = u / TPR, t = q0 + r;
    uint4 ov[G::NBOX][CH];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // lse of the warp's rows, log2 units
      const int tl = q0 + row + 8 * i;
      lse2[i] = tl < Tlen
                    ? lse[static_cast<size_t>(bh) * Tlen + tl] * kLog2e
                    : 0.f;
    }
    const bf16* orow = o + ((static_cast<size_t>(b) * Tlen + min(t, Tlen - 1))
                            * H + h) * HD;
#pragma unroll
    for (int c = 0; c < G::NBOX; ++c)
#pragma unroll
      for (int i = 0; i < CH; ++i)
        ov[c][i] = *reinterpret_cast<const uint4*>(
            orow + c * G::BOXW + (u % TPR + i * TPR) * 8);
    bar_wait(own, 0);
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < G::NBOX; ++c)
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const uint32_t off = r * G::RW + (u % TPR + i * TPR) * 16;
        const uint32_t swz = off ^ (((off >> 7) & (G::RW / 16 - 1)) << 4);
        d += dot8(*reinterpret_cast<const uint4*>(sp + (g_s - base) +
                                                  c * G::BOX + swz),
                  ov[c][i]);
      }
    if (t >= Tlen) d = 0.f;
#pragma unroll
    for (int m = 1; m < TPR; m <<= 1)
      d += __shfl_xor_sync(0xffffffffu, d, m);
    if (u % TPR == 0) {
      d_sm[r] = d;
      if (t < Tlen) dD[static_cast<size_t>(bh) * Tlen + t] = d;
    }
  }
  consumers_sync<P::CONSUMERS * 128>();
#pragma unroll
  for (int i = 0; i < 2; ++i) d_r[i] = d_sm[row + 8 * i];

  float acc[P::NPART][P::NW / 2];
#pragma unroll
  for (int p = 0; p < P::NPART; ++p)
#pragma unroll
    for (int e = 0; e < P::NW / 2; ++e) acc[p][e] = 0.f;

  for (int jt = 0; jt < n_live; ++jt) {
    const int st = jt % NS;
    bar_wait(full + 8 * st, (jt / NS) & 1);
    const uint32_t ks = k_s + st * G::TILE;
    const int32_t* ms =
        reinterpret_cast<const int32_t*>(sp + m_off) + st * kTile;
    float s[32], dp[32];
    first_products<HD>(s, dp, q_s, ks, g_s, v_s + st * G::TILE);
    wg_wait_all();
    keep(s);
    keep(dp);
    uint32_t hi[4][4], lo[4][4];
    if (causal && jt == iq)
      dq_scores<true>(s, dp, ms, sl, lse2, d_r, row, tq, hi, lo);
    else
      dq_scores<false>(s, dp, ms, sl, lse2, d_r, row, tq, hi, lo);

    // dq += dS K: K's rows are this product's K, so B is MN-major
#pragma unroll
    for (int p = 0; p < P::NPART; ++p) keep(acc[p]);
    keep(hi);
    keep(lo);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int p = 0; p < P::NPART; ++p)
        wgmma_rs<P::NW>(acc[p], hi[kk], tile_mn<HD>(ks, kk, c0 + p * P::NW));
#pragma unroll
      for (int p = 0; p < P::NPART; ++p)
        wgmma_rs<P::NW>(acc[p], lo[kk], tile_mn<HD>(ks, kk, c0 + p * P::NW));
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < P::NPART; ++p) keep(acc[p]);
    keep(hi);
    keep(lo);
    if (lane == 0) bar_arrive(empty + 8 * st);
  }
  store_acc<HD, P>(dq, acc, scale, warp, lane, b, q0, Tlen, H, h, c0);
}

// ------------------------------------------------------------------ //
// dk, dv
// ------------------------------------------------------------------ //

// P^T and dS^T of one 64 x 64 tile as A fragments hi + lo (k = queries):
// row r = warp 16 + g + 8 i is a key of the slice, column c a query of
// the tile; DIAG masks c < r. A query past T has zero Q and dO rows and
// zero lse and D, so its dS is 0 and its P meets a zero dO row.
template <bool DIAG>
__device__ __forceinline__ void dkv_scores(
    const float (&s)[32], const float (&dp)[32], const float* ls,
    const float* dd, float sl, const float (&kb2)[2], int row, int tq,
    uint32_t (&pa)[4][4], uint32_t (&pl)[4][4], uint32_t (&dsa)[4][4],
    uint32_t (&dsl)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 8 + tq * 2 + (e & 1);
      const int i = e >> 1;
      p[e] = exp2_approx(fmaf(s[j * 4 + e], sl, fmaf(-ls[c], kLog2e, kb2[i])));
      if (DIAG && c < row + 8 * i) p[e] = 0.f;
      ds[e] = p[e] * (dp[j * 4 + e] - dd[c]);
    }
    const int f = (j & 1) * 2;
    split_bf16(p[0], p[1], pa[j >> 1][f], pl[j >> 1][f]);
    split_bf16(p[2], p[3], pa[j >> 1][f + 1], pl[j >> 1][f + 1]);
    split_bf16(ds[0], ds[1], dsa[j >> 1][f], dsl[j >> 1][f]);
    split_bf16(ds[2], ds[3], dsa[j >> 1][f + 1], dsl[j >> 1][f + 1]);
  }
}

// One block per (batch * head, 64 key rows). Shared memory: K and V of
// the block's rows, then NS stages of Q, dO, lse and D, the
// barriers. The transposed scores S^T = K Q^T and dP^T = V dO^T come out
// with keys as rows, so P^T and dS^T are the A operands of dV += P^T dO
// and dK += dS^T Q in registers.
template <int HD>
__global__ void __launch_bounds__(Plan<HD, true>::THREADS,
                                  Plan<HD, true>::BLOCKS)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_g,
                           const float* __restrict__ lse,
                           const float* __restrict__ dD,
                           const int32_t* __restrict__ mask,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int Tlen, int H, int causal, float scale) {
  using G = Box<HD>;
  using P = Plan<HD, true>;
  constexpr int NS = stages<HD>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sp = smem_raw + (base - raw);
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + G::TILE;
  const uint32_t q_s = v_s + G::TILE;
  const uint32_t g_s = q_s + NS * G::TILE;
  const uint32_t l_off = g_s + NS * G::TILE - base;  // [NS][64]
  const uint32_t dd_off = l_off + NS * kTile * 4;    // [NS][64]
  const uint32_t full = base + dd_off + NS * kTile * 4;
  const uint32_t empty = full + 8 * NS;
  const uint32_t own = empty + 8 * NS;

  // a head's key tiles are neighbouring blocks, heaviest first, so the
  // blocks on the card at once share their heads' Q, dO, lse and D in L2
  const int n_q = (Tlen + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_q;
  const int b = bh / H;
  const int h = bh - b * H;
  const int jk = blockIdx.x - bh * n_q;
  const int k0 = jk * kTile;
  const int first = causal ? jk : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, P::CONSUMERS * 4);
    }
    bar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == P::CONSUMERS) {
    // producer: its first warp streams; lane 0 issues every TMA copy
    regs_dec<P::PRODUCER_REGS>();
    if (threadIdx.x >= P::CONSUMERS * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      bar_expect(own, 2 * G::TILE);
      for (int c = 0; c < G::NBOX; ++c) {
        const uint32_t off = c * G::BOX;
        tma_4d(k_s + off, &tm_k, own, c * G::BOXW, h, k0, b);
        tma_4d(v_s + off, &tm_v, own, c * G::BOXW, h, k0, b);
      }
    }
    const float* lse_row = lse + static_cast<size_t>(bh) * Tlen;
    const float* d_row = dD + static_cast<size_t>(bh) * Tlen;
    for (int it = first; it < n_q; ++it) {
      const int n = it - first;
      const int st = n % NS;
      bar_wait(empty + 8 * st, ((n / NS) & 1) ^ 1);
      // the tile's lse and D rows (0 past T) by 4-byte cp.async that the
      // full barrier also waits for: a row of [B, H, T] float32 starts
      // 16-byte aligned only when T is a multiple of 4, which a TMA box's
      // start needs
      const uint32_t bar = full + 8 * st;
      for (int c = lane; c < kTile; c += 32) {
        const int t = it * kTile + c;
        const int at = t < Tlen ? t : 0;
        cp_async4(base + l_off + (st * kTile + c) * 4, lse_row + at,
                  t < Tlen);
        cp_async4(base + dd_off + (st * kTile + c) * 4, d_row + at,
                  t < Tlen);
      }
      cp_async_arrive(bar);
      __syncwarp();
      if (lane == 0) {
        bar_expect(bar, 2 * G::TILE);
        for (int c = 0; c < G::NBOX; ++c) {
          const uint32_t off = st * G::TILE + c * G::BOX;
          tma_4d(q_s + off, &tm_q, bar, c * G::BOXW, h, it * kTile, b);
          tma_4d(g_s + off, &tm_g, bar, c * G::BOXW, h, it * kTile, b);
        }
      }
    }
    return;
  }
  regs_inc<P::CONSUMER_REGS>();

  // consumers: warpgroup wg keeps output columns c0 .. c0 + COLS of the
  // block's 64 key rows
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int c0 = wg * P::COLS;
  const int row = warp * 16 + gq;  // and row + 8
  const float sl = scale * kLog2e;

  float kb2[2];  // the key-mask bias of the warp's two key rows, log2 units
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + row + 8 * i;
    kb2[i] = t < Tlen && mask[static_cast<size_t>(b) * Tlen + t] > 0
                 ? 0.f
                 : kNegInf * kLog2e;
  }
  float dk_acc[P::NPART][P::NW / 2], dv_acc[P::NPART][P::NW / 2];
#pragma unroll
  for (int p = 0; p < P::NPART; ++p)
#pragma unroll
    for (int e = 0; e < P::NW / 2; ++e) dk_acc[p][e] = dv_acc[p][e] = 0.f;

  bar_wait(own, 0);
  for (int it = first; it < n_q; ++it) {
    const int n = it - first;
    const int st = n % NS;
    bar_wait(full + 8 * st, (n / NS) & 1);
    const uint32_t qs = q_s + st * G::TILE;
    const uint32_t gs = g_s + st * G::TILE;
    const float* ls = reinterpret_cast<const float*>(sp + l_off) +
                      st * kTile;
    const float* dd = reinterpret_cast<const float*>(sp + dd_off) +
                      st * kTile;
    float s[32], dp[32];
    first_products<HD>(s, dp, k_s, qs, v_s, gs);
    wg_wait_all();
    keep(s);
    keep(dp);
    uint32_t pa[4][4], pl[4][4], dsa[4][4], dsl[4][4];
    if (causal && it == jk)
      dkv_scores<true>(s, dp, ls, dd, sl, kb2, row, tq, pa, pl, dsa, dsl);
    else
      dkv_scores<false>(s, dp, ls, dd, sl, kb2, row, tq, pa, pl, dsa, dsl);

    // dV += P^T dO and dK += dS^T Q: dO's and Q's rows are this
    // product's K, so B is MN-major
#pragma unroll
    for (int p = 0; p < P::NPART; ++p) {
      keep(dk_acc[p]);
      keep(dv_acc[p]);
    }
    keep(pa);
    keep(pl);
    keep(dsa);
    keep(dsl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < P::NPART; ++p) {
        const uint64_t gb = tile_mn<HD>(gs, kk, c0 + p * P::NW);
        const uint64_t qb = tile_mn<HD>(qs, kk, c0 + p * P::NW);
        wgmma_rs<P::NW>(dv_acc[p], pa[kk], gb);
        wgmma_rs<P::NW>(dk_acc[p], dsa[kk], qb);
        wgmma_rs<P::NW>(dv_acc[p], pl[kk], gb);
        wgmma_rs<P::NW>(dk_acc[p], dsl[kk], qb);
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < P::NPART; ++p) {
      keep(dk_acc[p]);
      keep(dv_acc[p]);
    }
    keep(pa);
    keep(pl);
    keep(dsa);
    keep(dsl);
    if (lane == 0) bar_arrive(empty + 8 * st);
  }
  store_acc<HD, P>(dk, dk_acc, scale, warp, lane, b, k0, Tlen, H, h, c0);
  store_acc<HD, P>(dv, dv_acc, 1.f, warp, lane, b, k0, Tlen, H, h, c0);
}

// ------------------------------------------------------------------ //
// host: launches (tensor maps and preparation in hopper.cuh)
// ------------------------------------------------------------------ //

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const void* o, const void* lse,
                      const void* mask, void* dq, void* dD, int B, int T,
                      int H, int causal, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tg;
  if (!map_rows(&tq, q, B, T, H, HD) || !map_rows(&tk, k, B, T, H, HD) ||
      !map_rows(&tv, v, B, T, H, HD) || !map_rows(&tg, g, B, T, H, HD))
    return cudaErrorInvalidValue;
  using P = Plan<HD, false>;
  auto kernel = flash_bwd_dq_wgmma_kernel<HD>;
  static bool ready = false;
  cudaError_t err = prepare(kernel, P::LAUNCH_REGS, dq_smem<HD>(), &ready);
  if (err != cudaSuccess) return err;
  const unsigned grid = B * H * ((T + kTile - 1) / kTile);
  kernel<<<grid, P::THREADS, dq_smem<HD>(), st>>>(
      tq, tk, tv, tg, static_cast<const bf16*>(o),
      static_cast<const int32_t*>(mask),
      static_cast<const float*>(lse), static_cast<float*>(dD),
      static_cast<bf16*>(dq), T, H, causal, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* dD,
                       const void* mask, void* dk, void* dv, int B, int T,
                       int H, int causal, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tg;
  if (!map_rows(&tq, q, B, T, H, HD) || !map_rows(&tk, k, B, T, H, HD) ||
      !map_rows(&tv, v, B, T, H, HD) || !map_rows(&tg, g, B, T, H, HD))
    return cudaErrorInvalidValue;
  using P = Plan<HD, true>;
  auto kernel = flash_bwd_dkv_wgmma_kernel<HD>;
  static bool ready = false;
  cudaError_t err = prepare(kernel, P::LAUNCH_REGS, dkv_smem<HD>(), &ready);
  if (err != cudaSuccess) return err;
  const unsigned grid = B * H * ((T + kTile - 1) / kTile);
  kernel<<<grid, P::THREADS, dkv_smem<HD>(), st>>>(
      tq, tk, tv, tg, static_cast<const float*>(lse),
      static_cast<const float*>(dD), static_cast<const int32_t*>(mask),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). q, k, v, dO, O, dq, dk, dv:
// bf16 [B, T, H, hd], hd one of 16, 32, 64, 128, 256; mask int32 [B, T];
// lse and D float32 [B, H, T]; every tensor contiguous, the bf16 ones
// 16-byte aligned (TMA). flash_bwd_dq_bf16 writes dq and D;
// flash_bwd_dkv_bf16 reads that D. Each returns cudaGetLastError() after
// its launch (0 = launched), cudaErrorInvalidValue for a shape or tensor
// map it cannot take, or cudaErrorInvalidConfiguration if the kernel was
// not built to launch with the registers its warpgroups split.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* g, const void* o,
                                 const void* lse, const void* mask, void* dq,
                                 void* dD, int B, int T, int H, int hd,
                                 int causal, float scale, void* stream) {
  if (!shape_ok(B, T, H, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HD_DISPATCH(launch_dq, q, k, v, g, o, lse, mask, dq, dD, B, T, H, causal,
              scale, st);
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* g,
                                  const void* lse, const void* dD,
                                  const void* mask, void* dk, void* dv,
                                  int B, int T, int H, int hd, int causal,
                                  float scale, void* stream) {
  if (!shape_ok(B, T, H, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HD_DISPATCH(launch_dkv, q, k, v, g, lse, dD, mask, dk, dv, B, T, H, causal,
              scale, st);
}

// Dynamic shared memory a block of each kernel asks for at head dim hd
// (which 0: dq, 1: dk/dv), for the wrapper's plan to be checked against.
extern "C" int flash_bwd_smem_bytes(int hd, int which) {
  switch (hd) {
    case 16: return which ? dkv_smem<16>() : dq_smem<16>();
    case 32: return which ? dkv_smem<32>() : dq_smem<32>();
    case 64: return which ? dkv_smem<64>() : dq_smem<64>();
    case 128: return which ? dkv_smem<128>() : dq_smem<128>();
    case 256: return which ? dkv_smem<256>() : dq_smem<256>();
    default: return -1;
  }
}
