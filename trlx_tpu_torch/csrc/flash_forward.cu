// Flash attention forward for bfloat16 on Hopper (sm_90a): O and the
// float32 logsumexp on wgmma, with Q, K and V brought in by TMA.
//
// Replaces: trlx_tpu/ops/pallas_attention.py
//   - flash_fwd_wgmma_kernel <- _flash_fwd_kernel (:42), launched by
//     _flash_forward (pallas_call :157).
// It computes what the TPU kernel computes: O = softmax(q k^T / sqrt(hd)
// + bias) v and lse = m + log(l), float32 [B, H, T], with the bias 0 /
// -1e9 from the raw [B, T] key mask plus -1e9 above the diagonal when
// causal. q, k, v and O are [B, T, H, hd] bf16, hd 16, 32, 64, 128 or
// 256; O is rounded once to bf16. The float32 forward stays on the CUDA
// cores in flash_attention.cu.
//
// Rounding (tests/test_torch_flash_attention.py models it): scores in
// float32 with the bias, the running max from -1e30, P rounded once to
// bf16 before P V while the row sum takes P unrounded, O divided once by
// max(l, 1e-30); a fully left-padded query row stays a finite
// near-uniform average.
//
// What bounds it on an H100. At the training shape (B 32, T 576, H 12,
// hd 64, causal) it must move about 114 MB (q, k, v in, O out, the mask
// and lse: ~34 us at 3.35 TB/s) against ~18 GFLOP of live causal
// products (~18 us at 989 TF/s): bytes bound it; at T 2048 operations
// do. Beyond the bytes: the K and V tiles each block streams from L2 (its
// head's keys up to its diagonal), each block's fixed cost (its Q load
// before the first product, its epilogue), and a tile's serial chain
// S = Q K^T, then the softmax (4096 exponentials a 64 x 64 tile on the
// special-function unit, 16 a cycle an SM), then O += P V.
//
// Design:
//   - one block per (batch * head, 64 CONSUMERS query rows), a consumer
//     warpgroup owning 64 of them (wgmma's M), and a producer warpgroup
//     that hands the consumers its registers (setmaxnreg). To hd 64 one
//     consumer a block, 136 registers a thread, three blocks an SM, so
//     one block's loads, prologue and epilogue run under the others'
//     tiles; from hd 128 two consumers that share each K and V tile, one
//     block an SM (their 240 registers a thread hold O's whole head dim;
//     at hd 256 S is so formed once per row block, where the mma.sync
//     forward formed it twice). A head's blocks are neighbours in the
//     grid, heaviest causal block first, so the blocks on the card at
//     once share their heads' K and V in the 50 MB L2 (head-minor, as the
//     mma.sync forward was, hundreds of heads' tiles are in flight).
//   - the producer (FwdPlan; each launch checks that ptxas gave the
//     register count its setmaxnreg split assumes, as the backward does):
//     its first warp's lane 0 issues every tile load as TMA copies of 4-D
//     boxes (hopper.cuh map_rows: dims (hd, H, T, B), box (min(hd, 64), 1, 64,
//     1), swizzled at the box row's width): Q once behind its own
//     mbarrier, K and V through a ring of stages (four to hd 128, two at
//     256) with full and empty mbarriers of their own, so K runs ahead of
//     V. The tile's 64 key-mask entries (0 past T) the warp's lanes copy
//     by 4-byte cp.async that K's full barrier also waits for: a TMA box
//     must start 16-byte aligned, and a row of T int32 values is only
//     when 4 divides T. Rows past T come back as zeros (TMA's
//     out-of-bounds fill) and are never written.
//   - a consumer's tile: S = Q K^T is wgmma m64n64k16 with both operands
//     K-major in shared memory; the softmax runs on the accumulators in
//     registers (scale * log2 e and the key-mask bias in one FMA, the
//     causal test only in the diagonal tile's own round, exp2 by
//     ex2.approx; a row lives in a quad of lanes, its sum a per-lane
//     partial until the end); P, rounded once to bf16, is the register A
//     operand of O += P V, with V read MN-major (trans-b). No hi + lo
//     split. A round waits for each product before the next step
//     (serial_round), so only O and one of S or P are live; the SM
//     overlaps the chain across its warpgroups (one's softmax under
//     another's products), not within one.
//   - epilogue: O divided once, rounded once to bf16, staged in the
//     warpgroup's own Q tile (the TMA swizzle, so no bank conflict) and
//     written with 16-byte stores, rows below T only; lse by one lane a
//     row. No atomics: each output element is written by one thread. Key
//     tiles wholly above a warpgroup's diagonal are never computed (a
//     block's lower warpgroup passes over its upper one's diagonal tile).
// ptxas (-Xptxas -v, printed by chip_smoke.py at build time) gives each
// instance's registers at launch (80 to hd 64, 168 beyond; the consumers'
// 136 and 240 after setmaxnreg) and any spill.

#include "hopper.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// The block's plan at head dim HD: CONSUMERS warpgroups of 64 query rows
// each and the producer, BLOCKS blocks an SM (see the design note above).
// A block launches with the register file over its threads and blocks
// (rounded down to 8, as __launch_bounds__ caps ptxas). The producer is
// a warpgroup, as setmaxnreg moves registers four warps at a time: the
// consumers take all but 24 a thread of the producer's (in multiples of
// 8) and the producer keeps the rest.
template <int HD>
struct FwdPlan {
  static constexpr int CONSUMERS = HD <= 64 ? 1 : 2;
  static constexpr int BLOCKS = HD <= 64 ? 3 : 1;
  static constexpr int ROWS = kTile * CONSUMERS;  // query rows a block
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int LAUNCH_REGS = 65536 / (THREADS * BLOCKS) / 8 * 8;
  static constexpr int CONSUMER_REGS =
      ((CONSUMERS + 1) * LAUNCH_REGS - 24) / CONSUMERS / 8 * 8;
  static constexpr int PRODUCER_REGS =
      (CONSUMERS + 1) * LAUNCH_REGS - CONSUMERS * CONSUMER_REGS;
  static constexpr int NW = HD < 64 ? HD : 64;  // N of one P V product
  static constexpr int NPART = HD / NW;         // products a k-step
  static constexpr int STAGES = HD <= 128 ? 4 : 2;
  static_assert(CONSUMER_REGS % 8 == 0 && CONSUMER_REGS <= 256,
                "setmaxnreg takes multiples of 8 up to 256");
  static_assert(PRODUCER_REGS >= 24 && PRODUCER_REGS % 8 == 0,
                "setmaxnreg takes multiples of 8 from 24");
};

// dynamic shared memory: 1 KB to align the tiles to the 128 B swizzle's
// 1024 B period, the consumers' Q tiles, the stages of K, V and the key
// mask, the mbarriers (full and empty of K and of V a stage, Q's own)
template <int HD>
constexpr int fwd_smem() {
  using G = Box<HD>;
  using P = FwdPlan<HD>;
  constexpr int NS = P::STAGES;
  return 1024 + P::CONSUMERS * G::TILE + 2 * NS * G::TILE + NS * kTile * 4 +
         8 * (4 * NS + 1);
}

// one block within a block's 227 KB; BLOCKS of them within the SM's 228
// KB, 1 KB of it reserved for each block, where the plan runs several
template <int HD>
constexpr bool fwd_fits() {
  return fwd_smem<HD>() <= 232448 &&
         (HD > 64 || FwdPlan<HD>::BLOCKS * (fwd_smem<HD>() + 1024) <= 233472);
}
static_assert(fwd_fits<16>() && fwd_fits<32>() && fwd_fits<64>() &&
                  fwd_fits<128>() && fwd_fits<256>(),
              "the forward's blocks exceed shared memory");

// named barrier `id` over N threads
template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// a byte offset within one box of the tile as the swizzle places it:
// bits 4.. (the 16-byte chunk) XOR bits 7.. (the row, at RW 128)
template <int HD>
__device__ __forceinline__ uint32_t swizzled(uint32_t off) {
  return off ^ (((off >> 7) & (Box<HD>::RW / 16 - 1)) << 4);
}

// A tile's wgmma descriptors are its first box's plus a constant: the
// address field counts 16-byte units, and no offset within the block's
// shared memory carries out of it. K-major k-step kk (hopper.cuh
// tile_k): its box, then 32 B a step within the box's swizzled rows.
template <int HD>
__device__ __forceinline__ uint64_t step_k(uint64_t d, int kk) {
  using G = Box<HD>;
  constexpr int PER = G::BOXW / 16;  // k-steps a box holds
  return d + (((kk / PER) * G::BOX + (kk % PER) * 32) >> 4);
}

// MN-major rows 16 kk .. 16 kk + 15, columns col .. (hopper.cuh tile_mn)
template <int HD>
__device__ __forceinline__ uint64_t step_mn(uint64_t d, int kk, int col) {
  using G = Box<HD>;
  return d + (((col / G::BOXW) * G::BOX + kk * 16 * G::RW) >> 4);
}

// issue S = Q K^T of one tile from the Q and K tiles' descriptors, the
// first k-step overwriting s (the caller fenced, commits and waits)
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[32], uint64_t qd,
                                        uint64_t kd) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64(s, step_k<HD>(qd, kk), step_k<HD>(kd, kk), kk > 0);
}

// issue O += P V of one tile from the V tile's descriptor: V's rows are
// this product's K, so B is MN-major; k-step kk is keys 16 kk .. + 15
template <int HD, class P>
__device__ __forceinline__ void issue_pv(float (&acc)[P::NPART][P::NW / 2],
                                         const uint32_t (&pa)[4][4],
                                         uint64_t vd) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < P::NPART; ++p)
      wgmma_rs<P::NW>(acc[p], pa[kk], step_mn<HD>(vd, kk, p * P::NW));
}

// O's accumulators times each row's alpha (rows g, g + 8 of the warp's
// 16: elements 0, 1 and 2, 3 of each n-tile)
template <class P>
__device__ __forceinline__ void rescale(float (&acc)[P::NPART][P::NW / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int p = 0; p < P::NPART; ++p)
#pragma unroll
    for (int e = 0; e < P::NW / 2; ++e) acc[p][e] *= alpha[(e >> 1) & 1];
}

template <class P>
__device__ __forceinline__ void keep_acc(float (&acc)[P::NPART][P::NW / 2]) {
#pragma unroll
  for (int p = 0; p < P::NPART; ++p) keep(acc[p]);
}

// One tile's online softmax on a consumer thread's S accumulators: rows
// r = row, row + 8 of the warpgroup's 64 (i = 0, 1), columns c = 8 j +
// 2 t + (e & 1) of the key tile in s[4 j + e]. The scores become log2
// units with the bias, m the rows' new running max (a row lives in the
// quad's four lanes), alpha = 2^(m_old - m) for l and O, and s = P =
// 2^(s - m), whose sum joins the lane's partial l. The key-mask bias of
// the thread's column pair comes by one 8-byte read; DIAG (the causal
// diagonal tile, a round of its own) masks c > r.
template <bool DIAG>
__device__ __forceinline__ void softmax_tile(float (&s)[32],
                                             const int32_t* ms, float sl,
                                             int row, int tq, float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2]) {
  float mt[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int2 keys = *reinterpret_cast<const int2*>(ms + j * 8 + tq * 2);
    const float kb[2] = {keys.x > 0 ? 0.f : kNegInf * kLog2e,
                         keys.y > 0 ? 0.f : kNegInf * kLog2e};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float bias = kb[e & 1];
      if (DIAG && row + 8 * i < j * 8 + tq * 2 + (e & 1))
        bias += kNegInf * kLog2e;
      s[j * 4 + e] = fmaf(s[j * 4 + e], sl, bias);
      mt[i] = fmaxf(mt[i], s[j * 4 + e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    alpha[i] = exp2_approx(m[i] - mt[i]);
    m[i] = mt[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      s[j * 4 + e] = exp2_approx(s[j * 4 + e] - m[i]);
      l[i] += s[j * 4 + e];
    }
}

// a / b rounded once, as IEEE division gives it, from rb = the correctly
// rounded 1 / b: the quotient a rb and one FMA correction (Markstein's
// theorem, for b and a / b in the normal range: O's row sums are at
// least 1), three operations where a division takes a dozen
__device__ __forceinline__ float divide(float a, float b, float rb) {
  const float q = a * rb;
  return fmaf(fmaf(-q, b, a), rb, q);
}

// P rounded once to bf16 as A fragments: the accumulators of n-tiles
// 2 kk, 2 kk + 1 are k-step kk
__device__ __forceinline__ void pack_p(const float (&s)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j >> 1][(j & 1) * 2] = pack_bf16(s[j * 4], s[j * 4 + 1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j * 4 + 2], s[j * 4 + 3]);
  }
}

// A consumer's view of the block's shared memory: the descriptors of its
// Q tile and of the first K and V stages, the key-mask rows, the ring's
// barriers.
struct Ring {
  uint64_t q, k, v;
  uint32_t full_k, full_v, empty_k, empty_v;
  const int32_t* mask;
};

// Round jt: tile jt's S, its softmax, then its P V,
// each product waited for before the next step, the K stage released
// after the softmax and the V stage after P V. Of the registers only O's
// accumulators and one of S or P are live at a time, so more warpgroups
// fit an SM.
template <bool DIAG, int HD, class P>
__device__ __forceinline__ void serial_round(
    const Ring& r, int jt, float sl, int row, int tq, int lane,
    float (&s)[32], uint32_t (&pa)[4][4], float (&acc)[P::NPART][P::NW / 2],
    float (&m)[2], float (&l)[2]) {
  using G = Box<HD>;
  constexpr int NS = P::STAGES;
  const int st = jt % NS;
  const uint32_t parity = (jt / NS) & 1;
  bar_wait(r.full_k + 8 * st, parity);
  keep(s);
  wg_fence();
  issue_s<HD>(s, r.q, r.k + (st * G::TILE >> 4));
  wg_commit();
  wg_wait<0>();
  keep(s);
  float alpha[2];
  softmax_tile<DIAG>(s, r.mask + st * kTile, sl, row, tq, m, l, alpha);
  if (lane == 0) bar_arrive(r.empty_k + 8 * st);
  pack_p(s, pa);
  rescale<P>(acc, alpha);
  bar_wait(r.full_v + 8 * st, parity);
  keep_acc<P>(acc);
  keep(pa);
  wg_fence();
  issue_pv<HD, P>(acc, pa, r.v + (st * G::TILE >> 4));
  wg_commit();
  wg_wait<0>();
  keep_acc<P>(acc);
  if (lane == 0) bar_arrive(r.empty_v + 8 * st);
}

// One block per (batch * head, 64 CONSUMERS query rows). Shared memory: the
// consumers' Q tiles, then the stages of K, V and the key mask, the
// barriers (full K, full V, empty K, empty V a stage; Q's own).
template <int HD>
__global__ void __launch_bounds__(FwdPlan<HD>::THREADS, FwdPlan<HD>::BLOCKS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const int32_t* __restrict__ mask,
                       bf16* __restrict__ out, float* __restrict__ lse,
                       int Tlen, int H, int causal, float scale) {
  using G = Box<HD>;
  using P = FwdPlan<HD>;
  constexpr int NS = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sp = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + P::CONSUMERS * G::TILE;
  const uint32_t v_s = k_s + NS * G::TILE;
  const uint32_t m_off = v_s + NS * G::TILE - base;  // [NS][64]
  const uint32_t full_k = base + m_off + NS * kTile * 4;
  const uint32_t full_v = full_k + 8 * NS;
  const uint32_t empty_k = full_v + 8 * NS;
  const uint32_t empty_v = empty_k + 8 * NS;
  const uint32_t own = empty_v + 8 * NS;

  // a head's blocks are neighbours, heaviest first, so the blocks on the
  // card at once share their heads' K and V in L2
  const int n_blk = (Tlen + P::ROWS - 1) / P::ROWS;
  const int bh = blockIdx.x / n_blk;
  const int ib = n_blk - 1 - (blockIdx.x - bh * n_blk);
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = ib * P::ROWS;
  const int t0 = q0 / kTile;  // the block's first 64-row tile
  const int n_k = (Tlen + kTile - 1) / kTile;
  // consumers with rows below T, and the key tiles the block streams
  const int live = min(P::CONSUMERS, n_k - t0);
  const int n_live = causal ? t0 + live : n_k;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      bar_init(full_k + 8 * s, 1);
      bar_init(full_v + 8 * s, 1);
      bar_init(empty_k + 8 * s, live * 4);
      bar_init(empty_v + 8 * s, live * 4);
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
      bar_expect(own, live * G::TILE);
      for (int w = 0; w < live; ++w)
        for (int c = 0; c < G::NBOX; ++c)
          tma_4d(q_s + w * G::TILE + c * G::BOX, &tm_q, own, c * G::BOXW, h,
                 q0 + w * kTile, b);
    }
    for (int jt = 0; jt < n_live; ++jt) {
      const int st = jt % NS;
      const uint32_t phase = ((jt / NS) & 1) ^ 1;
      bar_wait(empty_k + 8 * st, phase);
      // the tile's 64 key-mask entries (0 past T) by 4-byte cp.async that
      // K's full barrier also waits for
      const uint32_t fk = full_k + 8 * st;
      for (int c = lane; c < kTile; c += 32) {
        const int t = jt * kTile + c;
        cp_async4(base + m_off + (st * kTile + c) * 4,
                  mask + static_cast<size_t>(b) * Tlen + (t < Tlen ? t : 0),
                  t < Tlen);
      }
      cp_async_arrive(fk);
      __syncwarp();
      if (lane == 0) {
        bar_expect(fk, G::TILE);
        for (int c = 0; c < G::NBOX; ++c)
          tma_4d(k_s + st * G::TILE + c * G::BOX, &tm_k, fk, c * G::BOXW, h,
                 jt * kTile, b);
      }
      bar_wait(empty_v + 8 * st, phase);
      if (lane == 0) {
        const uint32_t fv = full_v + 8 * st;
        bar_expect(fv, G::TILE);
        for (int c = 0; c < G::NBOX; ++c)
          tma_4d(v_s + st * G::TILE + c * G::BOX, &tm_v, fv, c * G::BOXW, h,
                 jt * kTile, b);
      }
    }
    return;
  }
  if (wg >= live) return;  // every row of this warpgroup is past T
  regs_inc<P::CONSUMER_REGS>();

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63, its 64-row
  // tile iq; it computes key tiles 0 .. last and passes over the rest
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int row = warp * 16 + gq;  // and row + 8
  const int iq = t0 + wg;
  const int last = causal ? iq : n_k - 1;
  const uint32_t qs = q_s + wg * G::TILE;
  const float sl = scale * kLog2e;
  const Ring ring{desc_k<HD>(qs), desc_k<HD>(k_s), desc_mn<HD>(v_s),
                  full_k, full_v, empty_k, empty_v,
                  reinterpret_cast<const int32_t*>(sp + m_off)};

  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};
  float acc[P::NPART][P::NW / 2];
#pragma unroll
  for (int p = 0; p < P::NPART; ++p)
#pragma unroll
    for (int e = 0; e < P::NW / 2; ++e) acc[p][e] = 0.f;
  float s[32] = {};  // the first k-step of each S overwrites it
  uint32_t pa[4][4];

  bar_wait(own, 0);
  // tiles 0 .. last - 1, then the last (the causal diagonal tile) in a
  // round of its own, so no round tests for the diagonal
  for (int jt = 0; jt < last; ++jt)
    serial_round<false, HD, P>(ring, jt, sl, row, tq, lane, s, pa, acc,
                               m_r, l_r);
  if (causal)
    serial_round<true, HD, P>(ring, last, sl, row, tq, lane, s, pa, acc,
                              m_r, l_r);
  else
    serial_round<false, HD, P>(ring, last, sl, row, tq, lane, s, pa, acc,
                               m_r, l_r);
  // the block's tiles past this warpgroup's diagonal (the other's
  // diagonal tile): released unread
  for (int jt = last + 1; jt < n_live; ++jt) {
    const int st = jt % NS;
    bar_wait(full_k + 8 * st, (jt / NS) & 1);
    bar_wait(full_v + 8 * st, (jt / NS) & 1);
    if (lane == 0) {
      bar_arrive(empty_k + 8 * st);
      bar_arrive(empty_v + 8 * st);
    }
  }

  // the quad's row sums; lse = m + log(l); O divided once
  float l_safe[2], l_inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_safe[i] = fmaxf(l, 1e-30f);
    l_inv[i] = __frcp_rn(l_safe[i]);
    const int t = q0 + wg * kTile + row + 8 * i;
    if (tq == 0 && t < Tlen)
      lse[static_cast<size_t>(bh) * Tlen + t] =
          m_r[i] * kLn2 + logf(l_safe[i]);
  }
  // O rounded once to bf16, staged in the warpgroup's own Q tile (every
  // warp of it is past its last product) where the swizzle puts each
  // 16-byte chunk, then 16-byte stores of the rows below T
  unsigned char* const stage = sp + (qs - base);
  named_sync<128>(1 + wg);
#pragma unroll
  for (int p = 0; p < P::NPART; ++p)
#pragma unroll
    for (int j = 0; j < P::NW / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = p * P::NW + j * 8 + tq * 2;
        const uint32_t off =
            (col / G::BOXW) * G::BOX +
            swizzled<HD>((row + 8 * i) * G::RW + (col % G::BOXW) * 2);
        *reinterpret_cast<uint32_t*>(stage + off) =
            pack_bf16(divide(acc[p][j * 4 + 2 * i], l_safe[i], l_inv[i]),
                      divide(acc[p][j * 4 + 2 * i + 1], l_safe[i], l_inv[i]));
      }
  named_sync<128>(1 + wg);
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  for (int idx = tid; idx < kTile * CH; idx += 128) {
    const int r = idx / CH;
    const int col = (idx - r * CH) * 8;
    const int t = q0 + wg * kTile + r;
    if (t >= Tlen) continue;
    const uint32_t off = (col / G::BOXW) * G::BOX +
                         swizzled<HD>(r * G::RW + (col % G::BOXW) * 2);
    *reinterpret_cast<uint4*>(
        out + ((static_cast<size_t>(b) * Tlen + t) * H + h) * HD + col) =
        *reinterpret_cast<const uint4*>(stage + off);
  }
}

// ------------------------------------------------------------------ //
// host: the launch (tensor maps and preparation in hopper.cuh)
// ------------------------------------------------------------------ //

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* lse, int B, int T,
                       int H, int causal, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!map_rows(&tq, q, B, T, H, HD) || !map_rows(&tk, k, B, T, H, HD) ||
      !map_rows(&tv, v, B, T, H, HD))
    return cudaErrorInvalidValue;
  using P = FwdPlan<HD>;
  auto kernel = flash_fwd_wgmma_kernel<HD>;
  static bool ready = false;
  cudaError_t err = prepare(kernel, P::LAUNCH_REGS, fwd_smem<HD>(), &ready);
  if (err != cudaSuccess) return err;
  const unsigned grid = B * H * ((T + P::ROWS - 1) / P::ROWS);
  kernel<<<grid, P::THREADS, fwd_smem<HD>(), st>>>(
      tq, tk, tv, static_cast<const int32_t*>(mask), static_cast<bf16*>(out),
      static_cast<float*>(lse), T, H, causal, scale);
  return cudaGetLastError();
}

template <int HD>
void plan_of(int* out) {
  using P = FwdPlan<HD>;
  out[0] = P::CONSUMERS;
  out[1] = P::BLOCKS;
  out[2] = P::STAGES;
  out[3] = P::LAUNCH_REGS;
  out[4] = P::PRODUCER_REGS;
  out[5] = P::CONSUMER_REGS;
  out[6] = fwd_smem<HD>();
}

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v, O: bf16 [B, T, H,
// hd], hd one of 16, 32, 64, 128, 256; mask int32 [B, T]; lse float32
// [B, H, T]; every tensor contiguous, q, k, v and O 16-byte aligned (TMA,
// 16-byte stores). Returns cudaGetLastError() after the launch (0 =
// launched), cudaErrorInvalidValue for a shape or tensor map it cannot
// take, or cudaErrorInvalidConfiguration if the kernel was not built to
// launch with the registers its warpgroups split.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* mask, void* out, void* lse, int B,
                              int T, int H, int hd, int causal, float scale,
                              void* stream) {
  if (!shape_ok(B, T, H, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HD_DISPATCH(launch_fwd, q, k, v, mask, out, lse, B, T, H, causal, scale,
              st);
}

// The block's plan at head dim hd, for the wrapper's to be checked
// against: out[0..6] = consumer warpgroups, blocks an SM, stages,
// registers a thread at launch, the producer's and each consumer's after
// setmaxnreg, dynamic shared memory bytes. Returns 0, or -1 for a head
// dim it has no kernel for.
extern "C" int flash_fwd_plan(int hd, int* out) {
  switch (hd) {
    case 16: plan_of<16>(out); return 0;
    case 32: plan_of<32>(out); return 0;
    case 64: plan_of<64>(out); return 0;
    case 128: plan_of<128>(out); return 0;
    case 256: plan_of<256>(out); return 0;
    default: return -1;
  }
}
