// Hopper (sm_90a) building blocks shared by the port's kernels
// (flash_forward.cu, flash_backward.cu, paged_decode.cu): 64-row tile
// geometry under a TMA swizzle, mbarriers, TMA box copies,
// thread-block clusters and their distributed shared memory, setmaxnreg,
// wgmma descriptors and instructions, and the host side of tensor maps
// and launch preparation.
// ops/_build.py hashes this header into every kernel library's name, so an
// edit here rebuilds them all.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached
                   // through cudaGetDriverEntryPoint, so no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;  // rows of a tile: wgmma's M and a streamed tile
constexpr float kNegInf = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// Box geometry at head dim HD: a 64-row tile of HD bf16 columns is NBOX
// TMA boxes of BOXW columns, each 64 rows of RW bytes (the swizzle
// width) one after another.
template <int HD>
struct Box {
  static constexpr int BOXW = HD < 64 ? HD : 64;
  static constexpr int NBOX = HD / BOXW;
  static constexpr int RW = BOXW * 2;
  static constexpr int BOX = kTile * RW;   // bytes of one box
  static constexpr int TILE = NBOX * BOX;  // bytes of a 64-row tile
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr int LAYOUT = RW == 128 ? 1 : RW == 64 ? 2 : 3;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ //
// mbarriers and TMA
// ------------------------------------------------------------------ //

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory; its bytes complete a transaction on `bar`
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory (128-byte aligned); its bytes complete a transaction on `bar`
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// one 4-byte value from global to shared memory, asynchronously; zeros
// when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// have `bar` wait for this thread's cp.async copies so far too: its
// pending count rises by one now and falls when they have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive on `bar` once this thread's cp.async copies so far have landed,
// as one of the arrivals its count was initialised with (no increment)
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
      : "memory");
}

// ------------------------------------------------------------------ //
// thread-block clusters
// ------------------------------------------------------------------ //

// every thread of every block of the cluster arrives once a phase, then
// waits for the phase: what a thread wrote to shared memory before its
// arrive is visible to every block's threads after their wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the float at `p` in the shared memory of the cluster's block `rank`
// (distributed shared memory: p is this block's address of the same
// variable)
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// hand registers back to the block's pool / take them from it (the
// whole warpgroup, once, before its role's work)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ //
// wgmma
// ------------------------------------------------------------------ //

// Shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16 B units) and the swizzle layout. A K-major operand
// (rows of the tile are M or N, columns K): LBO 1 (unused under a
// swizzle), SBO the 8-row group (8 RW). An MN-major one (rows are K,
// columns N): SBO the 8-row group along K; LBO, the stride to the next
// box along N, is unused since one instruction reads at most one box.
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  using G = Box<HD>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * G::RW) >> 4) << 32) |
         (static_cast<uint64_t>(G::LAYOUT) << 62);
}

template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  using G = Box<HD>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(G::BOX >> 4) << 16) |
         (static_cast<uint64_t>((8 * G::RW) >> 4) << 32) |
         (static_cast<uint64_t>(G::LAYOUT) << 62);
}

// K-major operand of k-step kk (16 columns) of a 64-row tile at `tile`:
// its box, then 32 B a step within the box's swizzled rows
template <int HD>
__device__ __forceinline__ uint64_t tile_k(uint32_t tile, int kk) {
  using G = Box<HD>;
  constexpr int PER = G::BOXW / 16;  // k-steps a box holds
  return desc_k<HD>(tile + (kk / PER) * G::BOX + (kk % PER) * 32);
}

// MN-major operand: rows 16 kk .. 16 kk + 15 of the tile (the K of the
// product), columns col .. col + NW (col a multiple of BOXW)
template <int HD>
__device__ __forceinline__ uint64_t tile_mn(uint32_t tile, int kk, int col) {
  using G = Box<HD>;
  return desc_mn<HD>(tile + (col / G::BOXW) * G::BOX + kk * 16 * G::RW);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin registers a wgmma reads or writes: before wgmma.fence, so no
// instruction that defines them lands inside the batch (ptxas would then
// serialize the wgmmas), and after wgmma.wait_group, so none reads them
// before the batch is done
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d[64 x 64] += A[64 x 16] B[16 x 64], both from shared memory (K-major);
// with accumulate 0, d = A B (d's old values are not read)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 16] += A[64 x 16] B[16 x 16], A from registers, B from shared
// memory MN-major (trans-b)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B from shared
// memory MN-major (trans-b)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B from shared
// memory MN-major (trans-b)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// the second product of one k-step at NW columns: d += A B
template <int NW>
__device__ __forceinline__ void wgmma_rs(float (&d)[NW / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NW == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (NW == 32) wgmma_rs_n32(d, a, b);
  else wgmma_rs_n64(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit (ex2.approx: relative error ~2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------ //
// host: tensor maps and launch preparation
// ------------------------------------------------------------------ //

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [B, T, H, hd] bf16 tensor as dims (hd, H, T, B), box (min(hd, 64), 1,
// 64, 1), swizzled at the box row's width
bool map_rows(CUtensorMap* map, const void* ptr, int B, int T, int H,
              int hd) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint32_t boxw = hd < 64 ? hd : 64;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * H, row * H * T};
  const cuuint32_t box[4] = {boxw, 1, static_cast<cuuint32_t>(kTile), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      boxw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : boxw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Once per kernel (not on every launch, so launches can be captured into
// a CUDA graph): raise its shared-memory ceiling and carveout, and check
// that it launches with the registers a thread its setmaxnreg split is
// balanced for (fewer would leave the consumers waiting for registers
// the producer never frees).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int regs, int smem, bool* done) {
  if (*done) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs != regs) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // all of the SM's 228 KB as shared memory, for two blocks where they fit
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  *done = err == cudaSuccess;
  return err;
}

bool shape_ok(int B, int T, int H, int hd) {
  return B > 0 && T > 0 && H > 0 &&
         (hd == 16 || hd == 32 || hd == 64 || hd == 128 || hd == 256);
}

#define HD_DISPATCH(LAUNCH, ...)                                 \
  do {                                                           \
    switch (hd) {                                                \
      case 16: return static_cast<int>(LAUNCH<16>(__VA_ARGS__));   \
      case 32: return static_cast<int>(LAUNCH<32>(__VA_ARGS__));   \
      case 64: return static_cast<int>(LAUNCH<64>(__VA_ARGS__));   \
      case 128: return static_cast<int>(LAUNCH<128>(__VA_ARGS__)); \
      default: return static_cast<int>(LAUNCH<256>(__VA_ARGS__));  \
    }                                                            \
  } while (0)

}  // namespace
