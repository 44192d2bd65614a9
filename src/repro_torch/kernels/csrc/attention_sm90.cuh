// Hopper (sm_90a) building blocks of the tensor-core attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): TMA tile loads completing on
// mbarriers, wgmma descriptors of 128-byte-swizzled bf16 tiles, the wgmma
// products the kernels issue, and the host-side tensor maps.
//
// Tile layout.  A tile is 64 rows of D bf16 values (one row of a (head,
// batch) slice per sequence position), stored as D/64 chunks of 64 x 64
// values, 8 KiB each; a chunk's row r holds 128 bytes at r * 128 whose
// 16-byte groups are permuted by the 128-byte swizzle (group j at
// j ^ (r % 8)), which TMA applies on load and the wgmma descriptors undo.
// Every tile starts on a 1024-byte boundary.  Read as a wgmma operand the
// same tile serves two ways:
//   K-major (the reduction runs along D, e.g. Q and K in Q K^T): rows 128 B
//   apart, 8-row groups 1024 B apart (SBO); a 16-wide k step is +32 B
//   inside a chunk, the next chunk +8 KiB;
//   MN-major (the reduction runs along the rows, e.g. V in P V): a 16-row k
//   step is +2 KiB, 8-row groups 1024 B apart (SBO), the next 64 columns of
//   N one chunk (LBO = 8 KiB) further.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace repro_sm90 {

constexpr int CHUNK_BYTES = 8192;   // 64 rows x 64 bf16 values
constexpr int KSTEP_BYTES_MN = 2048;  // 16 rows of a chunk: one MN-major k step

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to a 1024-byte boundary (the
// 128-byte swizzle repeats every 1024 bytes of address; launch with 1024
// bytes of slack).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces ``bytes`` of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase ``parity`` has completed.  A wait that
// lasts ~10 s (a schedule that can never complete) traps, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  long long t0 = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 1024) t0 = clock64();
    if (n > 1024 && (n & 1023) == 0 && clock64() - t0 > 20000000000LL) __trap();
  }
}

// ---- TMA -------------------------------------------------------------------

// The box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into shared
// memory; its bytes complete on ``bar``.  Out-of-range elements read as 0.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// All D/64 chunks of the tile of rows row0.. of (head, batch) into ``dst``.
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int head, int row0, int batch) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load_4d(dst + c * CHUNK_BYTES, map, bar, c * 64, head, row0, batch);
}

// Make this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma operands); follow with a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand starting at shared address
// ``saddr``: SBO 1024 B (8-row groups), LBO ``lbo`` bytes (the next 64
// columns of an MN-major operand; unused for K-major).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>(1024u >> 4) << 32) | (1ull << 62);
}

// K-major operand: k step ``kk`` (16 values of D) of the tile at ``tile``.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * CHUNK_BYTES + (kk & 3) * 32, 16);
}

// MN-major operand: k step ``kk`` (16 rows) of the tile at ``tile``.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * KSTEP_BYTES_MN, CHUNK_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin accumulator registers at this point of the program (after a wait,
// before a product): the compiler may not move their reads or writes
// across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two f32 values as a packed bf16 pair (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragment of a 64 x N product (m64nNk16, 128 threads): value i
// of thread t sits at row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2),
// column 8 * (i / 4) + 2 * (t % 4) + i % 2.  The A fragment of k step kk
// (16 columns) of the same rows is then values 8kk .. 8kk + 7 as pairs.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&d)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
}

// The products (PTX ISA, "wgmma.mma_async"): D(64 x N) = A(64 x 16) B(16 x N)
// + (accumulate ? D : 0), bf16 in, f32 accumulate.  SS: A and B from shared
// memory; RS: A from registers.  TA / TB: 0 = K-major, 1 = MN-major.

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// ---- tiles of positions ----------------------------------------------------

// One tile's rows of a (S,) position / segment row, read by one warp: the
// bounds of its valid entries (pos >= 0), whether all 64 rows are valid,
// and lane l's rows l and l + 32 (pos -1, seg ``pad_seg`` past S).
struct TileRows {
  repro_attn::Bounds b;
  int all;
  int p0, s0, p1, s1;
};

__device__ __forceinline__ TileRows warp_tile_rows(const int* pos, const int* seg, int row0, int S,
                                                   int pad_seg) {
  const int lane = threadIdx.x & 31;
  const int r0 = row0 + lane, r1 = r0 + 32;
  TileRows t;
  t.p0 = r0 < S ? pos[r0] : -1;
  t.s0 = r0 < S ? seg[r0] : pad_seg;
  t.p1 = r1 < S ? pos[r1] : -1;
  t.s1 = r1 < S ? seg[r1] : pad_seg;
  repro_attn::Bounds b{0, repro_attn::BIG, -repro_attn::BIG, repro_attn::BIG, -repro_attn::BIG};
  if (t.p0 >= 0) b = {1, t.p0, t.p0, t.s0, t.s0};
  if (t.p1 >= 0) {
    b.any = 1;
    b.pmin = min(b.pmin, t.p1);
    b.pmax = max(b.pmax, t.p1);
    b.smin = min(b.smin, t.s1);
    b.smax = max(b.smax, t.s1);
  }
  t.b = repro_attn::warp_reduce_bounds(b);
  t.all = __all_sync(0xffffffffu, (t.p0 >= 0) && (t.p1 >= 0));
  return t;
}

// Does every (q, k) pair of the two tiles pass pair_ok?  Then the tile
// needs no mask: all rows valid, one segment on both sides, causal with the
// latest key not after the earliest query, the window keeping the earliest
// key for the latest query.
__device__ __forceinline__ bool tile_full(const TileRows& q, const TileRows& k, int causal,
                                          int window) {
  bool ok = q.all && k.all && q.b.smin == q.b.smax && k.b.smin == k.b.smax && q.b.smin == k.b.smin;
  if (causal) ok = ok && k.b.pmax <= q.b.pmin;
  if (window > 0) ok = ok && k.b.pmin > q.b.pmax - window;
  return ok;
}

}  // namespace repro_sm90

// ---- host ----------------------------------------------------------------

namespace repro_sm90_host {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no link against
// libcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a contiguous bf16 (batch, seq, heads, D) array, read in
// boxes of 64 rows of one (head, batch) by 64 values of D with the 128-byte
// swizzle; rows past ``seq`` read as zeros.
inline cudaError_t tile_map(CUtensorMap* map, const void* base, int batch, int seq, int heads,
                            int D) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)seq * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace repro_sm90_host
