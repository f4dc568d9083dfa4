// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA loads and bulk copies, the TMA bulk reduce-add, wgmma with its
// shared-memory descriptors for the 128-byte swizzle, setmaxnreg, named
// barriers, and the host-side encoding of TMA tensor maps through the
// runtime's driver entry point (so a library needs no -lcuda).
//
// Tiles in shared memory are rows of 64 bf16 (128 B) as TMA writes them
// with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r lies at
// r * 128 + ((c ^ (r % 8)) * 16) from a 1024-byte-aligned base. The
// wgmma descriptors below read that layout in both orientations:
//   K-major (the product's contraction runs along the 128-byte row):
//     8-row groups 1024 B apart (SBO); the next k16 slice is +32 B.
//   MN-major (the contraction runs down the rows; imm-trans set):
//     8-row groups 1024 B apart (SBO); the next k16 slice is +2048 B; a
//     sub-tile starting n columns in is +2n B within the 128-byte row.
// f32 (tf32) tiles of 64 columns are two such tiles of 32 columns (128-byte
// rows), 8 KB apart for 64 rows; K-major only, the next k8 slice +32 B.
// int8 tiles of 128-byte rows (the int8_pv V codes, kv contiguous) use
// the same layout, K-major, the next k32 slice +32 B. int8 K tiles have
// 64-byte rows (64 codes of one kv position) and take the 64-byte swizzle
// (CU_TENSOR_MAP_SWIZZLE_64B): chunk c of row r at r * 64 + ((c ^ ((r / 2)
// % 4)) * 16) from a 512-byte-aligned base; K-major, 8-row groups 512 B
// apart (SBO), the next k32 slice +32 B (wgmma_desc_sw64).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::
               "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::
               "r"(smem_addr(bar)) : "memory");
}

// arrive once and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
               "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA and bulk copies

// a 3-D box of a tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a 4-D box of a tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of global
// memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// element-wise f32 add of a shared-memory box into the 2-D tensor map's
// box at (c0, c1), in the bulk-async group of the issuing thread
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.tile"
      ".bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1)
      : "memory");
}

// element-wise f64 add of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) of shared memory into global memory, in the bulk-async
// group of the issuing thread
__device__ __forceinline__ void bulk_reduce_add_f64(double* dst,
                                                    const void* src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f64"
      " [%0], [%1], %2;\n"
      :: "l"(dst), "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

// a shared-memory box into the 4-D tensor map's box at (c0 .. c3), in the
// bulk-async group of the issuing thread; rows out of bounds are not
// written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N of this thread's bulk groups still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (TMA, wgmma) before they read them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- barriers among some warps, and register rebalancing

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---- wgmma

// descriptor of a 128-byte-swizzled operand at shared address `addr`
// (LBO / SBO in bytes)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;          // SWIZZLE_128B
  return d;
}

// the same for the 64-byte swizzle (int8 K tiles of 64-byte rows)
__device__ __forceinline__ uint64_t wgmma_desc_sw64(uint32_t addr,
                                                    uint32_t lbo,
                                                    uint32_t sbo) {
  return (wgmma_desc(addr, lbo, sbo) & ~(static_cast<uint64_t>(3) << 62)) |
         (static_cast<uint64_t>(2) << 62);      // SWIZZLE_64B
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a
// wgmma wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

#define LANDIFF_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64 f32, 32 per thread) (+)= A (64 x 16, shared) . B (16 x 64,
// shared); scale_d = 0 overwrites d
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : LANDIFF_D8(0), LANDIFF_D8(8), LANDIFF_D8(16), LANDIFF_D8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers, the m16n8k16 A
// fragment of each warp's 16 rows) . B (16 x 64, shared)
template <int TransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : LANDIFF_D8(0), LANDIFF_D8(8), LANDIFF_D8(16), LANDIFF_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TransB));
}

// d (64 x 32 f32, 16 per thread) (+)= A (64 x 16, shared) . B (16 x 32,
// shared)
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : LANDIFF_D8(0), LANDIFF_D8(8)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// d (64 x 128 f32, 64 per thread) (+)= A (64 x 16, shared) . B (16 x
// 128, shared); scale_d = 0 overwrites d
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : LANDIFF_D8(0), LANDIFF_D8(8), LANDIFF_D8(16), LANDIFF_D8(24),
        LANDIFF_D8(32), LANDIFF_D8(40), LANDIFF_D8(48), LANDIFF_D8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransA), "n"(TransB));
}

#define LANDIFF_R8(i)                                                   \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 128 s32) (+)= A (64 x 32 s8, shared, K-major) . B (32 x 128 s8,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128_s8(uint32_t (&d)[64],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : LANDIFF_R8(0), LANDIFF_R8(8), LANDIFF_R8(16), LANDIFF_R8(24),
        LANDIFF_R8(32), LANDIFF_R8(40), LANDIFF_R8(48), LANDIFF_R8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 s32) (+)= A (64 x 32 s8, shared, K-major) . B (32 x 64 s8,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64_s8(uint32_t (&d)[32],
                                                uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p;\n}\n"
      : LANDIFF_R8(0), LANDIFF_R8(8), LANDIFF_R8(16), LANDIFF_R8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 s32) (+)= A (64 x 32 s8 in registers) . B (32 x 64 s8,
// shared, K-major)
__device__ __forceinline__ void wgmma_rs_n64_s8(uint32_t (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : LANDIFF_R8(0), LANDIFF_R8(8), LANDIFF_R8(16), LANDIFF_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (64 x 64 f32) (+)= A (64 x 8 tf32 in registers) . B (8 x 64 tf32,
// shared, K-major: 32-bit operands have no transpose); scale_d = 0
// overwrites d. A is each warp's 16 rows: a[0] (row g, k t), a[1] (g + 8,
// t), a[2] (g, t + 4), a[3] (g + 8, t + 4), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void wgmma_rs_n64_tf32(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : LANDIFF_D8(0), LANDIFF_D8(8), LANDIFF_D8(16), LANDIFF_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// x rounded to tf32 (10 mantissa bits, ties away from zero), as the f32
// bit pattern with its low 13 bits clear
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// The 3xTF32 split: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact), so
// a.b = hi.hi + hi.lo + lo.hi up to 2^-21 of |a||b| (lo.lo dropped)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

#undef LANDIFF_R8
#undef LANDIFF_D8

}  // namespace

// ---- host: TMA tensor maps

typedef CUresult (*landiff_encode_tiled_fn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded; null if
// the driver does not offer it
static inline landiff_encode_tiled_fn landiff_encode_tiled() {
  static landiff_encode_tiled_fn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<landiff_encode_tiled_fn>(p);
    }
  }
  return fn;
}

// A tensor map with the given swizzle (by default 128 bytes); dims
// innermost first, strides in bytes of dims 1.. . Rows out of bounds read
// as zeros. Returns 0 or the CUresult of the encoding (-1: no entry
// point).
static inline int landiff_tensor_map(
    CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  landiff_encode_tiled_fn encode = landiff_encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return static_cast<int>(encode(
      map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}
