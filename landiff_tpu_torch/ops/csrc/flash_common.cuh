// Shared device helpers of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the mask algebra, cp.async, mma.sync and ldmatrix wrappers
// and the tile geometry. Tiles are 64 x 64 with head dim 64; a bf16 tile
// row in shared memory is padded to 72 elements (144 B) so that fragment
// loads hit 32 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim
constexpr int kBQ = 64;         // q rows per tile
constexpr int kBKV = 64;        // kv rows per tile
constexpr int kThreads = 128;   // 4 warps x 16 rows
constexpr int kStrideH = kD + 8;   // bf16 smem row stride (144 B): no bank conflicts
constexpr float kNegInf = -1e30f;

enum MaskKind { kMaskNone = 0, kMaskCausal = 1, kMaskVideoEncoder = 2,
                kMaskVideoDecoder = 3 };

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// The boolean algebra of landiff_tpu/ops/masks.py, evaluated per score. P
// carries the mask descriptor: mask_kind and the VideoMaskLayout integers
// nf, tpf, iqt, pft.
template <class P>
__device__ __forceinline__ bool mask_keep(const P& p, int q, int kv) {
  if (p.mask_kind == kMaskNone) return true;
  if (p.mask_kind == kMaskCausal) return q >= kv;
  const int tpf = p.tpf, pft = p.pft;
  const int fe = p.nf * tpf;
  const int iqe = fe + p.iqt;
  const int sl = iqe + pft * (p.nf - 1);
  const int q_frame = floordiv(q, tpf);
  const int kv_frame = floordiv(kv, tpf);
  const int p_frame = floordiv(q - iqe, pft) + 1;
  if (p.mask_kind == kMaskVideoEncoder) {
    const bool in_frames = kv_frame <= q_frame;
    const bool kv_in_iq = kv >= fe && kv < iqe;
    const bool iq = kv < tpf || (kv_in_iq && kv <= q);
    const bool pq = kv < (p_frame + 1) * tpf || (kv >= fe && kv <= q);
    return (q < fe && in_frames) || (q >= fe && q < iqe && iq) ||
           (q >= iqe && q < sl && pq);
  }
  // kMaskVideoDecoder
  const bool sees = kv < tpf || (kv >= fe && kv < iqe);
  const bool pfp = (kv < fe && kv_frame <= q_frame) ||
                   (kv >= fe && kv < iqe + q_frame * pft);
  const bool pq = kv < (p_frame + 1) * tpf ||
                  (kv >= fe && kv < iqe + p_frame * pft);
  return (q < tpf && sees) || (q >= tpf && q < fe && pfp) ||
         (q >= fe && q < iqe && sees) || (q >= iqe && q < sl && pq);
}

// mask_keep's video branches (mask_kind kMaskVideoEncoder or
// kMaskVideoDecoder) with the frame indices given: q_frame = floor(q / tpf),
// p_frame = floor((q - iqe) / pft) + 1, kv_frame = floor(kv / tpf), iqe =
// nf * tpf + iqt, so that a kernel may divide once per row and column of a
// tile and not per score (the flash backward). The same algebra as
// mask_keep's, kept beside it and not called by it: with mask_keep built on
// it the forward kernels, at 128 registers, were allocated otherwise and
// some variants ran 2-15 % slower (PERF.md). To be unified when the
// forwards are rewritten (ROADMAP).
template <class P>
__device__ __forceinline__ bool keep_frames(const P& p, int q, int q_frame,
                                            int p_frame, int kv,
                                            int kv_frame) {
  const int tpf = p.tpf, pft = p.pft;
  const int fe = p.nf * tpf;
  const int iqe = fe + p.iqt;
  const int sl = iqe + pft * (p.nf - 1);
  if (p.mask_kind == kMaskVideoEncoder) {
    const bool in_frames = kv_frame <= q_frame;
    const bool kv_in_iq = kv >= fe && kv < iqe;
    const bool iq = kv < tpf || (kv_in_iq && kv <= q);
    const bool pq = kv < (p_frame + 1) * tpf || (kv >= fe && kv <= q);
    return (q < fe && in_frames) || (q >= fe && q < iqe && iq) ||
           (q >= iqe && q < sl && pq);
  }
  // kMaskVideoDecoder
  const bool sees = kv < tpf || (kv >= fe && kv < iqe);
  const bool pfp = (kv < fe && kv_frame <= q_frame) ||
                   (kv >= fe && kv < iqe + q_frame * pft);
  const bool pq = kv < (p_frame + 1) * tpf ||
                  (kv >= fe && kv < iqe + p_frame * pft);
  return (q < tpf && sees) || (q >= tpf && q < fe && pfp) ||
         (q >= fe && q < iqe && sees) || (q >= iqe && q < sl && pq);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16- and 4-byte async copies; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One 64-row x 64-column bf16 tile of a BSHD tensor (rows row0 .. row0+63
// of batch b, head h; row stride H*D) into padded shared memory, 512
// 16-byte chunks over 128 threads. Rows >= n_rows are zero-filled.
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* base, int row0, int n_rows,
    int b, int h, int H, int tid) {
  const size_t row_stride = static_cast<size_t>(H) * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3, col = (c & 7) * 8;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    const __nv_bfloat16* src =
        base + (static_cast<size_t>(b) * n_rows + (ok ? row : 0)) * row_stride +
        static_cast<size_t>(h) * kD + col;
    cp_async16(&dst[r * kStrideH + col], src, ok ? 16 : 0);
  }
}

}  // namespace
