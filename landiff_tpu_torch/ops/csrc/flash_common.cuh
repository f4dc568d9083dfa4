// Shared device helpers of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_f32.cu): the head dim, the backward's q tile, the
// mask algebra, the SFU's exp2 and bf16 packing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim
constexpr int kBQ = 64;         // q rows per tile of the backward
constexpr float kNegInf = -1e30f;

enum MaskKind { kMaskNone = 0, kMaskCausal = 1, kMaskVideoEncoder = 2,
                kMaskVideoDecoder = 3 };

// floor(a / b) for b >= 1 and |a| < 2^24, through the f32 reciprocal
// `inv` = 1/b and one exact integer correction (an integer division costs
// several times as much).
__device__ __forceinline__ int floordiv_fast(int a, int b, float inv) {
  int f = __float2int_rd(__int2float_rn(a) * inv);
  const int r = a - f * b;
  f += (r < 0) ? -1 : (r >= b ? 1 : 0);
  return f;
}

// The video masks' boolean algebra of landiff_tpu/ops/masks.py (mask_kind
// kMaskVideoEncoder or kMaskVideoDecoder; P carries the descriptor:
// mask_kind and the VideoMaskLayout integers nf, tpf, iqt, pft), with the
// frame indices given: q_frame = floor(q / tpf), p_frame = floor((q - iqe)
// / pft) + 1, kv_frame = floor(kv / tpf), iqe = nf * tpf + iqt, so that a
// kernel divides once per row and column of a tile and not per score.
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

// Every mask kind, per score, with the frame indices hoisted as for
// keep_frames (ignored by the none and causal kinds).
template <class P>
__device__ __forceinline__ bool mask_keep(const P& p, int q, int q_frame,
                                          int p_frame, int kv, int kv_frame) {
  if (p.mask_kind == kMaskNone) return true;
  if (p.mask_kind == kMaskCausal) return q >= kv;
  return keep_frames(p, q, q_frame, p_frame, kv, kv_frame);
}

// exp2 on the SFU (ex2.approx.ftz.f32: about 2 ulp; inputs and results
// below 2^-126 flushed to 0), as p is rounded to bf16 right after. The
// accurate exp2f made the backward 5 % slower at the training shape and
// 16 % at the TiTok shape (chip_bwd_ablation.py).
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two exp2 of a bf16 pair, rounded to bf16 (ex2.approx.ftz.bf16x2): the
// exp_bf16 variants' p
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
