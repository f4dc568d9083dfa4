// Flash-attention forward for Hopper (sm_90a): exact bf16 scores and
// int8 scores, block-sparse over per-q-tile visibility tables.
//
// Replaces the Pallas kernels of landiff_tpu/ops/attention.py:
//   - flash_fwd_bf16: _flash_kernel (:91) and _flash_kernel_cached (:197).
//     The two TPU kernels differ only in whether K/V stream from HBM or sit
//     in VMEM; here one CTA streams its visible K/V tiles through a
//     cp.async double buffer and L2 serves the re-reads across q tiles.
//   - flash_fwd_i8: _flash_kernel_cached_i8 (:264) without the int8_pv
//     variant. K arrives pre-quantized per kv position (int8 + f32 scale);
//     q is quantized per row inside the CTA.
//
// Numerics follow the JAX kernels (log2-domain online softmax):
//   exact: q' = bf16(f32(q) * scale*log2e); s = q'.k in f32
//   int8:  sq = max(|q|, 1e-30) * f32(1/127) per row (XLA compiles the
//          source's division by the constant 127 into this product),
//          q8 = rint(q / sq) (IEEE division, round half to even like
//          jnp.round), sq *= scale*log2e; s = f32(q8.k8 as int32) * sq * sk
//   masked scores = -1e30; m starts at -1e30; p = exp2(s - m_new) * keep,
//   cast to bf16 for p.v; out = acc / max(l, 1e-30);
//   lse = m + log2(l), or -1e30 where l == 0 (fully masked rows give 0).
// The build must not use --use_fast_math: the int8 codes depend on IEEE
// division and on round-half-to-even.
//
// Bound on the H100 (one DiT call, B=2 S=17,776 H=30 D=64): 4*B*H*S^2*D =
// 4.85 TFLOP of tensor-core work, 4.9 ms at the 989 TFLOP/s bf16 peak (the
// int8 kernel runs half of it at the 1,979 TOP/s int8 peak: 3.7 ms), and
// B*H*S^2 = 1.9e10 exp2 on the SFUs (16 per SM per clock: 4.7 ms at
// 1.98 GHz). So the kernel is bound by operations, tensor cores and SFUs
// about equally; the bytes (K/V read once per q tile from L2) are far
// below either. The design keeps every (q, kv) tile in registers: scores,
// probabilities and the output accumulator never touch shared or device
// memory. This first version uses mma.sync (m16n8k16 bf16, m16n8k32 s8)
// rather than wgmma/TMA, and one exp2 per score.
//
// Layout: q, k, v, out are BSHD (row stride H*D), read with strides; no
// transposes. The int8 kernel's K scales are (B, Skv, H) f32, as the
// quantization leaves them. lse is (B, H, Sq) f32. Tables (count (nq,), order and kind
// (nq, nk)) are int32 on the device at this kernel's tile sizes; with no
// tables every kv tile is visible. Partial tiles (kind 1, or the ragged
// last kv tile) evaluate the mask descriptor and the Skv bound per score.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim
constexpr int kBQ = 64;         // q rows per CTA (4 warps x 16)
constexpr int kBKV = 64;        // kv rows per tile
constexpr int kThreads = 128;
constexpr int kStrideH = kD + 8;   // bf16 smem row stride (144 B): no bank conflicts
constexpr int kStrideB = kD + 16;  // int8 smem row stride (80 B): no bank conflicts
constexpr float kNegInf = -1e30f;
constexpr float kInv127 = 1.0f / 127.0f;   // 0.00787401572f

enum MaskKind { kMaskNone = 0, kMaskCausal = 1, kMaskVideoEncoder = 2,
                kMaskVideoDecoder = 3 };

struct Params {
  const void* q;
  const void* k;
  const __nv_bfloat16* v;
  const float* ksc;     // int8 only: (B, Skv, H) per-position K scales
  __nv_bfloat16* o;
  float* lse;
  const int* count;     // null: every kv tile visible
  const int* order;
  const int* kind;
  int B, H, Sq, Skv, nk_table;
  float qscale;         // scale * log2(e), f32
  int mask_kind, nf, tpf, iqt, pft;   // mask descriptor (VideoMaskLayout)
};

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// The boolean algebra of landiff_tpu/ops/masks.py, evaluated per score.
__device__ __forceinline__ bool mask_keep(const Params& p, int q, int kv) {
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

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
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

// Raw storage (trivially constructible, as __shared__ requires); bf16
// arrays are reached through the accessors.
template <bool kInt8>
struct Smem {
  // q tile: exact = pre-scaled bf16; int8 = raw bf16 staging then int8 codes
  alignas(16) uint16_t q_raw[kBQ * kStrideH];
  alignas(16) int8_t q8[kInt8 ? kBQ * kStrideB : 16];
  float sq[kInt8 ? kBQ : 1];
  alignas(16) uint8_t k[2][kInt8 ? kBKV * kStrideB : kBKV * kStrideH * 2];
  alignas(16) uint16_t v_raw[2][kBKV * kStrideH];
  alignas(16) float ksc[2][kInt8 ? kBKV : 4];
  __device__ __nv_bfloat16* q() {
    return reinterpret_cast<__nv_bfloat16*>(q_raw);
  }
  __device__ __nv_bfloat16* v(int stage) {
    return reinterpret_cast<__nv_bfloat16*>(v_raw[stage]);
  }
};

template <bool kInt8>
__device__ __forceinline__ void load_kv_tile(const Params& p, Smem<kInt8>& sm,
                                             int stage, int kv0, int b, int h,
                                             int tid) {
  const size_t row_stride = static_cast<size_t>(p.H) * kD;
  // V: 64 rows x 128 B = 512 chunks of 16 B
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3, col = (c & 7) * 8;
    const int kv = kv0 + r;
    const bool ok = kv < p.Skv;
    const __nv_bfloat16* src =
        p.v + (static_cast<size_t>(b) * p.Skv + (ok ? kv : 0)) * row_stride +
        static_cast<size_t>(h) * kD + col;
    cp_async16(&sm.v(stage)[r * kStrideH + col], src, ok ? 16 : 0);
  }
  if constexpr (kInt8) {
    // K int8: 64 rows x 64 B = 256 chunks
    const int8_t* kp = static_cast<const int8_t*>(p.k);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, col = (c & 3) * 16;
      const int kv = kv0 + r;
      const bool ok = kv < p.Skv;
      const int8_t* src =
          kp + (static_cast<size_t>(b) * p.Skv + (ok ? kv : 0)) * row_stride +
          static_cast<size_t>(h) * kD + col;
      cp_async16(&sm.k[stage][r * kStrideB + col], src, ok ? 16 : 0);
    }
    if (tid < kBKV) {       // 64 scales, one per thread, H apart in memory
      const int kv = kv0 + tid;
      const bool ok = kv < p.Skv;
      const float* src =
          p.ksc + (static_cast<size_t>(b) * p.Skv + (ok ? kv : 0)) * p.H + h;
      cp_async4(&sm.ksc[stage][tid], src, ok ? 4 : 0);
    }
  } else {
    const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k);
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(sm.k[stage]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 3, col = (c & 7) * 8;
      const int kv = kv0 + r;
      const bool ok = kv < p.Skv;
      const __nv_bfloat16* src =
          kp + (static_cast<size_t>(b) * p.Skv + (ok ? kv : 0)) * row_stride +
          static_cast<size_t>(h) * kD + col;
      cp_async16(&ks[r * kStrideH + col], src, ok ? 16 : 0);
    }
  }
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  __shared__ Smem<kInt8> sm;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group / thread-in-group
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kBQ;
  const size_t row_stride = static_cast<size_t>(p.H) * kD;

  const int n_tiles = p.count ? p.count[qt] : (p.Skv + kBKV - 1) / kBKV;
  const int* order = p.order ? p.order + static_cast<size_t>(qt) * p.nk_table
                             : nullptr;
  const int* kinds = p.kind ? p.kind + static_cast<size_t>(qt) * p.nk_table
                            : nullptr;

  // start the first K/V tile while q is prepared
  if (n_tiles > 0) {
    load_kv_tile<kInt8>(p, sm, 0, (order ? order[0] : 0) * kBKV, b, h, tid);
  }
  cp_async_commit();

  // ---- q tile -> smem (rows >= Sq are zeros, as the JAX padding)
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3, col = (c & 7) * 8;
    const int qi = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (qi < p.Sq) {
      raw = *reinterpret_cast<const uint4*>(
          qp + (static_cast<size_t>(b) * p.Sq + qi) * row_stride +
          static_cast<size_t>(h) * kD + col);
    }
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
    if constexpr (!kInt8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        e[j] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(e[j]),
                                             p.qscale));
      }
    }
    *reinterpret_cast<uint4*>(&sm.q()[r * kStrideH + col]) = raw;
  }
  __syncthreads();
  if constexpr (kInt8) {
    if (tid < kBQ) {   // one thread per q row: absmax, scale, codes
      const __nv_bfloat16* row = &sm.q()[tid * kStrideH];
      float amax = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; ++d) {
        amax = fmaxf(amax, fabsf(__bfloat162float(row[d])));
      }
      const float sq = __fmul_rn(fmaxf(amax, 1e-30f), kInv127);
#pragma unroll 8
      for (int d = 0; d < kD; ++d) {
        const float code = rintf(__fdiv_rn(__bfloat162float(row[d]), sq));
        sm.q8[tid * kStrideB + d] = static_cast<int8_t>(code);
      }
      sm.sq[tid] = __fmul_rn(sq, p.qscale);
    }
    __syncthreads();
  }

  // ---- q fragments (A operand), kept in registers for the whole CTA
  const int r0 = warp * 16 + g;    // this thread's rows: r0 and r0 + 8
  uint32_t qa[kInt8 ? 2 : 4][4];
  float sqr[2] = {0.f, 0.f};
  if constexpr (kInt8) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(
          &sm.q8[r0 * kStrideB + kk * 32 + t * 4]);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(
          &sm.q8[(r0 + 8) * kStrideB + kk * 32 + t * 4]);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(
          &sm.q8[r0 * kStrideB + kk * 32 + 16 + t * 4]);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(
          &sm.q8[(r0 + 8) * kStrideB + kk * 32 + 16 + t * 4]);
    }
    sqr[0] = sm.sq[r0];
    sqr[1] = sm.sq[r0 + 8];
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(
          &sm.q()[r0 * kStrideH + kk * 16 + t * 2]);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(
          &sm.q()[(r0 + 8) * kStrideH + kk * 16 + t * 2]);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(
          &sm.q()[r0 * kStrideH + kk * 16 + 8 + t * 2]);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(
          &sm.q()[(r0 + 8) * kStrideH + kk * 16 + 8 + t * 2]);
    }
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};          // per-thread partial row sums
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_kv_tile<kInt8>(p, sm, stage ^ 1,
                          (order ? order[j + 1] : j + 1) * kBKV, b, h, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int kv0 = (order ? order[j] : j) * kBKV;
    const bool partial = (kinds ? kinds[j] == 1 : false) || kv0 + kBKV > p.Skv;

    // ---- s = q . k^T for this warp's 16 rows x 64 kv columns
    float s[8][4];
    if constexpr (kInt8) {
      const int8_t* ks = reinterpret_cast<const int8_t*>(sm.k[stage]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        int c32[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int8_t* kr = &ks[(n * 8 + g) * kStrideB + kk * 32 + t * 4];
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 16);
          mma_s8(c32, qa[kk], b0, b1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sk = sm.ksc[stage][n * 8 + t * 2 + (e & 1)];
          s[n][e] = __fmul_rn(__fmul_rn(static_cast<float>(c32[e]),
                                        sqr[e >> 1]), sk);
        }
      }
    } else {
      const __nv_bfloat16* ks =
          reinterpret_cast<const __nv_bfloat16*>(sm.k[stage]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const __nv_bfloat16* kr =
              &ks[(n * 8 + g) * kStrideH + kk * 16 + t * 2];
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
          mma_bf16(s[n], qa[kk], b0, b1);
        }
      }
    }

    // ---- mask (partial tiles only): keep bit per score
    uint32_t keep_bits = 0xffffffffu;
    if (partial) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + r0 + (e >> 1) * 8;
          const int kj = kv0 + n * 8 + t * 2 + (e & 1);
          const bool keep = kj < p.Skv && mask_keep(p, qi, kj);
          if (!keep) {
            s[n][e] = kNegInf;
            keep_bits &= ~(1u << (n * 4 + e));
          }
        }
      }
    }

    // ---- online softmax (log2 domain)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2f(s[n][e] - m[e >> 1]);
        if (!((keep_bits >> (n * 4 + e)) & 1u)) pe = 0.f;
        s[n][e] = pe;
        l[e >> 1] += pe;
        acc[n][e] *= alpha[e >> 1];
      }
    }

    // ---- acc += bf16(p) . v
    const __nv_bfloat16* vs = sm.v(stage);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {      // kv rows kk*16 .. +15
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < 4; ++nd) {    // d columns nd*16 .. +15
        const int mat = lane >> 3, rr = lane & 7;
        const __nv_bfloat16* ptr =
            &vs[(kk * 16 + (mat & 1) * 8 + rr) * kStrideH + nd * 16 +
                (mat >> 1) * 8];
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, ptr);
        mma_bf16(acc[2 * nd], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * nd + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // the stage is refilled by the next iteration
  }
  cp_async_wait<0>();

  // ---- epilogue: full row sums, normalise, write out and lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + r * 8;
    if (qi >= p.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = p.o + (static_cast<size_t>(b) * p.Sq + qi) *
                                    row_stride + static_cast<size_t>(h) * kD;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t packed = pack_bf16(__fdiv_rn(acc[n][r * 2], denom),
                                        __fdiv_rn(acc[n][r * 2 + 1], denom));
      *reinterpret_cast<uint32_t*>(&orow[n * 8 + t * 2]) = packed;
    }
    if (t == 0) {
      p.lse[static_cast<size_t>(bh) * p.Sq + qi] =
          l[r] > 0.f ? m[r] + log2f(denom) : kNegInf;
    }
  }
}

template <bool kInt8>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  flash_fwd_kernel<kInt8><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, const void* k, const void* v,
                   const float* ksc, void* o, float* lse, const int* count,
                   const int* order, const int* kind, int B, int H, int Sq,
                   int Skv, int nk_table, float qscale,
                   int mask_kind, int nf, int tpf, int iqt, int pft) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.ksc = ksc;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.count = count;
  p.order = order;
  p.kind = kind;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.nk_table = nk_table;
  p.qscale = qscale;
  p.mask_kind = mask_kind;
  p.nf = nf;
  p.tpf = tpf;
  p.iqt = iqt;
  p.pft = pft;
  return p;
}

}  // namespace

// Plain C interface (bound with ctypes). Returns the cudaError_t of the
// launch. Tiles: 64 q rows x 64 kv rows; head dim 64 only.
extern "C" int landiff_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* count, const int* order, const int* kind, int B, int H, int Sq,
    int Skv, int nk_table, float qscale, int mask_kind, int nf, int tpf,
    int iqt, int pft, void* stream) {
  const Params p = make_params(q, k, v, nullptr, o, lse, count, order, kind, B,
                               H, Sq, Skv, nk_table, qscale, mask_kind, nf,
                               tpf, iqt, pft);
  return launch<false>(p, static_cast<cudaStream_t>(stream));
}

extern "C" int landiff_flash_fwd_i8(
    const void* q, const void* k8, const float* ksc, const void* v, void* o,
    float* lse, const int* count, const int* order, const int* kind, int B,
    int H, int Sq, int Skv, int nk_table, float qscale, int mask_kind,
    int nf, int tpf, int iqt, int pft, void* stream) {
  const Params p = make_params(q, k8, v, ksc, o, lse, count, order, kind, B, H,
                               Sq, Skv, nk_table, qscale, mask_kind, nf, tpf,
                               iqt, pft);
  return launch<true>(p, static_cast<cudaStream_t>(stream));
}
