// Flash-attention forward for Hopper (sm_90a): exact bf16 scores and
// int8 scores, block-sparse over per-q-tile visibility tables.
//
// Replaces the Pallas kernels of landiff_tpu/ops/attention.py:
//   - flash_fwd_bf16: _flash_kernel (:91) and _flash_kernel_cached (:197).
//     The two TPU kernels differ only in whether K/V stream from HBM or sit
//     in VMEM; here one CTA streams its visible K/V tiles through a
//     cp.async double buffer and L2 serves the re-reads across q tiles.
//   - flash_fwd_i8: _flash_kernel_cached_i8 (:264). K arrives
//     pre-quantized per kv position (int8 + f32 scale); q is quantized per
//     row inside the CTA. With int8_pv (kPV8) V arrives pre-quantized too,
//     one absmax scale per (b, h, V block) of JAX's block_kv rows, codes
//     transposed (B*H, 64, Skv_p) with kv contiguous, and p.v runs in int8.
//   - exp_bf16 (kExpBf16), a variant of all three: _softmax_tile (:37-57)
//     with p = exp2(bf16(s - m)) in bf16.
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
//   exp_bf16: p = ex2.approx.bf16x2(bf16(s - m_new)) * keep, one
//          instruction per two exp2; the tile's row sum of the bf16 p is taken in f32 and
//          rounded to bf16 before l = l * alpha + sum (jnp.sum of a bf16
//          array computes in f32 and returns bf16).
//   int8_pv: p8 = rint(p * 127) (p in [0, 1] after the running max), acc
//          = acc * alpha + f32(p8.v8 as int32) * (sv * f32(1/127)) with sv
//          the V block's scale, constant over a 64-row kv tile since a V
//          block is a multiple of 64 rows; l keeps summing the f32 p.
// The build must not use --use_fast_math: the int8 codes depend on IEEE
// division and on round-half-to-even.
//
// Bound on the H100 (one DiT call, B=2 S=17,776 H=30 D=64): 4*B*H*S^2*D =
// 4.85 TFLOP of tensor-core work, 4.9 ms at the 989 TFLOP/s bf16 peak (the
// int8 kernel runs half of it at the 1,979 TOP/s int8 peak: 3.7 ms), and
// B*H*S^2 = 1.9e10 exp2 on the SFUs (16 per SM per clock: 4.5 ms at
// 1.98 GHz). So the kernel is bound by operations, tensor cores and SFUs
// about equally; the bytes (K/V read once per q tile from L2) are far
// below either. The design keeps every (q, kv) tile in registers: scores,
// probabilities and the output accumulator never touch shared or device
// memory. This first version uses mma.sync (m16n8k16 bf16, m16n8k32 s8)
// rather than wgmma/TMA, and one exp2 per score (one ex2.bf16x2 per two
// with exp_bf16, which on an H100 yields exp2 results no faster than the
// f32 ex2: landiff_ex2_rate reads the two rates within 0.4 %, so the
// bf16 form leaves the co-bound where it is). With int8 scores the q.k
// half runs at the int8 rate (1.8 ms) and the exp2 co-bound binds; with
// int8_pv both products do (2.45 ms in all). The p8 operand of p.v is not where the score
// accumulators hold it (a thread holds score columns 2t, 2t+1 of each
// 8-column tile, the s8 A operand wants columns 4t..4t+3 of each 16), so
// each thread packs its codes per tile into one 32-bit word and takes the
// words it needs from two lanes of its quad (__shfl_sync, __byte_perm).
//
// Layout: q, k, v, out are BSHD (row stride H*D), read with strides; no
// transposes. The int8 kernel's K scales are (B, Skv, H) f32, as the
// quantization leaves them. lse is (B, H, Sq) f32. Tables (count (nq,), order and kind
// (nq, nk)) are int32 on the device at this kernel's tile sizes; with no
// tables every kv tile is visible. Partial tiles (kind 1, or the ragged
// last kv tile) evaluate the mask descriptor and the Skv bound per score.

#include "flash_common.cuh"

namespace {

constexpr int kStrideB = kD + 16;  // int8 smem row stride (80 B): no bank conflicts
constexpr float kInv127 = 1.0f / 127.0f;   // 0.00787401572f

struct Params {
  const void* q;
  const void* k;
  const void* v;        // bf16 BSHD; int8_pv: int8 (B*H, 64, skv_p) codes
  const float* ksc;     // int8 only: (B, Skv, H) per-position K scales
  const float* vsc;     // int8_pv only: (B*H, skv_p / v_block) V scales
  __nv_bfloat16* o;
  float* lse;
  const int* count;     // null: every kv tile visible
  const int* order;
  const int* kind;
  int B, H, Sq, Skv, nk_table;
  float qscale;         // scale * log2(e), f32
  int mask_kind, nf, tpf, iqt, pft;   // mask descriptor (VideoMaskLayout)
  int v_block, skv_p;   // int8_pv only: V block rows, padded kv length
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// Raw storage (trivially constructible, as __shared__ requires); bf16
// arrays are reached through the accessors.
template <bool kInt8, bool kPV8>
struct Smem {
  // q tile: exact = pre-scaled bf16; int8 = raw bf16 staging then int8 codes
  alignas(16) uint16_t q_raw[kBQ * kStrideH];
  alignas(16) int8_t q8[kInt8 ? kBQ * kStrideB : 16];
  float sq[kInt8 ? kBQ : 1];
  alignas(16) uint8_t k[2][kInt8 ? kBKV * kStrideB : kBKV * kStrideH * 2];
  alignas(16) uint16_t v_raw[2][kPV8 ? 8 : kBKV * kStrideH];
  alignas(16) int8_t v8[2][kPV8 ? kD * kStrideB : 16];   // (d, kv) codes
  alignas(16) float ksc[2][kInt8 ? kBKV : 4];
  __device__ __nv_bfloat16* q() {
    return reinterpret_cast<__nv_bfloat16*>(q_raw);
  }
  __device__ __nv_bfloat16* v(int stage) {
    return reinterpret_cast<__nv_bfloat16*>(v_raw[stage]);
  }
};

template <bool kInt8, bool kPV8>
__device__ __forceinline__ void load_kv_tile(const Params& p,
                                             Smem<kInt8, kPV8>& sm,
                                             int stage, int kv0, int b, int h,
                                             int tid) {
  const size_t row_stride = static_cast<size_t>(p.H) * kD;
  if constexpr (kPV8) {
    // V codes: 64 d rows x 64 kv bytes = 256 chunks; kv0 + 64 <= skv_p
    // (the padding is zeros), so no bound check
    const int8_t* vp = static_cast<const int8_t*>(p.v) +
                       (static_cast<size_t>(b) * p.H + h) * kD * p.skv_p;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, col = (c & 3) * 16;
      cp_async16(&sm.v8[stage][r * kStrideB + col],
                 vp + static_cast<size_t>(r) * p.skv_p + kv0 + col, 16);
    }
  } else {
    // V: 64 rows x 128 B = 512 chunks of 16 B
    const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 3, col = (c & 7) * 8;
      const int kv = kv0 + r;
      const bool ok = kv < p.Skv;
      const __nv_bfloat16* src =
          vp + (static_cast<size_t>(b) * p.Skv + (ok ? kv : 0)) * row_stride +
          static_cast<size_t>(h) * kD + col;
      cp_async16(&sm.v(stage)[r * kStrideH + col], src, ok ? 16 : 0);
    }
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

template <bool kInt8, bool kPV8, bool kExpBf16>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  static_assert(kInt8 || !kPV8, "int8 p.v needs the int8-score kernel");
  __shared__ Smem<kInt8, kPV8> sm;
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
    load_kv_tile<kInt8, kPV8>(p, sm, 0, (order ? order[0] : 0) * kBKV, b, h,
                              tid);
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
  // per-thread partial row sums; with exp_bf16 the full row sums (every
  // thread of a quad holds them)
  float l[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_kv_tile<kInt8, kPV8>(p, sm, stage ^ 1,
                                (order ? order[j + 1] : j + 1) * kBKV, b, h,
                                tid);
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
    }
    if constexpr (kExpBf16) {
      // p in bf16, two per ex2; s keeps p widened to f32 (exact)
      float ts[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t pb = ex2_bf16x2(pack_bf16(s[n][2 * r] - m[r],
                                             s[n][2 * r + 1] - m[r]));
          if (!((keep_bits >> (n * 4 + 2 * r)) & 1u)) pb &= 0xffff0000u;
          if (!((keep_bits >> (n * 4 + 2 * r + 1)) & 1u)) pb &= 0x0000ffffu;
          s[n][2 * r] = __uint_as_float(pb << 16);
          s[n][2 * r + 1] = __uint_as_float(pb & 0xffff0000u);
          ts[r] += s[n][2 * r];
          ts[r] += s[n][2 * r + 1];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ts[r] += __shfl_xor_sync(0xffffffffu, ts[r], 1);
        ts[r] += __shfl_xor_sync(0xffffffffu, ts[r], 2);
        const float tsum = __bfloat162float(__float2bfloat16_rn(ts[r]));
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), tsum);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] *= alpha[r];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = exp2f(s[n][e] - m[e >> 1]);
          if (!((keep_bits >> (n * 4 + e)) & 1u)) pe = 0.f;
          s[n][e] = pe;
          l[e >> 1] += pe;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    }

    if constexpr (kPV8) {
      // ---- acc += f32(rint(127 p) . v8) * sv / 127
      // codes of this thread per 8-column tile n, bytes (row g, col 2t),
      // (g, 2t+1), (g+8, 2t), (g+8, 2t+1); p in [0, 1] so codes in [0, 127]
      uint32_t pk[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t w = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = __float2int_rn(__fmul_rn(s[n][e], 127.f));
          w |= static_cast<uint32_t>(c & 0xff) << (8 * e);
        }
        pk[n] = w;
      }
      // A operand (m16n8k32 s8): a[0] = row g, columns 4t..4t+3 of the
      // 32-column step, a[1] the same for row g+8, a[2] / a[3] columns
      // 16 + 4t..; those columns sit in tile 4kk + 2hh + (t >> 1) at lanes
      // 2(t & 1) and 2(t & 1) + 1 of the quad
      const int src0 = (lane & ~3) | ((t & 1) << 1);
      const bool upper = (t >> 1) != 0;
      uint32_t pa8[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n0 = kk * 4 + hh * 2;
          const uint32_t x0 = __shfl_sync(0xffffffffu, pk[n0], src0);
          const uint32_t x1 = __shfl_sync(0xffffffffu, pk[n0 + 1], src0);
          const uint32_t y0 = __shfl_sync(0xffffffffu, pk[n0], src0 + 1);
          const uint32_t y1 = __shfl_sync(0xffffffffu, pk[n0 + 1], src0 + 1);
          const uint32_t lo = upper ? x1 : x0, hi = upper ? y1 : y0;
          pa8[kk][2 * hh] = __byte_perm(lo, hi, 0x5410);       // row g
          pa8[kk][2 * hh + 1] = __byte_perm(lo, hi, 0x7632);   // row g + 8
        }
      }
      const int nvb = p.skv_p / p.v_block;
      const float svs = __fmul_rn(
          __ldg(&p.vsc[static_cast<size_t>(bh) * nvb + kv0 / p.v_block]),
          kInv127);
      const int8_t* vs8 = sm.v8[stage];
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {    // d columns nd*8 .. +7
        int c32[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int8_t* vr = &vs8[(nd * 8 + g) * kStrideB + kk * 32 + t * 4];
          mma_s8(c32, pa8[kk], *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 16));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[nd][e] = __fadd_rn(
              acc[nd][e], __fmul_rn(static_cast<float>(c32[e]), svs));
        }
      }
    } else {
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
    }
    __syncthreads();   // the stage is refilled by the next iteration
  }
  cp_async_wait<0>();

  // ---- epilogue: full row sums, normalise, write out and lse
  if constexpr (!kExpBf16) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
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

template <bool kInt8, bool kPV8, bool kExpBf16>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  flash_fwd_kernel<kInt8, kPV8, kExpBf16><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, const void* k, const void* v,
                   const float* ksc, const float* vsc, void* o, float* lse,
                   const int* count, const int* order, const int* kind, int B,
                   int H, int Sq, int Skv, int nk_table, float qscale,
                   int mask_kind, int nf, int tpf, int iqt, int pft,
                   int v_block, int skv_p) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.ksc = ksc;
  p.vsc = vsc;
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
  p.v_block = v_block;
  p.skv_p = skv_p;
  return p;
}

}  // namespace

// Plain C interface (bound with ctypes). Returns the cudaError_t of the
// launch. Tiles: 64 q rows x 64 kv rows; head dim 64 only. exp_bf16 != 0
// selects the bf16-exp2 variant.
extern "C" int landiff_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* count, const int* order, const int* kind, int B, int H, int Sq,
    int Skv, int nk_table, float qscale, int mask_kind, int nf, int tpf,
    int iqt, int pft, int exp_bf16, void* stream) {
  const Params p = make_params(q, k, v, nullptr, nullptr, o, lse, count,
                               order, kind, B, H, Sq, Skv, nk_table, qscale,
                               mask_kind, nf, tpf, iqt, pft, 0, 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exp_bf16 ? launch<false, false, true>(p, st)
                  : launch<false, false, false>(p, st);
}

// vsc null: v is bf16 BSHD and p.v runs in bf16. vsc set (int8_pv): v is
// the int8 (B*H, 64, skv_p) codes and vsc the (B*H, skv_p / v_block) f32
// scales; v_block is a multiple of 64 and divides skv_p >= Skv.
extern "C" int landiff_flash_fwd_i8(
    const void* q, const void* k8, const float* ksc, const void* v,
    const float* vsc, void* o, float* lse, const int* count, const int* order,
    const int* kind, int B, int H, int Sq, int Skv, int nk_table,
    float qscale, int mask_kind, int nf, int tpf, int iqt, int pft,
    int v_block, int skv_p, int exp_bf16, void* stream) {
  const Params p = make_params(q, k8, v, ksc, vsc, o, lse, count, order, kind,
                               B, H, Sq, Skv, nk_table, qscale, mask_kind, nf,
                               tpf, iqt, pft, v_block, skv_p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vsc) {
    return exp_bf16 ? launch<true, true, true>(p, st)
                    : launch<true, true, false>(p, st);
  }
  return exp_bf16 ? launch<true, false, true>(p, st)
                  : launch<true, false, false>(p, st);
}

namespace {
__global__ void ex2_bf16x2_kernel(const uint32_t* x, uint32_t* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = ex2_bf16x2(x[i]);
}
}  // namespace

// The exp_bf16 variant's exp2 (ex2.approx.ftz.bf16x2) applied to n pairs
// of bf16 values: a probe for the plain versions, which take the card's
// exp2 as a table of all 65,536 bf16 inputs to check the rest of the
// variant's arithmetic tightly. Not on any model path.
extern "C" int landiff_ex2_bf16x2(const void* x, void* y, int n,
                                  void* stream) {
  ex2_bf16x2_kernel<<<(n + 255) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

namespace {
// Eight independent chains per thread, x <- ex2(-|x|): each step waits on
// the last, the values stay in (0, 1], and the SFUs are the only pipe
// with work enough to bind (one LOP3 per ex2 sets the sign).
template <bool kPairs>
__global__ void ex2_rate_kernel(uint32_t* out, int iters) {
  const uint32_t id = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x[j] = kPairs ? 0x3f003f00u + ((id + j) & 0x7fu) * 0x10001u
                  : 0x3f000000u + (((id + j) & 0x7fffu) << 8);
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (kPairs) {
        asm volatile("ex2.approx.ftz.bf16x2 %0, %1;\n"
                     : "=r"(x[j]) : "r"(x[j] | 0x80008000u));
      } else {
        float y;
        asm volatile("ex2.approx.ftz.f32 %0, %1;\n"
                     : "=f"(y) : "f"(__uint_as_float(x[j] | 0x80000000u)));
        x[j] = __float_as_uint(y);
      }
    }
  }
  out[id] = x[0] ^ x[1] ^ x[2] ^ x[3] ^ x[4] ^ x[5] ^ x[6] ^ x[7];
}
}  // namespace

// A throughput probe of the SFU's exp2: blocks x 256 threads x 8 chains x
// iters instructions of ex2.approx.ftz.bf16x2 (pairs != 0: two exp2 each)
// or of ex2.approx.ftz.f32 (one each); out holds blocks * 256 words.
// Timed by the caller, it says what the exp_bf16 variants' exp2 costs
// against the f32 one. Not on any model path.
extern "C" int landiff_ex2_rate(void* out, int blocks, int iters, int pairs,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (pairs) {
    ex2_rate_kernel<true><<<blocks, 256, 0, st>>>(o, iters);
  } else {
    ex2_rate_kernel<false><<<blocks, 256, 0, st>>>(o, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
