// Flash-attention forward for Hopper (sm_90a): exact bf16 scores and int8
// scores, block-sparse over per-q-tile visibility tables. wgmma, TMA and
// mbarriers, warp-specialised: three consumer warpgroups whose softmax
// and tensor-core work interleave.
//
// Replaces the Pallas kernels of landiff_tpu/ops/attention.py:
//   - flash_fwd_bf16: _flash_kernel (:91) and _flash_kernel_cached (:197).
//     The two TPU kernels differ only in whether K/V stream from HBM or sit
//     in VMEM; here one CTA streams its visible K/V tiles through a TMA
//     ring and L2 serves the re-reads across q tiles.
//   - flash_fwd_i8: _flash_kernel_cached_i8 (:264). K arrives
//     pre-quantized per kv position (int8 + f32 scale), by this file's
//     prologue kernel (landiff_flash_quantize_k) where JAX quantizes it
//     with XLA outside its kernel; q is quantized per row inside the CTA.
//     With int8_pv (kPV8) V arrives pre-quantized too, one absmax scale
//     per (b, h, V block) of JAX's block_kv rows, codes transposed (B*H,
//     64, Skv_p) with kv contiguous, and p.v runs in int8.
//   - exp_bf16 (kExpBf16), a variant of all three: _softmax_tile (:37-57)
//     with p = exp2(bf16(s - m)) in bf16.
//
// Numerics follow the JAX kernels (log2-domain online softmax):
//   exact: q' = bf16(f32(q) * scale*log2e); s = q'.k in f32
//   int8:  sq = max(|q|, 1e-30) * f32(1/127) per row (XLA compiles the
//          source's division by the constant 127 into this product),
//          q8 = rint(q / sq) (IEEE division, round half to even like
//          jnp.round), sq *= scale*log2e; s = f32(q8.k8 as int32) * sq * sk
//          (JAX's order). The kernel takes t = f32(q8.k8) * sk per score
//          and the row's sq inside the max (exact: sq > 0 commutes with
//          it) and the exp2 (s - m = fma(t, sq, -m), one rounding where
//          JAX has two): s moves by at most an ulp, as under the SFU's
//          exp2, and one multiply per score goes. With exp_bf16, where
//          bf16(s - m) would round the other way on such an ulp, s is
//          taken in JAX's order.
//   masked scores = -1e30; m starts at -1e30; p = exp2(s - m_new), 0 for
//   a masked score, cast to bf16 for p.v; out = acc / max(l, 1e-30);
//   lse = m + log2(l), or -1e30 where l == 0 (fully masked rows give 0).
//   exp2 is the SFU's ex2.approx.ftz.f32 (about 2 ulp; JAX and the plain
//   versions take the exact 2^x), as in the backward.
//   exp_bf16: p = ex2.approx.bf16x2(bf16(s - m_new)), one instruction per
//          two exp2; the tile's row sum of the bf16 p is taken in f32 and
//          rounded to bf16 before l = l * alpha + sum (jnp.sum of a bf16
//          array computes in f32 and returns bf16).
//   int8_pv: p8 = rint(p * 127) (p in [0, 1] after the running max), acc
//          = acc * alpha + f32(p8.v8 as int32) * (sv * f32(1/127)) with sv
//          the V block's scale, constant over a 128-row kv tile since a V
//          block is a multiple of 128 rows; l keeps summing the f32 p.
// The build must not use --use_fast_math: the int8 codes depend on IEEE
// division and on round-half-to-even.
//
// Bound on the H100 (one DiT call, B=2 S=17,776 H=30 D=64): 4*B*H*S^2*D =
// 4.85 TFLOP of tensor-core work, 4.9 ms at the 989 TFLOP/s bf16 peak (the
// int8 kernel runs half of it at the 1,979 TOP/s int8 peak: 3.7 ms), and
// B*H*S^2 = 1.9e10 exp2 on the SFUs (16 per SM per clock: 4.5 ms at 1.98
// GHz). Bound by operations, tensor cores and SFUs about equally, and
// they are different units: the design lets one run under the other.
// The bytes (K/V read once per q tile from L2) are far below either.
//
// Design: one CTA per (192-row q tile, b*h), 512 threads. Warpgroup 0 is
// the producer: one thread loads the q tile once and then each visible
// K/V tile (128 kv rows) by TMA into a 3-stage ring under full / empty
// mbarriers (int8: the K codes with the 64-byte swizzle, their scales by
// bulk copy). Warpgroups 1-3 each own 64 q rows and first make them the
// A operand in shared memory (exact: q' in place; int8: the row codes).
// Per kv tile j a consumer issues S_j = Q.K_j^T (wgmma m64n128, bf16 k16
// or s8 k32, both operands from shared memory), then O += P_{j-1}.V_{j-1}
// (wgmma m64n64, A = the bf16 (or int8_pv: s8) p of the last tile, from
// registers; V MN-major bf16, or the K-major int8 codes), waits for S_j
// alone and runs the softmax of tile j (scores, mask on partial tiles,
// running max, exp2) under the second product; then waits for that, packs
// p as the next product's A fragments and rescales O (skipped where no
// row of the warp moved its running max). A warpgroup's softmax takes
// longer than its products on the tensor cores (one warp per SM
// sub-partition issues it), so three warpgroups share the tensor cores:
// while one's products run the others compute. (Making them issue in
// turn by named barriers, FA3's ping-pong, helped two warpgroups and
// slowed three: PERF.md.) Both waits sit in one iteration, so no group
// crosses the loop's back-edge (a partial wait across it makes ptxas
// serialize every wgmma), and the softmax writes only the score
// registers, whose product is done. The epilogue writes
// each warpgroup's 64 rows of out through shared memory with one TMA
// store (rows past Sq are not written) and lse per row.
//
// Layout: q, k, v, out are BSHD (4-D tensor maps, dims (D, H, S, B), so
// rows past S read as zeros and never from the next batch). The int8
// kernel's K codes are BSHD int8; its K scales (B*H, Skv_pad) f32, Skv
// rounded up to the kv tile and zero past Skv. lse is (B, H, Sq) f32.
// Tables (count (nq,), order and kind (nq, nk)) are int32 on the device at
// this kernel's 192 x 128 tiles; with no tables every kv tile is visible.
// Partial tiles (kind 1, or the ragged last kv tile) evaluate the mask
// descriptor and the Skv bound per score, with the frame indices taken
// once per q row and kv column of the tile.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kFwdWGs = 3;            // consumer warpgroups, 64 q rows each
constexpr int kFwdBQ = 64 * kFwdWGs;  // q rows per CTA
constexpr int kFwdBKV = 128;          // kv rows per tile
constexpr int kFwdStages = 3;         // K/V ring
constexpr int kFwdConsumers = 128 * kFwdWGs;
constexpr int kFwdThreads = kFwdConsumers + 128;   // and the producer
constexpr float kInv127 = 1.0f / 127.0f;   // 0.00787401572f
// 1.5 * 2^23: x + kMagic rounds 0 <= x < 2^22 to an integer (half to
// even) in the low mantissa bits, without a float-to-int conversion
constexpr float kMagic = 12582912.0f;
// named barriers 1 .. kFwdWGs: each consumer warpgroup's own (its q
// operand, its epilogue)
constexpr int kWarpgroupBarrier = 1;

struct Params {
  const float* ksc;     // int8 only: (B*H, skv_pad) per-position K scales
  const float* vsc;     // int8_pv only: (B*H, skv_p / v_block) V scales
  float* lse;
  const int* count;     // null: every kv tile visible
  const int* order;
  const int* kind;
  int B, H, Sq, Skv, nk_table, skv_pad;
  float qscale;         // scale * log2(e), f32
  int mask_kind, nf, tpf, iqt, pft;   // mask descriptor (VideoMaskLayout)
  int iqe;                            // nf * tpf + iqt
  float inv_tpf, inv_pft;             // 1 / tpf, 1 / pft in f32
  int v_block, skv_p;   // int8_pv only: V block rows, padded kv length
};

// One ring stage: the K tile (bf16 128-byte rows, or int8 64-byte rows),
// the V tile (bf16 128 kv x 64 d, or int8_pv codes 64 d x 128 kv) and,
// with int8 scores, the tile's K scales. Each tile starts 1024-aligned.
template <bool kInt8, bool kPV8>
struct alignas(1024) FwdStage {
  uint8_t k[kFwdBKV * kD * (kInt8 ? 1 : 2)];
  uint8_t v[kFwdBKV * kD * (kPV8 ? 1 : 2)];
  float ksc[kInt8 ? kFwdBKV : 4];
};

template <bool kInt8, bool kPV8>
struct alignas(1024) FwdSmem {
  uint16_t q[kFwdBQ * kD];   // the q tile (exact: q'); then the out rows
  uint8_t q8[kInt8 ? kFwdBQ * kD : 16];   // int8: the q codes
  FwdStage<kInt8, kPV8> st[kFwdStages];
  uint64_t full[kFwdStages];
  uint64_t empty[kFwdStages];
  uint64_t q_full;
};

template <bool kInt8, bool kPV8>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return kFwdBKV * kD * (kInt8 ? 1 : 2) + kFwdBKV * kD * (kPV8 ? 1 : 2) +
         (kInt8 ? kFwdBKV * 4 : 0);
}

__device__ __forceinline__ float int_to_f32(uint32_t c) {
  return static_cast<float>(static_cast<int>(c));
}

// The score accumulator: f32 for exact scores, s32 for int8 ones (its
// registers then take the f32 scores in place once the product is done).
template <bool kInt8>
struct Scores;
template <>
struct Scores<false> {
  float v[64];
  __device__ __forceinline__ float get(int i) const { return v[i]; }
  __device__ __forceinline__ void set(int i, float x) { v[i] = x; }
};
template <>
struct Scores<true> {
  uint32_t v[64];
  __device__ __forceinline__ float get(int i) const {
    return __uint_as_float(v[i]);
  }
  __device__ __forceinline__ void set(int i, float x) {
    v[i] = __float_as_uint(x);
  }
};

// A warpgroup's 64 rows of the q tile made into the A operand of S =
// Q.K^T, in shared memory, once per CTA. Exact: q' = bf16(q * qscale) in
// place (128-byte rows; the swizzle permutes within a row, so the product
// is taken chunk by chunk). int8: the row codes into q8 (64-byte rows,
// the 64-byte swizzle) and sqr, the scales of this thread's rows `row`
// and `row + 8` times qscale; the quad (t = 0..3) holds a row's 64 values
// between its four threads, so its absmax is two shuffles away.
template <bool kInt8>
__device__ __forceinline__ void q_operand(unsigned char* qb, uint8_t* q8,
                                          int cw, int ct, int row, int t,
                                          float qscale, float (&sqr)[2]) {
  if constexpr (!kInt8) {
    uint4* chunks = reinterpret_cast<uint4*>(qb + cw * 64 * 128);
#pragma unroll
    for (int i = 0; i < 4; ++i) {        // 512 chunks of 8 bf16
      uint4 w = chunks[ct + i * 128];
      uint32_t* h = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = pack_bf16(__fmul_rn(__uint_as_float(h[e] << 16), qscale),
                         __fmul_rn(__uint_as_float(h[e] & 0xffff0000u),
                                   qscale));
      }
      chunks[ct + i * 128] = w;
    }
    sqr[0] = sqr[1] = 0.f;
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + r * 8;
      float x[16];     // columns kk*32 + half*16 + 4t + e
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int chunk = kk * 4 + half * 2 + (t >> 1);
          const uint2 w = *reinterpret_cast<const uint2*>(
              qb + rr * 128 + ((chunk ^ (rr & 7)) << 4) + (t & 1) * 8);
          x[kk * 8 + half * 4 + 0] = __uint_as_float(w.x << 16);
          x[kk * 8 + half * 4 + 1] = __uint_as_float(w.x & 0xffff0000u);
          x[kk * 8 + half * 4 + 2] = __uint_as_float(w.y << 16);
          x[kk * 8 + half * 4 + 3] = __uint_as_float(w.y & 0xffff0000u);
        }
      }
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) amax = fmaxf(amax, fabsf(x[e]));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      const float sq = __fmul_rn(fmaxf(amax, 1e-30f), kInv127);
#pragma unroll
      for (int f = 0; f < 4; ++f) {   // codes of columns 16 f + 4t ..
        uint32_t w = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = static_cast<int>(rintf(__fdiv_rn(x[f * 4 + e], sq)));
          w |= static_cast<uint32_t>(c & 0xff) << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(
            q8 + rr * 64 + ((f ^ ((rr >> 1) & 3)) << 4) + t * 4) = w;
      }
      sqr[r] = __fmul_rn(sq, qscale);
    }
  }
  fence_async_smem();
  named_barrier(kWarpgroupBarrier + cw, 128);
}

template <bool kInt8, bool kPV8, bool kExpBf16>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, const Params p) {
  static_assert(kInt8 || !kPV8, "int8 p.v needs the int8-score kernel");
  using Smem = FwdSmem<kInt8, kPV8>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  // warp-uniform (a shuffle), so no wgmma sits in a path the compiler
  // takes for divergent
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kFwdBQ;
  const int n_tiles = __shfl_sync(
      0xffffffffu, p.count ? p.count[qt] : (p.Skv + kFwdBKV - 1) / kFwdBKV,
      0);
  const int* order = p.order ? p.order + static_cast<size_t>(qt) * p.nk_table
                             : nullptr;
  const int* kinds = p.kind ? p.kind + static_cast<size_t>(qt) * p.nk_table
                            : nullptr;

  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kFwdConsumers);
    }
    mbar_init(&sm.q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(&sm.q_full, kFwdBQ * kD * 2);
      tma_load_4d(sm.q, &tm_q, &sm.q_full, 0, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kFwdStages;
        mbar_wait(&sm.empty[s], ((j / kFwdStages) & 1) ^ 1);
        const int kv0 = (order ? order[j] : j) * kFwdBKV;
        mbar_expect_tx(&sm.full[s], stage_bytes<kInt8, kPV8>());
        tma_load_4d(sm.st[s].k, &tm_k, &sm.full[s], 0, h, kv0, b);
        if constexpr (kPV8) {
          tma_load_3d(sm.st[s].v, &tm_v, &sm.full[s], kv0, 0, bh);
        } else {
          tma_load_4d(sm.st[s].v, &tm_v, &sm.full[s], 0, h, kv0, b);
        }
        if constexpr (kInt8) {
          bulk_load(sm.st[s].ksc,
                    p.ksc + static_cast<size_t>(bh) * p.skv_pad + kv0,
                    kFwdBKV * 4, &sm.full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns q rows cw*64 .. cw*64+63
  setmaxnreg_inc<160>();
  const int cw = wg - 1;
  const int ct = tid - 128 * wg;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_lo = cw * 64 + warp * 16 + g;   // CTA rows r_lo and r_lo + 8

  const int qi[2] = {q0 + r_lo, q0 + r_lo + 8};   // this thread's q rows

  mbar_wait(&sm.q_full, 0);
  float sqr[2];
  q_operand<kInt8>(reinterpret_cast<unsigned char*>(sm.q), sm.q8, cw, ct,
                   r_lo, t, p.qscale, sqr);
  const uint32_t q_b = kInt8 ? smem_addr(sm.q8) + cw * 64 * 64
                             : smem_addr(sm.q) + cw * 64 * 128;

  Scores<kInt8> S;
  float o[32];
  uint32_t pv[kPV8 ? 32 : 1];     // int8_pv: the tile's p8.v8 sums
  uint32_t pa[8][4];              // p of the last tile as A fragments
  float m[2] = {kNegInf, kNegInf};
  // per-thread partial row sums; with exp_bf16 the full row sums (every
  // thread of a quad holds them)
  float l[2] = {0.f, 0.f};
  float sv_last = 0.f;            // int8_pv: the last tile's V scale / 127
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    o[i] = 0.f;
    pa[i / 4][i % 4] = 0u;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) S.set(i, 0.f);
  if constexpr (kPV8) {
#pragma unroll
    for (int i = 0; i < 32; ++i) pv[i] = 0u;
    reg_fence(pv);
  }
  // the values are in place before the first wgmma is issued: a register
  // that a wgmma accumulates into may not be defined by other instructions
  // while any wgmma is in flight, or the compiler serializes them all
  reg_fence(o);
  reg_fence(S.v);

  const uint32_t st_base = smem_addr(&sm.st[0]);
  constexpr uint32_t kStageStride = sizeof(FwdStage<kInt8, kPV8>);
  constexpr uint32_t kVOffset = kFwdBKV * kD * (kInt8 ? 1 : 2);


  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kFwdStages;
    const int s_last = (j + kFwdStages - 1) % kFwdStages;
    const int kv0 = (order ? order[j] : j) * kFwdBKV;
    const bool partial = (kinds ? kinds[j] == 1 : false) ||
                         kv0 + kFwdBKV > p.Skv;
    mbar_wait(&sm.full[s], (j / kFwdStages) & 1);

    // ---- issue S_j = Q.K_j^T, then O += P_{j-1}.V_{j-1}, as two groups
    const uint32_t k_b = st_base + s * kStageStride;
    wgmma_fence();
    if constexpr (kInt8) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        wgmma_ss_n128_s8(S.v, wgmma_desc_sw64(q_b + kk * 32, 16, 512),
                         wgmma_desc_sw64(k_b + kk * 32, 16, 512), kk > 0);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n128<0, 0>(S.v, wgmma_desc(q_b + kk * 32, 16, 1024),
                            wgmma_desc(k_b + kk * 32, 16, 1024), kk > 0);
      }
    }
    wgmma_commit();
    if (j > 0) {
      const uint32_t v_b = st_base + s_last * kStageStride + kVOffset;
      if constexpr (kPV8) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_n64_s8(pv, pa[kk], wgmma_desc(v_b + kk * 32, 16, 1024),
                          kk > 0);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_rs_n64<1>(o, pa[kk], wgmma_desc(v_b + kk * 2048, 1024, 1024));
        }
      }
    }
    wgmma_commit();           // (empty for the first tile)
    // S_j is done; P_{j-1}.V_{j-1} runs on under the softmax of tile j,
    // whose writes touch no register of that product
    wgmma_wait<1>();
    reg_fence(S.v);

    // ---- scores of tile j, in the accumulator's registers, in log2
    // units; int8, s = f32(q8.k8) * sq * sk in JAX's order
    if constexpr (kInt8) {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float2 sk2 =
            *reinterpret_cast<const float2*>(&sm.st[s].ksc[n * 8 + t * 2]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = n * 4 + e;
          const float c = int_to_f32(S.v[i]);
          S.set(i, __fmul_rn(__fmul_rn(c, sqr[e >> 1]),
                             (e & 1) ? sk2.y : sk2.x));
        }
      }
    }
    if (partial) {   // masked scores and kv >= Skv: -inf, so p = 0
      // the frame indices of the video masks, once per row and column
      int q_frame[2], p_frame[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        q_frame[r] = floordiv_fast(qi[r], p.tpf, p.inv_tpf);
        p_frame[r] = floordiv_fast(qi[r] - p.iqe, p.pft, p.inv_pft) + 1;
      }
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = kv0 + n * 8 + t * 2 + c;
          const int kv_frame = floordiv_fast(kj, p.tpf, p.inv_tpf);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (!(kj < p.Skv && mask_keep(p, qi[r], q_frame[r], p_frame[r],
                                          kj, kv_frame))) {
              S.set(n * 4 + r * 2 + c, -INFINITY);
            }
          }
        }
      }
    }

    // ---- online softmax (log2 domain); four partial maxima and sums per
    // row, so that no long chain of dependent instructions holds a warp
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        mt[n & 3] = fmaxf(mt[n & 3], fmaxf(S.get(n * 4 + r * 2),
                                           S.get(n * 4 + r * 2 + 1)));
      }
      float tm = fmaxf(fmaxf(mt[0], mt[1]), fmaxf(mt[2], mt[3]));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
      // a fully masked tile leaves the running max (-1e30 at the start)
      const float mx = tm == -INFINITY ? m[r] : fmaxf(m[r], tm);
      alpha[r] = exp2_sfu(m[r] - mx);
      m[r] = mx;
      // a row that has seen only masked scores: exp2(-inf - 0) = 0, as
      // exp2(s - m) * keep = 0 in the JAX kernel
      mu[r] = mx == kNegInf ? 0.f : mx;
    }
    if constexpr (kExpBf16) {
      float ts[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t pb =
              ex2_bf16x2(pack_bf16(S.get(n * 4 + r * 2) - mu[r],
                                   S.get(n * 4 + r * 2 + 1) - mu[r]));
          const float lo = __uint_as_float(pb << 16);
          const float hi = __uint_as_float(pb & 0xffff0000u);
          ts[r][n & 3] += lo + hi;
          S.set(n * 4 + r * 2, lo);
          S.set(n * 4 + r * 2 + 1, hi);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tr = (ts[r][0] + ts[r][1]) + (ts[r][2] + ts[r][3]);
        tr += __shfl_xor_sync(0xffffffffu, tr, 1);
        tr += __shfl_xor_sync(0xffffffffu, tr, 2);
        const float tsum = __bfloat162float(__float2bfloat16_rn(tr));
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), tsum);
      }
    } else {
      float ls[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2_sfu(S.get(n * 4 + e) - mu[e >> 1]);
          S.set(n * 4 + e, pe);
          ls[e >> 1][n & 3] += pe;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] +
               ((ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]));
      }
    }

    // ---- P_{j-1}.V_{j-1} done: release its stage, then P_j into the A
    // fragments it read, and O rescaled
    wgmma_wait<0>();
    reg_fence(o);
    if constexpr (kPV8) reg_fence(pv);
    if (j > 0) {
      mbar_arrive(&sm.empty[s_last]);   // K_{j-1} and V_{j-1} are read
      if constexpr (kPV8) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          o[i] = __fadd_rn(o[i], __fmul_rn(int_to_f32(pv[i]), sv_last));
        }
      }
    }
    if constexpr (!kPV8) {
      // A fragment of kv columns 16 * kk ..: a[0] row g, a[1] row g + 8 of
      // the first 8 columns (tile n = 2 kk), a[2], a[3] of the next 8
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          pa[n >> 1][(n & 1) * 2 + r] =
              pack_bf16(S.get(n * 4 + r * 2), S.get(n * 4 + r * 2 + 1));
        }
      }
    } else {
      // p8 = rint(127 p), p in [0, 1], as the A operand (m16n8k32 s8 per
      // warp): a[0] = row g, columns 4t..4t+3 of the 32-column step, a[1]
      // the same for row g+8, a[2] / a[3] columns 16 + 4t... A thread
      // packs its codes per 8-column tile n (bytes (row g, col 2t), (g,
      // 2t+1), (g+8, 2t), (g+8, 2t+1)); the columns a lane needs sit in
      // tile 4kk + 2hh + (t >> 1) at lanes 2(t & 1) and 2(t & 1) + 1 of
      // its quad
      const int src0 = (lane & ~3) | ((t & 1) << 1);
      const bool upper = (t >> 1) != 0;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pk[4];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          uint32_t w = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t c = __float_as_uint(__fadd_rn(
                __fmul_rn(S.get((kk * 4 + nn) * 4 + e), 127.f), kMagic));
            w |= (c & 0xffu) << (8 * e);
          }
          pk[nn] = w;
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t x0 = __shfl_sync(0xffffffffu, pk[hh * 2], src0);
          const uint32_t x1 = __shfl_sync(0xffffffffu, pk[hh * 2 + 1], src0);
          const uint32_t y0 = __shfl_sync(0xffffffffu, pk[hh * 2], src0 + 1);
          const uint32_t y1 =
              __shfl_sync(0xffffffffu, pk[hh * 2 + 1], src0 + 1);
          const uint32_t lo = upper ? x1 : x0, hi = upper ? y1 : y0;
          pa[kk][2 * hh] = __byte_perm(lo, hi, 0x5410);       // row g
          pa[kk][2 * hh + 1] = __byte_perm(lo, hi, 0x7632);   // g + 8
        }
      }
      const int nvb = p.skv_p / p.v_block;
      sv_last = __fmul_rn(
          __ldg(&p.vsc[static_cast<size_t>(bh) * nvb + kv0 / p.v_block]),
          kInv127);
    }
    // alpha is exactly 1 where the running max did not move, as in most
    // tiles of a long row: the rescale is skipped where no row of the
    // warp moved, which changes no bit
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
  }

  // ---- the last tile's O += P.V
  if (n_tiles > 0) {
    const int s_last = (n_tiles - 1) % kFwdStages;
    const uint32_t v_b = st_base + s_last * kStageStride + kVOffset;
    wgmma_fence();
    if constexpr (kPV8) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n64_s8(pv, pa[kk], wgmma_desc(v_b + kk * 32, 16, 1024),
                        kk > 0);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_rs_n64<1>(o, pa[kk], wgmma_desc(v_b + kk * 2048, 1024, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    if constexpr (kPV8) {
      reg_fence(pv);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        o[i] = __fadd_rn(o[i], __fmul_rn(int_to_f32(pv[i]), sv_last));
      }
    }
    mbar_arrive(&sm.empty[s_last]);
  }

  // ---- epilogue: full row sums, normalise, out through shared memory
  if constexpr (!kExpBf16) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
  unsigned char* ob = reinterpret_cast<unsigned char*>(sm.q);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + r * 8;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(ob + row * 128 + ((n ^ (row & 7)) << 4) +
                                   t * 4) =
          pack_bf16(__fdiv_rn(o[n * 4 + r * 2], denom),
                    __fdiv_rn(o[n * 4 + r * 2 + 1], denom));
    }
    if (t == 0 && qi[r] < p.Sq) {
      p.lse[static_cast<size_t>(bh) * p.Sq + qi[r]] =
          l[r] > 0.f ? m[r] + log2f(denom) : kNegInf;
    }
  }
  fence_async_smem();
  named_barrier(kWarpgroupBarrier + cw, 128);
  if (ct == 0) {
    tma_store_4d(&tm_o, ob + cw * 64 * 128, 0, h, q0 + cw * 64, b);
    bulk_commit();
    bulk_wait_read<0>();
  }
}

// The int8 forward's prologue, the quantization of K per kv position
// (flash_attention :565-570, outside JAX's kernel): one 8-thread group per
// (b, s, h) row of 64, s < Skv_pad, rows in BSHD order (coalesced): sk =
// max(|k|, 1e-30) * f32(1/127), codes rint(k / sk) (IEEE division, half
// to even) into k8 (BSHD int8), sk into ksc (B*H, Skv_pad), 0 past Skv.
__global__ void __launch_bounds__(256)
quantize_k_kernel(const __nv_bfloat16* k, int8_t* k8, float* ksc, int B,
                  int Skv, int H, int skv_pad) {
  const long long rows = static_cast<long long>(B) * skv_pad * H;
  const long long row = static_cast<long long>(blockIdx.x) * 32 +
                        threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  const bool live = row < rows;
  const int h = static_cast<int>(row % H);
  const int s = static_cast<int>((row / H) % skv_pad);
  const int b = static_cast<int>(row / (static_cast<long long>(H) * skv_pad));
  const bool in = live && s < Skv;
  const size_t off = ((static_cast<size_t>(b) * Skv + s) * H + h) * kD +
                     part * 8;
  float x[8];
  float amax = 0.f;
  if (in) {
    const uint4 w = *reinterpret_cast<const uint4*>(k + off);
    const uint32_t* h2 = reinterpret_cast<const uint32_t*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[2 * e] = __uint_as_float(h2[e] << 16);
      x[2 * e + 1] = __uint_as_float(h2[e] & 0xffff0000u);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(x[e]));
  }
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
  }
  const float sk = __fmul_rn(fmaxf(amax, 1e-30f), kInv127);
  if (in) {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = static_cast<int>(rintf(__fdiv_rn(x[e], sk)));
      w[e / 4] |= static_cast<uint32_t>(c & 0xff) << (8 * (e % 4));
    }
    *reinterpret_cast<uint2*>(k8 + off) = make_uint2(w[0], w[1]);
  }
  if (live && part == 0) {
    ksc[(static_cast<size_t>(b) * H + h) * skv_pad + s] = in ? sk : 0.f;
  }
}

// a BSHD tensor (B, S, H, 64) of 1- or 2-byte elements read in boxes of
// `rows` rows of one (b, h)
int bshd_map(CUtensorMap* map, const void* base, int B, int S, int H,
             int rows, bool int8) {
  const cuuint64_t esz = int8 ? 1 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {kD * esz,
                                 static_cast<cuuint64_t>(H) * kD * esz,
                                 static_cast<cuuint64_t>(S) * H * kD * esz};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kD), 1,
                             static_cast<cuuint32_t>(rows), 1};
  return landiff_tensor_map(
      map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, base, dims, strides, box,
      int8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool kInt8, bool kPV8>
int smem_bytes() {
  return static_cast<int>(sizeof(FwdSmem<kInt8, kPV8>)) + 1024;
}

template <bool kInt8, bool kPV8, bool kExpBf16>
int launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
           const CUtensorMap& tm_v, const CUtensorMap& tm_o, const Params& p,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<kInt8, kPV8, kExpBf16>;
  const int bytes = smem_bytes<kInt8, kPV8>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + kFwdBQ - 1) / kFwdBQ, p.B * p.H);
  kernel<<<grid, kFwdThreads, bytes, stream>>>(tm_q, tm_k, tm_v, tm_o, p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const float* ksc, const float* vsc, float* lse,
                   const int* count, const int* order, const int* kind, int B,
                   int H, int Sq, int Skv, int nk_table, float qscale,
                   int mask_kind, int nf, int tpf, int iqt, int pft,
                   int v_block, int skv_p) {
  Params p;
  p.ksc = ksc;
  p.vsc = vsc;
  p.lse = lse;
  p.count = count;
  p.order = order;
  p.kind = kind;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.nk_table = nk_table;
  p.skv_pad = (Skv + kFwdBKV - 1) / kFwdBKV * kFwdBKV;
  p.qscale = qscale;
  p.mask_kind = mask_kind;
  p.nf = nf;
  p.tpf = tpf;
  p.iqt = iqt;
  p.pft = pft;
  p.iqe = nf * tpf + iqt;
  p.inv_tpf = 1.f / static_cast<float>(tpf);
  p.inv_pft = 1.f / static_cast<float>(pft);
  p.v_block = v_block;
  p.skv_p = skv_p;
  return p;
}

// the q, k (bf16 or int8 codes) and out maps of one launch
int qko_maps(CUtensorMap* tm_q, CUtensorMap* tm_k, CUtensorMap* tm_o,
             const void* q, const void* k, void* o, int B, int H, int Sq,
             int Skv, bool int8) {
  int rc = bshd_map(tm_q, q, B, Sq, H, kFwdBQ, false);
  if (rc == 0) rc = bshd_map(tm_k, k, B, Skv, H, kFwdBKV, int8);
  if (rc == 0) rc = bshd_map(tm_o, o, B, Sq, H, 64, false);
  return rc;
}

}  // namespace

// Plain C interface (bound with ctypes). Each returns 0, a cudaError_t of
// the launch (or of raising the kernel's shared-memory limit), or, for a
// tensor map that could not be encoded, 1000 + its CUresult (-1: no
// cuTensorMapEncodeTiled entry point). Tiles: 192 q rows x 128 kv rows;
// head dim 64 only; every tensor 16-byte aligned. exp_bf16 != 0 selects
// the bf16-exp2 variant.
extern "C" int landiff_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* count, const int* order, const int* kind, int B, int H, int Sq,
    int Skv, int nk_table, float qscale, int mask_kind, int nf, int tpf,
    int iqt, int pft, int exp_bf16, void* stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int rc = qko_maps(&tm_q, &tm_k, &tm_o, q, k, o, B, H, Sq, Skv, false);
  if (rc == 0) rc = bshd_map(&tm_v, v, B, Skv, H, kFwdBKV, false);
  if (rc != 0) return rc < 0 ? rc : 1000 + rc;
  const Params p = make_params(nullptr, nullptr, lse, count, order, kind, B,
                               H, Sq, Skv, nk_table, qscale, mask_kind, nf,
                               tpf, iqt, pft, 0, 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exp_bf16 ? launch<false, false, true>(tm_q, tm_k, tm_v, tm_o, p, st)
                  : launch<false, false, false>(tm_q, tm_k, tm_v, tm_o, p, st);
}

// k8: int8 BSHD codes; ksc: (B*H, Skv_pad) f32 scales, Skv_pad = Skv
// rounded up to 128, zero past Skv. vsc null: v is bf16 BSHD and p.v runs
// in bf16. vsc set (int8_pv): v is the int8 (B*H, 64, skv_p) codes and vsc
// the (B*H, skv_p / v_block) f32 scales; v_block is a multiple of 128 and
// divides skv_p >= Skv.
extern "C" int landiff_flash_fwd_i8(
    const void* q, const void* k8, const float* ksc, const void* v,
    const float* vsc, void* o, float* lse, const int* count, const int* order,
    const int* kind, int B, int H, int Sq, int Skv, int nk_table,
    float qscale, int mask_kind, int nf, int tpf, int iqt, int pft,
    int v_block, int skv_p, int exp_bf16, void* stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int rc = qko_maps(&tm_q, &tm_k, &tm_o, q, k8, o, B, H, Sq, Skv, true);
  if (rc == 0 && vsc) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(skv_p),
                                static_cast<cuuint64_t>(kD),
                                static_cast<cuuint64_t>(B) * H};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(skv_p),
                                   static_cast<cuuint64_t>(skv_p) * kD};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(kFwdBKV),
                               static_cast<cuuint32_t>(kD), 1};
    rc = landiff_tensor_map(&tm_v, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, v, dims,
                            strides, box);
  } else if (rc == 0) {
    rc = bshd_map(&tm_v, v, B, Skv, H, kFwdBKV, false);
  }
  if (rc != 0) return rc < 0 ? rc : 1000 + rc;
  const Params p = make_params(ksc, vsc, lse, count, order, kind, B, H, Sq,
                               Skv, nk_table, qscale, mask_kind, nf, tpf, iqt,
                               pft, v_block, skv_p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vsc) {
    return exp_bf16 ? launch<true, true, true>(tm_q, tm_k, tm_v, tm_o, p, st)
                    : launch<true, true, false>(tm_q, tm_k, tm_v, tm_o, p, st);
  }
  return exp_bf16 ? launch<true, false, true>(tm_q, tm_k, tm_v, tm_o, p, st)
                  : launch<true, false, false>(tm_q, tm_k, tm_v, tm_o, p, st);
}

// The int8 forward's prologue: k (B, Skv, H, 64) bf16 -> k8 (the same
// shape, int8) and ksc (B*H, Skv_pad) f32, Skv_pad = Skv rounded up to
// 128.
extern "C" int landiff_flash_quantize_k(const void* k, void* k8, float* ksc,
                                        int B, int Skv, int H, int skv_pad,
                                        void* stream) {
  const long long rows = static_cast<long long>(B) * skv_pad * H;
  quantize_k_kernel<<<static_cast<unsigned>((rows + 31) / 32), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<int8_t*>(k8), ksc, B,
      Skv, H, skv_pad);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's dynamic shared memory per CTA, in bytes, by form.
extern "C" int landiff_flash_fwd_smem_bytes(int int8, int int8_pv) {
  return int8_pv ? smem_bytes<true, true>()
                 : (int8 ? smem_bytes<true, false>()
                         : smem_bytes<false, false>());
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
