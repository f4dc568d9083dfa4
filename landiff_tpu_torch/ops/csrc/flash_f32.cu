// Flash attention in f32 for the H100 (sm_90a): the forms the Pallas
// kernels of landiff_tpu/ops/attention.py take when given f32 refs.
//
//   landiff_flash_fwd_f32: the exact forward (_flash_kernel :91 /
//     _flash_kernel_cached :197 with f32 q / k / v): q' = q * scale*log2e in
//     f32, s = q'.k^T, online softmax in log2 units, p kept in f32 (the V
//     dtype, _softmax_tile), out = acc / max(l, 1e-30), the log2 lse
//     written (-1e30 for a fully masked row, whose output is 0). exp_bf16
//     (_softmax_tile :44-50): p = ex2.approx.ftz.bf16x2(bf16(s - m)), the
//     tile's row sum of the bf16 p taken in f32 and rounded to bf16 before
//     l = l * alpha + sum; p.v in f32.
//   landiff_flash_fwd_i8_f32: the int8-score forward (_flash_kernel_cached_i8
//     :264 with f32 inputs): q quantized per row in the CTA (absmax, IEEE
//     division, half to even), K per kv position by the prologue
//     landiff_flash_quantize_k_f32; s = f32(q8.k8) * sq * sk in JAX's order
//     from exact int32 sums (__dp4a); p.v in f32. int8_pv (:338-348): V
//     quantized per V block by the wrapper (attention.quantize_v_blocks, as
//     :573-584), p8 = rint(127 p), p8.v8 summed exactly in int32 (__dp4a)
//     and acc = acc * alpha + f32(p8.v8) * (sv * f32(1/127)); exp_bf16 as
//     above. SIMT (FFMA / DP4A on the CUDA cores), 64 x 64 tiles.
//   landiff_flash_bwd_prep_f32 / landiff_flash_bwd_f32: the fused backward
//     (_flash_bwd_fused_kernel :658 with f32 refs): p = exp2(s - lse) * keep,
//     dp = do.v^T, ds = p * (dp - delta), dv += p^T.do, dk += (scale*ds)^T.q,
//     dq += (scale*ds).k, q' = q * scale*log2e and every sum in f32.
//
// The exact forward and the backward run their products on the tensor
// cores in TF32 with three passes ("3xTF32"): x = hi + lo with hi =
// tf32(x) (cvt.rna) and lo = tf32(x - hi), a.b = hi.hi + hi.lo + lo.hi in
// f32 (the small products first), which leaves lo.lo, under 2^-21 of
// |a||b|: about f32's own error, where one TF32 pass is about 1e-3. A bf16
// p (exp_bf16) is exact in TF32: its p.v takes two passes. The tensor
// cores' sums lose low bits (one accumulator carried over a whole kv loop
// drifted far outside the f32 limits), so a product sums at most one
// 64-wide contraction into a fresh accumulator (kFwdGroup, kBwdGroup k8
// slices), which is then added into the result in f32, rounded to
// nearest.
//
// wgmma reads a 32-bit operand from shared memory only K-major (the
// contraction contiguous; there is no transpose bit as for bf16), and A may
// come from registers. Both kernels take every A from registers (split
// there) and every B from 128-byte-swizzled tiles of 32 columns that TMA
// writes. A operand that comes from an accumulator (p for p.v, ds for ds.k)
// holds columns 2t, 2t + 1 of each 8-column group where the A fragment
// wants t, t + 4: its B tile is stored with each 8-row group of the
// contraction permuted (position j holds row 2j for j < 4, 2(j - 4) + 1
// after), so the registers are taken as they are. The prologues make the
// split and transposed copies in device memory (landiff_tf32_split,
// landiff_tf32_split_t):
//   forward: K hi / lo (BSHD), V^T hi / lo (B*H, 64, Skv_pad64) permuted;
//   backward: K, V hi / lo (BSHD), K^T hi / lo permuted; q and do are read
//     raw and split in registers, in both orientations, by the consumers.
//
// Forward design: one CTA per (128 q rows, b*h), 384 threads: a producer
// warpgroup (one thread issues the TMA loads of each visible 64-row kv
// tile's K hi / lo and V^T hi / lo into a 3-stage ring: 64 KB a stage, 192
// KB) and two consumer warpgroups of 64 q rows, whose q' hi / lo sit in
// registers as A fragments for the whole kv loop. Per kv tile a consumer
// takes S = q'.K^T (24 wgmma m64n64k8), the online softmax
// (as the bf16 forward, flash_fwd.cu), O rescaled, then O += P.V (A = p
// split in registers). A warpgroup waits for each group of its products
// (its accumulators and A fragments fill its 240 registers): the two
// warpgroups' softmax and products interleave on the SM.
//
// Backward design: one CTA per (64-row kv tile, b*h), 384 threads: a
// producer warpgroup (K, V, K^T hi / lo once, 96 KB; then each visible
// 64-row q tile's raw q and do, 32 KB, into a ring of two stages) and two
// consumer warpgroups that take the q tiles in turns (even, odd), each
// with its own stage, in the q-major orientation (q rows are the wgmma's
// M):
//   S = q'.K^T  (A = q' split from the raw q tile), P = exp2(S - lse) *
//     keep in its registers, its split stored as P^T hi / lo [kv][q]
//   dV^T += do^T.P   (A = do^T, the raw do tile read across, split)
//   dP = do.V^T (A = do), dS = P * (dP - delta) * scale, P read back as
//     hi + lo (exact in f32, within 2^-22 of p)
//   dS^T hi / lo -> shared [kv][q]; dK^T += q^T.dS   (A = q^T)
//   dQ = dS.K  (A = dS's split read back in the accumulator's order, B =
//     K^T permuted), through the warpgroup's p / ds buffer as a [64 q][64
//     d] f64 box into the f64 workspace by one bulk reduce-add
//     (cp.reduce.async.bulk .add.f64)
// The consumer's 240 registers hold dV^T, dK^T, a fresh accumulator, the
// product at hand and one slice's A fragments: p and ds are read back from
// shared memory rather than kept, a product sums one k8 slice a group
// (kBwdGroup) and waits for it, and the video masks' loop stays rolled
// (ptxas spilled otherwise). The other warpgroup's products run meanwhile.
// The f32 limits bind on the sums: dV^T and dK^T take each q tile's
// slices summed afresh and add them once a tile, not once a slice (the
// sum of 1,112 f32 adds at the DiT shape missed the limits; PERF.md); dq
// is summed across kv tiles in f64. dV^T and dK^T of the two warpgroups are summed through shared
// memory at the end and written once: deterministic. dq's reduce-adds come
// in no fixed order: the last bits of its f64 sums vary from run to run.
//
// Shared memory (227 KB, 232,448 B, a CTA): forward 3 stages x (K hi, lo,
// V^T hi, lo: 4 x 16 KB) = 192 KB; backward 6 x 16 KB fixed (K, V, K^T hi /
// lo) + 2 stages x 32 KB (raw q, do) + 2 x 32 KB (each warpgroup's p / ds
// hi, lo) = 224 KB, plus 1 KB of alignment slack. The bf16 backward's
// 128-row kv tiles would need twice the fixed tiles: 64-row ones it is,
// and the q side's transposes are made in registers rather than stored
// (4 more tiles a stage).
//
// Bounds on the H100 (B=1 S=17,776 H=30 D=64, unmasked): forward 4 *
// B*H*S^2*D = 2.43 TFLOP, 3x that at the TF32 peak of 495 TFLOP/s = 14.7
// ms (the CUDA cores at 67 TFLOP/s: 36.2 ms); backward 10 * B*H*S^2*D x 3
// at 495 = 36.8 ms (90.6 on the CUDA cores). B*H*S^2 = 9.5e9 exp2 take 2.3
// ms on the SFUs; the bytes are far below. Bound by the tensor cores.
//
// exp2 is ex2.approx.ftz.f32 (about 2 ulp), as in the bf16 kernels. The
// mask algebra and the visibility / tile tables are the bf16 kernels'
// (flash_common.cuh): per 128-row q tile its visible 64-row kv tiles
// (exact forward), per 64 x 64 tile (int8 forward), per 64-row kv tile its
// 64-row q tiles (backward). The build must not use --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kT = 64;          // the int8 forward's q and kv rows per tile
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 block each
constexpr int kSkvPad = 128;    // the K scales' padding (the bf16 kernels')
constexpr float kInv127f = 1.0f / 127.0f;

struct Mask {
  int mask_kind, nf, tpf, iqt, pft, iqe;
  float inv_tpf, inv_pft;
};

Mask make_mask(int mask_kind, int nf, int tpf, int iqt, int pft) {
  Mask m;
  m.mask_kind = mask_kind;
  m.nf = nf;
  m.tpf = tpf;
  m.iqt = iqt;
  m.pft = pft;
  m.iqe = nf * tpf + iqt;
  m.inv_tpf = 1.f / static_cast<float>(tpf);
  m.inv_pft = 1.f / static_cast<float>(pft);
  return m;
}

// keep of score (q, kv) for the tile's rows / columns (kv < Skv checked by
// the caller)
__device__ __forceinline__ bool keep_score(const Mask& m, int q, int kv) {
  if (m.mask_kind == kMaskNone) return true;
  if (m.mask_kind == kMaskCausal) return q >= kv;
  const int q_frame = floordiv_fast(q, m.tpf, m.inv_tpf);
  const int p_frame = floordiv_fast(q - m.iqe, m.pft, m.inv_pft) + 1;
  return keep_frames(m, q, q_frame, p_frame, kv,
                     floordiv_fast(kv, m.tpf, m.inv_tpf));
}

// ---------------------------------------------------------------------------
// the int8-score forward (SIMT)

// A (row, 4-column chunk) of a 64 x 64 tile stored with its chunks XORed
// by the row's own chunk, so that a thread block's float4 stores of a
// transposed tile fall into distinct banks; a row's reads stay float4.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kT + ((chunk ^ ((row >> 2) & 15)) << 2);
}

// The tile in its own layout, n[r * 64 + d]; rows past `rows` zero.
__device__ __forceinline__ void load_n(float* n, const float* x, int b, int S,
                                       int H, int h, int r0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (threadIdx.x >> 4) + 16 * i;
    const int c = threadIdx.x & 15;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) {
      w = *reinterpret_cast<const float4*>(
          x + ((static_cast<size_t>(b) * S + r0 + r) * H + h) * kD + 4 * c);
    }
    *reinterpret_cast<float4*>(n + r * kT + 4 * c) = w;
  }
}

// acc[i][j] += sum_k a[k] (row, chunk ty, swizzled) * b[k * 64 + 4 tx + j],
// k < 64: the thread's 4 x 4 block of a 64 x 64 x 64 product.
__device__ __forceinline__ void mma_tile_swz(float (&acc)[4][4],
                                             const float* a, const float* b,
                                             int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < kT; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(a + swz(k, ty));
    const float4 y = *reinterpret_cast<const float4*>(b + k * kT + 4 * tx);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
    }
  }
}

// row reductions over the 16 threads (lanes tx = 0..15 of a half warp)
// that hold a row's 64 columns
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  }
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

struct I8Smem {
  int32_t q8[16 * kT];   // q codes, 4 per word, transposed
  float sq[kT];          // the rows' scales times qscale
  int32_t k8[16 * kT];   // k codes transposed
  float sk[kT];          // the tile's K scales
  float v[kT * kT];      // v, kv-major (f32 p.v)
  float p[kT * kT];      // p, kv-major, swizzled (f32 p.v)
  int32_t v8[16 * kT];   // int8_pv: v codes, 4 kv per word, [word][d]
  int32_t p8[16 * kT];   // int8_pv: p codes, 4 kv per word, [word][q]
};

struct I8Args {
  const float* q;
  const int8_t* k8;      // codes BSHD
  const float* ksc;      // (B*H, skv_pad)
  const void* v;         // f32 BSHD, or int8_pv: codes (B*H, 64, skv_p)
  const float* vsc;      // int8_pv: (B*H, skv_p / v_block)
  float* o;
  float* lse;
  const int* count;      // null: every kv tile visible
  const int* order;
  const int* kind;
  int B, H, Sq, Skv, nk_table, skv_pad, v_block, skv_p;
  float qscale;
  Mask mask;
};

template <bool kPV8, bool kExpBf16>
__global__ void __launch_bounds__(kThreads)
flash_fwd_i8_f32_kernel(const I8Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  I8Smem& sm = *reinterpret_cast<I8Smem*>(smem_raw);
  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qt * kT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // the row codes: 16 threads (a half warp) per row, a float4 each
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < a.Sq) {
      w = *reinterpret_cast<const float4*>(
          a.q + ((static_cast<size_t>(b) * a.Sq + q0 + r) * a.H + h) * kD +
          4 * tx);
    }
    float amax = fmaxf(fmaxf(fabsf(w.x), fabsf(w.y)),
                       fmaxf(fabsf(w.z), fabsf(w.w)));
    amax = row_max(amax);
    const float sq = __fmul_rn(fmaxf(amax, 1e-30f), kInv127f);
    const float xs[4] = {w.x, w.y, w.z, w.w};
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = static_cast<int>(rintf(__fdiv_rn(xs[e], sq)));
      word |= static_cast<uint32_t>(c & 0xff) << (8 * e);
    }
    sm.q8[tx * kT + r] = static_cast<int32_t>(word);
    if (tx == 0) sm.sq[r] = __fmul_rn(sq, a.qscale);
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int nkv = a.count ? a.count[qt] : (a.Skv + kT - 1) / kT;
  const int* order = a.order ? a.order + static_cast<size_t>(qt) * a.nk_table
                             : nullptr;
  const int* kinds = a.kind ? a.kind + static_cast<size_t>(qt) * a.nk_table
                            : nullptr;
  for (int j = 0; j < nkv; ++j) {
    const int kt = order ? order[j] : j;
    const int kv0 = kt * kT;
    const bool partial = (kinds && kinds[j] == 1) || kv0 + kT > a.Skv;
    __syncthreads();   // the previous tile's k, v and p are consumed
    {
      const int r = tid & 63;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = (tid >> 6) + 4 * i;
        int32_t w = 0;
        if (kv0 + r < a.Skv) {
          w = *reinterpret_cast<const int32_t*>(
              a.k8 + ((static_cast<size_t>(b) * a.Skv + kv0 + r) * a.H + h) *
                         kD + 4 * c);
        }
        sm.k8[c * kT + r] = w;
      }
      if (tid < kT) {
        sm.sk[tid] = a.ksc[static_cast<size_t>(bh) * a.skv_pad + kv0 + tid];
      }
    }
    if constexpr (kPV8) {
      // the V codes of kv 4w..4w+3 of column d, one word each (kv0 lies
      // inside the padded skv_p, zero past Skv)
      const int32_t* vc = static_cast<const int32_t*>(a.v) +
                          (static_cast<size_t>(bh) * kD * a.skv_p + kv0) / 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + kThreads * i;
        const int w = idx & 15, d = idx >> 4;
        sm.v8[w * kT + d] = vc[static_cast<size_t>(d) * (a.skv_p / 4) + w];
      }
    } else {
      load_n(sm.v, static_cast<const float*>(a.v), b, a.Skv, a.H, h, kv0);
    }
    __syncthreads();

    float s[4][4];
    {
      int si[4][4] = {};
#pragma unroll 4
      for (int w = 0; w < 16; ++w) {
        const int4 x = *reinterpret_cast<const int4*>(sm.q8 + w * kT + 4 * ty);
        const int4 y = *reinterpret_cast<const int4*>(sm.k8 + w * kT + 4 * tx);
        const int xs[4] = {x.x, x.y, x.z, x.w};
        const int ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) si[i][c] = __dp4a(xs[i], ys[c], si[i][c]);
        }
      }
      const float4 sk4 = *reinterpret_cast<const float4*>(sm.sk + 4 * tx);
      const float sks[4] = {sk4.x, sk4.y, sk4.z, sk4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sqi = sm.sq[4 * ty + i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = __fmul_rn(__fmul_rn(static_cast<float>(si[i][c]), sqi),
                              sks[c]);
        }
      }
    }
    if (partial) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kv = kv0 + 4 * tx + c;
          if (!(kv < a.Skv && keep_score(a.mask, q0 + 4 * ty + i, kv))) {
            s[i][c] = -INFINITY;
          }
        }
      }
    }
    // online softmax (log2 units); a fully masked tile keeps the running
    // max (-1e30 at the start), so its p are exp2(-inf) = 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tm = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      tm = row_max(tm);
      const float mx = tm == -INFINITY ? m[i] : fmaxf(m[i], tm);
      const float alpha = exp2_sfu(m[i] - mx);
      m[i] = mx;
      if constexpr (kExpBf16) {
        float ts = 0.f;
#pragma unroll
        for (int c = 0; c < 4; c += 2) {
          const uint32_t pb = ex2_bf16x2(pack_bf16(s[i][c] - mx,
                                                   s[i][c + 1] - mx));
          s[i][c] = __uint_as_float(pb << 16);
          s[i][c + 1] = __uint_as_float(pb & 0xffff0000u);
          ts += s[i][c] + s[i][c + 1];
        }
        const float tsum = __bfloat162float(__float2bfloat16_rn(row_sum(ts)));
        l[i] = __fadd_rn(__fmul_rn(l[i], alpha), tsum);
      } else {
        float ts = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = exp2_sfu(s[i][c] - mx);
          ts += s[i][c];
        }
        l[i] = fmaf(l[i], alpha, row_sum(ts));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }
    if constexpr (kPV8) {
      // p8 = rint(127 p), the codes of kv 4tx..4tx+3 of row 4ty+i in word
      // tx; the 4-row chunk XORed by the word, so that the stores of a
      // half warp fall into distinct banks
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t word = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int code = __float2int_rn(__fmul_rn(s[i][c], 127.f));
          word |= static_cast<uint32_t>(code & 0xff) << (8 * c);
        }
        sm.p8[tx * kT + 4 * (ty ^ tx) + i] = static_cast<int32_t>(word);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {   // p^T: row kv, chunk ty
        *reinterpret_cast<float4*>(sm.p + swz(4 * tx + c, ty)) =
            make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      }
    }
    __syncthreads();
    if constexpr (kPV8) {
      int pv[4][4] = {};
#pragma unroll 4
      for (int w = 0; w < 16; ++w) {
        const int4 x =
            *reinterpret_cast<const int4*>(sm.p8 + w * kT + 4 * (ty ^ w));
        const int4 y = *reinterpret_cast<const int4*>(sm.v8 + w * kT + 4 * tx);
        const int xs[4] = {x.x, x.y, x.z, x.w};
        const int ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) pv[i][c] = __dp4a(xs[i], ys[c], pv[i][c]);
        }
      }
      // the V block's scale over 127, constant over the tile: a V block is
      // a multiple of 128 rows
      const float svs = __fmul_rn(
          __ldg(a.vsc + static_cast<size_t>(bh) * (a.skv_p / a.v_block) +
                kv0 / a.v_block),
          kInv127f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][c] = __fadd_rn(acc[i][c],
                                __fmul_rn(static_cast<float>(pv[i][c]), svs));
        }
      }
    } else {
      mma_tile_swz(acc, sm.p, sm.v, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + 4 * ty + i;
    if (q >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float4 w;
    w.x = __fdiv_rn(acc[i][0], denom);
    w.y = __fdiv_rn(acc[i][1], denom);
    w.z = __fdiv_rn(acc[i][2], denom);
    w.w = __fdiv_rn(acc[i][3], denom);
    *reinterpret_cast<float4*>(
        a.o + ((static_cast<size_t>(b) * a.Sq + q) * a.H + h) * kD + 4 * tx) =
        w;
    if (tx == 0) {
      a.lse[static_cast<size_t>(bh) * a.Sq + q] =
          l[i] > 0.f ? m[i] + log2f(denom) : kNegInf;
    }
  }
}

// The int8 forward's prologue from f32 K: one 16-thread group per (b, s, h)
// row of 64, s < Skv_pad: sk = max(|k|, 1e-30) * f32(1/127), codes
// rint(k / sk) (IEEE division, half to even) into k8 (BSHD int8), sk into
// ksc (B*H, Skv_pad), 0 past Skv.
__global__ void __launch_bounds__(256)
quantize_k_f32_kernel(const float* k, int8_t* k8, float* ksc, int B, int Skv,
                      int H, int skv_pad) {
  const long long rows = static_cast<long long>(B) * skv_pad * H;
  const long long row = static_cast<long long>(blockIdx.x) * 16 +
                        threadIdx.x / 16;
  const int part = threadIdx.x % 16;
  const bool live = row < rows;
  const int h = static_cast<int>(row % H);
  const int s = static_cast<int>((row / H) % skv_pad);
  const int b = static_cast<int>(row / (static_cast<long long>(H) * skv_pad));
  const bool in = live && s < Skv;
  const size_t off = ((static_cast<size_t>(b) * Skv + s) * H + h) * kD +
                     part * 4;
  float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
  if (in) w = *reinterpret_cast<const float4*>(k + off);
  float amax = fmaxf(fmaxf(fabsf(w.x), fabsf(w.y)),
                     fmaxf(fabsf(w.z), fabsf(w.w)));
  amax = row_max(amax);
  const float sk = __fmul_rn(fmaxf(amax, 1e-30f), kInv127f);
  if (in) {
    const float xs[4] = {w.x, w.y, w.z, w.w};
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = static_cast<int>(rintf(__fdiv_rn(xs[e], sk)));
      word |= static_cast<uint32_t>(c & 0xff) << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(k8 + off) = word;
  }
  if (live && part == 0) {
    ksc[(static_cast<size_t>(b) * H + h) * skv_pad + s] = in ? sk : 0.f;
  }
}

// ---------------------------------------------------------------------------
// prologues of the 3xTF32 kernels

// hi = tf32(x), lo = tf32(x - hi) of n4 float4s
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float4* x, uint4* hi, uint4* lo, long long n4) {
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * 256) {
    const float4 v = x[i];
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// x (B, S, H, 64) f32 -> hi, lo (B*H, 64, S_pad): transposed, split, each
// 8-row group of s permuted (position j holds s 2j for j < 4, 2(j - 4) + 1
// after), zero where s >= S. One block per (64 rows of s, b*h) through a padded
// shared tile: reads along d, writes along s, both coalesced.
__global__ void __launch_bounds__(256)
tf32_split_t_kernel(const float* x, float* hi, float* lo, int S, int H,
                    int S_pad) {
  __shared__ float tile[64][65];
  const int s0 = blockIdx.x * 64, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  for (int i = threadIdx.x; i < 64 * 64; i += 256) {
    const int r = i >> 6, d = i & 63;
    tile[r][d] = s0 + r < S
        ? x[((static_cast<size_t>(b) * S + s0 + r) * H + h) * kD + d]
        : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 64; i += 256) {
    const int d = i >> 6, p = i & 63, j = p & 7;
    const int r = (p & ~7) + (j < 4 ? 2 * j : 2 * (j - 4) + 1);
    uint32_t vh, vl;
    split_tf32(tile[r][d], vh, vl);
    const size_t off = (static_cast<size_t>(bh) * kD + d) * S_pad + s0 + p;
    hi[off] = __uint_as_float(vh);
    lo[off] = __uint_as_float(vl);
  }
}

// The backward's prologue in f32: one 16-thread group per (b, s, h) row,
// s < Sq_pad: delta = rowsum(do * out) and the lse (+inf past Sq) into (B,
// H, Sq_pad), zeros into the f64 dq workspace (B, H, Sq_pad, 64).
__global__ void __launch_bounds__(256)
bwd_prep_f32_kernel(const float* out, const float* dout, const float* lse,
                    float* lse_pad, float* delta, double* dq, int B, int H,
                    int Sq, int Sq_pad) {
  const long long rows = static_cast<long long>(B) * Sq_pad * H;
  const long long row = static_cast<long long>(blockIdx.x) * 16 +
                        threadIdx.x / 16;
  const int part = threadIdx.x % 16;
  const bool live = row < rows;
  const int h = static_cast<int>(row % H);
  const int sp = static_cast<int>((row / H) % Sq_pad);
  const int b = static_cast<int>(row / (static_cast<long long>(H) * Sq_pad));
  const bool in = live && sp < Sq;
  const size_t off = ((static_cast<size_t>(b) * Sq + sp) * H + h) * kD +
                     part * 4;
  float d = 0.f;
  if (in) {
    const float4 o = *reinterpret_cast<const float4*>(out + off);
    const float4 g = *reinterpret_cast<const float4*>(dout + off);
    d = fmaf(o.w, g.w, fmaf(o.z, g.z, fmaf(o.y, g.y, o.x * g.x)));
  }
  d = row_sum(d);
  const size_t stat = (static_cast<size_t>(b) * H + h) * Sq_pad + sp;
  if (live) {
    double2* z = reinterpret_cast<double2*>(dq + stat * kD + part * 4);
    z[0] = make_double2(0.0, 0.0);
    z[1] = make_double2(0.0, 0.0);
    if (part == 0) {
      delta[stat] = d;
      lse_pad[stat] =
          in ? lse[(static_cast<size_t>(b) * H + h) * Sq + sp] : INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// the 3xTF32 kernels

constexpr uint32_t kTile = 64 * 64 * 4;   // a 64 x 64 f32 tile: 16 KB
constexpr int kHalf = 64 * 32;            // floats of one 32-column half
// k8 slices of a contraction that the tensor cores sum into one fresh
// accumulator, which is then added into the result in f32 (round to
// nearest): the tensor cores' sums lose low bits, and a sum carried over a
// whole kv loop drifted far outside the f32 limits (PERF.md). The forward
// sums a whole 64-wide contraction a group; the backward, whose limits are
// tighter and whose registers are fewer, one k8 slice (more exact and
// slower: chip_ablation.py).
constexpr int kFwdGroup = 8;
constexpr int kBwdGroup = 1;

// byte offset of (row, col) in a 64 x 64 f32 tile kept as two
// 128-byte-swizzled halves of 32 columns
__device__ __forceinline__ uint32_t f32_off(int row, int col) {
  return (col >> 5) * 8192 + row * 128 +
         ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
}

// descriptor of such a tile's first k8 slice as a K-major wgmma operand;
// slice kk is + slice_step(kk) (the start address field counts 16 B, and
// no tile reaches the field's 256 KB end)
__device__ __forceinline__ uint64_t tile_desc(uint32_t base) {
  uint64_t d = wgmma_desc(base, 16, 1024);
  // opaque to the optimizer, so that it does not hoist every slice's
  // descriptor out of a loop into registers
  asm volatile("" : "+l"(d));
  return d;
}
__host__ __device__ constexpr uint64_t slice_step(int kk) {
  return static_cast<uint64_t>((kk >> 2) * 512 + (kk & 3) * 2);
}

// shared-memory loads and stores by 32-bit address (a generic pointer
// takes two registers)
__device__ __forceinline__ float lds(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}
__device__ __forceinline__ void sts(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(x) : "memory");
}
// two f32 values widened to f64 and stored (the widening inside the asm:
// no f64 registers live outside it)
__device__ __forceinline__ void sts2_f64(uint32_t addr, float x, float y) {
  asm volatile(
      "{\n .reg .f64 a, b;\n cvt.f64.f32 a, %1;\n cvt.f64.f32 b, %2;\n"
      " st.shared.v2.f64 [%0], {a, b};\n}\n"
      :: "r"(addr), "f"(x), "f"(y) : "memory");
}

// The backward's shared-memory addresses: the per-thread parts (warp, g,
// t, r0) pass through an empty asm at each use, so that the offsets are
// recomputed there rather than hoisted out of the q-tile loop into
// registers, which the consumers do not have (ptxas spilled otherwise).
//
// A fragments of k8 slice kk, split, elements e = (row g, k t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4) of the warp's 16 rows (g = lane / 4, t =
// lane % 4), from a 64 x 64 tile at shared address `tile` (two swizzled
// halves), times `mul` if `scale`. kAcross false: M = the tile's rows
// warp * 16 + g (+ 8), the contraction its columns 8 kk + t (+ 4) (row & 7
// = g); true: M = its columns, the contraction its rows.
template <bool kAcross>
__device__ __forceinline__ void tile_frags(uint32_t tile, int warp, int g,
                                           int t, int kk, float mul,
                                           bool scale, uint32_t (&h)[4],
                                           uint32_t (&l)[4]) {
  asm volatile("" : "+r"(warp), "+r"(g), "+r"(t));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t off;
    if constexpr (!kAcross) {
      off = (warp * 16 + g) * 128 + t * 4 + (kk >> 2) * 8192 +
            (e & 1) * 1024 + ((((kk & 3) * 2 + (e >> 1)) ^ g) << 4);
    } else {
      const int c = (warp & 1) * 4 + (g >> 2) + 2 * (e & 1);
      off = (warp >> 1) * 8192 + t * 128 + (g & 3) * 4 + kk * 1024 +
            (e >> 1) * 512 + ((c ^ (t + 4 * (e >> 1))) << 4);
    }
    float x = lds(tile + off);
    if (scale) x = __fmul_rn(x, mul);
    split_tf32(x, h[e], l[e]);
  }
}

// A fragments of slice kk from a split tile pair (hi, lo, shared
// addresses) stored [k][m] by store_split_t, read in the accumulator's
// order: k slot t is row 8 kk + 2t, slot t + 4 row 8 kk + 2t + 1 (the B
// tile's rows are permuted to match); M = the columns warp * 16 + g (+ 8).
__device__ __forceinline__ void pair_frags(uint32_t hi, uint32_t lo, int warp,
                                           int g, int t, int kk,
                                           uint32_t (&h)[4],
                                           uint32_t (&l)[4]) {
  asm volatile("" : "+r"(warp), "+r"(g), "+r"(t));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t off =
        f32_off(8 * kk + 2 * t + (e >> 1), warp * 16 + g + 8 * (e & 1));
    h[e] = __float_as_uint(lds(hi + off));
    l[e] = __float_as_uint(lds(lo + off));
  }
}

// A fragments of an accumulator taken as it lies: k slot t is its column
// 2t, slot t + 4 its column 2t + 1 of each 8-column group (the B tile's
// rows are permuted to match). kSplit false: bf16 values, exact in tf32
// (lo unused).
template <bool kSplit>
__device__ __forceinline__ void acc_frags(const float (&v)[32], int kk,
                                          uint32_t (&h)[4],
                                          uint32_t (&l)[4]) {
  const float x[4] = {v[kk * 4], v[kk * 4 + 2], v[kk * 4 + 1],
                      v[kk * 4 + 3]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (kSplit) {
      split_tf32(x[e], h[e], l[e]);
    } else {
      h[e] = __float_as_uint(x[e]);
    }
  }
}

// d (kAcc: +=, else =) A . B over the 64-wide contraction in 3xTF32, A's
// fragments of slice kk from frags(kk, hi, lo): per group of kGroup k8
// slices (kFwdGroup, kBwdGroup), the three passes (the small ones first;
// two where A has no lo part) into tmp afresh, then tmp added into d in f32
// (round to nearest). bh, bl: the B tiles' descriptors (tile_desc). The
// warpgroup waits for each group: the other warpgroup's products run
// meanwhile.
template <int kGroup, bool kALo, bool kAcc, class Frags>
__device__ __forceinline__ void mma3(float (&d)[32], float (&tmp)[32],
                                     Frags&& frags, uint64_t bh,
                                     uint64_t bl) {
#pragma unroll
  for (int g0 = 0; g0 < 8; g0 += kGroup) {
    uint32_t ah[kGroup][4], al[kGroup][4];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) frags(g0 + i, ah[i], al[i]);
    wgmma_fence();
    if constexpr (kALo) {                      // lo.hi
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        wgmma_rs_n64_tf32(tmp, al[i], bh + slice_step(g0 + i), i > 0);
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {         // hi.lo
      wgmma_rs_n64_tf32(tmp, ah[i], bl + slice_step(g0 + i), kALo || i > 0);
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {         // hi.hi
      wgmma_rs_n64_tf32(tmp, ah[i], bh + slice_step(g0 + i), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(tmp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      d[i] = (!kAcc && g0 == 0) ? tmp[i] : __fadd_rn(d[i], tmp[i]);
    }
  }
}

// keep bit n * 4 + r * 2 + c of the accumulator element (row q[r], column
// kv_base + 8 n + c): the bounds, and the mask (kVideo: the video masks'
// algebra with the frame indices once per row and column, in a loop the
// compiler keeps rolled, as unrolled it holds more registers than the
// backward has; else causal or none)
template <bool kVideo>
__device__ __forceinline__ uint32_t keep_bits(const Mask& m, const int (&q)[2],
                                              int kv_base, int Sq, int Skv) {
  uint32_t bits = 0xffffffffu;
  if constexpr (kVideo) {
    int q_frame[2], p_frame[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      q_frame[r] = floordiv_fast(q[r], m.tpf, m.inv_tpf);
      p_frame[r] = floordiv_fast(q[r] - m.iqe, m.pft, m.inv_pft) + 1;
    }
#pragma unroll 1
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kv = kv_base + 8 * n + c;
        const int kv_frame = floordiv_fast(kv, m.tpf, m.inv_tpf);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!(kv < Skv && q[r] < Sq &&
                keep_frames(m, q[r], q_frame[r], p_frame[r], kv,
                            kv_frame))) {
            bits &= ~(1u << (n * 4 + r * 2 + c));
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kv = kv_base + 8 * n + c;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!(kv < Skv && q[r] < Sq &&
                (m.mask_kind != kMaskCausal || q[r] >= kv))) {
            bits &= ~(1u << (n * 4 + r * 2 + c));
          }
        }
      }
    }
  }
  return bits;
}

// ---- forward

constexpr int kFwdBQ = 128;           // two consumer warpgroups of 64 rows
constexpr int kFwdBKV = 64;
constexpr int kFwdStages = 3;
constexpr int kTfThreads = 384;       // producer + two consumer warpgroups
constexpr int kTfConsumers = 256;

struct FwdStage {                     // each tile 1024-aligned in the ring
  float k_hi[64 * 64];                // [kv][d]
  float k_lo[64 * 64];
  float vt_hi[64 * 64];               // [d][kv], kv permuted
  float vt_lo[64 * 64];
};

struct FwdSmem {
  FwdStage st[kFwdStages];
  uint64_t full[kFwdStages];
  uint64_t empty[kFwdStages];
};

struct TfFwdArgs {
  const float* q;
  float* o;
  float* lse;
  const int* count;      // null: every kv tile visible
  const int* order;
  const int* kind;
  int B, H, Sq, Skv, nk_table;
  float qscale;
  Mask mask;
};

template <bool kExpBf16, bool kVideo>
__global__ void __launch_bounds__(kTfThreads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tm_k_hi,
                      const __grid_constant__ CUtensorMap tm_k_lo,
                      const __grid_constant__ CUtensorMap tm_vt_hi,
                      const __grid_constant__ CUtensorMap tm_vt_lo,
                      const TfFwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  // warp-uniform (a shuffle), so no wgmma sits in a path the compiler
  // takes for divergent
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qt * kFwdBQ;
  const int n_tiles = __shfl_sync(
      0xffffffffu, a.count ? a.count[qt] : (a.Skv + kFwdBKV - 1) / kFwdBKV,
      0);
  const int* order = a.order ? a.order + static_cast<size_t>(qt) * a.nk_table
                             : nullptr;
  const int* kinds = a.kind ? a.kind + static_cast<size_t>(qt) * a.nk_table
                            : nullptr;

  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kTfConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy
    setmaxnreg_dec<24>();
    if (tid == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kFwdStages;
        mbar_wait(&sm.empty[s], ((j / kFwdStages) & 1) ^ 1);
        const int kv0 = (order ? order[j] : j) * kFwdBKV;
        FwdStage& st = sm.st[s];
        mbar_expect_tx(&sm.full[s], 4 * kTile);
        for (int half = 0; half < 2; ++half) {
          tma_load_4d(st.k_hi + half * kHalf, &tm_k_hi, &sm.full[s], half * 32,
                      h, kv0, b);
          tma_load_4d(st.k_lo + half * kHalf, &tm_k_lo, &sm.full[s], half * 32,
                      h, kv0, b);
          tma_load_3d(st.vt_hi + half * kHalf, &tm_vt_hi, &sm.full[s],
                      kv0 + half * 32, 0, bh);
          tma_load_3d(st.vt_lo + half * kHalf, &tm_vt_lo, &sm.full[s],
                      kv0 + half * 32, 0, bh);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns q rows cw*64 .. cw*64+63
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int ct = tid - 128 * wg;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane / 4, t = lane % 4;
  const int qi[2] = {q0 + cw * 64 + warp * 16 + g,
                     q0 + cw * 64 + warp * 16 + g + 8};

  // q' = q * qscale (f32), split, as A fragments for the whole kv loop
  uint32_t qh[8][4], ql[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qi[e & 1];
      const float x = row < a.Sq
          ? __ldg(a.q + ((static_cast<size_t>(b) * a.Sq + row) * a.H + h) *
                            kD + 8 * kk + t + 4 * (e >> 1))
          : 0.f;
      split_tf32(__fmul_rn(x, a.qscale), qh[kk][e], ql[kk][e]);
    }
  }
  const auto q_frags = [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = qh[kk][e];
      l[e] = ql[kk][e];
    }
  };

  float S[32], o[32], tmp[32];
  float m[2] = {kNegInf, kNegInf};
  // per-thread partial row sums; with exp_bf16 the full row sums (every
  // thread of a quad holds them)
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    o[i] = 0.f;
    tmp[i] = 0.f;
  }
  // the values are in place before the first wgmma is issued: a register
  // that a wgmma accumulates into may not be defined by other instructions
  // while any wgmma is in flight, or the compiler serializes them all
  reg_fence(tmp);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kFwdStages;
    const int kv0 = (order ? order[j] : j) * kFwdBKV;
    const bool partial = (kinds ? kinds[j] == 1 : false) ||
                         kv0 + kFwdBKV > a.Skv;
    const FwdStage& st = sm.st[s];
    mbar_wait(&sm.full[s], (j / kFwdStages) & 1);

    // ---- S = q'.K^T
    mma3<kFwdGroup, true, false>(S, tmp, q_frags,
                                 tile_desc(smem_addr(st.k_hi)),
                                 tile_desc(smem_addr(st.k_lo)));

    if (partial) {   // masked scores and kv >= Skv: -inf, so p = 0
      const uint32_t keep =
          keep_bits<kVideo>(a.mask, qi, kv0 + 2 * t, 0x7fffffff, a.Skv);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (!((keep >> i) & 1u)) S[i] = -INFINITY;
      }
    }

    // ---- online softmax (log2 domain)
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mt[n & 3] = fmaxf(mt[n & 3], fmaxf(S[n * 4 + r * 2],
                                           S[n * 4 + r * 2 + 1]));
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
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t pb = ex2_bf16x2(pack_bf16(S[n * 4 + r * 2] - mu[r],
                                                   S[n * 4 + r * 2 + 1] -
                                                       mu[r]));
          const float lo = __uint_as_float(pb << 16);
          const float hi = __uint_as_float(pb & 0xffff0000u);
          ts[r][n & 3] += lo + hi;
          S[n * 4 + r * 2] = lo;
          S[n * 4 + r * 2 + 1] = hi;
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
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2_sfu(S[n * 4 + e] - mu[e >> 1]);
          S[n * 4 + e] = pe;
          ls[e >> 1][n & 3] += pe;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] +
               ((ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]));
      }
    }

    // ---- O = O * alpha + P.V; alpha is exactly 1 where the running max
    // did not move: the rescale is skipped where no row of the warp moved,
    // which changes no bit
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
    mma3<kFwdGroup, !kExpBf16, true>(
        o, tmp,
        [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
          acc_frags<!kExpBf16>(S, kk, h, l);
        },
        tile_desc(smem_addr(st.vt_hi)), tile_desc(smem_addr(st.vt_lo)));
    mbar_arrive(&sm.empty[s]);
  }

  // ---- epilogue: full row sums, normalise, out and lse
  if constexpr (!kExpBf16) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= a.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* row = a.o + ((static_cast<size_t>(b) * a.Sq + qi[r]) * a.H + h) * kD;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(row + n * 8 + t * 2) =
          make_float2(__fdiv_rn(o[n * 4 + r * 2], denom),
                      __fdiv_rn(o[n * 4 + r * 2 + 1], denom));
    }
    if (t == 0) {
      a.lse[static_cast<size_t>(bh) * a.Sq + qi[r]] =
          l[r] > 0.f ? m[r] + log2f(denom) : kNegInf;
    }
  }
}

// ---- backward

constexpr int kBwdBKV = 64;           // kv rows per CTA
constexpr int kBwdBQ = 64;            // q rows per tile

struct BwdSmem {                      // every tile at a multiple of 1 KB
  float k_hi[64 * 64];                // [kv][d]: B of S = q'.K^T
  float k_lo[64 * 64];
  float v_hi[64 * 64];                // [kv][d]: B of dP = do.V^T
  float v_lo[64 * 64];
  float kt_hi[64 * 64];               // [d][kv], kv permuted: B of dS.K
  float kt_lo[64 * 64];
  float q[2][64 * 64];                // raw q tile, one stage a warpgroup
  float dout[2][64 * 64];             // raw do tile
  float pd[2][2][64 * 64];            // a warpgroup's p^T / ds^T hi, lo
  uint64_t full[2];
  uint64_t empty[2];
  uint64_t kv_full;
};
static_assert(sizeof(BwdSmem) + 1024 <= 232448, "backward smem budget");

struct TfBwdArgs {
  const float* lse;      // (B, H, Sq_pad) log2, +inf past Sq
  const float* delta;    // (B, H, Sq_pad)
  double* dq;            // (B, H, Sq_pad, 64), added into
  float* dk;
  float* dv;
  const int* count;      // null: every q tile visited
  const int* order;
  const int* kind;
  int B, H, Sq, Skv, Sq_pad, nq_table;
  float qscale, scale;
  Mask mask;
};

// a consumer warpgroup's named barrier
__device__ __forceinline__ void wg_sync(int cw) { named_barrier(1 + cw, 128); }

// the accumulator (rows r0 + 8 (e >> 1), columns 8 n + 2 t + (e & 1)) split
// into the transposed tile pair [column][row]
__device__ __forceinline__ void store_split_t(uint32_t hi, uint32_t lo,
                                              const float (&x)[32], int r0,
                                              int t) {
  asm volatile("" : "+r"(r0), "+r"(t));
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t vh, vl;
      split_tf32(x[n * 4 + e], vh, vl);
      const uint32_t off = f32_off(8 * n + 2 * t + (e & 1), r0 + 8 * (e >> 1));
      sts(hi + off, vh);
      sts(lo + off, vl);
    }
  }
}

template <bool kVideo>
__global__ void __launch_bounds__(kTfThreads, 1)
flash_bwd_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k_hi,
                      const __grid_constant__ CUtensorMap tm_k_lo,
                      const __grid_constant__ CUtensorMap tm_v_hi,
                      const __grid_constant__ CUtensorMap tm_v_lo,
                      const __grid_constant__ CUtensorMap tm_kt_hi,
                      const __grid_constant__ CUtensorMap tm_kt_lo,
                      const TfBwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int kv0 = kt * kBwdBKV;
  const int n_tiles = __shfl_sync(
      0xffffffffu, a.count ? a.count[kt] : (a.Sq + kBwdBQ - 1) / kBwdBQ, 0);
  const int* order = a.order ? a.order + static_cast<size_t>(kt) * a.nq_table
                             : nullptr;
  const int* kinds = a.kind ? a.kind + static_cast<size_t>(kt) * a.nq_table
                            : nullptr;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 128);
    }
    mbar_init(&sm.kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: the kv side once, then tile j's raw q and do into the
    // stage of the warpgroup that takes it (j & 1)
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(&sm.kv_full, 6 * kTile);
      for (int half = 0; half < 2; ++half) {
        const int c = half * 32, o = half * kHalf;
        tma_load_4d(sm.k_hi + o, &tm_k_hi, &sm.kv_full, c, h, kv0, b);
        tma_load_4d(sm.k_lo + o, &tm_k_lo, &sm.kv_full, c, h, kv0, b);
        tma_load_4d(sm.v_hi + o, &tm_v_hi, &sm.kv_full, c, h, kv0, b);
        tma_load_4d(sm.v_lo + o, &tm_v_lo, &sm.kv_full, c, h, kv0, b);
        tma_load_3d(sm.kt_hi + o, &tm_kt_hi, &sm.kv_full, kv0 + c, 0, bh);
        tma_load_3d(sm.kt_lo + o, &tm_kt_lo, &sm.kv_full, kv0 + c, 0, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j & 1;
        mbar_wait(&sm.empty[s], ((j >> 1) & 1) ^ 1);
        const int q0 = (order ? order[j] : j) * kBwdBQ;
        mbar_expect_tx(&sm.full[s], 2 * kTile);
        for (int half = 0; half < 2; ++half) {
          tma_load_4d(sm.q[s] + half * kHalf, &tm_q, &sm.full[s], half * 32,
                      h, q0, b);
          tma_load_4d(sm.dout[s] + half * kHalf, &tm_do, &sm.full[s],
                      half * 32, h, q0, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw takes q tiles cw, cw + 2, ...
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int ct = tid - 128 * wg;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;    // rows r0 and r0 + 8 of every product
  const uint32_t pd_hi = smem_addr(sm.pd[cw][0]);
  const uint32_t pd_lo = smem_addr(sm.pd[cw][1]);
  const uint32_t qb = smem_addr(sm.q[cw]), dob = smem_addr(sm.dout[cw]);
  // A fragments: q' = q * qscale and do by rows, do and q across
  const auto q_rows = [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
    tile_frags<false>(qb, warp, g, t, kk, a.qscale, true, h, l);
  };
  const auto do_rows = [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
    tile_frags<false>(dob, warp, g, t, kk, 1.f, false, h, l);
  };
  const auto do_across = [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
    tile_frags<true>(dob, warp, g, t, kk, 1.f, false, h, l);
  };
  const auto q_across = [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
    tile_frags<true>(qb, warp, g, t, kk, 1.f, false, h, l);
  };

  float dv[32], dk[32], S[32], dP[32], dq[32], part[32], tmp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dv[i] = 0.f;
    dk[i] = 0.f;
    tmp[i] = 0.f;
  }
  reg_fence(tmp);
  mbar_wait(&sm.kv_full, 0);

  for (int j = cw; j < n_tiles; j += 2) {
    const uint32_t parity = (j >> 1) & 1;
    const int q0 = (order ? order[j] : j) * kBwdBQ;
    const bool partial = (kinds ? kinds[j] == 1 : false) ||
                         kv0 + kBwdBKV > a.Skv || q0 + kBwdBQ > a.Sq;
    const int qi[2] = {q0 + r0, q0 + r0 + 8};
    mbar_wait(&sm.full[cw], parity);

    // ---- S = q'.K^T, then P = exp2(S - lse) * keep in its registers. A
    // masked score's p is 0 whatever s is (JAX: s = -1e30, then * keep).
    // (The keep bits first: their arithmetic needs registers that the
    // accumulators hold later.)
    const uint32_t keep = partial
        ? keep_bits<kVideo>(a.mask, qi, kv0 + 2 * t, a.Sq, a.Skv)
        : 0xffffffffu;
    mma3<kBwdGroup, true, false>(S, tmp, q_rows,
                                 tile_desc(smem_addr(sm.k_hi)),
                                 tile_desc(smem_addr(sm.k_lo)));
    {
      const float* row = a.lse + static_cast<size_t>(bh) * a.Sq_pad + q0 + r0;
      const float lse[2] = {__ldg(row), __ldg(row + 8)};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        S[i] = ((keep >> i) & 1u)
            ? exp2_sfu(__fsub_rn(S[i], lse[(i >> 1) & 1])) : 0.f;
      }
    }
    // ---- P^T into the buffer, once the last dq reduce has read it: P's
    // registers are free for the rest of the tile (dS reads it back)
    if (ct == 0) bulk_wait_read<0>();
    wg_sync(cw);
    store_split_t(pd_hi, pd_lo, S, r0, t);
    fence_async_smem();
    wg_sync(cw);                       // every warp's P^T is in place

    // ---- dV^T += do^T.P: the tile's slices summed afresh, then one f32
    // add into dV^T (fewer adds into the running sum: PERF.md)
    mma3<kBwdGroup, true, false>(part, tmp, do_across, tile_desc(pd_hi),
                                 tile_desc(pd_lo));
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[i] = __fadd_rn(dv[i], part[i]);

    // ---- dP = do.V^T; dS = P * (dP - delta) * scale in its registers,
    // P read back as hi + lo (exact in f32, within 2^-22 of p; each thread
    // reads what it stored)
    mma3<kBwdGroup, true, false>(dP, tmp, do_rows,
                                 tile_desc(smem_addr(sm.v_hi)),
                                 tile_desc(smem_addr(sm.v_lo)));
    {
      const float* row =
          a.delta + static_cast<size_t>(bh) * a.Sq_pad + q0 + r0;
      const float delta[2] = {__ldg(row), __ldg(row + 8)};
      int rr = r0, tt = t;
      asm volatile("" : "+r"(rr), "+r"(tt));
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t off =
              f32_off(8 * n + 2 * tt + (e & 1), rr + 8 * (e >> 1));
          const float pe = __fadd_rn(lds(pd_hi + off), lds(pd_lo + off));
          const int i = n * 4 + e;
          dP[i] = __fmul_rn(__fmul_rn(pe, __fsub_rn(dP[i], delta[e >> 1])),
                            a.scale);
        }
      }
    }

    // ---- dS^T into the buffer; dK^T += q^T.dS as dV^T
    wg_sync(cw);                       // every warp's dV^T has read P^T
    store_split_t(pd_hi, pd_lo, dP, r0, t);
    fence_async_smem();
    wg_sync(cw);
    mma3<kBwdGroup, true, false>(part, tmp, q_across, tile_desc(pd_hi),
                                 tile_desc(pd_lo));
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = __fadd_rn(dk[i], part[i]);
    mbar_arrive(&sm.empty[cw]);        // the raw tiles are read

    // ---- dQ = dS.K, dS's split read back from the buffer in the
    // accumulator's order (its registers are free since the store), into
    // the f64 workspace: the box [64 q][64 d] f64 fills the buffer, added
    // by one bulk reduce-add
    mma3<kBwdGroup, true, false>(
        dq, tmp,
        [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
          pair_frags(pd_hi, pd_lo, warp, g, t, kk, h, l);
        },
        tile_desc(smem_addr(sm.kt_hi)), tile_desc(smem_addr(sm.kt_lo)));
    wg_sync(cw);                       // every warp has read dS^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sts2_f64(pd_hi + ((r0 + 8 * r) * 64 + 8 * n + 2 * t) * 8,
                 dq[n * 4 + r * 2], dq[n * 4 + r * 2 + 1]);
      }
    }
    fence_async_smem();
    wg_sync(cw);
    if (ct == 0) {
      bulk_reduce_add_f64(
          a.dq + (static_cast<size_t>(bh) * a.Sq_pad + q0) * kD, sm.pd[cw][0],
          kBwdBQ * kD * 8);
      bulk_commit();
    }
  }

  // ---- epilogue: warpgroup 1's dV^T, dK^T through its buffer into
  // warpgroup 0's, written once
  float* xfer = sm.pd[1][0];
  if (cw == 1) {
    if (ct == 0) bulk_wait_read<0>();
    wg_sync(1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      xfer[i * 128 + ct] = dv[i];
      xfer[4096 + i * 128 + ct] = dk[i];
    }
  }
  named_barrier(3, kTfConsumers);
  if (cw == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int d = r0 + 8 * ((i >> 1) & 1);
      const int kv = kv0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (kv >= a.Skv) continue;
      const size_t off =
          ((static_cast<size_t>(b) * a.Skv + kv) * a.H + h) * kD + d;
      a.dv[off] = __fadd_rn(dv[i], xfer[i * 128 + ct]);
      a.dk[off] = __fadd_rn(dk[i], xfer[4096 + i * 128 + ct]);
    }
  }
  if (ct == 0) bulk_wait<0>();
}

// ---- host

template <class Kernel, class Args>
int launch(Kernel kernel, const Args& args, dim3 grid, int bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, bytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// an f32 BSHD tensor (B, S, H, 64) read in boxes of `rows` rows x 32
// columns of one (b, h)
int bshd_map(CUtensorMap* map, const void* base, int B, int S, int H,
             int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(kD) * 4, static_cast<cuuint64_t>(H) * kD * 4,
      static_cast<cuuint64_t>(S) * H * kD * 4};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(rows), 1};
  return landiff_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base,
                            dims, strides, box);
}

// a transposed split copy (B*H, 64, S_pad) read in boxes of 64 rows x 32
// columns of s
int t_map(CUtensorMap* map, const void* base, int BH, int S_pad) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(S_pad),
                              static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(S_pad) * 4,
                                 static_cast<cuuint64_t>(S_pad) * kD * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(kD), 1};
  return landiff_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base,
                            dims, strides, box);
}

template <class Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// Plain C interface (bound with ctypes). Each returns 0, a cudaError_t of
// the launch (or of raising the kernel's shared-memory limit), or, for a
// tensor map that could not be encoded, 1000 + its CUresult (-1: no
// cuTensorMapEncodeTiled entry point). Tensors are contiguous f32 BSHD
// with head dim 64, 16-byte aligned; the tables (count, order, kind) are
// per 128-row q tile of 64-row kv tiles (exact forward), per 64 x 64 tile
// (int8 forward), per 64-row kv tile of 64-row q tiles (backward), or null
// where nothing is masked.

// The exact forward on the prologue's copies: k_hi, k_lo (B, Skv, H, 64)
// from landiff_tf32_split, vt_hi, vt_lo (B*H, 64, skv_pad) from
// landiff_tf32_split_t, skv_pad = Skv rounded up to 64. exp_bf16 != 0
// selects the bf16-exp2 variant.
extern "C" int landiff_flash_fwd_f32(
    const float* q, const float* k_hi, const float* k_lo, const float* vt_hi,
    const float* vt_lo, float* o, float* lse, const int* count,
    const int* order, const int* kind, int B, int H, int Sq, int Skv,
    int skv_pad, int nk_table, float qscale, int mask_kind, int nf, int tpf,
    int iqt, int pft, int exp_bf16, void* stream) {
  if (skv_pad % kFwdBKV || skv_pad < Skv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm[4];
  int rc = bshd_map(&tm[0], k_hi, B, Skv, H, kFwdBKV);
  if (rc == 0) rc = bshd_map(&tm[1], k_lo, B, Skv, H, kFwdBKV);
  if (rc == 0) rc = t_map(&tm[2], vt_hi, B * H, skv_pad);
  if (rc == 0) rc = t_map(&tm[3], vt_lo, B * H, skv_pad);
  if (rc != 0) return rc < 0 ? rc : 1000 + rc;
  const TfFwdArgs a{q, o, lse, count, order, kind, B, H, Sq, Skv, nk_table,
                    qscale, make_mask(mask_kind, nf, tpf, iqt, pft)};
  const bool video =
      mask_kind == kMaskVideoEncoder || mask_kind == kMaskVideoDecoder;
  auto kernel = exp_bf16
      ? (video ? flash_fwd_tf32_kernel<true, true>
               : flash_fwd_tf32_kernel<true, false>)
      : (video ? flash_fwd_tf32_kernel<false, true>
               : flash_fwd_tf32_kernel<false, false>);
  const int bytes = static_cast<int>(sizeof(FwdSmem)) + 1024;
  const int err = set_smem(kernel, bytes);
  if (err != 0) return err;
  const dim3 grid((Sq + kFwdBQ - 1) / kFwdBQ, B * H);
  kernel<<<grid, kTfThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      tm[0], tm[1], tm[2], tm[3], a);
  return static_cast<int>(cudaGetLastError());
}

// k8: int8 BSHD codes and ksc: (B*H, Skv_pad) f32 scales, from
// landiff_flash_quantize_k_f32. vsc null: v is f32 BSHD and p.v runs in
// f32. vsc set (int8_pv): v is the int8 (B*H, 64, skv_p) codes and vsc the
// (B*H, skv_p / v_block) f32 scales; v_block is a multiple of 128 and
// divides skv_p >= Skv.
extern "C" int landiff_flash_fwd_i8_f32(
    const float* q, const void* k8, const float* ksc, const void* v,
    const float* vsc, float* o, float* lse, const int* count,
    const int* order, const int* kind, int B, int H, int Sq, int Skv,
    int nk_table, int skv_pad, float qscale, int mask_kind, int nf, int tpf,
    int iqt, int pft, int v_block, int skv_p, int exp_bf16, void* stream) {
  if (vsc && (v_block % kSkvPad || skv_p % v_block || skv_p < Skv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const I8Args a{q, static_cast<const int8_t*>(k8), ksc, v, vsc, o, lse,
                 count, order, kind, B, H, Sq, Skv, nk_table, skv_pad,
                 v_block, skv_p, qscale,
                 make_mask(mask_kind, nf, tpf, iqt, pft)};
  const dim3 grid((Sq + kT - 1) / kT, B * H);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = sizeof(I8Smem);
  if (vsc) {
    return exp_bf16 ? launch(flash_fwd_i8_f32_kernel<true, true>, a, grid,
                             bytes, st)
                    : launch(flash_fwd_i8_f32_kernel<true, false>, a, grid,
                             bytes, st);
  }
  return exp_bf16 ? launch(flash_fwd_i8_f32_kernel<false, true>, a, grid,
                           bytes, st)
                  : launch(flash_fwd_i8_f32_kernel<false, false>, a, grid,
                           bytes, st);
}

// k (B, Skv, H, 64) f32 -> k8 (the same shape, int8) and ksc (B*H, Skv_pad)
// f32, Skv_pad = Skv rounded up to 128.
extern "C" int landiff_flash_quantize_k_f32(const float* k, void* k8,
                                            float* ksc, int B, int Skv, int H,
                                            int skv_pad, void* stream) {
  if (skv_pad % kSkvPad) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * skv_pad * H;
  quantize_k_f32_kernel<<<static_cast<unsigned>((rows + 15) / 16), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      k, static_cast<int8_t*>(k8), ksc, B, Skv, H, skv_pad);
  return static_cast<int>(cudaGetLastError());
}

// hi, lo = the 3xTF32 split of n f32 values (n a multiple of 4).
extern "C" int landiff_tf32_split(const float* x, float* hi, float* lo,
                                  long long n, void* stream) {
  if (n % 4) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  const unsigned blocks = static_cast<unsigned>(
      n4 / 256 + 1 < 132 * 16 ? n4 / 256 + 1 : 132 * 16);
  tf32_split_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<uint4*>(hi),
      reinterpret_cast<uint4*>(lo), n4);
  return static_cast<int>(cudaGetLastError());
}

// x (B, S, H, 64) -> hi, lo (B*H, 64, S_pad), S_pad a multiple of 64 >= S:
// transposed, split, each 8-row group of s permuted, zero where s >= S.
extern "C" int landiff_tf32_split_t(const float* x, float* hi, float* lo,
                                    int B, int S, int H, int S_pad,
                                    void* stream) {
  if (S_pad % 64 || S_pad < S) return static_cast<int>(cudaErrorInvalidValue);
  tf32_split_t_kernel<<<dim3(S_pad / 64, B * H), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, hi, lo, S, H,
                                                             S_pad);
  return static_cast<int>(cudaGetLastError());
}

// The backward's q-side prologue: lse_pad, delta (B, H, Sq_pad) and the
// zeroed f64 dq workspace (B, H, Sq_pad, 64); Sq_pad = Sq rounded up to 64.
extern "C" int landiff_flash_bwd_prep_f32(
    const float* out, const float* dout, const float* lse, float* lse_pad,
    float* delta, double* dq, int B, int H, int Sq, int Sq_pad,
    void* stream) {
  const long long rows = static_cast<long long>(B) * Sq_pad * H;
  bwd_prep_f32_kernel<<<static_cast<unsigned>((rows + 15) / 16), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      out, dout, lse, lse_pad, delta, dq, B, H, Sq, Sq_pad);
  return static_cast<int>(cudaGetLastError());
}

// The backward on the prologues' outputs: k_hi, k_lo, v_hi, v_lo BSHD from
// landiff_tf32_split, kt_hi, kt_lo (B*H, 64, skv_pad) from
// landiff_tf32_split_t (skv_pad = Skv rounded up to 64); q, dout raw f32
// BSHD; dq the f64 (B, H, Sq_pad, 64) workspace; dk, dv f32 BSHD like k.
extern "C" int landiff_flash_bwd_f32(
    const float* q, const float* k_hi, const float* k_lo, const float* v_hi,
    const float* v_lo, const float* kt_hi, const float* kt_lo,
    const float* dout, const float* lse_pad, const float* delta, double* dq,
    float* dk, float* dv, const int* count, const int* order,
    const int* kind, int B, int H, int Sq, int Skv, int Sq_pad, int skv_pad,
    int nq_table, float qscale, float scale, int mask_kind, int nf, int tpf,
    int iqt, int pft, void* stream) {
  if (Sq_pad % kBwdBQ || skv_pad % kBwdBKV || skv_pad < Skv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm[8];
  int rc = bshd_map(&tm[0], q, B, Sq, H, kBwdBQ);
  if (rc == 0) rc = bshd_map(&tm[1], dout, B, Sq, H, kBwdBQ);
  if (rc == 0) rc = bshd_map(&tm[2], k_hi, B, Skv, H, kBwdBKV);
  if (rc == 0) rc = bshd_map(&tm[3], k_lo, B, Skv, H, kBwdBKV);
  if (rc == 0) rc = bshd_map(&tm[4], v_hi, B, Skv, H, kBwdBKV);
  if (rc == 0) rc = bshd_map(&tm[5], v_lo, B, Skv, H, kBwdBKV);
  if (rc == 0) rc = t_map(&tm[6], kt_hi, B * H, skv_pad);
  if (rc == 0) rc = t_map(&tm[7], kt_lo, B * H, skv_pad);
  if (rc != 0) return rc < 0 ? rc : 1000 + rc;
  const TfBwdArgs a{lse_pad, delta, dq, dk, dv, count, order, kind, B, H, Sq,
                    Skv, Sq_pad, nq_table, qscale, scale,
                    make_mask(mask_kind, nf, tpf, iqt, pft)};
  const bool video =
      mask_kind == kMaskVideoEncoder || mask_kind == kMaskVideoDecoder;
  auto kernel = video ? flash_bwd_tf32_kernel<true>
                      : flash_bwd_tf32_kernel<false>;
  const int bytes = static_cast<int>(sizeof(BwdSmem)) + 1024;
  const int err = set_smem(kernel, bytes);
  if (err != 0) return err;
  const dim3 grid((Skv + kBwdBKV - 1) / kBwdBKV, B * H);
  kernel<<<grid, kTfThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], tm[6], tm[7], a);
  return static_cast<int>(cudaGetLastError());
}

// The 3xTF32 kernels' dynamic shared memory per CTA, in bytes: the
// forward (bwd = 0) or the backward.
extern "C" int landiff_flash_f32_smem_bytes(int bwd) {
  return static_cast<int>(bwd ? sizeof(BwdSmem) : sizeof(FwdSmem)) + 1024;
}
