// Flash attention in f32 for the H100 (sm_90a): the forms the Pallas
// kernels of landiff_tpu/ops/attention.py take when given f32 refs.
//
//   landiff_flash_fwd_f32: the exact forward (_flash_kernel :91 /
//     _flash_kernel_cached :197 with f32 q / k / v): q' = q * scale*log2e in
//     f32, s = q'.k^T, online softmax in log2 units, p kept in f32 (the V
//     dtype, _softmax_tile), out = acc / max(l, 1e-30), the log2 lse
//     written (-1e30 for a fully masked row, whose output is 0).
//   landiff_flash_fwd_i8_f32: the int8-score forward (_flash_kernel_cached_i8
//     :264 with f32 inputs): q quantized per row in the CTA (absmax, IEEE
//     division, half to even), K per kv position by the prologue
//     landiff_flash_quantize_k_f32; s = f32(q8.k8) * sq * sk in JAX's order
//     from exact int32 sums (__dp4a); p.v in f32.
//   landiff_flash_bwd_prep_f32 / landiff_flash_bwd_f32: the fused backward
//     (_flash_bwd_fused_kernel :658 with f32 refs): the prologue writes q',
//     delta = rowsum(do * out), the lse padded with +inf and a zeroed dq
//     workspace, as the bf16 prologue does; then per (64-row kv tile, b*h)
//     p = exp2(s - lse) * keep, dp = do.v^T, ds = p * (dp - delta), dv +=
//     p^T.do, dk += (scale*ds)^T.q, dq += (scale*ds).k, all in f32.
//
// Every product is an f32 FFMA on the CUDA cores (a TF32 tensor-core product
// is about 1e-3 relative, far from f32): tiles of 64 q rows x 64 kv rows,
// 256 threads, each thread a 4 x 4 block of every product from float4 reads
// of shared memory. dq is summed across kv tiles by float4 atomics into the
// f32 workspace, in no fixed order: its last bits vary from run to run; dk
// and dv do not. exp2 is ex2.approx.ftz.f32 (about 2 ulp), as in the bf16
// kernels. The mask algebra and the visibility / tile tables are the bf16
// kernels' (flash_common.cuh), at 64 x 64 tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kT = 64;          // q rows and kv rows per tile
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

// A (row, 4-column chunk) of a 64 x 64 tile stored with its chunks XORed
// by the row's own chunk, so that a thread block's float4 stores of a
// transposed tile fall into distinct banks; a row's reads stay float4.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kT + ((chunk ^ ((row >> 2) & 15)) << 2);
}

// A 64-row tile of a BSHD f32 tensor (rows r0.., head h of batch b) into
// shared memory transposed, t[d * 64 + r], times `mul`, rows past `rows`
// zero. Thread tid reads row tid % 64, chunks tid / 64 + 4 i, so a warp's
// stores fall into distinct banks.
__device__ __forceinline__ void load_t(float* t, const float* x, int b, int S,
                                       int H, int h, int r0, float mul) {
  const int r = threadIdx.x & 63;
  const bool in = r0 + r < S;
  const float* src = x + ((static_cast<size_t>(b) * S + r0 + r) * H + h) * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = (threadIdx.x >> 6) + 4 * i;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in) w = *reinterpret_cast<const float4*>(src + 4 * c);
    t[(4 * c + 0) * kT + r] = __fmul_rn(w.x, mul);
    t[(4 * c + 1) * kT + r] = __fmul_rn(w.y, mul);
    t[(4 * c + 2) * kT + r] = __fmul_rn(w.z, mul);
    t[(4 * c + 3) * kT + r] = __fmul_rn(w.w, mul);
  }
}

// The same tile in its own layout, n[r * 64 + d]; rows past `rows` zero.
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

// acc[i][j] += sum_k a[k * 64 + 4 ty + i] * b[k * 64 + 4 tx + j], k < 64:
// the thread's 4 x 4 block of a 64 x 64 x 64 product, both operands
// k-major in shared memory.
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < kT; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(a + k * kT + 4 * ty);
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

// The same with operand a stored swizzled (swz: a[k] row, chunk ty).
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

struct FwdSmem {
  float q[kT * kT];      // exact: q' transposed (d-major)
  int32_t q8[16 * kT];   // int8: q codes, 4 per word, transposed
  float sq[kT];          // int8: the rows' scales times qscale
  float k[kT * kT];      // exact: k transposed
  int32_t k8[16 * kT];   // int8: k codes transposed
  float sk[kT];          // int8: the tile's K scales
  float v[kT * kT];      // v, kv-major
  float p[kT * kT];      // p, kv-major, swizzled
};

struct FwdArgs {
  const float* q;
  const float* k;        // exact
  const int8_t* k8;      // int8: codes BSHD
  const float* ksc;      // int8: (B*H, skv_pad)
  const float* v;
  float* o;
  float* lse;
  const int* count;      // null: every kv tile visible
  const int* order;
  const int* kind;
  int B, H, Sq, Skv, nk_table, skv_pad;
  float qscale;
  Mask mask;
};

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qt * kT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  if constexpr (!kInt8) {
    load_t(sm.q, a.q, b, a.Sq, a.H, h, q0, a.qscale);
  } else {
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
    if constexpr (!kInt8) {
      load_t(sm.k, a.k, b, a.Skv, a.H, h, kv0, 1.f);
    } else {
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
    load_n(sm.v, a.v, b, a.Skv, a.H, h, kv0);
    __syncthreads();

    float s[4][4];
    if constexpr (!kInt8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
      }
      mma_tile(s, sm.q, sm.k, ty, tx);
    } else {
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
      float ts = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = exp2_sfu(s[i][c] - mx);
        ts += s[i][c];
      }
      l[i] = fmaf(l[i], alpha, row_sum(ts));
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {   // p^T: row kv, chunk ty
      *reinterpret_cast<float4*>(sm.p + swz(4 * tx + c, ty)) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();
    mma_tile_swz(acc, sm.p, sm.v, ty, tx);
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

// The backward's prologue in f32: one 16-thread group per (b, s, h) row,
// s < Sq_pad. q' = q * qscale (BSHD), delta = rowsum(do * out) and the lse
// (+inf past Sq) into (B, H, Sq_pad), zeros into the dq workspace (B, H,
// Sq_pad, 64).
__global__ void __launch_bounds__(256)
bwd_prep_f32_kernel(const float* q, const float* out, const float* dout,
                    const float* lse, float* qs, float* lse_pad, float* delta,
                    float* dq, int B, int H, int Sq, int Sq_pad,
                    float qscale) {
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
    const float4 x = *reinterpret_cast<const float4*>(q + off);
    *reinterpret_cast<float4*>(qs + off) =
        make_float4(__fmul_rn(x.x, qscale), __fmul_rn(x.y, qscale),
                    __fmul_rn(x.z, qscale), __fmul_rn(x.w, qscale));
    const float4 o = *reinterpret_cast<const float4*>(out + off);
    const float4 g = *reinterpret_cast<const float4*>(dout + off);
    d = fmaf(o.w, g.w, fmaf(o.z, g.z, fmaf(o.y, g.y, o.x * g.x)));
  }
  d = row_sum(d);
  const size_t stat = (static_cast<size_t>(b) * H + h) * Sq_pad + sp;
  if (live) {
    *reinterpret_cast<float4*>(dq + stat * kD + part * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
    if (part == 0) {
      delta[stat] = d;
      lse_pad[stat] =
          in ? lse[(static_cast<size_t>(b) * H + h) * Sq + sp] : INFINITY;
    }
  }
}

struct BwdSmem {
  float kt[kT * kT];    // k transposed (d-major), for s
  float vt[kT * kT];    // v transposed, for dp
  float kn[kT * kT];    // k kv-major, for dq
  float qt[kT * kT];    // q' transposed, for s
  float dot[kT * kT];   // do transposed, for dp
  float qn[kT * kT];    // q q-major, for dk
  float don[kT * kT];   // do q-major, for dv
  float pn[kT * kT];    // p, then scale * ds, q-major
  float dst[kT * kT];   // scale * ds, kv-major, swizzled, for dq
  float lse[kT];
  float delta[kT];
};

struct BwdArgs {
  const float* q;
  const float* qs;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse_pad;
  const float* delta;
  float* dq;             // (B, H, Sq_pad, 64) workspace
  float* dk;
  float* dv;
  const int* count;      // null: every q tile sees every kv tile
  const int* order;
  const int* kind;
  int B, H, Sq, Skv, Sq_pad, nq_table;
  float scale;
  Mask mask;
};

__global__ void __launch_bounds__(kThreads)
flash_bwd_f32_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int kv0 = kt * kT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_t(sm.kt, a.k, b, a.Skv, a.H, h, kv0, 1.f);
  load_t(sm.vt, a.v, b, a.Skv, a.H, h, kv0, 1.f);
  load_n(sm.kn, a.k, b, a.Skv, a.H, h, kv0);

  // dk, dv: kv rows 4 ty + i, d columns 4 tx + e
  float dk[4][4] = {}, dv[4][4] = {};
  const int nq = a.count ? a.count[kt] : (a.Sq + kT - 1) / kT;
  const int* order = a.order ? a.order + static_cast<size_t>(kt) * a.nq_table
                             : nullptr;
  const int* kinds = a.kind ? a.kind + static_cast<size_t>(kt) * a.nq_table
                            : nullptr;
  const bool kv_edge = kv0 + kT > a.Skv;
  for (int j = 0; j < nq; ++j) {
    const int q0 = (order ? order[j] : j) * kT;
    const bool partial = (kinds && kinds[j] == 1) || kv_edge;
    __syncthreads();   // the previous q tile's operands are consumed
    load_t(sm.qt, a.qs, b, a.Sq, a.H, h, q0, 1.f);
    load_t(sm.dot, a.dout, b, a.Sq, a.H, h, q0, 1.f);
    load_n(sm.qn, a.q, b, a.Sq, a.H, h, q0);
    load_n(sm.don, a.dout, b, a.Sq, a.H, h, q0);
    if (tid < kT) {   // the padded lse is +inf past Sq: p = 0 there
      const size_t stat = static_cast<size_t>(bh) * a.Sq_pad + q0 + tid;
      sm.lse[tid] = a.lse_pad[stat];
      sm.delta[tid] = a.delta[stat];
    }
    __syncthreads();

    // q rows 4 ty + i, kv columns 4 tx + c
    float s[4][4] = {}, dp[4][4] = {};
    mma_tile(s, sm.qt, sm.kt, ty, tx);
    mma_tile(dp, sm.dot, sm.vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + 4 * ty + i;
      const float lse = sm.lse[4 * ty + i], delta = sm.delta[4 * ty + i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kv = kv0 + 4 * tx + c;
        float p = exp2_sfu(s[i][c] - lse);
        if (partial && !(kv < a.Skv && keep_score(a.mask, q, kv))) p = 0.f;
        s[i][c] = p;
        dp[i][c] = __fmul_rn(__fmul_rn(p, dp[i][c] - delta), a.scale);
      }
      *reinterpret_cast<float4*>(sm.pn + (4 * ty + i) * kT + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {   // (scale * ds)^T: row kv, chunk ty
      *reinterpret_cast<float4*>(sm.dst + swz(4 * tx + c, ty)) =
          make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
    }
    __syncthreads();

    mma_tile(dv, sm.pn, sm.don, ty, tx);   // dv += p^T . do
    float dq[4][4] = {};                   // q rows 4 ty + i, d 4 tx + e
    mma_tile_swz(dq, sm.dst, sm.kn, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + 4 * ty + i;
      if (q < a.Sq) {
        atomicAdd(reinterpret_cast<float4*>(
                      a.dq + (static_cast<size_t>(bh) * a.Sq_pad + q) * kD +
                      4 * tx),
                  make_float4(dq[i][0], dq[i][1], dq[i][2], dq[i][3]));
      }
    }
    __syncthreads();   // p is consumed: its buffer takes scale * ds
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(sm.pn + (4 * ty + i) * kT + 4 * tx) =
          make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
    __syncthreads();
    mma_tile(dk, sm.pn, sm.qn, ty, tx);    // dk += (scale * ds)^T . q
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kv = kv0 + 4 * ty + i;
    if (kv >= a.Skv) continue;
    const size_t off = ((static_cast<size_t>(b) * a.Skv + kv) * a.H + h) * kD +
                       4 * tx;
    *reinterpret_cast<float4*>(a.dk + off) =
        make_float4(dk[i][0], dk[i][1], dk[i][2], dk[i][3]);
    *reinterpret_cast<float4*>(a.dv + off) =
        make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]);
  }
}

template <class Kernel, class Args>
int launch(Kernel kernel, const Args& args, dim3 grid, int bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, bytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes). Each returns 0 or the cudaError_t
// of the launch. Tensors are contiguous f32 BSHD with head dim 64, 16-byte
// aligned; the tables (count, order, kind) are per 64-row q tile (forward)
// or per 64-row kv tile (backward), or null where nothing is masked.
extern "C" int landiff_flash_fwd_f32(
    const float* q, const float* k, const float* v, float* o, float* lse,
    const int* count, const int* order, const int* kind, int B, int H, int Sq,
    int Skv, int nk_table, float qscale, int mask_kind, int nf, int tpf,
    int iqt, int pft, void* stream) {
  FwdArgs a{q, k, nullptr, nullptr, v, o, lse, count, order, kind, B, H,
            Sq, Skv, nk_table, 0, qscale,
            make_mask(mask_kind, nf, tpf, iqt, pft)};
  return launch(flash_fwd_f32_kernel<false>, a,
                dim3((Sq + kT - 1) / kT, B * H), sizeof(FwdSmem),
                static_cast<cudaStream_t>(stream));
}

// k8: int8 BSHD codes and ksc: (B*H, Skv_pad) f32 scales, from
// landiff_flash_quantize_k_f32.
extern "C" int landiff_flash_fwd_i8_f32(
    const float* q, const void* k8, const float* ksc, const float* v,
    float* o, float* lse, const int* count, const int* order, const int* kind,
    int B, int H, int Sq, int Skv, int nk_table, int skv_pad, float qscale,
    int mask_kind, int nf, int tpf, int iqt, int pft, void* stream) {
  FwdArgs a{q, nullptr, static_cast<const int8_t*>(k8), ksc, v, o, lse,
            count, order, kind, B, H, Sq, Skv, nk_table, skv_pad, qscale,
            make_mask(mask_kind, nf, tpf, iqt, pft)};
  return launch(flash_fwd_f32_kernel<true>, a,
                dim3((Sq + kT - 1) / kT, B * H), sizeof(FwdSmem),
                static_cast<cudaStream_t>(stream));
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

extern "C" int landiff_flash_bwd_prep_f32(
    const float* q, const float* out, const float* dout, const float* lse,
    float* qs, float* lse_pad, float* delta, float* dq, int B, int H, int Sq,
    int Sq_pad, float qscale, void* stream) {
  const long long rows = static_cast<long long>(B) * Sq_pad * H;
  bwd_prep_f32_kernel<<<static_cast<unsigned>((rows + 15) / 16), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, out, dout, lse, qs, lse_pad, delta, dq, B, H, Sq, Sq_pad, qscale);
  return static_cast<int>(cudaGetLastError());
}

// Sq_pad: Sq rounded up to 64, the prologue's; dk, dv f32 BSHD like k.
extern "C" int landiff_flash_bwd_f32(
    const float* q, const float* qs, const float* k, const float* v,
    const float* dout, const float* lse_pad, const float* delta, float* dq,
    float* dk, float* dv, const int* count, const int* order,
    const int* kind, int B, int H, int Sq, int Skv, int Sq_pad, int nq_table,
    float scale, int mask_kind, int nf, int tpf, int iqt, int pft,
    void* stream) {
  if (Sq_pad % kT) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q, qs, k, v, dout, lse_pad, delta, dq, dk, dv, count, order,
            kind, B, H, Sq, Skv, Sq_pad, nq_table, scale,
            make_mask(mask_kind, nf, tpf, iqt, pft)};
  return launch(flash_bwd_f32_kernel, a, dim3((Skv + kT - 1) / kT, B * H),
                sizeof(BwdSmem), static_cast<cudaStream_t>(stream));
}
