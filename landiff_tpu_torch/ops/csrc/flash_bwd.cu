// Flash-attention backward for Hopper (sm_90a): dq, dk, dv from the exact
// forward's out and saved log2 lse, block-sparse over per-kv-tile
// visibility tables. wgmma, TMA and mbarriers, warp-specialised.
//
// Replaces the Pallas kernel _flash_bwd_fused_kernel (tile recompute
// _bwd_tile) of landiff_tpu/ops/attention.py: one pass that recomputes each
// visible (q, kv) tile once and feeds all three gradient products from it.
//
// Arithmetic, as the JAX kernel (all sums in f32):
//   q' = bf16(f32(q) * scale*log2e);  s = q'.k^T;  masked s = -1e30
//   p  = exp2(s - lse) * keep         (a fully masked row has lse = -1e30,
//                                      s - lse = 0, exp2 = 1: keep makes it 0)
//   dp = do.v^T;  ds = p * (dp - delta),  delta = rowsum(do * out)
//   dv += bf16(p)^T.do;  dk += bf16(scale*ds)^T.q;  dq += bf16(scale*ds).k
//
// Two kernels:
//   landiff_flash_bwd_prep: one pass over the (B, S, H, D) tensors writes
//     delta (B, H, Sq_pad) f32, lse padded to (B, H, Sq_pad) (+inf past
//     Sq: p = 0 there), q' (BSHD bf16, rounded once instead of per tile)
//     and zeros into the dq workspace (B, H, Sq_pad, D) f32. Sq_pad rounds
//     Sq up to the q tile (64), so a q tile's rows are one aligned block.
//   landiff_flash_bwd: one CTA per (128-row kv tile, b*h), 384 threads:
//     warpgroup 0 is the producer (one thread: K, V once by TMA, then for
//     each visited q tile q, q', do by TMA and the lse / delta rows by bulk
//     copy into a 3-stage ring under full / empty mbarriers); warpgroups 1
//     and 2 each own 64 of the kv rows and, per q tile, in the transposed
//     orientation (kv rows are the wgmma's M):
//       s^T  = K_wg . q'^T,  dp^T = V_wg . do^T   wgmma, operands in smem
//       p^T  = exp2(s^T - lse) * keep     registers (ex2.approx); the mask
//                                         per score on partial and ragged
//                                         tiles only
//       dv  += bf16(p^T) . do             wgmma, A from registers
//       ds^T = p^T * (dp^T - delta) * scale, bf16 in registers and in smem
//       dk  += ds^T . q                   wgmma, A from registers
//     and dq of the tile (64 q rows) = ds . K over all 128 kv rows, each
//     warpgroup taking 32 of the 64 head columns once both halves of ds^T
//     are in smem (an mbarrier, not a barrier: the product is issued a tile
//     late, so neither warpgroup waits for the other). The f32 dq half goes
//     to a 128-byte-swizzled smem box and one thread adds it into the
//     workspace with a TMA bulk reduce-add (cp.reduce.async.bulk.tensor
//     .add): one 8 KB operation per warpgroup and tile instead of a vector
//     atomic per thread and element. The order of those adds, so the last
//     bits of dq, changes from run to run; dk and dv stay in registers and
//     are written once, rounded to bf16: deterministic.
//
// Bound on the H100 (B=1 S=17,776 H=30 D=64, unmasked): 10*B*H*S^2*D =
// 6.07 TFLOP of tensor-core work, 6.1 ms at 989 TFLOP/s; B*H*S^2 = 9.5e9
// exp2, 2.3 ms on the SFUs; the bytes (about 0.5 GB) are far below. Bound
// by operations. The design keeps the tensor cores fed from smem (wgmma,
// no per-fragment loads), moves loads off the consumers (TMA ring,
// producer warp), and halves the dq reduction (a 128-row kv tile) while
// moving it off the threads (one bulk operation per 8 KB). What it does
// not do yet is overlap one warpgroup's exp2 with the tensor cores: each
// product's time shows in full in the kernel's (PERF.md).
//
// Layout: q, q', k, v, do, dk, dv BSHD bf16 (read by 4-D tensor maps, dims
// (D, H, S, B), so rows past S come back as zeros and never from the next
// batch); lse, delta (B, H, Sq_pad) f32; dq workspace (B, H, Sq_pad, D)
// f32. Tables (count (nk,), order and kind (nk, nq)) are int32 on the
// device at this kernel's 64-row q x 128-row kv tiles.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kBwdKV = 128;           // kv rows per CTA
constexpr int kStages = 3;            // q-tile ring
constexpr int kBwdThreads = 384;      // producer + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr uint32_t kTileBytes = kBQ * kD * 2;          // 8 KB bf16 q tile
constexpr uint32_t kStageBytes = 3 * kTileBytes + 2 * kBQ * 4;

struct Params {
  const float* lse;      // (B, H, Sq_pad) log2, +inf past Sq
  const float* delta;    // (B, H, Sq_pad) rowsum(do * out)
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const int* count;      // null: every q tile visited
  const int* order;
  const int* kind;
  int B, H, Sq, Skv, Sq_pad, nq_table;
  float scale;           // softmax scale, f32
  int mask_kind, nf, tpf, iqt, pft;   // mask descriptor (VideoMaskLayout)
  int iqe;                            // nf * tpf + iqt
  float inv_tpf, inv_pft;             // 1 / tpf, 1 / pft in f32
};

struct alignas(1024) Stage {
  uint16_t q[kBQ * kD];       // raw q (B of dk += ds^T.q)
  uint16_t qs[kBQ * kD];      // q' = bf16(q * scale*log2e)
  uint16_t dout[kBQ * kD];
};

struct alignas(1024) Smem {
  uint16_t k[kBwdKV * kD];
  uint16_t v[kBwdKV * kD];
  Stage st[kStages];
  uint16_t ds[2][kBwdKV * kD];    // bf16(scale*ds)^T: [kv row][q], swizzled
  float dq[2][kBQ * 32];          // per warpgroup: 64 q x 32 d reduce box
  float lse[kStages][kBQ];
  float delta[kStages][kBQ];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t ds_ready[2];           // both warpgroups' ds^T rows written
  uint64_t ds_free[2];            // the dq that read them has finished
  uint64_t kv_full;
};

// byte offset of (row, 16-byte chunk) in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// s^T = K_wg . q'^T and dp^T = V_wg . do^T (64 kv x 64 q each, all
// operands K-major) of the tile in `stage`, as two commit groups
__device__ __forceinline__ void issue_s_dp(float (&st)[32], float (&dp)[32],
                                           uint32_t kw_base, uint32_t vw_base,
                                           const Stage& stage) {
  const uint32_t qs_b = smem_addr(stage.qs);
  const uint32_t do_b = smem_addr(stage.dout);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss_n64<0, 0>(st, wgmma_desc(kw_base + kk * 32, 16, 1024),
                       wgmma_desc(qs_b + kk * 32, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss_n64<0, 0>(dp, wgmma_desc(vw_base + kk * 32, 16, 1024),
                       wgmma_desc(do_b + kk * 32, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// dq half of tile j (64 q x 32 d, columns cw*32 ..) = ds . K[:, cw*32 ..]
// over the CTA's 128 kv rows, once both warpgroups' ds^T rows of the tile
// are in place: ds from ds^T and K, both MN-major, from shared memory.
__device__ __forceinline__ void issue_dq_half(float (&dq)[16], Smem& sm,
                                              int j, uint32_t k_base,
                                              int cw) {
  mbar_wait(&sm.ds_ready[j & 1], (j >> 1) & 1);
  const uint32_t ds_base = smem_addr(sm.ds[j & 1]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_ss_n32<1, 1>(dq, wgmma_desc(ds_base + kk * 2048, 1024, 1024),
                       wgmma_desc(k_base + cw * 64 + kk * 2048, 1024, 1024),
                       kk > 0);
  }
  wgmma_commit();
}

// A warpgroup's dq half (64 q x 32 d f32 accumulators) into its swizzled
// reduce box, once the box's last bulk reduce has read it out, then one
// thread adds the box into the workspace rows from `row` on.
__device__ __forceinline__ void reduce_dq_half(unsigned char* box,
                                               const float (&dq)[16],
                                               const CUtensorMap& tm_dq,
                                               int row, int warp, int g,
                                               int t, int ct, int cw) {
  if (ct == 0) bulk_wait_read<0>();
  named_barrier(1 + cw, 128);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = warp * 16 + g + half * 8;
      *reinterpret_cast<float2*>(box + swz(row, n * 2 + t / 2) +
                                 (t & 1) * 8) =
          make_float2(dq[n * 4 + half * 2], dq[n * 4 + half * 2 + 1]);
    }
  }
  fence_async_smem();
  named_barrier(1 + cw, 128);
  if (ct == 0) {
    tma_reduce_add_2d(&tm_dq, box, cw * 32, row);
    bulk_commit();
  }
}

// floor(a / b) for b >= 1 and |a| < 2^24, through the f32 reciprocal
// `inv` = 1/b and one exact integer correction (an integer division costs
// several times as much).
__device__ __forceinline__ int floordiv_fast(int a, int b, float inv) {
  int f = __float2int_rd(__int2float_rn(a) * inv);
  const int r = a - f * b;
  f += (r < 0) ? -1 : (r >= b ? 1 : 0);
  return f;
}

// exp2 on the SFU (ex2.approx.ftz.f32: about 2 ulp; inputs and results
// below 2^-126 flushed to 0), as p is rounded to bf16 right after. The
// accurate exp2f makes the kernel 5 % slower at the training shape and
// 16 % at the TiTok shape (chip_bwd_ablation.py).
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kVideo: the video masks' algebra on partial tiles; else only the bounds
// and causal, which keeps the masked path out of the unmasked loop's way
// (with the frame arithmetic in it the unmasked shape ran slower).
template <bool kVideo>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_qs,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_dq, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  // warp-uniform (a shuffle), so no wgmma sits in a path the compiler
  // takes for divergent
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kv0 = kt * kBwdKV;
  const int n_tiles = __shfl_sync(
      0xffffffffu, p.count ? p.count[kt] : (p.Sq + kBQ - 1) / kBQ, 0);
  const int* order = p.order ? p.order + static_cast<size_t>(kt) * p.nq_table
                             : nullptr;
  const int* kinds = p.kind ? p.kind + static_cast<size_t>(kt) * p.nq_table
                            : nullptr;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.ds_ready[i], kConsumers);
      mbar_init(&sm.ds_free[i], kConsumers);
    }
    mbar_init(&sm.kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * kBwdKV * kD * 2);
      tma_load_4d(sm.k, &tm_k, &sm.kv_full, 0, h, kv0, b);
      tma_load_4d(sm.v, &tm_v, &sm.kv_full, 0, h, kv0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        const int q0 = (order ? order[j] : j) * kBQ;
        mbar_expect_tx(&sm.full[s], kStageBytes);
        tma_load_4d(sm.st[s].q, &tm_q, &sm.full[s], 0, h, q0, b);
        tma_load_4d(sm.st[s].qs, &tm_qs, &sm.full[s], 0, h, q0, b);
        tma_load_4d(sm.st[s].dout, &tm_do, &sm.full[s], 0, h, q0, b);
        const size_t row = static_cast<size_t>(bh) * p.Sq_pad + q0;
        bulk_load(sm.lse[s], p.lse + row, kBQ * 4, &sm.full[s]);
        bulk_load(sm.delta[s], p.delta + row, kBQ * 4, &sm.full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns kv rows cw*64 .. cw*64+63
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int ct = tid - 128 * wg;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_lo = cw * 64 + warp * 16 + g;   // kv rows r_lo and r_lo + 8
  const uint32_t k_base = smem_addr(sm.k), v_base = smem_addr(sm.v);
  const uint32_t kw_base = k_base + cw * 64 * 128;   // this warpgroup's rows
  const uint32_t vw_base = v_base + cw * 64 * 128;
  unsigned char* dqb = reinterpret_cast<unsigned char*>(sm.dq[cw]);

  float dk[32], dv[32], st[32], dp[32], dq[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  // the zeros are in place before the first wgmma is issued: a register
  // that a wgmma accumulates into may not be defined by other instructions
  // while any wgmma is in flight, or the compiler serializes them all
  reg_fence(dk);
  reg_fence(dv);
  mbar_wait(&sm.kv_full, 0);

  // Iteration j issues tile j's s^T and dp^T, then tile j-1's dq half
  // (deferred by a tile, so that neither warpgroup waits for the other's
  // ds^T while it could work), evaluates the mask under them, and one
  // wait retires everything in flight: dv, dk of tile j-1 too. Then tile
  // j-1 is drained and tile j's elementwise work issues dv and dk. (A
  // partial wait, leaving dp^T to run under the exp2, is no faster: the
  // compiler does not follow which group a partial wait retires across the
  // loop's back-edge, and serializes every wgmma.)
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int buf = j & 1;                   // ds^T buffer of this tile
    const uint32_t use = (j >> 1) & 1;       // parity of its use
    const int q0 = (order ? order[j] : j) * kBQ;
    const bool partial = (kinds ? kinds[j] == 1 : false) ||
                         kv0 + kBwdKV > p.Skv || q0 + kBQ > p.Sq;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    issue_s_dp(st, dp, kw_base, vw_base, sm.st[s]);
    if (j > 0) issue_dq_half(dq, sm, j - 1, k_base, cw);

    // ---- mask (partial and ragged tiles only): keep bit per score, while
    // s^T and dp^T are on the tensor cores
    uint32_t keep_bits = 0xffffffffu;
    if (partial && !kVideo) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = kv0 + r_lo + (e >> 1) * 8;
          const int qi = q0 + n * 8 + t * 2 + (e & 1);
          if (!(kj < p.Skv && qi < p.Sq &&
                (p.mask_kind != kMaskCausal || qi >= kj))) {
            keep_bits &= ~(1u << (n * 4 + e));
          }
        }
      }
    }
    if (partial && kVideo) {
      int kj[2], kj_frame[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        kj[r] = kv0 + r_lo + r * 8;
        kj_frame[r] = floordiv_fast(kj[r], p.tpf, p.inv_tpf);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = q0 + n * 8 + t * 2 + c;
          const int q_frame = floordiv_fast(qi, p.tpf, p.inv_tpf);
          const int p_frame = floordiv_fast(qi - p.iqe, p.pft, p.inv_pft) + 1;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (!(kj[r] < p.Skv && qi < p.Sq &&
                  keep_frames(p, qi, q_frame, p_frame, kj[r], kj_frame[r]))) {
              keep_bits &= ~(1u << (n * 4 + r * 2 + c));
            }
          }
        }
      }
    }

    wgmma_wait<0>();
    reg_fence(st);
    reg_fence(dp);
    reg_fence(dv);
    reg_fence(dk);
    reg_fence(dq);
    if (j > 0) {
      // ---- drain tile j-1: release its stage and ds^T buffer, add its
      // dq half into the workspace
      mbar_arrive(&sm.empty[(j - 1) % kStages]);
      mbar_arrive(&sm.ds_free[buf ^ 1]);
      reduce_dq_half(dqb, dq, tm_dq,
                     bh * p.Sq_pad + (order ? order[j - 1] : j - 1) * kBQ,
                     warp, g, t, ct, cw);
    }

    // ---- p^T = exp2(s^T - lse[q]) * keep. A masked score's p is 0
    // whatever s is (JAX: s = -1e30, then * keep). The accumulators are
    // only read: a register that a wgmma defines is written by no other
    // instruction, or the compiler serializes the wgmmas.
    float pf[32];
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(&sm.lse[s][n * 8 + t * 2]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2_sfu(st[n * 4 + e] - ((e & 1) ? l2.y : l2.x));
        pf[n * 4 + e] = ((keep_bits >> (n * 4 + e)) & 1u) ? pe : 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(pf[kk * 8 + r * 2], pf[kk * 8 + r * 2 + 1]);
      }
    }

    // ---- dv += bf16(p^T) . do (do MN-major); ds is formed under it
    const uint32_t do_b = smem_addr(sm.st[s].dout);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64<1>(dv, pa[kk], wgmma_desc(do_b + kk * 2048, 1024, 1024));
    }
    wgmma_commit();

    // ---- ds^T = p^T * (dp^T - delta[q]) * scale, rounded to bf16: A
    // fragments for dk, and the [kv][q] tile for dq once the dq of this
    // buffer's previous use has read it
    uint32_t da[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(&sm.delta[s][n * 8 + t * 2]);
      float dsf[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ds = __fmul_rn(
            pf[n * 4 + e], __fsub_rn(dp[n * 4 + e], (e & 1) ? d2.y : d2.x));
        dsf[e] = __fmul_rn(ds, p.scale);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        da[n / 2][(n & 1) * 2 + half] =
            pack_bf16(dsf[half * 2], dsf[half * 2 + 1]);
      }
    }
    mbar_wait(&sm.ds_free[buf], use ^ 1);
    unsigned char* dsb = reinterpret_cast<unsigned char*>(sm.ds[buf]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        *reinterpret_cast<uint32_t*>(dsb + swz(r_lo + half * 8, n) + t * 4) =
            da[n / 2][(n & 1) * 2 + half];
      }
    }
    fence_async_smem();
    mbar_arrive(&sm.ds_ready[buf]);

    // ---- dk += ds^T . q (q MN-major)
    const uint32_t q_b = smem_addr(sm.st[s].q);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64<1>(dk, da[kk], wgmma_desc(q_b + kk * 2048, 1024, 1024));
    }
    wgmma_commit();
  }
  if (n_tiles > 0) issue_dq_half(dq, sm, n_tiles - 1, k_base, cw);
  wgmma_wait<0>();
  reg_fence(dv);
  reg_fence(dk);
  reg_fence(dq);
  if (n_tiles > 0) {                         // drain the last tile
    const int last = n_tiles - 1;
    reduce_dq_half(dqb, dq, tm_dq,
                   bh * p.Sq_pad + (order ? order[last] : last) * kBQ, warp,
                   g, t, ct, cw);
  }

  // ---- epilogue: this warpgroup's 64 kv rows of dk, dv, rounded once
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = kv0 + r_lo + half * 8;
    if (kj >= p.Skv) continue;
    const size_t off =
        (static_cast<size_t>(b) * p.Skv + kj) * p.H * kD +
        static_cast<size_t>(h) * kD;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(&p.dk[off + n * 8 + t * 2]) =
          pack_bf16(dk[n * 4 + half * 2], dk[n * 4 + half * 2 + 1]);
      *reinterpret_cast<uint32_t*>(&p.dv[off + n * 8 + t * 2]) =
          pack_bf16(dv[n * 4 + half * 2], dv[n * 4 + half * 2 + 1]);
    }
  }
  if (ct == 0) bulk_wait<0>();
}

// One 8-thread group per (b, s, h) row of 64, s < Sq_pad, rows in BSHD
// order (coalesced): delta and the padded lse, q', and the row's zeros in
// the dq workspace.
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const __nv_bfloat16* q, const __nv_bfloat16* out,
                      const __nv_bfloat16* dout, const float* lse,
                      __nv_bfloat16* qs, float* lse_pad, float* delta,
                      float* dq, int B, int H, int Sq, int Sq_pad,
                      float qscale) {
  const long long rows = static_cast<long long>(B) * Sq_pad * H;
  const long long row = static_cast<long long>(blockIdx.x) * 32 +
                        threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  const bool live = row < rows;
  const int h = static_cast<int>(row % H);
  const int sp = static_cast<int>((row / H) % Sq_pad);
  const int b = static_cast<int>(row / (static_cast<long long>(H) * Sq_pad));
  const size_t bhs = (static_cast<size_t>(b) * H + h) * Sq_pad + sp;
  float sum = 0.f;
  if (live && sp < Sq) {
    const size_t off = ((static_cast<size_t>(b) * Sq + sp) * H + h) * kD +
                       part * 8;
    const uint4 qv = *reinterpret_cast<const uint4*>(q + off);
    const uint4 ov = *reinterpret_cast<const uint4*>(out + off);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&qv);
    const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
    const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dv);
    uint4 sv;
    __nv_bfloat16* se = reinterpret_cast<__nv_bfloat16*>(&sv);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      sum = __fmaf_rn(__bfloat162float(de[x]), __bfloat162float(oe[x]), sum);
      se[x] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(qe[x]), qscale));
    }
    *reinterpret_cast<uint4*>(qs + off) = sv;
  }
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (!live) return;
  float4* z = reinterpret_cast<float4*>(dq + bhs * kD + part * 8);
  z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (part == 0) {
    delta[bhs] = sp < Sq ? sum : 0.f;
    lse_pad[bhs] = sp < Sq ? lse[(static_cast<size_t>(b) * H + h) * Sq + sp]
                           : __int_as_float(0x7f800000);   // +inf: p = 0
  }
}

// a BSHD bf16 tensor (B, S, H, 64) read in boxes of `rows` rows of one
// (b, h)
int bshd_map(CUtensorMap* map, const void* base, int B, int S, int H,
             int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(kD) * 2, static_cast<cuuint64_t>(H) * kD * 2,
      static_cast<cuuint64_t>(S) * H * kD * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kD), 1,
                             static_cast<cuuint32_t>(rows), 1};
  return landiff_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                            dims, strides, box);
}

}  // namespace

// Plain C interface (bound with ctypes). Each returns 0, a cudaError_t of
// the launch (or of raising the kernel's shared-memory limit), or, for a
// tensor map that could not be encoded, 1000 + its CUresult (-1: the
// driver has no cuTensorMapEncodeTiled).

// The prologue; Sq_pad = Sq rounded up to 64. qs (B, Sq, H, 64) bf16;
// lse_pad, delta (B, H, Sq_pad) f32; dq (B, H, Sq_pad, 64) f32.
extern "C" int landiff_flash_bwd_prep(
    const void* q, const void* out, const void* dout, const float* lse,
    void* qs, float* lse_pad, float* delta, float* dq, int B, int H, int Sq,
    int Sq_pad, float qscale, void* stream) {
  const long long rows = static_cast<long long>(B) * Sq_pad * H;
  const unsigned grid = static_cast<unsigned>((rows + 31) / 32);
  flash_bwd_prep_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), lse,
      static_cast<__nv_bfloat16*>(qs), lse_pad, delta, dq, B, H, Sq, Sq_pad,
      qscale);
  return static_cast<int>(cudaGetLastError());
}

// The main kernel, on the prologue's outputs. Tiles: 64 q rows x 128 kv
// rows; head dim 64 only; every tensor 16-byte aligned.
extern "C" int landiff_flash_bwd(
    const void* q, const void* qs, const void* k, const void* v,
    const void* dout, const float* lse_pad, const float* delta, float* dq,
    void* dk, void* dv, const int* count, const int* order, const int* kind,
    int B, int H, int Sq, int Skv, int Sq_pad, int nq_table, float scale,
    int mask_kind, int nf, int tpf, int iqt, int pft, void* stream) {
  CUtensorMap tm_q, tm_qs, tm_do, tm_k, tm_v, tm_dq;
  int rc = bshd_map(&tm_q, q, B, Sq, H, kBQ);
  if (rc == 0) rc = bshd_map(&tm_qs, qs, B, Sq, H, kBQ);
  if (rc == 0) rc = bshd_map(&tm_do, dout, B, Sq, H, kBQ);
  if (rc == 0) rc = bshd_map(&tm_k, k, B, Skv, H, kBwdKV);
  if (rc == 0) rc = bshd_map(&tm_v, v, B, Skv, H, kBwdKV);
  if (rc == 0) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kD),
                                static_cast<cuuint64_t>(B) * H * Sq_pad};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kD) * 4};
    const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(kBQ)};
    rc = landiff_tensor_map(&tm_dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, dq,
                            dims, strides, box);
  }
  if (rc != 0) return rc < 0 ? rc : 1000 + rc;

  Params p;
  p.lse = lse_pad;
  p.delta = delta;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.count = count;
  p.order = order;
  p.kind = kind;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Sq_pad = Sq_pad;
  p.nq_table = nq_table;
  p.scale = scale;
  p.mask_kind = mask_kind;
  p.nf = nf;
  p.tpf = tpf;
  p.iqt = iqt;
  p.pft = pft;
  p.iqe = nf * tpf + iqt;
  p.inv_tpf = 1.f / static_cast<float>(tpf);
  p.inv_pft = 1.f / static_cast<float>(pft);
  const bool video =
      mask_kind == kMaskVideoEncoder || mask_kind == kMaskVideoDecoder;
  auto kernel = video ? flash_bwd_kernel<true> : flash_bwd_kernel<false>;
  const int smem_bytes = static_cast<int>(sizeof(Smem)) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Skv + kBwdKV - 1) / kBwdKV, B * H);
  kernel<<<grid, kBwdThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_qs, tm_do, tm_k, tm_v, tm_dq, p);
  return static_cast<int>(cudaGetLastError());
}

// The main kernel's dynamic shared memory per CTA, in bytes.
extern "C" int landiff_flash_bwd_smem_bytes() {
  return static_cast<int>(sizeof(Smem)) + 1024;
}
