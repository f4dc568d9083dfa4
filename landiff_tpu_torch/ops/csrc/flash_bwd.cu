// Flash-attention backward for Hopper (sm_90a): dq, dk, dv from the exact
// forward's saved log2 lse, block-sparse over per-kv-tile visibility tables.
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
// delta arrives as an input ((B, H, Sq) f32): the JAX package computes it
// outside its kernel too.
//
// What the TPU kernel does not have to solve. Its grid runs in order, so it
// adds dq into one resident (Sq, D) buffer across kv blocks. Here CTAs of
// different kv tiles run at once: one CTA owns a kv tile (dk, dv stay in
// its registers over the loop on q tiles and are written once, in bf16), and
// its dq contribution of each tile goes to a zeroed f32 (B, Sq, H, D)
// workspace with 8-byte vector atomics (red.global.add.v2.f32). The order
// of those sums, so the last bits of dq, changes from run to run; dk and dv
// are deterministic.
//
// Orientation. The CTA computes the transposed tile s^T = k.q'^T with each
// warp on 16 kv rows x 64 q columns, so that p^T and ds^T leave the
// accumulators in the layout of an A operand: dv and dk (16 kv rows x 64
// per warp) need no exchange. dq contracts over kv, which the warps split:
// ds^T goes through shared memory once and each warp then forms 16 q rows
// of ds.k with ldmatrix.trans on both operands.
//
// Bound on the H100 (B=1 S=17,776 H=30 D=64, unmasked): 10*B*H*S^2*D =
// 6.07 TFLOP of tensor-core work, 6.1 ms at 989 TFLOP/s; B*H*S^2 = 9.5e9
// exp2, 2.3 ms on the SFUs; the bytes (q, k, v, do, out read, dq, dk, dv
// written: about 0.5 GB) are far below. Bound by operations. This first
// version uses mma.sync m16n8k16 (not wgmma / TMA), a cp.async double
// buffer for the q / do tiles, and 2 CTAs per SM.
//
// Layout: q, k, v, do, dk, dv are BSHD bf16; lse, delta (B, H, Sq) f32; dq
// workspace (B, Sq, H, D) f32. Tables (count (nk,), order and kind (nk,
// nq)) are int32 on the device at this kernel's 64 x 64 tiles: the q tiles
// that see each kv tile; with no tables every q tile is visited. Partial
// tiles (kind 1) and ragged tiles (past Sq or Skv) evaluate the mask
// descriptor and the bounds per score.

#include "flash_common.cuh"

namespace {

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;      // (B, H, Sq) log2 domain, from the exact forward
  const float* delta;    // (B, H, Sq) rowsum(do * out)
  float* dq;             // (B, Sq, H, D) f32, zeroed by the caller
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const int* count;      // null: every q tile visited
  const int* order;
  const int* kind;
  int B, H, Sq, Skv, nq_table;
  float qscale;          // scale * log2(e), f32
  float scale;           // softmax scale, f32
  int mask_kind, nf, tpf, iqt, pft;   // mask descriptor (VideoMaskLayout)
};

struct Smem {
  alignas(16) uint16_t k[kBKV * kStrideH];
  alignas(16) uint16_t v[kBKV * kStrideH];
  alignas(16) uint16_t q[2][kBQ * kStrideH];      // raw q (for dk)
  alignas(16) uint16_t dout[2][kBQ * kStrideH];
  alignas(16) uint16_t qs[kBQ * kStrideH];        // q' = bf16(q * qscale)
  alignas(16) uint16_t ds[kBKV * kStrideH];       // bf16(scale*ds)^T: [kv][q]
  alignas(16) float lse[2][kBQ];
  alignas(16) float delta[2][kBQ];
};

__device__ __forceinline__ __nv_bfloat16* as_bf16(uint16_t* p) {
  return reinterpret_cast<__nv_bfloat16*>(p);
}

// q, do tiles and their lse / delta rows for the q tile starting at q0.
__device__ __forceinline__ void load_q_tile(const Params& p, Smem& sm,
                                            int stage, int q0, int b, int h,
                                            int tid) {
  load_tile_bf16(as_bf16(sm.q[stage]), p.q, q0, p.Sq, b, h, p.H, tid);
  load_tile_bf16(as_bf16(sm.dout[stage]), p.dout, q0, p.Sq, b, h, p.H, tid);
  const int r = tid & (kBQ - 1);
  const int qi = q0 + r;
  const bool ok = qi < p.Sq;
  const size_t off =
      (static_cast<size_t>(b) * p.H + h) * p.Sq + (ok ? qi : 0);
  if (tid < kBQ) {
    cp_async4(&sm.lse[stage][r], p.lse + off, ok ? 4 : 0);
  } else {
    cp_async4(&sm.delta[stage][r], p.delta + off, ok ? 4 : 0);
  }
}

// A-operand fragments (16 rows r0, r0+8 x 64 columns) of a padded tile.
__device__ __forceinline__ void load_a_frags(uint32_t a[4][4],
                                             const __nv_bfloat16* tile,
                                             int r0, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = *reinterpret_cast<const uint32_t*>(
        &tile[r0 * kStrideH + kk * 16 + t * 2]);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(
        &tile[(r0 + 8) * kStrideH + kk * 16 + t * 2]);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(
        &tile[r0 * kStrideH + kk * 16 + 8 + t * 2]);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(
        &tile[(r0 + 8) * kStrideH + kk * 16 + 8 + t * 2]);
  }
}

// c[n] (16 x 8 each, n = 0..7) = a (16 x 64) . tile^T, tile = 64 rows x 64
// columns in shared memory, read as the col-major B operand.
__device__ __forceinline__ void mma_a_tile_t(float c[8][4],
                                             const uint32_t a[4][4],
                                             const __nv_bfloat16* tile,
                                             int g, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* br = &tile[(n * 8 + g) * kStrideH + kk * 16 + t * 2];
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + 8);
      mma_bf16(c[n], a[kk], b0, b1);
    }
  }
}

// acc (16 x 64) += bf16(x) (16 x 64, accumulator layout) . tile, tile = 64
// rows x 64 columns in shared memory read through ldmatrix.trans. When
// `stash` is set, the bf16 fragments of x are also written there as a
// [row][column] tile (the warp's 16 rows at row0w).
__device__ __forceinline__ void mma_acc_tile(float acc[8][4],
                                             const float x[8][4],
                                             const __nv_bfloat16* tile,
                                             __nv_bfloat16* stash, int row0w,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    if (stash != nullptr) {
      __nv_bfloat16* lo = &stash[(row0w + g) * kStrideH + kk * 16 + t * 2];
      __nv_bfloat16* hi = lo + 8 * kStrideH;
      *reinterpret_cast<uint32_t*>(lo) = pa[0];
      *reinterpret_cast<uint32_t*>(hi) = pa[1];
      *reinterpret_cast<uint32_t*>(lo + 8) = pa[2];
      *reinterpret_cast<uint32_t*>(hi + 8) = pa[3];
    }
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) {
      const __nv_bfloat16* ptr =
          &tile[(kk * 16 + (mat & 1) * 8 + rr) * kStrideH + nd * 16 +
                (mat >> 1) * 8];
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, ptr);
      mma_bf16(acc[2 * nd], pa, bf[0], bf[1]);
      mma_bf16(acc[2 * nd + 1], pa, bf[2], bf[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group / thread-in-group
  const int mat = lane >> 3, rr = lane & 7;   // ldmatrix matrix / row
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kv0 = kt * kBKV;
  const size_t row_stride = static_cast<size_t>(p.H) * kD;

  const int n_tiles = p.count ? p.count[kt] : (p.Sq + kBQ - 1) / kBQ;
  const int* order = p.order ? p.order + static_cast<size_t>(kt) * p.nq_table
                             : nullptr;
  const int* kinds = p.kind ? p.kind + static_cast<size_t>(kt) * p.nq_table
                            : nullptr;

  // this CTA's K / V tile (rows >= Skv are zeros) and the first q tile
  load_tile_bf16(as_bf16(sm.k), p.k, kv0, p.Skv, b, h, p.H, tid);
  load_tile_bf16(as_bf16(sm.v), p.v, kv0, p.Skv, b, h, p.H, tid);
  if (n_tiles > 0) {
    load_q_tile(p, sm, 0, (order ? order[0] : 0) * kBQ, b, h, tid);
  }
  cp_async_commit();

  const int r0 = warp * 16 + g;    // this thread's kv rows: r0 and r0 + 8
  float dk[8][4], dv[8][4];        // 16 kv rows x 64 d per warp
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_q_tile(p, sm, stage ^ 1, (order ? order[j + 1] : j + 1) * kBQ, b,
                  h, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();               // tile j (and K / V) have arrived

    const int q0 = (order ? order[j] : j) * kBQ;
    const bool partial = (kinds ? kinds[j] == 1 : false) ||
                         kv0 + kBKV > p.Skv || q0 + kBQ > p.Sq;

    // ---- q' = bf16(q * scale*log2e), as the forward rounds it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 3, col = (c & 7) * 8;
      uint4 raw = *reinterpret_cast<const uint4*>(
          &sm.q[stage][r * kStrideH + col]);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        e[x] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(e[x]),
                                             p.qscale));
      }
      *reinterpret_cast<uint4*>(&sm.qs[r * kStrideH + col]) = raw;
    }
    __syncthreads();

    const __nv_bfloat16* qraw = as_bf16(sm.q[stage]);
    const __nv_bfloat16* dos = as_bf16(sm.dout[stage]);

    // ---- s^T = k . q'^T for this warp's 16 kv rows x 64 q columns
    float st[8][4];
    {
      uint32_t ka[4][4];
      load_a_frags(ka, as_bf16(sm.k), r0, t);
      mma_a_tile_t(st, ka, as_bf16(sm.qs), g, t);
    }

    // ---- mask (partial and ragged tiles only): keep bit per score
    uint32_t keep_bits = 0xffffffffu;
    if (partial) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = kv0 + r0 + (e >> 1) * 8;
          const int qi = q0 + n * 8 + t * 2 + (e & 1);
          const bool keep = kj < p.Skv && qi < p.Sq && mask_keep(p, qi, kj);
          if (!keep) {
            st[n][e] = kNegInf;
            keep_bits &= ~(1u << (n * 4 + e));
          }
        }
      }
    }

    // ---- p^T = exp2(s^T - lse[q]) * keep
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(&sm.lse[stage][n * 8 + t * 2]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2f(st[n][e] - ((e & 1) ? l2.y : l2.x));
        if (!((keep_bits >> (n * 4 + e)) & 1u)) pe = 0.f;
        st[n][e] = pe;
      }
    }

    // ---- dv += bf16(p)^T . do
    mma_acc_tile(dv, st, dos, nullptr, 0, lane);

    // ---- dp^T = v . do^T;  ds^T = p^T * (dp^T - delta[q]) * scale
    {
      float dpt[8][4];
      uint32_t va[4][4];
      load_a_frags(va, as_bf16(sm.v), r0, t);
      mma_a_tile_t(dpt, va, dos, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(&sm.delta[stage][n * 8 + t * 2]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ds = __fmul_rn(
              st[n][e], __fsub_rn(dpt[n][e], (e & 1) ? d2.y : d2.x));
          st[n][e] = __fmul_rn(ds, p.scale);
        }
      }
    }

    // ---- dk += bf16(scale*ds)^T . q, and the same bf16 tile to smem
    mma_acc_tile(dk, st, qraw, as_bf16(sm.ds), warp * 16, lane);
    __syncthreads();               // ds^T of all four warps is in place

    // ---- dq (this warp's 16 q rows) = bf16(scale*ds) . k, added atomically
    {
      float dq[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
      }
      const int qr0 = warp * 16;
      const __nv_bfloat16* dss = as_bf16(sm.ds);
      const __nv_bfloat16* ks = as_bf16(sm.k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {     // kv rows kk*16 .. +15
        uint32_t da[4];
        ldmatrix_x4_trans(da, &dss[(kk * 16 + (mat >> 1) * 8 + rr) * kStrideH +
                                   qr0 + (mat & 1) * 8]);
#pragma unroll
        for (int nd = 0; nd < 4; ++nd) {   // d columns nd*16 .. +15
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, &ks[(kk * 16 + (mat & 1) * 8 + rr) * kStrideH +
                                    nd * 16 + (mat >> 1) * 8]);
          mma_bf16(dq[2 * nd], da, kb[0], kb[1]);
          mma_bf16(dq[2 * nd + 1], da, kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int qi = q0 + qr0 + g + rh * 8;
        if (qi >= p.Sq) continue;
        float* row = p.dq + (static_cast<size_t>(b) * p.Sq + qi) * row_stride +
                     static_cast<size_t>(h) * kD;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          atomicAdd(reinterpret_cast<float2*>(&row[n * 8 + t * 2]),
                    make_float2(dq[n][rh * 2], dq[n][rh * 2 + 1]));
        }
      }
    }
    __syncthreads();   // the stage, qs and ds are rewritten by the next tile
  }
  cp_async_wait<0>();

  // ---- epilogue: this kv tile's dk, dv, rounded once
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int kj = kv0 + r0 + rh * 8;
    if (kj >= p.Skv) continue;
    const size_t off = (static_cast<size_t>(b) * p.Skv + kj) * row_stride +
                       static_cast<size_t>(h) * kD;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(&p.dk[off + n * 8 + t * 2]) =
          pack_bf16(dk[n][rh * 2], dk[n][rh * 2 + 1]);
      *reinterpret_cast<uint32_t*>(&p.dv[off + n * 8 + t * 2]) =
          pack_bf16(dv[n][rh * 2], dv[n][rh * 2 + 1]);
    }
  }
}

}  // namespace

// Plain C interface (bound with ctypes). Returns the cudaError_t of the
// launch (or of raising the kernel's dynamic shared-memory limit). The dq
// workspace must be zeroed by the caller on the same stream. Tiles: 64 q
// rows x 64 kv rows; head dim 64 only.
extern "C" int landiff_flash_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq, void* dk, void* dv,
    const int* count, const int* order, const int* kind, int B, int H, int Sq,
    int Skv, int nq_table, float qscale, float scale, int mask_kind, int nf,
    int tpf, int iqt, int pft, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.count = count;
  p.order = order;
  p.kind = kind;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.nq_table = nq_table;
  p.qscale = qscale;
  p.scale = scale;
  p.mask_kind = mask_kind;
  p.nf = nf;
  p.tpf = tpf;
  p.iqt = iqt;
  p.pft = pft;
  const int smem_bytes = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Skv + kBKV - 1) / kBKV, B * H);
  flash_bwd_kernel<<<grid, kThreads, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
