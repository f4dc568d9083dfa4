// The DiT layer's qkv preparation for Hopper (sm_90a): from the bias-free
// qkv product to the three attention inputs in one pass over device memory.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it. In PyTorch the chain (bias add, the strided q / k views,
// LayerNorm over each head's 64 values, Rotary3D, the copy of v) is some
// 45 passes over a (B, S, D) activation a layer, each rounding to the
// activation dtype. What it computes, per token row r = (b, s) of y
// (B, S, 3 D), D = H * 64, for each part (q, k, v) and head h:
//   t   = y[r, part, h, :] + bias[part, h, :]            (f32)
//   q, k only, with qk-LN:
//     mu  = mean(t); tc = t - mu; var = mean(tc * tc)    (f32, two passes)
//     t   = tc * rsqrt(var + eps) * w + b                (w, b: (64,), q's or k's)
//   with the rotary tables (q, k, and v under rot_v):
//     t   = t * cos[s'] + swap(t) * sin[s']              (s' = min(s, n_pos - 1))
//   out_part[r, h, :] = t                                rounded ONCE
// where swap exchanges the two values of each pair (2i, 2i + 1) and sin
// carries the pair's sign (models/dit.py `_rotary3d_on`: its text rows are
// cos 1, sin 0, so the tables cover every position and nothing selects).
//
// Bound on the H100: bytes. The 2b DiT call (2, 17,776, 5,760) bf16 reads
// 409.6 MB and writes 409.6 MB (0.245 ms at 3.35 TB/s); 5b's 3 x 3,072
// wide rows 655.4 + 655.4 MB (0.391 ms). The arithmetic is a few
// operations per byte. So the kernel reads y once with 16-byte loads and
// writes each output once with 16-byte stores, and keeps nothing else in
// device memory: a head's 64 values are 8 lanes' chunks in bf16 (16 in
// f32), neighbouring lanes on neighbouring chunks of the flat (rows, 3 D)
// product, and its statistics are shuffle reductions inside those lanes.
// Each thread holds kUnroll chunks, 32 chunks apart, whose loads are all
// issued before any arithmetic: 64 bytes in flight a thread. The bias, the
// LayerNorm affine and the rotary rows are re-read per chunk through the
// read-only cache: a rotary row serves the 2 H heads of q and k of its
// token, the rest is a few KB.
//
// Shapes: any B * S, D a multiple of 64 (heads of 64); bf16 or f32 I/O, with
// the bias, the affine and the tables in the same dtype; every pointer
// 16-byte aligned, rows contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // 16-byte chunks per thread
constexpr int kHeadDim = 64;

struct QkvParams {
  const void* y;       // (rows, 3 D), the qkv product without its bias
  const void* bias;    // (3 D,)
  const void* q_w;     // (64,) q's LayerNorm affine, k's below
  const void* q_b;
  const void* k_w;
  const void* k_b;
  const void* cos;     // (n_pos, 64) rotary tables, or null
  const void* sin;
  void* q;             // (rows, D) each
  void* k;
  void* v;
  unsigned total;      // chunks of y
  int S;               // tokens a batch entry: the position is row % S
  int D;
  int n_pos;
  int qk_ln;
  int rot_v;
  float eps;
};

template <typename T>
struct Chunk;   // one 16-byte load

template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> f32 is a shift: exact
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // round to nearest even, the one rounding of the result
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// the sum over the L lanes of an aligned group (one head's chunks)
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A warp owns 32 * kUnroll consecutive chunks; lane l holds chunks
// base + 32 u + l. y's total is a multiple of a head's chunks, so a head's
// lanes are valid or not together, and every lane joins the shuffles.
template <typename T, bool ROT>
__global__ void __launch_bounds__(kThreads)
qkv_layer_norm_rotary_kernel(const QkvParams p) {
  constexpr int N = Chunk<T>::kN;
  constexpr int L = kHeadDim / N;          // lanes a head
  const int lane = threadIdx.x & 31;
  const unsigned base =
      (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * (32u * kUnroll);
  const unsigned cpp = static_cast<unsigned>(p.D) / N;   // chunks a part
  const unsigned cpr = 3u * cpp;                         // chunks a row
  const T* y = static_cast<const T*>(p.y);

  float t[kUnroll][N];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned c = base + 32u * u + lane;
    if (c < p.total) {
      Chunk<T>::load(y + static_cast<size_t>(c) * N, t[u]);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) t[u][j] = 0.f;
    }
  }

#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned c = base + 32u * u + lane;
    const unsigned r = c / cpr;
    const unsigned cc = c - r * cpr;       // chunk within the row
    const unsigned part = cc / cpp;        // 0 q, 1 k, 2 v
    const unsigned w = cc - part * cpp;    // chunk within the part
    const int d0 = static_cast<int>(w % L) * N;
    float b[N];
    Chunk<T>::load(static_cast<const T*>(p.bias) + cc * N, b);
#pragma unroll
    for (int j = 0; j < N; ++j) t[u][j] += b[j];

    if (p.qk_ln) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) s += t[u][j];
      const float mu = group_sum<L>(s) * (1.0f / kHeadDim);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float d = t[u][j] - mu;
        sq += d * d;
      }
      const float rstd = rsqrtf(group_sum<L>(sq) * (1.0f / kHeadDim) + p.eps);
      if (part < 2) {
        float lw[N], lb[N];
        Chunk<T>::load(static_cast<const T*>(part ? p.k_w : p.q_w) + d0, lw);
        Chunk<T>::load(static_cast<const T*>(part ? p.k_b : p.q_b) + d0, lb);
#pragma unroll
        for (int j = 0; j < N; ++j)
          t[u][j] = (t[u][j] - mu) * rstd * lw[j] + lb[j];
      }
    }

    if (ROT && (part < 2 || p.rot_v)) {
      const unsigned s = r % static_cast<unsigned>(p.S);
      const unsigned row = min(s, static_cast<unsigned>(p.n_pos - 1));
      const size_t at = static_cast<size_t>(row) * kHeadDim + d0;
      float cs[N], sn[N];
      Chunk<T>::load(static_cast<const T*>(p.cos) + at, cs);
      Chunk<T>::load(static_cast<const T*>(p.sin) + at, sn);
#pragma unroll
      for (int j = 0; j < N; j += 2) {
        const float a = t[u][j], e = t[u][j + 1];
        t[u][j] = a * cs[j] + e * sn[j];
        t[u][j + 1] = e * cs[j + 1] + a * sn[j + 1];
      }
    }

    if (c < p.total) {
      T* out = static_cast<T*>(part == 0 ? p.q : part == 1 ? p.k : p.v);
      Chunk<T>::store(out + static_cast<size_t>(r) * p.D + w * N, t[u]);
    }
  }
}

template <typename T>
int launch(const QkvParams& p, cudaStream_t stream) {
  if (p.total == 0) return 0;
  const unsigned per_block = kThreads * kUnroll;
  const dim3 grid((p.total + per_block - 1) / per_block);
  if (p.cos != nullptr)
    qkv_layer_norm_rotary_kernel<T, true><<<grid, kThreads, 0, stream>>>(p);
  else
    qkv_layer_norm_rotary_kernel<T, false><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (B, S, 3 D) -> q, k, v (B, S, D) each. cos / sin null: no rotation;
// q_w .. k_b unread without qk_ln. is_bf16: 1 for bfloat16 I/O, 0 for
// float32. The caller keeps B * S * 3 D / (16 / element size) under 2^31.
// Returns the cudaError of the launch (0 on success).
extern "C" int landiff_qkv_prep(
    const void* y, const void* bias, const void* q_w, const void* q_b,
    const void* k_w, const void* k_b, const void* cos, const void* sin,
    void* q, void* k, void* v, int B, int S, int D, int n_pos, int qk_ln,
    int rot_v, float eps, int is_bf16, void* stream) {
  if (B < 0 || S <= 0 || D <= 0 || D % kHeadDim != 0 ||
      (cos != nullptr && n_pos <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(B) * S * 3 * D /
                          (is_bf16 ? 8 : 4);
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  QkvParams p;
  p.y = y; p.bias = bias;
  p.q_w = q_w; p.q_b = q_b; p.k_w = k_w; p.k_b = k_b;
  p.cos = cos; p.sin = sin;
  p.q = q; p.k = k; p.v = v;
  p.total = static_cast<unsigned>(total);
  p.S = S; p.D = D; p.n_pos = n_pos;
  p.qk_ln = qk_ln; p.rot_v = rot_v; p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}
