// Fused adaLN modulate for Hopper (sm_90a): LayerNorm with affine, then
// h * (1 + scale) + shift with the (shift, scale) pair picked per row,
// in one pass over device memory.
//
// Replaces the Pallas kernel `_kernel` of landiff_tpu/ops/adaln.py (:33,
// called from `_fused` :51). What it computes, per row r of x (B, S, D):
//   mu  = mean(x_r)                         (f32)
//   xc  = x_r - mu
//   var = mean(xc * xc)                     (f32, two passes, not E[x^2]-mu^2)
//   h   = xc * rsqrt(var + eps) * w + b
//   out = h * (1 + scale) + shift           rounded ONCE to the I/O dtype
// where (shift, scale) is the text pair of the row's batch entry for
// s < text_len and the video pair otherwise.
//
// Bound on the H100: bytes. The DiT call (2, 17,776, 1,920) bf16 reads
// 136.5 MB and writes 136.5 MB, 0.082 ms at 3.35 TB/s; the arithmetic is a
// few operations per byte. The design therefore reads x once with 16-byte
// loads and keeps the whole row in registers between the two statistics
// passes and the modulate: one warp owns one row (D / 32 elements per lane,
// 60 at D = 1,920), reduces with shuffles, needs no shared memory and no
// block-level barrier. w, b and the (B, D) pairs are re-read per row
// through the read-only cache; they are 4 * D values shared by every row
// and stay in L2. Neighbouring lanes load neighbouring 16-byte chunks.
//
// Shapes: any S, any D that is a multiple of 8 up to 4,096; bf16 or f32
// I/O, with w, b and the pairs in the same dtype. x and out are contiguous
// rows; each pair has its own row stride (the DiT passes slices of one
// (B, 12 D) tensor).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxD = 4096;

struct Params {
  const void* x;
  const void* w;
  const void* b;
  const void* t_shift;
  const void* t_scale;
  const void* v_shift;
  const void* v_scale;
  void* out;
  long long rows;     // B * S
  int S;
  int D;
  int text_len;
  int stride_ts, stride_tc, stride_vs, stride_vc;   // pair row strides, elements
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NCHUNK: 16-byte chunks per lane, so a row holds at most 32 * NCHUNK chunks
template <typename T, int NCHUNK>
__global__ void __launch_bounds__(kThreads)
adaln_kernel(const Params p) {
  constexpr int N = Chunk<T>::kN;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= p.rows) return;   // whole warps leave: no barrier follows
  const int nchunk = p.D / N;
  const int bi = static_cast<int>(row / p.S);
  const int si = static_cast<int>(row - static_cast<long long>(bi) * p.S);
  const T* x = static_cast<const T*>(p.x) + row * p.D;
  T* out = static_cast<T*>(p.out) + row * p.D;

  float xv[NCHUNK][N];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NCHUNK; ++i) {
    const int c = lane + 32 * i;
    if (c < nchunk) {
      Chunk<T>::load(x + c * N, xv[i]);
#pragma unroll
      for (int j = 0; j < N; ++j) sum += xv[i][j];
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) xv[i][j] = 0.f;
    }
  }
  const float inv_d = 1.0f / static_cast<float>(p.D);
  const float mu = warp_sum(sum) * inv_d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NCHUNK; ++i) {
    if (lane + 32 * i < nchunk) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        xv[i][j] -= mu;
        sq += xv[i][j] * xv[i][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_d + p.eps);

  const bool is_text = si < p.text_len;
  const T* shift = is_text
      ? static_cast<const T*>(p.t_shift) + static_cast<long long>(bi) * p.stride_ts
      : static_cast<const T*>(p.v_shift) + static_cast<long long>(bi) * p.stride_vs;
  const T* scale = is_text
      ? static_cast<const T*>(p.t_scale) + static_cast<long long>(bi) * p.stride_tc
      : static_cast<const T*>(p.v_scale) + static_cast<long long>(bi) * p.stride_vc;
  const T* w = static_cast<const T*>(p.w);
  const T* b = static_cast<const T*>(p.b);
#pragma unroll
  for (int i = 0; i < NCHUNK; ++i) {
    const int c = lane + 32 * i;
    if (c < nchunk) {
      float wv[N], bv[N], sh[N], sc[N], o[N];
      Chunk<T>::load(w + c * N, wv);
      Chunk<T>::load(b + c * N, bv);
      Chunk<T>::load(shift + c * N, sh);
      Chunk<T>::load(scale + c * N, sc);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float h = xv[i][j] * rstd * wv[j] + bv[j];
        o[j] = h * (1.0f + sc[j]) + sh[j];
      }
      Chunk<T>::store(out + c * N, o);
    }
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int N = Chunk<T>::kN;
  if (p.rows <= 0) return 0;
  if (p.D <= 0 || p.D % 8 != 0 || p.D > kMaxD || p.S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (p.rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  // chunks per lane in steps of a quarter of the widest row
  constexpr int kStep = kMaxD / N / 32 / 4;
  const int per_lane = (p.D / N + 31) / 32;
  if (per_lane <= kStep)
    adaln_kernel<T, kStep><<<grid, kThreads, 0, stream>>>(p);
  else if (per_lane <= 2 * kStep)
    adaln_kernel<T, 2 * kStep><<<grid, kThreads, 0, stream>>>(p);
  else if (per_lane <= 3 * kStep)
    adaln_kernel<T, 3 * kStep><<<grid, kThreads, 0, stream>>>(p);
  else
    adaln_kernel<T, 4 * kStep><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16: 1 for bfloat16 I/O, 0 for float32. Returns the cudaError of
// the launch (0 on success).
extern "C" int landiff_adaln_modulate(
    const void* x, const void* w, const void* b, const void* t_shift,
    const void* t_scale, const void* v_shift, const void* v_scale, void* out,
    int B, int S, int D, int text_len, int stride_ts, int stride_tc,
    int stride_vs, int stride_vc, float eps, int is_bf16, void* stream) {
  Params p;
  p.x = x; p.w = w; p.b = b;
  p.t_shift = t_shift; p.t_scale = t_scale;
  p.v_shift = v_shift; p.v_scale = v_scale;
  p.out = out;
  p.rows = static_cast<long long>(B) * S;
  p.S = S; p.D = D; p.text_len = text_len;
  p.stride_ts = stride_ts; p.stride_tc = stride_tc;
  p.stride_vs = stride_vs; p.stride_vc = stride_vc;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}
