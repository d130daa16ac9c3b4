// The decoder block's elementwise chain for Hopper, as three kernels:
// add + RMSNorm, q/k RMSNorm + RoPE + the masked paged K/V write, SiLU * mul.
//
// Replaces no TPU kernel.  The JAX package runs the chain inside jit, where
// XLA fuses it around the matrix products; the port runs eagerly, and the
// same chain as PyTorch ops took about 77 launches a decoder block (each
// RMSNorm 9, each RoPE about 12, the K/V write's gathers and index_put_s,
// the residual adds, SiLU and the mul), so the serving engine's host spent
// its decode step launching them while the card idled.  These three bring a
// block to about 12 launches, with the matrix products and the attention
// kernel unchanged.
//
// What bounds them on H100: bytes, and at the decode step's size the latency
// of one launch.  Each reads its operands once and writes its results once
// (the decode step's 32 rows x 5120 in bf16 are 320 KB a tensor, about
// 0.1 us at 3.35 TB/s), with a few flops a byte.  So each is one pass, the
// intermediate values stay in registers, and every load is a 16-byte vector
// where the row allows it.
//
// The arithmetic follows the plain chain (models/layers.py rms_norm and
// apply_rope, F.silu): fp32 inside, rounded to the storage type where the
// chain rounds (the residual sum before its norm, the normed q/k before the
// rotation, silu before the product), and products kept apart from sums
// (__fmul_rn) so that no fused multiply-add changes the rounding.  Only the
// order of each row's sum of squares differs.
//
// * add_rms_norm: one block per row.  s = x + r (stored), then
//   s * rsqrt(mean(s^2) + eps) * scale; without r the plain norm of x.
// * qk_norm_rope_write: one warp per (row, head task), a task being one of
//   the H query heads (norm, rotation, written to q_out), the Hkv key heads
//   (norm, rotation, stored into the pages) or the Hkv value heads (stored
//   as they are).  The rotate-half RoPE pairs element j with j + D/2, so a
//   lane holds both.  The row's target is (wr_page[row], wr_slot[row]); a
//   negative page writes nothing, so padding rows and lanes leave every
//   page byte as it was.
// * silu_mul: a grid-stride pass, silu(gate) * up.

#include <cstdint>

#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;
using repro::warp_sum;

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

constexpr int kMaxPacks = 8;     // packs a thread of add_rms_norm holds
constexpr int kMaxHalfIters = 4; // D / 2 / 32: head dims up to 256

// ---------------------------------------------------------- add + RMSNorm

template <typename T, int VEC>
__global__ void add_rms_norm_kernel(const T* __restrict__ x,
                                    const T* __restrict__ r,
                                    const T* __restrict__ scale,
                                    T* __restrict__ sum_out,
                                    T* __restrict__ out, int d, float eps) {
  using P = Pack<T, VEC>;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  const int n_pack = d / VEC;
  const P* xp = reinterpret_cast<const P*>(x + base);
  const P* rp = r ? reinterpret_cast<const P*>(r + base) : nullptr;
  P* sp = r ? reinterpret_cast<P*>(sum_out + base) : nullptr;
  P held[kMaxPacks];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPacks; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_pack) {
      P a = xp[i];
      if (rp) {
        const P b = rp[i];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          a.v[e] = from_float<T>(to_float(a.v[e]) + to_float(b.v[e]));
        sp[i] = a;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_float(a.v[e]);
        ss += f * f;
      }
      held[k] = a;
    }
  }
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
    ss = warp_sum(ss);
    if (lane == 0) red[0] = ss;
  }
  __syncthreads();
  const float inv = rsqrtf(red[0] / static_cast<float>(d) + eps);
  const P* gp = reinterpret_cast<const P*>(scale);
  P* op = reinterpret_cast<P*>(out + base);
#pragma unroll
  for (int k = 0; k < kMaxPacks; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_pack) {
      const P g = gp[i];
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = from_float<T>(__fmul_rn(
            __fmul_rn(to_float(held[k].v[e]), inv), to_float(g.v[e])));
      op[i] = o;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_add_rms_norm(const void* x, const void* r,
                                const void* scale, void* sum_out, void* out,
                                int rows, int d, float eps, cudaStream_t s) {
  const int n_pack = d / VEC;
  int threads = ((n_pack + 3) / 4 + 31) / 32 * 32;   // about 4 packs each
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  if ((n_pack + threads - 1) / threads > kMaxPacks)
    return cudaErrorInvalidValue;
  add_rms_norm_kernel<T, VEC><<<rows, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(scale), static_cast<T*>(sum_out),
      static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t add_rms_norm_dispatch(const void* x, const void* r,
                                  const void* scale, void* sum_out, void* out,
                                  int rows, int d, float eps,
                                  cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                   reinterpret_cast<uintptr_t>(scale) |
                   reinterpret_cast<uintptr_t>(out);
  if (r)
    bits |= reinterpret_cast<uintptr_t>(r) |
            reinterpret_cast<uintptr_t>(sum_out);
  if (d % kVec == 0 && bits % 16 == 0)
    return launch_add_rms_norm<T, kVec>(x, r, scale, sum_out, out, rows, d,
                                        eps, s);
  return launch_add_rms_norm<T, 1>(x, r, scale, sum_out, out, rows, d, eps,
                                   s);
}

// --------------------------------------- q/k RMSNorm + RoPE + K/V write

template <typename T>
__global__ void qk_norm_rope_write_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ q_scale, const T* __restrict__ k_scale,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    T* __restrict__ k_pages, T* __restrict__ v_pages,
    const int64_t* __restrict__ wr_page, const int64_t* __restrict__ wr_slot,
    T* __restrict__ q_out, int H, int Hkv, int D, int page_size, float eps) {
  const int row = blockIdx.x;
  const int task = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (task >= H + 2 * Hkv) return;
  const T* src;
  T* dst;
  const T* scale;
  bool rope = true;
  if (task < H) {
    src = q + (static_cast<int64_t>(row) * H + task) * D;
    dst = q_out + (static_cast<int64_t>(row) * H + task) * D;
    scale = q_scale;
  } else {
    const int64_t page = wr_page[row];
    if (page < 0) return;                  // padding: no page is touched
    const int head = task < H + Hkv ? task - H : task - H - Hkv;
    const int64_t at =
        ((page * page_size + wr_slot[row]) * Hkv + head) * D;
    const int64_t from = (static_cast<int64_t>(row) * Hkv + head) * D;
    if (task < H + Hkv) {
      src = k + from;
      dst = k_pages + at;
      scale = k_scale;
    } else {
      src = v + from;
      dst = v_pages + at;
      scale = nullptr;
      rope = false;
    }
  }
  const int half = D >> 1;
  float a[kMaxHalfIters], b[kMaxHalfIters];
  float ss = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxHalfIters; ++t) {
    const int j = lane + 32 * t;
    if (j < half) {
      a[t] = to_float(src[j]);
      b[t] = to_float(src[j + half]);
      ss += a[t] * a[t] + b[t] * b[t];
    }
  }
  if (scale) {
    const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(D) + eps);
#pragma unroll
    for (int t = 0; t < kMaxHalfIters; ++t) {
      const int j = lane + 32 * t;
      if (j < half) {
        a[t] = round_to<T>(
            __fmul_rn(__fmul_rn(a[t], inv), to_float(scale[j])));
        b[t] = round_to<T>(
            __fmul_rn(__fmul_rn(b[t], inv), to_float(scale[j + half])));
      }
    }
  }
  const float* cr = cos_t + static_cast<int64_t>(row) * half;
  const float* sr = sin_t + static_cast<int64_t>(row) * half;
#pragma unroll
  for (int t = 0; t < kMaxHalfIters; ++t) {
    const int j = lane + 32 * t;
    if (j < half) {
      float o1 = a[t], o2 = b[t];
      if (rope) {
        const float c = cr[j], sn = sr[j];
        o1 = __fsub_rn(__fmul_rn(a[t], c), __fmul_rn(b[t], sn));
        o2 = __fadd_rn(__fmul_rn(b[t], c), __fmul_rn(a[t], sn));
      }
      dst[j] = from_float<T>(o1);
      dst[j + half] = from_float<T>(o2);
    }
  }
}

constexpr int kTaskWarps = 4;

template <typename T>
cudaError_t launch_qk_norm_rope_write(
    const void* q, const void* k, const void* v, const void* q_scale,
    const void* k_scale, const void* cos_t, const void* sin_t, void* k_pages,
    void* v_pages, const void* wr_page, const void* wr_slot, void* q_out,
    int rows, int H, int Hkv, int D, int page_size, float eps,
    cudaStream_t s) {
  if (D % 2 || D / 2 > 32 * kMaxHalfIters) return cudaErrorInvalidValue;
  const dim3 grid(rows, (H + 2 * Hkv + kTaskWarps - 1) / kTaskWarps);
  qk_norm_rope_write_kernel<T><<<grid, 32 * kTaskWarps, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(q_scale),
      static_cast<const T*>(k_scale), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(k_pages),
      static_cast<T*>(v_pages), static_cast<const int64_t*>(wr_page),
      static_cast<const int64_t*>(wr_slot), static_cast<T*>(q_out), H, Hkv,
      D, page_size, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------------ SiLU * mul

template <typename T, int VEC>
__global__ void silu_mul_kernel(const T* __restrict__ gate,
                                const T* __restrict__ up, T* __restrict__ out,
                                int64_t n_pack) {
  using P = Pack<T, VEC>;
  const P* gp = reinterpret_cast<const P*>(gate);
  const P* up_p = reinterpret_cast<const P*>(up);
  P* op = reinterpret_cast<P*>(out);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n_pack; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const P g = gp[i], u = up_p[i];
    P o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float x = to_float(g.v[e]);
      const float act = round_to<T>(x / (1.0f + expf(-x)));
      o.v[e] = from_float<T>(__fmul_rn(act, to_float(u.v[e])));
    }
    op[i] = o;
  }
}

template <typename T, int VEC>
cudaError_t launch_silu_mul(const void* gate, const void* up, void* out,
                            int64_t n, cudaStream_t s) {
  const int64_t n_pack = n / VEC;
  constexpr int kThreads = 256;
  int64_t blocks = (n_pack + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  silu_mul_kernel<T, VEC><<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(gate), static_cast<const T*>(up),
      static_cast<T*>(out), n_pack);
  return cudaGetLastError();
}

template <typename T>
cudaError_t silu_mul_dispatch(const void* gate, const void* up, void* out,
                              int64_t n, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(gate) |
                         reinterpret_cast<uintptr_t>(up) |
                         reinterpret_cast<uintptr_t>(out);
  if (n % kVec == 0 && bits % 16 == 0)
    return launch_silu_mul<T, kVec>(gate, up, out, n, s);
  return launch_silu_mul<T, 1>(gate, up, out, n, s);
}

}  // namespace

// x, r (rows, d) (r may be null: the plain norm), scale (d,); writes
// sum_out = x + r (unless r is null) and out = rmsnorm(sum) * scale.
// dtype 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int add_rms_norm_launch(const void* x, const void* r,
                                   const void* scale, void* sum_out,
                                   void* out, int rows, int d, float eps,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 1) return static_cast<int>(cudaSuccess);
  if (dtype == 0)
    return add_rms_norm_dispatch<float>(x, r, scale, sum_out, out, rows, d,
                                        eps, s);
  if (dtype == 1)
    return add_rms_norm_dispatch<__nv_bfloat16>(x, r, scale, sum_out, out,
                                                rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q (rows, H, D), k / v (rows, Hkv, D), q_scale / k_scale (D,) or both
// null (no q/k norm), cos / sin (rows, D / 2) float32, k_pages / v_pages
// (P, page_size, Hkv, D) of one layer, wr_page / wr_slot (rows,) int64 (a
// negative page writes nothing); writes q_out (rows, H, D).
extern "C" int qk_norm_rope_write_launch(
    const void* q, const void* k, const void* v, const void* q_scale,
    const void* k_scale, const void* cos_t, const void* sin_t, void* k_pages,
    void* v_pages, const void* wr_page, const void* wr_slot, void* q_out,
    int rows, int H, int Hkv, int D, int page_size, float eps, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1) return static_cast<int>(cudaSuccess);
  if (dtype == 0)
    return launch_qk_norm_rope_write<float>(
        q, k, v, q_scale, k_scale, cos_t, sin_t, k_pages, v_pages, wr_page,
        wr_slot, q_out, rows, H, Hkv, D, page_size, eps, s);
  if (dtype == 1)
    return launch_qk_norm_rope_write<__nv_bfloat16>(
        q, k, v, q_scale, k_scale, cos_t, sin_t, k_pages, v_pages, wr_page,
        wr_slot, q_out, rows, H, Hkv, D, page_size, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// gate, up, out: n elements each; out = silu(gate) * up.
extern "C" int silu_mul_launch(const void* gate, const void* up, void* out,
                               long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return static_cast<int>(cudaSuccess);
  if (dtype == 0) return silu_mul_dispatch<float>(gate, up, out, n, s);
  if (dtype == 1)
    return silu_mul_dispatch<__nv_bfloat16>(gate, up, out, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
