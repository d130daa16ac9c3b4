// Dense attention forward (flash attention) for Hopper.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention (+ _flash_kernel).
//
// What it computes: q (B, Sq, H, D), k/v (B, Sk, Hkv, D) -> out (B, Sq, H, D)
// in q's dtype; softmax(q k^T / sqrt(D)) v with an fp32 online softmax, the
// scale applied to q in fp32 (as the TPU kernel).  GQA: query head h reads kv
// head h / (H / Hkv), so K/V are never copied per head.  With `causal` the
// mask is aligned top-left (query i sees keys 0..i, the TPU kernel's
// convention); the wrapper admits causal calls with Sq == Sk only.
//
// Grid: one block per (tile of kBlockQ query rows, head, batch).  The TPU grid
// carried (m, l, acc) in VMEM across a sequential kv axis; here the kv walk is
// a loop inside the block, over tiles of kBlockK keys, and with `causal` it
// stops at the diagonal tile, so fully masked tiles cost nothing.  Tiles are
// issued heaviest first (the last query tiles walk the most keys).  Ragged
// tails of Sq and Sk are masked, so no length needs to divide a tile.
//
// Each of the 256 threads owns 4 query rows x 4 keys of the score tile (rows
// 4 * (tid / 16) .., keys tid % 16 + 16 j) and the same 4 rows x D / 16
// columns of the output, so the row statistics (m, l) of a thread's rows live
// in its registers and are reduced across the 16 threads of a row group with
// shuffles.
//
// What bounds it on H100: at the models' shapes (S ~ 1000, D = 64) the causal
// product is ~2 * B * H * S^2 * D operations against a few MB of q, k, v, so
// operations bound it.  This first version does QK^T and PV as fp32 FMAs from
// shared memory; wgmma for both products and TMA-fed K/V tiles are later work.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kLdp = kBlockK + 4;   // score-tile stride: the two row groups
                                    // of a warp land on different banks
constexpr int kMaxCols = 8;         // D / 16 output columns a thread, D <= 128

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int Hkv, int D, int causal,
                       float scale) {
  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int row0 = (tid >> 4) * 4;  // this thread's 4 rows of the tile
  const int tc = tid & 15;          // its key / column lane
  const int ldq = D + 1;
  const int n_cols = (D + 15) / 16;

  extern __shared__ float smem[];
  float* q_s = smem;                  // kBlockQ * (D + 1), pre-scaled
  float* k_s = q_s + kBlockQ * ldq;   // kBlockK * (D + 1)
  float* v_s = k_s + kBlockK * ldq;   // kBlockK * D
  float* p_s = v_s + kBlockK * D;     // kBlockQ * kLdp

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    q_s[r * ldq + d] =
        qi < Sq ? repro::to_float(q[(((size_t)b * Sq + qi) * H + h) * D + d]) *
                      scale
                : 0.f;
  }

  float m[4], l[4], acc[4][kMaxCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done (and q_s is in)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      const int kj = k0 + t;
      const size_t off = (((size_t)b * Sk + kj) * Hkv + hk) * D + d;
      k_s[t * ldq + d] = kj < Sk ? repro::to_float(k[off]) : 0.f;
      v_s[t * D + d] = kj < Sk ? repro::to_float(v[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(row0 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tc + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; a masked score weighs exactly 0, and a row with no
    // visible key in this tile keeps its state (corr = 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + row0 + i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tc + 16 * j;
        valid[j] = kj < Sk && (!causal || kj <= qi);
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(row0 + i) * kLdp + tc + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    const int n_keys = min(kBlockK, Sk - k0);
    for (int t = 0; t < n_keys; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(row0 + i) * kLdp + t];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < n_cols) {
          const int col = min(tc + 16 * c, D - 1);
          const float vv = v_s[t * D + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = tc + 16 * c;
      if (c < n_cols && col < D)
        out[(((size_t)b * Sq + qi) * H + h) * D + col] =
            repro::from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, int D, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBlockQ * (D + 1) +
                                       (size_t)kBlockK * (D + 1) +
                                       (size_t)kBlockK * D +
                                       (size_t)kBlockQ * kLdp);
  cudaError_t err = repro::allow_smem(flash_attention_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, Hkv, D,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int Hkv, int D,
                                      int causal, float scale, int dtype,
                                      void* stream) {
  if (D < 1 || D > 16 * kMaxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal, scale,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
