// Paged-attention decode for Hopper: split-K flash decoding over a paged
// KV pool.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention
// (+ _paged_kernel, and the max/sum combine after its pallas_call).
//
// What it computes: one query token per batch row, q (B, H, D), attends over
// the row's pages of the pool (P, page, Hkv, D) through block_tables
// (B, n_pages), up to context_lens[b] keys.  All G = H / Hkv query heads of
// one kv head form one (G, D) tile.  The page walk is divided into
// num_splits ranges; each split writes an unnormalised fp32 (acc, m, l)
// partial, and a second kernel rescales and sums the partials.  Rows with
// occupancy 0 or context 0 write dead partials (m = -1e30, l = 0, acc = 0),
// so their output is exactly 0, never NaN; pages past the context are never
// read.
//
// What bounds it on H100: bytes.  Decode reads every live key and value
// once (B = 8, ctx = 1024, Hkv = 4, D = 64 in bf16 is about 8.4 MB, about
// 2.5 us at 3.35 TB/s) and does 4 * G * D flops per 4 * D bytes of bf16 K/V
// (8 flops/byte at G = 8), far below the ~295 flops/byte at which the
// tensor cores would bind.  The design
// therefore spends its effort on parallelism over the bytes, not on the
// products: one block per (row, kv head, split) so B * Hkv * splits blocks
// cover the 132 SMs even at B * Hkv = 32; K/V rows of a 64-key tile (eight
// 8-row pages) are gathered through the block table with coalesced row
// reads into shared memory, and each row is read by one block only.  The
// products are fp32 FMAs on CUDA cores (G = 8 query heads reuse each loaded
// key).  Vectorised loads, cp.async/TMA pipelining and wgmma are later work.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kThreads = 128;
constexpr int kTileKeys = 64;  // keys per iteration (eight pages of 8)
constexpr int kCombineMaxSplits = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_partial_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ block_tables,
                     const int* __restrict__ context_lens,
                     const unsigned char* __restrict__ occupancy,
                     float* __restrict__ acc_out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int B, int Hkv, int G, int D,
                     int page_size, int n_pages, int pages_per_split,
                     float scale) {
  const int b = blockIdx.x, hk = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int ldk = D + 1;  // padded K rows: conflict-free column reads

  extern __shared__ float smem[];
  float* q_s = smem;                      // G * D, pre-scaled
  float* k_s = q_s + G * D;               // kTileKeys * (D + 1)
  float* v_s = k_s + kTileKeys * ldk;     // kTileKeys * D
  float* p_s = v_s + kTileKeys * D;       // G * kTileKeys scores / probs
  float* acc_s = p_s + G * kTileKeys;     // G * D
  float* m_s = acc_s + G * D;             // G
  float* l_s = m_s + G;                   // G
  float* corr_s = l_s + G;                // G

  // this split's key range, cut at the context end (dead rows: empty)
  const int ctx = occupancy[b] ? context_lens[b] : 0;
  const int key_lo = sp * pages_per_split * page_size;
  const int key_hi =
      min(min((sp + 1) * pages_per_split, n_pages) * page_size, ctx);

  const T* q_row = q + ((size_t)b * Hkv + hk) * G * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    q_s[i] = repro::to_float(q_row[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const size_t page_stride = (size_t)page_size * Hkv * D;
  const size_t slot_stride = (size_t)Hkv * D;
  const int* bt_row = block_tables + (size_t)b * n_pages;

  for (int t0 = key_lo; t0 < key_hi; t0 += kTileKeys) {
    const int n_keys = min(kTileKeys, key_hi - t0);
    // gather the tile's K/V rows through the block table
    for (int i = tid; i < n_keys * D; i += blockDim.x) {
      const int t = i / D, d = i - t * D;
      const int pos = t0 + t;
      const size_t off = (size_t)bt_row[pos / page_size] * page_stride +
                         (size_t)(pos % page_size) * slot_stride +
                         (size_t)hk * D + d;
      k_s[t * ldk + d] = repro::to_float(k_pages[off]);
      v_s[t * D + d] = repro::to_float(v_pages[off]);
    }
    __syncthreads();
    // scores s[g, t] = q_g . k_t
    for (int i = tid; i < G * kTileKeys; i += blockDim.x) {
      const int g = i / kTileKeys, t = i - g * kTileKeys;
      float s = kNegInf;
      if (t < n_keys) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + t * ldk;
        s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      }
      p_s[i] = s;
    }
    __syncthreads();
    // fp32 online softmax, one warp per query head
    for (int g = warp; g < G; g += n_warps) {
      float* row = p_s + g * kTileKeys;
      float mx = kNegInf;
      for (int t = lane; t < n_keys; t += 32) mx = fmaxf(mx, row[t]);
      mx = repro::warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kTileKeys; t += 32) {
        const float p = t < n_keys ? expf(row[t] - m_new) : 0.f;
        row[t] = p;
        sum += p;
      }
      sum = repro::warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p @ V
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i - g * D;
      const float* pr = p_s + g * kTileKeys;
      float a = acc_s[i] * corr_s[g];
      for (int t = 0; t < n_keys; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  // partials laid out (split, B, Hkv, G[, D])
  const size_t part = ((size_t)sp * B + b) * Hkv + hk;
  for (int i = tid; i < G * D; i += blockDim.x)
    acc_out[part * G * D + i] = acc_s[i];
  for (int g = tid; g < G; g += blockDim.x) {
    m_out[part * G + g] = m_s[g];
    l_out[part * G + g] = l_s[g];
  }
}

// Flash-decoding combine, exactly paged_attention.py's max/sum reduce:
// dead splits (m = -1e30) weigh 0, and a row with every split dead divides
// 0 by 1e-30 and comes out exactly 0.
template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ acc,
                                     const float* __restrict__ m,
                                     const float* __restrict__ l,
                                     T* __restrict__ out, int n_splits,
                                     int n_rows, int D) {
  __shared__ float w_s[kCombineMaxSplits];
  __shared__ float denom_s;
  const int r = blockIdx.x;  // row of (B, H) == (B, Hkv, G)
  if (threadIdx.x == 0) {
    float m_max = kNegInf;
    for (int s = 0; s < n_splits; ++s)
      m_max = fmaxf(m_max, m[(size_t)s * n_rows + r]);
    const float m_ref = fmaxf(m_max, kNegInf * 0.5f);
    float l_tot = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float ms = m[(size_t)s * n_rows + r];
      const float w = ms > kNegInf * 0.5f ? expf(ms - m_ref) : 0.f;
      w_s[s] = w;
      l_tot += l[(size_t)s * n_rows + r] * w;
    }
    denom_s = fmaxf(l_tot, 1e-30f);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < n_splits; ++s)
      num += acc[((size_t)s * n_rows + r) * D + d] * w_s[s];
    out[(size_t)r * D + d] = repro::from_float<T>(num / denom_s);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* context_lens,
           const void* occupancy, void* acc, void* m, void* l, void* out,
           int B, int Hkv, int G, int D, int page_size, int n_pages,
           int num_splits, int pages_per_split, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)kTileKeys * (D + 1) +
                       (size_t)kTileKeys * D + (size_t)G * kTileKeys +
                       (size_t)G * D + 3 * (size_t)G);
  cudaError_t err = repro::allow_smem(paged_partial_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, Hkv, num_splits);
  paged_partial_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens),
      static_cast<const unsigned char*>(occupancy), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), B, Hkv, G, D,
      page_size, n_pages, pages_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rows = B * Hkv * G;
  const int threads = D >= 128 ? 128 : (D + 31) / 32 * 32;
  paged_combine_kernel<T><<<n_rows, threads, 0, stream>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<T*>(out), num_splits, n_rows,
      D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, const void* occupancy,
    void* acc, void* m, void* l, void* out, int B, int Hkv, int G, int D,
    int page_size, int n_pages, int num_splits, int pages_per_split,
    float scale, int dtype, void* stream) {
  if (num_splits < 1 || num_splits > kCombineMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_tables, context_lens,
                         occupancy, acc, m, l, out, B, Hkv, G, D, page_size,
                         n_pages, num_splits, pages_per_split, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                 context_lens, occupancy, acc, m, l, out, B,
                                 Hkv, G, D, page_size, n_pages, num_splits,
                                 pages_per_split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
