// Packed multi-prompt prefill attention for Hopper.
//
// Replaces the TPU kernel
// repro/kernels/packed_prefill.py::packed_prefill_attention (+ _packed_kernel).
//
// What it computes: C query lanes q (C, H, D), each tagged with a segment id
// (-1 = padding) and an absolute position.  A lane attends only to the keys
// of its own segment's page run (page_rows[seg], through the pool
// (P, page, Hkv, D)), causally up to its own position.  Pages at or past
// seg_ctx[seg] are skipped.  Padding lanes, and any lane with nothing
// visible, come out exactly 0.
//
// Grid: one block per (kv head, block of kLanes lanes); the block holds
// kLanes * G query rows.  The TPU grid walked (kv head, segment, page) with
// ALL C lanes scoring against every segment's pages; here a block walks only
// the segments that own one of its lanes, and for each only the pages up to
// min(seg_ctx, furthest position among its lanes + 1), so the S-fold waste is
// gone.  Nothing assumes that segments are laid end to end.
//
// What bounds it on H100: at the engine's shapes (C = 264 lanes, G = 8,
// D = 64, a few hundred keys per segment) the work is C * H * keys * D * 4
// flops against (keys * Hkv * D * 2) K/V elements read once per lane block,
// so it sits between the two rooflines.  This first version computes the
// products as fp32 FMAs on CUDA cores from shared memory (fp32 online
// softmax, as the TPU kernel); moving QK^T and PV onto wgmma, and splitting
// the key walk so more than Hkv * ceil(C / kLanes) blocks fill the SMs, are
// later work.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kThreads = 256;
constexpr int kLanes = 16;     // query lanes per block
constexpr int kTileKeys = 32;  // keys per iteration (four pages of 8)

template <typename T>
__global__ void __launch_bounds__(kThreads)
packed_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages,
                      const int* __restrict__ page_rows,
                      const int* __restrict__ seg_ids,
                      const int* __restrict__ positions,
                      const int* __restrict__ seg_ctx, T* __restrict__ out,
                      int C, int Hkv, int G, int D, int page_size, int n_segs,
                      int n_pages, float scale) {
  const int hk = blockIdx.x;
  const int c0 = blockIdx.y * kLanes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int H = Hkv * G;
  const int R = kLanes * G;  // query rows of this block: r = lane * G + g
  const int ldk = D + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                     // R * D, pre-scaled
  float* acc_s = q_s + R * D;            // R * D
  float* k_s = acc_s + R * D;            // kTileKeys * (D + 1)
  float* v_s = k_s + kTileKeys * ldk;    // kTileKeys * D
  float* p_s = v_s + kTileKeys * D;      // R * kTileKeys
  float* m_s = p_s + R * kTileKeys;      // R
  float* l_s = m_s + R;                  // R
  float* corr_s = l_s + R;               // R
  int* seg_s = reinterpret_cast<int*>(corr_s + R);  // kLanes
  int* pos_s = seg_s + kLanes;                       // kLanes

  for (int j = tid; j < kLanes; j += blockDim.x) {
    const int c = c0 + j;
    seg_s[j] = c < C ? seg_ids[c] : -1;  // the ragged tail acts as padding
    pos_s[j] = c < C ? positions[c] : -1;
  }
  for (int i = tid; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int c = c0 + r / G, g = r % G;
    q_s[i] = c < C
        ? repro::to_float(q[((size_t)c * H + (size_t)hk * G + g) * D + d]) *
              scale
        : 0.f;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const size_t page_stride = (size_t)page_size * Hkv * D;
  const size_t slot_stride = (size_t)Hkv * D;

  for (int si = 0; si < n_segs; ++si) {
    // block-uniform: every thread reads the same shared lane tags
    int max_pos = -1;
    for (int j = 0; j < kLanes; ++j)
      if (seg_s[j] == si) max_pos = max(max_pos, pos_s[j]);
    if (max_pos < 0) continue;  // no lane of this segment here
    const int live_pages =
        min((seg_ctx[si] + page_size - 1) / page_size, n_pages);
    const int key_end = min(live_pages * page_size, max_pos + 1);
    const int* row = page_rows + (size_t)si * n_pages;

    for (int t0 = 0; t0 < key_end; t0 += kTileKeys) {
      const int n_keys = min(kTileKeys, key_end - t0);
      for (int i = tid; i < n_keys * D; i += blockDim.x) {
        const int t = i / D, d = i - t * D;
        const int kp = t0 + t;
        const size_t off = (size_t)row[kp / page_size] * page_stride +
                           (size_t)(kp % page_size) * slot_stride +
                           (size_t)hk * D + d;
        k_s[t * ldk + d] = repro::to_float(k_pages[off]);
        v_s[t * D + d] = repro::to_float(v_pages[off]);
      }
      __syncthreads();
      // scores under the segment-indicator causal mask
      for (int i = tid; i < R * kTileKeys; i += blockDim.x) {
        const int r = i / kTileKeys, t = i - r * kTileKeys;
        const int j = r / G, kp = t0 + t;
        float s = kNegInf;
        if (t < n_keys && seg_s[j] == si && kp <= pos_s[j]) {
          const float* qr = q_s + r * D;
          const float* kr = k_s + t * ldk;
          s = 0.f;
          for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        }
        p_s[i] = s;
      }
      __syncthreads();
      // fp32 online softmax, one warp per query row; masked scores weigh 0
      // and a row with nothing visible in this tile keeps its state
      for (int r = warp; r < R; r += n_warps) {
        if (seg_s[r / G] != si) continue;  // warp-uniform
        float* prow = p_s + r * kTileKeys;
        float mx = kNegInf;
        for (int t = lane; t < kTileKeys; t += 32) mx = fmaxf(mx, prow[t]);
        mx = repro::warp_max(mx);
        const float m_prev = m_s[r];
        const bool any = mx > kNegInf * 0.5f;
        const float m_new = any ? fmaxf(m_prev, mx) : m_prev;
        float sum = 0.f;
        for (int t = lane; t < kTileKeys; t += 32) {
          const float s = prow[t];
          const float p = s > kNegInf * 0.5f ? expf(s - m_new) : 0.f;
          prow[t] = p;
          sum += p;
        }
        sum = repro::warp_sum(sum);
        if (lane == 0) {
          const float corr = any ? expf(m_prev - m_new) : 1.f;
          corr_s[r] = corr;
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();
      // acc = acc * corr + p @ V for this segment's rows
      for (int i = tid; i < R * D; i += blockDim.x) {
        const int r = i / D, d = i - r * D;
        if (seg_s[r / G] != si) continue;
        const float* pr = p_s + r * kTileKeys;
        float a = acc_s[i] * corr_s[r];
        for (int t = 0; t < n_keys; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
        acc_s[i] = a;
      }
      __syncthreads();
    }
  }

  // untouched rows (padding) hold acc = 0, l = 0: the epsilon divide pins
  // them to exactly 0
  for (int i = tid; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int c = c0 + r / G, g = r % G;
    if (c < C)
      out[((size_t)c * H + (size_t)hk * G + g) * D + d] =
          repro::from_float<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_rows, const void* seg_ids, const void* positions,
           const void* seg_ctx, void* out, int C, int Hkv, int G, int D,
           int page_size, int n_segs, int n_pages, float scale,
           cudaStream_t stream) {
  const size_t R = (size_t)kLanes * G;
  const size_t smem =
      sizeof(float) * (2 * R * D + (size_t)kTileKeys * (D + 1) +
                       (size_t)kTileKeys * D + R * kTileKeys + 3 * R) +
      sizeof(int) * 2 * kLanes;
  cudaError_t err = repro::allow_smem(packed_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Hkv, (C + kLanes - 1) / kLanes);
  packed_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_rows),
      static_cast<const int*>(seg_ids), static_cast<const int*>(positions),
      static_cast<const int*>(seg_ctx), static_cast<T*>(out), C, Hkv, G, D,
      page_size, n_segs, n_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int packed_prefill_launch(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* page_rows,
                                     const void* seg_ids,
                                     const void* positions,
                                     const void* seg_ctx, void* out, int C,
                                     int Hkv, int G, int D, int page_size,
                                     int n_segs, int n_pages, float scale,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, page_rows, seg_ids, positions,
                         seg_ctx, out, C, Hkv, G, D, page_size, n_segs,
                         n_pages, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_rows, seg_ids,
                                 positions, seg_ctx, out, C, Hkv, G, D,
                                 page_size, n_segs, n_pages, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
