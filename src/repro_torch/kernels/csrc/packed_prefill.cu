// Packed multi-prompt prefill attention for Hopper: two variants.
//
// Replaces the TPU kernel
// repro/kernels/packed_prefill.py::packed_prefill_attention (+ _packed_kernel).
//
// What it computes: C query lanes q (C, H, D), each tagged with a segment id
// (-1 = padding) and an absolute position.  A lane attends only to the keys
// of its own segment's page run (page_rows[seg], through the pool
// (P, page, Hkv, D)), causally up to its own position: the
// segment-indicator mask seg == si and key_pos <= pos.  Pages at or past
// seg_ctx[seg] are never read; segments may share physical pages.  Padding
// lanes, and any lane with nothing visible, come out exactly 0.
//
// What bounds it on H100: at the engine's chunk (C = 264 lanes, H = 32,
// Hkv = 4, D = 64, a few hundred to a thousand keys per segment) the whole
// call is ~0.4 GFLOP over ~6 MB, so the bound is bytes (~0.002 ms); what
// sets the time is latency and the schedule: how long the longest chain of
// dependent key tiles is, and how many SMs have work.  The TPU grid walked
// (kv head, segment, page) with all C lanes scoring against every
// segment's pages; here no block walks more than one segment's keys.
//
// * packed_prefill_tc_launch -- bf16 with D = 64 or 128 and G = H / Hkv
//   <= 64.  Three kernels.  (1) A one-block planner turns seg_ids,
//   positions, seg_ctx and the page count into work items (lane block,
//   segment, key range): a lane block is lanes = 64 / G lanes, so its
//   lanes x G query rows of one kv head fill one 64-row warpgroup tile,
//   and a key range is at most item_keys keys, so the critical path no
//   longer grows with a rider's context.  The planner runs on the device:
//   no host sync, and the grid of (2) is fixed from the shapes alone.
//   (2) Blocks of one warpgroup walk the (item, kv head) pairs: K/V rows
//   are gathered through the page row with cp.async (16 bytes a thread,
//   two buffers, written in the 128-byte-swizzled layout), QK^T and PV are
//   wgmma m64n64k16 as in the flash kernel (attn_tc.cuh), and each item
//   writes an unnormalised fp32 (acc, m, l) partial for the rows of its
//   segment.  wgmma rather than mma.sync: with lanes = 64 / G the gathered
//   tile always has 64 rows, the rows of other segments are masked.
//   (3) A combine kernel merges each row's partials, as the split-K
//   combine of paged_attention.cu; a row with no partial (padding, or
//   nothing visible) is written as exactly 0, never NaN.
// * packed_prefill_tf32x3_launch -- fp32 with D = 64 or 128 and G <= 64:
//   the same planner, work items and combine kernel; only the partial
//   kernel's products change.  Its 4 warps own 16 rows each of the 64-row
//   tile; K/V rows are gathered through the page row by 16-byte cp.async
//   into two buffers of row-major fp32 at a padded stride, and QK^T and PV
//   run on mma.sync m16n8k8 TF32 with every operand split in two TF32
//   numbers (3xTF32, tf32x3.cuh): fp32's accuracy at the TF32 rate.  A
//   warp none of whose rows belongs to the item's segment skips it.
// * packed_prefill_launch -- every other call (fp32 or bf16 with any other
//   D): the first version.  One block per (kv head, block of 16 lanes)
//   walks the segments that own one of its lanes, one after another, each
//   only up to min(seg_ctx, furthest position + 1), with its products as
//   fp32 FMAs from shared memory.
#include "attn_tc.cuh"
#include "common.cuh"
#include "tf32x3.cuh"

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

// ------------------------------------------------- tensor-core variant

namespace tcp {

using namespace repro::tc;
using repro::tc::kThreads;  // hides the FMA variant's 256

// One key range of one segment's keys seen from one lane block:
// {lane block, segment, range index, key_end of (block, segment)}.
// Range r covers keys [r * item_keys, min((r + 1) * item_keys, key_end)).

// Key end of segment s's live pages (pages at or past seg_ctx are never
// read).
__device__ __forceinline__ int live_keys(const int* seg_ctx, int s,
                                         int page_size, int n_pages) {
  return min((seg_ctx[s] + page_size - 1) / page_size, n_pages) * page_size;
}

__global__ void plan_kernel(const int* __restrict__ seg_ids,
                            const int* __restrict__ positions,
                            const int* __restrict__ seg_ctx,
                            int4* __restrict__ items, int* __restrict__ count,
                            int C, int lanes, int n_lb, int n_segs,
                            int n_pages, int page_size, int item_keys) {
  __shared__ int n;
  if (threadIdx.x == 0) n = 0;
  __syncthreads();
  for (int lb = threadIdx.x; lb < n_lb; lb += blockDim.x) {
    const int c0 = lb * lanes, c1 = min(C, c0 + lanes);
    for (int c = c0; c < c1; ++c) {
      const int s = seg_ids[c];
      if (s < 0 || s >= n_segs) continue;
      bool first = true;  // the first lane of segment s in this block
      for (int i = c0; i < c && first; ++i) first = seg_ids[i] != s;
      if (!first) continue;
      int max_pos = -1;
      for (int i = c; i < c1; ++i)
        if (seg_ids[i] == s) max_pos = max(max_pos, positions[i]);
      const int key_end =
          min(live_keys(seg_ctx, s, page_size, n_pages), max_pos + 1);
      const int n_ranges = (key_end + item_keys - 1) / item_keys;
      if (n_ranges <= 0) continue;
      const int at = atomicAdd(&n, n_ranges);
      for (int r = 0; r < n_ranges; ++r)
        items[at + r] = make_int4(lb, s, r, key_end);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) *count = n;
}

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return kRows * D * 2;
}

// Q, then two K and two V buffers, from a 1024-byte-aligned base.
template <int D>
constexpr size_t smem_bytes() {
  return 5 * tile_bytes<D>() + 1024;
}

// Partial slot of (kv head, lane block, range): 64 rows of D fp32 (acc)
// and of (m, l).
__device__ __forceinline__ size_t slot(int hk, int lb, int r, int n_lb,
                                       int max_ranges) {
  return ((size_t)hk * n_lb + lb) * max_ranges + r;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k_pages,
               const __nv_bfloat16* __restrict__ v_pages,
               const int* __restrict__ page_rows,
               const int* __restrict__ seg_ids,
               const int* __restrict__ positions,
               const int4* __restrict__ items, const int* __restrict__ count,
               float* __restrict__ acc_part, float2* __restrict__ ml_part,
               int C, int Hkv, int G, int page_size, int n_pages, int lanes,
               int n_lb, int max_ranges, int item_keys, float scale_log2) {
  constexpr uint32_t kTile = tile_bytes<D>();
  constexpr int kChunks = D / 8;  // 16-byte chunks of one row
  const int H = Hkv * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + kTile, v_s = base + 3 * kTile;
  const size_t slot_stride = (size_t)Hkv * D;
  const size_t page_stride = (size_t)page_size * slot_stride;
  const int n_work = *count * Hkv;

  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int4 it = items[w / Hkv];
    const int hk = w % Hkv, lb = it.x, s = it.y, r = it.z;
    const int key_lo = r * item_keys;
    const int key_hi = min(key_lo + item_keys, it.w);
    const int* row_pages = page_rows + (size_t)s * n_pages;

    // this thread's two rows: lane tag and position, live only if the
    // row's lane belongs to segment s
    bool live[2];
    int pos[2], row[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      row[half] = 16 * warp + (lane >> 2) + 8 * half;
      const int c = lb * lanes + row[half] / G;
      live[half] = row[half] < lanes * G && c < C && seg_ids[c] == s;
      pos[half] = live[half] ? positions[c] : -1;
    }

    __syncthreads();  // the previous item's readers of Q and K/V are done
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
      const int rr = i / kChunks, col = (i % kChunks) * 8;
      const int c = lb * lanes + rr / G;
      const bool ok = rr < lanes * G && c < C;
      const __nv_bfloat16* src =
          ok ? q + ((size_t)c * H + (size_t)hk * G + rr % G) * D + col : q;
      cp_async16(q_s + sw128_offset(kRows, rr, col), src, ok);
    }
    auto load_kv = [=](int k0, int buf) {
      for (int i = tid; i < kKeys * kChunks; i += kThreads) {
        const int t = i / kChunks, col = (i % kChunks) * 8;
        const int kp = k0 + t;
        const bool ok = kp < key_hi;
        const size_t off =
            ok ? (size_t)row_pages[kp / page_size] * page_stride +
                     (size_t)(kp % page_size) * slot_stride +
                     (size_t)hk * D + col
               : 0;
        const uint32_t dst = sw128_offset(kKeys, t, col) + buf * kTile;
        cp_async16(k_s + dst, k_pages + off, ok);
        cp_async16(v_s + dst, v_pages + off, ok);
      }
    };
    load_kv(key_lo, 0);
    cp_async_commit();

    float o[D / 64][32];
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
    OnlineSoftmax sm;
    sm.init();
    const int col0 = 2 * (lane & 3);
    const int n_tiles = (key_hi - key_lo + kKeys - 1) / kKeys;
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t & 1;
      if (t + 1 < n_tiles) {
        load_kv(key_lo + (t + 1) * kKeys, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      fence_proxy_async();  // cp.async writes -> wgmma's async-proxy reads
      __syncthreads();
      float sc[32];
      scores<D>(sc, q_s, k_s + buf * kTile);
      const int k0 = key_lo + t * kKeys;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
        const int half = (i >> 1) & 1;
        sc[i] = key < key_hi && key <= pos[half] ? sc[i] * scale_log2
                                                 : -INFINITY;
      }
      float corr[2];
      sm.step(sc, corr);
      rescale<D>(o, corr);
      accumulate_pv<D>(o, sc, v_s + buf * kTile);
      __syncthreads();  // products on `buf` done before it is refilled
    }

    sm.finish();
    const size_t sl = slot(hk, lb, r, n_lb, max_ranges);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!live[half]) continue;
      const size_t at = sl * kRows + row[half];
      float* dst = acc_part + at * D + col0;
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(dst + cb * 64 + 8 * j) =
              make_float2(o[cb][4 * j + 2 * half],
                          o[cb][4 * j + 2 * half + 1]);
      if ((lane & 3) == 0) ml_part[at] = make_float2(sm.m[half], sm.l[half]);
    }
  }
}

// The 3xTF32 partial kernel (fp32): partial_kernel's walk over the
// (item, kv head) pairs with fp32 tiles and the products of tf32x3.cuh.
// Q, then two K buffers of 64 rows at stride ld_qk(D), then two V buffers
// at stride ld_v(D).
template <int D>
constexpr size_t tf32_smem_bytes() {
  return sizeof(float) * kRows *
         (3 * repro::tf32::ld_qk(D) + 2 * repro::tf32::ld_v(D));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
partial_tf32x3_kernel(const float* __restrict__ q,
                      const float* __restrict__ k_pages,
                      const float* __restrict__ v_pages,
                      const int* __restrict__ page_rows,
                      const int* __restrict__ seg_ids,
                      const int* __restrict__ positions,
                      const int4* __restrict__ items,
                      const int* __restrict__ count,
                      float* __restrict__ acc_part,
                      float2* __restrict__ ml_part, int C, int Hkv, int G,
                      int page_size, int n_pages, int lanes, int n_lb,
                      int max_ranges, int item_keys, float scale_log2) {
  constexpr int ld = repro::tf32::ld_qk(D), ldv = repro::tf32::ld_v(D);
  constexpr int kChunks = D / 4;  // 16-byte chunks of one row
  const int H = Hkv * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ float4 smem_tf[];
  float* q_s = reinterpret_cast<float*>(smem_tf);
  float* k_s = q_s + kRows * ld;       // + buf * kKeys * ld
  float* v_s = k_s + 2 * kKeys * ld;   // + buf * kKeys * ldv
  const size_t slot_stride = (size_t)Hkv * D;
  const size_t page_stride = (size_t)page_size * slot_stride;
  const int n_work = *count * Hkv;

  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int4 it = items[w / Hkv];
    const int hk = w % Hkv, lb = it.x, s = it.y, r = it.z;
    const int key_lo = r * item_keys;
    const int key_hi = min(key_lo + item_keys, it.w);
    const int* row_pages = page_rows + (size_t)s * n_pages;

    bool live[2];
    int pos[2], row[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      row[half] = 16 * warp + (lane >> 2) + 8 * half;
      const int c = lb * lanes + row[half] / G;
      live[half] = row[half] < lanes * G && c < C && seg_ids[c] == s;
      pos[half] = live[half] ? positions[c] : -1;
    }
    const bool warp_live = __any_sync(0xffffffffu, live[0] || live[1]);

    __syncthreads();  // the previous item's readers of Q and K/V are done
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
      const int rr = i / kChunks, col = (i % kChunks) * 4;
      const int c = lb * lanes + rr / G;
      const bool ok = rr < lanes * G && c < C;
      const float* src =
          ok ? q + ((size_t)c * H + (size_t)hk * G + rr % G) * D + col : q;
      cp_async16(smem_u32(q_s + rr * ld + col), src, ok);
    }
    auto load_kv = [&](int k0, int buf) {
      for (int i = tid; i < kKeys * kChunks; i += kThreads) {
        const int t = i / kChunks, col = (i % kChunks) * 4;
        const int kp = k0 + t;
        const bool ok = kp < key_hi;
        const size_t off =
            ok ? (size_t)row_pages[kp / page_size] * page_stride +
                     (size_t)(kp % page_size) * slot_stride +
                     (size_t)hk * D + col
               : 0;
        cp_async16(smem_u32(k_s + (buf * kKeys + t) * ld + col),
                   k_pages + off, ok);
        cp_async16(smem_u32(v_s + (buf * kKeys + t) * ldv + col),
                   v_pages + off, ok);
      }
    };
    load_kv(key_lo, 0);
    cp_async_commit();

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    OnlineSoftmax sm;
    sm.init();
    const int col0 = 2 * (lane & 3);
    const int n_tiles = (key_hi - key_lo + kKeys - 1) / kKeys;
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t & 1;
      if (t + 1 < n_tiles) {
        load_kv(key_lo + (t + 1) * kKeys, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (warp_live) {
        float sc[32];
        repro::tf32::scores<D, kKeys>(sc, q_s + 16 * warp * ld,
                                      k_s + buf * kKeys * ld, lane);
        const int k0 = key_lo + t * kKeys;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
          const int half = (i >> 1) & 1;
          sc[i] = key < key_hi && key <= pos[half] ? sc[i] * scale_log2
                                                   : -INFINITY;
        }
        float corr[2];
        sm.step(sc, corr);
        repro::tf32::rescale(o, corr);
        repro::tf32::accumulate_pv<D, kKeys>(o, sc, v_s + buf * kKeys * ldv,
                                             lane);
      }
      __syncthreads();  // products on `buf` done before it is refilled
    }

    sm.finish();
    const size_t sl = slot(hk, lb, r, n_lb, max_ranges);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!live[half]) continue;
      const size_t at = sl * kRows + row[half];
      float* dst = acc_part + at * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
      if ((lane & 3) == 0) ml_part[at] = make_float2(sm.m[half], sm.l[half]);
    }
  }
}

// One block per (lane, kv head): out = sum_r acc_r 2^(m_r - M) /
// sum_r l_r 2^(m_r - M) over the ranges r that hold a visible key of the
// lane; no such range (padding, nothing visible) -> exactly 0.
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ acc_part,
               const float2* __restrict__ ml_part,
               const int* __restrict__ seg_ids,
               const int* __restrict__ positions,
               const int* __restrict__ seg_ctx,
               T* __restrict__ out, int Hkv, int G,
               int page_size, int n_pages, int n_segs, int lanes, int n_lb,
               int max_ranges, int item_keys) {
  const int c = blockIdx.x, hk = blockIdx.y;
  const int s = seg_ids[c];
  int n = 0;
  if (s >= 0 && s < n_segs) {
    const int vis =
        min(live_keys(seg_ctx, s, page_size, n_pages), positions[c] + 1);
    n = vis > 0 ? (vis + item_keys - 1) / item_keys : 0;
  }
  const int lb = c / lanes, row0 = (c % lanes) * G;
  const size_t sl0 = slot(hk, lb, 0, n_lb, max_ranges);
  for (int i = threadIdx.x; i < G * D / 4; i += blockDim.x) {
    const int g = i / (D / 4), d4 = i % (D / 4);
    float4 res = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n > 0) {
      const size_t at0 = sl0 * kRows + row0 + g;
      float mx = -INFINITY;
      for (int r = 0; r < n; ++r) mx = fmaxf(mx, ml_part[at0 + r * kRows].x);
      float l = 0.f;
      for (int r = 0; r < n; ++r) {
        const size_t at = at0 + (size_t)r * kRows;
        const float2 ml = ml_part[at];
        const float w = fast_exp2(ml.x - mx);
        const float4 a = reinterpret_cast<const float4*>(acc_part + at * D)[d4];
        l += ml.y * w;
        res.x += a.x * w;
        res.y += a.y * w;
        res.z += a.z * w;
        res.w += a.w * w;
      }
      const float inv = 1.f / l;
      res.x *= inv;
      res.y *= inv;
      res.z *= inv;
      res.w *= inv;
    }
    store4(out + ((size_t)c * Hkv * G + (size_t)hk * G + g) * D + d4 * 4,
           res);
  }
}

// Planner, partial kernel (wgmma for bf16, 3xTF32 for fp32) and combine.
template <int D, typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_rows, const void* seg_ids, const void* positions,
           const void* seg_ctx, void* out, void* items, void* count,
           void* acc_part, void* ml_part, int C, int Hkv, int G,
           int page_size, int n_segs, int n_pages, int lanes, int item_keys,
           int max_ranges, int grid, float scale, cudaStream_t stream) {
  constexpr bool kFp32 = sizeof(T) == 4;
  const int n_lb = (C + lanes - 1) / lanes;
  const int* seg = static_cast<const int*>(seg_ids);
  const int* pos = static_cast<const int*>(positions);
  const int* ctx = static_cast<const int*>(seg_ctx);
  plan_kernel<<<1, 256, 0, stream>>>(seg, pos, ctx, static_cast<int4*>(items),
                                     static_cast<int*>(count), C, lanes, n_lb,
                                     n_segs, n_pages, page_size, item_keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kFp32) {
    constexpr size_t smem = tf32_smem_bytes<D>();
    err = repro::allow_smem(partial_tf32x3_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    partial_tf32x3_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages),
        static_cast<const int*>(page_rows), seg, pos,
        static_cast<const int4*>(items), static_cast<const int*>(count),
        static_cast<float*>(acc_part), static_cast<float2*>(ml_part), C, Hkv,
        G, page_size, n_pages, lanes, n_lb, max_ranges, item_keys,
        scale * kLog2e);
  } else {
    constexpr size_t smem = smem_bytes<D>();
    err = repro::allow_smem(partial_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    partial_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages),
        static_cast<const int*>(page_rows), seg, pos,
        static_cast<const int4*>(items), static_cast<const int*>(count),
        static_cast<float*>(acc_part), static_cast<float2*>(ml_part), C, Hkv,
        G, page_size, n_pages, lanes, n_lb, max_ranges, item_keys,
        scale * kLog2e);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<D, T><<<dim3(C, Hkv), kThreads, 0, stream>>>(
      static_cast<const float*>(acc_part),
      static_cast<const float2*>(ml_part), seg, pos, ctx,
      static_cast<T*>(out), Hkv, G, page_size, n_pages, n_segs, lanes, n_lb,
      max_ranges, item_keys);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k_pages, const void* v_pages,
             const void* page_rows, const void* seg_ids,
             const void* positions, const void* seg_ctx, void* out,
             void* items, void* count, void* acc_part, void* ml_part, int C,
             int Hkv, int G, int D, int page_size, int n_segs, int n_pages,
             int lanes, int item_keys, int max_ranges, int grid, float scale,
             cudaStream_t stream) {
  if (lanes < 1 || lanes * G > kRows || item_keys < 1 || grid < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch<64, T>(q, k_pages, v_pages, page_rows, seg_ids, positions,
                         seg_ctx, out, items, count, acc_part, ml_part, C,
                         Hkv, G, page_size, n_segs, n_pages, lanes, item_keys,
                         max_ranges, grid, scale, stream);
  if (D == 128)
    return launch<128, T>(q, k_pages, v_pages, page_rows, seg_ids, positions,
                          seg_ctx, out, items, count, acc_part, ml_part, C,
                          Hkv, G, page_size, n_segs, n_pages, lanes,
                          item_keys, max_ranges, grid, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tcp

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

// The tensor-core variants: bf16 (wgmma) and fp32 (3xTF32), D = 64 or
// 128, lanes * G <= 64 rows, every pointer 16-byte aligned (cp.async).
// Scratch from the caller: items (int4, at least n_lb * min(lanes, n_segs)
// * max_ranges), count (one int), acc_part (Hkv * n_lb * max_ranges * 64 *
// D floats), ml_part (Hkv * n_lb * max_ranges * 64 float2), where n_lb =
// ceil(C / lanes) and max_ranges = ceil(n_pages * page_size / item_keys).
// `grid` blocks walk the (item, kv head) pairs.  Returns
// cudaGetLastError().
#define REPRO_TC_LAUNCH(name, T)                                             \
  extern "C" int name(                                                      \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* page_rows, const void* seg_ids, const void* positions,    \
      const void* seg_ctx, void* out, void* items, void* count,             \
      void* acc_part, void* ml_part, int C, int Hkv, int G, int D,          \
      int page_size, int n_segs, int n_pages, int lanes, int item_keys,     \
      int max_ranges, int grid, float scale, void* stream) {                \
    return tcp::launch_d<T>(q, k_pages, v_pages, page_rows, seg_ids,        \
                            positions, seg_ctx, out, items, count, acc_part, \
                            ml_part, C, Hkv, G, D, page_size, n_segs,       \
                            n_pages, lanes, item_keys, max_ranges, grid,    \
                            scale, static_cast<cudaStream_t>(stream));      \
  }

REPRO_TC_LAUNCH(packed_prefill_tc_launch, __nv_bfloat16)
REPRO_TC_LAUNCH(packed_prefill_tf32x3_launch, float)

#undef REPRO_TC_LAUNCH
