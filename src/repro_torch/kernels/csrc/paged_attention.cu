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
// num_splits ranges; each split makes an unnormalised fp32 (acc, m, l)
// partial, and the partials are rescaled and summed.  Rows with occupancy 0
// or context 0 have no live key in any split and come out exactly 0, never
// NaN; pages past the context are never read.
//
// What bounds it on H100: bytes, and at the decode step's size the latency
// of getting them.  Decode reads every live key and value once (the serving
// batch, B = 8 rows of up to 1024 keys, Hkv = 4, D = 64 in bf16, is about
// 3 MB, under 1 us at 3.35 TB/s) and does 4 G D flops per 4 D bytes of bf16
// K/V (8 flops/byte at G = 8), far below the ~295 flops/byte at which the
// tensor cores would bind.  3 MB is about what the card's memory system
// holds in flight at once, so the design issues every copy of a block
// before it computes on any, and keeps the host and launch overhead small.
//
// Two variants, chosen by the wrapper (kernels/paged_attention.py,
// kernel_variant):
//
// * "mma", bf16 with D = 64 or 128 and G <= 16 (every config that serves:
//   TinyLlama G = 8 D = 64, Qwen3 G = 4 D = 128, Llama-3 G = 16 D = 128).
//   One block of four warps per (split, row, kv head).  The split's
//   block-table entries are read once into shared memory, together with
//   the context length and the query rows.  Each warp owns
//   every fourth 16-key slice of the split and copies it itself, K and V
//   rows as 16-byte cp.async chunks (a slot's head row is D * 2 contiguous
//   bytes) into a private three-stage ring of bf16 tiles, so the next
//   slices are in flight while one is computed and the walk needs no block
//   barrier at all.  Products on the tensor cores with mma.sync m16n8k16:
//   the G query heads are the M rows (padded to 16: the products are a few
//   percent of the time at 8 flops/byte, and this orientation lets the
//   score fragment feed P V as its A operand in registers, with no
//   transpose), keys are N for Q K^T and K for P V (V through ldmatrix
//   .trans).  The online softmax stays in fp32 registers, in the log2
//   domain.  The four warps' states merge in shared memory into the
//   block's partial.  The splits of one (row, kv head), at most eight, run
//   as one thread-block cluster: each block stores its partial into block
//   0's shared memory (distributed shared memory), and after one cluster
//   barrier block 0 merges them and writes the row, so the merge costs no
//   global round trip, no scratch and no second launch (the dependent
//   round trips of a global merge, not the bytes, were most of a decode
//   call's time: a two-launch merge through global memory measured 2.1 us
//   slower on the device).
// * "fma", fp32 (not yet redesigned, ROADMAP B.1: the 3xTF32 split of
//   tf32x3.cuh keeps fp32's accuracy on the tensor cores, as the flash and
//   packed kernels' fp32 variants do) and bf16 at any other shape: the
//   first version, fp32 FMAs from shared memory and a second combine
//   kernel.

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma_tc.cuh"

namespace {

// ------------------------------------------------------------ "fma" variant

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

// ------------------------------------------------------------ "mma" variant

namespace paged_mma {

namespace cg = cooperative_groups;
namespace tc = repro::tc;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlice = 16;               // keys a warp computes at once
constexpr int kTile = kWarps * kSlice;   // keys of one round of the block
constexpr int kStages = 3;               // slices in flight per warp
constexpr int kMaxG = 16;                // query heads: the mma's M rows
constexpr int kMaxSplits = 8;            // blocks of a cluster (portable)

template <int D>
struct Cfg {
  static constexpr int kLd = D + 8;              // padded bf16 row
  static constexpr int kSliceElems = kSlice * kLd;
  static constexpr int kPerLane = kSlice * D / 8 / 32;  // 16-byte chunks
  static constexpr size_t kRingBytes =
      (size_t)kWarps * kStages * 2 * kSliceElems * sizeof(bf16);
  static constexpr size_t kQBytes = (size_t)kMaxG * kLd * sizeof(bf16);
  // after the walk, in the ring's place: the four warps' output tiles and
  // (m, l) pairs, and the merge's split weights and denominators
  static constexpr size_t kMergeBytes =
      sizeof(float) *
      ((size_t)kWarps * kMaxG * (D + 2) + 2 * kMaxSplits * kMaxG + kMaxG);
  static constexpr size_t kSmemFixed =
      (kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes) + kQBytes;
};

// Block 0 of a cluster receives every split's partial, (G x D) acc then
// (G x 2) (m, l), in shared memory that it touches only after the cluster
// barrier.
__host__ __device__ constexpr size_t recv_floats(int num_splits, int G,
                                                 int D) {
  return (size_t)num_splits * G * (D + 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                 const bf16* __restrict__ v_pages,
                 const int* __restrict__ block_tables,
                 const int* __restrict__ context_lens,
                 const unsigned char* __restrict__ occupancy,
                 bf16* __restrict__ out, int Hkv, int G, int page_size,
                 int n_pages, int num_splits, int pages_per_split,
                 float scale_log2) {
  using C = Cfg<D>;
  const int sp = blockIdx.x, b = blockIdx.y, hk = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t pair = (size_t)b * Hkv + hk;
  tc::cluster_arrive_relaxed();  // waited for before the first remote store

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* q_s = reinterpret_cast<bf16*>(smem + C::kSmemFixed - C::kQBytes);
  float* recv = reinterpret_cast<float*>(smem + C::kSmemFixed);
  int* bt_s = reinterpret_cast<int*>(recv + recv_floats(num_splits, G, D));

  // this split's keys [key_lo, key_lo + n_keys), cut at the context end
  const int cl = context_lens[b];
  const int ctx = occupancy[b] ? cl : 0;
  const int pg_lo = sp * pages_per_split;
  const int key_lo = pg_lo * page_size;
  const int key_hi =
      min(min(pg_lo + pages_per_split, n_pages) * page_size, ctx);
  const int n_keys = max(key_hi - key_lo, 0);

  // the G query rows (rows G..15 zero) and every block-table entry of the
  // split, loaded together with the context length (entries past it are
  // read but never followed)
  const bf16* q_row = q + pair * G * D;
  for (int i = tid; i < kMaxG * D / 8; i += kThreads) {
    const int r = i / (D / 8), c = i - r * (D / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < G) v = *reinterpret_cast<const uint4*>(q_row + r * D + c * 8);
    *reinterpret_cast<uint4*>(q_s + r * C::kLd + c * 8) = v;
  }
  const int n_bt = max(min(pages_per_split, n_pages - pg_lo), 0);
  const int* bt_row = block_tables + (size_t)b * n_pages + pg_lo;
  for (int i = tid; i < n_bt; i += kThreads) bt_s[i] = bt_row[i];
  __syncthreads();

  // this warp's slices: keys key_lo + 64 j + 16 warp + [0, 16)
  const int first = warp * kSlice;
  const int n_sl = n_keys > first ? (n_keys - first + kTile - 1) / kTile : 0;
  bf16* my_ring = ring + (size_t)warp * kStages * 2 * C::kSliceElems;
  const size_t slot_stride = (size_t)Hkv * D;
  const size_t page_stride = (size_t)page_size * slot_stride;
  const bf16* k_base = k_pages + (size_t)hk * D;
  const bf16* v_base = v_pages + (size_t)hk * D;

  auto issue = [&](int j) {
    if (j < n_sl) {
      const int t0 = j * kTile + first;
      bf16* ks = my_ring + (j % kStages) * 2 * C::kSliceElems;
      bf16* vs = ks + C::kSliceElems;
#pragma unroll
      for (int u = 0; u < C::kPerLane; ++u) {
        const int i = lane + 32 * u;
        const int r = i / (D / 8), c = i - r * (D / 8);
        const int t = t0 + r;
        const bool valid = t < n_keys;
        size_t off = 0;
        if (valid)
          off = (size_t)bt_s[t / page_size] * page_stride +
                (size_t)(t % page_size) * slot_stride + c * 8;
        tc::cp_async16(tc::smem_u32(ks + r * C::kLd + c * 8), k_base + off,
                       valid);
        tc::cp_async16(tc::smem_u32(vs + r * C::kLd + c * 8), v_base + off,
                       valid);
      }
    }
    tc::cp_async_commit();
  };

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    tc::ldmatrix_x4(qa[kk], tc::a_addr(q_s, C::kLd, 0, kk * 16, lane));

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int c0 = 2 * (lane & 3);

  for (int j = 0; j < n_sl; ++j) {
    tc::cp_async_wait<kStages - 2>();
    __syncwarp();
    issue(j + kStages - 1);
    const bf16* ks = my_ring + (j % kStages) * 2 * C::kSliceElems;
    const bf16* vs = ks + C::kSliceElems;

    // s (16 query rows x 16 keys) = Q K^T
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];
      tc::ldmatrix_x4(kb, tc::bn_addr(ks, C::kLd, 0, kk * 16, lane));
      tc::mma_bf16(s[0], qa[kk], kb[0], kb[1]);
      tc::mma_bf16(s[1], qa[kk], kb[2], kb[3]);
    }
    // scale into the log2 domain, mask keys past the split's end
    const int t0 = j * kTile + first;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[t][e] = t0 + 8 * t + c0 + (e & 1) < n_keys ? s[t][e] * scale_log2
                                                     : -INFINITY;
    // fp32 online softmax of this thread's two rows (r and r + 8)
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                       fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      corr[h] = tc::fast_exp2(m[h] - base);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[t][2 * h + e];
          x = tc::fast_exp2(x - base);
          sum += x;
        }
      l[h] = l[h] * corr[h] + sum;
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }
    // o += P V, P rounded to bf16 as the A operand
    const uint32_t pa[4] = {tc::pack_bf16(s[0][0], s[0][1]),
                            tc::pack_bf16(s[0][2], s[0][3]),
                            tc::pack_bf16(s[1][0], s[1][1]),
                            tc::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t vb[4];
      tc::ldmatrix_x4_trans(vb, tc::bk_addr(vs, C::kLd, 0, dn * 16, lane));
      tc::mma_bf16(o[2 * dn], pa, vb[0], vb[1]);
      tc::mma_bf16(o[2 * dn + 1], pa, vb[2], vb[3]);
    }
  }
  tc::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // merge the four warps' states into the block's partial
  __syncthreads();  // every warp is done with the ring
  float* o_s = reinterpret_cast<float*>(smem);       // [warp][16][D]
  float* ml_s = o_s + kWarps * kMaxG * D;            // [warp][16][2]
  float* w_s = ml_s + kWarps * kMaxG * 2;            // [2 splits][16]
  float* den_s = w_s + 2 * kMaxSplits * kMaxG;       // [16]
  const int r0 = lane >> 2;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    float* row = o_s + (warp * kMaxG + r0) * D + 8 * i + c0;
    *reinterpret_cast<float2*>(row) = make_float2(o[i][0], o[i][1]);
    *reinterpret_cast<float2*>(row + 8 * D) = make_float2(o[i][2], o[i][3]);
  }
  if ((lane & 3) == 0) {
    ml_s[(warp * kMaxG + r0) * 2] = m[0];
    ml_s[(warp * kMaxG + r0) * 2 + 1] = l[0];
    ml_s[(warp * kMaxG + r0 + 8) * 2] = m[1];
    ml_s[(warp * kMaxG + r0 + 8) * 2 + 1] = l[1];
  }
  __syncthreads();
  // the block's partial goes to its slot in block 0's shared memory (a
  // store to distributed shared memory); a dead block (no key) writes
  // acc = 0, l = 0
  cg::cluster_group cl_group = cg::this_cluster();
  tc::cluster_wait();  // every block of the cluster has started
  float* recv0 = cl_group.map_shared_rank(recv, 0);
  float* acc_p = recv0 + (size_t)sp * G * D;
  float* ml_p = recv0 + (size_t)num_splits * G * D + (size_t)sp * G * 2;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (ml_s[(w * kMaxG + g) * 2 + 1] > 0.f)
        mb = fmaxf(mb, ml_s[(w * kMaxG + g) * 2]);
    float a = 0.f, lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = ml_s[(w * kMaxG + g) * 2 + 1];
      if (lw > 0.f) {
        const float wt = tc::fast_exp2(ml_s[(w * kMaxG + g) * 2] - mb);
        a += wt * o_s[(w * kMaxG + g) * D + d];
        lb += wt * lw;
      }
    }
    acc_p[i] = a;
    if (d == 0) {
      ml_p[2 * g] = mb;
      ml_p[2 * g + 1] = lb;
    }
  }

  // once every block has arrived (its stores released), block 0 merges:
  // out[g, d] = sum_s w_s acc_s[g, d] / sum_s w_s l_s with w_s = exp2(m_s -
  // max m) over the live splits (l_s > 0); a row with no live split is
  // exactly 0
  cl_group.sync();
  if (sp != 0) return;
  const float2* r_ml =
      reinterpret_cast<const float2*>(recv + (size_t)num_splits * G * D);
  if (tid < num_splits * G) {
    const int s = tid / G, g = tid - s * G;
    const float2 v = r_ml[s * G + g];
    w_s[s * kMaxG + g] = v.x;
    w_s[(kMaxSplits + s) * kMaxG + g] = v.y;
  }
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
    for (int s = 0; s < num_splits; ++s)
      if (w_s[(kMaxSplits + s) * kMaxG + tid] > 0.f)
        mx = fmaxf(mx, w_s[s * kMaxG + tid]);
    float lt = 0.f;
    for (int s = 0; s < num_splits; ++s) {
      const float ls = w_s[(kMaxSplits + s) * kMaxG + tid];
      const float w =
          ls > 0.f ? tc::fast_exp2(w_s[s * kMaxG + tid] - mx) : 0.f;
      w_s[s * kMaxG + tid] = w;
      lt += w * ls;
    }
    den_s[tid] = lt;
  }
  __syncthreads();
  // every split wrote its acc (a dead one zeros), so the loads need no
  // condition and are all in flight together
  bf16* out_row = out + pair * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float num = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < num_splits) num += w_s[s * kMaxG + g] * recv[s * G * D + i];
    const float den = den_s[g];
    out_row[i] = __float2bfloat16(den > 0.f ? num / den : 0.f);
  }
}

template <int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* context_lens,
           const void* occupancy, void* out, int B, int Hkv, int G,
           int page_size, int n_pages, int num_splits, int pages_per_split,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const size_t smem = C::kSmemFixed +
                      sizeof(float) * recv_floats(num_splits, G, D) +
                      sizeof(int) * (size_t)pages_per_split;
  cudaError_t err = repro::allow_smem(paged_mma_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_splits, B, Hkv);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = num_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, paged_mma_kernel<D>, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k_pages), static_cast<const bf16*>(v_pages),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens),
      static_cast<const unsigned char*>(occupancy), static_cast<bf16*>(out),
      Hkv, G, page_size, n_pages, num_splits, pages_per_split,
      scale * tc::kLog2e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paged_mma

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

// The "mma" variant: bf16, D = 64 or 128, G <= 16, num_splits <= 8; the
// splits of a (row, kv head) run as one thread-block cluster and merge in
// its shared memory.  Returns cudaGetLastError().
extern "C" int paged_attention_mma_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, const void* occupancy,
    void* out, int B, int Hkv, int G, int D, int page_size, int n_pages,
    int num_splits, int pages_per_split, float scale, void* stream) {
  if (num_splits < 1 || num_splits > paged_mma::kMaxSplits || G < 1 ||
      G > paged_mma::kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return paged_mma::launch<64>(q, k_pages, v_pages, block_tables,
                                 context_lens, occupancy, out, B, Hkv, G,
                                 page_size, n_pages, num_splits,
                                 pages_per_split, scale, s);
  if (D == 128)
    return paged_mma::launch<128>(q, k_pages, v_pages, block_tables,
                                  context_lens, occupancy, out, B, Hkv, G,
                                  page_size, n_pages, num_splits,
                                  pages_per_split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
