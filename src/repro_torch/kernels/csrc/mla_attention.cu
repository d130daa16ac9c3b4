// Multi-head latent attention (DeepSeek-V2's MLA) over a paged latent pool,
// in absorbed form, for Hopper; and the masked store of the latent.
//
// Replaces no TPU kernel: the JAX package decodes MLA with plain einsums
// over a contiguous (B, S, rank) cache (repro/models/mla.py,
// mla_attention_decode) and has no paged latent cache.  The serving engine
// keeps one pool row of 576 values a token a layer: the 512-wide latent
// c_kv after its RMSNorm, then the 64 roped key dimensions.  Every query
// head reads the same row, so the rows are read once for many heads.
//
// What it computes: for each row b (a decode row, or a prefill lane with
// context = position + 1) and head h, with q (B, H, 576) the absorbed query
// (q_nope W_uk, then the roped q_rope), scores s = q . k over the row's
// first context_lens[b] pool rows (through block_tables (B, n_pages)) times
// `scale`, softmax in fp32, and the output o (B, H, 512) = sum p v, where v
// is the first 512 values of the same row.  Rows with occupancy 0 or no
// key come out exactly 0.
//
// What bounds it on H100: near the ridge.  A decode row of ~1,150 keys
// reads 1.3 MB of latent and does 128 heads x 1,088 x 2 operations a key:
// 239 operations a byte, against the card's 295.  So the design reads each
// latent row once for 64 heads and runs both products on the tensor cores.
//
// Design ("right and simple first"): one block of sixteen warps per (64
// query heads, row, split).  Its 64 x 576 queries sit in shared memory; the
// split's keys come 32 at a time by 16-byte cp.async into a two-stage ring
// (the next step's copy in flight while one is computed), a key past the
// split's end zero-filled.  Warp w = 4 kg + hg computes the scores of heads
// 16 hg .. +16 against keys 8 kg .. +8 over all 576 dimensions (mma.sync
// m16n8k16, bf16 in, fp32 out), and, after the block's row maxima and sums
// are merged through shared memory, accumulates heads 16 hg .. +16 x output
// dimensions 128 kg .. +128 from P (bf16, in shared memory) and the keys'
// first 512 values (ldmatrix .trans).  The online softmax is in fp32 in the
// log2 domain.  One split writes the normalised bf16 row; several write
// fp32 partials (acc, m, l) that a combine kernel merges.
//
// The decode call and a prefill chunk's lanes run the same body under
// distinct entry names (mla_decode_* and mla_prefill_*), so a trace can
// tell the two apart.

#include "common.cuh"
#include "mma_tc.cuh"

namespace {

using repro::kNegInf;
using repro::tc::a_addr;
using repro::tc::bk_addr;
using repro::tc::cp_async16;
using repro::tc::cp_async_commit;
using repro::tc::cp_async_wait;
using repro::tc::ldmatrix_x4;
using repro::tc::ldmatrix_x4_trans;
using repro::tc::mma_bf16;
using repro::tc::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int kLat = 512;                 // latent width (= V's width)
constexpr int kRope = 64;                 // roped key dimensions
constexpr int kDim = kLat + kRope;        // a pool row
constexpr int kHeads = 64;                // query heads a block
constexpr int kKeys = 32;                 // keys a step
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kDim + 8;             // padded row (1,168 B)
constexpr int kLdp = kKeys + 8;           // padded P row (80 B)
constexpr int kChunks = kDim / 8;         // 16-byte chunks a row
constexpr int kCombineThreads = 128;
constexpr size_t kSmem =
    sizeof(bf16) * (kHeads * kLd + 2 * kKeys * kLd + kHeads * kLdp) +
    sizeof(float) * 8 * kHeads;

struct Args {
  const bf16* q;             // (B, H, 576)
  const bf16* pool;          // (P, page_size, 576)
  const int* tables;         // (B, n_pages)
  const int* ctx;            // (B,)
  const unsigned char* occ;  // (B,)
  bf16* out;                 // (B, H, 512)
  float* acc;                // (splits, B, H, 512), splits > 1 only
  float* m;                  // (splits, B, H)
  float* l;                  // (splits, B, H)
  int B, H, page_size, n_pages, num_splits, keys_per_split;
  float scale_log2;          // the score scale times log2(e)
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void mla_body(const Args& a) {
  const int h0 = blockIdx.x * kHeads, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hg = warp & 3, kg = warp >> 2;
  const int r = lane >> 2, c = 2 * (lane & 3);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kHeads * kLd;
  bf16* p_s = k_s + 2 * kKeys * kLd;
  float* red_max = reinterpret_cast<float*>(p_s + kHeads * kLdp);
  float* red_sum = red_max + 4 * kHeads;

  const int ctx = a.occ[b] ? a.ctx[b] : 0;
  const int key_lo = sp * a.keys_per_split;
  const int key_hi = min(key_lo + a.keys_per_split, ctx);
  const int n_steps = key_hi > key_lo ? (key_hi - key_lo + kKeys - 1) / kKeys
                                      : 0;
  const int* bt = a.tables + (size_t)b * a.n_pages;

  const bf16* q_row = a.q + ((size_t)b * a.H + h0) * kDim;
  for (int i = tid; i < kHeads * kChunks; i += kThreads) {
    const int row = i / kChunks, ch = i % kChunks;
    cp_async16(smem_u32(q_s + row * kLd + ch * 8),
               q_row + (size_t)row * kDim + ch * 8, true);
  }
  auto load_keys = [&](int stage, int k0) {
    bf16* dst = k_s + stage * kKeys * kLd;
    for (int i = tid; i < kKeys * kChunks; i += kThreads) {
      const int row = i / kChunks, ch = i % kChunks;
      const int key = k0 + row;
      const bool live = key < key_hi;
      const bf16* src = a.pool;
      if (live)
        src = a.pool +
              ((size_t)bt[key / a.page_size] * a.page_size +
               key % a.page_size) * kDim + ch * 8;
      cp_async16(smem_u32(dst + row * kLd + ch * 8), src, live);
    }
  };
  if (n_steps > 0) load_keys(0, key_lo);
  cp_async_commit();

  float acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const int head_a = 16 * hg + r, head_b = head_a + 8;

  for (int j = 0; j < n_steps; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_steps) load_keys((j + 1) & 1, key_lo + (j + 1) * kKeys);
    cp_async_commit();
    const bf16* ks = k_s + (j & 1) * kKeys * kLd;

    // scores of heads 16 hg .. +16 against keys 8 kg .. +8
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 6
    for (int kk = 0; kk < kDim; kk += 32) {
      uint32_t bf[4], af[4];
      ldmatrix_x4(bf, smem_u32(ks + (8 * kg + (lane & 7)) * kLd + kk +
                               (lane >> 3) * 8));
      ldmatrix_x4(af, a_addr(q_s, kLd, 16 * hg, kk, lane));
      mma_bf16(s, af, bf[0], bf[1]);
      ldmatrix_x4(af, a_addr(q_s, kLd, 16 * hg, kk + 16, lane));
      mma_bf16(s, af, bf[2], bf[3]);
    }
    const int key0 = key_lo + j * kKeys + 8 * kg + c;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e] = key0 + (e & 1) < key_hi ? s[e] * a.scale_log2 : kNegInf;
    const float mx_a = quad_max(fmaxf(s[0], s[1]));
    const float mx_b = quad_max(fmaxf(s[2], s[3]));
    if ((lane & 3) == 0) {
      red_max[kg * kHeads + head_a] = mx_a;
      red_max[kg * kHeads + head_b] = mx_b;
    }
    __syncthreads();

    float m_new[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int h = i ? head_b : head_a;
      const float mb = fmaxf(fmaxf(red_max[h], red_max[kHeads + h]),
                             fmaxf(red_max[2 * kHeads + h],
                                   red_max[3 * kHeads + h]));
      m_new[i] = fmaxf(m_run[i], mb);
      alpha[i] = exp2f(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
    }
    const __nv_bfloat162 p_a = __floats2bfloat162_rn(
        exp2f(s[0] - m_new[0]), exp2f(s[1] - m_new[0]));
    const __nv_bfloat162 p_b = __floats2bfloat162_rn(
        exp2f(s[2] - m_new[1]), exp2f(s[3] - m_new[1]));
    const float2 f_a = __bfloat1622float2(p_a), f_b = __bfloat1622float2(p_b);
    const float sum_a = quad_sum(f_a.x + f_a.y);
    const float sum_b = quad_sum(f_b.x + f_b.y);
    *reinterpret_cast<__nv_bfloat162*>(p_s + head_a * kLdp + 8 * kg + c) = p_a;
    *reinterpret_cast<__nv_bfloat162*>(p_s + head_b * kLdp + 8 * kg + c) = p_b;
    if ((lane & 3) == 0) {
      red_sum[kg * kHeads + head_a] = sum_a;
      red_sum[kg * kHeads + head_b] = sum_b;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int h = i ? head_b : head_a;
      l_run[i] = l_run[i] * alpha[i] + red_sum[h] + red_sum[kHeads + h] +
                 red_sum[2 * kHeads + h] + red_sum[3 * kHeads + h];
    }
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }
    // heads 16 hg .. +16 x dimensions 128 kg .. +128 += P V
#pragma unroll
    for (int kk = 0; kk < kKeys; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, a_addr(p_s, kLdp, 16 * hg, kk, lane));
#pragma unroll
      for (int t = 0; t < 16; t += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bk_addr(ks, kLd, kk, 128 * kg + 8 * t, lane));
        mma_bf16(acc[t], af, bf[0], bf[1]);
        mma_bf16(acc[t + 1], af, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  const size_t row_a = (size_t)b * a.H + h0 + head_a;
  const size_t row_b = row_a + 8;
  const int col = 128 * kg + c;
  if (a.num_splits == 1) {
    const float inv_a = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;
    const float inv_b = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      *reinterpret_cast<__nv_bfloat162*>(a.out + row_a * kLat + col + 8 * t) =
          __floats2bfloat162_rn(acc[t][0] * inv_a, acc[t][1] * inv_a);
      *reinterpret_cast<__nv_bfloat162*>(a.out + row_b * kLat + col + 8 * t) =
          __floats2bfloat162_rn(acc[t][2] * inv_b, acc[t][3] * inv_b);
    }
    return;
  }
  const size_t base = (size_t)sp * a.B * a.H;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    *reinterpret_cast<float2*>(a.acc + (base + row_a) * kLat + col + 8 * t) =
        make_float2(acc[t][0], acc[t][1]);
    *reinterpret_cast<float2*>(a.acc + (base + row_b) * kLat + col + 8 * t) =
        make_float2(acc[t][2], acc[t][3]);
  }
  if (kg == 0 && (lane & 3) == 0) {
    a.m[base + row_a] = m_run[0];
    a.m[base + row_b] = m_run[1];
    a.l[base + row_a] = l_run[0];
    a.l[base + row_b] = l_run[1];
  }
}

// The splits' partials of one (row, head) merged: weights 2^(m_s - max m).
__device__ __forceinline__ void combine_body(const Args& a) {
  const size_t row = (size_t)blockIdx.y * a.H + blockIdx.x;
  const size_t rows = (size_t)a.B * a.H;
  float mx = kNegInf;
  for (int s = 0; s < a.num_splits; ++s) mx = fmaxf(mx, a.m[s * rows + row]);
  float wsum = 0.f, o[kLat / kCombineThreads] = {};
  for (int s = 0; s < a.num_splits; ++s) {
    const float w = exp2f(a.m[s * rows + row] - mx);
    wsum += w * a.l[s * rows + row];
    const float* src = a.acc + (s * rows + row) * kLat;
#pragma unroll
    for (int i = 0; i < kLat / kCombineThreads; ++i)
      o[i] += w * src[threadIdx.x + i * kCombineThreads];
  }
  const float inv = wsum > 0.f ? 1.f / wsum : 0.f;
#pragma unroll
  for (int i = 0; i < kLat / kCombineThreads; ++i)
    a.out[row * kLat + threadIdx.x + i * kCombineThreads] =
        __float2bfloat16(o[i] * inv);
}

__global__ void __launch_bounds__(kThreads, 1)
mla_decode_partial_kernel(const Args a) { mla_body(a); }

__global__ void __launch_bounds__(kThreads, 1)
mla_prefill_partial_kernel(const Args a) { mla_body(a); }

__global__ void __launch_bounds__(kCombineThreads)
mla_decode_combine_kernel(const Args a) { combine_body(a); }

__global__ void __launch_bounds__(kCombineThreads)
mla_prefill_combine_kernel(const Args a) { combine_body(a); }

// ------------------------------------------------------- latent store

// One block of 64 threads a lane: the lane's RMSNorm of kv[:512] times
// kv_norm, then its rope dimensions kv[512:576] rotated (rotate-half form,
// pairs read interleaved first when asked), both written to its pool row
// at (wr_page, wr_slot); a negative page writes nothing.  The arithmetic
// is the plain chain's: fp32 inside, one rounding to the storage type.
constexpr int kStoreThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kStoreThreads)
mla_latent_store_kernel(const T* __restrict__ kv, const T* __restrict__ gain,
                        const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, T* __restrict__ pool,
                        const long long* __restrict__ wr_page,
                        const long long* __restrict__ wr_slot, int page_size,
                        float eps, int interleaved) {
  const int n = blockIdx.x, tid = threadIdx.x;
  const long long page = wr_page[n];
  if (page < 0) return;
  const T* x = kv + (size_t)n * kDim;
  T* dst = pool + ((size_t)page * page_size + wr_slot[n]) * kDim;
  constexpr int kPer = kLat / kStoreThreads;
  float v[kPer], ss = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    v[i] = repro::to_float(x[tid + i * kStoreThreads]);
    ss += v[i] * v[i];
  }
  ss = repro::warp_sum(ss);
  __shared__ float part[kStoreThreads / 32];
  if ((tid & 31) == 0) part[tid >> 5] = ss;
  __syncthreads();
  const float rs = rsqrtf((part[0] + part[1]) / kLat + eps);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = tid + i * kStoreThreads;
    dst[d] = repro::from_float<T>(v[i] * rs * repro::to_float(gain[d]));
  }
  if (tid < kRope / 2) {
    const float* cs = cos_t + (size_t)n * (kRope / 2);
    const float* sn = sin_t + (size_t)n * (kRope / 2);
    const T* xr = x + kLat;
    const float x1 = repro::to_float(interleaved ? xr[2 * tid] : xr[tid]);
    const float x2 = repro::to_float(interleaved ? xr[2 * tid + 1]
                                                 : xr[tid + kRope / 2]);
    dst[kLat + tid] = repro::from_float<T>(x1 * cs[tid] - x2 * sn[tid]);
    dst[kLat + kRope / 2 + tid] =
        repro::from_float<T>(x2 * cs[tid] + x1 * sn[tid]);
  }
}

}  // namespace

// q (B, H, 576) bf16, pool (P, page_size, 576) bf16 of one layer,
// block_tables (B, n_pages) int32, context_lens (B,) int32, occupancy (B,)
// bool; writes out (B, H, 512) bf16.  With num_splits > 1, acc / m / l are
// the (splits, B, H, 512) / (splits, B, H) / (splits, B, H) fp32 partials.
// H is a multiple of 64.  prefill selects the prefill entry names.
extern "C" int mla_attention_launch(
    const void* q, const void* pool, const void* block_tables,
    const void* context_lens, const void* occupancy, void* out, void* acc,
    void* m, void* l, int B, int H, int page_size, int n_pages,
    int num_splits, int keys_per_split, float scale, int prefill,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1) return static_cast<int>(cudaSuccess);
  if (H % kHeads || num_splits < 1 || keys_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(pool),
         static_cast<const int*>(block_tables),
         static_cast<const int*>(context_lens),
         static_cast<const unsigned char*>(occupancy), static_cast<bf16*>(out),
         static_cast<float*>(acc), static_cast<float*>(m),
         static_cast<float*>(l), B, H, page_size, n_pages, num_splits,
         keys_per_split, scale * 1.4426950408889634f};
  auto partial = prefill ? mla_prefill_partial_kernel
                         : mla_decode_partial_kernel;
  cudaError_t err = repro::allow_smem(partial, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  partial<<<dim3(H / kHeads, B, num_splits), kThreads, kSmem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || num_splits == 1) return static_cast<int>(err);
  auto combine = prefill ? mla_prefill_combine_kernel
                         : mla_decode_combine_kernel;
  combine<<<dim3(H, B), kCombineThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// kv (rows, 576), gain (512,), cos / sin (rows, 32) float32, pool
// (P, page_size, 576) of one layer, wr_page / wr_slot (rows,) int64.
// dtype 0 = float32, 1 = bfloat16.
extern "C" int mla_latent_store_launch(const void* kv, const void* gain,
                                       const void* cos_t, const void* sin_t,
                                       void* pool, const void* wr_page,
                                       const void* wr_slot, int rows,
                                       int page_size, float eps,
                                       int interleaved, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1) return static_cast<int>(cudaSuccess);
  const auto* cs = static_cast<const float*>(cos_t);
  const auto* sn = static_cast<const float*>(sin_t);
  const auto* pg = static_cast<const long long*>(wr_page);
  const auto* sl = static_cast<const long long*>(wr_slot);
  if (dtype == 0)
    mla_latent_store_kernel<float><<<rows, kStoreThreads, 0, s>>>(
        static_cast<const float*>(kv), static_cast<const float*>(gain), cs,
        sn, static_cast<float*>(pool), pg, sl, page_size, eps, interleaved);
  else if (dtype == 1)
    mla_latent_store_kernel<__nv_bfloat16><<<rows, kStoreThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(kv),
        static_cast<const __nv_bfloat16*>(gain), cs, sn,
        static_cast<__nv_bfloat16*>(pool), pg, sl, page_size, eps,
        interleaved);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
