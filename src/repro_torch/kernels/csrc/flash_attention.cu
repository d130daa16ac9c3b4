// Dense attention forward (flash attention) for Hopper: three variants.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention (+ _flash_kernel).
//
// What it computes: q (B, Sq, H, D), k/v (B, Sk, Hkv, D) -> out (B, Sq, H, D)
// in q's dtype; softmax(q k^T / sqrt(D)) v with an fp32 online softmax.  GQA:
// query head h reads kv head h / (H / Hkv), so K/V are never copied per
// head.  With `causal` the mask is aligned top-left (query i sees keys
// 0..i, the TPU kernel's convention); the wrapper admits causal calls with
// Sq == Sk only.  Key tiles past the diagonal are skipped, the heaviest
// query tiles are issued first, and ragged tails of Sq and Sk are masked.
//
// What bounds it on H100: operations.  At the models' shapes (B = 4,
// S = 1024, H = 32, D = 64) the causal product is 17.2 GFLOP against
// 67 MB of q, k, v and out (bf16): 0.017 ms at 989 TFLOP/s, 0.020 ms at
// 3.35 TB/s, and the arithmetic intensity of one (query tile, key tile)
// pair is far above the card's ~295 flops/byte.  At DeepSeek-V2's MLA
// prefill (B = 2, S = 1024, H = 128, D = 192) the two come close: 403 MB
// take 0.120 ms, 103 GFLOP 0.104 ms.  In fp32 the same work is bound by
// operations at 165 TFLOP/s (3xTF32) or 67 (FMA).  So the design feeds the
// tensor cores:
//
// * flash_attention_tc_launch -- bf16 with D = 64, 128 or 192 (MLA's
//   nope 128 + rope 64, V padded to match).  One or two consumer
//   warpgroups (128 threads each) per tile of 64 or 128 query rows, each
//   warpgroup owning 64 rows and all of them sharing every K/V stage: two
//   halve the K/V traffic per query row and put 8 warps on an SM at
//   D = 192, where one 64-row block's shared memory leaves room for one
//   block of 4 (the wrapper's query_rows chooses).  QK^T is wgmma
//   m64n64k16 with Q and K read from shared memory in the 128-byte-swizzled
//   layout; PV is wgmma m64n64k16 with P in registers (bf16, after the fp32
//   rescale) and V read through the descriptor's transpose bit.  Q, K and
//   V tiles come in by TMA over 4-D tensor maps (D, heads, S, B) with box
//   (64, 1, 64, 1), one box per 64-wide column block (a 128-byte swizzle
//   row; D = 192 takes three), so a ragged S tail is zero-filled inside its
//   own batch; K/V tiles sit in a ring of kStages stages completed on
//   mbarriers, and each tile's copy overlaps the products of the tiles
//   before it.  The scale is folded with log2(e) into exp2 on the fp32
//   scores.  Shared helpers: attn_tc.cuh.
// * flash_attention_tf32x3_launch -- fp32 with D = 64, 128 or 192.  The
//   same tiling on mma.sync m16n8k8 TF32 with every operand split in two
//   TF32 numbers (3xTF32, tf32x3.cuh): fp32's accuracy at the TF32 rate.
//   4 or 8 warps own 16 query rows each (a 64- or 128-row tile, the
//   wrapper's query_rows chooses); K/V tiles of 64 keys (32 at D = 192,
//   where two stages of 64 fp32 keys would not fit beside Q) come in by
//   16-byte cp.async into a two-stage ring of row-major fp32 at a padded
//   stride; Q stays in shared memory and is split as it is read.  A warp
//   skips a key tile wholly past its own diagonal.
// * flash_attention_launch -- every other call (fp32 or bf16 with any
//   other D): the first version, fp32 FMAs from shared memory.  Each of
//   its 256 threads owns 4 query rows x 4 keys of a 64 x 64 score tile and
//   the same 4 rows x D / 16 output columns (D <= 192).
#include <cuda.h>

#include "attn_tc.cuh"
#include "common.cuh"
#include "tf32x3.cuh"

namespace {

using repro::kNegInf;

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kLdp = kBlockK + 4;   // score-tile stride: the two row groups
                                    // of a warp land on different banks
constexpr int kMaxCols = 12;        // D / 16 output columns a thread, D <= 192

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

// ------------------------------------------------- tensor-core variant

namespace tcf {

using namespace repro::tc;
using repro::tc::kThreads;  // hides the FMA variant's 256

// K/V ring: tile t + kStages loads while t computes.  Three stages at
// D = 192, where a 64-key tile of K and V is 48 KB, two below.
template <int D>
__host__ __device__ constexpr int stages_of() {
  return D == 192 ? 3 : 2;
}

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return kRows * D * 2;  // 64 rows (queries or keys) of D bf16
}

// WG query tiles of 64 rows (one a warpgroup), then kStages K tiles, then
// kStages V tiles, then the mbarriers (Q, then one per stage), from a
// 1024-byte-aligned base.
template <int D, int WG>
constexpr size_t smem_bytes() {
  constexpr int kStages = stages_of<D>();
  return (WG + 2 * kStages) * tile_bytes<D>() + 8 * (1 + kStages) + 1024;
}

// Grid: one block per (query tile, head, batch), flattened so that every
// (head, batch) of the heaviest query tile (the last: it walks the most
// keys when causal) is issued before any lighter one.  A block is WG
// consumer warpgroups, warpgroup w owning query rows q0 + 64 w ..
// q0 + 64 w + 63; they share every K/V stage.
template <int D, int WG>
__global__ void __launch_bounds__(kThreads * WG)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int B, int Sq, int Sk, int H,
                int Hkv, int causal, float scale_log2) {
  constexpr uint32_t kTile = tile_bytes<D>();
  constexpr uint32_t kBlockBytes = kRows * 128;  // one 64-wide column block
  constexpr int kRowsT = kRows * WG;
  constexpr int kStages = stages_of<D>();
  const int n_qt = (Sq + kRowsT - 1) / kRowsT;
  const int per_tile = H * B;
  const int q0 =
      (n_qt - 1 - static_cast<int>(blockIdx.x) / per_tile) * kRowsT;
  const int hb = static_cast<int>(blockIdx.x) % per_tile;
  const int h = hb % H, b = hb / H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31;
  // with two warpgroups, their index through a shuffle, so that ptxas
  // knows it warp-uniform and keeps the wgmma descriptors in uniform
  // registers; with one, the plain warp index
  const int wg = WG == 1 ? 0 : __shfl_sync(0xffffffffu, tid / kThreads, 0);
  const int warp = WG == 1 ? tid >> 5 : (tid >> 5) & 3;
  const int wq0 = q0 + kRows * wg;  // this warpgroup's first row

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;                          // + wg * kTile
  const uint32_t k_s = base + WG * kTile;             // + stage * kTile
  const uint32_t v_s = base + (WG + kStages) * kTile;  // + stage * kTile
  const uint32_t bar = base + (WG + 2 * kStages) * kTile;  // Q; + 8 (1 + s)

  const int k_end = causal ? min(Sk, q0 + kRowsT) : Sk;
  const int n_kt = (k_end + kKeys - 1) / kKeys;

  const CUtensorMap* map_k = &tk;
  const CUtensorMap* map_v = &tv;
  auto load_kv = [=](int t, int s) {
    const uint32_t full = bar + 8 * (1 + s);
    mbar_expect_tx(full, 2 * kTile);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load_4d(k_s + s * kTile + cb * kBlockBytes, map_k, full, cb * 64,
                  hk, t * kKeys, b);
      tma_load_4d(v_s + s * kTile + cb * kBlockBytes, map_v, full, cb * 64,
                  hk, t * kKeys, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(bar + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    // a warpgroup's tile wholly past Sq is zero-filled (its rows are
    // computed and never written)
    mbar_expect_tx(bar, WG * kTile);
#pragma unroll
    for (int w = 0; w < WG; ++w)
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        tma_load_4d(q_s + w * kTile + cb * kBlockBytes, &tq, bar, cb * 64, h,
                    q0 + kRows * w, b);
    for (int t = 0; t < kStages && t < n_kt; ++t) load_kv(t, t);
  }

  float o[D / 64][32];
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
  OnlineSoftmax sm;
  sm.init();
  const int row0 = wq0 + 16 * warp + (lane >> 2);  // + 8 for the second half
  const int col0 = 2 * (lane & 3);                 // + 8 j + e

  mbar_wait(bar, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    mbar_wait(bar + 8 * (1 + s), (t / kStages) & 1);
    const int k0 = t * kKeys;
    // Every warpgroup runs every tile, even one wholly past its diagonal
    // (masked: it leaves the softmax state as it was): a wgmma in a branch
    // that ptxas cannot prove warpgroup-uniform is serialized.
    float sc[32];
    scores<D>(sc, q_s + wg * kTile, k_s + s * kTile);
    const bool edge = k0 + kKeys > Sk || (causal && k0 + kKeys - 1 > wq0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      float x = sc[i] * scale_log2;
      if (edge && (key >= Sk || (causal && key > row))) x = -INFINITY;
      sc[i] = x;
    }
    float corr[2];
    sm.step(sc, corr);
    rescale<D>(o, corr);
    accumulate_pv<D>(o, sc, v_s + s * kTile);

    __syncthreads();  // every warp's products on stage s have completed
    if (tid == 0 && t + kStages < n_kt) load_kv(t + kStages, s);
  }

  sm.finish();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= Sq) continue;
    const float inv = 1.f / sm.l[half];
    __nv_bfloat16* dst = out + (((size_t)b * Sq + row) * H + h) * D + col0;
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + cb * 64 + 8 * j) =
            pack_bf16(o[cb][4 * j + 2 * half] * inv,
                      o[cb][4 * j + 2 * half + 1] * inv);
  }
}

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no
// -lcuda at link time).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a contiguous bf16 (B, S, heads, D) tensor, innermost
// first: (D, heads, S, B), box (64, 1, 64, 1), 128-byte swizzle, and
// zero fill outside the tensor (the ragged S tail of each batch).
cudaError_t encode(CUtensorMap* map, const void* ptr, int D, int heads, int S,
                   int B) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int WG>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, int causal, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode(&tq, q, D, H, Sq, B);
  if (err == cudaSuccess) err = encode(&tk, k, D, Hkv, Sk, B);
  if (err == cudaSuccess) err = encode(&tv, v, D, Hkv, Sk, B);
  if (err == cudaSuccess)
    err = repro::allow_smem(flash_tc_kernel<D, WG>, smem_bytes<D, WG>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      (long long)((Sq + kRows * WG - 1) / (kRows * WG)) * H * B;
  flash_tc_kernel<D, WG><<<(unsigned)blocks, kThreads * WG,
                           smem_bytes<D, WG>(), stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), B, Sq, Sk, H, Hkv, causal,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_rows(int rows, const void* q, const void* k, const void* v,
                void* out, int B, int Sq, int Sk, int H, int Hkv, int causal,
                float scale, cudaStream_t stream) {
  if (rows == 64)
    return launch<D, 1>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, scale,
                        stream);
  if (rows == 128)
    return launch<D, 2>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, scale,
                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tcf

// ------------------------------------------------ 3xTF32 variant (fp32)

namespace tff {

using repro::tc::cp_async16;
using repro::tc::cp_async_commit;
using repro::tc::cp_async_wait;
using repro::tc::kLog2e;
using repro::tc::OnlineSoftmax;
using repro::tc::smem_u32;
using repro::tf32::ld_qk;
using repro::tf32::ld_v;

// Keys of one K/V tile: 64, or 32 at D = 192 (two stages of 64 fp32 keys
// and a Q tile would not fit the 227 KB).
template <int D>
__host__ __device__ constexpr int keys_of() {
  return D == 192 ? 32 : 64;
}

// Q (16 WARPS rows) and two K stages at stride ld_qk(D), then two V
// stages at stride ld_v(D), row-major fp32.
template <int D, int WARPS>
constexpr size_t smem_bytes() {
  return sizeof(float) * (ld_qk(D) * (16 * WARPS + 2 * keys_of<D>()) +
                          ld_v(D) * 2 * keys_of<D>());
}

// Grid as flash_tc_kernel's: heaviest query tile first.  Warp w owns query
// rows q0 + 16 w .. q0 + 16 w + 15 of the block's 16 WARPS.
template <int D, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
flash_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int B, int Sq, int Sk, int H, int Hkv, int causal,
                    float scale_log2) {
  constexpr int kRowsT = 16 * WARPS, kKeysT = keys_of<D>();
  constexpr int ld = ld_qk(D), ldv = ld_v(D);
  constexpr int kThreadsT = 32 * WARPS, kChunks = D / 4;  // 16 B chunks
  const int n_qt = (Sq + kRowsT - 1) / kRowsT;
  const int per_tile = H * B;
  const int q0 =
      (n_qt - 1 - static_cast<int>(blockIdx.x) / per_tile) * kRowsT;
  const int hb = static_cast<int>(blockIdx.x) % per_tile;
  const int h = hb % H, b = hb / H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ float4 smem_tf[];
  float* q_s = reinterpret_cast<float*>(smem_tf);
  float* k_s = q_s + kRowsT * ld;       // + stage * kKeysT * ld
  float* v_s = k_s + 2 * kKeysT * ld;   // + stage * kKeysT * ldv

  for (int i = tid; i < kRowsT * kChunks; i += kThreadsT) {
    const int r = i / kChunks, col = (i % kChunks) * 4;
    const int qi = q0 + r;
    const bool ok = qi < Sq;
    cp_async16(smem_u32(q_s + r * ld + col),
               ok ? q + (((size_t)b * Sq + qi) * H + h) * D + col : q, ok);
  }
  auto load_kv = [&](int t, int s) {
    for (int i = tid; i < kKeysT * kChunks; i += kThreadsT) {
      const int r = i / kChunks, col = (i % kChunks) * 4;
      const int kj = t * kKeysT + r;
      const bool ok = kj < Sk;
      const size_t off = ok ? (((size_t)b * Sk + kj) * Hkv + hk) * D + col : 0;
      cp_async16(smem_u32(k_s + (s * kKeysT + r) * ld + col), k + off, ok);
      cp_async16(smem_u32(v_s + (s * kKeysT + r) * ldv + col), v + off, ok);
    }
  };
  const int k_end = causal ? min(Sk, q0 + kRowsT) : Sk;
  const int n_kt = (k_end + kKeysT - 1) / kKeysT;
  load_kv(0, 0);
  cp_async_commit();  // Q rides with the first K/V tile

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  OnlineSoftmax sm;
  sm.init();
  const int wq0 = q0 + 16 * warp;         // this warp's first row
  const int row0 = wq0 + (lane >> 2);     // + 8 for the second half
  const int col0 = 2 * (lane & 3);        // + 8 j + e

  for (int t = 0; t < n_kt; ++t) {
    const int s = t & 1;
    if (t + 1 < n_kt) {
      load_kv(t + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * kKeysT;
    // warp-uniform: a key tile wholly past this warp's diagonal adds
    // nothing
    if (!causal || k0 <= wq0 + 15) {
      float sc[kKeysT / 2];
      repro::tf32::scores<D, kKeysT>(sc, q_s + 16 * warp * ld,
                                     k_s + s * kKeysT * ld, lane);
      const bool edge = k0 + kKeysT > Sk || (causal && k0 + kKeysT - 1 > wq0);
#pragma unroll
      for (int i = 0; i < kKeysT / 2; ++i) {
        const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        float x = sc[i] * scale_log2;
        if (edge && (key >= Sk || (causal && key > row))) x = -INFINITY;
        sc[i] = x;
      }
      float corr[2];
      sm.step(sc, corr);
      repro::tf32::rescale(o, corr);
      repro::tf32::accumulate_pv<D, kKeysT>(o, sc, v_s + s * kKeysT * ldv,
                                            lane);
    }
    __syncthreads();  // every warp is done with stage s before its refill
  }

  sm.finish();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= Sq) continue;
    const float inv = 1.f / sm.l[half];
    float* dst = out + (((size_t)b * Sq + row) * H + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
  }
}

template <int D, int WARPS>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, WARPS>();
  cudaError_t err = repro::allow_smem(flash_tf32x3_kernel<D, WARPS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = 16 * WARPS;
  const long long blocks = (long long)((Sq + rows - 1) / rows) * H * B;
  flash_tf32x3_kernel<D, WARPS><<<(unsigned)blocks, 32 * WARPS, smem,
                                  stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), B, Sq, Sk, H,
      Hkv, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_rows(int rows, const void* q, const void* k, const void* v,
                void* out, int B, int Sq, int Sk, int H, int Hkv, int causal,
                float scale, cudaStream_t stream) {
  if (rows == 64)
    return launch<D, 4>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, scale,
                        stream);
  if (rows == 128)
    return launch<D, 8>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, scale,
                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tff

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

// The tensor-core variants.  bf16 (wgmma): D = 64, 128 or 192, every
// pointer 16-byte aligned (TMA); fp32 (3xTF32): the same D, every pointer
// 16-byte aligned (cp.async).  rows: the query rows of one block, 64 or
// 128.  Returns cudaGetLastError() (or the encode failure).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int Sq, int Sk, int H, int Hkv,
                                         int D, int causal, float scale,
                                         int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return tcf::launch_rows<64>(rows, q, k, v, out, B, Sq, Sk, H, Hkv, causal,
                                scale, s);
  if (D == 128)
    return tcf::launch_rows<128>(rows, q, k, v, out, B, Sq, Sk, H, Hkv,
                                 causal, scale, s);
  if (D == 192)
    return tcf::launch_rows<192>(rows, q, k, v, out, B, Sq, Sk, H, Hkv,
                                 causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_tf32x3_launch(const void* q, const void* k,
                                             const void* v, void* out, int B,
                                             int Sq, int Sk, int H, int Hkv,
                                             int D, int causal, float scale,
                                             int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return tff::launch_rows<64>(rows, q, k, v, out, B, Sq, Sk, H, Hkv, causal,
                                scale, s);
  if (D == 128)
    return tff::launch_rows<128>(rows, q, k, v, out, B, Sq, Sk, H, Hkv,
                                 causal, scale, s);
  if (D == 192)
    return tff::launch_rows<192>(rows, q, k, v, out, B, Sq, Sk, H, Hkv,
                                 causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
