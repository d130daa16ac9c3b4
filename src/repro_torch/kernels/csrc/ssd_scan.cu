// Mamba2 SSD (state-space duality) chunk scan for Hopper.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (+ _ssd_kernel).
//
// What it computes, per (batch b, head h), over chunks of Q positions:
//   da_cs[i]  = cumsum_{t <= i} dt[t] * a[h]              (within the chunk)
//   y[i]      = sum_{j <= i} (C_i . B_j) exp(da_cs[i] - da_cs[j]) dt[j] x[j]
//             + exp(da_cs[i]) C_i . state                  (carried (P, N))
//             + d_skip[h] x[i]                             (optional)
//   state     = state exp(da_cs[Q-1])
//             + sum_j x[j] (x) B_j exp(da_cs[Q-1] - da_cs[j]) dt[j]
// with x (B, S, H, P), dt (B, S, H) fp32, a (H,) fp32, B/C (B, S, G, N) and
// group g = h / (H / G); y (B, S, H, P) in x's dtype, the final state
// (B, H, P, N) in fp32.  d_skip is added in the fp32 epilogue before the
// cast (the model's ssd_chunked_ref order).
//
// Contract of both variants: one block per (head, batch) walks the chunks
// in order, as the TPU grid's sequential chunk axis did, carrying the fp32
// state.  The decay factor exp(da_cs[i] - da_cs[j]) is taken only on and
// below the diagonal (above it the exponent is positive and can pass 88,
// and exp * 0 would be NaN); every other exponent is <= 0.  A ragged last
// chunk (S not a multiple of Q) is zero-filled past the end: dt = 0 there,
// so it neither decays nor adds to the state, and its rows are not written.
//
// What bounds it on H100: bytes.  At the Mamba2 block's shape (B = 4,
// S = 1024, H = 64, P = 64, N = 128, bf16) one call reads x, B, C and dt
// and writes y and the fp32 final state, about 78 MB (23 us at 3.35 TB/s),
// against about 15 GFLOP of chunk products (15 us at the bf16 tensor-core
// peak).  B * H = 256 blocks cover the 132 SMs in one wave at two blocks
// an SM.
//
// Two variants, chosen by the wrapper (kernels/ssd_scan.py,
// kernel_variant):
//
// * "mma", bf16 x/B/C with P = 64, N = 64 or 128 and chunk 128 (Mamba2-1.3B
//   N = 128, Zamba2-1.2B N = 64).  All four products on the tensor cores
//   with mma.sync m16n8k16, each of the eight warps owning 16 query rows:
//   C state^T (the carried state as a bf16 copy in shared memory), then the
//   causal C B^T scores 16 keys at a time, masked and decayed in fp32,
//   rounded to bf16 and fed straight from the accumulator into W x as the
//   A operand (as flash attention feeds P); the state update x^T (B o w)
//   (w = exp(total - da_cs) dt folded into the x^T operand in registers)
//   accumulates into an fp32 state that never leaves the registers, each
//   warp owning a 16 x N/2 tile of it, and is copied to shared memory in
//   bf16 once a chunk.  x, B and C arrive in bf16 by 16-byte cp.async into
//   padded (conflict-free) tiles, 105 KB at N = 128: one stage, two blocks
//   an SM, so one block's copies overlap the other's products.  The dt a
//   cumsum is a warp scan.  mma.sync rather than wgmma: each warp's score
//   tile feeds its own W x product in registers, and a 16-row warp tile
//   follows the causal triangle at a fine grain.
// * "fma", fp32 (not yet redesigned, ROADMAP B.4: the 3xTF32 split of
//   tf32x3.cuh would keep fp32's accuracy on the tensor cores) and bf16 at
//   any other shape: the first version, everything in fp32 FMAs from shared
//   memory, the Q x Q scores built in strips of kStrip query rows.

#include "common.cuh"
#include "mma_tc.cuh"

namespace {

// ------------------------------------------------------------ "fma" variant

constexpr int kThreads = 256;  // 8 warps
constexpr int kStrip = 32;     // query rows per score strip: 8 warps x 4 rows
constexpr int kMaxQ = 128;     // 32 lanes x 4 key columns
constexpr int kMaxP = 128;     // state update: 8 warps x 16 rows
constexpr int kMaxN = 128;     // 32 lanes x 4 columns

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ d_skip,
                T* __restrict__ y, float* __restrict__ final_state, int S,
                int H, int G, int P, int N, int Q) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldn = N + 1;  // odd: lanes reading consecutive rows hit distinct
                          // banks
  const int n_pp = (P + 31) / 32;  // column blocks of y a lane computes
  const int n_nb = (N + 31) / 32;  // column blocks of the state it updates

  extern __shared__ float smem[];
  float* st_s = smem;                  // P * ldn, the carried state
  float* x_s = st_s + P * ldn;         // Q * P
  float* b_s = x_s + Q * P;            // Q * ldn
  float* c_s = b_s + Q * ldn;          // kStrip * ldn
  float* w_s = c_s + kStrip * ldn;     // kStrip * Q, decay-masked scores
  float* dt_s = w_s + kStrip * Q;      // Q
  float* cs_s = dt_s + Q;              // Q, cumsum of dt * a
  float* we_s = cs_s + Q;              // Q, exp(total - cs) * dt

  for (int i = tid; i < P * ldn; i += kThreads) st_s[i] = 0.f;
  const float a_h = a[h];
  const float ds = d_skip != nullptr ? d_skip[h] : 0.f;
  const size_t row_x = (size_t)H * P;   // x / y stride between positions
  const size_t row_bc = (size_t)G * N;  // B / C stride between positions

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int qc = min(Q, S - c0);
    __syncthreads();  // the previous chunk is done with every buffer
    for (int j = tid; j < Q; j += kThreads)
      dt_s[j] = j < qc ? dt[((size_t)b * S + c0 + j) * H + h] : 0.f;
    for (int i = tid; i < Q * P; i += kThreads) {
      const int j = i / P, p = i - j * P;
      x_s[i] = j < qc ? repro::to_float(
                            x[((size_t)b * S + c0 + j) * row_x +
                              (size_t)h * P + p])
                      : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int j = i / N, n = i - j * N;
      b_s[j * ldn + n] = j < qc ? repro::to_float(
                                      bm[((size_t)b * S + c0 + j) * row_bc +
                                         (size_t)g * N + n])
                                : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int j = 0; j < Q; ++j) {
        run += dt_s[j] * a_h;
        cs_s[j] = run;
      }
    }
    __syncthreads();
    const float total = cs_s[Q - 1];
    for (int j = tid; j < Q; j += kThreads)
      we_s[j] = expf(total - cs_s[j]) * dt_s[j];

    for (int i0 = 0; i0 < qc; i0 += kStrip) {
      __syncthreads();  // the previous strip is done with c_s and w_s
      for (int i = tid; i < kStrip * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        c_s[r * ldn + n] = i0 + r < qc
            ? repro::to_float(cm[((size_t)b * S + c0 + i0 + r) * row_bc +
                                 (size_t)g * N + n])
            : 0.f;
      }
      __syncthreads();

      // scores of this strip: rows warp * 4 + ii, keys lane + 32 kk, only
      // the key blocks at or below the strip's last row
      const int n_kb = min(i0 / 32 + 1, (Q + 31) / 32);
      float sc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) sc[ii][kk] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) cv[ii] = c_s[(warp * 4 + ii) * ldn + n];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < n_kb) {
            const int j = min(lane + 32 * kk, Q - 1);
            const float bv = b_s[j * ldn + n];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
              sc[ii][kk] = fmaf(cv[ii], bv, sc[ii][kk]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + warp * 4 + ii;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = lane + 32 * kk;
          if (kk < n_kb && j < Q)
            w_s[(warp * 4 + ii) * Q + j] =
                (i < qc && j <= i)
                    ? sc[ii][kk] * expf(cs_s[i] - cs_s[j]) * dt_s[j]
                    : 0.f;
        }
      }
      __syncthreads();

      // y for this strip: rows warp * 4 + ii, columns p = lane + 32 pp
      float yd[4][4], yo[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) yd[ii][pp] = yo[ii][pp] = 0.f;
      const int j_end = min(qc, i0 + kStrip);
      for (int j = 0; j < j_end; ++j) {
        float wv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) wv[ii] = w_s[(warp * 4 + ii) * Q + j];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (pp < n_pp) {
            const float xv = x_s[j * P + min(lane + 32 * pp, P - 1)];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
              yd[ii][pp] = fmaf(wv[ii], xv, yd[ii][pp]);
          }
        }
      }
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) cv[ii] = c_s[(warp * 4 + ii) * ldn + n];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (pp < n_pp) {
            const float sv = st_s[min(lane + 32 * pp, P - 1) * ldn + n];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
              yo[ii][pp] = fmaf(cv[ii], sv, yo[ii][pp]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + warp * 4 + ii;
        if (i >= qc) continue;
        const float e = expf(cs_s[i]);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          const int p = lane + 32 * pp;
          if (p < P) {
            float val = yd[ii][pp] + e * yo[ii][pp];
            if (d_skip != nullptr) val += x_s[i * P + p] * ds;
            y[((size_t)b * S + c0 + i) * row_x + (size_t)h * P + p] =
                repro::from_float<T>(val);
          }
        }
      }
    }
    __syncthreads();  // every strip has read the old state

    // state = state * exp(total) + sum_j x[j] (x) B_j * we[j]; this thread
    // owns rows p = warp + 8 pa and columns n = lane + 32 nb
    float acc[kMaxP / 8][kMaxN / 32];
#pragma unroll
    for (int pa = 0; pa < kMaxP / 8; ++pa)
#pragma unroll
      for (int nb = 0; nb < kMaxN / 32; ++nb) acc[pa][nb] = 0.f;
    for (int j = 0; j < qc; ++j) {
      const float wj = we_s[j];
      float bv[kMaxN / 32];
#pragma unroll
      for (int nb = 0; nb < kMaxN / 32; ++nb)
        bv[nb] = nb < n_nb ? b_s[j * ldn + min(lane + 32 * nb, N - 1)] * wj
                           : 0.f;
#pragma unroll
      for (int pa = 0; pa < kMaxP / 8; ++pa) {
        if (warp + 8 * pa < P) {
          const float xv = x_s[j * P + warp + 8 * pa];
#pragma unroll
          for (int nb = 0; nb < kMaxN / 32; ++nb)
            if (nb < n_nb) acc[pa][nb] = fmaf(xv, bv[nb], acc[pa][nb]);
        }
      }
    }
    const float decay = expf(total);
#pragma unroll
    for (int pa = 0; pa < kMaxP / 8; ++pa) {
      const int p = warp + 8 * pa;
#pragma unroll
      for (int nb = 0; nb < kMaxN / 32; ++nb) {
        const int n = lane + 32 * nb;
        if (p < P && n < N)
          st_s[p * ldn + n] = st_s[p * ldn + n] * decay + acc[pa][nb];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    final_state[(((size_t)b * H + h) * P + p) * N + n] = st_s[p * ldn + n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* d_skip, void* y, void* final_state,
           int B, int S, int H, int G, int P, int N, int Q,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)P * (N + 1) + (size_t)Q * P +
                       (size_t)Q * (N + 1) + (size_t)kStrip * (N + 1) +
                       (size_t)kStrip * Q + 3 * (size_t)Q);
  cudaError_t err = repro::allow_smem(ssd_scan_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(d_skip),
      static_cast<T*>(y), static_cast<float*>(final_state), S, H, G, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------------------ "mma" variant

namespace ssd_mma {

namespace tc = repro::tc;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQ = 128;  // chunk: 8 warps x 16 query rows
constexpr int kP = 64;   // head dim

template <int N>
struct Cfg {
  static constexpr int kLdX = kP + 8;  // padded bf16 rows (ldmatrix)
  static constexpr int kLdN = N + 8;
  static constexpr size_t kXBytes = (size_t)kQ * kLdX * sizeof(bf16);
  static constexpr size_t kBBytes = (size_t)kQ * kLdN * sizeof(bf16);
  static constexpr size_t kStBytes = (size_t)kP * kLdN * sizeof(bf16);
  static constexpr size_t kSmem =
      kXBytes + 2 * kBBytes + kStBytes + 3 * kQ * sizeof(float);
  static constexpr int kStT = N / 16;  // 8-column state tiles of a warp
};

// x (two bf16) scaled by (w0, w1), rounded back to bf16.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float w0,
                                                 float w1) {
  const float2 f = tc::unpack_bf16(v);
  return tc::pack_bf16(f.x * w0, f.y * w1);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const bf16* __restrict__ bm,
               const bf16* __restrict__ cm, const float* __restrict__ d_skip,
               bf16* __restrict__ y, float* __restrict__ final_state, int S,
               int H, int G) {
  using C = Cfg<N>;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, c = 2 * (lane & 3);

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* x_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = reinterpret_cast<bf16*>(smem + C::kXBytes);
  bf16* c_s = reinterpret_cast<bf16*>(smem + C::kXBytes + C::kBBytes);
  bf16* st_s = reinterpret_cast<bf16*>(smem + C::kXBytes + 2 * C::kBBytes);
  float* cs_s = reinterpret_cast<float*>(smem + C::kXBytes +
                                         2 * C::kBBytes + C::kStBytes);
  float* dt_s = cs_s + kQ;  // dt (0 past the chunk's end)
  float* we_s = dt_s + kQ;  // exp(total - da_cs) dt

  // cs_s holds da_cs in the log2 domain, so every decay is one exp2
  const float a_log2 = a[h] * tc::kLog2e;
  const float ds = d_skip != nullptr ? d_skip[h] : 0.f;
  const size_t row_x = (size_t)H * kP;   // x / y stride between positions
  const size_t row_bc = (size_t)G * N;   // B / C stride between positions
  const bf16* x_bh = x + (size_t)b * S * row_x + (size_t)h * kP;
  const bf16* b_bg = bm + (size_t)b * S * row_bc + (size_t)g * N;
  const bf16* c_bg = cm + (size_t)b * S * row_bc + (size_t)g * N;
  const float* dt_bh = dt + (size_t)b * S * H + h;
  bf16* y_bh = y + (size_t)b * S * row_x + (size_t)h * kP;

  for (int i = tid; i < kP * C::kLdN / 8; i += kThreads)
    reinterpret_cast<uint4*>(st_s)[i] = make_uint4(0u, 0u, 0u, 0u);

  // this warp's tile of the fp32 state: rows p = 16 pb + .., columns
  // n = (N / 2) nh + ..
  const int pb = warp & 3, nh = warp >> 2;
  float st[C::kStT][4];
#pragma unroll
  for (int t = 0; t < C::kStT; ++t) st[t][0] = st[t][1] = st[t][2] = st[t][3] = 0.f;
  const int i0 = 16 * warp;  // this warp's query rows of the chunk

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int qc = min(kQ, S - c0);
    // the chunk's x, B and C rows, zero-filled past its end
    for (int i = tid; i < kQ * kP / 8; i += kThreads) {
      const int j = i / (kP / 8), k = i - j * (kP / 8);
      const bool valid = j < qc;
      tc::cp_async16(tc::smem_u32(x_s + j * C::kLdX + k * 8),
                     valid ? x_bh + (size_t)(c0 + j) * row_x + k * 8 : x,
                     valid);
    }
    for (int i = tid; i < kQ * N / 8; i += kThreads) {
      const int j = i / (N / 8), k = i - j * (N / 8);
      const bool valid = j < qc;
      const size_t off = (size_t)(c0 + j) * row_bc + k * 8;
      tc::cp_async16(tc::smem_u32(b_s + j * C::kLdN + k * 8),
                     valid ? b_bg + off : bm, valid);
      tc::cp_async16(tc::smem_u32(c_s + j * C::kLdN + k * 8),
                     valid ? c_bg + off : cm, valid);
    }
    tc::cp_async_commit();
    if (warp == 0) {
      // inclusive scan of dt a: lane owns positions 4 lane .. 4 lane + 3
      float v[4], cum[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * lane + k;
        v[k] = j < qc ? dt_bh[(size_t)(c0 + j) * H] : 0.f;
        run += v[k] * a_log2;
        cum[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const float base = incl - run;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * lane + k;
        const float cs = base + cum[k];
        cs_s[j] = cs;
        dt_s[j] = v[k];
        we_s[j] = tc::fast_exp2(total - cs) * v[k];
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();

    if (i0 < qc) {
      // y = exp(da_cs_i) C_i state^T + sum_{j <= i} W_ij x_j
      float yacc[kP / 8][4];
#pragma unroll
      for (int t = 0; t < kP / 8; ++t)
        yacc[t][0] = yacc[t][1] = yacc[t][2] = yacc[t][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t ca[4];
        tc::ldmatrix_x4(ca, tc::a_addr(c_s, C::kLdN, i0, kk * 16, lane));
#pragma unroll
        for (int pt = 0; pt < kP / 16; ++pt) {
          uint32_t sb[4];
          tc::ldmatrix_x4(sb, tc::bn_addr(st_s, C::kLdN, pt * 16, kk * 16,
                                          lane));
          tc::mma_bf16(yacc[2 * pt], ca, sb[0], sb[1]);
          tc::mma_bf16(yacc[2 * pt + 1], ca, sb[2], sb[3]);
        }
      }
      const float cs_r[2] = {cs_s[i0 + r], cs_s[i0 + r + 8]};
      const float e0 = tc::fast_exp2(cs_r[0]), e1 = tc::fast_exp2(cs_r[1]);
#pragma unroll
      for (int t = 0; t < kP / 8; ++t) {
        yacc[t][0] *= e0;
        yacc[t][1] *= e0;
        yacc[t][2] *= e1;
        yacc[t][3] *= e1;
      }
      const int kb_end = min(warp, (qc - 1) / 16);
      for (int kb = 0; kb <= kb_end; ++kb) {
        // scores of keys 16 kb .. 16 kb + 15: C_i . B_j
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t ca[4], bb[4];
          tc::ldmatrix_x4(ca, tc::a_addr(c_s, C::kLdN, i0, kk * 16, lane));
          tc::ldmatrix_x4(bb, tc::bn_addr(b_s, C::kLdN, kb * 16, kk * 16,
                                          lane));
          tc::mma_bf16(s[0], ca, bb[0], bb[1]);
          tc::mma_bf16(s[1], ca, bb[2], bb[3]);
        }
        // W = scores exp(da_cs_i - da_cs_j) dt_j for j <= i, else 0; the
        // exponent is clamped at 0 so no exp overflows above the diagonal
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = kb * 16 + 8 * t + c + (e & 1);
            const int ii = i0 + r + 8 * (e >> 1);
            const float dec =
                tc::fast_exp2(fminf(cs_r[e >> 1] - cs_s[jj], 0.f));
            s[t][e] = jj <= ii ? s[t][e] * dec * dt_s[jj] : 0.f;
          }
        const uint32_t wa[4] = {tc::pack_bf16(s[0][0], s[0][1]),
                                tc::pack_bf16(s[0][2], s[0][3]),
                                tc::pack_bf16(s[1][0], s[1][1]),
                                tc::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int pt = 0; pt < kP / 16; ++pt) {
          uint32_t xb[4];
          tc::ldmatrix_x4_trans(xb, tc::bk_addr(x_s, C::kLdX, kb * 16,
                                                pt * 16, lane));
          tc::mma_bf16(yacc[2 * pt], wa, xb[0], xb[1]);
          tc::mma_bf16(yacc[2 * pt + 1], wa, xb[2], xb[3]);
        }
      }
      // fp32 epilogue: + d_skip x, then the cast
#pragma unroll
      for (int t = 0; t < kP / 8; ++t)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int ii = i0 + r + 8 * hh;
          if (ii < qc) {
            const int p = 8 * t + c;
            float v0 = yacc[t][2 * hh], v1 = yacc[t][2 * hh + 1];
            if (d_skip != nullptr) {
              const float2 xv = tc::unpack_bf16(
                  *reinterpret_cast<const uint32_t*>(x_s + ii * C::kLdX + p));
              v0 += xv.x * ds;
              v1 += xv.y * ds;
            }
            *reinterpret_cast<__nv_bfloat162*>(
                y_bh + (size_t)(c0 + ii) * row_x + p) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
    }

    // state = state exp(total) + x^T (B o w), w folded into the x^T operand
    const float decay = tc::fast_exp2(cs_s[kQ - 1]);
#pragma unroll
    for (int t = 0; t < C::kStT; ++t) {
      st[t][0] *= decay;
      st[t][1] *= decay;
      st[t][2] *= decay;
      st[t][3] *= decay;
    }
    for (int kk = 0; kk * 16 < qc; ++kk) {
      uint32_t xa[4];
      tc::ldmatrix_x4_trans(xa, tc::at_addr(x_s, C::kLdX, kk * 16, pb * 16,
                                            lane));
      const float* w = we_s + kk * 16 + c;
      xa[0] = scale_bf16x2(xa[0], w[0], w[1]);
      xa[1] = scale_bf16x2(xa[1], w[0], w[1]);
      xa[2] = scale_bf16x2(xa[2], w[8], w[9]);
      xa[3] = scale_bf16x2(xa[3], w[8], w[9]);
#pragma unroll
      for (int nt = 0; nt < C::kStT / 2; ++nt) {
        uint32_t bb[4];
        tc::ldmatrix_x4_trans(bb, tc::bk_addr(b_s, C::kLdN, kk * 16,
                                              nh * (N / 2) + nt * 16, lane));
        tc::mma_bf16(st[2 * nt], xa, bb[0], bb[1]);
        tc::mma_bf16(st[2 * nt + 1], xa, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this chunk's tiles
    // the bf16 copy of the new state, for the next chunk's C state^T
#pragma unroll
    for (int t = 0; t < C::kStT; ++t) {
      const int p = pb * 16 + r, n = nh * (N / 2) + 8 * t + c;
      *reinterpret_cast<__nv_bfloat162*>(st_s + p * C::kLdN + n) =
          __floats2bfloat162_rn(st[t][0], st[t][1]);
      *reinterpret_cast<__nv_bfloat162*>(st_s + (p + 8) * C::kLdN + n) =
          __floats2bfloat162_rn(st[t][2], st[t][3]);
    }
  }

  float* fs = final_state + ((size_t)b * H + h) * kP * N;
#pragma unroll
  for (int t = 0; t < C::kStT; ++t) {
    const int p = pb * 16 + r, n = nh * (N / 2) + 8 * t + c;
    *reinterpret_cast<float2*>(fs + (size_t)p * N + n) =
        make_float2(st[t][0], st[t][1]);
    *reinterpret_cast<float2*>(fs + (size_t)(p + 8) * N + n) =
        make_float2(st[t][2], st[t][3]);
  }
}

template <int N>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* d_skip, void* y, void* final_state,
           int B, int S, int H, int G, cudaStream_t stream) {
  const size_t smem = Cfg<N>::kSmem;
  cudaError_t err = repro::allow_smem(ssd_mma_kernel<N>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two blocks an SM need the largest shared-memory carveout
  err = cudaFuncSetAttribute(ssd_mma_kernel<N>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B);
  ssd_mma_kernel<N><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), static_cast<const float*>(d_skip),
      static_cast<bf16*>(y), static_cast<float*>(final_state), S, H, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd_mma

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt, a, d_skip and the
// final state are float32; d_skip may be null.  Returns cudaGetLastError().
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm,
                               const void* d_skip, void* y, void* final_state,
                               int B, int S, int H, int G, int P, int N,
                               int Q, int dtype, void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a, bm, cm, d_skip, y, final_state, B, S, H,
                         G, P, N, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, d_skip, y, final_state, B,
                                 S, H, G, P, N, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The "mma" variant: bf16 x, B, C and y; P = 64, chunk 128, N = 64 or 128;
// dt, a, d_skip and the final state fp32, d_skip may be null.  Returns
// cudaGetLastError().
extern "C" int ssd_scan_mma_launch(const void* x, const void* dt,
                                   const void* a, const void* bm,
                                   const void* cm, const void* d_skip,
                                   void* y, void* final_state, int B, int S,
                                   int H, int G, int N, void* stream) {
  if (G < 1 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 128)
    return ssd_mma::launch<128>(x, dt, a, bm, cm, d_skip, y, final_state, B,
                                S, H, G, s);
  if (N == 64)
    return ssd_mma::launch<64>(x, dt, a, bm, cm, d_skip, y, final_state, B,
                               S, H, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
