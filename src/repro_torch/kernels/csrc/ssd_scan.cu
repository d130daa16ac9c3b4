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
// (B, H, P, N) in fp32.  Everything inside is fp32, and d_skip is added in the
// fp32 epilogue before the cast (the model's ssd_chunked_ref order).
//
// Grid: one block per (head, batch) that walks the chunks in order, as the
// TPU grid's sequential chunk axis did; the (P, N) state stays in shared
// memory across chunks.  B * H blocks (256 at B = 4, H = 64) for 132 SMs is
// only about two waves; splitting the chunk walk (state passing between
// blocks) is later work.
//
// Shared memory: at Q = 128, P = 64, N = 128 the chunk's x and B plus the
// state take ~140 KB in fp32, so the Q x Q score matrix is never held whole:
// it is built in strips of kStrip query rows (with that strip's C), each strip
// consumed into y before the next.  Above 48 KB the launch raises the block's
// dynamic shared-memory limit.
//
// exp() only where it is finite: the decay factor exp(da_cs[i] - da_cs[j])
// is evaluated for j <= i only (above the diagonal the exponent is positive
// and can pass 88, and exp * 0 would be NaN); every other exponent is <= 0.
//
// A ragged last chunk (S not a multiple of Q) is zero-filled past the end:
// dt = 0 there, so it neither decays nor adds to the state, and its rows are
// not written.
//
// What bounds it on H100: ~2 * B * S * H * (Q N + Q P + 2 P N) operations
// (score strips, their product with x, the state's read and update) against
// one read of x, B, C and one write of y: operations.  This first version
// computes with fp32 FMAs from shared memory, 4 x 4 register tiles per thread.
#include "common.cuh"

namespace {

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
