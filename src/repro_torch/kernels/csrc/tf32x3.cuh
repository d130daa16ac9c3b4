// fp32-accurate products on the tensor cores: the 3xTF32 split, shared by
// the fp32 flash and packed-prefill kernels (flash_attention.cu,
// packed_prefill.cu), sm_90a.
//
// A TF32 operand keeps 10 of fp32's 23 mantissa bits, so one TF32 product
// is good to about 1e-3 relative: too coarse for the fp32 kernels'
// 3e-5 tolerance.  Split each operand in two TF32 numbers,
//   x = hi + lo,  hi = rna(x),  lo = rna(x - hi),
// where rna is cvt.rna.tf32.f32 (round to nearest, ties away from zero, to
// 10 mantissa bits).  Then
//   a b ~= a_hi b_hi + a_hi b_lo + a_lo b_hi,
// each product exact in the fp32 accumulator (11 x 11 significant bits),
// and the dropped a_lo b_lo is about 2^-22 of a b: fp32's own accuracy
// (CUTLASS's OpMultiplyAddFastF32).  Three mma.sync at the TF32 rate
// (495 TFLOP/s dense, so 165 for fp32-accurate work) against the card's
// 67 TFLOP/s of fp32 FMA.  The two small products go in first.
//
// mma.sync, not wgmma: TF32 wgmma reads B only K-major from shared memory,
// and P V would then need V transposed in shared memory.
//
// Fragment layouts (PTX ISA, "mma.m16n8k8" with .tf32), lane l of a warp,
// g = l / 4, t = l % 4:
//   A (16 x 8, row):  a[0] = (g, t), a[1] = (g + 8, t),
//                     a[2] = (g, t + 4), a[3] = (g + 8, t + 4)
//   B (8 x 8, col):   b[0] = (k t, n g), b[1] = (k t + 4, n g)
//   C (16 x 8, fp32): c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..2t+1)
// The C layout is that of one 8-column chunk of a wgmma accumulator
// (attn_tc.cuh), so an accumulator of n-tiles j, c[4j .. 4j + 3], works
// with OnlineSoftmax and rescale as they are.
//
// The order of the k index inside a step is free (the product sums over
// it), and both products use that freedom:
// * Q K^T: k index t stands for column 2t of the step's eight and t + 4
//   for 2t + 1, so a thread's two A values of a row, and its two B
//   values, are neighbours: one 64-bit shared load each.
// * P V: P is the A operand, and the score fragment gives a thread keys
//   2t and 2t + 1 of an 8-key chunk where A wants k indices t and t + 4;
//   with k index t standing for key 2t and t + 4 for key 2t + 1 the score
//   fragment is the A fragment as it lies, and the V operand reads rows
//   2t and 2t + 1.
//
// Shared memory: 32- and 64-bit loads (ldmatrix moves 16-bit tiles) from
// row-major fp32 tiles.  Q and K rows are ld_qk(D) = D + 8 words apart
// (8 mod 32): the 16 lanes of each half-warp's 64-bit load cover banks
// 8 g + 2 t .. 8 g + 2 t + 1, all 32 once.  V rows are ld_v(D) = D + 4
// apart (4 mod 32): a V load hits bank 8 t + g (+ the column base), 32
// distinct banks.
//
// The three products of one n-tile add into one accumulator, so each
// k-step issues every n-tile's first product, then every second, then
// every third: consecutive mma.sync never wait on each other.
#pragma once

#include <stdint.h>

namespace repro {
namespace tf32 {

// Row strides (words) of the fp32 Q / K and V tiles of D columns.
__host__ __device__ constexpr int ld_qk(int d) { return d + 8; }
__host__ __device__ constexpr int ld_v(int d) { return d + 4; }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (lo the rounded remainder).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += A B for one m16n8k8 step (TF32 operands, fp32 accumulator).
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A split A fragment (hi and lo of a[0..3]) and B fragment (b[0..1]).
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

// d[j] += A B[j] for N n-tiles in fp32 accuracy: the two small products,
// then the large one, each pass over every n-tile.
template <int N>
__device__ __forceinline__ void mma3(float* d, const FragA& a,
                                     const FragB (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    mma_tf32(*reinterpret_cast<float(*)[4]>(d + 4 * j), a.lo[0], a.lo[1],
             a.lo[2], a.lo[3], b[j].hi[0], b[j].hi[1]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    mma_tf32(*reinterpret_cast<float(*)[4]>(d + 4 * j), a.hi[0], a.hi[1],
             a.hi[2], a.hi[3], b[j].lo[0], b[j].lo[1]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    mma_tf32(*reinterpret_cast<float(*)[4]>(d + 4 * j), a.hi[0], a.hi[1],
             a.hi[2], a.hi[3], b[j].hi[0], b[j].hi[1]);
}

// S (16 x KEYS) = Q K^T for one warp: q points at the warp's first query
// row, k at the tile's first key, both at stride ld_qk(D).
// s[4 j .. 4 j + 3] is the C fragment of keys 8 j .. 8 j + 7.
template <int D, int KEYS>
__device__ __forceinline__ void scores(float (&s)[KEYS / 2],
                                       const float* __restrict__ q,
                                       const float* __restrict__ k,
                                       int lane) {
  constexpr int ld = ld_qk(D);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) s[i] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 8) {
    const float2 q0 = *reinterpret_cast<const float2*>(q + g * ld + k0 + 2 * t);
    const float2 q1 =
        *reinterpret_cast<const float2*>(q + (g + 8) * ld + k0 + 2 * t);
    FragA a;
    a.set(q0.x, q1.x, q0.y, q1.y);
    FragB b[KEYS / 8];
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      const float2 kv = *reinterpret_cast<const float2*>(
          k + (8 * j + g) * ld + k0 + 2 * t);
      b[j].set(kv.x, kv.y);
    }
    mma3(s, a, b);
  }
}

// O (16 x D) += P (16 x KEYS) V for one warp: p is the score fragment
// after the softmax (as scores() lays it out), v points at the tile's
// first key row, stride ld_v(D).  o[4 j .. 4 j + 3] is the C fragment of
// columns 8 j .. 8 j + 7; the n-tiles go eight at a time.
template <int D, int KEYS>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 2],
                                              const float (&p)[KEYS / 2],
                                              const float* __restrict__ v,
                                              int lane) {
  constexpr int ld = ld_v(D);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KEYS / 8; ++kk) {
    FragA a;  // k index t <- key 2t, k index t + 4 <- key 2t + 1
    a.set(p[4 * kk + 0], p[4 * kk + 2], p[4 * kk + 1], p[4 * kk + 3]);
    const float* vb = v + (8 * kk + 2 * t) * ld + g;
#pragma unroll
    for (int j0 = 0; j0 < D / 8; j0 += 8) {
      FragB b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j].set(vb[8 * (j0 + j)], vb[ld + 8 * (j0 + j)]);
      mma3(o + 4 * j0, a, b);
    }
  }
}

// Scale the accumulator rows by the softmax's correction factors (corr[0]
// for row g, corr[1] for row g + 8).
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= corr[(i >> 1) & 1];
}

}  // namespace tf32
}  // namespace repro
