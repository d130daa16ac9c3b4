// Warp-level tensor-core building blocks (mma.sync m16n8k16, bf16 in, fp32
// accumulate) shared by the bf16 paged-decode and SSD kernels
// (paged_attention.cu, ssd_scan.cu), sm_90a.  The cp.async, bf16-packing
// and exp2 helpers come from attn_tc.cuh, which the wgmma kernels share.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16" with .bf16), lane l of a warp,
// r = l / 4, c = 2 (l % 4):
//   A (16 x 16, row-major): a[0] = (r,     c..c+1), a[1] = (r + 8, c..c+1),
//                           a[2] = (r, c+8..c+9),   a[3] = (r + 8, c+8..c+9)
//   B (16 x 8, "col"):      b[0] = (k c..c+1, n r), b[1] = (k c+8..c+9, n r)
//   C (16 x 8, fp32):       d[0..1] = (r, c..c+1),  d[2..3] = (r + 8, c..c+1)
// so the C fragments of two neighbouring 8-column tiles, packed to bf16,
// are exactly the A fragment of one 16-deep k-step (flash attention's P).
//
// Operands come from shared memory through ldmatrix: .x4 loads four 8 x 8
// b16 matrices, lanes 8 i .. 8 i + 7 giving the row addresses of matrix i;
// without .trans lane l receives row r, columns c..c+1 of each matrix, with
// .trans rows c..c+1 of column r.  Every tile in shared memory is a
// row-major bf16 array whose row stride is a multiple of 16 bytes but not
// of 128 (rows padded by 16 bytes), so the eight rows of one matrix fall in
// distinct bank groups.
#pragma once

#include "attn_tc.cuh"

namespace repro {
namespace tc {

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += A B for one m16n8k16 step (bf16 operands, fp32 accumulator).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row address, for lane l, of an ldmatrix.x4 that reads a 16 x 16 tile at
// (row0, col0) of a row-major bf16 array with row stride ld, in the order
// the fragment wants it.
//  * A operand (non-trans): matrices (rows 0-7, cols 0-7), (8-15, 0-7),
//    (0-7, 8-15), (8-15, 8-15) -> a[0..3].
__device__ __forceinline__ uint32_t a_addr(const __nv_bfloat16* base, int ld,
                                           int row0, int col0, int lane) {
  return smem_u32(base + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}
//  * B operand stored n-major (rows = n, cols = k; K rows, B_ssd rows):
//    (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
//    -> b[0], b[1] of n-tile 0, then of n-tile 1.
__device__ __forceinline__ uint32_t bn_addr(const __nv_bfloat16* base, int ld,
                                            int n0, int k0, int lane) {
  return smem_u32(base + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                  ((lane >> 3) & 1) * 8);
}
//  * B operand stored k-major (rows = k, cols = n; V rows, x rows), read
//    with .trans: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
//    (k 8-15, n 8-15) -> b[0], b[1] of n-tile 0, then of n-tile 1.
__device__ __forceinline__ uint32_t bk_addr(const __nv_bfloat16* base, int ld,
                                            int k0, int n0, int lane) {
  return smem_u32(base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                  n0 + (lane >> 4) * 8);
}
//  * A operand stored k-major (rows = k, cols = m), read with .trans:
//    (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15)
//    -> a[0..3].
__device__ __forceinline__ uint32_t at_addr(const __nv_bfloat16* base, int ld,
                                            int k0, int m0, int lane) {
  return smem_u32(base + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                  ((lane >> 3) & 1) * 8);
}

// Split cluster barrier: arrive (relaxed) early, wait before the first
// access to another block's shared memory, which must not come before
// every block of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

}  // namespace tc
}  // namespace repro
