// Tensor-core building blocks shared by the bf16 attention kernels
// (flash_attention.cu and packed_prefill.cu), sm_90a only.
//
// One warpgroup (128 threads, four warps) owns a tile of 64 query rows.
// Scores S = Q K^T come from wgmma m64n64k16 with Q and K in shared memory;
// the output O += P V from wgmma m64n64k16 with P in registers (bf16, after
// the fp32 online-softmax rescale) and V in shared memory, read through the
// descriptor's transpose bit.  Every bf16 tile in shared memory has the
// layout that TMA writes with CU_TENSOR_MAP_SWIZZLE_128B: D / 64 column
// blocks of (rows x 128 B), each row's eight 16-byte chunks permuted by
// chunk ^ (row % 8), every block 1024-byte aligned.  A D = 64 bf16 row is
// exactly one 128-byte swizzle row.
//
// Fragment layout of an m64nN fp32 accumulator (PTX ISA, wgmma "Matrix D"):
// thread t = 32 w + l of the warpgroup holds, for each 8-column chunk j,
//   d[4j + 0], d[4j + 1]: row 16 w + l / 4,     columns 8 j + 2 (l % 4) + {0,1}
//   d[4j + 2], d[4j + 3]: row 16 w + l / 4 + 8, the same columns.
// So a thread owns two rows and each row is spread over the four threads
// of a quad (row statistics reduce with two shuffles).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {
namespace tc {

constexpr int kRows = 64;        // query rows of one warpgroup tile
constexpr int kKeys = 64;        // keys of one score tile
constexpr int kThreads = 128;    // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col) in a swizzled bf16 tile of `rows` rows.
__device__ __forceinline__ uint32_t sw128_offset(int rows, int row, int col) {
  const int block = col >> 6, chunk = (col >> 3) & 7;
  return block * rows * 128 + row * 128 + ((chunk ^ (row & 7)) << 4) +
         ((col & 7) << 1);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand starting
// at `addr`: 8-row groups 1024 B apart (stride byte offset); the leading
// byte offset is unused (a K-major k16 step stays inside one 128-byte row,
// and an MN-major n64 operand is one swizzle atom wide).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin accumulator registers at this point of the program, so the compiler
// moves no read or write of them across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_ACC32(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

#define REPRO_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, fp32) = (scale_d ? d : 0) + A (64 x 16) B (16 x 64); A and B
// both K-major in shared memory (Q rows, K rows).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) B (16 x 64); B is
// MN-major in shared memory (V rows: keys x head dim, head dim contiguous).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef REPRO_ACC32
#undef REPRO_D32

// S = Q K^T for one 64 x 64 tile: D / 16 k-steps, each 32 bytes further
// along the 128-byte rows (and into the next column block after four).
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t q_tile,
                                       uint32_t k_tile) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kRows * 128 + (kk & 3) * 32;
    wgmma_ss(s, sw128_desc(q_tile + off), sw128_desc(k_tile + off), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// O += P V for one tile of 64 keys: P (the exponentiated score fragment)
// becomes the bf16 A operand k-step by k-step (keys 16 kk .. 16 kk + 15
// are the fragment's chunks 2 kk and 2 kk + 1), V rows advance 16 keys
// (2048 bytes) a k-step, one n64 product per 64-wide column block.
template <int D>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 64][32],
                                              const float (&p)[32],
                                              uint32_t v_tile) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) fence_regs(o[cb]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[8 * kk + 0], p[8 * kk + 1]),
                           pack_bf16(p[8 * kk + 2], p[8 * kk + 3]),
                           pack_bf16(p[8 * kk + 4], p[8 * kk + 5]),
                           pack_bf16(p[8 * kk + 6], p[8 * kk + 7])};
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      wgmma_rs_tb(o[cb], a,
                  sw128_desc(v_tile + cb * kKeys * 128 + kk * 16 * 128));
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) fence_regs(o[cb]);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;  // exp2(-inf) = +0
}

// The fp32 online softmax of a thread's two rows (half 0: row l / 4, half
// 1: row l / 4 + 8), over score tiles in the log2 domain (masked = -inf).
// l is the thread's partial row sum until finish() adds up the quad.
struct OnlineSoftmax {
  float m[2], l[2];

  __device__ __forceinline__ void init() {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // Exponentiates s in place against the running maxima and returns in
  // corr the factor by which each row's output accumulator must shrink.
  // A row with nothing visible so far keeps m = -inf, l = 0 (corr 0 on an
  // accumulator that is still 0).  N = 32 is a 64-key tile (N / 4 chunks
  // of 8 keys).
  template <int N>
  __device__ __forceinline__ void step(float (&s)[N], float (&corr)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float base = mx == -INFINITY ? 0.f : mx;
      corr[h] = fast_exp2(m[h] - base);
      m[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x = fast_exp2(x - base);
          sum += x;
        }
      }
      l[h] = l[h] * corr[h] + sum;
    }
  }

  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }
};

// Scale the output accumulator rows by the softmax's correction factors.
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 64][32],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] *= corr[(i >> 1) & 1];
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

// TMA: the box at coordinates (c0, c1, c2, c3) of `map` into shared memory
// at dst, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

}  // namespace tc
}  // namespace repro
