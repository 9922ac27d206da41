// Tensor-core building blocks of the 3xTF32 kernels (cin_bwd.cu, ce_fwd.cu
// and ce_bwd.cu through ce_tc.cuh, attn_bwd_tc.cuh): every piece of inline
// PTX they use, as small device functions.
//
// 3xTF32 keeps near-fp32 accuracy on the TF32 tensor cores.  Each fp32
// operand x is split into big = tf32(x) (round to nearest, ties away, to
// 10 mantissa bits) and small = tf32(x - big), so x = big + small to about
// 2^-22 of |x|.  A product is then a_s*b_b + a_b*b_s + a_b*b_b (small x small
// dropped, under 2^-22 of the product), each term exact in the tensor core
// and accumulated in fp32: three MMAs for one fp32 product, at a third of
// the TF32 rate (165 of 495 TFLOP/s on the H100 SXM).  Where an operand is
// already bf16 (set_precision("bf16")), TF32 holds it exactly, its small
// part is 0, and one MMA is exact.
//
// The MMA is the warp-level mma.sync m16n8k8 (row.col, f32 += tf32 * tf32)
// with the PTX ISA's fragment layout: lane = 4 * group + tig (group 0..7,
// thread in group 0..3) holds
//   A (16 x 8, [row][k]): a0 (group, tig), a1 (group + 8, tig),
//                         a2 (group, tig + 4), a3 (group + 8, tig + 4);
//   B (8 x 8, [k][col]):  b0 (tig, group), b1 (tig + 4, group);
//   C (16 x 8):           c0 (group, 2 tig), c1 (group, 2 tig + 1),
//                         c2 (group + 8, 2 tig), c3 (group + 8, 2 tig + 1).
// Each k8 step's product is summed from zero (the first MMA takes a zero
// accumulator operand, mma_z) and added to the running sum in fp32 (mma3_add,
// below).  Operand tiles come from device memory by cp.async
// into shared memory (16-byte .cg copies where the source is aligned, 4-byte
// .ca ones elsewhere), zero-filled past the source's valid bytes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The tests' host emulation of the CUDA runtime defines TC_TF32_EMULATED and
// brings its own host versions of the functions below.
#ifndef TC_TF32_EMULATED

namespace tc {

// cvt.rna.tf32.f32: x rounded to TF32, as an fp32 bit pattern
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a * b over one m16n8k8 tile (fragments as above)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b over one m16n8k8 tile, summed from zero: the accumulator input
// is a zero operand, so d needs no registers zeroed first
__device__ __forceinline__ void mma_z(float (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src (16-byte aligned) to dst; only the first `bytes` (0..16)
// are read, the rest of dst is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes from src to dst, or a zero when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tc

#endif  // TC_TF32_EMULATED

namespace tc {

// acc += a * b in 3xTF32 (one MMA under "bf16", where the small halves are
// 0), the product summed from zero and added to acc in fp32, rounded to
// nearest.  The tensor cores' own fp32 accumulation does not round to
// nearest, so a long sum kept in the MMA accumulator drifts: cin_dw's dW over
// 40960 rows then failed chip_smoke.py's float64 gate (twice the plain fp32
// product's error); with one fp32 add a k8 step it errs 0.3-0.4x as much as
// the plain product (an NVIDIA H100 80GB HBM3 at 700 W).
// The three products are summed in the tensor core, the small terms first,
// the big product last.
__device__ __forceinline__ void mma3_add(float (&acc)[4], const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                         const uint32_t (&bs)[2], bool one = false) {
  float d[4];
  if (one) {
    mma_z(d, ab, bb);
  } else {
    mma_z(d, as, bb);
    mma(d, ab, bs);
    mma(d, ab, bb);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += d[q];
}

}  // namespace tc
