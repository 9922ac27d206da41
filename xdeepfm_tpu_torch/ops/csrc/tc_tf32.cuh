// Tensor-core building blocks of the 3xTF32 kernels (cin_fwd.cu, cin_bwd.cu,
// ce_fwd.cu and ce_bwd.cu through ce_tc.cuh, attn_bwd_tc.cuh): every piece
// of inline PTX they use, as small device functions.
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
// Two MMAs.  The warp-level mma.sync m16n8k8 (row.col, f32 += tf32 * tf32;
// cin_bwd.cu, the CE and attention-backward kernels) with the PTX ISA's
// fragment layout: lane = 4 * group + tig (group 0..7, thread in group
// 0..3) holds
//   A (16 x 8, [row][k]): a0 (group, tig), a1 (group + 8, tig),
//                         a2 (group, tig + 4), a3 (group + 8, tig + 4);
//   B (8 x 8, [k][col]):  b0 (tig, group), b1 (tig + 4, group);
//   C (16 x 8):           c0 (group, 2 tig), c1 (group, 2 tig + 1),
//                         c2 (group + 8, 2 tig), c3 (group + 8, 2 tig + 1).
// And the warpgroup MMA wgmma.mma_async m64nNk8 (cin_fwd.cu): the four
// warps of a warpgroup together multiply a 64 x 8 A, which they hold in
// registers, warp w rows 16 w .. 16 w + 15 in the m16n8k8 A layout above, by
// an 8 x N B read from shared memory through a descriptor (K-major, the
// only layout tf32 takes), into a 64 x N fp32 D that warp w holds as the
// m16n8k8 C layout of its 16 rows, one C fragment for each 8 columns:
// d[4 j + q] is column 8 j + the C fragment's column of q.  The MMA runs
// asynchronously: its A and D registers may be touched only after a
// wait_group that covers it.  B's descriptor (wgmma_desc) gives a tile of
// 8-row x 16-byte core matrices, each 128 contiguous bytes (rows 16 bytes
// apart, no swizzle): LBO the bytes from a core matrix to the next along K,
// SBO to the next 8 rows along N.
// Each k8 step's product is summed from zero (the first MMA takes a zero
// accumulator operand, mma_z) and added to the running sum in fp32 (mma3_add,
// below).  Operand tiles come from device memory by cp.async
// into shared memory (16-byte .cg copies where the source is aligned, 4-byte
// .ca ones elsewhere), zero-filled past the source's valid bytes, or, for
// the wgmma kernel, by bulk copies (cp.async.bulk) that complete a
// transaction count on an mbarrier in shared memory.
// The CIN's bf16 mode (cin_pallas.set_cin_precision("bf16")) takes the
// 16-bit forms instead: operands rounded to bf16 in pairs (bf16x2, or
// multiplied as pairs by mul_bf16x2), wgmma m64nNk16 bf16 with A from
// registers (cin_fwd.cu) or from shared memory (wgmma_bf16_ss, cin_bwd.cu)
// over K-major bf16 tiles (bf16_tile_*), chunks of k16 steps summed in the
// tensor cores from zero and added in fp32 by the same rule.  The CE's bf16
// mode (ce_bf16.cu) adds m64n64 and B read MN-major (wgmma_bf16_mn,
// bf16_tile_desc_mn), so one bf16 tile serves as K-major B of one product
// and MN-major B of the next.  The small attention's bf16 mode
// (sa_bf16.cu) takes the warp-level mma.sync m16n8k16 and m16n8k8 bf16
// (mma_bf16, mma_bf16_k8_z) with B fragments read from the same tiles.
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

// c (= or +=) a * b over one m16n8k16 tile of bf16 operands, fp32 sums
// (sa_bf16.cu's products over a walked chunk): a is the m16n8k16 A fragment
// (a warp's 16 rows of wgmma_bf16's A), b the B fragment, b0 (k 2 tig and
// 2 tig + 1, n group) and b1 (k 2 tig + 8 and + 9, n group), the lower k in
// the low half; c the m16n8k8 C layout above.  mma_bf16_z sums from zero.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16_z(float (&d)[4], const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// d = a * b over one m16n8k8 tile of bf16 operands, summed from zero: a
// (row group, k 2 tig and 2 tig + 1), (row group + 8, ...); b (k 2 tig and
// 2 tig + 1, n group)
__device__ __forceinline__ void mma_bf16_k8_z(float (&d)[4], const uint32_t (&a)[2],
                                              const uint32_t (&b)[1]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]), "f"(0.f));
}

// cvt.rn.bf16x2.f32: lo and hi rounded to bf16 (nearest, ties to even), lo
// in the low half, as the 16-bit MMAs read a pair of neighbouring k
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// mul.rn.bf16x2: the bf16 pairs a and b multiplied half by half, each
// product rounded to bf16 (nearest, ties to even) once
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
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


// ---- Hopper: the warpgroup MMA, mbarriers and bulk copies (cin_fwd.cu) ----

// mbarrier.init: `count` arrivals complete each phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (the copies)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` more of the phase's transactions
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory to shared memory; completes that many transactions on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bar.sync on named barrier `id` (1..15) for the `threads` threads that use it
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// setmaxnreg: a warpgroup's registers a thread raised or lowered to R
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an MMA's registers across it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TC_D16(i) TC_D4(i), TC_D4(i + 4), TC_D4(i + 8), TC_D4(i + 12)

// d (= or +=, as acc) a * B over one m64nNk8 tile: A from the four
// registers a (TF32 bits) of each thread, B through its descriptor
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                      int acc);

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : TC_D16(0), TC_D16(16), TC_D16(32), TC_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (= or +=, as acc) a * B over one m64nNk16 bf16 tile: A from the four
// registers a (bf16 pairs, each warp's 16 rows in the m16n8k16 A layout), B
// through its descriptor, K-major (trans-b 0), core matrices of 8 rows x 8
// bf16
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : TC_D16(0), TC_D16(16), TC_D16(32), TC_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (= or +=, as acc) A * B over one m64nNk16 bf16 tile, both operands from
// shared memory through their descriptors, K-major (trans-a 0, trans-b 0):
// A's 64 rows and B's N columns each in core matrices of 8 rows x 8 bf16
template <int N>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16_ss<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                   int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : TC_D16(0), TC_D16(16), TC_D16(32), TC_D16(48)
      : "l"(a), "l"(b), "r"(acc));
}

// d (= or +=, as acc) a * B over one m64nNk16 bf16 tile: A from the four
// registers a as in wgmma_bf16, B through its descriptor MN-major (trans-b
// 1): B's N columns contiguous, 8 to a 16-byte core-matrix row, one row for
// each k (the CE kernels' bf16 tiles read across, bf16_tile_desc_mn)
template <int N>
__device__ __forceinline__ void wgmma_bf16_mn(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16_mn<16>(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : TC_D4(0), TC_D4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_mn<32>(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : TC_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_mn<48>(float (&d)[24], const uint32_t (&a)[4],
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n"
      "}\n"
      : TC_D16(0), TC_D4(16), TC_D4(20)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_mn<64>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : TC_D16(0), TC_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                                  int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : TC_D16(0), TC_D16(16)
      : "l"(a), "l"(b), "r"(acc));
}

#undef TC_D16
#undef TC_D4

}  // namespace tc

#endif  // TC_TF32_EMULATED

namespace tc {

// The descriptor of a K-major, unswizzled wgmma operand tile at p in shared
// memory: core matrices lbo bytes apart along K, sbo bytes apart along N.
__host__ __device__ inline uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// The bf16 kernels' operand tiles (cin_fwd.cu's W stages, cin_bwd.cu's g
// tiles and W stages): K-major, `rows` rows (N of B, M of A; a multiple of
// 8) by kw bf16 along K (a multiple of 16), copied into shared memory as
// they stand in device memory: unswizzled core matrices of 8 rows x 16 bytes
// (8 k), ((row / 8) (kw / 8) + k / 8) 128 bytes on.  (A 128-byte swizzled
// layout ran no faster in either kernel; PERF.md section 6.)
// the byte offset of element (row, k)
__host__ __device__ inline uint32_t bf16_tile_off(int row, int k, int kw) {
  return ((row / 8) * (kw / 8) + k / 8) * 128 + (row % 8) * 16 + (k % 8) * 2;
}
// the inverse for a 16-byte chunk (8 k): the row and first k of the chunk
// at byte offset o
__host__ __device__ inline void bf16_tile_chunk(int o, int kw, int& row, int& k) {
  const int cm = o / 128;
  row = cm / (kw / 8) * 8 + (o % 128) / 16;
  k = cm % (kw / 8) * 8;
}
// the descriptor of k16 step s of rows row0.. (a multiple of 8) of the tile
// at shared address addr: core matrices 128 bytes apart along K (LBO), 16 kw
// along the rows (SBO)
__host__ __device__ inline uint64_t bf16_tile_desc(uint32_t addr, int row0, int s, int kw) {
  return wgmma_desc(addr + bf16_tile_off(row0, 16 * s, kw), 128, 16 * kw);
}

// The same tiles read MN-major, as the B operand of wgmma_bf16_mn: the
// tile's rows are the product's reduction axis and its kw columns its N.
// The descriptor of k16 step s (rows 16 s ..): core matrices 128 bytes
// apart along N (SBO), 16 kw bytes apart along the rows (LBO), the
// unswizzled MN-major layout's strides
__host__ __device__ inline uint64_t bf16_tile_desc_mn(uint32_t addr, int s, int kw) {
  return wgmma_desc(addr + bf16_tile_off(16 * s, 0, kw), 16 * kw, 128);
}

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
