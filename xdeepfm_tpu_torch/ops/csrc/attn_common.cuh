// Shared pieces of the attention kernels (sa_fwd.cu, sa_bwd.cu, ab_fwd.cu,
// ab_bwd.cu, sa_ablate.cu) and of their two routines, attn_fwd_tc.cuh (the
// forward: sa_fwd.cu, sa_ablate.cu, ab_fwd.cu) and attn_bwd_tc.cuh (the
// backward: sa_bwd.cu, ab_bwd.cu).
//
// The head width is a template parameter (1..MAX_DH), so per-lane operands
// and accumulators stay in registers.  The routines give each (query, key)
// pair to one lane of a warp, at the positions of the m16n8k8 tensor-core
// fragments: the backward runs its products over S in 3xTF32 on the tensor
// cores (tc_tf32.cuh), the forward in fp32 FMAs.  ab_fwd.cu runs its
// attention through the forward routine, ab_bwd.cu through the backward's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

// the dynamic shared memory of every attention kernel
extern __shared__ __align__(16) float attn_smem[];

namespace attn {

constexpr int MAX_DH = 16;       // widest head the kernels are instantiated for
constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM_BYTES = 232448;  // dynamic shared memory one Hopper block may take
// the most a block may take for two to share an SM (228 KB, 1 KB reserved a block)
constexpr int TWO_BLOCK_SMEM_BYTES = 115712;

// One thread per query (or key) column, at most MAX_THREADS; a block of
// fewer than S threads walks the columns in strides of blockDim.x.
__host__ __device__ inline int threads_for(int S) {
  const int t = (S + 31) / 32 * 32;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

// An operand of a product: x itself, or x rounded to bf16 (nearest even)
// under set_precision("bf16"), which is what the TPU kernel's bf16 dots did.
__device__ __forceinline__ float operand(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Sum over the block of one value per thread, the same on every thread and
// in a fixed order (butterfly within each warp, then warps in order):
// bit-equal from run to run.  `red` holds MAX_THREADS / 32 floats.  Every
// thread of the block must call it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

// Max over the block, as block_sum.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x) / 32; ++w) total = fmaxf(total, red[w]);
  __syncthreads();
  return total;
}

// The forward routine's key order in shared memory: key j = 8 b + r of
// block b at slot 8 b + 2 (r % 4) + r / 4, so that a lane's keys tig and
// tig + 4 are one 8-byte word (attn_fwd_tc.cuh).
__host__ __device__ inline int key_slot(int j) {
  const int r = j & 7;
  return (j - r) + 2 * (r & 3) + (r >> 2);
}

}  // namespace attn

// The exp of both routines.
namespace attn_tc {

#ifdef TC_TF32_EMULATED
inline float ex2(float x) { return std::exp2(x); }
#else
// 2^x on the special-function units
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
#endif

}  // namespace attn_tc

// `return fn<DH>(args...)` for the runtime head width dh in 1..MAX_DH, else
// cudaErrorInvalidValue (the wrappers check dh first).
#define ATTN_DISPATCH_DH(dh, fn, ...)                    \
  switch (dh) {                                          \
    case 1: return fn<1>(__VA_ARGS__);                   \
    case 2: return fn<2>(__VA_ARGS__);                   \
    case 3: return fn<3>(__VA_ARGS__);                   \
    case 4: return fn<4>(__VA_ARGS__);                   \
    case 5: return fn<5>(__VA_ARGS__);                   \
    case 6: return fn<6>(__VA_ARGS__);                   \
    case 7: return fn<7>(__VA_ARGS__);                   \
    case 8: return fn<8>(__VA_ARGS__);                   \
    case 9: return fn<9>(__VA_ARGS__);                   \
    case 10: return fn<10>(__VA_ARGS__);                 \
    case 11: return fn<11>(__VA_ARGS__);                 \
    case 12: return fn<12>(__VA_ARGS__);                 \
    case 13: return fn<13>(__VA_ARGS__);                 \
    case 14: return fn<14>(__VA_ARGS__);                 \
    case 15: return fn<15>(__VA_ARGS__);                 \
    case 16: return fn<16>(__VA_ARGS__);                 \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
