// Shared pieces of the softmax cross-entropy kernels (ce_fwd.cu, ce_bwd.cu).
//
// The forward (ce_fwd.cu) works on 128 x 128 tiles of logits S[r, v] =
// h[r, :] . W[v, :] + b[v] (rows r of the hidden state h [B, K], vocabulary
// columns v of one head W [V, K]) that 256 threads compute as 8 x 8 register
// tiles, with the whole depth K <= KMAX in shared memory: fp32 FMAs on the
// CUDA cores.  The backward (ce_bwd.cu) takes its products to the tensor
// cores in 3xTF32 (tc_tf32.cuh) and uses only the helpers below that are not
// tile products.  Under set_precision("bf16") each operand is first rounded
// to bf16 (round to nearest even), which is what the TPU kernel's bf16 dots
// did.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// the dynamic shared memory of every CE kernel
extern __shared__ __align__(16) float ce_smem[];

namespace ce {

constexpr int BM = 128;      // tile rows (batch rows in the forward)
constexpr int BN = 128;      // tile columns (vocabulary columns in the forward)
constexpr int BK = 16;       // depth unrolled at once; K is padded to it
constexpr int KMAX = 64;     // largest hidden width K the kernels take
constexpr int THREADS = 256;
constexpr int LD = BN + 4;   // padded row of a 128-wide tile: float4-aligned
static_assert(BM == BN && THREADS == (BM / 8) * (BN / 8), "8 x 8 per thread");

// Thread (tr, tc) = (tid / 16, tid % 16) owns tile rows tile_row(tr, 0..7) and
// columns tile_col(tc, 0..7): two groups of 4, 64 apart, so a warp's float4
// loads of either operand are free of bank conflicts.
__device__ __forceinline__ int tile_row(int tr, int i) {
  return i < 4 ? tr * 4 + i : BM / 2 + tr * 4 + (i - 4);
}
__device__ __forceinline__ int tile_col(int tc, int j) {
  return j < 4 ? tc * 4 + j : BN / 2 + tc * 4 + (j - 4);
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// An operand of a product: x itself, or x rounded to bf16 under "bf16".
__device__ __forceinline__ float operand(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Rows below this take part; `nv` is a device scalar (nullptr: all B rows).
__device__ __forceinline__ int valid_rows(const int* nv, int B) {
  if (nv == nullptr) return B;
  const int n = __ldg(nv);
  return n < 0 ? 0 : (n < B ? n : B);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < depth} a[k][tile_row(tr, i)] * b[k][tile_col(tc, j)]:
// both operands k-major in shared memory (rows lda, ldb apart), depth a
// multiple of BK.
__device__ __forceinline__ void mma_kk(const float* a, int lda, const float* b, int ldb,
                                       int depth, int tr, int tc, float (&acc)[8][8]) {
  for (int k0 = 0; k0 < depth; k0 += BK) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float* ak = a + (k0 + kk) * lda;
      const float* bk = b + (k0 + kk) * ldb;
      const float4 a0 = ld4(ak + tr * 4), a1 = ld4(ak + BM / 2 + tr * 4);
      const float4 b0 = ld4(bk + tc * 4), b1 = ld4(bk + BN / 2 + tc * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

}  // namespace ce
