// The fp32 tile of the CIN forward (cin_fwd.cu): the 128 x 128 output tile
// that 256 threads compute as 8 x 8 register tiles from two k-major
// shared-memory operands, and the element of the outer product
// z[r, h*M + m] = h[r, h] * x0[r, m] that the forward builds in shared memory
// instead of reading it from device memory.  The backward kernels
// (cin_bwd.cu) run on the tensor cores (tc_tf32.cuh).
#pragma once

#include <cuda_runtime.h>

namespace cin {

constexpr int BM = 128;  // tile rows
constexpr int BN = 128;  // tile columns
constexpr int BK = 16;   // depth of one reduction chunk
constexpr int TM = 8;    // rows per thread: two groups of 4, BM/2 apart
constexpr int TN = 8;    // columns per thread: two groups of 4, BN/2 apart
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int ALD = BM + 4;  // row-operand tile row, padded: float4-aligned

// Thread (tr, tc) = (tid / 16, tid % 16) owns tile rows tile_row(tr, 0..7)
// and columns tile_col(tc, 0..7); a warp's float4 loads of either operand
// are then free of bank conflicts.
__device__ __forceinline__ int tile_row(int tr, int i) {
  return i < 4 ? tr * 4 + i : BM / 2 + tr * 4 + (i - 4);
}
__device__ __forceinline__ int tile_col(int tc, int j) {
  return j < 4 ? tc * 4 + j : BN / 2 + tc * 4 + (j - 4);
}

// acc[i][j] += sum_kk a[kk][tile_row(tr, i)] * b[kk][tile_col(tc, j)]
__device__ __forceinline__ void tile_fma(const float (*a)[ALD], const float (*b)[BN],
                                         int tr, int tc, float (&acc)[TM][TN]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&a[kk][tr * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&a[kk][BM / 2 + tr * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&b[kk][tc * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b[kk][BN / 2 + tc * 4]);
    const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void tile_zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// z[r, hi*M + m] for the row that h_row / x0_row point at
__device__ __forceinline__ float z_at(const float* h_row, const float* x0_row,
                                      int hi, int m) {
  return __ldg(h_row + hi) * __ldg(x0_row + m);
}

}  // namespace cin
