// Small-sequence attention for the attention-pooled CIN, forward (sa_fwd),
// for Hopper (sm_90a), behind a plain C interface that
// ops/attention_cuda.py loads with ctypes.  Per pair g of G (batch * head),
// on dh-major operands q, k, v [G, dh, S] (fp32):
//
//   s[i, j]   = sum_d q[d, i] k[d, j]              (unscaled)
//   m[i]      = max_j s[i, j]
//   e[i, j]   = exp((s[i, j] - m[i]) * scale)
//   inv_z[i]  = 1 / sum_j e[i, j]
//   o[d, i]   = (sum_j v[d, j] e[i, j]) * inv_z[i]
//
// Under bf16 every operand of a product (q, k, v, e) is rounded to bf16
// first and the sums stay fp32, as the TPU kernel's bf16 dots.
//
// Replaces: xdeepfm_tpu/ops/attention_pallas.py _sa_fwd / _fwd_kernel.
//
// Bound: operations.  At the V2 training shape (G = 8192, dh = 5, S = 256)
// the least work is the two [S, S] products, 4 * G * S^2 * dh = 10.7 GFLOP,
// and G * S^2 = 0.54 G exps, against 84 MB of operands.  The [S, S] scores
// must never reach device memory (2.1 GB a launch at that shape), so:
//   * one block owns one pair: its k and v sit in shared memory, 2 * dh * S
//     floats (10 KB at dh = 5, S = 256);
//   * one thread owns one query column i: its q column and o accumulators
//     live in registers, dh of them, dh being a template parameter; it walks
//     every key j, whose k and v columns all threads of the block read at
//     once (shared-memory broadcasts);
//   * the row max is taken in a first sweep and exp, sum and the v-product in
//     a second, so e is exp((s - m) * scale) with the final max, as the TPU
//     kernel computed it (no online rescaling).
// The TPU kernel tiled 8-16 pairs per grid step along the sublanes and padded
// G to a multiple of 8 (a Mosaic rule); a block here takes one pair, so any G.

#include <cfloat>
#include <cmath>

#include "attn_common.cuh"

namespace {

using attn::operand;

template <int DH>
__global__ void __launch_bounds__(attn::MAX_THREADS)
sa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ m_out,
              float* __restrict__ z_out, int S, float scale, int bf16) {
  float* ks = attn_smem;  // [DH][S]
  float* vs = ks + DH * S;  // [DH][S]
  const long long base = static_cast<long long>(blockIdx.x) * DH * S;
  for (int e = threadIdx.x; e < DH * S; e += blockDim.x) {
    ks[e] = operand(__ldg(k + base + e), bf16);
    vs[e] = operand(__ldg(v + base + e), bf16);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    float qi[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qi[d] = operand(__ldg(q + base + d * S + i), bf16);
    float mx = -FLT_MAX;
    for (int j = 0; j < S; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qi[d], ks[d * S + j], s);
      mx = fmaxf(mx, s);
    }
    float sum = 0.f;
    float acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    for (int j = 0; j < S; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qi[d], ks[d * S + j], s);
      const float e = __expf((s - mx) * scale);
      sum += e;
      const float ep = operand(e, bf16);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(vs[d * S + j], ep, acc[d]);
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[base + d * S + i] = acc[d] * inv;
    m_out[static_cast<long long>(blockIdx.x) * S + i] = mx;
    z_out[static_cast<long long>(blockIdx.x) * S + i] = inv;
  }
}

template <int DH>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* m, float* z,
               int G, int S, float scale, int bf16, cudaStream_t st) {
  auto kern = sa_fwd_kernel<DH>;
  const int smem = 2 * DH * S * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&q, &k, &v, &o, &m, &z, &S, &scale, &bf16};
  err = cudaLaunchKernel(kern, dim3(G), dim3(attn::threads_for(S)), args,
                         static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, contiguity, G >= 1, 1 <= dh <= 16,
// S >= 1, the shared memory and 32-bit offsets within a pair, and allocated
// o [G, dh, S], m and inv_z [G, S].
int sa_fwd(const void* q, const void* k, const void* v, void* o, void* m, void* z, int G,
           int dh, int S, float scale, int bf16, void* stream) {
  ATTN_DISPATCH_DH(dh, launch_fwd, static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<float*>(o),
                   static_cast<float*>(m), static_cast<float*>(z), G, S, scale, bf16,
                   static_cast<cudaStream_t>(stream))
}

const char* sa_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
