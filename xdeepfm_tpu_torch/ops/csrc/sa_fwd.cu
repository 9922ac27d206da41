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
// the two [S, S] products are 4 G S^2 dh = 10.7 GFLOP (0.160 ms at the fp32
// rate; 0.065 ms were they both in 3xTF32 at a third of the TF32 rate) and
// G S^2 = 0.54 G exps, 0.128 ms on the special-function units.  The [S, S]
// scores never reach device memory (2.1 GB a launch at that shape).  Design:
// one block a pair, its k and v staged in shared memory (2 dh KP floats, KP
// = S rounded up to 8: 10 KB at dh 5, S 256), a warp per 32 queries (16
// above dh 8), and the head's forward in attn_fwd_tc.cuh: register-blocked
// fp32 FMAs for both products (4 queries and 2 keys a lane), in one pass
// whose reference max trails the running max (a max sweep first under
// bf16).  The TPU kernel tiled 8-16 pairs a grid step and padded G to a
// multiple of 8 (a Mosaic rule); a block here takes one pair, so any G.

#include "attn_fwd_tc.cuh"

namespace {

// o [dh][S], m and inv_z [S] of one pair in device memory
struct PairOut {
  float* out;
  float* m;
  float* z;
  int S;
  __device__ void o(int d, int i, float x) const { out[d * S + i] = x; }
  __device__ void max(int i, float x) const { m[i] = x; }
  __device__ void inv(int i, float x) const { z[i] = x; }
};

template <int DH, bool BF16>
__global__ void __maxnreg__(attn_fwd::MAX_REGS)
sa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ m_out,
              float* __restrict__ z_out, int S, float scale) {
  const int KP = attn_fwd::key_pitch(S);
  float* ks = attn_smem;      // [DH][KP]
  float* vs = ks + DH * KP;   // [DH][KP]
  const long long base = static_cast<long long>(blockIdx.x) * DH * S;
  const long long row = static_cast<long long>(blockIdx.x) * S;
  attn_fwd::stage<DH, BF16, true>(k + base, v + base, S, ks, vs);
  __syncthreads();
  attn_fwd::attn_fwd_head<DH, BF16, true>(attn_fwd::DeviceQ{q + base, S}, ks, vs, S, scale,
                                          PairOut{o + base, m_out + row, z_out + row, S});
}

template <int DH>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* m, float* z,
               int G, int S, float scale, int bf16, cudaStream_t st) {
  auto kern = bf16 ? sa_fwd_kernel<DH, true> : sa_fwd_kernel<DH, false>;
  const int smem = attn_fwd::stage_floats(DH, S) * static_cast<int>(sizeof(float));
  if (smem > attn::MAX_SMEM_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&q, &k, &v, &o, &m, &z, &S, &scale};
  err = cudaLaunchKernel(kern, dim3(G), dim3(32 * attn_fwd::warps_for(DH, S)), args,
                         static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, contiguity, G >= 1, 1 <= dh <= 16,
// S >= 1, the shared memory (the backward's, which is the larger) and 32-bit
// offsets within a pair, and allocated o [G, dh, S], m and inv_z [G, S].
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
