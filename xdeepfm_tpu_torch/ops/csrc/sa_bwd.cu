// Small-sequence attention for the attention-pooled CIN, backward (sa_bwd),
// for Hopper (sm_90a), behind a plain C interface that
// ops/attention_cuda.py loads with ctypes.  The flash backward of sa_fwd.cu
// from its saved m and inv_z: with delta[i] = sum_d g[d, i] o[d, i],
// dp[i, j] = sum_d g[d, i] v[d, j] and
// ds[i, j] = (dp[i, j] - delta[i]) * inv_z[i] * scale * e[i, j],
//
//   dq[d, i] = sum_j k[d, j] ds[i, j]     dk[d, j] = sum_i q[d, i] ds[i, j]
//   dv[d, j] = sum_i g[d, i] inv_z[i] e[i, j]
//
// Under bf16 every product operand (q, k, v, e, g, g * inv_z, ds) is rounded
// to bf16 first and the sums stay fp32.
//
// Replaces: xdeepfm_tpu/ops/attention_pallas.py _sa_bwd / _bwd_kernel.
//
// Bound: operations.  At the V2 training shape (G = 8192, dh = 5, S = 256)
// the five [S, S] products are 26.8 GFLOP.  Design: one block per pair, with
// q, k, v, g and g * inv_z [dh, S] and the row statistics in shared memory
// ((5 * dh + 3) * S floats, 28 KB at dh = 5, S = 256: the limit on S); the dq
// sweep has a thread per query and the dk / dv sweep a thread per key,
// recomputing the scores bit for bit (same products, same order), so every
// sum over queries or keys is one thread's loop: no atomics, bit-equal from
// run to run.

#include <cfloat>
#include <cmath>

#include "attn_common.cuh"

namespace {

using attn::operand;

template <int DH>
__global__ void __launch_bounds__(attn::MAX_THREADS)
sa_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ o, const float* __restrict__ m_in,
              const float* __restrict__ z_in, float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, int S, float scale, int bf16) {
  float* qs = attn_smem;      // [DH][S] q (operand)
  float* ks = qs + DH * S;    // [DH][S] k (operand)
  float* vs = ks + DH * S;    // [DH][S] v (operand)
  float* gs = vs + DH * S;    // [DH][S] g (operand of dp)
  float* gz = gs + DH * S;    // [DH][S] g * inv_z (operand of dv)
  float* ms = gz + DH * S;    // [S] row max
  float* zs = ms + S;         // [S] inverse normaliser
  float* dl = zs + S;         // [S] delta
  const long long base = static_cast<long long>(blockIdx.x) * DH * S;
  const long long row = static_cast<long long>(blockIdx.x) * S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const float zi = __ldg(z_in + row + i);
    float delta = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float gi = __ldg(g + base + d * S + i);
      delta = fmaf(gi, __ldg(o + base + d * S + i), delta);
      qs[d * S + i] = operand(__ldg(q + base + d * S + i), bf16);
      ks[d * S + i] = operand(__ldg(k + base + d * S + i), bf16);
      vs[d * S + i] = operand(__ldg(v + base + d * S + i), bf16);
      gs[d * S + i] = operand(gi, bf16);
      gz[d * S + i] = operand(gi * zi, bf16);
    }
    ms[i] = __ldg(m_in + row + i);
    zs[i] = zi;
    dl[i] = delta;
  }
  __syncthreads();

  // dq: a thread per query i, walking the keys
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    float qi[DH], gi[DH], acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qi[d] = qs[d * S + i];
      gi[d] = gs[d * S + i];
      acc[d] = 0.f;
    }
    const float mi = ms[i], di = dl[i], zsc = zs[i] * scale;
    for (int j = 0; j < S; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(qi[d], ks[d * S + j], s);
        dp = fmaf(gi[d], vs[d * S + j], dp);
      }
      const float e = __expf((s - mi) * scale);
      const float ds = operand((dp - di) * zsc * e, bf16);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(ks[d * S + j], ds, acc[d]);
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) dq[base + d * S + i] = acc[d];
  }

  // dk, dv: a thread per key j, walking the queries (scores recomputed in
  // the dq sweep's order: the same bits)
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    float kj[DH], vj[DH], ak[DH], av[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      kj[d] = ks[d * S + j];
      vj[d] = vs[d * S + j];
      ak[d] = 0.f;
      av[d] = 0.f;
    }
    for (int i = 0; i < S; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(qs[d * S + i], kj[d], s);
        dp = fmaf(gs[d * S + i], vj[d], dp);
      }
      const float e = __expf((s - ms[i]) * scale);
      const float ep = operand(e, bf16);
      const float ds = operand((dp - dl[i]) * (zs[i] * scale) * e, bf16);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        av[d] = fmaf(gz[d * S + i], ep, av[d]);
        ak[d] = fmaf(qs[d * S + i], ds, ak[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dk[base + d * S + j] = ak[d];
      dv[base + d * S + j] = av[d];
    }
  }
}

template <int DH>
int launch_bwd(const float* q, const float* k, const float* v, const float* g, const float* o,
               const float* m, const float* z, float* dq, float* dk, float* dv, int G, int S,
               float scale, int bf16, cudaStream_t st) {
  auto kern = sa_bwd_kernel<DH>;
  const int smem = (5 * DH + 3) * S * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&q, &k, &v, &g, &o, &m, &z, &dq, &dk, &dv, &S, &scale, &bf16};
  err = cudaLaunchKernel(kern, dim3(G), dim3(attn::threads_for(S)), args,
                         static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, contiguity, G >= 1, 1 <= dh <= 16,
// S >= 1, the shared memory ((5 * dh + 3) * S floats) and 32-bit offsets
// within a pair, and allocated dq, dk, dv [G, dh, S].
int sa_bwd(const void* q, const void* k, const void* v, const void* g, const void* o,
           const void* m, const void* z, void* dq, void* dk, void* dv, int G, int dh, int S,
           float scale, int bf16, void* stream) {
  ATTN_DISPATCH_DH(dh, launch_bwd, static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<const float*>(g),
                   static_cast<const float*>(o), static_cast<const float*>(m),
                   static_cast<const float*>(z), static_cast<float*>(dq),
                   static_cast<float*>(dk), static_cast<float*>(dv), G, S, scale, bf16,
                   static_cast<cudaStream_t>(stream))
}

const char* sa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
