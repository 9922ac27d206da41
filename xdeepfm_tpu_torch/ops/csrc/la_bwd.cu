// Lane attention for AutoInt / DIFM, backward (la_bwd), for Hopper
// (sm_90a), behind a plain C interface that ops/lane_attention_cuda.py loads
// with ctypes.  The exact gradients of la_fwd.cu for an upstream g, from q, k
// and v alone (p recomputed), per (head, sample), with dp[i, j] =
// sum_d g[d, i] v[d, j], delta[i] = sum_j dp[i, j] p[i, j] and
// ds[i, j] = (dp[i, j] - delta[i]) * p[i, j] * scale:
//
//   dv[d, j] = sum_i p[i, j] g[d, i]
//   dq[d, i] = sum_j ds[i, j] k[d, j]      dk[d, j] = sum_i ds[i, j] q[d, i]
//
// Replaces: xdeepfm_tpu/ops/lane_attention.py _la_bwd / _bwd_kernel.
//
// Bound: bytes.  At the AutoInt train shape (B = 4096, H = 2, dh = 5,
// S = 26) the function reads q, k, v and g and writes dq, dk and dv once,
// 30 MB, against 0.28 GFLOP (10 * S^2 * dh per pair).  Design: the block
// stages the P samples' q, k, v and g tiles in shared memory.  A first sweep
// has a thread per query row: the row max, then the normaliser and delta,
// then dq, each a walk over the keys, leaving dq and the row statistics
// (max, 1 / sum, delta) in shared memory.  A second sweep has a thread per
// key column: it recomputes p[i, j] from the statistics (the scores with the
// same products in the same order as the first sweep) and sums dk and dv
// over the queries, writing them over its own k and v columns.  Every sum is
// one thread's loop in a fixed order and every (head, sample) pair is
// independent, so there are no partial sums and no atomics, and the
// gradients are bit-equal from run to run.

#include <cfloat>
#include <cmath>

#include "la_common.cuh"

namespace {

template <int DMAX>
__global__ void __launch_bounds__(la::MAX_THREADS)
la_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g, float* __restrict__ dq,
              float* __restrict__ dk, float* __restrict__ dv, int B, int S, int dh, int P,
              la::Strides st, float scale) {
  const int h = blockIdx.y, b0 = blockIdx.x * P, n = S * P;
  float* qs = la_smem;       // [dh][S][P] q
  float* ks = qs + dh * n;   // [dh][S][P] k, then dk
  float* vs = ks + dh * n;   // [dh][S][P] v, then dv
  float* gs = vs + dh * n;   // [dh][S][P] g
  float* dqs = gs + dh * n;  // [dh][S][P] dq
  float* ms = dqs + dh * n;  // [S][P] row max of the scaled scores
  float* zs = ms + n;        // [S][P] 1 / row sum
  float* dl = zs + n;        // [S][P] delta
  la::load_tile(q, qs, st, h, b0, B, dh, S, P);
  la::load_tile(k, ks, st, h, b0, B, dh, S, P);
  la::load_tile(v, vs, st, h, b0, B, dh, S, P);
  la::load_tile(g, gs, st, h, b0, B, dh, S, P);
  __syncthreads();
  const int t = threadIdx.x, p = t % P;
  const bool live = t < n && b0 + p < B;

  // a thread per query row i (t = i * P + p), walking the keys
  if (live) {
    float qi[DMAX], gi[DMAX], acc[DMAX];
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      qi[d] = d < dh ? qs[d * n + t] : 0.f;
      gi[d] = d < dh ? gs[d * n + t] : 0.f;
      acc[d] = 0.f;
    }
    float mx = -FLT_MAX;
    for (int j = 0; j < S; ++j) mx = fmaxf(mx, la::dot(qi, ks, j * P + p, n, dh) * scale);
    float z = 0.f, edp = 0.f;
    for (int j = 0; j < S; ++j) {
      const int c = j * P + p;
      const float e = expf(la::dot(qi, ks, c, n, dh) * scale - mx);
      z += e;
      edp = fmaf(e, la::dot(gi, vs, c, n, dh), edp);
    }
    const float inv = 1.f / z, delta = edp * inv;
    for (int j = 0; j < S; ++j) {
      const int c = j * P + p;
      const float pij = expf(la::dot(qi, ks, c, n, dh) * scale - mx) * inv;
      const float ds = pij * (la::dot(gi, vs, c, n, dh) - delta) * scale;
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < dh) acc[d] = fmaf(ds, ks[d * n + c], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < DMAX; ++d)
      if (d < dh) dqs[d * n + t] = acc[d];
    ms[t] = mx;
    zs[t] = inv;
    dl[t] = delta;
  }
  __syncthreads();

  // a thread per key column j (t = j * P + p), walking the queries; it alone
  // reads its k and v columns, so it may overwrite them with dk and dv
  if (live) {
    float kj[DMAX], vj[DMAX], ak[DMAX], av[DMAX];
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      kj[d] = d < dh ? ks[d * n + t] : 0.f;
      vj[d] = d < dh ? vs[d * n + t] : 0.f;
      ak[d] = 0.f;
      av[d] = 0.f;
    }
    for (int i = 0; i < S; ++i) {
      const int c = i * P + p;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) {
        if (d < dh) {
          s = fmaf(qs[d * n + c], kj[d], s);
          dp = fmaf(gs[d * n + c], vj[d], dp);
        }
      }
      const float pij = expf(s * scale - ms[c]) * zs[c];
      const float ds = pij * (dp - dl[c]) * scale;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) {
        if (d < dh) {
          av[d] = fmaf(pij, gs[d * n + c], av[d]);
          ak[d] = fmaf(ds, qs[d * n + c], ak[d]);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      if (d < dh) {
        ks[d * n + t] = ak[d];
        vs[d * n + t] = av[d];
      }
    }
  }
  __syncthreads();
  la::store_tile(dq, dqs, st, h, b0, B, dh, S, P);
  la::store_tile(dk, ks, st, h, b0, B, dh, S, P);
  la::store_tile(dv, vs, st, h, b0, B, dh, S, P);
}

template <int DMAX>
int launch_bwd(const float* q, const float* k, const float* v, const float* g, float* dq,
               float* dk, float* dv, int B, int H, int S, int dh, la::Strides st, float scale,
               cudaStream_t stream) {
  auto kern = la_bwd_kernel<DMAX>;
  int P = la::pairs_per_block(S, B);
  const int smem = (5 * dh + 3) * S * P * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&q, &k, &v, &g, &dq, &dk, &dv, &B, &S, &dh, &P, &st, &scale};
  err = cudaLaunchKernel(kern, dim3((B + P - 1) / P, H), dim3(la::threads_for(S * P)), args,
                         static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, that q, k, v, g, dq, dk and dv share the
// element strides (sh, sd, ss, sb), B >= 1, 1 <= H <= 65535, 1 <= dh <= 16 and
// 1 <= S <= 64 (at most (5 * 16 + 3) * 256 floats, 85 KB, of shared memory),
// and allocated dq, dk, dv.
int la_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, int B, int H, int S, int dh, long long sh, long long sd, long long ss,
           long long sb, float scale, void* stream) {
  const la::Strides st{sh, sd, ss, sb};
  LA_DISPATCH_DH(dh, launch_bwd, static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const float*>(g),
                 static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), B, H,
                 S, dh, st, scale, static_cast<cudaStream_t>(stream))
}

const char* la_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
