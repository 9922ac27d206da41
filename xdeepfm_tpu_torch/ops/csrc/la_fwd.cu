// Lane attention for AutoInt / DIFM, forward (la_fwd), for Hopper
// (sm_90a), behind a plain C interface that ops/lane_attention_cuda.py loads
// with ctypes.  Per (head h, sample b), on strided operands q, k, v
// [H, dh, S, B] (fp32; la_common.cuh):
//
//   t[i, j]   = scale * sum_d q[h, d, i, b] k[h, d, j, b]
//   p[i, j]   = exp(t[i, j] - max_j t[i, j]) / sum_j exp(t[i, j] - max_j t[i, j])
//   o[h, d, i, b] = sum_j p[i, j] v[h, d, j, b]
//
// It saves nothing for the backward: la_bwd.cu recomputes p from q and k,
// as the TPU kernel does.
//
// Replaces: xdeepfm_tpu/ops/lane_attention.py _la_fwd / _fwd_kernel.
//
// Bound: bytes.  At the AutoInt train shape (B = 4096, H = 2, dh = 5,
// S = 26) the function moves q, k, v and o once, 17 MB, against 0.11 GFLOP
// (4 * S^2 * dh per pair) and 5.5 M exps.  Design: the block stages the P
// samples' q, k and v tiles in shared memory (coalesced: the copy walks the
// operand's unit stride), one thread per query row keeps its q row and o
// accumulators in registers and walks the keys twice (the row max, then exp,
// sum and the v product), then o goes back through the q tile (each thread
// overwrites only its own row) and out in one coalesced copy.  The TPU kernel
// put 128 samples on the lanes and padded B to a multiple of 128; here the
// ragged last block masks its missing samples, so any B.

#include <cfloat>
#include <cmath>

#include "la_common.cuh"

namespace {

template <int DMAX>
__global__ void __launch_bounds__(la::MAX_THREADS)
la_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int B, int S, int dh, int P,
              la::Strides st, float scale) {
  const int h = blockIdx.y, b0 = blockIdx.x * P, n = S * P;
  float* qs = la_smem;      // [dh][S][P] q, then o
  float* ks = qs + dh * n;  // [dh][S][P]
  float* vs = ks + dh * n;  // [dh][S][P]
  la::load_tile(q, qs, st, h, b0, B, dh, S, P);
  la::load_tile(k, ks, st, h, b0, B, dh, S, P);
  la::load_tile(v, vs, st, h, b0, B, dh, S, P);
  __syncthreads();
  const int t = threadIdx.x, p = t % P;
  if (t < n && b0 + p < B) {
    float qi[DMAX], acc[DMAX];
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      qi[d] = d < dh ? qs[d * n + t] : 0.f;  // t = i * P + p: this thread's row
      acc[d] = 0.f;
    }
    float mx = -FLT_MAX;
    for (int j = 0; j < S; ++j) mx = fmaxf(mx, la::dot(qi, ks, j * P + p, n, dh) * scale);
    float z = 0.f;
    for (int j = 0; j < S; ++j) {
      const int c = j * P + p;
      const float e = expf(la::dot(qi, ks, c, n, dh) * scale - mx);
      z += e;
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < dh) acc[d] = fmaf(e, vs[d * n + c], acc[d]);
    }
    const float inv = 1.f / z;
#pragma unroll
    for (int d = 0; d < DMAX; ++d)
      if (d < dh) qs[d * n + t] = acc[d] * inv;
  }
  __syncthreads();
  la::store_tile(o, qs, st, h, b0, B, dh, S, P);
}

template <int DMAX>
int launch_fwd(const float* q, const float* k, const float* v, float* o, int B, int H, int S,
               int dh, la::Strides st, float scale, cudaStream_t stream) {
  auto kern = la_fwd_kernel<DMAX>;
  int P = la::pairs_per_block(S, B);
  const int smem = 3 * dh * S * P * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&q, &k, &v, &o, &B, &S, &dh, &P, &st, &scale};
  err = cudaLaunchKernel(kern, dim3((B + P - 1) / P, H), dim3(la::threads_for(S * P)), args,
                         static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, that q, k, v and o share the element
// strides (sh, sd, ss, sb), B >= 1, 1 <= H <= 65535, 1 <= dh <= 16 and
// 1 <= S <= 64, and allocated o.
int la_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int S, int dh,
           long long sh, long long sd, long long ss, long long sb, float scale, void* stream) {
  const la::Strides st{sh, sd, ss, sb};
  LA_DISPATCH_DH(dh, launch_fwd, static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(o), B, H, S, dh, st, scale,
                 static_cast<cudaStream_t>(stream))
}

const char* la_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
