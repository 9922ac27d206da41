// The attention CIN's post-CIN block, forward (ab_fwd), for Hopper (sm_90a),
// behind a plain C interface that ops/attn_block_cuda.py loads with ctypes:
// pooled [B, E] and, for the backward, the softmax statistics m and inv_z,
// the per-head attention outputs and each layer's output (the math is in
// attn_block.cuh).
//
// Replaces: xdeepfm_tpu/ops/attn_block_pallas.py _ab_fwd / _fwd_kernel.
//
// Bound: operations.  At V1's training shape (B = 4096, E = 10, S = 256,
// H = 2, L = 1) the attention cores are most of the work (two [S, S]
// products a head, 10.7 GFLOP, and 0.54 G exps); the E-wide projections,
// W_o and pooling add about 10%.  The bytes are x and the saved activations,
// ~100 MB.  Design: a block per batch row (attn_block.cuh); the attention
// for query s runs on the thread that owns column s (two sweeps over the
// keys, as sa_fwd.cu), so the column needs no barrier between its attention
// and its W_o / LayerNorm; the pooling softmax over S is a fixed-order block
// reduction.  The TPU kernel walked 16 rows per grid step with
// lane-concatenated scratches; its S % 128 gate was a Mosaic lane rule: this
// kernel takes any S whose block fits shared memory (5 E P + 5 E^2 floats,
// P the padded pitch).

#include "attn_block.cuh"

namespace {

template <int DH>
__global__ void __launch_bounds__(attn::MAX_THREADS) ab_fwd_kernel(Params p, FwdOut out) {
  const int E = p.E, S = p.S, H = p.H, L = p.L, P = pitch(S), EP = E * P;
  float* X = attn_smem;    // [E][P] running activation
  float* Q = X + EP;       // [E][P] q, then the attention output o
  float* K = Q + EP;
  float* V = K + EP;
  float* R = V + EP;       // [E][P] W_o output (+ residual)
  float* W = R + EP;       // layer weights (load_layer)
  float* PW = W + 4 * E * E + 2 * E;  // pooling MLP (load_pool)
  float* SC = PW + E * E + 2 * E;     // [S] pooling scores, then weights
  float* red = SC + S;                // [32]
  const int b = blockIdx.x;
  const bool save = out.m != nullptr;
  load_rows(X, p.x + static_cast<long long>(b) * E * S, E, S, P);
  load_pool(PW, p);
  const float* G = W + 4 * E * E;
  const float* BT = G + E;
  for (int l = 0; l < L; ++l) {
    __syncthreads();  // the previous layer's sweeps have read K and V
    load_layer(W, p, l);
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) project<DH>(W, X, Q, K, V, s, E, H, P);
    __syncthreads();
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      for (int h = 0; h < H; ++h) {
        float qi[DH], acc[DH];
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          qi[d] = Q[(h * DH + d) * P + i];
          acc[d] = 0.f;
        }
        const float* Kh = K + h * DH * P;
        const float* Vh = V + h * DH * P;
        float mx = -FLT_MAX;
        for (int j = 0; j < S; ++j) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) s = fmaf(qi[d], Kh[d * P + j], s);
          mx = fmaxf(mx, s);
        }
        float sum = 0.f;
        for (int j = 0; j < S; ++j) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) s = fmaf(qi[d], Kh[d * P + j], s);
          const float e = __expf((s - mx) * p.scale);
          sum += e;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] = fmaf(Vh[d * P + j], e, acc[d]);
        }
        const float inv = 1.f / sum;
        const long long st = (static_cast<long long>(b) * L * H + l * H + h) * S + i;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          const float o = acc[d] * inv;
          Q[(h * DH + d) * P + i] = o;  // this thread's own column: q_i is in qi
          if (save) out.osave[((static_cast<long long>(b) * L + l) * E + h * DH + d) * S + i] = o;
        }
        if (save) {
          out.m[st] = mx;
          out.z[st] = inv;
        }
      }
      out_proj<DH>(W, Q, X, R, i, E, H, P, p.residual);
      if (p.layer_norm) {
        float mu, rstd;
        ln_stats(R, i, E, P, p.eps, &mu, &rstd);
        for (int f = 0; f < E; ++f) X[f * P + i] = G[f] * ((R[f * P + i] - mu) * rstd) + BT[f];
      } else {
        for (int f = 0; f < E; ++f) X[f * P + i] = R[f * P + i];
      }
      if (save) {
        float* ys = out.ysave + (static_cast<long long>(b) * L + l) * E * S;
        for (int f = 0; f < E; ++f) ys[f * S + i] = X[f * P + i];
      }
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) SC[s] = pool_score(PW, X, s, E, P);
  __syncthreads();
  softmax_cols(SC, S, red);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc = fmaf(SC[s], X[e * P + s], acc);
    out.pooled[static_cast<long long>(b) * E + e] = acc;
  }
}

template <int DH>
int launch_fwd(Params p, FwdOut out, cudaStream_t st) {
  auto kern = ab_fwd_kernel<DH>;
  const int smem = fwd_floats(p.E, p.S) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p, &out};
  err = cudaLaunchKernel(kern, dim3(p.B), dim3(attn::threads_for(p.S)), args,
                         static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, contiguity, B >= 1, E = H * dh with
// 1 <= dh <= 16, L >= 1, the shared memory and 32-bit offsets within a row,
// and allocated pooled [B, E] and, unless m is null, m and z [B, L*H, S],
// osave and ysave [B, L, E, S].
int ab_fwd(const void* x, const void* wq, const void* wk, const void* wv, const void* wo,
           const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2,
           void* pooled, void* m, void* z, void* osave, void* ysave, int B, int E, int S, int L,
           int H, float scale, float eps, int residual, int layer_norm, void* stream) {
  const Params p = make_params(x, wq, wk, wv, wo, gamma, beta, w1, b1, w2, B, E, S, L, H,
                               scale, eps, residual, layer_norm);
  FwdOut out;
  out.pooled = static_cast<float*>(pooled);
  out.m = static_cast<float*>(m);
  out.z = static_cast<float*>(z);
  out.osave = static_cast<float*>(osave);
  out.ysave = static_cast<float*>(ysave);
  const int dh = E / H;
  ATTN_DISPATCH_DH(dh, launch_fwd, p, out, static_cast<cudaStream_t>(stream))
}

const char* ab_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
