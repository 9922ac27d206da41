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
// products a head, 10.7 GFLOP: 0.160 ms at the fp32 rate) and 0.54 G exps
// (0.128 ms on the special-function units); the E-wide projections, W_o
// and pooling add about 10%.  The bytes are x and the saved activations,
// ~100 MB.  Design: a block per batch row (attn_block.cuh), one thread per
// column s for the projections, W_o, the residual, the LayerNorm and the
// pooling; the attention of each head through the forward routine that
// sa_fwd.cu runs (attn_fwd_tc.cuh): warps own tiles of 32 queries (16
// above dh 8), a lane 4 queries x 2 keys of every 8, both products fp32
// FMAs, one pass with a reference max that trails the running max.  The
// projections write k and v straight into the routine's key order
// (attn::key_slot), q stays in its odd-pitch rows and the routine writes o
// over it, so the block's attention needs no staging of its own.  m stays
// the row max of the unscaled scores summed over d from 0, bit-equal to
// what ab_bwd recomputes (attn_bwd_tc.cuh), and inv_z is the routine's.
// The pooling softmax over S is a fixed-order block reduction.
// Occupancy: shared memory 2 E KP + 3 E P + 5 E^2 + 4 E + S + 32 floats
// (KP = S rounded up to 8, P odd): 54.6 KB at E 10, S 256; registers capped
// at the routine's 80 (attn_fwd::MAX_REGS), so three blocks of 8 warps
// share an SM (four fit its shared memory).  The projections and W_o want
// more: at dh 5 the build log shows 124 bytes spilled; caps of 96 and 128
// registers (two blocks an SM) ran slower on the card, so 80 stays.
// Measured (chip_smoke.py, an NVIDIA H100 80GB HBM3 at 700.00 W): 0.775-0.785
// ms at V1's train shape, 0.740-0.744 without the saves, against
// 1.307-1.308 for the thread-per-column walk this replaced.  Scoring (no saves) and
// training run the same walk: pooled is bit-equal between them.  The TPU
// kernel walked 16 rows per grid step with lane-concatenated scratches; its
// S % 128 gate was a Mosaic lane rule: this kernel takes any S whose block
// fits shared memory.

#include "attn_block.cuh"
#include "attn_fwd_tc.cuh"

namespace {

// o of one head into its rows of Q (pitch P) and, when saving, osave; m and
// inv_z when saving
struct HeadOut {
  float* q;      // Q + h dh P
  float* osave;  // [dh][S] of this layer and head, or null
  float* m;      // [S], or null
  float* z;
  int P, S;
  __device__ void o(int d, int i, float x) const {
    q[d * P + i] = x;
    if (osave) osave[d * S + i] = x;
  }
  __device__ void max(int i, float x) const {
    if (m) m[i] = x;
  }
  __device__ void inv(int i, float x) const {
    if (z) z[i] = x;
  }
};

template <int DH>
__global__ void __maxnreg__(attn_fwd::MAX_REGS) ab_fwd_kernel(Params p, FwdOut out) {
  const int E = p.E, S = p.S, H = p.H, L = p.L, P = pitch(S), EP = E * P;
  const int KP = kv_pitch(S);
  float* K = attn_smem;    // [E][KP] k, in the routine's key order (8-byte aligned rows)
  float* V = K + E * KP;   // [E][KP] v, likewise
  float* X = V + E * KP;   // [E][P] running activation
  float* Q = X + EP;       // [E][P] q, then the attention output o
  float* R = Q + EP;       // [E][P] W_o output (+ residual)
  float* W = R + EP;       // layer weights (load_layer)
  float* PW = W + 4 * E * E + 2 * E;  // pooling MLP (load_pool)
  float* SC = PW + E * E + 2 * E;     // [S] pooling scores, then weights
  float* red = SC + S;                // [32]
  const int b = blockIdx.x;
  const bool save = out.m != nullptr;
  load_rows(X, p.x + static_cast<long long>(b) * E * S, E, S, P);
  load_pool(PW, p);
  // the keys past S: zero k and v, read by the routine's last block
  for (int i = threadIdx.x; i < E * (KP - S); i += blockDim.x) {
    const int c = i / (KP - S), j = S + i % (KP - S);
    K[c * KP + attn::key_slot(j)] = 0.f;
    V[c * KP + attn::key_slot(j)] = 0.f;
  }
  const float* G = W + 4 * E * E;
  const float* BT = G + E;
  for (int l = 0; l < L; ++l) {
    __syncthreads();  // the previous layer's attention has read K and V
    load_layer(W, p, l);
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      project<DH, true>(W, X, Q, K, V, s, E, H, P, KP);
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      const long long st = (static_cast<long long>(b) * L * H + l * H + h) * S;
      const HeadOut ho{Q + h * DH * P,
                       save ? out.osave + ((static_cast<long long>(b) * L + l) * E + h * DH) * S
                            : nullptr,
                       save ? out.m + st : nullptr, save ? out.z + st : nullptr, P, S};
      attn_fwd::attn_fwd_head<DH, false, true>(attn_fwd::SharedQ{Q + h * DH * P, P},
                                               K + h * DH * KP, V + h * DH * KP, S, p.scale, ho);
    }
    __syncthreads();  // every head's o is in Q
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
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
