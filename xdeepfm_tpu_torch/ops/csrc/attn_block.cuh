// Shared pieces of the attention CIN's fused block kernels (ab_fwd.cu,
// ab_bwd.cu): the parameter structs, the shared-memory layout and the
// per-column walks.  Per batch row b, on the transposed CIN output
// x [B, E, S] (E = H * dh channels, S feature maps):
//
//   y_0 = x;  for l < L:
//     q, k, v [h] = Wq/Wk/Wv[l, h]^T y_l            ([dh, S] per head)
//     o[h]        = attention(q, k, v) as csrc/sa_fwd.cu (max of the
//                   unscaled scores, exp((s - m) * scale), inv_z)
//     r           = sum_h Wo[l, h]^T o[h]  (+ y_l if use_residual)
//     y_{l+1}     = LayerNorm over E (fast variance E[r^2] - mu^2, eps;
//                   gamma, beta) if use_layer_norm, else r
//   pooled[b]   = sum_s softmax_s(w2 . tanh(W1^T y_L[:, s] + b1)) y_L[:, s]
//
// All fp32.  One block owns one batch row: x [E, S], the per-head q / k / v
// and (in the backward) every gradient of the row sit in shared memory, rows
// padded to a pitch: odd in the forward, so that column walks and row walks
// are both free of bank conflicts, except k and v, which the forward writes
// in the forward routine's key order (attn_fwd_tc.cuh, attn::key_slot, rows
// of S rounded up to 8); in the backward the attention routine's
// (attn_bwd_tc.cuh: even, 2 mod 4), which keeps the row walks of up to 16
// rows free of conflicts too.  The layer's weights (4 E^2 + 2 E floats) and
// the pooling MLP's are loaded into shared memory once per layer.  One
// thread owns one column s: the E-sized projections, W_o, the residual and
// the LayerNorm over E are that thread's loops.
#pragma once

#include <cfloat>
#include <cmath>

#include "attn_common.cuh"

namespace {

struct Params {
  const float* x;      // [B, E, S]
  const float* wq;     // [L*H, E, dh]
  const float* wk;     // [L*H, E, dh]
  const float* wv;     // [L*H, E, dh]
  const float* wo;     // [L*H, dh, E]
  const float* gamma;  // [L, E]
  const float* beta;   // [L, E]
  const float* w1;     // [E, E]: h1[f] = sum_e w1[e, f] y[e] + b1[f]
  const float* b1;     // [E]
  const float* w2;     // [E]
  int B, E, S, L, H;
  float scale, eps;
  int residual, layer_norm;
};

struct FwdOut {
  float* pooled;  // [B, E]
  float* m;       // [B, L*H, S] row max of the unscaled scores (null: no saves)
  float* z;       // [B, L*H, S] inverse normaliser
  float* osave;   // [B, L, E, S] per-head attention outputs, channel h*dh + d
  float* ysave;   // [B, L, E, S] each layer's output
};

struct BwdIo {
  const float* g;      // [B, E] gradient of pooled
  const float* m;      // saved by ab_fwd
  const float* z;
  const float* osave;
  const float* ysave;
  float* dx;           // [B, E, S]
  float* part;         // [NP, B] per-row parameter gradients
};

// the forward's pitch (the backward's is attn_bwd_tc.cuh's)
__host__ __device__ inline int pitch(int S) { return S % 2 == 0 ? S + 1 : S; }

// shared-memory floats of the forward kernel (the wrapper repeats this; the
// backward's formula is in ab_bwd.cu)
__host__ __device__ inline int weight_floats(int E) { return 5 * E * E + 4 * E; }
// the forward's k and v rows: S rounded up to 8 (attn_fwd::key_pitch)
__host__ __device__ inline int kv_pitch(int S) { return (S + 7) / 8 * 8; }
__host__ __device__ inline int fwd_floats(int E, int S) {
  return 2 * E * kv_pitch(S) + 3 * E * pitch(S) + weight_floats(E) + S + 32;
}

// Layer l's weights into W: wq, wk, wv [H][E][dh] (E*E each), wo [H][dh][E],
// gamma, beta [E].
__device__ void load_layer(float* W, const Params& p, int l) {
  const int EE = p.E * p.E;
  const long long off = static_cast<long long>(l) * EE;
  for (int i = threadIdx.x; i < EE; i += blockDim.x) {
    W[i] = __ldg(p.wq + off + i);
    W[EE + i] = __ldg(p.wk + off + i);
    W[2 * EE + i] = __ldg(p.wv + off + i);
    W[3 * EE + i] = __ldg(p.wo + off + i);
  }
  for (int i = threadIdx.x; i < p.E; i += blockDim.x) {
    W[4 * EE + i] = __ldg(p.gamma + l * p.E + i);
    W[4 * EE + p.E + i] = __ldg(p.beta + l * p.E + i);
  }
}

// The pooling MLP into PW: w1 [E][E], b1 [E], w2 [E].
__device__ void load_pool(float* PW, const Params& p) {
  const int EE = p.E * p.E;
  for (int i = threadIdx.x; i < EE; i += blockDim.x) PW[i] = __ldg(p.w1 + i);
  for (int i = threadIdx.x; i < p.E; i += blockDim.x) {
    PW[EE + i] = __ldg(p.b1 + i);
    PW[EE + p.E + i] = __ldg(p.w2 + i);
  }
}

// [E, S] rows of global memory (row stride S) into shared rows of pitch P
__device__ void load_rows(float* dst, const float* src, int E, int S, int P) {
  for (int i = threadIdx.x; i < E * S; i += blockDim.x) {
    const int e = i / S;
    dst[e * P + i - e * S] = __ldg(src + i);
  }
}

// q, k, v of column s from the layer input X: channel c = h*dh + d, q at
// Q[c P + s]; k and v at K[c KVP + key] with key = s, or its slot in the
// forward routine's order where SLOTS.
template <int DH, bool SLOTS = false>
__device__ void project(const float* W, const float* X, float* Q, float* K, float* V, int s,
                        int E, int H, int P, int KVP) {
  const int key = SLOTS ? attn::key_slot(s) : s;
  const int EE = E * E;
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      float aq = 0.f, ak = 0.f, av = 0.f;
      for (int e = 0; e < E; ++e) {
        const float xv = X[e * P + s];
        const int w = (h * E + e) * DH + d;
        aq = fmaf(W[w], xv, aq);
        ak = fmaf(W[EE + w], xv, ak);
        av = fmaf(W[2 * EE + w], xv, av);
      }
      const int c = h * DH + d;
      Q[c * P + s] = aq;
      K[c * KVP + key] = ak;
      V[c * KVP + key] = av;
    }
  }
}

// r = sum_h Wo[h]^T o[h] (+ x) for column s into R; o read from O.
template <int DH>
__device__ void out_proj(const float* W, const float* O, const float* X, float* R, int s, int E,
                         int H, int P, int residual) {
  const float* WO = W + 3 * E * E;
  for (int f = 0; f < E; ++f) {
    float r = 0.f;
    for (int h = 0; h < H; ++h) {
      float ao = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) ao = fmaf(WO[(h * DH + d) * E + f], O[(h * DH + d) * P + s], ao);
      r += ao;
    }
    if (residual) r += X[f * P + s];
    R[f * P + s] = r;
  }
}

// LayerNorm statistics of column s of R: (mu, rstd), fast variance.
__device__ void ln_stats(const float* R, int s, int E, int P, float eps, float* mu,
                         float* rstd) {
  float sum = 0.f, sq = 0.f;
  for (int f = 0; f < E; ++f) {
    const float r = R[f * P + s];
    sum += r;
    sq = fmaf(r, r, sq);
  }
  const float m = sum / E;
  *mu = m;
  *rstd = rsqrtf(sq / E - m * m + eps);
}

// pooling scores of column s: w2 . tanh(W1^T y + b1)
__device__ float pool_score(const float* PW, const float* Y, int s, int E, int P) {
  const int EE = E * E;
  float sc = 0.f;
  for (int f = 0; f < E; ++f) {
    float pre = 0.f;
    for (int e = 0; e < E; ++e) pre = fmaf(PW[e * E + f], Y[e * P + s], pre);
    sc = fmaf(PW[EE + E + f], tanhf(pre + PW[EE + f]), sc);
  }
  return sc;
}

// SC[s] <- softmax over s of SC (fixed-order block reductions).
__device__ void softmax_cols(float* SC, int S, float* red) {
  float mx = -FLT_MAX;
  for (int s = threadIdx.x; s < S; s += blockDim.x) mx = fmaxf(mx, SC[s]);
  mx = attn::block_max(mx, red);
  float se = 0.f;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float e = __expf(SC[s] - mx);
    SC[s] = e;
    se += e;
  }
  se = attn::block_sum(se, red);
  for (int s = threadIdx.x; s < S; s += blockDim.x) SC[s] = SC[s] / se;
  __syncthreads();
}

// out(a, c, sum_s A[a][s] * Bm[c][s]) for every (a, c): one thread's loop
// over s per output, in order.
template <class Store>
__device__ void col_products(const float* A, const float* Bm, int na, int nb, int S, int P,
                             Store store) {
  for (int o = threadIdx.x; o < na * nb; o += blockDim.x) {
    const int a = o / nb;
    const int c = o - a * nb;
    const float* ar = A + a * P;
    const float* br = Bm + c * P;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc = fmaf(ar[s], br[s], acc);
    store(a, c, acc);
  }
}

// Offsets of the parameter gradients in part [NP][B] (and in ab_bwd's
// reduced [NP] output): dwq, dwk, dwv [L*H][E][dh], dwo [L*H][dh][E],
// dgamma, dbeta [L][E], dw1 [E][E], db1 [E], dw2 [E].
struct Offsets {
  int wq, wk, wv, wo, gamma, beta, w1, b1, w2, np;
  __host__ __device__ Offsets(int E, int L) {
    const int LEE = L * E * E;
    wq = 0;
    wk = LEE;
    wv = 2 * LEE;
    wo = 3 * LEE;
    gamma = 4 * LEE;
    beta = gamma + L * E;
    w1 = beta + L * E;
    b1 = w1 + E * E;
    w2 = b1 + E;
    np = w2 + E;
  }
};

Params make_params(const void* x, const void* wq, const void* wk, const void* wv,
                   const void* wo, const void* gamma, const void* beta, const void* w1,
                   const void* b1, const void* w2, int B, int E, int S, int L, int H,
                   float scale, float eps, int residual, int layer_norm) {
  Params p;
  p.x = static_cast<const float*>(x);
  p.wq = static_cast<const float*>(wq);
  p.wk = static_cast<const float*>(wk);
  p.wv = static_cast<const float*>(wv);
  p.wo = static_cast<const float*>(wo);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.B = B;
  p.E = E;
  p.S = S;
  p.L = L;
  p.H = H;
  p.scale = scale;
  p.eps = eps;
  p.residual = residual;
  p.layer_norm = layer_norm;
  return p;
}

}  // namespace
