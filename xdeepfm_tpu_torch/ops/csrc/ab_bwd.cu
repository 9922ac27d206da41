// The attention CIN's post-CIN block, backward (ab_bwd), for Hopper
// (sm_90a), behind a plain C interface that ops/attn_block_cuda.py loads
// with ctypes: dx [B, E, S] and the nine parameter gradients from the
// activations ab_fwd saved (the math is in attn_block.cuh).
//
// Replaces: xdeepfm_tpu/ops/attn_block_pallas.py _ab_bwd / _bwd_kernel.
//
// Bound: operations.  At V1's training shape the attention backward's five
// [S, S] products a head are 26.8 GFLOP of about 30.  Design: a block per
// batch row walks pool -> LayerNorm -> W_o -> attention -> projections,
// writes dx, and writes each parameter gradient's sum over its row's S
// columns (one thread's loop, in order) as a per-row partial into part
// [NP][B]; ab_reduce_kernel then sums the B partials of each parameter in a
// fixed order.  The attention backward of each head is attn_bwd_tc.cuh's
// routine (each score and exp computed once, dV, dK and dQ in 3xTF32 on the
// tensor cores), on the row's q, k, v and do in shared memory; the rest is
// one thread per column s.  No atomics: bit-equal from run to run.  The
// TPU kernel carried the weight gradients in revisited output blocks along
// its sequential grid and reduced the vector gradients outside the kernel;
// blocks run concurrently here, hence the partials.  Shared memory:
// 10 E P + 3 H S + 4 E^2 + 3 E + 32 floats (P the routine's pitch, S + 2 at
// V1's S = 256), plus the routine's scratch where it does not fit in the
// rows it borrows (BwdLayout): 109 KB, two blocks an SM, at V1's shape.

#include "attn_block.cuh"
#include "attn_bwd_tc.cuh"

namespace {

// The routine's chunks a step and buffers: (2, 2) where a block fits, else
// (1, 2), else (1, 1).  Its scratch lies in the rows of X and DY, which hold
// no live value while it runs (X is loaded again after it), or past the
// statistics where it does not fit there.  The pooling MLP's weights share
// the layer weights' space (they are read before the first layer's are
// loaded).
struct BwdLayout {
  int ch, nbuf, extra, floats;
  __host__ __device__ BwdLayout(int E, int S, int H) {
    const int P = attn_tc::pitch(S), warps = attn::threads_for(S) / 32;
    for (int c = 0; c < 3; ++c) {
      ch = c == 0 ? 2 : 1;
      nbuf = c < 2 ? 2 : 1;
      const int f = attn_tc::scratch_floats(E / H, warps, nbuf, ch);
      extra = f > 2 * E * P ? f : 0;
      floats = 10 * E * P + 3 * H * S + (3 * H * S & 1) + extra + 4 * E * E + 3 * E + 32;
      if (floats * 4 <= attn::MAX_SMEM_BYTES) break;
    }
  }
};

// dq, dk, dv [dh][P] of one head in shared memory
struct HeadOut {
  float* dq;
  float* dk;
  float* dv;
  int P;
  __device__ float* at(int which, int d, int col) const {
    return (which == 0 ? dq : which == 1 ? dk : dv) + d * P + col;
  }
};

template <int DH>
__global__ void __launch_bounds__(attn::MAX_THREADS, 2) ab_bwd_kernel(Params p, BwdIo io) {
  const int E = p.E, S = p.S, H = p.H, L = p.L, EE = E * E;
  const BwdLayout lay(E, S, H);
  const int P = attn_tc::pitch(S), EP = E * P;
  float* X = attn_smem;  // [E][P] layer input (the final y for the pooling)
  float* DY = X + EP;    // [E][P] gradient of the layer output, then dx
  float* DR = DY + EP;   // [E][P] gradient of r (pre-LayerNorm)
  float* Q = DR + EP;
  float* K = Q + EP;
  float* V = K + EP;
  float* DO = V + EP;    // [E][P] gradient of the attention output
  float* DQ = DO + EP;   // [E][P] o, then dq; the pooling's dpre
  float* DK = DQ + EP;   // the pooling's h1 * dsc, then dk
  float* DV = DK + EP;   // the LayerNorm's normalised r, then dv
  float* M = DV + EP;    // [H][S] row max
  float* Z = M + H * S;  // [H][S] inverse normaliser
  float* DL = Z + H * S;  // [H][S] delta
  float* SC = M;          // [S] pooling weights (before the layers)
  float* DSC = M + S;     // [S]
  float* SCR = lay.extra ? DL + H * S + (3 * H * S & 1) : X;  // the routine's scratch
  float* W = DL + H * S + (3 * H * S & 1) + lay.extra;         // the layer's weights
  float* PW = W;                         // the pooling MLP (before the layers)
  float* GP = W + 4 * EE + 2 * E;        // [E]
  float* red = GP + E;                   // [32]
  const int b = blockIdx.x;
  const Offsets off(E, L);
  auto put = [&](int idx, float v) { io.part[static_cast<long long>(idx) * p.B + b] = v; };

  // ---- pooling backward (on the saved final y) ----
  load_pool(PW, p);
  for (int e = threadIdx.x; e < E; e += blockDim.x) GP[e] = __ldg(io.g + b * E + e);
  load_rows(X, io.ysave + (static_cast<long long>(b) * L + L - 1) * E * S, E, S, P);
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) SC[s] = pool_score(PW, X, s, E, P);
  __syncthreads();
  softmax_cols(SC, S, red);
  float part = 0.f;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float dw = 0.f;
    for (int e = 0; e < E; ++e) dw = fmaf(GP[e], X[e * P + s], dw);
    DSC[s] = dw;
    part = fmaf(dw, SC[s], part);
  }
  const float tot = attn::block_sum(part, red);
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float dsc = (DSC[s] - tot) * SC[s];
    for (int f = 0; f < E; ++f) {
      float pre = 0.f;
      for (int e = 0; e < E; ++e) pre = fmaf(PW[e * E + f], X[e * P + s], pre);
      const float h1 = tanhf(pre + PW[EE + f]);
      DQ[f * P + s] = (PW[EE + E + f] * dsc) * (1.f - h1 * h1);
      DK[f * P + s] = h1 * dsc;
    }
    for (int e = 0; e < E; ++e) {
      float acc = 0.f;
      for (int f = 0; f < E; ++f) acc = fmaf(PW[e * E + f], DQ[f * P + s], acc);
      DY[e * P + s] = GP[e] * SC[s] + acc;
    }
  }
  __syncthreads();
  col_products(X, DQ, E, E, S, P, [&](int e, int f, float v) { put(off.w1 + e * E + f, v); });
  for (int f = threadIdx.x; f < E; f += blockDim.x) {
    float db = 0.f, dw = 0.f;
    for (int s = 0; s < S; ++s) {
      db += DQ[f * P + s];
      dw += DK[f * P + s];
    }
    put(off.b1 + f, db);
    put(off.w2 + f, dw);
  }

  // ---- the layers, last to first ----
  const float* G = W + 4 * EE;
  for (int l = L - 1; l >= 0; --l) {
    __syncthreads();
    load_layer(W, p, l);
    load_rows(X, l == 0 ? p.x + static_cast<long long>(b) * E * S
                        : io.ysave + (static_cast<long long>(b) * L + l - 1) * E * S,
              E, S, P);
    load_rows(DQ, io.osave + (static_cast<long long>(b) * L + l) * E * S, E, S, P);
    load_rows(M, io.m + (static_cast<long long>(b) * L + l) * H * S, H, S, S);
    load_rows(Z, io.z + (static_cast<long long>(b) * L + l) * H * S, H, S, S);
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      if (p.layer_norm) {
        out_proj<DH>(W, DQ, X, DR, s, E, H, P, p.residual);
        float mu, rstd;
        ln_stats(DR, s, E, P, p.eps, &mu, &rstd);
        float mt = 0.f, mtr = 0.f;
        for (int f = 0; f < E; ++f) {
          const float rh = (DR[f * P + s] - mu) * rstd;
          DV[f * P + s] = rh;
          const float t = G[f] * DY[f * P + s];
          mt += t;
          mtr = fmaf(t, rh, mtr);
        }
        mt /= E;
        mtr /= E;
        for (int f = 0; f < E; ++f) {
          const float t = G[f] * DY[f * P + s];
          DR[f * P + s] = (t - mt - DV[f * P + s] * mtr) * rstd;
        }
      } else {
        for (int f = 0; f < E; ++f) DR[f * P + s] = DY[f * P + s];
      }
      const float* WO = W + 3 * EE;
      for (int h = 0; h < H; ++h) {
        float delta = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          const int c = h * DH + d;
          float acc = 0.f;
          for (int f = 0; f < E; ++f) acc = fmaf(WO[c * E + f], DR[f * P + s], acc);
          DO[c * P + s] = acc;
          delta = fmaf(acc, DQ[c * P + s], delta);
        }
        DL[h * S + s] = delta;
      }
      project<DH>(W, X, Q, K, V, s, E, H, P, P);
    }
    __syncthreads();
    if (p.layer_norm) {
      for (int f = threadIdx.x; f < E; f += blockDim.x) {
        float dg = 0.f, db = 0.f;
        for (int s = 0; s < S; ++s) {
          dg = fmaf(DY[f * P + s], DV[f * P + s], dg);
          db += DY[f * P + s];
        }
        put(off.gamma + l * E + f, dg);
        put(off.beta + l * E + f, db);
      }
    } else {
      for (int f = threadIdx.x; f < E; f += blockDim.x) {
        put(off.gamma + l * E + f, 0.f);
        put(off.beta + l * E + f, 0.f);
      }
    }
    col_products(DQ, DR, E, E, S, P,
                 [&](int c, int f, float v) { put(off.wo + l * EE + c * E + f, v); });
    __syncthreads();

    // attention backward per head (the routine ends on a barrier)
    for (int h = 0; h < H; ++h) {
      const int c = h * DH * P;
      attn_tc::attn_bwd_head<DH, false>(Q + c, K + c, V + c, DO + c, M + h * S, Z + h * S,
                                        DL + h * S, S, P, p.scale, SCR, lay.nbuf, lay.ch,
                                        HeadOut{DQ + c, DK + c, DV + c, P});
    }
    if (!lay.extra) {  // X lent its rows to the routine
      load_rows(X, l == 0 ? p.x + static_cast<long long>(b) * E * S
                          : io.ysave + (static_cast<long long>(b) * L + l - 1) * E * S,
                E, S, P);
      __syncthreads();
    }

    // projection gradients, and dx into DY (the next layer's dy)
    auto head_major = [&](int base, int e, int c, float v) {
      put(base + l * EE + ((c / DH) * E + e) * DH + c % DH, v);
    };
    col_products(X, DQ, E, E, S, P, [&](int e, int c, float v) { head_major(off.wq, e, c, v); });
    col_products(X, DK, E, E, S, P, [&](int e, int c, float v) { head_major(off.wk, e, c, v); });
    col_products(X, DV, E, E, S, P, [&](int e, int c, float v) { head_major(off.wv, e, c, v); });
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      for (int e = 0; e < E; ++e) {
        float dx = p.residual ? DR[e * P + s] : 0.f;
        for (int h = 0; h < H; ++h) {
          float tq = 0.f, tk = 0.f, tv = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            const int w = (h * E + e) * DH + d;
            const int c = (h * DH + d) * P + s;
            tq = fmaf(W[w], DQ[c], tq);
            tk = fmaf(W[EE + w], DK[c], tk);
            tv = fmaf(W[2 * EE + w], DV[c], tv);
          }
          dx += tq;
          dx += tk;
          dx += tv;
        }
        DY[e * P + s] = dx;
      }
    }
  }
  __syncthreads();
  float* dxb = io.dx + static_cast<long long>(b) * E * S;
  for (int i = threadIdx.x; i < E * S; i += blockDim.x) {
    const int e = i / S;
    dxb[i] = DY[e * P + i - e * S];
  }
}

// out[q] = sum_b part[q][b] in a fixed order (a block per parameter)
__global__ void __launch_bounds__(attn::MAX_THREADS)
ab_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int B) {
  const float* row = part + static_cast<long long>(blockIdx.x) * B;
  float acc = 0.f;
  for (int b = threadIdx.x; b < B; b += blockDim.x) acc += __ldg(row + b);
  acc = attn::block_sum(acc, attn_smem);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

template <int DH>
int launch_bwd(Params p, BwdIo io, float* grads, cudaStream_t st) {
  auto kern = ab_bwd_kernel<DH>;
  const int smem = BwdLayout(p.E, p.S, p.H).floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p, &io};
  err = cudaLaunchKernel(kern, dim3(p.B), dim3(attn::threads_for(p.S)), args,
                         static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* part = io.part;
  int B = p.B;
  void* rargs[] = {&part, &grads, &B};
  err = cudaLaunchKernel(ab_reduce_kernel, dim3(Offsets(p.E, p.L).np), dim3(attn::MAX_THREADS),
                         rargs, 32 * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, contiguity, B >= 1, E = H * dh with
// 1 <= dh <= 16, L >= 1, the shared memory and 32-bit offsets within a row,
// passed ab_fwd's saved m, z, osave and ysave, and allocated dx [B, E, S],
// part [NP, B] and grads [NP] (NP = ab_num_params(E, L)).
int ab_bwd(const void* x, const void* wq, const void* wk, const void* wv, const void* wo,
           const void* gamma, const void* beta, const void* w1, const void* b1, const void* w2,
           const void* g, const void* m, const void* z, const void* osave, const void* ysave,
           void* dx, void* part, void* grads, int B, int E, int S, int L, int H, float scale,
           float eps, int residual, int layer_norm, void* stream) {
  const Params p = make_params(x, wq, wk, wv, wo, gamma, beta, w1, b1, w2, B, E, S, L, H,
                               scale, eps, residual, layer_norm);
  BwdIo io;
  io.g = static_cast<const float*>(g);
  io.m = static_cast<const float*>(m);
  io.z = static_cast<const float*>(z);
  io.osave = static_cast<const float*>(osave);
  io.ysave = static_cast<const float*>(ysave);
  io.dx = static_cast<float*>(dx);
  io.part = static_cast<float*>(part);
  const int dh = E / H;
  ATTN_DISPATCH_DH(dh, launch_bwd, p, io, static_cast<float*>(grads),
                   static_cast<cudaStream_t>(stream))
}

// shared-memory bytes of the forward and backward kernels, and the number of
// parameter-gradient entries (the card tests hold ops/attn_block_cuda.py's
// formulas against these)
int ab_smem_bytes(int E, int S, int H, int backward) {
  return (backward ? BwdLayout(E, S, H).floats : fwd_floats(E, S)) *
         static_cast<int>(sizeof(float));
}

int ab_num_params(int E, int L) { return Offsets(E, L).np; }

const char* ab_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
