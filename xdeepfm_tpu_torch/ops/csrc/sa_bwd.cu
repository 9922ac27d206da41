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
// the five [S, S] products are 26.8 GFLOP: 0.401 ms on the fp32 FMA pipes,
// 0.163 ms on the tensor cores in 3xTF32 (three TF32 products each), and
// G * S^2 = 0.54 G exps, 0.128 ms on the special-function units.  Design:
// one block per pair, q, k, v and g [dh, P] and the row statistics in shared
// memory, and the head's backward in attn_bwd_tc.cuh: a warp per 16-key
// tile computes each score and exp once (the scores and dp by fp32 FMAs) and
// feeds e and ds straight into the dV, dK and dQ products, 3xTF32 on the
// tensor cores; the warps' dQ partials are added in a fixed order, a barrier
// every `ch` chunks of 16 queries.  No atomics: bit-equal from run to run.
// Shared memory: 4 dh P + 3 S floats plus the routine's scratch (P the
// routine's pitch; 87 KB at dh = 5, S = 256, with 8 chunks a step and two
// blocks an SM).

#include "attn_bwd_tc.cuh"

namespace {

// threads of a block: a warp per 16-key tile, at most MAX_THREADS
inline int bwd_threads(int S) {
  const int w = (S + 15) / 16;
  return 32 * (w < attn::MAX_THREADS / 32 ? w : attn::MAX_THREADS / 32);
}

// shared-memory floats of a block with `ch` chunks of queries a step
inline int bwd_floats_at(int dh, int S, int ch) {
  return 4 * dh * attn_tc::pitch(S) + 3 * S + (S & 1) +
         attn_tc::scratch_floats(dh, bwd_threads(S) / 32, 2, ch);
}

// chunks of 16 queries a step (a barrier a step): the most of 8, 4, 2, 1
// with which two blocks share an SM, else with which a block fits
inline int bwd_ch(int dh, int S) {
  const int limits[2] = {attn::TWO_BLOCK_SMEM_BYTES, attn::MAX_SMEM_BYTES};
  for (const int limit : limits) {
    for (int ch = 8; ch >= 1; ch /= 2) {
      if (bwd_floats_at(dh, S, ch) * 4 <= limit) return ch;
    }
  }
  return 1;
}

// shared-memory floats of a block (ops/attention_cuda.py repeats this)
inline int bwd_floats(int dh, int S) { return bwd_floats_at(dh, S, bwd_ch(dh, S)); }

// dq, dk, dv [dh][S] of one pair in device memory
struct PairOut {
  float* dq;
  float* dk;
  float* dv;
  int S;
  __device__ float* at(int which, int d, int col) const {
    return (which == 0 ? dq : which == 1 ? dk : dv) + d * S + col;
  }
};

template <int DH>
__global__ void __launch_bounds__(attn::MAX_THREADS, 2)
sa_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ o, const float* __restrict__ m_in,
              const float* __restrict__ z_in, float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, int S, float scale, int bf16, int ch) {
  const int P = attn_tc::pitch(S);
  float* qs = attn_smem;    // [DH][P] q
  float* ks = qs + DH * P;  // [DH][P] k
  float* vs = ks + DH * P;  // [DH][P] v
  float* gs = vs + DH * P;  // [DH][P] g
  float* ms = gs + DH * P;   // [S] row max
  float* zs = ms + S;        // [S] inverse normaliser
  float* dl = zs + S;        // [S] delta
  float* scratch = dl + S + (S & 1);  // the routine's stages and dQ partial slots
  const long long base = static_cast<long long>(blockIdx.x) * DH * S;
  const long long row = static_cast<long long>(blockIdx.x) * S;
  // fp32 as given: the routine rounds product operands to bf16 under "bf16"
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    float delta = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float gi = __ldg(g + base + d * S + i);
      delta = fmaf(gi, __ldg(o + base + d * S + i), delta);
      qs[d * P + i] = __ldg(q + base + d * S + i);
      ks[d * P + i] = __ldg(k + base + d * S + i);
      vs[d * P + i] = __ldg(v + base + d * S + i);
      gs[d * P + i] = gi;
    }
    ms[i] = __ldg(m_in + row + i);
    zs[i] = __ldg(z_in + row + i);
    dl[i] = delta;
  }
  __syncthreads();
  const PairOut out{dq + base, dk + base, dv + base, S};
  if (bf16)
    attn_tc::attn_bwd_head<DH, true>(qs, ks, vs, gs, ms, zs, dl, S, P, scale, scratch, 2, ch, out);
  else
    attn_tc::attn_bwd_head<DH, false>(qs, ks, vs, gs, ms, zs, dl, S, P, scale, scratch, 2, ch,
                                      out);
}

template <int DH>
int launch_bwd(const float* q, const float* k, const float* v, const float* g, const float* o,
               const float* m, const float* z, float* dq, float* dk, float* dv, int G, int S,
               float scale, int bf16, cudaStream_t st) {
  auto kern = sa_bwd_kernel<DH>;
  const int smem = bwd_floats(DH, S) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int ch = bwd_ch(DH, S);
  void* args[] = {&q, &k, &v, &g, &o, &m, &z, &dq, &dk, &dv, &S, &scale, &bf16, &ch};
  err = cudaLaunchKernel(kern, dim3(G), dim3(bwd_threads(S)), args,
                         static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, contiguity, G >= 1, 1 <= dh <= 16,
// S >= 1, the shared memory (sa_bwd_smem_bytes) and 32-bit offsets within a
// pair, and allocated dq, dk, dv [G, dh, S].
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

// shared-memory bytes of a block (the card tests hold ops/attention_cuda.py's
// formula against this)
int sa_bwd_smem_bytes(int dh, int S) {
  return bwd_floats(dh, S) * static_cast<int>(sizeof(float));
}

const char* sa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
