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
// S = 26) the function moves q, k, v and o once, 17.0 MB, 5.1 us at
// 3.35 TB/s, against 0.11 GFLOP (4 S^2 dh a pair, 1.7 us at the fp32 rate)
// and 5.5 M exps (1.3 us).
//
// Design (la_common.cuh): a warp per (sample, head) pair, a lane per query
// row, the pair's q, k, v tiles in shared memory.  Lane i computes each
// score t[i, j] once (its dh FMAs against the broadcast k row) and keeps
// the row in registers (the key loop unrolled to 32 R and left at S) with
// its max; then one exp per (i, j), as exp2 with log2(e) folded into the
// scale, the sum and the v product.  For S > 32 a lane takes its two rows
// one after the other.  o goes over the lane's own q row and out with the
// block's copy.  What the earlier kernel (a thread a row over a [dh][S][P]
// tile of P = 256 / S samples of one head) lost its time to, and what this
// does about it:
//  - each score computed twice (a max walk, then an exp walk): once here;
//  - tile copies with two divisions and two modulos by runtime values an
//    element: coordinates stepped with carries (la_common.cuh);
//  - dh 5 run as 8 with masked steps: an exact dh-5 build;
//  - a block of one head, reading 20 of every 40 bytes of a [B, S, E] row:
//    all heads of W samples a block, one contiguous run;
//  - cudaFuncSetAttribute at every launch: once a device (allow_smem).
//
// Occupancy (ptxas -v; 8 pairs a block, 3 tiles a pair): dh 5 at S <= 32
// takes 64 registers, so 32 warps (4 blocks of 12.7 KB at S 26) an SM; at
// S 64, 94 registers, 2 blocks; dh 16 80 (S <= 32) and 126 (S 64).  No
// build spills.  At B 4096 and H 2 the 1024 blocks fill 528 slots in two
// rounds.
//
// Measured (bench_lane.py and chip_smoke.py, torch.profiler's kernel time
// a launch, NVIDIA H100 80GB HBM3 at 700 W): 0.0139-0.0140 ms at the
// AutoInt train shape (2.7x the byte bound; the earlier kernel
// 0.0492-0.0496 in the same call), 0.026 ms at B 8192, 0.0157 ms on the
// contiguous [H, dh, S, B] layout.  Alone, the copies run near the memory
// rate and the compute takes about two thirds of the time; within a block
// they add up.  A persistent loop that copied the next samples by cp.async
// while computing measured slower at the train shape (more registers).
#include <cfloat>
#include <cmath>

#include "la_common.cuh"

namespace {

constexpr int FWD_WARPS = 8;  // pairs a block

template <int DMAX, bool EXACT, int R>
__global__ void __launch_bounds__(32 * FWD_WARPS)
la_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, la::Geom g, la::Strides st,
              float scale) {
  const int S = g.S, dh = g.dh, np = g.W * g.HB;
  const int b0 = blockIdx.x * g.W, nw = min(g.W, g.B - b0);
  const int lane = threadIdx.x % 32, pair = threadIdx.x / 32;
  const int w = pair / g.HB, hh = pair - w * g.HB;
  const int b = b0 + w, h = blockIdx.y * g.HB + hh;
  const bool live = w < nw && h < g.H;
  const int ostride = np * g.tile;
  float* tiles = la_smem;  // [3][np][tile]: q (then o), k, v
  float* qt = tiles + pair * g.tile;
  const float* kt = qt + ostride;
  const float* vt = kt + ostride;
  const float* const in[3] = {q, k, v};
  la::copy<DMAX, EXACT, R, true>(g, st, tiles, ostride, in, b0, nw, pair, live, h, b, lane);
  __syncthreads();

  // the scores in base 2: exp(x) = exp2(x log2(e)), the factor folded into the scale
  const float scale2 = scale * 1.4426950408889634f;
  if (live) {
    // row lane + 32 r, one after the other, its scores in registers; a lane
    // past the last row computes a copy of row S - 1 and stores nothing
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      const bool own = lane + 32 * r < S;
      const int i = own ? lane + 32 * r : S - 1;
      float qi[DMAX], acc[DMAX], t[32 * R];
      la::Tile<DMAX>::load(qt, S, i, qi);
      float m = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < 32 * R; ++j) {
        if (j >= S) break;
        float kj[DMAX];
        la::Tile<DMAX>::load(kt, S, j, kj);
        t[j] = la::dot<DMAX, EXACT>(qi, kj, dh) * scale2;
        m = fmaxf(m, t[j]);
      }
#pragma unroll
      for (int d = 0; d < DMAX; ++d) acc[d] = 0.f;
      float z = 0.f;
#pragma unroll
      for (int j = 0; j < 32 * R; ++j) {
        if (j >= S) break;
        float vj[DMAX];
        la::Tile<DMAX>::load(vt, S, j, vj);
        const float e = exp2f(t[j] - m);
        z += e;
        la::axpy<DMAX, EXACT>(acc, e, vj, dh);
      }
      if (own) {
        const float inv = 1.f / z;
#pragma unroll
        for (int d = 0; d < DMAX; ++d) acc[d] *= inv;
        la::Tile<DMAX>::store(qt, S, i, acc);  // only this lane reads row i of q
      }
    }
  }
  __syncthreads();
  float* const out[1] = {o};
  la::copy<DMAX, EXACT, R, false>(g, st, tiles, ostride, out, b0, nw, pair, live, h, b, lane);
}

template <int DMAX, bool EXACT, int R>
int launch_fwd(const float* q, const float* k, const float* v, float* o, int B, int H, int S,
               int dh, la::Strides st, float scale, cudaStream_t stream) {
  auto kern = la_fwd_kernel<DMAX, EXACT, R>;
  la::Geom g{B, H, S, dh, 0, 0, la::round4(S * DMAX), la::odd_pitch(S), 0};
  const int per_pair = 3 * g.tile * static_cast<int>(sizeof(float));
  la::cut(g, FWD_WARPS, per_pair, st);
  const int smem = g.W * g.HB * per_pair;
  static bool smem_set[la::MAX_DEVICES] = {};
  cudaError_t err = la::allow_smem(kern, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&q, &k, &v, &o, &g, &st, &scale};
  err = cudaLaunchKernel(kern, dim3((B + g.W - 1) / g.W, (H + g.HB - 1) / g.HB),
                         dim3(32 * g.W * g.HB), args, static_cast<size_t>(smem), stream);
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
  LA_DISPATCH(dh, S, launch_fwd, static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<float*>(o), B, H, S, dh, st, scale,
              static_cast<cudaStream_t>(stream))
}

const char* la_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
