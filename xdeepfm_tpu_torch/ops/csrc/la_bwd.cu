// Lane attention for AutoInt / DIFM, backward (la_bwd), for Hopper
// (sm_90a), behind a plain C interface that ops/lane_attention_cuda.py loads
// with ctypes.  The exact gradients of la_fwd.cu for an upstream g, from q, k
// and v alone (p recomputed), per (head, sample), with dp[i, j] =
// sum_d g[d, i] v[d, j], delta[i] = sum_j dp[i, j] p[i, j] and
// ds[i, j] = p[i, j] (dp[i, j] - delta[i]) * scale:
//
//   dv[d, j] = sum_i p[i, j] g[d, i]
//   dq[d, i] = sum_j ds[i, j] k[d, j]      dk[d, j] = sum_i ds[i, j] q[d, i]
//
// Replaces: xdeepfm_tpu/ops/lane_attention.py _la_bwd / _bwd_kernel.
//
// Bound: bytes.  At the AutoInt train shape (B = 4096, H = 2, dh = 5,
// S = 26) the function reads q, k, v and g and writes dq, dk and dv once,
// 29.8 MB, 8.9 us at 3.35 TB/s, against 0.28 GFLOP (10 S^2 dh a pair,
// 4.1 us at the fp32 rate) and 5.5 M exps (1.3 us).
//
// Design (la_common.cuh): a warp per (sample, head) pair, a lane per query
// row, the pair's q, k, v and g tiles in shared memory.  Lane i computes
// each score, dp and exp of its row once:
//  1. t[i, j] = scale q_i . k_j and dp[i, j] = g_i . v_j, with the row max;
//  2. e[i, j] = exp(t[i, j] - max), the sum z and sum_j e dp;
//  3. p = e / z, delta = sum_j e dp / z, ds = p (dp - delta) scale, and
//     dq_i = sum_j ds[i, j] k_j in registers;
// the rows live in registers (S <= 32: the key loops are unrolled to 32
// and leave at S) or in the warp's scratch (S <= 64, two rows a lane).
// Step 3 writes the p and ds rows into the warp's [S][S | 1] scratch (an
// odd row pitch, so the rows' writes and the columns' reads are free of
// bank conflicts); after __syncwarp, lane j sums its columns, dv_j = sum_i
// p[i, j] g_i and dk_j = sum_i ds[i, j] q_i, in the order i = 0, 1, ...,
// with q_i and g_i read as broadcasts, and writes them over its own k and v
// rows; after another __syncwarp, dq over the lane's q row; the block's copy
// takes the three out.  Every sum is one lane's loop in a fixed order and
// every pair is one warp's, so there are no atomics and the gradients are
// bit-equal from run to run.  What the earlier kernel (a thread a row, then
// a thread a column, over [dh][S][P] tiles of one head) lost its time to,
// and what this does about it:
//  - each score computed four times, each dp and exp three: once here;
//  - tile copies with two divisions and two modulos by runtime values an
//    element: coordinates stepped with carries (la_common.cuh);
//  - dh 5 run as 8 with masked steps: an exact dh-5 build;
//  - a block of one head, reading 20 of every 40 bytes of a [B, S, E] row:
//    all heads of W samples a block, one contiguous run;
//  - cudaFuncSetAttribute at every launch: once a device (allow_smem).
//
// Occupancy (ptxas -v; 4 pairs a block, 4 tiles and 2 S x (S | 1) scratch a
// pair): dh 5 at S <= 32 takes 94 registers, so 20 warps (5 blocks of
// 30.9 KB at S 26) an SM; at S 64 the scratch is 33 KB a pair and one block
// of 154 KB fits an SM (4 warps): the limit shape runs, slowly.  dh 16 takes
// 142 (S <= 32) and 140 (S 64) registers.  No build spills.
//
// Measured (bench_lane.py and chip_smoke.py, torch.profiler's kernel time
// a launch, NVIDIA H100 80GB HBM3 at 700 W): 0.029-0.030 ms at the AutoInt
// train shape (3.3x the byte bound; the earlier kernel 0.107 in the same
// call), 0.056 ms at B 8192, 0.040 ms on the contiguous [H, dh, S, B]
// layout.  Blocks of 4 pairs ran faster than 8 (more of them an SM).
#include <cfloat>
#include <cmath>

#include "la_common.cuh"

namespace {

constexpr int BWD_WARPS = 4;  // pairs a block

template <int DMAX, bool EXACT, int R>
__global__ void __launch_bounds__(32 * BWD_WARPS)
la_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g_,
              float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, la::Geom g,
              la::Strides st, float scale) {
  const int S = g.S, dh = g.dh, np = g.W * g.HB;
  const int b0 = blockIdx.x * g.W, nw = min(g.W, g.B - b0);
  const int lane = threadIdx.x % 32, pair = threadIdx.x / 32;
  const int w = pair / g.HB, hh = pair - w * g.HB;
  const int b = b0 + w, h = blockIdx.y * g.HB + hh;
  const bool live = w < nw && h < g.H;
  const int ostride = np * g.tile;
  float* tiles = la_smem;  // [4][np][tile]: q (then dq), k (then dk), v (then dv), g
  float* qt = tiles + pair * g.tile;
  float* kt = qt + ostride;
  float* vt = kt + ostride;
  const float* gt = vt + ostride;
  float* ps = tiles + 4 * ostride + pair * 2 * S * g.pitch;  // [S][pitch] p, then [S][pitch] ds
  float* dss = ps + S * g.pitch;
  const float* const in[4] = {q, k, v, g_};
  la::copy<DMAX, EXACT, R, true>(g, st, tiles, ostride, in, b0, nw, pair, live, h, b, lane);
  __syncthreads();

  if (live) {
    // a lane past the last row computes a copy of row S - 1 and stores nothing
    float qi[R][DMAX], gi[R][DMAX], dqi[R][DMAX], m[R], z[R], edp[R];
    bool own[R];
    // the scores, then the exps, then p; dp, then ds (R = 2: in place in the
    // p and ds scratch rows)
    la::Rows<R> t, dp;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      own[r] = lane + 32 * r < S;
      const int i = own[r] ? lane + 32 * r : S - 1;
      la::Tile<DMAX>::load(qt, S, i, qi[r]);
      la::Tile<DMAX>::load(gt, S, i, gi[r]);
#pragma unroll
      for (int d = 0; d < DMAX; ++d) dqi[r][d] = 0.f;
      m[r] = -FLT_MAX;
      z[r] = 0.f;
      edp[r] = 0.f;
      if constexpr (R > 1) {
        (r == 0 ? t.r0 : t.r1) = ps + i * g.pitch;
        (r == 0 ? dp.r0 : dp.r1) = dss + i * g.pitch;
      }
    }
    // The key loops run to 32 over the register rows (R = 1), unrolled in
    // full so that every index into them is a constant, and to S over the
    // scratch rows (R = 2), not unrolled, which keeps the wider builds from
    // spilling.
    const int keys = R == 1 ? 32 : S;
    // 1. scores and dp, the row max
#pragma unroll
    for (int j = 0; j < keys; ++j) {
      if (j >= S) break;
      float kj[DMAX], vj[DMAX];
      la::Tile<DMAX>::load(kt, S, j, kj);
      la::Tile<DMAX>::load(vt, S, j, vj);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float s = la::dot<DMAX, EXACT>(qi[r], kj, dh) * scale;
        t.set(r, j, s, own[r]);
        dp.set(r, j, la::dot<DMAX, EXACT>(gi[r], vj, dh), own[r]);
        m[r] = fmaxf(m[r], s);
      }
    }
    // 2. one exp per (i, j), the sum and sum_j e dp
#pragma unroll
    for (int j = 0; j < keys; ++j) {
      if (j >= S) break;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float e = expf(t.get(r, j) - m[r]);
        z[r] += e;
        edp[r] = fmaf(e, dp.get(r, j), edp[r]);
        t.set(r, j, e, own[r]);
      }
    }
    float inv[R], delta[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      inv[r] = 1.f / z[r];
      delta[r] = edp[r] * inv[r];
    }
    // 3. p and ds into the scratch rows, dq in registers
#pragma unroll
    for (int j = 0; j < keys; ++j) {
      if (j >= S) break;
      float kj[DMAX];
      la::Tile<DMAX>::load(kt, S, j, kj);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = t.get(r, j) * inv[r];
        const float ds = p * (dp.get(r, j) - delta[r]) * scale;
        la::axpy<DMAX, EXACT>(dqi[r], ds, kj, dh);
        t.set(r, j, p, own[r]);
        dp.set(r, j, ds, own[r]);
        if (R == 1 && own[r]) {  // the register rows into the scratch
          ps[lane * g.pitch + j] = p;
          dss[lane * g.pitch + j] = ds;
        }
      }
    }
    __syncwarp();
    // columns: lane j sums dv_j and dk_j over the queries in order
    float dkj[R][DMAX], dvj[R][DMAX];
    int col[R];
#pragma unroll
    for (int c = 0; c < R; ++c) {
      col[c] = lane + 32 * c < S ? lane + 32 * c : S - 1;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) dkj[c][d] = dvj[c][d] = 0.f;
    }
#pragma unroll 2
    for (int i = 0; i < S; ++i) {
      float qr[DMAX], gr[DMAX];
      la::Tile<DMAX>::load(qt, S, i, qr);
      la::Tile<DMAX>::load(gt, S, i, gr);
#pragma unroll
      for (int c = 0; c < R; ++c) {
        la::axpy<DMAX, EXACT>(dvj[c], ps[i * g.pitch + col[c]], gr, dh);
        la::axpy<DMAX, EXACT>(dkj[c], dss[i * g.pitch + col[c]], qr, dh);
      }
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      if (lane + 32 * c >= S) continue;
      la::Tile<DMAX>::store(kt, S, lane + 32 * c, dkj[c]);  // no lane reads k or v now
      la::Tile<DMAX>::store(vt, S, lane + 32 * c, dvj[c]);
    }
    __syncwarp();  // every lane is done with q
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (own[r]) la::Tile<DMAX>::store(qt, S, lane + 32 * r, dqi[r]);
  }
  __syncthreads();
  float* const out[3] = {dq, dk, dv};
  la::copy<DMAX, EXACT, R, false>(g, st, tiles, ostride, out, b0, nw, pair, live, h, b, lane);
}

template <int DMAX, bool EXACT, int R>
int launch_bwd(const float* q, const float* k, const float* v, const float* g_, float* dq,
               float* dk, float* dv, int B, int H, int S, int dh, la::Strides st, float scale,
               cudaStream_t stream) {
  auto kern = la_bwd_kernel<DMAX, EXACT, R>;
  la::Geom g{B, H, S, dh, 0, 0, la::round4(S * DMAX), la::odd_pitch(S), 0};
  const int per_pair = (4 * g.tile + 2 * S * g.pitch) * static_cast<int>(sizeof(float));
  la::cut(g, BWD_WARPS, per_pair, st);
  const int smem = g.W * g.HB * per_pair;
  static bool smem_set[la::MAX_DEVICES] = {};
  cudaError_t err = la::allow_smem(kern, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&q, &k, &v, &g_, &dq, &dk, &dv, &g, &st, &scale};
  err = cudaLaunchKernel(kern, dim3((B + g.W - 1) / g.W, (H + g.HB - 1) / g.HB),
                         dim3(32 * g.W * g.HB), args, static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, that q, k, v, g, dq, dk and dv share the
// element strides (sh, sd, ss, sb), B >= 1, 1 <= H <= 65535, 1 <= dh <= 16 and
// 1 <= S <= 64, and allocated dq, dk, dv.
int la_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, int B, int H, int S, int dh, long long sh, long long sd, long long ss,
           long long sb, float scale, void* stream) {
  const la::Strides st{sh, sd, ss, sb};
  LA_DISPATCH(dh, S, launch_bwd, static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(g),
              static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), B, H, S,
              dh, st, scale, static_cast<cudaStream_t>(stream))
}

const char* la_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
