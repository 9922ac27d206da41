// GRU / AGRU / AUGRU recurrence for DIEN, backward (gru_bwd), for Hopper
// (sm_90a), behind a plain C interface that ops/gru_cuda.py loads with
// ctypes.  For the cotangent g [B, T, H] of gru_fwd.cu's outs it walks
// t = T - 1 ... 0 (the TPU kernel's reverse sweep) with D = g[t] + dh:
//
//   ua = valid u, dn = D ua, du = valid D (n - h_prev)
//   dz_pre = -du z (1 - z) (gru), du att z (1 - z) (augru), 0 (agru)
//   datt[t] = sum_H du (agru), sum_H du z (augru), 0 (gru)
//   dn_pre = dn (1 - n^2), dhn = dn_pre r, dr_pre = dn_pre hn r (1 - r)
//   dgi[t] = (dr_pre, dz_pre, dn_pre); d(W h + b) = (dr_pre, dz_pre, dhn)
//   dW_g += d_g h_prev^T, db_g += d_g, dh = D (1 - ua) + sum_g W_g^T d_g
//
// and writes dh0 = dh after step 0.  Past a row's length valid = 0, so every
// dgi slice is exactly zero there and D passes through unchanged.
//
// Replaces: xdeepfm_tpu/ops/gru_pallas.py _gs_bwd / _bwd_kernel.
//
// The history: the TPU kernel re-runs the forward into five [T, H] VMEM
// histories per sample.  Here h before step t is the forward's own output
// outs[t - 1] (h0 at t = 0), read from device memory step by step, and r, z,
// n and W_n h + b_n are recomputed from it with the forward's arithmetic:
// no history is saved and no scratch is written.
//
// Bound: bytes.  At DIEN's train shape (B 4096, T 50, H 10) it reads gi
// (24.6 MB), outs and g (8.2 MB each), att, lengths, h0 and writes dgi
// (24.6 MB), datt and dh0, ~67 MB, against ~0.37 GFLOP.  As in the forward,
// step latency times T sets the time.  Design: the forward's thread per
// (sample, unit) with the gate rows in registers for the recompute and the
// gate columns for dh = sum_g W_g^T d_g (the d_g broadcast by shuffles);
// step t - 1's operands are loaded while step t computes.  dW and db: each
// thread accumulates its unit's rows over the steps in registers; a fixed
// butterfly sums the warp's samples, the block sums its warps in order into
// one partial per block (gru_bwd_kernel), and gru_bwd_sum_kernel sums the
// partials in a fixed order.  No atomics: two calls give bit-equal results.

#include <cmath>

#include "gru_common.cuh"

namespace {

constexpr int SUM_THREADS = 64;

template <int CELL, int G>
__global__ void __launch_bounds__(gru::THREADS)
gru_bwd_kernel(const float* __restrict__ g, const float* __restrict__ gi,
               const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ att, const int* __restrict__ lengths,
               const float* __restrict__ h0, const float* __restrict__ outs,
               float* __restrict__ dgi, float* __restrict__ datt, float* __restrict__ dh0,
               float* __restrict__ part, int B, int T, int H) {
  using gru::FULL;
  constexpr bool HAS_Z = CELL != gru::CELL_AGRU;
  const int i = threadIdx.x % G;
  const long long s = static_cast<long long>(blockIdx.x) * (gru::THREADS / G) + threadIdx.x / G;
  const bool in_batch = s < B;
  const bool live = in_batch && i < H;
  float wr[G], wz[G], wn[G], hp[G], br, bz, bn;
  gru::load_rows<G>(w, bias, H, i, live, wr, wz, wn, br, bz, bn);
  float cr[G], cz[G], cn[G];  // column i of each gate's weights: w[g][j][i]
  float dwr[G], dwz[G], dwn[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const bool on = live && j < H;
    cr[j] = on ? w[(0 * H + j) * H + i] : 0.f;
    cz[j] = on ? w[(1 * H + j) * H + i] : 0.f;
    cn[j] = on ? w[(2 * H + j) * H + i] : 0.f;
    dwr[j] = dwz[j] = dwn[j] = 0.f;
  }
  float dbr = 0.f, dbz = 0.f, dbn = 0.f;
  const int len = in_batch ? lengths[s] : 0;
  const long long step = 3LL * H;
  const float* x = gi + (live ? s * T * step + i : 0);
  const float* go = g + (live ? s * T * H + i : 0);
  const float* ho = outs + (live ? s * T * H + i : 0);
  const float* a_row = CELL == gru::CELL_GRU ? nullptr : att + (in_batch ? s * T : 0);
  float* dx = dgi + (live ? s * T * step + i : 0);
  const float h_init = live ? h0[s * H + i] : 0.f;

  float xr = 0.f, xz = 0.f, xn = 0.f, xa = 0.f, xg = 0.f, xh = 0.f;
  auto load = [&](int t) {
    if (live) {
      const float* xt = x + t * step;
      xr = xt[0];
      if (HAS_Z) xz = xt[H];
      xn = xt[2 * H];
      xg = go[static_cast<long long>(t) * H];
      xh = t > 0 ? ho[static_cast<long long>(t - 1) * H] : h_init;
    }
    if (CELL != gru::CELL_GRU && in_batch) xa = a_row[t];
  };
  load(T - 1);
  float dh = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const float ir = xr, iz = xz, in = xn, a = xa, gt = xg, h_prev = xh;
    if (t > 0) load(t - 1);  // in flight while this step computes
    // recompute the step from h_prev, as the forward did
    float ar = br, az = bz, an = bn;
    gru::recurrent<G>(wr, wz, wn, h_prev, hp, ar, az, an);
    const float r = gru::sigmoid(ir + ar);
    const float n = tanhf(in + r * an);
    float z = 0.f, u;
    if (CELL == gru::CELL_AGRU) {
      u = a;
    } else {
      z = gru::sigmoid(iz + az);
      u = CELL == gru::CELL_GRU ? 1.f - z : a * z;
    }
    const float v = t < len ? 1.f : 0.f;
    const float ua = v * u;
    const float D = gt + dh;
    const float dn = D * ua;
    const float dh_keep = D * (1.f - ua);
    const float du = v * (D * (n - h_prev));
    float dz_pre = 0.f, da = 0.f;
    if (CELL == gru::CELL_AGRU) {
      da = du;
    } else {
      float dz;
      if (CELL == gru::CELL_GRU) {
        dz = -du;
      } else {
        da = du * z;
        dz = du * a;
      }
      dz_pre = dz * z * (1.f - z);
    }
    const float dn_pre = dn * (1.f - n * n);
    const float dhn = dn_pre * r;
    const float dr_pre = dn_pre * an * r * (1.f - r);

    // datt[t]: the group's units summed by a fixed butterfly (every lane
    // ends with the same sum)
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2) da += __shfl_xor_sync(FULL, da, off);
    if (in_batch && i == 0) datt[s * T + t] = da;
    if (live) {
      float* d = dx + t * step;
      d[0] = dr_pre;
      d[H] = dz_pre;
      d[2 * H] = dn_pre;
    }
    dbr += dr_pre;
    dbz += dz_pre;
    dbn += dhn;
    float acc = dh_keep;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      dwr[j] = fmaf(dr_pre, hp[j], dwr[j]);
      dwn[j] = fmaf(dhn, hp[j], dwn[j]);
      acc = fmaf(cr[j], __shfl_sync(FULL, dr_pre, j, G), acc);
      if (HAS_Z) {
        dwz[j] = fmaf(dz_pre, hp[j], dwz[j]);
        acc = fmaf(cz[j], __shfl_sync(FULL, dz_pre, j, G), acc);
      }
      acc = fmaf(cn[j], __shfl_sync(FULL, dhn, j, G), acc);
    }
    dh = acc;
  }
  if (live) dh0[s * H + i] = dh;

  // this block's dW / db partial: the warp's samples by a fixed butterfly
  // over the lanes that hold the same unit, then the warps in order
#pragma unroll
  for (int off = G; off < 32; off *= 2) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      dwr[j] += __shfl_xor_sync(FULL, dwr[j], off);
      dwz[j] += __shfl_xor_sync(FULL, dwz[j], off);
      dwn[j] += __shfl_xor_sync(FULL, dwn[j], off);
    }
    dbr += __shfl_xor_sync(FULL, dbr, off);
    dbz += __shfl_xor_sync(FULL, dbz, off);
    dbn += __shfl_xor_sync(FULL, dbn, off);
  }
  constexpr int PER_WARP = 3 * G * G + 3 * G;  // [3][G][G] dW rows, then [3][G] db
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < G) {
    float* red = gru_smem + warp * PER_WARP;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      red[(0 * G + i) * G + j] = dwr[j];
      red[(1 * G + i) * G + j] = dwz[j];
      red[(2 * G + i) * G + j] = dwn[j];
    }
    red[3 * G * G + 0 * G + i] = dbr;
    red[3 * G * G + 1 * G + i] = dbz;
    red[3 * G * G + 2 * G + i] = dbn;
  }
  __syncthreads();
  const int n_w = 3 * H * H, n_all = n_w + 3 * H;  // part[block] = dW [3, H, H], db [3, H]
  for (int e = threadIdx.x; e < n_all; e += blockDim.x) {
    int src;
    if (e < n_w) {
      src = ((e / (H * H)) * G + (e / H) % H) * G + e % H;
    } else {
      src = 3 * G * G + ((e - n_w) / H) * G + (e - n_w) % H;
    }
    float sum = 0.f;
    for (int k = 0; k < gru::THREADS / 32; ++k) sum += gru_smem[k * PER_WARP + src];
    part[static_cast<long long>(blockIdx.x) * n_all + e] = sum;
  }
}

// sums[e] = sum over the nblk block partials part[p][e], one block per e:
// each thread sums p = tid, tid + SUM_THREADS, ... in order, then a fixed
// tree over the threads.
__global__ void __launch_bounds__(SUM_THREADS)
gru_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ sums, int nblk, int n) {
  const int e = blockIdx.x;
  float acc = 0.f;
  for (int p = threadIdx.x; p < nblk; p += SUM_THREADS) acc += part[static_cast<long long>(p) * n + e];
  gru_smem[threadIdx.x] = acc;
  __syncthreads();
  for (int off = SUM_THREADS / 2; off > 0; off /= 2) {
    if (threadIdx.x < off) gru_smem[threadIdx.x] += gru_smem[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[e] = gru_smem[0];
}

template <int CELL, int G>
int launch_bwd(const float* g, const float* gi, const float* w, const float* b, const float* att,
               const int* lengths, const float* h0, const float* outs, float* dgi, float* datt,
               float* dh0, float* part, float* sums, int nblk, int B, int T, int H,
               cudaStream_t stream) {
  constexpr int per = gru::THREADS / G;
  if (nblk != (B + per - 1) / per) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = gru_bwd_kernel<CELL, G>;
  const size_t smem = (gru::THREADS / 32) * (3 * G * G + 3 * G) * sizeof(float);
  void* args[] = {&g, &gi, &w, &b, &att, &lengths, &h0, &outs, &dgi, &datt, &dh0, &part,
                  &B, &T, &H};
  cudaError_t err = cudaLaunchKernel(kern, dim3(nblk), dim3(gru::THREADS), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int n = 3 * H * H + 3 * H;
  const float* cpart = part;
  void* sum_args[] = {&cpart, &sums, &nblk, &n};
  err = cudaLaunchKernel(gru_bwd_sum_kernel, dim3(n), dim3(SUM_THREADS), sum_args,
                         SUM_THREADS * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` and returns the first CUDA error (0 on
// success).  The caller has checked dtypes, shapes and contiguity,
// 0 <= cell <= 2, 1 <= H <= 16, T >= 1, B >= 1, att present unless cell is
// gru, nblk = ceil(B / (256 / G)) with G the lanes a sample, and allocated
// dgi, datt [B, T], dh0, part [nblk, 3H(H + 1)] and sums [3H(H + 1)]
// (dW [3, H, H] then db [3, H]).
int gru_bwd(int cell, const void* g, const void* gi, const void* w, const void* b,
            const void* att, const void* lengths, const void* h0, const void* outs, void* dgi,
            void* datt, void* dh0, void* part, void* sums, int nblk, int B, int T, int H,
            void* stream) {
  GRU_DISPATCH(cell, H, launch_bwd, static_cast<const float*>(g), static_cast<const float*>(gi),
               static_cast<const float*>(w), static_cast<const float*>(b),
               static_cast<const float*>(att), static_cast<const int*>(lengths),
               static_cast<const float*>(h0), static_cast<const float*>(outs),
               static_cast<float*>(dgi), static_cast<float*>(datt), static_cast<float*>(dh0),
               static_cast<float*>(part), static_cast<float*>(sums), nblk, B, T, H,
               static_cast<cudaStream_t>(stream))
}

const char* gru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
