// GRU / AGRU / AUGRU recurrence for DIEN, forward (gru_fwd), for Hopper
// (sm_90a), behind a plain C interface that ops/gru_cuda.py loads with
// ctypes.  Per sample and step t, on the batch-major operands of
// gru_common.cuh:
//
//   r = sigmoid(gi_r + W_r h + b_r),  n = tanh(gi_n + r (W_n h + b_n))
//   u = 1 - sigmoid(gi_z + W_z h + b_z)   (gru)
//       att[t]                            (agru)
//       att[t] sigmoid(gi_z + W_z h + b_z) (augru)
//   h = h + valid u (n - h),  valid = t < length,  outs[t] = h
//
// so the state freezes past each row's length and a length-0 row keeps h0.
//
// Replaces: xdeepfm_tpu/ops/gru_pallas.py _gs_fwd / _fwd_kernel (step
// _step_fwd).
//
// Bound: bytes.  At DIEN's train shape (B 4096, T 50, H 10) it reads gi
// (24.6 MB), att, lengths and h0 and writes outs (8.2 MB), ~34 MB, against
// ~0.13 GFLOP.  But the 50 steps depend on each other, so what sets the time
// is one step's latency times T.  Design: a thread per (sample, unit), 16
// lanes a sample at H 10 (B H = 40 960 live lanes, 16 warps an SM at B 4096);
// the unit's three weight rows live in registers and h is exchanged by H
// shuffles a step, so a step touches no shared memory and no barrier; step
// t + 1's gi and att are loaded before step t computes, so the loads' latency
// hides behind a step's math instead of adding up over the 50 steps.

#include <cmath>

#include "gru_common.cuh"

namespace {

template <int CELL, int G>
__global__ void __launch_bounds__(gru::THREADS)
gru_fwd_kernel(const float* __restrict__ gi, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ att,
               const int* __restrict__ lengths, const float* __restrict__ h0,
               float* __restrict__ outs, int B, int T, int H) {
  const int i = threadIdx.x % G;
  const long long s = static_cast<long long>(blockIdx.x) * (gru::THREADS / G) + threadIdx.x / G;
  const bool in_batch = s < B;
  const bool live = in_batch && i < H;
  float wr[G], wz[G], wn[G], hp[G], br, bz, bn;
  gru::load_rows<G>(w, bias, H, i, live, wr, wz, wn, br, bz, bn);
  const int len = in_batch ? lengths[s] : 0;
  float h = live ? h0[s * H + i] : 0.f;
  const long long step = 3LL * H;
  const float* x = gi + (live ? s * T * step + i : 0);
  const float* a_row = CELL == gru::CELL_GRU ? nullptr : att + (in_batch ? s * T : 0);
  float* o = outs + (live ? s * T * H + i : 0);

  float xr = 0.f, xz = 0.f, xn = 0.f, xa = 0.f;
  auto load = [&](int t) {
    if (live) {
      const float* xt = x + t * step;
      xr = xt[0];
      if (CELL != gru::CELL_AGRU) xz = xt[H];
      xn = xt[2 * H];
    }
    if (CELL != gru::CELL_GRU && in_batch) xa = a_row[t];
  };
  load(0);
  for (int t = 0; t < T; ++t) {
    const float ir = xr, iz = xz, in = xn, a = xa;
    if (t + 1 < T) load(t + 1);  // in flight while this step computes
    float ar = br, az = bz, an = bn;
    gru::recurrent<G>(wr, wz, wn, h, hp, ar, az, an);
    const float r = gru::sigmoid(ir + ar);
    const float n = tanhf(in + r * an);
    float u;
    if (CELL == gru::CELL_AGRU) {
      u = a;
    } else {
      const float z = gru::sigmoid(iz + az);
      u = CELL == gru::CELL_GRU ? 1.f - z : a * z;
    }
    const float v = t < len ? 1.f : 0.f;
    h = h + (v * u) * (n - h);
    if (live) o[static_cast<long long>(t) * H] = h;
  }
}

template <int CELL, int G>
int launch_fwd(const float* gi, const float* w, const float* b, const float* att,
               const int* lengths, const float* h0, float* outs, int B, int T, int H,
               cudaStream_t stream) {
  auto kern = gru_fwd_kernel<CELL, G>;
  constexpr int per = gru::THREADS / G;
  void* args[] = {&gi, &w, &b, &att, &lengths, &h0, &outs, &B, &T, &H};
  cudaError_t err =
      cudaLaunchKernel(kern, dim3((B + per - 1) / per), dim3(gru::THREADS), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes and contiguity, 0 <= cell <= 2,
// 1 <= H <= 16, T >= 1, B >= 1 and att present unless cell is gru, and
// allocated outs.
int gru_fwd(int cell, const void* gi, const void* w, const void* b, const void* att,
            const void* lengths, const void* h0, void* outs, int B, int T, int H, void* stream) {
  GRU_DISPATCH(cell, H, launch_fwd, static_cast<const float*>(gi), static_cast<const float*>(w),
               static_cast<const float*>(b), static_cast<const float*>(att),
               static_cast<const int*>(lengths), static_cast<const float*>(h0),
               static_cast<float*>(outs), B, T, H, static_cast<cudaStream_t>(stream))
}

const char* gru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
