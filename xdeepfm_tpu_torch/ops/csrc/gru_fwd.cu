// GRU / AGRU / AUGRU recurrence for DIEN, forward (gru_fwd), for Hopper
// (sm_90a), behind a plain C interface that ops/gru_cuda.py loads with
// ctypes.  Per sample and step t, on the batch-major operands of
// gru_common.cuh:
//
//   r = sigmoid(gi_r + W_r h + b_r),  n = tanh(gi_n + r (W_n h + b_n))
//   u = 1 - sigmoid(gi_z + W_z h + b_z)   (gru)
//       att[t]                            (agru)
//       att[t] sigmoid(gi_z + W_z h + b_z) (augru)
//   h = h + u (n - h) where t < length, else h unchanged;  outs[t] = h
//
// so the state freezes past each row's length and a length-0 row keeps h0.
//
// Replaces: xdeepfm_tpu/ops/gru_pallas.py _gs_fwd / _fwd_kernel (step
// _step_fwd).
//
// Bound: bytes.  At DIEN's train shape (B 4096, T 50, H 10, lengths uniform
// in 1..50, about half the (sample, step) pairs valid) it reads gi and att
// at the valid steps (~12.6 MB) and writes outs (8.2 MB), ~21 MB, against
// ~0.07 GFLOP.  But the steps of a row depend on each other: one step's
// latency times the longest row's steps sets the time (a lone warp runs
// about as fast as a full card), and the issue slots of the warps that
// share a scheduler come next.  Design (gru_common.cuh): a sample on
// exactly H lanes, the unit's three weight rows in registers, h exchanged
// through a double-buffered shared-memory row a step (one store, one
// __syncwarp, HP / 4 broadcast loads), each lane's gi and att loaded into
// registers AHEAD steps ahead (the loop over a chunk's steps is unrolled,
// so each step's slot is a register of its own), and each warp's steps
// stopped at its longest row: past it the lanes only store the frozen
// state.

#include <cmath>

#include "gru_common.cuh"

namespace {

constexpr int WARPS = 1;  // warps a block: the warps spread evenly over the SMs
constexpr int AHEAD = 6;  // steps a lane's gi and att are loaded ahead

// A warp's shared memory: the two exchange rows [2][SPW][HP].
template <int H>
struct FwdSmem {
  using L = gru::Lanes<H, WARPS>;
  static constexpr int XCH = L::SPW * L::HP;
  static constexpr size_t BYTES = sizeof(float) * WARPS * 2 * XCH;
};

template <int CELL, int H>
__global__ void __launch_bounds__(32 * WARPS)
gru_fwd_kernel(const float* __restrict__ gi, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ att,
               const int* __restrict__ lengths, const float* __restrict__ h0,
               float* __restrict__ outs, int B, int T) {
  using L = gru::Lanes<H, WARPS>;
  using M = FwdSmem<H>;
  constexpr int C = AHEAD, HP = L::HP, STEP = L::STEP;
  constexpr bool HAS_Z = CELL != gru::CELL_AGRU, HAS_ATT = CELL != gru::CELL_GRU;
  const L ln(B);
  const int i = ln.i;
  float wr[H], wz[H], wn[H], br, bz, bn;
  gru::load_rows<H>(w, bias, i, ln.active, wr, wz, wn, br, bz, bn);
  int longest;
  const int len = gru::row_length(lengths, ln.s, ln.live, T, longest);
  float h = ln.live ? h0[ln.s * H + i] : 0.f;
  float* o = outs + (ln.live ? ln.s * T * H + i : 0);
  float* row0 = gru_smem + ln.warp * 2 * M::XCH + ln.slot * HP;  // even steps' exchange row
  float* row1 = row0 + M::XCH;                                    // odd steps'

  // slot u holds step t0 + u's gi (r, z, n) and att, loaded C steps ahead
  const float* x = gi + (ln.live ? ln.s * T * STEP + i : 0);
  const float* a = att + (HAS_ATT && ln.live ? ln.s * T : 0);
  float xr[C], xz[C], xn[C], xa[C];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    xr[u] = xz[u] = xn[u] = xa[u] = 0.f;
    if (u < len) {
      xr[u] = x[u * STEP];
      if (HAS_Z) xz[u] = x[u * STEP + H];
      xn[u] = x[u * STEP + 2 * H];
      if (HAS_ATT) xa[u] = a[u];
    }
  }
  for (int t0 = 0; t0 < longest; t0 += C) {
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int t = t0 + u;
      if (t < longest) {  // the same for the whole warp
        float* row = (u & 1) ? row1 : row0;  // AHEAD is even: t's parity is u's
        if (ln.active) row[i] = h;
        __syncwarp();
        const float gr = xr[u], gz = xz[u], gn = xn[u], at = xa[u];
        if (t + C < len) {  // step t + C into the slot just read
          const float* xt = x + (t + C) * STEP;
          xr[u] = xt[0];
          if (HAS_Z) xz[u] = xt[H];
          xn[u] = xt[2 * H];
          if (HAS_ATT) xa[u] = a[t + C];
        }
        // every lane runs the step (an idle lane or one past B on its
        // zeros) and only a live lane stores: no branch a step
        float hv[H];
        gru::read_row<H>(row, hv);
        float ar = br, az = bz, an = bn;
        gru::recurrent<H, HAS_Z>(wr, wz, wn, hv, ar, az, an);
        const float r = gru::sigmoid(gr + ar);
        const float n = tanhf(gn + r * an);
        float uu;
        if (CELL == gru::CELL_AGRU) {
          uu = at;
        } else {
          const float z = gru::sigmoid(gz + az);
          uu = CELL == gru::CELL_GRU ? 1.f - z : at * z;
        }
        if (t < len) h = h + uu * (n - h);
        if (ln.live) o[static_cast<long long>(t) * H] = h;
      }
    }
  }
  // past the warp's longest row: the frozen state
  if (ln.live) {
    for (int t = longest; t < T; ++t) o[static_cast<long long>(t) * H] = h;
  }
}

template <int CELL, int H>
int launch_fwd(const float* gi, const float* w, const float* b, const float* att,
               const int* lengths, const float* h0, float* outs, int B, int T,
               cudaStream_t stream) {
  auto kern = gru_fwd_kernel<CELL, H>;
  static_assert(AHEAD % 2 == 0, "a step's exchange row follows its slot's parity");
  constexpr int per = WARPS * gru::Lanes<H, WARPS>::SPW;
  constexpr size_t smem = FwdSmem<H>::BYTES;
  static_assert(smem <= 48 * 1024, "the forward's shared memory fits the default limit");
  void* args[] = {&gi, &w, &b, &att, &lengths, &h0, &outs, &B, &T};
  cudaError_t err =
      cudaLaunchKernel(kern, dim3((B + per - 1) / per), dim3(32 * WARPS), args, smem, stream);
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
               static_cast<float*>(outs), B, T, static_cast<cudaStream_t>(stream))
}

const char* gru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
