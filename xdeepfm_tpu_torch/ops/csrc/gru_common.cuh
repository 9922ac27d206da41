// Shared pieces of the GRU-scan kernels (gru_fwd.cu, gru_bwd.cu).
//
// Operands, batch-major, fp32 and contiguous: gi [B, T, 3, H] (the hoisted
// input gates r, z, n), w [3, H, H], b [3, H], att [B, T] (unused by cell
// gru), lengths [B] int32, h0 [B, H], outs [B, T, H].
//
// One thread per (sample, hidden unit).  A sample's units are the lanes of a
// shuffle group of G = 4, 8 or 16 lanes (a template bound, the smallest that
// holds H <= 16), so 32 / G samples share a warp and THREADS / G a block.
// A step needs the sample's whole h: lane j broadcasts h[j] with
// __shfl_sync within the group, and each lane keeps the rows (and, in the
// backward, the columns) of the three gate weights that its unit touches in
// registers.  Lanes past H hold zero weights, so their h stays 0 and they
// own no output.  Every thread of a warp runs every step (a shuffle needs
// all 32 lanes): samples past B and steps past a row's length are masked,
// not skipped.
#pragma once

#include <cuda_runtime.h>

// the dynamic shared memory of the backward's block reductions
extern __shared__ __align__(16) float gru_smem[];

namespace gru {

constexpr int THREADS = 256;
constexpr int CELL_GRU = 0, CELL_AGRU = 1, CELL_AUGRU = 2;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The recurrent pre-activations of unit i, a_g = b_g[i] + sum_j w_g[i][j] h[j]
// (a_g holds b_g[i] on entry), summed in the order j = 0, 1, ...; h[j] is
// lane j's h, broadcast within the group, and lands in hp[j].
template <int G>
__device__ __forceinline__ void recurrent(const float (&wr)[G], const float (&wz)[G],
                                          const float (&wn)[G], float h, float (&hp)[G],
                                          float& ar, float& az, float& an) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    hp[j] = __shfl_sync(FULL, h, j, G);
    ar = fmaf(wr[j], hp[j], ar);
    az = fmaf(wz[j], hp[j], az);
    an = fmaf(wn[j], hp[j], an);
  }
}

// Row i of each gate's weights (w[g][i][j], j < H) and its biases, zero for
// a lane that owns no unit.
template <int G>
__device__ __forceinline__ void load_rows(const float* __restrict__ w,
                                          const float* __restrict__ b, int H, int i, bool live,
                                          float (&wr)[G], float (&wz)[G], float (&wn)[G],
                                          float& br, float& bz, float& bn) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const bool on = live && j < H;
    wr[j] = on ? w[(0 * H + i) * H + j] : 0.f;
    wz[j] = on ? w[(1 * H + i) * H + j] : 0.f;
    wn[j] = on ? w[(2 * H + i) * H + j] : 0.f;
  }
  br = live ? b[i] : 0.f;
  bz = live ? b[H + i] : 0.f;
  bn = live ? b[2 * H + i] : 0.f;
}

}  // namespace gru

// `return fn<CELL, G>(args...)` for the runtime cell and the smallest G in
// {4, 8, 16} that holds H, else cudaErrorInvalidValue (the wrappers check
// both first).
#define GRU_DISPATCH_G(CELL, H, fn, ...)                          \
  if ((H) >= 1 && (H) <= 4) return fn<CELL, 4>(__VA_ARGS__);      \
  if ((H) > 4 && (H) <= 8) return fn<CELL, 8>(__VA_ARGS__);       \
  if ((H) > 8 && (H) <= 16) return fn<CELL, 16>(__VA_ARGS__);     \
  return static_cast<int>(cudaErrorInvalidValue);

#define GRU_DISPATCH(cell, H, fn, ...)                                     \
  switch (cell) {                                                          \
    case gru::CELL_GRU: {                                                  \
      GRU_DISPATCH_G(gru::CELL_GRU, H, fn, __VA_ARGS__)                    \
    }                                                                      \
    case gru::CELL_AGRU: {                                                 \
      GRU_DISPATCH_G(gru::CELL_AGRU, H, fn, __VA_ARGS__)                   \
    }                                                                      \
    case gru::CELL_AUGRU: {                                                \
      GRU_DISPATCH_G(gru::CELL_AUGRU, H, fn, __VA_ARGS__)                  \
    }                                                                      \
    default:                                                               \
      return static_cast<int>(cudaErrorInvalidValue);                      \
  }
