// Shared pieces of the GRU-scan kernels (gru_fwd.cu, gru_bwd.cu).
//
// Operands, batch-major, fp32 and contiguous: gi [B, T, 3, H] (the hoisted
// input gates r, z, n), w [3, H, H], b [3, H], att [B, T] (unused by cell
// gru), lengths [B] int32, h0 [B, H], outs [B, T, H].
//
// One thread per (sample, hidden unit), a sample on exactly H lanes: a warp
// holds SPW = 32 / H samples (3 at DIEN's H 10, lanes 30-31 idle), a block
// a kernel's WARPS warps.  H is a template parameter (every width of the
// gate 1..16 has its build), so every loop over units runs to H and no lane
// of a sample is masked.  A step needs the sample's whole h (or, backward,
// its gate gradients): each lane writes its value to the warp's exchange
// row in shared memory, __syncwarp, and every lane reads the sample's row
// back as 16-byte broadcasts (HP / 4 loads for H values, HP = H rounded up
// to 4).  The rows are double-buffered by the step's parity, so one
// __syncwarp a step orders them.
//
// Each warp runs its recurrence only up to the longest length among its
// samples (a warp vote); past it the forward only stores the frozen state
// and the backward only carries dh += g[t].  A step at or past a row's own
// length leaves its state as it is by a select, not by a product with
// valid = 0: for finite inputs the values are those of the plain version,
// but a non-finite gi or att past a row's length no longer reaches h or any
// gradient (in the plain version and the TPU kernel it does, through
// 0 * inf).
//
// No step waits on device memory for its operands: the forward loads each
// lane's own gi and att into registers a few steps ahead, the backward
// stages its samples' chunks in shared memory a chunk ahead (gru_fwd.cu,
// gru_bwd.cu).  Only the rows below a row's length are loaded (g below the
// warp's longest): a slot past it holds an earlier step's operands or
// undefined data, which no select lets through.
#pragma once

#include <cuda_runtime.h>

// the dynamic shared memory of both kernels (the exchange rows, the
// backward's staging ring and block reduction)
extern __shared__ __align__(16) float gru_smem[];

namespace gru {

constexpr int CELL_GRU = 0, CELL_AGRU = 1, CELL_AUGRU = 2;
constexpr unsigned FULL = 0xffffffffu;

// 1 / (1 + e^-x) on the special-function unit: 2^(-x log2 e) by
// ex2.approx.ftz, then rcp.approx.ftz of 1 + that, 4 instructions against
// ~20 with a slow-path branch for expf and an IEEE division (and the range
// fix-ups of __expf, which keep denormal results that the sigmoid rounds
// away: ex2 flushes them to 0, where 1 / (1 + 0) = 1, and gives inf past
// 2^128, where 1 / inf = 0).  The exponential's relative error grows with
// |x|, but the sigmoid's slope, sigmoid (1 - sigmoid), shrinks faster, so
// the absolute error stays within a few units of fp32 rounding of 1 (the
// float64 gate of chip_smoke.py holds the kernels to twice the plain
// version's error).  The tests' host emulation defines TC_TF32_EMULATED and
// computes the same function with the host's exp2.
#ifndef TC_TF32_EMULATED
__device__ __forceinline__ float sigmoid(float x) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * -1.44269504088896341f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return r;
}
#else
inline float sigmoid(float x) { return 1.f / (1.f + std::exp2(x * -1.44269504088896341f)); }
#endif

// A warp's lanes for width H in blocks of WARPS warps: sample sw = lane / H
// of the warp, unit i = lane % H; lanes past SPW * H are idle (sw == SPW,
// slot 0: an idle lane reads sample 0's shared memory and writes none).
template <int H, int WARPS>
struct Lanes {
  static constexpr int SPW = 32 / H;
  static constexpr int HP = (H + 3) / 4 * 4;
  static constexpr int STEP = 3 * H;  // gi floats a step
  int warp, lane, sw, i;
  int slot;          // the sample whose shared memory the lane reads
  long long s;       // the sample
  bool active;       // the lane holds a unit (sw < SPW)
  bool live;         // ... of a sample in the batch
  long long first;   // the warp's first sample
  __device__ __forceinline__ Lanes(int B) {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    sw = lane / H;
    i = lane % H;
    first = (static_cast<long long>(blockIdx.x) * WARPS + warp) * SPW;
    s = first + sw;
    active = sw < SPW;
    slot = active ? sw : 0;
    live = active && s < B;
  }
};

// The lane's row length clamped to [0, T] (0 for a lane of no sample), and
// the longest over the warp.
__device__ __forceinline__ int row_length(const int* __restrict__ lengths, long long s, bool live,
                                          int T, int& longest) {
  const int len = live ? min(max(lengths[s], 0), T) : 0;
  longest = __reduce_max_sync(FULL, len);
  return len;
}

// v[0..H) from a broadcast row of HP floats (16-byte aligned).
template <int H>
__device__ __forceinline__ void read_row(const float* row, float (&v)[H]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < (H + 3) / 4; ++q) {
    const float4 x = r4[q];
    const float c[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * q + k < H) v[4 * q + k] = c[k];
    }
  }
}

// sum_j a[j] b[j] as two chains, j < H / 2 from `init` and the rest from
// zero, added at the end: half the latency of one chain of H.
template <int H>
__device__ __forceinline__ float dot(const float (&a)[H], const float (&b)[H], float init) {
  float lo = init, hi = 0.f;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    if (j < H / 2) {
      lo = fmaf(a[j], b[j], lo);
    } else {
      hi = fmaf(a[j], b[j], hi);
    }
  }
  return lo + hi;
}

// The recurrent pre-activations of unit i, a_g = b_g[i] + sum_j w_g[i][j] h[j]
// (a_g holds b_g[i] on entry).
template <int H, bool HAS_Z>
__device__ __forceinline__ void recurrent(const float (&wr)[H], const float (&wz)[H],
                                          const float (&wn)[H], const float (&h)[H], float& ar,
                                          float& az, float& an) {
  ar = dot<H>(wr, h, ar);
  if (HAS_Z) az = dot<H>(wz, h, az);
  an = dot<H>(wn, h, an);
}

// Row i of each gate's weights (w[g][i][j]) and its biases, zero for a lane
// that holds no unit.
template <int H>
__device__ __forceinline__ void load_rows(const float* __restrict__ w,
                                          const float* __restrict__ b, int i, bool active,
                                          float (&wr)[H], float (&wz)[H], float (&wn)[H],
                                          float& br, float& bz, float& bn) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    wr[j] = active ? w[(0 * H + i) * H + j] : 0.f;
    wz[j] = active ? w[(1 * H + i) * H + j] : 0.f;
    wn[j] = active ? w[(2 * H + i) * H + j] : 0.f;
  }
  br = active ? b[i] : 0.f;
  bz = active ? b[H + i] : 0.f;
  bn = active ? b[2 * H + i] : 0.f;
}

}  // namespace gru

// `return fn<CELL, H>(args...)` for the runtime cell and the exact width H
// in 1..16, else cudaErrorInvalidValue (the wrappers check both first).
#define GRU_CASE_H(CELL, H, fn, ...) \
  case H:                            \
    return fn<CELL, H>(__VA_ARGS__);

#define GRU_DISPATCH_H(CELL, H, fn, ...)                                                      \
  switch (H) {                                                                                \
    GRU_CASE_H(CELL, 1, fn, __VA_ARGS__) GRU_CASE_H(CELL, 2, fn, __VA_ARGS__)                 \
    GRU_CASE_H(CELL, 3, fn, __VA_ARGS__) GRU_CASE_H(CELL, 4, fn, __VA_ARGS__)                 \
    GRU_CASE_H(CELL, 5, fn, __VA_ARGS__) GRU_CASE_H(CELL, 6, fn, __VA_ARGS__)                 \
    GRU_CASE_H(CELL, 7, fn, __VA_ARGS__) GRU_CASE_H(CELL, 8, fn, __VA_ARGS__)                 \
    GRU_CASE_H(CELL, 9, fn, __VA_ARGS__) GRU_CASE_H(CELL, 10, fn, __VA_ARGS__)                \
    GRU_CASE_H(CELL, 11, fn, __VA_ARGS__) GRU_CASE_H(CELL, 12, fn, __VA_ARGS__)               \
    GRU_CASE_H(CELL, 13, fn, __VA_ARGS__) GRU_CASE_H(CELL, 14, fn, __VA_ARGS__)               \
    GRU_CASE_H(CELL, 15, fn, __VA_ARGS__) GRU_CASE_H(CELL, 16, fn, __VA_ARGS__)               \
    default:                                                                                  \
      return static_cast<int>(cudaErrorInvalidValue);                                         \
  }

#define GRU_DISPATCH(cell, H, fn, ...)                     \
  switch (cell) {                                          \
    case gru::CELL_GRU:                                    \
      GRU_DISPATCH_H(gru::CELL_GRU, H, fn, __VA_ARGS__)    \
    case gru::CELL_AGRU:                                   \
      GRU_DISPATCH_H(gru::CELL_AGRU, H, fn, __VA_ARGS__)   \
    case gru::CELL_AUGRU:                                  \
      GRU_DISPATCH_H(gru::CELL_AUGRU, H, fn, __VA_ARGS__)  \
    default:                                               \
      return static_cast<int>(cudaErrorInvalidValue);      \
  }
