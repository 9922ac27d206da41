// Shared pieces of the lane-attention kernels (la_fwd.cu, la_bwd.cu).
//
// Both kernels compute softmax(scale * q^T k) v for every (head, sample)
// pair of operands x[h, d, s, b] (H heads of width dh, S <= 64 tokens, B
// samples) that live at x + h*sh + d*sd + s*ss + b*sb.  The strides are the
// caller's: [H, dh, S, B] contiguous (the TPU kernel's lane layout) and the
// [B, S, E] projections viewed as [H, dh, S, B] (E index h*dh + d) reach the
// same kernel without a relayout.
//
// A block owns P samples of one head (grid = (ceil(B / P), H)) and stages
// their [dh][S][P] tiles in shared memory, P samples fastest; one thread owns
// one (sample, query row) of the tile (P * S <= 256 threads), so a sample's
// rows are S threads that read the same key columns.  The head width is a
// template bound DMAX in {4, 8, 16} with the runtime dh <= DMAX, so the
// per-thread q, o and gradient rows stay in registers with three builds per
// kernel instead of sixteen.
#pragma once

#include <cuda_runtime.h>

// the dynamic shared memory of both lane-attention kernels
extern __shared__ __align__(16) float la_smem[];

namespace la {

constexpr int MAX_DH = 16;
constexpr int MAX_S = 64;
constexpr int MAX_THREADS = 256;

// Element strides of an operand x[h, d, s, b].
struct Strides {
  long long h, d, s, b;
};

// Samples per block: as many as MAX_THREADS threads hold at one thread per
// query row, at most B.
__host__ __device__ inline int pairs_per_block(int S, int B) {
  int p = MAX_THREADS / S;
  if (p > B) p = B;
  return p < 1 ? 1 : p;
}

__host__ __device__ inline int threads_for(int n) { return (n + 31) / 32 * 32; }

// Tile element e -> (d, s, p), walking the operand's unit stride first so
// that neighbouring threads read neighbouring addresses: the samples when
// sb == 1 ([H, dh, S, B]), else the head width ([B, S, E]).
__device__ __forceinline__ void tile_coords(int e, int dh, int S, int P, bool batch_minor,
                                            int& d, int& s, int& p) {
  if (batch_minor) {
    p = e % P;
    const int r = e / P;
    s = r % S;
    d = r / S;
  } else {
    d = e % dh;
    const int r = e / dh;
    s = r % S;
    p = r / S;
  }
}

// t[(d * S + s) * P + p] = x[h, d, s, b0 + p]; 0 past the last sample.
__device__ __forceinline__ void load_tile(const float* __restrict__ x, float* t, Strides st,
                                          int h, int b0, int B, int dh, int S, int P) {
  const bool bm = st.b == 1;
  const int n = dh * S * P;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int d, s, p;
    tile_coords(e, dh, S, P, bm, d, s, p);
    const int b = b0 + p;
    t[(d * S + s) * P + p] =
        b < B ? __ldg(x + h * st.h + d * st.d + s * st.s + b * st.b) : 0.f;
  }
}

// x[h, d, s, b0 + p] = t[(d * S + s) * P + p] for the samples below B.
__device__ __forceinline__ void store_tile(float* __restrict__ x, const float* t, Strides st,
                                           int h, int b0, int B, int dh, int S, int P) {
  const bool bm = st.b == 1;
  const int n = dh * S * P;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int d, s, p;
    tile_coords(e, dh, S, P, bm, d, s, p);
    const int b = b0 + p;
    if (b < B) x[h * st.h + d * st.d + s * st.s + b * st.b] = t[(d * S + s) * P + p];
  }
}

// sum_d a[d] * t[d * pitch + col] over d < dh, in the order d = 0, 1, ...
template <int DMAX>
__device__ __forceinline__ float dot(const float (&a)[DMAX], const float* t, int col, int pitch,
                                     int dh) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DMAX; ++d)
    if (d < dh) s = fmaf(a[d], t[d * pitch + col], s);
  return s;
}

}  // namespace la

// `return fn<DMAX>(args...)` for the smallest DMAX in {4, 8, 16} that holds
// dh, else cudaErrorInvalidValue (the wrappers check dh first).
#define LA_DISPATCH_DH(dh, fn, ...)                            \
  if ((dh) >= 1 && (dh) <= 4) return fn<4>(__VA_ARGS__);       \
  if ((dh) > 4 && (dh) <= 8) return fn<8>(__VA_ARGS__);        \
  if ((dh) > 8 && (dh) <= 16) return fn<16>(__VA_ARGS__);      \
  return static_cast<int>(cudaErrorInvalidValue);
