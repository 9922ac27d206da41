// Shared pieces of the lane-attention kernels (la_fwd.cu, la_bwd.cu).
//
// Both kernels compute softmax(scale * q^T k) v for every (head, sample)
// pair of operands x[h, d, s, b] (H heads of width dh, S <= 64 tokens, B
// samples) that live at x + h*sh + d*sd + s*ss + b*sb.  The strides are the
// caller's: the models hand over their [B, S, E] projections viewed as
// [H, dh, S, B] (E index h*dh + d), and the TPU kernel's [H, dh, S, B]
// contiguous layout reaches the same kernels.
//
// Work: a warp per (sample, head) pair and a lane per query row (R rows a
// lane: row lane + 32 r, R = 1 for S <= 32, 2 for S <= 64).  A block holds
// W samples x HB heads, W * HB <= a kernel's warp cap (8 forward, 4
// backward); warp y owns pair y = w * HB + hh.  Each pair's operands sit in
// shared memory as tiles of S rows of DMAX values in planes: the DMAX / 4
// float4 planes [S] first, then the DMAX % 4 scalar planes [S].  A key or
// value row is then one 16-byte load a plane (two at dh 5: a float4 and a
// float), every lane reading the same row (a broadcast), and a lane's own
// row is free of bank conflicts.
//
// The copies (Copy), none of which divides an element's index: the thread's
// first coordinates are split once and then stepped with carries.
//  - PACKED, the models' [B, S, E] strides with all H heads in the block:
//    the block's samples are one contiguous run of W * S * H segments of dh
//    floats (segment g = (w * S + s) * H + hh), a segment a thread.
//  - ROWS, batch stride 1 (the [H, dh, S, B] layout), one head of W samples
//    a block: each (d, s) row holds the block's samples contiguous, a
//    sample a thread.
//  - PAIRS, any other dense strides: a pair a warp, a lane per row.
//
// The head width: DMAX with EXACT (dh == DMAX, dh 5, the models' width) or
// a bound DMAX in {4, 8, 16} for dh <= DMAX, whose steps past dh are
// branches on a uniform value; an EXACT build issues no masked step.
#pragma once

#include <cuda_runtime.h>

// the dynamic shared memory of both lane-attention kernels
extern __shared__ __align__(16) float la_smem[];

namespace la {

constexpr int MAX_S = 64;
constexpr int MAX_SMEM = 232448;  // the most dynamic shared memory a block may ask for
constexpr int MAX_DEVICES = 64;

// Element strides of an operand x[h, d, s, b].
struct Strides {
  long long h, d, s, b;
};

// A launch's shape and the block's cut of it.
struct Geom {
  int B, H, S, dh;
  int W, HB;     // samples and heads a block
  int tile;      // floats a tile (S * DMAX rounded up to 4)
  int pitch;     // floats a scratch row (S, odd)
  int copy;      // how the tiles are copied: PACKED, ROWS or PAIRS
};

// The copies.  PACKED: the [B, S, E] strides with HB == H, the block's
// samples one contiguous run.  ROWS: the batch stride 1 (the [H, dh, S, B]
// layout) with HB == 1, each (d, s) row of the block's head holding its
// samples contiguous.  PAIRS: any other strides, a pair a warp.
enum Copy { PACKED, ROWS, PAIRS };

inline int round4(int n) { return (n + 3) / 4 * 4; }
inline int odd_pitch(int S) { return S | 1; }

// Whether (sh, sd, ss, sb) are the [B, S, E] projections' strides, E = H*dh.
inline bool packed_strides(const Strides& st, int H, int S, int dh) {
  return st.d == 1 && st.h == dh && st.s == static_cast<long long>(H) * dh &&
         st.b == static_cast<long long>(S) * H * dh;
}

// The block's cut: as many pairs as fit `warps` warps and the shared memory
// (bytes_per_pair each); all heads of a sample in one block where they fit,
// but one head of as many samples as fit at batch stride 1, whose rows then
// run W samples long.
inline void cut(Geom& g, int warps, int bytes_per_pair, const Strides& st) {
  int pairs = MAX_SMEM / bytes_per_pair;
  if (pairs > warps) pairs = warps;
  if (pairs < 1) pairs = 1;
  g.HB = st.b == 1 ? 1 : g.H < pairs ? g.H : pairs;
  g.W = pairs / g.HB;
  if (g.W > g.B) g.W = g.B;
  g.copy = st.b == 1                                                 ? ROWS
           : g.HB == g.H && packed_strides(st, g.H, g.S, g.dh) ? PACKED
                                                               : PAIRS;
}

// One pair's tile: S rows of DMAX values in planes (see the head note).
template <int DMAX>
struct Tile {
  static constexpr int C4 = DMAX / 4, REM = DMAX % 4;
  // the float offset of (s, d)
  __device__ __forceinline__ static int at(int S, int s, int d) {
    return d < 4 * C4 ? (d >> 2) * 4 * S + s * 4 + (d & 3) : d * S + s;
  }
  __device__ __forceinline__ static void load(const float* t, int S, int s, float (&r)[DMAX]) {
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const float4 x = reinterpret_cast<const float4*>(t)[c * S + s];
      r[4 * c] = x.x;
      r[4 * c + 1] = x.y;
      r[4 * c + 2] = x.z;
      r[4 * c + 3] = x.w;
    }
#pragma unroll
    for (int e = 0; e < REM; ++e) r[4 * C4 + e] = t[(4 * C4 + e) * S + s];
  }
  __device__ __forceinline__ static void store(float* t, int S, int s, const float (&r)[DMAX]) {
#pragma unroll
    for (int c = 0; c < C4; ++c)
      reinterpret_cast<float4*>(t)[c * S + s] =
          make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2], r[4 * c + 3]);
#pragma unroll
    for (int e = 0; e < REM; ++e) t[(4 * C4 + e) * S + s] = r[4 * C4 + e];
  }
};

// sum_d a[d] * b[d] over d < dh, in the order d = 0, 1, ...
template <int DMAX, bool EXACT>
__device__ __forceinline__ float dot(const float (&a)[DMAX], const float (&b)[DMAX], int dh) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DMAX; ++d)
    if (EXACT || d < dh) s = fmaf(a[d], b[d], s);
  return s;
}

// acc[d] += w * x[d] over d < dh
template <int DMAX, bool EXACT>
__device__ __forceinline__ void axpy(float (&acc)[DMAX], float w, const float (&x)[DMAX], int dh) {
#pragma unroll
  for (int d = 0; d < DMAX; ++d)
    if (EXACT || d < dh) acc[d] = fmaf(w, x[d], acc[d]);
}

// The copies move NOP operands at once: operand o's tile of pair p sits at
// tiles + o * opnd_stride + p * tile.  IN copies x[o] (const float*) into
// the tiles, else the tiles into x[o] (float*).  The caller syncs.

// Block copy of the packed run of the samples b0 .. b0 + nw - 1: segment g
// = (w * S + s) * H + hh is dh floats at (b0 * S * H + g) * dh.
template <int DMAX, bool EXACT, bool IN, int NOP, class P>
__device__ __forceinline__ void copy_packed(const Geom& g, float* tiles, int opnd_stride,
                                            P const (&x)[NOP], int b0, int nw) {
  const int H = g.H, S = g.S, dh = g.dh, nt = blockDim.x;
  const int nseg = nw * S * H;
  // (w, s, hh) of segment threadIdx.x, and the step nt split the same way
  int hh = threadIdx.x % H, s = threadIdx.x / H % S, w = threadIdx.x / (H * S);
  const int dhh = nt % H, ds = nt / H % S, dw = nt / (H * S);
  const long long base = static_cast<long long>(b0) * S * H * dh;
  for (int seg = threadIdx.x; seg < nseg; seg += nt) {
    const long long off = base + static_cast<long long>(seg) * dh;
    float* t = tiles + (w * g.HB + hh) * g.tile;
#pragma unroll
    for (int o = 0; o < NOP; ++o) {
      float r[DMAX];
      if constexpr (IN) {
#pragma unroll
        for (int d = 0; d < DMAX; ++d) r[d] = EXACT || d < dh ? __ldg(x[o] + off + d) : 0.f;
        Tile<DMAX>::store(t + o * opnd_stride, S, s, r);
      } else {
        Tile<DMAX>::load(t + o * opnd_stride, S, s, r);
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (EXACT || d < dh) x[o][off + d] = r[d];
      }
    }
    hh += dhh;
    if (hh >= H) {
      hh -= H;
      ++s;
    }
    s += ds;
    if (s >= S) {
      s -= S;
      ++w;
    }
    w += dw;
  }
}

// Warp copy of one pair (head h, sample b) at any strides, a lane per row;
// t is the pair's tile of operand 0.
template <int DMAX, bool EXACT, int R, bool IN, int NOP, class P>
__device__ __forceinline__ void copy_pair(const Geom& g, const Strides& st, float* t,
                                          int opnd_stride, P const (&x)[NOP], int h, int b,
                                          int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane + 32 * r;
    if (s >= g.S) continue;
    const long long row = h * st.h + s * st.s + static_cast<long long>(b) * st.b;
#pragma unroll
    for (int o = 0; o < NOP; ++o) {
      float v[DMAX];
      if constexpr (IN) {
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          v[d] = EXACT || d < g.dh ? __ldg(x[o] + row + d * st.d) : 0.f;
        Tile<DMAX>::store(t + o * opnd_stride, g.S, s, v);
      } else {
        Tile<DMAX>::load(t + o * opnd_stride, g.S, s, v);
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (EXACT || d < g.dh) x[o][row + d * st.d] = v[d];
      }
    }
  }
}

// Block copy at batch stride 1 (HB == 1, head h): row (d, s) holds the
// samples b0 .. b0 + nw - 1 contiguous.  Thread t takes sample t % W of row
// slot t / W (split once); the slots walk the dh * S rows with carries.
template <int DMAX, bool EXACT, bool IN, int NOP, class P>
__device__ __forceinline__ void copy_rows(const Geom& g, const Strides& st, float* tiles,
                                          int opnd_stride, P const (&x)[NOP], int h, int b0,
                                          int nw) {
  const int S = g.S, dh = EXACT ? DMAX : g.dh;
  const int slots = blockDim.x / g.W, w = threadIdx.x % g.W, slot = threadIdx.x / g.W;
  if (slot >= slots || w >= nw) return;
  int s = slot % S, d = slot / S;
  const int ds = slots % S, dd = slots / S;
  const long long base = h * st.h + static_cast<long long>(b0 + w);
  float* t = tiles + w * g.tile;
  for (; d < dh;) {
    const long long off = base + d * st.d + s * st.s;
    const int at = Tile<DMAX>::at(S, s, d);
#pragma unroll
    for (int o = 0; o < NOP; ++o) {
      if constexpr (IN)
        t[o * opnd_stride + at] = __ldg(x[o] + off);
      else
        x[o][off] = t[o * opnd_stride + at];
    }
    s += ds;
    if (s >= S) {
      s -= S;
      ++d;
    }
    d += dd;
  }
}

// Copy NOP operands between the block's tiles and device memory (Copy).
template <int DMAX, bool EXACT, int R, bool IN, int NOP, class P>
__device__ __forceinline__ void copy(const Geom& g, const Strides& st, float* tiles,
                                     int opnd_stride, P const (&x)[NOP], int b0, int nw, int pair,
                                     bool live, int h, int b, int lane) {
  if (g.copy == PACKED)
    copy_packed<DMAX, EXACT, IN, NOP>(g, tiles, opnd_stride, x, b0, nw);
  else if (g.copy == ROWS)
    copy_rows<DMAX, EXACT, IN, NOP>(g, st, tiles, opnd_stride, x, blockIdx.y, b0, nw);
  else if (live)
    copy_pair<DMAX, EXACT, R, IN, NOP>(g, st, tiles + pair * g.tile, opnd_stride, x, h, b, lane);
}

// A lane's R rows of one value per key.  R = 1: registers (the key loops
// are unrolled in full, so every index is a constant).  R = 2: the warp's
// scratch rows r0 and r1 of the lane (clamped to the last row); a store
// lands only where the lane owns the row.
template <int R>
struct Rows {
  float* r0;
  float* r1;
  __device__ __forceinline__ float get(int r, int j) const { return (r == 0 ? r0 : r1)[j]; }
  __device__ __forceinline__ void set(int r, int j, float x, bool own) {
    if (own) (r == 0 ? r0 : r1)[j] = x;
  }
};
template <>
struct Rows<1> {
  float v[32];
  __device__ __forceinline__ float get(int, int j) const { return v[j]; }
  __device__ __forceinline__ void set(int, int j, float x, bool) { v[j] = x; }
};

// Set a kernel's dynamic shared-memory cap to the most any launch asks for,
// once a device: `done` is the launcher's own (a function-local static of
// each build; the builds share one function type).
template <class K>
inline cudaError_t allow_smem(K* kern, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidValue;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace la

// `return fn<DMAX, EXACT, R>(args...)` for the head width (dh 5 exact, else
// the smallest bound of 4, 8, 16 that holds it) and the rows a lane, else
// cudaErrorInvalidValue (the wrappers check dh and S first).
#define LA_DISPATCH_R(dmax, exact, S, fn, ...)                          \
  do {                                                                  \
    if ((S) <= 32) return fn<dmax, exact, 1>(__VA_ARGS__);              \
    return fn<dmax, exact, 2>(__VA_ARGS__);                             \
  } while (0)
#define LA_DISPATCH(dh, S, fn, ...)                                                   \
  if ((S) < 1 || (S) > la::MAX_S) return static_cast<int>(cudaErrorInvalidValue);     \
  if ((dh) == 5) LA_DISPATCH_R(5, true, S, fn, __VA_ARGS__);                          \
  if ((dh) >= 1 && (dh) <= 4) LA_DISPATCH_R(4, false, S, fn, __VA_ARGS__);            \
  if ((dh) > 4 && (dh) <= 8) LA_DISPATCH_R(8, false, S, fn, __VA_ARGS__);             \
  if ((dh) > 8 && (dh) <= 16) LA_DISPATCH_R(16, false, S, fn, __VA_ARGS__);           \
  return static_cast<int>(cudaErrorInvalidValue);
