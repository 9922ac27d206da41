// The attention ablation (three forwards over the same operands), for
// Hopper (sm_90a), behind a plain C interface that ops/attn_ablate_cuda.py
// loads with ctypes.  Per pair g of G, on dh-major operands q, k, v
// [G, dh, S] (fp32), with c = scale * log2(e):
//
//   full:  s[i, j] = sum_d q[d, i] k[d, j];  m[i] = max_j s[i, j]
//          e[i, j] = exp2(s[i, j] c - m[i] c);  z[i] = sum_j e[i, j]
//          o[d, i] = (sum_j v[d, j] e[i, j]) / z[i]
//   dots:  the same s, unscaled;  o[d, i] = sum_j v[d, j] s[i, j]
//          (no softmax, no normalisation)
//   soft:  s[i, j] = q[0, i] k[0, j] (an outer product, no dot);  m, e and
//          z as in full;  o[d, x] = (1 / z[x]) * sum_i e[i, x] for every d
//          (the column sum of e over the rows i, times row x's normaliser)
//
// Replaces: scripts/bench_attn_ablate.py build (pl.pallas_call :97) over
// full_kernel :51, dots_kernel :66 and soft_kernel :78.  The script splits
// the small-attention forward's time (row 8, sa_fwd.cu) between the two
// dot products, which run on the card's FMA pipe, and the softmax passes
// (max, exp2, sums), whose exp2 runs on the special-function units at an
// eighth of the FMA pipe's instruction rate (16 against 128 a clock an SM).
//
// Bound, at the script's default shape (G 8192, S 266, dh 5): full and dots
// do 4 G S^2 dh = 11.6 GFLOP of products (0.17 ms at 67 TFLOP/s fp32), full
// and soft G S^2 = 0.58 G exp2 (0.14 ms at 4.2 T/s), soft G S^2 products
// and 2 G S^2 sums; the operands are 174 MB (0.05 ms at 3.35 TB/s).
//
// So that the variants differ in their arithmetic alone, all three keep
// sa_fwd.cu's structure: one block a pair, k and v staged in shared memory
// ([dh][S] each), one thread a query column i with its q column and o
// accumulators in registers (dh a template parameter), a max sweep over the
// keys, then an exp / sum / product sweep.  The one place soft differs is
// its column sum: a thread owns a row i, but o[., x] needs e summed over
// every row for column x.  Shared-memory atomics would make that sum change
// from run to run, and a second sweep with a thread a column would take
// every exp twice.  Instead the exp sweep goes in chunks of SOFT_TILE key
// columns: each thread writes its row's e for the chunk into a shared
// [S][SOFT_TILE + 1] tile (padded: conflict-free), and after a barrier the
// block's threads, a warp's lanes on the chunk's columns and its warps on
// consecutive runs of rows, sum the tile in order, then one thread a column
// adds the warps' partials in order.  Every e is taken once (G S^2 exp2
// in all) and every sum is in a fixed order, so the output is bit-equal
// from run to run.  soft reads only q's row 0 from device memory; the other
// rows are dead and the compiler drops their loads.

#include <cfloat>
#include <cmath>

#include "attn_common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int SOFT_TILE = 32;  // key columns in one soft chunk: one per lane

enum Variant { FULL = 0, DOTS = 1, SOFT = 2 };

// Threads and dynamic shared memory of a launch; the kernels carve their
// shared memory in this order.
void geometry(int variant, int dh, int S, int* threads, long long* smem) {
  *threads = attn::threads_for(S);
  long long floats = 2LL * dh * S;  // k and v
  if (variant == SOFT)  // tile, q row 0, m c, z, column sums, warp partials
    floats += static_cast<long long>(S) * (SOFT_TILE + 1) + 4LL * S +
              static_cast<long long>(*threads / 32) * SOFT_TILE;
  *smem = floats * static_cast<long long>(sizeof(float));
}

// k and v of this block's pair into shared memory, [DH][S] each.
template <int DH>
__device__ __forceinline__ void stage_kv(const float* __restrict__ k, const float* __restrict__ v,
                                         float* ks, float* vs, long long base, int S) {
  for (int e = threadIdx.x; e < DH * S; e += blockDim.x) {
    ks[e] = __ldg(k + base + e);
    vs[e] = __ldg(v + base + e);
  }
  __syncthreads();
}

template <int DH>
__device__ __forceinline__ float score(const float (&qi)[DH], const float* ks, int S, int j) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) s = fmaf(qi[d], ks[d * S + j], s);
  return s;
}

template <int DH>
__global__ void __launch_bounds__(attn::MAX_THREADS)
full_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int S, float c) {
  float* ks = attn_smem;    // [DH][S]
  float* vs = ks + DH * S;  // [DH][S]
  const long long base = static_cast<long long>(blockIdx.x) * DH * S;
  stage_kv<DH>(k, v, ks, vs, base, S);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    float qi[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qi[d] = __ldg(q + base + d * S + i);
    float mx = -FLT_MAX;
    for (int j = 0; j < S; ++j) mx = fmaxf(mx, score<DH>(qi, ks, S, j));
    const float mc = mx * c;
    float z = 0.f;
    float acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float e = exp2f(score<DH>(qi, ks, S, j) * c - mc);
      z += e;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(vs[d * S + j], e, acc[d]);
    }
    const float inv = 1.f / z;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[base + d * S + i] = acc[d] * inv;
  }
}

template <int DH>
__global__ void __launch_bounds__(attn::MAX_THREADS)
dots_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int S, float) {
  float* ks = attn_smem;    // [DH][S]
  float* vs = ks + DH * S;  // [DH][S]
  const long long base = static_cast<long long>(blockIdx.x) * DH * S;
  stage_kv<DH>(k, v, ks, vs, base, S);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    float qi[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qi[d] = __ldg(q + base + d * S + i);
    float acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float s = score<DH>(qi, ks, S, j);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(vs[d * S + j], s, acc[d]);
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) o[base + d * S + i] = acc[d];
  }
}

template <int DH>
__global__ void __launch_bounds__(attn::MAX_THREADS)
soft_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int S, float c) {
  constexpr int J = SOFT_TILE;
  const int T = blockDim.x;
  const int warps = T / 32;
  float* ks = attn_smem;            // [DH][S]
  float* vs = ks + DH * S;          // [DH][S]
  float* tile = vs + DH * S;        // [S][J + 1]: one chunk's e
  float* q0 = tile + S * (J + 1);   // [S]: q[0, i]
  float* row_mc = q0 + S;           // [S]: m[i] * c
  float* row_z = row_mc + S;        // [S]: z[i]
  float* col = row_z + S;           // [S]: sum_i e[i, x]
  float* part = col + S;            // [warps][J]: each warp's share of a column
  const long long base = static_cast<long long>(blockIdx.x) * DH * S;
  stage_kv<DH>(k, v, ks, vs, base, S);
  const float* k0 = ks;  // k's row d = 0

  // the max sweep, a thread a row
  for (int i = threadIdx.x; i < S; i += T) {
    const float qi = __ldg(q + base + i);
    float mx = -FLT_MAX;
    for (int j = 0; j < S; ++j) mx = fmaxf(mx, qi * k0[j]);
    q0[i] = qi;
    row_mc[i] = mx * c;
    row_z[i] = 0.f;
  }
  // rows [lane's warp * rows, + rows) of a chunk's column `lane`
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rows = (S + warps - 1) / warps;
  const int lo = warp * rows, hi = min(S, lo + rows);
  for (int j0 = 0; j0 < S; j0 += J) {
    const int jn = min(J, S - j0);
    // the exp sweep over the chunk, a thread a row (each row's own data)
    for (int i = threadIdx.x; i < S; i += T) {
      const float qi = q0[i], mc = row_mc[i];
      float z = row_z[i];
      for (int t = 0; t < jn; ++t) {
        const float e = exp2f(qi * k0[j0 + t] * c - mc);
        z += e;
        tile[i * (J + 1) + t] = e;
      }
      row_z[i] = z;
    }
    __syncthreads();
    if (lane < jn) {
      float sum = 0.f;
      for (int i = lo; i < hi; ++i) sum += tile[i * (J + 1) + lane];
      part[warp * J + lane] = sum;
    }
    __syncthreads();
    // the warps' partials of each column, in order; the next chunk's tile
    // writes do not touch part, and its partial writes follow a barrier
    if (threadIdx.x < jn) {
      float sum = 0.f;
      for (int w = 0; w < warps; ++w) sum += part[w * J + threadIdx.x];
      col[j0 + threadIdx.x] = sum;
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < S; x += T) {
    const float out = (1.f / row_z[x]) * col[x];
#pragma unroll
    for (int d = 0; d < DH; ++d) o[base + d * S + x] = out;
  }
}

template <int DH>
int launch(int variant, const float* q, const float* k, const float* v, float* o, int G, int S,
           float scale, cudaStream_t st) {
  void (*kern)(const float*, const float*, const float*, float*, int, float);
  switch (variant) {
    case FULL: kern = full_kernel<DH>; break;
    case DOTS: kern = dots_kernel<DH>; break;
    case SOFT: kern = soft_kernel<DH>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  int threads;
  long long smem;
  geometry(variant, DH, S, &threads, &smem);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float c = scale * LOG2E;
  void* args[] = {&q, &k, &v, &o, &S, &c};
  err = cudaLaunchKernel(kern, dim3(G), dim3(threads), args, static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The launch geometry of `variant` (0 full, 1 dots, 2 soft) at head width
// dh and S columns: threads a block and dynamic shared bytes a block.
int sa_ablate_geometry(int variant, int dh, int S, int* threads, long long* smem_bytes) {
  if (variant < FULL || variant > SOFT || dh < 1 || dh > attn::MAX_DH || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  geometry(variant, dh, S, threads, smem_bytes);
  return 0;
}

// Launches `variant` on `stream` and returns the first CUDA error (0 on
// success).  The caller has checked dtypes, shapes, contiguity, G >= 1,
// 1 <= dh <= 16, S >= 1, the shared memory (sa_ablate_geometry) and 32-bit
// offsets within a pair, and allocated o [G, dh, S].
int sa_ablate(int variant, const void* q, const void* k, const void* v, void* o, int G, int dh,
              int S, float scale, void* stream) {
  ATTN_DISPATCH_DH(dh, launch, variant, static_cast<const float*>(q),
                   static_cast<const float*>(k), static_cast<const float*>(v),
                   static_cast<float*>(o), G, S, scale, static_cast<cudaStream_t>(stream))
}

const char* sa_ablate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
