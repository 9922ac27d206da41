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
// the small-attention forward's time (row 8, sa_fwd.cu) between its two
// products and its softmax passes (max, exp2, sums).
//
// Bound, at the script's default shape (G 8192, S 266, dh 5): full and dots
// do 4 G S^2 dh = 11.6 GFLOP of products (0.17 ms at 67 TFLOP/s fp32), full
// and soft G S^2 = 0.58 G exp2 (0.14 ms at 4.2 T/s), soft G S^2 products and
// 2 G S^2 sums; the operands are 174 MB (0.05 ms at 3.35 TB/s).
//
// So that the variants differ in their arithmetic alone, all three run
// sa_fwd.cu's routine (attn_fwd_tc.cuh) with its grid (a block a pair), its
// staging and its tiles (a warp per 32 queries, 16 above dh 8; a lane's 4
// queries and 2 keys of each 8-key block).  full is that routine with no m
// or inv_z written, so its o is sa_fwd's bit for bit.  dots is the routine
// with the softmax an identity: one sweep, s straight into the value FMAs.
// soft runs the same tiles on the outer product of q's and k's row 0 (one
// multiply a pair), a max sweep, then the exp2 sweep with the row sums, and
// takes its column sums by shuffles over each warp's rows into a per-warp
// row [warps][KP] of shared memory; after one barrier the warps' rows are
// added in warp order.  Every sum is in a fixed order, so the output is
// bit-equal from run to run.  soft reads only row 0 of q and k from device
// memory.

#include "attn_fwd_tc.cuh"

namespace {

enum Variant { FULL = 0, DOTS = 1, SOFT = 2 };

// Threads and dynamic shared memory of a launch; the kernels carve their
// shared memory in this order.
void geometry(int variant, int dh, int S, int* threads, long long* smem) {
  const int floats =
      variant == SOFT ? attn_fwd::soft_floats(S) : attn_fwd::stage_floats(dh, S);
  *threads = 32 * attn_fwd::warps_for(variant == SOFT ? 1 : dh, S);
  *smem = static_cast<long long>(floats) * static_cast<long long>(sizeof(float));
}

// o [dh][S] of one pair in device memory, no statistics
struct PairOut {
  float* out;
  int S;
  __device__ void o(int d, int i, float x) const { out[d * S + i] = x; }
  __device__ void max(int, float) const {}
  __device__ void inv(int, float) const {}
};

template <int DH, bool SOFTMAX>
__global__ void __maxnreg__(attn_fwd::MAX_REGS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, int S, float scale) {
  const int KP = attn_fwd::key_pitch(S);
  float* ks = attn_smem;      // [DH][KP]
  float* vs = ks + DH * KP;   // [DH][KP]
  const long long base = static_cast<long long>(blockIdx.x) * DH * S;
  attn_fwd::stage<DH, false, true>(k + base, v + base, S, ks, vs);
  __syncthreads();
  attn_fwd::attn_fwd_head<DH, false, SOFTMAX>(attn_fwd::DeviceQ{q + base, S}, ks, vs, S, scale,
                                              PairOut{o + base, S});
}

template <int DH>
__global__ void __maxnreg__(attn_fwd::MAX_REGS)
soft_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int S, float scale) {
  float* ks = attn_smem;  // k's row 0 [KP], then the routine's scratch
  const long long base = static_cast<long long>(blockIdx.x) * DH * S;
  attn_fwd::stage<1, false, false>(k + base, nullptr, S, ks, nullptr);
  __syncthreads();
  attn_fwd::attn_fwd_soft<DH>(q + base, ks, S, scale, ks + attn_fwd::key_pitch(S), o + base);
}

template <int DH>
int launch(int variant, const float* q, const float* k, const float* v, float* o, int G, int S,
           float scale, cudaStream_t st) {
  void (*kern)(const float*, const float*, const float*, float*, int, float);
  switch (variant) {
    case FULL: kern = fwd_kernel<DH, true>; break;
    case DOTS: kern = fwd_kernel<DH, false>; break;
    case SOFT: kern = soft_kernel<DH>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  int threads;
  long long smem;
  geometry(variant, DH, S, &threads, &smem);
  if (smem > attn::MAX_SMEM_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&q, &k, &v, &o, &S, &scale};
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
