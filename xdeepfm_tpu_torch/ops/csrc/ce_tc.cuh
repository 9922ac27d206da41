// The logit-tile walk of the fp32 softmax cross-entropy kernels (ce_fwd.cu,
// ce_bwd.cu) on the tensor cores: ce_fwd.cu's forward and ce_bwd.cu's
// ce_dh_kernel both call logit_walk, so the logits the forward folds into
// logz are, operation for operation, the logits the backward recomputes for
// exp(S - logz).  Also the copy and split helpers that ce_dw_kernel shares.
//
// An item is 64 rows of h (below num_valid) and a run of (head, 128-column
// vocabulary tile) pairs, walked 64 columns a step.  The item's h rows are
// split once into TF32 halves in shared memory; each step's W half-tile, its
// bias and the rows' values for its head (the targets, and logz and g in the
// backward) come by cp.async through a ring of two stages while the previous
// step computes, and the W rows are split once per step.  Eight warps own
// 16 rows x 32 columns of the step's logit tile S = h W^T, each k8 step's
// 3xTF32 product added in fp32 (tc::mma3_add).
// The caller's epilogue gets S without the bias, in the m16n8k8 accumulator
// layout: s[nt][q] is row rb + group + 8 (q / 2), column vb + 8 nt + 2 tig +
// q % 2 of the step, with the step's split W rows (ItemTiles::wb, ::ws), bias
// (::bs) and row values (::rv) in shared memory.  Operand tiles are laid out
// [row][k] 68 floats apart, so every fragment load is free of bank
// conflicts.  (Splitting W as its fragments are loaded, or once a launch
// into device memory, and loading the fragments by ldmatrix each measured
// no faster than this on an NVIDIA H100 80GB HBM3 at 700.00 W.)
//
// Also the pieces every CE kernel shares, the bf16 mode's (ce_bf16.cu) too:
// the dynamic shared memory, the widest hidden width they take, the device
// count of valid rows, the forward's plan of partials and their ordered
// merge (ce_fwd_combine), and the ordered sums of the backward's partials.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tf32.cuh"

// the dynamic shared memory of every CE kernel
extern __shared__ __align__(16) float ce_smem[];

namespace ce {

constexpr int KMAX = 64;  // largest hidden width K the kernels take

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Rows below this take part; `nv` is a device scalar (nullptr: all B rows).
__device__ __forceinline__ int valid_rows(const int* nv, int B) {
  if (nv == nullptr) return B;
  const int n = __ldg(nv);
  return n < 0 ? 0 : (n < B ? n : B);
}

constexpr int THREADS = 256;  // 8 warps
constexpr int LDK = KMAX + 4;  // row of a [rows][K] operand tile (68)
constexpr int ITEM_R = 64;     // rows of an item
constexpr int STEP_V = 64;     // vocabulary columns of a step (half a tile)
constexpr int STAGE = STEP_V * KMAX + STEP_V + 3 * ITEM_R;  // W rows, bias, row values
static_assert(4 * 16 == ITEM_R && 2 * 32 == STEP_V, "4 x 2 warps of 16 x 32");

// n floats at src (rows of a contiguous [*, K] operand) to dst by cp.async,
// `valid` of them read, the rest zero; 16-byte copies when src is aligned.
// slots is n rounded up to 4.
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int slots, int valid,
                                          int tid) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int e = tid * 4; e < slots; e += THREADS * 4) {
      const int left = valid - e;
      const int bytes = left <= 0 ? 0 : (left >= 4 ? 16 : 4 * left);
      tc::cp_async16(dst + e, bytes ? src + e : src, bytes);
    }
  } else {
    for (int e = tid; e < slots; e += THREADS)
      tc::cp_async4(dst + e, e < valid ? src + e : src, e < valid);
  }
}

// One row value per slot, [3][n]: logz and g as floats, the target's low
// word (a column index below 2^31) as an int; zero past `valid`.  A null lz
// or g (the forward) leaves its slots unwritten.
__device__ __forceinline__ void copy_row_values(float* dst, const float* lz, const float* g,
                                                const long long* t, int n, int valid, int tid) {
  for (int e = tid; e < 3 * n; e += THREADS) {
    const int which = e / n;
    const int r = e - which * n;
    const bool ok = r < valid;
    const int at = ok ? r : 0;
    const float* fv = which == 0 ? lz : g;
    if (which < 2 && fv == nullptr) continue;
    const void* src = which < 2 ? static_cast<const void*>(fv + at)
                                : static_cast<const void*>(t + at);
    tc::cp_async4(dst + e, src, ok);
  }
}

// [n][K] packed rows at src -> split big / small [n][LDK], zero for k in
// [K, KP): a thread's elements go through registers (src and the halves may
// overlap).  n * KP / THREADS <= CAP.
template <int CAP>
__device__ __forceinline__ void split_rows(const float* src, uint32_t* big, uint32_t* small, int n,
                                           int K, int KP, int tid) {
  float v[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / KP;
    const int k = e - r * KP;
    v[i] = (r < n && k < K) ? src[r * K + k] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / KP;
    const int k = e - r * KP;
    if (r < n) tc::split(v[i], big[r * LDK + k], small[r * LDK + k]);
  }
}

// n packed rows [n][K] of a ring stage -> split big / small [n][LDK], zero
// for k in [K, KP): four columns a thread where K is a multiple of 4
__device__ __forceinline__ void split_stage(const float* st, uint32_t* big, uint32_t* small,
                                            int n, int K, int KP, int tid) {
  if ((K & 3) == 0) {
    for (int e = 4 * tid; e < n * KP; e += 4 * THREADS) {
      const int r = e / KP;
      const int k = e - r * KP;
      const float4 v = k < K ? *reinterpret_cast<const float4*>(st + r * K + k)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      uint4 b, sm;
      tc::split(v.x, b.x, sm.x);
      tc::split(v.y, b.y, sm.y);
      tc::split(v.z, b.z, sm.z);
      tc::split(v.w, b.w, sm.w);
      *reinterpret_cast<uint4*>(big + r * LDK + k) = b;
      *reinterpret_cast<uint4*>(small + r * LDK + k) = sm;
    }
  } else {
    for (int e = tid; e < n * KP; e += THREADS) {
      const int r = e / KP;
      const int k = e - r * KP;
      tc::split(k < K ? st[r * K + k] : 0.f, big[r * LDK + k], small[r * LDK + k]);
    }
  }
}

// The shared memory of an item: h rows and the step's W rows split, the
// ring, and the step's bias [STEP_V] and row values [3][ITEM_R] (logz, g,
// targets) copied out of its stage.
struct ItemTiles {
  uint32_t *hb, *hs, *wb, *ws;
  float *ring, *bs, *rv;
};

constexpr int item_smem_floats() {
  return 2 * ITEM_R * LDK + 2 * STEP_V * LDK + 2 * STAGE + STEP_V + 3 * ITEM_R;
}

__device__ __forceinline__ ItemTiles item_tiles() {
  ItemTiles t;
  t.hb = reinterpret_cast<uint32_t*>(ce_smem);
  t.hs = t.hb + ITEM_R * LDK;
  t.wb = t.hs + ITEM_R * LDK;
  t.ws = t.wb + STEP_V * LDK;
  t.ring = reinterpret_cast<float*>(t.ws + STEP_V * LDK);
  t.bs = t.ring + 2 * STAGE;
  t.rv = t.bs + STEP_V;
  return t;
}

// One item: h rows [row0, row0 + rows) (rows past B or num_valid read as
// zero), the (head, tile) pairs from p_begin in the order f * tiles + t, two
// steps a pair, n_steps steps.  For each step j, after every warp's S tile
// is complete: epilogue(j, f, v0, s) with the step's head f and first
// vocabulary column v0.  lz and g may be null (the forward).  The caller
// syncs before reusing the tiles after the walk.
template <class Epilogue>
__device__ __forceinline__ void logit_walk(const float* h, const float* w, const float* bias,
                                           const long long* tgt, const float* lz, const float* g,
                                           int B, int K, int V, int row0, int rows, int p_begin,
                                           int n_steps, const ItemTiles& t,
                                           Epilogue&& epilogue) {
  const int KP = round_up(K, 8);
  const int n_vt = (V + 127) / 128;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, group = lane / 4, tig = lane % 4;
  const int rb = (warp % 4) * 16;  // this warp's rows of the item
  const int vb = (warp / 4) * 32;  // and columns of a step

  // the item's h rows: raw into hs's space, then split in place
  copy_rows(reinterpret_cast<float*>(t.hs), h + row0 * K, ITEM_R * K, rows * K, tid);
  tc::cp_async_commit();
  auto issue = [&](int j, int s) {
    float* st = t.ring + s * STAGE;
    const int pair = p_begin + j / 2;
    const int f = pair / n_vt;
    const int v0 = (pair - f * n_vt) * 128 + (j % 2) * STEP_V;
    const int cols = max(0, min(V, v0 + STEP_V) - v0);
    copy_rows(st, cols ? w + ((long long)f * V + v0) * K : w, STEP_V * K, cols * K, tid);
    const float* bf = bias + (long long)f * V + v0;
    for (int e = tid; e < STEP_V; e += THREADS)
      tc::cp_async4(st + STEP_V * KMAX + e, e < cols ? bf + e : bias, e < cols);
    const long long off = (long long)f * B + row0;
    copy_row_values(st + STEP_V * KMAX + STEP_V, lz ? lz + off : lz, g ? g + off : g, tgt + off,
                    ITEM_R, rows, tid);
  };
  issue(0, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();
  __syncthreads();
  split_rows<ITEM_R * KMAX / THREADS>(reinterpret_cast<const float*>(t.hs), t.hb, t.hs, ITEM_R,
                                      K, KP, tid);

  for (int j = 0; j < n_steps; ++j) {
    if (j + 1 < n_steps) {
      issue(j + 1, (j + 1) % 2);  // that stage's step j - 1 is converted
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // step j has landed; every warp is done with step j - 1
    const float* st = t.ring + (j % 2) * STAGE;
    split_stage(st, t.wb, t.ws, STEP_V, K, KP, tid);
    for (int e = tid; e < STEP_V + 3 * ITEM_R; e += THREADS) t.bs[e] = st[STEP_V * KMAX + e];
    __syncthreads();

    const int pair = p_begin + j / 2;
    const int f = pair / n_vt;
    const int v0 = (pair - f * n_vt) * 128 + (j % 2) * STEP_V;
    // S [16 rows][32 columns] = h W^T
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[nt][q] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < KMAX; k8 += 8) {
      if (k8 >= KP) break;
      const int a0 = (rb + group) * LDK + k8 + tig;
      const int a1 = a0 + 8 * LDK;
      const uint32_t ab[4] = {t.hb[a0], t.hb[a1], t.hb[a0 + 4], t.hb[a1 + 4]};
      const uint32_t as[4] = {t.hs[a0], t.hs[a1], t.hs[a0 + 4], t.hs[a1 + 4]};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int b0 = (vb + 8 * nt + group) * LDK + k8 + tig;
        const uint32_t bb[2] = {t.wb[b0], t.wb[b0 + 4]};
        const uint32_t bsm[2] = {t.ws[b0], t.ws[b0 + 4]};
        tc::mma3_add(s[nt], ab, as, bb, bsm);
      }
    }
    epilogue(j, f, v0, s);
  }
}

// ---- the forward's partials (ce_fwd.cu, ce_bf16.cu) ----

// Split s covers pairs [s * per, (s + 1) * per); head f's pairs are
// [f * n_vt, (f + 1) * n_vt).  The splits that reach head f are
// first_split(f) .. last_split(f); split s writes its partials of head f in
// slots width (s - first_split(f)) .. + width - 1 (ce_fwd.cu: its two column
// warps; ce_bf16.cu: one).
__host__ __device__ __forceinline__ int first_split(int f, int n_vt, int per) {
  return f * n_vt / per;
}
__host__ __device__ __forceinline__ int last_split(int f, int n_vt, int per) {
  return ((f + 1) * n_vt - 1) / per;
}

// The kernels below have internal linkage: each source that includes this
// header builds its own.
namespace {

// ll, logz [F, B] from each head's partials part [3][slots][F][B] (running
// max, sum of exp relative to it, target logit), merged in slot order; rows
// at or past num_valid give 0 (their partials are never read)
__global__ void ce_fwd_combine(const float* __restrict__ part, const int* __restrict__ nv_ptr,
                               float* __restrict__ ll, float* __restrict__ logz, int B, int F,
                               int V, int pairs_per_split, int slots, int width) {
  const int nv = valid_rows(nv_ptr, B);
  const int n_vt = (V + 127) / 128;
  const long long n = (long long)F * B;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    if (e % B >= nv) {
      ll[e] = 0.f;
      logz[e] = 0.f;
      continue;
    }
    const int f = static_cast<int>(e / B);
    const int used = width * (last_split(f, n_vt, pairs_per_split) -
                              first_split(f, n_vt, pairs_per_split) + 1);
    float m = __ldg(part + e);
    float s = __ldg(part + slots * n + e);
    float p = __ldg(part + 2 * slots * n + e);
    for (int q = 1; q < used; ++q) {
      const float mq = __ldg(part + q * n + e);
      const float mn = fmaxf(m, mq);
      s = s * __expf(m - mn) + __ldg(part + (slots + q) * n + e) * __expf(mq - mn);
      m = mn;
      p += __ldg(part + (2 * slots + q) * n + e);
    }
    const float lz = m + logf(s);
    ll[e] = lz - p;
    logz[e] = lz;
  }
}

inline cudaError_t launch_fwd_combine(const float* part, const int* nv, float* ll, float* logz,
                                      int B, int F, int V, int pairs_per_split, int slots,
                                      int width, cudaStream_t stream) {
  void* args[] = {&part, &nv, &ll, &logz, &B, &F, &V, &pairs_per_split, &slots, &width};
  const long long blocks = ((long long)F * B + 255) / 256;
  return cudaLaunchKernel(ce_fwd_combine,
                          dim3(static_cast<unsigned>(blocks < 1024 ? blocks : 1024)), dim3(256),
                          args, 0, stream);
}

// ---- the backward's ordered sums (ce_bwd.cu, ce_bf16.cu) ----

// out[i] = sum_s part[s * n + i], s = 0, 1, ... in order: deterministic
__global__ void ce_sum_slices_kernel(const float* __restrict__ part, int slices, long long n,
                                     float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float s = 0.f;
    for (int t = 0; t < slices; ++t) s += __ldg(part + t * n + i);
    out[i] = s;
  }
}

// dh[r, k] = sum_s part[s][r][k] in order for r < num_valid, else 0
__global__ void ce_dh_sum_kernel(const float* __restrict__ part, int splits,
                                 const int* __restrict__ nv_ptr, int B, int K,
                                 float* __restrict__ dh) {
  const long long n = (long long)B * K;
  const long long valid = (long long)valid_rows(nv_ptr, B) * K;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float s = 0.f;
    if (i < valid)
      for (int t = 0; t < splits; ++t) s += __ldg(part + t * n + i);
    dh[i] = s;
  }
}

inline dim3 sum_grid(long long n) {
  const long long blocks = (n + 255) / 256;
  return dim3(static_cast<unsigned>(blocks < 2048 ? blocks : 2048));
}

inline cudaError_t sum_slices(const float* part, int slices, long long n, float* out,
                              cudaStream_t stream) {
  void* args[] = {&part, &slices, &n, &out};
  return cudaLaunchKernel(ce_sum_slices_kernel, sum_grid(n), dim3(256), args, 0, stream);
}

inline cudaError_t launch_dh_sum(const float* part, int splits, const int* nv, int B, int K,
                                 float* dh, cudaStream_t stream) {
  void* args[] = {&part, &splits, &nv, &B, &K, &dh};
  return cudaLaunchKernel(ce_dh_sum_kernel, sum_grid((long long)B * K), dim3(256), args, 0,
                          stream);
}

}  // namespace

}  // namespace ce
