// The logit-tile walk of the softmax cross-entropy kernels (ce_fwd.cu,
// ce_bwd.cu) on the tensor cores: ce_fwd.cu's forward and ce_bwd.cu's ce_dh_kernel both call
// logit_walk, so the logits the forward folds into logz are, operation for
// operation, the logits the backward recomputes for exp(S - logz).  Also the
// copy and split helpers that ce_dw_kernel shares.
//
// An item is 64 rows of h (below num_valid) and a run of (head, 128-column
// vocabulary tile) pairs, walked 64 columns a step.  The item's h rows are
// split once into TF32 halves in shared memory; each step's W half-tile, its
// bias and the rows' values for its head (the targets, and logz and g in the
// backward) come by cp.async through a ring of two stages while the previous
// step computes, and the W rows are split once per step.  Eight warps own
// 16 rows x 32 columns of the step's logit tile S = h W^T, each k8 step's
// 3xTF32 product added in fp32 (tc::mma3_add; one exact MMA under "bf16").
// The caller's epilogue gets S without the bias, in the m16n8k8 accumulator
// layout: s[nt][q] is row rb + group + 8 (q / 2), column vb + 8 nt + 2 tig +
// q % 2 of the step, with the step's split W rows (ItemTiles::wb, ::ws), bias
// (::bs) and row values (::rv) in shared memory.  Operand tiles are laid out
// [row][k] 68 floats apart, so every fragment load is free of bank
// conflicts.  (Splitting W as its fragments are loaded, or once a launch
// into device memory, and loading the fragments by ldmatrix each measured
// no faster than this on an NVIDIA H100 80GB HBM3 at 700.00 W.)
//
// Also the pieces every CE kernel shares: the dynamic shared memory, the
// widest hidden width they take, the operand rounding under
// set_precision("bf16") (round to nearest even, which is what the TPU
// kernel's bf16 dots did) and the device count of valid rows.
#pragma once

#include <cuda_bf16.h>
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

// An operand of a product: x itself, or x rounded to bf16 under "bf16".
__device__ __forceinline__ float operand(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
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

// x as TF32 halves (x itself rounded to bf16 and a zero small half under "bf16")
__device__ __forceinline__ void split_op(float x, int bf16, uint32_t& big, uint32_t& small) {
  if (bf16) {
    big = __float_as_uint(operand(x, 1));
    small = 0u;
  } else {
    tc::split(x, big, small);
  }
}

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
                                           int K, int KP, int bf16, int tid) {
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
    if (r < n) split_op(v[i], bf16, big[r * LDK + k], small[r * LDK + k]);
  }
}

// n packed rows [n][K] of a ring stage -> split big / small [n][LDK], zero
// for k in [K, KP): four columns a thread where K is a multiple of 4
__device__ __forceinline__ void split_stage(const float* st, uint32_t* big, uint32_t* small,
                                            int n, int K, int KP, int bf16, int tid) {
  if ((K & 3) == 0) {
    for (int e = 4 * tid; e < n * KP; e += 4 * THREADS) {
      const int r = e / KP;
      const int k = e - r * KP;
      const float4 v = k < K ? *reinterpret_cast<const float4*>(st + r * K + k)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      uint4 b, sm;
      split_op(v.x, bf16, b.x, sm.x);
      split_op(v.y, bf16, b.y, sm.y);
      split_op(v.z, bf16, b.z, sm.z);
      split_op(v.w, bf16, b.w, sm.w);
      *reinterpret_cast<uint4*>(big + r * LDK + k) = b;
      *reinterpret_cast<uint4*>(small + r * LDK + k) = sm;
    }
  } else {
    for (int e = tid; e < n * KP; e += THREADS) {
      const int r = e / KP;
      const int k = e - r * KP;
      split_op(k < K ? st[r * K + k] : 0.f, bf16, big[r * LDK + k], small[r * LDK + k]);
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
                                           int n_steps, int bf16, const ItemTiles& t,
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
                                      K, KP, bf16, tid);

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
    split_stage(st, t.wb, t.ws, STEP_V, K, KP, bf16, tid);
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
        tc::mma3_add(s[nt], ab, as, bb, bsm, bf16);
      }
    }
    epilogue(j, f, v0, s);
  }
}

}  // namespace ce
