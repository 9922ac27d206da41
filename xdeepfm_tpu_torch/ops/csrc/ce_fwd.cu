// Softmax cross-entropy of vocabulary-sized heads, forward, for Hopper
// (sm_90a), behind a plain C interface that ops/ce_cuda.py loads with ctypes.
// For F heads that share the hidden state h [B, K]:
//
//   S[f, r, v]  = h[r, :] . W[f, v, :] + b[f, v]
//   logz[f, r]  = logsumexp_v S[f, r, v]
//   ll[f, r]    = logz[f, r] - S[f, r, t[f, r]]
//
// for rows r < num_valid; rows at or past it give ll = logz = 0.  h [B, K],
// W [F, V, K] (nn.Linear's [out, in] layout, heads stacked), b [F, V] and the
// outputs [F, B] are fp32; the targets t [F, B] are int64; num_valid is a
// device int32 read through a pointer, so no host sync is needed.  A single
// head is F = 1.
//
// Replaces: xdeepfm_tpu/ops/ce_pallas.py _ce_fwd / _fwd_kernel (one head) and
// _ces_fwd / _fwd_kernel_stacked (F heads in one launch).
//
// Bound: operations.  At the canonical Pro step (F = 26 heads, B = 4096,
// K = 64, V padded to 10112) the products are 2*nv*K*V*F = 33.6 MFLOP per
// valid row (138 GFLOP at nv = B), while the bytes that must move are W
// (67 MB) and a few MB more: about 2000 FLOP per byte against the card's fp32
// ridge of 20.  The [B, V] logits are the one thing that must never reach
// device memory (4.3 GB a step at these shapes), so:
//   * one block owns 128 rows of one head and walks a range of the
//     vocabulary in 128-column tiles; its h tile (all K <= 64) stays in
//     shared memory.  The vocabulary is cut into as many ranges (gridDim.z)
//     as fill the card when few row tiles are valid (a third of a batch, or
//     one head); each block writes its rows' partial max, sum of exp and
//     target logit, and ce_fwd_combine merges the ranges in order;
//   * W streams through in 16-deep chunks, double-buffered, with the next
//     chunk loaded into registers while the current one computes;
//   * each logit tile lives in registers (8 x 8 per thread) and is folded at
//     once into the thread's running max and sum of exp for its 8 rows
//     (online logsumexp); the target's logit is picked up by the one thread
//     that owns its column;
//   * only at the end are the 16 threads that share a row combined, by
//     shuffles in a fixed order, and the ranges by ce_fwd_combine, in order
//     (deterministic).
// The TPU kernel carried the running statistics along a sequential vocabulary
// grid axis in VMEM scratch and primed its software pipeline with a dummy
// block (_DUMMY); here the vocabulary walk is a loop in the block and neither
// is needed.  Tiles wholly past num_valid do no work; the tile that straddles
// it computes all its rows and writes zeros for the invalid ones.  Ragged B,
// V and K are masked, not padded.  Padded vocabulary columns (bias -1e30, as
// the decoder pads stacked heads) add exp(...) = 0 to a real row's sum: the
// running max starts at -FLT_MAX and every row has at least one real column,
// so the combined max is always a real logit.

#include <cfloat>
#include <cmath>

#include "ce_tile.cuh"

namespace {

using ce::BK;
using ce::BM;
using ce::BN;
using ce::LD;
using ce::THREADS;

constexpr int WLD = BN + 4;                // padded row of a W chunk
constexpr int WROWS = THREADS / BK;        // vocabulary rows the W loader covers per pass
constexpr int WPASS = BN / WROWS;          // W values per thread per chunk (8)
static_assert(THREADS % BK == 0 && BN % WROWS == 0, "W loader");

int fwd_smem_bytes(int kp) {
  return (kp * LD + 2 * BK * WLD + 2 * BM) * 4;
}

// grid (row tiles, heads, vocabulary ranges of tiles_per_range tiles);
// part [3][ranges][F][B]: each row's running max, sum of exp relative to it,
// and target logit (0 where the target lies in another range)
__global__ void __launch_bounds__(THREADS, 2)
ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const float* __restrict__ bias, const long long* __restrict__ tgt,
              const int* __restrict__ nv_ptr, float* __restrict__ part, int B, int K, int V,
              int F, int tiles_per_range, int bf16) {
  const int KP = ce::round_up(K, BK);
  float* hs = ce_smem;                                  // [KP][LD]: h tile, k-major
  float* ws = hs + KP * LD;                             // [2][BK][WLD]: W chunks, k-major
  int* tl = reinterpret_cast<int*>(ws + 2 * BK * WLD);  // [BM]: targets
  float* pk = reinterpret_cast<float*>(tl + BM);        // [BM]: the target's logit

  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int f = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int nv = ce::valid_rows(nv_ptr, B);
  if (row0 >= nv) return;  // the whole tile is past the valid prefix: no work

  const float* w_f = w + (long long)f * V * K;
  const float* b_f = bias + (long long)f * V;
  // h tile: consecutive threads read consecutive k of one row
  for (int e = tid; e < BM * KP; e += THREADS) {
    const int r = e / KP;
    const int k = e - r * KP;
    const int row = row0 + r;
    hs[k * LD + r] = (row < B && k < K) ? ce::operand(__ldg(h + row * K + k), bf16) : 0.f;
  }
  for (int r = tid; r < BM; r += THREADS) {
    const int row = row0 + r;
    tl[r] = row < B ? static_cast<int>(__ldg(tgt + (long long)f * B + row)) : -1;
    pk[r] = 0.f;
  }

  // W loader: k slot lk, vocabulary rows lv + p * WROWS (a half-warp reads 16
  // consecutive k of one row)
  const int lk = tid % BK;
  const int lv = tid / BK;
  const int nk = KP / BK;
  const int vt0 = blockIdx.z * tiles_per_range;
  const int n_vt = min((V + BN - 1) / BN - vt0, tiles_per_range);
  const int n_chunks = n_vt * nk;
  float wreg[WPASS];
  auto load_chunk = [&](int c) {
    const int v0 = (vt0 + c / nk) * BN;
    const int k = (c % nk) * BK + lk;
#pragma unroll
    for (int p = 0; p < WPASS; ++p) {
      const int v = v0 + lv + p * WROWS;
      wreg[p] = (v < V && k < K) ? ce::operand(__ldg(w_f + (long long)v * K + k), bf16) : 0.f;
    }
  };
  auto store_chunk = [&](int buf) {
#pragma unroll
    for (int p = 0; p < WPASS; ++p) ws[(buf * BK + lk) * WLD + lv + p * WROWS] = wreg[p];
  };

  float m[8], s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -FLT_MAX;
    s[i] = 0.f;
  }
  float acc[8][8];
  ce::zero(acc);

  load_chunk(0);
  store_chunk(0);
  __syncthreads();
  int buf = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const bool more = c + 1 < n_chunks;
    if (more) load_chunk(c + 1);
    const int kc = c % nk;
    ce::mma_kk(hs + kc * BK * LD, LD, ws + buf * BK * WLD, WLD, BK, tr, tc, acc);
    if (kc == nk - 1) {
      // the logit tile of vocabulary columns [v0, v0 + BN) is complete
      const int v0 = (vt0 + c / nk) * BN;
      float bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int v = v0 + ce::tile_col(tc, j);
        bv[j] = v < V ? __ldg(b_f + v) : -INFINITY;  // masked columns: exp = 0
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float sv[8];
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sv[j] = acc[i][j] + bv[j];
          mt = fmaxf(mt, sv[j]);
        }
        const float mn = fmaxf(m[i], mt);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += __expf(sv[j] - mn);
        s[i] = s[i] * __expf(m[i] - mn) + sum;
        m[i] = mn;
        const int r = ce::tile_row(tr, i);
        const int lt = tl[r] - v0;
        if (lt >= 0 && lt < BN) {  // one thread of the block owns the target
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (ce::tile_col(tc, j) == lt) pk[r] = sv[j];
        }
      }
      ce::zero(acc);
    }
    if (more) store_chunk(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  // combine the 16 threads (lanes tc = 0..15 of a half-warp) that share rows
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float so = __shfl_xor_sync(0xffffffffu, s[i], off);
      const float mn = fmaxf(m[i], mo);
      s[i] = s[i] * __expf(m[i] - mn) + so * __expf(mo - mn);
      m[i] = mn;
    }
  }
  if (tc == 0) {
    const long long plane = (long long)gridDim.z * F * B;
    float* out = part + ((long long)blockIdx.z * F + f) * B;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ce::tile_row(tr, i);
      const int row = row0 + r;
      if (row >= nv) continue;
      out[row] = m[i];
      out[plane + row] = s[i];
      out[2 * plane + row] = pk[r];
    }
  }
}

// ll, logz [F, B] from the ranges' partials, merged in range order; rows at
// or past num_valid give 0 (their partials are never read)
__global__ void ce_fwd_combine(const float* __restrict__ part, const int* __restrict__ nv_ptr,
                               float* __restrict__ ll, float* __restrict__ logz, int B, int F,
                               int ranges) {
  const int nv = ce::valid_rows(nv_ptr, B);
  const long long n = (long long)F * B;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    if (e % B >= nv) {
      ll[e] = 0.f;
      logz[e] = 0.f;
      continue;
    }
    float m = __ldg(part + e);
    float s = __ldg(part + ranges * n + e);
    float p = __ldg(part + 2 * ranges * n + e);
    for (int q = 1; q < ranges; ++q) {
      const float mq = __ldg(part + q * n + e);
      const float mn = fmaxf(m, mq);
      s = s * __expf(m - mn) + __ldg(part + (ranges + q) * n + e) * __expf(mq - mn);
      m = mn;
      p += __ldg(part + (2 * ranges + q) * n + e);
    }
    const float lz = m + logf(s);
    ll[e] = lz - p;
    logz[e] = lz;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, contiguity, 1 <= K <= 64, B, V, F >= 1
// and 32-bit element offsets, and allocated ll and logz [F, B] and the
// partials part [3, ranges, F, B]; the vocabulary is cut into `ranges` ranges
// of tiles_per_range 128-column tiles, none empty; nv may be null (all rows
// valid).
int ce_fwd(const void* h, const void* w, const void* b, const void* t, const void* nv,
           void* ll, void* logz, void* part, int ranges, int tiles_per_range, int B, int K,
           int V, int F, int bf16, void* stream) {
  const int smem = fwd_smem_bytes(ce::round_up(K, BK));
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  const long long* tp = static_cast<const long long*>(t);
  const int* nvp = static_cast<const int*>(nv);
  float* pp = static_cast<float*>(part);
  void* args[] = {&hp, &wp, &bp, &tp, &nvp, &pp, &B, &K, &V, &F, &tiles_per_range, &bf16};
  err = cudaLaunchKernel(ce_fwd_kernel, dim3((B + BM - 1) / BM, F, ranges), dim3(THREADS),
                         args, static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* cp = pp;
  float* llp = static_cast<float*>(ll);
  float* lzp = static_cast<float*>(logz);
  void* cargs[] = {&cp, &nvp, &llp, &lzp, &B, &F, &ranges};
  const long long blocks = ((long long)F * B + 255) / 256;
  err = cudaLaunchKernel(ce_fwd_combine, dim3(static_cast<unsigned>(blocks < 1024 ? blocks : 1024)),
                         dim3(256), cargs, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* ce_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
