// Softmax cross-entropy of vocabulary-sized heads, backward, for Hopper
// (sm_90a), behind a plain C interface that ops/ce_cuda.py loads with ctypes.
// With the forward's logz [F, B] and the output gradient g [F, B], for rows
// r < num_valid (every other row takes and gives no gradient):
//
//   dS[f, r, v] = (exp(S[f, r, v] - logz[f, r]) - [v == t[f, r]]) * g[f, r]
//   dh[r, :]    = sum_f sum_v dS[f, r, v] * W[f, v, :]     (summed over heads)
//   dW[f, v, :] = sum_r dS[f, r, v] * h[r, :]
//   db[f, v]    = sum_r dS[f, r, v]
//
// where S = h W^T + b is recomputed tile by tile, never stored.  Layouts and
// types as in ce_fwd.cu.  The bf16 mode has kernels of its own (ce_bf16.cu).
//
// Replaces: xdeepfm_tpu/ops/ce_pallas.py _ce_bwd / _bwd_kernel (one head) and
// _ces_bwd / _bwd_kernel_stacked (F heads in one launch).
//
// Bound: operations.  The least work is the logit recompute plus the two
// gradient products, 3 * 2*nv*K*V*F FLOPs (137.8 GFLOP at the canonical Pro
// step's nv = 1365 valid rows of B = 4096, K = 64, F = 26, V = 10112), against
// W, dW and a few MB of row data in bytes: 2.057 ms on the fp32 FMA pipes
// (67 TFLOP/s), 0.835 ms on the tensor cores in 3xTF32 (495 / 3 TFLOP/s).
// Every product here is a 3xTF32 mma.sync of tc_tf32.cuh.  The TPU
// kernel carried dW/db in its output block along a sequential batch axis
// and dh in VMEM for the whole grid; Hopper's blocks run in no order and
// nothing carries between them, so the work is split by what each block
// owns, and every sum is taken in a fixed order (deterministic, no atomics):
//   * ce_dw_kernel owns a 128-column vocabulary tile of one head: its W tile,
//     split once into TF32 halves in shared memory, dW [128, K] and db [128]
//     in registers (a warp owns 16 columns).  It walks the valid rows 32 at
//     a time, their h rows, logz, g and targets brought in by cp.async into
//     a ring of two stages while the previous chunk computes: the transposed
//     logit tile S^T = W h^T (MMAs), dS in place in the accumulator
//     fragments, then dW += dS^T h straight from those fragments.  Where heads
//     x tiles fill the card too thinly (one head), the rows are cut into
//     slices over gridDim.z whose partials ce_sum_slices adds in order;
//   * ce_dh_kernel: persistent blocks read num_valid and stride over the
//     items (64-row tile of the valid rows, split of the (head, vocabulary
//     tile) pairs), so no block is planned for rows that take no part.  An
//     item keeps dh [64, K] in registers and walks its pairs through
//     ce_tc.cuh's logit_walk, the forward's own routine (ce_fwd.cu): h rows
//     split once in shared memory, each W half-tile with its bias and the
//     rows' logz, g and targets brought in by cp.async into a ring of two
//     stages, the logit tile S = h W^T; then dS in the fragments and
//     dh += dS W.  So exp(S - logz) takes the very logits whose logsumexp
//     the forward took.  Eight warps own 16 rows x 32 columns; the two column
//     halves' dh are added in order at the item's end, and each split writes
//     its partial, which ce_dh_sum adds in order (zero past num_valid).
// dS never goes through shared memory: the m16n8k8 accumulator holds columns
// (2 tig, 2 tig + 1) of row group, so reading the reduction axis of the next
// product in the order (0, 2, 4, 6, 1, 3, 5, 7) makes the accumulator
// (c0, c2, c1, c3) exactly the A fragment of that product.  Operand tiles
// are laid out [row][k] 68 floats apart, so every fragment load is free of
// bank conflicts.  Each kernel recomputes the logits once: 4 * 2*nv*K*V*F
// FLOPs in all, a third more than the least.  Two blocks of ~105 KB of shared
// memory share an SM.  Ragged B, V and K are masked (zero-filled operands),
// not padded; every output is defined at num_valid = 0.  Against float64, at
// the Pro step's shape, dh, dW and db err 0.2-1.3x as much as the plain fp32
// version (chip_smoke.py, an NVIDIA H100 80GB HBM3 at 700 W).

#include <cmath>
#include <stdint.h>

#include "ce_tc.cuh"

namespace {

using ce::copy_row_values;
using ce::copy_rows;
using ce::ITEM_R;
using ce::KMAX;
using ce::LDK;
using ce::split_rows;
using ce::split_stage;
using ce::THREADS;

constexpr int DW_V = 128;          // ce_dw_kernel: vocabulary columns of a block
constexpr int DW_R = 32;           // ce_dw_kernel: rows of a chunk
constexpr int DW_STAGE = DW_R * KMAX + 3 * DW_R;  // h rows, logz, g, targets
static_assert(THREADS / 32 * 16 == DW_V, "ce_dw: a warp owns 16 columns");

constexpr int dw_smem_floats() {
  return 2 * DW_V * LDK + 2 * DW_R * LDK + 2 * DW_STAGE + DW_V + 3 * DW_R;
}

// grid (vocabulary tiles, heads, row slices); dw [slices][F][V][K] and
// db [slices][F][V] (the outputs themselves when slices == 1)
__global__ void __launch_bounds__(THREADS, 2)
ce_dw_kernel(const float* __restrict__ h, const float* __restrict__ w,
             const float* __restrict__ bias, const long long* __restrict__ tgt,
             const float* __restrict__ logz, const float* __restrict__ g,
             const int* __restrict__ nv_ptr, float* __restrict__ dw,
             float* __restrict__ db, int B, int K, int V, int F, int rows_per_slice) {
  const int KP = ce::round_up(K, 8);
  uint32_t* wb = reinterpret_cast<uint32_t*>(ce_smem);  // [DW_V][LDK]: W tile, big
  uint32_t* ws = wb + DW_V * LDK;                        // small
  uint32_t* hb = ws + DW_V * LDK;                        // [DW_R][LDK]: h rows, big
  uint32_t* hs = hb + DW_R * LDK;                        // small
  float* ring = reinterpret_cast<float*>(hs + DW_R * LDK);  // 2 x DW_STAGE
  float* bs = ring + 2 * DW_STAGE;                       // [DW_V]: bias
  float* rv = bs + DW_V;                                 // [3][DW_R]: logz, g, targets

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, group = lane / 4, tig = lane % 4;
  const int v0 = blockIdx.x * DW_V;
  const int f = blockIdx.y;
  const int slice = blockIdx.z;
  const int nv = ce::valid_rows(nv_ptr, B);
  const int r_begin = slice * rows_per_slice;
  const int r_end = min(nv, r_begin + rows_per_slice);
  const int n_chunks = r_end > r_begin ? (r_end - r_begin + DW_R - 1) / DW_R : 0;
  const float* w_f = w + (long long)f * V * K;
  const float* lz_f = logz + (long long)f * B;
  const float* g_f = g + (long long)f * B;
  const long long* t_f = tgt + (long long)f * B;

  // the W tile, once: raw rows into ws's space, then split in place
  copy_rows(reinterpret_cast<float*>(ws), w_f + (long long)v0 * K, ce::round_up(DW_V * K, 4),
            (min(V, v0 + DW_V) - v0) * K, tid);
  tc::cp_async_commit();
  for (int v = tid; v < DW_V; v += THREADS)
    bs[v] = v0 + v < V ? __ldg(bias + (long long)f * V + v0 + v) : 0.f;
  auto issue = [&](int c, int s) {
    float* st = ring + s * DW_STAGE;
    const int r0 = r_begin + c * DW_R;
    const int valid = min(r_end, r0 + DW_R) - r0;
    copy_rows(st, h + r0 * K, DW_R * K, valid * K, tid);
    copy_row_values(st + DW_R * KMAX, lz_f + r0, g_f + r0, t_f + r0, DW_R, valid, tid);
  };
  if (n_chunks > 0) issue(0, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();
  __syncthreads();
  split_rows<DW_V * KMAX / THREADS>(reinterpret_cast<const float*>(ws), wb, ws, DW_V, K, KP,
                                    tid);

  const int vb = warp * 16;  // this warp's columns of the tile
  float acc[8][4];           // dW [vb + 16][k]: k tiles of 8
  float dbp[2] = {0.f, 0.f};  // db of columns vb + group and vb + group + 8
#pragma unroll
  for (int kt = 0; kt < 8; ++kt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[kt][q] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      issue(c + 1, (c + 1) % 2);  // that stage's chunk c - 1 is converted
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    const float* st = ring + (c % 2) * DW_STAGE;
    split_stage(st, hb, hs, DW_R, K, KP, tid);
    for (int e = tid; e < 3 * DW_R; e += THREADS) rv[e] = st[DW_R * KMAX + e];
    __syncthreads();

    const int r0 = r_begin + c * DW_R;
    // S^T [16 columns][32 rows] = W h^T
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[nt][q] = 0.f;
    for (int k8 = 0; k8 < KP; k8 += 8) {
      const int a0 = (vb + group) * LDK + k8 + tig;
      const int a1 = a0 + 8 * LDK;
      const uint32_t ab[4] = {wb[a0], wb[a1], wb[a0 + 4], wb[a1 + 4]};
      const uint32_t as[4] = {ws[a0], ws[a1], ws[a0 + 4], ws[a1 + 4]};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int b0 = (8 * nt + group) * LDK + k8 + tig;
        const uint32_t bb[2] = {hb[b0], hb[b0 + 4]};
        const uint32_t bsm[2] = {hs[b0], hs[b0 + 4]};
        tc::mma3_add(s[nt], ab, as, bb, bsm);
      }
    }
    // dS in the fragments: s[nt][q] is column vb + group + 8 (q / 2), row
    // 8 nt + 2 tig + q % 2
    const float* lz = rv;
    const float* gr = rv + DW_R;
    const int* tt = reinterpret_cast<const int*>(rv + 2 * DW_R);
    float dbc[2] = {0.f, 0.f};  // this chunk's, added to dbp once: a shorter sum
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = vb + group + 8 * (q / 2);
        const int r = 8 * nt + 2 * tig + q % 2;
        float d = 0.f;
        if (r0 + r < r_end && v0 + v < V) {
          const float onehot = tt[r] == v0 + v ? 1.f : 0.f;
          d = (__expf(s[nt][q] + bs[v] - lz[r]) - onehot) * gr[r];
        }
        dbc[q / 2] += d;
        s[nt][q] = d;
      }
    dbp[0] += dbc[0];
    dbp[1] += dbc[1];
    // dW [16 columns][k] += dS^T h, rows in the order (0, 2, 4, 6, 1, 3, 5, 7)
    // of each 8, so that (c0, c2, c1, c3) is the A fragment
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t ab[4], as[4];
      tc::split(s[nt][0], ab[0], as[0]);
      tc::split(s[nt][2], ab[1], as[1]);
      tc::split(s[nt][1], ab[2], as[2]);
      tc::split(s[nt][3], ab[3], as[3]);
      const int b0 = (8 * nt + 2 * tig) * LDK + group;
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {
        if (8 * kt >= KP) break;
        const uint32_t bb[2] = {hb[b0 + 8 * kt], hb[b0 + LDK + 8 * kt]};
        const uint32_t bsm[2] = {hs[b0 + 8 * kt], hs[b0 + LDK + 8 * kt]};
        tc::mma3_add(acc[kt], ab, as, bb, bsm);
      }
    }
  }

  float* dw_s = dw + ((long long)slice * F + f) * V * K;
#pragma unroll
  for (int kt = 0; kt < 8; ++kt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + vb + group + 8 * (q / 2);
      const int k = 8 * kt + 2 * tig + q % 2;
      if (v < V && k < K) dw_s[(long long)v * K + k] = acc[kt][q];
    }
  // db: the four lanes of a group hold one column's row sums; add in order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dbp[i] += __shfl_xor_sync(0xffffffffu, dbp[i], 1);
    dbp[i] += __shfl_xor_sync(0xffffffffu, dbp[i], 2);
    const int v = v0 + vb + group + 8 * i;
    if (tig == 0 && v < V) db[((long long)slice * F + f) * V + v] = dbp[i];
  }
}

// Persistent: block b takes items b, b + gridDim.x, ... of the
// ceil(num_valid / 64) x splits items (row tile = item % tiles, split =
// item / tiles).  Split s walks the (head, vocabulary tile) pairs
// [s * pairs_per_split, ...) in the order f * tiles + t, two 64-column steps
// a pair.  dh_part [splits][B][K]: only the valid rows of each split are
// written.
__global__ void __launch_bounds__(THREADS, 2)
ce_dh_kernel(const float* __restrict__ h, const float* __restrict__ w,
             const float* __restrict__ bias, const long long* __restrict__ tgt,
             const float* __restrict__ logz, const float* __restrict__ g,
             const int* __restrict__ nv_ptr, float* __restrict__ dh_part, int B, int K, int V,
             int F, int splits, int pairs_per_split) {
  const int KP = ce::round_up(K, 8);
  const ce::ItemTiles t = ce::item_tiles();
  float* red = reinterpret_cast<float*>(t.wb);  // [ITEM_R][LDK]: the item's end

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, group = lane / 4, tig = lane % 4;
  const int rb = (warp % 4) * 16;  // this warp's rows of the item
  const int vb = (warp / 4) * 32;  // and columns of a step
  const int nv = ce::valid_rows(nv_ptr, B);
  const int pairs = F * ((V + 127) / 128);
  const int tiles = (nv + ITEM_R - 1) / ITEM_R;

  for (int item = blockIdx.x; item < tiles * splits; item += gridDim.x) {
    const int row0 = (item % tiles) * ITEM_R;
    const int split = item / tiles;
    const int rows = min(nv, row0 + ITEM_R) - row0;
    const int p_begin = split * pairs_per_split;
    const int n_steps = 2 * (min(pairs, p_begin + pairs_per_split) - p_begin);

    float acc[8][4];  // dh [rb + 16][k] over this warp's columns: k tiles of 8
#pragma unroll
    for (int kt = 0; kt < 8; ++kt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[kt][q] = 0.f;

    ce::logit_walk(h, w, bias, tgt, logz, g, B, K, V, row0, rows, p_begin, n_steps, t,
                   [&](int, int, int v0, float (&s)[4][4]) {
      // dS in the fragments: s[nt][q] is row rb + group + 8 (q / 2), column
      // vb + 8 nt + 2 tig + q % 2
      const float* lz = t.rv;
      const float* gr = t.rv + ITEM_R;
      const int* tt = reinterpret_cast<const int*>(t.rv + 2 * ITEM_R);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = rb + group + 8 * (q / 2);
          const int v = vb + 8 * nt + 2 * tig + q % 2;
          float d = 0.f;
          if (r < rows && v0 + v < V) {
            const float onehot = tt[r] == v0 + v ? 1.f : 0.f;
            d = (__expf(s[nt][q] + t.bs[v] - lz[r]) - onehot) * gr[r];
          }
          s[nt][q] = d;
        }
      // dh [16 rows][k] += dS W, columns in the order (0, 2, 4, 6, 1, 3, 5, 7)
      // of each 8, so that (c0, c2, c1, c3) is the A fragment
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t ab[4], as[4];
        tc::split(s[nt][0], ab[0], as[0]);
        tc::split(s[nt][2], ab[1], as[1]);
        tc::split(s[nt][1], ab[2], as[2]);
        tc::split(s[nt][3], ab[3], as[3]);
        const int b0 = (vb + 8 * nt + 2 * tig) * LDK + group;
#pragma unroll
        for (int kt = 0; kt < 8; ++kt) {
          if (8 * kt >= KP) break;
          const uint32_t bb[2] = {t.wb[b0 + 8 * kt], t.wb[b0 + LDK + 8 * kt]};
          const uint32_t bsm[2] = {t.ws[b0 + 8 * kt], t.ws[b0 + LDK + 8 * kt]};
          tc::mma3_add(acc[kt], ab, as, bb, bsm);
        }
      }
    });

    // the two column halves' dh, added in order: warps 4-7 through shared memory
    __syncthreads();  // every warp is done with wb
    if (vb != 0) {
#pragma unroll
      for (int kt = 0; kt < 8; ++kt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          red[(rb + group + 8 * (q / 2)) * LDK + 8 * kt + 2 * tig + q % 2] = acc[kt][q];
    }
    __syncthreads();
    if (vb == 0) {
      float* out = dh_part + (long long)split * B * K;
#pragma unroll
      for (int kt = 0; kt < 8; ++kt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = rb + group + 8 * (q / 2);
          const int k = 8 * kt + 2 * tig + q % 2;
          if (r < rows && k < K)
            out[(row0 + r) * K + k] = acc[kt][q] + red[r * LDK + k];
        }
    }
    __syncthreads();  // red (wb) and hs are free for the next item
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, contiguity, 1 <= K <= 64, B, V, F >= 1
// and 32-bit element offsets, and allocated the outputs dh [B, K],
// dw [F, V, K], db [F, V], the partials dh_part [splits, B, K] and, where
// slices > 1, dw_part [slices, F, V, K] and db_part [slices, F, V].
// ce_dh_kernel runs dh_blocks persistent blocks over (valid row tile, split)
// items, split s walking the (head, vocabulary tile) pairs
// [s * pairs_per_split, (s + 1) * pairs_per_split) in the order f * tiles + t;
// ce_dw_kernel's slice s walks rows [s * rows_per_slice, ...), a multiple
// of 128.
int ce_bwd(const void* h, const void* w, const void* b, const void* t, const void* logz,
           const void* g, const void* nv, void* dh, void* dh_part, int splits,
           int pairs_per_split, int dh_blocks, void* dw, void* db, void* dw_part,
           void* db_part, int slices, int rows_per_slice, int B, int K, int V, int F,
           void* stream) {
  const int dw_smem = dw_smem_floats() * 4;
  const int dh_smem = ce::item_smem_floats() * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ce_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ce_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dh_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  const long long* tp = static_cast<const long long*>(t);
  const float* lzp = static_cast<const float*>(logz);
  const float* gp = static_cast<const float*>(g);
  const int* nvp = static_cast<const int*>(nv);

  float* dwo = static_cast<float*>(slices > 1 ? dw_part : dw);
  float* dbo = static_cast<float*>(slices > 1 ? db_part : db);
  void* dw_args[] = {&hp, &wp, &bp, &tp, &lzp, &gp, &nvp, &dwo, &dbo,
                     &B, &K, &V, &F, &rows_per_slice};
  err = cudaLaunchKernel(ce_dw_kernel, dim3((V + DW_V - 1) / DW_V, F, slices), dim3(THREADS),
                         dw_args, static_cast<size_t>(dw_smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  float* dhp = static_cast<float*>(dh_part);
  void* dh_args[] = {&hp, &wp, &bp, &tp, &lzp, &gp, &nvp, &dhp,
                     &B, &K, &V, &F, &splits, &pairs_per_split};
  err = cudaLaunchKernel(ce_dh_kernel, dim3(dh_blocks), dim3(THREADS), dh_args,
                         static_cast<size_t>(dh_smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ce::launch_dh_sum(dhp, splits, nvp, B, K, static_cast<float*>(dh), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  if (slices > 1) {
    err = ce::sum_slices(dwo, slices, (long long)F * V * K, static_cast<float*>(dw), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = ce::sum_slices(dbo, slices, (long long)F * V, static_cast<float*>(db), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ce_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
