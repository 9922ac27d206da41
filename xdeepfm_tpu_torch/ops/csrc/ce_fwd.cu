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
// _ces_fwd / _fwd_kernel_stacked (F heads in one launch).  The bf16 mode
// (set_precision("bf16")) has kernels of its own, in ce_bf16.cu.
//
// Bound: operations.  At the canonical Pro step (F = 26 heads, K = 64, V
// padded to 10112, nv = 1365 valid rows of B = 4096) the product is
// 2*nv*K*V*F = 45.9 GFLOP against W (67 MB) and a few MB more: 0.279 ms on
// the tensor cores in 3xTF32 (495 / 3 TFLOP/s), 0.686 ms on the fp32 FMA
// pipes, and nv*V*F = 359 M exps, 0.086 ms at the exp rate (the fp32 rate
// / 16), all on an NVIDIA H100 80GB HBM3 at 700.00 W.  The [B, V] logits are
// the one thing that must never reach device memory (4.3 GB a step), so:
//   * persistent blocks read num_valid and stride over the items (64-row
//     tile of the valid rows, split of the F * V/128 (head, vocabulary tile)
//     pairs), as ce_bwd.cu's ce_dh_kernel does: no block is planned for rows
//     past num_valid;
//   * an item walks its pairs through ce_tc.cuh's logit_walk, the routine
//     that ce_dh_kernel recomputes the logits with: h rows split once into
//     TF32 halves in shared memory, each 64-column W half-tile and its bias
//     brought by cp.async through a two-stage ring and split once, the logit
//     tile S = h W^T summed from zero in k8 steps of 3xTF32 MMAs, then the
//     bias added.  So the backward's exp(S - logz) takes the forward's own
//     logits;
//   * the logsumexp is taken straight from the accumulator fragments: a lane
//     holds 8 columns of each of its 2 rows a step and keeps a running max
//     and sum of exp for each row, the sum taken step by step (8 exps added
//     first, then the step's sum added to the row's).  The max is exact; a
//     warp vote skips the rescale when no lane's row max rose, which after
//     the first steps is most steps, so the rescale exps are rare beside the
//     logits' one exp each.  The lane that owns a row's target column keeps
//     its logit;
//   * when the walk passes to another head, and at the item's end, the four
//     lanes of a quad (which share rows) are combined by shuffles in a fixed
//     order, and each of the two column warps of a row writes its
//     (max, sum, target logit) as one partial of that head; ce_fwd_combine
//     merges a head's partials in the order of the walk.
// The TPU kernel carried the running statistics along a sequential vocabulary
// grid axis in VMEM scratch and primed its software pipeline with a dummy
// block (_DUMMY); here the vocabulary walk is a loop in the block and the
// splits are partials merged in order, so every sum has a fixed order and two
// runs are bit-equal.  The item that straddles num_valid computes all its
// rows and writes only the valid ones.  Ragged B, V and K are masked, not
// padded: columns past V take -inf.  Padded vocabulary columns (bias -1e30,
// as the decoder pads stacked heads) add exp(...) = 0 to a real row's sum:
// the running max starts at -FLT_MAX and every row has at least one real
// column, so the merged max is always a real logit.  Measured at the Pro
// step (chip_smoke.py, an NVIDIA H100 80GB HBM3 at 700.00 W): 1.635-1.662 ms,
// against 2.354-2.355 for the fp32-FMA kernel this replaced; ll and logz err
// 0.9-1.2x as much as the plain fp32 version against float64.

#include <cfloat>
#include <cmath>

#include "ce_tc.cuh"

namespace {

using ce::ITEM_R;
using ce::STEP_V;
using ce::THREADS;

// Persistent: block b takes items b, b + gridDim.x, ... of the
// ceil(num_valid / 64) x splits items (row tile = item % tiles, split =
// item / tiles).  part [3][slots][F][B]: each valid row's running max, sum
// of exp relative to it, and target logit (0 where the target lies in
// another partial's columns).
__global__ void __launch_bounds__(THREADS, 2)
ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const float* __restrict__ bias, const long long* __restrict__ tgt,
              const int* __restrict__ nv_ptr, float* __restrict__ part, int B, int K, int V,
              int F, int splits, int pairs_per_split, int slots) {
  const ce::ItemTiles t = ce::item_tiles();
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, group = lane / 4, tig = lane % 4;
  const int rb = (warp % 4) * 16;  // this warp's rows of the item
  const int vb = (warp / 4) * 32;  // and columns of a step
  const int nv = ce::valid_rows(nv_ptr, B);
  const int n_vt = (V + 127) / 128;
  const int pairs = F * n_vt;
  const int tiles = (nv + ITEM_R - 1) / ITEM_R;
  const long long plane = (long long)slots * F * B;

  for (int item = blockIdx.x; item < tiles * splits; item += gridDim.x) {
    const int row0 = (item % tiles) * ITEM_R;
    const int split = item / tiles;
    const int rows = min(nv, row0 + ITEM_R) - row0;
    const int p_begin = split * pairs_per_split;
    const int n_steps = 2 * (min(pairs, p_begin + pairs_per_split) - p_begin);

    // rows rb + group and rb + group + 8: running max, sum of exp relative
    // to it, target logit, for head cur
    float m[2], sum[2], pk[2];
    int cur = -1;
    auto flush = [&]() {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {  // the quad, in a fixed order
          const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
          const float so = __shfl_xor_sync(0xffffffffu, sum[i], off);
          const float po = __shfl_xor_sync(0xffffffffu, pk[i], off);
          const float mn = fmaxf(m[i], mo);
          sum[i] = sum[i] * __expf(m[i] - mn) + so * __expf(mo - mn);
          m[i] = mn;
          pk[i] += po;
        }
      if (tig == 0) {
        const int slot = 2 * (split - ce::first_split(cur, n_vt, pairs_per_split)) + vb / 32;
        float* out = part + ((long long)slot * F + cur) * B + row0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rb + group + 8 * i;
          if (r >= rows) continue;
          out[r] = m[i];
          out[plane + r] = sum[i];
          out[2 * plane + r] = pk[i];
        }
      }
    };

    ce::logit_walk(h, w, bias, tgt, nullptr, nullptr, B, K, V, row0, rows, p_begin, n_steps,
                   t, [&](int, int f, int v0, float (&s)[4][4]) {
      if (f != cur) {  // a new head: the last one's partials out, fresh statistics
        if (cur >= 0) flush();
        cur = f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m[i] = -FLT_MAX;
          sum[i] = 0.f;
          pk[i] = 0.f;
        }
      }
      // S = s + b; s[nt][q] is row rb + group + 8 (q / 2), column
      // vb + 8 nt + 2 tig + q % 2; columns past V take -inf (exp 0)
      const bool full = v0 + STEP_V <= V;
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int v = vb + 8 * nt + 2 * tig + q % 2;
          const float x = (full || v0 + v < V) ? s[nt][q] + t.bs[v] : -INFINITY;
          s[nt][q] = x;
          mt[q / 2] = fmaxf(mt[q / 2], x);
        }
      // rescale where a row's max rose; the warp skips it where none did
      if (__any_sync(0xffffffffu, mt[0] > m[0] || mt[1] > m[1])) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float mn = fmaxf(m[i], mt[i]);
          sum[i] *= __expf(m[i] - mn);
          m[i] = mn;
        }
      }
      float ss[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) ss[q / 2] += __expf(s[nt][q] - m[q / 2]);
      sum[0] += ss[0];
      sum[1] += ss[1];
      // the target's logit, in the one lane that holds its column
      const int* tt = reinterpret_cast<const int*>(t.rv + 2 * ITEM_R);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tt[rb + group + 8 * i] - v0 - vb - 2 * tig;
        if (static_cast<unsigned>(c) < 32u && (c & 6) == 0) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int b = 0; b < 2; ++b)
              if (c == 8 * nt + b) pk[i] = s[nt][2 * i + b];
        }
      }
    });
    flush();
    __syncthreads();  // every warp is done with the item's tiles
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, contiguity, 1 <= K <= 64, B, V, F >= 1
// and 32-bit element offsets, and allocated ll and logz [F, B] and the
// partials part [3, slots, F, B], slots at least twice the most splits that
// reach one head.  ce_fwd_kernel runs `blocks` persistent blocks over
// (valid row tile, split) items, split s walking the (head, vocabulary tile)
// pairs [s * pairs_per_split, (s + 1) * pairs_per_split) in the order
// f * tiles + t; nv may be null (all rows valid).
int ce_fwd(const void* h, const void* w, const void* b, const void* t, const void* nv,
           void* ll, void* logz, void* part, int slots, int splits, int pairs_per_split,
           int blocks, int B, int K, int V, int F, void* stream) {
  const int smem = ce::item_smem_floats() * 4;
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
  void* args[] = {&hp, &wp, &bp, &tp, &nvp, &pp, &B, &K, &V, &F,
                  &splits, &pairs_per_split, &slots};
  err = cudaLaunchKernel(ce_fwd_kernel, dim3(blocks), dim3(THREADS), args,
                         static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ce::launch_fwd_combine(pp, nvp, static_cast<float*>(ll), static_cast<float*>(logz), B,
                               F, V, pairs_per_split, slots, 2, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* ce_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
