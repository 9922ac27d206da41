// Softmax cross-entropy of vocabulary-sized heads in the bf16 mode
// (ops/ce.py set_precision("bf16")), for Hopper (sm_90a), behind a plain C
// interface that ops/ce_cuda.py loads with ctypes.  The same function as
// ce_fwd.cu and ce_bwd.cu (their header comments give it), with every
// product taken on bf16 operands and summed in fp32, as the TPU kernels'
// bf16 dots did: S = bf16(h) bf16(W)^T + b, dh = bf16(dS) bf16(W),
// dW = bf16(dS)^T bf16(h); db sums dS in fp32.
//
// Replaces: xdeepfm_tpu/ops/ce_pallas.py _ce_fwd / _fwd_kernel and _ces_fwd
// / _fwd_kernel_stacked (ce_fwd_bf16), _ce_bwd / _bwd_kernel and _ces_bwd /
// _bwd_kernel_stacked (ce_bwd_bf16) under the module's default precision
// "bf16" (_dot, ce_pallas.py:128-135); ce_round_bf16 is their operands'
// cast to bf16, once a step instead of in every product.
//
// Bound: operations.  At the canonical Pro step (F = 26 heads, K = 64, V
// padded to 10112, nv = 1365 valid rows of B = 4096): the forward's product
// is 2*nv*K*V*F = 45.9 GFLOP, 0.046 ms at the bf16 tensor cores' 989
// TFLOP/s, and its nv*V*F = 359 M exps take 0.086 ms at the exp rate (the
// fp32 rate / 16, an H100 SXM at 700 W): the exps bound it.  The backward's
// least work is three such products, 137.8 GFLOP, 0.139 ms (its two
// kernels recompute the logits each, 4 products and two exp passes: 0.186
// and 0.171 ms).  W in bf16 (33.7 MB) and dW in fp32 (67.3 MB) take 0.030
// ms at 3.35 TB/s.
//
// Design:
//   * ce_round_bf16, one pass: h's valid rows and W rounded to bf16 (nearest
//     even) into tc_tf32.cuh's bf16 tiles (K-major core matrices of 8 rows
//     x 16 bytes; K zero-padded to KW, a multiple of 16; h's rows past
//     num_valid and W's past V zero), h as one tile of Bp rows and each
//     head's W as one of Vp, so any run of 8-aligned rows is one contiguous
//     block: one bulk copy.  The bias is copied to [F, Vp] fp32 with -inf
//     past V, so no kernel masks the vocabulary edge (exp(-inf) = 0).  The
//     forward runs it once; the autograd Function keeps its outputs for the
//     backward.
//   * ce_walk_kernel<KW, DH>: the forward (DH false) and the backward's dh
//     (DH true) walk the same logits.  Persistent blocks (one a SM) stride
//     over items (a 128-row tile of the valid rows, a split of the F * Vp /
//     128 (head, vocabulary tile) pairs).  A producer thread bulk-copies
//     (cp.async.bulk on mbarriers) the item's h tile into one of two
//     buffers and each pair's W tile with its bias through a ring of
//     stages; two consumer warpgroups, 64 rows each, take the logit tile
//     S = h W^T on wgmma m64n128k16 with both operands K-major from shared
//     memory.  The epilogue works on the accumulator fragments: the
//     forward keeps ce_fwd.cu's online logsumexp (running max and sum of
//     each row, a warp vote that skips the rescale, the target's logit, the
//     quad combined in a fixed order, one partial a split and head merged
//     in order by ce_fwd_combine); dh's dS = (exp(S - logz) - onehot) g is
//     rounded to bf16 in registers, where the accumulator's layout is
//     already the register A operand of the next product, dh += dS W, whose
//     B is the same W tile read MN-major (wgmma_bf16_mn): one bf16 copy of
//     each tile serves both products, and dS never goes to shared memory.
//   * ce_dw_kernel<KW>: a block owns a 128-column vocabulary tile of one
//     head (its W tile copied once) and walks the valid rows 64 at a time:
//     S^T = W h^T (wgmma m64n64k16, both operands K-major), dS^T in the
//     fragments, db in fp32 from them, then dW += dS^T h with dS^T from
//     registers and the same h tile read MN-major.  The producer warp also
//     stages each chunk's logz, g and targets.  Where heads x tiles fill
//     the card too thinly (one head) the rows are cut into slices whose
//     partials ce_sum_slices adds in order.
//   * Sums.  The tensor cores' fp32 sums truncate (tc_tf32.cuh), so a long
//     sum is cut: a pair's 128 columns (dh) or a chunk's 64 rows (dW) are
//     summed in the MMA accumulator from zero and then added to an fp32
//     total in a fixed order.  The logits sum K <= 64 products in one MMA
//     sum.  Every sum has a fixed order and no atomics: two runs are
//     bit-equal.
// Rows at or past num_valid give and take nothing: they are zero in the
// rounded h, their logz +inf and g 0 make their dS exactly 0 (no branch),
// and they are never written.  Everything else a CE kernel guarantees
// (ce_fwd.cu, ce_bwd.cu) holds here too.
//
// Measured (scripts/bench_ce_bf16.py, device ms from the profiler, an NVIDIA
// H100 80GB HBM3 at 700.00 W, the Pro step's 26 stacked heads at nv 1365):
// the forward's walk 0.285-0.290 and the rounding pass 0.032, against 1.352-
// 1.356 for the fp32 kernels' bf16 flag that this replaced (in the same
// calls); the backward's dW kernel 0.440-0.445 and dh walk 0.342-0.347
// against 2.41-2.43 and 2.74-2.75; errors against float64 0.48-1.39x the
// plain bf16 version's.  What the designs tried (diagnostic builds, not
// kept): a branch around each dS exp (rows past num_valid) took the dh walk
// to 0.94 ms and the dW kernel to 0.92; without the exps the walks take
// 0.197 (forward) and the dh walk 0.28, without the dh product 0.90 of the
// branchy 0.94, so the exp epilogues set the pace; issuing the next pair's
// or chunk's logits before the epilogue (two accumulator sets) ran slower
// (forward 0.307, dh 0.431, dW 0.438: the two consumer warpgroups already
// overlap each other's MMAs, and the dh walk spilled); dW chunks of 128 rows
// 0.59-0.60; 4 ring stages for the walk instead of 6 the same.

#include <cfloat>
#include <cmath>
#include <stdint.h>

#include "ce_tc.cuh"

namespace {

constexpr int WG = 128;          // threads of a warpgroup
constexpr int THREADS = 3 * WG;  // the producer warpgroup, then two consumers
constexpr int R = 64;            // rows (walk) or vocabulary columns (dW) of a consumer
constexpr int BM = 2 * R;        // rows of a walk item
constexpr int BN = 128;          // vocabulary columns of a pair
constexpr int STAGES = 6;        // the walk's ring of W tiles
constexpr int DW_R = 64;         // rows of a dW chunk
constexpr int DW_STAGES = 4;     // the dW kernel's ring of h chunks

// the walk's shared memory: two h tiles, the ring (W tile then bias), barriers
template <int KW>
struct WalkSmem {
  static constexpr int H_ELEMS = BM * KW;             // bf16 of an h tile
  static constexpr int W_BYTES = BN * KW * 2;          // a W tile
  static constexpr int STAGE_BYTES = W_BYTES + BN * 4;  // and its bias
  static constexpr int BAR_OFF = 2 * H_ELEMS * 2 + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 4) * 8;
};

// the dW kernel's: the W tile, the ring (h chunk, then logz, g, targets), barriers
template <int KW>
struct DwSmem {
  static constexpr int W_BYTES = BN * KW * 2;
  static constexpr int H_BYTES = DW_R * KW * 2;
  static constexpr int STAGE_BYTES = H_BYTES + 3 * DW_R * 4;
  static constexpr int BAR_OFF = W_BYTES + DW_STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 * DW_STAGES + 1) * 8;
};

// -------------------------------------------------------------- ce_round_bf16

// h [B, K] -> hb (Bp rows, zero at or past num_valid), W [F, V, K] -> wb (F
// tiles of Vp rows, zero past V), both bf16 tiles of KW columns (zero past
// K), and b [F, V] -> bp [F, Vp] (-inf past V).  A thread a 16-byte chunk of
// a tile (8 k of a row: tc::bf16_tile_chunk), or one bias.
__global__ void ce_round_bf16_kernel(const float* __restrict__ h, const float* __restrict__ w,
                                     const float* __restrict__ b, const int* __restrict__ nv_ptr,
                                     uint4* __restrict__ hb, uint4* __restrict__ wb,
                                     float* __restrict__ bp, int B, int K, int V, int F, int KW,
                                     int Bp, int Vp) {
  const int nv = ce::valid_rows(nv_ptr, B);
  const long long h_chunks = (long long)Bp * KW / 8, w_head = (long long)Vp * KW / 8;
  const long long w_chunks = F * w_head, total = h_chunks + w_chunks + (long long)F * Vp;
  const bool vec_h = (K & 3) == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  const bool vec_w = (K & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i >= h_chunks + w_chunks) {  // the bias
      const long long e = i - h_chunks - w_chunks;
      const int f = static_cast<int>(e / Vp), v = static_cast<int>(e % Vp);
      bp[e] = v < V ? __ldg(b + (long long)f * V + v) : -INFINITY;
      continue;
    }
    const bool is_h = i < h_chunks;
    const long long e = is_h ? i : i - h_chunks;
    const int f = is_h ? 0 : static_cast<int>(e / w_head);
    int r, k;
    tc::bf16_tile_chunk(16 * static_cast<int>(e - f * w_head), KW, r, k);
    const bool row_ok = is_h ? r < nv : r < V;
    const float* src = is_h ? h + (long long)r * K : w + ((long long)f * V + r) * K;
    float v[8];
    if (row_ok && k + 8 <= K && (is_h ? vec_h : vec_w)) {
      *reinterpret_cast<float4*>(v) = __ldg(reinterpret_cast<const float4*>(src + k));
      *reinterpret_cast<float4*>(v + 4) = __ldg(reinterpret_cast<const float4*>(src + k + 4));
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = row_ok && k + u < K ? __ldg(src + k + u) : 0.f;
    }
    const uint4 out = make_uint4(tc::bf16x2(v[0], v[1]), tc::bf16x2(v[2], v[3]),
                                 tc::bf16x2(v[4], v[5]), tc::bf16x2(v[6], v[7]));
    if (is_h) hb[e] = out;
    else wb[e] = out;
  }
}

// --------------------------------------------------------------- the walk

// A consumer thread's rows of a walk item: rows 16 warp + group and + 8 of
// its 64; the m64n128 accumulator d[4 j + q] is row `group + 8 (q / 2)`,
// column 8 j + 2 tig + q % 2 of the pair.

// The forward's statistics of a thread's two rows for the head `cur`:
// running max, sum of exp relative to it, the target's logit.
struct FwdRows {
  float m[2], sum[2], pk[2];
  int t[2];  // the rows' targets (-1 past num_valid)
  int cur = -1;

  __device__ __forceinline__ void start(int f, const long long* tgt, int B, const int (&row)[2],
                                        int nv) {
    cur = f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = -FLT_MAX;
      sum[i] = 0.f;
      pk[i] = 0.f;
      t[i] = row[i] < nv ? static_cast<int>(__ldg(tgt + (long long)f * B + row[i])) : -1;
    }
  }

  // one pair's logits (bias added in place)
  __device__ __forceinline__ void tile(float (&d)[BN / 2], const float* bias, int v0, int tig) {
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = d[4 * j + q] + bias[8 * j + 2 * tig + q % 2];
        d[4 * j + q] = x;
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
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) ss[q / 2] += __expf(d[4 * j + q] - m[q / 2]);
    sum[0] += ss[0];
    sum[1] += ss[1];
    // the target's logit, in the one lane that holds its column
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = t[i] - v0 - 2 * tig;
      if (static_cast<unsigned>(c) < static_cast<unsigned>(BN) && (c & 6) == 0) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (c == 8 * j + u) pk[i] = d[4 * j + 2 * i + u];
      }
    }
  }

  // the quad combined in a fixed order; lane tig 0 writes the rows' partial
  __device__ __forceinline__ void flush(float* part, long long plane, int slot, int F, int B,
                                        const int (&row)[2], int nv, int tig) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
        const float so = __shfl_xor_sync(0xffffffffu, sum[i], off);
        const float po = __shfl_xor_sync(0xffffffffu, pk[i], off);
        const float mn = fmaxf(m[i], mo);
        sum[i] = sum[i] * __expf(m[i] - mn) + so * __expf(mo - mn);
        m[i] = mn;
        pk[i] += po;
      }
    if (tig != 0) return;
    float* out = part + ((long long)slot * F + cur) * B;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= nv) continue;
      out[row[i]] = m[i];
      out[plane + row[i]] = sum[i];
      out[2 * plane + row[i]] = pk[i];
    }
  }
};

// Persistent blocks over items i = split * tiles + row tile (tiles =
// ceil(num_valid / 128)); split s walks pairs [s per, (s + 1) per) in the
// order f * n_vt + t.  DH false: part [3][slots][F][B] as ce_fwd_combine
// reads it (one slot a split that reaches a head).  DH true: dh_part
// [splits][B][K], the valid rows of each split.
template <int KW, bool DH>
__global__ void __launch_bounds__(THREADS, 1)
ce_walk_kernel(const uint16_t* __restrict__ hb, const uint16_t* __restrict__ wb,
               const float* __restrict__ bp, const long long* __restrict__ tgt,
               const float* __restrict__ logz, const float* __restrict__ g,
               const int* __restrict__ nv_ptr, float* __restrict__ out, int B, int K, int V,
               int F, int Vp, int splits, int per, int slots) {
  using S = WalkSmem<KW>;
  uint16_t* hbuf = reinterpret_cast<uint16_t*>(ce_smem);  // [2][BM * KW]
  unsigned char* ring = reinterpret_cast<unsigned char*>(hbuf + 2 * S::H_ELEMS);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(ce_smem) +
                                               S::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* hfull = empty + STAGES;
  uint64_t* hempty = hfull + 2;
  const int nv = ce::valid_rows(nv_ptr, B);
  const int n_vt = (V + BN - 1) / BN, pairs = F * n_vt;
  const int tiles = (nv + BM - 1) / BM, items = tiles * splits;
  const int wgi = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 2 * WG);
    }
    for (int b = 0; b < 2; ++b) {
      tc::mbar_init(&hfull[b], 1);
      tc::mbar_init(&hempty[b], 2 * WG);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {  // the producer: one thread copies the h tiles and the pairs' stages
    tc::regs_dec<40>();
    if (threadIdx.x != 0) return;
    int it = 0, hi = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const int rt = i % tiles, p0 = i / tiles * per, p1 = min(pairs, p0 + per);
      const int hbuf_i = hi % 2;
      tc::mbar_wait(&hempty[hbuf_i], ((hi / 2) & 1) ^ 1);
      tc::mbar_arrive_tx(&hfull[hbuf_i], S::H_ELEMS * 2);
      tc::bulk_copy(hbuf + hbuf_i * S::H_ELEMS, hb + (long long)rt * S::H_ELEMS, S::H_ELEMS * 2,
                    &hfull[hbuf_i]);
      ++hi;
      for (int p = p0; p < p1; ++p, ++it) {
        const int f = p / n_vt, v0 = (p - f * n_vt) * BN, sl = it % STAGES;
        unsigned char* st = ring + sl * S::STAGE_BYTES;
        tc::mbar_wait(&empty[sl], ((it / STAGES) & 1) ^ 1);
        tc::mbar_arrive_tx(&full[sl], S::STAGE_BYTES);
        tc::bulk_copy(st, wb + ((long long)f * Vp + v0) * KW, S::W_BYTES, &full[sl]);
        tc::bulk_copy(st + S::W_BYTES, bp + (long long)f * Vp + v0, BN * 4, &full[sl]);
      }
    }
    return;
  }

  tc::regs_inc<232>();
  const int c = wgi - 1, t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int group = lane / 4, tig = lane % 4;
  const uint32_t haddr = tc::smem_addr(hbuf), raddr = tc::smem_addr(ring);
  const long long plane = (long long)slots * F * B;
  int it = 0, hi = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int rt = i % tiles, split = i / tiles;
    const int p0 = split * per, p1 = min(pairs, p0 + per);
    const int rl = c * R + 16 * warp + group;  // this thread's first row of the item
    const int row[2] = {rt * BM + rl, rt * BM + rl + 8};
    const int hbuf_i = hi % 2;
    tc::mbar_wait(&hfull[hbuf_i], (hi / 2) & 1);
    ++hi;
    const uint32_t ha = haddr + hbuf_i * S::H_ELEMS * 2;

    FwdRows fs;
    float dht[KW / 2];  // dh [rows][KW]: the fp32 total of the pairs' sums
    int cur = -1, tr[2] = {-1, -1};
    float lz[2] = {INFINITY, INFINITY}, gr[2] = {0.f, 0.f};
    if constexpr (DH) {
#pragma unroll
      for (int e = 0; e < KW / 2; ++e) dht[e] = 0.f;
    }
    for (int p = p0; p < p1; ++p, ++it) {
      const int f = p / n_vt, v0 = (p - f * n_vt) * BN, sl = it % STAGES;
      const uint32_t wa = raddr + sl * S::STAGE_BYTES;
      const float* bias = reinterpret_cast<const float*>(ring + sl * S::STAGE_BYTES + S::W_BYTES);
      tc::mbar_wait(&full[sl], (it / STAGES) & 1);
      // S [64 rows][128 columns] = h W^T: K <= 64 products, one MMA sum
      float d[BN / 2];
      tc::wgmma_fence();
#pragma unroll
      for (int s = 0; s < KW / 16; ++s)
        tc::wgmma_bf16_ss<BN>(d, tc::bf16_tile_desc(ha, c * R, s, KW),
                              tc::bf16_tile_desc(wa, 0, s, KW), s);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(d);
      if constexpr (!DH) {
        if (f != fs.cur) {  // a new head: the last one's partials out, fresh statistics
          if (fs.cur >= 0)
            fs.flush(out, plane, split - ce::first_split(fs.cur, n_vt, per), F, B, row, nv, tig);
          fs.start(f, tgt, B, row, nv);
        }
        fs.tile(d, bias, v0, tig);
        tc::mbar_arrive(&empty[sl]);
      } else {
        if (f != cur) {  // a new head: its targets, logz and g of the rows
          cur = f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool ok = row[r] < nv;
            const long long at = (long long)f * B + row[r];
            tr[r] = ok ? static_cast<int>(__ldg(tgt + at)) : -1;
            lz[r] = ok ? __ldg(logz + at) : INFINITY;
            gr[r] = ok ? __ldg(g + at) : 0.f;
          }
        }
        // dS in the fragments, rounded to bf16 as the A operand of dh += dS W:
        // k16 step s's A is columns 16 s .. 16 s + 15, d[8 s .. 8 s + 7].
        // Rows past num_valid (logz +inf, g 0) give exactly 0 with no branch:
        // a branch around each exp made the kernel 2.7x slower
        uint32_t a[BN / 16][4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; q += 2) {
            const int r = q / 2, v = v0 + 8 * j + 2 * tig;
            float x[2];
#pragma unroll
            for (int u = 0; u < 2; ++u)
              x[u] = (__expf(d[4 * j + q + u] + bias[8 * j + 2 * tig + u] - lz[r]) -
                      (tr[r] == v + u ? 1.f : 0.f)) * gr[r];
            a[j / 2][(j % 2) * 2 + r] = tc::bf16x2(x[0], x[1]);
          }
        float dhp[KW / 2];  // this pair's 128 columns, one MMA sum
        tc::wgmma_fence();
#pragma unroll
        for (int s = 0; s < BN / 16; ++s)
          tc::wgmma_bf16_mn<KW>(dhp, a[s], tc::bf16_tile_desc_mn(wa, s, KW), s);
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_regs(dhp);
        tc::mbar_arrive(&empty[sl]);
#pragma unroll
        for (int e = 0; e < KW / 2; ++e) dht[e] += dhp[e];
      }
    }
    tc::mbar_arrive(&hempty[hbuf_i]);
    if constexpr (!DH) {
      if (fs.cur >= 0)
        fs.flush(out, plane, split - ce::first_split(fs.cur, n_vt, per), F, B, row, nv, tig);
    } else {
      float* dh = out + (long long)split * B * K;
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = row[q / 2], k = 8 * j + 2 * tig + q % 2;
          if (r < nv && k < K) dh[(long long)r * K + k] = dht[4 * j + q];
        }
    }
  }
}

// ---------------------------------------------------------------- ce_dw

// grid (vocabulary tiles, heads, row slices); dw [slices][F][V][K] and db
// [slices][F][V] (the outputs themselves when slices == 1).  Consumer c owns
// columns v0 + 64 c .. of the tile; a chunk's S^T [64 columns][64 rows]
// accumulator d[4 j + q] is column group + 8 (q / 2) of the warp's 16, row
// 8 j + 2 tig + q % 2 of the chunk.
template <int KW>
__global__ void __launch_bounds__(THREADS, 1)
ce_dw_kernel(const uint16_t* __restrict__ hb, const uint16_t* __restrict__ wb,
             const float* __restrict__ bp, const long long* __restrict__ tgt,
             const float* __restrict__ logz, const float* __restrict__ g,
             const int* __restrict__ nv_ptr, float* __restrict__ dw, float* __restrict__ db,
             int B, int K, int V, int F, int Vp, int rows_per_slice) {
  using S = DwSmem<KW>;
  unsigned char* base = reinterpret_cast<unsigned char*>(ce_smem);
  uint16_t* wt = reinterpret_cast<uint16_t*>(base);
  unsigned char* ring = base + S::W_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::BAR_OFF);
  uint64_t* empty = full + DW_STAGES;
  uint64_t* wfull = empty + DW_STAGES;
  const int v0 = blockIdx.x * BN, f = blockIdx.y, slice = blockIdx.z;
  const int nv = ce::valid_rows(nv_ptr, B);
  const int r_begin = slice * rows_per_slice, r_end = min(nv, r_begin + rows_per_slice);
  const int n_chunks = r_end > r_begin ? (r_end - r_begin + DW_R - 1) / DW_R : 0;
  const int wgi = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      tc::mbar_init(&full[s], 32);
      tc::mbar_init(&empty[s], 2 * WG);
    }
    tc::mbar_init(wfull, 1);
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {  // the producer warp: the W tile, then each chunk's h rows and row values
    tc::regs_dec<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      tc::mbar_arrive_tx(wfull, S::W_BYTES);
      tc::bulk_copy(wt, wb + ((long long)f * Vp + v0) * KW, S::W_BYTES, wfull);
    }
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int sl = ch % DW_STAGES, r0 = r_begin + ch * DW_R;
      unsigned char* st = ring + sl * S::STAGE_BYTES;
      tc::mbar_wait(&empty[sl], ((ch / DW_STAGES) & 1) ^ 1);
      float* rv = reinterpret_cast<float*>(st + S::H_BYTES);  // [3][DW_R]: logz, g, targets
      for (int e = lane; e < DW_R; e += 32) {
        const int r = r0 + e;
        const bool ok = r < r_end;
        const long long at = (long long)f * B + r;
        rv[e] = ok ? __ldg(logz + at) : INFINITY;  // dS exactly 0 there, no branch
        rv[DW_R + e] = ok ? __ldg(g + at) : 0.f;
        reinterpret_cast<int*>(rv)[2 * DW_R + e] = ok ? static_cast<int>(__ldg(tgt + at)) : -1;
      }
      if (lane == 0) {
        tc::mbar_arrive_tx(&full[sl], S::H_BYTES);
        tc::bulk_copy(st, hb + (long long)r0 * KW, S::H_BYTES, &full[sl]);
      } else {
        tc::mbar_arrive(&full[sl]);
      }
    }
    return;
  }

  tc::regs_inc<232>();
  const int c = wgi - 1, t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int group = lane / 4, tig = lane % 4;
  const int vl = c * R + 16 * warp + group;  // this thread's first column of the tile
  const int col[2] = {v0 + vl, v0 + vl + 8};
  float bias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) bias[i] = __ldg(bp + (long long)f * Vp + col[i]);
  const uint32_t waddr = tc::smem_addr(wt), raddr = tc::smem_addr(ring);
  float dwt[KW / 2];  // dW [columns][KW]: the fp32 total of the chunks' sums
#pragma unroll
  for (int e = 0; e < KW / 2; ++e) dwt[e] = 0.f;
  float dbp[2] = {0.f, 0.f};
  tc::mbar_wait(wfull, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int sl = ch % DW_STAGES;
    const uint32_t ha = raddr + sl * S::STAGE_BYTES;
    const float* rv = reinterpret_cast<const float*>(ring + sl * S::STAGE_BYTES + S::H_BYTES);
    const int* tt = reinterpret_cast<const int*>(rv + 2 * DW_R);
    tc::mbar_wait(&full[sl], (ch / DW_STAGES) & 1);
    float d[DW_R / 2];  // S^T = W h^T
    tc::wgmma_fence();
#pragma unroll
    for (int s = 0; s < KW / 16; ++s)
      tc::wgmma_bf16_ss<DW_R>(d, tc::bf16_tile_desc(waddr, c * R, s, KW),
                              tc::bf16_tile_desc(ha, 0, s, KW), s);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(d);
    // dS^T in the fragments, db from them in fp32, rounded to bf16 as the A
    // operand of dW += dS^T h: k16 step s is rows 16 s .. 16 s + 15.  Rows
    // past the slice (logz +inf, g 0) give exactly 0 with no branch
    uint32_t a[DW_R / 16][4];
    float dbc[2] = {0.f, 0.f};  // this chunk's, added to dbp once: a shorter sum
#pragma unroll
    for (int j = 0; j < DW_R / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int i = q / 2;
        float x[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = 8 * j + 2 * tig + u;
          x[u] = (__expf(d[4 * j + q + u] + bias[i] - rv[r]) - (tt[r] == col[i] ? 1.f : 0.f)) *
                 rv[DW_R + r];
          dbc[i] += x[u];
        }
        a[j / 2][(j % 2) * 2 + i] = tc::bf16x2(x[0], x[1]);
      }
    dbp[0] += dbc[0];
    dbp[1] += dbc[1];
    float dwp[KW / 2];  // this chunk's 64 rows, one MMA sum
    tc::wgmma_fence();
#pragma unroll
    for (int s = 0; s < DW_R / 16; ++s)
      tc::wgmma_bf16_mn<KW>(dwp, a[s], tc::bf16_tile_desc_mn(ha, s, KW), s);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dwp);
    tc::mbar_arrive(&empty[sl]);
#pragma unroll
    for (int e = 0; e < KW / 2; ++e) dwt[e] += dwp[e];
  }

  float* dw_s = dw + ((long long)slice * F + f) * V * K;
#pragma unroll
  for (int j = 0; j < KW / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = col[q / 2], k = 8 * j + 2 * tig + q % 2;
      if (v < V && k < K) dw_s[(long long)v * K + k] = dwt[4 * j + q];
    }
  // db: the four lanes of a quad hold one column's row sums; add in order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dbp[i] += __shfl_xor_sync(0xffffffffu, dbp[i], 1);
    dbp[i] += __shfl_xor_sync(0xffffffffu, dbp[i], 2);
    if (tig == 0 && col[i] < V) db[((long long)slice * F + f) * V + col[i]] = dbp[i];
  }
}

template <class Kern>
cudaError_t launch(Kern kern, dim3 grid, int smem, void** args, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernel(kern, grid, dim3(THREADS), args, static_cast<size_t>(smem), st);
}

template <int KW>
cudaError_t fwd(const void* hb, const void* wb, const void* bp, const void* t, const void* nv,
                void* part, int slots, int splits, int per, int blocks, int B, int K, int V,
                int F, int Vp, cudaStream_t st) {
  const float* none = nullptr;
  void* args[] = {const_cast<void**>(&hb), const_cast<void**>(&wb), const_cast<void**>(&bp),
                  const_cast<void**>(&t), &none, &none, const_cast<void**>(&nv), &part,
                  &B, &K, &V, &F, &Vp, &splits, &per, &slots};
  return launch(ce_walk_kernel<KW, false>, dim3(blocks), WalkSmem<KW>::BYTES, args, st);
}

template <int KW>
cudaError_t bwd(const void* hb, const void* wb, const void* bp, const void* t, const void* lz,
                const void* g, const void* nv, void* dh_part, int splits, int per, int blocks,
                void* dwo, void* dbo, int slices, int rows, int B, int K, int V, int F, int Vp,
                cudaStream_t st) {
  void* dw_args[] = {const_cast<void**>(&hb), const_cast<void**>(&wb), const_cast<void**>(&bp),
                     const_cast<void**>(&t), const_cast<void**>(&lz), const_cast<void**>(&g),
                     const_cast<void**>(&nv), &dwo, &dbo, &B, &K, &V, &F, &Vp, &rows};
  cudaError_t err = launch(ce_dw_kernel<KW>, dim3(Vp / BN, F, slices), DwSmem<KW>::BYTES,
                           dw_args, st);
  if (err != cudaSuccess) return err;
  int slots = 0;
  void* dh_args[] = {const_cast<void**>(&hb), const_cast<void**>(&wb), const_cast<void**>(&bp),
                     const_cast<void**>(&t), const_cast<void**>(&lz), const_cast<void**>(&g),
                     const_cast<void**>(&nv), &dh_part, &B, &K, &V, &F, &Vp, &splits, &per,
                     &slots};
  return launch(ce_walk_kernel<KW, true>, dim3(blocks), WalkSmem<KW>::BYTES, dh_args, st);
}

}  // namespace

extern "C" {

// Each launcher runs on `stream` and returns the first CUDA error (0 on
// success).  The caller has checked dtypes, shapes, contiguity, 1 <= K <= 64
// and 32-bit element offsets, and allocated every output: KW = K rounded up
// to 16, Bp = B rounded up to 128, Vp = V rounded up to 128; nv may be null
// (all rows valid).

// hb [Bp * KW] and wb [F * Vp * KW] bf16 tiles, bp [F, Vp] fp32
int ce_round_bf16(const void* h, const void* w, const void* b, const void* nv, void* hb,
                  void* wb, void* bp, int B, int K, int V, int F, int KW, int Bp, int Vp,
                  void* stream) {
  const float* hp = static_cast<const float*>(h);
  const float* wp = static_cast<const float*>(w);
  const float* bpp = static_cast<const float*>(b);
  const int* nvp = static_cast<const int*>(nv);
  uint4* hbo = static_cast<uint4*>(hb);
  uint4* wbo = static_cast<uint4*>(wb);
  float* bpo = static_cast<float*>(bp);
  void* args[] = {&hp, &wp, &bpp, &nvp, &hbo, &wbo, &bpo, &B, &K, &V, &F, &KW, &Bp, &Vp};
  const long long total = (long long)Bp * KW / 8 + (long long)F * Vp * (KW / 8 + 1);
  const long long blocks = (total + 255) / 256;
  cudaError_t err = cudaLaunchKernel(ce_round_bf16_kernel,
                                     dim3(static_cast<unsigned>(blocks < 4096 ? blocks : 4096)),
                                     dim3(256), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ll, logz [F, B] through the partials part [3, slots, F, B]: `blocks`
// persistent blocks over (valid 128-row tile, split) items, split s walking
// the (head, vocabulary tile) pairs [s * per, (s + 1) * per) in the order
// f * tiles + t; slots at least the most splits that reach one head
int ce_fwd_bf16(const void* hb, const void* wb, const void* bp, const void* t, const void* nv,
                void* ll, void* logz, void* part, int slots, int splits, int per, int blocks,
                int B, int K, int V, int F, int KW, int Vp, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto run = KW == 16 ? fwd<16> : KW == 32 ? fwd<32> : KW == 48 ? fwd<48> : fwd<64>;
  if (KW % 16 != 0 || KW < 16 || KW > 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = run(hb, wb, bp, t, nv, part, slots, splits, per, blocks, B, K, V, F, Vp, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ce::launch_fwd_combine(static_cast<const float*>(part), static_cast<const int*>(nv),
                               static_cast<float*>(ll), static_cast<float*>(logz), B, F, V, per,
                               slots, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// dh [B, K] through dh_part [splits, B, K] (the walk's items, as the
// forward's), dw [F, V, K] and db [F, V], through dw_part [slices, F, V, K]
// and db_part [slices, F, V] where slices > 1; slice s walks rows
// [s * rows_per_slice, ...), a multiple of 128
int ce_bwd_bf16(const void* hb, const void* wb, const void* bp, const void* t, const void* logz,
                const void* g, const void* nv, void* dh, void* dh_part, int splits, int per,
                int blocks, void* dw, void* db, void* dw_part, void* db_part, int slices,
                int rows_per_slice, int B, int K, int V, int F, int KW, int Vp, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  void* dwo = slices > 1 ? dw_part : dw;
  void* dbo = slices > 1 ? db_part : db;
  const auto run = KW == 16 ? bwd<16> : KW == 32 ? bwd<32> : KW == 48 ? bwd<48> : bwd<64>;
  if (KW % 16 != 0 || KW < 16 || KW > 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = run(hb, wb, bp, t, logz, g, nv, dh_part, splits, per, blocks, dwo, dbo,
                        slices, rows_per_slice, B, K, V, F, Vp, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ce::launch_dh_sum(static_cast<const float*>(dh_part), splits, static_cast<const int*>(nv),
                          B, K, static_cast<float*>(dh), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slices > 1) {
    err = ce::sum_slices(static_cast<const float*>(dwo), slices, (long long)F * V * K,
                         static_cast<float*>(dw), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = ce::sum_slices(static_cast<const float*>(dbo), slices, (long long)F * V,
                         static_cast<float*>(db), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ce_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
