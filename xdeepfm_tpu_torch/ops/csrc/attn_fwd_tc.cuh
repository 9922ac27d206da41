// The small-attention forward of one head on Hopper: the routine that
// sa_fwd.cu (row 8), ab_fwd.cu (row 10, the attention of each layer and
// head of its block) and sa_ablate.cu (row 16: full, dots, soft) share.
// With s = q^T k (unscaled) over dh-major operands q, k, v [dh][S] of one
// pair and c = scale * log2(e):
//
//   m[i]     = max_j s[i, j]
//   e[i, j]  = 2^(s[i, j] c - m[i] c)     (= exp((s[i, j] - m[i]) scale))
//   inv_z[i] = 1 / sum_j e[i, j]
//   o[d, i]  = (sum_j v[d, j] e[i, j]) inv_z[i]
//
// Tiles.  A warp owns a tile of 16 MT queries (MT m16 tiles: two up to
// dh 8, else one) and walks the keys 8 at a time; a lane holds 2 MT
// queries, rows grp + 8 h of each m16 tile (grp = lane / 4), and keys tig
// and tig + 4 (tig = lane % 4) of every 8-key block, the tensor cores'
// m16n8k8 A-fragment positions: the quad of lanes tig 0-3 shares a row.  Its
// q columns sit in registers (dh a template parameter; q in device or
// shared memory, rows of any pitch), and k and v are staged in shared
// memory with keys tig and tig + 4 of a block side by side
// (attn::key_slot; ab_fwd.cu's projections write them so), so one 8-byte
// load (a broadcast over the lanes of one tig) feeds
// 4 MT score FMAs, and another 4 MT value FMAs.  The scores are fp32 FMAs
// summed over d from 0 (fmaf(q[d], k[d], s)), the order in which the
// backward (attn_bwd_tc.cuh) recomputes them.
//
// One pass.  Each lane keeps the exact running max of its keys' scores (lm)
// and takes e from a reference mc of its row that trails the row's running
// max times c by at most T, so every e is at most 2^T.  Where a row's lane
// max passes the reference (a warp vote; after the first block it is rare),
// every row of the warp moves its reference to the quad's running max and
// scales its sum and accumulators by 2^(old - new).  At the end m is the
// quad's max of the lanes' maxima, bit-equal to the row max of the scores,
// and inv_z = 1 / (sum 2^(mc - m c)).  A max sweep first would repeat every
// score's dh FMAs, about a third of the walk's work at dh 5.  Under
// "bf16" e is rounded as a product operand, so it must be taken from the
// final max, as the plain version rounds it: bf16 keeps a max sweep first,
// and its reference never moves.
//
// The value product is fp32 FMAs: each lane's partial sums over its keys in
// key order, then two fixed shuffles within the quad, as the row sums.  In
// 3xTF32 on the tensor cores it was slower at V2's train shape, and the
// tensor cores' fp32 accumulation, which truncates, biased each 8-key step
// of o toward zero: V2's attention values keep their sign along the keys, so
// delta = g . o carried the bias into every row, and the W_k gradient of
// V2's second attention layer, a sum over the batch that nearly cancels,
// missed the card test's tolerance (1.21e-6 against 1.00e-6,
// test_attention_model_gradients_through_kernels_match_plain[v2], an NVIDIA
// H100 80GB HBM3 at 700 W), with or without a max sweep first; with fp32
// FMAs it passes.  No atomics, no barrier after the staging: bit-equal from
// run to run.
//
// Keys past S are zero in the stage and their e is set to 0 by a select
// (never multiplied: an exp of a masked score could overflow) in the last,
// ragged block of 8 only; queries past S are computed on zero q and not
// written.
//
// dots (sa_ablate.cu) runs the same tiles without the softmax: s straight
// into the value FMAs.  soft (attn_fwd_soft) runs them on the outer product
// of q's and k's row 0, with a max sweep first: its column sums add e over
// rows, which a per-row rescale could not reach.
#pragma once

#include <stdint.h>

#include <cfloat>

#include "attn_common.cuh"

namespace attn_fwd {

constexpr int MAX_WARPS = 16;
// Registers a thread, the kernels' __maxnreg__: at 80 three blocks of 8
// warps share an SM (V2's S 256) and two of 9 (the ablation's S 266), with
// the walk not unrolled.  Unrolled by two it took 100-107, which leave room
// for 16 warps an SM: one block of 9 warps.
constexpr int MAX_REGS = 80;
// e = 2^(s c - mc) with mc at most T below the row's running max times c
constexpr float T = 8.f;

// m16 tiles of queries a warp takes at once: two up to dh 8 (a lane holds
// 4 dh q values), one above
__host__ __device__ constexpr int m_tiles(int dh) { return dh <= 8 ? 2 : 1; }

__host__ __device__ inline int query_tiles(int dh, int S) {
  const int qt = 16 * m_tiles(dh);
  return (S + qt - 1) / qt;
}

// warps of a block: one a query tile, at most MAX_WARPS, which then walk
// the tiles in strides of the block's warps
__host__ __device__ inline int warps_for(int dh, int S) {
  const int n = query_tiles(dh, S);
  return n < MAX_WARPS ? n : MAX_WARPS;
}

// the staged rows' pitch in keys: S rounded up to a multiple of 8
__host__ __device__ inline int key_pitch(int S) { return (S + 7) / 8 * 8; }

// shared floats of the stage: k and v [dh][KP] each
__host__ __device__ inline int stage_floats(int dh, int S) { return 2 * dh * key_pitch(S); }

// Rows 0..DH-1 of k into ks [DH][KP] and, if V, of v into vs, zero past S,
// by every thread of the block (the caller adds the barrier).  Key
// j = 8 b + r of block b sits at slot 8 b + 2 (r % 4) + r / 4: a lane's keys
// tig and tig + 4 are the 8-byte word at 8 b + 2 tig.
template <int DH, bool BF16, bool V>
__device__ __forceinline__ void stage(const float* __restrict__ k, const float* __restrict__ v,
                                      int S, float* ks, float* vs) {
  const int KP = key_pitch(S);
  for (int e = threadIdx.x; e < DH * KP; e += blockDim.x) {
    const int d = e / KP, j = e - d * KP;
    const int slot = d * KP + attn::key_slot(j);
    const bool in = j < S;
    const float kx = in ? __ldg(k + d * S + j) : 0.f;
    ks[slot] = BF16 ? attn::operand(kx, 1) : kx;
    if (V) {
      const float vx = in ? __ldg(v + d * S + j) : 0.f;
      vs[slot] = BF16 ? attn::operand(vx, 1) : vx;
    }
  }
}

// Where the routine reads q[d][i]: one pair's [DH][S] in device memory,
// through the read-only cache (sa_fwd.cu, sa_ablate.cu) ...
struct DeviceQ {
  const float* __restrict__ q;
  int S;
  __device__ __forceinline__ float operator()(int d, int i) const { return __ldg(q + d * S + i); }
};
// ... or [DH] rows of pitch P in shared memory, a plain load: ab_fwd.cu
// writes each tile's o over its q
struct SharedQ {
  const float* q;
  int P;
  __device__ __forceinline__ float operator()(int d, int i) const { return q[d * P + i]; }
};

// the lane's q columns: qf[mt][h] is query q0 + 16 mt + 8 h + grp, zero past S
template <int DH, int MT, bool BF16, class Q>
__device__ __forceinline__ void load_q(const Q& q, int S, int q0, int grp,
                                       float (&qf)[MT][2][DH]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = q0 + 16 * mt + 8 * h + grp;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        const float x = i < S ? q(d, i) : 0.f;
        qf[mt][h][d] = BF16 ? attn::operand(x, 1) : x;
      }
    }
  }
}

// s[mt][h][u]: the score of query (mt, h) and key 8 b + tig + 4 u, where
// col = 8 b + 2 tig; fp32 FMAs over d from 0
template <int DH, int MT>
__device__ __forceinline__ void scores(const float (&qf)[MT][2][DH], const float* ks, int KP,
                                       int col, float (&s)[MT][2][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) s[mt][h][0] = s[mt][h][1] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    const float2 k2 = *reinterpret_cast<const float2*>(ks + d * KP + col);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[mt][h][0] = fmaf(qf[mt][h][d], k2.x, s[mt][h][0]);
        s[mt][h][1] = fmaf(qf[mt][h][d], k2.y, s[mt][h][1]);
      }
    }
  }
}

// the running max over block b's keys (EDGE: the ragged last block, keys
// past S skipped)
template <int MT, bool EDGE>
__device__ __forceinline__ void max_keys(const float (&s)[MT][2][2], int S, int b, int tig,
                                         float (&mx)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (!EDGE || 8 * b + tig + 4 * u < S) mx[mt][h] = fmaxf(mx[mt][h], s[mt][h][u]);
      }
    }
  }
}

// x's max and sum over the quad (two fixed shuffles): the same in its four
// lanes, bit for bit
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// m of the lane's rows by a sweep of every key, the same in a quad's lanes
template <int DH, int MT>
__device__ __forceinline__ void row_max(const float (&qf)[MT][2][DH], const float* ks, int KP,
                                        int S, int tig, float (&mx)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mx[mt][0] = mx[mt][1] = -FLT_MAX;
  const int nfull = S / 8;
  float s[MT][2][2];
#pragma unroll 1
  for (int b = 0; b < nfull; ++b) {
    scores<DH, MT>(qf, ks, KP, 8 * b + 2 * tig, s);
    max_keys<MT, false>(s, S, b, tig, mx);
  }
  if (8 * nfull < S) {
    scores<DH, MT>(qf, ks, KP, 8 * nfull + 2 * tig, s);
    max_keys<MT, true>(s, S, nfull, tig, mx);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[mt][h] = quad_max(mx[mt][h]);
  }
}

// 2^x for a rescale of the row sums (x <= 0, a difference of references):
// 2^n e^f with n = rint(x) and f = (x - n) ln 2, |f| <= 0.35, by e^f's
// Taylor series to degree 8 (below 2^-26), within about an ulp; ex2.approx's
// 2^-22 would move inv_z off the backward's e as far as o's own rounding.
__device__ __forceinline__ float exp2_fine(float x) {
  if (x < -126.f) return 0.f;
  const float n = rintf(x), f = (x - n) * 0.6931471805599453f;
  float p = 1.f / 40320.f;
  p = fmaf(p, f, 1.f / 5040.f);
  p = fmaf(p, f, 1.f / 720.f);
  p = fmaf(p, f, 1.f / 120.f);
  p = fmaf(p, f, 1.f / 24.f);
  p = fmaf(p, f, 1.f / 6.f);
  p = fmaf(p, f, 0.5f);
  p = fmaf(p, f, 1.f);
  p = fmaf(p, f, 1.f);
  return ldexpf(p, static_cast<int>(n));
}

// The rows' reference moves to the quad's running max: every row of the
// warp, its sum and its accumulators scaled by 2^(old mc - new mc) (0 at
// the first block).  tc = T / c.
template <int DH, int MT>
__device__ __forceinline__ void rebase(float c, float tc, const float (&lm)[MT][2],
                                       float (&mc)[MT][2], float (&thr)[MT][2],
                                       float (&sum)[MT][2], float (&acc)[MT][2][DH]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float r = quad_max(lm[mt][h]), mcn = r * c, a = exp2_fine(mc[mt][h] - mcn);
      mc[mt][h] = mcn;
      thr[mt][h] = r + tc;
      sum[mt][h] *= a;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[mt][h][d] *= a;
    }
  }
}

// One 8-key block of the walk: the scores; under SOFTMAX each lane's running
// max of its keys (lm), the rebase where a row's passes its threshold (a
// warp-uniform branch), the exps, summed into the row sums; then the value
// FMAs of the lane's keys into acc[mt][h][d], key tig before tig + 4.
template <int DH, int MT, bool BF16, bool SOFTMAX, bool EDGE>
__device__ __forceinline__ void value_step(const float (&qf)[MT][2][DH], const float* ks,
                                           const float* vs, int KP, int S, int b, int tig,
                                           float c, float tc, float (&lm)[MT][2],
                                           float (&mc)[MT][2], float (&thr)[MT][2],
                                           float (&sum)[MT][2], float (&acc)[MT][2][DH]) {
  float s[MT][2][2];
  scores<DH, MT>(qf, ks, KP, 8 * b + 2 * tig, s);
  if (SOFTMAX) {
    max_keys<MT, EDGE>(s, S, b, tig, lm);
    bool over = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) over |= (lm[mt][0] > thr[mt][0]) | (lm[mt][1] > thr[mt][1]);
    if (__any_sync(0xffffffffu, over)) rebase<DH, MT>(c, tc, lm, mc, thr, sum, acc);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float e = attn_tc::ex2(fmaf(s[mt][h][u], c, -mc[mt][h]));
          if (EDGE && 8 * b + tig + 4 * u >= S) e = 0.f;
          sum[mt][h] += e;
          s[mt][h][u] = BF16 ? attn::operand(e, 1) : e;
        }
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    const float2 v2 = *reinterpret_cast<const float2*>(vs + d * KP + 8 * b + 2 * tig);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[mt][h][d] = fmaf(s[mt][h][0], v2.x, acc[mt][h][d]);
        acc[mt][h][d] = fmaf(s[mt][h][1], v2.y, acc[mt][h][d]);
      }
    }
  }
}

// The forward of one head over the stage (ks, vs in stage()'s order; q
// through a DeviceQ or SharedQ).  SOFTMAX: o, m and inv_z as above, through out.o(d, i, x),
// out.max(i, m) and out.inv(i, inv_z); else dots: o[d, i] =
// sum_j v[d, j] s[i, j] through out.o.  Every warp of the block calls it,
// with the block's warps from warps_for(DH, S).
template <int DH, bool BF16, bool SOFTMAX, class Q, class Out>
__device__ void attn_fwd_head(Q q, const float* ks, const float* vs, int S, float scale,
                              Out out) {
  constexpr int MT = m_tiles(DH);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = static_cast<int>(blockDim.x) / 32;
  const int grp = lane / 4, tig = lane % 4;
  const int KP = key_pitch(S), nfull = S / 8, n_tiles = query_tiles(DH, S);
  const float c = scale * 1.4426950408889634f;  // as attn_bwd_tc.cuh's
  const float tc = T / c;
  for (int tile = warp; tile < n_tiles; tile += nw) {
    const int q0 = 16 * MT * tile;
    float qf[MT][2][DH];
    load_q<DH, MT, BF16>(q, S, q0, grp, qf);
    // fp32: the first block rebases every row (thr below any score, the old
    // reference's scale 0).  bf16: the exact max first, a fixed reference.
    float lm[MT][2], mc[MT][2], thr[MT][2], sum[MT][2], acc[MT][2][DH];
    if (SOFTMAX && BF16) row_max<DH, MT>(qf, ks, KP, S, tig, lm);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!(SOFTMAX && BF16)) lm[mt][h] = -FLT_MAX;
        mc[mt][h] = SOFTMAX && BF16 ? lm[mt][h] * c : -FLT_MAX;
        thr[mt][h] = SOFTMAX && BF16 ? FLT_MAX : -FLT_MAX;
        sum[mt][h] = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[mt][h][d] = 0.f;
      }
    }
#pragma unroll 1
    for (int b = 0; b < nfull; ++b)
      value_step<DH, MT, BF16, SOFTMAX, false>(qf, ks, vs, KP, S, b, tig, c, tc, lm, mc, thr,
                                               sum, acc);
    if (8 * nfull < S)
      value_step<DH, MT, BF16, SOFTMAX, true>(qf, ks, vs, KP, S, nfull, tig, c, tc, lm, mc, thr,
                                              sum, acc);
    // per row: m, the sum over the quad, inv_z of that sum moved from the
    // reference to m, and o, each lane writing the d with d % 4 = tig
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = q0 + 16 * mt + grp + 8 * h;
        float inv = 1.f;
        if (SOFTMAX) {
          const float m = quad_max(lm[mt][h]), z = quad_sum(sum[mt][h]);
          inv = 1.f / z;
          if (tig == 2 * mt + h && i < S) {
            out.max(i, m);
            out.inv(i, 1.f / (z * exp2_fine(mc[mt][h] - m * c)));
          }
        }
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          const float x = quad_sum(acc[mt][h][d]);
          if (d % 4 == tig && i < S) out.o(d, i, x * inv);
        }
      }
    }
  }
}

// soft's shared floats beside its stage of k's row 0 [KP]: the warps'
// column sums [warps][KP] and the row sums [S]
__host__ __device__ inline int soft_floats(int S) {
  return key_pitch(S) * (1 + warps_for(1, S)) + S;
}

// One 8-key block of soft: exps of the outer product, row sums, and the
// block's column sums over the warp's rows into its row of colp.
template <bool EDGE>
__device__ __forceinline__ void soft_step(const float (&qf)[2][2][1], const float* ks, int KP,
                                          int S, int b, int grp, int tig, int q0, float c,
                                          const float (&mc)[2][2], float (&sum)[2][2],
                                          float* colp, bool first) {
  float s[2][2][2];
  scores<1, 2>(qf, ks, KP, 8 * b + 2 * tig, s);
  float cs[2] = {0.f, 0.f};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float e = attn_tc::ex2(fmaf(s[mt][h][u], c, -mc[mt][h]));
        if (EDGE && (8 * b + tig + 4 * u >= S || q0 + 16 * mt + 8 * h + grp >= S)) e = 0.f;
        sum[mt][h] += e;
        cs[u] += e;
      }
    }
  }
  // the block's column sums over the warp's 32 rows: lanes of one tig, in a
  // fixed butterfly (every lane ends with the same sum)
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int off = 4; off < 32; off *= 2) cs[u] += __shfl_xor_sync(0xffffffffu, cs[u], off);
    if (grp == 0) {
      float* p = colp + 8 * b + tig + 4 * u;
      *p = first ? cs[u] : *p + cs[u];
    }
  }
}

// soft: s[i, j] = q[0, i] k[0, j]; m, e and the row sums z as above; then
// o[d, x] = (1 / z[x]) sum_i e[i, x] for every d < DH.  ks: k's row 0 as
// stage<1, false, false> leaves it; scratch: soft_floats(S) - KP floats.
// Each warp adds its column sums into its own row of scratch (the lanes of
// quad 0, in tile order) and writes its rows' z; after one barrier the block
// adds the warps' rows in warp order.  No atomics: bit-equal from run to run.
template <int DH>
__device__ void attn_fwd_soft(const float* __restrict__ q, const float* ks, int S, float scale,
                              float* scratch, float* o) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = static_cast<int>(blockDim.x) / 32;
  const int grp = lane / 4, tig = lane % 4;
  const int KP = key_pitch(S), nfull = S / 8, n_tiles = query_tiles(1, S);
  const float c = scale * 1.4426950408889634f;
  float* colp = scratch + warp * KP;  // this warp's column sums
  float* zrow = scratch + nw * KP;    // [S]
  for (int tile = warp; tile < n_tiles; tile += nw) {
    const int q0 = 32 * tile;
    const bool first = tile == warp;
    float qf[2][2][1], mx[2][2], mc[2][2], sum[2][2];
    load_q<1, 2, false>(DeviceQ{q, S}, S, q0, grp, qf);
    row_max<1, 2>(qf, ks, KP, S, tig, mx);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mc[mt][h] = mx[mt][h] * c;
        sum[mt][h] = 0.f;
      }
    }
    // rows past S are masked in the tile's every block, keys past S in the last
    if (q0 + 32 <= S) {
#pragma unroll 1
      for (int b = 0; b < nfull; ++b)
        soft_step<false>(qf, ks, KP, S, b, grp, tig, q0, c, mc, sum, colp, first);
    } else {
#pragma unroll 1
      for (int b = 0; b < nfull; ++b)
        soft_step<true>(qf, ks, KP, S, b, grp, tig, q0, c, mc, sum, colp, first);
    }
    if (8 * nfull < S) soft_step<true>(qf, ks, KP, S, nfull, grp, tig, q0, c, mc, sum, colp, first);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float z = quad_sum(sum[mt][h]);
        const int i = q0 + 16 * mt + 8 * h + grp;
        if (tig == 2 * mt + h && i < S) zrow[i] = z;
      }
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < S; x += blockDim.x) {
    float col = 0.f;
    for (int w = 0; w < nw; ++w) col += scratch[w * KP + x];
    const float out = (1.f / zrow[x]) * col;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d * S + x] = out;
  }
}

}  // namespace attn_fwd
