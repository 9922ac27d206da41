// The attention backward of one head on the tensor cores, in 3xTF32: the
// routine that sa_bwd.cu (a block per pair) and ab_bwd.cu (a block per batch
// row, a call per head) share.  With s = q^T k (unscaled), the forward's row
// max m and inverse normaliser inv_z, delta[i] = sum_d g[d, i] o[d, i]:
//
//   e[i, j]  = exp((s[i, j] - m[i]) * scale)
//   dp[i, j] = sum_d g[d, i] v[d, j]
//   ds[i, j] = (dp[i, j] - delta[i]) * inv_z[i] * scale * e[i, j]
//   dq[d, i] = sum_j k[d, j] ds[i, j]     dk[d, j] = sum_i q[d, i] ds[i, j]
//   dv[d, j] = sum_i g[d, i] inv_z[i] e[i, j]
//
// Design.  Each warp owns a tile of 16 keys and walks the queries 16 at a
// time (a chunk: two tiles of 8), holding the transposed tiles S^T and dP^T
// [16 keys][8 queries] in the m16n8k8 accumulator layout of tc_tf32.cuh, so
// that every (i, j) has its score and its exp computed once, by one lane.
// The scores and dp, sums over the head width alone, are fp32 FMAs in the
// forward's order (s is the forward's s bit for bit): as 3xTF32 products of
// that depth, whose tensor-core sums truncate, they failed the float64 gate
// at V2's train shape.  e and ds are split into TF32 halves in the fragments
// and fed straight back as A fragments: the accumulator read in the order
// (0, 2, 1, 3) is the A fragment of the next product when B's rows take the
// queries in the order (0, 4, 1, 5, 2, 6, 3, 7) (words 2 tig and 2 tig + 1 of
// lane tig), so dV += P^T (g inv_z) and dK += dS^T q run on the tensor cores
// in 3xTF32 and keep dK and dV in registers across the query walk.  Their B
// operands, the TF32 halves of g inv_z and q, and the row statistics are
// staged by the block once a step of `ch` chunks (double-buffered, filled
// during the previous step by the block's last warps).  dQ needs dS with
// queries as rows: two warp shuffles per 8 x 8 block move ds to that layout,
// the warp forms its partial dQ over its 16 keys on the tensor cores
// (A = dS, B = K^T) into a per-warp slot of shared memory, and after the
// step's one barrier a thread per (query, d) of the first warps adds the
// warps' partials in warp order, then to the earlier rounds' sum (where S has
// more key tiles than the block has warps).  No atomics: bit-equal from run
// to run.
//
// Every sum over S (queries for dK and dV, keys within a warp for dQ) is
// taken a k8 step at a time (summed from zero, added in fp32: mma3_add).
// Under "bf16" every product operand is rounded to bf16, which TF32 holds
// exactly: one MMA a product.  The TF32 split is integer rounding on the
// ALU pipes (cvt.rna.tf32.f32's bits) for the big half; the small half is
// the exact rest, whose low 13 bits the tensor cores ignore.  The exps are
// ex2.approx on the special-function units, as __expf.
//
// Operands, in shared memory: q, k, v, g as [dh][P] rows with P even and
// m, inv_z and delta as [S] rows.  The score loads are broadcasts, free of
// bank conflicts at any pitch; pitch() (P = 2 mod 4) also keeps up to 16
// rows read at one column in distinct banks, for the row walks of ab_bwd.cu's
// glue.  The score loads read the operands' rows up to column S rounded up
// to 16, past S only into what follows them in shared memory (the masked
// (i, j) are dropped by selects, never multiplied).
#pragma once

#include <stdint.h>

#include <cmath>

#include "attn_common.cuh"
#include "tc_tf32.cuh"

namespace attn_tc {

constexpr int QC = 16;  // queries a chunk (two tiles of 8): the rows of dQ's A fragment

// the operand rows' pitch: the least P >= S with P = 2 mod 4
__host__ __device__ inline int pitch(int S) { return S + (6 - S % 4) % 4; }
// A step is ch chunks between two barriers.  Its stage: the TF32 halves of
// g inv_z and q [4][dh][stage_pitch], then m * scale * log2(e), inv_z * scale
// and delta [3][QC ch]; the pitch QC ch + 8 (8 or 24 mod 32) keeps the
// 8-byte B loads free of bank conflicts.
__host__ __device__ inline int stage_pitch(int ch) { return QC * ch + 8; }
__host__ __device__ inline int stage_floats(int dh, int ch) {
  return 4 * dh * stage_pitch(ch) + 3 * QC * ch;
}
// the routine's shared scratch: nbuf stages and nbuf dQ partial slots
// [warps][QC ch][dh].  Two buffers take one barrier a step; one, where
// shared memory is short, three.
__host__ __device__ inline int scratch_floats(int dh, int warps, int nbuf, int ch) {
  return nbuf * (stage_floats(dh, ch) + warps * QC * ch * dh);
}

// x rounded to TF32 (nearest, ties away from zero: cvt.rna.tf32.f32's bits)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as TF32 halves: big rounded to nearest, small the exact rest, whose low
// 13 bits the tensor cores ignore; or x rounded to bf16 and a zero small
// half under "bf16"
template <bool BF16>
__device__ __forceinline__ void split_op(float x, uint32_t& big, uint32_t& small) {
  if (BF16) {
    big = __float_as_uint(attn::operand(x, 1));
    small = 0u;
  } else {
    big = tf32_bits(x);
    small = __float_as_uint(x - __uint_as_float(big));
  }
}

// acc += a * b over one k8 step in 3xTF32 (tc::mma3_add's sum), its three
// products formed independently, so that they can overlap, and added
// small terms first in fp32; one MMA under "bf16"
template <bool BF16>
__device__ __forceinline__ void mma3_add(float (&acc)[4], const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                         const uint32_t (&bs)[2]) {
  float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f}, d2[4] = {0.f, 0.f, 0.f, 0.f};
  tc::mma(d2, ab, bb);
  if (!BF16) {
    tc::mma(d0, as, bb);
    tc::mma(d1, ab, bs);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] += BF16 ? d2[r] : (d0[r] + d1[r]) + d2[r];
}

// Writes dq, dk and dv through out.at(0 = dq, 1 = dk, 2 = dv, d, column), a
// pointer to the entry; dq is read back there in rounds after the first.
// `scratch` holds scratch_floats(dh, warps of the block, nbuf, ch) floats,
// 8-byte aligned.  BF16: set_precision("bf16"), every product operand
// rounded to bf16 (one MMA a product).
template <int DH, bool BF16, class Store>
__device__ void attn_bwd_head(const float* q, const float* k, const float* v, const float* g,
                              const float* m, const float* z, const float* dl, int S, int P,
                              float scale, float* scratch, int nbuf, int ch, Store out) {
  constexpr int NT = (DH + 7) / 8;  // n8 tiles of d
  const int QS = QC * ch, QP = stage_pitch(ch), SF = stage_floats(DH, ch);  // a step
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nw = static_cast<int>(blockDim.x) / 32;
  const int grp = lane / 4, tig = lane % 4, odd = grp & 1;
  const int n_tiles = (S + 15) / 16;    // key tiles
  const int n_steps = (S + QS - 1) / QS;
  const float c = scale * 1.4426950408889634f;  // exp(x * scale) = 2^(x * c)
  float* stages = scratch;             // [nbuf][SF]
  float* slots = scratch + nbuf * SF;  // [nbuf][nw][QS][DH]
  // the dS transposition: lanes whose words hold (key 2 tig, query grp) and
  // (key 2 tig + 1, query grp) of an 8 x 8 block (see below)
  const int src_a = 4 * (2 * tig + odd) + grp / 2;
  const int src_b = 4 * (2 * tig + 1 - odd) + grp / 2;
  auto op = [](float x) { return BF16 ? attn::operand(x, 1) : x; };

  // step qs's stage, zero past S, by the block's last threads (the first
  // ones add the dQ partials: the work is spread over the warps)
  auto fill = [&](float* st, int qs) {
    const int i0 = qs * QS;
    for (int e = blockDim.x - 1 - tid; e < (DH + 1) * QS; e += blockDim.x) {
      const int d = e / QS, r = e - d * QS, i = i0 + r;
      const bool in = i < S;
      if (d < DH) {
        const float zi = in ? z[i] : 0.f;
        uint32_t* w = reinterpret_cast<uint32_t*>(st) + d * QP + r;
        split_op<BF16>(in ? g[d * P + i] * zi : 0.f, w[0], w[DH * QP]);
        split_op<BF16>(in ? q[d * P + i] : 0.f, w[2 * DH * QP], w[3 * DH * QP]);
      } else {
        st[4 * DH * QP + r] = in ? m[i] * c : 0.f;
        st[4 * DH * QP + QS + r] = in ? z[i] * scale : 0.f;
        st[4 * DH * QP + 2 * QS + r] = in ? dl[i] : 0.f;
      }
    }
  };

  fill(stages, 0);
  __syncthreads();
  int n = 0;  // steps walked: the parity of the stage and the slot
  const int n_all = ((n_tiles + nw - 1) / nw) * n_steps;
  for (int r0 = 0; r0 < n_tiles; r0 += nw) {  // a round: a key tile per warp
    const int kt = r0 + warp;
    const bool active = kt < n_tiles;
    const int n_active = min(nw, n_tiles - r0);
    const int j0 = kt * 16;
    // this key tile: k and v of keys j0 + grp and j0 + grp + 8 (the lane's
    // rows of S^T and dP^T, fp32 FMAs), and K^T as dQ's B fragment
    // (k = keys in the order 2 tig, 2 tig + 1; n = d); zero past S
    float kf[2][DH], vf[2][DH];
    uint32_t kbb[2][NT][2], kbs[2][NT][2];
    float dk[NT][4], dv[NT][4];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + grp + 8 * u;
        kf[u][d] = active && j < S ? op(k[d * P + j]) : 0.f;
        vf[u][d] = active && j < S ? op(v[d * P + j]) : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = 8 * t + grp;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = j0 + 8 * kk + 2 * tig + u;
          split_op<BF16>(active && d < DH && j < S ? k[d * P + j] : 0.f, kbb[kk][t][u],
                         kbs[kk][t][u]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dk[t][r] = 0.f;
        dv[t][r] = 0.f;
      }
    }

    for (int qs = 0; qs < n_steps; ++qs, ++n) {
      const int buf = nbuf == 2 ? n & 1 : 0;
      const float* st = stages + buf * SF;
      float* slot = slots + buf * nw * QS * DH;
      for (int sub = 0; active && sub < ch && qs * QS + sub * QC < S; ++sub) {
        const int i0 = qs * QS + sub * QC;  // the chunk's first query
        // dS in dQ's A layout: [key half kk][query tile h] -> (X, Y) words,
        // X at (query grp, key 2 tig), Y at (query grp, key 2 tig + 1)
        uint32_t xb[2][2][2], xs[2][2][2];
        const bool edge = j0 + 16 > S || i0 + QC > S;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ib = i0 + 8 * h, iq = ib + 2 * tig, lq = sub * QC + 8 * h + 2 * tig;
          // S^T and dP^T [16 keys][8 queries], fp32 FMAs in the forward's
          // order: word r is key j0 + grp + 8 (r / 2), query iq + r % 2.
          // Past S the operands are whatever the rows hold: e and ds are
          // masked below.
          float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            const float2 q2 = *reinterpret_cast<const float2*>(q + d * P + iq);
            const float2 g2 = *reinterpret_cast<const float2*>(g + d * P + iq);
            const float qx = op(q2.x), qy = op(q2.y), gx = op(g2.x), gy = op(g2.y);
            s[0] = fmaf(qx, kf[0][d], s[0]);
            s[1] = fmaf(qy, kf[0][d], s[1]);
            s[2] = fmaf(qx, kf[1][d], s[2]);
            s[3] = fmaf(qy, kf[1][d], s[3]);
            dp[0] = fmaf(gx, vf[0][d], dp[0]);
            dp[1] = fmaf(gy, vf[0][d], dp[1]);
            dp[2] = fmaf(gx, vf[1][d], dp[2]);
            dp[3] = fmaf(gy, vf[1][d], dp[3]);
          }
          const float* sv = st + 4 * DH * QP + lq;
          const float2 mc = *reinterpret_cast<const float2*>(sv);
          const float2 zsc = *reinterpret_cast<const float2*>(sv + QS);
          const float2 del = *reinterpret_cast<const float2*>(sv + 2 * QS);
          float e[4], ds[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            e[r] = ex2(fmaf(s[r], c, -(r % 2 ? mc.y : mc.x)));
            ds[r] = (dp[r] - (r % 2 ? del.y : del.x)) * (r % 2 ? zsc.y : zsc.x) * e[r];
          }
          if (edge) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              if (j0 + grp + 8 * (r / 2) >= S || iq + r % 2 >= S) {
                e[r] = 0.f;
                ds[r] = 0.f;
              }
            }
          }
          uint32_t pb[4], ps[4], sb[4], ss[4];  // A fragments of P^T and dS^T
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int a = (r & 1) * 2 + (r >> 1);  // word r is the A fragment's a[(0, 2, 1, 3)[r]]
            split_op<BF16>(e[r], pb[a], ps[a]);
            split_op<BF16>(ds[r], sb[a], ss[a]);
          }
          // dV += P^T (g inv_z), dK += dS^T q: B rows are the queries iq and
          // iq + 1, columns d, from the stage
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const int d = 8 * t + grp;
            uint32_t zb[2] = {0u, 0u}, zs[2] = {0u, 0u}, qb[2] = {0u, 0u}, qs[2] = {0u, 0u};
            if (d < DH) {
              const uint32_t* w = reinterpret_cast<const uint32_t*>(st) + d * QP + lq;
              const uint2 b0 = *reinterpret_cast<const uint2*>(w);
              const uint2 b1 = *reinterpret_cast<const uint2*>(w + DH * QP);
              const uint2 b2 = *reinterpret_cast<const uint2*>(w + 2 * DH * QP);
              const uint2 b3 = *reinterpret_cast<const uint2*>(w + 3 * DH * QP);
              zb[0] = b0.x; zb[1] = b0.y; zs[0] = b1.x; zs[1] = b1.y;
              qb[0] = b2.x; qb[1] = b2.y; qs[0] = b3.x; qs[1] = b3.y;
            }
            mma3_add<BF16>(dv[t], pb, ps, zb, zs);
            mma3_add<BF16>(dk[t], sb, ss, qb, qs);
          }
          // dS to queries as rows.  Block kk of this tile holds, in lane
          // (grp, tig), ds at (key 8 kk + grp, query 2 tig + w) in ds[2 kk + w].
          // Shuffle a reads lane (2 tig + odd, grp / 2), which offers its word
          // of parity `its grp`, shuffle b lane (2 tig + 1 - odd, grp / 2),
          // which offers the other one: an even lane gets X from a and Y from
          // b, an odd lane the reverse.  They are split after the move (one
          // word a value through the shuffles, not two).
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const float oa = odd ? ds[2 * kk + 1] : ds[2 * kk];
            const float ob = odd ? ds[2 * kk] : ds[2 * kk + 1];
            const float ra = __uint_as_float(__shfl_sync(0xffffffffu, __float_as_uint(oa), src_a));
            const float rb = __uint_as_float(__shfl_sync(0xffffffffu, __float_as_uint(ob), src_b));
            split_op<BF16>(odd ? rb : ra, xb[kk][h][0], xs[kk][h][0]);
            split_op<BF16>(odd ? ra : rb, xb[kk][h][1], xs[kk][h][1]);
          }
        }
        // this warp's dQ over its 16 keys: rows the chunk's queries (grp, grp + 8)
        float dq[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
#pragma unroll
          for (int r = 0; r < 4; ++r) dq[t][r] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t ab[4] = {xb[kk][0][0], xb[kk][1][0], xb[kk][0][1], xb[kk][1][1]};
          const uint32_t as[4] = {xs[kk][0][0], xs[kk][1][0], xs[kk][0][1], xs[kk][1][1]};
#pragma unroll
          for (int t = 0; t < NT; ++t) mma3_add<BF16>(dq[t], ab, as, kbb[kk][t], kbs[kk][t]);
        }
        float* mine = slot + (warp * QS + sub * QC) * DH;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int d = 8 * t + 2 * tig + r % 2;
            if (d < DH) mine[(grp + 8 * (r / 2)) * DH + d] = dq[t][r];
          }
        }
      }
      const int next = qs + 1 < n_steps ? qs + 1 : 0;
      if (nbuf == 2 && n + 1 < n_all) fill(stages + (buf ^ 1) * SF, next);
      __syncthreads();  // the step's partials (and the next stage) are in
      for (int o = tid; o < QS * DH; o += blockDim.x) {
        const int row = o / DH, d = o - row * DH, i = qs * QS + row;
        if (i < S) {
          float sum = 0.f;
#pragma unroll 8
          for (int w = 0; w < n_active; ++w) sum += slot[(w * QS + row) * DH + d];
          float* dq = out.at(0, d, i);
          *dq = r0 > 0 ? *dq + sum : sum;
        }
      }
      if (nbuf == 1 && n + 1 < n_all) {
        __syncthreads();  // the slot is read and the stage used
        fill(stages, next);
        __syncthreads();
      }
    }
    if (active) {
      // dK and dV: word r of tile t is key j0 + grp + 8 (r / 2), d = 8 t + 2 tig + r % 2
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = j0 + grp + 8 * (r / 2), d = 8 * t + 2 * tig + r % 2;
          if (j < S && d < DH) {
            *out.at(1, d, j) = dk[t][r];
            *out.at(2, d, j) = dv[t][r];
          }
        }
      }
    }
  }
  __syncthreads();  // every slot read and stage used before a next call
}

}  // namespace attn_tc
