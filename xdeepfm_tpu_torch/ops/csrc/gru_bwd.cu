// GRU / AGRU / AUGRU recurrence for DIEN, backward (gru_bwd), for Hopper
// (sm_90a), behind a plain C interface that ops/gru_cuda.py loads with
// ctypes.  For the cotangent g [B, T, H] of gru_fwd.cu's outs it walks
// t = T - 1 ... 0 (the TPU kernel's reverse sweep) with D = g[t] + dh; at a
// step before the row's length:
//
//   dn = D u, du = D (n - h_prev)
//   dz_pre = -du z (1 - z) (gru), du att z (1 - z) (augru), 0 (agru)
//   datt[t] = sum_H du (agru), sum_H du z (augru), 0 (gru)
//   dn_pre = dn (1 - n^2), dhn = dn_pre r, dr_pre = dn_pre hn r (1 - r)
//   dgi[t] = (dr_pre, dz_pre, dn_pre); d(W h + b) = (dr_pre, dz_pre, dhn)
//   dW_g += d_g h_prev^T, db_g += d_g, dh = D (1 - u) + sum_g W_g^T d_g
//
// and at a step at or past it dgi[t] = 0, datt[t] = 0 and dh = D.  It
// writes dh0 = dh after step 0.
//
// Replaces: xdeepfm_tpu/ops/gru_pallas.py _gs_bwd / _bwd_kernel.
//
// The history: the TPU kernel re-runs the forward into five [T, H] VMEM
// histories per sample.  Here h before step t is the forward's own output
// outs[t - 1] (h0 at t = 0), and r, z, n and W_n h + b_n are recomputed from
// it with the forward's arithmetic: no history is saved and no scratch is
// written.
//
// Bound: bytes.  At DIEN's train shape (B 4096, T 50, H 10, lengths uniform
// in 1..50) it reads gi, att and the h history at the valid steps and g at
// every step, and writes dgi, datt and dh0, ~50 MB, against ~0.2 GFLOP.
// As in the forward, one step's latency times the longest row's steps, and
// then the issue slots of the warps that share a scheduler, set the time.
// Design (gru_common.cuh's lanes and exchange rows): each warp walks its
// longest row only.  Above it the lanes carry dh += g[t] (loads independent
// of the chain) and store zeros, while the first chunk of the operands is
// in flight.  Below it the sample's operands are staged in a ring of two
// chunks of CHUNK steps in shared memory, a chunk ahead, by 16-byte
// cp.async (stage(): a handful of copies a lane a chunk, where loading
// each lane's own floats into registers took 6 loads a step and measured
// slower at DIEN's batches); the h rows (h_prev = outs[t - 1], h0 at t = 0)
// go a float a lane into rows of HP for broadcast loads.  A step recomputes
// the gates from its h row with the weight rows in registers, exchanges
// (dr_pre, dz_pre, dhn, the datt terms) through a double-buffered row, and
// sums dh = D (1 - u) + sum_g W_g^T d_g against the weight columns, also in
// registers (3 H rows, 3 H columns and 3 H dW accumulators a lane: 3 blocks
// of 4 warps an SM at H 10, one wave at DIEN's train batch).  dW and db:
// each lane accumulates its unit's rows over its sample's valid steps; the
// block sums its (warp, sample) partials in that order into one partial a
// block (gru_bwd_kernel), and gru_bwd_sum_kernel sums the partials in a
// fixed order.  No atomics: two calls give bit-equal results.

#include <cmath>

#include "gru_common.cuh"
#include "tc_tf32.cuh"  // tc::cp_async4, cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int WARPS = 4;      // warps a block: 4 x 3 samples share a dW / db partial at H 10
constexpr int CHUNK = 8;      // steps a staged chunk; a warp's ring holds two
constexpr int SUM_ROWS = 32;  // gru_bwd_sum_kernel: 32 entries x 32 partial rows a block

constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Whether `spw` samples at pitch p, each reading `width` consecutive words
// from its region's start (plus a common offset), touch distinct banks.
constexpr bool banks_apart(int p, int width, int spw) {
  unsigned used = 0;
  for (int s = 0; s < spw; ++s) {
    for (int i = 0; i < width; ++i) {
      const unsigned bit = 1u << ((s * p + i) % 32);
      if (used & bit) return false;
      used |= bit;
    }
  }
  return true;
}

// The pitch in floats of a per-sample region of `base` floats: the smallest
// multiple of `align` >= base at which the samples' windows of `width`
// words fall on distinct banks (base rounded up to `align` where none does).
constexpr int pitch(int base, int width, int spw, int align) {
  for (int p = round_up(base, align); p < round_up(base, align) + 32 * align; p += align) {
    if (banks_apart(p, width, spw)) return p;
  }
  return round_up(base, align);
}

// The floats by which p lies past a 16-byte boundary (0..3).
__device__ __forceinline__ int quad_offset(const float* p) {
  return static_cast<int>(reinterpret_cast<unsigned long long>(p) >> 2) & 3;
}

// Copies src[0..count), count <= CHUNK * WIDTH, by 16-byte cp.async into
// dst (16-byte aligned), lane i of a sample's H lanes taking the 16-byte
// words i, i + H, ...: the words that hold the run, from the one that holds
// src[0], so src[r] lands at dst[quad_offset(src) + r].  The first word may
// read up to 3 floats before src (in the same 16-byte word, hence the same
// allocation); the last reads only up to src[count - 1] and zero-fills the
// rest.  The words are unrolled to the most a lane can take, so each copy
// is one instruction with its offset in the instruction.
template <int H, int WIDTH>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int count,
                                      int i) {
  constexpr int WORDS = (CHUNK * WIDTH + 3 + 3) / 4;  // of a chunk, leading floats included
  const int off = quad_offset(src);
  const float* from = src - off + 4 * i;
  float* to = dst + 4 * i;
  const int left = off + count - 4 * i;  // floats from this lane's first word on
#pragma unroll
  for (int m = 0; m < (WORDS + H - 1) / H; ++m) {
    if (left > 4 * H * m) {
      tc::cp_async16(to + 4 * H * m, from + 4 * H * m, 4 * min(4, left - 4 * H * m));
    }
  }
}

// A warp's shared memory: the exchange rows [2][SPW][4][HP] (dr_pre,
// dz_pre, dhn, the datt terms) and the ring of two chunks, each h rows
// [SPW][HQ] (the steps' h_prev in rows of HP), gi [SPW][GP], g [SPW][GGP]
// and (agru, augru) att [SPW][AP] (gi, g and att from float quad_offset of
// their source on; each region at a pitch whose banks keep the warp's
// samples apart).  After the sweep the block's memory holds the (warp,
// sample) dW / db partials [WARPS][SPW][N].
template <int CELL, int H>
struct BwdSmem {
  using L = gru::Lanes<H, WARPS>;
  static constexpr int C = CHUNK, SPW = L::SPW, HP = L::HP;
  static constexpr bool HAS_ATT = CELL != gru::CELL_GRU;
  static constexpr int N = 3 * H * H + 3 * H;  // dW [3, H, H] then db [3, H]
  static constexpr int HQ = pitch(C * HP, 4, SPW, 4);
  static constexpr int GP = pitch(C * L::STEP + 3, H, SPW, 4);
  static constexpr int GGP = pitch(C * H + 3, H, SPW, 4);
  static constexpr int AP = pitch(C + 3, 1, SPW, 4);
  static constexpr int XCH = SPW * 4 * HP;
  static constexpr int STAGE = SPW * (HQ + GP + GGP + (HAS_ATT ? AP : 0));
  static constexpr int WARP = 2 * XCH + 2 * STAGE;
  static constexpr int SWEEP = WARPS * WARP;
  static constexpr int REDUCE = WARPS * SPW * N;
  static constexpr size_t BYTES = sizeof(float) * (SWEEP > REDUCE ? SWEEP : REDUCE);
};

template <int CELL, int H>
__global__ void __launch_bounds__(32 * WARPS, H <= 10 ? 3 : 2)
gru_bwd_kernel(const float* __restrict__ g, const float* __restrict__ gi,
               const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ att, const int* __restrict__ lengths,
               const float* __restrict__ h0, const float* __restrict__ outs,
               float* __restrict__ dgi, float* __restrict__ datt, float* __restrict__ dh0,
               float* __restrict__ part, int B, int T) {
  using L = gru::Lanes<H, WARPS>;
  using M = BwdSmem<CELL, H>;
  constexpr int C = CHUNK, SPW = L::SPW, HP = L::HP, STEP = L::STEP;
  constexpr bool HAS_Z = CELL != gru::CELL_AGRU;
  const L ln(B);
  const int i = ln.i, sw = ln.sw;
  float wr[H], wz[H], wn[H], br, bz, bn;
  gru::load_rows<H>(w, bias, i, ln.active, wr, wz, wn, br, bz, bn);
  float cr[H], cz[H], cn[H];  // column i of each gate's weights: w[g][j][i]
  float dwr[H], dwz[H], dwn[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    cr[j] = ln.active ? w[(0 * H + j) * H + i] : 0.f;
    cz[j] = ln.active ? w[(1 * H + j) * H + i] : 0.f;
    cn[j] = ln.active ? w[(2 * H + j) * H + i] : 0.f;
    dwr[j] = dwz[j] = dwn[j] = 0.f;
  }
  float dbr = 0.f, dbz = 0.f, dbn = 0.f;
  int longest;
  const int len = gru::row_length(lengths, ln.s, ln.live, T, longest);
  const long long row0 = ln.s * T;  // the sample's first (sample, step) row
  const float* gi_s = gi + row0 * STEP;
  const float* g_s = g + row0 * H;
  const float* att_s = att + (M::HAS_ATT ? row0 : 0);

  float* xch = gru_smem + ln.warp * M::WARP;
  float* ring = xch + 2 * M::XCH;
  // chunk k holds steps t0 .. th, th = longest - 1 - k C, t0 = max(th - C + 1, 0)
  auto issue = [&](int k) {
    const int th = longest - 1 - k * C, t0 = max(th - C + 1, 0);
    float* st = ring + (k & 1) * M::STAGE;
    if (ln.live && th >= 0) {
      const int nv = min(th, len - 1) - t0 + 1;  // the steps below the row's length
      float* sh = st + sw * M::HQ;
      float* sg = st + SPW * M::HQ;
      stage<H, H>(sg + SPW * M::GP + sw * M::GGP, g_s + t0 * H, (th - t0 + 1) * H, i);
      if (nv > 0) {
        stage<H, STEP>(sg + sw * M::GP, gi_s + t0 * STEP, nv * STEP, i);
        if (M::HAS_ATT) stage<H, 1>(sg + SPW * (M::GP + M::GGP) + sw * M::AP, att_s + t0, nv, i);
        // h_prev of steps t0 ..: outs rows t0 - 1 .. (h0 for row -1), a
        // float a lane a row, into rows of HP
        const float* src = outs + (row0 + t0 - 1) * H + i;
#pragma unroll
        for (int rr = 0; rr < C; ++rr) {
          if (rr < nv) tc::cp_async4(sh + rr * HP + i, t0 + rr > 0 ? src : h0 + ln.s * H + i, true);
          src += H;
        }
      }
    }
    tc::cp_async_commit();
  };
  issue(0);

  // above the warp's longest row: dh carries g, dgi and datt are zero
  float dh = 0.f;
  if (ln.live) {
#pragma unroll 4
    for (int t = T - 1; t >= longest; --t) {
      dh = g[(row0 + t) * H + i] + dh;
      float* d = dgi + (row0 + t) * STEP + i;
      d[0] = 0.f;
      d[H] = 0.f;
      d[2 * H] = 0.f;
      if (i == 0) datt[row0 + t] = 0.f;
    }
  }

  const int chunks = (longest + C - 1) / C;
  for (int k = 0; k < chunks; ++k) {
    tc::cp_async_wait<0>();  // chunk k has landed
    __syncwarp();            // ... for every lane, and chunk k - 1 is read
    issue(k + 1);            // into chunk k - 1's stage
    const int th = longest - 1 - k * C, t0 = max(th - C + 1, 0);
    const float* st = ring + (k & 1) * M::STAGE;
    const float* sh = st + ln.slot * M::HQ;
    const float* sg = st + SPW * M::HQ;
    const float* x0 = sg + ln.slot * M::GP + quad_offset(gi_s + t0 * STEP) + i;
    const float* go = sg + SPW * M::GP + ln.slot * M::GGP + quad_offset(g_s + t0 * H) + i;
    const float* a0 = sg + SPW * (M::GP + M::GGP) + ln.slot * M::AP + quad_offset(att_s + t0);
    for (int t = th; t >= t0; --t) {
      const int tt = t - t0;
      const bool valid = t < len;
      float* xr = xch + (t & 1) * M::XCH + ln.slot * 4 * HP;  // dr_pre, dz_pre, dhn, datt terms
      // recompute the step from h_prev, as the forward did (every lane, on
      // whatever its slots hold: a slot past the row's length holds no copy
      // and its results are not used)
      const float* x = x0 + tt * STEP;
      const float gr = x[0], gz = HAS_Z ? x[H] : 0.f, gn = x[2 * H];
      const float a = M::HAS_ATT ? a0[tt] : 0.f;
      const float D = go[tt * H] + dh;
      const float h_prev = sh[tt * HP + i];
      float hp[H];
      gru::read_row<H>(sh + tt * HP, hp);
      float ar = br, az = bz, an = bn;
      gru::recurrent<H, HAS_Z>(wr, wz, wn, hp, ar, az, an);
      const float r = gru::sigmoid(gr + ar);
      const float n = tanhf(gn + r * an);
      float z = 0.f, u;
      if (CELL == gru::CELL_AGRU) {
        u = a;
      } else {
        z = gru::sigmoid(gz + az);
        u = CELL == gru::CELL_GRU ? 1.f - z : a * z;
      }
      float dr_pre = 0.f, dz_pre = 0.f, dn_pre = 0.f, dhn = 0.f, da = 0.f, dh_keep = D;
      if (valid) {
        const float dn = D * u;
        dh_keep = D * (1.f - u);
        const float du = D * (n - h_prev);
        if (CELL == gru::CELL_AGRU) {
          da = du;
        } else {
          float dz;
          if (CELL == gru::CELL_GRU) {
            dz = -du;
          } else {
            da = du * z;
            dz = du * a;
          }
          dz_pre = dz * z * (1.f - z);
        }
        dn_pre = dn * (1.f - n * n);
        dhn = dn_pre * r;
        dr_pre = dn_pre * an * r * (1.f - r);
      }
      if (ln.live) {
        float* d = dgi + (row0 + t) * STEP + i;
        d[0] = dr_pre;
        d[H] = dz_pre;
        d[2 * H] = dn_pre;
      }
      if (ln.active) {
        xr[i] = dr_pre;
        if (HAS_Z) xr[HP + i] = dz_pre;
        xr[2 * HP + i] = dhn;
        if (M::HAS_ATT) xr[3 * HP + i] = da;
      }
      __syncwarp();
      // dh = D (1 - u) + sum_g W_g^T d_g, a chain a gate
      float v[H];
      gru::read_row<H>(xr, v);
      float acc = gru::dot<H>(cr, v, 0.f);
      if (HAS_Z) {
        gru::read_row<H>(xr + HP, v);
        acc += gru::dot<H>(cz, v, 0.f);
      }
      gru::read_row<H>(xr + 2 * HP, v);
      dh = dh_keep + (acc + gru::dot<H>(cn, v, 0.f));
      if (valid) {
#pragma unroll
        for (int j = 0; j < H; ++j) {
          dwr[j] = fmaf(dr_pre, hp[j], dwr[j]);
          if (HAS_Z) dwz[j] = fmaf(dz_pre, hp[j], dwz[j]);
          dwn[j] = fmaf(dhn, hp[j], dwn[j]);
        }
        dbr += dr_pre;
        dbz += dz_pre;
        dbn += dhn;
      }
      if (ln.live && i == 0) {  // datt[t]: the sample's units summed in order
        float sum = 0.f;
        if (M::HAS_ATT) {
          gru::read_row<H>(xr + 3 * HP, v);
#pragma unroll
          for (int j = 0; j < H; ++j) sum += v[j];
        }
        datt[row0 + t] = sum;
      }
    }
  }
  if (ln.live) dh0[ln.s * H + i] = dh;

  // this block's dW / db partial: the (warp, sample) partials summed in order
  tc::cp_async_wait<0>();
  __syncthreads();  // every warp is past its sweep: the memory is free
  float* red = gru_smem;
  if (ln.active) {
    float* mine = red + (ln.warp * SPW + sw) * M::N;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      mine[(0 * H + i) * H + j] = dwr[j];
      mine[(1 * H + i) * H + j] = HAS_Z ? dwz[j] : 0.f;
      mine[(2 * H + i) * H + j] = dwn[j];
    }
    mine[3 * H * H + 0 * H + i] = dbr;
    mine[3 * H * H + 1 * H + i] = dbz;
    mine[3 * H * H + 2 * H + i] = dbn;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < M::N; e += 32 * WARPS) {
    float sum = 0.f;
    for (int k = 0; k < WARPS * SPW; ++k) sum += red[k * M::N + e];
    part[static_cast<long long>(blockIdx.x) * M::N + e] = sum;
  }
}

// The sum over the nblk block partials part[p][e] into dW (e < 3 H H, as
// [3, H, H]) and db (the rest, as [3, H]): a block takes 32
// consecutive e, its thread (e, y) sums p = y, y + SUM_ROWS, ... in order
// (each warp reading 32 consecutive floats of a partial; eight loads in
// flight before their adds), then thread (e, 0) sums the SUM_ROWS row sums
// in order.
__global__ void __launch_bounds__(32 * SUM_ROWS)
gru_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ dw, float* __restrict__ db,
                   int nblk, int n, int n_w) {
  const int x = threadIdx.x % 32, y = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + x;
  float acc = 0.f;
  if (e < n) {
    for (int p0 = y; p0 < nblk; p0 += 8 * SUM_ROWS) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int p = p0 + k * SUM_ROWS;
        v[k] = p < nblk ? part[static_cast<long long>(p) * n + e] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += v[k];
    }
  }
  gru_smem[y * 32 + x] = acc;
  __syncthreads();
  if (y == 0 && e < n) {
    float sum = 0.f;
    for (int k = 0; k < SUM_ROWS; ++k) sum += gru_smem[k * 32 + x];
    if (e < n_w) {
      dw[e] = sum;
    } else {
      db[e - n_w] = sum;
    }
  }
}

template <int CELL, int H>
int launch_bwd(const float* g, const float* gi, const float* w, const float* b, const float* att,
               const int* lengths, const float* h0, const float* outs, float* dgi, float* datt,
               float* dh0, float* part, float* dw, float* db, int nblk, int B, int T,
               cudaStream_t stream) {
  constexpr int per = WARPS * gru::Lanes<H, WARPS>::SPW;
  if (nblk != (B + per - 1) / per) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = gru_bwd_kernel<CELL, H>;
  constexpr size_t smem = BwdSmem<CELL, H>::BYTES;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  void* args[] = {&g, &gi, &w, &b, &att, &lengths, &h0, &outs, &dgi, &datt, &dh0, &part, &B, &T};
  err = cudaLaunchKernel(kern, dim3(nblk), dim3(32 * WARPS), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int n = BwdSmem<CELL, H>::N, n_w = 3 * H * H;
  const float* cpart = part;
  void* sum_args[] = {&cpart, &dw, &db, &nblk, &n, &n_w};
  err = cudaLaunchKernel(gru_bwd_sum_kernel, dim3((n + 31) / 32), dim3(32 * SUM_ROWS), sum_args,
                         32 * SUM_ROWS * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` and returns the first CUDA error (0 on
// success).  The caller has checked dtypes, shapes and contiguity,
// 0 <= cell <= 2, 1 <= H <= 16, T >= 1, B >= 1, att present unless cell is
// gru, nblk = ceil(B / (4 (32 / H))) (4 warps of 32 / H samples a block),
// and allocated dgi, datt [B, T], dh0, part [nblk, 3H(H + 1)] (dW [3, H, H]
// then db [3, H] of each block), dw [3, H, H] and db [3, H].
int gru_bwd(int cell, const void* g, const void* gi, const void* w, const void* b,
            const void* att, const void* lengths, const void* h0, const void* outs, void* dgi,
            void* datt, void* dh0, void* part, void* dw, void* db, int nblk, int B, int T, int H,
            void* stream) {
  GRU_DISPATCH(cell, H, launch_bwd, static_cast<const float*>(g), static_cast<const float*>(gi),
               static_cast<const float*>(w), static_cast<const float*>(b),
               static_cast<const float*>(att), static_cast<const int*>(lengths),
               static_cast<const float*>(h0), static_cast<const float*>(outs),
               static_cast<float*>(dgi), static_cast<float*>(datt), static_cast<float*>(dh0),
               static_cast<float*>(part), static_cast<float*>(dw), static_cast<float*>(db), nblk,
               B, T, static_cast<cudaStream_t>(stream))
}

const char* gru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
