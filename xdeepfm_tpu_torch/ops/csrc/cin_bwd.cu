// CIN backward for Hopper (sm_90a), behind a plain C interface that
// ops/cin_cuda.py loads with ctypes.  For one CIN layer
//
//   out[r, o] = b[o] + sum_{h, m} W[o, h*M + m] * h_rows[r, h] * x0_rows[r, m]
//
// and its output gradient g [N, O], with Z[r, h, m] = sum_o g[r, o] W[o, h*M+m]:
//
//   cin_bwd_dx:  dh[r, h]  = sum_m Z[r, h, m] * x0[r, m]
//                dx0[r, m] = sum_h Z[r, h, m] * h[r, h]
//   cin_dw:      dW[o, h*M + m] = sum_r g[r, o] * h[r, h] * x0[r, m]
//
// All fp32; h_rows is read by row stride (split-half hands layer 1 a column
// slice of layer 0's output), every other operand is contiguous.
//
// Replaces: xdeepfm_tpu/ops/cin_pallas.py _bwd_fused_t / _bwd_kernel (the
// fused backward: cin_bwd_dx plus cin_dw) and _dw_contract / _dw_kernel (the
// dW of the legacy backward: cin_dw).
//
// Bound: operations.  At batch 4096 (N = 40960 rows) each kernel does the
// forward's 2*N*H*M*O FLOPs (14.2 GFLOP at layer 0, 34.9 at layer 1) on a few
// MB of operands: hundreds of FLOPs per byte, far above the card's ridge.
// So neither [N, H*M] intermediate (Z or the outer product z = h x x0) ever
// reaches device memory.  The two kernels take the work two ways:
//   * cin_bwd_dx, fp32 FMAs on the CUDA cores (bound 0.732 ms a train step
//     at 67 TFLOP/s), with the 8 x 8 register tiles of cin_tile.cuh: one
//     block owns 128 rows and walks the K = H*M columns in chunks of whole h
//     groups, each group's M columns padded to MP (a power of two: 32 at
//     M = 26), so that a chunk is 128 / MP groups.  The chunk's Z tile (a GEMM
//     over O: g rows times W columns, W from L2) stays in registers and is
//     reduced at once: dh by a shuffle over the MP / 4 lanes that hold one
//     group's columns, dx0 by a shuffle over the lanes that hold one m,
//     summed over chunks in shared memory and written at the end.  The padded
//     columns cost (MP - M) / M more FLOPs (23% at M = 26); the measured
//     TFLOP/s count only the unpadded work.  A block holds too little work
//     for 132 SMs when N is small, so the chunks are split over gridDim.y:
//     each split writes its own dx0 partial, summed in a fixed order
//     afterwards (deterministic).
//   * cin_dw, 3xTF32 on the tensor cores (tc_tf32.cuh; bound 0.298 ms a
//     train step at 495 / 3 TFLOP/s, against 0.732 on the FMA pipes): the
//     GEMM dW[O, K] = g^T z reduces over N rows while the output has only 12
//     (layer 0) or 26 (layer 1) 128 x 128 tiles, too few for 132 SMs.  So
//     the rows are cut into slices over gridDim.z, and cin_sum_slices adds
//     the slices' partial tiles in a fixed order: deterministic, no atomics.
//     A block walks its rows 32 at a time.  cp.async brings the next
//     chunk's g rows, the window of h columns its tile touches and the x0
//     rows into the other stage of a two-stage ring while this chunk
//     computes.  One pass forms the z tile from the staged h and x0 (each
//     element read once from device memory, not once per column) and splits
//     z and g once per element into their TF32 halves, four at a time, laid
//     out [n][column] with rows 136 apart so that the fragment loads are free
//     of bank conflicts.  Eight warps, 2 x 4 over the tile, each own a
//     64 x 32 block of dW in registers: 16 m16n8k8 tiles of three MMAs a k8
//     step, each step's product added to dW in fp32 (tc::mma3_add).  A warp
//     whose rows or columns are all padding (layer 0's last column tile)
//     skips its MMAs.  Two barriers a chunk; two blocks of 113 KB a SM at
//     M = 26, with no register spills.  Against a float64 dW at batch 4096
//     it errs 0.3-0.4x as much as the plain fp32 product (chip_smoke.py).
// The TPU kernels summed over rows (dW) and over H chunks along a sequential
// grid axis in their output block (cin_pallas.py:134-144, 209-215) and kept
// dW as [M, O, H]; blocks here run in no order, so the sums are split into
// partials instead and dW keeps the parameter's own [O, H*M] layout.  Ragged
// N, H, M and O edges are masked, not padded.  cin_dw's error against a
// float64 dW is held to the plain fp32 product's in chip_smoke.py.

#include <stdint.h>

#include "cin_tile.cuh"
#include "tc_tf32.cuh"

// the dynamic shared memory of every kernel here
extern __shared__ __align__(16) float cin_smem[];

namespace {

using cin::ALD;
using cin::BK;
using cin::BM;
using cin::BN;
using cin::THREADS;
using cin::TM;
using cin::TN;

// ------------------------------------------------------------- cin_bwd_dx

constexpr int GSTEP = THREADS / BK;  // rows the g loader covers per pass (16)
constexpr int GPASS = BM / GSTEP;    // g values per thread per O step (8)
constexpr int WSTEP = THREADS / BN;  // o slots the W loader covers per pass (2)
constexpr int WPASS = BK / WSTEP;    // W values per thread per O step (8)
static_assert(THREADS % BK == 0 && BM % GSTEP == 0, "g loader");
static_assert(THREADS % BN == 0 && BK % WSTEP == 0, "W loader");

constexpr int dx_smem_bytes(int mp) {
  return (2 * BK * ALD + 2 * BK * BN + BM * mp) * 4;
}

template <int MP>
__global__ void __launch_bounds__(THREADS, 2)
cin_bwd_dx_kernel(const float* __restrict__ g, const float* __restrict__ w,
                  const float* __restrict__ h, int ldh,
                  const float* __restrict__ x0, float* __restrict__ dh,
                  float* __restrict__ dx0, int N, int H, int M, int O,
                  int chunks_per_split) {
  static_assert(MP >= 4 && MP <= BN / 2 && (BN / 2) % MP == 0, "MP");
  constexpr int HC = BN / MP;  // h groups per chunk
  constexpr int GL = MP / 4;   // lanes holding one group's columns in a half
  float* smem = cin_smem;
  auto gs = reinterpret_cast<float (*)[BK][ALD]>(smem);  // [2][o][row]: g^T
  auto ws = reinterpret_cast<float (*)[BK][BN]>(smem + 2 * BK * ALD);  // [2][o][col]
  auto dxs = reinterpret_cast<float (*)[MP]>(smem + 2 * BK * ALD + 2 * BK * BN);

  const int K = H * M;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int tr = tid / (BN / TN);
  const int tc = tid % (BN / TN);
  const int n_chunks = (H + HC - 1) / HC;
  const int q_begin = blockIdx.y * chunks_per_split;
  const int q_end = min(n_chunks, q_begin + chunks_per_split);

  for (int e = tid; e < BM * MP; e += THREADS) (&dxs[0][0])[e] = 0.f;
  __syncthreads();

  // g loader: o slot gk, rows gr + p * GSTEP (a half-warp reads 16
  // consecutive o of one row).
  const int gk = tid % BK;
  const int gr = tid / BK;
  const int rows_left = N - row0 - gr;
  const float* gz = g + (row0 + gr) * O + gk;
  // W loader: chunk column wc, o slots wo + p * WSTEP (coalesced across wc).
  const int wc = tid % BN;
  const int wo = tid / BN;

  // this thread's tile columns, as (group, m): both halves share m because
  // MP divides BN / 2
  const int m_base = cin::tile_col(tc, 0) % MP;
  const int grp0 = cin::tile_col(tc, 0) / MP;
  const int grp1 = cin::tile_col(tc, TN / 2) / MP;

  float greg[GPASS];
  float wreg[WPASS];
  float acc[TM][TN];

  for (int q = q_begin; q < q_end; ++q) {
    const int w_h = q * HC + wc / MP;
    const int w_m = wc % MP;
    const bool wcol_ok = w_m < M && w_h < H;
    const float* wz = w + w_h * M + w_m;
    auto load_chunk = [&](int o0) {
      const bool o_ok = o0 + gk < O;
#pragma unroll
      for (int p = 0; p < GPASS; ++p)
        greg[p] = (o_ok && p * GSTEP < rows_left) ? __ldg(gz + p * GSTEP * O + o0) : 0.f;
#pragma unroll
      for (int p = 0; p < WPASS; ++p) {
        const int o = o0 + wo + p * WSTEP;
        wreg[p] = (wcol_ok && o < O) ? __ldg(wz + o * K) : 0.f;
      }
    };
    auto store_chunk = [&](int buf) {
#pragma unroll
      for (int p = 0; p < GPASS; ++p) gs[buf][gk][gr + p * GSTEP] = greg[p];
#pragma unroll
      for (int p = 0; p < WPASS; ++p) ws[buf][wo + p * WSTEP][wc] = wreg[p];
    };

    cin::tile_zero(acc);
    load_chunk(0);
    store_chunk(0);
    __syncthreads();
    int buf = 0;
    for (int o0 = 0; o0 < O; o0 += BK) {
      const bool more = o0 + BK < O;
      if (more) load_chunk(o0 + BK);
      cin::tile_fma(gs[buf], ws[buf], tr, tc, acc);
      if (more) store_chunk(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }

    // acc[i][j] is Z[row i, group q*HC + (j < 4 ? grp0 : grp1), m_base + j % 4]
    const int h0 = q * HC + grp0;
    const int h1 = q * HC + grp1;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int rl = cin::tile_row(tr, i);
      const int r = row0 + rl;
      const bool r_ok = r < N;
      float xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xv[j] = (r_ok && m_base + j < M) ? __ldg(x0 + r * M + m_base + j) : 0.f;
      const float hv0 = (r_ok && h0 < H) ? __ldg(h + r * ldh + h0) : 0.f;
      const float hv1 = (r_ok && h1 < H) ? __ldg(h + r * ldh + h1) : 0.f;
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p0 = fmaf(acc[i][j], xv[j], p0);
        p1 = fmaf(acc[i][j + 4], xv[j], p1);
      }
#pragma unroll
      for (int off = GL / 2; off > 0; off >>= 1) {
        p0 += __shfl_xor_sync(0xffffffffu, p0, off);
        p1 += __shfl_xor_sync(0xffffffffu, p1, off);
      }
      if (r_ok && tc % GL == 0) {
        if (h0 < H) dh[r * H + h0] = p0;
        if (h1 < H) dh[r * H + h1] = p1;
      }
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = fmaf(acc[i][j], hv0, acc[i][j + 4] * hv1);
#pragma unroll
      for (int off = GL; off < BN / TN; off <<= 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[j] += __shfl_xor_sync(0xffffffffu, d[j], off);
      if (tc < GL) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dxs[rl][m_base + j] += d[j];
      }
    }
  }

  // each (row, m) of dxs has one owner, the thread that wrote it above
  if (tc < GL) {
    float* out = dx0 + (long long)blockIdx.y * N * M;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int rl = cin::tile_row(tr, i);
      const int r = row0 + rl;
      if (r >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m_base + j < M) out[r * M + m_base + j] = dxs[rl][m_base + j];
    }
  }
}

// ----------------------------------------------------------------- cin_dw

namespace dw {
constexpr int WARPS_M = 2, WARPS_N = 4;  // warps over the tile's rows o and columns k
constexpr int MT = 4, NT = 4;            // m16 and n8 MMA tiles of a warp
constexpr int KC = 32;                   // rows n of one chunk: KC / 8 k8 steps
constexpr int MINB = 2;                  // resident blocks a SM (launch bounds)
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int BM = WARPS_M * 16 * MT;    // output rows (channels o) of a block's tile
constexpr int BN = WARPS_N * 8 * NT;     // output columns (k = h*M + m) of a block's tile
constexpr int STAGES = 2;                // chunks in flight in the copy ring
// rows of the [KC][BM] g and [KC][BN] z tiles: lanes (tig, group) hit banks
// 8 * tig + group, free of conflicts
constexpr int LDG = BM + 8;
constexpr int LDZ = BN + 8;
constexpr int XMAX = 128;  // x0 rows up to this width are staged whole
constexpr int SPLIT_FLOATS = 2 * KC * (LDG + LDZ);  // g and z, each big and small
static_assert(BM % 32 == 0 && BN % 32 == 0 && KC % (THREADS / (BN / 4)) == 0, "tile shapes");
}  // namespace dw

// The three staged operands of one chunk: g rows [KC][LDG] (columns o0..),
// the h window [KC][hw] (columns hlo..) and x0: whole rows [KC * M] when
// M <= XMAX, else [KC][BN], column j holding x0[n, (k0 + j) % M].
__host__ __device__ inline int dw_x_floats(int M) {
  return M <= dw::XMAX ? (dw::KC * M + 3) / 4 * 4 : dw::KC * dw::BN;
}
__host__ __device__ inline int dw_stage_floats(int M, int hw) {
  return dw::KC * dw::LDG + (dw::KC * hw + 3) / 4 * 4 + dw_x_floats(M);
}
// h columns a BN-column tile can touch: ceil(127 / M) + 1, at most H
inline int dw_h_window(int H, int M) { return min(H, (dw::BN - 1) / M + 2); }
inline int dw_smem_bytes(int M, int hw) {
  return (dw::SPLIT_FLOATS + dw::STAGES * dw_stage_floats(M, hw)) * 4;
}

// grid (k tiles, o tiles, row slices); part [slices][O][K]
__global__ void __launch_bounds__(dw::THREADS, dw::MINB)
cin_dw_kernel(const float* __restrict__ g, const float* __restrict__ h, int ldh,
              const float* __restrict__ x0, float* __restrict__ part, int N,
              int H, int M, int O, int rows_per_slice, int hw) {
  constexpr int BM = dw::BM, BN = dw::BN, KC = dw::KC, STAGES = dw::STAGES;
  constexpr int LDG = dw::LDG, LDZ = dw::LDZ, XMAX = dw::XMAX, THREADS = dw::THREADS;
  constexpr int MT = dw::MT, NT = dw::NT, SPLIT_FLOATS = dw::SPLIT_FLOATS;
  uint32_t* gb = reinterpret_cast<uint32_t*>(cin_smem);  // [KC][LDG]: g, big
  uint32_t* gsm = gb + KC * LDG;                          // g, small
  uint32_t* zb = gsm + KC * LDG;                          // [KC][LDZ]: z = h x x0, big
  uint32_t* zsm = zb + KC * LDZ;                          // z, small
  float* ring = cin_smem + SPLIT_FLOATS;
  const int stage_floats = dw_stage_floats(M, hw);

  const int K = H * M;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BN;
  const int o0 = blockIdx.y * BM;
  const int n_begin = blockIdx.z * rows_per_slice;
  const int n_end = min(N, n_begin + rows_per_slice);
  const int n_chunks = n_end > n_begin ? (n_end - n_begin + KC - 1) / KC : 0;
  const int hlo = k0 / M;
  const bool x_whole = M <= XMAX;
  const bool g_vec = (O & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;

  // copies of chunk c into stage s: every slot of the stage is written (a
  // zero past the valid rows and columns)
  auto issue = [&](int c, int s) {
    float* gr = ring + s * stage_floats;
    float* hr = gr + KC * LDG;
    float* xr = hr + (KC * hw + 3) / 4 * 4;
    const int n0 = n_begin + c * KC;
    if (g_vec) {
      for (int e = tid; e < KC * (BM / 4); e += THREADS) {
        const int r = e / (BM / 4);
        const int col = (e - r * (BM / 4)) * 4;
        const int left = (n0 + r < n_end) ? O - (o0 + col) : 0;
        const int bytes = left <= 0 ? 0 : (left >= 4 ? 16 : 4 * left);
        tc::cp_async16(gr + r * LDG + col, bytes ? g + (n0 + r) * O + o0 + col : g, bytes);
      }
    } else {
      for (int e = tid; e < KC * BM; e += THREADS) {
        const int r = e / BM;
        const int col = e - r * BM;
        const bool ok = n0 + r < n_end && o0 + col < O;
        tc::cp_async4(gr + r * LDG + col, ok ? g + (n0 + r) * O + o0 + col : g, ok);
      }
    }
    for (int e = tid; e < KC * hw; e += THREADS) {
      const int r = e / hw;
      const int j = e - r * hw;
      const bool ok = n0 + r < n_end && hlo + j < H;
      tc::cp_async4(hr + e, ok ? h + (n0 + r) * ldh + hlo + j : h, ok);
    }
    if (x_whole) {
      const float* src = x0 + n0 * M;  // rows n0.. are contiguous
      const int valid = (min(n_end, n0 + KC) - n0) * M;
      const int slots = dw_x_floats(M);
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        for (int e = tid * 4; e < slots; e += THREADS * 4) {
          const int left = valid - e;
          const int bytes = left <= 0 ? 0 : (left >= 4 ? 16 : 4 * left);
          tc::cp_async16(xr + e, bytes ? src + e : x0, bytes);
        }
      } else {
        for (int e = tid; e < slots; e += THREADS)
          tc::cp_async4(xr + e, e < valid ? src + e : x0, e < valid);
      }
    } else {
      for (int e = tid; e < KC * BN; e += THREADS) {
        const int r = e / BN;
        const int j = e - r * BN;
        const bool ok = n0 + r < n_end && k0 + j < K;
        tc::cp_async4(xr + e, ok ? x0 + (n0 + r) * M + (k0 + j) % M : x0, ok);
      }
    }
  };

  // the conversion pass: z column cc of the tile, rows cr + THREADS / BN * p
  const int zq = 4 * (tid % (BN / 4));  // z columns zq..zq + 3, rows zr + 8 p
  const int zr = tid / (BN / 4);
  const int z_h = (k0 + zq) / M - hlo;
  const int z_m = (k0 + zq) % M;

  // the MMA: warp (wo, wk) owns output rows wo.. and columns wk..
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = lane / 4;
  const int tig = lane % 4;
  const int wo = (warp / dw::WARPS_N) * 16 * MT;
  const int wk = (warp % dw::WARPS_N) * 8 * NT;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if (n_chunks > 0) {
    issue(0, 0);
    tc::cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      issue(c + 1, (c + 1) % STAGES);  // that stage's chunk c - 1 is converted
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1's tiles

    const float* gr = ring + (c % STAGES) * stage_floats;
    const float* hr = gr + KC * LDG;
    const float* xr = hr + (KC * hw + 3) / 4 * 4;
#pragma unroll 4
    for (int e = 4 * tid; e < KC * BM; e += 4 * THREADS) {  // 4 channels a thread
      const int r = e / BM;
      const int o = r * LDG + e - r * BM;
      const float4 v = *reinterpret_cast<const float4*>(gr + o);
      uint4 big, small;
      tc::split(v.x, big.x, small.x);
      tc::split(v.y, big.y, small.y);
      tc::split(v.z, big.z, small.z);
      tc::split(v.w, big.w, small.w);
      *reinterpret_cast<uint4*>(gb + o) = big;
      *reinterpret_cast<uint4*>(gsm + o) = small;
    }
#pragma unroll 2
    for (int r = zr; r < KC; r += THREADS / (BN / 4)) {  // 4 columns a thread
      float zv[4];
      int hh = z_h, mm = z_m;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        zv[q] = k0 + zq + q < K ? hr[r * hw + hh] * xr[x_whole ? r * M + mm : r * BN + zq + q]
                                : 0.f;
        if (++mm == M) {
          mm = 0;
          ++hh;
        }
      }
      uint4 big, small;
      tc::split(zv[0], big.x, small.x);
      tc::split(zv[1], big.y, small.y);
      tc::split(zv[2], big.z, small.z);
      tc::split(zv[3], big.w, small.w);
      *reinterpret_cast<uint4*>(zb + r * LDZ + zq) = big;
      *reinterpret_cast<uint4*>(zsm + r * LDZ + zq) = small;
    }
    __syncthreads();

    if (o0 + wo < O && k0 + wk < K)  // not a warp of padding alone
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      const int z0 = (kk + tig) * LDZ, z1 = (kk + tig + 4) * LDZ;
      const int g0 = (kk + tig) * LDG, g1 = (kk + tig + 4) * LDG;
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wk + 8 * j + group;
        bb[j][0] = zb[z0 + col];
        bb[j][1] = zb[z1 + col];
        bs[j][0] = zsm[z0 + col];
        bs[j][1] = zsm[z1 + col];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = wo + 16 * i + group;
        const uint32_t ab[4] = {gb[g0 + row], gb[g0 + row + 8], gb[g1 + row], gb[g1 + row + 8]};
        const uint32_t as[4] = {gsm[g0 + row], gsm[g0 + row + 8], gsm[g1 + row],
                                gsm[g1 + row + 8]};
#pragma unroll
        for (int j = 0; j < NT; ++j) tc::mma3_add(acc[i][j], ab, as, bb[j], bs[j]);
      }
    }
  }

  float* out = part + (long long)blockIdx.z * O * K;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = o0 + wo + 16 * i + group + 8 * half;
      if (o >= O) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = k0 + wk + 8 * j + 2 * tig + q;
          if (k < K) out[o * K + k] = acc[i][j][2 * half + q];
        }
    }
}

// out[i] = sum_s part[s * n + i], s = 0, 1, ... in order: deterministic
__global__ void cin_sum_slices_kernel(const float* __restrict__ part, int slices,
                                      long long n, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float s = 0.f;
    for (int t = 0; t < slices; ++t) s += __ldg(part + t * n + i);
    out[i] = s;
  }
}

template <int MP>
int launch_dx(const float* g, const float* w, const float* h, int ldh,
              const float* x0, float* dh, float* dx0, int N, int H, int M,
              int O, int splits, int chunks_per_split, cudaStream_t stream) {
  constexpr int smem = dx_smem_bytes(MP);
  cudaError_t err = cudaFuncSetAttribute(
      cin_bwd_dx_kernel<MP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BM - 1) / BM, splits);
  void* args[] = {&g, &w, &h, &ldh, &x0, &dh, &dx0, &N, &H, &M, &O, &chunks_per_split};
  err = cudaLaunchKernel(cin_bwd_dx_kernel<MP>, grid, dim3(THREADS), args,
                         static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each function launches on `stream` and returns cudaGetLastError() (0 on
// success).  The caller has checked shapes, dtypes, devices, N, H, M, O > 0
// and that every element offset fits in 32 bits; it allocates every output
// and partial buffer.

// dh [N, H]; dx0 [splits, N, M] partials (the final dx0 when splits == 1).
// mp is M rounded up to a power of two in 8..64; split s walks chunks
// [s * chunks_per_split, (s + 1) * chunks_per_split) of 128 / mp h groups.
int cin_bwd_dx(const void* g, const void* w, const void* h, int ldh,
               const void* x0, void* dh, void* dx0, int N, int H, int M,
               int O, int mp, int splits, int chunks_per_split, void* stream) {
  auto G = static_cast<const float*>(g);
  auto W = static_cast<const float*>(w);
  auto Hr = static_cast<const float*>(h);
  auto X0 = static_cast<const float*>(x0);
  auto DH = static_cast<float*>(dh);
  auto DX0 = static_cast<float*>(dx0);
  auto st = static_cast<cudaStream_t>(stream);
  switch (mp) {
    case 8:
      return launch_dx<8>(G, W, Hr, ldh, X0, DH, DX0, N, H, M, O, splits, chunks_per_split, st);
    case 16:
      return launch_dx<16>(G, W, Hr, ldh, X0, DH, DX0, N, H, M, O, splits, chunks_per_split, st);
    case 32:
      return launch_dx<32>(G, W, Hr, ldh, X0, DH, DX0, N, H, M, O, splits, chunks_per_split, st);
    case 64:
      return launch_dx<64>(G, W, Hr, ldh, X0, DH, DX0, N, H, M, O, splits, chunks_per_split, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// part [slices, O, H*M]: slice s sums rows [s * rows_per_slice, ...),
// rows_per_slice a multiple of cin_dw_geometry's kc.
int cin_dw(const void* g, const void* h, int ldh, const void* x0, void* part,
           int N, int H, int M, int O, int slices, int rows_per_slice,
           void* stream) {
  int hw = dw_h_window(H, M);
  const int smem = dw_smem_bytes(M, hw);
  cudaError_t err = cudaFuncSetAttribute(
      cin_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto G = static_cast<const float*>(g);
  auto Hr = static_cast<const float*>(h);
  auto X0 = static_cast<const float*>(x0);
  auto P = static_cast<float*>(part);
  void* args[] = {&G, &Hr, &ldh, &X0, &P, &N, &H, &M, &O, &rows_per_slice, &hw};
  const dim3 grid((H * M + dw::BN - 1) / dw::BN, (O + dw::BM - 1) / dw::BM, slices);
  err = cudaLaunchKernel(cin_dw_kernel, grid, dim3(dw::THREADS), args, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// cin_dw's tile: output rows, output columns, rows a chunk (rows_per_slice
// is a multiple of it) and the blocks a SM its launch bounds plan for
int cin_dw_geometry(int* bm, int* bn, int* kc, int* blocks_per_sm) {
  *bm = dw::BM;
  *bn = dw::BN;
  *kc = dw::KC;
  *blocks_per_sm = dw::MINB;
  return 0;
}

// out [n] = sum over s of part [slices, n]
int cin_sum_slices(const void* part, int slices, long long n, void* out,
                   int blocks, void* stream) {
  auto P = static_cast<const float*>(part);
  auto Out = static_cast<float*>(out);
  void* args[] = {&P, &slices, &n, &Out};
  const cudaError_t err = cudaLaunchKernel(cin_sum_slices_kernel, dim3(blocks), dim3(256), args,
                                           0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

const char* cin_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
