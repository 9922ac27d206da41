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
// reaches device memory.  Both kernels run on the tensor cores in 3xTF32
// (tc_tf32.cuh; bound 0.297 ms a train step at 495 / 3 TFLOP/s, against
// 0.732 on the fp32 FMA pipes, an NVIDIA H100 80GB HBM3 at 700.00 W):
//   * cin_bwd_dx: the GEMM Z = g W over O, each h group's M columns padded
//     to MP (a power of two, 8..64: 32 at M = 26, as the TPU kernel's Mp);
//     a first small kernel writes W with its groups so padded (zeros), so
//     that a stage's W columns come by 16-byte copies.  A block of 8 warps
//     owns 128 rows and walks chunks of 128 padded columns (128 / MP whole
//     groups); g rows [128 x 32 channels] and W columns [32 x 128] come by
//     cp.async through a ring of three stages, one barrier a stage.  A warp
//     owns 64 rows x 32 columns: 16 m16n8k8 tiles, each operand split into
//     its TF32 halves as it is loaded into fragments, each k8 step's product
//     added in fp32 (tc::mma3_add: O is a long sum).  When a chunk's Z is
//     complete, the epilogue works on the accumulator fragments:
//     dh[r, h] = sum_m Z x0[r, m] in the lane and then across the quad in a
//     fixed order (at MP = 64 a group spans two warps: their halves are
//     added in order through shared memory); dx0[r, m] += Z h[r, h] in
//     registers kept over every group and chunk the block walks, a lane's
//     slots of one m added in column order and the four column warps in
//     order at the block's end.  x0 is staged once a block, each chunk's h
//     columns with its last stage.  The two accumulators take 128 registers,
//     so one block of 8 warps a SM (up to 255 registers a thread); with 16
//     warps at 128 registers it spilled and ran slower.  The padded columns
//     cost (MP - M) / M more products (23% at M = 26); a warp whose columns
//     are all past H skips its products.  When 128-row tiles x chunks fill
//     the card too thinly, the chunks are split over gridDim.y, each split
//     writing a dx0 partial that cin_sum_slices adds in order.  Measured
//     (chip_smoke.py, an NVIDIA H100 80GB HBM3 at 700.00 W): 1.641-1.660 ms a
//     train step, against 1.752-1.757 for the fp32-FMA kernel this replaced;
//     dh and dx0 err 0.4-0.8x as much as the plain fp32 version against
//     float64.  Splits, copies and the fp32 adds of the products, not the
//     MMAs, take most of the time (throwaway variant builds without each);

//   * cin_dw: the GEMM dW[O, K] = g^T z reduces over N rows while the output has only 12
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
//     it errs 0.3-0.4x as much as the plain fp32 product (chip_smoke.py, an
//     NVIDIA H100 80GB HBM3 at 700.00 W).
// The TPU kernels summed over rows (dW) and over H chunks along a sequential
// grid axis in their output block (cin_pallas.py:134-144, 209-215) and kept
// dW as [M, O, H]; blocks here run in no order, so the sums are split into
// partials instead and dW keeps the parameter's own [O, H*M] layout.  Ragged
// N, H, M and O edges are masked, not padded.  Each kernel's error against
// float64 is held to twice the plain fp32 version's in chip_smoke.py.
//
// The bf16 mode (cin_bwd_dx_bf16; cin_pallas.set_cin_precision("bf16")):
// the TPU kernel's fused backward cast only g^T and W^T to bf16
// (cin_pallas.py:226-241), so Z = g W sums exact bf16 products in fp32 and
// dh, dx0 take the unrounded fp32 h and x0.  The same kernel, templated on
// the precision, stages g and W in fp32 as before, rounds each pair to bf16
// as it loads the fragments (cvt.rn.bf16x2) and runs one mma.sync m16n8k16
// bf16 a k16 step (a third of the TF32 route's MMAs at twice the depth),
// each step's product added to Z in fp32; the epilogue is the fp32 one.
// dW needs no kernel of its own: the TPU kernel formed it from the bf16
// g^T and the fp32 outer product, so the wrapper hands cin_dw g rounded to
// bf16 (and stored as fp32); the legacy backward's dW (_dw_contract) stays
// fp32 on the raw g.  Bound: operations, 2*N*H*M*O at 989 TFLOP/s (bf16
// tensor cores, H100 SXM): 0.050 ms the train batch's two launches.

#include <stdint.h>

#include "tc_tf32.cuh"

// the dynamic shared memory of every kernel here
extern __shared__ __align__(16) float cin_smem[];

namespace {

// ------------------------------------------------------------- cin_bwd_dx

namespace dx {
constexpr int WARPS_R = 2, WARPS_C = 4;  // warps over the block's rows and a chunk's columns
constexpr int THREADS = 32 * WARPS_R * WARPS_C;
constexpr int MT = 4;             // m16 tiles of a warp's rows
constexpr int BR = WARPS_R * 16 * MT;  // rows of a block (128): a warp owns 64
constexpr int BC = WARPS_C * 32;  // padded columns of a chunk (128): a warp owns 32 (4 n8 tiles)
constexpr int OC = 32;            // channels o of one ring stage: four k8 steps
constexpr int STAGES = 3;
constexpr int LDG = OC + 4;       // g rows [BR][LDG]: lanes (group, tig) hit banks 4 group + tig
constexpr int LDW = BC + 8;       // W rows [OC][LDW]: lanes hit banks 8 tig + group
// a stage: g, W and the chunk's h columns [BR][BC / MP]
__host__ __device__ constexpr int stage_floats(int mp) {
  return BR * LDG + OC * LDW + BR * (BC / mp);
}
}  // namespace dx

// the ring (at the block's end the column warps' dx0 [WARPS_C][BR][32]),
// x0 [BR][MP + 4], the upper dh halves [BR][2]
template <int MP>
constexpr int dx_smem_floats() {
  return dx::STAGES * dx::stage_floats(MP) + dx::BR * (MP + 4) + dx::BR * 2;
}
static_assert(dx::WARPS_C * dx::BR * 32 <= dx::STAGES * dx::stage_floats(64), "dx0 in the ring");

// x = big + small: big rounded to TF32, small the exact rest, whose low 13
// bits the tensor cores ignore
__device__ __forceinline__ void split_raw(float x, uint32_t& big, uint32_t& small) {
  big = tc::tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// wp [O][H * MP] = W [O][H * M] with each group's columns padded to MP by zeros
__global__ void cin_pad_w_kernel(const float* __restrict__ w, float* __restrict__ wp, int H,
                                 int M, int MP, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
    const long long o = e / ((long long)H * MP);
    const int k = static_cast<int>(e - o * H * MP);
    const int m = k % MP;
    wp[e] = m < M ? __ldg(w + o * H * M + k / MP * M + m) : 0.f;
  }
}

// grid (row tiles of 128, splits of the chunks); wp from cin_pad_w_kernel;
// dx0 [splits][N][M]
template <int MP, bool BF16>
__global__ void __launch_bounds__(dx::THREADS, 1)
cin_bwd_dx_kernel(const float* __restrict__ g, const float* __restrict__ wp,
                  const float* __restrict__ h, int ldh, const float* __restrict__ x0,
                  float* __restrict__ dh, float* __restrict__ dx0, int N, int H, int M, int O,
                  int chunks_per_split) {
  using namespace dx;
  static_assert(MP == 8 || MP == 16 || MP == 32 || MP == 64, "MP");
  constexpr int GPC = BC / MP;          // h groups of a chunk
  constexpr int LDX = MP + 4;           // x0 rows [BR][LDX]
  constexpr int GPW = MP <= 32 ? 32 / MP : 1;  // groups a warp's 32 columns touch
  constexpr int STAGE = stage_floats(MP);
  float* ring = cin_smem;
  float* xs = ring + STAGES * STAGE;    // [BR][LDX]: the block's x0 rows, zero past M
  float* dhx = xs + BR * LDX;           // [BR][2]: the upper halves of dh (MP 64)

  const int KP = H * MP;  // padded columns
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, group = lane / 4, tig = lane % 4;
  const int wr = (warp / WARPS_C) * 16 * MT;  // this warp's rows of the block
  const int wc = (warp % WARPS_C) * 32;       // and columns of a chunk
  const int row0 = blockIdx.x * BR;
  const int n_chunks = (H + GPC - 1) / GPC;
  const int q_begin = blockIdx.y * chunks_per_split;
  const int q_end = min(n_chunks, q_begin + chunks_per_split);
  const int so = (O + OC - 1) / OC;  // stages a chunk
  const int n_steps = q_end > q_begin ? (q_end - q_begin) * so : 0;
  const bool g_vec = (O & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;

  // step j: chunk q_begin + j / so, channels o0 = (j % so) * OC..; every slot
  // of the stage is written (zero past N, O and H); the chunk's h columns
  // come with its last stage
  auto issue = [&](int j, int s) {
    float* gs = ring + s * STAGE;
    float* ws = gs + BR * LDG;
    float* hs = ws + OC * LDW;
    const int q = q_begin + j / so;
    const int o0 = (j % so) * OC;
    if (g_vec) {
      for (int e = tid; e < BR * (OC / 4); e += THREADS) {
        const int r = e / (OC / 4);
        const int c = (e - r * (OC / 4)) * 4;
        const int left = row0 + r < N ? O - (o0 + c) : 0;
        const int bytes = left <= 0 ? 0 : (left >= 4 ? 16 : 4 * left);
        tc::cp_async16(gs + r * LDG + c, bytes ? g + (row0 + r) * O + o0 + c : g, bytes);
      }
    } else {
      for (int e = tid; e < BR * OC; e += THREADS) {
        const int r = e / OC;
        const int c = e - r * OC;
        const bool ok = row0 + r < N && o0 + c < O;
        tc::cp_async4(gs + r * LDG + c, ok ? g + (row0 + r) * O + o0 + c : g, ok);
      }
    }
    // W rows: the chunk's 128 padded columns, 16 bytes a copy (KP is a
    // multiple of 8, wp 16-byte aligned)
    for (int e = tid; e < OC * (BC / 4); e += THREADS) {
      const int o = e / (BC / 4);
      const int c = (e - o * (BC / 4)) * 4;
      const bool ok = o0 + o < O && q * BC + c < KP;
      tc::cp_async16(ws + o * LDW + c, ok ? wp + (o0 + o) * KP + q * BC + c : wp, ok ? 16 : 0);
    }
    if (j % so == so - 1) {
      for (int e = tid; e < BR * GPC; e += THREADS) {
        const int r = e / GPC;
        const int gi = e - r * GPC;
        const bool ok = row0 + r < N && q * GPC + gi < H;
        tc::cp_async4(hs + e, ok ? h + (row0 + r) * ldh + q * GPC + gi : h, ok);
      }
    }
  };

  for (int e = tid; e < BR * LDX; e += THREADS) {
    const int r = e / LDX;
    const int m = e - r * LDX;
    const bool ok = row0 + r < N && m < M;
    tc::cp_async4(xs + e, ok ? x0 + (row0 + r) * M + m : x0, ok);
  }
  if (n_steps > 0) issue(0, 0);
  tc::cp_async_commit();
  if (n_steps > 1) issue(1, 1);
  tc::cp_async_commit();

  // Z [rows wr + 16 i ..][columns wc + 8 nt ..] as m16n8 fragments, and
  // dx0 in the same slots: Z h summed over the groups and chunks walked
  float acc[MT][4][4], dacc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) dacc[i][nt][qq] = 0.f;

  for (int j = 0; j < n_steps; ++j) {
    tc::cp_async_wait<1>();
    __syncthreads();  // step j has landed; every warp is done with step j - 1's stage
    if (j + 2 < n_steps) issue(j + 2, (j + 2) % STAGES);
    tc::cp_async_commit();

    const int q = q_begin + j / so;
    if (j % so == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) acc[i][nt][qq] = 0.f;
    }
    const float* gs = ring + (j % STAGES) * STAGE;
    const float* ws = gs + BR * LDG;
    // a warp whose columns are all padding (past H) skips its products
    if (BF16 && q * GPC + wc / MP < H) {
      // g and W rounded to bf16 as the fragments are loaded, one m16n8k16
      // product a k16 step, added to Z in fp32
#pragma unroll
      for (int kk = 0; kk < OC; kk += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int a0 = (wr + 16 * i + group) * LDG + kk + 2 * tig;
          const int a1 = a0 + 8 * LDG;
          a[i][0] = tc::bf16x2(gs[a0], gs[a0 + 1]);
          a[i][1] = tc::bf16x2(gs[a1], gs[a1 + 1]);
          a[i][2] = tc::bf16x2(gs[a0 + 8], gs[a0 + 9]);
          a[i][3] = tc::bf16x2(gs[a1 + 8], gs[a1 + 9]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int b0 = (kk + 2 * tig) * LDW + wc + 8 * nt + group;
          const uint32_t b[2] = {tc::bf16x2(ws[b0], ws[b0 + LDW]),
                                 tc::bf16x2(ws[b0 + 8 * LDW], ws[b0 + 9 * LDW])};
#pragma unroll
          for (int i = 0; i < MT; ++i) tc::mma_bf16_add(acc[i][nt], a[i], b);
        }
      }
    } else if (!BF16 && q * GPC + wc / MP < H) {
#pragma unroll
      for (int kk = 0; kk < OC; kk += 8) {
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int a0 = (wr + 16 * i + group) * LDG + kk + tig;
          const int a1 = a0 + 8 * LDG;
          split_raw(gs[a0], ab[i][0], as[i][0]);
          split_raw(gs[a1], ab[i][1], as[i][1]);
          split_raw(gs[a0 + 4], ab[i][2], as[i][2]);
          split_raw(gs[a1 + 4], ab[i][3], as[i][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int b0 = (kk + tig) * LDW + wc + 8 * nt + group;
          uint32_t bb[2], bs[2];
          split_raw(ws[b0], bb[0], bs[0]);
          split_raw(ws[b0 + 4 * LDW], bb[1], bs[1]);
#pragma unroll
          for (int i = 0; i < MT; ++i) tc::mma3_add(acc[i][nt], ab[i], as[i], bb, bs);
        }
      }
    }
    if (j % so != so - 1) continue;

    // The chunk's Z is complete.  acc[i][nt][qq] is row wr + 16 i + group +
    // 8 (qq / 2), chunk column c = wc + 8 nt + 2 tig + qq % 2: group
    // q * GPC + c / MP, m = c % MP.  dh: this lane's m of each group, then
    // the quad, in a fixed order; dx0: Z h added to the lane's slots.
    const float* hs = ws + OC * LDW;
    const bool upper = MP == 64 && (wc / 32) % 2 == 1;  // a group's upper m half (MP 64)
    float lower[MT][2];  // a group's lower half of dh (MP 64)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wr + 16 * i + group + 8 * half;
        float p[GPW];
#pragma unroll
        for (int gw = 0; gw < GPW; ++gw) p[gw] = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int c = wc + 8 * nt + 2 * tig + b;
            const float z = acc[i][nt][2 * half + b];
            p[(8 * nt / MP) % GPW] = fmaf(z, xs[rl * LDX + c % MP], p[(8 * nt / MP) % GPW]);
            dacc[i][nt][2 * half + b] =
                fmaf(z, hs[rl * GPC + c / MP], dacc[i][nt][2 * half + b]);
          }
        const int r = row0 + rl;
#pragma unroll
        for (int gw = 0; gw < GPW; ++gw) {
          p[gw] += __shfl_xor_sync(0xffffffffu, p[gw], 1);
          p[gw] += __shfl_xor_sync(0xffffffffu, p[gw], 2);
          const int hh = q * GPC + wc / MP + gw;
          if (MP < 64 && tig == 0 && r < N && hh < H) dh[r * H + hh] = p[gw];
        }
        if (MP == 64) {
          lower[i][half] = p[0];
          if (upper && tig == 0) dhx[rl * 2 + wc / 64] = p[0];
        }
      }
    if (MP == 64) {
      __syncthreads();
      if (!upper && tig == 0) {
        const int hh = q * GPC + wc / 64;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int rl = wr + 16 * i + group + 8 * half;
            if (row0 + rl < N && hh < H)
              dh[(row0 + rl) * H + hh] = lower[i][half] + dhx[rl * 2 + wc / 64];
          }
      }
    }
  }

  // dx0: a lane's slots of one m (the groups of its 32 columns) in column
  // order, then the column warps in order (at MP = 64 the two that hold each
  // m) through the ring, free once every copy has landed and every warp is
  // past its last step
  constexpr int MW = MP < 32 ? MP : 32;  // the m of a warp's 32 columns
  tc::cp_async_wait<0>();
  __syncthreads();
  float* red = ring;  // [WARPS_C][BR][32]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = wr + 16 * i + group + 8 * half;
#pragma unroll
      for (int nt = 0; nt < MW / 8; ++nt)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          float d = dacc[i][nt][2 * half + b];
#pragma unroll
          for (int nn = nt + MW / 8; nn < 4; nn += MW / 8) d += dacc[i][nn][2 * half + b];
          red[((wc / 32) * BR + rl) * 32 + 8 * nt + 2 * tig + b] = d;
        }
    }
  __syncthreads();
  float* out = dx0 + (long long)blockIdx.y * N * M;
  for (int e = tid; e < BR * M; e += THREADS) {
    const int rl = e / M;
    const int m = e - rl * M;
    if (row0 + rl >= N) break;
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < WARPS_C; ++c)
      if (MP < 64 || c % 2 == m / 32) d += red[(c * BR + rl) * 32 + m % 32];
    out[(row0 + rl) * M + m] = d;
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

template <int MP, bool BF16>
int launch_dx(const float* g, const float* w, float* wp, const float* h, int ldh,
              const float* x0, float* dh, float* dx0, int N, int H, int M, int O, int splits,
              int chunks_per_split, cudaStream_t stream) {
  constexpr int smem = dx_smem_floats<MP>() * 4;
  cudaError_t err = cudaFuncSetAttribute(
      cin_bwd_dx_kernel<MP, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int mp = MP;
  long long n = (long long)O * H * MP;
  void* pargs[] = {&w, &wp, &H, &M, &mp, &n};
  const long long pblocks = (n + 255) / 256;
  err = cudaLaunchKernel(cin_pad_w_kernel, dim3(static_cast<unsigned>(pblocks < 1024 ? pblocks : 1024)),
                         dim3(256), pargs, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* wpc = wp;
  const dim3 grid((N + dx::BR - 1) / dx::BR, splits);
  void* args[] = {&g, &wpc, &h, &ldh, &x0, &dh, &dx0, &N, &H, &M, &O, &chunks_per_split};
  err = cudaLaunchKernel(cin_bwd_dx_kernel<MP, BF16>, grid, dim3(dx::THREADS), args,
                         static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// cin_bwd_dx's launch at the group width mp (8, 16, 32 or 64)
template <bool BF16>
int dispatch_dx(const void* g, const void* w, void* wp, const void* h, int ldh, const void* x0,
                void* dh, void* dx0, int N, int H, int M, int O, int mp, int splits,
                int chunks_per_split, void* stream) {
  auto G = static_cast<const float*>(g);
  auto W = static_cast<const float*>(w);
  auto WP = static_cast<float*>(wp);
  auto Hr = static_cast<const float*>(h);
  auto X0 = static_cast<const float*>(x0);
  auto DH = static_cast<float*>(dh);
  auto DX0 = static_cast<float*>(dx0);
  auto st = static_cast<cudaStream_t>(stream);
  switch (mp) {
    case 8:
      return launch_dx<8, BF16>(G, W, WP, Hr, ldh, X0, DH, DX0, N, H, M, O, splits,
                                chunks_per_split, st);
    case 16:
      return launch_dx<16, BF16>(G, W, WP, Hr, ldh, X0, DH, DX0, N, H, M, O, splits,
                                 chunks_per_split, st);
    case 32:
      return launch_dx<32, BF16>(G, W, WP, Hr, ldh, X0, DH, DX0, N, H, M, O, splits,
                                 chunks_per_split, st);
    case 64:
      return launch_dx<64, BF16>(G, W, WP, Hr, ldh, X0, DH, DX0, N, H, M, O, splits,
                                 chunks_per_split, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each function launches on `stream` and returns cudaGetLastError() (0 on
// success).  The caller has checked shapes, dtypes, devices, N, H, M, O > 0
// and that every element offset fits in 32 bits; it allocates every output
// and partial buffer.

// dh [N, H]; dx0 [splits, N, M] partials (the final dx0 when splits == 1);
// wp [O, H * mp], 16-byte aligned: scratch for W with each group padded to mp
// columns.  mp is M rounded up to a power of two in 8..64; the grid is
// 128-row tiles by splits, split s walking chunks [s * chunks_per_split,
// (s + 1) * chunks_per_split) of 128 / mp h groups; one block a SM.
int cin_bwd_dx(const void* g, const void* w, void* wp, const void* h, int ldh,
               const void* x0, void* dh, void* dx0, int N, int H, int M,
               int O, int mp, int splits, int chunks_per_split, void* stream) {
  return dispatch_dx<false>(g, w, wp, h, ldh, x0, dh, dx0, N, H, M, O, mp, splits,
                            chunks_per_split, stream);
}

// The bf16 mode's cin_bwd_dx: the same contract, Z = g W from g and W
// rounded to bf16 (cin_pallas.py:226: the TPU kernel's g^T and W^T in
// bf16), dh and dx0 from the fp32 h and x0.
int cin_bwd_dx_bf16(const void* g, const void* w, void* wp, const void* h, int ldh,
                    const void* x0, void* dh, void* dx0, int N, int H, int M,
                    int O, int mp, int splits, int chunks_per_split, void* stream) {
  return dispatch_dx<true>(g, w, wp, h, ldh, x0, dh, dx0, N, H, M, O, mp, splits,
                           chunks_per_split, stream);
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
