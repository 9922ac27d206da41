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
// dh, dx0 take the unrounded fp32 h and x0.  dW needs no kernel of its own:
// the TPU kernel formed it from the bf16 g^T and the fp32 outer product, so
// cin_dw takes g rounded to bf16 (stored as fp32, exact in TF32); the
// legacy backward's dW (_dw_contract) stays fp32 on the raw g.  Bound:
// operations, 2*N*H*M*O at 989 TFLOP/s (bf16 tensor cores, H100 SXM): 0.053
// ms the train batch's two launches (the padded groups' MMAs: 0.061).
// Design: every operand bf16 once and the product on wgmma:
//   * cin_round_g_bf16, one pass over g: bf16 row tiles for the MMAs (K-
//     major 8 x 16-byte core matrices, tc_tf32.cuh's bf16 tiles, the layout
//     of a shared-memory buffer) and g's fp32 copy for cin_dw, which until
//     then was a separate torch pass; cin_pad_w_bf16_kernel writes W once a
//     launch as bf16 stages of 64 channels x 128 padded columns, each
//     group's M columns padded to MP as in fp32.
//   * cin_bwd_dx_bf16_kernel: persistent blocks (one a SM) walk items (a
//     128-row tile, a split of its chunks of 128 padded columns); a
//     producer thread bulk-copies (cp.async.bulk on mbarriers) the item's g
//     tile once into one of two buffers and W's stages through a ring of up
//     to 8; two consumer warpgroups, 64 rows each, run wgmma m64n128k16 with
//     both operands from shared memory through descriptors: no conversion
//     and no operand load in the main loop.
//   * Accumulation: each 128 channels (SUMK) summed in the tensor cores
//     from zero, then added in fp32 (O 256: two sums; O 128: one).  The
//     float64 gate chose it: against the plain bf16 version's error, SUMK
//     64 erred up to 1.26x (dh) / 1.22x (dx0), 128 1.40x / 1.43x, 256
//     1.83x / 1.79x, at 0.0834 / 0.0782 / 0.0703 ms (layer 0) and 0.207 /
//     0.178 / 0.176 ms (layer 1); 128 is the longest with margin.
//   * Where O fits one sum (layer 1), two accumulator sets: chunk q + 1's
//     MMAs are issued before chunk q's epilogue, which they overlap (layer
//     1 0.174 ms against 0.202 with one set).
//   * The epilogue works on the accumulator fragments: each warp holds 16
//     rows by all 128 columns, so dh's group sums take the lane's m, then
//     the quad (shuffles, a fixed order), and dx0's m slots stay in the
//     lane: a chunk's groups added pairwise, 8 chunks' sums together, then
//     the item's; splits' partials through cin_sum_slices.  Bit-equal from
//     run to run.
// Measured (scripts/bench_cin_bf16.py, device ms from the profiler, an
// NVIDIA H100 80GB HBM3 at 700.00 W, batch 4096): layer 0 0.078-0.081,
// layer 1 0.172-0.176, against 0.313-0.322 and 0.743-0.756 in the same
// calls for the design this replaced (g and W staged in fp32, a cvt.rn.bf16x2
// per fragment pair, mma.sync m16n8k16); the rounding pass 0.039-0.040 and 0.019; errors 0.87-1.43x
// the plain version's.  The stream of W's stages from L2, re-read by every
// row tile (335 MB at layer 1), is the largest part left: diagnostic builds
// (not kept) took layer 1, one accumulator set, from 0.202 ms to 0.120
// without the epilogue's arithmetic, 0.163 without the MMAs and 0.081
// without either; 128-byte swizzled tiles and 4 to 8 stages changed it by
// under 3%.

#include <stdint.h>

#include "tc_tf32.cuh"

// the dynamic shared memory of every kernel here
extern __shared__ __align__(128) float cin_smem[];

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
template <int MP>
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
    if (q * GPC + wc / MP < H) {
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

// -------------------------------------------------------- cin_bwd_dx_bf16

namespace dxb {
constexpr int WG = 128;          // threads of a warpgroup
constexpr int THREADS = 3 * WG;  // the producer warpgroup, then two consumers
constexpr int R = 64;            // rows of a consumer: one m64 tile
constexpr int BM = 2 * R;        // rows of a tile
constexpr int BN = 128;          // padded columns of a chunk: one m64n128k16 wgmma
// SUMK: channels summed in the tensor cores from zero before each fp32 add
// (their own fp32 sums truncate; tc_tf32.cuh), chosen by the float64 gate
// (the file's header gives the sweep); W stages of KC channels, up to
// MAX_STAGES of them in the ring.
constexpr int SUMK = 128;
constexpr int KC = 64;  // channels of a W stage: one 128-byte row of bf16
static_assert(SUMK % KC == 0, "SUMK: whole W stages");
constexpr int MAX_STAGES = 8;
constexpr int DX0_BLOCK = 8;  // chunks whose dx0 terms are summed before the item's sum
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one Hopper block may take
constexpr int BARS = (2 * MAX_STAGES + 4) * 8;
}  // namespace dxb

// The bf16 backward's plan, the same on the host and the device: the
// channels O laid out in Oq (a multiple of KC, zero past O) and cut into
// nst W stages of KC, their MMAs over Ok (O rounded up to 16); g's row tile
// staged in nseg segments of KG channels (one, holding all of Oq, unless O
// passes 384), two segment buffers and `stages` W stages in shared memory.
struct DxbPlan {
  int Oq, Ok, nst, KG, spg, nseg, stages, bytes;
  __host__ __device__ explicit DxbPlan(int O) {
    using namespace dxb;
    constexpr int wst = BN * KC * 2;  // bytes of a W stage
    Oq = (O + KC - 1) / KC * KC;
    Ok = (O + 15) / 16 * 16;
    nst = Oq / KC;
    const int room = (SMEM_LIMIT - BARS - 2 * wst) / (2 * BM * 2);
    KG = Oq <= room ? Oq : room / KC * KC;
    spg = KG / KC;
    nseg = (Oq + KG - 1) / KG;
    stages = (SMEM_LIMIT - BARS - 2 * BM * KG * 2) / wst;
    if (stages > MAX_STAGES) stages = MAX_STAGES;
    bytes = 2 * BM * KG * 2 + stages * wst + BARS;
  }
  // channels of segment seg; k16 steps of W stage st
  __host__ __device__ int seg_width(int seg) const { return min(KG, Oq - seg * KG); }
  __host__ __device__ int stage_steps(int st) const { return min(dxb::KC, Ok - st * dxb::KC) / 16; }
};

// g [N, O] -> gt, g rounded to bf16 (nearest even) in the bf16 backward's
// row tiles: tile rt (BM rows) at rt BM Oq, its segment seg (KG channels)
// at seg BM KG, a bf16 tile (tc_tf32.cuh) of BM rows by the segment's
// channels, zero past N and O; and, where g_round is not null, g_round
// [N, O], the same values as fp32 (cin_dw's operand).  A thread a 16-byte
// chunk of gt (8 channels of a row, read and written as 32 bytes of g and
// g_round), a warp's chunks contiguous.
__global__ void cin_round_g_bf16_kernel(const float* __restrict__ g, int N, int O,
                                        float* __restrict__ g_round, uint4* __restrict__ gt) {
  using dxb::BM;
  const DxbPlan plan(O);
  const int per_tile = BM * plan.Oq / 8, per_seg = BM * plan.KG / 8;
  const int total = (N + BM - 1) / BM * per_tile;
  const bool vec = (O & 7) == 0 && ((reinterpret_cast<uintptr_t>(g) |
                                     reinterpret_cast<uintptr_t>(g_round)) & 15) == 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int rt = i / per_tile, e = i - rt * per_tile, seg = e / per_seg;
    int rr, kk;
    tc::bf16_tile_chunk(16 * (e - seg * per_seg), plan.seg_width(seg), rr, kk);
    const int r = rt * BM + rr, k = seg * plan.KG + kk;
    const long long at = static_cast<long long>(r) * O + k;
    float v[8];
    if (vec && r < N && k < O) {
      *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(g + at);
      *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(g + at + 4);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = r < N && k + u < O ? g[at + u] : 0.f;
    }
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = tc::bf16x2(v[2 * u], v[2 * u + 1]);
    gt[i] = make_uint4(w[0], w[1], w[2], w[3]);
    if (g_round == nullptr || r >= N || k >= O) continue;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = __uint_as_float(u % 2 ? w[u / 2] & 0xffff0000u : w[u / 2] << 16);
    if (vec) {
      *reinterpret_cast<float4*>(g_round + at) = *reinterpret_cast<const float4*>(v);
      *reinterpret_cast<float4*>(g_round + at + 4) = *reinterpret_cast<const float4*>(v + 4);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k + u < O) g_round[at + u] = v[u];
    }
  }
}

// W [O, H*M] -> wt, W rounded to bf16 with each h group's M columns padded
// to MP (zeros), in W stages: chunk q (BN padded columns) and stage st (KC
// channels) at (q nst + st) BN KC, a bf16 tile (tc_tf32.cuh) of BN rows
// (columns) by KC channels, zero past O and H * MP.  A thread a bf16 pair
// (two channels), neighbouring threads on neighbouring columns.
__global__ void cin_pad_w_bf16_kernel(const float* __restrict__ w, int H, int M, int MP, int O,
                                      int nch, uint32_t* __restrict__ wt) {
  using dxb::BN;
  using dxb::KC;
  const DxbPlan plan(O);
  constexpr int WORDS = BN * KC / 2;  // words a stage's block holds
  const long long total = static_cast<long long>(nch) * plan.nst * WORDS;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long blk = i / WORDS;
    const int e = static_cast<int>(i - blk * WORDS), st = static_cast<int>(blk % plan.nst);
    const int q = static_cast<int>(blk / plan.nst), n = e % BN, kk = 2 * (e / BN);
    const int c = q * BN + n, o = st * KC + kk;
    float v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      v[u] = o + u < O && c < H * MP && c % MP < M
                 ? __ldg(w + static_cast<long long>(o + u) * H * M + c / MP * M + c % MP)
                 : 0.f;
    wt[blk * WORDS + tc::bf16_tile_off(n, kk, KC) / 4] = tc::bf16x2(v[0], v[1]);
  }
}

// A consumer thread's rows of an item and its epilogue: a chunk's
// m64n128k16 D holds Z[rows[hf], chunk column 8 j + 2 tig + u] in
// z[4 j + 2 hf + u], the column in h group j / JM at m = 8 (j % JM) + 2 tig
// + u.  dh: a group's m in the lane, then the quad, in a fixed order; dx0:
// a chunk's Z h of each m summed over its groups pairwise, added to the
// block's sum (DX0_BLOCK chunks), each block's to the item's.
template <int MP>
struct DxbRows {
  static constexpr int GPC = dxb::BN / MP, JM = MP / 8;
  int rows[2], tig;
  float xv[2][JM][2], dacc[2][JM][2], dblk[2][JM][2];

  __device__ DxbRows(const float* __restrict__ x0, int r0, int lane_tig, int N, int M)
      : rows{r0, r0 + 8}, tig(lane_tig) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int jm = 0; jm < JM; ++jm)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int m = 8 * jm + 2 * tig + u;
          xv[hf][jm][u] = rows[hf] < N && m < M
                              ? __ldg(x0 + static_cast<long long>(rows[hf]) * M + m)
                              : 0.f;
          dacc[hf][jm][u] = dblk[hf][jm][u] = 0.f;
        }
  }
  // chunk q's h entries of the rows
  __device__ void load_h(float (&hv)[2][GPC], const float* __restrict__ h, int ldh, int q, int N,
                         int H) const {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int k = 0; k < GPC; ++k) {
        const int hh = q * GPC + k;
        hv[hf][k] = rows[hf] < N && hh < H
                        ? __ldg(h + static_cast<long long>(rows[hf]) * ldh + hh)
                        : 0.f;
      }
  }
  __device__ void epilogue(const float (&z)[dxb::BN / 2], const float (&hv)[2][GPC], int q,
                           int q0, int q1, float* __restrict__ dh, int N, int H) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int k = 0; k < GPC; ++k) {
        float p = 0.f;
#pragma unroll
        for (int jm = 0; jm < JM; ++jm)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            p = fmaf(z[4 * (k * JM + jm) + 2 * hf + u], xv[hf][jm][u], p);
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        const int hh = q * GPC + k;
        if (tig == 0 && rows[hf] < N && hh < H) dh[static_cast<long long>(rows[hf]) * H + hh] = p;
      }
    const bool fold = (q - q0) % dxb::DX0_BLOCK == dxb::DX0_BLOCK - 1 || q == q1 - 1;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int jm = 0; jm < JM; ++jm)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float p[GPC];
#pragma unroll
          for (int k = 0; k < GPC; ++k) p[k] = z[4 * (k * JM + jm) + 2 * hf + u] * hv[hf][k];
#pragma unroll
          for (int w = GPC / 2; w > 0; w /= 2)
#pragma unroll
            for (int k = 0; k < w; ++k) p[k] += p[k + w];
          dblk[hf][jm][u] += p[0];
          if (fold) {
            dacc[hf][jm][u] += dblk[hf][jm][u];
            dblk[hf][jm][u] = 0.f;
          }
        }
  }
  // dx0 of the rows (the split's partial)
  __device__ void store(float* __restrict__ out, int N, int M) const {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int jm = 0; jm < JM; ++jm)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int m = 8 * jm + 2 * tig + u;
          if (rows[hf] < N && m < M)
            out[static_cast<long long>(rows[hf]) * M + m] = dacc[hf][jm][u];
        }
  }
};

// Z = g W on the warpgroup MMA, both operands bf16 from shared memory:
// items i = s RT + rt (split s over chunks [s per, s per + per), row tile
// rt) walked by the persistent blocks in strides of the grid; dh [N, H],
// dx0 [splits][N][M] partials.  gt from cin_round_g_bf16_kernel, wt from
// cin_pad_w_bf16_kernel.
template <int MP, bool ONE>
__global__ void __launch_bounds__(dxb::THREADS, 1)
cin_bwd_dx_bf16_kernel(const uint16_t* __restrict__ gt, const uint16_t* __restrict__ wt,
                       const float* __restrict__ h, int ldh, const float* __restrict__ x0,
                       float* __restrict__ dh, float* __restrict__ dx0, int N, int H, int M,
                       int O, int splits, int per) {
  using namespace dxb;
  static_assert(MP == 8 || MP == 16 || MP == 32 || MP == 64, "MP");
  constexpr int GPC = BN / MP;  // h groups of a chunk
  const DxbPlan plan(O);
  const int RT = (N + BM - 1) / BM, items = RT * splits;
  const int nch = (H + GPC - 1) / GPC;
  uint16_t* gbuf = reinterpret_cast<uint16_t*>(cin_smem);  // [2][BM * KG]
  uint16_t* ring = gbuf + 2 * BM * plan.KG;                 // [stages][BN * KC]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + plan.stages * BN * KC);
  uint64_t* empty = full + plan.stages;
  uint64_t* gfull = empty + plan.stages;
  uint64_t* gempty = gfull + 2;
  const int wgi = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 2 * WG);
    }
    for (int b = 0; b < 2; ++b) {
      tc::mbar_init(&gfull[b], 1);
      tc::mbar_init(&gempty[b], 2 * WG);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {  // the producer: one thread copies g's segments and W's stages
    tc::regs_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0, gi = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int rt = i % RT, q0 = i / RT * per, q1 = min(nch, q0 + per);
        for (int q = q0; q < q1; ++q)
          for (int st = 0; st < plan.nst; ++st) {
            if (st % plan.spg == 0 && (plan.nseg > 1 || q == q0)) {
              const int seg = st / plan.spg, b = gi % 2;
              const int bytes = BM * plan.seg_width(seg) * 2;
              tc::mbar_wait(&gempty[b], ((gi / 2) & 1) ^ 1);
              tc::mbar_arrive_tx(&gfull[b], bytes);
              tc::bulk_copy(gbuf + b * BM * plan.KG,
                            gt + static_cast<long long>(rt) * BM * plan.Oq + seg * BM * plan.KG,
                            bytes, &gfull[b]);
              ++gi;
            }
            const int sl = it % plan.stages, bytes = BN * KC * 2;
            tc::mbar_wait(&empty[sl], ((it / plan.stages) & 1) ^ 1);
            tc::mbar_arrive_tx(&full[sl], bytes);
            tc::bulk_copy(ring + sl * BN * KC,
                          wt + (static_cast<long long>(q) * plan.nst + st) * BN * KC, bytes,
                          &full[sl]);
            ++it;
          }
      }
    }
  } else {  // a consumer: rows R (wgi - 1) .. of each tile
    tc::regs_inc<232>();
    const int c = wgi - 1, t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
    const uint32_t gaddr = tc::smem_addr(gbuf), raddr = tc::smem_addr(ring);
    int it = 0, gi = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const int rt = i % RT, s = i / RT, q0 = s * per, q1 = min(nch, q0 + per);
      DxbRows<MP> rs(x0, rt * BM + c * R + 16 * warp + lane / 4, lane % 4, N, M);
      int gb = 0;
      if constexpr (ONE) {
        // O fits one tensor-core sum (and one g segment): chunks in two
        // accumulator sets, chunk q + 1's MMAs issued before chunk q's
        // epilogue, which they overlap
        int rel = it;  // the oldest stage not yet released
        auto issue = [&](float(&d)[BN / 2], int q) {
          if (q == q0) {
            gb = gi % 2;
            tc::mbar_wait(&gfull[gb], (gi / 2) & 1);
            ++gi;
          }
          tc::fence_regs(d);
          for (int st = 0; st < plan.nst; ++st) {
            const int steps = plan.stage_steps(st), sl = it % plan.stages;
            tc::mbar_wait(&full[sl], (it / plan.stages) & 1);
            ++it;
            const uint32_t ab = gaddr + gb * BM * plan.KG * 2, bb = raddr + sl * BN * KC * 2;
            tc::wgmma_fence();
#pragma unroll
            for (int j = 0; j < KC / 16; ++j) {
              if (j >= steps) break;
              const int ks = st * KC / 16 + j;  // the k16 step in g's segment
              tc::wgmma_bf16_ss<BN>(d, tc::bf16_tile_desc(ab, c * R, ks, plan.KG),
                                    tc::bf16_tile_desc(bb, 0, j, KC), ks);
            }
          }
          tc::wgmma_commit();
        };
        // the oldest chunk's MMAs are done: its stages (and after the item's
        // last chunk, g's buffer) go back to the producer
        auto release = [&](float(&d)[BN / 2], int q) {
          tc::fence_regs(d);
          for (int k = 0; k < plan.nst; ++k, ++rel) tc::mbar_arrive(&empty[rel % plan.stages]);
          if (q == q1 - 1) tc::mbar_arrive(&gempty[gb]);
        };
        float d0[BN / 2], d1[BN / 2], hv0[2][BN / MP], hv1[2][BN / MP];
        if (q0 < q1) {
          rs.load_h(hv0, h, ldh, q0, N, H);
          issue(d0, q0);
        }
        for (int q = q0; q < q1; q += 2) {
          if (q + 1 < q1) {
            rs.load_h(hv1, h, ldh, q + 1, N, H);
            issue(d1, q + 1);
            tc::wgmma_wait<1>();
          } else {
            tc::wgmma_wait<0>();
          }
          release(d0, q);
          rs.epilogue(d0, hv0, q, q0, q1, dh, N, H);
          if (q + 1 == q1) break;
          if (q + 2 < q1) {
            rs.load_h(hv0, h, ldh, q + 2, N, H);
            issue(d0, q + 2);
            tc::wgmma_wait<1>();
          } else {
            tc::wgmma_wait<0>();
          }
          release(d1, q + 1);
          rs.epilogue(d1, hv1, q + 1, q0, q1, dh, N, H);
        }
      } else {
        for (int q = q0; q < q1; ++q) {
          float hv[2][BN / MP];  // loaded ahead of the chunk's MMAs
          rs.load_h(hv, h, ldh, q, N, H);
          // Z: the fp32 sum of the tensor cores' sums
          float sum[BN / 2], d[BN / 2];
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) sum[e] = 0.f;
          int prev = -1, kin = 0;  // the stage whose MMAs may be in flight; channels into the sum
          for (int st = 0; st < plan.nst; ++st) {
            const int seg = st / plan.spg, gw = plan.seg_width(seg), steps = plan.stage_steps(st);
            if (st % plan.spg == 0 && (plan.nseg > 1 || q == q0)) {
              gb = gi % 2;
              tc::mbar_wait(&gfull[gb], (gi / 2) & 1);
              ++gi;
            }
            const int sl = it % plan.stages;
            tc::mbar_wait(&full[sl], (it / plan.stages) & 1);
            ++it;
            // A: this consumer's 64 rows of the segment's tile, B: the
            // stage's 128 columns (bf16 tiles, tc_tf32.cuh)
            const uint32_t ab = gaddr + gb * BM * plan.KG * 2, bb = raddr + sl * BN * KC * 2;
            tc::fence_regs(d);
            tc::wgmma_fence();
#pragma unroll
            for (int j = 0; j < KC / 16; ++j) {
              if (j >= steps) break;
              tc::wgmma_bf16_ss<BN>(
                  d, tc::bf16_tile_desc(ab, c * R, (st % plan.spg) * KC / 16 + j, gw),
                  tc::bf16_tile_desc(bb, 0, j, KC), kin + 16 * j);
            }
            tc::wgmma_commit();
            kin += KC;
            const bool last = st == plan.nst - 1, ends = kin >= SUMK || last;
            const bool seg_end = plan.nseg > 1 && (st % plan.spg == plan.spg - 1 || last);
            if (ends || seg_end) {  // every MMA of this block done
              tc::wgmma_wait<0>();
              tc::fence_regs(d);
              if (prev >= 0) tc::mbar_arrive(&empty[prev]);
              tc::mbar_arrive(&empty[sl]);
              prev = -1;
            } else {  // the previous stage's MMAs done
              tc::wgmma_wait<1>();
              if (prev >= 0) tc::mbar_arrive(&empty[prev]);
              prev = sl;
            }
            if (ends) {
#pragma unroll
              for (int e = 0; e < BN / 2; ++e) sum[e] += d[e];
              kin = 0;
            }
            if (seg_end || (plan.nseg == 1 && last && q == q1 - 1)) tc::mbar_arrive(&gempty[gb]);
          }
          rs.epilogue(sum, hv, q, q0, q1, dh, N, H);
        }
      }
      rs.store(dx0 + static_cast<long long>(s) * N * M, N, M);
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
int launch_dx(const float* g, const float* w, float* wp, const float* h, int ldh,
              const float* x0, float* dh, float* dx0, int N, int H, int M, int O, int splits,
              int chunks_per_split, cudaStream_t stream) {
  constexpr int smem = dx_smem_floats<MP>() * 4;
  cudaError_t err = cudaFuncSetAttribute(
      cin_bwd_dx_kernel<MP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  err = cudaLaunchKernel(cin_bwd_dx_kernel<MP>, grid, dim3(dx::THREADS), args,
                         static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 backward: W's stages, then the persistent blocks (one a SM)
template <int MP>
int launch_dx_bf16(const uint16_t* gt, const float* w, uint32_t* wt, const float* h, int ldh,
                   const float* x0, float* dh, float* dx0, int N, int H, int M, int O,
                   int splits, int per, cudaStream_t stream) {
  const DxbPlan plan(O);
  if (plan.stages < 2 || plan.KG < 16) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int mp = MP, nch = (H + dxb::BN / MP - 1) / (dxb::BN / MP);
  const long long words = static_cast<long long>(nch) * plan.nst * dxb::BN * dxb::KC / 2;
  void* pargs[] = {&w, &H, &M, &mp, &O, &nch, &wt};
  const long long pblocks = words / 256 + 1;
  err = cudaLaunchKernel(cin_pad_w_bf16_kernel,
                         dim3(static_cast<unsigned>(pblocks < 1024 ? pblocks : 1024)), dim3(256),
                         pargs, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one tensor-core sum a chunk where O fits it, in two accumulator sets:
  // chunk q + 1's stages are taken before chunk q's go back, so the ring
  // must hold both
  const bool one = plan.Oq <= dxb::SUMK && plan.nseg == 1 && plan.stages >= 2 * plan.nst;
  auto kernel = one ? cin_bwd_dx_bf16_kernel<MP, true> : cin_bwd_dx_bf16_kernel<MP, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint16_t* wtc = reinterpret_cast<const uint16_t*>(wt);
  const int items = (N + dxb::BM - 1) / dxb::BM * splits;
  void* args[] = {&gt, &wtc, &h, &ldh, &x0, &dh, &dx0, &N, &H, &M, &O, &splits, &per};
  err = cudaLaunchKernel(kernel, dim3(items < sms ? items : sms), dim3(dxb::THREADS), args,
                         static_cast<size_t>(plan.bytes), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// a launch at the group width mp (8, 16, 32 or 64)
template <template <int> class L, class... A>
int dispatch_mp(int mp, A... args) {
  switch (mp) {
    case 8: return L<8>::run(args...);
    case 16: return L<16>::run(args...);
    case 32: return L<32>::run(args...);
    case 64: return L<64>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
template <int MP>
struct DxLaunch {
  template <class... A>
  static int run(A... a) { return launch_dx<MP>(a...); }
};
template <int MP>
struct DxBf16Launch {
  template <class... A>
  static int run(A... a) { return launch_dx_bf16<MP>(a...); }
};

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
  return dispatch_mp<DxLaunch>(
      mp, static_cast<const float*>(g), static_cast<const float*>(w), static_cast<float*>(wp),
      static_cast<const float*>(h), ldh, static_cast<const float*>(x0), static_cast<float*>(dh),
      static_cast<float*>(dx0), N, H, M, O, splits, chunks_per_split,
      static_cast<cudaStream_t>(stream));
}

// bf16 elements of g's row tiles (cin_round_g_bf16's gt) and of W's stages
// (cin_bwd_dx_bf16's wp) for the bf16 backward, or -1 past 2^31 or where the
// shared memory cannot hold two W stages
int cin_bwd_dx_bf16_g_elems(int N, int O) {
  const DxbPlan plan(O);
  const long long n = static_cast<long long>((N + dxb::BM - 1) / dxb::BM) * dxb::BM * plan.Oq;
  return plan.stages < 2 || n > 0x7fffffff ? -1 : static_cast<int>(n);
}
int cin_bwd_dx_bf16_w_elems(int H, int O, int mp) {
  const DxbPlan plan(O);
  const long long n = static_cast<long long>((H + dxb::BN / mp - 1) / (dxb::BN / mp)) *
                      plan.nst * dxb::BN * dxb::KC;
  return plan.stages < 2 || n > 0x7fffffff ? -1 : static_cast<int>(n);
}

// g [N, O] (fp32, contiguous) rounded to bf16 once: gt (16-byte aligned,
// cin_bwd_dx_bf16_g_elems(N, O) bf16) in the bf16 backward's row tiles, and,
// where g_round is not null, g_round [N, O] (fp32), cin_dw's operand.
int cin_round_g_bf16(const void* g, int N, int O, void* g_round, void* gt, void* stream) {
  const int n = cin_bwd_dx_bf16_g_elems(N, O);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int items = n / 8;
  void* args[] = {&g, &N, &O, &g_round, &gt};
  const int blocks = items / 256 + 1 < 2048 ? items / 256 + 1 : 2048;
  const cudaError_t err = cudaLaunchKernel(cin_round_g_bf16_kernel, dim3(blocks), dim3(256), args,
                                           0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The bf16 mode's cin_bwd_dx: Z = g W from g and W rounded to bf16
// (cin_pallas.py:226: the TPU kernel's g^T and W^T in bf16), dh and dx0 from
// the fp32 h and x0.  gt: g's row tiles from cin_round_g_bf16; wp:
// cin_bwd_dx_bf16_w_elems(H, O, mp) bf16 of scratch (16-byte aligned) for W's
// stages; the rest as cin_bwd_dx, on persistent blocks (one a SM) that walk
// the (row tile, split) items.
int cin_bwd_dx_bf16(const void* gt, const void* w, void* wp, const void* h, int ldh,
                    const void* x0, void* dh, void* dx0, int N, int H, int M,
                    int O, int mp, int splits, int chunks_per_split, void* stream) {
  return dispatch_mp<DxBf16Launch>(
      mp, static_cast<const uint16_t*>(gt), static_cast<const float*>(w),
      static_cast<uint32_t*>(wp), static_cast<const float*>(h), ldh,
      static_cast<const float*>(x0), static_cast<float*>(dh), static_cast<float*>(dx0), N, H,
      M, O, splits, chunks_per_split, static_cast<cudaStream_t>(stream));
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
