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
// MB of operands: hundreds of FLOPs per byte, far above the card's fp32 ridge
// (20 FLOP/byte).  So, as in cin_fwd.cu, neither [N, H*M] intermediate (Z or
// the outer product z = h x x0) ever reaches device memory, and the FMA
// pipes run the 128 x 128 tile with 8 x 8 register tiles of cin_tile.cuh:
//   * cin_bwd_dx: one block owns 128 rows and walks the K = H*M columns in
//     chunks of whole h groups, each group's M columns padded to MP (a power
//     of two: 32 at M = 26), so that a chunk is 128 / MP groups.  The chunk's
//     Z tile (a GEMM over O: g rows times W columns, W from L2) stays in
//     registers and is reduced at once: dh by a shuffle over the MP / 4 lanes
//     that hold one group's columns, dx0 by a shuffle over the lanes that hold
//     one m, summed over chunks in shared memory and written at the end.
//     The padded columns cost (MP - M) / M more FLOPs (23% at M = 26); the
//     measured TFLOP/s count only the unpadded work.  A block holds too little
//     work for 132 SMs when N is small, so the chunks are split over
//     gridDim.y: each split writes its own dx0 partial, summed in a fixed
//     order afterwards (deterministic).
//   * cin_dw: the GEMM dW[O, K] = g^T z reduces over N = 40960 rows while the
//     output has only 12 (layer 0) or 26 (layer 1) 128 x 128 tiles, too few
//     for 132 SMs.  So the rows are cut into slices over gridDim.z, each
//     block builds its z tile (h x x0) in shared memory from the rows it
//     owns, writes its partial tile, and cin_sum_slices adds the partials in
//     a fixed order: deterministic, no atomics.
// The TPU kernels summed over rows (dW) and over H chunks along a sequential
// grid axis in their output block (cin_pallas.py:134-144, 209-215) and kept
// dW as [M, O, H]; blocks here run in no order, so the sums are split into
// partials instead and dW keeps the parameter's own [O, H*M] layout.  Ragged
// N, H, M and O edges are masked, not padded.  fp32 FMAs on the CUDA cores;
// tensor cores are a later change of numerics.

#include "cin_tile.cuh"

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
  extern __shared__ __align__(16) float smem[];
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

constexpr int LSTEP = THREADS / BM;  // row slots the loaders cover per pass (2)
constexpr int LPASS = BK / LSTEP;    // values per thread per operand per step (8)
static_assert(BM == BN && THREADS % BM == 0 && BK % LSTEP == 0, "dW loaders");

__global__ void __launch_bounds__(THREADS, 2)
cin_dw_kernel(const float* __restrict__ g, const float* __restrict__ h, int ldh,
              const float* __restrict__ x0, float* __restrict__ part, int N,
              int H, int M, int O, int rows_per_slice) {
  __shared__ __align__(16) float gs[2][BK][ALD];  // g tile, row-major: [row][o]
  __shared__ __align__(16) float zs[2][BK][BN];   // z tile, row-major: [row][k]

  const int K = H * M;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BN;
  const int o0 = blockIdx.y * BM;
  const int n_begin = blockIdx.z * rows_per_slice;
  const int n_end = min(N, n_begin + rows_per_slice);
  const int tr = tid / (BN / TN);  // output rows are channels o
  const int tc = tid % (BN / TN);  // output columns are k = h*M + m

  // loaders: column lc (an o for g, a k for z), row slots ls + p * LSTEP;
  // a warp reads 32 consecutive o (or k) of one row
  const int lc = tid % BM;
  const int ls = tid / BM;
  const bool o_ok = o0 + lc < O;
  const int k = k0 + lc;
  const bool k_ok = k < K;
  const int zh = k_ok ? k / M : 0;
  const int zm = k_ok ? k - zh * M : 0;

  float greg[LPASS];
  float zreg[LPASS];
  auto load_chunk = [&](int n0) {
#pragma unroll
    for (int p = 0; p < LPASS; ++p) {
      const int n = n0 + ls + p * LSTEP;
      const bool n_ok = n < n_end;
      greg[p] = (n_ok && o_ok) ? __ldg(g + n * O + o0 + lc) : 0.f;
      zreg[p] = (n_ok && k_ok) ? cin::z_at(h + n * ldh, x0 + n * M, zh, zm) : 0.f;
    }
  };
  auto store_chunk = [&](int buf) {
#pragma unroll
    for (int p = 0; p < LPASS; ++p) {
      gs[buf][ls + p * LSTEP][lc] = greg[p];
      zs[buf][ls + p * LSTEP][lc] = zreg[p];
    }
  };

  float acc[TM][TN];
  cin::tile_zero(acc);
  load_chunk(n_begin);
  store_chunk(0);
  __syncthreads();
  int buf = 0;
  for (int n0 = n_begin; n0 < n_end; n0 += BK) {
    const bool more = n0 + BK < n_end;
    if (more) load_chunk(n0 + BK);
    cin::tile_fma(gs[buf], zs[buf], tr, tc, acc);
    if (more) store_chunk(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  float* out = part + (long long)blockIdx.z * O * K;
  const bool vec_ok = (K & 3) == 0;  // rows start 16-byte aligned
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int o = o0 + cin::tile_row(tr, i);
    if (o >= O) continue;
    float* orow = out + o * K;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = k0 + cin::tile_col(tc, half * 4);
      const int j0 = half * 4;
      if (vec_ok && c + 3 < K) {
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(acc[i][j0], acc[i][j0 + 1], acc[i][j0 + 2], acc[i][j0 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < K) orow[c + j] = acc[i][j0 + j];
      }
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
  cin_bwd_dx_kernel<MP><<<grid, THREADS, smem, stream>>>(
      g, w, h, ldh, x0, dh, dx0, N, H, M, O, chunks_per_split);
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

// part [slices, O, H*M]: slice s sums rows [s * rows_per_slice, ...).
int cin_dw(const void* g, const void* h, int ldh, const void* x0, void* part,
           int N, int H, int M, int O, int slices, int rows_per_slice,
           void* stream) {
  const dim3 grid((H * M + BN - 1) / BN, (O + BM - 1) / BM, slices);
  cin_dw_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(h), ldh,
      static_cast<const float*>(x0), static_cast<float*>(part), N, H, M, O,
      rows_per_slice);
  return static_cast<int>(cudaGetLastError());
}

// out [n] = sum over s of part [slices, n]
int cin_sum_slices(const void* part, int slices, long long n, void* out,
                   int blocks, void* stream) {
  cin_sum_slices_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), slices, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* cin_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
