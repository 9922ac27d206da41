// CIN forward contraction for Hopper (sm_90a), behind a plain C interface
// that ops/cin_cuda.py loads with ctypes.
//
//   out[r, o] = b[o] + sum_{h, m} h_rows[r, h] * x0_rows[r, m] * W[o, h*M + m]
//
// h_rows [N, H] (row stride ldh), x0_rows [N, M], W^T [H*M, O], b [O] and
// out [N, O] are fp32.  Rows r are (example, embedding-dim) pairs, so one
// canonical xDeepFM scoring batch has N = 8192 * 10 = 81920 rows.
//
// Replaces: xdeepfm_tpu/ops/cin_pallas.py _fused_contract / _fwd_kernel.
//
// Bound: operations.  A canonical batch moves about 100 MB (h, x0, W and the
// output, each once) but does 98 GFLOP (layer 0: 2*N*676*256, layer 1:
// 2*N*3328*128): about 1000 FLOP per byte, far above the card's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte).  So the design spends nothing
// on bytes it does not have to move and keeps the FMA pipes fed:
//   * the [N, H*M] outer product z never exists in device memory (the point
//     of the TPU kernel too): each block builds its [BK, BM] z tile in shared
//     memory from h and x0, whose rows stay in L1 across the K walk;
//   * the z loader gives each half-warp 16 consecutive k of one row, so a
//     warp's loads of h and x0 touch a few cache lines, not one per row, and
//     it keeps (k / M, k % M) as a running pair instead of dividing;
//   * the next chunk's z and W^T values are loaded into registers while the
//     current chunk computes from the other of two shared buffers, so global
//     latency hides behind the FMAs and each chunk needs one barrier;
//   * a 128 x 128 output tile per block and an 8 x 8 register tile per
//     thread give 64 FMAs for every four 16-byte shared-memory loads; each
//     thread's 8 rows (and 8 channels) are two groups of 4, 64 apart, so a
//     warp's float4 loads are served without bank conflicts.
// The TPU kernel summed H chunks across a sequential grid axis in its output
// block; blocks here run in no order, so the whole K = H*M walk is a loop in
// the block.  The TPU padded rows to its row tile; this kernel masks the
// ragged row, channel and K edges instead.  fp32 FMAs on the CUDA cores:
// tensor cores (TF32/bf16 wgmma) are a later, opt-in change of numerics.

#include "cin_tile.cuh"

namespace {

using cin::BK;
using cin::BM;
using cin::BN;
using cin::THREADS;
constexpr int ZLD = cin::ALD;           // z tile row, padded
constexpr int ZROWS = THREADS / BK;     // rows the z loader covers per pass
constexpr int ZPASS = BM / ZROWS;       // z values per thread per chunk
constexpr int WSTEP = THREADS / BN;     // k slots the W^T loader covers per pass
constexpr int WPASS = BK / WSTEP;       // W^T values per thread per chunk
static_assert(THREADS % BK == 0 && BM % ZROWS == 0, "z loader");
static_assert(THREADS % BN == 0 && BK % WSTEP == 0, "W^T loader");

__global__ void __launch_bounds__(THREADS, 2)
cin_fwd_kernel(const float* __restrict__ h, int ldh,
               const float* __restrict__ x0, const float* __restrict__ wt,
               const float* __restrict__ bias, float* __restrict__ out,
               int N, int H, int M, int O) {
  __shared__ __align__(16) float zs[2][BK][ZLD];  // z tile, k-major: [k][row]
  __shared__ __align__(16) float ws[2][BK][BN];   // W^T tile: [k][channel]

  const int K = H * M;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tr = tid / (BN / cin::TN);  // this thread's row group, 0..15
  const int tc = tid % (BN / cin::TN);  // this thread's channel group, 0..15

  // z loader: k slot zk of every chunk, rows zr + p * ZROWS.  (zh, zm) is
  // (k / M, k % M) for this thread's k in the chunk being loaded.
  const int zk = tid % BK;
  const int zr = tid / BK;
  int zh = zk / M;
  int zm = zk - zh * M;
  const int rows_left = N - row0 - zr;  // pass p is in range iff p*ZROWS < this
  const float* hz = h + (row0 + zr) * ldh;
  const float* xz = x0 + (row0 + zr) * M;
  // W^T loader: channel wc, k slots wk + p * WSTEP (coalesced across wc).
  const int wc = tid % BN;
  const int wk = tid / BN;
  const bool col_ok = col0 + wc < O;
  const float* wz = wt + col0 + wc;

  float zreg[ZPASS];
  float wreg[WPASS];
  auto load_chunk = [&](int k0) {
    const bool k_ok = zh < H;
#pragma unroll
    for (int p = 0; p < ZPASS; ++p) {
      zreg[p] = (k_ok && p * ZROWS < rows_left)
                    ? cin::z_at(hz + p * ZROWS * ldh, xz + p * ZROWS * M, zh, zm)
                    : 0.f;
    }
#pragma unroll
    for (int p = 0; p < WPASS; ++p) {
      const int k = k0 + wk + p * WSTEP;
      wreg[p] = (col_ok && k < K) ? __ldg(wz + k * O) : 0.f;
    }
  };
  auto store_chunk = [&](int buf) {
#pragma unroll
    for (int p = 0; p < ZPASS; ++p) zs[buf][zk][zr + p * ZROWS] = zreg[p];
#pragma unroll
    for (int p = 0; p < WPASS; ++p) ws[buf][wk + p * WSTEP][wc] = wreg[p];
  };

  float acc[cin::TM][cin::TN];
  cin::tile_zero(acc);

  load_chunk(0);
  store_chunk(0);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) {
      zm += BK;
      while (zm >= M) {
        zm -= M;
        ++zh;
      }
      load_chunk(k0 + BK);
    }
    cin::tile_fma(zs[buf], ws[buf], tr, tc, acc);
    // The other buffer was last read before the previous barrier.
    if (more) store_chunk(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  // Epilogue: add the bias and store, masking the ragged row/channel edges.
  const bool vec_ok = (O & 3) == 0;  // rows start 16-byte aligned
#pragma unroll
  for (int i = 0; i < cin::TM; ++i) {
    const int r = row0 + cin::tile_row(tr, i);
    if (r >= N) continue;
    float* orow = out + (long long)r * O;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = col0 + half * (BN / 2) + tc * 4;
      const int j0 = half * 4;
      if (vec_ok && c + 3 < O) {
        float4 o4;
        o4.x = acc[i][j0] + __ldg(bias + c);
        o4.y = acc[i][j0 + 1] + __ldg(bias + c + 1);
        o4.z = acc[i][j0 + 2] + __ldg(bias + c + 2);
        o4.w = acc[i][j0 + 3] + __ldg(bias + c + 3);
        *reinterpret_cast<float4*>(orow + c) = o4;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < O) orow[c + j] = acc[i][j0 + j] + __ldg(bias + c + j);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).  The
// caller has checked shapes, dtypes, devices, N, O > 0 and that every
// element offset (N*ldh, N*M, H*M*O) fits in 32 bits.
int cin_fwd(const void* h, int ldh, const void* x0, const void* wt,
            const void* bias, void* out, int N, int H, int M, int O,
            void* stream) {
  const dim3 grid((N + BM - 1) / BM, (O + BN - 1) / BN);
  cin_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), ldh, static_cast<const float*>(x0),
      static_cast<const float*>(wt), static_cast<const float*>(bias),
      static_cast<float*>(out), N, H, M, O);
  return static_cast<int>(cudaGetLastError());
}

const char* cin_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
