// Softmax cross-entropy of vocabulary-sized heads, backward, for Hopper
// (sm_90a), behind a plain C interface that ops/ce_cuda.py loads with ctypes.
// With the forward's logz [F, B] and the output gradient g [F, B], for rows
// r < num_valid (every other row takes and gives no gradient):
//
//   dS[f, r, v] = (exp(S[f, r, v] - logz[f, r]) - [v == t[f, r]]) * g[f, r]
//   dh[r, :]    = sum_f sum_v dS[f, r, v] * W[f, v, :]     (summed over heads)
//   dW[f, v, :] = sum_r dS[f, r, v] * h[r, :]
//   db[f, v]    = sum_r dS[f, r, v]
//
// where S = h W^T + b is recomputed tile by tile, never stored.  Layouts and
// types as in ce_fwd.cu.  Under "bf16" the products round h, W and dS to bf16
// (as the TPU kernel's bf16 dots did); db sums dS in fp32.
//
// Replaces: xdeepfm_tpu/ops/ce_pallas.py _ce_bwd / _bwd_kernel (one head) and
// _ces_bwd / _bwd_kernel_stacked (F heads in one launch).
//
// Bound: operations.  The least work is the logit recompute plus the two
// gradient products, 3 * 2*nv*K*V*F FLOPs (413 GFLOP at the canonical Pro
// step with nv = B = 4096, K = 64, F = 26, V = 10112), against W, dW and a few
// MB of row data in bytes.  The TPU kernel carried dW/db in its output block
// along a sequential batch axis and dh in VMEM for the whole grid; Hopper's
// blocks run in no order and nothing carries between them, so the work is
// split by what each block owns, and every sum is taken in a fixed order
// (deterministic, no atomics):
//   * ce_dw_kernel owns a 128-column vocabulary tile of one head, dW [128, K]
//     and db [128] in registers, and walks the valid rows 128 at a time:
//     logit tile (h rows x W tile, both in shared memory), dS in registers,
//     dS to shared memory, then dW += dS^T h.  Where heads x tiles fill the
//     card too thinly (one head), the rows are cut into slices over
//     gridDim.z whose partials ce_sum_slices adds in order;
//   * ce_dh_kernel owns 128 rows of dh [128, K] in registers and walks a
//     range of (head, vocabulary tile) pairs: the transposed logit tile, dS
//     in registers, dS to shared memory, then dh += dS W.  The pairs are
//     split over gridDim.y so that B / 128 row tiles fill the card; each
//     split writes a partial dh that ce_sum_slices adds in order.
// So each kernel recomputes the logits once: 4 * 2*nv*K*V*F FLOPs in all,
// a third more than the least.  Tiles with no valid row do no work and write
// zeros, so every output is defined at num_valid = 0.  Ragged B, V and K are
// masked, not padded.

#include <cmath>

#include "ce_tile.cuh"

namespace {

using ce::BK;
using ce::BM;
using ce::BN;
using ce::KLD;
using ce::KMAX;
using ce::LD;
using ce::THREADS;

int dw_smem_bytes(int kp) { return (kp * LD + BM * KLD + BM * LD + BN + 3 * BM) * 4; }
int dh_smem_bytes(int kp) { return (kp * LD + BN * KLD + BN * LD + BN + 3 * BM) * 4; }

__device__ __forceinline__ void store_row(float* dst, const float (&v)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + BN / 2) = make_float4(v[4], v[5], v[6], v[7]);
}

// grid (vocabulary tiles, heads, row slices); dw [slices][F][V][K] and
// db [slices][F][V] (the outputs themselves when slices == 1)
__global__ void __launch_bounds__(THREADS, 1)
ce_dw_kernel(const float* __restrict__ h, const float* __restrict__ w,
             const float* __restrict__ bias, const long long* __restrict__ tgt,
             const float* __restrict__ logz, const float* __restrict__ g,
             const int* __restrict__ nv_ptr, float* __restrict__ dw,
             float* __restrict__ db, int B, int K, int V, int F, int rows_per_slice,
             int bf16) {
  const int KP = ce::round_up(K, BK);
  float* ws = ce_smem;              // [KP][LD]: W tile, k-major (columns v)
  float* hr = ws + KP * LD;         // [BM][KLD]: h rows, row-major
  float* dss = hr + BM * KLD;       // [BM][LD]: dS[r][v]
  float* bs = dss + BM * LD;        // [BN]: bias
  float* lz = bs + BN;              // [BM]: logz of the rows
  float* gg = lz + BM;              // [BM]: g of the rows
  int* tt = reinterpret_cast<int*>(gg + BM);  // [BM]: targets of the rows

  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int v0 = blockIdx.x * BN;
  const int f = blockIdx.y;
  const int slice = blockIdx.z;
  const int nv = ce::valid_rows(nv_ptr, B);
  const int r_begin = slice * rows_per_slice;
  const int r_end = min(nv, r_begin + rows_per_slice);
  const float* w_f = w + (long long)f * V * K;
  const float* lz_f = logz + (long long)f * B;
  const float* g_f = g + (long long)f * B;
  const long long* t_f = tgt + (long long)f * B;

  for (int e = tid; e < BN * KP; e += THREADS) {
    const int v = e / KP;
    const int k = e - v * KP;
    ws[k * LD + v] = (v0 + v < V && k < K)
                         ? ce::operand(__ldg(w_f + (long long)(v0 + v) * K + k), bf16)
                         : 0.f;
  }
  for (int v = tid; v < BN; v += THREADS)
    bs[v] = v0 + v < V ? __ldg(bias + (long long)f * V + v0 + v) : 0.f;

  float out[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) out[i][q] = 0.f;
  float dbp[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) dbp[j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += BM) {
    __syncthreads();  // the previous chunk's products are done with hr and dss
    for (int e = tid; e < BM * KMAX; e += THREADS) {
      const int r = e / KMAX;
      const int k = e - r * KMAX;
      const int row = r0 + r;
      hr[r * KLD + k] = (row < r_end && k < K) ? ce::operand(__ldg(h + row * K + k), bf16) : 0.f;
    }
    for (int r = tid; r < BM; r += THREADS) {
      const int row = r0 + r;
      const bool ok = row < r_end;
      lz[r] = ok ? __ldg(lz_f + row) : 0.f;
      gg[r] = ok ? __ldg(g_f + row) : 0.f;
      tt[r] = ok ? static_cast<int>(__ldg(t_f + row)) : -1;
    }
    __syncthreads();

    float acc[8][8];
    ce::zero(acc);
    ce::mma_rk(hr, ws, LD, KP, tr, tc, acc);  // acc[i][j] = S[r_i][v_j] - b[v_j]
    float bv[8];
    bool vok[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int v = ce::tile_col(tc, j);
      bv[j] = bs[v];
      vok[j] = v0 + v < V;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ce::tile_row(tr, i);
      const bool rok = r0 + r < r_end;
      const float lzr = lz[r];
      const float gr = gg[r];
      const int lt = tt[r] - v0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float d = 0.f;
        if (rok && vok[j]) {
          const float onehot = ce::tile_col(tc, j) == lt ? 1.f : 0.f;
          d = (__expf(acc[i][j] + bv[j] - lzr) - onehot) * gr;
        }
        dbp[j] += d;
        acc[i][j] = ce::operand(d, bf16);
      }
      store_row(dss + r * LD + tc * 4, acc[i]);
    }
    __syncthreads();
    ce::mma_out_k(dss, hr, BM, tr, tc, out);  // out[v_i][k_q] += sum_r dS[r][v] h[r][k]
  }

  float* dw_s = dw + ((long long)slice * F + f) * V * K;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int v = v0 + ce::tile_row(tr, i);
    if (v >= V) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = tc * 4 + q;
      if (k < K) dw_s[(long long)v * K + k] = out[i][q];
    }
  }
  // db: the 16 threads that share a column add their row sums in order of tr
  __syncthreads();
  float* red = dss;  // [16][BN]
#pragma unroll
  for (int j = 0; j < 8; ++j) red[tr * BN + ce::tile_col(tc, j)] = dbp[j];
  __syncthreads();
  if (tid < BN && v0 + tid < V) {
    float s = 0.f;
    for (int q = 0; q < THREADS / 16; ++q) s += red[q * BN + tid];
    db[((long long)slice * F + f) * V + v0 + tid] = s;
  }
}

// grid (row tiles, splits of the (head, vocabulary tile) pairs);
// dh [splits][B][K] (the output itself when splits == 1)
__global__ void __launch_bounds__(THREADS, 1)
ce_dh_kernel(const float* __restrict__ h, const float* __restrict__ w,
             const float* __restrict__ bias, const long long* __restrict__ tgt,
             const float* __restrict__ logz, const float* __restrict__ g,
             const int* __restrict__ nv_ptr, float* __restrict__ dh, int B, int K, int V,
             int F, int pairs_per_split, int bf16) {
  const int KP = ce::round_up(K, BK);
  float* hk = ce_smem;              // [KP][LD]: h tile, k-major (columns r)
  float* wr = hk + KP * LD;         // [BN][KLD]: W tile, row-major
  float* dss = wr + BN * KLD;       // [BN][LD]: dS^T[v][r]
  float* bs = dss + BN * LD;        // [BN]: bias
  float* lz = bs + BN;              // [BM]
  float* gg = lz + BM;              // [BM]
  int* tt = reinterpret_cast<int*>(gg + BM);  // [BM]

  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int nv = ce::valid_rows(nv_ptr, B);
  float* out = dh + (long long)split * B * K;

  if (row0 >= nv) {  // no valid row: a zero partial
    for (int e = tid; e < BM * K; e += THREADS) {
      const int row = row0 + e / K;
      if (row < B) out[row * K + e % K] = 0.f;
    }
    return;
  }
  for (int e = tid; e < BM * KP; e += THREADS) {
    const int r = e / KP;
    const int k = e - r * KP;
    const int row = row0 + r;
    hk[k * LD + r] = (row < nv && k < K) ? ce::operand(__ldg(h + row * K + k), bf16) : 0.f;
  }

  const int n_vt = (V + BN - 1) / BN;
  const int p_begin = split * pairs_per_split;
  const int p_end = min(F * n_vt, p_begin + pairs_per_split);
  float acc2[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc2[i][q] = 0.f;

  int f_rows = -1;  // the head whose row values lz, gg, tt hold
  for (int p = p_begin; p < p_end; ++p) {
    const int f = p / n_vt;
    const int v0 = (p - f * n_vt) * BN;
    const float* w_f = w + (long long)f * V * K;
    __syncthreads();  // the previous pair's products are done with wr, dss and the rows
    for (int e = tid; e < BN * KMAX; e += THREADS) {
      const int v = e / KMAX;
      const int k = e - v * KMAX;
      wr[v * KLD + k] = (v0 + v < V && k < K)
                            ? ce::operand(__ldg(w_f + (long long)(v0 + v) * K + k), bf16)
                            : 0.f;
    }
    for (int v = tid; v < BN; v += THREADS)
      bs[v] = v0 + v < V ? __ldg(bias + (long long)f * V + v0 + v) : 0.f;
    if (f != f_rows) {
      for (int r = tid; r < BM; r += THREADS) {
        const int row = row0 + r;
        const bool ok = row < nv;
        lz[r] = ok ? __ldg(logz + (long long)f * B + row) : 0.f;
        gg[r] = ok ? __ldg(g + (long long)f * B + row) : 0.f;
        tt[r] = ok ? static_cast<int>(__ldg(tgt + (long long)f * B + row)) : -1;
      }
      f_rows = f;
    }
    __syncthreads();

    float acc[8][8];
    ce::zero(acc);
    ce::mma_rk(wr, hk, LD, KP, tr, tc, acc);  // acc[i][j] = S[r_j][v_i] - b[v_i]
    float lzr[8], ggr[8];
    int ltr[8];
    bool rok[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = ce::tile_col(tc, j);
      lzr[j] = lz[r];
      ggr[j] = gg[r];
      ltr[j] = tt[r] - v0;
      rok[j] = row0 + r < nv;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int v = ce::tile_row(tr, i);
      const bool vok = v0 + v < V;
      const float bvi = bs[v];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float d = 0.f;
        if (vok && rok[j]) {
          const float onehot = v == ltr[j] ? 1.f : 0.f;
          d = (__expf(acc[i][j] + bvi - lzr[j]) - onehot) * ggr[j];
        }
        acc[i][j] = ce::operand(d, bf16);
      }
      store_row(dss + v * LD + tc * 4, acc[i]);
    }
    __syncthreads();
    ce::mma_out_k(dss, wr, BN, tr, tc, acc2);  // acc2[r_i][k_q] += sum_v dS[r][v] W[v][k]
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + ce::tile_row(tr, i);
    if (row >= B) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = tc * 4 + q;
      if (k < K) out[row * K + k] = acc2[i][q];
    }
  }
}

// out[i] = sum_s part[s * n + i], s = 0, 1, ... in order: deterministic
__global__ void ce_sum_slices_kernel(const float* __restrict__ part, int slices, long long n,
                                     float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float s = 0.f;
    for (int t = 0; t < slices; ++t) s += __ldg(part + t * n + i);
    out[i] = s;
  }
}

cudaError_t sum_slices(const float* part, int slices, long long n, float* out,
                       cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  const dim3 grid(static_cast<unsigned>(blocks < 2048 ? blocks : 2048));
  void* args[] = {&part, &slices, &n, &out};
  return cudaLaunchKernel(ce_sum_slices_kernel, grid, dim3(256), args, 0, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).  The
// caller has checked dtypes, shapes, contiguity, 1 <= K <= 64, B, V, F >= 1
// and 32-bit element offsets, and allocated the outputs dh [B, K],
// dw [F, V, K], db [F, V] and, where splits > 1 or slices > 1, the partials
// dh_part [splits, B, K], dw_part [slices, F, V, K], db_part [slices, F, V].
// ce_dh_kernel's split s walks (head, vocabulary tile) pairs
// [s * pairs_per_split, (s + 1) * pairs_per_split) in the order f * tiles + t;
// ce_dw_kernel's slice s walks rows [s * rows_per_slice, ...).
int ce_bwd(const void* h, const void* w, const void* b, const void* t, const void* logz,
           const void* g, const void* nv, void* dh, void* dh_part, int splits,
           int pairs_per_split, void* dw, void* db, void* dw_part, void* db_part, int slices,
           int rows_per_slice, int B, int K, int V, int F, int bf16, void* stream) {
  const int kp = ce::round_up(K, BK);
  const int dw_smem = dw_smem_bytes(kp);
  const int dh_smem = dh_smem_bytes(kp);
  cudaError_t err = cudaFuncSetAttribute(
      ce_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ce_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dh_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  const long long* tp = static_cast<const long long*>(t);
  const float* lzp = static_cast<const float*>(logz);
  const float* gp = static_cast<const float*>(g);
  const int* nvp = static_cast<const int*>(nv);

  float* dwo = static_cast<float*>(slices > 1 ? dw_part : dw);
  float* dbo = static_cast<float*>(slices > 1 ? db_part : db);
  void* dw_args[] = {&hp, &wp, &bp, &tp, &lzp, &gp, &nvp, &dwo, &dbo,
                     &B, &K, &V, &F, &rows_per_slice, &bf16};
  err = cudaLaunchKernel(ce_dw_kernel, dim3((V + BN - 1) / BN, F, slices), dim3(THREADS),
                         dw_args, static_cast<size_t>(dw_smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  float* dho = static_cast<float*>(splits > 1 ? dh_part : dh);
  void* dh_args[] = {&hp, &wp, &bp, &tp, &lzp, &gp, &nvp, &dho,
                     &B, &K, &V, &F, &pairs_per_split, &bf16};
  err = cudaLaunchKernel(ce_dh_kernel, dim3((B + BM - 1) / BM, splits), dim3(THREADS), dh_args,
                         static_cast<size_t>(dh_smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  if (slices > 1) {
    err = sum_slices(dwo, slices, (long long)F * V * K, static_cast<float*>(dw), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = sum_slices(dbo, slices, (long long)F * V, static_cast<float*>(db), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (splits > 1) {
    err = sum_slices(dho, splits, (long long)B * K, static_cast<float*>(dh), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ce_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
