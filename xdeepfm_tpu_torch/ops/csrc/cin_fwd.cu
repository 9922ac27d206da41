// CIN forward contraction for Hopper (sm_90a), behind a plain C interface
// that ops/cin_cuda.py loads with ctypes.
//
//   out[r, o] = b[o] + sum_{h, m} h_rows[r, h] * x0_rows[r, m] * W[o, h*M + m]
//
// h_rows [N, H] (row stride ldh), x0_rows [N, M], W [O, H*M], b [O] and
// out [N, O] are fp32.  Rows r are (example, embedding-dim) pairs, so one
// canonical xDeepFM scoring batch has N = 8192 * 10 = 81920 rows.
//
// Replaces: xdeepfm_tpu/ops/cin_pallas.py _fused_contract / _fwd_kernel.
//
// Bound: operations.  A canonical scoring batch moves about 100 MB (h, x0,
// W and the output, each once) but does 98 GFLOP (layer 0: 2*N*676*256,
// layer 1: 2*N*3328*128): about 1000 FLOP per byte.  In 3xTF32 on the tensor
// cores (tc_tf32.cuh: three TF32 products for each fp32 one, 165 of the
// H100 SXM's 495 TFLOP/s) the train batch's two launches are bound at
// 0.297 ms, against 0.732 ms on the fp32 FMA pipes.
//
// Design: a GEMM out = z W^T whose left operand z[r, k] = h[r, h] x0[r, m]
// (the [N, H*M] outer product) never exists in device memory, on the
// warpgroup MMA (wgmma m64n128k8 tf32), A from registers, B from shared
// memory:
//   * K is walked in the order k' = m * Hp + h, H padded to Hp (a multiple
//     of 8, at most 128: the wrapper cuts wider h into blocks and adds
//     their outputs in order), so a k8 step has one m: a thread's four A
//     values are four h entries of its two rows times their x0[r, m].  Each
//     thread builds its A fragment from h and x0 rows staged in shared
//     memory once a row tile, and splits it once into TF32 halves: about
//     20 instructions a k8 step against three m64n128k8 wgmmas, 192 clocks
//     of the SM's tensor cores (the padding costs 23% more MMAs at H = 26).
//   * B = W, split once a launch by a first kernel (cin_fwd_split_w) into
//     its TF32 halves and written in (k', column) order, zero-padded, tile
//     by tile in the exact layout of one shared-memory stage: 8 x 4 core
//     matrices of 128 bytes, unswizzled.  A stage (KC k' x 128 columns, big
//     and small) is then one contiguous bulk copy (cp.async.bulk) completed
//     on an mbarrier, which a producer thread issues into a ring of up to
//     four stages while the consumers compute; no tensor map.
//   * A block is three warpgroups: the producer (setmaxnreg down to 40
//     registers) and two consumers (up to 232), each owning 64 rows of the
//     block's 128-row tile and sharing every W stage.  Blocks are
//     persistent, one a SM, and walk row tiles in strides of the grid; a
//     row tile's h and x0 are staged once (cp.async, zero past N, H and M)
//     and serve its every 128-column tile.  Where the tiles leave a last
//     round under half the grid (the train batch: 320 tiles on 132 SMs),
//     those tiles' K walks are cut into up to four parts, a block each,
//     whose sums a third kernel (cin_fwd_sum_parts) adds in order.  Against
//     a build that walks every tile whole (xdeepfm_tpu_torch/scripts/
//     bench_cin_fwd.py run from both, in turns, on an NVIDIA H100 80GB HBM3
//     at 700 W), the split took 6-7% off layer 0 and 10-12% off layer 1 at
//     batch 4096; at batch 8192, where nothing is split, the whole-tile
//     build ran 2-3% faster.
//   * Accumulation keeps mma3_add's rule in a form wgmma allows: the tensor
//     cores' fp32 sums truncate, so a long sum in the accumulator drifts
//     (tc_tf32.cuh).  Each chunk of KC k' is summed in the tensor core from
//     zero (scale-d 0 on its first MMA) and, after wait_group, added to an
//     fp32 register sum, rounded to nearest.  The other consumer's MMAs
//     fill the tensor cores while one builds A and adds.  KC = 16 (below).
//   * Rows past N are zero rows and not written; columns past O and k'
//     past the padded K are zero in the split W.  No atomics and one
//     fixed summation order: bit-equal from run to run.
// Measured (chip_smoke.py, an NVIDIA H100 80GB HBM3 at 700.00 W): 0.589-0.590
// ms a train step (layer 0 0.228-0.232, layer 1 0.358-0.362), half the
// 3xTF32 bound, against 1.62 for the fp32-FMA tile this replaced; a scoring
// batch's two launches 1.09 ms (2.78-2.79); errors against float64 0.25x
// (train layer 0) to 0.99x (train layer 1) the plain fp32 version's.
// Neither the MMAs nor the copies bound it: the chain a consumer runs
// between its MMA batches (build, wait, fp32 add) does, with two consumers
// to cover each other.
// The TPU kernel (cin_pallas.py:60-75) summed m steps of [R, H] x [H, O]
// products, and H chunks across a sequential grid axis, in its VMEM
// output block; its k order is this kernel's, and its H chunks are the
// wrapper's h blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tf32.cuh"

// the dynamic shared memory: the W ring, then h and x0 rows, then barriers
extern __shared__ __align__(128) float cin_smem[];

namespace {

constexpr int WG = 128;          // threads of a warpgroup
constexpr int THREADS = 3 * WG;  // the producer warpgroup, then two consumers
constexpr int R = 64;            // rows of a consumer: one m64 tile
constexpr int BM = 2 * R;        // rows of a tile
constexpr int BN = 128;          // columns of a tile: one m64n128k8 wgmma
constexpr int HMAX = 128;        // padded h columns one launch takes
constexpr int MAX_STAGES = 4;
constexpr int MAX_SPLITS = 4;       // K parts of a tail tile
// k' summed in the tensor cores before each fp32 add.  At the serving and
// train layer-1 shapes (K 3328; an NVIDIA H100 80GB HBM3 at 700 W, by a
// chunk sweep since removed) KC 8, 16 and 32 all passed the float64 gate
// with margin (errors 0.43x / 0.29x / 0.24x the plain fp32 version's at
// serving, 1.14x / 0.99x / 0.73x at train); KC 16 ran 0.003-0.022 ms (1-3%)
// a launch faster than 32 and a third faster than 8, so it is taken over
// the longest chunk that passes.
constexpr int KC = 16;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one Hopper block may take

// The launch's plan, the same on the host and the device.
struct Plan {
  int Hp;      // h columns padded to a multiple of 8
  int HS;      // staged h row pitch: 4 mod 32 floats, so a warp's fragment loads miss no bank
  int nch;     // chunks of KC k' over the padded K = M * Hp
  int MPAD;    // staged x0 columns: every m the chunks reach, zero past M
  int XS;      // staged x0 row pitch, odd
  int stage;   // floats of one ring stage (W's big and small halves)
  int stages;  // ring stages (0: the rows do not fit)
  int bytes;   // dynamic shared memory
  // Tiles: RT of BM rows, each over every column tile.  The first `whole`
  // are walked whole by the persistent blocks in strides of the grid; the
  // rest (under one round) are cut into `splits` parts along K, one a
  // block, whose sums cin_fwd_sum_parts adds in order.
  int RT, whole, splits, blocks;

  __host__ __device__ Plan(int N, int H, int M, int grid) {
    Hp = (H + 7) / 8 * 8;
    HS = Hp + ((36 - Hp % 32) % 32);
    nch = (M * Hp + KC - 1) / KC;
    MPAD = (nch * KC + Hp - 1) / Hp;
    XS = MPAD | 1;
    stage = 2 * BN * KC;
    const int rows = BM * (HS + XS) * 4 + 2 * MAX_STAGES * 8;
    stages = (SMEM_LIMIT - rows) / (stage * 4);
    if (stages > MAX_STAGES) stages = MAX_STAGES;
    bytes = stages * stage * 4 + BM * (HS + XS) * 4 + 2 * stages * 8;
    RT = (N + BM - 1) / BM;
    const int left = RT % grid;
    splits = left ? grid / left : 1;
    if (splits > MAX_SPLITS) splits = MAX_SPLITS;
    if (splits > nch) splits = nch;
    if (splits < 2) splits = 1;
    whole = splits > 1 ? RT - left : RT;
    blocks = splits > 1 ? grid : (RT < grid ? RT : grid);
  }
  // entries of one part: the split tiles' rows below N, O columns each
  __host__ __device__ long long part_size(int N, int O) const {
    return splits > 1 ? static_cast<long long>(N - whole * BM) * O : 0;
  }
};

// W [O, ldw] (k = h*M + m, columns h0 + [0, H)) into wsp: for each column
// tile ct and chunk ch, the big then the small TF32 halves of the stage's
// KC x BN block, element (n, kk) at ((n / 8) (KC / 4) + kk / 4) 32 +
// (n % 8) 4 + kk % 4, k' = ch KC + kk = m Hp + h; zero past O, M and H.
__global__ void cin_fwd_split_w(const float* __restrict__ w, int ldw, int h0, int H, int M,
                                int O, int Hp, int nch, int ct_count,
                                uint32_t* __restrict__ wsp) {
  constexpr int TILE = BN * KC;
  const long long total = static_cast<long long>(ct_count) * nch * TILE;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int e = static_cast<int>(i % TILE);
    const long long blk = i / TILE;  // ct * nch + ch
    const int ch = static_cast<int>(blk % nch), ct = static_cast<int>(blk / nch);
    const int cm = e / 32, in = e % 32;
    const int n = (cm / (KC / 4)) * 8 + in / 4;
    const int kp = ch * KC + (cm % (KC / 4)) * 4 + in % 4;
    const int m = kp / Hp, hh = kp - m * Hp, o = ct * BN + n;
    const float x = (o < O && m < M && hh < H) ? __ldg(w + static_cast<long long>(o) * ldw +
                                                       (h0 + hh) * M + m)
                                               : 0.f;
    uint32_t big, small;
    tc::split(x, big, small);
    wsp[blk * 2 * TILE + e] = big;
    wsp[blk * 2 * TILE + TILE + e] = small;
  }
}

// The block's work: whole tiles blockIdx.x + i gridDim.x below plan.whole,
// then, where the tail is split, part blockIdx.x of the split tiles.
// fn(rt, first chunk, end chunk, part or -1).
template <class Fn>
__device__ __forceinline__ void for_each_item(const Plan& plan, Fn fn) {
  for (int rt = blockIdx.x; rt < plan.whole; rt += gridDim.x) fn(rt, 0, plan.nch, -1);
  if (plan.splits > 1 && static_cast<int>(blockIdx.x) < (plan.RT - plan.whole) * plan.splits) {
    const int rt = plan.whole + blockIdx.x / plan.splits, p = blockIdx.x % plan.splits;
    fn(rt, p * plan.nch / plan.splits, (p + 1) * plan.nch / plan.splits, p);
  }
}

// One launch over an h block of H <= HMAX columns.  acc: add into out (a
// later h block) instead of writing out + b.  Split tiles write their parts'
// sums to part [splits][tail rows][O] instead.
__global__ void __launch_bounds__(THREADS, 1)
cin_fwd_kernel(const float* __restrict__ h, int ldh, const float* __restrict__ x0,
               const uint32_t* __restrict__ wsp, const float* __restrict__ bias,
               float* __restrict__ out, float* __restrict__ part, int N, int H, int M, int O,
               int acc, int grid) {
  constexpr int KS = KC / 8;
  const Plan plan(N, H, M, grid);
  const int CT = (O + BN - 1) / BN;
  float* ring = cin_smem;
  float* hs_all = ring + plan.stages * plan.stage;
  float* xs_all = hs_all + BM * plan.HS;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs_all + BM * plan.XS);
  uint64_t* empty = full + plan.stages;
  const int wgi = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 2 * WG);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {  // the producer: one thread streams every chunk's W stage
    tc::regs_dec<40>();
    if (threadIdx.x == 0) {
      const int bytes = plan.stage * 4;
      int it = 0;
      for_each_item(plan, [&](int, int c0, int c1, int) {
        for (int ct = 0; ct < CT; ++ct) {
          const uint32_t* src = wsp + static_cast<long long>(ct) * plan.nch * plan.stage;
          for (int ch = c0; ch < c1; ++ch, ++it) {
            const int s = it % plan.stages;
            tc::mbar_wait(&empty[s], ((it / plan.stages) & 1) ^ 1);
            tc::mbar_arrive_tx(&full[s], bytes);
            tc::bulk_copy(ring + s * plan.stage, src + ch * plan.stage, bytes, &full[s]);
          }
        }
      });
    }
  } else {  // a consumer: rows R (wgi - 1) .. of each tile
    tc::regs_inc<232>();
    const int c = wgi - 1, t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
    const int g = lane / 4, tig = lane % 4;
    float* hs = hs_all + c * R * plan.HS;
    float* xs = xs_all + c * R * plan.XS;
    const uint32_t ring_addr = tc::smem_addr(ring);
    const bool h16 = (reinterpret_cast<uintptr_t>(h) & 15) == 0 && ldh % 4 == 0;
    int it = 0;
    for_each_item(plan, [&](int rt, int c0, int c1, int p) {
      const int row0 = rt * BM + c * R;
      // stage this consumer's h and x0 rows (the previous tile's reads are done)
      tc::named_sync(1 + c, WG);
      for (int r = warp; r < R; r += 4) {
        const int gr = row0 + r;
        const bool in = gr < N;
        const float* hrow = h + static_cast<long long>(in ? gr : 0) * ldh;
        if (h16) {
          for (int q = lane; q < plan.Hp / 4; q += 32) {
            const int valid = in ? min(max(H - 4 * q, 0), 4) : 0;
            tc::cp_async16(hs + r * plan.HS + 4 * q, hrow + (valid ? 4 * q : 0), 4 * valid);
          }
        } else {
          for (int q = lane; q < plan.Hp; q += 32)
            tc::cp_async4(hs + r * plan.HS + q, hrow + (q < H ? q : 0), in && q < H);
        }
        const float* xrow = x0 + static_cast<long long>(in ? gr : 0) * M;
        for (int q = lane; q < plan.MPAD; q += 32)
          tc::cp_async4(xs + r * plan.XS + q, xrow + (q < M ? q : 0), in && q < M);
      }
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      tc::named_sync(1 + c, WG);

      const int r0 = 16 * warp + g;  // this thread's rows r0 and r0 + 8
      for (int ct = 0; ct < CT; ++ct) {
        float sum[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
        // k' = m Hp + hh of the next k8 step
        int m = c0 * KC / plan.Hp, hh = c0 * KC - m * plan.Hp;
        for (int ch = c0; ch < c1; ++ch, ++it) {
          // this chunk's A fragments: z = h x0 at rows r0 and r0 + 8, k'
          // columns tig and tig + 4 of each k8 step, split into TF32 halves
          uint32_t ab[KS][4], as[KS][4];
#pragma unroll
          for (int j = 0; j < KS; ++j) {
            const float* hr = hs + r0 * plan.HS + hh + tig;
            const float xa = xs[r0 * plan.XS + m], xb = xs[(r0 + 8) * plan.XS + m];
            const float z[4] = {hr[0] * xa, hr[8 * plan.HS] * xb, hr[4] * xa,
                                hr[8 * plan.HS + 4] * xb};
#pragma unroll
            for (int q = 0; q < 4; ++q) tc::split(z[q], ab[j][q], as[j][q]);
            hh += 8;
            if (hh == plan.Hp) {
              hh = 0;
              ++m;
            }
          }
          const int s = it % plan.stages;
          tc::mbar_wait(&full[s], (it / plan.stages) & 1);
          const uint32_t sb = ring_addr + s * plan.stage * 4;
          float d[BN / 2];
          tc::fence_regs(d);
          tc::wgmma_fence();
#pragma unroll
          for (int j = 0; j < KS; ++j) {
            // k8 step j: core matrices 2j and 2j + 1 along K (LBO 128 bytes),
            // 8-column groups KC / 4 core matrices apart (SBO); small terms
            // first, the chunk's first product from zero (scale-d 0)
            const uint64_t db = tc::wgmma_desc(sb + 256 * j, 128, 32 * KC);
            const uint64_t ds = tc::wgmma_desc(sb + BN * KC * 4 + 256 * j, 128, 32 * KC);
            tc::wgmma<BN>(d, as[j], db, j > 0);
            tc::wgmma<BN>(d, ab[j], ds, 1);
            tc::wgmma<BN>(d, ab[j], db, 1);
          }
          tc::wgmma_commit();
          tc::wgmma_wait<0>();
          tc::fence_regs(d);
          tc::mbar_arrive(&empty[s]);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) sum[i] += d[i];
        }
        // epilogue: d[4 j + q] is row r0 + 8 (q / 2), column 8 j + 2 tig + q % 2
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = row0 + r0 + 8 * hf;
          if (r >= N) continue;
          float* orow = p < 0 ? out + static_cast<long long>(r) * O
                              : part + p * plan.part_size(N, O) +
                                    static_cast<long long>(r - plan.whole * BM) * O;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int o = ct * BN + 8 * j + 2 * tig + u;
              const float v = sum[4 * j + 2 * hf + u];
              if (o < O) orow[o] = p >= 0 ? v : acc ? orow[o] + v : v + __ldg(bias + o);
            }
          }
        }
      }
    });
  }
}

// out[r] (+)= sum over parts p in order of part[p][r] (+ b where !acc) for
// the n = rows * O entries of the split tiles
__global__ void cin_fwd_sum_parts(const float* __restrict__ part, int splits, int n, int O,
                                  const float* __restrict__ bias, float* __restrict__ out,
                                  int acc) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float v = part[i];
    for (int p = 1; p < splits; ++p) v += part[static_cast<long long>(p) * n + i];
    out[i] = acc ? out[i] + v : v + __ldg(bias + i % O);
  }
}

}  // namespace

extern "C" {

// Floats of the scratch (the split W, then the split tiles' parts) that
// cin_fwd needs for one h block of H <= 128 columns on `grid` persistent
// blocks, or -1 where the shared memory cannot hold its rows (or the
// scratch passes 2^31 floats).
int cin_fwd_scratch_floats(int N, int H, int M, int O, int grid) {
  const Plan plan(N, H, M, grid);
  const long long n = static_cast<long long>((O + BN - 1) / BN) * plan.nch * plan.stage +
                      plan.splits * plan.part_size(N, O);
  return plan.stages < 2 || n > 0x7fffffff ? -1 : static_cast<int>(n);
}

// Launches the split of W, the contraction and, where the tail is split,
// the sum of its parts on `stream`; returns the first CUDA error (0 on
// success).  h and x0 point at this h block's first column (h0 of W's h),
// H <= 128 of them; scratch holds cin_fwd_scratch_floats(...) floats; acc
// adds into out instead of writing out + b.  The caller has checked shapes,
// dtypes, devices, N, O > 0 and 32-bit element offsets.  grid: the
// persistent blocks (one a SM).
int cin_fwd(const void* h, int ldh, const void* x0, const void* w, int ldw, int h0,
            const void* bias, void* scratch, void* out, int N, int H, int M, int O, int acc,
            int grid, void* stream) {
  if (H < 1 || H > HMAX) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan(N, H, M, grid);
  if (plan.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int CT = (O + BN - 1) / BN, Hp = plan.Hp, nch = plan.nch;
  const long long wfloats = static_cast<long long>(CT) * plan.nch * plan.stage;
  void* part = static_cast<float*>(scratch) + wfloats;
  const int sblocks = static_cast<int>(wfloats / 512 + 1 < 2048 ? wfloats / 512 + 1 : 2048);
  void* sargs[] = {&w, &ldw, &h0, &H, &M, &O, &Hp, &nch, &CT, &scratch};
  cudaError_t err = cudaLaunchKernel(cin_fwd_split_w, dim3(sblocks), dim3(256), sargs, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(cin_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&h, &ldh, &x0, &scratch, &bias, &out, &part, &N, &H, &M, &O, &acc, &grid};
  err = cudaLaunchKernel(cin_fwd_kernel, dim3(plan.blocks), dim3(THREADS), args,
                         static_cast<size_t>(plan.bytes), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.splits > 1) {
    int splits = plan.splits, n = static_cast<int>(plan.part_size(N, O));
    void* tail = static_cast<float*>(out) + static_cast<long long>(plan.whole) * BM * O;
    void* pargs[] = {&part, &splits, &n, &O, &bias, &tail, &acc};
    err = cudaLaunchKernel(cin_fwd_sum_parts, dim3(n / 256 + 1 < 1024 ? n / 256 + 1 : 1024),
                           dim3(256), pargs, 0, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cin_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
