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
//   * B = W, split once a launch by a first kernel (cin_fwd_stage_w) into
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
//
// The bf16 mode (cin_fwd_bf16; cin_pallas.set_cin_precision("bf16"),
// cin_pallas.py:353-366): the TPU kernel cast h, x0 and W to bf16 and
// formed z = h x0 in bf16, so z is rounded once; its dot with W summed in
// fp32.  cin_fwd_kernel<true> keeps the fp32 kernel's producer, W ring,
// tiles, tail splits and epilogue, and runs one m64n128k16 bf16 wgmma a k16
// step (H padded to 16, so a k16 step keeps one m).  Against the kernel it
// replaced (this kernel's fp32 staging: h and x0 rounded in place, A
// multiplied in fp32 and converted, KC 32) it shortens the consumer's chain
// between its MMA batches:
//   * h and x0 are staged in bf16 once a row tile (h as pairs, x0 in both
//     halves of a word), and A's word is one packed product of an h pair by
//     {x0, x0} (mul.rn.bf16x2): 4 products and 6 shared loads a k16 step
//     against the replaced kernel's 8 multiplies, 4 conversions and 10
//     loads.  The product of two bf16 values is exact in fp32, so this is
//     bit-equal to the fp32 product rounded once (the outputs' sha256 matched at every
//     shape against a build that multiplied in fp32 and converted);
//   * KC = 128 k' summed in the tensor cores before each fp32 add (the replaced
//     kernel: 32), a W stage of 32 KB; errors 0.17-0.49x the plain version's.
//     Where the staged rows leave no room for two such stages (at H 128, M
//     past 257) the plan halves KC, down to 32 (M up to 353; the replaced
//     kernel's fp32 rows took M up to about 285): shorter sums err less.
// Measured (scripts/bench_cin_bf16.py, device ms from the profiler, an
// NVIDIA H100 80GB HBM3 at 700.00 W; the replaced kernel in the same call): a
// train step's layers 0.099-0.101 + 0.127-0.137 ms (0.119-0.120 +
// 0.162-0.169), a scoring batch's 0.181-0.186 + 0.247-0.251 (0.211-0.213 +
// 0.298-0.301).  The sweep (one call, before a staging fix that took
// 2-3%): KC 32 / 64 / 128 packed 0.1235 / 0.106 / 0.101 (layer 0), 0.186 /
// 0.1515 / 0.135 (layer 1); KC 64 unpacked 0.110 / 0.161; two accumulator
// sets (chunk c + 1's MMAs before chunk c's add) KC 32 0.1205 / 0.175, KC
// 64 0.112 / 0.159 (it spills there); KC 256 (a later call) 0.104 / 0.125,
// but 0.200 against 0.181 at the scoring batch's layer 0.  m64n256k16 tiles
// need 128 accumulator registers and 128 for the fp32 sum, past the 255 a
// thread may hold; without the fp32 sum the tensor cores would sum 52-208
// k16 steps, and the backward's sweep shows the error growing with that
// length (1.40x at 8 steps, 1.83x at 16).  The stream of W from L2, read by
// every 128-row tile (272 MB at layer 1), is what remains.
// Bound: operations, 2*N*H*M*O at the bf16 tensor-core rate (989 TFLOP/s on
// the H100 SXM): 0.050 ms for the train batch's two launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one Hopper block may take
constexpr int SB = 8;               // a bf16 consumer thread's staging loads in flight

// What the two precisions change.  KC: k' summed in the tensor cores
// before each fp32 add (a ring stage's k').  At the serving and train
// layer-1 shapes (K 3328; an NVIDIA H100 80GB HBM3 at 700 W, by a chunk
// sweep since removed) TF32's KC 8, 16 and 32 all passed the float64 gate
// with margin (errors 0.43x / 0.29x / 0.24x the plain fp32 version's at
// serving, 1.14x / 0.99x / 0.73x at train); KC 16 ran 0.003-0.022 ms (1-3%)
// a launch faster than 32 and a third faster than 8, so it is taken over
// the longest chunk that passes.  bf16 takes KC 128 (the header's sweep),
// halved down to KC_MIN where the staged rows leave no room for two such
// stages (at H 128: M past 257 takes 64, past 321 takes 32, up to 353).
template <bool BF16>
struct Prec;
template <>
struct Prec<false> {  // 3xTF32: m64n128k8 tf32, W's big and small halves
  static constexpr int KC = 16, KC_MIN = 16, KSTEP = 8, HALIGN = 8, HS_MOD = 4;
};
template <>
struct Prec<true> {  // bf16: m64n128k16, W in bf16 (two a float)
  static constexpr int KC = 128, KC_MIN = 32, KSTEP = 16, HALIGN = 16, HS_MOD = 0;
};

// The launch's plan, the same on the host and the device.
template <bool BF16>
struct Plan {
  int Hp;      // h columns padded to a multiple of KSTEP (one m a k step)
  int HS;      // staged h row pitch, so that a warp's fragment loads miss no bank: TF32 HS_MOD
               // mod 32 floats; bf16 4 mod 8 words (h in bf16 pairs)
  int kc;      // k' of a chunk (Prec's KC, or less where the rows leave no room)
  int nch;     // chunks of kc k' over the padded K = M * Hp
  int MPAD;    // staged x0 columns: every m the chunks reach, zero past M
  int XS;      // staged x0 row pitch, odd (bf16: words, each x0 in both halves)
  int stage;   // floats of one ring stage (W's big and small halves, or W in bf16)
  int stages;  // ring stages (under 2: the rows do not fit)
  int bytes;   // dynamic shared memory
  // Tiles: RT of BM rows, each over every column tile.  The first `whole`
  // are walked whole by the persistent blocks in strides of the grid; the
  // rest (under one round) are cut into `splits` parts along K, one a
  // block, whose sums cin_fwd_sum_parts adds in order.
  int RT, whole, splits, blocks;

  __host__ __device__ Plan(int N, int H, int M, int grid) {
    using P = Prec<BF16>;
    Hp = (H + P::HALIGN - 1) / P::HALIGN * P::HALIGN;
    HS = BF16 ? Hp / 2 + 4 : Hp + ((32 + P::HS_MOD - Hp % 32) % 32);
    for (kc = P::KC;; kc /= 2) {  // the longest chunk whose two stages fit beside the rows
      nch = (M * Hp + kc - 1) / kc;
      MPAD = (nch * kc + Hp - 1) / Hp;
      XS = MPAD | 1;
      stage = BF16 ? BN * kc / 2 : 2 * BN * kc;
      stages = (SMEM_LIMIT - BM * (HS + XS) * 4 - 2 * MAX_STAGES * 8) / (stage * 4);
      if (stages >= 2 || kc == P::KC_MIN) break;
    }
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

// W [O, ldw] (k = h*M + m, columns h0 + [0, H)), element (n, k' = ch kc +
// kk = m Hp + h) of column tile ct, chunk ch; zero past O, M and H.
__device__ __forceinline__ float w_at(const float* __restrict__ w, int ldw, int h0, int H, int M,
                                      int O, int Hp, int ct, int n, int kp) {
  const int m = kp / Hp, hh = kp - m * Hp, o = ct * BN + n;
  return (o < O && m < M && hh < H)
             ? __ldg(w + static_cast<long long>(o) * ldw + (h0 + hh) * M + m)
             : 0.f;
}

// W into wsp stage by stage (for each column tile ct and chunk ch, one
// stage's kc x BN block).  TF32: the big then the small TF32 halves,
// element (n, kk) at ((n / 8) (kc / 4) + kk / 4) 32 + (n % 8) 4 + kk % 4.
// bf16: W rounded to bf16 (nearest even), a bf16 tile (tc_tf32.cuh) of BN
// rows (columns n) by kc k', two to a word.
template <bool BF16>
__global__ void cin_fwd_stage_w(const float* __restrict__ w, int ldw, int h0, int H, int M,
                                int O, int Hp, int kc, int nch, int ct_count,
                                uint32_t* __restrict__ wsp) {
  const int TILE = BN * kc;
  const int WORDS = BF16 ? TILE / 2 : TILE;  // a thread's items of a tile
  const long long total = static_cast<long long>(ct_count) * nch * WORDS;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int e = static_cast<int>(i % WORDS);
    const long long blk = i / WORDS;  // ct * nch + ch
    const int ch = static_cast<int>(blk % nch), ct = static_cast<int>(blk / nch);
    if constexpr (BF16) {  // a bf16 pair: channels kk, kk + 1 of column n
      const int n = e % BN, kk = 2 * (e / BN), kp = ch * kc + kk;
      wsp[blk * WORDS + tc::bf16_tile_off(n, kk, kc) / 4] =
          tc::bf16x2(w_at(w, ldw, h0, H, M, O, Hp, ct, n, kp),
                     w_at(w, ldw, h0, H, M, O, Hp, ct, n, kp + 1));
    } else {
      const int cm = e / 32, in = e % 32;
      const int n = (cm / (kc / 4)) * 8 + in / 4;
      const int kp = ch * kc + (cm % (kc / 4)) * 4 + in % 4;
      uint32_t big, small;
      tc::split(w_at(w, ldw, h0, H, M, O, Hp, ct, n, kp), big, small);
      wsp[blk * 2 * TILE + e] = big;
      wsp[blk * 2 * TILE + TILE + e] = small;
    }
  }
}

// The block's work: whole tiles blockIdx.x + i gridDim.x below plan.whole,
// then, where the tail is split, part blockIdx.x of the split tiles.
// fn(rt, first chunk, end chunk, part or -1).
template <bool BF16, class Fn>
__device__ __forceinline__ void for_each_item(const Plan<BF16>& plan, Fn fn) {
  for (int rt = blockIdx.x; rt < plan.whole; rt += gridDim.x) fn(rt, 0, plan.nch, -1);
  if (plan.splits > 1 && static_cast<int>(blockIdx.x) < (plan.RT - plan.whole) * plan.splits) {
    const int rt = plan.whole + blockIdx.x / plan.splits, p = blockIdx.x % plan.splits;
    fn(rt, p * plan.nch / plan.splits, (p + 1) * plan.nch / plan.splits, p);
  }
}

// A consumer's R rows from row0 of h and x0 into shared memory, zero past
// N, H and M; t is the thread of the warpgroup.  TF32: as they stand, by
// cp.async.  bf16: rounded once (as the TPU kernel cast them), h in bf16
// pairs and x0 in both halves of a word, SB loads of a thread in flight.
template <bool BF16, class Word>
__device__ __forceinline__ void stage_rows(const Plan<BF16>& plan, Word* hs, Word* xs,
                                           const float* __restrict__ h, int ldh,
                                           const float* __restrict__ x0, int row0, int N, int H,
                                           int M, int t) {
  if constexpr (BF16) {
    const int HW = plan.Hp / 2;
    for (int e0 = t; e0 < R * HW; e0 += SB * WG) {
      float lo[SB], hi[SB];
#pragma unroll
      for (int k = 0; k < SB; ++k) {
        const int e = e0 + k * WG, r = e / HW, q = e - r * HW, gr = row0 + r;
        const float* hr = h + static_cast<long long>(gr < N ? gr : 0) * ldh;
        const bool in = e < R * HW && gr < N;
        lo[k] = in && 2 * q < H ? hr[2 * q] : 0.f;
        hi[k] = in && 2 * q + 1 < H ? hr[2 * q + 1] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < SB; ++k) {
        const int e = e0 + k * WG, r = e / HW;
        if (e < R * HW) hs[r * plan.HS + e - r * HW] = tc::bf16x2(lo[k], hi[k]);
      }
    }
    for (int e0 = t; e0 < R * plan.MPAD; e0 += SB * WG) {
      float v[SB];
#pragma unroll
      for (int k = 0; k < SB; ++k) {
        const int e = e0 + k * WG, r = e / plan.MPAD, m = e - r * plan.MPAD, gr = row0 + r;
        v[k] = e < R * plan.MPAD && gr < N && m < M ? x0[static_cast<long long>(gr) * M + m]
                                                     : 0.f;
      }
#pragma unroll
      for (int k = 0; k < SB; ++k) {
        const int e = e0 + k * WG, r = e / plan.MPAD;
        if (e < R * plan.MPAD) xs[r * plan.XS + e - r * plan.MPAD] = tc::bf16x2(v[k], v[k]);
      }
    }
  } else {
    const int warp = t / 32, lane = t % 32;
    const bool h16 = (reinterpret_cast<uintptr_t>(h) & 15) == 0 && ldh % 4 == 0;
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
  }
}

// One launch over an h block of H <= HMAX columns.  acc: add into out (a
// later h block) instead of writing out + b.  Split tiles write their parts'
// sums to part [splits][tail rows][O] instead.  A consumer builds each
// chunk's A fragments, z = h x0 at its rows r0 and r0 + 8, from its staged
// rows: TF32 at k' columns tig and tig + 4 of each k8 step, split into TF32
// halves (three MMAs a step, small terms first); bf16 at k' columns 2 tig,
// 2 tig + 1, 2 tig + 8 and 2 tig + 9 of each k16 step, one packed product
// of an h pair by {x0, x0} a word (mul.rn.bf16x2: the product of two bf16
// values is exact in fp32, so this is the fp32 product rounded once, bit for
// bit).  Each chunk is summed in the tensor cores from zero (scale-d 0 on its
// first MMA) and added to the fp32 sum in chunk order.
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
cin_fwd_kernel(const float* __restrict__ h, int ldh, const float* __restrict__ x0,
               const uint32_t* __restrict__ wsp, const float* __restrict__ bias,
               float* __restrict__ out, float* __restrict__ part, int N, int H, int M, int O,
               int acc, int grid) {
  using P = Prec<BF16>;
  using Word = std::conditional_t<BF16, uint32_t, float>;  // a staged h / x0 slot
  constexpr int KSMAX = P::KC / P::KSTEP;                  // k steps of the longest chunk
  const Plan<BF16> plan(N, H, M, grid);
  const int CT = (O + BN - 1) / BN, KC = plan.kc, K = M * plan.Hp;
  float* ring = cin_smem;
  Word* hs_all = reinterpret_cast<Word*>(ring + plan.stages * plan.stage);
  Word* xs_all = hs_all + BM * plan.HS;
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
    Word* hs = hs_all + c * R * plan.HS;
    Word* xs = xs_all + c * R * plan.XS;
    const uint32_t ring_addr = tc::smem_addr(ring);
    int it = 0;
    for_each_item(plan, [&](int rt, int c0, int c1, int p) {
      const int row0 = rt * BM + c * R;
      tc::named_sync(1 + c, WG);  // the previous tile's reads are done
      stage_rows(plan, hs, xs, h, ldh, x0, row0, N, H, M, t);
      tc::named_sync(1 + c, WG);

      const int r0 = 16 * warp + g;  // this thread's rows r0 and r0 + 8
      for (int ct = 0; ct < CT; ++ct) {
        float sum[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
        int m = c0 * KC / plan.Hp, hh = c0 * KC - m * plan.Hp;  // k' = m Hp + hh of the next step
        for (int ch = c0; ch < c1; ++ch, ++it) {
          const int s = it % plan.stages;
          // the chunk's W stage, once the copy has landed
          auto stage = [&] {
            tc::mbar_wait(&full[s], (it / plan.stages) & 1);
            return ring_addr + s * plan.stage * 4;
          };
          float d[BN / 2];
          if constexpr (BF16) {  // the k16 steps below K
            uint32_t a[KSMAX][4];
#pragma unroll
            for (int j = 0; j < KSMAX; ++j) {
              if (16 * j >= KC || ch * KC + 16 * j >= K) break;
              const uint32_t xa = xs[r0 * plan.XS + m], xb = xs[(r0 + 8) * plan.XS + m];
              const uint32_t* hr = hs + r0 * plan.HS + hh / 2 + tig;
              const uint32_t* hq = hr + 8 * plan.HS;
              a[j][0] = tc::mul_bf16x2(hr[0], xa);
              a[j][1] = tc::mul_bf16x2(hq[0], xb);
              a[j][2] = tc::mul_bf16x2(hr[4], xa);
              a[j][3] = tc::mul_bf16x2(hq[4], xb);
              hh += 16;
              if (hh == plan.Hp) {
                hh = 0;
                ++m;
              }
            }
            const uint32_t sb = stage();
            tc::fence_regs(d);
            tc::wgmma_fence();
#pragma unroll
            for (int j = 0; j < KSMAX; ++j)
              if (16 * j < KC && ch * KC + 16 * j < K)
                tc::wgmma_bf16<BN>(d, a[j], tc::bf16_tile_desc(sb, 0, j, KC), j > 0);
          } else {
            uint32_t ab[KSMAX][4], as[KSMAX][4];
#pragma unroll
            for (int j = 0; j < KSMAX; ++j) {
              const float xa = xs[r0 * plan.XS + m], xb = xs[(r0 + 8) * plan.XS + m];
              const float* hr = hs + r0 * plan.HS + hh + tig;
              const float z[4] = {hr[0] * xa, hr[8 * plan.HS] * xb, hr[4] * xa,
                                  hr[8 * plan.HS + 4] * xb};
#pragma unroll
              for (int q = 0; q < 4; ++q) tc::split(z[q], ab[j][q], as[j][q]);
              hh += P::KSTEP;
              if (hh == plan.Hp) {
                hh = 0;
                ++m;
              }
            }
            const uint32_t sb = stage();
            tc::fence_regs(d);
            tc::wgmma_fence();
#pragma unroll
            for (int j = 0; j < KSMAX; ++j) {
              // k step j: core matrices 2j and 2j + 1 along K (LBO 128
              // bytes), 8-column groups a row of the stage's core matrices
              // apart (SBO)
              const uint64_t db = tc::wgmma_desc(sb + 256 * j, 128, 32 * P::KC);
              const uint64_t ds = tc::wgmma_desc(sb + BN * P::KC * 4 + 256 * j, 128, 32 * P::KC);
              tc::wgmma<BN>(d, as[j], db, j > 0);
              tc::wgmma<BN>(d, ab[j], ds, 1);
              tc::wgmma<BN>(d, ab[j], db, 1);
            }
          }
          tc::wgmma_commit();
          tc::wgmma_wait<0>();
          tc::fence_regs(d);
          tc::mbar_arrive(&empty[s]);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) sum[i] += d[i];
        }
        // epilogue: sum[4 j + q] is row r0 + 8 (q / 2), column 8 j + 2 tig + q % 2
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

template <bool BF16>
int scratch_floats(int N, int H, int M, int O, int grid) {
  const Plan<BF16> plan(N, H, M, grid);
  const long long n = static_cast<long long>((O + BN - 1) / BN) * plan.nch * plan.stage +
                      plan.splits * plan.part_size(N, O);
  return plan.stages < 2 || n > 0x7fffffff ? -1 : static_cast<int>(n);
}

template <bool BF16>
int launch(const void* h, int ldh, const void* x0, const void* w, int ldw, int h0,
           const void* bias, void* scratch, void* out, int N, int H, int M, int O, int acc,
           int grid, void* stream) {
  if (H < 1 || H > HMAX) return static_cast<int>(cudaErrorInvalidValue);
  const Plan<BF16> plan(N, H, M, grid);
  if (plan.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int CT = (O + BN - 1) / BN, Hp = plan.Hp, kc = plan.kc, nch = plan.nch;
  const long long wfloats = static_cast<long long>(CT) * plan.nch * plan.stage;
  void* part = static_cast<float*>(scratch) + wfloats;
  const int sblocks = static_cast<int>(wfloats / 512 + 1 < 2048 ? wfloats / 512 + 1 : 2048);
  void* sargs[] = {&w, &ldw, &h0, &H, &M, &O, &Hp, &kc, &nch, &CT, &scratch};
  cudaError_t err =
      cudaLaunchKernel(cin_fwd_stage_w<BF16>, dim3(sblocks), dim3(256), sargs, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(cin_fwd_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&h, &ldh, &x0, &scratch, &bias, &out, &part, &N, &H, &M, &O, &acc, &grid};
  err = cudaLaunchKernel(cin_fwd_kernel<BF16>, dim3(plan.blocks), dim3(THREADS), args,
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

}  // namespace

extern "C" {

// Floats of the scratch (the staged W, then the split tiles' parts) that
// cin_fwd needs for one h block of H <= 128 columns on `grid` persistent
// blocks, or -1 where the shared memory cannot hold its rows (or the
// scratch passes 2^31 floats).
int cin_fwd_scratch_floats(int N, int H, int M, int O, int grid) {
  return scratch_floats<false>(N, H, M, O, grid);
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
  return launch<false>(h, ldh, x0, w, ldw, h0, bias, scratch, out, N, H, M, O, acc, grid,
                       stream);
}

// The bf16 mode's scratch and launch: the same contract on fp32 inputs,
// rounded to bf16 inside (h, x0, W and each z = h x0), sums in fp32.
int cin_fwd_bf16_scratch_floats(int N, int H, int M, int O, int grid) {
  return scratch_floats<true>(N, H, M, O, grid);
}

int cin_fwd_bf16(const void* h, int ldh, const void* x0, const void* w, int ldw, int h0,
                 const void* bias, void* scratch, void* out, int N, int H, int M, int O,
                 int acc, int grid, void* stream) {
  return launch<true>(h, ldh, x0, w, ldw, h0, bias, scratch, out, N, H, M, O, acc, grid,
                      stream);
}

const char* cin_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
