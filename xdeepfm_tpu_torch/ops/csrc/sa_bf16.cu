// Small-sequence attention for the attention-pooled CIN in the bf16 mode
// (ops/attention.py set_precision("bf16")), forward (sa_fwd_bf16) and
// backward (sa_bwd_bf16), for Hopper (sm_90a), behind a plain C interface
// that ops/attention_cuda.py loads with ctypes.  The same function as
// sa_fwd.cu and sa_bwd.cu (their header comments give it), with every
// product taken on bf16 operands and summed in fp32, as the TPU kernel's
// bf16 dots did:
//
//   s = bf16(q)^T bf16(k),  m = max_j s,  e = exp((s - m) scale),
//   inv_z = 1 / sum_j e (the fp32 e),  o = (bf16(v) bf16(e)^T) inv_z;
//   dv = bf16(g inv_z) bf16(e),  dp = bf16(g)^T bf16(v),
//   ds = bf16(((dp - delta) (inv_z scale)) e),  dq = bf16(k) ds^T,
//   dk = bf16(q) ds,  with delta = sum_d g o in fp32.
//
// Replaces: xdeepfm_tpu/ops/attention_pallas.py _sa_fwd / _fwd_kernel
// (sa_fwd_bf16) and _sa_bwd / _bwd_kernel (sa_bwd_bf16) under the module's
// set_precision("bf16") (_dot, attention_pallas.py:70-77).
//
// Bound: operations.  At the V2 training shape (G = 8192, dh = 5, S = 256)
// a launch takes G S^2 = 0.54 G exps, 0.128 ms at the exp rate (the fp32
// rate / 16, an H100 SXM at 700 W).  Its products are 4 G S^2 dh = 10.7
// GFLOP forward and 10 G S^2 dh = 26.8 backward, 0.011 and 0.027 ms at the
// bf16 tensor cores' 989 TFLOP/s (0.022 and 0.054 with dh padded to the
// k16 step); the operands are 42 MB forward and 84 MB backward, 0.013 and
// 0.025 ms at 3.35 TB/s.
//
// Design.  A block is four warps and one pair.  Each warp owns 32 rows (two
// m16 tiles: queries, or keys in the backward's key pass) at a time, whose
// operands it holds as the A fragments of the score products (dh padded
// to the k8 or k16 step, rounded by cvt.rn.bf16x2), and walks the other
// side in chunks of 64 columns that the block stages in shared memory,
// rounded, in tc_tf32.cuh's bf16 tiles: a column tile [64][K d] is the B
// operand of a score product (k = d), a row tile [K d][64] the B operand of
// a product over the chunk (k = the columns, n = d), K = dh rounded up to 8
// or 16.  All products are mma.sync m16n8k8 / m16n8k16 bf16 with fp32
// sums: each warp runs on its own (no warpgroup barrier, no MMA waits),
// and a score's accumulator fragment is the A fragment of the next
// product, so e and ds go from registers to the tensor cores.  (A first
// design took the score products on wgmma m64nNk16, N up to 256, which the
// warpgroup waits on, and the value products on wgmma m64n8k16: no faster,
// and its wide accumulators cost registers and so blocks an SM.)  Where
// the pair fits in SMEM_BUDGET (at dh 5: S up to 1057 forward, 512
// backward; V2 runs S 256), the block first copies its fp32 operands into
// shared memory with cp.async (one wait for the whole pair; staged chunk
// by chunk from device memory, the chunks' load latencies were paid one
// after another, which slowed the backward most), then rounds every
// chunk's tiles from that copy in one pass; else it stages each chunk from
// device memory where it is used.
//   * sa_fwd_bf16: pass 1 takes the exact row max of the scores (m16n8kK
//     against the k column tile; masked keys by a select); pass 2 takes the
//     scores again (cheaper than keeping a row of them in registers), e =
//     2^(s c - m c) (c = scale log2 e, one FFMA) into the row sums, and e
//     rounded into the A fragment of o^T += E V^T against the v row tile.
//     The rounding point of e forbids a running max with a rescale.
//   * sa_bwd_bf16: a block runs two passes over its pair's one copy.  The
//     key pass (FA3's key-major order) owns keys and walks the queries: s^T
//     = k^T q and dp^T = v^T g, e^T from the columns' saved m, ds^T by the
//     formula above, then dv^T += e^T (g inv_z)^T and dk^T += ds^T q^T.
//     The query pass owns queries and walks the keys: s and dp again, ds,
//     dq^T += ds k^T.  Recomputing s, dp and the exps in the query pass
//     costs a second exp pass, and in exchange no [S, S] ds goes to shared
//     memory, so any S of the fp32 kernels' gate runs, and there are no
//     atomics.  (With each pass in a block of its own, every pair was
//     copied twice.)
//   * Sums.  The tensor cores' fp32 sums truncate (tc_tf32.cuh), so a
//     product over the walked side is summed in the MMA from zero over one
//     chunk (64 keys or queries) and added to an fp32 total in a fixed
//     order.  Every sum has a fixed order: two runs are bit-equal.
//   * The score of a (query, key) pair is one MMA sum of the same exact
//     products in every kernel and pass, so the backward's e at the
//     forward's argmax is 2^0: m is bit-equal to the row max of the scores
//     as the backward recomputes them.
//   * Masking.  Columns past S are zero in the staged tiles; the forward's
//     max and e and the query pass's e take a select there (not a multiply,
//     never a branch around the exps), in a copy of the loop that only the
//     ragged chunk runs.  Queries past S in the key pass have m c = +inf,
//     inv_z scale = 0 and delta = 0 in the staged statistics, so their e^T
//     and ds^T are 0 with no select.

#include <cfloat>
#include <cmath>
#include <stdint.h>

#include "attn_common.cuh"
#include "tc_tf32.cuh"

namespace {

constexpr int WG = 128;   // threads of a block: four warps
constexpr int MT = 2;     // m16 tiles of rows a warp owns
constexpr int OWN = 4 * 16 * MT;  // rows the block owns at a time
constexpr int C = 64;     // columns of a staged chunk
constexpr int SMEM_BUDGET = 96 << 10;  // the most a block holds to keep a whole pair
constexpr float LOG2E = 1.4426950408889634f;

// A chunk's tiles (tc_tf32.cuh's bf16 tiles, unswizzled core matrices of 8
// rows x 16 bytes), for head widths up to K (8 or 16): a column tile [C
// columns][K d] (bf16_tile_off(col, d, K)), the B operand of a score
// product (k = d, n = the columns), and a row tile [K rows d][C columns]
// (bf16_tile_off(d, col, C)), the B operand of a product over the columns
// (k = the columns, n = d).  Bytes of a chunk: the forward's k column and v
// row tiles; the key pass's q and g column tiles, q and g inv_z row tiles
// and three statistics of C queries; the query pass's k and v column tiles
// and k row tile.
__host__ __device__ constexpr int fwd_chunk_bytes(int K) { return 2 * 2 * K * C; }
__host__ __device__ constexpr int keys_chunk_bytes(int K) { return 2 * 4 * K * C + 3 * 4 * C; }
__host__ __device__ constexpr int queries_chunk_bytes(int K) { return 2 * 3 * K * C; }

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// A whole pair: its fp32 operands copied into shared memory (the
// forward's q, k, v; the backward's q, k, v, g, o [dh][S] and m, inv_z
// [S], each from a 16-byte boundary) and the tiles of every chunk, where
// they fit in SMEM_BUDGET; else each chunk is staged anew from device
// memory where it is used.  The floats of the copy, and the bytes of a
// launch's shared memory:
__host__ __device__ inline int fwd_raw_floats(int dh, int S) { return 3 * round4(dh * S); }
__host__ __device__ inline int bwd_raw_floats(int dh, int S) {
  return 5 * round4(dh * S) + 2 * round4(S);
}
__host__ __device__ inline int bwd_chunk_bytes(int K) {
  return keys_chunk_bytes(K) > queries_chunk_bytes(K) ? keys_chunk_bytes(K)
                                                      : queries_chunk_bytes(K);
}
__host__ __device__ inline bool fwd_whole(int dh, int S, int K) {
  return 4 * fwd_raw_floats(dh, S) + (S + C - 1) / C * fwd_chunk_bytes(K) <= SMEM_BUDGET;
}
__host__ __device__ inline bool bwd_whole(int dh, int S, int K) {
  return 4 * bwd_raw_floats(dh, S) + (S + C - 1) / C * bwd_chunk_bytes(K) <= SMEM_BUDGET;
}

// n floats from device memory to shared memory by cp.async (16 bytes a
// copy where n and src allow, else 4); dst on a 16-byte boundary
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n) {
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += WG) tc::cp_async16(dst + 4 * i, src + 4 * i, 16);
  } else {
    for (int i = threadIdx.x; i < n; i += WG) tc::cp_async4(dst + i, src + i, true);
  }
}

// The row tiles' rows dh .. K - 1, zeroed once for every slot: staging a
// chunk writes rows < dh only.
__device__ __forceinline__ void zero_rows(uint16_t* tile, int dh, int K) {
  for (int e = threadIdx.x; e < K * C / 8; e += WG) {
    int r, k;
    tc::bf16_tile_chunk(16 * e, C, r, k);
    if (r >= dh) reinterpret_cast<uint4*>(tile)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
}

constexpr int STAGE_UNROLL = 4;  // items a thread loads before it stores

// Chunks ch0 .. ch0 + n - 1 (columns (ch0 + j) C ..) of rows 0 .. dh - 1 of
// the pair's dh-major operand src [dh][S], each times mul[column] where mul
// is given, rounded to bf16 into row tiles, chunk j's at tile + j stride
// bytes; zero at columns >= S.  An item is 8 columns of a row: consecutive
// threads take consecutive items (float4 loads where vec: S a multiple of
// 4, the operands 16-byte aligned), STAGE_UNROLL items' loads issued before
// their stores.
__device__ __forceinline__ void stage_rows(unsigned char* __restrict__ tile, int stride,
                                           const float* __restrict__ src,
                                           const float* __restrict__ mul, int dh, int S, int ch0,
                                           int n, bool vec) {
  constexpr int per_row = C / 8;
  const int per = dh * per_row, total = n * per;
  for (int i0 = threadIdx.x; i0 < total; i0 += STAGE_UNROLL * WG) {
    float x[STAGE_UNROLL][8];
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * WG, r = i % per;
      const int col = (ch0 + i / per) * C + (r % per_row) * 8;
      const float* p = src + (r / per_row) * S + col;
      if (i < total && vec && col + 8 <= S) {
        const float4 a = *reinterpret_cast<const float4*>(p);
        const float4 b = *reinterpret_cast<const float4*>(p + 4);
        x[u][0] = a.x, x[u][1] = a.y, x[u][2] = a.z, x[u][3] = a.w;
        x[u][4] = b.x, x[u][5] = b.y, x[u][6] = b.z, x[u][7] = b.w;
      } else {
#pragma unroll
        for (int w = 0; w < 8; ++w) x[u][w] = i < total && col + w < S ? p[w] : 0.f;
      }
      if (mul != nullptr) {
#pragma unroll
        for (int w = 0; w < 8; ++w) x[u][w] *= i < total && col + w < S ? mul[col + w] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * WG, r = i % per;
      if (i >= total) break;
      const uint4 out = make_uint4(tc::bf16x2(x[u][0], x[u][1]), tc::bf16x2(x[u][2], x[u][3]),
                                   tc::bf16x2(x[u][4], x[u][5]), tc::bf16x2(x[u][6], x[u][7]));
      *reinterpret_cast<uint4*>(tile + (i / per) * stride +
                                tc::bf16_tile_off(r / per_row, (r % per_row) * 8, C)) = out;
    }
  }
}

// Chunks ch0 .. ch0 + n - 1 of src into column tiles of K d, rounded, chunk
// j's at tile + j stride bytes: an item is the 8 d of one 16-byte half of a
// column, zero at d >= dh and columns >= S; STAGE_UNROLL items' loads
// issued before their stores.
template <int K>
__device__ __forceinline__ void stage_cols(unsigned char* __restrict__ tile, int stride,
                                           const float* __restrict__ src, int dh, int S, int ch0,
                                           int n) {
  constexpr int per = K / 8 * C;
  const int total = n * per;
  for (int i0 = threadIdx.x; i0 < total; i0 += STAGE_UNROLL * WG) {
    float x[STAGE_UNROLL][8];
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * WG, r = i % per;
      const int at = (ch0 + i / per) * C + r % C, h = r / C;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const int d = 8 * h + w;
        x[u][w] = i < total && d < dh && at < S ? src[d * S + at] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * WG, r = i % per;
      if (i >= total) break;
      *reinterpret_cast<uint4*>(tile + (i / per) * stride +
                                tc::bf16_tile_off(r % C, 8 * (r / C), K)) =
          make_uint4(tc::bf16x2(x[u][0], x[u][1]), tc::bf16x2(x[u][2], x[u][3]),
                     tc::bf16x2(x[u][4], x[u][5]), tc::bf16x2(x[u][6], x[u][7]));
    }
  }
}

// delta = sum_d g[d] o[d] of column col, fmaf over d from 0 (the loads
// issued together)
__device__ __forceinline__ float delta_at(const float* __restrict__ gp,
                                          const float* __restrict__ op, int dh, int S, int col) {
  float gv[attn::MAX_DH], ov[attn::MAX_DH];
#pragma unroll
  for (int d = 0; d < attn::MAX_DH; ++d) {
    gv[d] = d < dh ? gp[d * S + col] : 0.f;
    ov[d] = d < dh ? op[d * S + col] : 0.f;
  }
  float dl = 0.f;
#pragma unroll
  for (int d = 0; d < attn::MAX_DH; ++d)
    if (d < dh) dl = fmaf(gv[d], ov[d], dl);
  return dl;
}

// The key pass's statistics of chunks ch0 .. ch0 + n - 1, chunk j's at
// tile + j stride bytes, [3][C] floats: each query column's m c (+inf past
// S), inv_z scale and delta
__device__ __forceinline__ void stage_stats(unsigned char* __restrict__ tile, int stride,
                                            const float* __restrict__ mp,
                                            const float* __restrict__ zp,
                                            const float* __restrict__ gp,
                                            const float* __restrict__ op, int dh, int S, float c,
                                            float scale, int ch0, int n) {
  for (int i = threadIdx.x; i < n * C; i += WG) {
    const int j = i % C, col = (ch0 + i / C) * C + j;
    const bool ok = col < S;
    float* st = reinterpret_cast<float*>(tile + (i / C) * stride);
    st[j] = ok ? mp[col] * c : INFINITY;
    st[C + j] = ok ? zp[col] * scale : 0.f;
    st[2 * C + j] = ok ? delta_at(gp, op, dh, S, col) : 0.f;
  }
}

// float4 loads are safe: S a multiple of 4 and every operand 16-byte aligned
__device__ __forceinline__ bool vec_ok(int S, const void* a, const void* b, const void* c,
                                       const void* d = nullptr, const void* e = nullptr) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d) |
                        reinterpret_cast<uintptr_t>(e);
  return S % 4 == 0 && (any & 15) == 0;
}

__device__ __forceinline__ uint32_t tile_word(const uint16_t* tile, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(reinterpret_cast<const unsigned char*>(tile) + off);
}

// The score products: m16n8kK over d (K 8 or 16).  A: the rows' fragment
// (K / 4 registers: (row, d 2 tig and 2 tig + 1), (row + 8, ...), and for
// K 16 the same at d + 8); B: columns 8 nt .. 8 nt + 7 of a column tile (K
// / 8 registers: d 2 tig and 2 tig + 1 of column 8 nt + group, and d + 8).
template <int K>
struct Score {
  uint32_t a[K / 4];

  // rows `row` and row + 8 of the pair's operand src [dh][S], rounded; zero
  // at d >= dh and rows >= S
  __device__ __forceinline__ void load(const float* __restrict__ src, int dh, int S, int row,
                                       int tig) {
    auto at = [&](int r, int d) { return d < dh && r < S ? src[d * S + r] : 0.f; };
#pragma unroll
    for (int h = 0; h < K / 8; ++h) {
      const int d0 = 8 * h + 2 * tig;
      a[2 * h] = tc::bf16x2(at(row, d0), at(row, d0 + 1));
      a[2 * h + 1] = tc::bf16x2(at(row + 8, d0), at(row + 8, d0 + 1));
    }
  }

  static __device__ __forceinline__ void b(uint32_t (&bf)[K / 8], const uint16_t* tile, int nt,
                                           int group, int tig) {
#pragma unroll
    for (int h = 0; h < K / 8; ++h)
      bf[h] = tile_word(tile, tc::bf16_tile_off(8 * nt + group, 8 * h + 2 * tig, K));
  }

  // d = A B, summed from zero
  __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&bf)[K / 8]) const {
    if constexpr (K == 16) {
      const uint32_t b2[2] = {bf[0], bf[1]};
      tc::mma_bf16_z(d, a, b2);
    } else {
      tc::mma_bf16_k8_z(d, a, bf);
    }
  }
};

// The m16n8k16 B fragment of k16 step s (columns 16 s ..) and rows n0 ..
// n0 + 7 (d) of a row tile: b0 (columns 2 tig, 2 tig + 1 of row n0 +
// group), b1 (the same 8 columns on)
__device__ __forceinline__ void row_frag(uint32_t (&b)[2], const uint16_t* tile, int n0, int s,
                                         int group, int tig) {
  b[0] = tile_word(tile, tc::bf16_tile_off(n0 + group, 16 * s + 2 * tig, C));
  b[1] = tile_word(tile, tc::bf16_tile_off(n0 + group, 16 * s + 8 + 2 * tig, C));
}

// sum over the four lanes of a quad, in a fixed order
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// A score product's accumulator d[4] holds row `group + 8 (e / 2)` of its
// m16 tile and column 8 nt + 2 tig + e % 2; two n-tiles 2 k16, 2 k16 + 1,
// rounded in pairs, are the A fragment of the k16 step k16 of the product
// over the columns: a[2 jj + e / 2] for n-tile 2 k16 + jj.

// The chunk staging of every kernel: all chunks in one pass for a whole
// pair (slots == chunks), else each chunk anew in slot 0 where it is used;
// stage(ch0, n, slot) stages chunks ch0 .. ch0 + n - 1 into slots slot ..;
// use(ch) returns chunk ch's slot.
template <class Stage>
struct Chunks {
  Stage stage;
  int chunks, slots, staged = -1;

  __device__ __forceinline__ Chunks(Stage st, int n, bool whole)
      : stage(st), chunks(n), slots(whole ? n : 1) {}
  __device__ __forceinline__ void stage_all() {  // one flat pass over every chunk
    if (slots != chunks) return;
    stage(0, chunks, 0);
    __syncthreads();
  }
  __device__ __forceinline__ int use(int ch) {
    if (slots == chunks) return ch;
    if (staged != ch) {
      __syncthreads();
      stage(ch, 1, 0);
      __syncthreads();
      staged = ch;
    }
    return 0;
  }
};

// ---------------------------------------------------------------- forward

// pass 1 over a chunk: the rows' max of the scores against the k column
// tile; RAGGED: columns at or past lim masked
template <int K, bool RAGGED>
__device__ __forceinline__ void fwd_max(const Score<K> (&aq)[MT], const uint16_t* kt,
                                        float (&mx)[MT][2], int lim, int group, int tig) {
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) {
    uint32_t b[K / 8];
    Score<K>::b(b, kt, nt, group, tig);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float sc[4];
      aq[mt].mma(sc, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (RAGGED && 8 * nt + 2 * tig + e % 2 >= lim) sc[e] = -INFINITY;
        mx[mt][e / 2] = fmaxf(mx[mt][e / 2], sc[e]);
      }
    }
  }
}

// pass 2 over a chunk: for each k16 step (16 keys) the scores again, e =
// 2^(s c - m c) into the row sums and, rounded, into the A fragment of
// o^T += E V^T against the v row tile; the chunk summed from zero and added
// in fp32.  RAGGED: keys at or past lim masked (e = 0).
template <int K, bool RAGGED>
__device__ __forceinline__ void fwd_chunk(const Score<K> (&aq)[MT], const uint16_t* kt,
                                          const uint16_t* vt, float (&ot)[MT][K / 2],
                                          float (&sum)[MT][2], const float (&mc)[MT][2], float c,
                                          int lim, int group, int tig) {
  float part[MT][K / 8][4];
#pragma unroll
  for (int k16 = 0; k16 < C / 16; ++k16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int nt = 2 * k16 + jj;
      uint32_t b[K / 8];
      Score<K>::b(b, kt, nt, group, tig);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float sc[4];
        aq[mt].mma(sc, b);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            x[u] = attn_tc::ex2(fmaf(sc[2 * r + u], c, -mc[mt][r]));
            if (RAGGED) x[u] = 8 * nt + 2 * tig + u < lim ? x[u] : 0.f;
            sum[mt][r] += x[u];
          }
          a[mt][2 * jj + r] = tc::bf16x2(x[0], x[1]);
        }
      }
    }
#pragma unroll
    for (int nd = 0; nd < K / 8; ++nd) {
      uint32_t b[2];
      row_frag(b, vt, 8 * nd, k16, group, tig);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (k16 == 0) tc::mma_bf16_z(part[mt][nd], a[mt], b);
        else tc::mma_bf16(part[mt][nd], a[mt], b);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nd = 0; nd < K / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) ot[mt][4 * nd + e] += part[mt][nd][e];
}

// A block takes pair blockIdx.x: o [dh][S], m and inv_z [S] of it.
template <int K>
__global__ void __launch_bounds__(WG)
sa_fwd_bf16_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, float* __restrict__ m_out,
                   float* __restrict__ z_out, int dh, int S, float scale) {
  constexpr int T = K * C;  // bf16 of a tile
  const long long base = static_cast<long long>(blockIdx.x) * dh * S;
  const long long rbase = static_cast<long long>(blockIdx.x) * S;
  const float *qp = q + base, *kp = k + base, *vp = v + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, group = lane / 4, tig = lane % 4;
  const float c = scale * LOG2E;
  const bool whole = fwd_whole(dh, S, K);
  if (whole) {  // the pair's q, k, v into shared memory, one wait for all
    const int n = round4(dh * S);
    copy_async(attn_smem, qp, dh * S);
    copy_async(attn_smem + n, kp, dh * S);
    copy_async(attn_smem + 2 * n, vp, dh * S);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    qp = attn_smem, kp = attn_smem + n, vp = attn_smem + 2 * n;
  }
  const bool vec = vec_ok(S, qp, kp, vp);
  // a slot: the k column and v row tiles
  constexpr int SLOT = fwd_chunk_bytes(K);
  unsigned char* slots =
      reinterpret_cast<unsigned char*>(attn_smem + (whole ? fwd_raw_floats(dh, S) : 0));
  uint16_t* ring = reinterpret_cast<uint16_t*>(slots);
  Chunks ck([&](int ch0, int n, int slot) {
    stage_cols<K>(slots + slot * SLOT, SLOT, kp, dh, S, ch0, n);
    stage_rows(slots + slot * SLOT + 2 * T, SLOT, vp, nullptr, dh, S, ch0, n, vec);
  }, (S + C - 1) / C, whole);
  for (int sl = 0; sl < ck.slots; ++sl) zero_rows(ring + (2 * sl + 1) * T, dh, K);
  ck.stage_all();

  for (int t = 0; t < (S + OWN - 1) / OWN; ++t) {
    const int row0 = t * OWN + 32 * warp + group;  // rows row0 + 16 mt (+ 8)
    Score<K> aq[MT];
    float mx[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      aq[mt].load(qp, dh, S, row0 + 16 * mt, tig);
      mx[mt][0] = mx[mt][1] = -INFINITY;
    }
    for (int ch = 0; ch < ck.chunks; ++ch) {  // pass 1: the exact row max
      const uint16_t* kt = ring + 2 * ck.use(ch) * T;
      const int lim = S - ch * C;
      if (lim < C) fwd_max<K, true>(aq, kt, mx, lim, group, tig);
      else fwd_max<K, false>(aq, kt, mx, lim, group, tig);
    }
    float mc[MT][2], sum[MT][2], ot[MT][K / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[mt][r] = quad_max(mx[mt][r]);
        mc[mt][r] = mx[mt][r] * c;
        sum[mt][r] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < K / 2; ++e) ot[mt][e] = 0.f;
    }
    for (int ch = 0; ch < ck.chunks; ++ch) {  // pass 2: e, the row sums, o
      const uint16_t* kt = ring + 2 * ck.use(ch) * T;
      const int lim = S - ch * C;
      if (lim < C) fwd_chunk<K, true>(aq, kt, kt + T, ot, sum, mc, c, lim, group, tig);
      else fwd_chunk<K, false>(aq, kt, kt + T, ot, sum, mc, c, lim, group, tig);
    }
    float* op = o + base;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = row0 + 16 * mt;
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(sum[mt][r]);
#pragma unroll
      for (int nd = 0; nd < K / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + 8 * (e / 2), dd = 8 * nd + 2 * tig + e % 2;
          if (r < S && dd < dh) op[dd * S + r] = ot[mt][4 * nd + e] * inv[e / 2];
        }
      if (tig == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row + 8 * r < S) {
            m_out[rbase + row + 8 * r] = mx[mt][r];
            z_out[rbase + row + 8 * r] = inv[r];
          }
      }
    }
  }
}

// --------------------------------------------------------------- backward

// The key pass: dk and dv [dh][S] of the pair's keys.  A chunk's slot: the
// q and g column tiles, the q and g inv_z row tiles, then the columns' m c
// (+inf past S), inv_z scale and delta.
template <int K>
__device__ __forceinline__ void bwd_keys(const float* qp, const float* kp, const float* vp,
                                         const float* gp, const float* op, const float* mp,
                                         const float* zp, float* dkp, float* dvp, int dh, int S,
                                         float scale, bool vec, unsigned char* ring, bool whole) {
  constexpr int T = K * C;  // bf16 of a tile
  constexpr int SLOT = keys_chunk_bytes(K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, group = lane / 4, tig = lane % 4;
  const float c = scale * LOG2E;
  auto tile = [&](int slot) { return reinterpret_cast<uint16_t*>(ring + slot * SLOT); };
  Chunks ck([&](int ch0, int n, int slot) {
    unsigned char* t = ring + slot * SLOT;
    stage_cols<K>(t, SLOT, qp, dh, S, ch0, n);
    stage_cols<K>(t + 2 * T, SLOT, gp, dh, S, ch0, n);
    stage_rows(t + 4 * T, SLOT, qp, nullptr, dh, S, ch0, n, vec);
    stage_rows(t + 6 * T, SLOT, gp, zp, dh, S, ch0, n, vec);
    stage_stats(t + 8 * T, SLOT, mp, zp, gp, op, dh, S, c, scale, ch0, n);
  }, (S + C - 1) / C, whole);
  for (int sl = 0; sl < ck.slots; ++sl) {
    zero_rows(tile(sl) + 2 * T, dh, K);
    zero_rows(tile(sl) + 3 * T, dh, K);
  }
  ck.stage_all();

  for (int t = 0; t < (S + OWN - 1) / OWN; ++t) {
    const int row0 = t * OWN + 32 * warp + group;  // keys row0 + 16 mt (+ 8)
    Score<K> ak[MT], av[MT];
    float dvt[MT][K / 2], dkt[MT][K / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ak[mt].load(kp, dh, S, row0 + 16 * mt, tig);
      av[mt].load(vp, dh, S, row0 + 16 * mt, tig);
#pragma unroll
      for (int e = 0; e < K / 2; ++e) dvt[mt][e] = dkt[mt][e] = 0.f;
    }
    for (int ch = 0; ch < ck.chunks; ++ch) {
      const uint16_t* t0 = tile(ck.use(ch));
      const uint16_t *qc = t0, *gc = t0 + T, *qr = t0 + 2 * T, *zr = t0 + 3 * T;
      const float* st = reinterpret_cast<const float*>(t0 + 4 * T);
      // for each k16 step (16 queries): s^T = k^T q and dp^T = v^T g, e^T
      // from the columns' m and ds^T, rounded into A fragments of dv^T +=
      // e^T (g inv_z)^T and dk^T += ds^T q^T; the chunk summed from zero
      float pv[MT][K / 8][4], pk[MT][K / 8][4];
#pragma unroll
      for (int k16 = 0; k16 < C / 16; ++k16) {
        uint32_t ae[MT][4], ads[MT][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int nt = 2 * k16 + jj, col = 8 * nt + 2 * tig;
          uint32_t bq[K / 8], bg[K / 8];
          Score<K>::b(bq, qc, nt, group, tig);
          Score<K>::b(bg, gc, nt, group, tig);
          const float2 mc = *reinterpret_cast<const float2*>(st + col);
          const float2 zs = *reinterpret_cast<const float2*>(st + C + col);
          const float2 dl = *reinterpret_cast<const float2*>(st + 2 * C + col);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float sc[4], dp[4];
            ak[mt].mma(sc, bq);
            av[mt].mma(dp, bg);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float e0 = attn_tc::ex2(fmaf(sc[2 * r], c, -mc.x));
              const float e1 = attn_tc::ex2(fmaf(sc[2 * r + 1], c, -mc.y));
              const float d0 = ((dp[2 * r] - dl.x) * zs.x) * e0;
              const float d1 = ((dp[2 * r + 1] - dl.y) * zs.y) * e1;
              ae[mt][2 * jj + r] = tc::bf16x2(e0, e1);
              ads[mt][2 * jj + r] = tc::bf16x2(d0, d1);
            }
          }
        }
#pragma unroll
        for (int nd = 0; nd < K / 8; ++nd) {
          uint32_t bz[2], bqr[2];
          row_frag(bz, zr, 8 * nd, k16, group, tig);
          row_frag(bqr, qr, 8 * nd, k16, group, tig);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (k16 == 0) {
              tc::mma_bf16_z(pv[mt][nd], ae[mt], bz);
              tc::mma_bf16_z(pk[mt][nd], ads[mt], bqr);
            } else {
              tc::mma_bf16(pv[mt][nd], ae[mt], bz);
              tc::mma_bf16(pk[mt][nd], ads[mt], bqr);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nd = 0; nd < K / 8; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dvt[mt][4 * nd + e] += pv[mt][nd][e];
            dkt[mt][4 * nd + e] += pk[mt][nd][e];
          }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nd = 0; nd < K / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + 16 * mt + 8 * (e / 2), dd = 8 * nd + 2 * tig + e % 2;
          if (r < S && dd < dh) {
            dvp[dd * S + r] = dvt[mt][4 * nd + e];
            dkp[dd * S + r] = dkt[mt][4 * nd + e];
          }
        }
  }
}

// A chunk of the query pass: for each k16 step (16 keys) s = q^T k and dp
// = g^T v, e from the rows' m, ds rounded into the A fragment of dq^T +=
// ds k^T against the k row tile; the chunk summed from zero and added in
// fp32.  RAGGED: keys at or past lim masked (e = 0).
template <int K, bool RAGGED>
__device__ __forceinline__ void query_chunk(const Score<K> (&aq)[MT], const Score<K> (&ag)[MT],
                                            const uint16_t* kc, const uint16_t* vc,
                                            const uint16_t* kr, float (&dqt)[MT][K / 2],
                                            const float (&mc)[MT][2], const float (&zs)[MT][2],
                                            const float (&dl)[MT][2], float c, int lim, int group,
                                            int tig) {
  float pq[MT][K / 8][4];
#pragma unroll
  for (int k16 = 0; k16 < C / 16; ++k16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int nt = 2 * k16 + jj;
      uint32_t bk[K / 8], bv[K / 8];
      Score<K>::b(bk, kc, nt, group, tig);
      Score<K>::b(bv, vc, nt, group, tig);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float sc[4], dp[4];
        aq[mt].mma(sc, bk);
        ag[mt].mma(dp, bv);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float ex = attn_tc::ex2(fmaf(sc[2 * r + u], c, -mc[mt][r]));
            if (RAGGED) ex = 8 * nt + 2 * tig + u < lim ? ex : 0.f;
            x[u] = ((dp[2 * r + u] - dl[mt][r]) * zs[mt][r]) * ex;
          }
          a[mt][2 * jj + r] = tc::bf16x2(x[0], x[1]);
        }
      }
    }
#pragma unroll
    for (int nd = 0; nd < K / 8; ++nd) {
      uint32_t b[2];
      row_frag(b, kr, 8 * nd, k16, group, tig);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (k16 == 0) tc::mma_bf16_z(pq[mt][nd], a[mt], b);
        else tc::mma_bf16(pq[mt][nd], a[mt], b);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nd = 0; nd < K / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqt[mt][4 * nd + e] += pq[mt][nd][e];
}

// The query pass: dq [dh][S] of the pair's queries.  A chunk's slot: the k
// and v column tiles and the k row tile.
template <int K>
__device__ __forceinline__ void bwd_queries(const float* qp, const float* kp, const float* vp,
                                            const float* gp, const float* op, const float* mp,
                                            const float* zp, float* dqp, int dh, int S,
                                            float scale, bool vec, unsigned char* slots,
                                            bool whole) {
  constexpr int T = K * C;
  constexpr int SLOT = queries_chunk_bytes(K);
  uint16_t* ring = reinterpret_cast<uint16_t*>(slots);  // a slot: 3 tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, group = lane / 4, tig = lane % 4;
  const float c = scale * LOG2E;
  Chunks ck([&](int ch0, int n, int slot) {
    unsigned char* t = slots + slot * SLOT;
    stage_cols<K>(t, SLOT, kp, dh, S, ch0, n);
    stage_cols<K>(t + 2 * T, SLOT, vp, dh, S, ch0, n);
    stage_rows(t + 4 * T, SLOT, kp, nullptr, dh, S, ch0, n, vec);
  }, (S + C - 1) / C, whole);
  for (int sl = 0; sl < ck.slots; ++sl) zero_rows(ring + (3 * sl + 2) * T, dh, K);
  ck.stage_all();

  for (int t = 0; t < (S + OWN - 1) / OWN; ++t) {
    const int row0 = t * OWN + 32 * warp + group;  // queries row0 + 16 mt (+ 8)
    Score<K> aq[MT], ag[MT];
    float mc[MT][2], zs[MT][2], dl[MT][2], dqt[MT][K / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      aq[mt].load(qp, dh, S, row0 + 16 * mt, tig);
      ag[mt].load(gp, dh, S, row0 + 16 * mt, tig);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + 16 * mt + 8 * r;
        const bool ok = i < S;  // rows past S: ds 0
        mc[mt][r] = ok ? mp[i] * c : 0.f;
        zs[mt][r] = ok ? zp[i] * scale : 0.f;
        dl[mt][r] = ok ? delta_at(gp, op, dh, S, i) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < K / 2; ++e) dqt[mt][e] = 0.f;
    }
    for (int ch = 0; ch < ck.chunks; ++ch) {
      const uint16_t* t0 = ring + 3 * ck.use(ch) * T;
      const int lim = S - ch * C;
      if (lim < C)
        query_chunk<K, true>(aq, ag, t0, t0 + T, t0 + 2 * T, dqt, mc, zs, dl, c, lim, group, tig);
      else
        query_chunk<K, false>(aq, ag, t0, t0 + T, t0 + 2 * T, dqt, mc, zs, dl, c, lim, group,
                              tig);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nd = 0; nd < K / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + 16 * mt + 8 * (e / 2), dd = 8 * nd + 2 * tig + e % 2;
          if (r < S && dd < dh) dqp[dd * S + r] = dqt[mt][4 * nd + e];
        }
  }
}

// A block takes pair blockIdx.x: its key pass (dk, dv), then its query pass
// (dq), both on the one copy of the pair.
template <int K>
__global__ void __launch_bounds__(WG, 4)
sa_bwd_bf16_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ o, const float* __restrict__ m,
                   const float* __restrict__ z, float* __restrict__ dq, float* __restrict__ dk,
                   float* __restrict__ dv, int dh, int S, float scale) {
  const long long base = static_cast<long long>(blockIdx.x) * dh * S;
  const long long rbase = static_cast<long long>(blockIdx.x) * S;
  const float *qp = q + base, *kp = k + base, *vp = v + base, *gp = g + base, *op = o + base;
  const float *mp = m + rbase, *zp = z + rbase;
  const bool whole = bwd_whole(dh, S, K);
  if (whole) {  // the pair's operands into shared memory, one wait for all
    const int n = round4(dh * S), r = round4(S);
    float* raw = attn_smem;
    copy_async(raw, qp, dh * S);
    copy_async(raw + n, kp, dh * S);
    copy_async(raw + 2 * n, vp, dh * S);
    copy_async(raw + 3 * n, gp, dh * S);
    copy_async(raw + 4 * n, op, dh * S);
    copy_async(raw + 5 * n, mp, S);
    copy_async(raw + 5 * n + r, zp, S);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    qp = raw, kp = raw + n, vp = raw + 2 * n, gp = raw + 3 * n, op = raw + 4 * n;
    mp = raw + 5 * n, zp = raw + 5 * n + r;
  }
  const bool vec = vec_ok(S, qp, kp, vp, gp, zp);
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(attn_smem + (whole ? bwd_raw_floats(dh, S) : 0));
  bwd_keys<K>(qp, kp, vp, gp, op, mp, zp, dk + base, dv + base, dh, S, scale, vec, ring, whole);
  __syncthreads();  // the query pass stages its tiles where the key pass's were
  bwd_queries<K>(qp, kp, vp, gp, op, mp, zp, dq + base, dh, S, scale, vec, ring, whole);
}

int fwd_smem(int dh, int S) {
  const int K = dh <= 8 ? 8 : 16;
  return fwd_whole(dh, S, K) ? 4 * fwd_raw_floats(dh, S) + (S + C - 1) / C * fwd_chunk_bytes(K)
                             : fwd_chunk_bytes(K);
}

int bwd_smem(int dh, int S) {
  const int K = dh <= 8 ? 8 : 16;
  return bwd_whole(dh, S, K) ? 4 * bwd_raw_floats(dh, S) + (S + C - 1) / C * bwd_chunk_bytes(K)
                             : bwd_chunk_bytes(K);
}

template <class Kern>
cudaError_t launch(Kern kern, dim3 grid, int smem, void** args, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(kern, grid, dim3(WG), args, static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher runs on `stream` and returns the first CUDA error (0 on
// success).  The caller has checked dtypes, shapes, contiguity, G >= 1,
// 1 <= dh <= 16, S >= 1 within the fp32 kernels' gate and 32-bit offsets
// within a pair, and allocated every output.

// o [G, dh, S], m and inv_z [G, S]
int sa_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* m, void* z, int G,
                int dh, int S, float scale, void* stream) {
  if (dh < 1 || dh > attn::MAX_DH) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&q, &k, &v, &o, &m, &z, &dh, &S, &scale};
  const int smem = fwd_smem(dh, S);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dh <= 8 ? launch(sa_fwd_bf16_kernel<8>, dim3(G), smem, args, st)
                                  : launch(sa_fwd_bf16_kernel<16>, dim3(G), smem, args, st));
}

// dq, dk, dv [G, dh, S] from the forward's o, m and inv_z
int sa_bwd_bf16(const void* q, const void* k, const void* v, const void* g, const void* o,
                const void* m, const void* z, void* dq, void* dk, void* dv, int G, int dh, int S,
                float scale, void* stream) {
  if (dh < 1 || dh > attn::MAX_DH) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&q, &k, &v, &g, &o, &m, &z, &dq, &dk, &dv, &dh, &S, &scale};
  const int smem = bwd_smem(dh, S);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dh <= 8
                              ? launch(sa_bwd_bf16_kernel<8>, dim3(G), smem, args, st)
                              : launch(sa_bwd_bf16_kernel<16>, dim3(G), smem, args, st));
}

const char* sa_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
