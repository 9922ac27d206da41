"""A host emulation of the CUDA runtime, for compiling the port's CUDA
sources (``xdeepfm_tpu_torch/ops/csrc/*.cu``) with g++ and running them on
the CPU.

``SHIM`` is written out as ``cuda_runtime.h``: a block's threads are
fibers of one OS thread, switched only where they wait (a round of them
in which none can go on aborts as a deadlock), ``__syncthreads``,
``__syncwarp`` and the warp shuffles are barriers (one a shuffle, vote or
``mma``: their exchange buffers are double, taken in turn), shared memory
is one buffer that the test's main file defines (one block runs at a time),
and ``cudaLaunchKernel`` walks the grid, recording the most dynamic shared
memory a launch asked for in ``emu::smem_high``.  It also stands in for
``tc_tf32.cuh``: ``cvt.rna.tf32`` rounds away the low 13 mantissa bits, the
``mma.sync`` m16n8k8 is computed by the warp's 32 lanes from the PTX ISA's
fragment layout through the warp barrier (reading its operands as TF32,
the low 13 bits ignored), and ``cp.async`` is a plain copy
whose waits are no-ops.  For Hopper's pieces (``cin_fwd.cu``): the
``wgmma`` m64nNk8 tf32 with A from registers is computed by the
warpgroup's 128 threads through a 128-thread barrier, B read through its
descriptor's layout (start address, LBO, SBO; unswizzled); ``mbarrier``s
keep their phase, arrivals and transaction count beside the barrier, so a
producer and its consumers, separate threads, wait on real phases; the
bulk copy is a plain copy that then completes its transactions; a named
barrier is the warpgroup's; ``setmaxnreg`` and the wgmma fences, commits
and waits are no-ops (the emulated MMA is synchronous).  The CIN's bf16
mode adds ``cvt.rn.bf16x2`` (round to nearest even, lo in the low half),
``mul.rn.bf16x2`` (each half's exact product rounded once) and the
``wgmma`` m64nNk16 bf16, A from registers (read by the PTX ISA's fragment
layout) or, like B, from shared memory through a descriptor (core matrices
of 8 rows x 8 bf16); the CE's bf16 mode B read MN-major (trans-b 1, its N
contiguous in the core matrices).  This checks a
kernel's indexing, masking, tiling, fragment layouts, barrier phases and
partial sums without a GPU; it says nothing about its speed, about the
GPU's compiler or about the order of asynchronous copies and MMAs, which
``chip_smoke.py`` and the ``cuda`` tests cover.
"""

SHIM = r"""
#pragma once
#include <ucontext.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <tuple>
#include <type_traits>
#include <utility>
#include <vector>
#include <algorithm>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __maxnreg__(n)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct __attribute__((aligned(16))) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct __attribute__((aligned(16))) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
using std::min;
using std::max;

namespace emu {
// The block's threads are fibers (ucontext) of one OS thread, switched at
// their barriers and waits only, so the emulation's speed does not hang on
// how the OS schedules hundreds of threads.  yield() returns to the block's
// scheduler, which resumes the next live fiber; `progress` counts the
// events that can unblock a fiber (arrivals, completed phases, ended
// fibers), so a round of the fibers without one is a deadlock.
inline unsigned long long progress = 0;
inline void yield();
// a barrier of n fibers: the last arrival opens it
struct Barrier {
  explicit Barrier(std::ptrdiff_t count) : n(count) {}
  void arrive_and_wait() {
    const unsigned g = gen;
    ++progress;
    if (++arrived == n) {
      arrived = 0;
      ++gen;
      return;
    }
    while (gen == g) yield();
  }
  std::ptrdiff_t n, arrived = 0;
  unsigned gen = 0;
};
struct Warp {
  Barrier bar{32};
  float vals[32];  // each lane's value of an exchange that brackets it with two barriers
  // each lane's value of a shuffle or vote and its A and B fragments of an
  // mma, in two buffers that the warp's exchanges take in turn (as a
  // WarpGroup's A fragments): one barrier an exchange
  float xv[2][32];
  uint32_t frag[2][32][6];
};
// a warpgroup's 128 threads: the barrier of its wgmma and its named
// barrier, and each thread's A fragment of one wgmma
struct WarpGroup {
  Barrier bar;
  // each thread's A fragment of a wgmma, in two buffers that calls take in
  // turn: a thread writes call k + 1's while others still read call k's,
  // and the barrier of call k + 1 keeps it from reaching call k + 2's
  uint32_t a[2][128][4];
  explicit WarpGroup(std::ptrdiff_t n) : bar(n) {}
};
// the running fiber's thread: set by the scheduler when it resumes one,
// the call counts saved back when it yields
inline dim3 tidx, bidx;
inline Barrier* block_bar = nullptr;
inline unsigned wgmma_calls = 0;  // this thread's wgmmas with A from registers
inline unsigned warp_calls = 0;   // this thread's warp exchanges (shuffles, votes, mmas)
inline Warp* warp = nullptr;
inline WarpGroup* group = nullptr;
// the emulated shared memory, which the test's main file defines: shared
// addresses (tc::smem_addr, wgmma descriptors) are offsets into it
inline const void* smem_base = nullptr;

inline dim3 grid_dim, block_dim;
inline size_t smem_high = 0;  // the most dynamic shared memory a launch asked for
}  // namespace emu
#define threadIdx emu::tidx
#define blockIdx emu::bidx
#define gridDim emu::grid_dim
#define blockDim emu::block_dim

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int lane = emu::tidx.x % 32;
  float* xv = emu::warp->xv[emu::warp_calls++ % 2];
  xv[lane] = v;
  emu::warp->bar.arrive_and_wait();
  return xv[lane ^ off];
}
// the warp's barrier (the lane-attention kernels' row and column phases)
inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp->bar.arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __expf(float x) { return std::exp(x); }

struct __nv_bfloat16 { uint16_t x; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);  // round to nearest even (no NaN inputs here)
  return {static_cast<uint16_t>(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = static_cast<uint32_t>(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
namespace emu {
inline int sm_count = 2;  // the SMs cudaDeviceGetAttribute reports (a test may set it)
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = emu::sm_count;
  return cudaSuccess;
}

namespace emu {
struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  bool done = false;
  dim3 tidx;
  Warp* warp = nullptr;
  WarpGroup* group = nullptr;
  unsigned wgmma_calls = 0, warp_calls = 0;
};
constexpr size_t kFiberStack = 256 << 10;
inline ucontext_t sched_ctx;
inline std::vector<Fiber>* fibers = nullptr;
inline size_t cur = 0;
inline std::function<void()> body;  // the block's kernel call
inline void fiber_main() {
  body();
  (*fibers)[cur].done = true;
  ++progress;
}  // returns to sched_ctx (uc_link)
inline void yield() {
  Fiber& f = (*fibers)[cur];
  f.wgmma_calls = wgmma_calls;
  f.warp_calls = warp_calls;
  swapcontext(&f.ctx, &sched_ctx);
}
// Runs the block's fibers round by round until all have ended.
inline void run_block(std::vector<Fiber>& fs) {
  fibers = &fs;
  for (size_t live = fs.size(); live > 0;) {
    const unsigned long long before = progress;
    live = 0;
    for (cur = 0; cur < fs.size(); ++cur) {
      Fiber& f = fs[cur];
      if (f.done) continue;
      tidx = f.tidx;
      warp = f.warp;
      group = f.group;
      wgmma_calls = f.wgmma_calls;
      warp_calls = f.warp_calls;
      swapcontext(&sched_ctx, &f.ctx);
      live += !f.done;
    }
    if (live > 0 && progress == before) {
      std::fprintf(stderr, "emulation: deadlock, %zu threads of block (%u, %u, %u) wait\n", live,
                   bidx.x, bidx.y, bidx.z);
      std::abort();
    }
  }
}
// The blocks run one at a time, each with its own barriers, its threads as
// fibers on stacks that the launch allocates once.
template <class... A, size_t... I>
cudaError_t launch(void (*f)(A...), dim3 grid, dim3 block, void** args, std::index_sequence<I...>) {
  std::tuple<std::decay_t<A>...> vals(*static_cast<std::decay_t<A>*>(args[I])...);
  grid_dim = grid;
  block_dim = block;
  const unsigned n = block.x;
  std::vector<Fiber> fs(n);
  for (auto& fb : fs) fb.stack.reset(new char[kFiberStack]);
  body = [&] { std::apply(f, vals); };
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        Barrier bar(n);
        std::unique_ptr<Warp[]> warps(new Warp[n / 32]);
        std::vector<std::unique_ptr<WarpGroup>> groups;
        for (unsigned i = 0; i < n; i += 128)
          groups.emplace_back(new WarpGroup(std::min(128u, n - i)));
        bidx = dim3(x, y, z);
        block_bar = &bar;
        for (unsigned t = 0; t < n; ++t) {
          Fiber& fb = fs[t];
          fb.done = false;
          fb.tidx = dim3(t);
          fb.warp = &warps[t / 32];
          fb.group = groups[t / 128].get();
          fb.wgmma_calls = fb.warp_calls = 0;
          getcontext(&fb.ctx);
          fb.ctx.uc_stack.ss_sp = fb.stack.get();
          fb.ctx.uc_stack.ss_size = kFiberStack;
          fb.ctx.uc_link = &sched_ctx;
          makecontext(&fb.ctx, fiber_main, 0);
        }
        run_block(fs);
      }
  body = nullptr;
  return cudaSuccess;
}
}  // namespace emu

template <class... A>
cudaError_t cudaLaunchKernel(void (*f)(A...), dim3 grid, dim3 block, void** args,
                             size_t smem, cudaStream_t) {
  emu::smem_high = std::max(emu::smem_high, smem);
  return emu::launch(f, grid, block, args, std::index_sequence_for<A...>{});
}

// Host versions of tc_tf32.cuh's functions (which this definition hides).
#define TC_TF32_EMULATED
namespace tc {
// cvt.rna.tf32.f32: the low 13 mantissa bits rounded away, ties away from 0
inline uint32_t tf32(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  return (u + 0x1000u) & 0xffffe000u;
}
inline void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}
// mma.sync m16n8k8 row.col f32.tf32: the warp's 32 lanes post their
// fragments, then each lane sums its own four C entries in the PTX ISA's
// layout (products of TF32 values are exact in fp32); as the tensor cores,
// it reads an operand register as TF32, ignoring its low 13 bits
inline void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int lane = emu::tidx.x % 32;
  uint32_t (*frag)[6] = emu::warp->frag[emu::warp_calls++ % 2];
  uint32_t (&mine)[6] = frag[lane];
  for (int q = 0; q < 4; ++q) mine[q] = a[q];
  mine[4] = b[0];
  mine[5] = b[1];
  emu::warp->bar.arrive_and_wait();
  const int group = lane / 4, tig = lane % 4;
  for (int q = 0; q < 4; ++q) {
    const int row = group + 8 * (q / 2), col = 2 * tig + q % 2;
    float s = c[q];
    for (int k = 0; k < 8; ++k) {
      const uint32_t av = frag[4 * (row % 8) + k % 4][(row >= 8) + 2 * (k >= 4)];
      const uint32_t bv = frag[4 * col + k % 4][4 + (k >= 4)];
      s += __uint_as_float(av & 0xffffe000u) * __uint_as_float(bv & 0xffffe000u);
    }
    c[q] = s;
  }
}
inline void mma_z(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  for (int q = 0; q < 4; ++q) d[q] = 0.f;
  mma(d, a, b);
}
// cp.async: a plain copy, zero-filled past the valid bytes; the waits have
// nothing to wait for
inline void cp_async16(void* dst, const void* src, int bytes) {
  std::memset(dst, 0, 16);
  std::memcpy(dst, src, bytes);
}
inline void cp_async4(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 4);
  else std::memset(dst, 0, 4);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

// Hopper's pieces (cin_fwd.cu).  A shared address is an offset into the
// emulated shared memory.
inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(static_cast<const char*>(p) -
                               static_cast<const char*>(emu::smem_base));
}
// mbarriers with their phase, pending arrivals and transaction count,
// kept beside the barrier's word (the producer and consumers are separate
// threads): a phase completes when its arrivals and transactions are all
// in, and wait(parity) returns once the phase of that parity has completed
struct Mbar {
  int expected = 0, pending = 0;
  long long tx = 0;
  uint32_t phase = 0;
};
inline std::map<const void*, Mbar> mbars;
inline void mbar_settle(Mbar& b) {
  ++emu::progress;
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.expected;
  }
}
inline void mbar_init(uint64_t* bar, int count) {
  Mbar& b = mbars[bar];
  b.expected = b.pending = count;
  b.tx = 0;
  b.phase = 0;
}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint64_t* bar) {
  Mbar& b = mbars.at(bar);
  --b.pending;
  mbar_settle(b);
}
inline void mbar_arrive_tx(uint64_t* bar, int bytes) {
  Mbar& b = mbars.at(bar);
  b.tx += bytes;
  --b.pending;
  mbar_settle(b);
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  const Mbar& b = mbars.at(bar);
  while (b.phase == parity) emu::yield();
}
// the bulk copy: a plain copy that then completes its transactions
inline void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  Mbar& b = mbars.at(bar);
  b.tx -= bytes;
  mbar_settle(b);
}
// the kernels name one barrier a warpgroup
inline void named_sync(int, int) { emu::group->bar.arrive_and_wait(); }
template <int R> inline void regs_inc() {}
template <int R> inline void regs_dec() {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N> inline void wgmma_wait() {}
template <int R> inline void fence_regs(float (&)[R]) {}
// wgmma m64nNk8 tf32, A from registers: the warpgroup's 128 threads post
// their A fragments (warp w rows 16 w.., the m16n8k8 A layout), then each
// sums its own D entries (warp w rows, one m16n8k8 C fragment an 8-column
// group), B read through the descriptor: start address, LBO along K and
// SBO along N, unswizzled 8 x 16-byte core matrices; operands as TF32
template <int N>
inline void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc, int acc) {
  const int t = emu::tidx.x % 128;
  uint32_t (*A)[4] = emu::group->a[emu::wgmma_calls++ % 2];
  for (int q = 0; q < 4; ++q) A[t][q] = a[q];
  emu::group->bar.arrive_and_wait();
  const char* b = static_cast<const char*>(emu::smem_base) + ((desc & 0x3fff) << 4);
  const size_t lbo = ((desc >> 16) & 0x3fff) << 4, sbo = ((desc >> 32) & 0x3fff) << 4;
  const int w = t / 32, grp = (t % 32) / 4, tig = t % 4;
  for (int j = 0; j < N / 8; ++j) {
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * w + grp + 8 * (q / 2), col = 8 * j + 2 * tig + q % 2;
      float s = acc ? d[4 * j + q] : 0.f;
      for (int k = 0; k < 8; ++k) {
        const uint32_t av =
            A[32 * (row / 16) + 4 * (row % 8) + k % 4][(row % 16 >= 8) + 2 * (k >= 4)];
        uint32_t bv;
        std::memcpy(&bv, b + (col / 8) * sbo + (col % 8) * 16 + (k / 4) * lbo + (k % 4) * 4, 4);
        s += __uint_as_float(av & 0xffffe000u) * __uint_as_float(bv & 0xffffe000u);
      }
      d[4 * j + q] = s;
    }
  }
}
// The bf16 forms (the CIN's bf16 mode).  cvt.rn.bf16x2.f32: lo in the low
// half, both rounded to nearest even
inline uint32_t bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__float2bfloat16_rn(lo).x) |
         static_cast<uint32_t>(__float2bfloat16_rn(hi).x) << 16;
}
// mul.rn.bf16x2: each half's product (exact in fp32) rounded to bf16 once
inline uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  auto half = [](uint32_t w, int k) { return __uint_as_float(k ? w & 0xffff0000u : w << 16); };
  return bf16x2(half(a, 0) * half(b, 0), half(a, 1) * half(b, 1));
}
// element k % 2 of a bf16 pair, as fp32
inline float bf16_at(uint32_t v, int k) { return __uint_as_float(k % 2 ? v & 0xffff0000u : v << 16); }
// element (row, k) of a K-major bf16 wgmma operand through its descriptor,
// as fp32: start address, LBO along K and SBO along the rows of unswizzled
// core matrices of 8 rows x 16 bytes
inline float bf16_operand(uint64_t desc, int row, int k) {
  const size_t start = (desc & 0x3fff) << 4;
  const size_t lbo = ((desc >> 16) & 0x3fff) << 4, sbo = ((desc >> 32) & 0x3fff) << 4;
  const size_t at = start + (row / 8) * sbo + (row % 8) * 16 + (k / 8) * lbo + (k % 8) * 2;
  uint16_t v;
  std::memcpy(&v, static_cast<const char*>(emu::smem_base) + at, 2);
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
// wgmma m64nNk16 bf16, A from registers (each warp's 16 rows in the
// m16n8k16 A layout), B K-major through its descriptor
template <int N>
inline void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc, int acc) {
  const int t = emu::tidx.x % 128;
  uint32_t (*A)[4] = emu::group->a[emu::wgmma_calls++ % 2];
  for (int q = 0; q < 4; ++q) A[t][q] = a[q];
  emu::group->bar.arrive_and_wait();
  const int w = t / 32, grp = (t % 32) / 4, tig = t % 4;
  for (int j = 0; j < N / 8; ++j) {
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * w + grp + 8 * (q / 2), col = 8 * j + 2 * tig + q % 2;
      float s = acc ? d[4 * j + q] : 0.f;
      for (int k = 0; k < 16; ++k) {
        const uint32_t av =
            A[32 * (row / 16) + 4 * (row % 8) + (k % 8) / 2][(row % 16 >= 8) + 2 * (k >= 8)];
        s += bf16_at(av, k) * bf16_operand(desc, col, k);
      }
      d[4 * j + q] = s;
    }
  }
}
// wgmma m64nNk16 bf16, A from registers as wgmma_bf16 takes it, B MN-major
// through its descriptor (trans-b 1; the CE bf16 kernels' second products):
// element (k, n) at the start address + (n / 8) SBO + (n % 8) 2 + (k / 8) LBO
// + (k % 8) 16 bytes, N contiguous in 8 x 16-byte core matrices
inline float bf16_operand_mn(uint64_t desc, int n, int k) {
  const size_t start = (desc & 0x3fff) << 4;
  const size_t lbo = ((desc >> 16) & 0x3fff) << 4, sbo = ((desc >> 32) & 0x3fff) << 4;
  const size_t at = start + (n / 8) * sbo + (n % 8) * 2 + (k / 8) * lbo + (k % 8) * 16;
  uint16_t v;
  std::memcpy(&v, static_cast<const char*>(emu::smem_base) + at, 2);
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
template <int N>
inline void wgmma_bf16_mn(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc, int acc) {
  const int t = emu::tidx.x % 128;
  uint32_t (*A)[4] = emu::group->a[emu::wgmma_calls++ % 2];
  for (int q = 0; q < 4; ++q) A[t][q] = a[q];
  emu::group->bar.arrive_and_wait();
  const int w = t / 32, grp = (t % 32) / 4, tig = t % 4;
  for (int j = 0; j < N / 8; ++j) {
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * w + grp + 8 * (q / 2), col = 8 * j + 2 * tig + q % 2;
      float s = acc ? d[4 * j + q] : 0.f;
      for (int k = 0; k < 16; ++k) {
        const uint32_t av =
            A[32 * (row / 16) + 4 * (row % 8) + (k % 8) / 2][(row % 16 >= 8) + 2 * (k >= 8)];
        s += bf16_at(av, k) * bf16_operand_mn(desc, col, k);
      }
      d[4 * j + q] = s;
    }
  }
}
// wgmma m64nNk16 bf16 with both operands in shared memory, K-major,
// through their descriptors (A's 64 rows and B's N columns alike, read by
// bf16_operand): each thread sums
// its own D entries (warp w rows 16 w.., an m16n8 C fragment an 8-column
// group) from the operands as they stand in shared memory
template <int N>
inline void wgmma_bf16_ss(float (&d)[N / 2], uint64_t adesc, uint64_t bdesc, int acc) {
  // row `row` of a K-major operand, its 16 k as fp32
  auto row_of = [](uint64_t desc, int row, float (&out)[16]) {
    for (int k = 0; k < 16; ++k) out[k] = bf16_operand(desc, row, k);
  };
  const int t = emu::tidx.x % 128, w = t / 32, grp = (t % 32) / 4, tig = t % 4;
  float a[2][16], b[16];
  for (int hf = 0; hf < 2; ++hf) row_of(adesc, 16 * w + grp + 8 * hf, a[hf]);
  for (int j = 0; j < N / 8; ++j)
    for (int u = 0; u < 2; ++u) {
      row_of(bdesc, 8 * j + 2 * tig + u, b);
      for (int hf = 0; hf < 2; ++hf) {
        float s = acc ? d[4 * j + 2 * hf + u] : 0.f;
        for (int k = 0; k < 16; ++k) s += a[hf][k] * b[k];
        d[4 * j + 2 * hf + u] = s;
      }
    }
}
}  // namespace tc
"""

# What the attention sources use beyond SHIM (appended to it where they are
# compiled): the routines' 8- and 16-byte words, the backward's lane-indexed
# shuffle of TF32 bits, the forward's warp vote, and the block's rsqrtf.
ATTN_EXTRA = r"""
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
struct __attribute__((aligned(8))) float2 { float x, y; };
struct __attribute__((aligned(8))) uint2 { uint32_t x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  const int lane = emu::tidx.x % 32;
  float* xv = emu::warp->xv[emu::warp_calls++ % 2];
  xv[lane] = __uint_as_float(v);
  emu::warp->bar.arrive_and_wait();
  return __float_as_uint(xv[src % 32]);
}
inline int __any_sync(unsigned, int p) {
  const int lane = emu::tidx.x % 32;
  float* xv = emu::warp->xv[emu::warp_calls++ % 2];
  xv[lane] = p ? 1.f : 0.f;
  emu::warp->bar.arrive_and_wait();
  int r = 0;
  for (int l = 0; l < 32; ++l) r |= xv[l] != 0.f;
  return r;
}
"""
