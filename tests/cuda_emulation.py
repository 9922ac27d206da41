"""A host emulation of the CUDA runtime, for compiling the port's CUDA
sources (``xdeepfm_tpu_torch/ops/csrc/*.cu``) with g++ and running them on
the CPU.

``SHIM`` is written out as ``cuda_runtime.h``: a block's threads are OS
threads, ``__syncthreads``, ``__syncwarp`` and the warp shuffles are
barriers, shared memory
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
and waits are no-ops (the emulated MMA is synchronous).  This checks a
kernel's indexing, masking, tiling, fragment layouts, barrier phases and
partial sums without a GPU; it says nothing about its speed, about the
GPU's compiler or about the order of asynchronous copies and MMAs, which
``chip_smoke.py`` and the ``cuda`` tests cover.
"""

SHIM = r"""
#pragma once
#include <barrier>
#include <cfloat>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
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
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
using std::min;
using std::max;

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  float vals[32];
  uint32_t frag[32][6];  // each lane's A and B fragments of one mma
};
// a warpgroup's 128 threads: the barrier of its wgmma and its named
// barrier, and each thread's A fragment of one wgmma
struct WarpGroup {
  std::barrier<> bar;
  uint32_t a[128][4];
  explicit WarpGroup(std::ptrdiff_t n) : bar(n) {}
};
inline thread_local dim3 tidx, bidx;
inline thread_local std::barrier<>* block_bar = nullptr;
inline thread_local Warp* warp = nullptr;
inline thread_local WarpGroup* group = nullptr;
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
  emu::warp->vals[lane] = v;
  emu::warp->bar.arrive_and_wait();
  const float r = emu::warp->vals[lane ^ off];
  emu::warp->bar.arrive_and_wait();
  return r;
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

namespace emu {
template <class... A, size_t... I>
cudaError_t launch(void (*f)(A...), dim3 grid, dim3 block, void** args, std::index_sequence<I...>) {
  std::tuple<std::decay_t<A>...> vals(*static_cast<std::decay_t<A>*>(args[I])...);
  grid_dim = grid;
  block_dim = block;
  const unsigned n = block.x;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bar(n);
        std::unique_ptr<Warp[]> warps(new Warp[n / 32]);
        std::vector<std::unique_ptr<WarpGroup>> groups;
        for (unsigned i = 0; i < n; i += 128)
          groups.emplace_back(new WarpGroup(std::min(128u, n - i)));
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < n; ++t)
          threads.emplace_back([&, t] {
            tidx = dim3(t);
            bidx = dim3(x, y, z);
            block_bar = &bar;
            warp = &warps[t / 32];
            group = groups[t / 128].get();
            std::apply(f, vals);
          });
        for (auto& th : threads) th.join();
      }
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
  uint32_t (&mine)[6] = emu::warp->frag[lane];
  for (int q = 0; q < 4; ++q) mine[q] = a[q];
  mine[4] = b[0];
  mine[5] = b[1];
  emu::warp->bar.arrive_and_wait();
  const int group = lane / 4, tig = lane % 4;
  for (int q = 0; q < 4; ++q) {
    const int row = group + 8 * (q / 2), col = 2 * tig + q % 2;
    float s = c[q];
    for (int k = 0; k < 8; ++k) {
      const uint32_t av = emu::warp->frag[4 * (row % 8) + k % 4][(row >= 8) + 2 * (k >= 4)];
      const uint32_t bv = emu::warp->frag[4 * col + k % 4][4 + (k >= 4)];
      s += __uint_as_float(av & 0xffffe000u) * __uint_as_float(bv & 0xffffe000u);
    }
    c[q] = s;
  }
  emu::warp->bar.arrive_and_wait();
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
inline std::mutex mbar_mu;
inline std::condition_variable mbar_cv;
inline std::map<const void*, Mbar> mbars;
inline void mbar_settle(Mbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.expected;
    mbar_cv.notify_all();
  }
}
inline void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lk(mbar_mu);
  mbars[bar] = Mbar{count, count, 0, 0};
}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lk(mbar_mu);
  Mbar& b = mbars.at(bar);
  --b.pending;
  mbar_settle(b);
}
inline void mbar_arrive_tx(uint64_t* bar, int bytes) {
  std::lock_guard<std::mutex> lk(mbar_mu);
  Mbar& b = mbars.at(bar);
  b.tx += bytes;
  --b.pending;
  mbar_settle(b);
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> lk(mbar_mu);
  mbar_cv.wait(lk, [&] { return mbars.at(bar).phase != parity; });
}
// the bulk copy: a plain copy that then completes its transactions
inline void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> lk(mbar_mu);
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
  emu::WarpGroup* G = emu::group;
  for (int q = 0; q < 4; ++q) G->a[t][q] = a[q];
  G->bar.arrive_and_wait();
  const char* b = static_cast<const char*>(emu::smem_base) + ((desc & 0x3fff) << 4);
  const size_t lbo = ((desc >> 16) & 0x3fff) << 4, sbo = ((desc >> 32) & 0x3fff) << 4;
  const int w = t / 32, grp = (t % 32) / 4, tig = t % 4;
  for (int j = 0; j < N / 8; ++j) {
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * w + grp + 8 * (q / 2), col = 8 * j + 2 * tig + q % 2;
      float s = acc ? d[4 * j + q] : 0.f;
      for (int k = 0; k < 8; ++k) {
        const uint32_t av =
            G->a[32 * (row / 16) + 4 * (row % 8) + k % 4][(row % 16 >= 8) + 2 * (k >= 4)];
        uint32_t bv;
        std::memcpy(&bv, b + (col / 8) * sbo + (col % 8) * 16 + (k / 4) * lbo + (k % 4) * 4, 4);
        s += __uint_as_float(av & 0xffffe000u) * __uint_as_float(bv & 0xffffe000u);
      }
      d[4 * j + q] = s;
    }
  }
  G->bar.arrive_and_wait();
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
  emu::warp->vals[lane] = __uint_as_float(v);
  emu::warp->bar.arrive_and_wait();
  const uint32_t r = __float_as_uint(emu::warp->vals[src % 32]);
  emu::warp->bar.arrive_and_wait();
  return r;
}
inline int __any_sync(unsigned, int p) {
  const int lane = emu::tidx.x % 32;
  emu::warp->vals[lane] = p ? 1.f : 0.f;
  emu::warp->bar.arrive_and_wait();
  int r = 0;
  for (int l = 0; l < 32; ++l) r |= emu::warp->vals[l] != 0.f;
  emu::warp->bar.arrive_and_wait();
  return r;
}
"""
