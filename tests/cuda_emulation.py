"""A host emulation of the CUDA runtime, for compiling the port's CUDA
sources (``xdeepfm_tpu_torch/ops/csrc/*.cu``) with g++ and running them on
the CPU.

``SHIM`` is written out as ``cuda_runtime.h``: a block's threads are OS
threads, ``__syncthreads`` and the warp shuffles are barriers, shared memory
is one buffer that the test's main file defines (one block runs at a time),
and ``cudaLaunchKernel`` walks the grid, recording the most dynamic shared
memory a launch asked for in ``emu::smem_high``.  It also stands in for
``tc_tf32.cuh``: ``cvt.rna.tf32`` rounds away the low 13 mantissa bits, the
``mma.sync`` m16n8k8 is computed by the warp's 32 lanes from the PTX ISA's
fragment layout through the warp barrier (reading its operands as TF32,
the low 13 bits ignored), and ``cp.async`` is a plain copy
whose waits are no-ops.  This checks a kernel's indexing, masking, tiling,
fragment layouts and partial sums without a GPU; it says nothing about its
speed, about the GPU's compiler or about the order of asynchronous copies,
which ``chip_smoke.py`` and the ``cuda`` tests cover.
"""

SHIM = r"""
#pragma once
#include <barrier>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
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
inline thread_local dim3 tidx, bidx;
inline thread_local std::barrier<>* block_bar = nullptr;
inline thread_local Warp* warp = nullptr;

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
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < n; ++t)
          threads.emplace_back([&, t] {
            tidx = dim3(t);
            bidx = dim3(x, y, z);
            block_bar = &bar;
            warp = &warps[t / 32];
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
inline void mma3(float (&c)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                 const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  mma(c, as, bb);
  mma(c, ab, bs);
  mma(c, ab, bb);
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
