"""The CIN backward's CUDA source, run on the CPU by a host emulation.

``ops/csrc/cin_bwd.cu`` (``cin_dw`` and ``cin_bwd_dx``, both in 3xTF32 on
the tensor cores) is compiled with g++ against the stand-in for the CUDA
runtime and for ``tc_tf32.cuh`` in ``tests/cuda_emulation.py`` (a block's
threads are OS threads, barriers, shuffles and the m16n8k8 MMA are
emulated, one block runs at a time).  The outputs are held against the
plain PyTorch versions in ``ops/cin_cuda.py`` at ragged N, H*M not a
multiple of 128, O below 128 and not a multiple of 4, a strided h, several
row slices and chunk splits, x0 rows wider than the staged 128 columns, a
one-column x0, M padded to each of ``cin_bwd_dx``'s group widths 8, 16, 32
and 64 (a group over two warps), a chunk whose last warps are all padding,
and operands that are not 16-byte aligned.  ``cin_dw`` runs twice and must be bit-equal; the shared
memory is filled with NaN before each launch, so a read of a slot the kernel
did not write spreads NaN into the output, and every slot past the largest
launch's shared bytes must still be NaN afterwards.  This checks the
kernels' indexing, the MMA fragment layouts and the fixed-order slice sums
without a GPU; it says nothing about their speed or about the GPU's
compiler, which ``chip_smoke.py`` and the ``cuda`` tests cover.  Skips where
no g++ is installed.

Tolerance: each output within 1e-4 of its largest entry of the plain fp32
version, as the card tests hold the kernels; and each output's error against
float64 at most twice the plain fp32 version's, or within 1e-6 of its
largest entry, the gate that ``chip_smoke.py`` holds the card to.
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch
from cuda_emulation import SHIM

from xdeepfm_tpu_torch.ops import cin_cuda

CSRC = pathlib.Path(cin_cuda.__file__).resolve().with_name("csrc")
SMEM_FLOATS = 1 << 16

# Reads ints (N, H, M, O, ldh, slices, rows, mp, splits, chunks per split,
# misaligned), then g [N, O], h [N, ldh], x0 [N, M], W [O, H*M]; writes ints
# (smem high-water bytes, untouched-past-it flag), then dW of two runs, dh
# and dx0.  Misaligned: g and x0 start one float past a 16-byte boundary.
MAIN = r"""
#include <cmath>
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
constexpr int kSmem = %d;
alignas(16) float cin_smem[kSmem];
extern "C" int cin_dw(const void*, const void*, int, const void*, void*, int, int, int, int,
                      int, int, void*);
extern "C" int cin_sum_slices(const void*, int, long long, void*, int, void*);
extern "C" int cin_bwd_dx(const void*, const void*, void*, const void*, int, const void*, void*,
                          void*, int, int, int, int, int, int, int, void*);
template <class T> std::vector<T> take(FILE* f, size_t n, size_t pad = 0) {
  std::vector<T> v(n + pad);
  if (n && fread(v.data() + pad, sizeof(T), n, f) != n) throw 1;
  return v;
}
int main(int argc, char** argv) {
  FILE* in = fopen(argv[1], "rb");
  auto hd = take<int>(in, 11);
  const int N = hd[0], H = hd[1], M = hd[2], O = hd[3], ldh = hd[4], slices = hd[5];
  const int rows = hd[6], mp = hd[7], splits = hd[8], per = hd[9], off = hd[10] ? 1 : 0;
  alignas(16) static float pad_g[1 << 20], pad_x[1 << 20];
  auto gv = take<float>(in, (size_t)N * O);
  auto h = take<float>(in, (size_t)N * ldh);
  auto xv = take<float>(in, (size_t)N * M);
  auto w = take<float>(in, (size_t)O * H * M);
  fclose(in);
  float* g = pad_g + 4 + off;
  float* x0 = pad_x + 4 + off;
  std::copy(gv.begin(), gv.end(), g);
  std::copy(xv.begin(), xv.end(), x0);
  const size_t K = (size_t)H * M;
  std::vector<float> part((size_t)slices * O * K), dw(2 * O * K), dh((size_t)N * H),
      dx0((size_t)N * M), dx_part((size_t)splits * N * M);
  int err = 0, untouched = 1;
  for (int run = 0; run < 2; ++run) {
    for (int i = 0; i < kSmem; ++i) cin_smem[i] = NAN;
    float* out = dw.data() + run * O * K;
    err |= cin_dw(g, h.data(), ldh, x0, slices > 1 ? part.data() : out, N, H, M, O, slices, rows,
                  nullptr);
    if (slices > 1) err |= cin_sum_slices(part.data(), slices, (long long)(O * K), out, 3, nullptr);
    for (size_t i = emu::smem_high / 4; i < kSmem; ++i) untouched &= std::isnan(cin_smem[i]);
  }
  if (mp) {  // cin_bwd_dx takes M <= 64 only
    for (int i = 0; i < kSmem; ++i) cin_smem[i] = NAN;
    std::vector<float> wp((size_t)O * H * mp);
    err |= cin_bwd_dx(g, w.data(), wp.data(), h.data(), ldh, x0, dh.data(),
                      splits > 1 ? dx_part.data() : dx0.data(), N, H, M, O, mp, splits, per,
                      nullptr);
    if (splits > 1)
      err |= cin_sum_slices(dx_part.data(), splits, (long long)N * M, dx0.data(), 2, nullptr);
  }
  FILE* o = fopen(argv[2], "wb");
  int head[2] = {(int)emu::smem_high, untouched};
  fwrite(head, 4, 2, o);
  for (auto* v : {&dw, &dh, &dx0}) fwrite(v->data(), 4, v->size(), o);
  fclose(o);
  return err;
}
""" % SMEM_FLOATS


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host emulation")
    d = tmp_path_factory.mktemp("cin_emu")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "main.cpp").write_text(MAIN)
    exe = d / "cin_emu"
    cmd = [cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-Wno-unknown-pragmas",
           f"-I{d}", f"-I{CSRC}", "-x", "c++", str(CSRC / "cin_bwd.cu"), str(d / "main.cpp"),
           "-o", str(exe)]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
    return d, exe


# (N, H, M, O, strided h, blocks a wave, misaligned): ragged N with H*M = 338
# and O = 7 (4-byte g copies), 4 slices; a strided h (split-half) with two O
# tiles of 16-byte g copies; x0 rows of 150 columns, staged a tile column at
# a time; one x0 column, so a tile's h window is 128 wide (H = 140 spans two
# tiles); tiny; misaligned g and x0; then cin_bwd_dx's group widths 16 (a
# strided h, O = 33 over two ring stages) and 64 (M = 40 misaligned with a
# last chunk of one group, M = 64 with two chunk splits)
CASES = [
    (300, 13, 26, 7, False, 12, False),
    (200, 5, 26, 256, True, 8, False),
    (70, 3, 150, 12, False, 8, False),
    (100, 140, 1, 8, True, 4, False),
    (5, 3, 2, 1, False, 1, False),
    (130, 7, 26, 128, False, 4, True),
    (150, 9, 13, 33, True, 4, False),
    (129, 5, 40, 64, False, 2, True),
    (70, 4, 64, 20, False, 8, False),
]


@pytest.mark.parametrize("N,H,M,O,strided,slots,misaligned", CASES)
def test_emulated_cin_backward_matches_plain(emulator, N, H, M, O, strided, slots, misaligned):
    d, exe = emulator
    rng = np.random.default_rng(N * 7 + H * 5 + M * 3 + O)
    g = rng.normal(size=(N, O)).astype(np.float32)
    hw = rng.normal(size=(N, 2 * H if strided else H)).astype(np.float32)
    x0 = rng.normal(size=(N, M)).astype(np.float32)
    W = rng.normal(size=(O, H * M)).astype(np.float32)
    slices, rows = cin_cuda._dw_slices(N, H, M, O, slots)
    mp, splits, per = (cin_cuda._dx_split(N, H, M, O, slots) if M <= cin_cuda.FUSED_MAX_M
                       else (0, 1, 1))
    case, out = d / f"{N}_{H}_{M}_{O}.bin", d / f"{N}_{H}_{M}_{O}.out"
    with open(case, "wb") as f:
        np.array([N, H, M, O, hw.shape[1], slices, rows, mp, splits, per, misaligned],
                 np.int32).tofile(f)
        for a in (g, hw, x0, W):
            a.tofile(f)
    subprocess.run([str(exe), str(case), str(out)], check=True, timeout=300)
    raw = np.fromfile(out, np.uint8)
    smem, untouched = raw[:8].view(np.int32)
    flat = torch.from_numpy(raw[8:].view(np.float32).copy())
    dw1, dw2, dh, dx0 = torch.split(flat, [O * H * M, O * H * M, N * H, N * M])
    assert untouched == 1 and 0 < smem <= 4 * SMEM_FLOATS
    assert torch.equal(dw1, dw2)  # bit-equal from run to run

    gt, ht, xt = torch.from_numpy(g), torch.from_numpy(hw)[:, :H], torch.from_numpy(x0)
    want = cin_cuda.cin_rows_dw_reference(gt, ht, xt)
    got = dw1.reshape(O, H * M)
    top = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * top + 1e-6)
    exact = cin_cuda.cin_rows_dw_reference(gt.double(), ht.double(), xt.double())
    err, plain_err = float((got - exact).abs().max()), float((want - exact).abs().max())
    assert err <= 2 * plain_err or err <= 1e-6 * top, (err, plain_err, top)

    if M <= cin_cuda.FUSED_MAX_M:
        Wt = torch.from_numpy(W)
        want_dh, want_dx0 = cin_cuda.cin_rows_backward_reference(gt, ht, xt, Wt)
        exact = cin_cuda.cin_rows_backward_reference(gt.double(), ht.double(), xt.double(),
                                                     Wt.double())
        for got, want, ex in zip((dh.reshape(N, H), dx0.reshape(N, M)), (want_dh, want_dx0),
                                 exact):
            top = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * top + 1e-6)
            err, plain_err = float((got - ex).abs().max()), float((want - ex).abs().max())
            assert err <= 2 * plain_err or err <= 1e-6 * top, (err, plain_err, top)
