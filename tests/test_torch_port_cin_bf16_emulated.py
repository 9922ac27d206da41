"""The CIN's bf16 kernels, run on the CPU by a host emulation.

``cin_fwd_bf16`` (``ops/csrc/cin_fwd.cu``: one bf16 ``wgmma`` m64n128k16 a
k16 step, A built in registers from h and x0 rounded to bf16, W staged in
bf16 core matrices through bulk copies on mbarriers) and
``cin_bwd_dx_bf16`` (``ops/csrc/cin_bwd.cu``: Z = g W on ``mma.sync``
m16n8k16 bf16, the fp32 epilogue) are compiled with g++ against the
stand-in for the CUDA runtime and ``tc_tf32.cuh`` in
``tests/cuda_emulation.py``, whose bf16 MMAs read each 16-bit half of an
operand register by the PTX ISA's fragment layouts.  Two cases, each running
both kernels twice with shared memory NaN-filled before each launch: layer
0's H = M = 26 (H padded to 32, K 676 over 26 chunks of 32) with a strided
h, O = 130 over two column tiles and a tail tile split along K; and h of
140 columns over two forward launches (H 128, then 12 padded to 16, the
second adding into the first's output) with a misaligned h, M = 7 (the
backward's group width 8) and O = 20.  Skips where no g++ is installed.

Tolerance: each output within 1e-4 of its largest entry of the bf16 plain
version (``cin_rows_reference_bf16``, ``cin_rows_backward_reference_bf16``:
the same rounded operands, fp32 sums in another order), and its error
against float64 of the same rounded operands at most twice the plain
version's, or within 1e-6 of its largest entry, the gate that
``chip_smoke.py`` holds the card to; bit-equal over two runs.
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

# Reads ints (N, H, M, O, ldh, grid, mp, splits, chunks per split,
# misaligned), then h [N, ldh], x0 [N, M], W [O, H*M], b [O], g [N, O];
# runs cin_fwd_bf16 over h blocks of FWD_H_BLOCK columns as ops/cin_cuda.py
# does, then cin_bwd_dx_bf16, each twice, shared memory NaN-filled before
# each launch; writes ints (smem high-water bytes, untouched-past-it flag),
# then out of both runs, then dh and dx0 of both.  Misaligned: h starts one
# float past a 16-byte boundary.
MAIN = r"""
#include <cmath>
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
constexpr int kSmem = %d, kBlock = %d;
alignas(128) float cin_smem[kSmem];
extern "C" int cin_fwd_bf16_scratch_floats(int, int, int, int, int);
extern "C" int cin_fwd_bf16(const void*, int, const void*, const void*, int, int, const void*,
                            void*, void*, int, int, int, int, int, int, void*);
extern "C" int cin_bwd_dx_bf16(const void*, const void*, void*, const void*, int, const void*,
                               void*, void*, int, int, int, int, int, int, int, void*);
extern "C" int cin_sum_slices(const void*, int, long long, void*, int, void*);
template <class T> std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) throw 1;
  return v;
}
int main(int argc, char** argv) {
  emu::smem_base = cin_smem;
  FILE* in = fopen(argv[1], "rb");
  auto hd = take<int>(in, 10);
  const int N = hd[0], H = hd[1], M = hd[2], O = hd[3], ldh = hd[4], grid = hd[5];
  const int mp = hd[6], splits = hd[7], per = hd[8], off = hd[9] ? 1 : 0;
  auto hv = take<float>(in, (size_t)N * ldh);
  auto x0 = take<float>(in, (size_t)N * M);
  auto w = take<float>(in, (size_t)O * H * M);
  auto b = take<float>(in, O);
  auto g = take<float>(in, (size_t)N * O);
  fclose(in);
  alignas(16) static float pad_h[1 << 20];
  float* h = pad_h + 4 + off;
  std::copy(hv.begin(), hv.end(), h);
  std::vector<float> out(2 * (size_t)N * O), dh(2 * (size_t)N * H), dx0(2 * (size_t)N * M);
  std::vector<float> wp((size_t)O * H * mp), part((size_t)splits * N * M);
  int err = 0, untouched = 1;
  auto check = [&] {
    for (size_t i = emu::smem_high / 4; i < kSmem; ++i) untouched &= std::isnan(cin_smem[i]);
  };
  for (int run = 0; run < 2; ++run) {
    for (int h0 = 0; h0 < H; h0 += kBlock) {
      const int hb = std::min(kBlock, H - h0);
      const int n = cin_fwd_bf16_scratch_floats(N, hb, M, O, grid);
      if (n < 0) return 3;
      std::vector<float> wsp(n);
      for (int i = 0; i < kSmem; ++i) cin_smem[i] = NAN;
      err |= cin_fwd_bf16(h + h0, ldh, x0.data(), w.data(), H * M, h0, b.data(), wsp.data(),
                          out.data() + run * (size_t)N * O, N, hb, M, O, h0 > 0, grid, nullptr);
      check();
    }
    for (int i = 0; i < kSmem; ++i) cin_smem[i] = NAN;
    float* dx = dx0.data() + run * (size_t)N * M;
    err |= cin_bwd_dx_bf16(g.data(), w.data(), wp.data(), h, ldh, x0.data(),
                           dh.data() + run * (size_t)N * H, splits > 1 ? part.data() : dx, N, H,
                           M, O, mp, splits, per, nullptr);
    if (splits > 1) err |= cin_sum_slices(part.data(), splits, (long long)N * M, dx, 2, nullptr);
    check();
  }
  FILE* o = fopen(argv[2], "wb");
  int head[2] = {(int)emu::smem_high, untouched};
  fwrite(head, 4, 2, o);
  for (auto* v : {&out, &dh, &dx0}) fwrite(v->data(), 4, v->size(), o);
  fclose(o);
  return err;
}
""" % (SMEM_FLOATS, cin_cuda.FWD_H_BLOCK)


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host emulation")
    d = tmp_path_factory.mktemp("cin_bf16_emu")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "main.cpp").write_text(MAIN)
    exe = d / "cin_bf16_emu"
    cmd = [cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-Wno-unknown-pragmas",
           f"-I{d}", f"-I{CSRC}", "-x", "c++", str(CSRC / "cin_fwd.cu"), str(CSRC / "cin_bwd.cu"),
           str(d / "main.cpp"), "-o", str(exe)]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
    return d, exe


def _gate(label, got, want, exact):
    """Within 1e-4 of the largest entry of the bf16 plain version, and its
    error against float64 at most twice the plain version's (or 1e-6 of the
    largest entry)."""
    top = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * top + 1e-6, msg=label)
    err = float((got.double() - exact).abs().max())
    plain = float((want.double() - exact).abs().max())
    assert err <= 2 * plain or err <= 1e-6 * top, (label, err, plain, top)


# (N, H, M, O, strided h, persistent blocks, misaligned h): see the module's
# docstring
CASES = [
    (300, 26, 26, 130, True, 2, False),
    (150, 140, 7, 20, False, 1, True),
]


@pytest.mark.parametrize("N,H,M,O,strided,grid,misaligned", CASES)
def test_emulated_cin_bf16_kernels_match_plain(emulator, N, H, M, O, strided, grid, misaligned):
    d, exe = emulator
    rng = np.random.default_rng(N * 7 + H * 5 + M * 3 + O)
    hw = rng.normal(size=(N, 2 * H if strided else H)).astype(np.float32)
    x0 = rng.normal(size=(N, M)).astype(np.float32)
    W = rng.normal(size=(O, H * M)).astype(np.float32)
    b = rng.normal(size=O).astype(np.float32)
    g = rng.normal(size=(N, O)).astype(np.float32)
    mp, splits, per = cin_cuda._dx_split(N, H, M, O, 2)
    tag = f"{N}_{H}_{M}_{O}"
    case, out = d / f"{tag}.bin", d / f"{tag}.out"
    with open(case, "wb") as f:
        np.array([N, H, M, O, hw.shape[1], grid, mp, splits, per, misaligned],
                 np.int32).tofile(f)
        for a in (hw, x0, W, b, g):
            a.tofile(f)
    subprocess.run([str(exe), str(case), str(out)], check=True, timeout=600)
    raw = np.fromfile(out, np.uint8)
    smem, untouched = raw[:8].view(np.int32)
    assert untouched == 1 and 0 < smem <= 4 * SMEM_FLOATS
    flat = torch.from_numpy(raw[8:].view(np.float32).copy())
    outs, dhs, dx0s = torch.split(flat, [2 * N * O, 2 * N * H, 2 * N * M])
    outs, dhs, dx0s = outs.view(2, N, O), dhs.view(2, N, H), dx0s.view(2, N, M)
    for runs in (outs, dhs, dx0s):
        assert torch.equal(runs[0], runs[1])  # bit-equal from run to run

    h, tx0, tW, tb, tg = (torch.from_numpy(a) for a in (hw[:, :H], x0, W, b, g))
    _gate("out", outs[0], cin_cuda.cin_rows_reference_bf16(h, tx0, tW, tb),
          cin_cuda.cin_rows_reference_bf16(h.double(), tx0.double(), tW.double(), tb.double()))
    want = cin_cuda.cin_rows_backward_reference_bf16(tg, h, tx0, tW)
    exact = cin_cuda.cin_rows_backward_reference_bf16(tg.double(), h.double(), tx0.double(),
                                                      tW.double())
    for label, got, w_, e in zip(("dh", "dx0"), (dhs[0], dx0s[0]), want, exact):
        _gate(label, got, w_, e)
    # the bf16 mode differs from fp32: the kernels did round
    assert float((outs[0] - cin_cuda.cin_rows_reference(h, tx0, tW, tb)).abs().max()) > 1e-3
