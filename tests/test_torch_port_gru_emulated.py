"""The GRU-scan kernels' CUDA sources, run on the CPU by a host emulation.

``ops/csrc/gru_fwd.cu`` and ``gru_bwd.cu`` (TPU kernel rows 14-15) are
compiled with g++ against the stand-in for the CUDA runtime in
``tests/cuda_emulation.py`` (a block's threads are OS threads,
barriers and shuffles are emulated, one block runs at a time), extended by
the width form of ``__shfl_sync`` that the kernels' shuffle groups use.  Their
outputs are held against the plain PyTorch versions in ``ops/gru_cuda.py``
for the three cells, a ragged batch, length-0 rows, each shuffle group
(H 3, 8, 10) and H at the gate (16); the backward runs twice and must be
bit-equal.  This checks the kernels' indexing, masking, shuffles and fixed-
order sums without a GPU; it says nothing about their speed or about the
GPU's compiler, which ``chip_smoke.py`` and the ``cuda`` tests cover.  Skips
where no g++ is installed.

Tolerances: outs within 1e-5 relative and absolute; each gradient within
1e-5 of its largest entry (fp32 sums over units, steps and samples in
another order than PyTorch's).
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch
from cuda_emulation import SHIM

from xdeepfm_tpu_torch.ops import gru_cuda

CSRC = pathlib.Path(gru_cuda.__file__).resolve().with_name("csrc")

# the width form of __shfl_sync: lane `src` of the caller's `width`-lane group
SHFL = r"""
inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  const int lane = emu::tidx.x % 32;
  emu::warp->vals[lane] = v;
  emu::warp->bar.arrive_and_wait();
  const float r = emu::warp->vals[(lane & ~(width - 1)) + (src & (width - 1))];
  emu::warp->bar.arrive_and_wait();
  return r;
}
"""

# Reads ints (cell, B, T, H, nblk), then gi, w, b, att, lengths (int32), h0,
# g as raw buffers; runs gru_fwd, then gru_bwd twice on its outs; writes outs,
# then dgi, datt, dh0, sums of each backward run.
MAIN = r"""
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
alignas(16) float gru_smem[1 << 16];
extern "C" int gru_fwd(int, const void*, const void*, const void*, const void*, const void*,
                       const void*, void*, int, int, int, void*);
extern "C" int gru_bwd(int, const void*, const void*, const void*, const void*, const void*,
                       const void*, const void*, const void*, void*, void*, void*, void*, void*,
                       int, int, int, int, void*);
template <class T> std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) throw 1;
  return v;
}
int main(int argc, char** argv) {
  FILE* in = fopen(argv[1], "rb");
  auto hd = take<int>(in, 5);
  const int cell = hd[0], B = hd[1], T = hd[2], H = hd[3], nblk = hd[4];
  const size_t bt = (size_t)B * T;
  auto gi = take<float>(in, bt * 3 * H), w = take<float>(in, 3 * H * H), b = take<float>(in, 3 * H),
       att = take<float>(in, bt);
  auto len = take<int>(in, B);
  auto h0 = take<float>(in, (size_t)B * H), g = take<float>(in, bt * H);
  fclose(in);
  std::vector<float> outs(bt * H);
  int err = gru_fwd(cell, gi.data(), w.data(), b.data(), cell ? att.data() : nullptr, len.data(),
                    h0.data(), outs.data(), B, T, H, nullptr);
  FILE* out = fopen(argv[2], "wb");
  fwrite(outs.data(), 4, outs.size(), out);
  for (int run = 0; run < 2; ++run) {
    std::vector<float> dgi(bt * 3 * H), datt(bt), dh0((size_t)B * H),
        part((size_t)nblk * 3 * H * (H + 1)), sums(3 * H * (H + 1));
    err |= gru_bwd(cell, g.data(), gi.data(), w.data(), b.data(), cell ? att.data() : nullptr,
                   len.data(), h0.data(), outs.data(), dgi.data(), datt.data(), dh0.data(),
                   part.data(), sums.data(), nblk, B, T, H, nullptr);
    for (auto* v : {&dgi, &datt, &dh0, &sums}) fwrite(v->data(), 4, v->size(), out);
  }
  fclose(out);
  return err;
}
"""


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host emulation")
    d = tmp_path_factory.mktemp("gru_emu")
    (d / "cuda_runtime.h").write_text(SHIM + SHFL)
    (d / "main.cpp").write_text(MAIN)
    exe = d / "gru_emu"
    cmd = [cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-Wno-unknown-pragmas",
           f"-I{d}", f"-I{CSRC}", "-x", "c++", str(CSRC / "gru_fwd.cu"), str(CSRC / "gru_bwd.cu"),
           str(d / "main.cpp"), "-o", str(exe)]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
    return d, exe


def _case(B, T, H, seed):
    """Seeded operands; lengths 0..T with a length-0 row and a full one."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    gi = rng.normal(size=(B, T, 3, H)).astype(f32)
    w = (rng.normal(size=(3, H, H)) / np.sqrt(H)).astype(f32)
    b = (0.3 * rng.normal(size=(3, H))).astype(f32)
    att = rng.uniform(size=(B, T)).astype(f32)
    lengths = rng.integers(0, T + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = 0, T
    h0 = (0.5 * rng.normal(size=(B, H))).astype(f32)
    g = rng.normal(size=(B, T, H)).astype(f32)
    return gi, w, b, att, lengths, h0, g


def _close_to_max(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()) + 1e-7)


# (cell, B, T, H): H 10 (DIEN's width, 16 lanes a sample, 16 samples a
# block) at a ragged B over three blocks for each cell; H at the gate; H 3
# (4 lanes) and 8 (8 lanes, B past one block); T 1 and H 1
CASES = [("gru", 37, 7, 10), ("agru", 37, 7, 10), ("augru", 37, 7, 10), ("augru", 20, 5, 16),
         ("gru", 9, 6, 3), ("agru", 40, 4, 8), ("augru", 3, 1, 1)]


@pytest.mark.parametrize("cell,B,T,H", CASES)
def test_emulated_gru_kernels_match_plain(emulator, cell, B, T, H):
    d, exe = emulator
    ops = _case(B, T, H, seed=B + T + H)
    nblk = gru_cuda.backward_blocks(B, H)
    case, out = d / f"{cell}_{B}_{T}_{H}.bin", d / f"{cell}_{B}_{T}_{H}.out"
    with open(case, "wb") as f:
        np.array([gru_cuda.CELLS[cell], B, T, H, nblk], np.int32).tofile(f)
        for a in ops[:6] + ops[6:]:
            a.tofile(f)
    subprocess.run([str(exe), str(case), str(out)], check=True, timeout=300)
    flat = torch.from_numpy(np.fromfile(out, np.float32))
    sizes = [B * T * H] + 2 * [B * T * 3 * H, B * T, B * H, 3 * H * (H + 1)]
    parts = list(flat.split(sizes))
    gi, w, b, att, lengths, h0, g = map(torch.from_numpy, ops)
    att = None if cell == "gru" else att

    outs = parts[0].reshape(B, T, H)
    want_outs = gru_cuda.gru_forward_reference(cell, gi, w, b, att, lengths, h0)
    torch.testing.assert_close(outs, want_outs, rtol=1e-5, atol=1e-5)
    # frozen past each row's length; a length-0 row keeps h0
    assert torch.equal(outs[0], h0[0].expand(T, H))

    want = gru_cuda.gru_backward_reference(cell, g, gi, w, b, att, lengths, h0, outs)
    runs = []
    for k in range(2):
        dgi, datt, dh0, sums = parts[1 + 4 * k : 5 + 4 * k]
        runs.append(parts[1 + 4 * k : 5 + 4 * k])
        got = (dgi.reshape(B, T, 3, H), sums[: 3 * H * H].reshape(3, H, H),
               sums[3 * H * H :].reshape(3, H), datt.reshape(B, T), dh0.reshape(B, H))
        for name, a, e in zip(("dgi", "dw", "db", "datt", "dh0"), got, want):
            _close_to_max(a, e) if e.abs().max() > 0 else torch.testing.assert_close(a, e)
        past = torch.arange(T)[None, :] >= torch.from_numpy(ops[4]).long()[:, None]
        assert (got[0][past] == 0).all()  # no gradient past a row's length
        if cell == "agru":
            assert (got[0][:, :, 1] == 0).all() and (got[1][1] == 0).all()
        if cell == "gru":
            assert (got[3] == 0).all()
    assert all(torch.equal(a, c) for a, c in zip(*runs))  # bit-equal backward


def test_blocks_and_gate():
    assert [gru_cuda.lanes_per_sample(h) for h in (1, 4, 5, 8, 9, 16)] == [4, 4, 8, 8, 16, 16]
    assert gru_cuda.backward_blocks(4096, 10) == 256 and gru_cuda.backward_blocks(37, 10) == 3
    assert gru_cuda.fits_kernel(50, 16, 1) and not gru_cuda.fits_kernel(50, 17, 4096)
    assert not gru_cuda.fits_kernel(0, 10, 4096) and not gru_cuda.fits_kernel(50, 10, 0)
