"""The GRU-scan kernels' CUDA sources, run on the CPU by a host emulation.

``ops/csrc/gru_fwd.cu`` and ``gru_bwd.cu`` (TPU kernel rows 14-15) are
compiled with g++ against the stand-in for the CUDA runtime in
``tests/cuda_emulation.py`` (a block's threads are fibers, barriers are
emulated, ``cp.async`` is a plain copy, one block runs at a time), extended
by the warp vote ``__reduce_max_sync`` that gives each warp its longest row
and by ``__fdividef``.
Their outputs are held against the plain PyTorch versions in
``ops/gru_cuda.py`` for the three cells: a sample on exactly H lanes at H 10
(3 samples a warp) with a B that is no multiple of 3, H 11 (2 a warp) and
16, H 1, 3 and 8; a ragged batch with length-0 rows; warps that all stop
well before T (every length at most 3 of 20, beside a length-0 row); T past
the staging ring (more than its two chunks of 8 steps).  Shared memory is
NaN-filled before each launch, the backward runs twice and must be
bit-equal, and no launch may ask for more shared memory than a block can
have.  This checks the kernels' indexing, staging, exchange rows, early
stops and fixed-order sums without a GPU; it says nothing about their speed,
about the GPU's compiler or about the order of asynchronous copies, which
``chip_smoke.py`` and the ``cuda`` tests cover.  Skips where no g++ is
installed.

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

# what gru_common.cuh uses beyond SHIM: the warp vote of row_length (the
# largest value over the warp) and the sigmoid's fast division
EXTRA = r"""
inline float __fdividef(float a, float b) { return a / b; }
inline int __reduce_max_sync(unsigned, int v) {
  const int lane = emu::tidx.x % 32;
  emu::warp->vals[lane] = static_cast<float>(v);
  emu::warp->bar.arrive_and_wait();
  float m = emu::warp->vals[0];
  for (int l = 1; l < 32; ++l) m = std::max(m, emu::warp->vals[l]);
  emu::warp->bar.arrive_and_wait();
  return static_cast<int>(m);
}
"""

# Reads ints (cell, B, T, H, nblk), then gi, w, b, att, lengths (int32), h0,
# g as raw buffers; runs gru_fwd, then gru_bwd twice on its outs, each launch
# on NaN-filled shared memory; writes outs, then dgi, datt, dh0, sums of each
# backward run, then the most dynamic shared memory a launch asked for.
MAIN = r"""
#include <cmath>
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
alignas(16) float gru_smem[1 << 16];
void poison() { std::fill(gru_smem, gru_smem + (1 << 16), NAN); }
extern "C" int gru_fwd(int, const void*, const void*, const void*, const void*, const void*,
                       const void*, void*, int, int, int, void*);
extern "C" int gru_bwd(int, const void*, const void*, const void*, const void*, const void*,
                       const void*, const void*, const void*, void*, void*, void*, void*, void*,
                       void*, int, int, int, int, void*);
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
  poison();
  int err = gru_fwd(cell, gi.data(), w.data(), b.data(), cell ? att.data() : nullptr, len.data(),
                    h0.data(), outs.data(), B, T, H, nullptr);
  FILE* out = fopen(argv[2], "wb");
  fwrite(outs.data(), 4, outs.size(), out);
  for (int run = 0; run < 2; ++run) {
    std::vector<float> dgi(bt * 3 * H), datt(bt), dh0((size_t)B * H),
        part((size_t)nblk * 3 * H * (H + 1)), sums(3 * H * (H + 1));  // dw, then db
    poison();
    err |= gru_bwd(cell, g.data(), gi.data(), w.data(), b.data(), cell ? att.data() : nullptr,
                   len.data(), h0.data(), outs.data(), dgi.data(), datt.data(), dh0.data(),
                   part.data(), sums.data(), sums.data() + 3 * H * H, nblk, B, T, H, nullptr);
    for (auto* v : {&dgi, &datt, &dh0, &sums}) fwrite(v->data(), 4, v->size(), out);
  }
  const float high = static_cast<float>(emu::smem_high);
  fwrite(&high, 4, 1, out);
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
    (d / "cuda_runtime.h").write_text(SHIM + EXTRA)
    (d / "main.cpp").write_text(MAIN)
    exe = d / "gru_emu"
    cmd = [cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-Wno-unknown-pragmas",
           f"-I{d}", f"-I{CSRC}", "-x", "c++", str(CSRC / "gru_fwd.cu"), str(CSRC / "gru_bwd.cu"),
           str(d / "main.cpp"), "-o", str(exe)]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
    return d, exe


def _case(B, T, H, seed, longest=None):
    """Seeded operands; lengths 0..longest (default T) with a length-0 row
    and one of the longest."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    top = T if longest is None else longest
    gi = rng.normal(size=(B, T, 3, H)).astype(f32)
    w = (rng.normal(size=(3, H, H)) / np.sqrt(H)).astype(f32)
    b = (0.3 * rng.normal(size=(3, H))).astype(f32)
    att = rng.uniform(size=(B, T)).astype(f32)
    lengths = rng.integers(0, top + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = 0, top
    h0 = (0.5 * rng.normal(size=(B, H))).astype(f32)
    g = rng.normal(size=(B, T, H)).astype(f32)
    return gi, w, b, att, lengths, h0, g


def _close_to_max(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()) + 1e-7)


# (cell, B, T, H): H 10 (DIEN's width, 3 samples a warp, 12 a block) at a
# ragged B over four blocks for each cell; H at the gate; H 3 and 8 (B past
# one block); T 1 and H 1; H 11 (2 samples a warp); all lengths short; T past
# the staging ring at H 10 and 16
CASES = [("gru", 37, 7, 10), ("agru", 37, 7, 10), ("augru", 37, 7, 10), ("augru", 20, 5, 16),
         ("gru", 9, 6, 3), ("agru", 40, 4, 8), ("augru", 3, 1, 1), ("augru", 25, 9, 11),
         ("gru", 30, 20, 10), ("augru", 14, 30, 10), ("agru", 11, 25, 16)]
# cases whose lengths stop at this many steps: every warp stops early
SHORT = {("gru", 30, 20, 10): 3}
SMEM_LIMIT = 232448  # the most dynamic shared memory a Hopper block may ask for


@pytest.mark.parametrize("cell,B,T,H", CASES)
def test_emulated_gru_kernels_match_plain(emulator, cell, B, T, H):
    d, exe = emulator
    ops = _case(B, T, H, seed=B + T + H, longest=SHORT.get((cell, B, T, H)))
    nblk = gru_cuda.backward_blocks(B, H)
    case, out = d / f"{cell}_{B}_{T}_{H}.bin", d / f"{cell}_{B}_{T}_{H}.out"
    with open(case, "wb") as f:
        np.array([gru_cuda.CELLS[cell], B, T, H, nblk], np.int32).tofile(f)
        for a in ops[:6] + ops[6:]:
            a.tofile(f)
    subprocess.run([str(exe), str(case), str(out)], check=True, timeout=300)
    flat = torch.from_numpy(np.fromfile(out, np.float32))
    sizes = [B * T * H] + 2 * [B * T * 3 * H, B * T, B * H, 3 * H * (H + 1)] + [1]
    parts = list(flat.split(sizes))
    assert 0 < parts[-1].item() <= SMEM_LIMIT
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
    assert [gru_cuda.lanes_per_sample(h) for h in (1, 4, 5, 8, 10, 16)] == [1, 4, 5, 8, 10, 16]
    assert [gru_cuda.samples_per_warp(h) for h in (1, 4, 5, 8, 10, 11, 16)] == [32, 8, 6, 4, 3, 2,
                                                                                2]
    assert gru_cuda.backward_blocks(4096, 10) == 342 and gru_cuda.backward_blocks(37, 10) == 4
    assert gru_cuda.backward_blocks(25, 11) == 4 and gru_cuda.backward_blocks(8192, 10) == 683
    assert gru_cuda.fits_kernel(50, 16, 1) and not gru_cuda.fits_kernel(50, 17, 4096)
    assert not gru_cuda.fits_kernel(0, 10, 4096) and not gru_cuda.fits_kernel(50, 10, 0)


def test_bench_gru_runs_the_plain_versions_on_cpu(capsys):
    """``scripts/bench_gru.py`` on the CPU times the plain versions: a line for
    each kernel of each cell at each batch, at DIEN's T 50 and H 10."""
    from xdeepfm_tpu_torch.scripts import bench_gru

    outs = bench_gru.main(["--device", "cpu", "--batches", "3", "2", "--repeats", "1"])
    assert [(o["kernel"], o["batch"], o["cell"]) for o in outs] == [
        (k, b, c) for b in (3, 2) for c in ("gru", "augru") for k in ("gru_fwd", "gru_bwd")]
    for o in outs:
        assert o["device"] == "cpu" and len(o["ms"]) == 1 and "device_ms" not in o
        assert o["max_abs_err_vs_plain"] == 0.0 and (o["T"], o["H"]) == (50, 10)
        assert 0 < o["valid_steps"] <= 50 * o["batch"]
    assert len(capsys.readouterr().out.splitlines()) == len(outs)
