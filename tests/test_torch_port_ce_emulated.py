"""The CE kernels' CUDA sources, run on the CPU by a host emulation.

``ops/csrc/ce_fwd.cu`` and ``ce_bwd.cu`` are compiled with g++ against the
stand-in for the CUDA runtime and for ``tc_tf32.cuh`` in
``tests/cuda_emulation.py`` (a block's threads are OS threads, barriers,
shuffles and the tensor-core MMA are emulated, one block runs at a time).
The emulated kernels' outputs are held against the plain PyTorch versions in
``ops/ce_cuda.py``.  This checks the kernels' indexing, masking, tiling,
fragment layouts and partial sums without a GPU; it says nothing about their
speed or about the GPU's compiler, which ``chip_smoke.py`` and the ``cuda``
tests cover.
Skips where no g++ is installed.
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch
from cuda_emulation import SHIM

from xdeepfm_tpu_torch.ops import ce_cuda

CSRC = pathlib.Path(ce_cuda.__file__).resolve().with_name("csrc")

# Reads one case (ints, then h, W, b, t, g, each raw), runs ce_fwd, then
# ce_bwd with the forward's logz, and writes ll, logz, dh, dW, db.
MAIN = r"""
#include <cmath>
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
alignas(16) float ce_smem[1 << 16];
extern "C" int ce_fwd(const void*, const void*, const void*, const void*, const void*, void*,
                      void*, void*, int, int, int, int, int, int, int, void*);
extern "C" int ce_bwd(const void*, const void*, const void*, const void*, const void*,
                      const void*, const void*, void*, void*, int, int, int, void*, void*, void*,
                      void*, int, int, int, int, int, int, int, void*);
template <class T> std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) throw 1;
  return v;
}
int main(int argc, char** argv) {
  FILE* in = fopen(argv[1], "rb");
  auto hd = take<int>(in, 13);
  const int B = hd[0], K = hd[1], V = hd[2], F = hd[3], bf16 = hd[4], nv = hd[5];
  const int splits = hd[6], per_split = hd[7], blocks = hd[8], slices = hd[9], rows = hd[10];
  const int ranges = hd[11], per_range = hd[12];
  auto h = take<float>(in, (size_t)B * K);
  auto w = take<float>(in, (size_t)F * V * K);
  auto b = take<float>(in, (size_t)F * V);
  auto t = take<long long>(in, (size_t)F * B);
  auto g = take<float>(in, (size_t)F * B);
  fclose(in);
  std::vector<float> ll(F * B), logz(F * B), dh(B * K), dw((size_t)F * V * K), db(F * V);
  std::vector<float> dh_part((size_t)splits * B * K), dw_part((size_t)slices * F * V * K),
      db_part((size_t)slices * F * V);
  std::vector<float> part((size_t)3 * ranges * F * B);
  const int* nvp = nv < 0 ? nullptr : &nv;
  int err = ce_fwd(h.data(), w.data(), b.data(), t.data(), nvp, ll.data(), logz.data(),
                   part.data(), ranges, per_range, B, K, V, F, bf16, nullptr);
  for (auto& x : ce_smem) x = NAN;  // a read of a slot never written spreads NaN
  err |= ce_bwd(h.data(), w.data(), b.data(), t.data(), logz.data(), g.data(), nvp, dh.data(),
                dh_part.data(), splits, per_split, blocks, dw.data(), db.data(), dw_part.data(),
                db_part.data(), slices, rows, B, K, V, F, bf16, nullptr);
  FILE* out = fopen(argv[2], "wb");
  for (auto* v : {&ll, &logz, &dh, &dw, &db}) fwrite(v->data(), 4, v->size(), out);
  fclose(out);
  return err;
}
"""


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host emulation")
    d = tmp_path_factory.mktemp("ce_emu")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "cuda_bf16.h").write_text('#pragma once\n#include "cuda_runtime.h"\n')
    (d / "main.cpp").write_text(MAIN)
    exe = d / "ce_emu"
    cmd = [cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-Wno-unknown-pragmas",
           f"-I{d}", f"-I{CSRC}", "-x", "c++", str(CSRC / "ce_fwd.cu"), str(CSRC / "ce_bwd.cu"),
           str(d / "main.cpp"), "-o", str(exe)]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    return d, exe


def _run(emulator, h, W, b, t, g, nv, bf16, split):
    d, exe = emulator
    F, V, K = W.shape
    B = h.shape[0]
    case, out = d / f"case_{B}_{K}_{V}_{F}.bin", d / f"out_{B}_{K}_{V}_{F}.bin"
    with open(case, "wb") as f:
        np.array([B, K, V, F, bf16, -1 if nv is None else nv, *split], np.int32).tofile(f)
        for a, dt in ((h, np.float32), (W, np.float32), (b, np.float32), (t, np.int64),
                      (g, np.float32)):
            np.ascontiguousarray(a, dt).tofile(f)
    subprocess.run([str(exe), str(case), str(out)], check=True, timeout=120)
    flat = np.fromfile(out, np.float32)
    sizes = [F * B, F * B, B * K, F * V * K, F * V]
    parts = np.split(flat, np.cumsum(sizes)[:-1])
    shapes = [(F, B), (F, B), (B, K), (F, V, K), (F, V)]
    return [torch.from_numpy(p.reshape(s).copy()) for p, s in zip(parts, shapes)]


# (B, K, V, F, num_valid, split): split = (splits, pairs per split, dh
# blocks, slices, rows per slice) of the backward, then (vocabulary ranges,
# tiles per range) of the forward.  Ragged B, K and V; a tile straddling num_valid;
# num_valid 0; several partial sums on every side; padded (-1e30) vocabulary
# columns.
CASES = [
    (300, 13, 300, 2, None, (1, 6, 2, 1, 384, 1, 3)),
    (300, 64, 257, 3, 150, (3, 3, 4, 3, 128, 3, 1)),
    (200, 40, 130, 2, 0, (2, 2, 3, 2, 128, 2, 1)),
    (5, 3, 7, 1, 4, (1, 1, 1, 1, 128, 1, 1)),
    (130, 64, 600, 2, 129, (4, 3, 5, 2, 128, 2, 3)),
]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("B,K,V,F,nv,split", CASES)
def test_emulated_kernels_match_plain(emulator, B, K, V, F, nv, split, precision):
    rng = np.random.default_rng(B + K + V + F)
    h = rng.normal(size=(B, K)).astype(np.float32)
    W = (rng.normal(size=(F, V, K)) / np.sqrt(K)).astype(np.float32)
    b = rng.normal(size=(F, V)).astype(np.float32)
    W[:, -3:] = 0.0
    b[:, -3:] = -1e30  # padded columns, as the decoder pads stacked heads
    t = rng.integers(0, V - 3, (F, B))
    g = rng.normal(size=(F, B)).astype(np.float32)
    ll, logz, dh, dW, db = _run(emulator, h, W, b, t, g, nv, int(precision == "bf16"), split)
    ht, Wt, bt, tt, gt = map(torch.from_numpy, (h, W, b, t, g))
    want_ll, want_lz = ce_cuda.ce_rows_forward_reference(ht, Wt, bt, tt, nv, precision)
    torch.testing.assert_close(ll, want_ll, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(logz, want_lz, rtol=1e-5, atol=1e-4)
    want = ce_cuda.ce_rows_backward_reference(gt, ht, Wt, bt, tt, logz, nv, precision)
    for got, w in zip((dh, dW, db), want):
        torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()) + 1e-6)
    if nv is not None:
        assert (ll[:, nv:] == 0).all() and (dh[nv:] == 0).all()
    if nv == 0:
        assert (dW == 0).all() and (db == 0).all()


def test_forward_split_covers_the_vocabulary():
    assert ce_cuda.forward_split(4096, 10112, 26, 132) == (3, 27)
    ranges, per = ce_cuda.forward_split(4096, 10000, 1, 132)
    assert per >= 2 and ranges * per >= 79 > (ranges - 1) * per
    assert ce_cuda.forward_split(5, 7, 1, 132) == (1, 1)


def test_backward_split_covers_the_work():
    # canonical Pro: 26 heads of 10112 columns, 4096 rows, 132 SMs
    splits, per, blocks, slices, rows = ce_cuda.backward_split(4096, 10112, 26, 132)
    assert (slices, rows) == (1, 4096) and splits * per >= 26 * 79 > (splits - 1) * per
    assert blocks == 2 * 132 and 64 * splits >= 16 * 132  # ~16 items a SM, all rows valid
    splits, per, blocks, slices, rows = ce_cuda.backward_split(4096, 10000, 1, 132)
    assert splits * per >= 79 > (splits - 1) * per and blocks == 2 * 132
    assert slices > 1 and rows % 128 == 0 and slices * rows >= 4096 > (slices - 1) * rows
    assert ce_cuda.backward_split(5, 7, 1, 132) == (1, 1, 1, 1, 128)
