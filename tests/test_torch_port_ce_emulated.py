"""The CE kernels' CUDA sources, run on the CPU by a host emulation.

``ops/csrc/ce_fwd.cu`` and ``ce_bwd.cu`` (both over the logit walk of
``ce_tc.cuh``) are compiled with g++ against the stand-in for the CUDA
runtime and for ``tc_tf32.cuh`` in ``tests/cuda_emulation.py`` (a block's
threads are fibers, barriers, shuffles, the warp vote and the
tensor-core MMA are emulated, one block runs at a time).  The emulated
kernels' outputs are held against the plain PyTorch versions in
``ops/ce_cuda.py``, and ll and logz against float64 by the gate that
``chip_smoke.py`` holds the card to.  The shared memory is filled with NaN
before each launch, so a read of a slot the kernel did not write spreads NaN
into an output.  This checks
the kernels' indexing, masking, tiling, fragment layouts and partial sums
without a GPU; it says nothing about their speed or about the GPU's
compiler, which ``chip_smoke.py`` and the ``cuda`` tests cover.
Skips where no g++ is installed.
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch
from cuda_emulation import ATTN_EXTRA, SHIM

from xdeepfm_tpu_torch.ops import ce_cuda

CSRC = pathlib.Path(ce_cuda.__file__).resolve().with_name("csrc")

# Reads one case (ints, then h, W, b, t, g, each raw), runs ce_fwd, then
# ce_bwd with the forward's logz, and writes ll, logz, dh, dW, db.  Misaligned: h, W and b start one float past a 16-byte
# boundary.
MAIN = r"""
#include <cmath>
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
alignas(16) float ce_smem[1 << 16];
extern "C" int ce_fwd(const void*, const void*, const void*, const void*, const void*, void*,
                      void*, void*, int, int, int, int, int, int, int, int, void*);
extern "C" int ce_bwd(const void*, const void*, const void*, const void*, const void*,
                      const void*, const void*, void*, void*, int, int, int, void*, void*, void*,
                      void*, int, int, int, int, int, int, void*);
template <class T> std::vector<T> take(FILE* f, size_t n, size_t pad = 0) {
  std::vector<T> v(n + pad);
  if (n && fread(v.data() + pad, sizeof(T), n, f) != n) throw 1;
  return v;
}
int main(int argc, char** argv) {
  FILE* in = fopen(argv[1], "rb");
  auto hd = take<int>(in, 15);
  const int B = hd[0], K = hd[1], V = hd[2], F = hd[3], nv = hd[4];
  const int splits = hd[5], per_split = hd[6], blocks = hd[7], slices = hd[8], rows = hd[9];
  const int f_splits = hd[10], f_per = hd[11], f_blocks = hd[12], slots = hd[13];
  const int off = hd[14] ? 1 : 0;
  auto hv = take<float>(in, (size_t)B * K, 4);
  auto wv = take<float>(in, (size_t)F * V * K, 4);
  auto bv = take<float>(in, (size_t)F * V, 4);
  auto t = take<long long>(in, (size_t)F * B);
  auto g = take<float>(in, (size_t)F * B);
  fclose(in);
  // the vectors' data are 16-byte aligned; the operands start 4 or 3 floats in
  const float* h = hv.data() + 4 - off;
  const float* w = wv.data() + 4 - off;
  const float* b = bv.data() + 4 - off;
  if (off) {
    std::copy(hv.begin() + 4, hv.end(), hv.begin() + 3);
    std::copy(wv.begin() + 4, wv.end(), wv.begin() + 3);
    std::copy(bv.begin() + 4, bv.end(), bv.begin() + 3);
  }
  std::vector<float> ll(F * B), logz(F * B), dh(B * K), dw((size_t)F * V * K), db(F * V);
  std::vector<float> dh_part((size_t)splits * B * K), dw_part((size_t)slices * F * V * K),
      db_part((size_t)slices * F * V);
  std::vector<float> part((size_t)3 * slots * F * B);
  const int* nvp = nv < 0 ? nullptr : &nv;
  int err = 0;
  for (auto& x : ce_smem) x = NAN;  // a read of a slot never written spreads NaN
  err |= ce_fwd(h, w, b, t.data(), nvp, ll.data(), logz.data(), part.data(), slots, f_splits,
                f_per, f_blocks, B, K, V, F, nullptr);
  for (auto& x : ce_smem) x = NAN;
  err |= ce_bwd(h, w, b, t.data(), logz.data(), g.data(), nvp, dh.data(), dh_part.data(),
                splits, per_split, blocks, dw.data(), db.data(), dw_part.data(),
                db_part.data(), slices, rows, B, K, V, F, nullptr);
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
    (d / "cuda_runtime.h").write_text(SHIM + ATTN_EXTRA)
    (d / "main.cpp").write_text(MAIN)
    exe = d / "ce_emu"
    cmd = [cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-Wno-unknown-pragmas",
           f"-I{d}", f"-I{CSRC}", "-x", "c++", str(CSRC / "ce_fwd.cu"), str(CSRC / "ce_bwd.cu"),
           str(d / "main.cpp"), "-o", str(exe)]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    return d, exe


def _run(emulator, h, W, b, t, g, nv, split, misaligned):
    """(ll, logz, dh, dW, db) of the emulated kernels."""
    d, exe = emulator
    F, V, K = W.shape
    B = h.shape[0]
    bwd, fwd = split
    slots = ce_cuda.forward_slots(V, fwd[0], fwd[1])
    case, out = d / f"case_{B}_{K}_{V}_{F}.bin", d / f"out_{B}_{K}_{V}_{F}.bin"
    with open(case, "wb") as f:
        np.array([B, K, V, F, -1 if nv is None else nv, *bwd, *fwd, slots, misaligned],
                 np.int32).tofile(f)
        for a, dt in ((h, np.float32), (W, np.float32), (b, np.float32), (t, np.int64),
                      (g, np.float32)):
            np.ascontiguousarray(a, dt).tofile(f)
    subprocess.run([str(exe), str(case), str(out)], check=True, timeout=120)
    sizes = [F * B, F * B, B * K, F * V * K, F * V]
    shapes = [(F, B), (F, B), (B, K), (F, V, K), (F, V)]
    parts = np.split(np.fromfile(out, np.float32), np.cumsum(sizes)[:-1])
    return [torch.from_numpy(p.reshape(s).copy()) for p, s in zip(parts, shapes)]


# (B, K, V, F, num_valid, split, misaligned): split = ((splits, pairs per
# split, dh blocks, slices, rows per slice) of the backward, (splits, pairs
# per split, blocks) of the forward).  Ragged B, K and V; 64-row items
# straddling num_valid (150, 129, 70); num_valid 0; forward splits that
# cross from one head into the next and heads reached by two or three
# splits, one pair a split, fewer persistent blocks than items; padded
# (-1e30) vocabulary columns; h, W and b one float off 16-byte alignment.
CASES = [
    (300, 13, 300, 2, None, ((1, 6, 2, 1, 384), (2, 4, 3)), False),
    (300, 64, 257, 3, 150, ((3, 3, 4, 3, 128), (9, 1, 4)), False),
    (200, 40, 130, 2, 0, ((2, 2, 3, 2, 128), (1, 4, 1)), False),
    (5, 3, 7, 1, 4, ((1, 1, 1, 1, 128), (1, 1, 1)), False),
    (130, 64, 600, 2, 129, ((4, 3, 5, 2, 128), (2, 5, 3)), False),
    (100, 21, 390, 3, 70, ((3, 5, 2, 1, 128), (3, 5, 2)), True),
]


def _f64_gate(got, want, exact):
    """The 3xTF32 gate of ``chip_smoke.py``: the error against float64 at
    most twice the plain fp32 version's, or within 1e-6 of the largest
    entry."""
    err = float((got.double() - exact).abs().max())
    plain = float((want.double() - exact).abs().max())
    assert err <= 2 * plain or err <= 1e-6 * float(exact.abs().max()), (err, plain)


# the bf16 mode has kernels of its own (test_torch_port_ce_bf16_emulated.py)
@pytest.mark.parametrize("precision", ["fp32"])
@pytest.mark.parametrize("B,K,V,F,nv,split,misaligned", CASES)
def test_emulated_kernels_match_plain(emulator, B, K, V, F, nv, split, misaligned, precision):
    rng = np.random.default_rng(B + K + V + F)
    h = rng.normal(size=(B, K)).astype(np.float32)
    W = (rng.normal(size=(F, V, K)) / np.sqrt(K)).astype(np.float32)
    b = rng.normal(size=(F, V)).astype(np.float32)
    W[:, -3:] = 0.0
    b[:, -3:] = -1e30  # padded columns, as the decoder pads stacked heads
    t = rng.integers(0, V - 3, (F, B))
    g = rng.normal(size=(F, B)).astype(np.float32)
    ll, logz, dh, dW, db = _run(emulator, h, W, b, t, g, nv, split, misaligned)
    ht, Wt, bt, tt, gt = map(torch.from_numpy, (h, W, b, t, g))
    want_ll, want_lz = ce_cuda.ce_rows_forward_reference(ht, Wt, bt, tt, nv, precision)
    torch.testing.assert_close(ll, want_ll, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(logz, want_lz, rtol=1e-5, atol=1e-4)
    if nv != 0:
        exact = ce_cuda.ce_rows_forward_reference(ht.double(), Wt.double(), bt.double(), tt, nv)
        for got, want, ex in zip((ll, logz), (want_ll, want_lz), exact):
            _f64_gate(got, want, ex)
    want = ce_cuda.ce_rows_backward_reference(gt, ht, Wt, bt, tt, logz, nv, precision)
    for got, w in zip((dh, dW, db), want):
        torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()) + 1e-6)
    if nv is not None:
        assert (ll[:, nv:] == 0).all() and (logz[:, nv:] == 0).all() and (dh[nv:] == 0).all()
    if nv == 0:
        assert (dW == 0).all() and (db == 0).all()


def test_forward_split_covers_the_vocabulary():
    # canonical Pro: the backward's item walk; a head of 79 tiles is reached
    # by at most 4 splits of 33 pairs, each writing 2 partials
    assert ce_cuda.forward_split(4096, 10112, 26, 132) == (63, 33, 264, 8)
    assert ce_cuda.forward_split(4096, 10112, 26, 132)[:3] == \
        ce_cuda.backward_split(4096, 10112, 26, 132)[:3]
    for B, V, F, sms in ((4096, 10112, 26, 132), (4096, 10000, 1, 132), (5, 7, 1, 132),
                         (1001, 1000, 3, 132), (300, 300, 2, 2), (4096, 10112, 26, 114)):
        splits, per, blocks, slots = ce_cuda.forward_split(B, V, F, sms)
        tiles = -(-V // 128)
        pairs = F * tiles
        assert splits * per >= pairs > (splits - 1) * per  # every pair, no empty split
        assert 1 <= blocks <= 2 * sms and blocks <= -(-B // 64) * splits
        reach = max(((f + 1) * tiles - 1) // per - f * tiles // per + 1 for f in range(F))
        assert slots >= 2 * reach  # every partial of a head has its slot
    assert ce_cuda.forward_split(5, 7, 1, 132) == (1, 1, 1, 2)


def test_backward_split_covers_the_work():
    # canonical Pro: 26 heads of 10112 columns, 4096 rows, 132 SMs
    splits, per, blocks, slices, rows = ce_cuda.backward_split(4096, 10112, 26, 132)
    assert (slices, rows) == (1, 4096) and splits * per >= 26 * 79 > (splits - 1) * per
    assert blocks == 2 * 132 and 64 * splits >= 16 * 132  # >= 16 items a SM, all rows valid
    splits, per, blocks, slices, rows = ce_cuda.backward_split(4096, 10000, 1, 132)
    assert splits * per >= 79 > (splits - 1) * per and blocks == 2 * 132
    assert slices > 1 and rows % 128 == 0 and slices * rows >= 4096 > (slices - 1) * rows
    assert ce_cuda.backward_split(5, 7, 1, 132) == (1, 1, 1, 1, 128)
