"""The CE's bf16 kernels, run on the CPU by a host emulation.

``ops/csrc/ce_bf16.cu`` (``ce_round_bf16``: h and W rounded once into bf16
tiles, the bias padded; ``ce_fwd_bf16`` and the backward's dh kernel: one
walk of persistent blocks, a producer thread bulk-copying (mbarriers) the h
tiles and each pair's W tile, two consumer warpgroups on ``wgmma``
m64n128k16 with both operands from shared memory; dh += dS W with dS from
registers and W read MN-major; the dW kernel's S^T = W h^T and dW += dS^T h
likewise) is compiled with g++ against the stand-in for the CUDA runtime and
``tc_tf32.cuh`` in ``tests/cuda_emulation.py``.  Each case runs the three
launchers twice, shared memory NaN-filled before each launch:

* three stacked heads of a ragged vocabulary (257 columns: three tiles, the
  last one mostly padding), K 64, num_valid 150 (a 128-row item straddles
  it), the walk's splits crossing heads;
* K 13 (padded to 16), every row valid, padded (-1e30) columns;
* num_valid 0, K 40 (padded to 48);
* one head whose dW rows are cut into slices, K 21 (padded to 32), h one
  float off 16-byte alignment;
* a tiny shape (B 5, V 7, K 3).

Tolerance: each output within 1e-4 of the largest entry of the bf16 plain
version (``ce_rows_forward_reference`` / ``ce_rows_backward_reference`` with
``precision="bf16"``: the same rounded operands, fp32 sums in another
order); its error against float64 of the same rounded operands at most
twice the plain version's, or within 1e-6 of its largest entry, the gate
``chip_smoke.py`` holds the card to; bit-equal over two runs.  Skips where
no g++ is installed.
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
SMEM_FLOATS = 1 << 16

# Reads ints (B, K, V, F, nv (-1: all rows), misaligned, sms, splits, per,
# blocks, slots, slices, rows per slice), then h, W, b, t, g; runs
# ce_round_bf16, ce_fwd_bf16 and ce_bwd_bf16 twice, shared memory NaN-filled
# before each launch; writes ll, logz, dh, dW, db of both runs.
# Misaligned: h starts one float past a 16-byte boundary.
MAIN = r"""
#include <cmath>
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
alignas(128) float ce_smem[%d];
extern "C" int ce_round_bf16(const void*, const void*, const void*, const void*, void*, void*,
                             void*, int, int, int, int, int, int, int, void*);
extern "C" int ce_fwd_bf16(const void*, const void*, const void*, const void*, const void*,
                           void*, void*, void*, int, int, int, int, int, int, int, int, int,
                           int, void*);
extern "C" int ce_bwd_bf16(const void*, const void*, const void*, const void*, const void*,
                           const void*, const void*, void*, void*, int, int, int, void*, void*,
                           void*, void*, int, int, int, int, int, int, int, int, void*);
template <class T> std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) throw 1;
  return v;
}
int main(int argc, char** argv) {
  emu::smem_base = ce_smem;
  FILE* in = fopen(argv[1], "rb");
  auto hd = take<int>(in, 13);
  const int B = hd[0], K = hd[1], V = hd[2], F = hd[3], nv = hd[4], off = hd[5] ? 1 : 0;
  emu::sm_count = hd[6];
  const int splits = hd[7], per = hd[8], blocks = hd[9], slots = hd[10], slices = hd[11];
  const int rows = hd[12];
  auto hv = take<float>(in, (size_t)B * K);
  auto w = take<float>(in, (size_t)F * V * K);
  auto b = take<float>(in, (size_t)F * V);
  auto t = take<long long>(in, (size_t)F * B);
  auto g = take<float>(in, (size_t)F * B);
  fclose(in);
  std::vector<float> pad_h((size_t)B * K + 8);
  float* h = pad_h.data() + 4 + off;  // the vector's data are 16-byte aligned
  std::copy(hv.begin(), hv.end(), h);
  const int KW = (K + 15) / 16 * 16, Bp = (B + 127) / 128 * 128, Vp = (V + 127) / 128 * 128;
  std::vector<uint16_t> hb((size_t)Bp * KW), wb((size_t)F * Vp * KW);
  std::vector<float> bp((size_t)F * Vp), part((size_t)3 * slots * F * B);
  std::vector<float> dh_part((size_t)splits * B * K), dw_part((size_t)slices * F * V * K),
      db_part((size_t)slices * F * V);
  const int* nvp = nv < 0 ? nullptr : &nv;
  FILE* out = fopen(argv[2], "wb");
  int err = 0;
  auto nan_smem = [] { for (auto& x : ce_smem) x = NAN; };
  for (int run = 0; run < 2; ++run) {
    std::vector<float> ll(F * B), logz(F * B), dh(B * K), dw((size_t)F * V * K), db(F * V);
    nan_smem();
    err |= ce_round_bf16(h, w.data(), b.data(), nvp, hb.data(), wb.data(), bp.data(), B, K, V,
                         F, KW, Bp, Vp, nullptr);
    nan_smem();
    err |= ce_fwd_bf16(hb.data(), wb.data(), bp.data(), t.data(), nvp, ll.data(), logz.data(),
                       part.data(), slots, splits, per, blocks, B, K, V, F, KW, Vp, nullptr);
    nan_smem();
    err |= ce_bwd_bf16(hb.data(), wb.data(), bp.data(), t.data(), logz.data(), g.data(), nvp,
                       dh.data(), dh_part.data(), splits, per, blocks, dw.data(), db.data(),
                       dw_part.data(), db_part.data(), slices, rows, B, K, V, F, KW, Vp,
                       nullptr);
    for (auto* v : {&ll, &logz, &dh, &dw, &db}) fwrite(v->data(), 4, v->size(), out);
  }
  fclose(out);
  return err;
}
""" % SMEM_FLOATS


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host emulation")
    d = tmp_path_factory.mktemp("ce_bf16_emu")
    (d / "cuda_runtime.h").write_text(SHIM + ATTN_EXTRA)
    (d / "main.cpp").write_text(MAIN)
    exe = d / "ce_bf16_emu"
    cmd = [cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-Wno-unknown-pragmas",
           f"-I{d}", f"-I{CSRC}", "-x", "c++", str(CSRC / "ce_bf16.cu"), str(d / "main.cpp"),
           "-o", str(exe)]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    return d, exe


def _run(emulator, h, W, b, t, g, nv, sms, misaligned):
    """((ll, logz, dh, dW, db) of the first run, of the second)."""
    d, exe = emulator
    F, V, K = W.shape
    B = h.shape[0]
    splits, per, blocks = ce_cuda.bf16_split(B, V, F, sms)
    slots = ce_cuda.bf16_slots(V, splits, per)
    *_, slices, rows = ce_cuda.backward_split(B, V, F, sms)
    case, out = d / f"case_{B}_{K}_{V}_{F}.bin", d / f"out_{B}_{K}_{V}_{F}.bin"
    with open(case, "wb") as f:
        np.array([B, K, V, F, -1 if nv is None else nv, misaligned, sms, splits, per, blocks,
                  slots, slices, rows], np.int32).tofile(f)
        for a, dt in ((h, np.float32), (W, np.float32), (b, np.float32), (t, np.int64),
                      (g, np.float32)):
            np.ascontiguousarray(a, dt).tofile(f)
    subprocess.run([str(exe), str(case), str(out)], check=True, timeout=120)
    shapes = [(F, B), (F, B), (B, K), (F, V, K), (F, V)] * 2
    parts = np.split(np.fromfile(out, np.float32),
                     np.cumsum([int(np.prod(s)) for s in shapes])[:-1])
    outs = [torch.from_numpy(p.reshape(s).copy()) for p, s in zip(parts, shapes)]
    return outs[:5], outs[5:]


def _gate(got, want, exact, what):
    """Within 1e-4 of the plain bf16 version's largest entry; against
    float64 of the same rounded operands at most twice its error, or within
    1e-6 of the largest entry."""
    top = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * top + 1e-6, msg=what)
    err = float((got.double() - exact).abs().max()) if got.numel() else 0.0
    plain = float((want.double() - exact).abs().max()) if got.numel() else 0.0
    assert err <= 2 * plain or err <= 1e-6 * float(exact.abs().max()), (what, err, plain)


# (B, K, V, F, num_valid, SMs, misaligned h)
CASES = [
    (300, 64, 257, 3, 150, 2, False),
    (300, 13, 300, 2, None, 2, False),
    (200, 40, 130, 2, 0, 2, False),
    (400, 21, 200, 1, 333, 2, True),
    (5, 3, 7, 1, 4, 1, False),
]


@pytest.mark.parametrize("B,K,V,F,nv,sms,misaligned", CASES)
def test_emulated_bf16_kernels_match_plain(emulator, B, K, V, F, nv, sms, misaligned):
    rng = np.random.default_rng(B + K + V + F)
    h = rng.normal(size=(B, K)).astype(np.float32)
    W = (rng.normal(size=(F, V, K)) / np.sqrt(K)).astype(np.float32)
    b = rng.normal(size=(F, V)).astype(np.float32)
    W[:, -3:] = 0.0
    b[:, -3:] = -1e30  # padded columns, as the decoder pads stacked heads
    t = rng.integers(0, V - 3, (F, B))
    g = rng.normal(size=(F, B)).astype(np.float32)
    first, second = _run(emulator, h, W, b, t, g, nv, sms, int(misaligned))
    for a, c in zip(first, second):
        assert torch.equal(a, c), "two runs differ"
    ll, logz, dh, dW, db = first
    ht, Wt, bt, tt, gt = map(torch.from_numpy, (h, W, b, t, g))
    want = ce_cuda.ce_rows_forward_reference(ht, Wt, bt, tt, nv, "bf16")
    exact = ce_cuda.ce_rows_forward_reference(ht.double(), Wt.double(), bt.double(), tt, nv,
                                              "bf16")
    for name, got, w, ex in zip(("ll", "logz"), (ll, logz), want, exact):
        _gate(got, w, ex, name)
    want = ce_cuda.ce_rows_backward_reference(gt, ht, Wt, bt, tt, logz, nv, "bf16")
    exact = ce_cuda.ce_rows_backward_reference(gt.double(), ht.double(), Wt.double(),
                                               bt.double(), tt, logz.double(), nv, "bf16")
    for name, got, w, ex in zip(("dh", "dW", "db"), (dh, dW, db), want, exact):
        _gate(got, w, ex, name)
    if nv is not None:
        assert (ll[:, nv:] == 0).all() and (logz[:, nv:] == 0).all() and (dh[nv:] == 0).all()
    if nv == 0:
        assert (dW == 0).all() and (db == 0).all()


def test_bf16_split_covers_the_pairs():
    # canonical Pro: 32 row tiles of 128, 26 heads of 79 tiles, 132 SMs
    assert ce_cuda.bf16_split(4096, 10112, 26, 132) == (63, 33, 132)
    for B, V, F, sms in ((4096, 10112, 26, 132), (4096, 10000, 1, 132), (5, 7, 1, 1),
                         (300, 257, 3, 2), (400, 200, 1, 2)):
        splits, per, blocks = ce_cuda.bf16_split(B, V, F, sms)
        tiles = -(-V // 128)
        pairs = F * tiles
        assert splits * per >= pairs > (splits - 1) * per  # every pair, no empty split
        assert 1 <= blocks <= sms
        reach = max(((f + 1) * tiles - 1) // per - f * tiles // per + 1 for f in range(F))
        assert ce_cuda.bf16_slots(V, splits, per) >= reach
