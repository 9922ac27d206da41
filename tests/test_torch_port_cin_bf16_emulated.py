"""The CIN's bf16 kernels, run on the CPU by a host emulation.

``cin_fwd_bf16`` (``ops/csrc/cin_fwd.cu``: h and x0 staged in bf16, A
built by packed products, one bf16 ``wgmma`` m64n128k16 a k16 step from
registers, W staged in bf16 core matrices through bulk copies on
mbarriers) and ``cin_round_g_bf16`` + ``cin_bwd_dx_bf16``
(``ops/csrc/cin_bwd.cu``: g and W rounded once into bf16 tiles, bulk-copied,
Z = g W on ``wgmma`` m64n128k16 with both operands from shared memory,
persistent blocks over (row tile, split) items, two accumulator sets where
O fits one tensor-core sum, the fp32 epilogue) are compiled with g++
against the stand-in for the CUDA runtime and ``tc_tf32.cuh`` in
``tests/cuda_emulation.py``.  Each case runs every kernel twice, shared
memory NaN-filled and the tiles 0xff-filled before each launch:

* layer 0's H = M = 26 (H padded to 32) with a strided h, O = 130 (two
  column tiles; the backward's two tensor-core sums), a forward tail split
  along K and the backward's chunks in two splits on 2 SMs (3 items a
  block);
* h of 140 columns over two forward launches with a misaligned h, M = 7
  (groups of 8), O = 20, one SM;
* layer 1's shape cut to two ragged row tiles and 48 h columns: strided h,
  groups of 32, one tensor-core sum a chunk (the two accumulator sets);
* M = 40 (groups of 64), O = 37 (not a multiple of 16), ragged N, 3 SMs;
* O = 400: g's row tile in two segments reloaded for each chunk, M = 9
  (groups of 16).

Tolerance: each output within 1e-4 of its largest entry of the bf16 plain
version (``cin_rows_reference_bf16``, ``cin_rows_backward_reference_bf16``:
the same rounded operands, fp32 sums in another order), and its error
against float64 of the same rounded operands at most twice the plain
version's, or within 1e-6 of its largest entry, the gate that
``chip_smoke.py`` holds the card to; bit-equal over two runs; the rounding
pass's fp32 copy of g bit-equal to ``bf16_round(g)``.  Skips where no g++
is installed.  ``test_dx_bf16_split_covers_every_chunk_once`` checks the
backward's split plan on the CPU alone, ``test_fwd_bf16_plan_fits_wide_x0``
the forward's shared-memory plan at H 128 with M past its longest chunk's
room.
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
#include <cstdlib>
#include <vector>
#include "cuda_runtime.h"
constexpr int kSmem = %d, kBlock = %d;
alignas(128) float cin_smem[kSmem];
extern "C" int cin_fwd_bf16_scratch_floats(int, int, int, int, int);
extern "C" int cin_fwd_bf16(const void*, int, const void*, const void*, int, int, const void*,
                            void*, void*, int, int, int, int, int, int, void*);
extern "C" int cin_bwd_dx_bf16_g_elems(int, int);
extern "C" int cin_bwd_dx_bf16_w_elems(int, int, int);
extern "C" int cin_round_g_bf16(const void*, int, int, void*, void*, void*);
extern "C" int cin_bwd_dx_bf16(const void*, const void*, void*, const void*, int, const void*,
                               void*, void*, int, int, int, int, int, int, int, void*);
extern "C" int cin_sum_slices(const void*, int, long long, void*, int, void*);
template <class T> std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) throw 1;
  return v;
}
int main(int argc, char** argv) {
  if (argc == 6) {  // cin_fwd_bf16_scratch_floats(N, H, M, O, grid) alone
    printf("%%d\n", cin_fwd_bf16_scratch_floats(atoi(argv[1]), atoi(argv[2]), atoi(argv[3]),
                                               atoi(argv[4]), atoi(argv[5])));
    return 0;
  }
  emu::smem_base = cin_smem;
  FILE* in = fopen(argv[1], "rb");
  auto hd = take<int>(in, 10);
  const int N = hd[0], H = hd[1], M = hd[2], O = hd[3], ldh = hd[4], grid = hd[5];
  const int mp = hd[6], splits = hd[7], per = hd[8], off = hd[9] ? 1 : 0;
  emu::sm_count = grid;
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
  std::vector<float> g_round((size_t)N * O, NAN), part((size_t)splits * N * M);
  const int gn = cin_bwd_dx_bf16_g_elems(N, O), wn = cin_bwd_dx_bf16_w_elems(H, O, mp);
  if (gn < 0 || wn < 0) return 3;
  std::vector<uint4> gt(gn / 8 + 1), wt(wn / 8 + 1);
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
    std::memset(gt.data(), 0xff, gt.size() * sizeof(uint4));  // every slot must be written
    std::memset(wt.data(), 0xff, wt.size() * sizeof(uint4));
    err |= cin_round_g_bf16(g.data(), N, O, run ? nullptr : g_round.data(), gt.data(), nullptr);
    float* dx = dx0.data() + run * (size_t)N * M;
    err |= cin_bwd_dx_bf16(gt.data(), w.data(), wt.data(), h, ldh, x0.data(),
                           dh.data() + run * (size_t)N * H, splits > 1 ? part.data() : dx, N, H,
                           M, O, mp, splits, per, nullptr);
    if (splits > 1) err |= cin_sum_slices(part.data(), splits, (long long)N * M, dx, 2, nullptr);
    check();
  }
  FILE* o = fopen(argv[2], "wb");
  int head[2] = {(int)emu::smem_high, untouched};
  fwrite(head, 4, 2, o);
  for (auto* v : {&out, &dh, &dx0, &g_round}) fwrite(v->data(), 4, v->size(), o);
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
    # layer 1's shape cut to two row tiles (ragged) and 48 h columns: strided
    # h, groups of 32, the backward's 12 chunks a tile
    (131, 48, 26, 128, True, 2, False),
    # M at 40 (groups of 64, a group's m over 8 n8 tiles), O not a multiple
    # of 16 (the backward's one stage of 3 k16 steps), ragged N
    (201, 9, 40, 37, False, 3, False),
    # O past 384: g's row tile in two segments (384 + 64 channels) reloaded
    # for each chunk, M 9 (groups of 16)
    (70, 3, 9, 400, False, 2, False),
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
    mp, splits, per = cin_cuda._dx_bf16_split(N, H, M, O, grid)
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
    outs, dhs, dx0s, g_round = torch.split(flat, [2 * N * O, 2 * N * H, 2 * N * M, N * O])
    outs, dhs, dx0s = outs.view(2, N, O), dhs.view(2, N, H), dx0s.view(2, N, M)
    for runs in (outs, dhs, dx0s):
        assert torch.equal(runs[0], runs[1])  # bit-equal from run to run

    h, tx0, tW, tb, tg = (torch.from_numpy(a) for a in (hw[:, :H], x0, W, b, g))
    # the rounding pass's fp32 copy of g is bf16_round's, bit for bit
    assert torch.equal(g_round.view(N, O), cin_cuda.bf16_round(tg))
    _gate("out", outs[0], cin_cuda.cin_rows_reference_bf16(h, tx0, tW, tb),
          cin_cuda.cin_rows_reference_bf16(h.double(), tx0.double(), tW.double(), tb.double()))
    want = cin_cuda.cin_rows_backward_reference_bf16(tg, h, tx0, tW)
    exact = cin_cuda.cin_rows_backward_reference_bf16(tg.double(), h.double(), tx0.double(),
                                                      tW.double())
    for label, got, w_, e in zip(("dh", "dx0"), (dhs[0], dx0s[0]), want, exact):
        _gate(label, got, w_, e)
    # the bf16 mode differs from fp32: the kernels did round
    assert float((outs[0] - cin_cuda.cin_rows_reference(h, tx0, tW, tb)).abs().max()) > 1e-3


# M at H 128: the last M of each chunk length (128 k': 257, 64: 321, 32:
# 353), the first of 64, and the first that no chunk fits
@pytest.mark.parametrize("M,fits", [(257, True), (258, True), (321, True), (353, True),
                                    (354, False)])
def test_fwd_bf16_plan_fits_wide_x0(emulator, M, fits):
    """``cin_fwd_bf16``'s plan halves its chunk where the staged rows leave
    no room for two stages of 128 k', so M up to 353 fits at H 128 (the
    earlier fp32 staging took about 285) and 354 is refused (-1)."""
    _, exe = emulator
    run = subprocess.run([str(exe), "301", "128", str(M), "20", "132"], check=True,
                         capture_output=True, text=True, timeout=60)
    assert (int(run.stdout) >= 0) == fits


# (N, H, M, O, SMs): the train and scoring batches' two layers on an H100's
# 132 SMs, the emulated cases' shapes, one row tile on many SMs
@pytest.mark.parametrize("N,H,M,O,sms", [
    (40960, 26, 26, 256, 132), (40960, 128, 26, 128, 132), (81920, 26, 26, 256, 132),
    (81920, 128, 26, 128, 132), *((c[0], c[1], c[2], c[3], c[5]) for c in CASES),
    (100, 200, 26, 64, 132)])
def test_dx_bf16_split_covers_every_chunk_once(N, H, M, O, sms):
    """cin_bwd_dx_bf16's splits: each of the ceil(H / (128 / mp)) chunks in
    exactly one split, no split empty, at most _MAX_DX_SPLITS of them, and no
    plan that loads its busiest persistent block more than one split alone
    would."""
    mp, splits, per = cin_cuda._dx_bf16_split(N, H, M, O, sms)
    assert mp >= M and mp in (8, 16, 32, 64)
    n_chunks = -(-H // (128 // mp))
    spans = [range(s * per, min(n_chunks, (s + 1) * per)) for s in range(splits)]
    assert all(len(r) > 0 for r in spans) and sorted(q for r in spans for q in r) == list(
        range(n_chunks))
    assert 1 <= splits <= cin_cuda._MAX_DX_SPLITS

    def busiest(splits, per):
        tiles, stages = -(-N // 128), -(-O // cin_cuda._DXB_STAGE)
        load = [0] * min(sms, tiles * splits)
        for i in range(tiles * splits):
            s = i // tiles
            load[i % len(load)] += (min(n_chunks, (s + 1) * per) - s * per) * stages \
                + cin_cuda._DXB_ITEM_STAGES
        return max(load)

    assert busiest(splits, per) <= busiest(1, n_chunks)
