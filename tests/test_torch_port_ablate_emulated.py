"""The attention ablation's CUDA source, run on the CPU by a host emulation.

``ops/csrc/sa_ablate.cu`` (TPU kernel row 16: ``full``, ``dots`` and
``soft``) is compiled with g++ against the stand-in for the CUDA runtime in
``tests/cuda_emulation.py`` (a block's threads are fibers,
barriers and shuffles are emulated, one block runs at a time).  Each
variant's output is held against its plain PyTorch version in
``ops/attn_ablate_cuda.py`` at ragged and tiny shapes, at S past one
block's 16 warps of query tiles (a second round of tiles and of the soft
column sums' per-warp rows), at dh 8, 9 and 16 (two m16 tiles a warp, then
one); each variant runs twice
and must be bit-equal.  The shared memory is filled with NaN before each
launch: a read of a slot the kernel did not write spreads NaN into the
output, and every slot past the launch's shared bytes
(``sa_ablate_geometry``) must still be NaN afterwards.  This checks the
forward routine's (``attn_fwd_tc.cuh``) indexing, lane layout and
masking, the soft kernel's column sums and the shared-memory layout without
a GPU; it says nothing about their speed or about the GPU's compiler, which
``chip_smoke.py`` and the ``cuda`` tests cover.  Skips where no g++ is
installed.

Tolerance: within 1e-5 of the largest |o| (fp32 sums of S terms, and for
soft of S exps over the rows, in another order than PyTorch's; exp2 of the
host's libm against PyTorch's).
"""

import math
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch
from cuda_emulation import ATTN_EXTRA, SHIM

from xdeepfm_tpu_torch.ops import attn_ablate_cuda as ab

CSRC = pathlib.Path(ab.__file__).resolve().with_name("csrc")
SMEM_FLOATS = 1 << 16

# Reads ints (variant, G, dh, S), float scale, then q, k, v; writes ints
# (threads, smem bytes, untouched-past-smem flag) and o of two runs.
MAIN = r"""
#include <cmath>
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
constexpr int kSmem = %d;
alignas(16) float attn_smem[kSmem];
extern "C" int sa_ablate_geometry(int, int, int, int*, long long*);
extern "C" int sa_ablate(int, const void*, const void*, const void*, void*, int, int, int, float,
                         void*);
template <class T> std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) throw 1;
  return v;
}
int main(int argc, char** argv) {
  FILE* in = fopen(argv[1], "rb");
  auto hd = take<int>(in, 4);
  const int variant = hd[0], G = hd[1], dh = hd[2], S = hd[3];
  const float scale = take<float>(in, 1)[0];
  const size_t n = (size_t)G * dh * S;
  auto q = take<float>(in, n), k = take<float>(in, n), v = take<float>(in, n);
  fclose(in);
  int threads = 0;
  long long smem = 0;
  int err = sa_ablate_geometry(variant, dh, S, &threads, &smem);
  if (smem > (long long)sizeof(attn_smem)) return 90;
  FILE* out = fopen(argv[2], "wb");
  int untouched = 1;
  std::vector<std::vector<float>> runs;
  for (int run = 0; run < 2; ++run) {
    for (int i = 0; i < kSmem; ++i) attn_smem[i] = NAN;
    std::vector<float> o(n);
    err |= sa_ablate(variant, q.data(), k.data(), v.data(), o.data(), G, dh, S, scale, nullptr);
    for (long long i = smem / 4; i < kSmem; ++i) untouched &= std::isnan(attn_smem[i]) ? 1 : 0;
    runs.push_back(o);
  }
  int head[3] = {threads, (int)smem, untouched};
  fwrite(head, 4, 3, out);
  for (auto& o : runs) fwrite(o.data(), 4, o.size(), out);
  fclose(out);
  return err;
}
""" % SMEM_FLOATS


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host emulation")
    d = tmp_path_factory.mktemp("ablate_emu")
    (d / "cuda_runtime.h").write_text(SHIM + ATTN_EXTRA)
    (d / "cuda_bf16.h").write_text('#pragma once\n#include "cuda_runtime.h"\n')
    (d / "main.cpp").write_text(MAIN)
    exe = d / "ablate_emu"
    cmd = [cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-Wno-unknown-pragmas",
           f"-I{d}", f"-I{CSRC}", "-x", "c++", str(CSRC / "sa_ablate.cu"), str(d / "main.cpp"),
           "-o", str(exe)]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
    return d, exe


# (G, dh, S): ragged (S 39: two tiles of 32 queries, the last 8-key block
# of 7), tiny, S 266 (the script's default width: 9 tiles, the last of 10
# queries), 300 at dh 16 (16-query tiles: 19 over the block's 16 warps, a
# second round), dh 8 (the widest with two m16 tiles a warp)
# and dh 9 (the narrowest with one) at ragged S
CASES = [(5, 3, 39), (2, 1, 5), (2, 5, 266), (1, 16, 300), (3, 8, 37), (2, 9, 70)]


def launch_geometry(variant, dh, S):
    """(threads, shared bytes) of ``csrc/sa_ablate.cu``: a warp per tile of
    32 queries (16 above dh 8; soft 32), at most 16 warps; full and dots
    stage k and v [dh][KP], soft k's row 0, the warps' column sums
    [warps][KP] and the row sums [S], with KP = S rounded up to 8."""
    kp = -(-S // 8) * 8
    tile = 32 if variant == "soft" or dh <= 8 else 16
    warps = min(16, -(-S // tile))
    floats = kp * (1 + warps) + S if variant == "soft" else 2 * dh * kp
    return 32 * warps, 4 * floats


@pytest.mark.parametrize("variant", ab.VARIANTS)
@pytest.mark.parametrize("G,dh,S", CASES)
def test_emulated_ablation_kernels_match_plain(emulator, variant, G, dh, S):
    d, exe = emulator
    rng = np.random.default_rng(G * 1000 + dh * 10 + S)
    q, k, v = (rng.normal(size=(G, dh, S)).astype(np.float32) for _ in range(3))
    scale = 1.0 / math.sqrt(dh)
    case, out = d / f"{variant}_{G}_{dh}_{S}.bin", d / f"{variant}_{G}_{dh}_{S}.out"
    with open(case, "wb") as f:
        np.array([ab.VARIANTS.index(variant), G, dh, S], np.int32).tofile(f)
        np.array([scale], np.float32).tofile(f)
        for a in (q, k, v):
            a.tofile(f)
    subprocess.run([str(exe), str(case), str(out)], check=True, timeout=300)
    raw = np.fromfile(out, np.uint8)
    threads, smem, untouched = raw[:12].view(np.int32)
    o1, o2 = torch.from_numpy(raw[12:].view(np.float32).copy()).reshape(2, G, dh, S)
    assert (threads, smem) == launch_geometry(variant, dh, S) and untouched == 1
    want = ab.REFERENCES[variant](*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert torch.isfinite(o1).all()
    torch.testing.assert_close(o1, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    assert torch.equal(o1, o2)  # bit-equal from run to run
    if variant == "soft":
        assert torch.equal(o1, o1[:, :1].expand_as(o1))  # one value a column for every d
