"""The lane-attention kernels' CUDA sources, run on the CPU by a host
emulation.

``ops/csrc/la_fwd.cu`` and ``la_bwd.cu`` (rows 12-13) are compiled with g++
against the stand-in for the CUDA runtime in
``tests/cuda_emulation.py`` (a block's threads are OS threads,
barriers are emulated, one block runs at a time), and their outputs are held
against the plain PyTorch versions in ``ops/lane_attention_cuda.py``.  Every
case runs at both stride sets the kernels serve: [H, dh, S, B] contiguous
(the TPU kernel's lane layout) and the projections' [B, S, E] viewed as
[H, dh, S, B].  This checks the kernels' strided tiles, the ragged last
block, the head-width bounds (4, 8, 16) and the two sweeps of the backward
without a GPU; it says nothing about their speed or about the GPU's compiler,
which ``chip_smoke.py`` and the ``cuda`` tests cover.  Skips where no g++ is
installed.

Tolerances: values within 1e-5 relative and absolute, each gradient within
1e-5 of its largest entry (fp32 sums of S terms in another order than
PyTorch's).
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch
from cuda_emulation import SHIM

from xdeepfm_tpu_torch.ops import lane_attention_cuda as lac

CSRC = pathlib.Path(lac.__file__).resolve().with_name("csrc")

# Reads ints (B, H, S, dh), the strides (sh, sd, ss, sb) as int64, the scale,
# then q, k, v, g as raw buffers of B*H*S*dh floats; writes o, dq, dk, dv in
# the same layout.
MAIN = r"""
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
alignas(16) float la_smem[1 << 16];
extern "C" int la_fwd(const void*, const void*, const void*, void*, int, int, int, int, long long,
                      long long, long long, long long, float, void*);
extern "C" int la_bwd(const void*, const void*, const void*, const void*, void*, void*, void*,
                      int, int, int, int, long long, long long, long long, long long, float,
                      void*);
template <class T> std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) throw 1;
  return v;
}
int main(int argc, char** argv) {
  FILE* in = fopen(argv[1], "rb");
  auto hd = take<int>(in, 4);
  const int B = hd[0], H = hd[1], S = hd[2], dh = hd[3];
  auto st = take<long long>(in, 4);
  const float scale = take<float>(in, 1)[0];
  const size_t n = (size_t)B * H * S * dh;
  auto q = take<float>(in, n), k = take<float>(in, n), v = take<float>(in, n),
       g = take<float>(in, n);
  fclose(in);
  std::vector<float> o(n), dq(n), dk(n), dv(n);
  int err = la_fwd(q.data(), k.data(), v.data(), o.data(), B, H, S, dh, st[0], st[1], st[2],
                   st[3], scale, nullptr);
  err |= la_bwd(q.data(), k.data(), v.data(), g.data(), dq.data(), dk.data(), dv.data(), B, H, S,
                dh, st[0], st[1], st[2], st[3], scale, nullptr);
  FILE* out = fopen(argv[2], "wb");
  for (auto* x : {&o, &dq, &dk, &dv}) fwrite(x->data(), 4, x->size(), out);
  fclose(out);
  return err;
}
"""


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host emulation")
    d = tmp_path_factory.mktemp("la_emu")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "main.cpp").write_text(MAIN)
    exe = d / "la_emu"
    cmd = [cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-Wno-unknown-pragmas",
           f"-I{d}", f"-I{CSRC}", "-x", "c++", str(CSRC / "la_fwd.cu"), str(CSRC / "la_bwd.cu"),
           str(d / "main.cpp"), "-o", str(exe)]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
    return d, exe


def _operands(rng, layout, B, H, S, dh):
    """Four [H, dh, S, B] views with the layout's strides, and their raw
    buffers: "lanes" is [H, dh, S, B] contiguous, "packed" the [B, S, E]
    projections (E index h * dh + d) viewed as [H, dh, S, B]."""
    shape = (H, dh, S, B) if layout == "lanes" else (B, S, H * dh)
    raws = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(4)]
    if layout == "lanes":
        return raws, raws
    return raws, [r.reshape(B, S, H, dh).permute(2, 3, 1, 0) for r in raws]


# (B, H, S, dh): AutoInt's head width at a ragged B and S (P = 6 samples a
# block, the last block ragged), S 64 at dh 16 (P = 4), dh 4 over three
# heads, B below one block's samples, S 64 at dh 5
CASES = [(37, 2, 39, 5), (10, 1, 64, 16), (9, 3, 26, 4), (3, 1, 3, 4), (5, 2, 64, 5)]


@pytest.mark.parametrize("layout", ["lanes", "packed"])
@pytest.mark.parametrize("B,H,S,dh", CASES)
def test_emulated_lane_attention_matches_plain(emulator, B, H, S, dh, layout):
    d, exe = emulator
    rng = np.random.default_rng(B + H + S + dh)
    raws, (q, k, v, g) = _operands(rng, layout, B, H, S, dh)
    scale = dh ** -0.5 if dh != 4 else 1.0
    case, out = d / f"{B}_{H}_{S}_{dh}_{layout}.bin", d / f"{B}_{H}_{S}_{dh}_{layout}.out"
    with open(case, "wb") as f:
        np.array([B, H, S, dh], np.int32).tofile(f)
        np.array(q.stride(), np.int64).tofile(f)
        np.array([scale], np.float32).tofile(f)
        for r in raws:
            r.numpy().tofile(f)
    subprocess.run([str(exe), str(case), str(out)], check=True, timeout=300)
    flat = torch.from_numpy(np.fromfile(out, np.float32))
    got = [torch.as_strided(part, q.shape, q.stride()) for part in flat.split(q.numel())]
    want_o = lac.la_forward_reference(q, k, v, scale)
    torch.testing.assert_close(got[0], want_o, rtol=1e-5, atol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], lac.la_backward_reference(g, q, k, v, scale)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()) + 1e-7,
                                   msg=lambda m, name=name: f"{name}: {m}")
