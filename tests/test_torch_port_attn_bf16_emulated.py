"""The small attention's bf16 kernels, run on the CPU by a host emulation.

``ops/csrc/sa_bf16.cu`` (``sa_fwd_bf16``: the scores of 64 queries against
a chunk of 128 or 256 keys by one ``wgmma`` with the keys' tile read
MN-major, the exact row max from the accumulator, e rounded in registers
into the A operand of o^T = E V^T; ``sa_bwd_bf16``: a key pass for dk and dv
and a query pass for dq in one grid) is compiled with g++ against the
stand-in for the CUDA runtime and ``tc_tf32.cuh`` in
``tests/cuda_emulation.py``.  Each case runs both launchers twice, shared
memory NaN-filled before each launch.  Shapes (G, dh, S): V2's head width
at S 16 and a ragged 37, dh 1 at S 5, dh 8 at S 64 (one whole chunk of the
backward), dh 16 (the k16 score products) at S 24, dh 9 at a ragged S 70,
S 300 (five chunks of 64) and S 2600 at dh 1 (a pair that no longer fits in
shared memory: every kernel stages its chunks from device memory one at a
time).

Checks: m bit-equal to the row max of the bf16 scores summed in fp32 from
d = 0 (the emulated MMA sums its exact products in k order, as such a
chain does); o and each gradient within ``ATTN_RTOL`` (an e or ds computed
in another order than the plain version's can round to the neighbouring
bf16 value, 2^-8 apart) of the largest entry of the bf16 plain version
(``sa_forward_reference`` / ``sa_backward_reference`` with
``precision="bf16"``), inv_z within 1e-4; against the float64 function of
the same rounded inputs (``sa_bf16_float64``) at most twice the plain
version's error or within 1e-6 of the largest entry, the gate
``chip_smoke.py`` holds the card to; bit-equal
over two runs; no launch asks for more than 96 KB of shared memory.  Skips
where no g++ is installed.
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch
from cuda_emulation import ATTN_EXTRA, SHIM

from xdeepfm_tpu_torch.ops import attention_cuda as sa

CSRC = pathlib.Path(sa.__file__).resolve().with_name("csrc")
ATTN_RTOL = 1e-2
SMEM_FLOATS = 1 << 16

# Reads ints (G, dh, S), float scale, then q, k, v, g; runs
# sa_fwd_bf16 and sa_bwd_bf16 twice, shared memory NaN-filled before each
# launch; writes o, m, inv_z, dq, dk, dv of both runs, then the most shared
# memory a launch asked for.
MAIN = r"""
#include <cmath>
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
alignas(128) float attn_smem[%d];
static void poison() { for (auto& x : attn_smem) x = NAN; }
extern "C" int sa_fwd_bf16(const void*, const void*, const void*, void*, void*, void*, int, int,
                           int, float, void*);
extern "C" int sa_bwd_bf16(const void*, const void*, const void*, const void*, const void*,
                           const void*, const void*, void*, void*, void*, int, int, int, float,
                           void*);
template <class T> std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) throw 1;
  return v;
}
int main(int argc, char** argv) {
  emu::smem_base = attn_smem;
  FILE* in = fopen(argv[1], "rb");
  auto hd = take<int>(in, 3);
  const int G = hd[0], dh = hd[1], S = hd[2];
  const float scale = take<float>(in, 1)[0];
  const size_t n = (size_t)G * dh * S, r = (size_t)G * S;
  auto q = take<float>(in, n), k = take<float>(in, n), v = take<float>(in, n),
       g = take<float>(in, n);
  fclose(in);
  FILE* out = fopen(argv[2], "wb");
  int err = 0;
  for (int run = 0; run < 2; ++run) {
    std::vector<float> o(n), m(r), z(r), dq(n), dk(n), dv(n);
    poison();
    err |= sa_fwd_bf16(q.data(), k.data(), v.data(), o.data(), m.data(), z.data(), G, dh, S,
                       scale, nullptr);
    poison();
    err |= sa_bwd_bf16(q.data(), k.data(), v.data(), g.data(), o.data(), m.data(), z.data(),
                       dq.data(), dk.data(), dv.data(), G, dh, S, scale, nullptr);
    for (auto* x : {&o, &m, &z, &dq, &dk, &dv}) fwrite(x->data(), 4, x->size(), out);
  }
  const float high = static_cast<float>(emu::smem_high);
  fwrite(&high, 4, 1, out);
  fclose(out);
  return err;
}
""" % SMEM_FLOATS


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host emulation")
    d = tmp_path_factory.mktemp("attn_bf16_emu")
    (d / "cuda_runtime.h").write_text(SHIM + ATTN_EXTRA)
    (d / "cuda_bf16.h").write_text('#pragma once\n#include "cuda_runtime.h"\n')
    (d / "main.cpp").write_text(MAIN)
    exe = d / "attn_bf16_emu"
    cmd = [cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-Wno-unknown-pragmas",
           f"-I{d}", f"-I{CSRC}", "-x", "c++", str(CSRC / "sa_bf16.cu"), str(d / "main.cpp"),
           "-o", str(exe)]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    return d, exe


def _run(emulator, q, k, v, g, scale):
    """((o, m, inv_z, dq, dk, dv) of the first run, of the second, the most
    shared memory a launch asked for)."""
    d, exe = emulator
    G, dh, S = q.shape
    case, out = d / f"case_{G}_{dh}_{S}.bin", d / f"out_{G}_{dh}_{S}.bin"
    with open(case, "wb") as f:
        np.array([G, dh, S], np.int32).tofile(f)
        np.array([scale], np.float32).tofile(f)
        for a in (q, k, v, g):
            np.ascontiguousarray(a, np.float32).tofile(f)
    subprocess.run([str(exe), str(case), str(out)], check=True, timeout=300)
    shapes = [(G, dh, S), (G, S), (G, S), (G, dh, S), (G, dh, S), (G, dh, S)] * 2 + [(1,)]
    flat = np.fromfile(out, np.float32)
    assert flat.size == sum(int(np.prod(s)) for s in shapes)
    parts = np.split(flat, np.cumsum([int(np.prod(s)) for s in shapes])[:-1])
    outs = [torch.from_numpy(p.reshape(s).copy()) for p, s in zip(parts, shapes)]
    return outs[:6], outs[6:12], int(outs[12][0])


def fmaf_row_max(q, k):
    """The row max of the bf16 scores, each summed in fp32 over d from 0:
    the products of bf16 values are exact in fp32, so each add rounds once,
    as fmaf does."""
    qb, kb = (t.to(torch.bfloat16).float() for t in (q, k))
    s = qb[:, 0, :, None] * kb[:, 0, None, :]
    for d in range(1, q.shape[1]):
        s = s + qb[:, d, :, None] * kb[:, d, None, :]
    return s.amax(-1)


def _gate(got, want, exact, what):
    """Within ATTN_RTOL of the plain bf16 version's largest entry; against
    the float64 function of the same rounded inputs at most twice its error,
    or within 1e-6 of the largest entry."""
    torch.testing.assert_close(got, want, rtol=ATTN_RTOL,
                               atol=ATTN_RTOL * float(want.abs().max()) + 1e-6, msg=what)
    err = float((got.double() - exact).abs().max())
    plain = float((want.double() - exact).abs().max())
    assert err <= 2 * plain or err <= 1e-6 * float(exact.abs().max()), (what, err, plain)


# (G, dh, S)
CASES = [(2, 5, 16), (3, 5, 37), (2, 1, 5), (2, 8, 64), (1, 16, 24), (1, 9, 70), (1, 5, 300),
         (1, 1, 2600)]


@pytest.mark.parametrize("G,dh,S", CASES)
def test_emulated_bf16_attention_matches_plain(emulator, G, dh, S):
    rng = np.random.default_rng(G * 1000 + dh * 100 + S)
    q, k, v, g = (rng.normal(size=(G, dh, S)).astype(np.float32) for _ in range(4))
    scale = float(dh ** -0.5)
    first, second, smem = _run(emulator, q, k, v, g, scale)
    for a, b in zip(first, second):
        assert torch.equal(a, b), "two runs differ"
    assert smem <= 96 * 1024
    o, m, z, dq, dk, dv = first
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    assert torch.equal(m, fmaf_row_max(qt, kt))
    want_o, want_m, want_z = sa.sa_forward_reference(qt, kt, vt, scale, "bf16")
    _gate(o, want_o, sa.sa_bf16_float64(qt, kt, vt, scale), "o")
    torch.testing.assert_close(m, want_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(z, want_z, rtol=1e-4, atol=1e-6)
    want = sa.sa_backward_reference(gt, qt, kt, vt, o, m, z, scale, "bf16")
    exact = sa.sa_bf16_float64(qt, kt, vt, scale, gt, o, m, z)
    for name, got, w, ex in zip(("dq", "dk", "dv"), (dq, dk, dv), want, exact):
        _gate(got, w, ex, name)


def test_emulated_bf16_attention_masks_keys_past_s_at_very_negative_scores(emulator):
    """Scores near -400 put m c below -128, where 2^(0 - m c) of a key past S
    (whose staged k and v are 0) overflows fp32: the select that masks those
    keys' e, not a multiply, keeps dq finite and equal to the plain
    version's (S 37: a ragged chunk)."""
    G, dh, S = 2, 5, 37
    rng = np.random.default_rng(41)
    q = (9 + 0.1 * rng.normal(size=(G, dh, S))).astype(np.float32)
    k = (-9 + rng.normal(size=(G, dh, S))).astype(np.float32)
    v, g = (rng.normal(size=(G, dh, S)).astype(np.float32) for _ in range(2))
    scale = float(dh ** -0.5)
    first, second, _ = _run(emulator, q, k, v, g, scale)
    o, m, z, dq, dk, dv = first
    assert float(m.max()) * scale * np.log2(np.e) < -128
    for t in first:
        assert torch.isfinite(t).all()
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    want_o = sa.sa_forward_reference(qt, kt, vt, scale, "bf16")[0]
    _gate(o, want_o, sa.sa_bf16_float64(qt, kt, vt, scale), "o")
    want = sa.sa_backward_reference(gt, qt, kt, vt, o, m, z, scale, "bf16")
    exact = sa.sa_bf16_float64(qt, kt, vt, scale, gt, o, m, z)
    for name, got, w, ex in zip(("dq", "dk", "dv"), (dq, dk, dv), want, exact):
        _gate(got, w, ex, name)
