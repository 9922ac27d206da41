"""The attention kernels' CUDA sources, run on the CPU by a host emulation.

``ops/csrc/sa_fwd.cu`` and ``sa_bwd.cu`` (rows 8-9) and ``ab_fwd.cu`` and
``ab_bwd.cu`` (rows 10-11, with the backward's fixed-order reduce) are
compiled with g++ against the stand-in for the CUDA runtime in
``tests/cuda_emulation.py`` (a block's threads are OS threads,
barriers and shuffles are emulated, one block runs at a time), and their
outputs are held against the plain PyTorch versions in
``ops/attention_cuda.py`` and ``ops/attn_block_cuda.py``.  This checks the
kernels' indexing, head splits, masking of ragged S, the LayerNorm and
pooling walks and the partial sums without a GPU; it says nothing about
their speed or about the GPU's compiler, which ``chip_smoke.py`` and the
``cuda`` tests cover.  Skips where no g++ is installed.

Tolerances: values within 1e-4 relative and 1e-5 absolute (fp32 sums in
another order than PyTorch's); each gradient within 1e-4 of its largest
entry; under bf16 the kernel and the plain version round the same operands,
but an fp32 value that lands on the other side of a rounding boundary moves
by one bf16 step (2^-8), hence 1e-2 there.
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch
from cuda_emulation import SHIM

from xdeepfm_tpu_torch.ops import attention_cuda as sa
from xdeepfm_tpu_torch.ops import attn_block_cuda as ab

CSRC = pathlib.Path(sa.__file__).resolve().with_name("csrc")

# what the attention sources use beyond the CE kernels' stand-in
EXTRA = r"""
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
"""

# Reads one case and writes the kernels' outputs.  Mode 0 (rows 8-9): ints
# (mode, G, dh, S, bf16), float scale, then q, k, v, g; writes o, m, inv_z,
# dq, dk, dv.  Mode 1 (rows 10-11): ints (mode, B, E, S, L, H, residual,
# layer_norm), floats (scale, eps), then x, wq, wk, wv, wo, gamma, beta, w1,
# b1, w2, g; writes pooled, then pooled again with no saves, dx and the
# reduced parameter gradients.
MAIN = r"""
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
alignas(16) float attn_smem[1 << 18];
extern "C" int sa_fwd(const void*, const void*, const void*, void*, void*, void*, int, int, int,
                      float, int, void*);
extern "C" int sa_bwd(const void*, const void*, const void*, const void*, const void*,
                      const void*, const void*, void*, void*, void*, int, int, int, float, int,
                      void*);
extern "C" int ab_fwd(const void*, const void*, const void*, const void*, const void*,
                      const void*, const void*, const void*, const void*, const void*, void*,
                      void*, void*, void*, void*, int, int, int, int, int, float, float, int,
                      int, void*);
extern "C" int ab_bwd(const void*, const void*, const void*, const void*, const void*,
                      const void*, const void*, const void*, const void*, const void*,
                      const void*, const void*, const void*, const void*, const void*, void*,
                      void*, void*, int, int, int, int, int, float, float, int, int, void*);
extern "C" int ab_num_params(int, int);
template <class T> std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) throw 1;
  return v;
}
static void put(FILE* f, const std::vector<float>& v) { fwrite(v.data(), 4, v.size(), f); }
int main(int argc, char** argv) {
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  const int mode = take<int>(in, 1)[0];
  int err = 0;
  if (mode == 0) {
    auto hd = take<int>(in, 4);
    const int G = hd[0], dh = hd[1], S = hd[2], bf16 = hd[3];
    const float scale = take<float>(in, 1)[0];
    const size_t n = (size_t)G * dh * S;
    auto q = take<float>(in, n), k = take<float>(in, n), v = take<float>(in, n),
         g = take<float>(in, n);
    std::vector<float> o(n), m((size_t)G * S), z((size_t)G * S), dq(n), dk(n), dv(n);
    err |= sa_fwd(q.data(), k.data(), v.data(), o.data(), m.data(), z.data(), G, dh, S, scale,
                  bf16, nullptr);
    err |= sa_bwd(q.data(), k.data(), v.data(), g.data(), o.data(), m.data(), z.data(),
                  dq.data(), dk.data(), dv.data(), G, dh, S, scale, bf16, nullptr);
    for (auto* x : {&o, &m, &z, &dq, &dk, &dv}) put(out, *x);
  } else {
    auto hd = take<int>(in, 7);
    const int B = hd[0], E = hd[1], S = hd[2], L = hd[3], H = hd[4], res = hd[5], ln = hd[6];
    auto fl = take<float>(in, 2);
    const int dh = E / H;
    auto x = take<float>(in, (size_t)B * E * S);
    auto wq = take<float>(in, (size_t)L * H * E * dh), wk = take<float>(in, (size_t)L * H * E * dh),
         wv = take<float>(in, (size_t)L * H * E * dh), wo = take<float>(in, (size_t)L * H * dh * E);
    auto gam = take<float>(in, (size_t)L * E), bet = take<float>(in, (size_t)L * E);
    auto w1 = take<float>(in, (size_t)E * E), b1 = take<float>(in, E), w2 = take<float>(in, E);
    auto g = take<float>(in, (size_t)B * E);
    std::vector<float> pooled((size_t)B * E), pooled2((size_t)B * E), m((size_t)B * L * H * S),
        z((size_t)B * L * H * S), os((size_t)B * L * E * S), ys((size_t)B * L * E * S),
        dx((size_t)B * E * S);
    const int np = ab_num_params(E, L);
    std::vector<float> part((size_t)np * B), grads(np);
    err |= ab_fwd(x.data(), wq.data(), wk.data(), wv.data(), wo.data(), gam.data(), bet.data(),
                  w1.data(), b1.data(), w2.data(), pooled.data(), m.data(), z.data(), os.data(),
                  ys.data(), B, E, S, L, H, fl[0], fl[1], res, ln, nullptr);
    err |= ab_fwd(x.data(), wq.data(), wk.data(), wv.data(), wo.data(), gam.data(), bet.data(),
                  w1.data(), b1.data(), w2.data(), pooled2.data(), nullptr, nullptr, nullptr,
                  nullptr, B, E, S, L, H, fl[0], fl[1], res, ln, nullptr);
    err |= ab_bwd(x.data(), wq.data(), wk.data(), wv.data(), wo.data(), gam.data(), bet.data(),
                  w1.data(), b1.data(), w2.data(), g.data(), m.data(), z.data(), os.data(),
                  ys.data(), dx.data(), part.data(), grads.data(), B, E, S, L, H, fl[0], fl[1],
                  res, ln, nullptr);
    for (auto* v : {&pooled, &pooled2, &dx, &grads}) put(out, *v);
  }
  fclose(in);
  fclose(out);
  return err;
}
"""


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host emulation")
    d = tmp_path_factory.mktemp("attn_emu")
    (d / "cuda_runtime.h").write_text(SHIM + EXTRA)
    (d / "cuda_bf16.h").write_text('#pragma once\n#include "cuda_runtime.h"\n')
    (d / "main.cpp").write_text(MAIN)
    exe = d / "attn_emu"
    cmd = [cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-Wno-unknown-pragmas",
           f"-I{d}", f"-I{CSRC}", "-x", "c++",
           *(str(CSRC / f"{name}.cu") for name in ("sa_fwd", "sa_bwd", "ab_fwd", "ab_bwd")),
           str(d / "main.cpp"), "-o", str(exe)]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
    return d, exe


def _run(emulator, name, header_ints, header_floats, arrays, sizes):
    d, exe = emulator
    case, out = d / f"{name}.bin", d / f"{name}.out"
    with open(case, "wb") as f:
        np.array(header_ints, np.int32).tofile(f)
        np.array(header_floats, np.float32).tofile(f)
        for a in arrays:
            np.ascontiguousarray(a, np.float32).tofile(f)
    subprocess.run([str(exe), str(case), str(out)], check=True, timeout=300)
    flat = np.fromfile(out, np.float32)
    assert flat.size == sum(sizes)
    return [torch.from_numpy(p.copy()) for p in np.split(flat, np.cumsum(sizes)[:-1])]


def _close_to_max(got, want, rtol):
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * float(want.abs().max()) + 1e-6)


# (G, dh, S): ragged S below one warp and above, dh as V2's (5) and others
SA_CASES = [(3, 5, 37), (2, 3, 70), (2, 8, 16), (1, 1, 5)]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("G,dh,S", SA_CASES)
def test_emulated_small_attention_matches_plain(emulator, G, dh, S, precision):
    rng = np.random.default_rng(G * 100 + dh * 10 + S)
    q, k, v, g = (rng.normal(size=(G, dh, S)).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(dh)
    n, r = G * dh * S, G * S
    o, m, z, dq, dk, dv = _run(
        emulator, f"sa_{G}_{dh}_{S}_{precision}", [0, G, dh, S, int(precision == "bf16")],
        [scale], (q, k, v, g), [n, r, r, n, n, n])
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, g))
    want_o, want_m, want_z = sa.sa_forward_reference(qt, kt, vt, scale, precision)
    torch.testing.assert_close(o.view(G, dh, S), want_o, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(m.view(G, S), want_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(z.view(G, S), want_z, rtol=1e-4, atol=1e-6)
    want = sa.sa_backward_reference(gt, qt, kt, vt, o.view(G, dh, S), m.view(G, S),
                                    z.view(G, S), scale, precision)
    rtol = 1e-4 if precision == "fp32" else 1e-2
    for got, w in zip((dq, dk, dv), want):
        _close_to_max(got.view(G, dh, S), w, rtol)


# (B, E, S, H, L, residual, layer_norm): V1's block (L 1), L 2, each of the
# residual and the LayerNorm off, a ragged S
AB_CASES = [
    (3, 10, 16, 2, 1, True, True),
    (2, 10, 16, 2, 2, True, True),
    (2, 10, 16, 2, 1, False, True),
    (2, 10, 16, 2, 1, True, False),
    (2, 6, 37, 3, 1, True, True),
]


def block_inputs(rng, B, E, S, H, L):
    """x, the ten packed weights and g as numpy, at the scale of a trained
    block (unit-normal x, weights ~ 1/sqrt(E), gamma near 1)."""
    dh = E // H
    w = lambda *s: (rng.normal(size=s) / np.sqrt(E)).astype(np.float32)  # noqa: E731
    x = rng.normal(size=(B, E, S)).astype(np.float32)
    weights = [w(L * H, E, dh), w(L * H, E, dh), w(L * H, E, dh), w(L * H, dh, E),
               (1 + 0.1 * rng.normal(size=(L, E, 1))).astype(np.float32),
               (0.1 * rng.normal(size=(L, E, 1))).astype(np.float32), w(E, E),
               (0.1 * rng.normal(size=(E, 1))).astype(np.float32), w(E, 1)]
    g = rng.normal(size=(B, E)).astype(np.float32)
    return x, weights, g


@pytest.mark.parametrize("B,E,S,H,L,residual,layer_norm", AB_CASES)
def test_emulated_attn_block_matches_plain(emulator, B, E, S, H, L, residual, layer_norm):
    rng = np.random.default_rng(B + E + S + H + L)
    x, weights, g = block_inputs(rng, B, E, S, H, L)
    cfg = ab.BlockCfg(layers=L, heads=H, scale=1.0 / np.sqrt(E // H), use_residual=residual,
                      use_layer_norm=layer_norm, eps=1e-5)
    np_ = ab.num_params(E, L)
    pooled, pooled2, dx, flat = _run(
        emulator, f"ab_{B}_{E}_{S}_{H}_{L}_{residual}_{layer_norm}",
        [1, B, E, S, L, H, int(residual), int(layer_norm)], [cfg.scale, cfg.eps],
        (x, *weights, g), [B * E, B * E, B * E * S, np_])
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    wt = [torch.from_numpy(w) for w in weights]
    want = ab.ab_forward_reference(cfg, xt, *wt)
    torch.testing.assert_close(pooled.view(B, E), want, rtol=1e-4, atol=1e-5)
    assert torch.equal(pooled, pooled2)  # the saves change nothing
    grads = (dx.view(B, E, S),) + tuple(
        t.view(w.shape) for t, w in zip(flat.split([w.numel() for w in wt]), wt))
    want_g = ab.ab_backward_reference(cfg, gt, xt, *wt)
    names = ("dx", "dwq", "dwk", "dwv", "dwo", "dgamma", "dbeta", "dw1", "db1", "dw2")
    for name, got, w in zip(names, grads, want_g):
        assert got.shape == w.shape, name
        _close_to_max(got, w, 1e-4)
    if not layer_norm:
        assert (grads[5] == 0).all() and (grads[6] == 0).all()
