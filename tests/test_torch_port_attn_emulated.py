"""The attention kernels' CUDA sources, run on the CPU by a host emulation.

``ops/csrc/sa_fwd.cu`` and ``sa_bwd.cu`` (rows 8-9) and ``ab_fwd.cu`` and
``ab_bwd.cu`` (rows 10-11, with the backward's fixed-order reduce) are
compiled with g++ against the stand-in for the CUDA runtime in
``tests/cuda_emulation.py`` (a block's threads are fibers,
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
from cuda_emulation import ATTN_EXTRA, SHIM

from xdeepfm_tpu_torch.ops import attention_cuda as sa
from xdeepfm_tpu_torch.ops import attn_block_cuda as ab

CSRC = pathlib.Path(sa.__file__).resolve().with_name("csrc")

# Reads one case and writes the kernels' outputs.  Mode 0 (rows 8-9): ints
# (mode, G, dh, S, bf16), float scale, then q, k, v, g; writes o, m, inv_z,
# dq, dk, dv.  Mode 2 (row 8 alone): the same header, then q, k, v; writes
# o, m, inv_z of two runs, then each row's max recomputed here by fmaf over
# d from 0 (the backward's order).  Mode 1 (rows 10-11): ints (mode, B, E, S, L, H, residual,
# layer_norm), floats (scale, eps), then x, wq, wk, wv, wo, gamma, beta, w1,
# b1, w2, g; writes pooled, then pooled again with no saves, dx and the
# reduced parameter gradients.  Mode 3 (row 10 alone): mode 1's header and
# inputs but g; writes pooled, m, inv_z, osave and ysave of two runs, pooled
# with no saves, then layer 0's score max of each (row, head, query)
# recomputed here by fmaf in the kernel's orders (the projections over e
# from 0, the scores over d from 0).
MAIN = r"""
#include <cmath>
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
alignas(16) float attn_smem[1 << 18];
// before each launch: a kernel that reads shared memory it did not write
// meets NaN
static void poison() { std::fill(attn_smem, attn_smem + (1 << 18), NAN); }
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
    poison();
    err |= sa_fwd(q.data(), k.data(), v.data(), o.data(), m.data(), z.data(), G, dh, S, scale,
                  bf16, nullptr);
    poison();
    err |= sa_bwd(q.data(), k.data(), v.data(), g.data(), o.data(), m.data(), z.data(),
                  dq.data(), dk.data(), dv.data(), G, dh, S, scale, bf16, nullptr);
    for (auto* x : {&o, &m, &z, &dq, &dk, &dv}) put(out, *x);
  } else if (mode == 2) {
    auto hd = take<int>(in, 4);
    const int G = hd[0], dh = hd[1], S = hd[2], bf16 = hd[3];
    const float scale = take<float>(in, 1)[0];
    const size_t n = (size_t)G * dh * S;
    auto q = take<float>(in, n), k = take<float>(in, n), v = take<float>(in, n);
    for (int run = 0; run < 2; ++run) {
      std::vector<float> o(n), m((size_t)G * S), z((size_t)G * S);
      poison();
      err |= sa_fwd(q.data(), k.data(), v.data(), o.data(), m.data(), z.data(), G, dh, S, scale,
                    bf16, nullptr);
      for (auto* x : {&o, &m, &z}) put(out, *x);
    }
    auto op = [&](float x) { return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x; };
    std::vector<float> mref((size_t)G * S);
    for (int g = 0; g < G; ++g)
      for (int i = 0; i < S; ++i) {
        float mx = -FLT_MAX;
        for (int j = 0; j < S; ++j) {
          float s = 0.f;
          for (int d = 0; d < dh; ++d)
            s = fmaf(op(q[((size_t)g * dh + d) * S + i]), op(k[((size_t)g * dh + d) * S + j]), s);
          mx = fmaxf(mx, s);
        }
        mref[(size_t)g * S + i] = mx;
      }
    put(out, mref);
  } else if (mode == 3) {
    auto hd = take<int>(in, 7);
    const int B = hd[0], E = hd[1], S = hd[2], L = hd[3], H = hd[4], res = hd[5], ln = hd[6];
    auto fl = take<float>(in, 2);
    const int dh = E / H;
    auto x = take<float>(in, (size_t)B * E * S);
    auto wq = take<float>(in, (size_t)L * H * E * dh), wk = take<float>(in, (size_t)L * H * E * dh),
         wv = take<float>(in, (size_t)L * H * E * dh), wo = take<float>(in, (size_t)L * H * dh * E);
    auto gam = take<float>(in, (size_t)L * E), bet = take<float>(in, (size_t)L * E);
    auto w1 = take<float>(in, (size_t)E * E), b1 = take<float>(in, E), w2 = take<float>(in, E);
    for (int run = 0; run < 3; ++run) {
      std::vector<float> pooled((size_t)B * E), m((size_t)B * L * H * S), z(m.size()),
          os((size_t)B * L * E * S), ys(os.size());
      const bool save = run < 2;
      poison();
      err |= ab_fwd(x.data(), wq.data(), wk.data(), wv.data(), wo.data(), gam.data(), bet.data(),
                    w1.data(), b1.data(), w2.data(), pooled.data(), save ? m.data() : nullptr,
                    save ? z.data() : nullptr, save ? os.data() : nullptr,
                    save ? ys.data() : nullptr, B, E, S, L, H, fl[0], fl[1], res, ln, nullptr);
      put(out, pooled);
      if (save)
        for (auto* v : {&m, &z, &os, &ys}) put(out, *v);
    }
    std::vector<float> mref((size_t)B * H * S), q((size_t)dh * S), k((size_t)dh * S);
    for (int b = 0; b < B; ++b)
      for (int h = 0; h < H; ++h) {
        for (int d = 0; d < dh; ++d)
          for (int s = 0; s < S; ++s) {
            float aq = 0.f, ak = 0.f;
            for (int e = 0; e < E; ++e) {
              const float xv = x[((size_t)b * E + e) * S + s];
              aq = fmaf(wq[((size_t)h * E + e) * dh + d], xv, aq);
              ak = fmaf(wk[((size_t)h * E + e) * dh + d], xv, ak);
            }
            q[d * S + s] = aq;
            k[d * S + s] = ak;
          }
        for (int i = 0; i < S; ++i) {
          float mx = -FLT_MAX;
          for (int j = 0; j < S; ++j) {
            float sc = 0.f;
            for (int d = 0; d < dh; ++d) sc = fmaf(q[d * S + i], k[d * S + j], sc);
            mx = fmaxf(mx, sc);
          }
          mref[((size_t)b * H + h) * S + i] = mx;
        }
      }
    put(out, mref);
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
    poison();
    err |= ab_fwd(x.data(), wq.data(), wk.data(), wv.data(), wo.data(), gam.data(), bet.data(),
                  w1.data(), b1.data(), w2.data(), pooled.data(), m.data(), z.data(), os.data(),
                  ys.data(), B, E, S, L, H, fl[0], fl[1], res, ln, nullptr);
    poison();
    err |= ab_fwd(x.data(), wq.data(), wk.data(), wv.data(), wo.data(), gam.data(), bet.data(),
                  w1.data(), b1.data(), w2.data(), pooled2.data(), nullptr, nullptr, nullptr,
                  nullptr, B, E, S, L, H, fl[0], fl[1], res, ln, nullptr);
    poison();
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
    (d / "cuda_runtime.h").write_text(SHIM + ATTN_EXTRA)
    (d / "cuda_bf16.h").write_text('#pragma once\n#include "cuda_runtime.h"\n')
    (d / "main.cpp").write_text(MAIN)
    exe = d / "attn_emu"
    flags = [cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing",
             "-Wno-unknown-pragmas", f"-I{d}", f"-I{CSRC}"]
    # one g++ per source, all started together, then the link
    sources = [CSRC / f"{name}.cu" for name in ("sa_fwd", "sa_bwd", "ab_fwd", "ab_bwd")]
    sources.append(d / "main.cpp")
    objs = [d / f"{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([*flags, "-x", "c++", "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    for proc in procs:
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log
    subprocess.run([*flags, *map(str, objs), "-o", str(exe)], check=True, capture_output=True,
                   text=True, timeout=600)
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


# (G, dh, S): ragged S below one warp and above, dh as V2's (5) and others;
# for the backward's tensor-core routine also dh 16 (two k8 steps) at an S
# that is not a multiple of 8, S a multiple of 8 but not of 16, and S 150
# (10 key tiles over 8 warps: two rounds of dQ partials); for the forward's
# routine dh 8 (the last width of two m16 tiles a warp) and 9 (the first of
# one), S 266 (9 tiles of 32 queries, the last ragged) and
# S 600 at dh 1 (19 tiles over the block's 16 warps: a second round)
SA_CASES = [(3, 5, 37), (2, 3, 70), (2, 8, 16), (1, 1, 5), (1, 16, 45), (2, 5, 40),
            (1, 1, 150), (3, 9, 37), (1, 5, 266), (1, 1, 600)]


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


# (G, dh, S): ragged S at V2's dh, the ablation's S at dh 8 (two m16 tiles
# and the last ragged 8-key block), dh 9 and 16 (one m16 tile a
# warp), dh 1 at S 5
M_CASES = [(3, 5, 37), (1, 8, 266), (2, 9, 70), (1, 16, 45), (2, 1, 5)]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("G,dh,S", M_CASES)
def test_emulated_forward_row_max_is_the_backwards_score_max(emulator, G, dh, S, precision):
    """The forward's m is bit-equal to each row's max of the scores summed by
    fmaf over d from 0, the order in which the backward recomputes them (so
    that the backward's e is the forward's); o, m and inv_z are bit-equal
    over two runs and o matches the plain version."""
    rng = np.random.default_rng(7 + G * 100 + dh * 10 + S)
    q, k, v = (rng.normal(size=(G, dh, S)).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(dh)
    n, r = G * dh * S, G * S
    o, m, z, o2, m2, z2, mref = _run(
        emulator, f"m_{G}_{dh}_{S}_{precision}", [2, G, dh, S, int(precision == "bf16")],
        [scale], (q, k, v), [n, r, r, n, r, r, r])
    assert torch.equal(m, mref)
    for a, b in ((o, o2), (m, m2), (z, z2)):
        assert torch.equal(a, b)
    want_o = sa.sa_forward_reference(*(torch.from_numpy(a) for a in (q, k, v)), scale,
                                     precision)[0]
    rtol = 1e-4 if precision == "fp32" else 1e-2
    _close_to_max(o.view(G, dh, S), want_o, rtol)


# (G, dh, S): scores that rise along the keys, so that the fp32 walk moves
# its reference max every few 8-key blocks (at the ragged last block too)
RISING_CASES = [(2, 5, 37), (1, 8, 100), (1, 9, 45), (1, 1, 70)]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("G,dh,S", RISING_CASES)
def test_emulated_forward_rebases_on_rising_scores(emulator, G, dh, S, precision):
    """The fp32 forward takes e from a reference max that trails the running
    max by at most 2^8 in e and rebases its sums where a row passes it: with
    every key's score above the last block's, o, m and inv_z still match the
    plain version (m bit-equal to the fmaf row max), bit-equal over two runs."""
    rng = np.random.default_rng(11 + G * 100 + dh * 10 + S)
    q = (1 + 0.1 * rng.normal(size=(G, dh, S))).astype(np.float32)
    k = (np.linspace(0, 60 / dh, S)[None, None, :] * (1 + 0.1 * rng.normal(size=(G, dh, S))))
    k = k.astype(np.float32)
    v = rng.normal(size=(G, dh, S)).astype(np.float32)
    scale = 1.0 / np.sqrt(dh)
    n, r = G * dh * S, G * S
    o, m, z, o2, m2, z2, mref = _run(
        emulator, f"rise_{G}_{dh}_{S}_{precision}", [2, G, dh, S, int(precision == "bf16")],
        [scale], (q, k, v), [n, r, r, n, r, r, r])
    assert torch.equal(m, mref)
    for a, b in ((o, o2), (m, m2), (z, z2)):
        assert torch.equal(a, b)
    want_o, want_m, want_z = sa.sa_forward_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                                     scale, precision)
    torch.testing.assert_close(o.view(G, dh, S), want_o, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(m.view(G, S), want_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(z.view(G, S), want_z, rtol=1e-4, atol=1e-6)


# (B, E, S, H, L, residual, layer_norm): V1's block (L 1), L 2, each of the
# residual and the LayerNorm off, a ragged S; then eight heads of dh 1 with
# neither the residual nor the LayerNorm, whose backward keeps the attention
# routine's scratch in a borrowed gradient row (the others past the
# statistics); one head of dh 9, whose forward routine takes one m16 tile a
# warp and walks 5 query tiles over 3 warps.  Wider E costs the emulation a block of 256 threads per
# parameter entry in the reduce, so dh 16 and the routine's one-buffer mode
# are the card tests' cases.
AB_CASES = [
    (3, 10, 16, 2, 1, True, True),
    (2, 10, 16, 2, 2, True, True),
    (2, 10, 16, 2, 1, False, True),
    (2, 10, 16, 2, 1, True, False),
    (2, 6, 37, 3, 1, True, True),
    (1, 8, 21, 8, 1, False, False),
    (1, 9, 70, 1, 1, True, True),
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



def block_statistics(cfg, x, wq, wk, wv, wo, gamma, beta):
    """m, inv_z [B, L*H, S], osave and ysave [B, L, E, S] by the plain
    composition of :func:`ab.ab_forward_reference`."""
    B, E, S = x.shape
    H = cfg.heads
    y, ms, zs, os, ys = x, [], [], [], []
    for l in range(cfg.layers):
        sl = slice(l * H, (l + 1) * H)
        q, k, v = (torch.einsum("hed,bes->bhds", w[sl], y) for w in (wq, wk, wv))
        s = torch.einsum("bhds,bhdt->bhst", q, k)
        m = s.amax(-1)
        e = torch.exp((s - m[..., None]) * cfg.scale)
        inv = 1.0 / e.sum(-1)
        o = torch.einsum("bhdt,bhst->bhds", v, e) * inv[:, :, None, :]
        r = torch.einsum("hdf,bhds->bfs", wo[sl], o)
        if cfg.use_residual:
            r = r + y
        if cfg.use_layer_norm:
            mu = r.mean(1, keepdim=True)
            var = (r * r).mean(1, keepdim=True) - mu * mu
            y = gamma[l][None] * ((r - mu) * torch.rsqrt(var + cfg.eps)) + beta[l][None]
        else:
            y = r
        ms.append(m)
        zs.append(inv)
        os.append(o.reshape(B, E, S))
        ys.append(y)
    return torch.cat(ms, 1), torch.cat(zs, 1), torch.stack(os, 1), torch.stack(ys, 1)


# (B, E, S, H, L, residual, layer_norm): V1's block at a ragged S over two
# layers, dh 9 (one m16 tile a warp, 5 query tiles over 3 warps) without
# the LayerNorm, eight heads of dh 1
AB_FWD_CASES = [
    (2, 10, 37, 2, 2, True, True),
    (1, 9, 70, 1, 1, True, False),
    (1, 8, 21, 8, 1, False, False),
]


@pytest.mark.parametrize("B,E,S,H,L,residual,layer_norm", AB_FWD_CASES)
def test_emulated_attn_block_forward_statistics(emulator, B, E, S, H, L, residual, layer_norm):
    """ab_fwd's attention runs through the forward routine: layer 0's m is
    bit-equal to the score max recomputed in the kernel's fmaf orders (what
    ab_bwd recomputes); pooled, m, inv_z, osave and ysave are bit-equal over
    two runs, pooled bit-equal without the saves, and each matches the plain
    composition."""
    rng = np.random.default_rng(3 + B + E + S + H + L)
    x, weights, _ = block_inputs(rng, B, E, S, H, L)
    cfg = ab.BlockCfg(layers=L, heads=H, scale=1.0 / np.sqrt(E // H), use_residual=residual,
                      use_layer_norm=layer_norm, eps=1e-5)
    st, big = B * L * H * S, B * L * E * S
    sizes = [B * E, st, st, big, big] * 2 + [B * E, B * H * S]
    outs = _run(emulator, f"abf_{B}_{E}_{S}_{H}_{L}_{residual}_{layer_norm}",
                [3, B, E, S, L, H, int(residual), int(layer_norm)], [cfg.scale, cfg.eps],
                (x, *weights), sizes)
    first, second, pooled_nosave, mref = outs[:5], outs[5:10], outs[10], outs[11]
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    pooled, m, z, osave, ysave = first
    assert torch.equal(pooled, pooled_nosave)
    assert torch.equal(m.view(B, L * H, S)[:, :H], mref.view(B, H, S))
    xt = torch.from_numpy(x)
    wt = [torch.from_numpy(w) for w in weights]
    torch.testing.assert_close(pooled.view(B, E), ab.ab_forward_reference(cfg, xt, *wt),
                               rtol=1e-4, atol=1e-5)
    want_m, want_z, want_o, want_y = block_statistics(cfg, xt, *wt[:6])
    torch.testing.assert_close(m.view(B, L * H, S), want_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(z.view(B, L * H, S), want_z, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(osave.view(B, L, E, S), want_o, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ysave.view(B, L, E, S), want_y, rtol=1e-4, atol=1e-5)
