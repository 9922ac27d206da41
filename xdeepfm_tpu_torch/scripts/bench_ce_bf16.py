"""Time the SFG decoder's fused CE in its bf16 mode (``precision="bf16"``,
``ops/ce_cuda.py``) of this checkout at the canonical Pro step's shapes.

The canonical xDeepFMPro's decoder: 26 heads of vocabulary 10000 padded to
10112 and stacked, hidden K = 64, batch 4096 of which about a third of the
rows are valid ("stacked_third", the train step's shape), and one head of
the same shape ("single_head").

    python -m xdeepfm_tpu_torch.scripts.bench_ce_bf16 [--shapes stacked_third single_head]
        [--repeats 3] [--build-only]

Run it from the root of each checkout to be compared, in turns, on one card
in one sitting: it needs only ``ce_rows_forward`` and ``ce_rows_backward``
with their ``precision`` argument, so a checkout whose bf16 mode is a flag
on the fp32 kernels runs it too.  ``--build-only`` builds and exits, so that
the checkouts' builds can run side by side before their timings.

On the card it prints the card's name and power limit (nvidia-smi), then
one JSON line a shape: for the bf16 mode the forward's and the backward's
mean ms over 10 calls after a warm-up, ``repeats`` times (this checkout's
forward includes its rounding pass, what a step runs; its backward reuses
the rounded tiles as the autograd Function does), the device ms by kernel
(torch.profiler), the largest difference from the bf16 plain version, the
error against float64 of the same rounded operands as a multiple of the
plain version's (the smoke's gate holds it to 2), bit-equality over two
runs; then the fp32 mode's times and its outputs' sha256 (first 16 hex
digits: the same seeded inputs give the same digits on checkouts whose fp32
kernels are bit-equal); and the bf16 bound (the products at 989 TFLOP/s,
the exps at the fp32 rate / 16, H100 SXM).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import torch

from ..ops import _build, ce_cuda

ITERS = 10  # timed calls a repeat, after one warm-up call
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s of the H100 SXM at 700 W
EXP_RATE = 67e12 / 16  # exp2 results/s: the fp32 FMA rate over 16 (H100 SXM)
VOCAB, VP, HEADS, BATCH, K = 10_000, 10_112, 26, 4096, 64
# (label, F, V, padded columns, num_valid)
SHAPES = {"stacked_third": (HEADS, VP, VP - VOCAB, BATCH // 3),
          "single_head": (1, VOCAB, 0, BATCH // 3)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shapes", nargs="+", choices=sorted(SHAPES), default=sorted(SHAPES))
    p.add_argument("--repeats", type=int, default=3, help="timings of each shape")
    p.add_argument("--build-only", action="store_true", help="build the libraries and exit")
    return p.parse_args(argv)


def _time_ms(fn):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def _device_ms(fn, calls=3):
    """Device ms a call by kernel name (torch.profiler over ``calls`` calls
    after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0 \
                and not getattr(e, "is_user_annotation", False):
            key = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
            key = key.split("(")[0]
            out[key] = out.get(key, 0.0) + e.device_time_total / 1e3 / calls
    return out


def _vs_float64(got, want, exact):
    """The kernel's largest error against float64 over the plain version's."""
    plain = float((want.double() - exact).abs().max())
    return float((got.double() - exact).abs().max()) / plain if plain else 0.0


def _exact(g, h, W, b, t, logz, nv):
    """float64 of the bf16 mode on its own rounded operands, over the first
    ``nv`` rows (the rest give 0): (ll, logz) and (dh, dW, db), the
    backward with the given logz as the kernels' and the smoke's gate take
    it.  Kept here so that every checkout is held to the same function."""
    hr, Wr = (x.to(torch.bfloat16).double() for x in (h[:nv], W))
    S = torch.matmul(hr, Wr.transpose(1, 2)) + b.double()[:, None, :]
    lz = torch.logsumexp(S, dim=-1)
    tv = t[:, :nv, None]
    fwd = (lz - S.gather(-1, tv)[..., 0], lz)
    dS = (S - logz[:, :nv, None].double()).exp_()
    del S
    dS.scatter_add_(-1, tv, torch.full(tv.shape, -1.0, device=dS.device, dtype=dS.dtype))
    dS.mul_(g[:, :nv, None].double())
    dSr = dS.to(torch.bfloat16).double()
    bwd = (torch.matmul(dSr, Wr).sum(0), torch.matmul(dSr.transpose(1, 2), hr), dS.sum(1))
    return fwd, bwd


def _inputs(F, V, pad, seed=0):
    """Seeded inputs on the card as the smoke makes them: unit-normal h,
    W / sqrt(K), b and g; the padded columns W 0 and bias -1e30."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(BATCH, K, generator=gen, device="cuda")
    W = torch.randn(F, V, K, generator=gen, device="cuda") / K**0.5
    b = torch.randn(F, V, generator=gen, device="cuda")
    if pad:
        W[:, -pad:] = 0.0
        b[:, -pad:] = -1e30
    t = torch.randint(0, V - pad, (F, BATCH), generator=gen, device="cuda")
    g = torch.randn(F, BATCH, generator=gen, device="cuda")
    return h, W, b, t, g


def bench(label, repeats):
    F, V, pad, nv = SHAPES[label]
    h, W, b, t, g = _inputs(F, V, pad)
    nvd = torch.tensor(nv, device="cuda")
    rec = dict(shape=label, F=F, B=BATCH, K=K, V=V, num_valid=nv)
    rounding = hasattr(ce_cuda, "ce_round_bf16")
    rec["design"] = "bf16 kernels (ce_bf16.cu)" if rounding else "bf16 flag on the fp32 kernels"

    # the bf16 mode
    ll, logz = ce_cuda.ce_rows_forward(h, W, b, t, nvd, "bf16")
    grads = ce_cuda.ce_rows_backward(g, h, W, b, t, logz, nvd, "bf16")
    want = ce_cuda.ce_rows_forward_reference(h, W, b, t, nvd, "bf16")
    exact, exact_bwd = _exact(g, h, W, b, t, logz, nv)
    rec["fwd_max_abs_err_vs_plain"] = max(float((a - w).abs().max()) for a, w in
                                          zip((ll, logz), want))
    rec["fwd_err_vs_float64_over_plain"] = {
        k: _vs_float64(a[:, :nv], w[:, :nv], e) for k, a, w, e in
        zip(("ll", "logz"), (ll, logz), want, exact)}
    del want, exact
    again = ce_cuda.ce_rows_forward(h, W, b, t, nvd, "bf16")
    rec["fwd_bit_equal"] = all(torch.equal(a, c) for a, c in zip((ll, logz), again))
    want = ce_cuda.ce_rows_backward_reference(g, h, W, b, t, logz, nvd, "bf16")
    rec["bwd_max_abs_err_vs_plain"] = max(float((a - w).abs().max()) for a, w in
                                          zip(grads, want))
    rows = (slice(None, nv), slice(None), slice(None))  # dh's valid rows; dW, db whole
    rec["bwd_err_vs_float64_over_plain"] = {
        k: _vs_float64(a[sl], w[sl], e) for k, a, w, e, sl in
        zip(("dh", "dW", "db"), grads, want, exact_bwd, rows)}
    del want, exact_bwd, again
    torch.cuda.empty_cache()
    again = ce_cuda.ce_rows_backward(g, h, W, b, t, logz, nvd, "bf16")
    rec["bwd_bit_equal"] = all(torch.equal(a, c) for a, c in zip(grads, again))
    del again, grads

    def fwd():
        return ce_cuda.ce_rows_forward(h, W, b, t, nvd, "bf16")

    if rounding:  # the backward on the tiles that the forward rounded
        r = ce_cuda.ce_round_bf16(h, W, b, nvd)

        def bwd():
            return ce_cuda.ce_rows_backward_bf16(g, r, t, logz, nvd)
    else:
        def bwd():
            return ce_cuda.ce_rows_backward(g, h, W, b, t, logz, nvd, "bf16")

    rec["fwd_ms"] = [_time_ms(fwd) for _ in range(repeats)]
    rec["bwd_ms"] = [_time_ms(bwd) for _ in range(repeats)]
    rec["fwd_device_ms"] = _device_ms(fwd)
    rec["bwd_device_ms"] = _device_ms(bwd)

    # the fp32 mode: times and the outputs' digest
    ll, logz = ce_cuda.ce_rows_forward(h, W, b, t, nvd)
    grads = ce_cuda.ce_rows_backward(g, h, W, b, t, logz, nvd)
    rec["fp32_outputs_sha256"] = hashlib.sha256(b"".join(
        x.cpu().numpy().tobytes() for x in (ll, logz, *grads))).hexdigest()[:16]
    del grads
    rec["fp32_fwd_ms"] = [_time_ms(lambda: ce_cuda.ce_rows_forward(h, W, b, t, nvd))
                          for _ in range(repeats)]
    rec["fp32_bwd_ms"] = [_time_ms(lambda: ce_cuda.ce_rows_backward(g, h, W, b, t, logz, nvd))
                          for _ in range(repeats)]

    flops = 2 * nv * K * V * F
    exps = nv * V * F
    rec["fwd_bound_ms"] = max(flops / PEAK_BF16, exps / EXP_RATE) * 1e3
    rec["bwd_bound_ms"] = max(3 * flops / PEAK_BF16, exps / EXP_RATE) * 1e3
    rec["exp_floor_ms"] = exps / EXP_RATE * 1e3
    return rec


def main(argv=None):
    args = parse_args(argv)
    _build.build(["ce_fwd", "ce_bwd"] + (["ce_bf16"] if hasattr(ce_cuda, "ce_round_bf16")
                                         else []))
    if args.build_only:
        return
    if not torch.cuda.is_available():
        raise SystemExit("bench_ce_bf16: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for label in args.shapes:
        print(json.dumps(bench(label, args.repeats)), flush=True)


if __name__ == "__main__":
    main()
