"""Time the CIN's bf16 kernels (``cin_fwd_bf16`` in ``ops/csrc/cin_fwd.cu``,
``cin_bwd_dx_bf16`` in ``ops/csrc/cin_bwd.cu``) of this checkout at the
canonical xDeepFM's shapes.

The CIN (256, 128) split-half over 26 sparse fields of dim 10: layer 0 is
h [N, 26] x x0 [N, 26] -> 256 columns, layer 1 h [N, 128] (half of layer
0's [N, 256], a column view, as split-half gives it) x x0 -> 128 columns,
N = batch * 10 rows.

    python -m xdeepfm_tpu_torch.scripts.bench_cin_bf16 [--batches 4096 8192]
        [--kernels fwd bwd] [--repeats 3] [--build-only]

Run it from the root of each checkout to be compared, in turns, on one card
in one sitting (it needs only ``cin_rows_forward_bf16`` and
``cin_rows_backward_bf16``, so a checkout from before the bf16 rounding
pass of g runs it too).  ``--build-only`` builds and exits, so that the
checkouts' builds can run side by side before their timings.

On the card it prints the card's name and power limit (nvidia-smi), then
one JSON line a (batch, layer, kernel): the kernel's mean ms over 20 calls
after a warm-up, ``repeats`` times; for the backward also the step's ms
(this checkout's: the rounding pass of g with its fp32 copy for ``cin_dw``,
then the kernel on its tiles; a checkout without that pass: the kernel and
``bf16_round(g)``) and the rounding pass alone; the largest difference from
the bf16 plain version on the same seeded inputs; the error against float64
of the same rounded operands as a multiple of the plain version's (the
smoke's gate holds it to 2); whether two runs are bit-equal, and the
outputs' sha256 (its first 16 hex digits: bit-equal variants share it); and
the bound,
2 N H M O operations at the bf16 tensor cores' 989 TFLOP/s (H100 SXM).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import numpy as np
import torch

from ..ops import _build, cin_cuda

ITERS = 20  # timed calls a repeat, after one warm-up call
# (layer, H, M, O) of the canonical CIN (256, 128) split-half
LAYERS = (("layer0", 26, 26, 256), ("layer1", 128, 26, 128))
DIM = 10  # embedding dim: rows per example
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s of the H100 SXM at 700 W


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", nargs="+", type=int, default=[4096, 8192],
                   help="examples a batch (default: the train batch 4096, the scoring 8192)")
    p.add_argument("--kernels", nargs="+", choices=("fwd", "bwd"), default=["fwd", "bwd"])
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


def _device_ms(fn, calls=5):
    """Device ms a call by kernel name (torch.profiler over ``calls`` calls
    after a warm-up); empty where the profiler recorded no device time."""
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


def _inputs(rng, N, H, M, O, strided):
    wide = rng.normal(size=(N, 2 * H if strided else H)).astype(np.float32)
    h, x0, W, b, g = (torch.as_tensor(a, device="cuda") for a in (
        wide, rng.normal(size=(N, M)).astype(np.float32),
        rng.normal(size=(O, H * M)).astype(np.float32), rng.normal(size=O).astype(np.float32),
        rng.normal(size=(N, O)).astype(np.float32)))
    return (h[:, H:] if strided else h), x0, W, b, g


def bench_fwd(h, x0, W, b, repeats):
    got = cin_cuda.cin_rows_forward_bf16(h, x0, W, b)
    want = cin_cuda.cin_rows_reference_bf16(h, x0, W, b)
    exact = cin_cuda.cin_rows_reference_bf16(h.double(), x0.double(), W.double(), b.double())
    rec = dict(max_abs_err_vs_plain=float((got - want).abs().max()),
               err_vs_float64_over_plain=_vs_float64(got, want, exact),
               bit_equal=bool(torch.equal(got, cin_cuda.cin_rows_forward_bf16(h, x0, W, b))),
               sha256=hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16])
    del got, want, exact
    rec["ms"] = [_time_ms(lambda: cin_cuda.cin_rows_forward_bf16(h, x0, W, b))
                 for _ in range(repeats)]
    rec["device_ms"] = _device_ms(lambda: cin_cuda.cin_rows_forward_bf16(h, x0, W, b))
    return rec


def bench_bwd(g, h, x0, W, repeats):
    bwd = cin_cuda.cin_rows_backward_bf16
    got = bwd(g, h, x0, W)
    want = cin_cuda.cin_rows_backward_reference_bf16(g, h, x0, W)
    exact = cin_cuda.cin_rows_backward_reference_bf16(g.double(), h.double(), x0.double(),
                                                      W.double())
    again = bwd(g, h, x0, W)
    rec = dict(max_abs_err_vs_plain=max(float((a - w).abs().max()) for a, w in zip(got, want)),
               err_vs_float64_over_plain={k: _vs_float64(a, w, e) for k, a, w, e in
                                          zip(("dh", "dx0"), got, want, exact)},
               bit_equal=all(torch.equal(a, c) for a, c in zip(got, again)),
               sha256=hashlib.sha256(b"".join(a.cpu().numpy().tobytes() for a in got))
               .hexdigest()[:16])
    del got, want, exact, again
    rnd = getattr(cin_cuda, "cin_rows_round_g_bf16", None)
    if rnd is None:  # the kernel rounds g itself; cin_dw's operand is a torch pass
        def step():
            bwd(g, h, x0, W)
            cin_cuda.bf16_round(g)
    else:
        def step():
            bwd(rnd(g), h, x0, W)
    rec["ms"] = [_time_ms(lambda: bwd(g, h, x0, W)) for _ in range(repeats)]
    rec["step_ms"] = [_time_ms(step) for _ in range(repeats)]
    rec["step_device_ms"] = _device_ms(step)
    if rnd is not None:
        assert torch.equal(rnd(g).rounded, cin_cuda.bf16_round(g))
        rec["round_g_ms"] = [_time_ms(lambda: rnd(g)) for _ in range(repeats)]
    return rec


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_cin_bf16 times the CUDA kernels and needs a card")
    if args.build_only:
        _build.build({"fwd": "cin_fwd", "bwd": "cin_bwd"}[k] for k in args.kernels)
        return []
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    rng = np.random.default_rng(0)
    outs = []
    for batch in args.batches:
        N = batch * DIM
        for layer, H, M, O in LAYERS:
            h, x0, W, b, g = _inputs(rng, N, H, M, O, layer == "layer1")
            for kernel in args.kernels:
                rec = bench_fwd(h, x0, W, b, args.repeats) if kernel == "fwd" else \
                    bench_bwd(g, h, x0, W, args.repeats)
                out = {"kernel": f"cin_{kernel}_bf16" if kernel == "fwd" else "cin_bwd_dx_bf16",
                       "batch": batch, "layer": layer, "N": N, "H": H, "M": M, "O": O,
                       "bound_ms": 2 * N * H * M * O / PEAK_BF16 * 1e3, **rec}
                print(json.dumps(out), flush=True)
                outs.append(out)
            del h, x0, W, b, g
    return outs


if __name__ == "__main__":
    main()
