"""Time the CIN forward kernel (``ops/csrc/cin_fwd.cu``) of this checkout
at the canonical xDeepFM's shapes.

The CIN (256, 128) split-half over 26 sparse fields of dim 10: layer 0 is
h [N, 26] x x0 [N, 26] -> 256 columns, layer 1 h [N, 128] (the second
half of layer 0's [N, 256], a column view, as split-half gives it) x x0 ->
128 columns, N = batch * 10 rows.

    python -m xdeepfm_tpu_torch.scripts.bench_cin_fwd [--batches 4096 8192]
        [--repeats 3] [--device cuda|cpu]

Run it from the root of each checkout to be compared, in turns, on one
card in one sitting.  On the card it prints the card's name and power limit
(nvidia-smi), then one JSON line a (batch, layer) with the kernel's mean ms
over 50 calls after a warm-up, ``repeats`` times, and its largest
difference from the plain version on the same seeded inputs.  On the CPU
it times the plain version.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..basemodel import resolve_device
from ..ops.cin_cuda import cin_rows_forward, cin_rows_reference

ITERS = 50  # timed calls a repeat, after one warm-up call
# (layer, H, M, O) of the canonical CIN (256, 128) split-half
LAYERS = (("layer0", 26, 26, 256), ("layer1", 128, 26, 128))
DIM = 10  # embedding dim: rows per example


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", nargs="+", type=int, default=[4096, 8192],
                   help="examples a batch (default: the train batch 4096, the scoring 8192)")
    p.add_argument("--repeats", type=int, default=3, help="timings of each shape")
    p.add_argument("--device", default="cuda", help="'cuda' (the kernel) or 'cpu' (plain)")
    return p.parse_args(argv)


def _time_ms(fn, cuda):
    fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        return (time.perf_counter() - t0) * 1e3 / ITERS
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(json.dumps({"device": torch.cuda.get_device_name(device), "nvidia_smi": smi}),
              flush=True)
    fwd = cin_rows_forward if cuda else cin_rows_reference
    rng = np.random.default_rng(0)
    outs = []
    for batch in args.batches:
        N = batch * DIM
        for layer, H, M, O in LAYERS:
            strided = layer == "layer1"
            hw = rng.normal(size=(N, 2 * H if strided else H)).astype(np.float32)
            h, x0, W, b = (torch.as_tensor(a, device=device) for a in (
                hw, rng.normal(size=(N, M)).astype(np.float32),
                rng.normal(size=(O, H * M)).astype(np.float32),
                rng.normal(size=O).astype(np.float32)))
            h = h[:, H:] if strided else h
            err = float((fwd(h, x0, W, b) - cin_rows_reference(h, x0, W, b)).abs().max())
            ms = [_time_ms(lambda: fwd(h, x0, W, b), cuda) for _ in range(args.repeats)]
            out = {"batch": batch, "layer": layer, "N": N, "H": H, "M": M, "O": O,
                   "strided_h": strided, "device": device.type, "ms": ms,
                   "max_abs_err_vs_plain": err}
            print(json.dumps(out), flush=True)
            outs.append(out)
            del h, x0, W, b, hw
    return outs


if __name__ == "__main__":
    main()
