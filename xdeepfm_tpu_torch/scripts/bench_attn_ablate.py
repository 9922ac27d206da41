"""Attention-kernel cost attribution: dots-only against softmax-only
(port of ``scripts/bench_attn_ablate.py``).

Times three forwards at the CIN-attention shapes to split the per-pair cost
of the small-attention forward between its two products (the score dot
and the output dot, fp32 FMAs on the card's CUDA cores) and its softmax
passes (max, exp2 on the special-function units, sums, normalisation).  The
variants (``ops/attn_ablate_cuda.py``, ``ops/csrc/sa_ablate.cu``) run the
production forward's routine (``ops/csrc/attn_fwd_tc.cuh``) and change only
its arithmetic: the same operands, one block a pair, the same tiles and
shared-memory staging, so differences attribute compute.

    python -m xdeepfm_tpu_torch.scripts.bench_attn_ablate [G S dh] [--device cuda|cpu]

Defaults G 8192, S 266, dh 5.  On the card it prints the card's name and
power limit (nvidia-smi) and each kernel's launch geometry (threads and
dynamic shared bytes a block), then times each kernel with CUDA events over
20 calls on fixed seeded inputs after a warm-up: each output is discarded,
never fed back as the next q (dots has no normalisation, so chained outputs
would grow by about S * dh a call and overflow within a few calls).  On the
CPU it
times the plain versions.  One JSON line follows each variant, with the keys
``shape``, ``full_fwd_ms``, ``dots_only_fwd_ms`` and ``softmax_only_fwd_ms``
as they are measured.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..basemodel import resolve_device
from ..ops.attn_ablate import ablate_forward
from ..ops.attn_ablate_cuda import geometry

KEYS = (("full", "full_fwd_ms"), ("dots", "dots_only_fwd_ms"), ("soft", "softmax_only_fwd_ms"))
ITERS = 20  # timed calls a variant, after one warm-up call


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("shape", nargs="*", type=int, metavar="G S dh",
                   help="pairs, columns and head width (default 8192 266 5)")
    p.add_argument("--device", default="cuda", help="'cuda' (the kernels) or 'cpu' (plain)")
    args = p.parse_args(argv)
    if len(args.shape) > 3:
        p.error("at most three sizes: G S dh")
    args.G, args.S, args.dh = args.shape + [8192, 266, 5][len(args.shape):]
    return args


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
    G, S, dh = args.G, args.S, args.dh
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=(G, dh, S)).astype(np.float32), device=device)
               for _ in range(3))
    scale = 1.0 / np.sqrt(dh)
    if cuda:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(json.dumps({"device": torch.cuda.get_device_name(device), "nvidia_smi": smi,
                          "geometry": {name: dict(zip(("threads", "shared_bytes"),
                                                      geometry(name, dh, S)))
                                       for name, _ in KEYS}}), flush=True)
    out = {"shape": f"G{G} S{S} dh{dh}", "device": device.type}
    for name, key in KEYS:
        out[key] = _time_ms(lambda: ablate_forward(name, q, k, v, scale), cuda)
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
