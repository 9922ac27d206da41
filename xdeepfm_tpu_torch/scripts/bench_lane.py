"""Time the lane-attention kernels (``ops/csrc/la_fwd.cu`` and ``la_bwd.cu``)
of this checkout at AutoInt's and DIFM's shapes.

The models' ``InteractingLayer`` runs 2 heads of dh 5 over S 26 field
tokens and hands the kernels its [B, S, E] projections viewed as
[H, dh, S, B] ("packed"); the first batch is also timed in the TPU kernel's
contiguous [H, dh, S, B] layout ("lanes").

    python -m xdeepfm_tpu_torch.scripts.bench_lane [--batches 4096 8192]
        [--repeats 3] [--device cuda|cpu]

Run it from the root of each checkout to be compared, in turns, on one card
in one sitting; it uses only ``la_forward`` / ``la_backward`` and their plain
versions, which every checkout since the lane kernels has.  On the card it
prints the card's name and power limit (nvidia-smi), then one JSON line a
(batch, layout, kernel): the mean ms a call over 50 calls after a warm-up
from CUDA events, ``repeats`` times, the mean device ms a launch from
torch.profiler's kernel durations over 50 calls, ``repeats`` times, and the
largest difference from the plain version on the same seeded inputs.  On
the CPU it times the plain versions by the host clock.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..basemodel import resolve_device
from .bench_gru import device_ms as gru_device_ms
from ..ops.lane_attention_cuda import (
    la_backward,
    la_backward_reference,
    la_forward,
    la_forward_reference,
)

ITERS = 50  # timed calls a repeat, after one warm-up call
H, DH, S = 2, 5, 26  # AutoInt's and DIFM's heads, head width and field tokens


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", nargs="+", type=int, default=[4096, 8192],
                   help="samples a call (default: the train batch 4096, the scoring 8192)")
    p.add_argument("--repeats", type=int, default=3, help="timings of each shape")
    p.add_argument("--device", default="cuda", help="'cuda' (the kernels) or 'cpu' (plain)")
    return p.parse_args(argv)


def _event_ms(fn, cuda):
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


def device_ms(fn, kernel, iters=ITERS):
    """Mean device ms a call of the kernel whose name holds ``kernel``, from
    torch.profiler's kernel durations over ``iters`` calls after one warm-up
    call: the kernel's own time, which back-to-back launches from Python do
    not pace as they pace CUDA events around short kernels.  It is
    :func:`~xdeepfm_tpu_torch.scripts.bench_gru.device_ms` for one kernel,
    which profiles a window again when the profiler dropped its records and
    gives None (not measured) when every window dropped too many."""
    return gru_device_ms(fn, (kernel,), iters)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(json.dumps({"device": torch.cuda.get_device_name(device), "nvidia_smi": smi}),
              flush=True)
    fwd, bwd = (la_forward, la_backward) if cuda else (la_forward_reference, la_backward_reference)
    rng = np.random.default_rng(0)
    outs = []
    runs = [(batch, "packed") for batch in args.batches] + [(args.batches[0], "lanes")]
    for batch, layout in runs:
        shape = (batch, S, H * DH) if layout == "packed" else (H, DH, S, batch)
        q, k, v, g = (torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=device)
                      for _ in range(4))
        if layout == "packed":
            q, k, v, g = (t.view(batch, S, H, DH).permute(2, 3, 1, 0) for t in (q, k, v, g))
        for scale in (1.0, DH ** -0.5):  # AutoInt's, DIFM's
            err = {"la_fwd": float((fwd(q, k, v, scale) - la_forward_reference(q, k, v, scale))
                                   .abs().max()),
                   "la_bwd": max(float((a - b).abs().max()) for a, b in zip(
                       bwd(g, q, k, v, scale), la_backward_reference(g, q, k, v, scale)))}
            for name, fn in (("la_fwd", lambda: fwd(q, k, v, scale)),
                             ("la_bwd", lambda: bwd(g, q, k, v, scale))):
                out = {"kernel": name, "batch": batch, "layout": layout, "H": H, "dh": DH,
                       "S": S, "scale": scale, "device": device.type,
                       "ms": [_event_ms(fn, cuda) for _ in range(args.repeats)],
                       "max_abs_err_vs_plain": err[name]}
                if cuda:
                    out["device_ms"] = [device_ms(fn, f"{name}_kernel")
                                        for _ in range(args.repeats)]
                print(json.dumps(out), flush=True)
                outs.append(out)
        del q, k, v, g
    return outs


if __name__ == "__main__":
    main()
