"""Time the GRU-scan kernels (``ops/csrc/gru_fwd.cu`` and ``gru_bwd.cu``) of
this checkout at DIEN's shapes.

DIEN runs the interest extractor's cell gru and the interest evolution's
augru over T 50 steps of H 10 units, a train batch of 4096 and a scoring
batch of 8192, with lengths uniform in 1..50.

    python -m xdeepfm_tpu_torch.scripts.bench_gru [--batches 4096 8192]
        [--cells gru augru] [--repeats 3] [--device cuda|cpu]

Run it from the root of each checkout to be compared, in turns, on one card
in one sitting; it uses only ``gru_forward`` / ``gru_backward`` and their
plain versions, which every checkout since the GRU kernels has.  On the
card it prints the card's name and power limit (nvidia-smi) and the
registers of each kernel build (``-Xptxas=-v``), then one JSON line a
(batch, cell, kernel): the mean ms a call over 50 calls after a warm-up from
CUDA events, ``repeats`` times; the mean device ms a call from
torch.profiler's kernel durations over 50 calls, ``repeats`` times (the
backward's two kernels, ``gru_bwd_kernel`` and ``gru_bwd_sum_kernel``,
summed, and once each alone); the host's µs a call (the wrapper's checks,
allocations and launch, by the host clock over 200 calls without a
synchronise); and the largest difference from the plain version on the same
seeded inputs.  On the CPU it times the plain versions by the host clock.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import numpy as np
import torch

from ..basemodel import resolve_device
from ..ops import _build
from ..ops.gru_cuda import (
    gru_backward,
    gru_backward_reference,
    gru_forward,
    gru_forward_reference,
)

ITERS = 50  # timed calls a repeat, after one warm-up call
HOST_ITERS = 200  # calls timed by the host clock
T, H = 50, 10  # DIEN's history length and hidden width
KERNELS = {"gru_fwd": ("gru_fwd_kernel",), "gru_bwd": ("gru_bwd_kernel", "gru_bwd_sum_kernel")}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", nargs="+", type=int, default=[4096, 8192],
                   help="samples a call (default: the train batch 4096, the scoring 8192)")
    p.add_argument("--cells", nargs="+", default=["gru", "augru"],
                   help="cells to time (default: DIEN's gru and augru)")
    p.add_argument("--repeats", type=int, default=3, help="timings of each shape")
    p.add_argument("--device", default="cuda", help="'cuda' (the kernels) or 'cpu' (plain)")
    return p.parse_args(argv)


def operands(rng, cell, B, device):
    """Seeded operands at DIEN's widths: (gi, w, b, att, lengths, h0) and the
    cotangent g of outs; lengths uniform in 1..T."""
    f32 = np.float32
    ops = [rng.normal(size=(B, T, 3, H)).astype(f32),
           (rng.normal(size=(3, H, H)) / np.sqrt(H)).astype(f32),
           (0.3 * rng.normal(size=(3, H))).astype(f32),
           rng.uniform(size=(B, T)).astype(f32),
           rng.integers(1, T + 1, B).astype(np.int32),
           (0.5 * rng.normal(size=(B, H))).astype(f32),
           rng.normal(size=(B, T, H)).astype(f32)]
    ops = [torch.as_tensor(a, device=device) for a in ops]
    if cell == "gru":
        ops[3] = None
    return ops


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


def host_us(fn, iters=HOST_ITERS):
    """The host's µs a call: the host clock around ``iters`` calls that end
    before the device has run them (no synchronise inside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e6 / iters


def device_ms(fn, kernels, iters=ITERS, attempts=5):
    """Mean device ms a call of ``fn`` that launches each of ``kernels`` (name
    substrings) once: torch.profiler's kernel durations over ``iters`` calls
    after one warm-up call (the device's activity alone, no host events),
    each kernel's mean over the launches the profiler recorded, summed over
    the kernels.  The profiler can drop the records of a window (seen on the
    card: 36 of 50, once none, and once too few in three windows in a row),
    so a window in which it kept fewer than half of some kernel's launches is
    profiled again, up to ``attempts`` windows.  If none kept enough, the
    time is not measured and the result is None: the caller's CUDA-event
    time stands alone.  Raises if a window recorded more than a launch a
    call."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        means = []
        for kernel in kernels:
            times = [e.device_time_total for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
            if len(times) > iters:
                raise RuntimeError(f"profiler saw {len(times)} launches of {kernel} in {iters} calls")
            if 2 * len(times) < iters:
                break
            means.append(sum(times) / len(times))
        else:
            return sum(means) / 1e3
    print(json.dumps({"device_ms_not_measured": list(kernels), "windows": attempts,
                      "why": f"the profiler kept fewer than {iters // 2} of {iters} launches "
                             "in every window"}), flush=True)
    return None


def registers(logs):
    """{kernel instance: registers} from nvcc's ``-Xptxas=-v`` build logs."""
    out = {}
    for log in logs.values():
        name = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name] = int(m.group(1))
    return out


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
        print(json.dumps({"registers": registers(_build.build(list(KERNELS)))}), flush=True)
    fwd, bwd = (gru_forward, gru_backward) if cuda else (gru_forward_reference,
                                                         gru_backward_reference)
    rng = np.random.default_rng(0)
    outs_all = []
    for batch in args.batches:
        for cell in args.cells:
            gi, w, b, att, lengths, h0, g = operands(rng, cell, batch, device)
            fargs = (cell, gi, w, b, att, lengths, h0)
            outs = fwd(*fargs)
            bargs = (cell, g, gi, w, b, att, lengths, h0, outs)
            err = {"gru_fwd": float((outs - gru_forward_reference(*fargs)).abs().max()),
                   "gru_bwd": max(float((a - e).abs().max()) for a, e in zip(
                       bwd(*bargs), gru_backward_reference(*bargs)))}
            for name, fn in (("gru_fwd", lambda: fwd(*fargs)), ("gru_bwd", lambda: bwd(*bargs))):
                out = {"kernel": name, "batch": batch, "cell": cell, "T": T, "H": H,
                       "valid_steps": int(lengths.sum()), "device": device.type,
                       "ms": [_event_ms(fn, cuda) for _ in range(args.repeats)],
                       "max_abs_err_vs_plain": err[name]}
                if cuda:
                    out["device_ms"] = [device_ms(fn, KERNELS[name])
                                        for _ in range(args.repeats)]
                    out["host_us"] = [host_us(fn) for _ in range(args.repeats)]
                    if len(KERNELS[name]) > 1:
                        out["device_ms_by_kernel"] = {k: device_ms(fn, (k,))
                                                      for k in KERNELS[name]}
                print(json.dumps(out), flush=True)
                outs_all.append(out)
            del gi, w, b, att, lengths, h0, g, outs
    return outs_all


if __name__ == "__main__":
    main()
