"""Big-table embedding-optimizer bench (counterpart of the JAX package's
``scripts/bench_lazy.py``): dense against the lazy row-sparse optimizer.

Criteo-production shape: 26 sparse fields of ``vocab`` rows each, dim 10, 13
dense fields, xDeepFM CIN (256, 128) split-half / DNN (256, 256), batch 4096,
L2 1e-5 on the tables, seed 1024; ids uniform over each field's vocabulary.
``bench.py``'s ``lazy104`` row is ``4000000 adagrad lazy_split`` (104M rows).

    python -m xdeepfm_tpu_torch.scripts.bench_lazy [vocab] [adam|adagrad]
        [modes...] [--steps 20] [--repeats 1] [--device cuda|cpu]

Modes: ``dense`` (the dense optimizer over every table), ``lazy`` (lazy, the
table's dense gradient), ``lazy_split`` (lazy, split gradient, packed
layout), ``lazy_split_flat`` (split, flat layout) and ``lazy_split_bf16``
(split, packed, bf16 row state).  The model is built once and compiled anew
for each mode; with ``--repeats`` the modes run again in turns (forward,
then backward order), since host-bound step times spread between runs.
One JSON line a mode: ms a step from CUDA events over ``--steps`` steps
after two warm-up steps, examples/s, the device's busy ms a step, idle
share and busiest kernels from torch.profiler over 5 steps, the
memory allocated before the steps and the peak during them
(``torch.cuda.max_memory_allocated``).  On the CPU the times are the host
clock's and there is no profile or memory.  On the card the first line is
the card's name and power limit (nvidia-smi).  Its ``dense`` mode runs in a
checkout from before the lazy optimizer too: copy the script there to
compare the dense step of two trees in turns.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..basemodel import resolve_device
from ..features import DenseFeat, SparseFeat
from ..models import xDeepFM

BATCH, N_SPARSE, N_DENSE, EMB = 4096, 26, 13, 10
MODES = {
    "dense": {},
    "lazy": dict(embedding_optimizer="lazy", embedding_gradient="dense"),
    "lazy_split": dict(embedding_optimizer="lazy", embedding_gradient="split"),
    "lazy_split_flat": dict(embedding_optimizer="lazy", embedding_gradient="split",
                            embedding_layout="flat"),
    "lazy_split_bf16": dict(embedding_optimizer="lazy", embedding_gradient="split",
                            embedding_state_dtype="bfloat16"),
}
PROFILE_STEPS = 5


def build_model(vocab, device="cuda", seed=1024, **kw):
    """The bench's xDeepFM at ``vocab`` rows a field (built on the host from
    ``seed``, then moved to ``device``)."""
    cols = [SparseFeat(f"C{i}", vocab, embedding_dim=EMB) for i in range(N_SPARSE)] + [
        DenseFeat(f"I{i}", 1) for i in range(N_DENSE)]
    return xDeepFM(cols, cols, dnn_hidden_units=(256, 256), cin_layer_size=(256, 128),
                   seed=seed, device=device, **kw)


def compile_mode(model, mode, optimizer="adam"):
    model.compile(optimizer, "binary_crossentropy", metrics=[], **MODES[mode])


def draw_batch(model, vocab, rng):
    """One batch of BATCH rows on the model's device as the JAX script draws
    it: ids uniform over each field's vocabulary, dense uniform in [0, 1),
    random labels.  Returns (x dict, labels [n, 1], mask [n])."""
    n = BATCH
    x = {f.name: rng.integers(0, vocab, size=n) for f in model.schema.sparse}
    x.update({f.name: rng.uniform(0, 1, size=n).astype(np.float32) for f in model.schema.dense})
    xb = {k: torch.as_tensor(v, device=model.device) for k, v in model.schema.pack(x).items()}
    y = torch.as_tensor(rng.integers(0, 2, size=(n, 1)).astype(np.float32), device=model.device)
    return xb, y, torch.ones(n, device=model.device)


def device_breakdown(prof, wall_ms, calls, top=12):
    """Device ms a call, busy and idle share, and the busiest kernels, from a
    torch.profiler run of ``calls`` calls that took ``wall_ms``."""
    device_ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            device_ms[e.name] = device_ms.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(device_ms.values())
    ranked = sorted(device_ms.items(), key=lambda kv: -kv[1])[:top]
    return dict(wall_ms_per_call=wall_ms / calls, device_busy_ms_per_call=busy / calls,
                device_idle_share=1.0 - busy / wall_ms,
                top_device_ms_per_call=[[name[:80], ms / calls] for name, ms in ranked])


def time_steps(model, batches, steps):
    """(ms a step, its source): CUDA events on the card, the host clock on
    the CPU, over ``steps`` train steps after two warm-up steps."""
    for xb, y, mask in batches[:2]:
        model._train_step(xb, y, mask, with_metrics=False)
    cuda = model.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for i in range(steps):
        model._train_step(*batches[i % len(batches)], with_metrics=False)
    if cuda:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps, "cuda_events"
    return (time.perf_counter() - t0) * 1e3 / steps, "host_clock"


def profile_steps(model, batches, steps=PROFILE_STEPS):
    """:func:`device_breakdown` over ``steps`` train steps."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            model._train_step(*batches[i % len(batches)], with_metrics=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_breakdown(prof, wall_ms, steps)


def bench(model, vocab, mode, optimizer="adam", steps=20, n_batches=4, seed=0):
    """Compile ``model`` for ``mode`` and time its train step: one record."""
    compile_mode(model, mode, optimizer)
    # fit's dropout stream (the bench model has no dropout)
    model._dropout_gen = torch.Generator(device=model.device).manual_seed(model.seed + 1)
    rng = np.random.default_rng(seed)
    batches = [draw_batch(model, vocab, rng) for _ in range(n_batches)]
    cuda = model.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    ms, clock = time_steps(model, batches, steps)
    rec = dict(mode=mode, optimizer=optimizer, rows=vocab * N_SPARSE, batch=BATCH, steps=steps,
               ms_per_step=ms, clock=clock, examples_per_s=BATCH / ms * 1e3)
    if cuda:
        rec.update(memory_allocated_before=resident,
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        rec.update(profile_steps(model, batches))
    if getattr(model, "_lazy", None) is not None:  # none before the lazy optimizer's port
        rec["lazy_arrays_bytes"] = sum(g["array"].numel() * 4 for g in model._lazy["groups"])
    return rec


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("vocab", nargs="?", type=int, default=400_000, help="rows a field")
    p.add_argument("modes", nargs="*", default=None,
                   help="an optimizer (adam, adagrad; default adam) then modes "
                        f"({', '.join(MODES)}; default dense lazy lazy_split)")
    p.add_argument("--steps", type=int, default=20, help="timed steps a mode")
    p.add_argument("--repeats", type=int, default=1, help="runs of each mode, in turns")
    p.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    modes = list(args.modes or [])
    optimizer = modes.pop(0) if modes and modes[0] in ("adam", "adagrad") else "adam"
    modes = modes or ["dense", "lazy", "lazy_split"]
    for mode in modes:
        if mode not in MODES:
            raise SystemExit(f"unknown mode {mode!r}; one of {sorted(MODES)}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    model = build_model(args.vocab, device)
    build_s = time.perf_counter() - t0
    records = []
    for r in range(args.repeats):
        for mode in modes if r % 2 == 0 else modes[::-1]:
            rec = bench(model, args.vocab, mode, optimizer, args.steps)
            rec.update(build_seconds=build_s, repeat=r)
            print(json.dumps(rec), flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
