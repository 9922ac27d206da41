"""Profiling / tracing hooks (port of ``xdeepfm_tpu/profiling.py``).

The reference's only observability is epoch wall-clock prints
(``basemodel.py:235,288``, SURVEY.md §5).  Over ``torch.profiler``:

* :func:`trace` — context manager for an ad-hoc trace,
* :class:`ProfilerCallback` — traces selected epochs,
* :class:`StepTimer` — per-step wall-clock histogram without device syncs.

A trace records CPU activity, and CUDA activity where a GPU is present; it
is written into ``log_dir`` as a Chrome trace (``trace_<n>.json``, viewable
in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .callbacks import Callback


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start():
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    return prof


def _stop(prof, log_dir):
    """Stop ``prof`` and export its Chrome trace into ``log_dir``; returns
    the trace's path."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    n = sum(1 for f in os.listdir(log_dir) if f.startswith("trace_"))
    path = os.path.join(log_dir, f"trace_{n}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    prof = _start()
    try:
        yield prof
    finally:
        _stop(prof, log_dir)


class ProfilerCallback(Callback):
    """Trace selected epochs (default: epoch 1, past the first epoch's
    kernel builds and allocator warm-up)."""

    def __init__(self, log_dir: str, epochs=(1,)):
        super().__init__()
        self.log_dir = log_dir
        self.epochs = set(epochs)
        self._prof = None

    def on_epoch_begin(self, epoch, logs=None):
        if epoch in self.epochs:
            self._prof = _start()

    def on_epoch_end(self, epoch, logs=None):
        if self._prof is not None:
            _stop(self._prof, self.log_dir)
            self._prof = None

    def on_train_end(self, logs=None):
        self.on_epoch_end(None)


class StepTimer:
    """Host-side step timer: records dispatch-to-dispatch deltas (no syncs)."""

    def __init__(self):
        self.times = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def summary(self):
        import numpy as np

        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {
            "steps": len(a),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p99_ms": float(np.percentile(a, 99) * 1e3),
        }
