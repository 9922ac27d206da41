"""Compiled dispatch: the port's counterpart of ``jax.jit``, ``lax.scan`` and
``lax.map`` over the engine's step functions (``xdeepfm_tpu/basemodel.py:1212-1275``,
``serving.py:24-50``).

The JAX engine compiles its train step, a ``lax.scan`` of K of them
(``train_step_multi``, which amortises the cost of a dispatch over K steps)
and its predict step, once per input shape, and dispatches each as one
program.  Here a :class:`GraphCache` holds, per key (the step function, K,
the inputs' shapes, TF32), one ``torch.cuda.CUDAGraph`` of K chained calls
of the step on static input buffers:

* the first call of a key runs the K steps eagerly on a side stream, as
  real work.  That warm-up builds every kernel's library (``nvcc``), runs
  each launcher's ``cudaFuncSetAttribute``, creates the optimizer's state
  and the BLAS workspaces;
* the second call captures the K steps on static device buffers (which runs
  nothing on the card), so a key that comes once (a one-off ``predict``, a
  last short group) costs no capture;
* that call and every later one copies its inputs into the static buffers
  (host arrays through pinned memory, device tensors on the device),
  replays the graph and copies the outputs out, so that the next replay,
  which writes the same addresses, leaves what the caller holds alone;
* each hand-written kernel's wrapper counts kernels run in ``.launches``:
  a capture's counts are taken back, and its counts are added at every
  replay.

A graph holds the addresses of everything it reads and writes: parameters,
optimizer state, running statistics, the dropout generator's state.  Their
owner drops the graphs (:meth:`GraphCache.clear`) wherever it swaps one of
those tensors for another, rather than writing into it.  A switch that
picks a kernel or its precision (``ops.cin.set_cin_precision``, a layer's
``backend``, ...) calls :func:`bump`, and every cache drops its graphs at
its next call.  A capture that fails raises: no call quietly runs eagerly
instead.

On the CPU (the tests) :meth:`GraphCache.run` calls the step function on the
inputs as they are: the K steps in turn, with the same schedule and inputs
as on the card.
"""

from __future__ import annotations

import gc
import importlib
from typing import Callable, Dict, Hashable, Sequence

import torch

# the modules whose wrappers launch the hand-written kernels
_KERNEL_MODULES = ("cin_cuda", "ce_cuda", "attention_cuda", "attn_block_cuda",
                   "lane_attention_cuda", "gru_cuda", "attn_ablate_cuda")
# the switches' version (:func:`bump`)
_VERSION = 0
# the warm-ups' and captures' stream of each device, shared by every cache:
# cuBLAS keeps a workspace for each stream it runs on until the process
# ends, so a stream per cache held one more workspace for every model
_SIDE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def bump() -> None:
    """Note that a code path changed: every ``set_*`` switch of ``ops/`` and
    ``parallel/`` and every :class:`Switch` attribute calls it when its
    value changes, and each :class:`GraphCache` drops its graphs at its
    next call."""
    global _VERSION
    _VERSION += 1


class Switch:
    """A module attribute that picks a step's code path (a layer's
    ``backend``, the SFG decoder's CE route): changing it calls :func:`bump`,
    so no graph captured under the old value is replayed.  The other plain
    attributes a forward reads are taken as they are at capture, as
    ``jax.jit`` takes the Python values a traced function reads."""

    def __set_name__(self, owner, name):
        self.slot = f"_switch_{name}"

    def __get__(self, obj, owner=None):
        return self if obj is None else obj.__dict__[self.slot]

    def __set__(self, obj, value):
        old = obj.__dict__.get(self.slot, value)  # a new module's first value: no graph has it
        obj.__dict__[self.slot] = value
        if value != old:
            bump()


def launch_counters() -> list:
    """Every kernel wrapper with a ``.launches`` count."""
    found = {}
    for name in _KERNEL_MODULES:
        mod = importlib.import_module(f"xdeepfm_tpu_torch.ops.{name}")
        for fn in vars(mod).values():
            if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                found[id(fn)] = fn
    return list(found.values())


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


def _tree_map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


class _Graph:
    """One captured key: the graph, its static inputs and outputs, the
    launch counts of one replay, the generators it reads."""

    def __init__(self, graph, inputs, outputs, launches, generators):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches, self.generators = launches, generators
        self.replays = 0


class GraphCache:
    """Captured CUDA graphs by key (see the module's docstring)."""

    def __init__(self):
        self._graphs: Dict[Hashable, _Graph] = {}
        self._warm = set()  # the keys run once, eagerly
        self._version = _VERSION
        self.captures = 0

    def __len__(self):
        return len(self._graphs)

    def __deepcopy__(self, memo):
        # a copy of the model holds other tensors: it captures its own graphs
        return GraphCache()

    def __getstate__(self):
        return {}

    def __setstate__(self, state):
        self.__init__()

    def clear(self):
        """Drop every graph (and its memory pool, once nothing else holds
        it)."""
        self._graphs.clear()
        self._warm.clear()

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self._graphs.values())

    def run(self, key: Hashable, fn: Callable, inputs: Dict[str, torch.Tensor],
            device: torch.device, generators: Sequence[torch.Generator] = ()):
        """``fn(inputs)`` -> its outputs (a tensor, or a tuple, list or dict
        of them).  ``inputs`` hold host or device tensors of the shapes that
        ``key`` stands for.  On a CUDA ``device``: the first call of ``key``
        runs ``fn`` eagerly, the second captures it and replays, later calls
        replay.  ``generators``: the CUDA generators ``fn`` draws from,
        registered with the graph so that each replay draws anew."""
        if self._version != _VERSION:  # a switch moved since these captures
            self.clear()
            self._version = _VERSION
        if device.type != "cuda":
            return fn({k: v.to(device) for k, v in inputs.items()})
        key = (key, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        side, main = _side_stream(device), torch.cuda.current_stream(device)
        if key not in self._warm:  # the warm-up: this call's real work
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = fn({k: v.to(device) for k, v in inputs.items()})
            main.wait_stream(side)
            _tree_map(lambda t: t.record_stream(main), out)
            self._warm.add(key)
            return out
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(fn, inputs, device, side, generators)
        _fill(entry.inputs, inputs)
        entry.graph.replay()
        entry.replays += 1
        for wrapper, n in entry.launches:
            wrapper.launches += n
        return _tree_map(torch.Tensor.clone, entry.outputs)

    def _capture(self, fn, inputs, device, stream, generators):
        """A graph of ``fn`` on new static buffers shaped as ``inputs``;
        the launch counts the capture added are taken back and kept as a
        replay's.  Unlike ``torch.cuda.graph``, no ``synchronize``,
        ``gc.collect`` and ``empty_cache`` first (a short fit's capture
        time): the collector is held off instead, so that nothing it frees
        runs a CUDA call inside the capture."""
        static = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                  for k, v in inputs.items()}
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        counters = launch_counters()
        before = [w.launches for w in counters]
        collecting = gc.isenabled()
        gc.disable()
        try:
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="global")
                try:
                    outputs = fn(static)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is invalid already: fn's error is the one to raise
                    raise
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        launches = []
        for w, n in zip(counters, before):
            if w.launches != n:
                launches.append((w, w.launches - n))
            w.launches = n
        self.captures += 1
        return _Graph(graph, static, outputs, tuple(launches), tuple(generators))


def _fill(static: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor]) -> None:
    """Copy ``inputs`` into the static buffers, in stream order: a host
    tensor through pinned memory, whose block the caching host allocator
    keeps until the copy has run."""
    for k, dst in static.items():
        src = inputs[k]
        if src.device.type == "cpu" and not src.is_pinned():
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)
