"""Misc utilities (port of ``xdeepfm_tpu/utils.py``; reference
``deepctr/utils.py``).

``check_version`` is a deliberate no-op, as in the JAX package: the
reference's PyPI version-check thread is not reproduced.
"""

from __future__ import annotations

import torch


def check_version(version: str) -> None:
    """API-compatible no-op (the reference's PyPI check thread is not
    reproduced by design)."""
    return None


def concat_fun(inputs, axis=-1):
    """Reference ``layers/utils.py:12-18``."""
    if len(inputs) == 1:
        return inputs[0]
    return torch.cat(inputs, dim=axis)


def slice_arrays(arrays, start=None, stop=None):
    """Keras-style array slicing (reference ``layers/utils.py:21-70``)."""
    if arrays is None:
        return [None]
    if isinstance(arrays, list):
        if hasattr(start, "__len__"):
            if hasattr(start, "shape"):
                start = start.tolist()
            return [None if x is None else x[start] for x in arrays]
        return [None if x is None else x[start:stop] for x in arrays]
    if hasattr(start, "__len__"):
        if hasattr(start, "shape"):
            start = start.tolist()
        return arrays[start]
    if hasattr(start, "__getitem__"):
        return arrays[start:stop]
    return [None]
