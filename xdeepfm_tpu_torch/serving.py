"""Serving / scoring path (port of ``xdeepfm_tpu/serving.py``).

* :class:`Scorer` — fixed-batch scoring over a model (pad + slice, float64
  outputs like ``predict``),
* :func:`load_scorer` — rebuild a scorer from the CLIs' artifacts of either
  package: the port's ``.npz`` weights or the JAX package's flax msgpack
  ones (a JAX CLI's ``{model}_best.weights``), and a ``preprocess.pkl``.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np
import torch


class Scorer:
    """Fixed-batch scorer over a BaseModel.  Reads the model's weights live
    at every call, so weights loaded after construction are used."""

    def __init__(self, model, batch_size: int = 8192):
        self.model = model
        self.batch_size = batch_size

    def warmup(self):
        """Score one all-zero batch: builds the CUDA kernels on first use."""
        self.model._predict_step(self.model._dummy_batch(self.batch_size))
        return self

    def score(self, x: Dict[str, np.ndarray]) -> np.ndarray:
        batch = self.model._pack_x(x)
        n = len(next(iter(batch.values()), np.zeros((0,))))
        if n == 0:
            return np.zeros((0, 1), dtype="float64")
        out = []
        for start in range(0, n, self.batch_size):
            stop = min(start + self.batch_size, n)
            xb = {k: v[start:stop] for k, v in batch.items()}
            bs = stop - start
            if bs < self.batch_size:
                xb = {
                    k: np.concatenate(
                        [v, np.repeat(v[-1:], self.batch_size - bs, axis=0)]
                    )
                    for k, v in xb.items()
                }
            out.append(self.model._predict_step(xb)[:bs])
        return torch.cat(out).cpu().numpy().astype("float64")


class PreprocessUnpickler(pickle.Unpickler):
    """Reads a CLI's ``preprocess.pkl`` written by either package: classes of
    the JAX package's ``data`` and ``features`` modules load as the port's
    copies (the same names and attributes), so reading a JAX-written file
    imports neither JAX nor ``xdeepfm_tpu``.  Any other module of the JAX
    package is refused.  The pandas route's payload holds ``SafeLabelEncoder``s
    built on ``pd.Index`` and needs pandas; the native route's holds only
    the scaler's arrays and lists."""

    MODULES = {"xdeepfm_tpu.data": "xdeepfm_tpu_torch.data",
               "xdeepfm_tpu.features": "xdeepfm_tpu_torch.features"}

    def find_class(self, module, name):
        module = self.MODULES.get(module, module)
        if module == "xdeepfm_tpu" or module.startswith("xdeepfm_tpu."):
            raise pickle.UnpicklingError(f"preprocess.pkl refers to {module}.{name}")
        return super().find_class(module, name)


def load_preprocess(path: str):
    """The dict of a CLI's ``preprocess.pkl`` (see :class:`PreprocessUnpickler`)."""
    with open(path, "rb") as f:
        return PreprocessUnpickler(f).load()


def load_scorer(
    build_model,
    weights_path: str,
    preprocess_path: Optional[str] = None,
    batch_size: int = 8192,
):
    """Rebuild a scorer from persisted artifacts.

    ``build_model()`` -> a BaseModel with the right feature columns (the
    CLI's ``training_log.json`` records the config); its weights come from
    ``weights_path`` through ``load_weights``: the port's ``save_weights``
    ``.npz``, or a file that the JAX package wrote (``save_weights``, a
    checkpoint's weights; a model trained by the JAX CLI on the TPU, served
    here).  Returns (scorer, preprocess dict | None).
    """
    model = build_model()
    model.load_weights(weights_path)
    preprocess = load_preprocess(preprocess_path) if preprocess_path else None
    return Scorer(model, batch_size=batch_size).warmup(), preprocess
