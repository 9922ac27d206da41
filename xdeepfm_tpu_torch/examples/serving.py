"""Standalone serving: train, persist weights, rebuild a scorer WITHOUT the
training data, and score new traffic (the JAX package's
``examples/serving.py`` on the port).

The reference's inference story is ``model.predict`` inside the training
process plus persisted preprocessors + weights (``xdftrain.py:454-495``);
here it ships as ``serving.Scorer`` / ``load_scorer``: a fixed-batch
scorer (pad + slice) over the model's predict step, whose CIN runs in the
hand-written kernel on the GPU.

    python -m xdeepfm_tpu_torch.examples.serving [--device cpu]
"""

import argparse
import functools
import os
import tempfile

import numpy as np

from ..features import DenseFeat, SparseFeat
from ..models import xDeepFM
from ..serving import load_scorer

VOCAB = 1000


def build_model(device="cuda"):
    """The serving side rebuilds the model from config alone (the CLIs
    record theirs in training_log.json)."""
    cols = [
        SparseFeat(f"C{i}", vocabulary_size=VOCAB, embedding_dim=8)
        for i in range(8)
    ] + [DenseFeat(f"I{i}", 1) for i in range(4)]
    model = xDeepFM(
        cols, cols, cin_layer_size=(32, 16), dnn_hidden_units=(64, 32), device=device
    )
    model.compile("adam", "binary_crossentropy", metrics=["auc"])
    return model


def make_traffic(n, seed):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(8)}
    x.update(
        {f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(4)}
    )
    logit = (x["C0"] % 5 < 2) * 1.2 + x["I0"] * 1.5 - 1.5
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return x, y


def main(n_train=20000, n_traffic=10000, epochs=2, device="cuda", out_dir=None, verbose=2):
    """Returns the scorer's and ``predict``'s scores of the traffic, their
    largest difference and the weights file."""
    # --- training process -------------------------------------------------
    x, y = make_traffic(n_train, seed=0)
    model = build_model(device)
    model.fit(x, y, batch_size=1024, epochs=epochs, verbose=verbose)
    weights = os.path.join(out_dir or tempfile.mkdtemp(), "xdeepfm.weights.npz")
    model.save_weights(weights)
    print("saved", weights)

    # --- serving process (no training data in sight) ----------------------
    scorer, _ = load_scorer(functools.partial(build_model, device), weights, batch_size=4096)
    traffic, labels = make_traffic(n_traffic, seed=7)
    preds = scorer.score(traffic)
    # sanity: the scorer reproduces the training process's predict exactly
    ref = model.predict(traffic, batch_size=4096)
    diff = float(np.abs(preds - ref).max())
    print("serving preds", preds[:5].ravel())
    print("max |serving - train predict| =", diff)
    return {"scores": preds, "predict": ref, "max_abs_diff": diff, "weights": weights}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
