"""Quickstart: train xDeepFM on a synthetic Criteo-shaped task (the JAX
package's ``examples/quickstart.py`` on the port: the same widths, data
draws, compile arguments and ``fit``).

    python -m xdeepfm_tpu_torch.examples.quickstart                # on the GPU
    python -m xdeepfm_tpu_torch.examples.quickstart --device cpu   # on the CPU
"""

import argparse

import numpy as np

from ..features import DenseFeat, SparseFeat
from ..models import xDeepFM


def main(n=20000, vocab=1000, epochs=3, device="cuda", verbose=2):
    """Train, evaluate and predict; returns the History's logs, the
    evaluation and the predictions."""
    rng = np.random.default_rng(0)

    # feature columns: 26 categorical + 13 dense, like Criteo
    cols = [
        SparseFeat(f"C{i}", vocabulary_size=vocab, embedding_dim=10)
        for i in range(1, 27)
    ] + [DenseFeat(f"I{i}", 1) for i in range(1, 14)]

    # synthetic data with real signal
    x = {f"C{i}": rng.integers(0, vocab, n) for i in range(1, 27)}
    x.update(
        {f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(1, 14)}
    )
    logit = (x["C1"] % 7 < 3) * 1.5 + x["I1"] * 2 - 2
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)

    model = xDeepFM(
        cols, cols, cin_layer_size=(256, 128), dnn_hidden_units=(256, 256),
        dnn_dropout=0.1, device=device,
    )
    model.compile(
        "adam", "binary_crossentropy",
        metrics=["binary_crossentropy", "auc"], lr=1e-3,
    )
    history = model.fit(
        x, y, batch_size=1024, epochs=epochs, verbose=verbose, validation_split=0.1,
        steps_per_dispatch=4,
    )
    evaluation = model.evaluate(x, y, batch_size=4096)
    print("eval:", evaluation)
    pred = model.predict(x, batch_size=4096)
    print("predictions:", pred[:5].ravel())
    return {"history": history.history, "eval": evaluation, "predictions": pred}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
