"""Production-scale embedding tables on one GPU (the JAX package's
``examples/large_tables.py`` on the port).

Demonstrates the lazy row-sparse optimizer with the lookup-boundary
gradient split and the packed param|state layout: only rows touched by each
batch are read or written, one gather and one row write per table group per
step, so table size stops mattering to step time.  At 2.5M rows a field and
above the optimizer's row state is kept in bf16 (half its bytes; the math
stays fp32).

Run small by default; pass a vocab-per-field to scale up:

    python -m xdeepfm_tpu_torch.examples.large_tables            # 26 x 40k rows (toy)
    python -m xdeepfm_tpu_torch.examples.large_tables 4000000    # 26 x 4M = 104M rows
    python -m xdeepfm_tpu_torch.examples.large_tables --device cpu
"""

import argparse
import os
import tempfile

import numpy as np

from ..features import DenseFeat, SparseFeat
from ..models import xDeepFM

BATCH, EPOCH_BATCHES = 4096, 8


def build_model(vocab, device="cuda"):
    cols = [
        SparseFeat(f"C{i}", vocab, embedding_dim=10) for i in range(26)
    ] + [DenseFeat(f"I{i}", 1) for i in range(13)]
    model = xDeepFM(cols, cols, dnn_hidden_units=(256, 256),
                    cin_layer_size=(256, 128), seed=1024, device=device)
    model.compile(
        "adam",
        "binary_crossentropy",
        metrics=["auc"],
        embedding_optimizer="lazy",        # touched-row updates only
        embedding_gradient="split",        # no full-table cotangent, ever
        # embedding_layout="auto" (default) -> packed [rows, dims + state]
        # param|state arrays: one gather + one row write per step.
        # At the capacity edge, halve the moment bytes (math stays fp32):
        embedding_state_dtype="bfloat16" if vocab >= 2_500_000 else "float32",
    )
    return model


def main(vocab=40_000, batch=BATCH, epoch_batches=EPOCH_BATCHES, device="cuda",
         checkpoint=None, verbose=1):
    """Two epochs, a checkpoint and one batch predicted; returns the model,
    the History's logs, the checkpoint's path and the predictions."""
    model = build_model(vocab, device)
    rng = np.random.default_rng(0)
    n = batch * epoch_batches
    x = {f"C{i}": rng.integers(0, vocab, n) for i in range(26)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32)
              for i in range(13)})
    y = (rng.uniform(size=n) < 0.25).astype(np.float32)

    history = model.fit(x, y, batch_size=batch, epochs=2, verbose=verbose, shuffle=False)

    # checkpoints are always written in the canonical flat format, whatever
    # the live layout: they reload into any embedding_layout setting
    path = checkpoint or os.path.join(tempfile.gettempdir(), "large_tables_ckpt.bin")
    model.save_checkpoint(path, epoch=2)
    pred = model.predict({k: v[:batch] for k, v in x.items()}, batch)
    print("predictions:", pred.shape)
    return {"model": model, "history": history.history, "checkpoint": path,
            "predictions": pred}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("vocab", nargs="?", type=int, default=40_000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.vocab, device=args.device)
