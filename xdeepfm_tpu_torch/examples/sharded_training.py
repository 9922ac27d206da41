"""Multi-GPU training on a (data, embed) rank grid (the JAX package's
``examples/sharded_training.py`` on the port).

One process per rank: batches split over the ``data`` axis (the gradient
is summed over it), embedding tables row-shard over ``embed``.  The public
``fit`` / ``predict`` surface is unchanged: sharding the model state is one
call.  Alone it runs a one-rank grid; under ``torchrun`` each process is a
rank on its own GPU (``LOCAL_RANK``), every rank with the same data:

    python -m xdeepfm_tpu_torch.examples.sharded_training [--device cpu]
    torchrun --nproc_per_node 4 -m xdeepfm_tpu_torch.examples.sharded_training
"""

import argparse
import os
import tempfile

import numpy as np
import torch.distributed as dist

from ..features import DenseFeat, SparseFeat
from ..models import xDeepFM
from ..parallel import make_mesh, shard_model_state
from ..parallel.distributed import initialize
from ..parallel.mesh import set_active_mesh

VOCAB = 10000


def main(n=32768, vocab=VOCAB, epochs=2, device=None, checkpoint=None, verbose=2):
    """Returns the model, the History's logs, the predictions and the
    sharded checkpoint's directory."""
    if device is None:  # this rank's GPU
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    initialize(device=device)
    n_ranks = dist.get_world_size() if dist.is_initialized() else 1
    print(f"{n_ranks} rank(s):", device)

    rng = np.random.default_rng(0)
    x = {f"C{i}": rng.integers(0, vocab, n) for i in range(26)}
    x.update(
        {f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(13)}
    )
    logit = (x["C1"] % 7 < 3) * 1.5 + x["I1"] * 2 - 2
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)

    cols = [
        SparseFeat(f"C{i}", vocab, embedding_dim=10) for i in range(26)
    ] + [DenseFeat(f"I{i}", 1) for i in range(13)]
    model = xDeepFM(
        cols, cols, cin_layer_size=(256, 128), dnn_hidden_units=(256, 256), device=device
    )
    # row-sharded tables want the sharded-friendly optimizer defaults; for
    # >=30M-row tables add embedding_optimizer='lazy' (the row state
    # shards with the rows: parallel/sharded_embedding.py)
    model.compile("adam", "binary_crossentropy", metrics=["auc"])

    mesh = make_mesh(n_ranks, device=device)  # (data, embed) axes over every rank
    print("mesh:", dict(mesh.shape))
    path = checkpoint or os.path.join(tempfile.gettempdir(), "sharded_ckpt")
    try:
        shard_model_state(model, mesh)  # tables row-sharded over 'embed'
        history = model.fit(
            x, y, batch_size=4096, epochs=epochs, verbose=verbose, validation_split=0.1,
        )
        pred = model.predict(x, batch_size=4096)
        # sharded-native checkpoint: each rank writes its own table shards
        # (no gather); block=False would let further steps overlap the write
        model.save_checkpoint_sharded(path, epoch=epochs)
        print("predictions:", pred[:5].ravel())
    finally:
        set_active_mesh(None)
    return {"model": model, "history": history.history, "predictions": pred,
            "checkpoint": path, "ranks": n_ranks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="this rank's device (default: cuda:LOCAL_RANK)")
    main(device=parser.parse_args().device)
    if dist.is_initialized():
        dist.destroy_process_group()
