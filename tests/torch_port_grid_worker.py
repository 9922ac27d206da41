"""One rank of the port's rank-grid tests, and the configurations they share.

    python tests/torch_port_grid_worker.py <suite> <dir>

runs every case of ``suite`` ("parallel": the sharded lookups and the
shard-local lazy update; "engine": the train steps, ``fit``,
``fit_stream``, the ``Scorer`` and the checkpoints; "families": the train
steps of the attention, sequence and zoo families and the JAX package's
flax files loaded into row-sharded models) as one rank of a gloo world on
the CPU, reading ``<dir>/inputs.npz`` and writing
``<dir>/<suite>_w<world>_r<rank>.npz``.  The rank joins through
``parallel.distributed.initialize`` from the ``XDEEPFM_*`` variables, as
:func:`spawn` sets them.  ``tests/test_torch_port_parallel.py`` and
``tests/test_torch_port_distributed.py`` and
``tests/test_torch_port_grid_families.py`` spawn the worlds once per file and
hold the results against the JAX package.  The module imports numpy only at
its top, so the tests import it for the configurations; a rank imports the
port and never ``jax``.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the world sizes: make_mesh gives them (data 2, embed 2) and (1, 2) grids
WORLDS = (4, 2)

# ------------------------------------------------------------ the lookups

LOOKUP_ROWS, LOOKUP_DIM = 64, 8
LAZY_ROWS, LAZY_DIM, LAZY_N, LAZY_LR, LAZY_L2 = 64, 8, 48, 0.01, 1e-3


def lookup_inputs():
    """The tables, ids and loss weights of the lookup cases
    (``tests/test_sharding.py:26-222``): uniform ids, duplicate-heavy ids
    (vocab 10), all ids on the last shard (skew)."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(LOOKUP_ROWS, LOOKUP_DIM)).astype(np.float32)
    return {
        "table": table,
        "ids_uniform": rng.integers(0, LOOKUP_ROWS, size=(16, 5)).astype(np.int32),
        "ids_dup": rng.integers(0, 10, size=(16, 5)).astype(np.int32),
        "ids_skew": rng.integers(LOOKUP_ROWS - 8, LOOKUP_ROWS, size=(16, 3)).astype(np.int32),
        "w_uniform": rng.normal(size=(16, 5, LOOKUP_DIM)).astype(np.float32),
        "w_dup": rng.normal(size=(16, 5, LOOKUP_DIM)).astype(np.float32),
        "w_skew": rng.normal(size=(16, 3, LOOKUP_DIM)).astype(np.float32),
    }


# lookup case -> (mode, ids key, comm dtype)
LOOKUP_CASES = {
    "psum_uniform": ("shard_map", "uniform", None),
    "psum_dup": ("shard_map", "dup", None),
    "a2a_uniform": ("all_to_all", "uniform", None),
    "a2a_dup": ("all_to_all", "dup", None),
    "a2a_skew": ("all_to_all", "skew", None),
    "a2a_bf16": ("all_to_all", "dup", "bfloat16"),
}


def lazy_inputs():
    """A table, its Adam state and a global occurrence stream (duplicates
    and rows of both shards) for ``sharded_lazy_row_update``."""
    rng = np.random.default_rng(1)
    return {
        "table": rng.normal(size=(LAZY_ROWS, LAZY_DIM)).astype(np.float32),
        "m": (0.1 * rng.normal(size=(LAZY_ROWS, LAZY_DIM))).astype(np.float32),
        "v": (0.01 * rng.uniform(size=(LAZY_ROWS, LAZY_DIM))).astype(np.float32),
        "ids": rng.integers(0, LAZY_ROWS // 2 + 5, size=LAZY_N).astype(np.int32),
        "g": rng.normal(size=(LAZY_N, LAZY_DIM)).astype(np.float32),
    }


LAZY_CASES = ("flat", "packed", "bf16")

# --------------------------------------------------------------- the models


def model_data(name):
    """(x, y) numpy of a model case, the JAX mesh tests' shapes
    (``tests/test_sharding.py:63-76``, :332-525)."""
    if name == "dien":  # test_sharding.py:378-431
        rng = np.random.default_rng(7)
        n, vocab, maxlen = 16, 16, 4
        lengths = rng.integers(1, maxlen + 1, n)
        seq_mask = np.arange(maxlen)[None, :] < lengths[:, None]
        x = {"user": rng.integers(0, vocab, n).astype(np.int64),
             "item": rng.integers(0, vocab, n).astype(np.int64),
             "score": rng.uniform(0, 1, n).astype(np.float32),
             "hist_item": (rng.integers(1, vocab, (n, maxlen)) * seq_mask).astype(np.int64),
             "neg_hist_item": (rng.integers(1, vocab, (n, maxlen)) * seq_mask).astype(np.int64),
             "seq_length": lengths.astype(np.int64)}
        return x, rng.integers(0, 2, n).astype(np.float32)
    if name == "din":
        rng = np.random.default_rng(0)
        n, vocab, maxlen = 16, 16, 4
        x = {"user": rng.integers(0, vocab, n), "item": rng.integers(0, vocab, n),
             "score": rng.uniform(0, 1, n).astype(np.float32)}
        lengths = rng.integers(1, maxlen + 1, n)
        hist = np.zeros((n, maxlen), np.int64)
        for i in range(n):
            hist[i, : lengths[i]] = rng.integers(1, vocab, lengths[i])
        x["hist_item"], x["seq_length"] = hist, lengths.astype(np.int64)
        return x, (x["item"] % 2).astype(np.float32)
    # test_sharding.py draws V1's rows from seed 5 (:332), the zoo's
    # (V2, ONN, MLR, FiBiNET; AutoInt beside them) from seed 9 (:434)
    rng = np.random.default_rng({"xdeepfm": 3, "pro": 6, "mmoe": 9, "v1": 5}.get(name, 9))
    n = 64 if name == "xdeepfm" else 16
    x = {f"C{i}": rng.integers(0, 16, n) for i in range(4)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(2)})
    y = (x["C0"] % 2).astype(np.float32)
    if name == "mmoe":
        y2 = (y * (np.random.default_rng(13).uniform(size=n) < 0.7)).astype(np.float32)
        y = np.stack([y, y2], axis=1)
    return x, y


def model_columns(ns, name):
    F = ns.features
    if name == "dien":
        def hist(n):
            return F.VarLenSparseFeat(F.SparseFeat(n, 16, embedding_dim=8, embedding_name="item"),
                                      maxlen=4, length_name="seq_length")

        return [F.SparseFeat("user", 16, embedding_dim=8),
                F.SparseFeat("item", 16, embedding_dim=8), F.DenseFeat("score", 1),
                hist("hist_item"), hist("neg_hist_item")]
    if name == "din":
        return [F.SparseFeat("user", 16, embedding_dim=8), F.SparseFeat("item", 16, embedding_dim=8),
                F.DenseFeat("score", 1),
                F.VarLenSparseFeat(F.SparseFeat("hist_item", 16, embedding_dim=8,
                                                embedding_name="item"),
                                   maxlen=4, length_name="seq_length")]
    return ([F.SparseFeat(f"C{i}", 16, embedding_dim=8) for i in range(4)]
            + [F.DenseFeat(f"I{i}") for i in range(2)])


def build_model(ns, name, **kw):
    """The model of a case from ``ns`` (``features``, ``models``, ``pro``:
    the JAX package's modules or the port's); ``kw`` reaches the
    constructor (the port's ``device``)."""
    cols = model_columns(ns, name)
    if name == "xdeepfm":
        return ns.models.xDeepFM(cols, cols, dnn_hidden_units=(8,), cin_layer_size=(4, 4),
                                 seed=11, **kw)
    if name == "pro":  # dropout off for step parity; the remat'd CE
        return ns.pro.xDeepFMPro(cols, cols, dnn_hidden_units=(8,), cin_layer_size=(4, 4),
                                 sfg_hidden_units=(8, 4), sfg_dropout=0.0, sfg_fused_ce=True,
                                 seed=11, **kw)
    if name == "din":
        return ns.models.DIN(cols, ["item"], dnn_hidden_units=(8,), att_hidden_size=(8,), **kw)
    if name == "mmoe":
        return ns.models.MMOE(cols, num_experts=2, expert_dnn_hidden_units=(8,),
                              gate_dnn_hidden_units=(4,), tower_dnn_hidden_units=(4,), **kw)
    # the families of tests/test_sharding.py:332-500, and AutoInt (2 layers
    # of 2 heads: the lane attention)
    M = ns.models
    if name == "v1":
        return M.xDeepFMAttention(cols, cols, dnn_hidden_units=(8,), cin_layer_size=(4, 4),
                                  cin_num_heads=2, seed=11, **kw)
    if name == "v2":
        return M.xDeepFMAttentionV2(cols, cols, dnn_hidden_units=(8,), cin_layer_size=(4, 4),
                                    cin_num_heads=2, cin_num_attn_layers=2, seed=11, **kw)
    if name == "dien":
        return M.DIEN(cols, ["item"], gru_type="AUGRU", use_negsampling=True,
                      dnn_hidden_units=(8,), seed=11, **kw)
    if name == "autoint":
        return M.AutoInt(cols, cols, att_layer_num=2, att_head_num=2, dnn_hidden_units=(8,),
                         seed=11, **kw)
    if name == "onn":
        return M.ONN(cols, cols, dnn_hidden_units=(8,), **kw)
    if name == "mlr":
        return M.MLR(cols, region_num=3, **kw)
    if name == "fibinet":
        return M.FiBiNET(cols, cols, dnn_hidden_units=(8,), **kw)
    raise KeyError(name)


def model_loss(name):
    return ["binary_crossentropy", "binary_crossentropy"] if name == "mmoe" else \
        "binary_crossentropy"


LAZY_SPLIT = dict(embedding_optimizer="lazy", embedding_gradient="split")

# train case -> (model, optimizer, compile kwargs, embedding mode, steps,
# worlds).  The lazy cases take 2 steps so that the row moments carry
# (test_sharding.py:570); SGD shows a gradient's scale, which Adam's
# normalisation hides (a mean over the ranks in place of the sum).
TRAIN_CASES = {
    "xdeepfm_shard_map": ("xdeepfm", "adam", {}, "shard_map", 1, (4, 2)),
    "xdeepfm_all_to_all": ("xdeepfm", "adam", {}, "all_to_all", 1, (4, 2)),
    "xdeepfm_gspmd": ("xdeepfm", "adam", {}, "gspmd", 1, (4,)),
    "sgd_shard_map": ("xdeepfm", "sgd", {}, "shard_map", 1, (4,)),
    "sgd_all_to_all": ("xdeepfm", "sgd", {}, "all_to_all", 1, (4,)),
    "lazy_packed_shard_map": ("xdeepfm", "adam", LAZY_SPLIT, "shard_map", 2, (4, 2)),
    "lazy_packed_all_to_all": ("xdeepfm", "adam", LAZY_SPLIT, "all_to_all", 2, (4,)),
    "lazy_flat_shard_map": ("xdeepfm", "adam", dict(LAZY_SPLIT, embedding_layout="flat"),
                            "shard_map", 2, (4,)),
    "lazy_bf16_shard_map": ("xdeepfm", "adam",
                            dict(LAZY_SPLIT, embedding_state_dtype="bfloat16"), "shard_map", 2,
                            (4,)),
    # "auto" resolves to the dense cotangent on more than one rank
    "lazy_dense_all_to_all": ("xdeepfm", "adam", dict(embedding_optimizer="lazy"),
                              "all_to_all", 2, (4,)),
    "pro_all_to_all": ("pro", "adam", {}, "all_to_all", 1, (4,)),
    "din_shard_map": ("din", "adam", {}, "shard_map", 1, (4,)),
    "mmoe_shard_map": ("mmoe", "adam", {}, "shard_map", 1, (4,)),
}

# the families on the (data 2, embed 2) grid: case -> (model, embedding
# mode), one Adam step each as test_sharding.py:502-527 steps them; DIEN's aux
# loss and V2's stacked blocks also under the all-to-all lookup.  The
# attention models also take one SGD step at lr FAMILY_SGD_LR, whose step
# p - lr * g carries each gradient to fp32 precision (FAMILY_SGD_CASES)
FAMILY_CASES = {
    "v1_shard_map": ("v1", "shard_map"),
    "v2_shard_map": ("v2", "shard_map"),
    "v2_all_to_all": ("v2", "all_to_all"),
    "dien_shard_map": ("dien", "shard_map"),
    "dien_all_to_all": ("dien", "all_to_all"),
    "autoint_shard_map": ("autoint", "shard_map"),
    "onn_shard_map": ("onn", "shard_map"),
    "mlr_shard_map": ("mlr", "shard_map"),
    "fibinet_shard_map": ("fibinet", "shard_map"),
}
FAMILY_WORLD = 4
FAMILY_SGD_CASES = ("v1_shard_map", "v2_shard_map", "v2_all_to_all")
FAMILY_SGD_LR = 100.0
# the JAX package's files into row-sharded models: a V2 save_weights file (the
# initial weights of case "v2_shard_map") and a lazy (split, packed) xDeepFM
# save_checkpoint, written by the test
FLAX_WEIGHTS, FLAX_CHECKPOINT = "v2.weights", "xdeepfm_lazy.ckpt"

# fit / fit_stream / Scorer / checkpoints: the port's one-process runs are the
# yardstick, so these need no JAX model
FIT_ROWS, FIT = 300, dict(batch_size=64, epochs=2, verbose=1, validation_split=0.2,
                          shuffle=True)
FIT_METRICS = ["binary_crossentropy", "auc"]


def fit_data():
    rng = np.random.default_rng(5)
    x = {f"C{i}": rng.integers(0, 16, FIT_ROWS) for i in range(4)}
    x.update({f"I{i}": rng.uniform(0, 1, FIT_ROWS).astype(np.float32) for i in range(2)})
    y = (rng.uniform(size=FIT_ROWS) < 0.3).astype(np.float32)
    return x, y


# ---------------------------------------------------------------- spawning


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(suite, out_dir, worlds=WORLDS, timeout=240):
    """Run every world of ``suite`` at once, each rank a process joined
    through the ``XDEEPFM_*`` variables; returns {world: [rank's results]}
    once all have written theirs, and raises with a failed rank's output."""
    procs = []
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_NUM_CPU_DEVICES")}
    env.update(PYTHONPATH=os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")])),
               OMP_NUM_THREADS="1")
    for world in worlds:
        coordinator = f"localhost:{_free_port()}"
        for rank in range(world):
            e = dict(env, XDEEPFM_NUM_PROCESSES=str(world), XDEEPFM_COORDINATOR=coordinator,
                     XDEEPFM_PROCESS_ID=str(rank))
            procs.append((world, rank, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), suite, str(out_dir)], env=e,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    deadline, outs = time.time() + timeout, {}
    try:
        for world, rank, p in procs:
            outs[world, rank] = p.communicate(timeout=max(1.0, deadline - time.time()))[0]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
    for world, rank, p in procs:
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {world} failed:\n{outs[world, rank][-6000:]}")
    return {world: [dict(np.load(os.path.join(out_dir, f"{suite}_w{world}_r{rank}.npz")))
                    for rank in range(world)] for world in worlds}


# ------------------------------------------------------------------- a rank


def _run_parallel(mesh, torch, out):
    """The lookups (values and table gradients, gathered) and the lazy row
    update (the table after one step, gathered)."""
    from xdeepfm_tpu_torch.optimizers import (
        LAZY_OPTIMIZERS, LAZY_ROW_MATH, encode_state)
    from xdeepfm_tpu_torch.parallel import shard_batch, shard_params
    from xdeepfm_tpu_torch.parallel.mesh import all_gather_rows, batch_axis, shard_rows
    from xdeepfm_tpu_torch.parallel.sharded_embedding import (
        maybe_sharded_take, set_embedding_mode, sharded_lazy_row_update, sharded_lookup,
        sharded_lookup_a2a)

    # shard_params on a canonical tree, shard_batch under both lookups
    inp = lookup_inputs()
    tree = {"embedding_dict": {"table_d8": inp["table"], "table_d3": inp["table"][:63, :3]},
            "dnn": {"linear_0": {"kernel": inp["w_uniform"][0]}}}
    for path, t in _flatten(shard_params(tree, mesh)):
        out[f"shard_params/{path}"] = t.numpy()
    for mode in ("shard_map", "all_to_all"):
        set_embedding_mode(mode, mesh)
        out[f"shard_batch/{mode}"] = shard_batch({"ids": inp["ids_uniform"]}, mesh)["ids"].numpy()
    for case, (mode, key, comm) in LOOKUP_CASES.items():
        set_embedding_mode(mode, mesh, comm_dtype=comm)
        ax = mesh.axis(batch_axis())
        ids, w = inp[f"ids_{key}"], inp[f"w_{key}"]
        b = ids.shape[0] // ax.size
        ids_l = torch.as_tensor(ids[ax.index * b : (ax.index + 1) * b])
        w_l = torch.as_tensor(w[ax.index * b : (ax.index + 1) * b])
        shard = shard_rows(torch.as_tensor(inp["table"]), mesh).clone().requires_grad_()
        fn = sharded_lookup if mode == "shard_map" else sharded_lookup_a2a
        vals = fn(shard, ids_l, mesh)
        (w_l * vals.square()).sum().backward()
        out[f"{case}/vals"] = all_gather_rows(vals.detach(), mesh, batch_axis()).numpy()
        out[f"{case}/dispatch"] = all_gather_rows(
            maybe_sharded_take(shard.detach(), ids_l), mesh, batch_axis()).numpy()
        out[f"{case}/grad"] = all_gather_rows(shard.grad, mesh, "embed").numpy()
    set_embedding_mode("gspmd", None)

    lz = lazy_inputs()
    world, rank = mesh.size, mesh.rank
    n = LAZY_N // world  # this rank's block of the stream, in rank order
    ids = torch.as_tensor(lz["ids"][rank * n : (rank + 1) * n])
    g = torch.as_tensor(lz["g"][rank * n : (rank + 1) * n])
    full = {k: torch.as_tensor(lz[k]) for k in ("table", "m", "v")}
    for case in LAZY_CASES:
        table, m, v = (shard_rows(full[k], mesh).clone() for k in ("table", "m", "v"))
        if case == "flat":
            state = torch.cat([m, v], 1)
            sharded_lazy_row_update(table, state, ids, g, 1, LAZY_OPTIMIZERS["adam"][1], mesh,
                                    lr=LAZY_LR, l2=LAZY_L2)
            out["lazy_flat/state"] = all_gather_rows(state, mesh, "embed").numpy()
        else:
            dt = "bfloat16" if case == "bf16" else "float32"
            table = torch.cat([table, encode_state(torch.cat([m, v], 1), dt)], 1)
            sharded_lazy_row_update(table, None, ids, g, 1, None, mesh, lr=LAZY_LR, l2=LAZY_L2,
                                    packed_dim=LAZY_DIM, row_math=LAZY_ROW_MATH["adam"][0],
                                    state_mult=2, state_dtype=dt)
        out[f"lazy_{case}/table"] = all_gather_rows(table, mesh, "embed").numpy()


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        yield from _flatten(v, path) if isinstance(v, dict) else [(path, v)]


def _local_state(model, prefix, out):
    """Every rank's own arrays (replicated parameters, its shards, the lazy
    arrays): the tests hold the replicas bit-equal."""
    for key, p in model.module.named_parameters():
        out[f"{prefix}/local/{key}"] = p.detach().numpy().copy()
    for i, g in enumerate(model._lazy["groups"] if model._lazy else ()):
        out[f"{prefix}/local/lazy_array_{i}"] = g["array"].numpy().copy()


def _on_grid(m, mesh, mode, comm=None):
    from xdeepfm_tpu_torch.parallel import shard_model_state
    from xdeepfm_tpu_torch.parallel.sharded_embedding import set_embedding_mode

    shard_model_state(m, mesh)
    set_embedding_mode(mode, mesh, comm_dtype=comm)
    m._dropout_gen = m._dropout_generator()
    return m


def _off_grid():
    from xdeepfm_tpu_torch.parallel.mesh import set_active_mesh
    from xdeepfm_tpu_torch.parallel.sharded_embedding import set_embedding_mode

    set_embedding_mode("gspmd", None)
    set_active_mesh(None)


def _rank_batch(m, mesh, x, y):
    """This rank's slice of the global batch (x, y, an all-ones mask)."""
    from xdeepfm_tpu_torch.parallel import shard_batch

    packed = m.schema.pack(x)
    yy = y[:, None] if y.ndim == 1 else y
    b = shard_batch(dict(packed, _y=yy, _mask=np.ones(len(yy), np.float32)), mesh)
    return b, b.pop("_y"), b.pop("_mask")


def _weights_of(inputs, case):
    """The canonical tree of a case's initial weights in ``inputs``."""
    from xdeepfm_tpu_torch.weights import unflatten_tree

    flat = {k[len(case) + 1:]: v for k, v in inputs.items() if k.startswith(case + "/")}
    tree = unflatten_tree(flat)
    return {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}


def _params_of(m, prefix, out):
    from xdeepfm_tpu_torch.weights import flatten_tree

    for k, v in flatten_tree(m.get_weights()["params"]):
        out[f"{prefix}/params/{k}"] = v


def _port_model(ns, name, kw, weights=None, optimizer="adam", lr=None):
    m = build_model(ns, name, device="cpu")
    m.compile(optimizer, model_loss(name), metrics=[], lr=lr, **kw)
    if weights is not None:
        m.set_weights(weights)
    return m


def _port_ns():
    import types

    import xdeepfm_tpu_torch.features as F
    import xdeepfm_tpu_torch.models as M
    import xdeepfm_tpu_torch.pro as PRO

    return types.SimpleNamespace(features=F, models=M, pro=PRO)


def _run_engine(mesh, torch, out, out_dir, inputs):
    from xdeepfm_tpu_torch.serving import Scorer

    ns = _port_ns()

    # the train steps
    for case, (name, optimizer, kw, mode, steps, worlds) in TRAIN_CASES.items():
        if mesh.size not in worlds:
            continue
        x, y = model_data(name)
        m = _on_grid(_port_model(ns, name, kw, _weights_of(inputs, case), optimizer), mesh,
                     mode)
        xb, yb, mask = _rank_batch(m, mesh, x, y)
        for _ in range(steps):
            total, _ = m._train_step(xb, yb, mask)
        out[f"{case}/total"] = np.asarray(float(total))
        _params_of(m, case, out)
        _local_state(m, case, out)
        for path, st in m._lazy_state().items():
            out[f"{case}/lazy/{path}"] = st.numpy()
        _off_grid()
    if mesh.size != 4:
        return

    # fit under all_to_all and fit_stream under shard_map against one process
    x, y = fit_data()
    for case, mode in (("fit", "all_to_all"), ("fit_stream", "shard_map")):
        histories = {}
        for grid in (False, True):
            m = build_model(ns, "xdeepfm", device="cpu")
            m.compile("adam", "binary_crossentropy", metrics=FIT_METRICS)
            if grid:
                _on_grid(m, mesh, mode)
            if case == "fit":
                h = m.fit(x, y, **FIT).history
            else:  # the same 240 training rows, the rest for validation
                def stream(epoch, b=64):
                    return [({k: v[i : i + b] for k, v in x.items()}, y[i : i + b])
                            for i in range(0, 240, b)]
                h = m.fit_stream(stream, epochs=2, verbose=1,
                                 validation_data=({k: v[240:] for k, v in x.items()}, y[240:])
                                 ).history
            histories[grid] = h
            if grid and case == "fit":
                # the Scorer and predict on the sharded model against one
                # process's from its gathered weights
                one = build_model(ns, "xdeepfm", device="cpu")
                one.compile("adam", "binary_crossentropy")
                one.set_weights(m.get_weights())
                out["scorer/grid"] = Scorer(m, batch_size=128).warmup().score(x)
                out["scorer/grid_predict"] = m.predict(x, 100)
                _off_grid()
                out["scorer/one"] = Scorer(one, batch_size=128).score(x)
            else:
                _off_grid()
        for grid, h in histories.items():
            for k, v in h.items():
                out[f"{case}/{'grid' if grid else 'one'}/{k}"] = np.asarray(v, np.float64)

    # checkpoints: lazy packed under shard_map, dense Adam under all_to_all
    xs, ys = model_data("xdeepfm")
    for case, kw, mode in (("ckpt_lazy", LAZY_SPLIT, "shard_map"), ("ckpt_dense", {}, "all_to_all")):
        def fresh():
            return _on_grid(_port_model(ns, "xdeepfm", kw), mesh, mode)

        m = fresh()
        xb, yb, mask = _rank_batch(m, mesh, xs, ys)
        m._train_step(xb, yb, mask)
        blocking = os.path.join(out_dir, f"{case}_blocking")
        m.save_checkpoint_sharded(blocking, epoch=1)
        # block=False: the snapshot is this call's, while training goes on
        snap = m.predict(xs, 64)
        m.save_checkpoint_sharded(os.path.join(out_dir, f"{case}_async"), epoch=2, block=False)
        m._train_step(xb, yb, mask)
        m._train_step(xb, yb, mask)
        m.wait_for_checkpoints()
        m2 = fresh()
        out[f"{case}/epoch_blocking"] = np.asarray(m2.load_checkpoint_sharded(blocking))
        m3 = fresh()
        out[f"{case}/epoch_async"] = np.asarray(
            m3.load_checkpoint_sharded(os.path.join(out_dir, f"{case}_async")))
        out[f"{case}/async_snapshot"], out[f"{case}/async_loaded"] = snap, m3.predict(xs, 64)
        # resume: the blocking checkpoint's model and a model taken to the
        # same point by steps, one more step each
        m4 = fresh()
        m4._train_step(xb, yb, mask)
        t2, _ = m2._train_step(xb, yb, mask)
        t4, _ = m4._train_step(xb, yb, mask)
        out[f"{case}/resumed_total"], out[f"{case}/straight_total"] = float(t2), float(t4)
        _params_of(m2, f"{case}/resumed", out)
        _params_of(m4, f"{case}/straight", out)
        # the canonical one-file checkpoint, written by rank 0 from the
        # gathered tree, into a fresh grid model
        npz = os.path.join(out_dir, f"{case}.npz")
        m4.save_checkpoint(npz, epoch=3)
        m5 = fresh()
        out[f"{case}/epoch_npz"] = np.asarray(m5.load_checkpoint(npz))
        _params_of(m4, f"{case}/npz_saved", out)
        _params_of(m5, f"{case}/npz_loaded", out)
        _off_grid()


def _run_families(mesh, torch, out, out_dir, inputs):
    """Each FAMILY_CASES step from the case's weights, then the JAX files
    into row-sharded models: the V2 weights and predict, the lazy
    checkpoint's weights and row states (gathered)."""
    ns = _port_ns()
    for case, (name, mode) in FAMILY_CASES.items():
        x, y = model_data(name)
        for optimizer in ("adam", "sgd") if case in FAMILY_SGD_CASES else ("adam",):
            key = f"{case}/{optimizer}"
            lr = FAMILY_SGD_LR if optimizer == "sgd" else None
            m = _on_grid(_port_model(ns, name, {}, _weights_of(inputs, case), optimizer, lr),
                         mesh, mode)
            xb, yb, mask = _rank_batch(m, mesh, x, y)
            total, _ = m._train_step(xb, yb, mask)
            out[f"{key}/total"] = np.asarray(float(total))
            _params_of(m, key, out)
            _local_state(m, key, out)
            _off_grid()
    m = _on_grid(_port_model(ns, "v2", {}), mesh, "shard_map")
    m.load_weights(os.path.join(out_dir, FLAX_WEIGHTS))
    out["flax_weights/predict"] = m.predict(model_data("v2")[0], 8)
    out["flax_weights/shards"] = np.asarray(sorted(m._shards))
    _off_grid()
    m = _on_grid(_port_model(ns, "xdeepfm", LAZY_SPLIT), mesh, "shard_map")
    out["flax_checkpoint/epoch"] = np.asarray(m.load_checkpoint(
        os.path.join(out_dir, FLAX_CHECKPOINT)))
    _params_of(m, "flax_checkpoint", out)
    for path, st in m._lazy_state().items():
        out[f"flax_checkpoint/lazy/{path}"] = st.numpy()
    out["flax_checkpoint/sharded_groups"] = np.asarray(
        sum(bool(g.get("sharded")) for g in m._lazy["groups"]))
    _off_grid()


def main():
    suite, out_dir = sys.argv[1], sys.argv[2]
    import torch

    torch.set_num_threads(1)
    from xdeepfm_tpu_torch.parallel import make_mesh
    from xdeepfm_tpu_torch.parallel.distributed import initialize

    assert initialize(device="cpu")
    mesh = make_mesh(device="cpu")
    out = {"world": np.asarray(mesh.size), "rank": np.asarray(mesh.rank),
           "coord": np.asarray([mesh.data_index, mesh.embed_index]),
           "shape": np.asarray([mesh.shape["data"], mesh.shape["embed"]])}
    if suite == "parallel":
        _run_parallel(mesh, torch, out)
    else:
        inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        run = _run_engine if suite == "engine" else _run_families
        run(mesh, torch, out, out_dir, inputs)
    np.savez(os.path.join(out_dir, f"{suite}_w{mesh.size}_r{mesh.rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
