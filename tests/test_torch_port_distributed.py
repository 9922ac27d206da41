"""PyTorch port, rank grid: the engine across ranks (``BaseModel`` on
``parallel.shard_model_state``) against the JAX package's mesh step and
against the port's own one-process runs.

The ranks are OS processes in gloo worlds of 4 (data 2, embed 2) and 2
(data 1, embed 2), joined through ``parallel.distributed.initialize`` from
the ``XDEEPFM_*`` variables and spawned once for the file
(``tests/torch_port_grid_worker.py``, suite "engine"), while this process
runs the JAX side: each model's own initial weights go to the port through
``set_weights``, and one or two train steps on ``make_mesh(4)`` /
``make_mesh(2)`` under the same embedding mode are the yardstick, at the JAX
mesh tests' tolerances (``tests/test_sharding.py:79-111``, :505-525): the
total loss ``rtol=1e-5``, the parameters ``rtol=1e-4`` with ``atol=1e-6``
(the flagship and Pro) or ``1e-5`` (DIN, MMOE: a cross-rank sum's ulps
magnified by Adam's normalisation near zero).  ``fit``, ``fit_stream``, the
``Scorer`` and the checkpoints are held against one-process port runs.
"""

import concurrent.futures
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_port_grid_worker as W
import xdeepfm_tpu.features as jf
import xdeepfm_tpu.models as jmodels
import xdeepfm_tpu.pro as jpro
import xdeepfm_tpu_torch.features as tf
import xdeepfm_tpu_torch.models as tmodels
from xdeepfm_tpu.parallel import make_mesh, shard_batch, shard_model_state
from xdeepfm_tpu.parallel.mesh import set_active_mesh
from xdeepfm_tpu.parallel.sharded_embedding import set_embedding_mode
from xdeepfm_tpu_torch.parallel.distributed import global_batch_from_host_local, initialize
from xdeepfm_tpu_torch.weights import flatten_tree

JNS = types.SimpleNamespace(features=jf, models=jmodels, pro=jpro)
ZOO_ATOL = {"din": 1e-5, "mmoe": 1e-5}


def _jax_model(case):
    name, optimizer, kw, *_ = W.TRAIN_CASES[case]
    m = W.build_model(JNS, name)
    m.compile(optimizer, W.model_loss(name), metrics=[], **kw)
    return m


def _jax_mesh_steps(m, case, world):
    """The case's steps of the JAX model ``m`` on the mesh of ``world``
    devices: (total, flat canonical params, lazy row states)."""
    name, _, _, mode, steps, _ = W.TRAIN_CASES[case]
    x, y = W.model_data(name)
    y = y[:, None] if y.ndim == 1 else y
    mesh = make_mesh(world)
    try:
        with mesh:
            shard_model_state(m, mesh)
            if mode != "gspmd":
                set_embedding_mode(mode, mesh)
            xb = shard_batch(m.schema.pack(x), mesh)
            yb = jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("data", None)))
            mask = jax.device_put(jnp.ones((len(y),), jnp.float32), NamedSharding(mesh, P("data")))
            p, bs, o = m.params, m.batch_stats, m.opt_state
            for s in range(steps):
                p, bs, o, total, _, _ = m._train_step(p, bs, o, xb, yb, mask, s)
            m.params, m.batch_stats, m.opt_state = p, bs, o
            params = {k: np.asarray(v) for k, v in flatten_tree(m.get_weights()["params"])}
            opt = m._canonical_opt_state()
            lazy = ({k: np.asarray(v) for k, v in opt["lazy"].items()}
                    if isinstance(opt, dict) and "lazy" in opt else {})
    finally:
        set_embedding_mode("gspmd", None)
        set_active_mesh(None)
    return float(total), params, lazy


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """(port results {world: [rank results]}, JAX results {(case, world):
    (total, params, lazy)}): the worlds run while the JAX side computes."""
    out_dir = tmp_path_factory.mktemp("grid_engine")
    inputs, models = {}, {}
    for case in W.TRAIN_CASES:
        models[case] = _jax_model(case)
        for k, v in flatten_tree(models[case].get_weights()):
            inputs[f"{case}/{k}"] = np.asarray(v)
    np.savez(out_dir / "inputs.npz", **inputs)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(W.spawn, "engine", out_dir, timeout=300)
        want = {}
        for case, (*_, worlds) in W.TRAIN_CASES.items():
            for i, world in enumerate(worlds):  # a fresh model (the same seed) for each mesh
                want[case, world] = _jax_mesh_steps(models[case] if i == 0 else _jax_model(case),
                                                    case, world)
        return ranks.result(), want


TRAIN_PARAMS = [(case, world) for case, (*_, worlds) in W.TRAIN_CASES.items()
                for world in worlds]


@pytest.mark.parametrize("case,world", TRAIN_PARAMS)
def test_train_step_matches_jax_mesh(grid, case, world):
    ranks, want = grid
    name = W.TRAIN_CASES[case][0]
    total, params, lazy = want[case, world]
    atol = ZOO_ATOL.get(name, 1e-6)
    for r in ranks[world]:
        np.testing.assert_allclose(float(r[f"{case}/total"]), total, rtol=1e-5)
        got = {k[len(case) + 8:]: v for k, v in r.items() if k.startswith(f"{case}/params/")}
        assert sorted(got) == sorted(params)
        for k in params:
            np.testing.assert_allclose(got[k], params[k], rtol=1e-4, atol=atol, err_msg=k)
        got_lazy = {k[len(case) + 6:]: v for k, v in r.items() if k.startswith(f"{case}/lazy/")}
        assert sorted(got_lazy) == sorted(lazy)
        for k in lazy:  # the row moments (bf16 pairs decoded on both sides)
            np.testing.assert_allclose(got_lazy[k], lazy[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case,world", TRAIN_PARAMS)
def test_replicas_stay_bit_equal(grid, case, world):
    """Every replicated parameter is bit-equal on every rank, and each row
    shard (a table or a lazy [rows, dims + state] array) on its data
    replicas; the shards of one data row differ."""
    ranks = grid[0][world]
    E = 2
    keys = [k for k in ranks[0] if k.startswith(f"{case}/local/")]
    assert keys
    sharded = 0
    for k in keys:
        same_e = [r[k] for r in ranks if int(r["rank"]) % E == 0]
        for r in ranks:
            if r[k].shape == ranks[0][k].shape and np.array_equal(r[k], ranks[0][k]):
                continue
            sharded += 1
            replicas = [q[k] for q in ranks if int(q["rank"]) % E == int(r["rank"]) % E]
            for q in replicas:
                np.testing.assert_array_equal(q, replicas[0], err_msg=k)
        for q in same_e:
            np.testing.assert_array_equal(q, same_e[0], err_msg=k)
    assert sharded > 0  # the tables did shard


def test_fit_history_matches_one_process(grid):
    """``fit`` under ``all_to_all`` (each rank 16 rows of each global batch
    of 64, the tail padded) against a one-process ``fit`` from the same
    weights and seed: the History at Adam's ``rtol=1e-4``
    (``tests/test_torch_port_train.py``)."""
    _assert_histories(grid, "fit")


def test_fit_stream_history_matches_one_process(grid):
    """``fit_stream`` under ``shard_map`` (``tests/test_stream.py:222``)."""
    _assert_histories(grid, "fit_stream")


def _assert_histories(grid, case):
    for r in grid[0][4]:
        one = {k.split("/")[-1]: v for k, v in r.items() if k.startswith(f"{case}/one/")}
        got = {k.split("/")[-1]: v for k, v in r.items() if k.startswith(f"{case}/grid/")}
        assert sorted(got) == sorted(one) == sorted(
            ["loss", "val_binary_crossentropy", "val_auc"] + W.FIT_METRICS)
        for k in one:
            np.testing.assert_allclose(got[k], one[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_scorer_on_sharded_model(grid):
    """``Scorer`` and ``predict`` on the sharded model against the
    one-process scorer from its gathered weights
    (``tests/test_serving.py:115-135``: ``rtol=1e-5, atol=1e-7``)."""
    for r in grid[0][4]:
        np.testing.assert_allclose(r["scorer/grid"], r["scorer/one"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r["scorer/grid_predict"], r["scorer/one"], rtol=1e-5,
                                   atol=1e-7)
        assert r["scorer/grid"].shape == (W.FIT_ROWS, 1)


@pytest.mark.parametrize("case", ["ckpt_lazy", "ckpt_dense"])
def test_sharded_checkpoints_resume(grid, case):
    """``save_checkpoint_sharded`` / ``load_checkpoint_sharded``
    (``tests/test_checkpoint.py:95-213``): the blocking checkpoint resumes
    to the step of a model that never stopped; ``block=False`` keeps the
    snapshot of its call while two more steps run; the canonical
    ``save_checkpoint`` of a grid model loads into a fresh grid model."""
    for r in grid[0][4]:
        assert int(r[f"{case}/epoch_blocking"]) == 1 and int(r[f"{case}/epoch_async"]) == 2
        assert int(r[f"{case}/epoch_npz"]) == 3
        np.testing.assert_array_equal(r[f"{case}/async_loaded"], r[f"{case}/async_snapshot"])
        np.testing.assert_allclose(float(r[f"{case}/resumed_total"]),
                                   float(r[f"{case}/straight_total"]), rtol=1e-6)
        for a, b in (("resumed", "straight"), ("npz_loaded", "npz_saved")):
            keys = [k for k in r if k.startswith(f"{case}/{a}/params/")]
            assert keys
            for k in keys:
                np.testing.assert_array_equal(r[k], r[k.replace(f"/{a}/", f"/{b}/")], err_msg=k)


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    """``initialize`` reads ``XDEEPFM_NUM_PROCESSES`` (the ranks above joined
    through ``XDEEPFM_COORDINATOR`` / ``XDEEPFM_PROCESS_ID``) and does
    nothing for one process (``tests/test_distributed.py``)."""
    for var in ("XDEEPFM_NUM_PROCESSES", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False
    monkeypatch.setenv("XDEEPFM_NUM_PROCESSES", "1")
    assert initialize(device="cpu") is False


def test_initialize_needs_a_coordinator(monkeypatch):
    for var in ("XDEEPFM_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        initialize(num_processes=2, process_id=0, device="cpu")


def test_global_batch_from_host_local_keeps_the_rank_slice():
    grid = types.SimpleNamespace(device="cpu")
    local = {"sparse": np.arange(12, dtype=np.int32).reshape(4, 3), "dense": np.ones((4, 2))}
    got = global_batch_from_host_local(local, grid)
    for k, v in local.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_gpus_is_accepted_and_ignored():
    """``gpus=[0, 1]`` builds on the CPU and computes what ``gpus=None``
    computes (the JAX engine ignores it, ``basemodel.py:133-136``)."""
    x, y = W.model_data("xdeepfm")
    cols = W.model_columns(types.SimpleNamespace(features=tf), "xdeepfm")
    preds = []
    for gpus in (None, [0, 1]):
        m = tmodels.xDeepFM(cols, cols, dnn_hidden_units=(8,), cin_layer_size=(4, 4), seed=11,
                            device="cpu", gpus=gpus)
        m.compile("adam", "binary_crossentropy")
        m.fit(x, y, batch_size=32, epochs=1, verbose=0)
        preds.append(m.predict(x, 32))
    np.testing.assert_array_equal(preds[1], preds[0])
