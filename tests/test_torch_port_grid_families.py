"""PyTorch port, rank grid: the mesh families of the JAX package
(``tests/test_sharding.py:332-527``) on the port's (data 2, embed 2) grid of
4 gloo ranks, against the JAX ``_train_step`` on ``make_mesh(4)`` in this
process: xDeepFMAttention (V1, the fused block ``ab_fwd`` / ``ab_bwd`` per
rank on the rank's rows, where the JAX mesh gates its Pallas block off),
xDeepFMAttentionV2, DIEN (AUGRU, negative sampling; the aux loss's count
summed over the ranks), AutoInt (the lane attention), ONN, MLR and FiBiNET,
one Adam step each as ``test_sharding.py`` steps them, V2 and DIEN under
both lookups; V1 and V2 also take one SGD step at lr 100, whose step
p - 100 g carries every gradient to fp32 precision.  The tolerances are
``test_sharding.py``'s for these layouts: the total ``rtol=1e-5``, the
parameters ``rtol=1e-4`` with ``atol=1e-5``; under SGD at lr 100 ``atol=1e-4``,
the gradients within 1e-6 (``test_torch_port_distributed.py``'s SGD cases,
``atol=1e-6`` at lr 0.01, hold them within 1e-4).

Adam's first step moves an entry by lr * g / (|g| + eps), so an entry whose
gradient is a few eps (1e-8) takes any step up to lr, and fp32 noise in g
decides it: the attention pooling's ``fc1`` entries of V1 and V2, whose
gradients nearly cancel (one of them, -3.7e-8 in float64, has the port's
sign in fp32 and the opposite one on the JAX mesh).  In those cases an
entry past the tolerance is held (at most MAX_HELD a step, each within
2 lr) only where each side's Adam step is its own first Adam step of its
own gradient (read off its SGD step) within the tolerance: the difference
is the gradients', which the SGD case holds to 1e-6.  The other cases
hold none.

The same world loads the JAX package's flax files into row-sharded models:
a V2 ``save_weights`` file (predict against the JAX model's) and a lazy
split packed ``save_checkpoint`` (the gathered weights and row states
against the file's).  The ranks run in their own spawn
(``tests/torch_port_grid_worker.py``, suite "families") while this process
runs the JAX side.
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
from xdeepfm_tpu.parallel import make_mesh, shard_batch, shard_model_state
from xdeepfm_tpu.parallel.mesh import set_active_mesh
from xdeepfm_tpu.parallel.sharded_embedding import set_embedding_mode
from xdeepfm_tpu_torch.weights import flatten_tree

JNS = types.SimpleNamespace(features=jf, models=jmodels, pro=jpro)
LAZY = dict(embedding_optimizer="lazy", embedding_gradient="split")
ADAM_LR, ADAM_EPS = 1e-3, 1e-8  # Adam's defaults on both sides
MAX_HELD = 32


def _jax_model(name, optimizer="adam", **compile_kw):
    m = W.build_model(JNS, name)
    lr = W.FAMILY_SGD_LR if optimizer == "sgd" else None
    m.compile(optimizer, W.model_loss(name), metrics=[], lr=lr, **compile_kw)
    return m


def _jax_mesh_step(m, name, mode):
    """One step of the JAX model ``m`` on ``make_mesh(4)`` under ``mode``:
    (total, flat canonical params)."""
    x, y = W.model_data(name)
    mesh = make_mesh(W.FAMILY_WORLD)
    try:
        with mesh:
            shard_model_state(m, mesh)
            set_embedding_mode(mode, mesh)
            xb = shard_batch(m.schema.pack(x), mesh)
            yb = jax.device_put(jnp.asarray(y[:, None]), NamedSharding(mesh, P("data", None)))
            mask = jax.device_put(jnp.ones((len(y),), jnp.float32), NamedSharding(mesh, P("data")))
            p, bs, o, total, _, _ = m._train_step(m.params, m.batch_stats, m.opt_state, xb, yb,
                                                  mask, 0)
            m.params, m.batch_stats, m.opt_state = p, bs, o
            params = {k: np.asarray(v) for k, v in flatten_tree(m.get_weights()["params"])}
    finally:
        set_embedding_mode("gspmd", None)
        set_active_mesh(None)
    return float(total), params


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """(the ranks' results, the JAX steps {(case, optimizer): (total,
    params)}, the initial weights {case: flat params}, the JAX
    V2 model's predictions, the JAX lazy checkpoint's weights and row
    states): the world runs while the JAX side computes."""
    out_dir = tmp_path_factory.mktemp("grid_families")
    inputs, models = {}, {}
    for case, (name, _) in W.FAMILY_CASES.items():
        models[case, "adam"] = _jax_model(name)
        for k, v in flatten_tree(models[case, "adam"].get_weights()):
            inputs[f"{case}/{k}"] = np.asarray(v)
    np.savez(out_dir / "inputs.npz", **inputs)
    v2 = models["v2_shard_map", "adam"]
    v2.save_weights(str(out_dir / W.FLAX_WEIGHTS))
    v2_predict = v2.predict(W.model_data("v2")[0], 8)
    lazy = _jax_model("xdeepfm", **LAZY)
    x, y = W.model_data("xdeepfm")
    lazy.fit(x, y, batch_size=16, epochs=1, verbose=0)
    lazy.save_checkpoint(str(out_dir / W.FLAX_CHECKPOINT), epoch=5)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(W.spawn, "families", out_dir, worlds=(W.FAMILY_WORLD,), timeout=300)
        want = {}
        for case, (name, mode) in W.FAMILY_CASES.items():
            for opt in ("adam", "sgd") if case in W.FAMILY_SGD_CASES else ("adam",):
                # the same seed: the same initial weights
                m = models.pop((case, opt), None) or _jax_model(name, opt)
                want[case, opt] = _jax_mesh_step(m, name, mode)
        files = dict(
            predict=v2_predict,
            params=dict(flatten_tree(lazy.get_weights()["params"])),
            lazy={k: np.asarray(v) for k, v in lazy._canonical_opt_state()["lazy"].items()})
        initial = {case: {k[len(case) + 8:]: v for k, v in inputs.items()
                          if k.startswith(f"{case}/params/")} for case in W.FAMILY_CASES}
        return ranks.result()[W.FAMILY_WORLD], want, initial, files


def _params(r, key):
    return {k[len(key) + 8:]: v for k, v in r.items() if k.startswith(f"{key}/params/")}


@pytest.mark.parametrize("case", W.FAMILY_SGD_CASES)
def test_family_sgd_step_matches_jax_mesh(grid, case):
    ranks, want, _, _ = grid
    total, params = want[case, "sgd"]
    for r in ranks:
        np.testing.assert_allclose(float(r[f"{case}/sgd/total"]), total, rtol=1e-5)
        got = _params(r, f"{case}/sgd")
        assert sorted(got) == sorted(params)
        for k in params:  # p - 100 g: the gradients within 1e-6
            np.testing.assert_allclose(got[k], params[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", list(W.FAMILY_CASES))
def test_family_adam_step_matches_jax_mesh(grid, case):
    ranks, want, initial, _ = grid
    total, params = want[case, "adam"]
    sgd, init = want.get((case, "sgd"), (None, None))[1], initial[case]
    for r in ranks:
        np.testing.assert_allclose(float(r[f"{case}/adam/total"]), total, rtol=1e-5)
        got, got_sgd = _params(r, f"{case}/adam"), _params(r, f"{case}/sgd")
        held_ok = case in W.FAMILY_SGD_CASES
        assert sorted(got) == sorted(params)
        held = 0
        for k in params:
            diff = np.abs(got[k] - params[k])
            off = diff > 1e-5 + 1e-4 * np.abs(params[k])
            if not off.any():
                continue
            assert held_ok, f"{k}: {int(off.sum())} entries off, up to {diff[off].max()}"
            for side, adam, after_sgd in (("port", got[k], got_sgd[k]), ("jax", params[k], sgd[k])):
                g = (init[k] - after_sgd) / W.FAMILY_SGD_LR
                own = init[k] - ADAM_LR * g / (np.abs(g) + ADAM_EPS)
                np.testing.assert_allclose(adam[off], own[off], rtol=1e-4, atol=1e-5,
                                           err_msg=f"{k}: the {side} Adam step")
            assert diff[off].max() <= 2 * ADAM_LR, k
            held += int(off.sum())
        assert held <= MAX_HELD, held


@pytest.mark.parametrize("case", list(W.FAMILY_CASES))
def test_family_replicas_stay_bit_equal(grid, case):
    """Every replicated parameter is bit-equal on every rank, and a row
    shard on its data replicas (the ranks of one embed index)."""
    ranks = grid[0]
    keys = [k for k in ranks[0] if k.startswith(f"{case}/") and "/local/" in k]
    assert keys
    E, sharded = 2, 0
    for k in keys:
        if all(np.array_equal(r[k], ranks[0][k]) for r in ranks):
            continue
        sharded += 1
        for r in ranks:
            np.testing.assert_array_equal(r[k], ranks[int(r["rank"]) % E][k], err_msg=k)
    assert sharded > 0  # the tables did shard


def test_jax_weights_into_row_sharded_model(grid):
    """A JAX V2 ``save_weights`` file into a row-sharded V2: each rank keeps
    its rows and predicts the JAX model's scores (``PRED_TOL``)."""
    ranks, _, _, files = grid
    for r in ranks:
        assert len(r["flax_weights/shards"]) > 0
        np.testing.assert_allclose(r["flax_weights/predict"], files["predict"], rtol=1e-5,
                                   atol=1e-6)


def test_jax_lazy_checkpoint_into_row_sharded_model(grid):
    """A JAX lazy (split, packed) ``save_checkpoint`` into a row-sharded lazy
    model: the epoch, the gathered weights and row states are the file's."""
    ranks, _, _, files = grid
    for r in ranks:
        assert int(r["flax_checkpoint/epoch"]) == 5
        assert int(r["flax_checkpoint/sharded_groups"]) > 0
        for k, v in files["params"].items():
            np.testing.assert_array_equal(r[f"flax_checkpoint/params/{k}"], v, err_msg=k)
        for k, v in files["lazy"].items():
            np.testing.assert_array_equal(r[f"flax_checkpoint/lazy/{k}"], v, err_msg=k)
