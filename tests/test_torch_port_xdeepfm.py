"""PyTorch port: xDeepFM predict / evaluate / Scorer against the JAX package.

The JAX model is compiled and its weights replaced (``set_weights``) by
seeded numpy draws at scale 0.1, so every tower moves the output; the port
receives them through ``from_jax_weights``.  Both sides are fp32 on the CPU.
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

import xdeepfm_tpu.features as jf
import xdeepfm_tpu.metrics as jm
import xdeepfm_tpu_torch.features as tf
import xdeepfm_tpu_torch.metrics as tm
from xdeepfm_tpu.models import xDeepFM as JaxXDeepFM
from xdeepfm_tpu.ops import cin_pallas as cp
from xdeepfm_tpu.ops.cin import set_cin_backend
from xdeepfm_tpu.serving import Scorer as JaxScorer
from xdeepfm_tpu_torch.models import xDeepFM
from xdeepfm_tpu_torch.ops.cin_cuda import cin_rows_forward
from xdeepfm_tpu_torch.serving import Scorer, load_scorer
from xdeepfm_tpu_torch.weights import flatten_tree, from_jax_weights, to_jax_weights

N_SPARSE, VOCAB, DIM, N_DENSE = 4, 50, 8, 2
ARCH = dict(dnn_hidden_units=(16, 16), cin_layer_size=(8, 6))
METRICS = ["binary_crossentropy", "auc"]
PRED_TOL = dict(rtol=1e-5, atol=1e-6)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _cols(mod):
    return [mod.SparseFeat(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)] + [
        mod.DenseFeat(f"I{i}") for i in range(N_DENSE)
    ]


def _linear_subset(cols):
    """Linear columns that differ from the DNN's: no shared gather."""
    return cols[:2] + cols[N_SPARSE:]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
    y = (rng.uniform(size=n) < 0.3).astype(np.float32)
    return x, y


def _jax_model(linear=None):
    cols = _cols(jf)
    m = JaxXDeepFM(cols if linear is None else linear(cols), cols, **ARCH)
    m.compile("adam", "binary_crossentropy", metrics=METRICS)
    rng = np.random.default_rng(1)
    w = m.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32),
        w["params"],
    )
    m.set_weights(w)
    return m


def _port_model(jax_model=None, linear=None, seed=1024):
    cols = _cols(tf)
    m = xDeepFM(cols if linear is None else linear(cols), cols, device="cpu",
                seed=seed, **ARCH)
    m.compile("adam", "binary_crossentropy", metrics=METRICS)
    if jax_model is not None:
        m.module.load_state_dict(from_jax_weights(jax_model.get_weights()))
    return m


@pytest.fixture(scope="module")
def pair():
    j = _jax_model()
    return j, _port_model(j)


def test_weights_round_trip_exact(pair):
    j, p = pair
    want = dict(flatten_tree(j.get_weights()["params"]))
    got = dict(flatten_tree(to_jax_weights(p.module)["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert to_jax_weights(p.module)["batch_stats"] == {}


def test_predict_matches_jax(pair):
    j, p = pair
    x, _ = _data(300)  # 3 batches of 128, the last one padded
    got, want = p.predict(x, 128), j.predict(x, 128)
    assert got.dtype == np.float64 and got.shape == (300, 1)
    np.testing.assert_allclose(got, want, **PRED_TOL)


def test_predict_matches_jax_pallas_cin():
    j = _jax_model()
    p = _port_model(j)
    x, _ = _data(300, seed=2)
    set_cin_backend("pallas")
    cp.set_interpret(True)
    try:
        want = j.predict(x, 128)
    finally:
        cp.set_interpret(False)
        set_cin_backend("auto")
    np.testing.assert_allclose(p.predict(x, 128), want, **PRED_TOL)


def test_predict_matches_jax_with_distinct_linear_columns():
    j = _jax_model(linear=_linear_subset)
    p = _port_model(j, linear=_linear_subset)
    assert not p.module._fused  # the separate-gather path
    x, _ = _data(200, seed=3)
    np.testing.assert_allclose(p.predict(x, 128), j.predict(x, 128), **PRED_TOL)


def test_scorer_matches_jax(pair):
    j, p = pair
    x, _ = _data(150, seed=4)  # 64 + 64 + a padded 22
    got = Scorer(p, batch_size=64).warmup().score(x)
    want = JaxScorer(j, batch_size=64).warmup().score(x)
    assert got.dtype == np.float64 and got.shape == (150, 1)
    np.testing.assert_allclose(got, want, **PRED_TOL)
    empty = {k: v[:0] for k, v in x.items()}
    out = Scorer(p, batch_size=64).score(empty)
    assert out.shape == (0, 1) and out.dtype == np.float64
    assert JaxScorer(j, batch_size=64).score(empty).shape == (0, 1)


def test_evaluate_matches_jax(pair):
    j, p = pair
    x, y = _data(300, seed=5)
    got, want = p.evaluate(x, y, 128), j.evaluate(x, y, 128)
    assert sorted(got) == sorted(want) == sorted(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_save_load_weights_round_trip(pair, tmp_path):
    _, p = pair
    path = tmp_path / "weights.npz"
    p.save_weights(path)
    q = _port_model(seed=7)  # other random weights until loaded
    x, _ = _data(100, seed=6)
    assert not np.array_equal(q.predict(x, 64), p.predict(x, 64))
    q.load_weights(path)
    for (ka, a), (kb, b) in zip(
        flatten_tree(q.get_weights()["params"]), flatten_tree(p.get_weights()["params"])
    ):
        assert ka == kb
        np.testing.assert_array_equal(a, b, err_msg=ka)
    np.testing.assert_array_equal(q.predict(x, 64), p.predict(x, 64))


def test_load_scorer_round_trip(pair, tmp_path):
    _, p = pair
    path = tmp_path / "weights.npz"
    p.save_weights(path)
    x, _ = _data(90, seed=8)
    scorer, preprocess = load_scorer(lambda: _port_model(seed=9), path, batch_size=64)
    assert preprocess is None
    np.testing.assert_array_equal(scorer.score(x), p.predict(x, 64))
    with pytest.raises(NotImplementedError):
        load_scorer(lambda: _port_model(seed=9), path, preprocess_path="preprocess.pkl")


def test_model_without_device_raises_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xDeepFM(_cols(tf), _cols(tf), **ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xDeepFM(_cols(tf), _cols(tf), device="cuda", **ARCH)


def test_cpu_model_never_launches_the_kernel(pair):
    _, p = pair
    p.predict(_data(50)[0], 32)
    assert cin_rows_forward.launches == 0


def test_pack_matches_jax():
    x, _ = _data(20, seed=10)
    got = tf.FeatureSchema.build(_cols(tf)).pack(x)
    want = jf.FeatureSchema.build(_cols(jf)).pack(x)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", sorted(jm.HOST_METRICS))
def test_host_metrics_match_jax(name):
    rng = np.random.default_rng(11)
    y = (rng.uniform(size=500) < 0.3).astype(np.float32)
    p = np.round(rng.uniform(size=500), 2)  # ties exercise the AUC's ranks
    assert sorted(tm.HOST_METRICS) == sorted(jm.HOST_METRICS)
    assert tm.HOST_METRICS[name](y, p) == jm.HOST_METRICS[name](y, p)


def _port_sources():
    return sorted((REPO / "xdeepfm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_nothing_of_jax():
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "xdeepfm_tpu"}
    sources = _port_sources()
    assert len(sources) > 10
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"
