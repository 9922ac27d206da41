"""PyTorch port, AutoInt / DIFM slice: the models AutoInt (its three
branches: attention + DNN, DNN only, attention only) and DIFM, at the
shapes of ``tests/test_model_zoo.py:39,49``, against the JAX package's
(the lane attention and the layers are in ``tests/test_torch_port_autoint.py``).

The JAX model is compiled and its weights replaced by seeded numpy draws at
scale 0.1; the port receives them through ``set_weights``, and both run fp32
on the CPU on the same numpy data.  The JAX lane kernel runs in interpret
mode (the ``interpret`` fixture), so the JAX ``InteractingLayer`` takes its
Pallas route; the port on a CPU tensor takes the lane route's plain versions.

Tolerances: predictions rtol 1e-5, atol 1e-6; one SGD step's weight changes
within 1e-4 of each parameter's largest change; the ``fit`` histories rtol
1e-4, atol 1e-6, and the weights after it within 1e-4 (adam; as
``tests/test_torch_port_attention_models.py``).
"""

import jax
import numpy as np
import pytest
from test_torch_port_autoint import N_SPARSE, _assert_launches_zero, _cols, _data, interpret  # noqa: F401

import xdeepfm_tpu.features as jf
import xdeepfm_tpu_torch.features as tf
from xdeepfm_tpu.models import DIFM as JaxDIFM
from xdeepfm_tpu.models import AutoInt as JaxAutoInt
from xdeepfm_tpu_torch.models import DIFM, AutoInt
from xdeepfm_tpu_torch.weights import canonical_paths, flatten_tree

MODELS = {
    # tests/test_model_zoo.py:39 and :49, and AutoInt's other two branches
    "autoint": (JaxAutoInt, AutoInt, dict(att_layer_num=2, dnn_hidden_units=(8, 8))),
    "autoint_dnn_only": (JaxAutoInt, AutoInt, dict(att_layer_num=0, dnn_hidden_units=(8, 8))),
    "autoint_att_only": (JaxAutoInt, AutoInt, dict(att_layer_num=2, dnn_hidden_units=())),
    "difm": (JaxDIFM, DIFM, dict(att_head_num=2, dnn_hidden_units=(8, 8))),
}
METRICS = ["binary_crossentropy", "auc"]


def _pair(name, optimizer="adam", **kw):
    """(JAX model, port model) with the same random weights (scale 0.1)."""
    jcls, tcls, arch = MODELS[name]
    jm = jcls(_cols(jf), _cols(jf), **arch, **kw)
    jm.compile(optimizer, "binary_crossentropy", metrics=METRICS)
    rng = np.random.default_rng(1)
    w = jm.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"])
    jm.set_weights(w)
    pm = tcls(_cols(tf), _cols(tf), device="cpu", **arch, **kw)
    pm.set_weights(jm.get_weights())
    pm.compile(optimizer, "binary_crossentropy", metrics=METRICS)
    return jm, pm


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_predict_matches_jax(interpret, name):
    jm, pm = _pair(name)
    assert pm.module._fused  # one gather through the main and linear tables
    x, _ = _data(150, seed=2)
    got, want = pm.predict(x, 64), jm.predict(x, 64)
    assert got.dtype == np.float64 and got.shape == (150, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert want.std() > 1e-3
    _assert_launches_zero()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_weights_round_trip(name):
    jm, pm = _pair(name)
    want = dict(flatten_tree(jm.get_weights()["params"]))
    got = dict(flatten_tree(pm.get_weights()["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    names = {"autoint": ("int_layer_1/W_Res", "dnn/linear_1/kernel", "dnn_linear/kernel"),
             "autoint_dnn_only": ("dnn/linear_0/kernel", "dnn_linear/kernel"),
             "autoint_att_only": ("int_layer_0/W_Query", "dnn_linear/kernel"),
             "difm": ("vector_wise_net/W_Key", "bit_wise_net/linear_0/kernel",
                      "transform_matrix_P_vec/kernel", "transform_matrix_P_bit/kernel")}[name]
    for k in names:
        assert k in got, k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_l2_registry_matches_jax(name):
    reg = dict(l2_reg_embedding=2e-3, l2_reg_dnn=3e-3)
    if name == "difm":
        reg["l2_reg_linear"] = 1e-3
    jm, pm = _pair(name, **reg)
    want = {p: jm._reg_coeffs_for(p) for p, _ in flatten_tree(jm.get_weights()["params"])}
    want = {p: c for p, c in want.items() if c != (0.0, 0.0)}
    paths = canonical_paths(pm.module)
    names = {id(p): n for n, p in pm.module.named_parameters()}
    got = {paths[names[id(p)]]: (l1, l2) for p, l1, l2 in pm._regularization_terms()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    if name == "difm":
        assert "vector_wise_net/W_Query" in got and "transform_matrix_P_bit/kernel" in got
    np.testing.assert_allclose(pm._regularization_loss().item(),
                               float(jm._regularization_loss(jm.params)), rtol=1e-5)


def _first_batch_delta(model, x, y, n):
    before = {k: v.copy() for k, v in flatten_tree(model.get_weights()["params"])}
    model.fit({k: v[:n] for k, v in x.items()}, y[:n], batch_size=n, epochs=1, verbose=0,
              shuffle=False)
    after = dict(flatten_tree(model.get_weights()["params"]))
    return {k: np.asarray(after[k]) - before[k] for k in before}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_one_sgd_step_matches_jax(interpret, name):
    """One SGD step from the same weights: the weight changes are lr times
    the gradients, each within 1e-4 of its largest change."""
    jm, pm = _pair(name, "sgd", l2_reg_dnn=1e-3)
    x, y = _data(96, seed=3)
    want = _first_batch_delta(jm, x, y, 96)
    got = _first_batch_delta(pm, x, y, 96)
    assert sorted(got) == sorted(want)
    if name != "autoint_dnn_only":
        assert any("/W_" in k and np.abs(want[k]).max() > 0 for k in want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max() + 1e-8, err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_fit_matches_jax(interpret, name):
    jm, pm = _pair(name)
    x, y = _data(300, seed=4)  # 240 train rows: 3 batches of 64 and a tail of 48
    fit = dict(batch_size=64, epochs=2, verbose=0, validation_split=0.2, shuffle=True)
    want = jm.fit(x, y, **fit).history
    got = pm.fit(x, y, **fit).history
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    # adam divides by the root of the second moment: a weight whose gradients
    # are near 0 (an embedding row met once) turns rounding noise into up to
    # lr-sized moves, hence atol 1e-4 on the weights
    want_w = dict(flatten_tree(jm.get_weights()["params"]))
    for k, v in flatten_tree(pm.get_weights()["params"]):
        np.testing.assert_allclose(v, np.asarray(want_w[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    _assert_launches_zero()


def test_model_constructor_errors_match_jax():
    with pytest.raises(ValueError, match="att_layer_num"):
        AutoInt(_cols(tf), _cols(tf), att_layer_num=0, dnn_hidden_units=(), device="cpu")
    with pytest.raises(ValueError, match="dnn_hidden_units is null"):
        DIFM(_cols(tf), _cols(tf), dnn_hidden_units=(), device="cpu")
    # the forward's own check (difm.py:69-70), reached with no sparse column
    m = DIFM(_cols(tf), _cols(tf), att_head_num=2, device="cpu")
    m.module.dnn_cols, m.module._fused = tuple(_cols(tf)[N_SPARSE:]), False
    with pytest.raises(ValueError, match="no sparse features"):
        m.predict(_data(4)[0], 4)
