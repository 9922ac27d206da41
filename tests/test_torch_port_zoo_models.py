"""PyTorch port, the rest of the single-task zoo: FiBiNET (interaction, all,
each), PNN (inner; outer with each kernel type; both), CCPM, MLR (3 regions;
with bias columns and distinct base columns; regression) and ONN against the
JAX package's models (the layers are in
``tests/test_torch_port_zoo_layers.py``).

The JAX model is compiled and its weights replaced by seeded numpy draws at
scale 0.1 (PNN's and FiBiNET's at 0.5, ``SCALE``); the port receives them
through ``set_weights``, and both run fp32 on the CPU on the same numpy
data.

Tolerances (``tests/test_torch_port_fm_models.py``'s): predictions rtol
1e-5, atol 1e-6; one SGD step's weight changes within 1e-4 of each
parameter's largest change; the ``fit`` and ``fit_stream`` histories rtol
1e-4, atol 1e-6, and the weights after them within 1e-4 (Adam); the lazy
split step's weights within Adam's rtol 1e-4 / atol 2e-5 and its row states
within rtol 1e-3 (``tests/test_torch_port_lazy.py``'s).
"""

import jax
import numpy as np
import pytest
from test_torch_port_lazy import _assert_states_close, _assert_weights_close

import xdeepfm_tpu.features as jf
import xdeepfm_tpu.models as jmodels
import xdeepfm_tpu_torch.features as tf
import xdeepfm_tpu_torch.models as tmodels
from xdeepfm_tpu_torch.serving import Scorer
from xdeepfm_tpu_torch.weights import canonical_paths, flatten_tree

N_SPARSE, VOCAB, DIM, N_DENSE = 5, 30, 4, 2


def _sparse(cols):
    return [f for f in cols if isinstance(f, (jf.SparseFeat, tf.SparseFeat))]


def _both(cols):
    return cols, cols


def _pnn(cols):
    return (cols,)


def _ccpm(cols):
    return cols, _sparse(cols)


def _mlr(cols):
    return (cols,)


def _mlr_bias(cols):
    """Regions over C0-C2 and I0, base columns C3-C4 (read by no one, as in
    the reference), bias columns C1 and I1."""
    sp = _sparse(cols)
    return sp[:3] + [cols[N_SPARSE]], sp[3:], [sp[1], cols[N_SPARSE + 1]]


# name: (class name, positional columns, architecture, loss)
MODELS = {
    "FiBiNET_interaction": ("FiBiNET", _both, dict(dnn_hidden_units=(8, 8))),
    "FiBiNET_all": ("FiBiNET", _both, dict(dnn_hidden_units=(8,), bilinear_type="all")),
    "FiBiNET_each": ("FiBiNET", _both, dict(dnn_hidden_units=(8,), bilinear_type="each",
                                            reduction_ratio=2)),
    "PNN_inner": ("PNN", _pnn, dict(dnn_hidden_units=(8, 8))),
    "PNN_outer_mat": ("PNN", _pnn, dict(dnn_hidden_units=(8,), use_inner=False,
                                        use_outter=True, kernel_type="mat")),
    "PNN_outer_vec": ("PNN", _pnn, dict(dnn_hidden_units=(8,), use_inner=False,
                                        use_outter=True, kernel_type="vec")),
    "PNN_outer_num": ("PNN", _pnn, dict(dnn_hidden_units=(8,), use_inner=False,
                                        use_outter=True, kernel_type="num")),
    "PNN_both": ("PNN", _pnn, dict(dnn_hidden_units=(8,), use_outter=True)),
    "CCPM": ("CCPM", _ccpm, dict(conv_kernel_width=(3, 2), conv_filters=(2, 2),
                                 dnn_hidden_units=(8,))),
    "MLR": ("MLR", _mlr, dict(region_num=3)),
    "MLR_bias": ("MLR", _mlr_bias, dict(region_num=3)),
    "MLR_regression": ("MLR", _mlr, dict(region_num=3, task="regression")),
    "ONN": ("ONN", _both, dict(dnn_hidden_units=(8, 8))),
}
METRICS = ["binary_crossentropy", "auc"]
# weight scales other than 0.1: PNN has no linear term, and at 0.1 its
# scores spread by 2e-4 only; FiBiNET's SENET output is the embeddings
# times weights of ~1e-4 at 0.1, so one SGD step moves its fc weights by
# less than their fp32 spacing
SCALE = {"PNN": 0.5, "FiBiNET": 0.5}
# the regularization arguments each class takes
REG = {
    "FiBiNET": dict(l2_reg_embedding=2e-3, l2_reg_linear=1e-3, l2_reg_dnn=3e-3),
    "PNN": dict(l2_reg_embedding=2e-3, l2_reg_dnn=3e-3),
    "CCPM": dict(l2_reg_embedding=2e-3, l2_reg_linear=1e-3, l2_reg_dnn=3e-3),
    "MLR": dict(l2_reg_linear=1e-3),
    "ONN": dict(l2_reg_embedding=2e-3, l2_reg_linear=1e-3, l2_reg_dnn=3e-3),
}
# a parameter each model must hold under its JAX path
NAMES = {
    "FiBiNET_interaction": ("Bilinear/bilinear_inter", "SE/fc1/kernel", "SE/fc2/kernel"),
    "FiBiNET_all": ("Bilinear/bilinear_all", "dnn_linear/kernel"),
    "FiBiNET_each": ("Bilinear/bilinear_each", "linear_model/weight"),
    "PNN_inner": ("embedding_dict/table_d4", "dnn/linear_1/kernel"),
    "PNN_outer_mat": ("outterproduct/kernel",),
    "PNN_outer_vec": ("outterproduct/kernel",),
    "PNN_outer_num": ("outterproduct/kernel",),
    "PNN_both": ("outterproduct/kernel", "dnn/linear_0/bias"),
    "CCPM": ("conv_layer/conv_1/kernel", "conv_layer/conv_2/bias",
             "linear_model/embedding_dict/table_d1"),
    "MLR": ("region_linear_model/embedding_dict/table_d3", "region_linear_model/weight"),
    "MLR_bias": ("bias_linear/embedding_dict/table_d1", "bias_linear/weight"),
    "MLR_regression": ("region_linear_model/embedding_dict/table_d3",),
    "ONN": ("second_order_emb1_f0", "second_order_emb2_f4", "linear_model/weight"),
}
# the tables a lazy split step trains row by row: the standard ones
LAZY = {
    "FiBiNET": ["embedding_dict/table_d4", "linear_model/embedding_dict/table_d1"],
    "PNN": ["embedding_dict/table_d4"],
    "CCPM": ["embedding_dict/table_d4", "linear_model/embedding_dict/table_d1"],
    "MLR": [],
    "ONN": ["linear_model/embedding_dict/table_d1"],
}


def _cls(name):
    return MODELS[name][0]


def _loss(name):
    return "mse" if "regression" in name else "binary_crossentropy"


def _cols(mod):
    return [mod.SparseFeat(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)] + [
        mod.DenseFeat(f"I{i}") for i in range(N_DENSE)]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
    return x, (rng.uniform(size=n) < 0.4).astype(np.float32)


def _models(name, **kw):
    """(JAX model, port model), uncompiled weights of their own."""
    cls, cols, arch = MODELS[name]
    jm = getattr(jmodels, cls)(*cols(_cols(jf)), **arch, **kw)
    pm = getattr(tmodels, cls)(*cols(_cols(tf)), device="cpu", **arch, **kw)
    return jm, pm


def _pair(name, optimizer="adam", **kw):
    """(JAX model, port model) with the same random weights, compiled."""
    jm, pm = _models(name, **kw)
    loss = _loss(name)
    jm.compile(optimizer, loss, metrics=METRICS)
    rng = np.random.default_rng(1)
    scale = SCALE.get(_cls(name), 0.1)
    w = jm.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (scale * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"])
    jm.set_weights(w)
    pm.set_weights(jm.get_weights())
    pm.compile(optimizer, loss, metrics=METRICS)
    return jm, pm


def _first_batch_delta(model, x, y, n):
    before = {k: v.copy() for k, v in flatten_tree(model.get_weights()["params"])}
    model.fit({k: v[:n] for k, v in x.items()}, y[:n], batch_size=n, epochs=1, verbose=0,
              shuffle=False)
    after = dict(flatten_tree(model.get_weights()["params"]))
    return {k: np.asarray(after[k]) - before[k] for k in before}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_predict_matches_jax(name):
    jm, pm = _pair(name)
    x, _ = _data(150, seed=2)
    got, want = pm.predict(x, 64), jm.predict(x, 64)
    assert got.dtype == np.float64 and got.shape == (150, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert want.std() > 1e-3


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_weights_round_trip(name):
    """The JAX tree loads and comes back bit-exactly, PNN's raw
    ``outterproduct/kernel`` untransposed under its own name among them."""
    jm, pm = _pair(name)
    want = dict(flatten_tree(jm.get_weights()["params"]))
    got = dict(flatten_tree(pm.get_weights()["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in NAMES[name]:
        assert k in got, k
    if "outterproduct/kernel" in want:
        np.testing.assert_array_equal(pm.module.outterproduct.kernel.detach().numpy(),
                                      want["outterproduct/kernel"])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_l2_registry_matches_jax(name):
    jm, pm = _pair(name, **REG[_cls(name)])
    want = {p: jm._reg_coeffs_for(p) for p, _ in flatten_tree(jm.get_weights()["params"])}
    want = {p: c for p, c in want.items() if c != (0.0, 0.0)}
    paths = canonical_paths(pm.module)
    names = {id(p): n for n, p in pm.module.named_parameters()}
    got = {paths[names[id(p)]]: (l1, l2) for p, l1, l2 in pm._regularization_terms()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(pm._regularization_loss().item(),
                               float(jm._regularization_loss(jm.params)), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_one_sgd_step_matches_jax(name):
    """Every parameter but the tables moves, within 1e-4 of its largest
    change from the JAX model's."""
    kw = {k: v for k, v in REG[_cls(name)].items() if k == "l2_reg_dnn"}
    jm, pm = _pair(name, "sgd", **kw)
    x, y = _data(96, seed=3)
    want = _first_batch_delta(jm, x, y, 96)
    got = _first_batch_delta(pm, x, y, 96)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max() + 1e-8, err_msg=k)
    assert all(np.abs(v).max() > 0 for k, v in want.items() if "table_d" not in k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_fit_matches_jax(name):
    jm, pm = _pair(name)
    x, y = _data(300, seed=4)  # 240 train rows: 3 batches of 64 and a tail of 48
    fit = dict(batch_size=64, epochs=2, verbose=0, validation_split=0.2, shuffle=True)
    want = jm.fit(x, y, **fit).history
    got = pm.fit(x, y, **fit).history
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    want_w = dict(flatten_tree(jm.get_weights()["params"]))
    for k, v in flatten_tree(pm.get_weights()["params"]):
        np.testing.assert_allclose(v, np.asarray(want_w[k]), rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["FiBiNET_interaction", "PNN_both", "CCPM", "MLR_bias", "ONN"])
def test_model_fit_stream_matches_jax(name):
    """``fit_stream`` over batches of 64 with a tail of 40, one class each."""
    jm, pm = _pair(name)
    x, y = _data(232, seed=5)

    def stream(epoch):
        for i in range(0, len(y), 64):
            yield {k: v[i:i + 64] for k, v in x.items()}, y[i:i + 64]

    want = jm.fit_stream(stream, epochs=2, verbose=0).history
    got = pm.fit_stream(stream, epochs=2, verbose=0).history
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    want_w = dict(flatten_tree(jm.get_weights()["params"]))
    for k, v in flatten_tree(pm.get_weights()["params"]):
        np.testing.assert_allclose(v, np.asarray(want_w[k]), rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_lazy_split_step_matches_jax(name):
    """``compile(embedding_optimizer="lazy")`` with the split gradient:
    only the standard tables are lazy (the main ``embedding_dict`` and the
    linear model's), as in both engines; ONN's pair tables and MLR's region
    and bias tables train densely.  One step: the loss, the weights and the
    row states."""
    jm, pm = _pair(name)
    for m in (jm, pm):
        m.compile("adam", _loss(name), metrics=["binary_crossentropy"],
                  embedding_optimizer="lazy", embedding_gradient="split")
    lazy = sorted(m["path"] for m in pm._lazy_members())
    assert lazy == LAZY[_cls(name)] == sorted(jm._lazy_tables)
    x, y = _data(96, seed=6)
    want = jm.fit(x, y, batch_size=96, epochs=1, verbose=0, shuffle=False).history
    got = pm.fit(x, y, batch_size=96, epochs=1, verbose=0, shuffle=False).history
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _assert_weights_close(pm, jm)
    if lazy:
        _assert_states_close(pm, jm)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_scorer_matches_jax(name):
    """``Scorer(batch_size=64)`` over 150 rows (a padded tail) against the
    JAX model's ``predict``."""
    jm, pm = _pair(name)
    x, _ = _data(150, seed=7)
    got = Scorer(pm, batch_size=64).warmup().score(x)
    assert got.dtype == np.float64 and got.shape == (150, 1)
    np.testing.assert_allclose(got, jm.predict(x, 64), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cls,cols,kw,exc,match", [
    ("PNN", _pnn, dict(kernel_type="matrix"), ValueError, "kernel_type must be mat,vec or num"),
    ("CCPM", _ccpm, dict(conv_kernel_width=(6, 5), conv_filters=(4,)), ValueError,
     "conv_kernel_width must have same element with conv_filters"),
    ("CCPM", _both, {}, ValueError, "DenseFeat is not supported in dnn_feature_columns"),
    ("MLR", _mlr, dict(region_num=1), ValueError, "region_num must > 1"),
    ("FiBiNET", _both, dict(bilinear_type="pairwise"), NotImplementedError, None),
])
def test_model_constructor_errors_match_jax(cls, cols, kw, exc, match):
    with pytest.raises(exc, match=match):
        getattr(jmodels, cls)(*cols(_cols(jf)), **kw)
    with pytest.raises(exc, match=match):
        getattr(tmodels, cls)(*cols(_cols(tf)), device="cpu", **kw)


def test_compute_input_dim_matches_jax():
    """``BaseModel.compute_input_dim`` as the JAX engine's, every flag."""
    jm, pm = _models("CCPM")
    jc, tc = _cols(jf), _cols(tf)
    for flags in [dict(), dict(include_dense=False, feature_group=True),
                  dict(include_sparse=False), dict(feature_group=True)]:
        assert pm.compute_input_dim(tc, **flags) == jm.compute_input_dim(jc, **flags), flags
