"""PyTorch port, FM-family slice: the models DeepFM, WDL, NFM, AFM (with
and without attention), IFM, DCN (vector and matrix) and DCNMix, the nine
builders of ``tests/test_model_zoo.py:26-48`` at dropout 0, against the JAX
package's (the layers are in ``tests/test_torch_port_fm_layers.py``).

The JAX model is compiled and its weights replaced by seeded numpy draws at
scale 0.1; the port receives them through ``set_weights``, and both run fp32
on the CPU on the same numpy data.  WDL and DCN also run on mixed embedding
dims, where ``fast_inputs`` falls back to each feature's own lookup.

Tolerances: predictions rtol 1e-5, atol 1e-6; one SGD step's weight changes
within 1e-4 of each parameter's largest change; the ``fit`` histories rtol
1e-4, atol 1e-6, and the weights after it within 1e-4 (Adam; as
``tests/test_torch_port_autoint_models.py``).
"""

import jax
import numpy as np
import pytest
import torch

import xdeepfm_tpu.features as jf
import xdeepfm_tpu.models as jmodels
import xdeepfm_tpu_torch.features as tf
import xdeepfm_tpu_torch.models as tmodels
from xdeepfm_tpu_torch.embeddings import MixedEmbeddingDims
from xdeepfm_tpu_torch.weights import canonical_paths, flatten_tree

N_SPARSE, VOCAB, DIM, N_DENSE = 5, 30, 4, 2


def _sparse_only(cols):
    return [f for f in cols if not isinstance(f, (jf.DenseFeat, tf.DenseFeat))]


# name: (class name, dnn columns, architecture) as tests/test_model_zoo.py:26-48
# builds them, bi_dropout 0
MODELS = {
    "DeepFM": ("DeepFM", None, dict(dnn_hidden_units=(8, 8))),
    "WDL": ("WDL", None, dict(dnn_hidden_units=(8, 8))),
    "NFM": ("NFM", None, dict(dnn_hidden_units=(8, 8))),
    "AFM_att": ("AFM", _sparse_only, dict(use_attention=True, attention_factor=4)),
    "AFM_plain": ("AFM", _sparse_only, dict(use_attention=False)),
    "DCN_vec": ("DCN", None, dict(cross_num=2, dnn_hidden_units=(8, 8))),
    "DCN_mat": ("DCN", None, dict(cross_num=2, cross_parameterization="matrix",
                                  dnn_hidden_units=(8,))),
    "DCNMix": ("DCNMix", None, dict(cross_num=2, dnn_hidden_units=(8,), low_rank=4,
                                    num_experts=2)),
    "IFM": ("IFM", None, dict(dnn_hidden_units=(8, 8))),
}
METRICS = ["binary_crossentropy", "auc"]
# the regularization arguments each class takes
REG = {
    "DeepFM": dict(l2_reg_linear=1e-3, l2_reg_dnn=3e-3),
    "WDL": dict(l2_reg_linear=1e-3, l2_reg_dnn=3e-3),
    "NFM": dict(l2_reg_linear=1e-3, l2_reg_dnn=3e-3),
    "AFM": dict(l2_reg_linear=1e-3, l2_reg_att=4e-3),
    "IFM": dict(l2_reg_linear=1e-3, l2_reg_dnn=3e-3),
    "DCN": dict(l2_reg_linear=1e-3, l2_reg_dnn=3e-3, l2_reg_cross=5e-3),
    "DCNMix": dict(l2_reg_linear=1e-3, l2_reg_dnn=3e-3, l2_reg_cross=5e-3),
}


def _cols(mod, mixed=False):
    """N_SPARSE fields of dim DIM (the last two of dim 6 when ``mixed``),
    N_DENSE dense."""
    dims = [DIM] * N_SPARSE
    if mixed:
        dims[-2:] = [6, 6]
    return [mod.SparseFeat(f"C{i}", VOCAB, d) for i, d in enumerate(dims)] + [
        mod.DenseFeat(f"I{i}") for i in range(N_DENSE)]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
    return x, (rng.uniform(size=n) < 0.4).astype(np.float32)


def _pair(name, optimizer="adam", mixed=False, **kw):
    """(JAX model, port model) with the same random weights (scale 0.1)."""
    cls, dnn, arch = MODELS[name]
    jcols, tcols = _cols(jf, mixed), _cols(tf, mixed)
    jdnn, tdnn = (jcols, tcols) if dnn is None else (dnn(jcols), dnn(tcols))
    jm = getattr(jmodels, cls)(jcols, jdnn, **arch, **kw)
    jm.compile(optimizer, "binary_crossentropy", metrics=METRICS)
    rng = np.random.default_rng(1)
    w = jm.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"])
    jm.set_weights(w)
    pm = getattr(tmodels, cls)(tcols, tdnn, device="cpu", **arch, **kw)
    pm.set_weights(jm.get_weights())
    pm.compile(optimizer, "binary_crossentropy", metrics=METRICS)
    return jm, pm


def _first_batch_delta(model, x, y, n):
    before = {k: v.copy() for k, v in flatten_tree(model.get_weights()["params"])}
    model.fit({k: v[:n] for k, v in x.items()}, y[:n], batch_size=n, epochs=1, verbose=0,
              shuffle=False)
    after = dict(flatten_tree(model.get_weights()["params"]))
    return {k: np.asarray(after[k]) - before[k] for k in before}


def _assert_sgd_step_matches(jm, pm, seed):
    """One SGD step from the same weights: the weight changes are lr times
    the gradients, each within 1e-4 of its largest change."""
    x, y = _data(96, seed=seed)
    want = _first_batch_delta(jm, x, y, 96)
    got = _first_batch_delta(pm, x, y, 96)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max() + 1e-8, err_msg=k)
    return want


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_predict_matches_jax(name):
    jm, pm = _pair(name)
    assert pm.module._fused  # one gather through the main and linear tables
    x, _ = _data(150, seed=2)
    got, want = pm.predict(x, 64), jm.predict(x, 64)
    assert got.dtype == np.float64 and got.shape == (150, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert want.std() > 1e-3


# a parameter each model must hold under its JAX path
NAMES = {
    "DeepFM": ("dnn/linear_1/kernel", "dnn_linear/kernel", "linear_model/weight"),
    "WDL": ("dnn/linear_1/bias", "dnn_linear/kernel"),
    "NFM": ("dnn/linear_0/kernel", "dnn_linear/kernel"),
    "AFM_att": ("fm/attention_W", "fm/attention_b", "fm/projection_h", "fm/projection_p"),
    "AFM_plain": ("embedding_dict/table_d4", "linear_model/embedding_dict/table_d1"),
    "DCN_vec": ("crossnet/kernels", "crossnet/bias", "dnn_linear/kernel"),
    "DCN_mat": ("crossnet/kernels", "dnn/linear_0/kernel"),
    "DCNMix": ("crossnet/U_list", "crossnet/V_list", "crossnet/C_list", "crossnet/gating",
               "crossnet/bias"),
    "IFM": ("factor_estimating_net/linear_1/kernel", "transform_weight_matrix_P/kernel"),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_weights_round_trip(name):
    jm, pm = _pair(name)
    want = dict(flatten_tree(jm.get_weights()["params"]))
    got = dict(flatten_tree(pm.get_weights()["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in NAMES[name]:
        assert k in got, k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_l2_registry_matches_jax(name):
    jm, pm = _pair(name, l2_reg_embedding=2e-3, **REG[MODELS[name][0]])
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
    kw = dict(l2_reg_att=1e-3) if name.startswith("AFM") else dict(l2_reg_dnn=1e-3)
    want = _assert_sgd_step_matches(*_pair(name, "sgd", **kw), seed=3)
    assert all(np.abs(v).max() > 0 for k, v in want.items() if "table_d" not in k
               and not (name == "AFM_att" and k == "fm/attention_b"))


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
    # adam divides by the root of the second moment: a weight whose gradients
    # are near 0 (an embedding row met once) turns rounding noise into up to
    # lr-sized moves, hence atol 1e-4 on the weights
    want_w = dict(flatten_tree(jm.get_weights()["params"]))
    for k, v in flatten_tree(pm.get_weights()["params"]):
        np.testing.assert_allclose(v, np.asarray(want_w[k]), rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["WDL", "DCN_vec"])
def test_mixed_dim_model_matches_jax(name):
    """C3 and C4 at dim 6, the rest at 4: two main tables, no fused gather,
    ``fast_inputs`` on each feature's own lookup; predictions and one SGD
    step as above."""
    jm, pm = _pair(name, mixed=True)
    assert not pm.module._fused
    tables = sorted(k for k, _ in flatten_tree(pm.get_weights()["params"])
                    if k.startswith("embedding_dict/"))
    assert tables == ["embedding_dict/table_d4", "embedding_dict/table_d6"]
    x, _ = _data(150, seed=5)
    np.testing.assert_allclose(pm.predict(x, 64), jm.predict(x, 64), rtol=1e-5, atol=1e-6)
    want = _assert_sgd_step_matches(*_pair(name, "sgd", mixed=True, l2_reg_dnn=1e-3), seed=6)
    assert np.abs(want["embedding_dict/table_d6"]).max() > 0


def _ctor_error(cls, jcols, jdnn, tcols, tdnn, exc, match, **kw):
    with pytest.raises(exc, match=match):
        getattr(jmodels, cls)(jcols, jdnn, **kw)
    with pytest.raises(exc, match=match):
        getattr(tmodels, cls)(tcols, tdnn, device="cpu", **kw)


def test_model_constructor_errors_match_jax():
    jc, tc = _cols(jf), _cols(tf)
    _ctor_error("IFM", jc, jc, tc, tc, ValueError, "dnn_hidden_units is null",
                dnn_hidden_units=())
    for cls in ("DCN",):
        _ctor_error(cls, jc, jc, tc, tc, ValueError, "parameterization should be",
                    cross_parameterization="diagonal")
    _ctor_error("AFM", jc, jc, tc, tc, ValueError, "DenseFeat is not supported")
    jm, tm = _cols(jf, mixed=True), _cols(tf, mixed=True)
    for cls in ("NFM", "AFM"):  # embedding_size over mixed dims
        _ctor_error(cls, jm, _sparse_only(jm), tm, _sparse_only(tm), ValueError,
                    "embedding_dim of SparseFeat and VarlenSparseFeat must be same")
    for cls in ("DeepFM", "IFM"):  # the stacked lookups over mixed dims
        _ctor_error(cls, jm, jm, tm, tm, ValueError, "uniform embedding dim")
        with pytest.raises(MixedEmbeddingDims):
            getattr(tmodels, cls)(tm, tm, device="cpu")


@pytest.mark.parametrize("cls", ["DeepFM", "WDL", "IFM", "DCN", "DCNMix"])
def test_dnn_use_bn_names_its_roadmap_item(cls):
    """``dnn_use_bn=True`` (ROADMAP item 12b; the name is kept from when it
    raised): each DNN layer gains ``bn_{i}`` after ``linear_{i}``.  With
    random running statistics, the predictions, one SGD step (weights and
    statistics, ``tests/test_torch_port_bn_models.py``'s step check) and the
    statistics after a ``fit`` ending on a partial batch (SGD, within rtol /
    atol 1e-4) match the JAX model's."""
    from test_torch_port_bn_models import _leaves, assert_sgd_step_matches

    name = {"DCN": "DCN_vec"}.get(cls, cls)
    jm, pm = _pair(name, "sgd", dnn_use_bn=True, l2_reg_dnn=1e-3)
    rng = np.random.default_rng(11)
    w = jm.get_weights()
    w["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, np.shape(v)) if "var" in jax.tree_util.keystr(path)
                         else 0.3 * rng.standard_normal(np.shape(v))).astype(np.float32),
        w["batch_stats"])
    stats = [k for k, _ in flatten_tree(w["batch_stats"])]
    # IFM's BatchNorms sit in its factor-estimating net
    assert stats and all(k.rsplit("/", 2)[-2].startswith("bn_") for k in stats)
    for m in (jm, pm):
        m.set_weights(w)
    x, y = _data(150, seed=12)
    want = jm.predict(x, 64)
    np.testing.assert_allclose(pm.predict(x, 64), want, rtol=1e-5, atol=1e-6)
    assert want.std() > 1e-3
    delta = assert_sgd_step_matches(jm, pm, x, y, 96)
    assert all(np.abs(v).max() > 0 for k, v in delta.items() if k.startswith("batch_stats/"))
    x, y = _data(240, seed=13)  # 3 batches of 64 and a tail of 48
    fit = dict(batch_size=64, epochs=2, verbose=0, shuffle=True)
    np.testing.assert_allclose(pm.fit(x, y, **fit).history["loss"],
                               jm.fit(x, y, **fit).history["loss"], rtol=1e-4)
    want, got = _leaves(jm), _leaves(pm)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("towers", ["dnn_only", "cross_only", "neither"])
def test_dcn_single_tower_matches_jax(towers):
    """DCN's other branches (``dcn.py:66-76``): the DNN alone, the cross
    network alone, and the linear term alone."""
    arch = {"dnn_only": dict(cross_num=0, dnn_hidden_units=(8,)),
            "cross_only": dict(cross_num=2, dnn_hidden_units=()),
            "neither": dict(cross_num=0, dnn_hidden_units=())}[towers]
    jm = jmodels.DCN(_cols(jf), _cols(jf), **arch)
    jm.compile("adam", "binary_crossentropy")
    pm = tmodels.DCN(_cols(tf), _cols(tf), device="cpu", **arch)
    pm.set_weights(jax.tree.map(np.asarray, jm.get_weights()))
    assert sorted(k for k, _ in flatten_tree(pm.get_weights()["params"])) == sorted(
        k for k, _ in flatten_tree(jm.get_weights()["params"]))
    x, _ = _data(64, seed=7)
    np.testing.assert_allclose(pm.predict(x, 64), jm.predict(x, 64), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- compile


def test_compile_takes_the_jax_parameters_in_the_jax_order():
    import inspect

    import xdeepfm_tpu.basemodel as jbm
    import xdeepfm_tpu_torch.basemodel as tbm

    want = inspect.signature(jbm.BaseModel.compile).parameters
    got = inspect.signature(tbm.BaseModel.compile).parameters
    assert list(got) == list(want)
    assert [p.default for p in got.values()] == [p.default for p in want.values()]


# bf16 keeps 8 significant bits: one rounding is 2^-8 relative at most
BF16_ROUNDING = 2.0**-8


def test_compile_rejects_bf16_matmuls_and_unknown_values():
    """``matmul_precision="bfloat16"`` (the name is kept from when it
    raised) trains: the module's forward runs under bf16 autocast in the
    train step only.  XLA:CPU ignores the JAX mode, so the JAX model trains
    in fp32 here, and the port is held to it at bf16's tolerance: one SGD
    step's changes within 5e-2 of each leaf's largest change (a few bf16
    roundings through the forward's products; DeepFM reads 1.1e-2) and the
    ``fit`` histories within one bf16 rounding.  The mode is live: a
    ``Linear``'s product is bf16 in a train step and fp32 in ``predict``,
    and the step's changes differ from the fp32 step's beyond the fp32
    tolerance.  Unknown values still raise."""
    jm, pm = _pair("DeepFM", "sgd")
    x, y = _data(300, seed=9)
    fp32 = _first_batch_delta(pm, x, y, 96)
    _, pm = _pair("DeepFM", "sgd")
    for m in (jm, pm):
        m.compile("sgd", "binary_crossentropy", metrics=METRICS, matmul_precision="bfloat16")
    seen = []
    hook = pm.module.dnn.linear_0.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    want, got = _first_batch_delta(jm, x, y, 96), _first_batch_delta(pm, x, y, 96)
    pm.predict({k: v[:96] for k, v in x.items()}, 96)
    hook.remove()
    assert seen == [torch.bfloat16, torch.float32]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-2 * np.abs(want[k]).max(),
                                   err_msg=k)
    assert max(np.abs(got[k] - fp32[k]).max() / np.abs(fp32[k]).max() for k in fp32) > 1e-4
    fit = dict(batch_size=64, epochs=2, verbose=0, shuffle=True)
    want, got = jm.fit(x, y, **fit).history, pm.fit(x, y, **fit).history
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=BF16_ROUNDING, err_msg=k)
    with pytest.raises(ValueError, match="matmul_precision"):
        pm.compile("adam", "binary_crossentropy", matmul_precision="tf32")
    with pytest.raises(ValueError):
        pm.compile("adam", "binary_crossentropy", fused_lookup="yes")
    # a positional call binds as the JAX one does
    pm.compile("sgd", "binary_crossentropy", None, None, "dense", None, "auto", False)
    assert not pm.module.embedding_dict.fused_lookup


@pytest.mark.parametrize("name", ["DeepFM", "WDL"])
def test_fused_lookup_false_gathers_each_table_alone(name, monkeypatch):
    """``compile(fused_lookup=False)``: one gather a table instead of one
    for both, the same predictions and SGD step as "auto" within 1e-6; a
    recompile with "auto" fuses again."""
    import xdeepfm_tpu_torch.embeddings as temb

    calls = []
    gather = temb.fused_gather
    monkeypatch.setattr(temb, "fused_gather",
                        lambda tables, ids: calls.append(len(tables)) or gather(tables, ids))
    x, y = _data(96, seed=8)
    runs = {}
    for fused in ("auto", False, True):
        _, pm = _pair(name, "sgd")
        pm.compile("sgd", "binary_crossentropy", fused_lookup=fused)
        calls.clear()
        pred = pm.predict(x, 96)
        runs[fused] = pred, _first_batch_delta(pm, x, y, 96)
        assert calls == ([1, 1] if fused is False else [2]) * 2, (fused, calls)
    for fused in (False, True):
        np.testing.assert_allclose(runs[fused][0], runs["auto"][0], rtol=0, atol=1e-6)
        for k, v in runs["auto"][1].items():
            np.testing.assert_allclose(runs[fused][1][k], v, rtol=0, atol=1e-6, err_msg=k)
