"""PyTorch port, the multitask family: SharedBottom (with towers; without
towers on a binary and a regression task), ESMM, MMOE (with and without gate
DNNs) and PLE (at its defaults; with 2 specific experts and 1 shared, whose
JAX tree holds only the shared experts its forward calls) against the JAX
package's models, trained through the engine's loss lists.

The JAX model is compiled and its weights replaced by seeded numpy draws
(``SCALE``); the port receives them through ``set_weights``, and both run
fp32 on the CPU on the same numpy data.  Each JAX model and its compiled
steps are built once per configuration and mode (``_jax``), and each test
restores its weights and optimizer state.

Tolerances (``tests/test_torch_port_zoo_models.py``'s): predictions rtol
1e-5, atol 1e-6; one SGD step's weight changes within 1e-4 of each
parameter's largest change; the ``fit`` and ``fit_stream`` histories rtol
1e-4, atol 1e-6, and the weights after them within 1e-4 (Adam); the lazy
split step's weights within Adam's rtol 1e-4 / atol 2e-5 and its row states
within rtol 1e-3 (``tests/test_torch_port_lazy.py``'s).
"""

import functools

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
BCE2 = ["binary_crossentropy", "binary_crossentropy"]

# name: (class name, architecture, losses)
MODELS = {
    "SharedBottom": ("SharedBottom", dict(bottom_dnn_hidden_units=(8, 8),
                                          tower_dnn_hidden_units=(4,)), BCE2),
    "SharedBottom_no_tower": ("SharedBottom", dict(
        bottom_dnn_hidden_units=(8,), tower_dnn_hidden_units=(),
        task_types=("binary", "regression")), ["binary_crossentropy", "mse"]),
    "ESMM": ("ESMM", dict(tower_dnn_hidden_units=(8, 8)), BCE2),
    "MMOE": ("MMOE", dict(num_experts=2, expert_dnn_hidden_units=(8,),
                          gate_dnn_hidden_units=(4,), tower_dnn_hidden_units=(4,)), BCE2),
    "MMOE_no_gate_dnn": ("MMOE", dict(num_experts=2, expert_dnn_hidden_units=(8,),
                                      gate_dnn_hidden_units=(), tower_dnn_hidden_units=(4,)),
                         BCE2),
    "PLE": ("PLE", dict(), BCE2),
    "PLE_2_specific_1_shared": ("PLE", dict(
        specific_expert_num=2, shared_expert_num=1, num_levels=2,
        expert_dnn_hidden_units=(8,), gate_dnn_hidden_units=(4,),
        tower_dnn_hidden_units=(4,)), BCE2),
}
METRICS = ["auc"]
# the weights' scale: at 0.1 the narrow towers' scores spread by 1e-4 only;
# PLE's defaults, (256, 128) experts over two levels, spread by 1e-3 at 0.1
# and saturate at 0.3
SCALE = {"PLE": 0.15}
# parameters each model must hold under its JAX path
NAMES = {
    "SharedBottom": ("bottom_dnn/linear_1/kernel", "tower_dnn_1/linear_0/kernel",
                     "tower_final_0/kernel", "out_1/global_bias"),
    "SharedBottom_no_tower": ("tower_final_1/kernel", "out_0/global_bias"),
    "ESMM": ("ctr_dnn/linear_1/kernel", "cvr_dnn/linear_0/bias", "ctr_final/kernel",
             "cvr_final/kernel", "out/global_bias"),
    "MMOE": ("expert_dnn_1/linear_0/kernel", "gate_dnn_0/linear_0/kernel",
             "gate_final_1/kernel", "tower_dnn_0/linear_0/kernel", "out_1/global_bias"),
    "MMOE_no_gate_dnn": ("gate_final_0/kernel", "gate_final_1/kernel"),
    "PLE": ("specific_expert_1_1_0/linear_1/kernel", "shared_expert_0_0_0/linear_0/bias",
            "specific_gate_dnn_0_1_0/linear_0/kernel", "shared_gate_dnn_1/linear_0/kernel",
            "specific_gate_final_1_0/kernel", "shared_gate_final_1/kernel"),
    "PLE_2_specific_1_shared": ("specific_expert_0_0_1/linear_0/kernel",
                                "shared_expert_1_0_0/linear_0/kernel"),
}


def _cols(mod):
    return [mod.SparseFeat(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)] + [
        mod.DenseFeat(f"I{i}") for i in range(N_DENSE)]


def _data(n, seed=0):
    """Rows and [n, 2] labels: a click, and a conversion only after a click
    (ESMM's CTCVR); a regression task takes the same 0/1 values."""
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
    click = rng.uniform(size=n) < 0.4
    buy = click & (rng.uniform(size=n) < 0.5)
    return x, np.stack([click, buy], 1).astype(np.float32)


def _seeded(jm, name):
    w = jm.get_weights()
    rng = np.random.default_rng(1)
    scale = SCALE.get(name, 0.5)
    w["params"] = jax.tree.map(
        lambda v: (scale * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"])
    return w


@functools.lru_cache(maxsize=None)
def _jax(name, optimizer="adam", l2_reg_dnn=0.0, lazy=False):
    """(JAX model, its seeded weights), compiled once per configuration and
    mode, so that its jitted steps are traced once."""
    cls, arch, loss = MODELS[name]
    jm = getattr(jmodels, cls)(_cols(jf), l2_reg_dnn=l2_reg_dnn, **arch)
    jm.compile("adam", loss)  # the weights exist after a compile
    w = _seeded(jm, name)
    kw = dict(embedding_optimizer="lazy", embedding_gradient="split") if lazy else {}
    jm.compile(optimizer, loss, metrics=METRICS, **kw)
    return jm, w


def _pair(name, optimizer="adam", l2_reg_dnn=0.0, lazy=False):
    """(JAX model, port model) with the same seeded weights, compiled, the
    JAX model's optimizer state fresh."""
    jm, w = _jax(name, optimizer, l2_reg_dnn, lazy)
    jm.set_weights(w)
    jm._init_opt_state()
    cls, arch, loss = MODELS[name]
    pm = getattr(tmodels, cls)(_cols(tf), l2_reg_dnn=l2_reg_dnn, device="cpu", **arch)
    pm.set_weights(w)
    kw = dict(embedding_optimizer="lazy", embedding_gradient="split") if lazy else {}
    pm.compile(optimizer, loss, metrics=METRICS, **kw)
    return jm, pm


def _first_batch_delta(model, x, y, n):
    before = {k: v.copy() for k, v in flatten_tree(model.get_weights()["params"])}
    model.fit({k: v[:n] for k, v in x.items()}, y[:n], batch_size=n, epochs=1, verbose=0,
              shuffle=False)
    after = dict(flatten_tree(model.get_weights()["params"]))
    return {k: np.asarray(after[k]) - before[k] for k in before}


def _assert_adam_weights_close(pm, jm, steps, lr=1e-3):
    """The weights after ``steps`` Adam steps within 1e-4, but for at most
    one in 1000 entries of a parameter, each within lr a step: Adam moves an
    entry by about lr whatever its gradient's size, so where fp32 rounding
    turns a near-zero gradient's sign the entry moves by up to lr the other
    way (5 of the 32768 entries of one kernel of PLE at its defaults)."""
    want = dict(flatten_tree(jm.get_weights()["params"]))
    got = dict(flatten_tree(pm.get_weights()["params"]))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(got[k] - np.asarray(w))
        off = err > 1e-4 + 1e-4 * np.abs(w)
        assert off.sum() <= off.size // 1000, (k, int(off.sum()), float(err.max()))
        assert err.max() <= steps * lr, (k, float(err.max()))


def _assert_history_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_multitask_predict_matches_jax(name):
    jm, pm = _pair(name)
    x, _ = _data(150, seed=2)
    got, want = pm.predict(x, 64), jm.predict(x, 64)
    assert got.dtype == np.float64 and got.shape == (150, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (want.std(0) > 1e-3).all()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_multitask_weights_round_trip(name):
    """The JAX tree loads and comes back bit-exactly, with the JAX key set
    (PLE's quirk case included: one shared expert a level)."""
    jm, pm = _pair(name)
    want = dict(flatten_tree(jm.get_weights()["params"]))
    got = dict(flatten_tree(pm.get_weights()["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in NAMES[name]:
        assert k in got, k
    if name == "PLE_2_specific_1_shared":
        assert sorted(k for k in got if k.startswith("shared_expert_")) == [
            f"shared_expert_{lv}_0_0/linear_0/{leaf}" for lv in (0, 1)
            for leaf in ("bias", "kernel")]
        assert got["specific_gate_final_0_0/kernel"].shape == (4, 3)
        assert got["shared_gate_final_1/kernel"].shape == (4, 5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_multitask_l2_registry_matches_jax(name):
    """Every parameter's (l1, l2) at ``l2_reg_dnn=0.1`` against the JAX
    registry's, PLE's gate finals matched by two patterns (0.2) among them,
    and the regularization value."""
    jm, pm = _pair(name, l2_reg_dnn=0.1)
    want = {p: jm._reg_coeffs_for(p) for p, _ in flatten_tree(jm.get_weights()["params"])}
    want = {p: c for p, c in want.items() if c != (0.0, 0.0)}
    paths = canonical_paths(pm.module)
    names = {id(p): n for n, p in pm.module.named_parameters()}
    got = {paths[names[id(p)]]: (l1, l2) for p, l1, l2 in pm._regularization_terms()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    if MODELS[name][0] == "PLE":
        assert got["specific_gate_final_1_0/kernel"] == got["shared_gate_final_0/kernel"] == (
            0.0, pytest.approx(0.2))
    np.testing.assert_allclose(pm._regularization_loss().item(),
                               float(jm._regularization_loss(jm.params)), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_multitask_one_sgd_step_matches_jax(name):
    """The loss list's gradients: each parameter's change within 1e-4 of its
    largest change from the JAX model's, and every parameter moves but the
    bias of the last PLE level's shared gate DNN: nothing reads that level's
    shared mixture, and the L2 term moves only kernels."""
    jm, pm = _pair(name, "sgd", l2_reg_dnn=1e-3)
    x, y = _data(96, seed=3)
    want = _first_batch_delta(jm, x, y, 96)
    got = _first_batch_delta(pm, x, y, 96)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max() + 1e-8, err_msg=k)
    still = sorted(k for k, v in want.items() if np.abs(v).max() == 0)
    assert still == (["shared_gate_dnn_1/linear_0/bias"] if MODELS[name][0] == "PLE" else [])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_multitask_fit_matches_jax(name):
    """``fit`` with the loss list, the macro AUC over both tasks and
    ``validation_data``: 240 rows in batches of 64 (a tail of 48)."""
    jm, pm = _pair(name)
    x, y = _data(240, seed=4)
    val = _data(60, seed=5)
    fit = dict(batch_size=64, epochs=2, verbose=1, validation_data=val, shuffle=True)
    want = jm.fit(x, y, **fit).history
    got = pm.fit(x, y, **fit).history
    assert sorted(got) == ["auc", "loss", "val_auc"]
    _assert_history_close(got, want)
    _assert_adam_weights_close(pm, jm, steps=8)
    np.testing.assert_allclose(pm.evaluate(*val, batch_size=64)["auc"],
                               jm.evaluate(*val, batch_size=64)["auc"], rtol=1e-6)


@pytest.mark.parametrize("name", ["SharedBottom_no_tower", "PLE_2_specific_1_shared"])
def test_multitask_fit_stream_matches_jax(name):
    """``fit_stream`` over batches of 64 with a tail of 40."""
    jm, pm = _pair(name)
    x, y = _data(232, seed=6)

    def stream(epoch):
        for i in range(0, len(y), 64):
            yield {k: v[i:i + 64] for k, v in x.items()}, y[i:i + 64]

    want = jm.fit_stream(stream, epochs=2, verbose=0).history
    got = pm.fit_stream(stream, epochs=2, verbose=0).history
    _assert_history_close(got, want)
    _assert_adam_weights_close(pm, jm, steps=8)


def test_mmoe_lazy_split_packed_step_matches_jax():
    """``compile(embedding_optimizer="lazy")`` with the split gradient and
    the packed layout: both tasks' gradients reach the one occurrence block.
    One step: the loss, the weights and the row states."""
    jm, pm = _pair("MMOE", lazy=True)
    assert pm._lazy["packed"] and jm._packed_tables
    assert sorted(m["path"] for m in pm._lazy_members()) == ["embedding_dict/table_d4"]
    x, y = _data(96, seed=7)
    want = jm.fit(x, y, batch_size=96, epochs=1, verbose=0, shuffle=False).history
    got = pm.fit(x, y, batch_size=96, epochs=1, verbose=0, shuffle=False).history
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _assert_weights_close(pm, jm)
    _assert_states_close(pm, jm)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_multitask_scorer_matches_jax(name):
    """``Scorer(batch_size=64)`` over 150 rows (a padded tail): [150, 2]
    float64 against the JAX model's ``predict``."""
    jm, pm = _pair(name)
    x, _ = _data(150, seed=8)
    got = Scorer(pm, batch_size=64).warmup().score(x)
    assert got.dtype == np.float64 and got.shape == (150, 2)
    np.testing.assert_allclose(got, jm.predict(x, 64), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cls,kw,exc,match", [
    ("SharedBottom", dict(task_names=("ctr",), task_types=("binary",)), ValueError,
     "num_tasks must be greater than 1"),
    ("SharedBottom", dict(task_types=("binary",)), ValueError,
     "num_tasks must be equal to the length of task_types"),
    ("SharedBottom", dict(task_types=("binary", "multiclass")), ValueError,
     "task must be binary or regression, multiclass is illegal"),
    ("ESMM", dict(task_names=("a", "b", "c"), task_types=("binary",) * 3), ValueError,
     "the length of task_names must be equal to 2"),
    ("ESMM", dict(task_types=("binary", "regression")), ValueError,
     "task must be binary in ESMM, regression is illegal"),
    ("MMOE", dict(num_experts=1), ValueError, "num_experts must be greater than 1"),
    ("MMOE", dict(task_types=("regression", "ranking")), ValueError,
     "task must be binary or regression, ranking is illegal"),
    ("PLE", dict(task_names=("ctr",)), ValueError, "num_tasks must be greater than 1!"),
    ("PLE", dict(shared_expert_num=2, specific_expert_num=1, expert_dnn_hidden_units=(4,),
                 gate_dnn_hidden_units=(), tower_dnn_hidden_units=()),
     IndexError, "index out of range"),
])
def test_multitask_constructor_errors_match_jax(cls, kw, exc, match):
    with pytest.raises(exc, match=match):
        getattr(jmodels, cls)(_cols(jf), **kw)
    with pytest.raises(exc, match=match):
        getattr(tmodels, cls)(_cols(tf), device="cpu", **kw)


@pytest.mark.parametrize("cls", ["SharedBottom", "ESMM", "MMOE", "PLE"])
def test_multitask_empty_columns_raise(cls):
    for mod in (jmodels, tmodels):
        with pytest.raises(ValueError, match="dnn_feature_columns is null!"):
            getattr(mod, cls)([], **({} if mod is jmodels else dict(device="cpu")))


@pytest.mark.parametrize("case", ["three_losses", "single_task_list"])
def test_loss_list_length_assert_matches_jax(case):
    """A loss list whose length is not the model's task count fails the
    first step with the JAX engine's assert: three losses on a two-task
    model, and any list on a single-task model (``num_tasks`` None)."""
    x, y = _data(64, seed=9)
    if case == "three_losses":
        arch = MODELS["SharedBottom"][1]
        models = [jmodels.SharedBottom(_cols(jf), **arch),
                  tmodels.SharedBottom(_cols(tf), device="cpu", **arch)]
        loss = BCE2 + ["mse"]
    else:
        models = [jmodels.WDL(_cols(jf), _cols(jf), dnn_hidden_units=(4,)),
                  tmodels.WDL(_cols(tf), _cols(tf), dnn_hidden_units=(4,), device="cpu")]
        loss, y = ["binary_crossentropy"], y[:, 0]
    assert models[1].num_tasks == models[0].num_tasks
    for m in models:
        m.compile("adam", loss)
        with pytest.raises(AssertionError,
                           match="the length of `loss_func` should be equal with "
                                 "`self.num_tasks`"):
            m.fit(x, y, batch_size=64, epochs=1, verbose=0)
