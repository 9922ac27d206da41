"""PyTorch port, BatchNorm slice: ``BatchNorm`` (flax's semantics), ``Dice``
and AFN's ``LogTransformLayer``, then the models DIN and AFN, against the
JAX package's.

Layers: inputs, parameters and running statistics are seeded numpy draws
given to both sides; the forward in training mode (batch statistics, the
updated running values), in evaluation mode (the running values) and the
gradients of a seeded cotangent against ``jax.grad``.  Forwards and
statistics within rtol 1e-5 / atol 1e-6 (fp32 sums over the batch in two
orders); gradients within rtol 1e-4 and 1e-4 of each gradient's largest
entry, the one-SGD-step tolerance below: the batch statistics' gradients
cancel, and in LTL's ``bn0`` bias both fp32 sides lie 1.4e-5 and 2.1e-5 of
its largest entry off a float64 run.

Models: the JAX model is compiled and its weights replaced by seeded numpy
draws at scale 0.3, its running means by draws at scale 0.3 and its
running variances by draws from U(0.5, 1.5); the port receives them through
``set_weights``, and both run fp32 on the CPU on the same numpy data.
Tolerances are ``tests/test_torch_port_fm_models.py``'s: predictions rtol
1e-5 / atol 1e-6; one SGD step's weight and statistics changes within 1e-4
of each leaf's largest change (plus 1e-6 of the step's largest, see
``assert_sgd_step_matches``); ``fit`` histories rtol 1e-4 / atol 1e-6 and
the weights and statistics after it rtol / atol 1e-4 (AFN's table: see
``AFN_TABLE_ATOL``).  Every ``fit`` ends its epochs on a partial batch,
whose padded rows enter the BatchNorm statistics on both sides.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xdeepfm_tpu.features as jf
import xdeepfm_tpu.models as jmodels
import xdeepfm_tpu_torch.features as tf
import xdeepfm_tpu_torch.models as tmodels
from xdeepfm_tpu.nn.activations import Dice as JaxDice
from xdeepfm_tpu.nn.interaction import LogTransformLayer as JaxLTL
from xdeepfm_tpu_torch.nn.activations import Dice
from xdeepfm_tpu_torch.nn.core import BatchNorm
from xdeepfm_tpu_torch.nn.interaction import LogTransformLayer
from xdeepfm_tpu_torch.serving import Scorer
from xdeepfm_tpu_torch.weights import canonical_paths, flatten_tree, from_jax_weights

TOL = dict(rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ layers


class _JaxBatchNorm(fnn.Module):
    """flax's BatchNorm as the port's DNN uses it (momentum 0.9)."""

    axis: int = -1
    epsilon: float = 1e-5

    @fnn.compact
    def __call__(self, x, training: bool = False):
        return fnn.BatchNorm(use_running_average=not training, momentum=0.9,
                             epsilon=self.epsilon, axis=self.axis, name="bn")(x)


class _PortBatchNorm(torch.nn.Module):
    def __init__(self, n, axis=-1):
        super().__init__()
        self.bn = BatchNorm(n, axis=axis)

    def forward(self, x, training=False):
        return self.bn(x, training=training)


def _seeded_variables(variables, seed):
    """Parameters N(0, 0.5) around their init (scale about 1), running
    means N(0, 0.5) and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, v):
        name = jax.tree_util.keystr(path)
        shape = np.shape(v)
        if "var" in name:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (np.asarray(v) + 0.5 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(np.asarray, variables))


def _assert_grad_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                               err_msg=name)


def _check_layer(jmod, tmod, x, seed):
    """``tmod`` against the flax module ``jmod`` on ``x`` (numpy): training
    and evaluation forwards, the updated running statistics and the
    gradients of a seeded cotangent for the input and every parameter."""
    variables = _seeded_variables(dict(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed)
    tmod.load_state_dict(from_jax_weights(variables), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    want_eval = jmod.apply(variables, jnp.asarray(x), training=False)
    with torch.no_grad():
        np.testing.assert_allclose(tmod(xt, training=False).numpy(), np.asarray(want_eval), **TOL)
    cot = np.random.default_rng(seed + 1).normal(size=np.shape(want_eval)).astype(np.float32)

    def loss(params, xj):
        out, mutated = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  xj, training=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mutated["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    got = tmod(xt, training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(torch.from_numpy(cot))
    _assert_grad_close(xt.grad.numpy(), np.asarray(gx), "x")
    named = dict(tmod.named_parameters())
    for path, g in flatten_tree(jax.tree.map(np.asarray, gp)):
        _assert_grad_close(named[path.replace("/", ".")].grad.numpy(), g, path)
    buffers = dict(tmod.named_buffers())
    assert sorted(buffers) == sorted(p.replace("/", ".") for p, _ in flatten_tree(stats))
    for path, s in flatten_tree(jax.tree.map(np.asarray, stats)):
        np.testing.assert_allclose(buffers[path.replace("/", ".")].numpy(), s, **TOL,
                                   err_msg=path)
        assert not np.allclose(s, np.asarray(dict(flatten_tree(variables["batch_stats"]))[path]))
    return xt.grad.numpy()


@pytest.mark.parametrize("axis", [-1, 1])
def test_batchnorm_matches_flax(axis):
    """Feature axis -1 (the DNN's, Dice's, LTL's ``bn0``) and 1 (LTL's
    ``bn1`` on [B, E, H]); the biased batch variance, momentum 0.9."""
    x = np.random.default_rng(3).normal(1.0, 2.0, size=(7, 5, 6)).astype(np.float32)
    n = x.shape[axis]
    _check_layer(_JaxBatchNorm(axis=axis), _PortBatchNorm(n, axis), x, seed=4)
    bn = BatchNorm(n, axis=axis)
    assert sorted(k for k, _ in bn.named_parameters()) == ["bias", "scale"]
    assert sorted(k for k, _ in bn.named_buffers()) == ["mean", "var"]
    assert bn.scale.tolist() == [1.0] * n and bn.var.tolist() == [1.0] * n
    assert bn.bias.tolist() == [0.0] * n and bn.mean.tolist() == [0.0] * n


@pytest.mark.parametrize("dim", [2, 3])
def test_dice_matches_jax(dim):
    """Dice over [B, C] (dim 2) and [B, T, C] (dim 3, the statistics over
    (B, T)); alpha (C,) or (C, 1); its BatchNorm ``bn`` at eps 1e-8; a wrong
    rank raises on both sides."""
    shape = (9, 4) if dim == 2 else (6, 5, 4)
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    jmod, tmod = JaxDice(emb_size=4, dim=dim), Dice(4, dim=dim)
    assert tuple(tmod.alpha.shape) == ((4,) if dim == 2 else (4, 1))
    assert not tmod.alpha.detach().any() and tmod.bn.eps == 1e-8
    _check_layer(jmod, tmod, x, seed=6)
    wrong = np.zeros((2, 3, 4) if dim == 2 else (2, 4), np.float32)
    with pytest.raises(ValueError, match="rank"):
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(wrong))
    with pytest.raises(ValueError, match="rank"):
        tmod(torch.from_numpy(wrong))


def test_log_transform_layer_matches_jax():
    """AFN's logarithmic neurons, forward and gradients; the input holds
    exact zeros and entries at +-1e-7 and below, where the clip's gradient
    (0, split at the tie) must match JAX's."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(8, 3, 4)).astype(np.float32)
    x[0, 0, :] = [0.0, np.float32(1e-7), -np.float32(1e-7), 3e-8]
    x[1, 2, :2] = [0.0, -5e-8]
    jmod = JaxLTL(field_size=3, embedding_size=4, ltl_hidden_size=5)
    tmod = LogTransformLayer(3, 4, 5)
    gx = _check_layer(jmod, tmod, x, seed=8)
    assert gx[0, 0, 0] == 0.0 and gx[0, 0, 3] == 0.0 and gx[1, 2, 1] == 0.0
    assert gx[0, 0, 1] != 0.0
    w = LogTransformLayer(26, 10, 256, generator=torch.Generator().manual_seed(0)).ltl_weights
    assert abs(float(w.std()) - 0.1) < 0.005 and abs(float(w.mean())) < 0.005


# ------------------------------------------------------------------ models

VOCAB, MAXLEN, EMB = 12, 6, 4
N_SPARSE, FM_VOCAB, N_DENSE = 5, 30, 2


def _din_cols(mod, length_name="seq_length"):
    """User and item, a dense score, the item history and a tag sequence
    pooled by the mean of its nonzero ids (no length column)."""
    return [mod.SparseFeat("user", VOCAB, EMB), mod.SparseFeat("item", VOCAB, EMB),
            mod.DenseFeat("score", 1),
            mod.VarLenSparseFeat(mod.SparseFeat("hist_item", VOCAB, EMB, embedding_name="item"),
                                 maxlen=MAXLEN, length_name=length_name),
            mod.VarLenSparseFeat(mod.SparseFeat("tags", 7, EMB), maxlen=3, combiner="mean")]


def _afn_cols(mod):
    return [mod.SparseFeat(f"C{i}", FM_VOCAB, EMB) for i in range(N_SPARSE)] + [
        mod.DenseFeat(f"I{i}") for i in range(N_DENSE)]


def _din_data(n, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, MAXLEN + 1, n)
    pad = np.arange(MAXLEN)[None, :] < lengths[:, None]
    x = {"user": rng.integers(0, VOCAB, n), "item": rng.integers(0, VOCAB, n),
         "score": rng.uniform(0, 1, n).astype(np.float32), "seq_length": lengths,
         "hist_item": rng.integers(1, VOCAB, (n, MAXLEN)) * pad,
         "tags": rng.integers(0, 7, (n, 3))}
    return x, (x["item"] % 2).astype(np.float32)


def _afn_data(n, seed):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, FM_VOCAB, n) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
    return x, (rng.uniform(size=n) < 0.4).astype(np.float32)


# name: (class, columns, data, architecture)
MODELS = {
    "DIN": ("DIN", _din_cols, _din_data, dict(dnn_hidden_units=(16, 8), att_hidden_size=(8, 4))),
    "DIN_bn": ("DIN", _din_cols, _din_data,
               dict(dnn_hidden_units=(16, 8), att_hidden_size=(8, 4), dnn_use_bn=True)),
    "AFN": ("AFN", _afn_cols, _afn_data, dict(ltl_hidden_size=8, afn_dnn_hidden_units=(8, 8))),
}


def _build(name, mod, models, **kw):
    cls, cols, _, arch = MODELS[name]
    args = (cols(mod), ["item"]) if cls == "DIN" else (cols(mod), cols(mod))
    return getattr(models, cls)(*args, **arch, **kw)


def _pair(name, optimizer="adam", **kw):
    """(JAX model, port model) with the same random weights (scale 0.3) and
    running statistics."""
    jm = _build(name, jf, jmodels, **kw)
    jm.compile(optimizer, "binary_crossentropy", metrics=["binary_crossentropy", "auc"])
    rng = np.random.default_rng(1)
    w = jm.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"])
    w["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, np.shape(v)) if "var" in jax.tree_util.keystr(path)
                         else 0.3 * rng.standard_normal(np.shape(v))).astype(np.float32),
        w["batch_stats"])
    jm.set_weights(w)
    pm = _build(name, tf, tmodels, device="cpu", **kw)
    pm.set_weights(jm.get_weights())
    pm.compile(optimizer, "binary_crossentropy", metrics=["binary_crossentropy", "auc"])
    return jm, pm


def _data(name, n, seed):
    return MODELS[name][2](n, seed)


def _leaves(model):
    """{"params/<path>" | "batch_stats/<path>": a copy} of ``get_weights``
    (the port's arrays share the CPU tensors' memory)."""
    w = model.get_weights()
    return {**{f"params/{k}": np.array(v) for k, v in flatten_tree(w["params"])},
            **{f"batch_stats/{k}": np.array(v) for k, v in flatten_tree(w["batch_stats"])}}


def _assert_leaves_close(pm, jm, rtol, atol, wide=()):
    """Every leaf within (rtol, atol), those named in ``wide`` within
    AFN_TABLE_ATOL."""
    want, got = _leaves(jm), _leaves(pm)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=AFN_TABLE_ATOL if k in wide else atol, err_msg=k)


# AFN's log makes an embedding entry's gradient 1/|e| times its upstream
# gradient, so ten SGD steps compound each step's fp32 rounding: an entry
# drawn at -0.058 moves to -1.33 in test_bn_model_fit_matches_jax[AFN].
# Against a float64 fit of the port from the same weights, both fp32 fits
# lie up to 2.7e-3 (JAX) and 2.8e-3 (the port) off in the table, each at its
# own worst entry (every other leaf of both within 2e-4).  So the table is held within 5e-3 after
# ``fit``; one step holds it within the step tolerance, and AFN's scores
# after ``fit`` within 1e-3.
AFN_TABLE_ATOL = 5e-3


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bn_model_predict_matches_jax(name):
    jm, pm = _pair(name)
    x, _ = _data(name, 150, seed=2)
    got, want = pm.predict(x, 64), jm.predict(x, 64)
    assert got.dtype == np.float64 and got.shape == (150, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert want.std() > 1e-3


# leaves each model must hold under its JAX path
NAMES = {
    "DIN": ("params/attention/local_att/dnn/act_0/alpha",
            "params/attention/local_att/dnn/act_1/bn/scale",
            "batch_stats/attention/local_att/dnn/act_0/bn/var",
            "params/attention/local_att/dense/kernel", "params/dnn/linear_1/kernel",
            "params/dnn_linear/kernel", "params/embedding_dict/table_d4"),
    "DIN_bn": ("params/dnn/bn_0/scale", "params/dnn/bn_1/bias", "batch_stats/dnn/bn_0/mean",
               "batch_stats/attention/local_att/dnn/act_1/bn/mean"),
    "AFN": ("params/ltl/ltl_weights", "params/ltl/ltl_biases", "params/ltl/bn0/scale",
            "batch_stats/ltl/bn1/var", "params/afn_dnn/bn_1/bias",
            "batch_stats/afn_dnn/bn_0/mean", "params/afn_dnn_linear/bias",
            "params/linear_model/embedding_dict/table_d1"),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bn_model_weights_round_trip(name):
    """A JAX tree with ``batch_stats`` loads into the port and comes back
    bit-equal; ``canonical_paths`` keeps the statistics out of ``params``."""
    jm, pm = _pair(name)
    want, got = _leaves(jm), _leaves(pm)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in NAMES[name]:
        assert k in got, k
    paths = set(canonical_paths(pm.module).values())
    assert not any(p.endswith(("/mean", "/var")) for p in paths)
    assert {f"params/{p}" for p in paths} == {k for k in got if k.startswith("params/")}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bn_model_l2_registry_matches_jax(name):
    kw = dict(l2_reg_embedding=2e-3, l2_reg_dnn=3e-3)
    if MODELS[name][0] == "AFN":
        kw["l2_reg_linear"] = 1e-3
    jm, pm = _pair(name, **kw)
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


def _first_batch_delta(model, x, y, n):
    before = _leaves(model)
    model.fit({k: v[:n] for k, v in x.items()}, y[:n], batch_size=n, epochs=1, verbose=0,
              shuffle=False)
    after = _leaves(model)
    return {k: after[k] - before[k] for k in before}


def assert_sgd_step_matches(jm, pm, x, y, n):
    """One SGD step from the same weights: the weight changes (lr times the
    gradients) and the running statistics' changes, each within 1e-4 of
    its largest change plus 1e-6 of the largest change of all.  The second
    term holds a DNN bias under a BatchNorm, whose gradient the batch mean
    cancels: its change is rounding noise on both sides (1e-8 against a
    largest change of 6e-2 in AFN's step)."""
    want = _first_batch_delta(jm, x, y, n)
    got = _first_batch_delta(pm, x, y, n)
    assert sorted(got) == sorted(want)
    largest = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max() + 1e-6 * largest, err_msg=k)
    return want


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bn_model_one_sgd_step_matches_jax(name):
    jm, pm = _pair(name, "sgd", l2_reg_dnn=1e-3)
    x, y = _data(name, 96, seed=3)
    want = assert_sgd_step_matches(jm, pm, x, y, 96)
    stats = [k for k in want if k.startswith("batch_stats/")]
    assert stats and all(np.abs(want[k]).max() > 0 for k in stats)
    assert all(np.abs(v).max() > 0 for k, v in want.items() if k.endswith("/kernel"))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bn_model_fit_matches_jax(name):
    """Two shuffled epochs of 3 batches of 64 and a tail of 48 (padded with
    row 0 under a zero mask, inside the statistics), validation on the
    rest: the histories, then every weight and running statistic.  SGD, as
    ``tests/test_torch_port_dien_models.py`` fits: a DNN bias under a
    BatchNorm has a gradient of rounding noise, which Adam's normalised
    steps would turn into lr-sized moves that the running means follow."""
    jm, pm = _pair(name, "sgd")
    x, y = _data(name, 300, seed=4)
    fit = dict(batch_size=64, epochs=2, verbose=0, validation_split=0.2, shuffle=True)
    want = jm.fit(x, y, **fit).history
    got = pm.fit(x, y, **fit).history
    assert sorted(got) == sorted(want) and "val_auc" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    wide = {"params/embedding_dict/table_d4"} if MODELS[name][0] == "AFN" else set()
    _assert_leaves_close(pm, jm, rtol=1e-4, atol=1e-4, wide=wide)
    # AFN's scores read those table rows: 2.3e-4 apart at worst
    np.testing.assert_allclose(pm.predict(x, 64), jm.predict(x, 64), rtol=1e-4,
                               atol=1e-3 if wide else 1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bn_model_files_carry_the_statistics(name, tmp_path):
    """``save_weights`` / ``load_weights`` and ``save_checkpoint`` /
    ``load_checkpoint`` write and read ``batch_stats/...``: a fresh model
    from either file predicts as the trained one, and a resumed ``fit``
    continues as the uninterrupted one."""
    _, pm = _pair(name)
    x, y = _data(name, 200, seed=5)
    pm.fit(x, y, batch_size=64, epochs=1, verbose=0)
    pm.save_weights(tmp_path / "w.npz")
    pm.save_checkpoint(tmp_path / "c.npz", epoch=1)
    with np.load(tmp_path / "w.npz") as data:
        keys = set(data.files)
    assert {k for k in _leaves(pm)} == keys
    assert any(k.startswith("batch_stats/") for k in keys)
    want = pm.predict(x, 64)
    for load in ("load_weights", "load_checkpoint"):
        other = _build(name, tf, tmodels, device="cpu")
        other.compile("adam", "binary_crossentropy", metrics=["binary_crossentropy", "auc"])
        assert getattr(other, load)(tmp_path / ("w.npz" if load == "load_weights" else "c.npz")) \
            in (None, 1)
        np.testing.assert_array_equal(other.predict(x, 64), want)
        for k, v in _leaves(pm).items():
            np.testing.assert_array_equal(_leaves(other)[k], v, err_msg=k)
    fit = dict(batch_size=64, epochs=2, initial_epoch=1, verbose=0, shuffle=False)
    want = pm.fit(x, y, **fit).history
    got = other.fit(x, y, **fit).history
    assert got == want


def test_din_scores_through_the_scorer():
    """``tests/test_serving.py:46``'s check for the port: the Scorer over
    DIN's varlen history and length keys gives ``predict``'s scores; the
    statistics after ``fit`` are read live."""
    _, pm = _pair("DIN_bn")
    x, y = _data("DIN_bn", 200, seed=6)
    pm.fit(x, y, batch_size=64, epochs=1, verbose=0)
    got = Scorer(pm, batch_size=128).warmup().score(x)
    np.testing.assert_allclose(got, pm.predict(x, 128), rtol=1e-6)
    assert got.shape == (200, 1)


def test_din_lazy_split_matches_jax():
    """``tests/test_lazy_optimizer.py:412`` and ``tests/test_fused_lookup.py:
    110`` for the port: DIN under ``embedding_optimizer="lazy"`` (Adam,
    split, packed) has no linear model, so one singleton group holds its
    item/user table; it trains as the JAX model does (histories, weights
    and Dice's statistics at Adam's rtol 1e-4 / atol 2e-5, the row states
    rtol 1e-3), and a dense compile with ``fused_lookup=True`` fuses
    nothing.  Without the BatchNorm DNN, whose biases Adam would move by
    noise (see ``test_bn_model_fit_matches_jax``)."""
    from test_torch_port_lazy import MODES, _assert_states_close

    jm, pm = _pair("DIN")
    for m in (jm, pm):
        m.compile("adam", "binary_crossentropy", metrics=["binary_crossentropy"],
                  embedding_optimizer="lazy", **MODES["split_packed"])
    assert [len(g["members"]) for g in pm._lazy["groups"]] == [1]
    x, y = _data("DIN", 96, seed=7)
    want = jm.fit(x, y, batch_size=32, epochs=2, verbose=0, shuffle=False).history
    got = pm.fit(x, y, batch_size=32, epochs=2, verbose=0, shuffle=False).history
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_leaves_close(pm, jm, rtol=1e-4, atol=2e-5)
    _assert_states_close(pm, jm)
    pm.compile("adam", "binary_crossentropy", fused_lookup=True)
    assert pm._lazy is None and not hasattr(pm.module, "_fused")
    assert pm.fit(x, y, batch_size=32, epochs=1, verbose=0).history["loss"][0] > 0


def test_bn_model_constructor_errors_match_jax():
    for mod, models, kw in ((jf, jmodels, {}), (tf, tmodels, dict(device="cpu"))):
        with pytest.raises(ValueError, match="max length column"):
            models.DIN([c for c in _din_cols(mod, None) if c.name != "tags"], ["item"], **kw)
        mixed = _afn_cols(mod) + [mod.SparseFeat("C9", 10, 6)]
        with pytest.raises(ValueError, match="embedding_dim of SparseFeat"):
            models.AFN(mixed, mixed, **kw)


# -------------------------------------------- the kernels' fp32 boundary


def _boundary_case(name, rng):
    """(ops module, its plain forward's name, a call of the public wrapper
    on bf16 tensors that require grad)."""
    from xdeepfm_tpu_torch.ops import attention, attn_block, ce, cin, gru, lane_attention

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16() \
            .requires_grad_()

    if name == "cin":
        args = t(6, 3), t(6, 4), t(5, 12), t(5)
        return cin, "cin_rows_reference", lambda: cin.cin_rows_contract(*args), args
    if name == "ce":
        args = t(4, 3), t(7, 3), t(7)
        targets = torch.tensor([0, 3, 6, 2])
        return ce, "ce_rows_forward_reference", lambda: ce.fused_ce_rows(*args, targets), args
    if name == "small_attention":
        args = t(2, 3, 5), t(2, 3, 5), t(2, 3, 5)
        return attention, "sa_forward_reference", \
            lambda: attention.small_attention(*args, 0.5), args
    if name == "attn_block":
        args = (t(2, 4, 5), t(2, 4, 2), t(2, 4, 2), t(2, 4, 2), t(2, 2, 4), t(1, 4, 1),
                t(1, 4, 1), t(4, 4), t(4, 1), t(4, 1))
        cfg = attn_block.BlockCfg(1, 2, 0.5, True, True, 1e-5)
        return attn_block, "ab_forward_reference", lambda: attn_block.attn_block(cfg, *args), args
    if name == "lane_attention":
        args = t(2, 3, 4, 5), t(2, 3, 4, 5), t(2, 3, 4, 5)
        return lane_attention, "la_forward_reference", \
            lambda: lane_attention.lane_attention(*args, 1.0), args
    args = t(3, 4, 3, 2), t(3, 2, 2), t(3, 2), t(3, 4), t(3, 2)
    lengths = torch.tensor([4, 1, 0])
    return gru, "gru_forward_reference", \
        lambda: gru.gru_scan("augru", *args[:4], lengths, args[4]), args


@pytest.mark.parametrize("name", ["cin", "ce", "small_attention", "attn_block",
                                  "lane_attention", "gru"])
def test_kernel_boundaries_take_fp32_under_autocast(name, monkeypatch):
    """Under bf16 autocast (the bf16 mode's train step) each
    ``autograd.Function`` of ``ops/`` hands its kernel, here its plain
    version on the CPU, fp32 inputs with autocast off, as the Pallas
    kernels keep their own precision; it returns fp32, and its gradients
    reach the bf16 inputs in bf16."""
    module, ref, call, args = _boundary_case(name, np.random.default_rng(12))
    plain, seen = getattr(module, ref), []

    def record(*a, **kw):
        seen.append(([x.dtype for x in a if torch.is_tensor(x) and x.is_floating_point()],
                     torch.is_autocast_enabled("cpu")))
        return plain(*a, **kw)

    monkeypatch.setattr(module, ref, record)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = call()
    assert len(seen) == 1
    dtypes, autocast_on = seen[0]
    assert dtypes and set(dtypes) == {torch.float32} and not autocast_on
    assert out.dtype == torch.float32
    out.float().square().sum().backward()
    assert all(a.grad is not None and a.grad.dtype == torch.bfloat16 for a in args)
