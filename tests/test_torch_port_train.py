"""PyTorch port, training slice: ``fit`` and its parts against the JAX package.

The JAX model is compiled and its weights replaced by seeded numpy draws at
scale 0.1; the port receives them through ``from_jax_weights``, and both
train from there on the same numpy data.  Both sides are fp32 on the CPU;
each tolerance is stated where it is used.
"""

import jax
import numpy as np
import pytest
import torch

import xdeepfm_tpu.callbacks as jcb
import xdeepfm_tpu.features as jf
import xdeepfm_tpu.metrics as jm
import xdeepfm_tpu_torch.callbacks as tcb
import xdeepfm_tpu_torch.features as tf
import xdeepfm_tpu_torch.metrics as tm
from xdeepfm_tpu.basemodel import _loss_fn_single as jax_loss_fn
from xdeepfm_tpu.models import xDeepFM as JaxXDeepFM
from xdeepfm_tpu.ops import cin_pallas as cp
from xdeepfm_tpu.ops.cin import set_cin_backend
from xdeepfm_tpu_torch.basemodel import _loss_fn_single
from xdeepfm_tpu_torch.models import xDeepFM
from xdeepfm_tpu_torch.ops.cin_cuda import cin_rows_backward, cin_rows_dw, cin_rows_forward
from xdeepfm_tpu_torch.optimizers import get_optimizer
from xdeepfm_tpu_torch.weights import flatten_tree

N_SPARSE, VOCAB, DIM, N_DENSE = 4, 50, 8, 2
ARCH = dict(dnn_hidden_units=(16, 16), cin_layer_size=(8, 6))
METRICS = ["binary_crossentropy", "auc"]
FIT = dict(batch_size=64, epochs=2, verbose=1, validation_split=0.2, shuffle=True)


def _cols(mod):
    return [mod.SparseFeat(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)] + [
        mod.DenseFeat(f"I{i}") for i in range(N_DENSE)
    ]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
    y = (rng.uniform(size=n) < 0.3).astype(np.float32)
    return x, y


def _pair(optimizer, **kw):
    jm_ = JaxXDeepFM(_cols(jf), _cols(jf), **ARCH, **kw)
    jm_.compile(optimizer, "binary_crossentropy", metrics=METRICS)
    rng = np.random.default_rng(1)
    w = jm_.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"]
    )
    jm_.set_weights(w)
    pm = xDeepFM(_cols(tf), _cols(tf), device="cpu", **ARCH, **kw)
    pm.set_weights(w)
    pm.compile(optimizer, "binary_crossentropy", metrics=METRICS)
    return jm_, pm


def _assert_weights_close(pm, jm_, rtol, atol):
    want = dict(flatten_tree(jm_.get_weights()["params"]))
    got = dict(flatten_tree(pm.get_weights()["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol, atol=atol, err_msg=k)


# Per optimizer: (rtol, atol) for the History logs and the weights after two
# epochs (8 steps).  Both sides sum the same fp32 terms in other orders
# (~1e-7 relative per step); adam, adagrad and rmsprop divide by the root of
# small second moments, which magnifies that noise in weights whose
# gradients are near 0, so their weight atol is larger than sgd's.
OPT_TOL = {
    "sgd": (1e-5, 1e-6),
    "adam": (1e-4, 2e-5),
    "adagrad": (1e-4, 2e-5),
    "rmsprop": (1e-4, 2e-5),
}


@pytest.mark.parametrize("optimizer", sorted(OPT_TOL))
def test_fit_matches_jax(optimizer):
    rtol, atol = OPT_TOL[optimizer]
    jm_, pm = _pair(optimizer)
    x, y = _data(300)  # 240 train rows = 3 batches of 64 and a tail of 48
    want = jm_.fit(x, y, **FIT).history
    got = pm.fit(x, y, **FIT).history
    assert sorted(got) == sorted(want) == sorted(
        ["loss", "val_binary_crossentropy", "val_auc"] + METRICS
    )
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-6, err_msg=k)
    _assert_weights_close(pm, jm_, rtol, atol)
    assert cin_rows_forward.launches == cin_rows_backward.launches == cin_rows_dw.launches == 0


def test_fit_matches_jax_pallas_cin():
    """The JAX side's CIN on the Pallas kernels (interpret mode), forward and
    fused backward, with L2 on every registered group."""
    reg = dict(l2_reg_linear=1e-3, l2_reg_embedding=1e-3, l2_reg_dnn=1e-3, l2_reg_cin=1e-3)
    jm_, pm = _pair("adam", **reg)
    x, y = _data(300, seed=3)
    set_cin_backend("pallas")
    cp.set_interpret(True)
    try:
        want = jm_.fit(x, y, **FIT).history
    finally:
        cp.set_interpret(False)
        set_cin_backend("auto")
    got = pm.fit(x, y, **FIT).history
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_weights_close(pm, jm_, 1e-4, 2e-5)


def test_fit_without_shuffle_or_validation_and_with_callbacks(capsys):
    jm_, pm = _pair("sgd")
    x, y = _data(150, seed=4)
    kw = dict(batch_size=64, epochs=3, verbose=0, shuffle=False)
    stops = [jcb.EarlyStopping(monitor="loss", patience=0, min_delta=10.0)]
    want = jm_.fit(x, y, callbacks=stops, **kw).history
    got = pm.fit(
        x, y, callbacks=[tcb.EarlyStopping(monitor="loss", patience=0, min_delta=10.0)], **kw
    ).history
    assert list(want) == list(got) == ["loss"]  # verbose=0: no train metrics
    assert len(got["loss"]) == len(want["loss"]) == 2  # stopped after epoch 2
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    out = capsys.readouterr().out
    assert "Train on 150 samples, validate on 0 samples, 3 steps per epoch" in out


def test_fit_with_validation_data_initial_epoch_and_steps_per_dispatch():
    jm_, pm = _pair("adam")
    x, y = _data(200, seed=5)
    vx, vy = _data(70, seed=6)
    kw = dict(batch_size=64, epochs=3, initial_epoch=1, validation_data=(vx, vy))
    want = jm_.fit(x, y, **kw).history
    got = pm.fit(x, y, steps_per_dispatch=2, **kw).history  # changes no result
    for k in want:
        assert len(got[k]) == 2
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_compile_options():
    _, pm = _pair("adam")
    pm.compile("adam", "binary_crossentropy", embedding_optimizer="lazy")  # split, packed
    assert pm._lazy["split"] and pm._lazy["packed"]
    assert all(id(p) != id(pm.module.embedding_dict.table_d8)
               for group in pm.optimizer.param_groups for p in group["params"])
    pm.compile("adam", "binary_crossentropy")
    assert pm._lazy is None
    with pytest.raises(ValueError):
        pm.compile("adam", "binary_crossentropy", embedding_layout="packed")
    pm.compile("adam", "binary_crossentropy", embedding_optimizer="auto")  # dense here
    assert isinstance(pm.optimizer, torch.optim.Adam)
    pm.compile(lambda ps: torch.optim.SGD(ps, lr=0.5), "binary_crossentropy")
    assert pm.optimizer.param_groups[0]["lr"] == 0.5
    with pytest.raises(RuntimeError, match="compile"):
        xDeepFM(_cols(tf), _cols(tf), device="cpu", **ARCH).fit(*_data(10))


@pytest.mark.parametrize("name", ["sgd", "adam", "adagrad", "rmsprop"])
def test_optimizer_defaults_match_jax(name):
    """One update of each optimizer from the same gradient, against optax
    through the JAX package's ``_get_optimizer``."""
    import optax

    from xdeepfm_tpu.basemodel import _get_optimizer

    rng = np.random.default_rng(8)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]
    opt = _get_optimizer(name)
    params = jax.numpy.asarray(w0)
    state = opt.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = get_optimizer(name, [p])
    for g in grads:
        updates, state = opt.update(jax.numpy.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-6, atol=1e-7)


def test_losses_match_jax_near_0_and_1():
    p = np.array([0.0, 1e-12, 1e-7, 3e-7, 0.5, 1 - 3e-7, 1 - 1e-8, 1.0], np.float32)
    y = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.float32)
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 1], np.float32)
    for name in ("binary_crossentropy", "mse", "mae"):
        want = float(jax_loss_fn(name)(*map(jax.numpy.asarray, (p, y, mask))))
        got = float(_loss_fn_single(name)(*map(torch.from_numpy, (p, y, mask))))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


def test_regularization_total_matches_jax():
    reg = dict(l2_reg_linear=1e-2, l2_reg_embedding=1e-3, l2_reg_dnn=1e-4, l2_reg_cin=1e-5)
    jm_, pm = _pair("adam", **reg)
    want = float(jm_._regularization_loss(jm_.params))
    got = pm._regularization_loss().item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    names = {id(q): n for n, q in pm.module.named_parameters()}
    coef = {names[id(q)]: l2 for q, _, l2 in pm._reg_terms}
    # the linear table matches "embedding_dict/" and "linear_model/"
    assert coef["linear_model.embedding_dict.table_d1"] == pytest.approx(1e-2 + 1e-3)
    assert coef["embedding_dict.table_d8"] == pytest.approx(1e-3)
    assert coef["dnn.linear_0.weight"] == pytest.approx(1e-4)  # a flax "kernel"
    assert coef["dnn_linear.weight"] == pytest.approx(1e-4)
    assert "dnn.linear_0.bias" not in coef
    assert coef["cin.conv_w_1"] == pytest.approx(1e-5)


@pytest.mark.parametrize("name", sorted(jm.DEVICE_METRICS))
def test_device_metrics_match_jax(name):
    rng = np.random.default_rng(9)
    y = (rng.uniform(size=256) < 0.3).astype(np.float32)
    p = np.round(rng.uniform(size=256), 2).astype(np.float32)  # ties
    mask = np.ones(256, np.float32)
    mask[200:] = 0.0  # a padded tail
    assert sorted(tm.DEVICE_METRICS) == sorted(jm.DEVICE_METRICS)
    for yy in (y, np.zeros_like(y)):  # one class only: AUC is 0.5
        want = float(jm.DEVICE_METRICS[name](*map(jax.numpy.asarray, (yy, p, mask))))
        got = float(tm.DEVICE_METRICS[name](*map(torch.from_numpy, (yy, p, mask))))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


class _Model:
    """The callbacks' view of a model: weights, stop_training, save_weights."""

    def __init__(self):
        self.stop_training = False
        self.w = 0
        self.saved = []

    def get_weights(self):
        return self.w

    def set_weights(self, w):
        self.w = w

    def save_weights(self, path):
        self.saved.append(path)


LOGS = [{"val_loss": v, "val_auc": 1 - v} for v in (0.5, 0.4, 0.45, 0.41, 0.39, 0.6, 0.7)]


@pytest.mark.parametrize(
    "kw",
    [dict(patience=1), dict(patience=2, min_delta=0.02), dict(monitor="val_auc", patience=2),
     dict(patience=2, restore_best_weights=True), dict(patience=1, baseline=0.3)],
)
def test_early_stopping_and_history_match_jax(kw):
    runs = []
    for mod in (jcb, tcb):
        model = _Model()
        cbs = mod.CallbackList([mod.EarlyStopping(**kw), mod.History()])
        cbs.set_model(model)
        cbs.on_train_begin()
        for epoch, logs in enumerate(LOGS):
            model.w = epoch
            cbs.on_epoch_end(epoch, logs)
            if model.stop_training:
                break
        cbs.on_train_end()
        stop, hist = cbs.callbacks
        runs.append((epoch, model.w, stop.best, stop.wait, hist.epoch, hist.history))
    assert runs[0] == runs[1]


def test_model_checkpoint_falls_back_to_save_weights():
    model = _Model()
    ck = tcb.ModelCheckpoint("w{epoch}.npz", save_best_only=True)
    ck.set_model(model)
    for epoch, logs in enumerate(LOGS[:3]):
        ck.on_epoch_end(epoch, logs)
    assert model.saved == ["w1.npz", "w2.npz"]  # epoch 3 did not improve
