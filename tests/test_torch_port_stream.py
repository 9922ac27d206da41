"""The port's ``fit_stream`` against the JAX package's, on the same batch stream.

Each case of ``tests/test_stream.py`` (``matches_fit`` :35,
``multi_dispatch_and_validation`` :63, ``steps_per_epoch_cap`` :78 and
``callbacks_early_stopping`` :92) runs on both packages: a small xDeepFM
(the port has no DeepFM yet) is compiled in JAX, its weights go to the port
through ``from_jax_weights``, and both train from there on the same numpy
batches.  Their histories and final weights must agree within
``tests/test_torch_port_train.py``'s Adam tolerance (``OPT_TOL``: fp32 sums in
another order, magnified by Adam's division by small second moments), and
each must keep its own case's property (the trajectory of ``fit``, falling
loss, the cap, the early stop).
"""

import threading

import jax
import numpy as np
import pytest

import xdeepfm_tpu.callbacks as jcb
import xdeepfm_tpu.features as jf
import xdeepfm_tpu_torch.callbacks as tcb
import xdeepfm_tpu_torch.features as tf
from xdeepfm_tpu.models import xDeepFM as JaxXDeepFM
from xdeepfm_tpu_torch.models import xDeepFM
from xdeepfm_tpu_torch.weights import flatten_tree

RTOL, ATOL = 1e-4, 2e-5  # OPT_TOL["adam"] of tests/test_torch_port_train.py
ARCH = dict(dnn_hidden_units=(8,), cin_layer_size=(4,), seed=5)


def _data(n=300, vocab=40, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, vocab, n) for i in range(3)}
    x["I0"] = rng.uniform(0, 1, n).astype(np.float32)
    y = (x["C0"] % 2).astype(np.float32)
    return x, y


def _cols(mod, vocab=40):
    return [mod.SparseFeat(f"C{i}", vocab, 8) for i in range(3)] + [mod.DenseFeat("I0")]


def _batches(x, y, bs, seen=None):
    for i in range(0, len(y), bs):
        if seen is not None:
            seen.append(len(y[i:i + bs]))
        yield {k: v[i:i + bs] for k, v in x.items()}, y[i:i + bs]


def _pair(lr=None):
    jm = JaxXDeepFM(_cols(jf), _cols(jf), **ARCH)
    jm.compile("adam", "binary_crossentropy", metrics=["auc"], lr=lr)
    pm = xDeepFM(_cols(tf), _cols(tf), device="cpu", **ARCH)
    pm.set_weights(jax.tree.map(np.asarray, jm.get_weights()))
    pm.compile("adam", "binary_crossentropy", metrics=["auc"], lr=lr)
    return jm, pm


def _weights(model):
    return dict(flatten_tree(model.get_weights()["params"]))


def _check_same(jm, pm, hj, hp):
    assert sorted(hp.history) == sorted(hj.history)
    for k in hj.history:
        np.testing.assert_allclose(hp.history[k], hj.history[k], rtol=RTOL, atol=1e-6,
                                   err_msg=k)
    want, got = _weights(jm), _weights(pm)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _case(name, model, cb_mod, x, y, seen):
    """Run ``tests/test_stream.py``'s case ``name`` on ``model``."""
    if name == "matches_fit":
        return model.fit_stream(lambda epoch: _batches(x, y, 64), epochs=2, verbose=2)
    if name == "multi_dispatch_and_validation":
        return model.fit_stream(lambda e: _batches(x, y, 50), epochs=3, verbose=0,
                                steps_per_dispatch=4, validation_data=(x, y))
    if name == "steps_per_epoch_cap":
        return model.fit_stream(lambda e: _batches(x, y, 50, seen), epochs=1, verbose=0,
                                steps_per_epoch=3)
    es = cb_mod.EarlyStopping(monitor="val_auc", patience=0, mode="max")
    return model.fit_stream(lambda e: _batches(x, y, 64), epochs=20, verbose=0,
                            validation_data=(x, y), callbacks=[es])


@pytest.mark.parametrize("case", ["matches_fit", "multi_dispatch_and_validation",
                                  "steps_per_epoch_cap", "callbacks_early_stopping"])
def test_fit_stream_matches_jax(case):
    x, y = _data()
    # the early stop needs val_auc to stop rising within 20 epochs: at Adam's
    # 0.01 this xDeepFM learns y = C0 % 2 to an AUC of 1 within a few
    jm, pm = _pair(lr=0.01 if case == "callbacks_early_stopping" else None)
    seen_j, seen_p = [], []
    hj = _case(case, jm, jcb, x, y, seen_j)
    hp = _case(case, pm, tcb, x, y, seen_p)
    _check_same(jm, pm, hj, hp)
    if case == "matches_fit":
        # and the port's fit on the same rows, in file order, takes the
        # same trajectory (300 rows: 4 batches of 64 and a tail of 44)
        _, ref = _pair()
        hf = ref.fit(x, y, batch_size=64, epochs=2, verbose=2, shuffle=False)
        for k in hf.history:
            np.testing.assert_allclose(hp.history[k], hf.history[k], rtol=1e-6, err_msg=k)
    elif case == "multi_dispatch_and_validation":
        assert len(hp.history["loss"]) == 3
        assert hp.history["loss"][-1] < hp.history["loss"][0]
        assert hp.history["val_auc"][-1] > 0.8
    elif case == "steps_per_epoch_cap":
        assert seen_p == seen_j == [50, 50, 50]
    else:
        assert len(hp.history["loss"]) < 20


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "fit_stream-prefetch"]


def test_generator_exception_reaches_the_caller_and_the_thread_exits():
    x, y = _data(100)
    _, pm = _pair()

    def bad(epoch):
        yield from _batches(x, y, 32)
        raise OSError("parse failed")

    with pytest.raises(OSError, match="parse failed"):
        pm.fit_stream(bad, epochs=1, verbose=0)
    assert _prefetch_threads() == []


def test_early_break_stops_the_prefetch_thread():
    x, y = _data(64)
    _, pm = _pair()

    def endless(epoch):
        while True:
            yield from _batches(x, y, 32)

    h = pm.fit_stream(endless, epochs=2, verbose=0, steps_per_epoch=2, prefetch=2)
    assert len(h.history["loss"]) == 2
    assert _prefetch_threads() == []


def test_consumer_error_stops_the_prefetch_thread():
    """A batch larger than the stream's first raises in the consumer; the
    read-ahead thread has exited when the error reaches the caller."""
    x, y = _data(200)
    _, pm = _pair()

    def growing(epoch):
        yield from _batches(x, y, 32)
        yield from _batches(x, y, 64)

    with pytest.raises(ValueError, match="exceeds the stream's batch size"):
        pm.fit_stream(growing, epochs=1, verbose=0, prefetch=2)
    assert _prefetch_threads() == []
