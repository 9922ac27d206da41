"""PyTorch port, DIEN slice: the model against the JAX package's, for all
four ``gru_type``s, with negative sampling on and off (the layers are in
``tests/test_torch_port_dien.py``).

The data is ``tests/test_sequence_models.py``'s kind at B 16-64, T 6, emb 4
(lengths 1..6, padded ids 0, labels ``item % 2``).  The JAX model is compiled
and its weights replaced by seeded numpy draws at scale 0.5; the port
receives them through ``set_weights``, and both run fp32 on the CPU on the
same numpy data.  Where a test takes the ``interpret`` fixture the JAX
recurrences run their Pallas kernels in interpret mode; elsewhere they run
the JAX ``lax.scan``, as ``tests/test_sequence_models.py`` runs DIEN.  The
port on a CPU tensor takes its ``gru_scan`` (the kernels' plain versions).

Tolerances: predictions and the aux loss rtol 1e-5, atol 1e-6; one SGD
step's weight changes within 1e-4 of each parameter's largest change plus
two fp32 roundings of its largest weight; the ``fit`` histories rtol 1e-4,
atol 1e-6 and the weights after it within 1e-5.  ``fit`` runs SGD: under
adam the attention's biases, whose gradient the softmax over T cancels to
rounding noise, would move by noise-driven lr-sized steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xdeepfm_tpu.features as jf
import xdeepfm_tpu_torch.features as tf
from xdeepfm_tpu.models import DIEN as JaxDIEN
from xdeepfm_tpu.ops import gru_pallas
from xdeepfm_tpu_torch.models import DIEN
from xdeepfm_tpu_torch.ops import gru_cuda
from xdeepfm_tpu_torch.serving import Scorer
from xdeepfm_tpu_torch.weights import canonical_paths, flatten_tree

GRU_TYPES = ["GRU", "AIGRU", "AGRU", "AUGRU"]
VOCAB, MAXLEN, EMB = 12, 6, 4
ARCH = dict(dnn_hidden_units=(16, 8), att_hidden_units=(8, 4))


@pytest.fixture
def interpret():
    gru_pallas.set_interpret(True)
    try:
        yield
    finally:
        gru_pallas.set_interpret(False)


def _cols(mod, with_neg=True, length_name="seq_length"):
    def hist(name):
        return mod.VarLenSparseFeat(mod.SparseFeat(name, VOCAB, EMB, embedding_name="item"),
                                    maxlen=MAXLEN, length_name=length_name)

    cols = [mod.SparseFeat("user", VOCAB, EMB), mod.SparseFeat("item", VOCAB, EMB),
            mod.DenseFeat("score", 1), hist("hist_item")]
    return cols + [hist("neg_hist_item")] if with_neg else cols


def _data(n, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, MAXLEN + 1, n)
    pad = np.arange(MAXLEN)[None, :] < lengths[:, None]
    x = {"user": rng.integers(0, VOCAB, n), "item": rng.integers(0, VOCAB, n),
         "score": rng.uniform(0, 1, n).astype(np.float32), "seq_length": lengths,
         "hist_item": rng.integers(1, VOCAB, (n, MAXLEN)) * pad,
         "neg_hist_item": rng.integers(1, VOCAB, (n, MAXLEN)) * pad}
    return x, (x["item"] % 2).astype(np.float32)


def _pair(gru_type, with_neg=True, optimizer="adam", **kw):
    """(JAX model, port model) with the same random weights (scale 0.5)."""
    args = dict(gru_type=gru_type, use_negsampling=with_neg, **ARCH, **kw)
    jm = JaxDIEN(_cols(jf, with_neg), ["item"], **args)
    jm.compile(optimizer, "binary_crossentropy", metrics=["binary_crossentropy", "auc"])
    rng = np.random.default_rng(1)
    w = jm.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (0.5 * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"])
    jm.set_weights(w)
    pm = DIEN(_cols(tf, with_neg), ["item"], device="cpu", **args)
    pm.set_weights(jm.get_weights())
    pm.compile(optimizer, "binary_crossentropy", metrics=["binary_crossentropy", "auc"])
    return jm, pm


def _assert_no_launches():
    assert gru_cuda.gru_forward.launches == 0 and gru_cuda.gru_backward.launches == 0


CASES = [(t, True) for t in GRU_TYPES] + [("AUGRU", False), ("GRU", False)]


@pytest.mark.parametrize("gru_type,with_neg", CASES)
def test_dien_predict_and_aux_loss_match_jax(interpret, gru_type, with_neg):
    """Predictions, and the auxiliary loss of one training forward (dropout
    is off), which the port computes only when training."""
    jm, pm = _pair(gru_type, with_neg, alpha=0.7)
    x, _ = _data(40, seed=2)
    got, want = pm.predict(x, 16), jm.predict(x, 16)
    assert got.dtype == np.float64 and got.shape == (40, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert want.std() > 1e-3
    packed = jm.schema.pack(x)
    want = jm.module.apply({"params": jm.params}, {k: jnp.asarray(v) for k, v in packed.items()},
                           training=True, rngs={"dropout": jax.random.PRNGKey(0)})["aux_loss"]
    batch = {k: torch.from_numpy(v) for k, v in pm.schema.pack(x).items()}
    with torch.no_grad():
        got = pm.module(batch, training=True)["aux_loss"]
        assert float(pm.module(batch, training=False)["aux_loss"]) == 0.0
    assert (float(want) > 0.1) == with_neg
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    _assert_no_launches()


def _first_batch_delta(model, x, y, n):
    """(weight change of one step, largest |weight| before it) per path."""
    before = {k: v.copy() for k, v in flatten_tree(model.get_weights()["params"])}
    model.fit({k: v[:n] for k, v in x.items()}, y[:n], batch_size=n, epochs=1, verbose=0,
              shuffle=False)
    after = dict(flatten_tree(model.get_weights()["params"]))
    return {k: (np.asarray(after[k]) - before[k], np.abs(before[k]).max()) for k in before}


@pytest.mark.parametrize("gru_type,with_neg", CASES)
def test_dien_sgd_step_and_fit_match_jax(gru_type, with_neg):
    """One SGD step from the same weights (sum-BCE, the L2 registry and the
    aux loss): the weight changes are lr times the gradients, each within
    1e-4 of its largest change plus the rounding of reading a change as the
    difference of two fp32 weights.  Then two more epochs of ``fit`` (SGD,
    shuffled, a tail batch, validation): the histories and the weights."""
    jm, pm = _pair(gru_type, with_neg, "sgd", l2_reg_dnn=1e-3)
    x, y = _data(80, seed=3)  # 64 train rows: 3 batches of 20 and a tail of 4
    want = _first_batch_delta(jm, x, y, 20)
    got = _first_batch_delta(pm, x, y, 20)
    assert sorted(got) == sorted(want)
    assert np.abs(want["interest_extractor/gru/weight_hh"][0]).max() > 0
    ulp = 2 * np.finfo(np.float32).eps
    for k, (delta, size) in want.items():
        np.testing.assert_allclose(got[k][0], delta, rtol=1e-4,
                                   atol=1e-4 * np.abs(delta).max() + ulp * size + 1e-8, err_msg=k)
    fit = dict(batch_size=20, epochs=2, verbose=0, validation_split=0.2, shuffle=True)
    want = jm.fit(x, y, **fit).history
    got = pm.fit(x, y, **fit).history
    assert sorted(got) == sorted(want) and "val_auc" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    want_w = dict(flatten_tree(jm.get_weights()["params"]))
    for k, v in flatten_tree(pm.get_weights()["params"]):
        np.testing.assert_allclose(v, np.asarray(want_w[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    _assert_no_launches()


def test_dien_l2_registry_matches_jax():
    """``("dnn/", "/kernel")`` reaches the top DNN and the attention MLP
    (``interest_evolution/attention/local_att/dnn/...``), not the aux net."""
    jm, pm = _pair("AUGRU", l2_reg_embedding=2e-3, l2_reg_dnn=3e-3)
    want = {p: jm._reg_coeffs_for(p) for p, _ in flatten_tree(jm.get_weights()["params"])}
    want = {p: c for p, c in want.items() if c != (0.0, 0.0)}
    paths = canonical_paths(pm.module)
    names = {id(p): n for n, p in pm.module.named_parameters()}
    got = {paths[names[id(p)]]: (l1, l2) for p, l1, l2 in pm._regularization_terms()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    assert "interest_evolution/attention/local_att/dnn/linear_0/kernel" in got
    assert not any("auxiliary_net" in k for k in got)
    np.testing.assert_allclose(pm._regularization_loss().item(),
                               float(jm._regularization_loss(jm.params)), rtol=1e-5)


@pytest.mark.parametrize("gru_type", GRU_TYPES)
def test_dien_weights_round_trip(gru_type):
    jm, pm = _pair(gru_type)
    want = dict(flatten_tree(jm.get_weights()["params"]))
    got = dict(flatten_tree(pm.get_weights()["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    evo = ("interest_evolution/interest_evolution/weight_hh" if gru_type in ("GRU", "AIGRU")
           else "interest_evolution/interest_evolution/rnn/weight_hh")
    for k in (evo, "interest_extractor/gru/bias_ih", "interest_extractor/auxiliary_net/linear_2/kernel",
              "interest_evolution/attention/local_att/dense/kernel", "linear/kernel",
              "embedding_dict/table_d4"):
        assert k in got, k


def test_dien_scores_through_the_scorer_and_checks_its_inputs():
    """``Scorer.warmup`` builds a batch with the varlen fields; the errors
    match the JAX model's; no GPU means ``device=None`` raises.  (Dice
    attention, which raised here before, is in
    ``test_dien_dice_attention_and_bn_dnn_match_jax``.)"""
    _, pm = _pair("AUGRU")
    x, _ = _data(37, seed=6)
    scorer = Scorer(pm, batch_size=16).warmup()
    np.testing.assert_allclose(scorer.score(x), pm.predict(x, 16), rtol=1e-6)
    with pytest.raises(ValueError, match="max length column"):
        DIEN(_cols(tf, length_name=None), ["item"], device="cpu")
    with pytest.raises(NotImplementedError, match="gru_type"):
        DIEN(_cols(tf), ["item"], gru_type="LSTM", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DIEN(_cols(tf), ["item"])


@pytest.mark.parametrize("gru_type", GRU_TYPES)
def test_dien_dice_attention_and_bn_dnn_match_jax(interpret, gru_type):
    """DIEN with ``att_activation="Dice"`` (the JAX model's batch-major
    fallback, ``dien.py:167-190``) and ``use_bn=True``, negative sampling
    on: the predictions with random running statistics; one SGD step's
    weight and statistics changes (``tests/test_torch_port_bn_models.py``'s
    step check); the statistics and weights after a ``fit`` ending on a
    partial batch (SGD, rtol 1e-4, atol 1e-5)."""
    from test_torch_port_bn_models import _leaves, assert_sgd_step_matches

    jm, pm = _pair(gru_type, True, "sgd", att_activation="Dice", use_bn=True, l2_reg_dnn=1e-3)
    rng = np.random.default_rng(9)
    w = jm.get_weights()
    w["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, np.shape(v)) if "var" in jax.tree_util.keystr(path)
                         else 0.3 * rng.standard_normal(np.shape(v))).astype(np.float32),
        w["batch_stats"])
    stats = sorted(k for k, _ in flatten_tree(w["batch_stats"]))
    assert "interest_evolution/attention/local_att/dnn/act_0/bn/mean" in stats
    assert "dnn/bn_1/var" in stats
    for m in (jm, pm):
        m.set_weights(w)
    x, y = _data(40, seed=10)
    want = jm.predict(x, 16)
    np.testing.assert_allclose(pm.predict(x, 16), want, rtol=1e-5, atol=1e-6)
    assert want.std() > 1e-3
    x, y = _data(80, seed=11)  # 64 train rows: 3 batches of 20 and a tail of 4
    delta = assert_sgd_step_matches(jm, pm, x, y, 20)
    assert all(np.abs(delta[f"batch_stats/{k}"]).max() > 0 for k in stats)
    fit = dict(batch_size=20, epochs=2, verbose=0, validation_split=0.2, shuffle=True)
    want, got = jm.fit(x, y, **fit).history, pm.fit(x, y, **fit).history
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    want, got = _leaves(jm), _leaves(pm)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    _assert_no_launches()
