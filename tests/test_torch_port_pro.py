"""PyTorch port, Pro slice: xDeepFMPro / xDeepFMProLight, the SFG decoder
and AutoDis against the JAX package.

Weights are carried from the JAX side with ``from_jax_weights``; inputs are
drawn from a numpy seed and handed to both.  Both sides run fp32 on the CPU,
dropout off.  Where the JAX side takes its CE kernels (``impl="pallas"``),
they run in interpret mode at fp32, the port's default.  Tolerances: values
within 1e-5 relative (1e-6 absolute), each gradient within 1e-4 of its
largest entry, and the fit histories and weights as in
``test_torch_port_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xdeepfm_tpu.features as jf
import xdeepfm_tpu_torch.features as tf
from xdeepfm_tpu.ops import ce_pallas as cp
from xdeepfm_tpu.pro import xDeepFMPro as JaxPro
from xdeepfm_tpu.pro import xDeepFMProLight as JaxProLight
from xdeepfm_tpu.pro.autodis import AutoDisLayer as JaxAutoDis
from xdeepfm_tpu.pro.sfg import LabelAwareAttention as JaxLabelAttention
from xdeepfm_tpu.pro.sfg import SFGDecoder as JaxDecoder
from xdeepfm_tpu.pro.sfg import sfg_loss as jax_sfg_loss
from xdeepfm_tpu.pro.sfg import sfg_loss_rows as jax_sfg_loss_rows
from xdeepfm_tpu_torch.ops import ce
from xdeepfm_tpu_torch.ops.ce_cuda import ce_rows_forward
from xdeepfm_tpu_torch.pro import (
    AutoDisLayer,
    LabelAwareAttention,
    SFGDecoder,
    SFGLoss,
    sfg_loss,
    xDeepFMPro,
    xDeepFMProLight,
)
from xdeepfm_tpu_torch.pro.sfg import sfg_loss_rows
from xdeepfm_tpu_torch.serving import Scorer
from xdeepfm_tpu_torch.weights import canonical_paths, flatten_tree, from_jax_weights

N_SPARSE, VOCAB, DIM, N_DENSE = 4, 30, 4, 3
ARCH = dict(dnn_hidden_units=(8,), cin_layer_size=(4, 4), sfg_hidden_units=(8, 6),
            sfg_dropout=0.0)
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL = 1e-4


def _close_to_max(got, want, err_msg="", rtol=GRAD_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max() + 1e-8, err_msg=err_msg)


def _cols(mod):
    return [mod.SparseFeat(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)] + [
        mod.DenseFeat(f"I{i}") for i in range(N_DENSE)
    ]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
    return x, (rng.uniform(size=n) < 0.4).astype(np.float32)


def _randomize(jax_model, seed=1):
    rng = np.random.default_rng(seed)
    w = jax_model.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"]
    )
    jax_model.set_weights(w)


def _pair(optimizer="adam", light=False, **kw):
    """(JAX model, port model) with the same random weights."""
    jcls, tcls = (JaxProLight, xDeepFMProLight) if light else (JaxPro, xDeepFMPro)
    arch = {} if light else ARCH
    jm = jcls(_cols(jf), _cols(jf), **arch, **kw)
    jm.compile(optimizer, "binary_crossentropy", metrics=["binary_crossentropy", "auc"])
    _randomize(jm)
    pm = tcls(_cols(tf), _cols(tf), device="cpu", **arch, **kw)
    pm.set_weights(jm.get_weights())
    pm.compile(optimizer, "binary_crossentropy", metrics=["binary_crossentropy", "auc"])
    return jm, pm


def _vars_to_port(module, variables):
    module.load_state_dict(from_jax_weights({"params": variables["params"]}), strict=True)
    return module


def _port_grads(module):
    """{JAX path: gradient in the JAX layout} of a port module."""
    paths = canonical_paths(module)
    out = {}
    for name, p in module.named_parameters():
        g = p.grad.numpy()
        out[paths[name]] = g.T if paths[name].endswith("/kernel") else g
    return out


# ------------------------------------------------------------------ layers


def test_label_aware_attention_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 10)).astype(np.float32)
    labels = rng.integers(0, 2, (12, 1)).astype(np.float32)
    jmod = JaxLabelAttention(input_dim=10, hidden_dim=6)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(labels))
    _randomize_vars = jax.tree.map(lambda v: v * 3.0, variables)  # move every weight
    want = jmod.apply(_randomize_vars, jnp.asarray(x), jnp.asarray(labels))
    pmod = _vars_to_port(LabelAwareAttention(10, 6), _randomize_vars)
    got = pmod(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert sorted(dict(pmod.named_parameters())) == [
        "att1.bias", "att1.weight", "att2.bias", "att2.weight", "label_embedding"
    ]


def test_autodis_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 2, (9, 3)).astype(np.float32)
    jmod = JaxAutoDis(num_features=3, num_buckets=5, embedding_dim=4, temperature=0.7)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = jax.tree.map(lambda v: v + 0.3 * jnp.ones_like(v), variables)
    pmod = _vars_to_port(AutoDisLayer(3, 5, 4, 0.7), variables)
    for name, shape in (("proj_w1", (3, 1, 5)), ("proj_w2", (3, 5, 5)),
                        ("meta_embeddings", (3, 5, 4)), ("feature_temperatures", (3,))):
        assert tuple(getattr(pmod, name).shape) == shape
    want_flat, want_emb = jmod.apply(variables, jnp.asarray(x))
    got_flat, got_emb = pmod(torch.from_numpy(x))
    np.testing.assert_allclose(got_flat.detach().numpy(), np.asarray(want_flat), **TOL)
    np.testing.assert_allclose(got_emb.detach().numpy(), np.asarray(want_emb), **TOL)
    np.testing.assert_array_equal(pmod.bucket_indices(torch.from_numpy(x)).numpy(),
                                  np.asarray(jmod.bucket_indices(jnp.asarray(x), variables)))
    empty = AutoDisLayer(0, 4, 5)(torch.zeros(6, 0))
    assert empty[0].shape == (6, 0) and empty[1].shape == (6, 0, 5)


# --------------------------------------------------------------- SFG decoder

B_DEC, F_DEC, E_DEC, D_DEC = 24, 3, 4, 2
VOCABS = {
    "one_bucket": (("C0", 7), ("C1", 5), ("C2", 9)),  # all pad to 128
    "mixed": (("C0", 50), ("C1", 300), ("C2", 100)),  # a stacked pair and a single head
}


def _decoder_case(vocab_key, seed=23):
    rng = np.random.default_rng(seed)
    vocabs = VOCABS[vocab_key]
    emb = rng.normal(size=(B_DEC, F_DEC, E_DEC)).astype(np.float32)
    dense = rng.normal(size=(B_DEC, D_DEC)).astype(np.float32)
    labels = rng.integers(0, 2, (B_DEC, 1)).astype(np.float32)
    sample_mask = (np.arange(B_DEC) < B_DEC - 3).astype(np.float32)  # padded tail
    targets = {name: rng.integers(0, v, B_DEC) for name, v in vocabs}
    jdec = JaxDecoder(embedding_dim=E_DEC, sparse_vocab_sizes=vocabs, num_dense=D_DEC,
                      hidden_units=(8, 6), dropout_rate=0.0)
    variables = jdec.init(jax.random.PRNGKey(3), jnp.asarray(emb), jnp.asarray(dense),
                          jnp.asarray(labels))
    pdec = _vars_to_port(SFGDecoder(E_DEC, vocabs, D_DEC, hidden_units=(8, 6), dropout_rate=0.0),
                         variables)
    return jdec, variables, pdec, emb, dense, labels, sample_mask, targets


# (port impl, JAX impl, stacked heads, row mask): the JAX ce_rows has "remat"
# and "pallas"; the port's "materialized" is JAX's sfg_fused_ce=False path
CE_IMPLS = [
    ("materialized", "remat", True, False),
    ("remat", "remat", True, False),
    ("pallas", "pallas", True, False),
    ("pallas", "pallas", True, True),
    ("pallas", "pallas", False, True),
]


@pytest.mark.parametrize("vocab_key", sorted(VOCABS))
@pytest.mark.parametrize("impl,jax_impl,stack,masked", CE_IMPLS)
def test_ce_rows_matches_jax(vocab_key, impl, jax_impl, stack, masked):
    _check_ce_rows(vocab_key, impl, jax_impl, stack, masked, "fp32")


# The CE's bf16 mode, the JAX package's default: both sides round h, W and dS
# to bf16 (nearest even) and sum in fp32, in other orders.  Where the two
# sides' fp32 dS straddle a bf16 rounding boundary their bf16 dS differ by
# one bf16 step (2^-8 of it), which moves a gradient by that share of one of
# its terms: gradients are held within 1e-3 of their largest entry, the
# losses and CE values at bf16's own resolution (2^-9 relative, 1e-3
# absolute on the sums of up to 6 terms).
BF16_TOL = dict(rtol=2e-3, atol=1e-3)
BF16_GRAD_RTOL = 1e-3


@pytest.mark.parametrize("vocab_key", sorted(VOCABS))
@pytest.mark.parametrize("stack", [True, False])
def test_ce_rows_bf16_matches_jax(vocab_key, stack):
    _check_ce_rows(vocab_key, "pallas", "pallas", stack, True, "bf16")


def _check_ce_rows(vocab_key, impl, jax_impl, stack, masked, precision):
    tol, grad_rtol = (TOL, GRAD_RTOL) if precision == "fp32" else (BF16_TOL, BF16_GRAD_RTOL)
    jdec, variables, pdec, emb, dense, labels, sample_mask, targets = _decoder_case(vocab_key)
    row_mask = (labels.reshape(-1) == 1).astype(np.float32) * sample_mask if masked else None

    def jax_loss(variables, emb):
        ll, dp = jdec.apply(
            variables, emb, jnp.asarray(dense), {k: jnp.asarray(v) for k, v in targets.items()},
            jnp.asarray(labels), method=JaxDecoder.ce_rows, impl=jax_impl,
            row_mask=None if row_mask is None else jnp.asarray(row_mask),
        )
        loss = jax_sfg_loss_rows(ll, dp, jnp.asarray(dense), jnp.asarray(labels),
                                 sample_mask=jnp.asarray(sample_mask), positive_only=True)
        return loss, (ll, dp)

    old_stack, old_prec, old_port = cp.stack_heads_enabled(), cp._PRECISION, ce._PRECISION
    cp.set_interpret(True)
    cp.set_precision(precision)
    ce.set_precision(precision)
    cp.set_stack_heads(stack)
    ce.set_stack_heads(stack)
    try:
        (want, (want_ll, want_dp)), (gv, ge) = jax.value_and_grad(
            jax_loss, argnums=(0, 1), has_aux=True
        )(variables, jnp.asarray(emb))
        et = torch.tensor(emb, requires_grad=True)
        ll, dp = pdec.ce_rows(
            et, torch.from_numpy(dense), {k: torch.from_numpy(v) for k, v in targets.items()},
            torch.from_numpy(labels), impl=impl,
            row_mask=None if row_mask is None else torch.from_numpy(row_mask),
        )
        got = sfg_loss_rows(ll, dp, torch.from_numpy(dense), torch.from_numpy(labels),
                            sample_mask=torch.from_numpy(sample_mask), positive_only=True)
        got.backward()
    finally:
        cp.set_interpret(False)
        cp.set_precision(old_prec)
        ce.set_precision(old_port)
        cp.set_stack_heads(old_stack)
        ce.set_stack_heads(True)
    np.testing.assert_allclose(got.item(), float(want), **tol)
    for name in want_ll:
        np.testing.assert_allclose(ll[name].detach().numpy(), np.asarray(want_ll[name]),
                                   rtol=tol["rtol"], atol=max(tol["atol"], 1e-5), err_msg=name)
    np.testing.assert_allclose(dp.detach().numpy(), np.asarray(want_dp), **tol)
    _close_to_max(et.grad.numpy(), ge, "embeddings", grad_rtol)
    grads = _port_grads(pdec)
    want_g = dict(flatten_tree(gv["params"]))
    assert sorted(grads) == sorted(want_g)
    for k in want_g:
        _close_to_max(grads[k], want_g[k], k, grad_rtol)
    assert ce_rows_forward.launches == 0


def test_ce_rows_all_rows_masked_gives_zero_loss_and_gradients():
    _, _, pdec, emb, dense, labels, _, targets = _decoder_case("one_bucket", seed=5)
    et = torch.tensor(emb, requires_grad=True)
    zeros = torch.zeros(B_DEC)
    ll, dp = pdec.ce_rows(et, torch.from_numpy(dense),
                          {k: torch.from_numpy(v) for k, v in targets.items()},
                          torch.from_numpy(labels), impl="pallas", row_mask=zeros)
    loss = sfg_loss_rows(ll, dp, torch.from_numpy(dense), zeros[:, None], positive_only=True)
    loss.backward()
    assert loss.item() == 0.0 and all((v == 0).all() for v in ll.values())
    assert torch.isfinite(et.grad).all() and (et.grad.abs() < 1e-7).all()


def test_ce_rows_falls_back_to_remat_past_the_shape_gate():
    vocabs = (("C0", 7), ("C1", 5))
    dec = SFGDecoder(4, vocabs, 0, hidden_units=(), dropout_rate=0.0)  # K = 8 fields wide
    dec_wide = SFGDecoder(40, vocabs, 0, hidden_units=(), dropout_rate=0.0)  # K = 80 > 64
    for d, E in ((dec, 4), (dec_wide, 40)):
        emb = torch.randn(6, 2, E)
        targets = {"C0": torch.zeros(6, dtype=torch.long), "C1": torch.ones(6, dtype=torch.long)}
        got, _ = d.ce_rows(emb, torch.zeros(6, 0), targets, impl="pallas")
        want, _ = d.ce_rows(emb, torch.zeros(6, 0), targets, impl="remat")
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)
    assert ce.fits_kernel(6, 8) and not ce.fits_kernel(6, 80)


@pytest.mark.parametrize("positive_only", [True, False])
def test_sfg_losses_match_jax(positive_only):
    rng = np.random.default_rng(0)
    B, V, D = 10, 6, 3
    logits = {f"C{i}": rng.normal(size=(B, V)).astype(np.float32) for i in range(2)}
    targets = {k: rng.integers(0, V, B) for k in logits}
    dense_p = rng.normal(size=(B, D)).astype(np.float32)
    dense_t = rng.normal(size=(B, D)).astype(np.float32)
    labels = rng.integers(0, 2, (B, 1)).astype(np.float32)
    mask = (np.arange(B) < 8).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    for sm in (None, mask):
        want = jax_sfg_loss({k: J(v) for k, v in logits.items()}, J(dense_p),
                            {k: J(v) for k, v in targets.items()}, J(dense_t), J(labels),
                            sample_mask=None if sm is None else J(sm),
                            positive_only=positive_only, sparse_weight=0.7, dense_weight=1.3)
        got = sfg_loss({k: T(v) for k, v in logits.items()}, T(dense_p),
                       {k: T(v) for k, v in targets.items()}, T(dense_t), T(labels),
                       sample_mask=None if sm is None else T(sm),
                       positive_only=positive_only, sparse_weight=0.7, dense_weight=1.3)
        np.testing.assert_allclose(float(got), float(want), **TOL)
        ll = {k: torch.logsumexp(T(v), -1) - T(v)[np.arange(B), targets[k]]
              for k, v in logits.items()}
        want_rows = jax_sfg_loss_rows({k: J(v.numpy()) for k, v in ll.items()}, J(dense_p),
                                      J(dense_t), J(labels),
                                      sample_mask=None if sm is None else J(sm),
                                      positive_only=positive_only)
        got_rows = sfg_loss_rows(ll, T(dense_p), T(dense_t), T(labels),
                                 sample_mask=None if sm is None else T(sm),
                                 positive_only=positive_only)
        np.testing.assert_allclose(float(got_rows), float(want_rows), **TOL)
    assert SFGLoss is sfg_loss
    # no positives: the loss is ~0 under the positive mask's guard
    zero = sfg_loss({k: T(v) for k, v in logits.items()}, T(dense_p),
                    {k: T(v) for k, v in targets.items()}, T(dense_t), torch.zeros(B, 1))
    assert float(zero) < 1e-3


# -------------------------------------------------------------------- models


@pytest.mark.parametrize("use_autodis", [False, True])
def test_pro_predict_matches_jax(use_autodis):
    jm, pm = _pair(use_autodis=use_autodis, autodis_buckets=5)
    x, _ = _data(150, seed=2)
    got, want = pm.predict(x, 64), jm.predict(x, 64)
    assert got.dtype == np.float64 and got.shape == (150, 1)
    np.testing.assert_allclose(got, want, **TOL)
    assert want.std() > 1e-3  # the towers move the scores


def test_pro_weights_round_trip_exact():
    jm, pm = _pair(use_autodis=True)
    want = dict(flatten_tree(jm.get_weights()["params"]))
    got = dict(flatten_tree(pm.get_weights()["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in ("sfg_decoder/head_C1/kernel", "sfg_decoder/label_attention/label_embedding",
              "sfg_decoder/shared_0/kernel", "sfg_decoder/dense_head/kernel",
              "autodis_encoder/autodis/proj_w2"):
        assert k in got


def _first_batch_delta(model, x, y, n):
    before = {k: v.copy() for k, v in flatten_tree(model.get_weights()["params"])}
    model.fit({k: v[:n] for k, v in x.items()}, y[:n], batch_size=n, epochs=1, verbose=0,
              shuffle=False)
    after = dict(flatten_tree(model.get_weights()["params"]))
    return {k: np.asarray(after[k]) - before[k] for k in before}


@pytest.mark.parametrize("fused", ["auto", True, "pallas"])
def test_pro_one_sgd_step_matches_jax(fused):
    """One SGD step from the same weights: the weight changes are lr times
    the gradients, compared per parameter against the largest change."""
    _check_sgd_step(fused, "fp32")


def test_pro_one_sgd_step_bf16_matches_jax():
    """The same step with the CE in its bf16 mode on both sides (the JAX
    package's default, its kernels in interpret mode; the port's plain bf16
    versions on the CPU), held as test_ce_rows_bf16_matches_jax holds the
    gradients."""
    _check_sgd_step("pallas", "bf16")


def _check_sgd_step(fused, precision):
    jm, pm = _pair("sgd", sfg_fused_ce=fused, l2_reg_dnn=1e-3)
    x, y = _data(96, seed=3)
    old_prec, old_port = cp._PRECISION, ce._PRECISION
    cp.set_interpret(True)
    cp.set_precision(precision)
    try:
        want = _first_batch_delta(jm, x, y, 96)
    finally:
        cp.set_interpret(False)
        cp.set_precision(old_prec)
    ce.set_precision(precision)
    try:
        got = _first_batch_delta(pm, x, y, 96)
    finally:
        ce.set_precision(old_port)
    assert sorted(got) == sorted(want)
    moved = [k for k in want if np.abs(want[k]).max() > 0]
    assert any(k.startswith("sfg_decoder/head_") for k in moved)
    for k in want:
        _close_to_max(got[k], want[k], k, GRAD_RTOL if precision == "fp32" else BF16_GRAD_RTOL)


@pytest.mark.parametrize("kw", [dict(), dict(use_autodis=True, sfg_positive_only=False)])
def test_pro_fit_history_matches_jax(kw):
    jm, pm = _pair("adam", **kw)
    x, y = _data(300, seed=4)  # 240 train rows: 3 batches of 64 and a tail of 48
    fit = dict(batch_size=64, epochs=2, verbose=0, validation_split=0.2, shuffle=True)
    want = jm.fit(x, y, **fit).history
    got = pm.fit(x, y, **fit).history
    assert sorted(got) == sorted(want) == sorted(
        ["loss", "sfg_loss", "val_binary_crossentropy", "val_auc"]
    )
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    want_w = dict(flatten_tree(jm.get_weights()["params"]))
    for k, v in flatten_tree(pm.get_weights()["params"]):
        np.testing.assert_allclose(v, np.asarray(want_w[k]), rtol=1e-4, atol=2e-5, err_msg=k)


def test_pro_light_defaults_match_jax():
    jm, pm = _pair("adam", light=True)
    for attr in ("sfg_weight", "sfg_hidden_units", "autodis_buckets", "dnn_hidden_units",
                 "cin_layer_size"):
        assert getattr(pm, attr) == getattr(jm, attr), attr
    assert pm.sfg_weight == 0.05 and pm.sfg_hidden_units == (64, 32)
    x, y = _data(128, seed=5)
    np.testing.assert_allclose(pm.predict(x, 64), jm.predict(x, 64), **TOL)


def test_embedding_analysis_matches_jax():
    jm, pm = _pair()
    x, _ = _data(40, seed=6)
    got, want = pm.get_embedding_analysis(x), jm.get_embedding_analysis(x)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert got["num_fields"] == N_SPARSE and got["embedding_dim"] == DIM


def test_evaluate_predict_and_scorer_skip_the_decoder(monkeypatch):
    jm, pm = _pair()
    x, y = _data(100, seed=7)

    def fail(*a, **k):
        raise AssertionError("the SFG decoder ran outside training")

    dec = pm.module.sfg_decoder
    monkeypatch.setattr(dec, "ce_rows", fail)
    monkeypatch.setattr(dec, "hidden", fail)
    got = pm.evaluate(x, y, 64)
    want = jm.evaluate(x, y, 64)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(Scorer(pm, batch_size=32).warmup().score(x), jm.predict(x, 32),
                               **TOL)
    batch = {k: torch.as_tensor(v) for k, v in pm._pack_x(x).items()}
    assert set(pm.module(batch, training=True)) == {"pred"}  # no labels: no SFG loss


def test_pro_options_that_raise():
    cols = [tf.SparseFeat("C0", 10, 4), tf.DenseFeat("I0", 2)]
    with pytest.raises(ValueError, match="AutoDis"):
        xDeepFMPro(cols, cols, use_autodis=True, device="cpu")
    # dnn_use_bn=True, refused here before BatchNorm was ported, predicts as
    # the JAX model does
    jm, pm = _pair(dnn_use_bn=True)
    assert "dnn/bn_0/mean" in dict(flatten_tree(pm.get_weights()["batch_stats"]))
    x, _ = _data(64, seed=5)
    np.testing.assert_allclose(pm.predict(x, 64), jm.predict(x, 64), **TOL)
    with pytest.raises(ValueError, match="sparse"):
        xDeepFMPro([tf.DenseFeat("I0")], [tf.DenseFeat("I0")], device="cpu")
    with pytest.raises(ValueError, match="sfg_fused_ce"):
        xDeepFMPro(_cols(tf), _cols(tf), sfg_fused_ce="fast", device="cpu")
