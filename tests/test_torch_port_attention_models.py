"""PyTorch port, attention-CIN slice: xDeepFMAttention and
xDeepFMAttentionV2 (the ``bench.py`` rows ``attn`` and ``attn2``, cut to
small widths) against the JAX package's models.

The JAX model is compiled and its weights replaced by seeded numpy draws at
scale 0.1; the port receives them through ``set_weights``, and both run fp32
on the CPU on the same numpy data.  Off the TPU the JAX models take their
unfused XLA route; the port on a CPU tensor takes its kernel routes' plain
versions (V1 the fused block's, V2 ``small_attention``'s), so these tests
also hold those routes against the reference composition.

Tolerances: predictions rtol 1e-5, atol 1e-6; one SGD step's weight changes
within 1e-4 of each parameter's largest change; ``fit`` histories rtol 1e-4,
atol 1e-6 (as ``tests/test_torch_port_train.py``) and the weights after it
within 1e-4 (adam; see the test).  V2 in the attention's bf16 mode (the JAX
kernel in interpret mode): predictions within atol 1e-6, one SGD step's
changes within 1e-3 of each parameter's largest (see the tests).
"""

import contextlib

import jax
import numpy as np
import pytest

import xdeepfm_tpu.features as jf
import xdeepfm_tpu_torch.features as tf
from xdeepfm_tpu.models.xdeepfm_attn import xDeepFMAttention as JaxV1
from xdeepfm_tpu.models.xdeepfm_attn import xDeepFMAttentionV2 as JaxV2
from xdeepfm_tpu.ops import attention_pallas
from xdeepfm_tpu_torch.models import xDeepFMAttention, xDeepFMAttentionV2
from xdeepfm_tpu_torch.ops import attention, attention_cuda, attn_block_cuda
from xdeepfm_tpu_torch.weights import canonical_paths, flatten_tree


def _assert_launches_zero():
    for fn in (attention_cuda.sa_forward, attention_cuda.sa_backward,
               attention_cuda.sa_forward_bf16, attention_cuda.sa_backward_bf16,
               attn_block_cuda.ab_forward, attn_block_cuda.ab_backward):
        assert fn.launches == 0


N_SPARSE, VOCAB, DIM, N_DENSE = 4, 30, 10, 3
ARCH = dict(dnn_hidden_units=(8,), cin_layer_size=(8, 6))
VERSIONS = {
    "v1": (JaxV1, xDeepFMAttention, dict(cin_num_heads=2)),
    "v2": (JaxV2, xDeepFMAttentionV2, dict(cin_num_heads=4, cin_num_attn_layers=2)),
}
METRICS = ["binary_crossentropy", "auc"]


def _cols(mod):
    return [mod.SparseFeat(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)] + [
        mod.DenseFeat(f"I{i}") for i in range(N_DENSE)
    ]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
    return x, (rng.uniform(size=n) < 0.4).astype(np.float32)


def _pair(version, optimizer="adam", **kw):
    """(JAX model, port model) with the same random weights (scale 0.1)."""
    jcls, tcls, arch = VERSIONS[version]
    jm = jcls(_cols(jf), _cols(jf), **ARCH, **arch, **kw)
    jm.compile(optimizer, "binary_crossentropy", metrics=METRICS)
    rng = np.random.default_rng(1)
    w = jm.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"])
    jm.set_weights(w)
    pm = tcls(_cols(tf), _cols(tf), device="cpu", **ARCH, **arch, **kw)
    pm.set_weights(jm.get_weights())
    pm.compile(optimizer, "binary_crossentropy", metrics=METRICS)
    return jm, pm


@pytest.mark.parametrize("version", sorted(VERSIONS))
def test_attention_model_predict_matches_jax(version):
    jm, pm = _pair(version)
    x, _ = _data(150, seed=2)
    got, want = pm.predict(x, 64), jm.predict(x, 64)
    assert got.dtype == np.float64 and got.shape == (150, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert want.std() > 1e-3
    _assert_launches_zero()


@pytest.mark.parametrize("version", sorted(VERSIONS))
def test_attention_model_weights_round_trip(version):
    jm, pm = _pair(version)
    want = dict(flatten_tree(jm.get_weights()["params"]))
    got = dict(flatten_tree(pm.get_weights()["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    if version == "v1":
        names = ("cin/mhsa/W_q/kernel", "cin/layer_norm/scale", "cin/attn_pooling/fc1/kernel",
                 "cin/attn_pooling/fc1/bias", "cin/attn_pooling/fc2/kernel",
                 "cin/output_proj/kernel")
    else:
        names = ("cin/mhsa_0/W_q/kernel", "cin/mhsa_1/W_o/kernel", "cin/ln_0/scale",
                 "cin/ln_1/bias", "cin/attn_pooling/fc2/kernel")
    for k in names:
        assert k in got, k


@pytest.mark.parametrize("version", sorted(VERSIONS))
def test_attention_model_l2_registry_matches_jax(version):
    reg = dict(l2_reg_linear=1e-3, l2_reg_embedding=2e-3, l2_reg_dnn=3e-3, l2_reg_cin=4e-3)
    jm, pm = _pair(version, **reg)
    want = {p: jm._reg_coeffs_for(p) for p, _ in flatten_tree(jm.get_weights()["params"])}
    want = {p: c for p, c in want.items() if c != (0.0, 0.0)}
    paths = canonical_paths(pm.module)
    names = {id(p): n for n, p in pm.module.named_parameters()}
    got = {paths[names[id(p)]]: (l1, l2) for p, l1, l2 in pm._regularization_terms()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    assert any("/mhsa" in k and k.endswith("/kernel") for k in got)
    assert "cin/output_proj/kernel" in got or version == "v2"
    assert all(not k.endswith("/scale") for k in got if k.startswith("cin/"))
    np.testing.assert_allclose(pm._regularization_loss().item(),
                               float(jm._regularization_loss(jm.params)), rtol=1e-5)


def _first_batch_delta(model, x, y, n):
    before = {k: v.copy() for k, v in flatten_tree(model.get_weights()["params"])}
    model.fit({k: v[:n] for k, v in x.items()}, y[:n], batch_size=n, epochs=1, verbose=0,
              shuffle=False)
    after = dict(flatten_tree(model.get_weights()["params"]))
    return {k: np.asarray(after[k]) - before[k] for k in before}


@pytest.mark.parametrize("version", sorted(VERSIONS))
def test_attention_model_one_sgd_step_matches_jax(version):
    """One SGD step from the same weights: the weight changes are lr times
    the gradients, each within 1e-4 of its largest change."""
    jm, pm = _pair(version, "sgd", l2_reg_cin=1e-3)
    x, y = _data(96, seed=3)
    want = _first_batch_delta(jm, x, y, 96)
    got = _first_batch_delta(pm, x, y, 96)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("cin/mhsa") and np.abs(want[k]).max() > 0 for k in want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max() + 1e-8, err_msg=k)


@pytest.mark.parametrize("version", sorted(VERSIONS))
def test_attention_model_fit_matches_jax(version):
    jm, pm = _pair(version)
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


@contextlib.contextmanager
def _bf16_attention():
    """Both packages' small attention in the bf16 mode: the JAX kernel in
    interpret mode (its "auto" route then takes the kernel) with
    ``attention_pallas.set_precision("bf16")``, the port's plain versions
    with ``attention.set_precision("bf16")``; fp32 and the XLA route again
    after."""
    attention_pallas.set_interpret(True)
    attention_pallas.set_precision("bf16")
    attention.set_precision("bf16")
    try:
        yield
    finally:
        attention_pallas.set_interpret(False)
        attention_pallas.set_precision("fp32")
        attention.set_precision("fp32")


def test_attention_v2_bf16_mode_predict_matches_jax():
    """V2 in the attention's bf16 mode: the port's plain versions against the
    JAX kernel (interpret mode, traced in the mode).  Both round the same
    operands to bf16 at the same points and sum in fp32; an e computed by
    another exp can land on the other side of a bf16 rounding boundary, so
    the predictions are held within atol 1e-6 (they differ by ~2e-7), while
    the mode moves them ~3.5e-6 off the fp32 mode's: a side left in fp32
    would fail."""
    jm, pm = _pair("v2")
    x, _ = _data(150, seed=2)
    fp32 = pm.predict(x, 64)
    with _bf16_attention():
        got, want = pm.predict(x, 64), jm.predict(x, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got - fp32).max() > 2e-6
    _assert_launches_zero()


def test_attention_v2_bf16_mode_one_sgd_step_matches_jax():
    """One SGD step of V2 in the bf16 mode from the same weights: each
    weight change within 1e-3 of its largest change (ds and g inv_z rounded
    to bf16 on both sides, a rounding boundary apart at most; the worst
    parameter differs by ~2e-4 of its largest change)."""
    jm, pm = _pair("v2", "sgd", l2_reg_cin=1e-3)
    x, y = _data(96, seed=3)
    with _bf16_attention():
        want = _first_batch_delta(jm, x, y, 96)
        got = _first_batch_delta(pm, x, y, 96)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("cin/mhsa") and np.abs(want[k]).max() > 0 for k in want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                   atol=1e-3 * np.abs(want[k]).max() + 1e-8, err_msg=k)
    _assert_launches_zero()
