"""PyTorch port: the fused softmax cross-entropy (``ops/ce.py``) against the
JAX package's ``ops/ce_pallas.py`` with its Pallas kernels in interpret mode.

Inputs are drawn from a numpy seed and handed to both sides; the port takes
the heads in ``nn.Linear`` layout ([V, K]), the JAX package in flax layout
([K, V]).  Both sides run on the CPU: the port's plain versions, JAX's
kernels interpreted.  Tolerances: ll within 1e-5 (fp32 sums of at most a few
hundred terms in another order); each gradient within 1e-4 of its largest
entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xdeepfm_tpu.ops import ce_pallas as cp
from xdeepfm_tpu_torch.ops import ce
from xdeepfm_tpu_torch.ops.ce_cuda import ce_rows_backward, ce_rows_forward

LL_ATOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture
def interpret():
    """JAX's CE kernels in interpret mode at a given precision; restored after."""
    old = cp._PRECISION
    cp.set_interpret(True)

    def precision(name):
        cp.set_precision(name)
        ce.set_precision(name)

    try:
        yield precision
    finally:
        cp.set_interpret(False)
        cp.set_precision(old)
        ce.set_precision("fp32")


def _grad_close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(want).max() + 1e-7,
        err_msg=err_msg,
    )


def _inputs(seed, F, B, K, V):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, K)).astype(np.float32)
    W = (rng.normal(size=(F, V, K)) / np.sqrt(K)).astype(np.float32)  # port layout
    b = rng.normal(size=(F, V)).astype(np.float32)
    t = rng.integers(0, V, (F, B)).astype(np.int32)
    w = rng.normal(size=(F, B)).astype(np.float32)  # the loss's weight per value
    return h, W, b, t, w


# (F, B, K, V): one head and three stacked; ragged B and V; the second shape
# has two JAX batch tiles (512 rows) and two vocabulary blocks (1024 columns),
# so num_valid = 520 straddles a tile
SHAPES = [(1, 24, 6, 300), (3, 600, 8, 1100)]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("nv", [None, "partial", 0])
@pytest.mark.parametrize("F,B,K,V", SHAPES)
def test_fused_ce_rows_matches_jax(interpret, F, B, K, V, nv, precision):
    interpret(precision)
    h, W, b, t, w = _inputs(F * B + K, F, B, K, V)
    num_valid = {None: None, "partial": 520 if B > 512 else 10, 0: 0}[nv]
    stacked = F > 1

    def jax_loss(h, W, b):
        Wj = jnp.swapaxes(W, 1, 2)  # [F, K, V]
        if stacked:
            ll = cp.fused_ce_rows_stacked(h, Wj, b, jnp.asarray(t), num_valid=num_valid)
        else:
            ll = cp.fused_ce_rows(h, Wj[0], b[0], jnp.asarray(t[0]), num_valid=num_valid)[None]
        return jnp.sum(ll * w), ll

    (_, want_ll), want_g = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(h), jnp.asarray(W), jnp.asarray(b)
    )
    ht, Wt, bt = (torch.tensor(a, requires_grad=True) for a in (h, W, b))
    tt = torch.from_numpy(t)
    if stacked:
        ll = ce.fused_ce_rows_stacked(ht, Wt, bt, tt, num_valid=num_valid)
    else:
        ll = ce.fused_ce_rows(ht, Wt[0], bt[0], tt[0], num_valid=num_valid)[None]
    (ll * torch.from_numpy(w)).sum().backward()

    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(want_ll), rtol=0, atol=LL_ATOL)
    for name, got, want in zip(("dh", "dW", "db"), (ht.grad, Wt.grad, bt.grad), want_g):
        _grad_close(got.numpy(), want, name)
    if num_valid is not None:
        assert (ll.detach()[:, num_valid:] == 0).all()
        assert (ht.grad[num_valid:] == 0).all()
    if num_valid == 0:
        assert (Wt.grad == 0).all() and (bt.grad == 0).all()
    assert ce_rows_forward.launches == ce_rows_backward.launches == 0  # CPU: plain versions


def test_fused_ce_rows_takes_lists_and_a_device_count():
    h, W, b, t, _ = _inputs(1, 2, 40, 5, 70)
    ht = torch.from_numpy(h)
    nv = torch.tensor(17)  # as sort_rows_by_mask gives it, on the device
    got = ce.fused_ce_rows_stacked(ht, list(torch.from_numpy(W)), list(torch.from_numpy(b)),
                                   torch.from_numpy(t), num_valid=nv)
    want = ce.fused_ce_rows_stacked(ht, torch.from_numpy(W), torch.from_numpy(b),
                                    torch.from_numpy(t), num_valid=17, backend="torch")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got[:, 17:] == 0).all() and (got[:, :17] != 0).all()


def _perm_inputs(seed):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=23) < 0.4).astype(np.float32)
    mask[-3:] = 0.0  # a padded tail
    return (mask, rng.normal(size=(23, 4)).astype(np.float32),
            rng.normal(size=(3, 23)).astype(np.float32))


def test_sort_rows_by_mask_matches_jax():
    for seed in range(3):
        mask, _, _ = _perm_inputs(seed)
        want = cp.sort_rows_by_mask(jnp.asarray(mask))
        got = ce.sort_rows_by_mask(torch.from_numpy(mask))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    perm, inv, nv = ce.sort_rows_by_mask(torch.zeros(5))
    assert int(nv) == 0 and perm.tolist() == inv.tolist() == list(range(5))


def test_permute_rows_and_unpermute_cols_match_jax():
    mask, x, y = _perm_inputs(4)
    perm, inv, _ = cp.sort_rows_by_mask(jnp.asarray(mask))
    rng = np.random.default_rng(5)
    cx, cy = (rng.normal(size=a.shape).astype(np.float32) for a in (x, y))

    def jax_f(x, y):
        return (jnp.sum(cp.permute_rows(x, perm, inv) * cx)
                + jnp.sum(cp.unpermute_cols(y, perm, inv) * cy))

    want = jax.grad(jax_f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tperm, tinv = (torch.tensor(np.asarray(a)) for a in (perm, inv))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    px, uy = ce.permute_rows(xt, tperm, tinv), ce.unpermute_cols(yt, tperm, tinv)
    np.testing.assert_array_equal(px.detach().numpy(), np.asarray(cp.permute_rows(x, perm, inv)))
    np.testing.assert_array_equal(uy.detach().numpy(),
                                  np.asarray(cp.unpermute_cols(y, perm, inv)))
    ((px * torch.from_numpy(cx)).sum() + (uy * torch.from_numpy(cy)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(want[1]), rtol=1e-6)
    # a round trip through the permutation and its inverse is the identity
    np.testing.assert_array_equal(ce.permute_rows(px, tinv, tperm).detach().numpy(), x)


def test_settings_and_shape_gate():
    assert ce._PRECISION == "fp32"  # the port's default (see ops/ce.py)
    with pytest.raises(ValueError):
        ce.set_precision("tf32")
    assert ce.stack_heads_enabled()
    ce.set_stack_heads(False)
    try:
        assert not ce.stack_heads_enabled()
    finally:
        ce.set_stack_heads(True)
    assert ce._NEG == cp._NEG
    assert ce.fits_kernel(4096, 64) and ce.fits_kernel(5, 1)
    assert not ce.fits_kernel(4096, 65) and not ce.fits_kernel(4096, 0)
    assert not ce.fits_kernel(2**26, 64)  # 32-bit row offsets
    h, W, b, t, _ = _inputs(2, 1, 8, 4, 10)
    with pytest.raises(ValueError, match="backend"):
        ce.fused_ce_rows(*map(torch.from_numpy, (h, W[0], b[0], t[0])), backend="cuda")


def test_kernel_wrappers_reject_cpu_tensors():
    h, W, b, t, _ = _inputs(3, 2, 8, 4, 10)
    ht, Wt, bt, tt = map(torch.from_numpy, (h, W, b, t.astype(np.int64)))
    with pytest.raises(ValueError, match="CUDA"):
        ce_rows_forward(ht, Wt, bt, tt)
    with pytest.raises(ValueError, match="CUDA"):
        ce_rows_backward(torch.ones(2, 8), ht, Wt, bt, tt, torch.ones(2, 8))
    assert ce_rows_forward.launches == ce_rows_backward.launches == 0
