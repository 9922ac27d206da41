"""PyTorch port, training slice: the CIN contraction's gradient and the fused
gather's gradient against the JAX package.

Inputs are seeded numpy arrays handed to both sides.  The JAX side
differentiates ``cin_pallas.cin_pallas_rows`` (its ``custom_vjp``) with the
Pallas kernels in interpret mode, under each backward implementation, as
tests/test_cin_pallas.py does; the port runs its plain versions (the CPU
path of the autograd ``Function``, which the CUDA kernels are held against on
the card).  Both sides are fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xdeepfm_tpu.embeddings import fused_gather as jax_fused_gather
from xdeepfm_tpu.ops import cin_pallas as cp
from xdeepfm_tpu_torch.embeddings import fused_gather
from xdeepfm_tpu_torch.ops.cin import cin_rows_contract, get_backward_impl, set_backward_impl
from xdeepfm_tpu_torch.ops.cin_cuda import (
    cin_rows_backward,
    cin_rows_backward_reference,
    cin_rows_dw,
    cin_rows_dw_reference,
)

# (N, H, M, O): odd H and O with N off the TPU's 256-row tile, and a layer-0
# shape (H == M) of the canonical model, narrowed
SHAPES = [(300, 13, 26, 7), (90, 26, 26, 32)]
# fp32 sums of up to N (dW) or O*M (dh, dx0) products in two orders; W is at
# the CIN init's scale, so entries stay O(1)-O(10)
TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture
def impl():
    yield
    set_backward_impl("auto")
    cp.set_backward_impl("auto")


def _inputs(seed, N, H, M, O):
    rng = np.random.default_rng(seed)
    wide = rng.normal(size=(N, 2 * H)).astype(np.float32)  # h is its left half
    return (
        wide,
        rng.normal(size=(N, M)).astype(np.float32),
        (rng.normal(size=(O, H * M)) / np.sqrt(H * M)).astype(np.float32),
        rng.normal(size=(O,)).astype(np.float32),
        rng.normal(size=(N, O)).astype(np.float32),  # the output's gradient
    )


def _jax_grads(wide, x0, W, b, g, name):
    H = wide.shape[1] // 2
    cp.set_interpret(True)
    cp.set_backward_impl(name)
    try:
        _, vjp = jax.vjp(
            cp.cin_pallas_rows,
            *(jnp.asarray(a) for a in (wide[:, :H], x0, W, b)),
        )
        return [np.asarray(t) for t in vjp(jnp.asarray(g))]
    finally:
        cp.set_interpret(False)
        cp.set_backward_impl("auto")


@pytest.mark.parametrize("name", ["fused_t", "legacy"])
@pytest.mark.parametrize("N,H,M,O", SHAPES)
def test_cin_gradients_match_jax_pallas_interpret(impl, name, N, H, M, O):
    wide, x0, W, b, g = _inputs(N + H, N, H, M, O)
    want = dict(zip(("dh", "dx0", "dW", "db"), _jax_grads(wide, x0, W, b, g, name)))

    tw, tx0, tW, tb, tg = (torch.from_numpy(a) for a in (wide, x0, W, b, g))
    h = tw[:, :H]  # a strided column view, as split-half hands it on
    assert h.stride() == (2 * H, 1)
    # the plain functions that the kernels are held against
    dh, dx0 = cin_rows_backward_reference(tg, h, tx0, tW)
    plain = {"dh": dh, "dx0": dx0, "dW": cin_rows_dw_reference(tg, h, tx0)}
    # the autograd Function under the same backward implementation
    set_backward_impl(name)
    assert get_backward_impl() == name
    args = [t.clone().requires_grad_() for t in (tw, tx0, tW, tb)]
    out = cin_rows_contract(args[0][:, :H], *args[1:])
    out.backward(tg)
    got = {
        "dh": args[0].grad[:, :H], "dx0": args[1].grad, "dW": args[2].grad,
        "db": args[3].grad,
    }
    assert float(args[0].grad[:, H:].abs().max()) == 0.0  # the other half
    for k, v in plain.items():
        np.testing.assert_allclose(v.numpy(), want[k], err_msg=f"plain {k}", **TOL)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], err_msg=f"Function {k}", **TOL)


@pytest.mark.parametrize("name", ["fused_t", "legacy"])
def test_cin_function_gradcheck_float64(impl, name):
    set_backward_impl(name)
    gen = torch.Generator().manual_seed(5)
    N, H, M, O = 7, 3, 4, 5

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64, requires_grad=True)

    wide, x0, W, b = rand(N, 2 * H), rand(N, M), rand(O, H * M), rand(O)
    assert torch.autograd.gradcheck(
        lambda w, x, W_, b_: cin_rows_contract(w[:, :H], x, W_, b_, backend="torch"),
        (wide, x0, W, b),
    )
    # layer 0 hands x0 in as h too: both gradients must reach it
    W0 = rand(O, M * M)
    assert torch.autograd.gradcheck(
        lambda x, W_, b_: cin_rows_contract(x, x, W_, b_, backend="torch"), (x0, W0, b)
    )


def test_backward_kernels_refuse_cpu_tensors():
    """On a CPU tensor the wrappers raise: only the Function dispatches to the
    plain versions, so no CUDA tensor ever falls back to them."""
    g, h, x0, W = (torch.zeros(s) for s in ((4, 2), (4, 3), (4, 5), (2, 15)))
    with pytest.raises(ValueError, match="CUDA"):
        cin_rows_backward(g, h, x0, W)
    with pytest.raises(ValueError, match="CUDA"):
        cin_rows_dw(g, h, x0)
    with pytest.raises(ValueError, match="unknown"):
        set_backward_impl("fused")


def test_fused_gather_gradient_matches_jax():
    rng = np.random.default_rng(7)
    rows = 30
    t10 = rng.normal(size=(rows, 4)).astype(np.float32)
    t1 = rng.normal(size=(rows, 1)).astype(np.float32)
    ids = rng.integers(0, 8, 64).astype(np.int32)  # many duplicates
    assert len(np.unique(ids)) < len(ids)
    ct = rng.normal(size=(64, 5)).astype(np.float32)

    def jax_loss(tables):
        return jnp.sum(jax_fused_gather((rows, (4, 1)), tables, jnp.asarray(ids)) * ct)

    want = jax.grad(jax_loss)((jnp.asarray(t10), jnp.asarray(t1)))
    a = torch.from_numpy(t10).requires_grad_()
    c = torch.from_numpy(t1).requires_grad_()
    out = fused_gather((a, c), torch.from_numpy(ids).long())
    np.testing.assert_array_equal(
        out.detach().numpy(), np.concatenate([t10, t1], axis=1)[ids]
    )
    (out * torch.from_numpy(ct)).sum().backward()
    # sums of up to 64 duplicate rows in another order
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
