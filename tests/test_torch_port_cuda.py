"""PyTorch port on the card: each CUDA kernel against its plain version, and
the models on the card against the same models on the CPU or with the plain
versions.

Every test needs an NVIDIA GPU and skips without one.  The file imports no
JAX, so on a machine with PyTorch alone run it without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from xdeepfm_tpu_torch.features import DenseFeat, SparseFeat
from xdeepfm_tpu_torch.models import xDeepFM
from xdeepfm_tpu_torch.ops import ce
from xdeepfm_tpu_torch.ops.ce_cuda import (
    ce_rows_backward,
    ce_rows_backward_reference,
    ce_rows_forward,
    ce_rows_forward_reference,
)
from xdeepfm_tpu_torch.ops.cin import set_backward_impl
from xdeepfm_tpu_torch.ops.cin_cuda import (
    cin_rows_backward,
    cin_rows_backward_reference,
    cin_rows_dw,
    cin_rows_dw_reference,
    cin_rows_forward,
    cin_rows_reference,
)
from xdeepfm_tpu_torch.pro import xDeepFMPro
from xdeepfm_tpu_torch.weights import flatten_tree, unflatten_tree

# fp32 sums of up to H*M unit-normal products, in another order than cuBLAS's
CIN_TOL = dict(rtol=1e-4, atol=1e-3)
# The backward sums up to N (dW) or O*M (dh, dx0) products, so its rounding
# grows with the largest entry: atol is relative to it.
BWD_RTOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, N, H, M, O):
    gen = torch.Generator().manual_seed(seed)
    return [
        torch.randn(shape, generator=gen).cuda()
        for shape in ((N, H), (N, M), (O, H * M), (O,))
    ]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "N,H,M,O",
    [(32, 16, 5, 12), (160, 26, 26, 32), (1001, 13, 26, 7), (5, 3, 2, 1),
     (4096, 128, 26, 128), (300, 26, 26, 256)],
)
def test_cin_kernel_matches_plain(card, N, H, M, O):
    h, x0, W, b = _inputs(N + H + M + O, N, H, M, O)
    wide = torch.cat([h, h], dim=1)[:, :H]  # strided rows, as split-half gives
    for hh in (h, wide):
        before = cin_rows_forward.launches
        got = cin_rows_forward(hh, x0, W, b)
        torch.cuda.synchronize()
        assert cin_rows_forward.launches == before + 1
        torch.testing.assert_close(got, cin_rows_reference(hh, x0, W, b), **CIN_TOL)


@pytest.mark.cuda
def test_cin_kernel_rejects_bad_input(card):
    h, x0, W, b = _inputs(0, 64, 4, 3, 8)
    for bad in (
        (h.double(), x0, W, b),
        (h, x0.t().contiguous().t(), W, b),  # column-major x0
        (h.t().contiguous().t(), x0, W, b),  # column-major h
        (h, x0, W[:, :-1], b),
        (h.cpu(), x0, W, b),
        (h[:, :0], x0, W[:, :0].contiguous(), b),  # H = 0
        (h, x0[:, :0].contiguous(), W[:, :0].contiguous(), b),  # M = 0
    ):
        with pytest.raises(ValueError):
            cin_rows_forward(*bad)


def _close(got, want):
    torch.testing.assert_close(
        got, want, rtol=BWD_RTOL, atol=BWD_RTOL * float(want.abs().max()) + 1e-6
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "N,H,M,O",
    [(32, 16, 5, 12), (160, 26, 26, 32), (1001, 13, 26, 7), (5, 3, 2, 1),
     (4096, 128, 26, 128), (300, 26, 26, 256), (700, 9, 40, 33), (64, 4, 13, 300)],
)
def test_cin_backward_kernels_match_plain(card, N, H, M, O):
    h, x0, W, _ = _inputs(N * H + M + O, N, H, M, O)
    g = torch.randn(N, O, generator=torch.Generator().manual_seed(O)).cuda()
    wide = torch.cat([h, h], dim=1)[:, :H]  # strided rows, as split-half gives
    for hh in (h, wide):
        n_dx, n_dw = cin_rows_backward.launches, cin_rows_dw.launches
        dh, dx0 = cin_rows_backward(g, hh, x0, W)
        dW = cin_rows_dw(g, hh, x0)
        torch.cuda.synchronize()
        assert (cin_rows_backward.launches, cin_rows_dw.launches) == (n_dx + 1, n_dw + 1)
        want_dh, want_dx0 = cin_rows_backward_reference(g, hh, x0, W)
        _close(dh, want_dh)
        _close(dx0, want_dx0)
        _close(dW, cin_rows_dw_reference(g, hh, x0))
        # partial sums are added in a fixed order: a second run is bit-equal
        again = (*cin_rows_backward(g, hh, x0, W), cin_rows_dw(g, hh, x0))
        for a, b in zip((dh, dx0, dW), again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cin_backward_kernels_reject_bad_input(card):
    h, x0, W, _ = _inputs(0, 64, 4, 3, 8)
    g = torch.randn(64, 8).cuda()
    for bad in (
        (g.double(), h, x0, W),
        (g.t().contiguous().t(), h, x0, W),  # column-major g
        (g, h.t().contiguous().t(), x0, W),  # column-major h
        (g, h, x0.t().contiguous().t(), W),  # column-major x0
        (g, h, x0, W[:, :-1]),
        (g[:-1], h, x0, W),
        (g, h.cpu(), x0, W),
        (g, h, x0[:, :0].contiguous(), W[:, :0].contiguous()),  # M = 0
    ):
        with pytest.raises(ValueError):
            cin_rows_backward(*bad)
        if bad[3] is W:  # the fault lies in g, h or x0
            with pytest.raises(ValueError):
                cin_rows_dw(*bad[:3])
    # cin_bwd_dx pads M to a power of two up to 64; wider M takes the legacy path
    wide_x0 = torch.randn(64, 65).cuda()
    with pytest.raises(ValueError, match="legacy"):
        cin_rows_backward(g, h, wide_x0, torch.randn(8, 4 * 65).cuda())


def _small_model(device):
    cols = [SparseFeat(f"C{i}", 100, 10) for i in range(6)] + [
        DenseFeat(f"I{i}") for i in range(3)
    ]
    kw = dict(dnn_hidden_units=(32, 32), cin_layer_size=(16, 8))
    return cols, xDeepFM(cols, cols, device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["auto", "legacy"])
def test_cin_gradients_reach_the_weights_on_card(card, impl):
    """The CIN kernel's autograd Function: conv_w_*/conv_b_* and the tables
    get the same gradients as with the plain CIN on the card."""
    _, model = _small_model("cuda")
    rng = np.random.default_rng(3)
    batch = {
        "sparse": torch.as_tensor(rng.integers(0, 100, (256, 6)), device="cuda"),
        "dense": torch.as_tensor(rng.uniform(0, 1, (256, 3)), dtype=torch.float32, device="cuda"),
    }
    params = dict(model.module.named_parameters())
    grads = {}
    set_backward_impl(impl)
    try:
        for backend in (None, "torch"):
            model.module.cin.backend = backend
            model.module.zero_grad(set_to_none=True)
            model.module(batch, training=True)["pred"].square().sum().backward()
            grads[backend] = {k: p.grad.clone() for k, p in params.items()}
    finally:
        set_backward_impl("auto")
        model.module.cin.backend = None
    for k in ("cin.conv_w_0", "cin.conv_b_0", "cin.conv_w_1", "embedding_dict.table_d10"):
        assert grads[None][k] is not None and grads[None][k].abs().max() > 0, k
    for k in params:
        _close(grads[None][k], grads["torch"][k])


@pytest.mark.cuda
def test_model_on_card_matches_cpu(card):
    cols = [SparseFeat(f"C{i}", 100, 10) for i in range(6)] + [
        DenseFeat(f"I{i}") for i in range(3)
    ]
    kw = dict(dnn_hidden_units=(32, 32), cin_layer_size=(16, 8))
    gpu = xDeepFM(cols, cols, device="cuda", **kw)
    cpu = xDeepFM(cols, cols, device="cpu", **kw)
    rng = np.random.default_rng(0)
    flat = {
        k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in flatten_tree(cpu.get_weights()["params"])
    }
    weights = {"params": unflatten_tree(flat), "batch_stats": {}}
    gpu.set_weights(weights)
    cpu.set_weights(weights)
    n = 700
    x = {f"C{i}": rng.integers(0, 100, n) for i in range(6)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(3)})
    before = cin_rows_forward.launches
    got = gpu.predict(x, 256)
    assert cin_rows_forward.launches - before == 2 * 3  # 2 layers x 3 batches
    want = cpu.predict(x, 256)
    assert want.std() > 1e-2  # every tower moves the scores
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _ce_inputs(seed, F, B, K, V, pad=0):
    """Unit-normal h, W / sqrt(K), b on the card; the last ``pad`` columns of
    each head padded as the decoder pads stacked heads (W 0, b -1e30)."""
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(B, K, generator=gen)
    W = torch.randn(F, V, K, generator=gen) / K**0.5
    b = torch.randn(F, V, generator=gen)
    if pad:
        W[:, -pad:] = 0.0
        b[:, -pad:] = ce._NEG
    t = torch.randint(0, V - pad, (F, B), generator=gen)
    g = torch.randn(F, B, generator=gen)
    return [x.cuda() for x in (h, W, b, t, g)]


# (F, B, K, V, pad, num_valid): the canonical stacked shape cut in depth, a
# single head, ragged B, K and V, a tile straddling num_valid, num_valid 0,
# a tiny one
CE_SHAPES = [
    (26, 512, 64, 10112, 112, None),
    (1, 1000, 64, 10000, 0, 333),
    (3, 1001, 13, 1000, 0, 700),
    (2, 300, 40, 257, 5, 129),
    (2, 256, 64, 1000, 0, 0),
    (1, 5, 3, 7, 0, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("F,B,K,V,pad,nv", CE_SHAPES)
def test_ce_kernels_match_plain(card, F, B, K, V, pad, nv, precision):
    h, W, b, t, g = _ce_inputs(F + B + K + V, F, B, K, V, pad)
    n_fwd, n_bwd = ce_rows_forward.launches, ce_rows_backward.launches
    ll, logz = ce_rows_forward(h, W, b, t, nv, precision)
    grads = ce_rows_backward(g, h, W, b, t, logz, nv, precision)
    torch.cuda.synchronize()
    assert (ce_rows_forward.launches, ce_rows_backward.launches) == (n_fwd + 1, n_bwd + 1)
    want_ll, want_logz = ce_rows_forward_reference(h, W, b, t, nv, precision)
    torch.testing.assert_close(ll, want_ll, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(logz, want_logz, rtol=1e-5, atol=1e-4)
    # fp32: each gradient within 1e-4 of its largest entry.  bf16 rounds dS:
    # where the kernel's fp32 value and the plain one straddle a rounding
    # boundary they differ by one bf16 step (2^-8), hence 1e-2 there.
    rtol = 1e-4 if precision == "fp32" else 1e-2
    for got, want in zip(grads, ce_rows_backward_reference(g, h, W, b, t, logz, nv, precision)):
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=rtol * float(want.abs().max()) + 1e-6)
    if nv is not None:
        assert (ll[:, nv:] == 0).all() and (grads[0][nv:] == 0).all()
    if nv == 0:
        assert all((x == 0).all() for x in grads)
    # partial sums are added in a fixed order: a second run is bit-equal
    for a, c in zip(grads, ce_rows_backward(g, h, W, b, t, logz, nv, precision)):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_ce_kernels_reject_bad_input(card):
    h, W, b, t, g = _ce_inputs(0, 2, 64, 8, 100)
    logz = torch.zeros_like(g)
    for bad in (
        (h.double(), W, b, t),
        (h, W, b, t.int()),  # int32 targets
        (h.t().contiguous().t(), W, b, t),  # column-major h
        (h, W[:, :-1], b, t),
        (h.cpu(), W, b, t),
        (h[:, :0].contiguous(), W[..., :0].contiguous(), b, t),  # K = 0
        (torch.randn(64, 65, device="cuda"), torch.randn(2, 100, 65, device="cuda"), b, t),
        (h, W[:, :0].contiguous(), b[:, :0].contiguous(), t),  # V = 0
    ):
        with pytest.raises(ValueError):
            ce_rows_forward(*bad)
        with pytest.raises(ValueError):
            ce_rows_backward(g, *bad, logz)
    with pytest.raises(ValueError):
        ce_rows_forward(h, W, b, t, 1.5)  # num_valid must be an integer
    with pytest.raises(ValueError):
        ce_rows_backward(g[:, :-1], h, W, b, t, logz)


def _pro_batch(n, seed, vocabs):
    rng = np.random.default_rng(seed)
    return {
        "sparse": torch.as_tensor(np.stack([rng.integers(0, v, n) for v in vocabs], 1),
                                  device="cuda"),
        "dense": torch.as_tensor(rng.uniform(0, 1, (n, 2)), dtype=torch.float32, device="cuda"),
        "labels": torch.as_tensor(rng.uniform(size=(n, 1)) < 0.4, dtype=torch.float32,
                                  device="cuda"),
        "sample_mask": torch.as_tensor(np.arange(n) < n - 7, dtype=torch.float32, device="cuda"),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("stack", [True, False])
def test_pro_gradients_through_ce_kernels_match_plain(card, stack):
    """The SFG loss's gradients reach every parameter through the CE kernels
    (stacked heads, and one launch per head) as through the plain CE."""
    vocabs = (300, 300, 290, 1000)  # a bucket of three heads (384) and one of 1024
    cols = [SparseFeat(f"C{i}", v, 8) for i, v in enumerate(vocabs)] + [
        DenseFeat(f"I{i}") for i in range(2)
    ]
    model = xDeepFMPro(cols, cols, dnn_hidden_units=(32,), cin_layer_size=(16, 8),
                       sfg_hidden_units=(32, 24), sfg_dropout=0.0, device="cuda")
    batch = _pro_batch(700, 4, vocabs)
    params = dict(model.module.named_parameters())
    grads, launches = {}, {}
    ce.set_stack_heads(stack)
    try:
        for backend in (None, "torch"):
            model.module.sfg_decoder.ce_backend = backend
            model.module.zero_grad(set_to_none=True)
            before = (ce_rows_forward.launches, ce_rows_backward.launches)
            out = model.module(batch, training=True)
            out["aux_loss"].backward()
            launches[backend] = (ce_rows_forward.launches - before[0],
                                 ce_rows_backward.launches - before[1])
            grads[backend] = {k: p.grad.clone() for k, p in params.items() if p.grad is not None}
    finally:
        ce.set_stack_heads(True)
        model.module.sfg_decoder.ce_backend = None
    per_step = (2, 2) if stack else (4, 4)
    assert launches == {None: per_step, "torch": (0, 0)}
    assert sorted(grads[None]) == sorted(grads["torch"])
    assert any(k.startswith("sfg_decoder.head_C3") for k in grads[None])
    for k in grads["torch"]:
        _close(grads[None][k], grads["torch"][k])
