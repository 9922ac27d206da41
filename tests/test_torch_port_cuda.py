"""PyTorch port on the card: each CUDA kernel against its plain version, and
the model on the card against the same model on the CPU.

Every test needs an NVIDIA GPU and skips without one.  The file imports no
JAX, so on a machine with PyTorch alone run it without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from xdeepfm_tpu_torch.features import DenseFeat, SparseFeat
from xdeepfm_tpu_torch.models import xDeepFM
from xdeepfm_tpu_torch.ops.cin import set_backward_impl
from xdeepfm_tpu_torch.ops.cin_cuda import (
    cin_rows_backward,
    cin_rows_backward_reference,
    cin_rows_dw,
    cin_rows_dw_reference,
    cin_rows_forward,
    cin_rows_reference,
)
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
