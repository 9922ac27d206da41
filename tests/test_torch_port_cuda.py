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
    ce_round_bf16,
    ce_rows_backward,
    ce_rows_backward_bf16,
    ce_rows_backward_reference,
    ce_rows_forward,
    ce_rows_forward_bf16,
    ce_rows_forward_reference,
)
from xdeepfm_tpu_torch.ops.cin import set_backward_impl
from xdeepfm_tpu_torch.ops.cin_cuda import (
    cin_rows_backward,
    cin_rows_backward_bf16,
    cin_rows_backward_reference,
    cin_rows_backward_reference_bf16,
    cin_rows_dw,
    cin_rows_dw_reference,
    cin_rows_forward,
    cin_rows_forward_bf16,
    bf16_round,
    cin_rows_reference,
    cin_rows_reference_bf16,
    cin_rows_round_g_bf16,
)
from xdeepfm_tpu_torch.ops import attention
from xdeepfm_tpu_torch.ops.attention_cuda import (
    SMEM_BYTES,
    sa_backward,
    sa_backward_bf16,
    sa_backward_reference,
    sa_bf16_float64,
    sa_forward,
    sa_forward_bf16,
    sa_forward_reference,
    sa_smem_bytes,
    smem_bytes_of_kernel,
)
from xdeepfm_tpu_torch.ops.attn_block_cuda import (
    BlockCfg,
    ab_backward,
    ab_backward_reference,
    ab_forward,
    ab_forward_reference,
    ab_smem_bytes,
)
from xdeepfm_tpu_torch.ops.attn_block_cuda import _fn as _attn_block_fn
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


def _close(got, want, rtol=BWD_RTOL):
    torch.testing.assert_close(
        got, want, rtol=rtol, atol=rtol * float(want.abs().max()) + 1e-6
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
# single head, ragged B, K and V, a tile straddling num_valid, K 21 (the bf16
# kernels' KW 32; the others take KW 16, 48 and 64), num_valid 0, a tiny one
CE_SHAPES = [
    (26, 512, 64, 10112, 112, None),
    (1, 1000, 64, 10000, 0, 333),
    (3, 1001, 13, 1000, 0, 700),
    (2, 300, 40, 257, 5, 129),
    (3, 200, 21, 300, 0, 150),
    (2, 256, 64, 1000, 0, 0),
    (1, 5, 3, 7, 0, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("F,B,K,V,pad,nv", CE_SHAPES)
def test_ce_kernels_match_plain(card, F, B, K, V, pad, nv, precision):
    h, W, b, t, g = _ce_inputs(F + B + K + V, F, B, K, V, pad)
    wrappers = (ce_rows_forward, ce_rows_backward, ce_round_bf16, ce_rows_forward_bf16,
                ce_rows_backward_bf16)
    before = [w.launches for w in wrappers]
    ll, logz = ce_rows_forward(h, W, b, t, nv, precision)
    grads = ce_rows_backward(g, h, W, b, t, logz, nv, precision)
    torch.cuda.synchronize()
    # fp32: one launch of each kernel; bf16: the bf16 mode's own kernels, the
    # operands rounded once by each call
    added = (1, 1, 0, 0, 0) if precision == "fp32" else (0, 0, 2, 1, 1)
    assert [w.launches - n for w, n in zip(wrappers, before)] == list(added)
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


def _f64_gate(got, want, exact):
    """The 3xTF32 kernels' numerics: the largest error against float64 at
    most twice the plain fp32 version's, or within 1e-6 of the largest entry
    (as ``chip_smoke.py`` holds them)."""
    err = float((got.double() - exact).abs().max())
    plain = float((want.double() - exact).abs().max())
    assert err <= 2 * plain or err <= 1e-6 * float(exact.abs().max()), (err, plain)


# (N, H, M, O, strided): the canonical scoring batch's two layers (8192 x 10
# rows), the train batch's (4096 x 10, layer 1's h split-half's strided
# view), a ragged shape, and h of 200 columns (two launches of the kernel,
# the second adding into the first's output)
@pytest.mark.cuda
@pytest.mark.parametrize("N,H,M,O,strided", [(81920, 26, 26, 256, False),
                                             (81920, 128, 26, 128, False),
                                             (40960, 26, 26, 256, False),
                                             (40960, 128, 26, 128, True),
                                             (1001, 13, 26, 7, False),
                                             (2000, 200, 26, 64, True)])
def test_cin_fwd_kernel_is_fp32_accurate_and_deterministic(card, N, H, M, O, strided):
    """The warpgroup-MMA forward in 3xTF32: within the plain fp32 version's
    tolerance, its error against float64 at most twice the plain version's
    (or within 1e-6 of the largest entry), and bit-equal over two runs; one
    launch counted for each h block of up to 128 columns."""
    h, x0, W, b = _inputs(N + H + O, N, 2 * H if strided else H, M, O)
    h = h[:, :H]
    W = W[:, :H * M].contiguous()
    before = cin_rows_forward.launches
    got = cin_rows_forward(h, x0, W, b)
    torch.cuda.synchronize()
    assert cin_rows_forward.launches == before + -(-H // 128)
    want = cin_rows_reference(h, x0, W, b)
    torch.testing.assert_close(got, want, **CIN_TOL)
    _f64_gate(got, want, cin_rows_reference(h.double(), x0.double(), W.double(), b.double()))
    assert torch.equal(got, cin_rows_forward(h, x0, W, b))


# (N, H, M, O, strided): layer 1 of a train batch of 1024 (split-half's
# strided h), and a ragged shape
@pytest.mark.cuda
@pytest.mark.parametrize("N,H,M,O,strided", [(10240, 128, 26, 128, True),
                                             (1001, 13, 26, 7, False)])
def test_cin_dw_kernel_is_fp32_accurate_and_deterministic(card, N, H, M, O, strided):
    h, x0, _, _ = _inputs(N + O, N, 2 * H if strided else H, M, O)
    h = h[:, :H]
    g = torch.randn(N, O, generator=torch.Generator().manual_seed(N)).cuda()
    got = cin_rows_dw(g, h, x0)
    torch.cuda.synchronize()
    want = cin_rows_dw_reference(g, h, x0)
    _close(got, want)
    _f64_gate(got, want, cin_rows_dw_reference(g.double(), h.double(), x0.double()))
    assert torch.equal(got, cin_rows_dw(g, h, x0))


# (N, H, M, O, strided): layer 1 of a train batch of 1024 (split-half's
# strided h), layer 0 of it, a ragged shape, and M = 40 (groups padded to
# 64, each over two warps) with O not a multiple of 4
@pytest.mark.cuda
@pytest.mark.parametrize("N,H,M,O,strided", [(10240, 128, 26, 128, True),
                                             (10240, 26, 26, 256, False),
                                             (1001, 13, 26, 7, False),
                                             (700, 9, 40, 33, False)])
def test_cin_bwd_dx_kernel_is_fp32_accurate_and_deterministic(card, N, H, M, O, strided):
    h, x0, W, _ = _inputs(N + H + O, N, 2 * H if strided else H, M, O)
    h = h[:, :H]
    W = W[:, :H * M].contiguous()
    g = torch.randn(N, O, generator=torch.Generator().manual_seed(N + 1)).cuda()
    got = cin_rows_backward(g, h, x0, W)
    torch.cuda.synchronize()
    want = cin_rows_backward_reference(g, h, x0, W)
    exact = cin_rows_backward_reference(g.double(), h.double(), x0.double(), W.double())
    for a, w, ex in zip(got, want, exact):
        _close(a, w)
        _f64_gate(a, w, ex)
    for a, c in zip(got, cin_rows_backward(g, h, x0, W)):
        assert torch.equal(a, c)


# (N, H, M, O, strided): the bf16 mode at layer 1 of a train batch of 1024
# (split-half's strided h), layer 0 of it, a ragged shape, h of 200 columns
# (two forward launches; the backward's groups at width 32) and M = 40
# (the backward's groups padded to 64)
@pytest.mark.cuda
@pytest.mark.parametrize("N,H,M,O,strided", [(10240, 128, 26, 128, True),
                                             (10240, 26, 26, 256, False),
                                             (1001, 13, 26, 7, False),
                                             (2000, 200, 26, 64, True),
                                             (700, 9, 40, 33, False)])
def test_cin_bf16_kernels_match_plain_and_are_deterministic(card, N, H, M, O, strided):
    """``cin_fwd_bf16`` and ``cin_bwd_dx_bf16`` against their bf16 plain
    versions (the same rounded operands, fp32 sums in another order) and
    against float64 of those operands by the fp32 kernels' gate, bit-equal
    over two runs."""
    h, x0, W, b = _inputs(N + H + O + 1, N, 2 * H if strided else H, M, O)
    h = h[:, :H]
    W = W[:, :H * M].contiguous()
    g = torch.randn(N, O, generator=torch.Generator().manual_seed(N + 2)).cuda()
    before = cin_rows_forward_bf16.launches
    got = cin_rows_forward_bf16(h, x0, W, b)
    torch.cuda.synchronize()
    assert cin_rows_forward_bf16.launches == before + -(-H // 128)
    want = cin_rows_reference_bf16(h, x0, W, b)
    torch.testing.assert_close(got, want, **CIN_TOL)
    _f64_gate(got, want,
              cin_rows_reference_bf16(h.double(), x0.double(), W.double(), b.double()))
    assert torch.equal(got, cin_rows_forward_bf16(h, x0, W, b))
    got = cin_rows_backward_bf16(g, h, x0, W)
    want = cin_rows_backward_reference_bf16(g, h, x0, W)
    exact = cin_rows_backward_reference_bf16(g.double(), h.double(), x0.double(), W.double())
    for a, w, ex in zip(got, want, exact):
        _close(a, w)
        _f64_gate(a, w, ex)
    for a, c in zip(got, cin_rows_backward_bf16(g, h, x0, W)):
        assert torch.equal(a, c)


# M at H 128 past the longest chunk's room: 257 (KC 128 with two stages,
# the edge), 300 (KC 64), 340 (KC 32); the fp32 rows of the earlier staging
# took M up to about 285
@pytest.mark.cuda
@pytest.mark.parametrize("M", [257, 300, 340])
def test_cin_fwd_bf16_takes_wide_x0_in_shorter_chunks(card, M):
    """``cin_fwd_bf16`` where the staged rows leave no room for two stages
    of its 128-k' chunk: the plan halves the chunk, and the kernel stays
    within its plain version and the float64 gate, bit-equal over two runs;
    M past the plan's room raises."""
    N, H, O = 301, 128, 20
    h, x0, W, b = _inputs(M, N, H, M, O)
    got = cin_rows_forward_bf16(h, x0, W, b)
    want = cin_rows_reference_bf16(h, x0, W, b)
    torch.testing.assert_close(got, want, **CIN_TOL)
    _f64_gate(got, want,
              cin_rows_reference_bf16(h.double(), x0.double(), W.double(), b.double()))
    assert torch.equal(got, cin_rows_forward_bf16(h, x0, W, b))
    h, x0, W, b = _inputs(M, 8, H, 354, O)
    with pytest.raises(ValueError, match="does not fit"):
        cin_rows_forward_bf16(h, x0, W, b)


# (N, O): layer 0's and layer 1's g at a train batch of 1024, ragged rows, O
# not a multiple of 8 (the pass's scalar loads), O past 384 (two segments)
@pytest.mark.cuda
@pytest.mark.parametrize("N,O", [(10240, 256), (10240, 128), (1001, 7), (700, 33),
                                 (300, 400)])
def test_cin_round_g_bf16_is_bf16_round_and_feeds_the_backward(card, N, O):
    """The bf16 backward's rounding pass: its fp32 copy of g bit-equal to
    ``bf16_round(g)``, and the backward on its tiles bit-equal to the
    backward on the raw g (which runs the pass itself)."""
    g = torch.randn(N, O, generator=torch.Generator().manual_seed(N + O)).cuda()
    h, x0, W, _ = _inputs(N + O, N, 5, 26, O)
    before = cin_rows_round_g_bf16.launches
    gq = cin_rows_round_g_bf16(g)
    assert cin_rows_round_g_bf16.launches == before + 1
    assert torch.equal(gq.rounded, bf16_round(g))
    for a, b in zip(cin_rows_backward_bf16(gq, h, x0, W), cin_rows_backward_bf16(g, h, x0, W)):
        assert torch.equal(a, b)


# (F, B, K, V, pad, num_valid): the Pro step's stacked heads cut to 4 with a
# third of a 4096 batch valid, one head of 10000 columns, ragged, no valid
# row, num_valid not a multiple of the 64-row items (nor of 128)
@pytest.mark.cuda
@pytest.mark.parametrize("F,B,K,V,pad,nv", [(4, 4096, 64, 10112, 112, 1365),
                                            (1, 4096, 64, 10000, 0, 1365),
                                            (3, 1001, 13, 1000, 0, 700),
                                            (2, 512, 64, 1000, 0, 0),
                                            (2, 777, 64, 3000, 0, 321)])
def test_ce_forward_kernel_is_fp32_accurate_and_deterministic(card, F, B, K, V, pad, nv):
    h, W, b, t, _ = _ce_inputs(F * B + V + 1, F, B, K, V, pad)
    nvd = torch.tensor(nv, device="cuda")
    got = ce_rows_forward(h, W, b, t, nvd)
    torch.cuda.synchronize()
    want = ce_rows_forward_reference(h, W, b, t, nvd)
    exact = ce_rows_forward_reference(h.double(), W.double(), b.double(), t, nvd)
    for a, w, ex in zip(got, want, exact):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-4)
        if nv:
            _f64_gate(a, w, ex)
        assert (a[:, nv:] == 0).all()
    for a, c in zip(got, ce_rows_forward(h, W, b, t, nvd)):
        assert torch.equal(a, c)


# (F, B, K, V, pad, num_valid): the Pro step's stacked heads cut to 4 with a
# third of a 4096 batch valid; ragged; no valid row; num_valid not a
# multiple of the 64-row items (nor of 128)
@pytest.mark.cuda
@pytest.mark.parametrize("F,B,K,V,pad,nv", [(4, 4096, 64, 10112, 112, 1365),
                                            (3, 1001, 13, 1000, 0, 700),
                                            (2, 512, 64, 1000, 0, 0),
                                            (2, 777, 64, 3000, 0, 321)])
def test_ce_backward_kernel_is_fp32_accurate_and_deterministic(card, F, B, K, V, pad, nv):
    h, W, b, t, g = _ce_inputs(F * B + V, F, B, K, V, pad)
    nvd = torch.tensor(nv, device="cuda")
    _, logz = ce_rows_forward(h, W, b, t, nvd)
    grads = ce_rows_backward(g, h, W, b, t, logz, nvd)
    torch.cuda.synchronize()
    want = ce_rows_backward_reference(g, h, W, b, t, logz, nvd)
    exact = ce_rows_backward_reference(g.double(), h.double(), W.double(), b.double(), t,
                                       logz.double(), nvd)
    for got, w, ex in zip(grads, want, exact):
        torch.testing.assert_close(got, w, rtol=BWD_RTOL,
                                   atol=BWD_RTOL * float(w.abs().max()) + 1e-6)
        if nv:
            _f64_gate(got, w, ex)
    assert (grads[0][nv:] == 0).all()
    if nv == 0:
        assert all((x == 0).all() for x in grads)
    for a, c in zip(grads, ce_rows_backward(g, h, W, b, t, logz, nvd)):
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


# ------------------------------------------------- attention kernels (rows 8-11)

# (G, dh, S): V2's pairs cut in number, ragged S, dh 1 and 16 (the kernels'
# instantiated range), a tiny one
SA_SHAPES = [(64, 5, 256), (7, 3, 37), (3, 16, 100), (2, 1, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("G,dh,S", SA_SHAPES)
def test_small_attention_kernels_match_plain(card, G, dh, S, precision):
    gen = torch.Generator().manual_seed(G + dh + S)
    q, k, v, g = (torch.randn(G, dh, S, generator=gen).cuda() for _ in range(4))
    scale = dh ** -0.5
    counters = (sa_forward, sa_backward, sa_forward_bf16, sa_backward_bf16)
    before = [fn.launches for fn in counters]
    o, m, inv_z = sa_forward(q, k, v, scale, precision)
    grads = sa_backward(g, q, k, v, o, m, inv_z, scale, precision)
    torch.cuda.synchronize()
    # "bf16" runs the bf16 mode's own kernels (sa_bf16.cu), not the fp32 ones
    launched = [fn.launches - b for fn, b in zip(counters, before)]
    assert launched == ([1, 1, 0, 0] if precision == "fp32" else [0, 0, 1, 1])
    want_o, want_m, want_z = sa_forward_reference(q, k, v, scale, precision)
    # fp32 sums of S terms in another order than cuBLAS's; bf16: an e or ds
    # on the other side of a rounding boundary moves one bf16 step (2^-8)
    rtol = 1e-4 if precision == "fp32" else 1e-2
    _close(o, want_o, rtol)
    torch.testing.assert_close(m, want_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(inv_z, want_z, rtol=1e-4, atol=1e-7)
    for got, want in zip(grads, sa_backward_reference(g, q, k, v, o, m, inv_z, scale, precision)):
        _close(got, want, rtol)
    # every sum is one thread's loop: a second run is bit-equal
    for a, b in zip(grads, sa_backward(g, q, k, v, o, m, inv_z, scale, precision)):
        assert torch.equal(a, b)


# (G, dh, S): chip_smoke.py's SA_BF16_SHAPES (V2's train and serving pairs,
# ragged, tiny, and S 600, a pair staged chunk by chunk from device memory)
SA_BF16_SHAPES = [(8192, 5, 256), (16384, 5, 256), (7, 3, 37), (2, 1, 5), (64, 5, 600)]


def _bf16_slices(G, step=1024):
    return [slice(a, a + step) for a in range(0, G, step)]


@pytest.mark.cuda
@pytest.mark.parametrize("G,dh,S", SA_BF16_SHAPES)
def test_bf16_small_attention_kernels_match_plain(card, G, dh, S):
    """sa_fwd_bf16 / sa_bwd_bf16 at the smoke's shapes: one launch each on
    their own counters, within 1e-2 of the largest entry of the bf16 plain
    versions (an e or ds on the other side of a rounding boundary moves one
    bf16 step, 2^-8) and inv_z within 1e-4, against the float64 function of
    the same rounded inputs at most twice the plain version's error, and
    bit-equal over two runs (no atomics)."""
    gen = torch.Generator().manual_seed(G + dh + S)
    q, k, v, g = (torch.randn(G, dh, S, generator=gen).cuda() for _ in range(4))
    scale = dh ** -0.5
    before = (sa_forward_bf16.launches, sa_backward_bf16.launches)
    o, m, inv_z = sa_forward_bf16(q, k, v, scale)
    grads = sa_backward_bf16(g, q, k, v, o, m, inv_z, scale)
    torch.cuda.synchronize()
    assert (sa_forward_bf16.launches, sa_backward_bf16.launches) == (before[0] + 1, before[1] + 1)
    for sl in _bf16_slices(G):
        want_o, want_m, want_z = sa_forward_reference(q[sl], k[sl], v[sl], scale, "bf16")
        _close(o[sl], want_o, 1e-2)
        torch.testing.assert_close(m[sl], want_m, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(inv_z[sl], want_z, rtol=1e-4, atol=1e-7)
        exact = sa_bf16_float64(q[sl], k[sl], v[sl], scale)
        err, plain = ((t.double() - exact).abs().max() for t in (o[sl], want_o))
        assert err <= 2 * plain or err <= 1e-6 * exact.abs().max()
        args = (g[sl], q[sl], k[sl], v[sl], o[sl], m[sl], inv_z[sl])
        want = sa_backward_reference(*args, scale, "bf16")
        exact = sa_bf16_float64(q[sl], k[sl], v[sl], scale, g[sl], o[sl], m[sl], inv_z[sl])
        for got, w, e in zip(grads, want, exact):
            _close(got[sl], w, 1e-2)
            err, plain = ((t.double() - e).abs().max() for t in (got[sl], w))
            assert err <= 2 * plain or err <= 1e-6 * e.abs().max()
    for a, b in zip((o, m, inv_z), sa_forward_bf16(q, k, v, scale)):
        assert torch.equal(a, b)
    for a, b in zip(grads, sa_backward_bf16(g, q, k, v, o, m, inv_z, scale)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("G,dh,S", [(64, 5, 256), (3, 16, 100), (2, 1, 600)])
def test_bf16_small_attention_row_max_is_exact_where_the_scores_are(card, G, dh, S):
    """On q and k of multiples of 1/8 in [-2, 2] every score is exact in
    fp32, so sa_fwd_bf16's m (the max of the tensor cores' sums) is
    bit-equal to the plain version's."""
    gen = torch.Generator().manual_seed(3 * G + S)
    q, k, v = ((torch.randn(G, dh, S, generator=gen) * 4).round().clamp(-16, 16).cuda() / 8
               for _ in range(3))
    m = sa_forward_bf16(q, k, v, dh ** -0.5)[1]
    assert torch.equal(m, sa_forward_reference(q, k, v, dh ** -0.5, "bf16")[1])


@pytest.mark.cuda
def test_bf16_small_attention_kernels_reject_bad_input(card):
    q = torch.randn(4, 5, 32, device="cuda")
    for bad in ((q.double(), q, q), (q.cpu(), q, q), (torch.randn(4, 17, 32, device="cuda"),) * 3,
                (torch.randn(1, 5, 4000, device="cuda"),) * 3):
        with pytest.raises(ValueError):
            sa_forward_bf16(*bad, 0.5)
    with pytest.raises(ValueError):
        sa_backward_bf16(q, q, q, q, q, torch.zeros(4, 31, device="cuda"),
                         torch.zeros(4, 32, device="cuda"), 0.5)


@pytest.mark.cuda
def test_small_attention_kernels_reject_bad_input(card):
    q = torch.randn(4, 5, 32, device="cuda")
    stats = torch.zeros(4, 32, device="cuda")
    for bad in (
        (q.double(), q, q),
        (q.cpu(), q, q),
        (q.transpose(1, 2).contiguous().transpose(1, 2), q, q),  # not contiguous
        (q, q[:, :4].contiguous(), q),
        (torch.randn(4, 17, 32, device="cuda"),) * 3,  # dh = 17
        (torch.randn(1, 5, 4000, device="cuda"),) * 3,  # beyond shared memory
    ):
        with pytest.raises(ValueError):
            sa_forward(*bad, 0.5)
    with pytest.raises(ValueError):
        sa_forward(q, q, q, 0.5, "fp16")
    with pytest.raises(ValueError):
        sa_backward(q, q, q, q, q, stats[:, :-1], stats, 0.5)


# (B, E, S, H, L, residual, layer_norm): V1's block cut in rows, L = 2, the
# residual off, the LayerNorm off, ragged S, a single head of width 10
AB_SHAPES = [
    (64, 10, 256, 2, 1, True, True),
    (16, 10, 64, 2, 2, True, True),
    (16, 10, 64, 2, 1, False, True),
    (16, 10, 64, 2, 1, True, False),
    (5, 10, 37, 2, 1, True, True),
    (3, 10, 20, 1, 1, True, True),
    # one head of dh 16; E 32 at S 157, where the backward's attention
    # routine takes one chunk a step, and E 96 at S 16, where it fits shared
    # memory with one buffer only
    (2, 16, 24, 1, 1, True, True),
    (2, 32, 157, 2, 1, True, True),
    (2, 96, 16, 6, 1, True, True),
]


def _block_inputs(seed, B, E, S, H, L):
    gen = torch.Generator().manual_seed(seed)
    dh = E // H

    def w(*shape):
        return torch.randn(*shape, generator=gen) / E**0.5

    x = torch.randn(B, E, S, generator=gen)
    ws = [w(L * H, E, dh), w(L * H, E, dh), w(L * H, E, dh), w(L * H, dh, E),
          1 + 0.1 * torch.randn(L, E, 1, generator=gen), 0.1 * torch.randn(L, E, 1, generator=gen),
          w(E, E), 0.1 * torch.randn(E, 1, generator=gen), w(E, 1)]
    g = torch.randn(B, E, generator=gen)
    return x.cuda(), [t.cuda() for t in ws], g.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("B,E,S,H,L,residual,layer_norm", AB_SHAPES)
def test_attn_block_kernels_match_plain(card, B, E, S, H, L, residual, layer_norm):
    x, ws, g = _block_inputs(B + S + L, B, E, S, H, L)
    cfg = BlockCfg(L, H, (E // H) ** -0.5, residual, layer_norm, 1e-5)
    n_fwd, n_bwd = ab_forward.launches, ab_backward.launches
    pooled, saved = ab_forward(cfg, x, *ws)
    grads = ab_backward(cfg, g, x, *ws, saved)
    torch.cuda.synchronize()
    assert (ab_forward.launches, ab_backward.launches) == (n_fwd + 1, n_bwd + 1)
    torch.testing.assert_close(pooled, ab_forward_reference(cfg, x, *ws), rtol=1e-4, atol=1e-5)
    assert torch.equal(ab_forward(cfg, x, *ws, save=False)[0], pooled)
    for got, want in zip(grads, ab_backward_reference(cfg, g, x, *ws)):
        _close(got, want)
    # fixed-order partial sums: a second run is bit-equal
    for a, b in zip(grads, ab_backward(cfg, g, x, *ws, saved)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_attn_block_kernels_reject_bad_input(card):
    x, ws, g = _block_inputs(0, 4, 10, 16, 2, 1)
    cfg = BlockCfg(1, 2, 0.5, True, True, 1e-5)
    with pytest.raises(ValueError):
        ab_forward(cfg, x.double(), *ws)
    with pytest.raises(ValueError):
        ab_forward(cfg, x.cpu(), *ws)
    with pytest.raises(ValueError):
        ab_forward(cfg._replace(heads=3), x, *ws)  # E % H
    with pytest.raises(ValueError):
        ab_forward(cfg, x, *ws[:6], ws[6][:, :-1].contiguous(), *ws[7:])
    with pytest.raises(ValueError):
        ab_forward(cfg, torch.randn(2, 32, 2000, device="cuda"), *ws)  # shared memory
    _, saved = ab_forward(cfg, x, *ws)
    with pytest.raises(ValueError):
        ab_backward(cfg, g[:-1], x, *ws, saved)
    # the kernels' own shared-memory formula agrees with the wrapper's gate
    smem = _attn_block_fn("ab_smem_bytes")
    for E, S, H in ((10, 256, 2), (10, 37, 2), (32, 100, 4), (32, 157, 2), (8, 21, 8),
                    (96, 16, 6)):
        assert smem(E, S, H, 1) == ab_smem_bytes(E, S, H)
        assert smem(E, S, H, 0) == ab_smem_bytes(E, S, H, backward=False)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sa", "ab"])
def test_attention_backwards_are_fp32_accurate_and_deterministic(card, kernel):
    """The 3xTF32 backwards at a path-width shape (V2's pairs and V1's rows,
    cut in number): every gradient's error against float64 at most twice
    the plain fp32 version's, or within 1e-6 of its largest entry, and a
    second run bit-equal."""
    if kernel == "sa":
        G, dh, S = 512, 5, 256
        gen = torch.Generator().manual_seed(9)
        q, k, v, g = (torch.randn(G, dh, S, generator=gen).cuda() for _ in range(4))
        o, m, inv_z = sa_forward(q, k, v, dh ** -0.5)
        args = (g, q, k, v, o, m, inv_z)
        got = sa_backward(*args, dh ** -0.5)
        again = sa_backward(*args, dh ** -0.5)
        torch.cuda.synchronize()
        want = sa_backward_reference(*args, dh ** -0.5)
        exact = sa_backward_reference(*(t.double() for t in args), dh ** -0.5)
    else:
        x, ws, g = _block_inputs(11, 256, 10, 256, 2, 1)
        cfg = BlockCfg(1, 2, 5 ** -0.5, True, True, 1e-5)
        _, saved = ab_forward(cfg, x, *ws)
        got = ab_backward(cfg, g, x, *ws, saved)
        again = ab_backward(cfg, g, x, *ws, saved)
        torch.cuda.synchronize()
        want = ab_backward_reference(cfg, g, x, *ws)
        exact = ab_backward_reference(cfg, g.double(), x.double(), *(w.double() for w in ws))
    for a, b, e, a2 in zip(got, want, exact, again):
        _close(a, b)
        _f64_gate(a, b, e)
        assert torch.equal(a, a2)


# (G, dh, S): V2's pairs cut in number, the ablation's S at dh 9 (one m16
# tile a warp), dh 16 at a ragged S
SA_FWD_SHAPES = [(512, 5, 256), (64, 9, 266), (33, 16, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("G,dh,S", SA_FWD_SHAPES)
def test_small_attention_forward_is_fp32_accurate_and_deterministic(card, G, dh, S):
    """The one-pass forward: o's error against float64 at most twice the
    plain fp32 version's, or within 1e-6 of its largest entry; o, m and
    inv_z bit-equal over two runs; and the backward on the forward's saved
    tensors matches the plain backward on the same tensors."""
    gen = torch.Generator().manual_seed(G + dh)
    q, k, v, g = (torch.randn(G, dh, S, generator=gen).cuda() for _ in range(4))
    scale = dh ** -0.5
    o, m, inv_z = sa_forward(q, k, v, scale)
    again = sa_forward(q, k, v, scale)
    torch.cuda.synchronize()
    for a, b in zip((o, m, inv_z), again):
        assert torch.equal(a, b)
    want = sa_forward_reference(q, k, v, scale)[0]
    _f64_gate(o, want, sa_forward_reference(q.double(), k.double(), v.double(), scale)[0])
    got = sa_backward(g, q, k, v, o, m, inv_z, scale)
    for a, b in zip(got, sa_backward_reference(g, q, k, v, o, m, inv_z, scale)):
        _close(a, b)


# (B, E, S, H, L): V1's block cut to 512 rows, two layers at a ragged S, one
# head of dh 9 (the routine's one m16 tile a warp)
AB_FWD_SHAPES = [(512, 10, 256, 2, 1), (64, 10, 101, 2, 2), (32, 9, 70, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,E,S,H,L", AB_FWD_SHAPES)
def test_attn_block_forward_is_fp32_accurate_and_deterministic(card, B, E, S, H, L):
    """ab_fwd's attention through the forward routine: pooled's error against
    float64 at most twice the plain fp32 version's (or within 1e-6 of its
    largest entry); pooled and every saved tensor bit-equal over two runs,
    pooled bit-equal without the saves; m the plain row max of the unscaled
    scores and inv_z its normaliser, to fp32 rounding (the emulated tests
    hold m bit-equal to the fmaf row max); and the backward on the saves
    matches the plain backward."""
    x, ws, g = _block_inputs(B + E + S, B, E, S, H, L)
    cfg = BlockCfg(L, H, (E // H) ** -0.5, True, True, 1e-5)
    pooled, saved = ab_forward(cfg, x, *ws)
    again, saved2 = ab_forward(cfg, x, *ws)
    torch.cuda.synchronize()
    assert torch.equal(pooled, again)
    for a, b in zip(saved, saved2):
        assert torch.equal(a, b)
    assert torch.equal(ab_forward(cfg, x, *ws, save=False)[0], pooled)
    want = ab_forward_reference(cfg, x, *ws)
    _f64_gate(pooled, want, ab_forward_reference(cfg, x.double(), *(t.double() for t in ws)))
    # layer 0's statistics from the plain projections of x
    dh = E // H
    q, k = (torch.einsum("hed,bes->bhds", w[:H], x) for w in ws[:2])
    s = torch.einsum("bhds,bhdt->bhst", q, k)
    m0 = s.amax(-1)
    torch.testing.assert_close(saved[0][:, :H], m0, rtol=1e-5, atol=1e-5)
    inv0 = 1.0 / torch.exp((s - m0[..., None]) * dh ** -0.5).sum(-1)
    torch.testing.assert_close(saved[1][:, :H], inv0, rtol=1e-4, atol=1e-6)
    for a, b in zip(ab_backward(cfg, g, x, *ws, saved), ab_backward_reference(cfg, g, x, *ws)):
        _close(a, b)


# the parent design's largest S at dh 5 and 16: (5 dh + 3) S floats of
# shared memory; the 3xTF32 backward needs less and takes them
@pytest.mark.cuda
@pytest.mark.parametrize("dh", [5, 16])
def test_small_attention_takes_the_largest_S_of_the_earlier_gate(card, dh):
    S = SMEM_BYTES // (4 * (5 * dh + 3))
    assert sa_smem_bytes(dh, S) <= SMEM_BYTES
    for s in (S, 37, 256, 1):
        assert smem_bytes_of_kernel(dh, s) == sa_smem_bytes(dh, s)
    gen = torch.Generator().manual_seed(dh)
    q, k, v, g = (torch.randn(1, dh, S, generator=gen).cuda() for _ in range(4))
    o, m, inv_z = sa_forward(q, k, v, dh ** -0.5)
    got = sa_backward(g, q, k, v, o, m, inv_z, dh ** -0.5)
    torch.cuda.synchronize()
    for a, b in zip(got, sa_backward_reference(g, q, k, v, o, m, inv_z, dh ** -0.5)):
        _close(a, b)


def _attn_models(device):
    from xdeepfm_tpu_torch.models import xDeepFMAttention, xDeepFMAttentionV2

    cols = [SparseFeat(f"C{i}", 100, 10) for i in range(6)] + [
        DenseFeat(f"I{i}") for i in range(3)
    ]
    kw = dict(dnn_hidden_units=(32,), cin_layer_size=(16, 8), device=device)
    return cols, {
        "v1": xDeepFMAttention(cols, cols, cin_num_heads=2, **kw),
        "v2": xDeepFMAttentionV2(cols, cols, cin_num_heads=4, cin_num_attn_layers=2, **kw),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_attention_model_gradients_through_kernels_match_plain(card, version):
    """Every parameter's gradient through the CIN and attention kernels
    matches the plain versions' on the card; V1 runs the fused block (1 + 1
    launch), V2 two small_attention layers (2 + 2)."""
    model = _attn_models("cuda")[1][version]
    rng = np.random.default_rng(5)
    batch = {
        "sparse": torch.as_tensor(rng.integers(0, 100, (300, 6)), device="cuda"),
        "dense": torch.as_tensor(rng.uniform(0, 1, (300, 3)), dtype=torch.float32, device="cuda"),
    }
    params = dict(model.module.named_parameters())
    counters = (sa_forward, sa_backward, ab_forward, ab_backward)
    grads, launches = {}, {}
    try:
        for backend in (None, "torch"):
            model.module.cin.backend = backend
            model.module.zero_grad(set_to_none=True)
            before = [fn.launches for fn in counters]
            model.module(batch, training=True)["pred"].square().sum().backward()
            launches[backend] = tuple(fn.launches - b for fn, b in zip(counters, before))
            grads[backend] = {k: p.grad.clone() for k, p in params.items()}
    finally:
        model.module.cin.backend = None
    assert launches == {None: (0, 0, 1, 1) if version == "v1" else (2, 2, 0, 0),
                        "torch": (0, 0, 0, 0)}
    assert any(k.startswith("cin.mhsa") and grads[None][k].abs().max() > 0 for k in params)
    for k in params:
        _close(grads[None][k], grads["torch"][k])


@pytest.mark.cuda
def test_attention_model_gradients_through_bf16_kernels_match_plain(card):
    """test_attention_model_gradients_through_kernels_match_plain[v2] under
    ``attention.set_precision("bf16")``: V2's two small_attention layers run
    sa_fwd_bf16 and sa_bwd_bf16 (2 + 2 launches, no fp32 sa_* launch), and
    every parameter's gradient matches the bf16 plain versions' within 1e-2
    of its largest entry (bf16 rounding points, 2^-8 apart)."""
    model = _attn_models("cuda")[1]["v2"]
    rng = np.random.default_rng(5)
    batch = {
        "sparse": torch.as_tensor(rng.integers(0, 100, (300, 6)), device="cuda"),
        "dense": torch.as_tensor(rng.uniform(0, 1, (300, 3)), dtype=torch.float32, device="cuda"),
    }
    params = dict(model.module.named_parameters())
    counters = (sa_forward, sa_backward, sa_forward_bf16, sa_backward_bf16)
    grads, launches = {}, {}
    attention.set_precision("bf16")
    try:
        for backend in (None, "torch"):
            model.module.cin.backend = backend
            model.module.zero_grad(set_to_none=True)
            before = [fn.launches for fn in counters]
            model.module(batch, training=True)["pred"].square().sum().backward()
            launches[backend] = tuple(fn.launches - b for fn, b in zip(counters, before))
            grads[backend] = {k: p.grad.clone() for k, p in params.items()}
    finally:
        attention.set_precision("fp32")
        model.module.cin.backend = None
    assert launches == {None: (0, 0, 2, 2), "torch": (0, 0, 0, 0)}
    assert any(k.startswith("cin.mhsa") and grads[None][k].abs().max() > 0 for k in params)
    for k in params:
        _close(grads[None][k], grads["torch"][k], 1e-2)


@pytest.mark.cuda
def test_attention_models_on_card_match_cpu(card):
    _, gpu = _attn_models("cuda")
    _, cpu = _attn_models("cpu")
    rng = np.random.default_rng(2)
    n = 500
    x = {f"C{i}": rng.integers(0, 100, n) for i in range(6)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(3)})
    for version in ("v1", "v2"):
        flat = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in flatten_tree(cpu[version].get_weights()["params"])}
        weights = {"params": unflatten_tree(flat), "batch_stats": {}}
        gpu[version].set_weights(weights)
        cpu[version].set_weights(weights)
        want = cpu[version].predict(x, 256)
        assert want.std() > 1e-3
        np.testing.assert_allclose(gpu[version].predict(x, 256), want, rtol=0, atol=1e-5)


# ---------------------------------------------- lane attention kernels (rows 12-13)

# (B, H, S, dh): AutoInt's train shape cut in rows, ragged B and S, S 64 at
# dh 16 (the kernels' limits), dh 4 over three heads, a tiny one
LA_SHAPES = [(512, 2, 26, 5), (1001, 2, 39, 5), (64, 1, 64, 16), (33, 3, 26, 4), (5, 1, 3, 4)]


def _la_operands(seed, B, H, S, dh, layout):
    """q, k, v, g as [H, dh, S, B]: contiguous ("lanes") or views of [B, S, E]
    projections ("packed")."""
    gen = torch.Generator().manual_seed(seed)
    if layout == "lanes":
        return [torch.randn(H, dh, S, B, generator=gen).cuda() for _ in range(4)]
    return [torch.randn(B, S, H * dh, generator=gen).cuda().reshape(B, S, H, dh).permute(2, 3, 1, 0)
            for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["lanes", "packed"])
@pytest.mark.parametrize("B,H,S,dh", LA_SHAPES)
def test_lane_attention_kernels_match_plain(card, B, H, S, dh, layout):
    from xdeepfm_tpu_torch.ops.lane_attention_cuda import (
        la_backward, la_backward_reference, la_forward, la_forward_reference)

    q, k, v, g = _la_operands(B + S + dh, B, H, S, dh, layout)
    scale = 1.0 if dh == 5 else dh ** -0.5
    n_fwd, n_bwd = la_forward.launches, la_backward.launches
    o = la_forward(q, k, v, scale)
    grads = la_backward(g, q, k, v, scale)
    torch.cuda.synchronize()
    assert (la_forward.launches, la_backward.launches) == (n_fwd + 1, n_bwd + 1)
    assert o.stride() == q.stride() and all(t.stride() == q.stride() for t in grads)
    # fp32 sums of S terms in another order than the plain einsums'
    _close(o, la_forward_reference(q, k, v, scale), 1e-5)
    for got, want in zip(grads, la_backward_reference(g, q, k, v, scale)):
        _close(got, want, 1e-5)
    # every (head, sample) is one block's, every sum one thread's loop
    for a, b in zip(grads, la_backward(g, q, k, v, scale)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["lanes", "packed"])
@pytest.mark.parametrize("B,H,S,dh", LA_SHAPES)
def test_lane_attention_kernels_float64_gate(card, B, H, S, dh, layout):
    """o and each gradient against float64: within twice the plain fp32
    version's error, or 1e-6 of the largest entry."""
    from xdeepfm_tpu_torch.ops.lane_attention_cuda import (
        la_backward, la_backward_reference, la_forward, la_forward_reference)

    q, k, v, g = _la_operands(B + S + dh + 1, B, H, S, dh, layout)
    scale = 1.0 if dh == 5 else dh ** -0.5
    ops64 = [t.double() for t in (q, k, v, g)]
    cases = [("o", la_forward(q, k, v, scale), la_forward_reference(q, k, v, scale),
              la_forward_reference(*ops64[:3], scale))]
    cases += zip(("dq", "dk", "dv"), la_backward(g, q, k, v, scale),
                 la_backward_reference(g, q, k, v, scale),
                 la_backward_reference(ops64[3], *ops64[:3], scale))
    for name, got, plain, exact in cases:
        err = float((got.double() - exact).abs().max())
        plain_err = float((plain.double() - exact).abs().max())
        assert err <= 2 * plain_err or err <= 1e-6 * float(exact.abs().max()), (
            f"{name}: {err} against the plain version's {plain_err}")


@pytest.mark.cuda
def test_lane_attention_kernels_reject_bad_input(card):
    from xdeepfm_tpu_torch.ops.lane_attention_cuda import la_backward, la_forward

    q = torch.randn(2, 5, 26, 64, device="cuda")
    for bad in (
        (q.double(), q.double(), q.double()),
        (q.cpu(), q, q),
        (q, q[..., :32], q),  # shapes differ
        (q, q.transpose(2, 3).contiguous().transpose(2, 3), q),  # strides differ
        (q[..., ::2],) * 3,  # gaps between samples
        (torch.randn(1, 17, 26, 8, device="cuda"),) * 3,  # dh = 17
        (torch.randn(1, 5, 65, 8, device="cuda"),) * 3,  # S = 65
        (torch.randn(2, 5, 26, device="cuda"),) * 3,  # not [H, dh, S, B]
    ):
        with pytest.raises(ValueError):
            la_forward(*bad, 1.0)
    with pytest.raises(ValueError):
        la_backward(q[..., :32].contiguous(), q, q, q, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("scaling", [False, True])
def test_interacting_layer_gradients_through_kernels_match_plain(card, scaling):
    """Every parameter's and the input's gradient through the lane kernels
    (1 + 1 launches) matches the plain versions' on the card."""
    from xdeepfm_tpu_torch.nn.interaction import InteractingLayer
    from xdeepfm_tpu_torch.ops.lane_attention_cuda import la_backward, la_forward

    layer = InteractingLayer(10, head_num=2, scaling=scaling).cuda()
    x0 = torch.randn(700, 26, 10, generator=torch.Generator().manual_seed(4)).cuda()
    grads, launches = {}, {}
    for backend in (None, "torch"):
        layer.backend = backend
        layer.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_(True)
        before = (la_forward.launches, la_backward.launches)
        layer(x).square().sum().backward()
        launches[backend] = (la_forward.launches - before[0], la_backward.launches - before[1])
        grads[backend] = {"x": x.grad, **{k: p.grad.clone() for k, p in layer.named_parameters()}}
    assert launches == {None: (1, 1), "torch": (0, 0)}
    for k in grads["torch"]:
        _close(grads[None][k], grads["torch"][k])


@pytest.mark.cuda
def test_autoint_and_difm_on_card_match_cpu(card):
    from xdeepfm_tpu_torch.models import DIFM, AutoInt
    from xdeepfm_tpu_torch.ops.lane_attention_cuda import la_forward

    cols = [SparseFeat(f"C{i}", 100, 10) for i in range(6)] + [
        DenseFeat(f"I{i}") for i in range(3)
    ]
    rng = np.random.default_rng(6)
    n = 500
    x = {f"C{i}": rng.integers(0, 100, n) for i in range(6)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(3)})
    for make, layers in ((lambda d: AutoInt(cols, cols, dnn_hidden_units=(32,), device=d), 3),
                         (lambda d: DIFM(cols, cols, att_head_num=2, dnn_hidden_units=(32,),
                                         device=d), 1)):
        gpu, cpu = make("cuda"), make("cpu")
        flat = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in flatten_tree(cpu.get_weights()["params"])}
        weights = {"params": unflatten_tree(flat), "batch_stats": {}}
        gpu.set_weights(weights)
        cpu.set_weights(weights)
        before = la_forward.launches
        got = gpu.predict(x, 256)
        assert la_forward.launches - before == 2 * layers  # 2 batches
        want = cpu.predict(x, 256)
        assert want.std() > 1e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------- GRU scan (rows 14-15)

# (B, T, H, shortest length): DIEN's train shape, a ragged batch with
# length-0 rows (B no multiple of the 3 samples a warp holds at H 10), H 3,
# 8 and 16, tiny; H 11 (2 samples a warp); every length at most 8 of 50 (all
# warps stop early); T past the staging ring several times over
GRU_SHAPES = [(4096, 50, 10, 1), (1001, 37, 10, 0), (33, 5, 3, 0), (300, 20, 8, 0),
              (257, 12, 16, 1), (5, 3, 2, 0), (1001, 50, 11, 0), (4095, 50, 10, 1),
              (512, 130, 10, 0)]
GRU_LONGEST = {(4095, 50, 10, 1): 8}  # shapes whose lengths stop at this many steps


def _gru_operands(seed, cell, B, T, H, shortest):
    gen = torch.Generator().manual_seed(seed)
    longest = GRU_LONGEST.get((B, T, H, shortest), T)
    ops = [torch.randn(B, T, 3, H, generator=gen), torch.randn(3, H, H, generator=gen) / H**0.5,
           0.3 * torch.randn(3, H, generator=gen),
           None if cell == "gru" else torch.rand(B, T, generator=gen),
           torch.randint(shortest, longest + 1, (B,), generator=gen, dtype=torch.int32),
           0.5 * torch.randn(B, H, generator=gen), torch.randn(B, T, H, generator=gen)]
    return [None if t is None else t.cuda() for t in ops]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gru", "agru", "augru"])
@pytest.mark.parametrize("B,T,H,shortest", GRU_SHAPES)
def test_gru_kernels_match_plain(card, cell, B, T, H, shortest):
    from xdeepfm_tpu_torch.ops.gru_cuda import (
        gru_backward,
        gru_backward_reference,
        gru_forward,
        gru_forward_reference,
    )

    gi, w, b, att, lengths, h0, g = _gru_operands(B + T + H, cell, B, T, H, shortest)
    outs = gru_forward(cell, gi, w, b, att, lengths, h0)
    want = gru_forward_reference(cell, gi, w, b, att, lengths, h0)
    torch.testing.assert_close(outs, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    got = gru_backward(cell, g, gi, w, b, att, lengths, h0, outs)
    for a, e in zip(got, gru_backward_reference(cell, g, gi, w, b, att, lengths, h0, outs)):
        _close(a, e)
    past = torch.arange(T, device="cuda")[None, :] >= lengths[:, None]
    assert (got[0][past] == 0).all()  # no gradient past a row's length
    again = gru_backward(cell, g, gi, w, b, att, lengths, h0, outs)
    assert all(torch.equal(a, c) for a, c in zip(got, again))  # deterministic


@pytest.mark.cuda
def test_gru_kernels_reject_bad_input(card):
    from xdeepfm_tpu_torch.ops.gru_cuda import gru_backward, gru_forward

    gi, w, b, att, lengths, h0, g = _gru_operands(1, "augru", 64, 5, 10, 0)
    good = ["augru", gi, w, b, att, lengths, h0]
    for i, bad in ((0, "lstm"), (1, gi.double()), (1, gi.cpu()), (2, w[:, :9]), (3, b.T),
                   (4, None), (5, lengths.long()), (6, h0[:32]), (1, gi.transpose(0, 1))):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            gru_forward(*args)
    wide = _gru_operands(2, "gru", 8, 3, 17, 0)
    with pytest.raises(ValueError, match="gate"):
        gru_forward("gru", *wide[:6])
    with pytest.raises(ValueError):
        gru_backward("augru", g[:, :4], *good[1:], g)


@pytest.mark.cuda
def test_fused_gather_backward_is_deterministic_on_card(card):
    """DIEN's padding row's share of ids: two backward calls bit-equal, and
    within 1e-6 of float64."""
    from xdeepfm_tpu_torch.embeddings import fused_gather

    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 10_000, (400_000,), generator=gen)
    ids[torch.rand(400_000, generator=gen) < 0.5] = 0
    ids = ids.cuda()
    table = torch.randn(10_000, 10, generator=gen).cuda().requires_grad_(True)
    g = torch.randn(400_000, 10, generator=gen).cuda()
    first, second = (torch.autograd.grad(fused_gather((table,), ids), table, g)[0] for _ in range(2))
    assert torch.equal(first, second)
    want = torch.zeros(10_000, 10, dtype=torch.float64, device="cuda").index_add_(0, ids, g.double())
    _close(first.double(), want, rtol=1e-6)


def _dien_pair():
    from xdeepfm_tpu_torch.features import VarLenSparseFeat
    from xdeepfm_tpu_torch.models import DIEN

    def hist(name):
        return VarLenSparseFeat(SparseFeat(name, 200, 10, embedding_name="item"), 20,
                                length_name="seq_length")

    cols = [SparseFeat("user", 200, 10), SparseFeat("item", 200, 10), DenseFeat("score"),
            hist("hist_item"), hist("neg_hist_item")]
    rng = np.random.default_rng(8)
    n = 600
    lengths = rng.integers(0, 21, n)
    valid = np.arange(20)[None, :] < lengths[:, None]
    x = {"user": rng.integers(0, 200, n), "item": rng.integers(0, 200, n),
         "score": rng.uniform(0, 1, n).astype(np.float32), "seq_length": lengths,
         "hist_item": rng.integers(1, 200, (n, 20)) * valid,
         "neg_hist_item": rng.integers(1, 200, (n, 20)) * valid}
    models = [DIEN(cols, ["item"], gru_type="AUGRU", use_negsampling=True,
                   dnn_hidden_units=(32, 16), device=d) for d in ("cuda", "cpu")]
    flat = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flatten_tree(models[1].get_weights()["params"])}
    for m in models:
        m.set_weights({"params": unflatten_tree(flat), "batch_stats": {}})
    return models, x, (x["item"] % 2).astype(np.float32)


@pytest.mark.cuda
def test_dien_gradients_through_gru_kernels_match_plain(card):
    """Every parameter's gradient of one DIEN step (BCE + aux loss) with the
    kernels (2 + 2 launches) against the plain versions on the card, and the
    scores against the CPU model."""
    from xdeepfm_tpu_torch.ops.gru_cuda import gru_backward, gru_forward

    (gpu, cpu), x, y = _dien_pair()
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in gpu.schema.pack(x).items()}
    yb = torch.as_tensor(y, device="cuda")
    grads, launches = {}, {}
    for backend in (None, "torch"):
        for m in gpu.module.modules():
            if hasattr(m, "backend"):
                m.backend = backend
        gpu.module.zero_grad(set_to_none=True)
        before = (gru_forward.launches, gru_backward.launches)
        out = gpu.module(batch, training=True)
        loss = torch.nn.functional.binary_cross_entropy(out["pred"][:, 0], yb) + out["aux_loss"]
        loss.backward()
        launches[backend] = (gru_forward.launches - before[0], gru_backward.launches - before[1])
        grads[backend] = {k: p.grad.clone() for k, p in gpu.module.named_parameters()}
    assert launches == {None: (2, 2), "torch": (0, 0)}
    for k in grads["torch"]:
        _close(grads[None][k], grads["torch"][k])
    for m in gpu.module.modules():
        if hasattr(m, "backend"):
            m.backend = None
    got, want = gpu.predict(x, 256), cpu.predict(x, 256)
    assert want.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# (G, dh, S): the ablation script's width at a smaller G, V2's train width,
# ragged, tiny and dh 16 past one block's 256 threads
ABLATE_SHAPES = [(512, 5, 266), (256, 5, 256), (1001, 3, 39), (2, 1, 5), (3, 16, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["full", "dots", "soft"])
@pytest.mark.parametrize("G,dh,S", ABLATE_SHAPES)
def test_ablation_kernels_match_plain(card, variant, G, dh, S):
    """Each ablation kernel against its plain version, within 1e-5 of the
    largest |o| (fp32 sums of S terms in another order), bit-equal over two
    runs, one launch a call."""
    from xdeepfm_tpu_torch.ops import attn_ablate_cuda as ab

    gen = torch.Generator().manual_seed(G + dh + S)
    q, k, v = (torch.randn(G, dh, S, generator=gen).cuda() for _ in range(3))
    kernel = ab.KERNELS[variant]
    before = kernel.launches
    got = kernel(q, k, v, dh ** -0.5)
    again = kernel(q, k, v, dh ** -0.5)
    torch.cuda.synchronize()
    assert kernel.launches - before == 2
    want = ab.REFERENCES[variant](q, k, v, dh ** -0.5)
    _close(got, want, rtol=1e-5)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_ablation_kernels_reject_bad_input(card):
    from xdeepfm_tpu_torch.ops.attn_ablate_cuda import ablate_full, ablate_soft

    q = torch.randn(4, 5, 40, device="cuda")
    for bad in (q.double(), q.cpu(), q[:, :, :20], q.transpose(1, 2), q[:, :, ::2]):
        with pytest.raises(ValueError):
            ablate_full(bad, q, q, 1.0)
    wide = torch.randn(2, 17, 8, device="cuda")
    with pytest.raises(ValueError):
        ablate_soft(wide, wide, wide, 1.0)
    long = torch.randn(1, 16, 4000, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        ablate_soft(long, long, long, 1.0)


@pytest.mark.cuda
def test_cli_eval_trains_on_card(card, tmp_path):
    """``xdftrain --mode eval`` on the card through the native parser: the
    CIN kernels launch 2 + 2 + 2 times a step, the artifacts are written and
    the eval AUC is a probability."""
    import json
    import os

    from xdeepfm_tpu_torch import native
    from xdeepfm_tpu_torch.cli.xdftrain import main

    rng = np.random.default_rng(0)
    path = tmp_path / "train.txt"
    with open(path, "w") as f:
        for _ in range(1000):
            dense = [str(rng.integers(0, 50)) if rng.uniform() > 0.1 else "" for _ in range(13)]
            sparse = [f"{rng.integers(0, 40):08x}" for _ in range(26)]
            f.write("\t".join([str(rng.integers(0, 2))] + dense + sparse) + "\n")
    flags = ["--use_native_parser"] if native.available() else []
    out = str(tmp_path / "out")
    before = (cin_rows_forward.launches, cin_rows_backward.launches, cin_rows_dw.launches)
    log = main(["--data_path", str(path), "--out_dir", out, "--epochs", "2", "--batch_size",
                "256", "--verbose", "0", "--device", "cuda", *flags])
    launched = [a.launches - b for a, b in zip(
        (cin_rows_forward, cin_rows_backward, cin_rows_dw), before)]
    steps = 2 * -(-900 // 256)  # 900 train rows, 2 epochs
    assert launched[1] == launched[2] == 2 * steps and launched[0] > 2 * steps
    for name in ("history.json", "preprocess.pkl", "training_log.json", "xdeepfm_best.weights",
                 "xdeepfm_weights.bin"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "training_log.json")) as f:
        saved = json.load(f)
    assert saved["model_config"]["device"] == "cuda" and saved["data_info"]["train_samples"] == 900
    assert 0.0 <= log["results"]["eval_auc"] <= 1.0


# ------------------------------------------- the FM family (no kernel of its own)

def _fm_family():
    from xdeepfm_tpu_torch import models as M

    def sparse(c):
        return [f for f in c if isinstance(f, SparseFeat)]

    return {
        "deepfm": lambda c, d: M.DeepFM(c, c, dnn_hidden_units=(32,), device=d),
        "wdl": lambda c, d: M.WDL(c, c, dnn_hidden_units=(32,), device=d),
        "nfm": lambda c, d: M.NFM(c, c, dnn_hidden_units=(32,), device=d),
        "afm": lambda c, d: M.AFM(c, sparse(c), attention_factor=4, device=d),
        "ifm": lambda c, d: M.IFM(c, c, dnn_hidden_units=(32,), device=d),
        "dcn": lambda c, d: M.DCN(c, c, dnn_hidden_units=(32,), device=d),
        "dcnmix": lambda c, d: M.DCNMix(c, c, dnn_hidden_units=(32,), low_rank=4,
                                        num_experts=2, device=d),
        "dcn_mixed_dims": lambda c, d: M.DCN(c, c, dnn_hidden_units=(32,), device=d),
    }


def _all_launches():
    from xdeepfm_tpu_torch.ops.attn_ablate_cuda import ablate_dots, ablate_full, ablate_soft
    from xdeepfm_tpu_torch.ops.gru_cuda import gru_backward, gru_forward
    from xdeepfm_tpu_torch.ops.lane_attention_cuda import la_backward, la_forward

    return [fn.launches for fn in (
        cin_rows_forward, cin_rows_backward, cin_rows_dw, ce_rows_forward,
        ce_rows_backward, sa_forward, sa_backward, ab_forward, ab_backward, la_forward,
        la_backward, gru_forward, gru_backward, ablate_full, ablate_dots, ablate_soft)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_fm_family()))
def test_fm_family_step_on_card_matches_cpu(card, name):
    """One SGD step of each FM-family model on the card against the CPU
    model from the same weights (each weight change within 1e-4 of its
    largest), the predictions after it within 1e-5, and no hand-written
    kernel launched; ``dcn_mixed_dims`` has C3-C5 at dim 4."""
    dims = [10, 10, 10, 4, 4, 4] if name == "dcn_mixed_dims" else [10] * 6
    cols = [SparseFeat(f"C{i}", 100, d) for i, d in enumerate(dims)] + [
        DenseFeat(f"I{i}") for i in range(3)
    ]
    make = _fm_family()[name]
    gpu, cpu = make(cols, "cuda"), make(cols, "cpu")
    rng = np.random.default_rng(7)
    flat = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flatten_tree(cpu.get_weights()["params"])}
    weights = {"params": unflatten_tree(flat), "batch_stats": {}}
    n = 256
    x = {f"C{i}": rng.integers(0, 100, n) for i in range(6)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(3)})
    y = (rng.uniform(size=n) < 0.4).astype(np.float32)
    before = _all_launches()
    deltas, preds = [], []
    for m in (gpu, cpu):
        m.set_weights(weights)
        m.compile("sgd", "binary_crossentropy")
        m.fit(x, y, batch_size=n, epochs=1, verbose=0, shuffle=False)
        after = dict(flatten_tree(m.get_weights()["params"]))
        deltas.append({k: np.asarray(after[k]) - v for k, v in flat.items()})
        preds.append(m.predict(x, 128))
    assert _all_launches() == before
    for k, want in deltas[1].items():
        np.testing.assert_allclose(deltas[0][k], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max() + 1e-8, err_msg=k)
    assert preds[1].std() > 1e-3
    np.testing.assert_allclose(preds[0], preds[1], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The rank grid (parallel/) on the card: co-located ranks over gloo on CUDA
# tensors (NCCL refuses two ranks on one GPU) and a one-rank NCCL group.
# ---------------------------------------------------------------------------

_GRID_RANK = r'''
import json, sys
import torch
import torch.distributed as dist
world, rank, port, backend, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
res = {}
t = torch.arange(4, dtype=torch.float32, device=dev) + rank
dist.all_reduce(t)
res["all_reduce"] = t.tolist()
t = torch.full((3,), float(rank + 1), device=dev)
dist.broadcast(t, 0)
res["broadcast"] = t.tolist()
parts = [torch.empty(2, device=dev) for _ in range(world)]
dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
res["all_gather"] = torch.cat(parts).tolist()
# rank r sends r + 1 rows of value r to every rank: ragged receives
recv = torch.empty(sum(range(1, world + 1)), device=dev)
dist.all_to_all_single(recv, torch.full((world * (rank + 1),), float(rank), device=dev),
                       output_split_sizes=list(range(1, world + 1)),
                       input_split_sizes=[rank + 1] * world)
res["all_to_all_single"] = recv.tolist()
if world > 1:
    from xdeepfm_tpu_torch.parallel import make_mesh
    from xdeepfm_tpu_torch.parallel.mesh import all_gather_rows
    from xdeepfm_tpu_torch.parallel.sharded_embedding import sharded_lookup, sharded_lookup_a2a
    mesh = make_mesh(device=dev)
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(64, 8, generator=gen).to(dev)
    ids = torch.randint(0, 64, (16, 5), generator=gen).to(dev)
    w = torch.randn(16, 5, 8, generator=gen).to(dev)
    E, D = mesh.shape["embed"], mesh.shape["data"]
    for name, fn in (("psum", sharded_lookup), ("a2a", sharded_lookup_a2a)):
        S = 64 // E
        shard = table[mesh.embed_index * S : (mesh.embed_index + 1) * S].clone().requires_grad_()
        # psum: the batch split over data; a2a: over both axes
        b = 16 // (world if name == "a2a" else D)
        lo = (rank if name == "a2a" else mesh.data_index) * b
        vals = fn(shard, ids[lo : lo + b], mesh)
        (w[lo : lo + b] * vals.square()).sum().backward()
        res[name + "_vals_equal"] = bool(torch.equal(vals, table[ids[lo : lo + b]]))
        full = table.clone().requires_grad_()
        (w * full[ids].square()).sum().backward()
        got = all_gather_rows(shard.grad, mesh, "embed")
        res[name + "_grad_err"] = float((got - full.grad).abs().max() / full.grad.abs().max())
json.dump(res, open(f"{out}/rank{rank}.json", "w"))
dist.destroy_process_group()
'''


def _grid_ranks(tmp_path, world, backend):
    import json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", _GRID_RANK, str(world), str(r), str(port),
                               backend, str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [json.load(open(tmp_path / f"rank{r}.json")) for r in range(world)]


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("gloo", 2), ("gloo", 4), ("nccl", 1)])
def test_collectives_on_cuda_tensors(card, tmp_path, backend, world):
    """The collectives the grid runs, on CUDA tensors: all_reduce,
    broadcast, all_gather and all_to_all_single with ragged split sizes;
    with more than one rank, the psum and a2a lookups of a row-sharded table
    bit-equal to the take and their gradients within 1e-6 of its largest."""
    for rank, res in enumerate(_grid_ranks(tmp_path, world, backend)):
        assert res["all_reduce"] == [world * (world - 1) / 2 + i * world for i in range(4)]
        assert res["broadcast"] == [1.0] * 3
        assert res["all_gather"] == [float(r) for r in range(world) for _ in range(2)]
        assert res["all_to_all_single"] == [float(j) for j in range(world) for _ in range(j + 1)]
        if world > 1:
            assert res["psum_vals_equal"] and res["a2a_vals_equal"]
            assert res["psum_grad_err"] < 1e-6 and res["a2a_grad_err"] < 1e-6
