"""PyTorch port: the CIN's bf16 mode and its backend switch against the JAX package.

``xdeepfm_tpu_torch.ops.cin.set_cin_precision("bf16")`` is
``cin_pallas.set_cin_precision("bf16")``: the forward rounds h, x0 and W to
bf16 and each z = h x0 once; the fused backward rounds g and W only (dh and
dx0 from the fp32 h and x0, dW from the bf16 g); the legacy backward runs
the bf16 forward with permuted weights and takes dW in fp32 from the raw g.
On the CPU the port runs its plain versions of the bf16 kernels; the JAX
side runs the Pallas kernels in interpret mode under the same precision,
restored in a ``finally``.  Inputs are seeded numpy arrays handed to both.

Tolerance: each output and gradient within 1e-5 of its largest |value|:
both sides round the same operands and differ only in the order of their
fp32 sums, about 2e-7 of the largest entry at these shapes.  The bf16 mode
moves the outputs by far more (the forward and model tests assert over 50
times the tolerance), so the tolerance tells the modes apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xdeepfm_tpu.features as jf
import xdeepfm_tpu_torch.features as tf
from xdeepfm_tpu.models import xDeepFM as JaxXDeepFM
from xdeepfm_tpu.nn.interaction import cin_feature_maps as jax_cin_feature_maps
from xdeepfm_tpu.ops import cin as jax_cin
from xdeepfm_tpu.ops import cin_pallas as cp
from xdeepfm_tpu_torch import ops
from xdeepfm_tpu_torch.models import xDeepFM
from xdeepfm_tpu_torch.nn.interaction import cin_feature_maps, cin_feature_maps_rows
from xdeepfm_tpu_torch.ops import cin as pc
from xdeepfm_tpu_torch.ops.cin_cuda import (
    cin_rows_backward_bf16,
    cin_rows_forward,
    cin_rows_forward_bf16,
    cin_rows_reference,
    cin_rows_reference_bf16,
)
from xdeepfm_tpu_torch.weights import flatten_tree

REL = 1e-5  # of the largest |value| of each output and gradient
# (N, H, M, O): ragged N (off the TPU's 256-row tile), H not a multiple of 8,
# M 26; and a layer-0 shape of the canonical model, narrowed
SHAPES = [(300, 13, 26, 7), (90, 26, 26, 32)]


def close(got, want, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= REL * top, (label, err, top)
    return err


@pytest.fixture
def bf16():
    """Both packages in the bf16 mode, the JAX kernels in interpret mode."""
    cp.set_interpret(True)
    cp.set_cin_precision("bf16")
    pc.set_cin_precision("bf16")
    try:
        yield
    finally:
        cp.set_interpret(False)
        cp.set_cin_precision("f32")
        cp.set_backward_impl("auto")
        jax_cin.set_cin_backend("auto")
        pc.set_cin_precision("f32")
        pc.set_backward_impl("auto")
        pc.set_cin_backend("auto")


def _inputs(seed, N, H, M, O):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(N, 2 * H)).astype(np.float32),  # h is its left half
        rng.normal(size=(N, M)).astype(np.float32),
        (rng.normal(size=(O, H * M)) / np.sqrt(H * M)).astype(np.float32),
        rng.normal(size=(O,)).astype(np.float32),
        rng.normal(size=(N, O)).astype(np.float32),  # the output's gradient
    )


@pytest.mark.parametrize("impl", ["fused_t", "legacy"])
@pytest.mark.parametrize("N,H,M,O", SHAPES)
def test_bf16_forward_and_backward_match_jax(bf16, impl, N, H, M, O):
    wide, x0, W, b, g = _inputs(N + H + O, N, H, M, O)
    cp.set_backward_impl(impl)
    out, vjp = jax.vjp(cp.cin_pallas_rows, *(jnp.asarray(a) for a in (wide[:, :H], x0, W, b)))
    want = [np.asarray(t) for t in (out, *vjp(jnp.asarray(g)))]

    pc.set_backward_impl(impl)
    args = [torch.from_numpy(a).clone().requires_grad_() for a in (wide, x0, W, b)]
    got = ops.cin_rows_contract(args[0][:, :H], *args[1:])  # split-half's strided view
    got.backward(torch.from_numpy(g))
    h = torch.from_numpy(wide)[:, :H]
    close(cin_rows_reference_bf16(h, *map(torch.from_numpy, (x0, W, b))), want[0], "plain out")
    close(got.detach(), want[0], "out")
    for label, t, w_ in zip(("dh", "dx0", "dW", "db"),
                            (args[0].grad[:, :H], args[1].grad, args[2].grad, args[3].grad),
                            want[1:]):
        close(t, w_, label)
    assert float(args[0].grad[:, H:].abs().max()) == 0.0
    # the modes differ by far more than the tolerance
    f32 = cin_rows_reference(h, *map(torch.from_numpy, (x0, W, b)))
    assert float((f32 - got.detach()).abs().max()) > 50 * REL * float(np.abs(want[0]).max())
    assert cin_rows_forward_bf16.launches == cin_rows_backward_bf16.launches == 0


def test_backward_keeps_the_forward_precision(bf16):
    """A layer run forward in bf16 keeps bf16 in its backward, whatever the
    switch says by then."""
    wide, x0, W, b, g = _inputs(3, 40, 5, 6, 4)
    args = [torch.from_numpy(a).clone().requires_grad_() for a in (wide[:, :5], x0, W, b)]
    out = ops.cin_rows_contract(*args)
    pc.set_cin_precision("f32")
    out.backward(torch.from_numpy(g))
    pc.set_cin_precision("bf16")
    again = [t.detach().clone().requires_grad_() for t in args]
    ops.cin_rows_contract(*again).backward(torch.from_numpy(g))
    for a, c in zip(args, again):
        assert torch.equal(a.grad, c.grad)


def test_setters_and_their_messages(bf16):
    assert ops.get_cin_precision() == "bf16" and ops.get_cin_backend() == "auto"
    with pytest.raises(ValueError, match="'f32' or 'bf16', got 'fp16'"):
        ops.set_cin_precision("fp16")
    assert ops.get_cin_precision() == "bf16"
    with pytest.raises(ValueError, match="unknown CIN backend 'cuda'"):
        ops.set_cin_backend("cuda")
    with pytest.raises(ValueError, match="unknown CIN backend 'triton'"):
        ops.cin_rows_contract(*(torch.zeros(s) for s in ((4, 2), (4, 3), (1, 6), (1,))),
                              backend="triton")
    for name in pc.BACKENDS:
        ops.set_cin_backend(name)
        assert ops.get_cin_backend() == name
    # the kernel backends take CUDA tensors only: no quiet fallback
    t = [torch.zeros(s) for s in ((4, 2), (4, 3), (1, 6), (1,))]
    for name in ("pallas", "pallas_sm"):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            ops.cin_rows_contract(*t, backend=name)
        ops.set_cin_backend(name)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            ops.cin_rows_contract(*t)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        cin_rows_forward_bf16(*t)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        cin_rows_backward_bf16(torch.zeros(4, 1), *t[:3])
    assert cin_rows_forward.launches == cin_rows_forward_bf16.launches == 0


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_layer_contract_matches_jax_backends(bf16, precision):
    """``cin_layer_contract`` [B, H, D] under each JAX backend name: "xla" and
    "fused" are the XLA lowerings (fp32 in either mode, as in JAX), "pallas"
    the kernel, whose CPU counterpart in the port is "auto" (its plain
    version); the port's "pallas" raises on a CPU tensor."""
    cp.set_cin_precision(precision)
    pc.set_cin_precision(precision)
    rng = np.random.default_rng(11)
    B, H, M, D, O = 7, 13, 26, 4, 12
    h, x0 = rng.normal(size=(B, H, D)), rng.normal(size=(B, M, D))
    W, b = rng.normal(size=(O, H * M)) / np.sqrt(H * M), rng.normal(size=O)
    arrays = [a.astype(np.float32) for a in (h, x0, W, b)]
    t = [torch.from_numpy(a) for a in arrays]
    outs = {}
    for jax_name, port_name in (("xla", "xla"), ("fused", "fused"), ("pallas", "auto")):
        want = np.asarray(jax_cin.cin_layer_contract(*map(jnp.asarray, arrays),
                                                     backend=jax_name))
        pc.set_cin_backend(port_name)
        got = ops.cin_layer_contract(*t)  # the global switch
        close(got, want, f"{jax_name} global")
        close(ops.cin_layer_contract(*t, backend=port_name), want, f"{jax_name} argument")
        outs[jax_name] = got
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.cin_layer_contract(*t, backend="pallas")
    assert torch.equal(outs["xla"], outs["fused"])
    moved = float((outs["pallas"] - outs["xla"]).abs().max())
    assert (moved > 1e-3) == (precision == "bf16"), moved


@pytest.mark.parametrize("split_half", [True, False])
def test_cin_feature_maps_match_jax(bf16, split_half):
    """The [B, S, D] feature maps against ``interaction.cin_feature_maps``,
    in the bf16 mode through the JAX kernel."""
    jax_cin.set_cin_backend("pallas")
    rng = np.random.default_rng(5)
    B, F, D, sizes = 6, 5, 4, (8, 6)
    x = rng.normal(size=(B, F, D)).astype(np.float32)
    fields = [F] + [s // 2 if split_half else s for s in sizes[:-1]]
    kernels = [(rng.normal(size=(s, fn * F)) / np.sqrt(fn * F)).astype(np.float32)
               for s, fn in zip(sizes, fields)]
    biases = [rng.normal(size=s).astype(np.float32) for s in sizes]
    want = np.asarray(jax_cin_feature_maps(jnp.asarray(x), [jnp.asarray(k) for k in kernels],
                                           [jnp.asarray(c) for c in biases], jax.nn.relu,
                                           sizes, split_half))
    args = (torch.from_numpy(x), [torch.from_numpy(k) for k in kernels],
            [torch.from_numpy(c) for c in biases], torch.relu, sizes, split_half)
    got = cin_feature_maps(*args)
    assert got.shape == want.shape == (B, sizes[0] // 2 + sizes[1] if split_half else 14, D)
    close(got, want, "maps")
    rows = cin_feature_maps_rows(*args)
    assert torch.equal(got, rows.view(B, D, -1).transpose(1, 2))


N_SPARSE, VOCAB, DIM, N_DENSE = 4, 50, 8, 2
ARCH = dict(dnn_hidden_units=(16, 16), cin_layer_size=(8, 6))


def _cols(mod):
    return [mod.SparseFeat(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)] + [
        mod.DenseFeat(f"I{i}") for i in range(N_DENSE)
    ]


def test_xdeepfm_bf16_predict_and_sgd_step_match_jax(bf16):
    """The whole model in the bf16 mode: the JAX model's CIN on the Pallas
    kernels (interpret mode), the port's from ``from_jax_weights`` (through
    ``set_weights``) on the plain bf16 versions; predictions and one SGD
    step's weight changes."""
    jax_cin.set_cin_backend("pallas")
    rng = np.random.default_rng(2)
    n = 96
    x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
    y = (rng.uniform(size=n) < 0.3).astype(np.float32)
    jm = JaxXDeepFM(_cols(jf), _cols(jf), **ARCH)
    jm.compile("sgd", "binary_crossentropy", lr=0.5)
    w = jm.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"])
    jm.set_weights(w)
    pm = xDeepFM(_cols(tf), _cols(tf), device="cpu", **ARCH)
    pm.set_weights(w)
    pm.compile("sgd", "binary_crossentropy", lr=0.5)

    want = jm.predict(x, n)
    close(pm.predict(x, n), want, "predict")
    pc.set_cin_precision("f32")
    f32 = pm.predict(x, n)
    pc.set_cin_precision("bf16")
    assert float(np.abs(f32 - want).max()) > 50 * REL * float(np.abs(want).max())

    before = dict(flatten_tree(w["params"]))
    jm.fit(x, y, batch_size=n, epochs=1, verbose=0, shuffle=False)
    pm.fit(x, y, batch_size=n, epochs=1, verbose=0, shuffle=False)
    got = dict(flatten_tree(pm.get_weights()["params"]))
    want = dict(flatten_tree(jm.get_weights()["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k] - before[k], np.asarray(want[k]) - before[k], f"step {k}")
