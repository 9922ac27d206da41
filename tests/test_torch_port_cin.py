"""PyTorch port: the CIN contraction and the CIN layer against the JAX package.

Inputs are seeded numpy arrays handed to both sides.  On the CPU the port
runs its plain version; the JAX side runs the Pallas kernel in interpret mode
(as tests/test_cin_pallas.py does) and its XLA lowering.  Both sides are fp32
on the CPU, hence rtol = atol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xdeepfm_tpu.nn.interaction import CIN as JaxCIN
from xdeepfm_tpu.ops import cin_pallas as cp
from xdeepfm_tpu.ops.cin import cin_rows_contract as jax_cin_rows_contract
from xdeepfm_tpu.ops.cin import set_cin_backend
from xdeepfm_tpu_torch.nn.interaction import CIN
from xdeepfm_tpu_torch.ops.cin import cin_rows_contract
from xdeepfm_tpu_torch.ops.cin_cuda import cin_rows_forward, cin_rows_reference
from xdeepfm_tpu_torch.scripts import bench_cin_fwd

# (N, H, M, O): tests/test_cin_pallas.py's (B, H, M, D, O) shapes as rows
# N = B * D, plus a layer-0 shape of the canonical model, narrowed.
SHAPES = [(32, 16, 5, 12), (160, 26, 26, 32), (40, 13, 26, 8), (40, 26, 26, 32)]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def interpret_mode():
    cp.set_interpret(True)
    yield
    cp.set_interpret(False)


def _inputs(rng, N, H, M, O):
    # W at the CIN init's scale, 1/sqrt(H*M): outputs stay O(1), so the fp32
    # rounding of two summation orders stays far below 1e-5
    return (
        rng.normal(size=(N, H)).astype(np.float32),
        rng.normal(size=(N, M)).astype(np.float32),
        (rng.normal(size=(O, H * M)) / np.sqrt(H * M)).astype(np.float32),
        rng.normal(size=(O,)).astype(np.float32),
    )


def _port_outputs(arrays):
    t = [torch.from_numpy(a) for a in arrays]
    return {
        "cin_rows_reference": cin_rows_reference(*t).numpy(),
        "cin_rows_contract": cin_rows_contract(*t).numpy(),
    }


@pytest.mark.parametrize("N,H,M,O", SHAPES)
def test_cin_rows_match_jax_pallas_interpret(rng, interpret_mode, N, H, M, O):
    arrays = _inputs(rng, N, H, M, O)
    want = np.asarray(cp.cin_pallas_rows(*map(jnp.asarray, arrays)))
    for name, got in _port_outputs(arrays).items():
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("N,H,M,O", SHAPES)
def test_cin_rows_match_jax_xla(rng, N, H, M, O):
    arrays = _inputs(rng, N, H, M, O)
    want = np.asarray(
        jax_cin_rows_contract(*map(jnp.asarray, arrays), backend="xla")
    )
    for name, got in _port_outputs(arrays).items():
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def test_cin_rows_strided_h_matches_contiguous(rng):
    """Split-half feeds a column slice of the previous layer's output."""
    h, x0, W, b = (torch.from_numpy(a) for a in _inputs(rng, 40, 26, 13, 8))
    wide = torch.cat([h, torch.zeros_like(h)], dim=1)[:, :26]
    assert not wide.is_contiguous()
    torch.testing.assert_close(
        cin_rows_contract(wide, x0, W, b), cin_rows_contract(h, x0, W, b),
        rtol=0, atol=0,
    )


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("split_half", [True, False])
def test_cin_module_matches_jax(rng, interpret_mode, split_half, backend):
    B, F, D = 6, 5, 4
    x = rng.normal(size=(B, F, D)).astype(np.float32)
    jax_cin = JaxCIN(field_size=F, layer_size=(8, 6), split_half=split_half)
    params = {
        k: 0.3 * rng.normal(size=np.shape(v)).astype(np.float32)
        for k, v in jax_cin.init(jax.random.PRNGKey(0), jnp.asarray(x))[
            "params"
        ].items()
    }
    set_cin_backend(backend)
    try:
        want = np.asarray(jax_cin.apply({"params": params}, jnp.asarray(x)))
    finally:
        set_cin_backend("auto")
    port = CIN(F, (8, 6), split_half=split_half)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, 8 // 2 + 6 if split_half else 14)
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_path_never_counts_a_kernel_launch(rng):
    before = cin_rows_forward.launches
    port = CIN(5, (8, 6))
    with torch.no_grad():
        port(torch.from_numpy(rng.normal(size=(3, 5, 4)).astype(np.float32)))
    cin_rows_contract(*(torch.from_numpy(a) for a in _inputs(rng, 8, 3, 2, 1)))
    assert cin_rows_forward.launches == before == 0


@pytest.mark.parametrize(
    "make",
    [
        lambda t: t,  # CPU tensors: the kernel takes CUDA tensors only
        lambda t: [a.double() for a in t],
    ],
    ids=["cpu", "float64"],
)
def test_kernel_wrapper_rejects_what_it_cannot_run(rng, make):
    t = [torch.from_numpy(a) for a in _inputs(rng, 8, 3, 2, 1)]
    with pytest.raises(ValueError):
        cin_rows_forward(*make(t))
    assert cin_rows_forward.launches == 0


def test_bench_script_times_the_plain_version_on_cpu(capsys):
    outs = bench_cin_fwd.main(["--batches", "2", "--repeats", "1", "--device", "cpu"])
    assert [(o["layer"], o["N"], o["H"], o["O"], o["strided_h"]) for o in outs] == [
        ("layer0", 20, 26, 256, False), ("layer1", 20, 128, 128, True)]
    assert all(o["max_abs_err_vs_plain"] == 0.0 and len(o["ms"]) == 1 for o in outs)
    assert len(capsys.readouterr().out.splitlines()) == 2
    assert cin_rows_forward.launches == 0
