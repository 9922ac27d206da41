"""PyTorch port, engine repairs: the deterministic embedding backward, full
training checkpoints and conv kernels in the weight tree.

* ``fused_gather`` / ``sorted_segment_sum``: the table gradient every gather
  gives, held against autograd's (``index_select``'s scatter-add, in
  float64) on the CPU, including a run of one id as long as DIEN's padding
  row's share of a step.
  On the card it is bit-equal between calls (``chip_smoke.py``'s
  ``grads_not_reproduced`` and the ``cuda`` tests).
* ``save_checkpoint`` / ``load_checkpoint``: a model restored after 2 epochs
  has bit-equal params and optimizer state, and its third epoch gives the
  History of the uninterrupted run; ``ModelCheckpoint`` writes the full
  checkpoint by default.
* ``from_jax_weights`` / ``to_jax_weights`` on an ``nn.Conv2d``: a round
  trip, and the conv against a flax ``nn.Conv`` given the same weights.

Tolerances: gradients rtol 1e-6 and within 1e-6 of their largest entry (fp32
sums in another order); the conv rtol/atol 1e-5; checkpoints exact.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from xdeepfm_tpu_torch.callbacks import ModelCheckpoint
from xdeepfm_tpu_torch.embeddings import fused_gather, sorted_segment_sum
from xdeepfm_tpu_torch.features import DenseFeat, SparseFeat
from xdeepfm_tpu_torch.models import xDeepFM
from xdeepfm_tpu_torch.weights import canonical_paths, flatten_tree, from_jax_weights, to_jax_weights


def _close_to_max(got, want):
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()) + 1e-12)


@pytest.mark.parametrize("n,rows,dims,pad_share", [
    (1000, 50, (10,), 0.0), (5000, 300, (10, 1), 0.5), (1, 4, (3,), 0.0), (70_000, 1000, (4,), 0.9)])
def test_fused_gather_backward_matches_autograd(n, rows, dims, pad_share):
    """The segment sum of the sorted ids against ``index_select``'s
    scatter-add; ``pad_share`` of the ids are 0, one long run."""
    rng = np.random.default_rng(n)
    ids = rng.integers(0, rows, n)
    ids[rng.uniform(size=n) < pad_share] = 0
    ids = torch.from_numpy(ids)
    tables = [torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).requires_grad_(True)
              for d in dims]
    g = torch.from_numpy(rng.normal(size=(n, sum(dims))).astype(np.float32))
    out = fused_gather(tables, ids)
    assert out.shape == (n, sum(dims))
    torch.testing.assert_close(out, torch.cat(tables, 1).index_select(0, ids), rtol=0, atol=0)
    got = torch.autograd.grad(out, tables, g)
    # autograd's scatter-add, in float64 (its fp32 sums a run one row after
    # another, which strays by ~1e-5 of a 63 000-row run's total)
    ref = [t.detach().double().requires_grad_(True) for t in tables]
    want = torch.autograd.grad(torch.cat(ref, 1).index_select(0, ids), ref, g.double())
    for a, b in zip(got, want):
        _close_to_max(a.double(), b)
    again = torch.autograd.grad(fused_gather(tables, ids), tables, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_sorted_segment_sum_edges():
    v = torch.arange(12, dtype=torch.float64).reshape(6, 2)
    ids = torch.tensor([3, 3, 3, 3, 3, 3])  # one run over every row
    out = sorted_segment_sum(v, ids, 5)
    assert out.shape == (5, 2) and (out[:3] == 0).all() and (out[4] == 0).all()
    torch.testing.assert_close(out[3], v.sum(0))
    assert sorted_segment_sum(v[:0], ids[:0], 5).abs().sum() == 0


# ---------------------------------------------------------------- checkpoint


def _model(seed=5):
    cols = [SparseFeat(f"C{i}", 16, 4) for i in range(3)] + [DenseFeat("I0")]
    m = xDeepFM(cols, cols, dnn_hidden_units=(8,), cin_layer_size=(4,), seed=seed, device="cpu")
    m.compile("adam", "binary_crossentropy", metrics=["auc"])
    return m


def _xy(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, 16, n) for i in range(3)}
    x["I0"] = rng.uniform(0, 1, n).astype(np.float32)
    return x, (x["C0"] % 2).astype(np.float32)


def _opt_state(model):
    paths = canonical_paths(model.module)
    names = {id(p): n for n, p in model.module.named_parameters()}
    return {(paths[names[id(p)]], k): v.clone() for p, st in model.optimizer.state.items()
            for k, v in st.items()}


def test_checkpoint_resumes_the_uninterrupted_run(tmp_path):
    x, y = _xy()
    fit = dict(batch_size=64, verbose=0, shuffle=False, validation_split=0.25)
    full = _model()
    full_hist = full.fit(x, y, epochs=3, **fit).history

    first = _model()
    first.fit(x, y, epochs=2, **fit)
    ckpt = str(tmp_path / "ckpt.bin")
    first.save_checkpoint(ckpt, epoch=2)
    resumed = _model(seed=9)  # other initial weights, overwritten by the load
    assert resumed.load_checkpoint(ckpt) == 2
    for (k, a), (_, b) in zip(flatten_tree(first.get_weights()["params"]),
                              flatten_tree(resumed.get_weights()["params"])):
        np.testing.assert_array_equal(a, b, err_msg=k)
    want_state, got_state = _opt_state(first), _opt_state(resumed)
    assert sorted(got_state) == sorted(want_state) and len(want_state) > 0
    for key, v in want_state.items():
        assert got_state[key].dtype == v.dtype and torch.equal(got_state[key], v), key
    third = resumed.fit(x, y, epochs=3, initial_epoch=2, **fit).history
    for k, v in full_hist.items():
        assert third[k] == v[2:], k  # the same floats: the run resumed exactly


def test_model_checkpoint_writes_the_full_checkpoint(tmp_path):
    x, y = _xy(128)
    m = _model()
    path = str(tmp_path / "full.ckpt")
    m.fit(x, y, batch_size=64, epochs=1, verbose=0, callbacks=[ModelCheckpoint(filepath=path)])
    with np.load(path) as data:
        assert "epoch" in data.files and any(k.startswith("opt_state/") for k in data.files)
    p1 = m.predict(x, 64)
    for load in ("load_checkpoint", "load_weights"):
        m2 = _model(seed=11)
        getattr(m2, load)(path)
        np.testing.assert_array_equal(m2.predict(x, 64), p1)
    with pytest.raises(RuntimeError, match="compile"):
        cols = [SparseFeat("C0", 4, 2)]
        xDeepFM(cols, cols, device="cpu").save_checkpoint(path)


# --------------------------------------------------------------- conv kernels


class _ConvNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 5, (3, 5), padding="same")
        self.head = nn.Linear(5, 2)

    def forward(self, x):  # x [B, C, H, W]
        return self.head(self.conv(x).mean((2, 3)))


def test_conv_kernels_round_trip_and_match_flax():
    torch.manual_seed(0)
    net = _ConvNet()
    tree = to_jax_weights(net)
    assert tree["params"]["conv"]["kernel"].shape == (3, 5, 3, 5)  # [kh, kw, in, out]
    assert tree["params"]["head"]["kernel"].shape == (5, 2)
    assert canonical_paths(net)["conv.weight"] == "conv/kernel"
    back = _ConvNet()
    back.load_state_dict(from_jax_weights(tree))
    for (k, a), (_, b) in zip(net.state_dict().items(), back.state_dict().items()):
        assert torch.equal(a, b), k
    # the flax conv (NHWC, SAME, odd kernel) with the same weights
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    conv = fnn.Conv(5, (3, 5), padding="SAME")
    params = {"params": {k: jnp.asarray(v) for k, v in tree["params"]["conv"].items()}}
    want = conv.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = back.conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
