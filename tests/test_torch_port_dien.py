"""PyTorch port, DIEN slice: the layers under DIEN against the JAX package
(the model is in ``tests/test_torch_port_dien_models.py``): ``sequence_pool``,
the varlen lookups, ``LocalActivationUnit``, ``AttentionSequencePoolingLayer``,
``GRU``, ``DynamicGRU`` and the plain versions of the GRU-scan kernels.

Inputs come from a numpy seed and go to both sides; weights are carried from
the JAX side with ``from_jax_weights``.  Both sides run fp32 on the CPU.  The
recurrences run on both of each side's routes: the JAX Pallas kernel in
interpret mode (``gru_pallas.set_interpret(True)``, as
``tests/test_gru_pallas.py`` runs it) against the port's ``gru_scan`` (its
plain versions on a CPU tensor), and the JAX ``lax.scan`` against the port's
plain scan (``gru.set_backend("xla")``).

Tolerances: forwards rtol/atol 1e-5; gradients rtol 2e-4, atol 2e-5 (those
of ``tests/test_gru_pallas.py``); the other layers rtol/atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xdeepfm_tpu.features as jf
import xdeepfm_tpu_torch.features as tf
from xdeepfm_tpu.embeddings import EmbeddingCollection as JaxEmbeddingCollection
from xdeepfm_tpu.nn.core import LocalActivationUnit as JaxLAU
from xdeepfm_tpu.nn.sequence import GRU as JaxGRU
from xdeepfm_tpu.nn.sequence import AttentionSequencePoolingLayer as JaxASP
from xdeepfm_tpu.nn.sequence import DynamicGRU as JaxDynamicGRU
from xdeepfm_tpu.nn.sequence import sequence_pool as jax_sequence_pool
from xdeepfm_tpu.ops import gru_pallas
from xdeepfm_tpu_torch.embeddings import EmbeddingCollection
from xdeepfm_tpu_torch.nn.core import LocalActivationUnit
from xdeepfm_tpu_torch.nn.sequence import (
    GRU,
    AGRUCell,
    AttentionSequencePoolingLayer,
    AUGRUCell,
    DynamicGRU,
    sequence_pool,
)
from xdeepfm_tpu_torch.ops import gru as tgru
from xdeepfm_tpu_torch.ops import gru_cuda
from xdeepfm_tpu_torch.weights import flatten_tree, from_jax_weights

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(params=["kernel", "scan"])
def route(request):
    """Each side's kernel route (JAX interpret mode, the port's gru_scan) or
    its plain scan; restored after the test."""
    gru_pallas.set_interpret(request.param == "kernel")
    tgru.set_backend("auto" if request.param == "kernel" else "xla")
    try:
        yield request.param
    finally:
        gru_pallas.set_interpret(False)
        tgru.set_backend("auto")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _load(module, variables):
    module.load_state_dict(from_jax_weights({"params": variables["params"]}), strict=True)
    return module


def _randomize(variables, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return {"params": jax.tree.map(
        lambda v: (scale * rng.standard_normal(np.shape(v))).astype(np.float32),
        variables["params"])}


def _assert_no_launches():
    assert gru_cuda.gru_forward.launches == 0 and gru_cuda.gru_backward.launches == 0


# ---------------------------------------------------------------- pooling


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("masking", [False, True])
def test_sequence_pool_matches_jax(mode, masking):
    rng = np.random.default_rng(3)
    seq = rng.normal(size=(5, 6, 3)).astype(np.float32)
    lengths = np.array([[6], [3], [1], [0], [2]])
    other = (np.arange(6)[None, :] < lengths) if masking else lengths
    want = jax_sequence_pool((jnp.asarray(seq), jnp.asarray(other)), mode, masking)
    got = sequence_pool((torch.from_numpy(seq), torch.from_numpy(other)), mode, masking)
    assert got.shape == (5, 1, 3)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    with pytest.raises(ValueError, match="sum, mean, max"):
        sequence_pool((torch.from_numpy(seq), torch.from_numpy(lengths)), "median")


def _varlen_cols(mod, combiner, length_name):
    return [
        mod.SparseFeat("item", 20, 4),
        mod.VarLenSparseFeat(mod.SparseFeat("hist_item", 20, 4, embedding_name="item"), 5,
                             combiner=combiner, length_name=length_name),
        mod.VarLenSparseFeat(mod.SparseFeat("tags", 7, 4), 3, combiner=combiner,
                             length_name=length_name),
    ]


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("length_name", [None, "seq_length"])
def test_varlen_lookups_match_jax(combiner, length_name):
    rng = np.random.default_rng(4)
    n = 6
    lengths = np.array([5, 2, 0, 1, 3, 4])
    x = {"item": rng.integers(0, 20, n), "seq_length": lengths,
         "hist_item": rng.integers(1, 20, (n, 5)) * (np.arange(5)[None, :] < lengths[:, None]),
         "tags": rng.integers(0, 7, (n, 3))}
    jcols, tcols = _varlen_cols(jf, combiner, length_name), _varlen_cols(tf, combiner, length_name)
    jschema, tschema = jf.FeatureSchema.build(jcols), tf.FeatureSchema.build(tcols)
    jbatch = {k: jnp.asarray(v) for k, v in jschema.pack(x).items()}
    tbatch = {k: torch.from_numpy(v) for k, v in tschema.pack(x).items()}
    jec = JaxEmbeddingCollection(feature_columns=tuple(jcols), schema=jschema, init_std=0.5)
    variables = jec.init(jax.random.PRNGKey(0), jbatch, jcols[1],
                         method=JaxEmbeddingCollection.lookup_varlen_seq)
    tec = _load(EmbeddingCollection(tcols, tschema), variables)
    for jfeat, tfeat in zip(jcols[1:], tcols[1:]):
        for method in ("lookup_varlen_seq", "lookup_varlen_pooled"):
            want = jec.apply(variables, jbatch, jfeat, method=getattr(JaxEmbeddingCollection, method))
            got = getattr(tec, method)(tbatch, tfeat)
            np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=f"{tfeat.name} {method}")
    # the varlen part of stacked_inputs: each varlen field pooled after the sparse ones
    want, _ = jec.apply(variables, jbatch, method=JaxEmbeddingCollection.stacked_inputs)
    got, _ = tec.stacked_inputs(tbatch)
    assert got.shape == (n, 3, 4)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("length_name", [None, "seq_length"])
def test_linear_model_pools_varlen_fields_like_jax(length_name):
    """The first-order term sums each varlen field's pooled 1-dim embedding
    after the sparse fields' (``xdeepfm_tpu/embeddings.py:470-484``)."""
    from xdeepfm_tpu.embeddings import LinearModel as JaxLinearModel
    from xdeepfm_tpu_torch.embeddings import LinearModel

    rng = np.random.default_rng(8)
    n = 6
    lengths = np.array([5, 2, 0, 1, 3, 4])
    x = {"item": rng.integers(0, 20, n), "seq_length": lengths, "score": rng.uniform(size=n),
         "hist_item": rng.integers(1, 20, (n, 5)) * (np.arange(5)[None, :] < lengths[:, None]),
         "tags": rng.integers(0, 7, (n, 3))}
    jcols = _varlen_cols(jf, "mean", length_name) + [jf.DenseFeat("score")]
    tcols = _varlen_cols(tf, "mean", length_name) + [tf.DenseFeat("score")]
    jschema, tschema = jf.FeatureSchema.build(jcols), tf.FeatureSchema.build(tcols)
    jbatch = {k: jnp.asarray(v) for k, v in jschema.pack(x).items()}
    jm = JaxLinearModel(feature_columns=tuple(jcols), schema=jschema)
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jbatch), 8, scale=1.0)
    tm = _load(LinearModel(tcols, tschema), variables)
    got = tm({k: torch.from_numpy(v) for k, v in tschema.pack(x).items()})
    np.testing.assert_allclose(_np(got), _np(jm.apply(variables, jbatch)), **TOL)


# -------------------------------------------------------------- attention


@pytest.mark.parametrize("activation", ["relu", "sigmoid", "dice"])
def test_local_activation_unit_matches_jax(activation):
    """The attention MLP; with Dice (dim 3, the statistics over every
    (sample, step)) also in training mode, with its updated statistics."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(4, 1, 5)).astype(np.float32)
    k = rng.normal(size=(4, 6, 5)).astype(np.float32)
    jm = JaxLAU(hidden_units=(8, 4), embedding_dim=5, activation=activation)
    init = jm.init(jax.random.PRNGKey(1), jnp.asarray(q), jnp.asarray(k))
    variables = dict(_randomize(init, 5), batch_stats=init.get("batch_stats", {}))
    tm = LocalActivationUnit(hidden_units=(8, 4), embedding_dim=5, activation=activation)
    tm.load_state_dict(from_jax_weights(variables), strict=True)
    want = jm.apply(variables, jnp.asarray(q), jnp.asarray(k))
    got = tm(torch.from_numpy(q), torch.from_numpy(k))
    assert got.shape == (4, 6, 1)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    if activation == "dice":
        want, mutated = jm.apply(variables, jnp.asarray(q), jnp.asarray(k), training=True,
                                 mutable=["batch_stats"])
        got = tm(torch.from_numpy(q), torch.from_numpy(k), training=True)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        stats = dict(flatten_tree(jax.tree.map(np.asarray, mutated["batch_stats"])))
        assert sorted(stats) == ["dnn/act_0/bn/mean", "dnn/act_0/bn/var", "dnn/act_1/bn/mean",
                                 "dnn/act_1/bn/var"]
        buffers = dict(tm.named_buffers())
        for path, v in stats.items():
            np.testing.assert_allclose(_np(buffers[path.replace("/", ".")]), v, **TOL,
                                       err_msg=path)


@pytest.mark.parametrize("weight_normalization", [False, True])
def test_attention_sequence_pooling_matches_jax(weight_normalization):
    """Both entries, with a length-0 row: ``forward`` (pooled and scores)
    and ``scores`` against the JAX ``scores_t`` DIEN takes."""
    rng = np.random.default_rng(6)
    B, T, E = 5, 7, 4
    q = rng.normal(size=(B, 1, E)).astype(np.float32)
    k = rng.normal(size=(B, T, E)).astype(np.float32)
    lengths = np.array([[7], [3], [0], [1], [5]], np.int32)
    kw = dict(att_hidden_units=(8, 4), att_activation="relu",
              weight_normalization=weight_normalization, embedding_dim=E)
    jq, jk, jl = map(jnp.asarray, (q, k, lengths))
    for return_score in (False, True):
        jm = JaxASP(return_score=return_score, **kw)
        variables = _randomize(jm.init(jax.random.PRNGKey(2), jq, jk, jl), 6)
        tm = _load(AttentionSequencePoolingLayer(return_score=return_score, **kw), variables)
        want = jm.apply(variables, jq, jk, jl)
        got = tm(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(lengths))
        assert got.shape == ((B, 1, T) if return_score else (B, 1, E))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    want_t = jm.apply(variables, jnp.swapaxes(jq[:, 0], 0, 1), jnp.transpose(jk, (1, 2, 0)),
                      jl.reshape(-1), method=JaxASP.scores_t)  # [T, 1, B]
    got = tm.scores(torch.from_numpy(q[:, 0]), torch.from_numpy(k), torch.from_numpy(lengths[:, 0]))
    np.testing.assert_allclose(_np(got), _np(want_t)[:, 0, :].T, **TOL)
    if weight_normalization:  # the length-0 row: a uniform softmax over T
        np.testing.assert_allclose(_np(got)[2], np.full(T, 1.0 / T), rtol=1e-6)
    else:
        assert (_np(got)[1, 3:] == 0).all()


# ------------------------------------------------------------ recurrences


def _seq(B=8, T=7, I=6, seed=0):
    """The JAX tests' shapes and draws (``tests/test_gru_pallas.py:24-29``)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, I)).astype(np.float32)
    lengths = rng.integers(0, T + 1, size=(B,)).astype(np.int32)
    lengths[0] = 0  # a length-0 row
    att = rng.uniform(size=(B, T)).astype(np.float32)
    return x, lengths, att


def _grads_close(got, want):
    for name in want:
        np.testing.assert_allclose(_np(got[name]), _np(want[name]), **GRAD_TOL, err_msg=name)


def test_gru_matches_jax(route):
    x, lengths, _ = _seq(seed=7)
    jm = JaxGRU(input_size=6, hidden_size=10)
    variables = _randomize(jm.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(lengths)), 7)
    tm = _load(GRU(6, 10), variables)

    def jloss(p, xx):
        outs, hl = jm.apply(p, xx, jnp.asarray(lengths))
        return jnp.sum(jnp.cos(outs)) + jnp.sum(hl * 0.7)

    outs, hl = jm.apply(variables, jnp.asarray(x), jnp.asarray(lengths))
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(variables, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    t_outs, t_hl = tm(xt, torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(t_outs), _np(outs), **TOL)
    np.testing.assert_allclose(_np(t_hl), _np(hl), **TOL)
    assert (_np(t_outs)[0] == 0).all()  # zero past the length (0 here)
    (torch.cos(t_outs).sum() + (t_hl * 0.7).sum()).backward()
    _grads_close({**{n: p.grad for n, p in tm.named_parameters()}, "x": xt.grad},
                 {**jg_p["params"], "x": jg_x})
    # call_t, the transposed entry: frozen states, h_last = the last slice
    want_t, want_last = jm.apply(variables, jnp.transpose(jnp.asarray(x), (1, 2, 0)),
                                 jnp.asarray(lengths), method=JaxGRU.call_t)
    got_t, got_last = tm.call_t(torch.from_numpy(x).permute(1, 2, 0), torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(got_t), _np(want_t), **TOL)
    np.testing.assert_allclose(_np(got_last), _np(want_last), **TOL)
    _assert_no_launches()


@pytest.mark.parametrize("gru_type", ["AGRU", "AUGRU"])
def test_dynamic_gru_matches_jax(route, gru_type):
    x, lengths, att = _seq(seed=5)
    jm = JaxDynamicGRU(input_size=6, hidden_size=10, gru_type=gru_type)
    jx, ja, jl = map(jnp.asarray, (x, att, lengths))
    variables = _randomize(jm.init(jax.random.PRNGKey(2), jx, ja, jl), 9)
    tm = _load(DynamicGRU(6, 10, gru_type=gru_type), variables)

    def jloss(p, xx, aa):
        return jnp.sum(jnp.sin(jm.apply(p, xx, aa, jl)) * 1.3)

    want = jm.apply(variables, jx, ja, jl)
    jg_p, jg_x, jg_a = jax.grad(jloss, argnums=(0, 1, 2))(variables, jx, ja)
    xt, at = (torch.from_numpy(a).requires_grad_(True) for a in (x, att))
    got = tm(xt, at, torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    (torch.sin(got) * 1.3).sum().backward()
    _grads_close({**{n.replace("rnn.", ""): p.grad for n, p in tm.named_parameters()},
                  "x": xt.grad, "att": at.grad},
                 {**jg_p["params"]["rnn"], "x": jg_x, "att": jg_a})
    want_t = jm.apply(variables, jnp.transpose(jx, (1, 2, 0)), jnp.swapaxes(ja, 0, 1)[:, None, :],
                      jl, method=JaxDynamicGRU.call_t)
    got_t = tm.call_t(torch.from_numpy(x).permute(1, 2, 0),
                      torch.from_numpy(att).T[:, None, :], torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(got_t), _np(want_t), **TOL)
    _assert_no_launches()


@pytest.mark.parametrize("name", ["AGRUCell", "AUGRUCell"])
def test_attention_cells_match_jax(name):
    """The batch-major cell API (``sequence.py:420-452``): one step."""
    import xdeepfm_tpu.nn.sequence as jseq
    import xdeepfm_tpu_torch.nn.sequence as tseq

    rng = np.random.default_rng(13)
    x, h = rng.normal(size=(5, 6)).astype(np.float32), rng.normal(size=(5, 4)).astype(np.float32)
    att = rng.uniform(size=(5,)).astype(np.float32)
    jm = getattr(jseq, name)(input_size=6, hidden_size=4)
    variables = _randomize(jm.init(jax.random.PRNGKey(5), *map(jnp.asarray, (x, h, att))), 13)
    tm = _load(getattr(tseq, name)(6, 4), variables)
    want = jm.apply(variables, *map(jnp.asarray, (x, h, att)))
    got = tm(*map(torch.from_numpy, (x, h, att)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("cell", ["gru", "agru", "augru"])
def test_gru_scan_plain_versions_match_jax_kernel(cell):
    """``gru_forward_reference`` / ``gru_backward_reference`` against the
    JAX ``_gs_fwd`` / ``_gs_bwd`` in interpret mode, layouts translated
    (the JAX kernels take [T, 3, H, B], a float valid and b [3, H, 1])."""
    B, T, H = 8, 7, 10
    rng = np.random.default_rng(11)
    gi = rng.normal(size=(B, T, 3, H)).astype(np.float32)
    w = (rng.normal(size=(3, H, H)) / np.sqrt(H)).astype(np.float32)
    b = (0.3 * rng.normal(size=(3, H))).astype(np.float32)
    att = rng.uniform(size=(B, T)).astype(np.float32)
    lengths = rng.integers(0, T + 1, B).astype(np.int32)
    lengths[0] = 0
    h0 = (0.5 * rng.normal(size=(B, H))).astype(np.float32)
    g = rng.normal(size=(B, T, H)).astype(np.float32)
    valid = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)[:, None, :]
    jargs = (jnp.asarray(gi.transpose(1, 2, 3, 0)), jnp.asarray(w), jnp.asarray(b[:, :, None]),
             jnp.asarray(att.T[:, None, :]), jnp.asarray(valid), jnp.asarray(h0.T))
    gru_pallas.set_interpret(True)
    try:
        want_outs, res = gru_pallas._gs_fwd(cell, *jargs)
        dgi, dw, db, datt, _, dh0 = gru_pallas._gs_bwd(cell, res, jnp.asarray(g.transpose(1, 2, 0)))
    finally:
        gru_pallas.set_interpret(False)
    t = [torch.from_numpy(a) for a in (gi, w, b, att, lengths, h0, g)]
    tatt = None if cell == "gru" else t[3]
    outs = gru_cuda.gru_forward_reference(cell, t[0], t[1], t[2], tatt, t[4], t[5])
    np.testing.assert_allclose(_np(outs), np.transpose(_np(want_outs), (2, 0, 1)), **TOL)
    got = gru_cuda.gru_backward_reference(cell, t[6], t[0], t[1], t[2], tatt, t[4], t[5], outs)
    want = (np.transpose(_np(dgi), (3, 0, 1, 2)), _np(dw), _np(db)[:, :, 0],
            _np(datt)[:, 0, :].T, _np(dh0).T)
    for name, a, e in zip(("dgi", "dw", "db", "datt", "dh0"), got, want):
        np.testing.assert_allclose(_np(a), e, **GRAD_TOL, err_msg=name)
    assert (_np(got[0])[0] == 0).all() and (_np(outs)[0] == h0[0]).all()  # length 0


def test_gru_scan_function_gradients():
    """``gru_scan`` (the autograd Function) on the CPU: gradcheck in float64
    for each cell, and the int-lengths contract (no gradient for lengths)."""
    rng = np.random.default_rng(12)
    B, T, H = 3, 4, 2
    lengths = torch.tensor([0, 2, 4])
    for cell in ("gru", "agru", "augru"):
        ops = [torch.from_numpy(rng.normal(size=s)).double().requires_grad_(True)
               for s in ((B, T, 3, H), (3, H, H), (3, H), (B, T), (B, H))]
        ops[3].data.uniform_(0.1, 0.9)
        gi, w, b, att, h0 = ops
        fn = lambda gi, w, b, att, h0: tgru.gru_scan(cell, gi, w, b, att, lengths, h0)  # noqa: E731
        assert torch.autograd.gradcheck(fn, (gi, w, b, att, h0), eps=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="backend"):
        tgru.gru_scan("gru", gi, w, b, None, lengths, h0, backend="cuda")
    with pytest.raises(ValueError, match="cell"):
        tgru.gru_scan("lstm", gi, w, b, None, lengths, h0)


def test_use_kernel_follows_backend_and_gate():
    assert tgru.use_kernel(50, 10, 4096) and not tgru.use_kernel(50, 17, 4096)
    tgru.set_backend("xla")
    try:
        assert not tgru.use_kernel(50, 10, 4096)
    finally:
        tgru.set_backend("auto")
    tgru.set_backend("pallas")
    try:
        assert tgru.use_kernel(50, 10, 4096)
    finally:
        tgru.set_backend("auto")
    with pytest.raises(ValueError):
        tgru.set_backend("lanes")


def test_gru_beyond_the_gate_takes_the_plain_scan():
    """H 17 is past the kernels' gate: the module runs the plain scan, as
    the JAX module runs lax.scan past fits_vmem, and matches it."""
    x, lengths, _ = _seq(B=4, T=3, I=5, seed=2)
    jm = JaxGRU(input_size=5, hidden_size=17)
    variables = _randomize(jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(lengths)), 3)
    tm = _load(GRU(5, 17), variables)
    want, _ = jm.apply(variables, jnp.asarray(x), jnp.asarray(lengths))
    got, _ = tm(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ------------------------------------------------------------------- init


def test_init_distributions():
    """GRU: weights normal(init_std), biases U(+-1/sqrt(H)); AGRU / AUGRU:
    weights normal(init_std) (or U(+-1/sqrt(H)) without one), biases zero
    (``tests/test_sequence_models.py:158``)."""
    H = 64
    bound = 1.0 / np.sqrt(H)
    g = GRU(32, H, init_std=1e-3, generator=torch.Generator().manual_seed(0))
    for name in ("bias_ih", "bias_hh"):
        v = _np(getattr(g, name))
        assert np.abs(v).max() <= bound and v.min() < -0.8 * bound and v.max() > 0.8 * bound
    for name in ("weight_ih", "weight_hh"):
        assert abs(float(getattr(g, name).detach().std()) - 1e-3) < 1e-4
    for cls in (AGRUCell, AUGRUCell):
        c = cls(32, H, init_std=1e-4, generator=torch.Generator().manual_seed(1))
        assert (_np(c.bias_ih) == 0).all() and (_np(c.bias_hh) == 0).all()
        assert abs(float(c.weight_hh.detach().std()) - 1e-4) < 1e-5
        raw = cls(32, H, generator=torch.Generator().manual_seed(2))
        assert np.abs(_np(raw.weight_ih)).max() <= bound and float(raw.weight_ih.detach().std()) > 0.5 * bound
        assert not hasattr(cls(32, H, use_bias=False), "bias_ih")
    with pytest.raises(NotImplementedError):
        DynamicGRU(4, 4, gru_type="GRU")
