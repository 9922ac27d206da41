"""The port's compiled dispatch (``xdeepfm_tpu_torch/dispatch.py``) against the
JAX engine's: ``fit(steps_per_dispatch=K)`` (``train_step_multi``, a
``lax.scan`` of K steps, and a shorter remainder group), ``fit_stream``'s
grouping and ``predict`` / ``evaluate`` with ``batches_per_dispatch``
(``predict_step_multi``), on the CPU, where the port runs each group's
steps in turn; Adam's lazy bias corrections against the JAX fp32 values;
the lazy row functions' ``sorted_ids``.

The ``cuda``-marked cases hold the CUDA graphs against the eager steps on
the card and skip here.  The file imports JAX only inside the CPU cases, so
on a machine without JAX run those alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_dispatch.py

Tolerances: ``tests/test_multi_dispatch.py``'s (the loss rtol 1e-5, the AUC
1e-4, the scores 1e-5); each weight within rtol 1e-5 and atol 1e-6 (both
sides sum the same fp32 terms in other orders, ~1e-7 relative a step).
"""

import numpy as np
import pytest
import torch

import xdeepfm_tpu_torch.features as tf
from xdeepfm_tpu_torch import dispatch
from xdeepfm_tpu_torch.basemodel import BaseModel
from xdeepfm_tpu_torch.models import xDeepFM
from xdeepfm_tpu_torch.ops import cin as tcin
from xdeepfm_tpu_torch.optimizers import adam_bias_corrections
from xdeepfm_tpu_torch.serving import Scorer
from xdeepfm_tpu_torch.weights import flatten_tree

N_SPARSE, VOCAB, DIM, N_DENSE = 4, 50, 8, 2
ARCH = dict(dnn_hidden_units=(16, 16), cin_layer_size=(8, 6))
LOSS_RTOL, AUC_RTOL, PRED_RTOL = 1e-5, 1e-4, 1e-5  # tests/test_multi_dispatch.py
W_RTOL, W_ATOL = 1e-5, 1e-6
OPTIMIZERS = {"adam": {}, "lazy_adam": dict(embedding_optimizer="lazy")}


def _cols(mod):
    return [mod.SparseFeat(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)] + [
        mod.DenseFeat(f"I{i}") for i in range(N_DENSE)]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
    return x, (rng.uniform(size=n) < 0.4).astype(np.float32)


def _seeded_weights(jm):
    import jax

    rng = np.random.default_rng(1)
    w = jm.get_weights()
    w["params"] = jax.tree.map(
        lambda v: (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32), w["params"])
    return w


def _pair(opt="adam", **kw):
    """(JAX xDeepFM, port xDeepFM) from the same seeded weights, compiled
    alike."""
    import xdeepfm_tpu.features as jf
    from xdeepfm_tpu.models import xDeepFM as JaxXDeepFM

    jm = JaxXDeepFM(_cols(jf), _cols(jf), **ARCH, **kw)
    jm.compile("adam", "binary_crossentropy")
    w = _seeded_weights(jm)
    jm.set_weights(w)
    jm.compile("adam", "binary_crossentropy", metrics=["auc"], **OPTIMIZERS[opt])
    pm = xDeepFM(_cols(tf), _cols(tf), device="cpu", **ARCH, **kw)
    pm.set_weights(w)
    pm.compile("adam", "binary_crossentropy", metrics=["auc"], **OPTIMIZERS[opt])
    return jm, pm


def _weights(model):
    return {k: np.asarray(v) for k, v in flatten_tree(model.get_weights()["params"])}


def _assert_same(jm, pm, hj, hp):
    assert sorted(hp) == sorted(hj)
    for k in hj:
        rtol = AUC_RTOL if "auc" in k else LOSS_RTOL
        np.testing.assert_allclose(hp[k], hj[k], rtol=rtol, atol=1e-7, err_msg=k)
    want, got = _weights(jm), _weights(pm)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=W_RTOL, atol=W_ATOL, err_msg=k)


def _spy_jax_groups(jm):
    """Record the K of each JAX dispatch (1 for the single jitted step)."""
    groups = []
    multi, single = jm._train_step_multi, jm._train_step

    def run_multi(*a):
        groups.append(int(a[4].shape[0]))
        return multi(*a)

    def run_single(*a):
        groups.append(1)
        return single(*a)

    jm._train_step_multi, jm._train_step = run_multi, run_single
    return groups


def _spy_port_groups(pm):
    """Record the k of each port dispatch (1 for an eager step)."""
    groups = []
    steps, step = pm._train_steps, pm._train_step

    def run_steps(inputs, k, with_metrics):
        groups.append(k)
        pm._train_step = step  # the group's own steps are not dispatches
        try:
            return steps(inputs, k, with_metrics)
        finally:
            pm._train_step = run_step

    def run_step(*a, **kw):
        groups.append(1)
        return step(*a, **kw)

    pm._train_steps, pm._train_step = run_steps, run_step
    return groups


# ------------------------------------------------------------------- fit


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("k", [1, 3, 4])
def test_fit_steps_per_dispatch_matches_jax(k, opt):
    """500 rows at batch 64: 8 steps an epoch, the last padded, so K = 3
    groups them 3, 3, 2 (a remainder group) and K = 4 as 4, 4."""
    jm, pm = _pair(opt)
    x, y = _data(500)
    kw = dict(batch_size=64, epochs=2, verbose=2, shuffle=True, validation_split=0.1,
              steps_per_dispatch=k)
    jgroups, pgroups = _spy_jax_groups(jm), _spy_port_groups(pm)
    hj = jm.fit(x, y, **kw).history
    hp = pm.fit(x, y, **kw).history
    assert pgroups == jgroups == {1: [1] * 16, 3: [3, 3, 2] * 2, 4: [4, 4] * 2}[k]
    _assert_same(jm, pm, hj, hp)
    np.testing.assert_allclose(pm.predict(x, 128), np.asarray(jm.predict(x, 128)),
                               rtol=PRED_RTOL, atol=1e-7)
    if opt == "lazy_adam":
        assert pm._lazy["t"] == 16  # the lazy step count advanced by every group


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_fit_groups_run_the_steps_of_k_1(opt):
    """On the CPU a group's steps run in turn on the same inputs, with a
    dropout mask drawn per step: K = 3 gives K = 1's weights and history to
    the bit."""
    runs = []
    for k in (1, 3):
        pm = xDeepFM(_cols(tf), _cols(tf), device="cpu", dnn_dropout=0.5, **ARCH)
        pm.compile("adam", "binary_crossentropy", metrics=["auc"], **OPTIMIZERS[opt])
        h = pm.fit(*_data(500, seed=2), batch_size=64, epochs=2, verbose=1,
                   steps_per_dispatch=k).history
        runs.append((h, _weights(pm)))
    (h1, w1), (h3, w3) = runs
    assert h1 == h3
    for key in w1:
        np.testing.assert_array_equal(w3[key], w1[key], err_msg=key)


# ------------------------------------------------------------- fit_stream


def _stream(x, y, bs):
    for i in range(0, len(y), bs):
        yield {k: v[i:i + bs] for k, v in x.items()}, y[i:i + bs]


@pytest.mark.parametrize("steps_per_epoch", [None, 5])
def test_fit_stream_groups_match_jax(steps_per_epoch):
    """Eight batches of 64 (the last of 52) in groups of 3: 3, 3, 2, or with
    a cap of 5 steps 3, 2."""
    jm, pm = _pair()
    x, y = _data(500, seed=3)
    kw = dict(epochs=2, verbose=1, steps_per_dispatch=3, steps_per_epoch=steps_per_epoch)
    jgroups, pgroups = _spy_jax_groups(jm), _spy_port_groups(pm)
    hj = jm.fit_stream(lambda epoch: _stream(x, y, 64), **kw).history
    hp = pm.fit_stream(lambda epoch: _stream(x, y, 64), **kw).history
    assert pgroups == jgroups == ([3, 2] if steps_per_epoch else [3, 3, 2]) * 2
    _assert_same(jm, pm, hj, hp)


# ---------------------------------------------------------------- predict


@pytest.mark.parametrize("batches_per_dispatch", [1, 3, 8])
def test_predict_batches_per_dispatch_matches_jax(batches_per_dispatch):
    """1000 rows at batch 64: 16 batches, the last padded; the port's
    dispatches of k batches are the JAX engine's."""
    jm, pm = _pair()
    x, y = _data(1000, seed=4)
    jb, pb = jm._pack_x(x), pm._pack_x(x)
    seen = []
    batches = pm._predict_batches
    pm._predict_batches = lambda b: seen.append(len(next(iter(b.values())))) or batches(b)
    got = pm._predict_packed(pb, 64, batches_per_dispatch)
    want = jm._predict_packed(jb, 64, batches_per_dispatch)
    assert got.shape == want.shape == (1000, 1) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=PRED_RTOL, atol=1e-7)
    n = -(-16 // batches_per_dispatch)
    assert seen == [batches_per_dispatch] * (n - 1) + [16 - batches_per_dispatch * (n - 1)]
    assert pm._graphs.captures == 0  # the CPU captures nothing
    pm_eval, want_eval = pm.evaluate(x, y, 64), jm.evaluate(x, y, 64)
    for k in want_eval:
        np.testing.assert_allclose(pm_eval[k], want_eval[k], rtol=AUC_RTOL, err_msg=k)


def test_scorer_scores_through_the_dispatch():
    _, pm = _pair()
    x, _ = _data(300, seed=5)
    got = Scorer(pm, batch_size=128).warmup().score(x)
    np.testing.assert_array_equal(got, pm.predict(x, 128))


# ------------------------------------------------------------- lazy Adam


def test_bias_correction_slots_match_jax():
    """The host-written (1 - b1^t, 1 - b2^t) of t = 1..2000, and the
    engine's table of them, against the JAX lazy Adam's fp32 values
    (``xdeepfm_tpu/optimizers.py:49-52``: ``jnp.power`` of an fp32 t under
    jit), bit for bit."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def jax_bc(t):
        t = t.astype(jnp.float32)
        return jnp.stack([1 - jnp.power(0.9, t), 1 - jnp.power(0.999, t)], axis=-1)

    want = np.asarray(jax_bc(jnp.arange(1, 2001, dtype=jnp.int32)))
    np.testing.assert_array_equal(adam_bias_corrections(0, 2000), want)
    np.testing.assert_array_equal(adam_bias_corrections(999, 1001), want[999:])
    _, pm = _pair("lazy_adam")
    np.testing.assert_array_equal(pm._lazy_bc(0, 2000).numpy(), want)
    np.testing.assert_array_equal(pm._lazy_bc(1700, 300).numpy(), want[1700:])


@pytest.mark.parametrize("how", ["position", "keyword"])
@pytest.mark.parametrize("kind", ["adam", "adagrad"])
def test_lazy_rows_take_sorted_ids_as_jax(kind, how):
    """``sorted_ids`` in the JAX functions' place (before ``p_rows``), by
    position and by keyword: it changes no row."""
    import jax.numpy as jnp

    from xdeepfm_tpu import optimizers as jopt
    from xdeepfm_tpu_torch import optimizers as topt

    rng = np.random.default_rng(6)
    p = rng.normal(size=(12, 3)).astype(np.float32)
    state = np.abs(rng.normal(size=(12, 6 if kind == "adam" else 3))).astype(np.float32)
    ids = np.array([1, 1, 4, 7, 7, 7, 10], np.int32)  # sorted, duplicates carry one sum
    g = rng.normal(size=(7, 3)).astype(np.float32)
    g = np.stack([g[ids == i].sum(0) for i in ids])
    jfn, tfn = getattr(jopt, f"lazy_{kind}_rows"), getattr(topt, f"lazy_{kind}_rows")
    hyper = (1e-3, 0.9, 0.999, 1e-8) if kind == "adam" else (0.01, 1e-10)
    j_args = (jnp.asarray(p), jnp.asarray(state), jnp.asarray(ids), jnp.asarray(g), jnp.int32(3))
    t_args = (torch.from_numpy(p.copy()), torch.from_numpy(state.copy()),
              torch.from_numpy(ids), torch.from_numpy(g), 3)
    if how == "position":
        jp, js, jrows = jfn(*j_args, *hyper, True)
        tp, ts, trows = tfn(*t_args, *hyper, True)
    else:
        jp, js, jrows = jfn(*j_args, sorted_ids=True)
        tp, ts, trows = tfn(*t_args, sorted_ids=True)
    for got, want in ((tp, jp), (ts, js), (trows, jrows)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tp.numpy()[[0, 2, 3]], p[[0, 2, 3]])  # untouched rows


# --------------------------------------------------------------- the cache


def test_cpu_runs_the_steps_and_captures_nothing():
    cache = dispatch.GraphCache()
    calls = []
    out = cache.run("k", lambda st: calls.append(st) or st["a"] * 2,
                    {"a": torch.arange(3.0)}, torch.device("cpu"))
    assert torch.equal(out, torch.tensor([0.0, 2.0, 4.0]))
    assert len(calls) == 1 and len(cache) == 0 and cache.captures == 0


def test_launch_counters_are_every_kernel_wrapper():
    from xdeepfm_tpu_torch.ops import attention_cuda, ce_cuda, cin_cuda, gru_cuda

    found = dispatch.launch_counters()
    for fn in (cin_cuda.cin_rows_forward, cin_cuda.cin_rows_backward, cin_cuda.cin_rows_dw,
               cin_cuda.cin_rows_forward_bf16, ce_cuda.ce_rows_forward_bf16,
               attention_cuda.sa_backward, gru_cuda.gru_forward):
        assert any(f is fn for f in found)
    assert len(found) == len({id(f) for f in found}) == 24


def _switches():
    """(name, get, set, another value) of every switch of a code path."""
    from xdeepfm_tpu_torch.ops import attention, attn_block, ce, gru, lane_attention
    from xdeepfm_tpu_torch.parallel import mesh
    from xdeepfm_tpu_torch.parallel import sharded_embedding as se

    def glob(mod, attr, setter, other):
        return (f"{mod.__name__.rsplit('.', 1)[1]}.{setter.__name__}",
                lambda: getattr(mod, attr), setter, other)

    return [
        glob(tcin, "_CIN_BACKEND", tcin.set_cin_backend, "xla"),
        glob(tcin, "_PRECISION", tcin.set_cin_precision, "bf16"),
        glob(tcin, "_BWD_IMPL", tcin.set_backward_impl, "legacy"),
        glob(ce, "_PRECISION", ce.set_precision, "bf16"),
        glob(ce, "_STACK_HEADS", ce.set_stack_heads, False),
        glob(attention, "_PRECISION", attention.set_precision, "bf16"),
        glob(attention, "_MHSA_BACKEND", attention.set_mhsa_backend, "xla"),
        glob(attn_block, "_BACKEND", attn_block.set_backend, "xla"),
        glob(lane_attention, "_BACKEND", lane_attention.set_backend, "xla"),
        glob(gru, "_BACKEND", gru.set_backend, "xla"),
        ("sharded_embedding.set_embedding_mode", lambda: se._MODE,
         lambda v: se.set_embedding_mode(v), "shard_map"),
        ("mesh.set_active_mesh", lambda: mesh._ACTIVE_MESH, mesh.set_active_mesh, object()),
    ]


def _layer_switches():
    """(name, module, attribute, another value) of every Switch attribute."""
    from xdeepfm_tpu_torch.nn.cin_attention import CINAttentionV2
    from xdeepfm_tpu_torch.nn.interaction import InteractingLayer
    from xdeepfm_tpu_torch.nn.sequence import GRU, DynamicGRU
    from xdeepfm_tpu_torch.pro import xDeepFMPro

    cin = xDeepFM(_cols(tf), _cols(tf), device="cpu", **ARCH).module.cin
    pro = xDeepFMPro(_cols(tf), _cols(tf), sfg_hidden_units=(8,), device="cpu").module
    return [("CIN.backend", cin, "backend", "torch"),
            ("InteractingLayer.backend", InteractingLayer(DIM, 4, 2), "backend", "torch"),
            ("CINAttentionV2.backend", CINAttentionV2(N_SPARSE, DIM, (8,)), "backend", "torch"),
            ("GRU.backend", GRU(4, 4), "backend", "torch"),
            ("DynamicGRU.backend", DynamicGRU(4, 4), "backend", "torch"),
            ("SFGDecoder.ce_backend", pro.sfg_decoder, "ce_backend", "torch"),
            ("XDeepFMProModule.sfg_fused_ce", pro, "sfg_fused_ce", False)]


@pytest.mark.parametrize("index", range(12))
def test_a_switch_that_changes_drops_the_graphs(index):
    """Each global switch of ``ops/`` and ``parallel/`` bumps the dispatch
    version when its value changes, and only then; a cache then drops its
    graphs at its next call."""
    name, get, put, other = _switches()[index]
    old = get()
    version = dispatch._VERSION
    put(old)
    assert dispatch._VERSION == version, name
    cache = dispatch.GraphCache()
    cache._graphs["stale"] = object()
    try:
        put(other)
        assert dispatch._VERSION > version, name
        cache.run("k", lambda st: st["a"], {"a": torch.zeros(1)}, torch.device("cpu"))
        assert len(cache) == 0, name
    finally:
        put(old)
    assert get() is old or get() == old


@pytest.mark.parametrize("index", range(7))
def test_a_layer_switch_that_changes_bumps_the_version(index):
    """Each :class:`~xdeepfm_tpu_torch.dispatch.Switch` attribute: its first
    value (the constructor's) and an unchanged value bump nothing, a change
    bumps the version."""
    version = dispatch._VERSION
    name, module, attr, other = _layer_switches()[index]
    assert dispatch._VERSION == version, name  # the constructors' first values
    setattr(module, attr, getattr(module, attr))
    assert dispatch._VERSION == version, name
    setattr(module, attr, other)
    assert dispatch._VERSION > version and getattr(module, attr) == other, name


def test_what_swaps_a_tensor_drops_the_graphs(tmp_path):
    pm = xDeepFM(_cols(tf), _cols(tf), device="cpu", **ARCH)
    pm.compile("adam", "binary_crossentropy")
    pm.fit(*_data(200), batch_size=64, verbose=0)
    pm.save_checkpoint(str(tmp_path / "c.npz"))
    for drop in (lambda: pm.compile("adam", "binary_crossentropy"),
                 lambda: pm.load_checkpoint(str(tmp_path / "c.npz"))):
        pm._graphs._graphs["stale"] = object()
        drop()
        assert len(pm._graphs) == 0
    gen = pm._dropout_gen
    pm.fit(*_data(200), batch_size=64, verbose=0)
    assert pm._dropout_gen is gen  # re-seeded in place, not swapped


def test_a_copied_model_starts_without_graphs():
    import copy
    import pickle

    pm = xDeepFM(_cols(tf), _cols(tf), device="cpu", **ARCH)
    pm._graphs._graphs["captured"] = object()
    for twin in (copy.deepcopy(pm), pickle.loads(pickle.dumps(pm))):
        assert len(twin._graphs) == 0 and twin._graphs.captures == 0
    assert len(pm._graphs) == 1


def test_set_weights_writes_the_lazy_l2_sums_in_place():
    _, pm = _pair("lazy_adam")
    sums = dict(pm._lazy["reg"])
    assert sums
    pm.set_weights(pm.get_weights())
    assert all(pm._lazy["reg"][k] is v for k, v in sums.items())


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_pair(card, opt, **kw):
    models = []
    for _ in range(2):
        m = xDeepFM(_cols(tf), _cols(tf), device=card, **ARCH, **kw)
        m.compile("adam", "binary_crossentropy", metrics=["auc"], **OPTIMIZERS[opt])
        models.append(m)
    models[1].set_weights(models[0].get_weights())
    return models


@pytest.mark.cuda
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_graph_fit_matches_eager_on_card(card, opt):
    """K = 4 (groups 4, 4 and 4, 3, one captured graph each) against K = 1,
    with dropout: the weights and the history equal to the bit."""
    eager, graph = _card_pair(card, opt, dnn_dropout=0.2)
    x, y = _data(1000, seed=7)
    kw = dict(batch_size=64, epochs=2, verbose=1, validation_split=0.1)
    h1 = eager.fit(x, y, steps_per_dispatch=1, **kw).history
    h4 = graph.fit(x, y, steps_per_dispatch=4, **kw).history
    assert h1 == h4
    w1, w4 = _weights(eager), _weights(graph)
    for key in w1:
        np.testing.assert_array_equal(w4[key], w1[key], err_msg=key)
    assert graph._graphs.captures >= 2 and graph._graphs.replays >= 4


@pytest.mark.cuda
def test_scorer_graph_reads_reloaded_weights_on_card(card, tmp_path):
    """``warmup`` captures the graph, so no request does; ``load_weights``
    writes the parameters in place, so the captured forward scores with the
    new weights, without a new capture."""
    model, other = _card_pair(card, "adam")
    x, _ = _data(300, seed=8)
    scorer = Scorer(model, batch_size=128).warmup()
    assert model._graphs.captures == 1  # the warm-up captured the graph
    before = scorer.score(x)
    captures = model._graphs.captures
    assert captures == 1  # and the first request replayed it
    w = {k: v * np.float32(1.5) for k, v in _weights(model).items()}
    other.set_weights(BaseModel._weights_tree({f"params/{k}": v for k, v in w.items()}))
    other.save_weights(str(tmp_path / "w.npz"))
    model.load_weights(str(tmp_path / "w.npz"))
    after = scorer.score(x)
    assert model._graphs.captures == captures  # replayed, not captured again
    np.testing.assert_array_equal(after, other.predict(x, 128))
    assert np.abs(after - before).max() > 1e-4


@pytest.mark.cuda
def test_dropped_models_leave_no_card_memory(card):
    """A model's graphs go with it, and every cache warms up and captures on
    one side stream a device (cuBLAS keeps a workspace for each stream it
    has run on): models fitted and dropped one after another leave the
    card's allocated memory where the one before left it."""
    import gc

    x, y = _data(1000, seed=9)
    held = []
    for _ in range(3):
        model = xDeepFM(_cols(tf), _cols(tf), device=card, **ARCH)
        model.compile("adam", "binary_crossentropy")
        model.fit(x, y, batch_size=64, epochs=1, verbose=0, steps_per_dispatch=4)
        assert model._graphs.captures == 1
        del model
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert held[2] == held[1]
