"""PyTorch port, rank grid: the sharded lookups, the shard-local lazy update
and the sharding rule (``xdeepfm_tpu_torch/parallel/``) against the JAX
package on its 8-device CPU mesh (``tests/conftest.py``).

The port's ranks are OS processes in gloo worlds of 4 (data 2, embed 2) and
2 (data 1, embed 2), spawned once for the file
(``tests/torch_port_grid_worker.py``, suite "parallel"); the JAX side runs
the same numpy inputs on ``make_mesh(4)`` and ``make_mesh(2)``.  Lookup
values are exact copies of table rows on both sides (bf16 ones rounded the
same way), so they are held bit-equal; gradients are sums in other orders,
held at the JAX mesh tests' ``rtol=1e-5, atol=1e-6``
(``tests/test_sharding.py:44-60``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_port_grid_worker as W
from xdeepfm_tpu.optimizers import LAZY_OPTIMIZERS as J_LAZY
from xdeepfm_tpu.optimizers import LAZY_ROW_MATH as J_ROW_MATH
from xdeepfm_tpu.optimizers import encode_state as j_encode_state
from xdeepfm_tpu.parallel import make_mesh
from xdeepfm_tpu.parallel import mesh as jmesh
from xdeepfm_tpu.parallel import sharded_embedding as jse
from xdeepfm_tpu_torch.parallel import mesh as tmesh
from xdeepfm_tpu_torch.parallel import sharded_embedding as tse


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [each rank's results]}, both worlds spawned once."""
    return W.spawn("parallel", tmp_path_factory.mktemp("grid_parallel"))


def _jax_lookup(mesh, mode, key, comm):
    inp = W.lookup_inputs()
    table = jax.device_put(jnp.asarray(inp["table"]), NamedSharding(mesh, P("embed", None)))
    ids = jax.device_put(jnp.asarray(inp[f"ids_{key}"]), NamedSharding(mesh, P("data", None)))
    w = jax.device_put(jnp.asarray(inp[f"w_{key}"]), NamedSharding(mesh, P("data", None, None)))
    fn = jse.sharded_lookup if mode == "shard_map" else jse.sharded_lookup_a2a
    try:
        jse.set_embedding_mode(mode, mesh, comm_dtype=jnp.bfloat16 if comm else None)
        vals = jax.jit(lambda t, i: fn(t, i, mesh))(table, ids)
        grad = jax.jit(jax.grad(lambda t: jnp.sum(w * fn(t, ids, mesh) ** 2)))(table)
    finally:
        jse.set_embedding_mode("gspmd", None)
    return np.asarray(vals), np.asarray(grad)


@pytest.mark.parametrize("world", sorted(W.WORLDS))
@pytest.mark.parametrize("case", list(W.LOOKUP_CASES))
def test_lookup_matches_jax_mesh(ranks, world, case):
    mode, key, comm = W.LOOKUP_CASES[case]
    want_vals, want_grad = _jax_lookup(make_mesh(world), mode, key, comm)
    inp = W.lookup_inputs()
    rows = inp["table"][inp[f"ids_{key}"]]
    for r in ranks[world]:
        got = r[f"{case}/vals"]
        np.testing.assert_array_equal(got, want_vals)
        np.testing.assert_array_equal(r[f"{case}/dispatch"], want_vals)
        if comm is None:
            np.testing.assert_array_equal(got, rows)
        else:  # bf16 rows on the wire (test_sharding.py:646-668)
            np.testing.assert_array_equal(got, torch.tensor(rows).bfloat16().float().numpy())
            np.testing.assert_allclose(got, rows, rtol=1e-2, atol=1e-2)
        tol = dict(rtol=1e-2, atol=1e-2) if comm else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r[f"{case}/grad"], want_grad, **tol)
        assert np.abs(r[f"{case}/grad"]).sum() > 0


def _jax_lazy(mesh, case):
    lz = W.lazy_inputs()
    shard = NamedSharding(mesh, P("embed", None))
    both = NamedSharding(mesh, P(("data", "embed")))
    ids = jax.device_put(jnp.asarray(lz["ids"]), both)
    g = jax.device_put(jnp.asarray(lz["g"]), NamedSharding(mesh, P(("data", "embed"), None)))
    state = np.concatenate([lz["m"], lz["v"]], 1)
    step = jnp.asarray(1)
    if case == "flat":
        update = jax.jit(lambda t, st, i, g_: jse.sharded_lazy_row_update(
            t, st, i, g_, step, J_LAZY["adam"][1], mesh, lr=W.LAZY_LR, l2=W.LAZY_L2))
        t, st = update(jax.device_put(jnp.asarray(lz["table"]), shard),
                       jax.device_put(jnp.asarray(state), shard), ids, g)
        return np.asarray(t), np.asarray(st)
    dt = jnp.bfloat16 if case == "bf16" else jnp.float32
    arr = jnp.concatenate([jnp.asarray(lz["table"]), j_encode_state(jnp.asarray(state), dt)], 1)
    update = jax.jit(lambda t, i, g_: jse.sharded_lazy_row_update(
        t, None, i, g_, step, None, mesh, lr=W.LAZY_LR, l2=W.LAZY_L2, packed_dim=W.LAZY_DIM,
        row_math=J_ROW_MATH["adam"][0], state_mult=2, state_dtype=dt))
    return np.asarray(update(jax.device_put(arr, shard), ids, g)), None


@pytest.mark.parametrize("world", sorted(W.WORLDS))
@pytest.mark.parametrize("case", W.LAZY_CASES)
def test_sharded_lazy_row_update_matches_jax_mesh(ranks, world, case):
    """One lazy Adam step with L2 (test_sharding.py:530-640 at the function):
    the table (packed: with its m|v columns, bf16 pairs under bf16) at
    ``rtol=1e-4, atol=1e-6``; every rank gathers the same bits."""
    want, want_state = _jax_lazy(make_mesh(world), case)
    lz = W.lazy_inputs()
    touched = np.zeros(W.LAZY_ROWS, bool)
    touched[lz["ids"]] = True
    got0 = ranks[world][0][f"lazy_{case}/table"]
    for r in ranks[world]:
        got = r[f"lazy_{case}/table"]
        np.testing.assert_array_equal(got, got0)
        if case == "bf16":  # the state columns hold bf16 pairs: compare them decoded
            np.testing.assert_allclose(got[:, : W.LAZY_DIM], want[:, : W.LAZY_DIM],
                                       rtol=1e-4, atol=1e-6)
            dec = lambda a: torch.tensor(np.ascontiguousarray(a[:, W.LAZY_DIM:])).view(
                torch.bfloat16).float().numpy()
            np.testing.assert_allclose(dec(got), dec(want), rtol=1e-2, atol=1e-6)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        if want_state is not None:
            np.testing.assert_allclose(r["lazy_flat/state"], want_state, rtol=1e-4, atol=1e-6)
    # untouched rows keep their bits, touched rows moved
    np.testing.assert_array_equal(got0[~touched, : W.LAZY_DIM], lz["table"][~touched])
    assert (got0[touched, : W.LAZY_DIM] != lz["table"][touched]).all(axis=1).all()


@pytest.mark.parametrize("world", sorted(W.WORLDS))
def test_shard_params_and_shard_batch(ranks, world):
    """``shard_params`` keeps a rank's rows [e*S, (e+1)*S) of a divisible
    ``table_d`` leaf and every other leaf whole (a 63-row table stays
    replicated); ``shard_batch`` gives a rank its slice of the global batch
    over ``data``, or over both axes under ``all_to_all``."""
    inp = W.lookup_inputs()
    for r in ranks[world]:
        d, e = (int(c) for c in r["coord"])
        D, E = (int(c) for c in r["shape"])
        S = W.LOOKUP_ROWS // E
        np.testing.assert_array_equal(r["shard_params/embedding_dict/table_d8"],
                                      inp["table"][e * S : (e + 1) * S])
        np.testing.assert_array_equal(r["shard_params/embedding_dict/table_d3"],
                                      inp["table"][:63, :3])
        np.testing.assert_array_equal(r["shard_params/dnn/linear_0/kernel"], inp["w_uniform"][0])
        ids = inp["ids_uniform"]
        b = len(ids) // D
        np.testing.assert_array_equal(r["shard_batch/shard_map"], ids[d * b : (d + 1) * b])
        b = len(ids) // world
        rank = int(r["rank"])
        np.testing.assert_array_equal(r["shard_batch/all_to_all"], ids[rank * b : (rank + 1) * b])


@pytest.mark.parametrize("world", sorted(W.WORLDS))
def test_grid_coordinates_follow_the_jax_device_order(ranks, world):
    """Rank r sits at (r // E, r % E), as np.array(devices).reshape(n // E, E)."""
    E = 2
    for r in ranks[world]:
        assert int(r["world"]) == world
        assert list(r["shape"]) == [world // E, E]
        assert list(r["coord"]) == [int(r["rank"]) // E, int(r["rank"]) % E]


@pytest.mark.parametrize("shape", [(64, 8), (63, 8), (64, 1), (8,), (3, 4, 5)])
@pytest.mark.parametrize("path", ["embedding_dict/table_d8", "linear_model/embedding_dict/"
                                  "table_d1", "dnn/linear_0/kernel", "cin/conv_w_0"])
@pytest.mark.parametrize("embed", [1, 2, 4])
def test_param_sharding_rule_matches_jax(path, shape, embed):
    """Row-sharded exactly where the JAX rule gives P("embed", None): a
    ``table_d`` path, 2 dims, rows divisible by E; a table whose rows do not
    divide is replicated."""
    jm = make_mesh(8, embed_axis=embed)
    want = jmesh.param_sharding_rule(path, np.zeros(shape, np.float32), jm).spec
    grid = types.SimpleNamespace(shape={"data": 8 // embed, "embed": embed})
    got = tmesh.param_sharding_rule(path, torch.zeros(shape), grid)
    assert got == (tmesh.ROW_SHARDED if want == P("embed", None) else tmesh.REPLICATED)
    assert want in (P("embed", None), P())


@pytest.mark.parametrize("key", ["uniform", "dup", "skew"])
@pytest.mark.parametrize("E", [2, 4])
def test_dedup_route_layout_matches_jax(key, E):
    """The exchange layout of the a2a lookup and the lazy update: the sort,
    unique slots, compact unique prefix, padding owner E, send sizes and
    offsets, bit for bit."""
    ids = W.lookup_inputs()[f"ids_{key}"].reshape(-1)
    S = W.LOOKUP_ROWS // E
    want = jse._dedup_route_layout(jnp.asarray(ids), E, S)
    got = tse._dedup_route_layout(torch.as_tensor(ids, dtype=torch.int64), E, S)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_one_process_grid_runs_every_lookup_as_a_take():
    """Without torch.distributed, make_mesh() is a 1 x 1 grid: nothing is
    sharded and maybe_sharded_take is the plain take in every mode."""
    grid = tmesh.make_mesh(device="cpu")
    assert grid.shape == {"data": 1, "embed": 1} and grid.size == 1
    table = torch.randn(10, 3)
    ids = torch.tensor([[1, 9], [0, 1]])
    for mode in ("gspmd", "shard_map", "all_to_all"):
        tse.set_embedding_mode(mode, grid)
        try:
            np.testing.assert_array_equal(tse.maybe_sharded_take(table, ids), table[ids])
            np.testing.assert_array_equal(tse.maybe_sharded_take(table, ids, width=2),
                                          table[ids][..., :2])
        finally:
            tse.set_embedding_mode("gspmd", None)
