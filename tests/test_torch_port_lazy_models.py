"""PyTorch port, the lazy optimizer's split step through the other model
families against the JAX package's: xDeepFM-Pro (with its SFG decoder),
the attention CIN (V1, V2), AutoInt and DIFM, the FM family (DeepFM, WDL,
NFM, AFM, IFM, DCN, DCNMix; WDL and DCN also on mixed embedding dims, where
``fast_inputs`` takes each feature's own lookup from the occurrence blocks),
and DIEN as a singleton packed group (its sparse fields and both histories
index one table).  The shared
helpers and tolerances are ``tests/test_torch_port_lazy.py``'s: the same
seeded weights (scale 0.1) on both sides, fp32 on the CPU, the weights after
training within Adam's rtol 1e-4 / atol 2e-5, the lazy row states within
rtol 1e-3 and 1e-4 of their largest entry.
"""

import numpy as np
import pytest
from test_torch_port_lazy import (
    ARCH,
    _assert_states_close,
    _assert_weights_close,
    _cols,
    _data,
    _dien_cols,
    _dien_data,
    _pair,
)

import xdeepfm_tpu.features as jf
import xdeepfm_tpu.models as jmodels
import xdeepfm_tpu.pro as jpro
import xdeepfm_tpu_torch.features as tf
import xdeepfm_tpu_torch.models as tmodels
import xdeepfm_tpu_torch.pro as tpro

# name: (JAX class, port class, architecture)
FAMILIES = {
    "pro": (jpro.xDeepFMPro, tpro.xDeepFMPro,
            dict(ARCH, use_sfg=True, sfg_hidden_units=(8,), sfg_dropout=0.0)),
    "v1": (jmodels.xDeepFMAttention, tmodels.xDeepFMAttention, dict(ARCH, cin_num_heads=2)),
    "v2": (jmodels.xDeepFMAttentionV2, tmodels.xDeepFMAttentionV2,
           dict(ARCH, cin_num_heads=2, cin_num_attn_layers=2)),
    "autoint": (jmodels.AutoInt, tmodels.AutoInt,
                dict(att_layer_num=2, att_head_num=2, dnn_hidden_units=(8,))),
    "difm": (jmodels.DIFM, tmodels.DIFM, dict(att_head_num=2, dnn_hidden_units=(8,))),
    "deepfm": (jmodels.DeepFM, tmodels.DeepFM, dict(dnn_hidden_units=(8,))),
    "wdl": (jmodels.WDL, tmodels.WDL, dict(dnn_hidden_units=(8,))),
    "nfm": (jmodels.NFM, tmodels.NFM, dict(dnn_hidden_units=(8,))),
    "afm": (jmodels.AFM, tmodels.AFM, dict(attention_factor=4)),
    "ifm": (jmodels.IFM, tmodels.IFM, dict(dnn_hidden_units=(8,))),
    "dcn": (jmodels.DCN, tmodels.DCN, dict(dnn_hidden_units=(8,))),
    "dcnmix": (jmodels.DCNMix, tmodels.DCNMix, dict(dnn_hidden_units=(8,), low_rank=4,
                                                    num_experts=2)),
}
SPARSE_DNN = {"afm"}  # its DNN columns hold no dense feature


def _dnn(family, cols):
    return [f for f in cols if not hasattr(f, "dimension")] if family in SPARSE_DNN else cols


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lazy_split_step_matches_jax(family):
    """One lazy split step (packed, and the linear table in the main's
    group) from the same weights: the weights, the row states and the
    step's loss."""
    jcls, tcls, arch = FAMILIES[family]
    jm, pm = _pair(jcls, tcls, (_cols(jf), _dnn(family, _cols(jf))),
                   (_cols(tf), _dnn(family, _cols(tf))), "adam", "split_packed", **arch)
    assert [len(g["members"]) for g in pm._lazy["groups"]] == [2]
    x, y = _data(96, seed=20)
    want = jm.fit(x, y, batch_size=96, epochs=1, verbose=0, shuffle=False).history
    got = pm.fit(x, y, batch_size=96, epochs=1, verbose=0, shuffle=False).history
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _assert_weights_close(pm, jm)
    _assert_states_close(pm, jm)


@pytest.mark.parametrize("with_neg", [True, False])
def test_dien_singleton_packed_group_matches_jax(with_neg):
    """DIEN's one item/user table (its sparse fields and both histories) as
    one singleton packed group; without negative sampling the negatives'
    occurrences are touched but read by no lookup.  The attention weights
    are not normalised: under the softmax the attention MLP's bias gets a
    gradient that cancels to rounding noise, which Adam's normalised steps
    would turn into lr-sized moves (``tests/test_torch_port_dien_models.py``
    runs SGD for that reason; the lazy optimizer needs Adam or Adagrad)."""
    jcols, tcols = _dien_cols(jf, with_neg), _dien_cols(tf, with_neg)
    kw = dict(gru_type="AUGRU", use_negsampling=with_neg, dnn_hidden_units=(8,),
              att_hidden_units=(8,), att_weight_normalization=False, l2_reg_embedding=1e-3)
    jm, pm = _pair(jmodels.DIEN, tmodels.DIEN, (jcols, ["item"]), (tcols, ["item"]), "adam",
                   "split_packed", **kw)
    (g,) = pm._lazy["groups"]
    assert len(g["members"]) == 1 and pm._lazy["packed"]
    x, y = _dien_data(96, seed=16)
    want = jm.fit(x, y, batch_size=32, epochs=2, verbose=0, shuffle=False).history
    got = pm.fit(x, y, batch_size=32, epochs=2, verbose=0, shuffle=False).history
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_weights_close(pm, jm)
    _assert_states_close(pm, jm)


def _mixed_extra(mod):
    return [mod.SparseFeat("C9", 20, 3)]


@pytest.mark.parametrize("family", ["wdl", "dcn"])
def test_lazy_split_step_mixed_dims_matches_jax(family):
    """A field of dim 3 beside the four of dim 6: the main tables
    ``table_d6`` and ``table_d3`` and the linear ``table_d1`` index three
    different id sets, so three singleton groups; ``fast_inputs`` falls
    back to ``embed_inputs``, whose lookups read the occurrence blocks (a
    lookup that bypassed them would fail the step).  The weights, row
    states and loss as above."""
    jcls, tcls, arch = FAMILIES[family]
    jcols, tcols = _cols(jf, _mixed_extra(jf)), _cols(tf, _mixed_extra(tf))
    jm, pm = _pair(jcls, tcls, (jcols, jcols), (tcols, tcols), "adam", "split_packed", **arch)
    assert sorted(m["path"] for g in pm._lazy["groups"] for m in g["members"]) == [
        "embedding_dict/table_d3", "embedding_dict/table_d6",
        "linear_model/embedding_dict/table_d1"]
    assert [len(g["members"]) for g in pm._lazy["groups"]] == [1, 1, 1]
    x, y = _data(96, seed=21)
    x["C9"] = np.random.default_rng(22).integers(0, 15, 96)
    want = jm.fit(x, y, batch_size=96, epochs=1, verbose=0, shuffle=False).history
    got = pm.fit(x, y, batch_size=96, epochs=1, verbose=0, shuffle=False).history
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _assert_weights_close(pm, jm)
    _assert_states_close(pm, jm)
