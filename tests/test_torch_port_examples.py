"""The port's usage layer on the CPU: ``xdeepfm_tpu_torch/examples/`` (the
JAX package's ``examples/`` scripts) and ``xdeepfm_tpu_torch/scripts/run*.bash``
(the JAX launchers ``scripts/run*.bash``).

Each example's ``main`` runs at a small size with ``device="cpu"``: finite
outputs, the serving scorer equal to ``predict``, the checkpoints read
back.  Each launcher must pass the JAX launcher's flags, in its order, to
the port's counterpart of the JAX CLI module, keep its ``DATA_PATH`` and
``OUT_DIR`` lines, and every flag must parse in the port CLI's parser to
what the JAX CLI's parser makes of it (``--device`` aside); run through
bash with ``PYTHON`` an echo, each passes them on, then the arguments it
was given.
"""

import os
import pathlib
import re
import shlex
import subprocess

import numpy as np
import pytest
import torch

from xdeepfm_tpu.cli import xdftrain as jax_xdftrain
from xdeepfm_tpu.cli import xdftrain_attn as jax_xdftrain_attn
from xdeepfm_tpu.cli import xdftrain_pro as jax_xdftrain_pro
from xdeepfm_tpu_torch.cli import xdftrain, xdftrain_attn, xdftrain_pro
from xdeepfm_tpu_torch.examples import large_tables, quickstart, serving, sharded_training
from xdeepfm_tpu_torch.ops.cin_cuda import cin_rows_forward
from xdeepfm_tpu_torch.parallel import make_mesh, shard_model_state
from xdeepfm_tpu_torch.parallel.mesh import set_active_mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
LAUNCHERS = {"run": (jax_xdftrain, xdftrain), "run_attn": (jax_xdftrain_attn, xdftrain_attn),
             "run_sfg": (jax_xdftrain_pro, xdftrain_pro)}


def _finite(a):
    return bool(np.isfinite(np.asarray(a, np.float64)).all())


def test_quickstart_trains_on_cpu():
    out = quickstart.main(n=600, vocab=50, epochs=2, device="cpu", verbose=0)
    assert {"loss", "val_binary_crossentropy", "val_auc"} <= set(out["history"])
    assert all(_finite(v) and len(v) == 2 for v in out["history"].values())
    assert set(out["eval"]) == {"binary_crossentropy", "auc"} and _finite(list(out["eval"].values()))
    assert out["predictions"].shape == (600, 1) and _finite(out["predictions"])
    assert cin_rows_forward.launches == 0  # the CPU runs the plain CIN


def test_serving_scorer_equals_predict(tmp_path):
    out = serving.main(n_train=600, n_traffic=300, epochs=1, device="cpu", out_dir=str(tmp_path),
                       verbose=0)
    assert out["scores"].shape == (300, 1) and _finite(out["scores"])
    assert out["max_abs_diff"] == 0.0
    np.testing.assert_array_equal(out["scores"], out["predict"])
    assert os.path.exists(out["weights"])


def test_large_tables_checkpoint_reloads(tmp_path):
    out = large_tables.main(vocab=500, batch=256, epoch_batches=2, device="cpu",
                            checkpoint=str(tmp_path / "ckpt.bin"), verbose=0)
    assert all(_finite(v) for v in out["history"].values())
    assert out["predictions"].shape == (256, 1) and _finite(out["predictions"])
    model = out["model"]
    assert model._lazy is not None  # the lazy row-sparse optimizer, packed
    again = large_tables.build_model(500, "cpu")
    assert again.load_checkpoint(out["checkpoint"]) == 2
    for (k, a), (_, b) in zip(model.module.state_dict().items(),
                              again.module.state_dict().items()):
        assert torch.equal(a, b), k
    # the bf16 row state switches on at 2.5M rows a field, as in the JAX script
    assert large_tables.build_model(2_500_000, "meta")._lazy["state_dtype"] == "bfloat16"


def test_sharded_training_one_rank_grid(tmp_path):
    out = sharded_training.main(n=600, vocab=50, epochs=1, device="cpu",
                                checkpoint=str(tmp_path / "sharded"), verbose=0)
    assert out["ranks"] == 1 and out["predictions"].shape == (600, 1)
    assert _finite(out["predictions"]) and all(_finite(v) for v in out["history"].values())
    # the sharded checkpoint reads back into an identically sharded model
    model = out["model"]
    again = sharded_training.xDeepFM(model.linear_feature_columns, model.dnn_feature_columns,
                                     cin_layer_size=(256, 128), dnn_hidden_units=(256, 256),
                                     device="cpu")
    again.compile("adam", "binary_crossentropy", metrics=["auc"])
    try:
        shard_model_state(again, make_mesh(1, device="cpu"))
        assert again.load_checkpoint_sharded(out["checkpoint"]) == 1
    finally:
        set_active_mesh(None)
    for (k, a), (_, b) in zip(model.module.state_dict().items(),
                              again.module.state_dict().items()):
        assert torch.equal(a, b), k


def _launcher(path):
    """(variable lines, CLI module, flags) of a launcher script."""
    text = path.read_text()
    variables = re.findall(r"^\w+=\$\{\w+:-[^}]*\}$", text, re.M)
    call = text[text.index(" -m ") + 4:].replace("\\\n", " ")
    words = shlex.split(call)
    flags = [w for w in words[1:] if w != "$@"]
    return variables, words[0], flags


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_launcher_keeps_the_jax_flags(name, tmp_path):
    jax_vars, jax_module, jax_flags = _launcher(ROOT / "scripts" / f"{name}.bash")
    port = ROOT / "xdeepfm_tpu_torch" / "scripts" / f"{name}.bash"
    vars_, module, flags = _launcher(port)
    assert vars_ == jax_vars and len(vars_) == 2
    assert module == jax_module.replace("xdeepfm_tpu.", "xdeepfm_tpu_torch.")
    assert flags == jax_flags
    # through bash, with PYTHON an echo: the variables' defaults, then the
    # arguments given to the launcher after the flags
    env = dict(os.environ, PYTHON="echo")
    env.pop("DATA_PATH", None)
    env.pop("OUT_DIR", None)
    argv = shlex.split(subprocess.run(["bash", str(port), "--device", "cpu"], env=env, check=True,
                                      capture_output=True, text=True, timeout=60).stdout)
    default = dict(re.match(r"(\w+)=\$\{\w+:-([^}]*)\}", v).groups() for v in vars_)
    want_argv = ["-m", module] + [{"$DATA_PATH": default["DATA_PATH"],
                                   "$OUT_DIR": default["OUT_DIR"]}.get(f, f) for f in flags]
    assert argv == want_argv + ["--device", "cpu"]
    jax_cli, port_cli = LAUNCHERS[name]
    want = vars(jax_cli.parse_args(argv[2:-2]))
    got = vars(port_cli.parse_args(argv[2:-2]))
    assert got.pop("device") == "cuda"  # the JAX CLI's default is its own device
    want.pop("device")
    assert got == want
    assert port_cli.parse_args(argv[2:]).device == "cpu"
