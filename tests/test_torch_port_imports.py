"""Import guard: every module of the port imports neither JAX, flax, msgpack
nor anything of ``xdeepfm_tpu``, and none imports pandas when it is imported
(the native route runs without it; ``serialization`` reads flax's files with
its own codec).  Each module is imported in a fresh interpreter, so
no other test's imports count."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ["cli", "cli.common", "cli.xdftrain", "cli.xdftrain_v1", "cli.xdftrain_attn",
           "cli.xdftrain_pro", "data", "native", "profiling", "utils", "callbacks", "serving",
           "serialization",
           "scripts", "scripts.bench_attn_ablate", "scripts.bench_cin_fwd", "scripts.bench_gru",
           "scripts.bench_lane", "scripts.bench_lazy",
           "ops.attn_ablate",
           "ops.attn_ablate_cuda",
           # the rest of the port: the engine, the models, the layers, the kernel
           # routes and their wrappers, Pro
           "basemodel", "embeddings", "weights", "features", "metrics", "optimizers",
           "models", "models.afm", "models.afn", "models.autoint", "models.ccpm", "models.dcn",
           "models.dcnmix", "models.deepfm", "models.dien", "models.difm", "models.din",
           "models.fibinet", "models.ifm", "models.mlr", "models.multitask",
           "models.multitask.esmm", "models.multitask.mmoe", "models.multitask.ple",
           "models.multitask.sharedbottom", "models.nfm", "models.onn", "models.pnn",
           "models.wdl", "models.xdeepfm", "models.xdeepfm_attn", "nn", "nn.activations", "nn.cin_attention", "nn.core",
           "nn.interaction", "nn.sequence", "ops", "ops._build", "ops.attention",
           "ops.attention_cuda", "ops.attn_block", "ops.attn_block_cuda", "ops.ce",
           "ops.ce_cuda", "ops.cin", "ops.cin_cuda", "ops.gru", "ops.gru_cuda",
           "ops.lane_attention", "ops.lane_attention_cuda", "pro", "pro.autodis", "pro.sfg",
           "pro.xdeepfm_pro",
           # the rank grid: mesh, the sharded lookups, the bootstrap
           "parallel", "parallel.mesh", "parallel.sharded_embedding", "parallel.distributed",
           # the usage scripts
           "examples", "examples.quickstart", "examples.serving", "examples.large_tables",
           "examples.sharded_training"]
PROBE = """
import importlib, json, sys
importlib.import_module(sys.argv[1])
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules}
                        & {"jax", "jaxlib", "xdeepfm_tpu", "pandas", "flax", "msgpack"})))
"""


@pytest.mark.parametrize("module", MODULES)
def test_port_module_imports_no_jax(module):
    proc = subprocess.run(
        [sys.executable, "-c", PROBE, f"xdeepfm_tpu_torch.{module}"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
