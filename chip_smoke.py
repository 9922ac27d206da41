"""Smoke run of the PyTorch/CUDA port (``xdeepfm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them.  The phases
run in order and any failure raises, so the exit code is non-zero:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: every CUDA source of the port, compiled from this checkout (one
   ``nvcc`` per source, all started together);
3. kernel vs plain: each kernel (``cin_fwd``, ``cin_bwd_dx``, ``cin_dw``)
   against its plain PyTorch version on the card at the serving and training
   paths' shapes (layer 1's h a strided column view, as split-half gives it)
   and at a ragged and a tiny shape, with its time, the plain version's time,
   one ``torch.einsum`` over the three operands (the library yardstick) and
   the least time the card could take (bound); all three (3xTF32 on the
   tensor cores) must also be bit-equal over two runs and, against float64
   (out, each of dh and dx0, and dW), within twice the plain fp32 version's
   error (or 1e-6 of the largest entry), with a second bound at the TF32
   tensor-core peak;
4. serving: the canonical xDeepFM (26 sparse fields, vocab 10000, dim 10,
   13 dense, CIN (256, 128) split-half, DNN (256, 256)) with seeded random
   weights scores four requests through ``Scorer(batch_size=8192)``; the CIN
   kernel must launch twice per scored batch, the scores must agree with the
   plain-PyTorch CIN on the card and with the CPU model on a small input;
5. profile: device time by kernel (torch.profiler) and the device's idle
   share over three scored 8192-row requests;
6. training: the canonical xDeepFM, ``compile("adam", "binary_crossentropy",
   metrics=["auc"])``, ``fit`` at batch 4096 for three epochs on seeded
   Criteo-like data labelled by a seeded logistic teacher.  Per step the CIN
   kernels must launch 2 + 2 + 2 times (forward, cin_bwd_dx, cin_dw), and
   8 + 0 + 2 under the legacy backward (dh and dx0 of each layer through the
   forward kernel, one launch for each 128 of the layer's O); one step's
   gradients must match the plain CIN's on the card under both backward
   implementations, and one SGD
   step on the card must match the CPU model's; loss and AUC must be finite
   and the epoch loss must fall.  Examples/s trained with the kernels and
   with the plain CIN, from CUDA events over train steps;
7. training profile: device time by kernel and idle share over train steps;
8. CE kernel vs plain: ``ce_fwd`` and ``ce_bwd`` (the SFG decoder's fused
   softmax cross-entropy) against their plain PyTorch versions at the
   canonical Pro step's stacked shape (26 heads, batch 4096, hidden 64,
   vocabulary 10000 padded to 10112) with every row and with a third of the
   rows valid, one head of the same shape, a ragged shape, no valid row and a
   tiny shape; both kernels (3xTF32 on the tensor cores, the logits through
   one routine) must be bit-deterministic and, against their plain versions
   in float64 (ll and logz; dh, dW and db), within twice the plain fp32
   version's error (or 1e-6 of the largest entry); times beside the plain
   version's, the library's (``F.linear`` then ``F.cross_entropy``, logits
   materialised, backward by autograd) and the bounds on the fp32 pipes and
   the TF32 tensor cores, and the forward's exp floor;
9. Pro training: the canonical xDeepFMPro (the columns above, SFG decoder
   (128, 64) with label attention, positive-only, dropout 0.1), ``fit`` at
   batch 4096 with Adam for three epochs.  Per step one ``ce_fwd`` and one
   ``ce_bwd`` (one bucket of 26 heads) beside the CIN's 2 + 2 + 2, none in
   validation; the epoch loss falls and ``sfg_loss`` is in the History and
   finite; one step's gradients with the kernels match the plain CE's,
   stacked and one head per launch (26 + 26); one SGD step on the card
   matches the CPU model; examples/s trained with the kernels and with the
   plain CE; then a training profile of the Pro step;
10. Pro scoring: ``Scorer(batch_size=8192)`` over the Pro model scores the
   serving requests with 2 ``cin_fwd`` and no CE launch per batch, and agrees
   with the CPU model on a small input;
11. attention kernels vs plain (run right after the CE kernels): ``sa_fwd``
   / ``sa_bwd`` (small_attention) at V2's train shape (G 8192, dh 5, S 256),
   its serving shape (G 16384), ragged, tiny and bf16, beside
   ``F.scaled_dot_product_attention`` on the [G, S, dh] views (backward by
   autograd); ``ab_fwd`` / ``ab_bwd`` (the fused block) at V1's train shape
   (B 4096, E 10, S 256, 2 heads, L 1), at L = 2, without the residual,
   without the LayerNorm and ragged; every backward bit-equal over two runs;
   at the train shapes ``sa_fwd``'s o, ``ab_fwd``'s pooled and every
   gradient also against float64;
12. attention training, for xDeepFMAttention (V1) and xDeepFMAttentionV2
   (V2, 2 layers) at the canonical widths: ``fit`` at batch 4096 with Adam
   for three epochs; per step the CIN's 2 + 2 + 2 launches and V1's
   ``ab_fwd`` + ``ab_bwd`` or V2's 2 ``sa_fwd`` + 2 ``sa_bwd``; one step's
   gradients with the kernels and with the plain versions, both held against
   a float64 copy of the model (each parameter's kernel gradient as close to
   float64 as the plain fp32 one, or within 1e-4 of its largest entry or of
   1e-3 of the model's largest gradient entry, whichever is larger), one
   SGD step against the CPU model, the epoch loss falling, examples/s with
   the kernels and the plain versions; a training profile; then ``Scorer(batch_size=8192)`` with 2
   ``cin_fwd`` + 1 ``ab_fwd`` (V1) or + 2 ``sa_fwd`` (V2) per batch, agreeing
   with the CPU model on a small input;
13. lane-attention kernels vs plain (run right after the attention
   kernels): ``la_fwd`` / ``la_bwd`` at AutoInt's train shape (B 4096, 2
   heads of dh 5, S 26, scale 1) on the [B, S, E] projections' strides, its
   serving shape (B 8192), DIFM's scale, the train shape contiguous
   [H, dh, S, B], S 64, ragged (B 1001, S 39), tiny and dh 16, beside
   ``F.scaled_dot_product_attention`` on the [B, H, S, dh] views (backward
   by autograd); every backward bit-equal over two runs; at every shape o
   and each gradient against float64 within twice the plain fp32 version's
   error (or 1e-6 of the largest entry); each kernel's device time a launch
   from torch.profiler's kernel durations beside its CUDA-event time, and
   its exp floor;
14. AutoInt (3 layers of 2 heads, DNN (256, 128)) and DIFM (2 heads, DNN
   (256, 128)) at the canonical columns, trained, profiled and scored as the
   attention models are in 12: per step 3 ``la_fwd`` + 3 ``la_bwd``
   (AutoInt) or 1 + 1 (DIFM), per scored batch 3 or 1 ``la_fwd``;
15. GRU-scan kernels vs plain (run right after the lane kernels):
   ``gru_fwd`` / ``gru_bwd`` for each cell (gru, agru, augru) at DIEN's train
   shape (B 4096, T 50, H 10, lengths uniform in 1..50), its serving shape
   (B 8192), ragged (B 1001, T 37, some lengths 0), tiny and H 16; every
   backward bit-equal over two runs; beside them for cell gru cuDNN's
   ``torch.nn.GRU`` over ``pack_padded_sequence`` (backward by autograd)
   and the kernel plus the hoisted input projection, which cuDNN includes;
16. DIEN (``bench.py``'s ``dien`` row: AUGRU, negative sampling, user and
   item of vocab 10 000 and dim 10, one dense field, histories of maxlen 50)
   trained, profiled and scored as the models in 12: per step 2 ``gru_fwd``
   + 2 ``gru_bwd`` (the extractor's GRU and the AUGRU), per scored batch 2
   ``gru_fwd``;
17. the embedding tables' backward (``gather`` lines): the port's
   deterministic ``fused_gather`` beside ``F.embedding``'s and
   ``index_select``'s, bit-equality over two calls, error against float64
   and time, at DIEN's and xDeepFM's step;
18. a ``{"kernels": [...]}`` line, one entry per hand-written kernel;
19. the last line: ``{"ok": true, "device": {...}}``.

Every model's training record lists the gradients that a second identical
step does not reproduce bit for bit (``grads_not_reproduced``); the run fails
unless that list is empty, since every gather and kernel of the port is
deterministic.

In every gradient comparison of a model (kernels against plain versions,
against float64, card against CPU) the second side's relus that follow a
kernel (each CIN layer's, each InteractingLayer's, and DIEN's attention MLP
and DNN, which read the recurrences' outputs) are compared input by
input with the first side's (:class:`ReluRecord`): relu's gradient jumps at
0, so an input that the two sides' fp32 sums put on opposite sides of it
moves the gradients by far more than rounding.  Such a flip is held (the
second side takes the first side's sign) only where both inputs lie within
``RELU_BAND`` of the layer's largest input; a flip farther out, or more than
``MAX_HELD_FLIPS`` in one comparison, fails the run.
"""

import concurrent.futures
import copy
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from xdeepfm_tpu_torch import native
from xdeepfm_tpu_torch.basemodel import _loss_fn_single
from xdeepfm_tpu_torch.cli import xdftrain, xdftrain_attn, xdftrain_pro
from xdeepfm_tpu_torch.embeddings import fused_gather
from xdeepfm_tpu_torch.features import DenseFeat, SparseFeat, VarLenSparseFeat
from xdeepfm_tpu_torch.models import (
    DIEN,
    DIFM,
    AutoInt,
    xDeepFM,
    xDeepFMAttention,
    xDeepFMAttentionV2,
)
from xdeepfm_tpu_torch.models.dien import DIENModule
from xdeepfm_tpu_torch.nn import (
    CIN,
    CINAttention,
    CINAttentionV2,
    InteractingLayer,
    LocalActivationUnit,
)
from xdeepfm_tpu_torch.ops import _build, attention, attn_block, ce, gru, lane_attention
from xdeepfm_tpu_torch.ops.attn_ablate_cuda import (
    REFERENCES as ABLATE_REFERENCES,
    ablate_dots,
    ablate_full,
    ablate_soft,
)
from xdeepfm_tpu_torch.ops.attention_cuda import (
    sa_backward,
    sa_backward_reference,
    sa_forward,
    sa_forward_reference,
)
from xdeepfm_tpu_torch.ops.attn_block_cuda import (
    BlockCfg,
    ab_backward,
    ab_backward_reference,
    ab_forward,
    ab_forward_reference,
)
from xdeepfm_tpu_torch.ops.ce_cuda import (
    ce_rows_backward,
    ce_rows_backward_reference,
    ce_rows_forward,
    ce_rows_forward_reference,
)
from xdeepfm_tpu_torch.ops.cin import set_backward_impl
from xdeepfm_tpu_torch.ops.gru_cuda import (
    gru_backward,
    gru_backward_reference,
    gru_forward,
    gru_forward_reference,
)
from xdeepfm_tpu_torch.ops.lane_attention_cuda import (
    la_backward,
    la_backward_reference,
    la_forward,
    la_forward_reference,
)
from xdeepfm_tpu_torch.ops.cin_cuda import (
    FWD_H_BLOCK,
    cin_rows_backward,
    cin_rows_backward_reference,
    cin_rows_dw,
    cin_rows_dw_reference,
    cin_rows_forward,
    cin_rows_reference,
)
from xdeepfm_tpu_torch.pro import xDeepFMPro
from xdeepfm_tpu_torch.scripts import bench_attn_ablate
from xdeepfm_tpu_torch.scripts.bench_lane import device_ms
from xdeepfm_tpu_torch.serving import Scorer, load_scorer
from xdeepfm_tpu_torch.weights import flatten_tree, unflatten_tree

SEED = 0
BATCH = 8192
TRAIN_BATCH = 4096  # bench.py's and cli/xdftrain.py's train batch
TRAIN_STEPS_PER_EPOCH, TRAIN_EPOCHS = 8, 3
N_SPARSE, VOCAB, DIM, N_DENSE = 26, 10_000, 10, 13
CIN_LAYERS, DNN_UNITS = (256, 128), (256, 256)
REQUESTS = (8192, 8192, 8192, 5000)  # the last one is padded to a whole batch

# Published dense peaks at the full power limit (NVIDIA data sheets): fp32 on
# the CUDA cores, device-memory bytes/s and TF32 on the tensor cores (each
# sheet's sparse TF32 figure halved: PCIe 756, NVL 835, H200 and SXM 989).
# First matching name wins; "H100" alone is the SXM part ("H100 80GB HBM3").
PEAKS = (
    ("H100 PCIe", 51.2e12, 2.0e12, 378e12),
    ("H100 NVL", 60.0e12, 3.9e12, 417.5e12),
    ("H200", 67.0e12, 4.8e12, 495e12),
    ("H100", 67.0e12, 3.35e12, 495e12),
)
# 3xTF32 (the CIN backward, the CE kernels): three TF32 products for each fp32 one
TF32_PASSES = 3
# exp2 runs on the special-function units: 16 results a clock an SM against
# the FMA pipe's 128 fp32 FMAs (2 FLOP each) for compute capability 9.0
# (CUDA C++ Programming Guide, throughput of native arithmetic instructions),
# so the card's exp2 rate is its fp32 FLOP rate / 16 (4.19e12/s on the SXM).
EXP_PER_FLOP = 1 / 16

# (label, N, H, M, O, strided h): the canonical serving batch's two CIN
# layers (N = 8192 * 10 rows), the train batch's (N = 4096 * 10; layer 1's h
# is the first half of layer 0's output, a strided view), a ragged shape with
# split-half's odd H, and a tiny one.
SERVE_SHAPES = (
    ("layer0", BATCH * DIM, N_SPARSE, N_SPARSE, CIN_LAYERS[0], False),
    ("layer1", BATCH * DIM, CIN_LAYERS[0] // 2, N_SPARSE, CIN_LAYERS[1], False),
)
TRAIN_SHAPES = (
    ("train_layer0", TRAIN_BATCH * DIM, N_SPARSE, N_SPARSE, CIN_LAYERS[0], False),
    ("train_layer1", TRAIN_BATCH * DIM, CIN_LAYERS[0] // 2, N_SPARSE, CIN_LAYERS[1], True),
)
EDGE_SHAPES = (("ragged", 1001, 13, 26, 7, False), ("tiny", 5, 3, 2, 1, False))
CIN_TOL = dict(rtol=1e-4, atol=1e-3)  # fp32 sums of up to 3328 products of
# magnitude ~60 at unit-normal inputs, in another order than cuBLAS's
# The backward kernels sum up to N = 40960 (dW) or O*M (dh, dx0) products, so
# their rounding grows with the largest entry: atol is relative to it.
BWD_RTOL = 1e-4
SOURCES = {
    "cin_fwd": ("xdeepfm_tpu_torch/ops/csrc/cin_fwd.cu", "xdeepfm_tpu/ops/cin_pallas.py:60"),
    "cin_bwd_dx": ("xdeepfm_tpu_torch/ops/csrc/cin_bwd.cu", "xdeepfm_tpu/ops/cin_pallas.py:174"),
    "cin_dw": ("xdeepfm_tpu_torch/ops/csrc/cin_bwd.cu", "xdeepfm_tpu/ops/cin_pallas.py:127"),
    "ce_fwd": ("xdeepfm_tpu_torch/ops/csrc/ce_fwd.cu",
               ["xdeepfm_tpu/ops/ce_pallas.py:138", "xdeepfm_tpu/ops/ce_pallas.py:369"]),
    "ce_bwd": ("xdeepfm_tpu_torch/ops/csrc/ce_bwd.cu",
               ["xdeepfm_tpu/ops/ce_pallas.py:204", "xdeepfm_tpu/ops/ce_pallas.py:423"]),
    "sa_fwd": ("xdeepfm_tpu_torch/ops/csrc/sa_fwd.cu", "xdeepfm_tpu/ops/attention_pallas.py:204"),
    "sa_bwd": ("xdeepfm_tpu_torch/ops/csrc/sa_bwd.cu", "xdeepfm_tpu/ops/attention_pallas.py:229"),
    "ab_fwd": ("xdeepfm_tpu_torch/ops/csrc/ab_fwd.cu", "xdeepfm_tpu/ops/attn_block_pallas.py:502"),
    "ab_bwd": ("xdeepfm_tpu_torch/ops/csrc/ab_bwd.cu", "xdeepfm_tpu/ops/attn_block_pallas.py:541"),
    "la_fwd": ("xdeepfm_tpu_torch/ops/csrc/la_fwd.cu", "xdeepfm_tpu/ops/lane_attention.py:124"),
    "la_bwd": ("xdeepfm_tpu_torch/ops/csrc/la_bwd.cu", "xdeepfm_tpu/ops/lane_attention.py:143"),
    "gru_fwd": ("xdeepfm_tpu_torch/ops/csrc/gru_fwd.cu", "xdeepfm_tpu/ops/gru_pallas.py:245"),
    "gru_bwd": ("xdeepfm_tpu_torch/ops/csrc/gru_bwd.cu", "xdeepfm_tpu/ops/gru_pallas.py:275"),
    "ablate_full": ("xdeepfm_tpu_torch/ops/csrc/sa_ablate.cu", "scripts/bench_attn_ablate.py:51"),
    "ablate_dots": ("xdeepfm_tpu_torch/ops/csrc/sa_ablate.cu", "scripts/bench_attn_ablate.py:66"),
    "ablate_soft": ("xdeepfm_tpu_torch/ops/csrc/sa_ablate.cu", "scripts/bench_attn_ablate.py:78"),
}
# the headers that hold a kernel's design beyond its source
HEADERS = {
    "cin_fwd": ("xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh",),
    "cin_bwd_dx": ("xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh",),
    "cin_dw": ("xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh",),
    "ce_fwd": ("xdeepfm_tpu_torch/ops/csrc/ce_tc.cuh", "xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh"),
    "ce_bwd": ("xdeepfm_tpu_torch/ops/csrc/ce_tc.cuh", "xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh"),
    "sa_fwd": ("xdeepfm_tpu_torch/ops/csrc/attn_fwd_tc.cuh",),
    "sa_bwd": ("xdeepfm_tpu_torch/ops/csrc/attn_bwd_tc.cuh",),
    "ab_fwd": ("xdeepfm_tpu_torch/ops/csrc/attn_fwd_tc.cuh",
               "xdeepfm_tpu_torch/ops/csrc/attn_block.cuh"),
    "ab_bwd": ("xdeepfm_tpu_torch/ops/csrc/attn_bwd_tc.cuh",),
    "la_fwd": ("xdeepfm_tpu_torch/ops/csrc/la_common.cuh",),
    "la_bwd": ("xdeepfm_tpu_torch/ops/csrc/la_common.cuh",),
    **{f"ablate_{v}": ("xdeepfm_tpu_torch/ops/csrc/attn_fwd_tc.cuh",)
       for v in ("full", "dots", "soft")},
}
WRAPPERS = {
    "cin_fwd": cin_rows_forward, "cin_bwd_dx": cin_rows_backward, "cin_dw": cin_rows_dw,
    "ce_fwd": ce_rows_forward, "ce_bwd": ce_rows_backward,
    "sa_fwd": sa_forward, "sa_bwd": sa_backward, "ab_fwd": ab_forward, "ab_bwd": ab_backward,
    "la_fwd": la_forward, "la_bwd": la_backward, "gru_fwd": gru_forward, "gru_bwd": gru_backward,
    "ablate_full": ablate_full, "ablate_dots": ablate_dots, "ablate_soft": ablate_soft,
}

# The Pro step's fused CE (canonical xDeepFMPro: 26 heads of vocabulary 10000,
# padded to 10112 and stacked; hidden K = 64, the last SFG hidden width).
# (label, F, B, K, V, padded columns, num_valid): about a third of the train
# batch is positive, so "stacked_third" is the training path's shape.
PRO_VP = -(-VOCAB // 128) * 128
CE_SHAPES = (
    ("stacked", N_SPARSE, TRAIN_BATCH, 64, PRO_VP, PRO_VP - VOCAB, TRAIN_BATCH),
    ("stacked_third", N_SPARSE, TRAIN_BATCH, 64, PRO_VP, PRO_VP - VOCAB, TRAIN_BATCH // 3),
    ("single_head", 1, TRAIN_BATCH, 64, VOCAB, 0, TRAIN_BATCH // 3),
    ("ragged", 3, 1001, 13, 1000, 0, 700),
    ("no_valid_row", 2, 512, 64, 1000, 0, 0),
    ("tiny", 1, 5, 3, 7, 0, None),
)
CE_PATH_SHAPE = "stacked_third"
# ll: fp32 logsumexp over 10112 columns in another order than the plain
# version's; each gradient within 1e-4 of its largest entry (as BWD_RTOL)
CE_TOL = dict(rtol=1e-5, atol=1e-4)


def emit(**record):
    print(json.dumps(record), flush=True)


def cuda_ms(fn, iters):
    """Mean ms per call from CUDA events around ``iters`` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peak = next((p for p in PEAKS if p[0] in smi), None)
    if peak is None:
        raise SystemExit(f"chip_smoke: no published peaks for {smi!r}")
    emit(phase="device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         peak_source=peak[0], peak_fp32_flops=peak[1], peak_bytes_per_s=peak[2],
         peak_tf32_flops=peak[3])
    return name, peak


def _timed_parser_build():
    t0 = time.time()
    lib = native.build()
    return str(lib), time.time() - t0


def phase_build():
    """Every CUDA source (one nvcc each, all started together) and, beside
    them, the native Criteo parser (g++; raises without g++)."""
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        parser = pool.submit(_timed_parser_build)
        logs = _build.build()
        parser_lib, parser_s = parser.result()
    emit(phase="build", seconds=round(time.time() - t0, 3), sources=sorted(logs),
         parser_library=os.path.relpath(parser_lib), parser_seconds=round(parser_s, 3))
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  [{name}] {line}", flush=True)


def _kernel_case(name, N, H, M, O, strided, gen):
    """(kernel call, plain call, library call, bytes the function must move)
    on fresh unit-normal inputs; h is a column view of an [N, 2H] tensor if
    ``strided``.  The library call is one ``torch.einsum`` over the three
    operands per output (dh and dx0 for cin_bwd_dx), timed only.  The
    backward kernels' calls carry ``float64()``, their plain versions in
    float64."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    h = rand(N, 2 * H)[:, :H] if strided else rand(N, H)
    x0, W, b, g = rand(N, M), rand(O, H * M), rand(O), rand(N, O)
    W3 = W.view(O, H, M)
    ins = 4 * (N * H + N * M)
    if name == "cin_fwd":
        def fwd():
            return cin_rows_forward(h, x0, W, b)

        fwd.float64 = lambda: cin_rows_reference(h.double(), x0.double(), W.double(), b.double())
        return (fwd, lambda: cin_rows_reference(h, x0, W, b),
                lambda: torch.einsum("nh,nm,ohm->no", h, x0, W3),
                ins + 4 * (O * H * M + O + N * O))
    if name == "cin_bwd_dx":
        def dx():
            return cin_rows_backward(g, h, x0, W)

        dx.float64 = lambda: cin_rows_backward_reference(g.double(), h.double(), x0.double(),
                                                         W.double())
        return (dx, lambda: cin_rows_backward_reference(g, h, x0, W),
                lambda: (torch.einsum("no,nm,ohm->nh", g, x0, W3),
                         torch.einsum("no,nh,ohm->nm", g, h, W3)),
                ins + 4 * (N * O + O * H * M) + ins)

    def dw():
        return cin_rows_dw(g, h, x0)

    dw.float64 = lambda: cin_rows_dw_reference(g.double(), h.double(), x0.double())
    return (dw, lambda: cin_rows_dw_reference(g, h, x0),
            lambda: torch.einsum("no,nh,nm->ohm", g, h, x0),
            ins + 4 * (N * O + O * H * M))


def _f64_gate(label, got, want, exact):
    """The 3xTF32 numerics gate: the kernel's largest error against the
    float64 result at most twice the plain fp32 version's, or within 1e-6 of
    the result's largest entry.  Returns (kernel error, plain error)."""
    err = float((got.double() - exact).abs().max()) if got.numel() else 0.0
    plain = float((want.double() - exact).abs().max()) if got.numel() else 0.0
    top = float(exact.abs().max()) if got.numel() else 0.0
    if not (err <= 2 * plain or err <= 1e-6 * top):
        raise AssertionError(f"{label}: error against float64 {err} exceeds twice the plain "
                             f"fp32 version's {plain} and 1e-6 of the largest entry {top}")
    return err, plain


def phase_kernels(peak):
    """Every kernel against its plain version on the same inputs.  FLOPs are
    the contraction's 2*N*H*M*O for each kernel (the N*H*M-sized epilogue
    terms add under 1% at O >= 128 and are left out of the bound).  All
    three kernels (3xTF32 on the tensor cores) are also held against float64
    on the card (:func:`_f64_gate`: out, each of dh and dx0, and dW), must
    be bit-equal over two runs, and carry a second bound, 3 * FLOPs at the
    TF32 peak (``bound_tc_ms``)."""
    _, peak_flops, peak_bw, peak_tc = peak
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    cases = [("cin_fwd", s) for s in SERVE_SHAPES] + [
        (name, s) for s in TRAIN_SHAPES + EDGE_SHAPES
        for name in ("cin_fwd", "cin_bwd_dx", "cin_dw")
    ]
    for name, (label, N, H, M, O, strided) in cases:
        kernel, plain, library, nbytes = _kernel_case(name, N, H, M, O, strided, gen)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        got, want = (got, want) if name != "cin_bwd_dx" else (torch.cat(got, 1), torch.cat(want, 1))
        err = (got - want).abs().max().item()
        extra = {}
        if name == "cin_fwd":
            torch.testing.assert_close(got, want, **CIN_TOL)
        else:
            torch.testing.assert_close(
                got, want, rtol=BWD_RTOL, atol=BWD_RTOL * want.abs().max().item() + 1e-6
            )
        exact = kernel.float64()
        if name == "cin_bwd_dx":  # dh and dx0 each to the gate
            gates = [_f64_gate(f"{name} {out} at {label}", a, b, e) for out, a, b, e in
                     zip(("dh", "dx0"), got.split((H, M), 1), want.split((H, M), 1), exact)]
        else:
            gates = [_f64_gate(f"{name} at {label}", got, want, exact)]
        extra["err_vs_float64"] = max(e for e, _ in gates)
        extra["plain_err_vs_float64"] = max(p for _, p in gates)
        del exact
        again = kernel()
        again = torch.cat(again, 1) if name == "cin_bwd_dx" else again
        extra["bit_equal"] = bool(torch.equal(got, again))
        del again
        if not extra["bit_equal"]:
            raise AssertionError(f"{name} at {label}: two runs differ")
        del got, want
        iters = 20 if N > 10_000 else 200
        kernel_ms = cuda_ms(kernel, iters)
        plain_ms = cuda_ms(plain, iters)
        library_ms = cuda_ms(library, iters)
        flops = 2 * N * H * M * O
        by_ops = flops / peak_flops >= nbytes / peak_bw
        extra["bound_tc_ms"] = max(TF32_PASSES * flops / peak_tc, nbytes / peak_bw) * 1e3
        results[name, label] = dict(
            N=N, H=H, M=M, O=O, strided_h=strided, max_abs_err=err, kernel_ms=kernel_ms,
            plain_ms=plain_ms, library_ms=library_ms, library="torch.einsum over h, x0 and W",
            bound_ms=max(flops / peak_flops, nbytes / peak_bw) * 1e3,
            bound_by="operations" if by_ops else "bytes",
            gflop=flops / 1e9, mbytes=nbytes / 1e6, tflops=flops / kernel_ms / 1e9, **extra,
        )
        emit(phase="kernel", kernel=name, shape=label, **results[name, label])
    return results


def canonical_columns():
    return [SparseFeat(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)] + [
        DenseFeat(f"I{i}") for i in range(N_DENSE)
    ]


# DIEN at bench.py's dien row (bench.py:338-371, 389-393): user and item of
# vocab 10 000 and dim 10, one dense field, the item history and its
# negatives (maxlen 50, lengths uniform in 1..50, padded ids 0) sharing the
# item table
DIEN_MAXLEN = 50


def dien_columns():
    def hist(name):
        return VarLenSparseFeat(SparseFeat(name, VOCAB, DIM, embedding_name="item"), DIEN_MAXLEN,
                                length_name="seq_length")

    return [SparseFeat("user", VOCAB, DIM), SparseFeat("item", VOCAB, DIM), DenseFeat("score"),
            hist("hist_item"), hist("neg_hist_item")]


def model_columns(version):
    return dien_columns() if version == "dien" else canonical_columns()


# The models at the canonical widths: xDeepFM, and the attention CIN's two
# (bench.py's rows attn, xDeepFMAttention(cols, cols, cin_num_heads=2), and
# attn2, xDeepFMAttentionV2(cols, cols, cin_num_heads=4,
# cin_num_attn_layers=2); E = 10 allows 2 heads, so V2 runs 2 of dh 5)
MODELS = {
    "xdeepfm": lambda cols, device: xDeepFM(
        cols, cols, dnn_hidden_units=DNN_UNITS, cin_layer_size=CIN_LAYERS, device=device),
    "v1": lambda cols, device: xDeepFMAttention(
        cols, cols, dnn_hidden_units=DNN_UNITS, cin_layer_size=CIN_LAYERS, cin_num_heads=2,
        device=device),
    "v2": lambda cols, device: xDeepFMAttentionV2(
        cols, cols, dnn_hidden_units=DNN_UNITS, cin_layer_size=CIN_LAYERS, cin_num_heads=4,
        cin_num_attn_layers=2, device=device),
    # AutoInt and DIFM as scripts/bench_zoo.py:44,49 build them: AutoInt's
    # defaults (3 layers of 2 heads, dh 5, unscaled, DNN (256, 128)), DIFM
    # with 2 heads (one scaled layer, DNN (256, 128))
    "autoint": lambda cols, device: AutoInt(cols, cols, device=device),
    "difm": lambda cols, device: DIFM(cols, cols, att_head_num=2, device=device),
    "dien": lambda cols, device: DIEN(cols, ["item"], gru_type="AUGRU", use_negsampling=True,
                                      device=device),
}


def set_kernel_backend(model, backend):
    """``backend`` (None: the kernels, "torch": their plain versions) on
    every module of ``model`` that routes to a kernel: the CIN, the
    attention CIN, each InteractingLayer."""
    for m in model.module.modules():
        if hasattr(m, "backend"):
            m.backend = backend


def canonical_model(device, weights=None, seeded=True, version="xdeepfm"):
    """The canonical xDeepFM (or attention ``version``) with ``weights``,
    else random weights from SEED (``seeded``), else its own
    initialisation."""
    model = MODELS[version](model_columns(version), device)
    if weights is None and not seeded:
        return model
    if weights is None:
        # random weights at scale 0.1 so that every tower, the CIN included,
        # moves the scores
        rng = np.random.default_rng(SEED)
        flat = {
            k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flatten_tree(model.get_weights()["params"])
        }
        weights = {"params": unflatten_tree(flat), "batch_stats": {}}
    model.set_weights(weights)
    return model


def requests(rng, sizes, version="xdeepfm"):
    if version == "dien":
        return [dien_rows(rng, n) for n in sizes]
    out = []
    for n in sizes:
        x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(N_SPARSE)}
        x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
        out.append(x)
    return out


def dien_rows(rng, n):
    """DIEN's rows as bench.py's dien_x draws them."""
    lengths = rng.integers(1, DIEN_MAXLEN + 1, n)
    valid = np.arange(DIEN_MAXLEN)[None, :] < lengths[:, None]
    return {"user": rng.integers(0, VOCAB, n), "item": rng.integers(0, VOCAB, n),
            "score": rng.uniform(0, 1, n).astype(np.float32),
            "hist_item": rng.integers(1, VOCAB, (n, DIEN_MAXLEN)) * valid,
            "neg_hist_item": rng.integers(1, VOCAB, (n, DIEN_MAXLEN)) * valid,
            "seq_length": lengths}


def score_all(scorer, reqs):
    """Scores and examples/s over all requests (CUDA events; ``score``
    returns host arrays, so the end event follows the last batch)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    preds = [scorer.score(x) for x in reqs]
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    return preds, sum(len(p) for p in preds) / (ms / 1e3), ms


def phase_serving():
    model = canonical_model("cuda")
    scorer = Scorer(model, batch_size=BATCH).warmup()
    reqs = requests(np.random.default_rng(SEED + 1), REQUESTS)
    n_batches = sum(-(-n // BATCH) for n in REQUESTS)

    reset_launches()
    preds, _, _ = score_all(scorer, reqs)
    counts = read_launches()
    launches = counts["cin_fwd"]
    if counts != expected(cin_fwd=2 * n_batches):
        raise AssertionError(
            f"CIN kernels launched {counts} for {n_batches} scored batches, "
            f"expected {2 * n_batches} forward launches and no backward"
        )
    for n, p in zip(REQUESTS, preds):
        if p.shape != (n, 1) or p.dtype != np.float64:
            raise AssertionError(f"bad scores: shape {p.shape}, dtype {p.dtype}")
        if not (np.isfinite(p).all() and (p > 0).all() and (p < 1).all()):
            raise AssertionError("scores are not finite probabilities")
    spread = float(np.concatenate(preds).std())
    if spread < 1e-3:
        raise AssertionError(f"scores barely vary (std {spread}): the towers are idle")

    kernel_runs = [score_all(scorer, reqs) for _ in range(3)]
    model.module.cin.backend = "torch"
    plain_runs = [score_all(scorer, reqs) for _ in range(3)]
    plain_preds = plain_runs[0][0]
    model.module.cin.backend = None
    plain_err = max(float(np.abs(a - b).max()) for a, b in zip(preds, plain_preds))
    for a, b in zip(preds, plain_preds):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)

    # the whole model on the CPU, same weights, a small input
    cpu_model = canonical_model("cpu", model.get_weights())
    small = requests(np.random.default_rng(SEED + 2), (64,))[0]
    cpu_err = float(np.abs(model.predict(small, 64) - cpu_model.predict(small, 64)).max())
    if cpu_err > 1e-5:
        raise AssertionError(f"card and CPU scores differ by {cpu_err}")

    record = dict(
        requests=list(REQUESTS), batches=n_batches, cin_launches=launches,
        examples_per_s_kernel=[r[1] for r in kernel_runs],
        examples_per_s_plain_cin=[r[1] for r in plain_runs],
        ms_kernel=[r[2] for r in kernel_runs], ms_plain_cin=[r[2] for r in plain_runs],
        max_abs_diff_vs_plain_cin=plain_err, max_abs_diff_vs_cpu=cpu_err,
        score_std=spread,
    )
    emit(phase="serving", **record)
    return record, scorer, reqs[0]


def phase_profile(scorer, req, calls=3):
    """Device time by kernel over ``calls`` scored 8192-row requests
    (torch.profiler), beside the host-clock wall time of the same window."""
    scorer.score(req)
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            scorer.score(req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit(phase="profile", calls=calls, rows_per_call=len(next(iter(req.values()))),
         **device_breakdown(prof, wall_ms, calls))


def train_data(rng, n, version="xdeepfm"):
    """Criteo-like rows (26 ids uniform over the vocab, 13 dense in [0, 1))
    labelled by a logistic teacher: per-id effects, dense weights and a
    negative bias, so the click rate is about a third and the labels carry
    signal that the model can learn.  DIEN's rows (``dien_rows``) take a
    teacher over the dense score, the item and the mean effect of the
    history's items, with the same negative bias."""
    if version == "dien":
        x = dien_rows(rng, n)
        effects = rng.normal(0.0, 0.5, VOCAB)
        hist = np.where(x["hist_item"] > 0, effects[x["hist_item"]], 0.0).sum(1) / x["seq_length"]
        logit = -1.0 + 3.0 * (x["score"] - 0.5) + effects[x["item"]] + hist
        return x, (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    x = requests(rng, (n,))[0]
    effects = rng.normal(0.0, 0.3, (N_SPARSE, VOCAB))
    logit = -1.0 + sum(effects[i][x[f"C{i}"]] for i in range(N_SPARSE))
    logit = logit + sum(w * x[f"I{i}"] for i, w in enumerate(rng.normal(0, 1, N_DENSE)))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return x, y


def reset_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def expected(**counts):
    """Launch counts of every kernel: ``counts``, and 0 for the rest."""
    return {name: counts.get(name, 0) for name in WRAPPERS}


def device_batch(model, x, y, n):
    packed = model.schema.pack({k: v[:n] for k, v in x.items()})
    xb = {k: torch.as_tensor(v, device=model.device) for k, v in packed.items()}
    return xb, torch.as_tensor(y[:n, None], device=model.device)


def step_grads(model, xb, yb):
    """Gradients of one step's loss (sum-BCE + L2 registry + a module's
    aux loss, as ``_train_step``), no update."""
    model.module.zero_grad(set_to_none=True)
    out = model.module(xb, training=True)
    mask = torch.ones(yb.shape[0], device=yb.device)
    loss = _loss_fn_single("binary_crossentropy")(out["pred"].reshape(-1), yb.reshape(-1), mask)
    (loss + model._regularization_loss() + out.get("aux_loss", 0.0)).backward()
    return {k: p.grad.clone() for k, p in model.module.named_parameters()}


# A relu input that two routes put on opposite sides of 0 is held only where
# both lie within this share of the layer's largest |input|: fp32 rounding
# of the sums that made them.  At most MAX_HELD_FLIPS such inputs in one
# comparison, out of ~1.6e7 CIN relu inputs a step at batch 4096
RELU_BAND = 1e-5
MAX_HELD_FLIPS = 32
_RELUS = (torch.relu, F.relu, torch.Tensor.relu)
# the modules whose relus follow a kernel: the CIN's layers, InteractingLayer,
# DIEN's attention MLP (on the extractor's states) and its DNN (on the
# evolution's last state)
_KERNEL_FED = (CIN, CINAttention, CINAttentionV2, InteractingLayer, LocalActivationUnit)


def kernel_fed_sites(model):
    sites = [m for m in model.module.modules() if isinstance(m, _KERNEL_FED)]
    if isinstance(model.module, DIENModule):
        sites.append(model.module.dnn)
    return sites


class ReluRecord(TorchFunctionMode):
    """The inputs of ``model``'s relus that follow a kernel (a relu called
    within a forward of :func:`kernel_fed_sites`), in call order,
    while it is entered.  With ``ref``, another route's record of the same
    step on the same batch, each input is compared with the one ``ref``
    recorded at its place instead: where their signs differ, the relu takes
    ``ref``'s sign if both lie within RELU_BAND of the larger of the two
    layers' largest |input|, and fails otherwise; more than MAX_HELD_FLIPS
    held flips fail on exit.  ``flips`` counts them, ``shares`` gives each
    one's |input| as a share of that layer's largest, ``worst`` the
    largest share."""

    def __init__(self, model, ref=None):
        super().__init__()
        self.ref, self.inputs, self.calls, self.depth = ref, [], 0, 0
        self.flips, self.worst, self.shares = 0, 0.0, []
        self.sites = kernel_fed_sites(model)
        # one relu per CIN layer, one per InteractingLayer, in each forward
        self.least = sum(len(getattr(m, "layer_size", (0,))) for m in self.sites)

    def __enter__(self):
        self.hooks = [h for m in self.sites for h in (
            m.register_forward_pre_hook(self._enter_site),
            m.register_forward_hook(self._leave_site))]
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        for h in self.hooks:
            h.remove()
        if exc[0] is not None:
            return
        if self.calls < self.least:
            raise AssertionError(f"{self.calls} kernel-fed relus ran, fewer than the "
                                 f"{self.least} of the model's layers")
        if self.ref is not None and self.calls != self.ref.calls:
            raise AssertionError(f"{self.calls} kernel-fed relus ran, {self.ref.calls} in the "
                                 "route compared")
        if self.flips > MAX_HELD_FLIPS:
            raise AssertionError(f"{self.flips} relu inputs flipped, more than {MAX_HELD_FLIPS}")

    def _enter_site(self, module, args):
        self.depth += 1

    def _leave_site(self, module, args, out):
        self.depth -= 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.depth == 0 or func not in _RELUS:
            return out
        x, i = args[0], self.calls
        self.calls += 1
        if self.ref is None:
            self.inputs.append(x.detach())
            return out
        if i >= len(self.ref.inputs) or self.ref.inputs[i].shape != x.shape:
            raise AssertionError(f"kernel-fed relu {i} of {tuple(x.shape)} has no counterpart")
        mine, theirs = x.detach(), self.ref.inputs[i].to(x.device, x.dtype)
        keep = theirs > 0
        flip = (mine > 0) != keep
        n = int(flip.sum())
        if n == 0:
            return out
        size = torch.maximum(mine.abs(), theirs.abs())
        shares = (size[flip] / size.max()).tolist()
        share = max(shares)
        self.flips += n
        self.worst = max(self.worst, share)
        self.shares += shares[:MAX_HELD_FLIPS + 1]
        if share > RELU_BAND:
            raise AssertionError(f"kernel-fed relu {i}: an input flipped at {share:.3g} of the "
                                 f"layer's largest, beyond {RELU_BAND}")
        return torch.where(flip, x * keep.to(x.dtype), out)

    def stats(self):
        return {"relus": self.calls, "flips": self.flips, "worst_share": self.worst,
                "shares": sorted(self.shares, reverse=True)}


def reproduced(label, got, again):
    """[] after checking that a second identical step (``again``) gave every
    gradient of ``got`` bit for bit; fails the run otherwise."""
    unsteady = sorted(k for k in got if not torch.equal(got[k], again[k]))
    if unsteady:
        raise AssertionError(f"{label}a second identical step changed the gradients of {unsteady}")
    return unsteady


def relu_step_grads(model, xb, yb, ref=None):
    """(:func:`step_grads`, the :class:`ReluRecord` of its kernel-fed
    relus, compared with ``ref`` where given)."""
    with ReluRecord(model, ref) as rec:
        grads = step_grads(model, xb, yb)
    return grads, rec


# A gradient far below the others may cancel to rounding noise by
# construction, and its error over its own size is then noise over noise.
# DIEN's attention MLP is such a gradient: the softmax over T cancels
# whatever shift a row's scores share, and at init_std 1e-4 nearly all of
# the MLP's gradient is such a shift.  So DIEN's gradients are each held
# relative to their largest entry or to GRAD_FLOOR of the largest entry of
# all the gradients compared, whichever is larger; every other model's
# relative to their own largest entry alone.
GRAD_FLOOR = {"dien": 1e-3}


def per_grad_err(got, want, floor=0.0):
    """Per-parameter error of ``got`` against ``want``, relative to that
    gradient's largest entry or ``floor`` times the largest entry of all,
    whichever is larger."""
    least = floor * max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k].to(want[k].dtype) - want[k]).abs().max())
            / max(float(want[k].abs().max()), least, 1e-30) for k in want}


def grad_err(got, want, floor=0.0):
    """The largest of :func:`per_grad_err`."""
    return max(per_grad_err(got, want, floor).values())


# fp32 sums in other orders (the kernels', cuBLAS's, the CPU's) through the
# whole backward: each gradient within this share of its largest entry
GRAD_RTOL = 1e-4


def sgd_step_vs_cpu(pair, x, y, label, floor=0.0):
    """One SGD step on 256 rows from the same weights by the card's and the
    CPU's model (``pair``), the CPU's kernel-fed relus compared with the
    card's (:class:`ReluRecord`).  Errors by :func:`per_grad_err` with
    ``floor``: the weights after it within GRAD_RTOL; the gradients within
    GRAD_RTOL, or, for a gradient that rounding moves further, as close to a
    float64 copy's gradients as the CPU's own fp32 ones, up to FP32_SLACK.
    Returns the errors and the relu flips."""
    small, recs = 256, []
    m64 = copy.deepcopy(pair[1])  # the CPU model before its step
    for m in pair:
        m.compile("sgd", "binary_crossentropy")
        with ReluRecord(m, recs[0] if recs else None) as rec:
            m.fit({k: v[:small] for k, v in x.items()}, y[:small], batch_size=small, epochs=1,
                  verbose=0, shuffle=False)
        recs.append(rec)
    errs = {"relus": recs[1].stats()}
    card, cpu = ({k: p.grad.detach().cpu() for k, p in m.module.named_parameters()} for m in pair)
    errs["grad"] = grad_err(card, cpu, floor)
    if errs["grad"] > GRAD_RTOL:
        m64.module = m64.module.double()
        m64.compile("sgd", "binary_crossentropy")
        xb, yb = device_batch(m64, x, y, small)
        xb = {k: v.double() if v.is_floating_point() else v for k, v in xb.items()}
        ref, held = relu_step_grads(m64, xb, yb.double(), recs[0])
        card64, cpu64 = per_grad_err(card, ref, floor), per_grad_err(cpu, ref, floor)
        vs64 = {k: (card64[k], cpu64[k]) for k in ref}
        bad = {k: e for k, e in vs64.items() if e[0] > max(GRAD_RTOL, FP32_SLACK * e[1])}
        if bad:
            raise AssertionError(f"{label}card and CPU grad after one step differ by "
                                 f"{errs['grad']}; off float64 by (card, CPU) {bad}")
        errs["relus_float64"] = held.stats()
        errs["grad_vs_float64_worst"] = {k: {"card": e[0], "cpu": e[1]} for k, e in sorted(
            vs64.items(), key=lambda kv: -kv[1][0])[:3]}
    weights = [{k: p.detach().cpu() for k, p in m.module.named_parameters()} for m in pair]
    errs["weights"] = grad_err(*weights, floor)
    if errs["weights"] > GRAD_RTOL:
        raise AssertionError(f"{label}card and CPU weights after one step differ by "
                             f"{errs['weights']}")
    return errs


def train_steps_ms(model, batches, steps):
    """ms per train step (CUDA events over ``steps`` after one warm-up)."""
    mask = torch.ones(TRAIN_BATCH, device="cuda")
    it = [batches[i % len(batches)] for i in range(steps)]
    model._train_step(*batches[0], mask)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for xb, yb in it:
        model._train_step(xb, yb, mask)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def phase_training():
    set_backward_impl("auto")
    model = canonical_model("cuda", seeded=False)
    model.compile("adam", "binary_crossentropy", metrics=["auc"])
    rng = np.random.default_rng(SEED + 3)
    x, y = train_data(rng, TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH + TRAIN_BATCH // 2)
    x, y, val = (  # the last half batch validates
        {k: v[: -TRAIN_BATCH // 2] for k, v in x.items()}, y[: -TRAIN_BATCH // 2],
        ({k: v[-TRAIN_BATCH // 2 :] for k, v in x.items()}, y[-TRAIN_BATCH // 2 :]),
    )
    n_val_batches = 1

    reset_launches()
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS, verbose=1,
                        validation_data=val)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    steps = TRAIN_STEPS_PER_EPOCH * TRAIN_EPOCHS
    want = expected(
        cin_fwd=2 * (steps + TRAIN_EPOCHS * n_val_batches),  # + validation batches
        cin_bwd_dx=2 * steps, cin_dw=2 * steps,
    )
    if launches != want:
        raise AssertionError(f"CIN launches {launches} over {steps} steps, expected {want}")
    logs = history.history
    for k, v in logs.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{k} is not finite: {v}")
    if not logs["loss"][0] > logs["loss"][1] > logs["loss"][2]:
        raise AssertionError(f"the epoch loss did not fall: {logs['loss']}")

    # one step's gradients, kernels against the plain CIN, its relus
    # compared with the kernels', per backward impl
    xb, yb = device_batch(model, x, y, TRAIN_BATCH)
    grad_errs, relu_flips, legacy_launches = {}, {}, None
    for impl in ("auto", "legacy"):
        set_backward_impl(impl)
        reset_launches()
        got_g, rec = relu_step_grads(model, xb, yb)
        counts = read_launches()
        model.module.cin.backend = "torch"
        want_g, held = relu_step_grads(model, xb, yb, rec)
        model.module.cin.backend = None
        relu_flips[impl] = held.stats()
        if impl == "legacy":
            legacy_launches = counts
            # the forwards, then each layer's dh and dx0 contractions over
            # the O columns of g in h blocks of FWD_H_BLOCK
            legacy_fwd = len(CIN_LAYERS) + sum(2 * -(-o // FWD_H_BLOCK) for o in CIN_LAYERS)
            if counts != expected(cin_fwd=legacy_fwd, cin_dw=2):
                raise AssertionError(f"legacy backward launched {counts} in one step")
        elif counts != expected(cin_fwd=2, cin_bwd_dx=2, cin_dw=2):
            raise AssertionError(f"fused backward launched {counts} in one step")
        grad_errs[impl] = grad_err(got_g, want_g)
        if grad_errs[impl] > GRAD_RTOL:
            raise AssertionError(f"{impl}: kernel gradients off by {grad_errs[impl]}")
    set_backward_impl("auto")
    unsteady = reproduced("xDeepFM: ", step_grads(model, xb, yb), step_grads(model, xb, yb))

    # one SGD step on the card against the CPU model from the same weights
    cpu_errs = sgd_step_vs_cpu(
        [canonical_model(dev, model.get_weights()) for dev in ("cuda", "cpu")], x, y, "")

    # examples/s trained, kernel CIN and plain CIN in turns
    batches = [device_batch(model, {k: v[i * TRAIN_BATCH:] for k, v in x.items()},
                            y[i * TRAIN_BATCH:], TRAIN_BATCH) for i in range(4)]
    runs = {"kernel": [], "plain": []}
    for backend in ("kernel", "plain", "plain", "kernel"):
        model.module.cin.backend = None if backend == "kernel" else "torch"
        runs[backend].append(train_steps_ms(model, batches, 20))
    model.module.cin.backend = None
    record = dict(
        batch=TRAIN_BATCH, steps=steps, epochs=TRAIN_EPOCHS, fit_seconds=fit_s,
        launches=launches, legacy_launches_per_step=legacy_launches,
        history=logs, grad_rel_err_vs_plain_cin=grad_errs, relu_flips_vs_plain_cin=relu_flips,
        grads_not_reproduced=unsteady,
        rel_err_vs_cpu_one_sgd_step=cpu_errs,
        ms_per_step_kernel=runs["kernel"], ms_per_step_plain_cin=runs["plain"],
        examples_per_s_kernel=[TRAIN_BATCH / ms * 1e3 for ms in runs["kernel"]],
        examples_per_s_plain_cin=[TRAIN_BATCH / ms * 1e3 for ms in runs["plain"]],
    )
    emit(phase="training", **record)
    return record, model, batches


def phase_train_profile(model, batches, steps=3, phase="train_profile"):
    """Device time by kernel over ``steps`` train steps (torch.profiler),
    beside the host-clock wall time of the same window."""
    mask = torch.ones(TRAIN_BATCH, device="cuda")
    model._train_step(*batches[0], mask)
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            model._train_step(*batches[i % len(batches)], mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    record = dict(steps=steps, batch=TRAIN_BATCH, **device_breakdown(prof, wall_ms, steps))
    emit(phase=phase, **record)
    return record


def _ce_case(label, F_, B, K, V, pad, nv, gen):
    """Fresh inputs of one CE shape on the card: unit-normal h, W / sqrt(K),
    b and g; the last ``pad`` columns of each head padded as the decoder pads
    stacked heads (W 0, bias -1e30)."""
    h = torch.randn(B, K, generator=gen, device="cuda")
    W = torch.randn(F_, V, K, generator=gen, device="cuda") / K**0.5
    b = torch.randn(F_, V, generator=gen, device="cuda")
    if pad:
        W[:, -pad:] = 0.0
        b[:, -pad:] = ce._NEG
    t = torch.randint(0, V - pad, (F_, B), generator=gen, device="cuda")
    g = torch.randn(F_, B, generator=gen, device="cuda")
    nv_dev = None if nv is None else torch.tensor(nv, device="cuda")
    return h, W, b, t, g, nv_dev


def _ce_library(h, W, b, t, nv):
    """One PyTorch call per head: F.linear, then F.cross_entropy with
    reduction="none" (the [B, V] logits materialised), rows past nv
    zeroed."""
    keep = torch.ones(h.shape[0], device=h.device) if nv is None else (
        torch.arange(h.shape[0], device=h.device) < nv).float()
    return torch.stack([
        F.cross_entropy(F.linear(h, W[f], b[f]), t[f], reduction="none") for f in range(W.shape[0])
    ]) * keep


def phase_ce_kernels(peak):
    """ce_fwd and ce_bwd against their plain versions on the same inputs, with
    times and bounds.  FLOPs count the rows that take part (num_valid): the
    forward's products 2*nv*K*V*F, the backward's least work three times that
    (the logit recompute, dh and dW; the kernels recompute the logits once per
    output, 4x).  Bytes: each input read once (nv rows of h, t, g, logz) and
    each output written once.  The exps (nv*V*F a pass) are left out of the
    fp32 bound.  Both kernels (3xTF32 on the tensor cores) are also held
    against their plain versions in float64 on the card (:func:`_f64_gate`:
    ll and logz, and each of dh, dW, db), must be bit-equal over two runs,
    and carry a second bound, 3 * FLOPs at the TF32 peak, with the bytes
    (``*_bound_tc_ms``); the forward also its exp floor, nv*V*F exps at the
    card's exp rate (``fwd_exp_floor_ms``)."""
    _, peak_flops, peak_bw, peak_tc = peak
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    results = {}
    for label, F_, B, K, V, pad, nv in CE_SHAPES:
        h, W, b, t, g, nvd = _ce_case(label, F_, B, K, V, pad, nv, gen)
        ll, logz = ce_rows_forward(h, W, b, t, nvd)
        grads = ce_rows_backward(g, h, W, b, t, logz, nvd)
        torch.cuda.synchronize()
        want_ll, want_logz = ce_rows_forward_reference(h, W, b, t, nvd)
        torch.testing.assert_close(ll, want_ll, **CE_TOL)
        torch.testing.assert_close(logz, want_logz, **CE_TOL)
        fwd_err = max(float((ll - want_ll).abs().max()), float((logz - want_logz).abs().max()))
        exact = ce_rows_forward_reference(h.double(), W.double(), b.double(), t, nvd)
        fwd64 = {out: _f64_gate(f"ce_fwd {out} at {label}", got, want, ex)
                 for out, got, want, ex in zip(("ll", "logz"), (ll, logz),
                                                (want_ll, want_logz), exact)}
        del exact
        torch.cuda.empty_cache()
        fwd_again = ce_rows_forward(h, W, b, t, nvd)
        if not (torch.equal(ll, fwd_again[0]) and torch.equal(logz, fwd_again[1])):
            raise AssertionError(f"ce_fwd at {label}: two runs differ")
        del fwd_again
        bwd_err = 0.0
        plain = ce_rows_backward_reference(g, h, W, b, t, logz, nvd)
        for got, want in zip(grads, plain):
            torch.testing.assert_close(got, want, rtol=BWD_RTOL,
                                       atol=BWD_RTOL * float(want.abs().max()) + 1e-6)
            bwd_err = max(bwd_err, float((got - want).abs().max()) if got.numel() else 0.0)
        # the float64 [F, B, V] block is ~8.6 GB at the stacked shapes: freed at once
        exact = ce_rows_backward_reference(g.double(), h.double(), W.double(), b.double(), t,
                                           logz.double(), nvd)
        vs64 = {out: _f64_gate(f"ce_bwd {out} at {label}", got, want, ex)
                for out, got, want, ex in zip(("dh", "dW", "db"), grads, plain, exact)}
        del exact, plain
        torch.cuda.empty_cache()
        again = ce_rows_backward(g, h, W, b, t, logz, nvd)
        deterministic = all(torch.equal(a, c) for a, c in zip(grads, again))
        if not deterministic:
            raise AssertionError(f"ce_bwd at {label}: two runs differ")
        del grads, again, want_ll, want_logz

        big = B * V * F_ > 10**8
        iters = 5 if big else 50
        hl = h.clone().requires_grad_(True)
        Wl = W.clone().requires_grad_(True)
        bl = b.clone().requires_grad_(True)
        lib_out = _ce_library(hl, Wl, bl, t, nvd)
        times = dict(
            fwd_ms=cuda_ms(lambda: ce_rows_forward(h, W, b, t, nvd), iters),
            bwd_ms=cuda_ms(lambda: ce_rows_backward(g, h, W, b, t, logz, nvd), iters),
            plain_fwd_ms=cuda_ms(lambda: ce_rows_forward_reference(h, W, b, t, nvd), iters),
            plain_bwd_ms=cuda_ms(
                lambda: ce_rows_backward_reference(g, h, W, b, t, logz, nvd), iters),
            library_fwd_ms=cuda_ms(lambda: _ce_library(h, W, b, t, nvd), iters),
            library_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (hl, Wl, bl), g, retain_graph=True), iters),
        )
        del lib_out, hl, Wl, bl
        rows = B if nv is None else nv
        flops = 2 * rows * K * V * F_
        fwd_bytes = 4 * (rows * K + F_ * V * K + F_ * V + 2 * F_ * B) + 8 * F_ * rows
        bwd_bytes = (4 * (rows * K + F_ * V * K + F_ * V + 2 * F_ * rows) + 8 * F_ * rows
                     + 4 * (B * K + F_ * V * K + F_ * V))
        rec = dict(F=F_, B=B, K=K, V=V, padded_columns=pad, num_valid=nv, **times,
                   fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err, fwd_bit_equal=True,
                   bwd_bit_equal=deterministic,
                   fwd_err_vs_float64={k: e[0] for k, e in fwd64.items()},
                   plain_fwd_err_vs_float64={k: e[1] for k, e in fwd64.items()},
                   bwd_err_vs_float64={k: e[0] for k, e in vs64.items()},
                   plain_bwd_err_vs_float64={k: e[1] for k, e in vs64.items()},
                   fwd_bound_tc_ms=max(TF32_PASSES * flops / peak_tc, fwd_bytes / peak_bw) * 1e3,
                   fwd_exp_floor_ms=rows * V * F_ / (peak_flops * EXP_PER_FLOP) * 1e3,
                   bwd_bound_tc_ms=max(TF32_PASSES * 3 * flops / peak_tc,
                                       bwd_bytes / peak_bw) * 1e3)
        for kind, n_flops, n_bytes, ms in (("fwd", flops, fwd_bytes, times["fwd_ms"]),
                                           ("bwd", 3 * flops, bwd_bytes, times["bwd_ms"])):
            by_ops = n_flops / peak_flops >= n_bytes / peak_bw
            rec[f"{kind}_bound_ms"] = max(n_flops / peak_flops, n_bytes / peak_bw) * 1e3
            rec[f"{kind}_bound_by"] = "operations" if by_ops else "bytes"
            rec[f"{kind}_gflop"] = n_flops / 1e9
            rec[f"{kind}_tflops"] = n_flops / ms / 1e9 if ms > 0 else 0.0
        results[label] = rec
        emit(phase="ce_kernel", shape=label, **rec)
        del h, W, b, t, g, ll, logz
        torch.cuda.empty_cache()
    return results


def pro_model(device, weights=None, **kw):
    """The canonical xDeepFMPro (xDeepFMPro(cols, cols) with its defaults)."""
    cols = canonical_columns()
    model = xDeepFMPro(cols, cols, device=device, **kw)
    if weights is not None:
        model.set_weights(weights)
    return model


def pro_batch(model, x, y, n):
    """A train batch as ``_train_step`` gives it to the module."""
    xb, yb = device_batch(model, x, y, n)
    return dict(xb, labels=yb, sample_mask=torch.ones(n, device=model.device)), yb


def pro_step_grads(model, batch, yb):
    """Gradients of one step's loss (sum-BCE + L2 registry + SFG aux), no
    update."""
    model.module.zero_grad(set_to_none=True)
    out = model.module(batch, training=True)
    mask = torch.ones(yb.shape[0], device=yb.device)
    loss = _loss_fn_single("binary_crossentropy")(out["pred"].reshape(-1), yb.reshape(-1), mask)
    (loss + model._regularization_loss() + out["aux_loss"]).backward()
    return {k: p.grad.clone() for k, p in model.module.named_parameters()}


def phase_pro_training():
    model = pro_model("cuda")
    model.compile("adam", "binary_crossentropy", metrics=["auc"])
    rng = np.random.default_rng(SEED + 3)
    x, y = train_data(rng, TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH + TRAIN_BATCH // 2)
    x, y, val = (  # the last half batch validates
        {k: v[: -TRAIN_BATCH // 2] for k, v in x.items()}, y[: -TRAIN_BATCH // 2],
        ({k: v[-TRAIN_BATCH // 2 :] for k, v in x.items()}, y[-TRAIN_BATCH // 2 :]),
    )
    positive_share = float(y.mean())

    reset_launches()
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS, verbose=1,
                        validation_data=val)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    steps = TRAIN_STEPS_PER_EPOCH * TRAIN_EPOCHS
    # one bucket of 26 heads: one ce_fwd and one ce_bwd a step, none in the
    # 3 validation batches (no labels there)
    want = expected(cin_fwd=2 * (steps + TRAIN_EPOCHS), cin_bwd_dx=2 * steps,
                    cin_dw=2 * steps, ce_fwd=steps, ce_bwd=steps)
    if launches != want:
        raise AssertionError(f"Pro launches {launches} over {steps} steps, expected {want}")
    logs = history.history
    if "sfg_loss" not in logs:
        raise AssertionError(f"no sfg_loss in the History: {sorted(logs)}")
    for k, v in logs.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{k} is not finite: {v}")
    if not logs["loss"][0] > logs["loss"][1] > logs["loss"][2]:
        raise AssertionError(f"the epoch loss did not fall: {logs['loss']}")

    # one step's gradients, CE kernels against the plain CE, dropout off;
    # stacked (one launch each) and one head per launch (26 each)
    batch, yb = pro_batch(model, x, y, TRAIN_BATCH)
    dec = model.module.sfg_decoder
    dec.dropout_rate = 0.0
    grad_errs, step_launches = {}, {}
    for stack in (True, False):
        ce.set_stack_heads(stack)
        dec.ce_backend = "torch"
        want_g = pro_step_grads(model, batch, yb)
        dec.ce_backend = None
        reset_launches()
        got_g = pro_step_grads(model, batch, yb)
        counts = read_launches()
        n = 1 if stack else N_SPARSE
        if counts != expected(cin_fwd=2, cin_bwd_dx=2, cin_dw=2, ce_fwd=n, ce_bwd=n):
            raise AssertionError(f"stack_heads={stack}: one step launched {counts}")
        key = "stacked" if stack else "per_head"
        step_launches[key] = counts
        grad_errs[key] = grad_err(got_g, want_g)
        if grad_errs[key] > GRAD_RTOL:
            raise AssertionError(f"{key}: CE kernel gradients off by {grad_errs[key]}")
    ce.set_stack_heads(True)
    unsteady = reproduced("Pro: ", pro_step_grads(model, batch, yb),
                          pro_step_grads(model, batch, yb))
    del want_g, got_g

    # one SGD step on the card against the CPU model from the same weights
    cpu_errs = sgd_step_vs_cpu(
        [pro_model(dev, model.get_weights(), sfg_dropout=0.0) for dev in ("cuda", "cpu")],
        x, y, "Pro: ")
    dec.dropout_rate = model.sfg_dropout

    # examples/s trained, CE kernels and the plain CE in turns
    batches = [device_batch(model, {k: v[i * TRAIN_BATCH:] for k, v in x.items()},
                            y[i * TRAIN_BATCH:], TRAIN_BATCH) for i in range(4)]
    runs = {"kernel": [], "plain": []}
    for backend in ("kernel", "plain", "plain", "kernel"):
        dec.ce_backend = None if backend == "kernel" else "torch"
        runs[backend].append(train_steps_ms(model, batches, 10))
    dec.ce_backend = None
    record = dict(
        batch=TRAIN_BATCH, steps=steps, epochs=TRAIN_EPOCHS, fit_seconds=fit_s,
        positive_share=positive_share, launches=launches, step_launches=step_launches,
        history=logs, grad_rel_err_vs_plain_ce=grad_errs, grads_not_reproduced=unsteady,
        rel_err_vs_cpu_one_sgd_step=cpu_errs,
        ms_per_step_kernel=runs["kernel"], ms_per_step_plain_ce=runs["plain"],
        examples_per_s_kernel=[TRAIN_BATCH / ms * 1e3 for ms in runs["kernel"]],
        examples_per_s_plain_ce=[TRAIN_BATCH / ms * 1e3 for ms in runs["plain"]],
    )
    emit(phase="pro_training", **record)
    return record, model, batches


def phase_pro_scoring(model):
    scorer = Scorer(model, batch_size=BATCH).warmup()
    reqs = requests(np.random.default_rng(SEED + 1), REQUESTS)
    n_batches = sum(-(-n // BATCH) for n in REQUESTS)
    reset_launches()
    preds, eps, ms = score_all(scorer, reqs)
    counts = read_launches()
    if counts != expected(cin_fwd=2 * n_batches):
        raise AssertionError(f"Pro scoring launched {counts} for {n_batches} batches")
    for n, p in zip(REQUESTS, preds):
        if p.shape != (n, 1) or not (np.isfinite(p).all() and (p > 0).all() and (p < 1).all()):
            raise AssertionError(f"bad Pro scores: shape {p.shape}")
    cpu_model = pro_model("cpu", model.get_weights())
    small = requests(np.random.default_rng(SEED + 2), (64,))[0]
    cpu_err = float(np.abs(model.predict(small, 64) - cpu_model.predict(small, 64)).max())
    if cpu_err > 1e-5:
        raise AssertionError(f"Pro: card and CPU scores differ by {cpu_err}")
    record = dict(requests=list(REQUESTS), batches=n_batches, launches=counts,
                  examples_per_s=eps, ms=ms, max_abs_diff_vs_cpu=cpu_err,
                  score_std=float(np.concatenate(preds).std()))
    emit(phase="pro_scoring", **record)
    return record


# ---------------------------------------------------------------------------
# the attention CIN: TPU kernel rows 8-11
# ---------------------------------------------------------------------------

ATTN_S = CIN_LAYERS[0] // 2 + CIN_LAYERS[1]  # 256 feature maps (split-half)
# (label, G, dh, S, precision): V2's train step launches small_attention twice
# at G = 4096 rows x 2 heads; scoring at batch 8192; a ragged and a tiny
# shape; the train shape under set_precision("bf16")
SA_SHAPES = (
    ("v2_train", TRAIN_BATCH * 2, DIM // 2, ATTN_S, "fp32"),
    ("v2_serve", BATCH * 2, DIM // 2, ATTN_S, "fp32"),
    ("ragged", 7, 3, 37, "fp32"),
    ("tiny", 2, 1, 5, "fp32"),
    ("v2_train_bf16", TRAIN_BATCH * 2, DIM // 2, ATTN_S, "bf16"),
)
SA_PATH_SHAPE = "v2_train"
# (label, B, E, S, H, L, use_residual, use_layer_norm): V1's train step runs
# the block once; L = 2, each of the residual and the LayerNorm off (a
# quarter of the batch: not on the path), a ragged shape
AB_SHAPES = (
    ("v1_train", TRAIN_BATCH, DIM, ATTN_S, 2, 1, True, True),
    ("layers_2", TRAIN_BATCH, DIM, ATTN_S, 2, 2, True, True),
    ("no_residual", TRAIN_BATCH // 4, DIM, ATTN_S, 2, 1, False, True),
    ("no_layer_norm", TRAIN_BATCH // 4, DIM, ATTN_S, 2, 1, True, False),
    ("ragged", 5, DIM, 37, 2, 1, True, True),
)
AB_PATH_SHAPE = "v1_train"
# fp32: values and gradients within 1e-4 of the largest entry (sums of S
# terms in another order than cuBLAS's).  bf16: an e or ds computed in
# another order can round to the neighbouring bf16 value (2^-8 apart).
ATTN_RTOL = {"fp32": 1e-4, "bf16": 1e-2}
# kernel launches per train step and per forward-only batch
ATTN_STEP = {"v1": dict(cin_fwd=2, cin_bwd_dx=2, cin_dw=2, ab_fwd=1, ab_bwd=1),
             "v2": dict(cin_fwd=2, cin_bwd_dx=2, cin_dw=2, sa_fwd=2, sa_bwd=2)}
ATTN_EVAL = {"v1": dict(cin_fwd=2, ab_fwd=1), "v2": dict(cin_fwd=2, sa_fwd=2)}
# AutoInt's three InteractingLayers and DIFM's one: a forward and a backward
# launch each per step
ATTN_STEP.update(autoint=dict(la_fwd=3, la_bwd=3), difm=dict(la_fwd=1, la_bwd=1))
ATTN_EVAL.update(autoint=dict(la_fwd=3), difm=dict(la_fwd=1))
# DIEN: the extractor's GRU and the AUGRU, a forward and a backward each
ATTN_STEP.update(dien=dict(gru_fwd=2, gru_bwd=2))
ATTN_EVAL.update(dien=dict(gru_fwd=2))
PHASE = {"v1": "attn_v1", "v2": "attn_v2", "autoint": "autoint", "difm": "difm", "dien": "dien"}


def _checked(got, want, rtol):
    """Largest absolute error, after asserting it within ``rtol`` of the
    largest entry of ``want``."""
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * float(want.abs().max()) + 1e-6)
    return float((got - want).abs().max())


def _bound(flops, nbytes, peak):
    by_ops = flops / peak[1] >= nbytes / peak[2]
    return max(flops / peak[1], nbytes / peak[2]) * 1e3, "operations" if by_ops else "bytes"


def _tc_bounds(rec, prefix, flops, nbytes, exps, peak):
    """The attention kernels' second bound and floor: every FLOP at a third
    of the TF32 rate, or the bytes, the larger (``<prefix>bound_3xtf32_ms``,
    the least time at fp32 accuracy on the card: the convention of rows 3
    and 7, and what rows 9 and 11 run in); and one exp per (i, j) at the
    card's exp rate (``<prefix>exp_floor_ms``)."""
    rec[f"{prefix}bound_3xtf32_ms"] = max(TF32_PASSES * flops / peak[3], nbytes / peak[2]) * 1e3
    rec[f"{prefix}exp_floor_ms"] = exps / (peak[1] * EXP_PER_FLOP) * 1e3


def phase_attn_kernels(peak):
    """sa_fwd / sa_bwd and ab_fwd / ab_bwd against their plain versions on the
    same inputs, each backward bit-equal over two runs, with times and bounds.
    FLOPs: small_attention's two [S, S] products forward (4 G S^2 dh) and five
    backward (10 G S^2 dh); the block adds its E-wide products (projections,
    W_o, pooling: 8 B S E^2 a layer and 2 B S E^2 forward, 16 and 4
    backward).  The exps (G S^2 a pass, on the SFU) are reported, not in the
    bound.  Bytes: each input read once, each output written once (the
    block's forward with the activations it saves for the backward).  The
    backwards run three of their five [S, S] products in 3xTF32 on the
    tensor cores, and sa_fwd takes its exps from a lagging reference max in
    one pass (as ab_fwd's attention, through the same routine): at the path
    shapes sa_fwd's o, ab_fwd's pooled and each gradient are also held
    against float64 (:func:`_f64_gate`), and :func:`_tc_bounds` adds the
    3xTF32 bound and the exp floor.  sa_fwd's o, m and inv_z must be
    bit-equal over two runs, as the backwards' gradients."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    results = {}
    for label, G, dh, S, prec in SA_SHAPES:
        q, k, v, g = (torch.randn(G, dh, S, generator=gen, device="cuda") for _ in range(4))
        scale = dh ** -0.5
        rtol = ATTN_RTOL[prec]
        o, m, z = sa_forward(q, k, v, scale, prec)
        grads = sa_backward(g, q, k, v, o, m, z, scale, prec)
        torch.cuda.synchronize()
        want_o, want_m, want_z = sa_forward_reference(q, k, v, scale, prec)
        fwd_err = max(_checked(o, want_o, rtol), _checked(m, want_m, 1e-5),
                      _checked(z, want_z, 1e-4))
        if not all(torch.equal(a, b) for a, b in zip((o, m, z), sa_forward(q, k, v, scale, prec))):
            raise AssertionError(f"sa_fwd at {label}: two runs differ")
        fwd_gate = None
        if label == SA_PATH_SHAPE:
            exact = sa_forward_reference(q.double(), k.double(), v.double(), scale)[0]
            fwd_gate = _f64_gate(f"sa_fwd o at {label}", o, want_o, exact)
            del exact
        del want_o, want_m, want_z
        bwd_err = max(_checked(a, b, rtol) for a, b in zip(
            grads, sa_backward_reference(g, q, k, v, o, m, z, scale, prec)))
        if not all(torch.equal(a, b) for a, b in zip(
                grads, sa_backward(g, q, k, v, o, m, z, scale, prec))):
            raise AssertionError(f"sa_bwd at {label}: two runs differ")
        gate = {}
        if label == SA_PATH_SHAPE:
            want = sa_backward_reference(g, q, k, v, o, m, z, scale, prec)
            exact = sa_backward_reference(*(t.double() for t in (g, q, k, v, o, m, z)), scale)
            for name, a, b, e in zip(("dq", "dk", "dv"), grads, want, exact):
                gate[name] = _f64_gate(f"sa_bwd {name} at {label}", a, b, e)
            del want, exact
        del grads
        torch.cuda.empty_cache()
        # the library yardstick: SDPA on the [G, S, dh] views, fp32
        ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        gl = g.transpose(1, 2)
        iters = 5 if G > 1000 else 50
        times = dict(
            fwd_ms=cuda_ms(lambda: sa_forward(q, k, v, scale, prec), iters),
            bwd_ms=cuda_ms(lambda: sa_backward(g, q, k, v, o, m, z, scale, prec), iters),
            plain_fwd_ms=cuda_ms(lambda: sa_forward_reference(q, k, v, scale, prec), iters),
            plain_bwd_ms=cuda_ms(
                lambda: sa_backward_reference(g, q, k, v, o, m, z, scale, prec), iters),
            library_fwd_ms=cuda_ms(
                lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale), iters),
            library_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), gl, retain_graph=True), iters),
        )
        del lib_out, ql, kl, vl
        rec = dict(G=G, dh=dh, S=S, precision=prec, **times, fwd_max_abs_err=fwd_err,
                   bwd_max_abs_err=bwd_err, fwd_bit_equal=True, bwd_bit_equal=True,
                   gexp=G * S * S / 1e9)
        if fwd_gate:
            rec["fwd_err_vs_float64"], rec["fwd_plain_err_vs_float64"] = fwd_gate
        if gate:
            rec["bwd_err_vs_float64"] = {k: e[0] for k, e in gate.items()}
            rec["bwd_plain_err_vs_float64"] = {k: e[1] for k, e in gate.items()}
        n = G * dh * S
        for kind, flops, nbytes in (("fwd", 4 * G * S * S * dh, 4 * (4 * n + 2 * G * S)),
                                    ("bwd", 10 * G * S * S * dh, 4 * (8 * n + 2 * G * S))):
            rec[f"{kind}_bound_ms"], rec[f"{kind}_bound_by"] = _bound(flops, nbytes, peak)
            rec[f"{kind}_gflop"] = flops / 1e9
            rec[f"{kind}_tflops"] = flops / rec[f"{kind}_ms"] / 1e9
        _tc_bounds(rec, "fwd_", 4 * G * S * S * dh, 4 * (4 * n + 2 * G * S), G * S * S, peak)
        _tc_bounds(rec, "bwd_", 10 * G * S * S * dh, 4 * (8 * n + 2 * G * S), G * S * S, peak)
        results["sa", label] = rec
        emit(phase="attn_kernel", kernel="small_attention", shape=label, **rec)
        del q, k, v, g, o, m, z
        torch.cuda.empty_cache()

    for label, B, E, S, H, L, res, ln in AB_SHAPES:
        dh = E // H

        def w(*shape):
            return torch.randn(*shape, generator=gen, device="cuda") / E**0.5

        x = torch.randn(B, E, S, generator=gen, device="cuda")
        ws = [w(L * H, E, dh), w(L * H, E, dh), w(L * H, E, dh), w(L * H, dh, E),
              1 + 0.1 * w(L, E, 1), 0.1 * w(L, E, 1), w(E, E), 0.1 * w(E, 1), w(E, 1)]
        g = torch.randn(B, E, generator=gen, device="cuda")
        cfg = BlockCfg(L, H, dh ** -0.5, res, ln, 1e-5)
        pooled, saved = ab_forward(cfg, x, *ws)
        grads = ab_backward(cfg, g, x, *ws, saved)
        torch.cuda.synchronize()
        fwd_err = _checked(pooled, ab_forward_reference(cfg, x, *ws), 1e-4)
        if not torch.equal(ab_forward(cfg, x, *ws, save=False)[0], pooled):
            raise AssertionError(f"ab_fwd at {label}: scoring and training forwards differ")
        bwd_err = max(_checked(a, b, BWD_RTOL) for a, b in zip(
            grads, ab_backward_reference(cfg, g, x, *ws)))
        if not all(torch.equal(a, b) for a, b in zip(grads, ab_backward(cfg, g, x, *ws, saved))):
            raise AssertionError(f"ab_bwd at {label}: two runs differ")
        fwd_gate, gate = None, {}
        if label == AB_PATH_SHAPE:
            fwd_gate = _f64_gate(f"ab_fwd pooled at {label}", pooled,
                                 ab_forward_reference(cfg, x, *ws),
                                 ab_forward_reference(cfg, x.double(), *(t.double() for t in ws)))
            want = ab_backward_reference(cfg, g, x, *ws)
            exact = ab_backward_reference(cfg, g.double(), x.double(), *(t.double() for t in ws))
            names = ("dx", "dwq", "dwk", "dwv", "dwo", "dgamma", "dbeta", "dw1", "db1", "dw2")
            for name, a, b, e in zip(names, grads, want, exact):
                gate[name] = _f64_gate(f"ab_bwd {name} at {label}", a, b, e)
            del want, exact
        del grads
        torch.cuda.empty_cache()
        iters = 5 if B > 100 else 50
        times = dict(
            fwd_ms=cuda_ms(lambda: ab_forward(cfg, x, *ws), iters),
            serve_fwd_ms=cuda_ms(lambda: ab_forward(cfg, x, *ws, save=False), iters),
            bwd_ms=cuda_ms(lambda: ab_backward(cfg, g, x, *ws, saved), iters),
            plain_fwd_ms=cuda_ms(lambda: ab_forward_reference(cfg, x, *ws), iters),
            plain_bwd_ms=cuda_ms(lambda: ab_backward_reference(cfg, g, x, *ws), iters),
        )
        rec = dict(B=B, E=E, S=S, H=H, L=L, use_residual=res, use_layer_norm=ln, **times,
                   library_ms=None, library="no single PyTorch call",
                   fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err, bwd_bit_equal=True,
                   gexp=L * B * H * S * S / 1e9)
        if fwd_gate:
            rec["fwd_err_vs_float64"], rec["fwd_plain_err_vs_float64"] = fwd_gate
        if gate:
            rec["bwd_err_vs_float64"] = {k: e[0] for k, e in gate.items()}
            rec["bwd_plain_err_vs_float64"] = {k: e[1] for k, e in gate.items()}
        glue = B * S * E * E
        wbytes = 4 * sum(t.numel() for t in ws)
        act = 4 * (B * E * S)
        saves = 4 * (2 * B * L * H * S + 2 * B * L * E * S)
        bwd = (L * (10 * B * H * S * S * dh + 16 * glue) + 4 * glue,
               2 * act + 2 * wbytes + 4 * B * E + saves)
        fwd = (L * (4 * B * H * S * S * dh + 8 * glue) + 2 * glue,
               act + wbytes + 4 * B * E + saves)
        for kind, flops, nbytes in (("fwd", *fwd), ("bwd", *bwd)):
            rec[f"{kind}_bound_ms"], rec[f"{kind}_bound_by"] = _bound(flops, nbytes, peak)
            rec[f"{kind}_gflop"] = flops / 1e9
            rec[f"{kind}_tflops"] = flops / rec[f"{kind}_ms"] / 1e9
        _tc_bounds(rec, "fwd_", *fwd, L * B * H * S * S, peak)
        _tc_bounds(rec, "bwd_", *bwd, L * B * H * S * S, peak)
        results["ab", label] = rec
        emit(phase="attn_kernel", kernel="attn_block", shape=label, **rec)
        del x, ws, g, pooled, saved
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# the lane attention of AutoInt and DIFM: TPU kernel rows 12-13
# ---------------------------------------------------------------------------

# (label, B, H, dh, S, scale, layout): AutoInt's train step launches each
# kernel 3 times at B 4096 on its [B, S, E] projections ("packed": the
# strided [H, dh, S, B] views the model hands over), scoring at B 8192;
# DIFM's scaled layer; the same train shape as contiguous [H, dh, S, B]
# ("lanes"); S 64, ragged, tiny and dh 16, the kernels' limits
LA_SHAPES = (
    ("autoint_train", TRAIN_BATCH, 2, DIM // 2, N_SPARSE, 1.0, "packed"),
    ("autoint_serve", BATCH, 2, DIM // 2, N_SPARSE, 1.0, "packed"),
    ("difm_train", TRAIN_BATCH, 2, DIM // 2, N_SPARSE, (DIM // 2) ** -0.5, "packed"),
    ("autoint_train_lanes", TRAIN_BATCH, 2, DIM // 2, N_SPARSE, 1.0, "lanes"),
    ("s64", TRAIN_BATCH, 2, DIM // 2, 64, 1.0, "lanes"),
    ("ragged", 1001, 2, DIM // 2, 39, 1.0, "lanes"),
    ("tiny", 5, 1, 4, 3, 1.0, "lanes"),
    ("dh16", TRAIN_BATCH // 4, 1, 16, N_SPARSE, 0.25, "lanes"),
)
LA_PATH_SHAPE = {"autoint": "autoint_train", "difm": "difm_train"}
# fp32 sums of S terms in another order than the plain einsums': each output
# within 1e-5 of its largest entry
LA_RTOL = 1e-5


def phase_lane_kernels(peak):
    """la_fwd / la_bwd against their plain versions on the same inputs, the
    backward bit-equal over two runs, with times, the library's (SDPA on the
    [B, H, S, dh] views, backward by autograd) and bounds.  FLOPs: the two
    [S, S] products forward (4 S^2 dh a pair), five backward (10 S^2 dh);
    the exps (S^2 a pair, one per (i, j) in each kernel) give the exp floor,
    not the bound.  Bytes: q, k, v and o forward, q, k, v, g, dq, dk and dv
    backward, once each.  At every shape o and each gradient go through the
    float64 gate (:func:`_f64_gate`); each kernel's time a launch comes from
    CUDA events (``fwd_ms``) and from the profiler's kernel durations
    (``fwd_device_ms``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    results = {}
    for label, B, H, dh, S, scale, layout in LA_SHAPES:
        if layout == "lanes":
            q, k, v, g = (torch.randn(H, dh, S, B, generator=gen, device="cuda") for _ in range(4))
        else:
            q, k, v, g = (torch.randn(B, S, H * dh, generator=gen, device="cuda")
                          .view(B, S, H, dh).permute(2, 3, 1, 0) for _ in range(4))
        o = la_forward(q, k, v, scale)
        grads = la_backward(g, q, k, v, scale)
        torch.cuda.synchronize()
        want_o = la_forward_reference(q, k, v, scale)
        want = la_backward_reference(g, q, k, v, scale)
        fwd_err = _checked(o, want_o, LA_RTOL)
        bwd_err = max(_checked(a, b, LA_RTOL) for a, b in zip(grads, want))
        if not all(torch.equal(a, b) for a, b in zip(grads, la_backward(g, q, k, v, scale))):
            raise AssertionError(f"la_bwd at {label}: two runs differ")
        q64, k64, v64, g64 = (t.double() for t in (q, k, v, g))
        fwd_gate = _f64_gate(f"la_fwd o at {label}", o, want_o,
                             la_forward_reference(q64, k64, v64, scale))
        bwd_gate = {name: _f64_gate(f"la_bwd {name} at {label}", a, b, e)
                    for name, a, b, e in zip(("dq", "dk", "dv"), grads, want,
                                             la_backward_reference(g64, q64, k64, v64, scale))}
        del grads, want_o, want, q64, k64, v64, g64
        # the library yardstick: SDPA on the [B, H, S, dh] views, fp32
        ql, kl, vl = (t.permute(3, 0, 2, 1).detach().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        gl = g.permute(3, 0, 2, 1)
        times = dict(
            fwd_ms=cuda_ms(lambda: la_forward(q, k, v, scale), 50),
            bwd_ms=cuda_ms(lambda: la_backward(g, q, k, v, scale), 50),
            plain_fwd_ms=cuda_ms(lambda: la_forward_reference(q, k, v, scale), 20),
            plain_bwd_ms=cuda_ms(lambda: la_backward_reference(g, q, k, v, scale), 20),
            library_fwd_ms=cuda_ms(
                lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale), 20),
            library_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), gl, retain_graph=True), 20),
        )
        del lib_out, ql, kl, vl
        times.update(
            fwd_device_ms=device_ms(lambda: la_forward(q, k, v, scale), "la_fwd_kernel"),
            bwd_device_ms=device_ms(lambda: la_backward(g, q, k, v, scale), "la_bwd_kernel"))
        rec = dict(B=B, H=H, dh=dh, S=S, scale=scale, layout=layout, strides=list(q.stride()),
                   **times, fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err, bwd_bit_equal=True,
                   fwd_err_vs_float64=fwd_gate[0], fwd_plain_err_vs_float64=fwd_gate[1],
                   bwd_err_vs_float64={k_: e[0] for k_, e in bwd_gate.items()},
                   bwd_plain_err_vs_float64={k_: e[1] for k_, e in bwd_gate.items()},
                   gexp=B * H * S * S / 1e9)
        n = B * H * S * dh
        for kind, flops, nbytes in (("fwd", 4 * B * H * S * S * dh, 4 * 4 * n),
                                    ("bwd", 10 * B * H * S * S * dh, 4 * 7 * n)):
            rec[f"{kind}_bound_ms"], rec[f"{kind}_bound_by"] = _bound(flops, nbytes, peak)
            rec[f"{kind}_gflop"] = flops / 1e9
            rec[f"{kind}_mbytes"] = nbytes / 1e6
            rec[f"{kind}_gbytes_per_s"] = nbytes / rec[f"{kind}_ms"] / 1e6
            rec[f"{kind}_exp_floor_ms"] = B * H * S * S / (peak[1] * EXP_PER_FLOP) * 1e3
        results[label] = rec
        emit(phase="lane_kernel", shape=label, **rec)
        del q, k, v, g, o
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# the GRU / AGRU / AUGRU recurrence of DIEN: TPU kernel rows 14-15
# ---------------------------------------------------------------------------

# (label, B, T, H, shortest length): DIEN's train step runs the extractor's
# gru and the augru once each at B 4096, T 50, H 10 with lengths uniform in
# 1..50; scoring at B 8192; a ragged batch and a tiny one with length-0 rows;
# H 16, the kernels' gate
GRU_SHAPES = (
    ("dien_train", TRAIN_BATCH, DIEN_MAXLEN, DIM, 1),
    ("dien_serve", BATCH, DIEN_MAXLEN, DIM, 1),
    ("ragged", 1001, 37, DIM, 0),
    ("tiny", 5, 3, 2, 0),
    ("h16", TRAIN_BATCH, DIEN_MAXLEN, 16, 1),
)
GRU_PATH_SHAPE = "dien_train"
# fp32 recurrences over up to 50 steps, the plain version's gate products in
# cuBLAS's order: outs within 1e-5 of their largest entry; the gradients
# (dW and db sum B * T terms) within BWD_RTOL of theirs
GRU_RTOL = 1e-5


def _gru_case(cell, B, T, H, shortest, gen):
    """Fresh operands of one GRU-scan shape on the card."""
    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    att = None if cell == "gru" else torch.rand(B, T, generator=gen, device="cuda")
    lengths = torch.randint(shortest, T + 1, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
    return (rand(B, T, 3, H), rand(3, H, H, scale=H ** -0.5), rand(3, H, scale=0.3), att,
            lengths, rand(B, H, scale=0.5), rand(B, T, H))


def _cudnn_gru(lengths, T, H, gen):
    """The library yardstick for cell gru: ``torch.nn.GRU`` (cuDNN) over
    ``pack_padded_sequence`` at [B, T, H] inputs, input projection included.
    (forward call, forward + autograd backward call)."""
    net = torch.nn.GRU(H, H, batch_first=True).cuda()
    x = torch.randn(lengths.shape[0], T, H, generator=gen, device="cuda", requires_grad=True)
    lens = lengths.cpu().long()

    def fwd():
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, lens, batch_first=True,
                                                         enforce_sorted=False)
        return net(packed)[0].data

    g = torch.randn(fwd().shape, generator=gen, device="cuda")
    params = (x, *net.parameters())
    return fwd, lambda: torch.autograd.grad(fwd(), params, g)


def phase_gru_kernels(peak):
    """gru_fwd / gru_bwd against their plain versions on the same inputs for
    each cell, the backward bit-equal over two runs, with times, bounds and
    for cell gru cuDNN's GRU beside the kernels plus the hoisted input
    projection (x W_ih^T + b_ih, one product; its backward three).  The
    work counts what this run's lengths need: gi, att and the h history are
    read, and the gate products done, only at the N_valid valid steps; g,
    outs, dgi and datt are every step's.  FLOPs a valid step: forward the
    three [H, H] products and the gates (6 H^2 + 12 H), backward the
    recompute, dW and dh products (18 H^2 + 30 H)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    results = {}
    for cell in ("gru", "agru", "augru"):
        for label, B, T, H, shortest in GRU_SHAPES:
            gi, w, b, att, lengths, h0, g = _gru_case(cell, B, T, H, shortest, gen)
            args = (cell, gi, w, b, att, lengths, h0)
            outs = gru_forward(*args)
            grads = gru_backward(cell, g, *args[1:], outs)
            torch.cuda.synchronize()
            fwd_err = _checked(outs, gru_forward_reference(*args), GRU_RTOL)
            bwd_err = max(_checked(a, e, BWD_RTOL) for a, e in zip(
                grads, gru_backward_reference(cell, g, *args[1:], outs)))
            if not all(torch.equal(a, c) for a, c in zip(grads, gru_backward(cell, g, *args[1:],
                                                                              outs))):
                raise AssertionError(f"gru_bwd {cell} at {label}: two runs differ")
            del grads
            iters = 50 if B > 100 else 200
            times = dict(
                fwd_ms=cuda_ms(lambda: gru_forward(*args), iters),
                bwd_ms=cuda_ms(lambda: gru_backward(cell, g, *args[1:], outs), iters),
                plain_fwd_ms=cuda_ms(lambda: gru_forward_reference(*args), 3),
                plain_bwd_ms=cuda_ms(lambda: gru_backward_reference(cell, g, *args[1:], outs), 3),
                library_fwd_ms=None, library_bwd_ms=None,
            )
            if cell == "gru" and shortest > 0:
                x = torch.randn(B, T, H, generator=gen, device="cuda")
                w_ih, b_ih = torch.randn(3 * H, H, device="cuda"), torch.randn(3 * H, device="cuda")
                dgi = torch.randn(B * T, 3 * H, device="cuda")
                xf = x.view(-1, H)
                times["kernel_with_projection_fwd_ms"] = cuda_ms(lambda: gru_forward(
                    cell, torch.addmm(b_ih, xf, w_ih.T).view(B, T, 3, H), *args[2:]), iters)
                times["kernel_with_projection_bwd_ms"] = cuda_ms(lambda: (
                    gru_backward(cell, g, *args[1:], outs), dgi @ w_ih, dgi.T @ xf, dgi.sum(0)),
                    iters)
                lib_fwd, lib_fwd_bwd = _cudnn_gru(lengths, T, H, gen)
                times["library_fwd_ms"] = cuda_ms(lib_fwd, 20)
                times["library_bwd_ms"] = cuda_ms(lib_fwd_bwd, 20) - times["library_fwd_ms"]
            nv = int(lengths.sum())
            att_in = 0 if cell == "gru" else 1
            small = B + B * H + 3 * H * H + 3 * H  # lengths, h0 (or dh0), w and b
            rec = dict(cell=cell, B=B, T=T, H=H, valid_steps=nv, **times, fwd_max_abs_err=fwd_err,
                       bwd_max_abs_err=bwd_err, bwd_bit_equal=True,
                       library="torch.nn.GRU (cuDNN) over pack_padded_sequence, fwd + autograd bwd "
                               "less fwd" if cell == "gru" else "none computes this cell")
            for kind, flops, nbytes in (
                    ("fwd", nv * (6 * H * H + 12 * H),
                     4 * (nv * (3 * H + att_in) + B * T * H + small)),
                    ("bwd", nv * (18 * H * H + 30 * H),
                     4 * (nv * (4 * H + att_in) + B * T * (H + 3 * H + 1) + 2 * small))):
                rec[f"{kind}_bound_ms"], rec[f"{kind}_bound_by"] = _bound(flops, nbytes, peak)
                rec[f"{kind}_gflop"] = flops / 1e9
                rec[f"{kind}_mbytes"] = nbytes / 1e6
                rec[f"{kind}_gbytes_per_s"] = nbytes / rec[f"{kind}_ms"] / 1e6
            results[cell, label] = rec
            emit(phase="gru_kernel", shape=label, **rec)
            del gi, w, b, att, lengths, h0, g, outs
            torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# the attention ablation: TPU kernel row 16
# ---------------------------------------------------------------------------

# (label, G, S, dh): the ablation script's default, V2's train shape (where
# full is also held against sa_fwd), a ragged and a tiny shape
ABLATE_SHAPES = (
    ("default", 8192, 266, 5),
    ("v2_train", TRAIN_BATCH * 2, ATTN_S, DIM // 2),
    ("ragged", 1001, 39, 3),
    ("tiny", 2, 5, 1),
)
ABLATE_PATH_SHAPE = "default"
ABLATE_RTOL = 1e-5  # of the largest |o|: fp32 sums of S terms in another order
ABLATE_KERNELS = {"full": ablate_full, "dots": ablate_dots, "soft": ablate_soft}


def _ablate_library(variant, q, k, v, scale):
    """One PyTorch call computing the variant's function, or None: full is
    SDPA on the [G, S, dh] views; dots one einsum over q, k and v (its
    contraction order is PyTorch's choice); no call computes soft."""
    if variant == "full":
        ql, kl, vl = (t.transpose(1, 2) for t in (q, k, v))
        return lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
    if variant == "dots":
        return lambda: torch.einsum("gds,gdt,get->ges", q, k, v)
    return None


def phase_ablate_kernels(peak):
    """ablate_full / ablate_dots / ablate_soft against their plain versions
    on the same inputs, each bit-equal over two runs, with times and bounds;
    at V2's train shape full is also held against sa_fwd (exp against exp2)
    and timed beside it.  Work a call, per pair: full 4 S^2 dh FLOP of
    products and 3 S^2 of softmax (scale-subtract FMA, sum), S^2 exp2; dots
    4 S^2 dh; soft 5 S^2 (product, FMA, row and column sums) and S^2 exp2.
    The FLOPs go against the fp32 rate and the exp2 against the
    special-function rate (EXP_PER_FLOP); the bound is the largest of those
    two times and the bytes' (q, k and v read, o written; soft reads only
    row 0 of q and k).  full and dots run sa_fwd's routine
    (``attn_fwd_tc.cuh``): at the script's default shape their o is held
    against float64 (:func:`_f64_gate`), and :func:`_tc_bounds` adds the
    3xTF32 bound of their products and the exp floor."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    results = {}
    for label, G, S, dh in ABLATE_SHAPES:
        q, k, v = (torch.randn(G, dh, S, generator=gen, device="cuda") for _ in range(3))
        scale = dh ** -0.5
        iters = 5 if G > 1000 else 50
        n = G * dh * S
        for variant, kernel in ABLATE_KERNELS.items():
            o = kernel(q, k, v, scale)
            again = kernel(q, k, v, scale)
            torch.cuda.synchronize()
            if not torch.equal(o, again):
                raise AssertionError(f"ablate_{variant} at {label}: two runs differ")
            plain = ABLATE_REFERENCES[variant]
            want = plain(q, k, v, scale)
            err = _checked(o, want, ABLATE_RTOL)
            gate = None
            if variant != "soft" and label == ABLATE_PATH_SHAPE:
                exact = plain(q.double(), k.double(), v.double(), scale)
                gate = _f64_gate(f"ablate_{variant} at {label}", o, want, exact)
                del exact
            del want
            rec = dict(G=G, S=S, dh=dh, max_abs_err=err, max_abs_out=float(o.abs().max()),
                       bit_equal=True,
                       ms=cuda_ms(lambda: kernel(q, k, v, scale), iters),
                       plain_ms=cuda_ms(lambda: plain(q, k, v, scale), max(2, iters // 5)))
            lib = _ablate_library(variant, q, k, v, scale)
            rec["library_ms"] = None if lib is None else cuda_ms(lib, iters)
            rec["library"] = {"full": "F.scaled_dot_product_attention on [G, S, dh] views",
                              "dots": "torch.einsum('gds,gdt,get->ges', q, k, v)",
                              "soft": "no single PyTorch call"}[variant]
            pairs = G * S * S
            flops = {"full": (4 * dh + 3) * pairs, "dots": 4 * dh * pairs,
                     "soft": 5 * pairs}[variant]
            exps = 0 if variant == "dots" else pairs
            nbytes = 4 * ((2 * G * S if variant == "soft" else 3 * n) + n)
            times = {"fp32": flops / peak[1], "exp2": exps / (peak[1] * EXP_PER_FLOP),
                     "bytes": nbytes / peak[2]}
            limit = max(times, key=times.get)
            rec.update(bound_ms=times[limit] * 1e3,
                       bound_by="bytes" if limit == "bytes" else "operations",
                       bound_unit=limit, gflop=flops / 1e9, gexp=exps / 1e9,
                       mbytes=nbytes / 1e6, fp32_ms=times["fp32"] * 1e3,
                       exp2_ms=times["exp2"] * 1e3, bytes_ms=times["bytes"] * 1e3)
            if variant != "soft":
                _tc_bounds(rec, "", 4 * dh * pairs, nbytes, exps, peak)
            if gate:
                rec["err_vs_float64"], rec["plain_err_vs_float64"] = gate
            if variant == "full" and label == "v2_train":
                o_sa = sa_forward(q, k, v, scale)[0]
                rec["max_abs_diff_vs_sa_fwd"] = _checked(o, o_sa, ABLATE_RTOL)
                rec["sa_fwd_ms"] = cuda_ms(lambda: sa_forward(q, k, v, scale), iters)
                del o_sa
            results[variant, label] = rec
            emit(phase="ablate_kernel", kernel=f"ablate_{variant}", shape=label, **rec)
            del o, again
            torch.cuda.empty_cache()
        del q, k, v
        torch.cuda.empty_cache()
    return results


def phase_ablate_script():
    """The ablation's entry point (``bench_attn_ablate.main``) once, at its
    default shape, counts set to 0 just before: it prints its three keys and
    launches each kernel."""
    reset_launches()
    out = bench_attn_ablate.main([])
    counts = read_launches()
    for key in ("full_fwd_ms", "dots_only_fwd_ms", "softmax_only_fwd_ms"):
        if not (isinstance(out.get(key), float) and out[key] > 0):
            raise AssertionError(f"the ablation script printed no {key}: {out}")
    moved = {k: counts[k] for k in ("ablate_full", "ablate_dots", "ablate_soft")}
    if min(moved.values()) < 1 or sum(counts.values()) != sum(moved.values()):
        raise AssertionError(f"the ablation script launched {counts}")
    emit(phase="ablate_script", **out, launches=counts)
    return dict(out, launches=counts)


# ---------------------------------------------------------------------------
# the training CLIs over the native parser
# ---------------------------------------------------------------------------

CLI_TRAIN_ROWS, CLI_TEST_ROWS, CLI_VALUES = 131_072, 16_384, 10_000
CLI_RUNS = (  # (path, CLI module, arguments beyond the common ones)
    ("cli_eval", xdftrain, ["--mode", "eval", "--epochs", "2"]),
    ("cli_final", xdftrain, ["--mode", "final", "--epochs", "1", "--test_path", "{test}"]),
    ("cli_streaming", xdftrain, ["--mode", "eval", "--epochs", "1", "--streaming",
                                 "--eval_path", "{eval}"]),
    ("cli_pro", xdftrain_pro, ["--mode", "eval", "--epochs", "1", "--use_sfg"]),
    ("cli_attn_v1", xdftrain_attn, ["--mode", "eval", "--epochs", "1", "--model_version", "v1"]),
)
# kernel launches a train step and a predicted batch, by CLI module
CLI_STEP = {xdftrain: dict(cin_fwd=2, cin_bwd_dx=2, cin_dw=2),
            xdftrain_pro: dict(cin_fwd=2, cin_bwd_dx=2, cin_dw=2, ce_fwd=1, ce_bwd=1),
            xdftrain_attn: ATTN_STEP["v1"]}
CLI_EVAL = {xdftrain: dict(cin_fwd=2), xdftrain_pro: dict(cin_fwd=2),
            xdftrain_attn: ATTN_EVAL["v1"]}


def cli_corpus(d):
    """A seeded Criteo-like corpus in ``d``: ``train.txt`` (label, 13
    integer-like dense fields with 10% empty, 26 categories of 8 hex digits
    drawn from 10 000 values a field with 2% empty; tab-separated, no
    header), ``eval.txt`` (16 384 more labelled rows) and ``test.txt`` (the
    same rows without the label: the 39-column test format).  Labels come
    from a logistic teacher over per-value effects and the dense fields."""
    rng = np.random.default_rng(SEED + 30)
    n = CLI_TRAIN_ROWS + CLI_TEST_ROWS
    ids = rng.integers(0, CLI_VALUES, (n, N_SPARSE))
    dense = rng.integers(0, 100, (n, N_DENSE))
    dense_empty = rng.uniform(size=(n, N_DENSE)) < 0.1
    cat_empty = rng.uniform(size=(n, N_SPARSE)) < 0.02
    effects = rng.normal(0.0, 0.3, (N_SPARSE, CLI_VALUES))
    logit = (-1.0 + effects[np.arange(N_SPARSE), ids].sum(1)
             + (np.where(dense_empty, 0, dense) / 100.0) @ rng.normal(0, 1.5, N_DENSE))
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(int)
    tokens = rng.integers(0, 2**32, (N_SPARSE, CLI_VALUES))
    words = [[f"{t:08x}" for t in row] for row in tokens]
    cats = [["" if cat_empty[r, f] else words[f][ids[r, f]] for f in range(N_SPARSE)]
            for r in range(n)]
    nums = [["" if dense_empty[r, f] else str(dense[r, f]) for f in range(N_DENSE)]
            for r in range(n)]
    rows = ["\t".join(nums[r] + cats[r]) for r in range(n)]
    paths = {name: os.path.join(d, f"{name}.txt") for name in ("train", "eval", "test")}
    with open(paths["train"], "w") as f:
        f.writelines(f"{labels[r]}\t{rows[r]}\n" for r in range(CLI_TRAIN_ROWS))
    with open(paths["eval"], "w") as f:
        f.writelines(f"{labels[r]}\t{rows[r]}\n" for r in range(CLI_TRAIN_ROWS, n))
    with open(paths["test"], "w") as f:
        f.writelines(f"{rows[r]}\n" for r in range(CLI_TRAIN_ROWS, n))
    return paths


def _timed_build(module, rec):
    """``module.build_model`` that records the seconds from the run's start
    to the model (the parse and preprocessing) and the seconds of its
    ``fit`` / ``fit_stream`` (synchronised at both ends)."""
    build = module.build_model

    def timed(args, linear_cols, dnn_cols, final_mode=False):
        rec["parse_seconds"] = time.perf_counter() - rec["t0"]
        model = build(args, linear_cols, dnn_cols, final_mode)
        for name in ("fit", "fit_stream"):
            def wrapped(*a, _fit=getattr(model, name), **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                history = _fit(*a, **kw)
                torch.cuda.synchronize()
                rec["fit_seconds"] = time.perf_counter() - t0
                return history
            setattr(model, name, wrapped)
        return model

    return timed


def _cli_launches(module, n_train, n_eval, n_test, epochs):
    """The kernel launches a CLI run makes: its train steps, and its
    predicted batches (validation each epoch at the train batch, the eval
    set again at 8192 in eval mode, the test file at 8192)."""
    steps = epochs * -(-n_train // TRAIN_BATCH)
    batches = epochs * -(-n_eval // TRAIN_BATCH) + -(-n_eval // BATCH) + -(-n_test // BATCH)
    return expected(**{k: steps * CLI_STEP[module].get(k, 0) + batches * CLI_EVAL[module].get(k, 0)
                       for k in WRAPPERS}), steps


def phase_cli():
    """The port's training CLIs in-process over a Criteo-like corpus at the
    canonical width (26 categories of ~10 000 values, 13 dense, embedding
    dim 10, the CLIs' default models), all through the native parser on the
    card at batch 4096: xdftrain eval (2 epochs, a 10% validation split),
    final (with --test_path), --streaming (fit_stream, with --eval_path),
    xdftrain_pro --use_sfg and xdftrain_attn --model_version v1 (1 epoch
    each).  Each run's counts are set to 0 just before it and read just
    after; every artifact must exist, preprocess.pkl must say native, no
    pandas may be imported, eval AUC must be finite and above 0.5, the
    2-epoch loss must fall, and load_scorer over the final run's artifacts
    must reproduce test_predictions.csv within 1e-6."""
    records = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        files = cli_corpus(d)
        corpus_s = time.perf_counter() - t0
        for path, module, extra in CLI_RUNS:
            out = os.path.join(d, path)
            argv = ["--data_path", files["train"], "--out_dir", out, "--use_native_parser",
                    "--device", "cuda", "--batch_size", str(TRAIN_BATCH), "--verbose", "0",
                    *(a.format(**files) for a in extra)]
            args = module.parse_args(argv)
            rec = {"t0": time.perf_counter()}
            build = module.build_model
            module.build_model = _timed_build(module, rec)
            reset_launches()
            try:
                log = module.main(argv)
            finally:
                module.build_model = build
            counts = read_launches()
            total_s = time.perf_counter() - rec.pop("t0")
            info = log["data_info"]
            n_train = info.get("train_samples", info.get("total_samples"))
            n_test = CLI_TEST_ROWS if args.test_path else 0
            want, steps = _cli_launches(module, n_train, info.get("eval_samples", 0), n_test,
                                        args.epochs)
            if counts != want:
                raise AssertionError(f"{path}: launches {counts} over {steps} steps, "
                                     f"expected {want}")
            name = log.get("model_config", {}).get("model_version")
            stem = {xdftrain: "xdeepfm", xdftrain_pro: "xdeepfm_pro",
                    xdftrain_attn: f"xdeepfm_attn_{name}"}[module]
            if args.mode == "final":
                artifacts = [f"{stem}_full_weights.bin", "history_full.json",
                             "training_log_full.json", "test_predictions.csv"]
            else:
                artifacts = [f"{stem}_weights.bin", f"{stem}_best.weights", "history.json",
                             "training_log.json"]
            artifacts += ["preprocess.pkl", "native_vocab.bin", log["tensorboard_log_dir"]]
            missing = [a for a in artifacts if not os.path.exists(os.path.join(out, a))]
            if missing:
                raise AssertionError(f"{path}: missing artifacts {missing}")
            with open(os.path.join(out, "preprocess.pkl"), "rb") as f:
                if pickle.load(f).get("native") is not True:
                    raise AssertionError(f"{path}: preprocess.pkl is not the native route's")
            losses = log["history"]["loss"]
            if not np.isfinite(losses).all():
                raise AssertionError(f"{path}: loss not finite: {losses}")
            if len(losses) > 1 and not losses[-1] < losses[0]:
                raise AssertionError(f"{path}: the epoch loss did not fall: {losses}")
            if args.mode == "eval":
                auc = log["results"]["eval_auc"]
                if not (np.isfinite(auc) and auc > 0.5):
                    raise AssertionError(f"{path}: eval AUC {auc}")
            rec.update(module=module.__name__.rsplit(".", 1)[-1], argv_extra=extra,
                       data_info=log["data_info"], results=log.get("results"),
                       history=log["history"], steps=steps, launches=counts,
                       total_seconds=total_s,
                       examples_per_s_fit=args.epochs * n_train / rec["fit_seconds"])
            records[path] = rec
            emit(phase="cli", path=path, **rec)
        if "pandas" in sys.modules:
            raise AssertionError("the native CLI runs imported pandas")

        # the final run's artifacts back through load_scorer
        out = os.path.join(d, "cli_final")
        parser = native.NativeCriteoParser()
        parser.load_vocab(os.path.join(out, "native_vocab.bin"))
        vocab = parser.vocab_sizes()
        cols = [SparseFeat(f"C{j + 1}", int(vocab[j]), DIM) for j in range(N_SPARSE)] + [
            DenseFeat(f"I{j + 1}", 1) for j in range(N_DENSE)]
        final_args = xdftrain.parse_args(["--data_path", files["train"], "--device", "cuda"])
        scorer, pp = load_scorer(
            lambda: xdftrain.build_model(final_args, cols, cols, final_mode=True),
            os.path.join(out, "xdeepfm_full_weights.bin"), os.path.join(out, "preprocess.pkl"))
        if pp is None or pp.get("native") is not True:
            raise AssertionError(f"load_scorer returned no native preprocess dict: {pp}")
        _, dense, ids = parser.transform(files["test"], with_label=False)
        dense = pp["scaler"].transform(dense)
        x = {f"C{j + 1}": ids[:, j] for j in range(N_SPARSE)}
        x.update({f"I{j + 1}": dense[:, j] for j in range(N_DENSE)})
        with open(os.path.join(out, "test_predictions.csv")) as f:
            lines = f.read().splitlines()
        if lines[0] != "predicted_ctr" or len(lines) != CLI_TEST_ROWS + 1:
            raise AssertionError(f"test_predictions.csv: {lines[0]!r}, {len(lines)} lines")
        written = np.array([float(v) for v in lines[1:]])
        scored = scorer.score(x)[:, 0]
        score_err = float(np.abs(scored - written).max())
        if score_err > 1e-6:
            raise AssertionError(f"load_scorer's scores differ from the CSV by {score_err}")
    summary = dict(corpus_seconds=corpus_s, train_rows=CLI_TRAIN_ROWS, test_rows=CLI_TEST_ROWS,
                   vocab=[int(v) for v in vocab], load_scorer_max_abs_diff=score_err,
                   pandas_imported=False)
    emit(phase="cli_summary", **summary)
    return records


# ---------------------------------------------------------------------------
# the embedding tables' backward
# ---------------------------------------------------------------------------


def phase_gather():
    """The table gradient of one step's gathers three ways, each run twice on
    the same cotangent: ``fused_gather`` (the port's: a segment sum over the
    sorted ids), ``F.embedding`` (PyTorch's sorted CUDA backward) and
    ``index_select`` (an fp32 atomic scatter-add).  Whether each is bit-equal
    between calls, its distance from float64 and its time (forward and
    backward), at DIEN's step (4096 rows of 2 + 100 ids over one 10 000-row
    table, half the history positions padding id 0) and xDeepFM's (4096 x 26
    ids over the 26 stacked tables of 10 000 rows, main and linear)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    rng = np.random.default_rng(SEED + 50)
    dien = dien_rows(rng, TRAIN_BATCH)
    dien_ids = np.concatenate([dien["user"][:, None], dien["item"][:, None], dien["hist_item"],
                               dien["neg_hist_item"]], 1)
    xdfm_ids = rng.integers(0, VOCAB, (TRAIN_BATCH, N_SPARSE)) + VOCAB * np.arange(N_SPARSE)
    for label, ids, rows, dim in (("dien_step", dien_ids, VOCAB, DIM),
                                  ("xdeepfm_step", xdfm_ids, N_SPARSE * VOCAB, DIM + 1)):
        ids = torch.as_tensor(ids.reshape(-1), device="cuda")
        table = torch.randn(rows, dim, generator=gen, device="cuda", requires_grad=True)
        g = torch.randn(ids.shape[0], dim, generator=gen, device="cuda")
        want = torch.zeros(rows, dim, dtype=torch.float64, device="cuda").index_add_(
            0, ids, g.double())
        ways = {"fused_gather": lambda: fused_gather((table,), ids),
                "F.embedding": lambda: F.embedding(ids, table),
                "index_select": lambda: table.index_select(0, ids)}
        rec = dict(ids=ids.shape[0], table_rows=rows, dim=dim,
                   longest_run=int(torch.bincount(ids).max()))
        for name, fwd in ways.items():
            first, second = (torch.autograd.grad(fwd(), table, g)[0] for _ in range(2))
            out = fwd()
            rec[name] = dict(
                bit_equal=bool(torch.equal(first, second)),
                rel_err_vs_float64=float((first.double() - want).abs().max() / want.abs().max()),
                fwd_ms=cuda_ms(fwd, 20),
                bwd_ms=cuda_ms(lambda: torch.autograd.grad(out, table, g, retain_graph=True), 20))
        if not rec["fused_gather"]["bit_equal"]:
            raise AssertionError(f"fused_gather at {label}: two backward calls differ")
        emit(phase="gather", shape=label, **rec)


# A gradient summed over 10^6 terms that cancel to a small total carries
# fp32 rounding of the terms' size: against float64, each parameter's
# gradient with the kernels must be within 1e-4 of its largest entry (for
# DIEN, or of GRAD_FLOOR of the model's largest) or within FP32_SLACK times
# the plain fp32 version's own error.
FP32_SLACK = 4.0


def fp64_grads(model, xb, yb, ref):
    """One step's gradients (as :func:`step_grads`) of a float64 copy of
    ``model`` on its plain unfused route (the CIN's plain version,
    ``attn_block.set_backend("xla")``, ``set_mhsa_backend("xla")``,
    ``lane_attention.set_backend("xla")`` and ``gru.set_backend("xla")``, the
    plain scan), and the flips of its kernel-fed
    relus against the fp32 route's record ``ref`` (:class:`ReluRecord`)."""
    m64 = copy.deepcopy(model)
    m64.module = m64.module.double()
    set_kernel_backend(m64, "torch")
    m64.compile("sgd", "binary_crossentropy")
    attn_block.set_backend("xla")
    attention.set_mhsa_backend("xla")
    lane_attention.set_backend("xla")
    gru.set_backend("xla")
    try:
        xb64 = {k: v.double() if v.is_floating_point() else v for k, v in xb.items()}
        grads, held = relu_step_grads(m64, xb64, yb.double(), ref)
        return grads, held.stats()
    finally:
        attn_block.set_backend("auto")
        attention.set_mhsa_backend("auto")
        lane_attention.set_backend("auto")
        gru.set_backend("auto")


def phase_model_training(version):
    """The model ``version`` ("v1", "v2", "autoint", "difm" or "dien")
    trained as the canonical xDeepFM is in phase_training: fit at batch 4096,
    Adam, three epochs of 8 steps; launches per step and per validation
    batch; one step's gradients with the kernels against the plain versions
    (the CIN's, the attention's, the recurrences') on the card, both against
    float64; a second identical step reproduces every gradient; one SGD step
    on the card against the CPU model; the epoch loss falls; examples/s with
    the kernels and with the plain versions."""
    model = canonical_model("cuda", seeded=False, version=version)
    model.compile("adam", "binary_crossentropy", metrics=["auc"])
    rng = np.random.default_rng(SEED + 3)
    x, y = train_data(rng, TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH + TRAIN_BATCH // 2, version)
    x, y, val = (  # the last half batch validates
        {k: v[: -TRAIN_BATCH // 2] for k, v in x.items()}, y[: -TRAIN_BATCH // 2],
        ({k: v[-TRAIN_BATCH // 2 :] for k, v in x.items()}, y[-TRAIN_BATCH // 2 :]),
    )
    reset_launches()
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS, verbose=1,
                        validation_data=val)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    steps = TRAIN_STEPS_PER_EPOCH * TRAIN_EPOCHS
    per_step, per_eval = ATTN_STEP[version], ATTN_EVAL[version]
    want = expected(**{k: steps * per_step.get(k, 0) + TRAIN_EPOCHS * per_eval.get(k, 0)
                       for k in WRAPPERS})
    if launches != want:
        raise AssertionError(f"{version}: launches {launches} over {steps} steps, expected {want}")
    logs = history.history
    for k, v in logs.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{version}: {k} is not finite: {v}")
    if not logs["loss"][0] > logs["loss"][1] > logs["loss"][2]:
        raise AssertionError(f"{version}: the epoch loss did not fall: {logs['loss']}")

    # one step's gradients, every kernel of the path against its plain
    # version, each against float64, their kernel-fed relus compared
    # (ReluRecord); the parameters whose gradients a second identical step
    # does not reproduce bit for bit
    xb, yb = device_batch(model, x, y, TRAIN_BATCH)
    set_kernel_backend(model, "torch")
    want_g, plain_rec = relu_step_grads(model, xb, yb)
    set_kernel_backend(model, None)
    reset_launches()
    got_g, kernel_rec = relu_step_grads(model, xb, yb)
    step_launches = read_launches()
    if step_launches != expected(**per_step):
        raise AssertionError(f"{version}: one step launched {step_launches}")
    unsteady = reproduced(f"{version}: ", got_g, step_grads(model, xb, yb))
    set_kernel_backend(model, "torch")
    held_g, held = relu_step_grads(model, xb, yb, kernel_rec)
    set_kernel_backend(model, None)
    floor = GRAD_FLOOR.get(version, 0.0)
    grad_rel = grad_err(got_g, held_g, floor)
    del held_g
    ref, kernel_vs64 = fp64_grads(model, xb, yb, kernel_rec)
    ref_plain, plain_vs64 = fp64_grads(model, xb, yb, plain_rec)
    relu_flips = dict(kernel_vs_plain=held.stats(), kernel_vs_float64=kernel_vs64,
                      plain_vs_float64=plain_vs64)
    kernel64, plain64 = per_grad_err(got_g, ref, floor), per_grad_err(want_g, ref_plain, floor)
    vs64 = {k: (kernel64[k], plain64[k]) for k in ref}
    bad = {k: e for k, e in vs64.items() if e[0] > max(GRAD_RTOL, FP32_SLACK * e[1])}
    if bad:
        raise AssertionError(f"{version}: kernel gradients off float64 by (kernel, plain) {bad}")
    worst = sorted(vs64.items(), key=lambda kv: -kv[1][0])[:5]
    del want_g, got_g, ref, ref_plain, kernel_rec, plain_rec

    # one SGD step on the card against the CPU model from the same weights
    cpu_errs = sgd_step_vs_cpu(
        [canonical_model(dev, model.get_weights(), version=version) for dev in ("cuda", "cpu")],
        x, y, f"{version}: ", floor)

    # examples/s trained, the kernels and the plain versions in turns; these
    # 44 steps repeat 4 batches (DIFM's refined FM saturates its sigmoid on
    # them), so the weights go back to those fit trained before scoring
    trained = model.get_weights()
    batches = [device_batch(model, {k: v[i * TRAIN_BATCH:] for k, v in x.items()},
                            y[i * TRAIN_BATCH:], TRAIN_BATCH) for i in range(4)]
    runs = {"kernel": [], "plain": []}
    for backend in ("kernel", "plain", "plain", "kernel"):
        set_kernel_backend(model, None if backend == "kernel" else "torch")
        runs[backend].append(train_steps_ms(model, batches, 10))
    set_kernel_backend(model, None)
    model.set_weights(trained)
    torch.cuda.empty_cache()
    record = dict(
        model=version, batch=TRAIN_BATCH, steps=steps, epochs=TRAIN_EPOCHS, fit_seconds=fit_s,
        launches=launches, step_launches=step_launches, history=logs,
        grad_rel_err_vs_plain=grad_rel, relu_flips=relu_flips, grads_not_reproduced=unsteady,
        grad_rel_err_vs_float64_worst={k: {"kernel": e[0], "plain": e[1]} for k, e in worst},
        grad_rel_err_vs_float64_tables={k: {"kernel": e[0], "plain": e[1]}
                                         for k, e in vs64.items() if "table_d" in k},
        rel_err_vs_cpu_one_sgd_step=cpu_errs,
        ms_per_step_kernel=runs["kernel"], ms_per_step_plain=runs["plain"],
        examples_per_s_kernel=[TRAIN_BATCH / ms * 1e3 for ms in runs["kernel"]],
        examples_per_s_plain=[TRAIN_BATCH / ms * 1e3 for ms in runs["plain"]],
    )
    emit(phase=f"{PHASE[version]}_training", **record)
    return record, model, batches


def phase_model_scoring(model, version):
    """The trained model through ``Scorer(batch_size=8192)`` over the serving
    requests: per batch V1 2 cin_fwd and one ab_fwd, V2 2 cin_fwd and two
    sa_fwd, AutoInt three la_fwd, DIFM one, DIEN two gru_fwd, no backward;
    the scores agree with the CPU model's on a small input."""
    scorer = Scorer(model, batch_size=BATCH).warmup()
    reqs = requests(np.random.default_rng(SEED + 1), REQUESTS, version)
    n_batches = sum(-(-n // BATCH) for n in REQUESTS)
    reset_launches()
    preds, eps, ms = score_all(scorer, reqs)
    counts = read_launches()
    want = expected(**{k: n_batches * c for k, c in ATTN_EVAL[version].items()})
    if counts != want:
        raise AssertionError(f"{version} scoring launched {counts}, expected {want}")
    for n, p in zip(REQUESTS, preds):
        if p.shape != (n, 1) or not (np.isfinite(p).all() and (p > 0).all() and (p < 1).all()):
            raise AssertionError(f"bad {version} scores: shape {p.shape}, "
                                 f"range [{p.min()}, {p.max()}]")
    runs = [score_all(scorer, reqs) for _ in range(2)]
    cpu_model = canonical_model("cpu", model.get_weights(), version=version)
    small = requests(np.random.default_rng(SEED + 2), (64,), version)[0]
    cpu_err = float(np.abs(model.predict(small, 64) - cpu_model.predict(small, 64)).max())
    if cpu_err > 1e-5:
        raise AssertionError(f"{version}: card and CPU scores differ by {cpu_err}")
    record = dict(model=version, requests=list(REQUESTS), batches=n_batches, launches=counts,
                  examples_per_s=[eps] + [r[1] for r in runs], ms=[ms] + [r[2] for r in runs],
                  max_abs_diff_vs_cpu=cpu_err, score_std=float(np.concatenate(preds).std()))
    emit(phase=f"{PHASE[version]}_scoring", **record)
    return record


def device_breakdown(prof, wall_ms, calls):
    """Device ms by kernel, busy and idle share.  User-annotation ranges on
    the device (``Optimizer.step#Adam.step``) span kernels already counted,
    so they are left out."""
    device_ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
            e, "is_user_annotation", False
        ):
            device_ms[e.name] = device_ms.get(e.name, 0.0) + e.device_time_total / 1e3
    busy_ms = sum(device_ms.values())
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_ms_per_call=wall_ms / calls, device_busy_ms_per_call=busy_ms / calls,
                device_idle_share=1.0 - busy_ms / wall_ms,
                top_device_ms_per_call=[[name[:80], ms / calls] for name, ms in top])


def main():
    name, peak = phase_device()
    phase_build()
    shapes = phase_kernels(peak)
    ce_shapes = phase_ce_kernels(peak)
    attn_shapes = phase_attn_kernels(peak)
    la_shapes = phase_lane_kernels(peak)
    gru_shapes = phase_gru_kernels(peak)
    ablate_shapes = phase_ablate_kernels(peak)
    ablation = phase_ablate_script()
    serving, scorer, req = phase_serving()
    phase_profile(scorer, req)
    training, model, batches = phase_training()
    phase_train_profile(model, batches)
    del scorer, model, batches
    torch.cuda.empty_cache()
    pro, pro_m, pro_batches = phase_pro_training()
    phase_train_profile(pro_m, pro_batches, phase="pro_train_profile")
    pro_scoring = phase_pro_scoring(pro_m)
    del pro_m, pro_batches
    torch.cuda.empty_cache()
    attn = {}
    for version in ("v1", "v2", "autoint", "difm", "dien"):
        rec, attn_m, attn_batches = phase_model_training(version)
        phase_train_profile(attn_m, attn_batches, phase=f"{PHASE[version]}_train_profile")
        attn[version] = rec, phase_model_scoring(attn_m, version)
        del attn_m, attn_batches
        torch.cuda.empty_cache()
    phase_gather()
    cli = phase_cli()
    paths = {"training": training["launches"], "pro_training": pro["launches"],
             "pro_scoring": pro_scoring["launches"]}
    for version, (rec, scoring) in attn.items():
        paths[f"{PHASE[version]}_training"] = rec["launches"]
        paths[f"{PHASE[version]}_scoring"] = scoring["launches"]
    paths["ablation"] = ablation["launches"]
    paths.update({path: rec["launches"] for path, rec in cli.items()})
    kernels = []
    for kname in ("cin_fwd", "cin_bwd_dx", "cin_dw"):
        source, replaces = SOURCES[kname]
        path = [shapes[kname, label] for label, *_ in TRAIN_SHAPES]  # per train step
        ops_s = sum(r["gflop"] for r in path) * 1e9 / peak[1]
        bytes_s = sum(r["mbytes"] for r in path) * 1e6 / peak[2]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=training["launches"][kname],
            launches_by_path={
                "serving": serving["cin_launches"] if kname == "cin_fwd" else 0,
                **{path: counts[kname] for path, counts in paths.items()}},
            max_abs_err=max(r["max_abs_err"] for (k, _), r in shapes.items() if k == kname),
            ms=sum(r["kernel_ms"] for r in path),
            plain_ms=sum(r["plain_ms"] for r in path),
            bound_ms=sum(r["bound_ms"] for r in path),
            bound_by="operations" if ops_s >= bytes_s else "bytes",
            library_ms=sum(r["library_ms"] for r in path),
            per="train step at batch 4096 (2 launches)",
            bound_tc_ms=sum(r["bound_tc_ms"] for r in path),
            err_vs_float64=max(r["err_vs_float64"] for (k, _), r in shapes.items()
                               if k == kname),
            bit_equal=all(r["bit_equal"] for (k, _), r in shapes.items() if k == kname),
        ))
    for kname, kind in (("ce_fwd", "fwd"), ("ce_bwd", "bwd")):
        source, replaces = SOURCES[kname]
        r = ce_shapes[CE_PATH_SHAPE]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=pro["launches"][kname],
            launches_by_path={path: counts[kname] for path, counts in paths.items()},
            max_abs_err=max(x[f"{kind}_max_abs_err"] for x in ce_shapes.values()),
            ms=r[f"{kind}_ms"], plain_ms=r[f"plain_{kind}_ms"],
            bound_ms=r[f"{kind}_bound_ms"], bound_by=r[f"{kind}_bound_by"],
            library_ms=r[f"library_{kind}_ms"],
            per=f"Pro train step at batch 4096, {r['F']} stacked heads, {r['num_valid']} "
                "valid rows (1 launch)",
            bound_tc_ms=r[f"{kind}_bound_tc_ms"],
            **({"exp_floor_ms": r["fwd_exp_floor_ms"]} if kind == "fwd" else {}),
            err_vs_float64=max(e for x in ce_shapes.values()
                               for e in x[f"{kind}_err_vs_float64"].values()),
            bit_equal=all(x[f"{kind}_bit_equal"] for x in ce_shapes.values()),
        ))
    # rows 8-9 on V2's train step (2 launches of each), rows 10-11 on V1's (1)
    for kname, kind, key, path, n in (
            ("sa_fwd", "fwd", ("sa", SA_PATH_SHAPE), "attn_v2_training", 2),
            ("sa_bwd", "bwd", ("sa", SA_PATH_SHAPE), "attn_v2_training", 2),
            ("ab_fwd", "fwd", ("ab", AB_PATH_SHAPE), "attn_v1_training", 1),
            ("ab_bwd", "bwd", ("ab", AB_PATH_SHAPE), "attn_v1_training", 1)):
        source, replaces = SOURCES[kname]
        r = attn_shapes[key]
        lib = r.get(f"library_{kind}_ms")
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=paths[path][kname],
            launches_by_path={p: counts[kname] for p, counts in paths.items()},
            max_abs_err=max(x[f"{kind}_max_abs_err"] for (k, _), x in attn_shapes.items()
                            if k == key[0]),
            ms=n * r[f"{kind}_ms"], plain_ms=n * r[f"plain_{kind}_ms"],
            bound_ms=n * r[f"{kind}_bound_ms"], bound_by=r[f"{kind}_bound_by"],
            library_ms=None if lib is None else n * lib,
            bound_tc_ms=n * r[f"{kind}_bound_3xtf32_ms"],
            exp_floor_ms=n * r[f"{kind}_exp_floor_ms"],
            err_vs_float64=(max(r["bwd_err_vs_float64"].values()) if kind == "bwd"
                            else r["fwd_err_vs_float64"]),
            per=(f"V2 train step at batch 4096 ({n} launches, G {r['G']}, dh {r['dh']}, "
                 f"S {r['S']})" if key[0] == "sa" else
                 f"V1 train step at batch 4096 (1 launch, E {r['E']}, S {r['S']}, H {r['H']})"),
        ))
    # rows 12-13 on AutoInt's train step (3 launches of each)
    for kname, kind in (("la_fwd", "fwd"), ("la_bwd", "bwd")):
        source, replaces = SOURCES[kname]
        r = la_shapes[LA_PATH_SHAPE["autoint"]]
        n = ATTN_STEP["autoint"][kname]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=paths["autoint_training"][kname],
            launches_by_path={p: counts[kname] for p, counts in paths.items()},
            max_abs_err=max(x[f"{kind}_max_abs_err"] for x in la_shapes.values()),
            ms=n * r[f"{kind}_ms"], plain_ms=n * r[f"plain_{kind}_ms"],
            bound_ms=n * r[f"{kind}_bound_ms"], bound_by=r[f"{kind}_bound_by"],
            library_ms=n * r[f"library_{kind}_ms"],
            device_ms=n * r[f"{kind}_device_ms"], exp_floor_ms=n * r[f"{kind}_exp_floor_ms"],
            err_vs_float64=max(
                x["fwd_err_vs_float64"] if kind == "fwd" else max(x["bwd_err_vs_float64"].values())
                for x in la_shapes.values()),
            per=(f"AutoInt train step at batch 4096 ({n} launches, H {r['H']}, dh {r['dh']}, "
                 f"S {r['S']}, [B, S, E] strides)"),
        ))
    # rows 14-15 on DIEN's train step: the extractor's gru and the augru, one
    # launch of each kernel each
    for kname, kind in (("gru_fwd", "fwd"), ("gru_bwd", "bwd")):
        source, replaces = SOURCES[kname]
        rs = [gru_shapes[cell, GRU_PATH_SHAPE] for cell in ("gru", "augru")]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=paths["dien_training"][kname],
            launches_by_path={p: counts[kname] for p, counts in paths.items()},
            max_abs_err=max(x[f"{kind}_max_abs_err"] for x in gru_shapes.values()),
            ms=sum(r[f"{kind}_ms"] for r in rs), plain_ms=sum(r[f"plain_{kind}_ms"] for r in rs),
            bound_ms=sum(r[f"{kind}_bound_ms"] for r in rs),
            bound_by=max(rs, key=lambda r: r[f"{kind}_bound_ms"])[f"{kind}_bound_by"],
            library_ms=None, library_gru_cell_ms=rs[0][f"library_{kind}_ms"],
            per=f"DIEN train step at batch 4096 (1 gru + 1 augru launch, T {rs[0]['T']}, "
                f"H {rs[0]['H']}); no library call computes the augru",
        ))
    # row 16: one forward of each variant at the ablation script's default
    for variant in ABLATE_KERNELS:
        kname = f"ablate_{variant}"
        source, replaces = SOURCES[kname]
        r = ablate_shapes[variant, ABLATE_PATH_SHAPE]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=paths["ablation"][kname],
            launches_by_path={p: counts[kname] for p, counts in paths.items()},
            max_abs_err=max(x["max_abs_err"] for (v, _), x in ablate_shapes.items()
                            if v == variant),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            bound_unit=r["bound_unit"], library_ms=r["library_ms"],
            **({"bound_tc_ms": r["bound_3xtf32_ms"], "exp_floor_ms": r["exp_floor_ms"],
                "err_vs_float64": r["err_vs_float64"]} if variant != "soft" else {}),
            per=f"one forward at G {r['G']}, S {r['S']}, dh {r['dh']} (the script's default)",
        ))
    for rec in kernels:  # each kernel's source and the headers that hold its routine
        rec["sources"] = [rec["source"], *HEADERS.get(rec["name"], ())]
    emit(kernels=kernels)
    emit(ok=True, device=dict(platform="gpu", kind=name, count=torch.cuda.device_count()))


if __name__ == "__main__":
    main()
