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
   tensor-core peak; then the bf16 mode's ``cin_fwd_bf16`` (train and
   serving shapes) and ``cin_bwd_dx_bf16`` (train shapes) against their
   bf16 plain versions and float64 of the same rounded operands by the same
   gate, bit-equal, beside the plain version, one ``torch.einsum`` on bf16
   operands, the profiler's device ms of the fp32 kernel at the same shape,
   the bound at the bf16 tensor-core peak, its share and the built variant,
   and the rounding pass of g (``cin_round_g_bf16``: its fp32 copy bit-equal
   to ``bf16_round(g)``, bound by its bytes) (``cin_bf16_kernel`` lines);
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
   the TF32 tensor cores, and the forward's exp floor; the fp32 outputs'
   sha256 (``outputs_sha256``); then the CE's bf16 mode (``ce_bf16_kernel``
   lines, every shape but the full-B one): ``ce_round_bf16`` (its tiles
   equal to the plain rounding), ``ce_fwd_bf16`` and ``ce_bwd_bf16`` on its
   tiles, one launch each, against the bf16 plain versions, against float64
   of the same rounded operands by the same gate, bit-equal over two runs,
   with their times, the plain and library times (bf16 ``F.linear``) and the
   bounds at the bf16 tensor-core peak and the exp rate;
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
   gradient also against float64; then the bf16 mode's ``sa_fwd_bf16`` /
   ``sa_bwd_bf16`` (``attn_bf16_kernel`` lines) at V2's train and serving
   shapes, ragged, tiny and S 600: against the bf16 plain versions and the
   float64 function of the same rounded inputs (twice the plain version's
   error), bit-equal over two runs, m bit-equal to the plain version's where
   the scores are exact, beside the plain versions, the fp32 kernels' bf16
   flag that they replaced and SDPA on bf16 operands, with device ms and the
   bounds at the exp rate and the bf16 tensor-core peak; and the fp32
   kernels' outputs' sha256 (``attn_fp32_outputs``);
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
   (B 8192), ragged (B 1001, T 37, some lengths 0), tiny, H 16, H 11,
   lengths 1..8 of T 50 and T 130; every backward bit-equal over two runs,
   outs and each gradient against float64 within twice the plain fp32
   version's error (or 1e-6 of the largest entry), each kernel's device
   time a launch from the profiler; beside them for cell gru cuDNN's
   ``torch.nn.GRU`` over ``pack_padded_sequence`` (backward by autograd)
   and the kernel plus the hoisted input projection, which cuDNN includes;
16. ``pro_autodis`` (run right after Pro's scoring): xDeepFMPro with
   ``use_autodis=True`` (the 13 dense fields through 16 buckets each), SFG
   on, ``fit`` at batch 4096 with Adam for two epochs, the CIN's 2 + 2 + 2
   and 1 ``ce_fwd`` + 1 ``ce_bwd`` a step, gradients with the CE kernels
   against the plain CE, the encoder's gradients non-zero, one SGD step
   against the CPU, a training profile and ``Scorer(8192)`` (2 ``cin_fwd``
   a batch) against the CPU model; ``flax_io``: the JAX package's file
   format (``serialization``): the canonical xDeepFM's weights out and back
   through ``load_weights`` with bit-equal scores, a lazy checkpoint out
   through ``to_jax_checkpoint`` and back through ``load_checkpoint`` with
   every weight, row state and the next step bit-equal, and a 28M x 10
   fp32 table (1.12 GB) through flax's chunked form with its write and
   read seconds;
   DIEN (``bench.py``'s ``dien`` row: AUGRU, negative sampling, user and
   item of vocab 10 000 and dim 10, one dense field, histories of maxlen 50)
   trained, profiled and scored as the models in 12: per step 2 ``gru_fwd``
   + 2 ``gru_bwd`` (the extractor's GRU and the AUGRU), per scored batch 2
   ``gru_fwd``;
17. the FM family and the BatchNorm slice (``zoo`` lines; no kernel of
   their own): DeepFM, WDL, NFM,
   AFM (325 pairs), IFM, DCN and DCN-Mix with their constructors' defaults on
   the canonical columns, each ``fit`` at batch 4096 with Adam for two
   epochs of 8 steps (every logged value finite, the epoch loss falling),
   none of the hand-written kernels launched in training or scoring, one
   SGD step on the card against the CPU model, examples/s trained, a
   training profile, and ``Scorer(batch_size=8192)`` over the serving
   requests agreeing with the CPU model on a small input; AFN (LTL 256 and
   a BatchNorm DNN (256, 128)) and DIN (Dice attention (64, 16), DNN (256,
   128), on DIEN's columns less the negatives and DIEN's rows) likewise, the
   SGD step also holding the BatchNorm running statistics, the fit's peak
   memory recorded; then a DCN with
   the last 13 sparse fields at dim 4 (``table_d10`` and ``table_d4``,
   ``fast_inputs`` on the per-feature route, one SGD step against the CPU);
   FiBiNET, PNN, CCPM, MLR and ONN (ROADMAP item 12c) trained and scored as
   the FM family, the fit's peak memory recorded;
   SharedBottom, ESMM, MMOE and PLE (ROADMAP item 15) at their defaults
   likewise, under the loss list ``["binary_crossentropy",
   "binary_crossentropy"]`` on two nested labels a row (the click and a
   click converted with probability MT_CVR), their scores [n, 2];
   ``zoo_variants_sgd_step``: PNN's outer "mat" product, FiBiNET's "each"
   bilinear and MLR with bias columns, one SGD step each against the CPU;
   ``mt_variants_sgd_step``: SharedBottom without towers on a binary and a
   regression task (``["binary_crossentropy", "mse"]``), MMOE without gate
   DNNs, PLE with 2 specific experts and 1 shared and ``l2_reg_dnn=1e-3``,
   one SGD step each against the CPU; ``mt_lazy``: MMOE under the lazy
   optimizer (Adam, split, packed), MT_LAZY_STEPS steps of batch 4096, the
   weights and row states after each step against the CPU model's within
   the lazy tolerances;
   ``zoo_ccpm_tf32_default``: CCPM with ``cudnn.allow_tf32 = True``, no
   convolution or TF32 kernel in its step, each conv layer's kernel
   gradient against float64 within FP32_SLACK times the CPU's error (cuDNN's
   TF32 conv beside it), one SGD step against the CPU;
   ``zoo_determinism``: the five at batch 4096, two identical steps
   bit-equal;
   ``dien_dice``: DIEN with a Dice attention MLP and a BatchNorm DNN, one
   SGD step on the card against the CPU (weights, gradients, running
   statistics) with 2 ``gru_fwd`` + 2 ``gru_bwd`` as on DIEN's path;
   ``bf16``: the canonical xDeepFM compiled with
   ``matmul_precision="bfloat16"``, its first step's loss within 1e-2 of the
   fp32 step's from the same weights, ``fit`` for two epochs of 8 steps with
   the fp32 path's CIN launches, the loss falling, bf16 GEMM kernels in its
   training profile and its busy ms beside the fp32 step's;
   ``cin_bf16_training``: the canonical xDeepFM under
   ``set_cin_precision("bf16")``, ``fit`` for two epochs of 8 steps with 2
   ``cin_fwd_bf16`` + 2 ``cin_round_g_bf16`` + 2 ``cin_bwd_dx_bf16`` + 2
   ``cin_dw`` a step and no fp32 forward or dx launch, one step's
   gradients under both backward
   implementations (kernels and plain versions each against float64 in the
   bf16 mode), one SGD step against the CPU model, ms a step and busy share
   beside the fp32 CIN's, then ``Scorer(8192)`` with 2 ``cin_fwd_bf16`` a
   batch against the CPU model;
   ``pro_ce_bf16_training``: the canonical xDeepFMPro under
   ``ce.set_precision("bf16")``, the first step's loss within
   PRO_CE_BF16_LOSS_RTOL of the fp32 mode's, ``fit`` for two epochs of 8
   steps with 1 ``ce_round_bf16`` + 1 ``ce_fwd_bf16`` + 1 ``ce_bwd_bf16`` a
   step and no fp32 CE launch, one SGD step against the CPU model, ms a step
   and the profiles' busy ms, idle share and device ms by kernel beside the
   fp32 mode's;
   ``v2_attn_bf16_training``: the canonical xDeepFMAttentionV2 under
   ``attention.set_precision("bf16")``, the first step's loss with the
   kernels within V2_BF16_LOSS_RTOL of the bf16 plain versions' on the card,
   ``fit`` for two epochs of 8 steps with 2 ``sa_fwd_bf16`` + 2
   ``sa_bwd_bf16`` (and the CIN's 2 + 2 + 2) a step and no fp32 ``sa_*``
   launch, one SGD step against the CPU model in the bf16 mode,
   ``Scorer(8192)`` with 2 ``sa_fwd_bf16`` (G 16384) a batch against the CPU
   model, ms a step and the profiles' busy ms, idle share and device ms by
   kernel beside the fp32 mode's;
18. the embedding tables' backward (``gather`` lines): the port's
   deterministic ``fused_gather`` beside ``F.embedding``'s and
   ``index_select``'s, bit-equality over two calls, error against float64
   and time, at DIEN's and xDeepFM's step;
   the compiled dispatch (``graph_*`` lines, ``xdeepfm_tpu_torch/dispatch.py``):
   ``graph_training``, the canonical xDeepFM at batch 4096 with Adam, ``fit``
   of GRAPH_STEPS steps at K = GRAPH_K (CUDA graphs of K chained steps; the
   first group runs eagerly as the warm-up, the second is captured) against K = 1
   from the same seeded weights, dense, lazy (split, packed) and under
   ``set_cin_precision("bf16")``: the weights, row states and history equal
   to the bit, the launch counts GRAPH_STEPS times a step's, then a timed
   and a profiled second and third fit of each (3 replays), the profiler's
   records of every hand-written kernel equal to the eager steps' and
   GRAPH_K times a step's per replay, wall, busy and idle ms a step;
   ``graph_pro_training``, xDeepFMPro with the CE in its bf16 mode and SFG
   dropout, the same checks; ``graph_serving``, ``Scorer(8192)``'s graph
   against the eager forward, bit-equal, then ``load_weights`` of other
   weights with no new capture, bit-equal to the eager forward and to the
   other model, wall, busy and idle ms a batch of each.  ``--graph-only``
   runs the device, build and these phases alone;
19. the training CLIs over the native parser (``cli`` lines, among them
   ``cli_lazy``: ``xdftrain --embedding_optimizer lazy``, split and packed;
   ``cli_v1``: ``xdftrain_v1`` final; ``cli_attn_v2``: ``xdftrain_attn
   --model_version v2 --num_attn_layers 2``; ``cli_pro_autodis``: ``xdftrain_pro --use_sfg
   --use_autodis``) and ``load_scorer`` over their artifacts
   (``cli_summary``); then the usage layer (``example`` and ``launcher``
   lines): the four ``xdeepfm_tpu_torch/examples/`` at their own sizes
   (wall seconds, examples/s, the CIN's launches, the serving example's
   largest |scorer - predict|) and the three ``scripts/run*.bash``
   launchers through bash on a 2048-row corpus;
20. the lazy row-sparse embedding optimizer (``compile(embedding_optimizer=
   "lazy")``; its sort, run sums and row writes are PyTorch ops, the CIN's
   and the GRU's kernels run on its steps): ``lazy_checks`` at 26 x 100 000
   rows (Adam and Adagrad in every mode: split flat, split packed, dense
   cotangent, packed bf16; packed against flat and split against dense
   cotangent within the lazy tolerances, bit-equal where ``bit_equal``
   says; the rows no batch touched and their state bit-unchanged; a second
   identical run bit-equal; one step against the CPU model; a packed
   checkpoint loaded into a flat model and stepped); ``lazy_dien`` (DIEN,
   one singleton packed group, 2 ``gru_fwd`` + 2 ``gru_bwd`` a step, its
   untouched rows unchanged); then ``lazy`` lines at ``bench.py``'s
   ``lazy104`` shape (26 x 4 000 000 rows, batch 4096): lazy Adagrad split
   packed, lazy Adam in bf16 state and dense Adam, each with ms a step (CUDA
   events), examples/s, busy ms, idle share and kernels (profiler), memory,
   2 + 2 + 2 CIN launches a step, and for the lazy runs one step's
   transient allocation below a tenth of the group array's bytes;
21. the rank grid (``sharded`` lines, ``parallel/``): 4 ranks on a (data 2,
   embed 2) grid and 2 on a (1, 2) grid, co-located on the one card over
   gloo on CUDA tensors (NCCL refuses two ranks on one GPU), and a one-rank
   NCCL group; each rank is this script again (``--grid-rank``).  The
   canonical xDeepFM at full width, global batch 4096, 3 steps: dense Adam
   under the ``shard_map`` and ``all_to_all`` lookups (fp32 and bf16 rows on
   the wire), one SGD step, lazy Adam split packed and with the dense
   cotangent, Pro under ``all_to_all`` (2 steps); every rank's gathered
   parameters against the one-process run on the card (the NCCL rank bit
   for bit), replicas bit-equal, the CIN (and CE) kernels launched on every
   rank, step ms per rank (co-located ranks on one card, not a scaling
   figure); ``Scorer(8192)`` on the sharded model against the one-process
   scorer; ``save_checkpoint_sharded(block=False)``, a step during the
   write, the resumed step bit-equal; V1 (``shard_map``), V2, DIEN
   (``all_to_all``) and AutoInt (``shard_map``) at their training phases'
   widths, 2 steps each, their attention, lane and GRU kernels launched on
   every rank as their one-process steps launch them; ``fit`` and
   ``fit_stream`` of xDeepFM under ``all_to_all`` (``grid_fit``), every
   rank's History against the one process's.  ``--sharded-only`` runs the
   device, build and sharded phases alone;
22. a ``{"kernels": [...]}`` line, one entry per hand-written kernel, its
   ``launches_by_path`` with the CLI, lazy, ``dien_dice``, ``bf16``,
   multitask and grid paths (a grid path's launches summed over its ranks);
23. the last line: ``{"ok": true, "device": {...}}``.

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
import contextlib
import copy
import hashlib
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from xdeepfm_tpu_torch import native
from xdeepfm_tpu_torch.basemodel import sum_loss
from xdeepfm_tpu_torch import serialization
from xdeepfm_tpu_torch.cli import xdftrain, xdftrain_attn, xdftrain_pro, xdftrain_v1
from xdeepfm_tpu_torch.embeddings import MixedEmbeddingDims, fused_gather, touched_ids
from xdeepfm_tpu_torch.features import DenseFeat, SparseFeat, VarLenSparseFeat
from xdeepfm_tpu_torch.models import (
    AFM,
    AFN,
    CCPM,
    DCN,
    DIEN,
    DIFM,
    DIN,
    ESMM,
    IFM,
    MLR,
    MMOE,
    NFM,
    ONN,
    PLE,
    PNN,
    WDL,
    AutoInt,
    DCNMix,
    DeepFM,
    FiBiNET,
    SharedBottom,
    xDeepFM,
    xDeepFMAttention,
    xDeepFMAttentionV2,
)
from xdeepfm_tpu_torch.models.dien import DIENModule
from xdeepfm_tpu_torch.optimizers import LAZY_OPTIMIZERS
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
    sa_backward_bf16,
    sa_backward_reference,
    sa_bf16_float64,
    sa_forward,
    sa_forward_bf16,
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
    ce_round_bf16,
    ce_round_bf16_reference,
    ce_rows_backward,
    ce_rows_backward_bf16,
    ce_rows_backward_reference,
    ce_rows_forward,
    ce_rows_forward_bf16,
    ce_rows_forward_reference,
)
from xdeepfm_tpu_torch.ops.cin import set_backward_impl, set_cin_precision
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
    bf16_round,
    cin_rows_backward,
    cin_rows_backward_bf16,
    cin_rows_backward_reference,
    cin_rows_backward_reference_bf16,
    cin_rows_dw,
    cin_rows_dw_reference,
    cin_rows_forward,
    cin_rows_forward_bf16,
    cin_rows_reference,
    cin_rows_reference_bf16,
    cin_rows_round_g_bf16,
)
from xdeepfm_tpu_torch.examples import large_tables, quickstart, sharded_training
from xdeepfm_tpu_torch.examples import serving as serving_example
from xdeepfm_tpu_torch.pro import xDeepFMPro
from xdeepfm_tpu_torch.scripts import bench_attn_ablate, bench_attn_bf16, bench_lazy
from xdeepfm_tpu_torch.scripts.bench_gru import KERNELS as GRU_KERNELS
from xdeepfm_tpu_torch.scripts.bench_gru import device_ms as gru_device_ms
from xdeepfm_tpu_torch.scripts.bench_lane import device_ms
from xdeepfm_tpu_torch.serving import Scorer, load_scorer
from xdeepfm_tpu_torch.weights import flatten_tree, to_jax_checkpoint, unflatten_tree

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
    # the bf16 mode (cin_pallas.set_cin_precision, :332): the same TPU kernels
    # fed bf16 operands (:353-366 forward, :226 and :241 the fused backward)
    "cin_fwd_bf16": ("xdeepfm_tpu_torch/ops/csrc/cin_fwd.cu", "xdeepfm_tpu/ops/cin_pallas.py:60"),
    "cin_bwd_dx_bf16": ("xdeepfm_tpu_torch/ops/csrc/cin_bwd.cu",
                        "xdeepfm_tpu/ops/cin_pallas.py:174"),
    # the fused backward's cast of g to bf16 (_bwd_fused_t), once for both
    # cin_bwd_dx_bf16 and cin_dw
    "cin_round_g_bf16": ("xdeepfm_tpu_torch/ops/csrc/cin_bwd.cu",
                         "xdeepfm_tpu/ops/cin_pallas.py:232"),
    "ce_fwd": ("xdeepfm_tpu_torch/ops/csrc/ce_fwd.cu",
               ["xdeepfm_tpu/ops/ce_pallas.py:138", "xdeepfm_tpu/ops/ce_pallas.py:369"]),
    "ce_bwd": ("xdeepfm_tpu_torch/ops/csrc/ce_bwd.cu",
               ["xdeepfm_tpu/ops/ce_pallas.py:204", "xdeepfm_tpu/ops/ce_pallas.py:423"]),
    # the bf16 mode (ce_pallas.set_precision, its default, :58): the same TPU
    # kernels with every product's operands cast to bf16 in _dot (:128)
    "ce_round_bf16": ("xdeepfm_tpu_torch/ops/csrc/ce_bf16.cu", "xdeepfm_tpu/ops/ce_pallas.py:128"),
    "ce_fwd_bf16": ("xdeepfm_tpu_torch/ops/csrc/ce_bf16.cu",
                    ["xdeepfm_tpu/ops/ce_pallas.py:138", "xdeepfm_tpu/ops/ce_pallas.py:369"]),
    "ce_bwd_bf16": ("xdeepfm_tpu_torch/ops/csrc/ce_bf16.cu",
                    ["xdeepfm_tpu/ops/ce_pallas.py:204", "xdeepfm_tpu/ops/ce_pallas.py:423"]),
    "sa_fwd": ("xdeepfm_tpu_torch/ops/csrc/sa_fwd.cu", "xdeepfm_tpu/ops/attention_pallas.py:204"),
    "sa_bwd": ("xdeepfm_tpu_torch/ops/csrc/sa_bwd.cu", "xdeepfm_tpu/ops/attention_pallas.py:229"),
    # the bf16 mode (attention_pallas.set_precision, :56): the same TPU kernels
    # with every product's operands cast to bf16 in _dot (:70)
    "sa_fwd_bf16": ("xdeepfm_tpu_torch/ops/csrc/sa_bf16.cu",
                    "xdeepfm_tpu/ops/attention_pallas.py:204"),
    "sa_bwd_bf16": ("xdeepfm_tpu_torch/ops/csrc/sa_bf16.cu",
                    "xdeepfm_tpu/ops/attention_pallas.py:229"),
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
    "cin_fwd_bf16": ("xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh",),
    "cin_bwd_dx_bf16": ("xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh",),
    "cin_round_g_bf16": ("xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh",),
    "ce_fwd": ("xdeepfm_tpu_torch/ops/csrc/ce_tc.cuh", "xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh"),
    "ce_bwd": ("xdeepfm_tpu_torch/ops/csrc/ce_tc.cuh", "xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh"),
    **{k: ("xdeepfm_tpu_torch/ops/csrc/ce_tc.cuh", "xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh")
       for k in ("ce_round_bf16", "ce_fwd_bf16", "ce_bwd_bf16")},
    "sa_fwd": ("xdeepfm_tpu_torch/ops/csrc/attn_fwd_tc.cuh",),
    "sa_bwd": ("xdeepfm_tpu_torch/ops/csrc/attn_bwd_tc.cuh",),
    **{k: ("xdeepfm_tpu_torch/ops/csrc/attn_common.cuh", "xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh")
       for k in ("sa_fwd_bf16", "sa_bwd_bf16")},
    "ab_fwd": ("xdeepfm_tpu_torch/ops/csrc/attn_fwd_tc.cuh",
               "xdeepfm_tpu_torch/ops/csrc/attn_block.cuh"),
    "ab_bwd": ("xdeepfm_tpu_torch/ops/csrc/attn_bwd_tc.cuh",),
    "la_fwd": ("xdeepfm_tpu_torch/ops/csrc/la_common.cuh",),
    "la_bwd": ("xdeepfm_tpu_torch/ops/csrc/la_common.cuh",),
    "gru_fwd": ("xdeepfm_tpu_torch/ops/csrc/gru_common.cuh",),
    "gru_bwd": ("xdeepfm_tpu_torch/ops/csrc/gru_common.cuh",
                "xdeepfm_tpu_torch/ops/csrc/tc_tf32.cuh"),
    **{f"ablate_{v}": ("xdeepfm_tpu_torch/ops/csrc/attn_fwd_tc.cuh",)
       for v in ("full", "dots", "soft")},
}
WRAPPERS = {
    "cin_fwd": cin_rows_forward, "cin_bwd_dx": cin_rows_backward, "cin_dw": cin_rows_dw,
    "cin_fwd_bf16": cin_rows_forward_bf16, "cin_bwd_dx_bf16": cin_rows_backward_bf16,
    "cin_round_g_bf16": cin_rows_round_g_bf16,
    "ce_fwd": ce_rows_forward, "ce_bwd": ce_rows_backward,
    "ce_round_bf16": ce_round_bf16, "ce_fwd_bf16": ce_rows_forward_bf16,
    "ce_bwd_bf16": ce_rows_backward_bf16,
    "sa_fwd": sa_forward, "sa_bwd": sa_backward, "sa_fwd_bf16": sa_forward_bf16,
    "sa_bwd_bf16": sa_backward_bf16, "ab_fwd": ab_forward, "ab_bwd": ab_backward,
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
# the bf16 mode's shapes: all but the full-B "stacked" one, whose float64
# [F, B, V] block (8.6 GB) the fp32 phase already takes once
CE_BF16_SHAPES = tuple(s for s in CE_SHAPES if s[0] != "stacked")
# the bf16 sub-rows of PERF.md's table: rows 4-5 (one head) at "single_head",
# rows 6-7 (stacked heads) at the Pro path's shape
CE_BF16_ROWS = {"4 bf16": ("single_head", "fwd"), "5 bf16": ("single_head", "bwd"),
                "6 bf16": (CE_PATH_SHAPE, "fwd"), "7 bf16": (CE_PATH_SHAPE, "bwd")}
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
    model.set_weights(seeded_weights(model) if weights is None else weights)
    return model


def seeded_weights(model):
    """Random weights for ``model``'s tree from SEED, at scale 0.1 so that
    every tower, the CIN included, moves the scores; its BatchNorm running
    statistics as they are."""
    rng = np.random.default_rng(SEED)
    weights = model.get_weights()
    flat = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flatten_tree(weights["params"])}
    return {"params": unflatten_tree(flat), "batch_stats": weights["batch_stats"]}


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
    """The first ``n`` rows on the model's device: labels [n, 1], or [n, T]
    for T tasks."""
    packed = model.schema.pack({k: v[:n] for k, v in x.items()})
    xb = {k: torch.as_tensor(v, device=model.device) for k, v in packed.items()}
    return xb, torch.as_tensor(y[:n, None] if y.ndim == 1 else y[:n], device=model.device)


def step_grads(model, xb, yb, loss="binary_crossentropy"):
    """Gradients of one step's loss (the sum-loss of ``loss``, a name or a
    multitask model's list, + L2 registry + a module's aux loss, as
    ``_train_step``), no update.  A parameter that no term reaches has no
    gradient (the last PLE level's shared gate without L2) and is left
    out."""
    model.module.zero_grad(set_to_none=True)
    out = model.module(xb, training=True)
    mask = torch.ones(yb.shape[0], device=yb.device)
    loss = sum_loss(loss, out["pred"], yb, mask, model.num_tasks)
    (loss + model._regularization_loss() + out.get("aux_loss", 0.0)).backward()
    return {k: p.grad.clone() for k, p in model.module.named_parameters()
            if p.grad is not None}


# A relu input that two routes put on opposite sides of 0 is held only where
# both lie within this share of the layer's largest |input|: fp32 rounding
# of the sums that made them.  At most MAX_HELD_FLIPS such inputs in one
# comparison, out of ~1.6e7 CIN relu inputs a step at batch 4096
RELU_BAND = 1e-5
MAX_HELD_FLIPS = 32
_RELUS = (torch.relu, F.relu, torch.Tensor.relu)
# the modules whose relus follow a kernel: the CIN's layers, InteractingLayer,
# and in DIEN its attention MLP (on the extractor's states) and its DNN (on
# the evolution's last state); DIN's attention MLP follows no kernel
_KERNEL_FED = (CIN, CINAttention, CINAttentionV2, InteractingLayer)


def kernel_fed_sites(model):
    sites = [m for m in model.module.modules() if isinstance(m, _KERNEL_FED)]
    if isinstance(model.module, DIENModule):
        sites += [m for m in model.module.modules() if isinstance(m, LocalActivationUnit)]
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


def relu_step_grads(model, xb, yb, ref=None, loss="binary_crossentropy"):
    """(:func:`step_grads`, the :class:`ReluRecord` of its kernel-fed
    relus, compared with ``ref`` where given)."""
    with ReluRecord(model, ref) as rec:
        grads = step_grads(model, xb, yb, loss)
    return grads, rec


# A gradient far below the others may cancel to rounding noise by
# construction, and its error over its own size is then noise over noise.
# DIEN's attention MLP is such a gradient: the softmax over T cancels
# whatever shift a row's scores share, and at init_std 1e-4 nearly all of
# the MLP's gradient is such a shift.  So DIEN's gradients are each held
# relative to their largest entry or to GRAD_FLOOR of the largest entry of
# all the gradients compared, whichever is larger; every other model's
# relative to their own largest entry alone.  AFM's attention_b is another:
# a few steps from init_std 1e-4 the pair products are far below it, so
# each attention unit's pre-activation has one sign over all pairs and the
# softmax over the pairs cancels b's share of the score, whose gradient is
# then rounding noise (on an H100 both fp32 sides' errors read ~3e8 times
# float64's gradient).
# A DNN bias under a BatchNorm is a third: the batch mean cancels its
# gradient (AFN's DNN, DIEN's under use_bn), which leaves rounding noise on
# every side.
GRAD_FLOOR = {"dien": 1e-3, "afm": 1e-3, "afn": 1e-3, "dien_dice": 1e-3}


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


def sgd_step_vs_cpu(pair, x, y, label, floor=0.0, loss="binary_crossentropy",
                    f64_route=contextlib.nullcontext):
    """One SGD step on 256 rows from the same weights by the card's and the
    CPU's model (``pair``) under ``loss`` (a name, or a multitask model's
    list over the [n, T] labels ``y``), the CPU's kernel-fed relus compared
    with the card's (:class:`ReluRecord`).  Errors by :func:`per_grad_err` with
    ``floor``: the weights after it within GRAD_RTOL; the gradients within
    GRAD_RTOL, or, for a gradient that rounding moves further, as close to a
    float64 copy's gradients as the CPU's own fp32 ones, up to FP32_SLACK,
    and then each weight's change likewise as close to lr times the float64
    gradient as the CPU's change; the BatchNorm running statistics within
    GRAD_RTOL.  The float64 copy runs inside ``f64_route()`` (a context
    manager: a route of its own where a mode's plain version takes only
    fp32).  Returns the errors and the relu flips."""
    small, recs, ref = 256, [], None
    m64 = copy.deepcopy(pair[1])  # the CPU model before its step
    before = {k: p.detach().cpu().clone() for k, p in pair[1].module.named_parameters()}
    for m in pair:
        m.compile("sgd", loss)
        with ReluRecord(m, recs[0] if recs else None) as rec:
            m.fit({k: v[:small] for k, v in x.items()}, y[:small], batch_size=small, epochs=1,
                  verbose=0, shuffle=False)
        recs.append(rec)
    errs = {"relus": recs[1].stats()}
    card, cpu = ({k: p.grad.detach().cpu() for k, p in m.module.named_parameters()
                  if p.grad is not None} for m in pair)
    if card.keys() != cpu.keys():
        raise AssertionError(f"{label}card and CPU gave gradients to different parameters: "
                             f"{sorted(card.keys() ^ cpu.keys())}")
    errs["grad"] = grad_err(card, cpu, floor)
    if errs["grad"] > GRAD_RTOL:
        m64.module = m64.module.double()
        m64.compile("sgd", loss)
        xb, yb = device_batch(m64, x, y, small)
        xb = {k: v.double() if v.is_floating_point() else v for k, v in xb.items()}
        with f64_route():
            ref, held = relu_step_grads(m64, xb, yb.double(), recs[0], loss)
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
    per = per_grad_err(*weights, floor)
    errs["weights"] = max(per.values())
    if errs["weights"] > GRAD_RTOL and ref is not None:
        # the changes, held as the gradients are: as close to the float64
        # step's as the CPU's own
        lr = pair[1].optimizer.param_groups[0]["lr"]
        want = {k: -lr * g for k, g in ref.items()}
        card64, cpu64 = ({k: w[k] - before[k] for k in w} for w in weights)
        card64, cpu64 = per_grad_err(card64, want, floor), per_grad_err(cpu64, want, floor)
        per = {k: card64[k] if card64[k] > max(GRAD_RTOL, FP32_SLACK * cpu64[k]) else 0.0
               for k in want}
        errs["weights_change_vs_float64_worst"] = {k: {"card": card64[k], "cpu": cpu64[k]}
                                                   for k in sorted(want, key=card64.get)[-3:]}
    if max(per.values()) > GRAD_RTOL:
        worst = sorted(per.items(), key=lambda kv: -kv[1])[:3]
        raise AssertionError(f"{label}card and CPU weights after one step differ by "
                             f"{errs['weights']} (worst {worst})")
    stats = [{k: b.detach().cpu() for k, b in m.module.named_buffers()} for m in pair]
    if stats[1]:  # the BatchNorm and Dice running statistics the step updated
        errs["batch_stats"] = grad_err(*stats)
        if errs["batch_stats"] > GRAD_RTOL:
            raise AssertionError(f"{label}card and CPU running statistics after one step "
                                 f"differ by {errs['batch_stats']}")
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
    # the bf16 mode's products (cuBLAS names its kernels by their types)
    record["bf16_kernels"] = sorted({e.name[:80] for e in prof.events()
                                     if e.device_type == torch.autograd.DeviceType.CUDA
                                     and "bf16" in e.name.lower()})
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


def _ce_library(h, W, b, t, nv, bf16=False):
    """One PyTorch call per head: F.linear, then F.cross_entropy with
    reduction="none" (the [B, V] logits materialised), rows past nv
    zeroed.  ``bf16``: F.linear on h and W cast to bf16 (cuBLAS's bf16
    GEMM), the logits taken to fp32 before the bias and the CE."""
    keep = torch.ones(h.shape[0], device=h.device) if nv is None else (
        torch.arange(h.shape[0], device=h.device) < nv).float()

    def logits(f):
        if bf16:
            return F.linear(h.bfloat16(), W[f].bfloat16()).float() + b[f]
        return F.linear(h, W[f], b[f])

    return torch.stack([
        F.cross_entropy(logits(f), t[f], reduction="none") for f in range(W.shape[0])
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

        # the outputs' sha256 (first 16 hex digits), bit-equal variants share it
        sha = hashlib.sha256(b"".join(x.cpu().numpy().tobytes()
                                      for x in (ll, logz, *grads))).hexdigest()[:16]
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
        del grads, again, want_ll, want_logz
        rec = dict(F=F_, B=B, K=K, V=V, padded_columns=pad, num_valid=nv, **times,
                   outputs_sha256=sha,
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


def phase_ce_bf16_kernels(peak):
    """The CE's bf16 mode (``ce.set_precision("bf16")``, the JAX package's
    default) at CE_BF16_SHAPES: ``ce_round_bf16`` (its tiles read back
    equal to the plain rounding), ``ce_fwd_bf16`` and ``ce_bwd_bf16`` on its
    tiles, one launch each, against the plain versions with
    ``precision="bf16"`` within CE_TOL / BWD_RTOL, against float64 of the same
    rounded operands by :func:`_f64_gate`, and bit-equal over two runs.
    Times: each kernel alone, the forward with its rounding (``fwd_ms``, what
    a step runs), the plain versions and the library (``_ce_library`` on
    bf16 h and W, backward by autograd).  Bounds at the bf16 tensor cores'
    peak: the forward's products 2*nv*K*V*F against its nv*V*F exps at the
    exp rate (its floor), the backward's least work three such products
    against one exp pass; the bytes as the fp32 phase counts them
    (``ce_kernel`` lines)."""
    _, peak_flops, peak_bw, _ = peak
    peak_bf16 = next(p for name, p in BF16_PEAKS if name in peak[0])
    exp_rate = peak_flops * EXP_PER_FLOP
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    results = {}
    for label, F_, B, K, V, pad, nv in CE_BF16_SHAPES:
        h, W, b, t, g, nvd = _ce_case(label, F_, B, K, V, pad, nv, gen)
        reset_launches()
        r = ce_round_bf16(h, W, b, nvd)
        ll, logz = ce_rows_forward_bf16(r, t, nvd)
        grads = ce_rows_backward_bf16(g, r, t, logz, nvd)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != expected(ce_round_bf16=1, ce_fwd_bf16=1, ce_bwd_bf16=1):
            raise AssertionError(f"ce bf16 at {label}: launched {launches}")
        for got, want in zip(r.values(), ce_round_bf16_reference(h, W, b, nvd)):
            if not torch.equal(got, want):
                raise AssertionError(f"ce_round_bf16 at {label}: tiles differ from the plain "
                                     "rounding")
        want_ll, want_logz = ce_rows_forward_reference(h, W, b, t, nvd, "bf16")
        torch.testing.assert_close(ll, want_ll, **CE_TOL)
        torch.testing.assert_close(logz, want_logz, **CE_TOL)
        fwd_err = max(float((ll - want_ll).abs().max()), float((logz - want_logz).abs().max()))
        exact = ce_rows_forward_reference(h.double(), W.double(), b.double(), t, nvd, "bf16")
        fwd64 = {out: _f64_gate(f"ce_fwd_bf16 {out} at {label}", got, want, ex)
                 for out, got, want, ex in zip(("ll", "logz"), (ll, logz),
                                                (want_ll, want_logz), exact)}
        del exact, want_ll, want_logz
        torch.cuda.empty_cache()
        again = ce_rows_forward_bf16(ce_round_bf16(h, W, b, nvd), t, nvd)
        if not (torch.equal(ll, again[0]) and torch.equal(logz, again[1])):
            raise AssertionError(f"ce_fwd_bf16 at {label}: two runs differ")
        bwd_err = 0.0
        plain = ce_rows_backward_reference(g, h, W, b, t, logz, nvd, "bf16")
        for got, want in zip(grads, plain):
            torch.testing.assert_close(got, want, rtol=BWD_RTOL,
                                       atol=BWD_RTOL * float(want.abs().max()) + 1e-6)
            bwd_err = max(bwd_err, float((got - want).abs().max()) if got.numel() else 0.0)
        exact = ce_rows_backward_reference(g.double(), h.double(), W.double(), b.double(), t,
                                           logz.double(), nvd, "bf16")
        vs64 = {out: _f64_gate(f"ce_bwd_bf16 {out} at {label}", got, want, ex)
                for out, got, want, ex in zip(("dh", "dW", "db"), grads, plain, exact)}
        del exact, plain
        torch.cuda.empty_cache()
        again = ce_rows_backward_bf16(g, r, t, logz, nvd)
        if not all(torch.equal(a, c) for a, c in zip(grads, again)):
            raise AssertionError(f"ce_bwd_bf16 at {label}: two runs differ")
        del grads, again

        iters = 5 if B * V * F_ > 10**8 else 50
        hl = h.clone().requires_grad_(True)
        Wl = W.clone().requires_grad_(True)
        bl = b.clone().requires_grad_(True)
        lib_out = _ce_library(hl, Wl, bl, t, nvd, bf16=True)
        times = dict(
            round_ms=cuda_ms(lambda: ce_round_bf16(h, W, b, nvd), iters),
            fwd_kernel_ms=cuda_ms(lambda: ce_rows_forward_bf16(r, t, nvd), iters),
            fwd_ms=cuda_ms(lambda: ce_rows_forward(h, W, b, t, nvd, "bf16"), iters),
            bwd_ms=cuda_ms(lambda: ce_rows_backward_bf16(g, r, t, logz, nvd), iters),
            plain_fwd_ms=cuda_ms(
                lambda: ce_rows_forward_reference(h, W, b, t, nvd, "bf16"), iters),
            plain_bwd_ms=cuda_ms(
                lambda: ce_rows_backward_reference(g, h, W, b, t, logz, nvd, "bf16"), iters),
            plain_round_ms=cuda_ms(lambda: ce_round_bf16_reference(h, W, b, nvd), iters),
            library_fwd_ms=cuda_ms(lambda: _ce_library(h, W, b, t, nvd, bf16=True), iters),
            library_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (hl, Wl, bl), g, retain_graph=True), iters),
        )
        del lib_out, hl, Wl, bl
        rows = B if nv is None else nv
        flops = 2 * rows * K * V * F_
        exps = rows * V * F_
        fwd_bytes = 4 * (rows * K + F_ * V * K + F_ * V + 2 * F_ * B) + 8 * F_ * rows
        bwd_bytes = (4 * (rows * K + F_ * V * K + F_ * V + 2 * F_ * rows) + 8 * F_ * rows
                     + 4 * (B * K + F_ * V * K + F_ * V))
        rec = dict(F=F_, B=B, K=K, V=V, padded_columns=pad, num_valid=nv, **times,
                   launches=launches, fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err,
                   fwd_bit_equal=True, bwd_bit_equal=True, round_equal_to_plain=True,
                   fwd_err_vs_float64={k: e[0] for k, e in fwd64.items()},
                   plain_fwd_err_vs_float64={k: e[1] for k, e in fwd64.items()},
                   bwd_err_vs_float64={k: e[0] for k, e in vs64.items()},
                   plain_bwd_err_vs_float64={k: e[1] for k, e in vs64.items()},
                   fwd_exp_floor_ms=exps / exp_rate * 1e3, peak_bf16_flops=peak_bf16,
                   # h's valid rows, W and b read; their bf16 tiles and the
                   # padded bias written
                   round_bound_ms=(4 * (rows * K + F_ * V * K + 2 * F_ * V) + 2 * (
                       rows * K + F_ * V * K)) / peak_bw * 1e3)
        for kind, n_flops, n_bytes, ms in (("fwd", flops, fwd_bytes, times["fwd_ms"]),
                                           ("bwd", 3 * flops, bwd_bytes, times["bwd_ms"])):
            rec[f"{kind}_mma_ms"] = n_flops / peak_bf16 * 1e3
            rec[f"{kind}_bound_ms"] = max(n_flops / peak_bf16, exps / exp_rate,
                                          n_bytes / peak_bw) * 1e3
            rec[f"{kind}_bound_by"] = ("bytes" if n_bytes / peak_bw > max(
                n_flops / peak_bf16, exps / exp_rate) else "operations")
            rec[f"{kind}_gflop"] = n_flops / 1e9
            rec[f"{kind}_bound_share"] = rec[f"{kind}_bound_ms"] / ms if ms > 0 else 0.0
        results[label] = rec
        emit(phase="ce_bf16_kernel", shape=label, **rec)
        del h, W, b, t, g, ll, logz, r
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
    loss = sum_loss("binary_crossentropy", out["pred"], yb, mask)
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


# a Pro train step in the CE's bf16 mode: the fp32 step's CIN launches and one
# launch of each bf16 CE kernel (one bucket of 26 stacked heads)
PRO_CE_BF16_STEP = dict(cin_fwd=2, cin_bwd_dx=2, cin_dw=2, ce_round_bf16=1, ce_fwd_bf16=1,
                        ce_bwd_bf16=1)
# bf16 operands keep 8 significant bits (relative rounding up to 2^-9): each
# logit moves by about that share of |h| |W|, with random signs, and the SFG
# loss averages some 35 000 CE rows, so the two modes' first-step losses (the
# whole and its SFG part, which alone the CE's mode moves) must agree well
# within 1%
PRO_CE_BF16_LOSS_RTOL = 1e-2


def pro_step_loss(model, batch, yb):
    """One step's loss (sum-BCE + L2 registry + SFG aux) and its SFG aux
    part, without a backward."""
    with torch.no_grad():
        out = model.module(batch, training=True)
        mask = torch.ones(yb.shape[0], device=yb.device)
        loss = sum_loss("binary_crossentropy", out["pred"], yb, mask)
        aux = out["aux_loss"]
        return float(loss + model._regularization_loss() + aux), float(aux)


def phase_pro_ce_bf16_training():
    """The canonical xDeepFMPro (bench.py's ``pro`` row) under
    ``ce.set_precision("bf16")``: the first step's loss against the fp32
    mode's from the same weights (SFG dropout off) within
    PRO_CE_BF16_LOSS_RTOL; ``fit`` at batch 4096 with Adam for ZOO_EPOCHS
    epochs of 8 steps (a validation half batch) with PRO_CE_BF16_STEP
    launches a step and no fp32 CE launch, the loss finite and falling; one
    SGD step on the card against the CPU model in the bf16 mode (the plain
    bf16 CE); ms a step in turns with the fp32 mode, and each mode's
    profile: busy ms a step, idle share and device ms by kernel."""
    ce.set_precision("bf16")
    try:
        return _pro_ce_bf16_training()
    finally:
        ce.set_precision("fp32")


def _pro_ce_bf16_training():
    model = pro_model("cuda")
    model.compile("adam", "binary_crossentropy", metrics=["auc"])
    rng = np.random.default_rng(SEED + 3)
    x, y = train_data(rng, TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH + TRAIN_BATCH // 2)
    x, y, val = (  # the last half batch validates
        {k: v[: -TRAIN_BATCH // 2] for k, v in x.items()}, y[: -TRAIN_BATCH // 2],
        ({k: v[-TRAIN_BATCH // 2 :] for k, v in x.items()}, y[-TRAIN_BATCH // 2 :]),
    )
    batch, yb = pro_batch(model, x, y, TRAIN_BATCH)
    dec = model.module.sfg_decoder
    dec.dropout_rate = 0.0
    first_loss, first_launches = {}, {}
    for mode in ("fp32", "bf16"):
        ce.set_precision(mode)
        reset_launches()
        first_loss[mode] = pro_step_loss(model, batch, yb)
        first_launches[mode] = read_launches()
    dec.dropout_rate = model.sfg_dropout
    if first_launches["bf16"] != expected(cin_fwd=2, ce_round_bf16=1, ce_fwd_bf16=1):
        raise AssertionError(f"Pro bf16 CE: the first-step loss launched {first_launches}")
    loss_rel = [abs(b - f) / abs(f) for b, f in zip(first_loss["bf16"], first_loss["fp32"])]
    if not max(loss_rel) <= PRO_CE_BF16_LOSS_RTOL:
        raise AssertionError(f"Pro bf16 CE: first-step (loss, SFG loss) {first_loss} differ by "
                             f"{loss_rel}")

    steps = TRAIN_STEPS_PER_EPOCH * ZOO_EPOCHS
    reset_launches()
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=TRAIN_BATCH, epochs=ZOO_EPOCHS, verbose=1,
                        validation_data=val)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    want = expected(**{k: n * steps for k, n in PRO_CE_BF16_STEP.items()})
    want["cin_fwd"] += 2 * ZOO_EPOCHS  # the validation batches' forwards (no CE there)
    if launches != want:
        raise AssertionError(f"Pro bf16 CE: launches {launches} over {steps} steps, "
                             f"expected {want}")
    logs = history.history
    for k, v in logs.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"Pro bf16 CE: {k} is not finite: {v}")
    if not logs["loss"][0] > logs["loss"][-1]:
        raise AssertionError(f"Pro bf16 CE: the epoch loss did not fall: {logs['loss']}")

    cpu_errs = sgd_step_vs_cpu(
        [pro_model(dev, model.get_weights(), sfg_dropout=0.0) for dev in ("cuda", "cpu")],
        x, y, "Pro bf16 CE: ")

    # ms a step, bf16 CE against fp32 CE from the same weights, in turns
    batches = [device_batch(model, {k: v[i * TRAIN_BATCH:] for k, v in x.items()},
                            y[i * TRAIN_BATCH:], TRAIN_BATCH) for i in range(4)]
    ms = {"bf16": [], "fp32": []}
    for mode in ("bf16", "fp32", "fp32", "bf16"):
        ce.set_precision(mode)
        ms[mode].append(train_steps_ms(model, batches, 10))
    ce.set_precision("fp32")
    fp32_profile = phase_train_profile(model, batches, phase="pro_ce_fp32_train_profile")
    ce.set_precision("bf16")
    reset_launches()
    profile = phase_train_profile(model, batches, phase="pro_ce_bf16_train_profile")
    record = dict(
        batch=TRAIN_BATCH, steps=steps, epochs=ZOO_EPOCHS, fit_seconds=fit_s, launches=launches,
        profiled_launches=read_launches(), history=logs,
        first_step_loss_and_sfg_loss=first_loss, first_step_rel_diff=loss_rel,
        rel_err_vs_cpu_one_sgd_step=cpu_errs,
        ms_per_step=ms, examples_per_s={k: [TRAIN_BATCH / t * 1e3 for t in v]
                                        for k, v in ms.items()},
        device_busy_ms_per_step={"bf16": profile["device_busy_ms_per_call"],
                                 "fp32": fp32_profile["device_busy_ms_per_call"]},
        device_idle_share={"bf16": profile["device_idle_share"],
                           "fp32": fp32_profile["device_idle_share"]},
        top_device_ms_per_step={"bf16": profile["top_device_ms_per_call"],
                                "fp32": fp32_profile["top_device_ms_per_call"]},
    )
    emit(phase="pro_ce_bf16_training", **record)
    return record


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


AUTODIS_EPOCHS = 2  # of TRAIN_STEPS_PER_EPOCH steps


def phase_pro_autodis():
    """xDeepFMPro(use_autodis=True) at the pro row's widths (its dense fields
    through AutoDis's 16 buckets), SFG on: ``fit`` at batch 4096 with Adam
    for AUTODIS_EPOCHS epochs, each step launching the CIN's 2 + 2 + 2 and
    one ``ce_fwd`` and one ``ce_bwd``, the epoch loss falling; one step's
    gradients with the CE kernels against the plain CE (as
    ``phase_pro_training``); one SGD step against the CPU model; the Scorer
    (2 ``cin_fwd`` a batch) and its scores against the CPU model's; busy ms a
    step from the profiler."""
    model = pro_model("cuda", use_autodis=True)
    model.compile("adam", "binary_crossentropy", metrics=["auc"])
    if getattr(model.module, "autodis_encoder", None) is None:
        raise AssertionError("use_autodis=True built no AutoDis encoder")
    # Pro's rows (phase_pro_training's seed): the positive-only decoder's CE
    # works on the positive rows, so its cost follows their share
    rng = np.random.default_rng(SEED + 3)
    x, y = train_data(rng, TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH + TRAIN_BATCH // 2)
    x, y, val = (
        {k: v[: -TRAIN_BATCH // 2] for k, v in x.items()}, y[: -TRAIN_BATCH // 2],
        ({k: v[-TRAIN_BATCH // 2 :] for k, v in x.items()}, y[-TRAIN_BATCH // 2 :]),
    )
    positive_share = float(y.mean())
    reset_launches()
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=TRAIN_BATCH, epochs=AUTODIS_EPOCHS, verbose=1,
                        validation_data=val)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    steps = TRAIN_STEPS_PER_EPOCH * AUTODIS_EPOCHS
    want = expected(cin_fwd=2 * (steps + AUTODIS_EPOCHS), cin_bwd_dx=2 * steps,
                    cin_dw=2 * steps, ce_fwd=steps, ce_bwd=steps)
    if launches != want:
        raise AssertionError(f"Pro AutoDis launches {launches} over {steps} steps, "
                             f"expected {want}")
    logs = history.history
    for k, v in logs.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"Pro AutoDis: {k} is not finite: {v}")
    if not logs["loss"][-1] < logs["loss"][0]:
        raise AssertionError(f"Pro AutoDis: the epoch loss did not fall: {logs['loss']}")

    batch, yb = pro_batch(model, x, y, TRAIN_BATCH)
    dec = model.module.sfg_decoder
    dec.dropout_rate = 0.0
    dec.ce_backend = "torch"
    want_g = pro_step_grads(model, batch, yb)
    dec.ce_backend = None
    reset_launches()
    got_g = pro_step_grads(model, batch, yb)
    step_launches = read_launches()
    if step_launches != expected(cin_fwd=2, cin_bwd_dx=2, cin_dw=2, ce_fwd=1, ce_bwd=1):
        raise AssertionError(f"Pro AutoDis: one step launched {step_launches}")
    err = grad_err(got_g, want_g)
    if err > GRAD_RTOL:
        raise AssertionError(f"Pro AutoDis: CE kernel gradients off by {err}")
    autodis_grads = sorted(k for k in got_g if k.startswith("autodis_encoder."))
    if not autodis_grads or not all(float(got_g[k].abs().max()) > 0 for k in autodis_grads):
        raise AssertionError(f"Pro AutoDis: the encoder takes no gradient: {autodis_grads}")
    unsteady = reproduced("Pro AutoDis: ", pro_step_grads(model, batch, yb),
                          pro_step_grads(model, batch, yb))
    del want_g, got_g
    cpu_errs = sgd_step_vs_cpu(
        [pro_model(dev, model.get_weights(), sfg_dropout=0.0, use_autodis=True)
         for dev in ("cuda", "cpu")], x, y, "Pro AutoDis: ")
    dec.dropout_rate = model.sfg_dropout

    batches = [device_batch(model, {k: v[i * TRAIN_BATCH:] for k, v in x.items()},
                            y[i * TRAIN_BATCH:], TRAIN_BATCH) for i in range(3)]
    ms = train_steps_ms(model, batches, 10)
    scorer = Scorer(model, batch_size=BATCH).warmup()
    reqs = requests(np.random.default_rng(SEED + 1), REQUESTS)
    n_batches = sum(-(-n // BATCH) for n in REQUESTS)
    reset_launches()
    preds, eps, score_ms = score_all(scorer, reqs)
    score_launches = read_launches()
    if score_launches != expected(cin_fwd=2 * n_batches):
        raise AssertionError(f"Pro AutoDis scoring launched {score_launches}")
    for n, p in zip(REQUESTS, preds):
        if p.shape != (n, 1) or not (np.isfinite(p).all() and (p > 0).all() and (p < 1).all()):
            raise AssertionError(f"bad Pro AutoDis scores: shape {p.shape}")
    cpu_model = pro_model("cpu", model.get_weights(), use_autodis=True)
    small = requests(np.random.default_rng(SEED + 2), (64,))[0]
    cpu_err = float(np.abs(model.predict(small, 64) - cpu_model.predict(small, 64)).max())
    if cpu_err > 1e-5:
        raise AssertionError(f"Pro AutoDis: card and CPU scores differ by {cpu_err}")
    record = dict(
        batch=TRAIN_BATCH, steps=steps, epochs=AUTODIS_EPOCHS, fit_seconds=fit_s,
        positive_share=positive_share, autodis_buckets=model.autodis_buckets,
        launches=launches, step_launches=step_launches,
        history=logs, grad_rel_err_vs_plain_ce=err, grads_not_reproduced=unsteady,
        rel_err_vs_cpu_one_sgd_step=cpu_errs, ms_per_step=ms,
        examples_per_s_trained=TRAIN_BATCH / ms * 1e3, scoring_launches=score_launches,
        scoring_examples_per_s=eps, scoring_ms=score_ms, max_abs_diff_vs_cpu=cpu_err)
    emit(phase="pro_autodis", **record)
    return record, model, batches


# ---------------------------------------------------------------------------
# the JAX package's flax msgpack files
# ---------------------------------------------------------------------------

# one table just over flax's chunk size: 28M rows x dim 10 fp32, 1.12 GB
FLAX_BIG_ROWS, FLAX_BIG_DIM = 28_000_000, 10


def phase_flax_io():
    """The JAX package's file format on the card's host: the canonical
    xDeepFM's weights out through ``serialization.save_file`` (the bytes of
    ``flax.serialization.to_bytes``) and back through ``load_weights`` into
    a fresh model, its scores bit-equal; a lazy (split, packed) model after
    two steps out through ``to_jax_checkpoint`` and back through
    ``load_checkpoint``: every weight and row state bit-equal and the next
    step's loss bit-equal; one table of FLAX_BIG_ROWS x FLAX_BIG_DIM fp32
    through flax's chunked form, written and read back with the seconds of
    each (the read a warm one: the file was just written)."""
    d = tempfile.mkdtemp(prefix="xdeepfm-flax-")
    try:
        model = canonical_model("cuda")
        path = os.path.join(d, "xdeepfm.weights")
        serialization.save_file(path, model.get_weights())
        fresh = canonical_model("cuda", seeded=False)
        fresh.load_weights(path)
        req = requests(np.random.default_rng(SEED + 70), (BATCH,))[0]
        scores_equal = bool(np.array_equal(Scorer(model, BATCH).score(req),
                                           Scorer(fresh, BATCH).score(req)))
        if not scores_equal:
            raise AssertionError("flax weights: the reloaded model's scores differ")
        weights_bytes = os.path.getsize(path)

        lazy = dict(embedding_optimizer="lazy", embedding_gradient="split")
        x, y = train_data(np.random.default_rng(SEED + 71), 3 * TRAIN_BATCH)
        batches = [device_batch(model, {k: v[i * TRAIN_BATCH:] for k, v in x.items()},
                                y[i * TRAIN_BATCH:], TRAIN_BATCH) for i in range(3)]
        mask = torch.ones(TRAIN_BATCH, device="cuda")
        grid_compile(model, "adam", lazy)
        for xb, yb in batches[:2]:
            model._train_step(xb, yb, mask, with_metrics=False)
        ckpt = os.path.join(d, "xdeepfm_lazy.ckpt")
        serialization.save_file(ckpt, to_jax_checkpoint(model, epoch=2))
        back = grid_compile(canonical_model("cuda", seeded=False), "adam", lazy)
        epoch = back.load_checkpoint(ckpt)
        model._restart_lazy_steps()  # as load_checkpoint restarts the loaded one's
        same = all(torch.equal(a, b) for a, b in zip(
            model.module.state_dict().values(), back.module.state_dict().values()))
        same_state = all(torch.equal(v, back._lazy_state()[k])
                         for k, v in model._lazy_state().items())
        t_model = float(model._train_step(*batches[2], mask, with_metrics=False)[0])
        t_back = float(back._train_step(*batches[2], mask, with_metrics=False)[0])
        if epoch != 2 or not (same and same_state) or t_model != t_back:
            raise AssertionError(f"flax checkpoint: epoch {epoch}, weights equal {same}, row "
                                 f"states equal {same_state}, next step {t_back} vs {t_model}")
        del model, fresh, back, batches
        torch.cuda.empty_cache()

        big = np.random.default_rng(SEED + 72).standard_normal(
            (FLAX_BIG_ROWS, FLAX_BIG_DIM), dtype=np.float32)
        tree = {"params": {"embedding_dict": {f"table_d{FLAX_BIG_DIM}": big}}}
        path = os.path.join(d, "big.weights")
        t0 = time.perf_counter()
        serialization.save_file(path, tree)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = serialization.restore_file(path)["params"]["embedding_dict"][
            f"table_d{FLAX_BIG_DIM}"]
        read_s = time.perf_counter() - t0
        n_chunks = -(-big.nbytes // serialization.MAX_CHUNK_SIZE)
        if got.shape != big.shape or not np.array_equal(got, big):
            raise AssertionError("flax chunked table: the read table differs")
        record = dict(weights_file_bytes=weights_bytes, scores_bit_equal=scores_equal,
                      lazy_checkpoint_epoch=epoch, lazy_checkpoint_bit_equal=True,
                      next_step_total=t_back, big_table_shape=list(big.shape),
                      big_table_bytes=big.nbytes, big_file_bytes=os.path.getsize(path),
                      chunks=n_chunks, write_seconds=write_s, read_seconds=read_s,
                      read="warm (the file was just written)")
        emit(phase="flax_io", **record)
        return record
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# the attention CIN: TPU kernel rows 8-11
# ---------------------------------------------------------------------------

ATTN_S = CIN_LAYERS[0] // 2 + CIN_LAYERS[1]  # 256 feature maps (split-half)
# (label, G, dh, S, precision): V2's train step launches small_attention twice
# at G = 4096 rows x 2 heads; scoring at batch 8192; a ragged and a tiny
# shape; the train shape under set_precision("bf16"), which runs the bf16
# mode's own kernels (their lines: SA_BF16_SHAPES)
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


# the bf16 mode's small attention (attention.set_precision("bf16")): rows 8-9
# bf16, csrc/sa_bf16.cu.  (label, G, dh, S): V2's train shape (the path), its
# serving shape (G 16384), a ragged and a tiny shape, and S 600, whose pair
# does not fit in a block's shared memory (the kernels then stage each chunk
# from device memory where it is used)
SA_BF16_SHAPES = (
    ("v2_train_bf16", TRAIN_BATCH * 2, DIM // 2, ATTN_S),
    ("v2_serve_bf16", BATCH * 2, DIM // 2, ATTN_S),
    ("ragged_bf16", 7, 3, 37),
    ("tiny_bf16", 2, 1, 5),
    ("long_bf16", 64, DIM // 2, 600),
)
SA_BF16_PATH_SHAPE = "v2_train_bf16"
SA_GATE_PAIRS = 1024  # pairs a slice of the checks against the plain version and float64


def _on_grid(t):
    """t on the grid of multiples of 1/8 in [-2, 2]: bf16 values whose
    products and sums over dh <= 16 are exact in fp32, so that every order
    and every MMA gives the same scores"""
    return (t * 4).round().clamp(-16, 16) / 8


def _sa_bf16_checks(label, outs, grads, q, k, v, g, scale):
    """The bf16 kernels' outputs against the bf16 plain versions (o and the
    gradients within ATTN_RTOL["bf16"] of the largest entry, inv_z within
    1e-4, m within 1e-5) and against the float64 function of the same
    rounded inputs (``sa_bf16_float64``, :func:`_f64_gate`'s rule), by
    slices of SA_GATE_PAIRS pairs.  Returns (largest error against the
    plain forward and backward, {output: (kernel, plain) error against
    float64}, share of rows whose m is bit-equal to the plain version's)."""
    o, m, z = outs
    errs, tops, f64, f64_top, m_equal = {}, {}, {}, {}, 0
    names = ("o", "m", "inv_z", "dq", "dk", "dv")
    for a in range(0, q.shape[0], SA_GATE_PAIRS):
        sl = slice(a, a + SA_GATE_PAIRS)
        qs, ks, vs, gs = q[sl], k[sl], v[sl], g[sl]
        want = list(sa_forward_reference(qs, ks, vs, scale, "bf16"))
        m_equal += int((m[sl] == want[1]).sum())
        want += sa_backward_reference(gs, qs, ks, vs, o[sl], m[sl], z[sl], scale, "bf16")
        exact = dict(zip(("dq", "dk", "dv"),
                         sa_bf16_float64(qs, ks, vs, scale, gs, o[sl], m[sl], z[sl])))
        exact["o"] = sa_bf16_float64(qs, ks, vs, scale)
        for name, got, w in zip(names, (o[sl], m[sl], z[sl], *(t[sl] for t in grads)), want):
            errs[name] = max(errs.get(name, 0.0), float((got - w).abs().max()))
            tops[name] = max(tops.get(name, 0.0), float(w.abs().max()))
            if name in exact:
                e = exact[name]
                k64, p64 = (float((t.double() - e).abs().max()) for t in (got, w))
                old = f64.get(name, (0.0, 0.0))
                f64[name] = (max(old[0], k64), max(old[1], p64))
                f64_top[name] = max(f64_top.get(name, 0.0), float(e.abs().max()))
        del want, exact
    rtol = {"m": 1e-5, "inv_z": 1e-4}
    for name in names:
        tol = rtol.get(name, ATTN_RTOL["bf16"]) * tops[name] + 1e-6
        if not errs[name] <= tol:
            raise AssertionError(f"sa bf16 {name} at {label}: {errs[name]} off the plain "
                                 f"version, above {tol}")
    for name, (err, plain) in f64.items():
        if not (err <= 2 * plain or err <= 1e-6 * f64_top[name]):
            raise AssertionError(f"sa bf16 {name} at {label}: error against float64 {err} "
                                 f"exceeds twice the plain version's {plain}")
    fwd = max(errs[n] for n in ("o", "m", "inv_z"))
    bwd = max(errs[n] for n in ("dq", "dk", "dv"))
    return fwd, bwd, f64, m_equal / m.numel()


def phase_attn_bf16_kernels(peak):
    """``sa_fwd_bf16`` / ``sa_bwd_bf16`` (the bf16 mode's kernels) at
    SA_BF16_SHAPES, one launch each, against the bf16 plain versions and the
    float64 function of the same rounded inputs (:func:`_sa_bf16_checks`),
    bit-equal over two runs, m bit-equal to the plain version's on inputs
    whose scores are exact (:func:`_on_grid`); times by CUDA events and
    device ms by the profiler, beside the plain versions, the fp32 kernels'
    bf16 flag (the path these replaced, ``bench_attn_bf16.flag_forward``)
    and SDPA on bf16 [G, S, dh] views (the library yardstick).  Bounds: the
    exps (G S^2 a launch) at the exp rate, the products (4 G S^2 dh forward,
    10 backward) at the bf16 tensor cores' peak, the bytes as the fp32
    ``attn_kernel`` lines count them.  Also prints the fp32 kernels'
    outputs' sha256 at V2's train shape on ``bench_attn_bf16``'s seeded
    inputs (``fp32_outputs_sha256``), comparable with that script's run in
    another checkout."""
    peak_bf16 = next(p for name, p in BF16_PEAKS if name in peak[0])
    exp_rate = peak[1] * EXP_PER_FLOP
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    results = {}
    for label, G, dh, S in SA_BF16_SHAPES:
        q, k, v, g = (torch.randn(G, dh, S, generator=gen, device="cuda") for _ in range(4))
        scale = dh ** -0.5
        reset_launches()
        outs = sa_forward_bf16(q, k, v, scale)
        grads = sa_backward_bf16(g, q, k, v, *outs, scale)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != expected(sa_fwd_bf16=1, sa_bwd_bf16=1):
            raise AssertionError(f"sa bf16 at {label}: launched {launches}")
        if not all(torch.equal(a, b) for a, b in zip(outs, sa_forward_bf16(q, k, v, scale))):
            raise AssertionError(f"sa_fwd_bf16 at {label}: two runs differ")
        if not all(torch.equal(a, b) for a, b in zip(
                grads, sa_backward_bf16(g, q, k, v, *outs, scale))):
            raise AssertionError(f"sa_bwd_bf16 at {label}: two runs differ")
        fwd_err, bwd_err, f64, m_share = _sa_bf16_checks(label, outs, grads, q, k, v, g, scale)
        del grads
        qg, kg = _on_grid(q), _on_grid(k)
        m_grid = sa_forward_bf16(qg, kg, v, scale)[1]
        if not torch.equal(m_grid, sa_forward_reference(qg, kg, v, scale, "bf16")[1]):
            raise AssertionError(f"sa_fwd_bf16 at {label}: m differs from the plain version's "
                                 "on scores that are exact in fp32")
        del qg, kg, m_grid
        torch.cuda.empty_cache()
        o, m, z = outs
        ql, kl, vl = (t.transpose(1, 2).to(torch.bfloat16).requires_grad_(True)
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        gl = g.transpose(1, 2).to(torch.bfloat16)
        fm, mm, zm = bench_attn_bf16.flag_forward(q, k, v, scale)
        iters = 5 if G > 1000 else 50
        times = dict(
            fwd_ms=cuda_ms(lambda: sa_forward_bf16(q, k, v, scale), iters),
            bwd_ms=cuda_ms(lambda: sa_backward_bf16(g, q, k, v, o, m, z, scale), iters),
            plain_fwd_ms=cuda_ms(lambda: sa_forward_reference(q, k, v, scale, "bf16"), iters),
            plain_bwd_ms=cuda_ms(
                lambda: sa_backward_reference(g, q, k, v, o, m, z, scale, "bf16"), iters),
            flag_fwd_ms=cuda_ms(lambda: bench_attn_bf16.flag_forward(q, k, v, scale), iters),
            flag_bwd_ms=cuda_ms(
                lambda: bench_attn_bf16.flag_backward(g, q, k, v, fm, mm, zm, scale), iters),
            library_fwd_ms=cuda_ms(
                lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale), iters),
            library_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), gl, retain_graph=True), iters),
            fwd_device_ms=device_ms(lambda: sa_forward_bf16(q, k, v, scale),
                                    "sa_fwd_bf16_kernel"),
            bwd_device_ms=device_ms(lambda: sa_backward_bf16(g, q, k, v, o, m, z, scale),
                                    "sa_bwd_bf16_kernel"),
            flag_fwd_device_ms=device_ms(lambda: bench_attn_bf16.flag_forward(q, k, v, scale),
                                         "sa_fwd_kernel"),
            flag_bwd_device_ms=device_ms(
                lambda: bench_attn_bf16.flag_backward(g, q, k, v, fm, mm, zm, scale),
                "sa_bwd_kernel"),
        )
        del lib_out, ql, kl, vl, fm, mm, zm
        rec = dict(G=G, dh=dh, S=S, launches=launches, **times, fwd_max_abs_err=fwd_err,
                   bwd_max_abs_err=bwd_err, fwd_bit_equal=True, bwd_bit_equal=True,
                   m_bit_equal_on_exact_scores=True, m_bit_equal_share=m_share,
                   err_vs_float64={n: e[0] for n, e in f64.items()},
                   plain_err_vs_float64={n: e[1] for n, e in f64.items()},
                   gexp=G * S * S / 1e9, peak_bf16_flops=peak_bf16)
        n = G * dh * S
        exps = G * S * S
        for kind, flops, nbytes in (("fwd", 4 * G * S * S * dh, 4 * (4 * n + 2 * G * S)),
                                    ("bwd", 10 * G * S * S * dh, 4 * (8 * n + 2 * G * S))):
            rec[f"{kind}_mma_ms"] = flops / peak_bf16 * 1e3
            rec[f"{kind}_exp_floor_ms"] = exps / exp_rate * 1e3
            rec[f"{kind}_bound_ms"] = max(flops / peak_bf16, exps / exp_rate,
                                          nbytes / peak[2]) * 1e3
            rec[f"{kind}_bound_by"] = ("bytes" if nbytes / peak[2] > max(
                flops / peak_bf16, exps / exp_rate) else "operations")
            rec[f"{kind}_bound_share"] = rec[f"{kind}_bound_ms"] / rec[f"{kind}_ms"]
        results[label] = rec
        emit(phase="attn_bf16_kernel", shape=label, **rec)
        del q, k, v, g, o, m, z, outs
        torch.cuda.empty_cache()
    G, dh, S = bench_attn_bf16.SHAPES["v2"]
    q, k, v, g = bench_attn_bf16.inputs(G, dh, S)
    digest = bench_attn_bf16.fp32_outputs_sha256(q, k, v, g, dh ** -0.5)
    emit(phase="attn_fp32_outputs", G=G, dh=dh, S=S, fp32_outputs_sha256=digest)
    del q, k, v, g
    torch.cuda.empty_cache()
    return results


# a V2 train step in the attention's bf16 mode: the CIN's launches and V2's
# two attention layers' (forward and backward); a forward-only batch
V2_BF16_STEP = dict(cin_fwd=2, cin_bwd_dx=2, cin_dw=2, sa_fwd_bf16=2, sa_bwd_bf16=2)
V2_BF16_EVAL = dict(cin_fwd=2, sa_fwd_bf16=2)
# the first step's loss with the kernels against the bf16 plain versions on
# the card, from the same weights and batch: the two round the same operands
# to bf16, and an e or ds that lands on the other side of a rounding boundary
# moves one term of a sum over 256 by 2^-8 of itself, so the mean BCE over
# 4096 rows moves by far less than this
V2_BF16_LOSS_RTOL = 1e-4


def step_loss(model, xb, yb):
    """One step's loss (sum-BCE + L2 registry + aux), without a backward."""
    with torch.no_grad():
        out = model.module(xb, training=True)
        mask = torch.ones(yb.shape[0], device=yb.device)
        loss = sum_loss("binary_crossentropy", out["pred"], yb, mask)
        return float(loss + model._regularization_loss() + out.get("aux_loss", 0.0))


@contextlib.contextmanager
def xla_attention():
    """The MHSA on its plain einsum route (``set_mhsa_backend("xla")``),
    which takes float64: the float64 reference of the bf16 mode's SGD step,
    whose attention is then the exact function of the unrounded operands
    (the card's and the CPU's bf16 roundings alike count as their error)."""
    attention.set_mhsa_backend("xla")
    try:
        yield
    finally:
        attention.set_mhsa_backend("auto")


def phase_v2_attn_bf16_training():
    """The canonical xDeepFMAttentionV2 (bench.py's ``attn2`` row) under
    ``attention.set_precision("bf16")``: the first step's loss with the
    kernels against the bf16 plain versions on the card within
    V2_BF16_LOSS_RTOL; ``fit`` at batch 4096 with Adam for ZOO_EPOCHS epochs
    of 8 steps (a validation half batch) with V2_BF16_STEP launches a step
    and no fp32 ``sa_*`` launch, the loss finite and falling; one SGD step on
    the card against the CPU model in the bf16 mode; ``Scorer(8192)`` with 2
    ``sa_fwd_bf16`` (G 16384) + 2 ``cin_fwd`` a batch, the scores within
    BF16_SCORE_TOL of the CPU model's; ms a step in turns with the fp32
    mode, and each mode's profile: busy ms a step, idle share and device ms
    by kernel.  The global random state is restored after it, so that the
    phases after it draw what they drew before it was added."""
    attention.set_precision("bf16")
    try:
        with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
            return _v2_attn_bf16_training()
    finally:
        attention.set_precision("fp32")


def _v2_attn_bf16_training():
    model = canonical_model("cuda", seeded=False, version="v2")
    model.compile("adam", "binary_crossentropy", metrics=["auc"])
    rng = np.random.default_rng(SEED + 3)
    x, y = train_data(rng, TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH + TRAIN_BATCH // 2, "v2")
    x, y, val = (  # the last half batch validates
        {k: v[: -TRAIN_BATCH // 2] for k, v in x.items()}, y[: -TRAIN_BATCH // 2],
        ({k: v[-TRAIN_BATCH // 2 :] for k, v in x.items()}, y[-TRAIN_BATCH // 2 :]),
    )
    xb, yb = device_batch(model, x, y, TRAIN_BATCH)
    first_loss, first_launches = {}, {}
    for route, backend in (("kernel", None), ("plain", "torch")):
        set_kernel_backend(model, backend)
        reset_launches()
        first_loss[route] = step_loss(model, xb, yb)
        first_launches[route] = read_launches()
    set_kernel_backend(model, None)
    if first_launches != {"kernel": expected(**V2_BF16_EVAL), "plain": expected()}:
        raise AssertionError(f"V2 bf16 attention: the first-step losses launched "
                             f"{first_launches}")
    loss_rel = abs(first_loss["kernel"] - first_loss["plain"]) / abs(first_loss["plain"])
    if not loss_rel <= V2_BF16_LOSS_RTOL:
        raise AssertionError(f"V2 bf16 attention: first-step losses {first_loss} differ by "
                             f"{loss_rel}")

    steps = TRAIN_STEPS_PER_EPOCH * ZOO_EPOCHS
    reset_launches()
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=TRAIN_BATCH, epochs=ZOO_EPOCHS, verbose=1,
                        validation_data=val)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    want = expected(**{k: n * steps + V2_BF16_EVAL.get(k, 0) * ZOO_EPOCHS
                       for k, n in V2_BF16_STEP.items()})
    if launches != want:
        raise AssertionError(f"V2 bf16 attention: launches {launches} over {steps} steps, "
                             f"expected {want}")
    logs = history.history
    for k, v in logs.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"V2 bf16 attention: {k} is not finite: {v}")
    if not logs["loss"][0] > logs["loss"][-1]:
        raise AssertionError(f"V2 bf16 attention: the epoch loss did not fall: {logs['loss']}")

    cpu_errs = sgd_step_vs_cpu(
        [canonical_model(dev, model.get_weights(), version="v2") for dev in ("cuda", "cpu")],
        x, y, "V2 bf16 attention: ", f64_route=xla_attention)

    # scoring: 2 sa_fwd_bf16 at G 16384 and 2 cin_fwd a batch
    scorer = Scorer(model, batch_size=BATCH).warmup()
    reqs = requests(np.random.default_rng(SEED + 1), REQUESTS, "v2")
    n_batches = sum(-(-n // BATCH) for n in REQUESTS)
    reset_launches()
    preds, eps, score_ms = score_all(scorer, reqs)
    scoring_launches = read_launches()
    if scoring_launches != expected(**{k: n_batches * c for k, c in V2_BF16_EVAL.items()}):
        raise AssertionError(f"V2 bf16 attention: scoring launched {scoring_launches} for "
                             f"{n_batches} batches")
    for n, p in zip(REQUESTS, preds):
        if p.shape != (n, 1) or not (np.isfinite(p).all() and (p > 0).all() and (p < 1).all()):
            raise AssertionError(f"V2 bf16 attention: bad scores, shape {p.shape}")
    cpu_model = canonical_model("cpu", model.get_weights(), version="v2")
    small = requests(np.random.default_rng(SEED + 2), (64,), "v2")[0]
    score_err = float(np.abs(model.predict(small, 64) - cpu_model.predict(small, 64)).max())
    if score_err > BF16_SCORE_TOL:
        raise AssertionError(f"V2 bf16 attention: card and CPU scores differ by {score_err}")
    del scorer, cpu_model

    # ms a step, the bf16 mode against the fp32 mode from the same weights, in turns
    batches = [device_batch(model, {k: v[i * TRAIN_BATCH:] for k, v in x.items()},
                            y[i * TRAIN_BATCH:], TRAIN_BATCH) for i in range(4)]
    ms = {"bf16": [], "fp32": []}
    for mode in ("bf16", "fp32", "fp32", "bf16"):
        attention.set_precision(mode)
        ms[mode].append(train_steps_ms(model, batches, 10))
    attention.set_precision("fp32")
    fp32_profile = phase_train_profile(model, batches, phase="attn_v2_fp32_train_profile")
    attention.set_precision("bf16")
    profile = phase_train_profile(model, batches, phase="attn_v2_bf16_train_profile")
    record = dict(
        batch=TRAIN_BATCH, steps=steps, epochs=ZOO_EPOCHS, fit_seconds=fit_s, launches=launches,
        history=logs, first_step_loss=first_loss, first_step_rel_diff=loss_rel,
        rel_err_vs_cpu_one_sgd_step=cpu_errs, scoring_launches=scoring_launches,
        scoring_examples_per_s=eps, scoring_ms=score_ms, max_abs_score_diff_vs_cpu=score_err,
        ms_per_step=ms, examples_per_s={k: [TRAIN_BATCH / t * 1e3 for t in v]
                                        for k, v in ms.items()},
        device_busy_ms_per_step={"bf16": profile["device_busy_ms_per_call"],
                                 "fp32": fp32_profile["device_busy_ms_per_call"]},
        device_idle_share={"bf16": profile["device_idle_share"],
                           "fp32": fp32_profile["device_idle_share"]},
        top_device_ms_per_step={"bf16": profile["top_device_ms_per_call"],
                                "fp32": fp32_profile["top_device_ms_per_call"]},
    )
    emit(phase="v2_attn_bf16_training", **record)
    return record


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

# (label, B, T, H, shortest length, longest length): DIEN's train step runs
# the extractor's gru and the augru once each at B 4096, T 50, H 10 with
# lengths uniform in 1..50; scoring at B 8192; a ragged batch (B no multiple
# of the 3 samples a warp holds at H 10) and a tiny one with length-0 rows;
# H 16, the kernels' gate; lengths 1..8 of 50, so every warp stops well
# before T; H 11 (2 samples a warp); T 130, the staging ring (2 chunks of 8
# steps) walked round many times
GRU_SHAPES = (
    ("dien_train", TRAIN_BATCH, DIEN_MAXLEN, DIM, 1, DIEN_MAXLEN),
    ("dien_serve", BATCH, DIEN_MAXLEN, DIM, 1, DIEN_MAXLEN),
    ("ragged", 1001, 37, DIM, 0, 37),
    ("tiny", 5, 3, 2, 0, 3),
    ("h16", TRAIN_BATCH, DIEN_MAXLEN, 16, 1, DIEN_MAXLEN),
    ("short", TRAIN_BATCH, DIEN_MAXLEN, DIM, 1, 8),
    ("h11", TRAIN_BATCH, DIEN_MAXLEN, 11, 1, DIEN_MAXLEN),
    ("long", 512, 130, DIM, 0, 130),
)
GRU_PATH_SHAPE = "dien_train"
# fp32 recurrences over up to 50 steps, the plain version's gate products in
# cuBLAS's order: outs within 1e-5 of their largest entry; the gradients
# (dW and db sum B * T terms) within BWD_RTOL of theirs
GRU_RTOL = 1e-5


def _gru_case(cell, B, T, H, shortest, longest, gen):
    """Fresh operands of one GRU-scan shape on the card."""
    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    att = None if cell == "gru" else torch.rand(B, T, generator=gen, device="cuda")
    lengths = torch.randint(shortest, longest + 1, (B,), generator=gen, device="cuda",
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
    recompute, dW and dh products (18 H^2 + 30 H).  At every shape outs and
    each gradient go through the float64 gate (:func:`_f64_gate`, the
    backward on the kernel's outs); each kernel's time a launch comes from
    CUDA events (``fwd_ms``) and from the profiler's kernel durations
    (``fwd_device_ms``; the backward's two kernels summed)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    results = {}
    for cell in ("gru", "agru", "augru"):
        for label, B, T, H, shortest, longest in GRU_SHAPES:
            gi, w, b, att, lengths, h0, g = _gru_case(cell, B, T, H, shortest, longest, gen)
            args = (cell, gi, w, b, att, lengths, h0)
            outs = gru_forward(*args)
            grads = gru_backward(cell, g, *args[1:], outs)
            torch.cuda.synchronize()
            want_outs = gru_forward_reference(*args)
            want = gru_backward_reference(cell, g, *args[1:], outs)
            fwd_err = _checked(outs, want_outs, GRU_RTOL)
            bwd_err = max(_checked(a, e, BWD_RTOL) for a, e in zip(grads, want))
            if not all(torch.equal(a, c) for a, c in zip(grads, gru_backward(cell, g, *args[1:],
                                                                              outs))):
                raise AssertionError(f"gru_bwd {cell} at {label}: two runs differ")
            g64, gi64, w64, b64, att64, h064, outs64 = (
                None if t is None else t.double() for t in (g, gi, w, b, att, h0, outs))
            fwd_gate = _f64_gate(f"gru_fwd {cell} outs at {label}", outs, want_outs,
                                 gru_forward_reference(cell, gi64, w64, b64, att64, lengths, h064))
            bwd_gate = {name: _f64_gate(f"gru_bwd {cell} {name} at {label}", a, e, x)
                        for name, a, e, x in zip(
                            ("dgi", "dw", "db", "datt", "dh0"), grads, want,
                            gru_backward_reference(cell, g64, gi64, w64, b64, att64, lengths,
                                                   h064, outs64))}
            del grads, want_outs, want, g64, gi64, w64, b64, att64, h064, outs64
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
            times.update(
                fwd_device_ms=gru_device_ms(lambda: gru_forward(*args), GRU_KERNELS["gru_fwd"]),
                bwd_device_ms=gru_device_ms(lambda: gru_backward(cell, g, *args[1:], outs),
                                            GRU_KERNELS["gru_bwd"]))
            nv = int(lengths.sum())
            att_in = 0 if cell == "gru" else 1
            small = B + B * H + 3 * H * H + 3 * H  # lengths, h0 (or dh0), w and b
            rec = dict(cell=cell, B=B, T=T, H=H, longest=longest, valid_steps=nv, **times,
                       fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err, bwd_bit_equal=True,
                       fwd_err_vs_float64=fwd_gate[0], fwd_plain_err_vs_float64=fwd_gate[1],
                       bwd_err_vs_float64={k_: e[0] for k_, e in bwd_gate.items()},
                       bwd_plain_err_vs_float64={k_: e[1] for k_, e in bwd_gate.items()},
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
                rec[f"{kind}_device_share_of_bound"] = (
                    None if rec[f"{kind}_device_ms"] is None  # not measured
                    else rec[f"{kind}_bound_ms"] / rec[f"{kind}_device_ms"])
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
    # the lazy optimizer (split gradient, packed layout: "auto" for both)
    ("cli_lazy", xdftrain, ["--mode", "eval", "--epochs", "2", "--embedding_optimizer", "lazy"]),
    # xdftrain_v1 (its Adagrad default; its eval mode's in-file split runs
    # on pandas only, so final with --test_path), V2, Pro with AutoDis
    ("cli_v1", xdftrain_v1, ["--mode", "final", "--epochs", "1", "--test_path", "{test}"]),
    # V2 at bench.py's attn2 depth: 2 attention layers, small_attention's
    # kernels (one layer would take the fused block, as V1)
    ("cli_attn_v2", xdftrain_attn, ["--mode", "eval", "--epochs", "1", "--model_version", "v2",
                                    "--num_attn_layers", "2"]),
    ("cli_pro_autodis", xdftrain_pro, ["--mode", "eval", "--epochs", "1", "--use_sfg",
                                       "--use_autodis"]),
)
# kernel launches a train step and a predicted batch, by path
_XDEEPFM_STEP = dict(cin_fwd=2, cin_bwd_dx=2, cin_dw=2)
_PRO_STEP = dict(cin_fwd=2, cin_bwd_dx=2, cin_dw=2, ce_fwd=1, ce_bwd=1)
CLI_STEP = {"cli_eval": _XDEEPFM_STEP, "cli_final": _XDEEPFM_STEP,
            "cli_streaming": _XDEEPFM_STEP, "cli_lazy": _XDEEPFM_STEP, "cli_v1": _XDEEPFM_STEP,
            "cli_pro": _PRO_STEP, "cli_pro_autodis": _PRO_STEP,
            "cli_attn_v1": ATTN_STEP["v1"], "cli_attn_v2": ATTN_STEP["v2"]}
CLI_EVAL = {path: dict(cin_fwd=2) for path in CLI_STEP}
CLI_EVAL.update(cli_attn_v1=ATTN_EVAL["v1"], cli_attn_v2=ATTN_EVAL["v2"])
CLI_STEM = {xdftrain: "xdeepfm", xdftrain_v1: "xdeepfm_v1", xdftrain_pro: "xdeepfm_pro"}


def cli_corpus(d, train_rows=CLI_TRAIN_ROWS, test_rows=CLI_TEST_ROWS):
    """A seeded Criteo-like corpus in ``d``: ``train.txt`` (``train_rows``:
    label, 13 integer-like dense fields with 10% empty, 26 categories of 8
    hex digits drawn from 10 000 values a field with 2% empty;
    tab-separated, no header), ``eval.txt`` (``test_rows`` more labelled
    rows) and ``test.txt`` (the same rows without the label: the 39-column
    test format).  Labels come from a logistic teacher over per-value
    effects and the dense fields."""
    rng = np.random.default_rng(SEED + 30)
    n = train_rows + test_rows
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
        f.writelines(f"{labels[r]}\t{rows[r]}\n" for r in range(train_rows))
    with open(paths["eval"], "w") as f:
        f.writelines(f"{labels[r]}\t{rows[r]}\n" for r in range(train_rows, n))
    with open(paths["test"], "w") as f:
        f.writelines(f"{rows[r]}\n" for r in range(train_rows, n))
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


def _cli_launches(path, n_train, n_eval, n_test, epochs):
    """The kernel launches a CLI run makes: its train steps, and its
    predicted batches (validation each epoch at the train batch, the eval
    set again at 8192 in eval mode, the test file at 8192)."""
    steps = epochs * -(-n_train // TRAIN_BATCH)
    batches = epochs * -(-n_eval // TRAIN_BATCH) + -(-n_eval // BATCH) + -(-n_test // BATCH)
    return expected(**{k: steps * CLI_STEP[path].get(k, 0) + batches * CLI_EVAL[path].get(k, 0)
                       for k in WRAPPERS}), steps


def phase_cli():
    """The port's training CLIs in-process over a Criteo-like corpus at the
    canonical width (26 categories of ~10 000 values, 13 dense, embedding
    dim 10, the CLIs' default models), all through the native parser on the
    card at batch 4096: xdftrain eval (2 epochs, a 10% validation split),
    final (with --test_path), --streaming (fit_stream, with --eval_path),
    xdftrain_pro --use_sfg, xdftrain_attn --model_version v1, lazy
    (2 epochs), xdftrain_v1 final (Adagrad, with --test_path),
    xdftrain_attn --model_version v2 --num_attn_layers 2 and xdftrain_pro
    --use_sfg --use_autodis (1 epoch each).  Each run's counts are set to
    0 just before it and read just after; every artifact must exist,
    preprocess.pkl must say native, no
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
            want, steps = _cli_launches(path, n_train, info.get("eval_samples", 0), n_test,
                                        args.epochs)
            if counts != want:
                raise AssertionError(f"{path}: launches {counts} over {steps} steps, "
                                     f"expected {want}")
            name = log.get("model_config", {}).get("model_version")
            stem = CLI_STEM.get(module, f"xdeepfm_attn_{name}")
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


# ---------------------------------------------------------------------------
# the FM family (ROADMAP item 12a).  No TPU kernel is on its path (the JAX
# models import nothing of xdeepfm_tpu/ops/ and their gather is XLA), so it is
# PyTorch ops; the phase checks that it trains and scores at full width, agrees
# with the CPU and launches none of the hand-written kernels.
# ---------------------------------------------------------------------------

# as scripts/bench_zoo.py:38-48 builds them: each constructor's defaults on
# the canonical columns (DeepFM DNN (256, 128), WDL (256, 128), NFM (128, 128),
# AFM over the 26 sparse fields (325 pairs, attention factor 8), IFM (256,
# 128), DCN vector with 2 cross layers over d = 273, DCN-Mix low rank 32 and
# 4 experts)
ZOO = {
    "deepfm": lambda cols, device: DeepFM(cols, cols, device=device),
    "wdl": lambda cols, device: WDL(cols, cols, device=device),
    "nfm": lambda cols, device: NFM(cols, cols, device=device),
    "afm": lambda cols, device: AFM(cols, [f for f in cols if isinstance(f, SparseFeat)],
                                    use_attention=True, device=device),
    "ifm": lambda cols, device: IFM(cols, cols, device=device),
    "dcn": lambda cols, device: DCN(cols, cols, device=device),
    "dcnmix": lambda cols, device: DCNMix(cols, cols, device=device),
    # ROADMAP item 12b (BatchNorm and Dice): AFN as scripts/bench_zoo.py:43
    # builds it (LTL 256, a BatchNorm DNN (256, 128)); DIN as :133-138 (DNN
    # (256, 128), attention MLP (64, 16) with Dice) on DIEN's columns less
    # the negatives (din_columns) and DIEN's rows
    "afn": lambda cols, device: AFN(cols, cols, device=device),
    "din": lambda cols, device: DIN(cols, ["item"], device=device),
    # ROADMAP item 12c, the rest of the zoo, as scripts/bench_zoo.py:47-53
    # builds it (each constructor's defaults): FiBiNET's interaction bilinear
    # over 325 pairs, a DNN (128, 128) over 6513 inputs; PNN's inner products,
    # DNN (128, 128); CCPM over the 26 sparse fields, widths (6, 5), filters
    # (4, 4), fields 26 -> 13 -> 3, DNN (256,); MLR's 4 regions, one
    # [260 000, 4] table; ONN's 50 pair tables, 2 x 325 x 10 x 10 000 =
    # 65.0 M parameters
    "fibinet": lambda cols, device: FiBiNET(cols, cols, device=device),
    "pnn": lambda cols, device: PNN(cols, device=device),
    "ccpm": lambda cols, device: CCPM(cols, [f for f in cols if isinstance(f, SparseFeat)],
                                      device=device),
    "mlr": lambda cols, device: MLR(cols, device=device),
    "onn": lambda cols, device: ONN(cols, cols, device=device),
    # ROADMAP item 15, the multitask family, as scripts/bench_zoo.py:146-150
    # builds it (each constructor's defaults, two binary tasks): SharedBottom's
    # bottom DNN (256, 128) over 273 inputs and towers (64,); ESMM's CTR and
    # CVR towers (256, 128) and the one shared prediction layer; MMOE's 3
    # experts (256, 128), gates (64,), towers (64,); PLE's 2 levels of 1
    # specific expert a task and 1 shared (256, 128), gates (64,), towers (64,)
    "sharedbottom": lambda cols, device: SharedBottom(cols, device=device),
    "esmm": lambda cols, device: ESMM(cols, device=device),
    "mmoe": lambda cols, device: MMOE(cols, device=device),
    "ple": lambda cols, device: PLE(cols, device=device),
}
# the multitask models train under a loss list, one BCE a task, on two
# nested labels a row (mt_labels)
ZOO_MULTITASK = ("sharedbottom", "esmm", "mmoe", "ple")
MT_LOSS = ["binary_crossentropy", "binary_crossentropy"]
# a converted row is a clicked row converted with this probability
MT_CVR = 0.3
# the paths of item 12c that the constructors' defaults miss, each one SGD
# step against the CPU: PNN's outer products with the "mat" kernel (a raw
# parameter named ``kernel``, carried untransposed), FiBiNET's "each"
# bilinear, MLR with bias columns (C0-C3 and I0)
ZOO_VARIANTS = {
    "pnn_outer_mat": lambda cols, device: PNN(cols, use_outter=True, kernel_type="mat",
                                              device=device),
    "fibinet_each": lambda cols, device: FiBiNET(cols, cols, bilinear_type="each",
                                                 device=device),
    "mlr_bias": lambda cols, device: MLR(cols, bias_feature_columns=cols[:4] + [cols[N_SPARSE]],
                                         device=device),
}
# the multitask paths that the defaults miss, each one SGD step against the
# CPU under its loss list: SharedBottom without towers on a binary and a
# regression task, MMOE without gate DNNs (its gates read the 273 inputs),
# PLE with 2 specific experts and 1 shared (the JAX tree's one shared expert
# a level) and the L2 registry that counts its gate finals twice
MT_VARIANTS = {
    "sharedbottom_regression": (
        lambda cols, device: SharedBottom(cols, tower_dnn_hidden_units=(),
                                          task_types=("binary", "regression"), device=device),
        ["binary_crossentropy", "mse"]),
    "mmoe_no_gate_dnn": (lambda cols, device: MMOE(cols, gate_dnn_hidden_units=(),
                                                   device=device), MT_LOSS),
    "ple_2_specific_1_shared_l2": (
        lambda cols, device: PLE(cols, specific_expert_num=2, shared_expert_num=1,
                                 l2_reg_dnn=1e-3, device=device), MT_LOSS),
}
MT_LAZY_STEPS = 3  # MMOE's lazy split packed steps, each against the CPU model
# item 12c's models, whose two identical steps must give bit-equal gradients
ZOO_12C = ("fibinet", "pnn", "ccpm", "mlr", "onn")
ZOO_EPOCHS = 2  # of TRAIN_STEPS_PER_EPOCH steps: the epoch loss must fall once
# the mixed-dim input path: the canonical columns with the last 13 sparse
# fields (C13-C25) at dim 4
ZOO_MIXED_DIM = 4


def din_columns():
    return [f for f in dien_columns() if f.name != "neg_hist_item"]


def zoo_version(name):
    """The rows a zoo model reads: DIN DIEN's (``dien_rows``), the rest the
    canonical columns'."""
    return "dien" if name == "din" else "xdeepfm"


def zoo_loss(name):
    """A zoo model's loss: a list of one BCE a task for the multitask models."""
    return MT_LOSS if name in ZOO_MULTITASK else "binary_crossentropy"


def mt_labels(rng, click):
    """[n, 2] labels of the multitask models: the click of ``train_data``'s
    teacher and the CTCVR, a click converted with probability MT_CVR, so that
    ESMM's product of the two towers has a target."""
    return np.stack([click, click * (rng.uniform(size=len(click)) < MT_CVR)],
                    1).astype(np.float32)


def zoo_data(rng, n, name):
    """``train_data``'s rows for zoo model ``name``, with [n, 2] nested
    labels for a multitask model."""
    x, y = train_data(rng, n, zoo_version(name))
    return x, (mt_labels(rng, y) if name in ZOO_MULTITASK else y)


def zoo_model(name, device, weights=None, cols=None):
    if cols is None:
        cols = din_columns() if name == "din" else canonical_columns()
    model = ZOO[name](cols, device)
    if weights is not None:
        model.set_weights(weights)
    return model


def phase_zoo_training(name):
    """Zoo model ``name`` (no kernel of its own) at full width: ``fit`` at
    batch 4096, Adam, under :func:`zoo_loss` (a multitask model's list on
    :func:`mt_labels`),
    ZOO_EPOCHS epochs of 8 steps with the validation half batch, every
    logged value finite and the epoch loss falling; no hand-written kernel
    launched; one SGD step on the card against the CPU model (weights and
    BatchNorm running statistics); examples/s trained (CUDA events); the
    peak memory of the fit."""
    model = zoo_model(name, "cuda")
    model.compile("adam", zoo_loss(name), metrics=["auc"])
    rng = np.random.default_rng(SEED + 3)
    x, y = zoo_data(rng, TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH + TRAIN_BATCH // 2, name)
    x, y, val = (  # the last half batch validates
        {k: v[: -TRAIN_BATCH // 2] for k, v in x.items()}, y[: -TRAIN_BATCH // 2],
        ({k: v[-TRAIN_BATCH // 2 :] for k, v in x.items()}, y[-TRAIN_BATCH // 2 :]),
    )
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=TRAIN_BATCH, epochs=ZOO_EPOCHS, verbose=0,
                        validation_data=val)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if launches != expected():
        raise AssertionError(f"zoo {name}: hand-written kernels launched: {launches}")
    logs = history.history
    for k, v in logs.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"zoo {name}: {k} is not finite: {v}")
    if not logs["loss"][0] > logs["loss"][-1]:
        raise AssertionError(f"zoo {name}: the epoch loss did not fall: {logs['loss']}")
    cpu_errs = sgd_step_vs_cpu(
        [zoo_model(name, dev, model.get_weights()) for dev in ("cuda", "cpu")], x, y,
        f"zoo {name}: ", GRAD_FLOOR.get(name, 0.0), zoo_loss(name))
    trained = model.get_weights()
    batches = [device_batch(model, {k: v[i * TRAIN_BATCH:] for k, v in x.items()},
                            y[i * TRAIN_BATCH:], TRAIN_BATCH) for i in range(4)]
    ms = [train_steps_ms(model, batches, 10) for _ in range(2)]
    model.set_weights(trained)
    record = dict(
        model=name, batch=TRAIN_BATCH, steps=TRAIN_STEPS_PER_EPOCH * ZOO_EPOCHS,
        epochs=ZOO_EPOCHS, loss=zoo_loss(name), fit_seconds=fit_s, launches=launches,
        history=logs,
        rel_err_vs_cpu_one_sgd_step=cpu_errs, ms_per_step=ms,
        examples_per_s=[TRAIN_BATCH / t * 1e3 for t in ms],
        parameters=sum(p.numel() for p in model.module.parameters()),
        batch_stats=sum(b.numel() for b in model.module.buffers()),
        max_memory_allocated=peak,
    )
    emit(phase=f"zoo_{name}_training", **record)
    return record, model, batches


def phase_zoo_scoring(model, name):
    """The trained zoo model through ``Scorer(batch_size=8192)`` over
    the serving requests: no hand-written kernel launched, finite
    probabilities of shape [n, 1] ([n, 2] for a multitask model),
    examples/s, and the scores within 1e-5 of the CPU model's on a small
    input."""
    scorer = Scorer(model, batch_size=BATCH).warmup()
    reqs = requests(np.random.default_rng(SEED + 1), REQUESTS, zoo_version(name))
    reset_launches()
    preds, eps, ms = score_all(scorer, reqs)
    counts = read_launches()
    if counts != expected():
        raise AssertionError(f"zoo {name} scoring launched {counts}")
    tasks = len(MT_LOSS) if name in ZOO_MULTITASK else 1
    for n, p in zip(REQUESTS, preds):
        if p.shape != (n, tasks) or not (np.isfinite(p).all() and (p > 0).all()
                                         and (p < 1).all()):
            raise AssertionError(f"bad zoo {name} scores: shape {p.shape}, "
                                 f"range [{p.min()}, {p.max()}]")
    runs = [score_all(scorer, reqs) for _ in range(2)]
    cpu_model = zoo_model(name, "cpu", model.get_weights())
    small = requests(np.random.default_rng(SEED + 2), (64,), zoo_version(name))[0]
    cpu_err = float(np.abs(model.predict(small, 64) - cpu_model.predict(small, 64)).max())
    if cpu_err > 1e-5:
        raise AssertionError(f"zoo {name}: card and CPU scores differ by {cpu_err}")
    record = dict(model=name, requests=list(REQUESTS),
                  batches=sum(-(-n // BATCH) for n in REQUESTS), launches=counts,
                  examples_per_s=[eps] + [r[1] for r in runs], ms=[ms] + [r[2] for r in runs],
                  max_abs_diff_vs_cpu=cpu_err,
                  score_std=np.concatenate(preds).std(axis=0).tolist())
    emit(phase=f"zoo_{name}_scoring", **record)
    return record


def phase_zoo_mixed_dims():
    """DCN on the canonical columns with the last 13 sparse fields at
    ZOO_MIXED_DIM: two main tables, ``fast_inputs`` on the per-feature route
    (the stacked lookup raises ``MixedEmbeddingDims``), no fused gather, one
    SGD step on the card against the CPU, no hand-written kernel launched."""
    cols = [SparseFeat(f"C{i}", VOCAB, DIM if i < 13 else ZOO_MIXED_DIM)
            for i in range(N_SPARSE)] + [DenseFeat(f"I{i}") for i in range(N_DENSE)]
    model = zoo_model("dcn", "cuda", cols=cols)
    tables = sorted(n for n, _ in model.module.embedding_dict.named_parameters())
    if tables != [f"table_d{DIM}", f"table_d{ZOO_MIXED_DIM}"]:
        raise AssertionError(f"zoo mixed dims: main tables {tables}")
    if model.module._fused:
        raise AssertionError("zoo mixed dims: the lookup fused a mixed-dim set")
    rng = np.random.default_rng(SEED + 3)
    x, y = train_data(rng, 512)
    xb, _ = device_batch(model, x, y, 512)
    emb = model.module.embedding_dict
    try:
        emb.stacked_inputs(xb, model.dnn_feature_columns)
        raise AssertionError("zoo mixed dims: the stacked lookup took mixed dims")
    except MixedEmbeddingDims:
        pass
    sparse_list, dense_list = emb.fast_inputs(xb, model.dnn_feature_columns)
    widths = [t.shape[-1] for t in sparse_list]
    if widths != [DIM] * 13 + [ZOO_MIXED_DIM] * (N_SPARSE - 13) or len(dense_list) != N_DENSE:
        raise AssertionError(f"zoo mixed dims: fast_inputs gave widths {widths}")
    weights = seeded_weights(model)
    reset_launches()
    cpu_errs = sgd_step_vs_cpu([zoo_model("dcn", dev, weights, cols) for dev in ("cuda", "cpu")],
                               x, y, "zoo mixed dims: ")
    launches = read_launches()
    if launches != expected():
        raise AssertionError(f"zoo mixed dims: hand-written kernels launched: {launches}")
    record = dict(model="dcn", tables=tables, fast_inputs_route="per_feature",
                  fast_inputs_widths=widths, launches=launches,
                  rel_err_vs_cpu_one_sgd_step=cpu_errs)
    emit(phase="zoo_dcn_mixed_dims", **record)
    return record


def sgd_variants(variants, phase):
    """One SGD step on the card against the CPU model for each of
    ``variants`` ({label: (model of (cols, device), loss)}; a loss list steps on
    :func:`mt_labels`) from seeded weights; no hand-written kernel launched.
    Returns the launches and each variant's record."""
    cols = canonical_columns()
    rng = np.random.default_rng(SEED + 3)
    x, click = train_data(rng, 512)
    y2 = mt_labels(rng, click)
    reset_launches()
    records = {}
    for label, (build, loss) in variants.items():
        pair = [build(cols, dev) for dev in ("cuda", "cpu")]
        weights = seeded_weights(pair[0])
        for m in pair:
            m.set_weights(weights)
        records[label] = sgd_step_vs_cpu(pair, x, y2 if isinstance(loss, list) else click,
                                         f"{phase} {label}: ", loss=loss)
        records[label]["parameters"] = sorted(k for k, _ in flatten_tree(weights["params"]))
        del pair
    launches = read_launches()
    if launches != expected():
        raise AssertionError(f"{phase}: hand-written kernels launched: {launches}")
    emit(phase=phase, launches=launches, variants=records)
    return dict(launches=launches, variants=records)


def phase_zoo_variants():
    """:func:`sgd_variants` over ZOO_VARIANTS; PNN's outer-product kernel
    keeps its raw name."""
    rec = sgd_variants({k: (build, "binary_crossentropy") for k, build in ZOO_VARIANTS.items()},
                       "zoo_variants_sgd_step")
    kernel = rec["variants"]["pnn_outer_mat"]["parameters"]
    if "outterproduct/kernel" not in kernel:
        raise AssertionError(f"zoo variants: PNN's outer-product kernel is missing: {kernel}")
    return rec


def phase_mt_variants():
    """:func:`sgd_variants` over MT_VARIANTS; PLE's tree holds one shared
    expert a level, as the JAX one."""
    rec = sgd_variants(MT_VARIANTS, "mt_variants_sgd_step")
    shared = sorted({k.split("/")[0] for k in rec["variants"]["ple_2_specific_1_shared_l2"]
                     ["parameters"] if k.startswith("shared_expert_")})
    if shared != ["shared_expert_0_0_0", "shared_expert_1_0_0"]:
        raise AssertionError(f"mt variants: PLE's shared experts {shared}")
    return rec


def phase_mt_lazy():
    """MMOE at its defaults on the canonical columns under the lazy
    optimizer, Adam, split gradient, packed layout (one group: the main
    table alone), from seeded weights: MT_LAZY_STEPS train steps of batch
    4096 under the loss list on the card and on the CPU from the same
    weights, the weights and row states after each step within the lazy
    tolerances, rounding-noise entries held (:func:`lazy_adam_close`); no
    hand-written kernel launched; the loss finite."""
    pair = [zoo_model("mmoe", dev) for dev in ("cuda", "cpu")]
    weights = seeded_weights(pair[0])
    for m in pair:
        m.set_weights(weights)
        m.compile("adam", MT_LOSS, embedding_optimizer="lazy", embedding_gradient="split",
                  embedding_layout="packed")
        m._dropout_gen = torch.Generator(device=m.device).manual_seed(m.seed + 1)
    (g,) = pair[0]._lazy["groups"]
    if [m["path"] for m in g["members"]] != ["embedding_dict/table_d10"]:
        raise AssertionError(f"mt lazy: groups {pair[0]._lazy['groups']}")
    rng = np.random.default_rng(SEED + 43)
    x, y = zoo_data(rng, MT_LAZY_STEPS * TRAIN_BATCH, "mmoe")
    reset_launches()
    losses, diffs, held = [], [], []
    for i in range(MT_LAZY_STEPS):
        rows = {k: v[i * TRAIN_BATCH :] for k, v in x.items()}
        totals = []
        for m in pair:
            xb, yb = device_batch(m, rows, y[i * TRAIN_BATCH :], TRAIN_BATCH)
            totals.append(m._train_step(xb, yb, torch.ones(TRAIN_BATCH, device=m.device),
                                        with_metrics=False)[0].item())
        card, cpu = (lazy_snapshot(m) for m in pair)
        held.append(lazy_adam_close(f"mt lazy step {i + 1}", card, cpu, i + 1))
        losses.append(totals)
        diffs.append(lazy_diff(card, cpu))
    launches = read_launches()
    if launches != expected():
        raise AssertionError(f"mt lazy: hand-written kernels launched: {launches}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"mt lazy: losses {losses}")
    record = dict(model="mmoe", steps=MT_LAZY_STEPS, batch=TRAIN_BATCH, launches=launches,
                  loss_card_cpu=losses, max_abs_diff_weights_state=diffs, held=held,
                  group_array_shape=list(g["array"].shape))
    emit(phase="mt_lazy", **record)
    return record


# the kernels of a step that would mean a cuDNN convolution or a TF32 product
TF32_OR_CONV = ("tf32", "cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm", "conv2d",
                "convolution")


def phase_ccpm_tf32():
    """CCPM under ``torch.backends.cudnn.allow_tf32 = True`` (torch's
    default; this script turns it off), set for this phase and restored
    after.  (1) A profiled step runs no cuDNN convolution and no TF32
    kernel.  (2) At the train batch, each conv layer's kernel gradient for
    the inputs the model gives it and a seeded cotangent, against float64:
    within FP32_SLACK times the CPU's fp32 error (or 1e-6 of its largest
    entry); beside it, as a control, the same gradient from cuDNN's
    ``F.conv2d`` with TF32 on, reported.  (3) One SGD step against the CPU
    model, the step of every zoo phase."""
    pair = [zoo_model("ccpm", dev) for dev in ("cuda", "cpu")]
    weights = seeded_weights(pair[0])
    for m in pair:
        m.set_weights(weights)
    x, y = train_data(np.random.default_rng(SEED + 3), TRAIN_BATCH)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        xb, yb = device_batch(pair[0], x, y, TRAIN_BATCH)
        seen = {}
        convs = {n: m for n, m in pair[0].module.conv_layer.named_children()
                 if n.startswith("conv_")}
        def keep_input(name):
            def hook(module, args, out):
                seen.setdefault(name, args[0].detach())
            return hook

        hooks = [m.register_forward_hook(keep_input(n)) for n, m in convs.items()]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step_grads(pair[0], xb, yb)
            torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        bad = [n for n in names if any(s in n.lower() for s in TF32_OR_CONV)]
        if bad:
            raise AssertionError(f"ccpm tf32: the step ran convolution or TF32 kernels {bad}")
        layers = {}
        gen = torch.Generator(device="cpu").manual_seed(SEED)
        for n, conv in convs.items():
            inp = seen[n]
            g = torch.randn(tuple(conv(inp).shape), generator=gen)
            ref = copy.deepcopy(conv).cpu().double()
            exact = torch.autograd.grad(ref(inp.cpu().double()), ref.kernel, g.double())[0]
            cpu = copy.deepcopy(conv).cpu()
            cpu_g = torch.autograd.grad(cpu(inp.cpu()), cpu.kernel, g)[0]
            card_g = torch.autograd.grad(conv(inp), conv.kernel, g.cuda())[0].cpu()
            # the control: the same function through cuDNN, NCHW, TF32 on
            w = conv.kernel.detach().permute(3, 2, 0, 1).contiguous().requires_grad_()
            out = F.conv2d(inp.permute(0, 3, 1, 2), w, conv.bias.detach(), padding="same")
            ctl_g = torch.autograd.grad(out, w, g.cuda().permute(0, 3, 1, 2))[0]
            ctl_g = ctl_g.permute(2, 3, 1, 0).cpu()
            top = float(exact.abs().max())
            errs = {k: float((v.double() - exact).abs().max()) / top
                    for k, v in (("card", card_g), ("cpu", cpu_g), ("cudnn_tf32", ctl_g))}
            if errs["card"] > max(FP32_SLACK * errs["cpu"], 1e-6):
                raise AssertionError(f"ccpm tf32: {n}'s kernel gradient is {errs['card']} off "
                                     f"float64, beyond {FP32_SLACK} times the CPU's "
                                     f"{errs['cpu']}")
            layers[n] = dict(input=list(inp.shape), rel_err_vs_float64=errs)
        reset_launches()
        step = sgd_step_vs_cpu(pair, x, y, "ccpm tf32: ")
        launches = read_launches()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    if launches != expected():
        raise AssertionError(f"ccpm tf32: hand-written kernels launched: {launches}")
    record = dict(model="ccpm", cudnn_allow_tf32=True, launches=launches, conv_layers=layers,
                  step_kernels=len(names), rel_err_vs_cpu_one_sgd_step=step)
    emit(phase="zoo_ccpm_tf32_default", **record)
    return record


def phase_zoo_determinism():
    """Each of ZOO_12C from seeded weights at the train batch: two identical
    steps (as :func:`step_grads`) give every gradient bit for bit."""
    x, y = train_data(np.random.default_rng(SEED + 4), TRAIN_BATCH)
    records = {}
    for name in ZOO_12C:
        model = zoo_model(name, "cuda")
        model.set_weights(seeded_weights(model))
        xb, yb = device_batch(model, x, y, TRAIN_BATCH)
        first = step_grads(model, xb, yb)
        records[name] = dict(gradients=len(first), grads_not_reproduced=reproduced(
            f"zoo {name}: ", first, step_grads(model, xb, yb)))
        del model, first
        torch.cuda.empty_cache()
    emit(phase="zoo_determinism", batch=TRAIN_BATCH, models=records)
    return records


# ---------------------------------------------------------------------------
# BatchNorm and Dice on a kernel path, and compile's bf16 mode (ROADMAP item
# 12b).  Neither has a TPU kernel of its own: Dice attention and a BatchNorm
# DNN reach DIEN's GRU kernels (rows 14-15), the bf16 mode the CIN's (rows
# 1-3), which keep fp32 inputs (``ops._build.fp32_forward``).
# ---------------------------------------------------------------------------

# the first bf16 step's loss against the fp32 step's from the same weights:
# a few bf16 roundings (2^-8 each) of the towers' products
BF16_LOSS_RTOL = 1e-2


def dien_dice_model(device):
    """DIEN as MODELS["dien"], with a Dice attention MLP and a BatchNorm
    DNN."""
    return DIEN(dien_columns(), ["item"], gru_type="AUGRU", use_negsampling=True,
                att_activation="Dice", use_bn=True, device=device)


def phase_dien_dice():
    """DIEN with ``att_activation="Dice"`` (batch-major attention, its
    statistics over every (sample, step), padded steps included) and
    ``use_bn=True``: one SGD step on the card against the CPU model from
    seeded weights (gradients, weights and running statistics), the GRU
    kernels launched as on DIEN's path (2 gru_fwd + 2 gru_bwd)."""
    pair = [dien_dice_model(dev) for dev in ("cuda", "cpu")]
    weights = seeded_weights(pair[0])
    for m in pair:
        m.set_weights(weights)
    x, y = train_data(np.random.default_rng(SEED + 3), 512, "dien")
    reset_launches()
    errs = sgd_step_vs_cpu(pair, x, y, "dien_dice: ", GRAD_FLOOR["dien_dice"])
    launches = read_launches()
    if launches != expected(**ATTN_STEP["dien"]):
        raise AssertionError(f"dien_dice: one step launched {launches}, DIEN's path "
                             f"{ATTN_STEP['dien']}")
    stats = sorted(k for k, _ in flatten_tree(pair[0].get_weights()["batch_stats"]))
    record = dict(model="dien", gru_type="AUGRU", att_activation="Dice", use_bn=True,
                  launches=launches, batch_stats=stats, rel_err_vs_cpu_one_sgd_step=errs)
    emit(phase="dien_dice_sgd_step", **record)
    return record


def phase_bf16():
    """The canonical xDeepFM compiled with ``matmul_precision="bfloat16"``:
    its first step's loss within BF16_LOSS_RTOL of the fp32 step's from the
    same weights; ``fit`` at batch 4096 with Adam for ZOO_EPOCHS epochs of 8
    steps (validation half batch), the loss finite and falling, the CIN
    kernels launched as on the fp32 path (2 + 2 + 2 a step, 2 a validation
    batch); a training profile of each mode, bf16 GEMM kernels in the
    bf16 step's, and its busy ms beside the fp32 step's (no claim)."""
    weights = canonical_model("cpu", seeded=False).get_weights()
    rng = np.random.default_rng(SEED + 3)
    x, y = train_data(rng, TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH + TRAIN_BATCH // 2)
    x, y, val = (  # the last half batch validates
        {k: v[: -TRAIN_BATCH // 2] for k, v in x.items()}, y[: -TRAIN_BATCH // 2],
        ({k: v[-TRAIN_BATCH // 2 :] for k, v in x.items()}, y[-TRAIN_BATCH // 2 :]),
    )
    first = {}
    for mode, precision in (("fp32", None), ("bf16", "bfloat16")):
        m = canonical_model("cuda", weights)
        m.compile("adam", "binary_crossentropy", matmul_precision=precision)
        first[mode] = m.fit({k: v[:TRAIN_BATCH] for k, v in x.items()}, y[:TRAIN_BATCH],
                            batch_size=TRAIN_BATCH, epochs=1, verbose=0,
                            shuffle=False).history["loss"][0]
    del m
    first_rel = abs(first["bf16"] - first["fp32"]) / abs(first["fp32"])
    if not first_rel <= BF16_LOSS_RTOL:
        raise AssertionError(f"bf16: first step's loss {first['bf16']} against fp32's "
                             f"{first['fp32']}, {first_rel} apart")

    model = canonical_model("cuda", weights)
    model.compile("adam", "binary_crossentropy", metrics=["auc"], matmul_precision="bfloat16")
    steps = TRAIN_STEPS_PER_EPOCH * ZOO_EPOCHS
    reset_launches()
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=TRAIN_BATCH, epochs=ZOO_EPOCHS, verbose=0,
                        validation_data=val)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    want = expected(cin_fwd=2 * (steps + ZOO_EPOCHS), cin_bwd_dx=2 * steps, cin_dw=2 * steps)
    if launches != want:
        raise AssertionError(f"bf16: launches {launches} over {steps} steps, expected {want}")
    logs = history.history
    for k, v in logs.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"bf16: {k} is not finite: {v}")
    if not logs["loss"][0] > logs["loss"][-1]:
        raise AssertionError(f"bf16: the epoch loss did not fall: {logs['loss']}")
    batches = [device_batch(model, {k: v[i * TRAIN_BATCH:] for k, v in x.items()},
                            y[i * TRAIN_BATCH:], TRAIN_BATCH) for i in range(4)]
    ref = canonical_model("cuda", model.get_weights())
    ref.compile("adam", "binary_crossentropy")
    ref.fit({k: v[:TRAIN_BATCH] for k, v in x.items()}, y[:TRAIN_BATCH],
            batch_size=TRAIN_BATCH, epochs=1, verbose=0)  # builds its step state
    profiles = {"fp32": phase_train_profile(ref, batches, phase="bf16_fp32_train_profile"),
                "bf16": phase_train_profile(model, batches, phase="bf16_train_profile")}
    gemms = [n for n in profiles["bf16"]["bf16_kernels"] if "gemm" in n.lower()]
    if not gemms:
        raise AssertionError(f"bf16: no bf16 GEMM kernel in the step; bf16 kernels "
                             f"{profiles['bf16']['bf16_kernels']}")
    if profiles["fp32"]["bf16_kernels"]:
        raise AssertionError(f"bf16: the fp32 step ran {profiles['fp32']['bf16_kernels']}")
    ms = {mode: [train_steps_ms(mm, batches, 10) for _ in range(2)]
          for mode, mm in (("fp32", ref), ("bf16", model))}
    record = dict(
        batch=TRAIN_BATCH, steps=steps, epochs=ZOO_EPOCHS, fit_seconds=fit_s,
        launches=launches, history=logs, first_step_loss=first,
        first_step_loss_rel_diff=first_rel, bf16_gemm_kernels=gemms,
        device_busy_ms_per_step={k: v["device_busy_ms_per_call"] for k, v in profiles.items()},
        device_idle_share={k: v["device_idle_share"] for k, v in profiles.items()},
        ms_per_step=ms, examples_per_s={k: [TRAIN_BATCH / t * 1e3 for t in v]
                                        for k, v in ms.items()},
    )
    emit(phase="bf16_training", **record)
    return record


# ---------------------------------------------------------------------------
# the CIN's bf16 mode (cin_pallas.set_cin_precision("bf16")): rows 1-2 of
# PERF.md's table in their bf16 kernels, cin_fwd_bf16 and cin_bwd_dx_bf16
# ---------------------------------------------------------------------------

# The bf16 tensor cores' published dense peak at the full power limit (the
# data sheets' sparse figure halved); first matching name wins, as PEAKS
BF16_PEAKS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H200", 989e12), ("H100", 989e12))
BF16_STEP = dict(cin_fwd_bf16=2, cin_round_g_bf16=2, cin_bwd_dx_bf16=2, cin_dw=2)
BF16_EVAL = dict(cin_fwd_bf16=2)
BF16_PROFILE_CALLS = 5
# The variant each bf16 kernel's source builds (its header gives the sweep
# that chose it)
BF16_DESIGN = {
    "cin_fwd_bf16": "wgmma m64n128k16, A by packed products (mul.rn.bf16x2) of bf16-staged "
                    "h and x0, KC 128 k' a tensor-core sum (halved to 32 where the rows "
                    "leave no room), one accumulator set",
    "cin_bwd_dx_bf16": "wgmma m64n128k16, g and W bf16 tiles bulk-copied, SUMK 128 channels "
                       "a tensor-core sum, up to 8 W stages of 64 channels, two accumulator "
                       "sets where O fits one sum",
    "cin_round_g_bf16": "one pass: bf16 row tiles and the fp32 copy for cin_dw",
}
# Card against CPU scores in the bf16 mode: the two sides' layer-0 sums
# differ in order, so a layer-1 h entry that lies on a bf16 rounding
# boundary rounds to neighbouring values (2^-8 apart) on the two sides; the
# scores (probabilities) are held within this
BF16_SCORE_TOL = 1e-4


def profiled_ms(fn, calls=BF16_PROFILE_CALLS):
    """Device ms a call of ``fn`` (every kernel it launches, summed) from
    torch.profiler over ``calls`` calls after a warm-up; None where the
    profiler recorded no device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))
    return total / 1e3 / calls if total > 0 else None


def phase_cin_bf16_kernels(peak):
    """``cin_fwd_bf16`` at the train batch's two layers and the scoring
    batch's, ``cin_bwd_dx_bf16`` and ``cin_round_g_bf16`` (the rounding pass
    of g) at the train layers.  The two contractions each against their bf16
    plain version (``CIN_TOL``, ``BWD_RTOL``; the backward from the raw g,
    the pass inside) and against float64 of the same rounded operands
    (:func:`_f64_gate`, the fp32 gate), bit-equal over two runs; CUDA-event
    ms (the backward's on g already rounded, as the train step runs it, and
    from the raw g) beside the plain version's and one ``torch.einsum`` on
    bf16 operands (the library yardstick); profiler device ms beside the fp32
    kernel's at the same shape; the bound at the bf16 tensor-core peak and
    the memory rate (fp32 operands read once, outputs written once) and the
    share of it; the chosen variant (``BF16_DESIGN``).  The rounding pass:
    its fp32 copy of g bit-equal to ``bf16_round(g)`` (its plain version),
    both outputs bit-equal over two runs, its ms and device ms beside one
    ``g.to(torch.bfloat16)`` (the library yardstick), bound by its bytes (g
    read, its fp32 copy and bf16 tiles written)."""
    _, _, peak_bw, _ = peak
    peak_bf16 = next(p for name, p in BF16_PEAKS if name in peak[0])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    results = {}
    cases = [("cin_fwd_bf16", s) for s in TRAIN_SHAPES + SERVE_SHAPES] + [
        (name, s) for s in TRAIN_SHAPES for name in ("cin_bwd_dx_bf16", "cin_round_g_bf16")]
    for name, (label, N, H, M, O, strided) in cases:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        h = rand(N, 2 * H)[:, :H] if strided else rand(N, H)
        x0, W, b, g = rand(N, M), rand(O, H * M), rand(O), rand(N, O)
        iters = 20 if N > 10_000 else 200
        if name == "cin_round_g_bf16":
            got, again = cin_rows_round_g_bf16(g), cin_rows_round_g_bf16(g)
            torch.cuda.synchronize()
            if not torch.equal(got.rounded, bf16_round(g)):
                raise AssertionError(f"{name} at {label}: g's fp32 copy is not bf16_round(g)")
            if not (torch.equal(got.tiles, again.tiles) and torch.equal(got.rounded,
                                                                        again.rounded)):
                raise AssertionError(f"{name} at {label}: two runs differ")
            del got, again
            kernel = lambda: cin_rows_round_g_bf16(g)  # noqa: E731
            kernel_ms, plain_ms, library_ms = (cuda_ms(f, iters) for f in (
                kernel, lambda: bf16_round(g), lambda: g.to(torch.bfloat16)))
            nbytes = N * O * (4 + 4 + 2)
            bound = nbytes / peak_bw * 1e3
            results[name, label] = dict(
                N=N, O=O, max_abs_err=0.0, rounded_bit_equal_to_plain=True, bit_equal=True,
                kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                plain="bf16_round(g): g.to(bfloat16).to(float32), the fp32 copy alone",
                library="g.to(torch.bfloat16): the rounding alone, no fp32 copy",
                design=BF16_DESIGN[name],
                device_ms=profiled_ms(kernel), bound_ms=bound, bound_by="bytes",
                bound_share=bound / kernel_ms, gflop=0.0, mbytes=nbytes / 1e6)
            emit(phase="cin_bf16_kernel", kernel=name, shape=label, **results[name, label])
            continue
        W3b = W.view(O, H, M).bfloat16()
        hb, xb, gb = h.bfloat16(), x0.bfloat16(), g.bfloat16()
        if name == "cin_fwd_bf16":
            kernel = lambda: cin_rows_forward_bf16(h, x0, W, b)  # noqa: E731
            path = kernel
            plain = lambda: cin_rows_reference_bf16(h, x0, W, b)  # noqa: E731
            fp32 = lambda: cin_rows_forward(h, x0, W, b)  # noqa: E731
            exact = cin_rows_reference_bf16(h.double(), x0.double(), W.double(), b.double())
            library = lambda: torch.einsum("nh,nm,ohm->no", hb, xb, W3b)  # noqa: E731
            nbytes = 4 * (N * H + N * M + O * H * M + O + N * O)
        else:
            gq = cin_rows_round_g_bf16(g, rounded=False)
            kernel = lambda: torch.cat(cin_rows_backward_bf16(g, h, x0, W), 1)  # noqa: E731
            path = lambda: cin_rows_backward_bf16(gq, h, x0, W)  # noqa: E731
            plain = lambda: torch.cat(cin_rows_backward_reference_bf16(g, h, x0, W), 1)  # noqa: E731
            fp32 = lambda: cin_rows_backward(g, h, x0, W)  # noqa: E731
            exact = torch.cat(cin_rows_backward_reference_bf16(
                g.double(), h.double(), x0.double(), W.double()), 1)
            library = lambda: (torch.einsum("no,nm,ohm->nh", gb, xb, W3b),  # noqa: E731
                               torch.einsum("no,nh,ohm->nm", gb, hb, W3b))
            nbytes = 4 * (N * O + O * H * M + 2 * (N * H + N * M))
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = float((got - want).abs().max())
        if name == "cin_fwd_bf16":
            torch.testing.assert_close(got, want, **CIN_TOL)
            gates = [_f64_gate(f"{name} at {label}", got, want, exact)]
        else:
            torch.testing.assert_close(got, want, rtol=BWD_RTOL,
                                       atol=BWD_RTOL * float(want.abs().max()) + 1e-6)
            gates = [_f64_gate(f"{name} {out} at {label}", a, p, e) for out, a, p, e in
                     zip(("dh", "dx0"), got.split((H, M), 1), want.split((H, M), 1),
                         exact.split((H, M), 1))]
            if not torch.equal(got, torch.cat(path(), 1)):
                raise AssertionError(f"{name} at {label}: the rounded g's tiles give other "
                                     "values than the raw g")
        again = kernel()
        bit_equal = bool(torch.equal(got, again))
        if not bit_equal:
            raise AssertionError(f"{name} at {label}: two runs differ")
        # the modes differ: the kernel did round
        f32_gap = float((got - (fp32() if name == "cin_fwd_bf16" else torch.cat(fp32(), 1)))
                        .abs().max())
        del got, want, again, exact
        kernel_ms, plain_ms, library_ms = (cuda_ms(f, iters) for f in (path, plain, library))
        flops = 2 * N * H * M * O
        by_ops = flops / peak_bf16 >= nbytes / peak_bw
        bound = max(flops / peak_bf16, nbytes / peak_bw) * 1e3
        results[name, label] = dict(
            N=N, H=H, M=M, O=O, strided_h=strided, max_abs_err=err,
            err_vs_float64=max(e for e, _ in gates), plain_err_vs_float64=max(p for _, p in gates),
            bit_equal=bit_equal, max_abs_diff_vs_fp32_kernel=f32_gap,
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            **({} if name == "cin_fwd_bf16" else {
                "kernel_ms_from_raw_g": cuda_ms(kernel, iters),
                "kernel_ms_is": "on g already rounded by cin_round_g_bf16, as the train step"}),
            library="torch.einsum over bf16 h, x0 and W" if name == "cin_fwd_bf16"
            else "torch.einsum over bf16 g, x0 / h and W (dh, dx0)",
            device_ms=profiled_ms(path), fp32_kernel_device_ms=profiled_ms(fp32),
            bound_ms=bound, bound_by="operations" if by_ops else "bytes",
            bound_share=bound / kernel_ms, design=BF16_DESIGN[name], peak_bf16_flops=peak_bf16,
            gflop=flops / 1e9, mbytes=nbytes / 1e6, tflops=flops / kernel_ms / 1e9,
        )
        emit(phase="cin_bf16_kernel", kernel=name, shape=label, **results[name, label])
    return results


def phase_cin_bf16_training():
    """The canonical xDeepFM at bench.py's width under
    ``set_cin_precision("bf16")``: ``fit`` at batch 4096 with Adam for
    ZOO_EPOCHS epochs of 8 steps (a validation half batch), 2 + 2 + 2 + 2
    launches a step (``cin_fwd_bf16``, ``cin_round_g_bf16``, whose rounded g
    feeds both ``cin_bwd_dx_bf16`` and ``cin_dw``) and no fp32 ``cin_fwd``
    or ``cin_bwd_dx``, the loss finite and falling; one step's gradients
    with the kernels and with the bf16 plain
    versions under each backward implementation (the legacy one: the bf16
    forward kernel with permuted weights, ``cin_dw`` on the raw g), both
    against a float64 copy in the bf16 mode (as :func:`phase_model_training`
    holds them); a second identical step bit-equal; one SGD step on the card
    against the CPU model in the bf16 mode; ms a step and the profiler's
    busy and idle share beside the fp32 step's from the same weights; then
    ``Scorer(8192)`` over the serving requests (2 ``cin_fwd_bf16`` a batch)
    on the seeded weights, against the CPU model on a small input within
    BF16_SCORE_TOL and nearer to it than the fp32 mode's scores."""
    set_cin_precision("bf16")
    try:
        return _cin_bf16_training()
    finally:
        set_cin_precision("f32")
        set_backward_impl("auto")


def _cin_bf16_training():
    model = canonical_model("cuda", seeded=False)
    model.compile("adam", "binary_crossentropy", metrics=["auc"])
    rng = np.random.default_rng(SEED + 3)
    x, y = train_data(rng, TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH + TRAIN_BATCH // 2)
    x, y, val = (  # the last half batch validates
        {k: v[: -TRAIN_BATCH // 2] for k, v in x.items()}, y[: -TRAIN_BATCH // 2],
        ({k: v[-TRAIN_BATCH // 2 :] for k, v in x.items()}, y[-TRAIN_BATCH // 2 :]),
    )
    steps = TRAIN_STEPS_PER_EPOCH * ZOO_EPOCHS
    reset_launches()
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=TRAIN_BATCH, epochs=ZOO_EPOCHS, verbose=1,
                        validation_data=val)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    want = expected(**{k: steps * BF16_STEP.get(k, 0) + ZOO_EPOCHS * BF16_EVAL.get(k, 0)
                       for k in WRAPPERS})
    if launches != want:
        raise AssertionError(f"cin_bf16: launches {launches} over {steps} steps, expected {want}")
    logs = history.history
    for k, v in logs.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"cin_bf16: {k} is not finite: {v}")
    if not logs["loss"][0] > logs["loss"][-1]:
        raise AssertionError(f"cin_bf16: the epoch loss did not fall: {logs['loss']}")

    xb, yb = device_batch(model, x, y, TRAIN_BATCH)
    grads, step_launches = {}, {}
    legacy_fwd = len(CIN_LAYERS) + sum(2 * -(-o // FWD_H_BLOCK) for o in CIN_LAYERS)
    per_impl = {"auto": expected(**BF16_STEP),
                "legacy": expected(cin_fwd_bf16=legacy_fwd, cin_dw=2)}
    for impl in ("auto", "legacy"):
        set_backward_impl(impl)
        model.module.cin.backend = "torch"
        want_g, plain_rec = relu_step_grads(model, xb, yb)
        model.module.cin.backend = None
        reset_launches()
        got_g, kernel_rec = relu_step_grads(model, xb, yb)
        step_launches[impl] = read_launches()
        if step_launches[impl] != per_impl[impl]:
            raise AssertionError(f"cin_bf16 {impl}: one step launched {step_launches[impl]}")
        ref, kernel_vs64 = fp64_grads(model, xb, yb, kernel_rec)
        ref_plain, plain_vs64 = fp64_grads(model, xb, yb, plain_rec)
        kernel64, plain64 = per_grad_err(got_g, ref), per_grad_err(want_g, ref_plain)
        vs64 = {k: (kernel64[k], plain64[k]) for k in ref}
        bad = {k: e for k, e in vs64.items() if e[0] > max(GRAD_RTOL, FP32_SLACK * e[1])}
        if bad:
            raise AssertionError(f"cin_bf16 {impl}: kernel gradients off float64 by "
                                 f"(kernel, plain) {bad}")
        grads[impl] = dict(
            rel_err_vs_plain=grad_err(got_g, want_g),
            relu_flips=dict(kernel_vs_float64=kernel_vs64, plain_vs_float64=plain_vs64),
            rel_err_vs_float64_worst={k: {"kernel": e[0], "plain": e[1]} for k, e in sorted(
                vs64.items(), key=lambda kv: -kv[1][0])[:5]})
        del want_g, got_g, ref, ref_plain
    set_backward_impl("auto")
    unsteady = reproduced("cin_bf16: ", step_grads(model, xb, yb), step_grads(model, xb, yb))
    cpu_errs = sgd_step_vs_cpu(
        [canonical_model(dev, model.get_weights()) for dev in ("cuda", "cpu")], x, y,
        "cin_bf16: ")

    # ms a step and the device's busy share, bf16 CIN against fp32 CIN from
    # the same weights, in turns
    batches = [device_batch(model, {k: v[i * TRAIN_BATCH:] for k, v in x.items()},
                            y[i * TRAIN_BATCH:], TRAIN_BATCH) for i in range(4)]
    ms = {"bf16": [], "fp32": []}
    for mode in ("bf16", "fp32", "fp32", "bf16"):
        set_cin_precision(mode if mode == "bf16" else "f32")
        ms[mode].append(train_steps_ms(model, batches, 10))
    set_cin_precision("f32")
    fp32_profile = phase_train_profile(model, batches, phase="cin_bf16_fp32_train_profile")
    set_cin_precision("bf16")
    profile = phase_train_profile(model, batches, phase="cin_bf16_train_profile")

    # scoring at 8192 in the bf16 mode, on the seeded weights (scale 0.1:
    # the CIN moves the scores, where the trained model's 1e-4 tables keep
    # its share small)
    model = canonical_model("cuda")
    scorer = Scorer(model, batch_size=BATCH).warmup()
    reqs = requests(np.random.default_rng(SEED + 1), REQUESTS)
    n_batches = sum(-(-n // BATCH) for n in REQUESTS)
    reset_launches()
    preds, eps, score_ms = score_all(scorer, reqs)
    scoring_launches = read_launches()
    if scoring_launches != expected(cin_fwd_bf16=2 * n_batches):
        raise AssertionError(f"cin_bf16: scoring launched {scoring_launches} for {n_batches} "
                             "batches")
    for n, p in zip(REQUESTS, preds):
        if p.shape != (n, 1) or not (np.isfinite(p).all() and (p > 0).all() and (p < 1).all()):
            raise AssertionError(f"cin_bf16: bad scores of shape {p.shape}")
    cpu_model = canonical_model("cpu", model.get_weights())
    small = requests(np.random.default_rng(SEED + 2), (64,))[0]
    cpu_pred = cpu_model.predict(small, 64)
    cpu_err = float(np.abs(model.predict(small, 64) - cpu_pred).max())
    if cpu_err > BF16_SCORE_TOL:
        raise AssertionError(f"cin_bf16: card and CPU scores differ by {cpu_err}")
    set_cin_precision("f32")  # the fp32 mode's scores: how far bf16 moves them
    fp32_gap = float(np.abs(model.predict(small, 64) - cpu_pred).max())
    set_cin_precision("bf16")
    if not fp32_gap > cpu_err:
        raise AssertionError(f"cin_bf16: the fp32 mode's scores ({fp32_gap} from the CPU's "
                             f"bf16 ones) are no farther than the card's bf16 ones ({cpu_err})")
    record = dict(
        batch=TRAIN_BATCH, steps=steps, epochs=ZOO_EPOCHS, fit_seconds=fit_s, launches=launches,
        step_launches=step_launches, history=logs, grads=grads, grads_not_reproduced=unsteady,
        rel_err_vs_cpu_one_sgd_step=cpu_errs,
        ms_per_step=ms, examples_per_s={k: [TRAIN_BATCH / t * 1e3 for t in v]
                                        for k, v in ms.items()},
        device_busy_ms_per_step={"bf16": profile["device_busy_ms_per_call"],
                                 "fp32": fp32_profile["device_busy_ms_per_call"]},
        device_idle_share={"bf16": profile["device_idle_share"],
                           "fp32": fp32_profile["device_idle_share"]},
        scoring_launches=scoring_launches, scoring_examples_per_s=eps, scoring_ms=score_ms,
        scoring_max_abs_diff_vs_cpu=cpu_err, fp32_mode_max_abs_diff_vs_cpu_bf16=fp32_gap,
    )
    emit(phase="cin_bf16_training", **record)
    return record


# ---------------------------------------------------------------------------
# the usage layer: xdeepfm_tpu_torch/examples/ and scripts/run*.bash
# ---------------------------------------------------------------------------

# (name, module, keyword arguments, examples trained by main: rows x epochs)
EXAMPLES = (
    ("quickstart", quickstart, {}, 18_000 * 3),
    ("serving", serving_example, {}, 20_000 * 2),
    ("large_tables", large_tables, {}, 4096 * 8 * 2),
    ("sharded_training", sharded_training, {}, 29_491 * 2),
)
LAUNCHER_TRAIN_ROWS = 2048  # run_sfg.bash: 30 epochs of batch 64 over 90% of them
LAUNCHER_TIMEOUT = 300


def phase_examples():
    """Each of ``xdeepfm_tpu_torch/examples/`` at its own size on the card
    (``main`` with its defaults; large_tables' checkpoint and the sharded
    one, a one-rank grid, into a temporary directory): wall seconds, the
    examples it trained a second of wall, the CIN kernels' launches (> 0
    for each; the fp32 mode's: no bf16 launch), the serving example's
    largest |scorer - predict| (at most 1e-6); then the three launchers
    ``xdeepfm_tpu_torch/scripts/run.bash``, ``run_attn.bash`` and
    ``run_sfg.bash`` through bash, with their flags as they are, on a
    Criteo-like corpus of LAUNCHER_TRAIN_ROWS rows (``DATA_PATH``,
    ``OUT_DIR``; ``--use_native_parser`` after the flags): exit code 0, the
    training log written, wall seconds."""
    records = {}
    with tempfile.TemporaryDirectory(prefix="xdeepfm-examples-") as d:
        for name, module, kw, trained in EXAMPLES:
            if name == "large_tables":
                kw = dict(kw, checkpoint=os.path.join(d, "large_tables_ckpt.bin"))
            elif name == "sharded_training":
                kw = dict(kw, checkpoint=os.path.join(d, "sharded_ckpt"))
            elif name == "serving":
                kw = dict(kw, out_dir=d)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = module.main(**kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            if not (launches["cin_fwd"] > 0 and launches["cin_bwd_dx"] > 0
                    and launches["cin_dw"] > 0):
                raise AssertionError(f"example {name}: CIN launches {launches}")
            if launches["cin_fwd_bf16"] or launches["cin_bwd_dx_bf16"] or \
                    launches["cin_round_g_bf16"]:
                raise AssertionError(f"example {name}: bf16 launches in the fp32 mode {launches}")
            rec = dict(wall_seconds=wall, examples_trained=trained,
                       examples_per_s=trained / wall, launches=launches)
            if name == "serving":
                rec["max_abs_scorer_minus_predict"] = out["max_abs_diff"]
                if out["max_abs_diff"] > 1e-6:
                    raise AssertionError(f"serving example: scorer and predict differ by "
                                         f"{out['max_abs_diff']}")
            for key in ("predictions", "scores"):
                if key in out and not np.isfinite(out[key]).all():
                    raise AssertionError(f"example {name}: {key} not finite")
            del out
            torch.cuda.empty_cache()
            records[name] = rec
            emit(phase="example", example=name, **rec)

        files = cli_corpus(d, train_rows=LAUNCHER_TRAIN_ROWS, test_rows=256)
        root = os.path.dirname(os.path.abspath(__file__))
        for name in ("run", "run_attn", "run_sfg"):
            out_dir = os.path.join(d, f"out_{name}")
            env = dict(os.environ, DATA_PATH=files["train"], OUT_DIR=out_dir,
                       PYTHON=sys.executable)
            t0 = time.perf_counter()
            proc = subprocess.run(
                ["bash", os.path.join(root, "xdeepfm_tpu_torch", "scripts", f"{name}.bash"),
                 "--use_native_parser"], cwd=root, env=env, capture_output=True, text=True,
                timeout=LAUNCHER_TIMEOUT)
            wall = time.perf_counter() - t0
            if proc.returncode != 0 or not os.path.exists(
                    os.path.join(out_dir, "training_log.json")):
                raise AssertionError(f"launcher {name}.bash exited {proc.returncode}:\n"
                                     f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
            with open(os.path.join(out_dir, "training_log.json")) as f:
                log = json.load(f)
            rec = dict(wall_seconds=wall, rows=LAUNCHER_TRAIN_ROWS,
                       training_config=log.get("training_config"),
                       last_lines=proc.stdout.strip().splitlines()[-3:])
            records[f"launcher_{name}"] = rec
            emit(phase="launcher", launcher=f"{name}.bash", **rec)
    return records


# ---------------------------------------------------------------------------
# the lazy row-sparse embedding optimizer.  It has no TPU kernel of its own
# (its sort, run sums and row writes are XLA in the JAX package and PyTorch
# ops here); the CIN kernels (rows 1-3) run on its xDeepFM steps and the GRU
# kernels (rows 14-15) on its DIEN steps.
# ---------------------------------------------------------------------------

# bench.py's lazy104 row (bench.py:438-467 -> scripts/bench_lazy.py:25-36):
# 26 fields of vocabulary 4 000 000 (104M rows), dim 10, 13 dense, CIN
# (256, 128) split-half, DNN (256, 256), batch 4096, L2 1e-5 on the tables,
# seed 1024, ids uniform over each field's vocabulary
LAZY_VOCAB = 4_000_000
LAZY_STEPS = 20  # timed steps a mode, after 2 warm-up steps
# (path, optimizer, bench_lazy mode): lazy104's own mode, Adam in bf16 row
# state (the same [104M, 22] array), dense Adam at the same table
LAZY_RUNS = (("lazy104_adagrad", "adagrad", "lazy_split"),
             ("lazy104_adam_bf16", "adam", "lazy_split_bf16"),
             ("dense104_adam", "adam", "dense"))
# a lazy split step may allocate at most this share of its group arrays'
# bytes on top of what it holds (a [rows, 11] gradient alone would be half)
LAZY_TRANSIENT_SHARE = 0.1
# the correctness checks at 26 x 100 000 = 2.6M rows, LAZY_CHECK_STEPS steps
# of batch 4096 each, in every mode of the lazy optimizer
LAZY_CHECK_VOCAB, LAZY_CHECK_STEPS = 100_000, 3
LAZY_MODES = ("lazy_split_flat", "lazy_split", "lazy", "lazy_split_bf16")
# Adam's and Adagrad's first steps move an entry by about lr whatever its
# gradient's size, so fp32 noise in a near-zero gradient can move it by up to
# lr: weights within 1e-4 relative and 2e-5 absolute (the CPU tests'
# tolerance at weights of scale 0.1), row states within 1e-4 of their
# largest entry, 2^-7 relative under bf16 (one bf16 step)
LAZY_W_RTOL, LAZY_W_ATOL, LAZY_STATE_ATOL = 1e-4, 2e-5, 1e-4
# bf16 row state against fp32: the moments round to bf16 (2^-9 relative)
# after every step, so step s reads s - 1 roundings.  A rounding of Adam's m
# moves m / sqrt(v) by 2^-9 and one of v by 2^-10 (through the root), one of
# Adagrad's accumulator moves g / sqrt(acc) by 2^-10; each is a share of an
# update of lr * (a ratio at most about 1 over the first steps).  So after S
# steps a lazy table's weights lie within lr * 2^-10 * c * S (S - 1) / 2 of
# the fp32 run's, c = 3 (Adam) or 1 (Adagrad): 8.8e-6 and 2.9e-5 at 3 steps.
LAZY_BF16_C = {"adam": 3, "adagrad": 1}


def lazy_bf16_bound(optimizer, steps=LAZY_CHECK_STEPS):
    lr = LAZY_OPTIMIZERS[optimizer][2]["lr"]
    return lr * 2 ** -10 * LAZY_BF16_C[optimizer] * steps * (steps - 1) / 2


def lazy_model(device, mode, optimizer):
    model = bench_lazy.build_model(LAZY_CHECK_VOCAB, device)
    bench_lazy.compile_mode(model, mode, optimizer)
    model._dropout_gen = torch.Generator(device=model.device).manual_seed(model.seed + 1)
    return model


def lazy_snapshot(model):
    """(every parameter, the lazy row states), cloned, on the host."""
    return ({k: v.detach().cpu().clone() for k, v in model.module.state_dict().items()},
            {k: v.cpu().clone() for k, v in model._lazy_state().items()})


def lazy_diff(a, b):
    """The largest absolute difference of each side of two snapshots."""
    return [max(float((x[k] - y[k]).abs().max()) for k in x) for x, y in zip(a, b)]


def lazy_close(label, got, want, bf16=False):
    """Raise unless ``got`` is within the lazy tolerances of ``want``."""
    for k, w in want[0].items():
        torch.testing.assert_close(got[0][k], w, rtol=LAZY_W_RTOL, atol=LAZY_W_ATOL,
                                   msg=lambda m: f"{label}: {k}: {m}")
    for k, w in want[1].items():
        torch.testing.assert_close(got[1][k], w, rtol=2 ** -7 if bf16 else 1e-3,
                                   atol=LAZY_STATE_ATOL * float(w.abs().max()),
                                   msg=lambda m: f"{label}: state {k}: {m}")


# Lazy Adam moves an entry by about lr whatever its gradient's size (its first
# step is lr * g / (|g| + eps)), so an entry whose gradient is itself rounding
# noise, |g| near eps, moves by what that noise says: MMOE's first lazy step
# at batch 4096 parted card and CPU by 2.1e-4 at one of 2.6M table entries.
# Such an entry is held where the CPU's first moment is below ADAM_NOISE of
# its table's largest, at most MAX_HELD_FLIPS in one comparison, each within
# lr a step.
ADAM_NOISE = 1e-5


def lazy_adam_close(label, got, want, steps):
    """:func:`lazy_close` for lazy Adam snapshots after ``steps`` steps, with
    the table entries whose gradient is rounding noise held (ADAM_NOISE):
    those take ``want``'s value before the comparison.  Returns the held
    entries' count and their largest difference and first-moment share."""
    lr = LAZY_OPTIMIZERS["adam"][2]["lr"]
    params = dict(got[0])
    held, worst, share = 0, 0.0, 0.0
    for path, st in want[1].items():
        k = path.replace("/", ".")
        w, g = want[0][k], got[0][k]
        m = st[:, : w.shape[1]].abs()  # Adam's row state is m, then v
        off = (g - w).abs() > LAZY_W_ATOL + LAZY_W_RTOL * w.abs()
        noise = m <= ADAM_NOISE * m.max()
        if (off & ~noise).any() or int(off.sum()) > MAX_HELD_FLIPS:
            return lazy_close(label, got, want)  # raises with the lazy tolerances
        diff = (g - w).abs()[off]
        if off.any():
            held += int(off.sum())
            worst = max(worst, float(diff.max()))
            share = max(share, float((m[off] / m.max()).max()))
            if worst > steps * lr:
                raise AssertionError(f"{label}: {k} held entries differ by {worst}, "
                                     f"above {steps} Adam steps of lr {lr}")
        params[k] = torch.where(off, w, g)
    lazy_close(label, (params, got[1]), want)
    return dict(held=held, held_max_abs_diff=worst, held_max_first_moment_share=share)


def lazy_bf16_close(label, got, want, optimizer, steps=LAZY_CHECK_STEPS):
    """Raise unless the snapshot ``got`` of a bf16-state run lies within the
    bf16 bound of ``want``, the fp32 run's: the lazy tables' weights within
    :func:`lazy_bf16_bound`, the other weights within the lazy tolerances,
    and each entry of a row state within ``steps`` bf16 roundings of itself
    (2^-7 relative covers 3) plus ``steps`` roundings of its moment's
    largest entry in the table: a moment that cancels to near 0 keeps the
    roundings of its earlier, larger values (Adam's m).  Returns the
    tables' largest absolute difference."""
    bound = lazy_bf16_bound(optimizer, steps)
    tables = {path.replace("/", ".") for path in want[1]}
    worst = max(float((got[0][k] - want[0][k]).abs().max()) for k in tables)
    if not worst <= bound:
        raise AssertionError(f"{label}: the lazy tables' weights differ by {worst}, "
                             f"above the bf16 bound {bound}")
    lazy_close(label, *[({k: v for k, v in snap[0].items() if k not in tables}, {})
                        for snap in (got, want)])
    for path, st in want[1].items():
        blocks = st.reshape(st.shape[0], -1, want[0][path.replace("/", ".")].shape[1])
        err = (got[1][path].reshape(blocks.shape) - blocks).abs()
        atol = steps * 2 ** -9 * blocks.abs().amax(dim=(0, 2))
        over = err > 2 ** -7 * blocks.abs() + atol[None, :, None]
        if over.any():
            raise AssertionError(f"{label}: {int(over.sum())} entries of {path}'s row state "
                                 f"past the bf16 bound, the largest difference {float(err.max())}")
    return worst


def phase_lazy104():
    """bench.py's lazy104 configuration on the card: the model built once on
    the host (1.14e9 normal draws) and compiled anew per run of LAZY_RUNS;
    each run's ms a step (CUDA events over LAZY_STEPS steps), examples/s,
    busy ms, idle share and kernels (profiler, 5 steps), memory, and its CIN
    launches (2 + 2 + 2 a step, counted over every step it ran), each line
    with the card's name and power limit (``card``).  After a
    lazy run one more step's transient allocation must stay below
    LAZY_TRANSIENT_SHARE of its group arrays' bytes."""
    records = {}
    card = subprocess.run(  # beside every number of the lines
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    model = bench_lazy.build_model(LAZY_VOCAB, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 40)
    for path, optimizer, mode in LAZY_RUNS:
        t0 = time.perf_counter()
        reset_launches()
        rec = bench_lazy.bench(model, LAZY_VOCAB, mode, optimizer, steps=LAZY_STEPS)
        counts = read_launches()
        steps = 2 + LAZY_STEPS + bench_lazy.PROFILE_STEPS
        want = expected(cin_fwd=2 * steps, cin_bwd_dx=2 * steps, cin_dw=2 * steps)
        if counts != want:
            raise AssertionError(f"{path}: launches {counts} over {steps} steps, expected {want}")
        batch = bench_lazy.draw_batch(model, LAZY_VOCAB, rng)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        total, _ = model._train_step(*batch, with_metrics=False)
        torch.cuda.synchronize()
        transient = torch.cuda.max_memory_allocated() - before
        if not np.isfinite(total.item()):
            raise AssertionError(f"{path}: the step's loss is {total.item()}")
        rec.update(path=path, card=card, build_seconds=build_s, seconds=time.perf_counter() - t0,
                   launches=counts,
                   launches_per_step={k: v / steps for k, v in counts.items() if v},
                   one_step_transient_bytes=transient, one_step_loss=total.item())
        if model._lazy is not None:
            arrays = sum(g["array"].numel() * g["array"].element_size()
                         for g in model._lazy["groups"])
            rec.update(group_array_bytes=arrays, group_array_shapes=[
                list(g["array"].shape) for g in model._lazy["groups"]],
                transient_share_of_arrays=transient / arrays)
            if transient >= LAZY_TRANSIENT_SHARE * arrays:
                raise AssertionError(f"{path}: a lazy step allocated {transient} bytes, "
                                     f"{transient / arrays:.3f} of its arrays' {arrays}")
        records[path] = rec
        emit(phase="lazy", **rec)
    del model
    torch.cuda.empty_cache()
    return records


def phase_lazy_checks():
    """The lazy optimizer's correctness on the card at 2.6M rows, for Adam
    and Adagrad in every mode (split flat, split packed, dense cotangent,
    packed bf16), LAZY_CHECK_STEPS steps from the seeded weights on the same
    batches: split packed against split flat and split against dense
    cotangent (bit-equal where ``bit_equal`` says so, else within the lazy
    tolerances), bf16 against fp32 state (:func:`lazy_bf16_close`); the
    rows no batch touched, and their state, bit-unchanged; a second identical run bit-equal; one step on
    the card against the CPU model's; a checkpoint of the packed model
    loaded into a flat one and the next step on both."""
    rng = np.random.default_rng(SEED + 41)
    cpu_model = lazy_model("cpu", "lazy_split", "adam")  # also the CPU side of one step
    init = lazy_snapshot(cpu_model)[0]
    cpu_batches = [bench_lazy.draw_batch(cpu_model, LAZY_CHECK_VOCAB, rng)
                   for _ in range(LAZY_CHECK_STEPS)]
    batches = [({k: v.cuda() for k, v in xb.items()}, yb.cuda(), mb.cuda())
               for xb, yb, mb in cpu_batches]
    sp = torch.cat([b[0]["sparse"].long() for b in cpu_batches])
    touched = torch.zeros(N_SPARSE * LAZY_CHECK_VOCAB, dtype=torch.bool)
    touched[(sp + torch.arange(N_SPARSE) * LAZY_CHECK_VOCAB).reshape(-1)] = True
    record = dict(rows=N_SPARSE * LAZY_CHECK_VOCAB, steps=LAZY_CHECK_STEPS,
                  touched_rows=int(touched.sum()))
    for optimizer in ("adam", "adagrad"):
        runs, losses = {}, {}
        for mode in LAZY_MODES + ("lazy_split",):
            m = lazy_model("cuda", mode, optimizer)
            totals = [m._train_step(*b, with_metrics=False)[0].item() for b in batches]
            if not np.isfinite(totals).all():
                raise AssertionError(f"lazy {optimizer} {mode}: loss {totals}")
            snap = lazy_snapshot(m)
            if mode in runs:  # the second identical run
                again = lazy_diff(snap, runs[mode])
                if any(again):
                    raise AssertionError(f"lazy {optimizer} {mode}: a second identical run "
                                         f"differs by {again}")
                record[f"{optimizer}_rerun_bit_equal"] = True
                continue
            runs[mode], losses[mode] = snap, totals
            for path, st in snap[1].items():
                w = path.replace("/", ".")
                frozen = torch.equal(snap[0][w][~touched], init[w][~touched])
                zero = not st[~touched].any()
                if not (frozen and zero):
                    raise AssertionError(f"lazy {optimizer} {mode}: {path}'s untouched rows "
                                         f"changed (weights {not frozen}, state {not zero})")
        for a, b in (("lazy_split", "lazy_split_flat"), ("lazy_split", "lazy"),
                     ("lazy_split_bf16", "lazy_split")):
            diff = lazy_diff(runs[a], runs[b])
            rec = record[f"{optimizer}_{a}_vs_{b}"] = dict(
                max_abs_diff_weights=diff[0], max_abs_diff_state=diff[1],
                bit_equal=not any(diff))
            if "bf16" in a:  # bf16 moments round: held to the bound they allow
                rec.update(max_abs_diff_lazy_tables=lazy_bf16_close(
                    f"lazy {optimizer} {a} vs {b}", runs[a], runs[b], optimizer),
                    lazy_tables_bound=lazy_bf16_bound(optimizer))
            else:
                lazy_close(f"lazy {optimizer} {a} vs {b}", runs[a], runs[b])
        record[f"{optimizer}_losses"] = losses

    # one step on the card against the CPU model's, 256 rows, Adam split packed
    xb, yb, mb = cpu_batches[0]
    small = ({k: v[:256] for k, v in xb.items()}, yb[:256], mb[:256])
    pair = [lazy_model("cuda", "lazy_split", "adam"), cpu_model]
    for m in pair:
        m._train_step({k: v.to(m.device) for k, v in small[0].items()}, small[1].to(m.device),
                      small[2].to(m.device), with_metrics=False)
    card, cpu = (lazy_snapshot(m) for m in pair)
    lazy_close("lazy card vs CPU", card, cpu)
    record["card_vs_cpu_one_step"] = dict(zip(("max_abs_diff_weights", "max_abs_diff_state"),
                                              lazy_diff(card, cpu)))
    del pair, cpu_model

    # a checkpoint of the packed Adam model into a flat one, then a step on both
    src = lazy_model("cuda", "lazy_split", "adam")
    dst = lazy_model("cuda", "lazy_split_flat", "adam")
    for b in batches[:2]:
        src._train_step(*b, with_metrics=False)
    with tempfile.TemporaryDirectory() as d:
        src.save_checkpoint(os.path.join(d, "c.npz"), epoch=1)
        dst.load_checkpoint(os.path.join(d, "c.npz"))
    loaded = lazy_diff(lazy_snapshot(dst), lazy_snapshot(src))
    for m in (src, dst):
        m._lazy["t"] = 2  # the step count goes on in this comparison, as no fit restarts it
        m._train_step(*batches[2], with_metrics=False)
    stepped = lazy_diff(lazy_snapshot(dst), lazy_snapshot(src))
    lazy_close("lazy checkpoint packed -> flat", *(lazy_snapshot(m) for m in (dst, src)))
    record["checkpoint_packed_to_flat"] = dict(
        loaded_max_abs_diff=loaded, next_step_max_abs_diff=stepped,
        bit_equal=not any(loaded + stepped))
    emit(phase="lazy_checks", **record)
    return record


def phase_lazy_dien():
    """DIEN (bench.py's dien row width, seeded weights) under the lazy
    optimizer, split and packed (one singleton group: user, item and both
    histories index one table): ``fit`` for LAZY_CHECK_STEPS steps of batch
    4096, 2 ``gru_fwd`` + 2 ``gru_bwd`` and no CIN launch a step, the loss
    finite, the rows no batch touched bit-unchanged."""
    model = canonical_model("cuda", version="dien")
    model.compile("adam", "binary_crossentropy", embedding_optimizer="lazy")
    (g,) = model._lazy["groups"]
    if not (model._lazy["packed"] and len(g["members"]) == 1):
        raise AssertionError(f"DIEN's lazy groups: {model._lazy['groups']}")
    x, y = train_data(np.random.default_rng(SEED + 42), LAZY_CHECK_STEPS * TRAIN_BATCH, "dien")
    before = model.module.embedding_dict.table_d10.detach().clone()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=TRAIN_BATCH, epochs=1, verbose=0, shuffle=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_launches()
    want = expected(**{k: LAZY_CHECK_STEPS * v for k, v in ATTN_STEP["dien"].items()})
    if counts != want:
        raise AssertionError(f"lazy DIEN: launches {counts}, expected {want}")
    loss = history.history["loss"]
    if not np.isfinite(loss).all():
        raise AssertionError(f"lazy DIEN: loss {loss}")
    after = model.module.embedding_dict.table_d10.detach()
    touched = torch.zeros(after.shape[0], dtype=torch.bool, device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in model.schema.pack(x).items()}
    touched[touched_ids(batch, g["entries"])] = True
    if not torch.equal(after[~touched], before[~touched]):
        raise AssertionError("lazy DIEN: untouched rows changed")
    if not (after[touched] != before[touched]).any(dim=1).all():
        raise AssertionError("lazy DIEN: a touched row did not move")
    record = dict(steps=LAZY_CHECK_STEPS, batch=TRAIN_BATCH, launches=counts, loss=loss,
                  fit_seconds=fit_s, rows=after.shape[0], touched_rows=int(touched.sum()),
                  group_array_shape=list(g["array"].shape))
    emit(phase="lazy_dien", **record)
    return record


# --------------------------------------------------------------------------
# The rank grid (parallel/): co-located ranks on one card.  NCCL refuses two
# ranks on one GPU, so the multi-rank worlds run over gloo on CUDA tensors;
# a one-rank NCCL world runs the same code.  Each rank is this script run
# again with --grid-rank; the kernels were built by phase_build, so a rank
# only loads them.
# --------------------------------------------------------------------------

GRID_STEPS = 3
GRID_LAZY_SPLIT = dict(embedding_optimizer="lazy", embedding_gradient="split")
GRID_LAZY_DENSE = dict(embedding_optimizer="lazy", embedding_gradient="dense")
# label -> (world, model, optimizer, compile kwargs, embedding mode, comm
# dtype, steps); the reference is the one-process run of (model, optimizer,
# compile kwargs, steps) on the card
GRID_CASES = {
    "grid_dense_shard_map": (4, "xdeepfm", "adam", {}, "shard_map", None, GRID_STEPS),
    "grid_dense_all_to_all": (4, "xdeepfm", "adam", {}, "all_to_all", None, GRID_STEPS),
    "grid_dense_all_to_all_bf16": (4, "xdeepfm", "adam", {}, "all_to_all", "bfloat16",
                                   GRID_STEPS),
    "grid_sgd_shard_map": (4, "xdeepfm", "sgd", {}, "shard_map", None, 1),
    "grid_lazy_split_packed": (4, "xdeepfm", "adam", GRID_LAZY_SPLIT, "shard_map", None,
                               GRID_STEPS),
    "grid_lazy_dense": (4, "xdeepfm", "adam", GRID_LAZY_DENSE, "all_to_all", None, GRID_STEPS),
    "grid_pro_all_to_all": (4, "pro", "adam", {}, "all_to_all", None, 2),
    "grid_dense_shard_map_1x2": (2, "xdeepfm", "adam", {}, "shard_map", None, GRID_STEPS),
    "grid_nccl_one_rank": (1, "xdeepfm", "adam", {}, "shard_map", None, GRID_STEPS),
    # the attention, lane and GRU kernels on the ranks: V1 and V2 at bench.py's
    # attn and attn2 rows, DIEN at its dien row, AutoInt as its smoke phase
    # builds it
    "grid_v1": (4, "v1", "adam", {}, "shard_map", None, 2),
    "grid_v2": (4, "v2", "adam", {}, "all_to_all", None, 2),
    "grid_dien": (4, "dien", "adam", {}, "all_to_all", None, 2),
    "grid_autoint": (4, "autoint", "adam", {}, "shard_map", None, 2),
}
# per train step of each model: the CIN's 2 + 2 + 2, Pro's CE 1 + 1 beside
# them; the attention models' as their one-process training phases count them
GRID_STEP_LAUNCHES = {"xdeepfm": dict(cin_fwd=2, cin_bwd_dx=2, cin_dw=2),
                      "pro": dict(cin_fwd=2, cin_bwd_dx=2, cin_dw=2, ce_fwd=1, ce_bwd=1),
                      **{name: ATTN_STEP[name] for name in ("v1", "v2", "dien", "autoint")}}
GRID_MODELS = sorted({case[1] for case in GRID_CASES.values()})
# the grid's fit and fit_stream (xDeepFM, all_to_all; histories against the
# one process's on the card)
GRID_FIT = dict(batch_size=TRAIN_BATCH, epochs=2, verbose=1, validation_split=0.2, shuffle=True)
GRID_FIT_METRICS = ["auc"]
GRID_TIMEOUT = 600


def grid_data_kind(name):
    """The rows a model takes: DIEN's behaviour sequences, else Criteo-like."""
    return "dien" if name == "dien" else "xdeepfm"


def grid_model(name, device, weights):
    """The canonical xDeepFM, xDeepFMPro with its SFG dropout off (the
    ranks draw their own masks), or a model of MODELS, with ``weights``."""
    if name == "pro":
        return pro_model(device, weights, sfg_dropout=0.0)
    return canonical_model(device, weights, version=name)


def grid_inputs(tmp):
    """Seeded weights of every GRID_MODELS model and GRID_STEPS global
    batches of 4096 of each kind of rows, written for the ranks; returns
    them."""
    weights = {name: seeded_weights(grid_model(name, "cpu", None) if name == "pro"
                                    else canonical_model("cpu", seeded=False, version=name))
               for name in GRID_MODELS}
    data = {kind: train_data(np.random.default_rng(SEED + 50), GRID_STEPS * TRAIN_BATCH,
                             version=kind) for kind in ("xdeepfm", "dien")}
    flat = {f"{name}/{k}": v for name, w in weights.items() for k, v in flatten_tree(w)}
    np.savez(os.path.join(tmp, "weights.npz"), **flat)
    np.savez(os.path.join(tmp, "batches.npz"),
             **{f"{kind}/y": y for kind, (_, y) in data.items()},
             **{f"{kind}/x/{k}": v for kind, (x, _) in data.items() for k, v in x.items()})
    return weights, data


def grid_read_inputs(tmp):
    with np.load(os.path.join(tmp, "weights.npz")) as f:
        flat = {k: f[k] for k in f.files}
    weights = {}
    for name in GRID_MODELS:
        tree = unflatten_tree({k[len(name) + 1:]: v for k, v in flat.items()
                               if k.startswith(name + "/")})
        weights[name] = {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}
    data = {}
    with np.load(os.path.join(tmp, "batches.npz")) as f:
        for kind in ("xdeepfm", "dien"):
            data[kind] = ({k[len(kind) + 3:]: f[k] for k in f.files
                           if k.startswith(f"{kind}/x/")}, f[f"{kind}/y"])
    return weights, data


def grid_fit_stream(x, y):
    """The stream of the grid's fit_stream: the first two batches of 4096 an
    epoch; the third validates."""
    return lambda epoch: [({k: v[i : i + TRAIN_BATCH] for k, v in x.items()},
                           y[i : i + TRAIN_BATCH]) for i in (0, TRAIN_BATCH)]


def grid_fit_histories(model, x, y):
    """{"fit": History, "fit_stream": History} of ``model`` (compiled, and on
    its grid where it is on one); fit_stream continues from fit's weights."""
    out = {"fit": model.fit(x, y, **GRID_FIT).history}
    val = ({k: v[2 * TRAIN_BATCH :] for k, v in x.items()}, y[2 * TRAIN_BATCH :])
    out["fit_stream"] = model.fit_stream(grid_fit_stream(x, y), epochs=2, verbose=1,
                                         validation_data=val).history
    return {k: {m: [float(v) for v in vals] for m, vals in h.items()} for k, h in out.items()}


def grid_compile(model, optimizer, kw):
    model.compile(optimizer, "binary_crossentropy", **kw)
    model._dropout_gen = model._dropout_generator()
    return model


def grid_state(model):
    """(the module's state, its tables gathered over ``embed``; the lazy row
    states, gathered) on the host: collective, every rank calls it."""
    from xdeepfm_tpu_torch.parallel.mesh import all_gather_rows

    state = dict(model.module.state_dict())
    for key in model._shards:
        state[key] = all_gather_rows(state[key], model._grid, "embed")
    return ({k: v.detach().cpu().clone() for k, v in state.items()},
            {k: v.cpu().clone() for k, v in model._lazy_state().items()})


def grid_moments(model):
    """{state key: Adam's first moment} of a one-process model: the dense
    optimizer's and the lazy row states' m."""
    named = {id(p): k for k, p in model.module.named_parameters()}
    out = {named[id(p)]: st["exp_avg"].detach().cpu() for p, st in model.optimizer.state.items()
           if "exp_avg" in st}
    for path, st in model._lazy_state().items():
        key = path.replace("/", ".")
        out[key] = st[:, : model.module.get_parameter(key).shape[1]].cpu()
    return out


def grid_local_hashes(model):
    """sha1 of every array this rank holds: its replicated parameters, its
    shards and lazy arrays."""
    import hashlib

    arrays = dict(model.module.named_parameters())
    for i, g in enumerate(model._lazy["groups"] if model._lazy else ()):
        arrays[f"lazy_array_{i}"] = g["array"]
    return {k: hashlib.sha1(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in arrays.items()}


def grid_close(label, got, want, moments, steps, lr):
    """Raise unless ``got`` matches ``want`` (host state dicts) within the
    lazy tolerances, but for at most MAX_HELD_FLIPS held entries, each within
    ``steps`` Adam steps of lr: a sum over ranks rounds otherwise than one
    process's, and Adam moves an entry by about lr whatever its gradient's
    size, so an entry whose gradient is rounding noise, or sits behind a
    relu input that the two runs' rounding puts on opposite sides of 0, may
    part the runs by up to lr a step.  SGD (``moments`` empty) holds none.
    Returns (largest difference, held entries, of them with a first moment
    (the one process's) above ADAM_NOISE of its tensor's largest)."""
    worst, held, firm = 0.0, 0, 0
    for k, w in want.items():
        diff = (got[k].float() - w.float()).abs()
        worst = max(worst, float(diff.max()))
        off = diff > LAZY_W_ATOL + LAZY_W_RTOL * w.abs()
        if not off.any():
            continue
        m = moments.get(k)
        if m is None or float(diff[off].max()) > steps * lr:
            raise AssertionError(f"{label}: {k}: {int(off.sum())} entries off the one-process "
                                 f"step by up to {float(diff[off].max())}")
        held += int(off.sum())
        firm += int((off & (m.abs() > ADAM_NOISE * m.abs().max())).sum())
    if held > MAX_HELD_FLIPS:
        raise AssertionError(f"{label}: {held} entries held, above {MAX_HELD_FLIPS}")
    return worst, held, firm


# A relu input within rounding of 0 that the grid's and the one process's
# sums put on opposite sides moves its sample's table gradients by ~1e-2 of
# their largest (the CIN's relus, see RELU_BAND), and Adam's m keeps a tenth
# of that: at most this share of a lazy row state may leave the lazy
# tolerances, each entry within a tenth of the state's largest.
GRID_STATE_OFF_SHARE = 1e-4


def grid_states_close(label, got, want):
    """The lazy row states against the one process's: entries past the lazy
    state tolerances at most GRID_STATE_OFF_SHARE of each state, each within
    a tenth of its largest.  Returns {path: (entries off, largest
    difference)}."""
    out = {}
    for path, w in want.items():
        diff = (got[path] - w).abs()
        off = diff > 1e-3 * w.abs() + LAZY_STATE_ATOL * float(w.abs().max())
        out[path] = (int(off.sum()), float(diff.max()))
        if off.sum() > GRID_STATE_OFF_SHARE * w.numel() or \
                float(diff.max()) > 0.1 * float(w.abs().max()):
            raise AssertionError(f"{label}: row state {path}: {out[path][0]} entries off the "
                                 f"one-process run, up to {out[path][1]}")
    return out


def grid_rank_main(world, rank, port, tmp, backend):
    """One rank of a grid world: the collectives on CUDA tensors, then every
    case of GRID_CASES of this world size (the steps, launches, step ms,
    local hashes; rank 0 the gathered state), and on the 4-rank world the
    Scorer and the asynchronous checkpoint round trip."""
    import torch.distributed as dist

    from xdeepfm_tpu_torch.parallel import make_mesh, shard_batch, shard_model_state
    from xdeepfm_tpu_torch.parallel.distributed import initialize
    from xdeepfm_tpu_torch.parallel.mesh import set_active_mesh
    from xdeepfm_tpu_torch.parallel.sharded_embedding import set_embedding_mode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # gloo ranks share card 0; NCCL ranks take a card each
    dev = torch.device("cuda", rank % torch.cuda.device_count() if backend == "nccl" else 0)
    if world > 1:
        initialize(f"localhost:{port}", world, rank, backend=backend, device=dev)
    else:  # initialize is a no-op for one process: the one-rank NCCL group by hand
        torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=1,
                                rank=0)
    out = {"world": world, "rank": rank, "backend": dist.get_backend()}
    # which collectives the backend takes on CUDA tensors
    checks = {}
    n = world
    for name, fn in (
            ("all_reduce", lambda t: dist.all_reduce(t)),
            ("broadcast", lambda t: dist.broadcast(t, 0)),
            ("all_gather", lambda t: dist.all_gather([torch.empty_like(t) for _ in range(n)], t)),
            ("all_to_all_single_split_sizes", lambda t: dist.all_to_all_single(
                t.new_empty(sum(range(1, n + 1))), t.new_ones(n * (rank + 1)),
                output_split_sizes=list(range(1, n + 1)),
                input_split_sizes=[rank + 1] * n))):
        try:
            fn(torch.arange(4, dtype=torch.float32, device=dev) + rank)
            torch.cuda.synchronize()
            checks[name] = "ok"
        except Exception as e:  # reported, and the phase fails
            checks[name] = f"{type(e).__name__}: {e}"[:300]
    out["collectives"] = checks
    mesh = make_mesh(device=dev)
    out["grid"] = [mesh.shape["data"], mesh.shape["embed"]]
    weights, data = grid_read_inputs(tmp)

    def rank_batches(model, kind="xdeepfm"):
        x, y = data[kind]
        packed = model.schema.pack(x)
        yy = y[:, None]
        batches = []
        for i in range(GRID_STEPS):
            sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
            b = shard_batch(dict({k: v[sl] for k, v in packed.items()}, _y=yy[sl],
                                 _m=np.ones(TRAIN_BATCH, np.float32)), mesh)
            batches.append((b, b.pop("_y"), b.pop("_m")))
        return batches

    def on_grid(name, optimizer, kw, mode, comm):
        model = grid_compile(grid_model(name, dev, weights[name]), optimizer, kw)
        shard_model_state(model, mesh)
        set_embedding_mode(mode, mesh, comm_dtype=comm)
        model._dropout_gen = model._dropout_generator()
        return model

    for label, (w, name, optimizer, kw, mode, comm, steps) in GRID_CASES.items():
        if w != world:
            continue
        model = on_grid(name, optimizer, kw, mode, comm)
        batches = rank_batches(model, grid_data_kind(name))
        reset_launches()
        totals, step_ms = [], []
        for xb, yb, mb in batches[:steps]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            total, _ = model._train_step(xb, yb, mb, with_metrics=False)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            totals.append(float(total))
        launches = read_launches()
        state = grid_state(model)
        out[label] = dict(totals=totals, step_ms=step_ms, launches=launches,
                          rows_per_rank=int(batches[0][1].shape[0]),
                          hashes=grid_local_hashes(model),
                          shards=sorted(model._shards))
        if rank == 0:
            torch.save(state, os.path.join(tmp, f"{label}.pt"))
        del model
        set_embedding_mode("gspmd", None)
        set_active_mesh(None)

    if world == 4:
        # Scorer(8192) on the sharded model (all_to_all: 2048 rows a rank)
        model = on_grid("xdeepfm", "adam", {}, "all_to_all", None)
        reqs = requests(np.random.default_rng(SEED + 51), REQUESTS)
        scorer = Scorer(model, batch_size=BATCH).warmup()
        reset_launches()
        preds, eps, ms = score_all(scorer, reqs)
        out["grid_scoring"] = dict(examples_per_s=eps, ms=ms, launches=read_launches(),
                                   rows_per_rank=BATCH // 4)
        if rank == 0:
            np.savez(os.path.join(tmp, "grid_scoring.npz"), *preds)
        set_embedding_mode("gspmd", None)
        # save_checkpoint_sharded(block=False), a step during the write,
        # load_checkpoint_sharded into a fresh grid model, the same step
        model = on_grid("xdeepfm", "adam", GRID_LAZY_SPLIT, "shard_map", None)
        (b0, y0, m0), (b1, y1, m1) = rank_batches(model)[:2]
        model._train_step(b0, y0, m0, with_metrics=False)
        ckpt = os.path.join(tmp, "grid_ckpt")
        t0 = time.perf_counter()
        model.save_checkpoint_sharded(ckpt, epoch=1, block=False)
        save_ms = (time.perf_counter() - t0) * 1e3
        straight = float(model._train_step(b1, y1, m1, with_metrics=False)[0])
        model.wait_for_checkpoints()
        fresh = on_grid("xdeepfm", "adam", GRID_LAZY_SPLIT, "shard_map", None)
        epoch = fresh.load_checkpoint_sharded(ckpt)
        resumed = float(fresh._train_step(b1, y1, m1, with_metrics=False)[0])
        out["grid_checkpoint"] = dict(
            epoch=epoch, straight_total=straight, resumed_total=resumed,
            save_call_ms=save_ms, straight_hashes=grid_local_hashes(model),
            resumed_hashes=grid_local_hashes(fresh))
        set_embedding_mode("gspmd", None)
        set_active_mesh(None)
        del model, fresh
        # fit and fit_stream on the grid (all_to_all), each rank its slice
        model = grid_model("xdeepfm", dev, weights["xdeepfm"])
        model.compile("adam", "binary_crossentropy", metrics=GRID_FIT_METRICS)
        shard_model_state(model, mesh)
        set_embedding_mode("all_to_all", mesh)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        histories = grid_fit_histories(model, *data["xdeepfm"])
        torch.cuda.synchronize()
        out["grid_fit"] = dict(histories=histories, launches=read_launches(),
                               seconds=time.perf_counter() - t0)
        set_embedding_mode("gspmd", None)
        set_active_mesh(None)
    with open(os.path.join(tmp, f"rank_w{world}_r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def grid_spawn(tmp, worlds):
    """Run the ranks of ``worlds`` ({world size: backend}) at once; every
    process is waited for or killed; raises with a failed rank's log."""
    procs = []
    for world, backend in worlds.items():
        port = _free_port()
        for rank in range(world):
            log = open(os.path.join(tmp, f"log_w{world}_r{rank}.txt"), "w")
            procs.append((world, rank, log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--grid-rank", str(world), str(rank),
                 str(port), tmp, backend], stdout=log, stderr=subprocess.STDOUT)))
    deadline = time.time() + GRID_TIMEOUT
    try:
        for _, _, _, p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for world, rank, _, p in procs:
        if p.returncode != 0:
            with open(os.path.join(tmp, f"log_w{world}_r{rank}.txt")) as f:
                raise AssertionError(f"grid rank {rank} of {world} failed "
                                     f"(rc {p.returncode}):\n{f.read()[-4000:]}")
    ranks = {}
    for world in worlds:
        ranks[world] = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank_w{world}_r{rank}.json")) as f:
                ranks[world].append(json.load(f))
    return ranks


def phase_sharded(per_gpu=False):
    """The rank grid on the card: 4 ranks on a (data 2, embed 2) grid and 2
    on a (1, 2) grid, co-located on one card over gloo on CUDA tensors, and
    a one-rank NCCL group; the canonical xDeepFM at full width (26 x 10 000
    rows, dim 10, CIN (256, 128), DNN (256, 256), global batch 4096) trained
    GRID_STEPS steps per case of GRID_CASES (Pro at 2): every rank's
    parameters after ``get_weights``-style gathering against the one-process
    run on the card (:func:`grid_close`; the one-rank NCCL group bit for
    bit), replicated arrays bit-equal on every rank and each shard on its
    data replicas, the kernels launched on every rank; the Scorer against
    the one-process scorer; an asynchronous sharded checkpoint, a step
    during its write, and the resumed step bit-equal to the un-interrupted
    one.  Step ms are co-located ranks on one card, not a scaling figure.
    ``per_gpu``: every world over NCCL, a rank a card (needs 4 cards)."""
    tmp = tempfile.mkdtemp(prefix="xdeepfm-grid-")
    weights, data = grid_inputs(tmp)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    # the one-process references on the card
    refs = {}
    for label, (_, name, optimizer, kw, _, _, steps) in GRID_CASES.items():
        key = (name, optimizer, tuple(sorted(kw.items())), steps)
        if key in refs:
            continue
        model = grid_compile(grid_model(name, "cuda", weights[name]), optimizer, kw)
        mask = torch.ones(TRAIN_BATCH, device="cuda")
        x, y = data[grid_data_kind(name)]
        totals = []
        for i in range(steps):
            xb, yb = device_batch(model, {k: v[i * TRAIN_BATCH :] for k, v in x.items()},
                                  y[i * TRAIN_BATCH :], TRAIN_BATCH)
            totals.append(float(model._train_step(xb, yb, mask, with_metrics=False)[0]))
        refs[key] = (totals, grid_state(model), grid_moments(model),
                     model.optimizer.param_groups[0]["lr"] if not model._lazy
                     else model._lazy["lr"])
        del model
    one = Scorer(canonical_model("cuda", weights["xdeepfm"]), batch_size=BATCH)
    want_scores = [one.score(r) for r in requests(np.random.default_rng(SEED + 51), REQUESTS)]
    one = canonical_model("cuda", weights["xdeepfm"])
    one.compile("adam", "binary_crossentropy", metrics=GRID_FIT_METRICS)
    want_fit = grid_fit_histories(one, *data["xdeepfm"])
    fit_steps = GRID_FIT["epochs"] * (-(-int(len(data["xdeepfm"][1]) * 0.8) // TRAIN_BATCH) + 2)
    del one
    torch.cuda.empty_cache()

    t0 = time.time()
    multi = "nccl" if per_gpu else "gloo"
    timing = ("one rank a card over NCCL, not a scaling figure" if per_gpu else
              "co-located ranks on one card, not a scaling figure")
    ranks = grid_spawn(tmp, {4: multi})
    t4 = time.time() - t0
    ranks.update(grid_spawn(tmp, {2: multi, 1: "nccl"}))
    t21 = time.time() - t0 - t4
    records = {}
    for label, (world, name, optimizer, kw, mode, comm, steps) in GRID_CASES.items():
        rs = ranks[world]
        totals, want, moments, lr = refs[(name, optimizer, tuple(sorted(kw.items())), steps)]
        got = torch.load(os.path.join(tmp, f"{label}.pt"))
        for r in rs:
            if r["collectives"] != {k: "ok" for k in r["collectives"]}:
                raise AssertionError(f"{label}: rank {r['rank']}: collectives {r['collectives']}")
            if r[label]["totals"] != rs[0][label]["totals"]:
                raise AssertionError(f"{label}: the ranks' totals differ")
            want_launches = expected(**{k: v * steps for k, v in
                                        GRID_STEP_LAUNCHES[name].items()})
            if r[label]["launches"] != want_launches:
                raise AssertionError(f"{label}: rank {r['rank']} launched {r[label]['launches']}, "
                                     f"expected {want_launches}")
        # replicas: a replicated array on every rank, a shard on its data
        # replicas (the ranks of one embed index)
        shards = set(rs[0][label]["shards"]) | {k for k in rs[0][label]["hashes"]
                                                if k.startswith("lazy_array")}
        E = 1 if world == 1 else 2
        for k in rs[0][label]["hashes"]:
            for r in rs:
                peer = rs[r["rank"] % E] if k in shards else rs[0]
                if r[label]["hashes"][k] != peer[label]["hashes"][k]:
                    raise AssertionError(f"{label}: {k} differs between ranks {r['rank']} and "
                                         f"{peer['rank']}")
        got_total = rs[0][label]["totals"]
        rec = dict(world=world, grid=rs[0]["grid"], backend=rs[0]["backend"],
                   ranks_per_card=1 if per_gpu else world, model=name, optimizer=optimizer,
                   mode=mode,
                   comm_dtype=comm, steps=steps, lazy=dict(kw),
                   rows_per_rank=rs[0][label]["rows_per_rank"],
                   totals=got_total, one_process_totals=totals,
                   launches_per_rank=[{k: v for k, v in r[label]["launches"].items() if v}
                                      for r in rs],
                   step_ms_per_rank=[r[label]["step_ms"] for r in rs],
                   examples_per_s_global=TRAIN_BATCH / (max(
                       float(np.mean(r[label]["step_ms"][1:] or r[label]["step_ms"]))
                       for r in rs) / 1e3),
                   timing=timing, card=smi, replicas_bit_equal=True,
                   sharded=rs[0][label]["shards"])
        if world == 1:
            equal = all(torch.equal(got[0][k], want[0][k]) for k in want[0])
            if got_total != totals or not equal:
                raise AssertionError(f"{label}: the one-rank NCCL step is not the one-process "
                                     f"step bit for bit (totals {got_total} vs {totals})")
            rec["bit_equal_to_one_process"] = True
        elif comm is not None:
            # bf16 rows on the wire: the lookups round to bf16, so the step
            # is held against the fp32 one loosely: the loss within 1e-2, no
            # entry past steps Adam steps of lr
            diff = max(float((got[0][k] - want[0][k]).abs().max()) for k in want[0])
            rel = max(abs(a - b) / abs(b) for a, b in zip(got_total, totals))
            if rel > 1e-2 or diff > 2 * steps * lr:
                raise AssertionError(f"{label}: bf16 wire: loss {rel} relative, weights {diff}")
            rec.update(max_abs_diff_vs_fp32_one_process=diff, loss_rel_diff_vs_fp32=rel)
        else:
            np.testing.assert_allclose(got_total, totals, rtol=1e-5, err_msg=label)
            worst, held, firm = grid_close(label, got[0], want[0], moments, steps, lr)
            rec.update(max_abs_diff_vs_one_process=worst, held_entries=held,
                       held_entries_not_noise=firm, row_states_off=grid_states_close(
                           label, got[1], want[1]))
        records[label] = rec
        emit(phase="sharded", path=label, **rec)
    # the Scorer
    rs = ranks[4]
    with np.load(os.path.join(tmp, "grid_scoring.npz")) as f:
        got_scores = [f[f"arr_{i}"] for i in range(len(REQUESTS))]
    score_err = max(float(np.abs(a - b).max()) for a, b in zip(got_scores, want_scores))
    if score_err > 1e-5:
        raise AssertionError(f"grid scores differ from the one-process scorer's by {score_err}")
    n_batches = sum(-(-n // BATCH) for n in REQUESTS)
    for r in rs:
        if r["grid_scoring"]["launches"] != expected(cin_fwd=2 * n_batches):
            raise AssertionError(f"grid scoring: rank {r['rank']} launched "
                                 f"{r['grid_scoring']['launches']}")
    scoring = dict(world=4, grid=rs[0]["grid"], backend=rs[0]["backend"],
                   ranks_per_card=1 if per_gpu else 4,
                   mode="all_to_all", max_abs_diff_vs_one_process=score_err,
                   launches_per_rank=[{k: v for k, v in r["grid_scoring"]["launches"].items()
                                       if v} for r in rs],
                   examples_per_s=[r["grid_scoring"]["examples_per_s"] for r in rs],
                   rows_per_rank=rs[0]["grid_scoring"]["rows_per_rank"], timing=timing,
                   card=smi)
    emit(phase="sharded", path="grid_scoring", **scoring)
    # the asynchronous checkpoint
    ck = [r["grid_checkpoint"] for r in rs]
    for c in ck:
        if c["epoch"] != 1 or c["resumed_total"] != c["straight_total"] or \
                c["resumed_hashes"] != c["straight_hashes"]:
            raise AssertionError(f"grid checkpoint: the resumed step is not the un-interrupted "
                                 f"one: {c['resumed_total']} vs {c['straight_total']}")
    emit(phase="sharded", path="grid_checkpoint", world=4, grid=rs[0]["grid"],
         resumed_bit_equal=True, total=ck[0]["straight_total"],
         save_call_ms_per_rank=[c["save_call_ms"] for c in ck], card=smi)
    # fit and fit_stream: every rank's History against the one process's
    # (Adam's rtol 1e-4, as tests/test_torch_port_distributed.py holds them);
    # each train step launches the CIN's 2 + 2 + 2 on every rank
    fit_err = 0.0
    for r in rs:
        got = r["grid_fit"]["histories"]
        for case, want_h in want_fit.items():
            if sorted(got[case]) != sorted(want_h):
                raise AssertionError(f"grid {case}: History keys {sorted(got[case])}")
            for k, w in want_h.items():
                np.testing.assert_allclose(got[case][k], w, rtol=1e-4, atol=1e-6,
                                           err_msg=f"grid {case}: {k}")
                fit_err = max(fit_err, float(np.max(np.abs(np.subtract(got[case][k], w)))))
        launches, want = r["grid_fit"]["launches"], expected(
            cin_fwd=2 * fit_steps, cin_bwd_dx=2 * fit_steps, cin_dw=2 * fit_steps)
        if any(launches[k] != want[k] for k in ("cin_bwd_dx", "cin_dw")) or \
                launches["cin_fwd"] < want["cin_fwd"]:  # and the validation batches
            raise AssertionError(f"grid fit: rank {r['rank']} launched {launches} over "
                                 f"{fit_steps} steps")
    grid_fit = dict(world=4, grid=rs[0]["grid"], mode="all_to_all", train_steps=fit_steps,
                    histories=rs[0]["grid_fit"]["histories"], one_process_histories=want_fit,
                    max_abs_diff_vs_one_process=fit_err,
                    launches_per_rank=[{k: v for k, v in r["grid_fit"]["launches"].items() if v}
                                       for r in rs],
                    seconds_per_rank=[r["grid_fit"]["seconds"] for r in rs], timing=timing,
                    card=smi)
    emit(phase="sharded", path="grid_fit", **grid_fit)
    emit(phase="sharded_summary", backend_world4=multi,
         collectives_on_cuda_world4=ranks[4][0]["collectives"],
         collectives_on_cuda_nccl_one_rank=ranks[1][0]["collectives"], seconds_world4=t4,
         seconds_world2_and_nccl=t21, card=smi)
    shutil.rmtree(tmp, ignore_errors=True)
    paths = {label: {k: sum(r[label]["launches"][k] for r in ranks[rec["world"]])
                     for k in WRAPPERS} for label, rec in records.items()}
    paths["grid_scoring"] = {k: sum(r["grid_scoring"]["launches"][k] for r in rs)
                             for k in WRAPPERS}
    paths["grid_fit"] = {k: sum(r["grid_fit"]["launches"][k] for r in rs) for k in WRAPPERS}
    return records, paths


# Compiled dispatch (xdeepfm_tpu_torch/dispatch.py): fit(steps_per_dispatch=K)
# as CUDA graphs of K chained train steps, predict and the Scorer as graphs
# of their forwards.  One epoch of GRAPH_STEPS steps: its first group of K
# runs eagerly (the warm-up), the second is captured and replayed, the third
# replays; a second fit replays all three.
GRAPH_K = 8
GRAPH_STEPS = 24
GRAPH_MODES = (  # (label, compile keywords, CIN precision)
    ("dense_adam", {}, "f32"),
    ("lazy_adam", dict(embedding_optimizer="lazy"), "f32"),  # split, packed
    ("cin_bf16", {}, "bf16"),
)
# the hand-written kernels' names, as the profiler lists them
KERNEL_NAMES = sorted({m for src in {s for s, _ in SOURCES.values()}
                       for m in re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)",
                                           open(src).read())})


def own_kernel_counts(prof):
    """{kernel name: records} of the hand-written kernels in a profile."""
    counts = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in KERNEL_NAMES:
            if re.search(r"\b" + name + r"[<(]", e.name):
                counts[e.name[:80]] = counts.get(e.name[:80], 0) + 1
    return counts


def flat_state(model):
    """The canonical weights, and under the lazy optimizer the row states,
    as {key: numpy array}."""
    out = dict(model._weights_flat())
    out.update({f"lazy/{k}": v.cpu().numpy() for k, v in model._lazy_state().items()})
    return out


def states_equal(label, a, b):
    """Raise unless two flat states are equal to the bit."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"{label}: the states hold other keys")
    off = [k for k in a if not np.array_equal(a[k], b[k])]
    if off:
        worst = max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in off)
        raise AssertionError(f"{label}: {len(off)} arrays differ (max {worst}), e.g. {off[:4]}")


def graph_fits(label, models, x, y, val, step_launches):
    """``fit`` of GRAPH_STEPS steps with K = 1 (``models[0]``, eager) and K =
    GRAPH_K (``models[1]``) from the same weights: the weights and the
    history equal to the bit, each model's launch counts GRAPH_STEPS times
    ``step_launches`` (and the validation forwards); then a second fit of
    each, timed, and a third, profiled: wall, busy and idle ms a step, the
    replays' kernel records against the eager steps' and the counters.
    Models without validation data skip the first check's validation."""
    fit_kw = dict(batch_size=TRAIN_BATCH, epochs=1, verbose=1, shuffle=True)
    hist, launches, replays = [], [], []
    for model, k in zip(models, (1, GRAPH_K)):
        reset_launches()
        hist.append(model.fit(x, y, steps_per_dispatch=k, validation_data=val,
                              **fit_kw).history)
        launches.append(read_launches())
    if hist[0] != hist[1]:
        raise AssertionError(f"{label}: K={GRAPH_K} history {hist[1]} is not K=1's {hist[0]}")
    states_equal(f"{label}: K={GRAPH_K} against K=1 after one fit", *map(flat_state, models))
    val_fwd = launches[0]["cin_fwd"] + launches[0]["cin_fwd_bf16"] - GRAPH_STEPS * (
        step_launches.get("cin_fwd", 0) + step_launches.get("cin_fwd_bf16", 0))
    want = expected(**{n: GRAPH_STEPS * c for n, c in step_launches.items()})
    want["cin_fwd_bf16" if "cin_fwd_bf16" in step_launches else "cin_fwd"] += val_fwd
    for counts in launches:
        if counts != want or val_fwd != 2:
            raise AssertionError(f"{label}: launches {launches}, expected {want} (2 validation)")
    rec = dict(history=hist[0], launches=launches[1], captures=models[1]._graphs.captures)
    timing = {}
    for model, k, name in zip(models, (1, GRAPH_K), ("eager", "graph")):
        torch.cuda.synchronize()
        before = model._graphs.replays
        reset_launches()
        t0 = time.perf_counter()
        model.fit(x, y, steps_per_dispatch=k, **fit_kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        replays.append(model._graphs.replays - before)
        counts = read_launches()
        if counts != expected(**{n: GRAPH_STEPS * c for n, c in step_launches.items()}):
            raise AssertionError(f"{label}: {name} fit launched {counts}")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.fit(x, y, steps_per_dispatch=k, **fit_kw)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        br = device_breakdown(prof, prof_wall, GRAPH_STEPS)
        timing[name] = dict(wall_ms_per_step=wall / GRAPH_STEPS,
                            examples_per_s=GRAPH_STEPS * TRAIN_BATCH / wall * 1e3,
                            profiled_wall_ms_per_step=br["wall_ms_per_call"],
                            busy_ms_per_step=br["device_busy_ms_per_call"],
                            idle_share=br["device_idle_share"],
                            top_device_ms_per_step=br["top_device_ms_per_call"][:6],
                            kernel_records=own_kernel_counts(prof))
    if replays != [0, GRAPH_STEPS // GRAPH_K]:
        raise AssertionError(f"{label}: replays {replays} in the second fits, expected "
                             f"[0, {GRAPH_STEPS // GRAPH_K}]")
    eager_rec, graph_rec = timing["eager"]["kernel_records"], timing["graph"]["kernel_records"]
    if eager_rec != graph_rec or not graph_rec:
        raise AssertionError(f"{label}: the replays ran kernels {graph_rec}, the eager steps "
                             f"{eager_rec}")
    per_replay = {n: c / replays[1] for n, c in graph_rec.items()}
    per_step = {n: c / GRAPH_STEPS for n, c in eager_rec.items()}
    if any(per_replay[n] != GRAPH_K * per_step[n] for n in per_step):
        raise AssertionError(f"{label}: {per_replay} kernels a replay, {per_step} a step")
    states_equal(f"{label}: K={GRAPH_K} against K=1 after three fits",
                 *map(flat_state, models))
    rec.update(replays_in_second_fit=replays[1], kernel_records_per_replay=per_replay,
               **timing)
    return rec


def graph_train_data(seed):
    rng = np.random.default_rng(seed)
    x, y = train_data(rng, GRAPH_STEPS * TRAIN_BATCH + TRAIN_BATCH // 2)
    return ({k: v[: -TRAIN_BATCH // 2] for k, v in x.items()}, y[: -TRAIN_BATCH // 2],
            ({k: v[-TRAIN_BATCH // 2 :] for k, v in x.items()}, y[-TRAIN_BATCH // 2 :]))


def phase_graph_training():
    """The canonical xDeepFM at batch 4096 with Adam, ``fit`` of GRAPH_STEPS
    steps at K = GRAPH_K against K = 1 from the same seeded weights, dense,
    lazy (split, packed: the lazy step count advances inside a graph) and
    under ``set_cin_precision("bf16")`` (:func:`graph_fits`)."""
    x, y, val = graph_train_data(SEED + 11)
    out = {}
    for label, compile_kw, precision in GRAPH_MODES:
        set_cin_precision(precision)
        try:
            models = [canonical_model("cuda") for _ in range(2)]
            for m in models:
                m.compile("adam", "binary_crossentropy", metrics=["auc"], **compile_kw)
            step = (dict(cin_fwd_bf16=2, cin_round_g_bf16=2, cin_bwd_dx_bf16=2, cin_dw=2)
                    if precision == "bf16" else dict(cin_fwd=2, cin_bwd_dx=2, cin_dw=2))
            out[label] = graph_fits(f"graph_training {label}", models, x, y, val, step)
        finally:
            set_cin_precision("f32")
        del models
        torch.cuda.empty_cache()
    emit(phase="graph_training", k=GRAPH_K, steps=GRAPH_STEPS, batch=TRAIN_BATCH, **out)
    return out


def phase_graph_pro_training():
    """The canonical xDeepFMPro (SFG dropout 0.1, drawn from the fit's
    generator) with the CE in its bf16 mode, K = GRAPH_K against K = 1
    (:func:`graph_fits`)."""
    x, y, val = graph_train_data(SEED + 12)
    ce.set_precision("bf16")
    try:
        first = pro_model("cuda")
        models = [first, pro_model("cuda", first.get_weights())]
        for m in models:
            m.compile("adam", "binary_crossentropy", metrics=["auc"])
        rec = graph_fits("graph_pro_training", models, x, y, val, PRO_CE_BF16_STEP)
    finally:
        ce.set_precision("fp32")
    emit(phase="graph_pro_training", k=GRAPH_K, steps=GRAPH_STEPS, batch=TRAIN_BATCH,
         ce_precision="bf16", **rec)
    return rec


def eager_score(model, x):
    """``Scorer.score`` through the eager forward (``_predict_step``)."""
    batch = model._pack_x(x)
    n = len(next(iter(batch.values())))
    out = []
    for start in range(0, n, BATCH):
        xb = {k: v[start : start + BATCH] for k, v in batch.items()}
        bs = len(next(iter(xb.values())))
        xb = {k: np.concatenate([v, np.repeat(v[-1:], BATCH - bs, axis=0)]) for k, v in xb.items()}
        out.append(model._predict_step(xb)[:bs])
    return torch.cat(out).cpu().numpy().astype("float64")


def phase_graph_serving():
    """``Scorer(8192)`` over the canonical xDeepFM: ``warmup`` captures the
    graph, so the first request replays it; the graph against the eager
    forward on the same requests, equal to the bit; then
    ``load_weights`` of other weights, and the graph's scores, with no new
    capture, against the eager scores under them; wall, busy and idle ms a
    batch of each."""
    model = canonical_model("cuda")
    scorer = Scorer(model, batch_size=BATCH).warmup()
    if model._graphs.captures != 1:
        raise AssertionError(f"graph_serving: warmup made {model._graphs.captures} captures")
    reqs = requests(np.random.default_rng(SEED + 13), REQUESTS)
    n_batches = sum(-(-n // BATCH) for n in REQUESTS)
    reset_launches()
    graph = [scorer.score(reqs[0])]
    if model._graphs.captures != 1:
        raise AssertionError("graph_serving: the first request after warmup captured a graph")
    graph += [scorer.score(r) for r in reqs[1:]]
    if read_launches() != expected(cin_fwd=2 * n_batches):
        raise AssertionError(f"graph_serving: launches {read_launches()}")
    eager = [eager_score(model, r) for r in reqs]
    if not all(np.array_equal(a, b) for a, b in zip(graph, eager)):
        raise AssertionError("graph_serving: the graph's scores are not the eager forward's")
    captures = model._graphs.captures
    other = canonical_model("cuda", seeded=False)  # the model's own initialisation
    with tempfile.TemporaryDirectory() as d:
        other.save_weights(os.path.join(d, "w.npz"))
        model.load_weights(os.path.join(d, "w.npz"))
    reloaded = [scorer.score(r) for r in reqs]
    eager_reloaded = [eager_score(model, r) for r in reqs]
    if not all(np.array_equal(a, b) for a, b in zip(reloaded, eager_reloaded)):
        raise AssertionError("graph_serving: after load_weights the graph's scores are not "
                             "the eager forward's")
    if not all(np.array_equal(a, b) for a, b in zip(reloaded, [other.predict(r, BATCH)
                                                               for r in reqs])):
        raise AssertionError("graph_serving: the reloaded scores are not the other model's")
    moved = max(float(np.abs(a - b).max()) for a, b in zip(graph, reloaded))
    if moved < 1e-3 or model._graphs.captures != captures:
        raise AssertionError(f"graph_serving: scores moved {moved} after load_weights, "
                             f"captures {captures} -> {model._graphs.captures}")
    timing = {}
    for name, fn in (("eager", lambda r: eager_score(model, r)), ("graph", scorer.score)):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in reqs:
                fn(r)
            ms.append((time.perf_counter() - t0) * 1e3 / n_batches)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for r in reqs:
                fn(r)
            prof_wall = (time.perf_counter() - t0) * 1e3
        br = device_breakdown(prof, prof_wall, n_batches)
        timing[name] = dict(wall_ms_per_batch=ms,
                            examples_per_s=[sum(REQUESTS) / n_batches / m * 1e3 for m in ms],
                            profiled_wall_ms_per_batch=br["wall_ms_per_call"],
                            busy_ms_per_batch=br["device_busy_ms_per_call"],
                            idle_share=br["device_idle_share"],
                            kernel_records=own_kernel_counts(prof))
    if timing["eager"]["kernel_records"] != timing["graph"]["kernel_records"]:
        raise AssertionError(f"graph_serving: kernel records {timing}")
    rec = dict(requests=list(REQUESTS), batches=n_batches, launches=expected(cin_fwd=2 * n_batches),
               max_abs_moved_by_reload=moved, captures=model._graphs.captures,
               replays=model._graphs.replays, **timing)
    emit(phase="graph_serving", **rec)
    return rec


def _times(n, ms):
    """``n`` launches' device ms, None where the profiler did not measure it."""
    return None if ms is None else n * ms


def _sum_measured(values):
    """The sum of device ms, None where one of them was not measured."""
    values = list(values)
    return None if None in values else sum(values)


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
    bf16_shapes = phase_cin_bf16_kernels(peak)
    ce_shapes = phase_ce_kernels(peak)
    ce_bf16_shapes = phase_ce_bf16_kernels(peak)
    attn_shapes = phase_attn_kernels(peak)
    attn_bf16_shapes = phase_attn_bf16_kernels(peak)
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
    autodis, autodis_m, autodis_batches = phase_pro_autodis()
    phase_train_profile(autodis_m, autodis_batches, phase="pro_autodis_train_profile")
    del autodis_m, autodis_batches
    torch.cuda.empty_cache()
    phase_flax_io()
    attn = {}
    for version in ("v1", "v2", "autoint", "difm", "dien"):
        rec, attn_m, attn_batches = phase_model_training(version)
        phase_train_profile(attn_m, attn_batches, phase=f"{PHASE[version]}_train_profile")
        attn[version] = rec, phase_model_scoring(attn_m, version)
        del attn_m, attn_batches
        torch.cuda.empty_cache()
    zoo = {}
    for model_name in ZOO:
        rec, zoo_m, zoo_batches = phase_zoo_training(model_name)
        phase_train_profile(zoo_m, zoo_batches, phase=f"zoo_{model_name}_train_profile")
        zoo[model_name] = rec, phase_zoo_scoring(zoo_m, model_name)
        del zoo_m, zoo_batches
        torch.cuda.empty_cache()
    phase_zoo_mixed_dims()
    variants = phase_zoo_variants()
    mt_variants = phase_mt_variants()
    mt_lazy = phase_mt_lazy()
    ccpm_tf32 = phase_ccpm_tf32()
    phase_zoo_determinism()
    dien_dice = phase_dien_dice()
    bf16 = phase_bf16()
    cin_bf16 = phase_cin_bf16_training()
    pro_ce_bf16 = phase_pro_ce_bf16_training()
    v2_bf16 = phase_v2_attn_bf16_training()
    phase_gather()
    graph_train = phase_graph_training()
    graph_pro = phase_graph_pro_training()
    graph_serve = phase_graph_serving()
    cli = phase_cli()
    examples = phase_examples()
    phase_lazy_checks()
    lazy_dien = phase_lazy_dien()
    lazy = phase_lazy104()
    _, grid_paths = phase_sharded()
    paths = {"training": training["launches"], "pro_training": pro["launches"],
             "pro_scoring": pro_scoring["launches"], "pro_autodis": autodis["launches"],
             "pro_autodis_scoring": autodis["scoring_launches"]}
    for version, (rec, scoring) in attn.items():
        paths[f"{PHASE[version]}_training"] = rec["launches"]
        paths[f"{PHASE[version]}_scoring"] = scoring["launches"]
    for model_name, (rec, scoring) in zoo.items():
        paths[f"zoo_{model_name}_training"] = rec["launches"]
        paths[f"zoo_{model_name}_scoring"] = scoring["launches"]
    paths["zoo_variants_sgd_step"] = variants["launches"]
    paths["mt_variants_sgd_step"] = mt_variants["launches"]
    paths["mt_lazy"] = mt_lazy["launches"]
    paths["zoo_ccpm_tf32_default"] = ccpm_tf32["launches"]
    paths["dien_dice_sgd_step"] = dien_dice["launches"]
    paths["bf16_training"] = bf16["launches"]
    paths["cin_bf16_training"] = cin_bf16["launches"]
    paths["cin_bf16_scoring"] = cin_bf16["scoring_launches"]
    paths["pro_ce_bf16_training"] = pro_ce_bf16["launches"]
    paths["v2_attn_bf16_training"] = v2_bf16["launches"]
    paths["v2_attn_bf16_scoring"] = v2_bf16["scoring_launches"]
    paths.update({f"graph_training_{label}": rec["launches"] for label, rec in graph_train.items()})
    paths["graph_pro_training"] = graph_pro["launches"]
    paths["graph_serving"] = graph_serve["launches"]
    paths.update({f"example_{name}": rec["launches"] for name, rec in examples.items()
                  if "launches" in rec})
    paths["ablation"] = ablation["launches"]
    paths.update({path: rec["launches"] for path, rec in cli.items()})
    paths.update({path: rec["launches"] for path, rec in lazy.items()})
    paths["lazy_dien_training"] = lazy_dien["launches"]
    paths.update(grid_paths)  # each summed over the path's ranks
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
    # rows 1-2's bf16 mode, on its train step (2 launches of each)
    for kname in ("cin_fwd_bf16", "cin_bwd_dx_bf16", "cin_round_g_bf16"):
        source, replaces = SOURCES[kname]
        path = [bf16_shapes[kname, label] for label, *_ in TRAIN_SHAPES]
        rnd = kname == "cin_round_g_bf16"
        ops_s = 0.0 if rnd else sum(r["gflop"] for r in path) * 1e9 / path[0]["peak_bf16_flops"]
        bytes_s = sum(r["mbytes"] for r in path) * 1e6 / peak[2]
        ms = sum(r["kernel_ms"] for r in path)
        bound = sum(r["bound_ms"] for r in path)
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=cin_bf16["launches"][kname],
            launches_by_path={p: counts[kname] for p, counts in paths.items()},
            max_abs_err=max(r["max_abs_err"] for (k, _), r in bf16_shapes.items() if k == kname),
            ms=ms, plain_ms=sum(r["plain_ms"] for r in path), bound_ms=bound,
            bound_by="operations" if ops_s >= bytes_s else "bytes",
            library_ms=sum(r["library_ms"] for r in path),
            bound_share=bound / ms,
            per="bf16 train step at batch 4096 (2 launches); " + (
                "bound by g's bytes" if rnd else "bound at the bf16 tensor-core peak"),
            device_ms=_sum_measured(r["device_ms"] for r in path),
            design=path[0]["design"],
            **({} if rnd else dict(
                fp32_kernel_device_ms=_sum_measured(r["fp32_kernel_device_ms"] for r in path),
                err_vs_float64=max(r["err_vs_float64"] for (k, _), r in bf16_shapes.items()
                                   if k == kname))),
            bit_equal=all(r["bit_equal"] for (k, _), r in bf16_shapes.items() if k == kname),
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
    # rows 4-7's bf16 mode on the Pro step (1 launch of each): the rounding
    # pass (bound by its bytes), the forward (by its exps), the backward
    for kname, kind in (("ce_round_bf16", "round"), ("ce_fwd_bf16", "fwd"),
                        ("ce_bwd_bf16", "bwd")):
        source, replaces = SOURCES[kname]
        r = ce_bf16_shapes[CE_PATH_SHAPE]
        rnd = kind == "round"
        ms = r[f"{kind}_kernel_ms" if kind == "fwd" else f"{kind}_ms"]
        bound = r["round_bound_ms" if rnd else f"{kind}_bound_ms"]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=pro_ce_bf16["launches"][kname],
            launches_by_path={path: counts[kname] for path, counts in paths.items()},
            max_abs_err=0.0 if rnd else max(x[f"{kind}_max_abs_err"]
                                            for x in ce_bf16_shapes.values()),
            ms=ms, plain_ms=r[f"plain_{kind}_ms"], bound_ms=bound,
            bound_by="bytes" if rnd else r[f"{kind}_bound_by"],
            library_ms=None if rnd else r[f"library_{kind}_ms"],
            bound_share=bound / ms if ms > 0 else 0.0,
            per=f"Pro train step at batch 4096 in the bf16 mode, {r['F']} stacked heads, "
                f"{r['num_valid']} valid rows (1 launch)" + (
                    "; no library call rounds into the kernels' tiles" if rnd else
                    "; bound at the bf16 tensor-core peak and the exp rate"),
            **({} if rnd else dict(
                mma_ms=r[f"{kind}_mma_ms"], exp_floor_ms=r["fwd_exp_floor_ms"],
                err_vs_float64=max(e for x in ce_bf16_shapes.values()
                                   for e in x[f"{kind}_err_vs_float64"].values()),
                **({"with_rounding_ms": r["fwd_ms"]} if kind == "fwd" else {}))),
            bit_equal=True,
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
    # rows 8-9's bf16 mode on V2's train step (2 launches of each)
    for kname, kind in (("sa_fwd_bf16", "fwd"), ("sa_bwd_bf16", "bwd")):
        source, replaces = SOURCES[kname]
        r = attn_bf16_shapes[SA_BF16_PATH_SHAPE]
        n = V2_BF16_STEP[kname]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=v2_bf16["launches"][kname],
            launches_by_path={p: counts[kname] for p, counts in paths.items()},
            max_abs_err=max(x[f"{kind}_max_abs_err"] for x in attn_bf16_shapes.values()),
            ms=n * r[f"{kind}_ms"], plain_ms=n * r[f"plain_{kind}_ms"],
            bound_ms=n * r[f"{kind}_bound_ms"], bound_by=r[f"{kind}_bound_by"],
            library_ms=n * r[f"library_{kind}_ms"],
            bound_share=r[f"{kind}_bound_share"],
            device_ms=_times(n, r[f"{kind}_device_ms"]),
            flag_ms=n * r[f"flag_{kind}_ms"],
            flag_device_ms=_times(n, r[f"flag_{kind}_device_ms"]),
            mma_ms=n * r[f"{kind}_mma_ms"], exp_floor_ms=n * r[f"{kind}_exp_floor_ms"],
            err_vs_float64=max(x["err_vs_float64"][o] for x in attn_bf16_shapes.values()
                               for o in (("o",) if kind == "fwd" else ("dq", "dk", "dv"))),
            bit_equal=True,
            per=(f"V2 train step at batch 4096 in the bf16 mode ({n} launches, G {r['G']}, "
                 f"dh {r['dh']}, S {r['S']}); bound by the exps, SDPA on bf16 operands as "
                 "the library; flag_ms: the fp32 kernels' bf16 flag these replaced"),
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
            device_ms=_times(n, r[f"{kind}_device_ms"]),
            exp_floor_ms=n * r[f"{kind}_exp_floor_ms"],
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
            device_ms=_sum_measured(r[f"{kind}_device_ms"] for r in rs),
            err_vs_float64=max(
                x["fwd_err_vs_float64"] if kind == "fwd" else max(x["bwd_err_vs_float64"].values())
                for x in gru_shapes.values()),
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


def main_graph_only():
    """``--graph-only``: the device, build and compiled-dispatch phases
    alone (a quick run of the CUDA graphs on the card)."""
    name, _ = phase_device()
    phase_build()
    phase_graph_training()
    phase_graph_pro_training()
    phase_graph_serving()
    emit(ok=True, device=dict(platform="gpu", kind=name, count=torch.cuda.device_count()))


def main_sharded_only(per_gpu=False):
    """``--sharded-only [--per-gpu]``: the device, build and sharded phases
    alone (a quick run of the rank grid on the card; ``--per-gpu`` puts a
    rank on each of 4 cards over NCCL; the full run takes no arguments)."""
    name, _ = phase_device()
    phase_build()
    phase_sharded(per_gpu)
    emit(ok=True, device=dict(platform="gpu", kind=name, count=torch.cuda.device_count()))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--grid-rank"]:
        world, rank, port = (int(a) for a in sys.argv[2:5])
        grid_rank_main(world, rank, port, *sys.argv[5:7])
    elif sys.argv[1:2] == ["--sharded-only"]:
        main_sharded_only(per_gpu="--per-gpu" in sys.argv)
    elif sys.argv[1:2] == ["--graph-only"]:
        main_graph_only()
    else:
        main()
