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
   and at a ragged and a tiny shape, with its time, the plain version's time
   and the least time the card could take (bound);
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
   6 + 0 + 2 under the legacy backward; one step's gradients must match the
   plain CIN's on the card under both backward implementations, and one SGD
   step on the card must match the CPU model's; loss and AUC must be finite
   and the epoch loss must fall.  Examples/s trained with the kernels and
   with the plain CIN, from CUDA events over train steps;
7. training profile: device time by kernel and idle share over train steps;
8. CE kernel vs plain: ``ce_fwd`` and ``ce_bwd`` (the SFG decoder's fused
   softmax cross-entropy) against their plain PyTorch versions at the
   canonical Pro step's stacked shape (26 heads, batch 4096, hidden 64,
   vocabulary 10000 padded to 10112) with every row and with a third of the
   rows valid, one head of the same shape, a ragged shape, no valid row and a
   tiny shape; the backward must be bit-deterministic; times beside the
   plain version's, the library's (``F.linear`` then ``F.cross_entropy``,
   logits materialised, backward by autograd) and the bound;
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
11. a ``{"kernels": [...]}`` line, one entry per hand-written kernel;
12. the last line: ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from xdeepfm_tpu_torch.basemodel import _loss_fn_single
from xdeepfm_tpu_torch.features import DenseFeat, SparseFeat
from xdeepfm_tpu_torch.models import xDeepFM
from xdeepfm_tpu_torch.ops import _build, ce
from xdeepfm_tpu_torch.ops.ce_cuda import (
    ce_rows_backward,
    ce_rows_backward_reference,
    ce_rows_forward,
    ce_rows_forward_reference,
)
from xdeepfm_tpu_torch.ops.cin import set_backward_impl
from xdeepfm_tpu_torch.ops.cin_cuda import (
    cin_rows_backward,
    cin_rows_backward_reference,
    cin_rows_dw,
    cin_rows_dw_reference,
    cin_rows_forward,
    cin_rows_reference,
)
from xdeepfm_tpu_torch.pro import xDeepFMPro
from xdeepfm_tpu_torch.serving import Scorer
from xdeepfm_tpu_torch.weights import flatten_tree, unflatten_tree

SEED = 0
BATCH = 8192
TRAIN_BATCH = 4096  # bench.py's and cli/xdftrain.py's train batch
TRAIN_STEPS_PER_EPOCH, TRAIN_EPOCHS = 8, 3
N_SPARSE, VOCAB, DIM, N_DENSE = 26, 10_000, 10, 13
CIN_LAYERS, DNN_UNITS = (256, 128), (256, 256)
REQUESTS = (8192, 8192, 8192, 5000)  # the last one is padded to a whole batch

# Published dense peaks at the full power limit (NVIDIA data sheets): fp32 on
# the CUDA cores (the kernel uses no tensor cores) and device-memory bytes/s.
# First matching name wins; "H100" alone is the SXM part ("H100 80GB HBM3").
PEAKS = (
    ("H100 PCIe", 51.2e12, 2.0e12),
    ("H100 NVL", 60.0e12, 3.9e12),
    ("H200", 67.0e12, 4.8e12),
    ("H100", 67.0e12, 3.35e12),
)

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
}
WRAPPERS = {
    "cin_fwd": cin_rows_forward, "cin_bwd_dx": cin_rows_backward, "cin_dw": cin_rows_dw,
    "ce_fwd": ce_rows_forward, "ce_bwd": ce_rows_backward,
}
NO_CE = {"ce_fwd": 0, "ce_bwd": 0}

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
         peak_source=peak[0], peak_fp32_flops=peak[1], peak_bytes_per_s=peak[2])
    return name, peak


def phase_build():
    t0 = time.time()
    logs = _build.build()
    emit(phase="build", seconds=round(time.time() - t0, 3), sources=sorted(logs))
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  [{name}] {line}", flush=True)


def _kernel_case(name, N, H, M, O, strided, gen):
    """(kernel call, plain call, bytes the function must move) on fresh
    unit-normal inputs; h is a column view of an [N, 2H] tensor if
    ``strided``."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    h = rand(N, 2 * H)[:, :H] if strided else rand(N, H)
    x0, W, b, g = rand(N, M), rand(O, H * M), rand(O), rand(N, O)
    ins = 4 * (N * H + N * M)
    if name == "cin_fwd":
        return (lambda: cin_rows_forward(h, x0, W, b), lambda: cin_rows_reference(h, x0, W, b),
                ins + 4 * (O * H * M + O + N * O))
    if name == "cin_bwd_dx":
        return (lambda: cin_rows_backward(g, h, x0, W),
                lambda: cin_rows_backward_reference(g, h, x0, W),
                ins + 4 * (N * O + O * H * M) + ins)
    return (lambda: cin_rows_dw(g, h, x0), lambda: cin_rows_dw_reference(g, h, x0),
            ins + 4 * (N * O + O * H * M))


def phase_kernels(peak):
    """Every kernel against its plain version on the same inputs.  FLOPs are
    the contraction's 2*N*H*M*O for each kernel (the N*H*M-sized epilogue
    terms add under 1% at O >= 128 and are left out of the bound)."""
    _, peak_flops, peak_bw = peak
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    cases = [("cin_fwd", s) for s in SERVE_SHAPES] + [
        (name, s) for s in TRAIN_SHAPES + EDGE_SHAPES
        for name in ("cin_fwd", "cin_bwd_dx", "cin_dw")
    ]
    for name, (label, N, H, M, O, strided) in cases:
        kernel, plain, nbytes = _kernel_case(name, N, H, M, O, strided, gen)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        got, want = (got, want) if name != "cin_bwd_dx" else (torch.cat(got, 1), torch.cat(want, 1))
        err = (got - want).abs().max().item()
        if name == "cin_fwd":
            torch.testing.assert_close(got, want, **CIN_TOL)
        else:
            torch.testing.assert_close(
                got, want, rtol=BWD_RTOL, atol=BWD_RTOL * want.abs().max().item() + 1e-6
            )
        del got, want
        iters = 20 if N > 10_000 else 200
        kernel_ms = cuda_ms(kernel, iters)
        plain_ms = cuda_ms(plain, iters)
        flops = 2 * N * H * M * O
        by_ops = flops / peak_flops >= nbytes / peak_bw
        results[name, label] = dict(
            N=N, H=H, M=M, O=O, strided_h=strided, max_abs_err=err, kernel_ms=kernel_ms,
            plain_ms=plain_ms, library_ms=plain_ms, library="the plain version (materialised)",
            bound_ms=max(flops / peak_flops, nbytes / peak_bw) * 1e3,
            bound_by="operations" if by_ops else "bytes",
            gflop=flops / 1e9, mbytes=nbytes / 1e6, tflops=flops / kernel_ms / 1e9,
        )
        emit(phase="kernel", kernel=name, shape=label, **results[name, label])
    return results


def canonical_columns():
    return [SparseFeat(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)] + [
        DenseFeat(f"I{i}") for i in range(N_DENSE)
    ]


def canonical_model(device, weights=None, seeded=True):
    """The canonical xDeepFM with ``weights``, else random weights from
    SEED (``seeded``), else its own initialisation."""
    cols = canonical_columns()
    model = xDeepFM(cols, cols, dnn_hidden_units=DNN_UNITS,
                    cin_layer_size=CIN_LAYERS, device=device)
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


def requests(rng, sizes):
    out = []
    for n in sizes:
        x = {f"C{i}": rng.integers(0, VOCAB, n) for i in range(N_SPARSE)}
        x.update({f"I{i}": rng.uniform(0, 1, n).astype(np.float32) for i in range(N_DENSE)})
        out.append(x)
    return out


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
    if counts != {"cin_fwd": 2 * n_batches, "cin_bwd_dx": 0, "cin_dw": 0, **NO_CE}:
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


def train_data(rng, n):
    """Criteo-like rows (26 ids uniform over the vocab, 13 dense in [0, 1))
    labelled by a logistic teacher: per-id effects, dense weights and a
    negative bias, so the click rate is about a third and the labels carry
    signal that the model can learn."""
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


def device_batch(model, x, y, n):
    packed = model.schema.pack({k: v[:n] for k, v in x.items()})
    xb = {k: torch.as_tensor(v, device=model.device) for k, v in packed.items()}
    return xb, torch.as_tensor(y[:n, None], device=model.device)


def step_grads(model, xb, yb):
    """Gradients of one step's loss (sum-BCE + L2 registry), no update."""
    model.module.zero_grad(set_to_none=True)
    out = model.module(xb, training=True)
    mask = torch.ones(yb.shape[0], device=yb.device)
    loss = _loss_fn_single("binary_crossentropy")(out["pred"].reshape(-1), yb.reshape(-1), mask)
    (loss + model._regularization_loss()).backward()
    return {k: p.grad.clone() for k, p in model.module.named_parameters()}


def grad_err(got, want):
    """Largest per-parameter error, relative to that gradient's largest entry."""
    return max(
        float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30)
        for k in want
    )


# fp32 sums in other orders (the kernels', cuBLAS's, the CPU's) through the
# whole backward: each gradient within this share of its largest entry
GRAD_RTOL = 1e-4


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
    want = {
        "cin_fwd": 2 * (steps + TRAIN_EPOCHS * n_val_batches),  # + validation batches
        "cin_bwd_dx": 2 * steps, "cin_dw": 2 * steps, **NO_CE,
    }
    if launches != want:
        raise AssertionError(f"CIN launches {launches} over {steps} steps, expected {want}")
    logs = history.history
    for k, v in logs.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{k} is not finite: {v}")
    if not logs["loss"][0] > logs["loss"][1] > logs["loss"][2]:
        raise AssertionError(f"the epoch loss did not fall: {logs['loss']}")

    # one step's gradients, kernels against the plain CIN, per backward impl
    xb, yb = device_batch(model, x, y, TRAIN_BATCH)
    grad_errs, legacy_launches = {}, None
    for impl in ("auto", "legacy"):
        set_backward_impl(impl)
        model.module.cin.backend = "torch"
        want_g = step_grads(model, xb, yb)
        model.module.cin.backend = None
        reset_launches()
        got_g = step_grads(model, xb, yb)
        counts = read_launches()
        if impl == "legacy":
            legacy_launches = counts
            if counts != {"cin_fwd": 6, "cin_bwd_dx": 0, "cin_dw": 2, **NO_CE}:
                raise AssertionError(f"legacy backward launched {counts} in one step")
        elif counts != {"cin_fwd": 2, "cin_bwd_dx": 2, "cin_dw": 2, **NO_CE}:
            raise AssertionError(f"fused backward launched {counts} in one step")
        grad_errs[impl] = grad_err(got_g, want_g)
        if grad_errs[impl] > GRAD_RTOL:
            raise AssertionError(f"{impl}: kernel gradients off by {grad_errs[impl]}")
    set_backward_impl("auto")

    # one SGD step on the card against the CPU model from the same weights
    small = 256
    pair = [canonical_model(dev, model.get_weights()) for dev in ("cuda", "cpu")]
    for m in pair:
        m.compile("sgd", "binary_crossentropy")
        m.fit({k: v[:small] for k, v in x.items()}, y[:small], batch_size=small, epochs=1,
              verbose=0, shuffle=False)
    cpu_errs = {}
    for what, get in (("grad", lambda m: {k: p.grad for k, p in m.module.named_parameters()}),
                      ("weights", lambda m: dict(m.module.named_parameters()))):
        got_t, want_t = ({k: t.detach().cpu() for k, t in get(m).items()} for m in pair)
        cpu_errs[what] = grad_err(got_t, want_t)
        if cpu_errs[what] > GRAD_RTOL:
            raise AssertionError(f"card and CPU {what} after one step differ by {cpu_errs[what]}")

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
        history=logs, grad_rel_err_vs_plain_cin=grad_errs, rel_err_vs_cpu_one_sgd_step=cpu_errs,
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
    each output written once.  The exps (nv*V*F a pass) are left out."""
    _, peak_flops, peak_bw = peak
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
        bwd_err = 0.0
        for got, want in zip(grads, ce_rows_backward_reference(g, h, W, b, t, logz, nvd)):
            torch.testing.assert_close(got, want, rtol=BWD_RTOL,
                                       atol=BWD_RTOL * float(want.abs().max()) + 1e-6)
            bwd_err = max(bwd_err, float((got - want).abs().max()) if got.numel() else 0.0)
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
                   fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err, bwd_bit_equal=deterministic)
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
    want = {"cin_fwd": 2 * (steps + TRAIN_EPOCHS), "cin_bwd_dx": 2 * steps,
            "cin_dw": 2 * steps, "ce_fwd": steps, "ce_bwd": steps}
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
        if counts != {"cin_fwd": 2, "cin_bwd_dx": 2, "cin_dw": 2, "ce_fwd": n, "ce_bwd": n}:
            raise AssertionError(f"stack_heads={stack}: one step launched {counts}")
        key = "stacked" if stack else "per_head"
        step_launches[key] = counts
        grad_errs[key] = grad_err(got_g, want_g)
        if grad_errs[key] > GRAD_RTOL:
            raise AssertionError(f"{key}: CE kernel gradients off by {grad_errs[key]}")
    ce.set_stack_heads(True)
    del want_g, got_g

    # one SGD step on the card against the CPU model from the same weights
    small = 256
    pair = [pro_model(dev, model.get_weights(), sfg_dropout=0.0) for dev in ("cuda", "cpu")]
    for m in pair:
        m.compile("sgd", "binary_crossentropy")
        m.fit({k: v[:small] for k, v in x.items()}, y[:small], batch_size=small, epochs=1,
              verbose=0, shuffle=False)
    cpu_errs = {}
    for what, get in (("grad", lambda m: {k: p.grad for k, p in m.module.named_parameters()}),
                      ("weights", lambda m: dict(m.module.named_parameters()))):
        got_t, want_t = ({k: t.detach().cpu() for k, t in get(m).items()} for m in pair)
        cpu_errs[what] = grad_err(got_t, want_t)
        if cpu_errs[what] > GRAD_RTOL:
            raise AssertionError(f"Pro: card and CPU {what} after one step differ by "
                                 f"{cpu_errs[what]}")
    del pair
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
        history=logs, grad_rel_err_vs_plain_ce=grad_errs, rel_err_vs_cpu_one_sgd_step=cpu_errs,
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
    if counts != {"cin_fwd": 2 * n_batches, "cin_bwd_dx": 0, "cin_dw": 0, **NO_CE}:
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
    serving, scorer, req = phase_serving()
    phase_profile(scorer, req)
    training, model, batches = phase_training()
    phase_train_profile(model, batches)
    del scorer, model, batches
    torch.cuda.empty_cache()
    pro, pro_m, pro_batches = phase_pro_training()
    phase_train_profile(pro_m, pro_batches, phase="pro_train_profile")
    pro_scoring = phase_pro_scoring(pro_m)
    kernels = []
    for kname in ("cin_fwd", "cin_bwd_dx", "cin_dw"):
        source, replaces = SOURCES[kname]
        path = [shapes[kname, label] for label, *_ in TRAIN_SHAPES]  # per train step
        ops_s = sum(r["gflop"] for r in path) * 1e9 / peak[1]
        bytes_s = sum(r["mbytes"] for r in path) * 1e6 / peak[2]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=training["launches"][kname],
            launches_by_path={"training": training["launches"][kname],
                              "serving": serving["cin_launches"] if kname == "cin_fwd" else 0,
                              "pro_training": pro["launches"][kname],
                              "pro_scoring": pro_scoring["launches"][kname]},
            max_abs_err=max(r["max_abs_err"] for (k, _), r in shapes.items() if k == kname),
            ms=sum(r["kernel_ms"] for r in path),
            plain_ms=sum(r["plain_ms"] for r in path),
            bound_ms=sum(r["bound_ms"] for r in path),
            bound_by="operations" if ops_s >= bytes_s else "bytes",
            library_ms=sum(r["library_ms"] for r in path),
            per="train step at batch 4096 (2 launches)",
        ))
    for kname, kind in (("ce_fwd", "fwd"), ("ce_bwd", "bwd")):
        source, replaces = SOURCES[kname]
        r = ce_shapes[CE_PATH_SHAPE]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=pro["launches"][kname],
            launches_by_path={"pro_training": pro["launches"][kname],
                              "pro_scoring": pro_scoring["launches"][kname]},
            max_abs_err=max(x[f"{kind}_max_abs_err"] for x in ce_shapes.values()),
            ms=r[f"{kind}_ms"], plain_ms=r[f"plain_{kind}_ms"],
            bound_ms=r[f"{kind}_bound_ms"], bound_by=r[f"{kind}_bound_by"],
            library_ms=r[f"library_{kind}_ms"],
            per=f"Pro train step at batch 4096, {r['F']} stacked heads, {r['num_valid']} "
                "valid rows (1 launch)",
        ))
    emit(kernels=kernels)
    emit(ok=True, device=dict(platform="gpu", kind=name, count=torch.cuda.device_count()))


if __name__ == "__main__":
    main()
