"""Time the small attention's bf16 mode (``precision="bf16"``,
``ops/attention_cuda.py``) of this checkout: the port's counterpart of
``scripts/bench_attn_kernel.py`` under ``BENCH_ATTN_PREC=bf16``.

Shapes: G 8192 pairs (batch 4096 x 2 heads) of head width 5 at S 256 (V2's
train step, "v2") and at S 266 (the JAX script's default, "jax_default").

    python -m xdeepfm_tpu_torch.scripts.bench_attn_bf16 [--shapes v2 jax_default]
        [--repeats 3] [--build-only]

Run it from the root of each checkout to be compared, in turns, on one card
in one sitting: it needs only ``sa_forward`` and ``sa_backward`` with their
``precision`` argument, so a checkout whose bf16 mode is a flag on the fp32
kernels runs it too.  ``--build-only`` builds and exits, so that the
checkouts' builds can run side by side before their timings.

On the card it prints the card's name and power limit (nvidia-smi), then
one JSON line a shape: for the bf16 mode the forward's and the backward's
mean ms over 10 calls after a warm-up, ``repeats`` times, the device ms by
kernel (torch.profiler), the largest difference from the bf16 plain version,
the error against the float64 function of the same rounded inputs as a
multiple of the plain version's (the smoke's gate holds it to 2), the share
of rows whose m is bit-equal to the plain version's, bit-equality over two
runs; where the checkout has the bf16 kernels, the same times of the fp32
kernels' bf16 flag (the path they replaced); then the fp32 mode's times and
its outputs' sha256 (first 16 hex digits: the same seeded inputs give the
same digits on checkouts whose fp32 kernels are bit-equal); and the bounds:
the exps at the fp32 rate / 16, the products at the bf16 tensor cores' rate
(H100 SXM).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import torch

from ..ops import _build
from ..ops import attention_cuda as sa

ITERS = 10  # timed calls a repeat, after one warm-up call
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s of the H100 SXM at 700 W
EXP_RATE = 67e12 / 16  # exp2 results/s: the fp32 FMA rate over 16 (H100 SXM)
HBM = 3.35e12  # bytes/s
# (G, dh, S)
SHAPES = {"v2": (8192, 5, 256), "jax_default": (8192, 5, 266)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shapes", nargs="+", choices=sorted(SHAPES), default=sorted(SHAPES))
    p.add_argument("--repeats", type=int, default=3, help="timings of each shape")
    p.add_argument("--build-only", action="store_true", help="build the libraries and exit")
    return p.parse_args(argv)


def has_bf16_kernels():
    return hasattr(sa, "sa_forward_bf16")


def flag_forward(q, k, v, scale):
    """The fp32 forward kernel with its bf16 flag set: the bf16 mode's path
    before ``sa_bf16.cu``."""
    G, dh, S = q.shape
    o = torch.empty_like(q)
    m = torch.empty((G, S), device=q.device)
    z = torch.empty_like(m)
    sa._launch("sa_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               m.data_ptr(), z.data_ptr(), G, dh, S, float(scale), 1)
    return o, m, z


def flag_backward(g, q, k, v, o, m, z, scale):
    """The fp32 backward kernel with its bf16 flag set."""
    G, dh, S = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    sa._launch("sa_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
               o.data_ptr(), m.data_ptr(), z.data_ptr(), dq.data_ptr(), dk.data_ptr(),
               dv.data_ptr(), G, dh, S, float(scale), 1)
    return dq, dk, dv


def time_ms(fn):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def device_ms(fn, calls=3):
    """Device ms a call by kernel name (torch.profiler over ``calls`` calls
    after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0 \
                and not getattr(e, "is_user_annotation", False):
            key = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
            key = key.split("(")[0]
            out[key] = out.get(key, 0.0) + e.device_time_total / 1e3 / calls
    return out


def exact(q, k, v, scale, g=None, o=None, m=None, z=None):
    """float64 of the bf16 mode's function on its rounded inputs (as
    ``sa_bf16_float64``; kept here so that every checkout is held to the
    same function): o, or (dq, dk, dv) from the given o, m and inv_z."""
    def r(t):
        return t.to(torch.bfloat16).double()

    qb, kb, vb = r(q), r(k), r(v)
    s = torch.einsum("gds,gdt->gst", qb, kb)
    if g is None:
        e = torch.exp((s - s.amax(-1, keepdim=True)) * scale)
        return torch.einsum("gdt,gst->gds", vb, e) / e.sum(-1)[:, None, :]
    g, o, m, z = (t.double() for t in (g, o, m, z))
    e = torch.exp((s - m[..., None]) * scale)
    del s
    dv = torch.einsum("gds,gst->gdt", g * z[:, None, :], e)
    ds = torch.einsum("gds,gdt->gst", r(g), vb)
    ds.sub_((g * o).sum(1)[..., None]).mul_((z * scale)[..., None]).mul_(e)
    del e
    return torch.einsum("gdt,gst->gds", kb, ds), torch.einsum("gds,gst->gdt", qb, ds), dv


def vs_float64(got, want, ex):
    """The kernel's largest error against float64 over the plain version's."""
    plain = float((want.double() - ex).abs().max())
    return float((got.double() - ex).abs().max()) / plain if plain else 0.0


def fp32_outputs_sha256(q, k, v, g, scale):
    """The first 16 hex digits of the sha256 of the fp32 kernels' outputs
    (o, m, inv_z, dq, dk, dv): equal on checkouts whose fp32 kernels are
    bit-equal, for the same inputs."""
    o, m, z = sa.sa_forward(q, k, v, scale)
    grads = sa.sa_backward(g, q, k, v, o, m, z, scale)
    return hashlib.sha256(b"".join(
        x.cpu().numpy().tobytes() for x in (o, m, z, *grads))).hexdigest()[:16]


def inputs(G, dh, S, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(G, dh, S, generator=gen, device="cuda") for _ in range(4)]


def bench(label, repeats):
    G, dh, S = SHAPES[label]
    q, k, v, g = inputs(G, dh, S)
    scale = dh ** -0.5
    rec = dict(shape=label, G=G, dh=dh, S=S)
    new = has_bf16_kernels()
    rec["design"] = "bf16 kernels (sa_bf16.cu)" if new else "bf16 flag on the fp32 kernels"

    # the bf16 mode, its errors on a slice of the pairs (the float64 [S, S]
    # blocks of all 8192 take 4.3 GB each)
    o, m, z = sa.sa_forward(q, k, v, scale, "bf16")
    grads = sa.sa_backward(g, q, k, v, o, m, z, scale, "bf16")
    again = sa.sa_forward(q, k, v, scale, "bf16")
    rec["fwd_bit_equal"] = all(torch.equal(a, c) for a, c in zip((o, m, z), again))
    again = sa.sa_backward(g, q, k, v, o, m, z, scale, "bf16")
    rec["bwd_bit_equal"] = all(torch.equal(a, c) for a, c in zip(grads, again))
    del again
    n = 1024
    qs, ks, vs, gs, os_, ms, zs = (t[:n] for t in (q, k, v, g, o, m, z))
    want_o, want_m, _ = sa.sa_forward_reference(qs, ks, vs, scale, "bf16")
    rec["fwd_max_abs_err_vs_plain"] = float((os_ - want_o).abs().max())
    rec["m_bit_equal_share_vs_plain"] = float((ms == want_m).float().mean())
    rec["fwd_err_vs_float64_over_plain"] = vs_float64(os_, want_o, exact(qs, ks, vs, scale))
    del want_o, want_m
    want = sa.sa_backward_reference(gs, qs, ks, vs, os_, ms, zs, scale, "bf16")
    ex = exact(qs, ks, vs, scale, gs, os_, ms, zs)
    rec["bwd_max_abs_err_vs_plain"] = max(
        float((a[:n] - w).abs().max()) for a, w in zip(grads, want))
    rec["bwd_err_vs_float64_over_plain"] = {
        name: vs_float64(a[:n], w, e) for name, a, w, e in zip(("dq", "dk", "dv"), grads, want, ex)}
    del want, ex, grads
    torch.cuda.empty_cache()

    def fwd():
        return sa.sa_forward(q, k, v, scale, "bf16")

    def bwd():
        return sa.sa_backward(g, q, k, v, o, m, z, scale, "bf16")

    rec["fwd_ms"] = [time_ms(fwd) for _ in range(repeats)]
    rec["bwd_ms"] = [time_ms(bwd) for _ in range(repeats)]
    rec["fwd_device_ms"] = device_ms(fwd)
    rec["bwd_device_ms"] = device_ms(bwd)
    if new:
        fm, mm, zm = flag_forward(q, k, v, scale)
        rec["flag_fwd_ms"] = [time_ms(lambda: flag_forward(q, k, v, scale))
                              for _ in range(repeats)]
        rec["flag_bwd_ms"] = [time_ms(lambda: flag_backward(g, q, k, v, fm, mm, zm, scale))
                              for _ in range(repeats)]
        rec["flag_fwd_device_ms"] = device_ms(lambda: flag_forward(q, k, v, scale))
        rec["flag_bwd_device_ms"] = device_ms(lambda: flag_backward(g, q, k, v, fm, mm, zm,
                                                                    scale))
        del fm, mm, zm

    # the fp32 mode: times and the outputs' digest
    rec["fp32_outputs_sha256"] = fp32_outputs_sha256(q, k, v, g, scale)
    o32, m32, z32 = sa.sa_forward(q, k, v, scale)
    rec["fp32_fwd_ms"] = [time_ms(lambda: sa.sa_forward(q, k, v, scale)) for _ in range(repeats)]
    rec["fp32_bwd_ms"] = [time_ms(lambda: sa.sa_backward(g, q, k, v, o32, m32, z32, scale))
                          for _ in range(repeats)]

    exps = G * S * S
    nb = 4 * G * dh * S
    rec["exp_floor_ms"] = exps / EXP_RATE * 1e3
    rec["fwd_mma_ms"] = 4 * G * S * S * dh / PEAK_BF16 * 1e3
    rec["bwd_mma_ms"] = 10 * G * S * S * dh / PEAK_BF16 * 1e3
    rec["fwd_bound_ms"] = max(exps / EXP_RATE, 4 * G * S * S * dh / PEAK_BF16,
                              (4 * nb + 8 * G * S) / HBM) * 1e3
    rec["bwd_bound_ms"] = max(exps / EXP_RATE, 10 * G * S * S * dh / PEAK_BF16,
                              (8 * nb + 8 * G * S) / HBM) * 1e3
    return rec


def ptxas_lines():
    """The build log's register, shared-memory and spill lines of the bf16
    kernels (nvcc -Xptxas=-v)."""
    if not has_bf16_kernels():
        return []
    log = _build.library_path("sa_bf16").with_suffix(".log").read_text()
    keep = ("Compiling entry", "registers", "spill")
    return [line.strip() for line in log.splitlines() if any(w in line for w in keep)]


def main(argv=None):
    args = parse_args(argv)
    _build.build(["sa_fwd", "sa_bwd"] + (["sa_bf16"] if has_bf16_kernels() else []))
    if args.build_only:
        return
    if not torch.cuda.is_available():
        raise SystemExit("bench_attn_bf16: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"ptxas": ptxas_lines()}), flush=True)
    for label in args.shapes:
        print(json.dumps(bench(label, args.repeats)), flush=True)


if __name__ == "__main__":
    main()
