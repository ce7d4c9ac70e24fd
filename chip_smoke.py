#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lvae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``lvae_tpu_torch/csrc`` and checks each
against its plain PyTorch version at the shapes of the models that run it,
then drives two models through their two entry points. The flagship
(static_mnist, z 32-32-32, 4 blocks per layer, 64 filters, gated, skip,
learned top prior):

- evaluation, ``lvae_tpu_torch.evaluate.main`` (phases 2-5): seeded random
  weights, test ELBO over 10,000 synthetic static_mnist-shaped images and
  the k=100 IW log-likelihood over the first 1,000 of them;
- training, ``lvae_tpu_torch.main`` (phases 6-9): the sample+KL kernels'
  per-sample forward (K1) and both backward kernels held against their
  plain versions and timed at the flagship's and celeba64's training
  shapes, 300 steps of the flagship at batch 64 with data-dependent
  init on 50,000 synthetic train images, the kernel path against the plain
  path and the CPU on one step, and train images/s.

And celeba64 (64x64 RGB, z 32-32-32-32, 2 blocks per layer, 64 filters,
the discretized-logistic-mixture head; phases 10-13): the mixture
log-prob kernel and its backward (K3, K3-bwd, on each of its two plans)
against their plain versions; evaluation over 2,000 synthetic 64x64 RGB images read from
``celeba/celeba_64.npz`` with the k=100 IW log-likelihood over the first
500; 200 training steps at batch 128 on 20,000 images; one step against
the plain path and the CPU, and train images/s.

Then the train-mode dropout+BatchNorm+activation segments (phases 14-16):
the segment kernel and its backward (K5, K5-bwd) against their plain
versions at every segment shape of both models, timed against their
plain versions, the port's unfused chain and their bound; 100 celeba64
steps through ``lvae_tpu_torch.main --fused all``; one step of each model
under ``--fused all`` against the path without the segments (and, for
celeba64, the CPU), and train images/s. Phase 14b holds the unfused bits8
dropout's kernel to its plain version.

Last, ``--steps-per-call 10`` (phase 17): for the flagship (``--fused
auto`` and ``all``) and celeba64 (``all``), 30 steps through one CUDA
graph of 10 bit-equal to 30 eager steps, the graph's kernel nodes by
kernel against the eager launches, train images/s, device time and idle
share graphed against eager; and 200 flagship steps through
``lvae_tpu_torch.main --steps-per-call 10``, resumed from the middle
checkpoint bit-equal.

Each entry point's run checks that it launched every kernel of its path;
the kernel path, the plain path and a CPU run are held to agree, and each
kernel is timed against its plain version.

Prints the card (``nvidia-smi`` name and power limit), one JSON line with
each kernel's launches, error, times, bound and library call, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and no result line is printed. Exits non-zero at once
when no CUDA device is visible.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B = 1000                                    # flagship eval batch
LATENT_SHAPES = [(32, 8, 8), (32, 4, 4), (32, 2, 2)]   # (c, h, w) per layer
N_TEST = 10_000
IW_SAMPLES = 100
TRAIN_B = 64                                # flagship train batch
N_TRAIN = 50_000
TRAIN_STEPS = 300
ODD_SHAPE = (3, 7, 7)                       # F = 147: not a multiple of 128
LONG_ROW = (32, 32, 32)                     # F = 32,768: 16 float4 units a K1 thread


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps=50, warmup=5):
    """Mean ms per call on the card (CUDA events around ``reps`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, reps=1, host_top=None):
    """(device-busy ms per call, wall ms per call, table of the top
    kernels) from torch.profiler over ``reps`` calls. Device-busy time is
    the sum of the kernels' (device-side events') durations; the CPU-side
    operator events, which carry their kernels' time too, are left out.
    ``host_top``: a list that receives the top host-side operators by
    self CPU time (name, ms per call, calls per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    # device-side events that are kernels (and copies), not the device
    # spans of host annotations such as "Optimizer.step#Adamax.step",
    # which also appear on the host under the same name
    events = prof.key_averages()
    host_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type != DeviceType.CPU
               and e.key not in host_keys and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: e.device_time_total, reverse=True)[:8]
    table = [(e.key[:70], e.device_time_total / 1e3 / reps, e.count // reps)
             for e in top]
    if host_top is not None:
        ops = [e for e in events if e.device_type == DeviceType.CPU]
        ops.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
        host_top += [(e.key[:70], e.self_cpu_time_total / 1e3 / reps, e.count // reps)
                     for e in ops[:12]]
    return busy, wall, table, sum(e.count for e in kernels)


def device_ms(fn, reps=20, tries=3):
    """Device-busy ms per call from the profiler. When no trace of
    ``tries`` holds as many kernel events as calls (the profiler was seen
    to drop the events of kernels launched through ctypes), the ms per
    call of a CUDA graph of ``reps`` calls replayed, which has no host
    launch cost; None ("not measured") if that cannot be captured."""
    for _ in range(tries):
        busy, _, _, n_events = device_profile(fn, reps)
        if n_events >= reps:
            return busy
    return graph_ms(fn, reps)


def graph_ms(fn, reps=20, replays=10):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        print(f"  (no CUDA graph of the call: {e})")
        return None
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


# NVIDIA H100 SXM, published peak rates (HBM3 bandwidth, fp32 non-tensor)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound(n_bytes, n_ops=0.0):
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the memory
    rate and its fp32 operations over the peak rate. Returns (ms, "bytes"
    or "operations")."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# fp32 operations per element, counted from the kernels' code (a Philox
# call as ~70 integer operations, a transcendental as one): the sample+KL
# kernels ~110 with keyed noise (Philox, Box-Muller's log, cos and sqrt,
# three exp), ~40 given eps; their backward ~30 (+ Philox); the segment
# ~25 per pass (a quarter of a Philox call, the normalise, the act)
OPS_SAMPLE_KL, OPS_SAMPLE_KL_EPS, OPS_SAMPLE_KL_BWD, OPS_SEGMENT = 110, 40, 30, 25


def total(values):
    return None if any(v is None for v in values) else sum(values)


def write_amat(path, images_u8):
    """Binary images as a Larochelle .amat: one row of 784 '0'/'1' per
    image, space separated."""
    n = images_u8.shape[0]
    row = np.full((n, 784 * 2), ord(" "), np.uint8)
    row[:, 0::2] = images_u8.reshape(n, 784) + ord("0")
    row[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(row.tobytes())


def phase_build():
    from lvae_tpu_torch.kernels import build

    print("[1] build", flush=True)
    t0 = time.perf_counter()
    path, log = build.build()
    build.library()
    print(f"  built {os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())
    return log


def ptxas_usage(log, marker):
    """{entry function: "registers, shared memory; spills"} from the
    ``-Xptxas -v`` log, for the entries whose mangled name holds
    ``marker``."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else None
        elif entry and marker in entry and ("registers" in line or "spill" in line):
            out[entry] = (out.get(entry, "") + "; " if entry in out else "") + \
                line.split(":", 1)[-1].strip()
    return out


def phase_sample_kl(card):
    import torch
    from scipy import stats

    from lvae_tpu_torch.kernels import stochastic as sk
    from lvae_tpu_torch.ops.philox import keyed_normal

    print("[2] sample+KL kernel vs its plain version", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    err, times, n_bytes, n_ops = 0.0, [], 0, 0
    for layer, (c, h, w) in enumerate(LATENT_SHAPES):
        q = (torch.randn(B, 2 * c, h, w, generator=g) * 0.7).to(dev)
        p = (torch.randn(B, 2 * c, h, w, generator=g) * 0.7).to(dev)
        eps = torch.randn(B, c, h, w, generator=g).to(dev)
        index = torch.randperm(50_000, generator=g)[:B].to(dev)

        z, kl = sk.sample_kl_eps(q, p, eps)
        zr, klr = sk._plain_sample_kl_eps(q, p, eps)
        rel = max(((z - zr).abs() / zr.abs().clamp_min(1.0)).max().item(),
                  ((kl - klr).abs() / klr.abs().clamp_min(1.0)).max().item())
        check(rel <= 1e-6, f"[{B},{c},{h},{w}] given eps: z, kl within 1e-6 "
                           f"relative (max {rel:.2e})")

        z, kl = sk.sample_kl(q, p, index, 1234, 0, layer)
        zr, klr = sk._plain_sample_kl(q, p, index, 1234, 0, layer)
        e = max((z - zr).abs().max().item(), (kl - klr).abs().max().item())
        err = max(err, e)
        check(e <= 1e-5, f"[{B},{c},{h},{w}] Philox: z, kl match the plain "
                         f"generator (max abs {e:.2e})")
        pb = p[:1].expand(B, -1, -1, -1)
        zb, klb = sk.sample_kl(q, pb, index, 1234, 0, layer)
        zf, klf = sk.sample_kl(q, pb.contiguous(), index, 1234, 0, layer)
        check(torch.equal(zb, zf) and torch.equal(klb, klf),
              "row-stride-0 prior equals the materialised prior")
        perm = torch.randperm(B, generator=g).to(dev)
        zp, klp = sk.sample_kl(q[perm].contiguous(), p[perm].contiguous(),
                               index[perm], 1234, 0, layer)
        check(torch.equal(zp, z[perm]) and torch.equal(klp, kl[perm]),
              "a batch permuted with its index gives permuted outputs")

        kernel = lambda: sk.sample_kl(q, p, index, 1234, 0, layer)  # noqa: E731
        plain = lambda: sk._plain_sample_kl(q, p, index, 1234, 0, layer)  # noqa: E731
        t = [cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)]
        dk, dp = device_ms(kernel), device_ms(plain)
        times.append(((t[1] + t[2]) / 2, (t[0] + t[3]) / 2, dk, dp))
        # q, p (4 floats) in, z and the KL map out; the rows' index
        n_bytes += B * c * h * w * 24 + B * 8
        n_ops += B * c * h * w * OPS_SAMPLE_KL
        print(f"  time [{B},{c},{h},{w}] per call: kernel {times[-1][0]:.4f} ms, "
              f"plain {times[-1][1]:.4f} ms; device busy: kernel {fmt_ms(dk)}, "
              f"plain {fmt_ms(dp)}  ({card})")

    # noise statistics: with mu = log-var = 0, z is eps itself
    c, h, w = LATENT_SHAPES[0]
    zeros = torch.zeros(B, 2 * c, h, w, device=dev)
    draws = []
    for seed in (7, 8):
        z, _ = sk.sample_kl(zeros, zeros, torch.arange(B, device=dev), seed, 0, 0)
        ref = keyed_normal(z.shape, seed, torch.arange(B, device=dev), 0, 0)
        e = (z - ref).abs().max().item()
        check(e <= 1e-5, f"kernel eps equals the plain generator's (max abs {e:.2e})")
        draws.append(z.flatten().double().cpu().numpy())
    x = np.concatenate(draws)
    n = x.size
    se = 1.0 / np.sqrt(n)
    check(n >= 1_000_000, f"{n} draws")
    check(abs(x.mean()) < 6 * se, f"eps mean {x.mean():+.2e} within 6 se")
    check(abs(x.var() - 1) < 6 * np.sqrt(2) * se, f"eps var {x.var():.6f} within 6 se")
    p1 = np.mean(np.abs(x) < 1.0)
    check(abs(p1 - 0.682689) < 1e-3, f"eps |x|<1 mass {p1:.4f}")
    ks = stats.kstest(x, "norm")
    check(ks.pvalue > 1e-3, f"KS vs N(0,1): D={ks.statistic:.2e} p={ks.pvalue:.3f}")
    lag = float(np.corrcoef(draws[0][:-1], draws[0][1:])[0, 1])
    check(abs(lag) < 6 / np.sqrt(draws[0].size), f"lag-1 autocorr {lag:+.2e}")
    return err, [total([t[i] for t in times]) for i in range(4)], bound(n_bytes, n_ops)


def phase_logsumexp(card, build_log=""):
    """K4 against its plain version at both models' IW shapes ([100, 1000]
    flagship, [100, 500] celeba64), a ragged B, k = 1000 (several register
    loads a thread) and B = 100,000 (a large grid: 4 warps a CTA): edge
    columns (all -inf, all but one -inf, +-1e30, a NaN, a +inf), bit-equal
    relaunches, each shape's launch plan;
    the kernel's registers, shared memory and spills from the ``-Xptxas
    -v`` log ``build_log``; per call and device time at the IW shapes
    beside the plain version and ``torch.logsumexp`` (timed only, never
    called by the port), the [1, 1] launch floor and the wrapper's host ms
    per call."""
    import torch

    from lvae_tpu_torch.kernels import logsumexp as lse

    print("[3] logsumexp kernel (K4) vs its plain version", flush=True)
    ptxas = ptxas_usage(build_log, "logsumexp_cu")
    for entry, line in ptxas.items():
        print(f"  ptxas {'logsumexp_kernel' if 'logsumexp_kernel' in entry else entry}: {line}")
    g = torch.Generator().manual_seed(1)
    err = 0.0
    for k, b in ((IW_SAMPLES, B), (IW_SAMPLES, 777), (IW_SAMPLES, CELEBA_EVAL_B), (1000, 64),
                 (IW_SAMPLES, 100_000)):
        shape = f"[{k},{b}]"
        print(f"  {shape} {lse.lse_plan(k, b)}")
        x = torch.randn(k, b, generator=g) * 30 - 200
        x[:, 0] = float("-inf")             # all -inf -> -inf
        x[1:, 1] = float("-inf")            # all but one -> that one
        x[:, 2] = 1e30
        x[:, 3] = -1e30
        x[::2, 4] = 1e30
        x[k // 3, 5] = float("nan")         # a NaN -> -inf
        x[k - 1, 6] = float("inf")          # a +inf -> -inf
        x = x.cuda()
        out, ref = lse.logsumexp(x), lse._plain_logsumexp(x)
        check(out[0].item() == float("-inf") and not torch.isnan(out).any(),
              f"{shape} all -inf column gives -inf, no NaN")
        check(out[1].item() == x[0, 1].item(), f"{shape} all-but-one -inf column")
        check(out[2].item() == x[0, 2].item() and out[3].item() == x[0, 3].item(),
              f"{shape} columns at +-1e30")
        check(out[5].item() == float("-inf") and out[6].item() == float("-inf"),
              f"{shape} a NaN column and a +inf column give -inf")
        fin = torch.isfinite(ref)
        check(torch.equal(fin, torch.isfinite(out)), f"{shape} the same columns are finite")
        e = (out[fin] - ref[fin]).abs().max().item()
        rel = rel_elem(out[fin], ref[fin])
        err = max(err, e)
        check(rel <= 1e-6, f"{shape} within 1e-6 relative (max {rel:.2e}, abs {e:.2e})")
        check(torch.equal(out, lse.logsumexp(x)), f"{shape} a second launch is bit-equal")

    rows, more = {}, {}
    for b in (B, CELEBA_EVAL_B):
        x = (torch.randn(IW_SAMPLES, b, generator=g) * 30 - 200).cuda()
        fns = {"plain": lambda: lse._plain_logsumexp(x), "kernel": lambda: lse.logsumexp(x)}
        t = [cuda_ms(fns["plain"]), cuda_ms(fns["kernel"]), cuda_ms(fns["kernel"]),
             cuda_ms(fns["plain"])]
        library = lambda: torch.logsumexp(x, 0)       # noqa: E731  (timed only, never called)
        # [k, B] in, [B] out; an exp, an add and a compare per element
        n = IW_SAMPLES * b
        rows[b] = {**timing_row({"kernel": (t[1] + t[2]) / 2, "plain": (t[0] + t[3]) / 2},
                                {"kernel": device_ms(fns["kernel"]),
                                 "plain": device_ms(fns["plain"])},
                                bound(4 * n + 4 * b, 3 * n)),
                   "library_ms": cuda_ms(library), "library_device_ms": device_ms(library),
                   "plan": lse.lse_plan(IW_SAMPLES, b)._asdict()}
        r = rows[b]
        print_times("K4", f"[{IW_SAMPLES},{b}]", r, card)
        print(f"    torch.logsumexp(x, 0): per call {fmt_ms(r['library_ms'])}, device "
              f"{fmt_ms(r['library_device_ms'])}  ({card})")
    one = torch.randn(1, 1, generator=g).cuda()
    more["floor_device_ms"] = device_ms(lambda: lse.logsumexp(one))
    more["host_ms"] = host_ms(lambda: lse.logsumexp(one))
    print(f"  [1,1]: device {fmt_ms(more['floor_device_ms'])} (the launch floor), the "
          f"wrapper's host ms per call {more['host_ms']:.4f} (wall over 300 calls, the card "
          f"idle between)  ({card})")
    more["celeba64"] = rows[CELEBA_EVAL_B]
    more["ptxas"] = list(ptxas.values())
    return err, rows[B], more


FLAGSHIP = {
    "dataset": "static_mnist", "zdims": [32, 32, 32], "downsample": [1, 1, 1],
    "blocks_per_layer": 4, "n_filters": 64, "gated": True, "skip": True,
    "learn_top_prior": True, "nonlin": "elu", "dropout": 0.2,
    "test_batch_size": B, "fused": "auto", "freebits": 0.5, "batch_size": 64,
}


def seeded_model(config, meta, device, seed=2024):
    """The model of ``config`` (a run's config dict) over the dataset
    metadata ``meta`` with seeded random weights: lecun-scale convs, the
    Gaussian and likelihood heads at their normal(1e-2) init, small random
    biases and top prior (so every layer's KL is well above 0), BatchNorm
    running stats away from 0/1."""
    import torch

    from lvae_tpu_torch.config import config_from_dict
    from lvae_tpu_torch.train.trainer import make_model

    g = torch.Generator().manual_seed(seed)
    model = make_model(config_from_dict(config), meta, device, generator=g)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.2)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith("bias") or name.endswith("top_prior"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.05)
    return model


def flagship_model(device):
    from lvae_tpu_torch.data.registry import load_test_set

    # the same 28x28x1 Bernoulli metadata
    return seeded_model(FLAGSHIP, load_test_set("synthetic"), device)


def set_kernels(model, on):
    """Every kernel switch of ``model``: the sample+KL kernels of each
    latent layer and, with a mixture head, K3."""
    for layer in model.top_down_layers:
        layer.stochastic.fused = on
    if hasattr(model.likelihood_head, "fused"):
        model.likelihood_head.fused = on


def per_image_elbo(model, x, index, seed=0):
    from lvae_tpu_torch.train.state import per_image_forward

    ll, kl_sep = per_image_forward(model, x, index, seed)
    return ll - kl_sep.sum(dim=0)


def phase_slice(card):
    import torch

    from lvae_tpu_torch import evaluate, serving
    from lvae_tpu_torch.data.device import eval_preprocess_batch
    from lvae_tpu_torch.data.sources import make_synthetic
    from lvae_tpu_torch.eval.iwll import evaluate_iwll
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.train.state import evaluate_elbo

    print("[4] the slice through lvae_tpu_torch.evaluate.main", flush=True)
    dev = torch.device("cuda")
    model = flagship_model(dev)
    _, test = make_synthetic(n_train=0, n_test=N_TEST, seed=5)
    out = {}
    with tempfile.TemporaryDirectory() as run_dir:
        data_dir = os.path.join(run_dir, "data")
        os.makedirs(os.path.join(data_dir, "static_mnist"))
        write_amat(os.path.join(data_dir, "static_mnist", "binarized_mnist_test.amat"), test)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(dict(FLAGSHIP, data_dir=data_dir), f)
        weights = os.path.join(run_dir, "weights.pt")
        torch.save(model.state_dict(), weights)

        build.reset_launches()
        res = evaluate.main(["--load", run_dir, "--state-dict", weights, "--ll",
                             "--iw-samples", str(IW_SAMPLES), "--iw-max-batches", "1",
                             "--device", "cuda"])
        launches = dict(build.LAUNCHES)
    n_batches = N_TEST // B
    print(f"  launches in the evaluate run: {launches}")
    check(launches["sample_kl"] == 3 * (n_batches + IW_SAMPLES),
          f"sample+KL kernel: 3 launches per forward ({launches['sample_kl']})")
    check(launches["logsumexp"] == 1, "logsumexp kernel: 1 launch per IW batch")
    m, iw = res["elbo"], res["iw"]
    check(m["n_images"] == N_TEST and iw["n_images"] == B, "sweep sizes")
    vals = [m["elbo"], m["ll"], m["kl"], m["bpd"], iw["iw_ll"], *m["kl_layers"]]
    check(all(np.isfinite(v) for v in vals), "finite metrics")
    check(min(m["kl_layers"]) > 0.1, f"every layer has KL > 0.1 nats ({m['kl_layers']})")
    out["elbo"], out["iw"] = m, iw

    # the kernel path against the plain path and the CPU, per image
    test_dev = torch.from_numpy(test).to(dev)
    index = torch.arange(B, device=dev)
    x = eval_preprocess_batch(test_dev[:B], "none", index)
    with torch.no_grad():
        e_fused = per_image_elbo(model, x, index)
        set_kernels(model, False)
        e_plain = per_image_elbo(model, x, index)
        model_cpu = flagship_model(torch.device("cpu"))
        model_cpu.load_state_dict(model.state_dict())
        set_kernels(model_cpu, False)
        e_cpu = per_image_elbo(model_cpu, x[:16].cpu(), index[:16].cpu())
        set_kernels(model, True)
    # log-mean-exp >= mean: the k=100 bound sits above the ELBO of the same
    # images, up to the noise of a one-sample ELBO mean (4 standard errors)
    mean, se = e_fused.mean().item(), e_fused.std().item() / B ** 0.5
    check(iw["iw_ll"] >= mean - 4 * se,
          f"IW-LL {iw['iw_ll']:.2f} >= ELBO {mean:.2f} - 4 se ({se:.2f}) of the "
          f"same {B} images")
    d = (e_fused - e_plain).abs().max().item()
    check(d <= 1e-3, f"per-image ELBO, --fused stochastic vs none: max {d:.2e} nats")
    d = (e_fused[:16].cpu() - e_cpu).abs().max().item()
    check(d <= 1e-2, f"per-image ELBO, GPU vs CPU: max {d:.2e} nats")

    u8 = test_dev[:64]
    r = serving.reconstruct(model, u8, 0, index[:64])
    check(r["out_mean"].shape == (64, 28, 28, 1) and torch.isfinite(r["elbo"]).all(),
          "reconstruct")
    d = (r["elbo"] - e_fused[:64]).abs().max().item()
    check(d <= 1e-3, f"reconstruct's ELBO is evaluate's ({d:.2e})")
    enc = serving.encode(model, u8, 0, index[:64])
    check([tuple(t.shape) for t in enc["mu"]]
          == [(64, 8, 8, 32), (64, 4, 4, 32), (64, 2, 2, 32)], "encode")
    gen = serving.generate(model, 16, seed=3)
    check(gen.shape == (16, 28, 28, 1) and bool(((gen >= 0) & (gen <= 1)).all()),
          "generate")

    print("[5] end-to-end times", flush=True)
    torch.cuda.synchronize()
    rates = {}
    for fused in (True, False, False, True):
        set_kernels(model, fused)
        r = evaluate_elbo(model, test_dev, "none", B, 784)
        rates.setdefault(("elbo", fused), []).append(r["images_per_sec"])
    for fused, impl in ((True, "kernel"), (False, "streaming")):
        set_kernels(model, fused)
        r = evaluate_iwll(model, test_dev, "none", 784, IW_SAMPLES, B,
                          logsumexp_impl=impl, max_batches=1)
        rates[("iw", fused)] = [r["images_per_sec"]]
    out["rates"] = {f"{k[0]}_{'kernels' if k[1] else 'plain'}": float(np.mean(v))
                    for k, v in rates.items()}
    for k, v in out["rates"].items():
        print(f"  {k}: {v:.1f} img/s  ({card})")

    # where a test-ELBO batch's time goes (kernels on, 2 batches)
    set_kernels(model, True)
    busy, wall, table, _ = device_profile(
        lambda: evaluate_elbo(model, test_dev[:2 * B], "none", B, 784), 3)
    out["elbo_profile"] = {"device_busy_ms": busy, "wall_ms": wall,
                           "idle_share": 1.0 - busy / wall, "top": table}
    print(f"  test-ELBO profile, 2 batches of {B}: wall {wall:.2f} ms, device "
          f"busy {busy:.2f} ms, idle share {1.0 - busy / wall:.3f}  ({card})")
    for name, ms, count in table:
        print(f"    {ms:8.3f} ms  x{count:<4d} {name}")
    out["launches"] = launches
    return out

def rel_elem(a, b):
    """max |a - b| / max(|b|, 1), elementwise."""
    return ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()


def rel_max(a, b, floor=0.0):
    """max |a - b| relative to max |b| (or ``floor``, if larger)."""
    return (a - b).abs().max().item() / max(b.abs().max().item(), floor, 1e-30)


def training_latents():
    """{model: (B, [(c, h, w) of each layer])}: the K1 and K1-bwd calls of
    one training step; the last layer reads the learned top prior with row
    stride 0."""
    return {"flagship": (TRAIN_B, list(LATENT_SHAPES)),
            "celeba64": (CELEBA_B, [(c, h, w) for h, w, c in CELEBA_LATENTS])}


def time_calls(fns):
    """(ms per call, device ms per call) of the "kernel" and the "plain"
    version in ``fns``."""
    per_call = {"kernel": cuda_ms(fns["kernel"], 50), "plain": cuda_ms(fns["plain"], 10)}
    device = {"kernel": device_ms(fns["kernel"], 20), "plain": device_ms(fns["plain"], 5)}
    return per_call, device


def host_ms(fn, reps=300):
    """Wall ms per call over ``reps`` calls after a warm-up, the card idle
    between: at a small shape, the wrapper's host time."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def timing_row(per_call, device, bnd):
    return {"ms": per_call["kernel"], "plain_ms": per_call.get("plain"),
            "device_ms": device["kernel"], "plain_device_ms": device.get("plain"),
            "bound_ms": bnd[0], "bound_by": bnd[1]}


def sum_rows(rows):
    """The rows of one model's layers summed (bound_by: that of the sum)."""
    keys = [k for k in rows[0] if k.endswith("ms")]
    out = {k: total([r[k] for r in rows]) for k in keys}
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations"
    return out


def print_times(label, shape, row, card):
    print(f"  time {label} {shape} per call: kernel {fmt_ms(row['ms'])}, plain "
          f"{fmt_ms(row['plain_ms'])}; device: kernel {fmt_ms(row['device_ms'])}, plain "
          f"{fmt_ms(row['plain_device_ms'])}; bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})  ({card})")


def phase_k1(card, build_log=""):
    """K1 against its plain version: given eps and keyed, relaunches, the
    stride-0 prior, at the flagship's and celeba64's training shapes, at
    B=256, at ODD_SHAPE and at LONG_ROW (16 units a thread); its launch
    plan at each; each model's training shapes timed (per call, device)
    with the plain version; the wrapper's host ms per call; the sample+KL
    kernels' registers, shared memory and spills from the ``-Xptxas -v``
    log ``build_log``."""
    import torch

    from lvae_tpu_torch.kernels import stochastic as sk

    print("[6] per-sample sample+KL kernel (K1) vs its plain version", flush=True)
    for entry, line in ptxas_usage(build_log, "stochastic_kl_cu").items():
        m = re.search(r"(sample_kl\w*?_kernel)(I(?:L\w\d+E)+E)?", entry)
        args = [v if t != "b" else ("false", "true")[int(v)]
                for t, v in re.findall(r"L(\w)(\d+)E", m[2] or "")] if m else []
        name = (m[1] + (f"<{', '.join(args)}>" if args else "")) if m else entry
        print(f"  ptxas {name}: {line}")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)

    def rnd(*s):
        return (torch.randn(*s, generator=g) * 0.7).to(dev)

    err = 0.0
    celeba = training_latents()["celeba64"][1]
    checked = ([(TRAIN_B, s) for s in LATENT_SHAPES + [ODD_SHAPE]]
               + [(256, s) for s in LATENT_SHAPES + [ODD_SHAPE]]
               + [(CELEBA_B, s) for s in celeba] + [(8, LONG_ROW)])
    for layer, (b, (c, h, w)) in enumerate(checked):
        shape = f"[{b},{2 * c},{h},{w}]"
        print(f"  {shape} {sk.k1_plan(b, c, h * w)}")
        q, p = rnd(b, 2 * c, h, w), rnd(b, 2 * c, h, w)
        eps = torch.randn(b, c, h, w, generator=g).to(dev)
        index = torch.randperm(N_TRAIN, generator=g)[:b].to(dev)

        z, kl = sk.sample_kl_per_sample_eps(q, p, eps)
        zr, klr = sk._plain_sample_kl_per_sample_eps(q, p, eps)
        rel = max(rel_elem(z, zr), rel_elem(kl, klr))
        check(rel <= 1e-6, f"{shape} given eps: z, kl_b within 1e-6 relative "
                           f"(max {rel:.2e})")
        z, kl = sk.sample_kl_per_sample(q, p, index, 77, 5, layer)
        zr, klr = sk._plain_sample_kl_per_sample(q, p, index, 77, 5, layer)
        e = (z - zr).abs().max().item()
        err = max(err, e, (kl - klr).abs().max().item())
        rel = rel_elem(kl, klr)
        check(e <= 1e-5 and rel <= 1e-5,
              f"{shape} Philox: z within {e:.2e} abs, kl_b {rel:.2e} relative of "
              f"the plain generator's")
        zk2, _ = sk.sample_kl(q, p, index, 77, 5, layer)
        check(torch.equal(z, zk2), f"{shape} K1 draws K2's z")
        pb = p[:1].expand(b, -1, -1, -1)
        zb, klb = sk.sample_kl_per_sample(q, pb, index, 77, 5, layer)
        zf, klf = sk.sample_kl_per_sample(q, pb.contiguous(), index, 77, 5, layer)
        check(torch.equal(zb, zf) and torch.equal(klb, klf),
              f"{shape} row-stride-0 prior equals the materialised prior")
        z2, kl2 = sk.sample_kl_per_sample(q, p, index, 77, 5, layer)
        check(torch.equal(z, z2) and torch.equal(kl, kl2),
              f"{shape} a second launch is bit-equal (deterministic row sums)")

    # each model's training shapes, the top layer with its stride-0 prior
    times = {}
    for model, (b, shapes) in training_latents().items():
        rows = []
        for layer, (c, h, w) in enumerate(shapes):
            top = layer == len(shapes) - 1
            n = b * c * h * w
            q = rnd(b, 2 * c, h, w)
            p = rnd(1, 2 * c, h, w).expand(b, -1, -1, -1) if top else rnd(b, 2 * c, h, w)
            index = torch.randperm(N_TRAIN, generator=g)[:b].to(dev)
            args = (q, p, index, 77, 5, layer)
            fns = {"plain": lambda: sk._plain_sample_kl_per_sample(*args),
                   "kernel": lambda: sk.sample_kl_per_sample(*args)}
            per_call, device = time_calls(fns)
            # q in, z out (4 B each per element, q two planes); p once per
            # row of its own; the rows' index in, their KL sums out
            n_bytes = n * 12 + (1 if top else b) * c * h * w * 8 + b * 12
            rows.append(timing_row(per_call, device, bound(n_bytes, n * OPS_SAMPLE_KL)))
            print_times("K1", f"[{b},{2 * c},{h},{w}]" + (" stride-0 prior" if top else ""),
                        rows[-1], card)
        times[model] = {**sum_rows(rows), "layers": rows}
        print_times("K1", f"{model}, {len(shapes)} layers at B={b} summed", times[model], card)

    # the wrapper's host time, where the call is host-bound: the flagship's
    # 4x4 layer, through the autograd.Function as the model calls it
    c, h, w = LATENT_SHAPES[1]
    q = rnd(TRAIN_B, 2 * c, h, w).requires_grad_()
    p = rnd(TRAIN_B, 2 * c, h, w).requires_grad_()
    gz = torch.randn(TRAIN_B, c, h, w, generator=g).to(dev)
    gkl = torch.randn(TRAIN_B, generator=g).to(dev)
    index = torch.randperm(N_TRAIN, generator=g)[:TRAIN_B].to(dev)
    keyed = sk.Keyed(index, 77, 5, 1)

    def fwd_bwd():
        z, kl = sk.sample_kl_per_sample(q, p, index, 77, 5, 1)
        torch.autograd.backward([z, kl], [gz, gkl])

    with torch.no_grad():
        host = {"forward": host_ms(lambda: sk.sample_kl_per_sample(q, p, index, 77, 5, 1)),
                "backward": host_ms(lambda: sk.sample_kl_backward(q, p, gz, gkl, keyed=keyed))}
    host["forward + backward"] = host_ms(fwd_bwd)
    print(f"  host ms per call at [{TRAIN_B},{2 * c},{h},{w}] (wall over 300 calls, the card "
          f"idle between): sample_kl_per_sample {host['forward']:.4f} ms, sample_kl_backward "
          f"keyed {host['backward']:.4f} ms, forward + backward through autograd "
          f"{host['forward + backward']:.4f} ms  ({card})")
    return err, times, host


def phase_bwd(card):
    """K1-bwd and K2-bwd against autograd of the plain forward, given eps
    and keyed, at the flagship's and celeba64's training shapes and at
    ODD_SHAPE; the stride-0 prior's gradient summed in the kernel against
    the plain per-row one summed over B; K1-bwd timed keyed, as the
    trainer calls it, and given eps, at both models' training shapes, and
    K2-bwd given eps at the flagship's."""
    import torch

    from lvae_tpu_torch.kernels import stochastic as sk

    print("[7] backward kernels (K1-bwd, K2-bwd) vs autograd of the plain forward",
          flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    err = {"k1": 0.0, "k2": 0.0}

    def rnd(*s):
        return torch.randn(*s, generator=g).to(dev)

    def operands(b, c, h, w, top):
        q = rnd(b, 2 * c, h, w) * 0.7
        p1 = rnd(1 if top else b, 2 * c, h, w) * 0.7
        eps, gz = rnd(b, c, h, w), rnd(b, c, h, w)
        index = torch.randperm(N_TRAIN, generator=g)[:b].to(dev)
        gkl_map = rnd(b, c, h, w)
        gkl_map[::4] = 0.0                       # rows a free-bits clamp zeroes
        gkl_row = rnd(b)
        gkl_row[::3] = 0.0
        return q, p1, eps, gz, index, gkl_map, gkl_row

    flag_b, flag = training_latents()["flagship"]
    cel_b, cel = training_latents()["celeba64"]
    checked = ([(flag_b, s, i == len(flag) - 1) for i, s in enumerate(flag)]
               + [(flag_b, ODD_SHAPE, False)]
               + [(cel_b, s, i == len(cel) - 1) for i, s in enumerate(cel)])
    for layer, (b, (c, h, w), top) in enumerate(checked):
        shape = f"[{b},{2 * c},{h},{w}]" + (" stride-0 prior" if top else "")
        q, p1, eps, gz, index, gkl_map, gkl_row = operands(b, c, h, w, top)
        print(f"  {shape} {sk.k1_bwd_plan(b, c, h * w, top)}")

        def expand(t):
            return t.expand(b, -1, -1, -1) if top else t

        def grads(fn, gkl, *args):
            qr, pr = q.clone().requires_grad_(), p1.clone().requires_grad_()
            z, kl = fn(qr, expand(pr), *args)
            torch.autograd.backward([z, kl], [gz, gkl])
            return qr.grad, pr.grad

        for name, per_sample, gkl in (("k2", False, gkl_map), ("k1", True, gkl_row)):
            label = "K1-bwd" if per_sample else "K2-bwd"
            plain_fwd = (sk._plain_sample_kl_per_sample_eps if per_sample
                         else sk._plain_sample_kl_eps)
            dq_r, dp_r = grads(plain_fwd, gkl, eps)
            dq, dp = sk.sample_kl_backward(q, expand(p1), gz, gkl, eps=eps)
            if top:
                check(tuple(dp.shape) == tuple(p1.shape),
                      f"{label} {shape}: the prior's gradient comes back "
                      f"{list(p1.shape)} ({list(dp.shape)})")
                _, dp_rows = sk._plain_sample_kl_bwd(q, expand(p1).contiguous(), eps, gz, gkl)
                e = rel_max(dp, dp_rows.sum(dim=0, keepdim=True))
                check(e <= 1e-5, f"{label} {shape}: the prior's gradient summed in the kernel "
                                 f"within 1e-5 of its max of the plain per-row one summed "
                                 f"over B ({e:.2e})")
            e = max(rel_max(dq, dq_r), rel_max(dp, dp_r))
            err[name] = max(err[name], (dq - dq_r).abs().max().item(),
                            (dp - dp_r).abs().max().item())
            check(e <= 1e-5, f"{label} {shape}: dq, dp within 1e-5 relative of "
                             f"autograd ({e:.2e})")
            if per_sample and not top:
                check(bool((dp[::3] == 0).all()), f"{label} rows with gkl = 0 give dp = 0")
            # keyed noise through the autograd.Function: the backward kernel
            # regenerates eps from the Philox counter
            keyed = sk.sample_kl_per_sample if per_sample else sk.sample_kl
            keyed_plain = (sk._plain_sample_kl_per_sample if per_sample
                           else sk._plain_sample_kl)
            a = grads(keyed, gkl, index, 9, 0, layer)
            r = grads(keyed_plain, gkl, index, 9, 0, layer)
            e = max(rel_max(a[0], r[0]), rel_max(a[1], r[1]))
            check(e <= 1e-5, f"{label} {shape} keyed, through the autograd.Function "
                             f"({e:.2e})")
        del q, p1, eps, gz, gkl_map

    def traffic(b, c, h, w, top, eps_in, gkl_map):
        """q, gz (and eps, K2-bwd's gkl map) in, dq out; p in and dp out
        once per row of their own; the rows' index and gkl."""
        n = b * c * h * w
        per = 8 + 4 + 8 + (4 if eps_in else 0) + (4 if gkl_map else 0)
        n_bytes = n * per + (1 if top else b) * c * h * w * 16 + b * (4 + (0 if eps_in else 8))
        return bound(n_bytes, n * (OPS_SAMPLE_KL_BWD + (0 if eps_in else OPS_SAMPLE_KL)))

    times = {"k1": {}, "k1_eps": {}}
    for model, (b, shapes) in training_latents().items():
        rows = {"k1": [], "k1_eps": []}
        for layer, (c, h, w) in enumerate(shapes):
            top = layer == len(shapes) - 1
            shape = f"[{b},{2 * c},{h},{w}]" + (" stride-0 prior" if top else "")
            q, p1, eps, gz, index, _, gkl = operands(b, c, h, w, top)
            pe = p1.expand(b, -1, -1, -1) if top else p1
            keyed = sk.Keyed(index, 9, 0, layer)
            for name, kw in (("k1", {"keyed": keyed}), ("k1_eps", {"eps": eps})):
                fns = {"plain": lambda: sk._plain_sample_kl_bwd(
                           q, pe, kw["eps"] if "eps" in kw else sk._eps_of(keyed, q), gz, gkl),
                       "kernel": lambda: sk.sample_kl_backward(q, pe, gz, gkl, **kw)}
                per_call, device = time_calls(fns)
                rows[name].append(timing_row(per_call, device,
                                             traffic(b, c, h, w, top, name == "k1_eps", False)))
                print_times("K1-bwd " + ("keyed" if name == "k1" else "given eps"), shape,
                            rows[name][-1], card)
        for name in rows:
            times[name][model] = {**sum_rows(rows[name]), "layers": rows[name]}
            print_times("K1-bwd " + ("keyed" if name == "k1" else "given eps"),
                        f"{model}, {len(shapes)} layers at B={b} summed", times[name][model],
                        card)

    # K2-bwd (on no entry point's path), given eps at the flagship's shapes
    rows = []
    for layer, (c, h, w) in enumerate(flag):
        top = layer == len(flag) - 1
        q, p1, eps, gz, _, gkl, _ = operands(flag_b, c, h, w, top)
        pe = p1.expand(flag_b, -1, -1, -1) if top else p1
        fns = {"plain": lambda: sk._plain_sample_kl_bwd(q, pe, eps, gz, gkl),
               "kernel": lambda: sk.sample_kl_backward(q, pe, gz, gkl, eps=eps)}
        per_call, device = time_calls(fns)
        rows.append(timing_row(per_call, device, traffic(flag_b, c, h, w, top, True, True)))
        print_times("K2-bwd given eps", f"[{flag_b},{2 * c},{h},{w}]"
                    + (" stride-0 prior" if top else ""), rows[-1], card)
    times["k2"] = {**sum_rows(rows), "layers": rows}
    return err, times


FLAGSHIP_ARGS = [
    "--dataset", "static_mnist", "--zdims", "32", "32", "32", "--downsample",
    "1", "1", "1", "--nonlin", "elu", "--skip", "--blocks-per-layer", "4",
    "--gated", "--freebits", "0.5", "--learn-top-prior", "--seed", "42",
    "--batch-size", str(TRAIN_B), "--dropout", "0.2", "--test-batch-size", str(B),
]


def train_data():
    """Synthetic static_mnist-shaped splits (50,000 train, 10,000 test)."""
    from lvae_tpu_torch.data.sources import make_synthetic

    return make_synthetic(n_train=N_TRAIN, n_test=N_TEST, seed=6)


def flagship_dataset(train_u8, test_u8):
    """The splits as the trainer's static_mnist dataset."""
    from lvae_tpu_torch.data.registry import Dataset

    return Dataset("static_mnist", test_u8, (28, 28), (32, 32), 1, "none", "bernoulli",
                   train=train_u8)


def init_launches(args, data):
    """The kernel launches of the data-dependent init alone of the model
    of the training CLI ``args`` on ``data`` (its train-mode statistics
    passes sample the latents with K1, as ``lvae_tpu``'s do; a pass stops
    at the conv it measures)."""
    import torch

    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.train.trainer import Experiment

    cfg, _ = config_from_args(args + ["--data-dep-init"])
    exp = Experiment(cfg, torch.device("cuda"), data)
    build.reset_launches()
    exp.init_state()
    torch.cuda.synchronize()
    n = dict(build.LAUNCHES)
    build.reset_launches()
    return n


def write_mnist(data_dir, train_u8, test_u8):
    """The splits as static_mnist's .amat files under ``data_dir``."""
    os.makedirs(os.path.join(data_dir, "static_mnist"))
    for split, arr in (("train", train_u8), ("test", test_u8)):
        write_amat(os.path.join(data_dir, "static_mnist", f"binarized_mnist_{split}.amat"),
                   arr)


def phase_train(card, train_u8, test_u8):
    import torch

    from lvae_tpu_torch import evaluate
    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build

    print("[8] the training slice through lvae_tpu_torch.main", flush=True)
    init = init_launches(FLAGSHIP_ARGS, flagship_dataset(train_u8, test_u8))
    n_init = init["sample_kl_per_sample"]
    print(f"  data-dependent init alone launches K1 {n_init} times and the dropout kernel "
          f"{init['dropout']}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        write_mnist(data_dir, train_u8, test_u8)
        build.reset_launches()
        t0 = time.perf_counter()
        trainer = train_main.main(FLAGSHIP_ARGS + [
            "--data-dir", data_dir, "--data-dep-init", "--max-steps", str(TRAIN_STEPS),
            "--device", "cuda", "--log-interval", "30", "--test-interval", "150",
            "--checkpoint-interval", "100", "--output-dir", os.path.join(tmp, "out"),
            "--run-name", "flagship",
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        print(f"  launches in the training run: {launches}")
        print(f"  run wall {wall:.1f} s (data parse, data-dependent init, "
              f"{TRAIN_STEPS} steps, 2 test sweeps, 3 checkpoints)  ({card})")
        n = 3 * TRAIN_STEPS
        check(launches["sample_kl_per_sample"] == n + n_init,
              f"K1: 3 launches per step and the init's {n_init} "
              f"({launches['sample_kl_per_sample']})")
        check(launches["sample_kl_per_sample_bwd"] == n,
              f"K1-bwd: 3 launches per step ({launches['sample_kl_per_sample_bwd']})")
        sites = unfused_dropouts(trainer.state.model)
        check(sites > 0 and launches["dropout"] == 2 * sites * TRAIN_STEPS + init["dropout"],
              f"the dropout kernel: forward and backward at each of the {sites} dropout "
              f"sites per step, and the init's {init['dropout']} ({launches['dropout']})")
        check(launches["sample_kl"] > 0 and launches["sample_kl_bwd"] == 0,
              f"the test hook ran K2 forward only ({launches['sample_kl']} launches)")
        hist = trainer.logger.history
        check(all(np.isfinite(np.asarray(v, dtype=np.float64)).all()
                  for _, _, m in hist for v in m.values()),
              f"every logged metric finite ({len(hist)} lines)")
        train_lines = {step: m for kind, step, m in hist if kind == "train"}
        first, last = float(train_lines[30]["loss"]), float(train_lines[TRAIN_STEPS]["loss"])
        check(last < first, f"EMA loss {last:.2f} at step {TRAIN_STEPS} below "
                            f"{first:.2f} at step 30")
        tests = [m for kind, _, m in hist if kind == "test"]
        check(len(tests) == 2, "the test hook ran at steps 150 and 300")
        ckpt = os.path.join(trainer.run_dir, "checkpoints", f"ckpt_{TRAIN_STEPS:08d}.pt")
        res = evaluate.main(["--load", trainer.run_dir, "--state-dict", ckpt,
                             "--device", "cuda"])
        e = res["elbo"]
        d = abs(e["elbo"] - tests[-1]["elbo"])
        check(np.isfinite(e["elbo"]) and d <= 1e-2,
              f"evaluate scores the checkpoint: ELBO {e['elbo']:.3f}, the run's "
              f"last test ELBO {tests[-1]['elbo']:.3f}")
        out["launches"] = launches
        out["wall_s"] = wall
        out["log_rates"] = {step: float(m["images_per_sec"]) for step, m in train_lines.items()}
        # the lines from step 120 on: 30-step windows over steps 91-300
        late = [r for step, r in out["log_rates"].items() if step > 100]
        out["log_rate_91_300"] = len(late) / sum(1.0 / r for r in late)
        print(f"  logged train rate over steps 91-{TRAIN_STEPS} (a metric sync every "
              f"30 steps, the checkpoints at 100 and 200 inside): "
              f"{out['log_rate_91_300']:.1f} img/s  ({card})")
        out["test_elbo"] = [float(m["elbo"]) for m in tests]
        out["ema_loss"] = (first, last)
    return out


def bn_fed_biases(model):
    """Names of the conv biases whose output only a BatchNorm reads: in a
    residual block, a conv whose next letter of the block type other than
    dropout's is a BatchNorm. Without dropout their gradient is zero but
    for roundoff (the BatchNorm takes out any per-channel shift)."""
    from lvae_tpu_torch.models.blocks import ResidualBlock

    names = set()
    for name, m in model.named_modules():
        if isinstance(m, ResidualBlock) and m.batchnorm:
            letters = m.block_type.replace("d", "")
            for nc, i in enumerate(i for i, ch in enumerate(letters) if ch == "c"):
                if letters[i + 1: i + 2] == "b":
                    names.add(f"{name}.Conv_{nc}.bias")
    return names


def phase_step(card, title, args, data, weights, cpu_batch, ab_steps, ab_log,
               paths=("auto", "none"), card_dropout=None, cpu=("none", 0.0)):
    """One step of the model of the training CLI ``args`` on ``data``
    from ``weights``: the kernel path ``paths[0]`` against the path
    ``paths[1]`` on the card (deterministic cuDNN; dropout ``card_dropout``,
    the config's when None) and against the CPU's path ``cpu[0]`` at
    ``cpu_batch`` images with dropout ``cpu[1]`` (no CPU step when
    ``cpu_batch`` is None; every dropout mask is keyed Philox bytes, the
    same on both); then train images/s through ``Trainer.run``, the two
    paths alternating (K, P, P, K, ``ab_steps`` steps each, the rate over
    the steps after ``ab_log``), and a 5-step profile of ``paths[0]``."""
    import dataclasses

    import torch

    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.data.device import preprocess_batch
    from lvae_tpu_torch.models.stochastic import Noise
    from lvae_tpu_torch.ops.math import linear_anneal
    from lvae_tpu_torch.train.state import loss_terms
    from lvae_tpu_torch.train.trainer import Experiment, Trainer

    print(title, flush=True)
    cfg, _ = config_from_args(args)
    order = np.random.default_rng((cfg.seed, 0)).permutation(data.train.shape[0])

    def one_step(fused, device, dropout, batch):
        exp = Experiment(dataclasses.replace(cfg, fused=fused, dropout=dropout),
                         torch.device(device), data)
        exp.model.load_state_dict(weights)
        state = exp.init_state(data_dep_init=False)
        index = torch.from_numpy(order[:batch]).to(device)
        x = preprocess_batch(exp.train_data.gather(index), data.preprocess, state.seed,
                             index, 0)
        loss, m = loss_terms(exp.model, x, Noise(state.seed, index, 0),
                             linear_anneal(0, 0.0, 1.0, cfg.beta_anneal), cfg.freebits)
        loss.backward()
        return (loss.item(), m["kl_layers"].detach().cpu(),
                {k: p.grad.detach().cpu() for k, p in exp.model.named_parameters()},
                {k: b.detach().cpu() for k, b in exp.model.named_buffers()
                 if k.endswith(("running_mean", "running_var"))},
                bn_fed_biases(exp.model))

    def compare(a, b, tol, what, zero_grads=()):
        """Each gradient within ``tol`` of its own max; those named in
        ``zero_grads`` (zero but for roundoff) within ``tol`` of the
        largest gradient's."""
        rel = abs(a[0] - b[0]) / abs(b[0])
        gmax = max(g.abs().max().item() for g in b[2].values())
        errs = {k: rel_max(a[2][k], g, gmax if k in zero_grads else 0.0)
                for k, g in b[2].items()}
        worst = max((e, k) for k, e in errs.items() if k not in zero_grads)
        stats = max((a[3][k] - v).abs().max().item() for k, v in b[3].items())
        print(f"  {what}: loss {a[0]:.6f} vs {b[0]:.6f} (rel {rel:.2e}); worst "
              f"gradient {worst[0]:.2e} ({worst[1]}); BN running stats {stats:.2e}")
        if zero_grads:
            zw = max((errs[k], k) for k in zero_grads)
            own = max((rel_max(a[2][k], b[2][k]), k) for k in zero_grads)
            print(f"  {what}: the {len(zero_grads)} biases that only a BatchNorm reads: "
                  f"worst {zw[0]:.2e} of the largest gradient ({zw[1]}); "
                  f"{own[0]:.2e} of its own max ({own[1]})")
            worst = max(worst, zw)
        check(rel <= tol, f"{what}: loss within {tol:g} relative")
        check(worst[0] <= tol, f"{what}: every parameter gradient within {tol:g} "
                               f"relative to its max")
        return stats

    kern, plain = paths
    drop = cfg.dropout if card_dropout is None else card_dropout
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        k = one_step(kern, "cuda", drop, cfg.batch_size)
        p = one_step(plain, "cuda", drop, cfg.batch_size)
        print(f"  per-layer KL of the batch: {k[1].numpy()} (free bits {cfg.freebits})")
        # a BatchNorm-fed bias's gradient is roundoff: where one path runs
        # the fused segments and the other does not, it is held to the
        # largest gradient
        segments = {"segments", "all"}
        stats = compare(k, p, 1e-4, f"--fused {kern} vs {plain} on the card, batch "
                                    f"{cfg.batch_size}, dropout {drop}",
                        zero_grads=k[4] if (kern in segments) != (plain in segments) else ())
        check(stats <= 1e-6, f"BN running stats within 1e-6 ({stats:.2e})")
        if cpu_batch is not None:
            # the dropout masks are keyed Philox bytes: the same on both
            kc = one_step(kern, "cuda", cpu[1], cpu_batch)
            c = one_step(cpu[0], "cpu", cpu[1], cpu_batch)
            compare(kc, c, 1e-3, f"the card (--fused {kern}) vs the CPU (--fused {cpu[0]}), "
                                 f"batch {cpu_batch}, dropout {cpu[1]}", zero_grads=c[4])
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False

    def trainer(fused, steps, log_interval):
        """A Trainer (the entry point's loop: its index stream and log
        hook) over ``steps`` steps, no data-dependent init, no test,
        checkpoint or files."""
        run_cfg = dataclasses.replace(
            cfg, fused=fused, max_steps=steps, log_interval=log_interval,
            test_interval=10 ** 9, checkpoint_interval=10 ** 9, dry_run=True)
        return Trainer(Experiment(run_cfg, torch.device("cuda"), data))

    def train_rate(fused):
        """Images/s over the steps after ``ab_log`` from the Trainer's log
        lines."""
        tr = trainer(fused, ab_steps, ab_log)
        tr.run()
        rates = [float(m["images_per_sec"]) for kind, step, m in tr.logger.history
                 if kind == "train" and step > ab_log]
        return len(rates) / sum(1.0 / r for r in rates)

    rates = {True: [], False: []}
    for fused in (True, False, False, True):
        rates[fused].append(train_rate(kern if fused else plain))
    out = {"train_images_per_sec": {"kernels": float(np.mean(rates[True])),
                                     "plain": float(np.mean(rates[False])),
                                     "paths": [kern, plain],
                                     "runs": {"kernels": rates[True], "plain": rates[False]}}}
    b = cfg.batch_size
    for name, fused in (("kernels", True), ("plain", False)):
        r = out["train_images_per_sec"][name]
        print(f"  Trainer.run, steps {ab_log + 1}-{ab_steps}, batch {b}, --fused "
              f"{kern if fused else plain}: {r:.1f} img/s, {1e3 * b / r:.2f} ms/step "
              f"(runs {rates[fused]})  ({card})")

    # where a step's time goes: Trainer.run over 5 kernel-path steps (its
    # set-up inside: a fresh optimiser and the epoch's shuffle)
    prof_run = trainer(kern, 5, 5)
    host = []
    busy, wall, table, n_events = device_profile(prof_run.run, host_top=host)
    out["train_profile"] = {"device_busy_ms": busy, "wall_ms": wall,
                            "idle_share": 1.0 - busy / wall, "top": table,
                            "host_top": host, "kernel_events": n_events}
    print(f"  train profile, --fused {kern}, Trainer.run of 5 steps of {b}: wall "
          f"{wall:.2f} ms, device busy {busy:.2f} ms ({busy / 5:.2f} ms per step), idle "
          f"share {1.0 - busy / wall:.3f}, {n_events} kernel events ({n_events / 5:.0f} "
          f"per step)  ({card})")
    for name, ms, count in table:
        print(f"    {ms:8.3f} ms  x{count:<4d} {name}")
    print("  host operators by self CPU time, 5 steps (under the profiler):")
    for name, ms, count in host:
        print(f"    {ms:8.3f} ms  x{count:<5d} {name}")
    return out


# ---------------------------------------------------------------------------
# celeba64: the mixture-head model (phases 10-13)
# ---------------------------------------------------------------------------

K_MIX = 10
# (B, C, H, W, K): celeba64's training and evaluation batches, a C = 1 case,
# and a K whose one-pass terms leave no room for a second CTA on an SM (the
# two-pass plan by default; every model of the repo has K = 10)
MIX_SHAPES = [(128, 3, 64, 64, K_MIX), (500, 3, 64, 64, K_MIX), (16, 1, 32, 32, K_MIX),
              (32, 3, 64, 64, 24)]
CELEBA_B, CELEBA_EVAL_B = 128, 500
CELEBA_N_TRAIN, CELEBA_N_TEST = 20_000, 2_000
CELEBA_STEPS = 200
SEGMENT_STEPS = 100                         # phase 15
CELEBA_LATENTS = [(16, 16, 32), (8, 8, 32), (4, 4, 32), (2, 2, 32)]   # NHWC per layer
CELEBA = {
    "dataset": "celeba", "zdims": [32] * 4, "downsample": [1] * 4,
    "blocks_per_layer": 2, "n_filters": 64, "gated": True, "skip": True,
    "learn_top_prior": True, "nonlin": "elu", "dropout": 0.2, "freebits": 0.5,
    "test_batch_size": CELEBA_EVAL_B, "fused": "auto", "batch_size": CELEBA_B,
}
CELEBA_ARGS = [
    "--dataset", "celeba", "--zdims", "32", "32", "32", "32", "--downsample", "1", "1",
    "1", "1", "--blocks-per-layer", "2", "--n-filters", "64", "--skip", "--gated",
    "--learn-top-prior", "--freebits", "0.5", "--dropout", "0.2", "--seed", "42",
    "--batch-size", str(CELEBA_B), "--test-batch-size", str(CELEBA_EVAL_B),
]


def rgb_blobs(n, seed, img=64):
    """``n`` synthetic RGB images, uint8 ``[n, img, img, 3]``: a Gaussian
    blob per channel at a random centre and radius (the shape of
    ``lvae_tpu``'s RGB fixture), drawn on the card."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    ax = torch.arange(img, device=dev, dtype=torch.float32)
    yy, xx = ax.view(1, img, 1, 1), ax.view(1, 1, img, 1)

    def draw(lo, hi):
        return torch.rand(n, 1, 1, 3, generator=g, device=dev) * (hi - lo) * img + lo * img

    cx, cy, r = draw(0.25, 0.75), draw(0.25, 0.75), draw(0.1, 0.3)
    blob = torch.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r ** 2))
    return (blob * 255).clamp(0, 255).to(torch.uint8).cpu().numpy()


def celeba_dataset(train_u8, test_u8):
    """The splits as the registry's celeba (64x64 RGB, dequantized, the
    mixture head)."""
    from lvae_tpu_torch.data.registry import Dataset

    return Dataset("celeba", test_u8, (64, 64), (64, 64), 3, "dequantize",
                   "discretized_logistic_mix", train=train_u8)


def write_celeba(data_dir, train_u8, test_u8):
    """The splits as the loader's ``celeba/celeba_64.npz`` cache."""
    os.makedirs(os.path.join(data_dir, "celeba"), exist_ok=True)
    np.savez(os.path.join(data_dir, "celeba", "celeba_64.npz"), train=train_u8, test=test_u8)


def mix_kernel_name(entry):
    m = re.search(r"(mix_\w+?_kernel)ILi(\d)E", entry)
    return f"{m[1]}<{m[2]}>" if m else entry


def phase_mixture(card, build_log=""):
    """K3 and K3-bwd against their plain versions at every ``MIX_SHAPES``
    entry, K3-bwd on each of its plans; both timed at celeba64's batches,
    K3-bwd on each plan at the training batch and at the large K; the
    kernels' registers, spills and shared memory."""
    import torch

    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.kernels import mixture as km

    print("[10] mixture log-prob kernels (K3, K3-bwd) vs their plain versions", flush=True)
    more = {"ptxas": {}, "plans": {}}
    for entry, line in ptxas_usage(build_log, "mixture_cu").items():
        more["ptxas"][mix_kernel_name(entry)] = line
        print(f"  ptxas {mix_kernel_name(entry)}: {line}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    err = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for b, c, h, w, k in MIX_SHAPES:
        shape = f"[{b},{k * (1 + 3 * c)},{h},{w}] C={c} K={k}"
        u = torch.randint(0, 256, (b, c, h, w), generator=g, device=dev)
        u[:, :, 0] = 0                      # exact 0 and 1 pixels: the edge bins
        u[:, :, -1] = 255
        x = u.float() / 255.0
        p = torch.randn(b, k * (1 + 3 * c), h, w, generator=g, device=dev)
        lo = k + k * c                      # the first log-scale channels
        p[:, lo:lo + 2] = -9.0 + torch.rand(b, 2, h, w, generator=g, device=dev)
        gg = torch.randn(b, h, w, generator=g, device=dev)

        ll = km.mix_log_prob(x, p, k)
        ref = km._plain_mix_log_prob(x, p, k, 256)
        e = ((ll - ref).abs() - 1e-5 * ref.abs()).max().item()
        err["fwd"] = max(err["fwd"], (ll - ref).abs().max().item())
        check(e <= 1e-4, f"K3 {shape}: ll within 1e-4 + 1e-5 |ll| (max |d| - 1e-5 |ll| "
                         f"= {e:.2e}; ll in [{ref.min().item():.1f}, {ref.max().item():.1f}])")
        check(torch.equal(ll, km.mix_log_prob(x, p, k)), f"K3 {shape}: a second launch "
                                                         f"is bit-equal")

        default = km.bwd_plan(k, c)
        plans = km.PLANS                    # one_pass fits a CTA at every K here
        more["plans"][shape] = {"default": default.name, "smem": default.smem}
        print(f"  K3-bwd {shape}: default plan {default.name} ({default.smem} B of shared "
              f"memory per CTA of {km.THREADS}); checked: {', '.join(plans)}")
        dp, dx = km.mix_log_prob_backward(x, p, gg, k)
        dp_h, dx_h = km._plain_mix_log_prob_bwd(x, p, gg, k, 256)
        xr, pr = x.clone().requires_grad_(), p.clone().requires_grad_()
        km._plain_mix_log_prob(xr, pr, k, 256).backward(gg)
        check(bool((pr.grad[:, lo:lo + 2] == 0).all()),
              f"{shape}: autograd of the plain forward has no gradient where the "
              f"log-scale is below -7")
        for plan in plans:
            dpf, dxf = km.mix_log_prob_backward(x, p, gg, k, plan=plan)
            for what, dpr, dxr in (("the plain hand backward", dp_h, dx_h),
                                   ("autograd of the plain forward", pr.grad, xr.grad)):
                e = max(rel_max(dpf, dpr), rel_max(dxf, dxr))
                check(e <= 1e-4, f"K3-bwd {shape} {plan}: dparams, dx within 1e-4 of their "
                                 f"max vs {what} ({e:.2e})")
            err["bwd"] = max(err["bwd"], (dpf - dp_h).abs().max().item(),
                             (dxf - dx_h).abs().max().item())
            # each block of channels against its own max (printed, not checked)
            blocks = {"dpi": (0, k), "dm": (k, lo), "dls": (lo, lo + k * c),
                      "dco": (lo + k * c, None)}
            by = {n: rel_max(dpf[:, a:z], dp_h[:, a:z]) for n, (a, z) in blocks.items()}
            more["plans"][shape][f"{plan}_rel_err_by_block"] = by
            print(f"  K3-bwd {shape} {plan}: each block within its own max vs the plain hand "
                  f"backward: " + ", ".join(f"{n} {v:.2e}" for n, v in by.items()))
            check(bool((dpf[:, lo:lo + 2] == 0).all()),
                  f"K3-bwd {shape} {plan}: no gradient where the log-scale is below -7")
            dp2, dx2 = km.mix_log_prob_backward(x, p, gg, k, plan=plan)
            check(torch.equal(dpf, dp2) and torch.equal(dxf, dx2),
                  f"K3-bwd {shape} {plan}: a second launch is bit-equal")
            if plan == default.name:
                check(torch.equal(dpf, dp) and torch.equal(dxf, dx),
                      f"K3-bwd {shape}: the default launch is {plan}, bit for bit")
            del dpf, dxf, dp2, dx2
        pk = p.clone().requires_grad_()
        build.reset_launches()
        km.mix_log_prob(x, pk, k).backward(gg)
        check(build.LAUNCHES["mix_log_prob"] == 1 and build.LAUNCHES["mix_log_prob_bwd"] == 1,
              f"{shape}: the autograd.Function launches K3 and K3-bwd once each")
        check(torch.equal(pk.grad, dp), f"{shape}: its gradient is K3-bwd's")
        build.reset_launches()
        del xr, pr, pk, dp_h, dx_h
        if c == 3 and k != K_MIX:           # both plans where two passes is the default
            for plan in plans:
                t = cuda_ms(lambda: km.mix_log_prob_backward(x, p, gg, k, need_dx=False,
                                                             plan=plan), 10)
                more["plans"][shape][f"{plan}_ms"] = t
                print(f"  time K3-bwd {shape} {plan} per call: {t:.4f} ms  ({card})")
        if c != 3 or k != K_MIX:
            continue
        fwd = lambda: km.mix_log_prob(x, p, k)                          # noqa: E731
        fwd_plain = lambda: km._plain_mix_log_prob(x, p, k, 256)        # noqa: E731
        # the trainer's call: x needs no gradient
        bwd = lambda: km.mix_log_prob_backward(x, p, gg, k, need_dx=False)  # noqa: E731
        bwd_plain = lambda: km._plain_mix_log_prob_bwd(x, p, gg, k, 256)     # noqa: E731
        two = lambda: km.mix_log_prob_backward(x, p, gg, k, need_dx=False,   # noqa: E731
                                               plan="two_pass")
        q = k * (1 + 3 * c)
        for name, kern, plain in (("K3", fwd, fwd_plain), ("K3-bwd", bwd, bwd_plain)):
            t = [cuda_ms(plain, 10), cuda_ms(kern, 20), cuda_ms(kern, 20), cuda_ms(plain, 10)]
            dk, dpl = device_ms(kern, 10), device_ms(plain, 5)
            # per pixel: params (100 floats), x (3) and ll in; the backward
            # adds g and writes dparams. Operations: ~40 per bin (30 bins;
            # each transcendental counted once), as many again for the
            # backward's gradient terms
            per = 4 * (q + c + 1) + (4 * q if name == "K3-bwd" else 0)
            ops = k * c * 40 * (2 if name == "K3-bwd" else 1)
            times[(name, b)] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2, dk, dpl,
                                *bound(b * h * w * per, b * h * w * ops))
            print(f"  time {name} {shape} per call: kernel {times[(name, b)][0]:.4f} ms, "
                  f"plain {times[(name, b)][1]:.4f} ms; device busy: kernel {fmt_ms(dk)}, "
                  f"plain {fmt_ms(dpl)}  ({card})")
        if b != CELEBA_B:
            continue
        # the default plan against the two-pass schedule, in turns
        t = [cuda_ms(two, 20), cuda_ms(bwd, 20), cuda_ms(bwd, 20), cuda_ms(two, 20)]
        times[("K3-bwd two_pass", b)] = ((t[0] + t[3]) / 2, device_ms(two, 10))
        print(f"  time K3-bwd {shape} per call: {default.name} {(t[1] + t[2]) / 2:.4f} ms, "
              f"two_pass {times[('K3-bwd two_pass', b)][0]:.4f} ms (device "
              f"{fmt_ms(times[('K3-bwd two_pass', b)][1])})  ({card})")
    torch.cuda.empty_cache()
    return err, times, more


def phase_celeba_eval(card, train_u8, test_u8):
    import torch

    from lvae_tpu_torch import evaluate, serving
    from lvae_tpu_torch.data.device import eval_preprocess_batch
    from lvae_tpu_torch.eval.iwll import evaluate_iwll
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.train.state import evaluate_elbo

    print("[11] celeba64 through lvae_tpu_torch.evaluate.main", flush=True)
    dev = torch.device("cuda")
    meta = celeba_dataset(train_u8, test_u8)
    model = seeded_model(CELEBA, meta, dev)
    b, dims = CELEBA_EVAL_B, 64 * 64 * 3
    out = {}
    with tempfile.TemporaryDirectory() as run_dir:
        data_dir = os.path.join(run_dir, "data")
        write_celeba(data_dir, train_u8[:1], test_u8)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(dict(CELEBA, data_dir=data_dir), f)
        weights = os.path.join(run_dir, "weights.pt")
        torch.save(model.state_dict(), weights)

        build.reset_launches()
        res = evaluate.main(["--load", run_dir, "--state-dict", weights, "--ll",
                             "--iw-samples", str(IW_SAMPLES), "--iw-max-batches", "1",
                             "--device", "cuda"])
        launches = dict(build.LAUNCHES)
    n_fwd = CELEBA_N_TEST // b + IW_SAMPLES
    print(f"  launches in the evaluate run: {launches}")
    check(launches["mix_log_prob"] == n_fwd and launches["mix_log_prob_bwd"] == 0,
          f"K3: 1 launch per forward ({launches['mix_log_prob']}), no K3-bwd")
    check(launches["sample_kl"] == 4 * n_fwd,
          f"K2: 4 launches per forward ({launches['sample_kl']})")
    check(launches["logsumexp"] == 1, "K4: 1 launch per IW batch")
    m, iw = res["elbo"], res["iw"]
    check(m["n_images"] == CELEBA_N_TEST and iw["n_images"] == b, "sweep sizes")
    vals = [m["elbo"], m["ll"], m["kl"], m["bpd"], iw["iw_ll"], iw["iw_bpd"], *m["kl_layers"]]
    check(all(np.isfinite(v) for v in vals), "finite metrics")
    check(min(m["kl_layers"]) > 0.1, f"every layer has KL > 0.1 nats ({m['kl_layers']})")
    check(abs(m["bpd"] + m["elbo"] / (dims * np.log(2))) < 1e-9, "bpd over 64 x 64 x 3")
    out["elbo"], out["iw"] = m, iw

    test_dev = torch.from_numpy(test_u8).to(dev)
    index = torch.arange(b, device=dev)
    x = eval_preprocess_batch(test_dev[:b], "dequantize", index)
    with torch.no_grad():
        e_k = per_image_elbo(model, x, index)
        set_kernels(model, False)
        e_p = per_image_elbo(model, x, index)
        model_cpu = seeded_model(CELEBA, meta, torch.device("cpu"))
        model_cpu.load_state_dict(model.state_dict())
        set_kernels(model_cpu, False)
        e_cpu = per_image_elbo(model_cpu, x[:8].cpu(), index[:8].cpu())
        set_kernels(model, True)
    mean, se = e_k.mean().item(), e_k.std().item() / b ** 0.5
    check(iw["iw_ll"] >= mean - 4 * se,
          f"IW-LL {iw['iw_ll']:.2f} >= ELBO {mean:.2f} - 4 se ({se:.2f}) of the same "
          f"{b} images")
    d = ((e_k - e_p).abs() / e_p.abs()).max().item()
    check(d <= 1e-5, f"per-image ELBO, kernels vs plain: within {d:.2e} of its magnitude")
    d = ((e_k[:8].cpu() - e_cpu).abs() / e_cpu.abs()).max().item()
    check(d <= 1e-4, f"per-image ELBO, GPU vs CPU: within {d:.2e} of its magnitude")

    u8 = test_dev[:64]
    r = serving.reconstruct(model, u8, 0, index[:64], preprocess="dequantize")
    check(r["out_mean"].shape == (64, 64, 64, 3) and torch.isfinite(r["elbo"]).all(),
          "reconstruct")
    d = ((r["elbo"] - e_k[:64]).abs() / e_k[:64].abs()).max().item()
    check(d <= 1e-6, f"reconstruct's ELBO is evaluate's ({d:.2e} relative)")
    d = (r["bpd"] + r["elbo"] / (dims * np.log(2))).abs().max().item()
    check(d <= 1e-6, "reconstruct's bpd over 64 x 64 x 3")
    enc = serving.encode(model, u8, 0, index[:64], preprocess="dequantize")
    check([tuple(t.shape) for t in enc["mu"]] == [(64, *s) for s in CELEBA_LATENTS],
          "encode: 4 layers")
    gen = serving.generate(model, 16, seed=3)
    check(gen.shape == (16, 64, 64, 3) and bool(((gen >= 0) & (gen <= 1)).all()),
          "generate: [16, 64, 64, 3] in [0, 1]")

    torch.cuda.synchronize()
    rates = {}
    for fused in (True, False, False, True):
        set_kernels(model, fused)
        r = evaluate_elbo(model, test_dev, "dequantize", b, dims)
        rates.setdefault(("elbo", fused), []).append(r["images_per_sec"])
    for fused, impl in ((True, "kernel"), (False, "streaming")):
        set_kernels(model, fused)
        r = evaluate_iwll(model, test_dev, "dequantize", dims, IW_SAMPLES, b,
                          logsumexp_impl=impl, max_batches=1)
        rates[("iw", fused)] = [r["images_per_sec"]]
    out["rates"] = {f"{k[0]}_{'kernels' if k[1] else 'plain'}": float(np.mean(v))
                    for k, v in rates.items()}
    for k, v in out["rates"].items():
        print(f"  celeba64 {k}: {v:.1f} img/s  ({card})")

    set_kernels(model, True)
    busy, wall, table, _ = device_profile(
        lambda: evaluate_elbo(model, test_dev[:2 * b], "dequantize", b, dims), 3)
    out["elbo_profile"] = {"device_busy_ms": busy, "wall_ms": wall,
                           "idle_share": 1.0 - busy / wall, "top": table}
    print(f"  celeba64 test-ELBO profile, 2 batches of {b}: wall {wall:.2f} ms, device "
          f"busy {busy:.2f} ms, idle share {1.0 - busy / wall:.3f}  ({card})")
    for name, ms, count in table:
        print(f"    {ms:8.3f} ms  x{count:<4d} {name}")
    out["launches"] = launches
    return out


def phase_celeba_train(card, train_u8, test_u8):
    import torch

    from lvae_tpu_torch import evaluate
    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build

    print("[12] celeba64 training through lvae_tpu_torch.main --dataset celeba", flush=True)
    init = init_launches(CELEBA_ARGS, celeba_dataset(train_u8, test_u8))
    print(f"  data-dependent init alone launches K1 {init['sample_kl_per_sample']} and K3 "
          f"{init['mix_log_prob']} times")
    steps, n_sweeps = CELEBA_STEPS, 2
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        write_celeba(data_dir, train_u8, test_u8)
        build.reset_launches()
        t0 = time.perf_counter()
        trainer = train_main.main(CELEBA_ARGS + [
            "--data-dir", data_dir, "--data-dep-init", "--max-steps", str(steps),
            "--device", "cuda", "--log-interval", "20", "--test-interval", "100",
            "--checkpoint-interval", "100", "--output-dir", os.path.join(tmp, "out"),
            "--run-name", "celeba64",
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        print(f"  launches in the training run: {launches}")
        print(f"  run wall {wall:.1f} s (data load, data-dependent init, {steps} steps, "
              f"{n_sweeps} test sweeps, 2 checkpoints)  ({card})")
        sweep_batches = n_sweeps * (CELEBA_N_TEST // CELEBA_EVAL_B)
        check(launches["mix_log_prob_bwd"] == steps,
              f"K3-bwd: 1 launch per step ({launches['mix_log_prob_bwd']})")
        check(launches["mix_log_prob"] == steps + sweep_batches + init["mix_log_prob"],
              f"K3: 1 launch per step, per test batch ({sweep_batches}) and the init's "
              f"{init['mix_log_prob']} ({launches['mix_log_prob']})")
        check(launches["sample_kl_per_sample"] == 4 * steps + init["sample_kl_per_sample"],
              f"K1: 4 launches per step and the init's {init['sample_kl_per_sample']} "
              f"({launches['sample_kl_per_sample']})")
        check(launches["sample_kl_per_sample_bwd"] == 4 * steps,
              f"K1-bwd: 4 launches per step ({launches['sample_kl_per_sample_bwd']})")
        check(launches["sample_kl"] == 4 * sweep_batches and launches["sample_kl_bwd"] == 0,
              f"the test hook ran K2 forward only ({launches['sample_kl']} launches)")
        hist = trainer.logger.history
        check(all(np.isfinite(np.asarray(v, dtype=np.float64)).all()
                  for _, _, m in hist for v in m.values()),
              f"every logged metric finite ({len(hist)} lines)")
        train_lines = {step: m for kind, step, m in hist if kind == "train"}
        first, last = float(train_lines[20]["loss"]), float(train_lines[steps]["loss"])
        check(last < first, f"EMA loss {last:.2f} at step {steps} below {first:.2f} at "
                            f"step 20")
        tests = [m for kind, _, m in hist if kind == "test"]
        check(len(tests) == n_sweeps, "the test hook ran at steps 100 and 200")
        ckpt = os.path.join(trainer.run_dir, "checkpoints", f"ckpt_{steps:08d}.pt")
        res = evaluate.main(["--load", trainer.run_dir, "--state-dict", ckpt,
                             "--device", "cuda"])
        e = res["elbo"]
        d = abs(e["elbo"] - tests[-1]["elbo"])
        check(np.isfinite(e["elbo"]) and d <= 1e-2,
              f"evaluate scores the checkpoint: ELBO {e['elbo']:.3f}, the run's last "
              f"test ELBO {tests[-1]['elbo']:.3f}")
        out["launches"] = launches
        out["wall_s"] = wall
        out["log_rates"] = {step: float(m["images_per_sec"]) for step, m in train_lines.items()}
        late = [r for step, r in out["log_rates"].items() if step > 100]
        out["log_rate_101_200"] = len(late) / sum(1.0 / r for r in late)
        print(f"  logged train rate over steps 101-{steps} (a metric sync every 20 steps): "
              f"{out['log_rate_101_200']:.1f} img/s  ({card})")
        out["test_elbo"] = [float(m["elbo"]) for m in tests]
        out["ema_loss"] = (first, last)
        out["state_keys"] = list(trainer.state.model.state_dict())
    return out


# ---------------------------------------------------------------------------
# the fused dropout+BatchNorm+activation segments (phases 14-16)
# ---------------------------------------------------------------------------

FLAGSHIP_IMAGE, CELEBA_IMAGE = (28, 28, 1), (64, 64, 3)       # NHWC, unpadded


def segment_shapes(config, meta, batch, image_shape):
    """{[B, C, H, W]: segments per step}: every shape that a fused segment
    of the model of ``config`` sees in a training forward at ``batch``,
    largest first, from forward pre-hooks on the residual blocks (every
    segment of a block sees the block's input shape)."""
    import torch

    from lvae_tpu_torch.models.blocks import ResidualBlock
    from lvae_tpu_torch.models.stochastic import Noise

    dev = torch.device("cuda")
    model = seeded_model(config, meta, dev)
    counts = {}

    def record(mod, inp):
        shape = tuple(inp[0].shape)
        counts[shape] = counts.get(shape, 0) + len(mod._segments)

    hooks = [m.register_forward_pre_hook(record)
             for m in model.modules() if isinstance(m, ResidualBlock) and m._segments]
    index = torch.arange(batch, device=dev)
    with torch.no_grad():
        model(torch.rand(batch, *image_shape, device=dev), noise=Noise(0, index, 0), train=True)
    for h in hooks:
        h.remove()
    del model
    torch.cuda.empty_cache()
    return dict(sorted(counts.items(), key=lambda kv: -np.prod(kv[0])))


def segments_per_step(model):
    """Fused segments a training step of ``model`` runs."""
    from lvae_tpu_torch.models.blocks import ResidualBlock

    return sum(len(m._segments) for m in model.modules()
               if isinstance(m, ResidualBlock) and m.fused_segments)


def segment_paths(shape):
    """{label: (path argument, forward plan or None, backward plan or None)}:
    "default", the plans that a caller gets at ``shape``, and each path it
    can be forced to, with the direction's plan where that path is legal
    and differs from the default."""
    from lvae_tpu_torch.kernels import segment as seg

    default = tuple(seg._plan(*shape, d) for d in ("fwd", "bwd"))
    out = {"default": (None, *default)}
    for path in seg.PATHS:
        plans = []
        for direction, plan in zip(("fwd", "bwd"), default):
            try:
                forced = seg._plan(*shape, direction, path)
            except ValueError:
                forced = None
            plans.append(None if forced == plan else forced)
        if any(plans):
            out[f"forced {path}"] = (path, *plans)
    return out


def kernel_events(fn, want):
    """{kernel name: events} of the device kernels of one profiled call of
    ``fn``: the first of up to five traces whose events add up to
    ``want``, else the last. (The profiler was seen to drop some or all
    events of the ctypes-launched kernels from a trace; it never adds
    any, so a trace with more than ``want`` fails the check however many
    were dropped elsewhere.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    found = {}
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        host_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
        found = {e.key: e.count for e in events if e.device_type != DeviceType.CPU
                 and e.key not in host_keys and not getattr(e, "is_user_annotation", False)}
        if sum(found.values()) >= want:
            break
    return found


def graph_kernel_nodes(fn):
    """Kernel nodes of a CUDA graph of one call of ``fn``, counted through
    libcuda (``cuGraphGetNodes``, ``cuGraphNodeGetType``): the count of
    kernels a call launches where the profiler drops their events."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    def ok(status, what):
        if status != 0:
            raise SmokeFailure(f"{what}: CUresult {status}")

    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kinds = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        kinds.append(kind.value)
    return sum(k == 0 for k in kinds)          # CU_GRAPH_NODE_TYPE_KERNEL


def phase_segment(card, per_step, timed, build_log=""):
    """K5 and K5-bwd against their plain versions at every segment shape of
    the models ``per_step`` ({model: {shape: segments per step}}), with the
    default plan and every path that the plan can be forced to there, with
    each plan's kernel events per call, device time, occupancy and the
    kernels' registers; each kernel's sum over a training step (the
    default path); the wrappers' host time per call at the flagship's
    [64,64,4,4]; the plain versions and the unfused chain timed too at
    the shapes ``timed``."""
    import torch
    import torch.nn.functional as F

    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.kernels import segment as seg
    from lvae_tpu_torch.models.blocks import Dropout, DropoutKey, batch_norm_train
    from lvae_tpu_torch.ops.math import bits8_keep_threshold, segment_backward, segment_forward
    from lvae_tpu_torch.ops.philox import dropout_bytes, mix_seed

    print("[14] segment kernels (K5, K5-bwd) vs their plain versions", flush=True)
    usage, ptxas = ptxas_usage(build_log, "segment_cu"), {}
    for entry, line in usage.items():
        m = re.search(r"(fwd|bwd)_kernelILi(\d+)ELi(\d)E", entry)
        name = f"{m[1]}_kernel<{m[2]}, {('elu', 'relu')[int(m[3])]}>" if m else entry
        print(f"  ptxas {name}: {line}")
        ptxas[name] = line
    if not usage:
        print("  ptxas: the library was built earlier in this process' build directory; "
              "no log")
    dev = torch.device("cuda")
    g_ = torch.Generator(device=dev).manual_seed(14)
    err = {"fwd": 0.0, "bwd": 0.0}
    # the kernels' key: train seed 42, step 7 (read from device memory, as
    # the trainer's step is), site 3; the plain versions take its bytes
    key = seg.Key(42, torch.tensor(7, dtype=torch.int64, device=dev), 3)
    seed = mix_seed(42, 7, 3)
    shapes = [s for counts in per_step.values() for s in counts]
    at_shape = {}           # device ms of K5, K5-bwd (rate 0.2, elu, default path), bounds
    by_path = {}            # {(shape, path): {...}} per path
    for shape in shapes:
        c, n = shape[1], int(np.prod(shape))
        x = torch.randn(shape, generator=g_, device=dev) * 1.5 + 0.3
        g = torch.randn(shape, generator=g_, device=dev)
        gamma = torch.rand(c, generator=g_, device=dev) + 0.5
        beta = torch.randn(c, generator=g_, device=dev) * 0.2
        paths = segment_paths(shape)
        for rate in (0.0, 0.2):
            t = bits8_keep_threshold(rate)
            bytes_ = dropout_bytes(shape, seed, dev) if t < 256 else None
            for act in ("elu", "relu"):
                what = f"{list(shape)} rate {rate} {act}"
                rm_p, rv_p = torch.full((c,), 0.3, device=dev), torch.full((c,), 1.7, device=dev)
                yp, mp, vp, rp = segment_forward(x, gamma, beta, t, act, mask_bytes=bytes_,
                                                 running_mean=rm_p, running_var=rv_p)
                hand = segment_backward(x, g, gamma, beta, mp, rp, t, act, bytes_)
                xr, gr, br = (v.clone().requires_grad_() for v in (x, gamma, beta))
                segment_forward(xr, gr, br, t, act, mask_bytes=bytes_)[0].backward(g)
                auto = (xr.grad, gr.grad, br.grad)
                del xr, gr, br
                for label, (path, pf, pb) in paths.items():
                    k = f"{what} {label}"
                    if pf is not None:
                        rm = torch.full((c,), 0.3, device=dev)
                        rv = torch.full((c,), 1.7, device=dev)
                        y, stats = seg._launch_fwd(x, gamma, beta, t, act, 1e-5, key, rm, rv,
                                                   0.9, path)
                        mean, var = stats[0], stats[1]
                        e = rel_max(y, yp)
                        err["fwd"] = max(err["fwd"], (y - yp).abs().max().item())
                        check(e <= 1e-5, f"K5 {k}: y within 1e-5 of max|y| ({e:.2e})")
                        e = max(rel_elem(mean, mp), rel_elem(var, vp))
                        check(e <= 1e-6, f"K5 {k}: mean, var within 1e-6 relative ({e:.2e})")
                        e = max(rel_elem(rm, rm_p), rel_elem(rv, rv_p))
                        check(e <= 1e-6, f"K5 {k}: running stats moved as the plain version's "
                                         f"({e:.2e}, bit-equal: "
                                         f"{torch.equal(rm, rm_p) and torch.equal(rv, rv_p)})")
                        y2, stats2 = seg._launch_fwd(x, gamma, beta, t, act, 1e-5, key, None,
                                                     None, 0.9, path)
                        check(torch.equal(y, y2) and torch.equal(stats, stats2),
                              f"K5 {k}: a second launch is bit-equal")
                        del y, y2
                    else:
                        _, stats = seg._launch_fwd(x, gamma, beta, t, act, 1e-5, key, None,
                                                   None, 0.9)
                    if pb is None:
                        continue
                    dx, dgamma, dbeta = seg._launch_bwd(x, g, gamma, stats, t, act, key, path)
                    for ref, against in ((hand, "the plain hand backward"),
                                         (auto, "autograd of the plain forward")):
                        e = max(rel_max(a, r) for a, r in zip((dx, dgamma, dbeta), ref))
                        check(e <= 1e-5, f"K5-bwd {k}: dx, dgamma, dbeta within 1e-5 of "
                                         f"their max vs {against} ({e:.2e})")
                    err["bwd"] = max(err["bwd"], *((a - r).abs().max().item()
                                                   for a, r in zip((dx, dgamma, dbeta), hand)))
                    check(torch.equal(dx == 0, hand[0] == 0),
                          f"K5-bwd {k}: dx is exactly 0 where the plain version's is "
                          f"({int((dx == 0).sum())} zeros)")
                    dx2, dg2, db2 = seg._launch_bwd(x, g, gamma, stats, t, act, key, path)
                    check(torch.equal(dx, dx2) and torch.equal(dgamma, dg2)
                          and torch.equal(dbeta, db2), f"K5-bwd {k}: a second launch is "
                                                       f"bit-equal")
                    del dx, dx2
                dx_ref = seg.dropout_bn_act_backward(
                    x, g, gamma, beta, seg._launch_fwd(x, gamma, beta, t, act, 1e-5, key,
                                                       None, None, 0.9)[1], t, act, *key)[0]
                xk = x.clone().requires_grad_()
                build.reset_launches()
                y, _, _ = seg.dropout_bn_act(xk, gamma, beta, rate=rate, act=act, **key._asdict())
                y.backward(g)
                check(build.LAUNCHES["segment"] == 1 and build.LAUNCHES["segment_bwd"] == 1
                      and torch.equal(xk.grad, dx_ref),
                      f"{what}: the autograd.Function launches K5 and K5-bwd once each and "
                      f"returns K5-bwd's dx")
                build.reset_launches()
                del xk, y, hand, auto, dx_ref
        # per path at rate 0.2, elu (the models' case): kernel events per
        # call (one trace of every path's calls), device time, occupancy
        t = bits8_keep_threshold(0.2)
        bnd = (bound(8 * n, OPS_SEGMENT * n)[0], bound(12 * n, 2 * OPS_SEGMENT * n)[0])
        _, stats = seg._launch_fwd(x, gamma, beta, t, "elu", 1e-5, key, None, None, 0.9)
        calls = {}
        for label, (path, pf, pb) in paths.items():
            if pf is not None:
                calls[("K5", label)] = (pf, lambda p=path: seg._launch_fwd(
                    x, gamma, beta, t, "elu", 1e-5, key, None, None, 0.9, p))
            if pb is not None:
                calls[("K5-bwd", label)] = (pb, lambda p=path: seg._launch_bwd(
                    x, g, gamma, stats, t, "elu", key, p))
        events = kernel_events(lambda: [fn() for _, fn in calls.values()], len(calls))
        dropped = sum(events.values()) < len(calls)
        for name, entry in (("K5", "fwd_kernel"), ("K5-bwd", "bwd_kernel")):
            want = sum(1 for k in calls if k[0] == name)
            if dropped:     # the profiler dropped the ctypes kernels' events
                nodes = [graph_kernel_nodes(fn) for k, (_, fn) in calls.items() if k[0] == name]
                check(nodes == [1] * want,
                      f"{name} {list(shape)}: one CUDA kernel per call of each of its {want} "
                      f"plans (the profiler dropped their events in 5 traces; kernel nodes "
                      f"of a CUDA graph of each call: {nodes})")
                continue
            got = sum(v for k, v in events.items() if entry in k)
            check(got == want and sum(events.values()) == len(calls),
                  f"{name} {list(shape)}: one CUDA kernel per call of each of its {want} "
                  f"plans ({got} {entry} events of {sum(events.values())})")
        for (name, path), (plan, call) in calls.items():
            ms = device_ms(call, 10)
            occ = seg.max_active_clusters(plan, "fwd" if name == "K5" else "bwd")
            by_path.setdefault((shape, path), {})[name] = {
                "device_ms": ms, "bound_ms": bnd[name == "K5-bwd"],
                "max_active_clusters": occ, "plan": plan._asdict() | {"path": plan.path}}
            print(f"  {name} {list(shape)} {path} ({plan.path}): device {fmt_ms(ms)}, bound "
                  f"{bnd[name == 'K5-bwd']:.4f} ms; cluster {plan.cluster} x {plan.threads} "
                  f"threads, {plan.units} units per CTA, {plan.chip} of them on chip, "
                  f"{plan.clusters} clusters ({plan.channels_per_cta} channels per CTA), "
                  f"{plan.smem} B dynamic shared memory, at most {occ} clusters active"
                  f"  ({card})")
        at_shape[shape] = (by_path[(shape, "default")]["K5"]["device_ms"],
                           by_path[(shape, "default")]["K5-bwd"]["device_ms"], *bnd)
        build.reset_launches()
        del x, g
        torch.cuda.empty_cache()
    steps = {}
    for model, counts in per_step.items():
        steps[model] = {"segments": sum(counts.values())}
        for i, name in enumerate(("K5", "K5-bwd")):
            steps[model][name] = {
                "device_ms": total([None if at_shape[s][i] is None else n * at_shape[s][i]
                                    for s, n in counts.items()]),
                "bound_ms": sum(n * at_shape[s][2 + i] for s, n in counts.items())}
        print(f"  per {model} training step ({steps[model]['segments']} segments): "
              + "; ".join(f"{k} device {fmt_ms(v['device_ms'])}, bound {v['bound_ms']:.4f} ms"
                          for k, v in steps[model].items() if k != "segments")
              + f"  ({card})")

    # the wrappers' host time where the call is host-bound: the flagship's
    # 4x4 maps, through the autograd.Function as the model calls it
    shape = (TRAIN_B, 64, 4, 4)
    x = torch.randn(shape, generator=g_, device=dev).requires_grad_()
    g = torch.randn(shape, generator=g_, device=dev)
    gamma = (torch.rand(64, generator=g_, device=dev) + 0.5).requires_grad_()
    beta = (torch.randn(64, generator=g_, device=dev) * 0.2).requires_grad_()
    host = {}
    for name in ("forward", "forward + backward"):
        def call():
            y = seg.dropout_bn_act(x, gamma, beta, rate=0.2, act="elu", **key._asdict())[0]
            if name != "forward":
                y.backward(g)
        host[name] = host_ms(call)
    print(f"  host ms per call at {list(shape)} (dropout_bn_act, rate 0.2, elu; wall over "
          f"300 calls, the card idle between): forward {host['forward']:.4f} ms, forward + "
          f"backward {host['forward + backward']:.4f} ms  ({card})")
    del x, g
    build.reset_launches()

    # times at each model's largest shape, rate 0.2 and ELU (the models' case)
    times = {}
    for shape in timed:
        c, n = shape[1], int(np.prod(shape))
        x = torch.randn(shape, generator=g_, device=dev) * 1.5 + 0.3
        g = torch.randn(shape, generator=g_, device=dev)
        gamma = torch.rand(c, generator=g_, device=dev) + 0.5
        beta = torch.randn(c, generator=g_, device=dev) * 0.2
        t = bits8_keep_threshold(0.2)
        _, stats = seg._launch_fwd(x, gamma, beta, t, "elu", 1e-5, key, None, None, 0.9)
        _, mp, _, rp = segment_forward(x, gamma, beta, t, "elu",
                                       mask_bytes=dropout_bytes(shape, seed, dev))
        # the port's unfused chain: keyed Dropout, batch_norm_train, ELU
        bn = torch.nn.BatchNorm2d(c).to(dev)
        drop = Dropout(0.2)
        drop.key = DropoutKey()
        drop.key.step = key.step
        chain = lambda v: F.elu(batch_norm_train(bn, drop(v, True)))  # noqa: E731
        xr = x.clone().requires_grad_()
        y_chain = chain(xr)
        calls = {
            "K5": (lambda: seg._launch_fwd(x, gamma, beta, t, "elu", 1e-5, key, None, None, 0.9),
                   lambda: segment_forward(x, gamma, beta, t, "elu",
                                           mask_bytes=dropout_bytes(shape, seed, dev)),
                   lambda: chain(x), bound(8 * n, OPS_SEGMENT * n)),
            "K5-bwd": (lambda: seg.dropout_bn_act_backward(x, g, gamma, beta, stats, t, "elu", *key),
                       lambda: segment_backward(x, g, gamma, beta, mp, rp, t, "elu",
                                                dropout_bytes(shape, seed, dev)),
                       lambda: torch.autograd.grad(y_chain, (xr, bn.weight, bn.bias), g,
                                                   retain_graph=True),
                       bound(12 * n, 2 * OPS_SEGMENT * n)),
        }
        for name, (kern, plain, unfused, bnd) in calls.items():
            ct = [cuda_ms(plain, 5), cuda_ms(kern, 20), cuda_ms(kern, 20), cuda_ms(plain, 5)]
            un = cuda_ms(unfused, 10)
            dk, dpl, dun = device_ms(kern, 10), device_ms(plain, 3), device_ms(unfused, 5)
            times[(name, shape)] = {
                "ms": (ct[1] + ct[2]) / 2, "plain_ms": (ct[0] + ct[3]) / 2, "device_ms": dk,
                "plain_device_ms": dpl, "unfused_ms": un, "unfused_device_ms": dun,
                "bound_ms": bnd[0], "bound_by": bnd[1]}
            r = times[(name, shape)]
            print(f"  time {name} {list(shape)} rate 0.2 elu per call: kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, the unfused chain {un:.4f} ms; device: "
                  f"kernel {fmt_ms(dk)}, plain {fmt_ms(dpl)}, unfused {fmt_ms(dun)}; bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]})  ({card})")
        del x, g, xr, y_chain
        torch.cuda.empty_cache()
    return err, times, steps, {"by_path": by_path, "host_ms": host, "ptxas": ptxas}


def unfused_dropouts(model):
    """Dropout sites of ``model`` that a training step runs through the
    bits8 dropout kernel: those with a mask that no fused segment
    absorbs."""
    from lvae_tpu_torch.models.blocks import Dropout, ResidualBlock
    from lvae_tpu_torch.ops.math import bits8_keep_threshold

    absorbed = {id(seg.dropout) for m in model.modules()
                if isinstance(m, ResidualBlock) and m.fused_segments
                for _, seg in m._segments.values() if seg.dropout is not None}
    return sum(1 for m in model.modules() if isinstance(m, Dropout) and m.impl == "bits8"
               and id(m) not in absorbed and 0 < bits8_keep_threshold(m.rate) < 256)


DROPOUT_ODD = (3, 5, 7, 2)                   # 210 elements: a ragged last group


def phase_dropout(card, shapes):
    """The bits8 dropout kernel (K5's bytes and key, alone; the unfused
    Dropout's path on CUDA) against its plain version at every segment
    shape, a ragged one and a misaligned one: bit-equal forward and
    backward, relaunches bit-equal; timed at the largest shape (in turns
    with the plain version) beside its bound."""
    import torch

    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.kernels import segment as seg
    from lvae_tpu_torch.ops.math import bits8_dropout_f32, bits8_keep_threshold
    from lvae_tpu_torch.ops.philox import dropout_bytes, mix_seed

    print("[14b] the bits8 dropout kernel vs its plain version", flush=True)
    dev = torch.device("cuda")
    g_ = torch.Generator(device=dev).manual_seed(141)
    key = seg.Key(42, torch.tensor(7, dtype=torch.int64, device=dev), 3)
    seed = mix_seed(42, 7, 3)
    n_checked, err = 0, 0.0
    for shape in list(shapes) + [DROPOUT_ODD, "misaligned"]:
        if shape == "misaligned":       # a contiguous view 4 bytes past an aligned base
            shape = (4, 8, 6, 6)
            x = torch.randn(int(np.prod(shape)) + 1, generator=g_, device=dev)[1:].view(shape)
        else:
            x = torch.randn(shape, generator=g_, device=dev)
        bytes_ = dropout_bytes(shape, seed, dev)
        for rate in (0.1, 0.2, 0.5):
            t = bits8_keep_threshold(rate)
            plain = bits8_dropout_f32(x, bytes_, t)
            y = seg._launch_dropout(x, t, key)
            err = max(err, (y - plain).abs().max().item())
            check(torch.equal(y, plain) and torch.equal(seg._launch_dropout(x, t, key), y),
                  f"dropout {list(shape)} rate {rate}: bit-equal to the plain version, and "
                  f"a relaunch")
            n_checked += 1
        g = torch.randn(shape, generator=g_, device=dev)
        xr = x.clone().requires_grad_()
        build.reset_launches()
        y = seg.dropout_bits8(xr, 0.2, *key)
        y.backward(g)
        t = bits8_keep_threshold(0.2)
        check(build.LAUNCHES["dropout"] == 2 and torch.equal(xr.grad, bits8_dropout_f32(g, bytes_, t)),
              f"dropout {list(shape)}: dropout_bits8 launches the kernel forward and backward, "
              f"and dx is the cotangent dropped by the same bytes")
        build.reset_launches()
    shape = max(shapes, key=lambda s: int(np.prod(s)))
    n = int(np.prod(shape))
    x = torch.randn(shape, generator=g_, device=dev)
    t = bits8_keep_threshold(0.2)
    kern = lambda: seg._launch_dropout(x, t, key)     # noqa: E731
    plain = lambda: bits8_dropout_f32(x, dropout_bytes(shape, mix_seed(*key), dev), t)  # noqa
    ct = [cuda_ms(plain, 5), cuda_ms(kern, 20), cuda_ms(kern, 20), cuda_ms(plain, 5)]
    bnd = bound(8 * n, OPS_SEGMENT * n)
    times = {"ms": (ct[1] + ct[2]) / 2, "plain_ms": (ct[0] + ct[3]) / 2,
             "device_ms": device_ms(kern, 10), "plain_device_ms": device_ms(plain, 3),
             "bound_ms": bnd[0], "bound_by": bnd[1], "shape": list(shape)}
    small = torch.randn((TRAIN_B, 64, 4, 4), generator=g_, device=dev)
    times["host_ms"] = host_ms(lambda: seg._launch_dropout(small, t, key))
    print(f"  dropout {list(shape)} rate 0.2 per call: kernel {times['ms']:.4f} ms, plain "
          f"{times['plain_ms']:.4f} ms; device: kernel {fmt_ms(times['device_ms'])}, plain "
          f"{fmt_ms(times['plain_device_ms'])}; bound {bnd[0]:.4f} ms ({bnd[1]}); host "
          f"{times['host_ms']:.4f} ms a call at [{TRAIN_B}, 64, 4, 4]; {n_checked} "
          f"shape-rate checks  ({card})")
    build.reset_launches()
    return err, times


def phase_celeba_segments(card, train_u8, test_u8, phase12):
    """celeba64 training through lvae_tpu_torch.main --fused all."""
    import torch

    from lvae_tpu_torch import evaluate
    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build

    print("[15] celeba64 training through lvae_tpu_torch.main --dataset celeba --fused all",
          flush=True)
    args = CELEBA_ARGS + ["--fused", "all"]
    init = init_launches(args, celeba_dataset(train_u8, test_u8))
    print(f"  data-dependent init alone launches K5 {init['segment']}, K1 "
          f"{init['sample_kl_per_sample']} and K3 {init['mix_log_prob']} times")
    steps, n_sweeps = SEGMENT_STEPS, 1
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        write_celeba(data_dir, train_u8, test_u8)
        build.reset_launches()
        t0 = time.perf_counter()
        trainer = train_main.main(args + [
            "--data-dir", data_dir, "--data-dep-init", "--max-steps", str(steps),
            "--device", "cuda", "--log-interval", "20", "--test-interval", str(steps),
            "--checkpoint-interval", str(steps), "--output-dir", os.path.join(tmp, "out"),
            "--run-name", "celeba64-segments",
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        n_seg = segments_per_step(trainer.state.model)
        print(f"  launches in the training run: {launches}")
        print(f"  run wall {wall:.1f} s (data load, data-dependent init, {steps} steps, "
              f"{n_sweeps} test sweep, 1 checkpoint)  ({card})")
        sweep_batches = n_sweeps * (CELEBA_N_TEST // CELEBA_EVAL_B)
        check(launches["segment"] == n_seg * steps + init["segment"],
              f"K5: {n_seg} segments per step and the init's {init['segment']} "
              f"({launches['segment']})")
        check(launches["segment_bwd"] == n_seg * steps,
              f"K5-bwd: {n_seg} per step ({launches['segment_bwd']})")
        sites = unfused_dropouts(trainer.state.model)
        check(sites > 0 and launches["dropout"] == 2 * sites * steps + init["dropout"],
              f"the dropout kernel: forward and backward at the {sites} dropout sites per "
              f"step that no segment absorbs, and the init's {init['dropout']} "
              f"({launches['dropout']})")
        check(launches["mix_log_prob_bwd"] == steps
              and launches["mix_log_prob"] == steps + sweep_batches + init["mix_log_prob"],
              f"K3, K3-bwd as in phase 12 ({launches['mix_log_prob']}, "
              f"{launches['mix_log_prob_bwd']})")
        check(launches["sample_kl_per_sample"] == 4 * steps + init["sample_kl_per_sample"]
              and launches["sample_kl_per_sample_bwd"] == 4 * steps,
              f"K1, K1-bwd as in phase 12 ({launches['sample_kl_per_sample']}, "
              f"{launches['sample_kl_per_sample_bwd']})")
        check(launches["sample_kl"] == 4 * sweep_batches and launches["sample_kl_bwd"] == 0,
              f"the test hook ran K2 forward only ({launches['sample_kl']} launches)")
        hist = trainer.logger.history
        check(all(np.isfinite(np.asarray(v, dtype=np.float64)).all()
                  for _, _, m in hist for v in m.values()),
              f"every logged metric finite ({len(hist)} lines)")
        train_lines = {step: m for kind, step, m in hist if kind == "train"}
        first, last = float(train_lines[20]["loss"]), float(train_lines[steps]["loss"])
        check(last < first, f"EMA loss {last:.2f} at step {steps} below {first:.2f} at "
                            f"step 20")
        tests = [m for kind, _, m in hist if kind == "test"]
        ckpt = os.path.join(trainer.run_dir, "checkpoints", f"ckpt_{steps:08d}.pt")
        res = evaluate.main(["--load", trainer.run_dir, "--state-dict", ckpt,
                             "--device", "cuda"])
        e = res["elbo"]
        d = abs(e["elbo"] - tests[-1]["elbo"])
        check(np.isfinite(e["elbo"]) and d <= 1e-2,
              f"evaluate scores the checkpoint: ELBO {e['elbo']:.3f}, the run's last "
              f"test ELBO {tests[-1]['elbo']:.3f}")
        check(list(trainer.state.model.state_dict()) == phase12["state_keys"],
              "its state_dict keys are phase 12's (--fused auto)")
        out["launches"] = launches
        out["segments_per_step"] = n_seg
        out["wall_s"] = wall
        out["log_rates"] = {step: float(m["images_per_sec"]) for step, m in train_lines.items()}
        out["test_elbo"] = [float(m["elbo"]) for m in tests]
        out["ema_loss"] = (first, last)
    return out


# ---------------------------------------------------------------------------
# --steps-per-call k: one CUDA graph of k train steps (phase 17)
# ---------------------------------------------------------------------------

GRAPH_K = 10
GRAPH_CLI_STEPS = 200
GRAPH_RATE_STEPS = 40                       # per timed Trainer.run, the first call untimed
# the kernels of a train step by the identifier in their symbol; K3-bwd
# has two plans (kernels/mixture.py bwd_plan)
GRAPH_KERNELS = {"dropout_kernel": "dropout",
                 "sample_kl_rows_kernel": "sample_kl_per_sample",
                 "sample_kl_bwd_kernel": "sample_kl_per_sample_bwd",
                 "mix_fwd_kernel": "mix_log_prob", "mix_bwd_one_pass_kernel": "mix_log_prob_bwd",
                 "mix_bwd_kernel": "mix_log_prob_bwd", "fwd_kernel": "segment",
                 "bwd_kernel": "segment_bwd"}


def graph_kernel_names(raw_graph):
    """{kernel symbol: kernel nodes} of a captured CUDA graph, through
    libcuda: ``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphKernelNodeGetParams`` (its ``func`` or ``kern`` field) and
    ``cuFuncGetName`` / ``cuKernelGetName``."""
    import collections
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    def ok(status, what):
        if status != 0:
            raise SmokeFailure(f"{what}: CUresult {status}")

    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", None) or \
        cu.cuGraphKernelNodeGetParams
    handle, n = ctypes.c_void_p(raw_graph), ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = collections.Counter()
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        if kind.value != 0:                     # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = (ctypes.c_byte * 256)()        # CUDA_KERNEL_NODE_PARAMS_v2 and room
        ok(get_params(ctypes.c_void_p(node), params), "cuGraphKernelNodeGetParams")
        func = ctypes.c_void_p.from_buffer(params, 0).value
        kern = ctypes.c_void_p.from_buffer(params, 56).value
        name = ctypes.c_char_p()
        if func:
            ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)), "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(kern)),
               "cuKernelGetName")
        names[name.value.decode()] += 1
    return names


def port_kernel(symbol):
    """The launch counter of the port's kernel whose mangled symbol this is
    (None for another kernel): its identifier with the length prefix the
    mangling gives it, so not a longer identifier ending in it."""
    for ident, counter in GRAPH_KERNELS.items():
        if f"{len(ident)}{ident}" in symbol:
            return counter
    return None


def state_equal(a, b):
    """Names of what differs, bit for bit, between two train states:
    parameters and BatchNorm statistics, EMA, Adamax state, the step."""
    import torch

    bad = [k for k, t in a.model.state_dict().items()
           if not torch.equal(t, b.model.state_dict()[k])]
    bad += [f"ema.{k}" for k in a.ema if not torch.equal(a.ema[k], b.ema[k])]
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    bad += [f"adamax.{i}.{k}" for i in sa for k in ("step", "exp_avg", "exp_inf")
            if not torch.equal(sa[i][k], sb[i][k])]
    if a.step != b.step or int(a.step_t) != int(b.step_t):
        bad.append("step")
    return bad


def device_union(fn, reps=1):
    """(device ms per call as the union of the kernels' intervals, the sum
    of their durations, wall ms per call, kernel events) of ``reps`` calls
    of ``fn`` under torch.profiler (device activity only, which keeps the
    trace of an eager call's ~10^5 host operators out), after one call
    outside it. A graph replay may run independent kernels at once, so
    the sum can exceed the wall time; the union is the time the device had
    a kernel running."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    events = prof.events()
    host_keys = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type != DeviceType.CPU and e.name not in host_keys
                   and not getattr(e, "is_user_annotation", False))
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    total_us = sum(b - a for a, b in spans)
    return union / 1e3 / reps, total_us / 1e3 / reps, wall, len(spans)


def graph_cell(card, name, args, data, weights):
    """One model and kernel policy under ``--steps-per-call GRAPH_K``: 3k
    steps through MultiStep (a warm-up call of k eager steps, which
    captures the graph, then two replays) against 3k eager train steps
    from the same state and batches, bit for bit (deterministic
    algorithms on, as phases 9 and 13); the graph's kernel nodes by
    kernel against the eager steps' launches; then train images/s through
    Trainer.run with k = 1 and k = GRAPH_K in turns (E, G, G, E), and each
    path's device ms per step and idle share from a profile."""
    import dataclasses

    import torch

    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.train.state import MultiStep, train_step
    from lvae_tpu_torch.train.trainer import Experiment, Trainer, index_stream

    k = GRAPH_K
    cfg, _ = config_from_args(args)
    print(f"  {name}: batch {cfg.batch_size}, dropout {cfg.dropout}, --fused {cfg.fused}, "
          f"k = {k}", flush=True)

    def setup():
        exp = Experiment(cfg, torch.device("cuda"), data)
        exp.model.load_state_dict(weights)
        return exp, exp.init_state(data_dep_init=False)

    out = {}
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        exp, eager = setup()
        stream = index_stream(exp.train_data, cfg.batch_size, cfg.seed, 0, k)
        blocks = [next(stream) for _ in range(3)]
        build.reset_launches()
        for block in blocks:
            for row in block:
                train_step(eager, exp.train_data.gather(row), row, exp.loss_cfg)
        torch.cuda.synchronize()
        per_step = {n: v / (3 * k) for n, v in build.LAUNCHES.items() if v}
        _, graphed = setup()
        multi = MultiStep(graphed, exp.train_data.gather, exp.loss_cfg, k)
        build.reset_launches()
        for block in blocks:
            multi(block)
        torch.cuda.synchronize()
        run_launches = dict(build.LAUNCHES)
        build.reset_launches()
        bad = state_equal(graphed, eager)
        check(not bad, f"{name}: {3 * k} steps (k eager, then 2 replays of the graph) "
                       f"bit-equal to {3 * k} eager steps: parameters, BatchNorm statistics, "
                       f"EMA, Adamax state, step (differ: {bad[:5]})")
        check(all(run_launches.get(n, 0) == 3 * k * v for n, v in per_step.items()),
              f"{name}: the launch counts of the graphed run (the warm-up's and 2 replays' "
              f"{run_launches}) are the eager run's")
        symbols = graph_kernel_names(multi.graph.raw_cuda_graph())
        nodes = sum(symbols.values())
        ours = {}
        for sym, v in symbols.items():
            counter = port_kernel(sym)
            if counter is not None:
                ours[counter] = ours.get(counter, 0) + v
        print(f"  {name}: the graph holds {nodes} kernel nodes ({nodes / k:.0f} per step); "
              f"the port's kernels per step: "
              f"{ {n: v / k for n, v in ours.items()} }; eager launches per step: {per_step}")
        for sym, v in symbols.most_common(12):
            print(f"    {v / k:7.1f} per step  {sym[:110]}")
        for sym in sorted(s for s in symbols if port_kernel(s)):
            print(f"    {symbols[sym] / k:7.1f} per step  {sym[:110]}")
        want = {n for n in per_step if n in GRAPH_KERNELS.values()}
        check(want and {n: v / k for n, v in ours.items()} == {n: per_step[n] for n in want},
              f"{name}: the graph's kernel nodes name each kernel of the step "
              f"({sorted(want)}) at the eager per-step counts")
        check(multi.launches == {n: v * k for n, v in per_step.items()},
              f"{name}: a replay counts the graph's launches ({multi.launches})")
        out.update(kernel_nodes_per_step=nodes / k,
                   port_kernels_per_step={n: v / k for n, v in ours.items()})
        del exp, eager, graphed, multi, blocks, stream
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    def trainer(steps_per_call, steps):
        run_cfg = dataclasses.replace(
            cfg, steps_per_call=steps_per_call, max_steps=steps, log_interval=k,
            test_interval=10 ** 9, checkpoint_interval=10 ** 9, dry_run=True)
        return Trainer(Experiment(run_cfg, torch.device("cuda"), data))

    def rate(steps_per_call):
        tr = trainer(steps_per_call, GRAPH_RATE_STEPS)
        tr.run()
        rates = [float(m["images_per_sec"]) for kind, step, m in tr.logger.history
                 if kind == "train" and step > k]
        return len(rates) / sum(1.0 / r for r in rates)

    runs = {1: [], k: []}
    for spc in (1, k, k, 1):
        runs[spc].append(rate(spc))
    b = cfg.batch_size
    for spc, label in ((1, "eager"), (k, "graphed")):
        r = float(np.mean(runs[spc]))
        out[label] = {"images_per_sec": r, "ms_per_step": 1e3 * b / r, "runs": runs[spc]}
        print(f"  {name} {label} (--steps-per-call {spc}): Trainer.run, steps "
              f"{k + 1}-{GRAPH_RATE_STEPS}, batch {b}: {r:.1f} img/s, {1e3 * b / r:.2f} ms/step "
              f"(runs {runs[spc]})  ({card})")

    # device time and idle share: a call of k steps, after a first call
    # (the graphed path's warm-up and capture) outside the profile
    for spc, label in ((1, "eager"), (k, "graphed")):
        exp, state = setup()
        stream = index_stream(exp.train_data, cfg.batch_size, cfg.seed, 0, k)
        if spc == 1:
            def call():
                for row in next(stream):
                    train_step(state, exp.train_data.gather(row), row, exp.loss_cfg)
        else:
            multi = MultiStep(state, exp.train_data.gather, exp.loss_cfg, k)
            call = lambda: multi(next(stream))   # noqa: E731
        call()
        busy, kernel_sum, wall, n_events = device_union(call)
        out[label].update(device_ms_per_step=busy / k, kernel_ms_per_step=kernel_sum / k,
                          profiled_ms_per_step=wall / k, idle_share=1.0 - busy / wall,
                          kernel_events_per_step=n_events / k)
        print(f"  {name} {label}: profile of a call of {k} steps: device busy {busy / k:.2f} ms "
              f"per step (the union of kernel intervals; their sum {kernel_sum / k:.2f}), wall "
              f"{wall / k:.2f} ms per step, idle share {1.0 - busy / wall:.3f}, "
              f"{n_events / k:.0f} kernel events per step  ({card})")
        del exp, state, stream
        torch.cuda.empty_cache()
    return out


def graph_cli(card, train_u8, test_u8):
    """``lvae_tpu_torch.main --steps-per-call GRAPH_K``: GRAPH_CLI_STEPS
    flagship steps with the log, test and checkpoint hooks, then an
    ``--auto-resume`` from its middle checkpoint to the same step, bit-equal
    to the uninterrupted run (deterministic algorithms on in both)."""
    import shutil

    import torch

    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build

    n, half = GRAPH_CLI_STEPS, GRAPH_CLI_STEPS // 2
    out = {}
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data_dir = os.path.join(tmp, "data")
            write_mnist(data_dir, train_u8, test_u8)

            def run(out_dir, *extra):
                return train_main.main(FLAGSHIP_ARGS + [
                    "--data-dir", data_dir, "--max-steps", str(n), "--device", "cuda",
                    "--steps-per-call", str(GRAPH_K), "--log-interval", "50",
                    "--test-interval", str(half), "--checkpoint-interval", str(half),
                    "--output-dir", out_dir, "--run-name", "graphed", *extra])

            build.reset_launches()
            t0 = time.perf_counter()
            whole = run(os.path.join(tmp, "a"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
            print(f"  the CLI run: {n} steps, 2 test sweeps, 2 checkpoints in {wall:.1f} s; "
                  f"launches {launches}  ({card})")
            check(launches["sample_kl_per_sample"] == 3 * n
                  and launches["sample_kl_per_sample_bwd"] == 3 * n,
                  f"K1, K1-bwd: 3 launches per step, counted through the replays "
                  f"({launches['sample_kl_per_sample']}, "
                  f"{launches['sample_kl_per_sample_bwd']})")
            hist = whole.logger.history
            check(all(np.isfinite(np.asarray(v, dtype=np.float64)).all()
                      for _, _, m in hist for v in m.values()),
                  f"every logged metric finite ({len(hist)} lines)")
            check([s for kind, s, _ in hist if kind == "test"] == [half, n]
                  and [s for kind, s, _ in hist if kind == "train"] == list(range(50, n + 1, 50)),
                  "the log and test hooks fired where a 10-step call crossed their intervals")
            ckpts = sorted(os.listdir(os.path.join(whole.run_dir, "checkpoints")))
            check(ckpts == [f"ckpt_{half:08d}.pt", f"ckpt_{n:08d}.pt"],
                  f"checkpoints at steps {half} and {n} ({ckpts})")
            second = os.path.join(tmp, "b", "graphed")
            shutil.copytree(whole.run_dir, second)
            os.unlink(os.path.join(second, "checkpoints", f"ckpt_{n:08d}.pt"))
            t0 = time.perf_counter()
            resumed = run(os.path.join(tmp, "b"), "--auto-resume")
            print(f"  resumed at step {half} and ran to {n} in "
                  f"{time.perf_counter() - t0:.1f} s  ({card})")
            bad = state_equal(resumed.state, whole.state)
            check(not bad, f"the run resumed from its step-{half} checkpoint is bit-equal to "
                           f"the uninterrupted one at step {n} (differ: {bad[:5]})")
            out.update(wall_s=wall, launches=launches,
                       test_elbo=[float(m["elbo"]) for kind, _, m in hist if kind == "test"])
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    return out


def phase_graph(card, train_u8, test_u8, flagship_weights, c_data, celeba_weights):
    t0 = time.perf_counter()
    print(f"[17] --steps-per-call {GRAPH_K}: one CUDA graph of {GRAPH_K} train steps",
          flush=True)
    out = {}
    for name, args, data, weights in (
            ("flagship auto", FLAGSHIP_ARGS + ["--fused", "auto"],
             flagship_dataset(train_u8, test_u8), flagship_weights),
            ("flagship all", FLAGSHIP_ARGS + ["--fused", "all"],
             flagship_dataset(train_u8, test_u8), flagship_weights),
            ("celeba64 all", CELEBA_ARGS + ["--fused", "all"], c_data, celeba_weights)):
        out[name] = graph_cell(card, name, args, data, weights)
    out["cli"] = graph_cli(card, train_u8, test_u8)
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 17 took {out['wall_s']:.1f} s")
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is "
              "False); this smoke run needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import lvae_tpu_torch  # noqa: F401  (fails when run outside the repository)

    # phases 9 and 13 turn deterministic algorithms on; cuBLAS needs this
    # set before its first use
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"tf32 off", flush=True)
    t0 = time.perf_counter()
    build_log = phase_build()
    res = {"card": card}
    k2_err, k2_t, k2_b = phase_sample_kl(card)
    k4_err, k4, k4_more = phase_logsumexp(card, build_log)
    ev = phase_slice(card)
    res.update(images_per_sec=ev["rates"], elbo_profile=ev["elbo_profile"])

    def entry(name, source, replaces, launches, err, t, bnd, library_ms, **more):
        return {"name": name, "route": "cuda", "source": f"lvae_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": t[0], "plain_ms": t[1], "device_ms": t[2], "plain_device_ms": t[3],
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms, **more}

    kernels = [
        entry("sample_kl", "stochastic_kl.cu", "lvae_tpu/kernels/stochastic_pallas.py:149",
              ev["launches"]["sample_kl"], k2_err, k2_t, k2_b, None,
              shapes="3 layers at B=1000", path="evaluate"),
        entry("logsumexp", "logsumexp.cu", "lvae_tpu/kernels/logsumexp_pallas.py:36",
              ev["launches"]["logsumexp"], k4_err,
              [k4[k] for k in ("ms", "plain_ms", "device_ms", "plain_device_ms")],
              (k4["bound_ms"], k4["bound_by"]), k4["library_ms"],
              library="torch.logsumexp(x, 0)", library_device_ms=k4["library_device_ms"],
              plan=k4["plan"], shapes=f"[{IW_SAMPLES}, {B}] (celeba64: [{IW_SAMPLES}, "
              f"{CELEBA_EVAL_B}])", path="evaluate", **k4_more),
    ]
    t6 = time.perf_counter()
    k1_err, k1_t, k1_host = phase_k1(card, build_log=build_log)
    bwd_err, bwd_t = phase_bwd(card)
    print(f"  phases 6-7 took {time.perf_counter() - t6:.1f} s")
    train_u8, test_u8 = train_data()
    tr = phase_train(card, train_u8, test_u8)
    res.update(train_run={k: tr[k] for k in ("wall_s", "log_rates", "log_rate_91_300",
                                            "test_elbo", "ema_loss")})
    flagship_weights = flagship_model(torch.device("cpu")).state_dict()
    res.update(phase_step(
        card, "[9] one step: the kernel path vs the plain path and the CPU; train "
        "images/s", FLAGSHIP_ARGS, flagship_dataset(train_u8, test_u8), flagship_weights,
        TRAIN_B, 150, 50))
    mix_err, mix_t, mix_more = phase_mixture(card, build_log)
    res["mixture"] = mix_more
    c_all = rgb_blobs(CELEBA_N_TRAIN + CELEBA_N_TEST, seed=12)
    c_train, c_test = c_all[:CELEBA_N_TRAIN], c_all[CELEBA_N_TRAIN:]
    c_data = celeba_dataset(c_train, c_test)
    cev = phase_celeba_eval(card, c_train, c_test)
    kernels[1]["launches_celeba64"] = cev["launches"]["logsumexp"]
    ctr = phase_celeba_train(card, c_train, c_test)
    celeba_weights = seeded_model(CELEBA, c_data, torch.device("cpu")).state_dict()
    cst = phase_step(
        card, "[13] one celeba64 step: the kernel path vs the plain path and the CPU; "
        "train images/s", CELEBA_ARGS, c_data, celeba_weights, 16, 150, 50)
    res["celeba64"] = {
        "images_per_sec": cev["rates"], "elbo_profile": cev["elbo_profile"],
        "train_run": {k: ctr[k] for k in ("wall_s", "log_rates", "log_rate_101_200",
                                         "test_elbo", "ema_loss")},
        **cst}

    per_step = {
        "celeba64": segment_shapes(CELEBA, c_data, CELEBA_B, CELEBA_IMAGE),
        "flagship": segment_shapes(FLAGSHIP, flagship_dataset(train_u8, test_u8), TRAIN_B,
                                   FLAGSHIP_IMAGE)}
    for model, counts in per_step.items():
        print(f"  {model}'s segments per step by shape: "
              f"{ {str(list(k)): v for k, v in counts.items()} }")
    timed = tuple(next(iter(per_step[m])) for m in ("celeba64", "flagship"))
    t14 = time.perf_counter()
    seg_err, seg_t, seg_steps, seg_more = phase_segment(card, per_step, timed, build_log)
    drop_err, drop_t = phase_dropout(card, [s for c in per_step.values() for s in c])
    print(f"  phase 14 took {time.perf_counter() - t14:.1f} s")
    res["segment_paths"] = {f"{list(shape)} {path}": row
                            for (shape, path), row in seg_more["by_path"].items()}
    res["segment_host_ms"] = seg_more["host_ms"]
    res["segment_ptxas"] = seg_more["ptxas"]
    csg = phase_celeba_segments(card, c_train, c_test, ctr)
    res["celeba64"]["segments_run"] = {k: csg[k] for k in ("wall_s", "log_rates", "test_elbo",
                                                           "ema_loss", "segments_per_step")}
    res["celeba64"]["segments_step"] = phase_step(
        card, "[16a] one celeba64 step: --fused all vs pallas on the card and vs the CPU; "
        "train images/s", CELEBA_ARGS, c_data, celeba_weights, 16, 100, 50,
        paths=("all", "pallas"), card_dropout=0.0, cpu=("all", 0.2))
    res["segments_step"] = phase_step(
        card, "[16b] one flagship step: --fused all vs stochastic on the card; train "
        "images/s", FLAGSHIP_ARGS, flagship_dataset(train_u8, test_u8), flagship_weights,
        None, 150, 50, paths=("all", "stochastic"), card_dropout=0.0)
    res["steps_per_call"] = phase_graph(card, train_u8, test_u8, flagship_weights, c_data,
                                        celeba_weights)

    def times_and_bound(t):
        return [t[k] for k in ("ms", "plain_ms", "device_ms", "plain_device_ms")], \
            (t["bound_ms"], t["bound_by"])

    def summary(t):
        return {k: v for k, v in t.items() if k != "layers"}

    train_path = "lvae_tpu_torch.main (training)"
    for name, replaces, e, t, more in (
        ("sample_kl_per_sample", "lvae_tpu/kernels/stochastic_pallas.py:318", k1_err, k1_t,
         {"host_ms": k1_host["forward"]}),
        ("sample_kl_per_sample_bwd", "lvae_tpu/kernels/stochastic_pallas.py:350",
         bwd_err["k1"], bwd_t["k1"],
         {"host_ms": k1_host["backward"], "noise": "keyed, as the trainer calls it",
          "given_eps": {m: summary(v) for m, v in bwd_t["k1_eps"].items()}}),
    ):
        kernels.append(entry(name, "stochastic_kl.cu", replaces, ctr["launches"][name], e,
                             *times_and_bound(t["celeba64"]), None, flagship=summary(t["flagship"]),
                             launches_flagship=tr["launches"][name],
                             shapes="celeba64: 4 layers at B=128 (flagship: 3 layers at B=64), "
                                    "the top layer's prior with row stride 0",
                             path=train_path, **more))
    # K2's gradient: neither entry point differentiates through K2 (the
    # trainer's K1 takes every shape, so it never falls back to K2 as
    # lvae_tpu's does for F % 128 != 0); held to autograd in phase 7
    kernels.append(entry("sample_kl_bwd", "stochastic_kl.cu",
                         "lvae_tpu/kernels/stochastic_pallas.py:178", tr["launches"]["sample_kl_bwd"],
                         bwd_err["k2"], *times_and_bound(bwd_t["k2"]), None,
                         shapes="3 layers at B=64, given eps",
                         path="not on either entry point's path; phase 7"))
    two_pass = mix_t[("K3-bwd two_pass", CELEBA_B)]
    for name, replaces, e, t, more in (
        ("mix_log_prob", "lvae_tpu/kernels/mixture_pallas.py:323", mix_err["fwd"],
         mix_t[("K3", CELEBA_B)], {}),
        ("mix_log_prob_bwd", "lvae_tpu/kernels/mixture_pallas.py:338", mix_err["bwd"],
         mix_t[("K3-bwd", CELEBA_B)],
         {"plan": mix_more["plans"][f"[{CELEBA_B},100,64,64] C=3 K={K_MIX}"]["default"],
          "two_pass_ms": two_pass[0], "two_pass_device_ms": two_pass[1]}),
    ):
        kernels.append(entry(name, "mixture.cu", replaces, ctr["launches"][name], e, t,
                             t[4:6], None, launches_eval=cev["launches"][name], **more,
                             shapes=f"[{CELEBA_B},100,64,64], C=3",
                             path="celeba64: lvae_tpu_torch.main (training), "
                                  "lvae_tpu_torch.evaluate"))
    for name, replaces, e, key in (
        ("segment", "lvae_tpu/kernels/segment_pallas.py:291", seg_err["fwd"], "K5"),
        ("segment_bwd", "lvae_tpu/kernels/segment_pallas.py:318", seg_err["bwd"], "K5-bwd"),
    ):
        big = seg_t[(key, timed[0])]
        t = [big[k] for k in ("ms", "plain_ms", "device_ms", "plain_device_ms")]
        kernels.append(entry(
            name, "segment.cu", replaces, csg["launches"][name], e, t,
            (big["bound_ms"], big["bound_by"]), None, unfused_ms=big["unfused_ms"],
            unfused_device_ms=big["unfused_device_ms"],
            flagship=seg_t[(key, timed[1])],
            per_step={m: v[key] for m, v in seg_steps.items()},
            shapes=f"{list(timed[0])}, rate 0.2, elu (flagship: {list(timed[1])})",
            path="celeba64 and the flagship: lvae_tpu_torch.main (training) --fused "
                 "segments|all"))
    kernels.append(entry(
        "dropout_bits8", "segment.cu", "lvae_tpu/models/blocks.py:86 (FastDropout: jax.random "
        "bits, no pl.pallas_call)", tr["launches"]["dropout"], drop_err,
        [drop_t[k] for k in ("ms", "plain_ms", "device_ms", "plain_device_ms")],
        (drop_t["bound_ms"], drop_t["bound_by"]), None, host_ms=drop_t["host_ms"],
        launches_celeba64_all=csg["launches"]["dropout"],
        shapes=f"{drop_t['shape']}, rate 0.2", path="the flagship and celeba64: "
        "lvae_tpu_torch.main (training), every bits8 dropout that no segment absorbs"))
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels, **res}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
