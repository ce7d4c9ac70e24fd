#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lvae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``lvae_tpu_torch/csrc`` and checks each
against its plain PyTorch version at the shapes of the models that run it
(phase 2 also runs the 24 hardware checks of ``lvae_tpu_torch.hw_tests``,
the twin of ``tools/tpu_hw_tests.py``, the eps statistics over 33.5M
draws of the kernel among them, with a KS test), then drives two models
through their two entry points. The flagship
(static_mnist, z 32-32-32, 4 blocks per layer, 64 filters, gated, skip,
learned top prior):

- evaluation, ``lvae_tpu_torch.evaluate.main`` (phases 2-5): seeded random
  weights, test ELBO over 10,000 synthetic static_mnist-shaped images and
  the k=100 IW log-likelihood over the first 1,000 of them;
- training, ``lvae_tpu_torch.main`` (phases 6-9): the sample+KL kernels'
  per-sample forward (K1) and both backward kernels held against their
  plain versions and timed at the flagship's and celeba64's training
  shapes, 40 steps of the flagship at batch 64 with data-dependent
  init on 50,000 synthetic train images, the kernel path against the plain
  path and the CPU on one step, and train images/s.

And celeba64 (64x64 RGB, z 32-32-32-32, 2 blocks per layer, 64 filters,
the discretized-logistic-mixture head; phases 10-13): the mixture
log-prob kernel and its backward (K3 at each of its 1, 2 or 4 pixels a
thread in fp32 and bf16, K3-bwd on each of its two plans, the one pass at
each of its 1 or 2 pixels a lane pair and on a map off alignment) against
their plain versions; evaluation over 2,000 synthetic 64x64 RGB images read from
``celeba/celeba_64.npz`` with the k=100 IW log-likelihood over the first
500; 40 training steps at batch 128 on 20,000 images; one step against
the plain path and the CPU, and train images/s.

Then the train-mode dropout+BatchNorm+activation segments (phases 14-16):
the segment kernel and its backward (K5, K5-bwd) against their plain
versions at every segment shape of both models, timed against their
plain versions, the port's unfused chain and their bound; 40 celeba64
steps through ``lvae_tpu_torch.main --fused all``; one step of each model
under ``--fused all`` against the path without the segments (and, for
celeba64, the CPU), and train images/s. Phase 14b holds the unfused bits8
dropout's kernel to its plain version.

Then ``--steps-per-call 10`` (phase 17): for the flagship (``--fused
auto`` and ``all``) and celeba64 (``all``), 30 steps through one CUDA
graph of 10 bit-equal to 30 eager steps, the graph's kernel nodes by
kernel against the eager launches, the graphed device time and idle
share (the eager ones are phases 9, 13 and 16's); and 60 flagship steps
through
``lvae_tpu_torch.main --steps-per-call 10``, resumed from the middle
checkpoint bit-equal.

Last, ``--precision bf16`` (phase 18): the bf16 instantiations of K5,
K5-bwd, the dropout kernel, K3 and K3-bwd against their plain bf16
versions at the models' shapes (bf16 outputs bit-equal or within 1 ulp,
the count printed; fp32 outputs at phases 10 and 14's tolerances), each
timed against its fp32 instantiation in turns and its bound at bf16
bytes (K3-bwd's default plan also at cifar10-deep's [128,100,32,32]); 60
flagship steps (``--fused auto``, as a CUDA graph of 10) and
40 celeba64 steps each under ``auto`` (eager) and ``all`` (graphed)
through ``lvae_tpu_torch.main --precision bf16`` with init, every bf16
instantiation held to its launch count and the checkpoint scored in bf16
by ``lvae_tpu_torch.evaluate``; one bf16 step on the kernel path against
the plain path; 20 steps in bf16 against 20 in fp32 from the trained
bf16 checkpoint (the mean loss of the last 20 within 2%); celeba64
``all`` graphed in bf16 bit-equal to eager, its device time and idle
share (phase 17's fp32 cell beside it); test ELBO and the k=100 IW-LL
of both models' trained bf16 checkpoints scored in fp32 and in bf16, with
the bpd delta and images/s.

Then cifar10-deep (phase 19; BASELINE config 4: 32x32 RGB, ten latent
layers, 64 filters, 2 blocks per layer, the mixture head): every kernel of
its path against its plain version at its shapes (K1, K1-bwd, K2 at the
ten layers, K3 and K3-bwd in fp32 and bf16, K5, K5-bwd and the dropout
kernel at every segment shape in fp32 and bf16, K5 without running
buffers), each timed per step; 60 steps through ``lvae_tpu_torch.main
--precision bf16 --fused all --remat --grad-accum 2 --steps-per-call 10``
with init on 20,000 synthetic images in CIFAR-10's pickle layout, every
launch counted (the remat recompute's among them) and the test hook's
three grids; a ``--remat`` step bit-equal to a plain one, ten graphed
``--grad-accum 2`` steps bit-equal to eager ones, the peak memory with
and without ``--remat``; and
``lvae_tpu_torch.evaluate --load <run name>`` from the run's own
checkpoint: test ELBO, the k=100 IW-LL and a diagnostics grid.

Then the multi-object datasets and the serving artifacts (phase 20):
multi-dSprites (64x64 RGB, binary, the Bernoulli head) at the flagship's
widths on 10,000 synthetic scenes in the multiobject npz layout: one
``--fused all`` step against the plain path, 20 steps through
``lvae_tpu_torch.main --fused all --steps-per-call 10`` with init and
every launch counted, ``lvae_tpu_torch.evaluate --load <run> --ll``;
multi-MNIST (48x48, padded to 64) through 5 steps and the test ELBO;
``python -m lvae_tpu_torch.export_serving --load <run> --check
--platforms cuda cpu`` and the same command exporting phase 18b's
celeba64 bf16 run's ``reconstruct`` (run beside phase 19); every artifact
served by a process that cannot import the port (B = 1, 7, 64 and a
shuffled 7; ``generate``; celeba64's served beside 20a-c, the eager
references computed beside the serving), its graphs
aten-only, its answers held to the eager plain path (1e-6) and kernel
path, and batch-invariant; export s, artifact MiB, load and first-call s,
and ``reconstruct`` img/s of the artifact against the eager kernel path.

Then ``--streaming`` (phase 21), the train split kept on the host and
each stack copied to the card through two pinned buffers: the feed alone
(gather, pinned and pageable copies, MB/s) at celeba64's and the
flagship's ``[10, B, H, W, C]`` stacks; 40 celeba64 steps through
``lvae_tpu_torch.main --streaming --fused all --precision bf16
--steps-per-call 10`` with init, every kernel of the path counted, resumed
from the middle checkpoint bit-equal; graphed streamed calls bit-equal to
the device-resident ``MultiStep`` fed the loader's rows and to eager
streamed steps, ms/step and idle share against the resident
path, and the card's memory without the split; 20 flagship eager fp32
steps through ``main --streaming`` bit-equal to the resident path.

Last, the measurement tools (phase 22): K1 and K1-bwd at every latent
layer, and K3 and K3-bwd in fp32 and bf16, against their plain versions
at the shapes the bench's default run of each preset gives them; then,
each through its ``main(argv)``: ``lvae_tpu_torch.bench`` (the twin of
``bench.py``) at mnist, celeba64 and
cifar10-deep in bf16 and mnist in fp32, 2 timed calls of a CUDA graph of
8 steps each after a warm-up call, every result line held to a finite rate, at most
1.05x the precision's peak, the same FLOPs an image in both precisions and
every kernel of the path launched once a layer and step, and mnist fp32
graphed at ``--fused none``; ``lvae_tpu_torch.profile_step`` on celeba64
bf16 graphed (each kernel's events against its nodes in the graph, the
port's kernels at their launches a step, the table marked partial
wherever a kernel is short);
``lvae_tpu_torch.perf_probe`` at batch 256; ``lvae_tpu_torch.iwll_probe``
at its defaults; and one batch of the IW-LL sweep (k=100, chunk 1) at
phases 4 and 11's shapes in bf16 with its device busy time and
idle share. The helpers it times and profiles with are
``lvae_tpu_torch.profiling``'s.

Then data parallelism, ``--num-data-shards`` (phase 23): 23a the flagship
at full width, fp32, ``--fused all``, two graphed calls of 8 steps on
one rank of an NCCL group (the loss's and the gradients' all-reduces in
the graph) bit-equal to the same run without a group, ms per step of the
two graphs in turns (the dry run runs at 2 x 2 in phase 25a); 23c
the commands on two gloo ranks sharing the card: ``lvae_tpu_torch.main
--num-data-shards 2 --fused all`` (its ranks started here as ``torchrun``
starts them, 2 steps, each rank's launches counted: the split segments
and no one-launch K5; one run directory and checkpoint), then on both ranks
gloo's all-reduce of a CUDA tensor, each launch of the split segment
(K5-split, K5-bwd-split) against its plain version at every segment shape
of a rank, timed per call and on the device with its bound at the
largest, and the gloo all-reduces of a step timed (two ranks on one card:
not a multi-GPU rate); then the same command as typed, starting its own
ranks, resumed two steps further, and ``evaluate --num-data-shards 2``
against one rank's.

Then the checkpoint pair (phase 24, run while 23c's resumed command and
its evaluate run as subprocesses): phase 8's flagship run exported by
``python -m lvae_tpu_torch.convert_checkpoint export`` and imported into a
new run directory by ``convert_checkpoint import``; both runs scored by
``lvae_tpu_torch.evaluate --load`` (test ELBO, the k=100 IW-LL over 1,000
images) bit-equal, and ``lvae_tpu_torch.main --load <imported>`` trained
2 steps under ``--rng-impl rbg`` bit-equal to threefry (cuDNN's
deterministic algorithms on in every run compared: its default ones sum
in another order run to run), each entry point's launches counted.

Last, height sharding, ``--spatial-shards`` (phase 25): 25a the README's
flagship at full width and depth (4 blocks a layer), fp32, ``--fused
all``, 3 steps against one rank at 2 x 2
through ``graft_entry_torch.dryrun_multichip(4)`` (its default layout for
an even count; held to one rank's run: losses 1e-5 relative, parameters
1e-4 but for a share of 2e-5; the sharded evaluate, the checkpoint round
trip, K3 on each rank's rows) and at 1 x 4 through
``lvae_tpu_torch.main --num-data-shards 1 --spatial-shards 4`` (four gloo
ranks sharing the card, started here as ``torchrun`` starts them; two
hold an empty band of the 2-row top), each rank's layout and launches
checked (K1, K1-bwd, the dropout kernel and the split segments on its
bands, no one-launch K5), its halo exchanges counted (not timed: 25c
and the 2 x 2 dry run go on beside it), the
logged metrics within 1e-5 and the checkpoint within Adamax's bound of
``main`` on one rank; 25b the banded index map of K1, K1-bwd, K2, the
dropout kernel and the split segments at every band shape of the
flagship over 2 and 4 ranks (a 1-row and an empty band among them)
against their plain versions (the bands' eps and dropped outputs
concatenated bit-equal to the whole map's), each timed at the widest
band of the 2 x 2 layout with its bound; 25c celeba64 at 1
x 2 for 2 steps the same way, K3 and K3-bwd on each rank's band.

Each entry point's run checks that it launched every kernel of its path;
the kernel path, the plain path and a CPU run are held to agree, and each
kernel is timed against its plain version.

Prints the card (``nvidia-smi`` name and power limit), one JSON line with
each kernel's launches (on each phase's path; ``launches_bench``: phase
22's bench runs), error, times, bound and library call, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and no result line is printed. Exits non-zero at once
when no CUDA device is visible.
"""

import atexit
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from lvae_tpu_torch.iwll_probe import CELEBA, FLAGSHIP, celeba_dataset, rgb_blobs, seeded_model
from lvae_tpu_torch.profiling import (by_name, card_line, device_spans, device_union,
                                      graph_kernel_names, kernel_events, kernel_names)

REPO = os.path.dirname(os.path.abspath(__file__))
B = FLAGSHIP["test_batch_size"]             # flagship eval batch
LATENT_SHAPES = [(32, 8, 8), (32, 4, 4), (32, 2, 2)]   # (c, h, w) per layer
N_TEST = 10_000
IW_SAMPLES = 100
TRAIN_B = FLAGSHIP["batch_size"]            # flagship train batch
N_TRAIN = 50_000
TRAIN_STEPS = 40                            # phase 8
# each Trainer.run of the A/Bs of phases 9, 13 and 16: steps, and the rate
# taken over the steps after AB_LOG
AB_STEPS, AB_LOG = 10, 5
ODD_SHAPE = (3, 7, 7)                       # F = 147: not a multiple of 128
LONG_ROW = (32, 32, 32)                     # F = 32,768: 16 float4 units a K1 thread


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


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
    spans = device_spans(prof)
    kernels = by_name(spans)
    busy = sum(ns for _, ns in kernels.values()) / 1e6 / reps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    table = [(name[:70], ns / 1e6 / reps, n // reps) for name, (n, ns) in top]
    if host_top is not None:
        ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
        ops.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
        host_top += [(e.key[:70], e.self_cpu_time_total / 1e3 / reps, e.count // reps)
                     for e in ops[:12]]
    return busy, wall, table, len(spans)


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

    from lvae_tpu_torch import hw_tests
    from lvae_tpu_torch.kernels import stochastic as sk
    from lvae_tpu_torch.ops.philox import keyed_normal

    print("[2] sample+KL kernel vs its plain version; the hardware checks", flush=True)
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

    # the hardware checks of lvae_tpu_torch.hw_tests (the twin of
    # tools/tpu_hw_tests.py), the eps statistics among them: the kernel's z
    # at mu = log-var = 0, four keys of [1024, 8, 32, 32]
    print(f"  lvae_tpu_torch.hw_tests on the card  ({card})", flush=True)
    t_hw = time.perf_counter()
    rows, draws = hw_tests.run_checks(dev)
    failed = [name for name, ok, _ in rows if not ok]
    check(not failed, f"hw_tests: {len(rows) - len(failed)} of {len(rows)} checks pass "
                      f"(failed: {failed})")
    b_eps = hw_tests.EPS_SHAPE[0]
    ref = keyed_normal(hw_tests.EPS_SHAPE, hw_tests.EPS_KEYS[0],
                       torch.arange(b_eps, device=dev), 0, 0)
    e = float(np.abs(draws[0] - ref.flatten().double().cpu().numpy()).max())
    check(e <= 1e-5, f"kernel eps equals the plain generator's (max abs {e:.2e})")
    x = np.concatenate(draws)
    ks = stats.kstest(x, "norm")
    check(ks.pvalue > 1e-3, f"KS vs N(0,1) over {x.size} draws: D={ks.statistic:.2e} "
                            f"p={ks.pvalue:.3f}")
    hw = {"checks": [{"name": name, "ok": ok, "detail": detail}
                     for name, ok, detail in rows],
          "ks": {"n": int(x.size), "D": float(ks.statistic), "p": float(ks.pvalue)},
          "eps_vs_plain_max_abs": e, "seconds": time.perf_counter() - t_hw}
    print(f"  hw_tests, the plain eps and the KS test took {hw['seconds']:.1f} s")
    return err, [total([t[i] for t in times]) for i in range(4)], bound(n_bytes, n_ops), hw


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
    # the forwards: the ELBO sweep's, the IW-LL's and the reconstruction
    # grid's (evaluate writes the grids after the metrics)
    check(launches["sample_kl"] == 3 * (n_batches + IW_SAMPLES + 1),
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


def time_calls(fns, reps=(50, 10, 20, 5)):
    """(ms per call, device ms per call) of the "kernel" and the "plain"
    version in ``fns``; ``reps``: the calls timed per call (kernel,
    plain) and profiled (kernel, plain)."""
    per_call = {"kernel": cuda_ms(fns["kernel"], reps[0]),
                "plain": cuda_ms(fns["plain"], reps[1])}
    device = {"kernel": device_ms(fns["kernel"], reps[2]),
              "plain": device_ms(fns["plain"], reps[3])}
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


@contextlib.contextmanager
def init_counted():
    """{launch counter: launches} of the data-dependent init of the one
    training run inside the block (its train-mode statistics passes sample
    the latents with K1, as ``lvae_tpu``'s do; a pass stops at the conv it
    measures): ``Experiment.init_state`` wrapped to read the counts, reset
    just before the run, as it returns, the card synchronised."""
    import torch

    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.train.trainer import Experiment

    counts, orig = {}, Experiment.init_state

    def init_state(self, *args, **kwargs):
        state = orig(self, *args, **kwargs)
        torch.cuda.synchronize()
        counts.update(build.LAUNCHES)
        return state

    Experiment.init_state = init_state
    try:
        yield counts
    finally:
        Experiment.init_state = orig


def write_mnist(data_dir, train_u8, test_u8):
    """The splits as static_mnist's .amat files under ``data_dir``."""
    os.makedirs(os.path.join(data_dir, "static_mnist"))
    for split, arr in (("train", train_u8), ("test", test_u8)):
        write_amat(os.path.join(data_dir, "static_mnist", f"binarized_mnist_{split}.amat"),
                   arr)


def phase_train(card, train_u8, test_u8, tmp):
    """Phase 8 in ``tmp``, which keeps the data and the run for phase 24:
    ``out["run_dir"]``, ``out["data_dir"]``."""
    import torch

    from lvae_tpu_torch import evaluate
    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build

    print("[8] the training slice through lvae_tpu_torch.main", flush=True)
    out = {}
    data_dir = os.path.join(tmp, "data")
    write_mnist(data_dir, train_u8, test_u8)
    build.reset_launches()
    t0 = time.perf_counter()
    with init_counted() as init:
        trainer = train_main.main(FLAGSHIP_ARGS + [
            "--data-dir", data_dir, "--data-dep-init", "--max-steps", str(TRAIN_STEPS),
            "--device", "cuda", "--log-interval", "20",
            "--test-interval", str(TRAIN_STEPS // 2),
            "--checkpoint-interval", str(TRAIN_STEPS // 2),
            "--output-dir", os.path.join(tmp, "out"), "--run-name", "flagship",
        ])
    torch.cuda.synchronize()
    n_init = init["sample_kl_per_sample"]
    print(f"  the data-dependent init launched K1 {n_init} times and the dropout kernel "
          f"{init['dropout']}")
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    print(f"  launches in the training run: {launches}")
    print(f"  run wall {wall:.1f} s (data parse, data-dependent init, "
          f"{TRAIN_STEPS} steps, 2 test sweeps, 2 checkpoints)  ({card})")
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
    first, last = float(train_lines[20]["loss"]), float(train_lines[TRAIN_STEPS]["loss"])
    check(last < first, f"EMA loss {last:.2f} at step {TRAIN_STEPS} below "
                        f"{first:.2f} at step 20")
    tests = [m for kind, _, m in hist if kind == "test"]
    check(len(tests) == 2, f"the test hook ran at steps {TRAIN_STEPS // 2} and "
                           f"{TRAIN_STEPS}")
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
    # the second half's 20-step windows
    late = [r for step, r in out["log_rates"].items() if step > TRAIN_STEPS // 2]
    out["log_rate_late"] = len(late) / sum(1.0 / r for r in late)
    print(f"  logged train rate over steps {TRAIN_STEPS // 2 + 1}-{TRAIN_STEPS} (a metric "
          f"sync every 20 steps, the middle checkpoint inside): "
          f"{out['log_rate_late']:.1f} img/s  ({card})")
    out["test_elbo"] = [float(m["elbo"]) for m in tests]
    out["ema_loss"] = (first, last)
    out["run_dir"], out["data_dir"] = trainer.run_dir, data_dir
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
    same on both); then train images/s through ``Trainer.run``, one run of
    each path (K, then P, ``ab_steps`` steps each, the rate over the steps
    after ``ab_log``), and a 5-step profile of ``paths[0]``."""
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
    for fused in (True, False):
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
# a K whose one-pass terms leave no room for a second CTA on an SM (the
# two-pass plan by default; every model of the repo has K = 10), and a 7x7
# map, whose 49 pixels no V > 1 of K3 divides
MIX_SHAPES = [(128, 3, 64, 64, K_MIX), (500, 3, 64, 64, K_MIX), (16, 1, 32, 32, K_MIX),
              (32, 3, 64, 64, 24), (8, 3, 7, 7, K_MIX)]
CELEBA_B, CELEBA_EVAL_B = CELEBA["batch_size"], CELEBA["test_batch_size"]
CELEBA_N_TRAIN, CELEBA_N_TEST = 20_000, 2_000
CELEBA_STEPS = 40                           # phase 12
SEGMENT_STEPS = 40                          # phase 15
CELEBA_LATENTS = [(16, 16, 32), (8, 8, 32), (4, 4, 32), (2, 2, 32)]   # NHWC per layer
CELEBA_ARGS = [
    "--dataset", "celeba", "--zdims", "32", "32", "32", "32", "--downsample", "1", "1",
    "1", "1", "--blocks-per-layer", "2", "--n-filters", "64", "--skip", "--gated",
    "--learn-top-prior", "--freebits", "0.5", "--dropout", "0.2", "--seed", "42",
    "--batch-size", str(CELEBA_B), "--test-batch-size", str(CELEBA_EVAL_B),
]


def write_celeba(data_dir, train_u8, test_u8):
    """The splits as the loader's ``celeba/celeba_64.npz`` cache."""
    os.makedirs(os.path.join(data_dir, "celeba"), exist_ok=True)
    np.savez(os.path.join(data_dir, "celeba", "celeba_64.npz"), train=train_u8, test=test_u8)


def mix_kernel_name(entry):
    """``mix_fwd_kernel<3, bf16, V 2>`` of a mangled symbol (the forward's
    pixels a thread as its third template argument)."""
    m = re.search(r"(mix_\w+?_kernel)ILi(\d)E(f|13__nv_bfloat16)(?:Li(\d)E)?E", entry)
    if not m:
        return entry
    v = f", V {m[4]}" if m[4] else ""
    return f"{m[1]}<{m[2]}, {'float' if m[3] == 'f' else 'bf16'}{v}>"


def k3_plan_checks(x, p, k, shape):
    """K3 at every V of ``kernels/mixture.py`` ``FWD_VECTORS``, fp32 and
    bf16 params, against the plain version on the same params (1e-4 +
    1e-5 |ll|), each relaunch bit-equal. Every V does the same arithmetic
    per pixel, so their ll are bit-equal, and so is a map one element off
    alignment, which the kernel reads one value at a time (V = 1); the
    default launch is its V's."""
    import torch

    from lvae_tpu_torch.kernels import mixture as km

    b, c, h, w = x.shape
    default = km.fwd_plan(b, h * w)
    for pp in (p, p.to(torch.bfloat16)):
        label = "bf16" if pp.dtype == torch.bfloat16 else "fp32"
        ref = km._plain_mix_log_prob(x, pp, k, 256)
        # the same values one element past an aligned address
        off = torch.empty(pp.numel() + 1, dtype=pp.dtype, device=pp.device)[1:].view_as(pp)
        off.copy_(pp)
        worst, first = {}, None
        for v in km.FWD_VECTORS:
            ll = km.mix_log_prob(x, pp, k, plan=v)
            e = ((ll - ref).abs() - 1e-5 * ref.abs()).max().item()
            worst[v] = (ll - ref).abs().max().item()
            check(ll.dtype == torch.float32 and e <= 1e-4,
                  f"K3 {label} {shape} V={v}: ll within 1e-4 + 1e-5 |ll| (max |d| - 1e-5 "
                  f"|ll| = {e:.2e}; ll in [{ref.min().item():.1f}, {ref.max().item():.1f}])")
            check(torch.equal(ll, km.mix_log_prob(x, pp, k, plan=v)),
                  f"K3 {label} {shape} V={v}: a second launch is bit-equal")
            check(torch.equal(ll, km.mix_log_prob(x, off, k, plan=v)),
                  f"K3 {label} {shape} V={v}: the map one element off alignment gives the "
                  f"same bits")
            if first is None:
                first = (v, ll)
            else:
                check(torch.equal(ll, first[1]), f"K3 {label} {shape} V={v}: bit-equal to "
                                                 f"V={first[0]}")
            if v == default:
                check(torch.equal(ll, km.mix_log_prob(x, pp, k)),
                      f"K3 {label} {shape}: the default launch is V={v}, bit for bit")
        print(f"  K3 {label} {shape}: default V={default}; max |ll - plain| by V: "
              + ", ".join(f"{v}: {e:.2e}" for v, e in worst.items()))
        del ref, off, first


def phase_mixture(card, build_log=""):
    """K3 and K3-bwd against their plain versions at every ``MIX_SHAPES``
    entry, K3 on each of its plans in fp32 and bf16, K3-bwd on each of its
    plans; both timed at celeba64's batches,
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
        del ll, ref
        k3_plan_checks(x, p, k, shape)

        default = km.bwd_plan(k, c, b, h * w)
        # every schedule, the one pass at each V (it fits a CTA at every K here)
        plans = {f"one_pass V={v}": ("one_pass", v) for v in km.BWD_VECTORS}
        plans["two_pass"] = ("two_pass", None)
        more["plans"][shape] = {"default": default.name, "v": default.v, "smem": default.smem,
                                "fwd_v": km.fwd_plan(b, h * w)}
        print(f"  K3-bwd {shape}: default plan {default.name} V={default.v} ({default.smem} B "
              f"of shared memory per CTA of {km.THREADS}); checked: {', '.join(plans)}")
        dp, dx = km.mix_log_prob_backward(x, p, gg, k)
        dp_h, dx_h = km._plain_mix_log_prob_bwd(x, p, gg, k, 256)
        xr, pr = x.clone().requires_grad_(), p.clone().requires_grad_()
        km._plain_mix_log_prob(xr, pr, k, 256).backward(gg)
        check(bool((pr.grad[:, lo:lo + 2] == 0).all()),
              f"{shape}: autograd of the plain forward has no gradient where the "
              f"log-scale is below -7")
        one_pass = {}
        for plan, (name, v) in plans.items():
            dpf, dxf = km.mix_log_prob_backward(x, p, gg, k, plan=name, v=v)
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
            dp2, dx2 = km.mix_log_prob_backward(x, p, gg, k, plan=name, v=v)
            check(torch.equal(dpf, dp2) and torch.equal(dxf, dx2),
                  f"K3-bwd {shape} {plan}: a second launch is bit-equal")
            if (name, v) == (default.name, default.v if name == "one_pass" else None):
                check(torch.equal(dpf, dp) and torch.equal(dxf, dx),
                      f"K3-bwd {shape}: the default launch is {plan}, bit for bit")
            if name == "one_pass":
                one_pass[v] = (dpf, dxf)
            del dp2, dx2
        # every V of the one pass does the same arithmetic per pixel, and a
        # map one element off alignment runs V = 1
        off = torch.empty(p.numel() + 1, device=dev)[1:].view_as(p)
        off.copy_(p)
        for v, (dpf, dxf) in one_pass.items():
            check(torch.equal(dpf, one_pass[1][0]) and torch.equal(dxf, one_pass[1][1]),
                  f"K3-bwd {shape} one_pass V={v}: bit-equal to V=1")
            dpo, dxo = km.mix_log_prob_backward(x, off, gg, k, plan="one_pass", v=v)
            check(torch.equal(dpo, dpf) and torch.equal(dxo, dxf),
                  f"K3-bwd {shape} one_pass V={v}: the map one element off alignment gives "
                  f"the same bits")
            del dpo, dxo
        del one_pass, off, dpf, dxf
        pk = p.clone().requires_grad_()
        build.reset_launches()
        km.mix_log_prob(x, pk, k).backward(gg)
        check(build.LAUNCHES["mix_log_prob"] == 1 and build.LAUNCHES["mix_log_prob_bwd"] == 1,
              f"{shape}: the autograd.Function launches K3 and K3-bwd once each")
        check(torch.equal(pk.grad, dp), f"{shape}: its gradient is K3-bwd's")
        build.reset_launches()
        del xr, pr, pk, dp_h, dx_h
        if c == 3 and k != K_MIX:           # each plan where two passes is the default
            for plan, (name, v) in plans.items():
                t = cuda_ms(lambda: km.mix_log_prob_backward(x, p, gg, k, need_dx=False,
                                                             plan=name, v=v), 10)
                more["plans"][shape][f"{plan}_ms"] = t
                print(f"  time K3-bwd {shape} {plan} per call: {t:.4f} ms  ({card})")
        if c != 3 or k != K_MIX or h != 64:
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
    n_fwd = CELEBA_N_TEST // b + IW_SAMPLES + 1        # and the reconstruction grid's
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
    steps, n_sweeps = CELEBA_STEPS, 2
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        write_celeba(data_dir, train_u8, test_u8)
        build.reset_launches()
        t0 = time.perf_counter()
        with init_counted() as init:
            trainer = train_main.main(CELEBA_ARGS + [
                "--data-dir", data_dir, "--data-dep-init", "--max-steps", str(steps),
                "--device", "cuda", "--log-interval", "20",
                "--test-interval", str(steps // 2), "--checkpoint-interval", str(steps // 2),
                "--output-dir", os.path.join(tmp, "out"), "--run-name", "celeba64",
            ])
        torch.cuda.synchronize()
        print(f"  the data-dependent init launched K1 {init['sample_kl_per_sample']} and K3 "
              f"{init['mix_log_prob']} times")
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        print(f"  launches in the training run: {launches}")
        print(f"  run wall {wall:.1f} s (data load, data-dependent init, {steps} steps, "
              f"{n_sweeps} test sweeps, 2 checkpoints)  ({card})")
        # each test hook: its sweep's batches and the reconstruction grid's forward
        sweep_batches = n_sweeps * (CELEBA_N_TEST // CELEBA_EVAL_B + 1)
        check(launches["mix_log_prob_bwd"] == steps,
              f"K3-bwd: 1 launch per step ({launches['mix_log_prob_bwd']})")
        check(launches["mix_log_prob"] == steps + sweep_batches + init["mix_log_prob"],
              f"K3: 1 launch per step, per test-hook forward ({sweep_batches}) and the init's "
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
        check(len(tests) == n_sweeps, f"the test hook ran at steps {steps // 2} and {steps}")
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
        late = [r for step, r in out["log_rates"].items() if step > steps // 2]
        out["log_rate_late"] = len(late) / sum(1.0 / r for r in late)
        print(f"  logged train rate over steps {steps // 2 + 1}-{steps} (a metric sync every 20 "
              f"steps): {out['log_rate_late']:.1f} img/s  ({card})")
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


def segment_paths(shape, esize=4):
    """{label: (path argument, forward plan or None, backward plan or None)}:
    "default", the plans that a caller gets at ``shape`` with ``esize``
    bytes an element (4: fp32, 2: bf16), and each path it can be forced
    to, with the direction's plan where that path is legal and differs
    from the default."""
    from lvae_tpu_torch.kernels import segment as seg

    default = tuple(seg._plan(*shape, d, None, esize) for d in ("fwd", "bwd"))
    out = {"default": (None, *default)}
    for path in seg.PATHS:
        plans = []
        for direction, plan in zip(("fwd", "bwd"), default):
            try:
                forced = seg._plan(*shape, direction, path, esize)
            except ValueError:
                forced = None
            plans.append(None if forced == plan else forced)
        if any(plans):
            out[f"forced {path}"] = (path, *plans)
    return out


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
        m = re.search(r"(fwd|bwd)_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d)E", entry)
        name = (f"{m[1]}_kernel<{'float' if m[2] == 'f' else 'bf16'}, {m[3]}, "
                f"{('elu', 'relu')[int(m[4])]}>" if m else entry)
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
                nodes = [sum(graph_kernel_names(fn).values())
                         for k, (_, fn) in calls.items() if k[0] == name]
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
    steps, n_sweeps = SEGMENT_STEPS, 1
    out = {}
    with tempfile.TemporaryDirectory() as tmp, init_counted() as init:
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
        # each test hook: its sweep's batches and the reconstruction grid's forward
        sweep_batches = n_sweeps * (CELEBA_N_TEST // CELEBA_EVAL_B + 1)
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
        out["run_dir"], out["data_dir"] = trainer.run_dir, data_dir
    return out


# ---------------------------------------------------------------------------
# --steps-per-call k: one CUDA graph of k train steps (phase 17)
# ---------------------------------------------------------------------------

GRAPH_K = 10
GRAPH_CLI_STEPS = 60
# the kernels of a train step by the identifier in their symbol; K3-bwd
# has two plans (kernels/mixture.py bwd_plan)
GRAPH_KERNELS = {"dropout_kernel": "dropout",
                 "sample_kl_rows_kernel": "sample_kl_per_sample",
                 "sample_kl_bwd_kernel": "sample_kl_per_sample_bwd",
                 "mix_fwd_kernel": "mix_log_prob", "mix_bwd_one_pass_kernel": "mix_log_prob_bwd",
                 "mix_bwd_kernel": "mix_log_prob_bwd", "fwd_kernel": "segment",
                 "bwd_kernel": "segment_bwd"}


def port_kernel(symbol):
    """The launch counter of the port's kernel whose mangled symbol this is
    (None for another kernel): its identifier with the length prefix the
    mangling gives it, so not a longer identifier ending in it; a bf16
    instantiation (``__nv_bfloat16`` among its template arguments) counts
    under its ``[bf16]`` name."""
    for ident, counter in GRAPH_KERNELS.items():
        if f"{len(ident)}{ident}" in symbol:
            return counter + "[bf16]" if "__nv_bfloat16" in symbol else counter
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


def graph_cell(card, name, args, data, weights):
    """One model and kernel policy under ``--steps-per-call GRAPH_K``: 3k
    steps through MultiStep (a warm-up call of k eager steps, which
    captures the graph, then two replays) against 3k eager train steps
    from the same state and batches, bit for bit (deterministic
    algorithms on, as phases 9 and 13); the graph's kernel nodes by
    kernel against the eager steps' launches; and the graphed path's device
    ms per step and idle share from a profile (the eager path's ms a step
    and profile are phases 9, 13 and 16's, through Trainer.run)."""
    import torch

    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.train.state import MultiStep, train_step
    from lvae_tpu_torch.train.trainer import Experiment, index_stream

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
        symbols = kernel_names(multi.graph.raw_cuda_graph())
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
        want = {n for n in per_step if n.removesuffix("[bf16]") in GRAPH_KERNELS.values()}
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

    # device time and idle share: a graphed call of k steps, after a first
    # call (the warm-up and capture) outside the profile
    exp, state = setup()
    stream = index_stream(exp.train_data, cfg.batch_size, cfg.seed, 0, k)
    multi = MultiStep(state, exp.train_data.gather, exp.loss_cfg, k)
    multi(next(stream))
    busy, kernel_sum, wall, n_events = device_union(lambda: multi(next(stream)))
    out["graphed"] = dict(device_ms_per_step=busy / k, kernel_ms_per_step=kernel_sum / k,
                          profiled_ms_per_step=wall / k, idle_share=1.0 - busy / wall,
                          kernel_events_per_step=n_events / k)
    print(f"  {name} graphed: profile of a call of {k} steps: device busy {busy / k:.2f} ms "
          f"per step (the union of kernel intervals; their sum {kernel_sum / k:.2f}), wall "
          f"{wall / k:.2f} ms per step, idle share {1.0 - busy / wall:.3f}, "
          f"{n_events / k:.0f} kernel events per step  ({card})")
    del exp, state, stream, multi
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
        print(f"  [{name} at {time.perf_counter() - t0:.1f} s of phase 17]", flush=True)
    print(f"  [the CLI at {time.perf_counter() - t0:.1f} s of phase 17]", flush=True)
    out["cli"] = graph_cli(card, train_u8, test_u8)
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 17 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# --precision bf16 (phase 18): bf16 convs from fp32 parameters, the bf16
# instantiations of K5, K5-bwd, the dropout kernel, K3 and K3-bwd
# ---------------------------------------------------------------------------

BF16_FLAGSHIP_STEPS = 60
BF16_CELEBA_STEPS = 40
BF16_GAP_STEPS = 20                 # per precision; the gap is over the last 20
BF16_IW_BATCH = {"flagship": 250, "celeba64": 100}    # the IW-LL's images, one batch
SEGMENT_RAGGED = (3, 8, 5, 7)       # H W = 35: units of one element
# one step of the kernel path against the plain path, both bf16: a
# kernel's fp32 result an ulp away from the plain version's flips a
# downstream bf16 rounding, which the convs carry on, so the step agrees to
# bf16's precision, not fp32's (phases 9 and 13: 1e-4)
BF16_STEP_TOL = {"loss": 1e-4, "grad": 1e-1}


def bf16_ulps(got, want):
    """(largest distance in bf16 ulps, elements apart) of two bf16 tensors;
    equal values (+0 and -0) are 0 apart."""
    import torch

    d = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    d = torch.where(got == want, torch.zeros_like(d), d)
    return int(d.max()), int((d > 0).sum())


def bf16_held(got, want, what, within=None):
    """A bf16 output bit-equal to its plain version's, or within 1 bf16
    ulp with the count printed; ``within`` (a float tolerance, absolute)
    also admits elements the fp32 check of the same output admits."""
    import torch

    check(got.dtype == want.dtype == torch.bfloat16, f"{what}: bf16")
    m, n = bf16_ulps(got, want)
    if m <= 1 or within is None:
        check(m <= 1, f"{what}: bit-equal or within 1 bf16 ulp ({n} of {got.numel()} "
                      f"elements 1 ulp apart)")
        return n
    far = (got.float() - want.float()).abs() > within
    d = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    check(not bool((far & (d > 1)).any()),
          f"{what}: within 1 bf16 ulp ({n} of {got.numel()} elements apart), or within "
          f"{within:.2e} where further (largest {m} ulps)")
    return n


def phase_bf16_kernels(card, per_step, timed, build_log=""):
    """The bf16 instantiations against their plain bf16 versions: K5 and
    K5-bwd at every segment shape of both models (each path the plan can be
    forced to), a ragged and a misaligned shape; the dropout kernel at the
    same shapes; K3 at every ``MIX_SHAPES`` entry and the bf16 IW-LL's
    batch, K3-bwd (both plans) at celeba64's training batch. Each timed at
    the ``timed`` shapes against its fp32 instantiation, in turns, and
    against its bound at bf16 bytes."""
    import torch

    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.kernels import mixture as km
    from lvae_tpu_torch.kernels import segment as seg
    from lvae_tpu_torch.ops.math import (
        bits8_dropout_f32,
        bits8_keep_threshold,
        segment_backward,
        segment_forward,
    )
    from lvae_tpu_torch.ops.philox import dropout_bytes, mix_seed

    print("[18a] the bf16 instantiations (K5, K5-bwd, the dropout kernel, K3, K3-bwd) vs "
          "their plain bf16 versions", flush=True)
    for entry, line in ptxas_usage(build_log, "__nv_bfloat16").items():
        print(f"  ptxas {entry[:90]}: {line}")
    bf = torch.bfloat16
    dev = torch.device("cuda")
    g_ = torch.Generator(device=dev).manual_seed(18)
    key = seg.Key(42, torch.tensor(7, dtype=torch.int64, device=dev), 3)
    seed = mix_seed(42, 7, 3)
    err = {k: 0.0 for k in ("segment", "segment_bwd", "dropout", "mix", "mix_bwd")}
    apart = {k: 0 for k in err}
    shapes = [s for counts in per_step.values() for s in counts] + [SEGMENT_RAGGED,
                                                                    "misaligned"]
    for si, shape in enumerate(shapes):
        if shape == "misaligned":       # a contiguous view 2 bytes past an aligned base
            shape = (4, 8, 6, 6)
            n = int(np.prod(shape))
            base = (torch.randn(n + 1, generator=g_, device=dev) * 1.5 + 0.3).to(bf)
            x = base[1:].view(shape)
        else:
            x = (torch.randn(shape, generator=g_, device=dev) * 1.5 + 0.3).to(bf)
        c = shape[1]
        g = torch.randn(shape, generator=g_, device=dev).to(bf)
        gamma = torch.rand(c, generator=g_, device=dev) + 0.5
        beta = torch.randn(c, generator=g_, device=dev) * 0.2
        for rate in (0.0, 0.2):
            t = bits8_keep_threshold(rate)
            bytes_ = dropout_bytes(shape, seed, dev) if t < 256 else None
            for act in ("elu", "relu") if si == 0 else ("elu",):
                what = f"{list(shape)} rate {rate} {act}"
                rm_p = torch.full((c,), 0.3, device=dev)
                rv_p = torch.full((c,), 1.7, device=dev)
                yp, mp, vp, rp = segment_forward(x, gamma, beta, t, act, mask_bytes=bytes_,
                                                 running_mean=rm_p, running_var=rv_p)
                dxp, dgp, dbp = segment_backward(x, g, gamma, beta, mp, rp, t, act, bytes_)
                for label, (path, pf, pb) in segment_paths(shape, 2).items():
                    k = f"{what} {label}"
                    if pf is not None:
                        rm = torch.full((c,), 0.3, device=dev)
                        rv = torch.full((c,), 1.7, device=dev)
                        y, stats = seg._launch_fwd(x, gamma, beta, t, act, 1e-5, key, rm, rv,
                                                   0.9, path)
                        apart["segment"] += bf16_held(y, yp, f"K5 bf16 {k}: y")
                        err["segment"] = max(err["segment"],
                                             (y.float() - yp.float()).abs().max().item())
                        e = max(rel_elem(stats[0], mp), rel_elem(stats[1], vp),
                                rel_elem(rm, rm_p), rel_elem(rv, rv_p))
                        check(stats.dtype == torch.float32 and e <= 1e-6,
                              f"K5 bf16 {k}: fp32 mean, var and running stats within 1e-6 "
                              f"relative ({e:.2e})")
                        y2, stats2 = seg._launch_fwd(x, gamma, beta, t, act, 1e-5, key, None,
                                                     None, 0.9, path)
                        check(torch.equal(y, y2) and torch.equal(stats, stats2),
                              f"K5 bf16 {k}: a second launch is bit-equal")
                        del y, y2
                    else:
                        _, stats = seg._launch_fwd(x, gamma, beta, t, act, 1e-5, key, None,
                                                   None, 0.9)
                    if pb is None:
                        continue
                    dx, dgamma, dbeta = seg._launch_bwd(x, g, gamma, stats, t, act, key, path)
                    apart["segment_bwd"] += bf16_held(dx, dxp, f"K5-bwd bf16 {k}: dx")
                    e = max(rel_max(dgamma, dgp), rel_max(dbeta, dbp))
                    check(dgamma.dtype == torch.float32 and e <= 1e-5,
                          f"K5-bwd bf16 {k}: fp32 dgamma, dbeta within 1e-5 of their max "
                          f"({e:.2e})")
                    err["segment_bwd"] = max(err["segment_bwd"],
                                             (dx.float() - dxp.float()).abs().max().item(),
                                             (dgamma - dgp).abs().max().item(),
                                             (dbeta - dbp).abs().max().item())
                    check(torch.equal(dx == 0, dxp == 0),
                          f"K5-bwd bf16 {k}: dx is 0 exactly where the plain version's is")
                    dx2 = seg._launch_bwd(x, g, gamma, stats, t, act, key, path)[0]
                    check(torch.equal(dx, dx2), f"K5-bwd bf16 {k}: a second launch is bit-equal")
                    del dx, dx2
        xk = x.clone().requires_grad_()
        build.reset_launches()
        y, _, _ = seg.dropout_bn_act(xk, gamma, beta, rate=0.2, act="elu", **key._asdict())
        y.backward(g)
        check(build.LAUNCHES["segment[bf16]"] == 1 and build.LAUNCHES["segment_bwd[bf16]"] == 1
              and build.LAUNCHES["segment"] == 0 and build.LAUNCHES["segment_bwd"] == 0
              and y.dtype == xk.grad.dtype == bf,
              f"{list(shape)}: the autograd.Function takes bf16 as it is: segment[bf16] and "
              f"segment_bwd[bf16] once each, bf16 y and dx")
        # the dropout kernel: bit-equal to the plain version (fp32 math, rounded)
        bytes_ = dropout_bytes(shape, seed, dev)
        for rate in (0.1, 0.2, 0.5):
            t = bits8_keep_threshold(rate)
            plain = bits8_dropout_f32(x.float(), bytes_, t).to(bf)
            y = seg._launch_dropout(x, t, key)
            err["dropout"] = max(err["dropout"], (y.float() - plain.float()).abs().max().item())
            check(y.dtype == bf and torch.equal(y, plain)
                  and torch.equal(seg._launch_dropout(x, t, key), y),
                  f"dropout bf16 {list(shape)} rate {rate}: bit-equal to the plain version, "
                  f"and a relaunch")
        xr = x.clone().requires_grad_()
        build.reset_launches()
        seg.dropout_bits8(xr, 0.2, *key).backward(g)
        t = bits8_keep_threshold(0.2)
        check(build.LAUNCHES["dropout[bf16]"] == 2 and build.LAUNCHES["dropout"] == 0
              and torch.equal(xr.grad, bits8_dropout_f32(g.float(), bytes_, t).to(bf)),
              f"dropout bf16 {list(shape)}: dropout_bits8 launches dropout[bf16] forward and "
              f"backward")
        build.reset_launches()
        del x, g, xk, xr, y
    torch.cuda.empty_cache()

    # K3 on a bf16 map, fp32 x, at every MIX_SHAPES entry (celeba64's
    # training and evaluation batches among them) and the bf16 IW-LL's
    # batch; K3-bwd, both plans, at the training batch, the one backward
    # shape on the path
    for b, c, h, w, k in MIX_SHAPES + [(BF16_IW_BATCH["celeba64"], 3, 64, 64, K_MIX)]:
        q, lo = k * (1 + 3 * c), k + k * c
        shape = f"[{b},{q},{h},{w}] C={c} K={k}"
        u = torch.randint(0, 256, (b, c, h, w), generator=g_, device=dev)
        u[:, :, 0], u[:, :, -1] = 0, 255
        x_ = u.float() / 255.0
        p_ = torch.randn(b, q, h, w, generator=g_, device=dev)
        p_[:, lo:lo + 2] = -9.0 + torch.rand(b, 2, h, w, generator=g_, device=dev)
        ll = km.mix_log_prob(x_, p_.to(bf), k)
        ref = km._plain_mix_log_prob(x_, p_.to(bf), k, 256)
        e = ((ll - ref).abs() - 1e-5 * ref.abs()).max().item()
        err["mix"] = max(err["mix"], (ll - ref).abs().max().item())
        check(ll.dtype == torch.float32 and e <= 1e-4,
              f"K3 bf16 {shape}: fp32 ll within 1e-4 + 1e-5 |ll| of the plain version ({e:.2e})")
        check(torch.equal(ll, km.mix_log_prob(x_, p_.to(bf), k)),
              f"K3 bf16 {shape}: a relaunch is bit-equal")
        if (b, c, h, w, k) == MIX_SHAPES[0]:
            mb, mc, mh, mw, mk, mq, mlo, mix = b, c, h, w, k, q, lo, shape
            xm, p32, pm = x_, p_, p_.to(bf)
        del x_, p_, ll, ref
    k = mk
    gg = torch.randn(mb, mh, mw, generator=g_, device=dev)
    dp_h, dx_h = km._plain_mix_log_prob_bwd(xm, pm.float(), gg, k, 256)
    dp_h = dp_h.to(bf)
    for plan in km.PLANS:
        dpf, dxf = km.mix_log_prob_backward(xm, pm, gg, k, plan=plan)
        scale = dp_h.float().abs().max().item()
        apart["mix_bwd"] += bf16_held(dpf, dp_h, f"K3-bwd bf16 {mix} {plan}: dparams",
                                      within=1e-4 * scale)
        e = rel_max(dxf, dx_h)
        check(dxf.dtype == torch.float32 and e <= 1e-4,
              f"K3-bwd bf16 {mix} {plan}: fp32 dx within 1e-4 of its max ({e:.2e})")
        check(bool((dpf[:, mlo:mlo + 2] == 0).all()),
              f"K3-bwd bf16 {mix} {plan}: no gradient where the log-scale is below -7")
        err["mix_bwd"] = max(err["mix_bwd"], (dpf.float() - dp_h.float()).abs().max().item())
        dp2, _ = km.mix_log_prob_backward(xm, pm, gg, k, plan=plan)
        check(torch.equal(dpf, dp2), f"K3-bwd bf16 {mix} {plan}: a relaunch is bit-equal")
        del dpf, dxf, dp2
    pk = pm.clone().requires_grad_()
    build.reset_launches()
    km.mix_log_prob(xm, pk, k).backward(gg)
    check(build.LAUNCHES["mix_log_prob[bf16]"] == 1
          and build.LAUNCHES["mix_log_prob_bwd[bf16]"] == 1
          and build.LAUNCHES["mix_log_prob"] == 0 and pk.grad.dtype == bf,
          f"{mix}: the autograd.Function launches K3 and K3-bwd's bf16 instantiations once "
          f"each; bf16 dparams")
    build.reset_launches()

    # times: each bf16 instantiation in turns with its fp32 one (f, b, b, f)
    times = {}

    def timed_pair(name, k16, k32, plain, n_bytes, n_ops):
        ct = [cuda_ms(k32, 20), cuda_ms(k16, 20), cuda_ms(k16, 20), cuda_ms(k32, 20)]
        r = {"ms": (ct[1] + ct[2]) / 2, "fp32_ms": (ct[0] + ct[3]) / 2,
             "plain_ms": cuda_ms(plain, 5), "device_ms": device_ms(k16, 10),
             "fp32_device_ms": device_ms(k32, 10), "plain_device_ms": device_ms(plain, 3)}
        r["bound_ms"], r["bound_by"] = bound(n_bytes, n_ops)
        times[name] = r
        print(f"  time {name} per call: bf16 {r['ms']:.4f} ms, fp32 {r['fp32_ms']:.4f} ms, "
              f"plain bf16 {r['plain_ms']:.4f} ms; device: bf16 {fmt_ms(r['device_ms'])}, "
              f"fp32 {fmt_ms(r['fp32_device_ms'])}, plain {fmt_ms(r['plain_device_ms'])}; "
              f"bound at bf16 bytes {r['bound_ms']:.4f} ms ({r['bound_by']})  ({card})")
        return r

    t = bits8_keep_threshold(0.2)
    for shape in timed:
        c, n = shape[1], int(np.prod(shape))
        x = (torch.randn(shape, generator=g_, device=dev) * 1.5 + 0.3).to(bf)
        g = torch.randn(shape, generator=g_, device=dev).to(bf)
        x32, g32 = x.float(), g.float()
        gamma = torch.rand(c, generator=g_, device=dev) + 0.5
        beta = torch.randn(c, generator=g_, device=dev) * 0.2
        st16 = seg._launch_fwd(x, gamma, beta, t, "elu", 1e-5, key, None, None, 0.9)[1]
        st32 = seg._launch_fwd(x32, gamma, beta, t, "elu", 1e-5, key, None, None, 0.9)[1]
        mask = dropout_bytes(shape, seed, dev)
        _, mp, _, rp = segment_forward(x, gamma, beta, t, "elu", mask_bytes=mask)
        timed_pair(f"K5 {list(shape)}",
                   lambda: seg._launch_fwd(x, gamma, beta, t, "elu", 1e-5, key, None, None, 0.9),
                   lambda: seg._launch_fwd(x32, gamma, beta, t, "elu", 1e-5, key, None, None,
                                           0.9),
                   lambda: segment_forward(x, gamma, beta, t, "elu", mask_bytes=mask),
                   4 * n, OPS_SEGMENT * n)
        timed_pair(f"K5-bwd {list(shape)}",
                   lambda: seg._launch_bwd(x, g, gamma, st16, t, "elu", key),
                   lambda: seg._launch_bwd(x32, g32, gamma, st32, t, "elu", key),
                   lambda: segment_backward(x, g, gamma, beta, mp, rp, t, "elu", mask),
                   6 * n, 2 * OPS_SEGMENT * n)
        timed_pair(f"dropout {list(shape)}", lambda: seg._launch_dropout(x, t, key),
                   lambda: seg._launch_dropout(x32, t, key),
                   lambda: bits8_dropout_f32(x.float(), dropout_bytes(shape, seed, dev),
                                             t).to(bf),
                   4 * n, OPS_SEGMENT * n)
        del x, g, x32, g32
        torch.cuda.empty_cache()
    npix, q = mb * mh * mw, mq
    # per pixel: params (100 bf16) and x (3 fp32) in, ll out; the backward
    # reads g and writes dparams (bf16) too. Operations as phase 10 counts
    # them: ~40 a bin, twice that backward
    timed_pair(f"K3 {mix}", lambda: km.mix_log_prob(xm, pm, k),
               lambda: km.mix_log_prob(xm, p32, k),
               lambda: km._plain_mix_log_prob(xm, pm, k, 256),
               npix * (2 * q + 4 * mc + 4), npix * k * mc * 40)
    for plan in km.PLANS:
        timed_pair(f"K3-bwd {mix} {plan}",
                   lambda p=plan: km.mix_log_prob_backward(xm, pm, gg, k, need_dx=False, plan=p),
                   lambda p=plan: km.mix_log_prob_backward(xm, p32, gg, k, need_dx=False,
                                                           plan=p),
                   lambda: km._plain_mix_log_prob_bwd(xm, pm.float(), gg, k, 256),
                   npix * (4 * q + 4 * mc + 4), npix * k * mc * 80)
    # the default plan at cifar10-deep's head (BASELINE config 4), 32x32
    del dp_h, dx_h
    xc, pc = xm[:, :, :32, :32].contiguous(), p32[:, :, :32, :32].contiguous()
    pc16, gc = pc.to(bf), gg[:, :32, :32].contiguous()
    plan = km.bwd_plan(k, mc, mb, 32 * 32)
    timed_pair(f"K3-bwd [{mb},{mq},32,32] C={mc} K={k} {plan.name} V={plan.v}",
               lambda: km.mix_log_prob_backward(xc, pc16, gc, k, need_dx=False),
               lambda: km.mix_log_prob_backward(xc, pc, gc, k, need_dx=False),
               lambda: km._plain_mix_log_prob_bwd(xc, pc, gc, k, 256),
               mb * 1024 * (4 * q + 4 * mc + 4), mb * 1024 * k * mc * 80)
    del xc, pc, pc16, gc
    print(f"  bf16 outputs 1 ulp from the plain version's, elements over every check: "
          f"{apart}")
    build.reset_launches()
    torch.cuda.empty_cache()
    return err, times, apart


def bf16_cli_run(card, name, args, data, write, steps, expect, keep=None):
    """``lvae_tpu_torch.main --precision bf16 ...``: ``steps`` steps with
    data-dependent init, one test sweep and a checkpoint, which
    ``lvae_tpu_torch.evaluate`` scores in bf16 (its stored precision).
    ``expect(model, unfused dropout sites)`` gives {launch counter:
    launches}, held to the run's counts less the init's; every fp32
    instantiation of a bf16 kernel is held at 0. Returns the run's
    record and the checkpoint's weights (the trained model's). With
    ``keep`` (a directory), the run and its data stay there, and the
    record names the run's directory."""
    import torch

    from lvae_tpu_torch import evaluate
    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build

    out = {}
    where = contextlib.nullcontext(keep) if keep else tempfile.TemporaryDirectory()
    with where as tmp, init_counted() as init:
        data_dir = os.path.join(tmp, "data")
        write(data_dir)
        build.reset_launches()
        t0 = time.perf_counter()
        trainer = train_main.main(args + [
            "--data-dir", data_dir, "--data-dep-init", "--max-steps", str(steps),
            "--device", "cuda", "--log-interval", "20", "--test-interval", str(steps),
            "--checkpoint-interval", str(steps), "--output-dir", os.path.join(tmp, "out"),
            "--run-name", name.replace(" ", "-")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        print(f"  {name}: {steps} steps with init in {wall:.1f} s; launches {launches}  "
              f"({card})")
        model = trainer.state.model
        for counter, n in expect(model, unfused_dropouts(model)).items():
            got = launches.get(counter, 0) - init.get(counter, 0)
            check(n > 0 and got == n, f"{name}: {counter} {n} in the run, the init's "
                                      f"{init.get(counter, 0)} besides ({launches.get(counter, 0)})")
        fp32_twins = [c.removesuffix("[bf16]") for c in build.LAUNCHES if c.endswith("[bf16]")]
        check(all(launches[c] == 0 for c in fp32_twins),
              f"{name}: no fp32 instantiation of a bf16 kernel ran "
              f"({ {c: launches[c] for c in fp32_twins} })")
        convs = [m for m in model.modules() if hasattr(m, "compute_dtype")]
        check(all(m.compute_dtype == torch.bfloat16 for m in convs)
              and all(p.dtype == torch.float32 for p in model.parameters()),
              f"{name}: {len(convs)} convs compute in bf16, the parameters are fp32")
        hist = trainer.logger.history
        check(all(np.isfinite(np.asarray(v, dtype=np.float64)).all()
                  for _, _, m in hist for v in m.values()),
              f"{name}: every logged metric finite ({len(hist)} lines)")
        lines = {step: m for kind, step, m in hist if kind == "train"}
        first, last = float(lines[20]["loss"]), float(lines[steps]["loss"])
        check(last < first, f"{name}: EMA loss {last:.2f} at step {steps} below {first:.2f} "
                            f"at step 20")
        tests = [m for kind, _, m in hist if kind == "test"]
        path = os.path.join(trainer.run_dir, "checkpoints", f"ckpt_{steps:08d}.pt")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        floats = [t for t in ckpt["model"].values() if t.is_floating_point()]
        floats += [v for st in ckpt["optimizer"]["state"].values() for v in st.values()]
        check(all(t.dtype == torch.float32 for t in floats),
              f"{name}: the checkpoint holds fp32 weights and Adamax state "
              f"({len(floats)} tensors)")
        with open(os.path.join(trainer.run_dir, "config.json")) as f:
            check(json.load(f)["precision"] == "bf16", f"{name}: config.json records bf16")
        build.reset_launches()
        res = evaluate.main(["--load", trainer.run_dir, "--state-dict", path,
                             "--device", "cuda"])
        e = res["elbo"]
        check(np.isfinite(e["elbo"]) and abs(e["elbo"] - tests[-1]["elbo"]) <= 1e-2,
              f"{name}: evaluate scores the checkpoint in bf16: ELBO {e['elbo']:.3f}, the "
              f"run's last test ELBO {tests[-1]['elbo']:.3f}")
        out.update(launches=launches, wall_s=wall, ema_loss=(first, last),
                   test_elbo=[float(m["elbo"]) for m in tests],
                   log_rates={s: float(m["images_per_sec"]) for s, m in lines.items()})
        if keep:
            out["run_dir"] = trainer.run_dir
    build.reset_launches()
    return out, ckpt["model"]


def one_step_vs_plain(card, name, args, data, weights, kern, plain, tol=BF16_STEP_TOL):
    """One step from ``weights`` (bf16 where ``args`` say so): the kernel
    path ``--fused kern`` against the plain path ``--fused plain`` on the
    card (deterministic algorithms on), at ``tol``: the loss, and each
    gradient against its own max (the BatchNorm-fed biases against the
    largest)."""
    import dataclasses

    import torch

    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.data.device import preprocess_batch
    from lvae_tpu_torch.models.stochastic import Noise
    from lvae_tpu_torch.train.state import loss_terms
    from lvae_tpu_torch.train.trainer import Experiment

    cfg, _ = config_from_args(args)
    order = np.random.default_rng((cfg.seed, 0)).permutation(data.train.shape[0])

    def one(fused):
        exp = Experiment(dataclasses.replace(cfg, fused=fused), torch.device("cuda"), data)
        exp.model.load_state_dict(weights)
        state = exp.init_state(data_dep_init=False)
        index = torch.from_numpy(order[:cfg.batch_size]).cuda()
        x = preprocess_batch(exp.train_data.gather(index), data.preprocess, state.seed, index,
                             0)
        loss, _ = loss_terms(exp.model, x, Noise(state.seed, index, 0), 1.0, cfg.freebits)
        loss.backward()
        return loss.item(), {k: p.grad.detach().clone() for k, p in
                             exp.model.named_parameters()}, bn_fed_biases(exp.model)

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        (lk, gk, zero), (lp, gp, _) = one(kern), one(plain)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    rel = abs(lk - lp) / abs(lp)
    # the biases that only a BatchNorm reads have a zero gradient but for
    # roundoff: against the largest gradient, as phases 9, 13 and 16 hold them
    gmax = max(g.abs().max().item() for g in gp.values())
    errs = sorted(((rel_max(gk[n], g, gmax if n in zero else 0.0), n) for n, g in gp.items()),
                  reverse=True)
    print(f"  {name}: loss {lk:.6f} vs {lp:.6f} (rel {rel:.2e}); worst gradients relative to "
          f"their max: {[(f'{e:.2e}', n) for e, n in errs[:3]]}; median "
          f"{errs[len(errs) // 2][0]:.2e}")
    check(rel <= tol["loss"], f"{name}: loss within {tol['loss']:g} relative")
    check(errs[0][0] <= tol["grad"], f"{name}: every gradient within {tol['grad']:g} of its "
                                     f"max")
    return {"loss_rel": rel, "worst_grad": errs[0][0], "median_grad": errs[len(errs) // 2][0]}


def bf16_loss_gap(card, name, args, data, weights):
    """``BF16_GAP_STEPS`` eager steps in fp32 and in bf16 from the same
    weights (a bf16 run's trained checkpoint) and batches: the mean loss
    over the last 20 steps within 2% relative, and the bf16 losses not the
    fp32 ones (the bf16 run computed in bf16)."""
    import dataclasses

    import torch

    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.train.state import train_step
    from lvae_tpu_torch.train.trainer import Experiment, index_stream

    cfg, _ = config_from_args(args)
    means, losses = {}, {}
    for precision in ("fp32", "bf16"):
        exp = Experiment(dataclasses.replace(cfg, precision=precision), torch.device("cuda"),
                         data)
        exp.model.load_state_dict(weights)
        state = exp.init_state(data_dep_init=False)
        stream = index_stream(exp.train_data, cfg.batch_size, cfg.seed, 0)
        losses[precision] = torch.stack([
            train_step(state, exp.train_data.gather(idx), idx, exp.loss_cfg)["loss"]
            for idx, _ in zip(stream, range(BF16_GAP_STEPS))])
        means[precision] = float(losses[precision][-20:].mean())
        del exp, state
        torch.cuda.empty_cache()
    gap = abs(means["bf16"] - means["fp32"]) / abs(means["fp32"])
    differ = int((losses["bf16"] != losses["fp32"]).sum())
    check(gap <= 0.02, f"{name}: mean loss over steps {BF16_GAP_STEPS - 19}-{BF16_GAP_STEPS}: "
                       f"bf16 {means['bf16']:.3f}, fp32 {means['fp32']:.3f}; gap {gap:.2e} "
                       f"relative, within 0.02")
    check(differ > 0, f"{name}: the bf16 losses are not the fp32 ones ({differ} of "
                      f"{BF16_GAP_STEPS} steps differ)")
    return {"mean_loss": means, "gap": gap, "steps_differ": differ}


def bf16_eval(card, name, config, weights, write, n_test, iw_batch, want=()):
    """Test ELBO over the test split and the k=100 IW-LL over its first
    ``iw_batch`` images, through ``lvae_tpu_torch.evaluate.main`` from the
    same weights (a bf16 run's trained checkpoint) at fp32 and at bf16;
    then the ELBO sweep's images/s at fp32, then bf16.
    Each precision's bpd and the bf16 - fp32 delta."""
    import torch

    from lvae_tpu_torch import evaluate
    from lvae_tpu_torch.kernels import build

    iw, turns, counts = {}, {"fp32": [], "bf16": []}, {}
    with tempfile.TemporaryDirectory() as run_dir:
        data_dir = os.path.join(run_dir, "data")
        write(data_dir)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(dict(config, data_dir=data_dir), f)
        path = os.path.join(run_dir, "weights.pt")
        torch.save(weights, path)
        base = ["--load", run_dir, "--state-dict", path, "--device", "cuda", "--precision"]
        for precision in ("fp32", "bf16"):
            build.reset_launches()
            iw[precision] = evaluate.main(base + [
                precision, "--ll", "--iw-samples", str(IW_SAMPLES), "--iw-max-batches", "1",
                "--test-batch-size", str(iw_batch)])
            counts[precision] = {k: v for k, v in build.LAUNCHES.items() if v}
        for precision in ("fp32", "bf16"):
            turns[precision].append(evaluate.main(base + [precision])["elbo"])
    build.reset_launches()
    bf16_kernels = [k for k in counts["bf16"] if k.endswith("[bf16]")]
    check(all(not k.endswith("[bf16]") for k in counts["fp32"])
          and all(k.removesuffix("[bf16]") not in counts["bf16"] for k in bf16_kernels),
          f"{name} eval: the bf16 run launched the bf16 instantiations ({bf16_kernels}), "
          f"the fp32 run the fp32 ones")
    check(all(k in counts["bf16"] for k in want), f"{name} eval bf16: {list(want)} ran")
    out = {}
    for precision in ("fp32", "bf16"):
        e, w = turns[precision][0], iw[precision]["iw"]
        check(e["n_images"] == n_test and w["n_images"] == iw_batch
              and np.isfinite(e["bpd"]) and np.isfinite(w["iw_bpd"]),
              f"{name} eval {precision}: finite ELBO over {n_test} images, IW-LL over "
              f"{iw_batch}")
        rate = float(np.mean([r["images_per_sec"] for r in turns[precision]]))
        out[precision] = {"bpd": e["bpd"], "elbo": e["elbo"], "iw_bpd": w["iw_bpd"],
                          "elbo_images_per_sec": rate, "iw_images_per_sec": w["images_per_sec"],
                          "launches": counts[precision]}
        print(f"  {name} eval {precision}: ELBO bpd {e['bpd']:.5f} over {n_test} images, "
              f"{rate:.1f} img/s (runs {[round(r['images_per_sec'], 1) for r in turns[precision]]}"
              f"); IW-LL (k={IW_SAMPLES}) bpd {w['iw_bpd']:.5f} over {iw_batch} images at "
              f"batch {iw_batch}, {w['images_per_sec']:.1f} img/s  ({card})")
    out["bpd_delta"] = out["bf16"]["bpd"] - out["fp32"]["bpd"]
    out["iw_bpd_delta"] = out["bf16"]["iw_bpd"] - out["fp32"]["iw_bpd"]
    print(f"  {name} eval: bpd delta bf16 - fp32: ELBO {out['bpd_delta']:+.5f}, IW-LL "
          f"{out['iw_bpd_delta']:+.5f}  ({card})")
    return out


def phase_bf16(card, per_step, timed, build_log, train_u8, test_u8, flagship_weights,
               c_train, c_test, c_data, celeba_weights, keep):
    """Phase 18: --precision bf16 on both models; celeba64's ``all`` run
    stays in the directory ``keep`` (phase 20 exports it)."""
    from lvae_tpu_torch.data.sources import make_synthetic

    t0 = time.perf_counter()
    err, times, apart = phase_bf16_kernels(card, per_step, timed, build_log)
    print(f"  phase 18a took {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"kernel_times": {k: v for k, v in times.items()}, "ulps_apart": apart}
    print("[18b] training in bf16 through lvae_tpu_torch.main", flush=True)
    fdata = flagship_dataset(train_u8, test_u8)

    def flagship_counts(model, sites):
        n = BF16_FLAGSHIP_STEPS
        return {"sample_kl_per_sample": 3 * n, "sample_kl_per_sample_bwd": 3 * n,
                "dropout[bf16]": 2 * sites * n}

    def celeba_counts(all_):
        def counts(model, sites):
            # the test hook's sweep and its reconstruction grid's forward
            n, sweep = BF16_CELEBA_STEPS, CELEBA_N_TEST // CELEBA_EVAL_B + 1
            out = {"mix_log_prob[bf16]": n + sweep, "mix_log_prob_bwd[bf16]": n,
                   "sample_kl_per_sample": 4 * n, "sample_kl_per_sample_bwd": 4 * n,
                   "dropout[bf16]": 2 * sites * n}
            if all_:
                out["segment[bf16]"] = out["segment_bwd[bf16]"] = segments_per_step(model) * n
            return out
        return counts

    runs, trained = {}, {}
    # the flagship and celeba64 all as CUDA graphs of GRAPH_K steps (the
    # replays count their launches), celeba64 auto eager
    graphed = ["--steps-per-call", str(GRAPH_K)]
    runs["flagship auto"], trained["flagship auto"] = bf16_cli_run(
        card, "flagship bf16 auto graphed",
        FLAGSHIP_ARGS + ["--precision", "bf16", "--fused", "auto"] + graphed, fdata,
        lambda d: write_mnist(d, train_u8, test_u8), BF16_FLAGSHIP_STEPS, flagship_counts)
    for fused, extra in (("auto", []), ("all", graphed)):
        runs[f"celeba64 {fused}"], trained[f"celeba64 {fused}"] = bf16_cli_run(
            card, f"celeba64 bf16 {fused}{' graphed' if extra else ''}",
            CELEBA_ARGS + ["--precision", "bf16", "--fused", fused] + extra, c_data,
            lambda d: write_celeba(d, c_train, c_test), BF16_CELEBA_STEPS,
            celeba_counts(fused == "all"), keep=keep if fused == "all" else None)
    out["runs"] = runs
    print(f"  [18c at {time.perf_counter() - t0:.1f} s of phase 18]", flush=True)
    print("[18c] one bf16 step, the kernel path vs the plain path; bf16 vs fp32 losses",
          flush=True)
    out["step"] = {
        "flagship auto": one_step_vs_plain(card, "flagship bf16 --fused auto vs none",
                                           FLAGSHIP_ARGS + ["--precision", "bf16"], fdata,
                                           flagship_weights, "auto", "none"),
        "celeba64 all": one_step_vs_plain(card, "celeba64 bf16 --fused all vs none",
                                          CELEBA_ARGS + ["--precision", "bf16"], c_data,
                                          celeba_weights, "all", "none")}
    # from the trained bf16 checkpoints: the seeded weights keep the
    # likelihood head at its normal(1e-2) init, near 0 in either precision
    out["loss_gap"] = {
        "flagship auto": bf16_loss_gap(card, "flagship auto", FLAGSHIP_ARGS, fdata,
                                       trained["flagship auto"]),
        "celeba64 all": bf16_loss_gap(card, "celeba64 all", CELEBA_ARGS + ["--fused", "all"],
                                      c_data, trained["celeba64 all"])}
    print(f"  [18d at {time.perf_counter() - t0:.1f} s of phase 18]", flush=True)
    print(f"[18d] --steps-per-call {GRAPH_K} in bf16", flush=True)
    cell_args = CELEBA_ARGS + ["--fused", "all"]
    out["graph"] = graph_cell(card, "celeba64 all bf16", cell_args + ["--precision", "bf16"],
                              c_data, celeba_weights)
    print(f"  [18e at {time.perf_counter() - t0:.1f} s of phase 18]", flush=True)
    print("[18e] evaluation in bf16 and fp32 from the same trained weights", flush=True)
    _, f_test = make_synthetic(n_train=0, n_test=N_TEST, seed=5)

    def write_flagship_test(d):
        os.makedirs(os.path.join(d, "static_mnist"))
        write_amat(os.path.join(d, "static_mnist", "binarized_mnist_test.amat"), f_test)

    out["eval"] = {
        "flagship": bf16_eval(card, "flagship", FLAGSHIP, trained["flagship auto"],
                              write_flagship_test, N_TEST, BF16_IW_BATCH["flagship"]),
        "celeba64": bf16_eval(card, "celeba64", CELEBA, trained["celeba64 all"],
                              lambda d: write_celeba(d, c_train[:1], c_test), CELEBA_N_TEST,
                              BF16_IW_BATCH["celeba64"], want=("mix_log_prob[bf16]",))}
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 18 took {out['wall_s']:.1f} s", flush=True)
    return err, times, out


# --- phase 19: cifar10-deep (BASELINE config 4) -----------------------------
CIFAR_B, CIFAR_EVAL_B = 128, 500
CIFAR_N_TRAIN, CIFAR_N_TEST = 20_000, 1_000
CIFAR_STEPS = 60                            # 19b, one test hook and checkpoint at the end
CIFAR_ZDIMS = [32] * 10
CIFAR_DOWNSAMPLE = [0, 0, 1, 0, 0, 1, 0, 0, 1, 0]
# lvae_tpu's bench_preset("cifar10-deep") (lvae_tpu/data/registry.py:117-124)
# at bench.py's widths (--n-filters 64, --blocks-per-layer 2)
CIFAR = {
    "dataset": "cifar10", "zdims": CIFAR_ZDIMS, "downsample": CIFAR_DOWNSAMPLE,
    "blocks_per_layer": 2, "n_filters": 64, "gated": True, "skip": True,
    "learn_top_prior": True, "nonlin": "elu", "dropout": 0.2, "freebits": 0.5,
    "test_batch_size": CIFAR_EVAL_B, "fused": "all", "batch_size": CIFAR_B,
    "precision": "bf16",
}
CIFAR_ARGS = [
    "--dataset", "cifar10", "--zdims", *map(str, CIFAR_ZDIMS),
    "--downsample", *map(str, CIFAR_DOWNSAMPLE), "--blocks-per-layer", "2",
    "--n-filters", "64", "--skip", "--gated", "--learn-top-prior", "--freebits", "0.5",
    "--dropout", "0.2", "--seed", "42", "--batch-size", str(CIFAR_B),
    "--test-batch-size", str(CIFAR_EVAL_B), "--precision", "bf16", "--fused", "all",
]
# the path phase 19 trains: remat, accumulation, graphed
CIFAR_RUN = ["--remat", "--grad-accum", "2", "--steps-per-call", str(GRAPH_K)]
CIFAR_IMAGE = (32, 32, 3)
CIFAR_REPS = (20, 3, 10, 2)                 # 19a's timing: time_calls' reps


def cifar_dataset(train_u8, test_u8):
    """The splits as the registry's cifar10 (32x32 RGB, dequantized, the
    mixture head)."""
    from lvae_tpu_torch.data.registry import Dataset

    return Dataset("cifar10", test_u8, (32, 32), (32, 32), 3, "dequantize",
                   "discretized_logistic_mix", train=train_u8)


def write_cifar10(data_dir, train_u8, test_u8):
    """The splits in CIFAR-10's python-pickle layout (five train batches
    and ``test_batch``: rows of 3,072 channel-major bytes) under
    ``cifar10/cifar-10-batches-py``."""
    import pickle

    d = os.path.join(data_dir, "cifar10", "cifar-10-batches-py")
    os.makedirs(d)
    parts = np.array_split(train_u8, 5)
    for name, arr in [(f"data_batch_{i + 1}", p) for i, p in enumerate(parts)] + [
            ("test_batch", test_u8)]:
        rows = np.ascontiguousarray(arr.transpose(0, 3, 1, 2)).reshape(len(arr), 3072)
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({"data": rows, "labels": [0] * len(arr)}, f)


def cifar_latents(data):
    """[(c, h, w) of each latent layer], from a forward of the model (the
    last reads the learned top prior with row stride 0)."""
    import torch

    from lvae_tpu_torch.models.stochastic import Noise

    model = seeded_model(CIFAR, data, torch.device("cuda"))
    with torch.no_grad():
        zs = model(torch.rand(2, *CIFAR_IMAGE, device="cuda"),
                   noise=Noise(0, torch.arange(2, device="cuda")))["z"]
    del model
    return [(z.shape[3], z.shape[1], z.shape[2]) for z in zs]


def remat_counts(model):
    """(fused segments, unfused bits8 dropout sites) inside the blocks that
    ``--remat`` recomputes: each runs its forward a second time in the
    backward (a gated block's last dropout feeds the gate's conv, which
    saves its input, so the recompute runs the whole branch)."""
    from lvae_tpu_torch.models.blocks import ResBlockWithResampling

    segs = sites = 0
    for m in model.modules():
        if isinstance(m, ResBlockWithResampling) and m.remat:
            segs += segments_per_step(m)
            sites += unfused_dropouts(m)
    return segs, sites


def k1_checks(b, layer, chw, top, g, n_rows, keep):
    """K1 and K1-bwd keyed, as the trainer calls them, at one latent layer
    of ``b`` rows (the top with its row-stride-0 prior) against the plain
    generator and autograd of the plain forward, at phases 6-7's
    tolerances, each relaunch bit-equal; ``keep(name, err)`` takes the
    largest errors. Returns the operands (q, p, index, gz, gkl, args)."""
    import torch

    from lvae_tpu_torch.kernels import stochastic as sk

    dev = torch.device("cuda")
    c, h, w = chw
    shape = f"[{b},{2 * c},{h},{w}]" + (" stride-0 prior" if top else "")
    q = (torch.randn(b, 2 * c, h, w, generator=g) * 0.7).to(dev)
    p1 = (torch.randn(1 if top else b, 2 * c, h, w, generator=g) * 0.7).to(dev)
    p = p1.expand(b, -1, -1, -1) if top else p1
    index = torch.randperm(n_rows, generator=g)[:b].to(dev)
    gz = torch.randn(b, c, h, w, generator=g).to(dev)
    gkl = torch.randn(b, generator=g).to(dev)
    gkl[::3] = 0.0                       # rows a free-bits clamp zeroes
    args = (index, 77, 5, layer)
    print(f"  {shape} {sk.k1_plan(b, c, h * w)}; {sk.k1_bwd_plan(b, c, h * w, top)}")
    z, kl = sk.sample_kl_per_sample(q, p, *args)
    zr, klr = sk._plain_sample_kl_per_sample(q, p, *args)
    e = (z - zr).abs().max().item()
    keep("k1", max(e, (kl - klr).abs().max().item()))
    check(e <= 1e-5 and rel_elem(kl, klr) <= 1e-5,
          f"K1 {shape}: z within 1e-5 abs ({e:.2e}), kl_b within 1e-5 relative of the "
          f"plain generator's")
    z2, kl2 = sk.sample_kl_per_sample(q, p, *args)
    check(torch.equal(z, z2) and torch.equal(kl, kl2), f"K1 {shape}: a relaunch is "
                                                      f"bit-equal")
    if top:
        zf, klf = sk.sample_kl_per_sample(q, p.contiguous(), *args)
        check(torch.equal(z, zf) and torch.equal(kl, klf),
              f"K1 {shape}: the row-stride-0 prior equals the materialised one")

    def grads(fn):
        qr, pr = q.clone().requires_grad_(), p1.clone().requires_grad_()
        zz, kk = fn(qr, pr.expand(b, -1, -1, -1) if top else pr, *args)
        torch.autograd.backward([zz, kk], [gz, gkl])
        return qr.grad, pr.grad

    a, r = grads(sk.sample_kl_per_sample), grads(sk._plain_sample_kl_per_sample)
    e = max(rel_max(a[0], r[0]), rel_max(a[1], r[1]))
    keep("k1_bwd", max((a[0] - r[0]).abs().max().item(), (a[1] - r[1]).abs().max().item()))
    check(e <= 1e-5, f"K1-bwd {shape} keyed: dq, dp within 1e-5 of their max of autograd "
                     f"of the plain forward ({e:.2e})")
    a2 = grads(sk.sample_kl_per_sample)
    check(torch.equal(a[0], a2[0]) and torch.equal(a[1], a2[1]),
          f"K1-bwd {shape}: a relaunch is bit-equal")
    return q, p, index, gz, gkl, args


def mix_checks(x, pp, k, shape, keep, gg=None):
    """K3 on ``pp`` (fp32 or bf16 params) against its plain version
    (1e-4 + 1e-5 |ll|) and, given ``gg``, K3-bwd against the plain hand
    backward (1e-4 of their max; bf16 dparams within 1 bf16 ulp, or 1e-4
    of the max), each relaunch bit-equal; ``keep(name, err)`` takes the
    largest errors."""
    import torch

    from lvae_tpu_torch.kernels import mixture as km

    label = "bf16" if pp.dtype == torch.bfloat16 else "fp32"
    ll = km.mix_log_prob(x, pp, k)
    ref = km._plain_mix_log_prob(x, pp, k, 256)
    e = ((ll - ref).abs() - 1e-5 * ref.abs()).max().item()
    keep("mix", (ll - ref).abs().max().item())
    check(ll.dtype == torch.float32 and e <= 1e-4,
          f"K3 {label} {shape}: ll within 1e-4 + 1e-5 |ll| of the plain version ({e:.2e})")
    check(torch.equal(ll, km.mix_log_prob(x, pp, k)), f"K3 {label} {shape}: a relaunch "
                                                       f"is bit-equal")
    if gg is None:
        return
    dp_h, dx_h = km._plain_mix_log_prob_bwd(x, pp.float(), gg, k, 256)
    dp, dx = km.mix_log_prob_backward(x, pp, gg, k)
    if label == "bf16":
        bf16_held(dp, dp_h.to(pp.dtype), f"K3-bwd bf16 {shape}: dparams",
                  within=1e-4 * dp_h.abs().max().item())
        e = rel_max(dx, dx_h)
    else:
        e = max(rel_max(dp, dp_h), rel_max(dx, dx_h))
    keep("mix_bwd", (dp.float() - dp_h).abs().max().item())
    check(e <= 1e-4, f"K3-bwd {label} {shape}: within 1e-4 of their max of the plain "
                     f"hand backward ({e:.2e})")
    dp2, dx2 = km.mix_log_prob_backward(x, pp, gg, k)
    check(torch.equal(dp, dp2) and torch.equal(dx, dx2),
          f"K3-bwd {label} {shape}: a relaunch is bit-equal")


def mix_operands(b, h, w, k, g):
    """(x, params, gg) of a C = 3 mixture head at [b, k (1 + 3 C), h, w]:
    exact 0 and 1 pixels in the first and last rows (the edge bins), two
    log-scale channels below -7."""
    import torch

    dev, c = torch.device("cuda"), 3
    qch, lo = k * (1 + 3 * c), k + k * c
    u = torch.randint(0, 256, (b, c, h, w), generator=g, device=dev)
    u[:, :, 0], u[:, :, -1] = 0, 255
    p = torch.randn(b, qch, h, w, generator=g, device=dev)
    p[:, lo:lo + 2] = -9.0 + torch.rand(b, 2, h, w, generator=g, device=dev)
    return u.float() / 255.0, p, torch.randn(b, h, w, generator=g, device=dev)


def cifar_kernels(card, latents, seg_counts):
    """19a: every kernel of the path at cifar10-deep's shapes against its
    plain version, at phases 6-7, 10, 14 and 18a's tolerances, with a
    bit-equal relaunch: K1 and K1-bwd keyed at the ten latent layers (the
    top with its stride-0 prior) at B = 128; K3 (fp32, bf16) at the
    training and evaluation batches, K3-bwd (fp32, bf16) at the training
    batch; K5, K5-bwd and the dropout kernel (fp32, bf16) at every segment
    shape, and K5 without running buffers, which leaves them as they are.
    Each timed per training step of the model (device and per call)."""
    import torch

    from lvae_tpu_torch.kernels import mixture as km
    from lvae_tpu_torch.kernels import segment as seg
    from lvae_tpu_torch.kernels import stochastic as sk
    from lvae_tpu_torch.ops.math import (
        bits8_dropout_f32,
        bits8_keep_threshold,
        segment_backward,
        segment_forward,
    )
    from lvae_tpu_torch.ops.philox import dropout_bytes, mix_seed

    print("[19a] cifar10-deep: the path's kernels vs their plain versions at its shapes",
          flush=True)
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(19)
    gd = torch.Generator(device=dev).manual_seed(19)
    err, times = {}, {}

    def keep(name, v):
        err[name] = max(err.get(name, 0.0), v)

    # K1, K1-bwd: the ten layers, keyed as the trainer calls them
    b, layers = CIFAR_B, []
    for layer, (c, h, w) in enumerate(latents):
        top = layer == len(latents) - 1
        q, p, index, gz, gkl, args = k1_checks(b, layer, (c, h, w), top, g, CIFAR_N_TRAIN,
                                               keep)
        n = b * c * h * w
        keyed = sk.Keyed(index, 77, 5, layer)
        layers.append(dict(
            fwd=lambda q=q, p=p, args=args: sk.sample_kl_per_sample(q, p, *args),
            fwd_plain=lambda q=q, p=p, args=args: sk._plain_sample_kl_per_sample(q, p, *args),
            bwd=lambda q=q, p=p, gz=gz, gkl=gkl, k=keyed: sk.sample_kl_backward(
                q, p, gz, gkl, keyed=k),
            bwd_plain=lambda q=q, p=p, gz=gz, gkl=gkl, k=keyed: sk._plain_sample_kl_bwd(
                q, p, sk._eps_of(k, q), gz, gkl),
            fwd_bytes=n * 12 + (1 if top else b) * c * h * w * 8 + b * 12,
            bwd_bytes=n * 20 + (1 if top else b) * c * h * w * 16 + b * 12,
            n=n))
    for name, kern, plain, ops in (("K1", "fwd", "fwd_plain", OPS_SAMPLE_KL),
                                   ("K1-bwd", "bwd", "bwd_plain",
                                    OPS_SAMPLE_KL_BWD + OPS_SAMPLE_KL)):
        fns = {"kernel": lambda kern=kern: [ly[kern]() for ly in layers],
               "plain": lambda plain=plain: [ly[plain]() for ly in layers]}
        per_call, device = time_calls(fns, CIFAR_REPS)
        times[name] = timing_row(per_call, device, bound(
            sum(ly[f"{kern}_bytes"] for ly in layers), sum(ly["n"] for ly in layers) * ops))
        print_times(name, f"cifar10-deep, {len(layers)} layers at B={b} (one step's calls)",
                    times[name], card)
    del layers
    # K2 at the evaluation batch: the ten layers of one eval forward
    b, layers, n_bytes, n_elem = CIFAR_EVAL_B, [], 0, 0
    for layer, (c, h, w) in enumerate(latents):
        top = layer == len(latents) - 1
        shape = f"[{b},{2 * c},{h},{w}]" + (" stride-0 prior" if top else "")
        q = (torch.randn(b, 2 * c, h, w, generator=g) * 0.7).to(dev)
        p1 = (torch.randn(1 if top else b, 2 * c, h, w, generator=g) * 0.7).to(dev)
        p = p1.expand(b, -1, -1, -1) if top else p1
        index = torch.randperm(CIFAR_N_TEST, generator=g)[:b].to(dev)
        args = (index, 1234, 3, layer)
        z, kl = sk.sample_kl(q, p, *args)
        zr, klr = sk._plain_sample_kl(q, p, *args)
        e = max((z - zr).abs().max().item(), (kl - klr).abs().max().item())
        keep("k2", e)
        check(e <= 1e-5, f"K2 {shape}: z, kl within 1e-5 of the plain generator's ({e:.2e})")
        z2, kl2 = sk.sample_kl(q, p, *args)
        zf, klf = sk.sample_kl(q, p.contiguous(), *args)
        check(torch.equal(z, z2) and torch.equal(kl, kl2) and torch.equal(z, zf)
              and torch.equal(kl, klf), f"K2 {shape}: a relaunch, and the materialised "
                                        f"prior, bit-equal")
        layers.append((lambda q=q, p=p, args=args: sk.sample_kl(q, p, *args),
                       lambda q=q, p=p, args=args: sk._plain_sample_kl(q, p, *args)))
        n_bytes += b * c * h * w * 24 + b * 8
        n_elem += b * c * h * w
    per_call, device = time_calls({"kernel": lambda: [f() for f, _ in layers],
                                   "plain": lambda: [f() for _, f in layers]}, CIFAR_REPS)
    times["K2"] = timing_row(per_call, device, bound(n_bytes, n_elem * OPS_SAMPLE_KL))
    print_times("K2", f"cifar10-deep, {len(layers)} layers at B={b} (one eval forward's calls)",
                times["K2"], card)
    del layers
    torch.cuda.empty_cache()

    # K3, K3-bwd at [B, 100, 32, 32], C = 3, K = 10; fp32 and bf16 params
    k, c = K_MIX, 3
    qch = k * (1 + 3 * c)
    for bb in (CIFAR_B, CIFAR_EVAL_B):
        x, p, gg = mix_operands(bb, 32, 32, k, gd)
        shape = f"[{bb},{qch},32,32] C={c} K={k}"
        for dt, label in ((torch.float32, "fp32"), (bf, "bf16")):
            pp = p.to(dt)
            mix_checks(x, pp, k, shape, keep, gg if bb == CIFAR_B else None)
            bnd = bound(bb * 32 * 32 * (qch * pp.element_size() + 3 * 4 + 4))
            per_call, device = time_calls({"kernel": lambda: km.mix_log_prob(x, pp, k),
                                           "plain": lambda: km._plain_mix_log_prob(x, pp, k,
                                                                                   256)},
                                          CIFAR_REPS)
            times[f"K3 {label} B={bb}"] = timing_row(per_call, device, bnd)
            print_times(f"K3 {label}", shape, times[f"K3 {label} B={bb}"], card)
            if bb != CIFAR_B:
                continue
            bnd = bound(bb * 32 * 32 * (2 * qch * pp.element_size() + 2 * 3 * 4 + 4))
            per_call, device = time_calls(
                {"kernel": lambda: km.mix_log_prob_backward(x, pp, gg, k),
                 "plain": lambda: km._plain_mix_log_prob_bwd(x, pp.float(), gg, k, 256)},
                CIFAR_REPS)
            times[f"K3-bwd {label}"] = timing_row(per_call, device, bnd)
            print_times(f"K3-bwd {label}", shape, times[f"K3-bwd {label}"], card)
        del x, p, gg
    torch.cuda.empty_cache()

    # K5, K5-bwd, the dropout kernel at every segment shape, rate 0 and 0.2
    # (the model's ba and dba segments), elu, fp32 and bf16 storage
    key = seg.Key(42, torch.tensor(7, dtype=torch.int64, device=dev), 3)
    seed = mix_seed(42, 7, 3)
    calls = {f"{n} {lab}": [] for n in ("K5", "K5-bwd", "dropout") for lab in ("fp32", "bf16")}
    for shape, per_step in seg_counts.items():
        cc = shape[1]
        x32 = torch.randn(shape, generator=gd, device=dev) * 1.5 + 0.3
        g32 = torch.randn(shape, generator=gd, device=dev)
        gamma = torch.rand(cc, generator=gd, device=dev) + 0.5
        beta = torch.randn(cc, generator=gd, device=dev) * 0.2
        for dt, label in ((torch.float32, "fp32"), (bf, "bf16")):
            x, gr = x32.to(dt), g32.to(dt)
            for rate in (0.0, 0.2):
                t = bits8_keep_threshold(rate)
                kk = key if t < 256 else None
                bytes_ = dropout_bytes(shape, seed, dev) if t < 256 else None
                what = f"{label} {list(shape)} rate {rate} elu"
                rm_p, rv_p = torch.full((cc,), 0.3, device=dev), torch.full((cc,), 1.7, device=dev)
                yp, mp, vp, rp = segment_forward(x, gamma, beta, t, "elu", mask_bytes=bytes_,
                                                 running_mean=rm_p, running_var=rv_p)
                dxp, dgp, dbp = segment_backward(x, gr, gamma, beta, mp, rp, t, "elu", bytes_)
                rm = torch.full((cc,), 0.3, device=dev)
                rv = torch.full((cc,), 1.7, device=dev)
                y, stats = seg._launch_fwd(x, gamma, beta, t, "elu", 1e-5, kk, rm, rv, 0.9)
                if dt == bf:
                    bf16_held(y, yp, f"K5 {what}: y")
                else:
                    e = rel_max(y, yp)
                    check(e <= 1e-5, f"K5 {what}: y within 1e-5 of max|y| ({e:.2e})")
                keep("segment", (y.float() - yp.float()).abs().max().item())
                e = max(rel_elem(stats[0], mp), rel_elem(stats[1], vp), rel_elem(rm, rm_p),
                        rel_elem(rv, rv_p))
                check(e <= 1e-6, f"K5 {what}: mean, var and the running stats within 1e-6 "
                                 f"relative ({e:.2e})")
                rm0, rv0 = rm.clone(), rv.clone()
                y2, stats2 = seg._launch_fwd(x, gamma, beta, t, "elu", 1e-5, kk, None, None, 0.9)
                check(torch.equal(y, y2) and torch.equal(stats, stats2)
                      and torch.equal(rm, rm0) and torch.equal(rv, rv0),
                      f"K5 {what}: a relaunch without running buffers (a --remat recompute's) "
                      f"is bit-equal and leaves the buffers as they were")
                dx, dgamma, dbeta = seg._launch_bwd(x, gr, gamma, stats, t, "elu", kk)
                if dt == bf:
                    bf16_held(dx, dxp, f"K5-bwd {what}: dx")
                    e = max(rel_max(dgamma, dgp), rel_max(dbeta, dbp))
                else:
                    e = max(rel_max(a, r) for a, r in zip((dx, dgamma, dbeta), (dxp, dgp, dbp)))
                keep("segment_bwd", (dx.float() - dxp.float()).abs().max().item())
                check(e <= 1e-5, f"K5-bwd {what}: within 1e-5 of their max of the plain hand "
                                 f"backward ({e:.2e})")
                dx2 = seg._launch_bwd(x, gr, gamma, stats, t, "elu", kk)[0]
                check(torch.equal(dx, dx2), f"K5-bwd {what}: a relaunch is bit-equal")
                if rate:
                    plain = bits8_dropout_f32(x.float(), bytes_, t).to(dt)
                    yd = seg._launch_dropout(x, t, key)
                    check(torch.equal(yd, plain) and torch.equal(seg._launch_dropout(x, t, key),
                                                                 yd),
                          f"dropout {what}: bit-equal to the plain version, and a relaunch")
                    keep("dropout", (yd.float() - plain.float()).abs().max().item())
                # a residual block's two segments, "ba" (rate 0) and "dba"
                # (0.2), and its one unfused dropout
                for _ in range(per_step // 2):
                    calls[f"K5 {label}"].append(
                        lambda x=x, t=t, kk=kk: seg._launch_fwd(
                            x, gamma, beta, t, "elu", 1e-5, kk, None, None, 0.9))
                    calls[f"K5-bwd {label}"].append(
                        lambda x=x, gr=gr, stats=stats, t=t, kk=kk: seg._launch_bwd(
                            x, gr, gamma, stats, t, "elu", kk))
                    if rate:
                        calls[f"dropout {label}"].append(
                            lambda x=x, t=t: seg._launch_dropout(x, t, key))
    # a step's segments and unfused dropouts, each kernel's calls in one go
    n_seg = sum(int(np.prod(s)) * v for s, v in seg_counts.items())
    for name, fns in calls.items():
        es = 2 if name.endswith("bf16") else 4
        kind = name.split()[0]
        n_elem = n_seg // 2 if kind == "dropout" else n_seg
        n_bytes = {"K5": 2 * es, "K5-bwd": 3 * es, "dropout": 2 * es}[kind] * n_elem
        t0 = cuda_ms(lambda fns=fns: [f() for f in fns], 10)
        dev_ms = device_ms(lambda fns=fns: [f() for f in fns], 3)
        times[name] = {"ms": t0, "plain_ms": None, "device_ms": dev_ms, "plain_device_ms": None}
        times[name]["bound_ms"], times[name]["bound_by"] = bound(n_bytes, OPS_SEGMENT * n_elem)
        print(f"  time {name}, cifar10-deep's {len(fns)} calls of a step: per step "
              f"{t0:.4f} ms, device {fmt_ms(dev_ms)}; bound {times[name]['bound_ms']:.4f} ms  "
              f"({card})")
    del calls
    torch.cuda.empty_cache()
    return err, times


def cifar_counts(model, steps, sweeps):
    """{launch counter: launches} of ``steps`` training steps of ``model``
    (bf16, --fused all, --remat) and ``sweeps`` eval forwards: K1 and K1-bwd
    per layer; K5 for every segment plus every segment of a rematerialised
    block again (the recompute), K5-bwd for every segment; the dropout
    kernel forward and backward at every unfused site, and forward again
    at each one inside a rematerialised block; K3-bwd once a step, K3 once
    a step and once an eval forward; K2 per layer of each eval forward."""
    segs, sites = segments_per_step(model), unfused_dropouts(model)
    r_segs, r_sites = remat_counts(model)
    layers = model.n_layers
    return {"sample_kl_per_sample": layers * steps, "sample_kl_per_sample_bwd": layers * steps,
            "segment[bf16]": (segs + r_segs) * steps, "segment_bwd[bf16]": segs * steps,
            "dropout[bf16]": (2 * sites + r_sites) * steps,
            "mix_log_prob[bf16]": steps + sweeps, "mix_log_prob_bwd[bf16]": steps,
            "sample_kl": layers * sweeps}


def grid_size(n, h, w, ncol=None):
    """make_grid's pixel size (H', W') of ``n`` tiles of h x w, pad 2."""
    import math

    ncol = ncol or int(math.ceil(math.sqrt(n)))
    return int(math.ceil(n / ncol)) * (h + 2) + 2, ncol * (w + 2) + 2


def cifar_train(card, data, train_u8, test_u8, tmp):
    """19b: cifar10-deep through ``lvae_tpu_torch.main`` at full width,
    bf16, ``--fused all --remat --grad-accum 2 --steps-per-call 10`` with
    data-dependent init: CIFAR_STEPS steps, the test hook (ELBO sweep and
    the three grids) and a checkpoint at the end; every kernel's launch
    count, the remat recompute's among them."""
    import torch
    from PIL import Image

    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build

    print("[19b] cifar10-deep training through lvae_tpu_torch.main --precision bf16 "
          "--fused all --remat --grad-accum 2 --steps-per-call 10", flush=True)
    args = CIFAR_ARGS + CIFAR_RUN
    data_dir = os.path.join(tmp, "data")
    write_cifar10(data_dir, train_u8, test_u8)
    build.reset_launches()
    t0 = time.perf_counter()
    with init_counted() as init:
        trainer = train_main.main(args + [
            "--data-dir", data_dir, "--data-dep-init", "--max-steps", str(CIFAR_STEPS),
            "--device", "cuda", "--log-interval", "20", "--test-interval", str(CIFAR_STEPS),
            "--checkpoint-interval", str(CIFAR_STEPS), "--output-dir",
            os.path.join(tmp, "out"), "--run-name", "cifar10-deep"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    build.reset_launches()
    model = trainer.state.model
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {CIFAR_STEPS} steps with init, a test sweep and the grids in {wall:.1f} s; "
          f"{n_params:,} parameters; launches {launches}; the init's {init}  ({card})")
    # the test hook's sweep (CIFAR_N_TEST / CIFAR_EVAL_B batches) and its
    # reconstruction forward
    sweeps = -(-CIFAR_N_TEST // CIFAR_EVAL_B) + 1
    want = cifar_counts(model, CIFAR_STEPS, sweeps)
    r_segs, r_sites = remat_counts(model)
    print(f"  per step: {segments_per_step(model)} segments ({r_segs} inside the "
          f"rematerialised blocks), {unfused_dropouts(model)} unfused dropout sites "
          f"({r_sites} inside them)")
    for counter, n in want.items():
        got = launches.get(counter, 0) - init.get(counter, 0)
        check(n > 0 and got == n, f"cifar10-deep: {counter} {n} in the run, the init's "
                                  f"{init.get(counter, 0)} besides ({launches.get(counter, 0)})")
    fp32_twins = [c.removesuffix("[bf16]") for c in want if c.endswith("[bf16]")]
    check(all(launches.get(c, 0) == 0 for c in fp32_twins + ["sample_kl_bwd"]),
          f"cifar10-deep: no fp32 instantiation of a bf16 kernel and no K2-bwd ran")
    hist = trainer.logger.history
    check(all(np.isfinite(np.asarray(v, dtype=np.float64)).all()
              for _, _, m in hist for v in m.values()),
          f"cifar10-deep: every logged metric finite ({len(hist)} lines)")
    lines = {s: m for kind, s, m in hist if kind == "train"}
    first, last = float(lines[20]["loss"]), float(lines[CIFAR_STEPS]["loss"])
    check(last < first, f"cifar10-deep: EMA loss {last:.1f} at step {CIFAR_STEPS} below "
                        f"{first:.1f} at step 20")
    acc = trainer.state.accum
    check(acc is not None and acc.k == 2 and int(acc.mini_step) == 0,
          "cifar10-deep: the accumulation ends on an update (micro-step 0 of 2)")
    tests = [m for kind, _, m in hist if kind == "test"]
    imgs = os.path.join(trainer.run_dir, "imgs")
    h, w, _ = CIFAR_IMAGE
    sizes = {f"sample_{CIFAR_STEPS}.png": (*grid_size(64, h, w), 3),
             f"recon_{CIFAR_STEPS}.png": (*grid_size(64, h, w, 8), 3),
             f"kl_spatial_{CIFAR_STEPS}.png": grid_size(10, 16, 16, 10)}
    for name, size in sizes.items():
        path = os.path.join(imgs, name)
        got = np.asarray(Image.open(path)).shape if os.path.exists(path) else None
        check(got == size, f"cifar10-deep: the test hook wrote {name} at {size} ({got})")
    ckpt = os.path.join(trainer.run_dir, "checkpoints", f"ckpt_{CIFAR_STEPS:08d}.pt")
    check(os.path.exists(ckpt), f"cifar10-deep: the run saved {os.path.basename(ckpt)}")
    rates = {s: float(m["images_per_sec"]) for s, m in lines.items()}
    out = {"launches": launches, "init_launches": init, "wall_s": wall, "log_rates": rates,
           "ema_loss": (first, last), "test_elbo": [float(m["elbo"]) for m in tests],
           "parameters": n_params, "run_dir": trainer.run_dir,
           "weights": {k_: v.detach().clone() for k_, v in model.state_dict().items()}}
    del trainer, model
    torch.cuda.empty_cache()
    return out


def cifar_step(card, data, weights):
    """19c: one bf16 step with --remat against the same step without it
    (deterministic algorithms on, as phases 9, 13 and 17): the loss, every
    gradient, every running buffer and the parameters after Adamax, bit for
    bit; ten graphed --grad-accum 2 steps (the replay of a graph captured
    from step 11, inside an accumulation) bit-equal to eager ones; the peak
    memory of a step with and without --remat."""
    import dataclasses

    import torch

    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.data.device import preprocess_batch
    from lvae_tpu_torch.models.stochastic import Noise
    from lvae_tpu_torch.train.state import MultiStep, loss_terms, train_step
    from lvae_tpu_torch.train.trainer import Experiment, index_stream

    print("[19c] cifar10-deep: a --remat step vs a plain one; graphed --grad-accum 2 vs "
          "eager; memory and ms/step", flush=True)
    cfg, _ = config_from_args(CIFAR_ARGS + CIFAR_RUN)
    order = np.random.default_rng((cfg.seed, 0)).permutation(data.train.shape[0])
    out = {}

    def setup(**over):
        exp = Experiment(dataclasses.replace(cfg, **over), torch.device("cuda"), data)
        exp.model.load_state_dict(weights)
        return exp, exp.init_state(data_dep_init=False)

    def one(remat):
        exp, state = setup(remat=remat, grad_accum=1)
        index = torch.from_numpy(order[:cfg.batch_size]).cuda()
        x = preprocess_batch(exp.train_data.gather(index), data.preprocess, state.seed, index,
                             0)
        loss, _ = loss_terms(exp.model, x, Noise(state.seed, index, 0), 1.0, cfg.freebits)
        loss.backward()
        grads = {k: p.grad.detach().clone() for k, p in exp.model.named_parameters()}
        state.optimizer.step()
        after = {k: v.detach().clone() for k, v in exp.model.state_dict().items()}
        del exp, state
        return loss.item(), grads, after

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        (lp, gp, sp), (lr, gr, sr) = one(False), one(True)
        bad = [k for k in gp if not torch.equal(gp[k], gr[k])]
        bad += [k for k in sp if not torch.equal(sp[k], sr[k])]
        moved = sum(1 for k in sp if "running" in k and not torch.equal(sp[k], weights[k]))
        print(f"  one bf16 step: loss {lp:.6f} plain, {lr:.6f} remat; {len(gp)} gradients, "
              f"{len(sp)} state tensors ({moved} running buffers moved); differ: {bad[:5]}")
        check(lp == lr and not bad and moved > 0,
              "a --remat step is bit-equal to a plain one: loss, every gradient, every "
              "running buffer (moved once), the parameters after Adamax")
        out["remat_step_bit_equal"] = True
        del gp, sp, gr, sr

        # ten graphed steps inside accumulations: one eager step, then two
        # calls of k = 10 (the warm-up and capture, then a replay) against
        # 21 eager steps
        k = GRAPH_K
        exp, eager = setup()
        stream = index_stream(exp.train_data, cfg.batch_size, cfg.seed, 0, 1)
        rows = [next(stream) for _ in range(2 * k + 1)]
        for row in rows:
            train_step(eager, exp.train_data.gather(row), row, exp.loss_cfg)
        _, graphed = setup()
        train_step(graphed, exp.train_data.gather(rows[0]), rows[0], exp.loss_cfg)
        multi = MultiStep(graphed, exp.train_data.gather, exp.loss_cfg, k)
        multi(torch.stack(rows[1:k + 1]))
        multi(torch.stack(rows[k + 1:]))
        torch.cuda.synchronize()
        bad = state_equal(graphed, eager)
        bad += [f"accum.{i}" for i, (a, b_) in enumerate(zip(graphed.accum.acc, eager.accum.acc))
                if not torch.equal(a, b_)]
        if not torch.equal(graphed.accum.mini_step, eager.accum.mini_step):
            bad.append("mini_step")
        check(not bad and int(eager.accum.mini_step) == 1,
              f"--grad-accum 2 --remat: steps 12-21 replayed from a graph captured inside an "
              f"accumulation bit-equal to eager steps: parameters, BatchNorm statistics, EMA, "
              f"Adamax, the accumulator, its micro-step (differ: {bad[:5]})")
        out["graph_accum_bit_equal"] = True
        del exp, eager, graphed, multi, rows, stream
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    # peak memory of an eager step (after a first one), each variant alone
    peaks = {}
    for label, remat in (("plain", False), ("remat", True)):
        exp, state = setup(remat=remat)
        stream = index_stream(exp.train_data, cfg.batch_size, cfg.seed, 0, 1)
        row = next(stream)
        train_step(state, exp.train_data.gather(row), row, exp.loss_cfg)
        torch.cuda.synchronize()
        rest = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        row = next(stream)
        train_step(state, exp.train_data.gather(row), row, exp.loss_cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        peaks[label] = {"peak_bytes": peak, "resting_bytes": rest, "step_bytes": peak - rest}
        print(f"  peak memory of a bf16 step at batch {cfg.batch_size}, {label}: "
              f"{peak / 2 ** 20:.1f} MiB ({(peak - rest) / 2 ** 20:.1f} MiB above the "
              f"{rest / 2 ** 20:.1f} MiB resting)  ({card})")
        del exp, state, stream
        torch.cuda.empty_cache()
    check(peaks["remat"]["step_bytes"] < peaks["plain"]["step_bytes"],
          f"--remat lowers a step's peak above the resting memory "
          f"({peaks['remat']['step_bytes'] / 2 ** 20:.1f} MiB against "
          f"{peaks['plain']['step_bytes'] / 2 ** 20:.1f})")
    out["memory"] = peaks
    return out


def cifar_eval(card, run_dir):
    """19d: ``lvae_tpu_torch.evaluate --load <run name>`` from the run's own
    checkpoint (no --state-dict): test ELBO over the 1,000 test images, the
    k=100 IW-LL over the first batch, the grids and a diagnostics grid; K2,
    K3 and K4 launched."""
    from PIL import Image

    from lvae_tpu_torch import evaluate
    from lvae_tpu_torch.kernels import build

    print("[19d] cifar10-deep through lvae_tpu_torch.evaluate --load <run name>", flush=True)
    build.reset_launches()
    t0 = time.perf_counter()
    res = evaluate.main(["--load", os.path.basename(run_dir), "--output-dir",
                         os.path.dirname(run_dir), "--device", "cuda", "--ll", "--iw-samples",
                         str(IW_SAMPLES), "--iw-max-batches", "1", "--nimages", "64",
                         "--mode-layers", "0", "1", "--temperature", "0.7"])
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    build.reset_launches()
    e, iw = res["elbo"], res["iw"]
    print(f"  evaluate: ELBO bpd {e['bpd']:.5f} over {e['n_images']} images "
          f"({e['images_per_sec']:.1f} img/s), IW-LL (k={IW_SAMPLES}) bpd {iw['iw_bpd']:.5f} "
          f"over {iw['n_images']} ({iw['images_per_sec']:.1f} img/s); {wall:.1f} s in all; "
          f"launches {launches}  ({card})")
    check(res["step"] == CIFAR_STEPS and e["n_images"] == CIFAR_N_TEST
          and iw["n_images"] == CIFAR_EVAL_B and np.isfinite(e["bpd"])
          and np.isfinite(iw["iw_bpd"]),
          f"evaluate --load scores step {CIFAR_STEPS}'s checkpoint: finite ELBO over "
          f"{CIFAR_N_TEST} images, IW-LL over {CIFAR_EVAL_B}")
    check(all(launches.get(k, 0) > 0 for k in ("sample_kl", "mix_log_prob[bf16]", "logsumexp")),
          "evaluate launched K2, K3 (bf16, the run's precision) and K4")
    diag = os.path.join(run_dir, "imgs", f"diag_mode0-1_T0.7_{CIFAR_STEPS}.png")
    check(os.path.exists(diag) and np.asarray(Image.open(diag)).shape
          == (*grid_size(64, 32, 32), 3), f"evaluate wrote {os.path.basename(diag)}")
    return {"bpd": e["bpd"], "iw_bpd": iw["iw_bpd"], "elbo_images_per_sec": e["images_per_sec"],
            "iw_images_per_sec": iw["images_per_sec"], "wall_s": wall, "launches": launches}


def phase_cifar(card):
    """Phase 19: cifar10-deep (BASELINE config 4) at full width."""
    import torch

    t0 = time.perf_counter()
    all_u8 = rgb_blobs(CIFAR_N_TRAIN + CIFAR_N_TEST, seed=19, img=32)
    train_u8, test_u8 = all_u8[:CIFAR_N_TRAIN], all_u8[CIFAR_N_TRAIN:]
    data = cifar_dataset(train_u8, test_u8)
    latents = cifar_latents(data)
    seg_counts = segment_shapes(CIFAR, data, CIFAR_B, CIFAR_IMAGE)
    print(f"  cifar10-deep's latent layers (c, h, w): {latents}; segments per step by shape: "
          f"{ {str(list(k)): v for k, v in seg_counts.items()} }", flush=True)
    err, times = cifar_kernels(card, latents, seg_counts)
    print(f"  phase 19a took {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"latents": latents, "kernel_times": times,
           "segments": {str(list(k)): v for k, v in seg_counts.items()}}
    with tempfile.TemporaryDirectory() as tmp:
        tr = cifar_train(card, data, train_u8, test_u8, tmp)
        out["train"] = {k: v for k, v in tr.items() if k not in ("weights", "run_dir")}
        print(f"  [19c at {time.perf_counter() - t0:.1f} s of phase 19]", flush=True)
        out["step"] = cifar_step(card, data, tr["weights"])
        print(f"  [19d at {time.perf_counter() - t0:.1f} s of phase 19]", flush=True)
        out["eval"] = cifar_eval(card, tr["run_dir"])
    out["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"  phase 19 took {out['wall_s']:.1f} s", flush=True)
    return err, out



# --- phase 20: the multi-object datasets trained, scored and served ----------
MO_N, MO_IMAGE = 10_000, (64, 64, 3)        # multi-dSprites: the last 10% the test split
MO_STEPS = 20                               # 20a, two CUDA graphs of 10
MO_EVAL_B = 500                             # 20b: the ELBO sweep's batch, the IW-LL's images
MNIST_MO_N, MNIST_MO_IMAGE, MNIST_MO_STEPS = 2_000, (48, 48, 1), 5
MO_NAMES = {"multi_dsprites_binary_rgb": ("dsprites", "multi_dsprites_color_012.npz"),
            "multi_mnist_binary": ("binary_mnist", "multi_binary_mnist_012.npz")}
# the flagship's architecture (FLAGSHIP_ARGS) over multi-dSprites
MO_ARGS = [
    "--dataset", "multi_dsprites_binary_rgb", "--zdims", "32", "32", "32", "--downsample",
    "1", "1", "1", "--nonlin", "elu", "--skip", "--blocks-per-layer", "4", "--n-filters",
    "64", "--gated", "--freebits", "0.5", "--learn-top-prior", "--seed", "42",
    "--batch-size", str(TRAIN_B), "--dropout", "0.2", "--test-batch-size", str(MO_EVAL_B),
]
MO = dict(FLAGSHIP, dataset="multi_dsprites_binary_rgb", test_batch_size=MO_EVAL_B)
FP32_STEP_TOL = {"loss": 1e-4, "grad": 1e-4}          # phases 9, 13 and 16's gate
SERVE_B = (1, 7, 64)
SERVE_RATE_B = (64, 500)
# an artifact against the eager plain path (the same operations: 1e-6), and
# against the eager kernel path (K2, and K3 for the mixture head) at phase
# 11's kernel-vs-plain per-image ELBO tolerance
SERVE_TOL = {"plain": 1e-6, "kernels": 1e-5}

# what a process that cannot import lvae_tpu_torch answers (20c): each
# artifact loaded with torch.export.load onto the card, timed, its graph's
# operators listed, and called on each request
SERVE_SCRIPT = r"""
import sys
sys.modules["lvae_tpu_torch"] = None
import time
import torch
import torch.utils._pytree as pytree

# full fp32 convolutions, as the manifest asks (a fresh process has TF32 on);
# deterministic algorithms, as the eager reference in the parent runs them
# (cuDNN's default choice is not bit-reproducible run to run)
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.use_deterministic_algorithms(True)
path = sys.argv[1]
req = torch.load(path + "/requests.pt")
res = {}
for key, (artifact, calls) in req.items():
    t0 = time.perf_counter()
    ep = torch.export.load(artifact)
    t1 = time.perf_counter()
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"]
    res[key, "nodes"] = len(nodes)
    res[key, "ops"] = sorted({(getattr(n.target, "namespace", ""), n.target.__name__)
                              for n in nodes})
    fn = ep.module()
    for i, (name, args) in enumerate(calls.items()):
        out = fn(*[a.cuda() for a in args])
        torch.cuda.synchronize()
        if i == 0:
            res[key, "load_s"], res[key, "first_call_s"] = t1 - t0, time.perf_counter() - t1
        res[key, name] = pytree.tree_map(lambda t: t.cpu(), out)
res["lvae_tpu_torch"] = any(m.startswith("lvae_tpu_torch") for m in sys.modules
                            if sys.modules[m] is not None)
torch.save(res, path + "/answers.pt")
"""


def multiobject_images(n, image, seed):
    """``n`` binary images, uint8 {0, 255} ``[n, h, w, c]``, drawn on the
    card: two candidate objects an image, each present with probability
    1/2 (so 0-2 objects), a disc at a random centre and radius in a random
    non-black colour (each channel on or off)."""
    import torch

    h, w, c = image
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    yy = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1, 1)
    xx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w, 1)
    x = torch.zeros(n, h, w, c, dtype=torch.bool, device=dev)
    for _ in range(2):
        def draw(lo, hi):
            return torch.rand(n, 1, 1, 1, generator=g, device=dev) * (hi - lo) + lo

        cy, cx, r = draw(0.2, 0.8) * h, draw(0.2, 0.8) * w, draw(0.08, 0.2) * min(h, w)
        colour = torch.rand(n, 1, 1, c, generator=g, device=dev) < 0.5
        colour[..., 0] |= ~colour.any(dim=-1)
        present = torch.rand(n, 1, 1, 1, generator=g, device=dev) < 0.5
        x |= ((yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2) & colour & present
    return (x.to(torch.uint8) * 255).cpu().numpy()


def write_multiobject(data_dir, name, images):
    """``images`` as the multiobject npz of dataset ``name`` under
    ``data_dir`` (``x`` uint8, and a per-image field beside it, as the
    package writes)."""
    sub, fname = MO_NAMES[name]
    d = os.path.join(data_dir, "multiobject", sub)
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, fname), x=images, n_obj=np.zeros(len(images), np.int64))


def mo_train(card, tmp, data):
    """20a: one step of the kernel path against the plain path, then
    multi-dSprites through ``lvae_tpu_torch.main --fused all
    --steps-per-call 10`` with init, with every launch counted."""
    import torch

    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build

    print("[20a] multi-dSprites: one step, --fused all vs none; training through "
          "lvae_tpu_torch.main --fused all --steps-per-call 10", flush=True)
    weights = seeded_model(MO, data, torch.device("cpu")).state_dict()
    step = one_step_vs_plain(card, "multi-dSprites fp32 --fused all vs none", MO_ARGS, data,
                             weights, "all", "none", tol=FP32_STEP_TOL)
    build.reset_launches()
    t0 = time.perf_counter()
    with init_counted() as init:
        trainer = train_main.main(MO_ARGS + [
            "--fused", "all", "--steps-per-call", str(GRAPH_K), "--data-dir",
            os.path.join(tmp, "data"), "--data-dep-init", "--max-steps", str(MO_STEPS),
            "--device", "cuda", "--log-interval", str(GRAPH_K), "--test-interval",
            str(MO_STEPS), "--checkpoint-interval", str(MO_STEPS), "--output-dir",
            os.path.join(tmp, "out"), "--run-name", "multi-dsprites"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v - init.get(k, 0) for k, v in build.LAUNCHES.items() if v}
    build.reset_launches()
    model = trainer.state.model
    segs, sites = segments_per_step(model), unfused_dropouts(model)
    # the test hook's sweep and its reconstruction grid's forward
    sweeps = -(-MO_N // 10 // MO_EVAL_B) + 1
    want = {"sample_kl_per_sample": 3 * MO_STEPS, "sample_kl_per_sample_bwd": 3 * MO_STEPS,
            "segment": segs * MO_STEPS, "segment_bwd": segs * MO_STEPS,
            "dropout": 2 * sites * MO_STEPS, "sample_kl": 3 * sweeps}
    print(f"  {MO_STEPS} steps with init, a test sweep and the grids in {wall:.1f} s; "
          f"{segs} segments and {sites} unfused dropout sites a step; "
          f"launches less the init's {launches}; the init's {dict(init)}  ({card})")
    for counter, n in want.items():
        check(n > 0 and launches.get(counter, 0) == n,
              f"multi-dSprites: {counter} {n} in the run ({launches.get(counter, 0)})")
    check(model.img_size == (64, 64) and model.likelihood_head.__class__.__name__
          == "BernoulliLikelihood", "multi-dSprites: a Bernoulli head over 64x64x3")
    hist = trainer.logger.history
    check(all(np.isfinite(np.asarray(v, dtype=np.float64)).all()
              for _, _, m in hist for v in m.values()),
          f"multi-dSprites: every logged metric finite ({len(hist)} lines)")
    lines = {s: m for kind, s, m in hist if kind == "train"}
    first, last = float(lines[GRAPH_K]["loss"]), float(lines[MO_STEPS]["loss"])
    check(last < first, f"multi-dSprites: EMA loss {last:.1f} at step {MO_STEPS} below "
                        f"{first:.1f} at step {GRAPH_K}")
    tests = [float(m["elbo"]) for kind, _, m in hist if kind == "test"]
    out = {"launches": launches, "init_launches": dict(init), "wall_s": wall, "step": step,
           "ema_loss": (first, last), "test_elbo": tests, "run_dir": trainer.run_dir,
           "log_rates": {s: float(m["images_per_sec"]) for s, m in lines.items()}}
    del trainer, model
    torch.cuda.empty_cache()
    return out


def mo_eval(card, run_dir, tmp):
    """20b: ``lvae_tpu_torch.evaluate --load <run>`` with the k=100 IW-LL
    over the first ``MO_EVAL_B`` test images (K2, K4); multi-MNIST
    (48x48, padded to 64) through 5 training steps and the test ELBO."""
    import torch

    from lvae_tpu_torch import evaluate
    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build

    print("[20b] multi-dSprites through lvae_tpu_torch.evaluate --load <run> --ll; "
          "multi-MNIST 48x48 through 5 steps and the test ELBO", flush=True)
    build.reset_launches()
    t0 = time.perf_counter()
    res = evaluate.main(["--load", run_dir, "--device", "cuda", "--ll", "--iw-samples",
                         str(IW_SAMPLES), "--iw-max-batches", "1"])
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    e, iw = res["elbo"], res["iw"]
    n_test = MO_N // 10
    print(f"  evaluate: ELBO bpd {e['bpd']:.5f} over {e['n_images']} images "
          f"({e['images_per_sec']:.1f} img/s), IW-LL (k={IW_SAMPLES}) bpd {iw['iw_bpd']:.5f} "
          f"over {iw['n_images']} ({iw['images_per_sec']:.1f} img/s); {wall:.1f} s in all; "
          f"launches {launches}  ({card})")
    check(res["step"] == MO_STEPS and e["n_images"] == n_test and iw["n_images"] == MO_EVAL_B
          and np.isfinite(e["bpd"]) and np.isfinite(iw["iw_bpd"]),
          f"evaluate scores step {MO_STEPS}: finite ELBO over {n_test} images, IW-LL over "
          f"{MO_EVAL_B}")
    check(abs(e["bpd"] + e["elbo"] / (64 * 64 * 3 * np.log(2))) < 1e-9, "bpd over 64x64x3")
    # the ELBO sweep's forwards, the IW-LL's and the reconstruction grid's
    n_fwd = -(-n_test // MO_EVAL_B) + IW_SAMPLES + 1
    check(launches.get("sample_kl") == 3 * n_fwd and launches.get("logsumexp") == 1,
          f"evaluate: K2 3 a forward ({3 * n_fwd}), K4 once")
    out = {"bpd": e["bpd"], "iw_bpd": iw["iw_bpd"], "elbo_images_per_sec": e["images_per_sec"],
           "iw_images_per_sec": iw["images_per_sec"], "wall_s": wall, "launches": launches}

    name = "multi_mnist_binary"
    write_multiobject(os.path.join(tmp, "data"), name,
                      multiobject_images(MNIST_MO_N, MNIST_MO_IMAGE, seed=21)[..., 0])
    n_test = MNIST_MO_N // 10
    build.reset_launches()
    t0 = time.perf_counter()
    args = MO_ARGS[:]
    args[args.index("multi_dsprites_binary_rgb")] = name
    args[args.index("--test-batch-size") + 1] = str(n_test)
    trainer = train_main.main(args + [
        "--data-dir", os.path.join(tmp, "data"), "--max-steps", str(MNIST_MO_STEPS),
        "--device", "cuda", "--log-interval", str(MNIST_MO_STEPS), "--test-interval",
        str(MNIST_MO_STEPS), "--checkpoint-interval", str(MNIST_MO_STEPS), "--output-dir",
        os.path.join(tmp, "out"), "--run-name", "multi-mnist"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    model = trainer.state.model
    test = [m for kind, _, m in trainer.logger.history if kind == "test"]
    elbo, bpd = float(test[-1]["elbo"]), float(test[-1]["bpd"])
    print(f"  multi-MNIST: {MNIST_MO_STEPS} steps and the test ELBO over {n_test} images in "
          f"{wall:.1f} s: ELBO {elbo:.2f}, bpd {bpd:.5f}; model {model.img_size}, data "
          f"{model.data_size}; launches {({k: v for k, v in build.LAUNCHES.items() if v})}  "
          f"({card})")
    check(model.img_size == (64, 64) and model.data_size == (48, 48),
          "multi-MNIST: 48x48 images padded to 64x64")
    check(np.isfinite(elbo) and abs(bpd + elbo / (48 * 48 * np.log(2))) < 1e-6,
          "multi-MNIST: a finite test ELBO, bpd over 48x48")
    out["multi_mnist"] = {"elbo": elbo, "bpd": bpd, "wall_s": wall,
                          "launches": {k: v for k, v in build.LAUNCHES.items() if v}}
    build.reset_launches()
    del trainer, model
    torch.cuda.empty_cache()
    return out


def served_err(what, got, want):
    """The worst gap of ``got`` (a tensor, or a dict or tuple of them) to
    ``want``: per image relative to its magnitude (ll, kl, elbo, bpd:
    1-d), otherwise (images, latents) relative to the largest value;
    shapes, float32 and the structure checked."""
    import torch

    if isinstance(want, dict):
        check(sorted(got) == sorted(want), f"{what}: outputs {sorted(want)}")
        return max(served_err(f"{what} {k}", got[k], w) for k, w in want.items())
    if isinstance(want, (tuple, list)):
        check(len(got) == len(want), f"{what}: {len(want)} outputs")
        return max(served_err(f"{what}[{i}]", g, w) for i, (g, w) in enumerate(zip(got, want)))
    w, got = want.float().cpu(), got.cpu()
    if got.shape != w.shape or got.dtype != torch.float32:
        check(False, f"{what}: float32 {tuple(w.shape)} ({got.dtype} {tuple(got.shape)})")
    if w.dim() == 1:
        return ((got - w).abs() / w.abs().clamp_min(1e-30)).max().item()
    return rel_max(got, w)


def served_ok(what, got, want, tol):
    e = served_err(what, got, want)
    check(e <= tol, f"{what}: within {tol:g} ({e:.2e})")
    return e


def start_serving(serve_dir, req):
    """The serving process of 20c (SERVE_SCRIPT, with nothing of the port
    on its path) on the requests ``req`` ({key: (artifact, {name:
    args})}), started and left running (:func:`finish_serving`)."""
    import torch

    os.makedirs(serve_dir)
    torch.save(req, os.path.join(serve_dir, "requests.pt"))
    p = start_command(["-c", SERVE_SCRIPT, serve_dir], cwd=serve_dir,
                      env=dict(os.environ, PYTHONPATH=""))
    p.serve_dir, p.t0 = serve_dir, time.perf_counter()
    return p


def finish_serving(p):
    """(answers, seconds) of a :func:`start_serving` process."""
    import torch

    rc, _ = finish_command(p, 900)
    check(rc == 0, f"the serving process exited 0 ({rc})")
    return torch.load(os.path.join(p.serve_dir, "answers.pt")), time.perf_counter() - p.t0


def keyed_requests(x):
    """20c's requests of a surface that takes images: B = 1, 7 and 64 of
    ``x`` with their global indices, and a shuffled 7 (:func:`serve_perm`)."""
    import torch

    seed = torch.tensor(5, dtype=torch.int32)
    calls = {f"b{b}": (x[:b], seed, torch.arange(b, dtype=torch.int32)) for b in SERVE_B}
    perm = serve_perm()
    calls["perm7"] = (x[:7][perm], seed, perm.to(torch.int32))
    return calls


def serve_perm():
    import torch

    return torch.from_numpy(np.random.default_rng(20).permutation(7))


def mo_serve(card, run_dir, celeba, tmp):
    """20c and 20d: ``python -m lvae_tpu_torch.export_serving --load <run>
    --check --platforms cuda cpu``; every artifact (and celeba64's bf16
    reconstruct, exported by the same command beside phase 19 and served
    since phase 20 began: ``celeba``) served by a process that cannot
    import lvae_tpu_torch and held to the eager port; then the times. The
    eager references are computed while the artifacts are served."""
    import torch

    from lvae_tpu_torch import export_serving, serving
    from lvae_tpu_torch.kernels import build

    print("[20c] export_serving --load <run> --check --platforms cuda cpu; the artifacts "
          "served by a process without the port", flush=True)
    model, data, _, _ = serving._restore_for_export(run_dir, None, torch.device("cuda"))
    models = {"multi-dSprites": (model, data.preprocess), "celeba64 bf16": celeba["model"]}
    x_mo, seed, perm = torch.from_numpy(data.test[:500]), torch.tensor(5, dtype=torch.int32), \
        serve_perm()
    c_path, c_manifest = celeba["req"]["celeba64 reconstruct"][0], celeba["manifest"]
    build.reset_launches()
    t0 = time.perf_counter()
    arts = export_serving.main(["--load", run_dir, "--check", "--platforms", "cuda", "cpu"])
    cli_s = time.perf_counter() - t0
    check(not any(build.LAUNCHES.values()), "the exports and --check launched no kernel of "
                                           "the port")
    sizes = {f"multi-dSprites {name}": os.path.getsize(p) / 2 ** 20
             for name, p in arts.paths.items() if name != "manifest"}
    sizes["celeba64 bf16 reconstruct"] = os.path.getsize(c_path) / 2 ** 20
    export_s = {f"multi-dSprites {name}": s["export_s"]
                for name, s in arts.manifest["surfaces"].items()}
    export_s["celeba64 bf16 reconstruct"] = c_manifest["surfaces"]["reconstruct"]["export_s"]
    check(arts.manifest["surfaces"]["reconstruct"]["batch"] is None
          and c_manifest["precision"] == "bf16", "a symbolic batch; celeba64's in bf16")
    print(f"  export_serving --check: {cli_s:.1f} s in all (celeba64's beside phase 19); trace "
          f"and save s by surface { {k: round(v, 2) for k, v in export_s.items()} }; artifact "
          f"MiB { {k: round(v, 2) for k, v in sizes.items()} }  ({card})")
    mo_req = {"reconstruct": (arts.paths["reconstruct"], keyed_requests(x_mo)),
              "encode": (arts.paths["encode"], {k: v for k, v in keyed_requests(x_mo).items()
                                                 if k != "perm7"}),
              "generate": (arts.paths["generate"], {"seed5": (seed,)})}
    serving_mo = start_serving(os.path.join(tmp, "serve"), mo_req)
    req = {**mo_req, **celeba["req"]}

    # while they serve: the eager plain path against itself, cuDNN's default
    # algorithms (why the comparisons run deterministic ones), then the
    # eager port on the same requests, the plain path and the kernel path,
    # deterministic algorithms on as in the serving processes
    model, pre = models["multi-dSprites"]
    set_kernels(model, False)
    args = [a.cuda() for a in req["encode"][1]["b64"]]
    self_gap = served_err("eager encode b64 twice", serving.encode(model, *args, pre),
                          serving.encode(model, *args, pre))
    print(f"  the eager plain path against itself (encode, B=64, cuDNN's default "
          f"algorithms): {self_gap:.2e}")
    eager, eager_launches = {}, {}
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        for path in ("plain", "kernels"):
            build.reset_launches()
            for key, (_, calls) in req.items():
                run = "celeba64 bf16" if key.startswith("celeba64") else "multi-dSprites"
                model, pre = models[run]
                set_kernels(model, path == "kernels")
                surface = key.split()[-1]
                for name, args in calls.items():
                    if surface == "generate":
                        eager[path, key, name] = serving.generate(
                            model, arts.manifest["surfaces"]["generate"]["n_images"],
                            args[0].cuda())
                    else:
                        fn = serving.reconstruct if surface == "reconstruct" else serving.encode
                        eager[path, key, name] = fn(model, args[0].cuda(), args[1].cuda(),
                                                    args[2].cuda(), pre)
            torch.cuda.synchronize()
            eager_launches[path] = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    build.reset_launches()

    (ans, sub_s), (c_ans, c_sub_s) = (finish_serving(serving_mo),
                                      finish_serving(celeba["serving"]))
    check(not ans["lvae_tpu_torch"] and not c_ans["lvae_tpu_torch"],
          "the serving processes imported nothing of the port")
    ans.update({k: v for k, v in c_ans.items() if k != "lvae_tpu_torch"})
    for key in req:
        ops = ans[key, "ops"]
        other = [op for op in ops if op[0] != "aten" and op[1] != "getitem"]
        check(not other and len(ops) > 10,
              f"{key}: {ans[key, 'nodes']} call nodes of {len(ops)} distinct operators, "
              f"every one aten or a getitem ({other})")
    first = {k: (ans[k, "load_s"], ans[k, "first_call_s"]) for k in req}
    print(f"  the serving processes: {sub_s:.1f} s (multi-dSprites) and {c_sub_s:.1f} s "
          f"(celeba64 bf16, beside 20a-c); load s, first call s by artifact "
          f"{ {k: (round(a, 2), round(b, 3)) for k, (a, b) in first.items()} }  ({card})")

    worst = {"plain": 0.0, "kernels": 0.0}
    eager_plain = {}
    for (path, key, name), want in eager.items():
        if path == "plain":
            eager_plain[key, name] = want
        worst[path] = max(worst[path], served_ok(
            f"{key} {name}: the artifact vs the eager {path} path", ans[key, name], want,
            SERVE_TOL[path]))
    check(not eager_launches["plain"], "the eager plain path launched no kernel")
    check(all(eager_launches["kernels"].get(k, 0) > 0
              for k in ("sample_kl", "mix_log_prob[bf16]")),
          f"the eager kernel path launched K2 and K3 ({eager_launches['kernels']})")
    print(f"  the artifacts vs the eager port: plain path worst {worst['plain']:.2e}, kernel "
          f"path worst {worst['kernels']:.2e}; the kernel path's launches "
          f"{eager_launches['kernels']}  ({card})")

    # batch invariance: B = 1 and 7 are B = 64's first rows, the shuffled 7
    # b7's rows. fp32 within 1e-6; a bf16 model's convolutions round by the
    # algorithm each B picks, so its artifact is held to the eager plain
    # path's own gap between the same batches
    invariance = {}
    for key in ("reconstruct", "celeba64 reconstruct"):
        pairs = {"b1": ("b64", slice(0, 1)), "b7": ("b64", slice(0, 7)), "perm7": ("b7", perm)}
        for name, (full, rows) in pairs.items():
            gaps = [served_err(f"{key} {name} vs {full}'s rows", src[key, name],
                               {k: v[rows] for k, v in src[key, full].items()})
                    for src in (ans, eager_plain)]
            tol = SERVE_TOL["plain"] if key == "reconstruct" else gaps[1] + SERVE_TOL["plain"]
            check(gaps[0] <= tol, f"{key} {name} vs {full}'s rows: the artifact's gap "
                                  f"{gaps[0]:.2e}, the eager plain path's {gaps[1]:.2e}; "
                                  f"within {tol:.2e}")
            invariance[f"{key} {name}"] = {"artifact": gaps[0], "eager": gaps[1]}

    print("[20d] reconstruct images/s: the artifact vs the eager kernel path, in turns",
          flush=True)
    model, pre = models["multi-dSprites"]
    set_kernels(model, True)
    art = serving.load_artifact(arts.paths["reconstruct"], "cuda").module()
    rates = {}
    for b in SERVE_RATE_B:
        x = x_mo[:b].cuda()
        s, idx = torch.tensor(5, dtype=torch.int32, device="cuda"), torch.arange(
            b, dtype=torch.int32, device="cuda")
        calls = {"artifact": lambda: art(x, s, idx),
                 "eager": lambda: serving.reconstruct(model, x, s, idx, pre)}
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        reps = 20 if b == 64 else 5
        turns = {"artifact": [], "eager": []}
        for name in ("artifact", "eager", "eager", "artifact"):
            t0 = time.perf_counter()
            for _ in range(reps):
                calls[name]()
            torch.cuda.synchronize()
            turns[name].append(reps * b / (time.perf_counter() - t0))
        rates[b] = {k: float(np.mean(v)) for k, v in turns.items()}
        rates[b]["turns"] = turns
        print(f"  B={b}: artifact {rates[b]['artifact']:.1f} img/s, eager kernel path "
              f"{rates[b]['eager']:.1f} img/s (turns {turns})  ({card})")
    del art, models, eager, eager_plain
    torch.cuda.empty_cache()
    return {"export_s": export_s, "artifact_mib": sizes, "cli_s": cli_s,
            "graph_nodes": {k: ans[k, "nodes"] for k in req},
            "serving_process_s": sub_s, "celeba64_serving_process_s": c_sub_s,
            "load_and_first_call_s": first,
            "worst": worst, "eager_launches": eager_launches, "invariance": invariance,
            "eager_self_gap": self_gap,
            "reconstruct_images_per_sec": {str(b): r for b, r in rates.items()}}


def start_celeba_export(run_dir):
    """``python -m lvae_tpu_torch.export_serving --load <celeba64 bf16 run>
    --what reconstruct --check`` on the card, started and left running
    (phase 20 waits for it)."""
    p = start_command(["-m", "lvae_tpu_torch.export_serving", "--load", run_dir, "--what",
                       "reconstruct", "--check", "--platforms", "cuda"])
    return {"run_dir": run_dir, "artifact_dir": os.path.join(run_dir, "serving"), "process": p}


def phase_multiobject(card, celeba):
    """Phase 20: multi-dSprites (64x64 RGB, binary, the Bernoulli head) at
    the flagship's widths, trained (20a), scored (20b) and exported and
    served (20c, 20d); multi-MNIST's 48 -> 64 padding; celeba64's bf16 run
    (phase 18b's) exported beside phase 19 (``celeba``, of
    :func:`start_celeba_export`) and served beside 20a-c."""
    import torch

    from lvae_tpu_torch import serving
    from lvae_tpu_torch.data.registry import load_dataset

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rc, _ = finish_command(celeba["process"], 900)
        check(rc == 0, f"export_serving --load <celeba64 bf16 run> --what reconstruct --check "
                       f"exited 0 ({rc})")
        with open(os.path.join(celeba["artifact_dir"], "manifest.json")) as f:
            celeba["manifest"] = json.load(f)
        model, c_data, _, _ = serving._restore_for_export(celeba["run_dir"], None,
                                                          torch.device("cuda"))
        celeba["model"], celeba["x"] = (model, c_data.preprocess), torch.from_numpy(
            c_data.test[:500])
        celeba["req"] = {"celeba64 reconstruct": (
            os.path.join(celeba["artifact_dir"], "reconstruct.pt2"), keyed_requests(celeba["x"]))}
        celeba["serving"] = start_serving(os.path.join(tmp, "serve_celeba"), celeba["req"])
        name = "multi_dsprites_binary_rgb"
        write_multiobject(os.path.join(tmp, "data"), name,
                          multiobject_images(MO_N, MO_IMAGE, seed=20))
        data = load_dataset(name, os.path.join(tmp, "data"))
        check((data.img_size, data.padded_size, data.color_ch, data.preprocess,
               data.default_likelihood, data.test.shape[0])
              == ((64, 64), (64, 64), 3, "none", "bernoulli", MO_N // 10),
              "multi-dSprites loads as lvae_tpu's row: 64x64x3, binary, Bernoulli, the last "
              "10% the test split")
        print(f"  multi-dSprites: {MO_N} images written and loaded in "
              f"{time.perf_counter() - t0:.1f} s; mean on-pixel share "
              f"{float(data.train.mean()):.4f}", flush=True)
        tr = mo_train(card, tmp, data)
        out = {"train": {k: v for k, v in tr.items() if k != "run_dir"}}
        print(f"  [20b at {time.perf_counter() - t0:.1f} s of phase 20]", flush=True)
        out["eval"] = mo_eval(card, tr["run_dir"], tmp)
        print(f"  [20c at {time.perf_counter() - t0:.1f} s of phase 20]", flush=True)
        out["serve"] = mo_serve(card, tr["run_dir"], celeba, tmp)
    out["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"  phase 20 took {out['wall_s']:.1f} s", flush=True)
    return out


# --- phase 21: --streaming, the host-fed training path ----------------------
STREAM_STEPS = 40                           # 21b: two checkpoints, resumed from the first
STREAM_CALLS = 4                            # 21c: graphed calls of GRAPH_K (both buffers reused)
STREAM_FLAGSHIP_STEPS = 20                  # 21d
STREAM_FEED_REPS = 20                       # 21a: stacks a timing
STREAM_CELEBA_ARGS = CELEBA_ARGS + ["--precision", "bf16", "--fused", "all",
                                    "--steps-per-call", str(GRAPH_K)]
STREAM_FLAGSHIP_ARGS = FLAGSHIP_ARGS + ["--fused", "auto"]


def stream_feed(card, stacks):
    """21a: the host feed alone, per ``[k, B, H, W, C]`` stack ({name:
    (split, B)}): the gather into pinned memory, its copy to the card
    (pinned, non-blocking, CUDA events) against a pageable copy, and the
    whole ``HostFeed.put``; and six stacks fed back to back, each held to
    the split's rows after one synchronise (a staging buffer written over
    before its copy landed would show here)."""
    import torch

    from lvae_tpu_torch.data.streaming import ArrayLoader, HostFeed

    out = {}
    for name, (split, b) in stacks.items():
        loader = ArrayLoader(split, b, seed=0, steps_per_call=GRAPH_K)
        rows = loader.indices(0)
        index = [next(rows) for _ in range(STREAM_FEED_REPS)]
        feed = HostFeed(loader, torch.device("cuda"))
        shape = (GRAPH_K, b) + split.shape[1:]
        mb = int(np.prod(shape)) / 1e6
        pinned = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
        pageable = torch.empty(shape, dtype=torch.uint8)
        t0 = time.perf_counter()
        for idx in index:
            loader.gather(idx, out=pinned.numpy())
        gather_ms = (time.perf_counter() - t0) * 1e3 / len(index)
        h2d = {"pinned": cuda_ms(lambda: pinned.to("cuda", non_blocking=True),
                                 reps=STREAM_FEED_REPS),
               "pageable": cuda_ms(lambda: pageable.to("cuda"), reps=STREAM_FEED_REPS)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for idx in index:
            feed.put(idx)
        torch.cuda.synchronize()
        put_ms = (time.perf_counter() - t0) * 1e3 / len(index)
        kept = [feed.put(idx) for idx in index[:6]]
        torch.cuda.synchronize()
        check(all(torch.equal(i.cpu(), torch.from_numpy(idx))
                  and np.array_equal(x.cpu().numpy(), split[idx]) for (i, x), idx in
                  zip(kept, index)),
              f"21a {name}: six stacks fed back to back through the two pinned buffers each "
              f"hold their rows")
        row = {"shape": list(shape), "mb_per_stack": mb, "gather_ms": gather_ms,
               "h2d_pinned_ms": h2d["pinned"], "h2d_pageable_ms": h2d["pageable"],
               "feed_put_ms": put_ms, "gather_mb_s": mb / gather_ms * 1e3,
               "h2d_pinned_mb_s": mb / h2d["pinned"] * 1e3,
               "h2d_pageable_mb_s": mb / h2d["pageable"] * 1e3,
               "feed_mb_s": mb / put_ms * 1e3}
        out[name] = row
        print(f"  21a {name} stack {list(shape)} ({mb:.2f} MB): gather {gather_ms:.3f} ms "
              f"({row['gather_mb_s']:.0f} MB/s); copy pinned {h2d['pinned']:.3f} ms "
              f"({row['h2d_pinned_mb_s']:.0f} MB/s), pageable {h2d['pageable']:.3f} ms "
              f"({row['h2d_pageable_mb_s']:.0f} MB/s); HostFeed.put {put_ms:.3f} ms "
              f"({row['feed_mb_s']:.0f} MB/s)  ({card})", flush=True)
    return out


def stream_celeba_counts(model, steps, sweeps):
    """{launch counter: launches} of ``steps`` celeba64 bf16 ``--fused
    all`` steps and ``sweeps`` test hooks (each a sweep and the
    reconstruction grid's forward), the init's left out."""
    fwd = steps + sweeps * (CELEBA_N_TEST // CELEBA_EVAL_B + 1)
    segs = segments_per_step(model) * steps
    return {"sample_kl_per_sample": 4 * steps, "sample_kl_per_sample_bwd": 4 * steps,
            "mix_log_prob[bf16]": fwd, "mix_log_prob_bwd[bf16]": steps,
            "segment[bf16]": segs, "segment_bwd[bf16]": segs,
            "dropout[bf16]": 2 * unfused_dropouts(model) * steps}


def stream_cli(card, c_train, c_test):
    """21b: celeba64 (BASELINE config 5) at full width through
    ``lvae_tpu_torch.main --streaming --fused all --precision bf16
    --steps-per-call 10``: STREAM_STEPS steps with init, test hooks and
    checkpoints at the half and the end, every kernel of the path held to
    its launch count; then an ``--auto-resume`` from the middle checkpoint,
    bit-equal to the whole run (deterministic algorithms on in both)."""
    import shutil

    import torch

    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build

    n, half = STREAM_STEPS, STREAM_STEPS // 2
    out = {}
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data_dir = os.path.join(tmp, "data")
            write_celeba(data_dir, c_train, c_test)

            def run(out_dir, *extra):
                return train_main.main(STREAM_CELEBA_ARGS + [
                    "--streaming", "--data-dir", data_dir, "--data-dep-init",
                    "--max-steps", str(n), "--device", "cuda", "--log-interval", str(half),
                    "--test-interval", str(half), "--checkpoint-interval", str(half),
                    "--output-dir", out_dir, "--run-name", "streamed", *extra])

            with init_counted() as init:
                build.reset_launches()
                t0 = time.perf_counter()
                whole = run(os.path.join(tmp, "a"))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {c: v - init.get(c, 0) for c, v in build.LAUNCHES.items()}
            print(f"  21b: {n} streamed steps with init, 2 test hooks, 2 checkpoints in "
                  f"{wall:.1f} s; launches less the init's {launches}  ({card})", flush=True)
            check(whole.exp.train_data is None,
                  "21b: no device copy of the train split under --streaming")
            model = whole.state.model
            for counter, want in stream_celeba_counts(model, n, 2).items():
                check(want > 0 and launches.get(counter, 0) == want,
                      f"21b: {counter} {want} launches in the run ({launches.get(counter, 0)})")
            fp32_twins = [c.removesuffix("[bf16]") for c in build.LAUNCHES if c.endswith("[bf16]")]
            check(all(launches[c] == 0 for c in fp32_twins),
                  "21b: no fp32 instantiation of a bf16 kernel ran")
            hist = whole.logger.history
            check(all(np.isfinite(np.asarray(v, dtype=np.float64)).all()
                      for _, _, m in hist for v in m.values()),
                  f"21b: every logged metric finite ({len(hist)} lines)")
            lines = {s: m for kind, s, m in hist if kind == "train"}
            first, last = float(lines[half]["loss"]), float(lines[n]["loss"])
            check(last < first, f"21b: EMA loss {last:.2f} at step {n} below {first:.2f} at "
                                f"step {half}")
            second = os.path.join(tmp, "b", "streamed")
            shutil.copytree(whole.run_dir, second)
            os.unlink(os.path.join(second, "checkpoints", f"ckpt_{n:08d}.pt"))
            t0 = time.perf_counter()
            resumed = run(os.path.join(tmp, "b"), "--auto-resume")
            print(f"  21b: resumed at step {half} and streamed to {n} in "
                  f"{time.perf_counter() - t0:.1f} s  ({card})")
            bad = state_equal(resumed.state, whole.state)
            check(not bad, f"21b: the run resumed from its step-{half} checkpoint is bit-equal "
                           f"to the whole run at step {n} (differ: {bad[:5]})")
            out.update(wall_s=wall, launches=launches, ema_loss=(first, last),
                       test_elbo=[float(m["elbo"]) for kind, _, m in hist if kind == "test"])
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    build.reset_launches()
    return out


def streamed_vs_resident(card, name, args, data, weights, calls):
    """``calls`` graphed calls of ``GRAPH_K`` steps from ``weights``, each
    fed a stack through the host feed, against the device-resident
    ``MultiStep`` fed the loader's own rows and against ``calls *
    GRAPH_K`` eager streamed steps; bit for bit (deterministic algorithms
    on). Returns the streamed run's launches."""
    import dataclasses

    import torch

    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.data.streaming import ArrayLoader, HostFeed
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.train.state import MultiStep, train_step
    from lvae_tpu_torch.train.trainer import Experiment

    cfg, _ = config_from_args(args)
    k = GRAPH_K

    def setup(streaming):
        exp = Experiment(dataclasses.replace(cfg, streaming=streaming), torch.device("cuda"),
                         data)
        exp.model.load_state_dict(weights)
        return exp, exp.init_state(data_dep_init=False)

    def feed(exp, spc):
        loader = ArrayLoader(data.train, cfg.batch_size, seed=cfg.seed, steps_per_call=spc)
        return HostFeed(loader, exp.device).stream(0)

    def run(state, exp, stacks):
        multi = MultiStep(state, None if exp.train_data is None else exp.train_data.gather,
                          exp.loss_cfg, k)
        for index, batch in stacks:
            multi(index, batch)

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        exp, streamed = setup(True)
        stacks = [next(s) for s in [feed(exp, k)] for _ in range(calls)]
        build.reset_launches()
        run(streamed, exp, stacks)
        torch.cuda.synchronize()
        launches = {c: v for c, v in build.LAUNCHES.items() if v}
        build.reset_launches()
        rows = [index for index, _ in stacks]
        exp_r, resident = setup(False)
        run(resident, exp_r, [(index, None) for index in rows])
        bad = state_equal(streamed, resident)
        check(not bad, f"{name}: {calls} graphed calls of {k} streamed steps bit-equal to the "
                       f"device-resident MultiStep fed the loader's rows (differ: {bad[:5]})")
        del exp_r, resident
        exp_e, eager = setup(True)
        ones = feed(exp_e, 1)
        for _ in range(calls * k):
            index, batch = next(ones)
            train_step(eager, batch, index, exp_e.loss_cfg)
        bad = state_equal(streamed, eager)
        check(not bad, f"{name}: {calls} graphed calls of {k} streamed steps bit-equal to "
                       f"{calls * k} eager streamed steps (differ: {bad[:5]})")
        del exp, streamed, stacks, exp_e, eager
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    build.reset_launches()
    torch.cuda.empty_cache()
    return launches


def stream_timing(card, name, args, data, weights, calls):
    """Resident against streamed, one run of each (resident, then
    streaming), each a fresh ``Experiment`` from ``weights``
    after the device memory it takes is read: ms/step on the host clock
    over ``calls`` graphed calls of ``GRAPH_K`` steps between two
    synchronises, after one call (the graph's warm-up and capture), so
    each stack's gather overlaps the call before it as in a run; and, as
    phase 17 takes it, device busy per step (the union of kernel
    intervals) and idle share from a profile of one call after a
    synchronise, where nothing hides the gather."""
    import dataclasses

    import torch

    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.data.streaming import ArrayLoader, HostFeed
    from lvae_tpu_torch.train.state import MultiStep
    from lvae_tpu_torch.train.trainer import Experiment, index_stream

    cfg, _ = config_from_args(args)
    k = GRAPH_K
    out = {"resident": {"runs": []}, "streaming": {"runs": []}}
    for label in ("resident", "streaming"):
        streaming, row = label == "streaming", out[label]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        exp = Experiment(dataclasses.replace(cfg, streaming=streaming), torch.device("cuda"),
                         data)
        torch.cuda.synchronize()
        row["experiment_bytes"] = torch.cuda.memory_allocated() - before
        exp.model.load_state_dict(weights)
        state = exp.init_state(data_dep_init=False)
        if streaming:
            stream = HostFeed(ArrayLoader(data.train, cfg.batch_size, seed=cfg.seed,
                                          steps_per_call=k), exp.device).stream(0)
        else:
            stream = ((i, None) for i in
                      index_stream(exp.train_data, cfg.batch_size, cfg.seed, 0, k))
        multi = MultiStep(state, None if streaming else exp.train_data.gather,
                          exp.loss_cfg, k)

        def call():
            multi(*next(stream))
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        row["runs"].append((time.perf_counter() - t0) * 1e3 / (calls * GRAPH_K))
        busy, _, wall, _ = device_union(call)
        row.update(device_ms_per_step=busy / GRAPH_K, idle_share_one_call=1.0 - busy / wall)
        print(f"  {name} {label}: {row['experiment_bytes'] / 1e6:.1f} MB on the card once the "
              f"Experiment is built; {calls} calls of {GRAPH_K} steps {row['runs'][-1]:.2f} ms "
              f"per step  ({card})", flush=True)
        del exp, state, stream, multi
        torch.cuda.empty_cache()
    for label, row in out.items():
        row["ms_per_step"] = float(np.mean(row["runs"]))
        row["idle_share"] = 1.0 - row["device_ms_per_step"] / row["ms_per_step"]
        print(f"  {name} {label}: {row['ms_per_step']:.2f} ms per step (runs "
              f"{[round(r, 2) for r in row['runs']]}); device busy "
              f"{row['device_ms_per_step']:.2f} ms per step, idle share "
              f"{row['idle_share']:.3f} against it ({row['idle_share_one_call']:.3f} in the "
              f"profile of one call)  ({card})", flush=True)
    return out


def stream_flagship(card, data_dir, data):
    """21d: STREAM_FLAGSHIP_STEPS eager fp32 flagship steps with init
    through ``lvae_tpu_torch.main --streaming`` (its kernels counted)
    against the device-resident path fed the loader's rows, bit for bit
    (deterministic algorithms on). Returns the run's wall s and
    launches, the init's left out."""
    import torch

    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.data.streaming import ArrayLoader
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.train.state import train_step
    from lvae_tpu_torch.train.trainer import Experiment

    n = STREAM_FLAGSHIP_STEPS
    args = STREAM_FLAGSHIP_ARGS + ["--data-dir", data_dir, "--data-dep-init"]
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        with init_counted() as init:
            build.reset_launches()
            t0 = time.perf_counter()
            tr = train_main.main(args + ["--streaming", "--max-steps", str(n), "--device",
                                         "cuda", "--dry-run", "--log-interval", "10",
                                         "--test-interval", str(10 ** 6)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {c: v - init.get(c, 0) for c, v in build.LAUNCHES.items()}
        print(f"  21d flagship: {n} streamed eager steps with init through main in "
              f"{wall:.1f} s; launches less the init's {launches}  ({card})", flush=True)
        want = {"sample_kl_per_sample": 3 * n, "sample_kl_per_sample_bwd": 3 * n,
                "dropout": 2 * unfused_dropouts(tr.state.model) * n}
        for counter, v in want.items():
            check(v > 0 and launches.get(counter, 0) == v,
                  f"21d: {counter} {v} launches ({launches.get(counter, 0)})")
        check(tr.exp.train_data is None, "21d: no device copy of the train split")
        cfg, _ = config_from_args(args)
        exp = Experiment(cfg, torch.device("cuda"), data)
        state = exp.init_state()
        rows = ArrayLoader(data.train, cfg.batch_size, seed=cfg.seed).indices(0)
        for _ in range(n):
            index = torch.from_numpy(next(rows)[0]).cuda()
            train_step(state, exp.train_data.gather(index), index, exp.loss_cfg)
        bad = state_equal(tr.state, state)
        check(not bad, f"21d: {n} steps through main --streaming bit-equal to the resident "
                       f"path fed the loader's rows, both with init (differ: {bad[:5]})")
        del exp, state, tr
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    build.reset_launches()
    return wall, launches


def phase_streaming(card, train_u8, test_u8, c_train, c_test, c_data, celeba_weights):
    """Phase 21: ``--streaming``, the train split on the host and each
    stack copied to the card through pinned buffers."""
    import torch

    from lvae_tpu_torch.data.registry import load_dataset

    t0 = time.perf_counter()
    print("[21] --streaming: the host-fed training path", flush=True)
    out = {"feed": stream_feed(card, {"celeba64": (c_train, CELEBA_B),
                                      "flagship": (train_u8, TRAIN_B)})}
    out["cli"] = stream_cli(card, c_train, c_test)
    print(f"  [21c at {time.perf_counter() - t0:.1f} s of phase 21]", flush=True)
    c_launches = streamed_vs_resident(card, "21c celeba64 bf16 all", STREAM_CELEBA_ARGS,
                                      c_data, celeba_weights, STREAM_CALLS)
    print(f"  [21c timing at {time.perf_counter() - t0:.1f} s of phase 21]", flush=True)
    out["celeba64"] = stream_timing(card, "21c celeba64 bf16 all graphed", STREAM_CELEBA_ARGS,
                                    c_data, celeba_weights, STREAM_CALLS)
    split = c_train.nbytes
    saved = out["celeba64"]["resident"]["experiment_bytes"] - \
        out["celeba64"]["streaming"]["experiment_bytes"]
    check(abs(saved - split) < 2 ** 20,
          f"21c: the streaming Experiment holds {saved / 1e6:.1f} MB less on the card than the "
          f"resident one: the {split / 1e6:.1f} MB train split")
    out["celeba64"]["launches_compared_run"] = c_launches
    print(f"  [21d at {time.perf_counter() - t0:.1f} s of phase 21]", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        write_mnist(data_dir, train_u8, test_u8)
        fdata = load_dataset("static_mnist", data_dir)
        wall, f_launches = stream_flagship(card, data_dir, fdata)
        out["flagship"] = {"wall_s": wall, "launches": f_launches}
    out["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"  phase 21 took {out['wall_s']:.1f} s", flush=True)
    return out


# --- phase 22: the bench and the measurement tools ----------------------------
# (preset, precision) of 22a's bench runs; each a warm-up call (eager steps
# and the capture) and 2 timed calls of --steps-per-call 8 (16 timed steps,
# 24 counted)
BENCH_RUNS = [("mnist", "bf16"), ("mnist", "fp32"), ("celeba64", "bf16"),
              ("cifar10-deep", "bf16")]
BENCH_ARGS = ["--steps", "2", "--warmup", "1", "--steps-per-call", "8"]
BENCH_STEPS = (1 + 2) * 8
BENCH_LAYERS = {"mnist": 3, "celeba64": 4, "cifar10-deep": 10}
PROFILE_ARGS = ["--preset", "celeba64", "--precision", "bf16", "--steps-per-call", "8",
                "--steps", "8"]
PERF_PROBE_B = 256
# 22d's sweeps: one IW batch (k = IW_SAMPLES, chunk 1) at phase 4's and 11's shapes
CHUNK_REL_TOL = {"fp32": 1e-5, "bf16": 1e-2}


def bench_kernels(preset, precision):
    """{launch counter: launches a step} of the bench's path (``--fused
    auto``): K1 and K1-bwd at every latent layer; K3 and K3-bwd once, in
    their bf16 instantiations at bf16, with the mixture head."""
    from lvae_tpu_torch.kernels.build import launch_name

    n = BENCH_LAYERS[preset]
    out = {"sample_kl_per_sample": n, "sample_kl_per_sample_bwd": n}
    if preset != "mnist":
        import torch

        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        out.update({launch_name("mix_log_prob", dtype): 1,
                    launch_name("mix_log_prob_bwd", dtype): 1})
    return out


def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept back and returned:
    ``(result, text)``."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def bench_kernel_checks():
    """22a's first step: every kernel of the bench's path at the shapes
    its default run of each preset gives it (the batch of
    ``bench.parse_args``, the latent layers of a forward of the bench's
    model): K1 and K1-bwd keyed at every latent layer, the top with its
    stride-0 prior, and with the mixture head K3 and K3-bwd in fp32 and
    bf16, each against its plain version at phases 6-7 and 19a's
    tolerances (:func:`k1_checks`, :func:`mix_checks`)."""
    import torch

    from lvae_tpu_torch import bench
    from lvae_tpu_torch.models.stochastic import Noise
    from lvae_tpu_torch.train.trainer import make_model

    print("[22a] the bench's kernels vs their plain versions at its shapes", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(22)
    gd = torch.Generator(device=dev).manual_seed(22)
    err = {}

    def keep(name, v):
        err[name] = max(err.get(name, 0.0), v)

    for preset in ("mnist", "celeba64", "cifar10-deep"):
        args = bench.parse_args(["--preset", preset])
        cfg, data = bench.bench_config(args)
        model = make_model(cfg, data, dev, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            zs = model(torch.rand(2, *data.img_size, data.color_ch, device=dev),
                       noise=Noise(0, torch.arange(2, device=dev)))["z"]
        latents = [(z.shape[3], z.shape[1], z.shape[2]) for z in zs]
        print(f"  {preset}, B={args.batch_size}: latent layers (c, h, w) {latents}")
        for layer, chw in enumerate(latents):
            k1_checks(args.batch_size, layer, chw, layer == len(latents) - 1, g,
                      len(data.train), keep)
        if data.default_likelihood == "discretized_logistic_mix":
            h, w = data.padded_size
            x, p, gg = mix_operands(args.batch_size, h, w, K_MIX, gd)
            for dt in (torch.float32, torch.bfloat16):
                mix_checks(x, p.to(dt), K_MIX, f"[{args.batch_size},{p.shape[1]},{h},{w}] C=3 "
                           f"K={K_MIX}", keep, gg)
            del x, p, gg
        del model, zs
        torch.cuda.empty_cache()
    return err


def phase_bench(card):
    """22a: ``lvae_tpu_torch.bench`` through ``main(argv)`` for each of
    BENCH_RUNS, each result line held to a finite positive rate, an MFU of
    the precision's peak of at most 1.05, the same FLOPs an image in fp32
    and bf16, and every kernel of the path launched once per layer and
    step."""
    import torch

    from lvae_tpu_torch import bench
    from lvae_tpu_torch.kernels import build

    print(f"[22a] python -m lvae_tpu_torch.bench {' '.join(BENCH_ARGS)} at each preset "
          "and precision", flush=True)
    rows = {}
    for preset, precision in BENCH_RUNS:
        build.reset_launches()
        r, text = quiet(bench.main, ["--preset", preset, "--precision", precision, *BENCH_ARGS])
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        print(f"  {text.strip()}")
        label = f"{preset} {precision}"
        print(f"  {label}: {r['value']:.1f} img/s, mfu {r['mfu']:.4f} of {r['peak_flops']:.3e}, "
              f"{r['mfu_precision_peak']:.4f} of the {precision} peak, "
              f"{r['flops_per_image']:.6e} FLOP/image, launches {launches}  ({card})")
        check(np.isfinite(r["value"]) and r["value"] > 0, f"{label}: a finite positive rate")
        check(r["mfu_precision_peak"] <= 1.05,
              f"{label}: at most 1.05x the {precision} peak ({r['mfu_precision_peak']:.4f})")
        check(r["device"] == torch.cuda.get_device_name(0)
              and r["power_limit_w"] is not None, f"{label}: the card and its power limit")
        for counter, per in bench_kernels(preset, precision).items():
            check(launches.get(counter, 0) == per * BENCH_STEPS,
                  f"{label}: {counter} {per} a step x {BENCH_STEPS} steps "
                  f"({launches.get(counter, 0)})")
        rows[label] = {k: r[k] for k in ("value", "mfu", "mfu_precision_peak", "flops_per_image",
                                         "img32_equivalent_per_sec", "final_elbo")}
        rows[label]["launches"] = launches
    a, b = (rows[f"mnist {p}"]["flops_per_image"] for p in ("fp32", "bf16"))
    check(a == b, f"mnist: the same FLOPs an image in fp32 and bf16 ({a:.6e}, {b:.6e})")
    # the graph of 8 steps with the sample+KL kernels off: the plain latent
    # draw built 2 pi from host data, which no CUDA graph captures
    build.reset_launches()
    r, _ = quiet(bench.main, ["--preset", "mnist", "--precision", "fp32", "--fused", "none",
                              "--steps", "1", "--warmup", "1", "--steps-per-call", "8"])
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    check(np.isfinite(r["value"]) and r["value"] > 0 and r["flops_per_image"]
          == rows["mnist fp32"]["flops_per_image"] and "sample_kl_per_sample" not in launches,
          f"mnist fp32 --fused none captured as a graph of 8 steps: {r['value']:.1f} img/s, "
          f"the same FLOPs an image as --fused auto, no sample+KL kernel ({launches})")
    rows["mnist fp32 none"] = {k: r[k] for k in ("value", "mfu", "mfu_precision_peak",
                                                 "flops_per_image")}
    rows["mnist fp32 none"]["launches"] = launches
    return rows


def phase_tools(card):
    """22b-c: ``profile_step`` on celeba64 bf16 graphed and ``perf_probe``
    at batch PERF_PROBE_B, through their ``main(argv)``."""
    from lvae_tpu_torch import perf_probe, profile_step
    from lvae_tpu_torch.kernels import build

    print(f"[22b] python -m lvae_tpu_torch.profile_step {' '.join(PROFILE_ARGS)}", flush=True)
    build.reset_launches()
    prof = profile_step.main(PROFILE_ARGS)
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    check(prof["kernel_events"] > 0 and 0 < prof["device_busy_ms_per_step"]
          <= prof["wall_ms_per_step"] and prof["top"], "a profile of device kernels")
    kernels = prof["kernels"]
    short = {name for name, r in kernels.items() if r["events"] < r["nodes"]}
    check(sum(r["nodes"] for r in kernels.values()) == prof["kernel_nodes"]
          and set(prof["short"]) == short and prof["complete"] == (not short),
          f"the table is printed as whole only if no kernel is short of its graph nodes "
          f"({len(short)} of {len(kernels)} short; {prof['kernel_events']} kernel events, "
          f"{prof['kernel_nodes']} kernel nodes; complete {prof['complete']})")
    for counter, per in bench_kernels("celeba64", "bf16").items():
        check(launches.get(counter, 0) > 0, f"profile_step ran {counter} ({launches})")
        rows = [r for r in kernels.values() if port_kernel(r["symbol"]) == counter]
        nodes, events = (sum(r[k] for r in rows) for k in ("nodes", "events"))
        check(nodes == per * prof["steps"] and (events == nodes or short),
              f"profile_step's table: {counter} {per} a step x {prof['steps']} steps in the "
              f"graph ({nodes} nodes), with as many events ({events}) unless the table is "
              f"partial")
    print(f"  kernels short of their nodes: {sorted(prof['short'].items())[:8]}; with more "
          f"events than nodes: {sorted(prof['extra'].items())[:8]}  ({card})")

    print(f"[22c] python -m lvae_tpu_torch.perf_probe --batch-size {PERF_PROBE_B}", flush=True)
    build.reset_launches()
    legs = perf_probe.main(["--batch-size", str(PERF_PROBE_B)])
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    check(len(legs) == 10 and all(np.isfinite(v["ms"]) and v["ms"] > 0 for v in legs.values()),
          "perf_probe: 10 legs timed")
    check(all(v["tflops"] * 1e12 <= 1.05 * 989e12 for v in legs.values()),
          "perf_probe: every leg under the bf16 peak")
    check(launches.get("sample_kl_per_sample", 0) > 0, f"perf_probe ran K1 ({launches})")
    print(f"  ({card})")
    prof = {k: v for k, v in prof.items() if k not in ("card", "kernels")}
    prof.update(short=len(prof["short"]), extra=sorted(prof["extra"].items())[:8])
    return {"profile_step": prof,
            "perf_probe": legs}


def phase_iwll(card, c_train, c_test):
    """22d: ``iwll_probe`` at its defaults, then one batch of the real IW
    sweep (``evaluate_iwll``, k = IW_SAMPLES, chunk 1) at phase 4's and
    phase 11's shapes in bf16 (phases 5 and 11 time the fp32 sweep), each
    with its device busy time and idle share, and every kernel of its path
    counted."""
    import torch

    from lvae_tpu_torch import iwll_probe
    from lvae_tpu_torch.kernels import build

    print("[22d] python -m lvae_tpu_torch.iwll_probe", flush=True)
    build.reset_launches()
    probe = iwll_probe.main([])
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    for precision, rows in probe.items():
        check(all(np.isfinite(r["ms_per_call"]) and 0 < r["device_busy_ms"] <= r["wall_ms"]
                  for leg, r in rows.items() if leg != "chunk_rel_diff"),
              f"iwll_probe {precision}: 4 legs timed and profiled")
        check(rows["chunk_rel_diff"] <= CHUNK_REL_TOL[precision],
              f"iwll_probe {precision}: iwll_c1 and iwll_c4 within "
              f"{CHUNK_REL_TOL[precision]:g} relative ({rows['chunk_rel_diff']:.2e})")
        for r in rows.values():
            if isinstance(r, dict):
                r.pop("values", None)
    check(launches.get("sample_kl", 0) > 0 and launches.get("logsumexp", 0) > 0,
          f"iwll_probe ran K2 and K4 ({launches})")

    dev = torch.device("cuda")
    cells = iwll_probe.iw_cells(c_test)
    sweeps, iw_launches = {}, {}
    for name, (config, meta, test, pre, dims, batch) in cells.items():
        test_dev = torch.from_numpy(test).to(dev)
        for precision in ("bf16",):
            model = seeded_model(dict(config, precision=precision), meta, dev)
            build.reset_launches()
            r = iwll_probe.iw_sweep(model, test_dev, pre, dims, batch, IW_SAMPLES)
            got = {k: v for k, v in build.LAUNCHES.items() if v}
            label = f"{name} {precision}"
            print(f"  IW sweep {label}, B={batch}, k={IW_SAMPLES}, chunk 1: wall "
                  f"{r['wall_ms']:.1f} ms, device busy {r['device_busy_ms']:.1f} ms, idle share "
                  f"{r['idle_share']:.3f}, {r['images_per_sec']:.1f} img/s, IW-LL "
                  f"{r['iw_ll']:.3f}, launches {got}  ({card})")
            n_layers = len(config["zdims"])
            check(np.isfinite(r["iw_ll"]) and got.get("sample_kl") == n_layers * IW_SAMPLES
                  and got.get("logsumexp") == 1,
                  f"{label}: a finite IW-LL, K2 {n_layers} a forward, K4 once")
            if name == "celeba64":
                mix = "mix_log_prob[bf16]" if precision == "bf16" else "mix_log_prob"
                check(got.get(mix) == IW_SAMPLES, f"{label}: {mix} once a forward")
            sweeps[label] = r
            for k, v in got.items():
                iw_launches[k] = iw_launches.get(k, 0) + v
            del model
    return {"iwll_probe": probe, "iw_sweep": sweeps, "iw_launches": iw_launches,
            "probe_launches": launches}


def phase_measure(card, c_train, c_test):
    """Phase 22: the bench's kernels at its shapes, the bench,
    profile_step, perf_probe and iwll_probe, and the IW sweep's idle share (``phase_measure(card, c_train, c_test)``
    alone, with celeba64's splits as ``main()`` makes them)."""
    t22 = time.perf_counter()
    out = {"bench_kernels_max_abs_err": bench_kernel_checks()}
    out["bench"] = phase_bench(card)
    print(f"  22a took {time.perf_counter() - t22:.1f} s")
    out.update(phase_tools(card))
    print(f"  22a-c took {time.perf_counter() - t22:.1f} s")
    out.update(phase_iwll(card, c_train, c_test))
    print(f"  phase 22 took {time.perf_counter() - t22:.1f} s")
    return out


# ---------------------------------------------------------------------------
# --num-data-shards: data parallelism over ranks (phase 23)
# ---------------------------------------------------------------------------

PARALLEL_K = 8                              # 23a: steps a graphed call
PARALLEL_CALLS = 2                          # 23a: graphed calls a run
PARALLEL_RANKS = 2                          # 23c
PARALLEL_CLI_STEPS = 2                      # 23c: steps of the counted run (the resume: 2 more)
PARALLEL_CLI_TRAIN, PARALLEL_CLI_TEST = 4096, 1007      # 23c: images
SPLIT_NAMES = {"segment_split_stats": "K5-split stats",
               "segment_split_apply": "K5-split apply",
               "segment_split_bwd_reduce": "K5-bwd-split reduce",
               "segment_split_bwd_apply": "K5-bwd-split apply"}


@contextlib.contextmanager
def counted_all_reduces(timed=False):
    """{"calls": n, "s": seconds}: ``torch.distributed.all_reduce`` calls
    inside the block (every all-reduce of the port goes through it); with
    ``timed``, each call's host time with the card synchronised before and
    after (gloo is blocking on the host)."""
    import torch
    import torch.distributed as dist

    out, orig = {"calls": 0, "s": 0.0}, dist.all_reduce

    def wrapped(*args, **kwargs):
        out["calls"] += 1
        if not timed:
            return orig(*args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(*args, **kwargs)
        torch.cuda.synchronize()
        out["s"] += time.perf_counter() - t0
        return res

    dist.all_reduce = wrapped
    try:
        yield out
    finally:
        dist.all_reduce = orig


def parallel_one_rank(card, train_u8, test_u8, weights):
    """23a: the flagship at full width (z 32-32-32, 64 filters, 4 blocks a
    layer), fp32, ``--fused all``, PARALLEL_CALLS calls of PARALLEL_K steps
    each through MultiStep (one CUDA graph), without a process group and
    then on one rank of an NCCL group: the group's run, whose graph holds
    the loss's and the gradients' all-reduces, bit-equal to the other
    (deterministic algorithms on); ms per step of both graphs in turns."""
    import torch

    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.parallel import multihost
    from lvae_tpu_torch.train.state import MultiStep
    from lvae_tpu_torch.train.trainer import Experiment, index_stream

    print("[23a] one rank under NCCL: graphed flagship steps vs the run without a group",
          flush=True)
    k = PARALLEL_K
    cfg, _ = config_from_args(FLAGSHIP_ARGS + ["--fused", "all"])
    data = flagship_dataset(train_u8, test_u8)

    def run():
        exp = Experiment(cfg, torch.device("cuda"), data)
        exp.model.load_state_dict(weights)
        state = exp.init_state(data_dep_init=False)
        multi = MultiStep(state, exp.train_data.gather, exp.loss_cfg, k)
        stream = index_stream(exp.train_data, cfg.batch_size, cfg.seed, 0, k)
        for _ in range(PARALLEL_CALLS):
            multi(next(stream))
        torch.cuda.synchronize()
        return state, multi, stream

    out = {}
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        plain, plain_multi, plain_stream = run()
        layout = multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                      device="cuda", backend="nccl")
        try:
            build.reset_launches()
            with counted_all_reduces() as ar:
                grouped, multi, stream = run()
            launches = {n: v for n, v in build.LAUNCHES.items() if v}
            check(all(launches.get(n, 0) > 0 for n in (
                "sample_kl_per_sample", "sample_kl_per_sample_bwd", "segment", "segment_bwd",
                "dropout")), f"the one-rank run launched K1, K1-bwd, K5, K5-bwd and the "
                             f"dropout kernel ({launches})")
            bad = state_equal(grouped, plain)
            check(not bad, f"{PARALLEL_CALLS * k} graphed steps on one NCCL rank bit-equal to "
                           f"the run without a group (differ: {bad[:5]})")
            # the warm-up call's k eager steps and the capture's k each call
            # the loss's and the gradients' all-reduce once a step
            check(ar["calls"] >= 4 * k and multi.graph is not None,
                  f"the all-reduces were called in the warm-up and in the capture "
                  f"({ar['calls']} calls over 2 x {k} steps)")
            symbols = kernel_names(multi.graph.raw_cuda_graph())
            nccl = {s[:60]: v for s, v in symbols.items() if "nccl" in s.lower()}
            print(f"  the group's graph: {sum(symbols.values())} kernel nodes, NCCL's "
                  f"{nccl or 'none (a one-rank all-reduce may be a copy)'}")
            calls = {"plain": lambda: plain_multi(next(plain_stream)),
                     "nccl": lambda: multi(next(stream))}
            ms = {"plain": [], "nccl": []}
            for label in ("plain", "nccl", "nccl", "plain"):
                ms[label].append(cuda_ms(calls[label], reps=3, warmup=1) / k)
            out = {"bit_equal": True, "all_reduce_calls": ar["calls"], "launches": launches,
                   "nccl_kernel_nodes": sum(nccl.values()),
                   "ms_per_step": {lbl: float(np.mean(v)) for lbl, v in ms.items()},
                   "ms_per_step_runs": ms, "backend": layout.backend}
            print(f"  ms per step (graphs of {k}, in turns): no group "
                  f"{out['ms_per_step']['plain']:.3f}, one NCCL rank "
                  f"{out['ms_per_step']['nccl']:.3f} ({ms})  ({card})")
        finally:
            multihost.shutdown()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    del plain, plain_multi, grouped, multi
    torch.cuda.empty_cache()
    return out


def split_operands(shape, seed=23):
    import torch

    dev = torch.device("cuda")
    g_ = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g_, device=dev) * 1.5 + 0.3
    g = torch.randn(shape, generator=g_, device=dev)
    gamma = torch.rand(c, generator=g_, device=dev) + 0.5
    beta = torch.randn(c, generator=g_, device=dev) * 0.2
    return x, g, gamma, beta


def split_rank_checks(layout):
    """23c's kernel checks on each rank (:func:`parallel_rank`, after the
    command's run): gloo's all-reduce of a CUDA tensor; each split launch
    (K5-split stats and apply, K5-bwd-split reduce and apply) against its
    plain version at every segment shape of this rank's part of a flagship
    step at its global batch of 64 (``graft_entry_torch``'s dry-run
    model), rate 0 and 0.2, elu, each relaunch bit-equal; each launch and
    its plain version timed at the largest, with the bound, on rank 0 while
    the others wait: per call with CUDA events around back-to-back calls
    (the host's launch rate at these sizes) and on the device
    (:func:`device_ms`: the profiler's kernel time, or a CUDA graph's
    replay); the gloo all-reduce of the sums; then two flagship train steps
    with every all-reduce timed."""
    import torch
    import torch.distributed as dist

    import graft_entry_torch as ge
    from lvae_tpu_torch.kernels import segment as seg
    from lvae_tpu_torch.ops import math as om
    from lvae_tpu_torch.ops.philox import dropout_bytes, mix_seed
    from lvae_tpu_torch.parallel import mesh
    from lvae_tpu_torch.train.state import train_step
    from lvae_tpu_torch.train.trainer import Experiment

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": layout.rank}
    t = torch.full((4,), float(layout.rank + 1), device=dev)
    try:
        dist.all_reduce(t, group=layout.group)
    except Exception as e:      # noqa: BLE001  (reported, then raised)
        raise SmokeFailure(f"gloo did not all-reduce a CUDA tensor: {e}") from e
    want = layout.size * (layout.size + 1) / 2
    check(bool((t == want).all()), f"gloo all-reduced a CUDA tensor on {dev} ({t.tolist()})")
    out["gloo_cuda"] = True

    cfg = ge._dryrun_config(layout.size, True, layout.size)
    data, _, _ = ge._dryrun_data(cfg.batch_size)
    per_rank = cfg.batch_size // layout.size
    shapes = list(segment_shapes({**FLAGSHIP, "blocks_per_layer": cfg.blocks_per_layer},
                                 data, per_rank, FLAGSHIP_IMAGE))
    key = seg.Key(42, torch.tensor(7, dtype=torch.int64, device=dev), 3)
    offset = lambda x: mesh.element_map(x, layout)          # noqa: E731
    err = {name: 0.0 for name in SPLIT_NAMES}
    for shape in shapes:
        x, g, gamma, beta = split_operands(shape)
        n_global = int(np.prod(shape)) // shape[1] * layout.size
        for rate in (0.0, 0.2):
            t_ = om.bits8_keep_threshold(rate)
            k_ = key if 0 < t_ < 256 else None
            b = dropout_bytes(shape, mix_seed(*key), dev, offset(x)) if k_ else None
            what = f"{list(shape)} rate {rate}"
            part = seg.split_stats(x, t_, k_, offset(x))
            plain = om.segment_split_stats(x, t_, b)
            e = rel_elem(part.sum(dim=1), plain.sum(dim=1))
            err["segment_split_stats"] = max(err["segment_split_stats"],
                                             (part.sum(dim=1) - plain.sum(dim=1)).abs().max()
                                             .item())
            check(e <= 1e-9, f"K5-split stats {what}: the sums within 1e-9 relative ({e:.2e})")
            check(torch.equal(part, seg.split_stats(x, t_, k_, offset(x))),
                  f"K5-split stats {what}: a second launch is bit-equal")
            glob = mesh.all_reduce_(part.clone(), layout)
            rm, rv = torch.full_like(gamma, 0.3), torch.full_like(gamma, 1.7)
            rm_p, rv_p = rm.clone(), rv.clone()
            y, stats = seg.split_apply(x, gamma, beta, glob, n_global, t_, "elu", 1e-5, k_,
                                       offset(x), rm, rv, 0.9)
            yp, sp = om.segment_split_apply(x, gamma, beta, glob, n_global, t_, "elu", 1e-5, b,
                                            rm_p, rv_p, 0.9)
            e = rel_max(y, yp)
            err["segment_split_apply"] = max(err["segment_split_apply"], (y - yp).abs().max()
                                             .item())
            check(e <= 1e-5, f"K5-split apply {what}: y within 1e-5 of max|y| ({e:.2e})")
            e = max(rel_elem(stats[:2], sp[:2]), rel_elem(rm, rm_p), rel_elem(rv, rv_p))
            check(e <= 1e-6, f"K5-split apply {what}: mean, var and the running statistics "
                             f"within 1e-6 relative ({e:.2e})")
            y2, s2 = seg.split_apply(x, gamma, beta, glob, n_global, t_, "elu", 1e-5, k_,
                                     offset(x), None, None, 0.9)
            check(torch.equal(y, y2) and torch.equal(stats, s2),
                  f"K5-split apply {what}: a second launch is bit-equal")
            local = seg.split_bwd_reduce(x, g, stats, t_, "elu", k_, offset(x))
            lp = om.segment_split_bwd_reduce(x, g, stats, t_, "elu", b)
            e = rel_max(local.sum(dim=1), lp.sum(dim=1))
            err["segment_split_bwd_reduce"] = max(err["segment_split_bwd_reduce"],
                                                  (local.sum(dim=1) - lp.sum(dim=1)).abs().max()
                                                  .item())
            check(e <= 1e-5, f"K5-bwd-split reduce {what}: the sums within 1e-5 of their max "
                             f"({e:.2e})")
            check(torch.equal(local, seg.split_bwd_reduce(x, g, stats, t_, "elu", k_,
                                                          offset(x))),
                  f"K5-bwd-split reduce {what}: a second launch is bit-equal")
            gl = mesh.all_reduce_(local.clone(), layout)
            got = seg.split_bwd_apply(x, g, gamma, stats, local, gl, n_global, t_, "elu", k_,
                                      offset(x))
            ref = om.segment_split_bwd_apply(x, g, gamma, stats, local, gl, n_global, t_,
                                             "elu", b)
            e = max(rel_max(a, r) for a, r in zip(got, ref))
            err["segment_split_bwd_apply"] = max(err["segment_split_bwd_apply"], *(
                (a - r).abs().max().item() for a, r in zip(got, ref)))
            check(e <= 1e-5, f"K5-bwd-split apply {what}: dx, dgamma, dbeta within 1e-5 of "
                             f"their max ({e:.2e})")
            check(torch.equal(got[0] == 0, ref[0] == 0),
                  f"K5-bwd-split apply {what}: dx is exactly 0 where the plain version's is")
            again = seg.split_bwd_apply(x, g, gamma, stats, local, gl, n_global, t_, "elu",
                                        k_, offset(x))
            check(all(torch.equal(a, b2) for a, b2 in zip(got, again)),
                  f"K5-bwd-split apply {what}: a second launch is bit-equal")
    out["max_abs_err"] = err

    # the bf16 instantiations (--precision bf16) at the largest and the
    # smallest shape (units of 16 and of 4), rate 0.2: the arithmetic is
    # fp32 on both sides, so y and dx within one bf16 rounding (2^-8 of
    # their max)
    t_ = om.bits8_keep_threshold(0.2)
    for shape in (shapes[0], shapes[-1]):
        x, g, gamma, beta = split_operands(shape)
        xb, gb = x.bfloat16(), g.bfloat16()
        n_global = xb.numel() // xb.shape[1] * layout.size
        b = dropout_bytes(xb.shape, mix_seed(*key), dev, offset(xb))
        part = mesh.all_reduce_(seg.split_stats(xb, t_, key, offset(xb)), layout)
        plain = mesh.all_reduce_(om.segment_split_stats(xb, t_, b), layout)
        check(rel_elem(part.sum(dim=1), plain.sum(dim=1)) <= 1e-9,
              f"K5-split stats bf16 {list(xb.shape)}: the global sums within 1e-9 relative")
        y, stats = seg.split_apply(xb, gamma, beta, part, n_global, t_, "elu", 1e-5, key,
                                   offset(xb), None, None, 0.9)
        yp, _ = om.segment_split_apply(xb, gamma, beta, part, n_global, t_, "elu", 1e-5, b)
        check(y.dtype == torch.bfloat16 and rel_max(y.float(), yp.float()) <= 2 ** -8,
              f"K5-split apply bf16 {list(xb.shape)}: y bf16 within 2^-8 of max|y|")
        local = seg.split_bwd_reduce(xb, gb, stats, t_, "elu", key, offset(xb))
        gl = mesh.all_reduce_(local.clone(), layout)
        got = seg.split_bwd_apply(xb, gb, gamma, stats, local, gl, n_global, t_, "elu", key,
                                  offset(xb))
        ref = om.segment_split_bwd_apply(xb, gb, gamma, stats, local, gl, n_global, t_, "elu",
                                         b)
        check(got[0].dtype == torch.bfloat16 and max(rel_max(a.float(), r.float())
                                                     for a, r in zip(got, ref)) <= 2 ** -8,
              f"K5-bwd-split bf16 {list(xb.shape)}: dx (bf16), dgamma, dbeta within 2^-8 of "
              f"their max")
        check(torch.equal(seg.split_stats(xb, t_, key, offset(xb)),
                          seg.split_stats(xb, t_, key, offset(xb)))
              and torch.equal(seg.split_apply(xb, gamma, beta, part, n_global, t_, "elu", 1e-5,
                                              key, offset(xb), None, None, 0.9)[0], y)
              and torch.equal(seg.split_bwd_reduce(xb, gb, stats, t_, "elu", key, offset(xb)),
                              local)
              and torch.equal(seg.split_bwd_apply(xb, gb, gamma, stats, local, gl, n_global, t_,
                                                  "elu", key, offset(xb))[0], got[0]),
              f"K5-split and K5-bwd-split bf16 {list(xb.shape)}: each relaunch bit-equal")

    # each launch timed at the largest shape, rate 0.2, on rank 0 alone
    shape = shapes[0]
    x, g, gamma, beta = split_operands(shape)
    n = int(np.prod(shape))
    n_global = n // shape[1] * layout.size
    t_ = om.bits8_keep_threshold(0.2)
    b = dropout_bytes(shape, mix_seed(*key), dev, offset(x))
    part = seg.split_stats(x, t_, key, offset(x))
    glob = mesh.all_reduce_(part.clone(), layout)
    y, stats = seg.split_apply(x, gamma, beta, glob, n_global, t_, "elu", 1e-5, key, offset(x),
                               None, None, 0.9)
    local = seg.split_bwd_reduce(x, g, stats, t_, "elu", key, offset(x))
    sums = local.numel() * 8
    calls = {
        "segment_split_stats": (
            lambda: seg.split_stats(x, t_, key, offset(x)),
            lambda: om.segment_split_stats(x, t_, b), 4 * n + sums),
        "segment_split_apply": (
            lambda: seg.split_apply(x, gamma, beta, glob, n_global, t_, "elu", 1e-5, key,
                                    offset(x), None, None, 0.9),
            lambda: om.segment_split_apply(x, gamma, beta, glob, n_global, t_, "elu", 1e-5, b),
            8 * n + sums),
        "segment_split_bwd_reduce": (
            lambda: seg.split_bwd_reduce(x, g, stats, t_, "elu", key, offset(x)),
            lambda: om.segment_split_bwd_reduce(x, g, stats, t_, "elu", b), 8 * n + sums),
        "segment_split_bwd_apply": (
            lambda: seg.split_bwd_apply(x, g, gamma, stats, local, glob, n_global, t_, "elu",
                                        key, offset(x)),
            lambda: om.segment_split_bwd_apply(x, g, gamma, stats, local, glob, n_global, t_,
                                               "elu", b), 12 * n + 2 * sums),
    }
    times = {}
    if layout.primary:      # the other ranks wait: they share the card
        for name, (kern, plain, n_bytes) in calls.items():
            bnd = bound(n_bytes, OPS_SEGMENT * n)
            times[name] = {"ms": cuda_ms(kern, 50), "plain_ms": cuda_ms(plain, 10),
                           "device_ms": device_ms(kern, 20),
                           "plain_device_ms": device_ms(plain, 5),
                           "bound_ms": bnd[0], "bound_by": bnd[1], "shape": list(shape)}
    dist.barrier(group=layout.group)
    ar = []
    for _ in range(3):          # the sums' all-reduce over gloo, CUDA tensors
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            mesh.all_reduce_(part.clone(), layout)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3 / 10)
    out.update(times=times, sums_all_reduce_ms=float(np.median(ar)), shapes=[list(s)
                                                                            for s in shapes])

    # two of the dry run's flagship steps with every all-reduce timed
    exp = Experiment(cfg, dev, data=data)
    state = exp.init_state()
    per_step = []
    for i in range(3):
        index = mesh.make_global_batch_indices(
            torch.arange(cfg.batch_size, device=dev) + i * cfg.batch_size, layout)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counted_all_reduces(timed=True) as c:
            train_step(state, exp.train_data.gather(index), index, exp.loss_cfg)
            torch.cuda.synchronize()
        per_step.append({"step_ms": (time.perf_counter() - t0) * 1e3, "all_reduces": c["calls"],
                         "all_reduce_ms": c["s"] * 1e3})
    out["steps"] = per_step[1:]         # the first builds the cuDNN plans
    return out


def parallel_rank(spec_path):
    """One rank of 23c, started by :func:`parallel_cli` through
    ``multihost.launch`` (which sets RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT): ``lvae_tpu_torch.main.main(argv)`` as under ``torchrun``
    (it joins the launcher's group, trains and leaves it), every launch
    count set to 0 just before and read just after; then
    :func:`split_rank_checks` in a group of its own at the spec's port.
    Writes ``rank<r>.pt`` beside the spec."""
    import torch

    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.parallel import multihost

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    build.reset_launches()
    with counted_all_reduces() as ar:
        trainer = train_main.main(spec["argv"])
    torch.cuda.synchronize()
    out = {"rank": rank, "launches": {k: v for k, v in build.LAUNCHES.items() if v},
           "all_reduces": ar["calls"], "history": trainer.logger.history,
           "backend": trainer.exp.layout.backend, "run_dir": trainer.run_dir}
    layout = multihost.initialize(f"127.0.0.1:{spec['port']}", world, rank, device="cuda")
    try:
        out["split"] = split_rank_checks(layout)
    finally:
        multihost.shutdown()
    torch.save(out, os.path.join(os.path.dirname(spec_path), f"rank{rank}.pt"))
    return 0


def run_command(argv, timeout_s):
    """(exit code, output) of ``python argv`` started from the repository
    in a session of its own, so that past ``timeout_s`` it and the ranks it
    starts are all killed; the output's last lines are echoed."""
    return finish_command(start_command(argv), timeout_s)


def start_command(argv, cwd=REPO, env=None):
    """``python argv`` started (from the repository by default) in a session
    of its own (:func:`finish_command` waits for it); should the script end
    first, on a failure, the session is killed on the way out."""
    import signal

    p = subprocess.Popen([sys.executable, *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, start_new_session=True)
    p.argv = argv
    atexit.register(lambda: p.poll() is None and os.killpg(p.pid, signal.SIGKILL))
    return p


def finish_command(p, timeout_s):
    """(exit code, output) of a :func:`start_command` process; past
    ``timeout_s`` it and the ranks it starts are all killed; the output's
    last lines are echoed."""
    import signal

    argv = p.argv
    try:
        text, _ = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise SmokeFailure(f"{' '.join(argv[:3])} ran past {timeout_s} s") from None
    for line in text.splitlines()[-12:]:
        print(f"    | {line}")
    return p.returncode, text


def printed(pattern, text):
    """The numbers ``pattern``'s group matched in ``text``."""
    return [float(v) for v in re.findall(pattern, text)]


def parallel_cli(card, train_u8, test_u8, beside=None):
    """23c: the commands a user runs, at the flagship's full width under
    ``--fused all`` over two gloo ranks sharing the card, on a static_mnist
    of PARALLEL_CLI_TRAIN train and PARALLEL_CLI_TEST test images (the
    test batch of 1000 does not divide them). (1) ``lvae_tpu_torch.main
    --num-data-shards 2``, its ranks started here as ``torchrun`` starts
    them (:func:`parallel_rank`): PARALLEL_CLI_STEPS steps with a test hook
    and a checkpoint at the end, each rank's launches counted (the split
    segments, none of the one-launch K5), the ranks' logged metrics equal,
    one run directory and one checkpoint written; then the split kernels'
    checks on both ranks. Then side by side: (2) the same command as a user
    types it (it starts its own ranks) with ``--auto-resume``, two steps
    more, and (3) ``evaluate --num-data-shards 2`` (it starts its own
    ranks) of a copy of (1)'s run against ``evaluate`` on one rank of
    another copy: the test ELBO and the IW-LL of one batch; ``beside`` (a
    callable) runs in this process while (2) and (3) run, its result in
    the returned record's ``beside``."""
    import torch

    from lvae_tpu_torch import evaluate as eval_main
    from lvae_tpu_torch.parallel import multihost
    from lvae_tpu_torch.train.checkpoint import CheckpointManager

    print(f"[23c] main and evaluate --num-data-shards {PARALLEL_RANKS} on the card", flush=True)
    n, ranks_txt = PARALLEL_CLI_STEPS, f"x {PARALLEL_RANKS} ranks (gloo)"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir, runs = os.path.join(tmp, "data"), os.path.join(tmp, "runs")
        write_mnist(data_dir, train_u8[:PARALLEL_CLI_TRAIN], test_u8[:PARALLEL_CLI_TEST])
        argv = FLAGSHIP_ARGS + [
            "--fused", "all", "--num-data-shards", str(PARALLEL_RANKS), "--device", "cuda",
            "--data-dir", data_dir, "--output-dir", runs, "--run-name", "dp",
            "--log-interval", "2", "--test-interval", str(n), "--checkpoint-interval", str(n)]
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"argv": argv + ["--max-steps", str(n)], "port": multihost.free_port()}, f)
        t0 = time.perf_counter()
        try:
            code = multihost.launch([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                                     spec], PARALLEL_RANKS, 300)
        except TimeoutError as e:
            raise SmokeFailure(f"23c: {e}") from e
        check(code == 0, f"23c: the {PARALLEL_RANKS} ranks of main ended with code 0 ({code})")
        out["wall_s"] = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(PARALLEL_RANKS)]
        for r in ranks:
            got = r["launches"]
            check(r["backend"] == "gloo" and all(got.get(c, 0) > 0 for c in (
                *SPLIT_NAMES, "sample_kl_per_sample", "sample_kl_per_sample_bwd", "dropout"))
                  and not any(got.get(c, 0) for c in ("segment", "segment_bwd")),
                  f"23c rank {r['rank']}: main launched the split segments, K1, K1-bwd and "
                  f"the dropout kernel, and no one-launch K5 ({got})")
            check(got.get("segment_split_stats") == got.get("segment_split_apply")
                  and got.get("segment_split_bwd_reduce") == got.get("segment_split_bwd_apply"),
                  f"23c rank {r['rank']}: each split launch's pair launched as often")
        train_path = (*SPLIT_NAMES, "sample_kl_per_sample", "sample_kl_per_sample_bwd",
                      "dropout")
        check(len({tuple(r["launches"].get(c, 0) for c in train_path) for r in ranks}) == 1,
              "23c: both ranks launched each kernel of the train step as often (rank 0 "
              "alone draws the test hook's grids)")
        hist = [[(kind, step, {k: np.asarray(v, dtype=np.float64) for k, v in m.items()
                               if k not in ("images_per_sec", "wall_s")})    # host clocks
                 for kind, step, m in r["history"]] for r in ranks]
        check([h[:2] for h in hist[0]] == [h[:2] for h in hist[1]]
              and all(np.allclose(a[k], b[k], rtol=1e-6, atol=0) and np.isfinite(a[k]).all()
                      for (_, _, a), (_, _, b) in zip(*hist) for k in a),
              f"23c: the ranks' metrics are the global batch's, equal and finite "
              f"({len(hist[0])} lines)")
        run_dir = ranks[0]["run_dir"]
        mngr = CheckpointManager(run_dir)
        check(os.listdir(runs) == ["dp"] and mngr.steps() == [n]
              and os.path.exists(os.path.join(run_dir, "config.json")),
              f"23c: one run directory, its config and one checkpoint (step {n}) written "
              f"({os.listdir(runs)}, {mngr.steps()})")

        # side by side: the command as typed, resumed two steps further, and
        # evaluate --num-data-shards 2 of a copy of the counted run (step n),
        # one rank's evaluate of another copy in this process meanwhile
        copies = [os.path.join(tmp, f"dp_{c}") for c in ("ranks", "one")]
        for c in copies:
            shutil.copytree(run_dir, c, ignore=shutil.ignore_patterns("imgs", "trace"))
        ev = ["--device", "cuda", "--ll", "--iw-samples", str(IW_SAMPLES), "--iw-max-batches",
              "1", "--nimages", "16"]
        t1 = time.perf_counter()
        resume = start_command(["-m", "lvae_tpu_torch.main", *argv, "--max-steps", str(n + 2),
                                "--auto-resume"])
        evaluate = start_command(["-m", "lvae_tpu_torch.evaluate", "--load", copies[0], *ev,
                                  "--num-data-shards", str(PARALLEL_RANKS)])
        one = eval_main.main(["--load", copies[1], *ev])
        out["beside"] = beside() if beside is not None else None
        code, text = finish_command(resume, 240)
        out["resume_wall_s"] = time.perf_counter() - t1
        check(code == 0 and ranks_txt in text
              and len(re.findall(rf"\[train\] step +{n + 2} ", text)) == 1
              and mngr.steps()[-1] == n + 2 and os.listdir(runs) == ["dp"],
              f"23c: python -m lvae_tpu_torch.main --num-data-shards {PARALLEL_RANKS} "
              f"--auto-resume started its ranks ({ranks_txt}), went on from step {n} to "
              f"{n + 2}, rank 0 alone logged, one run directory (code {code}, checkpoints "
              f"{mngr.steps()})")
        code, text = finish_command(evaluate, 240)
        out["evaluate_wall_s"] = time.perf_counter() - t1
        elbo, iw = printed(r"test elbo (-?[\d.]+) ", text), printed(r": (-?[\d.]+) nats", text)
        # printed to 2 decimals; the sums' order differs
        check(code == 0 and ranks_txt in text and len(elbo) == len(iw) == 1
              and abs(elbo[0] - one["elbo"]["elbo"]) <= 0.011
              and abs(iw[0] - one["iw"]["iw_ll"]) <= 0.011
              and f"[{PARALLEL_CLI_TEST} images" in text,
              f"23c: evaluate --num-data-shards {PARALLEL_RANKS} printed one rank's test ELBO "
              f"over {PARALLEL_CLI_TEST} images and IW-LL ({elbo} vs {one['elbo']['elbo']:.4f}, "
              f"{iw} vs {one['iw']['iw_ll']:.4f})")
    out.update(launches=[r["launches"] for r in ranks], all_reduces=ranks[0]["all_reduces"],
               split=ranks[0]["split"],
               loss=[float(m["loss"]) for kind, _, m in ranks[0]["history"] if kind == "train"],
               test_elbo=float(one["elbo"]["elbo"]), iw_ll=float(one["iw"]["iw_ll"]))
    print(f"  23c: {n} steps {out['wall_s']:.1f} s (rank start included), the resume "
          f"{out['resume_wall_s']:.1f} s, evaluate {out['evaluate_wall_s']:.1f} s  ({card})")
    return out


def phase_parallel(card, train_u8, test_u8, flagship_weights, beside=None):
    """Phase 23, ``--num-data-shards``: (a) one NCCL rank, graphed, bit-equal
    to no group; (c) :func:`parallel_cli`, the commands on two ranks (with
    ``beside`` run in this process while its last two do, its result under
    ``beside``), and the split kernels' checks on both. (The dry run runs
    in phase 25 at its default layout for four ranks, 2 x 2.)"""
    print("[23] data parallelism (--num-data-shards)", flush=True)
    t0 = time.perf_counter()
    out = {"one_rank_nccl": parallel_one_rank(card, train_u8, test_u8, flagship_weights)}
    print(f"  23a took {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    cli = parallel_cli(card, train_u8, test_u8, beside)
    out["beside"] = cli.pop("beside")
    split = cli.pop("split")
    check(split["gloo_cuda"], "gloo all-reduced CUDA tensors on the ranks")
    steps = split["steps"]
    ar_ms = float(np.mean([s["all_reduce_ms"] for s in steps]))
    step_ms = float(np.mean([s["step_ms"] for s in steps]))
    print(f"  rank 0: a flagship step (global batch 64) {step_ms:.1f} ms of which {ar_ms:.1f} "
          f"ms in {steps[0]['all_reduces']} gloo all-reduces of CUDA tensors (host clock, card "
          f"synchronised around each; two ranks sharing one card, not a multi-GPU rate); the "
          f"sums' all-reduce {split['sums_all_reduce_ms']:.3f} ms  ({card})")
    for name, row in split["times"].items():
        print(f"  time {SPLIT_NAMES[name]} {row['shape']}: per call kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms; device: kernel {fmt_ms(row['device_ms'])}, "
              f"plain {fmt_ms(row['plain_device_ms'])}; bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})  ({card})")
    print(f"  23c took {time.perf_counter() - t1:.1f} s", flush=True)
    out.update(cli=cli, split=split, gloo_step={"step_ms": step_ms, "all_reduce_ms": ar_ms,
                                                "all_reduces_per_step": steps[0]["all_reduces"]})
    return out


CKPT_STEPS = 2                              # 24c: steps of main --load from the import


def phase_checkpoint(card, run_dir, data_dir):
    """[24] the checkpoint pair on the card: phase 8's flagship run exported
    (``convert_checkpoint export``) and imported into a new run directory
    (``convert_checkpoint import --device cuda``); both runs scored by
    ``evaluate --load`` (test ELBO, k=100 IW-LL over one batch of 1,000),
    bit-equal; then ``main --load <imported>`` trains ``CKPT_STEPS`` steps
    under ``--rng-impl rbg`` and under threefry, bit-equal (deterministic
    cuDNN in both). Each entry point's launches are counted around it."""
    import torch

    from lvae_tpu_torch import convert_checkpoint, evaluate
    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.train.checkpoint import CheckpointManager

    print("[24] the checkpoint pair: export, import, evaluate --load, main --load "
          "(--rng-impl rbg and threefry)", flush=True)
    t0 = time.perf_counter()
    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        pt = os.path.join(tmp, "flagship.pt")
        build.reset_launches()
        convert_checkpoint.main(["export", "--load", run_dir, "--out", pt])
        exported = torch.load(pt, weights_only=True)
        ckpt = CheckpointManager(run_dir).load()
        check(sorted(exported) == sorted(ckpt["model"])
              and all(torch.equal(exported[k], v.cpu()) for k, v in ckpt["model"].items()),
              f"export wrote step {ckpt['step']}'s {len(exported)} tensors as they are")
        imported = os.path.join(tmp, "imported")
        convert_checkpoint.main(["import", "--state-dict", pt, "--run-dir", imported,
                                 "--device", "cuda", "--", *FLAGSHIP_ARGS,
                                 "--data-dir", data_dir])
        check(sum(build.LAUNCHES.values()) == 0, "export and import launch no kernel")
        t_convert = time.perf_counter() - t0

        # cuDNN's deterministic algorithms in every run compared: its
        # default convolution algorithms may sum in another order run to run
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
        try:
            scores = {}
            for name, d in (("original", run_dir), ("imported", imported)):
                build.reset_launches()
                t = time.perf_counter()
                r = evaluate.main(["--load", d, "--ll", "--iw-max-batches", "1",
                                   "--device", "cuda"])
                torch.cuda.synchronize()
                out["launches"][f"evaluate_{name}"] = dict(build.LAUNCHES)
                scores[name] = r
                out[f"evaluate_{name}_s"] = time.perf_counter() - t
            a, b = scores["original"], scores["imported"]
            keys = ("elbo", "ll", "kl", "bpd")
            same = (all(a["elbo"][k] == b["elbo"][k] for k in keys)
                    and list(a["elbo"]["kl_layers"]) == list(b["elbo"]["kl_layers"])
                    and a["iw"]["iw_ll"] == b["iw"]["iw_ll"])
            check(same and np.isfinite(b["elbo"]["elbo"]) and np.isfinite(b["iw"]["iw_ll"]),
                  f"the imported run scores bit-equal to the original: test ELBO "
                  f"{b['elbo']['elbo']!r} / {a['elbo']['elbo']!r}, IW-LL {b['iw']['iw_ll']!r} / "
                  f"{a['iw']['iw_ll']!r}")
            check(b["step"] == 0 and a["step"] == TRAIN_STEPS,
                  f"the import is step 0 of the original's step {TRAIN_STEPS}")
            ev = out["launches"]["evaluate_imported"]
            check(ev["sample_kl"] > 0 and ev["logsumexp"] > 0,
                  f"evaluate --load <imported> ran K2 and K4 ({ev['sample_kl']}, "
                  f"{ev['logsumexp']} launches)")
            out.update(test_elbo=b["elbo"]["elbo"], iw_ll=b["iw"]["iw_ll"])

            runs = {}
            for impl in ("rbg", "threefry"):
                build.reset_launches()
                t = time.perf_counter()
                tr = train_main.main(FLAGSHIP_ARGS + [
                    "--data-dir", data_dir, "--load", imported, "--max-steps", str(CKPT_STEPS),
                    "--rng-impl", impl, "--device", "cuda", "--log-interval", "1",
                    "--output-dir", os.path.join(tmp, "out"), "--run-name", impl])
                torch.cuda.synchronize()
                out["launches"][f"main_{impl}"] = dict(build.LAUNCHES)
                out[f"main_{impl}_s"] = time.perf_counter() - t
                runs[impl] = tr
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        ra, rb = runs["rbg"].state, runs["threefry"].state
        check(ra.step == rb.step == CKPT_STEPS, f"main --load trained {CKPT_STEPS} steps "
                                                f"from the import")
        c_rbg, c_tf = (CheckpointManager(r.run_dir).load(CKPT_STEPS) for r in runs.values())
        same = (all(torch.equal(c_rbg["model"][k], c_tf["model"][k]) for k in c_rbg["model"])
                and all(torch.equal(c_rbg["ema"][k], c_tf["ema"][k]) for k in c_rbg["ema"]))
        sa, sb = (c["optimizer"]["state"] for c in (c_rbg, c_tf))
        same = same and all(torch.equal(sa[i][n], sb[i][n]) for i in sa for n in sa[i])
        losses = [[float(m["loss"]) for kind, _, m in r.logger.history if kind == "train"]
                  for r in runs.values()]
        check(same and losses[0] == losses[1] and all(np.isfinite(losses[0])),
              f"--rng-impl rbg is bit-equal to threefry over {CKPT_STEPS} steps: weights, "
              f"Adamax state, EMA (losses {losses[0]})")
        n = 3 * CKPT_STEPS
        tl = out["launches"]["main_rbg"]
        sites = unfused_dropouts(ra.model)
        check(tl["sample_kl_per_sample"] == n and tl["sample_kl_per_sample_bwd"] == n
              and tl["dropout"] == 2 * sites * CKPT_STEPS,
              f"main --load ran K1 and K1-bwd 3 times a step and the dropout kernel at "
              f"{sites} sites each way ({tl['sample_kl_per_sample']}, "
              f"{tl['sample_kl_per_sample_bwd']}, {tl['dropout']})")
        out["losses"] = losses[0]
    out["convert_s"] = t_convert
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 24 took {out['seconds']:.1f} s (export + import {t_convert:.1f}, "
          f"evaluate {out['evaluate_original_s']:.1f} / {out['evaluate_imported_s']:.1f}, "
          f"main --load {out['main_rbg_s']:.1f} / {out['main_threefry_s']:.1f})  ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 25: height sharding (--spatial-shards)
# ---------------------------------------------------------------------------

SPATIAL_STEPS, SPATIAL_CELEBA_STEPS = 3, 2  # 25a, 25c: steps a run
SPATIAL_TRAIN, SPATIAL_TEST = 1024, 256     # the splits of 25a's static_mnist and 25c's celeba
# the kernels whose launches a banded step makes (the split segments under
# --fused all, the dropout kernel for the trailing dropouts)
SPATIAL_PATH = ("sample_kl_per_sample", "sample_kl_per_sample_bwd", "dropout", *SPLIT_NAMES)


def banded_k1_checks(check_band, dev, g, err, n_space, b, layer, h, w):
    """K2's eps, K1 and K1-bwd (the top layer's with its prior read with
    row stride 0) on every band of an ``[b, 32, h, w]`` latent map over
    ``n_space`` ranks: each against its plain version on the band, the
    bands' eps concatenated bit-equal to the whole map's, an empty band
    launching nothing."""
    import torch

    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.kernels import stochastic as sk
    from lvae_tpu_torch.ops.philox import Band, keyed_normal
    from lvae_tpu_torch.parallel.mesh import band

    c, seed = 32, 1234
    q = (torch.randn(b, 2 * c, h, w, generator=g) * 0.7).to(dev)
    p = (torch.randn((1 if layer == 2 else b), 2 * c, h, w, generator=g) * 0.7).to(dev)
    gz = torch.randn(b, c, h, w, generator=g).to(dev)
    gkl = torch.randn(b, generator=g).to(dev)
    index = torch.randperm(50_000, generator=g)[:b].to(dev)
    step = torch.tensor(11, dtype=torch.int64, device=dev)
    zero = torch.zeros(b, 2 * c, h, w, device=dev)
    whole_eps, _ = sk.sample_kl(zero, zero, index, seed, step, layer)    # z = eps at 0, 0
    eps_bands = []
    for s in range(n_space):
        h0, h1 = band(h, n_space, s)
        bd = Band(h, h0)
        what = f"S={n_space} band {s} [{b},{c},{h1 - h0},{w}] of {h} rows"
        qs, ps, gzs = (t[:, :, h0:h1].contiguous() for t in (q, p, gz))
        before = dict(build.LAUNCHES)
        zs = zero[:, :, h0:h1].contiguous()
        eps_s, _ = sk.sample_kl(zs, zs, index, seed, step, layer, bd)
        eps_bands.append(eps_s)
        z, kl = sk.sample_kl_per_sample(qs, ps, index, seed, step, layer, bd)
        zr, klr = sk._plain_sample_kl_per_sample(qs, ps, index, seed, step, layer, bd)
        dq, dp = sk.sample_kl_backward(qs, ps, gzs, gkl,
                                       keyed=sk.Keyed(index, seed, step, layer, bd))
        eps_r = keyed_normal(gzs.shape, seed, index, step, layer, bd)
        dqr, dpr = sk._plain_sample_kl_bwd(qs, ps, eps_r, gzs, gkl)
        if h1 == h0:
            check_band(all(build.LAUNCHES[k] == before[k] for k in (
                "sample_kl", "sample_kl_per_sample", "sample_kl_per_sample_bwd"))
                and tuple(z.shape) == (b, c, 0, w) and bool((kl == 0).all())
                and dq.numel() == 0, f"{what}: an empty band launches nothing, sums 0")
            continue
        e = max((eps_s - eps_r).abs().max().item(), (z - zr).abs().max().item(),
                (kl - klr).abs().max().item())
        err["sample_kl"] = max(err["sample_kl"], (eps_s - eps_r).abs().max().item())
        err["sample_kl_per_sample"] = max(err["sample_kl_per_sample"], e)
        check_band(e <= 1e-5, f"{what}: K2's eps, K1's z and per-sample KL match the plain "
                              f"banded generator (max abs {e:.2e})")
        e = max(rel_max(dq, dqr), rel_max(dp, dpr))
        err["sample_kl_per_sample_bwd"] = max(err["sample_kl_per_sample_bwd"], e)
        check_band(e <= 1e-5 and tuple(dp.shape) == tuple(ps.shape),
                   f"{what}: K1-bwd's dq, dp within 1e-5 of their max ({e:.2e})"
                   + (", the prior's dp summed over the rows" if ps.shape[0] == 1 else ""))
    check_band(torch.equal(torch.cat(eps_bands, dim=2), whole_eps),
               f"S={n_space} [{b},{c},{h},{w}]: the bands' eps concatenated bit-equal to the "
               f"whole map's")


def banded_segment_checks(check_band, dev, g, err, n_space, d, b, shape):
    """The dropout kernel and the four split launches on every band of
    data index ``d``'s rows ``[b, C, H, W]`` of a global batch: each
    against its plain version with the same element map (the masks
    bit-equal), the bands' dropped outputs concatenated bit-equal to the
    whole rows' (whose map is one run); this rank's sums standing for the
    global ones."""
    import torch

    from lvae_tpu_torch.kernels import segment as seg
    from lvae_tpu_torch.ops import math as om
    from lvae_tpu_torch.ops.philox import ElementMap, dropout_bytes, mix_seed
    from lvae_tpu_torch.parallel.mesh import band

    _, c, h, w = shape
    key = seg.Key(42, torch.tensor(7, dtype=torch.int64, device=dev), 3)
    t_ = om.bits8_keep_threshold(0.2)
    x = torch.randn(b, c, h, w, generator=g).to(dev) * 1.5 + 0.3
    gg = torch.randn(b, c, h, w, generator=g).to(dev)
    gamma = (torch.rand(c, generator=g) + 0.5).to(dev)
    beta = (torch.randn(c, generator=g) * 0.2).to(dev)
    row0 = d * b * c * h * w
    whole = seg._launch_dropout(x, t_, key, ElementMap(base=row0))
    plan = seg.split_plan(b, c, -(-h // n_space), w)
    n_global = b * (d + 1) * h * w
    outs = []
    for s in range(n_space):
        h0, h1 = band(h, n_space, s)
        what = f"S={n_space} band {s} [{b},{c},{h1 - h0},{w}] of {h} rows (data index {d})"
        xs, gs = x[:, :, h0:h1].contiguous(), gg[:, :, h0:h1].contiguous()
        emap = ElementMap((h1 - h0) * w, h * w, row0 + h0 * w)
        mask = dropout_bytes(xs.shape, mix_seed(*key), dev, emap)
        y = seg._launch_dropout(xs, t_, key, emap)
        outs.append(y)
        check_band(torch.equal(y, om.bits8_dropout_f32(xs, mask, t_)),
                   f"{what}: the dropout kernel bit-equal to the plain banded mask")
        part = seg.split_stats(xs, t_, key, emap, plan)
        plain = om.segment_split_stats(xs, t_, mask)
        e = rel_elem(part.sum(dim=1), plain.sum(dim=1)) if h1 > h0 else float(
            part.abs().max())
        err["segment_split_stats"] = max(err["segment_split_stats"], (
            part.sum(dim=1) - plain.sum(dim=1)).abs().max().item())
        check_band(e <= 1e-9 and part.shape[1] == plan.slices,
                   f"{what}: K5-split stats' sums within 1e-9 relative ({e:.2e}), "
                   f"{plan.slices} slices")
        glob = part + 1.0        # stands for the other ranks' sums
        y2, stats = seg.split_apply(xs, gamma, beta, glob, n_global, t_, "elu", 1e-5, key,
                                    emap, None, None, 0.9)
        yp, sp = om.segment_split_apply(xs, gamma, beta, glob, n_global, t_, "elu", 1e-5, mask)
        local = seg.split_bwd_reduce(xs, gs, stats, t_, "elu", key, emap, plan)
        lp = om.segment_split_bwd_reduce(xs, gs, stats, t_, "elu", mask)
        got = seg.split_bwd_apply(xs, gs, gamma, stats, local, local + 1.0, n_global, t_,
                                  "elu", key, emap)
        ref = om.segment_split_bwd_apply(xs, gs, gamma, stats, local, local + 1.0, n_global,
                                         t_, "elu", mask)
        again = (seg.split_stats(xs, t_, key, emap, plan),
                 *seg.split_apply(xs, gamma, beta, glob, n_global, t_, "elu", 1e-5, key, emap,
                                  None, None, 0.9),
                 seg.split_bwd_reduce(xs, gs, stats, t_, "elu", key, emap, plan),
                 *seg.split_bwd_apply(xs, gs, gamma, stats, local, local + 1.0, n_global, t_,
                                      "elu", key, emap))
        check_band(all(torch.equal(a, b2) for a, b2 in zip((part, y2, stats, local, *got),
                                                            again)),
                   f"{what}: each split launch's relaunch bit-equal")
        if h1 > h0:
            e = rel_max(y2, yp)
            err["segment_split_apply"] = max(err["segment_split_apply"],
                                             (y2 - yp).abs().max().item())
            check_band(e <= 1e-5 and rel_elem(stats[:2], sp[:2]) <= 1e-6,
                       f"{what}: K5-split apply's y within 1e-5 of max|y| ({e:.2e})")
            e = rel_max(local.sum(dim=1), lp.sum(dim=1))
            err["segment_split_bwd_reduce"] = max(err["segment_split_bwd_reduce"], (
                local.sum(dim=1) - lp.sum(dim=1)).abs().max().item())
            check_band(e <= 1e-5, f"{what}: K5-bwd-split reduce's sums within 1e-5 ({e:.2e})")
            e = max(rel_max(a, r) for a, r in zip(got, ref))
            err["segment_split_bwd_apply"] = max(err["segment_split_bwd_apply"], *(
                (a - r).abs().max().item() for a, r in zip(got, ref)))
            check_band(e <= 1e-5 and torch.equal(got[0] == 0, ref[0] == 0),
                       f"{what}: K5-bwd-split apply's dx, dgamma, dbeta within 1e-5, dx 0 "
                       f"where the plain version's is ({e:.2e})")
        else:
            check_band(float(local.abs().max()) == 0.0 and got[0].numel() == 0
                       and rel_elem(stats[:2], sp[:2]) <= 1e-6,
                       f"{what}: the split launches of an empty band give zero sums and "
                       f"the global statistics")
    check_band(torch.equal(torch.cat(outs, dim=2), whole),
               f"S={n_space} [{b},{c},{h},{w}]: the bands' dropped outputs concatenated "
               f"bit-equal to the whole rows'")


# 25b's edge cases of the split launches: (what, [B, C, H, W], the rank's
# element map (plane, gplane, base), the bf16 instantiation too)
SPLIT_EDGES = (
    ("a rank's count not a multiple of 16, units of 1 (7x7)", (3, 5, 7, 7), (0, 0, 735), False),
    ("a rank's count not a multiple of 16, units of 4 (2x2)", (3, 5, 2, 2), (0, 0, 60), True),
    ("a 1-row band of a 2-row map (H W = 2)", (4, 6, 1, 2), (2, 4, 98), False),
    ("an empty band", (4, 6, 0, 2), (0, 4, 100), False),
    ("runs that start off a Philox group (bytes element by element)", (2, 8, 4, 4),
     (0, 0, 5), True),
    ("a band whose strips start off a group", (2, 8, 1, 16), (16, 48, 7), False),
)


def split_edge_checks(check_band, dev, g, err):
    """The four split launches at :data:`SPLIT_EDGES`, each against its
    plain version under the same element map (y and dx within 1e-5 of
    their max in fp32, 2^-8 in bf16; the sums 1e-9 relative forward, 1e-5
    of their max backward; the statistics 1e-6; dx 0 where the plain
    version's is), each relaunch bit-equal; this rank's sums plus one
    standing for the global ones."""
    import torch

    from lvae_tpu_torch.kernels import segment as seg
    from lvae_tpu_torch.ops import math as om
    from lvae_tpu_torch.ops.philox import ElementMap, dropout_bytes, mix_seed

    key = seg.Key(42, torch.tensor(7, dtype=torch.int64, device=dev), 3)
    t_ = om.bits8_keep_threshold(0.2)
    for what, shape, emap, bf16_too in SPLIT_EDGES:
        emap = ElementMap(*emap)
        b, c, h, w = shape
        x32 = torch.randn(shape, generator=g).to(dev) * 1.5 + 0.3
        g32 = torch.randn(shape, generator=g).to(dev)
        gamma = (torch.rand(c, generator=g) + 0.5).to(dev)
        beta = (torch.randn(c, generator=g) * 0.2).to(dev)
        mask = dropout_bytes(shape, mix_seed(*key), dev, emap)
        n_global = 2 * b * max(h, 1) * w
        for dtype in (torch.float32, torch.bfloat16) if bf16_too else (torch.float32,):
            x, gg = x32.to(dtype), g32.to(dtype)
            tol = 2 ** -8 if dtype == torch.bfloat16 else 1e-5
            name = f"{what} {list(shape)} {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
            part = seg.split_stats(x, t_, key, emap)
            plain = om.segment_split_stats(x, t_, mask)
            glob = part + 1.0
            y, stats = seg.split_apply(x, gamma, beta, glob, n_global, t_, "elu", 1e-5, key,
                                       emap, None, None, 0.9)
            yp, sp = om.segment_split_apply(x, gamma, beta, glob, n_global, t_, "elu", 1e-5,
                                            mask)
            local = seg.split_bwd_reduce(x, gg, stats, t_, "elu", key, emap)
            lp = om.segment_split_bwd_reduce(x, gg, stats, t_, "elu", mask)
            got = seg.split_bwd_apply(x, gg, gamma, stats, local, local + 1.0, n_global, t_,
                                      "elu", key, emap)
            ref = om.segment_split_bwd_apply(x, gg, gamma, stats, local, local + 1.0,
                                             n_global, t_, "elu", mask)
            if x.numel():
                e = (rel_elem(part.sum(dim=1), plain.sum(dim=1)),
                     rel_max(y.float(), yp.float()), rel_elem(stats[:2], sp[:2]),
                     rel_max(local.sum(dim=1), lp.sum(dim=1)),
                     max(rel_max(a.float(), r.float()) for a, r in zip(got, ref)))
                check_band(e[0] <= 1e-9 and e[1] <= tol and e[2] <= 1e-6 and e[3] <= 1e-5
                           and e[4] <= tol and torch.equal(got[0] == 0, ref[0] == 0),
                           f"{name}: the split launches against their plain versions (sums "
                           f"{e[0]:.1e}, y {e[1]:.1e}, stats {e[2]:.1e}, backward sums "
                           f"{e[3]:.1e}, dx dgamma dbeta {e[4]:.1e}; dx 0 where the plain "
                           f"version's is)")
                if dtype == torch.float32:
                    for k, a, r in (("segment_split_stats", part.sum(dim=1), plain.sum(dim=1)),
                                    ("segment_split_apply", y, yp),
                                    ("segment_split_bwd_reduce", local.sum(dim=1),
                                     lp.sum(dim=1)),
                                    ("segment_split_bwd_apply", got[0], ref[0])):
                        err[k] = max(err[k], (a - r).abs().max().item())
            else:
                check_band(float(part.abs().max()) == 0.0 and float(local.abs().max()) == 0.0
                           and rel_elem(stats[:2], sp[:2]) <= 1e-6,
                           f"{name}: zero sums and the global statistics")
            again = (seg.split_stats(x, t_, key, emap),
                     *seg.split_apply(x, gamma, beta, glob, n_global, t_, "elu", 1e-5, key,
                                      emap, None, None, 0.9),
                     seg.split_bwd_reduce(x, gg, stats, t_, "elu", key, emap),
                     *seg.split_bwd_apply(x, gg, gamma, stats, local, local + 1.0, n_global,
                                          t_, "elu", key, emap))
            check_band(all(torch.equal(a, b2) for a, b2 in zip((part, y, stats, local, *got),
                                                                again)),
                       f"{name}: each split launch's relaunch bit-equal")


def spatial_kernel_checks(card):
    """25b: the banded index map of K1, K1-bwd, K2, the dropout kernel and
    the split segments at every band shape of the flagship over 2 and 4
    ranks (the latents' 8, 4 and 2 rows, the segments' 32, 16, 8, 4 and 2;
    a 1-row and an empty band among them), against their plain versions,
    each split launch's relaunch bit-equal, and the split launches at
    :data:`SPLIT_EDGES`; then K1, K1-bwd, K2, the dropout kernel and the
    split launches (fp32 and bf16) timed at the widest band of the
    flagship's 2 x 2 layout, per call and on the device, beside the bound
    and the plain versions."""
    import torch

    from lvae_tpu_torch.kernels import segment as seg
    from lvae_tpu_torch.kernels import stochastic as sk
    from lvae_tpu_torch.ops import math as om
    from lvae_tpu_torch.ops.philox import Band, ElementMap, dropout_bytes, keyed_normal, mix_seed

    print("[25b] the banded kernels against their plain versions", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(25)
    err = {k: 0.0 for k in ("sample_kl", "sample_kl_per_sample", "sample_kl_per_sample_bwd",
                            "dropout", *SPLIT_NAMES)}
    n_checks = [0]

    def check_band(cond, what):
        check(cond, what)
        n_checks[0] += 1

    for n_space, b in ((2, 32), (4, 64)):       # a rank's rows at 2 x 2 and 1 x 4
        for layer, (h, w) in enumerate(((8, 8), (4, 4), (2, 2))):
            banded_k1_checks(check_band, dev, g, err, n_space, b, layer, h, w)
        for h in (32, 16, 8, 4, 2):
            banded_segment_checks(check_band, dev, g, err, n_space, 1, b, (b, 64, h, h))
    split_edge_checks(check_band, dev, g, err)
    print(f"  {n_checks[0]} checks of the banded kernels and the split launches' edge cases "
          f"pass  ({card})", flush=True)

    # timed at band 0 of the flagship at 2 x 2 (data index 1): its bottom
    # latent [32, 32, 4, 8] and its widest segment [32, 64, 16, 32]
    b, c, h, w = 32, 32, 8, 8
    bd = Band(h, 0)
    q = (torch.randn(b, 2 * c, h // 2, w, generator=g) * 0.7).to(dev)
    p = (torch.randn(b, 2 * c, h // 2, w, generator=g) * 0.7).to(dev)
    gz = torch.randn(b, c, h // 2, w, generator=g).to(dev)
    gkl = torch.randn(b, generator=g).to(dev)
    index = torch.randperm(50_000, generator=g)[:b].to(dev)
    keyed = sk.Keyed(index, 1234, 0, 0, bd)
    n = b * c * (h // 2) * w
    shape = (32, 64, 16, 32)
    x = torch.randn(shape, generator=g).to(dev)
    gx = torch.randn(shape, generator=g).to(dev)
    gamma = (torch.rand(64, generator=g) + 0.5).to(dev)
    beta = (torch.randn(64, generator=g) * 0.2).to(dev)
    key = seg.Key(42, torch.tensor(7, dtype=torch.int64, device=dev), 3)
    t_ = om.bits8_keep_threshold(0.2)
    emap = ElementMap(16 * 32, 32 * 32, 32 * 64 * 32 * 32)
    mask = dropout_bytes(shape, mix_seed(*key), dev, emap)
    m = int(np.prod(shape))
    plan = seg.split_plan(32, 64, 16, 32)
    part = seg.split_stats(x, t_, key, emap, plan)
    n_global = 2 * 32 * 32 * 32
    _, stats = seg.split_apply(x, gamma, beta, part, n_global, t_, "elu", 1e-5, key, emap,
                               None, None, 0.9)
    local = seg.split_bwd_reduce(x, gx, stats, t_, "elu", key, emap, plan)
    sums = local.numel() * 8
    # the bf16 instantiations on the same band (--precision bf16)
    xb, gxb = x.bfloat16(), gx.bfloat16()
    part_b = seg.split_stats(xb, t_, key, emap, plan)
    _, stats_b = seg.split_apply(xb, gamma, beta, part_b, n_global, t_, "elu", 1e-5, key,
                                 emap, None, None, 0.9)
    local_b = seg.split_bwd_reduce(xb, gxb, stats_b, t_, "elu", key, emap, plan)
    sums_b = local_b.numel() * 8
    calls = {
        "sample_kl": (
            lambda: sk.sample_kl(q, p, index, 1234, 0, 0, bd),
            lambda: sk._plain_sample_kl(q, p, index, 1234, 0, 0, bd),
            bound(24 * n + 8 * b, OPS_SAMPLE_KL * n), [b, 2 * c, h // 2, w]),
        "sample_kl_per_sample": (
            lambda: sk.sample_kl_per_sample(q, p, index, 1234, 0, 0, bd),
            lambda: sk._plain_sample_kl_per_sample(q, p, index, 1234, 0, 0, bd),
            bound(20 * n + 12 * b, OPS_SAMPLE_KL * n), [b, 2 * c, h // 2, w]),
        "sample_kl_per_sample_bwd": (
            lambda: sk.sample_kl_backward(q, p, gz, gkl, keyed=keyed),
            lambda: sk._plain_sample_kl_bwd(q, p, keyed_normal(gz.shape, 1234, index, 0, 0,
                                                               bd), gz, gkl),
            bound(36 * n + 12 * b, (OPS_SAMPLE_KL_BWD + OPS_SAMPLE_KL) * n),
            [b, 2 * c, h // 2, w]),
        "dropout": (lambda: seg._launch_dropout(x, t_, key, emap),
                    lambda: om.bits8_dropout_f32(x, dropout_bytes(shape, mix_seed(*key), dev,
                                                                  emap), t_),
                    bound(8 * m, OPS_SEGMENT * m), list(shape)),
        "segment_split_stats": (
            lambda: seg.split_stats(x, t_, key, emap, plan),
            lambda: om.segment_split_stats(x, t_, mask), bound(4 * m + sums, OPS_SEGMENT * m),
            list(shape)),
        "segment_split_apply": (
            lambda: seg.split_apply(x, gamma, beta, part, n_global, t_, "elu", 1e-5, key,
                                    emap, None, None, 0.9),
            lambda: om.segment_split_apply(x, gamma, beta, part, n_global, t_, "elu", 1e-5,
                                           mask),
            bound(8 * m + sums, OPS_SEGMENT * m), list(shape)),
        "segment_split_bwd_reduce": (
            lambda: seg.split_bwd_reduce(x, gx, stats, t_, "elu", key, emap, plan),
            lambda: om.segment_split_bwd_reduce(x, gx, stats, t_, "elu", mask),
            bound(8 * m + sums, OPS_SEGMENT * m), list(shape)),
        "segment_split_bwd_apply": (
            lambda: seg.split_bwd_apply(x, gx, gamma, stats, local, part, n_global, t_, "elu",
                                        key, emap),
            lambda: om.segment_split_bwd_apply(x, gx, gamma, stats, local, part, n_global, t_,
                                               "elu", mask),
            bound(12 * m + 2 * sums, OPS_SEGMENT * m), list(shape)),
        "segment_split_stats[bf16]": (
            lambda: seg.split_stats(xb, t_, key, emap, plan),
            lambda: om.segment_split_stats(xb, t_, mask),
            bound(2 * m + sums_b, OPS_SEGMENT * m), list(shape)),
        "segment_split_apply[bf16]": (
            lambda: seg.split_apply(xb, gamma, beta, part_b, n_global, t_, "elu", 1e-5, key,
                                    emap, None, None, 0.9),
            lambda: om.segment_split_apply(xb, gamma, beta, part_b, n_global, t_, "elu", 1e-5,
                                           mask),
            bound(4 * m + sums_b, OPS_SEGMENT * m), list(shape)),
        "segment_split_bwd_reduce[bf16]": (
            lambda: seg.split_bwd_reduce(xb, gxb, stats_b, t_, "elu", key, emap, plan),
            lambda: om.segment_split_bwd_reduce(xb, gxb, stats_b, t_, "elu", mask),
            bound(4 * m + sums_b, OPS_SEGMENT * m), list(shape)),
        "segment_split_bwd_apply[bf16]": (
            lambda: seg.split_bwd_apply(xb, gxb, gamma, stats_b, local_b, part_b, n_global, t_,
                                        "elu", key, emap),
            lambda: om.segment_split_bwd_apply(xb, gxb, gamma, stats_b, local_b, part_b,
                                               n_global, t_, "elu", mask),
            bound(6 * m + 2 * sums_b, OPS_SEGMENT * m), list(shape)),
    }
    times = {}
    for name, (kern, plain, bnd, shp) in calls.items():
        times[name] = {"ms": cuda_ms(kern, 50), "plain_ms": cuda_ms(plain, 10),
                       "device_ms": device_ms(kern, 20), "plain_device_ms": device_ms(plain, 5),
                       "bound_ms": bnd[0], "bound_by": bnd[1], "shape": shp,
                       "max_abs_err": err.get(name, "checked at the edge shapes (bf16)")}
        r = times[name]
        print(f"  time banded {name} {shp}: per call kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms; device: kernel {fmt_ms(r['device_ms'])}, plain "
              f"{fmt_ms(r['plain_device_ms'])}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  ({card})", flush=True)
    return {"checks": n_checks[0], "max_abs_err": err, "times": times}


def spatial_rank(spec_path):
    """One rank of 25a or 25c, started by :func:`spatial_cli` through
    ``multihost.launch``: ``lvae_tpu_torch.main.main(argv)`` as under
    ``torchrun`` (it joins the launcher's group with its space axis,
    trains and leaves it), every launch count set to 0 just before and read
    just after; the halo exchanges (``mesh._exchange``, the one
    all-reduce of each exchange, forward and backward) counted and, where
    the spec says ``timed``, timed on the host with the card synchronised
    around each. Writes ``rank<r>.pt`` beside the spec."""
    import torch

    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    halo = {"calls": 0, "s": 0.0, "bytes": 0}
    orig = mesh._exchange

    def timed(t, group):
        if spec["timed"]:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(t, group)
        if spec["timed"]:
            torch.cuda.synchronize()
            halo["s"] += time.perf_counter() - t0
        halo["calls"] += 1
        halo["bytes"] += t.numel() * t.element_size()
        return out

    mesh._exchange = timed
    build.reset_launches()
    try:
        with counted_all_reduces() as ar:
            trainer = train_main.main(spec["argv"])
        torch.cuda.synchronize()
    finally:
        mesh._exchange = orig
    layout = trainer.exp.layout
    out = {"rank": rank, "launches": {k: v for k, v in build.LAUNCHES.items() if v},
           "all_reduces": ar["calls"], "halo": halo, "history": trainer.logger.history,
           "backend": layout.backend, "run_dir": trainer.run_dir,
           "layout": [layout.n_data, layout.n_space, layout.data, layout.space]}
    torch.save(out, os.path.join(os.path.dirname(spec_path), f"rank{rank}.pt"))
    return 0


def spatial_cli(card, tag, args, data_dir, n_data, n_space, steps, tmp, expect=(),
                beside=None):
    """One banded run through the command a user types, its ranks started
    here as ``torchrun`` starts them (:func:`spatial_rank`): ``main ...
    --num-data-shards n_data --spatial-shards n_space`` for ``steps``
    steps with a log line a step and, at the end, the test sweep and a
    checkpoint; against ``main`` on one rank in this process with the same
    flags. Checks each rank's layout and launches (every kernel of
    ``SPATIAL_PATH`` and ``expect``, no one-launch K5), the ranks' logged
    metrics equal to each other and, within 1e-5 relative, to the one
    rank's, and the checkpoint's parameters and statistics within Adamax's
    bound of the one rank's (``graft_entry_torch.dryrun_multichip``'s
    rule). ``beside`` (a callable) runs in this process while the ranks
    run, its result returned beside the run's; the halo exchanges are then
    counted but not timed. The ranks' spec and results go in a directory
    of ``tmp`` of their own, so that another run may go on beside. Returns
    ``(run, beside's result)``."""
    import threading

    import torch

    import graft_entry_torch as ge
    from lvae_tpu_torch import main as train_main
    from lvae_tpu_torch.parallel import multihost
    from lvae_tpu_torch.train.checkpoint import CheckpointManager

    world = n_data * n_space
    runs = os.path.join(tmp, f"runs_{tag}")
    base = args + ["--fused", "all", "--device", "cuda", "--data-dir", data_dir,
                   "--output-dir", runs, "--log-interval", "1", "--test-interval", str(steps),
                   "--checkpoint-interval", str(steps), "--max-steps", str(steps)]
    argv = base + ["--run-name", "sp", "--num-data-shards", str(n_data), "--spatial-shards",
                   str(n_space)]
    work = os.path.join(tmp, "ranks_" + tag.replace(" ", "_"))
    os.makedirs(work)
    spec = os.path.join(work, "spec.json")
    with open(spec, "w") as f:
        json.dump({"argv": argv, "timed": beside is None}, f)
    box = {}

    def launch_ranks():
        t0 = time.perf_counter()
        try:
            box["code"] = multihost.launch([sys.executable, os.path.abspath(__file__),
                                            "--spatial-rank", spec], world, 300)
        except TimeoutError as e:
            box["error"] = e
        box["wall"] = time.perf_counter() - t0

    thread = threading.Thread(target=launch_ranks)
    thread.start()
    try:
        beside_out = beside() if beside is not None else None
    finally:
        thread.join()
    if "error" in box:
        raise SmokeFailure(f"25 {tag}: {box['error']}") from box["error"]
    code, wall = box["code"], box["wall"]
    check(code == 0, f"25 {tag}: the {world} ranks of main ended with code 0 ({code})")
    t0 = time.perf_counter()
    one = train_main.main(base + ["--run-name", "one"])
    one_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    for r in ranks:
        got = r["launches"]
        check(r["layout"] == [n_data, n_space, r["rank"] // n_space, r["rank"] % n_space]
              and r["backend"] == "gloo",
              f"25 {tag} rank {r['rank']}: data index {r['rank'] // n_space} of {n_data}, "
              f"space index {r['rank'] % n_space} of {n_space}, gloo ({r['layout']})")
        check(all(got.get(k, 0) > 0 for k in (*SPATIAL_PATH, *expect))
              and not any(got.get(k, 0) for k in ("segment", "segment_bwd")),
              f"25 {tag} rank {r['rank']}: main launched the banded kernels "
              f"({', '.join((*SPATIAL_PATH, *expect))}) and no one-launch K5 ({got})")
        check(r["halo"]["calls"] > 0, f"25 {tag} rank {r['rank']}: halo exchanges ran "
                                      f"({r['halo']['calls']})")

    def metrics(hist):
        return [(kind, step, {k: float(np.asarray(v, dtype=np.float64).sum())
                              for k, v in m.items() if k not in ("images_per_sec", "wall_s")})
                for kind, step, m in hist]

    mine, ref = metrics(ranks[0]["history"]), metrics(one.logger.history)
    check(all(metrics(r["history"]) == mine for r in ranks[1:]),
          f"25 {tag}: every rank logged the same metrics")
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                for (_, _, a), (_, _, b) in zip(mine, ref) for k in b)
    check([m[:2] for m in mine] == [m[:2] for m in ref] and worst <= 1e-5,
          f"25 {tag}: the logged train and test metrics within 1e-5 relative of one rank's "
          f"({len(mine)} lines, worst {worst:.2e})")
    got = CheckpointManager(ranks[0]["run_dir"]).load(steps)["model"]
    want = CheckpointManager(one.run_dir).load(steps)["model"]
    diff = torch.cat([(got[k].double() - v.double()).abs().reshape(-1) for k, v in
                      want.items() if v.is_floating_point()])
    lr = 3e-4
    far = float((diff > 1e-4).double().mean())
    check(float(diff.max()) <= 2 * lr * steps and far <= ge.FAR_SHARE,
          f"25 {tag}: the checkpoint's parameters and statistics within 2 lr a step of one "
          f"rank's, {far:.2e} of them beyond 1e-4 (at most {ge.FAR_SHARE:g}; max "
          f"{float(diff.max()):.2e})")
    halo = ranks[0]["halo"]
    out = {"wall_s": wall, "one_rank_s": one_s, "launches": [r["launches"] for r in ranks],
           "all_reduces": ranks[0]["all_reduces"],
           "halo_per_step": halo["calls"] / steps,
           "halo_ms_per_step": halo["s"] * 1e3 / steps if beside is None else None,
           "halo_mb_per_step": halo["bytes"] / 1e6 / steps, "metrics_worst_rel": worst,
           "param_max_diff": float(diff.max()), "param_share_beyond_1e4": far,
           "loss": [m["loss"] for kind, _, m in mine if kind == "train"],
           "loss_one_rank": [m["loss"] for kind, _, m in ref if kind == "train"]}
    timing = ("not timed (run beside another phase)" if beside is not None else
              f"{out['halo_ms_per_step']:.1f} ms a step (gloo, the ranks sharing one card; "
              f"host clock, card synchronised around each)")
    print(f"  25 {tag}: {world} ranks {wall:.1f} s (start included; one rank {one_s:.1f} s); "
          f"rank 0: {out['halo_per_step']:.0f} halo exchanges a step, "
          f"{out['halo_mb_per_step']:.2f} MB a step, {timing}; losses {out['loss']} vs one "
          f"rank {out['loss_one_rank']}  ({card})", flush=True)
    return out, beside_out


def spatial_dryrun(card):
    """25a's 2 x 2 half: ``graft_entry_torch.dryrun_multichip(4)`` at its
    default layout for an even count, ``(data, space)`` = 2 x 2 (as
    ``__graft_entry__.py:112-140``), four gloo ranks sharing this card,
    each on its band of its half of the flagship's global batch of 64 at
    full width and depth (z 32-32-32, 64 filters, 4 blocks a layer,
    dropout 0.2) under ``--fused all``: 3 steps held against one rank's (losses 1e-5
    relative; parameters within 2 lr a step, all but FAR_SHARE of them
    1e-4), the sharded evaluate, the checkpoint round trip, K3 on each
    rank's rows; rank 0's launches checked."""
    import graft_entry_torch as ge

    print("[25a] dryrun_multichip(4): 2 x 2, gloo ranks sharing the card", flush=True)
    t0 = time.perf_counter()
    try:
        r = ge.dryrun_multichip(4, device="cuda", flagship=True, timeout_s=240)
    except RuntimeError as e:
        raise SmokeFailure(f"dryrun_multichip(4) on the card failed ({e}); its ranks' output "
                           f"is above") from e
    check(r["backend"] == "gloo" and r["spatial"] == 2 and r["size"] == 4,
          f"the dry run's group: gloo, 4 ranks, a space axis of 2 ({r['backend']}, "
          f"{r['size']}, {r['spatial']})")
    launches = r["launches"]
    check(all(launches.get(n, 0) > 0 for n in SPATIAL_PATH)
          and not any(launches.get(n, 0) for n in ("segment", "segment_bwd")),
          f"rank 0's 3 steps launched the banded kernels (the split segments, K1, K1-bwd and "
          f"the dropout kernel) and no one-launch K5 ({launches})")
    check(r["one_rank"]["launches"].get("segment", 0) > 0
          and not any(r["one_rank"]["launches"].get(n, 0) for n in SPLIT_NAMES),
          "the one-rank run took the one-launch K5 and no split launch")
    print(f"  rank 0 after 3 steps vs one rank: parameters within {r['param_max_diff']:.2e}, "
          f"{r['param_share_beyond_1e4']:.2e} of the elements beyond 1e-4 (at most "
          f"{ge.FAR_SHARE:g}); losses {r['losses']} vs {r['one_rank']['losses']}; "
          f"{time.perf_counter() - t0:.1f} s (the ranks' wall {r['wall_s']:.1f} s)  ({card})",
          flush=True)
    return {"launches": [launches], "wall_s": r["wall_s"], "loss": r["losses"],
            "loss_one_rank": r["one_rank"]["losses"], "param_max_diff": r["param_max_diff"],
            "param_share_beyond_1e4": r["param_share_beyond_1e4"], "eval": r["eval"],
            "entry": "graft_entry_torch.dryrun_multichip(4)"}


def phase_spatial(card, train_u8, test_u8, c_train, c_test):
    """Phase 25, ``--spatial-shards``: (a) the README's flagship at full
    width and depth (64 filters, 4 blocks a layer, batch 64, dropout 0.2),
    fp32, ``--fused all``, 3 steps against one rank at 2 x 2 through
    ``graft_entry_torch.dryrun_multichip(4)`` (:func:`spatial_dryrun`) and
    at 1 x 4 through ``main`` (the 2-row top leaves two ranks empty
    bands), gloo ranks sharing the card; (b)
    :func:`spatial_kernel_checks`; (c) celeba64 at 1 x 2 for
    SPATIAL_CELEBA_STEPS steps through ``main``, so that K3 and K3-bwd run
    on bands. The three runs go on side by side: 25c's ranks and 25a's 1 x
    4 ranks run while this process runs the 2 x 2 dry run (their halo
    exchanges counted, not timed)."""
    print("[25] height sharding (--spatial-shards)", flush=True)
    out = {"runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        celeba_dir = os.path.join(tmp, "celeba")
        write_celeba(celeba_dir, c_train[:SPATIAL_TRAIN], c_test[:SPATIAL_TEST])
        flagship_dir = os.path.join(tmp, "mnist")
        write_mnist(flagship_dir, train_u8[:SPATIAL_TRAIN], test_u8[:SPATIAL_TEST])

        def flagship_1x4():
            print("[25a] flagship 1x4: main --num-data-shards 1 --spatial-shards 4, its "
                  "ranks beside the 2 x 2 dry run", flush=True)
            return spatial_cli(card, "flagship 1x4", FLAGSHIP_ARGS, flagship_dir, 1, 4,
                               SPATIAL_STEPS, tmp, beside=lambda: spatial_dryrun(card))

        print("[25c] celeba64 1x2: K3 and K3-bwd on bands, its ranks beside 25a's", flush=True)
        out["runs"]["celeba64 1x2"], (out["runs"]["flagship 1x4"], out["runs"]["flagship 2x2"]) \
            = spatial_cli(card, "celeba64 1x2", CELEBA_ARGS, celeba_dir, 1, 2,
                          SPATIAL_CELEBA_STEPS, tmp, expect=("mix_log_prob", "mix_log_prob_bwd"),
                          beside=flagship_1x4)
        print(f"  25a and 25c side by side took {time.perf_counter() - t0:.1f} s", flush=True)
        t1 = time.perf_counter()
        out["kernels"] = spatial_kernel_checks(card)
        print(f"  25b took {time.perf_counter() - t1:.1f} s; phase 25 "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
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

    def lap(what):
        print(f"  [{what} at {time.perf_counter() - t0:.1f} s]", flush=True)

    build_log = phase_build()
    res = {"card": card}
    lap("phase 2")
    k2_err, k2_t, k2_b, res["hw_tests"] = phase_sample_kl(card)
    lap("phase 3")
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
    lap("phase 6")
    t6 = time.perf_counter()
    k1_err, k1_t, k1_host = phase_k1(card, build_log=build_log)
    bwd_err, bwd_t = phase_bwd(card)
    print(f"  phases 6-7 took {time.perf_counter() - t6:.1f} s")
    train_u8, test_u8 = train_data()
    lap("phase 8")
    # phase 8's data and run stay until phase 24 (inside 23c) exports the run
    keep8 = tempfile.TemporaryDirectory()
    tr = phase_train(card, train_u8, test_u8, keep8.name)
    res.update(train_run={k: tr[k] for k in ("wall_s", "log_rates", "log_rate_late",
                                            "test_elbo", "ema_loss")})
    flagship_weights = flagship_model(torch.device("cpu")).state_dict()
    lap("phase 9")
    res.update(phase_step(
        card, "[9] one step: the kernel path vs the plain path and the CPU; train "
        "images/s", FLAGSHIP_ARGS, flagship_dataset(train_u8, test_u8), flagship_weights,
        TRAIN_B, AB_STEPS, AB_LOG))
    lap("phase 10")
    mix_err, mix_t, mix_more = phase_mixture(card, build_log)
    res["mixture"] = mix_more
    c_all = rgb_blobs(CELEBA_N_TRAIN + CELEBA_N_TEST, seed=12)
    c_train, c_test = c_all[:CELEBA_N_TRAIN], c_all[CELEBA_N_TRAIN:]
    c_data = celeba_dataset(c_train, c_test)
    cev = phase_celeba_eval(card, c_train, c_test)
    lap("phase 12")
    kernels[1]["launches_celeba64"] = cev["launches"]["logsumexp"]
    ctr = phase_celeba_train(card, c_train, c_test)
    celeba_weights = seeded_model(CELEBA, c_data, torch.device("cpu")).state_dict()
    lap("phase 13")
    cst = phase_step(
        card, "[13] one celeba64 step: the kernel path vs the plain path and the CPU; "
        "train images/s", CELEBA_ARGS, c_data, celeba_weights, 16, AB_STEPS, AB_LOG)
    res["celeba64"] = {
        "images_per_sec": cev["rates"], "elbo_profile": cev["elbo_profile"],
        "train_run": {k: ctr[k] for k in ("wall_s", "log_rates", "log_rate_late",
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
    lap("phase 14")
    t14 = time.perf_counter()
    seg_err, seg_t, seg_steps, seg_more = phase_segment(card, per_step, timed, build_log)
    drop_err, drop_t = phase_dropout(card, [s for c in per_step.values() for s in c])
    print(f"  phase 14 took {time.perf_counter() - t14:.1f} s")
    res["segment_paths"] = {f"{list(shape)} {path}": row
                            for (shape, path), row in seg_more["by_path"].items()}
    res["segment_host_ms"] = seg_more["host_ms"]
    res["segment_ptxas"] = seg_more["ptxas"]
    lap("phase 15")
    csg = phase_celeba_segments(card, c_train, c_test, ctr)
    res["celeba64"]["segments_run"] = {k: csg[k] for k in ("wall_s", "log_rates", "test_elbo",
                                                           "ema_loss", "segments_per_step")}
    lap("phase 16")
    res["celeba64"]["segments_step"] = phase_step(
        card, "[16a] one celeba64 step: --fused all vs pallas on the card and vs the CPU; "
        "train images/s", CELEBA_ARGS, c_data, celeba_weights, 16, AB_STEPS, AB_LOG,
        paths=("all", "pallas"), card_dropout=0.0, cpu=("all", 0.2))
    res["segments_step"] = phase_step(
        card, "[16b] one flagship step: --fused all vs stochastic on the card; train "
        "images/s", FLAGSHIP_ARGS, flagship_dataset(train_u8, test_u8), flagship_weights,
        None, AB_STEPS, AB_LOG, paths=("all", "stochastic"), card_dropout=0.0)
    lap("phase 17")
    res["steps_per_call"] = phase_graph(card, train_u8, test_u8, flagship_weights, c_data,
                                        celeba_weights)
    lap("phase 18")
    # celeba64's bf16 run stays until phase 20 exports it
    keep = tempfile.TemporaryDirectory()
    b16_err, b16_t, res["bf16"] = phase_bf16(card, per_step, timed, build_log, train_u8,
                                             test_u8, flagship_weights, c_train, c_test,
                                             c_data, celeba_weights, keep.name)

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
         mix_t[("K3", CELEBA_B)],
         {"plan": f"V={mix_more['plans'][f'[{CELEBA_B},100,64,64] C=3 K={K_MIX}']['fwd_v']}"}),
        ("mix_log_prob_bwd", "lvae_tpu/kernels/mixture_pallas.py:338", mix_err["bwd"],
         mix_t[("K3-bwd", CELEBA_B)],
         {"plan": "{default} V={v}".format(
             **mix_more["plans"][f"[{CELEBA_B},100,64,64] C=3 K={K_MIX}"]),
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
    b16_runs = res["bf16"]["runs"]
    mix16 = f"[{CELEBA_B},100,64,64] C=3 K={K_MIX}"
    for name, source, replaces, run, e, t in (
        ("segment[bf16]", "segment.cu", "lvae_tpu/kernels/segment_pallas.py:291",
         "celeba64 all", b16_err["segment"], b16_t[f"K5 {list(timed[0])}"]),
        ("segment_bwd[bf16]", "segment.cu", "lvae_tpu/kernels/segment_pallas.py:318",
         "celeba64 all", b16_err["segment_bwd"], b16_t[f"K5-bwd {list(timed[0])}"]),
        ("dropout_bits8[bf16]", "segment.cu", "lvae_tpu/models/blocks.py:86 (FastDropout: "
         "jax.random bits, no pl.pallas_call)", "flagship auto", b16_err["dropout"],
         b16_t[f"dropout {list(timed[0])}"]),
        ("mix_log_prob[bf16]", "mixture.cu", "lvae_tpu/kernels/mixture_pallas.py:323",
         "celeba64 auto", b16_err["mix"], b16_t[f"K3 {mix16}"]),
        ("mix_log_prob_bwd[bf16]", "mixture.cu", "lvae_tpu/kernels/mixture_pallas.py:338",
         "celeba64 auto", b16_err["mix_bwd"], b16_t[f"K3-bwd {mix16} one_pass"]),
    ):
        counter = name.replace("dropout_bits8", "dropout")
        more = {}
        if name == "mix_log_prob_bwd[bf16]":
            plan = mix_more["plans"][mix16]
            more = {"plan": f"{plan['default']} V={plan['v']}", "cifar10_deep_shape": {
                key: v for key, v in b16_t.items() if "32,32] C=3" in key}}
        kernels.append(entry(
            name, source, replaces, b16_runs[run]["launches"][counter], e,
            [t[k] for k in ("ms", "plain_ms", "device_ms", "plain_device_ms")],
            (t["bound_ms"], t["bound_by"]), None, fp32_ms=t["fp32_ms"],
            fp32_device_ms=t["fp32_device_ms"], storage="bf16",
            path=f"lvae_tpu_torch.main --precision bf16 ({run})", **more))
    # phase 20's export of celeba64's bf16 run runs beside phase 19
    celeba = start_celeba_export(res["bf16"]["runs"]["celeba64 all"].pop("run_dir"))
    lap("phase 19")
    c_err, cifar = phase_cifar(card)
    res["cifar10_deep"] = cifar
    # each kernel at cifar10-deep's shapes (19a), and its launches on the
    # phase's two paths: the training run (19b, less the init's) and
    # evaluate --load (19d)
    train_l = {k: v - cifar["train"]["init_launches"].get(k, 0)
               for k, v in cifar["train"]["launches"].items()}
    eval_l = cifar["eval"]["launches"]
    at_cifar = {"sample_kl": ("K2", "k2"), "sample_kl_per_sample": ("K1", "k1"),
                "sample_kl_per_sample_bwd": ("K1-bwd", "k1_bwd"),
                "mix_log_prob": ("K3 fp32 B=128", "mix"),
                "mix_log_prob_bwd": ("K3-bwd fp32", "mix_bwd"),
                "segment": ("K5 fp32", "segment"), "segment_bwd": ("K5-bwd fp32", "segment_bwd"),
                "dropout_bits8": ("dropout fp32", "dropout"),
                "segment[bf16]": ("K5 bf16", "segment"),
                "segment_bwd[bf16]": ("K5-bwd bf16", "segment_bwd"),
                "dropout_bits8[bf16]": ("dropout bf16", "dropout"),
                "mix_log_prob[bf16]": ("K3 bf16 B=128", "mix"),
                "mix_log_prob_bwd[bf16]": ("K3-bwd bf16", "mix_bwd")}
    for kern in kernels:
        counter = kern["name"].replace("dropout_bits8", "dropout")
        row = {"launches_train": train_l.get(counter, 0),
               "launches_evaluate": eval_l.get(counter, 0)}
        if kern["name"] in at_cifar:
            tkey, ekey = at_cifar[kern["name"]]
            row.update(cifar["kernel_times"][tkey], max_abs_err=c_err.get(ekey))
            if tkey.startswith("K3 "):
                row["eval_batch"] = cifar["kernel_times"][tkey.replace("B=128",
                                                                       f"B={CIFAR_EVAL_B}")]
        else:
            row["times"] = "not measured at cifar10-deep's shapes" + (
                f"; phase 3's [{IW_SAMPLES}, {CELEBA_EVAL_B}] is its IW shape"
                if kern["name"] == "logsumexp" else "")
        kern["cifar10_deep"] = row
    lap("phase 20")
    with keep:
        mo = phase_multiobject(card, celeba)
    res["multiobject"] = mo
    # each kernel's launches on phase 20's paths: the multi-dSprites
    # training run (20a, less the init's), evaluate (20b), the eager
    # serving path the artifacts were held to (20c); none inside the
    # artifacts, which hold aten operators only
    for kern in kernels:
        counter = kern["name"].replace("dropout_bits8", "dropout")
        kern.update(launches_multiobject_train=mo["train"]["launches"].get(counter, 0),
                    launches_multiobject_evaluate=mo["eval"]["launches"].get(counter, 0),
                    launches_multiobject_eager_serving=mo["serve"]["eager_launches"]
                    ["kernels"].get(counter, 0),
                    launches_in_artifacts=0)
    lap("phase 21")
    st = phase_streaming(card, train_u8, test_u8, c_train, c_test, c_data, celeba_weights)
    res["streaming"] = st
    # each kernel's launches on phase 21's main paths: celeba64's streamed
    # run through main (21b) and the flagship's (21d), the init's left out
    for kern in kernels:
        counter = kern["name"].replace("dropout_bits8", "dropout")
        kern.update(launches_streaming_train=st["cli"]["launches"].get(counter, 0),
                    launches_streaming_flagship=st["flagship"]["launches"].get(counter, 0))
    lap("phase 22")
    ms = phase_measure(card, c_train, c_test)
    res["measure"] = {k: v for k, v in ms.items() if k != "iw_launches"}
    # each kernel's launches in 22a's five bench runs and 22d's four IW sweeps
    for kern in kernels:
        counter = kern["name"].replace("dropout_bits8", "dropout")
        kern.update(launches_bench=sum(r["launches"].get(counter, 0)
                                       for r in ms["bench"].values()),
                    launches_iw_sweep=ms["iw_launches"].get(counter, 0))
    lap("phase 23")

    def phase_24():
        # beside 23c's resume and evaluate commands (subprocesses)
        print("  [phase 24, beside 23c's last two commands]", flush=True)
        return phase_checkpoint(card, tr["run_dir"], tr["data_dir"])

    with keep8:
        par = phase_parallel(card, train_u8, test_u8, flagship_weights, beside=phase_24)
    ck = par.pop("beside")
    res["parallel"] = {k: v for k, v in par.items() if k != "split"}
    res["parallel"]["split_shapes"] = par["split"]["shapes"]
    # each kernel's launches on 23c's main run (each rank) and in 23a's
    # one-rank NCCL run (its warm-up call: a replay counts what it holds)
    main_ranks = par["cli"]["launches"]
    for kern in kernels:
        counter = kern["name"].replace("dropout_bits8", "dropout")
        kern.update(launches_parallel_main=[r.get(counter, 0) for r in main_ranks],
                    launches_one_rank_nccl=par["one_rank_nccl"]["launches"].get(counter, 0))
    split = par["split"]
    for counter, label in SPLIT_NAMES.items():
        t = split["times"][counter]
        kernels.append(entry(
            label, "segment.cu",
            "lvae_tpu/kernels/segment_pallas.py:" + ("291" if "bwd" not in counter else "318")
            + " over a batch sharded on the data mesh (the cross-shard reduction XLA's "
              "partitioner adds)",
            main_ranks[0].get(counter, 0), split["max_abs_err"][counter],
            [t[k] for k in ("ms", "plain_ms", "device_ms", "plain_device_ms")],
            (t["bound_ms"], t["bound_by"]), None,
            launches_parallel_main=[r.get(counter, 0) for r in main_ranks],
            shapes=f"rank 0's {t['shape']}, rate 0.2, elu, 2 ranks (the flagship's global "
                   f"batch of 64)",
            path=f"lvae_tpu_torch.main --num-data-shards {PARALLEL_RANKS} --fused all (23c, "
                 f"rank 0: launches); every --spatial-shards run of phase 25"))
    res["checkpoint"] = {k: v for k, v in ck.items() if k != "launches"}
    # each kernel's launches on phase 24's two main paths: evaluate --load
    # <imported> and main --load <imported> --rng-impl rbg
    for kern in kernels:
        counter = kern["name"].replace("dropout_bits8", "dropout")
        kern.update(
            launches_checkpoint_evaluate=ck["launches"]["evaluate_imported"].get(counter, 0),
            launches_checkpoint_train=ck["launches"]["main_rbg"].get(counter, 0))
    lap("phase 25")
    sp = phase_spatial(card, train_u8, test_u8, c_train, c_test)
    res["spatial"] = {"runs": {tag: {k: v for k, v in run.items() if k != "launches"}
                               for tag, run in sp["runs"].items()},
                      "kernel_checks": sp["kernels"]["checks"]}
    # each kernel's launches on phase 25's main paths (each rank of 25a's
    # flagship runs and of 25c's celeba64 run), and the banded launches
    # checked and timed in 25b
    counters = {label: counter for counter, label in SPLIT_NAMES.items()}
    banded = sp["kernels"]["times"]
    for kern in kernels:
        counter = counters.get(kern["name"], kern["name"].replace("dropout_bits8", "dropout"))
        kern["launches_spatial"] = {tag: [r.get(counter, 0) for r in run["launches"]]
                                    for tag, run in sp["runs"].items()}
        if counter in banded:
            kern["banded"] = {**banded[counter], "path": "25b: band 0 of the flagship at 2 x 2"}
        if f"{counter}[bf16]" in banded:
            kern["banded_bf16"] = {**banded[f"{counter}[bf16]"],
                                   "path": "25b: band 0 of the flagship at 2 x 2, bf16"}
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels, **res}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--parallel-rank":      # a rank of 23c
        sys.exit(parallel_rank(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--spatial-rank":       # a rank of 25a, 25c
        sys.exit(spatial_rank(sys.argv[2]))
    sys.exit(main())
