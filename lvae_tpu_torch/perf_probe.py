"""Ablation probe of the train step's time on the card (the twin of
``tools/perf_probe.py``).

    python -m lvae_tpu_torch.perf_probe [--batch-size 2048] [--iters 6]
        [--precision bf16]

Times, on the flagship (the bench's ``mnist`` preset: z 32-32-32, 2 blocks
a layer, 64 filters, gated, skip, learned top prior, dropout 0.2, free
bits 0.5) at the probe's batch, each with :func:`~lvae_tpu_torch.
profiling.timed` (the clock stops once a value of the last call is on
the host): the full eager train step, the forward alone (train mode, no
gradient), the forward with the backward, the six ablations of
``tools/perf_probe.py:133-140`` (no dropout, no BatchNorm, neither, no
gate, ``--remat``, ``--fused stochastic``) and a straw man of 12 3x3
64-channel convs at 16x16, forward, as ``F.conv2d`` + ELU. TF/s is each
leg's FLOPs, counted by ``FlopCounterMode`` over one call of the leg as
run (the remat leg's recompute included), over its time. The TPU tool's
GB/s column is dropped with the bench's bytes, and its ``--trace`` with
it: ``python -m lvae_tpu_torch.profile_step`` traces the step.

``--device cpu`` runs the same legs on the CPU for the tests; its times
are the CPU's.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

ABLATIONS = [
    ("no dropout", dict(dropout=0.0)),
    ("no batchnorm", dict(batchnorm=False)),
    ("no dropout + no bn", dict(dropout=0.0, batchnorm=False)),
    ("no gate", dict(gated=False)),
    ("remat", dict(remat=True)),
    ("fused stochastic", dict(fused="stochastic")),
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ablation probe of the train step on the card")
    p.add_argument("--batch-size", type=int, default=2048)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--n-filters", type=int, default=64)
    p.add_argument("--blocks-per-layer", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda needs a visible card; cpu is for the tests")
    return p


def count_flops(fn) -> float:
    """FLOPs of one call of ``fn`` (convolutions and matmuls)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def report(name: str, sec: float, batch: int, flops: float) -> dict:
    row = {"ms": sec * 1e3, "images_per_sec": batch / sec, "tflops": flops / sec / 1e12}
    print(f"{name:<38} {row['ms']:8.2f} ms  {row['images_per_sec']:9.0f} img/s  "
          f"{row['tflops']:6.2f} TF/s", flush=True)
    return row


def main(argv=None) -> dict:
    """Time every leg; print a line each and return ``{leg: {ms,
    images_per_sec, tflops}}``."""
    from lvae_tpu_torch import bench
    from lvae_tpu_torch.models.stochastic import Noise
    from lvae_tpu_torch.profiling import timed
    from lvae_tpu_torch.train.state import train_step
    from lvae_tpu_torch.train.trainer import Experiment

    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible; the probe never falls "
                         "back to the CPU")
    device, b = torch.device(args.device), args.batch_size
    b_args = bench.parse_args([
        "--preset", "mnist", "--batch-size", str(b), "--precision", args.precision,
        "--n-filters", str(args.n_filters), "--blocks-per-layer", str(args.blocks_per_layer)])
    cfg, data = bench.bench_config(b_args)
    name = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    print(f"device: {name}  batch {b}  precision {args.precision}", flush=True)
    index = torch.arange(b, device=device)
    legs = {}

    def step_leg(label, exp, state):
        def step():
            return train_step(state, exp.train_data.gather(index), index, exp.loss_cfg)["elbo"]
        flops = count_flops(step)
        legs[label] = report(label, timed(step, args.iters), b, flops)

    exp = Experiment(cfg, device, data)
    state = exp.init_state()
    step_leg("train step (full)", exp, state)

    model = state.model
    x = torch.from_numpy((np.random.default_rng(1).uniform(size=(b, 28, 28, 1)) < 0.5)
                         .astype(np.float32)).to(device)
    noise = Noise(0, index, 0)

    def objective():
        out = model(x, noise=noise, train=True)
        return out["ll"].mean() - out["kl_sep"].sum()

    def fwd():
        with torch.no_grad():
            return objective()

    params = [p for p in model.parameters() if p.requires_grad]

    def fwd_bwd():
        return torch.autograd.grad(objective(), params)[0]

    # counted with autograd on: FlopCounterMode's module tracker fails on
    # a module forward under no_grad; the forward's FLOPs are the same
    legs["forward only"] = report("forward only", timed(fwd, args.iters), b,
                                  count_flops(objective))
    legs["forward + backward"] = report("forward + backward", timed(fwd_bwd, args.iters), b,
                                        count_flops(fwd_bwd))
    del exp, state, model, params

    for label, over in ABLATIONS:
        e2 = Experiment(dataclasses.replace(cfg, **over), device, data)
        step_leg(f"train step ({label})", e2, e2.init_state())
        del e2

    # how fast can convs of the model's dominant shape class go here? 12
    # 3x3 64->64 convs at 16x16, forward
    dt = torch.bfloat16 if args.precision == "bf16" else torch.float32
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(12, 64, 64, 3, 3)) * 0.05
                         ).to(device, dt)
    xc = torch.from_numpy(np.random.default_rng(3).normal(size=(b, 64, 16, 16))).to(device, dt)

    def conv_stack():
        y = xc
        for i in range(12):
            y = F.elu(F.conv2d(y, w[i], padding=1))
        return y.float().mean()

    with torch.no_grad():
        legs["12x conv3x3 64ch @16x16 fwd"] = report(
            "12x conv3x3 64ch @16x16 fwd", timed(conv_stack, args.iters), b,
            count_flops(conv_stack))
    return legs


if __name__ == "__main__":
    main()
