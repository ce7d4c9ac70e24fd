"""Profile the bench's train step on the card and print where the device
time goes (the twin of ``tools/profile_step.py``).

    python -m lvae_tpu_torch.profile_step [--preset celeba64]
        [--precision bf16] [--steps-per-call 8] [--steps 16] [--top 30]
        [--out trace.json]

The model is the bench's (:func:`lvae_tpu_torch.bench.bench_config`, so
:func:`~lvae_tpu_torch.data.registry.bench_preset`'s data): three warm
calls, then ``--steps`` steps (whole calls of ``--steps-per-call``, one
CUDA graph each when it is above 1) under ``torch.profiler``. It prints
the device's busy time (the union of the kernels' intervals), the idle
share of the window and the top kernels by total time, grouped by name.
The profiler was seen to drop the events of the ctypes-launched kernels
from a trace: each kernel's events are held against its nodes in a CUDA
graph of the same call (:func:`~lvae_tpu_torch.profiling.kernel_names`,
matched by demangled name), up to three traces are taken, and where any
kernel is short of its nodes the table is printed as partial, with the
kernels short and both counts, whatever the total. ``--out`` writes the
Chrome trace. The TPU tool's tables by XLA fusion category and spatial
stage have no counterpart: a CUDA kernel's name carries no shape.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from lvae_tpu_torch.config import RNG_IMPLS

TRIES = 3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="profile the bench's train step on the card")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: 256 (mnist, cifar10-deep) / 128 (celeba64)")
    p.add_argument("--preset", default="mnist", choices=["mnist", "celeba64", "cifar10-deep"])
    p.add_argument("--steps", type=int, default=6,
                   help="steps profiled, rounded up to whole calls")
    p.add_argument("--steps-per-call", type=int, default=1)
    p.add_argument("--fused", default="auto",
                   choices=["auto", "none", "stochastic", "mixture", "pallas", "segments",
                            "all"])
    p.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--rng-impl", default="threefry", choices=list(RNG_IMPLS),
                   help="both values run the port's one keyed Philox stream")
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--n-filters", type=int, default=64)
    p.add_argument("--blocks-per-layer", type=int, default=2)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--out", default=None, help="write the Chrome trace to this file")
    p.add_argument("--device", default="cuda", choices=["cuda"],
                   help="the profile is the card's; there is no CPU run")
    return p


def held(nodes: dict, table: dict):
    """Each kernel's events (``table``: :func:`~lvae_tpu_torch.profiling.
    by_name`) against its graph nodes (``nodes``: {demangled name:
    [symbol, nodes]}): ``(short, extra)``, {name: (events, nodes)} of the
    kernels with fewer events than nodes, and of those with more (copies
    and memsets have no kernel nodes and are left out). The table is whole
    only where ``short`` is empty, whatever the totals."""
    def events(name):
        return table.get(name, (0, 0))[0]

    def count(name):
        return nodes.get(name, (None, 0))[1]

    short = {name: (events(name), n) for name, (_, n) in nodes.items() if events(name) < n}
    extra = {name: (n, count(name)) for name, (n, _) in table.items()
             if n > count(name) and not name.startswith(("Memcpy", "Memset"))}
    return short, extra


def main(argv=None) -> dict:
    """Profile; print the summary and return it."""
    from lvae_tpu_torch import bench
    from lvae_tpu_torch.profiling import (by_name, card_line, device_spans,
                                          graph_kernel_names, kernel_names, union)
    from lvae_tpu_torch.train.state import MultiStep, train_step
    from lvae_tpu_torch.train.trainer import Experiment
    from torch.profiler import ProfilerActivity, profile

    args = build_parser().parse_args(argv)
    b_args = bench.parse_args([
        "--preset", args.preset, "--fused", args.fused, "--precision", args.precision,
        "--n-filters", str(args.n_filters), "--blocks-per-layer", str(args.blocks_per_layer),
        "--steps-per-call", str(args.steps_per_call),
        *(["--batch-size", str(args.batch_size)] if args.batch_size else [])])
    cfg, data = bench.bench_config(b_args)
    cfg = dataclasses.replace(cfg, dropout=args.dropout, rng_impl=args.rng_impl)
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible; the profile is the "
                         "card's and never falls back to the CPU")
    device = torch.device("cuda")
    exp = Experiment(cfg, device, data)
    state = exp.init_state()
    k = b_args.steps_per_call
    index = torch.arange(b_args.batch_size, device=device)
    if k > 1:
        multi = MultiStep(state, exp.train_data.gather, exp.loss_cfg, k)
        stack = index.expand(k, -1).contiguous()

        def call():
            return multi(stack)
    else:
        def call():
            return train_step(state, exp.train_data.gather(index), index, exp.loss_cfg)

    for _ in range(3):
        metrics = call()
    float(metrics["elbo"])
    symbols = (kernel_names(multi.graph.raw_cuda_graph()) if k > 1
               else graph_kernel_names(call))
    calls = -(-args.steps // k)
    steps = calls * k
    nodes = {}                                  # {demangled name: [symbol, nodes]}
    for sym, n in symbols.items():
        nodes.setdefault(torch._C._demangle(sym), [sym, 0])[1] += n * calls
    want = sum(n for _, n in nodes.values())

    for attempt in range(1, TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                metrics = call()
            float(metrics["elbo"])
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_spans(prof)
        table = by_name(events)
        short, extra = held(nodes, table)
        if not short:
            break
    busy_ms = union(sorted((a, b) for _, a, b in events)) / 1e6
    n_kernels = sum(n for name, (n, _) in table.items()
                    if not name.startswith(("Memcpy", "Memset")))
    total_ms = sum(ns for _, ns in table.values()) / 1e6
    complete = not short
    card = card_line()

    if args.out:
        prof.export_chrome_trace(args.out)
        print(f"trace: {args.out}")
    print(f"card: {card}")
    print(f"{args.preset} {args.precision} --fused {args.fused}, batch {b_args.batch_size}, "
          f"{steps} steps in {calls} call(s) of {k}{' (CUDA graph)' if k > 1 else ''}")
    print(f"device busy {busy_ms / steps:.3f} ms/step (union of the kernels), kernel sum "
          f"{total_ms / steps:.3f} ms/step, wall {wall_ms / steps:.3f} ms/step, idle share "
          f"{1.0 - busy_ms / wall_ms:.3f}")
    print(f"kernel events: {n_kernels} in trace {attempt} of {TRIES}; kernel nodes of a graph "
          f"of the call: {want // calls} x {calls} call(s) = {want}, {len(nodes)} kernels")
    if not complete:
        print(f"PARTIAL: {len(short)} kernel(s) short of their nodes (events, nodes): "
              + "; ".join(f"{name[:60]} {e}/{n}" for name, (e, n) in sorted(short.items())[:8])
              + "; the table below and the busy time miss their events")
    if extra:
        print(f"{len(extra)} kernel(s) with more events than nodes (events, nodes): "
              + "; ".join(f"{name[:60]} {e}/{n}" for name, (e, n) in
                          sorted(extra.items(), key=lambda kv: kv[1][1] - kv[1][0])[:8]))
    print(f"-- top kernels{'' if complete else ' (PARTIAL)'} --\n"
          f"{'kernel':<70} {'ms/step':>9} {'%':>6} {'calls/step':>10} {'nodes/step':>10}")
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:args.top]
    for name, (n, ns) in top:
        print(f"{name[:70]:<70} {ns / 1e6 / steps:9.4f} {100 * ns / 1e6 / total_ms:6.2f} "
              f"{n / steps:10.2f} {nodes.get(name, (None, 0))[1] / steps:10.2f}")
    kernels = {name: {"symbol": sym, "nodes": n, "events": table.get(name, (0, 0))[0],
                      "ms": table.get(name, (0, 0))[1] / 1e6}
               for name, (sym, n) in nodes.items()}
    return {"card": card, "steps": steps, "calls": calls, "device_busy_ms_per_step":
            busy_ms / steps, "kernel_sum_ms_per_step": total_ms / steps,
            "wall_ms_per_step": wall_ms / steps, "idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_events": n_kernels, "kernel_nodes": want, "complete": complete,
            "short": short, "extra": extra, "kernels": kernels,
            "top": [(name, ns / 1e6 / steps, n / steps) for name, (n, ns) in top]}


if __name__ == "__main__":
    main()
