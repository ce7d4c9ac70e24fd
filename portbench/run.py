"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Builds the cell's model and data from the
seed through the port (``lvae_tpu_torch``), warms every shape the cell's
traffic uses, measures for ``--seconds``, checks the outputs against the
plain reference (``portbench/reference``) and prints one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read
from a ``torch.profiler`` trace of the window), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also end standard error.

Exits 2 without a CUDA device (or fewer than the cell asks for), and 1
without the program (``lvae_tpu_torch``) beside it or if ``jax``,
``jaxlib``, ``flax`` or ``lvae_tpu`` was imported; none prints a result.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

T_START = time.perf_counter()

if __name__ == "__main__":
    # Python's bytecode of the program and its libraries, cached inside the
    # checkout at a fixed path: where the installation holds none or may
    # not write it, every run would compile the ~900 modules it imports
    # (5 s and more of set-up on the chip's host); the first run writes them
    sys.pycache_prefix = str(Path.cwd() / "build" / "pycache")
    sys.dont_write_bytecode = False

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402

import torch  # noqa: E402

from portbench import drive, spec, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lvae_tpu")


class ForbiddenImport(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card (or why
    there is none)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def measure(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
            t_start: float, log=print) -> dict:
    """One run of ``cell`` on ``device``: the result line's dict."""
    from lvae_tpu_torch.kernels import build

    cuda = torch.device(device).type == "cuda"
    kind = drive.KINDS[cell.traffic["kind"]](cell, seed, device)
    kind.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    before = dict(build.LAUNCHES)
    recorder = trace.Recorder(cuda) if traced else None
    if recorder is not None:
        recorder.start()
    w = kind.window(seconds)
    results = recorder.stop() if recorder is not None else None
    launches = {k: n - before.get(k, 0) for k, n in build.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"loaded during the run: {found}")
    t = time.perf_counter()
    spans = trace.device_spans(results) if results is not None else []
    del results
    if traced:
        log(f"portbench: {len(spans)} device events read in {time.perf_counter() - t:.3f} s")
    kind.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = kind.numbers(kind.reference())
    log(f"portbench: the reference and the comparison took {time.perf_counter() - t:.3f} s")

    card = card_line() if cuda else "cpu"
    log(f"portbench: {cell.name} seed {seed}: {w['attempted']} attempted in "
        f"{w['seconds']:.3f} s, set-up {setup_s:.3f} s, peak {peak} B ({card})")
    last = t_start
    for what, t in kind.laps:
        log(f"portbench: set-up {t - last:.3f} s: {what}")
        last = t
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if traced:
        busy = trace.union_ns(spans) / 1e9
        ctx = drive.Context(cell.name, cell.config, cell.traffic, kind.rows,
                            w["images"] / w["seconds"], w["seconds"], spans, launches,
                            kind.flops_per_image())
        for m in cell.per_layer:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        values = {"setup_s": setup_s, **kind.end_to_end(w, peak)}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    checks, correct = {}, w["failed"] == 0
    for name, v in numbers.items():
        if name not in cell.limits:
            raise KeyError(f"limits/{cell.name}.json has no limit for {name!r}")
        limit = cell.limits[name]          # None: read, not held
        correct = correct and math.isfinite(v) and (limit is None or v <= limit)
        checks[name] = {"value": v if math.isfinite(v) else None, "limit": limit}
    out = {"correct": bool(correct), "attempted": w["attempted"], "failed": w["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name() if cuda else "cpu",
                      "count": cell.chips, "memory_peak_bytes": peak}}
    if traced:
        out["device"].update(busy_s=busy, window_s=w["seconds"])
        out["breakdown"] = trace.breakdown(spans)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload, Path.cwd())
    if importlib.util.find_spec("lvae_tpu_torch") is None:
        print(f"portbench: no lvae_tpu_torch under {Path.cwd()}: run from the root of a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        out = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START, log)
    except ForbiddenImport as e:
        log(f"portbench: {e}")
        return 1
    found = forbidden_modules()
    if found:
        log(f"portbench: loaded after the window: {found}")
        return 1
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
