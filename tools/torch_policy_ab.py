#!/usr/bin/env python3
"""A/B of the port's provisional defaults on one card, in turns.

    python tools/torch_policy_ab.py [--steps 16] [--json ab.json]

- ``--fused``: ``python -m lvae_tpu_torch.bench`` (in process, through
  ``main(argv)``) at each preset and precision, ``auto`` against ``all``,
  and for mnist ``segments`` too; the variants of a cell run in turns
  (a, b, b, a; a, b, c, c, b, a), each ``--steps`` calls of 8 steps after 2
  warm-up calls.
- ``--logsumexp`` and ``--iw-chunk``: one batch of the IW-LL sweep
  (``lvae_tpu_torch.iwll_probe.iw_sweep``: ``evaluate_iwll``, k = 100,
  under the profiler) on ``iwll_probe.iw_cells``, the cells of
  ``chip_smoke.py`` phase 22d (the flagship at B = 1,000 and celeba64 at
  B = 500, seeded weights, fp32 and bf16): ``kernel`` against ``streaming`` at chunk 1, then chunk 1, 4 and
  10 with the kernel, each set in turns.

Prints each run and, per cell and variant, the median and the spread
(max - min) of its runs beside the card's name and power limit;
``--json`` writes them. It changes no default: the decision is recorded
in ROADMAP.md.
"""

import argparse
import contextlib
import io
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FUSED_CELLS = [(p, q) for p in ("mnist", "celeba64", "cifar10-deep") for q in ("fp32", "bf16")]
CHUNKS = (1, 4, 10)


def in_turns(variants):
    return list(variants) + list(reversed(variants))


def summary(runs):
    return {"median": float(np.median(runs)), "spread": float(max(runs) - min(runs)),
            "runs": runs}


def fused_ab(card, steps):
    from lvae_tpu_torch import bench

    out = {}
    for preset, precision in FUSED_CELLS:
        variants = ("auto", "all", "segments") if preset == "mnist" else ("auto", "all")
        runs = {v: [] for v in variants}
        for fused in in_turns(variants):
            with contextlib.redirect_stdout(io.StringIO()):
                r = bench.main(["--preset", preset, "--precision", precision, "--fused", fused,
                                "--steps", str(steps), "--warmup", "2"])
            runs[fused].append(r["value"])
            print(f"  bench {preset} {precision} --fused {fused}: {r['value']:.1f} img/s, "
                  f"mfu {r['mfu']:.4f}, of the {precision} peak {r['mfu_precision_peak']:.4f}",
                  flush=True)
        for fused, values in runs.items():
            out[f"{preset} {precision} {fused}"] = summary(values)
            s = out[f"{preset} {precision} {fused}"]
            print(f"{preset} {precision} --fused {fused}: median {s['median']:.1f} img/s, "
                  f"spread {s['spread']:.1f} ({card})", flush=True)
    return out


def iw_ab(card):
    import torch

    from lvae_tpu_torch.iwll_probe import iw_cells, iw_sweep, seeded_model

    dev = torch.device("cuda")
    cells = iw_cells()
    out = {}
    for name, (config, meta, test, pre, dims, batch) in cells.items():
        test_dev = torch.from_numpy(test).to(dev)
        for precision in ("fp32", "bf16"):
            model = seeded_model(dict(config, precision=precision), meta, dev)
            for label, variants, kw in (
                    ("logsumexp", ("kernel", "streaming"), lambda v: {"logsumexp": v}),
                    ("chunk", CHUNKS, lambda v: {"chunk": v})):
                runs = {v: [] for v in variants}
                for v in in_turns(variants):
                    r = iw_sweep(model, test_dev, pre, dims, batch, **kw(v))
                    runs[v].append(r)
                    print(f"  IW {name} {precision} B={batch} {label} {v}: wall "
                          f"{r['wall_ms']:.1f} ms, device busy {r['device_busy_ms']:.1f} ms, "
                          f"idle {r['idle_share']:.3f}, {r['images_per_sec']:.1f} img/s, IW-LL "
                          f"{r['iw_ll']:.4f}", flush=True)
                for v, rs in runs.items():
                    key = f"{name} {precision} {label} {v}"
                    out[key] = {"images_per_sec": summary([r["images_per_sec"] for r in rs]),
                                "idle_share": summary([r["idle_share"] for r in rs]),
                                "iw_ll": [r["iw_ll"] for r in rs]}
                    s = out[key]["images_per_sec"]
                    print(f"IW {key}: median {s['median']:.1f} img/s, spread "
                          f"{s['spread']:.1f}, idle share median "
                          f"{out[key]['idle_share']['median']:.3f} ({card})", flush=True)
            del model
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=16, help="timed calls of 8 steps a bench run")
    p.add_argument("--json", default=None, help="write the medians and runs here")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible: the A/B is the card's")
    from lvae_tpu_torch.profiling import card_line

    card = card_line()
    print(f"card: {card}", flush=True)
    res = {"card": card, "fused": fused_ab(card, args.steps), "iw": iw_ab(card)}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
