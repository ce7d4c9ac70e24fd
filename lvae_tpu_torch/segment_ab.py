"""The split segment launches (K5-split's stats and apply, K5-bwd-split's
reduce and apply) of this checkout against those of another checkout of
the repository, on one card and in turns; and the SASS of both builds'
split kernels.

    python -m lvae_tpu_torch.segment_ab --other <checkout> [--json out.json]

The other checkout's kernels are built from its own ``csrc/`` by its own
``kernels/build.py`` (into its own ``build/``, ``mixture_ab.load_build``)
and called through its C entry, as are this checkout's: both without the
Python wrappers, each launch timed as a CUDA graph of ``--calls`` launches
replayed ``--replays`` times (``mixture_ab.graph_ms``: device ms a call,
no host cost), in the order other, this, this, other. Each build runs its
own plan: this checkout's ``kernels/segment.py`` ``split_plan``; an entry
that takes no thread count runs the earlier design's (a block of 256
threads per 2,048 elements of a channel, at most 64 slices). Between the turns this
checkout also runs half and twice its plan's slices once each. Shapes: a
flagship rank's widest segment at R = 2, [32,64,32,32], and a celeba64
rank's, [64,64,64,64], in fp32 and bf16, each the second of two data
ranks' rows; and the banded [32,64,16,32], band 0 of data index 1 at 2 x 2,
with its element map; rate 0.2, elu. Each build's outputs are held to the
other's: the sums 1e-9 relative, y and dx 1e-5 of their max (fp32; bf16
2^-8, one rounding of the fp32 value), dgamma and dbeta 1e-5, dx zero
where the other's is. ``cuobjdump -sass`` counts each split kernel's
instructions (static counts: where they sit, in a loop or once a block,
the source says): in all, its global loads by width (bits), the 64-bit
integer divisions (``I2F.U64.RP`` / ``I2F.S64.RP``, the reciprocal seed of
each), the other divisions by a run-time integer (``I2F.U32.RP``), the
subroutine calls (``CALL``: divisions' and fp64 square roots' slow paths)
and ``IMAD.HI`` (Philox's multiply-high). Needs the card, ``nvcc`` and
``cuobjdump``.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict

import torch

from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.kernels import segment as seg
from lvae_tpu_torch.mixture_ab import graph_ms, load_build
from lvae_tpu_torch.ops.math import bits8_keep_threshold
from lvae_tpu_torch.ops.philox import ElementMap
from lvae_tpu_torch.profiling import card_line

# (label, [B, C, H, W], the element map): the second of two data ranks'
# rows of the flagship's and celeba64's widest segment, and band 0 of data
# index 1 of the flagship's at 2 x 2 (chip_smoke.py 25b's timed band)
SHAPES = [("flagship rank, R = 2", (32, 64, 32, 32), ElementMap(base=32 * 64 * 32 * 32)),
          ("celeba64 rank, R = 2", (64, 64, 64, 64), ElementMap(base=64 * 64 * 64 * 64)),
          ("flagship band 0 of 2 x 2", (32, 64, 16, 32),
           ElementMap(16 * 32, 32 * 32, 32 * 64 * 32 * 32))]
N_GLOBAL_RANKS = 2                   # n_global = 2 B H W: two ranks of each shape's rows
RATE, SEED, SITE, STEP = 0.2, 42, 3, 7
LAUNCHES = ("stats", "apply", "bwd_reduce", "bwd_apply")


def old_plan(b: int, h: int, w: int) -> seg.SplitPlan:
    """The earlier design's slices (8 elements a thread of 256, at most
    64), for a build whose entry takes no thread count."""
    return seg.SplitPlan(max(1, min(64, -(-b * h * w // (256 * 8)))), 256)


class Side:
    """One build's four launches through its C entry, with its own plan."""

    def __init__(self, mod):
        self.lib = mod.library()
        self.takes_threads = len(mod._SIGNATURES["lvae_segment_split"]) == 32

    def plan(self, b: int, c: int, h: int, w: int) -> seg.SplitPlan:
        return seg.split_plan(b, c, h, w) if self.takes_threads else old_plan(b, h, w)

    def launch(self, which: int, x, plan: seg.SplitPlan, emap: ElementMap, step, *, g=None,
               gamma=None, beta=None, part=None, local=None, out_part=None, stats=None,
               y=None, dgb=None, n_global=1):
        b, c, h, w = x.shape
        ptr = lambda v: None if v is None else v.data_ptr()      # noqa: E731
        t = bits8_keep_threshold(RATE)
        status = self.lib.lvae_segment_split(
            which, x.data_ptr(), ptr(g), ptr(gamma), ptr(beta), ptr(part), ptr(local),
            ptr(out_part), None, None, ptr(stats), ptr(y), ptr(dgb), b, c, h * w, plan.slices,
            *((plan.threads,) if self.takes_threads else ()), build.esize(x.dtype), t, 0,
            float(n_global), 1e-5, 0.9, 0.1, SEED, SITE, step.data_ptr(), *emap,
            torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"lvae_segment_split({which}) returned {status}")

    def run(self, ops, plan: seg.SplitPlan) -> Dict[str, Callable]:
        """{launch: a call of it} on ``ops`` (x, g, gamma, beta, the step,
        the map, n_global), each run once, their outputs in ``ops["out"]``;
        the apply launches read this side's own sums doubled (two ranks'
        alike) as the global ones."""
        x, g, gamma, beta, step, emap, n = (ops[k] for k in ("x", "g", "gamma", "beta",
                                                              "step", "emap", "n_global"))
        c, dev = x.shape[1], x.device
        o = {"part": torch.empty(2, plan.slices, c, dtype=torch.float64, device=dev),
             "local": torch.empty(2, plan.slices, c, dtype=torch.float64, device=dev),
             "y": torch.empty_like(x), "dx": torch.empty_like(x),
             "stats": torch.empty(5, c, device=dev), "dgb": torch.empty(2, c, device=dev)}
        calls = {
            "stats": lambda: self.launch(0, x, plan, emap, step, out_part=o["part"]),
            "apply": lambda: self.launch(1, x, plan, emap, step, gamma=gamma, beta=beta,
                                         part=o["glob"], stats=o["stats"], y=o["y"],
                                         n_global=n),
            "bwd_reduce": lambda: self.launch(2, x, plan, emap, step, g=g, stats=o["stats"],
                                              out_part=o["local"]),
            "bwd_apply": lambda: self.launch(3, x, plan, emap, step, g=g, gamma=gamma,
                                             part=o["glob_bwd"], local=o["local"],
                                             stats=o["stats"], y=o["dx"], dgb=o["dgb"],
                                             n_global=n)}
        calls["stats"]()
        o["glob"] = o["part"] * N_GLOBAL_RANKS
        calls["apply"]()
        calls["bwd_reduce"]()
        o["glob_bwd"] = o["local"] * N_GLOBAL_RANKS
        calls["bwd_apply"]()
        torch.cuda.synchronize()
        ops["out"] = o
        return calls


def operands(shape, emap, dtype, gen):
    dev = torch.device("cuda")
    b, c, h, w = shape
    x = torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3
    g = torch.randn(shape, generator=gen, device=dev)
    gamma = torch.rand(c, generator=gen, device=dev) + 0.5
    beta = torch.randn(c, generator=gen, device=dev) * 0.2
    hg = h if emap.plane == 0 else emap.gplane // w
    return {"x": x.to(dtype), "g": g.to(dtype), "gamma": gamma, "beta": beta,
            "step": torch.tensor(STEP, dtype=torch.int64, device=dev), "emap": emap,
            "n_global": N_GLOBAL_RANKS * b * hg * w}


def held(a: dict, b: dict, bf16: bool, what: str) -> dict:
    """The largest gaps of one build's outputs to the other's, each checked
    against its tolerance."""
    rel = lambda u, v: ((u.double() - v.double()).abs().max()                     # noqa: E731
                        / v.double().abs().max().clamp_min(1e-30)).item()
    sums = lambda p: p.sum(dim=1)                                                  # noqa: E731
    gaps = {"sums": ((sums(a["part"]) - sums(b["part"])).abs()
                     / sums(b["part"]).abs().clamp_min(1.0)).max().item(),
            "y": rel(a["y"], b["y"]), "stats": rel(a["stats"][:2], b["stats"][:2]),
            "bwd_sums": rel(sums(a["local"]), sums(b["local"])),
            "dx": rel(a["dx"], b["dx"]), "dgb": rel(a["dgb"], b["dgb"])}
    limits = {"sums": 1e-9, "y": 2 ** -8 if bf16 else 1e-5, "stats": 1e-6, "bwd_sums": 1e-5,
              "dx": 2 ** -8 if bf16 else 1e-5, "dgb": 1e-5}
    bad = [f"{k} {gaps[k]:.2e} > {limits[k]:.0e}" for k in gaps if not gaps[k] <= limits[k]]
    if not torch.equal(a["dx"] == 0, b["dx"] == 0):
        bad.append("dx zero at other elements")
    if bad:
        raise RuntimeError(f"{what}: this build's outputs off the other's: {', '.join(bad)}")
    return gaps


# a kernel's name in cuobjdump's listing: split_<launch>_kernel and its
# template arguments (the mangled form, e.g. IfLi16ELi0EE)
_SPLIT = re.compile(r"(split_\w+?_kernel)I(\w+?)EEvN")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(lib: Path) -> Dict[str, dict]:
    """{kernel<template arguments>: {"total", "LDG" (by width in bits),
    "div64", "div32", "calls", "IMAD_HI", "opcodes"}} from ``cuobjdump
    -sass`` of a built library (NOPs left out)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    out, ins = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = _SPLIT.search(line)
            ins = out.setdefault(f"{m[1]}<{m[2]}>", []) if m else None
        elif ins is not None:
            m = _INSTR.search(line)
            if m and m[1] != "NOP":
                ins.append(m[1])
    return {name: _counts(ins) for name, ins in out.items()}


def _width(op: str) -> int:
    for bits in (128, 64):
        if f".{bits}" in op:
            return bits
    return 16 if ".U16" in op or ".S16" in op else 8 if ".U8" in op or ".S8" in op else 32


def _counts(ins) -> dict:
    ops = collections.Counter(ins)
    ldg = collections.Counter(_width(op) for op in ins if op.startswith("LDG"))
    count = lambda *prefixes: sum(n for op, n in ops.items()                    # noqa: E731
                                  if op.startswith(prefixes))
    return {"total": len(ins), "LDG": dict(sorted(ldg.items())),
            "div64": count("I2F.U64.RP", "I2F.S64.RP"), "div32": count("I2F.U32.RP"),
            "calls": count("CALL"), "IMAD_HI": count("IMAD.HI"),
            "opcodes": dict(ops.most_common())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout (e.g. the parent commit's git archive)")
    ap.add_argument("--json", type=Path, help="write every number here")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--replays", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("segment_ab: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}")
    other_mod = load_build(args.other.resolve())
    libs = {"other": other_mod.build()[0], "this": build.build()[0]}
    sides = {"other": Side(other_mod), "this": Side(build)}
    result = {"card": card, "sass": {}, "times": []}
    for side, lib in libs.items():
        result["sass"][side] = sass_counts(lib)
        for name, c in sorted(result["sass"][side].items()):
            print(f"  sass {side} {name}: {c['total']} instructions, LDG by bits {c['LDG']}, "
                  f"64-bit divisions {c['div64']}, 32-bit {c['div32']}, CALL {c['calls']}, "
                  f"IMAD.HI {c['IMAD_HI']}")
    gen = torch.Generator(device="cuda").manual_seed(19)
    for label, shape, emap in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            b, c, h, w = shape
            name = f"{label} {list(shape)} {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
            ops = {"other": operands(shape, emap, dtype, gen)}
            ops["this"] = dict(ops["other"])          # the same tensors, outputs of its own
            plans = {s: sides[s].plan(b, c, h, w) for s in sides}
            calls = {s: sides[s].run(ops[s], plans[s]) for s in sides}
            gaps = held(ops["this"]["out"], ops["other"]["out"], dtype == torch.bfloat16, name)
            row = {"shape": name, "plans": {s: plans[s]._asdict() for s in sides},
                   "all_reduce_bytes": {s: 2 * plans[s].slices * c * 8 for s in sides},
                   "gaps": gaps, "other_ms": {}, "this_ms": {}, "sweep_ms": {}}
            for launch in LAUNCHES:
                t = {"other": [], "this": []}
                for s in ("other", "this"):
                    t[s].append(graph_ms(calls[s][launch], args.calls, args.replays))
                for factor in (0.5, 2):
                    p = plans["this"]._replace(
                        slices=max(1, min(65535, int(plans["this"].slices * factor))))
                    alt = dict(ops["this"])
                    run = sides["this"].run(alt, p)
                    row["sweep_ms"].setdefault(launch, {})[f"slices {p.slices}"] = graph_ms(
                        run[launch], args.calls, args.replays)
                for s in ("this", "other"):
                    t[s].append(graph_ms(calls[s][launch], args.calls, args.replays))
                row["other_ms"][launch], row["this_ms"][launch] = t["other"], t["this"]
            result["times"].append(row)
            print(f"  {name}: plans {row['plans']}, sums all-reduced "
                  f"{row['all_reduce_bytes']} B; gaps "
                  + ", ".join(f"{k} {v:.1e}" for k, v in gaps.items()), flush=True)
            for launch in LAUNCHES:
                o, th = row["other_ms"][launch], row["this_ms"][launch]
                print(f"    {launch}: other {o[0]:.4f} / {o[1]:.4f} ms, this {th[0]:.4f} / "
                      f"{th[1]:.4f} ms ({sum(o) / sum(th):.2f}x); this at "
                      + ", ".join(f"{k} {v:.4f}" for k, v in row["sweep_ms"][launch].items())
                      + f"  ({card})", flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
