"""The segment kernels of this checkout against those of another checkout
of the repository, on one card and in turns; and the SASS of both builds'
kernels. A ``python -m`` tool for a machine with the card, not a phase of
``chip_smoke.py``.

    python -m lvae_tpu_torch.segment_ab --other <checkout> [--kernels split|segment]
        [--shapes 128x64x64x64 ...] [--json out.json]

``--kernels segment``: the one-launch K5 and K5-bwd (``fwd_kernel``,
``bwd_kernel``) at every segment shape of the models (celeba64's
[128,64,s,s] for s = 64 ... 2, which holds cifar10-deep's, and the
flagship's [64,64,s,s] for s = 32 ... 2), fp32 and bf16, both directions,
rate 0.2, elu. Each build runs its own plan (its checkout's
``kernels/segment.py`` ``_plan``) through its C entry, each launch timed
as a CUDA graph of ``--calls`` launches (``mixture_ab.graph_ms``) in the
order other, this, this, other; between the turns this checkout also
runs each variant its ``plan_variants`` names once. Both backwards take
the other build's statistics. The outputs are held to the other build's
at ``chip_smoke.py`` phase 18a's tolerances: bf16 y and dx within one
bf16 ulp, fp32 y and dx 1e-5 of their max, mean and var 1e-6 relative
(of max(|v|, 1)), dgamma and dbeta 1e-5 of their max, dx zero where the
other's is; a relaunch of this build bit-equal. ``cuobjdump -sass``
counts each ``fwd_kernel`` / ``bwd_kernel``'s instructions: in all,
F2F.F64.F32, DADD, DFMA, MUFU, CALL, and the global and shared loads by
width; ``-Xptxas -v`` gives their registers and spills. As context only,
not a yardstick (it computes no dropout),
cuDNN's ``F.batch_norm(training=True)`` then ``F.elu`` is timed at rate 0
at the same shapes.

``--kernels split`` (the default): the split segment launches
(K5-split's stats and apply, K5-bwd-split's reduce and apply), as below.

The other checkout's kernels are built from its own ``csrc/`` by its own
``kernels/build.py`` (into its own ``build/``, ``mixture_ab.load_kernels``)
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
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.kernels import segment as seg
from lvae_tpu_torch.mixture_ab import _width, graph_ms, load_kernels
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


def _counts(ins) -> dict:
    ops = collections.Counter(ins)
    ldg = collections.Counter(_width(op) for op in ins if op.startswith("LDG"))
    count = lambda *prefixes: sum(n for op, n in ops.items()                    # noqa: E731
                                  if op.startswith(prefixes))
    return {"total": len(ins), "LDG": dict(sorted(ldg.items())),
            "div64": count("I2F.U64.RP", "I2F.S64.RP"), "div32": count("I2F.U32.RP"),
            "calls": count("CALL"), "IMAD_HI": count("IMAD.HI"),
            "opcodes": dict(ops.most_common())}


# ---------------------------------------------------------------------------
# --kernels segment: the one-launch K5 and K5-bwd
# ---------------------------------------------------------------------------

# every segment shape of celeba64 (B = 128; cifar10-deep's are its 32x32 and
# below) and of the flagship (B = 64), largest first
SEGMENT_SHAPES = [(128, 64, s, s) for s in (64, 32, 16, 8, 4, 2)] + \
                 [(64, 64, s, s) for s in (32, 16, 8, 4, 2)]
DIRECTIONS = ("fwd", "bwd")


def plan_variants(plan: "seg.Plan", shape, direction: str, esize: int) -> Dict[str, "seg.Plan"]:
    """This checkout's other launches of ``shape``: each path the plan can
    be forced to where it differs, the default at half and twice its
    threads (a thread count sets no bits of the result) and at half and
    twice its cluster (``kernels/segment.py`` ``_layout``: another sum
    order)."""
    out = {}
    for path in seg.PATHS:
        try:
            forced = seg._plan(*shape, direction, path, esize)
        except ValueError:
            continue
        if forced != plan:
            out[path] = forced
    for factor in (0.5, 2):
        threads = int(plan.threads * factor)
        if 32 <= threads <= seg.MAX_THREADS and threads % 32 == 0:
            out[f"threads {threads}"] = plan._replace(threads=threads)
    b, c, h, w = shape
    for factor in (0.5, 2):
        cluster = int(plan.cluster * factor)
        if 1 <= cluster <= 16:
            out[f"cluster {cluster}"] = seg._layout(b, c, h * w, direction, None, esize, cluster,
                                                    plan.threads)
    return out


class SegmentSide:
    """One build's K5 and K5-bwd through its C entry, with its own plan."""

    def __init__(self, mod, plans):
        self.lib = mod.library()
        self.plans = plans
        self._keep = []             # the C plans of the calls made, kept alive

    def plan(self, shape, direction: str, esize: int):
        return self.plans._plan(*shape, direction, None, esize)

    def _c(self, plan) -> int:
        cp = self.plans._c_struct(plan)
        self._keep.append(cp)
        return ctypes.addressof(cp)

    def fwd(self, plan, ops, y, stats) -> Callable:
        cp, x = self._c(plan), ops["x"]
        t = bits8_keep_threshold(RATE)

        def call():
            status = self.lib.lvae_segment_fwd(
                cp, x.data_ptr(), ops["gamma"].data_ptr(), ops["beta"].data_ptr(), None, None,
                y.data_ptr(), stats.data_ptr(), t, 0, 1e-5, 0.9, 0.1, SEED, SITE,
                ops["step"].data_ptr(), torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError(f"lvae_segment_fwd returned {status}")
        return call

    def bwd(self, plan, ops, stats, dx, dgb) -> Callable:
        cp, x = self._c(plan), ops["x"]
        t = bits8_keep_threshold(RATE)

        def call():
            status = self.lib.lvae_segment_bwd(
                cp, x.data_ptr(), ops["g"].data_ptr(), ops["gamma"].data_ptr(),
                stats.data_ptr(), dx.data_ptr(), dgb.data_ptr(), t, 0, SEED, SITE,
                ops["step"].data_ptr(), torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError(f"lvae_segment_bwd returned {status}")
        return call


def segment_held(a: dict, b: dict, bf16: bool, what: str) -> dict:
    """The gaps of this build's K5 / K5-bwd outputs ``a`` to the other's
    ``b``, each checked at phase 18a's tolerance."""
    def ulps(u, v):
        d = (u.view(torch.int16).int() - v.view(torch.int16).int()).abs()
        return int(torch.where(u == v, torch.zeros_like(d), d).max())

    def rel_max(u, v):
        return ((u.double() - v.double()).abs().max()
                / v.double().abs().max().clamp_min(1e-30)).item()

    def rel_elem(u, v):
        return ((u.double() - v.double()).abs() / v.double().abs().clamp_min(1.0)).max().item()

    gaps, limits = {}, {}
    if "y" in a:
        gaps["stats"], limits["stats"] = rel_elem(a["stats"][:2], b["stats"][:2]), 1e-6
        gaps["y"], limits["y"] = (ulps(a["y"], b["y"]), 1) if bf16 else (rel_max(a["y"], b["y"]),
                                                                        1e-5)
    if "dx" in a:
        gaps["dx"], limits["dx"] = (ulps(a["dx"], b["dx"]), 1) if bf16 else (
            rel_max(a["dx"], b["dx"]), 1e-5)
        gaps["dgb"] = max(rel_max(a["dgb"][i], b["dgb"][i]) for i in range(2))
        limits["dgb"] = 1e-5
    bad = [f"{k} {gaps[k]:.2e} > {limits[k]:.0e}" for k in gaps if not gaps[k] <= limits[k]]
    if "dx" in a and not torch.equal(a["dx"] == 0, b["dx"] == 0):
        bad.append("dx zero at other elements")
    if bad:
        raise RuntimeError(f"{what}: this build's outputs off the other's: {', '.join(bad)}")
    return gaps


# fwd_kernel / bwd_kernel and their template arguments (the storage type,
# then the integers: V, the act, ...), e.g. _110fwd_kernelIfLi16ELi0EEEv
_SEGMENT = re.compile(r"\d(fwd|bwd)_kernelI(f|13__nv_bfloat16)((?:Li-?\d+E)+)EEv")


def segment_sass(lib: Path) -> Dict[str, dict]:
    """{``fwd_kernel<T, ...>``: counts} from ``cuobjdump -sass`` of a built
    library: every instruction but NOPs, F2F.F64.F32, DADD, DFMA, MUFU,
    CALL, and LDG / LDS / LDGSTS (cp.async) by width in bits."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    out, ins = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = _SEGMENT.search(line)
            ins = None
            if m:
                args = ", ".join(re.findall(r"Li(-?\d+)E", m[3]))
                name = f"{m[1]}_kernel<{'float' if m[2] == 'f' else 'bf16'}, {args}>"
                ins = out.setdefault(name, [])
        elif ins is not None:
            m = _INSTR.search(line)
            if m and m[1] != "NOP":
                ins.append(m[1])
    result = {}
    for name, ops_ in out.items():
        ops = collections.Counter(ops_)
        count = lambda *prefixes: sum(n for op, n in ops.items()             # noqa: E731,B023
                                      if op.startswith(prefixes))
        widths = lambda prefix: dict(sorted(collections.Counter(                # noqa: E731,B023
            _width(op) for op in ops_ if op.split(".")[0] == prefix).items()))
        result[name] = {"total": len(ops_), "F2F.F64.F32": ops["F2F.F64.F32"],
                        "DADD": count("DADD"), "DFMA": count("DFMA"), "MUFU": count("MUFU"),
                        "CALL": count("CALL"), "LDG": widths("LDG"), "LDS": widths("LDS"),
                        "LDGSTS": widths("LDGSTS"), "opcodes": dict(ops.most_common())}
    return result


def cudnn_ms(shape, dtype, gen, calls: int, replays: int) -> Optional[float]:
    """Device ms of cuDNN's train-mode ``F.batch_norm`` then ``F.elu`` (no
    dropout) on ``shape``, fp32 weights; None where the card refuses it."""
    import torch.nn.functional as F

    c = shape[1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 1.5 + 0.3).to(dtype)
    w = torch.rand(c, generator=gen, device="cuda") + 0.5
    b = torch.randn(c, generator=gen, device="cuda") * 0.2
    try:
        return graph_ms(lambda: F.elu(F.batch_norm(x, None, None, w, b, training=True)),
                        calls, replays)
    except RuntimeError as e:
        print(f"    cudnn {list(shape)} {dtype}: {e}".splitlines()[0])
        return None


def segment_main(args, card: str) -> dict:
    """The ``--kernels segment`` mode: {card, sass, times}."""
    other_mod = load_kernels(args.other.resolve(), "build")
    built = {"other": other_mod.build(), "this": build.build()}
    libs = {s: b[0] for s, b in built.items()}
    sides = {"other": SegmentSide(other_mod, load_kernels(args.other.resolve(), "segment")),
             "this": SegmentSide(build, seg)}
    result = {"card": card, "sass": {}, "times": [], "ptxas": {}}
    for side, (_, log) in built.items():
        entry = None
        for line in log.splitlines():       # -Xptxas -v: registers, spills
            if "Compiling entry function" in line:
                m = _SEGMENT.search(line)
                entry = m[0] if m else None
            elif entry and ("registers" in line or "spill" in line):
                text = line.split(":", 1)[-1].strip()
                result["ptxas"].setdefault(side, {}).setdefault(entry, []).append(text)
                print(f"  ptxas {side} {entry}: {text}")
    for side, lib in libs.items():
        result["sass"][side] = segment_sass(lib)
        for name, c in sorted(result["sass"][side].items()):
            print(f"  sass {side} {name}: {c['total']} instructions, F2F.F64.F32 "
                  f"{c['F2F.F64.F32']}, DADD {c['DADD']}, DFMA {c['DFMA']}, MUFU {c['MUFU']}, "
                  f"CALL {c['CALL']}, LDG {c['LDG']}, LDS {c['LDS']}, LDGSTS {c['LDGSTS']}")
    gen = torch.Generator(device="cuda").manual_seed(20)
    shapes = [tuple(int(v) for v in s.split("x")) for s in args.shapes] if args.shapes \
        else SEGMENT_SHAPES
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            bf16, esize = dtype == torch.bfloat16, build.esize(dtype)
            name = f"{list(shape)} {'bf16' if bf16 else 'fp32'}"
            ops = operands(shape, ElementMap(), dtype, gen)
            c = shape[1]
            outs = {s: {"y": torch.empty_like(ops["x"]), "stats": torch.empty(5, c, device="cuda"),
                        "dx": torch.empty_like(ops["x"]), "dgb": torch.empty(2, c, device="cuda")}
                    for s in sides}
            plans = {s: {d: sides[s].plan(shape, d, esize) for d in DIRECTIONS} for s in sides}
            calls = {s: {"fwd": sides[s].fwd(plans[s]["fwd"], ops, outs[s]["y"],
                                             outs[s]["stats"]),
                         "bwd": sides[s].bwd(plans[s]["bwd"], ops, outs["other"]["stats"],
                                             outs[s]["dx"], outs[s]["dgb"])}
                     for s in sides}
            for d in DIRECTIONS:
                for s in ("other", "this"):
                    calls[s][d]()
            torch.cuda.synchronize()
            gaps = segment_held(outs["this"], outs["other"], bf16, name)
            first = {k: v.clone() for k, v in outs["this"].items()}
            for d in DIRECTIONS:
                calls["this"][d]()
            torch.cuda.synchronize()
            if not all(torch.equal(first[k], outs["this"][k]) for k in first):
                raise RuntimeError(f"{name}: a relaunch of this build is not bit-equal")
            n = int(torch.tensor(shape).prod())
            row = {"shape": name, "bound_ms": {
                       "fwd": 2 * esize * n / 3.35e12 * 1e3, "bwd": 3 * esize * n / 3.35e12 * 1e3},
                   "plans": {s: {d: plans[s][d]._asdict() for d in DIRECTIONS} for s in sides},
                   "gaps": gaps, "other_ms": {}, "this_ms": {}, "variants_ms": {}}
            for d in DIRECTIONS:
                t = {"other": [], "this": []}
                for s in ("other", "this"):
                    t[s].append(graph_ms(calls[s][d], args.calls, args.replays))
                alt = {}
                for label, p in plan_variants(plans["this"][d], shape, d, esize).items():
                    o = {"y": torch.empty_like(ops["x"]), "stats": torch.empty(5, c, device="cuda"),
                         "dx": torch.empty_like(ops["x"]), "dgb": torch.empty(2, c, device="cuda")}
                    fn = (sides["this"].fwd(p, ops, o["y"], o["stats"]) if d == "fwd" else
                          sides["this"].bwd(p, ops, outs["other"]["stats"], o["dx"], o["dgb"]))
                    fn()
                    torch.cuda.synchronize()
                    segment_held({k: v for k, v in o.items()
                                  if k in (("y", "stats") if d == "fwd" else ("dx", "dgb"))},
                                 outs["other"], bf16, f"{name} {d} {label}")
                    alt[label] = graph_ms(fn, args.calls, args.replays)
                row["variants_ms"][d] = alt
                for s in ("this", "other"):
                    t[s].append(graph_ms(calls[s][d], args.calls, args.replays))
                row["other_ms"][d], row["this_ms"][d] = t["other"], t["this"]
            row["cudnn_bn_elu_ms"] = cudnn_ms(shape, dtype, gen, args.calls, args.replays)
            result["times"].append(row)
            print(f"  {name}: gaps " + ", ".join(f"{k} {v:.1e}" for k, v in gaps.items())
                  + f"; cuDNN batch_norm + elu (rate 0) "
                  + (f"{row['cudnn_bn_elu_ms']:.4f} ms" if row["cudnn_bn_elu_ms"] else "n/a"),
                  flush=True)
            for d in DIRECTIONS:
                o, th, p = row["other_ms"][d], row["this_ms"][d], plans["this"][d]
                print(f"    {('K5', 'K5-bwd')[d == 'bwd']}: other {o[0]:.4f} / {o[1]:.4f} ms, "
                      f"this {th[0]:.4f} / {th[1]:.4f} ms ({sum(o) / sum(th):.2f}x), bound "
                      f"{row['bound_ms'][d]:.4f}; this plan cluster {p.cluster} x {p.threads}, "
                      f"chip {p.chip} of {p.units}; variants "
                      + (", ".join(f"{k} {v:.4f}" for k, v in row["variants_ms"][d].items())
                         or "none") + f"  ({card})", flush=True)
            del ops, outs, calls, first
            torch.cuda.empty_cache()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout (e.g. the parent commit's git archive)")
    ap.add_argument("--kernels", choices=("split", "segment"), default="split",
                    help="split: the four split launches (K5-split, K5-bwd-split); segment: "
                         "the one-launch K5 and K5-bwd at every model segment shape")
    ap.add_argument("--shapes", nargs="*", help="--kernels segment: BxCxHxW shapes to run "
                                                "(default every model segment shape)")
    ap.add_argument("--json", type=Path, help="write every number here")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--replays", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("segment_ab: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}")
    if args.kernels == "segment":
        result = segment_main(args, card)
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(result, indent=1))
        return 0
    other_mod = load_kernels(args.other.resolve(), "build")
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
