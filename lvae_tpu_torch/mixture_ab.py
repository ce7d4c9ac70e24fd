"""K3 or K3-bwd, the mixture log-prob's forward or backward, of this
checkout against the same kernel of another checkout of the repository,
on one card and in turns; and the SASS of both builds' kernels. A
``python -m`` tool for a machine with the card, not a phase of
``chip_smoke.py``.

    python -m lvae_tpu_torch.mixture_ab --other <checkout> [--kernels fwd|bwd]
        [--json out.json]

The other checkout's kernels are built from its own ``csrc/`` by its own
``kernels/build.py`` (into its own ``build/``) and called through its C
entry, as are this checkout's: both without the Python wrapper, each
timed as a CUDA graph of ``--calls`` launches replayed ``--replays``
times (device ms a call, no host cost), in the order other, this, this,
other at each shape and dtype. The operands are ``chip_smoke.py`` phase
10's (integer pixels with both edge bins, normal params with two
log-scale channels under the floor). ``cuobjdump -sass`` counts each
kernel's instructions: in all, MUFU (the special function unit), global
loads and stores by width (LDG, STG), the integer-division sequences
(``I2F.*.RP``, the reciprocal seed of a division by a run-time integer),
and the instructions and MUFU of its innermost loop (the shortest
backward branch); ``-Xptxas -v`` gives registers and spills where a build
was made in the call. Needs the card, ``nvcc`` and ``cuobjdump``.

``--kernels fwd`` (the default): K3 at ``SHAPES``, at the V
``kernels/mixture.py`` ``fwd_plan`` chooses; this checkout's every V once
between the turns; each plan's ll held to the other build's (1e-4 + 1e-5
|ll|).

``--kernels bwd``: K3-bwd at ``BWD_SHAPES`` in fp32 and bf16, with and
without dx, each build on its own default plan (its checkout's
``kernels/mixture.py`` ``bwd_plan``; an entry that takes no V runs the
plan alone); between the turns this checkout runs each other schedule
and V once (``bwd_variants``). Every output is held to the other build's
at ``chip_smoke.py`` phase 18a's tolerances: bf16 dparams within one bf16
ulp or within 1e-4 of their max, fp32 dparams and dx within 1e-4 of their
max, zero under the log-scale floor; a relaunch of this build bit-equal.
Each row's bound: its bytes (params, x and g read, dparams and dx
written, once each) at 3.35 TB/s, or 80 fp32 operations a bin at 67
TFLOP/s where larger.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict

import torch

from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.kernels import mixture as km
from lvae_tpu_torch.profiling import card_line

# (B, C, H, W, K): celeba64's training and evaluation batches, cifar10-deep's
# (BASELINE config 4) training and evaluation batches, and chip_smoke.py's
# other MIX_SHAPES: C = 1, K = 24 and a 7x7 map
SHAPES = [(128, 3, 64, 64, 10), (500, 3, 64, 64, 10), (128, 3, 32, 32, 10),
          (500, 3, 32, 32, 10), (16, 1, 32, 32, 10), (32, 3, 64, 64, 24), (8, 3, 7, 7, 10)]
N_BINS = 256


def load_kernels(checkout: Path, name: str):
    """The checkout's ``kernels/<name>.py`` as a module of its own: its
    ``build`` (whose sources and build directory are its checkout's) or its
    launch plans (their imports resolve in this checkout's package)."""
    path = checkout / "lvae_tpu_torch" / "kernels" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_{abs(hash(str(checkout)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(mod) -> Callable:
    """``call(x, params, out, k, v)`` through ``mod``'s C entry: at V
    pixels a thread where that entry takes a V (``kernels/mixture.py``
    ``fwd_plan``), else the entry's own launch."""
    lib = mod.library()
    takes_v = len(mod._SIGNATURES["lvae_mix_log_prob"]) == 11

    def call(x, params, out, k, v):
        b, c, h, w = x.shape
        status = lib.lvae_mix_log_prob(
            x.data_ptr(), params.data_ptr(), out.data_ptr(), b, h * w, k, c, N_BINS,
            *((v,) if takes_v else ()), build.esize(params.dtype),
            torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"lvae_mix_log_prob returned {status}")

    return call


def graph_ms(fn: Callable, calls: int, replays: int) -> float:
    """Device ms per call: a CUDA graph of ``calls`` calls of ``fn``,
    replayed ``replays`` times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def operands(shape, gen):
    b, c, h, w, k = shape
    dev = torch.device("cuda")
    u = torch.randint(0, 256, (b, c, h, w), generator=gen, device=dev)
    u[:, :, 0], u[:, :, -1] = 0, 255
    p = torch.randn(b, k * (1 + 3 * c), h, w, generator=gen, device=dev)
    lo = k + k * c
    p[:, lo:lo + 2] = -9.0 + torch.rand(b, 2, h, w, generator=gen, device=dev)
    return u.float() / 255.0, p


# a mixture kernel's name in cuobjdump's listing and its template arguments
# (C, the storage type, V), e.g. mix_bwd_one_pass_kernelILi3E13__nv_bfloat16Li2EE
_KERNEL = re.compile(r"(mix_\w+?_kernel)ILi(\d)E(f|13__nv_bfloat16)(?:Li(\d)E)?E")
# an instruction line: its address, opcode and, for a branch, its target
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
                    r"(?:\s+(?:`\()?0x([0-9a-f]+))?")


def kernel_name(mangled: str) -> str:
    """``mix_bwd_one_pass_kernel<3, bf16, V 2>`` of a mangled symbol, or the
    symbol itself where it is no mixture kernel."""
    m = _KERNEL.search(mangled)
    if not m:
        return mangled
    plan = f", V {m[4]}" if m[4] else ""
    return f"{m[1]}<{m[2]}, {'float' if m[3] == 'f' else 'bf16'}{plan}>"


def sass_counts(lib: Path) -> Dict[str, dict]:
    """{``mix_fwd_kernel<C, P[, V]>`` (and every other mixture kernel):
    {"total", "MUFU", "LDG", "LDG_bits", "STG_bits", "LDS", "STS", "int_div",
    "loop", "loop_MUFU", "loops", "opcodes"}} from ``cuobjdump -sass`` of a
    built library (NOPs left out; "loop" counts the innermost loop's body,
    "loops" each loop's instructions and MUFU in address order)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    out, ins = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            ins = out.setdefault(kernel_name(line), []) if _KERNEL.search(line) else None
        elif ins is not None:
            m = _INSTR.search(line)
            if m and m[2] != "NOP":
                ins.append((int(m[1], 16), m[2], m[3]))
    return {name: _counts(ins) for name, ins in out.items()}


def _width(op: str) -> int:
    for bits in (128, 64):
        if f".{bits}" in op:
            return bits
    return 16 if ".U16" in op or ".S16" in op else 8 if ".U8" in op or ".S8" in op else 32


def _counts(ins) -> dict:
    ops = collections.Counter(op for _, op, _ in ins)
    back = sorted((int(target, 16), at) for at, op, target in ins
                  if op == "BRA" and target is not None and int(target, 16) < at)
    bodies = [[op for at, op, _ in ins if start <= at <= end] for start, end in back]
    inner = min(bodies, key=len) if bodies else []
    widths = lambda prefix: dict(sorted(collections.Counter(                  # noqa: E731
        _width(op) for _, op, _ in ins if op.split(".")[0] == prefix).items()))
    return {"total": len(ins),
            "MUFU": sum(n for op, n in ops.items() if op.startswith("MUFU")),
            "LDG": sum(n for op, n in ops.items() if op.startswith("LDG")),
            "LDG_bits": widths("LDG"), "STG_bits": widths("STG"),
            "LDS": sum(n for op, n in ops.items() if op.startswith("LDS")),
            "STS": sum(n for op, n in ops.items() if op.startswith("STS")),
            "int_div": sum(n for op, n in ops.items()
                           if op.startswith("I2F") and op.endswith(".RP")),
            "loop": len(inner), "loop_MUFU": sum(op.startswith("MUFU") for op in inner),
            "loops": [(len(b), sum(op.startswith("MUFU") for op in b)) for b in bodies],
            "opcodes": dict(ops.most_common())}


def ptxas_lines(log: str) -> Dict[str, list]:
    """{mixture kernel: its ``-Xptxas -v`` lines (registers, spills)} of a
    build's log (empty where the library was built before the call)."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = kernel_name(line) if _KERNEL.search(line) else None
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return out


def fwd_main(args, card: str) -> dict:
    """The ``--kernels fwd`` mode: {card, sass, times}."""
    other_mod = load_kernels(args.other.resolve(), "build")
    libs = {"other": other_mod.build()[0], "this": build.build()[0]}
    call = {"other": entry(other_mod), "this": entry(build)}
    result = {"card": card, "sass": {}, "times": []}
    for side, lib in libs.items():
        result["sass"][side] = {n: c for n, c in sass_counts(lib).items()
                                if n.startswith("mix_fwd_kernel")}
        for name, c in sorted(result["sass"][side].items()):
            print(f"  sass {side} {name}: {c['total']} instructions, MUFU {c['MUFU']}, "
                  f"LDG {c['LDG']}, integer division {c['int_div']}; innermost loop "
                  f"{c['loop']} instructions, MUFU {c['loop_MUFU']}")
    gen = torch.Generator(device="cuda").manual_seed(15)
    for shape in SHAPES:
        b, c, h, w, k = shape
        x32, p32 = operands(shape, gen)
        for p in (p32, p32.to(torch.bfloat16)):
            dtype = "bf16" if p.dtype == torch.bfloat16 else "fp32"
            label = f"[{b},{p.shape[1]},{h},{w}] C={c} K={k} {dtype}"
            default = km.fwd_plan(b, h * w)
            outs = {s: torch.empty(b, h, w, device="cuda") for s in ("other", "this")}
            call["other"](x32, p, outs["other"], k, default)
            run = {"other": lambda: call["other"](x32, p, outs["other"], k, default),
                   "this": lambda: call["this"](x32, p, outs["this"], k, default)}
            t = {"other": [], "this": []}
            t["other"].append(graph_ms(run["other"], args.calls, args.replays))
            t["this"].append(graph_ms(run["this"], args.calls, args.replays))
            plans = {}
            for v in km.FWD_VECTORS:
                out = torch.empty(b, h, w, device="cuda")
                call["this"](x32, p, out, k, v)
                ref = outs["other"]
                e = ((out - ref).abs() - 1e-5 * ref.abs()).max().item()
                if not e <= 1e-4:
                    raise RuntimeError(f"{label} V={v}: ll off the other build's by {e:.2e}")
                plans[f"V={v}"] = graph_ms(lambda vv=v, o=out: call["this"](x32, p, o, k, vv),
                                           args.calls, args.replays)
            t["this"].append(graph_ms(run["this"], args.calls, args.replays))
            t["other"].append(graph_ms(run["other"], args.calls, args.replays))
            row = {"shape": label, "default": f"V={default}",
                   "other_ms": t["other"], "this_ms": t["this"], "plans_ms": plans,
                   "speedup": (sum(t["other"]) / sum(t["this"]))}
            result["times"].append(row)
            print(f"  {label}: other {t['other'][0]:.4f} / {t['other'][1]:.4f} ms, this "
                  f"({row['default']}) {t['this'][0]:.4f} / {t['this'][1]:.4f} ms, "
                  f"{row['speedup']:.2f}x; plans: "
                  + ", ".join(f"{n} {v:.4f}" for n, v in plans.items()) + f"  ({card})",
                  flush=True)
        del x32, p32
    return result


# ---------------------------------------------------------------------------
# --kernels bwd: K3-bwd
# ---------------------------------------------------------------------------

# (B, C, H, W, K): celeba64's training batch, cifar10-deep's (BASELINE
# config 4), chip_smoke.py phase 10's C = 1 shape and its K = 24 (the
# two-pass schedule's)
BWD_SHAPES = [(128, 3, 64, 64, 10), (128, 3, 32, 32, 10), (16, 1, 32, 32, 10),
              (32, 3, 64, 64, 24)]
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
OPS_BIN_BWD = 80            # fp32 operations a bin, as chip_smoke.py phase 18a counts


class BwdSide:
    """One build's K3-bwd through its C entry, with its own default plan."""

    def __init__(self, mod, plans):
        self.lib = mod.library()
        self.takes_v = len(mod._SIGNATURES["lvae_mix_log_prob_bwd_plan"]) == 14
        self.plans = plans

    def plan(self, k: int, c: int, b: int, hw: int) -> km.Plan:
        if self.takes_v:
            return self.plans.bwd_plan(k, c, b, hw)
        p = self.plans.bwd_plan(k, c)           # an entry that takes no V
        return km.Plan(p.name, p.smem, 1)

    def call(self, ops: dict, plan: km.Plan, out: dict) -> Callable:
        """A launch on ``ops`` (x, params, g, k) into ``out`` (dparams and,
        or None, dx)."""
        x, p, g, k = ops["x"], ops["params"], ops["g"], ops["k"]
        b, c, h, w = x.shape
        dx = out["dx"]

        def run():
            status = self.lib.lvae_mix_log_prob_bwd_plan(
                x.data_ptr(), p.data_ptr(), g.data_ptr(), out["dparams"].data_ptr(),
                None if dx is None else dx.data_ptr(), b, h * w, k, c, N_BINS,
                km.PLANS.index(plan.name), *((plan.v,) if self.takes_v else ()),
                build.esize(p.dtype), torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError(f"lvae_mix_log_prob_bwd_plan returned {status}")
        return run


def bwd_variants(k: int, c: int, b: int, hw: int, default: km.Plan) -> Dict[str, km.Plan]:
    """This checkout's other K3-bwd launches of a shape: each schedule and
    (one pass) each V that fits a CTA and differs from the default."""
    out = {}
    for name in km.PLANS:
        for v in km.BWD_VECTORS if name == "one_pass" else (None,):
            try:
                plan = km.bwd_plan(k, c, b, hw, name, v)
            except ValueError:
                continue
            if plan != default:
                out[name + ("" if v is None else f" V={v}")] = plan
    return out


def bwd_held(got: dict, want: dict, lo: int, what: str) -> dict:
    """The gaps of one build's K3-bwd outputs ``got`` to the other's
    ``want``, each checked at phase 18a's tolerance: bf16 dparams within
    one bf16 ulp or within 1e-4 of their max, fp32 dparams and dx within
    1e-4 of their max; dparams zero at the two log-scale channels under the
    floor (``lo``, ``lo + 1``)."""
    dp, ref = got["dparams"], want["dparams"]
    scale = ref.float().abs().max().item()
    far = (dp.float() - ref.float()).abs()
    gaps = {"dparams": far.max().item() / max(scale, 1e-30)}
    bad = []
    if dp.dtype == torch.bfloat16:
        ulps = (dp.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
        ulps = torch.where(dp == ref, torch.zeros_like(ulps), ulps)
        gaps["ulps_apart"] = int((ulps > 0).sum())
        if bool(((ulps > 1) & (far > 1e-4 * scale)).any()):
            bad.append("bf16 dparams more than one ulp and 1e-4 of their max apart")
    elif not gaps["dparams"] <= 1e-4:
        bad.append(f"dparams {gaps['dparams']:.2e} > 1e-4")
    if got["dx"] is not None:
        gaps["dx"] = ((got["dx"] - want["dx"]).abs().max()
                      / want["dx"].abs().max().clamp_min(1e-30)).item()
        if not gaps["dx"] <= 1e-4:
            bad.append(f"dx {gaps['dx']:.2e} > 1e-4")
    if not bool((dp[:, lo:lo + 2] == 0).all()):
        bad.append("a gradient under the log-scale floor")
    if bad:
        raise RuntimeError(f"{what}: this build's outputs off the other's: {', '.join(bad)}")
    return gaps


def bwd_bound(shape, esize: int, need_dx: bool):
    """(ms, "bytes" or "operations"): each input read and output written
    once at 3.35 TB/s, or OPS_BIN_BWD a bin at 67 TFLOP/s where larger."""
    b, c, h, w, k = shape
    npix, q = b * h * w, k * (1 + 3 * c)
    n_bytes = npix * (2 * esize * q + 4 * c + 4 + (4 * c if need_dx else 0))
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = npix * k * c * OPS_BIN_BWD / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bwd_main(args, card: str) -> dict:
    """The ``--kernels bwd`` mode: {card, ptxas, sass, times}."""
    other_mod = load_kernels(args.other.resolve(), "build")
    built = {"other": other_mod.build(), "this": build.build()}
    sides = {"other": BwdSide(other_mod, load_kernels(args.other.resolve(), "mixture")),
             "this": BwdSide(build, km)}
    result = {"card": card, "ptxas": {}, "sass": {}, "times": []}
    for side, (lib, log) in built.items():
        result["ptxas"][side] = ptxas_lines(log)
        for name, lines in sorted(result["ptxas"][side].items()):
            if name.startswith("mix_bwd"):
                print(f"  ptxas {side} {name}: {'; '.join(lines)}")
        result["sass"][side] = {n: c for n, c in sass_counts(lib).items()
                                if n.startswith("mix_bwd")}
        for name, c in sorted(result["sass"][side].items()):
            print(f"  sass {side} {name}: {c['total']} instructions, MUFU {c['MUFU']}, LDG by "
                  f"bits {c['LDG_bits']}, STG by bits {c['STG_bits']}, LDS {c['LDS']}, STS "
                  f"{c['STS']}, integer division {c['int_div']}; loops (instructions, MUFU) "
                  f"{c['loops']}")
    gen = torch.Generator(device="cuda").manual_seed(21)
    for shape in args.shapes or BWD_SHAPES:
        b, c, h, w, k = shape
        x, p32 = operands(shape, gen)
        g = torch.randn(b, h, w, generator=gen, device="cuda")
        lo = k + k * c
        for dtype in (torch.float32, torch.bfloat16):
            p = p32.to(dtype)
            for need_dx in (False, True):
                label = (f"[{b},{p.shape[1]},{h},{w}] C={c} K={k} "
                         f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} "
                         f"{'with' if need_dx else 'without'} dx")
                ops = {"x": x, "params": p, "g": g, "k": k}
                plans = {s: sides[s].plan(k, c, b, h * w) for s in sides}

                def fresh():
                    return {"dparams": torch.empty_like(p),
                            "dx": torch.empty_like(x) if need_dx else None}
                outs = {s: fresh() for s in sides}
                calls = {s: sides[s].call(ops, plans[s], outs[s]) for s in sides}
                for s in sides:
                    calls[s]()
                torch.cuda.synchronize()
                gaps = bwd_held(outs["this"], outs["other"], lo, label)
                first = outs["this"]["dparams"].clone()
                calls["this"]()
                torch.cuda.synchronize()
                if not torch.equal(first, outs["this"]["dparams"]):
                    raise RuntimeError(f"{label}: a relaunch of this build is not bit-equal")
                t = {"other": [], "this": []}
                for s in ("other", "this"):
                    t[s].append(graph_ms(calls[s], args.calls, args.replays))
                variants = {}
                for name, plan in bwd_variants(k, c, b, h * w, plans["this"]).items():
                    o = fresh()
                    fn = sides["this"].call(ops, plan, o)
                    fn()
                    torch.cuda.synchronize()
                    bwd_held(o, outs["other"], lo, f"{label} {name}")
                    variants[name] = graph_ms(fn, args.calls, args.replays)
                    del o
                for s in ("this", "other"):
                    t[s].append(graph_ms(calls[s], args.calls, args.replays))
                bnd = bwd_bound(shape, build.esize(dtype), need_dx)
                row = {"shape": label, "plans": {s: plans[s]._asdict() for s in sides},
                       "gaps": gaps, "other_ms": t["other"], "this_ms": t["this"],
                       "variants_ms": variants, "speedup": sum(t["other"]) / sum(t["this"]),
                       "bound_ms": bnd[0], "bound_by": bnd[1]}
                result["times"].append(row)
                pt = plans["this"]
                print(f"  {label}: other ({plans['other'].name}) {t['other'][0]:.4f} / "
                      f"{t['other'][1]:.4f} ms, this ({pt.name} V={pt.v}) {t['this'][0]:.4f} / "
                      f"{t['this'][1]:.4f} ms, {row['speedup']:.2f}x; bound {bnd[0]:.4f} "
                      f"({bnd[1]}); variants "
                      + (", ".join(f"{n} {v:.4f}" for n, v in variants.items()) or "none")
                      + "; gaps " + ", ".join(f"{n} {v:.1e}" for n, v in gaps.items())
                      + f"  ({card})", flush=True)
                del outs, calls, first
            del p
        del x, p32, g
        torch.cuda.empty_cache()
    return result


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout (e.g. the parent commit's git archive)")
    ap.add_argument("--kernels", choices=("fwd", "bwd"), default="fwd",
                    help="fwd: K3 at SHAPES; bwd: K3-bwd at BWD_SHAPES (or --shapes)")
    ap.add_argument("--shapes", nargs="*", type=shape_arg,
                    help="--kernels bwd: BxCxHxWxK shapes to run (default BWD_SHAPES)")
    ap.add_argument("--json", type=Path, help="write every number here")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--replays", type=int, default=10)
    return ap.parse_args(argv)


def shape_arg(text: str):
    """``128x3x64x64x10`` -> (B, C, H, W, K), C 1 or 3."""
    try:
        shape = tuple(int(v) for v in text.split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 5 or shape[1] not in (1, 3) or min(shape) < 1:
        raise argparse.ArgumentTypeError(f"a shape is BxCxHxWxK with C 1 or 3, got {text!r}")
    return shape


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("mixture_ab: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}")
    result = (bwd_main if args.kernels == "bwd" else fwd_main)(args, card)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
