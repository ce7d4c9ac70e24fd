"""K3, the mixture log-prob forward, of this checkout against K3 of another
checkout of the repository, on one card and in turns; and the SASS of
both builds' forward kernels.

    python -m lvae_tpu_torch.mixture_ab --other <checkout> [--json out.json]

The other checkout's kernels are built from its own ``csrc/`` by its own
``kernels/build.py`` (into its own ``build/``) and called through its C
entry, as are this checkout's: both without the Python wrapper, each
timed as a CUDA graph of ``--calls`` launches replayed ``--replays``
times (device ms a call, no host cost), in the order other, this, this,
other at each shape and dtype at the V ``kernels/mixture.py``
``fwd_plan`` chooses; this checkout's every V once between. The operands are
``chip_smoke.py`` phase 10's (integer pixels with both edge bins, normal
params with two log-scale channels under the floor), and each plan's ll
is held to the other build's (1e-4 + 1e-5 |ll|). ``cuobjdump -sass``
counts each ``mix_fwd_kernel``'s instructions: in all, MUFU (the special
function unit), LDG (global loads), the integer-division sequences
(``I2F.*.RP``, the reciprocal seed of a division by a run-time integer),
and the instructions and MUFU of its innermost loop (the shortest
backward branch: K3's loop over components).
Needs the card, ``nvcc`` and ``cuobjdump``.
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


def load_build(checkout: Path):
    """The other checkout's ``kernels/build.py`` as a module of its own (its
    sources and build directory are its checkout's)."""
    path = checkout / "lvae_tpu_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location("other_build", path)
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


_FWD = re.compile(r"mix_fwd_kernelILi(\d)E(f|13__nv_bfloat16)(?:Li(\d)E)?E")
# an instruction line: its address, opcode and, for a branch, its target
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
                    r"(?:\s+(?:`\()?0x([0-9a-f]+))?")


def sass_counts(lib: Path) -> Dict[str, dict]:
    """{``mix_fwd_kernel<C, P[, V]>``: {"total", "MUFU", "LDG", "int_div",
    "loop", "loop_MUFU", "opcodes"}} from ``cuobjdump -sass`` of a built
    library (NOPs left out; "loop" counts the innermost loop's body)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    out, ins = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = _FWD.search(line)
            ins = None
            if m:
                plan = f", V {m[3]}" if m[3] else ""
                name = f"mix_fwd_kernel<{m[1]}, {'float' if m[2] == 'f' else 'bf16'}{plan}>"
                ins = out.setdefault(name, [])
        elif ins is not None:
            m = _INSTR.search(line)
            if m and m[2] != "NOP":
                ins.append((int(m[1], 16), m[2], m[3]))
    return {name: _counts(ins) for name, ins in out.items()}


def _counts(ins) -> dict:
    ops = collections.Counter(op for _, op, _ in ins)
    back = [(target, at) for at, op, target in ins if op == "BRA" and target is not None
            and int(target, 16) < at]
    body = []
    if back:
        start, end = min(((int(t, 16), at) for t, at in back), key=lambda r: r[1] - r[0])
        body = [op for at, op, _ in ins if start <= at <= end]
    return {"total": len(ins),
            "MUFU": sum(n for op, n in ops.items() if op.startswith("MUFU")),
            "LDG": sum(n for op, n in ops.items() if op.startswith("LDG")),
            "int_div": sum(n for op, n in ops.items()
                           if op.startswith("I2F") and op.endswith(".RP")),
            "loop": len(body), "loop_MUFU": sum(op.startswith("MUFU") for op in body),
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
        print("mixture_ab: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}")
    other_mod = load_build(args.other.resolve())
    libs = {"other": other_mod.build()[0], "this": build.build()[0]}
    call = {"other": entry(other_mod), "this": entry(build)}
    result = {"card": card, "sass": {}, "times": []}
    for side, lib in libs.items():
        result["sass"][side] = sass_counts(lib)
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
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
