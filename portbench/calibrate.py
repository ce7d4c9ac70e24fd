"""The readings that the output check's limits are set from, on a CUDA card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 ... [--fault-seeds 3]

For each seed, in one process: the program as a run drives it (a training
cell: set-up, whose first call the check observes; an IW-LL cell: set-up
and one whole batch at the cell's load), the numbers it reads against the
fp32 reference; the control, the reference computed in TF32 (the
precision below fp32 with TF32 off) in the program's place; and on the
first ``--fault-seeds`` seeds of a training cell two faults: the program
with half of each batch left out of the loss (its mean taken over the
rest), and with the CUDA graph's replay left out (the state as the eager
steps of the first call left it). One JSON line a seed on standard
output.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
from pathlib import Path

import torch

from portbench import drive, spec


@contextlib.contextmanager
def half_batch():
    """The program's loss over the first half of each batch alone."""
    from lvae_tpu_torch.train import state as st

    whole = st.loss_terms

    def half(model, x, noise, *args, **kwargs):
        h = x.shape[0] // 2
        return whole(model, x[:h], dataclasses.replace(noise, index=noise.index[:h]),
                     *args, **kwargs)

    st.loss_terms = half
    try:
        yield
    finally:
        st.loss_terms = whole


@contextlib.contextmanager
def replay_skipped():
    """Every replay of a CUDA graph left out: a graphed call returns with
    the state unchanged and the graph's outputs unwritten."""
    replay = torch.cuda.CUDAGraph.replay
    torch.cuda.CUDAGraph.replay = lambda self: None
    try:
        yield
    finally:
        torch.cuda.CUDAGraph.replay = replay


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readings(cell: spec.Cell, seed: int, device: str, fault: bool) -> dict:
    kind = drive.KINDS[cell.traffic["kind"]](cell, seed, device)
    kind.setup()
    if kind.kind == "iwll":
        kind.window(0.0)             # one whole batch
    kind.free()
    _free()
    ref = kind.reference()
    out = {"seed": seed, "program": kind.numbers(ref)}
    del kind.ref_model
    _free()
    out["control_tf32"] = kind.numbers(ref, kind.reference(tf32=True))
    del kind.ref_model
    _free()
    faults = {"fault_half_batch": half_batch, "fault_replay_skipped": replay_skipped}
    for name, planted in faults.items() if fault else ():
        other = drive.KINDS[cell.traffic["kind"]](cell, seed, device)
        with planted():
            other.setup()
        other.free()
        out[name] = kind.numbers(ref, other.prog)
        del other
        _free()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault-seeds", type=int, default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload, Path.cwd())
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(args.seeds):
        fault = cell.traffic["kind"] == "train" and i < args.fault_seeds
        print(json.dumps({"cell": cell.name, **readings(cell, seed, "cuda", fault)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
