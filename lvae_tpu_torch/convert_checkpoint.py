"""Weights into and out of the port's run directories: the twin of
``tools/convert_torch_checkpoint.py`` (``import``) and of
``tools/export_torch_checkpoint.py`` (``export``).

    python -m lvae_tpu_torch.convert_checkpoint import \\
        --state-dict ref_model.pt --run-dir output/converted [--non-strict] \\
        [--device cuda|cpu] -- \\
        --dataset static_mnist --zdims 32 32 32 --downsample 1 1 1 \\
        --blocks-per-layer 2 --gated --skip --learn-top-prior

    python -m lvae_tpu_torch.convert_checkpoint export \\
        --load <run name or dir> [--output-dir output] [--step N] --out ref_model.pt

``import`` reads a ``torch.save``d state dict keyed and laid out as the
reference's ``model.state_dict()`` (``docs/CHECKPOINT_FORMAT.md``
§"Parameter-name mapping"): what ``tools/export_torch_checkpoint.py``
writes from an ``lvae_tpu`` run, a reference checkpoint, a dict with a
``"state_dict"`` or ``"model"`` entry, or a checkpoint of the port's own
trainer. The flags after ``--`` are ``lvae_tpu_torch.main``'s and must
describe the architecture the weights were trained with. It writes
``<run-dir>/config.json`` and ``checkpoints/ckpt_00000000.pt``: the
checkpoint the trainer itself writes at step 0 under those flags (fresh
Adamax state, metric EMA and, under ``--grad-accum``, accumulator), with
the file's weights, so ``python -m lvae_tpu_torch.evaluate --load
<run-dir>`` scores it and ``python -m lvae_tpu_torch.main --load
<run-dir>`` trains on from it. Every key and shape must match the model
built from the flags; ``--non-strict`` keeps the fresh values of the
entries that do not, and prints them.

``export`` writes a run's checkpoint (the latest, or ``--step``'s) as a
plain ``torch.save``d dict of CPU tensors in that same naming and layout,
each BatchNorm's ``num_batches_tracked`` included: the port's
``state_dict`` is already the reference's, so the tensors are written as
they are. ``lvae_tpu.train.convert.torch_state_dict_to_flax`` and
``tools/convert_torch_checkpoint.py`` read the file. An ``lvae_tpu`` run
directory holds an orbax checkpoint, which needs JAX to read, and is
refused: ``tools/export_torch_checkpoint.py`` writes its ``.pt``, which
``import`` reads.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Mapping, Optional

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m lvae_tpu_torch.convert_checkpoint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    imp = sub.add_parser("import", help="a torch state dict -> a port run directory")
    imp.add_argument("--state-dict", required=True,
                     help="torch.save'd state dict (or a dict with a 'state_dict' / "
                          "'model' entry, or a checkpoint of the port's trainer)")
    imp.add_argument("--run-dir", required=True, help="run directory to create")
    imp.add_argument("--non-strict", action="store_true",
                     help="keep the fresh values of unmatched entries, and print them")
    imp.add_argument("--device", default=None, choices=["cuda", "cpu"],
                     help="where the template model is built (default: the main flags' "
                          "--device, cuda)")
    imp.add_argument("model_flags", nargs=argparse.REMAINDER,
                     help="lvae_tpu_torch.main's model and data flags after '--'")
    exp = sub.add_parser("export", help="a port run's checkpoint -> a torch state dict")
    exp.add_argument("--load", required=True, help="run directory (or run name)")
    exp.add_argument("--output-dir", default="output",
                     help="where run names are resolved (default: output)")
    exp.add_argument("--step", type=int, default=None,
                     help="checkpoint step to export (default: latest)")
    exp.add_argument("--out", required=True, help="output .pt path")
    return p


def match_state_dict(template: Mapping[str, torch.Tensor], sd: Mapping[str, torch.Tensor],
                     strict: bool = True) -> tuple[dict, dict]:
    """``(merged, unmatched)``: ``template`` with every entry of ``sd``
    whose key and shape it shares, and ``{"missing": [...], "unexpected":
    [...], "shape": [...]}``. ``strict`` raises a ValueError naming every
    unmatched entry instead."""
    missing = sorted(k for k in template if k not in sd)
    unexpected = sorted(k for k in sd if k not in template)
    shape = sorted(f"{k}: file {tuple(sd[k].shape)} vs model {tuple(t.shape)}"
                   for k, t in template.items() if k in sd and sd[k].shape != t.shape)
    unmatched = {"missing": missing, "unexpected": unexpected, "shape": shape}
    if strict and (missing or unexpected or shape):
        raise ValueError(
            "the state dict does not match the model the flags describe: "
            + "; ".join(f"{what} ({len(v)}): {v}" for what, v in unmatched.items() if v)
            + " (--non-strict keeps the fresh values of these)")
    merged = {k: sd[k] if k in sd and sd[k].shape == t.shape else t
              for k, t in template.items()}
    return merged, unmatched


def import_state_dict(state_dict_path: str, run_dir: str, flags, strict: bool = True,
                      device: Optional[str] = None) -> str:
    """Write ``run_dir`` (``config.json`` and the step-0 checkpoint) from
    the weights of ``state_dict_path`` and the model of ``flags``
    (``lvae_tpu_torch.main``'s); returns the checkpoint's path."""
    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.data.registry import stub_bundle
    from lvae_tpu_torch.train.checkpoint import CheckpointManager, save_config
    from lvae_tpu_torch.train.convert import load_state_dict_file
    from lvae_tpu_torch.train.trainer import Experiment

    cfg, flag_device = config_from_args([f for f in flags if f != "--"])
    device = torch.device(device or flag_device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(torch.cuda.is_available() is False); the port does not fall "
                         "back to the CPU (pass --device cpu to convert there)")
    sd = load_state_dict_file(state_dict_path)
    # the template is one rank's trainer state at step 0: the rank count
    # and the feed change no name or shape
    template_cfg = dataclasses.replace(cfg, num_data_shards=1, streaming=False)
    state = Experiment(template_cfg, device, stub_bundle(cfg.dataset)).init_state(
        data_dep_init=False)
    merged, unmatched = match_state_dict(state.model.state_dict(), sd, strict)
    for what, keys in unmatched.items():
        if keys:
            print(f"non-strict: {len(keys)} {what} entries keep their fresh values: {keys}")
    state.model.load_state_dict(merged, strict=True)
    save_config(run_dir, cfg)
    path = CheckpointManager(run_dir, keep=cfg.keep_checkpoints).save(state)
    print(f"converted {len(sd)} state_dict entries -> {run_dir} (step 0); evaluate with: "
          f"python -m lvae_tpu_torch.evaluate --load {run_dir}")
    return path


def is_orbax_run(run_dir: str) -> bool:
    """Whether ``run_dir`` holds ``lvae_tpu``'s orbax checkpoints
    (``checkpoints/<step>/`` directories) and none of the port's files."""
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return False
    names = os.listdir(ckpt_dir)
    return (not any(n.startswith("ckpt_") and n.endswith(".pt") for n in names)
            and any(n.isdigit() and os.path.isdir(os.path.join(ckpt_dir, n)) for n in names))


def export_state_dict(load: str, out: str, output_dir: str = "output",
                      step: Optional[int] = None) -> dict:
    """Write the model weights of the run ``load`` (a directory, or a run
    name under ``output_dir``) at ``step`` (default: the latest) to
    ``out``; returns the tensors written."""
    from lvae_tpu_torch.train.checkpoint import CheckpointManager

    run_dir = load if os.path.isdir(load) else os.path.join(output_dir, load)
    if is_orbax_run(run_dir):
        raise SystemExit(
            f"{run_dir} is an lvae_tpu run directory (an orbax checkpoint, which needs "
            f"JAX to read): export it with tools/export_torch_checkpoint.py, whose .pt "
            f"'python -m lvae_tpu_torch.convert_checkpoint import' reads")
    ckpt = CheckpointManager(run_dir).load(step)
    tensors = {k: v.detach().cpu().contiguous() for k, v in ckpt["model"].items()}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save(tensors, out)
    n_params = sum(int(v.numel()) for k, v in tensors.items()
                   if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    print(f"exported {run_dir} step {int(ckpt['step'])} -> {out} ({len(tensors)} entries, "
          f"{n_params:,} parameters)")
    return tensors


def main(argv=None):
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.command == "import":
        return import_state_dict(args.state_dict, args.run_dir, args.model_flags,
                                 strict=not args.non_strict, device=args.device)
    return export_state_dict(args.load, args.out, args.output_dir, args.step)


if __name__ == "__main__":
    main()
