"""Checkpoints and the run's ``config.json`` (the port's counterpart of
``lvae_tpu/train/checkpoint.py``, with ``torch.save`` for orbax).

A checkpoint is one file, ``<run dir>/checkpoints/ckpt_<step>.pt``: a dict
of the model's ``state_dict`` (``"model"``), the optimiser's, the step,
the metric EMA and the noise seed; under ``--grad-accum k`` also the
accumulator and its micro-step (``"accum"``, :class:`~lvae_tpu_torch.
train.state.GradAccum`), which a run without it does not hold.
``lvae_tpu_torch.evaluate --load <run>`` restores the model from it (the
latest, or ``--step``); ``--load`` and ``--auto-resume`` of the trainer
restore all of it. Only tensors and plain containers are stored, so it
loads with ``weights_only=True``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Optional

import torch

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, run_dir: str, keep: int = 2):
        self.dir = os.path.join(run_dir, "checkpoints")
        self.keep = keep

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.pt")

    def steps(self) -> list[int]:
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      if (m := _NAME.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state) -> str:
        os.makedirs(self.dir, exist_ok=True)
        path = self.path(state.step)
        tmp = path + ".tmp"
        ckpt = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "ema": {k: v.detach().cpu() for k, v in state.ema.items()},
            "seed": state.seed,
        }
        if state.accum is not None:
            ckpt["accum"] = state.accum.state_dict()
        torch.save(ckpt, tmp)
        os.replace(tmp, path)       # never a half-written file under the name
        for old in self.steps()[:-self.keep]:
            os.unlink(self.path(old))
        return path

    def restore(self, state, step: Optional[int] = None):
        """``state`` with the checkpoint's contents (the latest by
        default) loaded into its model and optimiser."""
        ckpt = self.load(step)
        state.model.load_state_dict(ckpt["model"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        if ("accum" in ckpt) != (state.accum is not None):
            raise ValueError(
                f"checkpoint step {ckpt['step']} was "
                f"{'' if 'accum' in ckpt else 'not '}saved under --grad-accum; "
                f"resume it with the --grad-accum it was trained with")
        if state.accum is not None:
            state.accum.load_state_dict(ckpt["accum"])
        device = next(state.model.parameters()).device
        state.ema = {k: v.to(device) for k, v in ckpt["ema"].items()}
        state.step, state.seed = int(ckpt["step"]), int(ckpt["seed"])
        return state

    def load(self, step: Optional[int] = None) -> dict:
        """The checkpoint of ``step`` (the latest by default) as saved;
        a step that has none raises, naming the steps that have one."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        step = steps[-1] if step is None else step
        if step not in steps:
            raise FileNotFoundError(
                f"no checkpoint of step {step} under {self.dir}; it holds steps {steps}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)


def save_config(run_dir: str, config: Any) -> None:
    """The run's config as JSON (``evaluate`` and resume rebuild from it)."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2, default=str)


def load_config_dict(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "config.json")) as f:
        return json.load(f)
