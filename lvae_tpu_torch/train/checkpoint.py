"""Checkpoints and the run's ``config.json`` (the port's counterpart of
``lvae_tpu/train/checkpoint.py``, with ``torch.save`` for orbax).

A checkpoint is one file, ``<run dir>/checkpoints/ckpt_<step>.pt``: a dict
of the model's ``state_dict`` (``"model"``), the optimiser's, the step,
the metric EMA and the noise seed. ``lvae_tpu_torch.evaluate
--state-dict`` loads it as it is (it takes the ``"model"`` entry), so a
trained run can be evaluated at once; ``--load`` and ``--auto-resume``
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
        torch.save({
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "ema": {k: v.detach().cpu() for k, v in state.ema.items()},
            "seed": state.seed,
        }, tmp)
        os.replace(tmp, path)       # never a half-written file under the name
        for old in self.steps()[:-self.keep]:
            os.unlink(self.path(old))
        return path

    def restore(self, state, step: Optional[int] = None):
        """``state`` with the checkpoint's contents (the latest by
        default) loaded into its model and optimiser."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        ckpt = torch.load(self.path(step), map_location="cpu", weights_only=True)
        state.model.load_state_dict(ckpt["model"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        device = next(state.model.parameters()).device
        state.ema = {k: v.to(device) for k, v in ckpt["ema"].items()}
        state.step, state.seed = int(ckpt["step"]), int(ckpt["seed"])
        return state


def save_config(run_dir: str, config: Any) -> None:
    """The run's config as JSON (``evaluate`` and resume rebuild from it)."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2, default=str)


def load_config_dict(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "config.json")) as f:
        return json.load(f)
