"""``lvae_tpu`` weights -> the port's ``state_dict`` (numpy only).

Two routes reach the port:

- :func:`params_from_flax` takes ``lvae_tpu``'s ``(params, batch_stats)``
  trees as nested dicts of numpy arrays and re-implements
  ``lvae_tpu/train/convert.py``'s ``torch_key_for`` / ``_to_torch_leaf``
  bit-exactly (pure transposes and flips);
- a ``.pt`` written by ``tools/export_torch_checkpoint.py`` (that
  function's output, saved with ``torch.save``) loads as it is, with
  :func:`load_state_dict_file`, and needs no orbax; so does a checkpoint
  of the port's own trainer.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

_LEAF_TO_TORCH = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def torch_key_for(path: tuple) -> str:
    """Dotted ``state_dict`` key of a flax tree path."""
    if path[-1] == "top_prior":
        return ".".join(path)
    return ".".join((*path[:-1], _LEAF_TO_TORCH[path[-1]]))


def _to_torch_leaf(path: tuple, value) -> np.ndarray:
    leaf = path[-1]
    v = np.array(value, dtype=np.float32)
    if leaf == "top_prior":
        return np.ascontiguousarray(v.transpose(0, 3, 1, 2))      # NHWC -> NCHW
    if leaf == "kernel":
        if any("ConvTranspose" in c for c in path):
            # flax [kh, kw, in, out], taps flipped -> torch [in, out, kh, kw]
            return np.ascontiguousarray(v[::-1, ::-1].transpose(2, 3, 0, 1))
        return np.ascontiguousarray(v.transpose(3, 2, 0, 1))      # -> [out, in, kh, kw]
    return v


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def params_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
                     ) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from ``lvae_tpu``'s trees (every
    BatchNorm also gets ``num_batches_tracked`` = 0, as
    ``flax_to_torch_state_dict`` writes)."""
    out: dict[str, torch.Tensor] = {}
    for path, val in _flatten(params):
        out[torch_key_for(path)] = torch.from_numpy(_to_torch_leaf(path, val))
    for path, val in _flatten(batch_stats or {}):
        out[torch_key_for(path)] = torch.from_numpy(_to_torch_leaf(path, val))
        if path[-1] == "mean":
            out[".".join((*path[:-1], "num_batches_tracked"))] = torch.tensor(
                0, dtype=torch.int64
            )
    return out


def load_state_dict_file(path: str, map_location="cpu") -> dict[str, torch.Tensor]:
    """A ``torch.save``d state dict of tensors, or the ``"model"`` entry of
    a checkpoint the port's trainer wrote, or a ``"state_dict"`` entry as
    ``tools/convert_torch_checkpoint.py:55-57`` unwraps it (loaded with
    ``weights_only``: no pickled code runs)."""
    d = torch.load(path, map_location=map_location, weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(d.get(key), dict):
            return d[key]
    return d
