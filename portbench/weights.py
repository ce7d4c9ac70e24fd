"""The weights of a run, drawn from its seed on the device in one call.

Every parameter and BatchNorm statistic, by name, as the plain reference
names them (the port's names are the same). One standard-normal draw of
the total size from a ``torch.Generator`` on the device, cut into the
tensors and scaled by kind:

- a conv kernel: std ``1 / sqrt(fan_in)`` (lecun normal, the program's
  own init); the heads (the Gaussian heads ``conv_in_p``, ``conv_in_q``
  and the likelihood head) std ``1e-2``, as the program starts them, or
  with ``head_scales`` (a mix that scores a trained model) the given
  multiple of lecun normal, so that the heads' maps spread as a trained
  model's do and each image's likelihood hangs on the whole network (at
  ``1e-2`` it barely moves with the convolutions' rounding);
- a bias, a BatchNorm shift, the top prior: std ``0.05``; a BatchNorm
  scale ``1 + 0.05 n``;
- a running mean std ``0.05``, a running variance ``exp(0.1 n)``.

So no term starts at exactly zero, and evaluation's BatchNorm reads
statistics of its own.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

_HEADS = {"gaussian": ("conv_in_p.", "conv_in_q."),
          "likelihood": ("likelihood_head.param_conv.",)}


def _scaled(name: str, n: torch.Tensor, head_scales: Optional[Dict[str, float]]
            ) -> torch.Tensor:
    if name.endswith("running_var"):
        return torch.exp(0.1 * n)
    if n.dim() == 4 and not name.endswith("top_prior"):      # a conv kernel
        fan_in = n.shape[0] if "ConvTranspose" in name else n.shape[1]
        lecun = n / math.sqrt(fan_in * n.shape[2] * n.shape[3])
        for head, prefixes in _HEADS.items():
            if any(h in name for h in prefixes):
                return 0.01 * n if head_scales is None else head_scales[head] * lecun
        return lecun
    if "BatchNorm" in name and name.endswith("weight"):
        return 1.0 + 0.05 * n
    return 0.05 * n


def make(shapes: Dict[str, torch.Size], seed: int, device,
         head_scales: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``{name: shape}`` from ``seed``."""
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(shapes.items(), torch.split(flat, sizes)):
        out[name] = _scaled(name, part.view(shape), head_scales)
    return out
