"""Shape, schedule and dropout utilities (port of ``lvae_tpu/ops/math.py``).
The shape ops take NHWC, like the reference package's public layout."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def pad_img_tensor(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Zero-pad an NHWC batch, centred, up to spatial ``size`` (the odd
    pixel goes bottom/right)."""
    h, w = x.shape[1], x.shape[2]
    th, tw = int(size[0]), int(size[1])
    dh, dw = th - h, tw - w
    if dh < 0 or dw < 0:
        raise ValueError(f"pad target {size} smaller than input {(h, w)}")
    if dh == 0 and dw == 0:
        return x
    # F.pad pads from the last axis backwards: (C), (W), (H)
    return F.pad(x, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


def crop_img_tensor(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Centre-crop an NHWC batch down to spatial ``size``."""
    h, w = x.shape[1], x.shape[2]
    th, tw = int(size[0]), int(size[1])
    dh, dw = h - th, w - tw
    if dh < 0 or dw < 0:
        raise ValueError(f"crop target {size} larger than input {(h, w)}")
    if dh == 0 and dw == 0:
        return x
    return x[:, dh // 2 : dh // 2 + th, dw // 2 : dw // 2 + tw, :]


def linear_anneal(step: int, start_value: float, end_value: float,
                  n_steps: int) -> float:
    """Linear schedule from ``start_value`` to ``end_value`` over
    ``n_steps`` (the KL-warmup beta), rounded as ``lvae_tpu`` rounds it:
    the fraction is an fp32 division clipped to [0, 1]."""
    if n_steps <= 0:
        return float(np.float32(end_value))
    frac = np.clip(np.float32(step) / np.float32(n_steps), np.float32(0), np.float32(1))
    return float(np.float32(start_value) + np.float32(end_value - start_value) * frac)


def free_bits_kl(kl_per_layer: torch.Tensor, free_bits: float) -> torch.Tensor:
    """Free-bits clamp on the *batch mean* of each layer's KL: ``[L, B]``
    -> ``[L]``, each layer's mean clamped below at ``free_bits`` nats (a
    clamped layer passes no gradient)."""
    mean_per_layer = kl_per_layer.mean(dim=1)
    if free_bits <= 0.0:
        return mean_per_layer
    return torch.clamp_min(mean_per_layer, free_bits)


def bits8_keep_threshold(rate: float) -> int:
    """Integer keep threshold for uint8-bits dropout: an element is kept
    iff its random byte ``< t``, so the keep probability is ``t / 256``.
    ``t >= 256`` keeps everything, ``t <= 0`` drops everything."""
    if rate <= 0.0:
        return 256
    return int(round((1.0 - rate) * 256.0))


def bits8_dropout_f32(u: torch.Tensor, generator: torch.Generator,
                      t: int) -> torch.Tensor:
    """uint8-bits dropout at threshold ``t`` (0 < t < 256): bytes drawn
    from ``generator`` on ``u``'s device, survivors scaled by the realised
    keep probability's inverse ``256 / t`` in fp32."""
    bits = torch.randint(0, 256, u.shape, dtype=torch.uint8, device=u.device,
                         generator=generator)
    return torch.where(bits < t, u * float(np.float32(256.0 / t)), 0.0)
