"""Shape utilities (port of ``lvae_tpu/ops/math.py``). NHWC, like the
reference package's public layout."""

from __future__ import annotations

from typing import Sequence

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
