"""Image grids (numpy + PIL, on the host; port of ``lvae_tpu/eval/viz.py``).

Tiles a ``[N, H, W, C]`` float batch in [0, 1] into one grid image with a
padding value between cells and writes it as a PNG: the sample,
reconstruction, spatial-KL and generation-diagnostics grids of
``Experiment.dump_images`` and ``evaluate``. Arrays are NHWC, as in
``lvae_tpu``; the model's public outputs are NHWC already, so a caller
moves them to the host (``.cpu().numpy()``) and passes them as they are.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np


def make_grid(
    images: np.ndarray,
    ncol: Optional[int] = None,
    pad: int = 2,
    pad_value: float = 0.5,
) -> np.ndarray:
    """[N,H,W,C] floats in [0,1] -> [H',W',C] grid with `pad` px spacing."""
    images = np.asarray(images, dtype=np.float32)
    n, h, w, c = images.shape
    if ncol is None:
        ncol = int(math.ceil(math.sqrt(n)))
    nrow = int(math.ceil(n / ncol))
    grid = np.full(
        (nrow * (h + pad) + pad, ncol * (w + pad) + pad, c),
        pad_value,
        dtype=np.float32,
    )
    for i in range(n):
        r, col = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        grid[y : y + h, x : x + w, :] = images[i]
    return grid


def save_image_grid(
    images: np.ndarray,
    path: str,
    ncol: Optional[int] = None,
    pad_value: float = 0.5,
) -> np.ndarray:
    """Write a PNG grid; returns the grid array (for TensorBoard)."""
    from PIL import Image

    grid = make_grid(images, ncol=ncol, pad_value=pad_value)
    arr = np.clip(grid * 255.0, 0, 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)
    return grid
