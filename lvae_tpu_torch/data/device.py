"""Eval preprocessing on the device (port of
``lvae_tpu/data/device.py:eval_preprocess_batch``)."""

from __future__ import annotations

from typing import Optional

import torch

from lvae_tpu_torch.data.registry import (
    PREPROCESS_BINARIZE,
    PREPROCESS_DEQUANTIZE,
    PREPROCESS_NONE,
)
from lvae_tpu_torch.ops.philox import STREAM_BINARIZE, keyed_uniform

# binarisation has a fixed seed: the test set is the same in every
# evaluation, whatever the eval seed
BINARIZE_SEED = 0


def eval_preprocess_batch(batch_u8: torch.Tensor, mode: str,
                          index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 NHWC batch -> float32 model input in [0, 1].

    ``binarize`` draws each image from Bernoulli(u8 / 255) keyed by
    ``(BINARIZE_SEED, index[i])`` on its own Philox stream, so an image's
    binarisation does not depend on the batch it sits in (``index``
    defaults to the batch positions). ``dequantize`` takes the bin
    centre."""
    if mode == PREPROCESS_NONE:
        return batch_u8.to(torch.float32)
    if mode == PREPROCESS_BINARIZE:
        if index is None:
            index = torch.arange(batch_u8.shape[0], device=batch_u8.device)
        probs = batch_u8.to(torch.float32) / 255.0
        u = keyed_uniform(batch_u8.shape, BINARIZE_SEED,
                          index.to(batch_u8.device), 0, STREAM_BINARIZE)
        return (u <= probs).to(torch.float32)  # u in (0, 1]: P = probs
    if mode == PREPROCESS_DEQUANTIZE:
        return (batch_u8.to(torch.float32) + 0.5) / 256.0
    raise ValueError(f"unknown preprocess mode {mode!r}")
