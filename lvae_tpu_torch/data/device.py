"""Preprocessing and the device-resident dataset (port of
``lvae_tpu/data/device.py``)."""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from lvae_tpu_torch.data.registry import (
    PREPROCESS_BINARIZE,
    PREPROCESS_DEQUANTIZE,
    PREPROCESS_NONE,
)
from lvae_tpu_torch.ops.philox import (
    STREAM_BINARIZE,
    STREAM_TRAIN_BINARIZE,
    STREAM_TRAIN_DEQUANTIZE,
    Ints,
    keyed_uniform,
)

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


def preprocess_batch(batch_u8: torch.Tensor, mode: str, seed: int,
                     index: torch.Tensor, step: Ints) -> torch.Tensor:
    """Training preprocessing: uint8 NHWC batch -> float32 model input.

    ``binarize`` draws image ``i`` from Bernoulli(u8 / 255) and
    ``dequantize`` adds uniform noise in (0, 1], both keyed by ``(seed,
    index[i], step)`` on their own Philox streams, so a step's input is a
    function of the step alone (``lvae_tpu`` keys them per step from its
    train key). ``step`` is an int or a 0-d int64 tensor on the batch's
    device, read there (a captured train step's)."""
    if mode == PREPROCESS_NONE:
        return batch_u8.to(torch.float32)
    index = index.to(batch_u8.device)
    if mode == PREPROCESS_BINARIZE:
        probs = batch_u8.to(torch.float32) / 255.0
        u = keyed_uniform(batch_u8.shape, seed, index, step, STREAM_TRAIN_BINARIZE)
        return (u <= probs).to(torch.float32)
    if mode == PREPROCESS_DEQUANTIZE:
        u = keyed_uniform(batch_u8.shape, seed, index, step, STREAM_TRAIN_DEQUANTIZE)
        return (batch_u8.to(torch.float32) + u) / 256.0
    raise ValueError(f"unknown preprocess mode {mode!r}")


class DeviceDataset:
    """A uint8 NHWC split resident on one device, gathered per step by an
    index tensor (``lvae_tpu``'s ``DeviceDataset``)."""

    def __init__(self, array_u8: np.ndarray, device: torch.device):
        self.array = torch.from_numpy(np.ascontiguousarray(array_u8, dtype=np.uint8)).to(device)
        self.n = self.array.shape[0]

    def epoch_indices(self, rng: np.random.Generator,
                      batch_size: int) -> Iterator[torch.Tensor]:
        """One epoch's shuffle as ``[batch_size]`` int64 index vectors on
        the device (the remainder is dropped), drawn as ``lvae_tpu`` draws
        it. The permutation is copied to the device once per epoch: a copy
        per step would make the host wait for the device at every step."""
        perm = torch.from_numpy(rng.permutation(self.n)).to(self.array.device)
        for i in range(0, (self.n // batch_size) * batch_size, batch_size):
            yield perm[i : i + batch_size]

    def gather(self, index: torch.Tensor) -> torch.Tensor:
        return self.array.index_select(0, index)
