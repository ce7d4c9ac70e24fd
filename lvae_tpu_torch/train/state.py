"""The eval half of ``lvae_tpu/train/state.py``: the per-image forward and
the test-ELBO sweep.

``lvae_tpu`` vmaps a B=1 forward so that image ``i`` draws from
``fold_in(key, index[i])``. The port runs the batch as one batch: eval
BatchNorm uses running statistics, so rows do not interact, and the
noise of row ``i`` depends only on ``(seed, index[i], sample, layer)``
(``models/stochastic.py``). Test ELBO is therefore the same for any
``--test-batch-size`` and sweep order.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from lvae_tpu_torch.data.device import eval_preprocess_batch
from lvae_tpu_torch.models.stochastic import Noise


def per_image_forward(model, x: torch.Tensor, index: torch.Tensor, seed: int,
                      sample=0):
    """``(ll [B], kl_sep [L, B])`` with image ``i``'s latents keyed by
    ``(seed, index[i], sample)``."""
    out = model(x, noise=Noise(seed, index, sample))
    return out["ll"], out["kl_sep"]


def test_batches(test_u8: torch.Tensor, batch_size: int,
                 max_batches: Optional[int] = None):
    """Sequential sweep: ``(index, batch)`` pairs; the last batch may be
    short (eager PyTorch needs no padding to one compiled shape)."""
    n = test_u8.shape[0]
    for bi, start in enumerate(range(0, n, batch_size)):
        if max_batches is not None and bi >= max_batches:
            break
        stop = min(start + batch_size, n)
        index = torch.arange(start, stop, device=test_u8.device)
        yield index, test_u8[start:stop]


class EvalAccumulator:
    """On-device sums of ll / kl / elbo / per-layer kl and the image count
    (the carry of ``lvae_tpu``'s ``make_eval_accum_step``); the host reads
    them once, in :meth:`result`."""

    def __init__(self, n_layers: int, device):
        z = lambda *s: torch.zeros(s, dtype=torch.float64, device=device)  # noqa: E731
        self.ll, self.kl, self.elbo = z(), z(), z()
        self.kl_layers = z(n_layers)
        self.count = 0

    def add(self, ll: torch.Tensor, kl_sep: torch.Tensor) -> None:
        kl = kl_sep.sum(dim=0)
        self.ll += ll.sum(dtype=torch.float64)
        self.kl += kl.sum(dtype=torch.float64)
        self.elbo += (ll - kl).sum(dtype=torch.float64)
        self.kl_layers += kl_sep.sum(dim=1, dtype=torch.float64)
        self.count += ll.shape[0]

    def result(self, data_dims: int) -> dict:
        count = max(self.count, 1)
        m = {k: float(getattr(self, k)) / count for k in ("ll", "kl", "elbo")}
        m["kl_layers"] = self.kl_layers.cpu().numpy() / count
        m["bpd"] = -m["elbo"] / (data_dims * np.log(2.0))
        m["n_images"] = self.count
        return m


@torch.no_grad()
def evaluate_elbo(model, test_u8: torch.Tensor, preprocess: str,
                  batch_size: int, data_dims: int, seed: int = 0,
                  max_batches: Optional[int] = None) -> dict:
    """Test-set ELBO over the device-resident uint8 split ``test_u8``
    (NHWC), with the wall time of the sweep (synchronised)."""
    device = test_u8.device
    acc = EvalAccumulator(model.n_layers, device)
    t0 = time.perf_counter()
    for index, batch in test_batches(test_u8, batch_size, max_batches):
        x = eval_preprocess_batch(batch, preprocess, index)
        acc.add(*per_image_forward(model, x, index, seed))
    m = acc.result(data_dims)       # reads the sums back: waits for the device
    wall = time.perf_counter() - t0
    m["wall_s"] = wall
    m["images_per_sec"] = m["n_images"] / wall if wall > 0 else float("nan")
    return m
