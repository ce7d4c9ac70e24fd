"""Importance-weighted log-likelihood (port of ``lvae_tpu/eval/iwll.py``):
log p(x) ~= logsumexp_j(elbo_j) - log k over k posterior samples.

Sample ``j`` of image ``i`` is keyed ``(seed, index[i], j, layer)``, so
the estimate does not depend on ``--test-batch-size``, sweep order or
``chunk`` (the number of samples stacked into one forward of ``chunk x
B`` rows). ``logsumexp_impl``: ``'kernel'`` writes each chunk's ELBO
rows into one ``[k, B]`` matrix and reduces it with the CUDA logsumexp
(``kernels/logsumexp.py``); ``'streaming'`` folds each chunk into an
online (max, sum-exp) accumulator and never holds the matrix. Over R
ranks each rank scores its rows of every test batch (the last padded with
its final index and masked) and the masked sums are all-reduced at the
end, so every rank returns the global estimate.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from lvae_tpu_torch.data.device import eval_preprocess_batch
from lvae_tpu_torch.kernels.logsumexp import logsumexp
from lvae_tpu_torch.parallel import mesh
from lvae_tpu_torch.train.state import per_image_forward, sweep

LOGSUMEXP_IMPLS = ("kernel", "streaming")


def streaming_logsumexp_init(batch: int, device=None):
    """(running max, running sum of exp(x - max))."""
    return (torch.full((batch,), float("-inf"), device=device),
            torch.zeros(batch, device=device))


def streaming_logsumexp_update_block(carry, x_block: torch.Tensor):
    """Fold a ``[c, B]`` block into the accumulator (lvae_tpu's algebra)."""
    m, s = carry
    new_m = torch.maximum(m, x_block.amax(dim=0))
    safe = torch.where(torch.isfinite(new_m), new_m, torch.zeros_like(new_m))
    s = s * torch.exp(m - safe) + torch.exp(x_block - safe).sum(dim=0)
    return new_m, s


def streaming_logsumexp_final(carry) -> torch.Tensor:
    m, s = carry
    return m + torch.log(s)


@torch.no_grad()
def iwll_batch(model, x: torch.Tensor, index: torch.Tensor, seed: int,
               n_samples: int, logsumexp_impl: str = "kernel",
               chunk: int = 1) -> torch.Tensor:
    """Per-image IW-LL ``[B]`` of a preprocessed NHWC batch."""
    if logsumexp_impl not in LOGSUMEXP_IMPLS:
        raise ValueError(f"unknown logsumexp impl {logsumexp_impl!r}")
    if chunk < 1:
        raise ValueError(f"--iw-chunk must be >= 1, got {chunk}")
    b = x.shape[0]
    kernel = logsumexp_impl == "kernel"
    elbos, carry = None, streaming_logsumexp_init(b, x.device)
    for j0 in range(0, n_samples, chunk):
        c = min(chunk, n_samples - j0)
        sample = torch.arange(j0, j0 + c, device=x.device).repeat_interleave(b)
        ll, kl_sep = per_image_forward(
            model, x.repeat(c, 1, 1, 1), index.repeat(c), seed, sample
        )
        if kernel:
            if elbos is None:                       # [k, B], once per batch
                elbos = ll.new_empty(n_samples, b)
            torch.sub(ll, kl_sep.sum(dim=0), out=elbos[j0:j0 + c].view(-1))
        else:
            carry = streaming_logsumexp_update_block(carry, (ll - kl_sep.sum(dim=0)).view(c, b))
    lse = logsumexp(elbos) if kernel else streaming_logsumexp_final(carry)
    return lse - math.log(n_samples)


@torch.no_grad()
def evaluate_iwll(model, test_u8: torch.Tensor, preprocess: str,
                  data_dims: int, n_samples: int = 100, batch_size: int = 1000,
                  seed: int = 0, logsumexp_impl: str = "kernel",
                  chunk: int = 1, max_batches: Optional[int] = None) -> dict:
    """IW-LL sweep over the device-resident uint8 test split: mean LL
    (nats/image), bpd, and the synchronised wall time; over R ranks
    (:func:`lvae_tpu_torch.parallel.mesh.current`) the global estimate on
    every rank."""
    layout = mesh.current()
    device = test_u8.device
    total = torch.zeros((), dtype=torch.float64, device=device)
    valid_n = torch.zeros((), dtype=torch.float64, device=device)
    count = 0
    t0 = time.perf_counter()
    for index, batch, valid in sweep(test_u8, batch_size, layout, max_batches):
        x = eval_preprocess_batch(batch, preprocess, index)
        ll = iwll_batch(model, x, index, seed, n_samples, logsumexp_impl, chunk)
        if valid is not None:
            ll = torch.where(valid, ll, 0.0)
            valid_n += valid.sum()
        total += ll.sum(dtype=torch.float64)
        count += ll.shape[0]
    if layout.sharded:
        total, valid_n = mesh.all_reduce_(torch.stack([total, valid_n]), layout).unbind(0)
        count = int(valid_n)
    mean_ll = float(total) / max(count, 1)  # reads back: waits for the device
    wall = time.perf_counter() - t0
    return {
        "iw_ll": mean_ll,
        "iw_bpd": -mean_ll / (data_dims * np.log(2.0)),
        "n_samples": n_samples,
        "n_images": count,
        "wall_s": wall,
        "images_per_sec": count / wall if wall > 0 else float("nan"),
    }
