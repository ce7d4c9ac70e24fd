"""Likelihood log-probabilities (port of ``lvae_tpu/ops/likelihoods.py``;
Bernoulli only on this slice)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bernoulli_log_prob(x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Elementwise log Bernoulli(x; sigmoid(logits)), in the stable
    log-sigmoid form."""
    return x * F.logsigmoid(logits) + (1.0 - x) * F.logsigmoid(-logits)
