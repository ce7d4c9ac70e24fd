"""Gaussian reparameterisation and analytic KL (port of
``lvae_tpu/ops/stochastic.py``); the plain oracles of the sample+KL
kernel.

A params tensor is the channel concatenation ``[mu, log_var]``. The port
keeps channels on axis 1 (NCHW) inside its modules, so :func:`split_params`
takes the axis; the halves are views and nothing is copied.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lvae_tpu_torch.ops.philox import Ints, keyed_normal


def split_params(params: torch.Tensor, dim: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``params`` into (mu, log_var) halves along ``dim`` (views)."""
    c = params.shape[dim] // 2
    return params.narrow(dim, 0, c), params.narrow(dim, c, c)


def normal_rsample(mu: torch.Tensor, log_var: torch.Tensor, seed: int,
                   index: torch.Tensor, sample: Ints, stream: int,
                   temperature: float = 1.0) -> torch.Tensor:
    """z = mu + T * sigma * eps, with eps from the keyed Philox generator
    (row ``i`` keyed by ``(seed, index[i], sample[i], stream)``)."""
    eps = keyed_normal(mu.shape, seed, index, sample, stream)
    return mu + temperature * torch.exp(0.5 * log_var) * eps


def gaussian_kl(q_mu: torch.Tensor, q_log_var: torch.Tensor,
                p_mu: torch.Tensor, p_log_var: torch.Tensor) -> torch.Tensor:
    """Elementwise KL( N(q_mu, q_var) || N(p_mu, p_var) )."""
    var_ratio = torch.exp(q_log_var - p_log_var)
    t1 = (q_mu - p_mu) ** 2 * torch.exp(-p_log_var)
    return 0.5 * (var_ratio + t1 - 1.0 - (q_log_var - p_log_var))
