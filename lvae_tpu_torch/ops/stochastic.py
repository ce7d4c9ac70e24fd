"""Gaussian reparameterisation, the logistic draw and the analytic KL
(port of ``lvae_tpu/ops/stochastic.py``); the plain oracles of the
sample+KL kernel.

A params tensor is the channel concatenation ``[mu, log_var]``. The port
keeps channels on axis 1 (NCHW) inside its modules, so :func:`split_params`
takes the axis; the halves are views and nothing is copied.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lvae_tpu_torch.ops.philox import Band, Ints, keyed_normal, keyed_uniform


def split_params(params: torch.Tensor, dim: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``params`` into (mu, log_var) halves along ``dim`` (views)."""
    c = params.shape[dim] // 2
    return params.narrow(dim, 0, c), params.narrow(dim, c, c)


def normal_rsample(mu: torch.Tensor, log_var: torch.Tensor, seed: int,
                   index: torch.Tensor, sample: Ints, stream: int,
                   temperature: float = 1.0, band: Optional[Band] = None) -> torch.Tensor:
    """z = mu + T * sigma * eps, with eps from the keyed Philox generator
    (row ``i`` keyed by ``(seed, index[i], sample[i], stream)``; ``band``:
    the maps are a band of rows of taller ones, ``ops/philox.py``)."""
    eps = keyed_normal(mu.shape, seed, index, sample, stream, band)
    return mu + temperature * torch.exp(0.5 * log_var) * eps


def logistic_rsample(mu: torch.Tensor, log_scale: torch.Tensor,
                     u: Optional[torch.Tensor] = None, *,
                     generator: Optional[torch.Generator] = None,
                     keyed: Optional[tuple] = None) -> torch.Tensor:
    """z = mu + e^log_scale * logit(u), a Logistic(mu, e^log_scale) draw.

    ``u``: uniforms of ``mu``'s shape given as an operand (a test hands in
    numpy's or JAX's), or drawn from ``generator`` (a ``torch.Generator`` on
    ``mu``'s device) or from the keyed Philox, ``keyed=(seed, index, sample,
    stream)``. Clipped to [1e-6, 1 - 1e-6] for a finite logit, the range
    ``lvae_tpu`` draws from."""
    if u is None:
        if (generator is None) == (keyed is None):
            raise ValueError("pass u, or exactly one of generator= and keyed=")
        if keyed is not None:
            u = keyed_uniform(mu.shape, *keyed).to(mu.dtype)
        else:
            u = torch.rand(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    u = u.clamp(1e-6, 1.0 - 1e-6)
    return mu + torch.exp(log_scale) * (torch.log(u) - torch.log1p(-u))


def gaussian_kl(q_mu: torch.Tensor, q_log_var: torch.Tensor,
                p_mu: torch.Tensor, p_log_var: torch.Tensor) -> torch.Tensor:
    """Elementwise KL( N(q_mu, q_var) || N(p_mu, p_var) )."""
    var_ratio = torch.exp(q_log_var - p_log_var)
    t1 = (q_mu - p_mu) ** 2 * torch.exp(-p_log_var)
    return 0.5 * (var_ratio + t1 - 1.0 - (q_log_var - p_log_var))
