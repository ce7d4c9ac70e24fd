"""Likelihood log-probabilities (port of ``lvae_tpu/ops/likelihoods.py``):
Bernoulli, Gaussian, the 256-bin discretized logistic and the PixelCNN++
discretized logistic mixture with linear channel autoregression.

The signatures are ``lvae_tpu``'s: images in [0, 1], channels last, and
per-element log-probs (per-pixel for the mixture, whose channels are
coupled). The model keeps channels on axis 1 (NCHW): the elementwise
functions take any layout, and the mixture takes the channel axis as
``dim``. fp32 math, as in ``lvae_tpu``. ``discretized_logistic_mix_log_prob``
is the plain version of the mixture kernel K3 (``kernels/mixture.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG_SCALE_MIN = -7.0   # the log-scale floor of both logistic heads


def bernoulli_log_prob(x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Elementwise log Bernoulli(x; sigmoid(logits)), in the stable
    log-sigmoid form."""
    return x * F.logsigmoid(logits) + (1.0 - x) * F.logsigmoid(-logits)


def gaussian_likelihood_log_prob(x: torch.Tensor, mean: torch.Tensor,
                                 log_var: torch.Tensor) -> torch.Tensor:
    """Elementwise log N(x; mean, exp(log_var))."""
    return -0.5 * (math.log(2.0 * math.pi) + log_var
                   + (x - mean) ** 2 * torch.exp(-log_var))


def _log_cdf_diff(minus_in: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """log(sigmoid(a + delta) - sigmoid(a)) without cancellation:
    ``b + log(-expm1(-delta)) - softplus(a) - softplus(b)``, b = a + delta,
    with ``delta > 0`` formed from the bin width."""
    plus_in = minus_in + delta
    return (plus_in + torch.log(-torch.expm1(-delta))
            - F.softplus(minus_in) - F.softplus(plus_in))


def discretized_logistic_log_prob(x: torch.Tensor, mean: torch.Tensor,
                                  log_scale: torch.Tensor,
                                  n_bins: int = 256) -> torch.Tensor:
    """Elementwise log-prob of x (levels k/(n_bins-1) in [0, 1]) under a
    logistic discretized to ``n_bins`` bins; the edge bins integrate to
    -inf and +inf."""
    inv_scale = torch.exp(-log_scale)
    half_bin = 1.0 / (2.0 * (n_bins - 1))
    plus_in = inv_scale * (x + half_bin - mean)
    minus_in = inv_scale * (x - half_bin - mean)
    delta = (2.0 * half_bin) * inv_scale
    log_interior = _log_cdf_diff(minus_in, delta)
    log_left = F.logsigmoid(plus_in)
    log_right = F.logsigmoid(-minus_in)
    lo = 0.5 / (n_bins - 1)
    hi = 1.0 - 0.5 / (n_bins - 1)
    return torch.where(x < lo, log_left, torch.where(x > hi, log_right, log_interior))


def mixture_slabs(params: torch.Tensor, k: int, c: int):
    """``(logit_pi [..., K], means, log_scales (floored), tanh(coeffs))``
    of a channels-last mixture map ``[..., K(1 + 3C)]``, the last three
    ``[..., K, C]``: component j, channel c is slab entry ``C j + c``."""
    shape = params.shape[:-1] + (k, c)
    logit_pi = params[..., :k]
    means = params[..., k:k + k * c].reshape(shape)
    log_scales = params[..., k + k * c:k + 2 * k * c].reshape(shape).clamp_min(LOG_SCALE_MIN)
    coeffs = torch.tanh(params[..., k + 2 * k * c:k + 3 * k * c].reshape(shape))
    return logit_pi, means, log_scales, coeffs


def discretized_logistic_mix_log_prob(x: torch.Tensor, params: torch.Tensor,
                                      n_components: int = 10, n_bins: int = 256,
                                      dim: int = -1) -> torch.Tensor:
    """Per-pixel log-prob under a discretized logistic mixture with linear
    channel autoregression (PixelCNN++).

    ``x``: ``[..., C]`` with C in {1, 3}, values in [0, 1]; ``params``:
    ``[..., K(1 + 3C)]``, per component ``[logit_pi (K)] ++ [means (KC)] ++
    [log_scales (KC)] ++ [coeffs (KC)]`` (coeffs unused for C = 1).
    ``dim`` is the channel axis of both (1 for the model's NCHW). Returns
    the per-pixel log-prob, ``x``'s shape without ``dim``.
    """
    if dim not in (-1, x.dim() - 1):
        x, params = x.movedim(dim, -1), params.movedim(dim, -1)
    c = x.shape[-1]
    k = n_components
    logit_pi, means, log_scales, coeffs = mixture_slabs(params, k, c)
    xs = (2.0 * x - 1.0).unsqueeze(-2)          # [..., 1, C] on [-1, 1]
    if c == 3:
        m1 = means[..., 1] + coeffs[..., 0] * xs[..., 0]
        m2 = means[..., 2] + coeffs[..., 1] * xs[..., 0] + coeffs[..., 2] * xs[..., 1]
        means = torch.stack([means[..., 0], m1, m2], dim=-1)
    centered = xs - means
    inv_s = torch.exp(-log_scales)
    half_bin = 1.0 / (n_bins - 1)               # bin half-width on [-1, 1]
    plus_in = inv_s * (centered + half_bin)
    minus_in = inv_s * (centered - half_bin)
    delta = (2.0 * half_bin) * inv_s
    log_interior = _log_cdf_diff(minus_in, delta)
    log_left = F.logsigmoid(plus_in)
    log_right = F.logsigmoid(-minus_in)
    log_probs_c = torch.where(xs < -1.0 + half_bin, log_left,
                              torch.where(xs > 1.0 - half_bin, log_right, log_interior))
    log_probs_k = log_probs_c.sum(dim=-1) + F.log_softmax(logit_pi, dim=-1)
    return torch.logsumexp(log_probs_k, dim=-1)
