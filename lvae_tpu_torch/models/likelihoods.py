"""Likelihood heads (port of ``lvae_tpu/models/likelihoods.py``): decoder
features -> output distribution.

Each head maps the final top-down features ``[B, c_in, H, W]`` to its
parameters with a 1x1 ``param_conv`` (the flax name, so ``params_from_flax``
loads it strictly), in fp32 whatever the convs' dtype, and returns the
per-element log-likelihood ``[B, C, H, W]`` of the target (NCHW) and a dict
with ``params``, ``mean`` and ``mode``. The mixture head's per-pixel
log-prob is spread evenly over the C channels, so every head returns the
same shape. With ``fused``, the mixture head's log-prob is the CUDA kernel
K3 (``kernels/mixture.py``), whose backward is K3-bwd.

:func:`sample_from_likelihood` draws an image from a head's ``params``
(channels last, as the model returns them), outside the model.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from lvae_tpu_torch.config import LIKELIHOODS
from lvae_tpu_torch.kernels.mixture import mix_log_prob
from lvae_tpu_torch.models.blocks import Conv2d
from lvae_tpu_torch.ops.likelihoods import (
    LOG_SCALE_MIN,
    bernoulli_log_prob,
    discretized_logistic_log_prob,
    discretized_logistic_mix_log_prob,
    gaussian_likelihood_log_prob,
    mixture_slabs,
)
from lvae_tpu_torch.ops.philox import (
    STREAM_SAMPLE_DRAW,
    STREAM_SAMPLE_SELECT,
    keyed_normal,
    keyed_uniform,
)
from lvae_tpu_torch.ops.stochastic import logistic_rsample, split_params


class BernoulliLikelihood(nn.Module):
    """Bernoulli over binary images; the params are logits."""

    def __init__(self, c_in: int, color_ch: int):
        super().__init__()
        self.param_conv = Conv2d(c_in, color_ch, 1, init_std=1e-2)

    def forward(self, h: torch.Tensor, x: Optional[torch.Tensor]
                ) -> Tuple[Optional[torch.Tensor], dict]:
        logits = self.param_conv(h).float()   # fp32 whatever the convs' dtype
        mean = torch.sigmoid(logits)
        data = {"params": logits, "mean": mean, "mode": torch.round(mean)}
        ll = bernoulli_log_prob(x, logits) if x is not None else None
        return ll, data


class GaussianLikelihood(nn.Module):
    """Gaussian with a learned per-pixel mean and log-variance."""

    def __init__(self, c_in: int, color_ch: int):
        super().__init__()
        self.param_conv = Conv2d(c_in, 2 * color_ch, 1, init_std=1e-2)

    def forward(self, h, x):
        params = self.param_conv(h).float()
        mean, log_var = split_params(params)
        data = {"params": params, "mean": mean, "mode": mean}
        if x is None:
            return None, data
        return gaussian_likelihood_log_prob(x, mean, log_var), data


class DiscretizedLogisticLikelihood(nn.Module):
    """256-bin discretized logistic; the params are (mean, log_scale), the
    log-scale floored at -7."""

    def __init__(self, c_in: int, color_ch: int, n_bins: int = 256):
        super().__init__()
        self.n_bins = n_bins
        self.param_conv = Conv2d(c_in, 2 * color_ch, 1, init_std=1e-2)

    def forward(self, h, x):
        mean, log_scale = split_params(self.param_conv(h).float())
        log_scale = log_scale.clamp_min(LOG_SCALE_MIN)
        data = {"params": torch.cat([mean, log_scale], dim=1), "mean": mean, "mode": mean}
        if x is None:
            return None, data
        return discretized_logistic_log_prob(x, mean, log_scale, self.n_bins), data


class DiscretizedLogisticMixLikelihood(nn.Module):
    """PixelCNN++ mixture of discretized logistics with linear channel
    autoregression; the mean (and mode) is the mixture's mean of the
    component means, coefficients ignored, on [0, 1]."""

    def __init__(self, c_in: int, color_ch: int, n_components: int = 10,
                 n_bins: int = 256, fused: bool = False):
        super().__init__()
        self.color_ch, self.n_components, self.n_bins = color_ch, n_components, n_bins
        self.fused = fused
        self.param_conv = Conv2d(c_in, n_components * (1 + 3 * color_ch), 1, init_std=1e-2)

    def forward(self, h, x):
        k, c = self.n_components, self.color_ch
        params = self.param_conv(h).float()
        b, _, hh, ww = params.shape
        pi = torch.softmax(params[:, :k], dim=1).unsqueeze(2)          # [B, K, 1, H, W]
        means = params[:, k:k + k * c].reshape(b, k, c, hh, ww)
        mix_mean = (((pi * means).sum(dim=1) + 1.0) / 2.0).clamp(0.0, 1.0)
        data = {"params": params, "mean": mix_mean, "mode": mix_mean}
        if x is None:
            return None, data
        if self.fused:
            ll_pixel = mix_log_prob(x.to(params.dtype).contiguous(), params, k, self.n_bins)
        else:
            ll_pixel = discretized_logistic_mix_log_prob(x, params, k, self.n_bins, dim=1)
        return (ll_pixel / c).unsqueeze(1).expand(-1, c, -1, -1), data


def make_likelihood(name: str, c_in: int, color_ch: int,
                    fused_mixture: bool = False) -> nn.Module:
    """The head ``name`` over ``c_in`` feature channels; ``fused_mixture``
    puts the mixture head's log-prob on K3."""
    if name == "bernoulli":
        return BernoulliLikelihood(c_in, color_ch)
    if name == "gaussian":
        return GaussianLikelihood(c_in, color_ch)
    if name == "discretized_logistic":
        return DiscretizedLogisticLikelihood(c_in, color_ch)
    if name == "discretized_logistic_mix":
        return DiscretizedLogisticMixLikelihood(c_in, color_ch, fused=fused_mixture)
    raise ValueError(f"unknown likelihood {name!r}; choose from {LIKELIHOODS}")


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

class _Draws:
    """Where a sample's noise comes from: the operands in ``noise`` (by
    name), a ``torch.Generator`` on the params' device, or the keyed
    Philox with image ``i`` keyed by ``(seed, index[i])``."""

    def __init__(self, like: torch.Tensor, noise: Optional[dict],
                 generator: Optional[torch.Generator], keyed: Optional[tuple]):
        if sum(v is not None for v in (noise, generator, keyed)) != 1:
            raise ValueError("sampling needs exactly one of noise=, generator= and keyed=")
        self.like, self.noise, self.generator, self.keyed = like, noise, generator, keyed

    def given(self, name: str, shape) -> Optional[torch.Tensor]:
        if self.noise is None:
            return None
        t = torch.as_tensor(self.noise[name], device=self.like.device).to(self.like.dtype)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"noise {name!r} must be {tuple(shape)}, got {tuple(t.shape)}")
        return t

    def uniform(self, name: str, shape, stream: int = STREAM_SAMPLE_DRAW) -> torch.Tensor:
        """Uniforms in (0, 1]: given, or drawn."""
        t = self.given(name, shape)
        if t is not None:
            return t
        if self.keyed is not None:
            seed, index = self.keyed
            return keyed_uniform(shape, seed, index, 0, stream).to(self.like.dtype)
        return torch.rand(shape, generator=self.generator, device=self.like.device,
                          dtype=self.like.dtype)

    def gumbel(self, name: str, shape) -> torch.Tensor:
        """Standard Gumbel: given, or -log(-log(u)) of a uniform kept
        inside (0, 1)."""
        t = self.given(name, shape)
        if t is not None:
            return t
        u = self.uniform(name, shape, STREAM_SAMPLE_SELECT)
        return -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 2.0 ** -24)))

    def normal(self, name: str, shape) -> torch.Tensor:
        t = self.given(name, shape)
        if t is not None:
            return t
        if self.keyed is not None:
            seed, index = self.keyed
            return keyed_normal(shape, seed, index, 0, STREAM_SAMPLE_DRAW).to(self.like.dtype)
        return torch.randn(shape, generator=self.generator, device=self.like.device,
                           dtype=self.like.dtype)


def sample_from_likelihood(name: str, params: torch.Tensor, *,
                           noise: Optional[dict] = None,
                           generator: Optional[torch.Generator] = None,
                           keyed: Optional[tuple] = None,
                           n_bins: int = 256, n_components: int = 10) -> torch.Tensor:
    """Draw an image from a head's ``params`` ``[B, H, W, Q]`` (channels
    last). The noise is one of: ``noise``, the draws as operands (``"u"``,
    uniforms, for Bernoulli and the discretized logistic; ``"eps"``,
    standard normals, for the Gaussian; ``"gumbel"`` ``[B, H, W, K]`` and
    ``"u"`` ``[B, H, W, C]`` for the mixture), a ``generator``, or
    ``keyed=(seed, index)``."""
    draws = _Draws(params, noise, generator, keyed)
    if name == "bernoulli":
        return (draws.uniform("u", params.shape) < torch.sigmoid(params)).to(params.dtype)
    if name == "gaussian":
        mean, log_var = split_params(params, dim=-1)
        return mean + torch.exp(0.5 * log_var) * draws.normal("eps", mean.shape)
    if name == "discretized_logistic":
        mean, log_scale = split_params(params, dim=-1)
        cont = logistic_rsample(mean, log_scale, draws.uniform("u", mean.shape))
        return torch.round(cont.clamp(0.0, 1.0) * (n_bins - 1)) / (n_bins - 1)
    if name == "discretized_logistic_mix":
        return _sample_dlogistic_mix(params, draws, n_components, n_bins)
    raise ValueError(f"unknown likelihood {name!r}; choose from {LIKELIHOODS}")


def _sample_dlogistic_mix(params: torch.Tensor, draws: _Draws, n_components: int,
                          n_bins: int) -> torch.Tensor:
    """PixelCNN++ sampling: Gumbel-max component choice, a logistic draw
    per channel, the linear channel autoregression, the snap to the
    ``n_bins`` grid. C comes from the channel count K(1 + 3C)."""
    k = n_components
    c = (params.shape[-1] // k - 1) // 3
    logit_pi, means, log_scales, coeffs = mixture_slabs(params, k, c)
    sel = torch.argmax(logit_pi + draws.gumbel("gumbel", logit_pi.shape), dim=-1)                  # [B, H, W]
    idx = sel[..., None, None].expand(*sel.shape, 1, c)

    def take(a):
        return torch.gather(a, -2, idx).squeeze(-2)                # [B, H, W, C]

    m, ls, co = take(means), take(log_scales), take(coeffs)
    u = draws.uniform("u", m.shape).clamp(1e-5, 1.0 - 1e-5)
    draw = torch.exp(ls) * (torch.log(u) - torch.log1p(-u))       # centred logistic
    x0 = (m[..., 0] + draw[..., 0]).clamp(-1.0, 1.0)
    if c == 1:
        out = x0.unsqueeze(-1)
    else:
        x1 = (m[..., 1] + co[..., 0] * x0 + draw[..., 1]).clamp(-1.0, 1.0)
        x2 = (m[..., 2] + co[..., 1] * x0 + co[..., 2] * x1 + draw[..., 2]).clamp(-1.0, 1.0)
        out = torch.stack([x0, x1, x2], dim=-1)
    out01 = (out + 1.0) / 2.0
    return torch.round(out01 * (n_bins - 1)) / (n_bins - 1)
