"""Likelihood heads (port of ``lvae_tpu/models/likelihoods.py``;
Bernoulli only on this slice)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from lvae_tpu_torch.models.blocks import Conv2d
from lvae_tpu_torch.ops.likelihoods import bernoulli_log_prob


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


def make_likelihood(name: str, c_in: int, color_ch: int) -> nn.Module:
    if name == "bernoulli":
        return BernoulliLikelihood(c_in, color_ch)
    raise NotImplementedError(
        f"likelihood {name!r} is not ported yet: the Gaussian, discretized "
        f"logistic and mixture heads come with the port's mixture-head PR"
    )
