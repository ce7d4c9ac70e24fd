"""Gaussian latent block (port of ``lvae_tpu/models/stochastic.py``).

Conv heads give the (mu, log-variance) maps of p and q; a sample is drawn
and the KL taken; the sample is projected back into the deterministic
stream. With ``fused=True`` and q present the draw and the KL run in the
CUDA sample+KL kernels (``kernels/stochastic.py``), forward and backward:
with ``train=True`` K1, which returns the KL summed per sample
(``kl_sample [B]``) and no elementwise map, as ``lvae_tpu``'s training
branch does; otherwise K2, the elementwise map. Without ``fused`` the
plain PyTorch ops (``ops/``) run under autograd. All draw eps from the same
keyed Philox stream, so they give the same z. The conv heads compute in
their compute dtype (bf16 under ``--precision bf16``); the parameters,
the sample and the KL are fp32, as in ``lvae_tpu``.

``p_row``, where given, is the one row ``[1, 2c, h, w]`` that ``p_in``
broadcasts over B (the top layer's prior, ``p_in`` its stride-0 view):
the fused kernels take it as it is and read it with row stride 0.

Noise is keyed, not drawn from a global generator: ``noise`` is a
:class:`Noise` ``(seed, index [B], sample)`` and ``stream`` the layer
number, and row ``i`` draws with counter ``(offset, index[i], sample[i],
stream)`` (``ops/philox.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from lvae_tpu_torch.models.blocks import Conv2d
from lvae_tpu_torch.ops.philox import Ints
from lvae_tpu_torch.ops.stochastic import gaussian_kl, normal_rsample, split_params


@dataclasses.dataclass(frozen=True)
class Noise:
    """Where a forward's latent noise comes from: row ``i`` is keyed by
    ``(seed, index[i], sample[i])`` (``sample`` an int or int64 ``[B]``)."""

    seed: int
    index: torch.Tensor
    sample: Ints = 0


class NormalStochasticBlock(nn.Module):
    def __init__(self, c_in: int, c_vars: int, c_out: int, kernel_size: int = 3,
                 transform_p_params: bool = True, fused: bool = False,
                 conv_pad: str = "same"):
        super().__init__()
        self.c_vars = c_vars
        self.fused = fused
        # near-zero Gaussian heads (normal(1e-2)), as lvae_tpu's head_init
        self.conv_in_p = (
            Conv2d(c_in, 2 * c_vars, kernel_size, conv_pad=conv_pad, init_std=1e-2)
            if transform_p_params else None
        )
        self.conv_in_q = Conv2d(c_in, 2 * c_vars, kernel_size,
                                conv_pad=conv_pad, init_std=1e-2)
        self.conv_out = Conv2d(c_vars, c_out, kernel_size, conv_pad=conv_pad)

    def forward(
        self,
        p_in: torch.Tensor,
        q_in: Optional[torch.Tensor] = None,
        *,
        noise: Optional[Noise] = None,
        stream: int = 0,
        p_row: Optional[torch.Tensor] = None,
        forced_latent: Optional[torch.Tensor] = None,
        forced_eps: Optional[torch.Tensor] = None,
        use_mode: bool = False,
        constant_latent: bool = False,
        train: bool = False,
        temperature: float = 1.0,
    ) -> dict[str, Any]:
        if self.conv_in_p is not None:
            p_params = self.conv_in_p(p_in)
        else:
            if p_in.shape[1] != 2 * self.c_vars:
                raise ValueError(
                    f"expected direct p_params with {2 * self.c_vars} channels, "
                    f"got {p_in.shape[1]}"
                )
            p_params = p_in
        # the latent math runs in fp32 whatever the convs' compute dtype,
        # as in lvae_tpu (under bf16 the heads' outputs are cast up here)
        p_params = p_params.float()
        q_params = self.conv_in_q(q_in).float() if q_in is not None else None
        mu, log_var = split_params(q_params if q_params is not None else p_params)

        kl = kl_sample = None
        # branch order of lvae_tpu/models/stochastic.py:95-137
        if forced_latent is not None:
            z = forced_latent
        elif forced_eps is not None:
            z = mu + torch.exp(0.5 * log_var) * forced_eps
        elif use_mode:
            z = mu
        elif self.fused and q_params is not None:
            from lvae_tpu_torch.kernels import stochastic as sk

            n = _need(noise)
            # the kernels read NCHW-contiguous heads (a no-op unless a conv
            # handed back channels-last); a prior given as its one row goes
            # in as that row, so its gradient comes back summed over B
            p = p_row.float() if p_row is not None else p_params.contiguous()
            fn = sk.sample_kl_per_sample if train else sk.sample_kl
            z, kl_out = fn(q_params.contiguous(), p, n.index, n.seed, n.sample, stream)
            if train:
                kl_sample = kl_out
            else:
                kl = kl_out
        else:
            n = _need(noise)
            z = normal_rsample(mu, log_var, n.seed, n.index, n.sample, stream,
                               temperature)

        if q_params is not None and kl is None and kl_sample is None:
            p_mu, p_lv = split_params(p_params)
            kl = gaussian_kl(mu, log_var, p_mu, p_lv)

        if constant_latent:
            z = z[:1].expand_as(z)

        return {
            "z": z,
            "out": self.conv_out(z),      # cast to the conv's compute dtype there
            "kl_elementwise": kl,
            "kl_sample": kl_sample,   # [B] where K1 ran
            "q_params": q_params,
            "p_params": p_params,
        }


def _need(noise: Optional[Noise]) -> Noise:
    if noise is None:
        raise ValueError(
            "a sampled latent needs noise=Noise(seed, index, sample); pass "
            "forced_eps, forced_latent or use_mode for a draw without it"
        )
    return noise
