"""Discretized-logistic-mixture log-prob, forward and backward: the port
of ``fused_mix_log_prob`` (``lvae_tpu/kernels/mixture_pallas.py:519``).

:func:`mix_log_prob` is a ``torch.autograd.Function``: the forward is K3
(``_run_fwd`` :323), the backward K3-bwd (``_run_bwd`` :338), which
writes the parameter gradient in the map's own channel layout and the x
gradient only when x needs one. Both take the model's NCHW layout as it
is: x ``[B, C, H, W]`` in [0, 1], params ``[B, K(1 + 3C), H, W]`` (flax's
channel order), ll ``[B, H, W]``; C is 1 or 3.

A CUDA tensor launches ``csrc/mixture.cu`` or raises; a CPU tensor takes
the plain PyTorch versions beside it: the forward is
``ops.likelihoods.discretized_logistic_mix_log_prob`` (the oracle's
math), the backward the hand-written :func:`_plain_mix_log_prob_bwd`.
Unlike ``lvae_tpu``, which falls back to its oracle for C != 3, the kernel
takes C = 1, so the wrapper never falls back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.ops.likelihoods import (
    LOG_SCALE_MIN,
    discretized_logistic_mix_log_prob,
)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _plain_mix_log_prob(x: torch.Tensor, params: torch.Tensor, k: int,
                        n_bins: int) -> torch.Tensor:
    return discretized_logistic_mix_log_prob(x, params, k, n_bins, dim=1)


def _plain_mix_log_prob_bwd(x: torch.Tensor, params: torch.Tensor, g: torch.Tensor,
                            k: int, n_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hand-written backward (``mixture_pallas.py:93-133``,
    ``:227-271``): ``(dparams [B, Q, H, W], dx [B, C, H, W])`` from the
    cotangent ``g [B, H, W]``. The log-scale gradient is blocked where
    the raw log-scale is at or below the floor (the Pallas kernel's
    ``ls_raw > floor`` rule)."""
    b, c, h, w = x.shape
    kc = k * c
    hb = 1.0 / (n_bins - 1)
    logit_pi = params[:, :k]                                       # [B, K, H, W]
    means = params[:, k:k + kc].reshape(b, k, c, h, w)
    ls_raw = params[:, k + kc:k + 2 * kc].reshape(b, k, c, h, w)
    co = torch.tanh(params[:, k + 2 * kc:k + 3 * kc].reshape(b, k, c, h, w))
    xs = (2.0 * x - 1.0).unsqueeze(1)                              # [B, 1, C, H, W]
    if c == 3:
        m1 = means[:, :, 1] + co[:, :, 0] * xs[:, :, 0]
        m2 = means[:, :, 2] + co[:, :, 1] * xs[:, :, 0] + co[:, :, 2] * xs[:, :, 1]
        means = torch.stack([means[:, :, 0], m1, m2], dim=2)
    ls = ls_raw.clamp_min(LOG_SCALE_MIN)
    inv_s = torch.exp(-ls)
    a = inv_s * ((xs - means) - hb)
    d = (2.0 * hb) * inv_s
    plus = a + d
    left, right = xs < -1.0 + hb, xs > 1.0 - hb
    lp = torch.where(left, F.logsigmoid(plus), torch.where(
        right, F.logsigmoid(-a),
        plus + torch.log(-torch.expm1(-d)) - F.softplus(a) - F.softplus(plus)))
    sig_a, sig_p = torch.sigmoid(a), torch.sigmoid(plus)
    da = torch.where(left, 1.0 - sig_p, torch.where(right, -sig_a, 1.0 - sig_a - sig_p))
    dd = torch.where(left, 1.0 - sig_p, torch.where(
        right, torch.zeros_like(d), 1.0 + 1.0 / torch.expm1(d) - sig_p))
    log_pi = F.log_softmax(logit_pi, dim=1)
    wk = torch.softmax(lp.sum(dim=2) + log_pi, dim=1)             # [B, K, H, W]
    g1 = g.unsqueeze(1)
    dpi = g1 * (wk - torch.exp(log_pi))
    gw = (g1 * wk).unsqueeze(2)                                    # [B, K, 1, H, W]
    dm = gw * (-inv_s * da)
    dls = torch.where(ls_raw > LOG_SCALE_MIN, gw * (-a * da - d * dd), torch.zeros_like(d))
    if c == 3:
        x0, x1 = xs[:, :, 0], xs[:, :, 1]
        dco = torch.stack([dm[:, :, 1] * x0 * (1.0 - co[:, :, 0] ** 2),
                           dm[:, :, 2] * x0 * (1.0 - co[:, :, 1] ** 2),
                           dm[:, :, 2] * x1 * (1.0 - co[:, :, 2] ** 2)], dim=2)
        dxs = torch.stack([(-dm[:, :, 0] + dm[:, :, 1] * co[:, :, 0]
                            + dm[:, :, 2] * co[:, :, 1]).sum(dim=1),
                           (-dm[:, :, 1] + dm[:, :, 2] * co[:, :, 2]).sum(dim=1),
                           (-dm[:, :, 2]).sum(dim=1)], dim=1)
    else:
        dco = torch.zeros_like(dm)          # C = 1: the coefficients are unused
        dxs = (-dm[:, :, 0]).sum(dim=1, keepdim=True)
    dparams = torch.cat([dpi] + [t.reshape(b, kc, h, w) for t in (dm, dls, dco)], dim=1)
    return dparams, 2.0 * dxs


# ---------------------------------------------------------------------------
# operand checks and launches
# ---------------------------------------------------------------------------

def _checked(x: torch.Tensor, params: torch.Tensor, k: int, n_bins: int) -> None:
    if x.dim() != 4 or x.shape[1] not in (1, 3):
        raise ValueError(f"x must be [B, C, H, W] with C in (1, 3), got {tuple(x.shape)}")
    b, c, h, w = x.shape
    q = k * (1 + 3 * c)
    if k < 1 or tuple(params.shape) != (b, q, h, w):
        raise ValueError(f"params must be [{b}, K(1 + 3C) = {q}, {h}, {w}] for K = {k}, "
                         f"got {tuple(params.shape)}")
    if n_bins < 2:
        raise ValueError(f"n_bins must be >= 2, got {n_bins}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the mixture kernels run on cpu or cuda, got {x.device}")
    if params.device != x.device:
        raise ValueError(f"params is on {params.device}, x on {x.device}")
    # CUDA: the kernels' fp32; CPU: the plain versions also take fp64
    # (gradcheck)
    ok = (torch.float32,) if x.device.type == "cuda" else (torch.float32, torch.float64)
    for name, t in (("x", x), ("params", params)):
        if t.dtype not in ok or t.dtype != params.dtype:
            raise TypeError(f"{name} must be float32 (like params), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous NCHW")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(x: torch.Tensor, params: torch.Tensor, k: int, n_bins: int) -> torch.Tensor:
    b, c, h, w = x.shape
    out = torch.empty((b, h, w), device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().lvae_mix_log_prob(
            x.data_ptr(), params.data_ptr(), out.data_ptr(), b, h * w, k, c, n_bins,
            _stream(x))
    build.LAUNCHES["mix_log_prob"] += 1
    build.check(status, "mix_log_prob")
    return out


def mix_log_prob_backward(x: torch.Tensor, params: torch.Tensor, g: torch.Tensor,
                          n_components: int = 10, n_bins: int = 256,
                          need_dx: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K3-bwd: ``(dparams [B, Q, H, W], dx [B, C, H, W] or None)`` from the
    cotangent ``g [B, H, W]`` of the per-pixel log-prob."""
    _checked(x, params, n_components, n_bins)
    b, c, h, w = x.shape
    if tuple(g.shape) != (b, h, w) or g.device != x.device:
        raise ValueError(f"g must be [{b}, {h}, {w}] on {x.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if x.device.type == "cpu":
        dparams, dx = _plain_mix_log_prob_bwd(x, params, g.to(params.dtype),
                                              n_components, n_bins)
        return dparams, dx if need_dx else None
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g.dtype}")
    g = g.contiguous()
    dparams = torch.empty_like(params)
    dx = torch.empty_like(x) if need_dx else None
    with torch.cuda.device(x.device):
        status = build.library().lvae_mix_log_prob_bwd(
            x.data_ptr(), params.data_ptr(), g.data_ptr(), dparams.data_ptr(),
            None if dx is None else dx.data_ptr(), b, h * w, n_components, c, n_bins,
            _stream(x))
    build.LAUNCHES["mix_log_prob_bwd"] += 1
    build.check(status, "mix_log_prob_bwd")
    return dparams, dx


class _MixLogProb(torch.autograd.Function):
    """The per-pixel log-prob with the hand-written backward: the kernels
    on CUDA, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, params, k, n_bins):
        if x.device.type == "cpu":
            ll = _plain_mix_log_prob(x, params, k, n_bins)
        else:
            ll = _launch_fwd(x, params, k, n_bins)
        ctx.k, ctx.n_bins = k, n_bins
        ctx.save_for_backward(x, params)
        return ll

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, params = ctx.saved_tensors
        dparams, dx = mix_log_prob_backward(x, params, g, ctx.k, ctx.n_bins,
                                            need_dx=ctx.needs_input_grad[0])
        return dx, dparams, None, None


def mix_log_prob(x: torch.Tensor, params: torch.Tensor, n_components: int = 10,
                 n_bins: int = 256) -> torch.Tensor:
    """K3: the per-pixel log-prob ``[B, H, W]`` of x ``[B, C, H, W]`` under
    the mixture ``params [B, K(1 + 3C), H, W]``, differentiable in both."""
    _checked(x, params, n_components, n_bins)
    return _MixLogProb.apply(x, params, n_components, n_bins)
