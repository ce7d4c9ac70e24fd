"""Discretized-logistic-mixture log-prob, forward and backward: the port
of ``fused_mix_log_prob`` (``lvae_tpu/kernels/mixture_pallas.py:519``).

:func:`mix_log_prob` is a ``torch.autograd.Function``: the forward is K3
(``_run_fwd`` :323), the backward K3-bwd (``_run_bwd`` :338), which
writes the parameter gradient in the map's own channel layout and the x
gradient only when x needs one. Both take the model's NCHW layout as it
is: x ``[B, C, H, W]`` in [0, 1], params ``[B, K(1 + 3C), H, W]`` (flax's
channel order), ll ``[B, H, W]``; C is 1 or 3.

K3 takes a launch plan (:func:`fwd_plan`): how many neighbouring pixels
a thread computes, each channel read with one vector load. K3-bwd has two
schedules (:func:`bwd_plan`): "one_pass" builds each component's bin terms
once and keeps them in shared memory until the logsumexps are known, two
lanes sharing V neighbouring pixels (each channel one access of V values)
and taking alternate components; "two_pass", the original kernel, finds
the logsumexps in a first pass and recomputes every component in a
second, and takes any K. The wrapper chooses the schedule from K and C
(one pass where its CTA leaves room for a second on an SM) and V from the
batch and the map.

params are fp32 or bf16 (the model's raw conv output under ``--precision
bf16``, as ``lvae_tpu`` feeds its kernel, ``mixture_pallas.py:533-542``); x,
the cotangent, ll and dx are fp32 either way, and dparams comes back in
params' dtype. A bf16 map launches the kernels' bf16 instantiation, which
upcasts each parameter as it reads it and writes dparams as bf16.

A CUDA tensor launches ``csrc/mixture.cu`` or raises; a CPU tensor takes
the plain PyTorch versions beside it: the forward is
``ops.likelihoods.discretized_logistic_mix_log_prob`` (the oracle's
math), the backward the hand-written :func:`_plain_mix_log_prob_bwd`, both
in fp32 on a bf16 map, dparams cast back to bf16.
Unlike ``lvae_tpu``, which falls back to its oracle for C != 3, the kernel
takes C = 1, so the wrapper never falls back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.ops.likelihoods import (
    LOG_SCALE_MIN,
    discretized_logistic_mix_log_prob,
)
from lvae_tpu_torch.ops.math import math_dtype


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _plain_mix_log_prob(x: torch.Tensor, params: torch.Tensor, k: int,
                        n_bins: int) -> torch.Tensor:
    return discretized_logistic_mix_log_prob(x, params.to(math_dtype(params.dtype)), k,
                                             n_bins, dim=1)


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
# the forward's launch plan
# ---------------------------------------------------------------------------

FWD_VECTORS = (4, 2, 1)   # pixels a thread: each channel one float4 / float2 (4 / 2 bf16)
# The least threads a launch should keep: 512 CTAs of THREADS, about four
# on each of an H100's 132 SMs, the occupancy of K3's 128-register kernels.
# Below it a smaller V, more threads, ran faster (PERF.md, PR 15).
MIN_THREADS = 65_536


def fwd_plan(b: int, hw: int, plan: Optional[int] = None) -> int:
    """K3's pixels a thread, V, for B maps of ``hw`` pixels: the largest of
    ``FWD_VECTORS`` that divides ``hw`` (so every row starts V-aligned) and
    leaves at least ``MIN_THREADS`` threads, else 1. ``plan`` forces a V of
    ``FWD_VECTORS``; where it does not divide ``hw`` (or a pointer is off
    V alignment) the C entry runs V = 1, which gives the same bits."""
    if plan is not None:
        if plan not in FWD_VECTORS:
            raise ValueError(f"plan must be one of {FWD_VECTORS} pixels a thread, got {plan!r}")
        return plan
    return next((v for v in FWD_VECTORS if hw % v == 0 and b * hw // v >= MIN_THREADS), 1)


# ---------------------------------------------------------------------------
# the backward's schedule
# ---------------------------------------------------------------------------

PLANS = ("one_pass", "two_pass")   # csrc/mixture.cu kOnePass, kTwoPass
THREADS = 128                      # csrc/mixture.cu kThreads
SPLIT = 2                          # csrc/mixture.cu kSplit: lanes a pixel group (one pass)
BWD_VECTORS = (2, 1)               # pixels a group: each channel one 2-value access, or one
# one pass by default where a CTA of V = 1 leaves room for a second on an SM
# (228 KB each, less 1 KB reserved per CTA), V = 2 where a CTA of V = 2
# does: at K = 24, C = 3 one pass at V = 1 (three CTAs an SM) ran in about
# half the time of two passes and 0.8x that of V = 2 (one CTA an SM) on an
# H100 (PERF.md, section 6)
ONE_PASS_BUDGET = 115_712
SMEM_MAX = 232_448                 # csrc/mixture.cu kSmemMax: what one CTA can have


class Plan(NamedTuple):
    name: str       # one of PLANS
    smem: int       # dynamic shared memory per CTA of THREADS threads
    v: int          # pixels a group of SPLIT lanes (one pass; 1 for two passes)


def stored_per_component(c: int) -> int:
    """Floats the one-pass backward keeps per component and pixel: t_j,
    pi_j, dm and the masked dls per channel, and tanh(coeffs) for C = 3."""
    return 2 + 2 * c + (3 if c == 3 else 0)


def one_pass_smem(k: int, c: int, v: int) -> int:
    """A one-pass CTA's shared memory: THREADS lanes, each keeping its
    ceil(K / SPLIT) components of V pixels (``csrc/mixture.cu``
    ``one_pass_smem``)."""
    return 4 * THREADS * -(-k // SPLIT) * stored_per_component(c) * v


def bwd_plan(k: int, c: int, b: int, hw: int, plan: Optional[str] = None,
             v: Optional[int] = None) -> Plan:
    """K3-bwd's schedule for B maps of ``hw`` pixels, K components of C
    channels. ``plan`` forces one; by default "one_pass" where a CTA of
    V = 1 keeps its terms within ``ONE_PASS_BUDGET``, else "two_pass". The
    one pass's V: 2 where it divides ``hw`` (so every row starts
    V-aligned), leaves at least ``MIN_THREADS`` threads and a CTA within
    the budget, else 1; ``v`` forces one of ``BWD_VECTORS`` (where it does
    not divide ``hw``, or a pointer is off V alignment, the C entry runs
    V = 1, which gives the same bits). A forced "one_pass" must fit one CTA
    (``SMEM_MAX``)."""
    if plan not in (None, *PLANS):
        raise ValueError(f"plan must be one of {PLANS} or None, got {plan!r}")
    if v is not None and v not in BWD_VECTORS:
        raise ValueError(f"v must be one of {BWD_VECTORS} pixels a group, got {v!r}")
    if plan is None:
        plan = PLANS[0] if one_pass_smem(k, c, 1) <= ONE_PASS_BUDGET else PLANS[1]
    if plan == "two_pass":
        return Plan(plan, 0, 1)
    if v is None:
        v = next((u for u in BWD_VECTORS if hw % u == 0 and b * hw * SPLIT // u >= MIN_THREADS
                  and one_pass_smem(k, c, u) <= ONE_PASS_BUDGET), 1)
    smem = one_pass_smem(k, c, v)
    if smem > SMEM_MAX:
        raise ValueError(f"plan 'one_pass' keeps {smem} B per CTA for K = {k}, C = {c}, "
                         f"V = {v}: more than the {SMEM_MAX} B a CTA can have")
    return Plan(plan, smem, v)


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
    # CUDA: params fp32 or bf16, x fp32; CPU: the plain versions also take
    # fp64 params and x (gradcheck)
    ok = (torch.float32, torch.bfloat16) + ((torch.float64,) if x.device.type == "cpu" else ())
    if params.dtype not in ok:
        raise TypeError(f"params must be float32 or bfloat16, got {params.dtype}")
    want = math_dtype(params.dtype)
    if x.dtype != want:
        raise TypeError(f"x must be {want} for {params.dtype} params, got {x.dtype}")
    for name, t in (("x", x), ("params", params)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous NCHW")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(x: torch.Tensor, params: torch.Tensor, k: int, n_bins: int,
                v: int) -> torch.Tensor:
    b, c, h, w = x.shape
    out = torch.empty((b, h, w), device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().lvae_mix_log_prob(
            x.data_ptr(), params.data_ptr(), out.data_ptr(), b, h * w, k, c, n_bins, v,
            build.esize(params.dtype), _stream(x))
    build.LAUNCHES[build.launch_name("mix_log_prob", params.dtype)] += 1
    build.check(status, "mix_log_prob")
    return out


def mix_log_prob_backward(x: torch.Tensor, params: torch.Tensor, g: torch.Tensor,
                          n_components: int = 10, n_bins: int = 256,
                          need_dx: bool = True, plan: Optional[str] = None,
                          v: Optional[int] = None
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K3-bwd: ``(dparams [B, Q, H, W], dx [B, C, H, W] or None)`` from the
    cotangent ``g [B, H, W]`` of the per-pixel log-prob, dparams in params'
    dtype and dx in x's. ``plan`` and ``v`` force a schedule and the one
    pass's pixels a group (see :func:`bwd_plan`; the CPU's plain version
    ignores both)."""
    _checked(x, params, n_components, n_bins)
    b, c, h, w = x.shape
    if tuple(g.shape) != (b, h, w) or g.device != x.device:
        raise ValueError(f"g must be [{b}, {h}, {w}] on {x.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    chosen = bwd_plan(n_components, c, b, h * w, plan, v)
    if x.device.type == "cpu":
        dparams, dx = _plain_mix_log_prob_bwd(x, params.to(x.dtype), g.to(x.dtype),
                                              n_components, n_bins)
        return dparams.to(params.dtype), dx if need_dx else None
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g.dtype}")
    g = g.contiguous()
    dparams = torch.empty_like(params)
    dx = torch.empty_like(x) if need_dx else None
    with torch.cuda.device(x.device):
        status = build.library().lvae_mix_log_prob_bwd_plan(
            x.data_ptr(), params.data_ptr(), g.data_ptr(), dparams.data_ptr(),
            None if dx is None else dx.data_ptr(), b, h * w, n_components, c, n_bins,
            PLANS.index(chosen.name), chosen.v, build.esize(params.dtype), _stream(x))
    build.LAUNCHES[build.launch_name("mix_log_prob_bwd", params.dtype)] += 1
    build.check(status, "mix_log_prob_bwd")
    return dparams, dx


class _MixLogProb(torch.autograd.Function):
    """The per-pixel log-prob with the hand-written backward: the kernels
    on CUDA, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, params, k, n_bins, v):
        if x.device.type == "cpu":
            ll = _plain_mix_log_prob(x, params, k, n_bins)
        else:
            ll = _launch_fwd(x, params, k, n_bins, v)
        ctx.k, ctx.n_bins = k, n_bins
        ctx.save_for_backward(x, params)
        return ll

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, params = ctx.saved_tensors
        dparams, dx = mix_log_prob_backward(x, params, g, ctx.k, ctx.n_bins,
                                            need_dx=ctx.needs_input_grad[0])
        return dx, dparams, None, None, None


def mix_log_prob(x: torch.Tensor, params: torch.Tensor, n_components: int = 10,
                 n_bins: int = 256, plan: Optional[int] = None) -> torch.Tensor:
    """K3: the per-pixel log-prob ``[B, H, W]`` (fp32) of x ``[B, C, H, W]``
    (fp32) under the mixture ``params [B, K(1 + 3C), H, W]`` (fp32 or bf16),
    differentiable in both. ``plan`` forces K3's pixels a thread (see
    :func:`fwd_plan`; the CPU's plain version ignores it)."""
    _checked(x, params, n_components, n_bins)
    b, _, h, w = x.shape
    v = fwd_plan(b, h * w, plan)
    return _MixLogProb.apply(x, params, n_components, n_bins, v)
