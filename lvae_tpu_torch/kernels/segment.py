"""Train-mode [bits8 dropout ->] BatchNorm -> ELU/ReLU, forward and
backward: the port of ``fused_dropout_bn_act``
(``lvae_tpu/kernels/segment_pallas.py:380``).

:func:`dropout_bn_act` is a ``torch.autograd.Function``: the forward is K5
(``_segment_fwd_impl`` :291, two passes and a finalise that also moves the
running statistics), the backward K5-bwd (``_segment_bwd_impl`` :318).
Both take the model's NCHW map ``x [B, C, H, W]`` as it is, with any B,
C, H and W; the dropout bytes are the keyed Philox bytes of
:func:`lvae_tpu_torch.ops.philox.dropout_bytes`, regenerated in every
pass from ``seed``.

A CUDA tensor launches ``csrc/segment.cu`` or raises; a CPU tensor takes
the plain versions, ``ops.math.segment_forward`` and the hand-written
``ops.math.segment_backward``. Unlike ``lvae_tpu``, which falls back to
plain XLA for channel counts its lanes cannot tile
(``segment_pallas.py:221-240``), the kernel takes every shape, so the
wrapper never falls back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.ops.math import (
    SEGMENT_ACTS,
    bits8_keep_threshold,
    segment_backward,
    segment_forward,
)
from lvae_tpu_torch.ops.philox import dropout_bytes

_TARGET_BLOCKS = 528        # ~4 blocks of 256 threads per SM of an H100
_MIN_BLOCK_ELEMENTS = 2048


def _batch_slices(b: int, c: int, hw: int) -> int:
    """The kernels' batch slices: grid (c, slices), a function of the shape
    alone, so the order of the sums (and their bits) is too."""
    return max(1, min(b, -(-_TARGET_BLOCKS // c), b * hw // _MIN_BLOCK_ELEMENTS))


def _checked(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, act: str) -> None:
    if act not in SEGMENT_ACTS:
        raise ValueError(f"unsupported fused-segment act {act!r}; choose from {SEGMENT_ACTS}")
    if x.dim() != 4:
        raise ValueError(f"x must be NCHW [B, C, H, W], got {tuple(x.shape)}")
    c = x.shape[1]
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the segment kernels run on cpu or cuda, got {x.device}")
    # CUDA: the kernels' fp32; CPU: the plain versions also take fp64
    ok = (torch.float32,) if x.device.type == "cuda" else (torch.float32, torch.float64)
    for name, v in (("x", x), ("gamma", gamma), ("beta", beta)):
        if v.dtype not in ok or v.dtype != x.dtype:
            raise TypeError(f"{name} must be float32 (like x), got {v.dtype}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"gamma and beta must be [{c}], got {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")


def _plain_bytes(x: torch.Tensor, t: int, seed: int) -> Optional[torch.Tensor]:
    """The plain path's keyed dropout bytes (None where no mask applies)."""
    return dropout_bytes(x.shape, seed, x.device) if 0 < t < 256 else None


def _vec(*tensors: torch.Tensor) -> int:
    """4 (16-byte accesses) where every map is 16-byte aligned and a
    channel's strip is a multiple of 4 floats, else 1."""
    hw = tensors[0].shape[2] * tensors[0].shape[3]
    return 4 if hw % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(x, gamma, beta, t, act, eps, seed, running_mean, running_var, momentum):
    b, c, h, w = x.shape
    slices = _batch_slices(b, c, h * w)
    y = torch.empty_like(x)
    stats = torch.empty((5, c), device=x.device)                  # mean, var, r, scale, shift
    partial = torch.empty((2, c, slices), dtype=torch.float64, device=x.device)
    if running_mean is not None:
        for name, v in (("running_mean", running_mean), ("running_var", running_var)):
            if v.dtype != torch.float32 or v.shape != (c,) or v.device != x.device:
                raise ValueError(f"{name} must be float32 [{c}] on {x.device}")
    with torch.cuda.device(x.device):
        status = build.library().lvae_segment_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            None if running_mean is None else running_mean.data_ptr(),
            None if running_var is None else running_var.data_ptr(),
            y.data_ptr(), stats.data_ptr(), partial.data_ptr(), b, c, h * w, slices, t,
            SEGMENT_ACTS.index(act), eps, momentum, 1.0 - momentum, seed & (2 ** 64 - 1),
            _vec(x, y), _stream(x))
    build.LAUNCHES["segment"] += 1
    build.check(status, "segment")
    return y, stats


def dropout_bn_act_backward(x: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, stats: torch.Tensor, t: int, act: str,
                            seed: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5-bwd: ``(dx, dgamma, dbeta)`` from the cotangent ``g`` of ``y``,
    given the forward's ``stats`` (rows mean, var, r, scale, shift)."""
    _checked(x, gamma, beta, act)
    if g.shape != x.shape or g.device != x.device or g.dtype != x.dtype:
        raise ValueError(f"g must be {x.dtype} {tuple(x.shape)} on {x.device}")
    g = g.contiguous()
    if x.device.type == "cpu":
        return segment_backward(x, g, gamma, beta, stats[0], stats[2], t, act,
                                _plain_bytes(x, t, seed))
    b, c, h, w = x.shape
    slices = _batch_slices(b, c, h * w)
    dx = torch.empty_like(x)
    bstats = torch.empty((5, c), device=x.device)        # dgamma, dbeta, m1, m2, gamma r
    partial = torch.empty((2, c, slices), dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().lvae_segment_bwd(
            x.data_ptr(), g.data_ptr(), gamma.data_ptr(), stats.data_ptr(), dx.data_ptr(),
            bstats.data_ptr(), partial.data_ptr(), b, c, h * w, slices, t,
            SEGMENT_ACTS.index(act), seed & (2 ** 64 - 1), _vec(x, g, dx), _stream(x))
    build.LAUNCHES["segment_bwd"] += 1
    build.check(status, "segment_bwd")
    return dx, bstats[0], bstats[1]


class _Segment(torch.autograd.Function):
    """The segment with the hand-written backward: the kernels on CUDA,
    the plain versions on the CPU. Outputs y and the [5, C] statistics
    (mean, var, r, scale, shift); only y carries a gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, running_mean, running_var, t, act, eps, seed, momentum):
        if x.device.type == "cpu":
            y, mean, var, r = segment_forward(x, gamma, beta, t, act, eps,
                                              _plain_bytes(x, t, seed), running_mean,
                                              running_var, momentum)
            scale = gamma * r
            stats = torch.stack([mean, var, r, scale, beta - mean * scale])
        else:
            y, stats = _launch_fwd(x, gamma, beta, t, act, eps, seed, running_mean,
                                   running_var, momentum)
        ctx.t, ctx.act, ctx.seed = t, act, seed
        ctx.save_for_backward(x, gamma, beta, stats)
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _gstats):
        x, gamma, beta, stats = ctx.saved_tensors
        dx, dgamma, dbeta = dropout_bn_act_backward(x, g, gamma, beta, stats, ctx.t, ctx.act,
                                                    ctx.seed)
        return dx, dgamma, dbeta, None, None, None, None, None, None, None


def dropout_bn_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                   rate: float = 0.0, act: str = "elu", eps: float = 1e-5, seed: int = 0,
                   running_mean: Optional[torch.Tensor] = None,
                   running_var: Optional[torch.Tensor] = None, momentum: float = 0.9
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: the train-mode segment ``y = act(BatchNorm(drop(x)))`` of the
    NCHW map ``x``, differentiable in x, gamma and beta. Returns ``(y,
    batch_mean, batch_var)``, the variance biased; given the running
    buffers, it moves them (momentum ``momentum``, flax's rule).

    ``rate`` takes bits8 dropout's semantics (keep iff the element's byte
    is below ``t = round(256 (1 - rate))``, survivors scaled by ``256 /
    t``; ``t >= 256`` is no mask, ``t <= 0`` drops everything, so ``y =
    act(beta)`` with zero statistics). The bytes are keyed by ``seed``
    (``mix_seed(train seed, step, site)``). A strided ``x`` (a cropped
    transposed conv's output) is copied to a contiguous one first."""
    x = x.contiguous()
    _checked(x, gamma, beta, act)
    y, stats = _Segment.apply(x, gamma, beta, running_mean, running_var,
                              bits8_keep_threshold(rate), act, eps, int(seed), momentum)
    return y, stats[0], stats[1]
