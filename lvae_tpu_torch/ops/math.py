"""Shape, schedule and dropout utilities (port of ``lvae_tpu/ops/math.py``),
and the plain math of the fused dropout + BatchNorm + activation segment.
The shape ops take NHWC, like the reference package's public layout; the
segment takes the model's NCHW maps."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pad_img_tensor(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Zero-pad an NHWC batch, centred, up to spatial ``size`` (the odd
    pixel goes bottom/right)."""
    h, w = x.shape[1], x.shape[2]
    th, tw = int(size[0]), int(size[1])
    dh, dw = th - h, tw - w
    if dh < 0 or dw < 0:
        raise ValueError(f"pad target {size} smaller than input {(h, w)}")
    if dh == 0 and dw == 0:
        return x
    # F.pad pads from the last axis backwards: (C), (W), (H)
    return F.pad(x, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


def crop_img_tensor(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Centre-crop an NHWC batch down to spatial ``size``."""
    h, w = x.shape[1], x.shape[2]
    th, tw = int(size[0]), int(size[1])
    dh, dw = h - th, w - tw
    if dh < 0 or dw < 0:
        raise ValueError(f"crop target {size} larger than input {(h, w)}")
    if dh == 0 and dw == 0:
        return x
    return x[:, dh // 2 : dh // 2 + th, dw // 2 : dw // 2 + tw, :]


def linear_anneal(step, start_value: float, end_value: float, n_steps: int):
    """Linear schedule from ``start_value`` to ``end_value`` over
    ``n_steps`` (the KL-warmup beta), rounded as ``lvae_tpu`` rounds it:
    the fraction is an fp32 division clipped to [0, 1]. ``step`` an int
    gives a float; a 0-d int64 tensor (the step on the device) gives a 0-d
    fp32 tensor beside it, the same value, with no host sync (the divisor
    is a tensor: PyTorch's CUDA division by a Python number multiplies by
    its reciprocal, which can round otherwise)."""
    if n_steps <= 0:
        return float(np.float32(end_value))
    if isinstance(step, torch.Tensor):
        den = torch.full((), float(np.float32(n_steps)), dtype=torch.float32,
                         device=step.device)
        frac = torch.clamp(step.to(torch.float32) / den, 0.0, 1.0)
        return float(np.float32(start_value)) + float(np.float32(end_value - start_value)) * frac
    frac = np.clip(np.float32(step) / np.float32(n_steps), np.float32(0), np.float32(1))
    return float(np.float32(start_value) + np.float32(end_value - start_value) * frac)


def free_bits_clamp(kl_mean_per_layer: torch.Tensor, free_bits: float) -> torch.Tensor:
    """Free-bits clamp on the *batch mean* of each layer's KL
    (``lvae_tpu``'s ``free_bits_kl`` after its mean over the batch): ``[L]``,
    each layer's mean clamped below at ``free_bits`` nats (a clamped layer
    passes no gradient). The mean is the global batch's: over R ranks, the
    all-reduced one (``train/state.py``)."""
    if free_bits <= 0.0:
        return kl_mean_per_layer
    return torch.clamp_min(kl_mean_per_layer, free_bits)


def bits8_keep_threshold(rate: float) -> int:
    """Integer keep threshold for uint8-bits dropout: an element is kept
    iff its random byte ``< t``, so the keep probability is ``t / 256``.
    ``t >= 256`` keeps everything, ``t <= 0`` drops everything."""
    if rate <= 0.0:
        return 256
    return int(round((1.0 - rate) * 256.0))


def bits8_dropout_f32(u: torch.Tensor, mask_bytes: torch.Tensor, t: int) -> torch.Tensor:
    """uint8-bits dropout at threshold ``t`` (0 < t < 256): ``u`` where its
    byte in ``mask_bytes`` is below ``t``, scaled by the realised keep
    probability's inverse ``256 / t`` in fp32, else 0."""
    return torch.where(mask_bytes < t, u * float(np.float32(256.0 / t)), 0.0)


# ---------------------------------------------------------------------------
# the fused segment: [bits8 dropout ->] BatchNorm (train) -> ELU/ReLU
# ---------------------------------------------------------------------------

SEGMENT_ACTS = ("elu", "relu")


def _segment_act(z: torch.Tensor, act: str) -> torch.Tensor:
    """ELU (``expm1``-based) or ReLU."""
    if act == "elu":
        return torch.where(z > 0, z, torch.expm1(z))
    if act == "relu":
        return torch.where(z > 0, z, 0.0)
    raise ValueError(f"unsupported fused-segment act {act!r}; choose from {SEGMENT_ACTS}")


def _segment_act_grad(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "elu":
        return torch.where(z > 0, 1.0, torch.exp(z))
    return (z > 0).to(z.dtype)


def _dropped(x: torch.Tensor, t: int, mask_bytes: Optional[torch.Tensor]) -> torch.Tensor:
    """u: x where its byte is below ``t``, scaled by ``256 / t`` rounded to
    fp32, else 0; x itself for ``t >= 256``, zeros for ``t <= 0``."""
    if t >= 256:
        return x
    if t <= 0:
        return torch.zeros_like(x)
    return bits8_dropout_f32(x, mask_bytes, t)


def math_dtype(storage: torch.dtype) -> torch.dtype:
    """The dtype a kernel's plain version computes in: fp32 for bf16
    storage (as the kernels and ``lvae_tpu``'s Pallas kernels do), else
    the storage's own (fp64 in the CPU tests' gradchecks)."""
    return torch.float32 if storage == torch.bfloat16 else storage


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def segment_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, t: int,
                    act: str, eps: float = 1e-5,
                    mask_bytes: Optional[torch.Tensor] = None,
                    running_mean: Optional[torch.Tensor] = None,
                    running_var: Optional[torch.Tensor] = None,
                    momentum: float = 0.9) -> Tuple[torch.Tensor, ...]:
    """The train-mode segment over NCHW ``x``, computed in ``x``'s dtype
    (fp32 for bf16 storage, ``y`` then cast back to bf16;
    ``segment_pallas.py:291-315``): ``(y, mean, var, r)`` with the batch
    mean and biased variance of ``u``, the dropped input (``t`` is the
    bits8 keep threshold; ``mask_bytes`` the uint8 byte of each element,
    needed when ``0 < t < 256``), and ``r = 1 / sqrt(var + eps)``.

    The sums are taken in fp64, as the kernel takes them: ``E[u^2] -
    mean^2`` cancels in fp32 at 64x64 maps. Given the running buffers, it
    moves them as flax does: ``ra = m ra + (1 - m) stat``. Differentiable
    by autograd; the hand-written backward is :func:`segment_backward`."""
    store = x.dtype
    x = x.to(math_dtype(store))
    u = _dropped(x, t, mask_bytes)
    n = u.numel() // u.shape[1]
    ud = u.double()
    mean_d = ud.sum(dim=(0, 2, 3)) / n
    var_d = (ud * ud).sum(dim=(0, 2, 3)) / n - mean_d * mean_d
    r_d = 1.0 / torch.sqrt(var_d + eps)
    mean, var, r = (v.to(x.dtype) for v in (mean_d, var_d, r_d))
    scale = gamma * r
    shift = beta - mean * scale
    y = _segment_act(u * _channel(scale) + _channel(shift), act).to(store)
    if running_mean is not None:
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean
                               + (1.0 - momentum) * mean.to(running_mean.dtype))
            running_var.copy_(momentum * running_var
                              + (1.0 - momentum) * var.to(running_var.dtype))
    return y, mean, var, r


def segment_backward(x: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, mean: torch.Tensor, r: torch.Tensor, t: int,
                     act: str, mask_bytes: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hand-written backward of :func:`segment_forward`
    (``segment_pallas.py:318-347``): ``(dx, dgamma, dbeta)`` from the
    cotangent ``g`` of ``y``, recomputing ``u``, ``z`` and ``act'(z)`` from
    ``x`` and the forward's ``mean`` and ``r``. It includes the
    batch-statistics terms ``m1 = mean(dz)``, ``m2 = mean(dz xhat)``; ``dx``
    is exactly 0 where the mask dropped the element. bf16 ``x`` and ``g``
    are computed in fp32 and ``dx`` cast back to bf16; dgamma and dbeta stay
    fp32."""
    store = x.dtype
    x, g = x.to(math_dtype(store)), g.to(math_dtype(store))
    u = _dropped(x, t, mask_bytes)
    n = u.numel() // u.shape[1]
    scale = gamma * r
    shift = beta - mean * scale
    dz = g * _segment_act_grad(u * _channel(scale) + _channel(shift), act)
    xhat = (u - _channel(mean)) * _channel(r)
    s1 = dz.double().sum(dim=(0, 2, 3))
    s2 = (dz * xhat).double().sum(dim=(0, 2, 3))
    dbeta, dgamma, m1, m2 = (v.to(x.dtype) for v in (s1, s2, s1 / n, s2 / n))
    du = _channel(gamma * r) * ((dz - _channel(m1)) - xhat * _channel(m2))
    if t >= 256:
        dx = du
    elif t <= 0:
        dx = torch.zeros_like(du)
    else:
        dx = torch.where(mask_bytes < t, du * float(np.float32(256.0 / t)), 0.0)
    return dx.to(store), dgamma, dbeta


# ---------------------------------------------------------------------------
# the segment over R > 1 ranks: the plain versions of the split launches
# (csrc/segment.cu split_*), each a function of this rank's tensors; the
# caller all-reduces the [2, S, C] sums between them
# ---------------------------------------------------------------------------


def segment_split_stats(x: torch.Tensor, t: int,
                        mask_bytes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[2, 1, C]`` fp64: per channel, ``sum(u)`` and ``sum(u^2)`` of this
    rank's dropped input ``u`` (the kernel's ``[2, S, C]`` with one
    slice)."""
    u = _dropped(x.to(math_dtype(x.dtype)), t, mask_bytes).double()
    return torch.stack([u.sum(dim=(0, 2, 3)), (u * u).sum(dim=(0, 2, 3))]).unsqueeze(1)


def _global_stats(part: torch.Tensor, n_global: int, eps: float, dtype: torch.dtype):
    """mean, var (biased) and r from the global ``[2, S, C]`` sums, as K5
    computes them from its fp64 sums."""
    s1, s2 = part.sum(dim=1).unbind(0)
    mean_d = s1 / n_global
    var_d = s2 / n_global - mean_d * mean_d
    r_d = 1.0 / torch.sqrt(var_d + eps)
    return tuple(v.to(dtype) for v in (mean_d, var_d, r_d))


def segment_split_apply(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        part: torch.Tensor, n_global: int, t: int, act: str,
                        eps: float = 1e-5, mask_bytes: Optional[torch.Tensor] = None,
                        running_mean: Optional[torch.Tensor] = None,
                        running_var: Optional[torch.Tensor] = None,
                        momentum: float = 0.9) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, stats)``: the segment of this rank's ``x`` normalised with the
    global sums ``part`` over ``n_global`` elements per channel; ``stats``
    the ``[5, C]`` rows mean, var, r, scale, shift. Moves the running
    buffers where given (flax's rule)."""
    store = x.dtype
    x = x.to(math_dtype(store))
    u = _dropped(x, t, mask_bytes)
    mean, var, r = _global_stats(part, n_global, eps, x.dtype)
    scale = gamma * r
    shift = beta - mean * scale
    y = _segment_act(u * _channel(scale) + _channel(shift), act).to(store)
    if running_mean is not None:
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean
                               + (1.0 - momentum) * mean.to(running_mean.dtype))
            running_var.copy_(momentum * running_var
                              + (1.0 - momentum) * var.to(running_var.dtype))
    return y, torch.stack([mean, var, r, scale, shift])


def _split_dz(x, g, stats, t, act, mask_bytes):
    """dz and xhat of this rank's elements from the forward's statistics."""
    u = _dropped(x, t, mask_bytes)
    mean, _, r, scale, shift = stats.unbind(0)
    dz = g * _segment_act_grad(u * _channel(scale) + _channel(shift), act)
    return dz, (u - _channel(mean)) * _channel(r)


def segment_split_bwd_reduce(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor, t: int,
                             act: str, mask_bytes: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """``[2, 1, C]`` fp64: ``sum(dz)`` and ``sum(dz xhat)`` of this rank's
    elements."""
    x, g = x.to(math_dtype(x.dtype)), g.to(math_dtype(x.dtype))
    dz, xhat = _split_dz(x, g, stats.to(x.dtype), t, act, mask_bytes)
    return torch.stack([dz.double().sum(dim=(0, 2, 3)),
                        (dz * xhat).double().sum(dim=(0, 2, 3))]).unsqueeze(1)


def segment_split_bwd_apply(x: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                            stats: torch.Tensor, local: torch.Tensor, part: torch.Tensor,
                            n_global: int, t: int, act: str,
                            mask_bytes: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dgamma, dbeta)``: dx from the global sums ``part`` (``m1 =
    sum(dz) / n``, ``m2 = sum(dz xhat) / n``), dgamma and dbeta this rank's
    own sums ``local`` (the train step sums the gradients over the
    ranks)."""
    store = x.dtype
    x, g = x.to(math_dtype(store)), g.to(math_dtype(store))
    stats = stats.to(x.dtype)
    dz, xhat = _split_dz(x, g, stats, t, act, mask_bytes)
    s1, s2 = part.sum(dim=1).unbind(0)
    m1, m2 = (v.to(x.dtype) for v in (s1 / n_global, s2 / n_global))
    l1, l2 = local.sum(dim=1).unbind(0)
    du = _channel(gamma * stats[2]) * ((dz - _channel(m1)) - xhat * _channel(m2))
    if t >= 256:
        dx = du
    elif t <= 0:
        dx = torch.zeros_like(du)
    else:
        dx = torch.where(mask_bytes < t, du * float(np.float32(256.0 / t)), 0.0)
    return dx.to(store), l2.to(x.dtype), l1.to(x.dtype)
