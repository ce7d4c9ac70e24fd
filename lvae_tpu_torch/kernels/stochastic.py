"""Fused sample + KL (forward): the port of ``fused_sample_kl``
(``lvae_tpu/kernels/stochastic_pallas.py:419``), eval path.

``sample_kl`` draws z = mu_q + sigma_q * eps with eps from the keyed
Philox generator (``ops/philox.py``) and returns the elementwise KL map,
in one pass over the conv heads' outputs. ``sample_kl_eps`` takes eps as
an operand instead (the twin of ``_fwd_eps_kernel``), so tests and the
chip smoke run can feed a given eps.

A CUDA tensor launches ``csrc/stochastic_kl.cu`` or raises; a CPU tensor
takes the plain PyTorch version beside it (``_plain_sample_kl*``). There
is no other fallback. Shapes are the port's NCHW: params ``[B, 2c, h, w]``
(mu then log-variance along channels), outputs ``[B, c, h, w]``. ``p``
may be ``[1, 2c, h, w]`` or a stride-0 broadcast of it over B (the
learned top prior), which the kernel reads with row stride 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.ops.philox import Ints, keyed_normal, seed_words
from lvae_tpu_torch.ops.stochastic import split_params


def _kl_terms(qmu, qlv, pmu, plv):
    # the kernel's operation order (csrc/stochastic_kl.cu)
    return 0.5 * (torch.exp(qlv - plv) + (qmu - pmu) ** 2 * torch.exp(-plv)
                  - 1.0 - qlv + plv)


def _plain_sample_kl_eps(q_params: torch.Tensor, p_params: torch.Tensor,
                         eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    qmu, qlv = split_params(q_params)
    pmu, plv = split_params(p_params)
    z = qmu + torch.exp(0.5 * qlv) * eps
    return z, _kl_terms(qmu, qlv, pmu, plv)


def _plain_sample_kl(q_params, p_params, index, seed, sample, stream):
    b, c2, h, w = q_params.shape
    eps = keyed_normal((b, c2 // 2, h, w), seed, index, sample, stream)
    return _plain_sample_kl_eps(q_params, p_params, eps)


def _checked(q_params: torch.Tensor, p_params: torch.Tensor):
    """Validate the operands; returns (rows, c, h*w, p tensor, p row
    stride in elements)."""
    if q_params.dim() != 4 or q_params.shape[1] % 2:
        raise ValueError(
            f"q_params must be [B, 2c, h, w], got {tuple(q_params.shape)}"
        )
    b, c2, h, w = q_params.shape
    if p_params.dim() != 4 or tuple(p_params.shape[1:]) != (c2, h, w) or (
        p_params.shape[0] not in (1, b)
    ):
        raise ValueError(
            f"p_params must be [1 or {b}, {c2}, {h}, {w}], got "
            f"{tuple(p_params.shape)}"
        )
    for name, t in (("q_params", q_params), ("p_params", p_params)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q_params.device:
            raise ValueError(f"{name} is on {t.device}, q_params on {q_params.device}")
    if not q_params.is_contiguous():
        raise ValueError("q_params must be contiguous NCHW")
    if p_params.shape[0] == 1 or p_params.stride(0) == 0:
        p, p_stride = p_params[:1], 0
    else:
        p, p_stride = p_params, c2 * h * w
    if not p.is_contiguous():
        raise ValueError("p_params must be contiguous NCHW (or a row broadcast)")
    return b, c2 // 2, h * w, p, p_stride


def sample_kl(q_params: torch.Tensor, p_params: torch.Tensor,
              index: torch.Tensor, seed: int, sample: Ints, stream: int,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, kl) ``[B, c, h, w]`` with row ``i``'s noise keyed by
    ``(seed, index[i], sample[i], stream)``. ``sample`` is an int or an
    int64 ``[B]`` tensor."""
    b, c, hw, p, p_stride = _checked(q_params, p_params)
    if q_params.device.type == "cpu":
        return _plain_sample_kl(q_params, p_params, index, seed, sample, stream)
    if q_params.device.type != "cuda":
        raise ValueError(f"sample_kl runs on cpu or cuda, got {q_params.device}")
    index = _row_words(index, b, q_params.device, "index")
    if isinstance(sample, torch.Tensor):
        sample_rows = _row_words(sample, b, q_params.device, "sample")
        sample_ptr, sample_word = sample_rows.data_ptr(), 0
    else:  # one sample word for every row: no per-row operand
        sample_ptr, sample_word = None, int(sample) & 0xFFFFFFFF
    z = torch.empty((b, c, *q_params.shape[2:]), device=q_params.device)
    kl = torch.empty_like(z)
    k0, k1 = seed_words(seed)
    with torch.cuda.device(q_params.device):
        status = build.library().lvae_sample_kl(
            q_params.data_ptr(), p.data_ptr(), p_stride, index.data_ptr(),
            sample_ptr, sample_word, k0 | (k1 << 32), stream & 0xFFFFFFFF,
            z.data_ptr(), kl.data_ptr(), b, c, hw,
            torch.cuda.current_stream().cuda_stream,
        )
    build.LAUNCHES["sample_kl"] += 1
    build.check(status, "sample_kl")
    return z, kl


def sample_kl_eps(q_params: torch.Tensor, p_params: torch.Tensor,
                  eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, kl) from a given standard-normal ``eps`` ``[B, c, h, w]``."""
    b, c, hw, p, p_stride = _checked(q_params, p_params)
    if tuple(eps.shape) != (b, c, *q_params.shape[2:]) or eps.dtype != torch.float32:
        raise ValueError(
            f"eps must be float32 {(b, c, *q_params.shape[2:])}, got "
            f"{eps.dtype} {tuple(eps.shape)}"
        )
    if eps.device != q_params.device:
        raise ValueError(f"eps is on {eps.device}, q_params on {q_params.device}")
    if q_params.device.type == "cpu":
        return _plain_sample_kl_eps(q_params, p_params, eps)
    if q_params.device.type != "cuda":
        raise ValueError(f"sample_kl_eps runs on cpu or cuda, got {q_params.device}")
    if not eps.is_contiguous():
        raise ValueError("eps must be contiguous NCHW")
    z = torch.empty_like(eps)
    kl = torch.empty_like(eps)
    with torch.cuda.device(q_params.device):
        status = build.library().lvae_sample_kl_eps(
            q_params.data_ptr(), p.data_ptr(), p_stride, eps.data_ptr(),
            z.data_ptr(), kl.data_ptr(), b, c, hw,
            torch.cuda.current_stream().cuda_stream,
        )
    build.LAUNCHES["sample_kl_eps"] += 1
    build.check(status, "sample_kl_eps")
    return z, kl


def _row_words(v: torch.Tensor, b: int, device: torch.device,
               name: str) -> torch.Tensor:
    """An int64 ``[B]`` tensor, contiguous on ``device``; the kernel reads
    its low 32 bits."""
    t = torch.as_tensor(v, dtype=torch.int64, device=device)
    if tuple(t.shape) != (b,):
        raise ValueError(f"{name} must be int64 [{b}], got {tuple(t.shape)}")
    return t.contiguous()

