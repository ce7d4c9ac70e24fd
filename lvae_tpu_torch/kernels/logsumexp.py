"""logsumexp over axis 0 of a ``[k, B]`` matrix: the port of
``pallas_logsumexp`` (``lvae_tpu/kernels/logsumexp_pallas.py:107``).

A CUDA tensor launches ``csrc/logsumexp.cu`` or raises; a CPU tensor takes
the plain PyTorch version beside it. An all -inf column gives -inf, not
NaN (so does any column whose max is not finite, as in the TPU kernel).
"""

from __future__ import annotations

import torch

from lvae_tpu_torch.kernels import build


def _plain_logsumexp(x: torch.Tensor) -> torch.Tensor:
    m = x.amax(dim=0)
    finite = torch.isfinite(m)
    safe_m = torch.where(finite, m, torch.zeros_like(m))
    s = torch.exp(x - safe_m).sum(dim=0)
    return torch.where(finite, safe_m + torch.log(s),
                       torch.full_like(m, float("-inf")))


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``[k, B]`` float32 -> ``[B]``."""
    if x.dim() != 2:
        raise ValueError(f"expected [k, B], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if x.device.type == "cpu":
        return _plain_logsumexp(x)
    if x.device.type != "cuda":
        raise ValueError(f"logsumexp runs on cpu or cuda, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous [k, B] row-major")
    k, b = x.shape
    if k < 1:
        raise ValueError("logsumexp needs k >= 1 rows")
    out = torch.empty(b, device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().lvae_logsumexp(
            x.data_ptr(), k, b, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.LAUNCHES["logsumexp"] += 1
    build.check(status, "logsumexp")
    return out
