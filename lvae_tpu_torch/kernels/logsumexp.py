"""logsumexp over axis 0 of a ``[k, B]`` matrix: the port of
``pallas_logsumexp`` (``lvae_tpu/kernels/logsumexp_pallas.py:107``).

A CUDA tensor launches ``csrc/logsumexp.cu`` with a plan computed here
from the shape (:func:`lse_plan`, which the C side checks), or raises; a
CPU tensor takes the plain PyTorch version beside it. An all -inf column
gives -inf, not NaN (so does any column whose max is not finite, or that
holds a NaN, as in the TPU kernel).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from lvae_tpu_torch.kernels import build

LSE_MAX_ROWS = 16               # rows a thread loads at once (csrc kMaxRows)
LSE_MAX_WARPS = 32              # warps a CTA may have (csrc kMaxWarps)
LSE_WARPS = 8                   # warps a CTA takes where k and the grid allow
LSE_MIN_WARPS = 4               # warps a CTA takes at least, where k allows
LSE_LAUNCH_WARPS = 2_560        # warps a launch takes at most, down to LSE_MIN_WARPS


class LsePlan(NamedTuple):
    """K4's launch (csrc ``LsePlan``): CTA ``i`` takes the 32 columns
    from ``32 i``, a lane one of them; warp ``w`` takes the rows ``[w
    span, (w + 1) span)`` (``span = rows chunks``), in ``chunks`` loads of
    ``rows`` rows a thread."""

    b: int
    k: int
    warps: int
    rows: int
    chunks: int

    @property
    def grid(self) -> int:
        return -(-self.b // 32)

    def rows_of(self, warp: int, chunk: int) -> range:
        """The rows that each thread of warp ``warp`` loads in ``chunk``."""
        start = (warp * self.chunks + chunk) * self.rows
        return range(start, max(start, min(start + self.rows, self.k)))


class _CLsePlan(ctypes.Structure):
    _fields_ = [("b", ctypes.c_int64)] + [
        (f, ctypes.c_int) for f in ("k", "warps", "rows", "chunks")]


def split_rows(k: int, warps: int) -> Tuple[int, int, int]:
    """(warps, rows, chunks): ``k`` rows over at most ``warps`` warps, each
    a contiguous block of ``rows chunks`` rows, as even as the blocks
    allow, loaded ``rows <= LSE_MAX_ROWS`` at a time; no warp empty."""
    span = -(-k // min(warps, k))
    chunks = -(-span // LSE_MAX_ROWS)
    rows = -(-span // chunks)
    return -(-k // (rows * chunks)), rows, chunks


@functools.lru_cache(maxsize=None)
def lse_plan(k: int, b: int) -> LsePlan:
    """K4's launch for a ``[k, b]`` matrix, a function of the shape (so
    the order of each column's sums, and its bits, is too). ``LSE_WARPS``
    warps split k, more where k needs more than ``LSE_MAX_ROWS`` rows a
    warp (up to ``LSE_MAX_WARPS``), fewer where the grid is so large that
    the launch would take more than ``LSE_LAUNCH_WARPS`` warps; what a
    warp's rows do not hold goes in chunks. Fitted to an H100 (the sweep
    in ``PERF.md`` §6): at the IW-LL's shapes ([100, 1000], [100, 500]) 8
    warps, 32 and 16 CTAs, each thread one burst of 13 loads."""
    if k < 1 or b < 1:
        raise ValueError(f"logsumexp's kernel takes k >= 1 rows and B >= 1 columns, "
                         f"got [{k}, {b}]")
    if k > 2 ** 31 - 1 or -(-b // 32) > 2 ** 31 - 1:
        raise ValueError(f"logsumexp's kernel takes at most 2^31 - 1 rows and CTAs, "
                         f"got [{k}, {b}]")
    warps = min(LSE_MAX_WARPS, max(LSE_WARPS, -(-k // LSE_MAX_ROWS)),
                max(LSE_MIN_WARPS, LSE_LAUNCH_WARPS // -(-b // 32)))
    return LsePlan(b, k, *split_rows(k, warps))


@functools.lru_cache(maxsize=None)
def _c_plan(k: int, b: int):
    """(The plan as the C entry point takes it, its address)."""
    cp = _CLsePlan(*lse_plan(k, b))
    return cp, ctypes.addressof(cp)


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
    if b == 0:
        return out
    _, plan = _c_plan(k, b)
    status = build.on_device(x, lambda stream: build.library().lvae_logsumexp(
        plan, x.data_ptr(), k, b, out.data_ptr(), stream))
    build.LAUNCHES["logsumexp"] += 1
    build.check(status, "logsumexp")
    return out
