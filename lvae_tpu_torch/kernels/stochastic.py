"""Fused sample + KL, forward and backward: the port of
``lvae_tpu/kernels/stochastic_pallas.py``.

Each function draws z = mu_q + sigma_q * eps and takes the Gaussian KL in
one pass over the conv heads' outputs, and is a ``torch.autograd.Function``
whose backward is a kernel too:

- :func:`sample_kl` / :func:`sample_kl_eps`: K2, the elementwise KL map
  (``fused_sample_kl`` :419; eval, and any caller that needs the map);
- :func:`sample_kl_per_sample` / :func:`sample_kl_per_sample_eps`: K1, the
  KL summed per row to ``[B]`` in the kernel (``fused_sample_kl_per_sample``
  :399; the training step, which needs nothing finer);
- their backward, K2-bwd and K1-bwd (:func:`sample_kl_backward`): the four
  parameter gradients from the cotangents of z and of the KL (elementwise
  or per row).

``sample_kl`` and ``sample_kl_per_sample`` draw eps from the keyed Philox
generator (``ops/philox.py``); the backward regenerates it from the same
counter. The ``*_eps`` twins take eps as an operand (the twins of
``_fwd_eps_kernel`` / ``_fwd_reduce_eps_kernel``).

K1 and the backward launch with a plan computed here from the shape
(:func:`k1_plan`, :func:`k1_bwd_plan`), which the C side checks against
the shape: a CTA per row for K1, a grid over (row group, slice of the
row) for the backward, one CTA per slice of all the rows for a stride-0
prior.

A CUDA tensor launches ``csrc/stochastic_kl.cu`` or raises; a CPU tensor
takes the plain PyTorch version beside it (``_plain_sample_kl*`` forward,
``_plain_sample_kl_bwd`` the hand-written backward). There is no other
path. Shapes are the port's NCHW: params ``[B, 2c, h, w]`` (mu then
log-variance along channels), z and the KL map ``[B, c, h, w]``. ``p`` may
be ``[1, 2c, h, w]`` or a stride-0 broadcast of it over B (the learned top
prior), which the kernels read with row stride 0; its gradient comes back
``[1, 2c, h, w]``, summed over B in the kernel (on the CPU, in fp64 by the
plain version). Given the one row itself (as the model's top layer gives
it), that gradient reaches it as it is: no ``[B, 2c, h, w]`` gradient is
made and summed.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.ops.philox import Ints, keyed_normal, seed_words
from lvae_tpu_torch.ops.stochastic import split_params


@dataclasses.dataclass(frozen=True)
class Keyed:
    """Keyed noise: row ``i`` draws with counter ``(offset, index[i],
    sample[i], stream)`` under ``seed`` (``sample`` an int or int64 [B])."""

    index: torch.Tensor
    seed: int
    sample: Ints
    stream: int


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

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


def _eps_of(keyed: Keyed, q_params: torch.Tensor) -> torch.Tensor:
    b, c2, h, w = q_params.shape
    return keyed_normal((b, c2 // 2, h, w), keyed.seed, keyed.index,
                        keyed.sample, keyed.stream)


def _plain_sample_kl(q_params, p_params, index, seed, sample, stream):
    eps = _eps_of(Keyed(index, seed, sample, stream), q_params)
    return _plain_sample_kl_eps(q_params, p_params, eps)


def _row_sums(kl: torch.Tensor) -> torch.Tensor:
    """Per-row sums of a KL map, accumulated in fp64 as the kernel does."""
    return kl.sum(dim=(1, 2, 3), dtype=torch.float64).to(kl.dtype)


def _plain_sample_kl_per_sample_eps(q_params, p_params, eps):
    z, kl = _plain_sample_kl_eps(q_params, p_params, eps)
    return z, _row_sums(kl)


def _plain_sample_kl_per_sample(q_params, p_params, index, seed, sample, stream):
    z, kl = _plain_sample_kl(q_params, p_params, index, seed, sample, stream)
    return z, _row_sums(kl)


def _plain_sample_kl_bwd(q_params, p_params, eps, gz, gkl):
    """The hand-written backward (``stochastic_pallas.py:109-118`` and
    ``:293-301``): ``(dq [B, 2c, h, w], dp)`` from the cotangent ``gz`` of
    z and ``gkl`` of the KL, elementwise or per row ``[B]``. dp is ``[B,
    2c, h, w]``, or, for a p of one row or a stride-0 broadcast of one,
    ``[1, 2c, h, w]``: the per-row gradients summed over B in fp64, as the
    kernel sums them."""
    qmu, qlv = split_params(q_params)
    pmu, plv = split_params(p_params)
    if gkl.dim() == 1:
        gkl = gkl.view(-1, 1, 1, 1)
    diff = qmu - pmu
    inv_pvar = torch.exp(-plv)
    var_ratio = torch.exp(qlv - plv)
    sigma_q = torch.exp(0.5 * qlv)
    dqmu = gz + gkl * diff * inv_pvar
    dqlv = gz * 0.5 * sigma_q * eps + gkl * 0.5 * (var_ratio - 1.0)
    dpmu = -gkl * diff * inv_pvar
    dplv = gkl * 0.5 * (1.0 - var_ratio - diff * diff * inv_pvar)
    dp = torch.cat([dpmu, dplv], dim=1)
    if p_params.shape[0] == 1 or p_params.stride(0) == 0:
        dp = dp.sum(dim=0, keepdim=True, dtype=torch.float64).to(dp.dtype)
    return torch.cat([dqmu, dqlv], dim=1), dp


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

K1_MAX_THREADS = 512    # csrc kK1MaxThreads
K1_SCALAR_MAX = 2048    # K1 takes rows of at most this many elements in units of 1
BWD_MAX_THREADS = 256   # csrc kBwdMaxThreads
BWD_PX = 128            # the backward's threads along the row per CTA, at most
BWD_VEC_MIN = 1 << 18   # ... which take units of 4 from this many elements a launch
SUM_MAX_THREADS = 512   # csrc kSumMaxThreads: a CTA of the prior's sum
SUM_PX = 2              # ... its elements along the row
MAX_PER_ROW = 2 ** 30 - 1


class K1Plan(NamedTuple):
    """K1's launch (csrc ``K1Plan``): row b is CTA b, whose thread t takes
    the units ``i threads + t`` of the row, ``i < per_thread``. A unit is
    ``vec`` consecutive elements (4: float4 accesses)."""

    rows: int
    per_row: int
    vec: int
    threads: int
    per_thread: int

    @property
    def units(self) -> int:
        return self.per_row // self.vec

    def units_of(self, thread: int) -> list:
        """The units that thread ``thread`` of a row's CTA takes."""
        return [u for u in range(thread, self.threads * self.per_thread, self.threads)
                if u < self.units]


class BwdPlan(NamedTuple):
    """The backward's launch (csrc ``BwdPlan``): a grid of (row groups,
    slices of ``px`` units of the row; with ``prior_sum`` the slices along
    the grid's x); a CTA is ``px`` threads along the
    row by ``ry`` across the rows, thread (tx, ty) taking unit ``slice px
    + tx`` of row ``group ry + ty``. ``prior_sum``: p is one row read with
    stride 0, there is one row group, thread (tx, ty) takes rows ``ty, ty
    + ry, ...`` and the CTA sums their dp over the rows."""

    rows: int
    per_row: int
    vec: int
    px: int
    ry: int
    prior_sum: int

    @property
    def units(self) -> int:
        return self.per_row // self.vec

    @property
    def grid(self) -> Tuple[int, int]:
        return (1 if self.prior_sum else -(-self.rows // self.ry)), -(-self.units // self.px)


class _CK1Plan(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_int64)] + [
        (k, ctypes.c_int) for k in ("per_row", "vec", "threads", "per_thread")]


class _CBwdPlan(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_int64)] + [
        (k, ctypes.c_int) for k in ("per_row", "vec", "px", "ry", "prior_sum")]


def _round32(n: int) -> int:
    return 32 * -(-n // 32)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _per_row(rows: int, c: int, hw: int) -> int:
    per_row = c * hw
    if rows < 1 or not 1 <= per_row <= MAX_PER_ROW:
        raise ValueError(f"the sample+KL kernels take rows >= 1 of 1 to {MAX_PER_ROW} "
                         f"elements, got {rows} rows of {c} x {hw}")
    return per_row


@functools.lru_cache(maxsize=None)
def k1_plan(rows: int, c: int, hw: int, aligned: bool = True) -> K1Plan:
    """K1's launch for ``rows`` rows of ``c hw`` elements, a function of
    the shape (so the order of each row's sum, and its bits, is too).
    Units of 4 elements (float4) where ``c hw % 4 == 0``, the operands are
    16-byte ``aligned`` and the row is longer than ``K1_SCALAR_MAX``; else
    of 1. One CTA per row: ``ceil(units / K1_MAX_THREADS)`` units per
    thread, and as few threads (a multiple of 32) as take them. Fitted to
    an H100 at the models' shapes (the sweeps in ``PERF.md`` §6), where a row
    spread over a thread block cluster, over 256 threads, or over units of
    4 at 8x8 and below ran slower (16x16: 512 threads of 4 units of 4;
    8x8: 512 threads of 4 elements)."""
    per_row = _per_row(rows, c, hw)
    vec = 4 if per_row % 4 == 0 and aligned and per_row > K1_SCALAR_MAX else 1
    units = per_row // vec
    per_thread = -(-units // K1_MAX_THREADS)
    threads = _round32(-(-units // per_thread))
    if rows > 2 ** 31 - 1:
        raise ValueError(f"K1 takes at most {2 ** 31 - 1} rows, got {rows}")
    return K1Plan(rows, per_row, vec, threads, per_thread)


@functools.lru_cache(maxsize=None)
def k1_bwd_plan(rows: int, c: int, hw: int, prior_sum: bool, aligned: bool = True) -> BwdPlan:
    """The backward's launch (K1-bwd and K2-bwd) for ``rows`` rows of ``c
    hw`` elements; ``prior_sum`` where p is one row read with stride 0,
    whose gradient the kernel sums over the rows. Without ``prior_sum``,
    up to ``BWD_PX`` threads along the row and one row per CTA, one unit
    per thread: of 4 elements (float4) from ``BWD_VEC_MIN`` elements a
    launch (where the kernel is bound by throughput), else of 1 (where
    it is bound by a thread's latency: more threads, each shorter). With
    it, units of one element, ``SUM_PX`` along the row and all the rows
    in one CTA: ``ry``, a power of 2, across them (each thread walks
    every ``ry``-th row), at most ``SUM_MAX_THREADS`` threads; the CTA adds
    its threads' sums over ``ry`` in a fixed tree, so no sum crosses
    CTAs."""
    per_row = _per_row(rows, c, hw)
    if prior_sum:
        vec, px = 1, SUM_PX
        ry = min(max(_pow2_at_least(rows), 32 // px), SUM_MAX_THREADS // px)
    else:
        vec = 4 if per_row % 4 == 0 and aligned and rows * per_row >= BWD_VEC_MIN else 1
        px, ry = min(_round32(per_row // vec), BWD_PX), 1
    if not prior_sum and -(-per_row // vec // px) > 65535:
        raise ValueError(f"the backward takes rows of at most {65535 * px * vec} elements, "
                         f"got {per_row}")
    return BwdPlan(rows, per_row, vec, px, ry, int(prior_sum))


@functools.lru_cache(maxsize=None)
def _c_k1_plan(rows: int, c: int, hw: int, aligned: bool):
    """(K1's plan as the C entry point takes it, its address)."""
    cp = _CK1Plan(*k1_plan(rows, c, hw, aligned))
    return cp, ctypes.addressof(cp)


@functools.lru_cache(maxsize=None)
def _c_bwd_plan(rows: int, c: int, hw: int, prior_sum: bool, aligned: bool):
    """(The backward's plan as the C entry points take it, its address)."""
    cp = _CBwdPlan(*k1_bwd_plan(rows, c, hw, prior_sum, aligned))
    return cp, ctypes.addressof(cp)


def _aligned(*ts: Optional[torch.Tensor]) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


# ---------------------------------------------------------------------------
# operand checks and launches
# ---------------------------------------------------------------------------

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
    if q_params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the sample+KL kernels run on cpu or cuda, got {q_params.device}")
    if p_params.device != q_params.device:
        raise ValueError(f"p_params is on {p_params.device}, q_params on {q_params.device}")
    # CUDA: the kernels' fp32; CPU: the plain version also takes fp64
    # (gradcheck)
    ok = (torch.float32,) if q_params.device.type == "cuda" else (
        torch.float32, torch.float64)
    for name, t in (("q_params", q_params), ("p_params", p_params)):
        if t.dtype not in ok or t.dtype != q_params.dtype:
            raise TypeError(f"{name} must be float32 (like q_params), got {t.dtype}")
    if not q_params.is_contiguous():
        raise ValueError("q_params must be contiguous NCHW")
    if p_params.shape[0] == 1:
        p, p_stride = p_params, 0
    elif p_params.stride(0) == 0:
        p, p_stride = p_params[:1], 0
    else:
        p, p_stride = p_params, c2 * h * w
    if not p.is_contiguous():
        raise ValueError("p_params must be contiguous NCHW (or a row broadcast)")
    return b, c2 // 2, h * w, p, p_stride


def _checked_map(t: Optional[torch.Tensor], shape, like: torch.Tensor,
                 name: str) -> Optional[torch.Tensor]:
    """A float map operand of ``shape`` on ``like``'s device (contiguous
    for the kernel)."""
    if t is None:
        return None
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q_params on {like.device}")
    if like.device.type == "cuda" and t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    return t.contiguous() if like.device.type == "cuda" else t


def _row_words(v: torch.Tensor, b: int, device: torch.device,
               name: str) -> torch.Tensor:
    """An int64 ``[B]`` tensor, contiguous on ``device``; the kernel reads
    its low 32 bits."""
    t = torch.as_tensor(v, dtype=torch.int64, device=device)
    if tuple(t.shape) != (b,):
        raise ValueError(f"{name} must be int64 [{b}], got {tuple(t.shape)}")
    return t.contiguous()


def _keyed_on(keyed: Keyed, b: int, device: torch.device) -> Keyed:
    sample = keyed.sample
    if isinstance(sample, torch.Tensor):
        sample = _row_words(sample, b, device, "sample")
    return Keyed(_row_words(keyed.index, b, device, "index"), int(keyed.seed),
                 sample, int(keyed.stream))


def _c_noise(keyed: Optional[Keyed]) -> tuple:
    """The C interface's (index, sample or NULL, sample_word, seed,
    stream_word); zeros for given eps."""
    if keyed is None:
        return None, None, 0, 0, 0
    k0, k1 = seed_words(keyed.seed)
    if isinstance(keyed.sample, torch.Tensor):
        sample_ptr, sample_word = keyed.sample.data_ptr(), 0
    else:  # one sample word for every row: no per-row operand
        sample_ptr, sample_word = None, int(keyed.sample) & 0xFFFFFFFF
    return (keyed.index.data_ptr(), sample_ptr, sample_word, k0 | (k1 << 32),
            keyed.stream & 0xFFFFFFFF)


def _launch_fwd(q_params, p, p_stride, eps, keyed, per_sample, b, c, hw):
    """K1 or K2 on checked operands (``p`` and ``p_stride`` as
    :func:`_checked` gives them, ``keyed`` on the device)."""
    dev = q_params.device
    z = torch.empty((b, c, *q_params.shape[2:]), device=dev)
    kl = torch.empty((b,), device=dev) if per_sample else torch.empty_like(z)
    lib = build.library()
    eps_ptr = None if eps is None else eps.data_ptr()
    if per_sample:
        name = "sample_kl_per_sample" if eps is None else "sample_kl_per_sample_eps"
        _, plan = _c_k1_plan(b, c, hw, _aligned(q_params, p, eps))
        status = build.on_device(q_params, lambda stream: lib.lvae_sample_kl_per_sample(
            plan, q_params.data_ptr(), p.data_ptr(), p_stride, *_c_noise(keyed), eps_ptr,
            z.data_ptr(), kl.data_ptr(), b, c, hw, stream))
    elif eps is None:
        name = "sample_kl"
        status = build.on_device(q_params, lambda stream: lib.lvae_sample_kl(
            q_params.data_ptr(), p.data_ptr(), p_stride, *_c_noise(keyed),
            z.data_ptr(), kl.data_ptr(), b, c, hw, stream))
    else:
        name = "sample_kl_eps"
        status = build.on_device(q_params, lambda stream: lib.lvae_sample_kl_eps(
            q_params.data_ptr(), p.data_ptr(), p_stride, eps_ptr,
            z.data_ptr(), kl.data_ptr(), b, c, hw, stream))
    build.LAUNCHES[name] += 1
    build.check(status, name)
    return z, kl


def _backward(q_params, p, p_stride, gz, gkl, eps, keyed, b, c, hw):
    """K1-bwd (``gkl`` ``[B]``) or K2-bwd on checked operands: ``(dq,
    dp)``, dp ``[1, 2c, h, w]`` where ``p_stride`` is 0."""
    if q_params.device.type == "cpu":
        return _plain_sample_kl_bwd(q_params, p,
                                    eps if eps is not None else _eps_of(keyed, q_params),
                                    gz, gkl)
    per_row = gkl.dim() == 1
    dq = torch.empty_like(q_params)
    dp = torch.empty_like(p)
    _, plan = _c_bwd_plan(b, c, hw, p_stride == 0,
                          _aligned(q_params, p, gz, None if per_row else gkl, eps))
    name = "sample_kl_per_sample_bwd" if per_row else "sample_kl_bwd"
    fn = getattr(build.library(), "lvae_" + name)
    status = build.on_device(q_params, lambda stream: fn(
        plan, q_params.data_ptr(), p.data_ptr(), p_stride, *_c_noise(keyed),
        None if eps is None else eps.data_ptr(), gz.data_ptr(), gkl.data_ptr(),
        dq.data_ptr(), dp.data_ptr(), b, c, hw, stream))
    build.LAUNCHES[name] += 1
    build.check(status, name)
    return dq, dp


def sample_kl_backward(q_params: torch.Tensor, p_params: torch.Tensor,
                       gz: torch.Tensor, gkl: torch.Tensor, *,
                       eps: Optional[torch.Tensor] = None,
                       keyed: Optional[Keyed] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-bwd (``gkl`` ``[B, c, h, w]``) or K1-bwd (``gkl`` ``[B]``):
    ``(dq, dp)``, dq ``[B, 2c, h, w]``; dp ``[B, 2c, h, w]``, or ``[1, 2c,
    h, w]`` summed over B where p is ``[1, 2c, h, w]`` or a stride-0
    broadcast of it. eps is ``eps`` or, with ``keyed``, regenerated from
    the Philox counter."""
    b, c, hw, p, p_stride = _checked(q_params, p_params)
    if (eps is None) == (keyed is None):
        raise ValueError("pass exactly one of eps and keyed")
    zshape = (b, c, *q_params.shape[2:])
    per_row = gkl.dim() == 1
    gz = _checked_map(gz, zshape, q_params, "gz")
    gkl = _checked_map(gkl, (b,) if per_row else zshape, q_params, "gkl")
    eps = _checked_map(eps, zshape, q_params, "eps")
    if keyed is not None:
        keyed = _keyed_on(keyed, b, q_params.device)
    return _backward(q_params, p, p_stride, gz, gkl, eps, keyed, b, c, hw)


class _SampleKL(torch.autograd.Function):
    """z and the KL (map, or per-row sums when ``per_sample``), with the
    hand-written backward. The kernels on CUDA, the plain versions on the
    CPU. Takes the operands as :func:`_apply` checked them (``shape``:
    rows, c, h w, p's row stride)."""

    @staticmethod
    def forward(ctx, q_params, p_params, eps, keyed, per_sample, shape):
        b, c, hw, p_stride = shape
        if q_params.device.type == "cpu":
            z, kl = _plain_sample_kl_eps(
                q_params, p_params, eps if eps is not None else _eps_of(keyed, q_params))
            if per_sample:
                kl = _row_sums(kl)
        else:
            z, kl = _launch_fwd(q_params, p_params, p_stride, eps, keyed, per_sample, b, c,
                                hw)
        ctx.keyed, ctx.shape = keyed, shape
        ctx.save_for_backward(q_params, p_params, eps)
        return z, kl

    @staticmethod
    @once_differentiable
    def backward(ctx, gz, gkl):
        q_params, p_params, eps = ctx.saved_tensors
        b, c, hw, p_stride = ctx.shape
        dq, dp = _backward(q_params, p_params, p_stride, gz.contiguous(), gkl.contiguous(),
                           eps, ctx.keyed, b, c, hw)
        return dq, dp, None, None, None, None


def _apply(q_params, p_params, eps, keyed, per_sample):
    b, c, hw, p, p_stride = _checked(q_params, p_params)
    if keyed is not None:
        keyed = _keyed_on(keyed, b, q_params.device)
    else:
        want = (b, c, *q_params.shape[2:])
        if eps.dtype != q_params.dtype:
            raise ValueError(f"eps must be {q_params.dtype}, got {eps.dtype}")
        eps = _checked_map(eps, want, q_params, "eps")
    return _SampleKL.apply(q_params, p, eps, keyed, per_sample, (b, c, hw, p_stride))


def sample_kl(q_params: torch.Tensor, p_params: torch.Tensor,
              index: torch.Tensor, seed: int, sample: Ints, stream: int,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (z, kl) ``[B, c, h, w]`` with row ``i``'s noise keyed by
    ``(seed, index[i], sample[i], stream)``. ``sample`` is an int or an
    int64 ``[B]`` tensor."""
    return _apply(q_params, p_params, None, Keyed(index, seed, sample, stream), False)


def sample_kl_eps(q_params: torch.Tensor, p_params: torch.Tensor,
                  eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (z, kl) from a given standard-normal ``eps`` ``[B, c, h, w]``."""
    return _apply(q_params, p_params, eps, None, False)


def sample_kl_per_sample(q_params: torch.Tensor, p_params: torch.Tensor,
                         index: torch.Tensor, seed: int, sample: Ints,
                         stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (z ``[B, c, h, w]``, kl ``[B]``), the KL summed over each row
    in the kernel (deterministically); noise keyed as in
    :func:`sample_kl`."""
    return _apply(q_params, p_params, None, Keyed(index, seed, sample, stream), True)


def sample_kl_per_sample_eps(q_params: torch.Tensor, p_params: torch.Tensor,
                             eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 from a given ``eps``."""
    return _apply(q_params, p_params, eps, None, True)
