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

A CUDA tensor launches ``csrc/stochastic_kl.cu`` or raises; a CPU tensor
takes the plain PyTorch version beside it (``_plain_sample_kl*`` forward,
``_plain_sample_kl_bwd`` the hand-written backward). There is no other
path. Shapes are the port's NCHW: params ``[B, 2c, h, w]`` (mu then
log-variance along channels), z and the KL map ``[B, c, h, w]``. ``p`` may
be ``[1, 2c, h, w]`` or a stride-0 broadcast of it over B (the learned top
prior), which the kernels read with row stride 0; its gradient comes back
in the shape it was given, and autograd sums a broadcast's over B.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    ``:293-301``): ``(dq [B, 2c, h, w], dp [B, 2c, h, w])`` from the
    cotangent ``gz`` of z and ``gkl`` of the KL, elementwise or per row
    ``[B]``. A broadcast p gives its per-row gradient (the caller sums)."""
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
    return torch.cat([dqmu, dqlv], dim=1), torch.cat([dpmu, dplv], dim=1)


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
    if p_params.shape[0] == 1 or p_params.stride(0) == 0:
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


def _launch_fwd(q_params, p_params, eps, keyed, per_sample):
    b, c, hw, p, p_stride = _checked(q_params, p_params)
    dev = q_params.device
    z = torch.empty((b, c, *q_params.shape[2:]), device=dev)
    kl = torch.empty((b,), device=dev) if per_sample else torch.empty_like(z)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    eps_ptr = None if eps is None else eps.data_ptr()
    with torch.cuda.device(dev):
        if per_sample:
            name = "sample_kl_per_sample" if eps is None else "sample_kl_per_sample_eps"
            status = lib.lvae_sample_kl_per_sample(
                q_params.data_ptr(), p.data_ptr(), p_stride, *_c_noise(keyed),
                eps_ptr, z.data_ptr(), kl.data_ptr(), b, c, hw, stream)
        elif eps is None:
            name = "sample_kl"
            status = lib.lvae_sample_kl(
                q_params.data_ptr(), p.data_ptr(), p_stride, *_c_noise(keyed),
                z.data_ptr(), kl.data_ptr(), b, c, hw, stream)
        else:
            name = "sample_kl_eps"
            status = lib.lvae_sample_kl_eps(
                q_params.data_ptr(), p.data_ptr(), p_stride, eps_ptr,
                z.data_ptr(), kl.data_ptr(), b, c, hw, stream)
    build.LAUNCHES[name] += 1
    build.check(status, name)
    return z, kl


def sample_kl_backward(q_params: torch.Tensor, p_params: torch.Tensor,
                       gz: torch.Tensor, gkl: torch.Tensor, *,
                       eps: Optional[torch.Tensor] = None,
                       keyed: Optional[Keyed] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-bwd (``gkl`` ``[B, c, h, w]``) or K1-bwd (``gkl`` ``[B]``):
    ``(dq, dp)``, both ``[B, 2c, h, w]``. eps is ``eps`` or, with
    ``keyed``, regenerated from the Philox counter."""
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
    if q_params.device.type == "cpu":
        return _plain_sample_kl_bwd(q_params, p_params,
                                    eps if eps is not None else _eps_of(keyed, q_params),
                                    gz, gkl)
    dq = torch.empty_like(q_params)
    dp = torch.empty_like(q_params)
    lib = build.library()
    name = "sample_kl_per_sample_bwd" if per_row else "sample_kl_bwd"
    with torch.cuda.device(q_params.device):
        status = getattr(lib, "lvae_" + name)(
            q_params.data_ptr(), p.data_ptr(), p_stride, *_c_noise(keyed),
            None if eps is None else eps.data_ptr(), gz.data_ptr(), gkl.data_ptr(),
            dq.data_ptr(), dp.data_ptr(), b, c, hw,
            torch.cuda.current_stream(q_params.device).cuda_stream)
    build.LAUNCHES[name] += 1
    build.check(status, name)
    return dq, dp


class _SampleKL(torch.autograd.Function):
    """z and the KL (map, or per-row sums when ``per_sample``), with the
    hand-written backward. The kernels on CUDA, the plain versions on the
    CPU."""

    @staticmethod
    def forward(ctx, q_params, p_params, eps, keyed, per_sample):
        if q_params.device.type == "cpu":
            z, kl = _plain_sample_kl_eps(
                q_params, p_params, eps if eps is not None else _eps_of(keyed, q_params))
            if per_sample:
                kl = _row_sums(kl)
        else:
            z, kl = _launch_fwd(q_params, p_params, eps, keyed, per_sample)
        ctx.keyed = keyed
        ctx.save_for_backward(q_params, p_params, eps)
        return z, kl

    @staticmethod
    @once_differentiable
    def backward(ctx, gz, gkl):
        q_params, p_params, eps = ctx.saved_tensors
        dq, dp = sample_kl_backward(q_params, p_params, gz, gkl, eps=eps,
                                    keyed=ctx.keyed)
        if p_params.shape[0] != q_params.shape[0]:
            dp = dp.sum(dim=0, keepdim=True)
        return dq, dp, None, None, None


def _apply(q_params, p_params, eps, keyed, per_sample):
    b = _checked(q_params, p_params)[0]
    if keyed is not None:
        keyed = _keyed_on(keyed, b, q_params.device)
    else:
        want = (b, q_params.shape[1] // 2, *q_params.shape[2:])
        if eps.dtype != q_params.dtype:
            raise ValueError(f"eps must be {q_params.dtype}, got {eps.dtype}")
        eps = _checked_map(eps, want, q_params, "eps")
    return _SampleKL.apply(q_params, p_params, eps, keyed, per_sample)


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
