"""Train-mode [bits8 dropout ->] BatchNorm -> ELU/ReLU, forward and
backward: the port of ``fused_dropout_bn_act``
(``lvae_tpu/kernels/segment_pallas.py:380``).

:func:`dropout_bn_act` is a ``torch.autograd.Function``: the forward is K5
(``_segment_fwd_impl`` :291; it also moves the running statistics), the
backward K5-bwd (``_segment_bwd_impl`` :318). Both take the model's NCHW
map ``x [B, C, H, W]`` as it is, with any B, C, H and W; the dropout bytes
are the keyed Philox bytes of
:func:`lvae_tpu_torch.ops.philox.dropout_bytes` under ``mix_seed(seed,
step, site)``, generated in the kernel: it takes the train seed and the
site by value and reads the step from device memory (a 0-d int64
tensor), deriving the key on chip, so a CUDA graph of a train step
replays with the step it finds there.

Each direction is one launch of ``csrc/segment.cu`` whose shape
:func:`_plan` computes from the tensor's shape and dtype alone: a thread block
cluster per channel, and whether the second sweep reads shared memory
("on_chip", for as much of the channel as fits) or the inputs again
("two_sweep").

x (and y, g, dx) is fp32 or bf16, each with its own instantiation of the
kernels; gamma, beta, the statistics, the running buffers, dgamma and
dbeta are fp32, and the arithmetic is fp32 either way
(``segment_pallas.py:103-211,300-367``).

Over R > 1 ranks (``--num-data-shards``) the statistics are the global
batch's, and no all-reduce fits inside one launch: :class:`_SplitSegment`
runs each direction as two launches of ``csrc/segment.cu`` around an
all-reduce of fp64 sums, K5-split (``split_stats``, ``split_apply``) and
K5-bwd-split (``split_bwd_reduce``, ``split_bwd_apply``), each with its
plain version in ``ops/math.py`` and its launch counter.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
versions, ``ops.math.segment_forward`` and the hand-written
``ops.math.segment_backward``. Unlike ``lvae_tpu``, which falls back to
plain XLA for channel counts its lanes cannot tile
(``segment_pallas.py:221-240``), the kernel takes every shape, so the
wrapper never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.ops.math import (
    SEGMENT_ACTS,
    bits8_dropout_f32,
    bits8_keep_threshold,
    math_dtype,
    segment_backward,
    segment_forward,
    segment_split_apply,
    segment_split_bwd_apply,
    segment_split_bwd_reduce,
    segment_split_stats,
)
from lvae_tpu_torch.ops.philox import ElementMap, Ints, dropout_bytes, mix_seed
from lvae_tpu_torch.parallel import mesh

SMS = 132                       # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232_448              # shared memory a CTA can have
SMEM_STATIC = 1024              # what the kernels declare statically, rounded up
SMS_SMEM = 233_472               # shared memory an SM holds for its CTAs (228 KB)
SMEM_BUDGET = 200 * 1024        # the dynamic shared memory a CTA's share may take
PART_BUDGET = 104 * 1024        # ... where only part fits: two CTAs per SM
KEEP_CHUNK = 2048               # csrc/segment.cu kChunk: keep words staged per step
MAX_ACCESSES = 4096             # 16-byte accesses per CTA that a cluster aims under
ONE_CTA = 2048                  # ... and a channel of at most this many takes one CTA
MAX_THREADS = 512               # csrc/segment.cu kMaxThreads
PATHS = ("on_chip", "two_sweep")


class Plan(NamedTuple):
    """One launch's shape (csrc/segment.cu ``SegPlan``)."""

    b: int
    hw: int
    c: int
    vec: int            # elements per unit (one Philox call): 16, 4 or 1
    cluster: int        # CTAs per channel, the cluster's size
    threads: int        # per CTA
    clusters: int       # the grid; cluster i takes channels i, i + clusters, ...
    chip: int           # units of a CTA's share kept in shared memory
    smem: int           # dynamic shared memory per CTA
    esize: int = 4      # bytes per element of x, y, g and dx: 4 (fp32) or 2 (bf16)

    @property
    def path(self) -> str:
        return PATHS[0] if self.chip == self.units else PATHS[1]

    @property
    def units(self) -> int:
        """Units of a CTA's share (the largest share)."""
        return -(-self.b * self.hw // self.vec // self.cluster)

    @property
    def channels_per_cta(self) -> int:
        return -(-self.c // self.clusters)

    @property
    def portable(self) -> bool:
        """A cluster of at most 8 CTAs; 16 needs the non-portable size."""
        return self.cluster <= 8


class _CPlan(ctypes.Structure):
    _fields_ = [("b", ctypes.c_int64), ("hw", ctypes.c_int64)] + [
        (k, ctypes.c_int) for k in ("c", "vec", "cluster", "threads", "clusters", "chip",
                                    "smem", "esize")]


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=None)
def _plan(b: int, c: int, h: int, w: int, direction: str, path: Optional[str] = None,
          esize: int = 4) -> Plan:
    """The kernel's launch for ``[b, c, h, w]`` in ``direction`` ("fwd" or
    "bwd") with ``esize`` bytes per element (4: fp32, 2: bf16), a function
    of the shape and the dtype alone (so the order of every sum, and its
    bits, is too). ``path`` forces "on_chip" (which needs ``h w % 4 ==
    0``) or "two_sweep"; by default on chip where it can be.

    A channel's ``b h w / vec`` units split into ``cluster`` contiguous
    shares, one per CTA: at most ``MAX_ACCESSES`` 16-byte accesses each,
    one CTA (no cluster barrier) up to ``ONE_CTA`` and two or more above,
    and on chip small enough that two CTAs fit on an SM (``PART_BUDGET``)
    where a cluster of 16 allows and the grid has more CTAs than SMs, unless
    a cluster of a half or a quarter the size puts every channel's cluster
    on the card at once (one wave) with its share on chip; one access per
    thread up to ``MAX_THREADS``, 8 where the grid has four CTAs per SM, 16
    (256 threads) where a cluster of 16's share leaves room for three CTAs
    an SM. An access is 16 bytes, ``16 / esize`` elements (8 in bf16; a
    bf16 unit of 4 is one 8-byte access). The share's layout is
    :func:`_layout`'s."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction must be 'fwd' or 'bwd', got {direction!r}")
    if path not in (None, *PATHS):
        raise ValueError(f"path must be one of {PATHS} or None, got {path!r}")
    if min(b, c, h, w) < 1 or b * h * w > 0x7FFFFFFF:
        raise ValueError(f"the segment kernels take [B, C, H, W] with B H W < 2^31, "
                         f"got {[b, c, h, w]}")
    if esize not in (4, 2):
        raise ValueError(f"esize must be 4 (fp32) or 2 (bf16), got {esize}")
    hw = h * w
    vec = split_unit(hw)
    units = b * hw // vec
    per_unit = _per_unit(direction, esize, vec)
    per_f = min(vec, 16 // esize)               # elements per access
    accesses = b * hw // per_f                  # per channel
    k = _pow2_at_least(-(-accesses // MAX_ACCESSES))
    if accesses > ONE_CTA:
        k = max(k, 2)
    def one_wave(k: int) -> bool:
        return c * k <= SMS and -(-units // k) * per_unit <= SMEM_BUDGET

    if vec > 1 and not one_wave(k):
        # the fewest rounds: one wave of larger shares where they fit on
        # chip (the channels' clusters all on the card at once), else on
        # chip two CTAs per SM where possible
        smaller = [k2 for k2 in (k // 2, k // 4) if k2 >= 2 and one_wave(k2)]
        k = smaller[0] if smaller else max(k, _pow2_at_least(-(-units * per_unit // PART_BUDGET)))
    k = min(16, k)
    stride = -(-units // k)
    mine = -(-stride * vec // per_f)            # accesses per CTA
    threads = min(MAX_THREADS, 32 * -(-mine // (32 * (8 if c * k >= 4 * SMS else 1))))
    if k == 16 and 3 * (stride * per_unit + SMEM_STATIC) <= SMS_SMEM:
        threads = min(threads, 256)             # three CTAs an SM, not two
    return _layout(b, c, hw, direction, path, esize, k, threads)


def _per_unit(direction: str, esize: int, vec: int) -> int:
    """Shared memory a unit kept on chip takes: x in the storage dtype, the
    backward's dz in fp32 beside it, and its keep word."""
    return (esize if direction == "fwd" else esize + 4) * vec + 4


def _layout(b: int, c: int, hw: int, direction: str, path: Optional[str], esize: int,
            cluster: int, threads: int) -> Plan:
    """The plan of ``cluster`` CTAs of ``threads`` a channel: which units of
    a CTA's share stay in shared memory. On chip, a CTA keeps x in its
    storage dtype (``esize`` B per element) and, backward, dz in fp32 (4 B
    more), and a keep word per unit (:func:`_per_unit`), all of it where that fits
    ``SMEM_BUDGET`` and either leaves room for a second CTA on the SM
    (``PART_BUDGET``) or the grid is one wave; else (celeba64's 64x64 maps,
    a cluster of 16 short of room for two CTAs) what fits beside a second
    CTA, the rest read twice from device memory (the second time likely
    from L2): two CTAs an SM and the rest read again outrun one CTA an SM
    with nothing read again (``segment_ab``). Forced "two_sweep" reads the
    whole share twice; the keep words of what is read twice are staged
    ``KEEP_CHUNK`` at a time. (The constants are fitted to an H100's
    timings at the models' shapes.)"""
    vec = split_unit(hw)
    units = b * hw // vec
    per_unit = _per_unit(direction, esize, vec)
    stride = -(-units // cluster)
    fits = vec > 1 and stride * per_unit <= SMEM_BUDGET
    roomy = c * cluster <= SMS or stride * per_unit <= PART_BUDGET
    if path == PATHS[0] and not fits:
        raise ValueError(f"{[b, c, hw]} {direction}: a CTA's share does not fit in shared "
                         f"memory, or H W % 4 != 0; only the two-sweep path takes it")
    if fits and (path == PATHS[0] or (path is None and roomy)):
        chip = stride
    elif vec > 1 and path is None:      # keep what fits beside a second CTA on the SM
        chip = min(stride, (PART_BUDGET - 4 * KEEP_CHUNK) // per_unit)
    else:
        chip = 0
    smem = chip * per_unit + 4 * min(stride - chip, KEEP_CHUNK)      # csrc smem_of
    return Plan(b, hw, c, vec, cluster, threads, c, chip, smem, esize)


def _c_struct(p: Plan) -> _CPlan:
    return _CPlan(p.b, p.hw, p.c, p.vec, p.cluster, p.threads, p.clusters, p.chip, p.smem,
                  p.esize)


@functools.lru_cache(maxsize=None)
def _c_plan(b: int, c: int, h: int, w: int, direction: str, path: Optional[str] = None,
            esize: int = 4):
    """(the plan as the C entry points take it, its address)."""
    cp = _c_struct(_plan(b, c, h, w, direction, path, esize))
    return cp, ctypes.addressof(cp)


def max_active_clusters(plan: Plan, direction: str, act: str = "elu") -> int:
    """``cudaOccupancyMaxActiveClusters`` of the kernel that ``plan``
    launches, on the current device."""
    cp = _c_struct(plan)
    out = ctypes.c_int(0)
    status = build.library().lvae_segment_max_clusters(
        ctypes.addressof(cp), ("fwd", "bwd").index(direction), SEGMENT_ACTS.index(act),
        ctypes.addressof(out))
    build.check(status, "segment occupancy")
    return out.value


def _checked(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, act: str) -> None:
    if act not in SEGMENT_ACTS:
        raise ValueError(f"unsupported fused-segment act {act!r}; choose from {SEGMENT_ACTS}")
    if x.dim() != 4:
        raise ValueError(f"x must be NCHW [B, C, H, W], got {tuple(x.shape)}")
    c = x.shape[1]
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the segment kernels run on cpu or cuda, got {x.device}")
    # CUDA: x fp32 or bf16, gamma and beta fp32; CPU: the plain versions
    # also take fp64 x, gamma and beta
    ok = (torch.float32, torch.bfloat16) + ((torch.float64,) if x.device.type == "cpu" else ())
    if x.dtype not in ok:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    want = math_dtype(x.dtype)
    for name, v in (("x", x), ("gamma", gamma), ("beta", beta)):
        if name != "x" and v.dtype != want:
            raise TypeError(f"{name} must be {want} for {x.dtype} x, got {v.dtype}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"gamma and beta must be [{c}], got {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")


class Key(NamedTuple):
    """A segment's dropout key: the train seed, the step (a 0-d int64
    tensor on the segment's device) and the dropout site. The mask's
    Philox key is ``mix_seed(seed, step, site)``."""

    seed: int
    step: torch.Tensor
    site: int


def _key(x: torch.Tensor, seed: int, step: Ints, site: int) -> Key:
    if isinstance(step, torch.Tensor):
        if step.dim() != 0 or step.dtype != torch.int64 or step.device != x.device:
            raise ValueError(f"step must be a 0-d int64 tensor on {x.device}, got "
                             f"{step.dtype} {tuple(step.shape)} on {step.device}")
    else:   # a host int: one copy to the device (not for a captured step)
        step = torch.tensor(int(step), dtype=torch.int64, device=x.device)
    return Key(int(seed), step, int(site))


def _plain_bytes(x: torch.Tensor, t: int, key: Key, emap: ElementMap = ElementMap()
                 ) -> Optional[torch.Tensor]:
    """The plain path's keyed dropout bytes (None where no mask applies),
    element ``e`` taking the byte of its global element under ``emap``
    (:class:`~lvae_tpu_torch.ops.philox.ElementMap`)."""
    if not 0 < t < 256:
        return None
    return dropout_bytes(x.shape, mix_seed(*key), x.device, emap)


_M64 = 2 ** 64 - 1


def _c_key(t: int, key: Optional[Key]) -> tuple:
    """The C entry points' (seed, site, step pointer): zeros and no
    pointer where no mask applies (the kernels then read no step)."""
    if key is None or not 0 < t < 256:
        return 0, 0, None
    return key.seed & _M64, key.site & _M64, key.step.data_ptr()


def _aligned(v: torch.Tensor) -> torch.Tensor:
    """``v``, or a copy where its data is not 16-byte aligned (a view at an
    offset): the kernels' units are 16-byte accesses."""
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _launch_fwd(x, gamma, beta, t, act, eps, key, running_mean, running_var, momentum,
                path=None):
    """K5 on a checked contiguous CUDA ``x``: ``(y, stats)``, stats the
    rows mean, var, r, scale, shift. ``path`` forces the plan's path."""
    b, c, h, w = x.shape
    _, plan = _c_plan(b, c, h, w, "fwd", path, build.esize(x.dtype))
    x = _aligned(x)
    y = torch.empty_like(x)
    stats = torch.empty((5, c), dtype=torch.float32, device=x.device)
    if running_mean is not None:
        for name, v in (("running_mean", running_mean), ("running_var", running_var)):
            if v.dtype != torch.float32 or v.shape != (c,) or v.get_device() != x.get_device():
                raise ValueError(f"{name} must be float32 [{c}] on {x.device}")
    status = build.on_device(x, lambda stream: build.library().lvae_segment_fwd(
        plan, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if running_mean is None else running_mean.data_ptr(),
        None if running_var is None else running_var.data_ptr(),
        y.data_ptr(), stats.data_ptr(), t, SEGMENT_ACTS.index(act), eps, momentum,
        1.0 - momentum, *_c_key(t, key), stream))
    build.LAUNCHES[build.launch_name("segment", x.dtype)] += 1
    build.check(status, "segment")
    return y, stats


def _launch_bwd(x, g, gamma, stats, t, act, key, path=None):
    """K5-bwd on checked contiguous CUDA tensors: ``(dx, dgamma, dbeta)``."""
    b, c, h, w = x.shape
    _, plan = _c_plan(b, c, h, w, "bwd", path, build.esize(x.dtype))
    x, g = _aligned(x), _aligned(g)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, c), dtype=torch.float32, device=x.device)      # dgamma, dbeta
    status = build.on_device(x, lambda stream: build.library().lvae_segment_bwd(
        plan, x.data_ptr(), g.data_ptr(), gamma.data_ptr(), stats.data_ptr(), dx.data_ptr(),
        dgb.data_ptr(), t, SEGMENT_ACTS.index(act), *_c_key(t, key), stream))
    build.LAUNCHES[build.launch_name("segment_bwd", x.dtype)] += 1
    build.check(status, "segment_bwd")
    return (dx, *dgb.unbind(0))


def _backward(x, g, gamma, beta, stats, t, act, key):
    if not x.is_cuda:
        return segment_backward(x, g, gamma, beta, stats[0], stats[2], t, act,
                                _plain_bytes(x, t, key))
    return _launch_bwd(x, g, gamma, stats, t, act, key)


def dropout_bn_act_backward(x: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, stats: torch.Tensor, t: int, act: str,
                            seed: int = 0, step: Ints = 0, site: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5-bwd: ``(dx, dgamma, dbeta)`` from the cotangent ``g`` of ``y``,
    given the forward's ``stats`` (rows mean, var, r, scale, shift) and its
    key (``seed``, ``step``, ``site``)."""
    _checked(x, gamma, beta, act)
    if g.dtype != x.dtype:
        raise TypeError(f"g must be {x.dtype} (like x), got {g.dtype}")
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must be {tuple(x.shape)} on {x.device}")
    key = _key(x, seed, step, site) if 0 < t < 256 else None
    return _backward(x, g.contiguous(), gamma, beta, stats, t, act, key)


class _Segment(torch.autograd.Function):
    """The segment with the hand-written backward: the kernels on CUDA,
    the plain versions on the CPU. Outputs y and the [5, C] statistics
    (mean, var, r, scale, shift); only y carries a gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, running_mean, running_var, t, act, eps, key, momentum):
        if not x.is_cuda:
            y, mean, var, r = segment_forward(x, gamma, beta, t, act, eps,
                                              _plain_bytes(x, t, key), running_mean,
                                              running_var, momentum)
            scale = gamma * r
            stats = torch.stack([mean, var, r, scale, beta - mean * scale])
        else:
            y, stats = _launch_fwd(x, gamma, beta, t, act, eps, key, running_mean,
                                   running_var, momentum)
        # the key's step tensor is read again by the backward, before the
        # train step moves it on
        ctx.t, ctx.act, ctx.key = t, act, key
        ctx.save_for_backward(x, gamma, beta, stats)
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _gstats):
        # x, gamma, beta were checked in the forward; g has y's shape
        x, gamma, beta, stats = ctx.saved_tensors
        dx, dgamma, dbeta = _backward(x, g.contiguous(), gamma, beta, stats, ctx.t, ctx.act,
                                      ctx.key)
        return dx, dgamma, dbeta, None, None, None, None, None, None, None


def _launch_dropout(x: torch.Tensor, t: int, key: Key, emap: ElementMap = ElementMap()
                    ) -> torch.Tensor:
    """The bits8 dropout kernel on a contiguous fp32 or bf16 CUDA ``x``,
    element ``e`` taking the byte of its global element under ``emap``."""
    y = torch.empty_like(x)
    if x.numel() == 0:      # a rank's empty band: nothing to launch
        return y
    status = build.on_device(x, lambda stream: build.library().lvae_dropout_bits8(
        x.data_ptr(), y.data_ptr(), x.numel(), build.esize(x.dtype), t, *_c_key(t, key),
        *emap, stream))
    build.LAUNCHES[build.launch_name("dropout", x.dtype)] += 1
    build.check(status, "dropout")
    return y


class _Dropout(torch.autograd.Function):
    """The bits8 dropout kernel; linear in x, so its backward is the same
    kernel on the cotangent, under the same key."""

    @staticmethod
    def forward(ctx, x, t, key, emap):
        ctx.t, ctx.key, ctx.emap = t, key, emap
        return _launch_dropout(x, t, key, emap)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _launch_dropout(g.contiguous(), ctx.t, ctx.key, ctx.emap), None, None, None


def dropout_bits8(x: torch.Tensor, rate: float, seed: int, step: Ints,
                  site: int, emap: ElementMap = ElementMap()) -> torch.Tensor:
    """bits8 dropout alone, under the segment's bytes: ``x`` where the
    byte of ``dropout_bytes(x.shape, mix_seed(seed, step, site))`` is below
    ``t = round(256 (1 - rate))``, scaled by ``256 / t`` in fp32 and cast
    back to ``x``'s dtype, else 0 (``x`` itself for ``t >= 256``, zeros for
    ``t <= 0``); ``step`` a 0-d int64 tensor on ``x``'s device, read there.
    A CUDA tensor (fp32 or bf16) launches the kernel (``csrc/segment.cu``
    ``dropout_kernel``, forward and backward) on a contiguous copy of
    ``x``; a CPU tensor takes the plain version. Element ``e`` takes the
    byte of its global element under ``emap`` (a rank's rows of the global
    batch, or its band of them: :func:`lvae_tpu_torch.parallel.mesh.
    element_map`)."""
    t = bits8_keep_threshold(rate)
    if t >= 256:      # rate below the 8-bit resolution: keep everything
        return x
    if t <= 0:        # rate ~ 1: drop everything
        return torch.zeros_like(x)
    key = _key(x, seed, step, site)
    if not x.is_cuda:
        return bits8_dropout_f32(x.to(math_dtype(x.dtype)), _plain_bytes(x, t, key, emap),
                                 t).to(x.dtype)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the dropout kernel takes float32 or bfloat16, got {x.dtype}")
    return _Dropout.apply(x.contiguous(), t, key, emap)


def dropout_bn_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                   rate: float = 0.0, act: str = "elu", eps: float = 1e-5, seed: int = 0,
                   step: Ints = 0, site: int = 0, running_mean: Optional[torch.Tensor] = None,
                   running_var: Optional[torch.Tensor] = None, momentum: float = 0.9
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: the train-mode segment ``y = act(BatchNorm(drop(x)))`` of the
    NCHW map ``x``, differentiable in x, gamma and beta. Returns ``(y,
    batch_mean, batch_var)``, the variance biased; given the running
    buffers, it moves them (momentum ``momentum``, flax's rule).

    ``rate`` takes bits8 dropout's semantics (keep iff the element's byte
    is below ``t = round(256 (1 - rate))``, survivors scaled by ``256 /
    t``; ``t >= 256`` is no mask, ``t <= 0`` drops everything, so ``y =
    act(beta)`` with zero statistics). The bytes are keyed by
    ``mix_seed(seed, step, site)``: ``seed`` the train seed, ``step`` a 0-d
    int64 tensor on ``x``'s device (the kernels read it there; an int is
    copied to the device first), ``site`` the dropout site. A strided
    ``x`` (a cropped transposed conv's output) is copied to a contiguous
    one first.

    ``x`` is this rank's part of the global batch: where the layout
    (:func:`lvae_tpu_torch.parallel.mesh.current`) has more than one rank,
    the statistics are the global batch's and the segment runs split,
    K5-split and K5-bwd-split (:class:`_SplitSegment`); on one rank K5 and
    K5-bwd, one launch a direction."""
    x = x.contiguous()
    _checked(x, gamma, beta, act)
    t = bits8_keep_threshold(rate)
    key = _key(x, seed, step, site) if 0 < t < 256 else None
    layout = mesh.current()
    if layout.sharded:
        y, stats = _SplitSegment.apply(x, gamma, beta, running_mean, running_var, t, act, eps,
                                       key, momentum, layout)
    else:
        y, stats = _Segment.apply(x, gamma, beta, running_mean, running_var, t, act, eps,
                                  key, momentum)
    mean, var, *_ = stats.unbind(0)
    return y, mean, var


# ---------------------------------------------------------------------------
# the segment over R > 1 ranks: K5-split and K5-bwd-split
# ---------------------------------------------------------------------------

SPLIT_MAX_THREADS = 256         # csrc/segment.cu kSplitMaxThreads
SPLIT_TILE = 32                 # units a warp takes at a time: a lane's draws
SPLIT_CTAS_PER_SM = 2           # blocks of a one-wave grid on each SM
SPLIT_TILES_PER_WARP = 4        # tiles a warp of a slice takes at most, past one wave
SPLIT_MAX_SLICES = 64
SPLIT_LAUNCHES = ("segment_split_stats", "segment_split_apply", "segment_split_bwd_reduce",
                  "segment_split_bwd_apply")


class SplitPlan(NamedTuple):
    """The split launches' grid (``csrc/segment.cu`` ``lvae_segment_split``):
    a block of ``threads`` per (slice, channel), a channel's units cut into
    ``slices`` contiguous slices."""

    slices: int
    threads: int


def split_unit(hw: int) -> int:
    """Elements of a unit (one Philox call) of a strip of ``hw``: 16, 4 or
    1, as K5's (``csrc/segment.cu`` ``split_vec``)."""
    return 16 if hw % 16 == 0 else 4 if hw % 4 == 0 else 1


@functools.lru_cache(maxsize=None)
def split_plan(b: int, c: int, h: int, w: int) -> SplitPlan:
    """The split launches' plan for a rank whose longest band of rows (its
    whole rows where the height is not sharded) is ``[b, c, h, w]``, in
    fp32 or bf16 alike: a function of that shape alone, so every rank's
    ``[2, S, C]`` sums have one shape and the all-reduce between the
    launches is the same on each. A channel's units (:func:`split_unit`)
    are cut into tiles of ``SPLIT_TILE``, a warp's at a time, and the
    tiles into ``S`` slices: a
    wave of ``SPLIT_CTAS_PER_SM`` blocks an SM (4 slices of 64 channels on
    an H100), or more where a warp would take more than
    ``SPLIT_TILES_PER_WARP`` tiles (16 at [64, 64, 64, 64]), but no more
    than give each of a block's 8 warps one tile, and at most
    ``SPLIT_MAX_SLICES``; a slice of fewer tiles takes fewer warps. The
    plan sets the order of the fp64 sums, and so the last bits of every
    output. (Fitted to an H100's timings at the models' shapes, in both
    dtypes: ``python -m lvae_tpu_torch.segment_ab``.)"""
    if min(b, c, h, w) < 0 or min(b, c) < 1 or b * h * w > 0x7FFFFFFF:
        raise ValueError(f"the split launches take [B, C, H, W] with B, C >= 1 and "
                         f"B H W < 2^31, got {[b, c, h, w]}")
    hw = h * w
    tiles = -(-(b * hw // split_unit(hw)) // SPLIT_TILE)
    warps = SPLIT_MAX_THREADS // 32
    wave = max(SPLIT_CTAS_PER_SM * SMS // c, -(-tiles // (warps * SPLIT_TILES_PER_WARP)))
    slices = max(1, min(SPLIT_MAX_SLICES, -(-tiles // warps), wave))
    return SplitPlan(slices, 32 * max(1, min(warps, -(-tiles // slices))))


def split_plan_of(x: torch.Tensor) -> SplitPlan:
    """The plan of this rank's ``x`` under the height sharding in force
    (:func:`lvae_tpu_torch.parallel.mesh.current_bands`): that of the
    longest band, ``ceil(H / count)`` rows of ``x``'s global height (its
    own rows without one), the same on every rank."""
    b, c, hb, w = x.shape
    bands = mesh.current_bands()
    return split_plan(b, c, -(-bands.height(x) // bands.count) if bands is not None else hb, w)


def _launch_split(which: int, x: torch.Tensor, t: int, act: str, key: Optional[Key],
                  emap: ElementMap, plan: SplitPlan, *, g=None, gamma=None, beta=None,
                  part=None, local=None, out_part=None, running_mean=None, running_var=None,
                  stats=None, y=None, dgb=None, n_global: int = 1, eps: float = 1e-5,
                  momentum: float = 0.9) -> None:
    """One launch of ``csrc/segment.cu`` ``lvae_segment_split`` (``which``:
    0 stats, 1 apply, 2 bwd_reduce, 3 bwd_apply) with ``plan`` on checked
    contiguous, 16-byte aligned CUDA tensors; NULL for what it does not read
    or write."""
    b, c, h, w = x.shape
    ptr = lambda v: None if v is None else v.data_ptr()    # noqa: E731
    status = build.on_device(x, lambda stream: build.library().lvae_segment_split(
        which, x.data_ptr(), ptr(g), ptr(gamma), ptr(beta), ptr(part), ptr(local),
        ptr(out_part), ptr(running_mean), ptr(running_var), ptr(stats), ptr(y), ptr(dgb),
        b, c, h * w, plan.slices, plan.threads, build.esize(x.dtype), t,
        SEGMENT_ACTS.index(act), float(n_global), eps, momentum, 1.0 - momentum,
        *_c_key(t, key), *emap, stream))
    name = SPLIT_LAUNCHES[which]
    build.LAUNCHES[build.launch_name(name, x.dtype)] += 1
    build.check(status, name)


def _sums_plan(part: torch.Tensor, x: torch.Tensor) -> SplitPlan:
    """The apply launches' plan: the sums' slices (every one is read), the
    threads of ``x``'s own plan (they set no bits of the result)."""
    return SplitPlan(part.shape[1], split_plan_of(x).threads)


def split_stats(x: torch.Tensor, t: int, key: Optional[Key], emap: ElementMap,
                plan: Optional[SplitPlan] = None) -> torch.Tensor:
    """K5-split's first launch: this rank's ``[2, S, C]`` fp64 sums of
    ``u`` and ``u^2`` (the plain version's ``S`` is 1). ``plan`` (by
    default :func:`split_plan_of` ``x``) must be every rank's alike: their
    sums are all-reduced."""
    if not x.is_cuda:
        return segment_split_stats(x, t, _plain_bytes(x, t, key, emap))
    plan = plan or split_plan_of(x)
    part = torch.empty((2, plan.slices, x.shape[1]), dtype=torch.float64, device=x.device)
    _launch_split(0, _aligned(x), t, "elu", key, emap, plan, out_part=part)
    return part


def split_apply(x, gamma, beta, part, n_global, t, act, eps, key, emap, running_mean,
                running_var, momentum) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5-split's second launch: ``(y, stats)`` from the global sums."""
    if not x.is_cuda:
        return segment_split_apply(x, gamma, beta, part, n_global, t, act, eps,
                                   _plain_bytes(x, t, key, emap), running_mean, running_var,
                                   momentum)
    if running_mean is not None:
        c = x.shape[1]
        for name, v in (("running_mean", running_mean), ("running_var", running_var)):
            if v.dtype != torch.float32 or v.shape != (c,) or v.get_device() != x.get_device():
                raise ValueError(f"{name} must be float32 [{c}] on {x.device}")
    x = _aligned(x)
    y = torch.empty_like(x)
    stats = torch.empty((5, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch_split(1, x, t, act, key, emap, _sums_plan(part, x), gamma=gamma, beta=beta,
                  part=part, running_mean=running_mean, running_var=running_var, stats=stats,
                  y=y, n_global=n_global, eps=eps, momentum=momentum)
    return y, stats


def split_bwd_reduce(x, g, stats, t, act, key, emap, plan: Optional[SplitPlan] = None
                     ) -> torch.Tensor:
    """K5-bwd-split's first launch: this rank's ``[2, S, C]`` fp64 sums of
    ``dz`` and ``dz xhat`` (``plan`` as :func:`split_stats`')."""
    if not x.is_cuda:
        return segment_split_bwd_reduce(x, g, stats, t, act, _plain_bytes(x, t, key, emap))
    plan = plan or split_plan_of(x)
    part = torch.empty((2, plan.slices, x.shape[1]), dtype=torch.float64, device=x.device)
    _launch_split(2, _aligned(x), t, act, key, emap, plan, g=_aligned(g), stats=stats,
                  out_part=part)
    return part


def split_bwd_apply(x, g, gamma, stats, local, part, n_global, t, act, key, emap
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5-bwd-split's second launch: ``(dx, dgamma, dbeta)``, dx from the
    global sums ``part``, dgamma and dbeta this rank's sums ``local``."""
    if not x.is_cuda:
        return segment_split_bwd_apply(x, g, gamma, stats, local, part, n_global, t, act,
                                       _plain_bytes(x, t, key, emap))
    x = _aligned(x)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch_split(3, x, t, act, key, emap, _sums_plan(part, x), g=_aligned(g), gamma=gamma,
                  part=part, local=local, stats=stats, y=dx, dgb=dgb, n_global=n_global)
    return (dx, *dgb.unbind(0))


class _SplitSegment(torch.autograd.Function):
    """The segment over ``layout.size`` ranks, ``x`` this rank's rows (and,
    under ``--spatial-shards``, its band of them): forward K5-split (this
    rank's sums, their all-reduce, y from the global ones), backward
    K5-bwd-split (the same for ``dz`` and ``dz xhat``), with the global
    batch's statistics, the dropout bytes of the global elements, and
    dgamma and dbeta this rank's part (the train step sums the gradients
    over the ranks). Every rank takes the plan of the longest band
    (:func:`split_plan_of`), so the sums all-reduce at one shape; an empty
    band adds zeros. The plain versions on the CPU, where the all-reduce
    runs over gloo."""

    @staticmethod
    def forward(ctx, x, gamma, beta, running_mean, running_var, t, act, eps, key, momentum,
                layout):
        b, _, hb, w = x.shape
        emap = mesh.element_map(x, layout)
        bands = mesh.current_bands()
        n_global = b * layout.n_data * (bands.height(x) if bands is not None else hb) * w
        plan = split_plan_of(x)       # the backward runs outside the bands' context
        part = mesh.all_reduce_(split_stats(x, t, key, emap, plan), layout)
        y, stats = split_apply(x, gamma, beta, part, n_global, t, act, eps, key, emap,
                               running_mean, running_var, momentum)
        ctx.t, ctx.act, ctx.key, ctx.emap, ctx.n_global = t, act, key, emap, n_global
        ctx.plan, ctx.layout = plan, layout
        ctx.save_for_backward(x, gamma, stats)
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _gstats):
        x, gamma, stats = ctx.saved_tensors
        g = g.contiguous()
        local = split_bwd_reduce(x, g, stats, ctx.t, ctx.act, ctx.key, ctx.emap, ctx.plan)
        part = mesh.all_reduce_(local.clone(), ctx.layout)
        dx, dgamma, dbeta = split_bwd_apply(x, g, gamma, stats, local, part, ctx.n_global,
                                            ctx.t, ctx.act, ctx.key, ctx.emap)
        return dx, dgamma, dbeta, None, None, None, None, None, None, None, None
