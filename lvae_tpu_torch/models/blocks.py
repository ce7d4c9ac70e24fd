"""Deterministic building blocks (port of ``lvae_tpu/models/blocks.py``).

NCHW inside; convolutions and BatchNorm go to cuDNN. Submodules carry the
flax names (``Conv_0``, ``BatchNorm_1``, ``GateLayer_0``,
``ResidualBlock_0``, ``ConvTranspose_0``) so ``state_dict()`` keys equal
``lvae_tpu.train.convert.torch_key_for`` of the flax paths.

Every block takes ``train``, as ``lvae_tpu``'s do. Eval: BatchNorm
normalises with its running statistics and dropout is the identity.
Train: BatchNorm normalises with the batch mean and biased variance and
moves its running statistics as flax does (momentum 0.9, biased
variance); dropout draws its mask from the Philox stream keyed by (train
seed, step, dropout site) (:class:`DropoutKey`), so a step's masks are a
function of the step alone. ``bn_stat_samples > 0`` takes the training
statistics from the batch's leading rows (``SubsampledBatchNorm``), and
``fused_segments`` runs each ``[d] b a`` run of a residual branch as one
:class:`FusedBNActSegment` (the kernels K5 and K5-bwd) in training.
``remat`` (``--remat``) runs a :class:`ResBlockWithResampling` under
``torch.utils.checkpoint``: its activations are dropped after the forward
and recomputed in the backward, which moves no running statistic a second
time (:func:`recomputing`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lvae_tpu_torch.kernels.segment import dropout_bits8, dropout_bn_act
from lvae_tpu_torch.ops.math import SEGMENT_ACTS
from lvae_tpu_torch.ops.philox import STREAM_FLOAT_DROPOUT, keyed_uniform, mix_seed

NONLINEARITIES: dict[str, Callable] = {
    "relu": F.relu,
    "leakyrelu": F.leaky_relu,          # slope 0.01, as flax
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "silu": F.silu,
}


def get_nonlin(name: str) -> Callable:
    try:
        return NONLINEARITIES[name]
    except KeyError:
        raise ValueError(
            f"unknown nonlinearity {name!r}; choose from {sorted(NONLINEARITIES)}"
        ) from None


def conv_padding(conv_pad: str, k: int, stride: int = 1,
                 size: Tuple[int, int] = (0, 0)) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) padding of a k x k convolution over an
    input of spatial ``size``.

    ``'same'``: flax/XLA SAME, total = max((ceil(n/s) - 1) s + k - n, 0)
    split low = total // 2, high = the rest (asymmetric at stride 2 on
    even inputs). ``'torch'``: symmetric k // 2 on every side.
    """
    if conv_pad == "torch":
        p = k // 2
        return p, p, p, p
    if conv_pad != "same":
        raise ValueError(f"unknown conv_pad {conv_pad!r}; use 'same' or 'torch'")
    pads = []
    for n in size:
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


class _ComputeDtype:
    """flax's ``nn.Conv(dtype=...)``: ``compute_dtype`` (None: the
    parameters' own) is the dtype the convolution computes and returns in.
    ``forward`` casts the input, the weight and the bias to it, so the
    parameters stay fp32 and their gradients come back fp32 through the
    casts; nothing is cached across calls, so an optimiser's in-place
    update (and a CUDA graph of the step) always reads the current weight.
    The bias is added after the convolution, in the compute dtype, as
    flax adds it (``y = conv(x, w); y += b``): the convolution's output is
    rounded once, then the sum. :func:`set_compute_dtype` sets it on every
    conv of a model."""

    compute_dtype: Optional[torch.dtype] = None

    def _conv(self, conv: Callable, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        """``conv(x, weight, bias, *args)`` in the compute dtype."""
        cd = self.compute_dtype or self.weight.dtype
        # no cast where there is nothing to cast: a traced graph
        # (torch.export) keeps every cast, even one to the same dtype
        if x.dtype != cd:
            x = x.to(cd)
        if cd == self.weight.dtype:
            return conv(x, self.weight, self.bias, *args, **kwargs)
        y = conv(x, self.weight.to(cd), None, *args, **kwargs)
        return y + self.bias.to(cd).view(1, -1, 1, 1)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Every conv of ``module`` computes in ``dtype`` (None: fp32, the
    parameters' dtype)."""
    for m in module.modules():
        if isinstance(m, _ComputeDtype):
            m.compute_dtype = dtype


class Conv2d(_ComputeDtype, nn.Conv2d):
    """``nn.Conv2d`` with ``lvae_tpu``'s padding conventions and a compute
    dtype. Parameters start at zero; :func:`init_parameters` draws them
    from an explicit generator (``init_std`` overrides the lecun-normal
    scale)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 conv_pad: str = "same", init_std: float | None = None):
        super().__init__(cin, cout, k, stride=stride, padding=0)
        self.conv_pad = conv_pad
        self.init_std = init_std

    def reset_parameters(self) -> None:  # no draw from torch's global RNG
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom, left, right = conv_padding(
            self.conv_pad, k, s, (x.shape[-2], x.shape[-1])
        )
        if top == bottom and left == right:
            return self._conv(F.conv2d, x, s, (top, left))
        return self._conv(F.conv2d, F.pad(x, (left, right, top, bottom)), s)


class ConvTranspose2d(_ComputeDtype, nn.ConvTranspose2d):
    """2x upsampling transposed conv (weight ``[in, out, k, k]``), with a
    compute dtype.

    ``'same'``: flax ``ConvTranspose(strides=2)`` SAME == the full
    transposed conv sliced to its top-left 2H x 2W (exact for k=3, s=2,
    the one shape the model uses). ``'torch'``: the reference's
    ``ConvTranspose2d(padding=k//2, output_padding=1)``.
    """

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 2,
                 conv_pad: str = "same"):
        super().__init__(cin, cout, k, stride=stride)
        self.conv_pad = conv_pad
        self.init_std = None

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        if self.conv_pad == "torch":
            return self.full(x, padding=k // 2, output_padding=s - 1)
        if self.conv_pad != "same":
            raise ValueError(f"unknown conv_pad {self.conv_pad!r}")
        h, w = x.shape[-2], x.shape[-1]
        return self.full(x)[:, :, : s * h, : s * w]

    def full(self, x: torch.Tensor, **pads) -> torch.Tensor:
        """The transposed conv, uncropped (the 'torch' convention's
        ``pads`` given), in the compute dtype."""
        return self._conv(F.conv_transpose2d, x, self.stride[0], **pads)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv kernel from ``generator``: normal with std
    1/sqrt(fan_in) (lecun-normal scale, flax's default), or the conv's
    ``init_std`` (the 1e-2 Gaussian heads). Biases, BatchNorm and the top
    prior keep their zero/one starts."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            w = m.weight
            fan_in = (w.shape[0] if isinstance(m, ConvTranspose2d) else w.shape[1])
            fan_in *= w.shape[2] * w.shape[3]
            std = m.init_std if m.init_std is not None else 1.0 / math.sqrt(fan_in)
            w.copy_(torch.randn(w.shape, generator=generator) * std)


class _Recompute:
    """How many rematerialised blocks are being recomputed (``--remat``).
    A plain counter, not a thread-local: autograd may run the recompute
    on its own thread, while the forward's thread waits in ``backward``."""

    depth = 0


def recomputing() -> bool:
    """Whether a rematerialised block's forward is being recomputed in
    the backward: the running statistics were moved by the forward
    already, once, as ``flax.linen.remat`` moves ``batch_stats`` once."""
    return _Recompute.depth > 0


@contextlib.contextmanager
def _recompute(key: Optional["DropoutKey"], seed: int, step: Optional[torch.Tensor]):
    """The recompute of a block: the dropout key set back to what the
    forward read (the same step tensor), :func:`recomputing` true."""
    _Recompute.depth += 1
    saved = None if key is None else (key.seed, key.step)
    if key is not None:
        key.seed, key.step = seed, step
    try:
        yield
    finally:
        if key is not None:
            key.seed, key.step = saved
        _Recompute.depth -= 1


def batch_norm_eval(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the running statistics, whatever ``bn.training``; a
    bf16 ``x`` is normalised in fp32 and the result cast back, as flax's
    ``_normalize`` does."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


def batch_norm_train(bn: nn.BatchNorm2d, x: torch.Tensor,
                     momentum: float = 0.9) -> torch.Tensor:
    """flax's ``nn.BatchNorm(use_running_average=False, momentum=0.9)``:
    normalise with the batch mean and *biased* variance (gradients flow
    through both), then ``ra = m * ra + (1 - m) * batch`` with the biased
    variance. ``nn.BatchNorm2d``'s own update would store the unbiased
    one, so its running buffers are only read here: the one BatchNorm
    kernel writes the batch statistics into fresh buffers (momentum 1),
    and the running statistics are moved from those. The batch statistics
    are in the running buffers' dtype (fp32 for a bf16 ``x``: flax reduces
    in fp32, normalises in fp32 and casts ``y`` back to ``x``'s dtype, as
    the mixed-dtype kernel does)."""
    c = x.shape[1]
    mean = torch.zeros(c, dtype=bn.running_mean.dtype, device=x.device)
    var = torch.ones(c, dtype=bn.running_var.dtype, device=x.device)
    y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True, 1.0, bn.eps)
    if recomputing():
        return y
    n = x.numel() // c
    with torch.no_grad():
        biased = var * ((n - 1) / n)       # the kernel stored n/(n-1) x it
        bn.running_mean.copy_(momentum * bn.running_mean + (1.0 - momentum) * mean)
        bn.running_var.copy_(momentum * bn.running_var + (1.0 - momentum) * biased)
    return y


def subsampled_batch_norm_train(bn: nn.BatchNorm2d, x: torch.Tensor, stat_samples: int,
                                momentum: float = 0.9) -> torch.Tensor:
    """``lvae_tpu``'s ``SubsampledBatchNorm`` in training
    (``lvae_tpu/models/blocks.py:209-290``): the mean and biased variance
    of the contiguous leading ``n = min(stat_samples, B)`` rows, in fp32,
    the variance clamped at 0; the whole batch normalised with them (the
    gradient reaches the statistics through those rows only); the running
    statistics moved as flax moves them."""
    n = max(1, min(stat_samples, x.shape[0]))
    xs = x[:n].float()
    mean = xs.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xs * xs).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    with torch.no_grad():
        if not recomputing():
            bn.running_mean.copy_(momentum * bn.running_mean + (1.0 - momentum) * mean)
            bn.running_var.copy_(momentum * bn.running_var + (1.0 - momentum) * var)
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    shift = bn.bias - mean * inv
    return (x.float() * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)).to(x.dtype)


class DropoutKey:
    """The dropout keys of one model: every :class:`Dropout` of the model
    holds this one object and its own site number, and draws its mask
    under the Philox key ``mix_seed(seed, step, site)``. The model sets
    ``seed`` (the train seed, a host int) and ``step`` (a 0-d int64 tensor
    on the device) before a training forward; the key is derived from the
    step where it lies (in the kernels, for bits8), so no host int changes
    from step to step: a CUDA graph of the forward replays with the step
    it reads."""

    def __init__(self):
        self.seed = 0
        self.step = torch.zeros((), dtype=torch.int64)


class Dropout(nn.Module):
    """``lvae_tpu``'s dropout: ``bits8`` keeps an element iff its random
    byte is below ``t = round(256 (1 - rate))`` and scales survivors by
    ``256 / t`` in fp32, cast back to ``x``'s dtype (``FastDropout``);
    ``float`` is plain dropout at the exact rate in ``x``'s dtype
    (``nn.Dropout``). The identity outside training.

    The randomness is keyed by (train seed, step, site): ``bits8`` takes
    the bytes that the fused segment K5 takes (``dropout_bytes``), so the
    unfused and fused paths drop the same elements, through K5's dropout
    kernel on CUDA (``kernels.segment.dropout_bits8``); ``float`` keeps an
    element iff its keyed uniform in (0, 1] is at most ``1 - rate``
    (``keyed_uniform`` on its own stream, row ``i`` of a ``[B, ...]``
    input keyed by ``i``: plain PyTorch, ~270 small ops a call). Both
    differ from ``lvae_tpu``'s threefry bits, as any generator would."""

    def __init__(self, rate: float, impl: str = "bits8"):
        super().__init__()
        if impl not in ("bits8", "float"):
            raise ValueError(f"unknown dropout_impl {impl!r}; use 'bits8' or 'float'")
        self.rate, self.impl = rate, impl
        self.site = 0
        self.key = DropoutKey()   # the model replaces it with its shared one

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        step = self.key.step.to(x.device)
        if self.impl == "bits8":
            return dropout_bits8(x, self.rate, self.key.seed, step, self.site)
        keep = 1.0 - self.rate
        index = torch.arange(x.shape[0], device=x.device)
        u = keyed_uniform(x.shape, mix_seed(self.key.seed, step, self.site), index, 0,
                          STREAM_FLOAT_DROPOUT)
        return torch.where(u <= keep, x / keep, 0.0)


class FusedBNActSegment:
    """``[dropout ->] BatchNorm -> activation`` of a residual branch as one
    unit in training: K5 forward and K5-bwd backward
    (:func:`lvae_tpu_torch.kernels.segment.dropout_bn_act`; the plain
    versions for a CPU tensor), the port of ``lvae_tpu``'s
    ``FusedBNActSegment`` (``lvae_tpu/models/blocks.py:132-206``).

    Not a module: it reads ``BatchNorm_n``'s weight, bias and running
    buffers in place (the kernel's finalise moves the buffers: momentum
    0.9, biased variance), so ``state_dict()`` keys are the same under
    every ``--fused`` value and checkpoints interoperate. The mask is keyed
    by the absorbed ``Dropout_n``'s site, as that dropout keys its own, so
    the fused and the unfused ops drop the same elements; the kernels read
    the step from the key's device tensor. As in ``lvae_tpu``, the segment
    computes in fp32 whatever the input's dtype and returns ``y`` in it: a
    bf16 ``x`` goes to the kernels' bf16 instantiation as it is and comes
    back bf16, with no copy either way."""

    def __init__(self, bn: nn.BatchNorm2d, act: str, dropout: "Dropout | None" = None):
        self.bn, self.act, self.dropout = bn, act, dropout

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        bn, drop = self.bn, self.dropout
        rate = drop.rate if drop is not None else 0.0
        key = dict(seed=drop.key.seed, step=drop.key.step, site=drop.site) if rate > 0.0 else {}
        # fp32 and bf16 storage go to the kernels as they are; fp64 (the CPU
        # tests' parity runs) computes in fp32, as lvae_tpu's segment does
        xs = x if x.dtype == torch.bfloat16 else x.float()
        # a recompute (--remat) leaves the running buffers as the forward
        # moved them: K5 without buffers writes none
        running = {} if recomputing() else dict(running_mean=bn.running_mean,
                                                 running_var=bn.running_var)
        y, _, _ = dropout_bn_act(
            xs, bn.weight.float(), bn.bias.float(), rate=rate, act=self.act, eps=bn.eps,
            **running, **key)
        return y.to(x.dtype)


class GateLayer(nn.Module):
    """a * sigmoid(b) from a 1x1 conv to 2x the channels, in the conv's
    compute dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.Conv_0 = Conv2d(channels, 2 * channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = torch.chunk(self.Conv_0(x), 2, dim=1)
        if a.dtype == torch.bfloat16:
            # lvae_tpu's sigmoid in bf16: jax.nn.sigmoid lowers to
            # 1 / (1 + exp(-b)) with each op rounded to bf16, where
            # torch.sigmoid rounds once; on a third of the elements the two
            # differ by an ulp
            return a * torch.reciprocal(1.0 + torch.exp(-b))
        return a * torch.sigmoid(b)


class ResidualBlock(nn.Module):
    """Residual block whose branch is spelled by ``block_type``: ``b``
    BatchNorm, ``a`` activation, ``c`` 3x3 conv, ``d`` dropout (the
    identity in eval); an optional GateLayer ends the branch.

    With ``fused_segments``, training runs every ``[d] b a`` run as one
    :class:`FusedBNActSegment`. That needs BatchNorm on full-batch
    statistics (``bn_stat_samples == 0``), ELU or ReLU and bits8 dropout;
    anything else keeps the unfused ops, silently, as ``lvae_tpu`` does
    (``lvae_tpu/models/blocks.py:321-357``). Eval is the same either way."""

    def __init__(self, channels: int, block_type: str = "bacdbacd",
                 kernel_size: int = 3, nonlin: str = "elu",
                 batchnorm: bool = True, gated: bool = False,
                 conv_pad: str = "same", dropout_rate: float = 0.0,
                 dropout_impl: str = "bits8", bn_stat_samples: int = 0,
                 fused_segments: bool = False):
        super().__init__()
        self.block_type = block_type
        self.act = get_nonlin(nonlin)
        self.batchnorm = batchnorm
        self.bn_stat_samples = bn_stat_samples
        self.fused_segments = fused_segments
        nb = nc = nd = 0
        for ch in block_type:
            if ch == "b" and batchnorm:
                self.add_module(f"BatchNorm_{nb}", nn.BatchNorm2d(channels, eps=1e-5))
                nb += 1
            elif ch == "c":
                self.add_module(
                    f"Conv_{nc}",
                    Conv2d(channels, channels, kernel_size, conv_pad=conv_pad),
                )
                nc += 1
            elif ch == "d":
                self.add_module(f"Dropout_{nd}", Dropout(dropout_rate, dropout_impl))
                nd += 1
            elif ch not in "abcd":
                raise ValueError(f"unknown block_type char {ch!r} in {block_type!r}")
        self.GateLayer_0 = GateLayer(channels) if gated else None
        # position in block_type -> (length, segment) of each [d] b a run
        self._segments: dict[int, tuple[int, FusedBNActSegment]] = {}
        if (batchnorm and bn_stat_samples == 0 and nonlin in SEGMENT_ACTS
                and dropout_impl == "bits8"):
            nb = nd = i = 0
            while i < len(block_type):
                run = (3 if block_type.startswith("dba", i)
                       else 2 if block_type.startswith("ba", i) else 0)
                if run:
                    drop = getattr(self, f"Dropout_{nd}") if run == 3 else None
                    self._segments[i] = (run, FusedBNActSegment(
                        getattr(self, f"BatchNorm_{nb}"), nonlin, drop))
                    nb, nd, i = nb + 1, nd + (run == 3), i + run
                else:
                    nb, nd, i = nb + (block_type[i] == "b"), nd + (block_type[i] == "d"), i + 1

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        segments = self._segments if train and self.fused_segments else {}
        h = x
        nb = nc = nd = i = 0
        while i < len(self.block_type):
            if i in segments:
                run, seg = segments[i]
                h = seg(h)
                nb, nd, i = nb + 1, nd + (run == 3), i + run
                continue
            ch = self.block_type[i]
            if ch == "b" and self.batchnorm:
                bn = getattr(self, f"BatchNorm_{nb}")
                if not train:
                    h = batch_norm_eval(bn, h)
                elif self.bn_stat_samples > 0:
                    h = subsampled_batch_norm_train(bn, h, self.bn_stat_samples)
                else:
                    h = batch_norm_train(bn, h)
                nb += 1
            elif ch == "a":
                h = self.act(h)
            elif ch == "c":
                h = getattr(self, f"Conv_{nc}")(h)
                nc += 1
            elif ch == "d":
                h = getattr(self, f"Dropout_{nd}")(h, train)
                nd += 1
            i += 1
        if self.GateLayer_0 is not None:
            h = self.GateLayer_0(h)
        return x + (h if h.dtype == x.dtype else h.to(x.dtype))


class ResBlockWithResampling(nn.Module):
    """Optional 2x resample, or a 1x1 channel projection, then a
    ResidualBlock. ``resample_mode='conv'``: a stride-2 conv bottom-up, a
    stride-2 transposed conv top-down; ``'interpolate'``: nearest 2x
    resize then a 1x1 conv.

    ``remat`` (set by the model, ``--remat``): a training forward with
    gradients runs under ``torch.utils.checkpoint`` (non-reentrant), as
    ``lvae_tpu`` wraps the block in ``nn.remat``. The recompute reads the
    dropout key the forward read and moves no running statistic; K5's
    saved statistics are dropped and recomputed, bit-equal because K5 is
    deterministic (a fixed reduction tree, no atomics)."""

    remat = False

    def __init__(self, mode: str, cin: int, channels: int,
                 resample: bool = False, resample_mode: str = "conv",
                 block_type: str = "bacdbacd", kernel_size: int = 3,
                 nonlin: str = "elu", batchnorm: bool = True,
                 gated: bool = False, conv_pad: str = "same",
                 dropout_rate: float = 0.0, dropout_impl: str = "bits8",
                 bn_stat_samples: int = 0, fused_segments: bool = False):
        super().__init__()
        if mode not in ("bottom-up", "top-down"):
            raise ValueError(f"unknown mode {mode!r}")
        if resample_mode not in ("conv", "interpolate"):
            raise ValueError(f"unknown resample_mode {resample_mode!r}")
        self.mode, self.resample, self.resample_mode = mode, resample, resample_mode
        self.ConvTranspose_0 = None
        self.Conv_0 = None
        if resample and resample_mode == "interpolate":
            self.Conv_0 = Conv2d(cin, channels, 1)
        elif resample and mode == "bottom-up":
            self.Conv_0 = Conv2d(cin, channels, kernel_size, stride=2,
                                 conv_pad=conv_pad)
        elif resample:
            self.ConvTranspose_0 = ConvTranspose2d(cin, channels, kernel_size,
                                                   2, conv_pad=conv_pad)
        elif cin != channels:
            self.Conv_0 = Conv2d(cin, channels, 1)
        self.ResidualBlock_0 = ResidualBlock(
            channels, block_type, kernel_size, nonlin, batchnorm, gated, conv_pad,
            dropout_rate, dropout_impl, bn_stat_samples, fused_segments,
        )

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.remat and train and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            key = next((m.key for m in self.modules() if isinstance(m, Dropout)), None)

            def contexts():
                snap = (None, 0, None) if key is None else (key, key.seed, key.step)
                return contextlib.nullcontext(), _recompute(*snap)

            # preserve_rng_state=False: no noise of the port reads torch's
            # generator (every draw is keyed Philox), and saving and
            # restoring that generator inside a CUDA graph capture is a hazard
            return checkpoint(self._forward, x, train, use_reentrant=False,
                              preserve_rng_state=False, context_fn=contexts)
        return self._forward(x, train)

    def _forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.resample and self.resample_mode == "interpolate":
            h, w = x.shape[-2], x.shape[-1]
            hw = (h // 2, w // 2) if self.mode == "bottom-up" else (2 * h, 2 * w)
            # 'nearest-exact' samples at pixel centres, as jax.image.resize
            x = F.interpolate(x, size=hw, mode="nearest-exact")
        if self.ConvTranspose_0 is not None:
            x = self.ConvTranspose_0(x)
        elif self.Conv_0 is not None:
            x = self.Conv_0(x)
        return self.ResidualBlock_0(x, train)


class MergeLayer(nn.Module):
    """Merge two same-shape maps: a 1x1 conv of their channel concat,
    then (``'residual'``) an ungated ResidualBlock."""

    def __init__(self, channels: int, merge_type: str = "residual",
                 block_type: str = "bacdbacd", nonlin: str = "elu",
                 batchnorm: bool = True, conv_pad: str = "same",
                 dropout_rate: float = 0.0, dropout_impl: str = "bits8",
                 bn_stat_samples: int = 0, fused_segments: bool = False):
        super().__init__()
        if merge_type not in ("linear", "residual"):
            raise ValueError(f"unknown merge_type {merge_type!r}")
        self.Conv_0 = Conv2d(2 * channels, channels, 1)
        self.ResidualBlock_0 = (
            ResidualBlock(channels, block_type, 3, nonlin, batchnorm, False,
                          conv_pad, dropout_rate, dropout_impl, bn_stat_samples,
                          fused_segments)
            if merge_type == "residual" else None
        )

    def forward(self, a: torch.Tensor, b: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        x = self.Conv_0(torch.cat([a, b], dim=1))
        if self.ResidualBlock_0 is not None:
            x = self.ResidualBlock_0(x, train)
        return x
