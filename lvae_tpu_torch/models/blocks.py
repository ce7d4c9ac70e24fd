"""Deterministic building blocks, eval mode (port of
``lvae_tpu/models/blocks.py``).

NCHW inside; convolutions and BatchNorm go to cuDNN. Submodules carry the
flax names (``Conv_0``, ``BatchNorm_1``, ``GateLayer_0``,
``ResidualBlock_0``, ``ConvTranspose_0``) so ``state_dict()`` keys equal
``lvae_tpu.train.convert.torch_key_for`` of the flax paths.

Eval only: BatchNorm always normalises with its running statistics and
dropout is the identity. Train-mode dropout and the BatchNorm update come
with the training slice.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with ``lvae_tpu``'s padding conventions. Parameters
    start at zero; :func:`init_parameters` draws them from an explicit
    generator (``init_std`` overrides the lecun-normal scale)."""

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
            return F.conv2d(x, self.weight, self.bias, s, (top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)),
                        self.weight, self.bias, s)


class ConvTranspose2d(nn.ConvTranspose2d):
    """2x upsampling transposed conv (weight ``[in, out, k, k]``).

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
            return F.conv_transpose2d(x, self.weight, self.bias, s,
                                      padding=k // 2, output_padding=s - 1)
        if self.conv_pad != "same":
            raise ValueError(f"unknown conv_pad {self.conv_pad!r}")
        h, w = x.shape[-2], x.shape[-1]
        y = F.conv_transpose2d(x, self.weight, self.bias, s)
        return y[:, :, : s * h, : s * w]


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


def batch_norm_eval(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the running statistics, whatever ``bn.training``."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


class GateLayer(nn.Module):
    """a * sigmoid(b) from a 1x1 conv to 2x the channels."""

    def __init__(self, channels: int):
        super().__init__()
        self.Conv_0 = Conv2d(channels, 2 * channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = torch.chunk(self.Conv_0(x), 2, dim=1)
        return a * torch.sigmoid(b)


class ResidualBlock(nn.Module):
    """Residual block whose branch is spelled by ``block_type``: ``b``
    BatchNorm, ``a`` activation, ``c`` 3x3 conv, ``d`` dropout (the
    identity in eval); an optional GateLayer ends the branch."""

    def __init__(self, channels: int, block_type: str = "bacdbacd",
                 kernel_size: int = 3, nonlin: str = "elu",
                 batchnorm: bool = True, gated: bool = False,
                 conv_pad: str = "same"):
        super().__init__()
        self.block_type = block_type
        self.act = get_nonlin(nonlin)
        self.batchnorm = batchnorm
        nb = nc = 0
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
            elif ch not in "abcd":
                raise ValueError(f"unknown block_type char {ch!r} in {block_type!r}")
        self.GateLayer_0 = GateLayer(channels) if gated else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        nb = nc = 0
        for ch in self.block_type:
            if ch == "b" and self.batchnorm:
                h = batch_norm_eval(getattr(self, f"BatchNorm_{nb}"), h)
                nb += 1
            elif ch == "a":
                h = self.act(h)
            elif ch == "c":
                h = getattr(self, f"Conv_{nc}")(h)
                nc += 1
        if self.GateLayer_0 is not None:
            h = self.GateLayer_0(h)
        return x + h


class ResBlockWithResampling(nn.Module):
    """Optional 2x resample, or a 1x1 channel projection, then a
    ResidualBlock. ``resample_mode='conv'``: a stride-2 conv bottom-up, a
    stride-2 transposed conv top-down; ``'interpolate'``: nearest 2x
    resize then a 1x1 conv."""

    def __init__(self, mode: str, cin: int, channels: int,
                 resample: bool = False, resample_mode: str = "conv",
                 block_type: str = "bacdbacd", kernel_size: int = 3,
                 nonlin: str = "elu", batchnorm: bool = True,
                 gated: bool = False, conv_pad: str = "same"):
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
            channels, block_type, kernel_size, nonlin, batchnorm, gated, conv_pad
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.resample and self.resample_mode == "interpolate":
            h, w = x.shape[-2], x.shape[-1]
            hw = (h // 2, w // 2) if self.mode == "bottom-up" else (2 * h, 2 * w)
            # 'nearest-exact' samples at pixel centres, as jax.image.resize
            x = F.interpolate(x, size=hw, mode="nearest-exact")
        if self.ConvTranspose_0 is not None:
            x = self.ConvTranspose_0(x)
        elif self.Conv_0 is not None:
            x = self.Conv_0(x)
        return self.ResidualBlock_0(x)


class MergeLayer(nn.Module):
    """Merge two same-shape maps: a 1x1 conv of their channel concat,
    then (``'residual'``) an ungated ResidualBlock."""

    def __init__(self, channels: int, merge_type: str = "residual",
                 block_type: str = "bacdbacd", nonlin: str = "elu",
                 batchnorm: bool = True, conv_pad: str = "same"):
        super().__init__()
        if merge_type not in ("linear", "residual"):
            raise ValueError(f"unknown merge_type {merge_type!r}")
        self.Conv_0 = Conv2d(2 * channels, channels, 1)
        self.ResidualBlock_0 = (
            ResidualBlock(channels, block_type, 3, nonlin, batchnorm, False,
                          conv_pad)
            if merge_type == "residual" else None
        )

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(torch.cat([a, b], dim=1))
        if self.ResidualBlock_0 is not None:
            x = self.ResidualBlock_0(x)
        return x
