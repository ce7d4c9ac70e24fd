"""Data-dependent initialisation (port of ``lvae_tpu/train/init.py``).

Walk the convolutions in execution order; for each, run a train-mode
forward on a real batch, and rescale that conv's weight by 1/std and shift
its bias by -mean/std, per output channel, from its output's statistics.
In order, so each conv sees its upstream convs already rescaled (all at
once from one forward would compound the growth). The Gaussian heads and
the likelihood head keep their deliberate near-zero start
(``_EXCLUDED_CONVS``); ``max_gain`` bounds each rescale.

The forwards are statistics passes: BatchNorm runs on batch statistics as
in training, but the running statistics are put back after each pass, as
``lvae_tpu`` (whose pass never writes them back) leaves them. The latents
take the training kernel (K1), as in ``lvae_tpu``. Each pass stops at the
conv it measures.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lvae_tpu_torch.models.blocks import Conv2d, ConvTranspose2d
from lvae_tpu_torch.models.stochastic import Noise

_EXCLUDED_CONVS = ("conv_in_p", "conv_in_q", "param_conv")


class _Measured(Exception):
    """Raised by the hook once the measured conv has run."""


def _output(m, inputs, out):
    """The conv output ``lvae_tpu`` measures. Its 'torch'-padded
    transposed conv is the full (VALID) transposed conv, cropped outside
    the module, so the statistics cover the full map."""
    if isinstance(m, ConvTranspose2d) and m.conv_pad == "torch":
        return F.conv_transpose2d(inputs[0], m.weight, m.bias, m.stride)
    return out


@torch.no_grad()
def data_dependent_init(model, x: torch.Tensor, noise: Noise, n_iter: int = 1,
                        eps: float = 1e-6, max_gain: float = 10.0,
                        forced_eps=None) -> None:
    """Rescale ``model``'s convs in place from the activations of the
    preprocessed NHWC batch ``x`` (noise and dropout keyed by ``noise``;
    ``forced_eps``, per-layer NHWC, replaces the latent draw)."""
    saved = {k: b.clone() for k, b in model.named_buffers()}

    def restore():
        for k, b in model.named_buffers():
            b.copy_(saved[k])

    def forward():
        model(x, noise=noise, forced_eps=forced_eps, train=True)

    candidates = [m for name, m in model.named_modules()
                  if isinstance(m, (Conv2d, ConvTranspose2d))
                  and not any(c in _EXCLUDED_CONVS for c in name.split("."))]
    order: list = []
    seen: set = set()

    def record(m, inputs, out):
        if id(m) not in seen:
            seen.add(id(m))
            order.append(m)

    hooks = [m.register_forward_hook(record) for m in candidates]
    try:
        forward()
    finally:
        for h in hooks:
            h.remove()
        restore()

    for _ in range(n_iter):
        for conv in order:
            got = {}

            def measure(m, inputs, out):
                got["out"] = _output(m, inputs, out)
                raise _Measured

            hook = conv.register_forward_hook(measure)
            try:
                forward()
            except _Measured:
                pass
            finally:
                hook.remove()
                restore()
            out = got["out"]
            mean = out.mean(dim=(0, 2, 3))
            std = out.std(dim=(0, 2, 3), unbiased=False).clamp(1.0 / max_gain, max_gain) + eps
            # output channels: dim 0 of a conv's weight, dim 1 of a
            # transposed conv's
            shape = (1, -1, 1, 1) if isinstance(conv, ConvTranspose2d) else (-1, 1, 1, 1)
            conv.weight.div_(std.view(shape))
            if conv.bias is not None:
                conv.bias.copy_((conv.bias - mean) / std)
