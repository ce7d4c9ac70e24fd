"""The plain reference Ladder VAE: fp32 PyTorch written from the layer
equations of the port's plain path, with no kernel, no bf16, no rank or
band, no remat and no graph.

Layout NCHW. Module names and registration order are those of
``lvae_tpu_torch.models.lvae.LadderVAE``, so one dict of weights loads
into both by name and the dropout sites (numbered in module order) key
the same masks. Every conv starts at zero: the benchmark loads the
weights it made (:func:`portbench.weights.make`).

Equations (layer 0 the bottom latent, L-1 the top):

- conv: flax SAME padding, ``total = max((ceil(n/s) - 1) s + k - n, 0)``
  split low ``total // 2``; the 2x transposed conv is the full one cut to
  its top-left ``2H x 2W``;
- residual block ``bacdbacd``: BatchNorm, ELU, 3x3 conv, dropout, twice,
  then the gate ``a * sigmoid(b)`` of a 1x1 conv to 2C, added to the
  input; BatchNorm in training normalises with the batch mean and the
  biased variance and moves the running statistics by flax's rule ``r =
  0.9 r + 0.1 batch`` (the biased variance), in evaluation normalises
  with the running statistics;
- dropout (training only): an element survives iff its byte
  (:func:`~portbench.reference.philox.dropout_bytes` under ``mix_seed(seed,
  step, site)``) is below ``t = round(256 (1 - rate))``, scaled ``256 / t``;
- latent layer: ``q = conv(merge(bu, td))`` (top: ``conv(bu)``), ``p =
  conv(td)`` (top: the learned prior row), ``z = mu_q + exp(lv_q / 2) eps``
  with eps keyed ``(seed, index, sample, layer)``, the analytic Gaussian
  KL elementwise, ``out = conv(z)`` merged with ``td`` before the blocks;
- head: the PixelCNN++ discretized logistic mixture (K = 10, 256 bins,
  linear channel autoregression) over a 1x1 conv's ``K (1 + 3C)`` maps.

Returns ``ll [B]`` (the image's log-likelihood) and ``kl [L, B]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.philox import dropout_bytes, keyed_normal, mix_seed

LOG_SCALE_MIN = -7.0


def _same(n: int, k: int, s: int):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=0)

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = _same(x.shape[-2], k, s)
        left, right = _same(x.shape[-1], k, s)
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight, self.bias, s)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__(cin, cout, k, stride=2)

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        return F.conv_transpose2d(x, self.weight, self.bias, 2)[:, :, :2 * h, :2 * w]


class Dropout(nn.Module):
    def __init__(self, rate: float, key: "DropKey"):
        super().__init__()
        self.rate, self.site, self.key = rate, 0, key

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        t = int(round((1.0 - self.rate) * 256.0)) if self.rate > 0.0 else 256
        if not train or t >= 256:
            return x
        keep = dropout_bytes(x.shape, mix_seed(self.key.seed, self.key.step, self.site),
                             x.device) < t
        return torch.where(keep, x * (256.0 / t), 0.0)


class DropKey:
    seed = 0
    step = 0


class GateLayer(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.Conv_0 = Conv2d(c, 2 * c, 1)

    def forward(self, x):
        a, b = torch.chunk(self.Conv_0(x), 2, dim=1)
        return a * torch.sigmoid(b)


BN_MOMENTUM = 0.9


def _batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, train: bool) -> torch.Tensor:
    if train:
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        with torch.no_grad():
            for r, batch in ((bn.running_mean, mean), (bn.running_var, var)):
                r.copy_(BN_MOMENTUM * r + (1.0 - BN_MOMENTUM) * batch.flatten())
    else:
        mean, var = bn.running_mean.view(1, -1, 1, 1), bn.running_var.view(1, -1, 1, 1)
    return ((x - mean) * torch.rsqrt(var + bn.eps) * bn.weight.view(1, -1, 1, 1)
            + bn.bias.view(1, -1, 1, 1))


class ResidualBlock(nn.Module):
    """``bacdbacd`` with an optional gate."""

    def __init__(self, c: int, gated: bool, rate: float, key: DropKey):
        super().__init__()
        for i in range(2):
            self.add_module(f"BatchNorm_{i}", nn.BatchNorm2d(c, eps=1e-5))
            self.add_module(f"Conv_{i}", Conv2d(c, c, 3))
            self.add_module(f"Dropout_{i}", Dropout(rate, key))
        self.GateLayer_0 = GateLayer(c) if gated else None

    def forward(self, x, train):
        h = x
        for i in range(2):
            h = F.elu(_batch_norm(getattr(self, f"BatchNorm_{i}"), h, train))
            h = getattr(self, f"Dropout_{i}")(getattr(self, f"Conv_{i}")(h), train)
        if self.GateLayer_0 is not None:
            h = self.GateLayer_0(h)
        return x + h


class ResBlockWithResampling(nn.Module):
    def __init__(self, mode: str, c: int, resample: bool, gated: bool, rate: float,
                 key: DropKey):
        super().__init__()
        self.ConvTranspose_0 = self.Conv_0 = None
        if resample and mode == "bottom-up":
            self.Conv_0 = Conv2d(c, c, 3, stride=2)
        elif resample:
            self.ConvTranspose_0 = ConvTranspose2d(c, c, 3)
        self.ResidualBlock_0 = ResidualBlock(c, gated, rate, key)

    def forward(self, x, train):
        if self.ConvTranspose_0 is not None:
            x = self.ConvTranspose_0(x)
        elif self.Conv_0 is not None:
            x = self.Conv_0(x)
        return self.ResidualBlock_0(x, train)


class MergeLayer(nn.Module):
    def __init__(self, c: int, rate: float, key: DropKey):
        super().__init__()
        self.Conv_0 = Conv2d(2 * c, c, 1)
        self.ResidualBlock_0 = ResidualBlock(c, False, rate, key)

    def forward(self, a, b, train):
        return self.ResidualBlock_0(self.Conv_0(torch.cat([a, b], dim=1)), train)


class NormalStochasticBlock(nn.Module):
    def __init__(self, c: int, z: int, top: bool):
        super().__init__()
        self.conv_in_p = None if top else Conv2d(c, 2 * z, 3)
        self.conv_in_q = Conv2d(c, 2 * z, 3)
        self.conv_out = Conv2d(z, c, 3)


class TopDownLayer(nn.Module):
    def __init__(self, z: int, c: int, blocks: int, upsample: int, top: bool,
                 prior_hw, rate: float, key: DropKey):
        super().__init__()
        self.top = top
        self.merge = None if top else MergeLayer(c, rate, key)
        self.skip_merge = None if top else MergeLayer(c, rate, key)
        self.stochastic = NormalStochasticBlock(c, z, top)
        self.top_prior = nn.Parameter(torch.zeros(1, 2 * z, *prior_hw)) if top else None
        self.det_blocks = []
        for j in range(blocks):
            blk = ResBlockWithResampling("top-down", c, j < upsample, True, rate, key)
            self.add_module(f"det_blocks_{j}", blk)
            self.det_blocks.append(blk)

    def forward(self, td, bu, noise, layer: int, train: bool):
        st = self.stochastic
        if self.top:
            p = self.top_prior.expand(bu.shape[0], -1, -1, -1)
            q = st.conv_in_q(bu)
        else:
            p = st.conv_in_p(td)
            q = st.conv_in_q(self.merge(bu, td, train))
        z_dim = q.shape[1] // 2
        mu, lv = q[:, :z_dim], q[:, z_dim:]
        p_mu, p_lv = p[:, :z_dim], p[:, z_dim:]
        seed, index, sample = noise
        z = mu + torch.exp(0.5 * lv) * keyed_normal(mu.shape, seed, index, sample, layer)
        kl = 0.5 * (torch.exp(lv - p_lv) + (mu - p_mu) ** 2 * torch.exp(-p_lv) - 1.0
                    - (lv - p_lv))
        h = st.conv_out(z)
        if not self.top:
            h = self.skip_merge(h, td, train)
        for blk in self.det_blocks:
            h = blk(h, train)
        return h, kl.sum(dim=(1, 2, 3))


class MixtureHead(nn.Module):
    def __init__(self, c_in: int, color_ch: int, k: int = 10):
        super().__init__()
        self.k = k
        self.param_conv = Conv2d(c_in, k * (1 + 3 * color_ch), 1)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Per-image log-likelihood of ``x`` (NCHW in [0, 1], C = 3)."""
        k = self.k
        p = self.param_conv(h).movedim(1, -1)                        # [B, H, W, K(1+3C)]
        c = x.shape[1]
        shape = p.shape[:-1] + (k, c)
        logit_pi = p[..., :k]
        means = p[..., k:k + k * c].reshape(shape)
        log_s = p[..., k + k * c:k + 2 * k * c].reshape(shape).clamp_min(LOG_SCALE_MIN)
        coef = torch.tanh(p[..., k + 2 * k * c:].reshape(shape))
        xs = (2.0 * x.movedim(1, -1) - 1.0).unsqueeze(-2)           # [B, H, W, 1, C]
        m1 = means[..., 1] + coef[..., 0] * xs[..., 0]
        m2 = means[..., 2] + coef[..., 1] * xs[..., 0] + coef[..., 2] * xs[..., 1]
        centred = xs - torch.stack([means[..., 0], m1, m2], dim=-1)
        inv_s = torch.exp(-log_s)
        half = 1.0 / 255.0
        plus, minus = inv_s * (centred + half), inv_s * (centred - half)
        delta = 2.0 * half * inv_s
        interior = (minus + delta + torch.log(-torch.expm1(-delta))
                    - F.softplus(minus) - F.softplus(minus + delta))
        lp = torch.where(xs < -1.0 + half, F.logsigmoid(plus),
                         torch.where(xs > 1.0 - half, F.logsigmoid(-minus), interior))
        lp = lp.sum(dim=-1) + F.log_softmax(logit_pi, dim=-1)
        return torch.logsumexp(lp, dim=-1).sum(dim=(1, 2))


def ladder(config: dict) -> dict:
    """The ladder of a configuration file: ``num_layers`` latent layers of
    ``model.z_dim`` channels each, ``downsample`` (a flag a layer: a
    stride-2 step in its first block), ``model.blocks_per_layer`` blocks
    a layer of ``model.n_filters`` channels."""
    m, n = config["model"], int(config["num_layers"])
    if len(config["downsample"]) != n:
        raise ValueError(f"downsample has {len(config['downsample'])} flags for {n} layers")
    return {"zdims": (int(m["z_dim"]),) * n, "downsample": tuple(config["downsample"]),
            "blocks_per_layer": int(m["blocks_per_layer"]), "n_filters": int(m["n_filters"])}


class LadderVAE(nn.Module):
    """The configuration's model: ``zdims``, ``downsample`` (a stride-2
    step in the first blocks of a layer), ``blocks_per_layer``,
    ``n_filters``; gated blocks, the stochastic skip merged before the
    blocks, a learned top prior, an initial 5x5 stride-2 conv."""

    def __init__(self, color_ch: int, zdims: Sequence[int], downsample: Sequence[int],
                 blocks_per_layer: int, n_filters: int, img_size, dropout: float):
        super().__init__()
        c, n = n_filters, len(zdims)
        key = self.dropout_key = DropKey()
        self.downsample = tuple(downsample)
        total = 1 + sum(downsample)
        prior_hw = (img_size[0] >> total, img_size[1] >> total)
        self.first_conv = Conv2d(color_ch, c, 5, stride=2)
        self.first_block = ResidualBlock(c, True, dropout, key)
        self.bottom_up = []
        for i in range(n):
            layer = []
            for j in range(blocks_per_layer):
                blk = ResBlockWithResampling("bottom-up", c, j < downsample[i], True, dropout,
                                             key)
                self.add_module(f"bottom_up_layers_{i}_{j}", blk)
                layer.append(blk)
            self.bottom_up.append(layer)
        self.top_down = []
        for i in range(n):
            layer = TopDownLayer(zdims[i], c, blocks_per_layer, downsample[i], i == n - 1,
                                 prior_hw, dropout, key)
            self.add_module(f"top_down_layers_{i}", layer)
            self.top_down.append(layer)
        self.final_blocks_0 = ResBlockWithResampling("top-down", c, True, True, dropout, key)
        self.final_blocks_1 = ResidualBlock(c, True, dropout, key)
        self.likelihood_head = MixtureHead(c, color_ch)
        for site, m in enumerate(m for m in self.modules() if isinstance(m, Dropout)):
            m.site = site

    def forward(self, x: torch.Tensor, noise, train: bool = False, step: int = 0):
        """``(ll [B], kl [L, B])`` of an NHWC batch in [0, 1]; ``noise`` is
        ``(seed, index [B], sample)``; in training the dropout masks are
        keyed ``(noise seed, step, site)``."""
        self.dropout_key.seed, self.dropout_key.step = int(noise[0]), int(step)
        xc = x.permute(0, 3, 1, 2).contiguous()
        h = self.first_block(F.elu(self.first_conv(xc)), train)
        bu = []
        for layer in self.bottom_up:
            for blk in layer:
                h = blk(h, train)
            bu.append(h)
        td, kls = None, [None] * len(self.top_down)
        for i in reversed(range(len(self.top_down))):
            td, kls[i] = self.top_down[i](td, bu[i], noise, i, train)
        td = self.final_blocks_1(self.final_blocks_0(td, train), train)
        return self.likelihood_head(td, xc), torch.stack(kls)
