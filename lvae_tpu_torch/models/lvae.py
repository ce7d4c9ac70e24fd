"""The Ladder VAE: training, evaluation and generation (port of
``lvae_tpu/models/lvae.py``).

Conventions kept from the reference package: layer 0 is the bottom
latent, layer L-1 the top; ``forward`` returns the same dict keys as
``LadderVAE.__call__``; ``topdown_pass`` is the generative path when
``bu_values is None``; submodules carry the flax names, so
``state_dict()`` loads ``flax_to_torch_state_dict``'s output strictly.

Layouts: the public methods take and return NHWC (images ``[B,H,W,C]``,
latents ``[B,h,w,c]``); everything inside runs NCHW, so convolutions and
BatchNorm go to cuDNN as they are. Latent noise is keyed per image
(:class:`~lvae_tpu_torch.models.stochastic.Noise`); layer ``i`` draws on
Philox stream ``i``.

``train=True`` runs BatchNorm on batch statistics (and moves the running
ones), dropout keyed by ``(noise.seed, step = noise.sample, site)``, and,
with ``fused_stochastic``, the per-sample KL kernel K1 in every latent
layer: ``kl_sep`` then comes from its ``[B]`` sums and ``kl_spatial`` is
``None``, as in ``lvae_tpu``. ``fused_mixture`` puts a mixture head's
log-prob on the kernel K3 (and its gradient on K3-bwd); ``fused_segments``
runs every ``[d] b a`` run of a residual branch in training as one
dropout+BatchNorm+activation segment, K5 (and K5-bwd); ``bn_stat_samples >
0`` takes training BatchNorm statistics from the batch's leading rows.
``remat`` (``--remat``) recomputes every ``ResBlockWithResampling`` in
the backward (``torch.utils.checkpoint``), as ``lvae_tpu`` wraps them in
``nn.remat``; the running statistics move once. ``dtype`` is flax's
compute dtype (``lvae_tpu/models/lvae.py:243,280,300,364``):
None (fp32) or ``torch.bfloat16``, under which every convolution (the
first conv, the blocks', the merges', the latent heads' and the likelihood
head's) computes in bf16 from fp32 parameters and the activation stream
between blocks is bf16, while BatchNorm, the segments and dropout compute
in fp32 and cast back, and the top prior, the latents, the KL, the
likelihood and everything the trainer does with them stay fp32. Building
the model turns TF32 off (:func:`lvae_tpu_torch.fp32_math`): fp32 convs
are full fp32.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from lvae_tpu_torch import fp32_math
from lvae_tpu_torch.models.blocks import (
    Conv2d,
    Dropout,
    DropoutKey,
    MergeLayer,
    ResBlockWithResampling,
    ResidualBlock,
    get_nonlin,
    init_parameters,
    resize_nearest,
    set_compute_dtype,
)
from lvae_tpu_torch.models.likelihoods import make_likelihood
from lvae_tpu_torch.models.stochastic import Noise, NormalStochasticBlock
from lvae_tpu_torch.ops.math import crop_img_tensor, pad_img_tensor
from lvae_tpu_torch.parallel import mesh


def _nchw(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.permute(0, 3, 1, 2)


def _nhwc(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.permute(0, 2, 3, 1)


class TopDownLayer(nn.Module):
    """One rung of the generative ladder (see ``lvae_tpu``'s docstring):
    q = conv(merge(bu, td)) (top: conv(bu)), p = conv(td) (top: the
    prior); the sample's projection, optionally merged with a bypass of
    the incoming state (``stochastic_skip``, before or after the blocks),
    runs through ``n_res_blocks`` blocks that also upsample."""

    def __init__(self, z_dim: int, n_filters: int, n_res_blocks: int,
                 upsample_steps: int = 0, is_top: bool = False,
                 learn_top_prior: bool = False,
                 top_prior_hw: Tuple[int, int] = (4, 4),
                 stochastic_skip: bool = False, skip_merge_mode: str = "pre",
                 merge_type: str = "residual", block_type: str = "bacdbacd",
                 nonlin: str = "elu", batchnorm: bool = True,
                 gated: bool = False, fused: bool = False,
                 resample_mode: str = "conv", conv_pad: str = "same",
                 dropout_rate: float = 0.0, dropout_impl: str = "bits8",
                 bn_stat_samples: int = 0, fused_segments: bool = False):
        super().__init__()
        self.is_top, self.z_dim = is_top, z_dim
        self.top_prior_hw = tuple(top_prior_hw)
        self.skip_merge_mode = skip_merge_mode
        common = dict(block_type=block_type, nonlin=nonlin,
                      batchnorm=batchnorm, conv_pad=conv_pad,
                      dropout_rate=dropout_rate, dropout_impl=dropout_impl,
                      bn_stat_samples=bn_stat_samples, fused_segments=fused_segments)
        # the top rung has no incoming state: lvae_tpu never calls (so
        # never creates) its merge or skip merge
        self.merge = None if is_top else MergeLayer(n_filters, merge_type, **common)
        self.skip_merge = (
            MergeLayer(n_filters, merge_type, **common)
            if stochastic_skip and not is_top else None
        )
        self.stochastic = NormalStochasticBlock(
            n_filters, z_dim, n_filters, transform_p_params=not is_top,
            fused=fused, conv_pad=conv_pad,
        )
        self.top_prior = (
            nn.Parameter(torch.zeros(1, 2 * z_dim, *self.top_prior_hw))
            if is_top and learn_top_prior else None
        )
        self.det_blocks = []
        for j in range(n_res_blocks):
            blk = ResBlockWithResampling(
                "top-down", n_filters, n_filters, resample=j < upsample_steps,
                resample_mode=resample_mode, gated=gated, **common,
            )
            self.add_module(f"det_blocks_{j}", blk)
            self.det_blocks.append(blk)

    def _top_prior_row(self, device: torch.device) -> torch.Tensor:
        """The top prior's params as one row ``[1, 2z, h, w]``; under
        ``--spatial-shards`` this rank's band of its rows (a copy, so that
        the kernels read it contiguous; the gradient reaches the band's
        rows of the parameter through it)."""
        if self.top_prior is not None:
            row = self.top_prior
        else:
            row = torch.zeros(1, 2 * self.z_dim, *self.top_prior_hw, device=device)
        bands = mesh.current_bands()
        if bands is None:
            return row
        h0, h1 = bands.rows(self.top_prior_hw[0])
        return row[:, :, h0:h1].contiguous()

    def forward(self, td_in, bu_value, *, stream: int, n_img_prior=None,
                noise=None, use_mode=False, forced_latent=None,
                forced_eps=None, constant_latent=False, train=False,
                temperature=1.0):
        if self.is_top:
            if bu_value is not None:
                batch, device = bu_value.shape[0], bu_value.device
            elif n_img_prior is not None:
                batch, device = n_img_prior, self.stochastic.conv_out.weight.device
            else:
                raise ValueError("top layer needs bu_value or n_img_prior")
            p_row = self._top_prior_row(device)
            p_in = p_row.expand(batch, -1, -1, -1)  # a view: never materialised over B
        else:
            if td_in is None:
                raise ValueError("non-top layer needs incoming top-down state")
            p_in, p_row = td_in, None
        if bu_value is not None:
            q_in = bu_value if self.is_top else self.merge(bu_value, td_in, train)
        else:
            q_in = None
        s = self.stochastic(
            p_in, q_in, noise=noise, stream=stream, p_row=p_row,
            forced_latent=forced_latent, forced_eps=forced_eps,
            use_mode=use_mode, constant_latent=constant_latent,
            train=train,
            temperature=temperature,
        )
        h = s["out"]
        do_skip = self.skip_merge is not None and td_in is not None
        if do_skip and self.skip_merge_mode == "pre":
            h = self.skip_merge(h, td_in, train)
        for blk in self.det_blocks:
            h = blk(h, train)
        if do_skip and self.skip_merge_mode == "post":
            skip = td_in
            size = (mesh.global_height(h), h.shape[-1])
            if (mesh.global_height(skip), skip.shape[-1]) != size:
                skip = resize_nearest(skip, size)
            h = self.skip_merge(h, skip, train)
        return h, s


class LadderVAE(nn.Module):
    """Hierarchical Ladder VAE. ``generator`` draws the initial weights
    (seed 0 when omitted); real weights come through ``load_state_dict``.
    ``dtype`` is the convolutions' compute dtype (see the module's
    docstring); the parameters are fp32 whatever it is."""

    def __init__(self, color_ch: int, z_dims: Sequence[int] = (32, 32, 32),
                 blocks_per_layer: int = 2, n_filters: int = 64,
                 stochastic_skip: bool = False, skip_merge_mode: str = "pre",
                 gated: bool = False, downsample: Sequence[int] = (1, 1, 1),
                 learn_top_prior: bool = False,
                 img_size: Tuple[int, int] = (32, 32),
                 data_size: Tuple[int, int] = (28, 28),
                 likelihood: str = "bernoulli", batchnorm: bool = True,
                 nonlin: str = "elu", res_block_type: str = "bacdbacd",
                 merge_type: str = "residual", resample_mode: str = "conv",
                 conv_pad: str = "same", no_initial_downscaling: bool = False,
                 fused_stochastic: bool = False, fused_mixture: bool = False,
                 fused_segments: bool = False, bn_stat_samples: int = 0,
                 dropout_rate: float = 0.2,
                 dropout_impl: str = "bits8",
                 dtype: Optional[torch.dtype] = None,
                 remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be None, float32 or bfloat16, got {dtype}")
        if skip_merge_mode not in ("pre", "post"):
            raise ValueError(f"unknown skip_merge_mode {skip_merge_mode!r}")
        self.z_dims = tuple(z_dims)
        self.blocks_per_layer = blocks_per_layer
        self.downsample = tuple(downsample)
        self.no_initial_downscaling = no_initial_downscaling
        self.img_size, self.data_size = tuple(img_size), tuple(data_size)
        self.act = get_nonlin(nonlin)
        scales = self._scales()
        total = scales[-1]
        h, w = self.img_size
        if h % (1 << total) or w % (1 << total):
            raise ValueError(
                f"img_size {self.img_size} not divisible by 2^{total} "
                f"(initial downscale + sum(downsample))"
            )
        common = dict(block_type=res_block_type, nonlin=nonlin,
                      batchnorm=batchnorm, conv_pad=conv_pad,
                      dropout_rate=dropout_rate, dropout_impl=dropout_impl,
                      bn_stat_samples=bn_stat_samples, fused_segments=fused_segments)
        self.dropout_rate = dropout_rate

        self.first_conv = Conv2d(color_ch, n_filters, 5,
                                 stride=1 if no_initial_downscaling else 2,
                                 conv_pad=conv_pad)
        self.first_block = ResidualBlock(n_filters, gated=gated, **common)
        self.bottom_up_layers = []
        for i in range(self.n_layers):
            layer = []
            for j in range(blocks_per_layer):
                blk = ResBlockWithResampling(
                    "bottom-up", n_filters, n_filters,
                    resample=j < self.downsample[i],
                    resample_mode=resample_mode, gated=gated, **common,
                )
                self.add_module(f"bottom_up_layers_{i}_{j}", blk)
                layer.append(blk)
            self.bottom_up_layers.append(layer)

        self.top_down_layers = []
        for i in range(self.n_layers):
            layer = TopDownLayer(
                self.z_dims[i], n_filters, blocks_per_layer,
                upsample_steps=self.downsample[i],
                is_top=i == self.n_layers - 1,
                learn_top_prior=learn_top_prior,
                top_prior_hw=(h >> total, w >> total),
                stochastic_skip=stochastic_skip,
                skip_merge_mode=skip_merge_mode, merge_type=merge_type,
                gated=gated, fused=fused_stochastic,
                resample_mode=resample_mode, **common,
            )
            self.add_module(f"top_down_layers_{i}", layer)
            self.top_down_layers.append(layer)

        self.final_blocks = []
        if not no_initial_downscaling:
            self.final_blocks.append(ResBlockWithResampling(
                "top-down", n_filters, n_filters, resample=True,
                resample_mode=resample_mode, gated=gated, **common,
            ))
        self.final_blocks.append(ResidualBlock(n_filters, gated=gated, **common))
        for j, blk in enumerate(self.final_blocks):
            self.add_module(f"final_blocks_{j}", blk)
        self.likelihood_head = make_likelihood(likelihood, n_filters, color_ch,
                                               fused_mixture=fused_mixture)
        # one dropout key for the model; each dropout site has its number
        self.dropout_key = DropoutKey()
        for site, m in enumerate(m for m in self.modules() if isinstance(m, Dropout)):
            m.site, m.key = site, self.dropout_key

        # --remat: every ResBlockWithResampling (the bottom-up layers', the
        # top-down layers' and the first final block), as lvae_tpu wraps
        # them in nn.remat (lvae_tpu/models/lvae.py:122-126,292-296)
        for m in self.modules():
            if isinstance(m, ResBlockWithResampling):
                m.remat = remat
        set_compute_dtype(self, dtype)
        fp32_math()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)
        self.eval()

    @property
    def n_layers(self) -> int:
        return len(self.z_dims)

    def _scales(self) -> list[int]:
        """Downsampling factor (log2) at the output of each BU layer."""
        if len(self.downsample) != self.n_layers:
            raise ValueError("downsample must have one entry per layer")
        if any(d > self.blocks_per_layer for d in self.downsample):
            raise ValueError(
                f"downsample {tuple(self.downsample)} has an entry larger "
                f"than blocks_per_layer {self.blocks_per_layer}: a layer "
                "can resample at most once per block"
            )
        s = 0 if self.no_initial_downscaling else 1
        scales = []
        for d in self.downsample:
            s += d
            scales.append(s)
        return scales

    @property
    def device(self) -> torch.device:
        return self.first_conv.weight.device

    def _noise_here(self, noise: Optional[Noise]) -> Optional[Noise]:
        if noise is None:
            return None
        sample = noise.sample
        if isinstance(sample, torch.Tensor):
            sample = sample.to(self.device)
        return dataclasses.replace(noise, index=noise.index.to(self.device),
                                   sample=sample)

    # ------------------------------------------------------------------
    # passes (NCHW inside)
    # ------------------------------------------------------------------
    def _set_dropout_step(self, noise: Optional[Noise]) -> None:
        """Key a training forward's dropout by ``(noise.seed, step)``; the
        step is ``noise.sample``, a 0-d int64 tensor on the device (the
        train step's, read there: no host sync, and a CUDA graph of the
        step replays with it) or an int, copied to the device."""
        if self.dropout_rate <= 0.0:
            return
        step = None if noise is None else noise.sample
        if isinstance(step, torch.Tensor) and step.dim() == 0:
            step = step.to(dtype=torch.int64)
        elif isinstance(step, numbers.Integral):
            step = torch.tensor(int(step), dtype=torch.int64, device=self.device)
        else:
            raise ValueError(
                "a training forward with dropout needs noise=Noise(seed, "
                "index, step) with the step as an int or a 0-d tensor"
            )
        self.dropout_key.seed, self.dropout_key.step = int(noise.seed), step

    def _bottomup(self, x: torch.Tensor, train: bool = False) -> list[torch.Tensor]:
        h = self.first_block(self.act(self.first_conv(x)), train)
        bu_values = []
        for layer in self.bottom_up_layers:
            for blk in layer:
                h = blk(h, train)
            bu_values.append(h)
        return bu_values

    def _topdown(self, bu_values, *, n_img_prior, noise, forced_latent,
                 forced_eps, mode_layers, constant_layers, temperature, train):
        L = self.n_layers
        bu_values = bu_values if bu_values is not None else [None] * L
        forced_latent = forced_latent if forced_latent is not None else [None] * L
        forced_eps = forced_eps if forced_eps is not None else [None] * L
        if isinstance(temperature, (int, float)):
            temps = [float(temperature)] * L
        else:
            temps = [float(t) for t in temperature]
            if len(temps) == 1:
                temps = temps * L
            elif len(temps) != L:
                raise ValueError(
                    f"temperature needs 1 or {L} values, got {len(temps)}"
                )
        td = None
        layer_data: list[dict[str, Any]] = [None] * L  # type: ignore[list-item]
        for i in reversed(range(L)):
            td, s = self.top_down_layers[i](
                td, bu_values[i], stream=i, n_img_prior=n_img_prior,
                noise=noise, use_mode=i in mode_layers,
                forced_latent=_nchw(forced_latent[i]),
                forced_eps=_nchw(forced_eps[i]),
                constant_latent=i in constant_layers, train=train,
                temperature=temps[i],
            )
            layer_data[i] = s
        for blk in self.final_blocks:
            td = blk(td, train)
        return td, layer_data

    # ------------------------------------------------------------------
    # public surfaces (NHWC)
    # ------------------------------------------------------------------
    def topdown_pass(
        self,
        bu_values: Optional[Sequence[Optional[torch.Tensor]]] = None,
        *,
        noise: Optional[Noise] = None,
        train: bool = False,
        n_img_prior: Optional[int] = None,
        forced_latent: Optional[Sequence[Optional[torch.Tensor]]] = None,
        forced_eps: Optional[Sequence[Optional[torch.Tensor]]] = None,
        mode_layers: Sequence[int] = (),
        constant_layers: Sequence[int] = (),
        temperature: Union[float, Sequence[float]] = 1.0,
    ) -> Tuple[torch.Tensor, dict[str, Any]]:
        """Top-down pass, the generative path when ``bu_values is None``.
        ``temperature`` scales the sampling std, one value or one per
        layer (bottom first)."""
        noise = self._noise_here(noise)
        if train:
            self._set_dropout_step(noise)
        bu = None if bu_values is None else [_nchw(b) for b in bu_values]
        td, layer_data = self._topdown(
            bu, n_img_prior=n_img_prior, noise=noise,
            forced_latent=forced_latent, forced_eps=forced_eps,
            mode_layers=mode_layers, constant_layers=constant_layers,
            temperature=temperature, train=train,
        )
        info = {
            k: [_nhwc(d[k]) for d in layer_data]
            for k in ("z", "kl_elementwise", "q_params", "p_params")
        }
        info["kl_sample"] = [d["kl_sample"] for d in layer_data]
        return _nhwc(td), info

    def forward(self, x: torch.Tensor, *, noise: Optional[Noise] = None,
                forced_eps=None, forced_latent=None, train: bool = False) -> dict[str, Any]:
        """Inference pass on an NHWC batch in [0, 1] (already binarised).
        Sampled latents need ``noise`` (in training ``Noise(seed, index,
        step)``); ``forced_eps`` / ``forced_latent`` (per-layer NHWC lists)
        replace the draw.

        A training forward over a layout with a space axis
        (``--spatial-shards``, :func:`lvae_tpu_torch.parallel.mesh.current`)
        runs banded: ``x`` is this rank's rows, whole; it is padded and cut
        to this rank's band of rows, and every activation after it is a
        band (:func:`lvae_tpu_torch.parallel.mesh.banded`). The crop to the
        data size keeps the band's rows inside the crop (at 32 -> 28 over 4
        ranks: 6, 8, 8 and 6), the likelihood takes the matching rows of
        ``x``, and ``ll`` and ``kl_sep`` are the bands' sums, summed over
        the space group (:func:`lvae_tpu_torch.parallel.mesh.space_sum`).
        The returned maps are the band's."""
        noise = self._noise_here(noise)
        if train:
            self._set_dropout_step(noise)
        bands = mesh.bands_for(mesh.current(), self.img_size) if train else None
        with mesh.banded(bands):
            return self._forward(x, noise, forced_eps, forced_latent, train, bands)

    def _forward(self, x, noise, forced_eps, forced_latent, train, bands):
        x_pad = pad_img_tensor(x, self.img_size)
        if bands is not None:
            h0, h1 = bands.rows(self.img_size[0])
            x_pad = x_pad[:, h0:h1]
        bu = self._bottomup(_nchw(x_pad).contiguous(), train)
        td, layer_data = self._topdown(
            bu, n_img_prior=None, noise=noise,
            forced_latent=forced_latent, forced_eps=forced_eps,
            mode_layers=(), constant_layers=(), temperature=1.0, train=train,
        )
        if bands is None:
            td = _nchw(crop_img_tensor(_nhwc(td), self.data_size))
            target = x
        else:
            td, target = self._crop_band(td, x, bands)
        ll, lik = self.likelihood_head(td, _nchw(target))
        kls = [d["kl_elementwise"] for d in layer_data]
        # the K1 branch summed each layer's KL per sample in the kernel
        # (lvae_tpu/models/lvae.py:454-463); elementwise maps elsewhere
        kl_sep = torch.stack([
            d["kl_sample"] if d["kl_sample"] is not None else k.sum(dim=(1, 2, 3))
            for d, k in zip(layer_data, kls)
        ])                                                              # [L, B]
        ll = ll.sum(dim=(1, 2, 3))
        if bands is not None:     # one all-reduce; each part keeps its dtype
            sums = mesh.space_sum(torch.cat([ll.view(1, -1), kl_sep]))
            ll, kl_sep = sums[0].to(ll.dtype), sums[1:].to(kl_sep.dtype)
        return {
            "ll": ll,
            "kl_sep": kl_sep,
            "kl_spatial": [None if k is None else k.sum(dim=1) for k in kls],  # [B, h, w]
            "z": [_nhwc(d["z"]) for d in layer_data],
            "q_params": [_nhwc(d["q_params"]) for d in layer_data],
            "p_params": [_nhwc(d["p_params"]) for d in layer_data],
            "out_mean": _nhwc(lik["mean"]),
            "out_mode": _nhwc(lik["mode"]),
            "out_params": _nhwc(lik["params"]),
        }

    def _crop_band(self, td: torch.Tensor, x: torch.Tensor, bands: mesh.Bands):
        """The centre crop of the padded map's band ``td`` (NCHW) to the
        data size: the band's rows that lie inside the crop (possibly
        none), and the rows of the NHWC batch ``x`` they stand for."""
        (hp, wp), (hd, wd) = self.img_size, self.data_size
        top, left = (hp - hd) // 2, (wp - wd) // 2
        h0, h1 = bands.rows(hp)
        r0 = min(max(h0, top), top + hd)
        r1 = max(min(h1, top + hd), r0)
        td = td[:, :, r0 - h0:r1 - h0, left:left + wd]
        return td, x[:, r0 - top:r1 - top]

    def sample_prior(self, n_img: int, *, seed: int,
                     mode_layers: Sequence[int] = (),
                     constant_layers: Sequence[int] = (),
                     temperature: Union[float, Sequence[float]] = 1.0,
                     ) -> dict[str, Any]:
        """Generate ``n_img`` images from the prior; image ``i`` draws with
        ``Noise(seed, index=i)``."""
        noise = Noise(seed, torch.arange(n_img, device=self.device))
        td, layer_data = self._topdown(
            None, n_img_prior=n_img, noise=noise, forced_latent=None,
            forced_eps=None, mode_layers=mode_layers,
            constant_layers=constant_layers, temperature=temperature,
            train=False,
        )
        td = _nchw(crop_img_tensor(_nhwc(td), self.data_size))
        _, lik = self.likelihood_head(td, None)
        return {
            "out_mean": _nhwc(lik["mean"]),
            "out_mode": _nhwc(lik["mode"]),
            "out_params": _nhwc(lik["params"]),
            "z": [_nhwc(d["z"]) for d in layer_data],
        }
