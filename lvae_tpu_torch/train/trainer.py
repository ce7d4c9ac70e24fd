"""Kernel policy and the model factory (the parts of
``lvae_tpu/train/trainer.py`` the eval path needs)."""

from __future__ import annotations

import torch

from lvae_tpu_torch.config import EvalConfig
from lvae_tpu_torch.data.registry import TestSet
from lvae_tpu_torch.models.lvae import LadderVAE

FUSED_POLICIES = ("auto", "none", "stochastic", "mixture", "pallas",
                  "segments", "all")


def resolve_fused(policy: str, device: torch.device) -> dict:
    """Map ``--fused`` to the port's kernel switches.

    On CUDA, ``auto`` turns the sample+KL kernel on; ``stochastic``,
    ``pallas`` and ``all`` (``lvae_tpu``'s spellings) do so on any
    device, and on the CPU the kernel's wrapper runs its plain version.
    ``none`` is the user's explicit choice of plain PyTorch. The other
    kernels named by ``lvae_tpu``'s policies (mixture head, train-mode
    segments) are not on this slice. PROVISIONAL: ``auto``'s choice is
    taken before any A/B of the port on the H100 (ROADMAP Queue 1,
    item 9); the TPU's measured policy is no evidence for it.
    """
    if policy not in FUSED_POLICIES:
        raise ValueError(f"unknown --fused {policy!r}; choose from {FUSED_POLICIES}")
    if policy == "auto":
        return {"fused_stochastic": torch.device(device).type == "cuda"}
    return {"fused_stochastic": policy in ("stochastic", "pallas", "all")}


def default_logsumexp(device: torch.device) -> str:
    """``--logsumexp`` when not given: the CUDA kernel on CUDA, the
    streaming accumulator elsewhere. PROVISIONAL, like ``resolve_fused``."""
    return "kernel" if torch.device(device).type == "cuda" else "streaming"


def make_model(cfg: EvalConfig, data: TestSet, device: torch.device,
               generator: torch.Generator | None = None) -> LadderVAE:
    """The configured model on ``device``; ``generator`` draws the
    initial weights."""
    model = LadderVAE(
        color_ch=data.color_ch,
        z_dims=cfg.zdims,
        blocks_per_layer=cfg.blocks_per_layer,
        n_filters=cfg.n_filters,
        stochastic_skip=cfg.skip,
        skip_merge_mode=cfg.skip_merge,
        gated=cfg.gated,
        downsample=cfg.downsample,
        learn_top_prior=cfg.learn_top_prior,
        img_size=data.padded_size,
        data_size=data.img_size,
        likelihood=cfg.likelihood or data.default_likelihood,
        batchnorm=cfg.batchnorm,
        nonlin=cfg.nonlin,
        res_block_type=cfg.residual_type,
        merge_type=cfg.merge_layers,
        resample_mode=cfg.resample_mode,
        conv_pad=cfg.conv_pad,
        no_initial_downscaling=cfg.no_initial_downscaling,
        generator=generator,
        **resolve_fused(cfg.fused, device),
    )
    return model.to(device)
