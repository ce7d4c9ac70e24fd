"""Serving surfaces as plain functions (the contracts of
``lvae_tpu/serving.py:63-175``; ``torch.export`` artifacts come later).

- ``reconstruct(model, x_u8, seed, index, preprocess)`` -> ``{out_mean,
  ll, kl, elbo, bpd}``, bpd over the image's H x W x C dimensions
- ``encode(model, x_u8, seed, index, preprocess)`` -> ``{mu, z}``:
  per-layer posterior means and draws, tuples indexed bottom-up
- ``generate(model, n, seed)`` -> ``[n, H, W, C]`` prior samples (the
  likelihood mean)

Keying contract: image ``i``'s preprocessing and latents are keyed by
``(seed, index[i])``. Pass global dataset indices for ``evaluate``'s
keying (outputs then invariant to batching and permutation), or
``arange(B)`` for position keying. Inputs are uint8 NHWC on the model's
device or the host, preprocessed as the dataset is evaluated
(``preprocess``: ``none``, ``binarize``, or ``dequantize`` for the RGB
datasets); outputs are float32 NHWC on the model's device.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from lvae_tpu_torch.data.device import eval_preprocess_batch
from lvae_tpu_torch.models.stochastic import Noise

LN2 = math.log(2.0)


def _inputs(model, x_u8: torch.Tensor, index: torch.Tensor, preprocess: str):
    if x_u8.dtype != torch.uint8 or x_u8.dim() != 4:
        raise ValueError(f"x must be uint8 [B, H, W, C], got {x_u8.dtype} "
                         f"{tuple(x_u8.shape)}")
    index = torch.as_tensor(index, dtype=torch.int64, device=model.device)
    if index.shape != (x_u8.shape[0],):
        raise ValueError(f"index must be [{x_u8.shape[0]}], got {tuple(index.shape)}")
    x = eval_preprocess_batch(x_u8.to(model.device), preprocess, index)
    return x, index


@torch.no_grad()
def reconstruct(model, x_u8: torch.Tensor, seed: int, index: torch.Tensor,
                preprocess: str = "none") -> dict:
    x, index = _inputs(model, x_u8, index, preprocess)
    out = model(x, noise=Noise(seed, index))
    kl = out["kl_sep"].sum(dim=0)
    elbo = out["ll"] - kl
    return {
        "out_mean": out["out_mean"],
        "ll": out["ll"],
        "kl": kl,
        "elbo": elbo,
        "bpd": -elbo / (x[0].numel() * LN2),
    }


@torch.no_grad()
def encode(model, x_u8: torch.Tensor, seed: int, index: torch.Tensor,
           preprocess: str = "none") -> dict:
    """The top layer's ``mu`` is a function of the image alone; lower
    layers condition on the draws above them and so vary with ``seed``."""
    x, index = _inputs(model, x_u8, index, preprocess)
    out = model(x, noise=Noise(seed, index))
    c = [q.shape[-1] // 2 for q in out["q_params"]]
    return {
        "mu": tuple(q[..., :ci] for q, ci in zip(out["q_params"], c)),
        "z": tuple(out["z"]),
    }


@torch.no_grad()
def generate(model, n: int, seed: int, *,
             temperature: Union[float, Sequence[float]] = 1.0,
             mode_layers: Sequence[int] = (),
             constant_layers: Sequence[int] = ()) -> torch.Tensor:
    return model.sample_prior(
        n, seed=seed, mode_layers=tuple(mode_layers),
        constant_layers=tuple(constant_layers), temperature=temperature,
    )["out_mean"]
