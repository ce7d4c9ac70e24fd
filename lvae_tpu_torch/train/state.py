"""The train step and the test-ELBO sweep (port of ``lvae_tpu/train/state.py``).

Training: :class:`TrainState` holds the step, the model, its Adamax
optimiser, the metric EMA (on the device) and the noise seed;
:func:`train_step` preprocesses a gathered uint8 batch, runs the forward
in train mode, takes ``lvae_tpu``'s loss (``-(mean ll - beta * sum of the
free-bits-clamped per-layer KL)``), backpropagates, clips by optax's
global-norm rule when asked, steps Adamax and moves the EMA. Every random
draw of step ``s`` is keyed by ``(seed, dataset index, s, stream)`` or
``(seed, s, dropout site)``, so a step depends on nothing but its number:
a resumed run repeats an uninterrupted one.

Evaluation: ``lvae_tpu`` vmaps a B=1 forward so that image ``i`` draws from
``fold_in(key, index[i])``. The port runs the batch as one batch: eval
BatchNorm uses running statistics, so rows do not interact, and the
noise of row ``i`` depends only on ``(seed, index[i], sample, layer)``
(``models/stochastic.py``). Test ELBO is therefore the same for any
``--test-batch-size`` and sweep order.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from lvae_tpu_torch.data.device import eval_preprocess_batch, preprocess_batch
from lvae_tpu_torch.models.stochastic import Noise
from lvae_tpu_torch.ops.math import free_bits_kl, linear_anneal


@dataclasses.dataclass(frozen=True)
class LossConfig:
    free_bits: float = 0.0
    beta_anneal_steps: int = 0    # 0: no KL warmup (beta = 1)
    preprocess: str = "none"
    ema_decay: float = 0.999
    max_grad_norm: Optional[float] = None


@dataclasses.dataclass
class TrainState:
    """``lvae_tpu``'s ``TrainState``: the step, the model (parameters and
    BatchNorm statistics), the optimiser, the metric EMA and the seed of
    the training noise (``lvae_tpu`` keys ``state.rng`` with seed + 1)."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema: dict
    seed: int


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Optimizer:
    """Adamax with ``optax.adamax``'s settings (betas 0.9, 0.999; eps 1e-8),
    the reference's optimiser."""
    return torch.optim.Adamax(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def init_ema(n_layers: int, device) -> dict:
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return {"elbo": z(), "ll": z(), "kl": z(), "loss": z(), "kl_layers": z(n_layers)}


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: when the global norm is
    not below ``max_norm``, every gradient becomes ``(g / norm) * max_norm``
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). Returns the
    norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if not bool(norm < max_norm):
        torch._foreach_div_(list(grads), norm)
        torch._foreach_mul_(list(grads), max_norm)
    return norm


def loss_terms(model, x: torch.Tensor, noise: Optional[Noise], beta: float,
               free_bits: float, forced_eps=None):
    """``(loss, metrics)`` of ``lvae_tpu``'s train loss on a preprocessed
    NHWC batch, the model in train mode."""
    out = model(x, noise=noise, forced_eps=forced_eps, train=True)
    kl_fb = free_bits_kl(out["kl_sep"], free_bits)          # [L]
    ll_mean = out["ll"].mean()
    loss = -(ll_mean - beta * kl_fb.sum())
    kl_mean = out["kl_sep"].sum(dim=0).mean()
    metrics = {
        "elbo": ll_mean - kl_mean,
        "ll": ll_mean,
        "kl": kl_mean,
        "loss": loss,
        "kl_layers": out["kl_sep"].mean(dim=1),
    }
    return loss, metrics


def train_step(state: TrainState, batch_u8: torch.Tensor, index: torch.Tensor,
               cfg: LossConfig, forced_eps=None) -> dict:
    """One optimiser step on the uint8 NHWC batch of dataset rows
    ``index``; returns the step's metrics (device tensors, no host sync).
    ``forced_eps`` (per-layer NHWC) replaces the latent draw."""
    model, step = state.model, state.step
    dtype = next(model.parameters()).dtype
    x = preprocess_batch(batch_u8, cfg.preprocess, state.seed, index, step).to(dtype)
    beta = linear_anneal(step, 0.0, 1.0, cfg.beta_anneal_steps)
    loss, metrics = loss_terms(model, x, Noise(state.seed, index, step), beta,
                               cfg.free_bits, forced_eps)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if cfg.max_grad_norm is not None:
        clip_by_global_norm_([p.grad for p in model.parameters() if p.grad is not None],
                             cfg.max_grad_norm)
    state.optimizer.step()
    metrics = {k: v.detach() for k, v in metrics.items()}
    d = cfg.ema_decay
    for k, m in metrics.items():     # initialised at step 0, as lvae_tpu
        e = state.ema[k]
        state.ema[k] = m.to(e.dtype).clone() if step == 0 else d * e + (1.0 - d) * m.to(e.dtype)
    state.step = step + 1
    return metrics


def per_image_forward(model, x: torch.Tensor, index: torch.Tensor, seed: int,
                      sample=0):
    """``(ll [B], kl_sep [L, B])`` with image ``i``'s latents keyed by
    ``(seed, index[i], sample)``."""
    out = model(x, noise=Noise(seed, index, sample))
    return out["ll"], out["kl_sep"]


def test_batches(test_u8: torch.Tensor, batch_size: int,
                 max_batches: Optional[int] = None):
    """Sequential sweep: ``(index, batch)`` pairs; the last batch may be
    short (eager PyTorch needs no padding to one compiled shape)."""
    n = test_u8.shape[0]
    for bi, start in enumerate(range(0, n, batch_size)):
        if max_batches is not None and bi >= max_batches:
            break
        stop = min(start + batch_size, n)
        index = torch.arange(start, stop, device=test_u8.device)
        yield index, test_u8[start:stop]


class EvalAccumulator:
    """On-device sums of ll / kl / elbo / per-layer kl and the image count
    (the carry of ``lvae_tpu``'s ``make_eval_accum_step``); the host reads
    them once, in :meth:`result`."""

    def __init__(self, n_layers: int, device):
        z = lambda *s: torch.zeros(s, dtype=torch.float64, device=device)  # noqa: E731
        self.ll, self.kl, self.elbo = z(), z(), z()
        self.kl_layers = z(n_layers)
        self.count = 0

    def add(self, ll: torch.Tensor, kl_sep: torch.Tensor) -> None:
        kl = kl_sep.sum(dim=0)
        self.ll += ll.sum(dtype=torch.float64)
        self.kl += kl.sum(dtype=torch.float64)
        self.elbo += (ll - kl).sum(dtype=torch.float64)
        self.kl_layers += kl_sep.sum(dim=1, dtype=torch.float64)
        self.count += ll.shape[0]

    def result(self, data_dims: int) -> dict:
        count = max(self.count, 1)
        m = {k: float(getattr(self, k)) / count for k in ("ll", "kl", "elbo")}
        m["kl_layers"] = self.kl_layers.cpu().numpy() / count
        m["bpd"] = -m["elbo"] / (data_dims * np.log(2.0))
        m["n_images"] = self.count
        return m


@torch.no_grad()
def evaluate_elbo(model, test_u8: torch.Tensor, preprocess: str,
                  batch_size: int, data_dims: int, seed: int = 0,
                  max_batches: Optional[int] = None) -> dict:
    """Test-set ELBO over the device-resident uint8 split ``test_u8``
    (NHWC), with the wall time of the sweep (synchronised)."""
    device = test_u8.device
    acc = EvalAccumulator(model.n_layers, device)
    t0 = time.perf_counter()
    for index, batch in test_batches(test_u8, batch_size, max_batches):
        x = eval_preprocess_batch(batch, preprocess, index)
        acc.add(*per_image_forward(model, x, index, seed))
    m = acc.result(data_dims)       # reads the sums back: waits for the device
    wall = time.perf_counter() - t0
    m["wall_s"] = wall
    m["images_per_sec"] = m["n_images"] / wall if wall > 0 else float("nan")
    return m
