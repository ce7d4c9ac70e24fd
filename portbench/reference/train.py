"""The reference train step and IW-LL, in plain fp32 PyTorch.

Train step ``s`` on uint8 NHWC rows ``index``: dequantise with keyed
uniform noise ``(u8 + u) / 256`` (``u`` keyed ``(seed, index, s,
STREAM_TRAIN_DEQUANTIZE)``), the forward in training with latents keyed
``(seed, index, s, layer)`` and dropout ``(seed, s, site)``, the loss
``-(mean ll - sum over layers of max(mean KL, free bits))``, its
gradient, and optax's Adamax (b1 0.9, b2 0.999, eps 1e-8):
``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g| + eps)``, ``p -= lr m /
((1 - b1^t) u)``; then the metrics' EMA ``e = d e + (1 - d) metric``,
``e`` the metric itself at step 0. BatchNorm moves its running statistics
in each training forward (:mod:`portbench.reference.model`).

IW-LL of an image: ``logsumexp_j(ll_j - kl_j) - log k`` over ``k``
posterior samples, sample ``j`` keyed ``(seed, index, j, layer)``, the
input the bin centre ``(u8 + 0.5) / 256``, BatchNorm on its running
statistics.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch

from portbench.reference.model import LadderVAE, ladder
from portbench.reference.philox import STREAM_TRAIN_DEQUANTIZE, keyed_uniform


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """fp32 convolutions and matmuls in full fp32 (``tf32=False``) or in
    TF32 (the control), restored on exit."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def build(config: dict, weights: Dict[str, torch.Tensor], device) -> LadderVAE:
    """The reference model of a configuration file's ladder and ``data``
    group, with ``weights`` (every parameter and BatchNorm
    statistic, by name) loaded."""
    m, d = config["model"], config["data"]
    implemented = {"skip": True, "gated": True, "learn_top_prior": True}
    if any(m.get(k) != v for k, v in implemented.items()) or (
            d["likelihood"] != "discretized_logistic_mix" or d["color_ch"] != 3
            or tuple(d["img_size"]) != tuple(d["padded_size"])):
        raise ValueError("the reference implements gated blocks, the stochastic skip, a "
                         "learned top prior and the RGB mixture head at the padded size")
    a = ladder(config)
    model = LadderVAE(d["color_ch"], a["zdims"], a["downsample"], a["blocks_per_layer"],
                      a["n_filters"], d["img_size"], config["train"]["dropout"])
    model.load_state_dict(weights, strict=False)
    missing = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")} - set(
        weights)
    if missing:
        raise KeyError(f"no weights for {sorted(missing)[:5]}")
    return model.to(device)


def loss_terms(model: LadderVAE, u8: torch.Tensor, index: torch.Tensor, seed: int,
               step: int, free_bits: float):
    """``(loss, metrics)`` of train step ``step`` on rows ``index`` (uint8
    NHWC): the metrics are the ones the program's EMA follows."""
    u = keyed_uniform(u8.shape, seed, index, step, STREAM_TRAIN_DEQUANTIZE)
    x = (u8.to(torch.float32) + u) / 256.0
    ll, kl = model(x, (seed, index, step), train=True, step=step)
    ll_mean, kl_layers, kl_mean = ll.mean(), kl.mean(dim=1), kl.sum(dim=0).mean()
    value = -(ll_mean - torch.clamp_min(kl_layers, free_bits).sum())
    metrics = {"elbo": ll_mean - kl_mean, "ll": ll_mean, "kl": kl_mean, "loss": value,
               "kl_layers": kl_layers}
    return value, {k: v.detach() for k, v in metrics.items()}


def train_steps(model: LadderVAE, batches: Sequence, seed: int, free_bits: float, lr: float,
                ema_decay: float, observed: int) -> dict:
    """Steps ``0 .. n-1`` on ``batches`` ``[(u8, index), ...]``: each step's
    loss, the first step's gradients by parameter name, the parameters
    after step ``observed``, and after the last step (``end``) the
    parameters, the metrics' EMA (float64) and the BatchNorm running
    statistics."""
    params = dict(model.named_parameters())
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    u = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses: List[float] = []
    first = after = None
    ema: Dict[str, torch.Tensor] = {}
    for step, (u8, index) in enumerate(batches):
        model.zero_grad(set_to_none=True)
        value, metrics = loss_terms(model, u8, index, seed, step, free_bits)
        value.backward()
        losses.append(float(metrics["loss"]))
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            corr = lr / (1.0 - b1 ** (step + 1))
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                u[k] = torch.maximum(b2 * u[k], g.abs() + eps)
                p.sub_(corr * m[k] / u[k])
        for k, v in metrics.items():
            v = v.double()
            ema[k] = v if step == 0 else ema_decay * ema[k] + (1.0 - ema_decay) * v
        if step + 1 == observed:
            after = {k: p.detach().clone() for k, p in params.items()}
    snapshot = lambda ts: {k: t.detach().clone() for k, t in ts}  # noqa: E731
    return {"losses": losses, "grads": first, "params": after,
            "end": {"params": snapshot(params.items()), "ema": ema,
                    "bn": snapshot((k, b) for k, b in model.named_buffers()
                                   if "running_" in k)}}


@torch.no_grad()
def iwll(model: LadderVAE, u8: torch.Tensor, index: torch.Tensor, seed: int, k: int,
         chunk: int) -> torch.Tensor:
    """Per-image IW-LL ``[B]`` (fp32), ``chunk`` samples a forward."""
    model.eval()
    x = (u8.to(torch.float32) + 0.5) / 256.0
    b = x.shape[0]
    elbos = []
    for j0 in range(0, k, chunk):
        c = min(chunk, k - j0)
        sample = torch.arange(j0, j0 + c, device=x.device).repeat_interleave(b)
        ll, kl = model(x.repeat(c, 1, 1, 1), (seed, index.repeat(c), sample))
        elbos.append((ll - kl.sum(dim=0)).view(c, b))
    return torch.logsumexp(torch.cat(elbos), dim=0) - math.log(k)


def flops(model: LadderVAE, u8: torch.Tensor, train: bool) -> float:
    """FLOPs an image that ``FlopCounterMode`` counts (convolutions and
    matmuls) over one reference train step, forward and backward
    (``train``), or one evaluation forward, on the rows ``u8``."""
    from torch.utils.flop_counter import FlopCounterMode

    index = torch.arange(u8.shape[0], device=u8.device)
    with FlopCounterMode(display=False) as counter:
        if train:
            loss_terms(model, u8, index, 1, 0, 0.5)[0].backward()
        else:
            with torch.no_grad():
                model.eval()
                model((u8.to(torch.float32) + 0.5) / 256.0, (1, index, 0))
    model.zero_grad(set_to_none=True)
    return float(counter.get_total_flops()) / u8.shape[0]
