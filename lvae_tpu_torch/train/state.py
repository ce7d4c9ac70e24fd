"""The train step and the test-ELBO sweep (port of ``lvae_tpu/train/state.py``).

Training: :class:`TrainState` holds the step, the model, its Adamax
optimiser, the metric EMA (on the device) and the noise seed;
:func:`train_body` preprocesses a gathered uint8 batch, runs the forward
in train mode, takes ``lvae_tpu``'s loss (``-(mean ll - beta * sum of the
free-bits-clamped per-layer KL)``), backpropagates, clips by optax's
global-norm rule when asked, steps Adamax (under ``--grad-accum k``, on
the mean of k micro-steps' gradients, :class:`GradAccum`) and moves the
EMA, all on the device with no host sync; :func:`train_step` runs it once and
:class:`MultiStep` ``k`` times a call (on CUDA, as one CUDA graph). Every
random draw of step ``s`` is keyed by ``(seed, dataset index, s,
stream)`` or ``(seed, s, dropout site)``, with ``s`` read from the
device, so a step depends on nothing but its number: a resumed run
repeats an uninterrupted one.

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
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from lvae_tpu_torch.data.device import eval_preprocess_batch, preprocess_batch
from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.models.stochastic import Noise
from lvae_tpu_torch.ops.math import free_bits_kl, linear_anneal
from lvae_tpu_torch.ops.philox import Ints


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
    the training noise (``lvae_tpu`` keys ``state.rng`` with seed + 1).

    ``step`` is the host's count of the steps enqueued; the step body
    reads the step from :meth:`device_step`, its copy on the device."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema: dict
    seed: int
    accum: Optional["GradAccum"] = None     # --grad-accum k > 1
    # --debug-nans: the first step whose loss, gradients or updated
    # parameters held a NaN (-1: none yet), written on the device
    nan_step: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    step_t: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    step_t_at: Optional[int] = dataclasses.field(default=None, repr=False)

    def device_step(self) -> torch.Tensor:
        """The step as a 0-d int64 tensor on the model's device: one tensor
        for the run, which every step reads (its keys, beta, the EMA's
        first step) and moves on in place, so a CUDA graph of the steps
        holds its address. ``step_t_at`` is the count it holds once the
        enqueued work has run; where ``step`` moved without it (a restore),
        it is written from ``step``."""
        device = next(self.model.parameters()).device
        if self.step_t is None or self.step_t.device != device:
            self.step_t = torch.zeros((), dtype=torch.int64, device=device)
            self.step_t_at = None
        if self.step_t_at != self.step:
            self.step_t.fill_(self.step)
            self.step_t_at = self.step
        return self.step_t

    def advance(self, n: int) -> None:
        """Count ``n`` enqueued steps, which move the device step too."""
        self.step += n
        self.step_t_at = self.step


class Adamax(torch.optim.Optimizer):
    """``optax.adamax`` (the reference's optimiser) with no host sync: each
    parameter's step count is a tensor on its device, the bias correction
    is computed there, and the update is ``_foreach`` ops, so the eager
    step and a CUDA graph of it launch the same kernels. (``torch.optim.
    Adamax`` reads the step on the host unless ``capturable=True``, which
    it refuses on the CPU.) The update is torch's capturable form, ``p +=
    exp_avg / (exp_inf (b1^t - 1) / lr)``. The state has torch's keys
    (``step``, ``exp_avg``, ``exp_inf``), so checkpoints load across."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for group in self.param_groups:       # the step beside its parameter
            for p in group["params"]:
                st = self.state.get(p)
                if st and "step" in st:
                    st["step"] = st["step"].to(device=p.device, dtype=torch.float32)

    @torch.no_grad()
    def step(self, closure=None, emit: Optional[torch.Tensor] = None):
        """One Adamax update of every parameter with a gradient. ``emit``
        (a 0-d bool tensor, :class:`GradAccum`'s) makes it the inner
        optimiser of ``optax.MultiSteps``: the update is computed from
        the count plus one, as optax's, and applied as ``p + emit * u``;
        the moments and the count take their new values only where
        ``emit`` is set, selected on the device as ``(1 - emit) old +
        emit new``."""
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_inf"] = torch.zeros_like(p)
            steps, avgs, infs = ([self.state[p][k] for p in params]
                                 for k in ("step", "exp_avg", "exp_inf"))
            grads = [p.grad for p in params]
            b1, b2 = group["betas"]
            if emit is None:
                new_steps, new_avgs, new_infs = steps, avgs, infs
                torch._foreach_add_(steps, 1.0)
                torch._foreach_lerp_(avgs, grads, 1.0 - b1)
                torch._foreach_mul_(infs, b2)
            else:
                new_steps = torch._foreach_add(steps, 1.0)
                new_avgs = torch._foreach_lerp(avgs, grads, 1.0 - b1)
                new_infs = torch._foreach_mul(infs, b2)
            norms = torch._foreach_abs(grads)
            torch._foreach_add_(norms, group["eps"])
            torch._foreach_maximum_(new_infs, norms)
            corr = torch._foreach_pow(b1, new_steps)       # b1^t - 1, over lr
            torch._foreach_sub_(corr, 1.0)
            torch._foreach_div_(corr, group["lr"])
            if emit is None:
                torch._foreach_addcdiv_(params, avgs, torch._foreach_mul(infs, corr))
                continue
            e = emit.to(torch.float32)
            upd = torch._foreach_div(new_avgs, torch._foreach_mul(new_infs, corr))
            torch._foreach_mul_(upd, e)
            torch._foreach_add_(params, upd)
            keep = 1.0 - e
            for old, new in ((steps, new_steps), (avgs, new_avgs), (infs, new_infs)):
                torch._foreach_mul_(old, keep)
                torch._foreach_mul_(new, e)
                torch._foreach_add_(old, new)


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Optimizer:
    """Adamax with ``optax.adamax``'s settings (betas 0.9, 0.999; eps 1e-8),
    the reference's optimiser."""
    return Adamax(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


class GradAccum:
    """``optax.MultiSteps(every_k_schedule=k)`` around the clip and Adamax
    (``lvae_tpu/train/state.py:49-65``), with no host sync. Each
    micro-step folds its gradients into the running mean ``acc + (g -
    acc) / (n + 1)`` (``n`` the micro-step, a 0-d int64 tensor on the
    device); the clip and Adamax then run on the mean (:meth:`inner`) and
    take effect on the ``k``-th micro-step only (``emit``); the
    accumulator is multiplied by ``1 - emit`` and ``n`` moves to ``(n +
    1) % k``. The train step, its keys, beta and the EMA move on every
    micro-step, as flax's ``TrainState.step`` does. The accumulator and
    ``n`` are checkpointed (:meth:`state_dict`), so a resume inside an
    accumulation is exact."""

    def __init__(self, params: Sequence[torch.Tensor], k: int):
        if k < 2:
            raise ValueError(f"GradAccum accumulates k >= 2 micro-steps, got {k}")
        self.k = k
        self.params = list(params)
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = torch.zeros((), dtype=torch.int64, device=self.params[0].device)

    @torch.no_grad()
    def inner(self, clone: bool) -> torch.Tensor:
        """Fold this micro-step's gradients (a missing one as zeros, as
        optax sees it) into the mean and hand the mean to the inner
        optimiser as every parameter's ``.grad`` (a copy when ``clone``:
        the clip rewrites it in place). Returns ``emit``."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, (self.mini_step + 1).to(self.acc[0].dtype))
        torch._foreach_add_(self.acc, delta)
        for p, a in zip(self.params, self.acc):
            p.grad = a.clone() if clone else a
        return self.mini_step == self.k - 1

    @torch.no_grad()
    def finish(self, emit: torch.Tensor) -> None:
        """After the inner update: the accumulator to ``(1 - emit) acc``,
        the micro-step on."""
        torch._foreach_mul_(self.acc, 1.0 - emit.to(self.acc[0].dtype))
        self.mini_step.copy_((self.mini_step + 1) % self.k)

    def state_dict(self) -> dict:
        return {"k": self.k, "mini_step": self.mini_step.detach().cpu(),
                "acc": [a.detach().cpu() for a in self.acc]}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        """In place, so the tensors keep their addresses."""
        if int(d["k"]) != self.k:
            raise ValueError(f"the checkpoint accumulates over --grad-accum {int(d['k'])}, "
                             f"this run over {self.k}")
        self.mini_step.copy_(d["mini_step"])
        for a, v in zip(self.acc, d["acc"], strict=True):
            a.copy_(v)


def init_ema(n_layers: int, device) -> dict:
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return {"elbo": z(), "ll": z(), "kl": z(), "loss": z(), "kl_layers": z(n_layers)}


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: where the global norm is
    not below ``max_norm``, every gradient becomes ``(g / norm) * max_norm``
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``), chosen on the
    device (``torch.where``, optax's select), with no host sync. Returns
    the norm."""
    grads = list(grads)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    clipped = torch._foreach_div(grads, norm)
    torch._foreach_mul_(clipped, max_norm)
    for g, c in zip(grads, clipped):
        g.copy_(torch.where(keep, g, c))
    return norm


def loss_terms(model, x: torch.Tensor, noise: Optional[Noise], beta,
               free_bits: float, forced_eps=None):
    """``(loss, metrics)`` of ``lvae_tpu``'s train loss on a preprocessed
    NHWC batch, the model in train mode (``beta`` a float or a 0-d
    tensor)."""
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


@torch.no_grad()
def update_ema_(ema: dict, metrics: dict, step: Ints, decay: float) -> None:
    """``ema = decay ema + (1 - decay) metric`` in place (the tensors keep
    their addresses), initialised to the metrics at step 0 as in
    ``lvae_tpu``: a host branch for an int step, ``torch.where`` for a
    tensor."""
    for k, m in metrics.items():
        e = ema[k]
        m = m.to(e.dtype)
        moved = decay * e + (1.0 - decay) * m
        if isinstance(step, torch.Tensor):
            e.copy_(torch.where(step == 0, m, moved))
        else:
            e.copy_(m if step == 0 else moved)


def train_body(state: TrainState, batch_u8: torch.Tensor, index: torch.Tensor,
               cfg: LossConfig, step: Ints, forced_eps=None) -> dict:
    """Train step number ``step`` on the uint8 NHWC batch of dataset rows
    ``index``: preprocess, forward in train mode, backward, clip, Adamax,
    EMA; returns its metrics (device tensors). ``step`` is an int or a 0-d
    int64 tensor on the device; from a tensor every key (the
    preprocessing's, the latents', the dropout masks') and beta are
    computed on the device, so the body reads no host int that changes
    with the step and makes no host sync: the eager step and a CUDA graph
    of it run the same kernels. Moves neither ``step`` nor
    ``state.step``. ``forced_eps`` (per-layer NHWC) replaces the latent
    draw."""
    model = state.model
    dtype = next(model.parameters()).dtype
    x = preprocess_batch(batch_u8, cfg.preprocess, state.seed, index, step).to(dtype)
    beta = linear_anneal(step, 0.0, 1.0, cfg.beta_anneal_steps)
    loss, metrics = loss_terms(model, x, Noise(state.seed, index, step), beta,
                               cfg.free_bits, forced_eps)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    emit = None
    if state.accum is not None:
        emit = state.accum.inner(clone=cfg.max_grad_norm is not None)
    if cfg.max_grad_norm is not None:
        clip_by_global_norm_([p.grad for p in model.parameters() if p.grad is not None],
                             cfg.max_grad_norm)
    state.optimizer.step(emit=emit)
    if emit is not None:
        state.accum.finish(emit)
    metrics = {k: v.detach() for k, v in metrics.items()}
    if state.nan_step is not None:
        _note_nan(state.nan_step, step, metrics["loss"], grads, list(model.parameters()))
    update_ema_(state.ema, metrics, step, cfg.ema_decay)
    return metrics


@torch.no_grad()
def _note_nan(nan_step: torch.Tensor, step: Ints, loss: torch.Tensor,
              grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor]) -> None:
    """``--debug-nans``: write ``step`` into ``nan_step`` where it holds
    no step yet and the loss, a gradient of this (micro-)step or an
    updated parameter holds a NaN (a NaN anywhere makes its tensor's norm
    NaN), on the device."""
    bad = torch.isnan(loss)
    for ts in (grads, params):
        if ts:
            bad = bad | torch.isnan(torch.stack(torch._foreach_norm(ts)).sum())
    nan_step.copy_(torch.where(bad & (nan_step < 0), step, nan_step))


def train_step(state: TrainState, batch_u8: torch.Tensor, index: torch.Tensor,
               cfg: LossConfig, forced_eps=None) -> dict:
    """One optimiser step (:func:`train_body` at the state's device step,
    which it then moves on); returns the step's metrics (device tensors,
    no host sync)."""
    step = state.device_step()
    metrics = train_body(state, batch_u8, index, cfg, step, forced_eps)
    step.add_(1)
    state.advance(1)
    return metrics


class MultiStep:
    """``k`` train steps per call, the port's ``make_multi_train_step``:
    ``index`` a ``[k, B]`` stack of dataset rows for steps ``state.step``
    to ``state.step + k - 1``; returns the last step's metrics (the EMA
    sees every step).

    On the CPU, :func:`train_step` ``k`` times. On CUDA the first call
    runs its ``k`` steps eagerly on a side stream (the warm-up: it builds
    the kernels, fills every cache a step consults and, where the run
    starts at 0, initialises the EMA) and then captures ``k`` steps of
    :func:`train_body` into one CUDA graph; each later call copies its
    indices into the graph's static ``[k, B]`` buffer and replays the
    graph. The graph reads the step from ``state.device_step()``, moves it
    on in place, and computes every key from it, so a replay is the work
    of ``k`` eager steps, kernel for kernel; the returned metrics are the
    graph's outputs, written anew by each replay. A capture that fails
    raises: nothing falls back to eager steps.

    Build it after any restore: the graph holds the addresses of the
    parameters, the optimiser's state and the EMA, which a restore
    replaces. The kernel wrappers' launch counts (``build.LAUNCHES``) count
    what runs: the capture's calls record launches without running them
    and are taken back out, and each replay adds the launches the graph
    holds (``self.launches``). The captured ``cudaGraph_t`` is kept, so
    its kernel nodes can be read (``self.graph.raw_cuda_graph()``)."""

    def __init__(self, state: TrainState, gather: Callable, cfg: LossConfig, k: int):
        if k < 2:
            raise ValueError(f"MultiStep takes k >= 2 steps a call, got {k}")
        self.state, self.gather, self.cfg, self.k = state, gather, cfg, k
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.index: Optional[torch.Tensor] = None
        self.metrics: Optional[dict] = None
        self.launches: dict = {}

    def __call__(self, index: torch.Tensor) -> dict:
        if index.dim() != 2 or index.shape[0] != self.k:
            raise ValueError(f"index must be [{self.k}, B], got {tuple(index.shape)}")
        state = self.state
        if state.device_step().device.type != "cuda":
            return self._eager(index)
        if self.graph is None:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                metrics = self._eager(index)
            torch.cuda.current_stream().wait_stream(side)
            self._capture(index)
            return metrics
        self.index.copy_(index)
        self.graph.replay()
        for name, n in self.launches.items():
            build.LAUNCHES[name] += n
        state.advance(self.k)
        return self.metrics

    def _eager(self, index: torch.Tensor) -> dict:
        for row in index:
            metrics = train_step(self.state, self.gather(row), row, self.cfg)
        return metrics

    def _capture(self, index: torch.Tensor) -> None:
        step = self.state.device_step()
        self.index = torch.empty_like(index)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = dict(build.LAUNCHES)
        with torch.cuda.graph(graph):
            for row in self.index:
                metrics = train_body(self.state, self.gather(row), row, self.cfg, step)
                step.add_(1)
        self.launches = {k: n - before[k] for k, n in build.LAUNCHES.items() if n > before[k]}
        build.LAUNCHES.update(before)
        graph.instantiate()
        self.graph, self.metrics = graph, metrics


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
