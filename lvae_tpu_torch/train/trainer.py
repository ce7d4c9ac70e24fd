"""Kernel policy, the model factory, and the training loop (port of
``lvae_tpu/train/trainer.py``, the device-resident loop).

:class:`Experiment` owns the config, model, optimiser and the two splits
on the device; :class:`Trainer` runs the loop: an epoch order drawn from
``np.random.default_rng((seed, epoch))`` as ``lvae_tpu`` draws it (so both
see the same batches), one :func:`~lvae_tpu_torch.train.state.train_step`
per batch (or ``--steps-per-call k`` steps a call, a CUDA graph of ``k``
steps on the card), the log, test and checkpoint hooks where a call
crosses their intervals (the test hook writes the sample, reconstruction
and spatial-KL grids, :meth:`Experiment.dump_images`), and a final
checkpoint on SIGTERM. ``--grad-accum``, ``--remat``, ``--defer-metrics``,
``--debug-nans`` and ``--profile`` run as in ``lvae_tpu``.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional, Sequence

import numpy as np
import torch

from lvae_tpu_torch.config import PRECISIONS, EvalConfig, TrainConfig
from lvae_tpu_torch.data.device import DeviceDataset, eval_preprocess_batch
from lvae_tpu_torch.data.registry import Dataset, TestSet, load_dataset
from lvae_tpu_torch.eval.viz import save_image_grid
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.models.stochastic import Noise
from lvae_tpu_torch.train.checkpoint import CheckpointManager, save_config
from lvae_tpu_torch.train.init import data_dependent_init
from lvae_tpu_torch.train.logging import MetricLogger
from lvae_tpu_torch.train.state import (
    GradAccum,
    LossConfig,
    MultiStep,
    TrainState,
    evaluate_elbo,
    init_ema,
    make_optimizer,
    train_step,
)

FUSED_POLICIES = ("auto", "none", "stochastic", "mixture", "pallas",
                  "segments", "all")


def resolve_fused(policy: str, device: torch.device, train: bool = False,
                  likelihood: str = "bernoulli") -> dict:
    """Map ``--fused`` to the port's kernel switches, ``fused_stochastic``
    (the sample+KL kernels: K1 in training, K2 in eval, each with its
    backward kernel), ``fused_mixture`` (K3 and K3-bwd, the mixture head's
    log-prob) and ``fused_segments`` (K5 and K5-bwd, the train-mode
    dropout+BatchNorm+activation segments).

    - ``auto``: on CUDA, the sample+KL kernels, and K3 when the head is
      ``discretized_logistic_mix``; on the CPU, nothing. Never K5.
    - ``stochastic``: the sample+KL kernels, on any device.
    - ``mixture``: K3 (with a mixture head), on any device.
    - ``pallas``: both (``lvae_tpu``'s spelling), on any device.
    - ``segments``: K5 alone, in training.
    - ``all``: the three, K5 in training.
    - ``none``: the user's explicit choice of plain PyTorch.

    On the CPU a kernel's wrapper runs its plain version. A head other than
    the mixture gets ``fused_mixture=False``, as in
    ``lvae_tpu/train/trainer.py:87-97``. Evaluation runs BatchNorm on the
    running statistics whatever the policy, so ``fused_segments`` is set
    for training only. PROVISIONAL: ``auto``'s choices on CUDA (K2/K1 and
    K3 on, K5 off) are taken before any A/B of the port on the H100
    decided them (ROADMAP Queue 1); the TPU's measured policy is no
    evidence for them.
    """
    if policy not in FUSED_POLICIES:
        raise ValueError(f"unknown --fused {policy!r}; choose from {FUSED_POLICIES}")
    mixture_head = likelihood == "discretized_logistic_mix"
    if policy == "auto":
        on_cuda = torch.device(device).type == "cuda"
        return {"fused_stochastic": on_cuda, "fused_mixture": on_cuda and mixture_head,
                "fused_segments": False}
    return {"fused_stochastic": policy in ("stochastic", "pallas", "all"),
            "fused_mixture": mixture_head and policy in ("mixture", "pallas", "all"),
            "fused_segments": train and policy in ("segments", "all")}


def default_logsumexp(device: torch.device) -> str:
    """``--logsumexp`` when not given: the CUDA kernel on CUDA, the
    streaming accumulator elsewhere. PROVISIONAL, like ``resolve_fused``."""
    return "kernel" if torch.device(device).type == "cuda" else "streaming"


def make_model(cfg: EvalConfig, data: TestSet, device: torch.device,
               generator: torch.Generator | None = None,
               train: bool = False) -> LadderVAE:
    """The configured model on ``device``; ``generator`` draws the
    initial weights. ``train`` (with a :class:`TrainConfig`) adds the
    dropout, ``--remat`` and the kernel policy's training switches. ``--precision
    bf16`` makes the convs compute in bf16 (``lvae_tpu/train/trainer.py:115``);
    the parameters are fp32 either way."""
    drop = dict(dropout_rate=cfg.dropout, dropout_impl=cfg.dropout_impl,
                remat=cfg.remat) if train else {}
    likelihood = cfg.likelihood or data.default_likelihood
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
        likelihood=likelihood,
        batchnorm=cfg.batchnorm,
        bn_stat_samples=cfg.bn_stat_samples,
        nonlin=cfg.nonlin,
        res_block_type=cfg.residual_type,
        merge_type=cfg.merge_layers,
        resample_mode=cfg.resample_mode,
        conv_pad=cfg.conv_pad,
        no_initial_downscaling=cfg.no_initial_downscaling,
        dtype=PRECISIONS[cfg.precision],
        generator=generator,
        **drop,
        **resolve_fused(cfg.fused, device, train, likelihood),
    )
    return model.to(device)


class Experiment:
    """Config, model, optimiser and data (``lvae_tpu``'s ``Experiment``)."""

    def __init__(self, cfg: TrainConfig, device: torch.device,
                 data: Optional[Dataset] = None):
        self.cfg, self.device = cfg, torch.device(device)
        self.data = data if data is not None else load_dataset(cfg.dataset, cfg.data_dir)
        self.model = make_model(cfg, self.data, self.device,
                                generator=torch.Generator().manual_seed(cfg.seed),
                                train=True)
        self.loss_cfg = LossConfig(
            free_bits=cfg.freebits, beta_anneal_steps=cfg.beta_anneal,
            preprocess=self.data.preprocess, ema_decay=cfg.ema_decay,
            max_grad_norm=cfg.max_grad_norm,
        )
        self.train_data = DeviceDataset(self.data.train, self.device)
        self.test_data = torch.from_numpy(self.data.test).to(self.device)

    def init_state(self, data_dep_init: Optional[bool] = None) -> TrainState:
        """A fresh train state; ``data_dep_init`` (default: the config's)
        rescales the convs from the first ``batch_size`` train images,
        their noise and dropout keyed by seed + 2 as in ``lvae_tpu``."""
        cfg = self.cfg
        state = TrainState(step=0, model=self.model,
                           optimizer=make_optimizer(self.model, cfg.lr),
                           ema=init_ema(len(cfg.zdims), self.device), seed=cfg.seed + 1)
        if cfg.grad_accum > 1:
            state.accum = GradAccum(self.model.parameters(), cfg.grad_accum)
        if cfg.debug_nans:
            state.nan_step = torch.full((), -1, dtype=torch.int64, device=self.device)
        if cfg.data_dep_init if data_dep_init is None else data_dep_init:
            n = min(cfg.batch_size, self.train_data.n)
            index = torch.arange(n, device=self.device)
            x = eval_preprocess_batch(self.train_data.array[:n], self.data.preprocess, index)
            data_dependent_init(self.model, x, Noise(cfg.seed + 2, index, 0))
        return state

    def evaluate(self, state: TrainState, max_batches: Optional[int] = None) -> dict:
        """Test-set ELBO (eval mode, keyed per image: the same for any
        batch size)."""
        bs = min(self.cfg.test_batch_size, self.test_data.shape[0])
        return evaluate_elbo(state.model, self.test_data, self.data.preprocess, bs,
                             self.data.data_dims, max_batches=max_batches)

    def dump_images(self, state: TrainState, run_dir: str, step: int,
                    logger: Optional[MetricLogger] = None, n_samples: int = 64,
                    forced_eps: Optional[Sequence[torch.Tensor]] = None) -> dict:
        """:func:`dump_images` of the state's model on the test split."""
        return dump_images(state.model, self.test_data, self.data.preprocess, run_dir, step,
                           logger, n_samples, forced_eps)


def dump_images(model: LadderVAE, test_u8: torch.Tensor, preprocess: str, run_dir: str,
                step: int, logger: Optional[MetricLogger] = None, n_samples: int = 64,
                forced_eps: Optional[Sequence[torch.Tensor]] = None) -> dict:
    """The prior-sample, reconstruction and spatial-KL grids of
    ``lvae_tpu``'s ``Experiment.dump_images``
    (``lvae_tpu/train/trainer.py:292-356``) under ``<run_dir>/imgs``:
    ``sample_<step>.png``, ``n_samples`` prior samples drawn with seed
    ``step``; ``recon_<step>.png``, the first 32 images of the uint8 test
    split ``test_u8`` each beside its reconstruction (eval mode, keyed as
    the test sweep keys it, ``forced_eps`` replacing the draw), 8 a row;
    ``kl_spatial_<step>.png``, per layer the batch-mean KL at each location
    over its max (floor 1e-8), upsampled nearest to the largest map, a
    tile per layer. Returns the three grids by TensorBoard tag."""
    img_dir = os.path.join(run_dir, "imgs")
    with torch.no_grad():
        samples = model.sample_prior(n_samples, seed=step)["out_mean"]
        n = min(32, test_u8.shape[0])
        index = torch.arange(n, device=test_u8.device)
        x = eval_preprocess_batch(test_u8[:n], preprocess, index)
        out = model(x, noise=Noise(0, index, 0), forced_eps=forced_eps)
    grids = {"samples": save_image_grid(
        samples.float().cpu().numpy(), os.path.join(img_dir, f"sample_{step}.png"))}
    orig, recon = x.float().cpu().numpy(), out["out_mean"].float().cpu().numpy()
    pairs = np.stack([orig, recon], axis=1).reshape(-1, *orig.shape[1:])
    grids["reconstructions"] = save_image_grid(
        pairs, os.path.join(img_dir, f"recon_{step}.png"), ncol=8)
    maps = kl_spatial_tiles(out["kl_spatial"])
    grids["kl_spatial"] = save_image_grid(
        maps, os.path.join(img_dir, f"kl_spatial_{step}.png"), ncol=len(maps), pad_value=1.0)
    if logger is not None:
        for tag, grid in grids.items():
            logger.log_images(tag, step, grid)
    return grids


def kl_spatial_tiles(kl_spatial: Sequence[Optional[torch.Tensor]]) -> np.ndarray:
    """``[L, H, W, 1]``: each layer's ``[B, h, w]`` KL map averaged over
    the batch, divided by its max (floor 1e-8) and repeated nearest to the
    largest map's ``H x W``. Every layer must have its map: an eval-mode
    forward gives one for each."""
    if any(k is None for k in kl_spatial):
        raise ValueError("kl_spatial has no map for a layer: take it from an eval-mode "
                         "forward, which gives one for every layer")
    hmax = max(k.shape[1] for k in kl_spatial)
    wmax = max(k.shape[2] for k in kl_spatial)
    maps = []
    for k in kl_spatial:
        mm = k.float().cpu().numpy().mean(axis=0)
        mm = mm / max(mm.max(), 1e-8)
        mm = np.repeat(np.repeat(mm, hmax // mm.shape[0], 0), wmax // mm.shape[1], 1)
        maps.append(mm[..., None])
    return np.stack(maps)


class Trainer:
    """The train loop (``lvae_tpu``'s ``Trainer``): ``--steps-per-call k``
    runs the steps ``k`` at a time (:class:`~lvae_tpu_torch.train.state.
    MultiStep`, one CUDA graph of ``k`` steps on the card), and SIGTERM
    ends the run with a final checkpoint, as ``lvae_tpu``'s does."""

    def __init__(self, experiment: Experiment):
        self.exp = experiment
        self.cfg = experiment.cfg
        self.logger: Optional[MetricLogger] = None
        self.run_dir: Optional[str] = None
        self.state: Optional[TrainState] = None

    def run(self) -> TrainState:
        """Run training to ``max_steps``. SIGTERM (preemption, job
        schedulers) is mapped to the KeyboardInterrupt path for the run,
        as ``lvae_tpu/train/trainer.py:387-409`` maps it: the signal is
        noted, the loop stops at the next k-step boundary (a step whose
        updates are in place is never cut in two) and the final checkpoint
        holds the state the device reached there, so ``--auto-resume``
        continues it exactly."""
        self._stop = False

        def _note(signum, frame):
            self._stop = True

        try:
            prev = signal.signal(signal.SIGTERM, _note)
            installed = True
        except ValueError:      # not the main thread: leave signals alone
            installed = False
        try:
            return self._run()
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev or signal.SIG_DFL)

    def _run(self) -> TrainState:
        cfg, exp = self.cfg, self.exp
        run_dir = self.run_dir = os.path.join(cfg.output_dir, cfg.make_run_name())
        logger = self.logger = MetricLogger(run_dir, enable_tb=not cfg.dry_run)
        ckpt = None
        if not cfg.dry_run:
            os.makedirs(run_dir, exist_ok=True)
            ckpt = CheckpointManager(run_dir, keep=cfg.keep_checkpoints)
        resume = ckpt is not None and cfg.auto_resume and ckpt.latest_step() is not None
        state = exp.init_state(data_dep_init=False if (cfg.load or resume) else None)
        try:
            if cfg.load:
                load_dir = cfg.load if os.path.isdir(cfg.load) else os.path.join(
                    cfg.output_dir, cfg.load)
                state = CheckpointManager(load_dir).restore(state)
                print(f"resumed from {load_dir} at step {state.step}", flush=True)
            elif resume:
                state = ckpt.restore(state)
                print(f"auto-resumed {run_dir} at step {state.step}", flush=True)
        finally:
            if not cfg.dry_run:
                save_config(run_dir, cfg)

        k = cfg.steps_per_call
        if k > 1 and cfg.max_steps % k:
            # the loop checks max_steps only between k-step calls
            print(f"warning: max_steps {cfg.max_steps} is not a multiple of "
                  f"steps-per-call {k}; the run will stop at step "
                  f"{-(-cfg.max_steps // k) * k}", flush=True)
        n_params = sum(p.numel() for p in state.model.parameters())
        print(f"run {os.path.basename(run_dir)}: {exp.train_data.n} train / "
              f"{exp.test_data.shape[0]} test images on {exp.device}, "
              f"{n_params:,} params", flush=True)
        if cfg.batch_size > exp.train_data.n:
            raise ValueError(
                f"batch_size {cfg.batch_size} exceeds the training set "
                f"({exp.train_data.n} images): an epoch would yield no batch"
            )
        # after any restore: a graph holds the addresses of what it replaces
        multi = MultiStep(state, exp.train_data.gather, exp.loss_cfg, k) if k > 1 else None

        step = state.step
        t_last, since_log = time.perf_counter(), 0
        in_step = False
        profile = Profile(cfg, run_dir, exp.device)
        try:
            for index in index_stream(exp.train_data, cfg.batch_size, cfg.seed, step, k):
                if self._stop:
                    raise KeyboardInterrupt
                if step >= cfg.max_steps:
                    break
                profile.before(step)
                in_step = True
                if multi is None:
                    train_step(state, exp.train_data.gather(index), index, exp.loss_cfg)
                else:
                    multi(index)
                in_step = False
                step = state.step
                since_log += k
                if state.nan_step is not None and int(state.nan_step) >= 0:
                    raise FloatingPointError(
                        f"--debug-nans: a NaN in the loss, the gradients or the updated "
                        f"parameters of step {int(state.nan_step)}; no checkpoint of this "
                        f"state is saved")
                profile.after(step)
                if crossed(step, cfg.log_interval, k):
                    if cfg.defer_metrics:     # no readback: a dispatch rate
                        dt = time.perf_counter() - t_last
                        logger.log_deferred(step, since_log * cfg.batch_size / dt)
                    else:
                        ema = {k_: v.cpu() for k_, v in state.ema.items()}  # waits for the step
                        dt = time.perf_counter() - t_last
                        logger.log_train(step, ema, since_log * cfg.batch_size / dt)
                    t_last, since_log = time.perf_counter(), 0
                if crossed(step, cfg.test_interval, k):
                    logger.log_test(step, exp.evaluate(state))
                    if not cfg.dry_run:
                        exp.dump_images(state, run_dir, step, logger)
                    t_last, since_log = time.perf_counter(), 0
                if ckpt is not None and crossed(step, cfg.checkpoint_interval, k):
                    ckpt.save(state)
        except KeyboardInterrupt:
            if in_step:     # cut inside a step: its updates are partly in place
                print("interrupted inside a step: no final checkpoint (the last "
                      "periodic one stands)", flush=True)
                ckpt = None
            else:
                print("interrupted: saving a final checkpoint", flush=True)
        finally:
            profile.close()
        if state.step_t is not None and state.step_t.is_cuda:
            torch.cuda.synchronize(state.step_t.device)
        if cfg.defer_metrics:
            logger.log_train(state.step, {k_: v.cpu() for k_, v in state.ema.items()})
        if ckpt is not None and ckpt.latest_step() != state.step:
            ckpt.save(state)
        logger.close()
        self.state = state
        return state


class Profile:
    """``--profile A-B``: a ``torch.profiler`` trace (the host, and the
    card where the run is on one) from the first call at or after step A
    to the first call that reaches B, written as a Chrome trace under
    ``<run>/trace``, as ``lvae_tpu`` writes its trace
    (``lvae_tpu/train/trainer.py:626-644``). A no-op without the flag."""

    def __init__(self, cfg: TrainConfig, run_dir: str, device: torch.device):
        self.range = cfg.profile_range() if cfg.profile else None
        self.dir = os.path.join(run_dir, "trace")
        self.device = device
        self.prof = None

    def before(self, step: int) -> None:
        if self.range is None or self.prof is not None or step < self.range[0]:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def after(self, step: int) -> None:
        if self.prof is None or step < self.range[1]:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.close()
        a, b = self.range
        print(f"profiler trace for steps {a}-{b} written to {self.dir}", flush=True)
        self.range = None

    def close(self) -> None:
        """Stop a running trace and write it (also at a run's end or
        interruption inside the range)."""
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.dir, f"trace_{os.getpid()}.json"))


def index_stream(data: DeviceDataset, batch_size: int, seed: int, step: int, k: int = 1):
    """Endless device index batches from ``step`` on: ``[batch_size]``
    vectors for ``k = 1``, ``[k, batch_size]`` stacks of ``k`` consecutive
    batches otherwise, a stack straddling an epoch's end where it falls
    there. Epoch e's shuffle is ``np.random.default_rng((seed, e))``'s, as
    ``lvae_tpu`` draws it, and the stream starts at ``step``, so a resumed
    run (at any step, a multiple of ``k`` or not) takes the batches that an
    uninterrupted one takes (``lvae_tpu/train/trainer.py:570-593``)."""
    steps_per_epoch = data.n // batch_size
    epoch, pos = divmod(step, steps_per_epoch)
    buf = []
    while True:
        erng = np.random.default_rng((seed, epoch))
        for bi, idx in enumerate(data.epoch_indices(erng, batch_size)):
            if bi < pos:
                continue
            if k == 1:
                yield idx
            else:
                buf.append(idx)
                if len(buf) == k:
                    yield torch.stack(buf)
                    buf = []
        pos = 0
        epoch += 1


def crossed(step: int, interval: int, k: int = 1) -> bool:
    """Whether a call that ended at ``step`` after ``k`` steps passed a
    multiple of ``interval``."""
    return (step // interval) > ((step - k) // interval)
