"""Configuration and the training CLI's flags (port of ``lvae_tpu/config.py``).

:class:`EvalConfig` holds the fields the evaluation and serving path
reads. A run's ``config.json`` (``lvae_tpu``'s or this port's trainer's)
loads through :func:`config_from_dict`, which drops the train-only fields
unread: they are neither stored nor validated there, so a stored train
batch size can never block an evaluation. ``bn_stat_samples`` is kept (the
model takes it) but validated only for training: evaluation normalises
with the running statistics whatever its value. :class:`TrainConfig` adds the
training fields, validated as ``lvae_tpu`` validates them; what the port
does not run is rejected with its flag named.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence, Tuple

import torch

# Values the port does not run yet; each names the flag it came from.
_LATER = "a later PR of the port"
# lvae_tpu/models/likelihoods.py:LIKELIHOODS, all four ported
LIKELIHOODS = ("bernoulli", "gaussian", "discretized_logistic", "discretized_logistic_mix")
# --precision -> the convolutions' compute dtype (lvae_tpu/train/trainer.py:115):
# bf16 convs from fp32 parameters; everything else stays fp32
PRECISIONS = {"fp32": None, "bf16": torch.bfloat16}


@dataclasses.dataclass
class EvalConfig:
    # data
    dataset: str = "static_mnist"
    data_dir: str = "./data"
    test_batch_size: int = 1000
    # model
    zdims: Tuple[int, ...] = (32, 32, 32)
    downsample: Tuple[int, ...] = (1, 1, 1)
    blocks_per_layer: int = 2
    n_filters: int = 64
    skip: bool = False
    gated: bool = False
    learn_top_prior: bool = False
    no_initial_downscaling: bool = False
    nonlin: str = "elu"
    residual_type: str = "bacdbacd"
    merge_layers: str = "residual"
    resample_mode: str = "conv"
    conv_pad: str = "same"
    skip_merge: str = "pre"
    batchnorm: bool = True
    bn_stat_samples: int = 0
    likelihood: Optional[str] = None  # None -> dataset default
    precision: str = "fp32"
    # kernels and devices
    fused: str = "auto"
    spatial_shards: int = 1

    def __post_init__(self):
        self.zdims = tuple(self.zdims)
        self.downsample = tuple(self.downsample)
        if len(self.downsample) != len(self.zdims):
            if self.downsample == (1, 1, 1):
                self.downsample = (1,) * len(self.zdims)
            elif len(self.downsample) == 1:
                self.downsample = self.downsample * len(self.zdims)
            else:
                raise ValueError(
                    f"--downsample needs one entry per stochastic layer: got "
                    f"{len(self.downsample)} entries for {len(self.zdims)} zdims"
                )
        if not self.zdims:
            raise ValueError("--zdims needs at least one stochastic layer")
        if any(z < 1 for z in self.zdims):
            raise ValueError(f"--zdims entries must be >= 1, got {self.zdims}")
        for name, v in (("blocks-per-layer", self.blocks_per_layer),
                        ("n-filters", self.n_filters),
                        ("test-batch-size", self.test_batch_size),
                        ("spatial-shards", self.spatial_shards)):
            if v < 1:
                raise ValueError(f"--{name} must be >= 1, got {v}")
        for ds in self.downsample:
            if ds < 0:
                raise ValueError(
                    f"--downsample entries must be >= 0, got {self.downsample}"
                )
            if ds > self.blocks_per_layer:
                raise ValueError(
                    f"--downsample {ds} exceeds --blocks-per-layer "
                    f"{self.blocks_per_layer}: a layer can resample at most "
                    f"once per block"
                )
        if self.likelihood not in (None, *LIKELIHOODS):
            raise ValueError(
                f"--likelihood {self.likelihood}: unknown head; choose from "
                f"{LIKELIHOODS}"
            )
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"--precision {self.precision}: choose from {tuple(PRECISIONS)}"
            )
        # what the port does not run, each rejected with its flag named
        if self.spatial_shards > 1:
            raise ValueError(
                f"--spatial-shards {self.spatial_shards} is not supported by "
                f"the port (single-GPU eval only)"
            )


def config_from_dict(d: dict) -> EvalConfig:
    """Build an :class:`EvalConfig` from a saved ``config.json``; fields
    this slice does not read (optimizer, schedule, logging...) are
    ignored."""
    names = {f.name for f in dataclasses.fields(EvalConfig)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue
        if isinstance(v, list):
            v = tuple(v)
        if v == "None":
            v = None
        kwargs[k] = v
    return EvalConfig(**kwargs)


@dataclasses.dataclass
class TrainConfig(EvalConfig):
    """The training fields of ``lvae_tpu/config.py:ExperimentConfig``."""

    batch_size: int = 64
    dropout: float = 0.2
    dropout_impl: str = "bits8"
    freebits: float = 0.0
    beta_anneal: int = 0
    lr: float = 3e-4
    max_grad_norm: Optional[float] = None
    max_steps: int = 100_000
    ema_decay: float = 0.999
    data_dep_init: bool = False
    seed: int = 54321
    log_interval: int = 1000
    test_interval: int = 10_000
    checkpoint_interval: int = 10_000
    keep_checkpoints: int = 2
    output_dir: str = "./output"
    run_name: Optional[str] = None
    load: Optional[str] = None
    auto_resume: bool = False
    dry_run: bool = False
    grad_accum: int = 1
    remat: bool = False
    steps_per_call: int = 1
    profile: Optional[str] = None       # "A-B": a trace of steps A to B
    debug_nans: bool = False
    defer_metrics: bool = False
    # lvae_tpu options this port does not run: stored so a run directory
    # says what it ran, and rejected below at anything but the value the
    # port runs
    streaming: bool = False
    num_data_shards: int = 1
    rng_impl: str = "threefry"

    def __post_init__(self):
        super().__post_init__()

        def _positive(name, v):
            if v < 1:
                raise ValueError(f"--{name} must be >= 1, got {v}")

        for name in ("batch-size", "max-steps", "log-interval", "test-interval",
                     "checkpoint-interval", "keep-checkpoints"):
            _positive(name, getattr(self, name.replace("-", "_")))
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"--dropout must be in [0, 1), got {self.dropout}")
        if self.dropout_impl not in ("bits8", "float"):
            raise ValueError(f"--dropout-impl must be bits8 or float, got {self.dropout_impl!r}")
        if self.freebits < 0:
            raise ValueError(f"--freebits must be >= 0, got {self.freebits}")
        if self.beta_anneal < 0:
            raise ValueError(f"--beta-anneal must be >= 0, got {self.beta_anneal}")
        if self.lr <= 0:
            raise ValueError(f"--lr must be > 0, got {self.lr}")
        if self.max_grad_norm is not None and self.max_grad_norm <= 0:
            raise ValueError(f"--max-grad-norm must be > 0, got {self.max_grad_norm}")
        if not 0.0 <= self.ema_decay <= 1.0:
            raise ValueError(f"--ema-decay must be in [0, 1], got {self.ema_decay}")
        if self.bn_stat_samples < 0:
            raise ValueError(f"--bn-stat-samples must be >= 0, got {self.bn_stat_samples}")
        if self.bn_stat_samples > self.batch_size:
            raise ValueError(
                f"--bn-stat-samples {self.bn_stat_samples} exceeds --batch-size "
                f"{self.batch_size} (stats come from the leading N batch rows)"
            )
        _positive("grad-accum", self.grad_accum)
        _positive("num-data-shards", self.num_data_shards)
        _positive("steps-per-call", self.steps_per_call)
        if self.profile is not None:
            self.profile_range()
        # what the port's trainer does not run, each rejected by its flag
        for flag, bad, why in (
            ("--streaming", self.streaming, "the host streaming pipeline"),
            ("--num-data-shards", self.num_data_shards > 1, "multi-GPU training"),
        ):
            if bad:
                raise ValueError(
                    f"{flag} {getattr(self, flag[2:].replace('-', '_'))}: {why} "
                    f"is not ported yet; it comes in {_LATER}"
                )
        if self.rng_impl != "threefry":
            raise ValueError(
                f"--rng-impl {self.rng_impl}: the port's noise is a keyed, "
                f"counter-based Philox (batch-invariant like threefry); "
                f"rbg is not ported"
            )

    def profile_range(self) -> Tuple[int, int]:
        """``--profile A-B`` as ``(A, B)``."""
        try:
            a, b = (int(v) for v in self.profile.split("-"))
        except ValueError:
            raise ValueError(f"--profile takes A-B (two step numbers), got "
                             f"{self.profile!r}") from None
        if not 0 <= a < b:
            raise ValueError(f"--profile {self.profile}: needs 0 <= A < B")
        return a, b

    def describe(self) -> str:
        """The run directory's descriptive suffix, as ``lvae_tpu`` names it."""
        parts = [self.dataset.replace(":", ""), "z" + "-".join(map(str, self.zdims)),
                 f"f{self.n_filters}", f"b{self.blocks_per_layer}"]
        for flag, name in ((self.skip, "skip"), (self.gated, "gated")):
            if flag:
                parts.append(name)
        if self.freebits:
            parts.append(f"fb{self.freebits:g}")
        if self.beta_anneal:
            parts.append(f"anneal{self.beta_anneal}")
        if self.learn_top_prior:
            parts.append("ltp")
        if self.conv_pad != "same":
            parts.append(f"pad-{self.conv_pad}")
        if self.skip_merge != "pre":
            parts.append(f"sm-{self.skip_merge}")
        if self.bn_stat_samples:
            parts.append(f"bnss{self.bn_stat_samples}")
        parts.append(f"seed{self.seed}")
        return ",".join(parts)

    def make_run_name(self) -> str:
        return self.run_name or f"{time.strftime('%y%m%d_%H%M%S')}_{self.describe()}"


def train_config_from_dict(d: dict) -> TrainConfig:
    """A :class:`TrainConfig` from a saved ``config.json`` (resume)."""
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: tuple(v) if isinstance(v, list) else
                          (None if v == "None" else v)
                          for k, v in d.items() if k in names})


def build_parser() -> argparse.ArgumentParser:
    """``lvae_tpu``'s training flags, spelled as there, plus ``--device``."""
    p = argparse.ArgumentParser(
        description="Ladder VAE training with the PyTorch/CUDA port",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    d = TrainConfig()
    add = p.add_argument
    # data
    add("--dataset", default=d.dataset)
    add("--data-dir", default=d.data_dir)
    add("--batch-size", type=int, default=d.batch_size)
    add("--test-batch-size", type=int, default=d.test_batch_size)
    # model
    add("--zdims", type=int, nargs="+", default=list(d.zdims))
    add("--downsample", type=int, nargs="+", default=list(d.downsample))
    add("--nonlin", default=d.nonlin,
        choices=["relu", "leakyrelu", "elu", "selu", "gelu", "silu"])
    add("--skip", action="store_true", help="stochastic skip connections")
    add("--blocks-per-layer", type=int, default=d.blocks_per_layer)
    add("--gated", action="store_true")
    add("--freebits", type=float, default=d.freebits)
    add("--learn-top-prior", action="store_true")
    add("--data-dep-init", action="store_true")
    add("--seed", type=int, default=d.seed)
    add("--n-filters", type=int, default=d.n_filters)
    add("--no-initial-downscaling", action="store_true")
    add("--dropout", type=float, default=d.dropout)
    add("--dropout-impl", default=d.dropout_impl, choices=["bits8", "float"])
    add("--residual-type", default=d.residual_type)
    add("--merge-layers", default=d.merge_layers, choices=["linear", "residual"])
    add("--resample-mode", default=d.resample_mode, choices=["conv", "interpolate"])
    add("--conv-pad", default=d.conv_pad, choices=["same", "torch"])
    add("--skip-merge", default=d.skip_merge, choices=["pre", "post"])
    add("--no-bn", action="store_true", help="disable batchnorm")
    add("--bn-stat-samples", type=int, default=d.bn_stat_samples,
        help="BatchNorm training statistics from the leading N batch rows (0: all)")
    add("--likelihood", default=None, choices=list(LIKELIHOODS),
        help="output head (default: the dataset's)")
    # loss / optimization
    add("--beta-anneal", type=int, default=d.beta_anneal, help="KL warmup steps (0 = off)")
    add("--lr", type=float, default=d.lr)
    add("--max-grad-norm", type=float, default=None)
    add("--grad-accum", type=int, default=d.grad_accum,
        help="average the gradients of k micro-steps before each clip and "
             "Adamax update (optax.MultiSteps)")
    add("--max-steps", type=int, default=d.max_steps)
    add("--ema-decay", type=float, default=d.ema_decay)
    # infrastructure
    add("--rng-impl", default=d.rng_impl, choices=["rbg", "threefry"])
    add("--precision", default=d.precision, choices=list(PRECISIONS),
        help="the convolutions' compute dtype: bf16 convs from fp32 parameters, "
             "with BatchNorm, the segments, the latents, the likelihood, the "
             "loss and the optimiser in fp32")
    add("--fused", default=d.fused,
        choices=["auto", "none", "stochastic", "mixture", "pallas", "segments", "all"],
        help="kernel policy: 'auto' turns on, on CUDA, the sample+KL kernels "
             "and, for the discretized_logistic_mix head, the mixture "
             "log-prob kernel; 'stochastic' the sample+KL kernels, "
             "'mixture' the mixture kernel, 'pallas' both; 'segments' the "
             "train-mode dropout+BatchNorm+activation segment kernel, 'all' "
             "the three; on any device (the CPU runs their plain versions); "
             "'none' is plain PyTorch")
    add("--remat", action="store_true",
        help="recompute each resampling residual block's activations in the "
             "backward (memory for FLOPs)")
    add("--steps-per-call", type=int, default=d.steps_per_call)
    add("--streaming", action="store_true")
    add("--num-data-shards", type=int, default=d.num_data_shards)
    add("--spatial-shards", type=int, default=d.spatial_shards)
    add("--log-interval", type=int, default=d.log_interval)
    add("--test-interval", type=int, default=d.test_interval)
    add("--checkpoint-interval", type=int, default=d.checkpoint_interval)
    add("--keep-checkpoints", type=int, default=d.keep_checkpoints)
    add("--output-dir", default=d.output_dir)
    add("--run-name", default=None)
    add("--load", default=None, help="run name (or dir) to resume from")
    add("--auto-resume", action="store_true",
        help="restore this run's latest checkpoint if one exists")
    add("--dry-run", action="store_true", help="no checkpoints, no run directory")
    add("--profile", default=None, metavar="A-B",
        help="write a torch.profiler Chrome trace of steps A to B to <run>/trace")
    add("--debug-nans", action="store_true",
        help="stop with FloatingPointError at the first step whose loss, "
             "gradients or updated parameters hold a NaN")
    add("--defer-metrics", action="store_true",
        help="no metric readback at log lines (a dispatch rate instead); "
             "one train line at the end")
    # devices
    add("--device", default="cuda", choices=["cuda", "cpu"],
        help="cuda needs a visible card and never falls back to the CPU")
    add("--platform", default=None,
        help="lvae_tpu's backend switch; the port takes cuda or cpu (as --device)")
    return p


def config_from_args(argv: Optional[Sequence[str]] = None) -> Tuple[TrainConfig, str]:
    """``(config, device)`` from the command line."""
    args = build_parser().parse_args(argv)
    device = args.device
    if args.platform is not None:
        if args.platform not in ("cuda", "cpu"):
            raise ValueError(
                f"--platform {args.platform}: the port runs on cuda or cpu only"
            )
        device = args.platform
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in vars(args).items() if k in names}
    kw["batchnorm"] = not args.no_bn
    for k in ("zdims", "downsample"):
        kw[k] = tuple(kw[k])
    return TrainConfig(**kw), device
