"""Model and evaluation configuration (port of ``lvae_tpu/config.py``).

Only the fields the evaluation and serving path reads are kept. A
``lvae_tpu`` run's ``config.json`` loads through :func:`config_from_dict`,
which drops the train-only fields unread: they are neither stored nor
validated here, so a stored train batch size can never block an
evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Values this slice does not run; each names the flag it came from.
_LATER = "a later PR of the port"


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
        # what this slice does not run, each rejected with its flag named
        if self.likelihood not in (None, "bernoulli"):
            raise ValueError(
                f"--likelihood {self.likelihood} is not ported yet (only "
                f"bernoulli runs on this slice; the other heads come in "
                f"{_LATER})"
            )
        if self.precision != "fp32":
            raise ValueError(
                f"--precision {self.precision} is not ported yet: this port "
                f"is fp32-only; bf16 comes in {_LATER}"
            )
        if self.spatial_shards > 1:
            raise ValueError(
                f"--spatial-shards {self.spatial_shards} is not supported by "
                f"the port (single-GPU eval only)"
            )
        if self.bn_stat_samples > 0:
            raise ValueError(
                f"--bn-stat-samples {self.bn_stat_samples} is a train-mode "
                f"BatchNorm option the port does not run"
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
