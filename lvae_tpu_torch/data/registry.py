"""Dataset metadata and loading (port of ``lvae_tpu/data/registry.py``).
:func:`load_test_set` reads the test split alone (evaluation never parses
a train split); :func:`load_dataset` both; :func:`bench_preset` makes the
synthetic splits of the bench and the probes; :func:`stub_bundle` makes a
dataset's metadata with tiny random splits, reading nothing."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from lvae_tpu_torch.data import sources

PREPROCESS_NONE = "none"
PREPROCESS_BINARIZE = "binarize"
PREPROCESS_DEQUANTIZE = "dequantize"

# (img_size, padded_size, color_ch, preprocess, default_likelihood): the
# rows of lvae_tpu/data/registry.py:_META (:70-87)
_META = {
    "static_mnist": ((28, 28), (32, 32), 1, PREPROCESS_NONE, "bernoulli"),
    "mnist": ((28, 28), (32, 32), 1, PREPROCESS_BINARIZE, "bernoulli"),
    "cifar10": ((32, 32), (32, 32), 3, PREPROCESS_DEQUANTIZE, "discretized_logistic_mix"),
    "svhn": ((32, 32), (32, 32), 3, PREPROCESS_DEQUANTIZE, "discretized_logistic"),
    "celeba": ((64, 64), (64, 64), 3, PREPROCESS_DEQUANTIZE, "discretized_logistic_mix"),
    "synthetic": ((28, 28), (32, 32), 1, PREPROCESS_NONE, "bernoulli"),
    "synthetic_rgb": ((32, 32), (32, 32), 3, PREPROCESS_DEQUANTIZE, "discretized_logistic"),
    "synthetic_celeba": ((64, 64), (64, 64), 3, PREPROCESS_DEQUANTIZE,
                         "discretized_logistic_mix"),
}
# (test loader, train loader) of each file-backed dataset
_FILES = {
    "static_mnist": (sources.load_static_mnist_test, sources.load_static_mnist_train),
    "mnist": (sources.load_mnist_test, sources.load_mnist_train),
    "cifar10": (sources.load_cifar10_test, sources.load_cifar10_train),
    "svhn": (sources.load_svhn_test, sources.load_svhn_train),
    "celeba": (lambda root: sources.load_celeba_split(root, "test"),
               lambda root: sources.load_celeba_split(root, "train")),
}

# the multi-object npz sets (lvae_tpu/data/registry.py:159-173): their
# shapes and channels come from the file, padded to the next power of two
_MULTIOBJECT = {
    "multi_dsprites_binary_rgb": ("dsprites", "multi_dsprites_color_012.npz"),
    "multi_mnist_binary": ("binary_mnist", "multi_binary_mnist_012.npz"),
}


def _padded(hw: int) -> int:
    """The smallest power of two >= hw (28 -> 32, 48 -> 64)."""
    p = 1
    while p < hw:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class TestSet:
    name: str
    test: np.ndarray                # uint8 NHWC
    img_size: Tuple[int, int]       # native data resolution
    padded_size: Tuple[int, int]    # model resolution
    color_ch: int
    preprocess: str
    default_likelihood: str

    @property
    def data_dims(self) -> int:
        return self.img_size[0] * self.img_size[1] * self.color_ch

    @property
    def data_shape(self) -> Tuple[int, int, int]:
        return (*self.img_size, self.color_ch)


@dataclasses.dataclass(frozen=True)
class Dataset(TestSet):
    """Both splits (uint8 NHWC) with the metadata."""

    train: Optional[np.ndarray] = None


def load_test_set(name: str, data_dir: str = "./data") -> TestSet:
    """The test split of a dataset, with its metadata (the synthetic
    fixtures take lvae_tpu's ``:N`` size suffix)."""
    test, _, meta = _load(name, data_dir, with_train=False)
    return TestSet(name, test, *meta)


def load_dataset(name: str, data_dir: str = "./data") -> Dataset:
    """Both splits: static_mnist's train is train + valid, mnist's the
    idx train file, cifar10's the five pickle batches, the multi-object
    sets' the first 90% of their npz, ``synthetic[:N]``,
    ``synthetic_rgb[:N]`` and ``synthetic_celeba[:N]`` lvae_tpu's
    fixtures."""
    test, train, meta = _load(name, data_dir, with_train=True)
    return Dataset(name, test, *meta, train=train)


def bench_preset(preset: str, n_train: int) -> Tuple[Dataset, Tuple[int, ...],
                                                   Tuple[int, ...]]:
    """``(dataset, zdims, downsample)`` of a bench preset
    (``lvae_tpu/data/registry.py:108-138``): the same
    ``np.random.default_rng(0)`` draws, so the same uint8 train split byte
    for byte, with ``test = train[:256]``. One source for the bench
    (:mod:`lvae_tpu_torch.bench`) and the probes, so the profiled model is
    the benchmarked one. ``mnist`` is the flagship 28x28 Bernoulli config;
    ``celeba64`` BASELINE config 5 (64x64 RGB, 4 latent layers, the
    logistic-mixture head); ``cifar10-deep`` BASELINE config 4 (32x32 RGB,
    10 latent layers, the mixture head)."""
    rng = np.random.default_rng(0)
    if preset == "cifar10-deep":
        train = rng.integers(0, 256, size=(n_train, 32, 32, 3), dtype=np.uint8)
        meta = ((32, 32), (32, 32), 3, PREPROCESS_DEQUANTIZE, "discretized_logistic_mix")
        # 10 latent layers. lvae_tpu's comment says three at 16x16; the
        # model gives two (16, 16, then 8 x3, 4 x3, 2 x2): the first block
        # of a downsampling layer resamples
        zdims, downsample = (32,) * 10, (0, 0, 1, 0, 0, 1, 0, 0, 1, 0)
    elif preset == "celeba64":
        train = rng.integers(0, 256, size=(n_train, 64, 64, 3), dtype=np.uint8)
        meta = ((64, 64), (64, 64), 3, PREPROCESS_DEQUANTIZE, "discretized_logistic_mix")
        zdims, downsample = (32, 32, 32, 32), (1, 1, 1, 1)
    elif preset == "mnist":
        train = (rng.uniform(size=(n_train, 28, 28, 1)) < 0.5).astype(np.uint8)
        meta = ((28, 28), (32, 32), 1, PREPROCESS_NONE, "bernoulli")
        zdims, downsample = (32, 32, 32), (1, 1, 1)
    else:
        raise ValueError(f"unknown bench preset {preset!r}; choose from {BENCH_PRESETS}")
    return Dataset("bench", train[:256], *meta, train=train), zdims, downsample


BENCH_PRESETS = ("mnist", "celeba64", "cifar10-deep")


def stub_bundle(name: str, n: int = 8) -> Dataset:
    """A dataset's metadata with ``n`` seeded random uint8 images as both
    splits, and no disk access (``lvae_tpu/data/registry.py:90-105``): for
    what needs only the shapes, the preprocessing and the head, such as
    the template model of a checkpoint import. A synthetic fixture's
    ``:N`` suffix sets only its split size, so it is ignored here."""
    base = name.partition(":")[0]
    if base not in _META:
        raise ValueError(
            f"no static metadata for {name!r} (multiobject shapes come from "
            f"their npz files); choose from {sorted(_META)}"
        )
    img, padded, ch, pre, lik = _META[base]
    arr = np.random.default_rng(0).integers(0, 256, size=(n, *img, ch), dtype=np.uint8)
    return Dataset(name, arr, img, padded, ch, pre, lik, train=arr)


def _load(name: str, data_dir: str, with_train: bool):
    base, _, size = name.partition(":")
    if size and (base in _FILES or base in _MULTIOBJECT):
        raise ValueError(f"{name!r}: only the synthetic fixtures take a ':N' size")
    if base in _MULTIOBJECT:
        train, test = sources.load_multiobject_npz(
            os.path.join(data_dir, "multiobject", *_MULTIOBJECT[base]))
        hw = train.shape[1]
        meta = ((hw, hw), (_padded(hw),) * 2, train.shape[-1], PREPROCESS_NONE,
                "bernoulli")
        return test, train if with_train else None, meta
    if base not in _META:
        raise ValueError(f"unknown dataset {name!r}; choose from "
                         f"{sorted(_META) + sorted(_MULTIOBJECT)}")
    meta = _META[base]
    if base in _FILES:
        test_fn, train_fn = _FILES[base]
        return test_fn(data_dir), train_fn(data_dir) if with_train else None, meta
    # lvae_tpu's fixture rule: 'name:N' = N train images, test N//4
    # clamped to [128, 1024]
    n_train = 512
    if size:
        n_train = int(size) if size.isdigit() else 0
        if n_train <= 0:
            raise ValueError(
                f"bad size suffix {size!r} in {name!r}: use '{base}:N' with a "
                "positive integer N"
            )
    n_test = min(max(n_train // 4, 128), 1024)
    train, test = sources.make_synthetic(n_train=n_train, n_test=n_test, img=meta[0][0],
                                         channels=meta[2], binary=base == "synthetic")
    return test, train, meta
