"""Dataset metadata and loading (port of ``lvae_tpu/data/registry.py``,
without the multi-object npz sets). :func:`load_test_set` reads the test
split alone (evaluation never parses a train split); :func:`load_dataset`
both."""

from __future__ import annotations

import dataclasses
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
    idx train file, cifar10's the five pickle batches, ``synthetic[:N]``,
    ``synthetic_rgb[:N]`` and ``synthetic_celeba[:N]`` lvae_tpu's
    fixtures."""
    test, train, meta = _load(name, data_dir, with_train=True)
    return Dataset(name, test, *meta, train=train)


def _load(name: str, data_dir: str, with_train: bool):
    base, _, size = name.partition(":")
    if base not in _META:
        raise NotImplementedError(
            f"--dataset {name} is not ported: the port runs {sorted(_META)} "
            f"(lvae_tpu's multi-object npz sets are not ported)"
        )
    meta = _META[base]
    if base in _FILES:
        if size:
            raise ValueError(f"{name!r}: only the synthetic fixtures take a ':N' size")
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
