"""Dataset metadata and test-set loading (a subset of
``lvae_tpu/data/registry.py``: the flagship's Bernoulli datasets)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from lvae_tpu_torch.data import sources

PREPROCESS_NONE = "none"
PREPROCESS_BINARIZE = "binarize"
PREPROCESS_DEQUANTIZE = "dequantize"

# (img_size, padded_size, color_ch, preprocess, default_likelihood), the
# rows of lvae_tpu/data/registry.py:_META this slice runs
_META = {
    "static_mnist": ((28, 28), (32, 32), 1, PREPROCESS_NONE, "bernoulli"),
    "mnist": ((28, 28), (32, 32), 1, PREPROCESS_BINARIZE, "bernoulli"),
    "synthetic": ((28, 28), (32, 32), 1, PREPROCESS_NONE, "bernoulli"),
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


def load_test_set(name: str, data_dir: str = "./data") -> TestSet:
    """The test split of a dataset, with its metadata (``synthetic:N``
    takes lvae_tpu's size suffix)."""
    base, _, size = name.partition(":")
    if base not in _META:
        raise NotImplementedError(
            f"--dataset {name} is not ported yet: this slice runs "
            f"{sorted(_META)}; the RGB datasets come with the port's "
            f"mixture-head PR"
        )
    meta = _META[base]
    if base == "static_mnist":
        test = sources.load_static_mnist_test(data_dir)
    elif base == "mnist":
        test = sources.load_mnist_test(data_dir)
    else:
        # lvae_tpu's fixture rule: 'synthetic:N' = N train images, test
        # N//4 clamped to [128, 1024]
        n_train = 512
        if size:
            n_train = int(size) if size.isdigit() else 0
            if n_train <= 0:
                raise ValueError(
                    f"bad size suffix {size!r} in {name!r}: use 'synthetic:N' "
                    "with a positive integer N"
                )
        n_test = min(max(n_train // 4, 128), 1024)
        _, test = sources.make_synthetic(n_train=n_train, n_test=n_test,
                                         img=meta[0][0])
    return TestSet(name, test, *meta)
