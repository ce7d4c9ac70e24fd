"""Test-split parsers (a subset of ``lvae_tpu/data/sources.py``), numpy
only. All return uint8 NHWC; binary datasets hold {0, 1}."""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np


def _first_existing(*paths: str) -> str:
    for p in paths:
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"none of the expected dataset files exist: {paths} (see "
        "lvae_tpu/data/sources.py for the layout under --data-dir)"
    )


def load_amat(path: str) -> np.ndarray:
    """A Larochelle ``binarized_mnist_*.amat``: ASCII 0/1, one 784-value
    row per image."""
    data = np.loadtxt(path, dtype=np.float32, ndmin=2).astype(np.uint8)
    return data.reshape(data.shape[0], 28, 28, 1)


def load_idx_images(path: str) -> np.ndarray:
    """An MNIST idx3-ubyte image file (optionally gzipped)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad idx magic {magic}")
        buf = f.read(n * rows * cols)
    return np.frombuffer(buf, dtype=np.uint8).reshape(n, rows, cols, 1)


def load_static_mnist_test(root: str) -> np.ndarray:
    """Static binarized MNIST, the test split."""
    d = os.path.join(root, "static_mnist")
    return load_amat(_first_existing(os.path.join(d, "binarized_mnist_test.amat")))


def load_mnist_test(root: str) -> np.ndarray:
    """MNIST grayscale, the test split (binarised per image at eval)."""
    d = os.path.join(root, "mnist")
    return load_idx_images(_first_existing(
        os.path.join(d, "t10k-images-idx3-ubyte"),
        os.path.join(d, "t10k-images-idx3-ubyte.gz"),
        os.path.join(d, "raw", "t10k-images-idx3-ubyte"),
    ))


def make_synthetic(n_train: int = 512, n_test: int = 128, img: int = 28,
                   channels: int = 1, binary: bool = True, seed: int = 0):
    """``lvae_tpu``'s deterministic blob fixture, element for element:
    returns (train, test) uint8."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    yy, xx = np.mgrid[0:img, 0:img].astype(np.float32)
    cx = rng.uniform(img * 0.25, img * 0.75, size=(n, 1, 1, channels))
    cy = rng.uniform(img * 0.25, img * 0.75, size=(n, 1, 1, channels))
    r = rng.uniform(img * 0.1, img * 0.3, size=(n, 1, 1, channels))
    blob = np.exp(
        -(((xx[None, :, :, None] - cx) ** 2 + (yy[None, :, :, None] - cy) ** 2))
        / (2 * r**2)
    )
    if binary:
        data = (blob > 0.5).astype(np.uint8)
    else:
        data = np.clip(blob * 255, 0, 255).astype(np.uint8)
    return data[:n_train], data[n_train:]
