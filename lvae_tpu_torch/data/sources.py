"""Dataset parsers (a subset of ``lvae_tpu/data/sources.py``), numpy
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
    row per image. A file of bare ``0``/``1`` tokens is read straight from
    its bytes (the 50,000-image train split in about a second); any other
    spelling goes through ``np.loadtxt``."""
    raw = np.fromfile(path, dtype=np.uint8)
    digits = raw[(raw == ord("0")) | (raw == ord("1"))]
    n_rows = int(np.count_nonzero(raw == ord("\n"))) + (raw.size > 0 and raw[-1] != ord("\n"))
    seps = np.isin(raw, np.frombuffer(b" \t\r\n", dtype=np.uint8))
    if digits.size == 784 * n_rows and digits.size + np.count_nonzero(seps) == raw.size:
        data = digits - np.uint8(ord("0"))
    else:
        data = np.loadtxt(path, dtype=np.float32, ndmin=2).astype(np.uint8)
    return data.reshape(-1, 28, 28, 1)


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


def load_static_mnist_train(root: str) -> np.ndarray:
    """Static binarized MNIST, the train split: train + valid, as
    ``lvae_tpu`` trains on both."""
    d = os.path.join(root, "static_mnist")
    train = load_amat(_first_existing(os.path.join(d, "binarized_mnist_train.amat")))
    valid = os.path.join(d, "binarized_mnist_valid.amat")
    if os.path.exists(valid):
        train = np.concatenate([train, load_amat(valid)], axis=0)
    return train


def _mnist_file(root: str, stem: str) -> str:
    d = os.path.join(root, "mnist")
    return _first_existing(os.path.join(d, stem), os.path.join(d, stem + ".gz"),
                           os.path.join(d, "raw", stem))


def load_mnist_test(root: str) -> np.ndarray:
    """MNIST grayscale, the test split (binarised per image at eval)."""
    return load_idx_images(_mnist_file(root, "t10k-images-idx3-ubyte"))


def load_mnist_train(root: str) -> np.ndarray:
    """MNIST grayscale, the train split (binarised per step in training)."""
    return load_idx_images(_mnist_file(root, "train-images-idx3-ubyte"))


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
