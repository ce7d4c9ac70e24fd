"""Dataset parsers (port of ``lvae_tpu/data/sources.py``), numpy only
(scipy for SVHN's ``.mat``, PIL for the one-time CelebA JPEG
conversion). All return uint8 NHWC; binary
datasets hold {0, 1}. Each split has its own loader, so evaluation never
parses a train split."""

from __future__ import annotations

import gzip
import os
import pickle
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


def _cifar10_dir(root: str) -> str:
    d = os.path.join(root, "cifar10", "cifar-10-batches-py")
    return d if os.path.isdir(d) else os.path.join(root, "cifar-10-batches-py")


def _cifar10_batch(path: str) -> np.ndarray:
    """One CIFAR-10 python pickle batch: rows of 3072 bytes, channel-major
    (``lvae_tpu/data/sources.py:106-121``)."""
    with open(path, "rb") as f:
        entry = pickle.load(f, encoding="latin1")
    data = np.asarray(entry["data"], dtype=np.uint8)
    return data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


def load_cifar10_test(root: str) -> np.ndarray:
    """CIFAR-10, the test split (``test_batch``)."""
    return _cifar10_batch(_first_existing(os.path.join(_cifar10_dir(root), "test_batch")))


def load_cifar10_train(root: str) -> np.ndarray:
    """CIFAR-10, the train split (``data_batch_1`` .. ``data_batch_5``)."""
    d = _cifar10_dir(root)
    return np.concatenate([_cifar10_batch(_first_existing(os.path.join(d, f"data_batch_{i}")))
                           for i in range(1, 6)])


def _svhn(root: str, split: str) -> np.ndarray:
    """An SVHN cropped-digits ``<split>_32x32.mat``: ``X`` is stored
    ``[32, 32, 3, N]`` (``lvae_tpu/data/sources.py:124-137``)."""
    from scipy.io import loadmat

    m = loadmat(_first_existing(os.path.join(root, "svhn", f"{split}_32x32.mat")))
    return np.ascontiguousarray(np.transpose(m["X"], (3, 0, 1, 2)), dtype=np.uint8)


def load_svhn_test(root: str) -> np.ndarray:
    return _svhn(root, "test")


def load_svhn_train(root: str) -> np.ndarray:
    return _svhn(root, "train")


CELEBA_CROP = 148  # centre crop before the resize to 64 (lvae_tpu's)


def load_celeba_split(root: str, split: str) -> np.ndarray:
    """CelebA 64x64, ``split`` 'train' or 'test' (``lvae_tpu/data/
    sources.py:143-190``): from the ``celeba/celeba_64.npz`` cache
    (arrays ``train`` and ``test``), else converted once from
    ``img_align_celeba/*.jpg`` (centre crop 148, bilinear resize to 64;
    ``list_eval_partition.txt`` part 2 is the test split, 0 and 1 train)
    and the cache written."""
    d = os.path.join(root, "celeba")
    cache = os.path.join(d, "celeba_64.npz")
    if not os.path.exists(cache):
        _convert_celeba(d, cache)
    with np.load(cache) as z:
        return np.asarray(z[split], dtype=np.uint8)


def _convert_celeba(d: str, cache: str) -> None:
    img_dir = os.path.join(d, "img_align_celeba")
    if not os.path.isdir(img_dir):
        raise FileNotFoundError(
            f"need {cache} or {img_dir} (with list_eval_partition.txt); the "
            "port does not download CelebA"
        )
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"converting {img_dir} to {cache} needs PIL, which is not "
            f"installed; convert on a machine that has it and copy the npz"
        ) from e
    splits = {}
    part_file = os.path.join(d, "list_eval_partition.txt")
    if os.path.exists(part_file):
        with open(part_file) as f:
            for line in f:
                name, part = line.split()
                splits[name] = int(part)
    train, test = [], []
    for name in sorted(os.listdir(img_dir)):
        if not name.lower().endswith((".jpg", ".png")):
            continue
        img = Image.open(os.path.join(img_dir, name))
        w, h = img.size
        left, top = (w - CELEBA_CROP) // 2, (h - CELEBA_CROP) // 2
        img = img.crop((left, top, left + CELEBA_CROP, top + CELEBA_CROP))
        arr = np.asarray(img.resize((64, 64), Image.BILINEAR), dtype=np.uint8)
        (test if splits.get(name, 0) == 2 else train).append(arr)
    train = np.stack(train)
    np.savez_compressed(cache, train=train, test=np.stack(test) if test else train[:1])


def load_multiobject_npz(path: str, test_fraction: float = 0.1):
    """A ``multiobject`` package npz (``lvae_tpu/data/sources.py:193-210``):
    the images under ``x`` (or ``images``), [N, H, W] or [N, H, W, C],
    binary as {0, 1} or {0, 255} and returned as {0, 1}; the per-object
    metadata beside them is not read. The last ``test_fraction`` of the
    images is the test split (the file has none). Returns (train, test)."""
    with np.load(_first_existing(path), allow_pickle=False) as z:
        x = np.asarray(z["x"] if "x" in z.files else z["images"])
    if x.ndim == 3:
        x = x[..., None]
    if x.dtype != np.uint8:
        x = x.astype(np.uint8)
    if x.max() > 1:
        x = (x > 127).astype(np.uint8)
    n_test = max(1, int(len(x) * test_fraction))
    return x[:-n_test], x[-n_test:]


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
