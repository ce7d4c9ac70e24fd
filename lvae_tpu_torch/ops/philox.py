"""The port's one noise definition: Philox4x32-10, keyed per image.

``lvae_tpu`` keys evaluation noise with ``fold_in(key, index)`` so test
ELBO and IW-LL do not depend on ``--test-batch-size`` or sweep order. The
port keeps that property with a counter-based generator:

- key: the two 32-bit words of the 64-bit ``seed``;
- counter: ``(offset, index[i], sample[i], stream)`` where ``offset`` is
  the element's position within its image's map (row-major in the
  tensor's own layout), ``index[i]`` the image's global dataset index,
  ``sample[i]`` the importance sample, and ``stream`` the latent layer (or
  a stream id such as :data:`STREAM_BINARIZE`);
- a uniform is the top 24 bits of a word, ``(i24 + 1) / 2^24``, in (0, 1];
- a normal is Box-Muller over output words 0 and 1:
  ``sqrt(-2 ln u1) * cos(2 pi u2)``.

This module is the plain PyTorch version; ``csrc/stochastic_kl.cu``
implements the same generator, so the kernel and this code give the same
eps up to libm rounding, on any device. Everything is int64 arithmetic:
each 32x32-bit product is split at 16 bits so nothing overflows.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

_M32 = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_ROUNDS = 10
_TWO_PI = 6.283185307179586

# stream words above every layer index
STREAM_BINARIZE = 0x80000000

Ints = Union[int, torch.Tensor]


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product ``m * b`` of two uint32
    values held in int64: ``m`` is split at 16 bits so every partial
    product stays below 2^48."""
    p_lo = (m & 0xFFFF) * b
    p_hi = (m >> 16) * b
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & _M32


def philox4x32(c0: Ints, c1: Ints, c2: Ints, c3: Ints, k0: int, k1: int):
    """Philox4x32-10 of the counter words ``(c0, c1, c2, c3)`` (int64
    tensors or ints holding uint32 values, broadcast together) under the
    key ``(k0, k1)``. Returns four int64 tensors of uint32 values."""
    c = [torch.as_tensor(v, dtype=torch.int64) for v in (c0, c1, c2, c3)]
    k0, k1 = k0 & _M32, k1 & _M32
    for r in range(_ROUNDS):
        if r:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def seed_words(seed: int):
    """The key words of a 64-bit seed (negative seeds wrap)."""
    s = int(seed) % (1 << 64)
    return s & _M32, s >> 32


def uniform24(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 uniforms in (0, 1]: the top 24 bits plus
    one, over 2^24 (exact in fp32)."""
    return ((bits >> 8).to(torch.float32) + 1.0) * (1.0 / 16777216.0)


def keyed_words(shape: Sequence[int], seed: int, index: torch.Tensor,
                sample: Ints, stream: int):
    """Philox output words for a ``[B, ...]`` tensor whose row ``i`` is
    keyed by ``(seed, index[i], sample[i], stream)``. Returns four int64
    ``[B, prod(shape[1:])]`` tensors."""
    b = int(shape[0])
    n = 1
    for d in shape[1:]:
        n *= int(d)
    index = torch.as_tensor(index, dtype=torch.int64)
    if index.shape != (b,):
        raise ValueError(f"index must be int64 [{b}], got {tuple(index.shape)}")
    device = index.device
    sample = torch.as_tensor(sample, dtype=torch.int64, device=device)
    offset = torch.arange(n, dtype=torch.int64, device=device).view(1, n)
    k0, k1 = seed_words(seed)
    words = philox4x32(
        offset,
        (index & _M32).view(b, 1),
        (sample & _M32).expand(b).reshape(b, 1),
        stream & _M32,
        k0, k1,
    )
    return [w.expand(b, n) for w in words]


def keyed_normal(shape: Sequence[int], seed: int, index: torch.Tensor,
                 sample: Ints, stream: int) -> torch.Tensor:
    """Standard normals of ``shape`` (fp32, on ``index``'s device), row
    ``i`` keyed by ``(seed, index[i], sample[i], stream)``."""
    w = keyed_words(shape, seed, index, sample, stream)
    u1, u2 = uniform24(w[0]), uniform24(w[1])
    two_pi = torch.tensor(_TWO_PI, dtype=torch.float32, device=u2.device)
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
    return eps.reshape(tuple(shape))


def keyed_uniform(shape: Sequence[int], seed: int, index: torch.Tensor,
                  sample: Ints, stream: int) -> torch.Tensor:
    """Uniforms in (0, 1] of ``shape``, keyed like :func:`keyed_normal`
    (output word 0)."""
    w = keyed_words(shape, seed, index, sample, stream)
    return uniform24(w[0]).reshape(tuple(shape))
