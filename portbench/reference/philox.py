"""A frozen copy of the port's keyed noise (Philox4x32-10), so that the
reference draws exactly the noise the program draws.

- key: the two 32-bit words of the 64-bit seed;
- counter: ``(offset, index[i], sample[i], stream)``: the element's
  row-major position in its image's map, the image's dataset index, the
  importance sample (in training the step) and the stream (the latent
  layer, or one of the ``STREAM_*`` words);
- a uniform is ``(top 24 bits + 1) / 2^24``, in (0, 1];
- a normal is Box-Muller over output words 0 and 1;
- the dropout byte of flat element ``e`` is byte ``e % 16`` of the Philox
  output at counter ``(e // 16, 0, 0, STREAM_SEGMENT_DROPOUT)`` under the
  key ``mix_seed(train seed, step, site)`` (splitmix64 over the words).

Integer arithmetic in int64: a 32x32-bit product wraps to the unsigned
product's 64 bits. Plain torch; imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI = 6.283185307179586
_MIX_INIT, _MIX_M1, _MIX_M2 = 0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB

STREAM_TRAIN_DEQUANTIZE = 0x80000002
STREAM_SEGMENT_DROPOUT = 0x80000005


def mix_seed(*words: int) -> int:
    """A 63-bit seed from integers: splitmix64 over each word in turn."""
    h = _MIX_INIT
    for w in words:
        h = (h ^ (int(w) & _M64)) * _MIX_M1 & _M64
        h = (h ^ (h >> 27)) * _MIX_M2 & _M64
        h ^= h >> 31
    return h >> 1


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counter words (int64 tensors or ints holding uint32
    values, broadcast together) under the key ``(k0, k1)``."""
    c = [torch.as_tensor(v, dtype=torch.int64) for v in (c0, c1, c2, c3)]
    k0, k1 = k0 & _M32, k1 & _M32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        p0, p1 = _PHILOX_M0 * c[0], _PHILOX_M1 * c[2]
        hi0, lo0 = (p0 >> 32) & _M32, p0 & _M32
        hi1, lo1 = (p1 >> 32) & _M32, p1 & _M32
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def _key(seed: int):
    s = int(seed) % (1 << 64)
    return s & _M32, s >> 32


def _uniform24(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 8).to(torch.float32) + 1.0) * (1.0 / 16777216.0)


def _words(shape: Sequence[int], seed: int, index: torch.Tensor, sample, stream: int):
    b, n = shape[0], math.prod(shape[1:])
    device = index.device
    sample = torch.as_tensor(sample, dtype=torch.int64, device=device).expand(b)
    offset = torch.arange(n, dtype=torch.int64, device=device).view(1, n)
    k0, k1 = _key(seed)
    return philox4x32(offset, (index.to(torch.int64) & _M32).view(b, 1),
                      (sample & _M32).reshape(b, 1), stream & _M32, k0, k1)


def keyed_normal(shape: Sequence[int], seed: int, index: torch.Tensor, sample,
                 stream: int) -> torch.Tensor:
    """fp32 standard normals of ``shape``; row ``i`` keyed by ``(seed,
    index[i], sample, stream)`` (``sample`` an int or one per row)."""
    w = _words(shape, seed, index, sample, stream)
    u1, u2 = _uniform24(w[0]), _uniform24(w[1])
    two_pi = torch.full((), _TWO_PI, dtype=torch.float32, device=u2.device)
    return (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)).reshape(tuple(shape))


def keyed_uniform(shape: Sequence[int], seed: int, index: torch.Tensor, sample,
                  stream: int) -> torch.Tensor:
    """fp32 uniforms in (0, 1] of ``shape``, keyed as :func:`keyed_normal`."""
    w = _words(shape, seed, index, sample, stream)
    return _uniform24(w[0]).reshape(tuple(shape))


def dropout_bytes(shape: Sequence[int], seed: int, device) -> torch.Tensor:
    """The uint8 dropout byte of every element of a row-major tensor of
    ``shape`` under ``seed`` (``mix_seed(train seed, step, site)``)."""
    n = math.prod(int(d) for d in shape)
    k0, k1 = _key(seed)
    grp = torch.arange((n + 15) // 16, dtype=torch.int64, device=device)
    words = torch.stack(philox4x32(grp & _M32, grp >> 32, 0, STREAM_SEGMENT_DROPOUT, k0, k1),
                        dim=1)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
    b = (words.unsqueeze(-1) >> shifts) & 255
    return b.reshape(-1)[:n].to(torch.uint8).reshape(tuple(shape))
