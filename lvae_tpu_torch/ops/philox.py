"""The port's one noise definition: Philox4x32-10, keyed per image.

``lvae_tpu`` keys evaluation noise with ``fold_in(key, index)`` so test
ELBO and IW-LL do not depend on ``--test-batch-size`` or sweep order. The
port keeps that property with a counter-based generator:

- key: the two 32-bit words of the 64-bit ``seed``;
- counter: ``(offset, index[i], sample[i], stream)`` where ``offset`` is
  the element's position within its image's map (row-major in the
  tensor's own layout; for a band of rows of a taller map, its position
  in the whole map, :class:`Band`), ``index[i]`` the image's global
  dataset index,
  ``sample[i]`` the importance sample (in training: the step), and
  ``stream`` the latent layer (or a stream id above every layer, such as
  :data:`STREAM_BINARIZE`);
- a uniform is the top 24 bits of a word, ``(i24 + 1) / 2^24``, in (0, 1];
- a normal is Box-Muller over output words 0 and 1:
  ``sqrt(-2 ln u1) * cos(2 pi u2)``.

This module is the plain PyTorch version; ``csrc/stochastic_kl.cu``
implements the same generator, so the kernel and this code give the same
eps up to libm rounding, on any device. Everything is int64 arithmetic;
a 32x32-bit product wraps to the unsigned product's 64 bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Union

import torch

_M32 = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_ROUNDS = 10
_TWO_PI = 6.283185307179586

# stream words above every layer index
STREAM_BINARIZE = 0x80000000          # eval binarisation (fixed seed)
STREAM_TRAIN_BINARIZE = 0x80000001    # train binarisation, keyed per step
STREAM_TRAIN_DEQUANTIZE = 0x80000002  # train dequantisation noise, per step
STREAM_SAMPLE_SELECT = 0x80000003     # image sampling: the mixture component
STREAM_SAMPLE_DRAW = 0x80000004       # image sampling: the per-pixel draw
STREAM_SEGMENT_DROPOUT = 0x80000005   # the fused segment's dropout bytes
STREAM_FLOAT_DROPOUT = 0x80000006     # the unfused 'float' dropout's uniforms

Ints = Union[int, torch.Tensor]


class Band(NamedTuple):
    """A band of rows of an NCHW map: the map's global height ``h`` and
    the band's first row ``h0`` (a rank's part under ``--spatial-shards``)."""

    h: int
    h0: int


class ElementMap(NamedTuple):
    """Where a rank's elements lie in the global tensor: local flat
    element ``e`` is global element ``e + base`` where ``plane`` is 0 (a
    contiguous run: ``ElementMap()`` the whole tensor, ``ElementMap(base=
    o)`` a run from ``o``), else ``(e // plane) gplane + e % plane + base``
    (a band: ``plane`` its rows' elements of one channel, ``gplane`` the
    whole map's, ``base`` the global index of its first element).
    ``csrc/philox.cuh`` ``global_element`` is the same map."""

    plane: int = 0
    gplane: int = 0
    base: int = 0

    def at(self, e: torch.Tensor) -> torch.Tensor:
        if self.plane == 0:
            return e + self.base
        return (e // self.plane) * self.gplane + e % self.plane + self.base


def band_map(shape: Sequence[int], band: Optional[Band], base: int = 0) -> ElementMap:
    """The :class:`ElementMap` of the in-row offsets of ``[B, C, hb, W]``
    maps that are rows ``[h0, h0 + hb)`` of ``band.h`` (``base`` added; the
    identity without a band)."""
    if band is None:
        return ElementMap(base=base)
    hb, w = int(shape[-2]), int(shape[-1])
    return ElementMap(hb * w, band.h * w, base + band.h0 * w)


_M64 = (1 << 64) - 1


def _signed64(v: int) -> int:
    """A 64-bit word as the int64 that holds the same bits."""
    return v - (1 << 64) if v >> 63 else v


_MIX_INIT, _MIX_M1, _MIX_M2 = 0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB


def _shr(h: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of the 64-bit words held in int64 (``>>`` is
    arithmetic on a signed tensor: the sign copies are masked off)."""
    return (h >> n) & ((1 << (64 - n)) - 1)


def mix_seed(*words: Ints) -> Ints:
    """A 63-bit seed from a sequence of integers (splitmix64 over each
    word in turn): the key of the Philox stream of, e.g., ``(train seed,
    step, dropout site)``. Where a word is a tensor (a 0-d int64 step on
    the device), the result is a 0-d int64 tensor on its device, computed
    there with no host sync: the same bits as the int version, int64
    products wrapping as 64-bit ones do; csrc/segment.cu ``drop_key``
    computes the same on chip."""
    if not any(isinstance(w, torch.Tensor) for w in words):
        h = _MIX_INIT
        for w in words:
            h = (h ^ (int(w) & _M64)) * _MIX_M1 & _M64
            h = (h ^ (h >> 27)) * _MIX_M2 & _M64
            h ^= h >> 31
        return h >> 1
    device = next(w.device for w in words if isinstance(w, torch.Tensor))
    h = torch.full((), _signed64(_MIX_INIT), dtype=torch.int64, device=device)
    for w in words:
        w = (w.to(device=device, dtype=torch.int64) if isinstance(w, torch.Tensor)
             else _signed64(int(w) & _M64))
        h = (h ^ w) * _signed64(_MIX_M1)
        h = (h ^ _shr(h, 27)) * _signed64(_MIX_M2)
        h = h ^ _shr(h, 31)
    return _shr(h, 1)


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product ``m * b`` of two uint32
    values held in int64: the int64 product wraps as a 64-bit one does
    (as :func:`mix_seed`'s), so its bits are the unsigned product's, and
    the arithmetic shift's sign copies are masked off."""
    p = m * b
    return (p >> 32) & _M32, p & _M32


def philox4x32(c0: Ints, c1: Ints, c2: Ints, c3: Ints, k0: Ints, k1: Ints):
    """Philox4x32-10 of the counter words ``(c0, c1, c2, c3)`` (int64
    tensors or ints holding uint32 values, broadcast together) under the
    key ``(k0, k1)`` (ints, or 0-d int64 tensors on the counters'
    device). Returns four int64 tensors of uint32 values."""
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


def seed_words(seed: Ints):
    """The key words of a 64-bit seed (negative seeds wrap); of a 0-d
    int64 tensor, two 0-d tensors on its device."""
    if isinstance(seed, torch.Tensor):
        return seed & _M32, _shr(seed, 32)
    s = int(seed) % (1 << 64)
    return s & _M32, s >> 32


def uniform24(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 uniforms in (0, 1]: the top 24 bits plus
    one, over 2^24 (exact in fp32)."""
    return ((bits >> 8).to(torch.float32) + 1.0) * (1.0 / 16777216.0)


def keyed_words(shape: Sequence[int], seed: Ints, index: torch.Tensor,
                sample: Ints, stream: int, band: Optional[Band] = None):
    """Philox output words for a ``[B, ...]`` tensor whose row ``i`` is
    keyed by ``(seed, index[i], sample[i], stream)``. Returns four int64
    ``[B, prod(shape[1:])]`` tensors. B stays as it comes, so a
    ``torch.export`` trace keeps a symbolic batch. With ``band`` the tensor
    is ``[B, C, hb, W]``, rows ``[h0, h0 + hb)`` of height-``h`` maps, and
    element ``(c, y, x)`` takes the counter of ``(c, h0 + y, x)`` in the
    whole map: the bands concatenated draw what the whole map draws."""
    b = shape[0]
    n = math.prod(shape[1:])
    index = torch.as_tensor(index, dtype=torch.int64)
    if index.shape != (b,):
        raise ValueError(f"index must be int64 [{b}], got {tuple(index.shape)}")
    device = index.device
    # an int sample as a fill on the device: a copy from the host would
    # break a CUDA graph's capture
    sample = (sample.to(device=device, dtype=torch.int64) if isinstance(sample, torch.Tensor)
              else torch.full((), int(sample), dtype=torch.int64, device=device))
    offset = torch.arange(n, dtype=torch.int64, device=device).view(1, n)
    if band is not None:
        offset = band_map(shape, band).at(offset)
    k0, k1 = seed_words(seed)
    words = philox4x32(
        offset,
        (index & _M32).view(b, 1),
        (sample & _M32).expand(b).reshape(b, 1),
        stream & _M32,
        k0, k1,
    )
    return [w.expand(b, n) for w in words]


def dropout_bytes(shape: Sequence[int], seed: Ints,
                  device: torch.device | None = None,
                  emap: ElementMap = ElementMap()) -> torch.Tensor:
    """The fused segment's dropout byte of every element of a tensor of
    ``shape`` (uint8, on ``device``): element ``e`` (its flat row-major
    index) takes byte ``j = e % 16`` of the Philox output at counter
    ``(e // 16 low word, high word, 0, STREAM_SEGMENT_DROPOUT)`` under the
    key of ``seed``, i.e. ``(word[j // 4] >> 8 (j % 4)) & 255``: one call
    gives 16 bytes. ``seed`` is ``mix_seed(train seed, step, site)``, an
    int or a 0-d int64 tensor on ``device`` (a step on the device gives
    one); ``csrc/segment.cu`` regenerates the same bytes in every pass.
    ``emap`` maps ``e`` to its global element (:class:`ElementMap`): a
    rank's part of the global batch (its rows, or its band of them) takes
    the bytes of its global elements."""
    if device is None and isinstance(seed, torch.Tensor):
        device = seed.device
    n = 1
    for d in shape:
        n *= int(d)
    k0, k1 = seed_words(seed)
    if emap != ElementMap():
        e = emap.at(torch.arange(n, dtype=torch.int64, device=device))
        grp = e >> 4
        words = torch.stack(philox4x32(grp & _M32, grp >> 32, 0, STREAM_SEGMENT_DROPOUT,
                                       k0, k1), dim=1)                # [n, 4]
        j = e & 15
        w = words.gather(1, (j >> 2).view(-1, 1)).view(-1)
        return ((w >> ((j & 3) * 8)) & 255).to(torch.uint8).reshape(tuple(shape))
    grp = torch.arange((n + 15) // 16, dtype=torch.int64, device=device)
    words = torch.stack(philox4x32(grp & _M32, grp >> 32, 0, STREAM_SEGMENT_DROPOUT,
                                   k0, k1), dim=1)                    # [n/16, 4]
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)    # 0, 8, 16, 24
    b = (words.unsqueeze(-1) >> shifts) & 255                         # [n/16, 4, 4]
    return b.reshape(-1)[:n].to(torch.uint8).reshape(tuple(shape))


def keyed_normal(shape: Sequence[int], seed: Ints, index: torch.Tensor,
                 sample: Ints, stream: int, band: Optional[Band] = None) -> torch.Tensor:
    """Standard normals of ``shape`` (fp32, on ``index``'s device), row
    ``i`` keyed by ``(seed, index[i], sample[i], stream)``; a ``band`` of
    rows draws its part of the whole map's (:func:`keyed_words`)."""
    w = keyed_words(shape, seed, index, sample, stream, band)
    u1, u2 = uniform24(w[0]), uniform24(w[1])
    # a fill on the device, not a copy from the host: a CUDA graph of the
    # train step cannot capture a copy from pageable host memory
    two_pi = torch.full((), _TWO_PI, dtype=torch.float32, device=u2.device)
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
    return eps.reshape(tuple(shape))


def keyed_uniform(shape: Sequence[int], seed: Ints, index: torch.Tensor,
                  sample: Ints, stream: int, band: Optional[Band] = None) -> torch.Tensor:
    """Uniforms in (0, 1] of ``shape``, keyed like :func:`keyed_normal`
    (output word 0); ``seed`` or ``sample`` may be a tensor on the device
    (a step), so no host int is read."""
    w = keyed_words(shape, seed, index, sample, stream, band)
    return uniform24(w[0]).reshape(tuple(shape))
