"""The host-fed input pipeline, ``--streaming`` (port of
``lvae_tpu/data/streaming.py``).

The device-resident split (:class:`~lvae_tpu_torch.data.device.
DeviceDataset`) is the default. Under ``--streaming`` the training split
stays in host RAM or a memmap, for a split that should not take device
memory: each step's uint8 rows are gathered on the host and copied to the
device, where the step preprocesses them as it does a resident batch.

Two loaders (``--stream-impl``), which draw ``lvae_tpu``'s batches byte
for byte:

- ``array`` (:class:`ArrayLoader`, the default): epoch ``e``'s order is
  ``np.random.default_rng([seed, shard_index, e]).permutation(n)``, the
  ``n % B`` remainder dropped per epoch, a k-stack straddling an epoch's
  end indexed in each epoch's own order.
- ``grain`` (:class:`GrainLoader`): ``grain``'s shuffle of the row
  numbers, repeated, then batched (its batches straddle epochs), with
  ``grain``'s prefetch threads; ``grain`` is imported when the loader is
  built, and a missing package raises with its name.

Both hand out each batch with its rows of the whole split, ``(index,
batch)``: the port keys every training draw by the dataset row
(``train/state.py``), where ``lvae_tpu`` keys it by the step alone. Under
``shard_index`` / ``shard_count`` a shard holds the rows ``shard_index +
shard_count * i``. ``epochs(start_step)`` fast-forwards in O(1), so a
resumed run takes the batches an uninterrupted one takes; a start that is
not a multiple of ``steps_per_call`` raises, as in ``lvae_tpu``.

:class:`HostFeed` moves the stacks to the device: it gathers each stack
with one ``np.take`` into one of two pinned staging buffers and copies it
to the device on the current stream without blocking; a buffer is written
again only once an event shows its last copy done, so the host gathers
stack n+1 while the device runs call n. Over R ranks (the port of
``make_sharded_streaming_step``, ``lvae_tpu/data/streaming.py:239-285``)
every rank runs the same loader, so each draws the global batches that
one rank draws, and its feed loads and puts only its contiguous rows of
each (:func:`lvae_tpu_torch.parallel.mesh.make_global_batch_indices`):
the ``B / R`` rows of the ``data`` mesh's shard, with no copy of the rest.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from lvae_tpu_torch.parallel import mesh


class _Loader:
    """What both loaders share: the shard's rows, the batch checks, the
    gather and :meth:`epochs`. A loader yields ``[k, B]`` index stacks of
    the whole split's rows from :meth:`indices`."""

    def __init__(self, array_u8: np.ndarray, batch_size: int, seed: int = 0,
                 num_threads: int = 0, steps_per_call: int = 1, shard_index: int = 0,
                 shard_count: int = 1):
        n = len(range(shard_index, len(array_u8), shard_count))
        if batch_size > n:
            raise ValueError(f"per-shard batch {batch_size} exceeds the shard's {n} images")
        self.array = array_u8
        self.batch_size = batch_size
        self.seed, self.num_threads = seed, num_threads
        self.steps_per_call = max(1, steps_per_call)
        self.shard_index, self.shard_count = shard_index, shard_count
        self.n = n

    def _check_start(self, start_step: int) -> None:
        if start_step % self.steps_per_call:
            raise ValueError(
                f"resume step {start_step} is not a multiple of steps_per_call "
                f"{self.steps_per_call}: the stream cannot land mid-stack")

    def _rows(self, local: np.ndarray) -> np.ndarray:
        """The shard's positions as rows of the whole split."""
        return self.shard_index + self.shard_count * local

    def indices(self, start_step: int = 0) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def gather(self, index: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        """The rows ``index`` (any shape) of the split, ``index.shape +
        image shape``, gathered by one ``np.take`` (into ``out`` when
        given)."""
        shape = index.shape + self.array.shape[1:]
        if out is None:
            out = np.empty(shape, dtype=self.array.dtype)
        np.take(self.array, index.reshape(-1), axis=0,
                out=out.reshape((-1,) + self.array.shape[1:]))
        return out

    def epochs(self, start_step: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Endless ``(index, batch)`` pairs from ``start_step``: ``[B]``
        and ``[B, H, W, C]`` for ``steps_per_call`` 1, ``[k, B]`` and
        ``[k, B, H, W, C]`` stacks otherwise."""
        for index in self.indices(start_step):
            batch = self.gather(index)
            yield (index[0], batch[0]) if self.steps_per_call == 1 else (index, batch)


class ArrayLoader(_Loader):
    """Permutation and one batched gather per call over an in-memory or
    memmapped array (``lvae_tpu``'s ``ArrayLoader``, ``--stream-impl
    array``): within an epoch each image comes at most once; the ``n % B``
    remainder is dropped per epoch. ``num_threads`` is taken for the
    signature's sake; no thread is used."""

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, self.shard_index, epoch])
        return rng.permutation(self.n)

    def indices(self, start_step: int = 0) -> Iterator[np.ndarray]:
        k, b = self.steps_per_call, self.batch_size
        self._check_start(start_step)
        per_epoch = self.n // b
        g = start_step          # the global batch: one batch per optimiser step
        perm_epoch, perm = -1, None
        while True:
            idx = np.empty((k, b), dtype=np.int64)
            for j in range(k):
                epoch, i = divmod(g + j, per_epoch)
                if epoch != perm_epoch:
                    perm, perm_epoch = self._perm(epoch), epoch
                idx[j] = perm[i * b:(i + 1) * b]
            yield self._rows(idx)
            g += k


class GrainLoader(_Loader):
    """``lvae_tpu``'s ``GrainLoader`` (``--stream-impl grain``): grain's
    shuffle of the shard's row numbers, repeated without end and batched
    (so a batch may straddle an epoch), read through ``num_threads``
    prefetch threads; each batch's rows are then gathered. The shuffle
    does not read the items, so its batches are those of ``lvae_tpu``'s
    loader, which shuffles the images themselves."""

    def __init__(self, array_u8: np.ndarray, batch_size: int, seed: int = 0,
                 num_threads: int = 4, steps_per_call: int = 1, shard_index: int = 0,
                 shard_count: int = 1):
        try:
            import grain.python as grain
        except ImportError as e:
            raise ModuleNotFoundError(
                "--stream-impl grain needs the 'grain' package, which is not installed; "
                "use --stream-impl array") from e
        super().__init__(array_u8, batch_size, seed, num_threads, steps_per_call, shard_index,
                         shard_count)
        self._grain = grain
        if shard_count > 1:     # (seed, shard) mixed, as lvae_tpu mixes them
            self.seed = int(np.random.SeedSequence([seed, shard_index]).generate_state(1)[0])

    def indices(self, start_step: int = 0) -> Iterator[np.ndarray]:
        grain, k = self._grain, self.steps_per_call
        self._check_start(start_step)
        ds = (grain.MapDataset.source(np.arange(self.n, dtype=np.int64))
              .seed(self.seed).shuffle().repeat(None)
              .batch(self.batch_size, drop_remainder=True))
        if start_step:
            ds = ds[start_step:]
        it = ds.to_iter_dataset(
            grain.ReadOptions(num_threads=self.num_threads, prefetch_buffer_size=8))
        buf = []
        for local in it:
            buf.append(np.asarray(local))
            if len(buf) == k:
                yield self._rows(np.stack(buf))
                buf = []


def make_loader(impl: str, array_u8: np.ndarray, batch_size: int, seed: int,
                steps_per_call: int) -> _Loader:
    """The ``--stream-impl`` loader over one shard (the whole split)."""
    loaders = {"array": ArrayLoader, "grain": GrainLoader}
    if impl not in loaders:
        raise ValueError(f"unknown --stream-impl {impl!r}; choose from {tuple(loaders)}")
    return loaders[impl](array_u8, batch_size, seed=seed, steps_per_call=steps_per_call)


class HostFeed:
    """The loader's stacks on ``device``: :meth:`stream` yields ``(index,
    batch)`` device tensors (``[k, B]`` int64 and ``[k, B, H, W, C]``
    uint8, or ``[B]`` and ``[B, H, W, C]`` at ``k = 1``).

    On CUDA each stack is gathered into one of two pinned staging buffers
    and copied with ``non_blocking=True`` on the current stream; an event
    recorded after the copy must have completed before that buffer is
    written again. The copy lands in a fresh device tensor, so a caller
    may keep what it was handed. On the CPU each stack is gathered into
    a fresh array. Over the ranks of ``layout`` each stack is this rank's
    columns of the loader's ``[k, B]`` one, ``B / R`` rows a step."""

    def __init__(self, loader: _Loader, device: torch.device,
                 layout: Optional[mesh.Layout] = None):
        self.loader, self.device = loader, torch.device(device)
        self.layout = layout or mesh.Layout()
        self.cols = self.layout.rows(loader.batch_size)
        kb = (loader.steps_per_call, self.cols.stop - self.cols.start)
        self.slots = []
        if self.device.type == "cuda":
            self.slots = [(torch.empty(kb, dtype=torch.int64, pin_memory=True),
                           torch.empty(kb + loader.array.shape[1:], dtype=torch.uint8,
                                       pin_memory=True),
                           torch.cuda.Event()) for _ in range(2)]
        self.stacks = 0

    def stream(self, start_step: int = 0) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        k = self.loader.steps_per_call
        for index in self.loader.indices(start_step):
            index_t, batch_t = self.put(np.ascontiguousarray(index[:, self.cols]))
            yield (index_t[0], batch_t[0]) if k == 1 else (index_t, batch_t)

    def put(self, index: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stack of rows ``index`` (``[k, B]``) on the device."""
        if not self.slots:
            return (torch.from_numpy(np.ascontiguousarray(index)),
                    torch.from_numpy(self.loader.gather(index)))
        index_h, batch_h, done = self.slots[self.stacks % 2]
        self.stacks += 1
        done.synchronize()              # this buffer's last copy has landed
        index_h.numpy()[...] = index
        self.loader.gather(index, out=batch_h.numpy())
        index_d = index_h.to(self.device, non_blocking=True)
        batch_d = batch_h.to(self.device, non_blocking=True)
        done.record()
        return index_d, batch_d
