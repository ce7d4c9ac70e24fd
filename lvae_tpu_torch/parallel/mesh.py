"""The rank layout of data-parallel training (port of
``lvae_tpu/parallel/mesh.py:41-164``).

``lvae_tpu`` builds a 1-D ``data`` mesh and lets XLA's SPMD partitioner
insert every cross-device reduction. The port runs one process per rank
over ``torch.distributed`` and writes those reductions out:

- the parameters, the optimiser state, the EMA and the uint8 splits are
  replicated: every rank holds its own copy (rank 0's is broadcast at the
  start, :func:`replicate_to_mesh`), so ``lvae_tpu``'s ``local_copy`` has
  nothing to do and no twin;
- the global batch is sharded: rank ``r`` of ``R`` holds the contiguous
  rows ``[r B / R, (r + 1) B / R)`` of each global index vector
  (:func:`shard_batch`), the order of ``lvae_tpu``'s 1-D ``data`` mesh;
- what the mesh reduces across shards, the port all-reduces: the
  BatchNorm statistics and their backward (``models/blocks.py``, the
  split segment kernels of ``kernels/segment.py``), the loss's batch means
  before the free-bits clamp (``train/state.py``), the gradients (summed:
  each rank holds its rows' part of the global loss's gradient), the
  metrics and the test sums.

Every training draw is keyed by the global dataset row or the global
element (the latents, the preprocessing, the dropout masks), so ``R``
ranks draw what one rank draws, as threefry's position-consistent draws
do on the mesh (``lvae_tpu/parallel/mesh.py:18-24``).

:class:`Layout` is the rank layout; :func:`current` is the one the model
and the train step read. Without a process group it is the one-rank
layout, and every function here is then the identity. The ``space`` axis
(``--spatial-shards``) has no port yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterable, Iterator, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Layout:
    """``size`` ranks, this process rank ``rank``, over the data group
    ``group`` (None: one process, no collectives); ``control`` is a gloo
    group for the host's agreements (a stop flag, a run name), the data
    group itself under gloo; ``backend`` is the data group's."""

    rank: int = 0
    size: int = 1
    group: Any = None
    control: Any = None
    backend: Optional[str] = None

    @property
    def distributed(self) -> bool:
        """Whether there is a process group (even of one rank)."""
        return self.group is not None

    @property
    def sharded(self) -> bool:
        """Whether the batch is split over more than one rank."""
        return self.size > 1

    @property
    def primary(self) -> bool:
        """Rank 0: the one that writes checkpoints, logs and images."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n``."""
        if n % self.size:
            raise ValueError(f"a global batch of {n} rows does not divide over {self.size} "
                             f"ranks (--num-data-shards)")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


_CURRENT = [Layout()]


def current() -> Layout:
    """The layout the model and the train step read."""
    return _CURRENT[0]


def set_layout(layout: Layout) -> None:
    _CURRENT[0] = layout


@contextlib.contextmanager
def use(layout: Layout) -> Iterator[Layout]:
    """``layout`` as :func:`current` inside the block (``Layout()`` turns
    every collective off, as data-dependent init wants)."""
    saved = _CURRENT[0]
    _CURRENT[0] = layout
    try:
        yield layout
    finally:
        _CURRENT[0] = saved


def make_mesh(n_devices: Optional[int] = None) -> Layout:
    """The layout of the process group this process joined
    (:func:`lvae_tpu_torch.parallel.multihost.initialize`), checked to
    have ``n_devices`` ranks: the port's ``make_mesh``."""
    layout = current()
    if n_devices is not None and n_devices != layout.size:
        raise ValueError(f"--num-data-shards {n_devices} needs {n_devices} ranks; this "
                         f"process group has {layout.size}")
    return layout


def shard_batch(x: torch.Tensor, layout: Optional[Layout] = None, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous rows of ``x`` along ``dim`` (the batch axis:
    0 for ``[B, ...]``, 1 for a ``[k, B, ...]`` stack)."""
    layout = layout or current()
    if not layout.sharded:
        return x
    return x.narrow(dim, layout.rows(x.shape[dim]).start, x.shape[dim] // layout.size)


def make_global_batch_indices(global_idx: torch.Tensor,
                              layout: Optional[Layout] = None) -> torch.Tensor:
    """This rank's part of a global index vector ``[B]`` (or of each row
    of a ``[k, B]`` stack): its contiguous rows, as the ``data`` mesh
    shards them."""
    return shard_batch(global_idx, layout, dim=global_idx.dim() - 1)


def element_offset(x: torch.Tensor, layout: Optional[Layout] = None) -> int:
    """The flat index, in the global batch's tensor, of this rank's first
    element of ``x`` (its part of a tensor sharded on dim 0): the offset a
    keyed dropout mask takes so that ``R`` ranks drop what one rank drops."""
    layout = layout or current()
    return layout.rank * x.numel() if layout.sharded else 0


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward is the sum of the cotangents:
    each rank's loss is its part of the global loss, so the gradient of
    the all-reduced value is the sum of every rank's."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(t: torch.Tensor, layout: Optional[Layout] = None) -> torch.Tensor:
    """``t`` summed over the ranks, differentiable (the identity without a
    process group)."""
    layout = layout or current()
    if not layout.distributed:
        return t
    return _AllReduceSum.apply(t, layout.group)


@torch.no_grad()
def all_reduce_(t: torch.Tensor, layout: Optional[Layout] = None) -> torch.Tensor:
    """``t`` summed over the ranks in place (no gradient)."""
    layout = layout or current()
    if layout.distributed:
        import torch.distributed as dist

        dist.all_reduce(t, group=layout.group)
    return t


@torch.no_grad()
def reduce_gradients_(params: Iterable[torch.Tensor], layout: Optional[Layout] = None) -> None:
    """Sum every parameter's gradient over the ranks, in place, with one
    all-reduce per dtype: each rank holds the gradient of its rows' part
    of the global loss, so the sum is the global loss's gradient (a mean
    would divide it by the rank count a second time). Parameters without
    a gradient stay so; every rank runs the same graph, so they are the
    same on every rank."""
    layout = layout or current()
    if not layout.distributed:
        return
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        all_reduce_(flat, layout)
        torch._foreach_copy_(group, [v.view_as(g) for v, g in
                                     zip(flat.split([g.numel() for g in group]), group)])


@torch.no_grad()
def replicate_to_mesh(module: torch.nn.Module, layout: Optional[Layout] = None) -> None:
    """Every parameter and buffer of ``module`` set to rank 0's, in place
    (a broadcast; a no-op without a process group)."""
    layout = layout or current()
    if not layout.distributed:
        return
    import torch.distributed as dist

    src = dist.get_global_rank(layout.group, 0)
    for t in [*module.parameters(), *module.buffers()]:
        dist.broadcast(t.data, src=src, group=layout.group)


def eval_batch_stream(test_u8: torch.Tensor, batch_size: int,
                      layout: Optional[Layout] = None,
                      max_batches: Optional[int] = None
                      ) -> Iterator[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``(index, batch, valid)`` of a sequential test sweep, sharded
    (``lvae_tpu/parallel/multihost.py:134-171``): the batch size rounded
    up to a multiple of the rank count, a short last batch padded to it
    with its final index, each rank its contiguous rows, ``valid`` a bool
    ``[rows]`` that masks the padding. On one rank nothing is padded (an
    eager forward takes any batch) and ``valid`` is all true."""
    layout = layout or current()
    n = test_u8.shape[0]
    device = test_u8.device
    bs = -(-batch_size // layout.size) * layout.size
    for bi, start in enumerate(range(0, n, bs)):
        if max_batches is not None and bi >= max_batches:
            break
        stop = min(start + bs, n)
        index = torch.arange(start, stop, device=device)
        if layout.sharded and stop - start < bs:
            index = torch.cat([index, index[-1:].expand(bs - (stop - start))])
        pos = torch.arange(index.shape[0], device=device)
        index, pos = shard_batch(index, layout), shard_batch(pos, layout)
        yield index, test_u8.index_select(0, index), pos < stop - start


def pack(values: Sequence[torch.Tensor]) -> tuple[torch.Tensor, list]:
    """Flatten tensors of one dtype into one vector (for one all-reduce)
    and the shapes to :func:`unpack` them with."""
    return torch.cat([v.reshape(-1) for v in values]), [v.shape for v in values]


def unpack(flat: torch.Tensor, shapes: list) -> list[torch.Tensor]:
    out, i = [], 0
    for s in shapes:
        n = 1
        for d in s:
            n *= d
        out.append(flat[i:i + n].view(s))
        i += n
    return out
