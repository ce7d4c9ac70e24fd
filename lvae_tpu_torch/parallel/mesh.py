"""The rank layout of data- and height-parallel training (port of
``lvae_tpu/parallel/mesh.py:41-164``).

``lvae_tpu`` builds a ``data`` mesh, or with ``--spatial-shards S`` a 2-D
``(data, space)`` one, and lets XLA's SPMD partitioner insert every
cross-device exchange. The port runs one process per rank over
``torch.distributed`` and writes those exchanges out:

- the parameters, the optimiser state, the EMA and the uint8 splits are
  replicated: every rank holds its own copy (rank 0's is broadcast at the
  start, :func:`replicate_to_mesh`), so ``lvae_tpu``'s ``local_copy`` has
  nothing to do and no twin;
- rank ``r = d S + s`` of ``D x S`` is data index ``d`` and space index
  ``s`` (``lvae_tpu``'s row-major grid, a space group on consecutive
  ranks). The global batch is sharded on the data index: data index
  ``d`` holds the contiguous rows ``[d B / D, (d + 1) B / D)`` of each
  global index vector (:func:`shard_batch`);
- in a training forward with ``S > 1`` (:func:`banded`) every activation
  of global height ``H`` is split into bands of ``ceil(H / S)`` rows
  (:func:`band`), space index ``s`` holding band ``s``; a convolution
  takes the rows its band needs from the other bands of its space group
  (:func:`gather_rows`, the halo exchange XLA inserts);
- what the mesh reduces across shards, the port all-reduces: the
  BatchNorm statistics and their backward (``models/blocks.py``, the
  split segment kernels of ``kernels/segment.py``) over every rank; each
  sample's log-likelihood and KL, summed over the bands of a space group
  (:func:`space_sum`); the loss's batch means before the free-bits clamp
  over the data group (``train/state.py``); the gradients over every rank
  (summed: each rank holds its rows' and its band's part of the global
  loss's gradient); the metrics and the test sums.

Every training draw is keyed by the global dataset row or the global
element (the latents, the preprocessing, the dropout masks), so ``D x S``
ranks draw what one rank draws, as threefry's position-consistent draws
do on the mesh (``lvae_tpu/parallel/mesh.py:18-24``).

:class:`Layout` is the rank layout; :func:`current` is the one the model
and the train step read. Without a process group it is the one-rank
layout, and every function here is then the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Iterable, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from lvae_tpu_torch.ops.philox import Band, ElementMap


@dataclasses.dataclass(frozen=True)
class Layout:
    """``size`` ranks, this process rank ``rank``, over the world group
    ``group`` (None: one process, no collectives); ``control`` is a gloo
    group for the host's agreements (a stop flag, a run name), the world
    group itself under gloo; ``backend`` is the world group's.

    ``n_space`` is the space axis' size S (``--spatial-shards``): rank
    ``r`` is data index ``r // S`` of ``size // S`` and space index ``r %
    S``. ``space_group`` holds this rank's space group (the S ranks of its
    data index), ``data_group`` its data group (the ranks of its space
    index); both are None where S is 1 (the data group is then the
    world)."""

    rank: int = 0
    size: int = 1
    group: Any = None
    control: Any = None
    backend: Optional[str] = None
    n_space: int = 1
    space_group: Any = None
    data_group: Any = None

    @property
    def distributed(self) -> bool:
        """Whether there is a process group (even of one rank)."""
        return self.group is not None

    @property
    def sharded(self) -> bool:
        """Whether the work is split over more than one rank."""
        return self.size > 1

    @property
    def primary(self) -> bool:
        """Rank 0: the one that writes checkpoints, logs and images."""
        return self.rank == 0

    @property
    def data(self) -> int:
        """This rank's data index."""
        return self.rank // self.n_space

    @property
    def n_data(self) -> int:
        """The data axis' size (``--num-data-shards``)."""
        return self.size // self.n_space

    @property
    def space(self) -> int:
        """This rank's space index."""
        return self.rank % self.n_space

    @property
    def batch_group(self) -> Any:
        """The group that a batch mean reduces over: the data group, or
        the world where there is no space axis."""
        return self.data_group if self.n_space > 1 else self.group

    def flat(self) -> "Layout":
        """The world as a data axis of ``size`` ranks (no space axis):
        the test sweep's layout, whose batch every rank shares."""
        return dataclasses.replace(self, n_space=1, space_group=None, data_group=None)

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n``: its data
        index's."""
        if n % self.n_data:
            raise ValueError(f"a global batch of {n} rows does not divide over {self.n_data} "
                             f"ranks (--num-data-shards)")
        per = n // self.n_data
        return slice(self.data * per, (self.data + 1) * per)


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


def make_mesh(n_devices: Optional[int] = None, spatial: int = 1) -> Layout:
    """The layout of the process group this process joined
    (:func:`lvae_tpu_torch.parallel.multihost.initialize`), checked to
    have ``n_devices x spatial`` ranks with a space axis of ``spatial``:
    the port's ``make_mesh``."""
    layout = current()
    if spatial < 1:
        raise ValueError(f"--spatial-shards must be >= 1, got {spatial}")
    if n_devices is not None and (n_devices * spatial != layout.size
                                  or spatial != layout.n_space):
        raise ValueError(
            f"--num-data-shards {n_devices} --spatial-shards {spatial} needs "
            f"{n_devices * spatial} ranks with a space axis of {spatial}; this process group "
            f"has {layout.size} with {layout.n_space}")
    return layout


def shard_batch(x: torch.Tensor, layout: Optional[Layout] = None, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous rows of ``x`` along ``dim`` (the batch axis:
    0 for ``[B, ...]``, 1 for a ``[k, B, ...]`` stack): its data index's."""
    layout = layout or current()
    if layout.n_data == 1:
        return x
    return x.narrow(dim, layout.rows(x.shape[dim]).start, x.shape[dim] // layout.n_data)


def make_global_batch_indices(global_idx: torch.Tensor,
                              layout: Optional[Layout] = None) -> torch.Tensor:
    """This rank's part of a global index vector ``[B]`` (or of each row
    of a ``[k, B]`` stack): its data index's contiguous rows, as the
    ``data`` mesh shards them."""
    return shard_batch(global_idx, layout, dim=global_idx.dim() - 1)


def element_map(x: torch.Tensor, layout: Optional[Layout] = None) -> ElementMap:
    """Where this rank's elements of the NCHW activation ``x`` lie in the
    global batch's tensor (:class:`~lvae_tpu_torch.ops.philox.ElementMap`):
    its data index's rows (one run, from its first element's flat index)
    and, inside :func:`banded`, its band's rows of each image; the map a
    keyed dropout mask takes so that ``D x S`` ranks drop what one rank
    drops."""
    layout = layout or current()
    bands = current_bands()
    if bands is None:
        return ElementMap(base=layout.data * x.numel() if layout.n_data > 1 else 0)
    b, c, hb, w = x.shape
    h = bands.height(x)
    h0, _ = bands.rows(h)
    return ElementMap(hb * w, h * w, layout.data * b * c * h * w + h0 * w)


# ---------------------------------------------------------------------------
# the space axis: bands of rows and the halo exchange
# ---------------------------------------------------------------------------

def band(h: int, count: int, index: int) -> Tuple[int, int]:
    """Band ``index`` of ``count`` of a height-``h`` activation: rows
    ``[min(index c, h), min((index + 1) c, h))`` with ``c = ceil(h /
    count)``, as XLA shards an uneven dimension. A band can be short or
    empty (a 2-row map over 4 ranks: 1, 1, 0 and 0 rows)."""
    c = -(-h // count)
    return min(index * c, h), min((index + 1) * c, h)


@dataclasses.dataclass(frozen=True)
class Bands:
    """The height sharding of a training forward: this rank holds band
    ``index`` of ``count`` (:func:`band`) of every activation, and
    exchanges rows over ``group`` (its space group). An activation's
    global height is its width times ``aspect`` (the padded image's
    height over its width: widths are never sharded, and every map of
    the model keeps the image's aspect)."""

    index: int
    count: int
    group: Any
    aspect: Tuple[int, int]

    def height(self, x: torch.Tensor) -> int:
        """The global height of the activation ``x`` (a band of it)."""
        return x.shape[-1] * self.aspect[0] // self.aspect[1]

    def rows(self, h: int) -> Tuple[int, int]:
        """This rank's band of a height-``h`` activation."""
        return band(h, self.count, self.index)

    def band_of(self, x: torch.Tensor) -> Band:
        """``x``'s place in its global activation: (global height, first
        row)."""
        h = self.height(x)
        return Band(h, self.rows(h)[0])


_BANDS: list = [None]


def current_bands() -> Optional[Bands]:
    """The height sharding in force (None: every rank holds whole rows)."""
    return _BANDS[0]


@contextlib.contextmanager
def banded(bands: Optional[Bands]) -> Iterator[Optional[Bands]]:
    """``bands`` in force inside the block (None: none)."""
    saved = _BANDS[0]
    _BANDS[0] = bands
    try:
        yield bands
    finally:
        _BANDS[0] = saved


def global_height(x: torch.Tensor) -> int:
    """The global height of the NCHW activation ``x``: its band's map's
    inside :func:`banded`, else its own."""
    bands = _BANDS[0]
    return x.shape[-2] if bands is None else bands.height(x)


def bands_for(layout: Layout, size: Sequence[int]) -> Optional[Bands]:
    """The height sharding of a training forward over ``layout`` on images
    padded to ``size`` (None without a space axis)."""
    if layout.n_space == 1:
        return None
    return Bands(layout.space, layout.n_space, layout.space_group,
                 (int(size[0]), int(size[1])))


class RowPlan(NamedTuple):
    """How one rank takes its rows from a space group's bands
    (:func:`row_plan`): the rows ``depth`` at each end of every band go
    into its slot of a ``[B, C, count 2 depth, W]`` buffer (the top ones
    at ``[0, depth)``, the bottom ones at ``[depth, 2 depth)``), which one
    all-reduce over the group fills (0 depth: no exchange). ``source[i]``
    is where output row ``i`` comes from in ``cat([band, buffer, one zero
    row])``; ``back[j]`` is the output row that reads source row ``j``
    (``len(source)`` where none does, the index of a zero cotangent)."""

    depth: int
    rows: int           # this rank's band's rows
    source: Tuple[int, ...]
    back: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def row_plan(h: int, count: int, index: int, want: Tuple[Tuple[int, int], ...]) -> RowPlan:
    """The plan for rank ``index`` of ``count`` to take global rows
    ``want[index]`` of a height-``h`` activation (zeros outside ``[0,
    h)``), every rank ``s`` of the group taking ``want[s]`` in the same
    exchange. ``depth`` is the least that carries every row a rank takes
    from another band: a row ``r`` of band ``[a, b)`` travels in the top
    slot where ``r - a < depth``, else in the bottom one."""
    bands = [band(h, count, t) for t in range(count)]
    depth = 0
    for s, (lo, hi) in enumerate(want):
        for t, (a, b) in enumerate(bands):
            if t != s:
                for r in range(max(lo, a), min(hi, b)):
                    depth = max(depth, min(r - a + 1, b - r))
    h0, h1 = bands[index]
    n = h1 - h0
    zero = n + count * 2 * depth
    lo, hi = want[index]
    source = []
    for r in range(lo, hi):
        if not 0 <= r < h:
            source.append(zero)
        elif h0 <= r < h1:
            source.append(r - h0)
        else:
            t = next(t for t, (a, b) in enumerate(bands) if a <= r < b)
            a, b = bands[t]
            pos = r - a if r - a < depth else 2 * depth - (b - r)
            source.append(n + t * 2 * depth + pos)
    back = [len(source)] * (zero + 1)
    for i, j in enumerate(source):
        if j != zero:
            back[j] = i
    return RowPlan(depth, n, tuple(source), tuple(back))


@functools.lru_cache(maxsize=None)
def row_index(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``values`` as an int64 index on ``device``, made once: a CUDA graph
    captured after the first (eager) call reads the same tensor and copies
    nothing from the host."""
    return torch.tensor(values, dtype=torch.long, device=device)


def _exchange(t: torch.Tensor, group: Any) -> torch.Tensor:
    """The all-reduce of an exchange's buffer over the space group, in
    place: exact, each element having one nonzero term."""
    import torch.distributed as dist

    dist.all_reduce(t, group=group)
    return t


class _GatherRows(torch.autograd.Function):
    """:func:`gather_rows` with its backward: each taken row's cotangent
    goes back to the band that holds the row, through the same exchange,
    and is added there."""

    @staticmethod
    def forward(ctx, x, plan, bands):
        b, c, _, w = x.shape
        d = plan.depth
        parts = [x]
        if d:
            buf = x.new_zeros((b, c, bands.count * 2 * d, w))
            k = min(d, plan.rows)
            slot = bands.index * 2 * d
            buf[:, :, slot:slot + k] = x[:, :, :k]
            buf[:, :, slot + 2 * d - k:slot + 2 * d] = x[:, :, plan.rows - k:]
            parts.append(_exchange(buf, bands.group))
        parts.append(x.new_zeros((b, c, 1, w)))
        ctx.plan, ctx.bands = plan, bands
        return torch.cat(parts, dim=2).index_select(2, row_index(plan.source, x.device))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        plan, bands = ctx.plan, ctx.bands
        b, c, _, w = g.shape
        d = plan.depth
        gs = torch.cat([g, g.new_zeros((b, c, 1, w))], dim=2).index_select(
            2, row_index(plan.back, g.device))
        gx = gs[:, :, :plan.rows].contiguous()
        if d:
            gbuf = _exchange(gs[:, :, plan.rows:plan.rows + bands.count * 2 * d].contiguous(),
                             bands.group)
            k = min(d, plan.rows)
            slot = bands.index * 2 * d
            gx[:, :, :k] += gbuf[:, :, slot:slot + k]
            gx[:, :, plan.rows - k:] += gbuf[:, :, slot + 2 * d - k:slot + 2 * d]
        return gx, None, None


def gather_rows(x: torch.Tensor, want: Sequence[Tuple[int, int]],
                bands: Optional[Bands] = None) -> torch.Tensor:
    """Global rows ``want[index]`` of the activation whose band ``x`` is
    (NCHW), zeros outside ``[0, H)``, while each rank ``s`` of the space
    group takes ``want[s]`` (every rank calls this together, with the same
    ``want``): one all-reduce of the bands' ends where any rank takes a
    row of another band, else none. Differentiable: the backward sends
    each taken row's cotangent to the band that holds it and adds it
    there. The halo exchange of a convolution and the rebalancing of a
    resample, which XLA's partitioner inserts on ``lvae_tpu``'s mesh."""
    bands = bands or current_bands()
    plan = row_plan(bands.height(x), bands.count, bands.index,
                    tuple((int(lo), int(hi)) for lo, hi in want))
    if x.shape[-2] != plan.rows:
        raise ValueError(f"x holds {x.shape[-2]} rows; band {bands.index} of "
                         f"{bands.count} of a height-{bands.height(x)} map has {plan.rows}")
    return _GatherRows.apply(x, plan, bands)


def halo(x: torch.Tensor, top: int, bottom: int, h: Optional[int] = None,
         bands: Optional[Bands] = None) -> torch.Tensor:
    """Rows ``[h0 - top, h1 + bottom)`` of the height-``h`` activation
    whose band ``[h0, h1)`` ``x`` is, zeros outside ``[0, h)``
    (:func:`gather_rows` with every rank taking its band and ``top`` rows
    above, ``bottom`` below; an empty band takes nothing): the rows a
    stride-1 convolution's output band reads (``Conv2d.banded``)."""
    bands = bands or current_bands()
    h = bands.height(x) if h is None else h
    want = []
    for t in range(bands.count):
        h0, h1 = band(h, bands.count, t)
        want.append((h0 - top, h1 + bottom) if h1 > h0 else (h0, h0))
    return gather_rows(x, want, bands)


class _SpaceSum(torch.autograd.Function):
    """A sum over the space group whose backward is the identity: every
    rank of the group computes the same loss from the sum, and counts it
    once, so each band's part takes the loss's cotangent once (the sum
    of the S ranks' cotangents would be S times it)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def space_sum(t: torch.Tensor, layout: Optional[Layout] = None) -> torch.Tensor:
    """``t`` (a band's part of per-sample sums) summed over the space group,
    differentiable with the identity backward (:class:`_SpaceSum`); the
    identity without a space axis."""
    layout = layout or current()
    if layout.n_space == 1:
        return t
    return _SpaceSum.apply(t, layout.space_group)


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


def all_reduce_sum(t: torch.Tensor, layout: Optional[Layout] = None,
                   group: Any = None) -> torch.Tensor:
    """``t`` summed over the ranks (over ``group``, by default the
    world), differentiable (the identity without a process group)."""
    layout = layout or current()
    if not layout.distributed:
        return t
    return _AllReduceSum.apply(t, layout.group if group is None else group)


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
    up to a multiple of the data axis' size, a short last batch padded to
    it with its final index, each data index its contiguous rows (the
    sweep never shards on space), ``valid`` a bool
    ``[rows]`` that masks the padding. On one rank nothing is padded (an
    eager forward takes any batch) and ``valid`` is all true."""
    layout = layout or current()
    n = test_u8.shape[0]
    device = test_u8.device
    bs = -(-batch_size // layout.n_data) * layout.n_data
    for bi, start in enumerate(range(0, n, bs)):
        if max_batches is not None and bi >= max_batches:
            break
        stop = min(start + bs, n)
        index = torch.arange(start, stop, device=device)
        if layout.n_data > 1 and stop - start < bs:
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
