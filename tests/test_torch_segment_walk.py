"""K5 and K5-bwd's walk over a channel (``csrc/segment.cu`` ``fwd_kernel``,
``bwd_kernel``), mirrored in Python, on the CPU.

The CUDA kernels cannot run here, so the order in which they visit and sum
a channel's elements is held through a mirror of their loops, at the plans
that ``kernels/segment.py`` ``_plan`` gives every model shape in fp32 and
bf16 (the bf16 forward's one-wave clusters of 2 at 32x32 and 256 threads at
64x64, the backward's share partly on chip at 64x64 among them): each CTA
of a channel's cluster takes its share of units; a thread copies the units
kept on chip with ``cp.async`` (access i = thread + m T), waits for all of
its copies, sums them in that order, then sweeps the units read from device
memory (``sweep_rest``: chunks of ``KEEP_CHUNK`` units, ``kUnroll`` accesses
in flight). The mirror checks that every element is summed once and every
chip access is read back by the thread that copied it, and that the sums,
fp64 element by element in that order, then the warp, block and cluster
trees of ``cluster_sums``, give the channel's mean and variance within
phase 18a's 1e-6 relative of exact sums at a celeba64-sized channel whose
|mean| / std is 1, 100 and 1,000."""

import math

import numpy as np
import pytest

from lvae_tpu_torch.kernels import segment as seg
from lvae_tpu_torch.ops.math import bits8_keep_threshold

UNROLL = {"fwd": 4, "bwd": 2}   # fwd_kernel / bwd_kernel kUnroll: sweep_rest's accesses in flight
MODEL_SHAPES = [(128, 64, s, s) for s in (64, 32, 16, 8, 4, 2)] + \
               [(64, 64, s, s) for s in (32, 16, 8, 4, 2)]
ODD_SHAPES = [(4, 3, 7, 7), (2, 5, 1, 1), (8, 3, 16, 16), (1, 64, 8, 8), (3, 2, 5, 6)]


def _access(plan) -> int:
    """Elements of one access (csrc access_elems): 16 bytes, at most a unit."""
    return 1 if plan.vec == 1 else min(plan.vec, 16 // plan.esize)


def _share(plan, rank):
    """(first unit, units) of CTA ``rank``'s share (csrc share_of)."""
    units = plan.b * plan.hw // plan.vec
    lo = units * rank // plan.cluster
    return lo, units * (rank + 1) // plan.cluster - lo


def first_sweep(plan, rank, direction):
    """CTA ``rank``'s first sweep of a channel: ``(order, copied)``,
    ``order[t]`` the share's accesses (their first element, share-local) in
    the order thread t sums them, ``copied`` {chip access: thread} from the
    copies' loop (``stage`` / ``stage_slot``)."""
    f, t_ = _access(plan), plan.threads
    _, n = _share(plan, rank)
    n_chip = min(n, plan.chip)
    m_chip = n_chip * plan.vec // f
    copied = {}
    for t in range(t_):
        for i in range(t, m_chip, t_):
            assert i not in copied
            copied[i] = t
    order = [list(range(t, m_chip, t_)) for t in range(t_)]     # after cp.async.wait_all
    order = [[i * f for i in o] for o in order]
    rest = n - n_chip
    chunks = -(-rest // seg.KEEP_CHUNK) if rest > 0 else 0
    for q in range(chunks):                         # then sweep_rest, in chunk order
        u0 = n_chip + q * seg.KEEP_CHUNK
        m = min(seg.KEEP_CHUNK, n - u0) * plan.vec // f
        for t in range(t_):
            for i in range(t, m, UNROLL[direction] * t_):
                for k in range(UNROLL[direction]):
                    if i + k * t_ < m:
                        order[t].append(u0 * plan.vec + (i + k * t_) * f)
    return order, copied


@pytest.mark.parametrize("esize", (4, 2), ids=("fp32", "bf16"))
@pytest.mark.parametrize("direction", ("fwd", "bwd"))
@pytest.mark.parametrize("shape", MODEL_SHAPES + ODD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_walk_sums_every_element_once(shape, direction, esize):
    """Every CTA of a channel's cluster: each element of its share summed
    once, by one thread; each chip access copied once, by the thread that
    reads it back (the only one whose wait covers it); the shares cover the
    channel."""
    plan = seg._plan(*shape, direction, None, esize)
    f = _access(plan)
    seen = np.zeros(plan.b * plan.hw, np.int64)
    for rank in range(plan.cluster):
        lo, n = _share(plan, rank)
        order, copied = first_sweep(plan, rank, direction)
        assert len(copied) == min(n, plan.chip) * plan.vec // f
        for t, accesses in enumerate(order):
            assert all(copied[a // f] == t for a in accesses if a // f in copied
                       and a < min(n, plan.chip) * plan.vec)
        for accesses in order:
            for a in accesses:
                seen[lo * plan.vec + a: lo * plan.vec + a + f] += 1
    assert (seen == 1).all()


def _tree_sum(order, u, threads, f):
    """fp64 sums of ``u`` (the share's values) in csrc's order: each thread
    element by element, then cluster_sums' warp shuffle-down tree and the
    butterfly over the warps (lane 0's bits)."""
    s = np.zeros(threads)
    longest = max(len(o) for o in order)
    idx = np.full((threads, longest * f), -1)
    for t, accesses in enumerate(order):
        e = (np.asarray(accesses, np.int64)[:, None] + np.arange(f)).ravel()
        idx[t, :len(e)] = e
    vals = np.where(idx >= 0, u[np.maximum(idx, 0)], 0.0)
    for j in range(vals.shape[1]):                  # one add a step, as a thread's loop
        s = s + vals[:, j]
    warps = s.reshape(-1, 32)
    for o in (16, 8, 4, 2, 1):                      # __shfl_down_sync: lane l += lane l + o
        warps = warps + np.concatenate([warps[:, o:], warps[:, -o:]], axis=1)
    return butterfly16(warps[:, 0])


def butterfly16(v):
    """sum16: lanes 0-15 hold ``v`` (zeros past it), a += lane (l ^ o) for
    o = 8, 4, 2, 1; lane 0's bits."""
    a = np.zeros(16)
    a[:len(v)] = v
    for o in (8, 4, 2, 1):
        a = a + a[np.arange(16) ^ o]
    return a[0]


def kernel_stats(plan, u, direction="fwd"):
    """(mean, var) as fp32 from the channel's u (B H W values in NCHW
    strip order) through the mirror: each rank's sums of u and u^2, the
    butterfly over the ranks, mean = s1 (1 / n), var = s2 (1 / n) -
    mean^2 in fp64 (csrc coef_of)."""
    f = _access(plan)
    pairs = []
    for rank in range(plan.cluster):
        lo, n = _share(plan, rank)
        order, _ = first_sweep(plan, rank, direction)
        share = u[lo * plan.vec:(lo + n) * plan.vec]
        pairs.append((_tree_sum(order, share, plan.threads, f),
                      _tree_sum(order, share * share, plan.threads, f)))
    s1, s2 = (butterfly16(np.array(p)) if plan.cluster > 1 else p[0] for p in zip(*pairs))
    inv_n = 1.0 / u.size
    mean = s1 * inv_n
    return np.float32(mean), np.float32(s2 * inv_n - mean * mean)


@pytest.mark.parametrize("esize", (4, 2), ids=("fp32", "bf16"))
@pytest.mark.parametrize("rate", (0.0, 0.2))
@pytest.mark.parametrize("ratio", (1, 100, 1000))
def test_sums_hold_mean_and_var_at_a_celeba64_channel(ratio, rate, esize):
    """One channel of celeba64's [128, 64, 64, 64] (524,288 elements, a
    cluster of 16) at |mean| / std = ``ratio``, with and without the bits8
    mask, x rounded to the storage dtype: the mirror's mean and var within
    1e-6 relative of exact sums (math.fsum) of the same u, forward's plan
    and the backward's (partial on chip in bf16: its rest summed first)."""
    rng = np.random.default_rng(ratio)
    n = 128 * 64 * 64
    x = (rng.normal(size=n) + ratio).astype(np.float32)
    if esize == 2:                                  # bf16: round to 8 significant bits
        x = (x.view(np.uint32) + 0x7FFF + ((x.view(np.uint32) >> 16) & 1)
             & 0xFFFF0000).view(np.float32)
    t = bits8_keep_threshold(rate)
    keep = rng.integers(0, 256, size=n) < t if t < 256 else np.ones(n, bool)
    scale = np.float32(256.0 / t) if t < 256 else np.float32(1.0)
    u = np.where(keep, x * scale, np.float32(0.0)).astype(np.float64)
    mean_x = math.fsum(u) / n
    var_x = math.fsum(u * u) / n - mean_x * mean_x
    for direction in ("fwd", "bwd"):
        plan = seg._plan(128, 64, 64, 64, direction, None, esize)
        mean, var = kernel_stats(plan, u, direction)
        assert abs(mean - mean_x) <= 1e-6 * abs(mean_x)
        assert abs(var - var_x) <= 1e-6 * abs(var_x)
