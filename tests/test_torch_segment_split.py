"""K5-split and K5-bwd-split, the segment over R > 1 ranks, on the CPU.

The CUDA launches (``csrc/segment.cu`` ``split_*_kernel``) cannot run
here, so what they do is held in three ways: the launch plan
(``kernels/segment.py`` ``split_plan``) is the same on every rank of every
layout; a Python mirror of the kernels' walk (``split_walk``: slices of a
channel's units, a warp's tiles of 32 units in two stages, a lane's
accesses and the shuffle of its unit's keep bits) covers every element
once and gives each the dropout byte of ``ops/philox.dropout_bytes`` under
the rank's element map; and the four plain versions (``ops/math.py``
``segment_split_*``), each rank's part with the sums added by hand, match
``lvae_tpu``'s ``fused_dropout_bn_act`` on the whole batch in interpret
mode, forward and VJP, fed the interpret kernel's own bytes as
``tests/test_torch_segment.py`` does. Tolerances are that file's (forward
1e-5, gradients 1e-4): the Pallas kernel computes in fp32, the plain
versions here in float64."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lvae_tpu.kernels.segment_pallas import fused_dropout_bn_act as j_segment
from lvae_tpu_torch.kernels import segment as seg
from lvae_tpu_torch.ops.math import (
    bits8_keep_threshold,
    segment_split_apply,
    segment_split_bwd_apply,
    segment_split_bwd_reduce,
    segment_split_stats,
)
from lvae_tpu_torch.ops.philox import (
    STREAM_SEGMENT_DROPOUT,
    ElementMap,
    dropout_bytes,
    philox4x32,
    seed_words,
)
from lvae_tpu_torch.parallel import mesh

# ---------------------------------------------------------------------------
# (a) the plan: one on every rank
# ---------------------------------------------------------------------------

# (global batch, channels, the heights of the segments' maps): the
# flagship (static_mnist padded to 32x32, batch 64) and celeba64 (batch 128)
MODELS = {"flagship": (64, 64, (32, 16, 8, 4, 2)),
          "celeba64": (128, 64, (64, 32, 16, 8, 4, 2))}
LAYOUTS = [(2, 1), (4, 1), (1, 2), (2, 2), (1, 4)]      # (data, space) ranks


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("n_data,n_space", LAYOUTS, ids=[f"{d}x{s}" for d, s in LAYOUTS])
def test_plan_equal_on_every_rank(model, n_data, n_space):
    """Each rank computes its plan from its own band of each map under its
    own :class:`mesh.Bands` (short and empty bands among them: 2 rows over
    4 ranks are 1, 1, 0 and 0) in fp32 and bf16; every rank of the layout
    gets one plan, that of the longest band, so their ``[2, S, C]`` sums
    all-reduce at one shape."""
    batch, c, heights = MODELS[model]
    for h in heights:
        plans = set()
        for dtype in (torch.float32, torch.bfloat16):
            for s in range(n_space):
                h0, h1 = mesh.band(h, n_space, s)
                x = torch.empty(batch // n_data, c, h1 - h0, h, dtype=dtype, device="meta")
                bands = mesh.Bands(s, n_space, None, (1, 1)) if n_space > 1 else None
                with mesh.banded(bands):
                    plans.add(seg.split_plan_of(x))
        (plan,) = plans
        assert plan == seg.split_plan(batch // n_data, c, -(-h // n_space), h)
        assert 1 <= plan.slices <= seg.SPLIT_MAX_SLICES
        assert 32 <= plan.threads <= seg.SPLIT_MAX_THREADS and plan.threads % 32 == 0


def test_plan_sizes_the_grid_to_the_card():
    """A flagship rank at R = 2 takes one wave of two blocks an SM (4
    slices of 64 channels, 256 blocks),
    celeba64's more slices so that a warp takes at most 4 tiles, and a
    small map a slice of fewer warps."""
    assert seg.split_plan(32, 64, 32, 32) == seg.SplitPlan(4, 256)
    assert seg.split_plan(64, 64, 64, 64) == seg.SplitPlan(16, 256)
    assert seg.split_plan(32, 64, 16, 32) == seg.SplitPlan(4, 256)
    assert seg.split_plan(32, 64, 8, 8) == seg.SplitPlan(1, 128)
    assert seg.split_plan(32, 64, 2, 2) == seg.SplitPlan(1, 32)
    assert seg.split_plan(4, 6, 0, 2) == seg.SplitPlan(1, 32)          # an empty band
    with pytest.raises(ValueError):
        seg.split_plan(0, 64, 4, 4)


# ---------------------------------------------------------------------------
# (b), (c) a mirror of the kernels' walk and byte choice
# ---------------------------------------------------------------------------

ACCESSES = 4            # csrc/segment.cu kSplitAccesses: a stage's 16-byte accesses


def _below4(w: int, tt: int) -> int:
    """csrc/segment.cu ``below4``: bit j, byte j of the word ``w`` below t
    (``tt`` t in every byte), the four compares at once."""
    m = 0xFFFFFFFF
    z = ((w | 0x80808080) - (tt & 0x7F7F7F7F)) & m
    lt = ((~w & tt) | (~(w ^ tt) & ~z)) & 0x80808080 & m
    return ((lt * 0x00204081) & m) >> 28


class Walk:
    """The split kernels' walk of one rank's ``[b, c, hw]`` in a mirror of
    ``csrc/segment.cu``: ``split_vec``, ``access_elems``, ``split_stage``,
    ``FastDiv``, ``unit_at``, ``keep_unit``, ``slice_lo`` and
    ``split_walk``'s loops (two stages, each drained once it was issued:
    both drained in one iteration, ``split_stats``; or one, its registers
    then shifted down, ``one_body``, the other three launches)."""

    def __init__(self, b, c, hw, esize, plan, emap=ElementMap(), operands=1,
                 one_body=False):
        self.b, self.c, self.hw, self.plan, self.emap = b, c, hw, plan, emap
        self.vec = seg.split_unit(hw)
        self.f = 1 if self.vec == 1 else min(self.vec, 16 // esize)      # access_elems
        self.a = self.vec // self.f                                       # accesses a unit
        self.stage = max(1, ACCESSES // (operands * self.a))              # split_stage
        self.units = b * hw // self.vec
        per_row = max(1, hw // self.vec)
        s = 0
        while (1 << s) < per_row:
            s += 1
        self.div = (per_row, ((1 << 32) * ((1 << s) - per_row)) // per_row + 1, s)
        self.gstride = hw if emap.plane == 0 else emap.gplane
        self.words = {}                  # (seed, Philox group) -> its four words
        self.one_body = one_body

    def row(self, u: int) -> int:
        d, m, s = self.div
        assert u < 2 ** 31 and m < 2 ** 32
        return (((u * m) >> 32) + u) >> s                    # FastDiv: umulhi, add, shift

    def unit_at(self, ch: int, u: int):
        """(its first element's flat index, that element's global element)"""
        row = self.row(u)
        assert row == u // self.div[0]
        within = (u - row * self.div[0]) * self.vec
        strip = row * self.c + ch
        return strip * self.hw + within, strip * self.gstride + self.emap.base + within

    def keep_unit(self, seed: int, t: int, g0: int) -> int:
        """The unit's keep bits: one Philox call where its run starts a
        group (V = 16) or a word (V = 4), else element by element."""
        tt = max(t, 0) * 0x01010101

        def words(grp):
            if (seed, grp) not in self.words:
                w = philox4x32(grp & 0xFFFFFFFF, grp >> 32, 0, STREAM_SEGMENT_DROPOUT,
                               *seed_words(seed))
                self.words[seed, grp] = [int(v) for v in w]
            return self.words[seed, grp]

        v = self.vec
        if v > 1 and g0 % v:
            bits = 0
            for j in range(v):
                g = g0 + j
                byte = (words(g >> 4)[(g & 15) >> 2] >> (8 * (g & 3))) & 255
                bits |= int(byte < t) << j
            return bits
        w = words(g0 >> 4)
        if v == 16:
            return sum(_below4(w[i], tt) << (4 * i) for i in range(4))
        return (_below4(w[(g0 >> 2) & 3], tt) >> (g0 & 3)) & ((1 << v) - 1)

    def slice_lo(self, s: int) -> int:
        return self.units * s // self.plan.slices

    def walk(self, seed=None, t=256):
        """Every body call: (slice, thread, unit, first element, F keep bits)."""
        nw = self.plan.threads // 32
        step = nw * self.stage
        for ch in range(self.c):
            for s in range(self.plan.slices):
                lo, hi = self.slice_lo(s), self.slice_lo(s + 1)
                tiles = -(-(hi - lo) // 32)
                for warp in range(nw):
                    held = {0: {}, 1: {}}          # a stage's registers: tile -> loaded

                    def issue(st, t0):
                        held[st] = {t0 + k * nw: True for k in range(self.stage)
                                    if t0 + k * nw < tiles}

                    def drain(st, t0):
                        for k in range(self.stage):
                            tile = t0 + k * nw
                            if tile >= tiles:
                                break
                            assert held[st].pop(tile), "drained a tile its stage did not load"
                            tu = lo + tile * 32
                            own = [self.keep_unit(seed, t, self.unit_at(ch, tu + ln)[1])
                                   if seed is not None and tu + ln < hi else 0xFFFF
                                   for ln in range(32)]
                            for lane in range(32):
                                for q in range(self.a):
                                    i = lane + 32 * q
                                    u = tu + i // self.a
                                    if u < hi:
                                        e0 = self.unit_at(ch, u)[0] + (i % self.a) * self.f
                                        bits = own[i // self.a] >> ((i % self.a) * self.f)
                                        yield s, warp * 32 + lane, u, e0, bits

                    issue(0, warp)
                    t0 = warp
                    while t0 < tiles:
                        issue(1, t0 + step)
                        yield from drain(0, t0)
                        if self.one_body:               # shift(): stage 1 to stage 0
                            held[0], held[1] = held[1], {}
                            t0 += step
                            continue
                        issue(0, t0 + 2 * step)
                        yield from drain(1, t0 + step)
                        t0 += 2 * step
                    assert not held[0] and not held[1], "a loaded stage was never drained"


# (b, c, h, w, the rank's element map): a per-rank count that is not a
# multiple of 16 (units of 1 and of 4), hw of 4 and 2, a 1-row band, an
# empty band, runs that start off a Philox group (bytes element by
# element), a band whose strips do, and a flagship-like map
EDGES = [(3, 5, 7, 7, ElementMap(base=735)), (3, 5, 2, 2, ElementMap(base=60)),
         (4, 6, 2, 2, ElementMap()), (4, 6, 1, 2, ElementMap(2, 4, 98)),
         (4, 6, 0, 2, ElementMap(0, 4, 100)), (2, 8, 4, 4, ElementMap(base=5)),
         (2, 8, 1, 16, ElementMap(16, 48, 7)), (4, 3, 16, 16, ElementMap(256, 512, 3 * 512))]
EDGE_IDS = ["7x7-run", "2x2-run60", "2x2", "1-row-band", "empty-band", "off-group-run",
            "off-group-band", "band-of-16x16"]


@pytest.mark.parametrize("esize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,c,h,w,emap", EDGES, ids=EDGE_IDS)
def test_walk_takes_every_element_once(b, c, h, w, emap, esize):
    """Under the rank's own plan, and under plans of more slices and of
    fewer threads, in each launch's walk (split_stats: one input, two
    bodies a loop; split_apply: one input, one body; the backward: two
    inputs, one body), every element of every channel falls to exactly
    one (slice, thread, unit) access of F elements, each unit to one
    slice, every loaded stage is drained and none before it was loaded."""
    base = seg.split_plan(b, c, h, w)
    for plan in {base, base._replace(slices=base.slices + 2), base._replace(threads=32)}:
        for operands, one_body in ((1, False), (1, True), (2, True)):
            walk = Walk(b, c, h * w, esize, plan, emap, operands, one_body)
            seen = np.zeros(b * c * h * w, np.int64)
            slice_of = {}
            for s, _, u, e0, _ in walk.walk():
                seen[e0:e0 + walk.f] += 1
                slice_of.setdefault((e0 // (h * w) % c, u), set()).add(s)
            assert (seen == 1).all()
            assert all(len(v) == 1 for v in slice_of.values())


@pytest.mark.parametrize("b,c,h,w,emap", EDGES, ids=EDGE_IDS)
def test_walk_draws_the_global_elements_bytes(b, c, h, w, emap):
    """Each element's keep bit, as the walk draws it (its unit's Philox
    bytes compared four at a time, or element by element off a group) and
    hands it on (the shuffle from the unit's lane, shifted by the access's
    place in the unit), is ``dropout_bytes(...) < t`` of the same element
    map, at t = 205 (rate 0.2) and 1."""
    seed = 0x5DEECE66D
    plan = seg.split_plan(b, c, h, w)
    mask = dropout_bytes((b, c, h, w), seed, emap=emap).flatten().numpy()
    for t in (bits8_keep_threshold(0.2), 1):
        walk = Walk(b, c, h * w, 4, plan, emap)
        keep = np.full(b * c * h * w, -1, np.int64)
        for _, _, _, e0, bits in walk.walk(seed, t):
            for j in range(walk.f):
                keep[e0 + j] = (bits >> j) & 1
        np.testing.assert_array_equal(keep, (mask < t).astype(np.int64))


def test_fast_division_is_exact():
    """``FastDiv`` (one multiply-high, an add and a shift) against ``//``
    over every divisor a strip gives (units of a strip 1 .. 2^12 and powers
    of two to 2^30) and dividends up to 2^31 - 1."""
    rng = np.random.default_rng(3)
    divisors = list(range(1, 4097)) + [1 << k for k in range(13, 31)] + [3 * 1024 * 1024 + 1]
    xs = np.concatenate([np.arange(0, 5000), rng.integers(0, 2 ** 31, 2000),
                         [2 ** 31 - 1]]).astype(np.uint64)
    for d in divisors:
        s = 0
        while (1 << s) < d:
            s += 1
        m = ((1 << 32) * ((1 << s) - d)) // d + 1
        assert m < 2 ** 32
        got = (((xs * np.uint64(m)) >> np.uint64(32)) + xs) >> np.uint64(s)
        np.testing.assert_array_equal(got, xs // np.uint64(d))


# ---------------------------------------------------------------------------
# (d) the plain versions over ranks' parts against lvae_tpu
# ---------------------------------------------------------------------------

SHAPE = (4, 8, 8, 8)                        # NHWC, as tests/test_torch_segment.py
SPLITS = [(2, 1), (4, 1), (2, 2)]           # (data, space): rows, and bands of rows


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _jax_bits(key, shape):
    """The interpret-mode kernel's mask bytes, unfolded to NCHW."""
    b, h, w, c = shape
    f = 128 // c
    bits = jax.random.bits(key, (b * h * w // f, f * c), jnp.uint8)
    return _nchw(np.asarray(bits).reshape(shape))


def _parts(n_data, n_space):
    """Each rank's (rows, band of rows) of the NCHW batch."""
    b, h = SHAPE[0], SHAPE[1]
    return [(slice(d * b // n_data, (d + 1) * b // n_data), slice(*mesh.band(h, n_space, s)))
            for d in range(n_data) for s in range(n_space)]


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["rate0", "rate0.2"])
@pytest.mark.parametrize("n_data,n_space", SPLITS, ids=[f"{d}x{s}" for d, s in SPLITS])
def test_plain_split_matches_lvae_tpu(n_data, n_space, rate):
    """Forward: the ranks' ``[2, 1, C]`` sums added by hand, each rank's
    ``y`` from them, concatenated, and the statistics, against
    ``fused_dropout_bn_act`` on the whole batch. Backward: the ranks'
    ``sum(dz)``, ``sum(dz xhat)`` added by hand, each rank's ``dx``
    concatenated, and dgamma, dbeta the sum of the ranks' own, against the
    VJP of the whole batch's segment. The plain side in float64."""
    rng = np.random.default_rng(19)
    x = (rng.normal(size=SHAPE) * 1.5 + 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=SHAPE[-1]).astype(np.float32)
    beta = (rng.normal(size=SHAPE[-1]) * 0.2).astype(np.float32)
    g = rng.normal(size=SHAPE).astype(np.float32)
    key = jax.random.key(23)
    t = bits8_keep_threshold(rate)

    def run(x_, gm, bt):
        return j_segment(x_, gm, bt, key if rate else None, rate=rate, act="elu")

    (yj, mj, vj), vjp = jax.vjp(run, jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    dj = vjp((jnp.asarray(g), jnp.zeros_like(mj), jnp.zeros_like(vj)))

    xt, gt = _nchw(x).double(), _nchw(g).double()
    gam, bet = torch.from_numpy(gamma).double(), torch.from_numpy(beta).double()
    bits = _jax_bits(key, SHAPE) if rate else None
    parts = _parts(n_data, n_space)
    n_global = SHAPE[0] * SHAPE[1] * SHAPE[2]
    cut = lambda v, r, s: None if v is None else v[r, :, s].contiguous()     # noqa: E731
    glob = sum(segment_split_stats(cut(xt, r, s), t, cut(bits, r, s)) for r, s in parts)
    y = torch.empty_like(xt)
    stats = None
    for r, s in parts:
        y[r, :, s], stats = segment_split_apply(cut(xt, r, s), gam, bet, glob, n_global, t,
                                                "elu", 1e-5, cut(bits, r, s))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(stats[0].numpy(), np.asarray(mj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(stats[1].numpy(), np.asarray(vj), rtol=1e-5, atol=1e-5)

    local = [segment_split_bwd_reduce(cut(xt, r, s), cut(gt, r, s), stats, t, "elu",
                                      cut(bits, r, s)) for r, s in parts]
    glob_bwd = sum(local)
    dx = torch.empty_like(xt)
    dgamma, dbeta = torch.zeros_like(gam), torch.zeros_like(bet)
    for (r, s), lp in zip(parts, local):
        dx[r, :, s], dgm, dbt = segment_split_bwd_apply(cut(xt, r, s), cut(gt, r, s), gam,
                                                        stats, lp, glob_bwd, n_global, t,
                                                        "elu", cut(bits, r, s))
        dgamma, dbeta = dgamma + dgm, dbeta + dbt
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(), np.asarray(dj[0]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(dgamma.numpy(), np.asarray(dj[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dbeta.numpy(), np.asarray(dj[2]), rtol=1e-4, atol=1e-4)
    if rate:
        assert (dx[bits >= t] == 0).all()
