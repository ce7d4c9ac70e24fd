"""The launch plan of the IW-LL logsumexp kernel (K4),
``kernels/logsumexp.py`` ``lse_plan``, at both models' IW shapes and at
odd shapes; and an emulation in PyTorch of the kernel's split of k over a
CTA's warps and its fixed combine order, held against the plain version.
The CUDA kernel that takes these plans is checked on the card by
``chip_smoke.py`` (phase 3)."""

import numpy as np
import pytest
import torch

from lvae_tpu_torch.kernels import logsumexp as lse

# [k, B]: the flagship's and celeba64's IW batches, one element, one row,
# tiny and ragged batches, k past one register load per thread (257, 1000),
# a batch of whole CTAs; and batches whose grid is large enough for fewer
# warps a CTA
SHAPES = [(100, 1000), (100, 500), (1, 1), (1, 777), (2, 3), (7, 333), (100, 777),
          (257, 1000), (1000, 64), (100, 1024)]
WIDE = [(3, 65_536), (1000, 65_536), (100, 100_000)]


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


def _reads(plan):
    """(per row, per column): how many of the plan's (warp, chunk) loads
    take each row, and how many of its (CTA, lane) each column. A thread
    is a (CTA, lane, warp): it loads its warp's rows of its lane's
    column, so every element is read once where both are all 1."""
    rows = np.zeros(plan.k, np.int64)
    for warp in range(plan.warps):
        for chunk in range(plan.chunks):
            r = plan.rows_of(warp, chunk)
            assert len(r) <= plan.rows
            rows[r.start:r.stop] += 1
    cols = np.bincount(np.arange(plan.grid * 32), minlength=plan.b)[:plan.b]
    assert plan.grid * 32 - 32 < plan.b             # no CTA without a column
    return rows, cols


class TestLsePlan:
    @pytest.mark.parametrize("shape", SHAPES + WIDE, ids=_ids(SHAPES + WIDE))
    def test_reads_each_element_once(self, shape):
        k, b = shape
        plan = lse.lse_plan(k, b)
        assert (plan.k, plan.b) == (k, b)
        rows, cols = _reads(plan)
        assert (rows == 1).all() and (cols == 1).all()
        assert 32 * plan.warps <= 1024 and plan.warps <= lse.LSE_MAX_WARPS
        assert 1 <= plan.rows <= lse.LSE_MAX_ROWS
        # one register load per thread wherever the warps' rows hold k;
        # no warp without a row
        assert (plan.chunks == 1) == (k <= plan.warps * plan.rows)
        assert (plan.warps - 1) * plan.rows * plan.chunks < k

    def test_iw_shapes(self):
        """Both models' IW batches: one burst of loads a thread, scalar
        columns, a CTA per 32 columns."""
        for b in (1000, 500):
            plan = lse.lse_plan(100, b)
            assert plan.chunks == 1 and plan.warps == 8 and plan.grid == -(-b // 32)
            assert plan.warps * plan.rows >= 100
        assert lse.lse_plan(100, 1000) == lse.lse_plan(100, 1000)

    def test_large_launches(self):
        """Fewer warps a CTA where the grid is large: at most
        LSE_LAUNCH_WARPS warps a launch, down to LSE_MIN_WARPS a CTA."""
        assert lse.lse_plan(1000, 1000)[2:] == (32, 16, 2)               # 32 CTAs
        assert lse.lse_plan(1000, 10_000)[2:] == (8, 16, 8)              # 313 CTAs
        assert lse.lse_plan(100, 10_000)[2:] == (8, 13, 1)
        assert lse.lse_plan(100, 100_000)[2:] == (4, 13, 2)              # 3,125 CTAs
        assert lse.lse_plan(2, 100_000)[2:] == (2, 1, 1)

    @pytest.mark.parametrize("k", [1, 2, 7, 16, 100, 257, 512, 513, 1000, 5000])
    @pytest.mark.parametrize("warps", [1, 4, 8, 13, 16, 32])
    def test_split_rows(self, k, warps):
        """Every row in one warp's block, no warp empty, at most ``warps``
        warps and ``LSE_MAX_ROWS`` rows a load."""
        w, rows, chunks = lse.split_rows(k, warps)
        assert 1 <= w <= min(warps, k) and 1 <= rows <= lse.LSE_MAX_ROWS
        assert (w - 1) * rows * chunks < k <= w * rows * chunks
        assert (chunks == 1) == (k <= min(warps, k) * lse.LSE_MAX_ROWS)

    @pytest.mark.parametrize("bad", [(0, 5), (5, 0), (2 ** 31, 5)])
    def test_rejects(self, bad):
        with pytest.raises(ValueError):
            lse.lse_plan(*bad)


def _emulate(x, plan):
    """``csrc/logsumexp.cu`` on ``x`` under ``plan``, in float32 and the
    kernel's order (every column at once): per warp, the earlier chunks
    folded into a running (max, sum of exp) in row order and the last
    chunk kept; the column's max over the warps in warp order (NaN marks
    a warp that saw one); each warp's sum of exp(v - M) in row order; the
    warps' sums added in warp order."""
    ninf = torch.full((plan.b,), float("-inf"))
    warps = []
    for w in range(plan.warps):
        m, s, nan = ninf.clone(), torch.zeros(plan.b), torch.zeros(plan.b, dtype=torch.bool)
        for c in range(plan.chunks):
            v = x[plan.rows_of(w, c).start:plan.rows_of(w, c).stop]
            if c + 1 == plan.chunks:
                break
            cm = m
            for row in v:
                nan |= torch.isnan(row)
                cm = torch.fmax(cm, row)
            safe = torch.where(torch.isfinite(cm), cm, torch.zeros_like(cm))
            acc = s * torch.exp(m - safe)
            for row in v:
                acc = acc + torch.exp(row - safe)
            m, s = cm, acc
        tm = m
        for row in v:
            nan |= torch.isnan(row)
            tm = torch.fmax(tm, row)
        warps.append((torch.where(nan, torch.full_like(tm, float("nan")), tm), m, s, v))
    mm, bad = ninf.clone(), torch.zeros(plan.b, dtype=torch.bool)
    for t, *_ in warps:
        bad |= torch.isnan(t)
        mm = torch.fmax(mm, t)
    bad |= ~torch.isfinite(mm)
    safe = torch.where(bad, torch.zeros_like(mm), mm)
    total = torch.zeros(plan.b)
    for _, m, s, v in warps:
        acc = s * torch.exp(m - safe)
        for row in v:
            acc = acc + torch.exp(row - safe)
        total = total + acc
    return torch.where(bad, ninf, safe + torch.log(total))


def _edge_columns(rng, k, b):
    x = (rng.standard_normal((k, b)) * 30 - 200).astype(np.float32)
    if b >= 8:
        x[:, 0] = -np.inf                      # all -inf -> -inf, not NaN
        x[:, 1] = -np.inf                      # all but one -inf -> that one
        x[k // 2, 1] = 3.5
        x[:, 2] = 1e30
        x[:, 3] = -1e30
        x[::2, 4] = 1e30
        x[k - 1, 5] = np.nan                   # a NaN -> -inf
        x[0, 6] = np.inf                       # a +inf -> -inf
        x[:, 7] *= 100
    return torch.from_numpy(x)


PLANS = SHAPES + [(100, 40), (3, 40)]


class TestEmulation:
    @pytest.mark.parametrize("warps", [None, 4, 13, 32], ids=["plan", "w4", "w13", "w32"])
    @pytest.mark.parametrize("shape", PLANS, ids=_ids(PLANS))
    def test_matches_the_plain_version(self, shape, warps):
        k, b = shape
        plan = lse.lse_plan(k, b)
        if warps is not None:
            plan = plan._replace(**dict(zip(("warps", "rows", "chunks"),
                                            lse.split_rows(k, warps))))
        x = _edge_columns(np.random.default_rng(k * 7919 + b), k, b)
        got, ref = _emulate(x, plan), lse._plain_logsumexp(x)
        fin = torch.isfinite(ref)
        assert torch.equal(fin, torch.isfinite(got))
        assert torch.equal(got[~fin], ref[~fin])              # all -inf
        rel = ((got[fin] - ref[fin]).abs() / ref[fin].abs().clamp_min(1.0)).max()
        assert rel <= 1e-6
        if b >= 8:
            assert got[0] == -np.inf and got[1] == 3.5
            assert got[2] == x[0, 2] and got[3] == x[0, 3]
            assert got[5] == -np.inf and got[6] == -np.inf
