"""K3-bwd's one pass (``csrc/mixture.cu`` ``mix_bwd_one_pass_kernel``) on
the CPU: a mirror of its walk over pixel groups, batch rows and components
(every pixel and component once, at every V, for the shapes of the models,
odd maps, a band of rows, a pointer off alignment and a batch past the
grid's y limit), its bin and tanh formulations in float32 against
``lvae_tpu``'s ``_bin_logprob_and_grads`` in float64, ``bwd_plan`` at the
K of every head, and the A/B tool's arguments. The kernel itself runs on
the card (``chip_smoke.py`` phases 10 and 18a, ``python -m
lvae_tpu_torch.mixture_ab --kernels bwd``)."""

import argparse

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lvae_tpu.kernels.mixture_pallas import _bin_logprob_and_grads
from lvae_tpu_torch import mixture_ab
from lvae_tpu_torch.kernels import mixture as km

MAX_GRID_Y = 65_535                  # csrc/mixture.cu kMaxGridY


def _entry_v(hw, v, offsets, esizes):
    """The C entry's V: the plan's, or 1 where ``hw`` or a pointer (its
    offset in elements, of ``esizes`` bytes each) is off V alignment."""
    if hw % v or any((o * e) % (v * e) for o, e in zip(offsets, esizes)):
        return 1
    return v


def _walk(b, hw, k, v):
    """The one pass's launch at V pixels a group: per (image, pixel,
    component) how many lanes build it, and per (image, pixel) how many
    write its dx; with the lanes of each pair, which must share a group.
    Grid (ceil(hw / (kGroups V)), min(B, 65,535)); lane l of warp w in
    CTA x takes pixels (64 x + 16 w + (l & 15)) V .. + V - 1 and the
    components j = l >> 4, + 2, ...; CTA row y takes images y, y + grid
    y, ...; lanes with l < 16 write dx."""
    groups = km.THREADS // km.SPLIT
    gx, gy = -(-hw // (groups * v)), min(b, MAX_GRID_Y)
    tid = np.arange(km.THREADS)
    lane, half = tid & 31, (tid & 31) >> 4
    group = (tid >> 5) * 16 + (lane & 15)
    partner = (tid & ~31) | (lane ^ 16)
    assert (group[partner] == group).all() and (half[partner] != half).all()
    built = np.zeros((hw, k), np.int64)
    dx = np.zeros(hw, np.int64)
    for x in range(gx):
        p0 = (x * groups + group) * v
        for t in np.nonzero(p0 < hw)[0]:
            assert p0[t] + v <= hw                    # a group never runs off its row
            built[p0[t]:p0[t] + v, half[t]::2] += 1
            dx[p0[t]:p0[t] + v] += half[t] == 0
    rows = np.zeros(b, np.int64)                      # the images a CTA row visits
    for y in range(gy):
        rows[y::gy] += 1
    return rows[:, None, None] * built, rows[:, None] * dx


class TestWalk:
    @pytest.mark.parametrize("b,hw,k,v,offsets", [
        (4, 64 * 64, 10, 2, (0, 0)),        # celeba64's map
        (4, 32 * 32, 10, 2, (0, 0)),        # cifar10-deep's
        (3, 32 * 32, 1, 2, (0, 0)),         # K = 1: the odd lanes build nothing
        (2, 64 * 64, 24, 1, (0, 0)),        # K = 24 at V = 1
        (2, 7 * 7, 10, 2, (0, 0)),          # 49 pixels: V = 2 runs V = 1
        (2, 32 * 64, 10, 2, (0, 0)),        # a celeba64 band of 32 rows (1 x 2)
        (2, 3 * 64, 10, 2, (0, 0)),         # a band of 3 rows
        (2, 64 * 64, 9, 2, (0, 1)),         # params one element off alignment: V = 1
        (MAX_GRID_Y + 3, 6, 3, 2, (0, 0)),  # B past the grid's y limit
    ])
    def test_every_pixel_and_component_once(self, b, hw, k, v, offsets):
        run_v = _entry_v(hw, v, offsets, (4, 2))
        assert run_v == (1 if hw % v or any(offsets) else v)
        built, dx = _walk(b, hw, k, run_v)
        assert (built == 1).all()
        assert (dx == 1).all()

    def test_plan_v_is_a_walkable_v(self):
        for b, hw in [(128, 64 * 64), (128, 32 * 32), (16, 32 * 32), (8, 7 * 7), (32, 2048)]:
            plan = km.bwd_plan(10, 3, b, hw)
            assert plan.v in km.BWD_VECTORS and hw % plan.v == 0


# ---------------------------------------------------------------------------
# the bin and tanh formulations, float32, against float64
# ---------------------------------------------------------------------------

F = np.float32
LOG_FLOOR = F(-7.0)


def _expm1_ratio(d):
    """csrc/mixture.cu expm1_ratio: (1 - e^-d) / d by its series."""
    h = d * F(-1.0 / 720.0) + F(1.0 / 120.0)
    h = d * h + F(-1.0 / 24.0)
    h = d * h + F(1.0 / 6.0)
    h = d * h + F(-0.5)
    return d * h + F(1.0)


def _bin_grads_f32(xs, m, raw, hb):
    """``bin_grads`` of one channel in float32, with the exponentials and
    the reciprocal exact where the kernel takes the hardware's: (lp, dm,
    dls)."""
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        hb = F(hb)
        lo = np.maximum(raw, LOG_FLOOR)
        inv_s = np.exp(-lo)
        a = inv_s * ((xs - m) - hb)
        d = F(2.0) * hb * inv_s
        is_left = xs < F(-1.0) + hb
        left = np.where(is_left, F(-np.inf), F(0.0))
        right = np.where(~is_left & (xs > F(1.0) - hb), F(np.inf), F(0.0))
        A, B, D = a + left, (a + d) + right, d + (right - left)
        series = D < F(0.25)
        h = _expm1_ratio(D)
        q = np.where(series, D * h, F(1.0) - np.exp(-D))
        lin = np.minimum(np.minimum(B, -A), F(0.0)) + np.where(
            series, F(np.log(2.0 * float(hb))) - lo, F(0.0))
        num = np.where(series, h, q)
        ea, eb = np.exp(-np.abs(A)), np.exp(-np.abs(B))
        pa, pb = F(1.0) + ea, F(1.0) + eb
        pab = pa * pb
        r = F(1.0) / (pab * q)
        ra, rb = (pb * q) * r, (pa * q) * r
        sig_b = np.where(B >= 0, rb, eb * rb)
        da = np.where(A >= 0, ea * ra, ra) - sig_b
        dd = pab * r - sig_b
        dm = -inv_s * da
        dls = np.where(raw > LOG_FLOOR, -(a * da + d * dd), F(0.0))
        lp = lin + (np.log(num) - np.log(pab))
    return lp.astype(F), dm.astype(F), dls.astype(F)


def _tanh3_f32(v):
    """``tanh3`` in float32: the three 1 - 2 / (1 + e^(2|v|)) from one
    reciprocal, |v| clamped at 10."""
    av = np.minimum(np.abs(v), F(10.0))
    e = F(1.0) + np.exp(F(2.0) * av)
    r = F(1.0) / (e[0] * e[1] * e[2])
    ri = np.stack([(e[1] * e[2]) * r, (e[0] * e[2]) * r, (e[0] * e[1]) * r])
    return np.copysign(F(1.0) - F(2.0) * ri, v).astype(F)


def _reference(xs, m, raw, hb):
    with jax.enable_x64():
        lp, dm, dls = _bin_logprob_and_grads(
            jnp.asarray(xs, jnp.float64), jnp.asarray(m, jnp.float64),
            jnp.maximum(jnp.asarray(raw, jnp.float64), -7.0), hb, True)
        dls = jnp.where(jnp.asarray(raw, jnp.float64) > -7.0, dls, 0.0)
        return np.asarray(lp), np.asarray(dm), np.asarray(dls)


class TestBinFormulation:
    HB = 1.0 / 255.0

    def _cases(self):
        """(xs, m, raw): edge bins, interior bins, d just under and over the
        series' 0.25, log-scales at and under the floor, and a spread."""
        hb = self.HB
        rng = np.random.default_rng(21)
        ls_at = lambda d: np.log(2.0 * hb / d)                        # noqa: E731
        xs = [-1.0, 1.0, -1.0 + 2 * hb, 1.0 - 2 * hb, 0.0, 0.5, -0.3]
        ms = [-1.2, -0.9, -0.02, 0.0, 0.01, 0.3, 1.1]
        raws = [-9.0, -7.0, -6.9, -4.0, -2.0, 0.0, 1.5, ls_at(0.2499), ls_at(0.2501),
                ls_at(0.01), ls_at(3.0)]
        grid = np.array([(x, m, r) for x in xs for m in ms for r in raws])
        spread = np.stack([rng.integers(0, 256, 4000) / 255.0 * 2.0 - 1.0,
                           rng.normal(0.0, 0.7, 4000), rng.uniform(-9.0, 2.0, 4000)], 1)
        cases = np.concatenate([grid, spread]).astype(F)
        return cases[:, 0], cases[:, 1], cases[:, 2]

    def test_bin_terms_against_float64(self):
        """lp, dm and dls of every case within float32's reach of the
        float64 reference: lp 2e-6 (relative, at least 1), dm and dls
        2e-6 of their scale (the gradient's factor inv_s and |a| + d);
        the floor's dls exactly 0, both edge bins taken."""
        xs, m, raw = self._cases()
        lp, dm, dls = _bin_grads_f32(xs, m, raw, self.HB)
        lp_r, dm_r, dls_r = _reference(xs, m, raw, self.HB)
        assert np.isfinite(lp).all() and np.isfinite(dm).all() and np.isfinite(dls).all()
        inv_s = np.exp(-np.maximum(raw.astype(np.float64), -7.0))
        a = inv_s * ((xs - m) - self.HB)
        np.testing.assert_array_less(np.abs(lp - lp_r), 2e-6 * np.maximum(1.0, np.abs(lp_r)))
        np.testing.assert_array_less(np.abs(dm - dm_r), 2e-6 * np.maximum(1.0, inv_s))
        np.testing.assert_array_less(np.abs(dls - dls_r),
                                     2e-6 * np.maximum(1.0, np.abs(a) + 2 * self.HB * inv_s))
        assert (dls[raw <= -7.0] == 0).all() and (np.abs(dls[raw > -7.0]) > 0).any()
        assert (xs == -1.0).any() and (xs == 1.0).any()

    @pytest.mark.parametrize("d", [0.2499, 0.2501])
    def test_series_bound_is_seamless(self, d):
        """Either side of the series' bound the kernel's q and 1 / q agree
        with float64 to 1e-6 relative (q keeps its relative accuracy)."""
        ls = np.float64(np.log(2.0 * self.HB / d))
        D = F(2.0 * self.HB) * np.exp(-F(ls))
        q = np.where(D < 0.25, D * _expm1_ratio(D), F(1.0) - np.exp(-D))
        want = -np.expm1(-np.float64(D))
        assert abs(q / want - 1.0) < 1e-6

    def test_tanh3_against_float64(self):
        """tanh of three coefficients from one reciprocal: within 3e-7 of
        np.tanh, exactly 1 in magnitude past 10, the sign kept."""
        rng = np.random.default_rng(3)
        v = np.concatenate([rng.normal(0, 2, (3, 3000)),
                            np.array([[0.0, 1e-6, -12.0], [10.0, -40.0, 0.125],
                                      [-0.25, 9.5, 3.0]])], 1).astype(F)
        got = _tanh3_f32(v)
        np.testing.assert_array_less(np.abs(got - np.tanh(v.astype(np.float64))), 3e-7)
        assert (np.abs(got[np.abs(v) > 10]) == 1.0).all()
        assert (np.sign(got) == np.sign(v)).all()


class TestPlanAtEveryHead:
    @pytest.mark.parametrize("k", [1, 10, 20, 24, 56])
    @pytest.mark.parametrize("c", [1, 3])
    @pytest.mark.parametrize("b,hw", [(128, 64 * 64), (128, 32 * 32), (16, 32 * 32), (8, 49)])
    def test_v_and_shared_memory_are_legal(self, k, c, b, hw):
        """The default plan's V divides the map, and its CTA's stash is
        what the kernel allocates and fits the budget (two CTAs an SM);
        every forced V that fits is a legal launch."""
        plan = km.bwd_plan(k, c, b, hw)
        if plan.name == "two_pass":
            assert plan == km.Plan("two_pass", 0, 1)
            assert km.one_pass_smem(k, c, 1) > km.ONE_PASS_BUDGET
            return
        assert hw % plan.v == 0 and plan.v in km.BWD_VECTORS
        assert plan.smem == km.one_pass_smem(k, c, plan.v) <= km.ONE_PASS_BUDGET
        assert plan.smem == 4 * km.THREADS * -(-k // 2) * km.stored_per_component(c) * plan.v
        for v in km.BWD_VECTORS:
            if km.one_pass_smem(k, c, v) <= km.SMEM_MAX:
                assert km.bwd_plan(k, c, b, hw, "one_pass", v).v == v


class TestMixtureAbArguments:
    def test_bwd_mode_and_shapes(self):
        args = mixture_ab.parse_args(["--other", "build/parent", "--kernels", "bwd",
                                      "--shapes", "128x3x64x64x10", "16x1x32x32x10"])
        assert args.kernels == "bwd" and args.shapes == [(128, 3, 64, 64, 10),
                                                         (16, 1, 32, 32, 10)]
        assert mixture_ab.parse_args(["--other", "x"]).kernels == "fwd"
        for bad in ("128x2x64x64x10", "128x3x64x64", "axbxcxdxe", "0x3x4x4x10"):
            with pytest.raises(argparse.ArgumentTypeError):
                mixture_ab.shape_arg(bad)

    def test_bwd_shape_list(self):
        """celeba64's training batch and cifar10-deep's at C = 3, phase 10's
        C = 1 shape and a K that the budget once sent to two passes."""
        assert mixture_ab.BWD_SHAPES == [(128, 3, 64, 64, 10), (128, 3, 32, 32, 10),
                                         (16, 1, 32, 32, 10), (32, 3, 64, 64, 24)]

    def test_variants_and_bound(self):
        default = km.bwd_plan(10, 3, 128, 64 * 64)
        variants = mixture_ab.bwd_variants(10, 3, 128, 64 * 64, default)
        assert set(variants) == {"one_pass V=1", "two_pass"}
        assert default not in variants.values()
        ms, by = mixture_ab.bwd_bound((128, 3, 64, 64, 10), 2, False)
        assert by == "bytes" and ms == pytest.approx(128 * 4096 * 416 / 3.35e12 * 1e3)
