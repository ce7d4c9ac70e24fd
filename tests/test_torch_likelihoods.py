"""The port's likelihoods on the CPU, held against ``lvae_tpu``: the plain
discretized-logistic-mixture log-prob (the plain version of K3) against
the XLA oracle and the Pallas kernel in interpret mode, its hand-written
backward (the plain version of K3-bwd) against ``jax.vjp`` of the oracle
and the Pallas backward, the ``autograd.Function`` against finite
differences, every head against its flax twin, and image sampling given
JAX's own noise. Inputs come from numpy seeds; the CUDA kernels are held
to these plain versions on the card by ``chip_smoke.py``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lvae_tpu.kernels.mixture_pallas import _run_bwd, fused_mix_log_prob
from lvae_tpu.models import likelihoods as jheads
from lvae_tpu.ops import likelihoods as jlik
from lvae_tpu.ops import stochastic as jsto
from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.kernels import mixture as km
from lvae_tpu_torch.models import likelihoods as theads
from lvae_tpu_torch.ops import likelihoods as tlik
from lvae_tpu_torch.ops import stochastic as tsto
from lvae_tpu_torch.train.convert import params_from_flax

FWD_TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_pallas.py:458-460
BWD_TOL = dict(rtol=2e-4, atol=2e-5)    # tests/test_pallas.py:487-489


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _pixels(rng, b, h, w, c, kind):
    """Images on the 256-level grid with exact 0 and 1 edge pixels
    ('grid'), or the bin centres the dequantizing eval preprocessing
    gives ('centre')."""
    u = rng.integers(0, 256, size=(b, h, w, c))
    u[:, 0, 0] = 0
    u[:, 1, 1] = 255
    u[:, 2, 2, 0] = 255
    x = u / 255.0 if kind == "grid" else (u + 0.5) / 256.0
    return x.astype(np.float32)


def _mix_data(rng, b=8, h=8, w=8, c=3, k=10, kind="grid"):
    x = _pixels(rng, b, h, w, c, kind)
    p = rng.normal(size=(b, h, w, k * (1 + 3 * c))).astype(np.float32)
    return x, p


class TestMixtureForward:
    @pytest.mark.parametrize("kind", ["grid", "centre"])
    @pytest.mark.parametrize("k", [10, 4])
    @pytest.mark.parametrize("c", [3, 1])
    def test_plain_matches_oracle_and_pallas(self, rng, c, k, kind):
        """NHWC (lvae_tpu's signature) and the model's NCHW (``dim=1``)
        against the oracle and ``fused_mix_log_prob``, which runs the
        Pallas kernel in interpret mode for C = 3 (its oracle for C = 1)."""
        x, p = _mix_data(rng, c=c, k=k, kind=kind)
        want = np.asarray(jlik.discretized_logistic_mix_log_prob(jnp.asarray(x),
                                                                 jnp.asarray(p), k))
        pallas = np.asarray(fused_mix_log_prob(jnp.asarray(x), jnp.asarray(p), n_components=k))
        got = tlik.discretized_logistic_mix_log_prob(torch.from_numpy(x), torch.from_numpy(p), k)
        got_nchw = tlik.discretized_logistic_mix_log_prob(_nchw(x), _nchw(p), k, dim=1)
        wrapper = km.mix_log_prob(_nchw(x), _nchw(p), k)    # the CPU: its plain version
        assert got.shape == got_nchw.shape == (8, 8, 8)
        for out in (got, got_nchw, wrapper):
            np.testing.assert_allclose(out.numpy(), want, **FWD_TOL)
            np.testing.assert_allclose(out.numpy(), pallas, **FWD_TOL)
        # the edge bins are taken: exact 0s and 1s are far from interior
        assert np.isfinite(want).all() and want.min() < -5.0

    @pytest.mark.parametrize("c", [3, 1])
    def test_elementwise_logistic_and_gaussian(self, rng, c):
        x = _pixels(rng, 3, 5, 5, c, "grid")
        mean = rng.uniform(size=x.shape).astype(np.float32)
        ls = rng.normal(size=x.shape).astype(np.float32) - 3.0
        args = [x, mean, ls]
        want = np.asarray(jlik.discretized_logistic_log_prob(*map(jnp.asarray, args)))
        got = tlik.discretized_logistic_log_prob(*map(torch.from_numpy, args))
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
        want = np.asarray(jlik.gaussian_likelihood_log_prob(*map(jnp.asarray, args)))
        got = tlik.gaussian_likelihood_log_prob(*map(torch.from_numpy, args))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    def test_log_cdf_diff_deep_in_the_tail(self):
        """log(sigmoid(a + d) - sigmoid(a)) stays finite where the naive
        difference of CDFs cancels to 0 (rtol 1e-5 against lvae_tpu)."""
        a = np.array([-200.0, -30.0, 0.0, 30.0, 90.0], np.float32)
        d = np.array([1e-3, 0.05, 1.0, 2.0, 1e-2], np.float32)
        want = np.asarray(jlik._log_cdf_diff(jnp.asarray(a), jnp.asarray(d)))
        got = tlik._log_cdf_diff(torch.from_numpy(a), torch.from_numpy(d)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class TestMixtureBackward:
    @pytest.mark.parametrize("k", [10, 4])
    @pytest.mark.parametrize("c", [3, 1])
    def test_plain_matches_jax(self, rng, c, k):
        """dparams and dx of the hand-written backward against jax.vjp of
        the oracle and (C = 3) the Pallas backward in interpret mode."""
        x, p = _mix_data(rng, c=c, k=k)
        g = rng.standard_normal(x.shape[:3]).astype(np.float32)
        _, vjp = jax.vjp(lambda xx, pp: jlik.discretized_logistic_mix_log_prob(xx, pp, k),
                         jnp.asarray(x), jnp.asarray(p))
        dx_j, dp_j = (np.asarray(t) for t in vjp(jnp.asarray(g)))
        dp, dx = km._plain_mix_log_prob_bwd(_nchw(x), _nchw(p), torch.from_numpy(g), k, 256)
        np.testing.assert_allclose(_nhwc(dp), dp_j, **BWD_TOL)
        np.testing.assert_allclose(_nhwc(dx), dx_j, **BWD_TOL)
        if c == 3:
            dp_pl, dx_pl = (np.asarray(t) for t in _run_bwd(jnp.asarray(x), jnp.asarray(p),
                                                            jnp.asarray(g), k, 256))
            np.testing.assert_allclose(_nhwc(dp), dp_pl, **BWD_TOL)
            np.testing.assert_allclose(_nhwc(dx), dx_pl, **BWD_TOL)
        # through the autograd.Function (CPU: the plain versions)
        xt, pt = _nchw(x).requires_grad_(), _nchw(p).requires_grad_()
        km.mix_log_prob(xt, pt, k).backward(torch.from_numpy(g))
        np.testing.assert_array_equal(pt.grad.numpy(), dp.numpy())
        np.testing.assert_array_equal(xt.grad.numpy(), dx.numpy())

    @pytest.mark.parametrize("c", [3, 1])
    def test_autograd_function_gradcheck(self, c):
        """The autograd.Function (plain forward, hand backward) against
        finite differences in float64, x off the bin-edge selects."""
        g = torch.Generator().manual_seed(c)
        k, b, h, w = 2, 2, 1, 2
        x = (torch.randint(16, 240, (b, c, h, w), generator=g) / 255.0).double()
        p = torch.randn(b, k * (1 + 3 * c), h, w, generator=g, dtype=torch.float64)
        x.requires_grad_()
        p.requires_grad_()
        assert torch.autograd.gradcheck(lambda xx, pp: km.mix_log_prob(xx, pp, k), (x, p))

    def test_floored_log_scale_blocks_its_gradient(self, rng):
        """Where the raw log-scale is below -7 its gradient is exactly 0,
        in the hand backward, through the autograd.Function, and in
        jax.grad of the oracle (the clip)."""
        k, c = 10, 3
        x, p = _mix_data(rng, c=c, k=k)
        lo = k + k * c
        p[..., lo:lo + 7] = -9.0 + rng.uniform(size=p[..., lo:lo + 7].shape)  # [-9, -8)
        g = rng.standard_normal(x.shape[:3]).astype(np.float32)
        dp, _ = km._plain_mix_log_prob_bwd(_nchw(x), _nchw(p), torch.from_numpy(g), k, 256)
        pt = _nchw(p).requires_grad_()
        km.mix_log_prob(_nchw(x), pt, k).backward(torch.from_numpy(g))
        dp_j = np.asarray(jax.grad(lambda pp: jnp.sum(
            jlik.discretized_logistic_mix_log_prob(jnp.asarray(x), pp, k) * g))(jnp.asarray(p)))
        for grad in (dp.numpy(), pt.grad.numpy(), dp_j.transpose(0, 3, 1, 2)):
            assert (grad[:, lo:lo + 7] == 0).all()
            assert np.abs(grad[:, lo + 7:lo + k * c]).max() > 1e-3   # the others flow

    def test_cpu_runs_plain_and_counts_no_launch(self, rng):
        x, p = _mix_data(rng, b=2, h=4, w=4)
        pt = _nchw(p).requires_grad_()
        before = dict(build.LAUNCHES)
        km.mix_log_prob(_nchw(x), pt).sum().backward()
        km.mix_log_prob_backward(_nchw(x), _nchw(p), torch.ones(2, 4, 4))
        assert build.LAUNCHES == before

    @pytest.mark.parametrize("bad", ["c2", "q", "dtype", "strided", "device", "g"])
    def test_rejects_bad_operands(self, rng, bad):
        x, p = (_nchw(a) for a in _mix_data(rng, b=2, h=4, w=4))
        g = torch.zeros(2, 4, 4)
        if bad == "c2":
            x, p = x[:, :2].contiguous(), p[:, :70].contiguous()
        elif bad == "q":
            p = p[:, :99].contiguous()
        elif bad == "dtype":
            x = x.double()
        elif bad == "strided":
            p = p.transpose(2, 3)
        elif bad == "device":
            p = p.to("meta")
        else:
            g = g[:1]
        with pytest.raises((ValueError, TypeError)):
            if bad == "g":
                km.mix_log_prob_backward(x, p, g)
            else:
                km.mix_log_prob(x, p)


HEADS = [("bernoulli", 1), ("gaussian", 3), ("discretized_logistic", 3),
         ("discretized_logistic_mix", 3), ("discretized_logistic_mix", 1)]


def _online_lse(v):
    """K3's logsumexp over axis 1 (``lse_fold``): a running (max, sum), one
    exponential of -|v - m| a value, no branch."""
    m, s = torch.full_like(v[:, 0], -np.inf), torch.zeros_like(v[:, 0])
    for j in range(v.shape[1]):
        vj = v[:, j]
        e = torch.where(vj == m, 1.0, torch.exp(-(vj - m).abs()))
        up = vj > m
        s, m = torch.where(up, s * e + 1.0, s + e), torch.where(up, vj, m)
    return m + torch.log(s)


def _k3_arithmetic(x, p, k, n_bins):
    """``csrc/mixture.cu`` ``mix_fwd_kernel``'s arithmetic in float64, with
    exact exponentials and logarithms where the kernel takes the
    hardware's: tanh as 1 - 2 / (1 + e^(2|v|)); per bin the edges as
    -inf / +inf added to a, a + d and d; min(a + d, -a, 0), plus log d =
    log(2 hb) - ls and the series of (1 - e^-d) / d below d = 0.25, else
    1 - e^-d; the channels' logarithms taken of products; and the
    logsumexps as the branch-free running fold."""
    x, p = x.double(), p.double()
    b, c, h, w = x.shape
    hb, kc = 1.0 / (n_bins - 1), k * c
    xs = (2.0 * x - 1.0).unsqueeze(1)                                   # [B, 1, C, H, W]
    is_left = xs < -1.0 + hb
    left = torch.where(is_left, -np.inf, 0.0)
    right = torch.where(~is_left & (xs > 1.0 - hb), np.inf, 0.0)
    pi = p[:, :k]
    m = p[:, k:k + kc].reshape(b, k, c, h, w)
    ls = p[:, k + kc:k + 2 * kc].reshape(b, k, c, h, w).clamp_min(km.LOG_SCALE_MIN)
    if c == 3:
        raw = p[:, k + 2 * kc:].reshape(b, k, c, h, w)
        co = torch.sign(raw) * (1.0 - 2.0 / (1.0 + torch.exp(2.0 * raw.abs())))
        m = torch.stack([m[:, :, 0], m[:, :, 1] + co[:, :, 0] * xs[:, :, 0],
                         (m[:, :, 2] + co[:, :, 1] * xs[:, :, 0]) + co[:, :, 2] * xs[:, :, 1]],
                        dim=2)
    inv_s = torch.exp(-ls)
    a = inv_s * ((xs - m) - hb)
    d = (2.0 * hb) * inv_s
    A, B, D = a + left, (a + d) + right, d + (right - left)
    series = D < 0.25
    ratio = 1.0 + D * (-0.5 + D * (1 / 6 + D * (-1 / 24 + D * (1 / 120 - D / 720))))
    lin = torch.minimum(torch.minimum(B, -A), torch.zeros_like(B)) + torch.where(
        series, np.log(2.0 * hb) - ls, 0.0)
    num = torch.where(series, ratio, 1.0 - torch.exp(-D))
    den = (1.0 + torch.exp(-A.abs())) * (1.0 + torch.exp(-B.abs()))
    t = lin.sum(2) + torch.log(num.prod(2)) - torch.log(den.prod(2)) + pi    # [B, K, H, W]

    return _online_lse(t) - _online_lse(pi)


class TestFwdPlan:
    """K3's launch plan (``kernels/mixture.py`` ``fwd_plan``: the pixels a
    thread, V), which the wrapper passes to the C entry on every launch,
    and the arithmetic of the kernel it launches (``_k3_arithmetic``); the
    kernel itself runs on the card (``chip_smoke.py`` phase 10 holds every
    V to the plain version)."""

    @pytest.mark.parametrize("b,hw,v", [
        (128, 64 * 64, 4),      # celeba64's training batch, in fp32 and bf16 alike
        (500, 64 * 64, 4),      # celeba64's evaluation batch
        (128, 32 * 32, 2),      # cifar10-deep (BASELINE config 4): V = 4 leaves 32,768 threads
        (256, 32 * 32, 4),      # the bench's cifar10-deep batch
        (16, 32 * 32, 1),       # chip_smoke.py's C = 1 shape: 16,384 pixels
        (32, 64 * 64, 2),       # chip_smoke.py's K = 24 shape
        (8, 7 * 7, 1),          # 49 pixels: no V > 1 divides them
        (4096, 7 * 7, 1),
        (4000, 7 * 6, 2),       # 42 pixels: 2 divides them, 4 does not
        (64, 64 * 64, 4),       # 65,536 threads at V = 4: the least it keeps
        (63, 64 * 64, 2),
    ])
    def test_default_plan(self, b, hw, v):
        assert km.fwd_plan(b, hw) == v
        assert hw % v == 0 and (v == 1 or b * hw // v >= km.MIN_THREADS)

    def test_override_and_its_rejection(self, rng):
        for v in km.FWD_VECTORS:          # any V at any map: unaligned rows run V = 1
            assert km.fwd_plan(128, 64 * 64, v) == v
            assert km.fwd_plan(8, 7 * 7, v) == v
        for bad in [3, 8, 0, "4", (4,), 4.5]:
            with pytest.raises(ValueError, match="plan"):
                km.fwd_plan(128, 64 * 64, bad)
        x, p = (_nchw(a) for a in _mix_data(rng, b=2, h=4, w=4))
        with pytest.raises(ValueError, match="plan"):        # refused on the CPU too
            km.mix_log_prob(x, p, plan=3)

    @pytest.mark.parametrize("plan", [None, *km.FWD_VECTORS])
    def test_cpu_plain_version_ignores_the_plan(self, rng, plan):
        """On the CPU every plan is the plain version, bit for bit, and
        launches nothing."""
        x, p = (_nchw(a) for a in _mix_data(rng, b=2, h=5, w=5))
        before = dict(build.LAUNCHES)
        ll = km.mix_log_prob(x, p, plan=plan)
        assert torch.equal(ll, km._plain_mix_log_prob(x, p, 10, 256))
        assert build.LAUNCHES == before

    @pytest.mark.parametrize("c,k,n_bins", [(3, 10, 256), (1, 10, 256), (3, 4, 16),
                                            (1, 1, 256), (3, 24, 256), (3, 10, 2)])
    def test_kernel_arithmetic_matches_the_plain_version(self, rng, c, k, n_bins):
        """The kernel's rewrite of the bin terms and logsumexps, in float64,
        against the plain version in float64: within the series' 6e-8
        (relative, in the bin's probability), and against the oracle in
        float32. Log-scales from -9 to 2 put d on both sides of the series'
        0.25 and under the floor; the grid's exact 0s and 1s take both edge
        bins."""
        x, p = _mix_data(rng, b=2, h=6, w=6, c=c, k=k)
        lo = k + k * c
        p[..., lo:lo + k * c] = rng.uniform(-9.0, 2.0, size=p[..., lo:lo + k * c].shape)
        x, p = _nchw(x), _nchw(p)
        got = _k3_arithmetic(x, p, k, n_bins)
        want = km._plain_mix_log_prob(x.double(), p.double(), k, n_bins)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-7)
        oracle = np.asarray(jlik.discretized_logistic_mix_log_prob(
            jnp.asarray(_nhwc(x)), jnp.asarray(_nhwc(p)), k, n_bins))
        np.testing.assert_allclose(got.numpy(), oracle, **FWD_TOL)

    def test_logsumexp_keeps_infinities_and_nan(self):
        """The kernel's running logsumexp: a component at -inf drops out,
        all at -inf give -inf, +inf gives +inf and a NaN propagates, as
        ``torch.logsumexp`` (the parent kernel's ``lse_push`` did the
        same)."""
        t = torch.tensor([[0.5, -np.inf, -2.0], [-np.inf] * 3, [1.0, np.inf, 0.0],
                          [np.nan, 1.0, 0.0], [1.0, np.nan, 0.0], [-30.0, 40.0, 39.5]],
                         dtype=torch.float64)
        np.testing.assert_allclose(_online_lse(t).numpy(), torch.logsumexp(t, dim=1).numpy(),
                                   rtol=1e-12)


class TestBwdPlan:
    """K3-bwd's schedule (``kernels/mixture.py`` ``bwd_plan``), which the
    wrapper passes to the C entry on every launch; the kernels themselves
    run on the card (``chip_smoke.py`` phase 10 holds both plans to the
    plain versions)."""

    @pytest.mark.parametrize("k,c,b,hw,plan,smem,v", [
        # every RGB model's head: celeba64's training batch, cifar10-deep's
        (10, 3, 128, 64 * 64, "one_pass", 56_320, 2),
        (10, 3, 128, 32 * 32, "one_pass", 56_320, 2),
        (10, 1, 16, 32 * 32, "one_pass", 10_240, 1),    # grey-scale, 16,384 pixels
        (10, 3, 8, 7 * 7, "one_pass", 28_160, 1),       # 49 pixels: 2 does not divide them
        (1, 3, 64, 64 * 64, "one_pass", 11_264, 2),
        (20, 3, 128, 64 * 64, "one_pass", 112_640, 2),  # the largest K at V = 2
        (21, 3, 128, 64 * 64, "one_pass", 61_952, 1),
        (24, 3, 32, 64 * 64, "one_pass", 67_584, 1),    # chip_smoke.py's large-K shape
        (40, 3, 128, 64 * 64, "one_pass", 112_640, 1),  # the largest K with two CTAs per SM
        (41, 3, 128, 64 * 64, "two_pass", 0, 1),
        (56, 1, 128, 64 * 64, "one_pass", 114_688, 2),  # ... and C = 1
        (112, 1, 128, 64 * 64, "one_pass", 114_688, 1),
        (113, 1, 128, 64 * 64, "two_pass", 0, 1),
    ])
    def test_default_plan(self, k, c, b, hw, plan, smem, v):
        assert km.bwd_plan(k, c, b, hw) == km.Plan(plan, smem, v)
        if plan == "one_pass":   # room for a second CTA, and its 1 KB reserve, on an SM
            assert 2 * (smem + 1024) <= 233_472
        assert km.bwd_plan(k, c, b, hw, "two_pass") == km.Plan("two_pass", 0, 1)

    @pytest.mark.parametrize("k,c,v,fits", [(21, 3, 2, True), (40, 3, 2, True), (41, 3, 2, False),
                                            (82, 3, 1, True), (83, 3, 1, False),
                                            (112, 1, 2, True), (113, 1, 2, False)])
    def test_forced_one_pass_fits_one_cta(self, k, c, v, fits):
        want = 4 * -(-k // km.SPLIT) * km.stored_per_component(c) * km.THREADS * v
        if fits:
            assert km.bwd_plan(k, c, 128, 64 * 64, "one_pass", v) == km.Plan("one_pass", want, v)
            assert want <= km.SMEM_MAX
        else:
            with pytest.raises(ValueError, match="one_pass"):
                km.bwd_plan(k, c, 128, 64 * 64, "one_pass", v)
            if v == 2:           # left to the plan, V = 1 fits
                assert km.bwd_plan(k, c, 128, 64 * 64, "one_pass") == km.Plan(
                    "one_pass", want // 2, 1)
                assert want // 2 <= km.SMEM_MAX

    def test_rejects_unknown_or_oversized_plans_on_any_device(self, rng):
        x, p = (_nchw(a) for a in _mix_data(rng, b=2, h=4, w=4))
        g = torch.ones(2, 4, 4)
        with pytest.raises(ValueError, match="plan"):
            km.bwd_plan(10, 3, 2, 16, "three_pass")
        with pytest.raises(ValueError, match="plan"):
            km.mix_log_prob_backward(x, p, g, plan="three_pass")
        with pytest.raises(ValueError, match="v must"):
            km.mix_log_prob_backward(x, p, g, plan="one_pass", v=4)
        k = 83                   # 42 components a lane: past a CTA at V = 1
        xs, ps = (_nchw(a) for a in _mix_data(rng, b=1, h=4, w=4, k=k))
        with pytest.raises(ValueError, match="one_pass"):
            km.mix_log_prob_backward(xs, ps, torch.ones(1, 4, 4), k, plan="one_pass")

    @pytest.mark.parametrize("plan", [None, *km.PLANS])
    def test_cpu_plain_version_ignores_the_plan(self, rng, plan):
        """On the CPU every plan is the plain hand backward, bit for bit,
        and launches nothing."""
        x, p = (_nchw(a) for a in _mix_data(rng, b=2, h=4, w=4))
        g = torch.from_numpy(rng.standard_normal((2, 4, 4)).astype(np.float32))
        before = dict(build.LAUNCHES)
        dp, dx = km.mix_log_prob_backward(x, p, g, plan=plan)
        dp_h, dx_h = km._plain_mix_log_prob_bwd(x, p, g, 10, 256)
        assert torch.equal(dp, dp_h) and torch.equal(dx, dx_h)
        assert build.LAUNCHES == before


def _head_pair(rng, name, c, fused=False):
    """lvae_tpu's head and its variables, the port's head with the same
    weights (through params_from_flax), features and a target."""
    h = rng.standard_normal((2, 6, 6, 16)).astype(np.float32)
    x = ((rng.uniform(size=(2, 6, 6, c)) < 0.4).astype(np.float32) if name == "bernoulli"
         else _pixels(rng, 2, 6, 6, c, "grid"))
    jh = jheads.make_likelihood(name, c)
    v = jh.init(jax.random.key(0), jnp.asarray(h), jnp.asarray(x))
    # kernel and bias off their normal(1e-2) and zero start
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.3, v)
    th = theads.make_likelihood(name, 16, c, fused_mixture=fused)
    th.load_state_dict(params_from_flax(v["params"]), strict=True)
    return jh, v, th, h, x


class TestHeads:
    @pytest.mark.parametrize("name,c,fused", [
        *((name, c, False) for name, c in HEADS),
        ("discretized_logistic_mix", 3, True), ("discretized_logistic_mix", 1, True)])
    def test_matches_lvae_tpu(self, rng, name, c, fused):
        """ll, mean, mode and params (NHWC) against the flax head; the
        mixture head with and without K3 (on the CPU, its plain
        version), rtol 1e-5."""
        jh, v, th, h, x = _head_pair(rng, name, c, fused)
        ll_j, data_j = jh.apply(v, jnp.asarray(h), jnp.asarray(x))
        with torch.no_grad():
            ll_t, data_t = th(_nchw(h), _nchw(x))
            none_t, _ = th(_nchw(h), None)
        assert none_t is None
        np.testing.assert_allclose(_nhwc(ll_t), np.asarray(ll_j), rtol=1e-5, atol=1e-5)
        for key in ("mean", "mode", "params"):
            np.testing.assert_allclose(_nhwc(data_t[key]), np.asarray(data_j[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        if name == "discretized_logistic_mix":
            # the per-pixel ll spread evenly over the channels
            per_pixel = tlik.discretized_logistic_mix_log_prob(
                _nchw(x), data_t["params"], 10, dim=1)
            np.testing.assert_allclose(ll_t.sum(dim=1).numpy(), per_pixel.numpy(),
                                       rtol=1e-5, atol=1e-5)
            assert bool(((data_t["mean"] >= 0) & (data_t["mean"] <= 1)).all())

    def test_unknown_head_raises(self):
        with pytest.raises(ValueError, match="laplace"):
            theads.make_likelihood("laplace", 8, 3)


def _jax_draw(key, name, params, k=10):
    """The noise lvae_tpu's sample_from_likelihood draws from ``key``, as
    arrays."""
    if name == "bernoulli":
        return {"u": jax.random.uniform(key, params.shape)}
    if name == "gaussian":
        return {"eps": jax.random.normal(key, params[..., :params.shape[-1] // 2].shape)}
    if name == "discretized_logistic":
        shape = params[..., :params.shape[-1] // 2].shape
        return {"u": jax.random.uniform(key, shape, minval=1e-6, maxval=1.0 - 1e-6)}
    c = (params.shape[-1] // k - 1) // 3
    k_sel, k_draw = jax.random.split(key)
    return {"gumbel": jax.random.gumbel(k_sel, params.shape[:-1] + (k,)),
            "u": jax.random.uniform(k_draw, params.shape[:-1] + (c,), minval=1e-5,
                                    maxval=1.0 - 1e-5)}


class TestSampling:
    @pytest.mark.parametrize("name,c", HEADS)
    def test_matches_lvae_tpu_given_its_noise(self, rng, name, c):
        """The port's sample from JAX's own draws equals lvae_tpu's sample
        from the key: exactly on the 256-bin grid (discretized heads and
        Bernoulli), rtol 1e-6 for the Gaussian."""
        jh, v, th, h, _ = _head_pair(rng, name, c)
        _, data_j = jh.apply(v, jnp.asarray(h), None)
        params = data_j["params"]
        key = jax.random.key(11)
        want = np.asarray(jheads.sample_from_likelihood(key, name, params))
        noise = {n: np.asarray(a) for n, a in _jax_draw(key, name, params).items()}
        got = theads.sample_from_likelihood(name, torch.from_numpy(np.array(params)),
                                            noise=noise).numpy()
        assert got.shape == want.shape == (2, 6, 6, c)
        if name == "gaussian":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
        if name.startswith("discretized"):
            assert np.array_equal(np.round(got * 255) / 255, got)
            assert len(np.unique(got)) > 5

    @pytest.mark.parametrize("name,c", HEADS)
    def test_generator_and_keyed_draws(self, rng, name, c):
        """A torch.Generator or the keyed Philox draws the noise:
        reproducible, on the grid, and a batch-invariant keyed draw."""
        _, _, th, h, _ = _head_pair(rng, name, c)
        with torch.no_grad():
            _, data = th(_nchw(h), None)
        params = data["params"].permute(0, 2, 3, 1).contiguous()

        def draw(**kw):
            return theads.sample_from_likelihood(name, params, **kw)

        a = draw(generator=torch.Generator().manual_seed(3))
        assert torch.equal(a, draw(generator=torch.Generator().manual_seed(3)))
        index = torch.tensor([7, 2])
        kd = draw(keyed=(5, index))
        assert torch.equal(kd[1:], theads.sample_from_likelihood(
            name, params[1:], keyed=(5, index[1:])))
        assert not torch.equal(kd, draw(keyed=(6, index)))
        for s in (a, kd):
            assert s.shape == (2, 6, 6, c) and torch.isfinite(s).all()
            if name != "gaussian":
                assert bool(((s >= 0) & (s <= 1)).all())
        with pytest.raises(ValueError, match="exactly one"):
            draw(generator=torch.Generator(), keyed=(5, index))

    def test_logistic_rsample_given_uniforms(self, rng):
        """z = mu + e^ls logit(u) from the uniforms lvae_tpu draws."""
        mu, ls = (rng.normal(size=(3, 4, 4, 2)).astype(np.float32) for _ in range(2))
        key = jax.random.key(4)
        want = np.asarray(jsto.logistic_rsample(key, jnp.asarray(mu), jnp.asarray(ls)))
        u = np.asarray(jax.random.uniform(key, mu.shape, minval=1e-6, maxval=1.0 - 1e-6))
        got = tsto.logistic_rsample(torch.from_numpy(mu), torch.from_numpy(ls),
                                    torch.from_numpy(u))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        g = tsto.logistic_rsample(torch.from_numpy(mu), torch.from_numpy(ls),
                                  generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(g).all()
        with pytest.raises(ValueError):
            tsto.logistic_rsample(torch.from_numpy(mu), torch.from_numpy(ls))
