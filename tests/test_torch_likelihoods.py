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
