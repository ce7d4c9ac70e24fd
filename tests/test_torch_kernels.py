"""The port's kernel wrappers on the CPU, where they run their plain
PyTorch versions, held against ``lvae_tpu``'s Pallas kernels in interpret
mode: K2 (sample+KL), K1 (per-sample sample+KL), their hand-written
backward (K2-bwd, K1-bwd) and K4 (logsumexp). The CUDA kernels themselves
are checked on the card by ``chip_smoke.py``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lvae_tpu.kernels import fused_sample_kl, pallas_logsumexp
from lvae_tpu.kernels.stochastic_pallas import _reduce_dims, fused_sample_kl_per_sample
from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.kernels import logsumexp as lse
from lvae_tpu_torch.kernels import stochastic as sk
from lvae_tpu_torch.ops.stochastic import gaussian_kl, normal_rsample, split_params

SHAPES = [(4, 8, 8, 16), (3, 4, 4, 32), (5, 2, 2, 3)]


def _heads(rng, shape):
    """q and p params NHWC [B,h,w,2c] -> (jax four maps, port NCHW heads)."""
    qmu, qlv, pmu, plv = (rng.standard_normal(shape).astype(np.float32) * s
                          for s in (1.0, 0.5, 1.0, 0.5))
    q = np.concatenate([qmu, qlv], -1).transpose(0, 3, 1, 2)
    p = np.concatenate([pmu, plv], -1).transpose(0, 3, 1, 2)
    return ((qmu, qlv, pmu, plv),
            torch.from_numpy(np.ascontiguousarray(q)),
            torch.from_numpy(np.ascontiguousarray(p)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


class TestSampleKL:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_plain_matches_pallas_with_recovered_eps(self, rng, shape):
        maps, q, p = _heads(rng, shape)
        qmu, qlv = map(jnp.asarray, maps[:2])
        zj, klj = fused_sample_kl(jax.random.key(0), qmu, qlv,
                                  *map(jnp.asarray, maps[2:]))
        # eps recovered from the Pallas draw (stochastic_pallas.py:435)
        eps = np.asarray((zj - qmu) * jnp.exp(-0.5 * qlv))
        zt, klt = sk.sample_kl_eps(q, p, torch.from_numpy(
            np.ascontiguousarray(eps.transpose(0, 3, 1, 2))))
        np.testing.assert_allclose(_nhwc(zt), np.asarray(zj), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_nhwc(klt), np.asarray(klj), rtol=1e-6, atol=1e-7)

    def test_keyed_draw_equals_unfused_path(self, rng):
        """--fused stochastic and --fused none draw the same eps: the
        wrapper's z equals normal_rsample's bit for bit, the KL agrees to
        fp32 rounding."""
        _, q, p = _heads(rng, (6, 4, 4, 8))
        index = torch.tensor([9, 3, 7, 1, 0, 12])
        z, kl = sk.sample_kl(q, p, index, 42, 2, 1)
        mu, lv = split_params(q)
        np.testing.assert_array_equal(
            z.numpy(), normal_rsample(mu, lv, 42, index, 2, 1).numpy()
        )
        np.testing.assert_allclose(kl.numpy(), gaussian_kl(mu, lv, *split_params(p)).numpy(),
                                   rtol=1e-6, atol=1e-7)

    def test_broadcast_prior_reads_row_zero(self, rng):
        _, q, p = _heads(rng, (4, 2, 2, 8))
        index = torch.arange(4)
        full = sk.sample_kl(q, p[:1].expand(4, -1, -1, -1).contiguous(), index, 1, 0, 2)
        for p_in in (p[:1], p[:1].expand(4, -1, -1, -1)):
            z, kl = sk.sample_kl(q, p_in, index, 1, 0, 2)
            np.testing.assert_array_equal(z.numpy(), full[0].numpy())
            np.testing.assert_array_equal(kl.numpy(), full[1].numpy())

    def test_permuted_batch_permutes_outputs(self, rng):
        _, q, p = _heads(rng, (8, 4, 4, 4))
        index = torch.arange(20, 28)
        perm = torch.from_numpy(rng.permutation(8))
        z, kl = sk.sample_kl(q, p, index, 3, 0, 0)
        zp, klp = sk.sample_kl(q[perm].contiguous(), p[perm].contiguous(),
                               index[perm], 3, 0, 0)
        np.testing.assert_array_equal(z[perm].numpy(), zp.numpy())
        np.testing.assert_array_equal(kl[perm].numpy(), klp.numpy())

    def test_cpu_runs_plain_and_counts_no_launch(self, rng):
        _, q, p = _heads(rng, (2, 2, 2, 2))
        q.requires_grad_()
        before = dict(build.LAUNCHES)
        z, kl = sk.sample_kl(q, p, torch.arange(2), 0, 0, 0)
        (z.sum() + kl.sum()).backward()
        sk.sample_kl_eps(q, p, torch.zeros(2, 2, 2, 2))
        z, kl = sk.sample_kl_per_sample(q, p, torch.arange(2), 0, 0, 0)
        (z.sum() + kl.sum()).backward()
        lse.logsumexp(torch.zeros(3, 2))
        assert build.LAUNCHES == before

    @pytest.mark.parametrize("bad", ["dtype", "q_shape", "p_shape", "strided", "eps"])
    def test_rejects_bad_operands(self, rng, bad):
        _, q, p = _heads(rng, (2, 4, 4, 4))
        eps = torch.zeros(2, 4, 4, 4)
        if bad == "dtype":
            q = q.double()
        elif bad == "q_shape":
            q = q[:, :7]
        elif bad == "p_shape":
            p = p[:, :, :2]
        elif bad == "strided":
            q = q.transpose(2, 3)
        else:
            eps = eps[:1]
        with pytest.raises((ValueError, TypeError)):
            sk.sample_kl_eps(q, p, eps)


# (B, h, w, c): F = h w c a multiple of 128 with B % 8 == 0 takes the
# TPU's reduced kernel; the other falls back to the elementwise one + a sum
PER_SAMPLE_SHAPES = [(8, 4, 4, 8), (8, 8, 8, 16), (3, 4, 4, 3)]


def _jax_per_sample(maps, prior=None):
    """lvae_tpu's K1 on four NHWC maps (``prior``: p broadcast from
    [1, h, w, 2c])."""
    qmu, qlv, pmu, plv = map(jnp.asarray, maps)
    return fused_sample_kl_per_sample(jax.random.key(0), qmu, qlv, pmu, plv)


def _eps_nchw(zj, qmu, qlv):
    """eps recovered from the Pallas draw, as lvae_tpu's VJP recovers it
    (stochastic_pallas.py:382)."""
    eps = np.asarray((zj - jnp.asarray(qmu)) * jnp.exp(-0.5 * jnp.asarray(qlv)))
    return torch.from_numpy(np.ascontiguousarray(eps.transpose(0, 3, 1, 2)))


class TestPerSampleKL:
    def test_shapes_cover_both_tpu_paths(self):
        assert _reduce_dims((8, 4, 4, 8))[2] and _reduce_dims((8, 8, 8, 16))[2]
        assert not _reduce_dims((3, 4, 4, 3))[2]

    @pytest.mark.parametrize("shape", PER_SAMPLE_SHAPES)
    def test_plain_matches_pallas_with_recovered_eps(self, rng, shape):
        """rtol 1e-6: the same fp32 terms, summed in another order."""
        maps, q, p = _heads(rng, shape)
        zj, klj = _jax_per_sample(maps)
        eps = _eps_nchw(zj, *maps[:2])
        zt, klt = sk._plain_sample_kl_per_sample_eps(q, p, eps)
        np.testing.assert_allclose(_nhwc(zt), np.asarray(zj), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(klt.numpy(), np.asarray(klj), rtol=1e-6, atol=1e-6)
        # the wrapper takes the plain version on the CPU
        zw, klw = sk.sample_kl_per_sample_eps(q, p, eps)
        np.testing.assert_array_equal(zw.numpy(), zt.numpy())
        np.testing.assert_array_equal(klw.numpy(), klt.numpy())

    def test_keyed_equals_k2_summed(self, rng):
        _, q, p = _heads(rng, (5, 3, 3, 4))
        index = torch.tensor([4, 0, 9, 2, 7])
        z1, kl1 = sk.sample_kl_per_sample(q, p, index, 11, 3, 2)
        z2, kl2 = sk.sample_kl(q, p, index, 11, 3, 2)
        np.testing.assert_array_equal(z1.numpy(), z2.numpy())
        np.testing.assert_allclose(kl1.numpy(), kl2.sum(dim=(1, 2, 3)).numpy(), rtol=1e-6)


class TestBackward:
    """The hand-written backward's plain version against jax.vjp of the
    Pallas kernels' custom VJPs, rtol 1e-6."""

    @pytest.mark.parametrize("shape", PER_SAMPLE_SHAPES)
    @pytest.mark.parametrize("per_sample", [False, True], ids=["K2-bwd", "K1-bwd"])
    def test_plain_matches_pallas_vjp(self, rng, shape, per_sample):
        maps, q, p = _heads(rng, shape)
        jmaps = [jnp.asarray(m) for m in maps]
        fn = fused_sample_kl_per_sample if per_sample else fused_sample_kl
        (zj, klj), vjp = jax.vjp(lambda *m: fn(jax.random.key(0), *m), *jmaps)
        gz = rng.standard_normal(zj.shape).astype(np.float32)
        gkl = rng.standard_normal(klj.shape).astype(np.float32)
        gkl[::2] = 0.0                      # a free-bits clamp zeroes rows
        dqmu, dqlv, dpmu, dplv = (np.asarray(g) for g in vjp((jnp.asarray(gz), jnp.asarray(gkl))))
        eps = _eps_nchw(zj, *maps[:2])
        nchw = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
            a.transpose(0, 3, 1, 2) if a.ndim == 4 else a))
        dq, dp = sk._plain_sample_kl_bwd(q, p, eps, nchw(gz), nchw(gkl))
        c = shape[-1]
        for got, ref in ((dq[:, :c], dqmu), (dq[:, c:], dqlv), (dp[:, :c], dpmu),
                         (dp[:, c:], dplv)):
            np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("per_sample", [False, True], ids=["K2", "K1"])
    @pytest.mark.parametrize("keyed", [False, True], ids=["given-eps", "keyed"])
    def test_autograd_function_gradcheck(self, per_sample, keyed):
        """The autograd.Function (plain forward, hand backward) against
        finite differences in float64, with a stride-0 prior."""
        g = torch.Generator().manual_seed(5)
        b, c, h, w = 3, 2, 3, 2
        q = torch.randn(b, 2 * c, h, w, generator=g, dtype=torch.float64, requires_grad=True)
        prior = torch.randn(1, 2 * c, h, w, generator=g, dtype=torch.float64,
                            requires_grad=True)
        eps = torch.randn(b, c, h, w, generator=g, dtype=torch.float64)
        index = torch.tensor([3, 1, 4])

        def f(q, prior):
            p = prior.expand(b, -1, -1, -1)
            if keyed:
                fn = sk.sample_kl_per_sample if per_sample else sk.sample_kl
                return fn(q, p, index, 6, 2, 1)
            fn = sk.sample_kl_per_sample_eps if per_sample else sk.sample_kl_eps
            return fn(q, p, eps)

        assert torch.autograd.gradcheck(f, (q, prior))

    def test_top_prior_gradient_sums_over_the_batch(self, rng):
        """The learned prior's gradient through its broadcast equals JAX's
        (the broadcast's VJP sums dmu_p, dlv_p over B), rtol 1e-6."""
        b, h, w, c = 8, 2, 2, 32
        maps, q, _ = _heads(rng, (b, h, w, c))
        prior = rng.standard_normal((1, h, w, 2 * c)).astype(np.float32) * 0.5
        gz = rng.standard_normal((b, h, w, c)).astype(np.float32)
        gkl = rng.standard_normal(b).astype(np.float32)

        def loss(prior):
            pb = jnp.broadcast_to(prior, (b, h, w, 2 * c))
            z, kl = fused_sample_kl_per_sample(jax.random.key(1), jnp.asarray(maps[0]),
                                               jnp.asarray(maps[1]), pb[..., :c], pb[..., c:])
            return jnp.sum(z * gz) + jnp.sum(kl * gkl), z

        (_, zj), gj = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(prior))
        eps = _eps_nchw(zj, *maps[:2])
        pt = torch.from_numpy(np.ascontiguousarray(prior.transpose(0, 3, 1, 2))).requires_grad_()
        z, kl = sk.sample_kl_per_sample_eps(q, pt.expand(b, -1, -1, -1), eps)
        torch.autograd.backward([z, kl], [torch.from_numpy(np.ascontiguousarray(
            gz.transpose(0, 3, 1, 2))), torch.from_numpy(gkl)])
        assert pt.grad.shape == (1, 2 * c, h, w)
        np.testing.assert_allclose(_nhwc(pt.grad), np.asarray(gj), rtol=1e-6, atol=1e-5)

    def test_backward_rejects_bad_operands(self, rng):
        _, q, p = _heads(rng, (2, 2, 2, 3))
        gz, eps = torch.zeros(2, 3, 2, 2), torch.zeros(2, 3, 2, 2)
        with pytest.raises(ValueError, match="exactly one"):
            sk.sample_kl_backward(q, p, gz, torch.zeros(2))
        with pytest.raises(ValueError, match="gkl"):
            sk.sample_kl_backward(q, p, gz, torch.zeros(3), eps=eps)
        with pytest.raises(ValueError, match="gz"):
            sk.sample_kl_backward(q, p, gz[:1], torch.zeros(2), eps=eps)


class TestLogsumexp:
    def _both(self, x, rtol=1e-6, atol=1e-6):
        ref = np.asarray(pallas_logsumexp(jnp.asarray(x)))
        got = lse.logsumexp(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
        return got

    def test_matches_pallas(self, rng):
        self._both(rng.standard_normal((100, 1000)).astype(np.float32) * 10)

    def test_ragged_batch(self, rng):
        self._both(rng.standard_normal((7, 333)).astype(np.float32))

    def test_extreme_values(self):
        x = np.asarray([[-1e4, 1e4, -1e4], [-1e4 + 1, 1e4 - 1, -1e4]], np.float32)
        self._both(x)

    def test_infinite_columns(self, rng):
        x = rng.standard_normal((100, 6)).astype(np.float32)
        x[:, 0] = -np.inf          # all -inf -> -inf, not NaN
        x[1:, 1] = -np.inf         # all but one -> that one
        x[:, 2] = 1e30
        x[:, 3] = -1e30
        got = self._both(x)
        assert got[0] == -np.inf and got[1] == x[0, 1]

    def test_nan_and_plus_inf_columns(self, rng):
        """A column that holds a NaN or a +inf has no finite max: -inf, as
        the TPU kernel's guard gives; the other columns are untouched."""
        x = rng.standard_normal((100, 5)).astype(np.float32)
        x[37, 0] = np.nan
        x[:, 1] = np.nan
        x[99, 2] = np.inf
        x[:, 3] = np.inf
        got = self._both(x)
        assert (got[:4] == -np.inf).all() and np.isfinite(got[4])

    def test_rejects_bad_operands(self):
        with pytest.raises(ValueError):
            lse.logsumexp(torch.zeros(3))
        with pytest.raises(TypeError):
            lse.logsumexp(torch.zeros(3, 2, dtype=torch.float64))
