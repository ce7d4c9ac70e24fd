"""The port's kernel wrappers on the CPU, where they run their plain
PyTorch versions, held against ``lvae_tpu``'s Pallas kernels in interpret
mode. The CUDA kernels themselves are checked on the card by
``chip_smoke.py``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lvae_tpu.kernels import fused_sample_kl, pallas_logsumexp
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
        before = dict(build.LAUNCHES)
        sk.sample_kl(q, p, torch.arange(2), 0, 0, 0)
        sk.sample_kl_eps(q, p, torch.zeros(2, 2, 2, 2))
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

    def test_rejects_bad_operands(self):
        with pytest.raises(ValueError):
            lse.logsumexp(torch.zeros(3))
        with pytest.raises(TypeError):
            lse.logsumexp(torch.zeros(3, 2, dtype=torch.float64))
