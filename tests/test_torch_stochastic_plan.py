"""The launch plans of the per-sample sample+KL kernel (K1) and of the
backward kernels (K1-bwd, K2-bwd), ``kernels/stochastic.py``
``k1_plan`` and ``k1_bwd_plan``, at every training shape of the flagship
and celeba64 and at odd shapes; and the backward's stride-0 prior
contract (dp ``[1, 2c, h, w]``, summed over B) on the CPU. The CUDA
kernels that take these plans are checked on the card by
``chip_smoke.py`` (phases 6 and 7)."""

import itertools

import numpy as np
import pytest
import torch

from lvae_tpu_torch.kernels import stochastic as sk

# (rows, c, h, w): the flagship's training latents at B=64, celeba64's at
# B=128 (the last of each reads the learned prior with row stride 0), the
# odd shape of chip_smoke.py at both batches, one row, rows whose length
# is not a multiple of 4, and rows long enough for several units per
# thread
MODEL_SHAPES = [(64, 32, 8, 8), (64, 32, 4, 4), (64, 32, 2, 2),
                (128, 32, 16, 16), (128, 32, 8, 8), (128, 32, 4, 4), (128, 32, 2, 2)]
SHAPES = MODEL_SHAPES + [(64, 3, 7, 7), (256, 3, 7, 7), (1, 32, 8, 8), (1, 3, 7, 7),
                         (8, 5, 3, 3), (16, 1, 9, 1), (4, 32, 32, 32), (2, 3, 33, 33)]
SMS = 132


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


class TestK1Plan:
    @pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
    @pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
    def test_covers_each_unit_once(self, shape, aligned):
        b, c, h, w = shape
        plan = sk.k1_plan(b, c, h * w, aligned)
        per_row = c * h * w
        assert plan.rows == b and plan.per_row == per_row
        # float4 units only where the row splits into them, the planes are
        # 16-byte aligned and the row is long; else the scalar path
        assert plan.vec == (4 if per_row % 4 == 0 and aligned and per_row > sk.K1_SCALAR_MAX
                            else 1)
        assert 32 <= plan.threads <= sk.K1_MAX_THREADS and plan.threads % 32 == 0
        # as few units per thread as K1_MAX_THREADS threads allow, and no
        # more threads than take them
        assert plan.per_thread == -(-plan.units // sk.K1_MAX_THREADS)
        assert plan.threads - 32 < -(-plan.units // plan.per_thread) <= plan.threads
        seen = [u for t in range(plan.threads) for u in plan.units_of(t)]
        assert sorted(seen) == list(range(plan.units))
        assert all(len(plan.units_of(t)) <= plan.per_thread for t in range(plan.threads))

    @pytest.mark.parametrize("shape", MODEL_SHAPES, ids=_ids(MODEL_SHAPES))
    def test_model_layers(self, shape):
        """The models' layers: float4 units at 16x16 only, at most 4 units
        a thread."""
        b, c, h, w = shape
        plan = sk.k1_plan(b, c, h * w)
        assert plan.vec == (4 if h >= 16 else 1)
        assert plan.per_thread <= 4

    def test_a_function_of_the_shape(self):
        assert sk.k1_plan(128, 32, 256) == sk.k1_plan(128, 32, 256)
        assert sk.k1_plan(128, 32, 256) == (128, 8192, 4, 512, 4)
        # a longer row: more units per thread in the one CTA
        assert sk.k1_plan(4, 32, 1024) == (4, 32768, 4, 512, 16)

    @pytest.mark.parametrize("bad", [(0, 32, 4), (4, 0, 4), (4, 1, 2 ** 30)])
    def test_rejects(self, bad):
        with pytest.raises(ValueError):
            sk.k1_plan(*bad)


def _bwd_cover(plan):
    """{(row, unit): times} over the plan's grid and threads."""
    gx, gy = plan.grid
    seen = {}
    for bx, by, t in itertools.product(range(gx), range(gy), range(plan.px * plan.ry)):
        tx, ty = t % plan.px, t // plan.px
        u = by * plan.px + tx
        if u >= plan.units:
            continue
        rows = range(ty, plan.rows, plan.ry) if plan.prior_sum else [bx * plan.ry + ty]
        for row in rows:
            if row < plan.rows:
                seen[(row, u)] = seen.get((row, u), 0) + 1
    return seen


class TestBwdPlan:
    @pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
    @pytest.mark.parametrize("prior_sum", [False, True], ids=["per-row-p", "stride-0-p"])
    @pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
    def test_covers_each_element_once(self, shape, prior_sum, aligned):
        b, c, h, w = shape
        plan = sk.k1_bwd_plan(b, c, h * w, prior_sum, aligned)
        per_row = c * h * w
        threads = plan.px * plan.ry
        assert threads % 32 == 0
        seen = _bwd_cover(plan)
        assert len(seen) == b * plan.units and set(seen.values()) == {1}
        gx, gy = plan.grid
        assert (gy - 1) * plan.px < plan.units                    # no slice empty
        if prior_sum:
            # all rows of a slice in one CTA: the sum crosses no CTA and
            # needs no atomics; a power of 2 across the rows for its tree
            assert plan.prior_sum == 1 and plan.vec == 1 and gx == 1
            assert threads <= sk.SUM_MAX_THREADS and plan.ry & (plan.ry - 1) == 0
        else:
            # float4 units only where the row splits into them, the
            # operands are 16-byte aligned and the launch is large; else
            # the scalar path
            assert plan.vec == (4 if per_row % 4 == 0 and aligned
                                and b * per_row >= sk.BWD_VEC_MIN else 1)
            assert plan.prior_sum == 0 and threads <= sk.BWD_MAX_THREADS and gy <= 65535
            assert (gx - 1) * plan.ry < b                             # no row group empty

    def test_top_layers_sum_in_one_cta_per_slice(self):
        for b in (64, 128):
            plan = sk.k1_bwd_plan(b, 32, 4, True)
            assert plan.grid == (1, 128 // sk.SUM_PX) and plan.ry == b


def _heads(seed, b, c, h, w, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, 2 * c, h, w)) * 0.7).to(dtype)
    prior = torch.from_numpy(rng.standard_normal((1, 2 * c, h, w)) * 0.7).to(dtype)
    eps = torch.from_numpy(rng.standard_normal((b, c, h, w))).to(dtype)
    gz = torch.from_numpy(rng.standard_normal((b, c, h, w))).to(dtype)
    return q, prior, eps, gz, rng


class TestStrideZeroPrior:
    @pytest.mark.parametrize("keyed", [False, True], ids=["given-eps", "keyed"])
    @pytest.mark.parametrize("per_sample", [False, True], ids=["K2-bwd", "K1-bwd"])
    @pytest.mark.parametrize("given", ["one-row", "stride-0"])
    def test_backward_returns_the_summed_row(self, given, per_sample, keyed):
        """dp comes back [1, 2c, h, w]: the per-row dp of the materialised
        prior summed over B (in fp64, as the kernel sums)."""
        b, c, h, w = 6, 3, 2, 2
        q, prior, eps, gz, rng = _heads(7, b, c, h, w)
        gkl = torch.from_numpy(rng.standard_normal(b if per_sample else (b, c, h, w))).float()
        gkl[::3] = 0.0
        p = prior if given == "one-row" else prior.expand(b, -1, -1, -1)
        kw = ({"keyed": sk.Keyed(torch.arange(b), 5, 1, 2)} if keyed else {"eps": eps})
        dq, dp = sk.sample_kl_backward(q, p, gz, gkl, **kw)
        eps_used = sk._eps_of(kw["keyed"], q) if keyed else eps
        dq_r, dp_rows = sk._plain_sample_kl_bwd(q, prior.expand(b, -1, -1, -1).contiguous(),
                                                eps_used, gz, gkl)
        assert dp_rows.shape == (b, 2 * c, h, w) and dp.shape == (1, 2 * c, h, w)
        np.testing.assert_array_equal(dq.numpy(), dq_r.numpy())
        np.testing.assert_allclose(dp.numpy(), dp_rows.double().sum(0, keepdim=True).numpy(),
                                   rtol=1e-6, atol=1e-7)

    def test_top_layer_hands_its_prior_row(self, monkeypatch):
        """A fused train-mode forward hands the kernels the learned prior
        itself, the row its stride-0 view repeats, so its gradient comes
        back [1, 2c, h, w] with no broadcast to sum; that gradient equals
        the unfused model's."""
        from lvae_tpu_torch.models.lvae import LadderVAE
        from lvae_tpu_torch.models.stochastic import Noise

        seen = []
        apply = sk._SampleKL.apply

        def spy(q, p, *rest):
            seen.append(p)
            return apply(q, p, *rest)

        monkeypatch.setattr(sk._SampleKL, "apply", spy)
        rng = np.random.default_rng(2)
        x = torch.from_numpy((rng.uniform(size=(4, 28, 28, 1)) < 0.4).astype(np.float32))
        noise = Noise(5, torch.arange(4), 1)
        grads = []
        for fused in (True, False):
            model = LadderVAE(color_ch=1, z_dims=(3, 3), downsample=(1, 1), blocks_per_layer=1,
                              n_filters=8, learn_top_prior=True, fused_stochastic=fused)
            out = model(x, noise=noise, train=True)
            (out["ll"] - out["kl_sep"].sum(0)).sum().backward()
            prior, = [m.top_prior for m in model.modules()
                      if getattr(m, "top_prior", None) is not None]
            if fused:
                assert len(seen) == 2 and seen[0] is prior         # top layer first
            grads.append(prior.grad)
        assert grads[0].shape == grads[1].shape == (1, 6, 4, 4)
        np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("make", ["parameter-expand", "row-of-a-batch", "leaf-view"])
    def test_gradient_through_a_broadcast(self, make):
        """The learned prior's gradient through the autograd.Function equals
        that of the materialised prior, however the broadcast was made
        (the kernels read its first row; autograd takes the gradient on
        through the view)."""
        b, c, h, w = 4, 2, 2, 2
        q, prior, _, gz, rng = _heads(11, b, c, h, w, torch.float64)
        gkl = torch.from_numpy(rng.standard_normal(b))
        index = torch.arange(b)

        def grad_of(p_in, leaf):
            z, kl = sk.sample_kl_per_sample(q, p_in, index, 3, 0, 1)
            torch.autograd.backward([z, kl], [gz, gkl])
            return leaf.grad

        ref_leaf = prior.clone().requires_grad_()
        ref = grad_of(ref_leaf.expand(b, -1, -1, -1).contiguous(), ref_leaf)
        if make == "parameter-expand":
            leaf = prior.clone().requires_grad_()
            got = grad_of(leaf.expand(b, -1, -1, -1), leaf)
        elif make == "row-of-a-batch":
            leaf = prior.repeat(3, 1, 1, 1).requires_grad_()
            got = grad_of(leaf[1:2].expand(b, -1, -1, -1), leaf)[1:2]
        else:
            # a broadcast that is itself the leaf: its gradient lands on the
            # view, row 0 taking the sum over B
            leaf = prior.expand(b, -1, -1, -1).detach().requires_grad_()
            got = grad_of(leaf, leaf).sum(0, keepdim=True)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
