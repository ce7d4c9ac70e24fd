"""The fused train-mode dropout + BatchNorm + activation segment (K5 and
K5-bwd) and the BatchNorm branch of the residual block, on the CPU, held
against ``lvae_tpu``.

``lvae_tpu``'s ``fused_dropout_bn_act`` runs here in interpret mode with
its mask bits precomputed as ``jax.random.bits(key, (rows, f C), uint8)``
(``segment_pallas.py:260-267``); the tests compute the same bits from the
same key, unfold them to NCHW and hand them to the port's plain versions
as ``mask_bytes``. C = 8 and NHWC ``[4, 8, 8, 8]`` let its fold tile (C
divides 128, N / f a multiple of 8), so the Pallas path, not its XLA
fallback, is the reference. Tolerances are ``tests/test_pallas.py``'s
(forward 1e-5, gradients 1e-4) unless a test says otherwise."""

import functools
import inspect
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax.traverse_util import flatten_dict

from lvae_tpu.kernels.segment_pallas import fused_dropout_bn_act as j_segment
from lvae_tpu.models import blocks as jblocks
from lvae_tpu.models.lvae import LadderVAE as JaxLVAE
from lvae_tpu.ops.math import crop_img_tensor, pad_img_tensor
from lvae_tpu_torch.kernels import build
from lvae_tpu_torch.kernels.segment import dropout_bn_act
from lvae_tpu_torch.models import blocks as tblocks
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.ops.math import bits8_keep_threshold, segment_backward, segment_forward
from lvae_tpu_torch.ops.philox import dropout_bytes, mix_seed, philox4x32, seed_words
from lvae_tpu_torch.train.convert import params_from_flax

SHAPE = (4, 8, 8, 8)                        # NHWC
CASES = [pytest.param(rate, act, id=f"{act}-rate{rate}")
         for rate in (0.0, 0.2) for act in ("elu", "relu")]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _inputs(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 1.5 + 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=shape[-1]).astype(np.float32)
    beta = (rng.normal(size=shape[-1]) * 0.2).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, gamma, beta, g


def _jax_bits(key, shape):
    """The interpret-mode kernel's mask bytes, unfolded to NCHW."""
    b, h, w, c = shape
    f = 128 // c
    bits = jax.random.bits(key, (b * h * w // f, f * c), jnp.uint8)
    return _nchw(np.asarray(bits).reshape(shape))


class TestPlainVsPallas:
    @pytest.mark.parametrize("rate,act", CASES)
    def test_forward(self, rate, act):
        x, gamma, beta, _ = _inputs()
        key = jax.random.key(5)
        yj, mj, vj = j_segment(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                               key if rate else None, rate=rate, act=act)
        y, mean, var, _ = segment_forward(_nchw(x), torch.from_numpy(gamma),
                                          torch.from_numpy(beta), bits8_keep_threshold(rate),
                                          act, mask_bytes=_jax_bits(key, SHAPE) if rate else None)
        np.testing.assert_allclose(_nhwc(y), np.asarray(yj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mean.numpy(), np.asarray(mj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(var.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("rate,act", CASES)
    def test_hand_backward_vs_jax_grad(self, rate, act):
        x, gamma, beta, g = _inputs(1)
        key = jax.random.key(6)

        def loss(x_, gm, bt):
            y = j_segment(x_, gm, bt, key if rate else None, rate=rate, act=act)[0]
            return jnp.sum(y * jnp.asarray(g))

        dj = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma),
                                               jnp.asarray(beta))
        bits = _jax_bits(key, SHAPE) if rate else None
        t = bits8_keep_threshold(rate)
        xt = _nchw(x)
        _, mean, _, r = segment_forward(xt, torch.from_numpy(gamma), torch.from_numpy(beta),
                                        t, act, mask_bytes=bits)
        dx, dgamma, dbeta = segment_backward(xt, _nchw(g), torch.from_numpy(gamma),
                                             torch.from_numpy(beta), mean, r, t, act, bits)
        np.testing.assert_allclose(_nhwc(dx), np.asarray(dj[0]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(dgamma.numpy(), np.asarray(dj[1]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(dbeta.numpy(), np.asarray(dj[2]), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("rate,act", CASES)
    def test_hand_backward_vs_autograd_float64(self, rate, act):
        """In float64 the hand backward is autograd of the plain forward
        to 1e-10 (the only differences are the order of the sums)."""
        x, gamma, beta, g = (torch.from_numpy(a).double() for a in _inputs(2))
        x, g = x.permute(0, 3, 1, 2).contiguous(), g.permute(0, 3, 1, 2).contiguous()
        t = bits8_keep_threshold(rate)
        bits = dropout_bytes(x.shape, 123) if rate else None
        xr, gr, br = (v.clone().requires_grad_() for v in (x, gamma, beta))
        y, mean, _, r = segment_forward(xr, gr, br, t, act, mask_bytes=bits)
        y.backward(g)
        dx, dgamma, dbeta = segment_backward(x, g, gamma, beta, mean.detach(), r.detach(), t,
                                             act, bits)
        for got, want in ((dx, xr.grad), (dgamma, gr.grad), (dbeta, br.grad)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-10)

    @pytest.mark.parametrize("rate", [0.999, 0.001], ids=["t0-drops-all", "t256-no-mask"])
    def test_degenerate_thresholds(self, rate):
        """t <= 0: y = act(beta), zero statistics, dx = 0, dgamma = 0 and
        dbeta the cotangent's sum through act'(beta); t >= 256: no mask
        (segment_pallas.py:397-408)."""
        x, gamma, beta, g = _inputs(3)
        key = jax.random.key(7)

        def run(x_, gm, bt):
            return j_segment(x_, gm, bt, key, rate=rate, act="elu")

        (yj, mj, vj), vjp = jax.vjp(run, jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
        dj = vjp((jnp.asarray(g), jnp.zeros_like(mj), jnp.zeros_like(vj)))
        xr, gr, br = (torch.from_numpy(a).requires_grad_()
                      for a in (_nchw(x).numpy(), gamma, beta))
        y, mean, var = dropout_bn_act(xr, gr, br, rate=rate, act="elu", seed=9)
        y.backward(_nchw(g))
        np.testing.assert_allclose(_nhwc(y), np.asarray(yj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mean.numpy(), np.asarray(mj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(var.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-5)
        for got, want in ((xr.grad, _nchw(dj[0])), (gr.grad, dj[1]), (br.grad, dj[2])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        if bits8_keep_threshold(rate) <= 0:
            assert not xr.grad.any() and not gr.grad.any() and not mean.any()

    def test_autograd_function_and_running_stats(self):
        """dropout_bn_act (keyed bytes) through its autograd.Function: the
        gradient is the hand backward's, the running statistics move as
        flax's (m = 0.9, biased variance), and a CPU tensor launches no
        kernel."""
        x, gamma, beta, g = (torch.from_numpy(a) for a in _inputs(4))
        x, g = x.permute(0, 3, 1, 2).contiguous(), g.permute(0, 3, 1, 2).contiguous()
        rm, rv = torch.full((8,), 0.5), torch.full((8,), 2.0)
        xr = x.clone().requires_grad_()
        build.reset_launches()
        y, mean, var = dropout_bn_act(xr, gamma, beta, rate=0.2, act="elu", seed=77,
                                      running_mean=rm, running_var=rv)
        y.backward(g)
        assert not any(build.LAUNCHES.values())
        t = bits8_keep_threshold(0.2)
        bits = dropout_bytes(x.shape, mix_seed(77, 0, 0))      # step 0, site 0
        y2, mean2, var2, r2 = segment_forward(x, gamma, beta, t, "elu", mask_bytes=bits)
        assert torch.equal(y, y2) and torch.equal(mean, mean2) and torch.equal(var, var2)
        dx, _, _ = segment_backward(x, g, gamma, beta, mean2, r2, t, "elu", bits)
        assert torch.equal(xr.grad, dx)
        np.testing.assert_allclose(rm.numpy(), 0.9 * 0.5 + 0.1 * mean.numpy(), rtol=1e-6)
        np.testing.assert_allclose(rv.numpy(), 0.9 * 2.0 + 0.1 * var.numpy(), rtol=1e-6)
        u = torch.where(bits < t, x * np.float32(256 / t), 0.0).double()
        np.testing.assert_allclose(var.numpy(), u.var(dim=(0, 2, 3), unbiased=False).numpy(),
                                   rtol=1e-6)


class TestPhiloxMask:
    def test_bytes_are_the_philox_words(self):
        """Element e takes byte e % 16 of Philox at counter (e // 16, 0, 0,
        stream) under the seed's words."""
        seed = mix_seed(54321, 7, 3)
        got = dropout_bytes((2, 3, 5, 7), seed).flatten()       # 210: a ragged last group
        e = torch.arange(got.numel())
        w = philox4x32(e // 16, 0, 0, 0x80000005, *seed_words(seed))
        words = torch.stack(w, dim=1)[torch.arange(len(e)), (e % 16) // 4]
        assert torch.equal(got.long(), (words >> (8 * (e % 4))) & 255)

    def test_keyed_by_step_and_site(self):
        a = dropout_bytes((8, 16, 8, 8), mix_seed(1, 5, 2))
        assert torch.equal(a, dropout_bytes((8, 16, 8, 8), mix_seed(1, 5, 2)))
        assert not torch.equal(a, dropout_bytes((8, 16, 8, 8), mix_seed(1, 6, 2)))
        assert not torch.equal(a, dropout_bytes((8, 16, 8, 8), mix_seed(1, 5, 3)))

    def test_drop_fraction(self):
        """Over 2^17 elements the dropped share is (256 - t) / 256 within
        0.01, and every kept element is scaled by 256 / t."""
        t = bits8_keep_threshold(0.2)
        x = torch.ones(8, 16, 32, 32)
        y, _, _ = dropout_bn_act(x, torch.ones(16), torch.zeros(16), rate=0.2, act="relu",
                                 seed=3, step=1, site=0)
        bits = dropout_bytes(x.shape, mix_seed(3, 1, 0))
        dropped = (bits >= t).double().mean().item()
        assert x.numel() >= 10 ** 5 and abs(dropped - (256 - t) / 256) < 0.01
        u = torch.where(bits < t, x * np.float32(256 / t), 0.0)
        assert set(np.unique(u.numpy())) == {0.0, np.float32(256.0 / t)}

    def test_dx_is_zero_exactly_where_dropped(self):
        """For positive x (every kept element's dz nonzero), dx is 0 at the
        dropped elements and only there."""
        x = torch.rand(4, 8, 8, 8) + 0.5
        g = torch.rand(4, 8, 8, 8) + 0.5
        xr = x.clone().requires_grad_()
        y, _, _ = dropout_bn_act(xr, torch.ones(8), torch.full((8,), 0.1), rate=0.2,
                                 act="elu", seed=11, step=torch.tensor(2), site=5)
        y.backward(g)
        kept = dropout_bytes(x.shape, mix_seed(11, 2, 5)) < bits8_keep_threshold(0.2)
        assert torch.equal(xr.grad != 0, kept)


# ---------------------------------------------------------------------------
# the kernels' launch plan (kernels/segment.py _plan, csrc/segment.cu)
# ---------------------------------------------------------------------------

# every segment shape of celeba64 (B = 128) and the flagship (B = 64)
MODEL_SHAPES = [(128, 64, s, s) for s in (64, 32, 16, 8, 4, 2)] + \
               [(64, 64, s, s) for s in (32, 16, 8, 4, 2)]
ODD_SHAPES = [(4, 3, 7, 7), (2, 5, 1, 1), (8, 3, 16, 16), (1, 64, 8, 8), (3, 2, 5, 6),
              (256, 64, 128, 128)]
DIRECTIONS = ("fwd", "bwd")


def _share_elements(plan, rank):
    """The channel-local elements of CTA ``rank``'s share, in the order of
    the kernels' float accesses (csrc/segment.cu share_of, Share.elem)."""
    units = plan.b * plan.hw // plan.vec
    lo, hi = units * rank // plan.cluster, units * (rank + 1) // plan.cluster
    return np.arange(lo * plan.vec, hi * plan.vec)


def _assert_legal(plan, shape, direction):
    from lvae_tpu_torch.kernels import segment as seg

    b, c, h, w = shape
    per_unit = (4 if direction == "fwd" else 8) * plan.vec + 4
    assert (plan.b, plan.c, plan.hw) == (b, c, h * w)
    assert plan.vec in (1, 4, 16) and plan.hw % plan.vec == 0
    assert plan.vec == 16 or (plan.hw % 16 != 0 and (plan.vec == 4) == (plan.hw % 4 == 0))
    assert plan.cluster in (1, 2, 4, 8, 16)
    assert plan.portable == (plan.cluster <= 8)       # 16 only as the non-portable size
    assert 32 <= plan.threads <= seg.MAX_THREADS and plan.threads % 32 == 0
    assert 1 <= plan.clusters <= c and plan.channels_per_cta * plan.clusters >= c
    assert plan.smem + seg.SMEM_STATIC <= seg.SMEM_MAX
    # on chip only where the CTA's whole share fits, and never for 4-byte units
    if plan.path == "on_chip":
        assert plan.vec > 1 and plan.chip == plan.units
        assert plan.units * per_unit <= seg.SMEM_BUDGET
    else:
        assert plan.chip < plan.units and (plan.vec > 1 or plan.chip == 0)
        assert plan.units * per_unit > seg.SMEM_BUDGET or plan.chip == 0
        assert plan.smem <= seg.PART_BUDGET
    assert plan.smem == plan.chip * per_unit + 4 * min(plan.units - plan.chip, seg.KEEP_CHUNK)
    # the CTAs' shares partition the channel's units, every share within
    # `units` of the plan
    units = b * h * w // plan.vec
    bounds = [units * r // plan.cluster for r in range(plan.cluster + 1)]
    assert bounds[0] == 0 and bounds[-1] == units
    assert all(0 <= hi - lo <= plan.units for lo, hi in zip(bounds, bounds[1:]))


def _assert_every_element_once(plan):
    """Each element of the map falls to exactly one (channel, CTA, thread)
    access: channels walked by the clusters, shares by the ranks, floats by
    the threads (F = 4 per access where vec > 1)."""
    b, c, hw = plan.b, plan.c, plan.hw
    f = 1 if plan.vec == 1 else 4
    seen = np.zeros(b * c * hw, np.int64)
    for cid in range(plan.clusters):
        for ch in range(cid, c, plan.clusters):
            for rank in range(plan.cluster):
                ce = _share_elements(plan, rank)[::f]          # each access's first float
                # access i is thread i % threads's (i // threads)-th
                tid = np.arange(len(ce)) % plan.threads
                assert np.bincount(tid, minlength=plan.threads).max() <= \
                    -(-len(ce) // plan.threads)
                e = (ce // hw) * c * hw + ch * hw + ce % hw
                for j in range(f):
                    np.add.at(seen, e + j, 1)
    assert (seen == 1).all()


class TestPlan:
    @pytest.mark.parametrize("direction", DIRECTIONS)
    @pytest.mark.parametrize("shape", MODEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
    def test_model_shapes_get_a_legal_plan(self, shape, direction):
        """All 11 segment shapes of the two models, both directions, on
        the default path and on every path it can be forced to."""
        from lvae_tpu_torch.kernels import segment as seg

        plan = seg._plan(*shape, direction)
        _assert_legal(plan, shape, direction)
        two = seg._plan(*shape, direction, "two_sweep")
        _assert_legal(two, shape, direction)
        assert two.path == "two_sweep" and two.chip == 0 and plan.cluster == two.cluster
        # every map of the models fits a CTA's share on chip but celeba64's
        # 64x64 backward (4 MB of g and x per channel)
        assert plan.path == ("two_sweep" if shape[2] == 64 and direction == "bwd"
                             else "on_chip")

    @pytest.mark.parametrize("shape", [s for s in MODEL_SHAPES if np.prod(s) <= 2 ** 19],
                             ids=lambda s: "x".join(map(str, s)))
    def test_every_element_assigned_once(self, shape):
        from lvae_tpu_torch.kernels import segment as seg

        for direction in DIRECTIONS:
            _assert_every_element_once(seg._plan(*shape, direction))

    @pytest.mark.parametrize("shape", [MODEL_SHAPES[0], MODEL_SHAPES[6], ODD_SHAPES[0]],
                             ids=lambda s: "x".join(map(str, s)))
    def test_a_function_of_the_shape_alone(self, shape):
        """Equal on repeated calls (the cache cleared between them) and for
        any data: the wrapper reads nothing but the shape."""
        from lvae_tpu_torch.kernels import segment as seg

        first = [seg._plan(*shape, d, p) for d in DIRECTIONS for p in (None, "two_sweep")]
        seg._plan.cache_clear()
        assert first == [seg._plan(*shape, d, p) for d in DIRECTIONS for p in (None, "two_sweep")]
        sig = inspect.signature(seg._plan.__wrapped__)
        assert list(sig.parameters) == ["b", "c", "h", "w", "direction", "path"]

    @pytest.mark.parametrize("shape", ODD_SHAPES, ids=lambda s: "x".join(map(str, s)))
    def test_odd_shapes_get_a_legal_plan(self, shape):
        """H W = 49 and 30 (no 16-byte unit: only the two-sweep path), 1x1,
        C = 3, B = 1, and a channel larger than any cluster's shared memory,
        which takes the two-sweep path."""
        from lvae_tpu_torch.kernels import segment as seg

        for direction in DIRECTIONS:
            plan = seg._plan(*shape, direction)
            _assert_legal(plan, shape, direction)
            if np.prod(shape) <= 2 ** 16:
                _assert_every_element_once(plan)
            if shape[2] * shape[3] % 4 != 0 or shape == (256, 64, 128, 128):
                assert plan.path == "two_sweep"
                with pytest.raises(ValueError, match="two-sweep"):
                    seg._plan(*shape, direction, "on_chip")

    def test_rejects_what_the_kernels_do_not_take(self):
        from lvae_tpu_torch.kernels import segment as seg

        with pytest.raises(ValueError, match="direction"):
            seg._plan(4, 8, 8, 8, "both")
        with pytest.raises(ValueError, match="path"):
            seg._plan(4, 8, 8, 8, "fwd", "one_sweep")
        with pytest.raises(ValueError, match="2\\^31"):
            seg._plan(2 ** 16, 1, 2 ** 8, 2 ** 8, "fwd")


# ---------------------------------------------------------------------------
# the residual block's BatchNorm branch
# ---------------------------------------------------------------------------

BLOCK_CASES = [
    pytest.param(dict(nonlin="elu"), True, id="fused-elu"),
    pytest.param(dict(nonlin="relu", block_type="cdbacdba"), True, id="fused-relu-cdba"),
    pytest.param(dict(nonlin="elu", dropout_impl="float"), False, id="float-dropout"),
    pytest.param(dict(nonlin="gelu"), False, id="gelu"),
    pytest.param(dict(nonlin="elu", bn_stat_samples=2), False, id="bn-stat-samples"),
]


def _perturbed(v, rng):
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.1,
        v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, size=a.shape).astype(np.float32),
        v["batch_stats"])
    return {"params": params, "batch_stats": stats}


class TestResidualBlock:
    @pytest.mark.parametrize("kw,fusable", BLOCK_CASES)
    def test_train_mode_matches_lvae_tpu(self, kw, fusable):
        """ResidualBlock(fused_segments=True) in training, dropout 0, from
        one flax variable tree: y, the moved batch_stats, and the parameter
        and input gradients. Where the block cannot fuse (float dropout,
        GELU, subsampled statistics) both packages keep the unfused ops."""
        rng = np.random.default_rng(8)
        kw = dict(dict(block_type="bacdbacd", gated=True, dropout_rate=0.0), **kw)
        x = rng.normal(size=SHAPE).astype(np.float32)
        cot = rng.normal(size=SHAPE).astype(np.float32)
        jb = jblocks.ResidualBlock(channels=8, fused_segments=True, **kw)
        v = _perturbed(jb.init(jax.random.key(0), jnp.asarray(x), True), rng)

        def loss(params, x_):
            y, upd = jb.apply({"params": params, "batch_stats": v["batch_stats"]}, x_, True,
                              mutable=["batch_stats"])
            return jnp.sum(y * jnp.asarray(cot)), (y, upd["batch_stats"])

        (_, (yj, stats_j)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            v["params"], jnp.asarray(x))
        tb = tblocks.ResidualBlock(8, fused_segments=True, **kw)
        tb.load_state_dict(params_from_flax(v["params"], v["batch_stats"]), strict=True)
        assert bool(tb._segments) == fusable
        xt = _nchw(x).requires_grad_()
        y = tb(xt, train=True)
        y.backward(_nchw(cot))
        np.testing.assert_allclose(_nhwc(y), np.asarray(yj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), rtol=1e-4, atol=1e-4)
        got = dict(tb.named_parameters())
        for k, want in params_from_flax(jax.device_get(gp)).items():
            np.testing.assert_allclose(got[k].grad.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        sd = tb.state_dict()
        for k, want in params_from_flax({}, jax.device_get(stats_j)).items():
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)

    def test_segments_run_in_training_only(self, monkeypatch):
        """Training calls one segment per [d] b a run; eval calls none (it
        is BatchNorm on the running statistics, then the activation)."""
        calls = []
        real = tblocks.dropout_bn_act
        monkeypatch.setattr(tblocks, "dropout_bn_act",
                            lambda *a, **k: calls.append(k["rate"]) or real(*a, **k))
        tb = tblocks.ResidualBlock(8, "bacdbacd", dropout_rate=0.3, fused_segments=True)
        tb.Dropout_0.key.seed = 4
        x = torch.randn(2, 8, 4, 4)
        tb(x, train=True)
        assert calls == [0.0, 0.3]       # "ba", then "dba" with Dropout_0's rate
        tb.eval()
        y = tb(x, train=False)
        tb.fused_segments = False
        assert calls == [0.0, 0.3] and torch.equal(y, tb(x, train=False))


class TestSubsampledBatchNorm:
    @pytest.mark.parametrize("n", [8, 40], ids=["leading-8-of-16", "more-than-B"])
    def test_matches_lvae_tpu(self, n):
        """Forward, the moved statistics and the gradients of lvae_tpu's
        SubsampledBatchNorm (blocks.py:209-290) in training."""
        rng = np.random.default_rng(9)
        x = (rng.normal(size=(16, 4, 4, 6)) * 2 + 1).astype(np.float32)
        cot = rng.normal(size=x.shape).astype(np.float32)
        jm = jblocks.SubsampledBatchNorm(channels=6, stat_samples=n)
        v = _perturbed(jm.init(jax.random.key(0), jnp.asarray(x), False), rng)

        def loss(params, x_):
            y, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x_, False,
                              mutable=["batch_stats"])
            return jnp.sum(y * jnp.asarray(cot)), (y, upd["batch_stats"])

        (_, (yj, sj)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            v["params"], jnp.asarray(x))
        bn = torch.nn.BatchNorm2d(6)
        bn.load_state_dict(dict(params_from_flax(v["params"], v["batch_stats"]),
                                num_batches_tracked=torch.tensor(0)))
        xt = _nchw(x).requires_grad_()
        y = tblocks.subsampled_batch_norm_train(bn, xt, n)
        y.backward(_nchw(cot))
        np.testing.assert_allclose(_nhwc(y), np.asarray(yj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(sj["mean"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(sj["var"]), rtol=1e-5,
                                   atol=1e-6)
        if n < x.shape[0]:   # rows past the slice reach no statistic
            assert np.abs(np.asarray(gx)[n:]).max() > 0


# ---------------------------------------------------------------------------
# the whole model, the converter and the CLI
# ---------------------------------------------------------------------------

CFG = dict(
    z_dims=(3, 3), blocks_per_layer=1, n_filters=8, stochastic_skip=True,
    gated=True, downsample=(1, 1), learn_top_prior=True, img_size=(16, 16),
    data_size=(14, 14),
)
RTOL, ATOL = 3e-6, 2e-3   # tests/test_torch_model.py's (tests/test_parity.py:151-155)


def _jax_train_forward(m, x, eps):
    td, info = m.topdown_pass(m.bottomup_pass(pad_img_tensor(x, m.img_size), train=True),
                              train=True, forced_eps=eps)
    ll, lik = m.likelihood_head(crop_img_tensor(td, m.data_size), x)
    return {"ll": ll.sum(axis=(1, 2, 3)),
            "kl_sep": jnp.stack([k.sum(axis=(1, 2, 3)) for k in info["kl_elementwise"]]),
            "out_mean": lik["mean"]}


@functools.lru_cache(maxsize=None)
def _model_pair():
    rng = np.random.default_rng(10)
    x = (rng.uniform(size=(8, 14, 14, 1)) < 0.4).astype(np.float32)
    jm = JaxLVAE(color_ch=1, dropout_rate=0.0, fused_segments=True, **CFG)
    v = _perturbed(jm.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                           jnp.asarray(x), train=True), rng)
    return jm, v, x


class TestLadderVAE:
    def test_train_forward_matches_lvae_tpu(self):
        """The whole model in training with fused segments against
        lvae_tpu's fused_segments=True, dropout 0, the same eps."""
        jm, v, x = _model_pair()
        rng = np.random.default_rng(11)
        eps = [rng.normal(size=(8, 4, 4, 3)).astype(np.float32),
               rng.normal(size=(8, 2, 2, 3)).astype(np.float32)]
        oj, _ = jm.apply(v, jnp.asarray(x), [jnp.asarray(e) for e in eps],
                         method=_jax_train_forward, mutable=["batch_stats"])
        tm = LadderVAE(color_ch=1, dropout_rate=0.0, fused_segments=True, **CFG)
        tm.load_state_dict(params_from_flax(v["params"], v["batch_stats"]), strict=True)
        with torch.no_grad():
            ot = tm(torch.from_numpy(x), forced_eps=[torch.from_numpy(e) for e in eps],
                    train=True)
        for k in ("ll", "kl_sep", "out_mean"):
            np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        assert np.abs(ot["ll"].numpy()).max() > 1.0

    def test_one_flax_tree_loads_fused_and_unfused(self):
        """The segments read BatchNorm_n in place: one flax tree gives
        identical state_dicts with and without fused segments."""
        _, v, _ = _model_pair()
        sd = params_from_flax(v["params"], v["batch_stats"])
        a = LadderVAE(color_ch=1, fused_segments=True, **CFG)
        b = LadderVAE(color_ch=1, **CFG)
        for m in (a, b):
            m.load_state_dict(sd, strict=True)
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


TINY = ["--dataset", "synthetic", "--zdims", "3", "3", "--blocks-per-layer", "1",
        "--n-filters", "8", "--skip", "--gated", "--learn-top-prior", "--batch-size", "16",
        "--test-batch-size", "64", "--seed", "5", "--device", "cpu", "--log-interval", "2",
        "--test-interval", "100", "--checkpoint-interval", "2"]


@pytest.fixture
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("_one_torch_thread")
class TestCLI:
    def test_fused_all_resumes_exactly_and_converts(self, tmp_path):
        """--fused all on the CPU (plain K5): four steps in one run equal two
        and an --auto-resume to four (the masks are keyed by the step); the
        checkpoint converts strictly through lvae_tpu's reader."""
        from lvae_tpu.train.convert import torch_state_dict_to_flax
        from lvae_tpu_torch.main import main

        def run(out, steps, *extra):
            return main(TINY + ["--fused", "all", "--dropout", "0.2", "--output-dir",
                                str(out), "--run-name", "r", "--max-steps", str(steps),
                                *extra])

        whole = run(tmp_path / "a", 4)
        assert all(tb.fused_segments for tb in whole.state.model.modules()
                   if isinstance(tb, tblocks.ResidualBlock))
        run(tmp_path / "b", 2)
        resumed = run(tmp_path / "b", 4, "--auto-resume")
        for k, t in whole.state.model.state_dict().items():
            assert torch.equal(t, resumed.state.model.state_dict()[k]), k

        ckpt = torch.load(os.path.join(whole.run_dir, "checkpoints", "ckpt_00000004.pt"),
                          weights_only=True)
        jm = JaxLVAE(color_ch=1, fused_segments=True, z_dims=(3, 3), blocks_per_layer=1,
                     n_filters=8, stochastic_skip=True, gated=True, downsample=(1, 1),
                     learn_top_prior=True, img_size=(32, 32), data_size=(28, 28))
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(0), "sample": jax.random.key(1)},
            jnp.zeros((2, 28, 28, 1)), train=True))
        params, stats = torch_state_dict_to_flax(shapes["params"], shapes["batch_stats"],
                                                 ckpt["model"], strict=True)
        assert len(flatten_dict(params)) == len(flatten_dict(shapes["params"]))
        assert all(np.isfinite(a).all() for a in flatten_dict(stats).values())

    def test_bn_stat_samples_trains(self, tmp_path):
        """--bn-stat-samples 8 of batch 16 through the training CLI: the
        run is named for it and its metrics are finite."""
        from lvae_tpu_torch.main import main

        tr = main(TINY + ["--bn-stat-samples", "8", "--max-steps", "2", "--dry-run",
                          "--output-dir", str(tmp_path)])
        assert tr.state.step == 2 and ",bnss8," in os.path.basename(tr.run_dir)
        hist = [m for kind, _, m in tr.logger.history if kind == "train"]
        assert hist and all(np.isfinite(float(m["loss"])) for m in hist)
        with pytest.raises(ValueError, match="--bn-stat-samples"):
            main(TINY + ["--bn-stat-samples", "17", "--dry-run", "--output-dir",
                         str(tmp_path)])
