"""The port's Ladder VAE against ``lvae_tpu.models.lvae.LadderVAE`` with
``train=False``: the same weights (through ``flax_to_torch_state_dict``),
the same inputs and the same per-layer eps from numpy, in both padding /
skip-merge conventions, at the tolerances of ``tests/test_parity.py``."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from lvae_tpu.models import blocks as jblocks
from lvae_tpu.models.lvae import LadderVAE as JaxLVAE
from lvae_tpu.ops.math import crop_img_tensor, pad_img_tensor
from lvae_tpu.train.convert import flax_to_torch_state_dict
from lvae_tpu_torch.models import blocks as tblocks
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.models.stochastic import Noise, NormalStochasticBlock
from lvae_tpu_torch.train.convert import params_from_flax

CFG = dict(
    z_dims=(3, 3), blocks_per_layer=1, n_filters=8, stochastic_skip=True,
    gated=True, downsample=(1, 1), learn_top_prior=True, img_size=(16, 16),
    data_size=(14, 14),
)
CONVENTIONS = [
    pytest.param(dict(conv_pad="same", skip_merge_mode="pre"), id="same-pre"),
    pytest.param(dict(conv_pad="torch", skip_merge_mode="post"), id="torch-post"),
]
RTOL, ATOL = 3e-6, 2e-3   # tests/test_parity.py:151-155 (nats)


def _perturbed(variables, rng):
    """Weights and running stats moved off their init (BN stats away from
    0/1) so every term is exercised."""
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.1,
        variables["params"],
    )
    stats = {}
    for k, a in flatten_dict(variables["batch_stats"]).items():
        a = np.asarray(a)
        stats[k] = (a + rng.normal(size=a.shape).astype(np.float32) * 0.1
                    if k[-1] == "mean"
                    else a * rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32))
    return {"params": params, "batch_stats": unflatten_dict(stats)}


@functools.lru_cache(maxsize=None)
def _pair(seed, batch, fused, conv_pad, skip_merge_mode):
    return _make_pair(seed, batch, fused, conv_pad=conv_pad,
                      skip_merge_mode=skip_merge_mode)


def make_pair(seed=0, batch=4, fused=False, conv_pad="same", skip_merge_mode="pre"):
    """(jax model, its variables, the port model with the same weights,
    a binary NHWC batch); built once per argument set (no test changes
    them)."""
    return _pair(seed, batch, fused, conv_pad, skip_merge_mode)


def _make_pair(seed, batch, fused, **conv):
    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=(batch, 14, 14, 1)) < 0.4).astype(np.float32)
    jm = JaxLVAE(color_ch=1, dropout_rate=0.0, **CFG, **conv)
    v = jm.init({"params": jax.random.key(seed), "sample": jax.random.key(1)},
                jnp.asarray(x), train=True)
    v = _perturbed(v, rng)
    tm = LadderVAE(color_ch=1, fused_stochastic=fused, **CFG, **conv)
    sd = flax_to_torch_state_dict(v["params"], v["batch_stats"])
    tm.load_state_dict({k: torch.from_numpy(np.asarray(a)) for k, a in sd.items()},
                       strict=True)
    return jm, v, tm, x


def latent_shapes(jm, v, x):
    out = jm.apply(v, jnp.asarray(x), train=False, rngs={"sample": jax.random.key(0)})
    return [z.shape for z in out["z"]]


def _jax_forced(m, x, eps):
    xp = pad_img_tensor(x, m.img_size)
    td, info = m.topdown_pass(m.bottomup_pass(xp, train=False), train=False,
                              forced_eps=eps)
    ll, lik = m.likelihood_head(crop_img_tensor(td, m.data_size), x)
    return {
        "ll": ll.sum(axis=(1, 2, 3)),
        "kl_sep": jnp.stack([k.sum(axis=(1, 2, 3)) for k in info["kl_elementwise"]]),
        "kl_spatial": [k.sum(axis=-1) for k in info["kl_elementwise"]],
        "out_mean": lik["mean"],
        "z": info["z"],
    }


class TestWholeSlice:
    @pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
    @pytest.mark.parametrize("conv", CONVENTIONS)
    def test_forward_matches_with_shared_eps(self, conv, fused):
        jm, v, tm, x = make_pair(fused=fused, **conv)
        rng = np.random.default_rng(7)
        eps = [rng.normal(size=s).astype(np.float32) for s in latent_shapes(jm, v, x)]
        oj = jm.apply(v, jnp.asarray(x), [jnp.asarray(e) for e in eps],
                      method=_jax_forced)
        with torch.no_grad():
            ot = tm(torch.from_numpy(x), forced_eps=[torch.from_numpy(e) for e in eps])
        for k in ("ll", "kl_sep", "out_mean"):
            np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        for a, b in zip(ot["kl_spatial"], oj["kl_spatial"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
        for a, b in zip(ot["z"], oj["z"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-5)
        assert np.abs(ot["ll"].numpy()).max() > 1.0
        assert ot["kl_sep"].numpy().max() > 1e-3

    @pytest.mark.parametrize("conv", CONVENTIONS)
    def test_generation_topdown_pass(self, conv):
        jm, v, tm, _ = make_pair(seed=2, **conv)
        rng = np.random.default_rng(3)
        shapes = [(5, 4, 4, 3), (5, 2, 2, 3)]
        eps = [rng.normal(size=s).astype(np.float32) for s in shapes]
        tdj, infoj = jm.apply(v, None, n_img_prior=5,
                              forced_eps=[jnp.asarray(e) for e in eps],
                              method="topdown_pass")
        with torch.no_grad():
            tdt, infot = tm.topdown_pass(None, n_img_prior=5,
                                         forced_eps=[torch.from_numpy(e) for e in eps])
        np.testing.assert_allclose(tdt.numpy(), np.asarray(tdj), rtol=RTOL, atol=1e-4)
        for a, b in zip(infot["z"], infoj["z"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-5)
        assert infot["q_params"] == [None, None]

    def test_keyed_samples_are_batch_invariant(self):
        _, _, tm, x = make_pair(batch=6, fused=True)
        index = torch.tensor([4, 8, 15, 16, 23, 42])
        with torch.no_grad():
            whole = tm(torch.from_numpy(x), noise=Noise(5, index))
            perm = torch.tensor([5, 3, 1, 0, 2, 4])
            permuted = tm(torch.from_numpy(x)[perm], noise=Noise(5, index[perm]))
            half = tm(torch.from_numpy(x)[3:], noise=Noise(5, index[3:]))
        np.testing.assert_allclose(whole["ll"][perm].numpy(), permuted["ll"].numpy(),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(whole["kl_sep"][:, 3:].numpy(),
                                   half["kl_sep"].numpy(), rtol=1e-5, atol=1e-4)

    def test_sample_prior_hooks(self):
        _, _, tm, _ = make_pair()
        with torch.no_grad():
            a = tm.sample_prior(4, seed=1)
            b = tm.sample_prior(4, seed=1)
            c = tm.sample_prior(4, seed=2)
            mode = tm.sample_prior(4, seed=1, mode_layers=(0, 1))
            t0 = tm.sample_prior(4, seed=9, temperature=[0.0, 0.0])
            const = tm.sample_prior(4, seed=1, constant_layers=(1,))
        assert a["out_mean"].shape == (4, 14, 14, 1)
        np.testing.assert_array_equal(a["out_mean"].numpy(), b["out_mean"].numpy())
        assert (a["out_mean"] - c["out_mean"]).abs().max() > 0
        np.testing.assert_allclose(t0["out_mean"].numpy(), mode["out_mean"].numpy(),
                                   rtol=1e-6, atol=1e-7)
        zc = const["z"][1]
        assert (zc - zc[:1]).abs().max() == 0


class TestBlocks:
    @pytest.mark.parametrize("mode", ["bottom-up", "top-down"])
    @pytest.mark.parametrize("resample_mode", ["conv", "interpolate"])
    @pytest.mark.parametrize("conv_pad", ["same", "torch"])
    def test_resampling_block(self, rng, mode, resample_mode, conv_pad):
        x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        jb = jblocks.ResBlockWithResampling(
            mode=mode, channels=6, resample=True, resample_mode=resample_mode,
            gated=True, conv_pad=conv_pad, block_type="cabdcabd", nonlin="gelu",
        )
        v = jb.init(jax.random.key(0), jnp.asarray(x), False)
        v = _perturbed(v, rng)
        yj = np.asarray(jb.apply(v, jnp.asarray(x), False))
        tb = tblocks.ResBlockWithResampling(
            mode, 4, 6, resample=True, resample_mode=resample_mode, gated=True,
            conv_pad=conv_pad, block_type="cabdcabd", nonlin="gelu",
        )
        sd = params_from_flax(v["params"], v["batch_stats"])
        tb.load_state_dict(sd, strict=True)
        with torch.no_grad():
            yt = tb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)

    def test_linear_merge_and_conv_padding(self, rng):
        a, b = (rng.standard_normal((2, 4, 4, 5)).astype(np.float32) for _ in range(2))
        jm = jblocks.MergeLayer(channels=5, merge_type="linear")
        v = jm.init(jax.random.key(1), jnp.asarray(a), jnp.asarray(b))
        tm = tblocks.MergeLayer(5, merge_type="linear")
        tm.load_state_dict(params_from_flax(v["params"]), strict=True)
        with torch.no_grad():
            yt = tm(*(torch.from_numpy(t).permute(0, 3, 1, 2) for t in (a, b)))
        yj = jm.apply(v, jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(yt.permute(0, 2, 3, 1).numpy(), np.asarray(yj),
                                   rtol=1e-5, atol=1e-6)
        # flax SAME at stride 2: 5x5 on 32 pads (1, 2), 3x3 on 16 pads (0, 1)
        assert tblocks.conv_padding("same", 5, 2, (32, 32)) == (1, 2, 1, 2)
        assert tblocks.conv_padding("same", 3, 2, (16, 16)) == (0, 1, 0, 1)
        assert tblocks.conv_padding("torch", 3, 2, (16, 16)) == (1, 1, 1, 1)

    def test_unknown_names_raise(self):
        with pytest.raises(ValueError, match="nonlinearity"):
            tblocks.get_nonlin("tanhh")
        with pytest.raises(ValueError, match="block_type"):
            tblocks.ResidualBlock(4, block_type="bax")


class TestGuards:
    def test_fused_train_branch_names_later_pr(self):
        blk = NormalStochasticBlock(4, 2, 4, fused=True)
        x = torch.zeros(1, 4, 2, 2)
        with pytest.raises(NotImplementedError, match="training"):
            blk(x, x, noise=Noise(0, torch.zeros(1, dtype=torch.int64)), train=True)

    def test_train_mode_raises(self):
        tm = LadderVAE(color_ch=1, **CFG)
        with pytest.raises(NotImplementedError):
            tm(torch.zeros(1, 14, 14, 1), train=True)

    def test_sampling_needs_noise(self):
        tm = LadderVAE(color_ch=1, **CFG)
        with pytest.raises(ValueError, match="noise"):
            tm(torch.zeros(1, 14, 14, 1))

    def test_scales_guard(self):
        with pytest.raises(ValueError, match="blocks_per_layer"):
            LadderVAE(color_ch=1, z_dims=(2, 2), downsample=(2, 1), blocks_per_layer=1)
        with pytest.raises(ValueError, match="divisible"):
            LadderVAE(color_ch=1, z_dims=(2,), downsample=(1,), img_size=(6, 6),
                      data_size=(6, 6))

    def test_other_heads_name_later_pr(self):
        with pytest.raises(NotImplementedError, match="mixture"):
            LadderVAE(color_ch=3, likelihood="discretized_logistic_mix", **CFG)

    def test_init_is_seeded_by_its_generator(self):
        a = LadderVAE(color_ch=1, generator=torch.Generator().manual_seed(3), **CFG)
        b = LadderVAE(color_ch=1, generator=torch.Generator().manual_seed(3), **CFG)
        c = LadderVAE(color_ch=1, generator=torch.Generator().manual_seed(4), **CFG)
        wa, wb, wc = (m.first_conv.weight for m in (a, b, c))
        assert torch.equal(wa, wb) and not torch.equal(wa, wc)
        head = a.top_down_layers_0.stochastic.conv_in_q.weight
        assert 0.005 < head.std().item() < 0.02   # normal(1e-2) heads


class TestConverter:
    @pytest.mark.parametrize("conv", CONVENTIONS)
    def test_params_from_flax_bit_exact(self, conv):
        jm, v, tm, _ = make_pair(**conv)
        ref = flax_to_torch_state_dict(v["params"], v["batch_stats"])
        got = params_from_flax(v["params"], v["batch_stats"])
        assert set(got) == set(ref) == set(tm.state_dict())
        for k, a in ref.items():
            assert got[k].dtype == torch.from_numpy(np.asarray(a)).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(a), err_msg=k)
        tm.load_state_dict(got, strict=True)

    def test_state_dict_names_follow_flax(self):
        tm = LadderVAE(color_ch=1, z_dims=(4, 4, 4), blocks_per_layer=2,
                       n_filters=8, stochastic_skip=True, gated=True,
                       learn_top_prior=True)
        keys = set(tm.state_dict())
        for k in ("top_down_layers_2.stochastic.conv_in_q.weight",
                  "bottom_up_layers_0_1.ResidualBlock_0.BatchNorm_0.running_mean",
                  "top_down_layers_2.top_prior",
                  "final_blocks_0.ConvTranspose_0.weight",
                  "likelihood_head.param_conv.bias"):
            assert k in keys, k
        assert tm.top_down_layers_2.top_prior.shape == (1, 8, 2, 2)
        assert not any(k.startswith("top_down_layers_2.merge") for k in keys)

    def test_export_tool_file_loads_strictly(self, tmp_path):
        """The .pt tools/export_torch_checkpoint.py writes: the converted
        state dict as torch tensors, torch.save'd."""
        from lvae_tpu_torch.train.convert import load_state_dict_file

        jm, v, tm, _ = make_pair(seed=5)
        sd = flax_to_torch_state_dict(v["params"], v["batch_stats"])
        path = tmp_path / "ref_model.pt"
        torch.save({k: torch.from_numpy(np.asarray(a).copy()) for k, a in sd.items()}, path)
        fresh = LadderVAE(color_ch=1, **CFG)
        fresh.load_state_dict(load_state_dict_file(str(path)), strict=True)
        for k, t in fresh.state_dict().items():
            assert torch.equal(t, tm.state_dict()[k]), k
