"""The port's plain ops, noise generator, preprocessing and config, held
against ``lvae_tpu`` (CPU, small sizes, inputs from numpy seeds)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lvae_tpu.data.device import eval_preprocess_batch as j_preprocess
from lvae_tpu.ops import likelihoods as jlik
from lvae_tpu.ops import math as jmath
from lvae_tpu.ops import stochastic as jsto
from lvae_tpu_torch.config import EvalConfig, config_from_dict
from lvae_tpu_torch.data.device import eval_preprocess_batch
from lvae_tpu_torch.data.registry import load_test_set
from lvae_tpu_torch.ops import likelihoods as tlik
from lvae_tpu_torch.ops import math as tmath
from lvae_tpu_torch.ops import stochastic as tsto
from lvae_tpu_torch.ops.philox import keyed_normal, keyed_uniform, philox4x32

RTOL = 1e-6  # fp32 elementwise math in both frameworks


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


class TestShapeOps:
    @pytest.mark.parametrize("size", [(32, 32), (31, 33), (14, 14)])
    def test_pad_crop_match(self, rng, size):
        x = rng.standard_normal((2, 14, 14, 3)).astype(np.float32)
        pj = np.asarray(jmath.pad_img_tensor(jnp.asarray(x), size))
        pt = tmath.pad_img_tensor(torch.from_numpy(x), size).numpy()
        np.testing.assert_array_equal(pj, pt)
        cj = np.asarray(jmath.crop_img_tensor(jnp.asarray(pj), (14, 14)))
        ct = tmath.crop_img_tensor(torch.from_numpy(pt), (14, 14)).numpy()
        np.testing.assert_array_equal(cj, ct)
        np.testing.assert_array_equal(ct, x)

    def test_pad_crop_reject_wrong_direction(self):
        x = torch.zeros(1, 8, 8, 1)
        with pytest.raises(ValueError):
            tmath.pad_img_tensor(x, (4, 4))
        with pytest.raises(ValueError):
            tmath.crop_img_tensor(x, (9, 9))


class TestStochasticOps:
    def _params(self, rng, shape=(3, 4, 5, 6)):
        return [rng.standard_normal(shape).astype(np.float32) * s
                for s in (1.0, 0.5, 1.0, 0.5)]

    def test_split_params_is_a_channel_view(self, rng):
        p = rng.standard_normal((2, 3, 3, 8)).astype(np.float32)
        mj, lj = jsto.split_params(jnp.asarray(p))
        pt = _nchw(p)
        mt, lt = tsto.split_params(pt)
        assert mt.data_ptr() == pt.data_ptr()  # no copy
        np.testing.assert_array_equal(np.asarray(mj), mt.permute(0, 2, 3, 1).numpy())
        np.testing.assert_array_equal(np.asarray(lj), lt.permute(0, 2, 3, 1).numpy())

    def test_gaussian_kl_matches(self, rng):
        a = self._params(rng)
        kj = np.asarray(jsto.gaussian_kl(*map(jnp.asarray, a)))
        kt = tsto.gaussian_kl(*map(torch.from_numpy, a)).numpy()
        np.testing.assert_allclose(kt, kj, rtol=RTOL, atol=1e-7)

    @pytest.mark.parametrize("temperature", [1.0, 0.5, 0.0])
    def test_normal_rsample_with_shared_eps(self, rng, temperature):
        mu, lv, _, _ = self._params(rng)
        index = torch.arange(mu.shape[0]) * 5 + 2
        zt = tsto.normal_rsample(torch.from_numpy(mu), torch.from_numpy(lv),
                                 7, index, 3, 1, temperature)
        eps = keyed_normal(mu.shape, 7, index, 3, 1).numpy()
        zj = jnp.asarray(mu) + temperature * jnp.exp(0.5 * jnp.asarray(lv)) * eps
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=RTOL, atol=1e-7)

    def test_bernoulli_log_prob_matches(self, rng):
        x = (rng.uniform(size=(3, 5, 5, 1)) < 0.5).astype(np.float32)
        logits = rng.standard_normal(x.shape).astype(np.float32) * 4
        lj = np.asarray(jlik.bernoulli_log_prob(jnp.asarray(x), jnp.asarray(logits)))
        lt = tlik.bernoulli_log_prob(torch.from_numpy(x), torch.from_numpy(logits))
        np.testing.assert_allclose(lt.numpy(), lj, rtol=RTOL, atol=1e-7)


class TestPhilox:
    # Random123's known-answer vectors for philox4x32-10
    KAT = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]

    @pytest.mark.parametrize("ctr,key,expected", KAT)
    def test_known_answers(self, ctr, key, expected):
        out = philox4x32(*ctr, *key)
        assert tuple(int(w) for w in out) == expected

    def test_permutation_invariant(self, rng):
        index = torch.from_numpy(rng.permutation(1000)[:64].astype(np.int64))
        perm = torch.from_numpy(rng.permutation(64))
        a = keyed_normal((64, 3, 4, 4), 11, index, 0, 2)
        b = keyed_normal((64, 3, 4, 4), 11, index[perm], 0, 2)
        np.testing.assert_array_equal(a[perm].numpy(), b.numpy())

    def test_batch_split_invariant(self):
        index = torch.arange(100, 164)
        whole = keyed_normal((64, 2, 3, 3), 5, index, 4, 0)
        parts = torch.cat([keyed_normal((16, 2, 3, 3), 5, index[i:i + 16], 4, 0)
                           for i in range(0, 64, 16)])
        np.testing.assert_array_equal(whole.numpy(), parts.numpy())

    def test_streams_are_distinct(self):
        index = torch.arange(8)
        base = keyed_normal((8, 64), 1, index, 0, 0)
        for other in (keyed_normal((8, 64), 2, index, 0, 0),     # seed
                      keyed_normal((8, 64), 1, index + 8, 0, 0),  # image
                      keyed_normal((8, 64), 1, index, 1, 0),      # sample
                      keyed_normal((8, 64), 1, index, 0, 1)):     # layer
            assert (base - other).abs().max() > 0.5

    def test_exports_with_a_symbolic_batch(self):
        """keyed_normal under torch.export with B symbolic (the serving
        artifacts' trace; the seed a 0-d tensor input): one program,
        replayed at two batch sizes, equal to the eager draws bit for bit;
        a wrong index shape still raises in eager mode."""

        class Draw(torch.nn.Module):
            def forward(self, like, seed, index):
                return keyed_normal(like.shape, seed, index, 3, 1)

        b = torch.export.Dim("b", min=1)
        like, index = torch.zeros(4, 2, 3, 3), torch.arange(4)
        ep = torch.export.export(Draw(), (like, torch.tensor(7), index),
                                 dynamic_shapes=({0: b}, None, {0: b}))
        for n in (3, 9):
            index = torch.arange(20, 20 + n)
            got = ep.module()(torch.zeros(n, 2, 3, 3), torch.tensor(7), index)
            assert torch.equal(got, keyed_normal((n, 2, 3, 3), 7, index, 3, 1))
        with pytest.raises(ValueError, match="index must be"):
            keyed_normal((4, 2, 3, 3), 7, torch.arange(5), 3, 1)

    def test_normal_moments(self):
        eps = keyed_normal((256, 1024), 3, torch.arange(256), 0, 0).double()
        assert abs(eps.mean().item()) < 0.01
        assert abs(eps.std().item() - 1.0) < 0.01
        frac = (eps.abs() < 1.0).double().mean().item()
        assert 0.677 < frac < 0.689  # P(|N| < 1) = 0.6827

    def test_uniform_range(self):
        u = keyed_uniform((64, 4096), 0, torch.arange(64), 0, 9)
        assert u.min() > 0.0 and u.max() <= 1.0
        assert abs(u.double().mean().item() - 0.5) < 0.005


class TestPreprocess:
    @pytest.mark.parametrize("mode", ["none", "dequantize"])
    def test_deterministic_modes_match(self, rng, mode):
        u8 = rng.integers(0, 256, size=(3, 6, 6, 1), dtype=np.uint8)
        xj = np.asarray(j_preprocess(jnp.asarray(u8), mode))
        xt = eval_preprocess_batch(torch.from_numpy(u8), mode).numpy()
        np.testing.assert_allclose(xt, xj, rtol=RTOL)

    def test_binarize_keyed_per_image(self, rng):
        u8 = torch.from_numpy(rng.integers(0, 256, size=(32, 28, 28, 1),
                                           dtype=np.uint8))
        index = torch.arange(500, 532)
        x = eval_preprocess_batch(u8, "binarize", index)
        assert set(np.unique(x.numpy())) <= {0.0, 1.0}
        perm = torch.from_numpy(rng.permutation(32))
        xp = eval_preprocess_batch(u8[perm], "binarize", index[perm])
        np.testing.assert_array_equal(x[perm].numpy(), xp.numpy())
        # P(x=1) = u8/255, incl. the exact ends
        ones = eval_preprocess_batch(torch.full((4, 8, 8, 1), 255, dtype=torch.uint8),
                                     "binarize", index[:4])
        zeros = eval_preprocess_batch(torch.zeros((4, 8, 8, 1), dtype=torch.uint8),
                                      "binarize", index[:4])
        assert ones.min() == 1.0 and zeros.max() == 0.0
        rate = x.mean().item()
        assert abs(rate - (u8.float() / 255).mean().item()) < 0.01


class TestConfig:
    def test_ignores_and_does_not_validate_train_fields(self):
        # an explicit --num-data-shards must not trip over the stored
        # train batch size (evaluate.py:107's fault): neither is read here
        cfg = config_from_dict({
            "zdims": [8, 8], "batch_size": 7, "num_data_shards": 2, "lr": -1.0,
            "grad_accum": 0, "optimizer_only_field": 3, "likelihood": "None",
        })
        assert cfg.zdims == (8, 8) and cfg.downsample == (1, 1)
        assert cfg.likelihood is None and not hasattr(cfg, "batch_size")

    @pytest.mark.parametrize("field,value,flag", [
        ("likelihood", "laplace", "--likelihood"),
        ("precision", "fp16", "--precision"),
        ("spatial_shards", 2, "--spatial-shards"),
        ("downsample", (1, 1), "--downsample"),
        ("blocks_per_layer", 0, "--blocks-per-layer"),
    ])
    def test_rejects_with_the_flag_named(self, field, value, flag):
        with pytest.raises(ValueError, match=flag):
            EvalConfig(**{field: value})

    @pytest.mark.parametrize("precision", ["fp32", "bf16"])
    def test_takes_both_precisions(self, precision):
        """--precision bf16 is taken (refused before the port ran it), and
        stored in the config a run directory records."""
        cfg = config_from_dict({"zdims": [8, 8], "precision": precision})
        assert cfg.precision == precision

    def test_eval_reads_bn_stat_samples_unvalidated(self):
        """A run trained with --bn-stat-samples 16 is scored: evaluation
        normalises with the running statistics whatever the value
        (lvae_tpu/models/blocks.py:270-271), so it is neither rejected nor
        checked against the stored batch size."""
        cfg = config_from_dict({"zdims": [8, 8], "bn_stat_samples": 16, "batch_size": 8})
        assert cfg.bn_stat_samples == 16

    @pytest.mark.parametrize("head", ["bernoulli", "gaussian", "discretized_logistic",
                                      "discretized_logistic_mix"])
    def test_every_head_is_accepted_and_built(self, head):
        """--likelihood takes each of lvae_tpu's four heads, and make_model
        builds it over the dataset's channels."""
        from lvae_tpu_torch.train.trainer import make_model

        cfg = EvalConfig(zdims=(2,), downsample=(1,), blocks_per_layer=1, n_filters=4,
                         likelihood=head)
        model = make_model(cfg, load_test_set("synthetic_rgb:4"), torch.device("cpu"))
        q = {"bernoulli": 3, "gaussian": 6, "discretized_logistic": 6,
             "discretized_logistic_mix": 100}[head]
        assert model.likelihood_head.param_conv.weight.shape[0] == q

    def test_synthetic_test_set_matches_lvae_tpu(self):
        from lvae_tpu.data.registry import load_dataset

        for name in ("synthetic", "synthetic:600"):
            ref = load_dataset(name).test
            got = load_test_set(name)
            np.testing.assert_array_equal(got.test, ref)
            assert got.padded_size == (32, 32) and got.data_dims == 784

    def test_static_mnist_amat_loader(self, tmp_path, rng):
        d = tmp_path / "static_mnist"
        d.mkdir()
        bits = (rng.uniform(size=(5, 784)) < 0.3).astype(np.uint8)
        np.savetxt(d / "binarized_mnist_test.amat", bits, fmt="%d")
        ts = load_test_set("static_mnist", str(tmp_path))
        assert ts.test.shape == (5, 28, 28, 1) and ts.preprocess == "none"
        np.testing.assert_array_equal(ts.test.reshape(5, 784), bits)


class TestRGBData:
    @pytest.mark.parametrize("name", ["synthetic_rgb", "synthetic_rgb:40",
                                      "synthetic_celeba", "synthetic_celeba:20"])
    def test_fixtures_match_lvae_tpu(self, name):
        """lvae_tpu's fixture rule, element for element, with its metadata."""
        from lvae_tpu.data.registry import load_dataset as j_load
        from lvae_tpu_torch.data.registry import load_dataset

        ref, got = j_load(name), load_dataset(name)
        np.testing.assert_array_equal(got.train, ref.train)
        np.testing.assert_array_equal(got.test, ref.test)
        np.testing.assert_array_equal(load_test_set(name).test, ref.test)
        for f in ("img_size", "padded_size", "color_ch", "preprocess", "default_likelihood"):
            assert getattr(got, f) == getattr(ref, f), f

    def test_registry_rows_match_lvae_tpu(self):
        from lvae_tpu.data.registry import _META as J_META
        from lvae_tpu_torch.data.registry import _META

        assert set(_META) <= set(J_META)
        assert {"cifar10", "svhn", "celeba", "synthetic_rgb", "synthetic_celeba"} <= set(_META)
        for name, row in _META.items():
            assert row == J_META[name], name
        assert load_test_set("synthetic_celeba:8").data_dims == 64 * 64 * 3

    def _compare(self, name, root, j_loader):
        from lvae_tpu_torch.data.registry import load_dataset

        train, test = j_loader(str(root))
        got = load_dataset(name, str(root))
        np.testing.assert_array_equal(got.train, train)
        np.testing.assert_array_equal(got.test, test)
        np.testing.assert_array_equal(load_test_set(name, str(root)).test, test)
        assert got.test.dtype == np.uint8 and got.test.shape[1:] == got.data_shape
        return got

    def test_cifar10_pickle_batches(self, tmp_path, rng):
        import pickle

        from lvae_tpu.data.sources import load_cifar10

        d = tmp_path / "cifar10" / "cifar-10-batches-py"
        d.mkdir(parents=True)
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            rows = rng.integers(0, 256, size=(3, 3072), dtype=np.uint8)
            with open(d / name, "wb") as f:
                pickle.dump({"data": rows, "labels": [0, 1, 2]}, f)
        got = self._compare("cifar10", tmp_path, load_cifar10)
        assert got.train.shape == (15, 32, 32, 3)
        assert got.default_likelihood == "discretized_logistic_mix"

    def test_svhn_mat_files(self, tmp_path, rng):
        from scipy.io import savemat

        from lvae_tpu.data.sources import load_svhn

        (tmp_path / "svhn").mkdir()
        for split, n in (("train", 5), ("test", 3)):
            x = rng.integers(0, 256, size=(32, 32, 3, n), dtype=np.uint8)
            savemat(tmp_path / "svhn" / f"{split}_32x32.mat", {"X": x, "y": np.ones((n, 1))})
        got = self._compare("svhn", tmp_path, load_svhn)
        assert got.train.shape == (5, 32, 32, 3)
        assert got.default_likelihood == "discretized_logistic"

    def test_celeba_npz_cache(self, tmp_path, rng):
        from lvae_tpu.data.sources import load_celeba

        (tmp_path / "celeba").mkdir()
        np.savez_compressed(tmp_path / "celeba" / "celeba_64.npz",
                            train=rng.integers(0, 256, size=(4, 64, 64, 3), dtype=np.uint8),
                            test=rng.integers(0, 256, size=(2, 64, 64, 3), dtype=np.uint8))
        got = self._compare("celeba", tmp_path, load_celeba)
        assert got.preprocess == "dequantize" and got.padded_size == (64, 64)

    def test_missing_files_and_bad_names(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="celeba_64.npz"):
            load_test_set("celeba", str(tmp_path))
        with pytest.raises(FileNotFoundError):
            load_test_set("cifar10", str(tmp_path))
        with pytest.raises(FileNotFoundError, match="multi_binary_mnist_012.npz"):
            load_test_set("multi_mnist_binary", str(tmp_path))
        with pytest.raises(ValueError, match="unknown dataset"):
            load_test_set("multi_mnist", str(tmp_path))
        with pytest.raises(ValueError, match="size"):
            load_test_set("synthetic_celeba:0")


class TestResolveFused:
    @pytest.mark.parametrize("policy,device,head,stochastic,mixture", [
        ("auto", "cuda", "discretized_logistic_mix", True, True),
        ("auto", "cuda", "bernoulli", True, False),
        ("auto", "cuda", "discretized_logistic", True, False),
        ("auto", "cpu", "discretized_logistic_mix", False, False),
        ("none", "cuda", "discretized_logistic_mix", False, False),
        ("stochastic", "cpu", "discretized_logistic_mix", True, False),
        ("mixture", "cpu", "discretized_logistic_mix", False, True),
        ("mixture", "cuda", "gaussian", False, False),
        ("pallas", "cpu", "discretized_logistic_mix", True, True),
        ("pallas", "cuda", "bernoulli", True, False),
        ("all", "cpu", "discretized_logistic_mix", True, True),
        ("segments", "cuda", "discretized_logistic_mix", False, False),
    ])
    @pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
    def test_switches(self, policy, device, head, stochastic, mixture, train):
        """Each --fused policy's kernels per head, device and mode; a head
        other than the mixture never gets K3 (lvae_tpu/train/trainer.py:
        87-97); K5 only in training, and never from auto."""
        from lvae_tpu_torch.train.trainer import resolve_fused

        assert resolve_fused(policy, torch.device(device), train, head) == {
            "fused_stochastic": stochastic, "fused_mixture": mixture,
            "fused_segments": train and policy in ("segments", "all")}

    @pytest.mark.parametrize("policy", ["segments", "all"])
    def test_training_turns_on_the_segment_kernel(self, policy):
        """--fused segments|all builds a training model whose residual
        blocks run the fused segments; its eval model does not."""
        from lvae_tpu_torch.config import TrainConfig
        from lvae_tpu_torch.models.blocks import ResidualBlock
        from lvae_tpu_torch.train.trainer import make_model

        cfg = TrainConfig(zdims=(2,), downsample=(1,), blocks_per_layer=1, n_filters=4,
                          fused=policy)
        for train in (True, False):
            model = make_model(cfg, load_test_set("synthetic"), torch.device("cpu"),
                               train=train)
            blocks = [m for m in model.modules() if isinstance(m, ResidualBlock)]
            assert blocks and all(b.fused_segments == train for b in blocks)
            assert all(b._segments for b in blocks)
