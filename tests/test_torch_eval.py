"""The port's eval path on the CPU: IW-LL against ``lvae_tpu``'s streaming
accumulator, invariance to chunking and batch order, the serving
surfaces, the evaluate CLI, and the package's independence from jax."""

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lvae_tpu.eval.iwll import (
    streaming_logsumexp_final,
    streaming_logsumexp_init,
    streaming_logsumexp_update,
)
from lvae_tpu_torch import serving
from lvae_tpu_torch.data.registry import load_test_set
from lvae_tpu_torch.eval.iwll import iwll_batch
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.train.state import evaluate_elbo, per_image_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(z_dims=(3, 3), blocks_per_layer=1, n_filters=8, stochastic_skip=True,
           gated=True, downsample=(1, 1), learn_top_prior=True,
           img_size=(16, 16), data_size=(14, 14))


def _model(fused=True, seed=0):
    m = LadderVAE(color_ch=1, fused_stochastic=fused,
                  generator=torch.Generator().manual_seed(seed), **CFG)
    with torch.no_grad():  # running stats away from 0/1
        g = torch.Generator().manual_seed(seed + 1)
        for name, buf in m.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    return m


def _batch(n=6, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.uniform(size=(n, 14, 14, 1)) < 0.4).astype(np.float32))
    return x, torch.from_numpy(rng.permutation(1000)[:n].astype(np.int64))


class TestIWLL:
    K = 5

    def test_matches_lvae_tpu_streaming_accumulator(self):
        model = _model()
        x, index = _batch()
        with torch.no_grad():
            elbos = []
            for j in range(self.K):
                ll, kl_sep = per_image_forward(model, x, index, 3, j)
                elbos.append((ll - kl_sep.sum(0)).numpy())
        carry = streaming_logsumexp_init(x.shape[0])
        for e in elbos:
            carry = streaming_logsumexp_update(carry, jnp.asarray(e))
        ref = np.asarray(streaming_logsumexp_final(carry)) - math.log(self.K)
        for impl in ("kernel", "streaming"):
            got = iwll_batch(model, x, index, 3, self.K, impl).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5, err_msg=impl)

    @pytest.mark.parametrize("chunk", [2, 3, 5])
    def test_chunk_invariant(self, chunk):
        model = _model()
        x, index = _batch()
        ref = iwll_batch(model, x, index, 1, self.K, "kernel", chunk=1)
        got = iwll_batch(model, x, index, 1, self.K, "kernel", chunk=chunk)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-4)

    def test_batch_order_invariant(self):
        model = _model()
        x, index = _batch()
        perm = torch.tensor([3, 0, 5, 1, 4, 2])
        a = iwll_batch(model, x, index, 1, self.K)
        b = iwll_batch(model, x[perm], index[perm], 1, self.K)
        np.testing.assert_allclose(a[perm].numpy(), b.numpy(), rtol=1e-5, atol=1e-4)

    def test_rejects_bad_options(self):
        model = _model()
        x, index = _batch(2)
        with pytest.raises(ValueError):
            iwll_batch(model, x, index, 0, 2, "pallas")
        with pytest.raises(ValueError):
            iwll_batch(model, x, index, 0, 2, chunk=0)


class TestTestELBO:
    def test_fused_and_plain_agree_per_image(self):
        x, index = _batch()
        with torch.no_grad():
            a = per_image_forward(_model(fused=True), x, index, 4)
            b = per_image_forward(_model(fused=False), x, index, 4)
        np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=0, atol=1e-3)
        np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), rtol=0, atol=1e-3)

    def test_batch_size_invariant(self):
        model = LadderVAE(color_ch=1, fused_stochastic=True, z_dims=(3, 3),
                          downsample=(1, 1), blocks_per_layer=1, n_filters=8)
        test = torch.from_numpy(load_test_set("synthetic").test[:40])
        a = evaluate_elbo(model, test, "none", 40, 784, seed=2)
        b = evaluate_elbo(model, test, "none", 7, 784, seed=2)
        assert a["n_images"] == b["n_images"] == 40
        for k in ("elbo", "ll", "kl"):
            assert abs(a[k] - b[k]) < 1e-4 * max(1.0, abs(a[k])), k
        np.testing.assert_allclose(a["kl_layers"], b["kl_layers"], rtol=1e-4, atol=1e-4)


class TestServing:
    def test_surfaces(self):
        model = _model()
        rng = np.random.default_rng(1)
        x_u8 = torch.from_numpy((rng.uniform(size=(4, 14, 14, 1)) < 0.5).astype(np.uint8))
        index = torch.tensor([7, 3, 9, 1])
        r = serving.reconstruct(model, x_u8, 5, index)
        assert r["out_mean"].shape == (4, 14, 14, 1)
        np.testing.assert_allclose(r["elbo"].numpy(), (r["ll"] - r["kl"]).numpy())
        np.testing.assert_allclose(r["bpd"].numpy(),
                                   (-r["elbo"] / (196 * math.log(2))).numpy(), rtol=1e-6)
        perm = torch.tensor([2, 0, 3, 1])
        rp = serving.reconstruct(model, x_u8[perm], 5, index[perm])
        np.testing.assert_allclose(r["elbo"][perm].numpy(), rp["elbo"].numpy(),
                                   rtol=1e-5, atol=1e-4)
        e = serving.encode(model, x_u8, 5, index)
        assert [m.shape for m in e["mu"]] == [(4, 4, 4, 3), (4, 2, 2, 3)]
        assert [z.shape for z in e["z"]] == [(4, 4, 4, 3), (4, 2, 2, 3)]
        e2 = serving.encode(model, x_u8, 6, index)
        np.testing.assert_array_equal(e["mu"][1].numpy(), e2["mu"][1].numpy())
        g = serving.generate(model, 3, seed=0, temperature=0.5)
        assert g.shape == (3, 14, 14, 1) and torch.isfinite(g).all()

    def test_rgb_surfaces_dequantize(self):
        """An RGB mixture-head model: reconstruct dequantizes as the test
        sweep does, its ELBO is the sweep's per-image ELBO and its bpd is
        over H x W x C; generate gives mixture means in [0, 1]."""
        from lvae_tpu_torch.data.device import eval_preprocess_batch

        model = LadderVAE(color_ch=3, likelihood="discretized_logistic_mix",
                          fused_mixture=True, generator=torch.Generator().manual_seed(2),
                          **dict(CFG, data_size=(16, 16)))
        rng = np.random.default_rng(3)
        x_u8 = torch.from_numpy(rng.integers(0, 256, size=(3, 16, 16, 3), dtype=np.uint8))
        index = torch.tensor([5, 0, 2])
        r = serving.reconstruct(model, x_u8, 4, index, preprocess="dequantize")
        with torch.no_grad():
            ll, kl_sep = per_image_forward(
                model, eval_preprocess_batch(x_u8, "dequantize", index), index, 4)
        np.testing.assert_allclose(r["elbo"].numpy(), (ll - kl_sep.sum(0)).numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(r["bpd"].numpy(),
                                   (-r["elbo"] / (768 * math.log(2))).numpy(), rtol=1e-6)
        assert r["out_mean"].shape == (3, 16, 16, 3)
        g = serving.generate(model, 2, seed=1)
        assert g.shape == (2, 16, 16, 3) and bool(((g >= 0) & (g <= 1)).all())

    def test_rejects_bad_inputs(self):
        model = _model()
        with pytest.raises(ValueError):
            serving.reconstruct(model, torch.zeros(2, 14, 14, 1), 0, torch.arange(2))
        with pytest.raises(ValueError):
            serving.encode(model, torch.zeros(2, 14, 14, 1, dtype=torch.uint8), 0,
                           torch.arange(3))


def _run_dir(tmp_path, **overrides):
    cfg = {
        "dataset": "synthetic", "zdims": [3, 3], "downsample": [1, 1],
        "blocks_per_layer": 1, "n_filters": 8, "skip": True, "gated": True,
        "learn_top_prior": True, "test_batch_size": 50, "batch_size": 64,
        "lr": 3e-4, "fused": "auto", "rng_impl": "rbg",
    }
    cfg.update(overrides)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    model = LadderVAE(color_ch=1, z_dims=(3, 3), downsample=(1, 1),
                      blocks_per_layer=1, n_filters=8, stochastic_skip=True,
                      gated=True, learn_top_prior=True)
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    return ["--load", str(tmp_path), "--state-dict", str(tmp_path / "weights.pt")]


class TestEvaluateCLI:
    def test_cpu_end_to_end(self, tmp_path, capsys):
        from lvae_tpu_torch.evaluate import main

        args = _run_dir(tmp_path, num_data_shards=4)
        out = main(args + ["--device", "cpu", "--ll", "--iw-samples", "3",
                           "--iw-chunk", "2", "--iw-max-batches", "1"])
        text = capsys.readouterr().out
        assert "note: run was trained on a 4x1" in text
        assert "test elbo" in text and "kl/layer_1" in text
        assert "IW log-likelihood (3 samples, 50 images, chunk 2, streaming)" in text
        assert out["elbo"]["n_images"] == 128
        assert out["iw"]["n_images"] == 50
        assert np.isfinite(out["elbo"]["elbo"]) and np.isfinite(out["iw"]["iw_ll"])

    def test_cuda_without_a_card_raises(self, tmp_path):
        from lvae_tpu_torch.evaluate import main

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible here")
        with pytest.raises(SystemExit, match="--device cuda"):
            main(_run_dir(tmp_path))

    def test_bf16_trained_run_scored_with_precision_fp32(self, tmp_path, capsys):
        """A run whose config.json holds "precision": "bf16" is scored in
        bf16 without the flag (as lvae_tpu's evaluate.py scores it in its
        stored dtype), and with --precision fp32 to the bit of the same
        weights under a stored "fp32"."""
        from lvae_tpu_torch.evaluate import main

        args = _run_dir(tmp_path, precision="bf16") + ["--device", "cpu"]
        in_bf16 = main(args)["elbo"]
        assert "(bf16)" in capsys.readouterr().out
        assert main(args + ["--precision", "bf16"])["elbo"]["elbo"] == in_bf16["elbo"]
        scored = main(args + ["--precision", "fp32"])["elbo"]
        cfg = json.loads((tmp_path / "config.json").read_text())
        (tmp_path / "config.json").write_text(json.dumps({**cfg, "precision": "fp32"}))
        stored = main(args)["elbo"]
        assert scored["n_images"] == stored["n_images"] == in_bf16["n_images"] == 128
        assert np.isfinite(scored["elbo"]) and np.isfinite(in_bf16["elbo"])
        for key in ("elbo", "ll", "kl", "bpd"):
            assert scored[key] == stored[key], key
        np.testing.assert_array_equal(scored["kl_layers"], stored["kl_layers"])
        # bf16 convs move the ELBO, by much less than its size
        assert in_bf16["elbo"] != stored["elbo"]
        assert abs(in_bf16["elbo"] - stored["elbo"]) < 0.01 * abs(stored["elbo"])
        assert "test elbo" in capsys.readouterr().out

    def test_more_than_one_shard_rejected(self, tmp_path, monkeypatch):
        """More than one shard runs (tests/test_torch_parallel_cli.py), but
        not where the launcher's group has another size: the rank stops,
        naming the flag, before it joins a group whose ranks never come."""
        from lvae_tpu_torch.evaluate import main

        monkeypatch.setenv("WORLD_SIZE", "3")
        with pytest.raises(SystemExit, match="--num-data-shards"):
            main(_run_dir(tmp_path) + ["--device", "cpu", "--num-data-shards", "2"])


class TestNoJaxNoFallback:
    def test_package_imports_without_jax(self):
        code = (
            "import sys, pkgutil, importlib, lvae_tpu_torch\n"
            "for m in pkgutil.walk_packages(lvae_tpu_torch.__path__, 'lvae_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'lvae_tpu'))\n"
            "assert not bad, bad\n"
            "print('clean', len([k for k in sys.modules if k.startswith('lvae_tpu_torch')]))\n"
        )
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert int(res.stdout.split()[-1]) >= 20

    def test_chip_smoke_refuses_without_a_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible here")
        lone = tmp_path / "lone"
        lone.mkdir()
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
        for cwd in (REPO, str(lone)):
            res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                                 capture_output=True, text=True, timeout=120)
            assert res.returncode != 0
            assert '"ok": true' not in res.stdout
