"""The port's training CLI and its training-only pieces on the CPU:
``python -m lvae_tpu_torch.main`` (run, exact resume, evaluate, the flags
it rejects), the bits8 and float dropout, and the training preprocessing.
The train step itself is held against ``lvae_tpu`` in
``test_torch_train.py``."""

import os

import numpy as np
import pytest
import torch

from lvae_tpu.ops.math import bits8_keep_threshold as j_threshold
from lvae_tpu_torch.data.device import preprocess_batch
from lvae_tpu_torch.models.blocks import Dropout
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.models.stochastic import Noise
from lvae_tpu_torch.ops.math import bits8_keep_threshold

CFG = dict(
    z_dims=(3, 3), blocks_per_layer=1, n_filters=8, stochastic_skip=True,
    gated=True, downsample=(1, 1), learn_top_prior=True, img_size=(16, 16),
    data_size=(14, 14),
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many tiny eager ops: one intra-op thread keeps them
    fast when the tier runs several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestDropout:
    @pytest.mark.parametrize("rate", [0.0, 0.001, 0.1, 0.2, 0.5, 0.999])
    def test_threshold_matches_lvae_tpu(self, rate):
        assert bits8_keep_threshold(rate) == j_threshold(rate)

    def test_bits8_rate_and_scale(self):
        d = Dropout(0.2)
        x = torch.ones(64, 16, 32, 32)
        y = d(x, train=True)
        t = bits8_keep_threshold(0.2)
        kept = (y != 0).double().mean().item()
        assert abs(kept - t / 256) < 4 * np.sqrt(t / 256 * (1 - t / 256) / x.numel())
        assert set(np.unique(y.numpy())) == {0.0, np.float32(256.0 / t)}
        assert torch.equal(d(x, train=False), x)

    def test_degenerate_thresholds(self):
        x = torch.randn(4, 3, 5, 5)
        assert torch.equal(Dropout(0.001)(x, train=True), x)       # t = 256
        assert torch.equal(Dropout(0.999)(x, train=True), torch.zeros_like(x))  # t = 0

    def test_float_impl_exact_rate(self):
        d = Dropout(0.3, "float")
        y = d(torch.ones(200_000), train=True)
        assert abs((y != 0).double().mean().item() - 0.7) < 0.005
        np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.7, rtol=1e-6)

    def test_masks_are_a_function_of_the_step(self):
        tm = LadderVAE(color_ch=1, dropout_rate=0.3, **CFG)
        x = torch.from_numpy((np.random.default_rng(0).uniform(size=(4, 14, 14, 1)) < 0.5)
                             .astype(np.float32))
        with torch.no_grad():
            a, b, c = (tm(x, noise=Noise(7, torch.arange(4), step), train=True)["ll"]
                       for step in (3, 3, 4))
        assert torch.equal(a, b) and not torch.equal(a, c)
        sites = [m.site for m in tm.modules() if isinstance(m, Dropout)]
        assert sites == list(range(len(sites))) and len(sites) > 10


class TestPreprocess:
    def test_binarize_keyed_per_step_and_image(self, rng):
        u8 = torch.from_numpy(rng.integers(0, 256, size=(16, 6, 6, 1), dtype=np.uint8))
        index = torch.arange(100, 116)
        a = preprocess_batch(u8, "binarize", 5, index, 3)
        assert torch.equal(a, preprocess_batch(u8, "binarize", 5, index, 3))
        assert not torch.equal(a, preprocess_batch(u8, "binarize", 5, index, 4))
        perm = torch.from_numpy(rng.permutation(16))
        assert torch.equal(a[perm], preprocess_batch(u8[perm], "binarize", 5, index[perm], 3))
        assert set(np.unique(a.numpy())) <= {0.0, 1.0}

    def test_dequantize_and_none(self, rng):
        u8 = torch.from_numpy(rng.integers(0, 256, size=(4, 5, 5, 1), dtype=np.uint8))
        x = preprocess_batch(u8, "dequantize", 1, torch.arange(4), 0)
        f = u8.float()
        assert bool(((x * 256 > f) & (x * 256 <= f + 1)).all())
        assert torch.equal(preprocess_batch(u8, "none", 1, torch.arange(4), 0), f)


TINY = ["--dataset", "synthetic", "--zdims", "3", "3", "--blocks-per-layer", "1",
        "--n-filters", "8", "--skip", "--gated", "--learn-top-prior",
        "--freebits", "0.5", "--beta-anneal", "4", "--batch-size", "32",
        "--test-batch-size", "64", "--seed", "5", "--device", "cpu"]


def _train(tmp_path, *extra):
    from lvae_tpu_torch.main import main

    return main(TINY + ["--output-dir", str(tmp_path), "--log-interval", "2",
                        "--test-interval", "6", "--checkpoint-interval", "3", *extra])


class TestCLI:
    def test_run_resume_and_evaluate(self, tmp_path, capsys):
        """Six steps in one run equal three, then an --auto-resume to six
        (the step's data, noise and dropout are keyed by the step); the
        checkpoint is what lvae_tpu_torch.evaluate scores."""
        from lvae_tpu_torch.evaluate import main as evaluate

        whole = _train(tmp_path / "a", "--run-name", "r", "--max-steps", "6",
                       "--data-dep-init")
        run_dir = whole.run_dir
        assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == [
            "ckpt_00000003.pt", "ckpt_00000006.pt"]
        assert os.path.exists(os.path.join(run_dir, "config.json"))
        half = _train(tmp_path / "b", "--run-name", "r", "--max-steps", "3",
                      "--data-dep-init")
        assert half.state.step == 3
        resumed = _train(tmp_path / "b", "--run-name", "r", "--max-steps", "6",
                         "--data-dep-init", "--auto-resume")
        text = capsys.readouterr().out
        assert "auto-resumed" in text and "[train] step       6" in text
        assert "[test ] step       6" in text
        a, b = whole.state, resumed.state
        assert a.step == b.step == 6
        for k, t in a.model.state_dict().items():
            assert torch.equal(t, b.model.state_dict()[k]), k
        for k in a.ema:
            assert torch.equal(a.ema[k], b.ema[k]), k
        sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
        assert all(torch.equal(sa[i]["exp_inf"], sb[i]["exp_inf"]) for i in sa)
        hist = [m for kind, _, m in whole.logger.history if kind == "train"]
        assert all(np.isfinite(float(m["loss"])) for m in hist)

        res = evaluate(["--load", run_dir, "--state-dict",
                        os.path.join(run_dir, "checkpoints", "ckpt_00000006.pt"),
                        "--device", "cpu"])
        assert np.isfinite(res["elbo"]["elbo"]) and res["elbo"]["n_images"] == 128
        test = [m for kind, _, m in whole.logger.history if kind == "test"][-1]
        assert abs(res["elbo"]["elbo"] - test["elbo"]) < 1e-3

    @pytest.mark.parametrize("flags,name", [
        (["--streaming"], "--streaming"),
        (["--spatial-shards", "2"], "--spatial-shards"),
        (["--num-data-shards", "2"], "--num-data-shards"),
        (["--rng-impl", "rbg"], "--rng-impl"),
        (["--platform", "tpu"], "--platform"),
    ])
    def test_rejects_what_the_port_does_not_run(self, tmp_path, flags, name):
        with pytest.raises(ValueError, match=name):
            _train(tmp_path, "--max-steps", "1", "--dry-run", *flags)

    @pytest.mark.parametrize("fused", ["auto", "all"])
    def test_trains_at_precision_bf16(self, tmp_path, fused):
        """--precision bf16 (refused before the port ran it): two finite
        steps with every conv computing in bf16, the parameters, the
        BatchNorm statistics and the optimiser's state fp32."""
        tr = _train(tmp_path, "--max-steps", "2", "--dry-run", "--precision", "bf16",
                    "--fused", fused)
        model = tr.state.model
        convs = [m for m in model.modules() if hasattr(m, "compute_dtype")]
        assert tr.state.step == 2 and convs
        assert all(m.compute_dtype == torch.bfloat16 for m in convs)
        assert all(t.dtype == torch.float32 for t in model.state_dict().values()
                   if t.is_floating_point())
        assert all(v.dtype == torch.float32 for st in tr.state.optimizer.state.values()
                   for v in st.values())
        assert all(np.isfinite(float(v)) for v in tr.state.ema.values() if v.dim() == 0)

    @pytest.mark.parametrize("flags", [["--fused", "segments"], ["--fused", "all"],
                                       ["--bn-stat-samples", "8"]],
                             ids=["fused-segments", "fused-all", "bn-stat-samples"])
    def test_trains_the_batchnorm_branch(self, tmp_path, flags):
        """The three values the trainer rejected before the segment kernel
        (K5) and SubsampledBatchNorm were ported: two finite steps, with
        the model's switch set."""
        tr = _train(tmp_path, "--max-steps", "2", "--dry-run", *flags)
        blocks = [m for m in tr.state.model.modules() if type(m).__name__ == "ResidualBlock"]
        assert tr.state.step == 2 and blocks
        assert all(b.fused_segments == ("--fused" in flags) for b in blocks)
        assert all(b.bn_stat_samples == (8 if "--bn-stat-samples" in flags else 0)
                   for b in blocks)
        assert all(np.isfinite(float(v)) for v in tr.state.ema.values() if v.dim() == 0)

    @pytest.mark.parametrize("k,max_steps,stop", [(2, 4, 4), (4, 4, 4), (3, 4, 6)],
                             ids=["k2", "k4", "k3-overshoots"])
    def test_trains_steps_per_call(self, tmp_path, capsys, k, max_steps, stop):
        """--steps-per-call k, which the trainer rejected before it ran k
        steps a call: the run trains to max_steps; a max_steps that is not
        a multiple of k warns and stops at the next multiple, as
        lvae_tpu's does."""
        tr = _train(tmp_path, "--max-steps", str(max_steps), "--dry-run",
                    "--steps-per-call", str(k))
        text = capsys.readouterr().out
        assert tr.state.step == stop
        warned = (f"warning: max_steps {max_steps} is not a multiple of steps-per-call "
                  f"{k}; the run will stop at step {stop}")
        assert (warned in text) == (stop != max_steps)
        assert all(np.isfinite(float(v)) for v in tr.state.ema.values() if v.dim() == 0)

    def test_trains_the_gaussian_head(self, tmp_path):
        """--likelihood overrides the dataset's head; the Gaussian head
        trains (two steps, finite metrics)."""
        tr = _train(tmp_path, "--max-steps", "2", "--dry-run", "--likelihood", "gaussian")
        assert tr.state.step == 2
        assert type(tr.state.model.likelihood_head).__name__ == "GaussianLikelihood"
        assert all(np.isfinite(float(v)) for v in tr.state.ema.values() if v.dim() == 0)

    def test_synthetic_celeba_trains_and_evaluates(self, tmp_path, capsys):
        """The celeba-shaped fixture (64x64 RGB, dequantized, the mixture
        head) through the CLI with the kernels' switch on (on the CPU,
        their plain versions): 2 steps, then lvae_tpu_torch.evaluate
        scores the checkpoint with --ll."""
        from lvae_tpu_torch.evaluate import main as evaluate
        from lvae_tpu_torch.main import main

        tr = main(["--dataset", "synthetic_celeba:64", "--zdims", "3", "3",
                   "--blocks-per-layer", "1", "--n-filters", "8", "--skip", "--gated",
                   "--learn-top-prior", "--freebits", "0.5", "--batch-size", "8",
                   "--test-batch-size", "64", "--data-dep-init", "--fused", "pallas",
                   "--max-steps", "2", "--log-interval", "1", "--test-interval", "2",
                   "--checkpoint-interval", "2", "--output-dir", str(tmp_path),
                   "--run-name", "celeba", "--device", "cpu"])
        head = tr.state.model.likelihood_head
        assert type(head).__name__ == "DiscretizedLogisticMixLikelihood" and head.fused
        test = [m for kind, _, m in tr.logger.history if kind == "test"][-1]
        ckpt = os.path.join(tr.run_dir, "checkpoints", "ckpt_00000002.pt")
        res = evaluate(["--load", tr.run_dir, "--state-dict", ckpt, "--ll",
                        "--iw-samples", "2", "--iw-max-batches", "1", "--device", "cpu"])
        assert res["elbo"]["n_images"] == 128 and res["iw"]["n_images"] == 64
        assert abs(res["elbo"]["elbo"] - test["elbo"]) < 1e-3 * abs(test["elbo"])
        # nats over 64 x 64 x 3 dimensions
        assert abs(res["elbo"]["bpd"] + res["elbo"]["elbo"] / (12288 * np.log(2))) < 1e-9
        assert np.isfinite(res["iw"]["iw_ll"]) and 0 < res["iw"]["iw_bpd"] < 20

    def test_cuda_without_a_card_raises(self, tmp_path):
        from lvae_tpu_torch.main import main

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible here")
        with pytest.raises(SystemExit, match="--device cuda"):
            main(["--dataset", "synthetic", "--device", "cuda",
                  "--output-dir", str(tmp_path)])
