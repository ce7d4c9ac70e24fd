"""The port's image grids and ``evaluate --load <run>`` on the CPU:

- ``eval/viz.py``'s ``make_grid`` and ``save_image_grid`` bit-equal to
  ``lvae_tpu.eval.viz``'s (the grid array and the PNG's pixels);
- ``dump_images``' spatial-KL tiles and reconstruction pairs against
  ``lvae_tpu``'s ``Experiment.dump_images`` on the same weights and the
  same eps (``forced_eps``), float32, within 1e-5 (the tiles are maps
  over their max, in [0, 1]; the model's float32 gap is ~1e-6);
- with every layer in ``--mode-layers`` generation draws no noise, so the
  port's ``sample_prior`` equals ``lvae_tpu``'s ``out_mean`` in float64
  within 1e-6; with every layer in ``--constant-layers`` every image of a
  batch is the same;
- the ``diag_<tag>_<step>.png`` names of ``lvae_tpu``'s ``evaluate.py``;
- ``evaluate --load <run name>`` from the run's latest checkpoint and from
  ``--step``, each equal to the test ELBO the trainer logged at that step,
  the grids at ``make_grid``'s pixel sizes (the trainer's test hook writes
  the first three), and the errors for a missing step and for
  ``--state-dict`` with ``--step``."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lvae_tpu.config import ExperimentConfig
from lvae_tpu.data.device import eval_preprocess_batch as j_eval_preprocess
from lvae_tpu.eval import viz as jviz
from lvae_tpu.ops.math import crop_img_tensor, pad_img_tensor
from lvae_tpu.train.trainer import Experiment as JExperiment
from lvae_tpu_torch.config import config_from_dict
from lvae_tpu_torch.data.registry import load_test_set
from lvae_tpu_torch.eval import viz
from lvae_tpu_torch.evaluate import diagnostics_path
from lvae_tpu_torch.evaluate import main as evaluate
from lvae_tpu_torch.models.stochastic import Noise
from lvae_tpu_torch.train.convert import params_from_flax
from lvae_tpu_torch.train.trainer import dump_images, make_model
from tests.test_torch_cli import _train


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestGrid:
    @pytest.mark.parametrize("n,hwc,ncol,pad_value", [
        (64, (28, 28, 1), None, 0.5), (7, (5, 3, 3), None, 0.5), (64, (8, 8, 3), 8, 0.5),
        (3, (4, 4, 1), 3, 1.0), (1, (2, 6, 1), None, 0.0)])
    def test_equals_lvae_tpu(self, rng, tmp_path, n, hwc, ncol, pad_value):
        images = rng.uniform(-0.2, 1.2, size=(n, *hwc)).astype(np.float32)
        want = jviz.make_grid(images, ncol=ncol, pad_value=pad_value)
        got = viz.make_grid(images, ncol=ncol, pad_value=pad_value)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        from PIL import Image

        a, b = tmp_path / "a.png", tmp_path / "b.png"
        viz.save_image_grid(images, str(a), ncol=ncol, pad_value=pad_value)
        jviz.save_image_grid(images, str(b), ncol=ncol, pad_value=pad_value)
        assert np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


def _eval_fwd(m, x, eps):
    """lvae_tpu's eval forward with the latent draw replaced by ``eps``:
    what its eval step hands dump_images."""
    td, info = m.topdown_pass(m.bottomup_pass(pad_img_tensor(x, m.img_size), train=False),
                              train=False, forced_eps=eps)
    _, lik = m.likelihood_head(crop_img_tensor(td, m.data_size), x)
    return {"kl_spatial": [jnp.sum(k, axis=-1) for k in info["kl_elementwise"]],
            "out_mean": lik["mean"]}


class _Grids:
    """A logger that keeps what dump_images logs."""

    def __init__(self):
        self.grids = {}

    def log_images(self, tag, step, grid):
        self.grids[tag] = grid


def _pair(**kw):
    """lvae_tpu's Experiment on a tiny synthetic config with its initial
    state, and the port's model on the same weights."""
    jcfg = ExperimentConfig(dataset="synthetic", zdims=(4, 4), downsample=(1, 1),
                            blocks_per_layer=1, n_filters=8, skip=True, gated=True,
                            learn_top_prior=True, dropout=0.0, seed=0, dry_run=True, **kw)
    jexp = JExperiment(jcfg)
    state = jexp.init_state(data_dep_init=False)
    # off the init (the heads start near 0, every image at p = 0.5)
    rng = np.random.default_rng(7)
    state = state.replace(params=jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.1,
        state.params))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    data = load_test_set(cfg.dataset, cfg.data_dir)
    model = make_model(cfg, data, torch.device("cpu"))
    model.load_state_dict(params_from_flax(jax.device_get(state.params),
                                           jax.device_get(state.batch_stats)), strict=True)
    return jexp, state, model, data


class TestDumpImages:
    def test_matches_lvae_tpu(self, rng, tmp_path):
        """The spatial-KL tiles and the reconstruction pairs equal
        lvae_tpu's at shared eps, within 1e-5; the three files exist."""
        jexp, state, model, data = _pair()
        n = 32
        with torch.no_grad():
            zs = model(torch.zeros(n, 28, 28, 1), noise=Noise(0, torch.arange(n)))["z"]
        eps = [rng.normal(size=z.shape).astype(np.float32) for z in zs]
        variables = {"params": state.params, "batch_stats": state.batch_stats}

        def eval_step(st, batch, key, idx):
            x = j_eval_preprocess(batch, jexp.bundle.preprocess, idx)
            return jexp.model.apply(variables, x, [jnp.asarray(e) for e in eps],
                                    method=_eval_fwd)

        jexp._eval_step = eval_step
        want = _Grids()
        jexp.dump_images(state, str(tmp_path / "j"), 5, want, n_samples=4)
        test = torch.from_numpy(np.asarray(data.test))
        got = dump_images(model, test, data.preprocess, str(tmp_path / "t"), 5, n_samples=4,
                          forced_eps=[torch.from_numpy(e) for e in eps])
        for tag in ("kl_spatial", "reconstructions"):
            assert got[tag].shape == want.grids[tag].shape, tag
            np.testing.assert_allclose(got[tag], want.grids[tag], rtol=0, atol=1e-5,
                                       err_msg=tag)
        assert got["samples"].shape == want.grids["samples"].shape
        assert sorted(os.listdir(tmp_path / "t" / "imgs")) == [
            "kl_spatial_5.png", "recon_5.png", "sample_5.png"]

    def test_mode_layers_match_lvae_tpu(self):
        """Every layer at its mode: no draw, so the port's sample_prior
        equals lvae_tpu's out_mean in float64 within 1e-6 (lvae_tpu's
        head rounds its output to float32, 6e-8 relative)."""
        jexp, state, model, _ = _pair()
        with jax.enable_x64():
            to64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
            want = jexp.model.apply(
                {"params": to64(state.params), "batch_stats": to64(state.batch_stats)}, 6,
                method="sample_prior", mode_layers=(0, 1), temperature=0.7,
                rngs={"sample": jax.random.key(1)})["out_mean"]
            want = np.asarray(want)
        with torch.no_grad():
            got = model.double().sample_prior(6, seed=3, mode_layers=(0, 1),
                                              temperature=0.7)["out_mean"]
        # both packages' heads round their float64 conv output to float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert float(np.abs(want - want[:1]).max()) == 0.0 and want.std() > 1e-2

    def test_constant_layers_give_one_image(self):
        """Every layer constant: one latent draw for the batch, bit for bit,
        so one image (within 1e-6: the CPU convolution may round a row of
        a batch differently, measured 6e-8 at B = 5 on one thread)."""
        _, _, model, _ = _pair()
        with torch.no_grad():
            out = model.sample_prior(5, seed=2, constant_layers=(0, 1))
            free = model.sample_prior(5, seed=2)["out_mean"]
        assert all(torch.equal(z[i], z[0]) for z in out["z"] for i in range(5))
        img = out["out_mean"]
        np.testing.assert_allclose(img.numpy(), img[:1].expand_as(img).numpy(), rtol=0,
                                   atol=1e-6)
        assert float((free - free[:1]).abs().max()) > 1e-3


class TestDiagnosticsName:
    @pytest.mark.parametrize("mode,const,temps,name", [
        ([0, 1], None, [0.7], "diag_mode0-1_T0.7_60.png"),
        (None, [1], None, "diag_const1_60.png"),
        ([], None, [1.0, 0.5], "diag_T1-0.5_60.png"),
        ([0], [1, 2], [0.25], "diag_mode0_const1-2_T0.25_60.png"),
        ([], [], None, "diag__60.png"),
    ])
    def test_tag(self, mode, const, temps, name):
        assert diagnostics_path("run", 60, mode, const, temps) == os.path.join(
            "run", "imgs", name)


def _size(n, h, w, ncol=None):
    """make_grid's pixel size (H', W') of n tiles of h x w."""
    ncol = ncol or int(np.ceil(np.sqrt(n)))
    return int(np.ceil(n / ncol)) * (h + 2) + 2, ncol * (w + 2) + 2


class TestEvaluateLoad:
    def test_load_by_name(self, tmp_path, capsys):
        """Six steps with a test hook and a checkpoint every 3: the hook's
        grids at both steps; evaluate --load r scores step 6, --step 3 step
        3, each equal to the trainer's test ELBO there; the grids and the
        diagnostics grid at make_grid's sizes."""
        from PIL import Image

        tr = _train(tmp_path, "--run-name", "r", "--max-steps", "6", "--test-interval", "3")
        imgs = os.path.join(tr.run_dir, "imgs")
        assert sorted(os.listdir(imgs)) == sorted(
            f"{k}_{s}.png" for k in ("sample", "recon", "kl_spatial") for s in (3, 6))
        tests = {s: m for kind, s, m in tr.logger.history if kind == "test"}
        capsys.readouterr()
        res = evaluate(["--load", "r", "--output-dir", str(tmp_path), "--device", "cpu",
                        "--nimages", "16", "--mode-layers", "0", "1", "--temperature", "0.7"])
        assert res["step"] == 6 and "its checkpoint of step 6" in capsys.readouterr().out
        assert abs(res["elbo"]["elbo"] - tests[6]["elbo"]) < 1e-6
        sizes = {"sample": _size(16, 28, 28), "recon": _size(64, 28, 28, 8),
                 "kl_spatial": _size(2, 8, 8, 2), "diag": _size(16, 28, 28)}
        assert [os.path.basename(p) for p in res["images"]] == [
            "sample_6.png", "recon_6.png", "kl_spatial_6.png", "diag_mode0-1_T0.7_6.png"]
        for path in res["images"]:
            kind = os.path.basename(path).split("_")[0]
            kind = "kl_spatial" if kind == "kl" else kind
            assert np.asarray(Image.open(path)).shape == sizes[kind], path
        res3 = evaluate(["--load", "r", "--output-dir", str(tmp_path), "--device", "cpu",
                         "--step", "3"])
        assert res3["step"] == 3 and abs(res3["elbo"]["elbo"] - tests[3]["elbo"]) < 1e-6
        assert res3["elbo"]["elbo"] != res["elbo"]["elbo"]

    def test_missing_step_and_state_dict_with_step(self, tmp_path):
        tr = _train(tmp_path, "--run-name", "r", "--max-steps", "6")
        base = ["--load", "r", "--output-dir", str(tmp_path), "--device", "cpu"]
        with pytest.raises(FileNotFoundError, match=r"step 4 .*\[3, 6\]"):
            evaluate(base + ["--step", "4"])
        ckpt = os.path.join(tr.run_dir, "checkpoints", "ckpt_00000006.pt")
        with pytest.raises(SystemExit, match="--step"):
            evaluate(base + ["--state-dict", ckpt, "--step", "6"])
        # --state-dict alone still scores, at the checkpoint's step
        assert evaluate(base + ["--state-dict", ckpt])["step"] == 6
