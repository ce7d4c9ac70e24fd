"""``python -m lvae_tpu_torch.convert_checkpoint`` (the twin of
``tools/convert_torch_checkpoint.py`` and ``tools/export_torch_checkpoint.py``)
and ``data/registry.py`` ``stub_bundle`` on the CPU, against ``lvae_tpu``.

An ``lvae_tpu`` state built on ``stub_bundle`` (its weights and running
statistics moved off their init) is written by ``flax_to_torch_state_dict``
as a reference-style ``.pt``, imported into a port run directory, exported
again, and converted back by ``torch_state_dict_to_flax(strict=True)`` bit
for bit, in both conventions, for the Bernoulli and the mixture heads; the
imported run's ELBO matches ``lvae_tpu``'s at shared eps within
``tests/test_parity.py``'s tolerance; ``evaluate --load`` and ``main
--load`` run on an imported run (also under ``--grad-accum 2``); strict
import names what does not match, and export refuses an orbax run."""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from lvae_tpu.config import config_from_args as j_config_from_args
from lvae_tpu.data import registry as j_registry
from lvae_tpu.train import CheckpointManager as JCheckpointManager
from lvae_tpu.train import Experiment as JExperiment
from lvae_tpu.train.convert import flax_to_torch_state_dict, torch_state_dict_to_flax
from lvae_tpu_torch import convert_checkpoint
from lvae_tpu_torch.config import config_from_dict
from lvae_tpu_torch.data import registry
from lvae_tpu_torch.train.trainer import make_model
from tests.test_torch_model import ATOL, RTOL, _jax_forced

CONVENTIONS = {"same-pre": ["--conv-pad", "same", "--skip-merge", "pre"],
               "torch-post": ["--conv-pad", "torch", "--skip-merge", "post"]}
SMALL = ["--zdims", "3", "3", "--downsample", "1", "1", "--blocks-per-layer", "1",
         "--skip", "--gated", "--learn-top-prior", "--batch-size", "8",
         "--test-batch-size", "16", "--seed", "3", "--fused", "none"]
FILTERS = {"static_mnist": "8", "synthetic_celeba": "16", "synthetic": "8"}
ROUND_TRIPS = [(d, c) for d in ("static_mnist", "synthetic_celeba") for c in CONVENTIONS]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flags(dataset, conv="same-pre", *extra):
    return ["--dataset", dataset, "--n-filters", FILTERS[dataset], *SMALL,
            *CONVENTIONS[conv], *extra]


def _moved(variables, rng):
    """Weights and running statistics moved off their init, little enough
    that the 64x64 mixture model's KL stays finite."""
    def move(path, a):
        a = np.asarray(a)
        noise = rng.normal(size=a.shape).astype(np.float32)
        if path[-1] == "var":
            return a * rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        return a + noise * (0.1 if path[-1] == "mean" else 0.02)

    return {k: unflatten_dict({p: move(p, a) for p, a in flatten_dict(t).items()})
            for k, t in variables.items()}


@functools.lru_cache(maxsize=None)
def lvae_tpu_run(dataset, conv):
    """(lvae_tpu's experiment on ``stub_bundle``, its init state, the
    perturbed ``{"params", "batch_stats"}`` trees, their reference-style
    state dict as tensors); built once per argument pair."""
    exp = JExperiment(j_config_from_args(flags(dataset, conv)),
                      bundle=j_registry.stub_bundle(dataset))
    state = exp.init_state()
    v = _moved({"params": state.params, "batch_stats": state.batch_stats},
               np.random.default_rng(11))
    sd = flax_to_torch_state_dict(v["params"], v["batch_stats"])
    return exp, state, v, {k: torch.from_numpy(np.array(a)) for k, a in sd.items()}


def write_reference(tmp_path, dataset, conv="same-pre"):
    path = str(tmp_path / "ref.pt")
    torch.save(lvae_tpu_run(dataset, conv)[3], path)
    return path


def import_run(tmp_path, dataset, conv="same-pre", *extra, source=None, name="imported"):
    run_dir = str(tmp_path / name)
    convert_checkpoint.main(["import", "--state-dict",
                             source or write_reference(tmp_path, dataset, conv),
                             "--run-dir", run_dir, "--device", "cpu", "--",
                             *flags(dataset, conv, *extra)])
    return run_dir


class TestStubBundle:
    @pytest.mark.parametrize("name", sorted(j_registry._META))
    def test_matches_lvae_tpu(self, name):
        got, want = registry.stub_bundle(name), j_registry.stub_bundle(name)
        for field in ("img_size", "padded_size", "color_ch", "preprocess",
                      "default_likelihood"):
            assert getattr(got, field) == getattr(want, field), field
        np.testing.assert_array_equal(got.train, want.train)
        np.testing.assert_array_equal(got.test, want.test)

    @pytest.mark.parametrize("name", ["multi_dsprites_binary_rgb", "multi_mnist_binary"])
    def test_refuses_the_multiobject_sets(self, name):
        with pytest.raises(ValueError, match="shapes come from their npz files"):
            registry.stub_bundle(name)


class TestRoundTrip:
    @pytest.mark.parametrize("dataset,conv", ROUND_TRIPS)
    def test_import_export_convert_back_bit_equal(self, tmp_path, dataset, conv):
        """lvae_tpu's trees -> flax_to_torch_state_dict -> import -> export
        -> torch_state_dict_to_flax(strict=True): the same trees bit for
        bit, and the exported file the reference-style file entry for
        entry."""
        _, state, v, sd = lvae_tpu_run(dataset, conv)
        run_dir = import_run(tmp_path, dataset, conv)
        out = str(tmp_path / "exported.pt")
        convert_checkpoint.main(["export", "--load", run_dir, "--out", out])
        exported = torch.load(out, weights_only=True)
        assert sorted(exported) == sorted(sd)
        for k, t in sd.items():
            assert exported[k].dtype == t.dtype and torch.equal(exported[k], t), k
        params, stats = torch_state_dict_to_flax(state.params, state.batch_stats, exported,
                                                 strict=True)
        for want, got in ((v["params"], params), (v["batch_stats"], stats)):
            fw, fg = flatten_dict(want), flatten_dict(got)
            assert sorted(fw) == sorted(fg)
            for path, a in fw.items():
                np.testing.assert_array_equal(np.asarray(a), fg[path], err_msg="/".join(path))

    @pytest.mark.parametrize("dataset,conv", ROUND_TRIPS)
    def test_imported_run_matches_lvae_tpu(self, tmp_path, dataset, conv):
        """The imported run's checkpoint, built as ``evaluate`` builds it,
        gives lvae_tpu's per-image ll and KL at shared eps (eval mode)."""
        exp, _, v, _ = lvae_tpu_run(dataset, conv)
        run_dir = import_run(tmp_path, dataset, conv)
        with open(os.path.join(run_dir, "config.json")) as f:
            cfg = config_from_dict(json.load(f))
        model = make_model(cfg, registry.stub_bundle(dataset), torch.device("cpu"))
        ckpt = torch.load(os.path.join(run_dir, "checkpoints", "ckpt_00000000.pt"),
                          weights_only=True)
        assert ckpt["step"] == 0 and "accum" not in ckpt
        model.load_state_dict(ckpt["model"], strict=True)
        model.eval()
        rng = np.random.default_rng(5)
        h, w, c = registry.stub_bundle(dataset).data_shape
        x = rng.uniform(size=(4, h, w, c)).astype(np.float32)
        if c == 1:
            x = (x < 0.4).astype(np.float32)
        shapes = [z.shape for z in exp.model.apply(
            v, jnp.asarray(x), train=False, rngs={"sample": jax.random.key(0)})["z"]]
        eps = [rng.normal(size=s).astype(np.float32) for s in shapes]
        oj = exp.model.apply(v, jnp.asarray(x), [jnp.asarray(e) for e in eps],
                             method=_jax_forced)
        with torch.no_grad():
            ot = model(torch.from_numpy(x), forced_eps=[torch.from_numpy(e) for e in eps])
        for k in ("ll", "kl_sep"):
            np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        assert np.abs(ot["ll"].numpy()).max() > 1.0

    def test_export_reads_back_through_lvae_tpus_import_tool(self, tmp_path):
        """The exported .pt through ``tools/convert_torch_checkpoint.py``
        (strict) into an orbax run whose restored trees are lvae_tpu's."""
        import importlib.util

        _, state, v, _ = lvae_tpu_run("static_mnist", "same-pre")
        out = str(tmp_path / "exported.pt")
        convert_checkpoint.main(["export", "--load", import_run(tmp_path, "static_mnist"),
                                 "--out", out])
        tool = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                            "convert_torch_checkpoint.py")
        spec = importlib.util.spec_from_file_location("convert_torch_checkpoint", tool)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        jax_run = str(tmp_path / "jax_run")
        mod.main(["--state-dict", out, "--run-dir", jax_run, "--",
                  *flags("static_mnist", "same-pre", "--platform", "cpu")])
        mngr = JCheckpointManager(jax_run)
        restored = mngr.restore(state)
        mngr.close()
        for want, got in ((v["params"], restored.params),
                          (v["batch_stats"], restored.batch_stats)):
            fg = flatten_dict(got)
            for path, a in flatten_dict(want).items():
                np.testing.assert_array_equal(np.asarray(a), np.asarray(fg[path]))


class TestCommandsOnAnImportedRun:
    @pytest.mark.parametrize("accum", [[], ["--grad-accum", "2"]], ids=["plain", "accum2"])
    def test_evaluate_and_main_load(self, tmp_path, accum):
        """``evaluate --load`` scores an imported run as it scores the
        lvae_tpu weights given by ``--state-dict``; ``main --load`` trains
        one step from it (under ``--grad-accum 2`` the checkpoint holds the
        accumulator the trainer restores)."""
        from lvae_tpu_torch.evaluate import main as evaluate
        from lvae_tpu_torch.main import main as train

        ref = write_reference(tmp_path, "synthetic")
        run_dir = import_run(tmp_path, "synthetic", "same-pre", *accum, source=ref)
        ckpt = torch.load(os.path.join(run_dir, "checkpoints", "ckpt_00000000.pt"),
                          weights_only=True)
        assert ("accum" in ckpt) == bool(accum)
        res = evaluate(["--load", run_dir, "--device", "cpu"])
        direct = evaluate(["--load", run_dir, "--state-dict", ref, "--device", "cpu"])
        assert res["step"] == 0 and np.isfinite(res["elbo"]["elbo"])
        assert res["elbo"]["elbo"] == direct["elbo"]["elbo"]
        tr = train(flags("synthetic", "same-pre", *accum) + [
            "--device", "cpu", "--load", run_dir, "--max-steps", "1",
            "--output-dir", str(tmp_path / "out"), "--run-name", "r", "--log-interval", "1"])
        assert tr.state.step == 1
        assert all(np.isfinite(float(m["loss"])) for kind, _, m in tr.logger.history
                   if kind == "train")


class TestRefusals:
    @staticmethod
    def _mutations(sd):
        key = next(k for k in sd if k.endswith(".weight") and sd[k].dim() == 4)
        missing = dict(sd)
        del missing[key]
        extra = dict(sd, **{"not.a.real.weight": sd[key]})
        shape = dict(sd, **{key: sd[key][:1].clone()})
        return key, {"missing": missing, "unexpected": extra, "shape": shape}

    @pytest.mark.parametrize("what", ["missing", "unexpected", "shape"])
    def test_strict_import_names_what_does_not_match(self, tmp_path, what):
        key, cases = self._mutations(lvae_tpu_run("synthetic", "same-pre")[3])
        path = str(tmp_path / "bad.pt")
        torch.save(cases[what], path)
        name = {"missing": key, "unexpected": "not.a.real.weight", "shape": key}[what]
        with pytest.raises(ValueError, match=rf"{what} \(1\): \['{name}"):
            import_run(tmp_path, "synthetic", source=path)
        assert not os.path.exists(tmp_path / "imported")

    def test_non_strict_reports_and_keeps_the_fresh_values(self, tmp_path, capsys):
        from lvae_tpu_torch.config import config_from_args

        sd = lvae_tpu_run("synthetic", "same-pre")[3]
        key, cases = self._mutations(sd)
        bias = key.replace(".weight", ".bias")
        bad = dict(cases["unexpected"])
        del bad[key]
        bad[bias] = torch.zeros(99)
        path = str(tmp_path / "bad.pt")
        torch.save(bad, path)
        run_dir = str(tmp_path / "imported")
        convert_checkpoint.main(["import", "--state-dict", path, "--run-dir", run_dir,
                                 "--non-strict", "--device", "cpu", "--",
                                 *flags("synthetic")])
        text = capsys.readouterr().out
        assert f"non-strict: 1 missing entries keep their fresh values: ['{key}']" in text
        assert ("non-strict: 1 unexpected entries keep their fresh values: "
                "['not.a.real.weight']") in text
        assert f"non-strict: 1 shape entries keep their fresh values: ['{bias}: " in text
        got = torch.load(os.path.join(run_dir, "checkpoints", "ckpt_00000000.pt"),
                         weights_only=True)["model"]
        cfg, _ = config_from_args(flags("synthetic"))
        fresh = make_model(cfg, registry.stub_bundle("synthetic"), torch.device("cpu"),
                           generator=torch.Generator().manual_seed(cfg.seed),
                           train=True).state_dict()
        for k, t in sd.items():
            assert torch.equal(got[k], fresh[k] if k in (key, bias) else t), k

    def test_export_refuses_an_orbax_run_and_names_the_jax_tool(self, tmp_path):
        _, state, _, _ = lvae_tpu_run("synthetic", "same-pre")
        run_dir = str(tmp_path / "jax_run")
        mngr = JCheckpointManager(run_dir)
        mngr.save(state, wait=True)
        mngr.close()
        with pytest.raises(SystemExit, match="tools/export_torch_checkpoint.py"):
            convert_checkpoint.main(["export", "--load", run_dir, "--out",
                                     str(tmp_path / "x.pt")])
        assert not os.path.exists(tmp_path / "x.pt")

    def test_import_without_a_card_refuses_cuda(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="no CUDA device is visible"):
            convert_checkpoint.main(["import", "--state-dict", "x.pt", "--run-dir",
                                     str(tmp_path / "r"), "--", *flags("synthetic")])
