"""The port's serving artifacts (``lvae_tpu_torch/serving.py``
``export_run`` / ``load_artifact`` and ``python -m
lvae_tpu_torch.export_serving``) on the CPU, case by case as
``tests/test_serving.py`` holds ``lvae_tpu``'s:

- a run the port's trainer writes (synthetic, z (4, 4), 8 filters, one
  block a layer) exports ``generate``, ``reconstruct`` and ``encode``
  once for the module; each artifact reproduces the in-process surface
  bit for bit (the same plain operations, traced);
- ``reconstruct`` with a symbolic batch serves B = 1, 3, 5 and 7 from
  one artifact, prefix- and permutation-invariant under global indices;
- the saved graphs hold aten operations only, and a process that cannot
  import ``lvae_tpu_torch`` loads and calls every artifact;
- against ``lvae_tpu``: an ``lvae_tpu`` run's weights, converted with
  ``flax_to_torch_state_dict``, exported by both packages; ``generate``
  with every layer at its mode (no noise, so the two generators do not
  matter) and ``encode``'s top-layer ``mu`` agree within
  ``tests/test_parity.py``'s tolerances, and the port's bf16 artifact is
  as near ``lvae_tpu`` at bf16 as ``tests/test_torch_precision.py``
  asks (a quarter of ``lvae_tpu``'s own bf16-vs-fp32 gap)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lvae_tpu.config import ExperimentConfig
from lvae_tpu.serving import export_run as j_export_run
from lvae_tpu.serving import load_artifact as j_load_artifact
from lvae_tpu.serving import make_generate_fn as j_make_generate_fn
from lvae_tpu.train import CheckpointManager as JCheckpointManager
from lvae_tpu.train import Experiment as JExperiment
from lvae_tpu.train import save_config as j_save_config
from lvae_tpu.train.convert import flax_to_torch_state_dict
from lvae_tpu_torch import serving
from lvae_tpu_torch.export_serving import main as export_cli

CPU = torch.device("cpu")
SEED0 = torch.tensor(0, dtype=torch.int32)
# tests/test_parity.py:371 (activations through a chain of fp32 convs)
RTOL, ATOL = 0, 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny run of the port's trainer: config.json and checkpoints."""
    from lvae_tpu_torch.main import main

    out = tmp_path_factory.mktemp("port_run")
    main(["--dataset", "synthetic", "--zdims", "4", "4", "--downsample", "1", "1",
          "--blocks-per-layer", "1", "--n-filters", "8", "--batch-size", "16",
          "--test-batch-size", "16", "--dropout", "0.0", "--max-steps", "4",
          "--log-interval", "100", "--test-interval", "1000",
          "--checkpoint-interval", "2", "--seed", "0", "--output-dir", str(out),
          "--run-name", "r", "--device", "cpu"])
    return str(out / "r")


@pytest.fixture(scope="module")
def arts(run):
    """Each surface exported once, B symbolic."""
    return serving.export_run(run, n_images=3, temperature=0.8, device="cpu")


@pytest.fixture(scope="module")
def model(run):
    return serving._restore_for_export(run, None, CPU)[0]


def _images(rng, b, shape=(28, 28, 1)):
    return torch.from_numpy((rng.uniform(size=(b, *shape)) > 0.5).astype(np.uint8))


def _idx(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32)


def _same(got, want, what):
    """Equal up to the convolutions' rounding, which may change with the
    batch size on the CPU."""
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6,
                               err_msg=what)


# what the process without the port answers: each surface's requests
SERVE = r"""
import sys
sys.modules["lvae_tpu_torch"] = None
import torch
out_dir, path = sys.argv[1:]
req = torch.load(path + "/in.pt")
res = {}
for name in ("generate", "reconstruct", "encode"):
    ep = torch.export.load(f"{out_dir}/{name}.pt2")
    res["ops", name] = sorted({(getattr(n.target, "namespace", ""), n.target.__name__)
                               for n in ep.graph.nodes if n.op == "call_function"})
    fn = ep.module()
    for key, args in req[name].items():
        res[name, key] = fn(*args)
torch.save(res, path + "/out.pt")
"""


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


@pytest.fixture(scope="module")
def served(arts, tmp_path_factory):
    """Every artifact loaded with torch.export.load alone in a fresh
    process that cannot import lvae_tpu_torch, and called: returns the
    requests and the answers."""
    rng = np.random.default_rng(3)
    x7 = _images(rng, 7)
    perm = np.array([6, 2, 0, 5, 1, 4, 3])
    keyed = {
        "b7": (x7, _i32(2), _idx(np.arange(7))),
        "b5": (x7[:5], _i32(2), _idx(np.arange(5))),
        "b3": (x7[:3], _i32(2), _idx(np.arange(3))),
        "b1": (x7[2:3], _i32(2), _idx([2])),
        "perm": (x7[perm], _i32(2), _idx(perm)),
        "seed7": (x7, _i32(7), _idx(np.arange(7))),
    }
    req = {"generate": {"s5": (_i32(5),), "s6": (_i32(6),)},
           "reconstruct": keyed, "encode": {k: keyed[k] for k in ("b7", "seed7")}}
    d = tmp_path_factory.mktemp("served")
    torch.save(req, d / "in.pt")
    subprocess.run([sys.executable, "-c", SERVE, arts.out_dir, str(d)], check=True,
                   cwd=str(d), env=dict(os.environ, PYTHONPATH=""), timeout=600)
    return req, torch.load(d / "out.pt"), perm


class TestExportRoundtrip:
    def test_generate_matches_direct(self, arts, model, served):
        assert os.path.exists(arts.paths["generate"])
        _, res, _ = served
        out = res["generate", "s5"]
        assert out.shape == (3, 28, 28, 1) and out.dtype == torch.float32
        _same(out, serving.generate(model, 3, 5, temperature=0.8), "generate vs eager")
        assert not torch.equal(out, res["generate", "s6"])

    def test_reconstruct_symbolic_batch_invariance(self, model, served):
        """One artifact (traced at B = 2) serves B = 7, 5, 3 and 1, and
        per-image outputs do not depend on the batch they sit in, nor on
        its order under global indices; each equals the eager port."""
        req, res, perm = served
        o7 = res["reconstruct", "b7"]
        for k in ("out_mean", "ll", "kl", "elbo", "bpd"):
            assert o7[k].dtype == torch.float32
            assert o7[k].shape[0] == 7
            for key, rows in (("b5", slice(0, 5)), ("b3", slice(0, 3)), ("b1", slice(2, 3)),
                              ("perm", perm)):
                _same(res["reconstruct", key][k], o7[k][rows], f"{key} {k}")
        assert bool(torch.isfinite(o7["bpd"]).all())
        for key, (x, seed, index) in req["reconstruct"].items():
            want = serving.reconstruct(model, x, int(seed), index.long())
            for k in want:
                _same(res["reconstruct", key][k], want[k], f"{key} {k} vs eager")

    def test_encode_surface(self, model, served):
        req, res, _ = served
        out, out2 = res["encode", "b7"], res["encode", "seed7"]
        # two ladder layers, z=4 each; layer 0 = bottom (kl/layer_i order)
        assert len(out["mu"]) == 2 and len(out["z"]) == 2
        for mu, z in zip(out["mu"], out["z"]):
            assert mu.shape[0] == 7 and mu.shape[-1] == 4
            assert z.shape == mu.shape and mu.dtype == torch.float32
            assert bool(torch.isfinite(mu).all())
        x, seed, index = req["encode"]["b7"]
        direct = serving.encode(model, x, 2, index.long())
        for a, b in zip(out["mu"] + out["z"], direct["mu"] + direct["z"]):
            _same(a, b, "encode vs eager")
        # the top layer's mu is a function of the image alone; z is keyed
        _same(out["mu"][-1], out2["mu"][-1], "top mu across seeds")
        assert not torch.allclose(out["z"][0], out2["z"][0])

    def test_manifest(self, arts):
        with open(arts.paths["manifest"]) as f:
            m = json.load(f)
        assert m == arts.manifest
        assert m["surfaces"]["generate"]["n_images"] == 3
        assert m["surfaces"]["generate"]["temperature"] == 0.8
        assert m["img_shape"] == [28, 28, 1]
        assert m["step"] == 4 and m["dataset"] == "synthetic"
        assert m["preprocess"] == "none" and m["precision"] == "fp32"
        assert m["platforms"] == ["cpu"] and m["traced_on"] == "cpu"
        assert m["torch_version"] == torch.__version__
        assert m["fp32_math"] == serving.FP32_MATH
        assert m["surfaces"]["reconstruct"]["batch"] is None
        assert m["surfaces"]["reconstruct"]["in"].startswith("x uint8[b,28,28,1]")
        assert m["surfaces"]["encode"]["zdims"] == [4, 4]
        assert "index[i]" in m["surfaces"]["encode"]["keying"]
        assert all(s["export_s"] > 0 for s in m["surfaces"].values())

    @pytest.mark.parametrize("name", serving.SURFACES)
    def test_graph_holds_only_aten_ops(self, served, name):
        """No op of the port and no ctypes call inside a saved artifact:
        every call_function node is an aten op (sizes included) or a
        getitem."""
        ops = served[1]["ops", name]
        assert any(ns == "aten" and n.startswith("conv") for ns, n in ops)
        other = [op for op in ops if op[0] != "aten" and op[1] != "getitem"]
        assert not other, other

    def test_load_artifact_onto_the_cpu(self, arts, served):
        req, res, _ = served
        ep = serving.load_artifact(arts.paths["reconstruct"], device="cpu")
        assert isinstance(ep, torch.export.ExportedProgram)
        got = ep.module()(*req["reconstruct"]["b5"])
        for k, v in got.items():
            _same(v, res["reconstruct", "b5"][k], k)

    def test_refusals(self, run, tmp_path):
        with pytest.raises(ValueError, match="unknown surfaces"):
            serving.export_run(run, what=("decode",), device="cpu", out_dir=str(tmp_path))
        with pytest.raises(ValueError, match="state_dict"):
            serving.export_run(run, what=("generate",), step=2, device="cpu",
                               state_dict=os.path.join(run, "checkpoints",
                                                       "ckpt_00000002.pt"))


class TestServingCLI:
    def test_cli_end_to_end(self, run, tmp_path, capsys):
        """The CLI with --check, reconstruct alone, its batch pinned to 3
        (the artifact then serves B = 3 alone)."""
        arts = export_cli(["--load", "r", "--output-dir", os.path.dirname(run),
                           "--batch", "3", "--what", "reconstruct", "--device", "cpu",
                           "--artifact-dir", str(tmp_path), "--check"])
        out = capsys.readouterr().out
        assert "wrote reconstruct" in out and "wrote manifest" in out
        assert "wrote generate" not in out and "wrote encode" not in out
        assert "check reconstruct [cpu]: out_mean (3, 28, 28, 1) bpd[0]=" in out
        m = arts.manifest
        assert m["surfaces"]["reconstruct"]["batch"] == 3
        assert m["surfaces"]["reconstruct"]["in"].startswith("x uint8[3,28,28,1]")
        assert sorted(os.listdir(tmp_path)) == ["manifest.json", "reconstruct.pt2"]

    def test_cuda_without_a_card_raises(self, run):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible")
        with pytest.raises(SystemExit, match="no CUDA device"):
            export_cli(["--load", run])
        with pytest.raises(SystemExit, match="no CUDA device"):
            export_cli(["--load", run, "--device", "cpu", "--platforms", "cuda", "cpu"])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A tiny lvae_tpu run dir (tests/test_serving.py's configuration,
    its config.json and an orbax checkpoint, both written by lvae_tpu; the
    initial parameters moved off their start with numpy, so that every
    conv does work), and its weights as the port's state_dict file."""
    out = tmp_path_factory.mktemp("jax_run")
    cfg = ExperimentConfig(
        dataset="synthetic", zdims=(4, 4), downsample=(1, 1),
        blocks_per_layer=1, n_filters=8, batch_size=16,
        test_batch_size=16, dropout=0.0, max_steps=4,
        log_interval=100, test_interval=1000, checkpoint_interval=2,
        seed=0, dry_run=False, output_dir=str(out), run_name="r",
    )
    run_dir = str(out / "r")
    exp = JExperiment(cfg)
    j_save_config(run_dir, cfg)
    state = exp.init_state(data_dep_init=False)
    rng = np.random.default_rng(11)
    state = state.replace(params=jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.normal(size=a.shape) * 0.1, a.dtype), state.params))
    JCheckpointManager(run_dir).save(state, wait=True)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in flax_to_torch_state_dict(
        variables["params"], variables.get("batch_stats")).items()}
    path = str(out / "weights.pt")
    torch.save(sd, path)
    return run_dir, path, exp, variables


class TestParityWithLvaeTpu:
    MODE = (0, 1)

    def test_generate_and_encode_match(self, jax_run, rng, tmp_path):
        """Both packages' artifacts on the same weights (the port's through
        its CLI with --state-dict): generate with every layer at its mode,
        and encode's top-layer mu (a function of the image alone in
        both)."""
        run_dir, weights, _, _ = jax_run
        jarts = j_export_run(run_dir, what=("generate", "encode"), n_images=3,
                             mode_layers=self.MODE, out_dir=str(tmp_path / "jax"))
        tarts = export_cli(["--load", run_dir, "--state-dict", weights, "--what", "generate",
                            "encode", "--nimages", "3", "--mode-layers", "0", "1",
                            "--device", "cpu", "--artifact-dir", str(tmp_path / "port")])
        assert tarts.manifest["step"] == 0 and tarts.manifest["img_shape"] == [28, 28, 1]
        want = np.asarray(j_load_artifact(jarts.paths["generate"]).call(np.int32(5)))
        got = serving.load_artifact(tarts.paths["generate"]).module()(
            torch.tensor(5, dtype=torch.int32)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert got.std() > 1e-5
        x = _images(rng, 4)
        idx = np.arange(4, dtype=np.int32)
        jmu = np.asarray(j_load_artifact(jarts.paths["encode"]).call(
            x.numpy(), np.int32(1), idx)["mu"][-1])
        tmu = serving.load_artifact(tarts.paths["encode"]).module()(
            x, torch.tensor(1, dtype=torch.int32), _idx(idx))["mu"][-1].numpy()
        np.testing.assert_allclose(tmu, jmu, rtol=RTOL, atol=ATOL)
        assert np.abs(jmu).max() > 1e-3

    def test_bf16_generate(self, jax_run, tmp_path):
        """The port's generate exported at --precision bf16 against
        lvae_tpu's generate at bf16 (compiled without XLA's excess
        precision): within a quarter of lvae_tpu's own bf16-vs-fp32 gap."""
        from tests.test_torch_precision import _exact

        run_dir, weights, exp, variables = jax_run
        tarts = serving.export_run(run_dir, what=("generate",), n_images=3,
                                   mode_layers=self.MODE, device="cpu", precision="bf16",
                                   state_dict=weights, out_dir=str(tmp_path))
        assert tarts.manifest["precision"] == "bf16"
        got = serving.load_artifact(tarts.paths["generate"]).module()(
            torch.tensor(5, dtype=torch.int32)).numpy()
        assert got.dtype == np.float32
        jax_out = {}
        for dtype in (jnp.bfloat16, None):
            fn = j_make_generate_fn(exp.model.clone(dtype=dtype), variables, 3,
                                    mode_layers=self.MODE)
            jax_out[dtype] = np.asarray(_exact(fn, jnp.int32(5)), np.float32)
        own_gap = np.abs(jax_out[jnp.bfloat16] - jax_out[None]).max()
        assert own_gap > 0
        assert np.abs(got - jax_out[jnp.bfloat16]).max() <= 0.25 * own_gap
