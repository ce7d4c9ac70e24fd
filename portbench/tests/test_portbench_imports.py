"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (``lvae_tpu_torch`` is not ``lvae_tpu``), and the
reference imports nothing of the program."""

import subprocess
import sys

from portbench import run
from portbench.tests.conftest import ROOT


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import lvae_tpu_torch  # noqa: F401

    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "lvae_tpu", raising=False)
    names = [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]
    for m in names:
        monkeypatch.delitem(sys.modules, m)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lvae_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib_extra", object())
    assert run.forbidden_modules() == ["lvae_tpu"]
    monkeypatch.setitem(sys.modules, "flax", object())
    assert run.forbidden_modules() == ["flax", "lvae_tpu"]


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_harness_and_the_program_load_no_jax():
    loaded = _loaded_after(
        "import portbench.run, portbench.calibrate, portbench.drive\n"
        "import lvae_tpu_torch.train.trainer, lvae_tpu_torch.train.state\n"
        "import lvae_tpu_torch.eval.iwll, lvae_tpu_torch.kernels.build\n"
        "from portbench import spec\n"
        "for m in ('train_step_mfu', 'mixture_roofline.train', 'latent_kl_roofline.iwll'):\n"
        "    spec.reader(m)")
    assert "lvae_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    loaded = _loaded_after("import portbench.reference.train, portbench.reference.model, "
                           "portbench.reference.philox, portbench.weights")
    assert not loaded & {"lvae_tpu_torch", *run.FORBIDDEN}
