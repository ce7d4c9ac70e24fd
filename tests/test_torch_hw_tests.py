"""``python -m lvae_tpu_torch.hw_tests`` (the twin of ``tools/tpu_hw_tests.py``)
on the CPU, where its kernels cannot run: its checks are the JAX tool's by
name and order (read from both sources), its eps statistics pass on the
keyed Philox stream that the kernels compute (``keyed_normal``, which
they are held to on the card) and fail on a stream with a fault, every
other check passes on the kernels' plain versions, and ``main()`` exits 2
without a card."""

import ast
import os

import numpy as np
import pytest
import torch

from lvae_tpu_torch import hw_tests
from lvae_tpu_torch.ops.philox import keyed_normal

JAX_TOOL = os.path.join(os.path.dirname(__file__), os.pardir, "tools", "tpu_hw_tests.py")
# the two names that hold a JAX function (module docstring of hw_tests)
SUBSTITUTIONS = (("jax.nn.logsumexp", "torch.logsumexp"),
                 ("autodiff", "autograd of the plain version"))
CPU_EPS_SHAPE = (256, 8, 32, 32)        # 2.1M draws a key, 8.4M in all


def _names(path, func):
    """The first argument of every call to ``func`` in ``path``, in
    source order."""
    with open(path) as f:
        tree = ast.parse(f.read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == func]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return [ast.literal_eval(n.args[0]) for n in calls if n.args]


@pytest.fixture(scope="module")
def draws():
    index = torch.arange(CPU_EPS_SHAPE[0])
    keyed = [keyed_normal(CPU_EPS_SHAPE, k, index, 0, 0).flatten().double().numpy()
             for k in hw_tests.EPS_KEYS]
    return keyed, keyed_normal(CPU_EPS_SHAPE, hw_tests.EPS_KEYS[0], index, 0, 0
                               ).flatten().double().numpy()


def test_names_are_the_jax_tools_in_order():
    want = _names(JAX_TOOL, "check")
    for old, new in SUBSTITUTIONS:
        want = [n.replace(old, new) for n in want]
    got = _names(hw_tests.__file__, "row")
    assert len(want) == 24 and got == want


def test_eps_checks_pass_on_the_keyed_philox_stream(draws):
    rows = hw_tests.eps_checks(*draws)
    assert [r[0] for r in rows] == _names(hw_tests.__file__, "row")[5:15]
    assert all(ok for _, ok, _ in rows), [r for r in rows if not r[1]]


@pytest.mark.parametrize("fault,name", [
    ("shift", "eps mean ~ 0"),
    ("same_key", "different keys decorrelated"),
    ("other_rerun", "same key deterministic"),
])
def test_eps_checks_fail_on_a_faulty_stream(draws, fault, name):
    keyed, rerun = draws
    if fault == "shift":
        keyed = [d + 0.01 for d in keyed]
    elif fault == "same_key":
        keyed = [keyed[0], keyed[0], *keyed[2:]]
    else:
        rerun = keyed[1]
    rows = {n: ok for n, ok, _ in hw_tests.eps_checks(keyed, rerun)}
    assert rows[name] is False


def test_other_checks_pass_on_the_plain_versions():
    """Checks 1-5 and 16-24 at their full shapes with CPU tensors, which
    the wrappers hand to their plain versions: the thresholds hold for
    the math the kernels are held to, so a failure on the card is the
    kernel's."""
    rng = np.random.default_rng(0)
    rows = []
    for section in (hw_tests.sample_kl_checks, hw_tests.logsumexp_checks,
                    hw_tests.mixture_checks, hw_tests.segment_checks):
        rows += section(rng, "cpu")
    names = _names(hw_tests.__file__, "row")
    assert [r[0] for r in rows] == names[:5] + names[15:]
    assert all(ok for _, ok, _ in rows), [r for r in rows if not r[1]]


def test_main_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert hw_tests.main() == 2
    assert "this is a hardware test; no CUDA device found" in capsys.readouterr().err
