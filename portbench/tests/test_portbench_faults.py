"""A whole run on the CPU at a tiny size, past the look for a card: sound
it comes out correct, and with the timed path broken underneath it comes
out not correct, once for each fault a cell can have. (One chip: no
exchange between chips to leave out.)"""

import contextlib
import time

import pytest
import torch

from portbench import calibrate, run

SEED = 2**31 + 9


def measure(cell):
    return run.measure(cell, SEED, 0.5, False, "cpu", time.perf_counter(), log=lambda m: None)


@contextlib.contextmanager
def sound():
    yield


@contextlib.contextmanager
def unchanged_state(monkeypatch):
    """Adamax's step returns the state as it was (no moment, no update)."""
    from lvae_tpu_torch.train.state import Adamax

    monkeypatch.setattr(Adamax, "step", lambda self, closure=None, emit=None: None)
    yield


@contextlib.contextmanager
def altered_loss(monkeypatch):
    """The loss a step produces, scaled by 1.001."""
    from lvae_tpu_torch.train import state as st

    whole = st.loss_terms

    def scaled(*args, **kwargs):
        loss, metrics = whole(*args, **kwargs)
        return loss * 1.001, metrics

    monkeypatch.setattr(st, "loss_terms", scaled)
    yield


@contextlib.contextmanager
def half_the_samples(monkeypatch):
    """Each image's IW-LL from half its samples, the mean over the rest."""
    from lvae_tpu_torch.eval import iwll

    whole = iwll.iwll_batch
    monkeypatch.setattr(iwll, "iwll_batch", lambda model, x, index, seed, k, *a:
                        whole(model, x, index, seed, max(1, k // 2), *a))
    yield


@contextlib.contextmanager
def altered_answer(monkeypatch):
    """One image's IW-LL altered by a thousandth where it is produced."""
    from lvae_tpu_torch.eval import iwll

    whole = iwll.iwll_batch

    def altered(*args):
        ll = whole(*args).clone()
        ll[1] *= 1.001
        return ll

    monkeypatch.setattr(iwll, "iwll_batch", altered)
    yield


def test_a_sound_training_run_is_correct(tiny_cell):
    out = measure(tiny_cell("train"))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == 4
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"train_images_per_s", "train_peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_loss"])
def test_a_broken_training_step_is_not_correct(tiny_cell, monkeypatch, fault):
    ctx = {"unchanged_state": lambda: unchanged_state(monkeypatch),
           "half_batch": calibrate.half_batch,
           "altered_loss": lambda: altered_loss(monkeypatch)}[fault]
    with ctx():
        out = measure(tiny_cell("train"))
    assert not out["correct"], out["checks"]


def test_a_sound_iwll_run_is_correct(tiny_cell):
    out = measure(tiny_cell("iwll"))
    assert out["correct"] and out["attempted"] % 4 == 0
    assert set(out["metrics"]) == {"iwll_images_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["half_the_samples", "altered_answer"])
def test_a_broken_iwll_is_not_correct(tiny_cell, monkeypatch, fault):
    with {"half_the_samples": half_the_samples, "altered_answer": altered_answer}[fault](
            monkeypatch):
        out = measure(tiny_cell("iwll"))
    assert not out["correct"], out["checks"]


def test_a_traced_run_reports_its_per_layer_metrics(tiny_cell):
    out = run.measure(tiny_cell("train"), SEED, 0.5, True, "cpu", time.perf_counter(),
                      log=lambda m: None)
    assert out["correct"] and out["metrics"]["train_step_mfu"]["unit"] == "%"
    assert out["device"]["window_s"] >= 0.5 and "breakdown" in out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["celeba64.train", "cifar10_deep.train", "celeba64.iwll"])
def test_the_control_fails_at_the_cells_size(cell):
    """The reference in TF32 (the precision below fp32 with TF32 off) in the
    program's place fails one of the cell's limits, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    from portbench import spec
    from portbench.tests.conftest import ROOT

    c = spec.load_cell(cell, ROOT)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        control = calibrate.readings(c, seed, "cuda", fault=False)["control_tf32"]
        assert any(c.limits[k] is not None and v > c.limits[k] for k, v in control.items()), \
            (seed, control)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["celeba64.train", "cifar10_deep.train"])
def test_a_run_whose_graph_replays_are_left_out_is_not_correct(cell):
    """On a card the window replays the CUDA graph of ``k`` steps, which the
    CPU never builds: a whole run with every replay left out (the state as
    the first call's eager steps left it) is not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CPU runs no CUDA graph")
    from portbench import spec
    from portbench.tests.conftest import ROOT

    with calibrate.replay_skipped():
        out = run.measure(spec.load_cell(cell, ROOT), 2**31 + 404, 2.0, False, "cuda",
                          time.perf_counter(), log=lambda m: None)
    assert not out["correct"], out["checks"]
