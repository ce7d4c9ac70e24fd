"""The port's training trajectory against ``lvae_tpu``'s over a training
horizon (``tools/parity_drift_torch.py``): one trajectory through both
packages' own train steps in fp32, dropout 0, from the same weights, with
shared per-(step, layer) latent noise and the data order of both
``ArrayLoader``s, the two batches checked identical at every step.

Tolerances, as ``tests/test_parity.py::TestLongHorizonDrift`` holds
``lvae_tpu`` against the torch mirror: the test ELBO under shared eval
noise within 1e-3 bpd at every evaluation; the per-step losses within
1e-3 relative. The tier-1 case is 30 steps at z 8-8-8, 16 filters, one
block a layer (the compiles of ``lvae_tpu``'s init, step and eval take
most of its time); the slow case is 200 steps at TestLongHorizonDrift's
shape.
"""

import importlib.util
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONVENTIONS = [pytest.param(("same", "pre"), id="same-pre"),
               pytest.param(("torch", "post"), id="torch-post")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small eager ops: one intra-op thread keeps them fast when the tier
    runs several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(**kw):
    spec = importlib.util.spec_from_file_location(
        "parity_drift_torch", os.path.join(REPO, "tools", "parity_drift_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.run_drift_torch(**kw)


def _bounded(r):
    for row in r["history"]:
        assert row["drift_bpd"] < 1e-3, (row, r["config"])
    assert r["drift_bpd"] < 1e-3, r["config"]
    assert r["loss_rel_gap_max"] < 1e-3, r["config"]


@pytest.mark.parametrize("conv", CONVENTIONS)
def test_30_step_drift_bounded(conv):
    """Every evaluation's drift and every step's loss gap bounded, and the
    trajectory learned (both test ELBOs rose from the first evaluation to
    the last)."""
    r = _run(steps=30, batch=16, zdims=(8, 8, 8), n_filters=16, blocks_per_layer=1,
             conv_pad=conv[0], skip_merge=conv[1], beta_anneal=20, n_train=256, n_eval=32,
             eval_eps=1, eval_every=10)
    _bounded(r)
    first, last = r["history"][0], r["history"][-1]
    assert last["elbo_jax"] > first["elbo_jax"] and last["elbo_torch"] > first["elbo_torch"]


@pytest.mark.slow
@pytest.mark.parametrize("conv", CONVENTIONS)
def test_200_step_drift_bounded(conv):
    """TestLongHorizonDrift's run (200 steps, batch 16, z 8-8-8, 16
    filters, 2 blocks a layer, free bits 0.5, a 100-step warm-up) with the
    port in the mirror's place; the trajectory learned as there."""
    r = _run(steps=200, batch=16, zdims=(8, 8, 8), n_filters=16, blocks_per_layer=2,
             conv_pad=conv[0], skip_merge=conv[1], free_bits=0.5, beta_anneal=100,
             n_train=512, n_eval=64, eval_eps=2, eval_every=100)
    _bounded(r)
    assert r["elbo_jax"] > -570
