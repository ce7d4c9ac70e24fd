"""The port's measurement tools on the CPU: ``lvae_tpu_torch.perf_probe``,
``iwll_probe`` and ``profile_step`` (the twins of ``tools/perf_probe.py``,
``tools/iwll_probe.py`` and ``tools/profile_step.py``) and the shared
helpers of ``lvae_tpu_torch.profiling``.

Each probe's ``main`` runs at a tiny size with ``--device cpu`` and
prints its legs; the IW-LL legs at chunk 1 and 4 agree, as the sweep's
chunk invariance says; each tool refuses ``--device cuda`` without a card,
and ``profile_step`` takes ``--rng-impl rbg`` as it takes threefry. The
card's runs are ``chip_smoke.py`` phase 22.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from lvae_tpu_torch import iwll_probe, perf_probe, profile_step
from lvae_tpu_torch.profiling import by_name, device_spans, power_limit_w, timed, union

TINY = ["--device", "cpu", "--batch-size", "8", "--n-filters", "8", "--blocks-per-layer", "1"]
PERF_LEGS = ["train step (full)", "forward only", "forward + backward",
             *(f"train step ({name})" for name, _ in perf_probe.ABLATIONS),
             "12x conv3x3 64ch @16x16 fwd"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny eager ops: one intra-op thread keeps them fast when the tier
    runs several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_perf_probe_prints_every_leg(capsys):
    legs = perf_probe.main([*TINY, "--iters", "1", "--precision", "fp32"])
    assert list(legs) == PERF_LEGS
    out = capsys.readouterr().out
    assert out.startswith("device: cpu  batch 8  precision fp32")
    for name, row in legs.items():
        assert row["ms"] > 0 and row["images_per_sec"] > 0 and row["tflops"] > 0, name
        assert re.search(rf"^{re.escape(name)} +[\d.]+ ms +\d+ img/s +[\d.]+ TF/s$", out, re.M)


def test_iwll_probe_prints_every_leg_and_chunks_agree(capsys):
    """``iwll_c1`` and ``iwll_c4`` within 1e-6 of each other (relative, per
    image) at both precisions: the sweep's chunk invariance."""
    out = iwll_probe.main([*TINY, "--iters", "1", "--k", "8"])
    assert list(out) == list(iwll_probe.PRECISIONS)
    text = capsys.readouterr().out
    for precision, rows in out.items():
        for leg in ("batched_fwd", "per_image_fwd", "iwll_c1", "iwll_c4"):
            assert rows[leg]["ms_per_call"] > 0 and rows[leg]["fwd_images_per_sec"] > 0
            assert re.search(rf"^\[{precision}\] +{leg}: +[\d.]+ ms/call", text, re.M)
        assert rows["iwll_c1"]["ms_per_fwd"] == pytest.approx(rows["iwll_c1"]["ms_per_call"] / 8)
        c1, c4 = rows["iwll_c1"]["values"], rows["iwll_c4"]["values"]
        assert c1.shape == (8,) and torch.isfinite(c1).all()
        assert rows["chunk_rel_diff"] <= 1e-6
        torch.testing.assert_close(c4, c1, rtol=1e-6, atol=0)


@pytest.mark.parametrize("tool", [perf_probe, iwll_probe, profile_step])
def test_refuses_cuda_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device is visible"):
        tool.main(["--device", "cuda", "--batch-size", "8", "--n-filters", "8",
                   "--blocks-per-layer", "1"])


@pytest.mark.parametrize("impl", ["rbg", "threefry"])
def test_profile_step_takes_either_rng_impl(impl, monkeypatch):
    """Either ``--rng-impl`` passes the config and stops at the tool's own
    exit without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device is visible"):
        profile_step.main(["--rng-impl", impl, "--n-filters", "8", "--blocks-per-layer", "1"])


def test_timed_reads_a_value_back_after_the_warmup_and_the_last_call():
    calls, reads = [], []

    class Out:
        """A call's output that records each read of one of its elements."""

        def __init__(self, v):
            self.v = v

        def reshape(self, *shape):
            return self

        def __getitem__(self, i):
            reads.append(self.v)
            return self.v

    def fn():
        calls.append(len(calls))
        return Out(float(len(calls)))

    sec = timed(fn, iters=3, warmup=2)
    assert sec >= 0 and len(calls) == 5
    assert reads == [2.0, 5.0]


@pytest.mark.parametrize("spans, want", [
    ([], 0.0),
    ([(0, 2)], 2.0),
    ([(0, 2), (1, 3)], 3.0),              # overlapping
    ([(0, 2), (3, 4)], 3.0),              # a gap
    ([(0, 5), (1, 2), (3, 4)], 5.0),      # nested
    ([(0, 1), (1, 2)], 2.0),              # touching
])
def test_union(spans, want):
    assert union(spans) == want


def test_power_limit_of_a_card_line():
    assert power_limit_w("NVIDIA H100 80GB HBM3, 700.00 W") == 700.0
    assert power_limit_w("NVIDIA H100 80GB HBM3, [N/A]") is None


def _event(name, device, start=0, end=0, annotation=False):
    """A raw kineto record of the profiler."""
    return SimpleNamespace(name=lambda: name, device_type=lambda: device,
                           start_ns=lambda: start, end_ns=lambda: end,
                           is_user_annotation=lambda: annotation,
                           is_hidden_event=lambda: False)


def test_device_events_and_spans_keep_the_device_kernels():
    """Kernels and copies on the device; not the host's operators, not the
    device spans of host annotations (named as a host event, or flagged),
    not the profiler's "[memory]" records; by name, demangled."""
    events = [_event("aten::add", DeviceType.CPU),
              _event("Optimizer.step#Adamax.step", DeviceType.CPU),
              _event("Optimizer.step#Adamax.step", DeviceType.CUDA, 0, 9),
              _event("ProfilerStep#1", DeviceType.CUDA, 0, 9, annotation=True),
              _event("[memory]", DeviceType.CUDA, 0, 9),
              _event("_Z2k1IfEvv", DeviceType.CUDA, 10, 15),
              _event("Memcpy DtoD (Device -> Device)", DeviceType.CUDA, 20, 22),
              _event("void k1<float>()", DeviceType.CUDA, 30, 33)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: events)))
    spans = device_spans(prof)
    assert spans == [("_Z2k1IfEvv", 10, 15), ("Memcpy DtoD (Device -> Device)", 20, 22),
                     ("void k1<float>()", 30, 33)]
    assert by_name(spans) == {"void k1<float>()": [2, 8],
                              "Memcpy DtoD (Device -> Device)": [1, 2]}


def test_profile_step_marks_a_table_partial_where_any_kernel_is_short():
    """A kernel short of its graph nodes makes the table partial even when
    another kernel's extra events bring the total over the nodes."""
    nodes = {"void k1<float>()": ["_Z2k1IfEvv", 8], "gemm": ["gemm", 4]}
    table = {"void k1<float>()": [6, 60], "gemm": [7, 70], "Memcpy HtoD": [3, 3]}
    short, extra = profile_step.held(nodes, table)
    assert sum(n for n, _ in table.values()) > sum(n for _, n in nodes.values())
    assert short == {"void k1<float>()": (6, 8)}
    assert extra == {"gemm": (7, 4)}
    whole = {"void k1<float>()": [8, 80], "gemm": [4, 40]}
    assert profile_step.held(nodes, whole) == ({}, {})
    assert profile_step.held(nodes, {})[0] == {"void k1<float>()": (0, 8), "gemm": (0, 4)}


def test_iw_cells_are_the_sweeps_models_and_batches():
    """The IW sweep's two cells (shared by the smoke run and the A/B):
    the flagship at B = 1,000 on 28x28x1 and celeba64 at B = 500 on the
    64x64 RGB test batch given, each model built with seeded weights."""
    blobs = iwll_probe.rgb_blobs(600, seed=12, device="cpu")
    assert blobs.shape == (600, 64, 64, 3) and blobs.dtype == np.uint8
    assert 0 < blobs.mean() < 255
    cells = iwll_probe.iw_cells(blobs)
    assert list(cells) == ["flagship", "celeba64"]
    (f_cfg, f_meta, f_test, f_pre, f_dims, f_b), (c_cfg, c_meta, c_test, c_pre, c_dims, c_b) = \
        cells.values()
    assert (f_b, f_test.shape, f_pre, f_dims) == (1000, (1000, 28, 28, 1), "none", 784)
    assert (c_b, c_test.shape, c_pre, c_dims) == (500, (500, 64, 64, 3), "dequantize", 12288)
    assert f_meta.default_likelihood == "bernoulli"
    assert c_meta.default_likelihood == "discretized_logistic_mix"
    a = iwll_probe.seeded_model(dict(c_cfg, n_filters=8), c_meta, torch.device("cpu"))
    b = iwll_probe.seeded_model(dict(c_cfg, n_filters=8), c_meta, torch.device("cpu"))
    assert all(torch.equal(t, b.state_dict()[k]) for k, t in a.state_dict().items())
