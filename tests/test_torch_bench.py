"""``lvae_tpu_torch.bench`` (the twin of ``bench.py``) on the CPU.

``bench_preset`` against ``lvae_tpu``'s byte for byte; the bench's model
against ``lvae_tpu``'s bench model (parameter names and shapes through
``params_from_flax``, full width and ``--smoke``); the ``--smoke --device
cpu`` line with the JAX bench's keys; the liveness gate and its failure
records, mirrored from ``tests/test_bench_entry.py``; the
``no_cuda_device`` record; the last-verified record keyed by device and
written by card runs only; and the FLOP count: ``FlopCounterMode``'s
forward against a closed-form sum over the model's convolutions, and the
count the same at ``--fused none`` and ``all`` and at fp32 and bf16. The
card's own run is ``chip_smoke.py`` phase 22.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch.utils.flop_counter import FlopCounterMode

from lvae_tpu.config import ExperimentConfig
from lvae_tpu.data.registry import bench_preset as jax_bench_preset
from lvae_tpu.train.trainer import make_model as jax_make_model
from lvae_tpu_torch import bench
from lvae_tpu_torch.data.registry import bench_preset
from lvae_tpu_torch.models.blocks import Conv2d, ConvTranspose2d
from lvae_tpu_torch.models.stochastic import Noise
from lvae_tpu_torch.train.convert import params_from_flax
from lvae_tpu_torch.train.trainer import Experiment, make_model

PRESETS = ("mnist", "celeba64", "cifar10-deep")
CPU = torch.device("cpu")
# bench.py:408-431's keys (and its config's)
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "img32_equivalent_per_sec", "mfu",
            "flops_per_image", "bytes_per_image", "device", "peak_flops", "config"}
JAX_CONFIG_KEYS = {"preset", "batch_size", "steps_per_call", "timed_steps", "precision",
                   "fused", "conv_pad", "skip_merge", "remat", "bn_stat_samples"}
SMOKE = ["--smoke", "--device", "cpu", "--steps", "2", "--warmup", "1", "--steps-per-call", "2"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny eager ops: one intra-op thread keeps them fast when the tier
    runs several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(preset, *more):
    return bench.parse_args(["--preset", preset, "--device", "cpu", *more])


@pytest.mark.parametrize("preset", PRESETS)
def test_bench_preset_is_lvae_tpus_byte_for_byte(preset):
    data, zdims, downsample = bench_preset(preset, 300)
    bundle, jz, jd = jax_bench_preset(preset, 300)
    assert data.train.dtype == np.uint8 and data.train.tobytes() == bundle.train.tobytes()
    assert data.test.tobytes() == bundle.test.tobytes() == bundle.train[:256].tobytes()
    assert (zdims, downsample) == (jz, jd)
    assert (data.img_size, data.padded_size, data.color_ch, data.preprocess,
            data.default_likelihood) == (bundle.img_size, bundle.padded_size,
                                         bundle.color_ch, bundle.preprocess,
                                         bundle.default_likelihood)


def test_bench_preset_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="unknown bench preset"):
        bench_preset("imagenet", 8)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("preset", PRESETS)
def test_bench_model_matches_lvae_tpus(preset, smoke):
    """The bench's model has ``lvae_tpu``'s bench model's parameters, name
    for name and shape for shape (``bench.py:260-280`` at the same
    flags)."""
    args = _args(preset, *(["--smoke"] if smoke else []))
    cfg, data = bench.bench_config(args)
    bundle, zdims, downsample = jax_bench_preset(preset, 8)
    jcfg = ExperimentConfig(
        dataset="bench", zdims=zdims, downsample=downsample,
        blocks_per_layer=args.blocks_per_layer, n_filters=args.n_filters, skip=True,
        gated=True, learn_top_prior=True, freebits=0.5, batch_size=args.batch_size,
        dropout=0.2, seed=0, fused="none", precision=args.precision, dry_run=True)
    jm = jax_make_model(jcfg, bundle)
    h, w = bundle.img_size
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        jnp.zeros((2, h, w, bundle.color_ch)), train=False))
    zeros = {k: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes[k])
             for k in ("params", "batch_stats")}
    model = make_model(cfg, data, CPU, generator=torch.Generator().manual_seed(0), train=True)
    model.load_state_dict(params_from_flax(zeros["params"], zeros["batch_stats"]), strict=True)
    n_jax = sum(int(np.prod(s.shape)) for s in flatten_dict(shapes["params"]).values())
    assert sum(p.numel() for p in model.parameters()) == n_jax
    if preset == "cifar10-deep" and not smoke:
        assert n_jax == 6_183_908


def test_smoke_prints_one_json_line_with_the_jax_benchs_keys(capsys, monkeypatch, tmp_path):
    record = tmp_path / "last.json"
    monkeypatch.setattr(bench, "LAST_VERIFIED_PATH", str(record))
    result = bench.main(SMOKE)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d == json.loads(json.dumps(result))
    assert JAX_KEYS <= set(d) and JAX_CONFIG_KEYS <= set(d["config"])
    assert d["metric"] == "train_images_per_sec_per_chip" and d["unit"] == "images/sec/chip"
    assert math.isfinite(d["value"]) and d["value"] > 0
    assert d["vs_baseline"] is None and d["bytes_per_image"] is None
    # a CPU number is no device metric: no peak, no MFU, no power limit
    assert d["device"] == "cpu" and d["mfu"] is None and d["mfu_precision_peak"] is None
    assert d["peak_flops"] is None and d["power_limit_w"] is None
    assert d["flops_per_image"] > 0 and "FlopCounterMode" in d["flops_counted"]
    assert d["config"]["timed_steps"] == 4 and d["config"]["smoke"]
    assert math.isfinite(d["final_elbo"])
    assert not record.exists(), "a CPU run writes no last-verified record"


def test_no_cuda_device_gives_the_structured_record_and_exit_2(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "LAST_VERIFIED_PATH", str(tmp_path / "none.json"))
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code == 2
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["error"] == "no_cuda_device" and d["value"] is None
    assert d["metric"] == "train_images_per_sec_per_chip" and d["last_verified"] is None


def test_cpu_without_smoke_is_refused():
    with pytest.raises(SystemExit, match="--smoke run only"):
        bench.main(["--device", "cpu"])


def test_last_verified_is_keyed_by_device_and_written_by_card_runs_only(monkeypatch, tmp_path):
    record = tmp_path / "last.json"
    monkeypatch.setattr(bench, "LAST_VERIFIED_PATH", str(record))
    card = {"value": 5000.0, "unit": "images/sec/chip", "mfu": 0.03, "device": "NVIDIA H100",
            "config": {"preset": "celeba64", "device": "cuda", "smoke": False}}
    assert not bench.record_last_verified(dict(card, config={"device": "cpu", "smoke": True}))
    assert not bench.record_last_verified(dict(card, config={"device": "cuda", "smoke": True}))
    assert not record.exists()
    assert bench.record_last_verified(card)
    assert bench.record_last_verified(dict(card, device="NVIDIA A100", value=1.0))
    d = json.loads(record.read_text())
    assert d["NVIDIA H100"]["value"] == 5000.0 and d["NVIDIA A100"]["value"] == 1.0
    assert d["NVIDIA H100"]["config"]["preset"] == "celeba64"
    assert "timestamp_utc" in d["NVIDIA H100"]


class TestLivenessRetry:
    """``assert_device_alive``: retries with backoff and, after the last
    failure, the structured record citing the last verified results
    (``tests/test_bench_entry.py:34-125``, against the port's bench)."""

    def test_retries_until_probe_succeeds(self):
        calls = {"probe": 0, "sleep": []}

        def fake_probe(timeout_s):
            calls["probe"] += 1
            return calls["probe"] >= 3

        bench.assert_device_alive(timeout_s=1.0, retries=3, backoff_s=42.0, _probe=fake_probe,
                                  _sleep=lambda s: calls["sleep"].append(s))
        assert calls["probe"] == 3
        assert calls["sleep"] == [42.0, 42.0]

    def test_immediate_success_probes_once(self):
        calls = {"probe": 0}

        def fake_probe(timeout_s):
            calls["probe"] += 1
            return True

        bench.assert_device_alive(_probe=fake_probe, _sleep=lambda s: 0)
        assert calls["probe"] == 1

    def test_final_failure_emits_structured_json(self, capsys, monkeypatch, tmp_path):
        exited = {}
        monkeypatch.setattr(bench.os, "_exit", lambda rc: exited.update(rc=rc))
        last = tmp_path / "last.json"
        last.write_text(json.dumps({"NVIDIA H100 80GB HBM3": {
            "value": 4321.0, "unit": "images/sec/chip", "timestamp_utc": "2026-10-17T19:48:00Z"}}))
        monkeypatch.setattr(bench, "LAST_VERIFIED_PATH", str(last))
        bench.assert_device_alive(timeout_s=1.0, retries=3, backoff_s=5.0,
                                  _probe=lambda t: False, _sleep=lambda s: None)
        assert exited["rc"] == 2
        d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert d["metric"] == "train_images_per_sec_per_chip"
        assert d["value"] is None and d["vs_baseline"] is None
        assert d["error"] == "device_unreachable"
        assert "3 liveness probes" in d["detail"]
        rec = d["last_verified"]["NVIDIA H100 80GB HBM3"]
        assert rec["value"] == 4321.0 and rec["timestamp_utc"] == "2026-10-17T19:48:00Z"

    def test_final_failure_without_history_still_parses(self, capsys, monkeypatch, tmp_path):
        exited = {}
        monkeypatch.setattr(bench.os, "_exit", lambda rc: exited.update(rc=rc))
        monkeypatch.setattr(bench, "LAST_VERIFIED_PATH", str(tmp_path / "missing.json"))
        bench.assert_device_alive(timeout_s=1.0, retries=2, backoff_s=5.0,
                                  _probe=lambda t: False, _sleep=lambda s: None)
        assert exited["rc"] == 2
        d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert d["error"] == "device_unreachable" and d["last_verified"] is None

    def test_success_records_last_verified(self, monkeypatch, tmp_path):
        last = tmp_path / "last.json"
        monkeypatch.setattr(bench, "LAST_VERIFIED_PATH", str(last))
        assert bench.record_last_verified({
            "value": 123.0, "unit": "images/sec/chip", "mfu": 0.3, "device": "NVIDIA H100",
            "config": {"preset": "mnist", "device": "cuda", "smoke": False}})
        d = json.loads(last.read_text())["NVIDIA H100"]
        assert d["value"] == 123.0 and d["config"]["preset"] == "mnist"
        assert "timestamp_utc" in d


def test_flop_counter_forward_is_the_closed_form_sum_over_the_convs():
    """``FlopCounterMode`` counts a forward's convolutions as
    ``2 Cin Cout kh kw Hout Wout B`` (a transposed conv over its input's
    ``H W``), summed over every conv the forward runs, hooked; the model
    has no linear layer."""
    cfg, data = bench.bench_config(_args("celeba64", "--smoke"))
    model = make_model(cfg, data, CPU, generator=torch.Generator().manual_seed(0), train=True)
    assert not any(isinstance(m, torch.nn.Linear) for m in model.modules())
    want = []

    def hook(m, inputs, out):
        x, = inputs
        cout, cin_g = (m.weight.shape[1], m.weight.shape[0]) \
            if isinstance(m, ConvTranspose2d) else m.weight.shape[:2]
        hw = x.shape[2] * x.shape[3] if isinstance(m, ConvTranspose2d) else \
            out.shape[2] * out.shape[3]
        want.append(2 * cin_g * cout * m.weight.shape[2] * m.weight.shape[3] * hw * x.shape[0])

    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.register_forward_hook(hook)
    x = torch.rand(4, *data.img_size, data.color_ch)
    with FlopCounterMode(display=False) as counter:
        model(x, noise=Noise(0, torch.arange(4), 0), train=True)
    assert len(want) > 20
    assert counter.get_total_flops() == sum(want)


def test_flops_per_image_same_at_fused_none_and_all_fp32_and_bf16(capsys):
    """The bench counts a plain step whatever ``--fused`` and
    ``--precision`` run: the same FLOPs an image."""
    got = {("all", "bf16"): bench.main([
        "--smoke", "--device", "cpu", "--steps", "1", "--warmup", "0", "--steps-per-call", "1",
        "--preset", "celeba64", "--fused", "all", "--precision", "bf16"])["flops_per_image"]}
    for fused, precision in (("none", "fp32"), ("all", "fp32"), ("none", "bf16")):
        cfg, data = bench.bench_config(_args("celeba64", "--smoke", "--fused", fused,
                                             "--precision", precision))
        exp = Experiment(cfg, CPU, data)
        got[fused, precision] = bench.count_flops(cfg, data, exp.train_data, exp.loss_cfg,
                                                  CPU) / cfg.batch_size
    assert len(set(got.values())) == 1, got


def test_index_stream_is_bench_pys():
    """``bench.py:291-298``'s rows: call ``i`` from ``i B``, step ``j`` of a
    call ``j B`` further, modulo the split."""
    calls = bench.index_stream(4, 10, 3, 2)
    np.testing.assert_array_equal(calls[0], [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 0, 1]])
    np.testing.assert_array_equal(calls[1][0], [4, 5, 6, 7])
    np.testing.assert_array_equal(bench.index_stream(4, 10, 1, 3)[2], [8, 9, 0, 1])


def test_device_peaks_by_name():
    assert bench.device_peaks("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    assert bench.device_peaks("NVIDIA H100 80GB HBM3")["fp32"] == 67e12
    assert bench.device_peaks("cpu") is None
