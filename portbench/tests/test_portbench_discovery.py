"""A later cell, mix, configuration or metric is files and entries: a
dummy of each, added in a temporary copy, is found by name."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import spec
from portbench.tests.conftest import ROOT


@pytest.fixture
def copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert cell.traffic["kind"] in ("train", "iwll")
        assert cell.limits, f"{w['name']} has no limits file"
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))
            assert m["moves"] in names, (w["name"], m["name"])


def test_a_dummy_cell_mix_config_and_metric_are_found(copy):
    here = copy / "portbench"
    cfg = json.loads((here / "configs" / "celeba64.json").read_text())
    cfg["train"]["batch_size"] = 64
    (here / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (here / "traffic" / "train_long.json").write_text(
        json.dumps({"kind": "train", "steps_per_call": 16, "n_train": 8192}))
    (here / "limits" / "dummy.train_long.json").write_text(json.dumps({"loss_gap": 1.0}))
    (here / "metrics" / "dummy_share.train.py").write_text(
        "def read(ctx):\n    return 42.0 if ctx else None\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "https://example.org",
                             "file": "portbench/configs/dummy.json", "reduced": [],
                             "why": "a dummy"})
    bench["workloads"].append({"name": "dummy.train_long", "config": "dummy",
                               "traffic": "train_long", "chips": 1, "why": "a dummy"})
    bench["per_layer"].append({"name": "dummy_share.train", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "train_images_per_s",
                               "workloads": ["dummy.train_long"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("train_"):
            m["workloads"].append("dummy.train_long")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("dummy.train_long", copy, here)
    assert cell.config["train"]["batch_size"] == 64
    assert cell.traffic["steps_per_call"] == 16 and cell.limits == {"loss_gap": 1.0}
    assert {m["name"] for m in cell.end_to_end} == {"train_images_per_s",
                                                    "train_peak_mem_gib", "setup_s"}
    assert [m["name"] for m in cell.per_layer][-1] == "dummy_share.train"
    assert spec.reader("dummy_share.train", here)(True) == 42.0
    old = spec.load_cell("celeba64.train", copy, here)
    assert "dummy_share.train" not in {m["name"] for m in old.per_layer}
    with pytest.raises(KeyError):
        spec.load_cell("no.such", copy, here)


def test_a_metric_split_by_traffic_is_read_by_its_generic_reader(copy):
    here = copy / "portbench"
    (here / "metrics" / "dummy_rate.py").write_text(
        "def read(ctx):\n    return {'train': 1.0}.get(ctx.traffic['kind'])\n")
    (here / "metrics" / "dummy_rate.iwll.py").write_text("def read(ctx):\n    return 2.0\n")

    class Ctx:
        traffic = {"kind": "train"}

    assert spec.reader("dummy_rate.train", here)(Ctx) == 1.0
    assert spec.reader("dummy_rate.iwll", here)(Ctx) == 2.0      # its own file first
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.train", here)


def test_the_run_needs_a_card(copy):
    """No CUDA device here: the run exits 2 and prints no result; nor does
    a directory that holds only the benchmark (the program is absent)."""
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "celeba64.train",
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
    alone = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                            "celeba64.train", "--seed", "1", "--seconds", "1"],
                           cwd=copy, capture_output=True, text=True, timeout=300,
                           env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(copy)})
    assert alone.returncode != 0 and alone.stdout == ""
