"""Tests of the benchmark itself, run apart from the repository's suite:

    python -m pytest portbench/tests -q            # on the CPU
    python -m pytest portbench/tests -q -m cuda    # on a CUDA card

A test marked ``cuda`` decides inside itself whether a card is there.
The tiny cell below keeps every CPU test to seconds."""

import copy
import json
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "name": "tiny",
    "data": {"img_size": [16, 16], "padded_size": [16, 16], "color_ch": 3,
             "preprocess": "dequantize", "likelihood": "discretized_logistic_mix"},
    "num_layers": 3,
    "downsample": [1, 0, 1],
    "model": {"z_dim": 4, "blocks_per_layer": 2, "n_filters": 8, "skip": True, "gated": True,
              "learn_top_prior": True},
    "train": {"batch_size": 4, "dropout": 0.2, "freebits": 0.5, "lr": 3e-4,
              "precision": "fp32"},
}
TINY_TRAFFIC = {
    "train": {"kind": "train", "steps_per_call": 4, "n_train": 32},
    "iwll": {"kind": "iwll", "batch": 4, "n_test": 16, "n_samples": 6, "chunk": 2,
             "logsumexp": "kernel", "warm_samples": 2, "n_check": 64,
             "head_scales": {"likelihood": 1.0, "gaussian": 0.5}},
}
# limits of the tiny CPU cells: the port's plain path reads 1e-7 to 7e-4
# against the reference here (fp32 on both sides)
TINY_LIMITS = {
    "train": {"loss_gap": 1e-5, "grad_norm_gap": 1e-4, "change_norm_gap": 1e-3,
              "replay_loss_gap": 1e-5, "replay_change_gap": 1e-3, "bn_stats_gap": 1e-4,
              "ema_gap": 1e-5},
    "iwll": {"iwll_gap": 1e-5},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips itself without one")


@pytest.fixture
def tiny_cell():
    """A tiny cell of the celeba64 architecture, as ``spec.load_cell``
    would give it, for a traffic kind."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    def make(kind: str) -> spec.Cell:
        name = f"celeba64.{kind}"
        return spec.Cell(name, 1, copy.deepcopy(TINY), dict(TINY_TRAFFIC[kind]),
                         dict(TINY_LIMITS[kind]),
                         [m for m in bench["end_to_end"] if spec._covers(m, name)],
                         [m for m in bench["per_layer"] if spec._covers(m, name)])
    return make
