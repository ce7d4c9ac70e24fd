"""Finding a cell's files by the names in ``BENCHMARK.json``.

- ``configs/<config>.json``: the model, its data and its training flags;
- ``traffic/<mix>.json``: the mix's parameters, ``kind`` naming the loop
  of :mod:`portbench.drive` that reads them;
- ``limits/<cell>.json``: the limit of each number the output check
  compares (``null`` for a number that is read but not held);
- ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(ctx)`` that returns a number or None; a metric split by traffic,
  ``<name>.<part>``, without a file of its own is read by
  ``metrics/<name>.py``, which may branch on ``ctx.traffic["kind"]``.

A later cell, mix, configuration or metric is added as files and entries;
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, Optional[float]]
    end_to_end: List[dict]      # the metrics this cell reports untraced
    per_layer: List[dict]       # and traced


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files (looked up
    under ``here``, the benchmark's folder)."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; choose from {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    limits_path = here / "limits" / f"{name}.json"
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=_json(limits_path) if limits_path.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _covers(m, name)],
        per_layer=[m for m in bench["per_layer"] if _covers(m, name)])


def reader(metric: str, here: Path = HERE) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``, or where that is
    absent of ``metrics/<name>.py`` for a ``<name>.<part>`` (a file name may
    hold dots, so it is loaded by path)."""
    path = here / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = here / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
