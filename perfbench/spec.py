"""Where the harness finds each piece, by the names in ``BENCHMARK.json``.

- a cell: its entry in ``BENCHMARK.json``'s ``workloads`` (configuration,
  traffic, chips);
- a configuration: ``perfbench/configs/<config>.json``;
- its instance generator: ``perfbench/generators/<name>.py``, a module
  with ``generate(k, seed0, **sizes)``;
- a traffic mix: ``perfbench/traffic/<traffic>.json``;
- the limits of a cell's comparison: ``perfbench/limits/<cell>.json``;
- a metric (end to end or per layer): ``perfbench/metrics/<metric>.py``,
  a module with ``read(run) -> float | None``;
- a kernel's operations and bytes: ``perfbench/roofline/<kernel>.py``.

A later change adds a cell, a configuration or a metric as new files and
entries; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

#: the benchmark's folder
HOME = Path(__file__).resolve().parent
#: the checkout's root, which holds BENCHMARK.json
ROOT = HOME.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the metrics of BENCHMARK.json this cell reports
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str) -> Cell:
    bench = benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    w = entries[name]
    config = _json(HOME / "configs" / f"{w['config']}.json")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=_json(HOME / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HOME / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def _module(folder: str, name: str):
    path = HOME / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"perfbench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generator(name: str):
    """The instance generator of a configuration: ``generate(k, seed0, **sizes)``."""
    return _module("generators", name)


def metric(name: str):
    """The reader module of a metric: ``read(run) -> float | None``."""
    return _module("metrics", name)


def roofline(kernel: str):
    """A kernel's operations and bytes: ``ops(...)``, ``nbytes(...)``."""
    return _module("roofline", kernel)
