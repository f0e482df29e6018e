"""BENCHMARK.json against the contract's shape, and every cell resolved
to its files: configuration, traffic, limits, one reader per metric."""

import json
import re
from pathlib import Path

import pytest

from perfbench import spec
from perfbench.reference import judge

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.cell(cell)
    assert c.chips == 1
    assert set(c.traffic) == {"k"} and c.traffic["k"] >= 1
    assert set(c.limits) == set(judge.NUMBERS)
    names = {m["name"] for m in c.end_to_end}
    assert {"setup_s", "solved_per_s", "solve_p95_s"} <= names
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric(m["name"]).read)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_entry(metric):
    m = next(x for x in METRICS if x["name"] == metric)
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
    if m["unit"] == "%" and m["name"].endswith("_roofline"):
        assert m["better"] == "higher"


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    path = spec.ROOT / entry["file"]
    assert path.parts[len(spec.ROOT.parts)] == "perfbench"
    cfg = json.loads(path.read_text())
    assert cfg["name"] == config and cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"] and len(entry["source"]) <= 200
    assert any(w["config"] == config for w in BENCH["workloads"])
    assert {"generator", "call", "options", "control", "assumed"} <= set(cfg)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_generator_resolves(config):
    cfg = spec.cell(next(w["name"] for w in BENCH["workloads"] if w["config"] == config)).config
    assert (spec.HOME / "generators" / f"{cfg['generator']['name']}.py").is_file()
    assert callable(spec.generator(cfg["generator"]["name"]).generate)


def test_names_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_command_stays_in_paths():
    cmd = BENCH["command"]
    assert len(cmd) <= 32
    assert not any(w.startswith("/") or ".." in Path(w).parts for w in cmd)
