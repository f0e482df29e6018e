"""The command itself: no result without a card, or without the port;
one short run of a cell on the card."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench import run as run_mod
from perfbench import spec


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", "lp_normal.sweep8", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_alone_in_a_directory_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HOME, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    cmd = json.loads((tmp_path / "BENCHMARK.json").read_text())["command"]
    proc = subprocess.run([sys.executable, *cmd[1:], "--workload", "qp_k1.sweep8", "--seed", "3",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.card
def test_short_run_on_the_card(cuda_card):
    cmd = spec.benchmark()["command"]
    proc = subprocess.run([sys.executable, *cmd[1:], "--workload", "lp_normal.sweep8",
                           "--seed", str(2**31 + 4242), "--seconds", "3", "--trace", "0"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"solved_per_s", "solve_p95_s", "setup_s"}
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "checks"
