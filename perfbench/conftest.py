"""pytest settings of the benchmark's tests (``perfbench/tests``).

Tests that need the card carry the ``card`` marker and take the
``cuda_card`` fixture, which skips them where torch finds no CUDA device.
Whether there is a card is decided inside the fixture, never while a
module is imported, so that every worker collects the same tests.
"""

import dataclasses
import json

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch finds none here")


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name, k, m, n)``: the cell of BENCHMARK.json with its
    generator cut to m x n and its traffic to k instances a call, for runs
    on the CPU."""
    from perfbench import spec

    def make(name: str, k: int = 2, m: int = 24, n: int = 48):
        cell = spec.cell(name)
        cfg = json.loads(json.dumps(cell.config))
        cfg["generator"].update(m=m, n=n)
        cfg["call"]["pad_multiple"] = 8
        return dataclasses.replace(cell, config=cfg, traffic=dict(cell.traffic, k=k))

    return make
