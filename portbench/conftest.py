"""Fixtures of the benchmark's own tests: cells of BENCHMARK.json cut to
a size this CPU runs in seconds (the rows, the batch and the query
pool; every width as configured)."""

import copy
import dataclasses
import os
import sys

import pytest

PB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB)
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.append(p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels have no CPU "
        "mode); skips without one")


@pytest.fixture(scope="session")
def tiny_cell():
    """make(name, n=..., batch=...): the cell `name` at `n` rows and
    `batch` queries a batch, its pool and profiled stretch cut to
    match."""
    from portbench.harness.cell import load_cell

    def make(name, n=1500, batch=32):
        cell = load_cell(ROOT, name)
        cfg = copy.deepcopy(cell.config)
        cfg["data"]["n"] = n
        tr = dict(cell.traffic, batch=batch, pool_mb=1, profile_s=0.3)
        return dataclasses.replace(cell, config=cfg, traffic=tr)

    return make
