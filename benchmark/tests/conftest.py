"""Shared set-up of the benchmark's CPU tests: a tiny version of the
cell, run on the CPU with the program's plain kernels."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def tiny():
    """{cell: overrides} shrinking each cell to a CPU test's size."""
    e = _config("ecoli-10287-k5")["population"]
    return {
        "ecoli-10287-k5.createdb": {
            "config": {"n_genomes": 160, "population": {**e, "strains": 8}},
            "traffic": {"chunk": 64}},
    }
