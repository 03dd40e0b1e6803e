"""The run's check for JAX and the JAX package compares top-level module
names whole."""

import sys
import types

import pytest

from benchmark import run


@pytest.mark.parametrize("name, flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax", True), ("poppunk_tpu", True), ("poppunk_tpu.ops", True),
    ("poppunk_tpu_torch", False), ("poppunk_tpu_torch.ops", False),
    ("jaxtyping", False), ("flaxen", False)])
def test_forbidden_modules_whole_names(monkeypatch, name, flagged):
    for known in list(sys.modules):
        if known.split(".", 1)[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, known)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (run.forbidden_modules() == [name.split(".")[0]]) is flagged
