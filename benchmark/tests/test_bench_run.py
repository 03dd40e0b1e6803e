"""Whole runs of the cell on the CPU at a tiny size: the look for a card
skipped, the rest of a run driven. A sound run comes out correct; each
fault the cell can have, planted in the timed path underneath, and the
controls (the reference in TF32 and bfloat16 in the program's place) come
out not correct."""

import json

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.drivers.passes import row_offset as run_offset

CREATEDB = "ecoli-10287-k5.createdb"


def _run(cell, tiny, cpu, capsys, seed=2 ** 31 + 3):
    code = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     "1", "--trace", "0"], device=cpu, overrides=tiny[cell])
    out = capsys.readouterr()
    assert code == 0, out.err
    record = json.loads(out.out.strip().splitlines()[-1])
    assert list(record)[-1] == "checks"
    # each number compared ends standard error beside its limit
    tail = out.err.strip().splitlines()[-len(record["checks"]):]
    assert [line.split(":")[0] for line in tail] == \
        [f"check {name}" for name in record["checks"]]
    return record


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 33 + 5])
def test_sound_run_is_correct(seed, tiny, cpu, capsys):
    record = _run(CREATEDB, tiny, cpu, capsys, seed)
    assert record["correct"] and record["failed"] == 0
    assert record["attempted"] >= 1
    assert "setup_s" in record["metrics"]


def _createdb_faults():
    import poppunk_tpu_torch.ops.distances as dmod

    original = dmod.condensed_self_block

    def altered(*args, **kwargs):  # answers altered where produced:
        out = original(*args, **kwargs)  # the rows of the second chunk
        n, chunk = len(args[0]), 64
        lo = run_offset(chunk, n)
        out[lo:run_offset(2 * chunk, n)] += 0.01
        return out

    def half(*args, **kwargs):  # half of the batch left out
        out = original(*args, **kwargs)
        return out[:len(out) // 2]

    return dmod, "condensed_self_block", {"altered": altered, "half": half}


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_fault_is_not_correct(fault, tiny, cpu, capsys, monkeypatch):
    target, name, faults = _createdb_faults()
    monkeypatch.setattr(target, name, faults[fault])
    record = _run(CREATEDB, tiny, cpu, capsys)
    assert not record["correct"]


def test_controls_are_not_correct(tiny, cpu):
    _, _, c, _, _ = run.load_cell(CREATEDB)
    limits = c["check"]
    got = control.readings(run, CREATEDB, 2 ** 31 + 9, 0,
                           ["tf32", "bfloat16"], device=cpu,
                           overrides=tiny[CREATEDB])
    assert all(got["program"][k] <= limits[k] for k in limits)
    for precision in ("tf32", "bfloat16"):
        assert any(got[precision][k] > limits[k] for k in limits)


def test_no_card_no_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "environment", lambda chips: None)
    code = run.main(["--workload", CREATEDB, "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert code != 0 and out.out == ""


def test_unknown_cell(capsys):
    assert run.main(["--workload", "nope", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_createdb_cell_on_the_card(tiny, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = run.main(["--workload", CREATEDB, "--seed", "5", "--seconds",
                     "1", "--trace", "1"], overrides=tiny[CREATEDB])
    out = capsys.readouterr()
    assert code == 0, out.err
    record = json.loads(out.out.strip().splitlines()[-1])
    assert record["correct"] and record["device"]["busy_s"] > 0
    assert np.isfinite(record["metrics"]["match_counts.roofline.createdb"]
                       ["value"])
