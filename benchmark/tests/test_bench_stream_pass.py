"""Whole runs of the stream-pass cell on the CPU at a tiny size: the look
for a card skipped, the rest of a run driven. A sound run comes out
correct; each fault the cell can have, planted in the timed path
underneath, and the controls (the reference in TF32 and bfloat16 in the
program's place) come out not correct."""

import json
import os

import pytest
import torch

from benchmark import control, run

CELL = "gps-20027-k6.stream-pass"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHUNK = 64


@pytest.fixture
def small(monkeypatch):
    """The cell at 601 genomes of 60 strains (padded to 640: five folded
    chunks of 64 rows), sketchsize64 8, on the CPU."""
    monkeypatch.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "gps-20027-k6.json")) as f:
        pop = json.load(f)["population"]
    return {"config": {"n_genomes": 601, "sketchsize64": 8,
                       "population": {**pop, "strains": 60}},
            "traffic": {"chunk": CHUNK}}


def _run(small, capsys, seed=2 ** 31 + 3):
    code = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                     "1", "--trace", "0"], device=torch.device("cpu"),
                    overrides=small)
    out = capsys.readouterr()
    assert code == 0, out.err
    record = json.loads(out.out.strip().splitlines()[-1])
    tail = out.err.strip().splitlines()[-len(record["checks"]):]
    assert [line.split(":")[0] for line in tail] == \
        [f"check {name}" for name in record["checks"]]
    return record


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 33 + 5])
def test_sound_run_is_correct(seed, small, capsys):
    record = _run(small, capsys, seed)
    assert record["correct"] and record["failed"] == 0
    assert record["attempted"] >= 1
    assert set(record["metrics"]) == {"createdb_pairs_per_s", "setup_s"}
    assert set(record["checks"]) == {"knn_gap", "knn_wrong", "band_wrong",
                                     "fill_overflow", "maxima_short",
                                     "pass_drift"}


def _faults(monkeypatch):
    import poppunk_tpu_torch.scale as sc
    from poppunk_tpu_torch.ops.sparse_sweep import SweepEdges

    fold_knn_rows, fold_block = sc._fold_knn_rows, sc._fold_block
    pop_prefill = sc.StreamingCondensed.pop_prefill

    def knn_altered():  # the second chunk's kNN distances moved
        def altered(ki, kd, off, c, top_i, top_d):
            fold_knn_rows(ki, kd, off, c, top_i,
                          top_d + 0.01 if off == c else top_d)
        monkeypatch.setattr(sc, "_fold_knn_rows", altered)

    def edge_dropped():  # genome 0's first in-band edge left out
        def dropped(self):
            got = pop_prefill(self)
            if got is None:
                return got
            e, cum, spec = got
            k = int(torch.nonzero((e.i == 0) | (e.j == 0))[0])
            keep = torch.cat([torch.arange(k), torch.arange(k + 1, e.count)])
            return (SweepEdges(e.i[keep], e.j[keep], e.d0[keep], e.count - 1,
                               e.n, e.n_real), cum, spec)
        monkeypatch.setattr(sc.StreamingCondensed, "pop_prefill", dropped)

    def chunk_skipped():  # the second chunk's work replaced by the first's
        def skipped(planes, lengths, freqs, s, c, *args, **kwargs):
            return fold_block(planes, lengths, freqs, 0 if s == c else s, c,
                              *args, **kwargs)
        monkeypatch.setattr(sc, "_fold_block", skipped)

    def prefill_discarded():
        monkeypatch.setattr(sc.StreamingCondensed, "pop_prefill",
                            lambda self: None)

    return {"knn_altered": knn_altered, "edge_dropped": edge_dropped,
            "chunk_skipped": chunk_skipped,
            "prefill_discarded": prefill_discarded}


@pytest.mark.parametrize("fault", ["knn_altered", "edge_dropped",
                                   "chunk_skipped", "prefill_discarded"])
def test_fault_is_not_correct(fault, small, capsys, monkeypatch):
    _faults(monkeypatch)[fault]()
    record = _run(small, capsys)
    assert not record["correct"]


def test_controls_are_not_correct(small):
    _, _, c, _, _ = run.load_cell(CELL)
    limits = c["check"]
    got = control.readings(run, CELL, 2 ** 31 + 9, 0, ["tf32", "bfloat16"],
                           device="cpu", overrides=small)
    assert all(got["program"][k] <= limits[k] for k in limits)
    for precision in ("tf32", "bfloat16"):
        assert any(got[precision][k] > limits[k] for k in limits)
