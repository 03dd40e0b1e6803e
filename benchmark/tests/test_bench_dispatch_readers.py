"""The serving cells' ``serve.ahead_share.*`` readers on a synthetic
run's spans: 100 x the summed ``ahead`` over the summed ``follows`` of
the ``serve.dispatch`` spans whose midpoints lie in the traced window,
and None where no dispatch carries ``follows`` (a program that predates
the counter) or the run has no trace."""

from types import SimpleNamespace

import pytest

from benchmark import run as bench_run
from poppunk_tpu_torch import profiling

CELLS = ["assign-batch", "assign-network"]


def fake_run(monkeypatch, recorded, window=(10.0, 40.0)):
    """A traced run over ``window`` whose program recorded ``recorded``."""
    monkeypatch.setattr(profiling, "spans", lambda: list(recorded))
    return SimpleNamespace(trace=SimpleNamespace(
        window=window, window_s=window[1] - window[0]))


def dispatch(index, start, **counts):
    return profiling.Span(index, "serve.dispatch", None, start, start + 0.5,
                          {"rows": 512, "pairs": 512 * 20027, **counts})


@pytest.mark.parametrize("cell", CELLS)
def test_ahead_share_reads_ahead_over_follows(cell, monkeypatch):
    read = bench_run.load_reader("serve.ahead_share." + cell)
    spans = [
        dispatch(0, 11.0, follows=0, ahead=0),  # a request's first
        dispatch(1, 12.0, follows=1, ahead=1),
        dispatch(2, 13.0, follows=1, ahead=0),
        dispatch(3, 14.0, follows=1, ahead=1),
        dispatch(4, 15.0, follows=0, ahead=0),
        dispatch(5, 16.0, follows=1, ahead=1),
        # outside the window: not counted
        dispatch(6, 5.0, follows=1, ahead=0),
        dispatch(7, 45.0, follows=1, ahead=0),
        # another span's counters are not a dispatch's
        profiling.Span(8, "serve.attach", None, 17.0, 17.5,
                       {"queries": 512, "follows": 1}),
    ]
    assert read(fake_run(monkeypatch, spans)) == pytest.approx(
        100.0 * 3 / 4)


@pytest.mark.parametrize("cell", CELLS)
def test_ahead_share_is_none_without_the_counter(cell, monkeypatch):
    read = bench_run.load_reader("serve.ahead_share." + cell)
    older = [dispatch(i, 11.0 + i) for i in range(4)]
    assert read(fake_run(monkeypatch, older)) is None
    assert read(fake_run(monkeypatch, [])) is None
    # single-bucket requests alone: nothing follows
    first = [dispatch(i, 11.0 + i, follows=0, ahead=0) for i in range(3)]
    assert read(fake_run(monkeypatch, first)) is None
    assert read(SimpleNamespace(trace=None)) is None
