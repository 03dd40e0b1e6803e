"""The port's span and counter recorder (poppunk_tpu_torch/profiling.py),
the distance engine's spans (ops/distances.py) and the benchmark's readers
of them (benchmark/program_spans.py, benchmark/metrics/), on the CPU."""

import io
import os
import resource
import subprocess
import sys
import time
import types
from collections import Counter, deque

import numpy as np
import pytest
import torch

from benchmark import program_spans
from benchmark import run as bench_run
from benchmark.trace import Trace
from poppunk_tpu_torch import profiling
from poppunk_tpu_torch.ops import distances as td

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KLIST = (15, 21)
SS64 = 2
BBITS = 3


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    """The port computes on the card unless asked for the CPU (_device.py);
    these tests ask for it, and start with an empty store, recording off."""
    monkeypatch.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(profiling, "_ENABLED", False)
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def recording(monkeypatch):
    monkeypatch.setattr(profiling, "_ENABLED", True)


def _population(n, seed=0):
    rng = np.random.default_rng(seed)
    w32, wp, _ = td.plane_geometry(SS64, BBITS)
    planes = np.zeros((n, len(KLIST), BBITS, wp), np.uint32)
    planes[..., :w32] = rng.integers(0, 2 ** 32, (n, len(KLIST), BBITS, w32),
                                     dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(4_000_000, 5_000_000, n).astype(np.int32)
    freqs = rng.dirichlet(np.full(4, 8.0), n).astype(np.float32)
    return planes, lengths, freqs


def _condensed(pop, chunk, jaccard=False):
    return td.condensed_self_block(*pop, KLIST, SS64, BBITS, jaccard=jaccard,
                                   chunk=chunk, device=torch.device("cpu"))


def _raise(*args, **kwargs):
    raise AssertionError("called while recording is off")


def test_recording_off_records_nothing_and_touches_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "resource",
                        types.SimpleNamespace(getrusage=_raise))
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter=_raise))
    monkeypatch.setattr(profiling, "_device_sync", _raise)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    monkeypatch.setattr(torch.cuda, "current_stream", _raise)
    assert not profiling.recording()
    assert profiling.span("x", bytes=1) is profiling.span("y")
    with profiling.stage("z", sync=True):
        with profiling.span("x") as sp:
            sp.add(bytes=5)
    out = _condensed(_population(70), 32)
    assert out.shape == (70 * 69 // 2, 2)
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_environment_turns_recording_on_and_reports_at_exit():
    code = ("from poppunk_tpu_torch import profiling\n"
            "assert profiling.recording()\n"
            "with profiling.stage('distances'):\n"
            "    with profiling.span('dists.upload', bytes=7):\n"
            "        pass\n"
            "    for ready in (1, 0, 1):\n"
            "        with profiling.span('dists.fetch_wait', ready=ready):\n"
            "            pass\n")
    env = {**os.environ, "POPPUNK_TPU_PROFILE": "1",
           "PYTHONPATH": ROOT}
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert "== poppunk_tpu_torch spans ==" in done.stderr
    rows = {line.split()[0]: line.split() for line in
            done.stderr.splitlines() if line.startswith("  dists.")}
    assert rows["dists.upload"][1] == "1" and rows["dists.upload"][-1] == "7"
    # the other counts follow the bytes, summed over the calls
    assert rows["dists.fetch_wait"][1] == "3"
    assert rows["dists.fetch_wait"][-2:] == ["0", "ready=2"]


def test_nested_spans_carry_parent_clock_and_counts(recording):
    t0 = time.perf_counter()
    with profiling.span("outer", bytes=1) as outer:
        with profiling.span("inner", pairs=2) as inner:
            inner.add(pairs=3, bytes=4)
        with profiling.span("inner"):
            time.sleep(0.002)
        outer.add(bytes=10)
    t1 = time.perf_counter()
    got = profiling.spans()
    assert [s.name for s in got] == ["inner", "inner", "outer"]
    first, second, top = got
    assert top.parent is None
    assert first.parent == second.parent == top.index
    for s in got:
        assert t0 <= s.start <= s.end <= t1
        assert s.counts["faults"] >= 0
    assert top.start <= first.start and second.end <= top.end
    assert first.counts["pairs"] == 5 and first.counts["bytes"] == 4
    assert top.counts["bytes"] == 11
    own = profiling.self_seconds(got)
    children = (first.end - first.start) + (second.end - second.start)
    assert own[top.index] == pytest.approx(top.end - top.start - children)
    assert own[second.index] == second.end - second.start


def test_faults_count_the_pages_touched(recording):
    with profiling.span("touch"):
        block = np.ones(64 << 20, np.uint8)  # 64 MiB, fresh pages
    del block
    (s,) = profiling.spans()
    # a kernel that counts minor faults has counted this process's many;
    # one that counts none (gVisor, for one) reports 0 throughout
    if resource.getrusage(resource.RUSAGE_SELF).ru_minflt:
        assert s.counts["faults"] >= (64 << 20) // (2 << 20)
    else:
        assert s.counts["faults"] == 0


def test_store_is_bounded_and_keeps_the_newest(recording, monkeypatch):
    monkeypatch.setattr(profiling, "_SPANS", deque(maxlen=4))
    for i in range(6):
        with profiling.span(f"s{i}"):
            pass
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4", "s5"]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_recording_follows_the_torch_profiler():
    assert not profiling.recording()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.recording()
        with profiling.span("under.profiler"):
            pass
    assert not profiling.recording()
    with profiling.span("after.profiler"):
        pass
    assert [s.name for s in profiling.spans()] == ["under.profiler"]


def _chunks(n, chunk):
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


@pytest.mark.parametrize("jaccard", [False, True])
def test_condensed_self_block_spans(jaccard, recording, monkeypatch):
    n, chunk = 300, 64
    pop = _population(n, seed=1)
    on = _condensed(pop, chunk, jaccard)
    got = profiling.spans()
    names = Counter(s.name for s in got)
    calls = -(-n // chunk)
    assert names == {"dists.condensed_self_block": 1, "dists.upload": 1,
                     "dists.enqueue": calls, "dists.fetch_wait": calls,
                     "dists.fetch_copy": calls, "dists.slice": calls,
                     "dists.concat": 1}
    (top,) = [s for s in got if s.name == "dists.condensed_self_block"]
    assert top.parent is None
    assert all(s.parent == top.index for s in got if s is not top)
    width = len(KLIST) if jaccard else 2

    def counted(name, key):
        return [s.counts[key] for s in got if s.name == name]

    assert counted("dists.enqueue", "pairs") == [
        (stop - start) * (n - start) for start, stop in _chunks(n, chunk)]
    assert counted("dists.fetch_copy", "bytes") == [
        (stop - start) * (n - start) * width * 4
        for start, stop in _chunks(n, chunk)]
    assert counted("dists.upload", "bytes") == [0]  # nothing leaves the CPU
    assert counted("dists.concat", "bytes") == [n * (n - 1) // 2 * width * 4]
    # the CPU's results are ready at once
    assert counted("dists.fetch_wait", "ready") == [1] * calls
    monkeypatch.setattr(profiling, "_ENABLED", False)
    off = _condensed(pop, chunk, jaccard)
    assert on.tobytes() == off.tobytes()


def test_pairwise_block_and_pack_planes_spans(recording):
    planes, lengths, freqs = _population(50, seed=2)
    sketches = [types.SimpleNamespace(
        sketchsize64=SS64, bbits=BBITS, length=int(lengths[i]),
        base_freq=freqs[i],
        usigs={k: np.arange(SS64 * BBITS, dtype=np.uint64) + i
               for k in KLIST}) for i in range(7)]
    td.pack_planes(sketches, list(KLIST))
    td.pairwise_block(planes[:20], planes, lengths[:20], lengths,
                      freqs[:20], freqs, KLIST, SS64, BBITS, chunk=8,
                      device=torch.device("cpu"))
    got = profiling.spans()
    names = Counter(s.name for s in got)
    assert names == {"dists.pack_planes": 1, "dists.upload": 2,
                     "dists.enqueue": 3, "dists.fetch_wait": 3,
                     "dists.fetch_copy": 3, "dists.concat": 1}
    assert [(s.counts["sketches"], s.counts["staged"]) for s in got
            if s.name == "dists.pack_planes"] == [(7, 0)]
    assert [s.counts["pairs"] for s in got if s.name == "dists.enqueue"] \
        == [8 * 50, 8 * 50, 4 * 50]


def test_stage_runs_on_the_recorder(recording, monkeypatch):
    syncs = []
    monkeypatch.setattr(profiling, "_device_sync", lambda: syncs.append(1))
    assert not hasattr(profiling, "_STAGES")
    for _ in range(2):
        with profiling.stage("distances", sync=True):
            with profiling.span("dists.upload", bytes=100):
                time.sleep(0.001)
            with profiling.span("dists.enqueue"):
                time.sleep(0.001)
    with profiling.stage("network"):
        time.sleep(0.001)
    assert len(syncs) == 4
    got = profiling.spans()
    rows, top = profiling.summary(got)
    assert list(rows) == ["distances", "dists.upload", "dists.enqueue",
                          "network"]
    assert rows["distances"][0] == 2 and rows["dists.upload"][4] == 200
    assert top == pytest.approx(rows["distances"][1] + rows["network"][1])
    assert rows["distances"][2] == pytest.approx(
        rows["distances"][1] - rows["dists.upload"][1]
        - rows["dists.enqueue"][1])
    # the self times share out the top-level total: no double count
    assert sum(r[2] for r in rows.values()) == pytest.approx(top)
    text = io.StringIO()
    profiling.report(text)
    lines = text.getvalue().splitlines()
    shares = [float(line.split()[4]) for line in lines
              if line.split() and line.split()[0] in rows]
    assert len(shares) == 4 and sum(shares) == pytest.approx(100.0, abs=0.3)
    assert any(line.split()[0] == "dists.upload" and line.split()[-1] == "200"
               for line in lines if line.split())


def _span(index, name, parent, start, end, **counts):
    return profiling.Span(index, name, parent, start, end,
                          {"faults": 0, **counts})


# window [10, 20]; pass A straddles its start, pass C its end
SYNTHETIC = [
    _span(1, "dists.upload", 0, 9.0, 9.5, bytes=1000),
    _span(2, "dists.fetch_copy", 0, 10.5, 11.0, bytes=500),
    _span(3, "dists.slice", 0, 11.0, 11.5),
    _span(4, "dists.concat", 0, 11.5, 12.0, bytes=40),
    _span(0, "dists.condensed_self_block", None, 9.0, 12.0, faults=100),
    _span(6, "dists.upload", 5, 12.5, 13.0, bytes=300),
    _span(7, "dists.fetch_copy", 5, 14.0, 15.0, bytes=700),
    _span(8, "dists.slice", 5, 15.0, 16.0),
    _span(9, "dists.concat", 5, 18.5, 19.0, bytes=40),
    _span(5, "dists.condensed_self_block", None, 12.5, 19.0, faults=200),
    _span(11, "dists.slice", 10, 19.8, 20.4),
    _span(10, "dists.condensed_self_block", None, 19.5, 22.0, faults=999),
]
N_GENOMES = 100


def _run(trace=True):
    events = [("match_counts_kernel", "kernel", 10.0, 11.0),
              ("Memcpy DtoH", "gpu_memcpy", 13.0, 14.0),
              ("late", "kernel", 21.0, 21.5)]
    return types.SimpleNamespace(
        trace=Trace(events, (10.0, 20.0), None) if trace else None,
        work={"passes": 2}, config={"n_genomes": N_GENOMES})


@pytest.mark.parametrize("name,want", [
    # slices and concatenations' own time in the window, C's slice clipped
    ("host.assembly_share.createdb", 100.0 * (0.5 + 0.5 + 1.0 + 0.5 + 0.2)
     / 10.0),
    # the passes whose midpoint lies in the window: A and B
    ("host.faults_per_pass.createdb", (100 + 200) / 2),
    # A's upload lies before the window
    ("transfer.bytes_per_pair.createdb",
     (500 + 300 + 700) / (2 * N_GENOMES * (N_GENOMES - 1) // 2)),
])
def test_readers_on_synthetic_spans(name, want, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SYNTHETIC))
    read = bench_run.load_reader(name)
    assert read(_run()) == pytest.approx(want)
    assert read(_run(trace=False)) is None


@pytest.mark.parametrize("name", ["host.assembly_share.createdb",
                                  "host.faults_per_pass.createdb",
                                  "transfer.bytes_per_pair.createdb"])
def test_readers_without_the_recorder(name, monkeypatch):
    read = bench_run.load_reader(name)
    assert read(_run()) is None  # a store with nothing in the window
    monkeypatch.delattr(profiling, "spans")  # a program before the recorder
    assert read(_run()) is None


def test_idle_time_by_innermost_span(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SYNTHETIC))
    run = _run()
    got = program_spans.idle_by_span(run)
    want = {"dists.slice": 0.5 + 1.0 + 0.2, "dists.concat": 0.5 + 0.5,
            "outside the program": 0.5 + 0.5,
            "dists.upload": 0.5, "dists.fetch_copy": 1.0,
            "dists.condensed_self_block": 2.5 + 0.3}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key])
    idle = run.trace.window_s - run.trace.busy_s()
    assert sum(got.values()) == pytest.approx(idle)
    assert program_spans.idle_by_span(_run(trace=False)) is None
