"""The streaming tier's spans and counters (poppunk_tpu_torch/scale.py,
recorded by poppunk_tpu_torch/profiling.py) and the stream-pass cell's
reader of them (benchmark/stream_readers.py), on the CPU."""

import types

import numpy as np
import pytest
import torch

from benchmark import stream_readers
from benchmark.trace import Trace
from poppunk_tpu_torch import profiling
from poppunk_tpu_torch import scale as tsc
from poppunk_tpu_torch.ops import distances as td

N_REAL = 61
N_PAD = 64
CHUNK = 8
KLIST = (13, 17, 21)
SS64 = 2
BBITS = 4
SCALE_SPANS = ("scale.pass1", "scale.upload", "scale.tile", "scale.knn",
               "scale.fill", "scale.fetch")


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    """The port computes on the card unless asked for the CPU (_device.py);
    these tests ask for it, and start with an empty store, recording
    off."""
    monkeypatch.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(profiling, "_ENABLED", False)
    profiling.clear()
    yield
    profiling.clear()


def _population():
    """Plane-major planes of two planted strains, padded with zero genomes
    and pack_planes' pad metadata."""
    rng = np.random.default_rng(3)
    w32, wp, _ = tsc.plane_geometry(SS64, BBITS)
    base = rng.integers(0, 2 ** 32, (2, len(KLIST), BBITS, w32),
                        dtype=np.uint64).astype(np.uint32)
    planes = np.zeros((N_PAD, len(KLIST), BBITS, wp), np.uint32)
    flip = rng.random((N_REAL, len(KLIST), BBITS, w32)) < 0.02
    noise = rng.integers(0, 2 ** 32, flip.shape,
                         dtype=np.uint64).astype(np.uint32)
    planes[:N_REAL, ..., :w32] = np.where(flip, noise,
                                          base[np.arange(N_REAL) % 2])
    lengths = np.full(N_PAD, 2_000_000, np.int32)
    lengths[:N_REAL] = rng.integers(1_900_000, 2_100_000, N_REAL)
    freqs = np.full((N_PAD, 4), 0.25, np.float32)
    freqs[:N_REAL] = rng.dirichlet(np.full(4, 50.0), N_REAL)
    return (np.ascontiguousarray(planes.transpose(1, 2, 0, 3)), lengths,
            freqs)


def _spec():
    return dict(scale=np.array([0.5, 0.9]),
                offsets=np.linspace(0.0, 0.8, 40), slope=2,
                line=(0.05, 0.1, 0.6, 0.8), n_act=30, e_total=4000)


def _pass(fill=True, population=None, device=torch.device("cpu")):
    cd = tsc.StreamingCondensed(*(population or _population()), KLIST, SS64,
                                BBITS, chunk=CHUNK, knn=3, n_real=N_REAL,
                                defer=True, device=device)
    cd.run_pass1(_spec() if fill else None)
    return cd


def _ancestors(span, by_index):
    while span.parent is not None:
        span = by_index[span.parent]
        yield span.name


@pytest.mark.parametrize("fill", [True, False], ids=["fill", "plain"])
def test_spans_nest_under_pass1_and_count_the_work(monkeypatch, fill):
    monkeypatch.setattr(profiling, "_ENABLED", True)
    cd = _pass(fill)
    found = profiling.spans()
    by_index = {s.index: s for s in found}
    names = [s.name for s in found]
    (p1,) = [s for s in found if s.name == "scale.pass1"]
    assert p1.parent is None
    assert p1.counts["chunks"] == N_PAD // 2 // CHUNK
    assert p1.counts["pairs_needed"] == N_REAL * (N_REAL - 1) // 2
    (up,) = [s for s in found if s.name == "scale.upload"]
    assert up.parent is None and up.counts["bytes"] == 0  # on the CPU
    assert up.end <= p1.start
    for s in found:
        if s.name in ("scale.tile", "scale.knn", "scale.fill", "scale.fetch"):
            assert "scale.pass1" in _ancestors(s, by_index), s.name
    # two owned tiles a chunk from row s: its low rows against the genomes
    # from s on, its mirror rows against those from n_pad - s - CHUNK on
    tiles = [s.counts["pairs"] for s in found if s.name == "scale.tile"]
    starts = range(0, N_PAD // 2, CHUNK)
    assert tiles == [p for s in starts
                     for p in (CHUNK * (N_PAD - s), CHUNK * (s + CHUNK))]
    assert sum(tiles) == len(starts) * CHUNK * (N_PAD + CHUNK)
    assert names.count("scale.knn") == len(tiles)
    assert names.count("scale.fetch") == 1
    fills = [s.counts["pairs"] for s in found if s.name == "scale.fill"]
    if fill:
        edges, cum, _ = cd.pop_prefill()
        assert len(fills) == len(starts)
        assert sum(fills) == edges.count == cum[29] > 0
    else:
        assert fills == [] and cd.pop_prefill() is None


def test_recording_off_records_nothing_and_changes_nothing(monkeypatch):
    cd_off = _pass()
    assert profiling.spans() == []
    monkeypatch.setattr(profiling, "_ENABLED", True)
    cd_on = _pass()
    assert {s.name for s in profiling.spans()} == set(SCALE_SPANS)
    np.testing.assert_array_equal(cd_on.knn_col, cd_off.knn_col)
    assert cd_on.knn_dist.tobytes() == cd_off.knn_dist.tobytes()
    assert cd_on.max_scale().tobytes() == cd_off.max_scale().tobytes()
    (e_on, c_on, _), (e_off, c_off, _) = cd_on.pop_prefill(), \
        cd_off.pop_prefill()
    np.testing.assert_array_equal(c_on, c_off)
    for a, b in zip(e_on.fetch_prefix(e_on.count),
                    e_off.fetch_prefix(e_off.count)):
        np.testing.assert_array_equal(a, b)


def test_the_new_spans_are_documented():
    for name in SCALE_SPANS:
        assert name in profiling.__doc__


def _run(found, window, passes):
    trace = Trace([], window, None)
    run = types.SimpleNamespace(trace=trace, work={"passes": passes},
                                config={"n_genomes": N_REAL})
    return run, found


def test_pairs_per_needed_reads_the_window_tiles(monkeypatch):
    monkeypatch.setattr(profiling, "_ENABLED", True)
    _pass()
    found = profiling.spans()
    window = (min(s.start for s in found) - 1, max(s.end for s in found) + 1)
    run, _ = _run(found, window, 1)
    want = (N_PAD // 2 * (N_PAD + CHUNK)) / (N_REAL * (N_REAL - 1) / 2)
    assert stream_readers.pairs_per_needed(run) == pytest.approx(want)
    # no trace, no passes, or no tile in the window: nothing to read
    assert stream_readers.pairs_per_needed(
        types.SimpleNamespace(trace=None, work={"passes": 1},
                              config=run.config)) is None
    run.work = {}
    assert stream_readers.pairs_per_needed(run) is None
    late, _ = _run(found, (window[1] + 1, window[1] + 2), 1)
    assert stream_readers.pairs_per_needed(late) is None


def _upload_span(name, device):
    """The one ``name`` span of a stream pass 1 (scale.upload) or an
    all-vs-all call (dists.upload) from the host planes on ``device``,
    and the host bytes of its planes, lengths and frequencies."""
    planes, lengths, freqs = _population()
    if name == "scale.upload":
        _pass(population=(planes, lengths, freqs), device=device)
    else:
        planes = np.ascontiguousarray(planes.transpose(2, 0, 1, 3))
        td.condensed_self_block(planes, lengths, freqs, KLIST, SS64, BBITS,
                                chunk=CHUNK, device=device)
    (up,) = [s for s in profiling.spans() if s.name == name]
    return up, (planes.nbytes, planes.nbytes + lengths.nbytes + freqs.nbytes)


@pytest.mark.parametrize("name", ["scale.upload", "dists.upload"])
def test_uploads_count_the_staged_bytes(name, monkeypatch):
    """Both uploads carry ``staged``, the bytes that went through the
    page-locked slabs: none on the CPU, whose bytes stay 0, even past a
    slab."""
    monkeypatch.setattr(profiling, "_ENABLED", True)
    monkeypatch.setattr(td, "UPLOAD_SLAB", 1024)
    up, _ = _upload_span(name, torch.device("cpu"))
    assert up.counts["staged"] == 0 and up.counts["bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scale.upload", "dists.upload"])
def test_uploads_stage_the_planes_on_the_card(name, monkeypatch):
    """Past one slab the planes go through the slabs: ``staged`` counts
    them, ``bytes`` the planes, lengths and frequencies as before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(profiling, "_ENABLED", True)
    monkeypatch.setattr(td, "UPLOAD_SLAB", 40_000)
    up, (planes, moved) = _upload_span(name, torch.device("cuda", 0))
    assert planes > 2 * td.UPLOAD_SLAB
    assert up.counts["staged"] == planes and up.counts["bytes"] == moved


@pytest.mark.cuda
def test_pass1_from_staged_host_planes_equals_card_planes():
    """Pass 1 from host planes uploaded through the slabs (a ragged last
    one) equals pass 1 from the same planes already on the card: kNN,
    maxima, band count, offset histogram and every band edge in order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", 0)
    planes, lengths, freqs = _population()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(td, "UPLOAD_SLAB", 40_000)
        assert planes.nbytes % td.UPLOAD_SLAB and \
            td._upload(planes, card)[1] == planes.nbytes
        staged = _pass(population=(planes, lengths, freqs), device=card)
    resident = _pass(population=(td.planes_to_tensor(planes, card), lengths,
                                 freqs), device=card)
    np.testing.assert_array_equal(staged.knn_col, resident.knn_col)
    assert staged.knn_dist.tobytes() == resident.knn_dist.tobytes()
    assert staged.max_scale().tobytes() == resident.max_scale().tobytes()
    (e_s, c_s, _), (e_r, c_r, _) = staged.pop_prefill(), \
        resident.pop_prefill()
    assert e_s.count == e_r.count > 0
    np.testing.assert_array_equal(c_s, c_r)
    for a, b in zip(e_s.fetch_prefix(e_s.count),
                    e_r.fetch_prefix(e_r.count)):
        np.testing.assert_array_equal(a, b)
