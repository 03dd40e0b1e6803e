"""Typing against a reference database on disk: the port's resident
session (poppunk_tpu_torch.serve.AssignSession) against the benchmark's
plain reference of ``--stable core`` assignment
(benchmark/assign_reference.py), on the CPU.

The database is written by the port's own writers, as the typing cell's
set-up writes one: 96 references of the port's seeded synthetic population
(K 3, 512-bin sketches) through ``io/hdf5db.write_sketches``, a BGMM K 2
fit on their pairs saved by ``BGMMFit.save()``, and a ``_clusters.csv``
naming each reference's strain. The queries are the population's other
genomes, one strain among them wholly (absent from the references, so
"NA"). The session answers as the reference does (cluster or "NA", and the
nearest reference) in requests of 1, 7, 33 and 70 queries against a chunk
of 32 (ragged buckets); its default return is the clusters alone, as the
JAX package's session gives them; answers are the same with span recording
on and off; and each ``serve.*`` span carries its counters. Once the
session is open no dispatch factors the BGMM's covariances (torch.linalg's
factoring calls made to raise), and each dispatch counts whether it
follows another of its request. At the
default chunk of 512, requests of 1 to 1,100 queries packed bucket by
bucket into the session's reused buffers answer bit for bit as the whole
request packed into numpy and padded by ``np.pad`` did, a small request
after larger ones included; ``cuda``-marked tests check the page-locked
route's counters on the card, and that a dispatch's upload and enqueue
queue their work without a host synchronisation.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from benchmark import assign_reference
from benchmark.drivers.assign_batch import (sketches_from_planes,
                                            write_clusters)
from poppunk_tpu.serve import AssignSession as JaxSession
from poppunk_tpu_torch import profiling
from poppunk_tpu_torch.io.hdf5db import write_sketches
from poppunk_tpu_torch.models.bgmm import BGMMFit
from poppunk_tpu_torch.ops.distances import pack_planes
from poppunk_tpu_torch.serve import AssignSession
from poppunk_tpu_torch.synth import synthetic_population_device

CPU = torch.device("cpu")
KLIST = (13, 17, 21)
SS64 = 8  # 512 bins
BBITS = 14
N_REF = 96
CHUNK = 32
CFG = {"kmers": list(KLIST), "sketchsize64": SS64, "bbits": BBITS,
       "random_correct": True, "use_rc": True}


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, with span recording off."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        m.setattr(profiling, "_ENABLED", False)
        yield


@pytest.fixture(scope="module")
def typing(tmp_path_factory):
    """(database directory, query sketches, reference's answers, reference's
    float64 distances, the absent strain's queries)."""
    # divergences wide enough that 512 bins and K 3 resolve them: closer
    # strains leave most queries within 1e-4 of a tie or of the decision
    pop = synthetic_population_device(180, KLIST, SS64, BBITS, n_strains=8,
                                      seed=5, strain_alpha=1.0,
                                      core_div=(0.004, 0.01),
                                      strain_div=(0.02, 0.04), device=CPU)
    planes = pop.planes_gm.numpy().view(np.uint32)
    lengths, freqs = pop.lengths.numpy(), pop.freqs.numpy()
    sizes = np.bincount(pop.strain)
    absent = int(np.argmin(sizes))
    rng = np.random.default_rng(3)
    others = np.flatnonzero(pop.strain != absent)
    refs = np.sort(rng.choice(others, N_REF, replace=False))
    queries = np.setdiff1d(np.arange(len(pop.strain)), refs)

    db = str(tmp_path_factory.mktemp("typing") / "db")
    base = os.path.join(db, "db")
    names = [f"ref{i:05d}" for i in range(N_REF)]
    clusters = [str(s + 1) for s in pop.strain[refs]]
    write_sketches(db, sketches_from_planes(
        planes[refs], lengths[refs], freqs[refs], names, KLIST, SS64))
    tr = torch.from_numpy(planes[refs].view(np.int32))
    rr = assign_reference.reference_distances(
        tr, tr, lengths[refs], lengths[refs], freqs[refs], freqs[refs], CFG)
    iu = np.triu_indices(N_REF, 1)
    model = BGMMFit(db, seed=42, device=CPU)
    model.fit(rr[iu].astype(np.float32), max_components=2)
    model.save()
    write_clusters(base + "_clusters.csv", names, clusters)

    q_sketches = sketches_from_planes(
        planes[queries], lengths[queries], freqs[queries],
        [f"query{j:04d}" for j in range(len(queries))], KLIST, SS64)
    dists = assign_reference.reference_distances(
        torch.from_numpy(planes[queries].view(np.int32)), tr,
        lengths[queries], lengths[refs], freqs[queries], freqs[refs], CFG)
    fit = assign_reference.Fit(base + "_fit.npz")
    answer, nearest = assign_reference.answers(dists, fit, clusters)
    unsure = assign_reference.ambiguous(dists, fit, clusters)
    gone = [q.name for q, s in zip(q_sketches, pop.strain[queries])
            if s == absent]
    return db, q_sketches, (answer, nearest, unsure), dists, gone


def session(db):
    return AssignSession(db, stable="core", chunk=CHUNK, device=CPU)


def held_to_the_reference(s, typing, pick, got):
    """The answers ``got`` of the queries ``pick`` against the plain
    reference's."""
    _, queries, (answer, nearest, unsure), dists, _ = typing
    assert sorted(got) == sorted(queries[i].name for i in pick)
    for i in pick:
        cluster, ref = got[queries[i].name]
        chosen = s.r_names.index(ref)
        # the program's nearest is the reference's, or one float32 cannot
        # tell from it
        assert dists[i, chosen, 0] - dists[i, nearest[i], 0] <= 1e-5
        if not unsure[i]:
            assert cluster == answer[i]
            assert chosen == nearest[i]
    assert unsure.sum() <= len(unsure) // 8  # the comparison has teeth


@pytest.mark.parametrize("size", [1, 7, 33, 70])
def test_session_answers_as_the_reference(typing, size):
    db, queries, _, _, _ = typing
    s = session(db)
    assert s.r_names == [f"ref{i:05d}" for i in range(N_REF)]
    pick = np.random.default_rng(size).choice(len(queries), size,
                                              replace=False)
    got = s.assign_sketches([queries[i] for i in pick], with_nearest=True)
    held_to_the_reference(s, typing, pick, got)


def refuse_factors(monkeypatch):
    """Make every factoring call of torch.linalg raise."""
    def refused(*args, **kwargs):
        raise AssertionError("a dispatch factored the covariances")
    for name in ("cholesky", "cholesky_ex", "solve_triangular"):
        monkeypatch.setattr(torch.linalg, name, refused)


@pytest.mark.parametrize("size", [1, 33, 70])
def test_no_dispatch_factors_the_covariances(typing, size, monkeypatch):
    """Once the session is open its dispatches factor nothing: with
    torch.linalg's factoring calls made to raise, requests in ragged
    buckets answer as the reference; each serve.dispatch counts follows 0
    on a request's first bucket and 1 after it, and ahead 0 on the
    CPU."""
    db, queries, _, _, _ = typing
    s = session(db)
    refuse_factors(monkeypatch)
    pick = np.random.default_rng(size).choice(len(queries), size,
                                              replace=False)
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.clear()
    try:
        got = s.assign_sketches([queries[i] for i in pick],
                                with_nearest=True)
        spans = profiling.spans()
    finally:
        profiling.clear()
    held_to_the_reference(s, typing, pick, got)
    dispatch = sorted((x for x in spans if x.name == "serve.dispatch"),
                      key=lambda x: x.start)
    assert len(dispatch) == -(-size // CHUNK)
    assert [x.counts["follows"] for x in dispatch] == \
        [0] + [1] * (len(dispatch) - 1)
    assert {x.counts["ahead"] for x in dispatch} == {0}


def test_an_absent_strain_is_na(typing):
    db, queries, (answer, _, _), _, gone = typing
    assert gone
    by_name = {q.name: q for q in queries}
    got = session(db).assign_sketches([by_name[n] for n in gone])
    assert set(got.values()) == {"NA"}
    assert {answer[i] for i, q in enumerate(queries) if q.name in gone} \
        == {"NA"}
    # and the population is typed, not all "NA"
    assert len(set(answer) - {"NA"}) >= 3


def test_the_default_return_is_the_clusters(typing):
    db, queries, _, _, _ = typing
    s = session(db)
    plain = s.assign_sketches(queries)
    nearest = s.assign_sketches(queries, with_nearest=True)
    assert plain == {k: v[0] for k, v in nearest.items()}
    assert all(isinstance(v, str) for v in plain.values())
    assert JaxSession(db, stable="core",
                      chunk=CHUNK).assign_sketches(queries) == plain


def test_recording_changes_no_answer(typing, monkeypatch):
    db, queries, _, _, _ = typing
    s = session(db)
    off = s.assign_sketches(queries, with_nearest=True)
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.clear()
    try:
        on = s.assign_sketches(queries, with_nearest=True)
        assert any(x.name == "serve.assign" for x in profiling.spans())
    finally:
        profiling.clear()
    assert on == off


def test_serve_spans_count_the_request(typing, monkeypatch):
    db, queries, _, _, _ = typing
    s = session(db)
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.clear()
    try:
        s.assign_sketches(queries[:70])
        spans = profiling.spans()
    finally:
        profiling.clear()
    by = {}
    for x in spans:
        by.setdefault(x.name, []).append(x)
    (top,) = by["serve.assign"]
    assert top.parent is None
    assert {k: top.counts[k] for k in ("queries", "pairs", "dispatches")} \
        == {"queries": 70, "pairs": 70 * N_REF, "dispatches": 3}
    dispatch = sorted(by["serve.dispatch"], key=lambda x: x.start)
    assert [x.counts["rows"] for x in dispatch] == [32, 32, 8]
    assert [x.counts["pairs"] for x in dispatch] == [32 * N_REF, 32 * N_REF,
                                                     8 * N_REF]
    assert {x.parent for x in dispatch} == {top.index}
    # one pack a bucket, inside its dispatch; nothing page-locked here
    pack = sorted(by["dists.pack_planes"], key=lambda x: x.start)
    assert [x.parent for x in pack] == [x.index for x in dispatch]
    assert [x.counts["sketches"] for x in pack] == [32, 32, 6]
    assert {x.counts["staged"] for x in pack} == {0}
    upload = by["serve.upload"]
    assert sorted(x.parent for x in upload) == sorted(x.index
                                                      for x in dispatch)
    assert {x.counts["bytes"] for x in upload} == {0}  # nothing moved
    attach = sorted(by["serve.attach"], key=lambda x: x.start)
    assert [x.counts["queries"] for x in attach] == [32, 32, 6]
    assert {x.parent for x in attach} == {top.index}
    wait = by["serve.fetch_wait"]
    assert sorted(x.parent for x in wait) == sorted(x.index for x in attach)


def _old_assembly(s, request):
    """The answers of the assembly the session ran before it packed each
    bucket into its own buffers: the whole request packed into numpy,
    each bucket's rows padded by ``np.pad`` (lengths 1), one synchronous
    dispatch a bucket."""
    planes, lengths, freqs = pack_planes(request, s.kmers)
    out = {}
    for start in range(0, len(request), s.chunk):
        sl = slice(start, min(start + s.chunk, len(request)))
        n = sl.stop - sl.start
        pad = (1 << (n - 1).bit_length()) - n
        extra = s._dispatch(np.pad(planes[sl], ((0, pad),) + ((0, 0),) * 3),
                            np.pad(lengths[sl], (0, pad), constant_values=1),
                            np.pad(freqs[sl], ((0, pad), (0, 0))))
        for sk, (nn, within) in zip(request[sl], extra[:n]):
            nearest = s.r_names[int(nn)]
            out[sk.name] = (s.ref_clustering[nearest] if within else "NA",
                            nearest)
    return out


@pytest.fixture(scope="module")
def requests_1100(typing):
    """1,100 queries: the typing queries repeated under names of their own,
    in a seeded order."""
    _, queries, _, _, _ = typing
    pick = np.random.default_rng(11).integers(0, len(queries), 1100)
    return [dataclasses.replace(queries[i], name=f"q{j:05d}")
            for j, i in enumerate(pick)]


def test_staged_buckets_answer_as_the_old_assembly(typing, requests_1100):
    """Through one session at chunk 512, requests of 1,100, 3, 513, 1 and
    512 queries: each answer bit-equal to the old assembly's, and after a
    small request follows larger ones, the rows its bucket pads are zero
    (lengths 1) in the reused buffer, whatever they held before."""
    db = typing[0]
    s = AssignSession(db, stable="core", device=CPU)
    assert s.chunk == 512
    for size in (1100, 3, 513, 1, 512):
        request = requests_1100[:size]
        got = s.assign_sketches(request, with_nearest=True)
        assert got == _old_assembly(s, request)
        if size == 3:
            planes, lengths, freqs = s._views(s._buffers[1 - s._turn], 4)
            assert not planes[3:].any() and not freqs[3:].any()
            assert lengths[3:].tolist() == [1]
            assert planes[:3].any()


def test_staged_spans_count_each_bucket(typing, requests_1100, monkeypatch):
    """One dists.pack_planes a bucket, its sketches summing to the
    request, staged 0 on the CPU; answers equal with recording on."""
    db = typing[0]
    s = AssignSession(db, stable="core", device=CPU)
    off = s.assign_sketches(requests_1100, with_nearest=True)
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.clear()
    try:
        on = s.assign_sketches(requests_1100, with_nearest=True)
        spans = profiling.spans()
    finally:
        profiling.clear()
    assert on == off
    pack = [x for x in spans if x.name == "dists.pack_planes"]
    assert [x.counts["sketches"] for x in pack] == [512, 512, 76]
    assert {x.counts["staged"] for x in pack} == {0}
    assert [x.counts["rows"] for x in spans
            if x.name == "serve.dispatch"] == [512, 512, 128]


@pytest.mark.cuda
def test_staged_buckets_on_the_card(typing, requests_1100, monkeypatch):
    """On a card: every bucket packed into page-locked memory (staged its
    queries' bytes), each upload's bytes the padded bucket's planes,
    lengths and frequencies, and the answers those of the old assembly on
    the same card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    db = typing[0]
    card = AssignSession(db, stable="core", device=torch.device("cuda", 0))
    card.warmup()
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.clear()
    try:
        got = card.assign_sketches(requests_1100, with_nearest=True)
        spans = profiling.spans()
    finally:
        profiling.clear()
    row = len(KLIST) * BBITS * card.wp * 4
    assert [x.counts["staged"] for x in spans
            if x.name == "dists.pack_planes"] == [
        n * (row + 20) for n in (512, 512, 76)]
    assert [x.counts["bytes"] for x in spans if x.name == "serve.upload"] \
        == [b * (row + 4 + 16) for b in (512, 512, 128)]
    assert got == _old_assembly(card, requests_1100)


@pytest.mark.cuda
def test_the_enqueue_waits_for_nothing_on_the_card(typing, requests_1100):
    """On a card a bucket's upload and fused dispatch queue their work
    without one host synchronisation (torch's sync debug mode set to
    raise), and the dispatch's head equals the synchronous route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = AssignSession(typing[0], stable="core",
                         device=torch.device("cuda", 0))
    card.warmup()
    request = requests_1100[:512]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        head, cols = card._enqueue(*card._upload(request, 512))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cols is None
    want = card._dispatch(*pack_planes(request, card.kmers))
    np.testing.assert_array_equal(head.cpu().numpy(), want)
