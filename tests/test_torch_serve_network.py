"""The resident session in PopPUNK's network mode
(``AssignSession(stable=None, use_full_network=True)``) against the port's
batch assignment (``assign_query_hdf5(use_full_network=True)``, the query
rows of its ``_clusters.csv``) and the benchmark's plain reference
(benchmark/network_reference.py), on the CPU.

The database is written by the port's own writers, as the network cell's
set-up writes one: 96 references of the port's seeded synthetic
population (K 3, 512-bin sketches), a BGMM K 2 fit on their pairs, the
network of the fit's within-strain pairs, and its clusters named by
``print_clusters``. One strain's references are cut in two by dropping the
network's edges between its halves, so a query of that strain bridges two
old clusters (a merge named "A_B"); the two smallest strains are absent
from the references, so their queries are novel lineages. Requests: a
bridge, both novel strains in one request with as many queries each (a
tie in size, broken by the first vertex), no novel query, a single
query, and one larger than the session's chunk of 8. The session answers
as the CLI does, bit for bit, and as the plain reference does; its
answers are the same with span recording on and off, and the spans'
counts add up. Once the session is open nothing it runs factors the
BGMM's covariances (torch.linalg's factoring calls made to raise), and
each dispatch counts whether it follows another of its request. On the
port's CLI-written databases of the conftest population, BGMM, refine,
threshold and DBSCAN fits answer as the CLI does too. On a card (tests
marked ``cuda``), dispatches whose queries have no within-strain
reference answer as on the CPU, and a dispatch's upload and enqueue
queue their work without a host synchronisation.
"""

import csv
import os

import numpy as np
import pytest
import torch

from benchmark import assign_reference, network_reference
from benchmark.drivers.assign_batch import sketches_from_planes
from poppunk_tpu_torch import profiling
from poppunk_tpu_torch.assign import assign_query_hdf5
from poppunk_tpu_torch.cli.assign import main as torch_assign
from poppunk_tpu_torch.cli.main import main as torch_main
from poppunk_tpu_torch.io.hdf5db import write_sketches
from poppunk_tpu_torch.models.bgmm import BGMMFit
from poppunk_tpu_torch.network.clusters import print_clusters
from poppunk_tpu_torch.network.construct import \
    construct_network_from_assignments
from poppunk_tpu_torch.network.graph import Graph, save_network
from poppunk_tpu_torch.ops.distances import pack_planes, query_db
from poppunk_tpu_torch.ops.fused_assign import model_post_spec
from poppunk_tpu_torch.serve import AssignSession
from poppunk_tpu_torch.synth import synthetic_population_device

CPU = torch.device("cpu")
KLIST = (13, 17, 21)
SS64 = 8  # 512 bins
BBITS = 14
N_REF = 96
CHUNK = 8
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


class NetDB:
    """The test database and the population behind it."""


@pytest.fixture(scope="module")
def netdb(tmp_path_factory):
    pop = synthetic_population_device(200, KLIST, SS64, BBITS, n_strains=8,
                                      seed=6, strain_alpha=1.0,
                                      core_div=(0.004, 0.01),
                                      strain_div=(0.02, 0.04), device=CPU)
    t = NetDB()
    t.planes = pop.planes_gm.numpy().view(np.uint32)
    t.lengths, t.freqs = pop.lengths.numpy(), pop.freqs.numpy()
    t.strain = pop.strain
    sizes = np.bincount(pop.strain)
    t.novel = [int(s) for s in np.argsort(sizes, kind="stable")[:2]]
    others = np.flatnonzero(~np.isin(pop.strain, t.novel))
    t.refs = np.sort(np.random.default_rng(3).choice(others, N_REF,
                                                     replace=False))
    t.pool = np.setdiff1d(np.arange(len(pop.strain)), t.refs)
    t.names = [f"ref{i:05d}" for i in range(N_REF)]
    t.db = str(tmp_path_factory.mktemp("network") / "db")
    t.base = os.path.join(t.db, "db")
    r_sketches = sketches_from_planes(
        t.planes[t.refs], t.lengths[t.refs], t.freqs[t.refs], t.names, KLIST,
        SS64)
    write_sketches(t.db, r_sketches)
    t.tr = torch.from_numpy(t.planes[t.refs].view(np.int32))
    rr = assign_reference.reference_distances(
        t.tr, t.tr, t.lengths[t.refs], t.lengths[t.refs], t.freqs[t.refs],
        t.freqs[t.refs], CFG)
    model = BGMMFit(t.db, seed=42, device=CPU)
    model.fit(rr[np.triu_indices(N_REF, 1)].astype(np.float32),
              max_components=2)
    model.save()
    _, classes = query_db(r_sketches, None, list(KLIST), self_mode=True,
                          post_spec=model_post_spec(model), device=CPU)
    G = construct_network_from_assignments(
        t.names, t.names, classes, within_label=model.within_label,
        summarise=False)
    # the largest strain's references cut in two halves: no edge between
    t.split = int(np.bincount(pop.strain[t.refs]).argmax())
    members = np.flatnonzero(pop.strain[t.refs] == t.split)
    half = np.zeros(N_REF, np.int8)
    half[members] = 1
    half[members[len(members) // 2:]] = 2
    e = G.edges
    cut = (half[e[:, 0]] > 0) & (half[e[:, 1]] > 0) & (
        half[e[:, 0]] != half[e[:, 1]])
    G = Graph(N_REF, e[~cut])
    save_network(G, prefix=t.db, suffix="_graph")
    print_clusters(G, t.names, out_prefix=t.base)
    t.queries = sketches_from_planes(
        t.planes[t.pool], t.lengths[t.pool], t.freqs[t.pool],
        [f"query{j:04d}" for j in range(len(t.pool))], KLIST, SS64)
    t.fit = assign_reference.Fit(t.base + "_fit.npz")
    # the plain reference over the same (cut) network, named by its own
    # rule, which print_clusters' file must agree with
    t.net = network_reference.Network(N_REF, G.edges)
    with open(t.base + "_clusters.csv") as f:
        assert {r["Taxon"]: r["Cluster"] for r in csv.DictReader(f)} == \
            dict(zip(t.names, t.net.names))
    return t


def session(t, chunk=CHUNK):
    return AssignSession(t.db, stable=None, use_full_network=True,
                         chunk=chunk, device=CPU)


def of_strain(t, s):
    return [j for j in range(len(t.pool)) if t.strain[t.pool[j]] == s]


def requests(t):
    """{case: pool indices of the request, in order}."""
    known = [j for j in range(len(t.pool))
             if t.strain[t.pool[j]] not in t.novel + [t.split]]
    a, b = (of_strain(t, s) for s in t.novel)
    bridge = of_strain(t, t.split)
    return {"bridge": known[:3] + bridge[:1] + known[3:5],
            "two_novel": [a[0]] + known[:2] + [b[0], a[1], b[1]],
            "no_novel": known[:6] + bridge[:2],
            "single": [a[0]],
            "larger_than_chunk": (known[:12] + a[:3] + bridge[:2]
                                  + b[:3])[::-1]}


CASES = ["bridge", "two_novel", "no_novel", "single", "larger_than_chunk"]


def cli(t, request, out):
    """The query rows of assign_query_hdf5's _clusters.csv for ``request``
    alone."""
    write_sketches(out, request)
    assign_query_hdf5(t.db, [s.name for s in request], out,
                      {"run_qc": False}, use_full_network=True,
                      dist_device=CPU, model_device=CPU)
    with open(os.path.join(out, os.path.basename(out) + "_clusters.csv")) \
            as f:
        return {r["Taxon"]: r["Cluster"] for r in csv.DictReader(f)}


def reference(t, idx):
    """The plain reference's answers of a request, and whether any of its
    pairs is unsure."""
    rows = t.pool[np.asarray(idx)]
    tq = torch.from_numpy(t.planes[rows].view(np.int32))
    d = assign_reference.reference_distances(
        tq, t.tr, t.lengths[rows], t.lengths[t.refs], t.freqs[rows],
        t.freqs[t.refs], CFG)
    within, unsure = network_reference.pair_classes(d, t.fit, CPU)
    nq = len(idx)
    qq = (np.zeros(0, int), np.zeros(0, int))
    unsure = unsure.any()
    if nq > 1 and not within.any(1).all():
        dq = assign_reference.reference_distances(
            tq, tq, t.lengths[rows], t.lengths[rows], t.freqs[rows],
            t.freqs[rows], CFG)
        w, u = network_reference.pair_classes(dq, t.fit, CPU)
        upper = np.triu(np.ones((nq, nq), bool), 1)
        qq = np.nonzero(w & upper)
        unsure = unsure or (u & upper).any()
    labels, names, _ = t.net.components(nq, np.nonzero(within), qq)
    return [names[labels[N_REF + i]] for i in range(nq)], unsure, d


@pytest.mark.parametrize("case", CASES)
def test_session_answers_as_the_cli_and_the_reference(netdb, case,
                                                      tmp_path):
    t = netdb
    idx = requests(t)[case]
    request = [t.queries[j] for j in idx]
    got = session(t).assign_sketches(request, with_nearest=True)
    assert list(got) == [s.name for s in request]
    assert {q: c for q, (c, _) in got.items()} == cli(t, request,
                                                      str(tmp_path / "q"))
    want, unsure, d = reference(t, idx)
    assert not unsure  # the comparison is exact here
    assert [got[s.name][0] for s in request] == want
    nearest = [t.names.index(got[s.name][1]) for s in request]
    assert np.all(d[np.arange(len(idx)), nearest, 0]
                  - d[..., 0].min(1) <= 1e-5)


def test_the_cases_hold_what_they_name(netdb):
    """A merge, two new numbers tied in size, none new, a single query and
    three dispatches, each where its case says."""
    t = netdb
    s = session(t)
    names = {}
    for case, idx in requests(t).items():
        names[case] = s.assign_sketches([t.queries[j] for j in idx])
    olds = set(t.net.old_order)
    assert any("_" in c for c in names["bridge"].values())
    novel = [names["two_novel"][t.queries[j].name]
             for j in requests(t)["two_novel"]]
    first = max(int(p) for c in olds for p in c.split("_")) + 1
    # a0, b0, a1, b1 at positions 0, 3, 4, 5: equal sizes, the later first
    # vertex (strain b's) ranks first and takes the first new number
    assert novel[0] == novel[4] == str(first + 1)
    assert novel[3] == novel[5] == str(first)
    assert {p for c in names["no_novel"].values()
            for p in c.split("_")} <= olds
    assert list(names["single"].values()) == [str(first)]
    assert len(names["larger_than_chunk"]) > 2 * CHUNK


def test_default_return_is_the_clusters(netdb):
    t = netdb
    request = [t.queries[j] for j in requests(t)["larger_than_chunk"]]
    s = session(t)
    plain = s.assign_sketches(request)
    both = s.assign_sketches(request, with_nearest=True)
    assert plain == {k: v[0] for k, v in both.items()}


def test_recording_changes_no_answer_and_spans_add_up(netdb, monkeypatch):
    t = netdb
    idx = requests(t)["larger_than_chunk"]
    request = [t.queries[j] for j in idx]
    s = session(t)
    off = s.assign_sketches(request, with_nearest=True)
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.clear()
    try:
        on = s.assign_sketches(request, with_nearest=True)
        spans = profiling.spans()
    finally:
        profiling.clear()
    assert on == off
    by = {}
    for x in spans:
        by.setdefault(x.name, []).append(x)
    (top,) = by["serve.assign"]
    nq = len(request)
    assert top.counts["queries"] == nq and top.counts["dispatches"] == 3
    attach = {x.index for x in by["serve.attach"]}
    fetched = [x for x in by["serve.edges"] if x.parent in attach]
    assert len(fetched) == 3
    assert sum(x.counts["edges"] for x in fetched) == top.counts["edges"]
    assert {x.counts["bytes"] for x in by["serve.edges"]} == {0}  # CPU
    novel = sum(t.strain[t.pool[j]] in t.novel for j in idx)
    assert top.counts["novel"] == novel > 0
    assert top.counts["qq_pairs"] == nq * (nq - 1) // 2
    (qq,) = by["serve.qq"]
    assert qq.counts["pairs"] == top.counts["qq_pairs"]
    assert qq.parent == top.index
    (net,) = by["serve.network"]
    answers = {c for c, _ in on.values()}
    assert net.counts["queries"] == nq
    assert net.counts["components"] == len(answers)
    assert net.counts["merges"] == sum("_" in c for c in answers) == 1
    assert net.counts["new"] == 2
    # a request with no novel query classifies no query pair
    s.assign_sketches([t.queries[j] for j in requests(t)["no_novel"]])


@pytest.mark.parametrize("size", [1, 33, 70])
def test_no_dispatch_factors_the_covariances(netdb, size, monkeypatch):
    """Once the session is open neither its dispatches nor its query-pair
    chunks factor the covariances: with torch.linalg's factoring calls
    made to raise, requests in ragged buckets of a chunk of 32 answer as
    the plain reference; each serve.dispatch counts follows 0 on a
    request's first bucket and 1 after it, and ahead 0 on the CPU."""
    t = netdb
    idx = list(np.random.default_rng(size).choice(len(t.pool), size,
                                                  replace=False))
    want, unsure, _ = reference(t, idx)
    assert not unsure  # the comparison is exact here
    s = session(t, chunk=32)
    for name in ("cholesky", "cholesky_ex", "solve_triangular"):
        monkeypatch.setattr(torch.linalg, name, refuse_factor)
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.clear()
    try:
        got = s.assign_sketches([t.queries[j] for j in idx])
        spans = profiling.spans()
    finally:
        profiling.clear()
    assert [got[t.queries[j].name] for j in idx] == want
    dispatch = sorted((x for x in spans if x.name == "serve.dispatch"),
                      key=lambda x: x.start)
    assert len(dispatch) == -(-size // 32)
    assert [x.counts["follows"] for x in dispatch] == \
        [0] + [1] * (len(dispatch) - 1)
    assert {x.counts["ahead"] for x in dispatch} == {0}
    if size > 1:  # the query pairs were classified too
        assert any(x.name == "serve.qq" for x in spans)


def refuse_factor(*args, **kwargs):
    raise AssertionError("a dispatch factored the covariances")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the session's count kernel has no "
                    "CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["single", "first_bucket_novel",
                                  "last_novel"])
def test_card_answers_dispatches_with_no_within_strain_pair(netdb, card,
                                                            case):
    """On the card a dispatch whose queries have no within-strain
    reference fetches no edge: a single novel query, a first bucket of
    novel queries alone, and a request of one query more than the chunk
    whose last query is novel answer as on the CPU."""
    t = netdb
    a = of_strain(t, t.novel[0])
    known = [j for j in range(len(t.pool))
             if t.strain[t.pool[j]] not in t.novel + [t.split]]
    idx, chunk = {"single": ([a[0]], CHUNK),
                  "first_bucket_novel": (a[:2] + known[:3], 2),
                  "last_novel": (known[:CHUNK] + [a[0]], CHUNK)}[case]
    request = [t.queries[j] for j in idx]
    want = session(t, chunk).assign_sketches(request)
    got = AssignSession(t.db, stable=None, use_full_network=True,
                        chunk=chunk, device=card).assign_sketches(
        request, with_nearest=True)
    assert {q: c for q, (c, _) in got.items()} == want
    _, _, d = reference(t, idx)
    nearest = [t.names.index(got[s.name][1]) for s in request]
    assert np.all(d[np.arange(len(idx)), nearest, 0]
                  - d[..., 0].min(1) <= 1e-5)


@pytest.mark.cuda
def test_the_enqueue_waits_for_nothing_on_the_card(netdb, card):
    """On a card a network-mode bucket's upload and fused dispatch (every
    pair classified, the within-strain pairs compacted) queue their work
    without one host synchronisation (torch's sync debug mode set to
    raise), and the dispatch's head equals the synchronous route's."""
    t = netdb
    s = AssignSession(t.db, stable=None, use_full_network=True, chunk=512,
                      device=card)
    s.warmup()
    request = t.queries
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        head, cols = s._enqueue(*s._upload(request, 512))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cols is not None
    planes, lengths, freqs = pack_planes(request, s.kmers)
    n, pad = len(request), 512 - len(request)
    want = s._dispatch(np.pad(planes, ((0, pad),) + ((0, 0),) * 3),
                       np.pad(lengths, (0, pad), constant_values=1),
                       np.pad(freqs, ((0, pad), (0, 0))))
    np.testing.assert_array_equal(head.cpu().numpy(), want)
    assert want[:n, 1].sum() > 0


def test_stable_none_needs_the_network(netdb, tmp_path):
    """Without a network file beside the model the session says so."""
    t = netdb
    bare = str(tmp_path / "bare")
    os.makedirs(bare)
    for ext in ("_fit.pkl", "_fit.npz", "_clusters.csv"):
        src = t.base + ext
        if os.path.isfile(src):
            with open(src, "rb") as f, open(
                    os.path.join(bare, "bare" + ext), "wb") as g:
                g.write(f.read())
    with pytest.raises(RuntimeError, match="network file"):
        AssignSession(t.db, model_dir=bare, stable=None, device=CPU)


KARGS = ["--min-k", "13", "--max-k", "25", "--k-step", "4",
         "--sketch-size", "2048", "--no-plot"]


@pytest.fixture(scope="module")
def fitted(population, population_dir, tmp_path_factory):
    """(database, {model: model directory}, query rfile): the port's CLI
    database of the conftest population (strains 0-2 less the iso0
    hold-outs; the queries the hold-outs and strain 3) with its BGMM fit,
    and refine, threshold and DBSCAN fits beside it."""
    d, _ = population_dir
    refs = [n for n in population.names
            if not n.startswith("strain3") and not n.endswith("iso0")]
    queries = [n for n in population.names if n not in refs]
    r_file = population.subset_rfile(d, refs, "network_refs.txt")
    q_file = population.subset_rfile(d, queries, "network_queries.txt")
    root = tmp_path_factory.mktemp("network_fits")
    db = str(root / "db")
    torch_main(["--create-db", "--r-files", r_file, "--output", db] + KARGS)
    torch_main(["--fit-model", "bgmm", "--ref-db", db, "--output", db,
                "--K", "2", "--no-plot"])
    fits = {"bgmm": db}
    for model, extra in (("refine", []), ("threshold", ["--threshold",
                                                        "0.02"]),
                         ("dbscan", [])):
        fits[model] = str(root / model)
        torch_main(["--fit-model", model, "--ref-db", db, "--model-dir", db,
                    "--output", fits[model], "--no-plot"] + extra)
    return db, fits, q_file


@pytest.mark.parametrize("model", ["bgmm", "refine", "threshold", "dbscan"])
def test_every_model_answers_as_the_cli(fitted, model, tmp_path):
    db, fits, q_file = fitted
    out = str(tmp_path / "cli")
    torch_assign(["--db", db, "--model-dir", fits[model], "--query", q_file,
                  "--output", out, "--use-full-network"])
    with open(os.path.join(out, "cli_clusters.csv")) as f:
        want = {r["Taxon"]: r["Cluster"] for r in csv.DictReader(f)}
    got = AssignSession(db, model_dir=fits[model], stable=None,
                        use_full_network=True,
                        device=CPU).assign_files(q_file)
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_print_clusters_names_as_the_jax_package(seed, tmp_path, capsys):
    """The port's print_clusters, naming through network/naming.py, against
    the JAX package's: the same clustering, merged queries, CSV bytes and
    reports, after an old clustering that splits and merges (names such as
    "4_9" among them), with samples it does not hold, and components of
    tied sizes. The unword names are drawn unseeded, so their file is
    compared with each word replaced by its order of first appearance."""
    from poppunk_tpu.network.clusters import print_clusters as jax_print
    from poppunk_tpu.network.graph import Graph as JaxGraph

    rng = np.random.default_rng(seed)
    n = 60
    names = [f"s{i:02d}" for i in rng.permutation(n)]
    group = rng.integers(0, 14, n)
    edges = np.array([(i, j) for i in range(n) for j in range(i + 1, n)
                      if group[i] == group[j] and rng.random() < 0.5])
    old_group = np.where(rng.random(n) < 0.8, rng.integers(0, 9, n), -1)
    labels = ["1", "2", "3", "4_9", "5", "7", "8", "10", "12"]
    old = tmp_path / "old_clusters.csv"
    with open(old, "w") as f:
        f.write("Taxon,Cluster\n")
        for i in rng.permutation(n):
            if old_group[i] >= 0:
                f.write(f"{names[i]},{labels[old_group[i]]}\n")
    got = {}
    for key, graph, fn in (("port", Graph, print_clusters),
                           ("jax", JaxGraph, jax_print)):
        out = tmp_path / key
        out.mkdir()
        prefix = str(out / key)
        result = fn(graph(n, edges), names, prefix, str(old),
                    print_ref=False)
        with open(prefix + "_clusters.csv", "rb") as f, open(
                prefix + "_unword_clusters.csv") as g:
            words = {}
            unwords = [(row[0], words.setdefault(row[1], len(words)))
                       for row in csv.reader(g)]
            got[key] = (result, f.read(), unwords, capsys.readouterr().err)
    assert got["port"] == got["jax"]
    assert "merged" in got["port"][3] and "split" in got["port"][3]
