"""Whole runs of the network-mode cell on the CPU at a tiny size: the look
for a card skipped, the rest of a run driven (the database written,
fitted and its network built, the session opened and warmed, the
window's requests, the reference's check). A sound run comes out
correct; each fault the cell can have, planted in the session underneath,
comes out not correct on its own check; the bfloat16 control comes out
not correct; and a run loads neither JAX nor the JAX package.

The tiny cell's database is the driver's, with one strain's references cut
in two halves (the network's edges between them dropped before its
clusters are named, and the reference's own classes of those pairs read
between-strain alike, as if the fit had called them so), so that its
queries bridge two old clusters and merges are named; 48 strains over 208 genomes leave several strains
wholly in the query pool, novel lineages, some requests holding more than
one of them."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import control, network_reference, run
from benchmark.drivers import assign_network

CELL = "gps-20027-k6-network.assign-network"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKS = set(assign_network.CHECKS)


def small_cell():
    """The cell at 160 references and a pool of 48 queries of 48 strains,
    the configuration's K 6, 1,024-bin sketches, requests of 4-24 queries
    against a chunk of 8 (ragged buckets, several dispatches a request)."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "gps-20027-k6-network.json")) as f:
        cfg = json.load(f)
    return {"config": {"n_genomes": 160, "n_query_pool": 48,
                       "sketchsize64": 16,
                       "population": {**cfg["population"], "strains": 48},
                       "session": {**cfg["session"], "chunk": 8},
                       "fit": {**cfg["fit"], "model_subsample": 4000,
                               "chunk": 16}},
            "traffic": {"queries": [4, 24]}}


def split_strain(driver):
    """Rewrite the driver's database network with the largest strain's
    references cut in two halves, and name its clusters again. Returns
    each reference's half (0 outside the strain)."""
    from poppunk_tpu_torch.network.clusters import print_clusters
    from poppunk_tpu_torch.network.graph import Graph, save_network

    with np.load(driver.base + "_graph.graph.npz") as f:
        n, e = int(f["n_vertices"]), f["edges"]
    members = np.flatnonzero(driver.strain_refs
                             == np.bincount(driver.strain_refs).argmax())
    half = np.zeros(n, np.int8)
    half[members] = 1
    half[members[len(members) // 2:]] = 2
    cut = (half[e[:, 0]] > 0) & (half[e[:, 1]] > 0) & (
        half[e[:, 0]] != half[e[:, 1]])
    G = Graph(n, e[~cut])
    save_network(G, prefix=driver.db, suffix="_graph")
    print_clusters(G, driver.ref_names, out_prefix=driver.base)
    return half


def rewrite(driver, edges):
    """The driver's saved network with ``edges`` [m, 2] in place of its
    own, and its clusters named again."""
    from poppunk_tpu_torch.network.clusters import print_clusters
    from poppunk_tpu_torch.network.graph import Graph, save_network

    G = Graph(len(driver.ref_names), np.asarray(edges, np.int64))
    save_network(G, prefix=driver.db, suffix="_graph")
    print_clusters(G, driver.ref_names, out_prefix=driver.base)


def saved_edges(driver):
    with np.load(driver.base + "_graph.graph.npz") as f:
        return np.asarray(f["edges"], np.int64)


@pytest.fixture
def small(monkeypatch):
    """The small cell on the CPU, on two threads, its database holding a
    split strain."""
    monkeypatch.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
    write = assign_network.Driver.write_database
    base_pairs = network_reference.base_pairs
    halves = []

    def written(self, base):
        write(self, base)
        halves.append(split_strain(self))

    def split_pairs(*args):
        within, unsure = base_pairs(*args)
        a, b = halves[-1][within[:, 0]], halves[-1][within[:, 1]]
        return within[(a == 0) | (b == 0) | (a == b)], unsure
    monkeypatch.setattr(assign_network.Driver, "write_database", written)
    monkeypatch.setattr(network_reference, "base_pairs", split_pairs)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield small_cell()
    torch.set_num_threads(threads)


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
    return record, out.err


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 33 + 5])
def test_sound_run_is_correct(seed, small, capsys, monkeypatch):
    seen, top = [], []
    assign = assign_network.Driver.compare

    def compare(self, produced, ref):
        seen.extend(c for entries in (e for _, e in produced["requests"])
                    for _, c, _ in entries)
        top.append(self.max_old)
        return assign(self, produced, ref)
    monkeypatch.setattr(assign_network.Driver, "compare", compare)
    record, err = _run(small, capsys, seed)
    assert record["correct"] and record["failed"] == 0
    assert record["attempted"] >= 2
    assert set(record["metrics"]) == {"createdb_pairs_per_s", "setup_s"}
    assert set(record["checks"]) == CHECKS
    # the checked answers hold merges and new numbers
    assert any("_" in c for c in seen)
    assert any(c.isdigit() and int(c) > top[0] for c in seen)
    # the notes say how the reference's database was made and what it
    # left unchecked
    assert "reference database:" in err and "database_wrong 0" in err
    assert "checked answers:" in err


def _faults(monkeypatch):
    from poppunk_tpu_torch.network import naming, resident
    from poppunk_tpu_torch.ops import fused_assign

    network_assign = resident.ResidentNetwork.assign

    def edge_dropped():  # each request's first attached query cut loose
        def dropped(self, q_names, qr, qq):
            q, r = qr
            keep = q != q[0] if len(q) else q == q
            return network_assign(self, q_names, (q[keep], r[keep]), qq)
        monkeypatch.setattr(resident.ResidentNetwork, "assign", dropped)

    def merge_swapped():  # a merge named in the reverse order
        name = naming.ClusterNamer.name

        def swapped(self, joins, n_old):
            cls_id, partial = name(self, joins, n_old)
            if partial:
                cls_id = "_".join(reversed(cls_id.split("_")))
            return cls_id, partial
        monkeypatch.setattr(naming.ClusterNamer, "name", swapped)

    def novel_named_old():  # a novel lineage given an old name
        def named(self, q_names, qr, qq):
            got, counts = network_assign(self, q_names, qr, qq)
            old = next(iter(self.namer.order))
            return {q: old if c.isdigit() and int(c) >= self.namer.new_id
                    else c for q, c in got.items()}, counts
        monkeypatch.setattr(resident.ResidentNetwork, "assign", named)

    def novel_shared():  # every novel lineage of a request one number
        def shared(self, q_names, qr, qq):
            got, counts = network_assign(self, q_names, qr, qq)
            first = str(self.namer.new_id)
            return {q: first if c.isdigit() and int(c) >= self.namer.new_id
                    else c for q, c in got.items()}, counts
        monkeypatch.setattr(resident.ResidentNetwork, "assign", shared)

    def request_dropped():  # the second request's answers left out
        from poppunk_tpu_torch.serve import AssignSession

        assign = AssignSession.assign_sketches
        calls = []

        def dropped(self, sketches, with_nearest=False):
            calls.append(1)
            got = assign(self, sketches, with_nearest)
            return {} if len(calls) == 2 else got
        monkeypatch.setattr(AssignSession, "assign_sketches", dropped)

    def second_nearest():  # the second-nearest reference returned
        post = fused_assign._post_edges

        def second(dists, params, static):
            head, cols = post(dists, params, static)
            nn = dists[..., 0].argsort(dim=-1, stable=True)[..., 1]
            return torch.stack([nn.to(torch.int32), head[:, 1]], -1), cols
        monkeypatch.setitem(fused_assign.POST_FNS, "edges", second)

    def database_joined():  # the saved network joins two strains
        write = assign_network.Driver.write_database

        def joined(self, base):
            write(self, base)
            s = self.strain_refs
            other = int(np.flatnonzero(s != s[0])[0])
            rewrite(self, np.concatenate([saved_edges(self), [[0, other]]]))
        monkeypatch.setattr(assign_network.Driver, "write_database", joined)

    def database_misnamed():  # two clusters' names swapped in the file
        write = assign_network.Driver.write_database

        def misnamed(self, base):
            write(self, base)
            path = base + "_clusters.csv"
            with open(path) as f:
                text = f.read()
            with open(path, "w") as f:
                f.write(text.replace(",1\n", ",x\n").replace(
                    ",2\n", ",1\n").replace(",x\n", ",2\n"))
        monkeypatch.setattr(assign_network.Driver, "write_database",
                            misnamed)

    return {"edge_dropped": (edge_dropped, "label_wrong"),
            "merge_swapped": (merge_swapped, "label_wrong"),
            "novel_named_old": (novel_named_old, "strain_wrong"),
            "novel_shared": (novel_shared, "strain_wrong"),
            "request_dropped": (request_dropped, "answers_missing"),
            "second_nearest": (second_nearest, "nn_gap"),
            "database_joined": (database_joined, "database_wrong"),
            "database_misnamed": (database_misnamed, "database_wrong")}


@pytest.mark.parametrize("fault", ["edge_dropped", "merge_swapped",
                                   "novel_named_old", "novel_shared",
                                   "request_dropped", "second_nearest",
                                   "database_joined", "database_misnamed"])
def test_fault_is_not_correct(fault, small, capsys, monkeypatch):
    plant, check = _faults(monkeypatch)[fault]
    plant()
    record, _ = _run(small, capsys)
    assert not record["correct"]
    got = record["checks"][check]
    assert got["value"] > got["limit"]


def test_bfloat16_control_is_not_correct(small):
    _, _, c, _, _ = run.load_cell(CELL)
    limits = c["check"]
    got = control.readings(run, CELL, 2 ** 31 + 9, 0, ["bfloat16"],
                           device="cpu", overrides=small)
    assert all(got["program"][k] <= limits[k] for k in limits)
    assert any(got["bfloat16"][k] > limits[k] for k in limits)


RUN_ALONE = """
import json, sys, torch
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.tests.test_bench_assign_network import CELL, small_cell
code = run.main(["--workload", CELL, "--seed", "5", "--seconds", "0.5",
                 "--trace", "0"], device=torch.device("cpu"),
                overrides=small_cell())
loaded = sorted({{m.split(".")[0] for m in sys.modules}}
                & {{"jax", "jaxlib", "flax", "poppunk_tpu"}})
print(json.dumps([code, loaded]))
"""


def test_a_run_loads_no_jax():
    env = {**os.environ, "POPPUNK_TPU_TORCH_DEVICE": "cpu",
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", RUN_ALONE.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [0, []]
