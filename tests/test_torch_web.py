"""The port's web / BeeBOP glue (poppunk_tpu_torch.web) against the JAX
package's, on the CPU: the JSON sketch <-> HDF5 round trip, the graphml
subgraph JSON, cluster prevalence summaries, the legacy microreact POST
(monkeypatched) and the ``poppunk_tpu_torch_api`` flow, each on the same
inputs as the JAX package's and giving the same outputs."""

import json
import os

import numpy as np
import pytest
import torch

from poppunk_tpu import web as jax_web
from poppunk_tpu.cli.main import main as jax_main
from poppunk_tpu.io.hdf5db import read_sketches as jax_read_sketches
from poppunk_tpu_torch import web
from poppunk_tpu_torch.io.hdf5db import read_sketches

torch.set_num_threads(2)

KARGS = ["--min-k", "13", "--max-k", "25", "--k-step", "4",
         "--sketch-size", "2048", "--no-plot"]
DIST_TOL = dict(rtol=1e-5, atol=2e-5)  # tests/test_torch_distances.py


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, as a CPU-only host must."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


def small_sketches():
    from poppunk_tpu_torch.sketch.minhash import SketchParams, sketch_sequence

    rng = np.random.default_rng(5)
    params = SketchParams(klist=(15, 19), sketchsize64=8, bbits=8)
    return [sketch_sequence(f"s{i}",
                            rng.integers(0, 4, 30000).astype(np.uint8),
                            params)
            for i in range(3)]


def test_sketch_json_hdf5_round_trip_equals_the_jax_package(tmp_path):
    from poppunk_tpu.ops.distances import query_db as jax_query_db
    from poppunk_tpu_torch.ops.distances import query_db

    sketches = small_sketches()
    doc = {sk.name: json.dumps(web.sketch_to_json(sk)) for sk in sketches}
    assert doc == {sk.name: json.dumps(jax_web.sketch_to_json(sk))
                   for sk in sketches}
    out, jax_out = str(tmp_path / "webdb"), str(tmp_path / "jaxdb")
    q_names = web.sketch_to_hdf5(doc, out)
    assert q_names == jax_web.sketch_to_hdf5(doc, jax_out)
    rebuilt = read_sketches(out, q_names)
    for orig, new, jax_new in zip(sketches, rebuilt,
                                  jax_read_sketches(jax_out, q_names)):
        assert orig.length == new.length == jax_new.length
        for k in orig.usigs:
            assert np.array_equal(orig.usigs[k], new.usigs[k])
            assert np.array_equal(jax_new.usigs[k], new.usigs[k])
    want = jax_query_db(sketches, None, [15, 19], self_mode=True,
                        use_pallas=False)
    got = query_db(rebuilt, None, [15, 19], self_mode=True)
    np.testing.assert_allclose(got, np.asarray(want), **DIST_TOL)


def test_graphml_to_json_equals_the_jax_package(tmp_path):
    from poppunk_tpu_torch.network.graph import Graph, save_network

    G = Graph(6, [(0, 1), (1, 2), (3, 4), (4, 5), (3, 5)])
    labels = [f"iso{i}" for i in range(6)]
    out = str(tmp_path / "net")
    save_network(G, prefix=out, suffix="_cytoscape", use_graphml=True,
                 vertex_labels=labels)
    doc = web.graphml_to_json(out)
    # the component of the last vertex: {3, 4, 5}
    assert {n["data"]["label"] for n in doc["elements"]["nodes"]} == \
        {"iso3", "iso4", "iso5"}
    assert len(doc["elements"]["edges"]) == 3
    with open(os.path.join(out, "subgraph.graphml")) as f:
        subgraph = f.read()
    assert doc == jax_web.graphml_to_json(out)
    with open(os.path.join(out, "subgraph.graphml")) as f:
        assert f.read() == subgraph


def test_summarise_clusters_equals_the_jax_package(tmp_path):
    out = str(tmp_path / "sum")
    os.makedirs(out)
    with open(os.path.join(out, "sum_clusters.csv"), "w") as f:
        f.write("Taxon,Cluster\n")
        for i in range(6):
            f.write(f"r{i},1\n")
        f.write("r6,2\nr7,2\nq0,1\n")
    got = web.summarise_clusters(out, "sp", str(tmp_path), ["q0"])
    with open(os.path.join(out, "include1.txt")) as f:
        include = f.read()
    assert got == jax_web.summarise_clusters(out, "sp", str(tmp_path),
                                             ["q0"])
    assert got[0] == ["q0"] and got[1] == [1] and got[2][0] > 70
    assert "q0" in include.split()


def test_api_posts_what_the_jax_package_posts(tmp_path, monkeypatch):
    import requests

    db = tmp_path / "wdb"
    db.mkdir()
    (db / "wdb_microreact_clusters.csv").write_text(
        "id,Cluster_Cluster__autocolour\na,1\nb,2\nc,1\n")
    (db / "wdb.nwk").write_text("(a:1,(b:1,c:1):1);")
    posted = []

    class FakeResponse:
        text = '{"url": "https://microreact.org/project/xyz"}'

    def fake_post(url, data=None):
        posted.append((url, data))
        return FakeResponse()

    monkeypatch.setattr(requests, "post", fake_post)
    assert web.api("1", str(db)) == jax_web.api("1", str(db)) == \
        "https://microreact.org/project/xyz"
    assert posted[0] == posted[1]
    assert posted[0][1]["tree"].startswith("(a:1")
    assert "red" in posted[0][1]["data"] and "blue" in posted[0][1]["data"]


def test_api_main_gives_the_jax_flows_json(population, population_dir,
                                           tmp_path, capsys):
    """poppunk_tpu_torch_api end to end on a JAX-written, BGMM-fitted
    database: a held-out genome's canonical JSON sketch is assigned to its
    strain's cluster, and the response equals the JAX flow's."""
    d, _ = population_dir
    refs = [n for n in population.names if not n.endswith("iso0")]
    queries = [n for n in population.names
               if n.endswith("iso0") and n.startswith("strain0")]
    rfile = population.subset_rfile(d, refs, "web_refs.txt")
    qfile = population.subset_rfile(d, queries, "web_q.txt")
    db, qdb = str(tmp_path / "apidb"), str(tmp_path / "apiq")
    jax_main(["--create-db", "--r-files", rfile, "--output", db] + KARGS)
    jax_main(["--fit-model", "bgmm", "--ref-db", db, "--output", db,
              "--K", "2", "--no-plot"])
    jax_main(["--create-db", "--r-files", qfile, "--output", qdb] + KARGS)
    (sk,) = jax_read_sketches(qdb, queries)
    sketch_path = str(tmp_path / (queries[0] + ".json"))
    with open(sketch_path, "w") as f:
        json.dump(web.sketch_to_json(sk), f)

    response = web.main(["--sketch", sketch_path, "--ref-db", db,
                         "--output", str(tmp_path / "out")])
    printed = json.loads(capsys.readouterr().out)
    want = jax_web.main(["--sketch", sketch_path, "--ref-db", db,
                         "--output", str(tmp_path / "jax_out")])
    assert response == printed == want
    with open(os.path.join(db, "apidb_clusters.csv")) as f:
        rows = dict(line.strip().split(",") for line in f.readlines()[1:])
    assert response["queries"][0]["name"] == queries[0]
    assert response["queries"][0]["cluster"] in {
        c for n, c in rows.items() if n.startswith("strain0")}
    assert response["clusters"]
