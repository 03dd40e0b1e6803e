"""The port's helper scripts (poppunk_tpu_torch/scripts) and
``python -m poppunk_tpu_torch`` against the JAX package's, on the CPU.

tests/test_scripts.py's nine tests, each run by both packages' scripts on
the same inputs: a database fitted by the JAX package's CLIs on the
conftest population (for iterate, with --multi-boundary 4), or, for the
scripts that build their own databases (batch_mst, easy_run), the same
sequence files. Outputs are byte-equal where the JAX package writes them
deterministically: the extracted distances and components, the rand
indices, the bundles, the batched MST, easy_run's cluster CSV. iterate's
tree and cluster table carry mean core distances that each package
computes with its own distance pass: equal as text but for those numbers,
which agree within the port's core/accessory tolerance (DIST_TOL,
tests/test_torch_distances.py). The weighted network's arrays are equal
(its .npz archive stamps the write time).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from poppunk_tpu.cli.main import main as jax_main
from test_torch_pipeline import DIST_TOL, KARGS, read_bytes

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("rand_index", "silhouette", "extract_components",
           "extract_distances", "add_weights", "distribute_fit", "easy_run",
           "iterate", "batch_mst")


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


def script(package, name):
    return __import__(f"{package}.scripts.{name}", fromlist=["main"]).main


def both(name, argv_of):
    """Run the script of each package; argv_of(package) gives its argv."""
    return {pkg: script(pkg, name)(argv_of(pkg))
            for pkg in ("poppunk_tpu", "poppunk_tpu_torch")}


@pytest.fixture(scope="module")
def fitted_db(population_dir, tmp_path_factory):
    d, rfile = population_dir
    db = str(tmp_path_factory.mktemp("torch_scripts") / "db")
    jax_main(["--create-db", "--r-files", rfile, "--output", db] + KARGS)
    jax_main(["--fit-model", "bgmm", "--ref-db", db, "--output", db,
              "--K", "2", "--no-plot"])
    return db


def db_file(db, ext):
    return os.path.join(db, os.path.basename(db) + ext)


def out(tmp_path, package, name):
    return str(tmp_path / f"{package}_{name}")


def test_rand_index(fitted_db, tmp_path):
    csv1 = db_file(fitted_db, "_clusters.csv")
    # a second clustering: the first with two clusters merged
    lines = open(csv1).read().splitlines()
    csv2 = str(tmp_path / "merged.csv")
    with open(csv2, "w") as f:
        f.write("\n".join([lines[0]] + [re.sub(r",2$", ",1", ln)
                                        for ln in lines[1:]]) + "\n")
    for adjusted in ([], ["--adjusted"]):
        both("rand_index", lambda p: ["--input", f"{csv1},{csv1},{csv2}",
                                      "--output", out(tmp_path, p, "rand")]
             + adjusted)
        got = read_bytes(out(tmp_path, "poppunk_tpu_torch", "rand"))
        assert got == read_bytes(out(tmp_path, "poppunk_tpu", "rand"))
        rows = [ln.split("\t") for ln in got.decode().splitlines()]
        assert len(rows) == 4 and float(rows[1][3]) == 1.0
        assert float(rows[2][3]) < 1.0
        if adjusted:
            assert float(rows[1][4]) == 1.0


def test_silhouette(fitted_db):
    scores = both("silhouette", lambda p: [
        "--distances", db_file(fitted_db, ".dists"),
        "--cluster-csv", db_file(fitted_db, "_clusters.csv")])
    assert scores["poppunk_tpu_torch"] == scores["poppunk_tpu"]
    assert scores["poppunk_tpu_torch"] > 0.5  # strains are well separated


def test_extract_components(fitted_db, tmp_path):
    both("extract_components", lambda p: [
        "--graph", db_file(fitted_db, "_graph.graph.npz"),
        "--output", out(tmp_path, p, "comp")])
    files = {p: sorted(f[len(p) + 1:] for f in os.listdir(tmp_path)
                       if f.startswith(p + "_comp.component_"))
             for p in ("poppunk_tpu", "poppunk_tpu_torch")}
    assert files["poppunk_tpu_torch"] == files["poppunk_tpu"]
    assert len(files["poppunk_tpu"]) == 4
    for f in files["poppunk_tpu"]:
        assert read_bytes(tmp_path / ("poppunk_tpu_torch_" + f)) == \
            read_bytes(tmp_path / ("poppunk_tpu_" + f))


def test_extract_distances(fitted_db, tmp_path):
    both("extract_distances", lambda p: [
        "--distances", db_file(fitted_db, ".dists"),
        "--output", out(tmp_path, p, "dists.tsv")])
    got = read_bytes(out(tmp_path, "poppunk_tpu_torch", "dists.tsv"))
    assert got == read_bytes(out(tmp_path, "poppunk_tpu", "dists.tsv"))
    lines = got.decode().splitlines()
    assert lines[0] == "Query\tSubject\tCore\tAccessory"
    assert len(lines) == 1 + 15 * 14 // 2


def test_add_weights(fitted_db, tmp_path):
    from poppunk_tpu_torch.network.graph import load_network_file

    both("add_weights", lambda p: [
        db_file(fitted_db, "_graph.graph.npz"), db_file(fitted_db, ".dists"),
        out(tmp_path, p, "weighted")])
    graphs = {p: load_network_file(os.path.join(
        out(tmp_path, p, "weighted"), f"{p}_weighted_graph.graph.npz"))
        for p in ("poppunk_tpu", "poppunk_tpu_torch")}
    got, want = graphs["poppunk_tpu_torch"], graphs["poppunk_tpu"]
    assert got.weights is not None and (got.weights > 0).all()
    assert got.n_vertices == want.n_vertices
    np.testing.assert_array_equal(got.edges, want.edges)
    np.testing.assert_array_equal(got.weights, want.weights)


def test_distribute_fit(fitted_db, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    both("distribute_fit", lambda p: [
        "--dbdir", fitted_db, "--fitdir", fitted_db, "--outpref", p,
        "--no-compress"])
    expect = {"full": ("_full.h5", "_full_fit.npz"), "refs": ("_refs.h5",)}
    for bundle, wanted in expect.items():
        names = {p: sorted(f[len(p):] for f in os.listdir(f"{p}_{bundle}"))
                 for p in ("poppunk_tpu", "poppunk_tpu_torch")}
        assert names["poppunk_tpu_torch"] == names["poppunk_tpu"]
        assert set(wanted) <= set(names["poppunk_tpu"])
        for f in names["poppunk_tpu"]:
            assert read_bytes(f"poppunk_tpu_torch_{bundle}/"
                              f"poppunk_tpu_torch{f}") == \
                read_bytes(f"poppunk_tpu_{bundle}/poppunk_tpu{f}")


def test_batch_mst(population, population_dir, tmp_path, monkeypatch):
    """Batched lineage build + sparse MST driver: the port's CLIs give the
    JAX package's MST."""
    d, rfile = population_dir
    monkeypatch.chdir(tmp_path)
    both("batch_mst", lambda p: [
        "--r-files", rfile, "--n-batches", "2", "--output",
        out(tmp_path, p, "bmst"), "--rank", "3", "--sketch-size", "2048",
        "--min-k", "13", "--max-k", "25", "--k-step", "4", "--no-plot"])
    nwk = {p: read_bytes(os.path.join(out(tmp_path, p, "bmst"),
                                      f"{p}_bmst_MST.nwk"))
           for p in ("poppunk_tpu", "poppunk_tpu_torch")}
    assert nwk["poppunk_tpu_torch"] == nwk["poppunk_tpu"]
    for name in population.names:
        assert name in nwk["poppunk_tpu_torch"].decode(), name


NUMBER = re.compile(r"\d+\.\d+(?:e-?\d+)?")


def assert_equal_but_for_numbers(got, want):
    """The same text with its decimal numbers replaced, and the numbers
    within DIST_TOL."""
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want)
    np.testing.assert_allclose(
        [float(x) for x in NUMBER.findall(got)],
        [float(x) for x in NUMBER.findall(want)], **DIST_TOL)


def test_iterate(population_dir, tmp_path):
    d, rfile = population_dir
    db = str(tmp_path / "multi")
    jax_main(["--create-db", "--r-files", rfile, "--output", db] + KARGS)
    jax_main(["--fit-model", "bgmm", "--ref-db", db, "--output", db,
              "--K", "2", "--no-plot"])
    jax_main(["--fit-model", "refine", "--ref-db", db, "--output", db,
              "--multi-boundary", "4", "--no-plot"])
    assert [f for f in os.listdir(db)
            if "_boundary" in f and f.endswith("_clusters.csv")]
    both("iterate", lambda p: ["--db", db, "--cutoff", "0.5", "--output",
                               out(tmp_path, p, "it")])
    for ext in (".tree.nwk", ".clusters.csv", ".cutoff_clusters.csv"):
        got = read_bytes(out(tmp_path, "poppunk_tpu_torch", "it") + ext)
        want = read_bytes(out(tmp_path, "poppunk_tpu", "it") + ext)
        if ext == ".cutoff_clusters.csv":
            assert got == want
        else:
            assert_equal_but_for_numbers(got.decode(), want.decode())


def test_easy_run(population_dir, tmp_path):
    """create-db -> dbscan -> refine through each package's CLIs."""
    d, rfile = population_dir
    both("easy_run", lambda p: [
        "--r-files", rfile, "--output", out(tmp_path, p, "easy"),
        "--analysis-args", "--min-k 13 --max-k 21 --k-step 4 "
        "--sketch-size 1024 --no-plot --K 2"])
    files = {p: os.path.join(out(tmp_path, p, "easy"), f"{p}_easy")
             for p in ("poppunk_tpu", "poppunk_tpu_torch")}
    assert os.path.isfile(files["poppunk_tpu_torch"] + "_fit.npz")
    assert read_bytes(files["poppunk_tpu_torch"] + "_clusters.csv") == \
        read_bytes(files["poppunk_tpu"] + "_clusters.csv")


def test_python_m_runs_the_main_cli():
    env = {**os.environ, "POPPUNK_TPU_TORCH_DEVICE": "cpu",
           "PYTHONPATH": REPO}
    run = subprocess.run([sys.executable, "-m", "poppunk_tpu_torch",
                          "--help"], env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.startswith("usage: poppunk_tpu_torch")
    assert "--create-db" in run.stdout


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_parsers_take_their_port_names(name, capsys):
    with pytest.raises(SystemExit):
        script("poppunk_tpu_torch", name)(["--help"])
    assert capsys.readouterr().out.startswith(
        f"usage: poppunk_tpu_torch_{name}")
