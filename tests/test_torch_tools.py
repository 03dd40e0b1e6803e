"""The port's auxiliary CLIs (visualise, mst, mandrake, info, references,
lineages) beside the JAX package's, on the CPU.

Both packages run each tool on the same JAX-written databases of the
conftest population (tests/test_cli_tools.py's: the whole population with
a BGMM fit, and with a lineage fit) into directories of the same name.
Microreact / phandango / grapetree / cytoscape CSVs, NJ and MST newick
files, graphml, the references, the info output and the lineage CSVs must
be byte-identical files: below 512 genomes both packages build NJ trees
with the host float64 NJ, on the distances of the JAX package's database.
Mandrake .dot files must have the same names, with the same nodes in the
same order; their coordinates come from different random generators and
are not compared, nor is the .microreact bundle (which embeds them and a
date) or the MST drawings. Where the port recalculates distances of its
own (``--recalculate-distances``, the lineage CLI), they are the match-
count kernel's, and the outputs built from them must still be the JAX
package's (NJ trees to the newick's six decimals).
"""

import importlib
import os
import pickle

import numpy as np
import pytest
import torch

from poppunk_tpu.cli.assign import main as jax_assign
from poppunk_tpu.cli.main import main as jax_main
from poppunk_tpu.trees import parse_newick
from test_nj_device import patristic_matrix

torch.set_num_threads(2)

KARGS = ["--min-k", "13", "--max-k", "25", "--k-step", "4",
         "--sketch-size", "2048", "--no-plot"]
NOT_COMPARED = (".microreact", "_mandrake.dot", ".png")


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, as a CPU-only host must."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


def tool(pkg, name):
    """The ``main`` of a CLI module of either package."""
    package = {"torch": "poppunk_tpu_torch", "jax": "poppunk_tpu"}[pkg]
    return importlib.import_module(f"{package}.cli.{name}").main


@pytest.fixture(scope="module")
def fitted_db(population_dir, tmp_path_factory):
    _, rfile = population_dir
    db = str(tmp_path_factory.mktemp("torch_tools") / "db")
    jax_main(["--create-db", "--r-files", rfile, "--output", db] + KARGS)
    jax_main(["--fit-model", "bgmm", "--ref-db", db, "--output", db,
              "--K", "2", "--no-plot"])
    return db


@pytest.fixture(scope="module")
def lineage_db(population_dir, tmp_path_factory):
    _, rfile = population_dir
    db = str(tmp_path_factory.mktemp("torch_tools_lin") / "db")
    jax_main(["--create-db", "--r-files", rfile, "--output", db] + KARGS)
    jax_main(["--fit-model", "lineage", "--ranks", "1,2", "--ref-db", db,
              "--output", db, "--no-plot"])
    return db


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def run_both(name, argv_for, tmp_path, leaf="out"):
    """{package: output directory} after each package's CLI ``name`` ran
    with ``argv_for(output directory)``."""
    outs = {}
    for pkg in ("torch", "jax"):
        outs[pkg] = str(tmp_path / pkg / leaf)
        tool(pkg, name)(argv_for(outs[pkg]))
    return outs


def assert_same_files(outs, expect=()):
    names = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["torch"])) == names
    compared = [n for n in names if not n.endswith(NOT_COMPARED)]
    for name in compared:
        assert read_bytes(os.path.join(outs["torch"], name)) == \
            read_bytes(os.path.join(outs["jax"], name)), name
    assert set(expect) <= set(compared), sorted(set(expect) - set(compared))
    return names


VISUALISE = {
    "microreact": (["--microreact", "--tree", "both", "--maxIter", "10000"],
                   ["_microreact_clusters.csv", "_core_NJ.nwk", "_MST.nwk"]),
    "phandango_grapetree": (["--phandango", "--grapetree", "--tree", "nj"],
                            ["_phandango_clusters.csv",
                             "_grapetree_clusters.csv", "_core_NJ.tree",
                             "_core_NJ.nwk"]),
    "cytoscape": (["--cytoscape", "--network-file", "{db}/db_graph.graph.npz"],
                  ["_cytoscape.graphml", "_cytoscape.csv"]),
}


@pytest.mark.parametrize("case", sorted(VISUALISE))
def test_visualise_writes_the_jax_packages_files(fitted_db, case, tmp_path):
    flags, expect = VISUALISE[case]
    flags = [f.format(db=fitted_db) for f in flags]
    outs = run_both("visualise", lambda out: ["--ref-db", fitted_db,
                                              "--output", out] + flags,
                    tmp_path, "viz")
    names = assert_same_files(outs, ["viz" + e for e in expect])
    if case == "cytoscape":
        assert any(n.startswith("viz_component_") for n in names)
    if case == "microreact":
        assert "viz.microreact" in names
        assert "viz_perplexity20.0_accessory_mandrake.dot" in names


def test_visualise_include_files_subset(fitted_db, population, tmp_path):
    subset = [n for n in population.names
              if n.startswith(("strain0", "strain1"))]
    subset_file = tmp_path / "subset.txt"
    subset_file.write_text("\n".join(subset) + "\n")
    outs = run_both("visualise", lambda out: [
        "--ref-db", fitted_db, "--output", out, "--microreact", "--tree",
        "nj", "--include-files", str(subset_file), "--maxIter", "10000"],
        tmp_path, "sub")
    assert_same_files(outs, ["sub_microreact_clusters.csv",
                             "sub_core_NJ.nwk"])
    with open(os.path.join(outs["torch"], "sub_microreact_clusters.csv")) as f:
        ids = [line.split(",")[0] for line in f.readlines()[1:]]
    assert sorted(ids) == sorted(subset)


def patristic(path):
    with open(path) as f:
        tree = parse_newick(f.read())
    labels = sorted(n.label for n in _leaves(tree))
    return labels, patristic_matrix(tree, labels)


def _leaves(node):
    if node.is_leaf():
        return [node]
    return [leaf for c in node.children for leaf in _leaves(c)]


def test_visualise_recalculates_a_query_db_on_the_port(
        population, population_dir, fitted_db, tmp_path):
    """With a query database and --recalculate-distances the port reruns
    the all-vs-all through its own distance engine: the clusters CSV is
    the JAX package's file, the NJ tree its tree to the newick's six
    decimals (distances within rtol 1e-5 of the JAX package's)."""
    d, _ = population_dir
    queries = [n for n in population.names if n.endswith("iso2")][:2]
    qfile = tmp_path / "viz_queries.txt"
    qfile.write_text("".join(f"{n}_q\t{os.path.join(str(d), n + '.fa')}\n"
                             for n in queries))
    q_out = str(tmp_path / "qdb")
    jax_assign(["--db", fitted_db, "--query", str(qfile), "--output", q_out])
    outs = run_both("visualise", lambda out: [
        "--ref-db", fitted_db, "--query-db", q_out, "--output", out,
        "--microreact", "--tree", "nj", "--maxIter", "10000",
        "--recalculate-distances"], tmp_path, "qviz")
    csv_name = "qviz_microreact_clusters.csv"
    assert read_bytes(os.path.join(outs["torch"], csv_name)) == \
        read_bytes(os.path.join(outs["jax"], csv_name))
    with open(os.path.join(outs["torch"], csv_name)) as f:
        ids = {line.split(",")[0] for line in f.readlines()[1:]}
    assert {f"{n}_q" for n in queries} <= ids and len(ids) == 15 + 2
    labels, got = patristic(os.path.join(outs["torch"], "qviz_core_NJ.nwk"))
    want_labels, want = patristic(os.path.join(outs["jax"],
                                               "qviz_core_NJ.nwk"))
    assert labels == want_labels and len(labels) == 17
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_mst_drawing_without_matplotlib_fails_before_its_layout(
        monkeypatch, tmp_path):
    """A host without matplotlib (the H100 host) gets the import error
    before the spring layout, which takes minutes at thousands of genomes;
    visualise catches it, as the JAX package does."""
    from poppunk_tpu_torch import plotting
    from poppunk_tpu_torch.network.graph import Graph

    missing = ModuleNotFoundError("No module named 'matplotlib'")
    monkeypatch.setattr(plotting, "plt", plotting._Missing(missing))

    def no_layout(*args, **kwargs):
        raise AssertionError("the layout ran")

    monkeypatch.setattr(plotting, "spring_layout", no_layout)
    mst = Graph(3, np.array([[0, 1], [1, 2]]), np.ones(2))
    with pytest.raises(ModuleNotFoundError, match="matplotlib"):
        plotting.draw_mst(mst, str(tmp_path / "o"), {"Cluster": {}},
                          "Cluster", True)


def test_mst_writes_the_jax_packages_files(lineage_db, tmp_path):
    outs = run_both("mst", lambda out: [
        "--rank-fit", os.path.join(lineage_db, "db_rank_2_fit.npz"),
        "--distance-pkl", os.path.join(lineage_db, "db.dists.pkl"),
        "--previous-clustering", os.path.join(lineage_db, "db_lineages.csv"),
        "--output", out, "--no-plot"], tmp_path, "mst")
    assert_same_files(outs, ["mst_MST.graphml", "mst_MST.nwk"])


@pytest.mark.parametrize("simple", [False, True], ids=["full", "simple"])
def test_info_prints_what_the_jax_package_prints(fitted_db, simple, capsys):
    argv = ["--db", fitted_db] + (["--simple"] if simple else [])
    printed = {}
    for pkg in ("torch", "jax"):
        tool(pkg, "info")(argv)
        printed[pkg] = capsys.readouterr().out
    assert printed["torch"] == printed["jax"]
    assert "Number of samples:\t\t15" in printed["torch"]
    assert "Sketch size:\t\t\t2048" in printed["torch"]
    assert ("strain0_iso0" in printed["torch"]) is not simple


def test_references_writes_the_jax_packages_files(fitted_db, tmp_path):
    outs = run_both("references", lambda out: [
        "--network", os.path.join(fitted_db, "db_graph.graph.npz"),
        "--distances", os.path.join(fitted_db, "db.dists"),
        "--ref-db", fitted_db, "--model", fitted_db, "--output", out],
        tmp_path, "refs")
    names = os.listdir(outs["jax"])
    assert sorted(os.listdir(outs["torch"])) == sorted(names)
    for name in names:
        got = os.path.join(outs["torch"], name)
        want = os.path.join(outs["jax"], name)
        if name.endswith((".npz", ".npy")):
            a, b = np.load(got), np.load(want)
            for key in (b.files if name.endswith(".npz") else [None]):
                np.testing.assert_array_equal(
                    a if key is None else a[key],
                    b if key is None else b[key], err_msg=name)
        elif not name.endswith((".h5", ".pkl")):
            assert read_bytes(got) == read_bytes(want), name
    with open(os.path.join(outs["torch"], "refs.refs.dists.pkl"), "rb") as f:
        refs_names = pickle.load(f)[0]
    with open(os.path.join(outs["torch"], "refs.refs")) as f:
        refs = f.read().split()
    assert refs_names == refs and 4 <= len(refs) < 15
    assert {"refs.refs.h5", "refs_fit.npz", "refs_clusters.csv"} <= \
        set(names)


def test_lineages_write_the_jax_packages_files(population, population_dir,
                                               tmp_path, monkeypatch):
    """Create (one lineage model per strain, the strains' all-vs-all on the
    port's distance engine) and query (the queries' distances on it too);
    every CSV is the JAX package's file."""
    d, _ = population_dir
    refs = [n for n in population.names if not n.endswith("iso1")]
    queries = [n for n in population.names if n.endswith("iso1")]
    rfile = population.subset_rfile(d, refs, "tools_lin_refs.txt")
    qfile = population.subset_rfile(d, queries, "tools_lin_queries.txt")
    db = str(tmp_path / "straindb")
    jax_main(["--create-db", "--r-files", rfile, "--output", db] + KARGS)
    jax_main(["--fit-model", "bgmm", "--ref-db", db, "--output", db,
              "--K", "2", "--no-plot"])
    files = {}
    for pkg in ("torch", "jax"):
        # strain lineage databases are written relative to the cwd
        cwd = tmp_path / pkg
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        lineages = tool(pkg, "lineages")
        lineages(["--create-db", db, "--db-scheme", "scheme.pkl",
                  "--output", "create", "--ranks", "1,2", "--min-count",
                  "2", "--overwrite"])
        lineages(["--query-db", qfile, "--db-scheme", "scheme.pkl",
                  "--output", "query"])
        files[pkg] = {str(p.relative_to(cwd)): p.read_bytes()
                      for p in sorted(cwd.rglob("*.csv"))}
    assert files["torch"] == files["jax"]
    assert {"create.csv", "query.csv"} <= set(files["torch"])
    assert any(name.endswith("_lineages.csv") for name in files["torch"])
    rows = files["torch"]["query.csv"].decode().splitlines()
    assert rows[0].split(",")[:2] == ["id", "Cluster"]
    assert {r.split(",")[0] for r in rows[1:]} == set(queries)


def test_mandrake_dot_names_are_the_jax_packages(fitted_db, tmp_path):
    outs = run_both("mandrake", lambda out: [
        "--distances", os.path.join(fitted_db, "db.dists"), "--output", out,
        "--perplexity", "5", "--knn", "5", "--iter", "10000"],
        tmp_path, "emb")
    dots = {}
    for pkg, out in outs.items():
        (name,) = os.listdir(out)
        with open(os.path.join(out, name)) as f:
            text = f.read()
        assert text.startswith("graph G {")
        dots[pkg] = (name, [part.split("[")[0]
                            for part in text[10:].split("; ") if "[" in part])
    assert dots["torch"] == dots["jax"]
    assert len(dots["torch"][1]) == 15
