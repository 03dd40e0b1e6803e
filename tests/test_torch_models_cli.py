"""The DBSCAN and lineage model CLIs and --qc-db, port against JAX package.

On the conftest population split of test_torch_pipeline.py (strains 0-2
minus the iso0 hold-outs as references; the hold-outs plus the novel
strain 3 as queries) both packages fit the JAX package's database (the
same distances in, so the artefacts must be equal): --fit-model dbscan,
dbscan --for-refine then refine from it, lineage --ranks 1,2, --use-model
on the DBSCAN and lineage fits, --qc-db plain and with --remove-samples.
Then each package assigns with its own fits: DBSCAN in batch, --serial,
--stable core and --update-db full; lineage in batch and --update-db
full. Cluster CSVs, .refs, _lineages.csv and QC reports must be identical
files, the _fit.npz, rank and kNN npz arrays equal. Each package reads the
other's DBSCAN and lineage databases, and the port refuses --serial with a
lineage model as the JAX package does. One create-db + DBSCAN fit + assign
runs with the port's distances under KERNEL_CHOICE packed.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import scipy.sparse
import torch

from poppunk_tpu.utils import read_pickle
from poppunk_tpu_torch.io.hdf5db import get_seqs_in_db
from poppunk_tpu_torch.ops import match_counts as mc
from test_torch_pipeline import (CLIS, DIST_TOL, KARGS, base, cluster_files,
                                 read_bytes, run_assign)

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, as a CPU-only host must."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def split(population, population_dir):
    d, _ = population_dir
    refs = [n for n in population.names
            if not n.startswith("strain3") and not n.endswith("iso0")]
    queries = [n for n in population.names if n not in refs]
    return (population.subset_rfile(d, refs, "models_refs.txt"),
            population.subset_rfile(d, queries, "models_queries.txt"), refs)


@pytest.fixture(scope="module")
def jax_db(split, tmp_path_factory):
    db = str(tmp_path_factory.mktemp("torch_models") / "jaxdb" / "db")
    CLIS["jax"][0](["--create-db", "--r-files", split[0], "--output", db]
                   + KARGS)
    return db


FITS = {
    "dbscan": ["--fit-model", "dbscan"],
    "dbscan_for_refine": ["--fit-model", "dbscan", "--for-refine"],
    "lineage": ["--fit-model", "lineage", "--ranks", "1,2"],
}


@pytest.fixture(scope="module")
def fitted(jax_db, tmp_path_factory):
    """{fit: {package: output dir}}: each package's fit of the JAX
    package's database; refine_from_dbscan refines each package's own
    --for-refine DBSCAN fit. A lineage fit writes no copy of the sketches
    and distances (the JAX package's too), so each package fits a copy of
    the database in place, as a lineage database is assigned to."""
    root = tmp_path_factory.mktemp("torch_models_fits")
    out = {}
    for fit in [*FITS, "refine_from_dbscan"]:
        out[fit] = {}
        for pkg, (main, _) in CLIS.items():
            out[fit][pkg] = ref_db = str(root / pkg / fit / "db")
            flags = FITS.get(fit) or ["--fit-model", "refine", "--model-dir",
                                      out["dbscan_for_refine"][pkg]]
            if fit == "lineage":
                shutil.copytree(jax_db, ref_db)
            else:
                ref_db = jax_db
            main(flags + ["--ref-db", ref_db, "--output", out[fit][pkg],
                          "--no-plot"])
    return out


def npz_files(prefix):
    return sorted(f for f in os.listdir(prefix) if f.endswith(".npz")
                  and not f.endswith(".graph.npz"))


def assert_same_artefacts(torch_dir, jax_dir, float_tol=None):
    """Identical cluster CSVs, .refs and _lineages.csv; equal arrays in
    every model npz (_fit, _rank_<k>_fit, _sparse_dists). Where each
    package computed distances of its own, ``float_tol`` holds the float
    arrays (distances and what is computed from them) to it; the integer
    arrays (kNN structure, labels) stay equal."""
    names = cluster_files(jax_dir) + sorted(
        f for f in os.listdir(jax_dir) if f.endswith("_lineages.csv"))
    got = cluster_files(torch_dir) + sorted(
        f for f in os.listdir(torch_dir) if f.endswith("_lineages.csv"))
    assert got == names
    for name in names:
        assert read_bytes(os.path.join(torch_dir, name)) == \
            read_bytes(os.path.join(jax_dir, name)), name
    npzs = npz_files(jax_dir)
    assert npz_files(torch_dir) == npzs
    for name in npzs:
        a = np.load(os.path.join(torch_dir, name))
        b = np.load(os.path.join(jax_dir, name))
        assert sorted(a.files) == sorted(b.files), name
        for key in b.files:
            if float_tol and b[key].dtype.kind == "f":
                np.testing.assert_allclose(a[key], b[key], **float_tol,
                                           err_msg=f"{name}:{key}")
            else:
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"{name}:{key}")
    assert names or npzs


@pytest.mark.parametrize("fit", sorted([*FITS, "refine_from_dbscan"]))
def test_fit_writes_identical_outputs(fitted, fit):
    assert_same_artefacts(fitted[fit]["torch"], fitted[fit]["jax"])
    if fit == "dbscan_for_refine":
        assert not cluster_files(fitted[fit]["torch"])
    if fit == "lineage":
        with open(base(fitted[fit]["torch"]) + "_lineages.csv") as f:
            assert f.readline().strip().split(",") == \
                ["id", "Rank_1", "Rank_2", "overall"]


@pytest.mark.parametrize("fit", ["dbscan", "lineage"])
def test_use_model_writes_identical_outputs(jax_db, fitted, fit, tmp_path):
    outs = {}
    for pkg, (main, _) in CLIS.items():
        outs[pkg] = str(tmp_path / pkg / "reused")
        main(["--use-model", "--ref-db", jax_db, "--output", outs[pkg],
              "--model-dir", fitted[fit][pkg], "--no-plot"])
    assert_same_artefacts(outs["torch"], outs["jax"])


def read_dists(prefix):
    stem = base(prefix) + ".dists"
    with open(stem + ".pkl", "rb") as f:
        names = pickle.load(f)[0]
    return names, np.load(stem + ".npy")


@pytest.mark.parametrize("removal", [False, True], ids=["plain", "remove"])
def test_qc_db_writes_identical_outputs(jax_db, split, removal, tmp_path):
    """Plain: the default thresholds fail some of these references (their
    distances run high); both packages fail the same ones. With
    --remove-samples under thresholds every reference passes, so the one
    named is all that goes."""
    removed = split[2][1]
    flags = []
    if removal:
        listing = tmp_path / "remove.txt"
        listing.write_text(removed + "\n")
        flags = ["--remove-samples", str(listing), "--max-pi-dist", "1",
                 "--max-a-dist", "1", "--max-zero-dist", "1"]
    outs = {}
    for pkg, (main, _) in CLIS.items():
        outs[pkg] = str(tmp_path / pkg / "qc")
        main(["--qc-db", "--ref-db", jax_db, "--output", outs[pkg]] + flags)
    names, X = read_dists(outs["torch"])
    want_names, want = read_dists(outs["jax"])
    assert names == want_names
    np.testing.assert_array_equal(X, want)
    report = base(outs["torch"]) + "_qcreport.txt"
    assert read_bytes(report) == read_bytes(base(outs["jax"])
                                            + "_qcreport.txt")
    assert sorted(get_seqs_in_db(base(outs["torch"]) + ".h5")) == \
        sorted(names)
    if removal:
        assert names == [n for n in split[2] if n != removed]
        assert read_bytes(report) == f"{removed}\tRequested removal\n".encode()


@pytest.mark.parametrize("mode", ["batch", "serial", "stable", "update"])
def test_assign_with_a_dbscan_model(fitted, split, mode, tmp_path):
    outs = {pkg: run_assign(pkg, fitted["dbscan"][pkg], split[1], mode,
                            str(tmp_path / pkg / "out")) for pkg in CLIS}
    exts = ["_clusters.csv"] + ([".refs"] if mode == "update" else [])
    for ext in exts:
        assert read_bytes(base(outs["torch"]) + ext) == \
            read_bytes(base(outs["jax"]) + ext), ext
    if mode == "batch":
        _, _, _, Xj = read_pickle(base(outs["jax"]) + ".dists")
        _, _, _, Xt = read_pickle(base(outs["torch"]) + ".dists")
        np.testing.assert_allclose(Xt, Xj, **DIST_TOL)


@pytest.mark.parametrize("mode", ["batch", "update"])
def test_assign_with_a_lineage_model(fitted, split, mode, tmp_path):
    outs = {pkg: run_assign(pkg, fitted["lineage"][pkg], split[1], mode,
                            str(tmp_path / pkg / "out")) for pkg in CLIS}
    # the query distances in the extended kNN are each package's own
    assert_same_artefacts(outs["torch"], outs["jax"], DIST_TOL)
    with open(base(outs["torch"]) + "_lineages.csv") as f:
        rows = [line.strip().split(",") for line in f]
    assert rows[0] == ["id", "Rank_1", "Rank_2", "overall", "Status"]
    assert {r[-1] for r in rows[1:]} == {"Query", "Reference"}
    if mode == "update":
        knn = scipy.sparse.load_npz(base(outs["torch"]) + "_sparse_dists.npz")
        assert knn.shape[0] == len(rows) - 1


def test_lineage_models_refuse_serial_assignment(fitted, split, tmp_path):
    for pkg in CLIS:
        with pytest.raises(RuntimeError, match="--serial or"):
            run_assign(pkg, fitted["lineage"][pkg], split[1], "serial",
                       str(tmp_path / pkg / "out"))


@pytest.mark.parametrize("fit", ["dbscan", "lineage"])
@pytest.mark.parametrize("reader,writer", [("torch", "jax"),
                                           ("jax", "torch")])
def test_each_package_reads_the_others_database(fitted, split, fit, reader,
                                                writer, tmp_path):
    db = fitted[fit][writer]
    crossed = run_assign(reader, db, split[1], "batch",
                         str(tmp_path / "crossed" / "out"))
    native = run_assign(writer, db, split[1], "batch",
                        str(tmp_path / "native" / "out"))
    assert_same_artefacts(crossed, native)


def test_packed_create_db_dbscan_and_assign(jax_db, fitted, split, tmp_path,
                                            monkeypatch):
    """The port's own distances under the packed kernel choice: create-db,
    the DBSCAN fit and assignment write the JAX package's cluster files."""
    monkeypatch.setattr(mc, "KERNEL_CHOICE", "packed")
    db = str(tmp_path / "packed" / "db")
    main = CLIS["torch"][0]
    main(["--create-db", "--r-files", split[0], "--output", db] + KARGS)
    _, _, _, X = read_pickle(base(db) + ".dists")
    _, _, _, want = read_pickle(base(jax_db) + ".dists")
    np.testing.assert_allclose(X, want, **DIST_TOL)
    main(["--fit-model", "dbscan", "--ref-db", db, "--output", db,
          "--no-plot"])
    assert_same_artefacts(db, fitted["dbscan"]["jax"], DIST_TOL)
    out = run_assign("torch", db, split[1], "batch", str(tmp_path / "q"))
    native = run_assign("jax", fitted["dbscan"]["jax"], split[1], "batch",
                        str(tmp_path / "native" / "q"))
    assert read_bytes(base(out) + "_clusters.csv") == \
        read_bytes(base(native) + "_clusters.csv")
