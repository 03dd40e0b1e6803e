"""The port's CLIs end to end against the JAX package's, on the CPU.

On the conftest population (strains 0-2 minus the iso0 hold-outs as
references; the hold-outs plus the novel strain 3 as queries) both
packages run --create-db, --fit-model bgmm (and --use-model), then assign
in batch mode, with --serial, --stable and --update-db. Cluster CSVs and .refs must be
identical files; distances agree within the core/accessory tolerance of
test_torch_distances.py (rtol 1e-5, atol 2e-5). Each package also reads
the other's database.

The refine path: both packages refine the JAX package's BGMM database
(the same distances and start model in, so the ``_fit.npz`` boundaries
must be equal) with --fit-model refine (default, --indiv-refine both,
--unconstrained, --multi-boundary 3), --fit-model threshold and
--use-model, then assign with the refine model, with and without
--core --accessory. The port's distance passes run under both
KERNEL_CHOICE values (standard and packed, a monkeypatched module
attribute); every cluster CSV and .refs file must be identical.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from poppunk_tpu.cli.assign import main as jax_assign
from poppunk_tpu.cli.main import main as jax_main
from poppunk_tpu.utils import read_pickle
from poppunk_tpu_torch.cli.assign import main as torch_assign
from poppunk_tpu_torch.cli.main import main as torch_main
from poppunk_tpu_torch.ops import match_counts as mc

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, as a CPU-only host must."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


KARGS = ["--min-k", "13", "--max-k", "25", "--k-step", "4",
         "--sketch-size", "2048", "--no-plot"]
DIST_TOL = dict(rtol=1e-5, atol=2e-5)
CLIS = {"jax": (jax_main, jax_assign), "torch": (torch_main, torch_assign)}
ASSIGN_MODES = {"batch": [], "serial": ["--serial"],
                "stable": ["--stable", "core"],
                "update": ["--update-db", "full"]}


def base(prefix):
    return os.path.join(prefix, os.path.basename(prefix))


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def split(population, population_dir):
    d, _ = population_dir
    refs = [n for n in population.names
            if not n.startswith("strain3") and not n.endswith("iso0")]
    queries = [n for n in population.names if n not in refs]
    return (population.subset_rfile(d, refs, "torch_refs.txt"),
            population.subset_rfile(d, queries, "torch_queries.txt"))


@pytest.fixture(scope="module")
def dbs(split, tmp_path_factory):
    """{package: database fitted with that package's CLIs}."""
    rfile, _ = split
    root = tmp_path_factory.mktemp("torch_pipeline")
    out = {}
    for pkg, (main, _) in CLIS.items():
        db = str(root / pkg / "db")
        main(["--create-db", "--r-files", rfile, "--output", db] + KARGS)
        main(["--fit-model", "bgmm", "--ref-db", db, "--output", db,
              "--K", "2", "--no-plot"])
        out[pkg] = db
    return out


def run_assign(pkg, db, qfile, mode, out, extra=()):
    CLIS[pkg][1](["--db", db, "--query", qfile, "--output", out]
                 + ASSIGN_MODES[mode] + list(extra))
    return out


def cluster_files(prefix):
    """Names of the cluster CSVs and .refs files in an output directory
    (not the unword CSVs: their names are drawn unseeded, as the
    reference draws them)."""
    return sorted(f for f in os.listdir(prefix)
                  if (f.endswith("_clusters.csv") or f.endswith(".refs"))
                  and not f.endswith("_unword_clusters.csv"))


def assert_same_files(torch_dir, jax_dir):
    names = cluster_files(jax_dir)
    assert names and cluster_files(torch_dir) == names
    for name in names:
        assert read_bytes(os.path.join(torch_dir, name)) == \
            read_bytes(os.path.join(jax_dir, name)), name


def test_create_db_distances_agree(dbs):
    rj, _, _, Xj = read_pickle(base(dbs["jax"]) + ".dists")
    rt, _, _, Xt = read_pickle(base(dbs["torch"]) + ".dists")
    assert rj == rt
    np.testing.assert_allclose(Xt, Xj, **DIST_TOL)


def test_use_model_writes_identical_clusters(dbs, tmp_path):
    """--use-model: each package re-applies its own fitted model to its
    database's distances; the outputs are identical files."""
    outs = {}
    for pkg, (main, _) in CLIS.items():
        outs[pkg] = str(tmp_path / pkg / "reused")
        main(["--use-model", "--ref-db", dbs[pkg], "--output", outs[pkg],
              "--model-dir", dbs[pkg], "--no-plot"])
    for ext in ("_clusters.csv", ".refs"):
        assert read_bytes(base(outs["torch"]) + ext) == \
            read_bytes(base(outs["jax"]) + ext), ext


def test_fit_writes_identical_clusters_and_refs(dbs):
    for ext in ("_clusters.csv", ".refs"):
        assert read_bytes(base(dbs["torch"]) + ext) == \
            read_bytes(base(dbs["jax"]) + ext), ext
    fj = np.load(base(dbs["jax"]) + "_fit.npz")
    ft = np.load(base(dbs["torch"]) + "_fit.npz")
    assert (int(ft["within"]), int(ft["between"])) == \
        (int(fj["within"]), int(fj["between"]))
    # the scale is the distances' maximum, so it carries their tolerance
    np.testing.assert_allclose(ft["scale"], fj["scale"], **DIST_TOL)


@pytest.mark.parametrize("mode", sorted(ASSIGN_MODES))
def test_assign_writes_identical_outputs(dbs, split, mode, tmp_path):
    _, qfile = split
    outs = {pkg: run_assign(pkg, dbs[pkg], qfile, mode,
                            str(tmp_path / pkg / "out")) for pkg in CLIS}
    exts = ["_clusters.csv"] + ([".refs"] if mode == "update" else [])
    for ext in exts:
        assert read_bytes(base(outs["torch"]) + ext) == \
            read_bytes(base(outs["jax"]) + ext), ext
    if mode == "batch":
        _, _, _, Xj = read_pickle(base(outs["jax"]) + ".dists")
        _, _, _, Xt = read_pickle(base(outs["torch"]) + ".dists")
        np.testing.assert_allclose(Xt, Xj, **DIST_TOL)


@pytest.mark.parametrize("reader,writer", [("torch", "jax"),
                                           ("jax", "torch")])
def test_each_package_reads_the_others_database(dbs, split, reader, writer,
                                                tmp_path):
    _, qfile = split
    crossed = run_assign(reader, dbs[writer], qfile, "batch",
                         str(tmp_path / "crossed"))
    native = run_assign(writer, dbs[writer], qfile, "batch",
                        str(tmp_path / "native"))
    assert read_bytes(base(crossed) + "_clusters.csv") == \
        read_bytes(base(native) + "_clusters.csv")


def test_cli_path_with_h5py_standin(dbs, split, tmp_path, monkeypatch):
    """chip_smoke.py drives these CLIs on a host without h5py through the
    h5py stand-in: the same run here writes the same clusters, references
    and assignments as with h5py."""
    from test_torch_h5py_standin import h5py_standin as make_standin

    from poppunk_tpu_torch.io import hdf5db

    h5py_standin = make_standin()
    rfile, qfile = split
    with_h5py = run_assign("torch", dbs["torch"], qfile, "batch",
                           str(tmp_path / "with_h5py"))
    db = str(tmp_path / "standin" / "db")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", h5py_standin)
        m.setattr(hdf5db, "h5py", h5py_standin)
        torch_main(["--create-db", "--r-files", rfile, "--output", db]
                   + KARGS)
        torch_main(["--fit-model", "bgmm", "--ref-db", db, "--output", db,
                    "--K", "2", "--no-plot"])
        out = run_assign("torch", db, qfile, "batch",
                         str(tmp_path / "standin_out"))
    for ext in ("_clusters.csv", ".refs"):
        assert read_bytes(base(db) + ext) == \
            read_bytes(base(dbs["torch"]) + ext), ext
    assert read_bytes(base(out) + "_clusters.csv") == \
        read_bytes(base(with_h5py) + "_clusters.csv")


def test_gpu_flag_without_cuda_raises(split, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    rfile, _ = split
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        torch_main(["--create-db", "--r-files", rfile, "--output",
                    str(tmp_path / "gpu"), "--gpu-dist"] + KARGS)


def test_port_never_imports_jax(split, tmp_path):
    """In a fresh interpreter: after importing the package and after CLI
    runs (create-db, BGMM, refine, a DBSCAN fit, a lineage fit, --qc-db)
    with plotting on, neither jax nor any module of the JAX package is
    loaded."""
    rfile, _ = split
    db = str(tmp_path / "nojax")
    refine = str(tmp_path / "nojax_refine")
    dbscan = str(tmp_path / "nojax_dbscan")
    lineage = str(tmp_path / "nojax_lineage")
    qc = str(tmp_path / "nojax_qc")
    script = f"""
import sys

def jax_modules():
    return sorted(m for m in sys.modules if m == 'jax' or m == 'poppunk_tpu'
                  or m.startswith(('jax.', 'poppunk_tpu.')))

import poppunk_tpu_torch, poppunk_tpu_torch.assign, poppunk_tpu_torch.cli.assign
assert not jax_modules(), jax_modules()
from poppunk_tpu_torch.cli.main import main
main(['--create-db', '--r-files', {rfile!r}, '--output', {db!r},
      '--min-k', '13', '--max-k', '21', '--k-step', '4',
      '--sketch-size', '1024', '--plot-fit', '1'])
main(['--fit-model', 'bgmm', '--ref-db', {db!r}, '--output', {db!r}])
main(['--fit-model', 'refine', '--ref-db', {db!r}, '--output', {refine!r},
      '--model-dir', {db!r}, '--indiv-refine', 'both'])
main(['--fit-model', 'dbscan', '--ref-db', {db!r}, '--output', {dbscan!r}])
main(['--fit-model', 'lineage', '--ref-db', {db!r}, '--output', {lineage!r},
      '--ranks', '1,2'])
main(['--qc-db', '--ref-db', {db!r}, '--output', {qc!r}])
assert not jax_modules(), jax_modules()
print('NO_JAX_OK')
"""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               POPPUNK_TPU_TORCH_DEVICE="cpu")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=600, env=env,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr
    for suffix in ("_distanceDistribution.png", "_DPGMM_fit.png",
                   "_DPGMM_fit_contours.pdf", "_fit_example_1.pdf"):
        assert os.path.isfile(base(db) + suffix), suffix
    assert os.path.isfile(base(refine) + "_refined_fit.png")
    assert os.path.isfile(base(dbscan) + "_dbscan.png")
    assert os.path.isfile(base(lineage) + "_rank_2_histogram.png")
    assert os.path.isfile(base(qc) + ".dists.pkl")


# --------------------------------------------------------------------------
# refine and threshold
# --------------------------------------------------------------------------

REFINE_FITS = {
    "refine": ["--fit-model", "refine"],
    "indiv_both": ["--fit-model", "refine", "--indiv-refine", "both"],
    "unconstrained": ["--fit-model", "refine", "--unconstrained"],
    "multi_boundary": ["--fit-model", "refine", "--multi-boundary", "3"],
    "threshold": ["--fit-model", "threshold", "--threshold", "0.01"],
}


@pytest.fixture(scope="module")
def refined(dbs, tmp_path_factory):
    """{fit: {package: output dir}}: each package's fit of the JAX
    package's BGMM database (its distances and start model)."""
    root = tmp_path_factory.mktemp("torch_refine")
    out = {}
    for fit, flags in REFINE_FITS.items():
        out[fit] = {}
        for pkg, (main, _) in CLIS.items():
            out[fit][pkg] = str(root / pkg / fit)
            main(flags + ["--ref-db", dbs["jax"], "--model-dir", dbs["jax"],
                          "--output", out[fit][pkg], "--no-plot"])
    return out


@pytest.mark.parametrize("fit", sorted(REFINE_FITS))
def test_refine_writes_identical_outputs(refined, fit):
    assert_same_files(refined[fit]["torch"], refined[fit]["jax"])
    fj = np.load(base(refined[fit]["jax"]) + "_fit.npz")
    ft = np.load(base(refined[fit]["torch"]) + "_fit.npz")
    assert sorted(ft.files) == sorted(fj.files)
    for key in fj.files:
        np.testing.assert_array_equal(ft[key], fj[key], err_msg=key)
    if fit == "indiv_both":
        for ext in ("_core_clusters.csv", "_accessory_clusters.csv"):
            assert os.path.isfile(base(refined[fit]["torch"]) + ext), ext
    if fit == "multi_boundary":
        assert any("_boundary" in f
                   for f in cluster_files(refined[fit]["torch"]))


def test_use_model_on_a_refine_fit(dbs, refined, tmp_path):
    outs = {}
    for pkg, (main, _) in CLIS.items():
        outs[pkg] = str(tmp_path / pkg / "reused")
        main(["--use-model", "--ref-db", dbs["jax"], "--output", outs[pkg],
              "--model-dir", refined["indiv_both"][pkg], "--no-plot"])
    for ext in ("_clusters.csv", ".refs"):
        assert read_bytes(base(outs["torch"]) + ext) == \
            read_bytes(base(outs["jax"]) + ext), ext


@pytest.mark.parametrize("choice", ["standard", "packed"])
@pytest.mark.parametrize("flags", [[], ["--core", "--accessory"]],
                         ids=["combined", "core_accessory"])
def test_assign_with_a_refine_model(refined, split, choice, flags, tmp_path,
                                    monkeypatch):
    _, qfile = split
    monkeypatch.setattr(mc, "KERNEL_CHOICE", choice)
    outs = {pkg: run_assign(pkg, refined["indiv_both"][pkg], qfile, "batch",
                            str(tmp_path / pkg / "out"), flags)
            for pkg in CLIS}
    assert_same_files(outs["torch"], outs["jax"])
    if flags:
        assert os.path.isfile(base(outs["torch"])
                              + "_core_refined_clusters.csv")
    _, _, _, Xj = read_pickle(base(outs["jax"]) + ".dists")
    _, _, _, Xt = read_pickle(base(outs["torch"]) + ".dists")
    np.testing.assert_allclose(Xt, Xj, **DIST_TOL)


@pytest.mark.parametrize("reader,writer", [("torch", "jax"),
                                           ("jax", "torch")])
def test_each_package_reads_the_others_refine_database(refined, split,
                                                       reader, writer,
                                                       tmp_path):
    _, qfile = split
    db = refined["indiv_both"][writer]
    crossed = run_assign(reader, db, qfile, "batch",
                         str(tmp_path / "crossed" / "out"), ["--core"])
    native = run_assign(writer, db, qfile, "batch",
                        str(tmp_path / "native" / "out"), ["--core"])
    assert_same_files(crossed, native)


def test_packed_create_db_writes_the_same_distances(dbs, split, tmp_path,
                                                    monkeypatch):
    """--create-db under KERNEL_CHOICE packed: the .dists equal the
    standard route's bit for bit (the counts are exact either way)."""
    rfile, _ = split
    db = str(tmp_path / "packed" / "db")
    monkeypatch.setattr(mc, "KERNEL_CHOICE", "packed")
    torch_main(["--create-db", "--r-files", rfile, "--output", db] + KARGS)
    names, _, _, X = read_pickle(base(db) + ".dists")
    want_names, _, _, want = read_pickle(base(dbs["torch"]) + ".dists")
    assert names == want_names
    np.testing.assert_array_equal(X, want)
