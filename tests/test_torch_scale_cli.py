"""poppunk_tpu_torch_scale against poppunk_tpu_scale on the conftest
population, on the CPU.

Both packages fit the JAX package's database of the whole population (the
same sketches in): the BGMM start with --write-lineages --ranks 1,2, the
DBSCAN start, and --indiv-refine both with --extract-references. The
cluster CSVs, .refs and _lineages.csv must be identical files, the
_fit.npz boundaries equal within rtol 1e-4 atol 1e-6 (the JAX package's
refine tests' tolerance) and the scales within the distances' tolerance.
The port's bootstrap and POPPUNK_TPU_BOOTSTRAP=0 give the same clusters;
each package's assign takes its own scale fit of the reference split and
assigns the hold-outs identically; --warmup warms 10 serving buckets with
the model's own classifier, and a lineage model's with none; the
flags whose paths the port does not run exit non-zero before any work; a
run in a fresh interpreter loads neither jax nor the JAX package. (The
parser is held to the JAX package's in tests/test_torch_standalone.py.)
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from poppunk_tpu.cli.scale import _pad_geometry as jax_pad_geometry
from poppunk_tpu.cli.scale import main as jax_scale
from poppunk_tpu_torch.cli.assign import main as torch_assign
from poppunk_tpu_torch.cli.scale import _pad_geometry
from poppunk_tpu_torch.cli.scale import main as torch_scale
from test_torch_pipeline import (CLIS, DIST_TOL, KARGS, base, cluster_files,
                                 read_bytes, run_assign)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALES = {"jax": jax_scale, "torch": torch_scale}
BOUNDARY_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, as a CPU-only host must."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        m.delenv("POPPUNK_TPU_BOOTSTRAP", raising=False)
        yield


@pytest.fixture(scope="module")
def jax_db(population_dir, tmp_path_factory):
    _, rfile = population_dir
    db = str(tmp_path_factory.mktemp("torch_scale") / "db")
    CLIS["jax"][0](["--create-db", "--r-files", rfile, "--output", db]
                   + KARGS)
    return db


FITS = {
    "bgmm_lineages": ["--write-lineages", "--ranks", "1,2"],
    "dbscan": ["--fit-model", "dbscan"],
    "indiv_refs": ["--indiv-refine", "both", "--extract-references"],
}


@pytest.fixture(scope="module")
def fitted(jax_db, tmp_path_factory):
    """{fit: {package: output dir}}"""
    root = tmp_path_factory.mktemp("torch_scale_fits")
    out = {}
    for fit, flags in FITS.items():
        out[fit] = {}
        for pkg, main in SCALES.items():
            out[fit][pkg] = str(root / pkg / fit)
            main(["--ref-db", jax_db, "--output", out[fit][pkg],
                  "--no-plot", "--seed", "42"] + flags)
    return out


def lineage_files(prefix):
    return sorted(f for f in os.listdir(prefix) if f.endswith("_lineages.csv"))


@pytest.mark.parametrize("fit", sorted(FITS))
def test_fit_writes_the_jax_packages_outputs(fitted, fit, population):
    t_dir, j_dir = fitted[fit]["torch"], fitted[fit]["jax"]
    names = cluster_files(j_dir) + lineage_files(j_dir)
    assert cluster_files(t_dir) + lineage_files(t_dir) == names
    for name in names:
        assert read_bytes(os.path.join(t_dir, name)) == \
            read_bytes(os.path.join(j_dir, name)), name
    got, want = np.load(base(t_dir) + "_fit.npz"), \
        np.load(base(j_dir) + "_fit.npz")
    assert sorted(got.files) == sorted(want.files)
    for key in ("intercept", "core_acc_intercepts"):
        np.testing.assert_allclose(got[key], want[key], **BOUNDARY_TOL)
    np.testing.assert_allclose(got["scale"], want["scale"], **DIST_TOL)
    assert bool(got["indiv_fitted"]) == bool(want["indiv_fitted"]) == \
        (fit == "indiv_refs")
    # no condensed matrix on disk; clusters never mix strains
    assert os.path.isfile(base(t_dir) + ".dists.pkl")
    assert not os.path.isfile(base(t_dir) + ".dists.npy")
    strains = {}
    with open(base(t_dir) + "_clusters.csv") as f:
        for line in f.readlines()[1:]:
            name, cl = line.strip().split(",")
            strains.setdefault(cl, set()).add(population.strain_of[name])
    assert all(len(s) == 1 for s in strains.values())
    if fit == "indiv_refs":
        assert {"db_core_clusters.csv", "db_accessory_clusters.csv"} <= {
            n.replace(os.path.basename(t_dir), "db") for n in names}
        assert any(n.endswith(".refs") for n in names)
    if fit == "bgmm_lineages":
        assert os.path.isdir(t_dir + "_lineages")


def test_bootstrap_and_the_plain_pass_give_the_same_clusters(
        jax_db, fitted, tmp_path, monkeypatch):
    monkeypatch.setenv("POPPUNK_TPU_BOOTSTRAP", "0")
    out = str(tmp_path / "plain")
    torch_scale(["--ref-db", jax_db, "--output", out, "--no-plot",
                 "--seed", "42"] + FITS["bgmm_lineages"])
    booted = fitted["bgmm_lineages"]["torch"]
    for name in ("_clusters.csv", "_lineages.csv"):
        assert read_bytes(base(out) + name) == read_bytes(base(booted) + name)


@pytest.fixture(scope="module")
def split_fits(population, population_dir, tmp_path_factory):
    """Each package's scale fit of its own create-db of the references of
    tests/test_torch_pipeline.py's split; the queries are the hold-outs."""
    d, _ = population_dir
    refs = [n for n in population.names
            if not n.startswith("strain3") and not n.endswith("iso0")]
    queries = [n for n in population.names if n not in refs]
    rfile = population.subset_rfile(d, refs, "scale_refs.txt")
    qfile = population.subset_rfile(d, queries, "scale_queries.txt")
    root = tmp_path_factory.mktemp("torch_scale_split")
    out = {}
    for pkg, (main, _) in CLIS.items():
        db = str(root / pkg / "db")
        main(["--create-db", "--r-files", rfile, "--output", db] + KARGS)
        out[pkg] = str(root / pkg / "fit")
        SCALES[pkg](["--ref-db", db, "--output", out[pkg], "--no-plot"])
    return out, qfile


def test_assign_takes_the_scale_fit(split_fits, tmp_path):
    fits, qfile = split_fits
    outs = {pkg: run_assign(pkg, fits[pkg], qfile, "batch",
                            str(tmp_path / pkg / "out")) for pkg in CLIS}
    assert read_bytes(base(outs["torch"]) + "_clusters.csv") == \
        read_bytes(base(outs["jax"]) + "_clusters.csv")


def record_posts(monkeypatch):
    """The names of the fused classifiers the distance pass applies."""
    from poppunk_tpu_torch.ops import fused_assign

    names, real = [], fused_assign.apply_post

    def apply_post(dists, post_spec):
        names.append(post_spec[0])
        return real(dists, post_spec)

    monkeypatch.setattr(fused_assign, "apply_post", apply_post)
    return names


def warmup(db, tmp_path, capfd, *flags):
    """poppunk_tpu_torch_assign --warmup; returns its stderr."""
    with pytest.raises(SystemExit) as exit_:
        torch_assign(["--db", db, "--warmup", "--output",
                      str(tmp_path / "w")] + list(flags))
    assert exit_.value.code == 0
    return capfd.readouterr().err


def test_warmup_warms_ten_serving_buckets(split_fits, tmp_path, capfd,
                                          monkeypatch):
    """With the model's own classifier: the scale fit is a refine model."""
    fits, _ = split_fits
    posts = record_posts(monkeypatch)
    err = warmup(fits["torch"], tmp_path, capfd)
    assert f"Warmed 10 serving programs for {fits['torch']}" in err
    assert posts == ["boundary"] * 10


def test_warmup_warms_a_lineage_model(split_fits, tmp_path, capfd,
                                      monkeypatch):
    """A lineage model has no fused classifier: the buckets run the
    distances alone, as the reference's warmup does (post_spec None)."""
    fits, _ = split_fits
    db = os.path.join(os.path.dirname(fits["torch"]), "db")
    lineage = str(tmp_path / "lineage")
    CLIS["torch"][0](["--fit-model", "lineage", "--ranks", "1,2",
                      "--ref-db", db, "--output", lineage, "--no-plot"])
    posts = record_posts(monkeypatch)
    err = warmup(db, tmp_path, capfd, "--model-dir", lineage)
    assert f"Warmed 10 serving programs for {db}" in err
    assert posts == []


@pytest.mark.parametrize("flags", [
    ["--unconstrained"], ["--multi-boundary", "3"], ["--use-model"],
    ["--run-qc"], ["--mandrake"]], ids=lambda f: f[0])
def test_flags_the_port_does_not_run_exit_before_any_work(flags, tmp_path,
                                                         capsys):
    out = tmp_path / "never"
    with pytest.raises(SystemExit) as exit_:
        torch_scale(["--ref-db", str(tmp_path / "nodb"), "--output",
                     str(out)] + flags)
    assert exit_.value.code != 0
    assert flags[0] in capsys.readouterr().err
    assert not out.exists()


SCALE_RUN = """
import json, sys
from poppunk_tpu_torch.cli.scale import main
main(["--ref-db", sys.argv[1], "--output", sys.argv[2], "--no-plot",
      "--write-lineages", "--ranks", "1"])
print(json.dumps(sorted(m for m in sys.modules if m in ("jax", "poppunk_tpu")
                        or m.startswith(("jax.", "poppunk_tpu.")))))
"""


def test_a_scale_run_loads_no_jax(jax_db, tmp_path):
    env = {**os.environ, "POPPUNK_TPU_TORCH_DEVICE": "cpu",
           "PYTHONPATH": REPO}
    run = subprocess.run([sys.executable, "-c", SCALE_RUN, jax_db,
                          str(tmp_path / "fit")], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert json.loads(run.stdout.splitlines()[-1]) == []
    assert os.path.isfile(base(str(tmp_path / "fit")) + "_clusters.csv")


@pytest.mark.parametrize("n,chunk,k", [(3, 256, 6), (15, 256, 4),
                                       (1001, 64, 5), (65536, 256, 5),
                                       (131073, 512, 6)])
def test_pad_geometry_equals_the_jax_packages_on_one_device(n, chunk, k):
    c, n_pad, mesh = jax_pad_geometry(n, chunk, 1, False, n_kmers=k)
    assert mesh is None
    assert _pad_geometry(n, chunk, n_kmers=k) == (c, n_pad)
    assert n_pad >= n and (n_pad // 2) % c == 0
