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
the model's own classifier, and a lineage model's with none; a run in a
fresh interpreter loads neither jax nor the JAX package. (The parser is
held to the JAX package's in tests/test_torch_standalone.py.)

The other modes, on the same database: --unconstrained --pos-shift 0.05
--neg-shift 0.05 (without --neg-shift, held to the JAX test's invariants:
test_unconstrained_at_the_grid_edge says why), --multi-boundary 4 and
--mandrake fits (cluster CSVs byte for byte, the
.dot's names equal; the embedding itself is not compared, the packages'
generators differ, tests/test_torch_nj_embedding.py); --use-model with a
scale fit and with a --fit-model threshold fit, both written by the JAX
package (cluster CSVs byte for byte, and the source fit's clusters);
--run-qc on the population plus a junk genome (the QC report and cluster
CSVs byte for byte, the failed set the port's host qc_dist_mat's); and the
two refusals the JAX package makes, --unconstrained with --indiv-refine
and --use-model on a BGMM fit.
"""

import json
import os
import re
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
    # --neg-shift 0.05: see test_unconstrained_at_the_grid_edge
    "unconstrained": ["--unconstrained", "--pos-shift", "0.05",
                      "--neg-shift", "0.05"],
    "multi_boundary": ["--multi-boundary", "4"],
    "mandrake": ["--mandrake", "--perplexity", "5", "--mandrake-iter",
                 "20000"],
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
    if fit == "unconstrained":
        assert (got["intercept"] > 0).all()
    if fit == "multi_boundary":
        assert sum("_boundary" in n for n in names) >= 1


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


def test_unconstrained_at_the_grid_edge(jax_db, population, tmp_path):
    """--unconstrained --pos-shift 0.05 (tests/test_scale_cli.py's flags):
    the best grid cell here is the first column, x_max[0] =
    float32(x_start), and the local step runs only if x_start <
    float32(x_start) — a rounding coin flip in refine_fit_device_2d (the
    reference's code, copied as it is), which the two packages' start
    models, equal within the distances' float32 noise, land on different
    sides of. So both fits are held to the JAX test's invariants here, and
    to each other byte for byte a grid step inside the edge (FITS)."""
    for pkg, main in SCALES.items():
        out = str(tmp_path / pkg / "edge")
        main(["--ref-db", jax_db, "--output", out, "--no-plot",
              "--unconstrained", "--pos-shift", "0.05"])
        assert (np.load(base(out) + "_fit.npz")["intercept"] > 0).all()
        strains = {}
        with open(base(out) + "_clusters.csv") as f:
            for line in f.readlines()[1:]:
                name, cl = line.strip().split(",")
                strains.setdefault(cl, set()).add(population.strain_of[name])
        assert all(len(s) == 1 for s in strains.values()), pkg


def dot_names(path):
    with open(path) as f:
        return re.findall(r'"([^"]+)"\[x=', f.read())


def test_mandrake_writes_the_jax_packages_names(fitted, population):
    dots = {pkg: base(fitted["mandrake"][pkg])
            + "_perplexity5.0_accessory_mandrake.dot" for pkg in SCALES}
    names = dot_names(dots["jax"])
    assert dot_names(dots["torch"]) == names == sorted(population.names)
    with open(dots["torch"]) as f:
        coords = np.array(re.findall(r'[xy]="([^"]+)"', f.read()), float)
    assert coords.shape == (2 * len(names),) and np.isfinite(coords).all()


@pytest.fixture(scope="module")
def use_model_sources(jax_db, fitted, tmp_path_factory):
    """JAX-written fits for --use-model: {source: (model dir, its
    _clusters.csv)}, from a scale fit, a --fit-model threshold fit and a
    BGMM fit (which --use-model refuses)."""
    root = tmp_path_factory.mktemp("torch_scale_use_model")
    thr, bgmm = str(root / "thr"), str(root / "bgmm")
    CLIS["jax"][0](["--fit-model", "threshold", "--threshold", "0.02",
                    "--ref-db", jax_db, "--output", thr, "--no-plot"])
    CLIS["jax"][0](["--fit-model", "bgmm", "--ref-db", jax_db, "--output",
                    bgmm, "--no-plot"])
    scale_fit = fitted["bgmm_lineages"]["jax"]
    return {"scale": (scale_fit, base(scale_fit) + "_clusters.csv"),
            "threshold": (thr, base(thr) + "_clusters.csv"),
            "bgmm": (bgmm, None)}


@pytest.mark.parametrize("source", ["scale", "threshold"])
def test_use_model_writes_the_jax_packages_outputs(jax_db, use_model_sources,
                                                   source, tmp_path):
    model_dir, clusters = use_model_sources[source]
    outs = {}
    for pkg, main in SCALES.items():
        outs[pkg] = str(tmp_path / pkg / "reuse")
        main(["--ref-db", jax_db, "--output", outs[pkg], "--use-model",
              "--model-dir", model_dir, "--no-plot"])
    names = cluster_files(outs["jax"])
    assert names == cluster_files(outs["torch"]) == ["reuse_clusters.csv"]
    got = read_bytes(base(outs["torch"]) + "_clusters.csv")
    assert got == read_bytes(base(outs["jax"]) + "_clusters.csv")
    # the source fit's own clusters, and its boundary saved again
    assert got == read_bytes(clusters)
    np.testing.assert_array_equal(
        np.load(base(outs["torch"]) + "_fit.npz")["intercept"],
        np.load(base(model_dir) + "_fit.npz")["intercept"])


REFUSALS = {
    "unconstrained_indiv": (["--unconstrained", "--indiv-refine", "both"],
                            "Unconstrained optimization and indiv-refine "
                            "incompatible"),
    "use_model_bgmm": (["--use-model"], "--use-model streams "
                       "refine/threshold boundaries; a 'bgmm' model"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_equal_the_jax_packages(jax_db, use_model_sources, case,
                                         tmp_path, capsys):
    flags, message = REFUSALS[case]
    if case == "use_model_bgmm":
        flags = flags + ["--model-dir", use_model_sources["bgmm"][0]]
    for pkg, main in SCALES.items():
        with pytest.raises(SystemExit) as exit_:
            main(["--ref-db", jax_db, "--output", str(tmp_path / pkg),
                  "--no-plot"] + flags)
        assert exit_.value.code == 1, pkg
        assert message in capsys.readouterr().err, pkg
    assert not os.path.exists(tmp_path / "torch" / "torch_clusters.csv")


QC_FLAGS = ["--run-qc", "--max-zero-dist", "1", "--max-pi-dist", "0.2",
            "--max-a-dist", "0.85"]


@pytest.fixture(scope="module")
def junk_db(population_dir, tmp_path_factory):
    """The JAX package's database of the population plus one genome of
    random sequence (tests/test_scale_cli.py's recipe)."""
    _, rfile = population_dir
    root = tmp_path_factory.mktemp("torch_scale_qc")
    rng = np.random.default_rng(99)
    junk = root / "junkbug.fa"
    seq = "".join(rng.choice(list("ACGT"), size=80_000))
    junk.write_text(">junkbug\n" + "\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    rfile2 = root / "with_junk.txt"
    rfile2.write_text(open(rfile).read() + f"junkbug\t{junk}\n")
    db = str(root / "db")
    CLIS["jax"][0](["--create-db", "--r-files", str(rfile2), "--output", db]
                   + KARGS)
    return db


def test_run_qc_writes_the_jax_packages_report(junk_db, population,
                                               tmp_path):
    from poppunk_tpu_torch.qc import DEFAULT_QC, qc_dist_mat
    from poppunk_tpu_torch.utils import read_pickle

    outs = {}
    for pkg, main in SCALES.items():
        outs[pkg] = str(tmp_path / pkg / "qcfit")
        main(["--ref-db", junk_db, "--output", outs[pkg], "--no-plot"]
             + QC_FLAGS)
    report = base(outs["torch"]) + "_qcreport.txt"
    assert read_bytes(report) == read_bytes(base(outs["jax"])
                                            + "_qcreport.txt")
    names = cluster_files(outs["jax"])
    assert names and cluster_files(outs["torch"]) == names
    for name in names:
        assert read_bytes(os.path.join(outs["torch"], name)) == \
            read_bytes(os.path.join(outs["jax"], name)), name
    # the host oracle on the database's distances at the same thresholds
    rlist, _, _, X = read_pickle(base(junk_db) + ".dists")
    qc_dict = dict(DEFAULT_QC, prop_zero=1, max_pi_dist=0.2,
                   max_a_dist=0.85)
    _, fail_host = qc_dist_mat(X, rlist, rlist, junk_db, qc_dict)
    failed = {line.split("\t")[0] for line in open(report)}
    assert "junkbug" in failed and failed == set(fail_host)
    with open(base(outs["torch"]) + "_clusters.csv") as f:
        clustered = {line.split(",")[0] for line in f.readlines()[1:]}
    assert clustered == set(population.names) - failed


SCALE_RUN = """
import json, sys
from poppunk_tpu_torch.cli.scale import main
main(["--ref-db", sys.argv[1], "--output", sys.argv[2], "--no-plot",
      "--write-lineages", "--ranks", "1", "--run-qc", "--max-zero-dist", "1",
      "--max-pi-dist", "0.2", "--max-a-dist", "0.85", "--mandrake",
      "--perplexity", "5", "--mandrake-iter", "2000"])
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
    for ext in ("_clusters.csv", "_perplexity5.0_accessory_mandrake.dot"):
        assert os.path.isfile(base(str(tmp_path / "fit")) + ext)


@pytest.mark.parametrize("n,chunk,k", [(3, 256, 6), (15, 256, 4),
                                       (1001, 64, 5), (65536, 256, 5),
                                       (131073, 512, 6)])
def test_pad_geometry_equals_the_jax_packages_on_one_device(n, chunk, k):
    c, n_pad, mesh = jax_pad_geometry(n, chunk, 1, False, n_kmers=k)
    assert mesh is None
    assert _pad_geometry(n, chunk, 1, False, n_kmers=k) == (c, n_pad, None)
    assert n_pad >= n and (n_pad // 2) % c == 0
