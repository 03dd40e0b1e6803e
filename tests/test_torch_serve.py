"""The port's resident serving session (poppunk_tpu_torch.serve) against
the JAX package's, on the CPU.

Both packages serve one JAX-written database (the conftest population
split of test_torch_pipeline.py: strains 0-2 minus the iso0 hold-outs as
references; the hold-outs plus the novel strain 3 as queries) with the
JAX package's refine, BGMM and DBSCAN fits: the port's session must give
the port's ``--stable`` CLI answers and the JAX package's AssignSession
answers, on core and accessory. Each ``*_stable`` post equals its JAX twin
bit for bit on seeded tiles, one of them with tied minima; on the same
tiles each BGMM post placed once by ``post_spec_on`` (the mixture factored
there) equals the raw spec's, and the likelihood split into its factor and
its per-row step equals the one function it was. The session
warms 10 buckets at chunk 512, refuses a query of the wrong geometry and a
lineage model, and takes both forms of ``assign_files``, with and without
the spawn pool. A ``cuda``-marked test holds the session on the card to
the session on the CPU.
"""

import csv
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poppunk_tpu.cli.main import main as jax_main
from poppunk_tpu.ops import fused_assign as jax_fused
from poppunk_tpu.serve import AssignSession as JaxSession
from poppunk_tpu_torch.cli.assign import main as torch_assign
from poppunk_tpu_torch.cli.main import main as torch_main
from poppunk_tpu_torch.ops import fused_assign as torch_fused
from poppunk_tpu_torch.serve import AssignSession

torch.set_num_threads(2)

KARGS = ["--min-k", "13", "--max-k", "25", "--k-step", "4",
         "--sketch-size", "2048", "--no-plot"]
CPU = torch.device("cpu")


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
    return (population.subset_rfile(d, refs, "serve_refs.txt"),
            population.subset_rfile(d, queries, "serve_queries.txt"))


@pytest.fixture(scope="module")
def served(split, tmp_path_factory):
    """(reference database, {model: model directory}): the JAX package's
    database with its BGMM fit in place, and its refine and DBSCAN fits
    beside it."""
    root = tmp_path_factory.mktemp("torch_serve")
    db = str(root / "db")
    jax_main(["--create-db", "--r-files", split[0], "--output", db] + KARGS)
    jax_main(["--fit-model", "bgmm", "--ref-db", db, "--output", db,
              "--K", "2", "--no-plot"])
    fits = {"bgmm": db, "refine": str(root / "refine"),
            "dbscan": str(root / "dbscan")}
    jax_main(["--fit-model", "refine", "--ref-db", db, "--model-dir", db,
              "--output", fits["refine"], "--no-plot"])
    jax_main(["--fit-model", "dbscan", "--ref-db", db, "--output",
              fits["dbscan"], "--no-plot"])
    return db, fits


def read_clusters(out):
    with open(os.path.join(out, os.path.basename(out) + "_clusters.csv")) as f:
        return {r["Taxon"]: r["Cluster"] for r in csv.DictReader(f)}


@pytest.mark.parametrize("stable", ["core", "accessory"])
@pytest.mark.parametrize("model", ["refine", "bgmm", "dbscan"])
def test_session_equals_the_cli_and_the_jax_session(served, split, model,
                                                    stable, tmp_path):
    db, fits = served
    out = str(tmp_path / "cli")
    torch_assign(["--db", db, "--model-dir", fits[model], "--query",
                  split[1], "--output", out, "--stable", stable])
    cli = read_clusters(out)
    session = AssignSession(db, model_dir=fits[model], stable=stable)
    got = session.assign_files(split[1])
    assert got == cli
    assert "NA" in got.values() and set(got.values()) != {"NA"}
    # a second request on the same session (resident references) agrees
    assert session.assign_files(split[1]) == cli
    want = JaxSession(db, model_dir=fits[model],
                      stable=stable).assign_files(split[1])
    assert got == want


def tiles(seed, nq=5, nr=7, ties=False):
    rng = np.random.default_rng(seed)
    d = (rng.random((nq, nr, 2)) * [0.05, 0.4]).astype(np.float32)
    if ties:
        # every query's minimum on both columns is at reference 1 and again
        # at reference 4; reference 5 ties it on the core column alone
        low = d[:, 1].copy()
        d = np.maximum(d, low[:, None] + np.float32(1e-3))
        d[:, 1] = d[:, 4] = low
        d[:, 5, 0] = low[:, 0]
    return d


def post_params():
    """{post name: (static tuples, numpy parameters)} for both packages."""
    rng = np.random.default_rng(11)
    grid = rng.integers(-1, 3, (64, 64)).astype(np.int16)
    return {
        "boundary_stable": ([(s, c) for s in (0, 1, 2) for c in (0, 1)],
                            (np.array([0.05, 0.4], np.float32),
                             np.float32(0.4), np.float32(0.5))),
        "bgmm_stable": ([(c, w) for c in (0, 1) for w in (0, 1)],
                        (np.array([0.4, 0.6], np.float32),
                         np.array([[0.2, 0.2], [0.7, 0.7]], np.float32),
                         np.stack([np.eye(2, dtype=np.float32) * 0.05,
                                   np.array([[0.04, 0.01], [0.01, 0.03]],
                                            np.float32)]),
                         np.array([0.05, 0.4], np.float32))),
        "dbscan_stable": ([(c, w) for c in (0, 1) for w in (0, 1, 2)],
                          (grid, np.float32(0.0), np.float32(1 / 40),
                           np.float32(0.0), np.float32(1 / 40),
                           np.array([0.05, 0.4], np.float32))),
    }


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("name", sorted(post_params()))
def test_stable_posts_equal_the_jax_posts(name, ties):
    statics, params = post_params()[name]
    for seed in range(3):
        d = tiles(seed, ties=ties)
        for static in statics:
            want = np.asarray(jax_fused.POST_FNS[name](
                jnp.asarray(d), tuple(jnp.asarray(p) for p in params),
                static))
            got = torch_fused.POST_FNS[name](
                torch.from_numpy(d), tuple(torch.as_tensor(p)
                                           for p in params), static)
            assert got.dtype == torch.int32 and got.shape == (5, 2)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{static}")
            nn = got.numpy()[:, 0]
            dist_col = static[1] if name == "boundary_stable" else static[0]
            # the first minimum, as np.argmin
            np.testing.assert_array_equal(nn, d[..., dist_col].argmin(1))
            if ties:
                assert (nn == 1).all()
            assert set(got.numpy()[:, 1]) <= {0, 1}


# the posts that classify by a BGMM, with their statics
BGMM_POSTS = {"bgmm": [()],
              "bgmm_stable": post_params()["bgmm_stable"][0],
              "edges": [("bgmm", (), w) for w in (0, 1)]}


def _outputs(result):
    return result if isinstance(result, tuple) else (result,)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("name", sorted(BGMM_POSTS))
def test_factored_bgmm_posts_equal_the_raw_posts(name, ties):
    """A spec placed by ``post_spec_on`` carries the mixture factored once;
    its classes equal, bit for bit, those of the raw four-tuple spec, which
    factors on every call (``edges``: the head and the compacted
    columns)."""
    from poppunk_tpu_torch.models.bgmm import MixtureFactor

    params = tuple(torch.as_tensor(p)
                   for p in post_params()["bgmm_stable"][1])
    for seed in range(3):
        d = torch.from_numpy(tiles(seed, ties=ties))
        for static in BGMM_POSTS[name]:
            raw = (name, static, params)
            placed = torch_fused.post_spec_on(raw, CPU)
            assert isinstance(placed[2], MixtureFactor)
            want = _outputs(torch_fused.apply_post(d, raw))
            assert all(torch.equal(a, b) for a, b in zip(
                _outputs(torch_fused.POST_FNS[name](d, params, static)),
                want))
            got = _outputs(torch_fused.apply_post(d, placed))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                              err_msg=f"{static}")


def _log_likelihood_before_the_split(X, weights, means, covariances, scale):
    """models/bgmm.log_likelihood as one function, as it was before the
    factor was split out of it."""
    import math

    X = X / scale
    chol = torch.linalg.cholesky(covariances)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    d = X.shape[1]
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                         upper=False)
    y = torch.einsum("...kij,...nkj->...nki", linv,
                     X[:, None, :] - means[None, :, :])
    maha = (y ** 2).sum(-1)
    log_prob = -0.5 * (maha + d * math.log(2 * math.pi) + logdet[None, :])
    lpr = log_prob + torch.log(weights)[None, :]
    return torch.logsumexp(lpr, dim=1), lpr


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_the_split_likelihood_is_bit_equal(ties):
    from poppunk_tpu_torch.models.bgmm import GaussianMixture

    params = tuple(torch.as_tensor(p)
                   for p in post_params()["bgmm_stable"][1])
    mixture = GaussianMixture(*params)
    for seed in range(3):
        X = torch.from_numpy(tiles(seed, ties=ties)).reshape(-1, 2)
        got = mixture.log_likelihood(X)
        want = _log_likelihood_before_the_split(X, *params)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("model", ["refine", "bgmm", "dbscan"])
def test_stable_post_specs_equal_the_jax_specs(served, model):
    from poppunk_tpu.models import load_cluster_fit as jax_load
    from poppunk_tpu_torch.models import load_cluster_fit

    base = os.path.join(served[1][model], os.path.basename(served[1][model]))
    jax_model = jax_load(base + "_fit.pkl", base + "_fit.npz")
    torch_model = load_cluster_fit(base + "_fit.pkl", base + "_fit.npz",
                                   device=CPU)
    for dist_col in (0, 1):
        want = jax_fused.stable_post_spec(jax_model, dist_col)
        got = torch_fused.stable_post_spec(torch_model, dist_col)
        assert got[:2] == want[:2]
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_warmup_runs_ten_buckets(served):
    assert AssignSession(served[0]).warmup() == 10  # buckets 1..512


def test_geometry_mismatch_is_refused(served):
    from poppunk_tpu_torch.sketch.minhash import Sketch

    session = AssignSession(served[0])
    ss = session.ss64 // 2  # any value != the db's geometry
    wrong = Sketch(name="q0", usigs={k: np.zeros(ss * session.bbits,
                                                 np.uint64)
                                     for k in session.kmers},
                   sketchsize64=ss, bbits=session.bbits,
                   length=2_000_000, missing_bases=0,
                   base_freq=(0.25, 0.25, 0.25, 0.25))
    with pytest.raises(ValueError, match="geometry"):
        session.assign_sketches([wrong])


def test_a_lineage_model_is_refused(served, tmp_path):
    db = str(tmp_path / "lineage" / "db")
    shutil.copytree(served[0], db)
    torch_main(["--fit-model", "lineage", "--ranks", "1,2", "--ref-db", db,
                "--output", db, "--no-plot"])
    with pytest.raises(RuntimeError, match="got lineage"):
        AssignSession(db)


def test_assign_files_takes_lists_and_the_spawn_pool(served, split):
    names, files = [], []
    with open(split[1]) as f:
        for line in f:
            n, p = line.split()
            names.append(n)
            files.append(p)
    session = AssignSession(served[0])
    via_rfile = session.assign_files(split[1])
    assert session.assign_files((names, files)) == via_rfile
    assert session.assign_files(split[1], threads=2) == via_rfile
    with pytest.raises(TypeError, match="rfile path"):
        session.assign_files(["a.fa", "b.fa"])


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["refine", "bgmm", "dbscan"])
def test_the_session_on_the_card_equals_the_cpu(served, split, model):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    db, fits = served
    card = AssignSession(db, model_dir=fits[model],
                         device=torch.device("cuda", 0))
    assert card.warmup() == 10
    cpu = AssignSession(db, model_dir=fits[model], device=CPU)
    assert card.assign_files(split[1]) == cpu.assign_files(split[1])
