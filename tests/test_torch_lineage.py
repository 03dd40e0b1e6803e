"""The port's lineage model and sparse kNN against the JAX package's.

Both are host numpy (the port's are copies): on the same seeded distances
the kNN, every lower-rank mode and the query extension give equal arrays,
and ``LineageFit`` fits, extends, saves and loads to equal COO structures,
with the tests/test_models.py::TestLineageFit setups.
"""

import numpy as np
import pytest
import scipy.sparse

from poppunk_tpu.models.base import load_cluster_fit as jax_load
from poppunk_tpu.models.lineage import LineageFit as JaxLineageFit
from poppunk_tpu.ops import sparse_knn as jax_knn
from poppunk_tpu_torch.models.base import load_cluster_fit as torch_load
from poppunk_tpu_torch.models.lineage import LineageFit as TorchLineageFit
from poppunk_tpu_torch.ops import sparse_knn as torch_knn

PACKAGES = {"jax": (JaxLineageFit, jax_load),
            "torch": (TorchLineageFit, torch_load)}


def square(n, seed, ties=True):
    """A symmetric float32 distance matrix with a zero diagonal; with
    ``ties`` some rows repeat distances exactly."""
    rng = np.random.default_rng(seed)
    sq = rng.random((n, n)).astype(np.float32) * 0.5 + 0.01
    if ties:
        sq = np.round(sq, 2)
    sq = (sq + sq.T) / 2
    np.fill_diagonal(sq, 0)
    return sq


def condensed(sq, idx):
    i, j = np.triu_indices(len(idx), 1)
    d = sq[np.asarray(idx)[i], np.asarray(idx)[j]]
    return np.stack([d, d[::-1].copy()], axis=1).astype(np.float32)


def assert_equal_triples(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("knn", [3, 10, 59])
def test_knn_from_condensed(knn):
    sq = square(60, 1)
    vec = condensed(sq, range(60))[:, 0]
    assert_equal_triples(torch_knn.knn_from_condensed(vec, 60, knn),
                         jax_knn.knn_from_condensed(vec, 60, knn))


@pytest.mark.parametrize("mode", ["plain", "count_unique_distances",
                                  "reciprocal_only"])
@pytest.mark.parametrize("rank", [1, 3])
def test_lower_rank(mode, rank):
    n = 50
    vec = condensed(square(n, 2), range(n))[:, 0]
    higher = jax_knn.knn_from_condensed(vec, n, 12)
    kw = dict(reciprocal_only=mode == "reciprocal_only",
              count_unique_distances=mode == "count_unique_distances",
              epsilon=1e-3)
    assert_equal_triples(torch_knn.lower_rank(higher, n, rank, **kw),
                         jax_knn.lower_rank(higher, n, rank, **kw))


def test_extend():
    n_all, n_ref, knn = 40, 28, 8
    sq = square(n_all, 3)
    higher = jax_knn.get_knn_distances(sq[:n_ref, :n_ref], knn)
    qq = sq[n_ref:, n_ref:]
    qr = sq[:n_ref, n_ref:]
    assert_equal_triples(torch_knn.extend(higher, qq, qr, knn),
                         jax_knn.extend(higher, qq, qr, knn))


def make(pkg, tmp_path, name, ranks=(1, 2), **kw):
    return PACKAGES[pkg][0](
        str(tmp_path / pkg / name), list(ranks), max_search_depth=10,
        reciprocal_only=False, count_unique_distances=False,
        lineage_resolution=1e-10, dist_col=0, **kw)


def assert_same_model(got, want):
    assert got.ranks == want.ranks
    for a, b in [(got.nn_dists, want.nn_dists)] + [
            (got.lower_rank_dists[r], want.lower_rank_dists[r])
            for r in want.ranks]:
        a, b = a.tocoo(), b.tocoo()
        assert a.shape == b.shape and a.dtype == b.dtype
        for field in ("row", "col", "data"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))


def test_fit_extend_save_load(tmp_path):
    """TestLineageFit's fit-on-references-then-extend setup through both
    packages, then each package loads both packages' artefacts."""
    n_all, n_ref = 30, 22
    sq = square(n_all, 11, ties=False)
    qq = condensed(sq, range(n_ref, n_all))
    n_q = n_all - n_ref
    qr = np.zeros((n_q * n_ref, 2), np.float32)
    for q in range(n_q):
        qr[q * n_ref:(q + 1) * n_ref] = sq[n_ref + q, :n_ref, None]
    models, edges = {}, {}
    for pkg in PACKAGES:
        model = make(pkg, tmp_path, "lin")
        edges[pkg] = [model.fit(condensed(sq, range(n_ref)))]
        edges[pkg].append(model.extend(qq, qr))
        model.save()
        models[pkg] = model
    assert edges["torch"] == edges["jax"]
    assert_same_model(models["torch"], models["jax"])
    for pkg in PACKAGES:
        prefix = models[pkg].outPrefix + "/lin"
        for rank in (1, 2):
            a = scipy.sparse.load_npz(f"{prefix}_rank_{rank}_fit.npz")
            b = models["jax"].lower_rank_dists[rank]
            assert (a != b).nnz == 0
        for reader, (_, load) in PACKAGES.items():
            loaded = load(prefix + "_fit.pkl", prefix + "_fit.npz")
            assert loaded.type == "lineage", (reader, pkg)
            assert_same_model(loaded, models["jax"])
            assert sorted(loaded.assign(1)) == sorted(models["jax"].assign(1))
