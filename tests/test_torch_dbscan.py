"""The port's DBSCAN model and HDBSCAN against the JAX package's, on the CPU.

- The Boruvka MST (torch ops over row tiles) against the JAX package's
  jitted scan and the host Prim oracle, on the cloud of
  test_hdbscan_shapes.py (n 1200 with exact duplicate points, tile 128):
  equal weight multisets, to rtol 1e-6 against JAX (XLA on the CPU may
  contract dx*dx + dy*dy into an FMA, torch does not) and atol 1e-5
  against Prim.
- ``DBSCANFit`` at 6,000 points, above the n >= 4096 gate, so both
  packages fit through Boruvka: equal labels, cluster counts, within /
  between labels, assignments and cluster boxes.
- The decision grid and the fused ``dbscan`` post equal the JAX
  package's element for element.
- Artefacts: each package loads the other's ``_fit.pkl``; loading a
  JAX-written fit in the port imports neither jax nor the JAX package
  (a fresh interpreter); a foreign (PopPUNK ``hdbscan``) pickle goes
  through ``rebuild_hdbscan_from_state``.
"""

import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poppunk_tpu.models.base import load_cluster_fit as jax_load
from poppunk_tpu.models.dbscan import DBSCANFit as JaxDBSCANFit
from poppunk_tpu.ops import fused_assign as jax_fused
from poppunk_tpu.ops import hdbscan as jax_hdbscan
from poppunk_tpu_torch.models import compat
from poppunk_tpu_torch.models.base import load_cluster_fit as torch_load
from poppunk_tpu_torch.models.dbscan import DBSCANFit as TorchDBSCANFit
from poppunk_tpu_torch.ops import fused_assign as torch_fused
from poppunk_tpu_torch.ops import hdbscan as torch_hdbscan
from test_models import make_dist_cloud

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def duplicate_cloud():
    """tests/test_hdbscan_shapes.py::test_boruvka_matches_prim's points
    and core distances."""
    rng = np.random.default_rng(3)
    n = 1200
    centers = np.array([[0.02, 0.05], [0.12, 0.25], [0.3, 0.5]])
    X = np.abs(centers[rng.integers(0, 3, n)] + rng.normal(0, 0.012, (n, 2)))
    X[100:150] = X[0:50]  # exact ties stress the cut-rule tie-breaking
    core, _ = jax_hdbscan.core_distances(X, 10)
    return X, core


def test_boruvka_matches_the_jax_package_and_prim():
    X, core = duplicate_cloud()
    X32, core32 = X.astype(np.float32), core.astype(np.float32)
    got = torch_hdbscan.boruvka_mst_device(X32, core32, tile=128, device=CPU)
    want = jax_hdbscan.boruvka_mst_device(X32, core32, tile=128)
    prim = jax_hdbscan.mutual_reachability_mst(X, core)  # n < 4096: Prim
    assert got.shape == want.shape == prim.shape
    np.testing.assert_allclose(np.sort(got[:, 2]), np.sort(want[:, 2]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(np.sort(got[:, 2]), np.sort(prim[:, 2]),
                               rtol=0, atol=1e-5)
    # a spanning tree: n - 1 edges joining every vertex
    labels = torch_hdbscan.single_linkage(got[np.argsort(got[:, 2])],
                                          X.shape[0])
    assert labels[-1, 3] == X.shape[0]


def test_prim_and_the_small_n_path_equal_the_jax_package():
    X, core = duplicate_cloud()
    want = jax_hdbscan.mutual_reachability_mst(X, core)
    np.testing.assert_array_equal(
        torch_hdbscan.mutual_reachability_mst(X, core), want)
    prim = torch_hdbscan.prim_mst(X, core)
    np.testing.assert_array_equal(
        prim[np.argsort(prim[:, 2], kind="stable")], want)


def test_boruvka_round_against_a_dense_oracle():
    """One round at a ragged size (padding in the last tile): per vertex
    the minimum mutual reachability to another component, and the first
    column achieving it."""
    rng = np.random.default_rng(5)
    n, tile = 300, 64
    X = rng.random((n, 2)).astype(np.float32)
    core = (rng.random(n) * 0.05).astype(np.float32)
    comp = rng.integers(0, 7, n).astype(np.int32)
    n_pad = -(-n // tile) * tile
    Xp = np.zeros((n_pad, 2), np.float32)
    Xp[:n] = X
    corep = np.full(n_pad, 3.4e38, np.float32)
    corep[:n] = core
    compp = np.full(n_pad, -1, np.int32)
    compp[:n] = comp
    w, j = torch_hdbscan._boruvka_round(
        torch.as_tensor(Xp), torch.as_tensor(corep), torch.as_tensor(compp),
        n, tile)
    d = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    mr = np.maximum(d, np.maximum(core[:, None], core[None, :]))
    mr[comp[:, None] == comp[None, :]] = np.inf
    np.testing.assert_allclose(w.numpy()[:n], mr.min(axis=1), rtol=1e-6)
    jw = mr[np.arange(n), j.numpy()[:n]]
    np.testing.assert_allclose(jw, mr.min(axis=1), rtol=1e-6)


# --------------------------------------------------------------------------
# DBSCANFit at 6,000 points: both packages through Boruvka


@pytest.fixture(scope="module")
def cloud():
    return make_dist_cloud(1200, 4800)


@pytest.fixture(scope="module")
def fits(cloud, tmp_path_factory):
    """{package: (fitted model, assignments)}; both saved."""
    root = tmp_path_factory.mktemp("torch_dbscan")
    out = {}
    for pkg, cls, kw in (("jax", JaxDBSCANFit, {}),
                         ("torch", TorchDBSCANFit, {"device": CPU})):
        model = cls(str(root / pkg / "db"), **kw)
        y = model.fit(cloud, 100, 0.0001)
        model.save()
        out[pkg] = (model, y)
    return out


def test_the_fit_takes_the_boruvka_path(fits):
    model, _ = fits["torch"]
    assert model.subsampled_X.shape[0] >= 4096


def test_dbscan_fit_equals_the_jax_package(fits):
    (jm, jy), (tm, ty) = fits["jax"], fits["torch"]
    np.testing.assert_array_equal(tm.labels, jm.labels)
    np.testing.assert_array_equal(tm.hdb.labels_, jm.hdb.labels_)
    assert (tm.n_clusters, tm.within_label, tm.between_label) == \
        (jm.n_clusters, jm.within_label, jm.between_label)
    np.testing.assert_array_equal(ty, jy)
    for key in ("cluster_means", "cluster_mins", "cluster_maxs", "scale"):
        np.testing.assert_allclose(getattr(tm, key), getattr(jm, key),
                                   rtol=1e-6, err_msg=key)
    assert tm.n_clusters >= 2
    assert np.mean(ty[:1200] == tm.within_label) > 0.9


def test_decision_grid_equals_the_jax_package(fits):
    got = fits["torch"][0].decision_grid(1024)
    want = fits["jax"][0].decision_grid(1024)
    assert got[0].dtype == want[0].dtype == np.int16
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_post_dbscan_equals_the_jax_package(fits, cloud):
    """The fused post of each package on the same distances: equal labels,
    and equal to the model's own grid assignment."""
    model = fits["torch"][0]
    rng = np.random.default_rng(9)
    dists = np.concatenate([cloud[:2000], rng.random((496, 2)) * 0.6,
                            -rng.random((4, 2))]).astype(np.float32)
    dists = dists.reshape(25, 100, 2)  # a [nq, nr, 2] tile
    spec = torch_fused.model_post_spec(model)
    assert spec[0] == "dbscan"
    got = torch_fused.apply_post(torch.as_tensor(dists), spec).numpy()
    want = np.asarray(jax_fused.apply_post(
        jnp.asarray(dists), jax_fused.model_post_spec(fits["jax"][0])))
    assert got.shape == dists.shape[:-1]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got.reshape(-1), model.assign(dists.reshape(-1, 2), use_grid=True))


@pytest.mark.parametrize("reader,writer", [("torch", "jax"),
                                           ("jax", "torch")])
def test_each_package_loads_the_others_fit(fits, cloud, reader, writer):
    prefix = fits[writer][0].outPrefix
    base = os.path.join(prefix, os.path.basename(prefix))
    if reader == "torch":
        loaded = torch_load(base + "_fit.pkl", base + "_fit.npz", device=CPU)
        assert isinstance(loaded.hdb, torch_hdbscan.HDBSCAN)
    else:
        loaded = jax_load(base + "_fit.pkl", base + "_fit.npz")
    assert loaded.type == "dbscan" and loaded.fitted
    assert (loaded.within_label, loaded.between_label) == \
        (fits[writer][0].within_label, fits[writer][0].between_label)
    np.testing.assert_array_equal(loaded.assign(cloud, max_batch_size=1000),
                                  fits[writer][1])


def test_a_port_written_pickle_holds_no_device(fits):
    prefix = fits["torch"][0].outPrefix
    with open(os.path.join(prefix, "db_fit.pkl"), "rb") as f:
        hdb, fit_type = pickle.load(f)
    assert fit_type == "dbscan"
    assert "_device" not in vars(hdb)
    assert not any(isinstance(v, (torch.Tensor, torch.device))
                   for v in vars(hdb).values())


def test_loading_a_jax_written_fit_imports_no_jax(fits, cloud, tmp_path):
    """In a fresh interpreter the port loads the JAX package's DBSCAN fit
    (whose pickle names poppunk_tpu.ops.hdbscan classes) and assigns with
    it; neither jax nor the JAX package is imported."""
    prefix = fits["jax"][0].outPrefix
    base = os.path.join(prefix, "db")
    np.save(tmp_path / "cloud.npy", cloud[:500])
    np.save(tmp_path / "want.npy", fits["jax"][1][:500])
    script = f"""
import sys
import numpy as np
from poppunk_tpu_torch.models import load_cluster_fit
from poppunk_tpu_torch.ops.hdbscan import CondensedTree, HDBSCAN
model = load_cluster_fit({base + "_fit.pkl"!r}, {base + "_fit.npz"!r})
assert type(model.hdb) is HDBSCAN, type(model.hdb)
assert type(model.hdb._condensed) is CondensedTree
got = model.assign(np.load({str(tmp_path / "cloud.npy")!r}))
assert np.array_equal(got, np.load({str(tmp_path / "want.npy")!r}))
loaded = sorted(m for m in sys.modules if m in ('jax', 'poppunk_tpu')
                or m.startswith(('jax.', 'poppunk_tpu.')))
assert not loaded, loaded
print('NO_JAX_OK')
"""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               POPPUNK_TPU_TORCH_DEVICE="cpu")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr


def test_other_jax_package_classes_load_as_stubs(tmp_path):
    """A class of the JAX package other than the two HDBSCAN classes
    becomes a ForeignStub, never an import of that package."""
    from poppunk_tpu.ops.hdbscan import CondensedTree

    from test_reference_pickles import _pickle_with_fake_module

    path = str(tmp_path / "other.pkl")
    _pickle_with_fake_module({"a": 1}, "poppunk_tpu.not_a_module", "Thing",
                             "dbscan", path)
    obj, fit_type = compat.tolerant_pickle_load(path)
    assert compat.is_foreign(obj) and obj.a == 1 and fit_type == "dbscan"
    assert repr(obj) == "<ForeignStub poppunk_tpu.not_a_module.Thing>"
    tree = CondensedTree(*(np.arange(3),) * 4)
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    got = compat.tolerant_pickle_load(path)
    assert type(got) is torch_hdbscan.CondensedTree
    np.testing.assert_array_equal(got.lambda_val, tree.lambda_val)


def foreign_dbscan(tmp_path):
    """A reference-style DBSCAN artefact whose pkl holds a stand-in
    hdbscan.HDBSCAN with training data and an hdbscan-style condensed
    tree (tests/test_reference_pickles.py's construction)."""
    from test_reference_pickles import _pickle_with_fake_module

    rng = np.random.default_rng(42)
    X = np.vstack([rng.normal([0.1, 0.15], 0.01, (120, 2)),
                   rng.normal([0.5, 0.6], 0.02, (120, 2))]).clip(1e-4, None)
    ours = jax_hdbscan.HDBSCAN(min_samples=10, min_cluster_size=10).fit(X)
    ct = ours._condensed
    tree = np.empty(len(ct.parent), dtype=[
        ("parent", np.int64), ("child", np.int64),
        ("lambda_val", np.float64), ("child_size", np.int64)])
    tree["parent"], tree["child"] = ct.parent, ct.child
    tree["lambda_val"], tree["child_size"] = ct.lambda_val, ct.child_size
    d = tmp_path / "foreign"
    d.mkdir()
    pkl_file, npz_file = str(d / "foreign_fit.pkl"), str(d / "foreign_fit.npz")
    _pickle_with_fake_module(
        {"labels_": ours.labels_, "probabilities_": ours.probabilities_,
         "_raw_data": X, "min_samples": 10, "min_cluster_size": 10,
         "_condensed_tree": tree}, "hdbscan", "HDBSCAN", "dbscan", pkl_file)
    labs = ours.labels_
    k = labs.max() + 1
    means = np.array([X[labs == i].mean(axis=0) for i in range(k)])
    np.savez(npz_file, n_clusters=k,
             within=int(np.argmin(means.sum(axis=1))),
             between=int(np.argmax(means.sum(axis=1))), means=means,
             maxs=np.array([X[labs == i].max(axis=0) for i in range(k)]),
             mins=np.array([X[labs == i].min(axis=0) for i in range(k)]),
             scale=np.array([1.0, 1.0]), assign_points=True)
    return pkl_file, npz_file, ours


def test_a_foreign_pickle_is_rebuilt_like_the_jax_package(tmp_path):
    pkl_file, npz_file, ours = foreign_dbscan(tmp_path)
    got = torch_load(pkl_file, npz_file, device=CPU)
    want = jax_load(pkl_file, npz_file)
    assert isinstance(got.hdb, torch_hdbscan.HDBSCAN)
    assert got.hdb._cluster_birth_lambda == want.hdb._cluster_birth_lambda
    assert got.hdb._cluster_max_lambda == want.hdb._cluster_max_lambda
    rng = np.random.default_rng(7)
    Y = np.vstack([rng.normal([0.1, 0.15], 0.01, (50, 2)),
                   rng.normal([0.5, 0.6], 0.02, (50, 2)),
                   [[0.3, 0.9]]]).clip(1e-4, None)
    labels = got.hdb.approximate_predict(Y)[0]
    np.testing.assert_array_equal(labels, want.hdb.approximate_predict(Y)[0])
    np.testing.assert_array_equal(labels, ours.approximate_predict(Y)[0])


@pytest.mark.cuda
def test_boruvka_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(11)
    n = 5000
    centers = np.array([[0.02, 0.05], [0.12, 0.25], [0.3, 0.5]])
    X = np.abs(centers[rng.integers(0, 3, n)] + rng.normal(0, 0.012, (n, 2)))
    X[100:150] = X[0:50]
    core, _ = torch_hdbscan.core_distances(X, 10)
    X32, core32 = X.astype(np.float32), core.astype(np.float32)
    card = torch_hdbscan.boruvka_mst_device(X32, core32,
                                            device=torch.device("cuda"))
    host = torch_hdbscan.boruvka_mst_device(X32, core32, device=CPU)
    np.testing.assert_allclose(np.sort(card[:, 2]), np.sort(host[:, 2]),
                               rtol=0, atol=1e-6)
