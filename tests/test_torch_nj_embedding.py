"""The port's device NJ (ops/nj_device.py) and SCE embedding
(embedding.py) against the JAX package's, on the CPU.

- NJ: the torch join loop against ``poppunk_tpu.ops.nj_device`` and the
  host float64 NJ by patristic distance matrices (rtol 1e-4, atol 1e-5, as
  tests/test_nj_device.py), on random metrics and on an additive tree,
  which it must recover. The routing is the reference's: below 512
  genomes, or off the card, the host NJ runs in both packages.
- SCE: both optimisers for 5 epochs against the JAX ones, with the JAX
  package's initial embedding and (sampled branch) negatives drawn here
  from its key schedule and injected. float32 on both sides, summed in
  other orders: the embeddings agree to rtol 1e-4 of their own scale
  (atol ``SCE_ATOL`` x max |Y|). Both branches separate two clusters by
  the centroid test of tests/test_embedding.py, and the .dot names are
  the JAX package's, in its order (coordinates come from other random
  generators and are not compared).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poppunk_tpu.embedding as jax_emb
from poppunk_tpu.ops.nj_device import \
    neighbor_joining_device as jax_nj_device
from poppunk_tpu.trees import neighbor_joining as jax_host_nj
from poppunk_tpu_torch import embedding
from poppunk_tpu_torch.ops import nj_device
from poppunk_tpu_torch.trees import Node, generate_nj_tree, neighbor_joining
from test_embedding import two_cluster_distmat
from test_nj_device import patristic_matrix

torch.set_num_threads(2)

CPU = torch.device("cpu")
PATRISTIC_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_nj_device.py
SCE_ATOL = 1e-4  # times max |Y|: float32 sums in other orders, 5 epochs


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, as a CPU-only host must."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


def random_metric(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3))
    return np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))


@pytest.mark.parametrize("n,seed", [(8, 0), (20, 1), (45, 2)])
def test_nj_equals_the_jax_device_nj_and_the_host_nj(n, seed):
    D = random_metric(n, seed)
    labels = [f"s{i}" for i in range(n)]
    got = patristic_matrix(
        nj_device.neighbor_joining_device(D.copy(), labels, CPU), labels)
    np.testing.assert_allclose(got, patristic_matrix(
        jax_nj_device(D.copy(), labels), labels), **PATRISTIC_TOL)
    np.testing.assert_allclose(got, patristic_matrix(
        jax_host_nj(D.copy(), labels), labels), **PATRISTIC_TOL)


def test_nj_recovers_an_additive_tree():
    rng = np.random.default_rng(3)
    n = 12
    leaves = [Node(f"s{i}", float(rng.random() + 0.1)) for i in range(n)]
    root = cur = Node()
    for i, leaf in enumerate(leaves[:-1]):
        nxt = Node(None, float(rng.random() * 0.5 + 0.05)) \
            if i < n - 2 else leaves[-1]
        cur.add_child(leaf)
        cur.add_child(nxt)
        cur = nxt
    labels = [f"s{i}" for i in range(n)]
    D = patristic_matrix(root, labels)
    tree = nj_device.neighbor_joining_device(D, labels, CPU)
    np.testing.assert_allclose(patristic_matrix(tree, labels), D,
                               **PATRISTIC_TOL)


def test_the_host_nj_runs_below_512_genomes_and_off_the_card(tmp_path):
    from poppunk_tpu.trees import generate_nj_tree as jax_generate_nj_tree

    assert not nj_device.use_device_nj(511, CPU)
    assert not nj_device.use_device_nj(4096, CPU)
    D = random_metric(20, 4)
    labels = [f"s{i}" for i in range(20)]
    assert generate_nj_tree(D, labels, str(tmp_path)) == \
        jax_generate_nj_tree(D, labels, str(tmp_path))
    # the port's host NJ is the JAX package's, bit for bit
    assert patristic_matrix(neighbor_joining(D, labels), labels).tolist() \
        == patristic_matrix(jax_host_nj(D, labels), labels).tolist()


@pytest.mark.cuda
def test_nj_on_the_card_equals_the_cpu_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    D = random_metric(600, 5)
    labels = [f"s{i}" for i in range(600)]
    assert nj_device.use_device_nj(600, torch.device("cuda", 0))
    card = nj_device.neighbor_joining_device(D, labels,
                                             torch.device("cuda", 0))
    cpu = nj_device.neighbor_joining_device(D, labels, CPU)
    np.testing.assert_allclose(patristic_matrix(card, labels),
                               patristic_matrix(cpu, labels),
                               **PATRISTIC_TOL)


def knn_affinities(n1=20, n2=20, knn=10, perplexity=10):
    from poppunk_tpu_torch.ops.sparse_knn import get_knn_distances

    D, labels = two_cluster_distmat(n1, n2)
    n = D.shape[0]
    I, J, dists = get_knn_distances(D, knn)
    P = embedding._perplexity_probabilities(
        np.asarray(dists).reshape(n, knn), perplexity).reshape(-1)
    return np.asarray(I), np.asarray(J), P, n


def assert_close_embeddings(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=SCE_ATOL * np.abs(want).max())


def test_dense_optimiser_equals_the_jax_one_for_5_epochs():
    I, J, P, n = knn_affinities()
    Pmat = np.zeros((n, n), dtype=np.float32)
    Pmat[I, J] += P
    Pmat[J, I] += P
    key = jax.random.PRNGKey(42)
    want = jax_emb._sce_optimize_dense(key, jnp.asarray(Pmat), n=n,
                                       epochs=5)
    _, init_key = jax.random.split(key)
    Y0 = np.array(jax.random.normal(init_key, (n, 2), jnp.float32) * 1e-4)
    got = embedding._sce_optimize_dense(
        None, torch.from_numpy(Pmat), n, 5, Y0=torch.from_numpy(Y0))
    assert_close_embeddings(got.numpy(), want)


def test_sampled_optimiser_equals_the_jax_one_for_5_epochs():
    I, J, P, n = knn_affinities()
    epochs, n_neg = 5, 5
    key = jax.random.PRNGKey(42)
    want = jax_emb._sce_optimize_sampled(
        key, jnp.asarray(I, jnp.int32), jnp.asarray(J, jnp.int32),
        jnp.asarray(P, jnp.float32), n=n, epochs=epochs)
    # the JAX package's key schedule: the initial embedding, then one key
    # per epoch for that epoch's negatives
    key, init_key = jax.random.split(key)
    Y0 = np.array(jax.random.normal(init_key, (n, 2), jnp.float32) * 1e-2)
    negatives = []
    for _ in range(epochs):
        key, k1 = jax.random.split(key)
        negatives.append(np.asarray(
            jax.random.randint(k1, (len(I), n_neg), 0, n)))
    index = lambda a: torch.as_tensor(a, dtype=torch.int64)  # noqa: E731
    got = embedding._sce_optimize_sampled(
        None, index(I), index(J), torch.as_tensor(P, dtype=torch.float32),
        n, epochs, n_neg=n_neg, Y0=torch.from_numpy(Y0),
        negatives=index(np.stack(negatives)))
    assert_close_embeddings(got.numpy(), want)


def separation(Y, labels):
    c0, c1 = Y[labels == 0].mean(0), Y[labels == 1].mean(0)
    within = max(np.linalg.norm(Y[labels == 0] - c0, axis=1).mean(),
                 np.linalg.norm(Y[labels == 1] - c1, axis=1).mean())
    return np.linalg.norm(c0 - c1) / within


@pytest.mark.parametrize("branch", ["dense", "sampled"])
def test_both_branches_separate_two_clusters(branch, monkeypatch):
    if branch == "sampled":
        monkeypatch.setattr(embedding, "DENSE_LIMIT", 16)
    D, labels = two_cluster_distmat()
    Y = embedding.sce_embedding(D, perplexity=10, knn=10, max_iter=200_000)
    assert Y.shape == (40, 2) and np.isfinite(Y).all()
    assert separation(Y, labels) > 1.5


def test_dot_names_are_the_jax_packages(tmp_path):
    D, _ = two_cluster_distmat(8, 8)
    labels = [f"s{i}" for i in range(16)]
    dots = {}
    for name, module in (("torch", embedding), ("jax", jax_emb)):
        out = tmp_path / name / "embed"
        out.mkdir(parents=True)
        fn = module.generate_embedding(labels, D, 5, str(out),
                                       overwrite=True, kNN=5,
                                       maxIter=10_000)
        with open(fn) as f:
            text = f.read()
        assert text.startswith("graph G {") and text.endswith("}\n")
        dots[name] = (fn.split("/")[-1],
                      [part.split("[")[0] for part in text[10:].split("; ")
                       if "[" in part])
        # no overwrite: the existing file stays
        assert module.generate_embedding(labels, D, 5, str(out), False) == fn
    assert dots["torch"] == dots["jax"]
    assert dots["torch"][1] == [f'"{lab}"' for lab in labels]
