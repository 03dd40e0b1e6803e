"""The port's device sparse sweep (poppunk_tpu_torch/ops/sparse_sweep.py)
against the JAX package's and the host scorer, on the CPU.

Scores within rtol 1e-5 atol 1e-7, the JAX package's own tolerance against
the host oracle (tests/test_sparse_sweep.py:89): the port counts triangles,
degrees and wedges exactly in int64 and takes each score as one float64
expression of them, so it differs from the host scorer by rounding alone
and from the JAX package (float32 sums) by that package's rounding. Edge
counts are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poppunk_tpu.network.incremental import grow_network_scores
from poppunk_tpu.ops import sparse_sweep as jss
from poppunk_tpu_torch.ops import sparse_sweep as tss

torch.set_num_threads(2)

SCORE_TOL = dict(rtol=1e-5, atol=1e-7)


def edges_both(i, j, d0, n, alloc=None):
    """(JAX, port) SweepEdges over the same (i, j, d0) with pad slots."""
    e = len(i)
    alloc = alloc or max(4 * e, 64)
    bi = np.full(alloc, n, np.int32)
    bj = np.full(alloc, n, np.int32)
    bd = np.full(alloc, np.inf, np.float32)
    bi[:e], bj[:e], bd[:e] = i, j, d0
    return (jss.SweepEdges(jnp.asarray(bi), jnp.asarray(bj), jnp.asarray(bd),
                           e, n),
            tss.SweepEdges(torch.from_numpy(bi), torch.from_numpy(bj),
                           torch.from_numpy(bd), e, n))


def host_scores(n, i, j, d0, ts):
    idx = np.searchsorted(ts, d0, side="left").astype(np.int32)
    keep = idx < len(ts)
    return grow_network_scores(n, np.asarray(i)[keep], np.asarray(j)[keep],
                               idx[keep], len(ts), 0, 100,
                               rng=np.random.default_rng(1))


def check(i, j, d0, n, ts):
    """Port scores against the host scorer and the JAX package; counts
    exact."""
    je, te = edges_both(i, j, d0, n)
    got, counts = tss.sweep_scores_sparse_device(te, ts)
    want, want_counts = jss.sweep_scores_sparse_device(je, ts)
    np.testing.assert_allclose(got, host_scores(n, i, j, d0, ts),
                               **SCORE_TOL)
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(
        counts, np.searchsorted(np.sort(d0), np.asarray(ts, np.float32),
                                side="right"))
    return got, counts


def random_graph(n, m, seed):
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < m:
        a, b = rng.integers(0, n, 2)
        if a != b:
            pairs.add((min(a, b), max(a, b)))
    pairs = np.array(sorted(pairs), np.int32)
    return pairs[:, 0], pairs[:, 1], rng.uniform(0, 1, m).astype(np.float32)


@pytest.mark.parametrize("n,m,seed", [(200, 3000, 0), (70, 900, 1)])
def test_random_graph(n, m, seed):
    i, j, d0 = random_graph(n, m, seed)
    check(i, j, d0, n, np.linspace(0.05, 1.0, 17))


def test_deltas_longer_than_a_block(monkeypatch):
    """A delta of many _TRI_BLOCK blocks, set and counted block by block,
    scores as one block does."""
    i, j, d0 = random_graph(150, 2500, 7)
    ts = np.array([0.3, 0.9, 1.0])
    _, te = edges_both(i, j, d0, 150)
    whole, _ = tss.sweep_scores_sparse_device(te, ts)
    monkeypatch.setattr(tss, "_TRI_BLOCK", 64)
    blocked, _ = tss.sweep_scores_sparse_device(te, ts)
    np.testing.assert_array_equal(blocked, whole)
    np.testing.assert_allclose(blocked, host_scores(150, i, j, d0, ts),
                               **SCORE_TOL)


def test_clique_population():
    """Dense cliques (the strain regime), with sparse between-block edges at
    large d0: heavy triangle counts per step, and vertices at every bit of
    a word, bit 31 (the int32 sign) included."""
    rng = np.random.default_rng(3)
    blocks = [(0, 30), (30, 75), (75, 120)]
    i_l, j_l, d_l = [], [], []
    for lo, hi in blocks:
        for a in range(lo, hi):
            for b in range(a + 1, hi):
                i_l.append(a)
                j_l.append(b)
                d_l.append(rng.uniform(0, 0.4))
    seen = set()
    while len(seen) < 200:
        a, b = int(rng.integers(0, 75)), int(rng.integers(75, 120))
        if (a, b) not in seen:
            seen.add((a, b))
            i_l.append(a)
            j_l.append(b)
            d_l.append(rng.uniform(0.4, 1.0))
    i, j = np.array(i_l, np.int32), np.array(j_l, np.int32)
    check(i, j, np.array(d_l, np.float32), 120, np.linspace(0.02, 1.0, 23))


def test_batched_triangle_births():
    """One step activating 1, 2 or 3 edges of the same triangle counts it
    once (the S_all / S_on / S_nn inclusion-exclusion)."""
    i = np.array([0, 0, 1, 3, 3, 4, 6, 6, 7], np.int32)
    j = np.array([1, 2, 2, 4, 5, 5, 7, 8, 8], np.int32)
    d0 = np.array([0.1, 0.2, 0.3, 0.1, 0.3, 0.3, 0.3, 0.3, 0.3], np.float32)
    _, counts = check(i, j, d0, 9, np.array([0.05, 0.15, 0.25, 0.35]))
    assert counts.tolist() == [0, 2, 3, 9]


def test_single_threshold_and_empty():
    i, j = np.array([0, 1], np.int32), np.array([1, 2], np.int32)
    d0 = np.array([0.5, 0.6], np.float32)
    _, te = edges_both(i, j, d0, 4)
    got, counts = tss.sweep_scores_sparse_device(te, np.array([0.1]))
    assert counts[0] == 0 and got[0] == 0.0  # the empty graph scores -0
    check(i, j, d0, 4, np.array([0.55]))
    with pytest.raises(ValueError, match="ascending"):
        tss.sweep_scores_sparse_device(te, np.array([0.6, 0.5]))


def test_n_real_excludes_pads_from_the_density():
    """Pad vertices (>= n_real) take no edges and do not count as
    possible pairs."""
    i, j, d0 = random_graph(61, 400, 5)
    je, te = edges_both(i, j, d0, 64)
    je.n_real = te.n_real = 61
    ts = np.linspace(0.1, 1.0, 9)
    got, _ = tss.sweep_scores_sparse_device(te, ts)
    np.testing.assert_allclose(got, host_scores(61, i, j, d0, ts),
                               **SCORE_TOL)
    np.testing.assert_allclose(got, jss.sweep_scores_sparse_device(je, ts)[0],
                               **SCORE_TOL)


def test_sweep_edges_sort_stably_and_answer_prefixes():
    d0 = np.array([0.3, 0.1, 0.3, 0.2, 0.1], np.float32)
    i = np.arange(5, dtype=np.int32)
    j = i + 10
    je, te = edges_both(i, j, d0, 20, alloc=8)
    # ties keep their order (the reference's stable lax.sort)
    assert te.i[:5].tolist() == [1, 4, 3, 0, 2]
    np.testing.assert_array_equal(te.fetch_prefix(5)[0],
                                  np.asarray(je.fetch_prefix(5)[0]))
    ts = np.array([0.0, 0.1, 0.25, 0.3, 9.0])
    np.testing.assert_array_equal(te.counts_at(ts), je.counts_at(ts))
    assert te.counts_at(ts).tolist() == [0, 2, 3, 5, 5]
    # the pad slots past the count are dropped, not sorted
    assert len(te) == 5 and te.i.shape[0] == te.d0.shape[0] == 5


def test_bits_set_the_sign_bit_for_vertex_31():
    v = torch.tensor([0, 5, 31, 32, 63])
    got = tss._bits(v)
    assert got.dtype == torch.int32
    assert got.tolist() == [1, 32, -2**31, 1, -2**31]


def test_memory_planning_equals_the_jax_package_on_the_cpu():
    for name in ("_TRI_BLOCK", "HBM_TOTAL", "FILL_TRANSIENT"):
        assert getattr(tss, name) == getattr(jss, name), name
    assert tss.device_hbm_total() == tss.device_hbm_total("cpu") == \
        jss.HBM_TOTAL
    for n, resident in ((65536, 1_761_607_680), (131072, 3 * 10**9)):
        assert tss.max_edge_cap(n, resident) == jss.max_edge_cap(n, resident)
        for e in (10**6, 10**8, 10**9):
            assert tss.hbm_feasible(n, e, resident) == \
                jss.hbm_feasible(n, e, resident)
            assert tss.hbm_feasible(n, e, resident) == (
                resident + tss.sweep_peak_bytes(n, e) <= tss.HBM_TOTAL)
    # the edge buffers hold the band plus the reference's margin, without
    # its power-of-two pad
    for e in (1, 1024, 1025, 10**6, 2**20):
        assert e + 1024 <= tss.band_slots(e) <= \
            jss._bucket(e + max(1024, e // 128))
    # the d0 sort's int64 order is budgeted too: at n 8192 with nothing
    # resident the reference's 2**29-edge cap no longer fits
    assert tss.max_edge_cap(8192, 0) == jss.max_edge_cap(8192, 0) // 2
    # a card's budget widens the cap
    assert tss.max_edge_cap(65536, 0, 72e9) > tss.max_edge_cap(65536, 0)
