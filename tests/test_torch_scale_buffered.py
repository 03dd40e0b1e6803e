"""The port's buffered scale tier and pipeline against the JAX package's,
on the CPU.

One population, drawn by the JAX package's synthetic_population_device
(n 256, sketchsize64 64, bbits 8, 10 strains; the parameters of
tests/test_scale.py's pipeline tests) and handed to both packages as numpy
planes.

Tolerances: the folded buffer, its kNN distances, column maxima and
subsample are float32 distances, held within the port's core/accessory
tolerance (FLOAT_TOL, tests/test_torch_scale.py: the two packages compute
the same float32 arithmetic in different orders). Every consumer of the
buffer (counts, the sparse fetch and fill, the d0 square, the matmul
sweep's edge counts, component labels) is then held to the JAX package's
on the SAME buffer, the JAX package's own, exactly; the pairs' signed
boundary distances d0 within a few float32 ulps (D0_TOL), the matmul
scores within rtol 1e-5 (the reference sums in float32, the port in
float64 from exact counts). Refined boundaries within BOUNDARY_TOL, the
JAX package's own refine tests' tolerance. The pipelines, both routes, run on identical
planes (the port's synth entry returns the JAX-drawn population) and must
give the JAX package's edge count, clusters, labels and lineages.
"""

import numpy as np
import pytest
import torch

import poppunk_tpu.network.incremental as j_incremental
import poppunk_tpu.scale as jsc
import poppunk_tpu_torch.network.incremental as t_incremental
import poppunk_tpu_torch.scale as tsc
import poppunk_tpu_torch.synth as tsynth
from poppunk_tpu.synth import synthetic_population_device as jax_synth
from poppunk_tpu_torch.ops.distances import planes_to_tensor
from test_torch_scale import BOUNDARY_TOL, FLOAT_TOL, assert_same_knn

torch.set_num_threads(2)

N = 256
KLIST = (13, 15, 17, 19, 21, 23)
SS64 = 64
BBITS = 8
CHUNK = 32
PIPELINE = dict(
    n=N, klist=KLIST, sketchsize64=SS64, bbits=BBITS, n_strains=10,
    chunk=CHUNK, knn=3, subsample=5000, seed=5,
    synth_kwargs=dict(core_div=(0.0005, 0.002), strain_div=(0.04, 0.06),
                      accessory_within=(0.93, 0.97),
                      accessory_strain=(0.70, 0.80)))
LINE = (0.1, 0.1, 0.7, 0.7)
# d0 from the same buffer: the JAX package's float32 division and products
# may round an ulp apart from torch's (XLA's CPU code), so a few ulps
D0_TOL = dict(rtol=1e-6, atol=1e-7)
OFFSETS = np.linspace(0.0, 0.5, 20)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        m.delenv("POPPUNK_TPU_SPARSE_SWEEP", raising=False)
        m.delenv("POPPUNK_TPU_BOOTSTRAP", raising=False)
        yield


@pytest.fixture(scope="module")
def jpop():
    """The JAX package's draw, as run_scale_pipeline(**PIPELINE) draws
    it."""
    kw = PIPELINE
    return jax_synth(kw["n"], kw["klist"], kw["sketchsize64"], kw["bbits"],
                     n_strains=kw["n_strains"], seed=kw["seed"],
                     chunk=max(kw["chunk"], min(kw["n"], 2048)),
                     **kw["synth_kwargs"])


@pytest.fixture(scope="module")
def operands(jpop):
    return (np.asarray(jpop.planes), np.asarray(jpop.lengths),
            np.asarray(jpop.freqs))


@pytest.fixture(scope="module")
def jcd(operands):
    return jsc.fill_condensed_device(*operands, KLIST, SS64, BBITS,
                                     chunk=CHUNK, knn=5, use_pallas=False)


@pytest.fixture(scope="module")
def tcd(operands):
    return tsc.fill_condensed_device(*operands, KLIST, SS64, BBITS,
                                     chunk=CHUNK, knn=5)


@pytest.fixture(scope="module")
def same(jcd):
    """The JAX package's buffer and kNN in the port's CondensedDevice."""
    return tsc.CondensedDevice(torch.tensor(np.asarray(jcd.buf)), jcd.n,
                               jcd.knn_row, jcd.knn_col, jcd.knn_dist)


def sweep_args(jcd, slope=2):
    return (np.asarray(jcd.max_scale(), np.float64), OFFSETS, slope, *LINE)


def start_fit(jcd):
    """(scale, mean0, mean1, subsample) from the within / between split of
    20,000 subsampled pairs (the estimator's minimum is 10,000)."""
    scale = np.asarray(jcd.max_scale(), np.float64)
    sub = jcd.subsample_pairs(20000, seed=1)
    Xs = sub / scale
    close = Xs[:, 0] < 0.5 * Xs[:, 0].max()
    return scale, Xs[close].mean(axis=0), Xs[~close].mean(axis=0), sub


# --------------------------------------------------------------------------
# the fill


def test_fill_equals_the_jax_package(jcd, tcd, same):
    assert tcd.n == jcd.n == N and tcd.n_pairs == jcd.n_pairs
    assert tcd.buf.shape == (N // 2, N - 1, 2)
    np.testing.assert_allclose(tcd.buf.numpy(), np.asarray(jcd.buf),
                               **FLOAT_TOL)
    assert_same_knn(tcd, jcd)
    np.testing.assert_array_equal(tcd.knn_sparse()[0], jcd.knn_sparse()[0])
    np.testing.assert_allclose(tcd.max_scale(), jcd.max_scale(), **FLOAT_TOL)
    np.testing.assert_allclose(tcd.subsample_pairs(200, seed=3),
                               jcd.subsample_pairs(200, seed=3), **FLOAT_TOL)
    # the same draw over folded positions, gathered from the same buffer
    np.testing.assert_array_equal(same.max_scale(), jcd.max_scale())
    np.testing.assert_array_equal(same.subsample_pairs(200, seed=3),
                                  jcd.subsample_pairs(200, seed=3))
    assert same.subsample_pairs(10 ** 9).shape == (jcd.n_pairs, 2)


def test_the_fill_is_the_streaming_pass(operands, tcd):
    """Every folded block of the buffer is the streaming pass-1 block of
    the same chunk: one _fold_block, bit for bit."""
    sc = tsc.StreamingCondensed(*operands, KLIST, SS64, BBITS, chunk=CHUNK,
                                knn=5)
    np.testing.assert_array_equal(sc.knn_col, tcd.knn_col)
    np.testing.assert_array_equal(sc.knn_dist, tcd.knn_dist)
    np.testing.assert_array_equal(sc.max_scale(), tcd.max_scale())
    flat = torch.cat([f for _, _, f in tsc._stream_pairs(sc)])
    assert torch.equal(flat, tcd.buf.reshape(-1, 2))


def test_the_fill_refuses_a_ragged_chunk_and_odd_n(operands):
    planes, lengths, freqs = operands
    with pytest.raises(ValueError, match="multiple of chunk"):
        tsc.fill_condensed_device(planes, lengths, freqs, KLIST, SS64,
                                  BBITS, chunk=48)
    with pytest.raises(ValueError, match="even n"):
        tsc.fill_condensed_device(planes[:, :, :N - 1], lengths[:N - 1],
                                  freqs[:N - 1], KLIST, SS64, BBITS)


# --------------------------------------------------------------------------
# the sweeps over the buffer


@pytest.mark.parametrize("slope,chunk_rows", [(2, 8), (2, 7), (2, 1024),
                                              (0, 8), (1, 8)])
def test_counts_equal_the_jax_package(jcd, same, slope, chunk_rows,
                                      monkeypatch):
    """chunk_rows 8 divides the 128 folded rows, 7 leaves a ragged tail,
    1024 is one chunk; the port slices its buffer by _BUF_ROWS rows."""
    args = sweep_args(jcd, slope)
    want = jsc.sweep_counts_buffered(jcd, *args, chunk_rows=chunk_rows)
    monkeypatch.setattr(tsc, "_BUF_ROWS", chunk_rows)
    np.testing.assert_array_equal(tsc.sweep_counts_streaming(same, *args),
                                  want)
    assert want[-1] > want[0]


@pytest.mark.parametrize("n_act", [None, 7])
def test_fetch_and_fill_equal_the_jax_package(jcd, same, n_act,
                                              monkeypatch):
    args = sweep_args(jcd)
    monkeypatch.setattr(tsc, "_BUF_ROWS", 24)
    ti, tj, tidx, td0 = tsc.sweep_first_offsets(same, *args, _n_act=n_act)
    ji, jj, jidx, jd0 = jsc.sweep_first_offsets(jcd, *args, chunk_rows=24,
                                                _n_act=n_act)
    assert len(ti) > 0
    for got, want in ((ti, ji), (tj, jj), (tidx, jidx)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(td0, jd0, **D0_TOL)
    k = len(ti)
    t_edges, t_cum = tsc.sweep_fill_device(same, *args, n_act=n_act or 20,
                                           e_total=k)
    j_edges, j_cum = jsc.sweep_fill_device(jcd, *args, n_act=n_act or 20,
                                           e_total=k)
    np.testing.assert_array_equal(t_cum, j_cum)
    assert t_edges.count == j_edges.count == k
    got = set(zip(*[a.tolist() for a in t_edges.fetch_prefix(k)]))
    assert got == set(zip(*[a.tolist() for a in j_edges.fetch_prefix(k)]))
    assert got == set(zip(ti.tolist(), tj.tolist()))


# --------------------------------------------------------------------------
# the dense square, the matmul sweep and the components


@pytest.fixture(scope="module")
def squares(jcd, same):
    args = sweep_args(jcd)
    j_sq, j_t = jsc.build_d0_square(jcd, args[0], 2, *LINE, OFFSETS,
                                    block_rows=100)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsc, "_SQUARE_ROWS", 100)
        t_sq, t_t = tsc.build_d0_square(same, args[0], 2, *LINE, OFFSETS)
    return np.asarray(j_sq), j_t, t_sq, t_t


def test_d0_square_equals_the_jax_package(squares):
    j_sq, j_t, t_sq, t_t = squares
    np.testing.assert_allclose(t_sq.numpy(), j_sq, **D0_TOL)
    np.testing.assert_array_equal(t_t, np.asarray(j_t, np.float32))
    assert np.isinf(np.diag(j_sq)).all()
    np.testing.assert_array_equal(j_sq, j_sq.T)


def test_matmul_scores_equal_the_jax_package_and_the_host_scorer(jcd, same,
                                                                 squares):
    j_sq, j_t, t_sq, t_t = squares
    scores, edges = tsc.matmul_sweep_scores(t_sq, t_t)
    j_scores, j_edges = jsc.matmul_sweep_scores(j_sq, j_t)
    np.testing.assert_array_equal(edges, j_edges)
    np.testing.assert_allclose(scores, j_scores, rtol=1e-5, atol=1e-7)
    # the host scorer on the fetched pairs: both ratios of exact counts
    i, j, idx, _ = tsc.sweep_first_offsets(same, *sweep_args(jcd))
    host = t_incremental.grow_network_scores(N, i, j, idx, len(OFFSETS), 0,
                                             100,
                                             rng=np.random.default_rng(1))
    np.testing.assert_allclose(scores, host, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        edges, np.cumsum(np.bincount(idx, minlength=len(OFFSETS))))


@pytest.mark.parametrize("n", [300, 64])
def test_the_int8_product_is_exact(n):
    """Dense random graphs whose common-neighbour counts pass 256 (a bf16
    product's exact range) at n 300, off the int8 product's multiple of 8;
    the scores and edges against a float64 count."""
    rng = np.random.default_rng(n)
    d0 = rng.random((n, n), dtype=np.float32)
    d0 = np.minimum(d0, d0.T)
    np.fill_diagonal(d0, np.inf)
    ts = np.array([0.2, 0.6, 0.97], np.float32)
    scores, edges = tsc.matmul_sweep_scores(torch.from_numpy(d0), ts)
    want_s, want_e = float64_sweep(d0, ts)
    np.testing.assert_array_equal(edges, want_e)
    np.testing.assert_allclose(scores, want_s, rtol=1e-12)


def test_the_int8_product_sums_in_row_blocks(monkeypatch):
    """The degrees and paths summed 64 rows at a time, the last block
    ragged (n 300 pads to 304), equal the float64 count."""
    monkeypatch.setattr(tsc, "_SQUARE_ROWS", 64)
    rng = np.random.default_rng(11)
    d0 = rng.random((300, 300), dtype=np.float32)
    d0 = np.minimum(d0, d0.T)
    np.fill_diagonal(d0, np.inf)
    ts = np.array([0.1, 0.5, 0.95], np.float32)
    scores, edges = tsc.matmul_sweep_scores(torch.from_numpy(d0), ts)
    want_s, want_e = float64_sweep(d0, ts)
    np.testing.assert_array_equal(edges, want_e)
    np.testing.assert_allclose(scores, want_s, rtol=1e-12)


def float64_sweep(d0, ts):
    """(scores, edges) per threshold from float64 products on the host."""
    n = d0.shape[0]
    scores, edges = [], []
    for t in ts:
        A = (d0 <= t).astype(np.float64)
        deg = A.sum(axis=1)
        paths = (A * (A @ A)).sum()
        wedges2 = (deg * (deg - 1)).sum()
        trans = paths / wedges2 if wedges2 > 0 else 0.0
        scores.append(-(trans * (1 - deg.sum() / 2 / (0.5 * n * (n - 1)))))
        edges.append(int(deg.sum()) // 2)
    return np.array(scores), np.array(edges)


@pytest.mark.cuda
def test_the_int8_product_is_exact_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 4100
    rng = np.random.default_rng(7)
    d0 = rng.random((n, n), dtype=np.float32)
    d0 = np.minimum(d0, d0.T)
    np.fill_diagonal(d0, np.inf)
    ts = np.array([0.05, 0.5, 0.9], np.float32)
    scores, edges = tsc.matmul_sweep_scores(
        torch.from_numpy(d0).to("cuda"), ts)
    want_s, want_e = float64_sweep(d0, ts)
    np.testing.assert_array_equal(edges, want_e)
    np.testing.assert_allclose(scores, want_s, rtol=1e-12)


def partition_pairs(a, b):
    return {(x, y) for x, y in zip(a, b)}


@pytest.mark.parametrize("o", [3, 9, 15])
def test_components_equal_the_jax_package(jcd, same, squares, o,
                                          monkeypatch):
    j_sq, j_t, t_sq, t_t = squares
    monkeypatch.setattr(tsc, "_SQUARE_ROWS", 100)
    labels, n_edges = tsc.components_device(t_sq, t_t[o])
    j_labels, j_edges = jsc.components_device(j_sq, j_t[o])
    np.testing.assert_array_equal(labels, j_labels)
    assert n_edges == j_edges
    # the edge-list route over the same boundary
    args = sweep_args(jcd)
    k = int(tsc.sweep_counts_streaming(same, *args)[-1])
    t_edges, _ = tsc.sweep_fill_device(same, *args, n_act=20, e_total=k)
    j_edges_l, _ = jsc.sweep_fill_device(jcd, *args, n_act=20, e_total=k)
    e_labels, e_k = tsc.edge_components_device(t_edges, t_t[o])
    je_labels, je_k = jsc.edge_components_device(j_edges_l, j_t[o])
    np.testing.assert_array_equal(e_labels, je_labels)
    np.testing.assert_array_equal(e_labels, labels)
    assert e_k == je_k == n_edges


def test_edge_components_raise_past_the_round_cap(jcd, same, monkeypatch):
    args = sweep_args(jcd)
    k = int(tsc.sweep_counts_streaming(same, *args)[-1])
    edges, _ = tsc.sweep_fill_device(same, *args, n_act=20, e_total=k)
    monkeypatch.setattr(tsc, "_label_prop_rounds", lambda n: 1)
    with pytest.raises(RuntimeError, match="failed to converge"):
        tsc.edge_components_device(edges, OFFSETS[-1])


# --------------------------------------------------------------------------
# the refine on a buffered cd


@pytest.mark.parametrize("score_idx,route", [(0, "device"), (1, "sparse")])
def test_refine_equals_the_jax_package(jcd, same, score_idx, route):
    scale, mean0, mean1, sub = start_fit(jcd)
    kw = dict(max_move=0.05, score_idx=score_idx, seed=4,
              betweenness_sample=1000, est_pairs=sub)
    want = jsc.refine_fit_device(jcd, scale, mean0, mean1, **kw)
    timings = {}
    got = tsc.refine_fit_device(same, scale, mean0, mean1,
                                timings_out=timings, **kw)
    assert got[3][0] == want[3][0] == route
    np.testing.assert_allclose(got[:3], want[:3], **BOUNDARY_TOL)
    if route == "device":
        np.testing.assert_allclose(got[3][1].numpy(),
                                   np.asarray(want[3][1]), **D0_TOL)
        assert "grid" in timings
    assert tsc.plan_sweep_band(same, scale, mean0, mean1,
                               est_pairs=sub) is None


def test_refine_past_the_matmul_cap_takes_the_sparse_sweep(jcd, same,
                                                           monkeypatch):
    """Past MATMUL_SWEEP_MAX_N a buffered cd fills the device edge list
    from its buffer, in both packages."""
    scale, mean0, mean1, sub = start_fit(jcd)
    monkeypatch.setattr(jsc, "MATMUL_SWEEP_MAX_N", 0)
    monkeypatch.setattr(tsc, "MATMUL_SWEEP_MAX_N", 0)
    kw = dict(max_move=0.05, score_idx=0, seed=4)
    want = jsc.refine_fit_device(jcd, scale, mean0, mean1, **kw)
    got = tsc.refine_fit_device(same, scale, mean0, mean1, **kw)
    assert got[3][0] == want[3][0] == "edges"
    np.testing.assert_allclose(got[:3], want[:3], **BOUNDARY_TOL)


def test_saturated_grid_raises(jcd, same):
    scale, mean0, mean1, _ = start_fit(jcd)
    with pytest.raises(tsc.SweepSaturated, match="all points"):
        tsc.refine_fit_device(same, scale, mean0, mean1, max_move=5.0)


# --------------------------------------------------------------------------
# the pipeline


class Labels:
    """Records what the network and lineage steps of run_scale_pipeline
    hand back, by wrapping their module attributes."""

    def __init__(self, monkeypatch, module, incremental):
        self.calls = []
        for name in ("components_device", "edge_components_device"):
            monkeypatch.setattr(module, name, self.wrap(getattr(module,
                                                                name)))
        monkeypatch.setattr(incremental, "components_native",
                            self.wrap(incremental.components_native))

    def wrap(self, fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls.append(np.asarray(out[0]))
            return out
        return recorded


def the_jax_draw_on_the_cpu(jpop):
    def draw(*args, **kwargs):
        return tsynth.SyntheticSketches(
            planes_to_tensor(np.asarray(jpop.planes), torch.device("cpu")),
            torch.tensor(np.asarray(jpop.lengths)),
            torch.tensor(np.asarray(jpop.freqs)), jpop.strain, jpop.d,
            jpop.pi, jpop.klist, jpop.sketchsize64, jpop.bbits)
    return draw


@pytest.mark.parametrize("streaming,route", [(False, "device"),
                                             (True, "edges")])
def test_pipeline_equals_the_jax_package(jpop, monkeypatch, streaming,
                                         route):
    j_log, t_log = [], []
    j_rec = Labels(monkeypatch, jsc, j_incremental)
    want = jsc.run_scale_pipeline(streaming=streaming, sharded=False,
                                  log=j_log.append, **PIPELINE)
    monkeypatch.setattr(tsynth, "synthetic_population_device",
                        the_jax_draw_on_the_cpu(jpop))
    t_rec = Labels(monkeypatch, tsc, t_incremental)
    got = tsc.run_scale_pipeline(streaming=streaming, log=t_log.append,
                                 **PIPELINE)
    assert any(f"via {route} sweep" in m for m in t_log)
    assert any(f"via {route} sweep" in m for m in j_log)
    for key in ("n_edges", "n_clusters", "n_lineages", "streaming"):
        assert got[key] == want[key], key
    assert got["ari"] == want["ari"] == 1.0
    assert got["ari_lineage"] == pytest.approx(want["ari_lineage"],
                                               abs=1e-12)
    assert len(t_rec.calls) == len(j_rec.calls) == 2  # network, lineage
    for t_labels, j_labels in zip(t_rec.calls, j_rec.calls):
        np.testing.assert_array_equal(t_labels, j_labels)
    assert got["route"] == route
    np.testing.assert_array_equal(got["labels"], t_rec.calls[0])
    assert set(got) >= set(want) - {"refine_phase_s"}
    assert got["timings"].keys() == want["timings"].keys()


@pytest.mark.parametrize("case", ["random", "same", "one_cluster",
                                  "singletons", "relabelled", "strings"])
def test_adjusted_rand_index_equals_sklearn(case):
    from sklearn.metrics import adjusted_rand_score

    rng = np.random.default_rng(3)
    a = rng.integers(0, 7, 500)
    b = {"random": rng.integers(0, 5, 500), "same": a.copy(),
         "one_cluster": np.zeros(500, int), "singletons": np.arange(500),
         "relabelled": (a * 3 + 11) % 50,
         "strings": np.array([f"c{v}" for v in rng.integers(0, 9, 500)])}[
        case]
    assert tsc.adjusted_rand_index(a, b) == adjusted_rand_score(a, b)
    assert tsc.adjusted_rand_index(b, a) == adjusted_rand_score(b, a)
