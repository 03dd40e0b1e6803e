"""The port's row-sharded scale tier against the JAX package's mesh and
the port's single-device route, on the CPU.

The JAX package runs its mesh on the 8 virtual CPU devices of
tests/conftest.py (use_pallas=False); the port runs a mesh of the CPU
repeated 8 times, get_mesh(devices=[cpu] * 8). The planes are
tests/test_torch_scale.py's planted populations: 64 genomes (chunk 4:
four folded rows per shard) and 61 genomes padded to 80 (chunk 5, the
JAX package's test_sharded_gap19). The cases mirror the row-sharded ones
of tests/test_scale.py (TestSweep2D, TestRaggedDispatchPlan,
TestMeshCompactPasses, TestArbitraryPadStreaming, TestShardedStreaming)
and tests/test_sparse_sweep.py::TestMeshShardedSweep (tier "row"), then
the buffered tier (fill_condensed_sharded and its readers), the pipeline
on both routes, and the scale CLI with its mesh forced to 8 CPU shards.

Tolerances: against the port's single-device route everything is exact,
floats included (every shard runs the same steps as one device). Against
the JAX package's mesh: counts, kNN indices, fetched (i, j, offset) in
their order, QC flags, edge sets, labels and the CLI's CSVs exactly;
distances within FLOAT_TOL and boundaries within BOUNDARY_TOL
(tests/test_torch_scale.py says why).
"""

import numpy as np
import pytest
import torch

import poppunk_tpu.scale as jsc
import poppunk_tpu_torch.parallel.mesh as tmesh
import poppunk_tpu_torch.scale as tsc
from poppunk_tpu.parallel.mesh import get_mesh as jax_get_mesh
from poppunk_tpu_torch.ops import sparse_sweep
from test_torch_scale import (BBITS, BOUNDARY_TOL, FLOAT_TOL, KLIST, SS64,
                              assert_same_knn, planted, start_fit,
                              sweep_args)

torch.set_num_threads(2)

CPU = torch.device("cpu")
N = 64
CHUNK = 4


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        m.delenv("POPPUNK_TPU_SPARSE_SWEEP", raising=False)
        m.delenv("POPPUNK_TPU_BOOTSTRAP", raising=False)
        yield


def virtual(n=8):
    return tmesh.get_mesh(devices=[CPU] * n)


@pytest.fixture(scope="module")
def pop():
    planes, lengths, freqs, strains = planted(N, ties=((1, 9), (2, 30)))
    return dict(planes=planes, lengths=lengths, freqs=freqs,
                strains=strains, n=N)


def operands(pop):
    return pop["planes"], pop["lengths"], pop["freqs"], KLIST, SS64, BBITS


@pytest.fixture(scope="module")
def streams(pop):
    """(JAX mesh, port mesh, port single device) StreamingCondensed, knn 5
    and a predeclared subsample of 200 pairs (seed 3)."""
    kw = dict(chunk=CHUNK, knn=5, subsample=(200, 3))
    return (jsc.StreamingCondensed(*operands(pop), use_pallas=False,
                                   mesh=jax_get_mesh(8), **kw),
            tsc.StreamingCondensed(*operands(pop), mesh=virtual(), **kw),
            tsc.StreamingCondensed(*operands(pop), **kw))


def assert_same_fetch(got, one, want):
    """(i, j, offset, d0) equal the single device's exactly and the JAX
    package's mesh in order, d0 within FLOAT_TOL."""
    assert len(got[0]) > 0
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[3], want[3], **FLOAT_TOL)


# --------------------------------------------------------------------------
# pass 1 and the sweeps (TestShardedStreaming, TestRaggedDispatchPlan)


def test_knn_and_scale_match(streams):
    js, ts, one = streams
    assert ts._n_dev == 8 and ts._half_loc == 4 and ts.chunk == CHUNK
    np.testing.assert_array_equal(ts.knn_col, one.knn_col)
    np.testing.assert_array_equal(ts.knn_dist, one.knn_dist)
    np.testing.assert_array_equal(ts.max_scale(), one.max_scale())
    assert_same_knn(ts, js)
    np.testing.assert_allclose(ts.max_scale(), js.max_scale(), **FLOAT_TOL)


def test_predeclared_subsample_matches(streams):
    js, ts, one = streams
    got = ts.subsample_pairs(200, seed=3)
    np.testing.assert_array_equal(got, one.subsample_pairs(200, seed=3))
    np.testing.assert_allclose(got, js.subsample_pairs(200, seed=3),
                               **FLOAT_TOL)
    np.testing.assert_array_equal(ts.subsample_pairs(150, seed=5),
                                  one.subsample_pairs(150, seed=5))


@pytest.mark.parametrize("slope", [2, 0, 1])
def test_sweep_matches_single_device(streams, slope):
    js, ts, one = streams
    args = list(sweep_args(js))
    args[2] = slope
    want = tsc.sweep_counts_streaming(one, *args)
    np.testing.assert_array_equal(tsc.sweep_counts_streaming(ts, *args),
                                  want)
    np.testing.assert_array_equal(jsc.sweep_counts_streaming(js, *args),
                                  want)
    for n_act in (None, 7):
        assert_same_fetch(
            tsc.sweep_first_offsets(ts, *args, _n_act=n_act),
            tsc.sweep_first_offsets(one, *args, _n_act=n_act),
            jsc.sweep_first_offsets(js, *args, _n_act=n_act))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_fewer_shards_equal_single_device(pop, streams, n_dev):
    """Shards of several steps each (half_loc 16 and 8 at chunk 4), the
    port's counterpart of the JAX package's ragged dispatch groups."""
    _, _, one = streams
    cd = tsc.StreamingCondensed(*operands(pop), chunk=CHUNK, knn=5,
                                subsample=(200, 3), mesh=virtual(n_dev))
    np.testing.assert_array_equal(cd.knn_col, one.knn_col)
    np.testing.assert_array_equal(cd.subsample_pairs(200, seed=3),
                                  one.subsample_pairs(200, seed=3))
    args = sweep_args(one)
    for a, b in zip(tsc.sweep_first_offsets(cd, *args),
                    tsc.sweep_first_offsets(one, *args)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsc.sweep_counts_streaming(cd, *args),
                                  tsc.sweep_counts_streaming(one, *args))


X_GRID = np.linspace(0.05, 0.9, 6).astype(np.float32)
Y_GRID = np.linspace(0.05, 0.9, 5).astype(np.float32)


def test_2d_passes_match_single_device(streams):
    """Row-sharded 2-D passes equal the single-device twin exactly
    (counts and the in-union fetch, in order), and the JAX package's
    mesh."""
    js, ts, one = streams
    scale = np.asarray(js.max_scale(), np.float64)
    want = tsc.sweep2d_counts_streaming(one, scale, X_GRID, Y_GRID)
    np.testing.assert_array_equal(
        tsc.sweep2d_counts_streaming(ts, scale, X_GRID, Y_GRID), want)
    np.testing.assert_array_equal(
        jsc.sweep2d_counts_streaming(js, scale, X_GRID, Y_GRID), want)
    x_caps = np.full(len(Y_GRID), X_GRID[-1], np.float32)
    got = tsc.sweep2d_fetch_streaming(ts, scale, x_caps, Y_GRID)
    assert len(got[0]) > 0
    for a, b in zip(got, tsc.sweep2d_fetch_streaming(one, scale, x_caps,
                                                     Y_GRID)):
        np.testing.assert_array_equal(a, b)
    mi, mj, mx, my = jsc.sweep2d_fetch_streaming(js, scale, x_caps, Y_GRID)
    np.testing.assert_array_equal(got[0], mi)
    np.testing.assert_array_equal(got[1], mj)
    np.testing.assert_allclose(got[2], mx, **FLOAT_TOL)
    np.testing.assert_allclose(got[3], my, **FLOAT_TOL)


# --------------------------------------------------------------------------
# the compaction passes (TestMeshCompactPasses)


def test_qc_pairs_sharded(pop):
    args = (*operands(pop), CHUNK, N, 0.05, 0.3)
    one = tsc.qc_bad_pairs_streaming(*args)
    got = tsc.qc_bad_pairs_streaming(*args, mesh=virtual())
    want = jsc.qc_bad_pairs_streaming(*args, use_pallas=False,
                                      mesh=jax_get_mesh(8))
    assert len(one[0]) > 0
    for a, b, c in zip(got, one, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("slope,bx,by", [(2, 0.4, 0.5), (0, 0.3, 0.0)])
def test_boundary_fetch_sharded(pop, streams, slope, bx, by):
    scale = np.asarray(streams[0].max_scale(), np.float64)
    args = (*operands(pop), CHUNK, N, scale, bx, by, slope)
    one = tsc.fetch_within_boundary(*args)
    got = tsc.fetch_within_boundary(*args, mesh=virtual())
    want = jsc.fetch_within_boundary(*args, use_pallas=False,
                                     mesh=jax_get_mesh(8))
    assert len(one[0]) > 0
    for a, b, c in zip(got, one, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# --------------------------------------------------------------------------
# padding (TestArbitraryPadStreaming::test_sharded_gap19)


def test_sharded_gap19():
    """61 genomes padded to 80 over 8 shards of 5 rows (chunk 5): the
    pads stay exactly masked on every shard."""
    planes, lengths, freqs, _ = planted(61, n_pad=80)
    kw = dict(chunk=5, knn=5, subsample=(150, 3), n_real=61)
    ops = (planes, lengths, freqs, KLIST, SS64, BBITS)
    ts = tsc.StreamingCondensed(*ops, mesh=virtual(), **kw)
    one = tsc.StreamingCondensed(*ops, **kw)
    js = jsc.StreamingCondensed(*ops, use_pallas=False,
                                mesh=jax_get_mesh(8), **kw)
    assert ts.n == 61 and ts.n_pairs == 61 * 60 // 2
    np.testing.assert_array_equal(ts.knn_col, one.knn_col)
    np.testing.assert_array_equal(ts.knn_dist, one.knn_dist)
    assert (ts.knn_col < 61).all()
    assert_same_knn(ts, js)
    np.testing.assert_array_equal(ts.max_scale(), one.max_scale())
    np.testing.assert_array_equal(ts.subsample_pairs(150, seed=3),
                                  one.subsample_pairs(150, seed=3))
    args = sweep_args(js)
    got = tsc.sweep_first_offsets(ts, *args)
    assert_same_fetch(got, tsc.sweep_first_offsets(one, *args),
                      jsc.sweep_first_offsets(js, *args))
    assert (got[0] < 61).all() and (got[1] < 61).all()
    qc = tsc.qc_bad_pairs_streaming(*ops, 5, 61, 0.05, 0.3,
                                    mesh=virtual())
    for a, b in zip(qc, tsc.qc_bad_pairs_streaming(*ops, 5, 61, 0.05, 0.3)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the device sweep (TestMeshShardedSweep, tier "row")


def test_mesh_fill_matches_fetch(streams):
    js, ts, one = streams
    args = sweep_args(js)
    n_grid = len(args[1])
    hi, hj, hidx, _ = tsc.sweep_first_offsets(one, *args)
    cum_global, per_dev = tsc.sweep_counts_mesh(ts, *args)
    assert per_dev.shape == (8, n_grid)
    assert per_dev.sum(axis=0)[-1] == cum_global[-1] == len(hi)
    j_cum, j_per_dev = jsc.sweep_counts_mesh(js, *args)
    np.testing.assert_array_equal(per_dev, j_per_dev)
    edges, cum_fill = tsc.sweep_fill_device(
        ts, *args, n_act=n_grid, e_total=int(cum_global[-1]),
        e_per_dev=per_dev[:, -1])
    np.testing.assert_array_equal(cum_fill, cum_global)
    one_edges, _ = tsc.sweep_fill_device(one, *args, n_act=n_grid,
                                         e_total=len(hi))
    # the shards' edges concatenated in row order: the single device's
    # list, sorted the same way
    for name in ("i", "j", "d0"):
        assert torch.equal(getattr(edges, name), getattr(one_edges, name))
    assert edges.count == len(hi) and edges.n_real == N
    fi, fj = edges.fetch_prefix(edges.count)
    assert (sorted(zip(fi.tolist(), fj.tolist()))
            == sorted(zip(hi.tolist(), hj.tolist())))
    _, _, t = jsc._line_d0_params(args[1], *args[2:])
    for o in (4, 11):
        k = int(edges.counts_at(np.array([t[o]]))[0])
        pi, pj = edges.fetch_prefix(k)
        mask = hidx <= o
        assert (sorted(zip(pi.tolist(), pj.tolist()))
                == sorted(zip(hi[mask].tolist(), hj[mask].tolist())))


def test_mesh_estimate_sizing_and_overflow(streams, monkeypatch):
    """Estimate-based shard sizing fills completely when generous; an
    under-sized shard raises SweepFillOverflow."""
    _, ts, one = streams
    args = sweep_args(one)
    n_grid = len(args[1])
    cum_global, _ = tsc.sweep_counts_mesh(ts, *args)
    total = int(cum_global[-1])
    edges, _ = tsc.sweep_fill_device(ts, *args, n_act=n_grid,
                                     e_total=total)
    assert edges.count == total
    monkeypatch.setattr(sparse_sweep, "band_slots", lambda e: 8)
    with pytest.raises(tsc.SweepFillOverflow, match="shard buffer 8"):
        tsc.sweep_fill_device(ts, *args, n_act=n_grid, e_total=total,
                              e_per_dev=np.full(8, 1))


def test_mesh_refine_matches_host(streams, pop, monkeypatch):
    """The device sparse sweep on the mesh ("edges") against the host
    scorer ("sparse"), the single device and the JAX package's mesh."""
    js, ts, one = streams
    scale, mean0, mean1, _ = start_fit(js, pop)
    kw = dict(max_move=0.05, score_idx=0, seed=4)
    monkeypatch.setenv("POPPUNK_TPU_SPARSE_SWEEP", "0")
    host = tsc.refine_fit_device(ts, scale, mean0, mean1, **kw)
    monkeypatch.setenv("POPPUNK_TPU_SPARSE_SWEEP", "1")
    dev = tsc.refine_fit_device(ts, scale, mean0, mean1, **kw)
    assert dev[3][0] == "edges" and host[3][0] == "sparse"
    np.testing.assert_allclose(dev[:3], host[:3], **BOUNDARY_TOL)
    single = tsc.refine_fit_device(one, scale, mean0, mean1, **kw)
    assert dev[:3] == single[:3]
    want = jsc.refine_fit_device(js, scale, mean0, mean1, **kw)
    np.testing.assert_allclose(dev[:3], want[:3], **BOUNDARY_TOL)


def test_mesh_fill_overflow_falls_back_to_exact_counts(streams, pop,
                                                       monkeypatch):
    """An estimate that under-sizes a shard: refine_fit_device pays for
    the exact counts pass and refills sized by its per-shard counts."""
    _, ts, one = streams
    scale, mean0, mean1, sub = start_fit(one, pop)
    kw = dict(max_move=0.05, score_idx=0, seed=4)
    want = tsc.refine_fit_device(one, scale, mean0, mean1, **kw)
    real_fill = tsc.sweep_fill_device
    calls = []

    def exploding_fill(*args, **kwargs):
        calls.append(kwargs.get("e_per_dev"))
        if len(calls) == 1:
            raise tsc.SweepFillOverflow("sweep fill overflow: forced")
        return real_fill(*args, **kwargs)

    monkeypatch.setattr(tsc, "sweep_fill_device", exploding_fill)
    timings = {}
    got = tsc.refine_fit_device(ts, scale, mean0, mean1, est_pairs=sub,
                                timings_out=timings, **kw)
    assert len(calls) == 2 and "counts" in timings
    assert calls[0] is None and calls[1].shape == (8,)
    assert got[:3] == want[:3]


def test_mesh_components_match_host(streams):
    from poppunk_tpu_torch.network.components import connected_components
    from poppunk_tpu_torch.network.graph import Graph

    _, ts, one = streams
    args = sweep_args(one)
    hi, hj, _, hd0 = tsc.sweep_first_offsets(one, *args)
    edges, _ = tsc.sweep_fill_device(ts, *args, n_act=len(args[1]),
                                     e_total=len(hi))
    _, _, t = jsc._line_d0_params(args[1], *args[2:])
    for tv in (t[5], t[12], t[-1]):
        labels, k = tsc.edge_components_device(edges, float(tv))
        mask = hd0 <= tv
        want, _ = connected_components(
            Graph(N, np.stack([hi[mask], hj[mask]], axis=1)))
        assert k == int(mask.sum())
        np.testing.assert_array_equal(labels, want)


# --------------------------------------------------------------------------
# the buffered tier


@pytest.fixture(scope="module")
def buffers(pop):
    """(JAX sharded, port sharded, port single device) buffered cds."""
    kw = dict(chunk=CHUNK, knn=5)
    return (jsc.fill_condensed_sharded(*operands(pop), mesh=jax_get_mesh(8),
                                       use_pallas=False, **kw),
            tsc.fill_condensed_sharded(*operands(pop), mesh=virtual(),
                                       **kw),
            tsc.fill_condensed_device(*operands(pop), **kw))


def test_sharded_fill_equals_the_single_device_and_jax(buffers):
    jcd, tcd, one = buffers
    assert isinstance(tcd.buf, tuple) and len(tcd.buf) == 8
    assert all(b.shape == (4, N - 1, 2) for b in tcd.buf)
    assert torch.equal(torch.cat(tcd.buf), one.buf)
    np.testing.assert_allclose(torch.cat(tcd.buf).numpy(),
                               np.asarray(jcd.buf), **FLOAT_TOL)
    np.testing.assert_array_equal(tcd.knn_col, one.knn_col)
    np.testing.assert_array_equal(tcd.knn_dist, one.knn_dist)
    assert_same_knn(tcd, jcd)
    np.testing.assert_array_equal(tcd.max_scale(), one.max_scale())
    np.testing.assert_array_equal(tcd.subsample_pairs(500, seed=2),
                                  one.subsample_pairs(500, seed=2))
    np.testing.assert_allclose(tcd.subsample_pairs(500, seed=2),
                               jcd.subsample_pairs(500, seed=2),
                               **FLOAT_TOL)


def test_sharded_buffer_readers_equal_the_single_device(buffers):
    """Every reader of the buffer walks the shards in row order: counts,
    the fetch, the fill, the d0 square, the matmul sweep and the
    components give the single-device answers."""
    jcd, tcd, one = buffers
    args = sweep_args(jcd)
    np.testing.assert_array_equal(tsc.sweep_counts_streaming(tcd, *args),
                                  tsc.sweep_counts_streaming(one, *args))
    assert_same_fetch(tsc.sweep_first_offsets(tcd, *args),
                      tsc.sweep_first_offsets(one, *args),
                      jsc.sweep_first_offsets(jcd, *args))
    e_total = int(tsc.sweep_counts_streaming(one, *args)[-1])
    got, _ = tsc.sweep_fill_device(tcd, *args, n_act=len(args[1]),
                                   e_total=e_total)
    want, _ = tsc.sweep_fill_device(one, *args, n_act=len(args[1]),
                                    e_total=e_total)
    assert torch.equal(got.i, want.i) and torch.equal(got.j, want.j)
    square, t = tsc.build_d0_square(tcd, args[0], 2, *args[3:], args[1])
    one_square, _ = tsc.build_d0_square(one, args[0], 2, *args[3:],
                                        args[1])
    assert torch.equal(square, one_square)
    for a, b in zip(tsc.matmul_sweep_scores(square, t),
                    tsc.matmul_sweep_scores(one_square, t)):
        np.testing.assert_array_equal(a, b)
    for tv in (t[4], t[12]):
        for a, b in zip(tsc.components_device(square, tv),
                        tsc.components_device(one_square, tv)):
            np.testing.assert_array_equal(a, b)
    assert tsc._resident_bytes(tcd) == tsc._resident_bytes(one)


def test_sharded_buffer_refine_takes_the_matmul_sweep(buffers, pop):
    _, tcd, one = buffers
    scale, mean0, mean1, _ = start_fit(one, pop)
    kw = dict(max_move=0.05, score_idx=0, seed=4)
    got = tsc.refine_fit_device(tcd, scale, mean0, mean1, **kw)
    want = tsc.refine_fit_device(one, scale, mean0, mean1, **kw)
    assert got[3][0] == want[3][0] == "device"
    assert got[:3] == want[:3]


def test_the_sharded_fill_refuses_ragged_shards(pop):
    with pytest.raises(ValueError, match="multiple of the device count"):
        tsc.fill_condensed_sharded(*operands(pop), mesh=virtual(3))
    with pytest.raises(ValueError, match="per-device rows"):
        tsc.fill_condensed_sharded(*operands(pop), mesh=virtual(8), chunk=3)


# --------------------------------------------------------------------------
# the column-sharding rule


@pytest.mark.parametrize("n,n_dev", [(65536, 4), (131072, 8), (200000, 8),
                                     (200001, 8), (64, 8)])
def test_resolve_shard_planes_equals_the_jax_package(n, n_dev):
    geom = (n, (13, 17, 21, 25, 29), 156, 14, 256, 30)

    class Shape:
        shape = {"q": 1, "r": n_dev}

    assert tsc._resolve_shard_planes("auto", Shape, *geom) == \
        jsc._resolve_shard_planes("auto", Shape, *geom)


def test_the_bootstrap_fill_and_other_ranks_are_refused(pop):
    cd = tsc.StreamingCondensed(*operands(pop), chunk=CHUNK, knn=5,
                                mesh=virtual(), defer=True)
    with pytest.raises(ValueError, match="single device"):
        cd.run_pass1(dict(scale=np.ones(2)))
    cd.run_pass1()  # the standard pass 1 runs on the mesh
    np.testing.assert_array_equal(
        cd.knn_col, tsc.StreamingCondensed(*operands(pop), chunk=CHUNK,
                                           knn=5).knn_col)
    two_ranks = tmesh.Mesh([CPU] * 2, (1, 2), ranks=[0, 1])
    with pytest.raises(ValueError, match="one process"):
        tsc.StreamingCondensed(*operands(pop), chunk=CHUNK, knn=5,
                               mesh=two_ranks)


# --------------------------------------------------------------------------
# the pipeline


def test_pipeline_device_choice(monkeypatch):
    """sharded=None: the buffered fill is sharded when there are more
    devices than one and n // 2 divides by their count; the streaming
    passes take the mesh by the same rule, without the bootstrap."""
    class Chose(Exception):
        pass

    def record(route):
        def fn(*args, **kwargs):
            raise Chose(route, kwargs.get("mesh"), kwargs.get("defer"))
        return fn

    monkeypatch.setattr(tsc, "fill_condensed_sharded", record("sharded"))
    monkeypatch.setattr(tsc, "fill_condensed_device", record("single"))
    monkeypatch.setattr(tsc, "StreamingCondensed", record("streaming"))
    kw = dict(klist=KLIST, sketchsize64=SS64, bbits=BBITS, n_strains=4,
              chunk=8, log=lambda m: None)

    def route(**extra):
        with pytest.raises(Chose) as chose:
            tsc.run_scale_pipeline(**kw, **extra)
        return chose.value.args

    mesh = virtual()
    assert route(n=64, mesh=mesh)[:2] == ("sharded", mesh)
    assert route(n=68, mesh=mesh)[0] == "single"  # 34 % 8
    assert route(n=64)[0] == "single"  # the CPU: one device
    assert route(n=64, sharded=True)[0] == "sharded"
    assert route(n=64, mesh=mesh, sharded=False)[0] == "single"
    assert route(n=64, mesh=mesh, streaming=True) == ("streaming", mesh,
                                                      False)
    assert route(n=68, mesh=mesh, streaming=True) == ("streaming", None,
                                                      True)


@pytest.mark.parametrize("streaming,route", [(False, "device"),
                                             (True, "edges")])
def test_pipeline_on_the_mesh_equals_the_jax_package(monkeypatch, streaming,
                                                     route):
    """run_scale_pipeline(mesh=8 CPU shards) against the JAX package's on
    its 8 devices (sharded=True; its streaming route takes the mesh
    itself) and the port's single device, on the JAX-drawn population."""
    import poppunk_tpu.network.incremental as j_incremental
    import poppunk_tpu_torch.network.incremental as t_incremental
    import poppunk_tpu_torch.synth as tsynth
    from poppunk_tpu.synth import synthetic_population_device as jax_synth
    from test_torch_scale_buffered import (PIPELINE, Labels,
                                           the_jax_draw_on_the_cpu)

    kw = PIPELINE
    jpop = jax_synth(kw["n"], kw["klist"], kw["sketchsize64"], kw["bbits"],
                     n_strains=kw["n_strains"], seed=kw["seed"],
                     chunk=max(kw["chunk"], min(kw["n"], 2048)),
                     **kw["synth_kwargs"])
    j_log, t_log = [], []
    j_rec = Labels(monkeypatch, jsc, j_incremental)
    want = jsc.run_scale_pipeline(streaming=streaming, sharded=True,
                                  log=j_log.append, **PIPELINE)
    monkeypatch.setattr(tsynth, "synthetic_population_device",
                        the_jax_draw_on_the_cpu(jpop))
    t_rec = Labels(monkeypatch, tsc, t_incremental)
    got = tsc.run_scale_pipeline(streaming=streaming, mesh=virtual(),
                                 log=t_log.append, **PIPELINE)
    one = tsc.run_scale_pipeline(streaming=streaming, log=lambda m: None,
                                 **PIPELINE)
    shard_line = ("dists: streaming sharded over 8 devices\n" if streaming
                  else "dists: folded buffer sharded over 8 devices\n")
    assert shard_line in t_log and shard_line in j_log
    assert got["route"] == one["route"] == route
    for key in ("n_edges", "n_clusters", "n_lineages", "streaming"):
        assert got[key] == want[key] == one[key], key
    assert got["ari"] == want["ari"] == 1.0
    # network and lineage labels, of the mesh run and of the single one
    assert len(t_rec.calls) == 2 * len(j_rec.calls) == 4
    for t_labels, j_labels in zip(t_rec.calls[:2], j_rec.calls):
        np.testing.assert_array_equal(t_labels, j_labels)
    np.testing.assert_array_equal(got["labels"], one["labels"])
    assert got["boundary"]["s_opt"] == one["boundary"]["s_opt"]
    assert got["timings"].keys() == want["timings"].keys()


# --------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def mesh_db(tmp_path_factory):
    """64 genomes in 8 strains: with --chunk 2 the reference's rule takes
    the mesh on 8 devices (n >= 4 * 8 * 2)."""
    from poppunk_tpu.cli.main import main as jax_main
    from synth_genomes import SyntheticPopulation
    from test_torch_pipeline import KARGS

    pop = SyntheticPopulation(
        n_strains=8, genomes_per_strain=(8,) * 8, genome_length=20_000,
        core_mutation_rate=0.008, between_divergence=0.035,
        accessory_pool=20, accessory_gene_len=1_000, seed=7)
    d = tmp_path_factory.mktemp("mesh_genomes")
    rfile = pop.write_fastas(str(d))
    db = str(d / "db")
    jax_main(["--create-db", "--r-files", rfile, "--output", db] + KARGS)
    return db


def test_cli_on_the_mesh_writes_the_jax_clis_csvs(mesh_db, tmp_path,
                                                  monkeypatch, capsys):
    """poppunk_tpu_torch_scale with the default mesh forced to 8 CPU
    shards writes the JAX CLI's cluster and lineage CSVs byte for byte;
    --single-device turns the mesh off and writes the same files."""
    from poppunk_tpu.cli.scale import main as jax_scale
    from poppunk_tpu_torch.cli.scale import main as torch_scale
    from test_torch_pipeline import base, read_bytes

    flags = ["--write-lineages", "--ranks", "1,2", "--chunk", "2",
             "--no-plot", "--seed", "42"]
    out = {}
    for name, main, extra in (("jax", jax_scale, []),
                              ("torch", torch_scale, []),
                              ("single", torch_scale, ["--single-device"])):
        if name != "jax":
            monkeypatch.setattr(tmesh, "visible_devices",
                                lambda: [CPU] * 8)
        out[name] = str(tmp_path / name)
        capsys.readouterr()
        main(["--ref-db", mesh_db, "--output", out[name]] + flags + extra)
        err = capsys.readouterr().err
        assert ("Sharding streaming passes over 8 devices" in err) == \
            (name != "single"), name
    for suffix in ("_clusters.csv", "_lineages.csv"):
        want = read_bytes(base(out["jax"]) + suffix)
        assert read_bytes(base(out["torch"]) + suffix) == want, suffix
        assert read_bytes(base(out["single"]) + suffix) == want, suffix
    assert len(set(read_bytes(base(out["torch"]) + "_clusters.csv")
                   .decode().split())) > 8


@pytest.mark.parametrize("n,chunk,n_dev", [(64, 2, 8), (63, 2, 8),
                                           (1001, 64, 4), (100, 8, 2)])
def test_pad_geometry_on_a_mesh_equals_the_jax_packages(monkeypatch, n,
                                                        chunk, n_dev):
    from poppunk_tpu.cli.scale import _pad_geometry as jax_pad_geometry
    from poppunk_tpu_torch.cli.scale import _pad_geometry

    monkeypatch.setattr(tmesh, "visible_devices", lambda: [CPU] * n_dev)
    c, n_pad, mesh = jax_pad_geometry(n, chunk, n_dev, True, n_kmers=4)
    tc, tn_pad, tmesh_ = _pad_geometry(n, chunk, n_dev, True, n_kmers=4)
    assert (tc, tn_pad) == (c, n_pad)
    assert (tmesh_ is None) == (mesh is None)
    if tmesh_ is not None:
        assert tmesh_.size == n_dev and n_pad % (2 * c * n_dev) == 0


# --------------------------------------------------------------------------
# on the card (skipped on a host without CUDA)


@pytest.mark.cuda
def test_row_sharded_tier_on_the_card():
    """The row-sharded passes on a virtual mesh of 4 shards on cuda:0
    equal the card's single-device route: the fill, pass 1, the sweep
    counts and fetch, the QC pass and the pipeline's partition."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", 0)
    mesh = tmesh.get_mesh(devices=[card] * 4)
    planes, lengths, freqs, _ = planted(N, ties=((1, 9), (2, 30)))
    ops = (planes, lengths, freqs, KLIST, SS64, BBITS)
    kw = dict(chunk=CHUNK, knn=5, subsample=(200, 3))
    ts = tsc.StreamingCondensed(*ops, mesh=mesh, **kw)
    one = tsc.StreamingCondensed(*ops, device=card, **kw)
    np.testing.assert_array_equal(ts.knn_col, one.knn_col)
    np.testing.assert_array_equal(ts.subsample_pairs(200, seed=3),
                                  one.subsample_pairs(200, seed=3))
    args = sweep_args(one)
    for a, b in zip(tsc.sweep_first_offsets(ts, *args),
                    tsc.sweep_first_offsets(one, *args)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsc.qc_bad_pairs_streaming(*ops, CHUNK, N, 0.05, 0.3,
                                               mesh=mesh),
                    tsc.qc_bad_pairs_streaming(*ops, CHUNK, N, 0.05, 0.3,
                                               device=card)):
        np.testing.assert_array_equal(a, b)
    buf = tsc.fill_condensed_sharded(*ops[:6], mesh=mesh, chunk=CHUNK)
    assert torch.equal(torch.cat(buf.buf), tsc.fill_condensed_device(
        *ops[:6], chunk=CHUNK, device=card).buf)
    from test_torch_scale_buffered import PIPELINE

    got = tsc.run_scale_pipeline(mesh=mesh, log=lambda m: None, **PIPELINE)
    want = tsc.run_scale_pipeline(device=card, log=lambda m: None,
                                  **PIPELINE)
    assert got["route"] == want["route"] == "device"
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["n_edges"] == want["n_edges"]
