"""The port's column-sharded scale tier against its single device and the
JAX package's column-sharded mesh, on the CPU.

Column shards (shard_planes): the planes split over the genome axis, every
device walking every folded chunk and owning its column slice of each
tile. The JAX package runs its mesh on the 8 virtual CPU devices of
tests/conftest.py (use_pallas=False); the port runs a mesh of the CPU
repeated 8 times, get_mesh(devices=[cpu] * 8). The planes are
tests/test_torch_scale.py's planted populations: 64 genomes (chunk 4,
eight columns per shard) and 61 genomes padded to 80 (chunk 5, the pads
inside the last shard). The cases mirror tests/test_scale.py's
TestColShardedStreaming, the column cases of TestMeshCompactPasses and
TestArbitraryPadStreaming, tests/test_sparse_sweep.py's tier "col", then
the 2-D passes, multi_refine_device, refine, the pipeline and the scale
CLI forced onto column shards.

Tolerances: against the port's single device everything is exact, floats
included (each pair's arithmetic is the same whatever the tile's width);
fetches, whose column order groups pairs by owning device, compare as
sorted sets. Against the JAX package's column mesh: counts, fetched (i,
j, offset) in its order, QC flags, edges, files and the CLI's CSVs
exactly; kNN indices exactly but at its float near-ties
(test_torch_scale.assert_same_knn); distances within FLOAT_TOL, refined
boundaries within BOUNDARY_TOL.
"""

import os

import numpy as np
import pytest
import torch

import poppunk_tpu.scale as jsc
import poppunk_tpu_torch.parallel.mesh as tmesh
import poppunk_tpu_torch.scale as tsc
from poppunk_tpu.parallel.mesh import get_mesh as jax_get_mesh
from test_torch_scale import (BBITS, BOUNDARY_TOL, FLOAT_TOL, KLIST, SS64,
                              assert_same_knn, planted, start_fit,
                              sweep_args)
from test_torch_scale_mesh import mesh_db  # noqa: F401 (a fixture)

torch.set_num_threads(2)

CPU = torch.device("cpu")
N = 64
CHUNK = 4
X_GRID = np.linspace(0.05, 0.9, 6).astype(np.float32)
Y_GRID = np.linspace(0.05, 0.9, 5).astype(np.float32)


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
    """(JAX column mesh, port column mesh, port single device)
    StreamingCondensed, knn 5 and a predeclared subsample of 200 pairs
    (seed 3)."""
    kw = dict(chunk=CHUNK, knn=5, subsample=(200, 3))
    return (jsc.StreamingCondensed(*operands(pop), use_pallas=False,
                                   mesh=jax_get_mesh(8), shard_planes=True,
                                   **kw),
            tsc.StreamingCondensed(*operands(pop), mesh=virtual(),
                                   shard_planes=True, **kw),
            tsc.StreamingCondensed(*operands(pop), **kw))


def in_pair_order(arrays):
    """The arrays of a fetch (i, j first) sorted by (i, j)."""
    order = np.lexsort((arrays[1], arrays[0]))
    return [a[order] for a in arrays]


def assert_same_fetch(got, one, want, n_float=1):
    """A column-sharded fetch: the single device's pairs as a set (floats
    included, exactly) and the JAX package's column fetch in its order,
    its last ``n_float`` arrays within FLOAT_TOL."""
    assert len(got[0]) > 0
    for a, b in zip(in_pair_order(got), in_pair_order(one)):
        np.testing.assert_array_equal(a, b)
    k = len(got) - n_float
    for a, b in zip(got[:k], want[:k]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[k:], want[k:]):
        np.testing.assert_allclose(a, b, **FLOAT_TOL)


# --------------------------------------------------------------------------
# pass 1 and the sweeps (TestColShardedStreaming)


def test_knn_and_scale_match(streams):
    js, ts, one = streams
    assert ts._col and js._col and ts._n_dev == 8 and ts.chunk == CHUNK
    assert len(ts.planes) == 8
    assert all(p.shape == (len(KLIST), BBITS, 8, one.planes.shape[3])
               for p in ts.planes)
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


def test_recomputed_subsample_matches(streams):
    """A (size, seed) not predeclared: each pair's rows gathered from the
    shards that own them."""
    js, ts, one = streams
    got = ts.subsample_pairs(64, seed=11, block=32)
    np.testing.assert_array_equal(got, one.subsample_pairs(64, seed=11,
                                                           block=32))
    np.testing.assert_allclose(got, js.subsample_pairs(64, seed=11,
                                                       block=32),
                               **FLOAT_TOL)


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


def test_2d_passes_match(streams):
    """The 2-D counts equal the single device's and the JAX package's;
    the in-union fetch is the single device's set and the JAX package's
    column fetch in its order."""
    js, ts, one = streams
    scale = np.asarray(js.max_scale(), np.float64)
    want = tsc.sweep2d_counts_streaming(one, scale, X_GRID, Y_GRID)
    np.testing.assert_array_equal(
        tsc.sweep2d_counts_streaming(ts, scale, X_GRID, Y_GRID), want)
    np.testing.assert_array_equal(
        jsc.sweep2d_counts_streaming(js, scale, X_GRID, Y_GRID), want)
    x_caps = np.full(len(Y_GRID), X_GRID[-1], np.float32)
    assert_same_fetch(
        tsc.sweep2d_fetch_streaming(ts, scale, x_caps, Y_GRID),
        tsc.sweep2d_fetch_streaming(one, scale, x_caps, Y_GRID),
        jsc.sweep2d_fetch_streaming(js, scale, x_caps, Y_GRID), n_float=2)


def test_refine_2d_matches(streams, pop):
    js, ts, one = streams
    scale, mean0, mean1, _ = start_fit(one, pop)
    kw = dict(max_move=0.05, score_idx=0, seed=4, grid=8)
    got = tsc.refine_fit_device_2d(ts, scale, mean0, mean1, **kw)
    assert got[:2] == tsc.refine_fit_device_2d(one, scale, mean0, mean1,
                                               **kw)[:2]
    want = jsc.refine_fit_device_2d(js, scale, mean0, mean1, **kw)
    np.testing.assert_allclose(got[:2], want[:2], **BOUNDARY_TOL)


def test_multi_refine_writes_the_jax_packages_files(streams, pop,
                                                    tmp_path):
    js, ts, one = streams
    scale, mean0, mean1, _ = start_fit(one, pop)
    files = {}
    for name, sc, cd in (("jax", jsc, js), ("torch", tsc, ts),
                         ("single", tsc, one)):
        out = tmp_path / name / "multi"
        out.mkdir(parents=True)
        sc.multi_refine_device(cd, scale, mean0, mean1, 0.3, 4, str(out),
                               [f"g{k}" for k in range(cd.n)])
        files[name] = {f: (out / f).read_bytes()
                       for f in sorted(os.listdir(out))}
    assert files["jax"] and files["torch"] == files["jax"]
    assert files["single"] == files["jax"]


def test_refine_matches_single_device(streams, pop):
    """The device sparse sweep over the column shards' per-device fills
    ("edges") against the single device and the JAX package's column
    mesh."""
    js, ts, one = streams
    scale, mean0, mean1, _ = start_fit(js, pop)
    kw = dict(max_move=0.05, score_idx=0, seed=4)
    got = tsc.refine_fit_device(ts, scale, mean0, mean1, **kw)
    assert got[3][0] == "edges"
    assert got[:3] == tsc.refine_fit_device(one, scale, mean0, mean1,
                                            **kw)[:3]
    want = jsc.refine_fit_device(js, scale, mean0, mean1, **kw)
    np.testing.assert_allclose(got[:3], want[:3], **BOUNDARY_TOL)


# --------------------------------------------------------------------------
# the device sweep (test_sparse_sweep.py::TestMeshShardedSweep, tier "col")


def test_mesh_fill_matches_fetch(streams):
    js, ts, one = streams
    args = sweep_args(js)
    n_grid = len(args[1])
    hi, hj, hidx, _ = tsc.sweep_first_offsets(one, *args)
    cum_global, per_dev = tsc.sweep_counts_mesh(ts, *args)
    assert per_dev.shape == (8, n_grid)
    assert per_dev.sum(axis=0)[-1] == cum_global[-1] == len(hi)
    np.testing.assert_array_equal(per_dev, jsc.sweep_counts_mesh(js,
                                                                 *args)[1])
    edges, cum_fill = tsc.sweep_fill_device(
        ts, *args, n_act=n_grid, e_total=int(cum_global[-1]),
        e_per_dev=per_dev[:, -1])
    np.testing.assert_array_equal(cum_fill, cum_global)
    assert edges.count == len(hi) and edges.n_real == N
    one_edges, _ = tsc.sweep_fill_device(one, *args, n_act=n_grid,
                                         e_total=len(hi))
    assert torch.equal(edges.d0, one_edges.d0)
    _, _, t = jsc._line_d0_params(args[1], *args[2:])
    for o in (4, 11, n_grid - 1):
        k = int(edges.counts_at(np.array([t[o]]))[0])
        pi, pj = edges.fetch_prefix(k)
        mask = hidx <= o
        assert (sorted(zip(pi.tolist(), pj.tolist()))
                == sorted(zip(hi[mask].tolist(), hj[mask].tolist())))


# --------------------------------------------------------------------------
# the compaction passes (TestMeshCompactPasses, column cases)


def test_qc_pairs_col_sharded(pop):
    args = (*operands(pop), CHUNK, N, 0.05, 0.3)
    one = tsc.qc_bad_pairs_streaming(*args)
    got = tsc.qc_bad_pairs_streaming(*args, mesh=virtual(),
                                     shard_planes=True)
    want = jsc.qc_bad_pairs_streaming(*args, use_pallas=False,
                                      mesh=jax_get_mesh(8),
                                      shard_planes=True)
    assert len(one[0]) > 0
    for a, b, c in zip(got, one, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("slope,bx,by", [(2, 0.4, 0.5), (0, 0.3, 0.0)])
def test_boundary_fetch_col_sharded(pop, streams, slope, bx, by):
    """Pairs grouped by owning device: the JAX package's column fetch in
    its order, the single device's as a set."""
    scale = np.asarray(streams[0].max_scale(), np.float64)
    args = (*operands(pop), CHUNK, N, scale, bx, by, slope)
    one = tsc.fetch_within_boundary(*args)
    got = tsc.fetch_within_boundary(*args, mesh=virtual(),
                                    shard_planes=True)
    want = jsc.fetch_within_boundary(*args, use_pallas=False,
                                     mesh=jax_get_mesh(8),
                                     shard_planes=True)
    assert len(one[0]) > 0 and got[0].dtype == np.int32
    assert not np.array_equal(got[0], one[0])  # another order
    for a, b in zip(in_pair_order(got), in_pair_order(one)):
        np.testing.assert_array_equal(a, b)
    for a, c in zip(got, want):
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("chunk", [3, 12])
def test_the_compaction_halves_its_chunk(pop, chunk):
    """The column compaction's own chunk rule: c halved until it divides
    n // 2 (3 -> 1, 12 -> 6 -> 3 -> 1 at n // 2 = 32), where the row
    shards would refuse; the pairs are the single device's."""
    args = (*operands(pop), chunk, N, 0.05, 0.3)
    got = tsc.qc_bad_pairs_streaming(*args, mesh=virtual(),
                                     shard_planes=True)
    for a, b in zip(got, tsc.qc_bad_pairs_streaming(*operands(pop), CHUNK,
                                                    N, 0.05, 0.3)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# padding (TestArbitraryPadStreaming::test_col_sharded_gap19)


def test_col_sharded_gap19():
    """61 genomes padded to 80 over 8 column shards of 10 (chunk 5): the
    19 pads all lie in the last two shards and stay exactly masked."""
    planes, lengths, freqs, _ = planted(61, n_pad=80)
    kw = dict(chunk=5, knn=5, subsample=(150, 3), n_real=61)
    ops = (planes, lengths, freqs, KLIST, SS64, BBITS)
    ts = tsc.StreamingCondensed(*ops, mesh=virtual(), shard_planes=True,
                                **kw)
    one = tsc.StreamingCondensed(*ops, **kw)
    js = jsc.StreamingCondensed(*ops, use_pallas=False,
                                mesh=jax_get_mesh(8), shard_planes=True,
                                **kw)
    assert ts._col and ts.n == 61 and ts.n_pairs == 61 * 60 // 2
    np.testing.assert_array_equal(ts.knn_col, one.knn_col)
    np.testing.assert_array_equal(ts.knn_dist, one.knn_dist)
    assert (ts.knn_col < 61).all()
    assert_same_knn(ts, js)
    np.testing.assert_array_equal(ts.max_scale(), one.max_scale())
    np.testing.assert_array_equal(ts.subsample_pairs(150, seed=3),
                                  one.subsample_pairs(150, seed=3))
    np.testing.assert_allclose(ts.subsample_pairs(150, seed=3),
                               js.subsample_pairs(150, seed=3), **FLOAT_TOL)
    args = sweep_args(js)
    got = tsc.sweep_first_offsets(ts, *args)
    assert_same_fetch(got, tsc.sweep_first_offsets(one, *args),
                      jsc.sweep_first_offsets(js, *args))
    assert (got[0] < 61).all() and (got[1] < 61).all()
    np.testing.assert_array_equal(tsc.sweep_counts_streaming(ts, *args),
                                  tsc.sweep_counts_streaming(one, *args))
    qc = tsc.qc_bad_pairs_streaming(*ops, 5, 61, 0.05, 0.3, mesh=virtual(),
                                    shard_planes=True)
    for a, b, c in zip(qc, tsc.qc_bad_pairs_streaming(*ops, 5, 61, 0.05,
                                                      0.3),
                       jsc.qc_bad_pairs_streaming(
                           *ops, 5, 61, 0.05, 0.3, use_pallas=False,
                           mesh=jax_get_mesh(8), shard_planes=True)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# --------------------------------------------------------------------------
# the shards themselves


def test_column_shards_are_taken_as_they_are(pop, streams):
    """A column-sharded cd's planes (the tuple of its shards), as
    --mandrake hands them to its accessory-kNN pass: another kNN without
    copying the population again, equal to the single device's."""
    _, ts, _ = streams
    cd = tsc.StreamingCondensed(ts.planes, ts.lengths, ts.freqs, KLIST,
                                SS64, BBITS, chunk=CHUNK, knn=7, dist_col=1,
                                mesh=virtual())
    one = tsc.StreamingCondensed(*operands(pop), chunk=CHUNK, knn=7,
                                 dist_col=1)
    assert cd._col
    np.testing.assert_array_equal(cd.knn_col, one.knn_col)
    np.testing.assert_array_equal(cd.knn_dist, one.knn_dist)
    with pytest.raises(ValueError, match="mesh they lie on"):
        tsc.StreamingCondensed(ts.planes, ts.lengths, ts.freqs, KLIST,
                               SS64, BBITS, chunk=CHUNK)
    with pytest.raises(ValueError, match="8 column shards"):
        tsc.StreamingCondensed(ts.planes, ts.lengths, ts.freqs, KLIST,
                               SS64, BBITS, chunk=CHUNK, mesh=virtual(4))
    with pytest.raises(ValueError, match="multiple of the device count"):
        tsc.StreamingCondensed(*operands(pop), chunk=CHUNK, mesh=virtual(3),
                               shard_planes=True)


def force_column_shards(monkeypatch):
    """Both packages' "auto" rule sees more than 8e9 bytes of replicated
    planes, as past ~76k genomes at K 6, and takes the column shards."""
    for module in (jsc, tsc):
        real = module.streaming_hbm_accounting
        monkeypatch.setattr(
            module, "streaming_hbm_accounting",
            lambda *a, _real=real, **k: dict(_real(*a, **k), planes=9e9))


def test_auto_takes_the_column_shards(pop, monkeypatch):
    ops = operands(pop)
    assert not tsc.StreamingCondensed(*ops, chunk=CHUNK, knn=5,
                                      mesh=virtual(),
                                      shard_planes="auto")._col
    force_column_shards(monkeypatch)
    cd = tsc.StreamingCondensed(*ops, chunk=CHUNK, knn=5, mesh=virtual(),
                                shard_planes="auto")
    assert cd._col
    assert not tsc.StreamingCondensed(*ops, chunk=CHUNK, knn=5,
                                      shard_planes="auto")._col


def test_pipeline_on_column_shards_equals_the_jax_package(monkeypatch):
    """run_scale_pipeline's streaming route on 8 column shards (both
    packages' "auto" forced onto them) against the JAX package's and the
    port's single device, on the JAX-drawn population."""
    import poppunk_tpu_torch.synth as tsynth
    from poppunk_tpu.synth import synthetic_population_device as jax_synth
    from test_torch_scale_buffered import PIPELINE, the_jax_draw_on_the_cpu

    kw = PIPELINE
    jpop = jax_synth(kw["n"], kw["klist"], kw["sketchsize64"], kw["bbits"],
                     n_strains=kw["n_strains"], seed=kw["seed"],
                     chunk=max(kw["chunk"], min(kw["n"], 2048)),
                     **kw["synth_kwargs"])
    monkeypatch.setattr(tsynth, "synthetic_population_device",
                        the_jax_draw_on_the_cpu(jpop))
    one = tsc.run_scale_pipeline(streaming=True, log=lambda m: None,
                                 **PIPELINE)
    force_column_shards(monkeypatch)
    j_log, t_log = [], []
    want = jsc.run_scale_pipeline(streaming=True, sharded=True,
                                  log=j_log.append, **PIPELINE)
    got = tsc.run_scale_pipeline(streaming=True, mesh=virtual(),
                                 log=t_log.append, **PIPELINE)
    line = ("dists: column-sharded planes (replicated residency would "
            "crowd per-device HBM)\n")
    assert line in t_log and line in j_log
    assert got["route"] == one["route"] == "edges"
    for key in ("n_edges", "n_clusters", "n_lineages"):
        assert got[key] == want[key] == one[key], key
    assert got["ari"] == want["ari"] == 1.0
    np.testing.assert_array_equal(got["labels"], one["labels"])
    assert got["boundary"]["s_opt"] == pytest.approx(
        one["boundary"]["s_opt"], rel=1e-4)


def test_cli_on_column_shards_writes_the_jax_clis_csvs(mesh_db, tmp_path,
                                                       monkeypatch, capsys):
    """poppunk_tpu_torch_scale on 8 CPU shards with "auto" forced onto
    the column shards (both packages) writes the JAX CLI's cluster CSV
    byte for byte, as does the port's single device, and its lineage CSV
    is the single device's. The JAX package's column path cannot take
    --write-lineages here: its kNN asks each shard of 8 genomes for the
    lineage fit's 25 neighbours (lax.top_k refuses k past the width), so
    its run writes the clusters alone."""
    from poppunk_tpu.cli.scale import main as jax_scale
    from poppunk_tpu_torch.cli.scale import main as torch_scale
    from test_torch_pipeline import base, read_bytes

    flags = ["--chunk", "2", "--no-plot", "--seed", "42"]
    lineages = ["--write-lineages", "--ranks", "1,2"]
    out = {}
    monkeypatch.setattr(tmesh, "visible_devices", lambda: [CPU] * 8)
    out["single"] = str(tmp_path / "single")
    torch_scale(["--ref-db", mesh_db, "--output", out["single"],
                 "--single-device"] + flags + lineages)
    force_column_shards(monkeypatch)
    for name, main, extra in (("jax", jax_scale, []),
                              ("torch", torch_scale, lineages)):
        out[name] = str(tmp_path / name)
        capsys.readouterr()
        main(["--ref-db", mesh_db, "--output", out[name]] + flags + extra)
        assert "Column-sharded planes over the mesh" in \
            capsys.readouterr().err, name
    want = read_bytes(base(out["jax"]) + "_clusters.csv")
    assert read_bytes(base(out["torch"]) + "_clusters.csv") == want
    assert read_bytes(base(out["single"]) + "_clusters.csv") == want
    assert len(set(want.decode().split())) > 8
    assert (read_bytes(base(out["torch"]) + "_lineages.csv")
            == read_bytes(base(out["single"]) + "_lineages.csv"))


# --------------------------------------------------------------------------
# on the card (skipped on a host without CUDA)


@pytest.mark.cuda
def test_column_tier_on_the_card():
    """The column-sharded passes on a virtual mesh of 4 shards on cuda:0
    equal the card's single device: pass 1, the counts, the fetch and the
    QC pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", 0)
    mesh = tmesh.get_mesh(devices=[card] * 4)
    planes, lengths, freqs, _ = planted(N, ties=((1, 9), (2, 30)))
    ops = (planes, lengths, freqs, KLIST, SS64, BBITS)
    kw = dict(chunk=CHUNK, knn=5, subsample=(200, 3))
    ts = tsc.StreamingCondensed(*ops, mesh=mesh, shard_planes=True, **kw)
    one = tsc.StreamingCondensed(*ops, device=card, **kw)
    np.testing.assert_array_equal(ts.knn_col, one.knn_col)
    np.testing.assert_array_equal(ts.knn_dist, one.knn_dist)
    np.testing.assert_array_equal(ts.subsample_pairs(200, seed=3),
                                  one.subsample_pairs(200, seed=3))
    args = sweep_args(one)
    np.testing.assert_array_equal(tsc.sweep_counts_streaming(ts, *args),
                                  tsc.sweep_counts_streaming(one, *args))
    for a, b in zip(in_pair_order(tsc.sweep_first_offsets(ts, *args)),
                    in_pair_order(tsc.sweep_first_offsets(one, *args))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsc.qc_bad_pairs_streaming(*ops, CHUNK, N, 0.05, 0.3,
                                               mesh=mesh,
                                               shard_planes=True),
                    tsc.qc_bad_pairs_streaming(*ops, CHUNK, N, 0.05, 0.3,
                                               device=card)):
        np.testing.assert_array_equal(a, b)
