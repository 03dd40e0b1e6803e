"""The port's streaming scale tier against the JAX package's, on the CPU.

The same seeded numpy planes (planted strains, plane-major) go through
poppunk_tpu.scale (JAX on the CPU, use_pallas=False, as
tests/test_scale.py runs it) and poppunk_tpu_torch.scale.

Tolerances: integer outputs (fold positions, kNN indices, per-offset
counts, edge sets, fetched (i, j, first offset)) are exact. Float outputs
(kNN distances, column maxima, subsample values) within the port's
core/accessory tolerance, rtol 1e-5 plus an absolute 2e-5
(tests/test_torch_distances.py): the two packages compute the same float32
arithmetic in different orders (the 4-wide random-match dots, the k-mer
fit's sums), and the fit's 1 - e^slope loses the relative precision of
near-zero distances. Refined boundaries within
rtol 1e-4 atol 1e-6, the JAX package's own refine tests' tolerance
(tests/test_sparse_sweep.py:236-237).
"""

import numpy as np
import pytest
import torch

import poppunk_tpu.scale as jsc
import poppunk_tpu_torch.scale as tsc
from poppunk_tpu_torch.ops import match_counts as mc
from poppunk_tpu_torch.ops import sparse_sweep
from poppunk_tpu_torch.ops.distances import plane_geometry, planes_to_tensor

torch.set_num_threads(2)

KLIST = (13, 17, 21)
SS64 = 16
BBITS = 8
CHUNK = 8
FLOAT_TOL = dict(rtol=1e-5, atol=2e-5)
BOUNDARY_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, as a CPU-only host must."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        m.delenv("POPPUNK_TPU_SPARSE_SWEEP", raising=False)
        yield


def planted(n, n_strains=4, seed=11, n_pad=None, ties=()):
    """Plane-major planes [K, P, n_pad, Wp] whose per-bin agreement follows
    pr(k) = (1-a)(1-c)^k, (a, c) = (0.01, 0.001) within a strain and
    (0.15, 0.01) across (chip_smoke.py's planted population, small);
    genomes past n are zero pads with the reference's pad metadata.
    ``ties``: (a, b) pairs whose genome b is a copy of genome a, so
    distances to them tie exactly. Returns (planes, lengths, freqs,
    strains)."""
    rng = np.random.default_rng(seed)
    k = np.asarray(KLIST, np.float64)
    pr_w = 0.99 * 0.999 ** k
    pr_b = 0.85 * 0.99 ** k
    s = np.sqrt(pr_w)[:, None]
    t = np.sqrt(pr_b / pr_w)[:, None]
    nbins = SS64 * 64
    w32, wp, _ = plane_geometry(SS64, BBITS)
    top = 1 << BBITS
    ancestor = rng.integers(0, top, (len(k), nbins))
    roots = np.where(rng.random((n_strains, len(k), nbins)) < t, ancestor,
                     rng.integers(0, top, (n_strains, len(k), nbins)))
    strains = np.arange(n) % n_strains
    keep = rng.random((n, len(k), nbins)) < s
    vals = np.where(keep, roots[strains],
                    rng.integers(0, top, (n, len(k), nbins)))
    n_pad = n if n_pad is None else n_pad
    planes = np.zeros((n_pad, len(k), BBITS, wp), np.uint32)
    for p in range(BBITS):
        bits = ((vals >> p) & 1).astype(np.uint8)
        planes[:n, :, p, :w32] = np.packbits(
            bits, axis=-1, bitorder="little").view("<u4")
    lengths = np.full(n_pad, 2_000_000, np.int32)
    freqs = np.full((n_pad, 4), 0.25, np.float32)
    lengths[:n] = rng.integers(1_800_000, 2_200_000, n)
    freqs[:n] = rng.dirichlet(np.array([30.0, 20.0, 20.0, 30.0]) * 50, n)
    for a, b in ties:
        planes[b], lengths[b], freqs[b] = planes[a], lengths[a], freqs[a]
    return (np.ascontiguousarray(planes.transpose(1, 2, 0, 3)), lengths,
            freqs, strains)


def both(planes, lengths, freqs, **kw):
    """(JAX, port) StreamingCondensed on the same inputs."""
    j = jsc.StreamingCondensed(planes, lengths, freqs, KLIST, SS64, BBITS,
                               chunk=CHUNK, use_pallas=False, **kw)
    t = tsc.StreamingCondensed(planes, lengths, freqs, KLIST, SS64, BBITS,
                               chunk=CHUNK, **kw)
    return j, t


POPS = {
    # even n; two planted ties (genome 9 copies 1, 30 copies 2)
    "even": dict(n=64, ties=((1, 9), (2, 30))),
    # odd n padded to the chunk grid: the n_real masking path
    "odd": dict(n=61, n_pad=64, ties=((0, 4),)),
}


@pytest.fixture(scope="module", params=sorted(POPS))
def pop(request):
    spec = POPS[request.param]
    planes, lengths, freqs, strains = planted(
        spec["n"], n_pad=spec.get("n_pad"), ties=spec["ties"])
    return dict(planes=planes, lengths=lengths, freqs=freqs,
                strains=strains, n=spec["n"], ties=spec["ties"])


@pytest.fixture(scope="module")
def streams(pop):
    """Pass 1 with knn 5 and a predeclared subsample (200 pairs, seed 3)."""
    return both(pop["planes"], pop["lengths"], pop["freqs"], knn=5,
                n_real=pop["n"], subsample=(200, 3))


def geometry(stream):
    """(scale, mean0, mean1) for sweeps: the column maxima and the planted
    within / between means of the scaled distances."""
    scale = np.asarray(stream.max_scale(), np.float64)
    return scale, np.array([0.05, 0.2]), np.array([0.6, 0.8])


def assert_same_knn(ts, js):
    """The kNN equal the JAX package's: distances within FLOAT_TOL and the
    indices bit for bit, but where the JAX package's own distances of the
    two swapped neighbours are within FLOAT_TOL of each other. Exact ties
    (the planted copies) resolve to the lowest index in both packages; two
    distinct genomes whose distances differ by the fit's float32 noise
    (~1e-7 absolute at core distances of ~2e-4) may come in either order."""
    np.testing.assert_allclose(ts.knn_dist, js.knn_dist, **FLOAT_TOL)
    bad = np.argwhere(ts.knn_col != js.knn_col)
    assert len(bad) <= 0.01 * ts.knn_col.size, bad
    for r, c in bad:
        row = list(js.knn_col[r])
        assert ts.knn_col[r, c] in row, (r, c)
        np.testing.assert_allclose(js.knn_dist[r, row.index(
            ts.knn_col[r, c])], js.knn_dist[r, c], **FLOAT_TOL)


# --------------------------------------------------------------------------
# the folded layout


@pytest.mark.parametrize("n", [20, 64, 65])
def test_fold_index_round_trips_and_equals_the_jax_package(n):
    i, j = np.triu_indices(n, 1)
    if n % 2:
        with pytest.raises(ValueError):
            tsc.fold_rows(n)
        return
    pos = tsc.fold_index(i, j, n)
    assert sorted(pos) == list(range(n * (n - 1) // 2))
    np.testing.assert_array_equal(pos, jsc.fold_index(i, j, n))
    i2, j2 = tsc.fold_inverse(pos, n)
    np.testing.assert_array_equal(i2, i)
    np.testing.assert_array_equal(j2, j)
    assert tsc.fold_rows(n) == jsc.fold_rows(n)


# --------------------------------------------------------------------------
# pass 1


def test_pass1_knn_maxima_and_subsample_equal_the_jax_package(streams, pop):
    js, ts = streams
    assert ts.n == js.n == pop["n"] and ts.n_pairs == js.n_pairs
    assert_same_knn(ts, js)
    np.testing.assert_allclose(ts.max_scale(), js.max_scale(), **FLOAT_TOL)
    got, want = ts.subsample_pairs(200, seed=3), js.subsample_pairs(200,
                                                                    seed=3)
    assert got.shape == want.shape == (200, 2)
    np.testing.assert_allclose(got, want, **FLOAT_TOL)
    # the recomputed draw (another seed: not predeclared)
    got = ts.subsample_pairs(150, seed=5, block=64)
    np.testing.assert_allclose(got, js.subsample_pairs(150, seed=5,
                                                       block=64),
                               **FLOAT_TOL)
    for rows in (ts.knn_sparse(), js.knn_sparse()):
        assert rows[0].shape == (pop["n"] * 5,)
    np.testing.assert_array_equal(ts.knn_sparse()[0], js.knn_sparse()[0])


def test_the_predeclared_subsample_equals_the_recomputed_draw(streams):
    _, ts = streams
    np.testing.assert_allclose(
        ts.subsample_pairs(200, seed=3),
        _undeclared(ts).subsample_pairs(200, seed=3, block=32), **FLOAT_TOL)


def _undeclared(ts):
    """The same stream with its predeclared spec hidden."""
    clone = object.__new__(tsc.StreamingCondensed)
    clone.__dict__.update(ts.__dict__, _sub_spec=None)
    return clone


def assert_ties_to_the_lowest_index(ts, pop, must_meet):
    """Genome b is a copy of genome a (a < b): in every row that holds
    both, a comes first; with ``must_meet``, some row holds both."""
    planes = pop["planes"]
    for a, b in pop["ties"]:
        assert np.array_equal(planes[:, :, a], planes[:, :, b])
        both_in = 0
        for row in range(ts.n):
            nbrs = list(ts.knn_col[row])
            if a in nbrs and b in nbrs:
                assert nbrs.index(a) < nbrs.index(b)
                both_in += 1
        assert both_in > 0 or not must_meet
        assert ts.knn_dist[a][0] == ts.knn_dist[b][0] == 0


def test_planted_ties_resolve_to_the_lowest_index(streams, pop):
    assert_ties_to_the_lowest_index(streams[1], pop, must_meet=False)


@pytest.mark.parametrize("knn,dist_col", [(20, 1), (30, 0)])
def test_pass1_past_16_neighbours_equals_the_jax_package(pop, knn,
                                                         dist_col):
    js, ts = both(pop["planes"], pop["lengths"], pop["freqs"], knn=knn,
                  dist_col=dist_col, n_real=pop["n"])
    assert_same_knn(ts, js)
    assert_ties_to_the_lowest_index(ts, pop, must_meet=True)


def test_pads_never_enter_the_knn_and_are_never_drawn(streams, pop):
    _, ts = streams
    assert ts.knn_col.shape == (pop["n"], 5)
    assert ts.knn_col.max() < pop["n"]
    assert np.isfinite(ts.subsample_pairs(200, seed=3)).all()


@pytest.mark.parametrize("knn", [3, 17])
def test_seq_topk_orders_ties_by_index(knn):
    """The kNN's keys (_keys, _smallest, _decode) order ties by the lowest
    index, as the JAX package's sequential top-k does."""
    rng = np.random.default_rng(4)
    col = rng.integers(0, 5, (7, 40)).astype(np.float32)  # many ties
    col[2, :] = 1.0
    idx, d = tsc._decode(tsc._smallest(tsc._keys(torch.from_numpy(col)),
                                       knn))
    want = np.lexsort((np.broadcast_to(np.arange(40), col.shape), col),
                      axis=1)[:, :knn]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(d.numpy(), np.take_along_axis(col, want,
                                                                axis=1))


def test_cum_counts_equal_the_compare_on_ties_inf_and_nan():
    t = torch.tensor([-1.0, 0.0, 0.0, 0.5, 2.0])
    d0 = torch.tensor([-2.0, -1.0, 0.0, 0.0, 0.25, 0.5, 2.0, 3.0,
                       float("inf"), float("-inf"), float("nan")])
    want = torch.stack([(d0 <= tv).sum() for tv in t])
    assert torch.equal(tsc._cum_counts(d0, t), want)
    assert tsc._first_offsets(d0, t)[-1] == len(t)


def test_streaming_hbm_accounting_equals_the_jax_package():
    prod = dict(klist=(13, 17, 21, 25, 29), sketchsize64=156, bbits=14,
                chunk=256, knn=30, n_dev=1)
    for n in (8192, 65536):
        assert tsc.streaming_hbm_accounting(n, **prod) == \
            jsc.streaming_hbm_accounting(n, **prod)


# --------------------------------------------------------------------------
# the sweeps


def sweep_args(stream):
    scale, mean0, mean1 = geometry(stream)
    offsets = np.linspace(0.0, 0.6, 20)
    return scale, offsets, 2, mean0[0], mean0[1], mean1[0], mean1[1]


@pytest.mark.parametrize("slope", [0, 1, 2])
def test_counts_and_fetch_equal_the_jax_package(streams, slope):
    js, ts = streams
    args = list(sweep_args(js))
    args[2] = slope
    np.testing.assert_array_equal(tsc.sweep_counts_streaming(ts, *args),
                                  jsc.sweep_counts_streaming(js, *args))
    for n_act in (None, 7):
        ti, tj, tidx, td0 = tsc.sweep_first_offsets(ts, *args,
                                                    _n_act=n_act)
        ji, jj, jidx, jd0 = jsc.sweep_first_offsets(js, *args,
                                                    _n_act=n_act)
        assert len(ti) > 0
        for got, want in ((ti, ji), (tj, jj), (tidx, jidx)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(td0, jd0, **FLOAT_TOL)


def test_fill_equals_the_jax_package_and_the_fetch(streams):
    js, ts = streams
    args = sweep_args(js)
    hi, hj, _, _ = tsc.sweep_first_offsets(ts, *args, _n_act=12)
    t_edges, t_cum = tsc.sweep_fill_device(ts, *args, n_act=12,
                                           e_total=len(hi))
    j_edges, j_cum = jsc.sweep_fill_device(js, *args, n_act=12,
                                           e_total=len(hi))
    np.testing.assert_array_equal(t_cum, j_cum)
    assert t_edges.count == j_edges.count == len(hi)
    got = set(zip(*[a.tolist() for a in t_edges.fetch_prefix(len(hi))]))
    assert got == set(zip(*[a.tolist() for a in
                            j_edges.fetch_prefix(len(hi))]))
    assert got == set(zip(hi.tolist(), hj.tolist()))


def test_a_fill_past_its_buffer_raises(streams, monkeypatch):
    _, ts = streams
    args = sweep_args(ts)
    hi, _, _, _ = tsc.sweep_first_offsets(ts, *args, _n_act=12)
    monkeypatch.setattr(sparse_sweep, "band_slots", lambda e: len(hi) - 1)
    with pytest.raises(tsc.SweepFillOverflow, match=f"{len(hi)} pairs"):
        tsc.sweep_fill_device(ts, *args, n_act=12, e_total=len(hi))


# --------------------------------------------------------------------------
# the bootstrap pass


def fill_spec(stream, n_act):
    scale, mean0, mean1 = geometry(stream)
    offsets = np.linspace(-1e-9, 0.8, 40)
    return dict(scale=scale, offsets=offsets, slope=2,
                line=(mean0[0], mean0[1], mean1[0], mean1[1]),
                n_act=n_act, e_total=2000)


def test_bootstrap_pass_equals_the_plain_pass_and_the_jax_package(
        pop, streams):
    js, ts = streams
    spec = fill_spec(js, 25)
    jb, tb = both(pop["planes"], pop["lengths"], pop["freqs"], knn=5,
                  n_real=pop["n"], defer=True)
    jb.run_pass1(spec)
    tb.run_pass1(spec)
    with pytest.raises(RuntimeError, match="already ran"):
        tb.run_pass1(spec)
    # the fused stats equal the plain pass's
    np.testing.assert_array_equal(tb.knn_col, ts.knn_col)
    np.testing.assert_array_equal(tb.knn_dist, ts.knn_dist)
    np.testing.assert_array_equal(tb.max_scale(), ts.max_scale())
    t_edges, t_cum, t_spec = tb.pop_prefill()
    j_edges, j_cum, _ = jb.pop_prefill()
    assert tb.pop_prefill() is None and t_spec["n_act"] == 25
    # the cum is the exact counts pass's, bit for bit, on the full grid;
    # against the JAX package's it differs only at offsets whose threshold
    # a pair's d0 meets within the distances' float32 noise
    args = (spec["scale"], spec["offsets"], 2, *spec["line"])
    np.testing.assert_array_equal(t_cum, tsc.sweep_counts_streaming(ts,
                                                                    *args))
    _, _, _, jd0 = jsc.sweep_first_offsets(js, *args)
    _, _, t = jsc._line_d0_params(spec["offsets"], 2, *spec["line"])
    near = np.array([(np.abs(jd0 - tv) <= 1e-4).sum() for tv in t])
    assert (np.abs(t_cum - j_cum) <= near).all()
    assert (t_cum == j_cum).mean() >= 0.95
    assert t_cum[-1] > t_cum[24] >= t_edges.count > 0
    assert t_edges.count == j_edges.count
    assert set(zip(*[a.tolist() for a in t_edges.fetch_prefix(
        t_edges.count)])) == set(zip(*[a.tolist() for a in
                                       j_edges.fetch_prefix(j_edges.count)]))


def test_bootstrap_overflow_keeps_the_stats_and_drops_the_prefill(
        pop, streams, monkeypatch):
    _, ts = streams
    spec = fill_spec(ts, 40)
    monkeypatch.setattr(sparse_sweep, "band_slots", lambda e: 8)
    tb = tsc.StreamingCondensed(pop["planes"], pop["lengths"], pop["freqs"],
                                KLIST, SS64, BBITS, chunk=CHUNK, knn=5,
                                n_real=pop["n"], defer=True)
    tb.run_pass1(spec)
    assert tb.pop_prefill() is None
    np.testing.assert_array_equal(tb.knn_col, ts.knn_col)


# --------------------------------------------------------------------------
# the refine


def start_fit(stream, pop):
    """The planted within / between means and a 20,000-pair subsample of
    the distances (the estimator's minimum is 10,000)."""
    scale = np.asarray(stream.max_scale(), np.float64)
    sub = stream.subsample_pairs(stream.n_pairs, seed=1)
    rng = np.random.default_rng(0)
    sub = sub[rng.integers(0, len(sub), 20000)]
    Xs = sub / scale
    close = Xs[:, 0] < 0.5 * Xs[:, 0].max()
    return scale, Xs[close].mean(axis=0), Xs[~close].mean(axis=0), sub


@pytest.mark.parametrize("slope", [2, 0, 1])
def test_refine_equals_the_jax_package(streams, pop, slope):
    js, ts = streams
    scale, mean0, mean1, sub = start_fit(js, pop)
    kw = dict(max_move=0.05, score_idx=0, seed=4, slope=slope)
    want = jsc.refine_fit_device(js, scale, mean0, mean1, **kw)
    got = tsc.refine_fit_device(ts, scale, mean0, mean1, **kw)
    assert got[3][0] == want[3][0] == "edges"
    np.testing.assert_allclose(got[:3], want[:3], **BOUNDARY_TOL)
    # with the subsample estimate instead of the exact counts pass
    est = tsc.refine_fit_device(ts, scale, mean0, mean1, est_pairs=sub,
                                **kw)
    np.testing.assert_allclose(est[:3], want[:3], **BOUNDARY_TOL)


def test_refine_with_the_prefill_equals_the_jax_package(streams, pop):
    js, ts = streams
    scale, mean0, mean1, sub = start_fit(js, pop)
    kw = dict(max_move=0.05, min_move=1e-9, max_sweep_fetch=40_000_000)
    spec = tsc.plan_sweep_band(ts, scale, mean0, mean1, est_pairs=sub, **kw)
    j_spec = jsc.plan_sweep_band(js, scale, mean0, mean1, est_pairs=sub,
                                 **kw)
    assert spec["n_act"] == j_spec["n_act"]
    assert spec["e_total"] == j_spec["e_total"]
    np.testing.assert_array_equal(spec["offsets"], j_spec["offsets"])
    jb, tb = both(pop["planes"], pop["lengths"], pop["freqs"], knn=5,
                  n_real=pop["n"], defer=True)
    jb.run_pass1(spec)
    tb.run_pass1(spec)
    rk = dict(max_move=0.05, score_idx=0, seed=4, est_pairs=sub)
    want = jsc.refine_fit_device(jb, scale, mean0, mean1,
                                 prefill=jb.pop_prefill(), **rk)
    got = tsc.refine_fit_device(tb, scale, mean0, mean1,
                                prefill=tb.pop_prefill(), **rk)
    np.testing.assert_allclose(got[:3], want[:3], **BOUNDARY_TOL)
    plain = tsc.refine_fit_device(ts, scale, mean0, mean1, **rk)
    np.testing.assert_allclose(got[:3], plain[:3], **BOUNDARY_TOL)


@pytest.mark.parametrize("score_idx", [1, 0])
def test_host_scorer_path_equals_the_jax_package(streams, pop, score_idx,
                                                 monkeypatch):
    """score_idx 1 takes the host scorer; score_idx 0 with the device
    sweep disabled does too."""
    js, ts = streams
    scale, mean0, mean1, _ = start_fit(js, pop)
    if score_idx == 0:
        monkeypatch.setenv("POPPUNK_TPU_SPARSE_SWEEP", "0")
    kw = dict(max_move=0.05, score_idx=score_idx, seed=4,
              betweenness_sample=1000)
    want = jsc.refine_fit_device(js, scale, mean0, mean1, **kw)
    got = tsc.refine_fit_device(ts, scale, mean0, mean1, **kw)
    assert got[3][0] == want[3][0] == "sparse"
    np.testing.assert_allclose(got[:3], want[:3], **BOUNDARY_TOL)


def test_fill_overflow_falls_back_to_exact_counts(streams, pop,
                                                  monkeypatch):
    js, ts = streams
    scale, mean0, mean1, sub = start_fit(js, pop)
    kw = dict(max_move=0.05, score_idx=0, seed=4)
    want = jsc.refine_fit_device(js, scale, mean0, mean1, **kw)
    real_fill = tsc.sweep_fill_device
    calls = []

    def exploding_fill(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise tsc.SweepFillOverflow("sweep fill overflow: forced")
        return real_fill(*args, **kwargs)

    monkeypatch.setattr(tsc, "sweep_fill_device", exploding_fill)
    timings = {}
    got = tsc.refine_fit_device(ts, scale, mean0, mean1, est_pairs=sub,
                                timings_out=timings, **kw)
    assert len(calls) == 2 and "counts" in timings
    np.testing.assert_allclose(got[:3], want[:3], **BOUNDARY_TOL)


# --------------------------------------------------------------------------
# the plain kernel version in the plane-major layout


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_plane_major_counts_equal_the_contiguous_ones(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device(device)
    planes, _, _, _ = planted(40, seed=2)
    pad_bits = plane_geometry(SS64, BBITS)[2]
    pm = planes_to_tensor(planes, dev)  # [K, P, n, Wp]
    gm = pm.permute(2, 0, 1, 3).contiguous()  # [n, K, P, Wp]
    want = mc.match_counts_torch(gm[5:21], gm, pad_bits)
    # a row slice of the resident tensor is a view: no copy
    view = pm[:, :, 5:21]
    assert view.data_ptr() == pm[:, :, 5:].data_ptr()
    for fn in (mc.match_counts_torch, mc.match_counts):
        got = fn(view, pm, pad_bits, plane_major=True)
        assert torch.equal(got, want)
    got = mc.match_counts_device(view, pm, pad_bits, plane_major=True)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="differ in K, P or Wp"):
        mc.match_counts(view, gm, pad_bits, plane_major=True)


def test_plane_major_stays_on_the_standard_kernel_under_packed(monkeypatch,
                                                               capsys):
    planes, _, _, _ = planted(24, seed=5)
    pad_bits = plane_geometry(SS64, BBITS)[2]
    pm = planes_to_tensor(planes, torch.device("cpu"))
    monkeypatch.setattr(mc, "KERNEL_CHOICE", "packed")
    monkeypatch.setattr(mc, "_PLANE_MAJOR_NOTE", [False])
    got = mc.match_counts_device(pm[:, :, :8], pm, pad_bits,
                                 plane_major=True)
    assert torch.equal(got, mc.match_counts_torch(pm[:, :, :8], pm, pad_bits,
                                                  plane_major=True))
    assert "stay on the standard kernel" in capsys.readouterr().err
