"""The streaming tier's pass 1 (poppunk_tpu_torch/scale.py) against the
benchmark's plain reference of it (benchmark/stream_reference.py), on the
CPU at a small size.

The population: benchmark/population.py's planted strains, n_real 601
padded to 640 by the CLI's geometry (chunk 64: five folded chunks, 39 pads
masked by n_real), K 6, a shortened sketch (sketchsize64 4, b-bits 14).
The reference computes every real pair in float64; the program in float32.

Tolerance: TOL = 2e-5 on distances, the port's absolute float32 tolerance
on core/accessory distances (tests/test_torch_scale.py's FLOAT_TOL): the
float32 random-match dots and the fit's sums round differently from the
float64 reference, and 1 - e^slope loses the relative precision of
near-zero distances. Band membership is exact except for pairs whose d0
lies within the tolerance carried from TOL of the band's edge.
"""

import numpy as np
import pytest
import torch

from benchmark import population, stream_reference
from poppunk_tpu_torch import scale as tsc
from poppunk_tpu_torch.cli.scale import _pad_geometry

N_REAL = 601
CHUNK = 64
KLIST = (13, 16, 19, 22, 25, 28)
SS64 = 4
BBITS = 14
KNN = 5
TOL = 2e-5
POP = {"strains": 12, "strain_skew_alpha": 0.5, "tree_depth": 2,
       "strain_half_divergence": [0.016, 0.028],
       "strain_retention": [0.55, 0.85],
       "core_half_divergence": [0.0005, 0.003],
       "genome_retention": [0.8, 0.95],
       "genome_length": [2000000, 2200000],
       "base_composition": [0.3015, 0.1985, 0.1985, 0.3015],
       "base_concentration": 4000}
CFG = {"kmers": list(KLIST), "sketchsize64": SS64, "bbits": BBITS,
       "random_correct": True, "use_rc": True}


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        m.delenv("POPPUNK_TPU_SPARSE_SWEEP", raising=False)
        yield


@pytest.fixture(scope="module")
def pop():
    """Plane-major host planes padded as pack_planes lays them out, the
    strains, and the reference's distances of every real pair."""
    chunk, n_pad, mesh = _pad_geometry(N_REAL, CHUNK, 1, False,
                                       n_kmers=len(KLIST))
    assert (chunk, n_pad, mesh) == (CHUNK, 640, None)
    rng = np.random.default_rng(5)
    sizes = population.strain_sizes(rng, N_REAL, POP["strains"], 0.5)
    strain = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    planes, lengths, freqs = population.draw(
        strain, len(sizes), POP, KLIST, SS64, BBITS, 17, torch.device("cpu"))
    K, P, wp = planes.shape[1:]
    pm = torch.zeros((K, P, n_pad, wp), dtype=torch.int32)
    pm[:, :, :N_REAL] = planes.permute(1, 2, 0, 3)
    len_pad = np.full(n_pad, 2_000_000, np.int32)
    len_pad[:N_REAL] = lengths
    freq_pad = np.full((n_pad, 4), 0.25, np.float32)
    freq_pad[:N_REAL] = freqs
    rows = np.arange(N_REAL)
    ref = stream_reference.rows_distances(planes, lengths, freqs, rows,
                                          N_REAL, CFG)
    return dict(planes=pm.numpy().view(np.uint32), lengths=len_pad,
                freqs=freq_pad, strain=strain, rows=rows, ref=ref,
                n_pad=n_pad)


def spec(pop, n_act):
    """A refine fill spec from the reference's distances: the scale is the
    column maxima, the line runs from the within-strain mean to the
    between-strain mean (the planted strains), as a fitted start model's
    would."""
    ref, strain = pop["ref"], pop["strain"]
    iu = np.triu_indices(N_REAL, 1)
    d = ref[iu]
    scale = d.max(axis=0)
    within = strain[iu[0]] == strain[iu[1]]
    m0, m1 = d[within].mean(axis=0) / scale, d[~within].mean(axis=0) / scale
    return dict(scale=scale, offsets=np.linspace(0.0, 0.8, 40), slope=2,
                line=(m0[0], m0[1], m1[0], m1[1]), n_act=n_act,
                e_total=N_REAL * N_REAL)


CASES = {"plain": None, "band10": 10, "band25": 25, "band40": 40}


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request, pop):
    n_act = CASES[request.param]
    fill = None if n_act is None else spec(pop, n_act)
    cd = tsc.StreamingCondensed(pop["planes"], pop["lengths"], pop["freqs"],
                                KLIST, SS64, BBITS, chunk=CHUNK, knn=KNN,
                                dist_col=0, n_real=N_REAL, defer=True,
                                device=torch.device("cpu"), mesh=None,
                                shard_planes="auto")
    cd.run_pass1(fill)
    return dict(cd=cd, fill=fill, prefill=cd.pop_prefill())


def test_knn_equals_the_reference(run, pop):
    cd, rows = run["cd"], pop["rows"]
    want_ids, want = stream_reference.nearest(pop["ref"], rows, KNN)
    assert cd.knn_col.shape == (N_REAL, KNN)
    np.testing.assert_allclose(cd.knn_dist, want, rtol=0, atol=TOL)
    for r in rows:
        got = cd.knn_col[r]
        assert len(set(got.tolist())) == KNN
        assert (got != r).all() and (got < N_REAL).all()
        # a neighbour other than the reference's only on a tie within TOL
        for j in set(got.tolist()) ^ set(want_ids[r].tolist()):
            assert abs(pop["ref"][r, j, 0] - want[r, -1]) <= TOL


def test_maxima_equal_the_reference(run, pop):
    want = stream_reference.maxima(pop["ref"], pop["rows"])
    np.testing.assert_allclose(run["cd"].max_scale(), want, rtol=0,
                               atol=TOL)


def test_band_edges_equal_the_reference(run, pop):
    if run["fill"] is None:
        assert run["prefill"] is None
        return
    edges, cum, spec_out = run["prefill"]
    assert spec_out["n_act"] == run["fill"]["n_act"]
    n_act = run["fill"]["n_act"]
    # the exact histogram at the widest active offset counts the band
    assert cum.shape == (40,) and cum[n_act - 1] == edges.count
    assert (np.diff(cum) >= 0).all()
    i, j = (a.astype(np.int64) for a in edges.fetch_prefix(edges.count))
    assert (i < j).all() and (j < N_REAL).all()
    held = np.zeros((N_REAL, N_REAL), bool)
    held[i, j] = True
    assert held.sum() == edges.count  # each pair once
    held |= held.T
    inside, near = stream_reference.band(pop["ref"], pop["rows"],
                                         run["fill"], TOL)
    assert ((held != inside) & ~near).sum() == 0
    assert 0 < edges.count < N_REAL * (N_REAL - 1) // 2 or n_act == 40
