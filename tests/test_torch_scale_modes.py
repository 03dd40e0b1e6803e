"""The scale tier's other modes against the JAX package's, on the CPU.

The unconstrained 2-D sweep (exact per-cell counts, the union fetch,
refine_fit_device_2d), multi_refine_device's boundary files, the
fixed-boundary fetch of --use-model and the streaming distance QC of
--run-qc, on tests/test_torch_scale.py's planted populations (even n, and
odd n padded to the chunk grid), through poppunk_tpu.scale (JAX on the
CPU, use_pallas=False) and poppunk_tpu_torch.scale.

Tolerances, as tests/test_torch_scale.py's: integer outputs (counts, the
fetched (i, j), QC flags) exact; fetched coordinates within FLOAT_TOL;
refined boundaries within BOUNDARY_TOL; the boundary files byte for byte.
The ``cuda`` tests hold each pass on the card to the same pass on the CPU.
"""

import os

import numpy as np
import pytest
import torch

import poppunk_tpu.scale as jsc
import poppunk_tpu_torch.scale as tsc
from poppunk_tpu_torch.ops.distances import planes_to_tensor
from test_torch_scale import (BBITS, BOUNDARY_TOL, FLOAT_TOL, KLIST, SS64,
                              on_the_cpu, pop, start_fit,  # noqa: F401
                              streams)

torch.set_num_threads(2)

X_GRID = np.linspace(0.05, 0.6, 7).astype(np.float32)
Y_GRID = np.linspace(0.08, 0.7, 6).astype(np.float32)
CAPS = {
    "full": np.full(len(Y_GRID), X_GRID[-1], np.float32),
    # rows 1 and 4 disabled, the others capped at different widths
    "ragged": np.array([0.3, 0.0, 0.6, 0.45, -1.0, 0.2], np.float32),
}
QC_CUTS = (0.005, 0.25)  # max_pi, max_a: between-strain pairs fail


def scale_of(stream):
    return np.asarray(stream.max_scale(), np.float64)


@pytest.fixture(scope="module")
def means(streams, pop):
    """The planted within / between means of the scaled distances."""
    return start_fit(streams[0], pop)[1:3]


def pass_args(pop, chunk=8):
    return (pop["planes"], pop["lengths"], pop["freqs"], KLIST, SS64, BBITS,
            chunk, pop["n"])


# --------------------------------------------------------------------------
# the 2-D sweep


def test_sweep2d_counts_equal_the_jax_package(streams):
    js, ts = streams
    scale = scale_of(js)
    got = tsc.sweep2d_counts_streaming(ts, scale, X_GRID, Y_GRID)
    want = jsc.sweep2d_counts_streaming(js, scale, X_GRID, Y_GRID)
    assert got.dtype == np.int64 and got.shape == (len(Y_GRID), len(X_GRID))
    np.testing.assert_array_equal(got, want)
    # the cells nest; the widest is neither empty nor every pair
    assert (np.diff(got, axis=0) >= 0).all() and (np.diff(got, axis=1) >=
                                                   0).all()
    assert 0 < got[-1, -1] < ts.n_pairs


@pytest.mark.parametrize("caps", sorted(CAPS))
def test_sweep2d_fetch_equals_the_jax_package(streams, caps):
    js, ts = streams
    scale = scale_of(js)
    ti, tj, tx, ty = tsc.sweep2d_fetch_streaming(ts, scale, CAPS[caps],
                                                 Y_GRID)
    ji, jj, jx, jy = jsc.sweep2d_fetch_streaming(js, scale, CAPS[caps],
                                                 Y_GRID)
    assert len(ti) > 0 and ti.dtype == tj.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tj, jj)
    np.testing.assert_allclose(tx, jx, **FLOAT_TOL)
    np.testing.assert_allclose(ty, jy, **FLOAT_TOL)
    # every fetched pair lies inside some enabled row's boundary
    inside = np.zeros(len(ti), bool)
    for xm, ym in zip(CAPS[caps], Y_GRID):
        if xm > 0:
            inside |= tsc.inside_2d_host(tx, ty, xm, ym)
    assert inside.all()


@pytest.fixture(scope="module")
def refined_2d(streams, means):
    js, ts = streams
    scale = scale_of(js)
    kw = dict(max_move=0.05, score_idx=0, seed=4)
    return (jsc.refine_fit_device_2d(js, scale, *means, **kw),
            tsc.refine_fit_device_2d(ts, scale, *means, **kw))


def test_refine_2d_equals_the_jax_package(refined_2d):
    want, got = refined_2d
    np.testing.assert_allclose(got[:2], want[:2], **BOUNDARY_TOL)
    assert got[0] > 0 and got[1] > 0
    assert got[2][0] == want[2][0] == "sparse2d"
    for a, b in zip(got[2][1:3], want[2][1:3]):
        np.testing.assert_array_equal(a, b)
    # the network at the optimum (cli/scale.py's sparse2d arm)
    masks = [tsc.inside_2d_host(*sweep[3:], *xy)
             for *xy, sweep in (got, want)]
    np.testing.assert_array_equal(*masks)
    assert masks[0].any()


@pytest.mark.parametrize("cap", [0, 1200])
def test_refine_2d_past_its_cap_is_saturated(streams, means, cap):
    """No scoreable cell (cap 0): both packages raise SweepSaturated; a
    cap inside the grid's range (its cells hold ~800-1800 pairs) scores the
    cells above it as 1 and refines over the rest."""
    js, ts = streams
    scale = scale_of(js)
    kw = dict(max_move=0.05, seed=4, max_sweep_fetch=cap, no_local=True)
    if cap == 0:
        for sc, cd in ((jsc, js), (tsc, ts)):
            with pytest.raises(sc.SweepSaturated, match="tightest 2-D cell"):
                sc.refine_fit_device_2d(cd, scale, *means, **kw)
        return
    want = jsc.refine_fit_device_2d(js, scale, *means, **kw)
    got = tsc.refine_fit_device_2d(ts, scale, *means, **kw)
    np.testing.assert_allclose(got[:2], want[:2], **BOUNDARY_TOL)
    np.testing.assert_array_equal(got[2][1], want[2][1])
    np.testing.assert_array_equal(got[2][2], want[2][2])


# --------------------------------------------------------------------------
# --multi-boundary


def boundary_files(out):
    return sorted(f for f in os.listdir(out) if "_boundary" in f)


def test_multi_refine_writes_the_jax_packages_files(streams, means,
                                                    tmp_path):
    js, ts = streams
    scale = scale_of(js)
    outs = {}
    for name, sc, cd in (("jax", jsc, js), ("torch", tsc, ts)):
        outs[name] = str(tmp_path / name / "multi")
        os.makedirs(outs[name])
        sc.multi_refine_device(cd, scale, *means, 0.3, 4, outs[name],
                               [f"g{k}" for k in range(cd.n)])
    names = boundary_files(outs["jax"])
    assert names and boundary_files(outs["torch"]) == names
    for name in names:
        with open(os.path.join(outs["torch"], name), "rb") as a, \
                open(os.path.join(outs["jax"], name), "rb") as b:
            assert a.read() == b.read(), name
    with pytest.raises(RuntimeError, match="max_sweep_fetch 3"):
        tsc.multi_refine_device(ts, scale, *means, 0.3, 4, outs["torch"],
                                [], max_sweep_fetch=3)


# --------------------------------------------------------------------------
# --use-model: the fixed-boundary fetch


BOUNDARIES = {0: (0.4, 0.0), 1: (0.0, 0.5), 2: (0.4, 0.5)}


@pytest.mark.parametrize("slope", sorted(BOUNDARIES))
def test_fetch_within_boundary_equals_the_jax_package(pop, streams, slope):
    scale = scale_of(streams[0])
    bx, by = BOUNDARIES[slope]
    args = pass_args(pop) + (scale, bx, by, slope)
    want = jsc.fetch_within_boundary(*args, use_pallas=False)
    got = tsc.fetch_within_boundary(*args)
    assert len(got[0]) > 0 and got[0].dtype == np.int32
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # from an int32 tensor already on its device, at another chunk
    resident = planes_to_tensor(pop["planes"], torch.device("cpu"))
    args = (resident,) + pass_args(pop, chunk=16)[1:] + (scale, bx, by,
                                                         slope)
    for a, b in zip(tsc.fetch_within_boundary(*args), want):
        np.testing.assert_array_equal(a, b)


def test_fetch_within_boundary_raises_past_max_fetch(pop, streams):
    args = pass_args(pop) + (scale_of(streams[0]), 0.4, 0.5, 2)
    n = len(tsc.fetch_within_boundary(*args)[0])
    assert len(tsc.fetch_within_boundary(*args, max_fetch=n)[0]) == n
    with pytest.raises(RuntimeError, match=f"more than {n - 1} pairs fall"):
        tsc.fetch_within_boundary(*args, max_fetch=n - 1)


# --------------------------------------------------------------------------
# --run-qc: the streaming distance QC


@pytest.mark.parametrize("check_zero", [True, False])
def test_qc_bad_pairs_equal_the_jax_package(pop, check_zero):
    args = pass_args(pop) + QC_CUTS
    want = jsc.qc_bad_pairs_streaming(*args, use_pallas=False,
                                      check_zero=check_zero)
    got = tsc.qc_bad_pairs_streaming(*args, check_zero=check_zero)
    assert got[2].dtype == np.uint8 and ((got[2] & 1) > 0).any()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # condensed order, pads never flagged; the planted copies are zero pairs
    i, j, flags = got
    assert (np.lexsort((j, i)) == np.arange(len(i))).all()
    assert (j < pop["n"]).all() and (i < j).all()
    zero = set(zip(i[(flags & 2) > 0].tolist(), j[(flags & 2) > 0].tolist()))
    if check_zero:
        assert set(pop["ties"]) <= zero
    else:
        assert not zero


def test_qc_bad_pairs_raise_past_max_fetch(pop):
    args = pass_args(pop) + QC_CUTS
    n = len(tsc.qc_bad_pairs_streaming(*args)[0])
    with pytest.raises(RuntimeError, match=f"more than {n - 1} pairs fail"):
        tsc.qc_bad_pairs_streaming(*args, max_fetch=n - 1)


# --------------------------------------------------------------------------
# each pass on the card against the same pass on the CPU


CARD_PASSES = ("sweep2d", "boundary", "qc", "multi_boundary")


@pytest.mark.cuda
@pytest.mark.parametrize("which", CARD_PASSES)
def test_the_pass_on_the_card_equals_the_cpu(pop, streams, means, which,
                                            tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, ts = streams
    scale = scale_of(ts)
    card = tsc.StreamingCondensed(
        pop["planes"], pop["lengths"], pop["freqs"], KLIST, SS64, BBITS,
        chunk=8, knn=5, n_real=pop["n"], device=torch.device("cuda"))
    if which == "sweep2d":
        np.testing.assert_array_equal(
            tsc.sweep2d_counts_streaming(card, scale, X_GRID, Y_GRID),
            tsc.sweep2d_counts_streaming(ts, scale, X_GRID, Y_GRID))
        got = tsc.sweep2d_fetch_streaming(card, scale, CAPS["ragged"],
                                          Y_GRID)
        want = tsc.sweep2d_fetch_streaming(ts, scale, CAPS["ragged"], Y_GRID)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[2], want[2], **FLOAT_TOL)
    elif which == "boundary":
        for slope, (bx, by) in BOUNDARIES.items():
            args = pass_args(pop) + (scale, bx, by, slope)
            got = tsc.fetch_within_boundary(*args,
                                            device=torch.device("cuda"))
            for a, b in zip(got, tsc.fetch_within_boundary(*args)):
                np.testing.assert_array_equal(a, b)
    elif which == "qc":
        args = pass_args(pop) + QC_CUTS
        got = tsc.qc_bad_pairs_streaming(*args, device=torch.device("cuda"))
        for a, b in zip(got, tsc.qc_bad_pairs_streaming(*args)):
            np.testing.assert_array_equal(a, b)
    else:
        names = [f"g{k}" for k in range(ts.n)]
        outs = {name: tmp_path / name / "multi" for name in ("card", "cpu")}
        for name, cd in (("card", card), ("cpu", ts)):
            os.makedirs(outs[name])
            tsc.multi_refine_device(cd, scale, *means, 0.3, 4,
                                    str(outs[name]), names)
        files = boundary_files(outs["cpu"])
        assert files and boundary_files(outs["card"]) == files
        for f in files:
            assert (outs["card"] / f).read_bytes() == \
                (outs["cpu"] / f).read_bytes()
