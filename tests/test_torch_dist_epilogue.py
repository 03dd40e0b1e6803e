"""The distance epilogue (poppunk_tpu_torch/ops/distances.py::dist_epilogue,
csrc/dist_epilogue.cu): match counts -> corrected Jaccards -> (core,
accessory), against the JAX package and against the port's own torch
composition.

On the CPU the wrapper runs its plain version, dist_epilogue_torch, which
is the torch composition corrected_jaccards -> core_accessory: equal to it
bit for bit. The `cuda` tests hold the kernel to the plain version on the
card: Jaccards bit for bit, distances within DIST_TOL (rtol 1e-5, atol
2e-5), every pair's value independent of the tile it is computed in.

Both paths are held to the JAX package on the same numpy inputs. Two
float32 evaluations of the reference's formula need not agree to DIST_TOL:
the random-match correction divides by 1 - r, and the fit's normal
equations cancel at pairs with few usable k (most pairs of a block at
chance); the JAX package's own fit and the port's CPU fit differ there by
up to some 3e-4. So each value is held within the repo's tolerance or,
where that is less, within the rounding bound of two float32 evaluations
(hold_to_the_jax_package); the distances are also held to the float64
oracle on the same Jaccards (hold_to_the_oracle).

The inputs are made with numpy from a seed: counts spread from zero to
every bin, with three degenerate query rows (no bin matches, matches at
chance, identical genomes), short genomes and one-base compositions
beside bacterial lengths and Dirichlet frequencies; and a block like the
bench's, its unrelated pairs' counts drawn at chance.
"""

import json
import sys
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from poppunk_tpu.ops import distances as jd
from poppunk_tpu.ops import kmer_fit as jk
from poppunk_tpu_torch import _build
from poppunk_tpu_torch import scale as tsc
from poppunk_tpu_torch.ops import distances as td
from poppunk_tpu_torch.ops import match_counts as mc
from poppunk_tpu_torch.ops.kmer_fit import (fit_kmer_curve_np,
                                            fit_rounding_bound)

torch.set_num_threads(2)

DIST_TOL = dict(rtol=1e-5, atol=2e-5)
# the corrected Jaccards against the JAX package's (test_torch_distances.py)
JACCARD_TOL = dict(rtol=1e-6, atol=1e-9)
CORRECTED_TOL = dict(rtol=1e-6, atol=1e-7)
U32 = 2.0 ** -24
SS64, BBITS = 32, 14
# K 1, 5, 6 and 29 (cli/common.py::parse_kmers' widest list, 3..31); 8 and
# 9 on either side of the kernel's KMAX 8 instantiation, 32 its KMAX 32
# edge (k 32-34 past the squares a pair holds: the pow chain goes on)
KLISTS = {1: (17,), 5: (13, 17, 21, 25, 29), 6: (13, 16, 19, 22, 25, 28),
          8: tuple(range(13, 29, 2)), 9: tuple(range(13, 31, 2)),
          29: tuple(range(3, 32)), 32: tuple(range(3, 35))}
FLAGS = [(True, True), (True, False), (False, False)]


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's CPU tests ask for it."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


def epilogue_inputs(seed, nq, nr, K, ss64=SS64, bbits=BBITS):
    """(counts int32 [nq, nr, K], len_q, len_r int32, freq_q, freq_r f32
    [n, 4]) as numpy. Most pairs lie between chance and every bin, with
    fewer matches at longer k; query rows 0-2 are the degenerate rows (no
    bin matches; the chance count nbins / 2^bbits, rounded up; every bin
    matches), row 3 and column 3 short genomes, row and column 4 one base
    only."""
    rng = np.random.default_rng(seed)
    nbins = ss64 * 64
    chance = nbins / 2 ** bbits
    frac = rng.random((nq, nr, 1)) ** 3 * np.linspace(1.0, 0.5, K)
    counts = np.where(rng.random((nq, nr, 1)) < 0.8,
                      chance + frac * (nbins - chance),
                      rng.integers(0, nbins + 1, (nq, nr, K)))
    counts = counts.astype(np.int32)
    counts[0] = 0
    counts[1] = np.ceil(chance)
    counts[2] = nbins
    len_q = rng.integers(1_800_000, 2_400_000, nq).astype(np.int32)
    len_r = rng.integers(1_800_000, 2_400_000, nr).astype(np.int32)
    len_q[3], len_r[3] = 20, 10
    freq_q = rng.dirichlet(np.ones(4), nq).astype(np.float32)
    freq_r = rng.dirichlet(np.ones(4), nr).astype(np.float32)
    freq_q[4] = freq_r[4] = (1.0, 0.0, 0.0, 0.0)
    return counts, len_q, len_r, freq_q, freq_r


def as_tensors(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def composition(counts, klist, lq, lr, fq, fr, random_correct, use_rc,
                jaccard):
    """The torch composition _dist_chunk ran before the kernel."""
    j = td.corrected_jaccards(counts, klist, lq, lr, fq, fr, SS64, BBITS,
                              random_correct, use_rc)
    return j if jaccard else td.core_accessory(j, klist)


@pytest.mark.parametrize("jaccard", [False, True], ids=["dists", "jaccards"])
@pytest.mark.parametrize("random_correct,use_rc", FLAGS)
@pytest.mark.parametrize("K", sorted(KLISTS))
def test_cpu_equals_the_torch_composition(K, random_correct, use_rc,
                                          jaccard):
    klist = KLISTS[K]
    counts, lq, lr, fq, fr = as_tensors(epilogue_inputs(K, 9, 13, K))
    got = td.dist_epilogue(counts, klist, lq, lr, fq, fr, SS64, BBITS,
                           random_correct, use_rc, jaccard)
    want = composition(counts, klist, lq, lr, fq, fr, random_correct,
                       use_rc, jaccard)
    assert got.shape == (9, 13, K if jaccard else 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("jaccard", [False, True], ids=["dists", "jaccards"])
@pytest.mark.parametrize("random_correct,use_rc", FLAGS)
@pytest.mark.parametrize("K", sorted(KLISTS))
def test_cpu_equals_the_jax_package(K, random_correct, use_rc, jaccard):
    klist = KLISTS[K]
    arrays = epilogue_inputs(100 + K, 9, 13, K)
    got = td.dist_epilogue(*as_tensors(arrays[:1]), klist,
                           *as_tensors(arrays[1:]), SS64, BBITS,
                           random_correct, use_rc, jaccard)
    j = jd.corrected_jaccards(*map(jnp.asarray, arrays[:1]), klist,
                              *map(jnp.asarray, arrays[1:]), SS64, BBITS,
                              random_correct, use_rc)
    want = j if jaccard else jd.core_accessory(j, klist)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIST_TOL)
    if not jaccard:  # no bin matches: unrelated; identical: distance 0
        assert (got[0].numpy() == 1.0).all()
        assert (got[2].numpy() == (1.0 if K == 1 else 0.0)).all()


def test_cpu_writes_into_out():
    counts, lq, lr, fq, fr = as_tensors(epilogue_inputs(7, 6, 8, 5))
    out = torch.full((6, 8, 2), float("nan"))
    got = td.dist_epilogue(counts, KLISTS[5], lq, lr, fq, fr, SS64, BBITS,
                           out=out)
    assert got is out
    assert torch.equal(out, composition(counts, KLISTS[5], lq, lr, fq, fr,
                                        True, True, False))


def test_cpu_never_builds_and_counts_no_launch(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    before = td.EPILOGUE_LAUNCHES
    counts, lq, lr, fq, fr = as_tensors(epilogue_inputs(8, 5, 7, 6))
    for jaccard in (False, True):
        td.dist_epilogue(counts, KLISTS[6], lq, lr, fq, fr, SS64, BBITS,
                         jaccard=jaccard)
    assert td.EPILOGUE_LAUNCHES == before


def _bad_operands(counts, lq, lr, fq, fr):
    """(name, operands, error type) the wrapper must refuse."""
    yield "int64 counts", (counts.long(), lq, lr, fq, fr), TypeError
    yield "int64 lengths", (counts, lq.long(), lr, fq, fr), TypeError
    yield "float64 freqs", (counts, lq, lr, fq, fr.double()), TypeError
    yield "strided counts", (counts.transpose(0, 1).contiguous()
                             .transpose(0, 1), lq, lr, fq, fr), ValueError
    yield "strided freqs", (counts, lq, lr, fq.t().contiguous().t(), fr), \
        ValueError
    yield "short lengths", (counts, lq[:-1], lr, fq, fr), ValueError


@pytest.mark.parametrize("case", range(6))
def test_the_wrapper_refuses_what_the_kernel_cannot_take(case):
    counts, lq, lr, fq, fr = as_tensors(epilogue_inputs(9, 5, 7, 6))
    name, operands, error = list(_bad_operands(counts, lq, lr, fq, fr))[case]
    with pytest.raises(error):
        td.dist_epilogue(operands[0], KLISTS[6], *operands[1:], SS64, BBITS)


def test_the_wrapper_refuses_more_than_32_kmer_lengths():
    klist = tuple(range(3, 36))
    counts, lq, lr, fq, fr = as_tensors(epilogue_inputs(10, 6, 7,
                                                        len(klist)))
    with pytest.raises(ValueError, match="1 to 32"):
        td.dist_epilogue(counts, klist, lq, lr, fq, fr, SS64, BBITS)


def test_the_wrapper_refuses_a_mismatched_out():
    counts, lq, lr, fq, fr = as_tensors(epilogue_inputs(11, 6, 7, 6))
    with pytest.raises(ValueError, match="out"):
        td.dist_epilogue(counts, KLISTS[6], lq, lr, fq, fr, SS64, BBITS,
                         jaccard=True, out=torch.empty((6, 7, 2)))


# --------------------------------------------------------------------------
# the float64 pow chain of the random-match term (pow_f64, the kernel's too)

@pytest.mark.parametrize("k", [0, 1, 2])
def test_pow_f64_equals_torch_pow_at_k_0_1_2(k):
    """x ** 0 is 1, x ** 1 is x, and x * x is exact in float64, so rounded
    once it is torch's float32 x * x: bit for bit, at the edges too."""
    rng = np.random.default_rng(k)
    x = torch.as_tensor(np.concatenate([
        rng.random(4096), [0.0, 1.0, 1e-30, 0.5, 3.0, 1e20]]).astype(
            np.float32))
    got = td.pow_f64(x, k)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32),
                       torch.pow(x, k).view(torch.int32))


def _within_half_ulp_of_the_exact_power(x, k, got):
    """|got - x^k| <= half a float32 ulp + 1e-15 x^k, x^k exact (Fraction)."""
    exact = Fraction(float(x)) ** k
    ulp = Fraction(float(np.spacing(np.float32(float(exact)))))
    return abs(Fraction(float(got)) - exact) <= ulp / 2 + Fraction(
        1e-15) * exact


@settings(max_examples=300, deadline=None)
@given(x=st.floats(0.0, 1.0, width=32), k=st.integers(3, 31))
@example(x=0.0, k=3)
@example(x=1.0, k=31)
@example(x=float(np.nextafter(np.float32(1), np.float32(0))), k=31)
def test_pow_f64_is_within_half_an_ulp_of_the_exact_power(x, k):
    got = td.pow_f64(torch.tensor([x], dtype=torch.float32), k)[0]
    assert _within_half_ulp_of_the_exact_power(x, k, got)


@pytest.mark.parametrize("k", range(3, 32))
def test_pow_f64_at_every_k_of_parse_kmers(k):
    """256 draws in the range base-composition dots take, [0.15, 0.45], and
    256 in (0, 1): each within half an ulp (+ 1e-15 relative) of the exact
    power; no further from it than torch's float32 pow."""
    rng = np.random.default_rng(100 + k)
    x = np.concatenate([rng.uniform(0.15, 0.45, 256),
                        rng.random(256)]).astype(np.float32)
    got = td.pow_f64(torch.as_tensor(x), k).numpy()
    torch_pow = torch.pow(torch.as_tensor(x), float(k)).numpy()
    for xi, g, t in zip(x, got, torch_pow):
        assert _within_half_ulp_of_the_exact_power(xi, k, g), (xi, g)
        exact = Fraction(float(xi)) ** k
        assert abs(Fraction(float(g)) - exact) <= abs(
            Fraction(float(t)) - exact)


def test_pow_f64_refuses_a_fractional_or_negative_exponent():
    x = torch.rand(4)
    for k in (2.5, -1):
        with pytest.raises(ValueError, match="integer"):
            td.pow_f64(x, k)


def plane_major_operands(seed, n, K, ss64=8, bbits=4):
    """Plane-major planes [K, P, n, Wp] int32 with some shared words, and
    int32 lengths and f32 freqs, as tensors."""
    rng = np.random.default_rng(seed)
    w32, wp, pad_bits = td.plane_geometry(ss64, bbits)
    planes = np.zeros((K, bbits, n, wp), np.uint32)
    planes[..., :w32] = rng.integers(0, 2**32, (K, bbits, n, w32),
                                     dtype=np.uint32)
    planes[:, :, 1::2, :w32 // 2] = planes[:, :, 0:n - 1:2, :w32 // 2]
    lengths = rng.integers(1_800_000, 2_400_000, n).astype(np.int32)
    freqs = rng.dirichlet(np.ones(4), n).astype(np.float32)
    return (torch.from_numpy(planes.view(np.int32)),
            torch.as_tensor(lengths), torch.as_tensor(freqs), pad_bits)


def test_tile_dists_on_the_cpu_as_before():
    """scale._tile_dists over more than two _EPILOGUE_ROWS blocks equals
    the loop it ran before the kernel: the plain counts, then the torch
    composition 64 rows at a time."""
    klist, ss64, bbits = KLISTS[5], 8, 4
    planes, lengths, freqs, pad_bits = plane_major_operands(12, 150, 5)
    rows = torch.cat([torch.arange(0, 70), torch.arange(80, 150)])
    pq = planes[:, :, rows]
    got = tsc._tile_dists(pq, planes, lengths[rows], lengths, freqs[rows],
                          freqs, klist, ss64, bbits, pad_bits)
    counts = mc.match_counts_torch(pq, planes, pad_bits, plane_major=True)
    want = torch.empty_like(got)
    for a in range(0, rows.shape[0], 64):
        j = td.corrected_jaccards(counts[a:a + 64], klist,
                                  lengths[rows][a:a + 64], lengths,
                                  freqs[rows][a:a + 64], freqs, ss64, bbits)
        want[a:a + 64] = td.core_accessory(j, klist)
    assert torch.equal(got, want)


@pytest.mark.parametrize("jaccard", [False, True], ids=["dists", "jaccards"])
def test_dist_chunk_on_the_cpu_as_before(jaccard):
    klist, ss64, bbits = KLISTS[6], 8, 4
    planes, lengths, freqs, pad_bits = plane_major_operands(13, 40, 6)
    planes = planes.permute(2, 0, 1, 3).contiguous()  # [n, K, P, Wp]
    qry = (planes[:9], lengths[:9], freqs[:9])
    ref = (planes, lengths, freqs)
    got = td._dist_chunk(qry, ref, klist, ss64, bbits, True, True, jaccard)
    counts = mc.match_counts_torch(planes[:9], planes, pad_bits)
    j = td.corrected_jaccards(counts, klist, lengths[:9], lengths,
                              freqs[:9], freqs, ss64, bbits)
    assert torch.equal(got, j if jaccard else td.core_accessory(j, klist))


# --------------------------------------------------------------------------
# against the JAX package, where float32 decides the value and where not

def near_chance_inputs(seed, nq, nr, ss64=156, bbits=14, K=6):
    """A block like the bench's (sketch 9984, 14 planes, K 6): counts of
    unrelated pairs drawn at chance (a bin matches with probability
    2^-bbits), one pair in 16 related with a share of bins kept that falls
    with k; ~2 Mbp lengths, Dirichlet(1, 1, 1, 1) base frequencies."""
    rng = np.random.default_rng(seed)
    nbins = ss64 * 64
    counts = rng.binomial(nbins, 2.0 ** -bbits, (nq, nr, K))
    keep = rng.random((nq, nr, 1)) ** 0.5 * np.linspace(1.0, 0.6, K)
    related = (rng.random((nq, nr)) < 1 / 16)[..., None]
    counts = np.where(related, rng.binomial(nbins, keep), counts)
    len_q = rng.integers(1_800_000, 2_400_000, nq).astype(np.int32)
    len_r = rng.integers(1_800_000, 2_400_000, nr).astype(np.int32)
    freq_q = rng.dirichlet(np.ones(4), nq).astype(np.float32)
    freq_r = rng.dirichlet(np.ones(4), nr).astype(np.float32)
    return counts.astype(np.int32), len_q, len_r, freq_q, freq_r


def jaccard_rounding_bound(arrays, klist, ss64, bbits, random_correct,
                           use_rc, evaluations=2):
    """A first-order bound on the gap between ``evaluations`` float32
    evaluations of corrected_jaccards on the same inputs, float64 [nq, nr,
    K]. m / nbins and the b-bit correction round a few times; the random-
    match term dot^k carries k times dot's rounding, and (j - r) / (1 - r)
    divides the error of r by 1 - r, which reaches 1e-6 where r is clamped
    near 1 (short genomes, one-base compositions): there float32 does not
    determine the Jaccard."""
    counts, len_q, len_r, freq_q, freq_r = arrays
    u = evaluations * U32
    e = 2.0 ** -bbits
    jb = np.clip((counts / (ss64 * 64.0) - e) / (1 - e), 0.0, 1.0)
    djb = 3 * u * (jb + e)
    if not random_correct:
        return djb
    k = np.asarray(klist, np.float64)
    fq, fr = np.float64(freq_q), np.float64(freq_r)
    p = (fq @ fr.T)[..., None] ** k
    if use_rc:
        p = p + (fq @ fr[:, ::-1].T)[..., None] ** k
    n1 = np.maximum(np.float64(len_q)[:, None, None] - k + 1, 1.0)
    n2 = np.maximum(np.float64(len_r)[None, :, None] - k + 1, 1.0)
    inter = n1 * n2 * p
    union = n1 + n2 - inter
    r = np.where(union <= 0, 1.0, inter / np.maximum(union, 1e-30))
    clamped = r >= 1 - 1e-6
    r = np.clip(r, 0.0, 1 - 1e-6)
    # the 4-wide dot (4u), pow (k times the dot's and 2 ulp), the products
    dinter = (4 * k + 8) * u * inter
    dunion = u * (n1 + n2 + np.abs(union)) + dinter
    dr = np.where(clamped, 0.0,
                  r * (dinter / np.maximum(inter, 1e-300)
                       + dunion / np.maximum(np.abs(union), 1e-300) + u))
    j = np.clip((jb - r) / (1 - r), 0.0, 1.0)
    return ((djb + dr * (1 + j) + u * (np.abs(jb - r) + (1 - r) * j))
            / (1 - r) + u * j)


def hold_to_the_jax_package(jaccards, dists, arrays, klist, ss64, bbits,
                            random_correct, use_rc):
    """The port's Jaccards and (core, accessory) (numpy) against the JAX
    package's on the same numpy inputs. Each value is held within the
    repo's tolerance (CORRECTED_TOL or JACCARD_TOL; DIST_TOL), or, where
    that is less, within the rounding bound of two float32 evaluations
    (jaccard_rounding_bound; fit_rounding_bound, with the Jaccards' own
    difference carried through the fit): where float32 cannot decide a
    value to the tolerance, neither package is nearer the exact value than
    that. Returns a summary with the pair furthest beyond DIST_TOL."""
    jj = np.asarray(jd.corrected_jaccards(
        jnp.asarray(arrays[0]), klist, *map(jnp.asarray, arrays[1:]), ss64,
        bbits, random_correct, use_rc))
    jdist = np.asarray(jd.core_accessory(jnp.asarray(jj), klist))
    tol = CORRECTED_TOL if random_correct else JACCARD_TOL
    limit = np.maximum(
        tol["atol"] + tol["rtol"] * np.abs(jj),
        jaccard_rounding_bound(arrays, klist, ss64, bbits, random_correct,
                               use_rc))
    jerr = np.abs(jaccards - jj)
    assert (jerr <= limit).all(), np.argwhere(jerr > limit)[:5].tolist()
    dtol = DIST_TOL["atol"] + DIST_TOL["rtol"] * np.abs(jdist)
    bound = fit_rounding_bound(jaccards, klist, evaluations=2,
                               dj=np.float64(jaccards) - jj)
    err = np.abs(dists - jdist)
    beyond = err > dtol
    q, r = np.unravel_index((err - dtol).max(-1).argmax(), err.shape[:2])
    worst = {"pair": [int(q), int(r)], "port": dists[q, r].tolist(),
             "jax": jdist[q, r].tolist(), "bound": bound[q, r].tolist(),
             "counts": arrays[0][q, r].tolist(),
             "lengths": [int(arrays[1][q]), int(arrays[2][r])],
             "freq_q": arrays[3][q].tolist(), "freq_r": arrays[4][r].tolist()}
    assert (err <= np.maximum(dtol, bound)).all(), worst
    return {"values": int(err.size), "beyond_dist_tol": int(beyond.sum()),
            "undecided": int((bound > dtol).sum()),
            "max_abs_err": float(err.max()),
            "jaccard_max_abs_err": float(jerr.max()), "worst": worst}


def hold_to_the_oracle(jaccards, dists, klist):
    """(core, accessory) against the float64 oracle on the same float32
    Jaccards, within DIST_TOL or, where that is less, the one evaluation's
    fit_rounding_bound: a hold on no library's summation order. Returns
    (max |diff|, values beyond DIST_TOL)."""
    oracle = np.stack(fit_kmer_curve_np(jaccards, np.float32(klist)), -1)
    dtol = DIST_TOL["atol"] + DIST_TOL["rtol"] * np.abs(oracle)
    err = np.abs(dists - oracle)
    limit = np.maximum(dtol, fit_rounding_bound(jaccards, klist))
    assert (err <= limit).all(), np.argwhere(err > limit)[:5].tolist()
    return float(err.max()), int((err > dtol).sum())


@pytest.mark.parametrize("random_correct,use_rc", FLAGS)
@pytest.mark.parametrize("K", sorted(KLISTS))
def test_cpu_against_the_jax_package_at_a_ragged_shape(K, random_correct,
                                                       use_rc):
    """The CPU path at the cuda tests' 129 x 257 operands (it predates the
    kernel: these are the JAX package's own float32 gaps)."""
    klist = KLISTS[K]
    arrays = epilogue_inputs(200 + K, 129, 257, K)
    ops = as_tensors(arrays)
    jac, dists = (td.dist_epilogue(ops[0], klist, *ops[1:], SS64, BBITS,
                                   random_correct, use_rc, jaccard).numpy()
                  for jaccard in (True, False))
    hold_to_the_jax_package(jac, dists, arrays, klist, SS64, BBITS,
                            random_correct, use_rc)


def test_cpu_near_chance_block_against_the_jax_package():
    """128 x 512 pairs like the bench's: the CPU path against the JAX
    package. Some values differ by more than DIST_TOL (the summary
    printed), every one inside the two fits' rounding bound."""
    klist = KLISTS[6]
    arrays = near_chance_inputs(400, 128, 512)
    ops = as_tensors(arrays)
    jac, dists = (td.dist_epilogue(ops[0], klist, *ops[1:], 156, 14,
                                   jaccard=jaccard).numpy()
                  for jaccard in (True, False))
    summary = hold_to_the_jax_package(jac, dists, arrays, klist, 156, 14,
                                      True, True)
    print(json.dumps({"near_chance_cpu": summary}))


@pytest.mark.parametrize("source", ["near_chance", "ragged"])
def test_fit_rounding_bound_covers_both_packages_float32_fits(source):
    """Both packages' float32 fits of the same Jaccards land within
    DIST_TOL of the float64 oracle, or within fit_rounding_bound where that
    is more, and within the two evaluations' bound of each other."""
    klist = KLISTS[6]
    if source == "near_chance":
        arrays, geometry = near_chance_inputs(401, 96, 256), (156, 14)
    else:
        arrays, geometry = epilogue_inputs(206, 129, 257, 6), (SS64, BBITS)
    j = td.corrected_jaccards(*as_tensors(arrays[:1]), klist,
                              *as_tensors(arrays[1:]), *geometry).numpy()
    oracle = np.stack(jk.fit_kmer_curve_np(j, np.float32(klist)), -1)
    port = td.core_accessory(torch.as_tensor(j), klist).numpy()
    jax_fit = np.asarray(jd.core_accessory(jnp.asarray(j), klist))
    dtol = DIST_TOL["atol"] + DIST_TOL["rtol"] * np.abs(oracle)
    one = np.maximum(dtol, fit_rounding_bound(j, klist))
    assert (np.abs(port - oracle) <= one).all()
    assert (np.abs(jax_fit - oracle) <= one).all()
    two = np.maximum(dtol, fit_rounding_bound(j, klist, evaluations=2))
    assert (np.abs(port - jax_fit) <= two).all()


def test_fit_rounding_bound_stays_near_dist_tol_where_the_fit_is_well_posed():
    """Pairs with every k usable and Jaccards well above chance: the bound
    stays under DIST_TOL's limit at 95% of values and under 1.5 times it at
    all (the intercept, extrapolated from k 13 to 0, is the loosest), so
    there the hold is DIST_TOL's or near it; it is zero for a pair with
    fewer than two usable k."""
    klist = np.float32(KLISTS[6])
    rng = np.random.default_rng(5)
    a = rng.uniform(0.0, 0.5, (4096, 1))
    c = rng.uniform(0.0, 0.05, (4096, 1))
    j = np.float32((1 - a) * (1 - c) ** klist)
    oracle = np.stack(jk.fit_kmer_curve_np(j, klist), -1)
    share = fit_rounding_bound(j, klist) / (
        DIST_TOL["atol"] + DIST_TOL["rtol"] * np.abs(oracle))
    assert (share <= 1.0).mean() >= 0.95 and share.max() <= 1.5
    j[:, 1:] = 0.0
    assert (fit_rounding_bound(j, klist) == 0.0).all()


# --------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a card (it has no CPU mode)")
    from poppunk_tpu_torch import _device

    _device.set_full_precision()
    return torch.device("cuda", 0)


def worst_pairs(got, want, counts, lq, lr, fq, fr, n=3):
    """The pairs furthest apart, with their inputs, for a failure's
    message."""
    err = (got - want).abs().amax(dim=-1).flatten()
    out = []
    for flat in torch.topk(err, min(n, err.numel())).indices.tolist():
        q, r = divmod(flat, got.shape[1])
        out.append({"pair": (q, r), "got": got[q, r].tolist(),
                    "want": want[q, r].tolist(),
                    "counts": counts[q, r].tolist(), "len": (int(lq[q]),
                                                             int(lr[r])),
                    "freq_q": fq[q].tolist(), "freq_r": fr[r].tolist()})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("random_correct,use_rc", FLAGS)
@pytest.mark.parametrize("K", sorted(KLISTS))
def test_kernel_equals_the_plain_version(cuda_device, K, random_correct,
                                         use_rc):
    """Jaccards bit for bit, distances within DIST_TOL, at a ragged shape
    (129 x 257: neither a block of 256 nor a warp divides it)."""
    klist = KLISTS[K]
    ops = as_tensors(epilogue_inputs(200 + K, 129, 257, K), cuda_device)
    for jaccard in (True, False):
        before = td.EPILOGUE_LAUNCHES
        got = td.dist_epilogue(ops[0], klist, *ops[1:], SS64, BBITS,
                               random_correct, use_rc, jaccard)
        torch.cuda.synchronize()
        assert td.EPILOGUE_LAUNCHES == before + 1
        want = td.dist_epilogue_torch(ops[0], klist, *ops[1:], SS64, BBITS,
                                      random_correct, use_rc, jaccard)
        if jaccard:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            ok = torch.isclose(got, want, **DIST_TOL).all()
            assert ok, worst_pairs(got, want, *ops)


@pytest.mark.cuda
@pytest.mark.parametrize("random_correct,use_rc", FLAGS)
@pytest.mark.parametrize("K", sorted(KLISTS))
def test_kernel_against_the_jax_package_and_the_oracle(cuda_device, K,
                                                       random_correct,
                                                       use_rc):
    """The kernel's output, moved to the host, against the JAX package's
    on the same numpy inputs at 129 x 257 (hold_to_the_jax_package), and
    its distances against the float64 oracle on its own Jaccards."""
    klist = KLISTS[K]
    arrays = epilogue_inputs(200 + K, 129, 257, K)
    ops = as_tensors(arrays, cuda_device)
    jac, dists = (td.dist_epilogue(ops[0], klist, *ops[1:], SS64, BBITS,
                                   random_correct, use_rc,
                                   jaccard).cpu().numpy()
                  for jaccard in (True, False))
    hold_to_the_jax_package(jac, dists, arrays, klist, SS64, BBITS,
                            random_correct, use_rc)
    hold_to_the_oracle(jac, dists, klist)


@pytest.mark.cuda
def test_kernel_near_chance_block_against_the_jax_package(cuda_device):
    """512 x 1024 pairs like the bench's, most at chance: the kernel
    against the JAX package and against the float64 oracle; the summary
    (values beyond DIST_TOL, the worst pair) printed."""
    klist = KLISTS[6]
    arrays = near_chance_inputs(402, 512, 1024)
    ops = as_tensors(arrays, cuda_device)
    jac, dists = (td.dist_epilogue(ops[0], klist, *ops[1:], 156, 14,
                                   jaccard=jaccard).cpu().numpy()
                  for jaccard in (True, False))
    summary = hold_to_the_jax_package(jac, dists, arrays, klist, 156, 14,
                                      True, True)
    summary["oracle_max_abs_err"], summary["oracle_beyond_dist_tol"] = \
        hold_to_the_oracle(jac, dists, klist)
    print(json.dumps({"near_chance_kernel": summary}))


@pytest.mark.cuda
def test_kernel_values_do_not_depend_on_the_tile(cuda_device):
    """A pair's value in a 1 x 1 call and in a 64 x 128 block equals its
    value in the whole 300 x 700 call, bit for bit, in both modes."""
    klist = KLISTS[6]
    counts, lq, lr, fq, fr = as_tensors(epilogue_inputs(300, 300, 700, 6),
                                        cuda_device)
    q, r = 170, 555
    for jaccard in (False, True):
        whole = td.dist_epilogue(counts, klist, lq, lr, fq, fr, SS64, BBITS,
                                 jaccard=jaccard)
        for (q0, q1), (r0, r1) in (((q, q + 1), (r, r + 1)),
                                   ((q - 30, q + 34), (r - 100, r + 28))):
            part = td.dist_epilogue(
                counts[q0:q1, r0:r1].contiguous(), klist, lq[q0:q1],
                lr[r0:r1], fq[q0:q1], fr[r0:r1], SS64, BBITS,
                jaccard=jaccard)
            assert torch.equal(part.view(torch.int32),
                               whole[q0:q1, r0:r1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [6, 29])
def test_kernel_gives_each_pair_its_1x1_value(cuda_device, K):
    """Contract (c) pair by pair: at 13 x 260 (a block of 256 references
    and one of 4) every pair equals its value in a 1 x 1 call, bit for
    bit, in both modes."""
    klist = KLISTS[K]
    counts, lq, lr, fq, fr = as_tensors(epilogue_inputs(500 + K, 13, 260, K),
                                        cuda_device)
    for jaccard in (False, True):
        whole = td.dist_epilogue(counts, klist, lq, lr, fq, fr, SS64, BBITS,
                                 jaccard=jaccard)
        one = torch.empty_like(whole)
        for q in range(13):
            for r in range(260):
                one[q, r] = td.dist_epilogue(
                    counts[q:q + 1, r:r + 1].contiguous(), klist,
                    lq[q:q + 1], lr[r:r + 1], fq[q:q + 1], fr[r:r + 1],
                    SS64, BBITS, jaccard=jaccard)[0, 0]
        assert torch.equal(whole.view(torch.int32), one.view(torch.int32)), \
            jaccard


@pytest.mark.cuda
def test_kernel_walks_past_the_grid_limit(cuda_device):
    """More query rows than a grid holds in y (65,535): 524,289 query rows
    against 3 references; the blocks go on to the rows past it. Jaccards
    bit for bit against the plain version."""
    klist = KLISTS[6]
    nq, nr = 65535 * 8 + 9, 3
    rng = np.random.default_rng(16)
    counts = torch.as_tensor(rng.integers(0, SS64 * 64 + 1, (nq, nr, 6),
                                          dtype=np.int32), device=cuda_device)
    lq, lr = (torch.full((n,), 2_000_000, dtype=torch.int32,
                         device=cuda_device) for n in (nq, nr))
    fq, fr = (torch.full((n, 4), 0.25, device=cuda_device) for n in (nq, nr))
    got = td.dist_epilogue(counts, klist, lq, lr, fq, fr, SS64, BBITS,
                           jaccard=True)
    want = td.dist_epilogue_torch(counts, klist, lq, lr, fq, fr, SS64, BBITS,
                                  jaccard=True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_one_epilogue_launch_per_chunk_and_tile(cuda_device):
    klist, ss64, bbits = KLISTS[6], 8, 4
    planes, lengths, freqs, pad_bits = plane_major_operands(14, 96, 6)
    planes, lengths, freqs = (t.to(cuda_device)
                              for t in (planes, lengths, freqs))
    before = td.EPILOGUE_LAUNCHES
    tile = tsc._tile_dists(planes[:, :, :80], planes, lengths[:80], lengths,
                           freqs[:80], freqs, klist, ss64, bbits, pad_bits)
    assert td.EPILOGUE_LAUNCHES == before + 1
    genome_major = planes.permute(2, 0, 1, 3).contiguous()
    d = td._dist_chunk((genome_major[:80], lengths[:80], freqs[:80]),
                       (genome_major, lengths, freqs), klist, ss64, bbits,
                       True, True, False)
    torch.cuda.synchronize()
    assert td.EPILOGUE_LAUNCHES == before + 2
    assert torch.equal(d, tile)


@pytest.mark.cuda
def test_kernel_rejects_int64_lengths(cuda_device):
    counts, lq, lr, fq, fr = as_tensors(epilogue_inputs(15, 6, 7, 6),
                                        cuda_device)
    with pytest.raises(TypeError, match="int32"):
        td.dist_epilogue(counts, KLISTS[6], lq.long(), lr, fq, fr, SS64,
                         BBITS)


# --------------------------------------------------------------------------
# the build's ptxas report and phase B's reading of it

PTXAS = ("ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
         "ptxas info    : Function properties for {name}\n"
         "    {stack} bytes stack frame, {spill} bytes spill stores, "
         "{spill} bytes spill loads\n"
         "ptxas info    : Used {regs} registers, used 1 barriers, "
         "352 bytes cmem[0]\n")


def _entry(kmax, jaccard, stack=0, spill=0, regs=64):
    name = (f"_ZN12_GLOBAL__N_120dist_epilogue_kernelILi{kmax}ELb1ELb1ELb"
            f"{jaccard}EEEvNS_8OperandsENS_6ParamsE")
    return PTXAS.format(name=name, stack=stack, spill=spill, regs=regs)


def test_the_build_keeps_its_ptxas_report_beside_the_library(tmp_path,
                                                             monkeypatch):
    """A stand-in nvcc writes each object and a ptxas line per source on
    stderr; the report is the build's, and a later process that finds the
    library built reads the same report from beside it."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import os, sys\n"
        "args = sys.argv[1:]\n"
        "open(args[args.index('-o') + 1], 'w').write('')\n"
        "if '-c' in args:\n"
        "    sys.stderr.write('ptxas info : Compiling entry function '\n"
        "                     + repr(os.path.basename(args[-1])) + '\\n')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "ptxas_report", None)
    monkeypatch.setattr(_build, "build_seconds", None)
    path = _build.build()
    report = _build.ptxas_report
    assert "'dist_epilogue.cu'" in report and "'match_counts.cu'" in report
    assert _build.build_seconds is not None
    monkeypatch.setattr(_build, "ptxas_report", None)
    monkeypatch.setattr(_build, "build_seconds", None)
    assert _build.build() == path
    assert _build.ptxas_report == report and _build.build_seconds is None


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_phase_b_reads_each_epilogue_instantiation():
    """chip_smoke.py's reading of ptxas: each instantiation's registers,
    stack and spills by its template arguments; other kernels left out."""
    cs = _chip_smoke()
    report = (_entry(8, 0) + _entry(32, 1, stack=64, spill=8, regs=255)
              + PTXAS.format(name="_Z19match_counts_kernelv", stack=0,
                             spill=0, regs=202))
    assert cs.epilogue_instantiations(report) == {
        "KMAX 32 random 1 rc 1 jaccard 1": {
            "registers": 255, "stack": 64, "spill_stores": 8,
            "spill_loads": 8},
        "KMAX 8 random 1 rc 1 jaccard 0": {
            "registers": 64, "stack": 0, "spill_stores": 0,
            "spill_loads": 0}}


# --------------------------------------------------------------------------
# the bound chip_smoke.py reckons from the shapes

def test_epilogue_bound_counts_the_function_at_the_shapes():
    """The bytes (counts, lengths and frequencies in, the output out) at
    HBM rate against the epilogue_ops instructions at 128 an SM a clock
    and its special-function ones at 16: at 2048 x 4096 x K 6 on 132 SMs
    at 1980 MHz the instructions bind; at a hundredth of the clock too."""
    from poppunk_tpu_torch import bench

    assert bench.epilogue_ops(6) == (378, 48)
    assert bench.epilogue_ops(6, jaccard=True) == (194, 36)
    assert bench.epilogue_ops(6, False, False, True) == (36, 0)
    pairs = 2048 * 4096
    ms, by, reckoning = bench.epilogue_bound(2048, 4096, 6, 1980.0, sms=132)
    issue_ms = pairs * (378 + 48) / (128 * 132 * 1980e6) * 1e3
    sfu_ms = pairs * 48 / (16 * 132 * 1980e6) * 1e3
    bytes_ms = (pairs * (24 + 8) + 6144 * 20) / 3.35e12 * 1e3
    assert (by, ms) == ("operations", pytest.approx(issue_ms))
    assert reckoning["sfu_ms"] == pytest.approx(sfu_ms)
    assert reckoning["bytes_ms"] == pytest.approx(bytes_ms)
    ms, by, _ = bench.epilogue_bound(2048, 4096, 6, 3e6, sms=132)
    assert (by, ms) == ("bytes", pytest.approx(bytes_ms))
