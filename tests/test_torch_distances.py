"""The port's distance epilogue and distance engine
(poppunk_tpu_torch/ops/distances.py, ops/kmer_fit.py) against the JAX
package, on the CPU.

Tolerances, each with its reason:
- Jaccards: rtol 1e-6 / atol 1e-9, as tests/conformance/validate.py:95-98.
- random-corrected Jaccards: rtol 1e-6 / atol 1e-7. The random-match term
  r(k) is m**k of a 4-wide dot; the frameworks' pow and dot differ by an
  ulp, which k <= 29 raises to under 2e-6 relative in r, and r < 0.05 for
  genomes of 50 kbp and more (measured worst case 5.6e-8 absolute).
- core/accessory: rtol 1e-5 plus an absolute bound of 2e-5. The 2x2
  normal-equation sums cancel in ``det`` (kmer_fit.py:43) and the two
  frameworks sum, log and exp in different orders and precisions. Worst
  cases measured on 4 x 20,000 synthetic pairs (float32, CPU): port vs JAX
  1.3e-5 (accessory) and 1.9e-6 (core); against the float64 oracle the
  JAX package is off by up to 1.8e-5 and the port by up to 1.0e-5, so
  1e-5 would fail the reference itself.
"""

import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poppunk_tpu.ops import distances as jd
from poppunk_tpu.ops.kmer_fit import _fit_math as jax_fit_math
from poppunk_tpu.ops.kmer_fit import fit_kmer_curve_np as jax_oracle
from poppunk_tpu.sketch.minhash import SketchParams, sketch_sequence
from poppunk_tpu_torch.ops import distances as td
from poppunk_tpu_torch.ops.kmer_fit import _fit_math
from poppunk_tpu_torch.ops.kmer_fit import fit_kmer_curve_np

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, as a CPU-only host must."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


JACCARD_TOL = dict(rtol=1e-6, atol=1e-9)
CORRECTED_TOL = dict(rtol=1e-6, atol=1e-7)
DIST_TOL = dict(rtol=1e-5, atol=2e-5)
KLIST = (13, 17, 21, 25)


@pytest.fixture(scope="module")
def sketches(population):
    params = SketchParams(klist=KLIST, sketchsize64=32, bbits=14)
    return [sketch_sequence(name, codes, params)
            for name, codes in zip(population.names, population.genomes)]


def _epilogue_inputs(seed, nq=7, nr=11, ss64=32, bbits=14):
    rng = np.random.default_rng(seed)
    nbins = ss64 * 64
    matches = rng.integers(0, nbins + 1, (nq, nr, len(KLIST))).astype(np.int32)
    len_q = rng.integers(50_000, 3_000_000, nq).astype(np.int32)
    len_r = rng.integers(50_000, 3_000_000, nr).astype(np.int32)
    freq_q = rng.dirichlet(np.full(4, 8.0), nq).astype(np.float32)
    freq_r = rng.dirichlet(np.full(4, 8.0), nr).astype(np.float32)
    return matches, len_q, len_r, freq_q, freq_r


@pytest.mark.parametrize("random_correct,use_rc",
                         [(True, True), (True, False), (False, True)])
def test_corrected_jaccards_match_jax(random_correct, use_rc):
    args = _epilogue_inputs(1)
    want = jd.corrected_jaccards(*map(jnp.asarray, args[:1]), KLIST,
                                 *map(jnp.asarray, args[1:]), 32, 14,
                                 random_correct, use_rc)
    got = td.corrected_jaccards(*map(torch.as_tensor, args[:1]), KLIST,
                                *map(torch.as_tensor, args[1:]), 32, 14,
                                random_correct, use_rc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(CORRECTED_TOL if random_correct
                                  else JACCARD_TOL))


@pytest.mark.parametrize("k", KLIST)
def test_random_match_term_matches_jax(k):
    """rtol 1e-5: m**k raises a 1-ulp difference in the 4-wide dot to a
    k-ulp one (k <= 29 -> under 2e-6 relative)."""
    _, len_q, len_r, freq_q, freq_r = _epilogue_inputs(2)
    want = jd._random_jaccard_jnp(float(k), *map(jnp.asarray, (
        len_q, len_r, freq_q, freq_r)))
    got = td._random_jaccard(float(k), *map(torch.as_tensor, (
        len_q, len_r, freq_q, freq_r)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-12)


def _curve_jaccards(n=20_000, seed=3):
    """Jaccards of 20,000 synthetic pairs on pr(k) = (1-a)(1-c)^k with
    multiplicative noise and some zeros (masked ks / degenerate pairs)."""
    rng = np.random.default_rng(seed)
    k = np.asarray(KLIST + (29,), np.float64)
    a = rng.uniform(0.0, 0.9, n)[:, None]
    c = rng.uniform(0.0, 0.08, n)[:, None]
    j = (1 - a) * (1 - c) ** k * rng.lognormal(0.0, 0.05, (n, k.size))
    j[rng.random(j.shape) < 0.05] = 0.0
    return np.clip(j, 0.0, 1.0).astype(np.float32), k.astype(np.float32)


def test_fit_math_matches_jax():
    """Port vs JAX _fit_math on 20,000 pairs (worst cases: module
    docstring)."""
    j, k = _curve_jaccards()
    want = jax_fit_math(jnp, jnp.asarray(j), jnp.asarray(k))
    got = _fit_math(torch.as_tensor(j), torch.as_tensor(k))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **DIST_TOL)


def test_fit_math_matches_float64_oracle():
    """Both packages' float32 fits against the float64 oracle at the same
    bound; the port's float64 oracle equals the reference's."""
    j, k = _curve_jaccards(seed=4)
    oracle = jax_oracle(j, k)
    port = _fit_math(torch.as_tensor(j), torch.as_tensor(k))
    jax_fit = jax_fit_math(jnp, jnp.asarray(j), jnp.asarray(k))
    port64 = fit_kmer_curve_np(j, k)
    for i in range(2):
        np.testing.assert_allclose(port[i].numpy(), oracle[i], **DIST_TOL)
        np.testing.assert_allclose(np.asarray(jax_fit[i]), oracle[i],
                                   **DIST_TOL)
        np.testing.assert_allclose(port64[i], oracle[i], rtol=1e-12,
                                   atol=1e-12)


def _random_sketches(n, ss64, bbits, klist=KLIST, seed=0):
    """Sketch stand-ins of random full 64-bit words (high bits set)."""
    rng = np.random.default_rng(seed)
    return [types.SimpleNamespace(
        sketchsize64=ss64, bbits=bbits, length=int(rng.integers(1, 2**31)),
        base_freq=rng.dirichlet([1, 1, 1, 1]),
        usigs={k: rng.integers(0, 2**64, ss64 * bbits, dtype=np.uint64,
                               endpoint=False) for k in klist})
        for _ in range(n)]


# (genomes, sketchsize64, bbits, klist, pack_planes keywords, destination):
# None the population fixture's sketches; destination "filled" arrays of
# 0xFF bytes, "tensors" CPU tensors of them with int32 planes
PACK_CASES = {
    "population": (None, 32, 14, KLIST, {}, None),
    "one": (1, 32, 14, KLIST, {}, None),
    "odd": (7, 32, 14, KLIST, {}, None),
    "past_a_block": (td.PACK_BLOCK + 3, 32, 14, KLIST, {}, None),
    "no_wp_pad": (5, 64, 14, KLIST, {}, None),
    "bbits_1": (9, 32, 1, KLIST, {}, None),
    "klist_subset_reordered": (6, 32, 14, (25, 13), {}, None),
    "plane_major": (7, 32, 14, KLIST, dict(plane_major=True), None),
    "pad_to_even": (7, 32, 14, KLIST, dict(pad_to_even=True), None),
    "pad_to": (5, 32, 14, KLIST, dict(pad_to=8), None),
    "plane_major_pad_to_past_a_block": (
        td.PACK_BLOCK + 3, 64, 14, KLIST,
        dict(plane_major=True, pad_to=td.PACK_BLOCK + 8), None),
    "into_filled": (7, 32, 14, KLIST, {}, "filled"),
    "into_filled_plane_major_even": (
        7, 32, 1, (21, 17), dict(plane_major=True, pad_to_even=True),
        "filled"),
    "into_filled_tensors_past_a_block": (
        td.PACK_BLOCK + 1, 32, 14, KLIST, {}, "tensors"),
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_planes_matches_reference(request, case):
    """The port's host planes, lengths and frequencies equal the JAX
    package's bit for bit, whatever the destination held before."""
    n, ss64, bbits, klist, kw, dest = PACK_CASES[case]
    sketches = (request.getfixturevalue("sketches") if n is None
                else _random_sketches(n, ss64, bbits, KLIST, seed=n))
    want = jd.pack_planes(sketches, klist, **kw)
    out = None
    if dest is not None:
        out = [np.empty(w.shape, w.dtype) for w in want]
        for a in out:
            a.view(np.uint8)[...] = 0xFF
        if dest == "tensors":
            out[0] = out[0].view(np.int32)
            out = [torch.from_numpy(a) for a in out]
    got = td.pack_planes(sketches, klist, out=out, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if out is not None:  # written in place
        for g, o in zip(got, out):
            assert np.shares_memory(g, np.asarray(o))


def test_pack_planes_refuses_a_destination_of_another_shape():
    sketches = _random_sketches(3, 32, 14)
    planes, lengths, freqs = td.pack_planes(sketches, KLIST)
    with pytest.raises(ValueError, match="out"):
        td.pack_planes(sketches, KLIST, out=(planes[:2], lengths, freqs))
    with pytest.raises(ValueError, match="out"):
        td.pack_planes(sketches, KLIST,
                       out=(planes, lengths.astype(np.int64), freqs))


@pytest.mark.parametrize("jaccard", [True, False])
def test_query_db_self_mode_matches_jax(sketches, jaccard):
    tol = CORRECTED_TOL if jaccard else DIST_TOL
    got = td.query_db(sketches, None, KLIST, self_mode=True, jaccard=jaccard,
                      device=torch.device("cpu"))
    want = jd.query_db(sketches, None, KLIST, self_mode=True,
                       jaccard=jaccard, use_pallas=False)
    n = len(sketches)
    assert got.shape == (n * (n - 1) // 2, len(KLIST) if jaccard else 2)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


@pytest.mark.parametrize("jaccard", [True, False])
def test_query_db_query_mode_matches_jax(sketches, jaccard):
    """Row q * n_ref + r; chunk 4 exercises several query chunks."""
    tol = CORRECTED_TOL if jaccard else DIST_TOL
    refs, queries = sketches[:9], sketches[9:]
    got = td.query_db(refs, queries, KLIST, jaccard=jaccard)
    want = jd.query_db(refs, queries, KLIST, jaccard=jaccard,
                       use_pallas=False)
    assert got.shape[0] == len(refs) * len(queries)
    np.testing.assert_allclose(got, np.asarray(want), **tol)
    planes_r, len_r, freq_r = td.pack_planes(refs, KLIST)
    planes_q, len_q, freq_q = td.pack_planes(queries, KLIST)
    chunked = td.pairwise_block(planes_q, planes_r, len_q, len_r, freq_q,
                                freq_r, KLIST, 32, 14, jaccard=jaccard,
                                chunk=4)
    np.testing.assert_allclose(chunked.reshape(got.shape), got, **tol)


def test_condensed_chunks_agree(sketches):
    """Chunked condensed rows (each chunk against genomes from its own
    first row on) agree with the one-chunk result. Not bit for bit: BLAS
    picks its kernel by shape, so the random-match dots may round
    differently per chunking."""
    planes, lengths, freqs = td.pack_planes(sketches, KLIST)
    one = td.condensed_self_block(planes, lengths, freqs, KLIST, 32, 14)
    many = td.condensed_self_block(planes, lengths, freqs, KLIST, 32, 14,
                                   chunk=4)
    np.testing.assert_allclose(many, one, **DIST_TOL)


def test_frozen_conformance_vectors():
    """The production-geometry vectors of tests/conformance/expected.json
    (ss64 156, 14 planes, k = 13..28) at validate.py's own tolerances."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                    "conformance"))
    import validate
    from poppunk_tpu.pairs import iter_dist_rows

    exp = validate.load_expected()
    sk = validate.our_sketches(exp, use_native=True)
    klist = list(exp["klist"])
    j = td.query_db(sk, None, klist, self_mode=True, jaccard=True,
                    random_correct=False)
    d = td.query_db(sk, None, klist, self_mode=True, random_correct=False)
    rows = {(p["a"], p["b"]): p for p in exp["pairs"]}
    names = [s.name for s in sk]
    for row, (a, b) in enumerate(iter_dist_rows(names, names)):
        want = rows[(a, b)]
        np.testing.assert_allclose(
            j[row], [want["jaccard"][str(k)] for k in klist], **JACCARD_TOL)
        np.testing.assert_allclose(d[row], [want["core"], want["accessory"]],
                                   rtol=1e-5, atol=1e-8)
