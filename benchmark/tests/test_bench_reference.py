"""The plain reference against hand computations on tiny inputs."""

import math

import numpy as np
import pytest
import torch

from benchmark import reference


def _bit(word, b):
    return (int(word) >> b) & 1


def test_match_counts_by_bin_signatures():
    rng = np.random.default_rng(7)
    K, P, w32 = 2, 3, 4
    q = rng.integers(-2 ** 31, 2 ** 31, (2, K, P, 128), dtype=np.int64)
    r = rng.integers(-2 ** 31, 2 ** 31, (3, K, P, 128), dtype=np.int64)
    r[0] = q[0]  # identical sketches
    r[1, :, :, :2] = q[1, :, :, :2]  # half the words shared
    q, r = q.astype(np.int32), r.astype(np.int32)
    got = reference.match_counts(
        reference.words64(torch.from_numpy(q), w32),
        reference.words64(torch.from_numpy(r), w32)).numpy()
    for i in range(2):
        for j in range(3):
            for k in range(K):
                want = sum(
                    all(_bit(q[i, k, p, w], b) == _bit(r[j, k, p, w], b)
                        for p in range(P))
                    for w in range(w32) for b in range(32))
                assert got[i, j, k] == want
    assert got[0, 0].tolist() == [32 * w32] * K


def _hand(counts, klist, lq, lr, fq, fr, ss64, bbits):
    """One pair, scalar float64, unconstrained fit by numpy's polyfit."""
    nbins, e = 64 * ss64, 2.0 ** -bbits
    ys = []
    for c, k in zip(counts, klist):
        jac = min(max((c / nbins - e) / (1 - e), 0.0), 1.0)
        p = sum(a * b for a, b in zip(fq, fr)) ** k + \
            sum(a * b for a, b in zip(fq, fr[::-1])) ** k
        n1, n2 = lq - k + 1, lr - k + 1
        inter = n1 * n2 * p
        r = min(inter / (n1 + n2 - inter), 1 - 1e-6)
        ys.append(math.log(min(max((jac - r) / (1 - r), 0.0), 1.0)))
    b1, b0 = np.polyfit(np.asarray(klist, float), ys, 1)
    return 1 - math.exp(b1), 1 - math.exp(b0)


def test_distances_match_a_hand_fit():
    klist, ss64, bbits = (13, 17, 21, 25), 156, 14
    counts = np.array([[[7000, 6500, 6100, 5700]]], np.int32)
    lq, lr = np.array([2_000_000]), np.array([2_100_000])
    fq = np.array([[0.3, 0.2, 0.2, 0.3]], np.float32)
    fr = np.array([[0.28, 0.22, 0.21, 0.29]], np.float32)
    got = reference.distances(torch.from_numpy(counts), klist, lq, lr, fq,
                              fr, ss64, bbits).numpy()[0, 0]
    want = _hand(counts[0, 0], klist, 2_000_000, 2_100_000,
                 fq[0].astype(float), fr[0].astype(float), ss64, bbits)
    assert got == pytest.approx(want, rel=1e-9)


def test_fit_on_the_box_faces():
    k = (10, 20)
    # log j rising with k: b1 > 0 leaves the box, b1 = 0 and b0 = mean
    j = torch.tensor([[0.5, 0.6]], dtype=torch.float64)
    core, acc = reference.kmer_fit(j, k)[0].tolist()
    assert core == pytest.approx(0.0)
    assert acc == pytest.approx(1 - math.exp((math.log(0.5)
                                              + math.log(0.6)) / 2))
    # fewer than two usable k: unrelated
    assert reference.kmer_fit(torch.tensor([[0.0, 0.4]],
                                           dtype=torch.float64),
                              k)[0].tolist() == [1.0, 1.0]


def test_lower_precisions_depart_from_float64():
    counts = torch.tensor([[[7000, 6500, 6100, 5700]]], dtype=torch.int32)
    args = ((13, 17, 21, 25), [2_000_000], [2_100_000],
            np.array([[0.3, 0.2, 0.2, 0.3]], np.float32),
            np.array([[0.28, 0.22, 0.21, 0.29]], np.float32), 156, 14)
    exact = reference.distances(counts, *args).double()
    for precision, least in (("tf32", 1e-6), ("bfloat16", 1e-4)):
        got = reference.distances(counts, *args, precision=precision)
        assert (got.double() - exact).abs().max() > least

