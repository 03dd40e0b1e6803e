"""Condensed (long-form) pair indexing.

The distance matrix for a self (all-vs-all) comparison of ``n`` samples is
stored condensed: ``n*(n-1)/2`` rows, row ``r`` holding the pair ``(i, j)``
with ``i < j`` ordered lexicographically — the same layout as the reference
(index math in ``src/boundary.cpp:22-37``, row iteration in
``PopPUNK/utils.py:199-226``).  Query-vs-reference comparisons are stored as
``q * n_ref + r`` rows (``PopPUNK/assign.py:690,704``).

Everything here is vectorised numpy (host) — these run at array-creation
time, never in the device hot loop.

Copied from ``poppunk_tpu/pairs.py``, whose counterpart it is: this package
imports nothing of the JAX package.
"""

import numpy as np


def n_pairs(n_samples: int) -> int:
    """Number of condensed rows for an all-vs-all comparison."""
    return n_samples * (n_samples - 1) // 2


def samples_from_rows(n_rows: int) -> int:
    """Inverse of :func:`n_pairs` (reference: src/boundary.cpp:18-20)."""
    n = int(round(0.5 * (1 + np.sqrt(1 + 8 * n_rows))))
    if n_pairs(n) != n_rows:
        raise ValueError(f"{n_rows} is not a valid condensed row count")
    return n


def condensed_to_pair(rows, n: int):
    """Vectorised condensed row index -> (i, j) with i < j.

    Matches ``calc_row_idx`` / ``calc_col_idx`` in src/boundary.cpp:22-31.
    """
    k = np.asarray(rows, dtype=np.int64)
    i = (
        n
        - 2
        - np.floor(np.sqrt((-8.0 * k + 4.0 * n * (n - 1) - 7).astype(np.float64)) / 2.0 - 0.5)
    ).astype(np.int64)
    j = k + i + 1 - n * (n - 1) // 2 + (n - i) * ((n - i) - 1) // 2
    return i, j


def pair_to_condensed(i, j, n: int):
    """Vectorised (i, j) with i < j -> condensed row index.

    Matches ``square_to_condensed`` in src/boundary.cpp:33-37.
    """
    i = np.asarray(i, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    if np.any(j <= i):
        raise ValueError("pair_to_condensed requires j > i")
    return n * i - ((i * (i + 1)) >> 1) + j - 1 - i


def all_pairs(n: int):
    """All (i, j), i < j, in condensed row order — vectorised."""
    idx = np.arange(n_pairs(n), dtype=np.int64)
    return condensed_to_pair(idx, n)


def condensed_to_square(vec, n: int, dtype=None):
    """Condensed vector -> symmetric n x n matrix with zero diagonal.

    Equivalent of ``pp_sketchlib.longToSquare`` (PopPUNK/utils.py:393).
    """
    vec = np.asarray(vec)
    out = np.zeros((n, n), dtype=dtype or vec.dtype)
    i, j = all_pairs(n)
    out[i, j] = vec
    out[j, i] = vec
    return out


def square_to_condensed_vec(mat):
    """Symmetric matrix -> condensed vector (pp_sketchlib.squareToLong)."""
    mat = np.asarray(mat)
    n = mat.shape[0]
    i, j = all_pairs(n)
    return mat[i, j]


def square_multi(rr_vec, qr_vec, qq_vec, n_ref: int, n_query: int, dtype=None):
    """Merge rr (condensed), qr (q*n_ref+r rows) and qq (condensed) vectors
    into one (n_ref+n_query) square matrix.

    Equivalent of ``pp_sketchlib.longToSquareMulti`` (PopPUNK/utils.py:398).
    """
    n = n_ref + n_query
    rr_vec = np.asarray(rr_vec)
    out = np.zeros((n, n), dtype=dtype or rr_vec.dtype)
    i, j = all_pairs(n_ref)
    out[i, j] = rr_vec
    out[j, i] = rr_vec
    if n_query > 0:
        qr = np.asarray(qr_vec).reshape(n_query, n_ref)
        out[n_ref:, :n_ref] = qr
        out[:n_ref, n_ref:] = qr.T
        if n_query > 1:
            qi, qj = all_pairs(n_query)
            qq = np.asarray(qq_vec)
            out[n_ref + qi, n_ref + qj] = qq
            out[n_ref + qj, n_ref + qi] = qq
    return out


def iter_dist_rows(ref_seqs, query_seqs, self=True):
    """Name pairs for each condensed row (PopPUNK/utils.py:199-226).

    Note the reference yields ``(refSeqs[j], ref_i)`` i.e. (larger-index name,
    smaller-index name) in self mode, and ``(ref, query)`` in query mode.
    """
    if self:
        if ref_seqs != query_seqs:
            raise RuntimeError("refSeqs must equal querySeqs for db building (self = true)")
        for i, ref in enumerate(ref_seqs):
            for j in range(i + 1, len(ref_seqs)):
                yield (ref_seqs[j], ref)
    else:
        for query in query_seqs:
            for ref in ref_seqs:
                yield (ref, query)
