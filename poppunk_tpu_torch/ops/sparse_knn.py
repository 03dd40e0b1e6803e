"""Sparse kNN ops for lineage fits.

NumPy equivalents of the reference's native src/extend.cpp, replicating its
exact semantics (including quirks):

- get_knn_distances (extend.cpp:248-289): per-row kNN of a square distance
  matrix, self excluded, stable sort order.
- lower_rank (extend.cpp:147-246): reduce a kNN structure to rank k. In the
  plain mode the size check happens *before* appending, so each row keeps
  k+1 entries (faithful to the C++); with count_unique_distances, entries
  are kept while the running count of epsilon-distinct values is <= k; with
  reciprocal_only, only pairs present in both directions are kept.
- extend (extend.cpp:52-137): merge an existing reference kNN structure
  with new query-ref and query-query dense blocks into a combined kNN of
  the same depth — the streaming-growth path behind --update-db for
  lineage models. Ties prefer the query-side list (the C++ merge's <=).

Copied from ``poppunk_tpu/ops/sparse_knn.py``, whose counterpart it is:
this package imports nothing of the JAX package.
"""

import numpy as np


def get_knn_distances(dist_mat, knn, exclude_self=None):
    """(row, col, data): kNN per row. Self (column i of row i) is excluded
    for square matrices; rectangular matrices (e.g. the query-vs-ref block
    in --stable assignment, PopPUNK/assign.py:681) have no self column."""
    dist_mat = np.asarray(dist_mat)
    n, m = dist_mat.shape
    if exclude_self is None:
        exclude_self = n == m
    knn = min(knn, m - 1 if exclude_self else m)
    rows = np.repeat(np.arange(n, dtype=np.int64), knn)
    cols = np.empty(n * knn, dtype=np.int64)
    data = np.empty(n * knn, dtype=dist_mat.dtype)
    for i in range(n):
        order = np.argsort(dist_mat[i], kind="stable")
        if exclude_self:
            order = order[order != i]
        order = order[:knn]
        cols[i * knn : (i + 1) * knn] = order
        data[i * knn : (i + 1) * knn] = dist_mat[i][order]
    return rows, cols, data


def knn_from_condensed(condensed, n, knn, chunk=2048):
    """(row, col, data): kNN per sample straight from a condensed i<j
    distance vector — never materialises the n x n square (80 GB at 1e5
    genomes; this is O(chunk * n)). Output is identical to
    ``get_knn_distances(condensed_to_square(condensed, n), knn)``.
    """
    condensed = np.asarray(condensed)
    knn = min(knn, n - 1)
    rows_out = np.repeat(np.arange(n, dtype=np.int64), knn)
    cols_out = np.empty(n * knn, dtype=np.int64)
    data_out = np.empty(n * knn, dtype=condensed.dtype)
    # condensed index of pair (i<j): i*n - i(i+1)/2 + (j-i-1)
    offsets = np.arange(n, dtype=np.int64) * n \
        - (np.arange(n, dtype=np.int64) * (np.arange(n, dtype=np.int64) + 1)) // 2
    j_all = np.arange(n, dtype=np.int64)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        i_idx = np.arange(start, stop, dtype=np.int64)[:, None]  # [c,1]
        lo = np.minimum(i_idx, j_all[None, :])
        hi = np.maximum(i_idx, j_all[None, :])
        flat = offsets[lo] + (hi - lo - 1)
        block = condensed[np.clip(flat, 0, condensed.shape[0] - 1)]
        block = np.where(i_idx == j_all[None, :], np.inf, block)
        if n > 4 * knn + 64:
            # argpartition prunes each row to ~4k candidates before the
            # stable sort (an O(n) scan instead of O(n log n)); exact ties
            # straddling the candidate boundary could order differently,
            # which only matters for epsilon-identical distances
            cand = np.argpartition(block, min(4 * knn, n - 1),
                                   axis=1)[:, :4 * knn]
            cand.sort(axis=1)  # restore column order for stable ties
            cand_vals = np.take_along_axis(block, cand, axis=1)
            sub_order = np.argsort(cand_vals, axis=1, kind="stable")[:, :knn]
            order = np.take_along_axis(cand, sub_order, axis=1)
        else:
            order = np.argsort(block, axis=1, kind="stable")[:, :knn]
        sl = slice(start * knn, stop * knn)
        cols_out[sl] = order.ravel()
        data_out[sl] = np.take_along_axis(block, order, axis=1).ravel()
    return rows_out, cols_out, data_out


def _rows_to_lists(row, col, data, n_samples):
    """Group a row-sorted COO structure by row."""
    row = np.asarray(row)
    col = np.asarray(col)
    data = np.asarray(data)
    order = np.argsort(row, kind="stable")
    row, col, data = row[order], col[order], data[order]
    starts = np.searchsorted(row, np.arange(n_samples + 1))
    return row, col, data, starts


def lower_rank(sparse_rr, n_samples, knn, reciprocal_only=False,
               count_unique_distances=False, epsilon=1e-10):
    """Reduce rank of a kNN COO structure (extend.cpp:147-246)."""
    row, col, data = sparse_rr
    _, col, data, starts = _rows_to_lists(row, col, data, n_samples)

    i_out, j_out, d_out = [], [], []
    per_row_j = [[] for _ in range(n_samples)]
    per_row_d = [[] for _ in range(n_samples)]
    for i in range(n_samples):
        cj = col[starts[i] : starts[i + 1]]
        cd = data[starts[i] : starts[i + 1]]
        if cj.shape[0] == 0:
            continue
        order = np.argsort(cd, kind="stable")
        unique_neighbors = 0
        prev_value = 0.0
        for idx in order:
            j = int(cj[idx])
            dist = float(cd[idx])
            if j == i:
                continue
            if count_unique_distances:
                if abs(dist - prev_value) >= epsilon:
                    unique_neighbors += 1
                    prev_value = dist
            else:
                unique_neighbors = len(per_row_j[i])
            if unique_neighbors <= knn:
                per_row_j[i].append(j)
                per_row_d[i].append(dist)
            else:
                break

    if reciprocal_only:
        pairs = set()
        for i in range(n_samples):
            for j in per_row_j[i]:
                if i > j:
                    pairs.add((i, j))
        for i in range(n_samples):
            keep_j, keep_d = [], []
            for j, dist in zip(per_row_j[i], per_row_d[i]):
                if i < j and (j, i) in pairs:
                    keep_j.append(j)
                    keep_d.append(dist)
            per_row_j[i], per_row_d[i] = keep_j, keep_d

    for i in range(n_samples):
        i_out.extend([i] * len(per_row_j[i]))
        j_out.extend(per_row_j[i])
        d_out.extend(per_row_d[i])
    return (
        np.array(i_out, dtype=np.int64),
        np.array(j_out, dtype=np.int64),
        np.array(d_out, dtype=np.float32),
    )


def extend(sparse_rr, qq_square, qr_rect, knn):
    """Merge rr kNN + dense qr/qq blocks -> combined kNN (extend.cpp:52-137).

    qr_rect: [n_ref, n_query] (ref rows, query cols, the reference's
    transposed rectangle, models.py:1363).
    """
    qr_rect = np.asarray(qr_rect)
    qq_square = np.asarray(qq_square)
    nr = qr_rect.shape[0]
    nq = qr_rect.shape[1]
    row, col, data = sparse_rr
    _, rcol, rdata, starts = _rows_to_lists(row, col, data, nr)

    i_out, j_out, d_out = [], [], []
    for i in range(nr + nq):
        if i < nr:
            qr_dists = qr_rect[i]  # distances to queries; j = idx + nr
            rr_dists = rdata[starts[i] : starts[i + 1]]
            rr_js = rcol[starts[i] : starts[i + 1]]
        else:
            rr_dists = qr_rect[:, i - nr]  # distances to refs; j = idx
            rr_js = np.arange(nr)
            qr_dists = qq_square[i - nr]  # distances to queries

        qr_order = np.argsort(qr_dists, kind="stable")
        rr_order = np.argsort(rr_dists, kind="stable")
        qi = ri = 0
        count = 0
        while (qi < qr_order.shape[0] or ri < rr_order.shape[0]) and count < knn:
            take_qr = ri >= rr_order.shape[0] or (
                qi < qr_order.shape[0]
                and qr_dists[qr_order[qi]] <= rr_dists[rr_order[ri]]
            )
            if take_qr:
                j = int(qr_order[qi]) + nr
                dist = float(qr_dists[qr_order[qi]])
                qi += 1
            else:
                j = int(rr_js[rr_order[ri]])
                dist = float(rr_dists[rr_order[ri]])
                ri += 1
            if j == i:
                continue
            i_out.append(i)
            j_out.append(j)
            d_out.append(dist)
            count += 1
    return (
        np.array(i_out, dtype=np.int64),
        np.array(j_out, dtype=np.int64),
        np.array(d_out, dtype=np.float32),
    )
