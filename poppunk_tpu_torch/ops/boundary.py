"""Boundary assignment and sweep ops.

Vectorised (numpy host / jnp device) equivalents of the reference's native
poppunk_refine module (src/boundary.cpp):

- line_dist / assign_threshold  (boundary.cpp:42-80)
- edge_iterate                  (boundary.cpp:82-95)
- generate_tuples / generate_all_tuples (boundary.cpp:97-150)
- threshold_iterate_1d          (boundary.cpp:154-210) — the sort-once
  boundary sweep: each pair's signed boundary distance is computed once,
  pairs sorted by it (stable, ties by index like boost's
  parallel_stable_sort over row order), then each grid offset emits the
  prefix of pairs inside its boundary.
- threshold_iterate_2d          (boundary.cpp:212-237)

These feed both the host refine path and the all-grid-points-parallel
device scoring (models/refine.py).

Copied from ``poppunk_tpu/ops/boundary.py``, whose counterpart it is: this
package imports nothing of the JAX package.
"""

import numpy as np

from ..pairs import all_pairs, condensed_to_pair, samples_from_rows


def line_dist(X, x_max, y_max, slope):
    """Signed unnormalised distance of points to the boundary
    (boundary.cpp:42-58). X: [..., 2]."""
    x0 = X[..., 0]
    y0 = X[..., 1]
    if slope == 2:
        if x_max == 0 or y_max == 0:
            return np.sqrt(x0 * x0 + y0 * y0)
        return y0 * x_max + x0 * y_max - x_max * y_max
    elif slope == 0:
        return x0 - x_max
    elif slope == 1:
        return y0 - y_max
    raise ValueError("slope must be 0, 1 or 2")


def assign_threshold(X, slope, x_max, y_max):
    """Sign (-1/0/+1) of each condensed row vs the boundary
    (boundary.cpp:60-80). Within-strain (inside boundary) rows are -1."""
    d = line_dist(np.asarray(X), x_max, y_max, slope)
    return np.sign(d).astype(np.int32)


def edge_iterate(X, slope, x_max, y_max):
    """(i, j) edges for condensed rows inside the boundary
    (boundary.cpp:82-95)."""
    X = np.asarray(X)
    n = samples_from_rows(X.shape[0])
    inside = line_dist(X, x_max, y_max, slope) <= 0
    rows = np.flatnonzero(inside)
    i, j = condensed_to_pair(rows, n)
    return np.stack([i, j], axis=1)


def generate_tuples(assignments, within_label, self=True, num_ref=0, int_offset=0):
    """Assignment vector -> edge array (boundary.cpp:97-123).

    self: condensed i<j layout; else row = q * num_ref + r with query nodes
    offset by num_ref.
    """
    assignments = np.asarray(assignments)
    rows = np.flatnonzero(assignments == within_label)
    if self:
        n = samples_from_rows(assignments.shape[0])
        i, j = condensed_to_pair(rows, n)
        i = i + int_offset
        j = j + int_offset
    else:
        i = rows % num_ref + int_offset
        j = rows // num_ref + num_ref + int_offset
    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    return np.stack([lo, hi], axis=1)


def generate_all_tuples(num_ref, num_queries=0, self=True, int_offset=0):
    """All pairs as edges (boundary.cpp:125-150)."""
    if self:
        i, j = all_pairs(num_ref)
        return np.stack([i + int_offset, j + int_offset], axis=1)
    q = np.repeat(np.arange(num_queries), num_ref)
    r = np.tile(np.arange(num_ref), num_queries)
    return np.stack([q, r + num_ref], axis=1)


def _boundary_params(offsets, slope, x0, y0, x1, y1):
    """Per-offset (x_max, y_max) along the search line
    (boundary.cpp:171-184)."""
    dx = x1 - x0
    dy = y1 - y0
    ds = np.sqrt(dx * dx + dy * dy)
    gradient = dy / dx
    offsets = np.asarray(offsets, dtype=np.float64)
    xi = x0 + offsets * (dx / ds)
    yi = y0 + offsets * (dy / ds)
    if slope == 2:
        x_max = xi + yi * gradient
        y_max = yi + xi / gradient
    elif slope == 0:
        x_max = xi
        y_max = np.zeros_like(xi)
    else:
        x_max = np.zeros_like(yi)
        y_max = yi
    return x_max, y_max


def threshold_iterate_1d(X, offsets, slope, x0, y0, x1, y1):
    """Boundary sweep (boundary.cpp:154-210).

    Returns (i_vec, j_vec, offset_idx) where each pair appears once, at the
    first offset whose boundary contains it; output ordered by the sweep
    (sorted by signed distance at the first offset, ties by row index).
    """
    X = np.asarray(X, dtype=np.float32)
    n = samples_from_rows(X.shape[0])
    x_max, y_max = _boundary_params(offsets, slope, x0, y0, x1, y1)

    d0 = line_dist(X, float(x_max[0]), float(y_max[0]), slope)
    order = np.argsort(d0, kind="stable")

    i_vec, j_vec, offset_idx = [], [], []
    sorted_idx = 0
    for offset_nr in range(len(offsets)):
        if sorted_idx >= order.shape[0]:
            break
        d = line_dist(
            X[order[sorted_idx:]], float(x_max[offset_nr]), float(y_max[offset_nr]), slope
        )
        # pairs are in d0 order; emit while inside this boundary (the
        # reference's while loop stops at the first outside pair)
        inside = d <= 0
        stop = inside.shape[0] if inside.all() else int(np.argmin(inside))
        take = order[sorted_idx : sorted_idx + stop]
        if take.size:
            i, j = condensed_to_pair(take, n)
            i_vec.append(i)
            j_vec.append(j)
            offset_idx.append(np.full(take.shape[0], offset_nr, dtype=np.int64))
            sorted_idx += take.size
    if i_vec:
        return (
            np.concatenate(i_vec),
            np.concatenate(j_vec),
            np.concatenate(offset_idx),
        )
    return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64))


def threshold_iterate_1d_fast(X, offsets, slope, x0, y0, x1, y1):
    """Sort-free 1-D sweep for huge pair counts.

    The 1-D search translates a fixed-normal boundary, so every offset's
    signed distance is d0 - t_off for a scalar t_off — each pair's first
    active offset is a searchsorted over the 40 thresholds instead of a
    global argsort of all P pairs (the O(P log P) the reference's
    boost::parallel_stable_sort pays, src/boundary.cpp:154-210). Output
    set {(i, j, first_offset)} matches threshold_iterate_1d up to float
    rounding at boundary-grazing pairs; ordering within an offset differs
    (irrelevant to the union-find/device scoring).
    """
    X = np.asarray(X, dtype=np.float32)
    n = samples_from_rows(X.shape[0])
    x_max, y_max = _boundary_params(offsets, slope, x0, y0, x1, y1)

    d0 = line_dist(X, float(x_max[0]), float(y_max[0]), slope)
    # threshold for offset o = the d0 value of a point ON that offset's
    # boundary (pair active at o iff d0(pair) <= t[o]); exact whatever the
    # per-offset normalisation of line_dist does
    if slope == 1:
        boundary_points = np.stack(
            [np.zeros_like(y_max), y_max], axis=1).astype(np.float32)
    else:
        boundary_points = np.stack(
            [x_max, np.zeros_like(x_max)], axis=1).astype(np.float32)
    t = line_dist(boundary_points, float(x_max[0]), float(y_max[0]), slope)
    # thresholds must be non-decreasing (boundary moves outward)
    t = np.maximum.accumulate(t)
    idx = np.searchsorted(t, d0, side="left")
    active = idx < len(offsets)
    rows = np.flatnonzero(active)
    i, j = condensed_to_pair(rows, n)
    return i, j, idx[rows].astype(np.int64)


# Above this many pairs the faithful sorted sweep's argsort dominates; the
# sort-free path takes over.
FAST_SWEEP_MIN_PAIRS = 5_000_000


def threshold_iterate_1d_auto(X, offsets, slope, x0, y0, x1, y1):
    if np.asarray(X).shape[0] >= FAST_SWEEP_MIN_PAIRS:
        return threshold_iterate_1d_fast(X, offsets, slope, x0, y0, x1, y1)
    return threshold_iterate_1d(X, offsets, slope, x0, y0, x1, y1)


def threshold_iterate_2d(X, x_max_list, y_max):
    """2-D sweep at fixed y_max over increasing x_max (boundary.cpp:212-237)."""
    X = np.asarray(X, dtype=np.float32)
    n = samples_from_rows(X.shape[0])
    i_vec, j_vec, offset_idx = [], [], []
    prev_inside = np.zeros(X.shape[0], dtype=bool)
    for offset_nr, x_max in enumerate(x_max_list):
        inside = line_dist(X, float(x_max), float(y_max), 2) <= 0
        new = inside & ~prev_inside
        rows = np.flatnonzero(new)
        if rows.size:
            i, j = condensed_to_pair(rows, n)
            i_vec.append(i)
            j_vec.append(j)
            offset_idx.append(np.full(rows.shape[0], offset_nr, dtype=np.int64))
        prev_inside = prev_inside | inside
    if i_vec:
        return (
            np.concatenate(i_vec),
            np.concatenate(j_vec),
            np.concatenate(offset_idx),
        )
    return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64))
