"""The plain reference of the streaming tier's pass 1, from the benchmark's
own inputs.

Plain PyTorch and numpy, importing nothing of the program: the distances
are ``reference.block_distances`` (PopPUNK's published definitions), and
what pass 1 derives from them is written here from its definitions.

    kNN           for a genome, the k other real genomes of least core
                  distance (self and pads excluded), ties to the lowest
                  index
    maxima        the largest core and accessory distance over the pairs
                  considered
    band          a pair is in the refine band when d0, its signed distance
                  to the boundary at the first offset of the refine's
                  search line, is at or below the threshold of the widest
                  active offset (t[n_act - 1])

The d0 line geometry is frozen here (as ``roofline.py`` froze its counts)
from upstream PopPUNK's boundary sweep, ``src/boundary.cpp`` (the
boundary's parameters along the search line, lines 171-184, and the signed
distance to it, lines 42-58), as ``poppunk_tpu_torch/scale.py``'s
``_line_d0_params`` and ``_d0_chunk`` apply it: the thresholds t[o] are the
first offset's signed distances of each offset's axis intercept, in
float32, made non-decreasing; d0 is taken in float64 here.

``precision`` ("float64", "tf32", "bfloat16") is the distances'
arithmetic, as in ``reference.py``; the controls take the lower two.
"""

import numpy as np
import torch

from . import reference


def boundary_params(offsets, slope, x0, y0, x1, y1):
    """Per-offset (x_max, y_max) along the line from (x0, y0) to (x1, y1)
    (boundary.cpp:171-184)."""
    dx, dy = x1 - x0, y1 - y0
    ds = np.sqrt(dx * dx + dy * dy)
    gradient = dy / dx
    offsets = np.asarray(offsets, dtype=np.float64)
    xi = x0 + offsets * (dx / ds)
    yi = y0 + offsets * (dy / ds)
    if slope == 2:
        return xi + yi * gradient, yi + xi / gradient
    if slope == 0:
        return xi, np.zeros_like(xi)
    return np.zeros_like(yi), yi


def line_dist(x, y, x_max, y_max, slope):
    """Signed distance of points (x, y) to the boundary through (x_max, 0)
    and (0, y_max) (boundary.cpp:42-58)."""
    if slope == 2:
        if x_max == 0 or y_max == 0:
            return np.sqrt(x * x + y * y)
        return y * x_max + x * y_max - x_max * y_max
    return x - x_max if slope == 0 else y - y_max


def band_geometry(spec):
    """(xm0, ym0, t_band) of a fill spec (scale, offsets, slope, line,
    n_act): the first offset's boundary and the widest active threshold,
    the thresholds built in float32 as the sweep builds them."""
    slope = int(spec["slope"])
    x_max, y_max = boundary_params(spec["offsets"], slope, *spec["line"])
    if slope == 1:
        x, y = np.zeros_like(y_max), y_max
    else:
        x, y = x_max, np.zeros_like(x_max)
    xm0, ym0 = float(x_max[0]), float(y_max[0])
    t = line_dist(x.astype(np.float32), y.astype(np.float32), xm0, ym0,
                  slope)
    t = np.maximum.accumulate(np.asarray(t, np.float32))
    return xm0, ym0, float(t[int(spec["n_act"]) - 1])


def d0(dists, spec):
    """float64 d0 of distances [..., 2] under a fill spec."""
    xm0, ym0, _ = band_geometry(spec)
    scale = np.asarray(spec["scale"], np.float64)
    x = np.asarray(dists[..., 0], np.float64) / scale[0]
    y = np.asarray(dists[..., 1], np.float64) / scale[1]
    return line_dist(x, y, xm0, ym0, int(spec["slope"]))


def d0_tolerance(spec, dist_tol):
    """The widest change of d0 that a change of ``dist_tol`` in each
    distance can make (d0 is linear in the scaled distances, or their
    norm when the boundary meets an axis at 0)."""
    xm0, ym0, _ = band_geometry(spec)
    scale = np.asarray(spec["scale"], np.float64)
    slope = int(spec["slope"])
    if slope == 2 and xm0 != 0 and ym0 != 0:
        return dist_tol * (abs(ym0) / scale[0] + abs(xm0) / scale[1])
    if slope == 2:
        return dist_tol * (1 / scale[0] + 1 / scale[1])
    return dist_tol / scale[0 if slope == 0 else 1]


def rows_distances(planes, lengths, freqs, rows, n_real, cfg,
                   precision="float64"):
    """float64 numpy [len(rows), n_real, 2]: the reference's (core,
    accessory) of genomes ``rows`` against every real genome. ``planes``
    is the genome-major int32 [n, K, P, Wp] tensor (pads past n_real
    ignored); lengths and freqs numpy."""
    idx = np.asarray(rows, np.int64)
    q = planes[torch.as_tensor(idx, device=planes.device)]
    return reference.block_distances(
        q, planes[:n_real], lengths[idx], lengths[:n_real], freqs[idx],
        freqs[:n_real], cfg, precision)


def nearest(d, rows, k, dist_col=0):
    """(ids int64 [m, k], distances float64 [m, k]): each row's k nearest
    other genomes by column ``dist_col``, ordered by (distance, index)."""
    col = np.array(d[..., dist_col], np.float64)
    col[np.arange(len(rows)), np.asarray(rows)] = np.inf  # self
    ids = np.argsort(col, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(col, ids, 1)


def maxima(d, rows):
    """[2] the largest core and accessory distance over the rows' pairs
    (self excluded)."""
    d = np.array(d, np.float64)
    d[np.arange(len(rows)), np.asarray(rows)] = -np.inf
    return d.reshape(-1, 2).max(axis=0)


def band(d, rows, spec, dist_tol):
    """(inside bool [m, n_real], near bool [m, n_real]): each row's pairs
    in the band (self excluded), and those whose d0 lies within the
    tolerance carried from ``dist_tol`` in distance of the band's edge,
    where the program's float32 arithmetic may fall either side."""
    _, _, t_band = band_geometry(spec)
    z = d0(d, spec)
    m = len(rows)
    inside = z <= t_band
    near = np.abs(z - t_band) <= d0_tolerance(spec, dist_tol)
    inside[np.arange(m), np.asarray(rows)] = False
    near[np.arange(m), np.asarray(rows)] = False
    return inside, near
