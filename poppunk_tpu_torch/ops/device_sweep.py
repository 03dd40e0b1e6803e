"""Refine boundary sweep scored on the model device.

Counterpart of poppunk_tpu/ops/device_sweep.py (growNetwork,
PopPUNK/refine.py:375-474, for score_idx 0): for each boundary offset t
the edges active at t make a dense float32 adjacency A on the device, and
the network's score is

    -(transitivity * (1 - density)),
    transitivity = 6 * triangles / (2 * wedges) = sum(A * (A @ A)) / sum(d (d - 1))

from one [n, n] product (A * A@A summed gives 6 * triangles; no A^3). The
reference rebuilds A per offset inside a scan; edges only ever switch on
along the sweep, so here one A is carried and each offset scatters only
its newly active edges. Peak memory is two [n, n] float32 buffers (A and
its product) and one float64 row block of the product while it is summed
(_SQUARE_ROWS rows: 0.54 GB at n = 32768).

``A @ A`` is ``torch.matmul`` with TF32 off (``_device.set_full_precision``):
its entries and the degrees are exact in float32 (< 2^24 for n <= 32768).
The aggregates are taken in float64 (``network_score``, which the scale
tier's dense sweep shares), so unlike the reference's float32 tree sums
(its ~1e-6 relative error past 2^24, device_sweep.py:22-27) they stay
exact there too.

The sweep runs for n <= 32768 vertices on a CUDA model device; the host
native sweep (network/incremental.py) takes every other case, as the
reference gates its device sweep on a non-CPU backend.
"""

import numpy as np
import torch

# Above this vertex count the dense [n, n] buffers exceed sensible device
# memory (n = 32768 -> 4.3 GB each); the host sweep takes over.
DEVICE_SWEEP_MAX_N = 32768

# float32 accumulations are exact only below 2^24
F32_EXACT = float(2 ** 24)

# rows of the [n, n] product summed at a time: torch widens a float32 tensor
# to float64 with a full copy before it sums it, so the widened copy is one
# block (8 * _SQUARE_ROWS * n bytes), never the whole square (8 n^2)
_SQUARE_ROWS = 2048


def sweep_scores_device(n_vertices, i_vec, j_vec, idx_vec, n_offsets,
                        device):
    """-(score) float64 [n_offsets] on ``device``, matching
    grow_network_scores with score_idx 0. Edge e joins i_vec[e] and
    j_vec[e] from offset idx_vec[e] on; an idx past the sweep never
    activates."""
    if len(i_vec) == 0:
        # the host twin's empty-network score: transitivity 0 -> -0.0
        return np.zeros(n_offsets)
    n = int(n_vertices)
    idx = np.asarray(idx_vec, dtype=np.int64)
    order = np.argsort(idx, kind="stable")
    # edges active at offset t: the sorted prefix with idx <= t
    ends = np.searchsorted(idx[order], np.arange(n_offsets), side="right")
    as_dev = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, dtype=np.int64)[order], device=device)
    iv, jv = as_dev(i_vec), as_dev(j_vec)
    A = torch.zeros((n, n), dtype=torch.float32, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    scores = []
    for t in range(n_offsets):
        new = slice(int(ends[t - 1]) if t else 0, int(ends[t]))
        A.index_put_((iv[new], jv[new]), one)  # duplicate-safe: set, not add
        A.index_put_((jv[new], iv[new]), one)
        scores.append(network_score(A.sum(dim=1), _paths(A), n))
    return torch.stack(scores).cpu().numpy()


def _paths(A):
    """sum(A * (A @ A)) = 6 * triangles, a float64 0-d tensor. Each block
    of _SQUARE_ROWS rows is summed in float64: its entries are exact
    integers, so the total is exact whatever the order, where a float32
    sum of a dense row could pass 2^24."""
    prod = (A @ A).mul_(A)
    paths = torch.zeros((), dtype=torch.float64, device=A.device)
    for s in range(0, A.shape[0], _SQUARE_ROWS):
        paths += prod[s:s + _SQUARE_ROWS].sum(dtype=torch.float64)
    return paths


def network_score(deg, paths, n):
    """-(transitivity * (1 - density)), a float64 scalar tensor, from the
    exact vertex degrees [n] and paths = sum(A * (A @ A)) = 6 * triangles
    of a graph on n vertices. Every aggregate is taken in float64 from the
    exact integer counts."""
    deg = deg.to(torch.float64)
    n_edges = deg.sum() / 2.0
    wedges2 = (deg * (deg - 1.0)).sum()  # 2 * wedges
    paths = paths.to(torch.float64)
    transitivity = torch.where(wedges2 > 0, paths / wedges2.clamp(min=1.0),
                               torch.zeros_like(paths))
    return -(transitivity * (1.0 - n_edges / (0.5 * n * (n - 1))))


def counts_f32_exact(i_vec, j_vec, n_vertices):
    """True iff the final graph's aggregate counts (2 * edges,
    sum deg (deg - 1) >= 6 * triangles) are exactly representable in
    float32: the widest offset activates every edge, so this bounds every
    offset. The float64 aggregates here do not need it; it tells which
    regime an edge set is in."""
    if len(i_vec) == 0:
        return True
    deg = np.bincount(np.asarray(i_vec, np.int64), minlength=n_vertices)
    deg += np.bincount(np.asarray(j_vec, np.int64), minlength=n_vertices)
    wedges2 = float((deg.astype(np.float64) * (deg - 1.0)).sum())
    return max(wedges2, 2.0 * len(i_vec)) < F32_EXACT


def use_device_sweep(n_vertices, score_idx, device):
    """Route to the dense device sweep: score 0, the vertex count within
    the dense cap, and a CUDA model device."""
    return (score_idx == 0 and n_vertices <= DEVICE_SWEEP_MAX_N
            and device is not None and torch.device(device).type == "cuda")
