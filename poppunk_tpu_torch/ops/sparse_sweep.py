"""Sparse boundary-sweep scoring on the device at any n.

Counterpart of poppunk_tpu/ops/sparse_sweep.py. It scores the refine search
for score_idx 0 (networkSummary's transitivity * (1 - density),
PopPUNK/refine.py:375-474 + network.py:1204-1307) from an edge list that
stays on the device: only the per-threshold scores reach the host.

Core ideas, as in the reference:

* Edges arrive (i, j, d0) with d0 the signed boundary distance; sorted by
  d0 once (stably), every threshold's active set is a PREFIX, and
  consecutive thresholds differ by a contiguous DELTA slice.
* The adjacency is a bit-packed [n, ceil(n/32)] bitmap of int32 words (the
  reference's uint32 bits; bit 31 is the sign) carried from threshold to
  threshold: each step sets only its delta edges' bits and gathers only
  the delta rows for triangle counting.
* New triangles per step are counted exactly by inclusion-exclusion over
  popcounts against the old bitmap, the delta-only bitmap, and their union:
  a new triangle with k in {1,2,3} new edges contributes k to
  S_all = sum popcount(B[u] & B[v]) over new edges, 1 to S_on (both other
  edges old) iff k = 1, and 3 to S_nn (both other edges new) iff k = 3, so
      n_new = S_on + (S_all - S_on - S_nn)/2 + S_nn/3.

What differs from the reference, and why:

* The triangle popcount sums, the triangle count, the degrees and the wedge
  sum are exact int64 (the reference sums them in float32); each score is
  then one float64 expression of exact integers, so the scores differ from
  the host scorer (network/incremental.grow_network_scores) by rounding
  alone.
* Steps are launched one threshold at a time at their exact delta size,
  and the edge buffers hold the band's edges plus a small margin
  (``band_slots``): torch has no static shapes, so the reference's
  power-of-two pads, pad slots and padded step groups (``_bucket``,
  ``_STEP_GRID``, XLA's compiled-program budget) have no counterpart.
* Delta bits are set with ``index_put_(accumulate=True)`` on int32 words:
  each target bit is written once (edges are unique i < j pairs), so the
  add is an OR, bit 31 included.
* The memory budget is the card's (``device_hbm_total``); the reference's
  ``HBM_TOTAL`` / ``FILL_TRANSIENT`` stay as the CPU's values, so on the
  CPU the port plans within the JAX package's budget.
"""

import numpy as np
import torch

from .match_counts import popcount32

# Edge-block size for the triangle popcount gathers: bounds the gathered
# row transient to 4 * _TRI_BLOCK * ceil(n/32) * 4 bytes (537 MB at
# n = 131072).
_TRI_BLOCK = 8192
# [_TRI_BLOCK, ceil(n/32)] int32 blocks live beside the four gathered ones
# while a block's popcounts are summed (_delta_step's psum of the two OR'd
# rows): the two ORs, their AND, and popcount32's working words (its sign
# bits and up to four SWAR steps)
_TRI_TRANSIENT_BLOCKS = 8


def band_slots(e_total):
    """Edge-buffer slots for a band of ``e_total`` edges (an exact count or
    an estimate): the count plus a margin for pairs that sit exactly on a
    threshold."""
    e = max(int(e_total), 1)
    return e + max(1024, e // 128)


def _bits(v):
    """int32 words with bit (v & 31) set: 1 << 31 wraps to the sign bit."""
    b = torch.ones_like(v, dtype=torch.int64) << (v & 31)
    return torch.where(b >= 2**31, b - 2**32, b).to(torch.int32)


def _delta_step(bm, deg, i_sorted, j_sorted, start, stop):
    """Activate the delta slice [start, stop) of the sorted edges: returns
    the new triangles it closes (int64 0-d) and updates bm and deg in
    place. Every per-edge transient is one _TRI_BLOCK of edges: the
    delta-only bitmap is set block by block, then the triangle popcount
    sums gather 4 * _TRI_BLOCK * w words at a time."""
    def blocks():
        for b in range(start, stop, _TRI_BLOCK):
            e = min(b + _TRI_BLOCK, stop)
            yield i_sorted[b:e].long(), j_sorted[b:e].long()

    bnew = torch.zeros_like(bm)
    for iv, jv in blocks():
        bnew.index_put_((iv, jv >> 5), _bits(jv), accumulate=True)
        bnew.index_put_((jv, iv >> 5), _bits(iv), accumulate=True)

    def psum(x, y):
        # a row's sum is at most 32 * w bits, so int32 holds it; only the
        # [_TRI_BLOCK] row sums are widened to int64, never the block
        return popcount32(x & y).sum(dim=1, dtype=torch.int32).sum(
            dtype=torch.int64)

    zero = torch.zeros((), dtype=torch.int64, device=bm.device)
    s_all, s_on, s_nn = zero, zero, zero
    for iv, jv in blocks():
        bou, bov, bnu, bnv = bm[iv], bm[jv], bnew[iv], bnew[jv]
        s_all = s_all + psum(bou | bnu, bov | bnv)
        s_on = s_on + psum(bou, bov)
        s_nn = s_nn + psum(bnu, bnv)
        ones = torch.ones_like(iv)
        deg.index_add_(0, iv, ones)
        deg.index_add_(0, jv, ones)
    bm |= bnew
    return s_on + (s_all - s_on - s_nn) // 2 + s_nn // 3


class SweepEdges:
    """Device-resident in-boundary edge list (i, j, d0), d0-sorted.

    The first ``count`` slots of the buffers are the edges (i < j int32,
    d0 float32); later slots are ignored. The constructor sorts once,
    stably (the reference's lax.sort with one key); `counts_at` answers
    prefix sizes for any ascending threshold grid.
    """

    def __init__(self, i_dev, j_dev, d0_dev, count, n, n_real=None):
        self.n = int(n)
        self.n_real = int(n_real) if n_real is not None else int(n)
        self.count = int(count)
        self.d0, order = torch.sort(d0_dev[:self.count], stable=True)
        self.i = i_dev[:self.count][order]
        self.j = j_dev[:self.count][order]

    def __len__(self):
        return self.count

    def counts_at(self, thresholds):
        """Active-prefix length per ascending threshold (host int64[])."""
        t = torch.as_tensor(np.asarray(thresholds, np.float32),
                            device=self.d0.device)
        pos = torch.searchsorted(self.d0, t, right=True)
        return pos.cpu().numpy().astype(np.int64)

    def fetch_prefix(self, k):
        """Host (i, j) int32 of the first k edges (the final network at the
        optimal boundary)."""
        k = int(k)
        return (self.i[:k].cpu().numpy().astype(np.int32),
                self.j[:k].cpu().numpy().astype(np.int32))


def sweep_scores_sparse_device(edges, thresholds):
    """-(transitivity * (1 - density)) per ascending threshold, scored on
    the edge list's device from a SweepEdges list; returns (scores float64,
    edge counts int64) on the host. The edge list never leaves the device.

    Host twin: network/incremental.grow_network_scores with
    score_idx=0 over (i, j, searchsorted(thresholds, d0)).
    """
    n = edges.n
    w = (n + 31) // 32
    ts = np.asarray(thresholds, np.float64)
    if np.any(np.diff(ts) < 0):
        raise ValueError("thresholds must be ascending")
    cum = edges.counts_at(ts)
    dev = edges.d0.device
    possible = 0.5 * float(edges.n_real) * (edges.n_real - 1.0)

    bm = torch.zeros((n, w), dtype=torch.int32, device=dev)
    deg = torch.zeros(n, dtype=torch.int64, device=dev)
    tri = torch.zeros((), dtype=torch.int64, device=dev)
    tris, wedges = [], []
    start = 0
    for stop in cum.tolist():
        if stop > start:
            tri = tri + _delta_step(bm, deg, edges.i, edges.j, start, stop)
        # pad vertex rows (>= n_real) never receive edges, so deg there
        # stays 0 and the wedge sum is over real vertices only
        tris.append(tri)
        wedges.append((deg * (deg - 1)).sum())
        start = stop
    tri_h = torch.stack(tris).cpu().numpy().astype(np.float64)
    wedges_h = torch.stack(wedges).cpu().numpy().astype(np.float64)
    density = cum.astype(np.float64) / possible
    with np.errstate(divide="ignore", invalid="ignore"):
        trans = np.where(wedges_h > 0, 6.0 * tri_h / wedges_h, 0.0)
    return -(trans * (1.0 - density)), cum.astype(np.int64)


# Device memory assumed available to the sweep's phases on the CPU (the
# reference's 16 GB figure minus its runtime reserve, kept so that on the CPU
# the port plans with the JAX package's budget); on a card, device_hbm_total
# reads it.
HBM_TOTAL = 14_500_000_000
# fill-phase streaming transients (plan-capped compaction buffers)
FILL_TRANSIENT = 1_500_000_000
# what the card keeps back from the sweep: the CUDA context, the caching
# allocator's slack and the streaming pass's own transients
_CARD_RESERVE = 0.10


def device_hbm_total(device=None):
    """Device memory the sweep may plan with: HBM_TOTAL on the CPU (or
    when no device is named), else the card's total from
    ``torch.cuda.mem_get_info`` less a 10% reserve."""
    if device is None or torch.device(device).type != "cuda":
        return HBM_TOTAL
    _, total = torch.cuda.mem_get_info(torch.device(device))
    return int(total * (1.0 - _CARD_RESERVE))


def sweep_peak_bytes(n, e_cap):
    """Device bytes, beyond the resident tensors, of a sweep over e_cap
    edges at its largest phase:

    - fill: compaction transients + 12 B/slot edge buffers;
    - d0-sort: the edge buffers in and out plus the int64 sort order;
    - scoring: edge buffers + two [n, n/32] bitmaps + the four gathered
      row blocks + the _TRI_TRANSIENT_BLOCKS int32 blocks of a block's
      popcount sums + a 200 MB allowance. The row sums are int32, so no
      block is widened to int64; the allowance covers what is not per
      block: the delta's int32 bit words and scatter indices for one
      _TRI_BLOCK of edges, the [_TRI_BLOCK] row sums, the degrees' int64
      [n] (1 MB at n = 131072) and the per-step scalars.

    Slots are ``band_slots(e_cap)``, the buffers the fill allocates."""
    slots = band_slots(e_cap)
    w = (n + 31) // 32
    bitmaps = 2 * n * w * 4  # carried adjacency + per-step delta bitmap
    block = _TRI_BLOCK * w * 4
    tri_gather = 4 * block
    tri_transient = _TRI_TRANSIENT_BLOCKS * block
    return max(FILL_TRANSIENT + 12 * slots, 32 * slots,
               12 * slots + bitmaps + tri_gather + tri_transient
               + 200_000_000)


def hbm_feasible(n, e_cap, resident_bytes, hbm_total=HBM_TOTAL):
    """True if a sweep over e_cap edges fits alongside `resident_bytes`
    of persistent tensors (the planes) at every phase."""
    return resident_bytes + sweep_peak_bytes(n, e_cap) <= hbm_total


def max_edge_cap(n, resident_bytes, hbm_total=HBM_TOTAL):
    """Largest pow2 edge count hbm_feasible accepts (0 if none)."""
    cap = 0
    c = 1 << 20
    while hbm_feasible(n, c, resident_bytes, hbm_total):
        cap = c
        c *= 2
    return cap
