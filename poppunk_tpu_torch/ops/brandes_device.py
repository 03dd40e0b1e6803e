"""Batched Brandes betweenness on the device.

Counterpart of poppunk_tpu/ops/brandes_device.py. The refine betweenness
scores (score_idx 1/2) need, per evaluated boundary offset, the largest
normalised betweenness of every network component of more than three
vertices, from a sampled subset of sources (PopPUNK's networkSummary with
betweenness_sample; the host oracle is network/summary.brandes_betweenness,
whose native OpenMP twin is native/graph_core.cpp).

The strain-graph components at refine scale are a few thousand vertices
each, so their DENSE adjacencies fit [m, m] blocks, and Brandes'
level-synchronous BFS is a sequence of (adjacency x per-source vector)
products: a batch of components x a batch of sources turns the forward
sigma recursion and the backward dependency accumulation into
``torch.bmm`` of [C, m, m] x [C, m, S], all components and all sources at
once. The forward loop ends at the first level no vertex sits at, read by
one host sync per level; the backward loop runs the levels it found.

Shortest-path counts sigma at these diameters stay far below float32's
integer range, and with TF32 off (``exact=True``) every product is exact
in float32, so sigma is an exact integer and the dependencies match the
float64 host oracle to float32 rounding.

What differs from the reference: ``pack_components(max_comp=...)`` keeps
the ``max_comp`` LARGEST components (ties to the lower label), in label
order; the reference keeps the first ``max_comp`` labels whatever their
size (its brandes_device.py:121). With ``max_comp`` None or at least the
component count the two are the same.
"""

import numpy as np
import torch

from .. import _device

__all__ = ["brandes_batched_device", "pack_components"]

_INF = 2 ** 30


def _brandes_batched(A, sources, weights, exact=True):
    """A: f32 [C, m, m] symmetric 0/1 dense adjacencies (zero diagonal,
    padded rows and columns all zero). sources: int [C, S], -1 = padding.
    weights: f32 [C, S] per-source contribution weight (the sampling
    rescale n_comp / n_sampled rides here). Returns bc f32 [C, m]:
    unnormalised betweenness (Brandes' undirected double-counting
    convention) summed over the given sources.

    ``exact=False`` lets the card's reduced-precision product (TF32) run
    the products, as Precision.DEFAULT does on the TPU; sigma is then
    exact only while it fits TF32's 11-bit significand. On the CPU it is
    the same as ``exact=True``."""
    C, m, _ = A.shape
    valid = (sources >= 0)[:, None, :]  # [C, 1, S]
    src = sources.clamp(0, m - 1).long()
    onehot = torch.zeros((C, m, sources.shape[1]), dtype=torch.float32,
                         device=A.device)
    onehot.scatter_(1, src[:, None, :], 1.0)
    onehot = onehot * valid
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = not exact
    try:
        dist = torch.where(onehot > 0, 0, _INF).to(torch.int32)  # [C, m, S]
        sigma = onehot
        level = 0
        while bool((dist == level).any()):
            frontier = (dist == level).to(torch.float32)
            contrib = torch.bmm(A, sigma * frontier)
            newly = (contrib > 0) & (dist == _INF)
            dist = torch.where(newly, level + 1, dist)
            sigma = torch.where(newly, contrib, sigma)
            level += 1
        delta = torch.zeros_like(sigma)
        inv_sigma = torch.where(sigma > 0, 1.0 / sigma, 0.0)
        for lv in range(level - 1, 0, -1):
            w_mask = (dist == lv).to(torch.float32)
            coef = (1.0 + delta) * inv_sigma * w_mask
            pred_mask = (dist == lv - 1).to(torch.float32)
            delta = delta + sigma * torch.bmm(A, coef) * pred_mask
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    reached = (dist > 0) & (dist < _INF)  # excludes source + unreachable
    return (delta * reached * weights[:, None, :]).sum(dim=2)


def brandes_batched_device(A, sources, weights=None, exact=True,
                           device=None):
    """Batched betweenness; see _brandes_batched. A, sources, weights:
    numpy arrays or tensors; weights default to 1. Runs on ``device``
    (None: a tensor A's device, else ``_device.resolve``'s choice: the
    card unless the CPU is asked for). Returns bc f32 [C, m] there."""
    if device is None and isinstance(A, torch.Tensor):
        device = A.device
    device = _device.resolve(device)
    A = torch.as_tensor(A, dtype=torch.float32, device=device)
    sources = torch.as_tensor(sources, dtype=torch.int32, device=device)
    if weights is None:
        weights = torch.ones(sources.shape, dtype=torch.float32,
                             device=device)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=device)
    return _brandes_batched(A, sources, weights, exact=bool(exact))


def pack_components(i, j, labels, min_size=4, max_comp=None, pad_to=None):
    """Host-side packing of an edge list into the batched dense layout.

    i, j: edge endpoints (global vertex ids); labels: component label
    per vertex. Components of size <= min_size - 1 are dropped (the
    reference scores only size > 3, network.py:1270); with ``max_comp``
    the ``max_comp`` largest of the rest are kept (ties to the lower
    label), in label order. Returns (adj [C, m, m] f32, local_of [n] i32
    (-1 if dropped), comps (list of global-vertex arrays per kept
    component)) with m the largest kept component size rounded up to
    ``pad_to`` (default: next multiple of 128)."""
    labels = np.asarray(labels)
    comps_all, counts = np.unique(labels, return_counts=True)
    big = counts >= min_size
    keep = comps_all[big]
    if max_comp is not None and max_comp < len(keep):
        largest = np.argsort(-counts[big], kind="stable")[:max_comp]
        keep = np.sort(keep[largest])
    comps = [np.flatnonzero(labels == c) for c in keep]
    if not comps:
        return (np.zeros((0, 0, 0), np.float32),
                np.full(labels.shape, -1, np.int32), [])
    m = max(len(v) for v in comps)
    pad_to = pad_to or 128
    m = ((m + pad_to - 1) // pad_to) * pad_to
    n = labels.shape[0]
    local_of = np.full(n, -1, np.int32)
    comp_of = np.full(n, -1, np.int32)
    for ci, verts in enumerate(comps):
        local_of[verts] = np.arange(len(verts), dtype=np.int32)
        comp_of[verts] = ci
    adj = np.zeros((len(comps), m, m), np.float32)
    ci_e = comp_of[i]
    ok = (ci_e >= 0) & (ci_e == comp_of[j])
    a, b = local_of[i[ok]], local_of[j[ok]]
    adj[ci_e[ok], a, b] = 1.0
    adj[ci_e[ok], b, a] = 1.0
    return adj, local_of, comps
