"""The plain reference of GPSC assignment in PopPUNK's network mode: a
request of new genomes attached to the database network and its clusters
named, from the benchmark's own inputs and the saved BGMM fit.

Plain PyTorch and numpy, importing nothing of the program (nor JAX). What
a request gets, written from PopPUNK's ``poppunk_assign`` without
``--stable``, ``--serial`` or ``--update-db``, with ``--use-full-network``
(assign.py: addQueryToNetwork, printClusters):

    distances   (core, accessory) of every query against every reference
                in float64, ``assign_reference.reference_distances``
                (PopPUNK's published definitions), and of every pair of
                the request's queries (query i against query j, i < j)
                where a query has no within-strain reference
    class       of each pair: the BGMM component of highest posterior from
                the saved fit, in float64 (``assign_reference.Fit``)
    network     the database network of the references' own pairs,
                classified here (``base_pairs``, float64 distances and
                classes of every pair of references, i < j), and the
                request's within-strain pairs: queries are vertices after
                the references, in the request's order; components by a
                plain union-find
    names       printClusters: the database's clusters are the network's
                components ranked largest first, among equal sizes the one
                whose first vertex comes later first, named 1, 2, ... in
                that order (the order the clusters file lists them); after
                a request, a component whose old members lie in one old
                cluster takes its name; in several, their names joined by
                "_" in that order; with no old member, the next number
                above every old one, in rank order

``pair_classes`` flags, beside each pair's class, the pairs whose class
changes within DIST_TOL of their distances (on a BOX_POINTS x BOX_POINTS
grid of the square, as ``assign_reference.ambiguous`` does for the
nearest pairs); the driver exempts answers such a pair could change, and
resolves an unsure pair of references as the database's saved network
does. ``precision`` of the distances as in ``assign_reference``; classes
are float64 in every precision.
"""

import numpy as np
import torch

from .assign_reference import BOX_POINTS, DIST_TOL, reference_distances

ROWS = 16  # query rows of the pairs classified at once
BASE_ROWS = 64  # reference rows of base_pairs' distances at once


def pair_classes(dists, fit, device, tol=DIST_TOL):
    """(within, unsure) bool numpy [nq, nr] of the pairs ``dists`` [nq, nr,
    2] (float64 numpy): the fit's class at each pair, and whether it
    differs anywhere on a BOX_POINTS x BOX_POINTS grid of the square
    within ``tol`` of the pair's distances. Float64 torch on ``device``."""
    f64 = dict(dtype=torch.float64, device=device)
    inv = torch.as_tensor(np.linalg.inv(fit.covariances), **f64)
    means = torch.as_tensor(fit.means, **f64)
    scale = torch.as_tensor(fit.scale, **f64)
    log_norm = torch.as_tensor(
        np.log(fit.weights)
        - 0.5 * np.log(np.linalg.det(2 * np.pi * fit.covariances)), **f64)
    steps = torch.linspace(-tol, tol, BOX_POINTS, **f64)
    box = torch.stack(torch.meshgrid(steps, steps, indexing="ij"),
                      -1).reshape(-1, 2)
    centre = BOX_POINTS * BOX_POINTS // 2  # the (0, 0) offset
    nq = dists.shape[0]
    within = np.zeros(dists.shape[:2], bool)
    unsure = np.zeros(dists.shape[:2], bool)
    for start in range(0, nq, ROWS):
        d = torch.as_tensor(dists[start:start + ROWS], **f64)
        x = (d[:, :, None, :] + box) / scale  # [rows, nr, grid, 2]
        diff = x[..., None, :] - means  # [rows, nr, grid, K, 2]
        maha = torch.einsum("...ki,kij,...kj->...k", diff, inv, diff)
        hit = (log_norm - 0.5 * maha).argmax(-1) == fit.within
        within[start:start + ROWS] = hit[..., centre].cpu().numpy()
        unsure[start:start + ROWS] = (hit.any(-1)
                                      != hit.all(-1)).cpu().numpy()
    return within, unsure


def base_pairs(planes, lengths, freqs, cfg, fit, device):
    """(within, unsure) int64 [m, 2] arrays of reference pairs (i, j),
    i < j, of ``planes`` (int32 torch [n, K, P, Wp] on ``device``) and
    their lengths and frequencies: those the fit calls within-strain, and
    those whose class is unsure (``pair_classes``), from float64
    distances, BASE_ROWS rows at a time against the columns after them."""
    n = planes.shape[0]
    within, unsure = [], []
    for start in range(0, n - 1, BASE_ROWS):
        stop = min(start + BASE_ROWS, n)
        d = reference_distances(planes[start:stop], planes[start:],
                                lengths[start:stop], lengths[start:],
                                freqs[start:stop], freqs[start:], cfg)
        w, u = pair_classes(d, fit, device)
        del d
        after = (np.arange(start, n)[None, :]
                 > np.arange(start, stop)[:, None])
        for found, out in ((w, within), (u, unsure)):
            i, j = np.nonzero(found & after)
            out.append(np.stack([start + i, start + j], 1))
    return tuple(np.concatenate(out + [np.zeros((0, 2), np.int64)])
                 for out in (within, unsure))


class Network:
    """The database network over ``n_ref`` references (vertex i the
    database's i-th) with the within-strain pairs ``edges`` [m, 2], its
    clusters named as printClusters names a new database's: ``names``,
    each reference's cluster name."""

    def __init__(self, n_ref, edges):
        self.n_ref = n_ref
        parent = list(range(n_ref))
        for u, v in np.asarray(edges, np.int64).tolist():
            _union(parent, u, v)
        self.root = _roots(np.array(parent, np.int64))
        roots, first, sizes = np.unique(self.root, return_index=True,
                                        return_counts=True)
        ranked = roots[np.lexsort((-first, -sizes))]
        rank = np.empty(n_ref, np.int64)
        rank[ranked] = np.arange(len(ranked))
        # each reference's old cluster, as its place in the file's order
        self.old = rank[self.root]
        self.old_order = [str(k + 1) for k in range(len(ranked))]
        self.names = [self.old_order[k] for k in self.old.tolist()]
        self.next_new = len(ranked) + 1

    def components(self, nq, qr, qq):
        """(labels [n_ref + nq], {label: name}, labels of the components
        named by new numbers) of the network with ``nq`` queries after
        the references, ``qr`` (query, reference) and ``qq`` (query,
        query) index arrays its within-strain pairs."""
        parent = self.root.tolist() + list(range(self.n_ref,
                                                 self.n_ref + nq))
        q, r = (np.asarray(a, np.int64) for a in qr)
        for u, v in np.unique(np.stack([self.n_ref + q, self.root[r]], 1),
                              axis=0).tolist():
            _union(parent, u, v)
        for u, v in zip(np.asarray(qq[0]).tolist(),
                        np.asarray(qq[1]).tolist()):
            _union(parent, self.n_ref + u, self.n_ref + v)
        labels = _roots(np.array(parent))
        roots, first, sizes = np.unique(labels, return_index=True,
                                        return_counts=True)
        # largest first; among equal sizes the later first vertex first
        ranked = roots[np.lexsort((-first, -sizes))]
        held = np.unique(np.stack([labels[:self.n_ref], self.old], 1),
                         axis=0)
        olds = {}
        for label, k in held:  # each label's old clusters, in file order
            olds.setdefault(int(label), []).append(self.old_order[k])
        names, new, next_new = {}, set(), self.next_new
        for label in ranked:
            label = int(label)
            if label in olds:
                names[label] = "_".join(olds[label])
            else:
                names[label] = str(next_new)
                next_new += 1
                new.add(label)
        return labels, names, new


def _find(parent, x):
    while parent[x] != x:
        parent[x] = parent[parent[x]]
        x = parent[x]
    return x


def _union(parent, u, v):
    a, b = _find(parent, u), _find(parent, v)
    if a != b:
        parent[max(a, b)] = min(a, b)


def _roots(parent):
    """Every vertex's root, by pointer jumping."""
    parent = parent.copy()
    while True:
        up = parent[parent]
        if np.array_equal(up, parent):
            return parent
        parent = up
