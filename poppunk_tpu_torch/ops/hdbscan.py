"""HDBSCAN from scratch (host, with the Boruvka sweep on the device).

Counterpart of poppunk_tpu/ops/hdbscan.py, which replaces the external
``hdbscan`` package the reference depends on (PopPUNK/dbscan.py:54-60:
boruvka balltree, prediction data). Pipeline:

1. core distances: distance to the min_samples-th nearest neighbour
   (self included, matching sklearn/hdbscan conventions) via cKDTree;
2. mutual reachability mr(a,b) = max(core_a, core_b, d(a,b));
3. exact MST of the complete mutual-reachability graph with O(n) memory
   (no n x n matrix is materialised): Boruvka on the model device for
   n >= 4096 — per round one tiled min-outgoing-edge sweep in torch ops,
   O(log n) rounds — with a host Prim loop as the small-n path and oracle;
4. single-linkage dendrogram (union-find over MST edges sorted ascending);
5. condensed tree with min_cluster_size, stability, excess-of-mass cluster
   selection, labels + membership probabilities;
6. approximate_predict for out-of-sample points (the reference calls
   hdbscan.approximate_predict for all-pair assignment,
   PopPUNK/models.py:192).

The host parts are copies of the JAX package's. The Boruvka round is the
JAX package's jitted scan rewritten as torch ops over row tiles, with the
same float32 operands and padding, so both packages find the same MST
(tests/test_torch_dbscan.py). A fitted ``HDBSCAN`` pickles numpy / scipy
state only, never its device, so its ``_fit.pkl`` loads anywhere.
"""

from dataclasses import dataclass

import numpy as np
import torch
from scipy.spatial import cKDTree

from .. import _device

# the mask value of the Boruvka sweep (the JAX package's float32 3.4e38)
_MASKED = 3.4e38


def core_distances(X, min_samples):
    tree = cKDTree(X)
    k = min(min_samples, X.shape[0])
    dists, _ = tree.query(X, k=k, workers=-1)
    if k == 1:
        return np.zeros(X.shape[0]), tree
    return dists[:, -1], tree


def mutual_reachability_mst(X, core, device=None):
    """MST over the complete mutual reachability graph.

    Returns edges [(u, v, w)] sorted ascending by w, length n-1.
    O(n) memory (never materialises the n x n matrix). Large inputs use
    Boruvka with the per-round min-outgoing-edge sweep on ``device``
    (None: ``_device.resolve``'s choice; O(log n) rounds); small ones a
    host Prim loop (its oracle).
    """
    n = X.shape[0]
    if n >= 4096:
        edges = boruvka_mst_device(
            np.asarray(X, dtype=np.float32), np.asarray(core, np.float32),
            device=device)
    else:
        edges = prim_mst(X, core)
    order = np.argsort(edges[:, 2], kind="stable")
    return edges[order]


def prim_mst(X, core):
    """The host Prim loop of the JAX package's mutual_reachability_mst
    (its small-n path, and the Boruvka sweep's oracle at any n): float64
    edges [(u, v, w)] in the order Prim adds them, length n-1."""
    n = X.shape[0]
    in_tree = np.zeros(n, dtype=bool)
    best_dist = np.full(n, np.inf)
    best_from = np.zeros(n, dtype=np.int64)
    in_tree[0] = True
    current = 0
    edges = np.empty((n - 1, 3))
    for step in range(n - 1):
        d = np.sqrt(((X - X[current]) ** 2).sum(axis=1))
        mr = np.maximum(np.maximum(d, core), core[current])
        update = mr < best_dist
        best_dist = np.where(update, mr, best_dist)
        best_from = np.where(update, current, best_from)
        masked = np.where(in_tree, np.inf, best_dist)
        nxt = int(np.argmin(masked))
        edges[step] = (best_from[nxt], nxt, best_dist[nxt])
        in_tree[nxt] = True
        current = nxt
    return edges


def _boruvka_round(X, core, comp, n, tile):
    """One Boruvka round on X's device: for every vertex, the minimum
    mutual-reachability edge leaving its component, as (weight float32
    [n_pad], first column achieving it int64 [n_pad]).

    X [n_pad, d] / core / comp are padded to a multiple of ``tile``
    (padded rows: core 3.4e38, component -1); padded columns and columns
    of the row's own component are masked to 3.4e38. Row tiles keep peak
    memory at a few [tile, n_pad] blocks. Per tile, torch ops in the JAX
    package's float32 order: one [tile, n_pad] difference per coordinate,
    squared and summed (never a matrix product, which rounds otherwise),
    the root, the max with both core distances, the mask, then the row
    min and the first index achieving it (``torch.argmin``, like
    ``jnp.argmin``).
    """
    n_pad = X.shape[0]
    coords = X.t().contiguous()  # [d, n_pad]
    col_pad = torch.arange(n_pad, device=X.device) >= n
    w = torch.empty(n_pad, dtype=X.dtype, device=X.device)
    j = torch.empty(n_pad, dtype=torch.int64, device=X.device)
    for s in range(0, n_pad, tile):
        rows = slice(s, s + tile)
        mr = None
        for c in coords:
            diff = c[rows, None] - c[None, :]
            diff.mul_(diff)
            mr = diff if mr is None else mr.add_(diff)
        mr.sqrt_()
        torch.maximum(mr, core[rows, None], out=mr)
        torch.maximum(mr, core[None, :], out=mr)
        masked = comp[rows, None] == comp[None, :]
        mr.masked_fill_(masked.logical_or_(col_pad), _MASKED)
        w[rows] = mr.amin(dim=1)
        j[rows] = torch.argmin(mr, dim=1)
    return w, j


def boruvka_mst_device(X, core, tile=1024, device=None):
    """Exact MST of the complete mutual-reachability graph via Boruvka.

    ``device`` (None: ``_device.resolve``'s choice) does the O(n^2)
    min-outgoing-edge sweep each round; the host does the O(n) component
    bookkeeping (union-find over at most one candidate edge per component
    — any per-component minimum edge is in some MST by the cut property,
    and single-linkage heights depend only on the weight multiset, which
    is identical across MSTs).

    Returns float64 edges [(u, v, w)], unsorted, length n-1.
    """
    device = _device.resolve(device)
    n = X.shape[0]
    n_pad = -(-n // tile) * tile
    Xp = np.zeros((n_pad, X.shape[1]), np.float32)
    Xp[:n] = X
    corep = np.full(n_pad, _MASKED, np.float32)
    corep[:n] = core

    Xd = torch.as_tensor(Xp, device=device)
    cored = torch.as_tensor(corep, device=device)

    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    comp = np.arange(n, dtype=np.int32)
    edges = np.empty((n - 1, 3))
    n_edges = 0
    while n_edges < n - 1:
        compp = np.full(n_pad, -1, np.int32)
        compp[:n] = comp
        w, j = _boruvka_round(Xd, cored, torch.as_tensor(compp, device=device),
                              n, tile)
        w = w.cpu().numpy()[:n]
        j = j.cpu().numpy()[:n]
        # per-component minimum outgoing edge (first vertex achieving it)
        cids, cinv = np.unique(comp, return_inverse=True)
        best = np.full(cids.shape[0], np.inf)
        np.minimum.at(best, cinv, w)
        idxs = np.flatnonzero(w == best[cinv])
        first = idxs[np.unique(cinv[idxs], return_index=True)[1]]
        for u in first:
            u = int(u)
            v = int(j[u])
            ru, rv = find(u), find(v)
            if ru == rv:  # mutual pick already merged this round
                continue
            edges[n_edges] = (u, v, w[u])
            n_edges += 1
            parent[ru] = rv
        # pointer-jump all vertices to their roots in O(log n) passes
        p = parent[np.arange(n)]
        while True:
            pp = parent[p]
            if np.array_equal(pp, p):
                break
            p = pp
        parent[np.arange(n)] = p  # full path compression
        comp = p.astype(np.int32)
    return edges


def single_linkage(mst_edges, n):
    """Union-find dendrogram: returns [(left, right, dist, size)] with
    cluster ids n..2n-2 (scipy linkage convention)."""
    parent = np.arange(2 * n - 1, dtype=np.int64)
    size = np.ones(2 * n - 1, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    merges = np.empty((n - 1, 4))
    next_id = n
    for idx, (u, v, w) in enumerate(mst_edges):
        ru, rv = find(int(u)), find(int(v))
        merges[idx] = (ru, rv, w, size[ru] + size[rv])
        parent[ru] = next_id
        parent[rv] = next_id
        size[next_id] = size[ru] + size[rv]
        next_id += 1
    return merges


@dataclass
class CondensedTree:
    parent: np.ndarray
    child: np.ndarray
    lambda_val: np.ndarray
    child_size: np.ndarray


def condense_tree(merges, n, min_cluster_size):
    """Condensed tree (hdbscan-style): clusters persist only while both
    children have >= min_cluster_size points; smaller splits 'fall out' as
    points at the split's lambda."""
    root = 2 * n - 2
    # children arrays for internal nodes
    left = np.zeros(n - 1, dtype=np.int64)
    right = np.zeros(n - 1, dtype=np.int64)
    dist = np.zeros(n - 1)
    size = np.zeros(2 * n - 1, dtype=np.int64)
    size[:n] = 1
    for i in range(n - 1):
        left[i] = merges[i, 0]
        right[i] = merges[i, 1]
        dist[i] = merges[i, 2]
        size[n + i] = merges[i, 3]

    parents, children, lambdas, sizes = [], [], [], []
    relabel = {root: n}  # condensed cluster ids start at n
    next_label = n + 1
    # iterative DFS: (node, condensed_parent)
    stack = [(root, n)]
    while stack:
        node, cparent = stack.pop()
        if node < n:
            # leaf reached directly (only if root is a leaf — degenerate)
            continue
        i = node - n
        l, r = int(left[i]), int(right[i])
        lam = 1.0 / dist[i] if dist[i] > 0 else np.inf
        lsz, rsz = int(size[l]), int(size[r])

        if lsz >= min_cluster_size and rsz >= min_cluster_size:
            # true split: two new condensed clusters
            for ch, csz in ((l, lsz), (r, rsz)):
                relabel[ch] = next_label
                parents.append(cparent)
                children.append(next_label)
                lambdas.append(lam)
                sizes.append(csz)
                next_label += 1
                if ch >= n:
                    stack.append((ch, relabel[ch]))
                else:
                    # singleton cluster: immediately a point of itself —
                    # record the point falling out of the new cluster at inf
                    parents.append(relabel[ch])
                    children.append(ch)
                    lambdas.append(np.inf)
                    sizes.append(1)
        else:
            # cluster continues through the bigger child; smaller child's
            # points fall out at this lambda
            for ch, csz in ((l, lsz), (r, rsz)):
                if csz >= min_cluster_size:
                    stack.append((ch, cparent))
                else:
                    # all points under ch fall out at lam
                    sub = [ch]
                    while sub:
                        x = sub.pop()
                        if x < n:
                            parents.append(cparent)
                            children.append(x)
                            lambdas.append(lam)
                            sizes.append(1)
                        else:
                            sub.append(int(left[x - n]))
                            sub.append(int(right[x - n]))
    return CondensedTree(
        np.array(parents, dtype=np.int64),
        np.array(children, dtype=np.int64),
        np.array(lambdas),
        np.array(sizes, dtype=np.int64),
    )


def compute_stability(tree, n):
    """Stability per condensed cluster: sum over members of
    (lambda_p - lambda_birth)."""
    births = {}
    cap = _finite_max(tree)
    for p, c, lam in zip(tree.parent, tree.child, tree.lambda_val):
        if c >= n:
            # cap like lam_eff below: a cluster born at a zero-distance
            # split (infinite lambda) must not poison its stability sum
            # with -inf
            births[c] = lam if np.isfinite(lam) else cap
    births[n] = 0.0
    stability = {}
    for p, lam, sz in zip(tree.parent, tree.lambda_val, tree.child_size):
        birth = births.get(p, 0.0)
        lam_eff = lam if np.isfinite(lam) else cap  # zero-distance merges
        stability[p] = stability.get(p, 0.0) + (lam_eff - birth) * sz
    return stability


def _finite_max(tree):
    finite = tree.lambda_val[np.isfinite(tree.lambda_val)]
    return finite.max() if finite.size else 1.0


def select_clusters_eom(tree, n):
    """Excess-of-mass selection: a cluster is selected if its stability
    exceeds the sum of its children's; root never selected."""
    stability = compute_stability(tree, n)
    cluster_children = {}
    for p, c in zip(tree.parent, tree.child):
        if c >= n:
            cluster_children.setdefault(p, []).append(c)

    clusters = sorted((c for c in stability if c != n), reverse=True)
    selected = {}
    for c in clusters:
        kids = cluster_children.get(c, [])
        child_sum = sum(stability.get(k, 0.0) for k in kids)
        if stability.get(c, 0.0) >= child_sum or not kids:
            selected[c] = True
            # deselect all descendants
            stack = list(kids)
            while stack:
                k = stack.pop()
                selected[k] = False
                stack.extend(cluster_children.get(k, []))
        else:
            selected[c] = False
            stability[c] = child_sum
    return [c for c, s in selected.items() if s]


def labels_from_selection(tree, n, selected):
    """Point labels (+ probabilities) from the selected clusters."""
    selected = set(selected)
    # map each condensed cluster to its selected ancestor (or none)
    parent_of = {}
    for p, c in zip(tree.parent, tree.child):
        if c >= n:
            parent_of[c] = p

    def selected_ancestor(c):
        while c != n:
            if c in selected:
                return c
            c = parent_of.get(c, n)
        return -1

    # lambda at which each point left, and which cluster it left from
    labels = np.full(n, -1, dtype=np.int64)
    probs = np.zeros(n)
    # max lambda within each selected cluster's subtree (for probability)
    max_lambda = {c: 0.0 for c in selected}
    point_parent = {}
    point_lambda = {}
    for p, c, lam in zip(tree.parent, tree.child, tree.lambda_val):
        if c < n:
            point_parent[c] = p
            point_lambda[c] = lam
            anc = selected_ancestor(p)
            if anc >= 0 and np.isfinite(lam):
                max_lambda[anc] = max(max_lambda[anc], lam)

    cluster_ids = {c: i for i, c in enumerate(sorted(selected))}
    for pt in range(n):
        p = point_parent.get(pt, n)
        anc = selected_ancestor(p)
        if anc >= 0:
            labels[pt] = cluster_ids[anc]
            ml = max_lambda.get(anc, 0.0)
            lam = point_lambda.get(pt, 0.0)
            if ml > 0 and np.isfinite(lam):
                probs[pt] = min(lam, ml) / ml
            else:
                probs[pt] = 1.0
    return labels, probs


class HDBSCAN:
    """Minimal fit/predict interface used by the DBSCAN model. The Boruvka
    sweep of ``fit`` runs on ``device`` (None: ``_device.resolve``'s
    choice, made only when a fit takes the Boruvka path); the device is
    not pickled."""

    def __init__(self, min_samples=5, min_cluster_size=5, device=None):
        self.min_samples = min_samples
        self.min_cluster_size = min_cluster_size
        self._device = device

    def __getstate__(self):
        # numpy / scipy state only: a pickled fit loads on any host, and
        # in the JAX package
        state = dict(self.__dict__)
        state.pop("_device", None)
        return state

    def fit(self, X):
        X = np.asarray(X, dtype=np.float64)
        self._X = X
        n = X.shape[0]
        self._core, self._tree = core_distances(X, self.min_samples)
        mst = mutual_reachability_mst(X, self._core,
                                      getattr(self, "_device", None))
        merges = single_linkage(mst, n)
        self._condensed = condense_tree(merges, n, self.min_cluster_size)
        selected = select_clusters_eom(self._condensed, n)
        self.labels_, self.probabilities_ = labels_from_selection(
            self._condensed, n, selected
        )
        # per-cluster max (finite) point lambda + birth lambda for
        # prediction thresholds
        self._cluster_max_lambda = {}
        self._cluster_birth_lambda = {}
        point_lambda = {}
        cluster_birth = {}
        for p, c, lam in zip(self._condensed.parent, self._condensed.child,
                             self._condensed.lambda_val):
            if c < n:
                point_lambda[int(c)] = lam
            else:
                cluster_birth[int(c)] = lam
        for pt, lab in enumerate(self.labels_):
            lam = point_lambda.get(pt, 0.0)
            if lab >= 0 and np.isfinite(lam):
                self._cluster_max_lambda[lab] = max(
                    self._cluster_max_lambda.get(lab, 0.0), lam
                )
        ids = {cc: i for i, cc in enumerate(sorted(selected))}
        for c in selected:
            self._cluster_birth_lambda[ids[c]] = cluster_birth.get(int(c), 0.0)
        return self

    def approximate_predict(self, Y, _chunk=262144):
        """Assign new points to fitted clusters (hdbscan-style): each point
        joins the cluster of its minimum-mutual-reachability neighbour
        among its min_samples nearest fitted points (the reference
        hdbscan's _find_neighbor_and_lambda — NOT simply the
        Euclidean-nearest, whose cluster can differ when that point is
        noise with a large core distance), unless the mutual reachability
        exceeds the cluster's persistence range (then noise).

        Queries run in chunks: the [m, min_samples] kNN buffers at the
        decision-grid batch size (1M points x up to 1023 neighbours)
        would otherwise be tens of GB."""
        Y = np.asarray(Y, dtype=np.float64)
        k = min(self.min_samples, self._X.shape[0])
        m = Y.shape[0]
        nn = np.zeros(m, dtype=np.int64)
        mr = np.zeros(m, dtype=np.float64)
        for s in range(0, m, max(1, _chunk // max(k, 1))):
            e = min(m, s + max(1, _chunk // max(k, 1)))
            d, idx = self._tree.query(Y[s:e], k=k, workers=-1)
            if d.ndim == 1:
                d = d[:, None]
                idx = idx[:, None]
            core_y = d[:, -1]
            mr_all = np.maximum(np.maximum(d, core_y[:, None]),
                                self._core[idx])
            best = np.argmin(mr_all, axis=1)
            rows = np.arange(e - s)
            nn[s:e] = idx[rows, best]
            mr[s:e] = mr_all[rows, best]
        labels = self.labels_[nn].copy()
        probs = np.zeros(Y.shape[0])
        n_labels = int(labels.max()) + 1 if labels.size and labels.max() >= 0 else 0
        max_lam_arr = np.array(
            [self._cluster_max_lambda.get(lab, 0.0) for lab in range(n_labels)])
        birth_arr = np.array(
            [self._cluster_birth_lambda.get(lab, 0.0) for lab in range(n_labels)])
        with np.errstate(divide="ignore"):
            lam = np.where(mr > 0, 1.0 / np.maximum(mr, 1e-300), np.inf)
        assigned = labels >= 0
        if n_labels:
            birth = np.where(assigned, birth_arr[np.maximum(labels, 0)], 0.0)
            max_lam = np.where(assigned, max_lam_arr[np.maximum(labels, 0)], 0.0)
            # a point whose join-lambda is below the cluster's birth would
            # not have been part of it -> noise
            to_noise = assigned & np.isfinite(birth) & (lam < birth)
            labels[to_noise] = -1
            keep = assigned & ~to_noise
            probs[keep] = np.where(
                max_lam[keep] > 0,
                np.minimum(lam[keep], max_lam[keep])
                / np.maximum(max_lam[keep], 1e-300),
                1.0,
            )
        return labels, probs
