"""DBSCAN model (HDBSCAN over the 2-D distance cloud).

Counterpart of poppunk_tpu/models/dbscan.py, which reimplements DBSCANFit
(PopPUNK/models.py:467-783) and the dbscan helpers (PopPUNK/dbscan.py) on
top of a from-scratch HDBSCAN (ops/hdbscan.py):

- parameter cascade: min_samples from min_cluster_prop (>=10, <=1023),
  min_cluster_size 1% (>=10), halving until the within/between clusters
  are distinct (models.py:516-600);
- within = cluster nearest origin, between = most-assigned other cluster;
- distinctness check per evaluate_dbscan_clusters (dbscan.py:69-96);
- assignment via approximate_predict, batched;
- artefacts: _fit.npz (n_clusters/within/between/means/maxs/mins/scale) +
  _fit.pkl carrying the fitted HDBSCAN object (models.py:613-629).

A copy of the JAX package's module but for ``DBSCANFit``, which takes the
model device (``--gpu-model``): the HDBSCAN fits of the cascade run their
Boruvka sweep there (ops/hdbscan.py). Assignment, the decision grid and
the artefacts are the JAX package's host code; a fit written by either
package loads in the other.
"""

import pickle
import sys

import numpy as np

from .. import _device
from ..ops.hdbscan import HDBSCAN
from .base import ClusterFit
from .bgmm import find_within_label


def find_between_label(assignments, within_cluster):
    """Most-assigned cluster that is not within/noise
    (PopPUNK/dbscan.py:98-123)."""
    assignments = [a for a in np.asarray(assignments).tolist()
                   if a != within_cluster and a != -1]
    if not assignments:
        raise RuntimeError("No between-strain cluster found")
    return max(set(assignments), key=assignments.count)


def evaluate_dbscan_clusters(model):
    """True if within/between clusters overlap (indistinct)
    (PopPUNK/dbscan.py:69-96)."""
    core_min_between = model.cluster_mins[model.between_label, 0]
    core_max_within = model.cluster_maxs[model.within_label, 0]
    acc_min_between = model.cluster_mins[model.between_label, 1]
    acc_max_within = model.cluster_maxs[model.within_label, 1]
    return not (
        core_min_between > core_max_within or acc_min_between > acc_max_within
    )


class _UnloadablePredictor:
    """Stands in for a foreign DBSCAN fit whose pickle carried no
    training data: loading succeeds (within/between labels and cluster
    boxes come from the npz) but assigning new points raises with a
    actionable message instead of an unpickling crash."""

    def __init__(self, desc):
        self._desc = desc

    def approximate_predict(self, *_a, **_k):
        raise RuntimeError(
            "This DBSCAN model was written by another PopPUNK build and "
            f"its pickle ({self._desc}) carries no training data; re-fit "
            "the model (--fit-model dbscan) or refine it (--fit-model "
            "refine) before assigning new distances")


class DBSCANFit(ClusterFit):
    def __init__(self, out_prefix, max_batch_size=5000, max_samples=100000,
                 assign_points=True, seed=42, grid_assign=False, device=None,
                 **_ignored):
        ClusterFit.__init__(self, out_prefix, seed=seed)
        self.type = "dbscan"
        self.preprocess = True
        self.max_batch_size = max_batch_size
        self.max_samples = max_samples
        self.assign_points = assign_points
        self.grid_assign = grid_assign
        self.device = _device.resolve(device)

    def fit(self, X, max_num_clusters, min_cluster_prop):
        ClusterFit.fit(self, X)
        min_samples = max(int(min_cluster_prop * self.subsampled_X.shape[0]), 10)
        min_samples = min(min_samples, 1023)
        min_cluster_size = max(int(0.01 * self.subsampled_X.shape[0]), 10)

        indistinct = True
        # cascade matches models.py:542 exactly
        while indistinct and min_cluster_size >= min_samples and min_samples >= 10:
            sys.stderr.write(
                f"Fitting HDBSCAN (min_samples={min_samples}, "
                f"min_cluster_size={min_cluster_size})\n"
            )
            self.hdb = HDBSCAN(
                min_samples=min_samples, min_cluster_size=min_cluster_size,
                device=self.device,
            ).fit(self.subsampled_X)
            self.labels = self.hdb.labels_
            self.n_clusters = len(set(self.labels.tolist())) - (
                1 if -1 in self.labels else 0
            )
            self.fitted = True

            if 1 < self.n_clusters <= max_num_clusters:
                self.max_cluster_num = int(self.labels.max())
                self.cluster_means = np.zeros((self.n_clusters, 2))
                self.cluster_mins = np.zeros((self.n_clusters, 2))
                self.cluster_maxs = np.zeros((self.n_clusters, 2))
                for i in range(self.max_cluster_num + 1):
                    member = self.labels == i
                    self.cluster_means[i] = self.subsampled_X[member].mean(axis=0)
                    self.cluster_mins[i] = self.subsampled_X[member].min(axis=0)
                    self.cluster_maxs[i] = self.subsampled_X[member].max(axis=0)
                y = self.assign(self.subsampled_X, no_scale=True, progress=False,
                                max_batch_size=self.subsampled_X.shape[0])
                self.within_label = find_within_label(self.cluster_means, y)
                self.between_label = find_between_label(y, self.within_label)
                indistinct = evaluate_dbscan_clusters(self)

            if min_cluster_size < min_samples / 2:
                min_samples = min_samples // 10
            min_cluster_size = int(min_cluster_size / 2)

        if indistinct:
            self.fitted = False
            raise RuntimeError("Failed to find distinct clusters in this dataset")

        if self.assign_points:
            y = self.assign(X, max_batch_size=self.max_batch_size,
                            use_grid=self.grid_assign)
        else:
            y = self.assign(self.subsampled_X * self.scale,
                            max_batch_size=self.max_batch_size,
                            use_grid=self.grid_assign)
        return y

    def assign(self, X, no_scale=False, progress=True, max_batch_size=5000,
               use_grid=False, grid_resolution=1024):
        """Cluster label per pair (reference PopPUNK/models.py:192
        approximate_predict semantics).

        use_grid routes bulk assignment through the quantised decision
        grid (decision_grid, the serving path's lookup): ~100x the exact
        host predict, exact wherever a pair sits more than half a cell
        from a decision boundary. Opt-in (--dbscan-grid-assign) because
        labels can flip within that half-cell band."""
        if not self.fitted:
            raise RuntimeError("Trying to assign using an unfitted model")
        scale = np.array([1, 1], dtype=X.dtype) if no_scale else self.scale
        if use_grid:
            grid, x0, dx, y0, dy = self.decision_grid(grid_resolution)
            if progress:
                sys.stderr.write("Assigning distances with DBSCAN model "
                                 f"(decision grid {grid_resolution})\n")
            res = grid.shape[0]
            Xs = X / scale
            # same cell math as ops/fused_assign._dbscan_grid_label
            ix = np.clip(((Xs[:, 0] - x0) / dx).astype(np.int64), 0,
                         res - 1)
            iy = np.clip(((Xs[:, 1] - y0) / dy).astype(np.int64), 0,
                         res - 1)
            return grid[ix, iy].astype(int)
        if progress:
            sys.stderr.write("Assigning distances with DBSCAN model\n")
        outs = []
        for start in range(0, X.shape[0], max_batch_size):
            chunk = X[start : start + max_batch_size] / scale
            outs.append(self.hdb.approximate_predict(chunk)[0])
        return np.concatenate(outs).astype(int)

    def decision_grid(self, resolution=1024, pad_frac=1.0):
        """Quantised approximate_predict over scaled distance space, for
        the fused serving path (serve.py): labels int16[res, res] at cell
        centres, plus the (x0, dx, y0, dy) affine mapping a scaled point
        to its cell. Exact wherever a pair sits more than half a cell from
        a decision boundary; the grid extends pad_frac beyond the fitted
        range so out-of-range points resolve like far points (noise).

        Cached per (fitted model, resolution): the 1M-point exact predict
        is the expensive part and both the serving path and bulk
        grid-assign want the same grid. fit() replaces self.hdb, and the
        cache keys on its identity, so a refit never serves stale
        labels."""
        cached = getattr(self, "_grid_cache", None)
        if (cached is not None and cached[0] is self.hdb
                and cached[1] == (resolution, pad_frac)):
            return cached[2]
        hi = np.asarray(self.hdb._X).max(axis=0) * (1.0 + pad_frac)
        lo = np.zeros(2)
        dx = (hi[0] - lo[0]) / resolution
        dy = (hi[1] - lo[1]) / resolution
        xc = lo[0] + (np.arange(resolution) + 0.5) * dx
        yc = lo[1] + (np.arange(resolution) + 0.5) * dy
        xx, yy = np.meshgrid(xc, yc, indexing="ij")
        pts = np.stack([xx.ravel(), yy.ravel()], axis=1)
        labels = self.hdb.approximate_predict(pts)[0]
        # int16, not int8: --D has no upper bound and >= 128 clusters
        # would wrap to garbage/negative (noise-like) ids
        grid = labels.reshape(resolution, resolution).astype(np.int16)
        out = (grid, float(lo[0]), float(dx), float(lo[1]), float(dy))
        self._grid_cache = (self.hdb, (resolution, pad_frac), out)
        return out

    def save(self):
        if not self.fitted:
            raise RuntimeError("Trying to save unfitted model")
        np.savez(
            self._artefact("_fit.npz"),
            n_clusters=self.n_clusters,
            within=self.within_label,
            between=self.between_label,
            means=self.cluster_means,
            maxs=self.cluster_maxs,
            mins=self.cluster_mins,
            scale=self.scale,
            assign_points=self.assign_points,
        )
        with open(self._artefact("_fit.pkl"), "wb") as f:
            pickle.dump([self.hdb, self.type], f)

    def load(self, fit_npz, fit_obj):
        from .compat import is_foreign, rebuild_hdbscan_from_state

        if is_foreign(fit_obj):
            # a reference-written pickle (an hdbscan.HDBSCAN we could not
            # import): rebuild a working predictor from its stored state
            rebuilt = rebuild_hdbscan_from_state(fit_obj.__dict__)
            if rebuilt is None:
                sys.stderr.write(
                    "Foreign DBSCAN fit lacks training data; only "
                    "npz-derived parameters (within/between labels, "
                    "cluster boxes) are available — re-fit or refine "
                    "before assigning new distances\n")
                self.hdb = _UnloadablePredictor(repr(fit_obj))
                self.labels = np.asarray(
                    fit_obj.__dict__.get("labels_", []), dtype=np.int64)
            else:
                self.hdb = rebuilt
                self.labels = rebuilt.labels_
        else:
            self.hdb = fit_obj
            self.labels = self.hdb.labels_
        self.n_clusters = int(fit_npz["n_clusters"])
        self.scale = fit_npz["scale"]
        self.within_label = int(fit_npz["within"])
        self.between_label = int(fit_npz["between"])
        self.cluster_means = fit_npz["means"]
        self.cluster_maxs = fit_npz["maxs"]
        self.cluster_mins = fit_npz["mins"]
        self.assign_points = bool(fit_npz["assign_points"]) if "assign_points" in fit_npz else True
        self.fitted = True

    def plot(self, X=None, y=None):
        ClusterFit.plot(self, X)
        sys.stderr.write(
            "Fit summary:\n\tNumber of clusters\t" + str(self.n_clusters)
            + "\n\tNumber of datapoints\t" + str(self.subsampled_X.shape[0] if hasattr(self, "subsampled_X") else 0)
            + "\n"
        )
        try:
            from ..plotting import plot_dbscan_results

            plot_dbscan_results(
                self.subsampled_X * self.scale,
                self.assign(self.subsampled_X, no_scale=True, progress=False,
                            max_batch_size=self.subsampled_X.shape[0]),
                self.n_clusters,
                self._artefact("_dbscan"),
            )
        except Exception as e:
            sys.stderr.write(f"Plotting failed: {e}\n")
