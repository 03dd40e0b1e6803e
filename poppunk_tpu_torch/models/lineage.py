"""Lineage (sparse kNN) model.

Reimplements LineageFit (PopPUNK/models.py:1110-1389): fit keeps the
``max_search_depth`` nearest neighbours per sample from the chosen distance
column, per-rank structures come from lower_rank filtering, assignment
returns the COO entries as network edges, and extend() merges query blocks
for --update-db. Artefacts: ``_sparse_dists.npz`` (full-depth kNN) +
``_rank_<k>_fit.npz`` per rank (scipy COO, models.py:1240-1263).

Copied from ``poppunk_tpu/models/lineage.py``, whose counterpart it is:
the fit is host numpy (ops/sparse_knn.py), and the query-query distances
that ``extend`` takes come from the caller's distance pass on the card.
"""

import os
import pickle
import sys

import numpy as np
import scipy.sparse

from ..ops.sparse_knn import extend as knn_extend
from ..ops.sparse_knn import knn_from_condensed, lower_rank
from ..pairs import condensed_to_square
from .base import ClusterFit

EPSILON = 1e-10


def rank_file(rank):
    return "_rank_" + str(rank) + "_fit.npz"


class LineageFit(ClusterFit):
    def __init__(self, out_prefix, ranks, max_search_depth, reciprocal_only,
                 count_unique_distances, lineage_resolution, dist_col=None,
                 seed=42, **_ignored):
        ClusterFit.__init__(self, out_prefix, seed=seed)
        self.type = "lineage"
        self.preprocess = False
        max_rank = max(ranks)
        self.max_search_depth = max(max_search_depth, max_rank + 5)
        self.nn_dists = None
        self.ranks = []
        for rank in sorted(ranks):
            if rank < 1:
                raise ValueError("Rank must be at least 1")
            self.ranks.append(int(rank))
        self.lower_rank_dists = {}
        self.reciprocal_only = reciprocal_only
        self.count_unique_distances = count_unique_distances
        self.dist_col = dist_col
        self.resolution = lineage_resolution

    def __save_sparse__(self, data, row, col, rank, n_samples, dtype,
                        is_nn_dist=False):
        data = np.array(data)
        data[data < EPSILON] = EPSILON
        mat = scipy.sparse.coo_matrix(
            (data, (row, col)), shape=(n_samples, n_samples), dtype=dtype
        )
        if is_nn_dist:
            self.nn_dists = mat
        else:
            self.lower_rank_dists[rank] = mat

    def _reduce_rank(self, higher, rank, n_samples, dtype):
        if (rank == self.max_search_depth and not self.reciprocal_only
                and not self.count_unique_distances):
            row, col, data = higher
            self.__save_sparse__(data, row, col, rank, n_samples, dtype)
        else:
            row, col, data = lower_rank(
                higher, n_samples, rank, self.reciprocal_only,
                self.count_unique_distances, self.resolution,
            )
            self.__save_sparse__(data, row, col, rank, n_samples, dtype)

    @classmethod
    def from_knn(cls, out_prefix, ranks, knn_triple, n_samples,
                 search_depth, dist_col=0, reciprocal_only=False,
                 count_unique_distances=False,
                 lineage_resolution=EPSILON):
        """Build a fitted LineageFit directly from a kNN triple
        (row, col, data) — the streaming scale tier accumulates the kNN
        inside the distance pass (poppunk_tpu/scale.py), so the model
        never sees a condensed matrix. knn_triple must hold each row's
        ``search_depth`` nearest neighbours (ties to the lowest index,
        knn_from_condensed order); artefacts and extend() semantics then
        match a from-scratch fit of the same depth."""
        model = cls(out_prefix, ranks, search_depth, reciprocal_only,
                    count_unique_distances, lineage_resolution,
                    dist_col=dist_col)
        if max(model.ranks) >= n_samples:
            raise ValueError(
                "Maximum rank must be less than the number of samples: "
                + str(n_samples))
        # like fit(): the physical depth is capped at n-1 neighbours
        if search_depth < min(model.max_search_depth, n_samples - 1):
            raise ValueError(
                f"kNN depth {search_depth} is below the required search "
                f"depth {min(model.max_search_depth, n_samples - 1)}")
        row, col, data = knn_triple
        data = np.asarray(data, np.float32)
        model.__save_sparse__(data, row, col, search_depth, n_samples,
                              data.dtype, is_nn_dist=True)
        for rank in model.ranks:
            model._reduce_rank((np.asarray(row), np.asarray(col), data),
                               rank, n_samples, data.dtype)
        model.fitted = True
        return model

    def fit(self, X):
        ClusterFit.fit(self, X)
        sample_size = int(round(0.5 * (1 + np.sqrt(1 + 8 * X.shape[0]))))
        if max(self.ranks) >= sample_size:
            raise ValueError(
                "Maximum rank must be less than the number of samples: "
                + str(sample_size)
            )
        search_depth = min(self.max_search_depth, sample_size - 1)
        row, col, data = knn_from_condensed(
            X[:, self.dist_col], sample_size, search_depth)
        self.__save_sparse__(data, row, col, search_depth, sample_size,
                             X.dtype, is_nn_dist=True)
        for rank in self.ranks:
            self._reduce_rank((row, col, data), rank, sample_size, X.dtype)
        self.fitted = True
        return self.assign(min(self.ranks))

    def save(self):
        if not self.fitted:
            raise RuntimeError("Trying to save unfitted model")
        scipy.sparse.save_npz(self._artefact("_sparse_dists.npz"), self.nn_dists)
        for rank in self.ranks:
            scipy.sparse.save_npz(
                self._artefact(rank_file(rank)), self.lower_rank_dists[rank]
            )
        with open(self._artefact("_fit.pkl"), "wb") as f:
            pickle.dump(
                [
                    [self.ranks, self.max_search_depth, self.reciprocal_only,
                     self.count_unique_distances, self.dist_col, self.resolution],
                    self.type,
                ],
                f,
            )

    def load(self, fit_npz, fit_obj):
        (self.ranks, self.max_search_depth, self.reciprocal_only,
         self.count_unique_distances, self.dist_col, self.resolution) = fit_obj
        self.nn_dists = fit_npz.tocoo() if scipy.sparse.issparse(fit_npz) else fit_npz
        # per-rank structures are recomputed from the full-depth kNN (the
        # reference reloads _rank_k_fit.npz files; recomputing guarantees
        # consistency regardless of where the artefacts were relocated)
        self.fitted = True
        nn = self.nn_dists.tocoo()
        higher = (nn.row, nn.col, nn.data)
        for rank in self.ranks:
            self._reduce_rank(higher, rank, nn.shape[0], nn.data.dtype)

    def assign(self, rank):
        """Edges (row, col) of the rank fit (models.py:1301-1320)."""
        if not self.fitted:
            raise RuntimeError("Trying to assign using an unfitted model")
        mat = self.lower_rank_dists[rank]
        return list(zip(mat.row.tolist(), mat.col.tolist()))

    def edge_weights(self, rank):
        if not self.fitted:
            raise RuntimeError("Trying to get weights from an unfitted model")
        return self.lower_rank_dists[rank].data

    def extend(self, qq_dists, qr_dists):
        """Merge query distances into the kNN structure
        (models.py:1337-1389)."""
        qq_square = condensed_to_square(
            np.maximum(qq_dists[:, self.dist_col], EPSILON),
            int(round(0.5 * (1 + np.sqrt(1 + 8 * qq_dists.shape[0])))) if qq_dists.shape[0] else 0,
        ) if qq_dists.shape[0] else np.zeros((1, 1), dtype=np.float32)

        n_ref = self.nn_dists.shape[0]
        if qq_dists.shape[0]:
            n_query = qq_square.shape[1]
        else:
            n_query = qr_dists.shape[0] // n_ref
            qq_square = np.zeros((n_query, n_query), dtype=np.float32)
        qr_rect = np.maximum(
            qr_dists[:, self.dist_col].reshape(n_query, n_ref).T, EPSILON
        )
        nn = self.nn_dists.tocoo()
        higher = knn_extend(
            (nn.row, nn.col, nn.data), qq_square, qr_rect, self.max_search_depth
        )
        self.__save_sparse__(higher[2], higher[0], higher[1],
                             self.max_search_depth, n_ref + n_query,
                             nn.data.dtype, is_nn_dist=True)
        for rank in self.ranks:
            self._reduce_rank(higher, rank, n_ref + n_query, nn.data.dtype)
        return self.assign(min(self.ranks))

    def plot(self, X, y=None):
        ClusterFit.plot(self, X)
        try:
            from ..plotting import dist_histogram

            for rank in self.ranks:
                dist_histogram(
                    self.lower_rank_dists[rank].data, rank,
                    os.path.join(self.outPrefix, os.path.basename(self.outPrefix)),
                )
        except Exception as e:
            sys.stderr.write(f"Plotting failed: {e}\n")
