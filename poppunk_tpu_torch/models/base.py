"""ClusterFit base class and model loader.

Counterpart of poppunk_tpu/models/base.py (PopPUNK/models.py:81-280):
subsample + max-scale preprocessing on the host, artefacts
``<prefix>/<basename>_fit.npz`` + ``_fit.pkl`` with the pkl holding
``[fit_data_or_none, type_string]``, so the files are interchangeable with
the JAX package's and PopPUNK's. Every model type loads: BGMM, DBSCAN,
refine (threshold fits are refine models) and lineage, whose fit data is
``<prefix>_sparse_dists.npz`` rather than the npz.
"""

import os
import re
import sys

import numpy as np
import scipy.sparse


def load_cluster_fit(pkl_file, npz_file, out_prefix="", max_samples=100000,
                     device=None):
    """Load a fitted model (PopPUNK/models.py:81-136); its device state
    goes to ``device``."""
    from .bgmm import BGMMFit
    from .compat import tolerant_pickle_load
    from .dbscan import DBSCANFit
    from .lineage import LineageFit
    from .refine import RefineFit

    # The reference pickles live library objects (sklearn BGMM, an
    # hdbscan.HDBSCAN — models.py:341-354, 613-630); tolerant_pickle_load
    # stubs classes this environment cannot import so published PopPUNK
    # databases still open. Parameters are reconstructed from the npz.
    with open(pkl_file, "rb") as f:
        fit_object, fit_type = tolerant_pickle_load(f)

    if fit_type == "lineage":
        prefix = re.match(r"^(.+)_fit\.pkl$", os.path.basename(pkl_file))
        rank_file = os.path.join(
            os.path.dirname(pkl_file), prefix.group(1) + "_sparse_dists.npz"
        )
        fit_data = scipy.sparse.load_npz(rank_file)
    else:
        fit_data = np.load(npz_file, allow_pickle=True)

    if fit_type == "bgmm":
        sys.stderr.write("Loading BGMM 2D Gaussian model\n")
        load_obj = BGMMFit(out_prefix, max_samples, device=device)
    elif fit_type == "dbscan":
        sys.stderr.write("Loading DBSCAN model\n")
        load_obj = DBSCANFit(out_prefix, max_samples=max_samples,
                             device=device)
    elif fit_type == "refine":
        sys.stderr.write("Loading previously refined model\n")
        load_obj = RefineFit(out_prefix, device=device)
    elif fit_type == "lineage":
        sys.stderr.write("Loading lineage cluster model\n")
        load_obj = LineageFit(out_prefix, *fit_object)
    else:
        raise RuntimeError("Undefined model type: " + str(fit_type))

    load_obj.load(fit_data, fit_object)
    return load_obj


class ClusterFit:
    """Base model (PopPUNK/models.py:195-280)."""

    def __init__(self, out_prefix, default_dtype=np.float32, seed=42):
        self.outPrefix = out_prefix
        if out_prefix != "" and not os.path.isdir(out_prefix):
            os.makedirs(out_prefix, exist_ok=True)
        self.fitted = False
        self.indiv_fitted = False
        self.default_dtype = default_dtype
        self.threads = 1
        self.seed = seed  # pinned (the reference leaves this unseeded)

    def set_threads(self, threads):
        self.threads = threads

    def fit(self, X=None):
        if self.outPrefix != "" and not os.path.isdir(self.outPrefix):
            if os.path.isfile(self.outPrefix):
                raise RuntimeError(self.outPrefix + " already exists as a file")
            os.makedirs(self.outPrefix, exist_ok=True)
        if X is not None:
            self.default_dtype = X.dtype
        if getattr(self, "preprocess", False):
            rng = np.random.default_rng(self.seed)
            if X.shape[0] > self.max_samples:
                idx = rng.permutation(X.shape[0])[: self.max_samples]
                self.subsampled_X = X[idx].copy()
            else:
                self.subsampled_X = np.copy(X)
            self.scale = np.amax(self.subsampled_X, axis=0)
            self.subsampled_X /= self.scale

    def no_scale(self):
        self.scale = np.array([1, 1], dtype=self.default_dtype)

    def copy(self, prefix):
        self.outPrefix = prefix
        self.save()

    def _artefact(self, ext):
        return os.path.join(
            self.outPrefix, os.path.basename(self.outPrefix) + ext
        )

    def plot(self, X=None, y=None):
        if not self.fitted:
            raise RuntimeError("Trying to plot unfitted model")
