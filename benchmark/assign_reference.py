"""The plain reference of GPSC typing: ``--stable core`` assignment of new
genomes against a reference database, from the benchmark's own inputs.

Plain PyTorch and numpy, importing nothing of the program (nor JAX). The
distances are ``reference.block_distances`` (PopPUNK's published
definitions) of each query against every reference; what assignment
derives from them is written here from PopPUNK's ``--stable`` mode
(``assign.py``: each query's nearest reference on the core distance, and
that reference's cluster if the fitted model calls the pair
within-strain, else "NA"):

    nearest   the reference of least core distance; on ties the first in
              the database's order, as ``np.argmin``
    class     of the (query, nearest) pair: the BGMM component of highest
              posterior, weight_c N(d / scale; mean_c, cov_c), from the
              saved fit's own parameters (``_fit.npz``: weights, means,
              covariances, scale, within), in float64
    answer    the nearest reference's cluster if the class is the fit's
              within-strain component, else "NA"

Departures from PopPUNK's ``--stable``: the distances are float64 here
(PopPUNK's sketch library computes float32); the query sketches' QC is not
run (the session answers every query); every reference of the database is
served (no ``.refs`` subset); the clusters are the ones the harness wrote
(each reference's strain), not a network fit's.

``precision`` ("float64", "tf32", "bfloat16") is the distances'
arithmetic, as in ``reference.py``; the controls take the lower two. The
classification is float64 in every precision.
"""

import numpy as np
import torch

from . import reference

# the distances' tolerance inside label_wrong: the create-db cell's
# dist_gap limit, 23x the program's widest departure from float64 there
DIST_TOL = 1e-4
# points of each axis of the square within DIST_TOL of a pair on which
# its class is evaluated to find pairs near the BGMM decision
BOX_POINTS = 5


def reference_distances(planes_q, planes_r, len_q, len_r, freq_q, freq_r,
                        cfg, precision="float64", block=8):
    """(core, accessory) [nq, nr, 2] float64 numpy of every query against
    every reference, with TF32 off for any matmul torch runs."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return reference.block_distances(planes_q, planes_r, len_q, len_r,
                                         freq_q, freq_r, cfg, precision,
                                         block)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


class Fit:
    """A saved BGMM fit's parameters, read from its ``_fit.npz``."""

    def __init__(self, npz_path):
        with np.load(npz_path) as f:
            self.weights = np.asarray(f["weights"], np.float64)
            self.means = np.asarray(f["means"], np.float64)
            self.covariances = np.asarray(f["covariances"], np.float64)
            self.scale = np.asarray(f["scale"], np.float64)
            self.within = int(f["within"])
        self._inv = np.linalg.inv(self.covariances)
        self._log_norm = (np.log(self.weights)
                          - 0.5 * np.log(np.linalg.det(
                              2 * np.pi * self.covariances)))

    def within_pair(self, d):
        """bool [...]: pairs of (core, accessory) [..., 2] whose component
        of highest posterior is the within-strain one."""
        x = np.asarray(d, np.float64)[..., None, :] / self.scale
        diff = x - self.means
        maha = np.einsum("...ki,kij,...kj->...k", diff, self._inv, diff)
        return np.argmax(self._log_norm - 0.5 * maha, -1) == self.within


def answers(dists, fit, clusters):
    """(answer, nearest index) of each query from its distances [nq, nr,
    2]: ``clusters`` [nr] the references' cluster names."""
    nearest = np.argmin(dists[..., 0], axis=1)
    pair = dists[np.arange(len(nearest)), nearest]
    within = fit.within_pair(pair)
    answer = np.where(within, np.asarray(clusters, object)[nearest], "NA")
    return answer, nearest


def ambiguous(dists, fit, clusters, tol=DIST_TOL):
    """bool [nq]: queries whose answer DIST_TOL in each distance could
    change: a reference within ``tol`` of the least core distance that
    would answer otherwise (another cluster, or another class), or a pair
    of those references whose class changes within ``tol`` of its
    distances (on a BOX_POINTS x BOX_POINTS grid of the square)."""
    core = dists[..., 0]
    near = core <= core.min(axis=1, keepdims=True) + tol
    steps = np.linspace(-tol, tol, BOX_POINTS)
    box = np.stack(np.meshgrid(steps, steps, indexing="ij"), -1).reshape(-1, 2)
    out = np.zeros(len(dists), bool)
    clusters = np.asarray(clusters, object)
    for q in range(len(dists)):
        refs = np.flatnonzero(near[q])
        within = fit.within_pair(dists[q, refs][:, None, :] + box)
        said = {clusters[r] if w else "NA"
                for r, row in zip(refs, within) for w in row}
        out[q] = len(said) > 1
    return out
