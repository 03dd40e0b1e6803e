"""Boundary-refinement model (refine and threshold fits).

Copied from poppunk_tpu/models/refine.py (that package loads jax on
import); it reimplements RefineFit (PopPUNK/models.py:786-1091) and the
refineFit / multi_refine optimisers (PopPUNK/refine.py:51-312):

- start line between the within/between component means of a BGMM or
  DBSCAN fit (or a manual start file);
- global 1-D search: 40 offsets along the line, one sorted boundary sweep
  (ops/boundary.py threshold_iterate_1d) scored on the model
  device (ops/device_sweep.py) or incrementally on the host
  (network/incremental.py);
- unconstrained 2-D search: 20x20 (x_max, y_max) grid, swept per y row;
- local refinement: golden-section (scipy minimize_scalar bounded) on the
  full-network score, matching refine.py:224-231;
- assignment via the sign of the signed boundary distance
  (ops/boundary.assign_threshold).

The only change from the reference's copy is the device: ``RefineFit``
takes the model device (``--gpu-model``) and hands it to the sweep.
"""

import os
import pickle
import sys
from math import sqrt

import numpy as np
import scipy.optimize

from .. import _device
from ..network.incremental import grow_network_scores
from ..ops import boundary as bops
from ..ops.device_sweep import sweep_scores_device, use_device_sweep
from ..utils import decision_boundary, transform_line
from .base import ClusterFit

BETWEENNESS_SAMPLE_DEFAULT = 100


def read_manual_start(start_file):
    """(mean0, mean1, scaled) from a manual start file
    (PopPUNK/refine.py:612-664)."""
    mean0 = mean1 = None
    scaled = True
    with open(start_file) as f:
        for line in f:
            param, value = line.rstrip().split()
            if param == "start":
                mean0 = np.array([float(v) for v in value.split(",")])
            elif param == "end":
                mean1 = np.array([float(v) for v in value.split(",")])
            elif param == "scaled":
                if value.lower() == "false":
                    scaled = False
            else:
                raise RuntimeError("Incorrectly formatted manual start file")
    if mean0 is None or mean1 is None:
        raise RuntimeError("Must set both start and end")
    if mean0.shape != (2,) or mean1.shape != (2,):
        raise RuntimeError("Wrong size for values")
    if np.any(np.hstack([mean0, mean1]) > 1) or np.any(np.hstack([mean0, mean1]) < 0):
        raise RuntimeError("Value out of range (between 0 and 1)")
    return mean0, mean1, scaled


def new_network_score(s, sample_names, dist_mat, mean0, mean1, gradient,
                      slope=2, score_idx=0, betweenness_sample=100,
                      rng=None):
    """Score of the network at boundary position s (newNetwork,
    refine.py:476-548). Returns -score."""
    new_intercept = transform_line(s, mean0, mean1)
    if slope == 2:
        x_max, y_max = decision_boundary(new_intercept, gradient)
    elif slope == 0:
        x_max, y_max = new_intercept[0], 0
    else:
        x_max, y_max = 0, new_intercept[1]
    edges = bops.edge_iterate(dist_mat, slope, x_max, y_max)
    scores = grow_network_scores(
        len(sample_names), edges[:, 0], edges[:, 1],
        np.zeros(edges.shape[0], dtype=np.int64), 1, score_idx,
        betweenness_sample, rng=rng)
    return scores[0]


def check_search_range(scale, mean0, mean1, lower_s, upper_s):
    """(refine.py:314-352)."""
    gradient = (mean1[1] - mean0[1]) / (mean1[0] - mean0[0])
    bottom_end = transform_line(lower_s, mean0, mean1)
    top_end = transform_line(upper_s, mean0, mean1)
    min_x, min_y = decision_boundary(bottom_end, gradient)
    max_x, max_y = decision_boundary(top_end, gradient)
    sys.stderr.write(
        "Searching core intercept from "
        + "{:.3f}".format(min_x * scale[0])
        + " to " + "{:.3f}".format(max_x * scale[0]) + "\n"
    )
    return (min_x, max_x), (min_y, max_y)


def refine_fit(dist_mat, sample_names, mean0, mean1, scale, max_move, min_move,
               slope=2, score_idx=0, unconstrained=False, no_local=False,
               num_processes=1, betweenness_sample=BETWEENNESS_SAMPLE_DEFAULT,
               sample_size=None, rng=None, device=None):
    """Global + local boundary optimisation (refineFit, refine.py:51-247);
    the global sweep runs on ``device`` where use_device_sweep allows.

    Returns (optimal_x, optimal_y, optimised_s).
    """
    sys.stderr.write("Trying to optimise score globally\n")
    gradient = (mean1[1] - mean0[1]) / (mean1[0] - mean0[0])

    if unconstrained:
        if slope != 2:
            raise RuntimeError("Unconstrained optimization and indiv-refine incompatible")
        global_grid_resolution = 20
        x_max_start, y_max_start = decision_boundary(np.copy(mean0), gradient, adj=-1 * min_move)
        x_max_end, y_max_end = decision_boundary(np.copy(mean1), gradient, adj=max_move)
        if x_max_start < -1e-9 or y_max_start < -1e-9:
            raise RuntimeError("Boundary range below zero")
        x_max = np.linspace(x_max_start, x_max_end, global_grid_resolution, dtype=np.float32)
        y_max = np.linspace(y_max_start, y_max_end, global_grid_resolution, dtype=np.float32)

        row_rngs = (rng.spawn(global_grid_resolution) if rng is not None
                    else [None] * global_grid_resolution)

        def score_row(y_idx):
            """One y row = one sweep over the x grid (the reference farms
            rows to a process pool, refine.py:147-166; numpy + the native
            scorer release the GIL so threads suffice here)."""
            i_vec, j_vec, idx_vec = bops.threshold_iterate_2d(
                dist_mat, x_max, float(y_max[y_idx])
            )
            if len(idx_vec) == dist_mat.shape[0]:
                return np.zeros(len(x_max))
            if use_device_sweep(len(sample_names), score_idx, device):
                return sweep_scores_device(
                    len(sample_names), i_vec, j_vec, idx_vec, len(x_max),
                    device)
            return grow_network_scores(
                len(sample_names), i_vec, j_vec, idx_vec, len(x_max),
                score_idx, betweenness_sample, rng=row_rngs[y_idx],
            )

        if num_processes > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=num_processes) as pool:
                global_s = list(pool.map(score_row, range(global_grid_resolution)))
        else:
            global_s = [score_row(y) for y in range(global_grid_resolution)]
        global_s = np.concatenate(global_s)
        global_s[np.isnan(global_s)] = 1
        min_idx = int(np.argmin(global_s))
        optimal_x = x_max[min_idx % global_grid_resolution]
        optimal_y = y_max[min_idx // global_grid_resolution]
        optimised_s = global_s[min_idx]

        if not (
            x_max_start < optimal_x < x_max_end and y_max_start < optimal_y < y_max_end
        ):
            no_local = True
        elif not no_local:
            gradient = optimal_x / optimal_y
            delta = x_max[1] - x_max[0]
            bounds = [-delta, delta]
            mean0 = np.array([optimal_x, 0])
            mean1 = np.array([optimal_x + delta, delta * gradient])
    else:
        search_length = max_move + sqrt(
            (mean1[0] - mean0[0]) ** 2 + (mean1[1] - mean0[1]) ** 2
        )
        global_grid_resolution = 40
        s_range = np.linspace(-min_move, search_length, num=global_grid_resolution)
        (min_x, max_x), (min_y, max_y) = check_search_range(
            scale, mean0, mean1, s_range[0], s_range[-1]
        )
        # tolerance: a 0,0 manual start produces -0.0/-1e-18 intercepts
        if min_x < -1e-9 or min_y < -1e-9:
            raise RuntimeError("Boundary range below zero")

        i_vec, j_vec, idx_vec = bops.threshold_iterate_1d_auto(
            dist_mat, s_range, slope, mean0[0], mean0[1], mean1[0], mean1[1]
        )
        if len(idx_vec) == dist_mat.shape[0]:
            raise RuntimeError("Boundary range includes all points")
        if use_device_sweep(len(sample_names), score_idx, device):
            global_s = sweep_scores_device(
                len(sample_names), i_vec, j_vec, idx_vec, len(s_range),
                device)
        else:
            global_s = grow_network_scores(
                len(sample_names), i_vec, j_vec, idx_vec, len(s_range),
                score_idx, betweenness_sample, rng=rng,
            )
        global_s[np.isnan(global_s)] = 1
        min_idx = int(np.argmin(global_s))
        if 0 < min_idx < len(s_range) - 1:
            bounds = [s_range[min_idx - 1], s_range[min_idx + 1]]
        else:
            no_local = True
        if no_local:
            optimised_s = s_range[min_idx]

    if not no_local:
        sys.stderr.write("Trying to optimise score locally\n")
        local_s = scipy.optimize.minimize_scalar(
            new_network_score,
            bounds=bounds,
            method="Bounded",
            options={"disp": False},
            args=(sample_names, dist_mat, mean0, mean1, gradient, slope,
                  score_idx, betweenness_sample, rng),
        )
        optimised_s = local_s.x

    if not unconstrained or not no_local:
        optimised_coor = transform_line(optimised_s, mean0, mean1)
        if slope == 2:
            optimal_x, optimal_y = decision_boundary(optimised_coor, gradient)
            if optimal_x < 0 or optimal_y < 0:
                raise RuntimeError(
                    "Optimisation failed: produced a boundary outside of allowed range"
                )
        else:
            optimal_x, optimal_y = optimised_coor[0], optimised_coor[1]
            if (slope == 0 and optimal_x < 0) or (slope == 1 and optimal_y < 0):
                raise RuntimeError(
                    "Optimisation failed: produced a boundary outside of allowed range"
                )

    return optimal_x, optimal_y, optimised_s


def multi_refine(dist_mat, sample_names, mean0, mean1, scale, s_max,
                 n_boundary_points, output_prefix, score_idx=0,
                 betweenness_sample=BETWEENNESS_SAMPLE_DEFAULT, rng=None):
    """Cluster outputs at boundary positions from the optimum toward the
    axes (refine.py:249-312)."""
    gradient = (mean1[1] - mean0[1]) / (mean1[0] - mean0[0])
    if mean0[1] >= gradient * mean0[0]:
        s_min = -mean0[0] * sqrt(1 + gradient * gradient)
    else:
        s_min = -mean0[1] * sqrt(1 + 1 / (gradient * gradient))
    s_range = np.linspace(s_min, s_max, num=n_boundary_points)
    check_search_range(scale, mean0, mean1, s_range[0], s_range[-1])
    i_vec, j_vec, idx_vec = bops.threshold_iterate_1d(
        dist_mat, s_range, 2, mean0[0], mean0[1], mean1[0], mean1[1]
    )
    grow_network_scores(
        len(sample_names), i_vec, j_vec, idx_vec, len(s_range),
        score_idx, betweenness_sample,
        write_clusters=output_prefix, sample_names=sample_names, rng=rng,
    )


class RefineFit(ClusterFit):
    def __init__(self, out_prefix, seed=42, device=None):
        ClusterFit.__init__(self, out_prefix, seed=seed)
        # where the global sweep runs: the card, or the host for a CPU device
        self.device = _device.resolve(device)
        self.type = "refine"
        self.preprocess = False
        self.within_label = -1
        self.slope = 2
        self.threshold = False
        self.unconstrained = False
        self.assign_points = True

    def fit(self, X, sample_names, model, max_move, min_move, startFile=None,
            indiv_refine=None, unconstrained=False, multi_boundary=0,
            score_idx=0, no_local=False,
            betweenness_sample=BETWEENNESS_SAMPLE_DEFAULT, sample_size=None):
        ClusterFit.fit(self)
        self.scale = np.copy(model.scale)
        self.max_move = max_move
        self.min_move = min_move
        self.unconstrained = unconstrained

        model.no_scale()
        if startFile:
            self.mean0, self.mean1, scaled = read_manual_start(startFile)
            if not scaled:
                self.mean0 /= self.scale
                self.mean1 /= self.scale
        elif model.type == "dbscan":
            sys.stderr.write("Initial model-based network construction based on DBSCAN fit\n")
            self.mean0 = model.cluster_means[model.within_label, :]
            self.mean1 = model.cluster_means[model.between_label, :]
        elif model.type == "bgmm":
            sys.stderr.write("Initial model-based network construction based on Gaussian fit\n")
            self.mean0 = model.means[model.within_label, :]
            self.mean1 = model.means[model.between_label, :]
        else:
            raise RuntimeError("Unrecognised model type")

        rng = np.random.default_rng(self.seed)
        scaled_X = X / self.scale
        self.optimal_x, self.optimal_y, optimal_s = refine_fit(
            scaled_X, sample_names, self.mean0, self.mean1, self.scale,
            self.max_move, self.min_move, slope=2, score_idx=score_idx,
            unconstrained=unconstrained, no_local=no_local,
            num_processes=self.threads,
            betweenness_sample=betweenness_sample, sample_size=sample_size,
            rng=rng, device=self.device,
        )
        self.fitted = True

        if multi_boundary > 1:
            sys.stderr.write("Creating multiple boundary fits\n")
            multi_refine(
                scaled_X, sample_names, self.mean0, self.mean1, self.scale,
                optimal_s, multi_boundary, self.outPrefix,
                betweenness_sample=betweenness_sample, rng=rng,
            )

        self.core_boundary = self.optimal_x
        self.accessory_boundary = self.optimal_y
        if indiv_refine is not None:
            try:
                for dist_type, slope in zip(["core", "accessory"], [0, 1]):
                    if indiv_refine in ("both", dist_type):
                        sys.stderr.write(f"Refining {dist_type} distances separately\n")
                        core_b, acc_b, _ = refine_fit(
                            scaled_X, sample_names, self.mean0, self.mean1,
                            self.scale, self.max_move, self.min_move,
                            slope=slope, score_idx=score_idx,
                            no_local=no_local,
                            betweenness_sample=betweenness_sample,
                            sample_size=sample_size, rng=rng,
                            device=self.device,
                        )
                        if dist_type == "core":
                            self.core_boundary = core_b
                        else:
                            self.accessory_boundary = acc_b
                self.indiv_fitted = True
            except RuntimeError as e:
                sys.stderr.write(
                    f"{e}\nCould not separately refine core and accessory boundaries. "
                    "Using joint 2D refinement only.\n"
                )
        return self.assign(X)

    def apply_threshold(self, X, threshold):
        """(models.py:956-994)."""
        self.scale = np.array([1, 1], dtype=X.dtype)
        self.mean0 = self.mean1 = None
        self.min_move = self.max_move = None
        self.core_boundary = threshold
        self.accessory_boundary = np.nan
        self.optimal_x = threshold
        self.optimal_y = np.nan
        self.slope = 0
        self.fitted = True
        self.threshold = True
        self.indiv_fitted = False
        self.unconstrained = False
        return self.assign(X)

    def assign(self, X, slope=None):
        if not self.fitted:
            raise RuntimeError("Trying to assign using an unfitted model")
        if slope is None:
            slope = self.slope
        Xs = X / self.scale
        if slope == 2:
            return bops.assign_threshold(Xs, 2, self.optimal_x, self.optimal_y)
        elif slope == 0:
            return bops.assign_threshold(Xs, 0, self.core_boundary, 0)
        return bops.assign_threshold(Xs, 1, 0, self.accessory_boundary)

    def save(self):
        if not self.fitted:
            raise RuntimeError("Trying to save unfitted model")
        np.savez(
            self._artefact("_fit.npz"),
            intercept=np.array([self.optimal_x, self.optimal_y]),
            core_acc_intercepts=np.array([self.core_boundary, self.accessory_boundary]),
            scale=self.scale,
            indiv_fitted=self.indiv_fitted,
        )
        with open(self._artefact("_fit.pkl"), "wb") as f:
            pickle.dump([None, self.type], f)

    def load(self, fit_npz, fit_obj):
        self.optimal_x = fit_npz["intercept"].item(0)
        self.optimal_y = fit_npz["intercept"].item(1)
        self.core_boundary = fit_npz["core_acc_intercepts"].item(0)
        self.accessory_boundary = fit_npz["core_acc_intercepts"].item(1)
        self.scale = fit_npz["scale"]
        self.fitted = True
        self.indiv_fitted = bool(fit_npz["indiv_fitted"]) if "indiv_fitted" in fit_npz else False
        if np.isnan(self.optimal_y) and np.isnan(self.accessory_boundary):
            self.threshold = True
            self.slope = 0
        self.mean0 = self.mean1 = None
        self.min_move = self.max_move = None

    def plot(self, X, y=None):
        ClusterFit.plot(self, X)
        try:
            from ..plotting import plot_refined_results

            plot_refined_results(
                X, self.assign(X), self.optimal_x, self.optimal_y,
                self.core_boundary, self.accessory_boundary, self.mean0,
                self.mean1, self.min_move, self.max_move, self.scale,
                self.threshold, self.indiv_fitted, self.unconstrained,
                "Refined fit boundary", self._artefact("_refined_fit"),
            )
        except Exception as e:
            sys.stderr.write(f"Plotting failed: {e}\n")
