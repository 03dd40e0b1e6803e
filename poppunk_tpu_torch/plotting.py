"""The plots the port draws, copied from poppunk_tpu/plotting.py.

Re-implements the reference's PopPUNK/plot.py on matplotlib (Agg). Output
filenames match the reference exactly (plot.py:31-466):

- ``<p>_distanceDistribution.png``  (plot_scatter, plot.py:31)
- ``<p>_genome_lengths.png`` / ``<p>_ambiguous_base_counts.png`` (plot.py:84)
- ``<p>.pdf`` k-mer fit (plot_fit, plot.py:135)
- ``<p>.png`` model fits (plot_results / plot_dbscan_results /
  plot_refined_results, plot.py:182-372)
- ``<p>.pdf`` contours (plot_contours, plot.py:375)
- ``<p>_rank_<r>_histogram.png`` (distHistogram, plot.py:443)

Only the functions this package calls are copied; they are unchanged but
for plot_contours, whose likelihood grid is this package's
(models/bgmm.py). This package imports nothing of the JAX package.
Importing this module loads matplotlib; callers import it
inside the function that plots, so hosts without matplotlib run every
path with ``--no-plot``.
"""

import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np


def get_grid(minimum, maximum, resolution):
    """(plot.py:416-441)."""
    x = np.linspace(minimum, maximum, resolution)
    y = np.linspace(minimum, maximum, resolution)
    xx, yy = np.meshgrid(x, y)
    xy = np.vstack([yy.ravel(), xx.ravel()]).T
    return xx, yy, xy


def plot_scatter(X, out_prefix, title, kde=True):
    """Core-accessory scatter with KDE contours (plot.py:31-82)."""
    max_plot_samples = 1000000
    if X.shape[0] > max_plot_samples:
        rng = np.random.default_rng(42)
        X = X[rng.permutation(X.shape[0])[:max_plot_samples]]
    X = np.array(X, copy=True)
    scale = np.amax(X, axis=0)
    scale[scale == 0] = 1
    X /= scale

    plt.figure(figsize=(11, 8), dpi=160, facecolor="w", edgecolor="k")
    if kde:
        from sklearn.neighbors import KernelDensity

        xx, yy, xy = get_grid(0, 1, 100)
        est = KernelDensity(bandwidth=0.03, metric="euclidean",
                            kernel="epanechnikov", algorithm="ball_tree")
        est.fit(X)
        z = np.exp(est.score_samples(xy)).reshape(xx.shape).T
        levels = np.linspace(z.min(), z.max(), 10)
        plt.contour(xx * scale[0], yy * scale[1], z, levels=levels[1:],
                    cmap="plasma")
        scatter_alpha = 1
    else:
        scatter_alpha = 0.1

    plt.scatter(X[:, 0] * scale[0], X[:, 1] * scale[1], s=1,
                alpha=scatter_alpha)
    plt.title(title)
    plt.xlabel("Core distance (" + r"$\pi$" + ")")
    plt.ylabel("Accessory distance (" + r"$a$" + ")")
    plt.savefig(os.path.join(
        out_prefix, os.path.basename(out_prefix) + "_distanceDistribution.png"
    ))
    plt.close()


def plot_database_evaluations(prefix, genome_lengths, ambiguous_bases):
    """(plot.py:84-106)."""
    plot_evaluation_histogram(
        genome_lengths, prefix=prefix, suffix="genome_lengths",
        plt_title="Distribution of sequence lengths",
        xlab="Sequence length (nt)",
    )
    plot_evaluation_histogram(
        ambiguous_bases, prefix=prefix, suffix="ambiguous_base_counts",
        plt_title="Distribution of ambiguous base counts",
        xlab="Number of ambiguous bases",
    )


def plot_evaluation_histogram(input_data, n_bins=100, prefix="hist",
                              suffix="", plt_title="histogram", xlab="x"):
    """(plot.py:108-133)."""
    plt.figure(figsize=(8, 8), dpi=160, facecolor="w", edgecolor="k")
    counts, bins = np.histogram(input_data, bins=n_bins)
    plt.stairs(counts, bins, fill=True)
    plt.title(plt_title)
    plt.xlabel(xlab)
    plt.ylabel("Frequency")
    plt.savefig(os.path.join(
        prefix, os.path.basename(prefix) + "_" + suffix + ".png"
    ))
    plt.close()


def plot_fit(klist, raw_matching, raw_fit, corrected_matching, corrected_fit,
             out_prefix, title):
    """k-mer size vs log match probability with fitted line
    (plot.py:135-180)."""
    klist = np.asarray(klist)
    k_fit = np.linspace(0, klist[-1], num=100)
    raw_fit_line = (1 - raw_fit[1]) * np.power(1 - raw_fit[0], k_fit)
    corrected_fit_line = (1 - corrected_fit[1]) * np.power(
        1 - corrected_fit[0], k_fit
    )

    fig, ax = plt.subplots()
    ax.set_yscale("log")
    ax.set_xlabel("k-mer length", fontsize=9)
    ax.set_ylabel("Proportion of matches", fontsize=9)
    ax.tick_params(axis="both", which="both", labelsize=9)
    plt.tight_layout()
    plt.plot(klist, raw_matching, "o", label="Raw matching k-mer proportion")
    plt.plot(k_fit, raw_fit_line, "b-", label="Fit to raw matches")
    plt.plot(klist, corrected_matching, "mx",
             label="Corrected matching k-mer proportion")
    plt.plot(k_fit, corrected_fit_line, "m--",
             label="Fit to corrected matches")
    plt.legend(loc="upper right", prop={"size": 8})
    plt.title(title, fontsize=10)
    plt.savefig(out_prefix + ".pdf", bbox_inches="tight")
    plt.close()


_COMPONENT_PALETTE = ["navy", "c", "cornflowerblue", "gold", "darkorange"]


def _sigma_ellipse(centre, cov, colour, n_sigma2=2.0):
    """Ellipse patch covering n_sigma2 * variance of a 2x2 covariance:
    axes 2*sqrt(n_sigma2 * eigval), tilted along the first eigenvector."""
    vals, vecs = np.linalg.eigh(cov)
    theta = np.degrees(np.arctan2(vecs[1, 0], vecs[0, 0]))
    width, height = 2.0 * np.sqrt(n_sigma2 * np.maximum(vals, 0.0))
    return matplotlib.patches.Ellipse(
        centre, width, height, angle=theta, color=colour, alpha=0.5
    )


def _dist_axes(ax, title):
    ax.set_title(title)
    ax.set_xlabel("Core distance (" + r"$\pi$" + ")")
    ax.set_ylabel("Accessory distance (" + r"$a$" + ")")


def plot_results(X, Y, means, covariances, scale, title, out_prefix):
    """BGMM fit: per-component scatter plus 2-sigma covariance ellipses
    in unscaled distance space (same output contract as the reference's
    plot_results, plot.py:182-235)."""
    X = np.asarray(X)
    Y = np.asarray(Y)
    S = np.diag(scale)
    fig, ax = plt.subplots(figsize=(11, 8), dpi=160)
    occupied = [k for k in range(len(means)) if np.any(Y == k)]
    for idx, k in enumerate(occupied):
        colour = _COMPONENT_PALETTE[idx % len(_COMPONENT_PALETTE)]
        pts = X[Y == k]
        ax.scatter(pts[:, 0], pts[:, 1], s=0.4, color=colour)
        ell = _sigma_ellipse(means[k] * scale, S @ covariances[k] @ S, colour)
        ell.set_clip_box(ax.bbox)
        ax.add_artist(ell)
    _dist_axes(ax, title)
    fig.savefig(out_prefix + ".png")
    plt.close(fig)


def plot_dbscan_results(X, y, n_clusters, out_prefix):
    """HDBSCAN fit: noise in black, clusters over a spectral colormap in
    two vectorised scatter calls (output contract of the reference's
    plot_dbscan_results, plot.py:237-283)."""
    X = np.asarray(X)
    y = np.asarray(y)
    fig, ax = plt.subplots(figsize=(11, 8), dpi=160)
    noise = y == -1
    ax.scatter(X[noise, 0], X[noise, 1], s=1, color="k", marker=".")
    ax.scatter(X[~noise, 0], X[~noise, 1], s=2, c=y[~noise],
               cmap="Spectral", marker=".")
    _dist_axes(ax,
               "HDBSCAN – estimated number of spatial clusters: %d" % n_clusters)
    fig.savefig(out_prefix + ".png")
    plt.close(fig)


def plot_refined_results(X, Y, x_boundary, y_boundary, core_boundary,
                         accessory_boundary, mean0, mean1, min_move, max_move,
                         scale, threshold, indiv_boundaries, unconstrained,
                         title, out_prefix):
    """Refined fit with decision boundary and search range
    (plot.py:285-373)."""
    from .utils import decision_boundary as _db
    from .utils import transform_line

    Y = np.asarray(Y)
    plt.figure(figsize=(11, 8), dpi=160, facecolor="w", edgecolor="k")
    plt.scatter(X[Y == -1, 0], X[Y == -1, 1], 0.4, color="cornflowerblue")
    plt.scatter(X[Y == 1, 0], X[Y == 1, 1], 0.4, color="c")

    if not threshold:
        plt.plot([x_boundary * scale[0], 0], [0, y_boundary * scale[1]],
                 color="red", linewidth=2, linestyle="--",
                 label="Combined decision boundary")
        if indiv_boundaries:
            plt.plot([core_boundary * scale[0]] * 2, [0, np.amax(X[:, 1])],
                     color="darkgray", linewidth=1, linestyle="-.",
                     label="Individual decision boundaries")
            plt.plot([0, np.amax(X[:, 0])], [accessory_boundary * scale[1]] * 2,
                     color="darkgray", linewidth=1, linestyle="-.")
        if (mean0 is not None and mean1 is not None
                and min_move is not None and max_move is not None):
            mean0 = np.asarray(mean0, dtype=float)
            mean1 = np.asarray(mean1, dtype=float)
            if unconstrained:
                gradient = (mean1[1] - mean0[1]) / (mean1[0] - mean0[0])
                opt_start = np.array(_db(np.copy(mean0), gradient)) * scale
                opt_end = np.array(_db(np.copy(mean1), gradient)) * scale
                plt.fill([opt_start[0], opt_end[0], 0, 0],
                         [0, 0, opt_end[1], opt_start[1]],
                         fill=True, facecolor="lightcoral", alpha=0.2,
                         label="Search range")
            else:
                search_length = max_move + np.hypot(
                    mean1[0] - mean0[0], mean1[1] - mean0[1]
                )
                minimum_xy = transform_line(-min_move, mean0, mean1) * scale
                maximum_xy = transform_line(search_length, mean0, mean1) * scale
                plt.plot([minimum_xy[0], maximum_xy[0]],
                         [minimum_xy[1], maximum_xy[1]],
                         color="k", linewidth=1, linestyle=":",
                         label="Search range")
            m0 = mean0 * scale
            m1 = mean1 * scale
            plt.plot(m0[0], m0[1], "rx", label="Within-strain mean")
            plt.plot(m1[0], m1[1], "r+", label="Between-strain mean")
    else:
        plt.plot([core_boundary * scale[0]] * 2, [0, np.amax(X[:, 1])],
                 color="red", linewidth=2, linestyle="--",
                 label="Threshold boundary")

    plt.legend(loc="lower right")
    plt.title(title)
    plt.xlabel("Core distance (" + r"$\pi$" + ")")
    plt.ylabel("Accessory distance (" + r"$a$" + ")")
    plt.savefig(out_prefix + ".png")
    plt.close()


def plot_contours(model, assignments, title, out_prefix):
    """Mixture likelihood surface + within/between decision contour
    (plot.py:375-414), the grid's likelihood evaluated by this package's
    GaussianMixture on the model's device."""
    import torch

    from .models.bgmm import (
        GaussianMixture,
        find_between_label_bgmm,
        find_within_label,
    )

    xx, yy, xy = get_grid(0, 1, 100)
    z = model.assign(xy, values=True, progress=False)
    within = find_within_label(model.means, assignments, 0)
    between = find_between_label_bgmm(model.means, assignments)
    z_diff = (z[:, within] - z[:, between]).reshape(xx.shape).T

    mixture = model.mixture
    unit = GaussianMixture(mixture.weights, mixture.means,
                           mixture.covariances,
                           torch.ones_like(mixture.scale))
    z_ll, _ = unit.log_likelihood(
        torch.as_tensor(xy, dtype=torch.float32, device=model.device))
    z_ll = z_ll.cpu().numpy().reshape(xx.shape).T

    plt.figure(figsize=(11, 8), dpi=160, facecolor="w", edgecolor="k")
    plt.contour(xx, yy, z_ll, levels=np.linspace(z_ll.min(), z_ll.max(), 25))
    plt.contour(xx, yy, z_diff, levels=[0], colors="r", linewidths=3)
    plt.title(title)
    plt.xlabel("Scaled core distance")
    plt.ylabel("Scaled accessory distance")
    plt.savefig(out_prefix + ".pdf")
    plt.close()


def dist_histogram(dists, rank, out_prefix):
    """(distHistogram, plot.py:443-466)."""
    plt.figure(figsize=(11, 8), dpi=160, facecolor="w", edgecolor="k")
    plt.hist(dists, 50, facecolor="b", alpha=0.75)
    plt.title("Included nearest neighbour distances for rank " + str(rank))
    plt.xlabel("Distance")
    plt.ylabel("Density")
    plt.grid(True)
    plt.savefig(out_prefix + "_rank_" + str(rank) + "_histogram.png")
    plt.close()
