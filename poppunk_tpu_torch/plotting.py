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
- ``<p>_mst_stress_plot.png`` / ``<p>_mst_cluster_plot.png`` (drawMST)
- cluster CSVs for microreact/phandango/grapetree/cytoscape
  (writeClusterCsv, plot.py:598-758) and the per-tool output bundles
  (plot.py:512-1005).

The functions are copies, unchanged but for plot_contours, whose
likelihood grid is this package's (models/bgmm.py),
outputs_for_microreact, which passes the embedding its device, and
draw_mst, which raises before its layout when matplotlib is absent. This
package imports nothing of the JAX package. The exports need no
matplotlib: on a host without it this module imports, and every plot
(``draw_mst`` included) raises ModuleNotFoundError when called.
"""

import os
import sys
from collections import defaultdict

import numpy as np
import pandas as pd

from .utils import isolate_name_to_label


class _Missing:
    """Stands in for an absent module: any use raises its import error."""

    def __init__(self, error):
        self.error = error

    def __getattr__(self, name):
        raise self.error


try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ModuleNotFoundError as missing:
    matplotlib = plt = _Missing(missing)


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


def spring_layout(n, edges, iterations=60, seed=42):
    """Fruchterman–Reingold force layout in numpy (replaces gt.sfdp_layout
    for MST drawing)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 2))
    if n <= 1:
        return pos
    k = 1.0 / np.sqrt(n)
    t = 0.1
    dt = t / (iterations + 1)
    src = edges[:, 0]
    dst = edges[:, 1]
    # above this size exact all-pairs repulsion (O(n^2)/iteration) gives way
    # to a sampled estimate
    max_exact = 3000
    for _ in range(iterations):
        if n <= max_exact:
            others = pos
            scale_rep = 1.0
        else:
            idx = rng.integers(0, n, max_exact)
            others = pos[idx]
            scale_rep = n / max_exact
        delta = pos[:, None, :] - others[None, :, :]
        dist = np.maximum(np.linalg.norm(delta, axis=-1), 0.01)
        force = (k * k / dist ** 2)[:, :, None] * delta  # repulsion
        disp = force.sum(axis=1) * scale_rep
        # attraction along edges
        edelta = pos[src] - pos[dst]
        edist = np.maximum(np.linalg.norm(edelta, axis=-1), 0.01)
        pull = (edist / k)[:, None] * edelta / edist[:, None]
        np.add.at(disp, src, -pull)
        np.add.at(disp, dst, pull)
        length = np.maximum(np.linalg.norm(disp, axis=-1), 0.01)
        pos += disp / length[:, None] * np.minimum(length, t)[:, None]
        t -= dt
    return pos


def draw_mst(mst, out_prefix, isolate_clustering, clustering_name, overwrite):
    """MST stress and cluster plots (drawMST, plot.py:468-510).

    ``mst`` is our network.Graph with a ``vertex_labels`` attribute set by
    the caller (list of isolate names in vertex order).
    """
    graph1 = os.path.join(
        out_prefix, os.path.basename(out_prefix) + "_mst_stress_plot.png"
    )
    graph2 = os.path.join(
        out_prefix, os.path.basename(out_prefix) + "_mst_cluster_plot.png"
    )
    if not overwrite and os.path.isfile(graph1) and os.path.isfile(graph2):
        return
    if isinstance(plt, _Missing):
        # before the layout, which takes minutes at thousands of vertices
        raise plt.error
    sys.stderr.write("Drawing MST\n")
    n = mst.n_vertices
    edges = mst.edges
    pos = spring_layout(n, edges)
    labels = getattr(mst, "vertex_labels", [str(i) for i in range(n)])
    degrees = mst.degrees()

    if overwrite or not os.path.isfile(graph1):
        plt.figure(figsize=(15, 15), dpi=200)
        for u, v in edges:
            plt.plot(pos[[u, v], 0], pos[[u, v], 1], "-", color="0.6",
                     linewidth=0.7, zorder=1)
        plt.scatter(pos[:, 0], pos[:, 1],
                    s=20 + 30 * np.sqrt(degrees), c=degrees, cmap="viridis",
                    zorder=2)
        plt.axis("off")
        plt.savefig(graph1)
        plt.close()

    if overwrite or not os.path.isfile(graph2):
        rng = np.random.default_rng(0)
        clustering = isolate_clustering[clustering_name]
        cluster_fill = {
            cluster: rng.random(3) for cluster in set(clustering.values())
        }
        colors = np.array([
            cluster_fill[clustering[labels[v]]] for v in range(n)
        ])
        plt.figure(figsize=(15, 15), dpi=200)
        for u, v in edges:
            plt.plot(pos[[u, v], 0], pos[[u, v], 1], "-", color="0.6",
                     linewidth=0.7, zorder=1)
        plt.scatter(pos[:, 0], pos[:, 1], s=30, c=colors, alpha=0.9, zorder=2)
        plt.axis("off")
        plt.savefig(graph2)
        plt.close()


def write_cluster_csv(outfile, node_names, node_labels, clustering,
                      output_format="microreact", epi_csv=None,
                      query_names=None, suffix="_Cluster"):
    """Cluster CSV in each tool's dialect (writeClusterCsv,
    plot.py:598-758)."""
    colnames = []
    if output_format == "microreact":
        colnames = ["id"]
        for cluster_type in clustering:
            colnames.append(cluster_type + suffix + "__autocolour")
        if query_names is not None:
            colnames += ["Status", "Status__colour"]
    elif output_format == "phandango":
        colnames = ["id"]
        for cluster_type in clustering:
            colnames.append(cluster_type + suffix)
        if query_names is not None:
            colnames += ["Status", "Status:colour"]
    elif output_format == "grapetree":
        colnames = ["ID"]
        for cluster_type in clustering:
            colnames.append(cluster_type + suffix)
        if query_names is not None:
            colnames.append("Status")
    elif output_format == "cytoscape":
        colnames = ["id"]
        for cluster_type in clustering:
            colnames.append(cluster_type + suffix)
        if query_names is not None:
            colnames.append("Status")
    else:
        sys.stderr.write("Do not recognise format for CSV writing\n")
        raise RuntimeError("Unknown CSV output format: " + str(output_format))

    d = defaultdict(list)
    if epi_csv is not None:
        columns_to_be_omitted = [
            "id", "Id", "ID", "combined_Cluster__autocolour",
            "core_Cluster__autocolour", "accessory_Cluster__autocolour",
            "overall_Lineage",
        ]
        epi_data = pd.read_csv(epi_csv, index_col=False, quotechar='"')
        epi_data.index = isolate_name_to_label(epi_data.iloc[:, 0])
        for e in epi_data.columns.values:
            if e not in columns_to_be_omitted:
                colnames.append(str(e))

    example_cluster_title = list(clustering.keys())[0]
    query_set = frozenset(query_names) if query_names is not None else frozenset()

    for name, label in zip(node_names, isolate_name_to_label(node_labels)):
        if name not in clustering[example_cluster_title]:
            sys.stderr.write("Cannot find " + name + " in clustering\n")
            raise RuntimeError("Name missing from clustering: " + name)
        id_col = "ID" if output_format == "grapetree" else "id"
        d[id_col].append(label)
        for cluster_type in clustering:
            if output_format == "microreact":
                col_name = cluster_type + suffix + "__autocolour"
            else:
                col_name = cluster_type + suffix
            d[col_name].append(clustering[cluster_type][name])
        if query_names is not None:
            status = "Query" if name in query_set else "Reference"
            d["Status"].append(status)
            if output_format == "microreact":
                d["Status__colour"].append(
                    "red" if status == "Query" else "black"
                )
            elif output_format == "phandango":
                d["Status:colour"].append(
                    "#ff0000" if status == "Query" else "#000000"
                )
        if epi_csv is not None:
            if label in epi_data.index:
                for col, value in zip(epi_data.columns.values,
                                      epi_data.loc[[label]].iloc[0].values):
                    if col not in columns_to_be_omitted:
                        d[col].append(str(value))
            else:
                for col in epi_data.columns.values:
                    if col not in columns_to_be_omitted:
                        d[col].append("")

    sys.stderr.write("Parsed data, now writing to CSV\n")
    pd.DataFrame(data=d).to_csv(outfile, columns=colnames, index=False)


def outputs_for_cytoscape(G, G_mst, isolate_names, clustering, out_prefix,
                          epi_csv, query_list=None, suffix=None,
                          write_csv=True, use_partial_query_graph=None):
    """Cytoscape graphml bundle (outputsForCytoscape, plot.py:512-596)."""
    from .network.graph import save_network

    seq_labels = isolate_name_to_label(isolate_names)
    if suffix is None:
        suffix = "_cytoscape"
    else:
        suffix = suffix + "_cytoscape"
    if use_partial_query_graph is None:
        save_network(G, prefix=out_prefix, suffix=suffix, use_graphml=True,
                     vertex_labels=seq_labels)

    example_cluster_title = list(clustering.keys())[0]
    if use_partial_query_graph is not None:
        represented = {
            clustering[example_cluster_title][iso] for iso in isolate_names
        }
    else:
        represented = set(clustering[example_cluster_title].values())
    for cluster in represented:
        members = np.array([
            v for v in range(G.n_vertices)
            if clustering[example_cluster_title].get(isolate_names[v]) == cluster
        ], dtype=np.int64)
        G_comp, old_ids = G.subgraph(members, relabel=True)
        save_network(
            G_comp, prefix=out_prefix, suffix="_component_" + str(cluster),
            use_graphml=True,
            vertex_labels=[seq_labels[i] for i in old_ids],
        )

    if G_mst is not None:
        mst_labels = isolate_name_to_label(
            getattr(G_mst, "vertex_labels", isolate_names)
        )
        save_network(G_mst, prefix=out_prefix, suffix=suffix + "_mst",
                     use_graphml=True, vertex_labels=mst_labels)

    if write_csv:
        write_cluster_csv(
            os.path.join(out_prefix,
                         os.path.basename(out_prefix) + "_cytoscape.csv"),
            isolate_names, isolate_names, clustering, "cytoscape",
            epi_csv, query_list,
        )


def outputs_for_microreact(combined_list, clustering, nj_tree, mst_tree,
                           acc_mat, perplexity, max_iter, out_prefix, epi_csv,
                           query_list=None, overwrite=False, n_threads=1,
                           device=None):
    """Microreact bundle: cluster CSV, SCE embedding .dot, trees
    (outputsForMicroreact, plot.py:761-836); the embedding runs on
    ``device`` (None: ``_device.resolve``'s choice)."""
    from .embedding import generate_embedding
    from .trees import write_tree

    seq_labels = isolate_name_to_label(combined_list)
    csv_file = os.path.join(
        out_prefix, os.path.basename(out_prefix) + "_microreact_clusters.csv"
    )
    outfiles = [csv_file]
    write_cluster_csv(csv_file, combined_list, combined_list, clustering,
                      "microreact", epi_csv, query_list)

    embedding_file = generate_embedding(
        seq_labels, acc_mat, perplexity, out_prefix, overwrite,
        kNN=100, maxIter=max_iter, n_threads=n_threads, device=device,
    )
    outfiles.append(embedding_file)

    if nj_tree is not None:
        write_tree(nj_tree, out_prefix, "_core_NJ.nwk", overwrite)
        outfiles.append(os.path.join(
            out_prefix, os.path.basename(out_prefix) + "_core_NJ.nwk"
        ))
    if mst_tree is not None:
        write_tree(mst_tree, out_prefix, "_MST.nwk", overwrite)
        outfiles.append(os.path.join(
            out_prefix, os.path.basename(out_prefix) + "_MST.nwk"
        ))
    return outfiles


def create_microreact(prefix, microreact_files, api_key=None, info_csv=None):
    """Write the .microreact JSON bundle; POST to the API if a key is given
    (createMicroreact, plot.py:836-901)."""
    import json
    from datetime import datetime

    description = "PopPUNK run on " + datetime.now().strftime("%Y-%b-%d %H:%M")
    doc = {
        "schema": 1,
        "meta": {"name": description},
        "files": {},
        "networks": {},
        "maps": {},
        "timelines": {},
    }
    if info_csv is not None:
        info_df = pd.read_csv(info_csv)
        if "latitude" not in info_df.columns or "longitude" not in info_df.columns:
            doc["maps"] = {}
        if "year" not in info_df.columns:
            doc["timelines"] = {}

    with open(microreact_files[0]) as cluster_file:
        doc["files"]["data-file-1"] = {
            "id": "data-file-1", "name": "clusters.csv",
            "format": "text/csv", "blob": cluster_file.read(),
        }
    with open(microreact_files[1]) as dot_file:
        doc["files"]["network-file-1"] = {
            "id": "network-file-1", "name": "network.dot",
            "format": "text/vnd.graphviz", "blob": dot_file.read(),
        }
        doc["networks"]["network-1"] = {
            "title": "Network", "file": "network-file-1", "nodeField": "id",
        }
    if len(microreact_files) > 2:
        with open(microreact_files[2]) as tree_file:
            doc["files"]["tree-file-1"] = {
                "id": "tree-file-1", "name": "tree.nwk",
                "format": "text/x-nh", "blob": tree_file.read(),
            }

    out_json = os.path.join(
        prefix, os.path.basename(prefix) + ".microreact"
    )
    with open(out_json, "w") as json_file:
        json.dump(doc, json_file)

    url = None
    if api_key is not None:
        import requests

        headers = {"Content-type": "application/json; charset=UTF-8",
                   "Access-Token": api_key}
        r = requests.post("https://microreact.org/api/projects/create",
                          data=json.dumps(doc), headers=headers)
        if not r.ok:
            sys.stderr.write(
                "Microreact API call failed with response " + r.text + "\n"
            )
        else:
            url = r.json()["url"]
    return url


def outputs_for_phandango(combined_list, clustering, nj_tree, mst_tree,
                          out_prefix, epi_csv, query_list=None,
                          overwrite=False):
    """(outputsForPhandango, plot.py:924-962)."""
    from .trees import write_tree

    write_cluster_csv(
        os.path.join(out_prefix,
                     os.path.basename(out_prefix) + "_phandango_clusters.csv"),
        combined_list, combined_list, clustering, "phandango", epi_csv,
        query_list,
    )
    if nj_tree is not None:
        write_tree(nj_tree, out_prefix, "_core_NJ.tree", overwrite)
    else:
        sys.stderr.write("Need an NJ tree for a Phandango output")


def outputs_for_grapetree(combined_list, clustering, nj_tree, mst_tree,
                          out_prefix, epi_csv, query_list=None,
                          overwrite=False):
    """(outputsForGrapetree, plot.py:964-1005)."""
    from .trees import write_tree

    write_cluster_csv(
        os.path.join(out_prefix,
                     os.path.basename(out_prefix) + "_grapetree_clusters.csv"),
        combined_list, combined_list, clustering, "grapetree", epi_csv,
        query_list,
    )
    if nj_tree is not None:
        write_tree(nj_tree, out_prefix, "_core_NJ.nwk", overwrite)
    if mst_tree is not None:
        write_tree(mst_tree, out_prefix, "_core_MST.nwk", overwrite)
