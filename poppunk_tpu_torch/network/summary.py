"""Host network code, copied from poppunk_tpu/network/summary.py (that
package loads jax on import); its imports point at this package.

Network summary statistics and scores.

Mirrors networkSummary (PopPUNK/network.py:1204-1307):
  metrics = [components, density, transitivity, mean betweenness,
             size-weighted mean betweenness]
  scores  = [t(1-d), t(1-d)(1-bt), t(1-d)(1-wbt)]

Definitions match graph-tool's:
- density        = E / (n(n-1)/2)
- transitivity   = global clustering = 3*triangles / #connected triples,
                   computed via sparse A -> sum((A@A) ∘ A) / (2 * wedges)
- betweenness    = per component (size > 3): max over vertices of
                   normalised betweenness centrality (norm factor
                   2/((N-1)(N-2)), graph-tool norm=True); mean and
                   size-weighted mean over those components.

Subsampling (--summary-sample) picks a uniform vertex subset first, like
the reference (PopPUNK/network.py:1251-1260).
"""

import sys

import numpy as np

from .components import connected_components


def transitivity_from_adjacency(A):
    """Global clustering coefficient from a boolean symmetric CSR."""
    deg = np.asarray(A.sum(axis=1)).ravel()
    wedges = float((deg * (deg - 1)).sum()) / 2.0
    if wedges == 0:
        return 0.0
    paths_with_edge = float((A @ A).multiply(A).sum())  # 6 * triangles
    return paths_with_edge / (2.0 * wedges)


def betweenness_max_per_component(G, labels, sizes, sample_sources=None,
                                  rng=None):
    """Max normalised betweenness per component of size > 3.

    Returns (maxima, comp_sizes) for qualifying components. With
    ``sample_sources``, Brandes runs from a sampled subset of sources per
    component (the reference's GPU betweenness_sample, network.py:1279-1285)
    and results are rescaled by n_comp/sample.
    """
    maxima, comp_sizes = [], []
    for comp in np.flatnonzero(sizes > 3):
        vertices = np.flatnonzero(labels == comp)
        sub, _ = G.subgraph(vertices)
        A = sub.adjacency()
        n = sub.n_vertices
        sources = np.arange(n)
        scale = 1.0
        # sample_sources <= 0 means sampling disabled (all sources), the
        # native engine's convention (graph_core.cpp sweep_scores_v2)
        if sample_sources is not None and 0 < sample_sources < n:
            rng = rng or np.random.default_rng(1)
            sources = rng.choice(n, size=sample_sources, replace=False)
            scale = n / sample_sources
        bc = brandes_betweenness(A, sources) * scale
        norm = (n - 1) * (n - 2) / 2.0
        maxima.append(bc.max() / 2.0 / norm if norm > 0 else 0.0)
        comp_sizes.append(n)
    return np.array(maxima), np.array(comp_sizes)


def brandes_betweenness(A, sources):
    """Brandes betweenness (unnormalised, undirected double counting) from
    the given source vertices. A: boolean CSR.

    Dispatches to the native OpenMP engine (native/graph_core.cpp) when
    available; the numpy implementation below is its oracle."""
    from .incremental import brandes_native

    native = brandes_native(A, np.asarray(sources))
    if native is not None:
        return native
    n = A.shape[0]
    indptr, indices = A.indptr, A.indices
    bc = np.zeros(n)
    for s in sources:
        # BFS with path counting
        dist = np.full(n, -1, dtype=np.int64)
        sigma = np.zeros(n)
        dist[s] = 0
        sigma[s] = 1.0
        layers = [np.array([s])]
        frontier = layers[0]
        while frontier.size:
            next_set = {}
            # vectorised neighbour expansion
            neigh_all = []
            src_rep = []
            for v in frontier:
                nb = indices[indptr[v] : indptr[v + 1]]
                neigh_all.append(nb)
                src_rep.append(np.full(nb.shape[0], v))
            if not neigh_all:
                break
            neigh = np.concatenate(neigh_all)
            srcs = np.concatenate(src_rep)
            new_mask = dist[neigh] == -1
            newly = np.unique(neigh[new_mask])
            dist[newly] = dist[frontier[0]] + 1
            # sigma accumulation: edges into next layer
            into_next = dist[neigh] == dist[frontier[0]] + 1
            np.add.at(sigma, neigh[into_next], sigma[srcs[into_next]])
            frontier = newly
            if newly.size:
                layers.append(newly)
        # dependency accumulation
        delta = np.zeros(n)
        for layer in reversed(layers[1:]):
            for w in layer:
                nb = indices[indptr[w] : indptr[w + 1]]
                preds = nb[dist[nb] == dist[w] - 1]
                if preds.size:
                    contrib = (sigma[preds] / sigma[w]) * (1.0 + delta[w])
                    np.add.at(delta, preds, contrib)
        delta[s] = 0.0
        bc += delta
    return bc


def network_summary(G, calc_betweenness=True, betweenness_sample=100,
                    subsample=None, rng=None):
    """(metrics, scores) as in the reference networkSummary."""
    if subsample is not None and subsample < G.n_vertices:
        rng = rng or np.random.default_rng(1)
        vertices = rng.choice(G.n_vertices - 1, size=subsample, replace=False)
        S, _ = G.subgraph(np.sort(vertices))
    else:
        S = G
    labels, sizes = connected_components(S)
    components = len(sizes)
    n = S.n_vertices
    density = S.n_edges / (0.5 * n * (n - 1)) if n > 1 else 0.0
    transitivity = transitivity_from_adjacency(S.adjacency())

    mean_bt = 0.0
    weighted_mean_bt = 0.0
    if calc_betweenness:
        maxima, comp_sizes = betweenness_max_per_component(
            S, labels, sizes, sample_sources=betweenness_sample, rng=rng
        )
        if len(maxima) > 1:
            mean_bt = float(np.mean(maxima))
            weighted_mean_bt = float(np.average(maxima, weights=comp_sizes))
        elif len(maxima) == 1:
            mean_bt = weighted_mean_bt = float(maxima[0])

    metrics = [components, density, transitivity, mean_bt, weighted_mean_bt]
    base_score = transitivity * (1.0 - density)
    scores = [
        base_score,
        base_score * (1.0 - mean_bt),
        base_score * (1.0 - weighted_mean_bt),
    ]
    return metrics, scores


def print_network_summary(G, sample_size=None, betweenness_sample=100):
    metrics, scores = network_summary(
        G, subsample=sample_size, betweenness_sample=betweenness_sample
    )
    sys.stderr.write(
        "Network summary:\n"
        + "\n".join(
            [
                "\tComponents\t\t\t\t" + str(metrics[0]),
                "\tDensity\t\t\t\t\t" + "{:.4f}".format(metrics[1]),
                "\tTransitivity\t\t\t\t" + "{:.4f}".format(metrics[2]),
                "\tMean betweenness\t\t\t" + "{:.4f}".format(metrics[3]),
                "\tWeighted-mean betweenness\t\t" + "{:.4f}".format(metrics[4]),
                "\tScore\t\t\t\t\t" + "{:.4f}".format(scores[0]),
                "\tScore (w/ betweenness)\t\t\t" + "{:.4f}".format(scores[1]),
                "\tScore (w/ weighted-betweenness)\t\t" + "{:.4f}".format(scores[2]),
            ]
        )
        + "\n"
    )
