"""Host network code, copied from poppunk_tpu/network/construct.py (that
package loads jax on import); its imports point at this package.

Network construction from model assignments / distance rows.

Counterpart of construct_network_from_assignments /
construct_network_from_edge_list (PopPUNK/network.py:734-1202), built on the
array-native Graph: an assignment vector over condensed or query-vs-ref
rows becomes an edge array via ops.boundary.generate_tuples, optionally
weighted with the pair's Euclidean (core, accessory) distance.
"""

import sys

import numpy as np

from ..ops.boundary import generate_tuples
from .graph import Graph
from .summary import print_network_summary


def euclidean_row_weights(dist_mat, rows):
    """Euclidean distance of each (core, acc) row — the reference's
    --graph-weights edge weights (network.py:985-990)."""
    d = np.asarray(dist_mat)[rows]
    return np.sqrt((d ** 2).sum(axis=1))


def construct_network_from_assignments(
        rlist, qlist, assignments, within_label=1, dist_mat=None,
        weights_type="euclidean", use_weights=False, previous_network=None,
        summarise=True, sample_size=None, betweenness_sample=100):
    """Graph whose edges are the within-strain pairs
    (network.py:1115-1202).

    rlist == qlist: condensed self rows; else rows are q * len(rlist) + r
    and query vertices are numbered len(rlist)..len(rlist)+len(qlist)-1.
    """
    assignments = np.asarray(assignments)
    self_mode = list(rlist) == list(qlist)
    rows = np.flatnonzero(assignments == within_label)
    if self_mode:
        n_vertices = len(rlist)
        edges = generate_tuples(assignments, within_label, self=True)
    else:
        n_vertices = len(rlist) + len(qlist)
        edges = generate_tuples(assignments, within_label, self=False,
                                num_ref=len(rlist))

    weights = None
    if use_weights and dist_mat is not None:
        if weights_type == "euclidean":
            weights = euclidean_row_weights(dist_mat, rows)
        elif weights_type == "core":
            weights = np.asarray(dist_mat)[rows, 0]
        else:
            weights = np.asarray(dist_mat)[rows, 1]

    G = Graph(n_vertices, edges, weights)
    if previous_network is not None:
        G = merge_with_previous(G, previous_network)
    if summarise:
        print_network_summary(G, sample_size=sample_size,
                              betweenness_sample=betweenness_sample)
    return G


def merge_with_previous(G, previous):
    """Append a previous network's edges (network.py:909-983). The previous
    graph's vertex ids must already be in this graph's numbering."""
    if previous.n_vertices > G.n_vertices:
        raise ValueError("Previous network has more vertices than current")
    w = None
    if G.weights is not None or previous.weights is not None:
        w = previous.weights if previous.weights is not None \
            else np.zeros(previous.n_edges)
    return G.add_edges(previous.edges, w)


def network_vertex_check(G, expected, fatal=True):
    """Vertex-count sanity gate (network.py:154-176)."""
    if G.n_vertices != expected:
        msg = (f"ERROR: Network size ({G.n_vertices}) does not match "
               f"sample count ({expected})\n")
        if fatal:
            raise RuntimeError(msg)
        sys.stderr.write(msg)


def construct_dense_network(n, dist_mat=None, use_weights=False):
    """Fully-connected graph over n vertices (network.py:1060-1113 —
    used by visualise for MSTs over all samples)."""
    from ..pairs import all_pairs

    i, j = all_pairs(n)
    edges = np.stack([i, j], axis=1)
    weights = None
    if use_weights and dist_mat is not None:
        weights = euclidean_row_weights(dist_mat, np.arange(edges.shape[0]))
    return Graph(n, edges, weights)
