"""Minimum spanning trees (generate_minimum_spanning_tree,
PopPUNK/network.py:1721-1831).

scipy's sparse MST on the host; if the graph has several components, their
MSTs are linked through seed vertices (highest degree per component) using
existing inter-seed edges where present and max-weight placeholder edges
otherwise, exactly following the reference's strategy.
"""

import sys

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph

from .components import connected_components
from .graph import Graph


EPSILON = 1e-10


def minimum_spanning_tree(G):
    if G.weights is None:
        raise RuntimeError("MST passed unweighted graph")
    sys.stderr.write("Starting calculation of minimum-spanning tree\n")
    # identical genomes produce weight-0 edges, which a sparse CSR cannot
    # represent (0 == no edge, silently dropping them from the MST);
    # clamp to epsilon, as the reference's lineage fits do (models.py:54)
    if np.any(G.weights < EPSILON):
        G = Graph(G.n_vertices, G.edges, np.maximum(G.weights, EPSILON))
    adj = G.adjacency(weights=True)
    mst = scipy.sparse.csgraph.minimum_spanning_tree(adj)
    mst_coo = scipy.sparse.coo_matrix(mst)
    keep = mst_coo.data > 0
    edges = np.stack([mst_coo.row[keep], mst_coo.col[keep]], axis=1)
    weights = mst_coo.data[keep]
    mst_g = Graph(G.n_vertices, edges, weights)

    labels, sizes = connected_components(mst_g)
    if len(sizes) > 1:
        # seed vertex per component: max degree (network.py:1752-1775)
        deg = mst_g.degrees()
        seeds = []
        for comp in range(len(sizes)):
            members = np.flatnonzero(labels == comp)
            seeds.append(int(members[np.argmax(deg[members])]))
        seeds = set(seeds)
        max_weight = float(np.max(G.weights))
        connections = []
        adj_w = G.adjacency(weights=True).tolil()
        for ref in seeds:
            found = False
            for t in seeds:
                if t != ref and adj_w[ref, t] != 0:
                    connections.append((ref, t, float(adj_w[ref, t])))
                    found = True
            if not found:
                for query in seeds:
                    if query != ref:
                        connections.append((ref, query, max_weight))
        if connections:
            conn = np.array([(s, t) for s, t, _ in connections], dtype=np.int64)
            conn_w = np.array([w for _, _, w in connections])
            seed_g = Graph(G.n_vertices, conn, conn_w)
            seed_mst = scipy.sparse.csgraph.minimum_spanning_tree(
                seed_g.adjacency(weights=True)
            )
            sm = scipy.sparse.coo_matrix(seed_mst)
            keep = sm.data > 0
            mst_g = mst_g.add_edges(
                np.stack([sm.row[keep], sm.col[keep]], axis=1), sm.data[keep]
            )
    sys.stderr.write("Completed calculation of minimum-spanning tree\n")
    return mst_g


def mst_from_sparse_distances(row, col, data, n):
    """MST directly from a sparse kNN distance structure (lineage rank
    fits); used by the sparse-MST CLI (PopPUNK/sparse_mst.py)."""
    G = Graph(n, np.stack([np.asarray(row), np.asarray(col)], axis=1),
              np.asarray(data, dtype=np.float64))
    return minimum_spanning_tree(G)
