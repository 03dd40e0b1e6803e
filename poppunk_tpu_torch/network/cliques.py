"""Host network code, copied from poppunk_tpu/network/cliques.py (that
package loads jax on import); its imports point at this package.

Clique-based reference extraction.

Reimplements extractReferences' CPU path (PopPUNK/network.py:178-487):
per connected component, repeatedly take a maximal clique, keep one vertex
from it (if none already kept), drop the clique and recurse; then verify
components aren't split in the reference-only subgraph, patching with
shortest paths. The choice of maximal clique is implementation-defined in
the reference (whatever gt.max_cliques yields first); we use a greedy
maximal clique seeded from the highest-degree vertex, which is
deterministic.

``fast_mode`` matches fastPrune (network.py:222-261): random sampling
instead of cliques, with extra refs for merged queries.
"""

import os
import sys

import numpy as np
import scipy.sparse.csgraph

from .components import connected_components

FAST_REF_SUBSAMPLE = 10
FAST_REF_MERGE_SUBSAMPLE = 3


def _greedy_maximal_clique(adj_sets, vertices):
    """A maximal clique within ``vertices`` (set), greedy from the highest
    degree vertex."""
    if not vertices:
        return set()
    seed = max(vertices, key=lambda v: (len(adj_sets[v] & vertices), -v))
    clique = {seed}
    candidates = adj_sets[seed] & vertices
    while candidates:
        # pick the candidate with most connections into remaining candidates
        v = max(candidates, key=lambda u: (len(adj_sets[u] & candidates), -u))
        clique.add(v)
        candidates = candidates & adj_sets[v]
    return clique


def _clique_prune_component(adj_sets, component_vertices, reference_indices):
    """One vertex per clique, cliques removed iteratively
    (getCliqueRefs, network.py:178-204)."""
    refs = set(reference_indices)
    remaining = set(component_vertices)
    if len(remaining) <= 2:
        refs.add(min(remaining))
        return refs
    while len(remaining) > 1:
        clique = _greedy_maximal_clique(adj_sets, remaining)
        if not clique:
            break
        if clique.isdisjoint(refs):
            refs.add(min(clique))
        remaining -= clique
    if len(remaining) == 1:
        refs.add(next(iter(remaining)))
    return refs


def extract_references(G, db_order, out_prefix, merged_queries=(), out_suffix="",
                       existing_refs=None, threads=1, fast_mode=False,
                       rng=None):
    """Returns (reference_indices set, reference_names, ref_file_name, G_ref).

    G_ref is the induced subgraph on references, renumbered in sorted
    reference order (as the reference's pruned GraphView)."""
    if existing_refs is None:
        reference_indices = set()
    else:
        index_lookup = {v: k for k, v in enumerate(db_order)}
        reference_indices = set(index_lookup[r] for r in existing_refs)

    merged_query_idx = set()
    if merged_queries:
        index_lookup = {v: k for k, v in enumerate(db_order)}
        merged_query_idx = set(index_lookup[r] for r in frozenset(merged_queries))

    labels, sizes = connected_components(G)
    adj_sets = _adjacency_sets(G)

    if fast_mode:
        sys.stderr.write("Running quick reference picking\n")
        rng = rng or np.random.default_rng(1)
        for comp in range(len(sizes)):
            comp_vertices = np.flatnonzero(labels == comp)
            comp_set = frozenset(comp_vertices.tolist())
            if not comp_set.intersection(reference_indices):
                n_new = len(comp_set) // FAST_REF_SUBSAMPLE + 1
                reference_indices.update(sorted(comp_set)[:n_new])
            merged = sorted(comp_set.intersection(merged_query_idx))
            if merged:
                n_new = len(merged) // FAST_REF_MERGE_SUBSAMPLE + 1
                reference_indices.update(merged[:n_new])
    else:
        sys.stderr.write("Running clique finding\n")
        for comp in range(len(sizes)):
            comp_vertices = np.flatnonzero(labels == comp)
            reference_indices = _clique_prune_component(
                adj_sets, comp_vertices.tolist(), reference_indices
            )

    # Reconstruct clusters with shortest paths: if a component's references
    # fall into multiple components of the reference subgraph, add the
    # vertices of connecting shortest paths (network.py:427-482).
    sys.stderr.write("Reconstructing clusters with shortest paths\n")
    ref_sorted = np.array(sorted(reference_indices), dtype=np.int64)
    G_ref, _ = G.subgraph(ref_sorted)
    ref_labels, _ = connected_components(G_ref)
    ref_label_of = {int(v): int(ref_labels[i]) for i, v in enumerate(ref_sorted)}

    adj = G.adjacency()
    updated = False
    for comp in range(len(sizes)):
        comp_refs = [int(v) for v in ref_sorted if labels[v] == comp]
        if len(comp_refs) > 1:
            ref_comps = {ref_label_of[v] for v in comp_refs}
            if len(ref_comps) > 1:
                # connect them via shortest paths in the full graph
                base = comp_refs[0]
                _, predecessors = scipy.sparse.csgraph.shortest_path(
                    adj, indices=[base], return_predecessors=True, unweighted=True
                )
                pred = predecessors[0]
                for other in comp_refs[1:]:
                    v = other
                    while v != base and v >= 0:
                        reference_indices.add(int(v))
                        v = pred[v]
                updated = True
    if updated:
        ref_sorted = np.array(sorted(reference_indices), dtype=np.int64)
        G_ref, _ = G.subgraph(ref_sorted)

    reference_names = [db_order[int(x)] for x in sorted(reference_indices)]
    ref_file_name = write_references(reference_names, out_prefix, out_suffix)
    return reference_indices, reference_names, ref_file_name, G_ref


def _adjacency_sets(G):
    adj = [set() for _ in range(G.n_vertices)]
    for s, t in G.edges:
        if s != t:
            adj[s].add(int(t))
            adj[t].add(int(s))
    return adj


def write_references(ref_list, out_prefix, out_suffix=""):
    """(PopPUNK/network.py:489-509)."""
    os.makedirs(out_prefix, exist_ok=True)
    ref_file = os.path.join(out_prefix,
                            os.path.basename(out_prefix) + out_suffix + ".refs")
    with open(ref_file, "w") as f:
        for ref in ref_list:
            f.write(ref + "\n")
    return ref_file
