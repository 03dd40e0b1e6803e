"""A reference network held in memory, to which requests of queries attach.

PopPUNK's batch assignment (assign.py:assign_query_hdf5, network mode)
adds each request's queries to the database network by their
within-strain pairs and names the components after the database's
clusters (printClusters). A resident serving session answers many
requests against one network, so ``ResidentNetwork`` reads the network's
components and the old clusters once; a request then costs a union over
the components its queries touch and the naming of those components, by
the rule both share with ``print_clusters`` (``naming.py``):

- the components of the reference network are labelled in order of their
  first vertex (connected_components), and each keeps its size and, per
  old cluster, how many of its members that cluster holds;
- a request's queries are vertices after the references, in the request's
  order; its within-strain pairs join each query to the components of its
  references and to other queries;
- a component the request leaves alone keeps its old name; one it touches
  is named from the old clusters of all its members; the components
  without any old member (a request's novel lineages, and any reference
  component the old clustering does not cover) take new numbers in the
  rank order of the whole network's components, which is their order by
  size, then by first vertex, as ``print_clusters`` ranks them.
"""

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph

from ..utils import read_isolate_type_from_csv
from .components import connected_components
from .naming import ClusterNamer, old_membership, rank_components


class ResidentNetwork:
    """The components of a reference network ``G`` over ``r_names`` (its
    vertices in order) and the old clusters of ``old_cluster_file``, the
    first column of a clusters CSV, as ``print_clusters`` reads it."""

    def __init__(self, G, r_names, old_cluster_file):
        labels, sizes = connected_components(G)
        self.labels = np.asarray(labels, np.int64)
        self.sizes = np.asarray(sizes, np.int64)
        self.n_ref = len(r_names)
        # labels follow first occurrence: label c first appears at vertex
        # first[c], and the firsts increase with the label
        self.first = np.unique(self.labels, return_index=True)[1]
        old_all = read_isolate_type_from_csv(old_cluster_file,
                                             mode="external",
                                             return_dict=False)
        old_clusters = old_all[list(old_all.keys())[0]]
        self.member_of = old_membership(old_clusters)
        self.namer = ClusterNamer(old_clusters, quiet=True)
        self.joins = [{} for _ in range(len(self.sizes))]
        self.n_old = np.zeros(len(self.sizes), np.int64)
        for vertex, name in enumerate(r_names):
            olds = self.member_of.get(name)
            if olds:
                c = self.labels[vertex]
                self.n_old[c] += 1
                for old in olds:
                    self.joins[c][old] = self.joins[c].get(old, 0) + 1
        # reference components the old clustering does not cover: they
        # take new numbers in every request, in rank order with its own
        self.nameless = np.flatnonzero(self.n_old == 0)

    def assign(self, q_names, qr, qq):
        """({query name: cluster name}, counts) of a request: ``qr`` the
        (query index, reference index) arrays of its within-strain query x
        reference pairs, ``qq`` the (query index, query index) arrays of
        its within-strain query pairs. counts: components holding a query,
        how many of them are merges of old clusters and how many are new."""
        nq = len(q_names)
        q_r, r_r = (np.asarray(a, np.int64) for a in qr)
        # the components the pairs touch, and each pair's place among
        # them, in O(pairs + components)
        hit = self.labels[r_r]
        present = np.zeros(len(self.sizes), bool)
        present[hit] = True
        touched = np.flatnonzero(present)
        comp = (np.cumsum(present) - 1)[hit]
        # a graph over the request's queries (0..nq-1) and the components
        # it touches (nq..): its components are the network's new ones
        a = np.concatenate([q_r, np.asarray(qq[0], np.int64)])
        b = np.concatenate([nq + comp,
                            np.asarray(qq[1], np.int64)])
        n_nodes = nq + len(touched)
        graph = scipy.sparse.coo_matrix(
            (np.ones(len(a), np.int8), (a, b)), shape=(n_nodes, n_nodes))
        n_groups, group = scipy.sparse.csgraph.connected_components(
            graph, directed=False)
        # per group: size, first vertex, old members and their clusters
        size = np.bincount(group[:nq], minlength=n_groups)
        first = np.full(n_groups, self.n_ref + nq, np.int64)
        np.minimum.at(first, group[:nq], self.n_ref + np.arange(nq))
        joins = [{} for _ in range(n_groups)]
        n_old = np.zeros(n_groups, np.int64)
        for g, c in zip(group[nq:], touched):
            size[g] += self.sizes[c]
            first[g] = min(first[g], self.first[c])
            n_old[g] += self.n_old[c]
            for old, k in self.joins[c].items():
                joins[g][old] = joins[g].get(old, 0) + k
        for i, name in enumerate(q_names):
            olds = self.member_of.get(name)
            if olds:
                g = group[i]
                n_old[g] += 1
                for old in olds:
                    joins[g][old] = joins[g].get(old, 0) + 1
        # the untouched nameless reference components rank beside them
        alone = np.setdiff1d(self.nameless, touched)
        order = rank_components(
            np.concatenate([size, self.sizes[alone]]),
            np.concatenate([first, self.first[alone]]))
        namer = self.namer.fresh()
        names, merges = [None] * n_groups, 0
        for k in order:
            if k < n_groups:
                names[k], partial = namer.name(joins[k], n_old[k])
                merges += partial > 0
            else:
                namer.name({}, 0)
        out = {q: names[group[i]] for i, q in enumerate(q_names)}
        return out, {"components": n_groups, "merges": int(merges),
                     "new": int(np.sum(n_old == 0))}
