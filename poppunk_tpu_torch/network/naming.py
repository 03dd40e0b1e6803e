"""The rule that names network components after a previous clustering.

PopPUNK's printClusters (PopPUNK/network.py:1478-1663) names each
component of a network once its vertices carry the names of an older
clustering; ``print_clusters`` and the resident serving session
(``serve.AssignSession`` in network mode) both name through this module:

- components are taken largest first; among components of one size the
  one whose first vertex comes later goes first (``rankdata``'s ordinal
  ranks, subtracted from the count);
- a component holding members of one old cluster alone keeps its name;
- one holding members of several old clusters is named by joining their
  names with "_" in the order the old clusters were read;
- one holding no old member takes the next number above the largest old
  name (``first_new_id``), in the order above;
- an old cluster met in a second component is reported as split across
  new clusters, and a merge as the clusters that merged.
"""

import copy
import sys

import numpy as np
from scipy.stats import rankdata


def frequency_ranks(sizes):
    """Each component's rank, 0 for the largest, from ``sizes`` in the
    components' order of first occurrence; ties go to the later one."""
    return len(sizes) - rankdata(sizes, method="ordinal").astype(int)


def first_new_id(old_clusters):
    """The first number above every number in the old clusters' names
    (merged names count each of their parts)."""
    parsed_old = set(int(item) for name in old_clusters
                     for item in name.split("_"))
    new_id = max(parsed_old) + 1
    while new_id in parsed_old:
        new_id += 1
    return new_id


class ClusterNamer:
    """Names components one at a time, in rank order, after the old
    clusters ``old_clusters`` ({name: members}, in the order read). The
    split and merge reports go to standard error unless ``quiet``."""

    def __init__(self, old_clusters, quiet=False):
        self.order = {name: i for i, name in enumerate(old_clusters)}
        self.new_id = first_new_id(old_clusters)
        self.found = set()
        self.quiet = quiet

    def fresh(self):
        """A namer at the start, as this one was made (for many networks
        named after the same old clusters)."""
        other = copy.copy(self)
        other.found = set()
        return other

    def name(self, joins, n_old):
        """(name, partial) of the next component: ``joins`` {old cluster:
        how many of the component's old members it holds}, ``n_old`` how
        many of its members the old clustering holds; ``partial`` the
        number of old clusters holding only part of them (0 unless the
        component is a merge). A component with no old member takes the
        next new number."""
        if n_old == 0:
            cls_id = str(self.new_id)
            self.new_id += 1
            return cls_id, 0
        merge, cls_id, partial = False, None, 0
        for old in sorted(joins, key=self.order.__getitem__):
            join = joins[old]
            if old in self.found:
                self._say("WARNING: Old cluster " + old
                          + " split across multiple new clusters\n")
            else:
                self.found.add(old)
            if join < n_old:
                merge, partial = True, partial + 1
                cls_id = old if cls_id is None else cls_id + "_" + old
            elif join == n_old:
                assert merge is False
                cls_id = old
                break
        if merge:
            self._say("Clusters " + ",".join(cls_id.split("_"))
                      + " have merged into " + cls_id + "\n")
        return cls_id, partial

    def _say(self, message):
        if not self.quiet:
            sys.stderr.write(message)


def member_joins(members, member_of):
    """({old cluster: members of ``members`` it holds}, members the old
    clustering holds) for ``member_of`` {sample: [its old clusters]}."""
    joins, n_old = {}, 0
    for member in members:
        olds = member_of.get(member)
        if olds:
            n_old += 1
            for old in olds:
                joins[old] = joins.get(old, 0) + 1
    return joins, n_old


def old_membership(old_clusters):
    """{sample: [old clusters holding it, in the order read]}."""
    member_of = {}
    for name, members in old_clusters.items():
        for sample in members:
            member_of.setdefault(sample, []).append(name)
    return member_of


def rank_components(sizes, first):
    """Positions of components in rank order: ``sizes`` and ``first`` (the
    index of each one's first vertex, distinct) of any set of a network's
    components, in any order."""
    by_first = np.argsort(np.asarray(first), kind="stable")
    ranks = frequency_ranks(np.asarray(sizes)[by_first])
    return by_first[np.argsort(ranks, kind="stable")]
