"""Cluster hierarchy analysis from the --multi-boundary method
(scripts/poppunk_iterate.py): collect consistent clusters across boundary
positions, nest them into a tree by inclusion, weight nodes by mean core
distance, and cut the tree at a proportional distance cutoff."""

import argparse
import os
import re
import sys
from collections import defaultdict
from copy import deepcopy

import numpy as np

from ..trees import Node, to_newick


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_iterate",
        description="Cluster QC and analysis from multi-boundary method")
    parser.add_argument("--db", required=True,
                        help="Output directory with results of "
                             "--multi-boundary")
    parser.add_argument("--h5", default=None,
                        help="Location of .h5 DB file "
                             "[default = <db>/<db>.h5]")
    parser.add_argument("--output", default=None,
                        help="Prefix for output files "
                             "[default = <db>/<db>_iterate]")
    parser.add_argument("--cutoff", default=0.1, type=float,
                        help="Proportional distance cutoff (0, 1)")
    parser.add_argument("--cpus", type=int, default=1)
    return parser.parse_args(arg_list)


def read_next_cluster_file(db_prefix):
    """Iterator over boundary cluster files with decreasing resolution.

    Scans for ``<prefix>_boundary<N>_clusters.csv`` in increasing N (the
    sweep writes only offsets with at least one non-trivial cluster, so N
    need not be consecutive)."""
    import glob

    pattern = db_prefix + "_boundary*_clusters.csv"
    indexed = []
    for fn in glob.glob(pattern):
        m = re.search(r"_boundary(\d+)_clusters\.csv$", fn)
        if m:
            indexed.append((int(m.group(1)), fn))
    for cluster_idx, cluster_file in sorted(indexed):
        all_clusters = defaultdict(set)
        with open(cluster_file) as f:
            f.readline()
            for line in f:
                name, cluster = line.rstrip().split(",")
                all_clusters[int(cluster)].add(name)
        no_singletons = {c: m for c, m in all_clusters.items() if len(m) > 1}
        yield all_clusters, no_singletons, cluster_idx


def is_nested(cluster_dict, child_members, node_list):
    """Smallest already-added cluster containing child_members."""
    parent = None
    for node in node_list:
        if child_members.issubset(cluster_dict[node]) and (
                parent is None
                or len(cluster_dict[node]) < len(cluster_dict[parent])):
            parent = node
    return parent


def main(arg_list=None):
    args = get_options(arg_list)
    if not 0 < args.cutoff < 1:
        raise RuntimeError("--cutoff must be between 0 and 1")
    db = args.db.rstrip("/")
    if args.output is None:
        args.output = os.path.join(db, os.path.basename(db) + "_iterate")
    h5_prefix = args.h5 or db
    h5_prefix = re.sub(r"\.h5$", "", h5_prefix)
    if os.path.isdir(h5_prefix):
        h5_prefix = os.path.join(h5_prefix, os.path.basename(h5_prefix))

    db_name = os.path.join(db, os.path.basename(db))
    cluster_it = read_next_cluster_file(db_name)
    try:
        all_clusters, iterated_clusters, _ = next(cluster_it)
    except StopIteration:
        sys.stderr.write("No boundary cluster files found at "
                         + db_name + "_boundary*\n")
        sys.exit(1)
    iterated_clusters = dict(iterated_clusters)
    all_samples = set()
    for members in all_clusters.values():
        all_samples.update(members)
    cluster_idx = max(iterated_clusters) if iterated_clusters else 0

    # keep clusters consistent (nested or disjoint) with everything so far
    for _, no_singletons, _ in cluster_it:
        for new_cluster in no_singletons.values():
            valid = True
            for old_cluster in iterated_clusters.values():
                if new_cluster == old_cluster or not (
                        new_cluster.issubset(old_cluster)
                        or old_cluster.issubset(new_cluster)
                        or not new_cluster & old_cluster):
                    valid = False
                    break
            if valid:
                cluster_idx += 1
                iterated_clusters[cluster_idx] = new_cluster
    sorted_clusters = sorted(iterated_clusters,
                             key=lambda k: len(iterated_clusters[k]),
                             reverse=True)

    # mean core distance within each cluster
    from ..io.hdf5db import get_db_kmers, read_sketches
    from ..ops.distances import query_db

    db_dir = os.path.dirname(h5_prefix) or "."
    kmers = [int(k) for k in get_db_kmers(db_dir)]
    pi_values = {}
    max_pi = 0.0
    for cluster in sorted_clusters:
        names = sorted(iterated_clusters[cluster])
        sketches = read_sketches(db_dir, names)
        dist_mat = query_db(sketches, None, kmers, self_mode=True)
        pi_values[cluster] = float(np.mean(dist_mat[:, 0]))
        max_pi = max(max_pi, pi_values[cluster])

    # nest clusters into a tree
    root = Node(label="root")
    tree_clusters = deepcopy(iterated_clusters)
    tree_clusters["root"] = all_samples.copy()
    node_list = {"root": root}
    for cluster in sorted_clusters:
        new_node = Node(label="cluster" + str(cluster))
        new_node.edge_length = pi_values[cluster] / max(max_pi, 1e-12)
        parent = is_nested(tree_clusters, tree_clusters[cluster],
                           list(node_list))
        if parent is not None:
            node_list[parent].add_child(new_node)
            tree_clusters[parent] -= tree_clusters[cluster]
        node_list[cluster] = new_node
    for cluster in tree_clusters:
        for sample in tree_clusters[cluster]:
            node_list[cluster].add_child(Node(label=sample, edge_length=0.0))

    with open(args.output + ".tree.nwk", "w") as f:
        f.write(to_newick(root))
    with open(args.output + ".clusters.csv", "w") as f:
        f.write("Cluster,Avg_Pi,Taxa\n")
        for cluster in sorted_clusters:
            f.write(f"{cluster},{pi_values[cluster]},"
                    + ";".join(sorted(iterated_clusters[cluster])) + "\n")

    # cut the tree: deepest cluster nodes with scaled length < cutoff
    cut_clusters = []

    def walk(node, parent_below):
        label = node.label or ""
        is_cluster = label.startswith("cluster")
        below = is_cluster and (node.edge_length or 0.0) < args.cutoff
        cluster_children = [c for c in node.children
                            if (c.label or "").startswith("cluster")]
        if below:
            # keep only if no descendant cluster is also below the cutoff
            has_lower = any(
                (c.edge_length or 0.0) < args.cutoff
                for c in cluster_children)
            if not has_lower:
                cut_clusters.append(label)
        for c in cluster_children:
            walk(c, below)

    for c in root.children:
        if (c.label or "").startswith("cluster"):
            walk(c, False)

    included = set()
    with open(args.output + ".cutoff_clusters.csv", "w") as f:
        f.write("Isolate,Cluster\n")
        for idx, label in enumerate(cut_clusters):
            cluster_id = int(label[len("cluster"):])
            for sample in sorted(iterated_clusters[cluster_id]):
                included.add(sample)
                f.write(f"{sample},{idx + 1}\n")
        for idx, sample in enumerate(sorted(all_samples - included)):
            f.write(f"{sample},{idx + len(cut_clusters) + 1}\n")


if __name__ == "__main__":
    main()
