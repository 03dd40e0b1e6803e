"""Host network code, copied from poppunk_tpu/network/clusters.py (that
package loads jax on import); its imports point at this package.

Cluster naming from network components.

Reimplements printClusters (PopPUNK/network.py:1478-1663) exactly:
components ranked by size get names; with a previous clustering, old names
are kept where the member sets still match, merges get underscore-joined
names (and are reported), brand-new clusters take the next free integer,
by the rule of ``naming.py``, which the serving session names by too;
optional pronounceable "unword" names; CSV output sorted by cluster
frequency.
"""

import operator
import sys
from collections import Counter

from ..utils import read_isolate_type_from_csv
from .components import connected_components
from .naming import (ClusterNamer, frequency_ranks, member_joins,
                     old_membership)
from .unwords import gen_unword


def print_clusters(G, rlist, out_prefix=None, old_cluster_file=None,
                   external_cluster_csv=None, print_ref=True, print_csv=True,
                   clustering_type="combined", write_unwords=True):
    """Returns (clustering dict name->cluster id, merged_queries list)."""
    if old_cluster_file is None and print_ref is False:
        raise RuntimeError("Trying to print query clusters with no query sequences")
    if write_unwords and not print_csv:
        write_unwords = False

    labels, sizes = connected_components(G)
    component_frequency_ranks = frequency_ranks(sizes)
    new_clusters = [set() for _ in range(len(sizes))]
    for isolate_index, isolate_name in enumerate(rlist):
        component = labels[isolate_index]
        new_clusters[component_frequency_ranks[component]].add(isolate_name)

    old_names = set()
    if old_cluster_file is not None:
        old_all = read_isolate_type_from_csv(old_cluster_file, mode="external",
                                             return_dict=False)
        old_clusters = old_all[list(old_all.keys())[0]]
        namer = ClusterNamer(old_clusters)
        member_of = old_membership(old_clusters)
        old_names = set(member_of)

    clustering = {}
    cluster_unword = {}
    merged_queries = []
    unword_generator = gen_unword() if write_unwords else None

    for new_cls_idx, new_cluster in enumerate(new_clusters):
        if old_cluster_file is not None:
            joins, n_old = member_joins(new_cluster, member_of)
            cls_id, partial = namer.name(joins, n_old)
            if partial:
                query_only = new_cluster - old_names.intersection(new_cluster)
                for _ in range(partial):
                    merged_queries.extend(query_only)
            needs_unword = n_old == 0 or partial > 0
        else:
            cls_id = new_cls_idx + 1
            needs_unword = True

        unword = next(unword_generator) if (write_unwords and needs_unword) else None
        for member in new_cluster:
            clustering[member] = cls_id
            if unword is not None:
                cluster_unword[member] = unword

    if print_csv:
        out_file = out_prefix + "_clusters.csv"
        with open(out_file, "w") as cluster_file:
            cluster_file.write("Taxon,Cluster\n")
            unword_file = None
            if write_unwords:
                unword_file = open(out_prefix + "_unword_clusters.csv", "w")
                unword_file.write("Taxon,Cluster_name\n")
            freq_order = sorted(
                dict(Counter(clustering.values())).items(),
                key=operator.itemgetter(1),
                reverse=True,
            )
            freq_order = [x[0] for x in freq_order]
            for member, cluster_name in sorted(
                clustering.items(), key=lambda i: freq_order.index(i[1])
            ):
                if print_ref or member not in old_names:
                    cluster_file.write(",".join((member, str(cluster_name))) + "\n")
                if write_unwords and member in cluster_unword:
                    unword_file.write(",".join((member, cluster_unword[member])) + "\n")
            if unword_file is not None:
                unword_file.close()
        if external_cluster_csv is not None:
            print_external_clusters(new_clusters, external_cluster_csv,
                                    out_prefix, old_names, print_ref)

    return clustering, merged_queries


def print_external_clusters(new_clusters, ext_cluster_file, out_prefix,
                            old_names, print_ref=True):
    """Relate components to externally-defined clusters
    (PopPUNK/network.py:1665-1719)."""
    import pandas as pd
    from collections import defaultdict

    d = defaultdict(list)
    ext_clusters = read_isolate_type_from_csv(ext_cluster_file, mode="external",
                                              return_dict=True)
    for pp_cluster in new_clusters:
        prev_clusters = defaultdict(set)
        for sample in pp_cluster:
            for ext in ext_clusters:
                if sample in ext_clusters[ext]:
                    prev_clusters[ext].add(ext_clusters[ext][sample])
        for sample in pp_cluster:
            if print_ref or sample not in old_names:
                d["sample"].append(sample)
                for ext in ext_clusters:
                    if ext in prev_clusters:
                        d[ext].append(";".join(prev_clusters[ext]))
                    else:
                        d[ext].append("NA")
    if "sample" not in d:
        sys.stderr.write("WARNING: No new samples found, cannot write external clusters\n")
    else:
        pd.DataFrame(data=d).to_csv(
            out_prefix + "_external_clusters.csv",
            columns=["sample"] + list(ext_clusters.keys()),
            index=False,
        )
