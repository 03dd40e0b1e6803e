"""Host network code, copied from poppunk_tpu/network/clusters.py (that
package loads jax on import); its imports point at this package.

Cluster naming from network components.

Reimplements printClusters (PopPUNK/network.py:1478-1663) exactly:
components ranked by size get names; with a previous clustering, old names
are kept where the member sets still match, merges get underscore-joined
names (and are reported), brand-new clusters take the next free integer;
optional pronounceable "unword" names; CSV output sorted by cluster
frequency.
"""

import operator
import sys
from collections import Counter

from scipy.stats import rankdata

from ..utils import read_isolate_type_from_csv
from .components import connected_components
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
    # rank components by size: largest -> rank 0 (reference: rankdata ordinal)
    component_frequency_ranks = (
        len(sizes) - rankdata(sizes, method="ordinal").astype(int)
    )
    new_clusters = [set() for _ in range(len(sizes))]
    for isolate_index, isolate_name in enumerate(rlist):
        component = labels[isolate_index]
        new_clusters[component_frequency_ranks[component]].add(isolate_name)

    old_names = set()
    if old_cluster_file is not None:
        old_all = read_isolate_type_from_csv(old_cluster_file, mode="external",
                                             return_dict=False)
        old_clusters = old_all[list(old_all.keys())[0]]
        parsed_old = set(
            int(item)
            for sublist in (x.split("_") for x in old_clusters)
            for item in sublist
        )
        new_id = max(parsed_old) + 1
        while new_id in parsed_old:
            new_id += 1
        for prev_cluster in old_clusters.values():
            for prev_sample in prev_cluster:
                old_names.add(prev_sample)

    clustering = {}
    found_old_clusters = []
    cluster_unword = {}
    merged_queries = []
    unword_generator = gen_unword() if write_unwords else None

    for new_cls_idx, new_cluster in enumerate(new_clusters):
        needs_unword = False
        if old_cluster_file is not None:
            merge = False
            cls_id = None
            ref_only = old_names.intersection(new_cluster)
            query_only = new_cluster - ref_only
            if len(ref_only) == 0:
                cls_id = str(new_id)
                new_id += 1
                needs_unword = True
            else:
                for old_cluster_name, old_cluster_members in old_clusters.items():
                    join = ref_only.intersection(old_cluster_members)
                    if len(join) > 0:
                        if old_cluster_name in found_old_clusters:
                            sys.stderr.write(
                                "WARNING: Old cluster " + old_cluster_name
                                + " split across multiple new clusters\n"
                            )
                        else:
                            found_old_clusters.append(old_cluster_name)
                        if len(join) < len(ref_only):
                            merge = True
                            merged_queries.extend(query_only)
                            needs_unword = True
                            if cls_id is None:
                                cls_id = old_cluster_name
                            else:
                                cls_id += "_" + old_cluster_name
                        elif len(join) == len(ref_only):
                            assert merge is False
                            cls_id = old_cluster_name
                            break
            if merge:
                merged_ids = cls_id.split("_")
                sys.stderr.write(
                    "Clusters " + ",".join(merged_ids) + " have merged into "
                    + cls_id + "\n"
                )
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
