"""Visualisation orchestration.

Counterpart of PopPUNK/visualise.py:generate_visualisations (:194-795):
load/recompute distances, subset, build NJ/MST trees, and write
Microreact / Phandango / Grapetree / Cytoscape bundles.

Copied from ``poppunk_tpu/visualise.py``, whose counterpart it is: this
package imports nothing of the JAX package. The device work (the
recalculated all-vs-all distances through the match-count kernel, NJ from
512 genomes, the SCE embedding) runs on ``device``: None means
``_device.resolve``'s choice, the card unless the CPU is asked for.
"""

import os
import sys

import numpy as np
import scipy.sparse

from . import _device
from .io.hdf5db import read_db_params, read_sketches
from .network.graph import load_network_file
from .network.mst import minimum_spanning_tree
from .ops.distances import query_db
from .pairs import condensed_to_square
from .trees import generate_nj_tree, load_tree, mst_to_phylogeny
from .utils import (join_cluster_dicts, read_pickle,
                    read_isolate_type_from_csv,
                    read_rlist_from_distance_pickle)


def _file_base(prefix):
    return os.path.join(prefix, os.path.basename(prefix))


def _load_clustering(model, model_prefix, ref_db, previous_clustering,
                     external_clustering):
    """Locate + read the clustering CSV(s) (visualise.py:370-430)."""
    if external_clustering:
        mode = "external"
        cluster_file = external_clustering
    elif previous_clustering is not None:
        cluster_file = previous_clustering
        mode = "lineages" if cluster_file.endswith("_lineages.csv") else "clusters"
    else:
        mode = "lineages" if model.type == "lineage" else "clusters"
        suffix = "_lineages.csv" if model.type == "lineage" else "_clusters.csv"
        if os.path.exists(_file_base(ref_db) + suffix):
            cluster_file = _file_base(ref_db) + suffix
        else:
            cluster_file = _file_base(model_prefix) + suffix

    sys.stderr.write("Loading clustering from " + cluster_file
                     + "; change using --previous-clustering if necessary\n")
    isolate_clustering = read_isolate_type_from_csv(cluster_file, mode=mode,
                                                    return_dict=True)
    if model.indiv_fitted:
        for ctype, indiv_suffix in zip(
                ["Core", "Accessory"],
                ["_core_clusters.csv", "_accessory_clusters.csv"]):
            indiv_file = _file_base(model_prefix) + indiv_suffix
            if os.path.isfile(indiv_file):
                indiv = read_isolate_type_from_csv(indiv_file, mode="clusters",
                                                   return_dict=True)
                isolate_clustering[ctype] = indiv["Cluster"]
    return isolate_clustering, cluster_file, mode


def generate_visualisations(query_db, ref_db, distances, rank_fit, threads,
                            output, external_clustering, microreact,
                            phandango, grapetree, cytoscape, perplexity,
                            maxIter, strand_preserved, include_files,
                            model_dir, previous_clustering,
                            previous_query_clustering, previous_mst,
                            previous_distances, network_file, info_csv,
                            rapidnj, api_key, tree, mst_distances, overwrite,
                            display_cluster, use_partial_query_graph=None,
                            extend_query_graph=False,
                            recalculate_distances=False, tmp="/tmp/",
                            device=None):
    from .models import load_cluster_fit

    device = _device.resolve(device)

    if not (microreact or phandango or grapetree or cytoscape):
        sys.stderr.write("Must specify at least one type of visualisation "
                         "to output\n")
        sys.exit(1)
    if cytoscape and not (microreact or phandango or grapetree):
        if (rank_fit is None and network_file is None
                and not recalculate_distances):
            sys.stderr.write("For cytoscape, specify either a network file "
                             "with --network-file or a lineage model with "
                             "--rank-fit\n")
            sys.exit(1)
        tree = "none"

    ref_db = ref_db.rstrip("/")
    os.makedirs(output, exist_ok=True)
    if distances is None:
        distances = _file_base(ref_db) + ".dists"

    # Sequence universe: reference dists (+ query dists if given)
    raw_combined = read_rlist_from_distance_pickle(distances + ".pkl",
                                                   include_queries=False)
    qlist = []
    if query_db is not None:
        query_db = query_db.rstrip("/")
        qlist = read_rlist_from_distance_pickle(
            _file_base(query_db) + ".dists.pkl", only_queries=True)
        raw_combined = raw_combined + qlist
    combined_seq = list(dict.fromkeys(raw_combined))

    viz_subset = None
    subset_file = include_files or use_partial_query_graph
    if subset_file is not None:
        viz_subset = set()
        with open(subset_file) as f:
            for line in f:
                name = line.rstrip()
                if name in set(combined_seq):
                    viz_subset.add(name)

    # Model + clustering
    model_prefix = (model_dir or ref_db).rstrip("/")
    model = load_cluster_fit(_file_base(model_prefix) + "_fit.pkl",
                             _file_base(model_prefix) + "_fit.npz",
                             device=device)
    model.set_threads(threads)
    isolate_clustering, cluster_file, mode = _load_clustering(
        model, model_prefix, ref_db, previous_clustering, external_clustering)

    if query_db is not None:
        suffix = "_lineages.csv" if model.type == "lineage" else "_clusters.csv"
        prev_query = previous_query_clustering or _file_base(query_db) + suffix
        if os.path.isfile(prev_query):
            query_clustering = read_isolate_type_from_csv(
                prev_query, mode=mode, return_dict=True)
            isolate_clustering = join_cluster_dicts(isolate_clustering,
                                                    query_clustering)

    # Extend the partial query graph subset to every isolate sharing a
    # cluster with it (reference visualise.py:444-464)
    if use_partial_query_graph and extend_query_graph and viz_subset:
        clustering = isolate_clustering.get("Cluster", {})
        subset_clusters = {clustering[s] for s in viz_subset
                           if s in clustering}
        universe = set(combined_seq)
        for isolate, cluster in clustering.items():
            if cluster in subset_clusters and isolate in universe:
                viz_subset.add(isolate)

    # ------------------------------------------------------------------
    # Dense distances (for NJ and dense MST)
    # ------------------------------------------------------------------
    need_dense = tree in ("nj", "both") or microreact or (
        (tree == "mst" or cytoscape) and rank_fit is None)
    core_mat = acc_mat = None
    if need_dense:
        combined_seq, core_mat, acc_mat = _dense_matrices(
            ref_db, query_db, distances, combined_seq, strand_preserved,
            recalculate_distances, viz_subset, device)
    elif viz_subset is not None:
        combined_seq = [s for s in combined_seq if s in viz_subset]

    if viz_subset is not None and core_mat is not None:
        keep = [i for i, s in enumerate(combined_seq) if s in viz_subset]
        combined_seq = [combined_seq[i] for i in keep]
        core_mat = core_mat[np.ix_(keep, keep)]
        acc_mat = acc_mat[np.ix_(keep, keep)]

    # ------------------------------------------------------------------
    # Trees
    # ------------------------------------------------------------------
    nj_tree = mst_tree = None
    mst_graph = None
    if tree in ("nj", "both"):
        existing = None if overwrite else load_tree(output, "NJ")
        if existing is not None:
            nj_tree = existing
        else:
            sys.stderr.write("Building NJ tree\n")
            nj_tree = generate_nj_tree(
                core_mat, combined_seq, output, tmp=tmp,
                rapidnj=rapidnj, threads=threads, device=device)
    if tree in ("mst", "both") or cytoscape:
        if rank_fit is not None:
            sys.stderr.write("Building MST from sparse lineage distances\n")
            sparse_mat = scipy.sparse.load_npz(rank_fit)
            from .cli.mst import generate_mst_from_sparse_input

            old_rlist = None
            if previous_distances is not None:
                old_rlist = read_rlist_from_distance_pickle(
                    previous_distances + ".pkl", allow_non_self=False)
            mst_graph = generate_mst_from_sparse_input(
                sparse_mat, combined_seq, old_rlist=old_rlist,
                previous_mst=previous_mst)
        elif core_mat is not None:
            sys.stderr.write("Building MST from dense distances\n")
            from .network.construct import construct_dense_network
            from .pairs import square_to_condensed_vec

            mat = core_mat if mst_distances == "core" else acc_mat
            G_dense = construct_dense_network(
                len(combined_seq),
                np.stack([square_to_condensed_vec(core_mat),
                          square_to_condensed_vec(acc_mat)], axis=1)
                if mst_distances == "euclidean" else None,
                use_weights=mst_distances == "euclidean")
            if mst_distances != "euclidean":
                G_dense.weights = square_to_condensed_vec(mat)
            mst_graph = minimum_spanning_tree(G_dense)
        if mst_graph is not None and tree in ("mst", "both"):
            mst_tree = mst_to_phylogeny(mst_graph, combined_seq)
            try:
                from .plotting import draw_mst

                display = display_cluster or list(isolate_clustering)[0]
                cluster_for_draw = isolate_clustering.get(
                    display, next(iter(isolate_clustering.values())))
                mst_graph.vertex_labels = list(combined_seq)
                draw_mst(mst_graph, output,
                         {display: {n: cluster_for_draw.get(n, "NA")
                                    for n in combined_seq}},
                         display, overwrite)
            except Exception as e:
                sys.stderr.write(f"MST drawing failed: {e}\n")

    # ------------------------------------------------------------------
    # Exports
    # ------------------------------------------------------------------
    query_list = qlist if query_db is not None else None
    if microreact:
        from .plotting import create_microreact, outputs_for_microreact

        sys.stderr.write("Writing microreact output\n")
        files = outputs_for_microreact(
            combined_seq, isolate_clustering, nj_tree, mst_tree, acc_mat,
            perplexity, maxIter, output, info_csv, query_list,
            overwrite=overwrite, n_threads=threads, device=device)
        url = create_microreact(output, files, api_key, info_csv)
        if url is not None:
            sys.stderr.write("Microreact: " + url + "\n")

    if phandango:
        from .plotting import outputs_for_phandango

        sys.stderr.write("Writing phandango output\n")
        outputs_for_phandango(combined_seq, isolate_clustering, nj_tree,
                              mst_tree, output, info_csv, query_list,
                              overwrite=overwrite)

    if grapetree:
        from .plotting import outputs_for_grapetree

        sys.stderr.write("Writing grapetree output\n")
        outputs_for_grapetree(combined_seq, isolate_clustering, nj_tree,
                              mst_tree, output, info_csv, query_list,
                              overwrite=overwrite)

    if cytoscape:
        from .plotting import outputs_for_cytoscape

        sys.stderr.write("Writing cytoscape output\n")
        if network_file is not None:
            G = load_network_file(network_file)
        elif mst_graph is not None:
            G = mst_graph
        else:
            sys.stderr.write("Cytoscape output requires --network-file or "
                             "an MST\n")
            G = None
        if G is not None:
            outputs_for_cytoscape(G, mst_graph, combined_seq,
                                  isolate_clustering, output, info_csv,
                                  query_list,
                                  use_partial_query_graph=use_partial_query_graph)

    sys.stderr.write("Done\n")


def _dense_matrices(ref_db, query_db, distances, combined_seq,
                    strand_preserved, recalculate, viz_subset, device=None):
    """Square core/accessory matrices over the combined sequence set
    (visualise.py:465-600); a recalculation runs on ``device``."""
    kmers = list(read_db_params(ref_db)[0])
    if not recalculate and os.path.isfile(distances + ".pkl"):
        rlist, qlist, self_mode, X = read_pickle(distances)
        if self_mode and query_db is None and X is not None:
            core = condensed_to_square(X[:, 0], len(rlist))
            acc = condensed_to_square(X[:, 1], len(rlist))
            return list(rlist), core, acc

    # Recompute all-vs-all over the combined set from sketches
    sys.stderr.write("Recalculating pairwise distances for tree "
                     "construction\n")
    names = combined_seq if viz_subset is None else [
        s for s in combined_seq if s in viz_subset]
    ref_names = set()
    from .io.hdf5db import get_seqs_in_db
    from .utils import db_h5_path

    ref_names = set(get_seqs_in_db(db_h5_path(ref_db)))
    missing = [n for n in names if n not in ref_names]
    if missing and query_db is None:
        raise RuntimeError(f"{missing[0]} not found in any database")
    by_name = {}
    for sk in read_sketches(ref_db, [n for n in names if n in ref_names]):
        by_name[sk.name] = sk
    if missing:
        for sk in read_sketches(query_db, missing):
            by_name[sk.name] = sk
    sketches = [by_name[n] for n in names]
    X = query_db_sketches(sketches, kmers, strand_preserved, device)
    core = condensed_to_square(X[:, 0], len(names))
    acc = condensed_to_square(X[:, 1], len(names))
    return names, core, acc


def query_db_sketches(sketches, kmers, strand_preserved, device=None):
    return query_db(sketches, None, kmers, self_mode=True,
                    use_rc=not strand_preserved, device=device)
