"""Query assignment — the production path.

Counterpart of poppunk_tpu/assign.py (PopPUNK/assign.py: assign_query
:249, assign_query_hdf5 :326): sketch queries on the host, query-vs-
reference distances with every pair classified in the same pass on the
distance device, network attachment with stable cluster naming, and the
optional database update. Sketching, the HDF5 database and QC are copies
of the reference's host modules. The distances and the model run on
``dist_device`` / ``model_device`` (None: ``_device.resolve``'s choice,
the card unless the CPU is asked for). Every model type assigns here
(models/base.py): BGMM, DBSCAN (through the decision grid of the fused
``dbscan`` post) and refine / threshold models attach queries to the
reference network; a refine model fitted with ``--indiv-refine`` also
assigns on its core-only and accessory-only boundaries (``--core``,
``--accessory``), reusing the distances of the first pass. A lineage model
classifies nothing on the device: the query-query distances extend its kNN
on the host, and ``_lineages.csv`` gives every sample's lineage per rank.
"""

import os
import sys
import warnings
from collections import defaultdict

import numpy as np

from . import _device
from .io.hdf5db import (add_random, construct_database, create_database_dir,
                        get_seqs_in_db, join_dbs, read_db_params,
                        read_sketches, remove_from_db)
from .network.clusters import print_clusters, print_external_clusters
from .network.construct import (construct_network_from_assignments,
                                network_vertex_check)
from .network.graph import (GRAPH_SUFFIX, Graph, load_network_file,
                            remove_non_query_components, save_network)
from .ops.boundary import generate_tuples
from .ops.distances import query_db
from .ops.fused_assign import model_post_spec
from .qc import (prune_query_distance_matrix, qc_dist_mat,
                 qc_query_assignments, sketch_qc, write_qc_failure_report)
from .utils import db_h5_path, read_pickle, store_pickle


def _file_base(prefix):
    return os.path.join(prefix, os.path.basename(prefix))


def fetch_network(network_dir, model, ref_list, ref_graph=False,
                  core_only=False, accessory_only=False):
    """Load the network accompanying a fitted model
    (fetchNetwork, PopPUNK/network.py:49-118); ``core_only`` /
    ``accessory_only`` pick the networks of an indiv-refine fit, and a
    lineage model's lowest-rank network comes first.

    Returns (graph, old_cluster_csv_path)."""
    base = _file_base(network_dir)
    if core_only:
        suffix = "_core"
    elif accessory_only:
        suffix = "_accessory"
    else:
        suffix = ""
    stems = []
    if ref_graph:
        stems.append(base + suffix + ".refs_graph")
    stems.append(base + suffix + "_graph")
    if model.type == "lineage":
        stems.insert(0, base + "_rank_" + str(min(model.ranks)) + "_graph")
    # native format first, then the reference's graph-tool .gt and its
    # GPU-mode cugraph edge list (PopPUNK/network.py:120-176)
    candidates = [stem + ext for stem in stems
                  for ext in (GRAPH_SUFFIX, ".gt", ".csv.gz")]
    network_file = next((c for c in candidates if os.path.isfile(c)), None)
    if network_file is None:
        raise RuntimeError(
            f"Could not find a network file in {network_dir}; looked for "
            + ", ".join(candidates))
    sys.stderr.write("Loading network from " + network_file + "\n")
    G = load_network_file(network_file)
    network_vertex_check(G, len(ref_list))
    return G, base + suffix + "_clusters.csv"


def add_query_to_network(rlist, qlist, G, assignments, model, query_db_prefix,
                         kmers=None, distance_type="euclidean",
                         query_query=False, strand_preserved=False,
                         weights=None, device=None):
    """Attach queries to the reference network
    (addQueryToNetwork, PopPUNK/network.py:1315-1442). ``distance_type``
    ("euclidean", "core" or "accessory") picks the boundary that
    classifies query-query pairs and the edge weights; those distances,
    when needed, run on ``device``.

    Returns (new graph, qq distance matrix or None)."""
    n_ref = len(rlist)
    G = construct_network_from_assignments(
        rlist, qlist, assignments, within_label=model.within_label,
        dist_mat=weights, use_weights=weights is not None,
        weights_type=distance_type if weights is not None else "euclidean",
        previous_network=G, summarise=False)

    qq_dist_mat = None
    if not query_query:
        deg = G.degrees()[n_ref:n_ref + len(qlist)]
        if np.any(deg == 0):
            sys.stderr.write("Found novel query clusters. Calculating "
                             "distances between them.\n")
            query_query = True

    if query_query:
        if len(qlist) == 1:
            qq_dist_mat = np.zeros((0, 2), dtype=np.float32)
        else:
            sys.stderr.write("Calculating all query-query distances\n")
            add_random(query_db_prefix, qlist, kmers, strand_preserved)
            q_sketches = read_sketches(query_db_prefix, qlist)
            qq_slope = {"core": 0, "accessory": 1}.get(distance_type)
            post_spec = model_post_spec(model, slope=qq_slope)
            out = query_db(q_sketches, None, kmers, self_mode=True,
                           use_rc=not strand_preserved, post_spec=post_spec,
                           device=device)
            if post_spec is not None:
                qq_dist_mat, qq_assign = out
            else:
                qq_dist_mat = out
                qq_assign = (model.assign(qq_dist_mat) if qq_slope is None
                             else model.assign(qq_dist_mat, slope=qq_slope))
            edges = generate_tuples(np.asarray(qq_assign), model.within_label,
                                    self=True, int_offset=n_ref)
            w = None
            if weights is not None:
                rows = np.flatnonzero(np.asarray(qq_assign)
                                      == model.within_label)
                if distance_type == "core":
                    w = qq_dist_mat[rows, 0]
                elif distance_type == "accessory":
                    w = qq_dist_mat[rows, 1]
                else:
                    w = np.sqrt((qq_dist_mat[rows] ** 2).sum(axis=1))
            G = G.add_edges(edges, w)
    return G, qq_dist_mat


def assign_query(ref_db, q_files, output, qc_dict, update_db=False,
                 write_references=False, distances=None, serial=False,
                 stable=None, threads=1, overwrite=False, plot_fit=0,
                 graph_weights=False, model_dir=None, strand_preserved=False,
                 previous_clustering=None, external_clustering=None,
                 core=False, accessory=False, save_partial_query_graph=False,
                 use_full_network=False, min_kmer_count=0, exact_count=False,
                 dist_device=None, model_device=None):
    """Sketch queries then assign (assign_query, PopPUNK/assign.py:249)."""
    dist_device = _device.resolve(dist_device)
    model_device = _device.resolve(model_device)
    if os.path.abspath(ref_db) == os.path.abspath(output) and not overwrite:
        sys.stderr.write("--output and --db must be different to "
                         "prevent overwrite.\n")
        sys.exit(1)
    if not os.path.isfile(db_h5_path(ref_db.rstrip("/"))):
        sys.stderr.write(f"Cannot find database {ref_db} "
                         "(no sketch .h5 file)\n")
        sys.exit(1)
    kmers, sketch_size, codon_phased = read_db_params(ref_db)
    create_database_dir(output, kmers)
    q_names = construct_database(
        q_files, kmers, sketch_size, output, threads=threads,
        overwrite=overwrite, codon_phased=codon_phased, calc_random=False,
        strand_preserved=strand_preserved, min_count=min_kmer_count,
        use_exact=exact_count)
    return assign_query_hdf5(
        ref_db, q_names, output, qc_dict, update_db, write_references,
        distances, serial, stable, threads, overwrite, plot_fit,
        graph_weights, model_dir, strand_preserved, previous_clustering,
        external_clustering, core, accessory, save_partial_query_graph,
        use_full_network, dist_device, model_device)


def assign_query_hdf5(ref_db, q_names, output, qc_dict, update_db=False,
                      write_references=False, distances=None, serial=False,
                      stable=None, threads=1, overwrite=False, plot_fit=0,
                      graph_weights=False, model_dir=None,
                      strand_preserved=False, previous_clustering=None,
                      external_clustering=None, core=False, accessory=False,
                      save_partial_query_graph=False, use_full_network=False,
                      dist_device=None, model_device=None):
    """Assign already-sketched queries
    (assign_query_hdf5, PopPUNK/assign.py:326)."""
    from .models import load_cluster_fit
    from .profiling import stage

    dist_device = _device.resolve(dist_device)
    model_device = _device.resolve(model_device)
    ref_db = ref_db.rstrip("/")
    output = output.rstrip("/")
    if distances is None:
        distances = _file_base(ref_db) + ".dists"
    model_prefix = (model_dir or ref_db).rstrip("/")
    if serial and update_db:
        raise RuntimeError("--update-db cannot be used with --serial")
    if stable and update_db:
        raise RuntimeError("--update-db cannot be used with --stable")
    if stable:
        serial = True

    sys.stderr.write("Mode: Assigning clusters of query sequences\n\n")

    # Sketch-level QC of the queries
    failed_assembly_qc = {}
    failed_assembly_samples = frozenset()
    if qc_dict["run_qc"]:
        pass_assembly_qc, failed_assembly_qc = sketch_qc(output, q_names,
                                                         qc_dict)
        failed_assembly_samples = (frozenset(q_names)
                                   - frozenset(pass_assembly_qc))
        if failed_assembly_samples:
            sys.stderr.write(
                f"{len(failed_assembly_samples)} samples failed:\n"
                f"{','.join(failed_assembly_samples)}\n")
            q_names = pass_assembly_qc
            if not q_names:
                write_qc_failure_report(failed_assembly_samples,
                                        [failed_assembly_qc], output)
                sys.exit(1)

    model = load_cluster_fit(_file_base(model_prefix) + "_fit.pkl",
                             _file_base(model_prefix) + "_fit.npz",
                             device=model_device)
    if not model.fitted or not getattr(model, "assign_points", True):
        sys.stderr.write(
            "Cannot assign points with an incompletely-fitted model\n"
            "Please refit the model without --for-refine\n")
        sys.exit(1)
    if model.type == "lineage" and (serial or stable):
        raise RuntimeError("lineage models cannot be used with --serial or "
                           "--stable")
    model.set_threads(threads)
    kmers = list(read_db_params(ref_db)[0])
    prev_clustering_dir = (previous_clustering or model_prefix).rstrip("/")

    fit_type_list = ["default"]
    if model.type == "refine" and model.indiv_fitted:
        if core:
            fit_type_list.append("core_refined")
        if accessory:
            fit_type_list.append("accessory_refined")

    isolate_clustering = {}
    dist_cache_key = dist_cache = None
    for fit_type in fit_type_list:
        ext = "" if fit_type == "default" else "_" + fit_type
        if os.path.isfile(distances + ".pkl"):
            r_names = read_pickle(distances, enforce_self=True,
                                  distances=False)[0]
        elif update_db:
            sys.stderr.write("Distance order .pkl missing, cannot use "
                             "--update-db\n")
            sys.exit(1)
        else:
            r_names = get_seqs_in_db(db_h5_path(ref_db))

        ref_file_name = _file_base(model_prefix) + ext + ".refs"
        use_ref_graph = (os.path.isfile(ref_file_name)
                         and update_db != "full" and model.type != "lineage"
                         and not use_full_network)
        if use_ref_graph:
            with open(ref_file_name) as f:
                ref_names = frozenset(line.rstrip() for line in f)
            r_names = [r for r in r_names if r in ref_names]

        # Name clashes: rename queries with a _query suffix
        same_names = set(r_names).intersection(q_names)
        if same_names:
            warnings.warn("Names of queries match names in reference "
                          "database\n", stacklevel=2)
            if not write_references:
                sys.stderr.write("Not running -- change names or add "
                                 "--write-references to override this "
                                 "behaviour\n")
                sys.exit(1)
            import h5py

            with h5py.File(db_h5_path(output), "r+") as query_h5:
                sketch_grp = query_h5["sketches"]
                for idx, query in enumerate(q_names):
                    if query in same_names:
                        new_name = query + "_query"
                        q_names[idx] = new_name
                        sketch_grp.move(query, new_name)

        # the boundary that classifies pairs (reference assign.py:444-460)
        if fit_type == "core_refined" or (model.type == "refine"
                                          and model.threshold):
            dist_type, fused_slope = "core", 0
        elif fit_type == "accessory_refined":
            dist_type, fused_slope = "accessory", 1
        else:
            dist_type, fused_slope = "euclidean", None

        if dist_cache_key == (tuple(r_names), tuple(q_names)):
            # same reference and query sets as the previous fit type:
            # reuse the (already QC'd) matrix, classify it on the host
            # (the reference reuses too, assign.py:500)
            sys.stderr.write("Reusing distances from previous fit type\n")
            qr_dist_mat = dist_cache
            query_assignments = model.assign(qr_dist_mat, slope=fused_slope)
        else:
            sys.stderr.write(f"Calculating query distances against "
                             f"{len(r_names)} references\n")
            # every pair is classified against the model in the distance
            # pass (a lineage model has no classifier: distances only)
            post_spec = model_post_spec(model, slope=fused_slope)
            with stage("query_distances", sync=True):
                r_sketches = read_sketches(ref_db, r_names)
                q_sketches = read_sketches(output, q_names)
                out = query_db(r_sketches, q_sketches, kmers,
                               use_rc=not strand_preserved,
                               post_spec=post_spec, device=dist_device)
            qr_dist_mat, query_assignments = (
                out if post_spec is not None else (out, None))
            if fit_type == "default" and plot_fit > 0:
                _plot_query_fits(ref_db, output, r_names, q_names, kmers,
                                 plot_fit, not strand_preserved, dist_device)

            if qc_dict["run_qc"]:
                sys.stderr.write("Running QC on distance matrix\n")
                passing, failed_dist_qc = qc_dist_mat(
                    qr_dist_mat, r_names, q_names, ref_db, qc_dict)
                failed_dist_samples = frozenset(q_names) - frozenset(passing)
                if failed_dist_samples:
                    sys.stderr.write(
                        f"{len(failed_dist_samples)} samples failed:\n"
                        f"{','.join(failed_dist_samples)}\n")
                    write_qc_failure_report(
                        failed_dist_samples | failed_assembly_samples,
                        [failed_dist_qc, failed_assembly_qc], output)
                    if len(failed_dist_samples) == len(q_names):
                        sys.exit(1)
                    q_names, qr_dist_mat, query_assignments = \
                        prune_query_distance_matrix(
                            r_names, q_names, failed_dist_samples,
                            qr_dist_mat, query_assignments)

        if model.type == "lineage":
            genome_network, isolate_clustering = _assign_lineage(
                model, r_names, q_names, qr_dist_mat, output, kmers,
                strand_preserved, graph_weights, dist_device)
            merged_queries = []
        else:
            (genome_network, isolate_clustering, merged_queries, q_names,
             qr_dist_mat) = _assign_network(
                model, fit_type, ext, dist_type, r_names, q_names,
                qr_dist_mat, query_assignments, prev_clustering_dir, output,
                kmers, qc_dict, serial, stable, update_db, write_references,
                graph_weights, strand_preserved, external_clustering,
                use_ref_graph, dist_device)
        dist_cache_key = (tuple(r_names), tuple(q_names))
        dist_cache = qr_dist_mat

        # Database update / distance persistence (assign.py:735-817)
        dists_out = _file_base(output) + ".dists"
        if update_db:
            sys.stderr.write("Updating reference database to " + output
                             + "\n")
            if fit_type == "default":
                join_dbs(ref_db, output, output,
                         update_random={"strand_preserved":
                                        strand_preserved})
            sys.stderr.write("Saving model and network\n")
            if model.type == "lineage":
                save_network(genome_network[min(model.ranks)], prefix=output,
                             suffix="_graph")
                model.outPrefix = output
                model.save()
            elif update_db == "full":
                save_network(genome_network, prefix=output,
                             suffix=ext + "_graph")
            if os.path.abspath(output) != os.path.abspath(model.outPrefix) \
                    and fit_type == "default" and model.type != "lineage":
                model.copy(output)

            combined_seq = list(r_names) + list(q_names)
            store_pickle(combined_seq, combined_seq, True, None, dists_out)

            if model.type != "lineage" and os.path.isfile(ref_file_name):
                from .network.cliques import extract_references

                sys.stderr.write(f"Finding references ({update_db})\n")
                with open(ref_file_name) as f:
                    existing_refs = [line.rstrip() for line in f]
                ref_idx, _, _, genome_network = extract_references(
                    genome_network, combined_seq, output,
                    merged_queries=merged_queries, out_suffix=ext,
                    existing_refs=existing_refs, threads=threads,
                    fast_mode=update_db == "fast")
                to_remove = [combined_seq[n]
                             for n in set(range(len(combined_seq)))
                             .difference(ref_idx)]
                if to_remove:
                    save_network(genome_network, prefix=output,
                                 suffix=ext + ".refs_graph")
                    remove_from_db(output, output, to_remove)
                    os.rename(_file_base(output) + ".tmp.h5",
                              _file_base(output) + ext + ".refs.h5")
        else:
            store_pickle(r_names, q_names, False, qr_dist_mat, dists_out)
            if save_partial_query_graph and not serial:
                lineage = model.type == "lineage"
                G_sub, pruned_names = remove_non_query_components(
                    genome_network[min(model.ranks)] if lineage
                    else genome_network, r_names, q_names, relabel=True)
                save_network(G_sub, prefix=output,
                             suffix="_graph" if lineage else ext + "_graph")
                with open(_file_base(output) + "_query.subset", "w") as f:
                    for isolate in pruned_names:
                        f.write(isolate + "\n")

    return isolate_clustering


def _assign_lineage(model, r_names, q_names, qr_dist_mat, output, kmers,
                    strand_preserved, graph_weights, device):
    """Lineage-model assignment: the query-query distances on ``device``,
    then the kNN extension and per-rank networks on the host
    (assign.py:528-573)."""
    from .utils import create_overall_lineage

    add_random(output, q_names, kmers, strand_preserved, overwrite=True)
    q_sketches = read_sketches(output, q_names)
    if len(q_names) > 1:
        qq_dist_mat = query_db(q_sketches, None, kmers, self_mode=True,
                               use_rc=not strand_preserved, device=device)
    else:
        qq_dist_mat = np.zeros((0, 2), dtype=np.float32)
    model.extend(qq_dist_mat, qr_dist_mat)

    all_names = list(r_names) + list(q_names)
    genome_network = {}
    lineage_clusters = defaultdict(dict)
    for rank in model.ranks:
        edges = model.assign(rank)
        weights = model.edge_weights(rank) if graph_weights else None
        G = Graph(len(all_names),
                  np.asarray(edges, dtype=np.int64).reshape(-1, 2), weights)
        genome_network[rank] = G
        clustering, _ = print_clusters(G, all_names, print_csv=False,
                                       write_unwords=False)
        lineage_clusters[rank] = dict(clustering)

    overall = create_overall_lineage(model.ranks, lineage_clusters)
    _write_lineage_csv(_file_base(output) + "_lineages.csv", all_names,
                       model.ranks, overall, query_names=set(q_names))
    return genome_network, overall


def _write_lineage_csv(path, names, ranks, overall, query_names=()):
    with open(path, "w") as f:
        cols = ["Rank_" + str(r) for r in ranks] + ["overall"]
        f.write(",".join(["id"] + cols + ["Status"]) + "\n")
        for name in names:
            status = "Query" if name in query_names else "Reference"
            f.write(",".join([name] + [str(overall[c][name]) for c in cols]
                             + [status]) + "\n")


def _assign_network(model, fit_type, ext, dist_type, r_names, q_names,
                    qr_dist_mat, query_assignments, prev_clustering_dir,
                    output, kmers, qc_dict, serial, stable, update_db,
                    write_references, graph_weights, strand_preserved,
                    external_clustering, use_ref_graph, device):
    """Attach to the network and name clusters (assign.py:576-734)."""
    genome_network, old_cluster_file = fetch_network(
        prev_clustering_dir, model, r_names, ref_graph=use_ref_graph,
        core_only=fit_type == "core_refined",
        accessory_only=fit_type == "accessory_refined")
    sys.stderr.write(f"Loading previous cluster assignments from "
                     f"{old_cluster_file}\n")

    if qc_dict["run_qc"] and qc_dict["max_merge"] > 1:
        sys.stderr.write("Running QC on model assignments\n")
        passing = frozenset(qc_query_assignments(
            r_names, q_names, query_assignments, qc_dict["max_merge"],
            old_cluster_file)[0])
        failed = frozenset(q_names) - passing
        if failed:
            sys.stderr.write(f"{len(failed)} samples failed:\n"
                             f"{','.join(failed)}\n")
            if len(failed) == len(q_names):
                sys.exit(1)
            q_names, qr_dist_mat, query_assignments = \
                prune_query_distance_matrix(r_names, q_names, failed,
                                            qr_dist_mat, query_assignments)

    weights = qr_dist_mat if graph_weights else None
    output_fn = _file_base(output) + ext
    merged_queries = []

    if not serial:
        genome_network, _ = add_query_to_network(
            r_names, q_names, genome_network, query_assignments, model,
            output, kmers=kmers, distance_type=dist_type,
            query_query=bool(update_db) and fit_type == "default",
            strand_preserved=strand_preserved, weights=weights,
            device=device)
        if qc_dict["run_qc"] and qc_dict.get("betweenness"):
            _print_query_betweenness(genome_network, r_names, q_names)
        isolate_clustering, merged_queries = print_clusters(
            genome_network, list(r_names) + list(q_names), output_fn,
            old_cluster_file, external_clustering,
            print_ref=write_references or bool(update_db))
    elif stable is not None:
        sys.stderr.write("Assigning stably\n")
        from .utils import read_isolate_type_from_csv

        ref_clustering = read_isolate_type_from_csv(
            old_cluster_file, mode="clusters", return_dict=True)["Cluster"]
        isolate_clustering = {}
        dist_col = 0 if stable == "core" else 1
        rect = qr_dist_mat[:, dist_col].reshape(len(q_names), len(r_names))
        r_idx = rect.argmin(axis=1)  # 1-NN per query (first min on ties)
        assignments = np.asarray(query_assignments)
        for query, ref in enumerate(r_idx):
            if assignments[query * len(r_names) + ref] == model.within_label:
                isolate_clustering[q_names[query]] = \
                    ref_clustering[r_names[ref]]
            else:
                isolate_clustering[q_names[query]] = "NA"
        _write_serial_csv(output, isolate_clustering)
        if external_clustering is not None:
            _serial_external_clusters(output, isolate_clustering,
                                      external_clustering, r_names)
    else:
        sys.stderr.write("Assigning serially\n")
        assignments = np.asarray(query_assignments)
        isolate_clustering = {}
        n_ref = len(r_names)
        for idx, sample in enumerate(q_names):
            G_q, _ = add_query_to_network(
                r_names, [sample], genome_network,
                assignments[idx * n_ref:(idx + 1) * n_ref], model, output)
            clustering = print_clusters(
                G_q, list(r_names) + [sample], output_fn, old_cluster_file,
                external_clustering, print_ref=False, print_csv=False,
                write_unwords=False)[0]
            cluster = clustering[sample]
            try:  # merge names like "1_2" stay as-is
                cluster = "novel" if int(cluster) > len(r_names) \
                    else int(cluster)
            except ValueError:
                pass
            isolate_clustering[sample] = cluster
        _write_serial_csv(output, isolate_clustering)
        if external_clustering is not None:
            _serial_external_clusters(output, isolate_clustering,
                                      external_clustering, r_names)

    return (genome_network, isolate_clustering, merged_queries, q_names,
            qr_dist_mat)


def _serial_external_clusters(output, isolate_clustering,
                              external_clustering, r_names):
    """External-cluster mapping after a serial/stable CSV write
    (printExternalClusters, reference assign.py:731-733)."""
    new_clusters = defaultdict(set)
    for sample, cl in isolate_clustering.items():
        new_clusters[cl].add(sample)
    print_external_clusters(list(new_clusters.values()),
                            external_clustering, _file_base(output),
                            set(r_names), print_ref=False)


def _plot_query_fits(ref_db, query_db_prefix, r_names, q_names, kmers,
                     count, use_rc, device, seed=42):
    """Random query-vs-reference k-mer fit plots (--plot-fit)."""
    try:
        from .plotting import plot_fit

        from .ops.kmer_fit import fit_kmer_curve_np

        rng = np.random.default_rng(seed)
        for i in range(count):
            q = q_names[rng.integers(len(q_names))]
            r = r_names[rng.integers(len(r_names))]
            pair = read_sketches(ref_db, [r]) + read_sketches(
                query_db_prefix, [q])
            raw, corrected = (
                query_db(pair, None, kmers, self_mode=True, jaccard=True,
                         random_correct=rc, use_rc=use_rc, device=device)[0]
                for rc in (False, True))
            dists = query_db(pair, None, kmers, self_mode=True,
                             use_rc=use_rc, device=device)[0]
            raw_fit = fit_kmer_curve_np(raw, np.asarray(kmers))
            plot_fit(kmers, raw, np.array(raw_fit), corrected,
                     np.array(dists),
                     _file_base(query_db_prefix) + f"_fit_example_{i + 1}",
                     f"Example fit {i + 1} - {q} vs. {r}")
    except Exception as e:  # plotting must never kill assignment
        sys.stderr.write(f"Fit plotting failed: {e}\n")


def _print_query_betweenness(G, r_names, q_names):
    """Per-query vertex betweenness, highest first (the reference's
    --betweenness QC report, assign.py:648-653)."""
    from .network.components import connected_components
    from .network.summary import brandes_betweenness

    A = G.adjacency()
    labels, _ = connected_components(G)
    bc = np.zeros(G.n_vertices)
    for comp in set(labels[len(r_names):].tolist()):
        members = np.flatnonzero(labels == comp)
        if members.shape[0] >= 3:
            bc += brandes_betweenness(A, members)
    betweenness = {q: bc[len(r_names) + i] for i, q in enumerate(q_names)}
    print("query\tbetweenness")
    for query, b in sorted(betweenness.items(), key=lambda kv: kv[1],
                           reverse=True):
        print(f"{query}\t{b}")


def _write_serial_csv(output, isolate_clustering):
    with open(_file_base(output) + "_clusters.csv", "w") as f:
        f.write("Taxon,Cluster\n")
        for sample, cluster in isolate_clustering.items():
            f.write(",".join((sample, str(cluster))) + "\n")
