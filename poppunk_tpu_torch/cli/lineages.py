"""poppunk_tpu_lineages — lineage clustering within strains.

Counterpart of ``poppunk_lineages`` (PopPUNK/lineages.py): --create-db
builds one lineage (sparse kNN) model per strain of an existing strain
database; --query-db assigns queries in two stages (strain, then lineage
within the strain).

Its parser is a copy of the JAX package's (poppunk_tpu/cli/lineages.py);
this package imports nothing of the JAX package. The distances
(each strain's all-vs-all, the queries against the references) run on
``cuda:<--deviceid>`` unless ``POPPUNK_TPU_TORCH_DEVICE=cpu`` asks for
the CPU; ``--gpu-dist`` keeps them on the card even then.
"""

import argparse
import os
import pickle
import shutil
import sys
from collections import defaultdict

import numpy as np

from .. import DEFAULT_LINEAGE_RESOLUTION, SEARCH_DEPTH_FACTOR, __version__


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_lineages",
        description="Lineage clustering across strains",
    )
    mode_group = parser.add_argument_group("Mode of operation")
    mode = mode_group.add_mutually_exclusive_group(required=True)
    mode.add_argument("--create-db",
                      help="Strain database used to generate lineage databases")
    mode.add_argument("--query-db",
                      help="File listing query input assemblies")

    io_group = parser.add_argument_group("Input and output files")
    io_group.add_argument("--db-scheme", required=True,
                          help="Pickle describing the database scheme")
    io_group.add_argument("--output", required=True)
    io_group.add_argument("--model-dir")
    io_group.add_argument("--distances")
    io_group.add_argument("--external-clustering")
    io_group.add_argument("--clustering-col-name", default="Cluster")
    io_group.add_argument("--lineage-db-prefix", default="strain")
    io_group.add_argument("--write-networks", action="store_true")
    io_group.add_argument("--overwrite", action="store_true")

    a_group = parser.add_argument_group("Analysis options")
    a_group.add_argument("--threads", type=int, default=1)

    q_group = parser.add_argument_group("Strain model querying options")
    dist_type = q_group.add_mutually_exclusive_group()
    dist_type.add_argument("--core", action="store_true")
    dist_type.add_argument("--accessory", action="store_true")
    q_group.add_argument("--strand-preserved", action="store_true")
    q_group.add_argument("--min-kmer-count", type=int, default=0)
    q_group.add_argument("--exact-count", action="store_true")

    l_group = parser.add_argument_group("Lineage model options")
    l_group.add_argument("--ranks", default="1,2,3")
    l_group.add_argument("--max-search-depth", type=int, default=None)
    l_group.add_argument("--use-accessory", action="store_true")
    l_group.add_argument("--min-count", type=int, default=10)
    l_group.add_argument("--count-unique-distances", action="store_true")
    l_group.add_argument("--reciprocal-only", action="store_true")
    l_group.add_argument("--lineage-resolution", type=float,
                         default=DEFAULT_LINEAGE_RESOLUTION)
    parser.add_argument("--version", action="version",
                        version="%(prog)s " + __version__)
    from .common import add_accel_compat_flags

    add_accel_compat_flags(parser, "gpu-sketch", "gpu-dist", "gpu-graph", "deviceid")
    return parser.parse_args(arg_list)


def main(arg_list=None):
    args = get_options(arg_list)
    from .. import _device

    device, _ = _device.stage_devices(args)
    if args.create_db is not None:
        create_db(args, device)
    else:
        query_db(args, device)


def create_db(args, device=None):
    """(create_db, PopPUNK/lineages.py:155-325); the distances run on
    ``device``."""
    import pandas as pd

    from ..io.hdf5db import read_db_params, read_sketches
    from ..models import LineageFit
    from ..network.clusters import print_clusters
    from ..network.graph import Graph, save_network
    from ..ops.distances import query_db as run_query_db
    from ..utils import create_overall_lineage, store_pickle

    if not args.overwrite:
        for path in (args.output + ".csv", args.db_scheme):
            if os.path.exists(path):
                sys.stderr.write("Output file " + path
                                 + " exists; use --overwrite to replace it\n")
                sys.exit(1)

    ref_db = args.create_db.rstrip("/")
    model_dir = (args.model_dir or ref_db).rstrip("/")
    clustering_file = args.external_clustering or os.path.join(
        model_dir, os.path.basename(model_dir) + "_clusters.csv")
    strains = pd.read_csv(clustering_file, dtype=str).groupby(
        args.clustering_col_name)

    distances = args.distances or os.path.join(
        ref_db, os.path.basename(ref_db) + ".dists")
    kmers, sketch_size, codon_phased = read_db_params(ref_db)
    rank_list = sorted(int(x) for x in args.ranks.split(","))
    if args.max_search_depth is not None:
        if args.max_search_depth <= max(rank_list):
            sys.stderr.write("Max search depth must be greater than the "
                             "highest lineage rank\n")
            sys.exit(1)
        max_search_depth = args.max_search_depth
    else:
        max_search_depth = max(rank_list) * SEARCH_DEPTH_FACTOR

    sys.stderr.write("Generating databases for individual strains\n")
    all_isolates = []
    lineage_dbs = {}
    overall_lineage = {}
    for strain, isolates in strains:
        strain_db_name = (args.lineage_db_prefix + "_" + str(strain)
                          + "_lineage_db")
        isolate_list = isolates[isolates.columns.values[0]].to_list()
        if len(isolate_list) < args.min_count:
            continue
        if len(isolate_list) <= max(rank_list):
            sys.stderr.write(
                f"Skipping strain {strain}: {len(isolate_list)} members is "
                f"not more than the maximum rank {max(rank_list)}\n")
            continue
        sys.stderr.write("Making database for strain " + str(strain) + "\n")
        lineage_dbs[strain] = strain_db_name
        all_isolates.extend(isolate_list)
        if os.path.isdir(strain_db_name) and args.overwrite:
            shutil.rmtree(strain_db_name)
        os.makedirs(strain_db_name, exist_ok=True)

        # link the strain DB to the parent sketch database
        src_db = os.path.join(ref_db, os.path.basename(ref_db) + ".h5")
        dest_db = os.path.join(strain_db_name,
                               os.path.basename(strain_db_name) + ".h5")
        if os.path.exists(dest_db) and args.overwrite:
            os.remove(dest_db)
        if not os.path.exists(dest_db):
            os.symlink(os.path.relpath(src_db, os.path.dirname(dest_db)),
                       dest_db)
        store_pickle(isolate_list, isolate_list, True, None,
                     os.path.join(strain_db_name, strain_db_name + ".dists"))

        sketches = read_sketches(strain_db_name, isolate_list)
        strain_dist_mat = run_query_db(
            sketches, None, list(kmers), self_mode=True,
            use_rc=not args.strand_preserved, device=device)

        model = LineageFit(strain_db_name, rank_list, max_search_depth,
                           args.reciprocal_only, args.count_unique_distances,
                           args.lineage_resolution,
                           dist_col=1 if args.use_accessory else 0)
        model.set_threads(args.threads)
        model.fit(strain_dist_mat)

        lineage_clusters = defaultdict(dict)
        for rank in rank_list:
            edges = model.assign(rank)
            G = Graph(len(isolate_list),
                      np.asarray(edges, dtype=np.int64).reshape(-1, 2))
            if args.write_networks:
                save_network(G, prefix=strain_db_name,
                             suffix="_rank_" + str(rank) + "_graph")
            clustering, _ = print_clusters(G, isolate_list, print_csv=False,
                                           write_unwords=False)
            lineage_clusters[rank] = dict(clustering)
            sys.stderr.write(
                "Network for rank " + str(rank) + " has "
                + str(max(lineage_clusters[rank].values())) + " lineages\n")

        overall_lineage[strain] = create_overall_lineage(rank_list,
                                                         lineage_clusters)
        _write_strain_lineage_csv(
            os.path.join(strain_db_name,
                         os.path.basename(strain_db_name) + "_lineages.csv"),
            isolate_list, rank_list, overall_lineage[strain])
        model.save()

    if not overall_lineage:
        sys.stderr.write("No strains had enough members "
                         f"(--min-count {args.min_count})\n")
        sys.exit(1)
    print_overall_clustering(overall_lineage, args.output + ".csv",
                             all_isolates)

    with open(args.db_scheme, "wb") as f:
        pickle.dump([ref_db, all_isolates, model_dir, clustering_file,
                     args.clustering_col_name, distances, list(kmers),
                     sketch_size, codon_phased, max_search_depth, rank_list,
                     args.use_accessory, args.min_count,
                     args.count_unique_distances, args.reciprocal_only,
                     args.strand_preserved, args.core, args.accessory,
                     lineage_dbs], f)


def _write_strain_lineage_csv(path, isolate_list, ranks, overall):
    with open(path, "w") as f:
        cols = ["Rank_" + str(r) for r in ranks] + ["overall"]
        f.write(",".join(["id"] + [c + "_Lineage" for c in cols]) + "\n")
        for name in isolate_list:
            f.write(",".join([name] + [str(overall[c][name]) for c in cols])
                    + "\n")


def query_db(args, device=None):
    """(query_db, PopPUNK/lineages.py:329-465); the distances and the
    strain model run on ``device``."""
    from ..assign import assign_query_hdf5
    from ..io.hdf5db import construct_database, create_database_dir
    from ..utils import create_overall_lineage

    with open(args.db_scheme, "rb") as f:
        (ref_db, rlist, model_dir, clustering_file, clustering_col_name,
         distances, kmers, sketch_size, codon_phased, max_search_depth,
         rank_list, use_accessory, min_count, count_unique_distances,
         reciprocal_only, strand_preserved, core, accessory,
         lineage_dbs) = pickle.load(f)

    previous_clustering_file = os.path.join(
        model_dir, os.path.basename(model_dir) + "_clusters.csv")
    external_clustering = None
    if clustering_file != previous_clustering_file:
        external_clustering = clustering_file

    qc_dict = {"run_qc": False}
    if os.path.abspath(ref_db) == os.path.abspath(args.output):
        sys.stderr.write("--output and the scheme's reference database must "
                         "differ to prevent overwrite.\n")
        sys.exit(1)

    create_database_dir(args.output, kmers)
    q_names = construct_database(
        args.query_db, kmers, sketch_size, args.output,
        threads=args.threads, overwrite=True, codon_phased=codon_phased,
        calc_random=False, strand_preserved=strand_preserved)

    isolate_clustering = assign_query_hdf5(
        ref_db, q_names, args.output, qc_dict, update_db=False,
        write_references=False, distances=distances, serial=False,
        stable=None, threads=args.threads, overwrite=True, plot_fit=0,
        graph_weights=False, model_dir=model_dir,
        strand_preserved=strand_preserved, previous_clustering=model_dir,
        external_clustering=external_clustering, core=core,
        accessory=accessory, save_partial_query_graph=False,
        use_full_network=True, dist_device=device, model_device=device)

    query_strains = defaultdict(list)
    for isolate, strain in isolate_clustering.items():
        if isolate in set(q_names):
            query_strains[str(strain)].append(isolate)

    overall_lineage = {}
    for strain, strain_queries in query_strains.items():
        if strain in lineage_dbs:
            lineage_distances = os.path.join(
                lineage_dbs[strain],
                os.path.basename(lineage_dbs[strain]) + ".dists")
            lineage_clustering = assign_query_hdf5(
                lineage_dbs[strain], strain_queries, args.output, qc_dict,
                update_db=False, write_references=False,
                distances=lineage_distances, serial=False, stable=None,
                threads=args.threads, overwrite=True, plot_fit=0,
                graph_weights=False, model_dir=lineage_dbs[strain],
                strand_preserved=strand_preserved,
                previous_clustering=lineage_dbs[strain],
                external_clustering=None, core=core, accessory=accessory,
                save_partial_query_graph=False, use_full_network=True,
                dist_device=device, model_device=device)
            overall_lineage[strain] = lineage_clustering
        else:
            overall_lineage[strain] = {
                "overall": {q: "novel" for q in strain_queries}}

    print_overall_clustering(overall_lineage, args.output + ".csv", q_names)


def print_overall_clustering(overall_lineage, output, include_list):
    """(print_overall_clustering, PopPUNK/lineages.py:467-492)."""
    include = set(include_list)
    first_strain = list(overall_lineage.keys())[0]
    ranks = list(overall_lineage[first_strain].keys())
    isolate_info = {}
    for strain in overall_lineage:
        for rank in ranks:
            if rank not in overall_lineage[strain]:
                continue
            for isolate, value in overall_lineage[strain][rank].items():
                if isolate in include:
                    if isolate in isolate_info:
                        isolate_info[isolate].append(str(value))
                    else:
                        isolate_info[isolate] = [str(strain), str(value)]

    with open(output, "w") as out:
        out.write("id,Cluster," + ",".join(ranks) + "\n")
        for isolate, info in isolate_info.items():
            out.write(isolate + "," + ",".join(info) + "\n")


if __name__ == "__main__":
    main()
