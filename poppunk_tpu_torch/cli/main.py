"""poppunk_tpu_torch — main CLI: --create-db, --qc-db, --fit-model
{bgmm,dbscan,refine,lineage,threshold}, --use-model.

Counterpart of poppunk_tpu/cli/main.py (PopPUNK/__main__.py:245-791) with
a copy of its parser (the same flags and defaults) and the same on-disk
conventions. The distance engine, the BGMM fit and assignment, the HDBSCAN
Boruvka sweep of the DBSCAN fit and the refine boundary sweep run on
``cuda:<--deviceid>`` unless ``POPPUNK_TPU_TORCH_DEVICE=cpu`` asks for the
CPU; ``--gpu-dist`` / ``--gpu-model`` keep their stage on the card even
then (_device.py). ``--gpu-sketch`` and ``--gpu-graph`` parse and the work
stays on the host, as do ``--qc-db`` and the lineage fit (host kNN).
"""

import argparse
import os
import shutil
import sys

import numpy as np

from .. import __version__, _device
from ..profiling import stage
from ..utils import create_overall_lineage, read_pickle, store_pickle
from .common import (default_dists, file_base, parse_kmers, qc_dict_from_args,
                     setup_output)

# Defaults (reference __main__.py:17-26)
DEFAULT_MAX_A_DIST = 0.5
DEFAULT_MAX_PI_DIST = 0.1
DEFAULT_MAX_ZERO = 0.05
DEFAULT_LENGTH_SIGMA = 5
DEFAULT_PROP_N = 0.1
BETWEENNESS_SAMPLE_DEFAULT = 100
DEFAULT_X = 0.2
DEFAULT_R = 50


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch",
        description="PopPUNK in PyTorch on a CUDA card: population "
                    "partitioning using nucleotide k-mers",
    )
    mode_group = parser.add_argument_group("Mode of operation")
    mode = mode_group.add_mutually_exclusive_group(required=True)
    mode.add_argument("--create-db", action="store_true",
                      help="Sketch input assemblies and calculate distances")
    mode.add_argument("--qc-db", action="store_true",
                      help="Run quality control on a database")
    mode.add_argument("--fit-model",
                      choices=["bgmm", "dbscan", "refine", "lineage",
                               "threshold"],
                      default=False,
                      help="Fit a model to a database's distances")
    mode.add_argument("--use-model", action="store_true",
                      help="Apply a previously fitted model to a database")

    io_group = parser.add_argument_group("Input files")
    io_group.add_argument("--ref-db", help="Location of built reference database")
    io_group.add_argument("--r-files", help="File listing reference input assemblies")
    io_group.add_argument("--distances", help="Prefix of input pickle of pre-calculated distances")
    io_group.add_argument("--external-clustering",
                          help="File with cluster definitions or other labels")

    out_group = parser.add_argument_group("Output options")
    out_group.add_argument("--output", help="Prefix for output files")
    out_group.add_argument("--plot-fit", type=int, default=0,
                           help="Create this many plots of k-mer/distance fits")
    out_group.add_argument("--overwrite", action="store_true",
                           help="Overwrite any existing database files")
    out_group.add_argument("--graph-weights", action="store_true",
                           help="Save within-strain Euclidean distances into the graph")

    kmer_group = parser.add_argument_group("Create DB options")
    kmer_group.add_argument("--min-k", type=int, default=13)
    kmer_group.add_argument("--max-k", type=int, default=29)
    kmer_group.add_argument("--k-step", type=int, default=4)
    kmer_group.add_argument("--sketch-size", type=int, default=10000)
    kmer_group.add_argument("--codon-phased", action="store_true")
    kmer_group.add_argument("--min-kmer-count", type=int, default=0)
    kmer_group.add_argument("--exact-count", action="store_true")
    kmer_group.add_argument("--strand-preserved", action="store_true")

    qc_group = parser.add_argument_group("Quality control options")
    qc_group.add_argument("--qc-keep", action="store_true",
                          help="Only write failing sequences to a file, do not remove")
    qc_group.add_argument("--remove-samples",
                          help="A list of names to remove from the database")
    qc_group.add_argument("--retain-failures", action="store_true")
    qc_group.add_argument("--max-a-dist", type=float, default=DEFAULT_MAX_A_DIST)
    qc_group.add_argument("--max-pi-dist", type=float, default=DEFAULT_MAX_PI_DIST)
    qc_group.add_argument("--max-zero-dist", type=float, default=DEFAULT_MAX_ZERO)
    qc_group.add_argument("--length-sigma", type=int, default=DEFAULT_LENGTH_SIGMA)
    qc_group.add_argument("--length-range", nargs=2, type=int, default=[None, None])
    qc_group.add_argument("--prop-n", type=float, default=DEFAULT_PROP_N)
    qc_group.add_argument("--upper-n", type=int, default=None)
    qc_group.add_argument("--auto-max-dists",
                          choices=["core", "accessory", "both"],
                          default=None,
                          help="Find the optimal maximum distances to "
                               "permit by percentile jump detection")
    qc_group.add_argument("--x", type=float, default=DEFAULT_X)
    qc_group.add_argument("--r", type=int, default=DEFAULT_R)

    model_group = parser.add_argument_group("Model fit options")
    model_group.add_argument("--model-subsample", type=int, default=100000)
    model_group.add_argument("--assign-subsample", type=int, default=5000)
    model_group.add_argument("--for-refine", action="store_true",
                             help="Fit only to be used as a refine start (skip full assignment)")
    model_group.add_argument("--K", type=int, default=2,
                             help="Maximum number of mixture components")
    model_group.add_argument("--D", type=int, default=100,
                             help="Maximum number of clusters in DBSCAN fitting")
    model_group.add_argument("--min-cluster-prop", type=float, default=0.0001)
    model_group.add_argument("--dbscan-grid-assign", action="store_true",
                             help="Assign pairs to DBSCAN clusters via the "
                                  "quantised decision grid (~100x faster; "
                                  "exact beyond half a grid cell from "
                                  "decision boundaries)")
    model_group.add_argument("--threshold", type=float,
                             help="Cutoff if using --fit-model threshold")

    refine_group = parser.add_argument_group("Refine model options")
    refine_group.add_argument("--pos-shift", type=float, default=0.0)
    refine_group.add_argument("--neg-shift", type=float, default=0.0)
    refine_group.add_argument("--manual-start",
                              help="A file containing a start point")
    refine_group.add_argument("--model-dir", help="Directory containing model to use")
    refine_group.add_argument("--score-idx", type=int, default=0, choices=[0, 1, 2])
    refine_group.add_argument("--summary-sample", type=int, default=None)
    refine_group.add_argument("--betweenness-sample", type=int,
                              default=BETWEENNESS_SAMPLE_DEFAULT)
    refine_mode = refine_group.add_mutually_exclusive_group()
    refine_mode.add_argument("--unconstrained", action="store_true")
    refine_mode.add_argument("--multi-boundary", type=int, default=0)
    refine_group.add_argument("--indiv-refine", choices=["both", "core", "accessory"],
                              default=None)

    lineage_group = parser.add_argument_group("Lineage analysis options")
    lineage_group.add_argument("--ranks", default="1,2,3")
    lineage_group.add_argument("--count-unique-distances", action="store_true")
    lineage_group.add_argument("--reciprocal-only", action="store_true")
    lineage_group.add_argument("--max-search-depth", type=int, default=10000)
    lineage_group.add_argument("--write-lineage-networks", action="store_true")
    lineage_group.add_argument("--use-accessory", action="store_true")
    lineage_group.add_argument("--lineage-resolution", type=float, default=1e-10)

    other = parser.add_argument_group("Other options")
    other.add_argument("--threads", type=int, default=1)
    other.add_argument("--no-plot", action="store_true")
    other.add_argument("--profile", action="store_true",
                       help="Print per-stage timings at exit")
    other.add_argument("--no-local", action="store_true")
    other.add_argument("--version", action="version",
                       version="%(prog)s " + __version__)
    other.add_argument("--citation", action="store_true",
                       help="Give a methods paragraph and citations")

    from .common import add_accel_compat_flags

    add_accel_compat_flags(parser, "gpu-sketch", "gpu-dist", "gpu-model",
                           "gpu-graph", "deviceid")
    return parser.parse_args(arg_list)


def main(arg_list=None):
    args = get_options(arg_list)
    if args.profile:
        from ..profiling import enable

        enable(True)
    if args.citation:
        from ..citation import print_citation

        print_citation(args)
        sys.exit(0)
    if args.qc_db:
        return qc_db(args)  # host only: sketch attributes and distances
    dist_device, model_device = _device.stage_devices(args)
    if args.create_db:
        return create_db(args, dist_device)
    return fit_model(args, model_device)


def create_db(args, device):
    """Sketch on the host, then all-vs-all distances on ``device``."""
    from ..io.hdf5db import (construct_database, create_database_dir,
                             get_database_statistics, read_sketches)

    from ..ops.distances import query_db

    if args.r_files is None:
        sys.stderr.write("--create-db requires --r-files\n")
        sys.exit(1)
    output = setup_output(args.output)
    klist = parse_kmers(args.min_k, args.max_k, args.k_step)
    sys.stderr.write(f"Sketching genomes using k = {klist}\n")
    create_database_dir(output, klist)

    with stage("sketching"):
        names = construct_database(
            args.r_files, klist, args.sketch_size // 64, output,
            threads=args.threads, overwrite=args.overwrite,
            strand_preserved=args.strand_preserved,
            min_count=args.min_kmer_count, use_exact=args.exact_count,
            codon_phased=args.codon_phased,
        )

    sys.stderr.write(f"Calculating all-vs-all distances on {device}\n")
    with stage("distances", sync=True):
        sketches = read_sketches(output, names)
        dist_mat = query_db(sketches, None, klist, self_mode=True,
                            random_correct=True,
                            use_rc=not args.strand_preserved, device=device)
    store_pickle(names, names, True, dist_mat, default_dists(output))

    if not args.no_plot:
        try:
            from ..plotting import plot_database_evaluations, plot_scatter

            plot_scatter(dist_mat, output,
                         os.path.basename(output) + " distances")
            lengths, ambiguous = get_database_statistics(output)
            plot_database_evaluations(output, lengths, ambiguous)
        except Exception as e:  # plotting must never kill the pipeline
            sys.stderr.write(f"Plotting failed: {e}\n")
    if args.plot_fit > 0:
        plot_kmer_fits(output, names, klist, args.plot_fit,
                       not args.strand_preserved, device)
    sys.stderr.write("Done\n")
    return names, dist_mat


def plot_kmer_fits(db_prefix, names, klist, count, use_rc, device, seed=42):
    """Random sample of per-pair k-mer/Jaccard fit plots (--plot-fit,
    reference __main__.py:407-418)."""
    from ..io.hdf5db import read_sketches
    from ..plotting import plot_fit

    from ..ops.distances import query_db
    from ..ops.kmer_fit import fit_kmer_curve_np

    rng = np.random.default_rng(seed)
    sketches = read_sketches(db_prefix, names)
    for i in range(count):
        a, b = rng.choice(len(names), size=2, replace=False)
        pair = [sketches[a], sketches[b]]
        raw, corrected = (
            query_db(pair, None, klist, self_mode=True, jaccard=True,
                     random_correct=rc, use_rc=use_rc, device=device)[0]
            for rc in (False, True))
        dists = query_db(pair, None, klist, self_mode=True, use_rc=use_rc,
                         device=device)[0]
        raw_fit = fit_kmer_curve_np(raw, np.asarray(klist))
        plot_fit(klist, raw, np.array(raw_fit), corrected, np.array(dists),
                 file_base(db_prefix) + f"_fit_example_{i + 1}",
                 f"Example fit {i + 1} - {names[a]} vs. {names[b]}")


def qc_db(args):
    """Sketch and distance QC of a database, removing the failures and
    the ``--remove-samples`` list (reference __main__.py:421-470)."""
    from ..qc import (auto_dist_find, qc_dist_mat, remove_qc_fail, sketch_qc)

    if args.ref_db is None:
        sys.stderr.write("--qc-db requires --ref-db\n")
        sys.exit(1)
    ref_db = args.ref_db.rstrip("/")
    output = args.output.rstrip("/") if args.output else ref_db
    if output != ref_db:
        setup_output(output)

    distances = args.distances or default_dists(ref_db)
    rlist, qlist, self_mode, X = read_pickle(distances, enforce_self=True)

    qc_dict = qc_dict_from_args(args)
    if args.auto_max_dists:
        auto_max_pi, auto_max_a = auto_dist_find(X, qc_dict)
        if args.auto_max_dists in ("both", "core"):
            qc_dict["max_pi_dist"] = auto_max_pi
        if args.auto_max_dists in ("both", "accessory"):
            qc_dict["max_a_dist"] = auto_max_a

    fail_dicts = []
    pass_sketch, fail_sketch = sketch_qc(ref_db, rlist, qc_dict)
    fail_dicts.append(fail_sketch)
    pass_dist, fail_dist = qc_dist_mat(X, rlist, rlist, ref_db, qc_dict)
    fail_dicts.append(fail_dist)
    passed = [x for x in pass_sketch if x in set(pass_dist)]

    if args.remove_samples:
        with open(args.remove_samples) as f:
            to_remove = set(line.strip() for line in f if line.strip())
        fail_dicts.append({s: ["Requested removal"] for s in to_remove
                           if s in set(passed)})
        passed = [x for x in passed if x not in to_remove]

    if len(passed) < len(rlist):
        remove_qc_fail(qc_dict, rlist, passed, fail_dicts, ref_db, X,
                       output, strand_preserved=args.strand_preserved,
                       threads=args.threads)
        sys.stderr.write(
            f"{len(rlist) - len(passed)} samples failed QC and were removed\n"
        )
    else:
        sys.stderr.write("All samples passed QC\n")
        if output != ref_db:
            store_pickle(rlist, rlist, True, X, default_dists(output))
    sys.stderr.write("Done\n")


def fit_model(args, device):
    """--fit-model bgmm / dbscan / refine / threshold / lineage or
    --use-model on ``device``, then the network, clusters and clique-pruned
    references (a lineage model: its per-rank networks and lineage CSV) on
    the host."""
    from ..models import (BGMMFit, DBSCANFit, LineageFit, RefineFit,
                          load_cluster_fit)

    if args.ref_db is None:
        sys.stderr.write("Fitting a model requires --ref-db\n")
        sys.exit(1)
    ref_db = args.ref_db.rstrip("/")
    output = setup_output(args.output or ref_db)
    distances = args.distances or default_dists(ref_db)
    if not os.path.isfile(distances + ".pkl"):
        sys.stderr.write(
            f"Cannot find distances at {distances}.pkl — run --create-db "
            "first, or point --distances at an existing output\n")
        sys.exit(1)
    rlist, _, _, X = read_pickle(distances, enforce_self=True)
    sys.stderr.write(f"Loaded distances for {len(rlist)} samples\n")

    assignments = None
    with stage("model_fit", sync=True):
        if args.use_model:
            model_dir = (args.model_dir or ref_db).rstrip("/")
            model = load_cluster_fit(file_base(model_dir) + "_fit.pkl",
                                     file_base(model_dir) + "_fit.npz",
                                     out_prefix=output,
                                     max_samples=args.model_subsample,
                                     device=device)
            model.set_threads(args.threads)
            if model.type == "lineage":
                model.fit(X)
            elif model.type == "dbscan":
                assignments = model.assign(
                    X, use_grid=args.dbscan_grid_assign)
            else:
                assignments = model.assign(X, *(
                    [args.assign_subsample] if model.type == "bgmm" else []))
        elif args.fit_model == "bgmm":
            sys.stderr.write(f"Fitting bgmm model on {device}\n")
            model = BGMMFit(output, max_samples=args.model_subsample,
                            max_batch_size=args.assign_subsample,
                            assign_points=not args.for_refine, device=device)
            model.set_threads(args.threads)
            assignments = model.fit(X, args.K)
        elif args.fit_model == "dbscan":
            sys.stderr.write(f"Fitting dbscan model on {device}\n")
            model = DBSCANFit(output, max_samples=args.model_subsample,
                              max_batch_size=args.assign_subsample,
                              assign_points=not args.for_refine,
                              grid_assign=args.dbscan_grid_assign,
                              device=device)
            model.set_threads(args.threads)
            assignments = model.fit(X, args.D, args.min_cluster_prop)
        elif args.fit_model == "refine":
            model_dir = (args.model_dir or ref_db).rstrip("/")
            start_model = load_cluster_fit(
                file_base(model_dir) + "_fit.pkl",
                file_base(model_dir) + "_fit.npz",
                max_samples=args.model_subsample, device=device)
            model = RefineFit(output, device=device)
            model.set_threads(args.threads)
            assignments = model.fit(
                X, rlist, start_model,
                max_move=args.pos_shift, min_move=args.neg_shift,
                startFile=args.manual_start,
                indiv_refine=args.indiv_refine,
                unconstrained=args.unconstrained,
                multi_boundary=args.multi_boundary,
                score_idx=args.score_idx,
                no_local=args.no_local,
                betweenness_sample=args.betweenness_sample,
                sample_size=args.summary_sample,
            )
        elif args.fit_model == "threshold":
            if args.threshold is None:
                sys.stderr.write("--fit-model threshold requires "
                                 "--threshold\n")
                sys.exit(1)
            model = RefineFit(output, device=device)
            model.set_threads(args.threads)
            assignments = model.apply_threshold(X, args.threshold)
        else:  # lineage
            from .. import SEARCH_DEPTH_FACTOR

            ranks = sorted(int(x) for x in args.ranks.split(","))
            max_search = args.max_search_depth or max(
                int(SEARCH_DEPTH_FACTOR * max(ranks)), 25)
            model = LineageFit(
                output, ranks, max_search, args.reciprocal_only,
                args.count_unique_distances, args.lineage_resolution,
                dist_col=1 if args.use_accessory else 0,
            )
            model.set_threads(args.threads)
            model.fit(X)

    model.save()
    if not args.no_plot:
        try:
            model.plot(X, assignments)
        except Exception as e:
            sys.stderr.write(f"Plotting failed: {e}\n")

    if args.for_refine and not args.use_model:
        # assignments cover only the fit subsample; points are assigned
        # when the model is refined (reference __main__.py:630-632)
        sys.stderr.write(
            'Initial model fit complete; points will be assigned when this '
            'model is refined\nusing "--fit-model refine"\n')
        sys.stderr.write("Done\n")
        return model, assignments

    if model.type == "lineage":
        lineage_clusters = fit_lineage_networks(model, rlist, X, output, args)
        sys.stderr.write("Done\n")
        return model, lineage_clusters

    with stage("network+refs"):
        make_network_and_refs(model, assignments, rlist, X, output, args)
    sys.stderr.write("Done\n")
    return model, assignments


def fit_lineage_networks(model, rlist, X, output, args):
    """Per-rank networks + lineage CSV (reference __main__.py:655-700)."""
    from ..network import Graph, print_clusters
    from ..network.graph import save_network

    n = len(rlist)
    lineage_clusters = {}
    for rank in model.ranks:
        sys.stderr.write(f"Network for rank {rank}\n")
        edges = model.assign(rank)
        weights = model.edge_weights(rank) if args.graph_weights else None
        G = Graph(n, np.asarray(edges, dtype=np.int64).reshape(-1, 2), weights)
        clustering, _ = print_clusters(
            G, rlist, out_prefix=file_base(output) + f"_rank{rank}",
            print_csv=False, write_unwords=False,
        )
        lineage_clusters[rank] = {
            name: clustering[name] for name in rlist
        }
        if args.write_lineage_networks:
            save_network(G, prefix=output, suffix=f"_rank_{rank}_graph")
        if rank == min(model.ranks):
            # the lowest rank's network is the overall one (reference
            # __main__.py keeps it as the output _graph)
            save_network(G, prefix=output, suffix="_graph")

    overall = create_overall_lineage(model.ranks, lineage_clusters)
    write_lineage_csv(file_base(output) + "_lineages.csv", rlist, model.ranks,
                      overall)
    # the overall-rank network is the lowest rank's
    return lineage_clusters


def write_lineage_csv(path, rlist, ranks, overall):
    with open(path, "w") as f:
        cols = ["Rank_" + str(r) for r in ranks] + ["overall"]
        f.write(",".join(["id"] + cols) + "\n")
        for name in rlist:
            f.write(",".join([name] + [str(overall[c][name]) for c in cols])
                    + "\n")


def make_network_and_refs(model, assignments, rlist, X, output, args):
    """fit -> network -> clusters -> clique pruning
    (reference __main__.py:635-791)."""
    from ..io.hdf5db import remove_from_db
    from ..network.cliques import extract_references
    from ..network.clusters import print_clusters
    from ..network.construct import construct_network_from_assignments
    from ..network.graph import save_network
    from ..qc import prune_distance_matrix
    from ..utils import db_h5_path

    # which distance projections to build networks for (indiv-refine adds
    # core-only / accessory-only boundaries, reference __main__.py:635-654)
    fit_types = {"combined": assignments}
    suffixes = {"combined": ""}
    if model.type == "refine" and model.indiv_fitted:
        if args.indiv_refine in ("both", "core"):
            fit_types["core"] = model.assign(X, slope=0)
            suffixes["core"] = "_core"
        if args.indiv_refine in ("both", "accessory"):
            fit_types["accessory"] = model.assign(X, slope=1)
            suffixes["accessory"] = "_accessory"

    isolate_clustering = {}
    graphs = {}
    for fit_type, y in fit_types.items():
        suffix = suffixes[fit_type]
        G = construct_network_from_assignments(
            rlist, rlist, y, within_label=model.within_label, dist_mat=X,
            use_weights=args.graph_weights,
            sample_size=args.summary_sample,
            betweenness_sample=args.betweenness_sample,
        )
        graphs[fit_type] = G
        save_network(G, prefix=output, suffix=suffix + "_graph")
        clustering, _ = print_clusters(
            G, rlist, out_prefix=file_base(output) + suffix,
            external_cluster_csv=args.external_clustering,
            write_unwords=(fit_type == "combined"),
        )
        isolate_clustering[fit_type] = clustering

    # clique-based reference pruning on the combined network
    G = graphs["combined"]
    _, ref_names, _, G_ref = extract_references(
        G, rlist, output, threads=args.threads)
    if len(ref_names) < len(rlist):
        sys.stderr.write(f"Pruned network to {len(ref_names)} references\n")
        save_network(G_ref, prefix=output, suffix=".refs_graph")
        non_refs = set(rlist) - set(ref_names)
        prune_distance_matrix(rlist, non_refs, X,
                              file_base(output) + ".refs.dists")
        ref_db = args.ref_db.rstrip("/")
        if os.path.isfile(db_h5_path(ref_db)):
            tmp = remove_from_db(ref_db, output, non_refs)
            os.rename(tmp, file_base(output) + ".refs.h5")
    else:
        sys.stderr.write("All samples kept as references\n")

    # keep the full dists available under the output prefix too
    if (args.output and args.output.rstrip("/") != args.ref_db.rstrip("/")
            and not os.path.isfile(default_dists(output) + ".pkl")):
        store_pickle(rlist, rlist, True, X, default_dists(output))
        ref_h5 = db_h5_path(args.ref_db.rstrip("/"))
        if os.path.isfile(ref_h5) and not os.path.isfile(db_h5_path(output)):
            shutil.copy(ref_h5, db_h5_path(output))
    return isolate_clustering


if __name__ == "__main__":
    main()
