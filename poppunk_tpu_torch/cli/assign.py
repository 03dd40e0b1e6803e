"""poppunk_tpu_torch_assign — query assignment CLI.

Counterpart of poppunk_tpu/cli/assign.py (PopPUNK/assign.py:28-247) with a
copy of its parser, plus PopPUNK's ``--gpu-model`` (the JAX package's
parser does not register it). It assigns with any fitted model: BGMM,
DBSCAN, refine / threshold (queries join the reference network) and
lineage (the kNN is extended, ``_lineages.csv`` written; not with
``--serial`` or ``--stable``). Query distances and their fused
classification, and the model, run on ``cuda:<--deviceid>`` unless
``POPPUNK_TPU_TORCH_DEVICE=cpu`` asks for the CPU; ``--gpu-dist`` /
``--gpu-model`` keep their stage on the card even then (_device.py).
``--warmup`` loads the model and the serving references (the ``.refs``
subset unless ``--use-full-network``) as the reference does, and runs
every query-batch bucket once through the query path with the model's own
classifier (none for a lineage model): the kernels are built and the
allocator holds each bucket's buffers.
"""

import argparse
import sys

from .. import __version__, _device
from .common import qc_dict_from_args


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_assign",
        description="Assign queries to strains using a fitted "
                    "poppunk_tpu database, in PyTorch on a CUDA card",
    )
    io_group = parser.add_argument_group("Input files")
    io_group.add_argument("--db", required=True,
                          help="Location of built reference database")
    io_group.add_argument("--query", required="--warmup" not in
                          (arg_list if arg_list is not None else sys.argv),
                          help="File listing query input assemblies")
    io_group.add_argument("--warmup", action="store_true",
                          help="Pre-compile the serving programs for this "
                               "database's geometry (one per query-batch "
                               "bucket size) and exit — no request then "
                               "pays a first-compile")
    io_group.add_argument("--distances",
                          help="Prefix of input pickle of pre-calculated distances")
    io_group.add_argument("--external-clustering",
                          help="File with cluster definitions or other labels")

    out_group = parser.add_argument_group("Output options")
    out_group.add_argument("--output", required=True,
                           help="Prefix for output files (required)")
    out_group.add_argument("--plot-fit", type=int, default=0)
    out_group.add_argument("--write-references", action="store_true",
                           help="Write reference database isolates' cluster assignments too")
    out_group.add_argument("--update-db", default=False,
                           choices=["full", "fast", False],
                           help="Update reference database with query sequences")
    out_group.add_argument("--overwrite", action="store_true")
    out_group.add_argument("--graph-weights", action="store_true")
    out_group.add_argument("--save-partial-query-graph", action="store_true")

    kmer_group = parser.add_argument_group("Kmer comparison options")
    kmer_group.add_argument("--min-kmer-count", type=int, default=0)
    kmer_group.add_argument("--exact-count", action="store_true")
    kmer_group.add_argument("--strand-preserved", action="store_true")

    qc_group = parser.add_argument_group("Quality control options")
    qc_group.add_argument("--run-qc", action="store_true")
    qc_group.add_argument("--retain-failures", action="store_true")
    qc_group.add_argument("--max-a-dist", type=float, default=0.5)
    qc_group.add_argument("--max-pi-dist", type=float, default=0.1)
    qc_group.add_argument("--max-zero-dist", type=float, default=0.05)
    qc_group.add_argument("--max-merge", type=int, default=-1)
    qc_group.add_argument("--betweenness", action="store_true")
    qc_group.add_argument("--length-sigma", type=int, default=None)
    qc_group.add_argument("--length-range", nargs=2, type=int,
                          default=[None, None])
    qc_group.add_argument("--prop-n", type=float, default=None)
    qc_group.add_argument("--upper-n", type=int, default=None)

    query_group = parser.add_argument_group("Database querying options")
    query_group.add_argument("--serial", action="store_true",
                             help="Assign queries one-by-one, not treating them as a clique")
    query_group.add_argument("--stable", default=None,
                             choices=["core", "accessory"],
                             help="Use nearest neighbour rather than network for cluster assignment")
    query_group.add_argument("--model-dir",
                             help="Directory containing the model to use")
    query_group.add_argument("--previous-clustering",
                             help="Directory containing previous cluster definitions and network")
    query_group.add_argument("--core", action="store_true",
                             help="Use core-distance boundary (refine models)")
    query_group.add_argument("--accessory", action="store_true",
                             help="Use accessory-distance boundary (refine models)")
    query_group.add_argument("--use-full-network", action="store_true")

    other = parser.add_argument_group("Other options")
    other.add_argument("--threads", type=int, default=1)
    other.add_argument("--profile", action="store_true",
                       help="Print per-stage timings at exit")
    other.add_argument("--version", action="version",
                       version="%(prog)s " + __version__)
    other.add_argument("--citation", action="store_true")

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

        args.ref_db = args.db
        print_citation(args, assign=True)
        sys.exit(0)
    dist_device, model_device = _device.stage_devices(args)
    if args.warmup:
        sys.exit(warmup(args, dist_device, model_device))

    from ..assign import assign_query

    return assign_query(
        ref_db=args.db,
        q_files=args.query,
        output=args.output,
        qc_dict=qc_dict_from_args(args, run_qc=args.run_qc),
        update_db=args.update_db,
        write_references=args.write_references,
        distances=args.distances,
        serial=args.serial,
        stable=args.stable,
        threads=args.threads,
        overwrite=args.overwrite,
        plot_fit=args.plot_fit,
        graph_weights=args.graph_weights,
        model_dir=args.model_dir,
        strand_preserved=args.strand_preserved,
        previous_clustering=args.previous_clustering,
        external_clustering=args.external_clustering,
        core=args.core,
        accessory=args.accessory,
        save_partial_query_graph=args.save_partial_query_graph,
        use_full_network=args.use_full_network,
        min_kmer_count=args.min_kmer_count,
        exact_count=args.exact_count,
        dist_device=dist_device,
        model_device=model_device,
    )


def warmup(args, dist_device, model_device):
    """--warmup (the reference's poppunk_tpu/cli/assign.py:118-143): the
    model and the serving references, then every query-batch bucket once
    with the model's fused classifier. Returns the exit code."""
    import os

    from ..io.hdf5db import read_db_params, read_sketches
    from ..models import load_cluster_fit
    from ..ops.distances import warmup_query_programs
    from ..ops.fused_assign import model_post_spec

    db = args.db.rstrip("/")
    model_prefix = (args.model_dir or db).rstrip("/")
    base = os.path.join(model_prefix, os.path.basename(model_prefix))
    kmers = list(read_db_params(db)[0])
    model = load_cluster_fit(base + "_fit.pkl", base + "_fit.npz",
                             device=model_device)
    # warm against the .refs subset if present (the serving ref set)
    r_names = None
    refs_file = base + ".refs"
    if os.path.isfile(refs_file) and not args.use_full_network:
        with open(refs_file) as f:
            r_names = [line.rstrip() for line in f]
    r_sketches = read_sketches(db, r_names)
    n = warmup_query_programs(r_sketches, kmers,
                              post_spec=model_post_spec(model),
                              use_rc=not args.strand_preserved,
                              device=dist_device)
    sys.stderr.write(f"Warmed {n} serving programs for {db} "
                     f"({len(r_sketches)} references)\n")
    return 0


if __name__ == "__main__":
    main()
