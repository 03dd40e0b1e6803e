"""poppunk_tpu_visualise — visualisation CLI.

Counterpart of ``poppunk_visualise`` (PopPUNK/visualise.py:33-192).

Its parser is a copy of the JAX package's (poppunk_tpu/cli/visualise.py);
this package imports nothing of the JAX package. The recalculated
distances (``--recalculate-distances``, ``--query-db``), NJ from 512
genomes and the SCE embedding run on ``cuda:<--deviceid>`` unless
``POPPUNK_TPU_TORCH_DEVICE=cpu`` asks for the CPU; ``--gpu-dist`` keeps
them on the card even then.
"""

import argparse

from .. import __version__


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_visualise",
        description="Create visualisations from poppunk_tpu results",
    )
    io_group = parser.add_argument_group("Input files")
    io_group.add_argument("--ref-db", required=True,
                          help="Location of built reference database")
    io_group.add_argument("--query-db", help="Location of query database")
    io_group.add_argument("--distances",
                          help="Prefix of input pickle of pre-calculated distances")
    io_group.add_argument("--rank-fit",
                          help="Location of rank fit (_rank_k_fit.npz), for MST")
    io_group.add_argument("--include-files",
                          help="File with list of sequences to include")
    io_group.add_argument("--external-clustering")
    io_group.add_argument("--model-dir")
    io_group.add_argument("--previous-clustering")
    io_group.add_argument("--previous-query-clustering")
    io_group.add_argument("--previous-mst")
    io_group.add_argument("--previous-distances")
    io_group.add_argument("--recalculate-distances", action="store_true",
                          help="Recalculate pairwise distances rather than "
                               "reading them from the distance file")
    io_group.add_argument("--read-distances", action="store_true",
                          help="Read pairwise distances from a file rather "
                               "than recalculate them (the default when a "
                               "distance file exists; accepted for "
                               "compatibility)")
    io_group.add_argument("--network-file")
    io_group.add_argument("--display-cluster",
                          help="Column of clustering CSV to use for colouring")
    io_group.add_argument("--use-partial-query-graph",
                          help="File with the list of sequences in the "
                               "partial query graph from poppunk_assign")
    io_group.add_argument("--extend-query-graph", action="store_true",
                          help="Extend the partial query graph to include "
                               "all other sequences in the same clusters")

    out_group = parser.add_argument_group("Output options")
    out_group.add_argument("--output", required=True)
    out_group.add_argument("--overwrite", action="store_true")

    viz_group = parser.add_argument_group("Visualisation options")
    viz_group.add_argument("--microreact", action="store_true")
    viz_group.add_argument("--cytoscape", action="store_true")
    viz_group.add_argument("--phandango", action="store_true")
    viz_group.add_argument("--grapetree", action="store_true")
    viz_group.add_argument("--tree", default="nj",
                           choices=["nj", "mst", "both", "none"])
    viz_group.add_argument("--mst-distances", default="core",
                           choices=["core", "accessory", "euclidean"])
    viz_group.add_argument("--rapidnj", default=None,
                           help="Path to rapidNJ binary (optional; on-device "
                                "NJ used otherwise)")
    viz_group.add_argument("--api-key", default=None)
    viz_group.add_argument("--perplexity", type=float, default=20.0)
    viz_group.add_argument("--maxIter", type=int, default=1000000)
    viz_group.add_argument("--info-csv",
                           help="Epidemiological information CSV for join")

    query_group = parser.add_argument_group("Database querying options")
    query_group.add_argument("--core-only", action="store_true",
                             help="Accepted for compatibility with PopPUNK "
                                  "(parsed but unused there too)")
    query_group.add_argument("--accessory-only", action="store_true",
                             help="Accepted for compatibility with PopPUNK "
                                  "(parsed but unused there too)")

    other = parser.add_argument_group("Other options")
    other.add_argument("--threads", type=int, default=1)
    other.add_argument("--strand-preserved", action="store_true")
    other.add_argument("--tmp", default="/tmp/")
    other.add_argument("--version", action="version",
                       version="%(prog)s " + __version__)

    from .common import add_accel_compat_flags

    add_accel_compat_flags(parser, "gpu-dist", "gpu-graph", "deviceid")
    return parser.parse_args(arg_list)


def main(arg_list=None):
    args = get_options(arg_list)
    from .. import _device
    from ..visualise import generate_visualisations

    device, _ = _device.stage_devices(args)
    generate_visualisations(
        query_db=args.query_db,
        ref_db=args.ref_db,
        distances=args.distances,
        rank_fit=args.rank_fit,
        threads=args.threads,
        output=args.output,
        external_clustering=args.external_clustering,
        microreact=args.microreact,
        phandango=args.phandango,
        grapetree=args.grapetree,
        cytoscape=args.cytoscape,
        perplexity=args.perplexity,
        maxIter=args.maxIter,
        strand_preserved=args.strand_preserved,
        include_files=args.include_files,
        model_dir=args.model_dir,
        previous_clustering=args.previous_clustering,
        previous_query_clustering=args.previous_query_clustering,
        previous_mst=args.previous_mst,
        previous_distances=args.previous_distances,
        network_file=args.network_file,
        info_csv=args.info_csv,
        rapidnj=args.rapidnj,
        api_key=args.api_key,
        tree=args.tree,
        mst_distances=args.mst_distances,
        overwrite=args.overwrite,
        display_cluster=args.display_cluster,
        use_partial_query_graph=args.use_partial_query_graph,
        extend_query_graph=args.extend_query_graph,
        recalculate_distances=(args.recalculate_distances
                               and not args.read_distances),
        tmp=args.tmp,
        device=device,
    )


if __name__ == "__main__":
    main()
