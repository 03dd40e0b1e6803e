"""poppunk_tpu_mst — MST from sparse lineage-rank distances.

Counterpart of ``poppunk_mst`` (PopPUNK/sparse_mst.py).

Its parser is a copy of the JAX package's (poppunk_tpu/cli/mst.py);
this package imports nothing of the JAX package. Its work runs
on the host; like every entry point of this package it refuses a host
without CUDA unless ``POPPUNK_TPU_TORCH_DEVICE=cpu`` asks for the CPU.
"""

import argparse
import os
import shutil
import sys

import numpy as np
import scipy.sparse

from .. import __version__


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_mst",
        description="Create a minimum-spanning tree from a lineage rank fit",
    )
    io_group = parser.add_argument_group("Input files")
    io_group.add_argument("--rank-fit", required=True,
                          help="Location of rank fit (_rank_k_fit.npz)")
    io_group.add_argument("--previous-clustering",
                          help="CSV with previous cluster definitions")
    io_group.add_argument("--previous-mst", help="Graph file of a previous MST")
    io_group.add_argument("--distance-pkl",
                          help="Pickle of distance order (.dists.pkl)")
    io_group.add_argument("--previous-distance-pkl",
                          help="Pickle of distance order of the previous MST")
    io_group.add_argument("--display-cluster", default=None)

    out_group = parser.add_argument_group("Output options")
    out_group.add_argument("--output", required=True)
    out_group.add_argument("--no-plot", action="store_true")
    out_group.add_argument("--overwrite", action="store_true")

    other = parser.add_argument_group("Other options")
    other.add_argument("--threads", type=int, default=1)
    other.add_argument("--version", action="version",
                       version="%(prog)s " + __version__)
    from .common import add_accel_compat_flags

    add_accel_compat_flags(parser, "gpu-graph")
    return parser.parse_args(arg_list)


def generate_mst_from_sparse_input(sparse_mat, rlist, old_rlist=None,
                                   previous_mst=None):
    """(generate_mst_from_sparse_input, sparse_mst.py:82-124)."""
    from ..network.graph import Graph, load_network_file
    from ..network.mst import minimum_spanning_tree

    sparse_mat = sparse_mat.tocoo()
    edges = np.stack([sparse_mat.row, sparse_mat.col], axis=1)
    weights = np.asarray(sparse_mat.data, dtype=np.float64)
    G = Graph(len(rlist), edges, weights)
    if previous_mst is not None:
        prev = load_network_file(previous_mst)
        if old_rlist is not None:
            # remap old vertex ids into the new name order
            lookup = {name: idx for idx, name in enumerate(rlist)}
            remap = np.array([lookup[name] for name in old_rlist],
                             dtype=np.int64)
            prev_edges = remap[prev.edges]
        else:
            prev_edges = prev.edges
        G = G.add_edges(prev_edges, prev.weights
                        if prev.weights is not None
                        else np.zeros(prev.n_edges))
    return minimum_spanning_tree(G)


def main(arg_list=None):
    args = get_options(arg_list)
    from .. import _device

    _device.resolve()
    from ..network.graph import save_network
    from ..trees import mst_to_phylogeny, write_tree
    from ..utils import (read_isolate_type_from_csv,
                         read_rlist_from_distance_pickle)

    if (args.distance_pkl is not None) ^ (args.previous_clustering is not None):
        sys.stderr.write("To label strains, both --distance-pkl and "
                         "--previous-clustering must be provided\n")
        sys.exit(1)
    rlist = read_rlist_from_distance_pickle(args.distance_pkl,
                                            allow_non_self=False)
    old_rlist = None
    if args.previous_distance_pkl is not None:
        old_rlist = read_rlist_from_distance_pickle(
            args.previous_distance_pkl, allow_non_self=False)

    if args.overwrite and os.path.exists(args.output):
        if os.path.isdir(args.output):
            shutil.rmtree(args.output)
        else:
            os.remove(args.output)
    os.makedirs(args.output, exist_ok=True)

    sys.stderr.write("Loading distances into graph\n")
    sparse_mat = scipy.sparse.load_npz(args.rank_fit)
    G = generate_mst_from_sparse_input(sparse_mat, rlist,
                                       old_rlist=old_rlist,
                                       previous_mst=args.previous_mst)

    sys.stderr.write("Generating output\n")
    save_network(G, prefix=args.output, suffix="_MST", use_graphml=True,
                 vertex_labels=rlist)
    mst_as_tree = mst_to_phylogeny(G, rlist)
    write_tree(mst_as_tree, args.output, "_MST.nwk", overwrite=True)

    if not args.no_plot:
        from ..plotting import draw_mst

        if args.previous_clustering is not None:
            mode = ("lineages"
                    if args.previous_clustering.endswith("_lineages.csv")
                    else "clusters")
            isolate_clustering = read_isolate_type_from_csv(
                args.previous_clustering, mode=mode, return_dict=True)
        else:
            isolate_clustering = {"Cluster": {name: "0" for name in rlist}}

        clustering_name = list(isolate_clustering.keys())[0]
        if args.display_cluster is not None:
            if args.display_cluster not in isolate_clustering:
                sys.stderr.write("Unable to find clustering column "
                                 + args.display_cluster + "\n")
                sys.exit(1)
            clustering_name = args.display_cluster
        G.vertex_labels = list(rlist)
        filled = {n: isolate_clustering[clustering_name].get(n, "0")
                  for n in rlist}
        draw_mst(G, args.output, {clustering_name: filled},
                 clustering_name, True)


if __name__ == "__main__":
    main()
