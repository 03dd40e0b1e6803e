"""Annotate an unweighted strain network with Euclidean (core, accessory)
edge weights (scripts/poppunk_add_weights.py)."""

import argparse

import numpy as np


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_add_weights",
        description="Add edge weights to a network")
    parser.add_argument("graph", help="Input graph (.graph.npz/.graphml)")
    parser.add_argument("distances", help="Prefix for distances (<p>.dists)")
    parser.add_argument("output", help="Prefix for output graph")
    parser.add_argument("--graphml", action="store_true",
                        help="Save output as graphml")
    return parser.parse_args(arg_list)


def main(arg_list=None):
    args = get_options(arg_list)
    from ..network.graph import Graph, load_network_file, save_network
    from ..pairs import pair_to_condensed
    from ..utils import read_pickle

    G = load_network_file(args.graph)
    rlist, qlist, self_mode, X = read_pickle(args.distances,
                                             enforce_self=True)
    if len(rlist) != G.n_vertices:
        raise RuntimeError("Graph size does not match distance matrix")

    i = np.minimum(G.edges[:, 0], G.edges[:, 1])
    j = np.maximum(G.edges[:, 0], G.edges[:, 1])
    rows = pair_to_condensed(i, j, len(rlist))
    weights = np.sqrt((X[rows] ** 2).sum(axis=1))
    weighted = Graph(G.n_vertices, G.edges, weights)
    save_network(weighted, prefix=args.output, suffix="_graph",
                 use_graphml=args.graphml,
                 vertex_labels=rlist if args.graphml else None)


if __name__ == "__main__":
    main()
