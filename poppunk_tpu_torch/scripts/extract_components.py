"""Write each network component as its own graphml
(scripts/poppunk_extract_components.py)."""

import argparse
import sys

import numpy as np
from scipy.stats import rankdata


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_extract_components",
        description="Extract graphml files of each component")
    parser.add_argument("--graph", required=True,
                        help="Input graph (.graph.npz or .graphml)")
    parser.add_argument("--output", required=True,
                        help="Prefix for output files")
    return parser.parse_args(arg_list)


def main(arg_list=None):
    args = get_options(arg_list)
    from ..network.components import connected_components
    from ..network.graph import load_network_file

    G = load_network_file(args.graph)
    labels, sizes = connected_components(G)
    ranks = len(sizes) - rankdata(sizes, method="ordinal").astype(int)
    sys.stderr.write("Writing " + str(len(sizes))
                     + " components in reverse order of size\n")
    vertex_labels = getattr(G, "vertex_labels",
                            [str(v) for v in range(G.n_vertices)])
    for comp in range(len(sizes)):
        members = np.flatnonzero(labels == comp)
        sub, old_ids = G.subgraph(members, relabel=True)
        fn = args.output + ".component_" + str(ranks[comp]) + ".graphml"
        sub.save_graphml(fn, [vertex_labels[i] for i in old_ids])


if __name__ == "__main__":
    main()
