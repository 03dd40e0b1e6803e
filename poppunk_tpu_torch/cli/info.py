"""poppunk_tpu_info — database report.

Counterpart of ``poppunk_info`` (PopPUNK/info.py).

Its parser is a copy of the JAX package's (poppunk_tpu/cli/info.py);
this package imports nothing of the JAX package. Its work runs
on the host; like every entry point of this package it refuses a host
without CUDA unless ``POPPUNK_TPU_TORCH_DEVICE=cpu`` asks for the CPU.
"""

import argparse
import os
import sys

import h5py
import numpy as np

from .. import __version__


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_info",
        description="Print information about a poppunk_tpu database",
    )
    parser.add_argument("--db", required=True,
                        help="Database name (directory prefix)")
    parser.add_argument("--simple", action="store_true",
                        help="Print only the database summary")
    parser.add_argument("--network-file", help="Network file to report on")
    parser.add_argument("--output", help="File to save per-sample info CSV")
    parser.add_argument("--threads", type=int, default=1)
    parser.add_argument("--version", action="version",
                        version="%(prog)s " + __version__)
    from .common import add_accel_compat_flags

    add_accel_compat_flags(parser, "use-gpu")
    return parser.parse_args(arg_list)


def main(arg_list=None):
    args = get_options(arg_list)
    from .. import _device

    _device.resolve()
    from ..network.graph import GRAPH_SUFFIX, load_network_file
    from ..network.summary import print_network_summary
    from ..utils import db_h5_path

    db = args.db.rstrip("/")
    with h5py.File(db_h5_path(db), "r") as ref_db:
        print("poppunk_tpu database:\t\t" + db)
        print("Sketch version:\t\t\t"
              + str(ref_db["sketches"].attrs.get("sketch_version", "?")))
        samples = list(ref_db["sketches"].keys())
        print("Number of samples:\t\t" + str(len(samples)))
        first = ref_db["sketches/" + samples[0]]
        kmers = np.asarray(first.attrs["kmers"])
        print("K-mer sizes:\t\t\t" + ",".join(str(int(k)) for k in kmers))
        print("Sketch size:\t\t\t"
              + str(int(first.attrs["sketchsize64"]) * 64))
        print("Contains random matches:\t" + str("random" in ref_db))
        print("Codon phased seeds:\t\t"
              + str(bool(ref_db["sketches"].attrs.get("codon_phased", False))))

        sample_info = []
        if not args.simple:
            for name in samples:
                s = ref_db["sketches/" + name]
                freq = np.asarray(s.attrs["base_freq"], dtype=float)
                sample_info.append({
                    "name": name,
                    "length": int(s.attrs["length"]),
                    "missing_bases": int(s.attrs["missing_bases"]),
                    "frequencies": freq,
                })

    if not args.simple:
        stem = os.path.join(db, os.path.basename(db) + "_graph")
        network_file = args.network_file or next(
            (stem + ext for ext in (GRAPH_SUFFIX, ".gt", ".csv.gz")
             if os.path.isfile(stem + ext)), stem + GRAPH_SUFFIX)
        G = None
        if os.path.isfile(network_file):
            if (network_file.endswith(".npz")
                    and not network_file.endswith(".graph.npz")):
                # a sparse lineage rank fit (reference info.py:128-131)
                import scipy.sparse

                from ..network.graph import Graph

                mat = scipy.sparse.load_npz(network_file).tocoo()
                G = Graph(mat.shape[0],
                          np.stack([mat.row, mat.col], axis=1), mat.data)
            else:
                G = load_network_file(network_file)
            print("\nNetwork summary for " + network_file)
            print_network_summary(G)
        else:
            sys.stderr.write("No network file found at " + network_file
                             + "\n")

        lines = ["name,length,missing_bases,A,C,G,T"
                 + (",degree,component" if G is not None else "")]
        if G is not None:
            from ..network.components import connected_components

            degrees = G.degrees()
            labels, _ = connected_components(G)
        for idx, info in enumerate(sample_info):
            row = [info["name"], str(info["length"]),
                   str(info["missing_bases"])] + [
                f"{f:.4f}" for f in info["frequencies"]]
            if G is not None and idx < G.n_vertices:
                row += [str(int(degrees[idx])), str(int(labels[idx]))]
            lines.append(",".join(row))
        text = "\n".join(lines) + "\n"
        if args.output:
            with open(args.output, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text)


if __name__ == "__main__":
    main()
