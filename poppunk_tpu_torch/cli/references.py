"""poppunk_tpu_references — standalone clique-based reference picking.

Counterpart of ``poppunk_references`` (PopPUNK/reference_pick.py).

Its parser is a copy of the JAX package's (poppunk_tpu/cli/references.py);
this package imports nothing of the JAX package. Its work runs
on the host; like every entry point of this package it refuses a host
without CUDA unless ``POPPUNK_TPU_TORCH_DEVICE=cpu`` asks for the CPU.
"""

import argparse
import os
import sys

from .. import __version__


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_references",
        description="Pick references from an existing network",
    )
    io_group = parser.add_argument_group("Input files")
    io_group.add_argument("--network", required=True,
                          help="Network file (.graph.npz or .graphml)")
    io_group.add_argument("--distances", required=True,
                          help="Prefix of input pickle of distances")
    io_group.add_argument("--ref-db",
                          help="Location of sketch database (to also prune)")
    io_group.add_argument("--model",
                          help="Directory containing the model fit (copied "
                               "to the output)")
    io_group.add_argument("--clusters", default=None,
                          help="Specify a different clustering (e.g. "
                               "core/accessory) to copy with the model")
    out_group = parser.add_argument_group("Output options")
    out_group.add_argument("--output", required=True)
    other = parser.add_argument_group("Other options")
    other.add_argument("--threads", type=int, default=1)
    other.add_argument("--version", action="version",
                       version="%(prog)s " + __version__)

    from .common import add_accel_compat_flags

    add_accel_compat_flags(parser, "use-gpu")
    return parser.parse_args(arg_list)


def main(arg_list=None):
    args = get_options(arg_list)
    from .. import _device

    _device.resolve()
    from ..io.hdf5db import remove_from_db
    from ..network.cliques import extract_references
    from ..network.graph import load_network_file, save_network
    from ..qc import prune_distance_matrix
    from ..utils import db_h5_path, read_pickle

    output = args.output.rstrip("/")
    os.makedirs(output, exist_ok=True)

    rlist, qlist, self_mode, X = read_pickle(args.distances,
                                             enforce_self=True)
    G = load_network_file(args.network)

    ref_idx, ref_names, ref_file, G_ref = extract_references(
        G, rlist, output, threads=args.threads)
    sys.stderr.write(f"Kept {len(ref_names)} references\n")
    save_network(G_ref, prefix=output, suffix=".refs_graph")

    non_refs = set(rlist) - set(ref_names)
    prune_distance_matrix(
        rlist, non_refs, X,
        os.path.join(output, os.path.basename(output) + ".refs.dists"))

    if args.ref_db is not None and os.path.isfile(db_h5_path(args.ref_db)):
        tmp = remove_from_db(args.ref_db, output, non_refs)
        os.rename(tmp, os.path.join(
            output, os.path.basename(output) + ".refs.h5"))

    if args.model is not None:
        from shutil import copyfile

        from ..models import load_cluster_fit

        model_base = os.path.join(args.model, os.path.basename(args.model))
        model = load_cluster_fit(model_base + "_fit.pkl",
                                 model_base + "_fit.npz")
        model.copy(output)
        # carry the clustering over too (reference_pick.py:124-128);
        # --clusters picks an alternative CSV (e.g. core/accessory)
        cluster_file = args.clusters or model_base + "_clusters.csv"
        if os.path.isfile(cluster_file):
            copyfile(cluster_file, os.path.join(
                output, os.path.basename(output) + "_clusters.csv"))


if __name__ == "__main__":
    main()
