"""Package a fitted database for distribution
(scripts/poppunk_distribute_fit.py): collect the minimal artefact set
(sketch DB, dists, model, network, clusters) into full/refs bundles."""

import argparse
import os
import shutil
import sys
import tarfile


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_distribute_fit",
        description="Package a fitted database for distribution")
    parser.add_argument("--dbdir", required=True,
                        help="Database directory")
    parser.add_argument("--fitdir", required=True, help="Fit directory")
    parser.add_argument("--outpref", default="poppunk_tpu",
                        help="Output file prefix")
    parser.add_argument("--lineage", action="store_true",
                        help="Set if the fit is a lineage fit")
    parser.add_argument("--no-compress", action="store_true")
    return parser.parse_args(arg_list)


FULL_EXTS = [".h5", ".dists.pkl", ".dists.npy", "_fit.pkl", "_fit.npz",
             "_graph.graph.npz", "_clusters.csv", "_unword_clusters.csv"]
REFS_EXTS = [".refs", ".refs.h5", ".refs.dists.pkl", ".refs.dists.npy",
             ".refs_graph.graph.npz", "_fit.pkl", "_fit.npz",
             "_clusters.csv"]
LINEAGE_EXTS = ["_sparse_dists.npz", "_lineages.csv"]


def _collect(src_dirs, exts, out_dir, rename_refs=False):
    os.makedirs(out_dir, exist_ok=True)
    out_base = os.path.basename(out_dir)
    found = []
    for ext in exts:
        for src_dir in src_dirs:
            base = os.path.join(src_dir, os.path.basename(src_dir))
            src = base + ext
            if os.path.isfile(src):
                dest_ext = ext.replace(".refs", "") if rename_refs else ext
                dest = os.path.join(out_dir, out_base + dest_ext)
                shutil.copy(src, dest)
                found.append(ext)
                break
        # also pick up rank fits by glob
    for src_dir in src_dirs:
        base_dir = os.path.basename(src_dir)
        for fn in os.listdir(src_dir):
            if "_rank_" in fn and fn.endswith("_fit.npz"):
                shutil.copy(os.path.join(src_dir, fn),
                            os.path.join(out_dir,
                                         fn.replace(base_dir, out_base)))
    return found


def main(arg_list=None):
    args = get_options(arg_list)
    dbdir = args.dbdir.rstrip("/")
    fitdir = args.fitdir.rstrip("/")

    full_dir = args.outpref + "_full"
    exts = FULL_EXTS + (LINEAGE_EXTS if args.lineage else [])
    found = _collect([fitdir, dbdir], exts, full_dir)
    sys.stderr.write(f"Full bundle: {len(found)} artefacts -> {full_dir}\n")

    refs_dir = args.outpref + "_refs"
    found_refs = _collect([fitdir, dbdir], REFS_EXTS, refs_dir,
                          rename_refs=True)
    sys.stderr.write(
        f"Refs bundle: {len(found_refs)} artefacts -> {refs_dir}\n")

    if not args.no_compress:
        for d in (full_dir, refs_dir):
            with tarfile.open(d + ".tar.bz2", "w:bz2") as tar:
                tar.add(d, arcname=os.path.basename(d))
            sys.stderr.write("Wrote " + d + ".tar.bz2\n")


if __name__ == "__main__":
    main()
