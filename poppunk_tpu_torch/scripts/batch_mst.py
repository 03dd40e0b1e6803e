"""Batched lineage build + sparse MST driver
(scripts/poppunk_batch_mst.py): split the input into batches, build a
lineage database on the first batch, grow it with --update-db for each
further batch (bounded memory: the Nk + 2NQ + Q^2 - Q recurrence,
reference docs/mst.rst:125-144), then compute the MST from the final
rank fit."""

import argparse
import os
import shutil
import sys


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_batch_mst",
        description="Batched lineage model building and sparse MST")
    parser.add_argument("--r-files", required=True,
                        help="Sample names and sequence file list")
    parser.add_argument("--batch-file",
                        help="CSV mapping sample to batch (name,batch); "
                             "without it, samples are split evenly")
    parser.add_argument("--n-batches", type=int, default=10,
                        help="Number of batches if no --batch-file")
    parser.add_argument("--output", required=True)
    parser.add_argument("--rank", type=int, default=10,
                        help="Rank used for the sparse MST")
    parser.add_argument("--sketch-size", type=int, default=10000)
    parser.add_argument("--min-k", type=int, default=13)
    parser.add_argument("--max-k", type=int, default=29)
    parser.add_argument("--k-step", type=int, default=4)
    parser.add_argument("--threads", type=int, default=1)
    parser.add_argument("--use-accessory", action="store_true")
    parser.add_argument("--keep-intermediates", action="store_true")
    parser.add_argument("--previous-clustering")
    parser.add_argument("--no-plot", action="store_true")
    return parser.parse_args(arg_list)


def read_batches(args):
    with open(args.r_files) as f:
        lines = [line.rstrip("\n") for line in f if line.strip()]
    name_of = {line.split("\t")[0]: line for line in lines}
    if args.batch_file:
        import csv

        batches = {}
        with open(args.batch_file) as f:
            for row in csv.reader(f):
                batches.setdefault(row[1], []).append(name_of[row[0]])
        return [batches[k] for k in sorted(batches)]
    n = max(1, args.n_batches)
    size = (len(lines) + n - 1) // n
    return [lines[i:i + size] for i in range(0, len(lines), size)]


def main(arg_list=None):
    args = get_options(arg_list)
    from ..cli.assign import main as assign_main
    from ..cli.main import main as poppunk_main
    from ..cli.mst import main as mst_main

    batches = read_batches(args)
    sys.stderr.write(f"Running in {len(batches)} batches\n")
    work = args.output + "_batches"
    os.makedirs(work, exist_ok=True)

    kargs = ["--min-k", str(args.min_k), "--max-k", str(args.max_k),
             "--k-step", str(args.k_step),
             "--sketch-size", str(args.sketch_size),
             "--threads", str(args.threads), "--no-plot"]
    lineage_args = ["--ranks", str(args.rank)]
    if args.use_accessory:
        lineage_args.append("--use-accessory")

    current_db = os.path.join(work, "batch0")
    rfile0 = os.path.join(work, "rfile0.txt")
    with open(rfile0, "w") as f:
        f.write("\n".join(batches[0]) + "\n")
    poppunk_main(["--create-db", "--r-files", rfile0,
                  "--output", current_db] + kargs)
    poppunk_main(["--fit-model", "lineage", "--ref-db", current_db,
                  "--output", current_db, "--no-plot", "--threads",
                  str(args.threads)] + lineage_args)

    for idx, batch in enumerate(batches[1:], start=1):
        rfile = os.path.join(work, f"rfile{idx}.txt")
        with open(rfile, "w") as f:
            f.write("\n".join(batch) + "\n")
        next_db = os.path.join(work, f"batch{idx}")
        assign_main(["--db", current_db, "--query", rfile,
                     "--output", next_db, "--update-db", "full",
                     "--threads", str(args.threads)])
        if not args.keep_intermediates and idx > 1:
            shutil.rmtree(current_db, ignore_errors=True)
        current_db = next_db

    # final MST from the rank fit of the accumulated database
    base = os.path.join(current_db, os.path.basename(current_db))
    mst_args = ["--rank-fit", base + f"_rank_{args.rank}_fit.npz",
                "--distance-pkl", base + ".dists.pkl",
                "--output", args.output]
    if args.previous_clustering:
        mst_args += ["--previous-clustering", args.previous_clustering]
    else:
        mst_args += ["--previous-clustering", base + "_lineages.csv"]
    if args.no_plot:
        mst_args.append("--no-plot")
    mst_main(mst_args)

    if not args.keep_intermediates:
        for idx in range(len(batches) - 1):
            shutil.rmtree(os.path.join(work, f"batch{idx}"),
                          ignore_errors=True)
    sys.stderr.write("Done\n")


if __name__ == "__main__":
    main()
