"""Convenience driver: create-db -> dbscan fit -> refine fit
(scripts/poppunk_easy_run.py)."""

import argparse
import sys


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_easy_run",
        description="Run create-db, then dbscan and refine model fits")
    parser.add_argument("--r-files", required=True,
                        help="List of sequence names and files")
    parser.add_argument("--output", required=True)
    parser.add_argument("--analysis-args", default="",
                        help="Other arguments to pass to the main CLI, "
                             'e.g. "--min-k 13 --max-k 29"')
    parser.add_argument("--viz", action="store_true",
                        help="Also run microreact visualisation")
    parser.add_argument("--viz-args", default="")
    return parser.parse_args(arg_list)


def main(arg_list=None):
    args = get_options(arg_list)
    from ..cli.main import main as poppunk_main

    extra = args.analysis_args.split()
    sys.stderr.write("Running --create-db\n")
    poppunk_main(["--create-db", "--r-files", args.r_files,
                  "--output", args.output] + extra)
    sys.stderr.write("Running --fit-model dbscan\n")
    poppunk_main(["--fit-model", "dbscan", "--ref-db", args.output,
                  "--output", args.output] + extra)
    sys.stderr.write("Running --fit-model refine\n")
    poppunk_main(["--fit-model", "refine", "--ref-db", args.output,
                  "--output", args.output] + extra)

    if args.viz:
        from ..cli.visualise import main as vis_main

        vis_main(["--ref-db", args.output, "--output",
                  args.output + "_viz", "--microreact"]
                 + args.viz_args.split())


if __name__ == "__main__":
    main()
