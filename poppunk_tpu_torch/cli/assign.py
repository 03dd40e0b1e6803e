"""poppunk_tpu_torch_assign — query assignment CLI.

Counterpart of poppunk_tpu/cli/assign.py (PopPUNK/assign.py:28-247): the
reference parser, plus PopPUNK's ``--gpu-model`` (the JAX package's parser
does not register it). ``--gpu-dist`` runs the query distances and their
fused classification on ``cuda:<--deviceid>``, ``--gpu-model`` loads the
model there; ``--warmup`` (jit pre-compilation) has no counterpart here.
"""

import argparse
import sys

from poppunk_tpu.cli.assign import get_options as _reference_options
from poppunk_tpu.cli.common import qc_dict_from_args

from .. import _device


def get_options(arg_list=None):
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--gpu-model", action="store_true")
    known, rest = pre.parse_known_args(
        sys.argv[1:] if arg_list is None else arg_list)
    args = _reference_options(rest)
    args.gpu_model = known.gpu_model
    return args


def main(arg_list=None):
    args = get_options(arg_list)
    if args.profile:
        from ..profiling import enable

        enable(True)
    if args.citation:
        from poppunk_tpu.citation import print_citation

        args.ref_db = args.db
        print_citation(args, assign=True)
        sys.exit(0)
    if args.warmup:
        sys.stderr.write("--warmup pre-compiles jit programs; "
                         "poppunk_tpu_torch has none to warm\n")
        sys.exit(0)

    from ..assign import assign_query

    dist_device, model_device = _device.stage_devices(args)
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


if __name__ == "__main__":
    main()
