"""poppunk_tpu_mandrake — stochastic cluster embedding of accessory
distances.

Counterpart of ``poppunk_mandrake`` (PopPUNK/mandrake.py:123-183); the SCE
optimisation runs on device (embedding.py) instead of the
external C++/CUDA SCE package.

Its parser is a copy of the JAX package's (poppunk_tpu/cli/mandrake.py);
this package imports nothing of the JAX package. The SCE
optimiser runs on ``cuda:<--device-id>`` unless
``POPPUNK_TPU_TORCH_DEVICE=cpu`` asks for the CPU; ``--use-gpu`` keeps it
on the card even then.
"""

import argparse
import os

from .. import __version__


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_mandrake",
        description="Run mandrake/SCE embedding of accessory distances",
    )
    parser.add_argument("--distances", required=True,
                        help="Prefix of input pickle of distances")
    parser.add_argument("--output", required=True)
    parser.add_argument("--perplexity", type=float, default=30.0)
    parser.add_argument("--knn", type=int, default=50)
    parser.add_argument("--iter", type=int, default=100000)
    parser.add_argument("--cpus", type=int, default=1)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--version", action="version",
                        version="%(prog)s " + __version__)
    from .common import add_accel_compat_flags

    add_accel_compat_flags(parser, "use-gpu", "device-id")
    return parser.parse_args(arg_list)


def main(arg_list=None):
    args = get_options(arg_list)
    from .. import _device
    from ..embedding import generate_embedding
    from ..utils import read_pickle

    device = _device.flagged(args.use_gpu, args.device_id)
    rlist, qlist, self_mode, X = read_pickle(args.distances,
                                             enforce_self=True)
    os.makedirs(args.output, exist_ok=True)
    generate_embedding(rlist, X[:, 1], args.perplexity, args.output,
                       args.overwrite, kNN=args.knn, maxIter=args.iter,
                       n_threads=args.cpus, condensed=True, device=device)


if __name__ == "__main__":
    main()
