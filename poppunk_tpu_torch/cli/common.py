"""Shared CLI helpers: QC dict assembly, distance defaults, output setup.

Copied from ``poppunk_tpu/cli/common.py``, whose counterpart it is: this
package imports nothing of the JAX package.

The GPU flags keep the JAX package's names and defaults, and mean what
PopPUNK means by them.
"""

import os
import sys

from ..qc import DEFAULT_QC


def setup_output(output, overwrite=False):
    """Create the output directory (reference setupDBFuncs/createDatabaseDir
    convention: outputs live in a directory named by the prefix)."""
    if output is None:
        sys.stderr.write("--output required\n")
        sys.exit(1)
    output = output.rstrip("/")
    if os.path.isfile(output):
        sys.stderr.write(output + " exists as a file, cannot use as output\n")
        sys.exit(1)
    os.makedirs(output, exist_ok=True)
    return output


def file_base(prefix):
    return os.path.join(prefix, os.path.basename(prefix))


def default_dists(ref_db):
    return file_base(ref_db) + ".dists"


def qc_dict_from_args(args, run_qc=True):
    """Assemble the QC option dict (reference __main__.py:421-434)."""
    qc = dict(DEFAULT_QC)
    qc["run_qc"] = run_qc
    for key in ("length_sigma", "prop_n", "upper_n", "max_pi_dist",
                "max_a_dist", "x", "r"):
        if hasattr(args, key) and getattr(args, key) is not None:
            qc[key] = getattr(args, key)
    if getattr(args, "max_zero_dist", None) is not None:
        qc["prop_zero"] = args.max_zero_dist
    if getattr(args, "length_range", None):
        lr = args.length_range
        if isinstance(lr, str):
            lr = [int(x) for x in lr.split(",")]
        qc["length_range"] = lr
    if getattr(args, "retain_failures", False):
        qc["retain_failures"] = True
    if getattr(args, "qc_keep", False):
        qc["no_remove"] = True
    if getattr(args, "max_merge", None) is not None:
        qc["max_merge"] = args.max_merge
    if getattr(args, "betweenness", False):
        qc["betweenness"] = True
    if getattr(args, "type_isolate", None) is not None:
        qc["type_isolate"] = args.type_isolate
    return qc


_ON_CARD = ("on the CUDA card (the default; the flag keeps it there under "
            "POPPUNK_TPU_TORCH_DEVICE=cpu)")
_ACCEL_FLAG_DEFS = {
    "gpu-sketch": ("--gpu-sketch", dict(
        action="store_true", help="Accepted for compatibility with PopPUNK; "
        "sketching runs on the host")),
    "gpu-dist": ("--gpu-dist", dict(
        action="store_true", help="Distances " + _ON_CARD)),
    "gpu-model": ("--gpu-model", dict(
        action="store_true", help="Model fit and assignment " + _ON_CARD)),
    "gpu-graph": ("--gpu-graph", dict(
        action="store_true", help="Accepted for compatibility with PopPUNK; "
        "network code runs on the host")),
    "use-gpu": ("--use-gpu", dict(
        action="store_true", help="The SCE embedding (mandrake) "
        + _ON_CARD + "; elsewhere accepted for compatibility with PopPUNK, "
        "the work runs on the host")),
    "deviceid": ("--deviceid", dict(
        type=int, default=0, help="CUDA card to run on (default 0)")),
    "device-id": ("--device-id", dict(
        type=int, default=0, help="CUDA card to run on (default 0)")),
}


def add_accel_compat_flags(parser, *names):
    """Register PopPUNK's GPU flags (PopPUNK/__main__.py:216-220,
    docs/gpu.rst) with the JAX package's names and defaults. Here they
    mean what PopPUNK means by them (_device.py): --gpu-dist and
    --gpu-model put their stage on the card, --deviceid picks it;
    --gpu-sketch and --gpu-graph parse and the work stays on the host."""
    group = parser.add_argument_group("GPU options")
    for name in names:
        flag, kwargs = _ACCEL_FLAG_DEFS[name]
        group.add_argument(flag, **kwargs)


def parse_kmers(min_k, max_k, k_step):
    if min_k >= max_k:
        sys.stderr.write("Minimum k-mer length must be smaller than maximum\n")
        sys.exit(1)
    if min_k < 3:
        sys.stderr.write("Minimum k-mer length must be at least 3\n")
        sys.exit(1)
    return list(range(min_k, max_k + 1, k_step))
