"""What the per-layer metric readers (``benchmark/metrics/<name>.py``)
share: the device trace's shares and the kernels' rooflines, counted from
the work the inputs need (``roofline``), never from what a kernel pads to.

A reader returns None when its run has nothing for it to read (no trace,
no such kernel, no such work), and the metric is left out of the line.
"""

from . import roofline
from .population import plane_geometry
from .trace import DEVICE_CATS

MATCH_COUNTS = r"\bmatch_counts_kernel\b"
EPILOGUE = r"\bdist_epilogue_kernel\b"


def geometry(cfg):
    """(K, P, w32, Wp) of a configuration's sketches."""
    w32, wp = plane_geometry(int(cfg["sketchsize64"]))
    return len(cfg["kmers"]), int(cfg["bbits"]), w32, wp


def share(run, cats):
    """Percent of the traced window in which the device ran an operation
    of ``cats``."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * run.trace.busy_s(cats) / run.trace.window_s


def idle(run):
    busy = share(run, DEVICE_CATS)
    return None if busy is None else 100.0 - busy


def kernel_roofline(run, pattern, bound_s):
    """100 * the least time of the needed work over the summed device
    time of the kernels matching ``pattern``."""
    if run.trace is None or not bound_s:
        return None
    seconds = run.trace.kernel_seconds(pattern)
    return None if not seconds else 100.0 * bound_s / seconds


def createdb_work(run):
    """(passes, pairs, genomes read) of the traced create-db passes."""
    passes = run.work.get("passes")
    if not passes:
        return None
    n = int(run.config["n_genomes"])
    return passes, passes * n * (n - 1) // 2, passes * n


def match_counts_createdb(run):
    work = createdb_work(run)
    if work is None:
        return None
    passes, pairs, genomes = work
    K, P, w32, wp = geometry(run.config)
    bound_s, _ = roofline.match_counts_bound_s(
        pairs, K, P, w32, genomes * K * P * wp * 4, run.sms)
    return kernel_roofline(run, MATCH_COUNTS, bound_s)


def epilogue_createdb(run):
    work = createdb_work(run)
    if work is None:
        return None
    cfg = run.config
    _, pairs, genomes = work
    bound_s, _ = roofline.epilogue_bound_s(
        pairs, genomes, len(cfg["kmers"]), run.sms,
        random_correct=cfg["random_correct"], use_rc=cfg["use_rc"])
    return kernel_roofline(run, EPILOGUE, bound_s)

