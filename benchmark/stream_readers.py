"""What the stream-pass cell's per-layer readers share: the work of the
traced passes, and the program's ``scale.tile`` spans.

A pass needs the n_real (n_real - 1) / 2 real pairs and reads each
genome's planes once; the folded walk computes n_pad^2 pairs to deliver
them (each chunk's low and mirror rows against every genome). A reader
returns None when its run has nothing for it to read: no trace, no passes,
or a program that records no ``scale.tile`` spans.
"""

from . import program_spans, readers, roofline

TILE = "scale.tile"


def work(run):
    """(passes, pairs needed, genomes read) of the traced passes."""
    passes = run.work.get("passes")
    if not passes:
        return None
    n = int(run.config["n_genomes"])
    return passes, passes * n * (n - 1) // 2, passes * n


def match_counts_roofline(run):
    got = work(run)
    if got is None:
        return None
    _, pairs, genomes = got
    K, P, w32, wp = readers.geometry(run.config)
    bound_s, _ = roofline.match_counts_bound_s(
        pairs, K, P, w32, genomes * K * P * wp * 4, run.sms)
    return readers.kernel_roofline(run, readers.MATCH_COUNTS, bound_s)


def epilogue_roofline(run):
    got = work(run)
    if got is None:
        return None
    cfg = run.config
    _, pairs, genomes = got
    bound_s, _ = roofline.epilogue_bound_s(
        pairs, genomes, len(cfg["kmers"]), run.sms,
        random_correct=cfg["random_correct"], use_rc=cfg["use_rc"])
    return readers.kernel_roofline(run, readers.EPILOGUE, bound_s)


def pairs_per_needed(run):
    """Summed ``pairs`` of the window's ``scale.tile`` spans over the
    pairs the window's passes needed."""
    got = work(run)
    found = program_spans.window_spans(run)
    if got is None or found is None:
        return None
    tiles = [s.counts.get("pairs", 0) for s in found
             if s.name == TILE and program_spans._inside(s, run.trace.window)]
    if not tiles:
        return None
    return sum(tiles) / got[1]
