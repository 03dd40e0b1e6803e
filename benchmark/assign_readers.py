"""What the assign-batch cell's per-layer readers share: the work of the
traced requests, and the session's ``serve.*`` spans.

A request of q queries needs q x n pairs against the n resident
references and reads each query's and each reference's planes once; the
session computes every padded bucket against every reference to deliver
them. A reader returns None when its run has nothing for it to read: no
trace, no requests, or a program that records no ``serve.*`` spans.
"""

from . import program_spans, readers, roofline

# the session's host work: the queries' packing, their upload through
# page-locked memory, the answers' lookup (less the wait for the result)
HOST = ("dists.pack_planes", "serve.upload", "serve.attach")


def work(run):
    """(pairs needed, genomes read) of the traced window's whole
    requests."""
    if not run.work.get("requests"):
        return None
    return run.work["pairs"], run.work["genomes_read"]


def match_counts_roofline(run):
    got = work(run)
    if got is None:
        return None
    pairs, genomes = got
    K, P, w32, wp = readers.geometry(run.config)
    bound_s, _ = roofline.match_counts_bound_s(
        pairs, K, P, w32, genomes * K * P * wp * 4, run.sms)
    return readers.kernel_roofline(run, readers.MATCH_COUNTS, bound_s)


def epilogue_roofline(run):
    got = work(run)
    if got is None:
        return None
    cfg = run.config
    pairs, genomes = got
    bound_s, _ = roofline.epilogue_bound_s(
        pairs, genomes, len(cfg["kmers"]), run.sms,
        random_correct=cfg["random_correct"], use_rc=cfg["use_rc"])
    return readers.kernel_roofline(run, readers.EPILOGUE, bound_s)


def host_share(run):
    """Percent of the traced window that the host spent in its own time
    of the session's host work (HOST)."""
    found = program_spans.window_spans(run)
    if found is None or run.trace.window_s <= 0:
        return None
    if not any(s.name.startswith("serve.") for s in found):
        return None
    own = program_spans._clipped_self_s(found, run.trace.window)
    return 100.0 * sum(own[s.index] for s in found
                       if s.name in HOST) / run.trace.window_s


def rows_per_query(run):
    """Summed ``rows`` of the window's ``serve.dispatch`` spans over the
    summed ``queries`` of its ``serve.assign`` spans: the padded buckets'
    rows computed per query asked."""
    found = program_spans.window_spans(run)
    if found is None:
        return None
    inside = [s for s in found if program_spans._inside(s, run.trace.window)]
    rows = sum(s.counts.get("rows", 0) for s in inside
               if s.name == "serve.dispatch")
    queries = sum(s.counts.get("queries", 0) for s in inside
                  if s.name == "serve.assign")
    return rows / queries if rows and queries else None


def bytes_per_pair(run):
    """Summed ``bytes`` of the window's ``serve.upload`` spans (the
    queries' planes, lengths and frequencies moved to the card) over the
    pairs its requests need, queries x references."""
    found = program_spans.window_spans(run)
    got = work(run)
    if found is None or got is None:
        return None
    moved = [s.counts.get("bytes", 0) for s in found
             if s.name == "serve.upload"
             and program_spans._inside(s, run.trace.window)]
    return sum(moved) / got[0] if moved else None
