"""What the assign-network cell's per-layer readers share: the session's
``serve.*`` spans and counters in network mode, taken in the traced
window.

A request of q queries needs q x n query x reference pairs against the n
resident references, and, where one of its queries has no within-strain
reference, its q(q - 1)/2 query pairs too (``serve.assign``'s
``qq_pairs``). A reader returns None when its run has nothing for it to
read: no trace, no requests, or a program that records no network-mode
spans (one without the network mode).
"""

from . import program_spans, readers, roofline


def _assigns(run):
    """The window's ``serve.assign`` spans of network mode, or None."""
    found = program_spans.window_spans(run)
    if found is None:
        return None
    inside = [s for s in found if s.name == "serve.assign"
              and program_spans._inside(s, run.trace.window)
              and "qq_pairs" in s.counts]
    return inside or None


def _per_query(run, counter):
    assigns = _assigns(run)
    if assigns is None:
        return None
    queries = sum(s.counts.get("queries", 0) for s in assigns)
    return (sum(s.counts[counter] for s in assigns) / queries
            if queries else None)


def edges_per_query(run):
    """Within-strain query x reference pairs fetched per query."""
    return _per_query(run, "edges")


def qq_pairs_per_query(run):
    """Query pairs classified per query."""
    return _per_query(run, "qq_pairs")


def network_share(run):
    """Percent of the traced window the host spent in the self time of
    ``serve.network``: the attach to the resident network and the
    naming."""
    found = program_spans.window_spans(run)
    if (found is None or run.trace.window_s <= 0
            or not any(s.name == "serve.network" for s in found)):
        return None
    own = program_spans._clipped_self_s(found, run.trace.window)
    return 100.0 * sum(own[s.index] for s in found
                       if s.name == "serve.network") / run.trace.window_s


def bytes_per_pair(run):
    """Bytes moved between host and card (``serve.upload`` and
    ``serve.edges``) per query x reference pair of the window's
    requests."""
    found = program_spans.window_spans(run)
    pairs = run.work.get("pairs")
    if found is None or not pairs:
        return None
    moved = [s.counts.get("bytes", 0) for s in found
             if s.name in ("serve.upload", "serve.edges")
             and program_spans._inside(s, run.trace.window)]
    if not any(s.name == "serve.edges" for s in found):
        return None
    return sum(moved) / pairs


def _needed(run):
    """(pairs, genomes read) of the window's requests: their query x
    reference pairs and the query pairs of those that classify them;
    each query's and reference's planes read once a request, and the
    queries of a request that classifies its query pairs once more."""
    assigns = _assigns(run)
    if assigns is None or not run.work.get("requests"):
        return None
    qq = sum(s.counts["qq_pairs"] for s in assigns)
    again = sum(s.counts.get("queries", 0) for s in assigns
                if s.counts["qq_pairs"])
    return run.work["pairs"] + qq, run.work["genomes_read"] + again


def match_counts_roofline(run):
    """The count kernel's share of its roofline over the window's
    requests (``_needed``)."""
    got = _needed(run)
    if got is None:
        return None
    pairs, genomes = got
    K, P, w32, wp = readers.geometry(run.config)
    bound_s, _ = roofline.match_counts_bound_s(
        pairs, K, P, w32, genomes * K * P * wp * 4, run.sms)
    return readers.kernel_roofline(run, readers.MATCH_COUNTS, bound_s)


def epilogue_roofline(run):
    """The distance epilogue's share of its roofline over the window's
    requests (``_needed``)."""
    got = _needed(run)
    if got is None:
        return None
    cfg = run.config
    pairs, genomes = got
    bound_s, _ = roofline.epilogue_bound_s(
        pairs, genomes, len(cfg["kmers"]), run.sms,
        random_correct=cfg["random_correct"], use_rc=cfg["use_rc"])
    return readers.kernel_roofline(run, readers.EPILOGUE, bound_s)
