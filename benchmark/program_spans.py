"""What the create-db engine's per-layer readers share: the program's own
spans (``poppunk_tpu_torch.profiling.spans()``: name, parent, start, end
and counts, on the host's perf_counter clock, which ``trace.profile``
aligns the device trace to), taken in the traced window.

The program records them while a torch profiler runs, so a ``--trace 1``
run holds the window's spans. A reader returns None when the run has no
trace, or the program records no spans (one that predates the recorder).
"""

import bisect
from collections import defaultdict

from .trace import DEVICE_CATS, _union

ASSEMBLY = ("dists.slice", "dists.concat")
PASS = "dists.condensed_self_block"
MOVED = ("dists.upload", "dists.fetch_copy")


def window_spans(run):
    """The program's spans that overlap the traced window, or None."""
    if run.trace is None:
        return None
    try:
        from poppunk_tpu_torch.profiling import spans
    except ImportError:
        return None
    w0, w1 = run.trace.window
    found = [s for s in spans() if s.end > w0 and s.start < w1]
    return found or None


def _inside(s, window):
    """Whether the span's midpoint lies in the window: a span counted
    whole is counted in one window alone."""
    return window[0] <= (s.start + s.end) / 2 < window[1]


def _clipped_self_s(found, window):
    """{span index: its time in the window less its children's}."""
    w0, w1 = window

    def clipped(s):
        return max(0.0, min(s.end, w1) - max(s.start, w0))

    out = {s.index: clipped(s) for s in found}
    for s in found:
        if s.parent in out:
            out[s.parent] -= clipped(s)
    return out


def assembly_share(run):
    """Percent of the traced window that the host spent in its own time
    of the row slicing and the output's concatenation."""
    found = window_spans(run)
    if found is None or run.trace.window_s <= 0:
        return None
    own = _clipped_self_s(found, run.trace.window)
    return 100.0 * sum(own[s.index] for s in found
                       if s.name in ASSEMBLY) / run.trace.window_s


def faults_per_pass(run):
    """Minor page faults of the window's whole create-db passes, per
    pass."""
    found = window_spans(run)
    passes = run.work.get("passes")
    if found is None or not passes:
        return None
    calls = [s for s in found if s.name == PASS and s.parent is None
             and _inside(s, run.trace.window)]
    if not calls:
        return None
    return sum(s.counts.get("faults", 0) for s in calls) / passes


def bytes_per_pair(run):
    """Bytes moved between host and device (the upload and each chunk's
    fetch) per condensed pair delivered in the window."""
    found = window_spans(run)
    passes = run.work.get("passes")
    if found is None or not passes:
        return None
    moved = [s.counts.get("bytes", 0) for s in found
             if s.name in MOVED and _inside(s, run.trace.window)]
    if not moved:
        return None
    n = int(run.config["n_genomes"])
    return sum(moved) / (passes * n * (n - 1) // 2)


def idle_by_span(run):
    """{innermost program span, or "outside the program": seconds of the
    traced window in which the device ran no kernel, copy or memset}, or
    None."""
    found = window_spans(run)
    if found is None:
        return None
    w0, w1 = run.trace.window
    busy = _union(run.trace._clipped(DEVICE_CATS))
    idle, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    by_index = {s.index: s for s in found}
    ordered = sorted(found, key=lambda s: (s.start, -s.end))
    starts = [s.start for s in ordered]
    edges = sorted({x for s in found for x in (s.start, s.end)})
    out = defaultdict(float)
    for a, b in idle:
        cuts = edges[bisect.bisect_right(edges, a):
                     bisect.bisect_left(edges, b)]
        for lo, hi in zip([a] + cuts, cuts + [b]):
            name = _innermost(ordered, starts, by_index, (lo + hi) / 2)
            out[name] += hi - lo
    return dict(out)


def _innermost(ordered, starts, by_index, t):
    """The name of the deepest span holding time t. Spans nest, so it is
    the latest-starting span before t, or the first of its ancestors,
    that has not ended."""
    i = bisect.bisect_right(starts, t) - 1
    s = ordered[i] if i >= 0 else None
    while s is not None and s.end < t:
        s = by_index.get(s.parent)
    return "outside the program" if s is None else s.name
