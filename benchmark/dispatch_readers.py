"""What the serving cells' dispatch readers share: the ``follows`` and
``ahead`` counters of the session's ``serve.dispatch`` spans, taken in the
traced window.

A dispatch follows another when it is not its request's first; it is
ahead when, once its bucket was packed, the request's previous dispatch
had not yet completed on the card: the host's pack ran under the card's
work. A reader returns None when its run has nothing for it to read: no
trace, or a program whose dispatches carry no such counter.
"""

from . import program_spans


def ahead_share(run):
    """100 x the summed ``ahead`` over the summed ``follows`` of the
    window's ``serve.dispatch`` spans (%)."""
    found = program_spans.window_spans(run)
    if found is None:
        return None
    counted = [s.counts for s in found if s.name == "serve.dispatch"
               and "follows" in s.counts
               and program_spans._inside(s, run.trace.window)]
    follows = sum(c["follows"] for c in counted)
    if not follows:
        return None
    return 100.0 * sum(c.get("ahead", 0) for c in counted) / follows
