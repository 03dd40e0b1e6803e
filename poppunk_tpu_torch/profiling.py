"""The port's span and counter recorder, and the ``--profile`` report.

``span(name, **counts)`` is a context manager that records one
``Span(index, name, parent, start, end, counts)``: ``parent`` is the index
of the enclosing span (None at the top), ``start`` and ``end`` are
``time.perf_counter()`` seconds (the clock a torch profiler's trace is
aligned to), and ``counts`` holds the process's minor page faults over the
span (``faults``, from ``getrusage``) beside whatever the call site counts
(``bytes``, ``pairs``, ``sketches``; ``Recording.add`` adds counts known
only inside the span). ``spans()`` returns what was recorded, oldest
first by end; past MAX_SPANS the oldest go, and ``dropped()`` counts them;
``clear()`` empties the store.

Spans record only while recording is on: after ``enable()`` (``--profile``
on the CLIs, or POPPUNK_TPU_PROFILE=1 in the environment), or while a torch
profiler runs. Off, a span reads two flags and hands back one shared
context that does nothing: no clock, no ``getrusage``, no synchronisation.

``stage(name, sync=False)`` is a span that, with ``sync=True``, waits for
the queued CUDA work on entry and exit, so it is charged its device time.

With ``enable()`` a report prints at exit, one line per span name: calls,
total seconds, self seconds (the total less its child spans'), the self
time's share of the top-level spans' total (the shares sum to 100%),
faults, bytes, and the sums of the other counts (``ready=19``).

The spans:

    sketching, distances, model_fit,   the stages of ``poppunk_tpu_torch``
      network+refs                     (cli/main.py)
    query_distances                    the assign CLI's distance stage
    dists.condensed_self_block         a whole all-vs-all call, parent of
                                       the spans below on one device
    dists.pack_planes                  sketches -> host planes; sketches,
                                       staged (the bytes written into a
                                       page-locked destination; else 0).
                                       In serve.AssignSession one a
                                       bucket, inside serve.dispatch
    dists.upload                       planes, lengths and frequencies to
                                       the device; bytes moved from the host
                                       (0 on the CPU), staged (the planes'
                                       bytes when they went through the
                                       page-locked slabs of
                                       ops/distances.py::_slab_copy, past
                                       one slab to a card; else 0)
    dists.enqueue                      a chunk's match-count and epilogue
                                       launches (host time); pairs
    dists.fetch_copy                   a chunk's result toward the host;
                                       bytes. In condensed_self_block the
                                       enqueue of its copy into a
                                       page-locked staging buffer on a
                                       card, nothing on the CPU; elsewhere
                                       the copy
    dists.fetch_wait                   in condensed_self_block the wait for
                                       that copy's event alone (ready 1
                                       when it had completed before the
                                       wait, always on the CPU); elsewhere
                                       the host buffer taken, then a
                                       stream synchronise
    dists.slice                        a chunk's condensed rows written
                                       into place in the output
    dists.concat                       condensed_self_block's output
                                       allocated; pairwise_block's chunks
                                       concatenated; bytes out
    scale.pass1                        the streaming tier's pass 1
                                       (scale.StreamingCondensed), parent
                                       of the scale spans below; chunks
                                       (folded chunks walked), pairs_needed
                                       (n_real (n_real - 1) / 2)
    scale.upload                       planes, lengths and frequencies to
                                       the device in StreamingCondensed;
                                       bytes moved from the host (0 on the
                                       CPU), staged (as dists.upload's)
    scale.tile                         one tile's match-count and epilogue
                                       launches (scale._tile_dists); pairs
                                       (rows x columns computed)
    scale.knn                          an owned tile's kNN
                                       (scale._merge_knn): the epilogue on
                                       the transposed counts, the key
                                       build, the top-k and the merge into
                                       the running kNN
    scale.fill                         a chunk's refine-band fill
                                       (scale._BandFill.add), the wait of
                                       its nonzero included; pairs (the
                                       chunk's in-band pairs)
    scale.fetch                        pass 1's kNN, maxima, subsample and
                                       band histogram to the host; bytes (0
                                       on the CPU)
    serve.assign                       one request of serve.AssignSession
                                       (assign_sketches), parent of the
                                       serve spans below; queries, pairs
                                       (queries x references), dispatches
    serve.dispatch                     one bucket's packing into the
                                       session's reused host buffer
                                       (dists.pack_planes), its padding,
                                       upload and fused enqueue; rows (the
                                       padded bucket), pairs (bucket x
                                       references), follows (1 on every
                                       dispatch after a request's first),
                                       ahead (1 when the request's previous
                                       dispatch had not completed on the
                                       card once this bucket was packed;
                                       0 on the CPU)
    serve.upload                       a bucket's planes, lengths and
                                       frequencies to the device, one
                                       copy out of that buffer; bytes
                                       moved from the host (0 on the CPU)
    serve.attach                       a bucket's answers looked up on the
                                       host; queries
    serve.fetch_wait                   inside serve.attach, the wait for
                                       the bucket's result on the host
"""

import atexit
import collections
import itertools
import os
import resource
import sys
import threading
import time

import torch
import torch.autograd.profiler as _torch_profiler

MAX_SPANS = 1 << 16

Span = collections.namedtuple("Span", "index name parent start end counts")

_ENABLED = bool(os.environ.get("POPPUNK_TPU_PROFILE"))
_REPORT_REGISTERED = False
_SPANS = collections.deque(maxlen=MAX_SPANS)
_INDEX = itertools.count()
_RECORDED = 0  # spans recorded since the last clear
_LOCK = threading.Lock()
_OPEN = threading.local()  # .stack: indices of this thread's open spans


def enable(flag=True):
    global _ENABLED, _REPORT_REGISTERED
    _ENABLED = flag
    if flag and not _REPORT_REGISTERED:
        atexit.register(report)
        _REPORT_REGISTERED = True


def recording():
    """Whether spans record now: after ``enable()``, or under a torch
    profiler (the flag torch keeps for such checks)."""
    return _ENABLED or _torch_profiler._is_profiler_enabled


def _faults():
    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt


class Recording:
    """An open span."""

    def __init__(self, name, counts):
        self.name = name
        self.counts = counts

    def add(self, **counts):
        """Add to the span's counts."""
        for key, value in counts.items():
            self.counts[key] = self.counts.get(key, 0) + value

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1] if stack else None
        self.index = next(_INDEX)
        stack.append(self.index)
        self.faults = _faults()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _RECORDED
        end = time.perf_counter()
        self.add(faults=_faults() - self.faults)
        _OPEN.stack.pop()
        with _LOCK:
            _SPANS.append(Span(self.index, self.name, self.parent,
                               self.start, end, self.counts))
            _RECORDED += 1
        return False


class _Off:
    """The span handed out while recording is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts):
        pass


_OFF = _Off()


def span(name, **counts):
    """Record the block as a span called ``name`` with ``counts``."""
    if not (_ENABLED or _torch_profiler._is_profiler_enabled):
        return _OFF
    return Recording(name, counts)


def spans():
    """The recorded spans, oldest first by end."""
    with _LOCK:
        return list(_SPANS)


def dropped():
    """Spans recorded since the last ``clear`` that the store let go."""
    with _LOCK:
        return _RECORDED - len(_SPANS)


def clear():
    global _RECORDED
    with _LOCK:
        _SPANS.clear()
        _RECORDED = 0


def _device_sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Stage(Recording):
    def __enter__(self):
        _device_sync()
        return super().__enter__()

    def __exit__(self, *exc):
        _device_sync()
        return super().__exit__(*exc)


def stage(name, sync=False):
    """A span around a pipeline stage; with ``sync`` it waits for the
    queued CUDA work on entry and exit."""
    if not recording():
        return _OFF
    return _Stage(name, {}) if sync else Recording(name, {})


def self_seconds(recorded):
    """{span index: its duration less its recorded children's}."""
    out = {s.index: s.end - s.start for s in recorded}
    for s in recorded:
        if s.parent in out:
            out[s.parent] -= s.end - s.start
    return out


def summary(recorded):
    """{name: [calls, total_s, self_s, faults, bytes, {other count: sum}]}
    in the order of each name's first start, and the top-level spans'
    total seconds."""
    own = self_seconds(recorded)
    rows = {}
    for s in sorted(recorded, key=lambda s: s.start):
        row = rows.setdefault(s.name, [0, 0.0, 0.0, 0, 0, {}])
        row[0] += 1
        row[1] += s.end - s.start
        row[2] += own[s.index]
        for key, value in s.counts.items():
            if key == "faults":
                row[3] += value
            elif key == "bytes":
                row[4] += value
            else:
                row[5][key] = row[5].get(key, 0) + value
    top = sum(s.end - s.start for s in recorded if s.parent not in own)
    return rows, top


def report(stream=None):
    recorded = spans()
    if not recorded:
        return
    stream = stream or sys.stderr
    rows, top = summary(recorded)
    width = max(len(k) for k in rows)
    stream.write("\n== poppunk_tpu_torch spans ==\n")
    stream.write(f"  {'span'.ljust(width)}  {'calls':>6}  {'total s':>9}  "
                 f"{'self s':>9}  {'self %':>6}  {'faults':>9}  "
                 f"{'bytes':>14}  other counts\n")
    for name, (calls, total, own, faults, nbytes, other) in rows.items():
        share = 100.0 * own / top if top else 0.0
        counts = " ".join(f"{k}={v}" for k, v in other.items())
        stream.write(f"  {name.ljust(width)}  {calls:6d}  {total:9.3f}  "
                     f"{own:9.3f}  {share:6.1f}  {faults:9d}  "
                     f"{nbytes:14d}  {counts}".rstrip() + "\n")
    stream.write(f"  {'TOTAL'.ljust(width)}  {'':6}  {top:9.3f}\n")
    if dropped():
        stream.write(f"  ({dropped()} earlier spans dropped)\n")


if _ENABLED:
    enable(True)
