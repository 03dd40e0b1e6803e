"""The device trace of a run's window and the harness's own spans.

``Spans`` records host-clock spans the harness opens around its calls
into the program (a pass, a request, a wait for the next arrival). In a
``--trace 1`` run, ``profile`` runs the window under ``torch.profiler``
(CUDA activity only) and returns a ``Trace``: the device's kernels,
copies and memsets from the profiler's chrome trace, aligned to the host
clock by a marker kernel launched at the window's start.

Per-layer metric readers take their numbers from here.
"""

import bisect
import json
import os
import re
import time
from collections import defaultdict
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host-clock spans: (name, start_s, end_s), perf_counter seconds."""

    def __init__(self):
        self.items = []

    @contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def durations(self, name):
        return [t1 - t0 for n, t0, t1 in self.items if n == name]


def short_name(name):
    """A kernel's name without its return type, arguments and template
    arguments; a copy's or memset's name as the profiler gives it."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = re.sub(r"\(anonymous namespace\)::|^void ", "", name)
    for stop in ("(", "<"):
        name = name.split(stop, 1)[0]
    return name.split("::")[-1][:80] or "?"


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device events of one window. ``events``: (name, cat, start_s,
    end_s) on the host's perf_counter clock; ``window``: (start_s, end_s)
    of the window on that clock."""

    def __init__(self, events, window, spans):
        self.events = events
        self.window = window
        self.spans = spans

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    def _clipped(self, cats):
        w0, w1 = self.window
        return [(max(s, w0), min(e, w1)) for _, c, s, e in self.events
                if c in cats and e > w0 and s < w1]

    def busy_s(self, cats=DEVICE_CATS):
        """Seconds of the window in which an event of ``cats`` ran."""
        return sum(e - s for s, e in _union(self._clipped(cats)))

    def kernel_seconds(self, pattern):
        """Summed device seconds of the kernels whose name matches the
        regular expression ``pattern`` (None if none ran)."""
        rx = re.compile(pattern)
        found = [e - s for n, c, s, e in self.events
                 if c == "kernel" and rx.search(n)]
        return sum(found) if found else None

    def _span_at(self, t):
        """The name of the latest-starting span that holds time t."""
        if not hasattr(self, "_starts"):
            self._sorted = sorted(self.spans.items, key=lambda x: x[1])
            self._starts = [s for _, s, _ in self._sorted]
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self._sorted[i][2] >= t:
            return self._sorted[i][0]
        return "outside any span"

    def breakdown(self, top=10):
        """{"device_ops": [[name, seconds]], "idle_gaps": [[label,
        seconds]]}: the device operations that took most time, and the
        idle time between them summed by what the host was doing (the
        harness's span) and which operations the gap lies between."""
        ops = defaultdict(float)
        dev = sorted((s, e, short_name(n)) for n, c, s, e in self.events
                     if c in DEVICE_CATS)
        for s, e, n in dev:
            ops[n] += e - s
        gaps = defaultdict(float)
        w0, w1 = self.window
        prev_end, prev_name = w0, "window start"
        for s, e, n in dev + [(w1, w1, "window end")]:
            if s > prev_end:
                gap0, gap1 = max(prev_end, w0), min(s, w1)
                if gap1 > gap0:
                    label = (f"{self._span_at((gap0 + gap1) / 2)}: "
                             f"{prev_name} -> {n}")
                    gaps[label] += gap1 - gap0
            if e > prev_end:
                prev_end, prev_name = e, n

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


def _marker(torch):
    torch.cuda._sleep(100)


def profile(torch, device, fn, spans, out_dir):
    """Run ``fn()`` under torch.profiler's CUDA tracing. Returns (fn's
    result, Trace). The device is idle when the window opens: a marker
    kernel launched then is the trace's first device event, and sets the
    offset between the trace's clock and the host's."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        host_marker = time.perf_counter()
        _marker(torch)
        torch.cuda.synchronize(device)
        w0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize(device)
        w1 = time.perf_counter()
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        raw = json.load(f)
    os.remove(path)
    events = [e for e in (raw.get("traceEvents") if isinstance(raw, dict)
                          else raw)
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    events.sort(key=lambda e: float(e["ts"]))
    offset = host_marker - float(events[0]["ts"]) * 1e-6
    out = [(e.get("name", "?"), e["cat"],
            float(e["ts"]) * 1e-6 + offset,
            (float(e["ts"]) + float(e.get("dur", 0))) * 1e-6 + offset)
           for e in events[1:]]
    trace = Trace(out, (w0, w1), spans)
    trace.marker = events[0].get("name", "?")
    return result, trace
