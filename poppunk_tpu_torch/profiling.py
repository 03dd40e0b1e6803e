"""Per-stage wall-clock timing.

Counterpart of poppunk_tpu/profiling.py's ``stage``: a context manager that
accumulates wall time per pipeline stage, reported at process exit when
profiling is on (``--profile`` on the CLIs, or POPPUNK_TPU_PROFILE=1).
With ``sync=True`` the stage waits for queued CUDA work on entry and exit
(``torch.cuda.synchronize``), so it is charged its true device time.
"""

import atexit
import contextlib
import os
import sys
import time
from collections import OrderedDict

import torch

_ENABLED = bool(os.environ.get("POPPUNK_TPU_PROFILE"))
_STAGES = OrderedDict()  # name -> [total_seconds, calls]
_REPORT_REGISTERED = False


def enable(flag=True):
    global _ENABLED, _REPORT_REGISTERED
    _ENABLED = flag
    if flag and not _REPORT_REGISTERED:
        atexit.register(report)
        _REPORT_REGISTERED = True


if _ENABLED:
    enable(True)


def _device_sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage(name, sync=False):
    """Time a pipeline stage."""
    if not _ENABLED:
        yield
        return
    if sync:
        _device_sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _device_sync()
        entry = _STAGES.setdefault(name, [0.0, 0])
        entry[0] += time.perf_counter() - t0
        entry[1] += 1


def report(stream=None):
    if not _STAGES:
        return
    stream = stream or sys.stderr
    total = sum(v[0] for v in _STAGES.values())
    stream.write("\n== poppunk_tpu_torch stage timings ==\n")
    width = max(len(k) for k in _STAGES)
    for name, (secs, calls) in _STAGES.items():
        share = 100.0 * secs / total if total else 0.0
        stream.write(f"  {name.ljust(width)}  {secs:9.3f} s  "
                     f"x{calls:<5d} {share:5.1f}%\n")
    stream.write(f"  {'TOTAL'.ljust(width)}  {total:9.3f} s\n")
