"""One run of one benchmark cell of poppunk_tpu_torch.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in the checkout's BENCHMARK.json.
Everything that belongs to it is found by name under ``benchmark/``:

    workloads/<cell>.json     its configuration, traffic and the limits
                              of its comparison
    configs/<config>.json     the deployment: sizes, guarantees, population
    traffic/<traffic>.json    the mix; its ``kind`` names the driver,
                              ``drivers/<kind>.py``, which sets up the
                              program, drives its entry point and compares
                              what the window produced with the reference
    metrics/<metric>.py       one reader per per-layer metric

Set-up (the import, the inputs made from ``--seed`` on the card, the
program's state, a warm-up of every shape the traffic uses) is timed from
the process's start as ``setup_s``; then the window runs for
``--seconds``. With ``--trace 1`` the window runs under torch.profiler and
the cell's per-layer metrics are reported instead of its end-to-end ones.
After the window the program's state is freed and the plain reference
checks what the window produced. The last line of standard output is one
JSON object; the numbers compared, each beside its limit, end standard
error and the JSON line.

A run needs a CUDA card for each chip the cell asks for; without one it
exits with code 2 and prints no result, as it does (code 3) if a module
of JAX or of the JAX package ``poppunk_tpu`` was imported.
"""

import time

IMPORTED_AT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded in a run: JAX and the JAX
# package (compared whole: the program's name, poppunk_tpu_torch, begins
# with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "poppunk_tpu")
CACHE_DIR = os.path.join(ROOT, ".bench_cache")


def process_start():
    """The process's start on the epoch clock, from /proc (10 ms ticks);
    the import of this module where /proc says nothing."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return IMPORTED_AT


def forbidden_modules():
    """The forbidden top-level names among the loaded modules."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def environment(chips):
    """The run's environment, set before torch loads: the first ``chips``
    cards visible, every kernel cache at a fixed path in the checkout, the
    program on its defaults, JAX kept out of libraries that would load it."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, range(chips)))
    else:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
            visible.split(",")[:chips])
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    for var in ("POPPUNK_TPU_TORCH_DEVICE", "POPPUNK_TPU_KERNEL"):
        os.environ.pop(var, None)
    os.environ["USE_FLAX"] = "0"


def load_reader(name):
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(workload, overrides=None):
    """(BENCHMARK.json, the cell's entry, the cell (its file under the
    entry), its configuration, its traffic), each updated by
    ``overrides[key]`` for the keys "config", "cell" and "traffic" (tests
    only). A cell that BENCHMARK.json does not list raises KeyError."""
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(workload)
    cell = {**load_json(BENCH_DIR, "workloads", workload + ".json"), **entry}
    config = load_json(BENCH_DIR, "configs", entry["config"] + ".json")
    traffic = load_json(BENCH_DIR, "traffic", entry["traffic"] + ".json")
    for target, key in ((config, "config"), (cell, "cell"),
                        (traffic, "traffic")):
        target.update((overrides or {}).get(key, {}))
    return bench, entry, cell, config, traffic


def make_driver(run):
    """The driver of the run's traffic kind, set up."""
    return importlib.import_module(
        f"benchmark.drivers.{run.traffic['kind']}").Driver(run)


def finite(x):
    """A number JSON carries: non-finite values as +-1e300."""
    x = float(x)
    return x if math.isfinite(x) else math.copysign(1e300, x)


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


class Run:
    """What a driver and a metric reader see of the run."""

    def __init__(self, torch, args, cell, config, traffic, device, tmp):
        self.torch = torch
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.seed = int(args.seed) % 2 ** 63
        self.seconds = float(args.seconds)
        self.device = device
        self.tmp = tmp
        self.limits = cell.get("check", {})
        self.notes = []
        self.trace = None
        self.work = {}
        self.sms = (torch.cuda.get_device_properties(device)
                    .multi_processor_count if device.type == "cuda" else 0)
        from .trace import Spans

        self.spans = Spans()

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def mark_program_start(self):
        """From here on the device's peak memory is the program's: the
        harness's own inputs are made and moved off the card."""
        if self.device.type == "cuda":
            self.sync()
            self.torch.cuda.empty_cache()
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def note(self, message):
        self.notes.append(message)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, overrides=None):
    """Run one cell; returns the exit code. ``device`` (tests only) skips
    the look for cards and runs on it; ``overrides`` (tests only) updates
    the configuration's and the cell's entries."""
    started = process_start() if device is None else time.time()
    args = parse(argv)
    try:
        bench, entry, cell, config, traffic = load_cell(args.workload,
                                                        overrides)
    except KeyError:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2

    if device is None:
        environment(int(entry["chips"]))
    import torch

    marks = [("import", time.time())]
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < int(entry["chips"])):
            print(f"benchmark: the cell needs {entry['chips']} CUDA "
                  f"card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)

    from . import trace as tracing

    tmp = tempfile.mkdtemp(prefix="benchmark-run-")
    try:
        run = Run(torch, args, cell, config, traffic, device, tmp)
        driver = make_driver(run)
        marks.append(("inputs", time.time()))
        driver.warm()
        marks.append(("warm", time.time()))
        run.sync()
        # the set-up's garbage is not the window's to collect
        gc.collect()
        build = sys.modules.get("poppunk_tpu_torch._build")
        compile_s = getattr(build, "build_seconds", None)
        setup_s = time.time() - started

        def window():
            return driver.window(run.seconds, run.spans)

        if args.trace:
            if device.type != "cuda":
                raise RuntimeError("--trace 1 reads the card's trace")
            result, run.trace = tracing.profile(torch, device, window,
                                                run.spans, tmp)
            run.note(f"trace: marker {run.trace.marker!r}, "
                     f"{len(run.trace.events)} device events")
        else:
            result = window()
        run.sync()
        run.work = getattr(driver, "work", {})
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        driver.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        compared = driver.check()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    limits = run.limits
    checks = {name: {"value": finite(value),
                     "limit": finite(limits.get(name, 0.0))}
              for name, value in compared}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if applies(m, args.workload):
                value = load_reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
    else:
        values = {**result["values"], "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if applies(m, args.workload) and values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    record = {"correct": correct, "attempted": int(result["attempted"]),
              "failed": int(result["failed"]), "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": int(entry["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if run.trace is not None:
        record["device"]["busy_s"] = run.trace.busy_s()
        record["device"]["window_s"] = run.trace.window_s
        record["breakdown"] = run.trace.breakdown()
    record["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules were imported: {found}",
              file=sys.stderr)
        return 3
    # seconds of each stage of set-up: to torch's import, the inputs and
    # the program's state, the warm-up
    stages = {f"{name}_s": t - t0 for (name, t), t0
              in zip(marks, [started] + [t for _, t in marks])}
    info = {"setup_s": setup_s, "setup_stages": stages,
            "compile_s": compile_s,
            "card": card_line() if device.type == "cuda" else "cpu",
            **result["notes"]}
    for line in run.notes:
        print(line, file=sys.stderr)
    print("run: " + json.dumps(info), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # a run that breaks prints no result
        traceback.print_exc()
        code = 1
    sys.exit(code)
