"""Readings of a cell's comparison: the program's and the controls'.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        [--seconds 5] [--precisions tf32,bfloat16]

For each seed, in one process: the cell's set-up, a short window of the
program at the cell's own load (``--seconds 0``: one whole pass), and the comparison of what it produced
with the float64 reference (the program's reading). Then each control:
the reference computed in a lower precision put in the program's place,
judged by the same comparison. One JSON line a seed. The limits of
``workloads/<cell>.json`` are set from these readings: above the largest
the program gives, below the smallest a control gives.

The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import tempfile
import types


def readings(run_mod, workload, seed, seconds, precisions, device=None,
             overrides=None):
    """{"seed", "program": {...}, <precision>: {...}} of one seed."""
    import torch

    _, _, cell, config, traffic = run_mod.load_cell(workload, overrides)
    device = torch.device(device or "cuda")
    args = types.SimpleNamespace(seed=seed, seconds=seconds)
    with tempfile.TemporaryDirectory(prefix="benchmark-control-") as tmp:
        run = run_mod.Run(torch, args, cell, config, traffic, device, tmp)
        driver = run_mod.make_driver(run)
        driver.warm()
        driver.window(run.seconds, run.spans)
        driver.release()
        ref = driver.reference()
        out = {"seed": seed,
               "program": dict(driver.compare(driver.produced(), ref))}
        for precision in precisions:
            out[precision] = dict(driver.compare(
                driver.in_place(driver.reference(precision)), ref))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--precisions", default="tf32,bfloat16")
    args = p.parse_args(argv)
    from . import run as run_mod

    run_mod.environment(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(run_mod, args.workload, seed, args.seconds,
                                  args.precisions.split(","))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
