"""Closed loop, one caller: back-to-back whole create-db passes.

The window drives ``poppunk_tpu_torch.ops.distances.condensed_self_block``
over every genome of the configuration, from host planes to the host
condensed array, as ``query_db(self_mode=True)`` hands them over; the next
pass starts when the last returned. The unit of work is one whole pass.

Checked after the window, against the plain reference: the last pass's
array has every condensed i<j pair; sampled rows of every chunk (the last
partial one among them) hold the reference's (core, accessory) in the
condensed row order; and every pass agreed with the last on a fixed probe
of entries.

Each pass takes its host memory fresh from the operating system, as the one
pass of a ``--create-db`` run does: glibc's malloc would otherwise raise its
mmap threshold after the first large free and keep later passes' chunk
buffers in its heap, whether it does depending on what else the process
holds (a running profiler is enough), which moved a pass by 15-25%.
"""

import ctypes
import time

import numpy as np
import torch

from .. import population, reference

ROWS_PER_CHUNK = 8
M_MMAP_THRESHOLD = -3  # mallopt's parameter (malloc.h)
GLIBC_MMAP_THRESHOLD = 128 * 1024  # its default, held from here on


def hold_mmap_threshold():
    """Keep glibc's mmap threshold at its default: every block of 128 KiB
    or more is mapped when allocated and unmapped when freed."""
    if not ctypes.CDLL("libc.so.6").mallopt(M_MMAP_THRESHOLD,
                                             GLIBC_MMAP_THRESHOLD):
        raise OSError("mallopt(M_MMAP_THRESHOLD) failed")


def make_inputs(run):
    """The configuration's population: (host uint32 planes [n, K, P, Wp],
    lengths int32 [n], freqs float32 [n, 4])."""
    cfg = run.config
    pop = cfg["population"]
    n = int(cfg["n_genomes"])
    rng = np.random.default_rng([run.seed, 1])
    sizes = population.strain_sizes(rng, n, int(pop["strains"]),
                                    float(pop["strain_skew_alpha"]))
    strain = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    planes, lengths, freqs = population.draw(
        strain, len(sizes), pop, cfg["kmers"], cfg["sketchsize64"],
        cfg["bbits"], run.seed, run.device)
    host = planes.cpu().numpy().view(np.uint32)
    return host, lengths, freqs


def sample_rows(n, chunk, rng):
    """Rows of every chunk of ``chunk`` rows, the first and the last row
    that holds a pair among them, sorted."""
    rows = {0, n - 2}
    for start in range(0, n - 1, chunk):
        stop = min(start + chunk, n - 1)
        rows.update(rng.choice(np.arange(start, stop),
                               min(ROWS_PER_CHUNK, stop - start),
                               replace=False).tolist())
    return np.array(sorted(rows))


def row_offset(i, n):
    """Where condensed row i (pairs (i, i+1..n-1)) starts."""
    return i * n - i * (i + 1) // 2


class Driver:
    def __init__(self, run):
        hold_mmap_threshold()
        self.run = run
        cfg = run.config
        self.n = int(cfg["n_genomes"])
        self.chunk = int(run.traffic["chunk"])
        self.planes, self.lengths, self.freqs = make_inputs(run)
        rng = np.random.default_rng([run.seed, 2])
        self.rows = sample_rows(self.n, self.chunk, rng)
        n_pairs = self.n * (self.n - 1) // 2
        self.probe = np.sort(rng.choice(n_pairs, 256, replace=False))
        from poppunk_tpu_torch.ops.distances import condensed_self_block

        self.entry = condensed_self_block
        run.mark_program_start()

    def call(self):
        cfg = self.run.config
        return self.entry(self.planes, self.lengths, self.freqs,
                          cfg["kmers"], cfg["sketchsize64"], cfg["bbits"],
                          random_correct=cfg["random_correct"],
                          use_rc=cfg["use_rc"], chunk=self.chunk,
                          device=self.run.device)

    def warm(self):
        """One whole pass: builds or loads the kernels and fills the
        allocator with every chunk's buffers."""
        self.call()

    def window(self, seconds, span):
        self.probes, self.last, self.error = [], None, None
        pass_s = []
        t_start = t_end = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            try:
                with span("createdb.pass"):
                    out = self.call()
            except Exception as exc:  # a pass that raises fails the run
                self.error = f"{type(exc).__name__}: {exc}"
                break
            t_end = time.perf_counter()
            pass_s.append(t_end - t0)
            self.last = out
            self.probes.append(out.reshape(-1, 2)[
                self.probe[self.probe < out.shape[0]]].copy())
            if t_end - t_start >= seconds:
                break
        passes = len(pass_s)
        pairs = passes * self.n * (self.n - 1) // 2
        elapsed = t_end - t_start
        self.work = {"passes": passes, "pairs": pairs}
        return {"attempted": passes + (self.error is not None),
                "failed": int(self.error is not None),
                "values": {"createdb_pairs_per_s":
                           pairs / elapsed if passes else None},
                "notes": {"passes": passes, "window_s": elapsed,
                          "pass_s_min": min(pass_s, default=None),
                          "pass_s_median": (float(np.median(pass_s))
                                            if pass_s else None),
                          "pass_s_max": max(pass_s, default=None)}}

    def release(self):
        """Drop the program's state before the reference runs."""
        self.entry = None

    def produced(self):
        """What the window produced, for the comparison: the condensed
        length, the sampled rows of the last pass, the probes' drift."""
        out, n = self.last, self.n
        rows = {}
        if out is not None and out.shape == (n * (n - 1) // 2, 2):
            for i in self.rows:
                o = row_offset(int(i), n)
                rows[int(i)] = np.asarray(out[o:o + n - 1 - i], np.float64)
        probes, drift = self.probes, None
        if probes and any(p.shape != probes[-1].shape for p in probes):
            drift = float("inf")
        elif probes:
            drift = max(reference.widest(p, probes[-1]) for p in probes)
        return {"shape": None if out is None else tuple(out.shape),
                "rows": rows, "drift": drift}

    def reference(self, precision="float64"):
        """The reference's (core, accessory) of the sampled rows against
        every later genome, {row: float64 [n - 1 - row, 2]}."""
        dev = self.run.device
        planes = torch.from_numpy(self.planes.view(np.int32)).to(dev)
        rows = self.rows
        d = reference.block_distances(
            planes[torch.as_tensor(rows, device=dev)], planes,
            self.lengths[rows], self.lengths, self.freqs[rows], self.freqs,
            self.run.config, precision)
        del planes
        return {int(i): d[j, i + 1:] for j, i in enumerate(rows)}

    def compare(self, produced, ref):
        """The numbers compared: (name, value) pairs."""
        n = self.n
        want = (n * (n - 1) // 2, 2)
        shape = produced["shape"]
        missing = (float(want[0]) if shape is None
                   else float(abs(want[0] - shape[0]) + (shape[1:] != (2,))))
        rows = produced["rows"]
        gap = (max(reference.widest(rows[i], ref[i]) for i in ref) if rows
               else float("inf"))
        drift = produced["drift"]
        return [("pairs_missing", missing), ("dist_gap", gap),
                ("pass_drift", float("inf") if drift is None else drift)]

    def in_place(self, ref):
        """What the reference ``ref`` (in a lower precision) would have
        produced in the program's place."""
        return {"shape": (self.n * (self.n - 1) // 2, 2), "rows": ref,
                "drift": 0.0}

    def check(self):
        return self.compare(self.produced(), self.reference())
