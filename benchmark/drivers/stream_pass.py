"""Closed loop, one caller: back-to-back whole passes 1 of the streaming
scale tier, as ``poppunk_tpu_torch_scale`` runs it on one card.

Set-up (untimed) makes the calls ``cli/scale.py::main`` makes before its
pass: ``_chunk_geometry`` for the chunk and the padded count, the
plane-major host planes padded as ``pack_planes(plane_major=True,
pad_to=n_pad)`` lays them out, a deferred ``StreamingCondensed``, the
model subsample drawn directly (``subsample_pairs``), the BGMM start fit
and ``plan_sweep_band``; a plan of None, or one that raises, fails the
run. Then one warm pass.

The window's unit of work is one whole pass from the host planes: a fresh
deferred ``StreamingCondensed`` (the planes' upload), ``run_pass1`` with
the planned refine-band fill, and ``pop_prefill``; the next pass starts
when the last returned. ``createdb_pairs_per_s`` counts the n(n-1)/2 real
pairs each pass needs.

Checked after the window, against the plain reference
(``benchmark/stream_reference.py``): of sampled genomes (8 of every folded
chunk, 4 of its low rows and 4 of its mirror rows where those are real,
genome 0 and genome n_real - 1, the last real genome before the pads),
the kNN of the last pass, the column maxima, and their pairs in the last
pass's band; every pass's kNN, maxima, band count and offset histogram
against the last's, bit for bit; every pass handed over its band.

Glibc's mmap threshold is held at its default, as ``passes.py`` holds it.
"""

import time
import types

import numpy as np
import torch

from .. import stream_reference
from .passes import hold_mmap_threshold, make_inputs

ROWS_PER_SIDE = 4  # sampled genomes of each folded chunk's low / mirror rows
# the distances' tolerance inside the counts that must be 0 (knn_wrong,
# band_wrong): the createdb cell's dist_gap limit, 23x the program's
# widest departure from the float64 reference there
DIST_TOL = 1e-4


def sample_rows(n_real, n_pad, chunk, rng):
    """Genomes of every folded chunk: ROWS_PER_SIDE of its low rows and of
    its mirror rows, real ones only; genome 0 and genome n_real - 1."""
    rows = {0, n_real - 1}
    for s in range(0, n_pad // 2, chunk):
        for lo, hi in ((s, s + chunk), (n_pad - s - chunk, n_pad - s)):
            real = np.arange(lo, min(hi, n_real))
            if len(real):
                rows.update(rng.choice(real, min(ROWS_PER_SIDE, len(real)),
                                       replace=False).tolist())
    return np.array(sorted(rows))


def band_partners(edges, rows):
    """{row: int64 array of its partners, one entry per edge} of the
    sampled ``rows`` among the band's edges (i < j int32 on the device)."""
    r = torch.as_tensor(rows, device=edges.i.device)
    i, j = edges.i.long(), edges.j.long()
    ends = [(a[keep].cpu().numpy(), b[keep].cpu().numpy())
            for a, b in ((i, j), (j, i)) for keep in [torch.isin(a, r)]]
    a = np.concatenate([e[0] for e in ends])
    b = np.concatenate([e[1] for e in ends])
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    lo = np.searchsorted(a, rows, side="left")
    hi = np.searchsorted(a, rows, side="right")
    return {int(x): b[p:q] for x, p, q in zip(rows, lo, hi)}


def _same(a, b):
    """Entries that differ, bit for bit, between two arrays (every entry
    when the shapes differ)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.size, b.size, 1)
    if a.dtype.kind == "f":
        a, b = a.view(f"i{a.itemsize}"), b.view(f"i{b.itemsize}")
    return int((a != b).sum())


class Driver:
    def __init__(self, run):
        from poppunk_tpu_torch.cli.scale import _chunk_geometry

        hold_mmap_threshold()
        self.run = run
        cfg = run.config
        self.n = int(cfg["n_genomes"])
        self.klist = [int(k) for k in cfg["kmers"]]
        self.cli = cfg["cli_defaults"]
        args = types.SimpleNamespace(chunk=int(run.traffic["chunk"]),
                                     single_device=False)
        self.chunk, self.n_pad, mesh = _chunk_geometry(
            self.n, args, self.klist, run.device)
        if mesh is not None:
            raise RuntimeError("the cell runs on one card")
        planes, lengths, freqs = make_inputs(run)  # genome-major, host
        K, P, wp = planes.shape[1:]
        # plane-major, padded to n_pad with zero genomes and pack_planes'
        # pad metadata
        self.planes = np.zeros((K, P, self.n_pad, wp), np.uint32)
        torch.from_numpy(self.planes.view(np.int32))[:, :, :self.n].copy_(
            torch.from_numpy(planes.view(np.int32)).permute(1, 2, 0, 3))
        del planes
        self.lengths = np.full(self.n_pad, 2_000_000, np.int32)
        self.lengths[:self.n] = lengths
        self.freqs = np.full((self.n_pad, 4), 0.25, np.float32)
        self.freqs[:self.n] = freqs
        rng = np.random.default_rng([run.seed, 2])
        self.rows = sample_rows(self.n, self.n_pad, self.chunk, rng)
        from poppunk_tpu_torch import scale

        self.scale = scale
        run.mark_program_start()

    def stream(self):
        cfg = self.run.config
        return self.scale.StreamingCondensed(
            self.planes, self.lengths, self.freqs, self.klist,
            cfg["sketchsize64"], cfg["bbits"], chunk=self.chunk,
            knn=int(self.cli["knn"]), dist_col=0, n_real=self.n, defer=True,
            device=self.run.device, mesh=None, shard_planes="auto")

    def warm(self):
        """The CLI's bootstrap up to its pass: the subsample, the BGMM
        start fit and the band's plan; then one warm pass."""
        from poppunk_tpu_torch.models.bgmm import BGMMFit

        cli, dev = self.cli, self.run.device
        cd = self.stream()
        size = min(int(cli["model_subsample"]), cd.n_pairs)
        sub = cd.subsample_pairs(size, seed=int(cli["seed"]))
        start = BGMMFit("", max_samples=size, seed=int(cli["seed"]),
                        device=dev)
        start.fit(sub, max_components=int(cli["K"]))
        self.fill_spec = self.scale.plan_sweep_band(
            cd, start.scale, start.means[start.within_label],
            start.means[start.between_label],
            max_move=float(cli["pos_shift"]), min_move=float(cli["neg_shift"]),
            max_sweep_fetch=int(cli["max_sweep_fetch"]), est_pairs=sub)
        if self.fill_spec is None:
            raise RuntimeError("plan_sweep_band planned no band fill")
        del cd
        self.one_pass()

    def one_pass(self):
        """One whole pass; returns (its record, the band's edges or
        None)."""
        cd = self.stream()
        cd.run_pass1(self.fill_spec)
        prefill = cd.pop_prefill()
        record = (cd.knn_col, cd.knn_dist, cd.max_scale())
        del cd
        if prefill is None:
            return record + (None, None), None
        edges, cum, _ = prefill
        return record + (edges.count, cum), edges

    def window(self, seconds, span):
        self.passes, self.edges, self.error = [], None, None
        pass_s = []
        t_start = t_end = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            self.edges = None  # the last pass's band, freed
            try:
                with span("createdb.pass"):
                    record, self.edges = self.one_pass()
            except Exception as exc:  # a pass that raises fails the run
                self.error = f"{type(exc).__name__}: {exc}"
                break
            t_end = time.perf_counter()
            pass_s.append(t_end - t0)
            self.passes.append(record)
            if t_end - t_start >= seconds:
                break
        passes = len(pass_s)
        needed = self.n * (self.n - 1) // 2
        elapsed = t_end - t_start
        self.work = {"passes": passes, "pairs_needed": passes * needed,
                     "pairs_computed": passes * self.n_pad ** 2}
        return {"attempted": passes + (self.error is not None),
                "failed": int(self.error is not None),
                "values": {"createdb_pairs_per_s":
                           passes * needed / elapsed if passes else None},
                "notes": {"passes": passes, "window_s": elapsed,
                          "n_pad": self.n_pad, "chunk": self.chunk,
                          "n_act": int(self.fill_spec["n_act"]),
                          "e_total": int(self.fill_spec["e_total"]),
                          "band_pairs": (None if not self.passes
                                         else self.passes[-1][3]),
                          "pass_s_min": min(pass_s, default=None),
                          "pass_s_median": (float(np.median(pass_s))
                                            if pass_s else None),
                          "pass_s_max": max(pass_s, default=None),
                          "error": self.error}}

    def release(self):
        """Drop the program's state before the reference runs: the band's
        sampled rows are taken from the device first."""
        self.partners = (None if self.edges is None
                         else band_partners(self.edges, self.rows))
        self.edges = None

    def produced(self):
        """What the window produced, for the comparison: the last pass's
        kNN of the sampled rows, its maxima and their band partners, and
        every pass against the last."""
        if not self.passes:
            return None
        last = self.passes[-1]
        drift = sum(_same(a, b) for p in self.passes
                    for a, b in zip(p, last)
                    if a is not None and b is not None)
        return {"knn": (last[0][self.rows], last[1][self.rows]),
                "maxima": np.asarray(last[2], np.float64),
                "partners": self.partners,
                "overflow": float(any(p[3] is None for p in self.passes)),
                "drift": float(drift)}

    def reference(self, precision="float64"):
        """The reference's distances of the sampled rows against every
        real genome, float64 numpy [rows, n_real, 2]."""
        dev = self.run.device
        planes = torch.from_numpy(self.planes.view(np.int32)).to(dev)
        planes = planes[:, :, :self.n].permute(2, 0, 1, 3).contiguous()
        d = stream_reference.rows_distances(
            planes, self.lengths, self.freqs, self.rows, self.n,
            self.run.config, precision)
        del planes
        return d

    def compare(self, produced, ref):
        """The numbers compared: (name, value) pairs."""
        inf = float("inf")
        if produced is None:
            return [(name, inf) for name in
                    ("knn_gap", "knn_wrong", "band_wrong", "fill_overflow",
                     "maxima_short", "pass_drift")]
        rows, n, k = self.rows, self.n, int(self.cli["knn"])
        ids, dist = produced["knn"]
        _, want = stream_reference.nearest(ref, rows, k)
        gap = float(np.abs(np.sort(np.asarray(dist, np.float64), axis=1)
                           - want).max(initial=0.0))
        if not np.isfinite(gap):
            gap = inf
        wrong = 0
        for r, row in enumerate(rows):
            got = np.asarray(ids[r], np.int64)
            real = (got >= 0) & (got < n) & (got != row)
            wrong += int((~real).sum()) + len(got) - len(np.unique(got))
            at = ref[r, got[real], 0]
            off = (np.abs(at - np.asarray(dist[r], np.float64)[real])
                   > DIST_TOL) | (at > want[r, -1] + DIST_TOL)
            wrong += int(off.sum())
        partners = produced["partners"]
        if partners is None:
            band_wrong = inf
        else:
            inside, near = stream_reference.band(ref, rows, self.fill_spec,
                                                 DIST_TOL)
            band_wrong = 0
            for r, row in enumerate(rows):
                got = partners[int(row)]
                real = (got >= 0) & (got < n) & (got != row)
                band_wrong += int((~real).sum())
                got = got[real]
                held = np.zeros(n, bool)
                held[got] = True
                band_wrong += len(got) - int(held.sum())  # duplicates
                band_wrong += int(((held != inside[r]) & ~near[r]).sum())
        short = float(np.max(stream_reference.maxima(ref, rows)
                             - produced["maxima"]))
        return [("knn_gap", gap), ("knn_wrong", float(wrong)),
                ("band_wrong", float(band_wrong)),
                ("fill_overflow", produced["overflow"]),
                ("maxima_short", max(0.0, short) if np.isfinite(short)
                 else inf),
                ("pass_drift", produced["drift"])]

    def in_place(self, ref):
        """What the reference ``ref`` (in a lower precision) would have
        produced in the program's place."""
        rows = self.rows
        ids, dist = stream_reference.nearest(ref, rows,
                                             int(self.cli["knn"]))
        inside, _ = stream_reference.band(ref, rows, self.fill_spec,
                                          DIST_TOL)
        return {"knn": (ids, dist),
                "maxima": stream_reference.maxima(ref, rows),
                "partners": {int(x): np.flatnonzero(inside[r])
                             for r, x in enumerate(rows)},
                "overflow": 0.0, "drift": 0.0}

    def check(self):
        return self.compare(self.produced(), self.reference())
