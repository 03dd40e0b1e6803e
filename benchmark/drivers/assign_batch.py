"""Closed loop, one caller: GPSC typing of batches of new genomes by a
resident ``serve.AssignSession`` over a reference database on disk.

Set-up. The configuration's population of ``n_genomes`` references and
``n_query_pool`` queries is drawn on the card (``benchmark/population.py``,
strains drawn as ``passes.make_inputs`` draws them); a seeded
``n_query_pool`` of the genomes are the query pool, the rest the
references, named ``ref00000``... in the generator's order (the database's
sorted order). The reference database is written into the run's temporary
directory by the program's own writers, as ``--create-db --fit-model``
leaves one: the sketches by ``io/hdf5db.write_sketches``; the BGMM fit of
the configuration's ``fit`` on the references' pair subsample, drawn by
``StreamingCondensed.subsample_pairs`` as ``drivers/stream_pass.py``
draws it, saved by ``BGMMFit.save()``; and ``<db>_clusters.csv`` naming
each reference's cluster, its strain's number from 1. Then the session is
opened on that directory through its own constructor, and ``warmup()``
runs every bucket. Where h5py is not installed (the card's host), the
database goes through ``benchmark/h5py_standin.py``: the same calls of the
program, a pickled tree on disk instead of HDF5.

The window's unit of work is one whole ``assign_sketches(request,
with_nearest=True)``: a request of a log-uniform number of queries over
the traffic's ``queries`` range, drawn without replacement from the pool
and handed over as ``Sketch`` objects; the next request starts when the
last returned. ``createdb_pairs_per_s`` counts queries x references of
the window's whole requests.

Glibc's malloc keeps its own mmap threshold, which rises as a long-running
service's process frees large buffers (the create-db and stream-pass
drivers hold it at its default for a one-shot CLI's process).

Checked after the window, against the plain reference
(``benchmark/assign_reference.py``), on every query of the last request
and SAMPLED answers drawn across the window's requests: each answer and
its nearest reference. The reference classifies from the saved fit, so
the same answers are also held to what the generator knows, apart from
any fit: a query of a strain among the references gets that strain's
cluster, one of a strain wholly in the pool "NA". Every request's
answers are checked for presence and for drift between requests.
"""

import csv
import inspect
import os
import time
import types

import numpy as np
import torch

from .. import assign_reference, h5py_standin, population

SAMPLED = 1024  # answers drawn across the window's requests for the check


def sketches_from_planes(planes, lengths, freqs, names, klist,
                         sketchsize64):
    """The program's ``Sketch`` objects of host planes uint32 [n, K, P,
    Wp]: each plane row's (low, high) int32 word pairs are the uint64 bin
    words, stored word-major (word w of plane p at w * P + p) as the
    sketch database holds them."""
    from poppunk_tpu_torch.sketch.minhash import Sketch

    n, K, P, _ = planes.shape
    words = np.ascontiguousarray(planes[..., :2 * sketchsize64]).view(
        np.uint64)
    usigs = np.ascontiguousarray(words.transpose(0, 1, 3, 2)).reshape(
        n, K, sketchsize64 * P)
    return [Sketch(name=name, usigs={int(k): usigs[i, j]
                                     for j, k in enumerate(klist)},
                   sketchsize64=sketchsize64, bbits=P,
                   length=int(lengths[i]), missing_bases=0,
                   base_freq=np.asarray(freqs[i], np.float64))
            for i, name in enumerate(names)]


def write_clusters(path, names, clusters):
    """``Taxon,Cluster`` rows, as the program's ``print_clusters`` writes
    a ``_clusters.csv``."""
    with open(path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(("Taxon", "Cluster"))
        out.writerows(zip(names, clusters))


class Driver:
    def __init__(self, run):
        self.h5py = h5py_standin.install()
        from poppunk_tpu_torch import serve

        if "with_nearest" not in inspect.signature(
                serve.AssignSession.assign_sketches).parameters:
            raise RuntimeError("AssignSession.assign_sketches takes no "
                               "with_nearest: the program cannot run this "
                               "cell")
        t0 = time.perf_counter()
        self.run = run
        cfg = run.config
        self.klist = [int(k) for k in cfg["kmers"]]
        self.ss64 = int(cfg["sketchsize64"])
        self.n = int(cfg["n_genomes"])
        self.requests, self._produced = [], None
        n_pool = int(cfg["n_query_pool"])
        pop = cfg["population"]
        rng = np.random.default_rng([run.seed, 1])
        sizes = population.strain_sizes(rng, self.n + n_pool,
                                        int(pop["strains"]),
                                        float(pop["strain_skew_alpha"]))
        strain = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
        planes, lengths, freqs = population.draw(
            strain, len(sizes), pop, self.klist, self.ss64, cfg["bbits"],
            run.seed, run.device)
        planes = planes.cpu().numpy().view(np.uint32)
        pool = np.sort(np.random.default_rng([run.seed, 2]).choice(
            self.n + n_pool, n_pool, replace=False))
        refs = np.setdiff1d(np.arange(self.n + n_pool), pool)
        # the harness keeps the population for the reference
        self.planes, self.lengths, self.freqs = planes, lengths, freqs
        self.refs, self.pool = refs, pool
        self.ref_names = [f"ref{i:05d}" for i in range(self.n)]
        self.clusters = [str(s + 1) for s in strain[refs]]
        # each pool query's answer by its strain alone: the strain's
        # cluster where the references hold that strain, else "NA"
        self.by_strain = [str(s + 1) if known else "NA" for s, known in
                          zip(strain[pool], np.isin(strain[pool],
                                                    strain[refs]))]
        self.queries = sketches_from_planes(
            planes[pool], lengths[pool], freqs[pool],
            [f"query{j:04d}" for j in range(n_pool)], self.klist, self.ss64)

        t1 = time.perf_counter()
        self.db = os.path.join(run.tmp, "gps")
        base = os.path.join(self.db, "gps")
        self.write_database(base)
        t2 = time.perf_counter()
        run.mark_program_start()
        session = cfg["session"]
        self.session = serve.AssignSession(
            self.db, stable=session["stable"], chunk=int(session["chunk"]),
            device=run.device)
        if self.session.r_names != self.ref_names:
            raise RuntimeError("the session serves other references than "
                               "the database's")
        self.fit = assign_reference.Fit(base + "_fit.npz")
        # seconds of the set-up's steps: the population and the pool's
        # sketches, the database written, the session opened
        self.setup = {"population_s": t1 - t0, "database_s": t2 - t1,
                      "session_s": time.perf_counter() - t2}

    def write_database(self, base):
        """The reference database at ``self.db``: sketches, the BGMM fit
        and the clusters."""
        from poppunk_tpu_torch.io.hdf5db import write_sketches

        refs = self.refs
        write_sketches(self.db, sketches_from_planes(
            self.planes[refs], self.lengths[refs], self.freqs[refs],
            self.ref_names, self.klist, self.ss64))
        self.fit_model()
        write_clusters(base + "_clusters.csv", self.ref_names, self.clusters)

    def fit_model(self):
        """The BGMM fit of the configuration's ``fit`` on the references'
        pair subsample, saved into the database directory."""
        from poppunk_tpu_torch.cli.scale import _chunk_geometry
        from poppunk_tpu_torch.models.bgmm import BGMMFit
        from poppunk_tpu_torch.scale import StreamingCondensed

        cfg, dev = self.run.config, self.run.device
        fit = cfg["fit"]
        args = types.SimpleNamespace(chunk=int(fit["chunk"]),
                                     single_device=False)
        chunk, n_pad, mesh = _chunk_geometry(self.n, args, self.klist, dev)
        if mesh is not None:
            raise RuntimeError("the cell runs on one card")
        refs = self.planes[self.refs]
        K, P, wp = refs.shape[1:]
        # plane-major, padded to n_pad with zero genomes and pack_planes'
        # pad metadata, as drivers/stream_pass.py lays them out
        planes = np.zeros((K, P, n_pad, wp), np.uint32)
        torch.from_numpy(planes.view(np.int32))[:, :, :self.n].copy_(
            torch.from_numpy(refs.view(np.int32)).permute(1, 2, 0, 3))
        del refs
        lengths = np.full(n_pad, 2_000_000, np.int32)
        lengths[:self.n] = self.lengths[self.refs]
        freqs = np.full((n_pad, 4), 0.25, np.float32)
        freqs[:self.n] = self.freqs[self.refs]
        cd = StreamingCondensed(
            planes, lengths, freqs, self.klist, self.ss64, cfg["bbits"],
            chunk=chunk, knn=1, dist_col=0, n_real=self.n,
            defer=True, device=dev, mesh=None, shard_planes="auto")
        size = min(int(fit["model_subsample"]), cd.n_pairs)
        sub = cd.subsample_pairs(size, seed=int(fit["seed"]))
        del cd, planes
        model = BGMMFit(self.db, max_samples=size, seed=int(fit["seed"]),
                        device=dev)
        model.fit(sub, max_components=int(fit["K"]))
        model.save()

    def warm(self):
        """Every bucket once: the kernels built, the allocator primed."""
        self.session.warmup()

    def window(self, seconds, span):
        self.requests, self.error, self._produced = [], None, None
        lo, hi = np.log(self.run.traffic["queries"])
        rng = np.random.default_rng([self.run.seed, 3])
        request_s = []
        t_start = t_end = time.perf_counter()
        while True:
            size = int(round(np.exp(rng.uniform(lo, hi))))  # log-uniform
            ids = rng.choice(len(self.queries), size, replace=False)
            request = [self.queries[i] for i in ids]
            t0 = time.perf_counter()
            try:
                with span("assign.request"):
                    got = self.session.assign_sketches(request,
                                                       with_nearest=True)
            except Exception as exc:  # a request that raises fails the run
                self.error = f"{type(exc).__name__}: {exc}"
                break
            t_end = time.perf_counter()
            request_s.append(t_end - t0)
            self.requests.append((ids, got))
            if t_end - t_start >= seconds:
                break
        done = len(request_s)
        queries = sum(len(ids) for ids, _ in self.requests)
        elapsed = t_end - t_start
        self.work = {"requests": done, "queries": queries,
                     "pairs": queries * self.n,
                     "genomes_read": queries + done * self.n}
        return {"attempted": done + (self.error is not None),
                "failed": int(self.error is not None),
                "values": {"createdb_pairs_per_s":
                           queries * self.n / elapsed if done else None},
                "notes": {"requests": done, "queries": queries,
                          "window_s": elapsed, "h5py": self.h5py,
                          **self.setup,
                          "request_s_min": min(request_s, default=None),
                          "request_s_median": (float(np.median(request_s))
                                               if request_s else None),
                          "request_s_max": max(request_s, default=None),
                          "error": self.error}}

    def release(self):
        """Drop the session before the reference runs."""
        self.session = None

    def produced(self):
        """What the window produced, for the comparison (drawn once): the
        checked answers (pool index, cluster, nearest reference's index),
        the answers missing and the queries whose answers drifted."""
        if not self.requests:
            return None
        if self._produced is None:
            self._produced = self._gather()
        return self._produced

    def _gather(self):
        index = {name: i for i, name in enumerate(self.ref_names)}
        valid = set(self.clusters) | {"NA"}
        missing, seen, drift, answered = 0, {}, set(), []
        for ids, got in self.requests:
            entries = []
            for q in ids:
                answer = got.get(self.queries[q].name)
                if not (isinstance(answer, tuple) and len(answer) == 2
                        and answer[0] in valid and answer[1] in index):
                    missing += 1
                    continue
                entry = (int(q), answer[0], index[answer[1]])
                if seen.setdefault(entry[0], entry) != entry:
                    drift.add(entry[0])
                entries.append(entry)
            answered.append(entries)
        flat = [e for entries in answered for e in entries]
        drawn = np.random.default_rng([self.run.seed, 4]).choice(
            len(flat), min(SAMPLED, len(flat)), replace=False)
        return {"checked": answered[-1] + [flat[i] for i in np.sort(drawn)],
                "missing": float(missing), "drift": float(len(drift))}

    def reference(self, precision="float64"):
        """The reference's (core, accessory) of the checked queries (every
        query of the last request, those of the SAMPLED answers) against
        every reference: (pool indices [nq], float64 numpy [nq, n, 2])."""
        dev = self.run.device
        produced = self.produced()
        qs = np.unique([e[0] for e in produced["checked"]] if produced
                       else []).astype(np.int64)
        rows = self.pool[qs]
        planes_r = torch.from_numpy(self.planes[self.refs].view(np.int32))
        planes_q = torch.from_numpy(self.planes[rows].view(np.int32))
        d = assign_reference.reference_distances(
            planes_q.to(dev), planes_r.to(dev), self.lengths[rows],
            self.lengths[self.refs], self.freqs[rows], self.freqs[self.refs],
            self.run.config, precision)
        return qs, d

    def compare(self, produced, ref):
        """The numbers compared: (name, value) pairs."""
        if produced is None:
            return [(name, float("inf")) for name in
                    ("answers_missing", "nn_gap", "label_wrong",
                     "strain_wrong", "answer_drift")]
        qs, dists = ref
        row = {int(q): i for i, q in enumerate(qs)}
        want, _ = assign_reference.answers(dists, self.fit, self.clusters)
        unsure = assign_reference.ambiguous(dists, self.fit, self.clusters)
        least = dists[..., 0].min(axis=1)
        gap, wrong, strain_wrong = 0.0, 0, 0
        for q, cluster, nearest in produced["checked"]:
            r = row[q]
            gap = max(gap, float(dists[r, nearest, 0] - least[r]))
            wrong += int(cluster != want[r] and not unsure[r])
            strain_wrong += int(cluster != self.by_strain[q]
                                and not unsure[r])
        return [("answers_missing", produced["missing"]), ("nn_gap", gap),
                ("label_wrong", float(wrong)),
                ("strain_wrong", float(strain_wrong)),
                ("answer_drift", produced["drift"])]

    def in_place(self, ref):
        """What the reference ``ref`` (in a lower precision) would have
        produced in the program's place."""
        qs, dists = ref
        answer, nearest = assign_reference.answers(dists, self.fit,
                                                   self.clusters)
        row = {int(q): i for i, q in enumerate(qs)}
        produced = self.produced()
        return {"checked": [(q, answer[row[q]], int(nearest[row[q]]))
                            for q, _, _ in produced["checked"]],
                "missing": 0.0, "drift": 0.0}

    def check(self):
        return self.compare(self.produced(), self.reference())
