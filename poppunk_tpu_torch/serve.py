"""Resident serving session for query assignment.

Counterpart of poppunk_tpu/serve.py. The CLI path re-reads the sketch
database, re-packs the reference planes and uploads them on every
invocation: right for batch jobs, wasteful for a daemon answering many
small requests (the BeeBOP web flow assigns per upload).
``AssignSession`` pays those costs once:

- the reference planes, lengths and base frequencies are read, packed
  (under ``KERNEL_CHOICE == "packed"``, packed lanes too) and put on the
  device at construction, as are the model's post parameters (a BGMM's
  covariances factored there once, so no dispatch waits on the host for
  a factor: ``_enqueue`` returns as soon as its work is queued);
- the fitted model's classifier runs in the distance pass (ops/
  fused_assign), so the |Q| x |R| tile never leaves the device;
- a request goes in buckets of at most ``chunk`` queries, each padded to
  a power of two, as the reference's are; a bucket is packed straight
  into one of two host buffers the session reuses (page-locked on a
  card), padded there and uploaded in one copy; ``warmup()`` runs each
  bucket size once, which builds the kernels and primes the allocator
  before traffic arrives.

Two modes, as ``poppunk_tpu_torch_assign`` has them:

- ``stable="core"`` or ``"accessory"`` (reference assign.py:663-693, the
  ``*_stable`` posts): each query takes its nearest reference's cluster
  iff that pair is within-strain, else "NA"; a dispatch fetches
  (nearest, within) a query.
- ``stable=None``, the network mode (assign.py:assign_query_hdf5 without
  ``--serial``, ``--stable`` or ``--update-db``): the database network
  (its components) and its ``_clusters.csv`` are read at construction
  (``network/resident.py``); a dispatch classifies every pair by the
  model's own post and fetches each query's nearest reference and its
  within-strain pairs' references, compacted on the device (the
  ``edges`` post); if a query of the request has none, every pair of the
  request's queries is classified on the device too and its within-strain
  pairs added; the components the request touches are then named by
  ``print_clusters``' rule (``network/naming.py``): an old cluster keeps
  its name, clusters a query bridges merge into ``A_B``, a novel lineage
  takes a new number above the largest old one. Each answer is what the
  CLI writes for that request alone.

A request runs in ``profiling`` spans (they record only while recording
is on): ``serve.assign`` the whole call (queries, pairs = queries x
references, dispatches; in network mode also edges, the within-strain
query x reference pairs, novel, the queries with none, and qq_pairs, the
query pairs classified); per dispatch ``serve.dispatch`` (rows = the
padded bucket, pairs = bucket x references: the packing, the padding,
the upload and the enqueue; follows, 1 on every dispatch after a
request's first; ahead, 1 when the request's previous dispatch had not
completed on the card once this bucket was packed, always 0 on the CPU)
holding ``dists.pack_planes`` (sketches, the bucket's queries; staged,
the bytes packed into page-locked memory, 0 on the CPU) and
``serve.upload`` (bytes moved from the host, 0 on the CPU); per
dispatch's result ``serve.attach`` (queries: the host's lookup of each
answer) holding ``serve.fetch_wait`` (the wait for the result's copy)
and, in network mode, ``serve.edges`` (edges; bytes fetched from the
card, 0 on the CPU). In network mode ``serve.qq`` (pairs) holds the
query pairs' dispatches and ``serve.network`` (queries, components,
merges, new) the attach to the network and the naming.

Sessions serve refine / threshold, BGMM and DBSCAN models; DBSCAN pairs
are classified by the quantised decision grid (DBSCANFit.decision_grid),
exact for any pair more than half a grid cell from a decision boundary.
"""

import os

import numpy as np
import torch

from . import _device, profiling
from .io.hdf5db import read_db_params, read_sketches
from .ops import match_counts as mc
from .ops.distances import (_dist_chunk, _Operands, _staging, pack_planes,
                             plane_geometry)
from .utils import db_h5_path, read_isolate_type_from_csv


def _file_base(prefix):
    return os.path.join(prefix, os.path.basename(prefix))


class AssignSession:
    def __init__(self, ref_db, model_dir=None, stable="core",
                 use_full_network=False, strand_preserved=False, chunk=512,
                 device=None):
        from .models import load_cluster_fit
        from .ops.fused_assign import (edges_post_spec, post_spec_on,
                                       stable_post_spec)

        self.device = _device.resolve(device)
        self.ref_db = ref_db = ref_db.rstrip("/")
        model_prefix = (model_dir or ref_db).rstrip("/")
        base = _file_base(model_prefix)
        self.model = load_cluster_fit(base + "_fit.pkl", base + "_fit.npz",
                                      device=self.device)
        if self.model.type not in ("refine", "bgmm", "dbscan"):
            raise RuntimeError(
                "AssignSession serves refine/threshold/bgmm/dbscan models; "
                "got " + self.model.type)
        if stable not in ("core", "accessory", None):
            raise ValueError("stable must be 'core' or 'accessory' (the "
                             "nearest reference's cluster), or None (the "
                             "network mode)")
        self.stable = stable
        self.chunk = chunk
        self.use_rc = not strand_preserved
        self.kmers = tuple(int(k) for k in read_db_params(ref_db)[0])

        # the serving references: the .refs subset if present, in the order
        # of the .dists pkl (the CLI's --stable order: ties go to the first
        # minimum, so another order could name another cluster)
        from .io.hdf5db import get_seqs_in_db

        dist_pkl = _file_base(ref_db) + ".dists"
        if os.path.isfile(dist_pkl + ".pkl"):
            from .utils import read_pickle

            all_names = read_pickle(dist_pkl, distances=False)[0]
        else:
            all_names = get_seqs_in_db(db_h5_path(ref_db))
        r_names = None
        refs_file = base + ".refs"
        use_ref_graph = os.path.isfile(refs_file) and not use_full_network
        if use_ref_graph:
            with open(refs_file) as f:
                wanted = frozenset(line.rstrip() for line in f)
            r_names = [n for n in all_names if n in wanted]
        elif os.path.isfile(dist_pkl + ".pkl"):
            r_names = list(all_names)
        sketches = read_sketches(ref_db, r_names)
        self.r_names = [s.name for s in sketches]
        self.ss64 = sketches[0].sketchsize64
        self.bbits = sketches[0].bbits
        _, self.wp, self.pad_bits = plane_geometry(self.ss64, self.bbits)
        self.ref = _Operands(*pack_planes(sketches, self.kmers), self.device,
                             self.pad_bits)

        self.network = None
        if stable is None:
            # the database network and its clusters, held for every
            # request; pairs classified by the boundary the CLI picks
            # (reference assign.py:444-460)
            from .assign import fetch_network
            from .network.resident import ResidentNetwork

            G, cluster_csv = fetch_network(model_prefix, self.model,
                                           self.r_names,
                                           ref_graph=use_ref_graph)
            self.network = ResidentNetwork(G, self.r_names, cluster_csv)
            slope = (0 if self.model.type == "refine"
                     and self.model.threshold else None)
            spec = edges_post_spec(self.model, slope)
        else:
            # reference clustering for cluster names
            self.ref_clustering = read_isolate_type_from_csv(
                base + "_clusters.csv", mode="clusters",
                return_dict=True)["Cluster"]
            spec = stable_post_spec(self.model,
                                    0 if stable == "core" else 1)
        if spec is None:  # not assert: must survive python -O
            raise RuntimeError(
                f"no fused classifier for model type {self.model.type}")
        self.post_spec = post_spec_on(spec, self.device)
        # a query's bytes in _send's host buffers (its planes, frequencies
        # and length); the two buffers, made on first use, the events after
        # their last uploads, and the next one to fill
        self._query_bytes = len(self.kmers) * self.bbits * self.wp * 4 + 20
        self._buffers, self._uploaded, self._turn = None, [None, None], 0
        self._copies = None  # the side stream of the edges' fetches

    def _views(self, buffer, bucket):
        """(planes int32 [bucket, K, P, Wp], lengths int32 [bucket], freqs
        float32 [bucket, 4]) laid back to back in the uint8 tensor
        ``buffer``: the planes, then the frequencies, then the lengths,
        each from a 16-byte boundary of the buffer's start."""
        a = bucket * (self._query_bytes - 20)
        b = a + bucket * 16
        return (buffer[:a].view(torch.int32).view(
                    bucket, len(self.kmers), self.bbits, self.wp),
                buffer[b:b + 4 * bucket].view(torch.int32),
                buffer[a:b].view(torch.float32).view(bucket, 4))

    def _send(self, sketches, bucket):
        """One fused dispatch of ``sketches`` padded to ``bucket`` rows
        (``_upload``), then distances, classification and 1-NN enqueued on
        the device. Returns the post's device result without waiting for
        it (``_enqueue``)."""
        return self._enqueue(*self._upload(sketches, bucket))

    def _upload(self, sketches, bucket, behind=None, dispatch=None):
        """The device operands of ``sketches`` padded to ``bucket`` rows:
        packed straight into the next of two reused host buffers
        (page-locked on a card), the pad rows zeroed (lengths 1), the
        buffer's first ``bucket`` rows uploaded in one asynchronous copy
        (a copy of them on the CPU, so the operands outlive the buffer's
        reuse). Before a buffer is refilled the host waits for the event
        recorded after its last upload alone, never the stream. With
        recording on, ``dispatch`` (the open ``serve.dispatch`` span) counts
        ``ahead`` 1 if ``behind``, the event after the request's previous
        dispatch, has not completed once the bucket is packed: the pack ran
        while the card still had work."""
        on_card = self.device.type == "cuda"
        if self._buffers is None:
            self._buffers = _staging(self.chunk * self._query_bytes, 2,
                                     pinned=on_card)
        turn, self._turn = self._turn, 1 - self._turn
        buffer = self._buffers[turn]
        if self._uploaded[turn] is not None:
            self._uploaded[turn].synchronize()
        planes, lengths, freqs = self._views(buffer, bucket)
        n = len(sketches)
        if n:
            pack_planes(sketches, self.kmers,
                        out=(planes[:n], lengths[:n], freqs[:n]))
        planes[n:].zero_()
        lengths[n:] = 1
        freqs[n:].zero_()
        if behind is not None and profiling.recording():
            dispatch.add(ahead=int(not behind.query()))
        nbytes = bucket * self._query_bytes
        with profiling.span("serve.upload", bytes=nbytes if on_card else 0):
            if on_card:
                moved = torch.empty(nbytes, dtype=torch.uint8,
                                    device=self.device)
                moved.copy_(buffer[:nbytes], non_blocking=True)
                self._uploaded[turn] = torch.cuda.Event()
                self._uploaded[turn].record()
            else:
                moved = buffer[:nbytes].clone()
        return self._views(moved, bucket)

    def _enqueue(self, planes, lengths, freqs):
        """The fused dispatch of query operands on the device: (head,
        cols). head int32 [rows, 2] is (nn_index, within) a query in
        stable mode, (nn_index, within-strain pairs) in network mode;
        cols (network mode, else None) holds those pairs' references,
        compacted row by row (``_post_edges``)."""
        if isinstance(self.ref.planes, mc.PackedPlanes):
            planes = mc.pack(planes, self.pad_bits)
        _, extra = _dist_chunk((planes, lengths, freqs),
                               self.ref.rows(0, None), self.kmers,
                               self.ss64, self.bbits, True, self.use_rc,
                               False, self.post_spec)
        return extra if isinstance(extra, tuple) else (extra, None)

    def _fetch_async(self, extra):
        """Start copying a dispatch's result to the host; returns
        (host tensor, event to wait on, or None on the CPU). The copy goes
        to pinned memory behind an event, so fetching batch i never waits
        for batch i+1, queued after it."""
        if self.device.type != "cuda":
            return extra, None
        host = torch.empty(extra.shape, dtype=extra.dtype, pin_memory=True)
        host.copy_(extra, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _dispatch(self, planes_q, len_q, freq_q):
        """One batch of host arrays already packed and padded, through
        plain copies and synchronously: the head (``_enqueue``) as numpy,
        (nn_index, within) int32 [nq, 2] in stable mode."""
        return self._enqueue(*(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (planes_q.view(np.int32), len_q, freq_q)))[0].cpu(
            ).numpy()

    def assign_sketches(self, sketches, with_nearest=False):
        """{query name: cluster or 'NA'} for already-sketched queries;
        with ``with_nearest``, {query name: (cluster or 'NA', name of the
        nearest reference)}. In stable mode a query takes its nearest
        reference's cluster if their pair is within-strain, else "NA"; in
        network mode every query is named, a novel lineage by a new
        number.

        Double-buffered: batch i+1 is packed and its fused dispatch queued
        before batch i's result is read and attached, so the host attach
        runs under the device's compute instead of after it. The attach
        looks up each answer in stable mode and collects each query's
        within-strain pairs in network mode (``_attach_network``), whose
        query pairs and naming follow the last dispatch. One caller at a
        time: the session's host buffers are reused."""
        bad = [s.name for s in sketches
               if s.sketchsize64 != self.ss64 or s.bbits != self.bbits]
        if bad:
            # same-Wp mismatches (e.g. ss64 32 vs 64 both pad to one
            # 128-word row) would pass every shape check and return
            # confidently wrong clusters
            raise ValueError(
                f"query sketch geometry does not match the reference db "
                f"(sketchsize64={self.ss64}, bbits={self.bbits}): "
                + ", ".join(bad[:5]))
        n_refs, nq = len(self.r_names), len(sketches)
        names = [s.name for s in sketches]
        nearest = np.empty(nq, np.int64)
        with profiling.span("serve.assign", queries=nq, pairs=nq * n_refs,
                            dispatches=-(-nq // self.chunk)) as whole:
            if self.network is None:
                clusters, kept = {}, None

                def attach(head, fetched, cols, start):
                    for name, (nn, within) in zip(names[start:], head):
                        clusters[name] = (
                            self.ref_clustering[self.r_names[int(nn)]]
                            if within else "NA")
            else:
                edges, kept = [], []

                def attach(head, fetched, cols, start):
                    edges.append((
                        np.repeat(np.arange(start, start + len(head)),
                                  head[:, 1]),
                        self._fetch_edges(cols, fetched,
                                          int(head[:, 1].sum()))))

            def landed(fetched, cols, start, n):
                with profiling.span("serve.attach", queries=n):
                    head = self._wait(fetched)[:n]
                    nearest[start:start + n] = head[:, 0]
                    attach(head, fetched, cols, start)

            pending = None
            for start in range(0, nq, self.chunk):
                n = min(self.chunk, nq - start)
                bucket = 1
                while bucket < n:
                    bucket *= 2
                with profiling.span("serve.dispatch", rows=bucket,
                                    pairs=bucket * n_refs,
                                    follows=int(pending is not None),
                                    ahead=0) as sp:
                    ops = self._upload(
                        sketches[start:start + n], bucket,
                        None if pending is None else pending[0][1], sp)
                    head, cols = self._enqueue(*ops)
                    fetched = self._fetch_async(head)
                if kept is not None:  # the query pairs' operands
                    kept.append((ops, n))
                if pending is not None:
                    landed(*pending)
                pending = (fetched, cols, start, n)
            if pending is not None:
                landed(*pending)
            if kept is not None:
                clusters = self._attach_network(names, edges, kept, whole)
        if not with_nearest:
            return clusters
        return {q: (clusters[q], self.r_names[int(r)])
                for q, r in zip(names, nearest)}

    def _attach_network(self, names, edges, operands, whole):
        """{query name: cluster} of a request in network mode (reference
        assign.py:assign_query_hdf5 with ``use_full_network``, no database
        update): the queries attached to the resident network by their
        within-strain pairs (``edges``: each dispatch's query and
        reference indices), then its components named. If a query has no
        within-strain reference, every pair of the request's queries is
        classified on the device from the dispatches' ``operands``, and
        its within-strain pairs added, as ``add_query_to_network`` does."""
        nq = len(names)
        edges_q = np.concatenate([q for q, _ in edges] + [np.zeros(0, int)])
        edges_r = np.concatenate([r for _, r in edges] + [np.zeros(0, int)])
        novel = nq - len(np.unique(edges_q))
        qq = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        qq_pairs = nq * (nq - 1) // 2 if novel and nq > 1 else 0
        if qq_pairs:
            with profiling.span("serve.qq", pairs=qq_pairs):
                qq = self._query_pairs(operands)
        with profiling.span("serve.network", queries=nq) as sp:
            clusters, counts = self.network.assign(
                names, (edges_q, edges_r), qq)
            sp.add(**counts)
        whole.add(edges=len(edges_r), novel=novel, qq_pairs=qq_pairs)
        return clusters

    def _wait(self, fetched):
        """A fetched dispatch head as numpy, once its copy has landed."""
        host, done = fetched
        with profiling.span("serve.fetch_wait"):
            if done is not None:
                done.synchronize()
        return host.cpu().numpy()

    def _fetch_edges(self, cols, fetched, total):
        """The compacted references of a dispatch's ``total`` within-strain
        pairs (the first entries of ``cols``) as int64 numpy. On a card
        they are copied on a side stream after the dispatch's event, so
        the copy waits for that dispatch alone, never for the next one
        queued behind it on the compute stream."""
        on_card = self.device.type == "cuda"
        with profiling.span("serve.edges", edges=total,
                            bytes=(fetched[0].nbytes + 4 * total
                                   if on_card else 0)):
            if total == 0:
                return np.zeros(0, np.int64)
            if not on_card:
                return cols[:total].numpy().astype(np.int64)
            if self._copies is None:
                self._copies = torch.cuda.Stream(self.device)
            host = torch.empty(total, dtype=torch.int32, pin_memory=True)
            self._copies.wait_event(fetched[1])
            with torch.cuda.stream(self._copies):
                host.copy_(cols[:total], non_blocking=True)
            self._copies.synchronize()
            return host.numpy().astype(np.int64)

    def _query_pairs(self, operands):
        """(i, j) int64 arrays, i < j, of the request's within-strain query
        pairs, classified by the session's post on the device from the
        uploaded operands (``operands``: each dispatch's device operands
        and its number of queries), as the CLI's condensed pass computes
        them: a chunk of rows against the queries from its first row on,
        row i against column j."""
        planes, lengths, freqs = (
            torch.cat([ops[a][:n] for ops, n in operands]) for a in range(3))
        packed = isinstance(self.ref.planes, mc.PackedPlanes)
        if packed:
            planes = mc.pack(planes, self.pad_bits)

        def rows(a, b):
            return (planes.rows(a, b) if packed else planes[a:b],
                    lengths[a:b], freqs[a:b])

        nq = lengths.shape[0]
        first, second = [], []
        for start in range(0, nq, self.chunk):
            stop = min(start + self.chunk, nq)
            _, (head, cols) = _dist_chunk(
                rows(start, stop), rows(start, nq), self.kmers, self.ss64,
                self.bbits, True, self.use_rc, False, self.post_spec)
            fetched = self._fetch_async(head)
            counts = self._wait(fetched)[:, 1]
            i = np.repeat(np.arange(start, stop), counts)
            j = start + self._fetch_edges(cols, fetched, int(counts.sum()))
            first.append(i[j > i])
            second.append(j[j > i])
        return np.concatenate(first), np.concatenate(second)

    def assign_files(self, q_files, threads=1):
        """Sketch query inputs (an rfile path, or a (names, files) pair
        of parallel lists) then assign; no query database is written.
        Returns {name: cluster or 'NA'}."""
        from .io.hdf5db import _sketch_one
        from .sketch.minhash import SketchParams
        from .utils import read_rfile

        if isinstance(q_files, (tuple, list)) and len(q_files) == 2 \
                and not isinstance(q_files[0], str):
            names, sequences = list(q_files[0]), list(q_files[1])
        elif isinstance(q_files, str):
            names, sequences = read_rfile(q_files)
        else:
            raise TypeError(
                "q_files must be an rfile path or a (names, files) pair "
                "of parallel lists")
        params = SketchParams(klist=self.kmers, sketchsize64=self.ss64,
                              bbits=self.bbits, use_rc=self.use_rc)
        if threads > 1 and len(names) > 1:
            from multiprocessing import get_context

            # spawn, not fork: CUDA cannot be used in a child forked after
            # the session put the references on the card. native_threads=1
            # per job: P workers x min(n_k, cores) OpenMP threads would
            # oversubscribe the host (as construct_database's pool)
            jobs = [(n, f, params, 1) for n, f in zip(names, sequences)]
            with get_context("spawn").Pool(min(threads, len(jobs))) as pool:
                sketches = pool.map(_sketch_one, jobs)
        else:
            sketches = [_sketch_one((n, f, params))
                        for n, f in zip(names, sequences)]
        return self.assign_sketches(sketches)

    def warmup(self):
        """Run every bucket size once before taking traffic: the kernels
        are built, the two host buffers made and the allocator holds each
        bucket's device buffers. Returns the number of buckets (10 at chunk
        512)."""
        n = 0
        bucket = 1
        while True:
            self._send([], bucket)[0].cpu()
            n += 1
            if bucket >= self.chunk:
                return n
            bucket *= 2
