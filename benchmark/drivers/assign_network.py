"""Closed loop, one caller: GPSC assignment in PopPUNK's default network
mode by a resident ``serve.AssignSession(stable=None,
use_full_network=True)`` over a reference database on disk.

Set-up. The population, the query pool and the reference database's
sketches and BGMM fit are those of the typing cell
(``drivers/assign_batch.py``: the same draws from ``--seed``, the same
program writers). The database network is then written by the program's
own ``--fit-model bgmm`` network step over the references' all-vs-all:
``condensed_self_block`` with the fit's ``bgmm`` post classifies every
pair on the card, ``construct_network_from_assignments`` makes the graph
of the within-strain pairs, ``save_network`` writes ``<db>_graph`` and
``print_clusters`` the network's own ``<db>_clusters.csv`` (components
named by size). Then the session is opened on that directory through its
own constructor, and ``warmup()`` runs every bucket.

The window's unit of work is one whole ``assign_sketches(request,
with_nearest=True)``, drawn as the typing cell draws its requests (the
traffic's ``queries`` range, log-uniform, without replacement from the
pool). ``createdb_pairs_per_s`` counts queries x references of the
window's whole requests; the query-query pairs a request may add are not
counted.

Checked after the window, against the plain reference
(``benchmark/network_reference.py``), each request taken whole, since a
query's component depends on its whole request: the last request and
CHECKED requests drawn across the window. The reference builds the
database network from its own float64 classes of every pair of references
(an unsure pair resolved as the saved network has it), and the database
the set-up wrote is held to it: its saved edges and its clusters' names
(``database_wrong``). The same answers are held to what the generator
knows, apart from any fit: a query of a strain the references hold gets
the cluster of that strain's references; the queries of a strain wholly
in the pool share one new number in a request, and two such strains never
share one. Every request's answers are checked for presence and for drift
between requests. How many checked answers were exempt, and why, goes to
the run's notes.
"""

import csv
import os
from collections import Counter

import numpy as np
import torch

from .. import assign_reference, network_reference, population
from .assign_batch import Driver as TypingDriver
from .assign_batch import sketches_from_planes

CHECKED = 3  # requests drawn across the window, besides the last
CHECKS = ("answers_missing", "nn_gap", "label_wrong", "strain_wrong",
          "answer_drift", "database_wrong")


class Driver(TypingDriver):
    def __init__(self, run):
        self.net = None
        # the generator's strains, drawn as the typing set-up draws them
        # (the population's draws take seeds of their own)
        cfg = run.config
        pop = cfg["population"]
        rng = np.random.default_rng([run.seed, 1])
        sizes = population.strain_sizes(
            rng, int(cfg["n_genomes"]) + int(cfg["n_query_pool"]),
            int(pop["strains"]), float(pop["strain_skew_alpha"]))
        self.strain = rng.permutation(np.repeat(np.arange(len(sizes)),
                                                sizes))
        # the typing cell's set-up, its database written by
        # write_database below; no .refs is written, so the session it
        # opens (stable None) serves the full network, as
        # use_full_network asks
        super().__init__(run)
        session = cfg["session"]
        if (session["stable"] is not None or not session["use_full_network"]
                or os.path.isfile(self.base + ".refs")
                or self.session.network is None):
            raise RuntimeError("the cell serves the full database network "
                               "in network mode")
        if self.clusters != [str(s + 1) for s in self.strain_refs]:
            raise RuntimeError("the strains differ from the set-up's")

    def write_database(self, base):
        """The reference database at ``self.db``: sketches, the BGMM fit,
        and the network of the fit's within-strain pairs with its
        clusters, as ``--fit-model bgmm`` writes them."""
        from poppunk_tpu_torch.io.hdf5db import write_sketches
        from poppunk_tpu_torch.models import load_cluster_fit
        from poppunk_tpu_torch.network.clusters import print_clusters
        from poppunk_tpu_torch.network.construct import \
            construct_network_from_assignments
        from poppunk_tpu_torch.network.graph import save_network
        from poppunk_tpu_torch.ops.distances import condensed_self_block
        from poppunk_tpu_torch.ops.fused_assign import model_post_spec

        self.base = base
        self.strain_refs = self.strain[self.refs]
        self.strain_pool = self.strain[self.pool]
        refs, cfg, dev = self.refs, self.run.config, self.run.device
        write_sketches(self.db, sketches_from_planes(
            self.planes[refs], self.lengths[refs], self.freqs[refs],
            self.ref_names, self.klist, self.ss64))
        self.fit_model()
        model = load_cluster_fit(base + "_fit.pkl", base + "_fit.npz",
                                 device=dev)
        _, classes = condensed_self_block(
            self.planes[refs], self.lengths[refs], self.freqs[refs],
            self.klist, self.ss64, cfg["bbits"],
            post_spec=model_post_spec(model), device=dev)
        G = construct_network_from_assignments(
            self.ref_names, self.ref_names, classes,
            within_label=model.within_label, summarise=False)
        del classes
        save_network(G, prefix=self.db, suffix="_graph")
        print_clusters(G, self.ref_names, out_prefix=base)

    # -- the comparison ------------------------------------------------

    def _database(self):
        """The reference's database network (built once): its own float64
        classes of every pair of references, an unsure pair taken as the
        saved network has it; and how far the saved database departs from
        it (``self.database_wrong``): saved edges it calls between-strain,
        within-strain pairs the saved network lacks, and references the
        saved clusters file names otherwise."""
        if self.net is None:
            dev, n = self.run.device, len(self.ref_names)
            within, unsure = network_reference.base_pairs(
                torch.from_numpy(self.planes[self.refs].view(np.int32)).to(
                    dev), self.lengths[self.refs], self.freqs[self.refs],
                self.run.config, self.fit, dev)
            with np.load(self.base + "_graph.graph.npz") as f:
                saved = np.sort(np.asarray(f["edges"], np.int64), axis=1)
            key = [e[:, 0] * n + e[:, 1] for e in (within, unsure, saved)]
            within, unsure, saved = (np.unique(k) for k in key)
            sure = np.setdiff1d(within, unsure)
            edges = np.union1d(sure, np.intersect1d(saved, unsure))
            self.net = network_reference.Network(
                n, np.stack([edges // n, edges % n], 1))
            with open(self.base + "_clusters.csv", newline="") as f:
                named = {row["Taxon"]: row["Cluster"]
                         for row in csv.DictReader(f)}
            wrong = (len(np.setdiff1d(saved, np.union1d(within, unsure)))
                     + len(np.setdiff1d(sure, saved))
                     + sum(named.get(r) != c
                           for r, c in zip(self.ref_names, self.net.names)))
            self.database_wrong = float(wrong)
            self.old_names = set(self.net.old_order)
            self.max_old = self.net.next_new - 1
            self.run.note(f"reference database: {len(within)} within-strain "
                          f"pairs of references, {len(unsure)} unsure, "
                          f"{len(saved)} saved edges, {len(self.old_names)} "
                          f"clusters; database_wrong {wrong}")
        return self.net

    def _valid(self, name):
        """Whether ``name`` is an old name, a merge of old names or a
        number above every old one."""
        if not isinstance(name, str):
            return False
        parts = name.split("_")
        if all(p in self.old_names for p in parts):
            return len(parts) == 1 or len(set(parts)) == len(parts)
        return name.isdigit() and int(name) > self.max_old

    def _gather(self):
        self._database()
        index = {name: i for i, name in enumerate(self.ref_names)}
        missing, drift, plain, nearest_of, answered = 0, set(), {}, {}, []
        for ids, got in self.requests:
            entries = []
            for q in ids:
                answer = got.get(self.queries[q].name)
                if not (isinstance(answer, tuple) and len(answer) == 2
                        and self._valid(answer[0]) and answer[1] in index):
                    missing += 1
                    entries.append(None)
                    continue
                q, name, ref = int(q), answer[0], index[answer[1]]
                # the nearest reference never moves; an old name moves
                # only through a merge, which is not an old name
                if nearest_of.setdefault(q, ref) != ref or (
                        name in self.old_names
                        and plain.setdefault(q, name) != name):
                    drift.add(q)
                entries.append((q, name, ref))
            answered.append(entries)
        last = len(answered) - 1
        drawn = np.random.default_rng([self.run.seed, 4]).choice(
            last, min(CHECKED, last), replace=False)
        return {"requests": [(self.requests[i][0], answered[i])
                             for i in sorted(drawn.tolist()) + [last]],
                "missing": float(missing), "drift": float(len(drift))}

    def reference(self, precision="float64"):
        """Per checked request (the whole request): its pool indices, the
        reference's float64 core distances [nq, n], each pair's class and
        whether it is unsure ``network_reference.pair_classes``, and the
        same of the request's query pairs [nq, nq] where a query may have
        no within-strain reference. The distances in ``precision``."""
        dev = self.run.device
        produced = self.produced()
        planes_r = torch.from_numpy(
            self.planes[self.refs].view(np.int32)).to(dev)
        out = []
        for ids, _ in (produced["requests"] if produced else []):
            rows = self.pool[np.asarray(ids)]
            planes_q = torch.from_numpy(
                self.planes[rows].view(np.int32)).to(dev)
            d = assign_reference.reference_distances(
                planes_q, planes_r, self.lengths[rows],
                self.lengths[self.refs], self.freqs[rows],
                self.freqs[self.refs], self.run.config, precision)
            within, unsure = network_reference.pair_classes(d, self.fit, dev)
            entry = {"core": d[..., 0].copy(), "within": within,
                     "unsure": unsure, "qq": None}
            del d
            if len(ids) > 1 and not (within & ~unsure).any(1).all():
                dq = assign_reference.reference_distances(
                    planes_q, planes_q, self.lengths[rows],
                    self.lengths[rows], self.freqs[rows], self.freqs[rows],
                    self.run.config, precision)
                entry["qq"] = network_reference.pair_classes(dq, self.fit,
                                                             dev)
            out.append(entry)
        return out

    def _answers(self, entry):
        """(the reference's answer of each query of a request, why each is
        exempt, "" where it is checked). An unsure pair is live where
        flipping its class could change a component: an edge, or a pair
        across two components. "qq": whether the request needs its query
        pairs is itself unsure; "touched": a live pair touches the query's
        component; "new_order": the answer is a new number and a live pair
        could change which components have no old member, or their order:
        it joins one such component, or may split one, or one holding a
        query."""
        net = self._database()
        within, unsure = entry["within"], entry["unsure"]
        nq, n = within.shape[0], net.n_ref
        qq_used = nq > 1 and not within.any(1).all()
        q, r = np.nonzero(within)
        qi = qj = np.zeros(0, np.int64)
        upper = np.triu(np.ones((nq, nq), bool), 1)
        if qq_used:
            qi, qj = np.nonzero(entry["qq"][0] & upper)
        labels, names, new = net.components(nq, (q, r), (qi, qj))
        own = labels[n:]
        answer = [names[lab] for lab in own.tolist()]
        # the unsure pairs as vertex pairs, and whether each is an edge
        uq, ur = np.nonzero(unsure)
        a, b, edge = [n + uq], [ur], [within[uq, ur]]
        if qq_used:
            ui, uj = np.nonzero(entry["qq"][1] & upper)
            a.append(n + ui)
            b.append(n + uj)
            edge.append(entry["qq"][0][ui, uj])
        la, lb = labels[np.concatenate(a)], labels[np.concatenate(b)]
        edge = np.concatenate(edge)
        live = edge | (la != lb)
        touched = set(la[live].tolist()) | set(lb[live].tolist())
        queried = set(own.tolist())
        moves_new = any(
            x in new or y in new or (x == y and x in queried)
            for x, y in zip(la[live].tolist(), lb[live].tolist()))
        decided = nq == 1 or (within & ~unsure).any(1).all() or (
            ~(within | unsure)).all(1).any()
        why = ["qq" if not decided else "touched" if lab in touched
               else "new_order" if lab in new and moves_new else ""
               for lab in own.tolist()]
        return answer, why

    def _expected(self, ids):
        """Per query of a request, what the generator says of it: a known
        strain's cluster name, None where its references hold several
        names, or ("novel", strain) for a strain wholly in the pool."""
        net = self._database()
        names = {}
        for s, name in zip(self.strain_refs, net.names):
            names.setdefault(int(s), set()).add(name)
        out = []
        for q in ids:
            held = names.get(int(self.strain_pool[q]))
            if held is None:
                out.append(("novel", int(self.strain_pool[q])))
            else:
                out.append(next(iter(held)) if len(held) == 1 else None)
        return out

    def compare(self, produced, ref):
        """The numbers compared: (name, value) pairs. The checked answers
        exempt from label_wrong and strain_wrong, by reason, go to the
        run's notes."""
        if produced is None:
            return [(name, float("inf")) for name in CHECKS]
        gap, wrong, strain_wrong = 0.0, 0, 0
        exempt, checked = Counter(), 0
        for (ids, entries), entry in zip(produced["requests"], ref):
            want, why = self._answers(entry)
            expected = self._expected(ids)
            core = entry["core"]
            novel = {}
            for i, e in enumerate(entries):
                if e is None:
                    continue
                _, name, nearest = e
                gap = max(gap, float(core[i, nearest] - core[i].min()))
                checked += 1
                if why[i]:
                    exempt[why[i]] += 1
                    continue
                wrong += int(name != want[i])
                if isinstance(expected[i], tuple):
                    novel.setdefault(expected[i][1], []).append(name)
                elif expected[i] is not None:
                    strain_wrong += int(name != expected[i])
            # a novel strain's queries share one new number, its own
            shared = Counter(Counter(names).most_common(1)[0][0]
                             for names in novel.values())
            for names in novel.values():
                top = Counter(names).most_common(1)[0][0]
                for name in names:
                    strain_wrong += int(
                        name != top or shared[top] > 1
                        or not name.isdigit() or int(name) <= self.max_old)
        self.run.note(f"checked answers: {checked}, exempt "
                      f"{sum(exempt.values())} {dict(exempt)}")
        return [("answers_missing", produced["missing"]), ("nn_gap", gap),
                ("label_wrong", float(wrong)),
                ("strain_wrong", float(strain_wrong)),
                ("answer_drift", produced["drift"]),
                ("database_wrong", self.database_wrong)]

    def in_place(self, ref):
        """What the reference ``ref`` (in a lower precision) would have
        produced in the program's place."""
        produced = self.produced()
        requests = []
        for (ids, _), entry in zip(produced["requests"], ref):
            want, _ = self._answers(entry)
            nearest = entry["core"].argmin(1)
            requests.append((ids, [(int(q), want[i], int(nearest[i]))
                                   for i, q in enumerate(ids)]))
        return {"requests": requests, "missing": 0.0, "drift": 0.0}
