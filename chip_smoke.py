#!/usr/bin/env python3
"""Drive poppunk_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  A  the card: nvidia-smi name and power limit, torch / CUDA / nvcc versions
  B  build the CUDA kernels from poppunk_tpu_torch/csrc with nvcc
  C  the match-count kernel against its plain PyTorch version on the card
     (bit-exact) at the JAX tests' tile-edge shapes, at production geometry
     and at the bench shape 2048 x 4096 x K 6, timed with CUDA events
  D  the CLIs end to end on a synthetic population (6 strains x 8 genomes
     of 0.5 Mbp, one genome per strain held out as a query):
     create-db --gpu-dist, fit-model bgmm --gpu-model, assign --gpu-dist
     --gpu-model; clusters must equal the planted strains
  E  the same library path at database size: 8192 reference planes in 64
     planted strains plus 1024 queries at production geometry, made with
     numpy from a seed; all-vs-all distances, BGMM fit and assignment,
     network + clusters + references, fused query assignment against the
     full network; clusters must equal the planted strains, and a block of
     rows is checked against the plain version on the card.
Then the kernel summary line ({"kernels": [...]}, launches counted over
phases D and E only), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a host without CUDA.
"""

import csv
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
SMALL = (16, 5, 3)            # ss64, bbits, K: the JAX kernel tests
PRODUCTION = (156, 14, 5)     # sketch size 9984, k = 13..29 step 4
BENCH = (156, 14, 6)          # bench.py:30-32
KLIST = (13, 17, 21, 25, 29)
DIST_TOL = dict(rtol=1e-5, atol=2e-5)  # tests/test_torch_distances.py


def emit(obj):
    print(json.dumps(obj), flush=True)


def elapsed(torch, t0):
    """Seconds since t0, after queued CUDA work has finished."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


# --------------------------------------------------------------------------
# A, B: the card and the build
# --------------------------------------------------------------------------

def phase_a(torch):
    from poppunk_tpu_torch import _build, _device

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    _device.set_full_precision()
    emit({"phase": "A", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "seconds": time.perf_counter() - t0})
    return smi


def phase_b():
    from poppunk_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    emit({"phase": "B", "library": os.path.relpath(path, REPO),
          "nvcc_seconds": _build.build_seconds,
          "seconds": time.perf_counter() - t0})


# --------------------------------------------------------------------------
# C: kernel against plain
# --------------------------------------------------------------------------

def random_planes(rng, n, geometry):
    from poppunk_tpu_torch.ops.distances import plane_geometry

    ss64, bbits, K = geometry
    w32, wp, _ = plane_geometry(ss64, bbits)
    planes = np.zeros((n, K, bbits, wp), dtype=np.uint32)
    planes[..., :w32] = rng.integers(0, 2**32, (n, K, bbits, w32),
                                     dtype=np.uint32)
    return planes


def event_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_c(torch, device):
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.ops.distances import plane_geometry, planes_to_tensor

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    cases = [(3, 5, SMALL), (64, 128, SMALL), (65, 129, SMALL),
             (257, 1031, PRODUCTION), (2048, 4096, BENCH)]
    results, max_err, timing = [], 0, None
    for nq, nr, geometry in cases:
        pad_bits = plane_geometry(geometry[0], geometry[1])[2]
        pq = random_planes(rng, nq, geometry)
        pr = random_planes(rng, nr, geometry)
        m = min(nq, nr)  # planted agreement: counts above the chance floor
        pr[:m, ..., :100] = pq[:m, ..., :100]
        q = planes_to_tensor(pq, device)
        r = planes_to_tensor(pr, device)
        got = mc.match_counts(q, r, pad_bits)
        want = mc.match_counts_torch(q, r, pad_bits)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        results.append({"nq": nq, "nr": nr, "ss64": geometry[0],
                        "bbits": geometry[1], "K": geometry[2],
                        "exact": bool(torch.equal(got, want)),
                        "max_abs_err": err})
        if geometry is BENCH:
            mc.match_counts(q, r, pad_bits)  # warm
            ms = event_ms(torch, lambda: mc.match_counts(q, r, pad_bits), 10)
            plain_ms = event_ms(
                torch, lambda: mc.match_counts_torch(q, r, pad_bits), 2)
            timing = {"shape": [nq, nr, geometry[2]], "ms": ms,
                      "plain_ms": plain_ms,
                      "pairs_per_s": nq * nr / (ms / 1e3),
                      "plain_pairs_per_s": nq * nr / (plain_ms / 1e3)}
        del q, r, got, want
    emit({"phase": "C", "cases": results, **timing,
          "seconds": elapsed(torch, t0)})
    if max_err:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{results}")
    return max_err, timing


# --------------------------------------------------------------------------
# D: the CLIs on a synthetic population
# --------------------------------------------------------------------------

def read_clusters(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    if rows[0] != ["Taxon", "Cluster"]:
        raise AssertionError(f"{path}: header {rows[0]}")
    return dict(rows[1:])


def check_partition(clusters, strain_of):
    """Every cluster holds one strain and every strain one cluster."""
    by_cluster, by_strain = {}, {}
    for name, cl in clusters.items():
        by_cluster.setdefault(cl, set()).add(strain_of[name])
        by_strain.setdefault(strain_of[name], set()).add(cl)
    if any(len(s) != 1 for s in by_cluster.values()) or \
            any(len(c) != 1 for c in by_strain.values()):
        raise AssertionError(f"clusters do not match the planted strains: "
                             f"{by_cluster}")


def check_queries(q_clusters, ref_clusters, strain_of):
    strain_cluster = {strain_of[n]: cl for n, cl in ref_clusters.items()}
    wrong = {q: cl for q, cl in q_clusters.items()
             if strain_cluster.get(strain_of[q]) != cl}
    if wrong:
        raise AssertionError(f"queries outside their strain's cluster: "
                             f"{wrong}")


def phase_d(torch, device, workdir, n_strains=6, per_strain=8,
            genome_length=500_000, h5py_version=None):
    from synth_genomes import SyntheticPopulation

    from poppunk_tpu_torch.cli.assign import main as assign_main
    from poppunk_tpu_torch.cli.main import main as poppunk_main
    from poppunk_tpu_torch.ops import match_counts as mc

    t0 = time.perf_counter()
    pop = SyntheticPopulation(
        n_strains=n_strains, genomes_per_strain=(per_strain,) * n_strains,
        genome_length=genome_length, core_mutation_rate=0.005,
        between_divergence=0.03, accessory_pool=60, accessory_gene_len=2000,
        seed=SEED)
    fasta = os.path.join(workdir, "genomes")
    pop.write_fastas(fasta)
    queries = [n for n in pop.names if n.endswith("_iso0")]
    refs = [n for n in pop.names if n not in queries]
    rfile = pop.subset_rfile(fasta, refs, "refs.txt")
    qfile = pop.subset_rfile(fasta, queries, "queries.txt")
    strain_of = {n: pop.strain_of[n] for n in pop.names}
    gpu = ["--gpu-dist", "--gpu-model"] if device.type == "cuda" else []
    db = os.path.join(workdir, "db")
    out = os.path.join(workdir, "assigned")
    stages, launches = {}, {}

    t = time.perf_counter()
    n0 = mc.LAUNCHES
    poppunk_main(["--create-db", "--r-files", rfile, "--output", db,
                  "--no-plot"] + gpu[:1])
    stages["create_db"] = elapsed(torch, t)
    launches["create_db"] = mc.LAUNCHES - n0

    t = time.perf_counter()
    model, _ = poppunk_main(["--fit-model", "bgmm", "--ref-db", db,
                             "--output", db, "--no-plot"] + gpu[1:])
    stages["fit_bgmm"] = elapsed(torch, t)
    if model.mixture.means.device.type != device.type:
        raise AssertionError(f"BGMM on {model.mixture.means.device}")

    t = time.perf_counter()
    n0 = mc.LAUNCHES
    assign_main(["--db", db, "--query", qfile, "--output", out] + gpu)
    stages["assign"] = elapsed(torch, t)
    launches["assign"] = mc.LAUNCHES - n0

    ref_clusters = read_clusters(os.path.join(db, "db_clusters.csv"))
    check_partition(ref_clusters, strain_of)
    if set(ref_clusters) != set(refs):
        raise AssertionError("reference clusters miss samples")
    q_clusters = read_clusters(os.path.join(out, "assigned_clusters.csv"))
    if set(q_clusters) != set(queries):
        raise AssertionError(f"assigned {sorted(q_clusters)}")
    check_queries(q_clusters, ref_clusters, strain_of)
    emit({"phase": "D", "h5py": h5py_version,
          "genomes": len(pop.names), "queries": len(queries),
          "clusters": len(set(ref_clusters.values())), "stages": stages,
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


# --------------------------------------------------------------------------
# E: database-size library path on planted planes
# --------------------------------------------------------------------------

def planted_population(n_ref, n_query, n_strains, seed, ss64=156, bbits=14,
                       klist=KLIST, within=(0.01, 0.001),
                       between=(0.15, 0.01), chunk=256):
    """Planes whose per-bin agreement follows pr(k) = (1-a)(1-c)^k, with
    (a, c) = ``within`` inside a strain and ``between`` across strains.

    Each strain root keeps an ancestor's bin with probability t(k), each
    genome its root's bin with probability s(k), else a fresh random
    bbits-bit value: s^2 = pr_within(k) and s^2 t^2 = pr_between(k).
    Lengths are ~2 Mbp and base frequencies AT-rich, so the random-match
    correction is active. Returns (planes uint32 [n, K, P, Wp], lengths,
    freqs, strain labels); the first n_ref genomes are the references."""
    from poppunk_tpu_torch.ops.distances import plane_geometry

    rng = np.random.default_rng(seed)
    k = np.asarray(klist, np.float64)
    pr_w = (1 - within[0]) * (1 - within[1]) ** k
    pr_b = (1 - between[0]) * (1 - between[1]) ** k
    s = np.sqrt(pr_w).astype(np.float32)[:, None]
    t = np.sqrt(pr_b / pr_w).astype(np.float32)[:, None]
    nbins = ss64 * 64
    w32, wp, _ = plane_geometry(ss64, bbits)
    top = 1 << bbits

    ancestor = rng.integers(0, top, (len(k), nbins), dtype=np.uint16)
    roots = np.where(rng.random((n_strains, len(k), nbins), np.float32) < t,
                     ancestor,
                     rng.integers(0, top, (n_strains, len(k), nbins),
                                  dtype=np.uint16))
    n = n_ref + n_query
    strains = np.concatenate([np.arange(n_ref) % n_strains,
                              rng.integers(0, n_strains, n_query)])
    planes = np.zeros((n, len(k), bbits, wp), dtype=np.uint32)
    for start in range(0, n, chunk):
        sl = slice(start, min(start + chunk, n))
        c = sl.stop - sl.start
        keep = rng.random((c, len(k), nbins), np.float32) < s
        vals = np.where(keep, roots[strains[sl]],
                        rng.integers(0, top, (c, len(k), nbins),
                                     dtype=np.uint16))
        for p in range(bbits):
            bits = ((vals >> p) & 1).astype(np.uint8)
            planes[sl, :, p, :w32] = np.packbits(
                bits, axis=-1, bitorder="little").view("<u4")
    lengths = rng.integers(1_800_000, 2_200_000, n).astype(np.int32)
    freqs = rng.dirichlet(np.array([30.0, 20.0, 20.0, 30.0]) * 50, n) \
        .astype(np.float32)
    return planes, lengths, freqs, strains


def phase_e(torch, device, workdir, n_ref=8192, n_query=1024, n_strains=64,
            spot_rows=64):
    from poppunk_tpu_torch.assign import add_query_to_network, fetch_network
    from poppunk_tpu_torch.cli.main import make_network_and_refs
    from poppunk_tpu_torch.models import BGMMFit
    from poppunk_tpu_torch.network.clusters import print_clusters
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.ops.distances import (condensed_self_block,
                                                 corrected_jaccards,
                                                 core_accessory,
                                                 pairwise_block,
                                                 plane_geometry,
                                                 planes_to_tensor)
    from poppunk_tpu_torch.ops.fused_assign import model_post_spec

    ss64, bbits = PRODUCTION[:2]
    t0 = time.perf_counter()
    stages = {}
    on_card = device.type == "cuda"

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        stages[name] = elapsed(torch, t)
        return out

    planes, lengths, freqs, strains = timed(
        "make_data", lambda: planted_population(n_ref, n_query, n_strains,
                                                SEED + 1))
    names = [f"g{i}" for i in range(n_ref + n_query)]
    rlist, qlist = names[:n_ref], names[n_ref:]
    strain_of = dict(zip(names, strains.tolist()))
    pr, lr, fr = planes[:n_ref], lengths[:n_ref], freqs[:n_ref]
    pq, lq, fq = planes[n_ref:], lengths[n_ref:], freqs[n_ref:]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    n0 = mc.LAUNCHES

    X = timed("distances", lambda: condensed_self_block(
        pr, lr, fr, KLIST, ss64, bbits, device=device))
    if X.shape != (n_ref * (n_ref - 1) // 2, 2) or not np.isfinite(X).all():
        raise AssertionError(f"distances {X.shape}, finite "
                             f"{np.isfinite(X).all()}")
    out = os.path.join(workdir, "planted")
    model = BGMMFit(out, max_samples=100000, max_batch_size=5000,
                    device=device)
    y = timed("bgmm_fit_assign", lambda: model.fit(X, 2))
    args = SimpleNamespace(graph_weights=False, summary_sample=None,
                           betweenness_sample=100, external_clustering=None,
                           threads=1, ref_db=out, output=out)
    timed("network_clusters_refs",
          lambda: make_network_and_refs(model, y, rlist, X, out, args))
    ref_clusters = read_clusters(os.path.join(out, "planted_clusters.csv"))
    check_partition(ref_clusters, strain_of)

    def assign():
        dists, classes = pairwise_block(
            pq, pr, lq, lr, fq, fr, KLIST, ss64, bbits,
            post_spec=model_post_spec(model), device=device)
        G, old_clusters = fetch_network(out, rlist)
        G, _ = add_query_to_network(rlist, qlist, G, classes.reshape(-1),
                                    model, out, kmers=list(KLIST))
        clusters, _ = print_clusters(G, rlist + qlist,
                                     os.path.join(out, "queries"),
                                     old_clusters, print_ref=False)
        return dists, {q: str(clusters[q]) for q in qlist}

    q_dists, q_clusters = timed("fused_query_assign", assign)
    launches = mc.LAUNCHES - n0
    check_queries(q_clusters, ref_clusters, strain_of)
    peak = torch.cuda.max_memory_allocated() if on_card else None

    # spot check: a block of query rows, the kernel's counts against the
    # plain version's on the same device, and the main path's distances
    # against an epilogue fed with the plain counts
    pad_bits = plane_geometry(ss64, bbits)[2]
    q = planes_to_tensor(pq[:spot_rows], device)
    r = planes_to_tensor(pr, device)
    got = mc.match_counts(q, r, pad_bits)
    plain = mc.match_counts_torch(q, r, pad_bits)
    if not torch.equal(got, plain):
        raise AssertionError("spot check: kernel counts differ from plain")
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    d_plain = core_accessory(corrected_jaccards(
        plain, KLIST, as_t(lq[:spot_rows]), as_t(lr), as_t(fq[:spot_rows]),
        as_t(fr), ss64, bbits), KLIST).cpu().numpy()
    np.testing.assert_allclose(q_dists[:spot_rows], d_plain, **DIST_TOL)

    emit({"phase": "E", "references": n_ref, "queries": n_query,
          "strains": n_strains, "pairs_all_vs_all": int(X.shape[0]),
          "pairs_query": int(n_query * n_ref),
          "within_pairs": int((np.asarray(y) == model.within_label).sum()),
          "stages": stages, "launches": launches,
          "peak_device_bytes": peak, "spot_check_rows": spot_rows,
          "seconds": time.perf_counter() - t0})
    return launches


# --------------------------------------------------------------------------

def main():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke.py: torch.cuda.is_available() is False; "
                         "this script measures the port on a CUDA card\n")
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_h5py_standin import install_h5py

    from poppunk_tpu_torch.ops import match_counts as mc

    h5 = install_h5py()

    device = torch.device("cuda", 0)
    smi = phase_a(torch)
    phase_b()
    max_err, timing = phase_c(torch, device)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        mc.LAUNCHES = 0  # count the main path's launches only
        d = phase_d(torch, device, workdir, h5py_version=h5)
        if min(d.values()) < 1:
            raise AssertionError(f"phase D stages skipped the kernel: {d}")
        e = phase_e(torch, device, workdir)
        if e < 1:
            raise AssertionError("phase E never launched the kernel")
    emit({"kernels": [{
        "name": "match_counts", "route": "cuda",
        "source": "poppunk_tpu_torch/csrc/match_counts.cu",
        "replaces": "poppunk_tpu/ops/pallas_jaccard.py:76",
        "launches": sum(d.values()) + e, "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
