#!/usr/bin/env python3
"""Drive poppunk_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  A  the card: nvidia-smi name and power limit, torch / CUDA / nvcc versions
  B  build the CUDA kernels from poppunk_tpu_torch/csrc with nvcc; each
     epilogue instantiation's registers, stack and spills from ptxas (a
     KMAX 8 one with a stack frame or spills fails the script)
  C  both match-count kernels (standard and packed-lane) against their
     plain PyTorch versions on the card, and the packed kernel against the
     standard one (all bit-exact), at the JAX tests' tile-edge shapes, at
     production geometry, at an odd sketchsize64 and at the bench shape
     2048 x 4096 x K 6, where all four are timed with CUDA events beside
     the SM clock nvidia-smi reads, against the operation bound at that
     clock and against torch.cdist(p=0) on the unpacked bin signatures
     (the one PyTorch call that computes the same counts, held to them)
  C2 the distance epilogue kernel (csrc/dist_epilogue.cu) against its
     plain version (ops/distances.dist_epilogue_torch) on the card, on
     kernel 1's counts at C's shapes, at K 29, at k 1, 2, 3 and 31 and at
     K 8 and 9 (either side of its KMAX 8 instantiation), with degenerate
     rows, in both output modes and with the random-match
     correction with, without the reverse complement and off: Jaccards bit
     for bit, distances within DIST_TOL, and the distances against the
     float64 oracle on the kernel's own Jaccards (within DIST_TOL or the
     pair's float32 rounding bound, where that is more); one pair's value
     equal in a 1 x 1 and a 64 x 128 call; timed at BENCH beside the plain
     version and the bound from the function's operations at the shapes;
     each instantiation's registers, stack and spills (phase B: none for
     KMAX 8).
     The epilogue is held again at its routes' own operands: E's spot
     rows, an owned tile of L2, L3 and M and its transposed counts
     (hold_steps_to_plain), O's column tiles, Q's corner
  D  the CLIs end to end on a synthetic population (6 strains x 8 genomes
     of 0.5 Mbp, one genome per strain held out as a query), on the card
     by default (no --gpu-* flag): create-db, fit-model bgmm, assign;
     clusters must equal the planted strains
  E  the same library path at database size: 8192 reference planes in 64
     planted strains plus 1024 queries at production geometry, made with
     numpy from a seed; all-vs-all distances, BGMM fit and assignment,
     network + clusters + references, fused query assignment against the
     full network; clusters must equal the planted strains, and a block of
     rows is checked against the plain version on the card.
  F  with KERNEL_CHOICE packed, the refine path through the CLIs on phase
     D's population: create-db (distances equal phase D's bit for bit),
     fit-model refine --indiv-refine both from phase D's BGMM fit (global
     sweeps on the card), fit-model threshold at the core boundary refine
     found, assign with the refine model with and without --core
     --accessory; every cluster file must equal the planted strains
  G  with KERNEL_CHOICE packed, phase E's population: the packed
     all-vs-all (equal to phase E's bit for bit), refine from phase E's
     BGMM fit with the device sweep, its 40 global scores held to the host
     native sweep on the same edges (its peak device memory held to two
     float32 squares, one float64 row block and the edges' indices), the
     refine network, and fused
     boundary-post assignment of the queries (distances equal phase E's)
  H  with KERNEL_CHOICE standard again, the DBSCAN, lineage and QC CLIs
     on phase D's population and database: --qc-db removing one reference
     by name; --fit-model dbscan (clusters equal the planted strains) and
     assign with it through the fused dbscan post on the card; dbscan
     --for-refine, then refine from it (strain-pure clusters); lineage
     --ranks 1,2 and assign with it, with and without --update-db full
     (a Status column; rank-1 lineages strain-pure)
  I  phase E's population through the DBSCAN model at the CLI defaults:
     the fit on the 100,000-pair subsample with the HDBSCAN Boruvka sweep
     on the card (seconds and rounds of every MST, the cascade's steps),
     the exact assignment of all pairs, timed apart, and the decision-grid
     assignment beside it; network, clusters and references (the planted
     strains); fused dbscan-post assignment of the queries (distances
     equal phase E's); the card's Boruvka on 8192 of the subsample held to
     the same function on the CPU and to the host Prim oracle; a lineage
     fit (ranks 1-3, depth 30) extended with the queries, whose
     query-query distances run on the card (rank-1 lineages strain-pure)
  J, K  serving and the side tools (the verify skill, section 5)
  L0 (right after C) the standard kernel's plane-major route against its
     plain version and the contiguous route, bit for bit, on row-slice
     views of a resident [K, P, n, Wp] tensor; timed at BENCH
  L  the streaming scale tier: L1 poppunk_tpu_torch_scale on phase D's
     database (BGMM with lineages, DBSCAN, --indiv-refine both, bootstrap
     against POPPUNK_TPU_BOOTSTRAP=0, assign of the queries); L2 phase E's
     references through StreamingCondensed (subsample and kNN held to
     phase E's condensed distances, the bootstrap refine's clusters the
     planted strains); L3 the streaming fit at 65,536 planted genomes of
     production geometry drawn on the card (stage seconds, pass 1's
     kernel time, the sweep's timings, peak device memory held to
     streaming_hbm_accounting plus the sweep's budget; strain-pure)
  L4 the scale tier's other modes: L4a poppunk_tpu_torch_scale on phase
     D's database with --unconstrained, --multi-boundary 4, --use-model
     (L1's fit), --run-qc (D plus a junk genome, held to the host
     qc_dist_mat) and --mandrake; L4b phase E's references: the 2-D refine
     at a 1,000,000-pair cap (the planted strains), multi_refine_device up
     to L2's optimum, the streaming QC held to a scan of phase E's
     distances; L4c on L3's resident planes: the fixed-boundary fetch (its
     components L3's clusters), the QC pass, the accessory kNN and SCE of
     --mandrake, each pass's seconds and kernel time, peak device memory
     held to L3's limit
  M  the buffered scale pipeline and the helper scripts: M1
     run_scale_pipeline(n=20480) at the reference's defaults on the card
     (the folded condensed buffer, the 40-offset matmul sweep, components
     on the card; stage seconds, the fill's launches and kernel time,
     peak device memory under 16 GB net of what was live before, the
     planted strains), its device stages rebuilt one at a time at its
     boundary (each stage's memory, the same components), the kernel
     held to its plain version at the streaming pass's operands; M2 the same
     population through the streaming route (the partition and edge
     count M1's, and at M1's boundary the dense product's edge count the
     streamed exact count); M3 ``python -m poppunk_tpu_torch --version``
     and the helper scripts on phase D's database
  N  the device mesh (parallel/, scale.py's row-sharded arms): a real mesh
     over every card with two or more, else a virtual mesh of 4 shards on
     cuda:0, shape (2, 2), named on a line of its own. N1 pairwise_block
     on phase E's 1024 queries x 8192 references sharded over the mesh
     against the single device, without and with the BGMM fused post,
     under the standard kernel and then the packed one (classes bit for
     bit, distances within DIST_TOL); N2 two worker processes of this
     script (``--n2-worker``: init_distributed over gloo, pod_mesh over a
     virtual (1 x 2) local mesh on cuda:0) computing their tiles of a
     1024 x 4096 block, held bit for bit in counts to the single process;
     N3 run_scale_pipeline(n=20480, mesh=...) buffered and streaming
     against M1 and M2 (edges, boundary, partition; peak memory under
     M1's limit), then the QC pass and the fixed-boundary fetch at M1's
     boundary through _mesh_compact_pass against the single device
  O  the column-sharded scale tier (scale.py's _ColShardedStream) on N's
     mesh: O1 M's population (20,480 genomes, K 6) through
     StreamingCondensed(shard_planes=True) (kNN, maxima and subsample bit
     for bit against the single device), refine over the column shards
     (M2's edges and partition, s_opt within rtol 1e-4) and the QC and
     fetch passes through _compact_pass's column arm at M1's boundary
     (N3's pairs as sets); O1 and O2 hold kernel 1's plane-major route to
     its plain version at the last shard's cuts of two chunks' owned
     tiles, and the epilogue at a cut and its transposed counts; O2 pass 1
     at 131,072 genomes drawn on the card with shard_planes="auto"
     (column shards; seconds, launches, kernel time,
     peak device memory against streaming_hbm_accounting's column figure,
     256 genomes' kNN against a full-row recompute)
  Q  the port's bench headline (poppunk_tpu_torch/bench.py: match counts,
     corrections and k-mer fit at 2048 x 4096 x K 6 against the live g++
     CPU baseline) in this process, its record printed on a line of its
     own: the card, ceiling_frac in (0, 1.05], a 64 x 128 corner against
     the plain counts and epilogue, the baseline's counts bit for bit
  P  the batched device Brandes (ops/brandes_device.py) at bench.py's
     bench_brandes_ab shapes (100 components of 1000 vertices padded to
     1024, degree ~40, 100 sources): exact products held to the native
     engine within rtol 1e-5, TF32 products timed with their error
``python3 chip_smoke.py --mesh-only`` runs A, B, E, M1's and M2's
pipelines, N and O1 alone (for a host with several cards: their mesh
spans them). Then the kernel summary line ({"kernels": [...]}: the
standard kernel's launches counted over phases D, E, H-O and Q, the packed
kernel's over F, G and N1's packed runs, the epilogue's over every one of
those paths (each must launch it), each phase run with the counts set to
0 just before it; N2's are its workers' own counts; the epilogue's
max_abs_err the worst of C2 and its route holds), the nvidia-smi line,
and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a host without CUDA.

The CPU rehearsal of phases D-I (the README's) sets
POPPUNK_TPU_TORCH_DEVICE=cpu: the port runs on the card unless asked.
"""

import collections
import contextlib
import csv
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from poppunk_tpu_torch.bench import (bound, card_chunk, card_mesh,
                                     epilogue_operands, event_ms,
                                     random_components, time_cdist,
                                     timed_at_sm_clock)

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
SMALL = (16, 5, 3)            # ss64, bbits, K: the JAX kernel tests
PRODUCTION = (156, 14, 5)     # sketch size 9984, k = 13..29 step 4
ODD = (15, 5, 4)              # odd ss64: a 4-word chunk straddles two k slots
BENCH = (156, 14, 6)          # bench.py:30-32
KLIST = (13, 17, 21, 25, 29)
DIST_TOL = dict(rtol=1e-5, atol=2e-5)  # tests/test_torch_distances.py
# device against host sweep scores: both take ratios of exact integer
# counts in float64 (the device's A @ A entries are exact in float32 below
# 2^24), so they differ by rounding alone
SWEEP_ATOL = 1e-9
# the device sweep's peak beyond the buffers it names: the cuBLAS workspace
# and the caching allocator's rounding (tests/test_torch_sweep_memory.py)
SWEEP_MARGIN = 64 * 2**20
# the card's Boruvka MST weights against the CPU's (both float32 torch ops)
# and against the host Prim oracle in float64 (tests/test_hdbscan_shapes.py)
BORUVKA_ATOL = 1e-6
PRIM_ATOL = 1e-5
# the SCE optimisers on the card against the CPU after 5 epochs from the
# same start, over max |Y| (tests/test_torch_nj_embedding.py)
SCE_ATOL = 1e-4


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


def ptxas_entries(report):
    """ptxas -v's report -> {entry function: {"registers", "stack",
    "spill_stores", "spill_loads"}} (bytes but registers)."""
    entries, entry, props = {}, None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            entries[entry] = {}
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props in entries:
            entries[props].update(zip(("stack", "spill_stores",
                                       "spill_loads"), map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in entries:
            entries[entry]["registers"] = int(m.group(1))
    return entries


def epilogue_instantiations(report):
    """The epilogue kernel's instantiations in ptxas's report, by their
    template arguments: {"KMAX 8 random 1 rc 1 jaccard 0": {...}}."""
    out = {}
    for name, props in ptxas_entries(report).items():
        m = re.search(r"dist_epilogue_kernelILi(\d+)ELb([01])ELb([01])"
                      r"ELb([01])E", name)
        if m:
            out["KMAX {} random {} rc {} jaccard {}".format(
                *m.groups())] = props
    return dict(sorted(out.items()))


def phase_b():
    """Build the kernels; every KMAX 8 instantiation of the epilogue
    kernel must keep its arrays in registers: no stack, no spills.
    Returns the epilogue's instantiations (epilogue_instantiations)."""
    from poppunk_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    report = _build.ptxas_report or ""
    ptxas = [line.split(":", 1)[-1].strip() for line in report.splitlines()
             if "entry function" in line or "registers" in line
             or "spill" in line]
    epilogue = epilogue_instantiations(report)
    emit({"phase": "B", "library": os.path.relpath(path, REPO),
          "nvcc_seconds": _build.build_seconds, "ptxas": ptxas,
          "epilogue_instantiations": epilogue,
          "seconds": time.perf_counter() - t0})
    # KMAX 8 and 32, each with the three flag settings in both modes
    if report and len(epilogue) != 12:
        raise AssertionError(f"B: 12 epilogue instantiations expected in "
                             f"ptxas's report, found {sorted(epilogue)}")
    on_stack = {name: props for name, props in epilogue.items()
                if name.startswith("KMAX 8 ")
                and (props.get("stack") or props.get("spill_stores")
                     or props.get("spill_loads"))}
    if on_stack:
        raise AssertionError(f"B: KMAX 8 epilogue instantiations with a "
                             f"stack frame or spills: {on_stack}")
    return epilogue


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


def max_abs_err(got, want):
    return int((got.long() - want.long()).abs().max())


def phase_c(torch, device):
    """Both kernels against their plain versions (and the packed kernel
    against the standard one), bit for bit; both timed at BENCH. Returns
    {kernel name: {"max_abs_err", "ms", "plain_ms", ...}}."""
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.ops.distances import plane_geometry, planes_to_tensor

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    cases = [(3, 5, SMALL), (64, 128, SMALL), (65, 129, SMALL),
             (257, 1031, PRODUCTION), (65, 129, ODD), (2048, 4096, BENCH)]
    results = []
    kernels = {"match_counts": {"max_abs_err": 0},
               "match_counts_packed": {"max_abs_err": 0}}
    for nq, nr, geometry in cases:
        pad_bits = plane_geometry(geometry[0], geometry[1])[2]
        pq = random_planes(rng, nq, geometry)
        pr = random_planes(rng, nr, geometry)
        m = min(nq, nr)  # planted agreement: counts above the chance floor
        pr[:m, ..., :100] = pq[:m, ..., :100]
        q = planes_to_tensor(pq, device)
        r = planes_to_tensor(pr, device)
        qp, rp = mc.pack(q, pad_bits), mc.pack(r, pad_bits)
        got = mc.match_counts(q, r, pad_bits)
        want = mc.match_counts_torch(q, r, pad_bits)
        got_p = mc.match_counts_packed(qp, rp)
        want_p = mc.match_counts_packed_torch(qp, rp)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        err_p = max_abs_err(got_p, want_p)
        err_ps = max_abs_err(got_p, got)
        for name, e in (("match_counts", err),
                        ("match_counts_packed", max(err_p, err_ps))):
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"],
                                               e)
        results.append({"nq": nq, "nr": nr, "ss64": geometry[0],
                        "bbits": geometry[1], "K": geometry[2],
                        "G": qp.g, "L": qp.bits.shape[-1],
                        "max_abs_err": err, "packed_max_abs_err": err_p,
                        "packed_vs_standard_max_abs_err": err_ps})
        if geometry is BENCH:
            w32 = plane_geometry(geometry[0], geometry[1])[0]
            library_ms = time_cdist(q, r, got, w32)
            for name, kernel, plain, args in (
                    ("match_counts", mc.match_counts, mc.match_counts_torch,
                     (q, r, pad_bits)),
                    ("match_counts_packed", mc.match_counts_packed,
                     mc.match_counts_packed_torch, (qp, rp))):
                kernel(*args)  # warm
                # ~1 s of calls: some 20 clock samples fall inside
                ms, sm_mhz, samples = timed_at_sm_clock(
                    lambda: kernel(*args), 60)
                plain_ms = event_ms(lambda: plain(*args), 2)
                in_bytes = sum(t.numel() * 4 for t in (
                    (q, r) if name == "match_counts" else (qp.bits, rp.bits)))
                bound_ms, bound_by = bound(nq, nr, geometry[2], geometry[1],
                                           w32, in_bytes, sm_mhz)
                kernels[name].update(
                    shape=[nq, nr, geometry[2]], ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by, bound_share=bound_ms / ms,
                    sm_clock_mhz=sm_mhz, sm_clock_samples=samples,
                    pairs_per_s=nq * nr / (ms / 1e3),
                    plain_pairs_per_s=nq * nr / (plain_ms / 1e3))
        del q, r, qp, rp, got, want, got_p, want_p
    emit({"phase": "C", "cases": results, "kernels": kernels,
          "seconds": elapsed(torch, t0)})
    if any(k["max_abs_err"] for k in kernels.values()):
        raise AssertionError(f"a kernel disagrees with its plain version or "
                             f"the packed kernel with the standard one: "
                             f"{results}")
    return kernels


# --------------------------------------------------------------------------
# C2: the distance epilogue against plain
# --------------------------------------------------------------------------

# (nq, nr, geometry, klist): C's shapes, then K 29 (parse_kmers' widest
# list, 3..31), k 1, 2, 3 and 31 (the ends of the pow chain), K 8 and 9 on
# either side of the kernel's KMAX 8 instantiation
C2_CASES = ((64, 128, SMALL, KLIST[:3]), (257, 1031, PRODUCTION, KLIST),
            (65, 129, ODD, (1, 2, 3, 31)),
            (64, 129, SMALL[:2] + (29,), tuple(range(3, 32))),
            (64, 129, SMALL[:2] + (8,), tuple(range(13, 29, 2))),
            (64, 129, SMALL[:2] + (9,), tuple(range(13, 31, 2))),
            (2048, 4096, BENCH, (13, 16, 19, 22, 25, 28)))
C2_FLAGS = ((True, True), (True, False), (False, False))
# a pair of the BENCH case held to itself in a 1 x 1 and a 64 x 128 call
C2_PAIR = (1000, 3000)
# the query rows of each C2 case held to the float64 oracle on the host
C2_ORACLE_ROWS = 512


def worst_pairs(got, want, ops, n=3):
    """The pairs furthest apart, with their counts, lengths and
    frequencies: what a failure prints."""
    counts, lq, lr, fq, fr = ops
    err = (got - want).abs().amax(dim=-1).flatten()
    out = []
    for flat in err.topk(min(n, err.numel())).indices.tolist():
        q, r = divmod(flat, got.shape[1])
        out.append({"pair": [q, r], "got": got[q, r].tolist(),
                    "want": want[q, r].tolist(),
                    "counts": counts[q, r].tolist(),
                    "lengths": [int(lq[q]), int(lr[r])],
                    "freq_q": fq[q].tolist(), "freq_r": fr[r].tolist()})
    return out


def hold_epilogue(torch, got, want, ops, jaccard, where):
    """The kernel's output against the plain version's: Jaccards bit for
    bit, distances within DIST_TOL. Returns max |got - want|; raises with
    the worst pairs' inputs."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if jaccard:
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    else:
        bad = int((~torch.isclose(got, want, **DIST_TOL)).sum())
    if bad:
        what = "Jaccards" if jaccard else "distances"
        raise AssertionError(
            f"{where}: the epilogue kernel's {what} differ from the plain "
            f"version's at {bad} values (max |diff| {err}): "
            f"{worst_pairs(got, want, ops)}")
    return err


def hold_to_the_oracle(jaccards, dists, klist, where):
    """The kernel's (core, accessory) (numpy) against the float64 oracle
    (ops/kmer_fit.py::fit_kmer_curve_np) on its own float32 Jaccards: each
    value within DIST_TOL or, where that is more, within the float32 fit's
    rounding bound (kmer_fit.fit_rounding_bound), which depends on no
    library's summation order. Returns (max |diff|, values beyond
    DIST_TOL, values whose bound is beyond it)."""
    from poppunk_tpu_torch.ops.kmer_fit import (fit_kmer_curve_np,
                                                fit_rounding_bound)

    oracle = np.stack(fit_kmer_curve_np(jaccards, np.float32(klist)), -1)
    tol = DIST_TOL["atol"] + DIST_TOL["rtol"] * np.abs(oracle)
    bound = fit_rounding_bound(jaccards, klist)
    err = np.abs(dists - oracle)
    bad = err > np.maximum(tol, bound)
    if bad.any():
        q, r = np.argwhere(bad)[0][:2]
        raise AssertionError(
            f"{where}: {int(bad.sum())} distances beyond the float64 "
            f"oracle's limit, first pair {[int(q), int(r)]}: kernel "
            f"{dists[q, r].tolist()}, oracle {oracle[q, r].tolist()}, bound "
            f"{bound[q, r].tolist()}, Jaccards {jaccards[q, r].tolist()}")
    return (float(err.max()), int((err > tol).sum()),
            int((bound > tol).sum()))


# every hold of the epilogue kernel at a route's own operands: (where,
# distances' max |diff|, Jaccards' max |diff|), folded into the kernel line
EPILOGUE_HOLDS = []


@contextlib.contextmanager
def uncounted():
    """Launches inside compare a kernel with its plain version: the launch
    counts are as they were before them."""
    from poppunk_tpu_torch.ops import distances as dd
    from poppunk_tpu_torch.ops import match_counts as mc

    saved = mc.LAUNCHES, mc.PACKED_LAUNCHES, dd.EPILOGUE_LAUNCHES
    try:
        yield
    finally:
        mc.LAUNCHES, mc.PACKED_LAUNCHES, dd.EPILOGUE_LAUNCHES = saved


def record_epilogue_hold(where, dist_err, jac_err=0.0):
    EPILOGUE_HOLDS.append((where, dist_err, jac_err))
    emit({"epilogue_hold": where, "max_abs_err": dist_err,
          "jaccard_max_abs_err": jac_err})


def hold_tile_epilogue(torch, where, route, lq, lr, fq, fr, klist, ss64,
                       bbits, counts, plain_counts):
    """The epilogue kernel at a scale tile's own operands (the tile's
    kernel-1 and plain counts ``counts`` and ``plain_counts``, its query
    genomes' lengths and frequencies lq and fq, its columns' lr and fr):
    ``route()``, the tile's distances as the route itself computes them,
    against the plain epilogue on the plain counts within DIST_TOL, and
    the kernel's Jaccards on the route's counts against the plain
    version's bit for bit. The plain version runs 64 rows at a time, as
    the CPU route does. Not counted in any path."""
    from poppunk_tpu_torch.ops import distances as dd

    ops = (plain_counts, lq, lr, fq, fr)
    with uncounted():
        got = route()
        want = torch.empty_like(got)
        for a in range(0, got.shape[0], 64):
            dd.dist_epilogue_torch(plain_counts[a:a + 64], klist,
                                   lq[a:a + 64], lr, fq[a:a + 64], fr, ss64,
                                   bbits, out=want[a:a + 64])
        dist_err = hold_epilogue(torch, got, want, ops, False, where)
        del got, want
        jac = dd.dist_epilogue(counts, klist, lq, lr, fq, fr, ss64, bbits,
                               jaccard=True)
        want = torch.empty_like(jac)
        for a in range(0, jac.shape[0], 64):
            dd.dist_epilogue_torch(counts[a:a + 64], klist, lq[a:a + 64], lr,
                                   fq[a:a + 64], fr, ss64, bbits,
                                   jaccard=True, out=want[a:a + 64])
        jac_err = hold_epilogue(torch, jac, want, (counts, *ops[1:]), True,
                                where)
    record_epilogue_hold(where, dist_err, jac_err)


def phase_c2(torch, device, instantiations):
    """C2: the distance epilogue kernel (csrc/dist_epilogue.cu, wrapper
    ops/distances.dist_epilogue) against its plain version
    (dist_epilogue_torch) on the card, on kernel 1's counts at C's shapes,
    K 29, k 1, 2, 3 and 31, K 8 and 9, with the degenerate rows
    (epilogue_operands), in both output modes, with the random-match
    correction with and without the reverse complement and
    without it: Jaccards bit for bit, distances within DIST_TOL. The
    distances of each case's first C2_ORACLE_ROWS query rows are held to
    the float64 oracle on the kernel's own Jaccards (hold_to_the_oracle).
    One BENCH pair equals itself, bit for bit, in a 1 x 1 and a 64 x 128
    call. Timed at BENCH (2048 x 4096 x K 6, distances) by CUDA events
    at the SM clock, beside the plain version and the bound
    (bench.epilogue_bound: the bytes, or the function's float32 and
    special-function operations at that clock). library_ms is
    None: no single PyTorch call computes this function. Each case names
    the kernel's KMAX instantiation; ``instantiations`` (phase B's ptxas
    report) goes in the record.
    These launches compare; no path counts them. Returns the kernel's
    summary entry."""
    from poppunk_tpu_torch import bench
    from poppunk_tpu_torch.ops import distances as dd

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    results, worst, jac_worst, timing = [], 0.0, 0.0, {}
    oracle = {"max_abs_err": 0.0, "beyond_dist_tol": 0, "undecided": 0,
              "values": 0}
    for nq, nr, geometry, klist in C2_CASES:
        ss64, bbits = geometry[:2]
        ops = epilogue_operands(device, rng, nq, nr, geometry, klist)
        errs = {}
        for random_correct, use_rc in C2_FLAGS:
            for jaccard in (True, False):
                args = (ops[0], klist, *ops[1:], ss64, bbits, random_correct,
                        use_rc, jaccard)
                got = dd.dist_epilogue(*args)
                want = dd.dist_epilogue_torch(*args)
                where = (f"C2 {nq} x {nr} x K {len(klist)} random_correct "
                         f"{random_correct} use_rc {use_rc}")
                err = hold_epilogue(torch, got, want, ops, jaccard, where)
                errs[f"{'jaccards' if jaccard else 'dists'}_"
                     f"{int(random_correct)}{int(use_rc)}"] = err
                rows = got[:C2_ORACLE_ROWS].cpu().numpy()
                if jaccard:
                    jac_worst = max(jac_worst, err)
                    jac_rows = rows
                else:
                    worst = max(worst, err)
                    o_err, beyond, undecided = hold_to_the_oracle(
                        jac_rows, rows, klist, where)
                    oracle["max_abs_err"] = max(oracle["max_abs_err"], o_err)
                    oracle["beyond_dist_tol"] += beyond
                    oracle["undecided"] += undecided
                    oracle["values"] += rows.size
                del got, want
        kmax = min(m for m in dd.EPILOGUE_KMAX if m >= len(klist))
        results.append({"nq": nq, "nr": nr, "ss64": ss64, "bbits": bbits,
                        "klist": list(klist), "kmax": kmax,
                        "max_abs_err": errs})
        if geometry is BENCH:
            q, r = C2_PAIR
            tiles = {}
            for jaccard in (False, True):
                whole = dd.dist_epilogue(ops[0], klist, *ops[1:], ss64,
                                         bbits, jaccard=jaccard)
                for name, (q0, q1), (r0, r1) in (
                        ("1x1", (q, q + 1), (r, r + 1)),
                        ("64x128", (q - 20, q + 44), (r - 100, r + 28))):
                    part = dd.dist_epilogue(
                        ops[0][q0:q1, r0:r1].contiguous(), klist,
                        ops[1][q0:q1], ops[2][r0:r1], ops[3][q0:q1],
                        ops[4][r0:r1], ss64, bbits, jaccard=jaccard)
                    tiles[f"{name}_{'jaccards' if jaccard else 'dists'}"] = \
                        bool(torch.equal(
                            part[q - q0, r - r0].view(torch.int32),
                            whole[q, r].view(torch.int32)))
            if not all(tiles.values()):
                raise AssertionError(f"C2: pair {C2_PAIR}'s value depends on "
                                     f"the tile: {tiles}")
            args = (ops[0], klist, *ops[1:], ss64, bbits)
            fn = lambda: dd.dist_epilogue(*args)  # noqa: E731
            fn()
            window = bench.clock_window(fn, event_ms(fn, 10))
            plain_ms = event_ms(lambda: dd.dist_epilogue_torch(*args), 3)
            jaccard_ms = event_ms(
                lambda: dd.dist_epilogue(*args, jaccard=True), 20)
            bound_ms, bound_by, reckoning = bench.epilogue_bound(
                nq, nr, len(klist), window["sm_clock_mhz"])
            instantiation = f"KMAX {kmax} random 1 rc 1 jaccard 0"
            timing = dict(shape=[nq, nr, len(klist)], ms=window["ms"],
                          instantiation=instantiation,
                          ptxas=instantiations.get(instantiation),
                          plain_ms=plain_ms, jaccard_ms=jaccard_ms,
                          library_ms=None, bound_ms=bound_ms,
                          bound_by=bound_by,
                          bound_share=bound_ms / window["ms"],
                          sm_clock_mhz=window["sm_clock_mhz"],
                          sm_clock_samples=window["sm_clock_samples"],
                          reckoning=reckoning, tile_bit_equal=tiles)
        del ops
    emit({"phase": "C2", "cases": results, "timing": timing,
          "max_abs_err": worst, "jaccard_max_abs_err": jac_worst,
          "oracle": oracle, "instantiations": instantiations,
          "seconds": elapsed(torch, t0)})
    if jac_worst:
        raise AssertionError(f"C2: Jaccards differ: {results}")
    return dict(timing, max_abs_err=worst, jaccard_max_abs_err=jac_worst)


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
    db = os.path.join(workdir, "db")
    out = os.path.join(workdir, "assigned")
    stages, launches = {}, {}

    t = time.perf_counter()
    n0 = mc.LAUNCHES
    poppunk_main(["--create-db", "--r-files", rfile, "--output", db,
                  "--no-plot"])
    stages["create_db"] = elapsed(torch, t)
    launches["create_db"] = mc.LAUNCHES - n0

    t = time.perf_counter()
    model, _ = poppunk_main(["--fit-model", "bgmm", "--ref-db", db,
                             "--output", db, "--no-plot"])
    stages["fit_bgmm"] = elapsed(torch, t)
    if model.mixture.means.device.type != device.type:
        raise AssertionError(f"BGMM on {model.mixture.means.device}")

    t = time.perf_counter()
    n0 = mc.LAUNCHES
    assign_main(["--db", db, "--query", qfile, "--output", out])
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
    return launches, SimpleNamespace(db=db, rfile=rfile, qfile=qfile,
                                     refs=refs, queries=queries,
                                     strain_of=strain_of,
                                     genome_length=genome_length)


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
        G, old_clusters = fetch_network(out, model, rlist)
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
    record_epilogue_hold(f"E spot rows {spot_rows} x {n_ref}", float(
        np.abs(q_dists[:spot_rows] - d_plain).max()))

    emit({"phase": "E", "references": n_ref, "queries": n_query,
          "strains": n_strains, "pairs_all_vs_all": int(X.shape[0]),
          "pairs_query": int(n_query * n_ref),
          "within_pairs": int((np.asarray(y) == model.within_label).sum()),
          "stages": stages, "launches": launches,
          "peak_device_bytes": peak, "spot_check_rows": spot_rows,
          "seconds": time.perf_counter() - t0})
    return launches, SimpleNamespace(
        planes=planes, lengths=lengths, freqs=freqs, n_ref=n_ref,
        names=names, strain_of=strain_of, X=X, q_dists=q_dists, model=model)


# --------------------------------------------------------------------------
# F, G: the refine / threshold path under the packed kernel choice
# --------------------------------------------------------------------------

class RecordSweeps:
    """Record the boundary sweeps models/refine.py runs: (kind, args,
    scores, seconds) per call, kind "device" (ops/device_sweep.py) or
    "host" (network/incremental.py), and in ``peaks`` each call's peak
    device memory net of what was live before it (None on the host or the
    CPU). The functions are wrapped, not replaced; both return host
    arrays, so a call's seconds include its device work."""

    def __enter__(self):
        from poppunk_tpu_torch.models import refine

        self.module, self.calls, self.peaks = refine, [], []
        self.saved = {}
        for kind, attr in (("device", "sweep_scores_device"),
                           ("host", "grow_network_scores")):
            fn = self.saved[attr] = getattr(refine, attr)
            setattr(refine, attr, self._recorder(kind, fn))
        return self

    def _recorder(self, kind, fn):
        import torch

        def record(*args, **kwargs):
            card = kind == "device" and torch.cuda.is_available()
            if card:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            scores = fn(*args, **kwargs)
            self.calls.append((kind, args, scores, time.perf_counter() - t))
            self.peaks.append(torch.cuda.max_memory_allocated() - base
                              if card else None)
            return scores
        return record

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.module, attr, fn)

    def global_sweeps(self, n_offsets):
        """The calls that scored a whole offset grid (not the local
        search's one-offset scores)."""
        return [c for c in self.calls if c[1][4] == n_offsets]

    def global_peak(self, n_offsets):
        """The peak device bytes of the one whole-grid sweep."""
        (peak,) = [p for c, p in zip(self.calls, self.peaks)
                   if c[1][4] == n_offsets]
        return peak


def read_dists(prefix):
    """(names, X) of a database's ``.dists`` (the reference's pickle +
    npy pair)."""
    import pickle

    stem = os.path.join(prefix, os.path.basename(prefix) + ".dists")
    with open(stem + ".pkl", "rb") as f:
        names = pickle.load(f)[0]
    return names, np.load(stem + ".npy")


def phase_f(torch, device, workdir, d):
    """The CLIs under KERNEL_CHOICE packed on phase D's population and its
    BGMM fit: create-db (distances equal phase D's bit for bit), refine
    with --indiv-refine both, threshold, and assign with the refine model
    with and without --core --accessory. Returns packed launches per
    stage."""
    from poppunk_tpu_torch.cli.assign import main as assign_main
    from poppunk_tpu_torch.cli.main import main as poppunk_main
    from poppunk_tpu_torch.ops import match_counts as mc

    t0 = time.perf_counter()
    stages, launches = {}, {}
    path = lambda name: os.path.join(workdir, name)  # noqa: E731
    db, refined, thr = path("db_packed"), path("refined"), path("threshold")

    def run(stage, fn, argv):
        t = time.perf_counter()
        n0 = mc.PACKED_LAUNCHES
        result = fn(argv)
        stages[stage] = elapsed(torch, t)
        launches[stage] = mc.PACKED_LAUNCHES - n0
        return result

    run("create_db", poppunk_main, ["--create-db", "--r-files", d.rfile,
                                    "--output", db, "--no-plot"])
    names, X = read_dists(db)
    want_names, want = read_dists(d.db)
    if names != want_names or not np.array_equal(X, want):
        raise AssertionError("packed create-db distances differ from the "
                             "standard kernel's")

    with RecordSweeps() as sweeps:
        model, _ = run("fit_refine", poppunk_main, [
            "--fit-model", "refine", "--ref-db", db, "--model-dir", d.db,
            "--output", refined, "--indiv-refine", "both", "--no-plot"])
    kinds = sorted({c[0] for c in sweeps.global_sweeps(40)})
    if device.type == "cuda" and kinds != ["device"]:
        raise AssertionError(f"refine's global sweeps ran on {kinds}")
    if not model.indiv_fitted:
        raise AssertionError("--indiv-refine both did not fit both boundaries")
    ref_clusters = {}  # the refined networks' clusters, by fit type
    for ext in ("", "_core", "_accessory"):
        clusters = ref_clusters[ext] = read_clusters(os.path.join(
            refined, f"refined{ext}_clusters.csv"))
        if set(clusters) != set(d.refs):
            raise AssertionError(f"refined{ext} clusters miss samples")
        check_partition(clusters, d.strain_of)

    # the threshold at the core boundary refine found, in distance units
    threshold = float(model.core_boundary * model.scale[0])
    run("fit_threshold", poppunk_main, [
        "--fit-model", "threshold", "--threshold", repr(threshold),
        "--ref-db", db, "--output", thr, "--no-plot"])
    check_partition(read_clusters(os.path.join(thr, "threshold_clusters.csv")),
                    d.strain_of)

    for stage, flags in (("assign", []),
                         ("assign_core_accessory", ["--core", "--accessory"])):
        out = path(stage)
        run(stage, assign_main, ["--db", refined, "--query", d.qfile,
                                 "--output", out] + flags)
        for ext in (("", "_core", "_accessory") if flags else ("",)):
            name = f"{stage}{ext}{'_refined' if ext else ''}_clusters.csv"
            q_clusters = read_clusters(os.path.join(out, name))
            if set(q_clusters) != set(d.queries):
                raise AssertionError(f"{name}: assigned "
                                     f"{sorted(q_clusters)}")
            check_queries(q_clusters, ref_clusters[ext], d.strain_of)

    emit({"phase": "F", "kernel_choice": mc.KERNEL_CHOICE,
          "threshold": threshold, "global_sweeps": kinds,
          "boundaries": {"x": float(model.optimal_x),
                         "y": float(model.optimal_y),
                         "core": float(model.core_boundary),
                         "accessory": float(model.accessory_boundary)},
          "stages": stages, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return {k: launches[k] for k in ("create_db", "assign",
                                     "assign_core_accessory")}


def phase_g(torch, device, workdir, e):
    """Phase E's planted population under KERNEL_CHOICE packed: the packed
    all-vs-all (equal to phase E's distances bit for bit), refine from
    phase E's BGMM fit with the device sweep (its 40 global scores held to
    the host sweep on the same edges), the refine network, and fused
    boundary-post assignment of the queries. Returns packed launches."""
    from poppunk_tpu_torch.assign import add_query_to_network, fetch_network
    from poppunk_tpu_torch.cli.main import make_network_and_refs
    from poppunk_tpu_torch.models import RefineFit
    from poppunk_tpu_torch.network.clusters import print_clusters
    from poppunk_tpu_torch.network.incremental import grow_network_scores
    from poppunk_tpu_torch.ops import device_sweep
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.ops.device_sweep import sweep_scores_device
    from poppunk_tpu_torch.ops.distances import (condensed_self_block,
                                                 pairwise_block)
    from poppunk_tpu_torch.ops.fused_assign import model_post_spec

    ss64, bbits = PRODUCTION[:2]
    t0 = time.perf_counter()
    stages = {}
    n0 = mc.PACKED_LAUNCHES

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        stages[name] = elapsed(torch, t)
        return out

    n = e.n_ref
    rlist, qlist = e.names[:n], e.names[n:]
    pr, lr, fr = e.planes[:n], e.lengths[:n], e.freqs[:n]
    pq, lq, fq = e.planes[n:], e.lengths[n:], e.freqs[n:]

    X = timed("distances", lambda: condensed_self_block(
        pr, lr, fr, KLIST, ss64, bbits, device=device))
    if not np.array_equal(X, e.X):
        raise AssertionError("packed all-vs-all distances differ from the "
                             "standard kernel's")

    out = os.path.join(workdir, "planted_refine")
    model = RefineFit(out, device=device)
    with RecordSweeps() as sweeps:
        y = timed("refine_fit_assign", lambda: model.fit(
            X, rlist, e.model, max_move=0.0, min_move=0.0))
    (kind, sweep_args, scores, sweep_s), = sweeps.global_sweeps(40)
    if device.type == "cuda" and kind != "device":
        raise AssertionError(f"refine's global sweep ran on the {kind}")
    # the dense sweep holds A and its product, one float64 row block of
    # the product while it is summed, and the edges' int64 indices
    sweep_peak = sweeps.global_peak(40)
    sweep_named = (2 * 4 * n * n + 8 * device_sweep._SQUARE_ROWS * n
                   + 16 * len(sweep_args[1]))
    if sweep_peak is not None and sweep_peak > sweep_named + SWEEP_MARGIN:
        raise AssertionError(f"the device sweep peaked at {sweep_peak} "
                             f"bytes against {sweep_named} named")

    # the same edges through the other scorer
    n_edges = len(sweep_args[1])
    if kind == "device":
        other = timed("host_sweep", lambda: grow_network_scores(
            *sweep_args[:5], score_idx=0))
    else:
        other = timed("device_sweep", lambda: sweep_scores_device(
            *sweep_args[:5], device))
    np.testing.assert_allclose(scores, other, rtol=0, atol=SWEEP_ATOL)
    if int(np.argmin(scores)) != int(np.argmin(other)):
        raise AssertionError("device and host sweeps disagree on the argmin")

    args = SimpleNamespace(graph_weights=False, summary_sample=None,
                           betweenness_sample=100, external_clustering=None,
                           threads=1, ref_db=out, output=out,
                           indiv_refine=None)
    timed("network_clusters_refs",
          lambda: make_network_and_refs(model, y, rlist, X, out, args))
    ref_clusters = read_clusters(os.path.join(out,
                                              "planted_refine_clusters.csv"))
    check_partition(ref_clusters, e.strain_of)

    def assign():
        dists, classes = pairwise_block(
            pq, pr, lq, lr, fq, fr, KLIST, ss64, bbits,
            post_spec=model_post_spec(model), device=device)
        G, old_clusters = fetch_network(out, model, rlist)
        G, _ = add_query_to_network(rlist, qlist, G, classes.reshape(-1),
                                    model, out, kmers=list(KLIST))
        clusters, _ = print_clusters(G, rlist + qlist,
                                     os.path.join(out, "queries"),
                                     old_clusters, print_ref=False)
        return dists, {q: str(clusters[q]) for q in qlist}

    q_dists, q_clusters = timed("fused_query_assign", assign)
    launches = mc.PACKED_LAUNCHES - n0
    if not np.array_equal(q_dists, e.q_dists):
        raise AssertionError("packed query distances differ from the "
                             "standard kernel's")
    check_queries(q_clusters, ref_clusters, e.strain_of)

    emit({"phase": "G", "kernel_choice": mc.KERNEL_CHOICE,
          "references": n, "queries": len(qlist),
          "global_sweep": kind, "global_sweep_s": sweep_s,
          "global_sweep_peak_bytes": sweep_peak,
          "global_sweep_named_bytes": sweep_named,
          "local_sweeps": len(sweeps.calls) - 1,
          "local_sweeps_s": sum(c[3] for c in sweeps.calls) - sweep_s,
          "sweep_edges": n_edges,
          "sweep_argmin": int(np.argmin(scores)),
          "sweep_max_abs_diff": float(np.abs(scores - other).max()),
          "boundary": [float(model.optimal_x), float(model.optimal_y)],
          "within_pairs": int((np.asarray(y) == model.within_label).sum()),
          "stages": stages, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches


# --------------------------------------------------------------------------
# H, I: the DBSCAN and lineage models, and --qc-db
# --------------------------------------------------------------------------

def check_pure(clusters, strain_of, what):
    """No cluster holds two strains (a strain may span several)."""
    by_cluster = {}
    for name, cl in clusters.items():
        by_cluster.setdefault(cl, set()).add(strain_of[name])
    mixed = {cl: s for cl, s in by_cluster.items() if len(s) > 1}
    if mixed:
        raise AssertionError(f"{what}: clusters mix strains: {mixed}")


def read_lineages(path):
    """(header, {name: row}) of a _lineages.csv."""
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], {row[0]: row for row in rows[1:]}


class RecordPosts:
    """Record the device of every tile the fused ``name`` post classifies
    (ops/fused_assign.py; wrapped, not replaced)."""

    def __init__(self, name):
        self.name, self.devices = name, set()

    def __enter__(self):
        from poppunk_tpu_torch.ops import fused_assign

        self.table = fused_assign.POST_FNS
        fn = self.saved = self.table[self.name]

        def record(dists, params, static):
            self.devices.add(dists.device.type)
            return fn(dists, params, static)
        self.table[self.name] = record
        return self

    def __exit__(self, *exc):
        self.table[self.name] = self.saved


class RecordBoruvka:
    """Record the HDBSCAN fits ops/hdbscan.py runs: each fit's
    (min_samples, min_cluster_size), and per Boruvka MST its size, rounds,
    the devices its rounds ran on, its seconds and the seconds of its
    sweeps (each round's result is copied to the host right after it, so
    the synchronise that ends a sweep's timing moves no work). The
    functions are wrapped, not replaced."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from poppunk_tpu_torch.ops import hdbscan

        self.module, self.steps, self.msts = hdbscan, [], []
        self.saved = {name: getattr(hdbscan, name) for name in
                      ("boruvka_mst_device", "_boruvka_round")}
        self.saved_fit = hdbscan.HDBSCAN.fit
        rounds = []

        def boruvka_round(X, *args, **kwargs):
            t = time.perf_counter()
            out = self.saved["_boruvka_round"](X, *args, **kwargs)
            rounds.append((X.device.type, elapsed(self.torch, t)))
            return out

        def boruvka_mst(X, *args, **kwargs):
            rounds.clear()
            t = time.perf_counter()
            edges = self.saved["boruvka_mst_device"](X, *args, **kwargs)
            self.msts.append({"n": int(X.shape[0]), "rounds": len(rounds),
                              "devices": sorted({r[0] for r in rounds}),
                              "seconds": time.perf_counter() - t,
                              "sweep_seconds": [r[1] for r in rounds]})
            return edges

        def fit(model, X):
            self.steps.append([int(model.min_samples),
                               int(model.min_cluster_size)])
            return self.saved_fit(model, X)

        hdbscan._boruvka_round = boruvka_round
        hdbscan.boruvka_mst_device = boruvka_mst
        hdbscan.HDBSCAN.fit = fit
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)
        self.module.HDBSCAN.fit = self.saved_fit


def phase_h(torch, device, workdir, d):
    """The DBSCAN, lineage and QC CLIs under KERNEL_CHOICE standard on
    phase D's population and database. Returns standard launches for the
    stages that compute distances."""
    from poppunk_tpu_torch.cli.assign import main as assign_main
    from poppunk_tpu_torch.cli.main import main as poppunk_main
    from poppunk_tpu_torch.io.hdf5db import get_seqs_in_db
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.utils import db_h5_path

    t0 = time.perf_counter()
    stages, launches = {}, {}
    path = lambda name: os.path.join(workdir, name)  # noqa: E731

    def run(stage, fn, argv, counted=False):
        t = time.perf_counter()
        n0 = mc.LAUNCHES
        result = fn(argv)
        stages[stage] = elapsed(torch, t)
        if counted:
            launches[stage] = mc.LAUNCHES - n0
        return result

    # --qc-db: one reference removed by name (the distance thresholds
    # opened wide: at the defaults, 0.1 core, the other strains' members
    # fail against the first genome's strain)
    removed = d.refs[0]
    listing = path("remove.txt")
    with open(listing, "w") as f:
        f.write(removed + "\n")
    qc = path("qc")
    run("qc_db", poppunk_main, ["--qc-db", "--ref-db", d.db, "--output", qc,
                                "--remove-samples", listing,
                                "--max-pi-dist", "1", "--max-a-dist", "1",
                                "--max-zero-dist", "1"])
    names, _ = read_dists(qc)
    with open(os.path.join(qc, "qc_qcreport.txt")) as f:
        report = f.read()
    if (names != [n for n in d.refs if n != removed]
            or sorted(get_seqs_in_db(db_h5_path(qc))) != sorted(names)
            or report != f"{removed}\tRequested removal\n"):
        raise AssertionError(f"--qc-db kept {names}, reported {report!r}")

    # DBSCAN: fit, then assign through the fused dbscan post
    dbscan = path("dbscan")
    run("fit_dbscan", poppunk_main, ["--fit-model", "dbscan", "--ref-db",
                                     d.db, "--output", dbscan, "--no-plot"])
    ref_clusters = read_clusters(os.path.join(dbscan, "dbscan_clusters.csv"))
    if set(ref_clusters) != set(d.refs):
        raise AssertionError("DBSCAN clusters miss samples")
    check_partition(ref_clusters, d.strain_of)
    with RecordPosts("dbscan") as posts:
        run("dbscan_assign", assign_main, [
            "--db", dbscan, "--query", d.qfile, "--output",
            path("dbscan_assign")], counted=True)
    if posts.devices != {device.type}:
        raise AssertionError(f"the dbscan post ran on {posts.devices}")
    q_clusters = read_clusters(path("dbscan_assign/dbscan_assign_clusters.csv"))
    if set(q_clusters) != set(d.queries):
        raise AssertionError(f"DBSCAN assigned {sorted(q_clusters)}")
    check_queries(q_clusters, ref_clusters, d.strain_of)

    # a DBSCAN start model for refine
    run("fit_dbscan_for_refine", poppunk_main, [
        "--fit-model", "dbscan", "--ref-db", d.db, "--output",
        path("dbscan_fr"), "--for-refine", "--no-plot"])
    run("fit_refine_from_dbscan", poppunk_main, [
        "--fit-model", "refine", "--ref-db", d.db, "--model-dir",
        path("dbscan_fr"), "--output", path("refine_dbscan"), "--no-plot"])
    refined = read_clusters(
        path("refine_dbscan/refine_dbscan_clusters.csv"))
    if set(refined) != set(d.refs):
        raise AssertionError("refine-from-DBSCAN clusters miss samples")
    check_pure(refined, d.strain_of, "refine from DBSCAN")

    # lineage: fitted in place on a copy of the database, then assigned
    lineage = path("lineage/db")
    shutil.copytree(d.db, lineage)
    run("fit_lineage", poppunk_main, [
        "--fit-model", "lineage", "--ranks", "1,2", "--ref-db", lineage,
        "--output", lineage, "--no-plot"])
    rank1 = {}
    for stage, flags in (("lineage_assign", []),
                         ("lineage_assign_update", ["--update-db", "full"])):
        run(stage, assign_main, ["--db", lineage, "--query", d.qfile,
                                 "--output", path(stage)] + flags,
            counted=True)
        header, rows = read_lineages(
            os.path.join(path(stage), f"{stage}_lineages.csv"))
        if header != ["id", "Rank_1", "Rank_2", "overall", "Status"] or \
                set(rows) != set(d.refs) | set(d.queries):
            raise AssertionError(f"{stage}: {header}, {sorted(rows)}")
        statuses = {name: row[-1] for name, row in rows.items()}
        if any(statuses[q] != "Query" for q in d.queries) or \
                any(statuses[r] != "Reference" for r in d.refs):
            raise AssertionError(f"{stage}: statuses {statuses}")
        rank1[stage] = {name: row[1] for name, row in rows.items()}
        check_pure(rank1[stage], d.strain_of, f"{stage} rank 1")

    emit({"phase": "H", "kernel_choice": mc.KERNEL_CHOICE,
          "qc_removed": removed, "dbscan_clusters":
          len(set(ref_clusters.values())),
          "refine_from_dbscan_clusters": len(set(refined.values())),
          "rank1_lineages": {k: len(set(v.values()))
                             for k, v in rank1.items()},
          "post_devices": sorted(posts.devices),
          "stages": stages, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches


def phase_i(torch, device, workdir, e, max_samples=100000,
            check_points=8192):
    """Phase E's population through the DBSCAN model at the CLI defaults
    (the HDBSCAN Boruvka sweep on the card), its network and fused
    dbscan-post query assignment, the Boruvka check and a lineage fit
    extended with the queries. Returns standard launches for the stages
    that compute distances."""
    from poppunk_tpu_torch.assign import add_query_to_network, fetch_network
    from poppunk_tpu_torch.cli.main import make_network_and_refs
    from poppunk_tpu_torch.models import DBSCANFit, LineageFit
    from poppunk_tpu_torch.network import Graph, connected_components
    from poppunk_tpu_torch.network.clusters import print_clusters
    from poppunk_tpu_torch.ops import hdbscan
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.ops.distances import (condensed_self_block,
                                                 pairwise_block)
    from poppunk_tpu_torch.ops.fused_assign import model_post_spec

    ss64, bbits = PRODUCTION[:2]
    t0 = time.perf_counter()
    stages, launches = {}, {}
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        stages[name] = elapsed(torch, t)
        return out

    n = e.n_ref
    rlist, qlist = e.names[:n], e.names[n:]
    pr, lr, fr = e.planes[:n], e.lengths[:n], e.freqs[:n]
    pq, lq, fq = e.planes[n:], e.lengths[n:], e.freqs[n:]

    # the fit at the CLI defaults; its exact assignment of every pair
    # (DBSCANFit.assign, host kNN over the fitted points) is timed apart
    out = os.path.join(workdir, "planted_dbscan")
    model = DBSCANFit(out, max_samples=max_samples, max_batch_size=5000,
                      device=device)
    assign_calls = []

    def timed_assign(X, *args, **kwargs):
        t = time.perf_counter()
        y = DBSCANFit.assign(model, X, *args, **kwargs)
        assign_calls.append((X.shape[0], time.perf_counter() - t))
        return y

    model.assign = timed_assign
    with RecordBoruvka(torch) as boruvka:
        y = timed("dbscan_fit", lambda: model.fit(e.X, 100, 0.0001))
    del model.assign
    stages["dbscan_assign"] = sum(s for rows, s in assign_calls
                                  if rows == e.X.shape[0])
    stages["dbscan_fit"] -= stages["dbscan_assign"]
    if not boruvka.msts or any(m["devices"] != [device.type]
                               for m in boruvka.msts):
        raise AssertionError(f"Boruvka MSTs: {boruvka.msts}")
    y_grid = timed("dbscan_grid_assign",
                   lambda: model.assign(e.X, use_grid=True))

    args = SimpleNamespace(graph_weights=False, summary_sample=None,
                           betweenness_sample=100, external_clustering=None,
                           threads=1, ref_db=out, output=out,
                           indiv_refine=None)
    timed("network_clusters_refs",
          lambda: make_network_and_refs(model, y, rlist, e.X, out, args))
    ref_clusters = read_clusters(os.path.join(out,
                                              "planted_dbscan_clusters.csv"))
    check_partition(ref_clusters, e.strain_of)

    def assign():
        dists, classes = pairwise_block(
            pq, pr, lq, lr, fq, fr, KLIST, ss64, bbits,
            post_spec=model_post_spec(model), device=device)
        G, old_clusters = fetch_network(out, model, rlist)
        G, _ = add_query_to_network(rlist, qlist, G, classes.reshape(-1),
                                    model, out, kmers=list(KLIST))
        clusters, _ = print_clusters(G, rlist + qlist,
                                     os.path.join(out, "queries"),
                                     old_clusters, print_ref=False)
        return dists, {q: str(clusters[q]) for q in qlist}

    n0 = mc.LAUNCHES
    with RecordPosts("dbscan") as posts:
        q_dists, q_clusters = timed("fused_query_assign", assign)
    launches["fused_query_assign"] = mc.LAUNCHES - n0
    if posts.devices != {device.type}:
        raise AssertionError(f"the dbscan post ran on {posts.devices}")
    if not np.array_equal(q_dists, e.q_dists):
        raise AssertionError("DBSCAN-post query distances differ from "
                             "phase E's")
    check_queries(q_clusters, ref_clusters, e.strain_of)

    # lineage: ranks 1-3 at depth 30 (SEARCH_DEPTH_FACTOR x the top rank),
    # extended with the queries; their query-query distances on the card
    def lineage():
        fit = LineageFit(os.path.join(workdir, "planted_lineage"), [1, 2, 3],
                         30, False, False, 1e-10, dist_col=0)
        fit.fit(e.X)
        qq = condensed_self_block(pq, lq, fq, KLIST, ss64, bbits,
                                  device=device)
        fit.extend(qq, q_dists.reshape(-1, 2))
        return fit

    n0 = mc.LAUNCHES
    lineage_fit = timed("lineage_fit_extend", lineage)
    launches["lineage_fit_extend"] = mc.LAUNCHES - n0
    edges = np.asarray(lineage_fit.assign(1), dtype=np.int64).reshape(-1, 2)
    labels, _ = connected_components(Graph(len(e.names), edges))
    check_pure(dict(zip(e.names, labels.tolist())), e.strain_of,
               "rank-1 lineages")
    peak = torch.cuda.max_memory_allocated() if on_card else None

    # the card's Boruvka against the same function on the CPU and the host
    # Prim oracle, on points of the fit's subsample above the 4096 gate
    sub = model.subsampled_X[:check_points].astype(np.float64)
    core, _ = hdbscan.core_distances(sub, boruvka.steps[0][0])
    x32, core32 = sub.astype(np.float32), core.astype(np.float32)
    weights = {}
    for name, fn in (
            ("card", lambda: hdbscan.boruvka_mst_device(x32, core32,
                                                        device=device)),
            ("cpu", lambda: hdbscan.boruvka_mst_device(
                x32, core32, device=torch.device("cpu"))),
            ("prim", lambda: hdbscan.prim_mst(sub, core))):
        weights[name] = np.sort(timed(f"boruvka_check_{name}", fn)[:, 2])
    cpu_err = float(np.abs(weights["card"] - weights["cpu"]).max())
    prim_err = float(np.abs(weights["card"] - weights["prim"]).max())
    if cpu_err > BORUVKA_ATOL or prim_err > PRIM_ATOL:
        raise AssertionError(f"Boruvka on {check_points} points: card vs "
                             f"CPU {cpu_err}, card vs Prim {prim_err}")

    emit({"phase": "I", "references": n, "queries": len(qlist),
          "pairs_all_vs_all": int(e.X.shape[0]),
          "subsample": int(model.subsampled_X.shape[0]),
          "cascade_steps": boruvka.steps, "boruvka_msts": boruvka.msts,
          "clusters": int(model.n_clusters),
          "within_label": int(model.within_label),
          "between_label": int(model.between_label),
          "within_pairs": int((np.asarray(y) == model.within_label).sum()),
          "grid_agreement": float(np.mean(y_grid == y)),
          "boruvka_check": {"points": int(sub.shape[0]),
                            "card_vs_cpu_max_abs": cpu_err,
                            "card_vs_prim_max_abs": prim_err},
          "rank1_lineages": int(len(set(labels.tolist()))),
          "stages": stages, "launches": launches,
          "peak_device_bytes": peak, "seconds": time.perf_counter() - t0})
    return launches


# --------------------------------------------------------------------------
# J: the resident serving session and the web flow
# --------------------------------------------------------------------------

def unpack_sketches(planes, lengths, freqs, names, klist=KLIST, chunk=512):
    """Sketch objects whose packed planes (ops/distances.pack_planes) are
    ``planes``: the inverse of pack_planes, word w of plane p at index
    w * bbits + p."""
    from poppunk_tpu_torch.sketch.minhash import Sketch

    n, _, bbits, _ = planes.shape
    ss64 = PRODUCTION[0]
    out = []
    for start in range(0, n, chunk):
        block = planes[start:start + chunk, :, :, :2 * ss64]
        u = (block[..., 0::2].astype(np.uint64)
             | (block[..., 1::2].astype(np.uint64) << np.uint64(32)))
        u = np.ascontiguousarray(u.transpose(0, 1, 3, 2))  # [c, K, ss64, P]
        for i in range(u.shape[0]):
            g = start + i
            out.append(Sketch(
                name=names[g], sketchsize64=ss64, bbits=bbits,
                usigs={int(k): u[i, ki].reshape(-1)
                       for ki, k in enumerate(klist)},
                length=int(lengths[g]), missing_bases=0,
                base_freq=freqs[g].astype(np.float64)))
    return out


def write_served_db(workdir, e):
    """Phase E's population as an on-disk reference database with the
    port's writers: the 8192 reference sketches, ``.dists`` with phase E's
    X, and phase E's BGMM fit, clusters, references and network. Returns
    (database prefix, query sketches)."""
    from poppunk_tpu_torch.io.hdf5db import write_sketches
    from poppunk_tpu_torch.ops.distances import pack_planes
    from poppunk_tpu_torch.utils import store_pickle

    n = e.n_ref
    sketches = unpack_sketches(e.planes, e.lengths, e.freqs, e.names)
    planes, lengths, freqs = pack_planes(sketches[:64], KLIST)
    if not (np.array_equal(planes, e.planes[:64])
            and np.array_equal(lengths, e.lengths[:64])
            and np.array_equal(freqs, e.freqs[:64])):
        raise AssertionError("unpacked sketches do not pack to the planes")
    db = os.path.join(workdir, "served")
    write_sketches(db, sketches[:n])
    base = os.path.join(db, "served")
    store_pickle(e.names[:n], e.names[:n], True, e.X, base + ".dists")
    e.model.copy(db)
    planted = os.path.join(workdir, "planted", "planted")
    for ext in ("_clusters.csv", ".refs", "_graph.graph.npz"):
        shutil.copyfile(planted + ext, base + ext)
    return db, sketches[n:]


def percentile(values, q):
    return float(np.percentile(np.asarray(values), q))


def serve_requests(torch, session, sketches, per_request=16):
    """The session's timings: one request of every query, then requests of
    ``per_request`` queries each. Returns (answers of the one request,
    {seconds / latencies})."""
    t = time.perf_counter()
    answers = session.assign_sketches(sketches)
    one = time.perf_counter() - t
    lat, small = [], {}
    for start in range(0, len(sketches), per_request):
        t = time.perf_counter()
        small.update(session.assign_sketches(
            sketches[start:start + per_request]))
        lat.append(time.perf_counter() - t)
    if small != answers:
        raise AssertionError("small requests answer otherwise than one "
                             "request of every query")
    return answers, {"one_request_s": one,
                     "one_request_queries_per_s": len(sketches) / one,
                     "requests": len(lat), "queries_per_request": per_request,
                     "p50_s": percentile(lat, 50), "p99_s": percentile(lat, 99),
                     "queries_per_s": len(sketches) / sum(lat)}


def phase_j(torch, device, workdir, d, e):
    """The serving session: at phase D's size against the --stable CLI for
    the BGMM (D), refine (F) and DBSCAN (H) fits on core and accessory,
    the geometry refusal and the API flow; then at phase E's full width,
    against the .refs subset and the full network (8192 resident
    references), held to a host oracle from phase E's distances. Returns
    standard launches per stage."""
    import contextlib
    import io

    from poppunk_tpu_torch import web
    from poppunk_tpu_torch.cli.assign import main as assign_main
    from poppunk_tpu_torch.io.hdf5db import read_sketches
    from poppunk_tpu_torch.ops import fused_assign
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.serve import AssignSession
    from poppunk_tpu_torch.sketch.minhash import Sketch

    t0 = time.perf_counter()
    stages, launches = {}, {}
    path = lambda name: os.path.join(workdir, name)  # noqa: E731

    def counted(stage, fn):
        t = time.perf_counter()
        n0 = mc.LAUNCHES
        out = fn()
        stages[stage] = elapsed(torch, t)
        launches[stage] = mc.LAUNCHES - n0
        return out

    # phase D's size: the session gives the --stable CLI's answers
    fits = {"bgmm": d.db, "refine": path("refined"), "dbscan": path("dbscan")}
    ref_clusters = read_clusters(os.path.join(d.db, "db_clusters.csv"))
    fit_clusters = {m: read_clusters(os.path.join(
        fit, os.path.basename(fit) + "_clusters.csv"))
        for m, fit in fits.items()}

    def small_sessions():
        for model, fit in fits.items():
            for stable in ("core", "accessory"):
                out = path(f"stable_{model}_{stable}")
                assign_main(["--db", d.db, "--model-dir", fit, "--query",
                             d.qfile, "--output", out, "--stable", stable])
                cli = read_clusters(os.path.join(
                    out, os.path.basename(out) + "_clusters.csv"))
                session = AssignSession(d.db, model_dir=fit, stable=stable)
                got = session.assign_files(d.qfile)
                if got != cli:
                    raise AssertionError(f"{model} {stable}: session {got}, "
                                         f"--stable CLI {cli}")
                check_queries(got, fit_clusters[model], d.strain_of)
        return session

    session = counted("stable_sessions_vs_cli", small_sessions)
    ss = session.ss64 // 2
    wrong = Sketch(name="q0", usigs={k: np.zeros(ss * session.bbits,
                                                 np.uint64)
                                     for k in session.kmers},
                   sketchsize64=ss, bbits=session.bbits, length=2_000_000,
                   missing_bases=0, base_freq=(0.25, 0.25, 0.25, 0.25))
    try:
        session.assign_sketches([wrong])
    except ValueError as refused:
        if "geometry" not in str(refused):
            raise
    else:
        raise AssertionError("a query of the wrong geometry was served")

    # the web flow: phase D's queries as JSON sketches
    sketch_files = []
    for sk in read_sketches(path("assigned"), d.queries):
        sketch_files.append(path(f"{sk.name}.json"))
        with open(sketch_files[-1], "w") as f:
            json.dump(web.sketch_to_json(sk), f)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        response = counted("api", lambda: web.main(
            ["--sketch", *sketch_files, "--ref-db", d.db, "--output",
             path("api")]))
    if json.loads(printed.getvalue()) != response:
        raise AssertionError("the API printed another response")
    check_queries({q["name"]: q["cluster"] for q in response["queries"]},
                  ref_clusters, d.strain_of)

    # full width: phase E's database on disk, 1024 queries served
    db, q_sketches = timed_stage(torch, stages, "write_database",
                                 lambda: write_served_db(workdir, e))
    n = e.n_ref
    rlist = e.names[:n]
    planted = read_clusters(os.path.join(db, "served_clusters.csv"))
    served = {}
    for mode, full in (("refs", False), ("full_network", True)):
        t = time.perf_counter()
        n0 = mc.LAUNCHES
        session = AssignSession(db, use_full_network=full, device=device)
        timing = {"construct_s": elapsed(torch, t),
                  "references": len(session.r_names)}
        t = time.perf_counter()
        timing["warmup_buckets"] = session.warmup()
        timing["warmup_s"] = elapsed(torch, t)
        answers, requests = serve_requests(torch, session, q_sketches)
        launches[f"serve_{mode}"] = mc.LAUNCHES - n0
        check_queries(answers, planted, e.strain_of)
        served[mode] = {**timing, **requests}
        stages[f"serve_{mode}"] = elapsed(torch, t)
    if served["full_network"]["references"] != n:
        raise AssertionError(f"full network served "
                             f"{served['full_network']['references']}")

    # the host oracle on phase E's distances: first minimum on the core
    # column, the model's class of that pair, the reference's cluster
    nn = e.q_dists[..., 0].argmin(axis=1)
    nearest = e.q_dists[np.arange(len(nn)), nn]
    within = np.asarray(e.model.assign(nearest)) == e.model.within_label
    oracle = {sk.name: planted[rlist[r]] if w else "NA"
              for sk, r, w in zip(q_sketches, nn, within)}
    if answers != oracle:
        bad = {q: (answers[q], oracle[q]) for q in oracle
               if answers[q] != oracle[q]}
        raise AssertionError(f"full-network answers differ from the host "
                             f"oracle on {len(bad)} queries: "
                             f"{list(bad.items())[:5]}")

    # each *_stable post on the card against the same post on the CPU, on
    # 64 queries of phase E's distances
    tile = torch.as_tensor(e.q_dists[:64])
    posts = {}
    for dist_col in (0, 1):
        spec = fused_assign.stable_post_spec(e.model, dist_col)
        card = fused_assign.apply_post(
            tile.to(device), fused_assign.post_spec_on(spec, device)).cpu()
        cpu = fused_assign.apply_post(
            tile, fused_assign.post_spec_on(spec, torch.device("cpu")))
        if not torch.equal(card, cpu):
            raise AssertionError(f"{spec[0]} on the card differs from the "
                                 f"CPU (column {dist_col})")
        posts[f"{spec[0]}_col{dist_col}"] = int(card[:, 1].sum())

    emit({"phase": "J", "references": n, "queries": len(q_sketches),
          "served": served, "oracle_queries": len(oracle),
          "stable_post_within": posts, "api_queries": len(response["queries"]),
          "stages": stages, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches, SimpleNamespace(db=db)


def timed_stage(torch, stages, name, fn):
    t = time.perf_counter()
    out = fn()
    stages[name] = elapsed(torch, t)
    return out


# --------------------------------------------------------------------------
# K: visualise and the auxiliary tools
# --------------------------------------------------------------------------

class Timed:
    """Record (label, args, kwargs, seconds after a synchronise, result)
    of every call of some module functions; wrapped, not replaced.
    ``targets``: (module, attribute, label)."""

    def __init__(self, torch, targets):
        self.torch, self.targets = torch, targets
        self.calls = []

    def __enter__(self):
        self.saved = []
        for module, attr, label in self.targets:
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))
            setattr(module, attr, self._recorder(fn, label))
        return self

    def _recorder(self, fn, label):
        def record(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            self.calls.append((label, args, kwargs,
                               elapsed(self.torch, t), out))
            return out
        return record

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)

    def seconds(self):
        out = {}
        for label, _, _, s, _ in self.calls:
            out[label] = out.get(label, 0.0) + s
        return out


def patristic(tree, labels):
    """All-pairs leaf path lengths of a trees.Node tree (scipy Dijkstra;
    1e-12 added to every edge keeps zero-length branches as edges)."""
    import scipy.sparse
    import scipy.sparse.csgraph

    ids, rows, cols, weights, leaf = {}, [], [], [], {}
    stack = [(tree, None)]
    while stack:
        node, parent = stack.pop()
        ids[id(node)] = len(ids)
        if parent is not None:
            rows.append(ids[id(parent)])
            cols.append(ids[id(node)])
            weights.append((node.edge_length or 0.0) + 1e-12)
        if node.is_leaf():
            leaf[node.label] = ids[id(node)]
        stack.extend((c, node) for c in node.children)
    graph = scipy.sparse.coo_matrix((weights, (rows, cols)),
                                    shape=(len(ids), len(ids))).tocsr()
    order = [leaf[lab] for lab in labels]
    dist = scipy.sparse.csgraph.dijkstra(graph, directed=False,
                                         indices=order)
    return dist[:, order]


def centroid_separation(coords, strain_of):
    """The centroid test of tests/test_embedding.py for every pair of
    planted strains: min over pairs of |c_a - c_b| / max(r_a, r_b), r the
    mean distance of a strain's points to its centroid."""
    names = list(coords)
    xy = np.array([coords[n] for n in names])
    strains = np.array([strain_of[n] for n in names])
    uniq = np.unique(strains)
    cent = np.array([xy[strains == s].mean(0) for s in uniq])
    radius = np.array([np.linalg.norm(xy[strains == s] - c, axis=1).mean()
                       for s, c in zip(uniq, cent)])
    gap = np.linalg.norm(cent[:, None] - cent[None], axis=-1)
    spread = np.maximum(radius[:, None], radius[None])
    iu = np.triu_indices(len(uniq), 1)
    return float((gap[iu] / spread[iu]).min())


def read_dot(path):
    """{name: (x, y)} from a mandrake .dot."""
    with open(path) as f:
        text = f.read()
    coords = {}
    for part in text[len("graph G { "):].split("; "):
        if "[" in part:
            name, attrs = part.split("[", 1)
            x = float(attrs.split('x="')[1].split('"')[0])
            y = float(attrs.split('y="')[1].split('"')[0])
            coords[name.strip('"')] = (x, y)
    return coords


def condensed_rows(n, idx):
    """Rows of the condensed i<j vector over n points for the pairs of the
    sorted indices ``idx``, in their own condensed order."""
    i, j = np.triu_indices(len(idx), 1)
    a, b = idx[i].astype(np.int64), idx[j].astype(np.int64)
    return n * a - a * (a + 1) // 2 + b - a - 1


def phase_k(torch, device, workdir, d, e, served_db, nj_check=1024,
            subset=2048, dense_epochs=500):
    """Visualise and the tools on phase E's database (served_db, written
    by phase J): every export with NJ and the dense SCE at full width, a
    subset recalculated on the card, mandrake's dense and sampled
    branches, the card's NJ held to the host's and the CPU's; then the
    lineage, info and references CLIs on phase D's database. Returns
    standard launches per stage."""
    import contextlib
    import io

    from poppunk_tpu_torch import embedding, plotting, trees
    from poppunk_tpu_torch import visualise as vis
    from poppunk_tpu_torch.cli.info import main as info_main
    from poppunk_tpu_torch.cli.lineages import main as lineages_main
    from poppunk_tpu_torch.cli.mandrake import main as mandrake_main
    from poppunk_tpu_torch.cli.references import main as references_main
    from poppunk_tpu_torch.cli.visualise import main as visualise_main
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.ops import nj_device
    from poppunk_tpu_torch.pairs import condensed_to_square
    from poppunk_tpu_torch.utils import read_pickle, store_pickle

    t0 = time.perf_counter()
    stages, launches = {}, {}
    path = lambda name: os.path.join(workdir, name)  # noqa: E731
    n = e.n_ref
    rlist = e.names[:n]
    base = os.path.join(served_db, "served")
    targets = [(vis, "generate_nj_tree", "nj_tree"),
               (nj_device, "neighbor_joining_device", "nj_device"),
               (vis, "minimum_spanning_tree", "mst"),
               (vis, "mst_to_phylogeny", "mst_to_phylogeny"),
               (embedding, "generate_embedding", "embedding"),
               (vis, "query_db_sketches", "recalculated_distances")]
    targets += [(plotting, f"outputs_for_{tool}", f"export_{tool}")
                for tool in ("microreact", "phandango", "grapetree",
                             "cytoscape")]
    drawn = io.StringIO()

    # every export at full width: NJ on the card at 8192, the dense MST,
    # the dense SCE at 8192 (one epoch at the default --maxIter)
    out = path("viz")
    with Timed(torch, targets) as full, contextlib.redirect_stderr(drawn):
        timed_stage(torch, stages, "visualise_full", lambda: visualise_main([
            "--ref-db", served_db, "--output", out, "--microreact",
            "--phandango", "--grapetree", "--cytoscape", "--network-file",
            base + "_graph.graph.npz", "--tree", "both"]))
    sys.stderr.write(drawn.getvalue())
    nj_calls = [c for c in full.calls if c[0] == "nj_device"]
    # the reference's routing: the card's NJ from 512 genomes on the card
    if [(c[1][0].shape[0], str(c[1][2])) for c in nj_calls] != \
            ([(n, str(device))] if device.type == "cuda" else []):
        raise AssertionError(f"NJ at full width ran as "
                             f"{[(c[1][0].shape, c[1][2]) for c in nj_calls]}")
    failed = [line for line in drawn.getvalue().splitlines()
              if "failed" in line.lower()]
    if any(not line.startswith("MST drawing failed") for line in failed):
        raise AssertionError(f"visualise: {failed}")
    files = sorted(os.listdir(out))
    for name in ("viz_microreact_clusters.csv", "viz_core_NJ.nwk",
                 "viz_MST.nwk", "viz_core_MST.nwk", "viz_core_NJ.tree",
                 "viz_phandango_clusters.csv", "viz_grapetree_clusters.csv",
                 "viz_cytoscape.graphml", "viz_cytoscape.csv",
                 "viz_cytoscape_mst.graphml", "viz.microreact",
                 "viz_perplexity20.0_accessory_mandrake.dot"):
        if name not in files:
            raise AssertionError(f"visualise wrote no {name}: {files}")
    with open(os.path.join(out, "viz_core_NJ.nwk")) as f:
        nj_leaves = {leaf.label for leaf in leaves(trees.parse_newick(
            f.read()))}
    if nj_leaves != set(rlist):
        raise AssertionError("the NJ tree misses genomes")
    components = [f for f in files if f.startswith("viz_component_")]
    if len(components) != len(set(e.strain_of[r] for r in rlist)):
        raise AssertionError(f"{len(components)} cytoscape components")

    # a 2048-genome subset recalculated on the card
    sub_idx = np.arange(subset)
    sub_names = [rlist[i] for i in sub_idx]
    listing = path("subset.txt")
    with open(listing, "w") as f:
        f.write("\n".join(sub_names) + "\n")
    n0 = mc.LAUNCHES
    with Timed(torch, targets) as recalc:
        timed_stage(torch, stages, "visualise_subset_recalculated",
                    lambda: visualise_main([
                        "--ref-db", served_db, "--output", path("viz_sub"),
                        "--microreact", "--tree", "nj", "--include-files",
                        listing, "--recalculate-distances"]))
    launches["visualise_subset_recalculated"] = mc.LAUNCHES - n0
    ((_, (sketches, *_), _, _, X_sub), ) = [
        c for c in recalc.calls if c[0] == "recalculated_distances"]
    if [s.name for s in sketches] != sub_names:
        raise AssertionError("the recalculation took other genomes")
    np.testing.assert_allclose(X_sub, e.X[condensed_rows(n, sub_idx)],
                               **DIST_TOL)

    # mandrake: the dense branch at 8192 for dense_epochs epochs, then the
    # sampled branch (DENSE_LIMIT lowered) for as many. Every pair of the
    # planted strains must pass the centroid test in the dense embedding.
    # The sampled optimiser (the JAX package's design, ported as it is)
    # does not part dozens of equidistant strains pairwise, in either
    # package: its full-width minimum is recorded, and it is held to the
    # centroid test as tests/test_embedding.py holds it, on two strains
    # (their 2 x n / n_strains genomes, with its limit lowered below that)
    # at that test's kNN of 10, for the epoch cap of 1000
    strains = sorted(set(e.strain_of[r] for r in rlist))
    two = [i for i, r in enumerate(rlist) if e.strain_of[r] in strains[:2]]
    two_dists = path("two_strains")
    store_pickle([rlist[i] for i in two], [rlist[i] for i in two], True,
                 e.X[condensed_rows(n, np.asarray(two))], two_dists)
    separation = {}
    for branch, dists, m, limit, knn, epochs in (
            ("dense", base + ".dists", n, embedding.DENSE_LIMIT, 50,
             dense_epochs),
            ("sampled", base + ".dists", n, n // 2, 50, dense_epochs),
            ("sampled_two_strains", two_dists, len(two), len(two) // 2, 10,
             1000)):
        saved, embedding.DENSE_LIMIT = embedding.DENSE_LIMIT, limit
        try:
            mandrake_out = path(f"mandrake_{branch}")
            timed_stage(torch, stages, f"mandrake_{branch}",
                        lambda: mandrake_main([
                            "--distances", dists, "--output", mandrake_out,
                            "--knn", str(knn), "--iter",
                            str(epochs * m * knn)]))
        finally:
            embedding.DENSE_LIMIT = saved
        (dot,) = os.listdir(mandrake_out)
        coords = read_dot(os.path.join(mandrake_out, dot))
        if list(coords) != read_pickle(dists, distances=False)[0] or \
                not np.isfinite(np.array(list(coords.values()))).all():
            raise AssertionError(f"mandrake {branch}: bad embedding")
        separation[branch] = centroid_separation(coords, e.strain_of)
        if branch != "sampled" and separation[branch] <= 1.5:
            raise AssertionError(f"mandrake {branch}: strains not separated "
                                 f"({separation[branch]})")

    # each SCE optimiser on the card against the CPU, 5 epochs from the
    # same initial embedding (and negatives): float32 sums in other
    # orders, index_add_ unordered on the card
    sce = sce_card_vs_cpu(torch, device, e, sub_idx)

    # the card's NJ on a 1024-genome subset against the host float64 NJ
    # and the CPU torch run, by patristic distances
    idx = np.arange(nj_check)
    labels = [rlist[i] for i in idx]
    core = condensed_to_square(e.X[condensed_rows(n, idx), 0], nj_check)
    trees_ = {
        "card": timed_stage(torch, stages, f"nj_card_{nj_check}",
                            lambda: nj_device.neighbor_joining_device(
                                core, labels, device)),
        "cpu": timed_stage(torch, stages, f"nj_cpu_torch_{nj_check}",
                           lambda: nj_device.neighbor_joining_device(
                               core, labels, torch.device("cpu"))),
        "host": timed_stage(torch, stages, f"nj_host_{nj_check}",
                            lambda: trees.neighbor_joining(
                                core.astype(np.float64), labels))}
    pat = {k: patristic(t, labels) for k, t in trees_.items()}
    nj_err = {}
    for other in ("cpu", "host"):
        np.testing.assert_allclose(pat["card"], pat[other], rtol=1e-4,
                                   atol=1e-6)
        nj_err[other] = float((np.abs(pat["card"] - pat[other])
                               / np.maximum(pat[other], 1e-12)).max())

    # the tools on phase D's database
    lineage_dir = path("lineages")
    os.makedirs(lineage_dir)
    cwd = os.getcwd()
    os.chdir(lineage_dir)  # strain databases are written relative to it
    try:
        n0 = mc.LAUNCHES
        timed_stage(torch, stages, "lineages_create", lambda: lineages_main([
            "--create-db", d.db, "--db-scheme", "scheme.pkl", "--output",
            "create", "--ranks", "1,2", "--min-count", "2"]))
        timed_stage(torch, stages, "lineages_query", lambda: lineages_main([
            "--query-db", d.qfile, "--db-scheme", "scheme.pkl", "--output",
            "query"]))
        launches["lineages"] = mc.LAUNCHES - n0
    finally:
        os.chdir(cwd)
    ref_clusters = read_clusters(os.path.join(d.db, "db_clusters.csv"))
    for name, members in (("create", d.refs), ("query", d.queries)):
        with open(os.path.join(lineage_dir, name + ".csv")) as f:
            rows = list(csv.reader(f))
        if rows[0][:2] != ["id", "Cluster"] or \
                sorted(r[0] for r in rows[1:]) != sorted(members):
            raise AssertionError(f"lineages {name}: {rows[:3]}")
        check_queries({r[0]: r[1] for r in rows[1:]}, ref_clusters,
                      d.strain_of)
        check_pure({r[0]: (r[1], r[2]) for r in rows[1:]}, d.strain_of,
                   f"lineages {name} rank 1")

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        timed_stage(torch, stages, "info",
                    lambda: info_main(["--db", d.db]))
    if f"Number of samples:\t\t{len(d.refs)}" not in printed.getvalue():
        raise AssertionError(f"info printed {printed.getvalue()[:500]}")
    refs_out = path("references")
    timed_stage(torch, stages, "references", lambda: references_main([
        "--network", os.path.join(d.db, "db_graph.graph.npz"), "--distances",
        os.path.join(d.db, "db.dists"), "--ref-db", d.db, "--output",
        refs_out]))
    with open(os.path.join(refs_out, "references.refs")) as f:
        picked = f.read().split()
    if {d.strain_of[r] for r in picked} != {d.strain_of[r] for r in d.refs}:
        raise AssertionError(f"references picked {picked}")

    emit({"phase": "K", "references": n, "subset": len(sub_idx),
          "full_width_seconds": full.seconds(),
          "subset_seconds": recalc.seconds(),
          "mst_drawing": [line for line in failed],
          "mandrake_epochs": dense_epochs,
          "mandrake_separation": separation, "sce_card_vs_cpu": sce,
          "nj_check": {"genomes": nj_check,
                       "card_vs_other_max_rel": nj_err},
          "references_picked": len(picked),
          "stages": stages, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches


def leaves(node):
    stack, out = [node], []
    while stack:
        x = stack.pop()
        if x.is_leaf():
            out.append(x)
        stack.extend(x.children)
    return out


def sce_card_vs_cpu(torch, device, e, idx, epochs=5, knn=50):
    """Both SCE optimisers on the card and on the CPU from the same
    initial embedding (and, sampled, the same negatives) on the accessory
    kNN of ``idx``'s genomes: the largest difference over max |Y|."""
    from poppunk_tpu_torch import embedding
    from poppunk_tpu_torch.ops.sparse_knn import knn_from_condensed

    m = len(idx)
    I, J, dists = knn_from_condensed(e.X[condensed_rows(e.n_ref, idx), 1],
                                     m, knn)
    P = embedding._perplexity_probabilities(
        np.asarray(dists).reshape(m, knn), 30.0).reshape(-1)
    gen = torch.Generator().manual_seed(SEED)
    Y0 = torch.randn((m, 2), generator=gen) * 1e-2
    neg = torch.randint(0, m, (epochs, len(I), 5), generator=gen)
    Pmat = np.zeros((m, m), dtype=np.float32)
    Pmat[np.asarray(I), np.asarray(J)] += P
    Pmat[np.asarray(J), np.asarray(I)] += P
    out = {}
    for branch in ("dense", "sampled"):
        ys = {}
        for dev in (device, torch.device("cpu")):
            if branch == "dense":
                y = embedding._sce_optimize_dense(
                    None, torch.from_numpy(Pmat).to(dev), m, epochs,
                    Y0=Y0.to(dev))
            else:
                as_t = lambda a, dt: torch.as_tensor(  # noqa: E731
                    np.asarray(a), dtype=dt, device=dev)
                y = embedding._sce_optimize_sampled(
                    None, as_t(I, torch.int64), as_t(J, torch.int64),
                    as_t(P, torch.float32), m, epochs, Y0=Y0.to(dev),
                    negatives=neg.to(dev))
            ys[dev.type] = y.cpu().numpy()
        scale = np.abs(ys["cpu"]).max()
        err = float(np.abs(ys[device.type] - ys["cpu"]).max() / scale)
        if err > SCE_ATOL:
            raise AssertionError(f"SCE {branch}: card vs CPU {err}")
        out[branch] = err
    return out


# --------------------------------------------------------------------------
# L: the streaming scale tier
# --------------------------------------------------------------------------

def phase_l0(torch, device):
    """The standard kernel's plane-major route against the plain version
    (bit for bit) and against the contiguous route, at phase C's shapes:
    the queries a row-slice view of a resident [K, P, n, Wp] reference
    tensor, against the whole tensor and, as the scale tier's owned tiles
    read it, against a column view that starts at the queries' first row.
    Timed at BENCH, route against route in one window, with
    CUDA events beside the SM clock and the bound. These launches compare;
    no path counts them. L2 and L3 hold the route to the plain version
    again at the streaming pass's own operands (hold_steps_to_plain)."""
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.ops.distances import (plane_geometry,
                                                 planes_to_tensor)

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 7)
    cases = [(3, 5, SMALL), (64, 128, SMALL), (65, 129, SMALL),
             (257, 1031, PRODUCTION), (65, 129, ODD), (2048, 4096, BENCH)]
    results, worst, timing = [], 0, {}
    for nq, nr, geometry in cases:
        pad_bits = plane_geometry(geometry[0], geometry[1])[2]
        # resident plane-major reference; the queries start one row in
        resident = planes_to_tensor(
            random_planes(rng, nr, geometry).transpose(1, 2, 0, 3), device)
        view = resident[:, :, 1:1 + nq]
        errs = {}
        for name, r in (("view", resident), ("owned", resident[:, :, 1:])):
            got = mc.match_counts(view, r, pad_bits, plane_major=True)
            plain = mc.match_counts_torch(view, r, pad_bits,
                                          plane_major=True)
            contiguous = mc.match_counts(
                view.permute(2, 0, 1, 3).contiguous(),
                r.permute(2, 0, 1, 3).contiguous(), pad_bits)
            torch.cuda.synchronize()
            errs[name] = max(max_abs_err(got, plain),
                             max_abs_err(got, contiguous))
        worst = max(worst, *errs.values())
        results.append({"nq": nq, "nr": nr, "ss64": geometry[0],
                        "bbits": geometry[1], "K": geometry[2],
                        "max_abs_err": errs})
        if geometry is BENCH:
            w32 = plane_geometry(geometry[0], geometry[1])[0]
            q_c = view.permute(2, 0, 1, 3).contiguous()
            r_c = resident.permute(2, 0, 1, 3).contiguous()
            routes = {"plane_major": (view, resident, True),
                      "contiguous": (q_c, r_c, False)}
            for route, (q, r, pm) in routes.items():
                mc.match_counts(q, r, pad_bits, plane_major=pm)  # warm
                ms, sm_mhz, samples = timed_at_sm_clock(
                    lambda: mc.match_counts(q, r, pad_bits,
                                            plane_major=pm), 60)
                in_bytes = (q.numel() + r.numel()) * 4
                bound_ms, bound_by = bound(nq, nr, geometry[2], geometry[1],
                                           w32, in_bytes, sm_mhz)
                timing[route] = dict(ms=ms, sm_clock_mhz=sm_mhz,
                                     sm_clock_samples=samples,
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     bound_share=bound_ms / ms)
            timing["plane_major"]["plain_ms"] = event_ms(
                lambda: mc.match_counts_torch(
                    view, resident, pad_bits, plane_major=True), 1)
            del q_c, r_c
        del resident, view
    emit({"phase": "L0", "cases": results, "timing": timing,
          "seconds": elapsed(torch, t0)})
    if worst:
        raise AssertionError(f"the plane-major route disagrees: {results}")
    return worst, timing


def planted_population_on_card(torch, device, n, n_strains, seed,
                               ss64=156, bbits=14, klist=KLIST,
                               within=(0.01, 0.001), between=(0.15, 0.01),
                               chunk=2048):
    """planted_population's model, drawn on the card from a seeded
    torch.Generator straight into the plane-major [K, P, n, Wp] layout the
    scale tier keeps resident (set-up, not the system). Genome i belongs
    to strain i % n_strains. Returns (planes int32, lengths int32,
    freqs float32) on the card and the strain labels."""
    from poppunk_tpu_torch.ops.distances import plane_geometry

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    k = np.asarray(klist, np.float64)
    pr_w = (1 - within[0]) * (1 - within[1]) ** k
    pr_b = (1 - between[0]) * (1 - between[1]) ** k
    s = torch.tensor(np.sqrt(pr_w), dtype=torch.float32,
                     device=device)[:, None]
    t = torch.tensor(np.sqrt(pr_b / pr_w), dtype=torch.float32,
                     device=device)[:, None]
    nbins, K = ss64 * 64, len(klist)
    w32, wp, _ = plane_geometry(ss64, bbits)
    top = 1 << bbits

    def rand_bins(*shape):
        return torch.randint(0, top, shape, generator=gen, device=device,
                             dtype=torch.int32)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    ancestor = rand_bins(K, nbins)
    roots = torch.where(rand(n_strains, K, nbins) < t, ancestor,
                        rand_bins(n_strains, K, nbins))
    strains = torch.arange(n, device=device) % n_strains
    planes = torch.zeros((K, bbits, n, wp), dtype=torch.int32, device=device)
    shifts = torch.arange(32, dtype=torch.int64, device=device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        c = stop - start
        vals = torch.where(rand(c, K, nbins) < s, roots[strains[start:stop]],
                           rand_bins(c, K, nbins))
        for p in range(bbits):
            bits = ((vals >> p) & 1).to(torch.int64).view(c, K, w32, 32)
            words = (bits << shifts).sum(dim=-1)
            words = torch.where(words >= 2**31, words - 2**32, words)
            planes[:, p, start:stop, :w32] = words.to(torch.int32).permute(
                1, 0, 2)
    lengths = torch.randint(1_800_000, 2_200_000, (n,), generator=gen,
                            device=device, dtype=torch.int32)
    freqs = torch.tensor([0.3, 0.2, 0.2, 0.3], device=device) \
        + 0.01 * torch.randn((n, 4), generator=gen, device=device)
    freqs = freqs / freqs.sum(dim=1, keepdim=True)
    return planes, lengths, freqs.float(), strains.cpu().numpy()


class RecordLaunchTimes:
    """CUDA event time of every standard-kernel launch while open
    (ops/match_counts.py::match_counts, wrapped, not replaced)."""

    def __init__(self, torch):
        self.torch, self.events = torch, []

    def __enter__(self):
        from poppunk_tpu_torch.ops import match_counts as mc

        self.module, self.saved = mc, mc.match_counts

        def timed(*args, **kwargs):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.saved(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out
        mc.match_counts = timed
        return self

    def __exit__(self, *exc):
        self.module.match_counts = self.saved

    def seconds(self):
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3


def hold_steps_to_plain(torch, cd):
    """The plane-major route at the operands the streaming pass gives it
    (scale._fold_block), bit for bit against the plain version on the same
    device: the owned tiles of the first step (rows [0, c) against every
    genome, the mirror rows [n-c, n) against the columns [n-c, n)) and of
    a middle step s (rows [s, s+c) against the columns [s, n), the mirror
    rows [n-s-c, n-s) against [n-s-c, n)), each a row-slice view of the
    resident [K, P, n, Wp] tensor against a column view of it at the
    tile's row offset. At the middle step's low tile the epilogue kernel
    too (hold_tile_epilogue), as the tile computes it (scale._tile_dists)
    and as the kNN computes it again on the transposed counts, the column
    genomes as the queries (scale._merge_knn). These launches compare; no
    path counts them. Returns {operand: max_abs_err} and the plain
    version's seconds."""
    from poppunk_tpu_torch import scale
    from poppunk_tpu_torch.ops import match_counts as mc

    planes, c = cd.planes, cd.chunk
    n = planes.shape[2]
    mid = scale.fold_rows(n) // c // 2 * c  # a middle step's first row
    tiles = {f"{side}_step_{s}": r0 for s in (0, mid)
             for side, r0 in (("low", s), ("mirror", n - s - c))}
    errs, plain_s = {}, 0.0
    for name, r0 in tiles.items():
        rows, cols = slice(r0, r0 + c), slice(r0, None)
        q, k = planes[:, :, rows], planes[:, :, cols]
        got = mc.match_counts(q, k, cd._pad_bits, plane_major=True)
        t = time.perf_counter()
        want = mc.match_counts_torch(q, k, cd._pad_bits, plane_major=True)
        plain_s += elapsed(torch, t)
        errs[name] = max_abs_err(got, want)
        if name == f"low_step_{mid}" and not errs[name]:
            ln, fr = cd.lengths, cd.freqs
            ops = (cd._klist, cd._ss64, cd._bbits)
            hold_tile_epilogue(
                torch, f"owned tile {name} at n {n}",
                lambda: scale._tile_dists(q, k, ln[rows], ln[cols], fr[rows],
                                          fr[cols], *ops, cd._pad_bits),
                ln[rows], ln[cols], fr[rows], fr[cols], *ops, got, want)
            got_t = got.transpose(0, 1).contiguous()
            hold_tile_epilogue(
                torch, f"transposed tile {name} at n {n}",
                lambda: scale._epilogue(got_t, cd._klist, ln[cols], ln[rows],
                                        fr[cols], fr[rows], cd._ss64,
                                        cd._bbits),
                ln[cols], ln[rows], fr[cols], fr[rows], *ops, got_t,
                want.transpose(0, 1).contiguous())
            del got_t
        del got, want
    if any(errs.values()):
        raise AssertionError(f"the plane-major route disagrees with the "
                             f"plain version at n {n}, c {c}: {errs}")
    return errs, plain_s


def streaming_fit(torch, device, workdir, planes, lengths, freqs, names,
                  knn, ranks=None, summary_sample=None):
    """The scale CLI's default path as library calls, on planes already
    plane-major (numpy, or int32 on the card): the deferred
    StreamingCondensed, the recomputed model subsample (100,000 pairs),
    the BGMM start on the card, plan_sweep_band, pass 1 with the band fill
    fused, refine_fit_device from the prefill, the network and clusters
    (cli/scale.py's helpers), and with ``ranks`` the lineage fit from the
    fused kNN. Returns (clusters, a record of the run)."""
    from poppunk_tpu_torch.cli.scale import (_network_and_clusters,
                                             _write_lineages)
    from poppunk_tpu_torch.models import BGMMFit
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.scale import (StreamingCondensed,
                                         plan_sweep_band, refine_fit_device)

    ss64, bbits = PRODUCTION[:2]
    n = len(names)
    stages, peaks = {}, {}
    on_card = device.type == "cuda"

    def timed(name, fn):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        stages[name] = elapsed(torch, t)
        if on_card:
            peaks[name] = torch.cuda.max_memory_allocated()
        return out

    chunk = card_chunk(device, n, 256, len(KLIST))
    cd = StreamingCondensed(planes, lengths, freqs, KLIST, ss64, bbits,
                            chunk=chunk, knn=knn, defer=True, device=device)
    subsample = min(100000, cd.n_pairs)
    sub = timed("subsample", lambda: cd.subsample_pairs(subsample,
                                                        seed=SEED))
    start = BGMMFit("", max_samples=subsample, seed=SEED, device=device)
    timed("start_fit", lambda: start.fit(sub, max_components=2))
    mean0 = start.means[start.within_label]
    mean1 = start.means[start.between_label]
    spec = timed("plan", lambda: plan_sweep_band(
        cd, start.scale, mean0, mean1, max_move=0.0, min_move=0.0,
        est_pairs=sub))
    if spec is None:
        raise AssertionError("plan_sweep_band planned no bootstrap band")
    n0 = mc.LAUNCHES
    if device.type == "cuda":
        with RecordLaunchTimes(torch) as kernel:
            timed("pass1", lambda: cd.run_pass1(spec))
            kernel_s = kernel.seconds()
    else:  # the CPU rehearsal: the plain twin runs, nothing to time
        timed("pass1", lambda: cd.run_pass1(spec))
        kernel_s = 0.0
    pass1_launches = mc.LAUNCHES - n0
    prefill = cd.pop_prefill()
    if prefill is None:
        raise AssertionError("the bootstrap band overflowed its buffer")
    band = prefill[0].count
    sweep_t = {}
    x, y, s_opt, sweep = timed("refine", lambda: refine_fit_device(
        cd, start.scale, mean0, mean1, max_move=0.0, min_move=0.0,
        est_pairs=sub, prefill=prefill, timings_out=sweep_t))
    del prefill
    if sweep[0] != "edges":
        raise AssertionError(f"refine took the {sweep[0]} path")
    out = os.path.join(workdir, f"stream{n}")
    os.makedirs(out, exist_ok=True)
    args = network_args(summary_sample)
    G, clusters = timed("network_clusters", lambda: _network_and_clusters(
        cd, sweep, s_opt, names, out, args))
    lineages = None
    if ranks:
        timed("lineage_fit", lambda: _write_lineages(cd, ranks, names, out,
                                                      args))
        lineages = read_lineages(os.path.join(
            out, f"stream{n}_lineages.csv"))
    return clusters, SimpleNamespace(
        cd=cd, stages=stages, peaks=peaks, spec=spec, band_edges=band,
        start=(start.scale, mean0, mean1), s_opt=s_opt,
        boundary=[float(x), float(y)], network_edges=int(G.n_edges),
        sweep=sweep_t, chunk=chunk, pass1_launches=pass1_launches,
        pass1_kernel_s=kernel_s, lineages=lineages)


def network_args(summary_sample=None):
    """The CLI options cli/scale.py's network and lineage helpers read."""
    return SimpleNamespace(summary_sample=summary_sample,
                           betweenness_sample=100, external_clustering=None,
                           use_accessory=False, reciprocal_only=False,
                           count_unique_distances=False)


def phase_l(torch, device, workdir, d, e):
    """L1-L3: the scale CLI on phase D's database, phase E's population
    through StreamingCondensed, and the full-width streaming fit. Returns
    standard launches per stage, and L2's and L3's records for L4 (L3's
    planes stay resident on the card)."""
    launches = {}
    launches.update(phase_l1(torch, device, workdir, d))
    l2_launches, l2 = phase_l2(torch, device, workdir, e)
    launches.update(l2_launches)
    l3_launches, l3 = phase_l3(torch, device, workdir)
    launches.update(l3_launches)
    return launches, SimpleNamespace(l2=l2, l3=l3)


def phase_l1(torch, device, workdir, d):
    """poppunk_tpu_torch_scale on phase D's database (the card by
    default): the BGMM start with --write-lineages --ranks 1,2 (bootstrap,
    and again with POPPUNK_TPU_BOOTSTRAP=0: the same files), the DBSCAN
    start, --indiv-refine both; every cluster file strain-pure; then
    poppunk_tpu_torch_assign places phase D's queries with the BGMM fit."""
    from poppunk_tpu_torch.cli.assign import main as assign_main
    from poppunk_tpu_torch.cli.scale import main as scale_main
    from poppunk_tpu_torch.ops import match_counts as mc

    t0 = time.perf_counter()
    stages, launches = {}, {}
    path = lambda name: os.path.join(workdir, name)  # noqa: E731
    files = lambda out, ext: os.path.join(  # noqa: E731
        out, os.path.basename(out) + ext)

    def run(stage, fn, argv):
        t = time.perf_counter()
        n0 = mc.LAUNCHES
        fn(argv)
        stages[stage] = elapsed(torch, t)
        launches["L1_" + stage] = mc.LAUNCHES - n0

    fits = {"bgmm": ["--write-lineages", "--ranks", "1,2"],
            "dbscan": ["--fit-model", "dbscan"],
            "indiv": ["--indiv-refine", "both"]}
    for fit, flags in fits.items():
        run(f"scale_{fit}", scale_main, ["--ref-db", d.db, "--output",
                                         path(f"scale_{fit}"), "--no-plot"]
            + flags)
    os.environ["POPPUNK_TPU_BOOTSTRAP"] = "0"
    try:
        run("scale_bgmm_plain", scale_main,
            ["--ref-db", d.db, "--output", path("scale_bgmm_plain"),
             "--no-plot"] + fits["bgmm"])
    finally:
        del os.environ["POPPUNK_TPU_BOOTSTRAP"]
    counts = {}
    for fit in fits:
        exts = ("", "_core", "_accessory") if fit == "indiv" else ("",)
        for ext in exts:
            clusters = read_clusters(files(path(f"scale_{fit}"),
                                           f"{ext}_clusters.csv"))
            if set(clusters) != set(d.refs):
                raise AssertionError(f"scale {fit}{ext}: clusters miss "
                                     "samples")
            check_pure(clusters, d.strain_of, f"scale {fit}{ext}")
            counts[fit + ext] = len(set(clusters.values()))
    header, rows = read_lineages(files(path("scale_bgmm"), "_lineages.csv"))
    check_pure({n: row[1] for n, row in rows.items()}, d.strain_of,
               "scale rank-1 lineages")
    for ext in ("_clusters.csv", "_lineages.csv"):
        with open(files(path("scale_bgmm"), ext)) as a, \
                open(files(path("scale_bgmm_plain"), ext)) as b:
            if a.read() != b.read():
                raise AssertionError(f"bootstrap and plain pass differ in "
                                     f"{ext}")
    run("assign", assign_main, ["--db", path("scale_bgmm"), "--query",
                                d.qfile, "--output", path("scale_assigned")])
    ref_clusters = read_clusters(files(path("scale_bgmm"), "_clusters.csv"))
    q_clusters = read_clusters(files(path("scale_assigned"),
                                     "_clusters.csv"))
    if set(q_clusters) != set(d.queries):
        raise AssertionError(f"scale assign: assigned {sorted(q_clusters)}")
    check_pure({**ref_clusters, **q_clusters}, d.strain_of,
               "scale assign")
    emit({"phase": "L1", "clusters": counts, "lineage_header": header,
          "stages": stages, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches


def phase_l2(torch, device, workdir, e):
    """Phase E's 8192 references through StreamingCondensed on the card:
    the predeclared 100,000-pair subsample equals phase E's condensed
    distances at the same pairs within DIST_TOL, the fused kNN (k 10)
    equals a kNN taken from them (indices equal but where two neighbours'
    distances meet within DIST_TOL), and the bootstrap refine's clusters
    equal the planted strains. After the counted run, the kernel is held to
    the plain version at the pass's own operands (hold_steps_to_plain)."""
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.ops.sparse_knn import knn_from_condensed
    from poppunk_tpu_torch.pairs import pair_to_condensed
    from poppunk_tpu_torch.scale import StreamingCondensed, fold_inverse

    ss64, bbits = PRODUCTION[:2]
    t0 = time.perf_counter()
    n, knn = e.n_ref, 10
    names = e.names[:n]
    planes = np.ascontiguousarray(e.planes[:n].transpose(1, 2, 0, 3))
    n0 = mc.LAUNCHES
    t = time.perf_counter()
    cd = StreamingCondensed(planes, e.lengths[:n], e.freqs[:n], KLIST, ss64,
                            bbits, chunk=256, knn=knn,
                            subsample=(100000, SEED), device=device)
    pass1_s = elapsed(torch, t)
    launches = {"L2_pass1": mc.LAUNCHES - n0}
    sub = cd.subsample_pairs(100000, seed=SEED)
    pos = np.sort(np.random.default_rng(SEED).choice(cd.n_pairs, 100000,
                                                     replace=False))
    i, j = fold_inverse(pos, n)
    np.testing.assert_allclose(sub, e.X[pair_to_condensed(i, j, n)],
                               **DIST_TOL)
    _, cols, dists = knn_from_condensed(e.X[:, 0], n, knn)
    cols, dists = cols.reshape(n, knn), dists.reshape(n, knn)
    np.testing.assert_allclose(cd.knn_dist, dists, **DIST_TOL)
    r, c = np.nonzero(cd.knn_col != cols)
    a, b = np.minimum(r, cd.knn_col[r, c]), np.maximum(r, cd.knn_col[r, c])
    np.testing.assert_allclose(e.X[pair_to_condensed(a, b, n), 0],
                               dists[r, c], **DIST_TOL)
    del cd

    n0 = mc.LAUNCHES
    clusters, fit = streaming_fit(torch, device, workdir, planes,
                                  e.lengths[:n], e.freqs[:n], names, knn)
    launches["L2_fit"] = mc.LAUNCHES - n0
    check_partition(clusters, e.strain_of)
    step_errs, step_plain_s = hold_steps_to_plain(torch, fit.cd)
    emit({"phase": "L2", "genomes": n, "pass1_seconds": pass1_s,
          "plane_major_vs_plain": {"max_abs_err": step_errs,
                                   "plain_seconds": step_plain_s},
          "subsample_pairs": int(len(sub)), "knn": knn,
          "knn_index_near_ties": int(len(r)), "stages": fit.stages,
          "band_edges": fit.band_edges, "boundary": fit.boundary,
          "sweep": fit.sweep, "clusters": len(set(clusters.values())),
          "launches": launches, "seconds": time.perf_counter() - t0})
    # L4b recomputes from E's planes: the resident copy goes now, so that
    # L3's peak device memory is L3's own
    fit.cd = None
    return launches, fit


def phase_l3(torch, device, workdir, n=65536, n_strains=128):
    """The streaming fit at full width: n genomes in planted strains at
    production geometry, drawn on the card; pass 1 with the k 30 kNN and
    the band fill, the BGMM start on the 100,000-pair subsample,
    plan_sweep_band, refine_fit_device on the card, the network and
    clusters (strain-pure), the lineage fit (ranks 1-3) from the fused
    kNN. Peak device memory is held to streaming_hbm_accounting's total
    plus the sweep's budget (ops/sparse_sweep.sweep_peak_bytes, what
    hbm_feasible plans with). After the counted run, the kernel is held to
    the plain version at the pass's own operands (hold_steps_to_plain)."""
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.ops.sparse_sweep import sweep_peak_bytes
    from poppunk_tpu_torch.scale import streaming_hbm_accounting

    ss64, bbits = PRODUCTION[:2]
    t0 = time.perf_counter()
    t = time.perf_counter()
    planes, lengths, freqs, strains = planted_population_on_card(
        torch, device, n, n_strains, SEED + 3)
    make_s = elapsed(torch, t)
    names = [f"g{i}" for i in range(n)]
    strain_of = dict(zip(names, strains.tolist()))
    n0 = mc.LAUNCHES
    clusters, fit = streaming_fit(torch, device, workdir, planes, lengths,
                                  freqs, names, knn=30, ranks=[1, 2, 3],
                                  summary_sample=10000)
    launches = {"L3": mc.LAUNCHES - n0}
    peak = max(fit.peaks.values(), default=0)
    check_pure(clusters, strain_of, "L3 clusters")
    step_errs, step_plain_s = hold_steps_to_plain(torch, fit.cd)
    accounting = streaming_hbm_accounting(n, KLIST, ss64, bbits, fit.chunk,
                                          30, 1)
    sweep_bytes = sweep_peak_bytes(n, fit.spec["e_total"])
    limit = accounting["total"] + sweep_bytes
    emit({"phase": "L3", "genomes": n, "strains": n_strains,
          "geometry": {"sketchsize64": ss64, "bbits": bbits,
                       "klist": list(KLIST), "chunk": fit.chunk},
          "make_data_seconds": make_s, "stages": fit.stages,
          "plane_major_vs_plain": {"max_abs_err": step_errs,
                                   "plain_seconds": step_plain_s},
          # n^2 a pass, as when every row was counted in full: comparable
          # across runs, but twice the pairs the owned-tile walk computes,
          # (n/2)(n + c) a pass (the next key)
          "pass1_full_row_pairs_per_s": n * n / fit.stages["pass1"],
          "pass1_computed_pairs_per_s":
              n // 2 * (n + fit.chunk) / fit.stages["pass1"],
          "pass1_kernel": {"launches": fit.pass1_launches,
                           "event_seconds": fit.pass1_kernel_s,
                           "rest_seconds":
                               fit.stages["pass1"] - fit.pass1_kernel_s},
          "band_edges": fit.band_edges, "band_offsets": fit.spec["n_act"],
          "sweep": fit.sweep, "boundary": fit.boundary,
          "clusters": len(set(clusters.values())),
          "lineages": {f"rank_{r}": len({row[i + 1] for row in
                                         fit.lineages[1].values()})
                       for i, r in enumerate((1, 2, 3))},
          "peak_device_bytes": peak, "peak_device_bytes_by_stage": fit.peaks,
          "accounting_total": accounting["total"],
          "sweep_budget_bytes": sweep_bytes, "launches": launches,
          "seconds": time.perf_counter() - t0})
    if peak > limit:
        raise AssertionError(f"L3 peak device memory {peak} exceeds the "
                             f"accounting {accounting['total']} plus the "
                             f"sweep's budget {sweep_bytes}")
    return launches, SimpleNamespace(fit=fit, clusters=clusters, names=names,
                                     limit=limit)


def counted(torch, device, fn):
    """(result, seconds, standard-kernel launches, their summed CUDA event
    seconds) of one pass; no event time on the CPU rehearsal."""
    from poppunk_tpu_torch.ops import match_counts as mc

    n0 = mc.LAUNCHES
    t = time.perf_counter()
    if device.type == "cuda":
        with RecordLaunchTimes(torch) as kernel:
            out = fn()
            seconds = elapsed(torch, t)
            kernel_s = kernel.seconds()
    else:
        out, kernel_s = fn(), 0.0
        seconds = elapsed(torch, t)
    return out, seconds, mc.LAUNCHES - n0, kernel_s


def phase_l4(torch, device, workdir, d, e, lctx):
    """L4a-c: the scale tier's other modes. Returns standard launches per
    stage."""
    launches = {}
    launches.update(phase_l4a(torch, device, workdir, d))
    launches.update(phase_l4b(torch, device, workdir, e, lctx.l2))
    launches.update(phase_l4c(torch, device, workdir, lctx.l3))
    return launches, None


def phase_l4a(torch, device, workdir, d):
    """poppunk_tpu_torch_scale's other modes on phase D's database, on the
    card by default: --unconstrained --pos-shift 0.05 (strain-pure, both
    intercepts positive); --multi-boundary 4 (every boundary file only
    splits strains); --use-model with L1's BGMM-started fit (L1's clusters,
    name for name); --run-qc on D's references plus one genome of random
    sequence, at thresholds between D's column maxima and the junk
    genome's median distances (the junk genome fails, alone, and the
    failed set equals the port's host qc_dist_mat on that database's
    distances at the same thresholds; that database's distances equal
    the CPU's within DIST_TOL); --mandrake --perplexity 5
    --mandrake-iter 20000 (every name in the .dot, finite coordinates)."""
    import glob

    from poppunk_tpu_torch import _device
    from poppunk_tpu_torch.cli.main import main as poppunk_main
    from poppunk_tpu_torch.cli.scale import main as scale_main
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.pairs import condensed_to_pair
    from poppunk_tpu_torch.qc import DEFAULT_QC, qc_dist_mat
    from poppunk_tpu_torch.utils import read_pickle

    t0 = time.perf_counter()
    stages, launches = {}, {}
    path = lambda name: os.path.join(workdir, name)  # noqa: E731
    files = lambda out, ext: os.path.join(  # noqa: E731
        out, os.path.basename(out) + ext)

    def run(stage, fn, argv):
        t = time.perf_counter()
        n0 = mc.LAUNCHES
        fn(argv)
        stages[stage] = elapsed(torch, t)
        launches["L4a_" + stage] = mc.LAUNCHES - n0

    def scale(stage, *flags, db=d.db):
        out = path(f"l4_{stage}")
        run(stage, scale_main, ["--ref-db", db, "--output", out, "--no-plot"]
            + list(flags))
        return out

    out = scale("unconstrained", "--unconstrained", "--pos-shift", "0.05")
    boundary = np.load(files(out, "_fit.npz"))["intercept"]
    if not (boundary > 0).all():
        raise AssertionError(f"--unconstrained boundary {boundary}")
    check_pure(read_clusters(files(out, "_clusters.csv")), d.strain_of,
               "L4a --unconstrained")

    out = scale("multi_boundary", "--multi-boundary", "4")
    boundary_files = sorted(glob.glob(os.path.join(
        out, "*_boundary[0-9]*_clusters.csv")))
    if not boundary_files:
        raise AssertionError("--multi-boundary wrote no boundary file")
    for f in boundary_files:
        clusters = read_clusters(f)
        if set(clusters) != set(d.refs):
            raise AssertionError(f"{f} misses samples")
        check_pure(clusters, d.strain_of, os.path.basename(f))

    fit = path("scale_bgmm")  # L1's
    out = scale("use_model", "--use-model", "--model-dir", fit)
    if read_clusters(files(out, "_clusters.csv")) != read_clusters(
            files(fit, "_clusters.csv")):
        raise AssertionError("--use-model: clusters differ from L1's fit")

    # --run-qc: D's references and one genome of random sequence
    rng = np.random.default_rng(SEED + 9)
    junk = path("junkbug.fa")
    seq = "".join(rng.choice(list("ACGT"), size=d.genome_length))
    with open(junk, "w") as f:
        f.write(">junkbug\n" + "\n".join(
            seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    rfile = path("refs_and_junk.txt")
    with open(d.rfile) as src, open(rfile, "w") as f:
        f.write(src.read() + f"junkbug\t{junk}\n")
    junk_db = path("junk_db")
    run("qc_create_db", poppunk_main, ["--create-db", "--r-files", rfile,
                                       "--output", junk_db, "--no-plot"])
    rlist, _, _, X = read_pickle(files(junk_db, ".dists"))
    i, j = condensed_to_pair(np.arange(len(X)), len(rlist))
    with_junk = (np.asarray(rlist)[i] == "junkbug") | \
        (np.asarray(rlist)[j] == "junkbug")
    # a column where most junk pairs lie past D's own distances is cut at
    # the midpoint of D's maximum and the junk pairs' median; a column
    # where they do not is opened past every distance
    real_max = X[~with_junk].max(axis=0)
    junk_median = np.median(X[with_junk], axis=0)
    if not (junk_median > real_max).any():
        raise AssertionError(f"the junk genome's distances (median "
                             f"{junk_median}) do not clear D's {real_max}")
    cuts = np.where(junk_median > real_max, (real_max + junk_median) / 2,
                    X.max(axis=0) + 1)
    # the same database's distances on the CPU: the card's equal them
    # within DIST_TOL, the junk genome's near-empty Jaccards included
    saved = os.environ.get(_device.ENV)
    os.environ[_device.ENV] = "cpu"
    try:
        poppunk_main(["--create-db", "--r-files", rfile, "--output",
                      path("junk_db_cpu"), "--no-plot"])
    finally:
        if saved is None:
            del os.environ[_device.ENV]
        else:
            os.environ[_device.ENV] = saved
    X_cpu = read_pickle(files(path("junk_db_cpu"), ".dists"))[3]
    beyond = ~np.isclose(X, X_cpu, **DIST_TOL).all(axis=1)
    junk_card_vs_cpu = {
        "max_abs_err": float(np.abs(X - X_cpu).max()),
        "pairs_beyond_dist_tol": int(beyond.sum()),
        "of_them_with_junk": int((beyond & with_junk).sum()),
        "examples": [[rlist[a], rlist[b], X[r].tolist(), X_cpu[r].tolist()]
                     for r, a, b in zip(np.nonzero(beyond)[0][:5],
                                        i[beyond][:5], j[beyond][:5])]}
    if beyond.any():
        raise AssertionError(f"the junk database's distances on the card "
                             f"and the CPU differ: {junk_card_vs_cpu}")
    out = scale("run_qc", "--run-qc", "--max-zero-dist", "1",
                "--max-pi-dist", repr(float(cuts[0])), "--max-a-dist",
                repr(float(cuts[1])), db=junk_db)
    with open(files(out, "_qcreport.txt")) as f:
        failed = {line.split("\t")[0] for line in f}
    qc_dict = dict(DEFAULT_QC, prop_zero=1, max_pi_dist=float(cuts[0]),
                   max_a_dist=float(cuts[1]))
    _, fail_host = qc_dist_mat(X, rlist, rlist, junk_db, qc_dict)
    if failed != {"junkbug"} or failed != set(fail_host):
        raise AssertionError(f"--run-qc failed {sorted(failed)}, the host "
                             f"qc_dist_mat {sorted(fail_host)}")
    if set(read_clusters(files(out, "_clusters.csv"))) != \
            set(d.refs) - failed:
        raise AssertionError("--run-qc: clusters are not the survivors")

    out = scale("mandrake", "--mandrake", "--perplexity", "5",
                "--mandrake-iter", "20000")
    coords = read_dot(files(out, "_perplexity5.0_accessory_mandrake.dot"))
    if set(coords) != set(d.refs) or not np.isfinite(
            list(coords.values())).all():
        raise AssertionError("--mandrake: the .dot misses names or holds "
                             "non-finite coordinates")
    emit({"phase": "L4a", "unconstrained_boundary": boundary.tolist(),
          "boundary_files": len(boundary_files),
          "qc_junk_median": junk_median.tolist(),
          "qc_junk_min": X[with_junk].min(axis=0).tolist(),
          "qc_d_max": real_max.tolist(), "qc_cuts": cuts.tolist(),
          "qc_failed": sorted(failed),
          "junk_db_card_vs_cpu": junk_card_vs_cpu,
          "stages": stages, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches


def phase_l4b(torch, device, workdir, e, l2):
    """Phase E's 8192 references at production geometry, from L2's BGMM
    start (L2's planes went with L2; they are put on the card again): the
    unconstrained refine_fit_device_2d at a 1,000,000-pair cap (the
    520,192 within-strain pairs stay scoreable, the host scorer bounded),
    its counts pass, fetch pass and host scoring timed apart, its clusters
    the planted strains; multi_refine_device at 4 points up to L2's
    constrained s_opt (every file only splits strains);
    qc_bad_pairs_streaming at thresholds just under E's column maxima
    (the 100th largest value of each), whose (i, j, flags) equal a scan of
    E's condensed distances with the same rule but for pairs within
    DIST_TOL of a threshold (counted)."""
    import glob

    import poppunk_tpu_torch.scale as tsc
    from poppunk_tpu_torch.cli.scale import _network_and_clusters
    from poppunk_tpu_torch.pairs import condensed_to_pair, pair_to_condensed

    ss64, bbits = PRODUCTION[:2]
    t0 = time.perf_counter()
    n = e.n_ref
    names = e.names[:n]
    cd = tsc.StreamingCondensed(
        np.ascontiguousarray(e.planes[:n].transpose(1, 2, 0, 3)),
        e.lengths[:n], e.freqs[:n], KLIST, ss64, bbits, chunk=l2.chunk,
        knn=0, defer=True, device=device)
    scale, mean0, mean1 = l2.start
    stages, launches, kernel_s = {}, {}, {}
    cap = 1_000_000
    with Timed(torch, [(tsc, "sweep2d_counts_streaming", "counts_pass"),
                       (tsc, "sweep2d_fetch_streaming", "fetch_pass")]) as rec:
        (x, y, sweep), refine_s, launches["L4b_refine_2d"], \
            kernel_s["refine_2d"] = counted(
                torch, device, lambda: tsc.refine_fit_device_2d(
                    cd, scale, mean0, mean1, max_move=0.0, min_move=0.0,
                    max_sweep_fetch=cap))
    cum = rec.calls[0][4]
    stages.update(rec.seconds())
    stages["host_scoring"] = refine_s - sum(rec.seconds().values())
    out = os.path.join(workdir, "l4_refine_2d")
    os.makedirs(out, exist_ok=True)
    _, clusters = timed_stage(torch, stages, "network_clusters", lambda: (
        _network_and_clusters(cd, sweep, None, names, out, network_args(),
                              boundary=(x, y))))
    check_partition(clusters, e.strain_of)

    out = os.path.join(workdir, "l4_multi")
    os.makedirs(out, exist_ok=True)
    _, stages["multi_refine"], launches["L4b_multi_refine"], \
        kernel_s["multi_refine"] = counted(
            torch, device, lambda: tsc.multi_refine_device(
                cd, scale, mean0, mean1, l2.s_opt, 4, out, names))
    multi_files = sorted(glob.glob(os.path.join(
        out, "*_boundary[0-9]*_clusters.csv")))
    if not multi_files:
        raise AssertionError("multi_refine_device wrote no boundary file")
    for f in multi_files:
        check_pure(read_clusters(f), e.strain_of, os.path.basename(f))

    X = e.X
    cuts = np.partition(X, len(X) - 100, axis=0)[len(X) - 100]
    (i, j, flags), stages["qc"], launches["L4b_qc"], kernel_s["qc"] = \
        counted(torch, device, lambda: tsc.qc_bad_pairs_streaming(
            cd.planes, cd.lengths, cd.freqs, KLIST, ss64, bbits, cd.chunk, n,
            float(cuts[0]), float(cuts[1])))
    del cd
    core, acc = X[:, 0], X[:, 1]
    scan = ((core > cuts[0]) | (acc > cuts[1])).astype(np.uint8) \
        + 2 * ((core == 0) | (acc == 0)).astype(np.uint8)
    rows = np.nonzero(scan)[0]
    si, sj = condensed_to_pair(rows, n)
    got = set(zip(i.tolist(), j.tolist(), flags.tolist()))
    want = set(zip(np.asarray(si).tolist(), np.asarray(sj).tolist(),
                   scan[rows].tolist()))
    differ = np.array(sorted({(a, b) for a, b, _ in got ^ want}),
                      np.int64).reshape(-1, 2)
    tol = DIST_TOL["atol"] + DIST_TOL["rtol"] * np.abs(cuts)

    def near(v):
        return (np.abs(v - cuts) <= tol).any(axis=1) | \
            (np.abs(v) <= DIST_TOL["atol"]).any(axis=1)

    near_all = int(near(X).sum())
    off = X[pair_to_condensed(differ[:, 0], differ[:, 1], n)]
    if not near(off).all():
        raise AssertionError(f"qc_bad_pairs_streaming disagrees with E's "
                             f"distances away from a threshold: {differ}")
    emit({"phase": "L4b", "genomes": n, "max_sweep_fetch": cap,
          "cells": int(cum.size), "scored_cells": int((cum <= cap).sum()),
          "fetched_pairs": int(len(sweep[1])), "boundary": [x, y],
          "clusters": len(set(clusters.values())),
          "multi_boundary_files": len(multi_files),
          "qc_cuts": cuts.tolist(), "qc_flagged": int(len(i)),
          "qc_scan_flagged": int(len(rows)),
          "qc_pairs_differing": int(len(differ)),
          "qc_pairs_within_tol_of_a_cut": near_all,
          "stages": stages, "kernel_event_seconds": kernel_s,
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


def phase_l4c(torch, device, workdir, l3):
    """Full width, on L3's resident planes (65,536 genomes; no upload):
    fetch_within_boundary at L3's refined boundary (the components of the
    fetched edges are L3's clusters; edge counts beside L3's),
    qc_bad_pairs_streaming at 0.999 of L3's column maxima (non-empty; every
    flagged pair, recomputed by _pair_block_dists, breaks its rule within
    DIST_TOL) and the --mandrake path (_mandrake_embedding: the accessory
    kNN pass at k 50, then the SCE at the CLI's default --mandrake-iter).
    Each pass: seconds, launches, summed kernel event time. Peak device
    memory is held to L3's limit."""
    from poppunk_tpu_torch import embedding
    from poppunk_tpu_torch.cli.scale import _mandrake_embedding
    from poppunk_tpu_torch.network.components import connected_components
    from poppunk_tpu_torch.network.graph import Graph
    from poppunk_tpu_torch.scale import (_pair_block_dists,
                                         fetch_within_boundary,
                                         qc_bad_pairs_streaming)

    ss64, bbits = PRODUCTION[:2]
    t0 = time.perf_counter()
    fit, names = l3.fit, l3.names
    cd, n = fit.cd, len(l3.names)
    operands = (cd.planes, cd.lengths, cd.freqs, KLIST, ss64, bbits,
                cd.chunk, n)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    passes, launches = {}, {}

    def record(name, fn):
        out, seconds, launches["L4c_" + name], kernel_s = counted(
            torch, device, fn)
        passes[name] = {"seconds": seconds, "kernel_event_seconds": kernel_s}
        return out

    scale = fit.start[0]
    i, j = record("fetch_within_boundary", lambda: fetch_within_boundary(
        *operands, scale, *fit.boundary, 2))
    labels = connected_components(Graph(n, np.stack([i, j], axis=1)))[0]
    cl = np.array([l3.clusters[name] for name in names])
    same = len(set(zip(labels.tolist(), cl.tolist())))
    if not same == len(set(labels.tolist())) == len(set(cl.tolist())):
        raise AssertionError("fetch_within_boundary's components are not "
                             "L3's clusters")

    cuts = 0.999 * np.asarray(cd.max_scale(), np.float64)
    qi, qj, flags = record("qc", lambda: qc_bad_pairs_streaming(
        *operands, float(cuts[0]), float(cuts[1])))
    if not len(qi):
        raise AssertionError("qc_bad_pairs_streaming flagged nothing")
    bad = 0
    for s in range(0, len(qi), 8192):
        dd = _pair_block_dists(
            cd._pair_rows, cd.lengths, cd.freqs,
            torch.as_tensor(qi[s:s + 8192], device=device),
            torch.as_tensor(qj[s:s + 8192], device=device), cd._klist,
            cd._ss64, cd._bbits).cpu().numpy()
        tol = DIST_TOL["atol"] + DIST_TOL["rtol"] * cuts
        long_ok = (dd > cuts - tol).any(axis=1)
        zero_ok = (np.abs(dd) <= DIST_TOL["atol"]).any(axis=1)
        f = flags[s:s + 8192]
        bad += int((((f & 1) > 0) & ~long_ok).sum()
                   + (((f & 2) > 0) & ~zero_ok).sum())
    if bad:
        raise AssertionError(f"{bad} flagged pairs keep the QC rules")

    args = SimpleNamespace(perplexity=30.0, mandrake_iter=100000, seed=SEED)
    out = os.path.join(workdir, "l4_mandrake")
    os.makedirs(out, exist_ok=True)
    with Timed(torch, [(embedding, "embedding_from_knn", "sce")]) as rec:
        emb = record("mandrake", lambda: _mandrake_embedding(
            args, cd, names, out, device))
    passes["mandrake"]["sce_seconds"] = rec.seconds()["sce"]
    if emb.shape != (n, 2) or not np.isfinite(emb).all():
        raise AssertionError(f"mandrake embedding {emb.shape}, finite "
                             f"{np.isfinite(emb).all()}")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    emit({"phase": "L4c", "genomes": n, "passes": passes,
          "fetched_edges": int(len(i)), "l3_network_edges":
              fit.network_edges, "edge_difference":
              int(len(i)) - fit.network_edges,
          "clusters": len(set(cl.tolist())), "qc_cuts": cuts.tolist(),
          "qc_flagged": int(len(qi)),
          "qc_flag_counts": {"long": int(((flags & 1) > 0).sum()),
                             "zero": int(((flags & 2) > 0).sum())},
          "peak_device_bytes": peak, "l3_limit_bytes": l3.limit,
          "launches": launches, "seconds": time.perf_counter() - t0})
    if on_card and peak > l3.limit:
        raise AssertionError(f"L4c peak device memory {peak} exceeds L3's "
                             f"limit {l3.limit}")
    return launches


# --------------------------------------------------------------------------
# M: the buffered scale pipeline, its streaming twin, the helper scripts
# --------------------------------------------------------------------------

# the 16 GB chip the reference sized MATMUL_SWEEP_MAX_N (20480) for
M1_LIMIT_BYTES = 16e9


def time_products(torch, d0_sq, t):
    """One grid offset's adjacency product at threshold t on the M1
    square by three exact routes, each timed by CUDA events over 3 calls
    after a warm-up and held equal to the first: torch._int_mm with the
    column-major second operand (matmul_sweep_scores' route), with a
    row-major one, and float32 with TF32 off. Returns {route: ms}."""
    A = (d0_sq <= torch.tensor(np.float32(t), device=d0_sq.device)).to(
        torch.int8)
    Af = A.float()
    routes = {"int8_col_major": lambda: torch._int_mm(A, A.t()),
              "int8_row_major": lambda: torch._int_mm(A, A),
              "float32": lambda: Af @ Af}
    ms, want = {}, None
    for name, fn in routes.items():
        got = fn().to(torch.int32)
        if want is None:
            want = got
        elif not torch.equal(got, want):
            raise AssertionError(f"the {name} product differs")
        del got
        ms[name] = event_ms(fn, 3)
    return ms


def phase_m(torch, device, workdir, d, n=20480):
    """M1-M3. Returns standard launches per stage, and M1's worst
    difference of the kernel from its plain version at the fill's own
    operands with M1's and M2's pipeline results (for phase N)."""
    launches = {}
    m1_launches, m1 = phase_m1(torch, device, n)
    launches.update(m1_launches)
    m2_launches, m2 = phase_m2(torch, device, m1, n)
    launches.update(m2_launches)
    launches.update(phase_m3(torch, device, workdir, d))
    return launches, SimpleNamespace(kernel_err=m1.kernel_err, n=n,
                                     m1=m1.out, m2=m2)


def phase_m1(torch, device, n):
    """run_scale_pipeline(n) at the reference's defaults (K 6, sketch
    9984, 14 planes, 20 strains, chunk 512, kNN 5, the 100,000-pair
    subsample), on the card: the buffered route (the folded condensed
    buffer resident, the 40-offset matmul sweep, components on the card).
    Stage seconds, the refine's grid and local parts, the fill's launches
    and their summed CUDA event time, pairs/s, and the pipeline's peak
    device memory net of what was allocated before it; fails unless the
    route is ``device``, the ARI against the planted strains is >= 0.99
    with 20 clusters and the net peak stays under M1_LIMIT_BYTES. Then
    m1_rebuild reruns the pipeline's device stages at its boundary."""
    from poppunk_tpu_torch import scale

    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    base = None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    log = []
    out, seconds, fill_launches, kernel_s = counted(
        torch, device, lambda: scale.run_scale_pipeline(
            n=n, log=log.append, device=device))
    peak = torch.cuda.max_memory_allocated() - base if on_card else None
    emit({"phase": "M1", "n": n, "route": out["route"],
          "stages": out["timings"],
          "refine_parts": out.get("refine_phase_s"),
          "pipeline_s": out["pipeline_s"], "n_edges": out["n_edges"],
          "n_clusters": out["n_clusters"], "ari": out["ari"],
          "n_lineages": out["n_lineages"], "ari_lineage": out["ari_lineage"],
          "fill_launches": fill_launches, "fill_kernel_s": kernel_s,
          "pairs_per_s": out["pairs_per_s"], "base_device_bytes": base,
          "peak_device_bytes": peak, "limit_bytes": M1_LIMIT_BYTES,
          "log": log, "seconds": elapsed(torch, t0)})
    if out["route"] != "device":
        raise AssertionError(f"M1 took the {out['route']} sweep, not device")
    if out["ari"] < 0.99 or out["n_clusters"] != 20:
        raise AssertionError(f"M1: ARI {out['ari']}, {out['n_clusters']} "
                             "clusters against 20 planted strains")
    if on_card and peak >= M1_LIMIT_BYTES:
        raise AssertionError(f"M1 peak device memory {peak} (net) >= "
                             f"{M1_LIMIT_BYTES}")
    return {"M1_fill": fill_launches}, m1_rebuild(torch, device, n, out)


def m1_rebuild(torch, device, n, out):
    """The pipeline's device stages again, on the same seed at M1's
    boundary, one at a time: the synthetic population, the buffered fill,
    the dense square, the product and the components at the boundary.
    Each stage's device bytes live at its start and its peak, net of what
    was allocated before the first (M1's memory breakdown). Fails unless
    the components are M1's labels. Then one offset's product is timed by
    three exact routes (time_products), the boundary's pairs are counted
    once more by the streaming recompute from the planes (for M2), and the
    kernel is held to its plain version at the streaming pass's operands
    (hold_steps_to_plain: the first and a middle step's owned tiles, row
    views of the resident planes against column views of them)."""
    from poppunk_tpu_torch import scale, synth

    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    b = out["boundary"]
    t = scale.offset_threshold(b["s_opt"], b["s_range"], 2, *b["line"])
    memory, base = {}, torch.cuda.memory_allocated() if on_card else None

    def stage(name, fn):
        if on_card:
            live = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
        got = fn()
        if on_card:
            memory[name] = {"live": live,
                            "peak": torch.cuda.max_memory_allocated() - base}
        return got

    # run_scale_pipeline's defaults at n <= 20480
    klist, ss64, bbits, chunk = (13, 16, 19, 22, 25, 28), 156, 14, 512
    pop = stage("synth", lambda: synth.synthetic_population_device(
        n, klist, ss64, bbits, n_strains=20, seed=2,
        chunk=max(chunk, min(n, 2048)), device=device))
    cd = stage("fill", lambda: scale.fill_condensed_device(
        pop.planes, pop.lengths, pop.freqs, klist, ss64, bbits, chunk=chunk,
        knn=5))
    d0_sq, _ = stage("square", lambda: scale.build_d0_square(
        cd, b["scale"], 2, *b["line"], b["s_range"]))
    dense = int(stage("product", lambda: scale.matmul_sweep_scores(
        d0_sq, [t]))[1][0])
    labels, _ = stage("components",
                      lambda: scale.components_device(d0_sq, t))
    if not np.array_equal(labels, out["labels"]):
        raise AssertionError("the rebuilt square's components are not M1's")
    products = time_products(torch, d0_sq, t) if on_card else None
    del d0_sq, cd
    scd = scale.StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                   klist, ss64, bbits, chunk=chunk,
                                   defer=True)
    streamed = int(scale.sweep_counts_streaming(
        scd, b["scale"], np.array([b["s_range"][0], b["s_opt"]]), 2,
        *b["line"])[1])
    emit({"phase": "M1_rebuild", "memory": memory, "base_device_bytes": base,
          "products_ms": products, "seconds": elapsed(torch, t0)})
    t1 = time.perf_counter()
    errs, plain_s = hold_steps_to_plain(torch, scd)
    emit({"phase": "M1_plain", "max_abs_err": errs, "plain_s": plain_s,
          "seconds": elapsed(torch, t1)})
    return SimpleNamespace(out=out, dense=dense, streamed=streamed,
                           kernel_err=max(errs.values()))


def phase_m2(torch, device, m1, n):
    """The same population (the same seed) through
    run_scale_pipeline(streaming=True): the bootstrap pass and the device
    sparse sweep. Fails unless the route is ``edges``, the edge count and
    clusters are M1's, the partition is M1's (ARI 1.0 between the label
    vectors), and at M1's boundary the dense product's edge count equals
    the streamed exact count (both from m1_rebuild)."""
    from poppunk_tpu_torch import scale

    t0 = time.perf_counter()
    log = []
    out, seconds, launches, kernel_s = counted(
        torch, device, lambda: scale.run_scale_pipeline(
            n=n, streaming=True, log=log.append, device=device))
    agree = scale.adjusted_rand_index(m1.out["labels"], out["labels"])
    emit({"phase": "M2", "n": n, "route": out["route"],
          "stages": out["timings"],
          "refine_parts": out.get("refine_phase_s"),
          "pipeline_s": out["pipeline_s"], "n_edges": out["n_edges"],
          "n_clusters": out["n_clusters"], "ari": out["ari"],
          "n_lineages": out["n_lineages"], "pass_launches": launches,
          "pass_kernel_s": kernel_s, "pairs_per_s": out["pairs_per_s"],
          "ari_vs_m1": agree, "m1_boundary_edges": {
              "dense": m1.dense, "streamed": m1.streamed,
              "m1": m1.out["n_edges"]}, "log": log,
          "seconds": elapsed(torch, t0)})
    if out["route"] != "edges":
        raise AssertionError(f"M2 took the {out['route']} sweep, not edges")
    if (out["n_edges"], out["n_clusters"]) != (m1.out["n_edges"],
                                               m1.out["n_clusters"]):
        raise AssertionError(
            f"M2 {out['n_edges']} edges / {out['n_clusters']} clusters, "
            f"M1 {m1.out['n_edges']} / {m1.out['n_clusters']}")
    if agree != 1.0:
        raise AssertionError(f"M2's partition is not M1's (ARI {agree})")
    if not m1.dense == m1.streamed == m1.out["n_edges"]:
        raise AssertionError(f"at M1's boundary: dense {m1.dense}, streamed "
                             f"{m1.streamed}, M1 {m1.out['n_edges']} edges")
    return {"M2_pass": launches}, out


def phase_m3(torch, device, workdir, d):
    """``python -m poppunk_tpu_torch --version`` in a subprocess, then the
    helper scripts on phase D's database and sequence files (on the card
    by default): extract_distances (one row per pair), extract_components
    (one graph per cluster), add_weights (positive weights), distribute_fit
    (the bundles), rand_index unadjusted (1.0 against itself), iterate on a
    --multi-boundary 4 refine of D built as tests/test_scripts.py builds
    it (tree, cluster and cutoff files; the tree's leaves D's
    references), batch_mst (the MST names every genome) and easy_run
    (create-db, DBSCAN, refine: the planted strains). Returns the
    standard kernel's launches over M3."""
    from poppunk_tpu_torch.cli.main import main as poppunk_main
    from poppunk_tpu_torch.network.graph import load_network_file
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.scripts import (add_weights, batch_mst,
                                           distribute_fit, easy_run,
                                           extract_components,
                                           extract_distances, iterate,
                                           rand_index)
    from poppunk_tpu_torch.trees import parse_newick

    t0 = time.perf_counter()
    n0 = mc.LAUNCHES
    stages = {}
    out = os.path.join(workdir, "m3")
    os.makedirs(out)
    db = os.path.join(d.db, os.path.basename(d.db))

    def run(stage, fn, argv):
        t = time.perf_counter()
        fn(argv)
        stages[stage] = elapsed(torch, t)

    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "poppunk_tpu_torch",
                          "--version"], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    stages["python_m"] = time.perf_counter() - t
    if res.returncode or not res.stdout.startswith("poppunk_tpu_torch"):
        raise AssertionError(f"python -m poppunk_tpu_torch --version: "
                             f"{res.returncode} {res.stdout!r} "
                             f"{res.stderr[-2000:]}")

    n_refs = len(d.refs)
    run("extract_distances", extract_distances.main,
        ["--distances", db + ".dists", "--output", out + "/dists.tsv"])
    with open(out + "/dists.tsv") as f:
        rows = f.read().splitlines()
    if rows[0] != "Query\tSubject\tCore\tAccessory" or \
            len(rows) != 1 + n_refs * (n_refs - 1) // 2:
        raise AssertionError(f"extract_distances: {len(rows)} rows")

    n_clusters = len(set(read_clusters(db + "_clusters.csv").values()))
    run("extract_components", extract_components.main,
        ["--graph", db + "_graph.graph.npz", "--output", out + "/comp"])
    comps = [f for f in os.listdir(out) if f.startswith("comp.component_")]
    if len(comps) != n_clusters:
        raise AssertionError(f"extract_components: {len(comps)} graphs, "
                             f"{n_clusters} clusters")

    run("add_weights", add_weights.main,
        [db + "_graph.graph.npz", db + ".dists", out + "/weighted"])
    weighted = load_network_file(out + "/weighted/weighted_graph.graph.npz")
    if weighted.weights is None or not (weighted.weights > 0).all():
        raise AssertionError("add_weights: weights missing or not positive")

    run("distribute_fit", distribute_fit.main,
        ["--dbdir", d.db, "--fitdir", d.db, "--outpref", out + "/bundle",
         "--no-compress"])
    full = os.listdir(out + "/bundle_full")
    refs = os.listdir(out + "/bundle_refs")
    if not {"bundle_full.h5", "bundle_full_fit.npz"} <= set(full) or \
            "bundle_refs.h5" not in refs:
        raise AssertionError(f"distribute_fit: {full} {refs}")

    clusters_csv = db + "_clusters.csv"
    run("rand_index", rand_index.main,
        ["--input", f"{clusters_csv},{clusters_csv}", "--output",
         out + "/rand.tsv"])
    with open(out + "/rand.tsv") as f:
        fields = f.read().splitlines()[1].split("\t")
    if float(fields[3]) != 1.0:
        raise AssertionError(f"rand_index against itself: {fields}")

    multi = os.path.join(workdir, "m3_multi")
    run("multi_create_db", poppunk_main,
        ["--create-db", "--r-files", d.rfile, "--output", multi,
         "--no-plot"])
    run("multi_fit_bgmm", poppunk_main,
        ["--fit-model", "bgmm", "--ref-db", multi, "--output", multi,
         "--no-plot"])
    run("multi_refine", poppunk_main,
        ["--fit-model", "refine", "--ref-db", multi, "--output", multi,
         "--multi-boundary", "4", "--no-plot"])
    if not [f for f in os.listdir(multi)
            if "_boundary" in f and f.endswith("_clusters.csv")]:
        raise AssertionError("--multi-boundary 4 wrote no boundary files")
    run("iterate", iterate.main, ["--db", multi, "--cutoff", "0.5"])
    it = os.path.join(multi, "m3_multi_iterate")
    for ext in (".clusters.csv", ".cutoff_clusters.csv"):
        if not os.path.isfile(it + ext):
            raise AssertionError(f"iterate wrote no {ext}")
    with open(it + ".tree.nwk") as f:
        tree_leaves = {node.label for node in leaves(parse_newick(f.read()))}
    if tree_leaves != set(d.refs):
        raise AssertionError(f"iterate's tree leaves: {sorted(tree_leaves)}")

    run("batch_mst", batch_mst.main,
        ["--r-files", d.rfile, "--n-batches", "2", "--output",
         out + "/bmst", "--rank", "3", "--no-plot"])
    with open(out + "/bmst/bmst_MST.nwk") as f:
        nwk = f.read()
    missing = [name for name in d.refs if name not in nwk]
    if missing:
        raise AssertionError(f"batch_mst's MST misses {missing}")

    run("easy_run", easy_run.main,
        ["--r-files", d.rfile, "--output", out + "/easy",
         "--analysis-args=--no-plot"])
    check_partition(read_clusters(out + "/easy/easy_clusters.csv"),
                    d.strain_of)
    launches = mc.LAUNCHES - n0
    emit({"phase": "M3", "stages": stages, "launches": launches,
          "components": len(comps), "tree_leaves": len(tree_leaves),
          "seconds": time.perf_counter() - t0})
    return {"M3_scripts": launches}


# --------------------------------------------------------------------------
# N: the device mesh
# --------------------------------------------------------------------------

# N2's workers: each has this long to start, compute and gather
N2_TIMEOUT = 120


def sync_all(torch):
    """Wait for queued work on every card (a mesh spreads it)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def phase_n1(torch, device, e, mesh):
    """N1: pairwise_block on phase E's queries against its references,
    on one device (use_mesh=False) and sharded over ``mesh``
    (use_mesh=True), without a post and with E's BGMM fused post, under
    the current KERNEL_CHOICE. Fails unless the classes are equal bit for
    bit and the distances within DIST_TOL (and records whether they are
    bit-equal too). Returns the kernel's launches per route."""
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.ops.distances import pairwise_block
    from poppunk_tpu_torch.ops.fused_assign import model_post_spec

    t0 = time.perf_counter()
    ss64, bbits = PRODUCTION[:2]
    ref = (e.planes[:e.n_ref], e.lengths[:e.n_ref], e.freqs[:e.n_ref])
    qry = (e.planes[e.n_ref:], e.lengths[e.n_ref:], e.freqs[e.n_ref:])
    counter = "LAUNCHES" if mc.KERNEL_CHOICE == "standard" \
        else "PACKED_LAUNCHES"
    runs, launches = {}, {"single": 0, "mesh": 0}
    for post in ("none", "bgmm"):
        spec = None if post == "none" else model_post_spec(e.model)
        out = {}
        for route in ("single", "mesh"):
            n0 = getattr(mc, counter)
            t = time.perf_counter()
            got = pairwise_block(
                qry[0], ref[0], qry[1], ref[1], qry[2], ref[2], KLIST, ss64,
                bbits, post_spec=spec, device=device,
                use_mesh=route == "mesh",
                mesh=mesh if route == "mesh" else None)
            sync_all(torch)
            seconds = time.perf_counter() - t
            n = getattr(mc, counter) - n0
            launches[route] += n
            out[route] = got if spec is not None else (got, None)
            runs[f"{post}_{route}"] = {"seconds": seconds, "launches": n}
        (d1, c1), (dm, cm) = out["single"], out["mesh"]
        runs[post] = {"max_abs_err": float(np.abs(dm - d1).max()),
                      "bit_equal": bool(np.array_equal(dm, d1))}
        np.testing.assert_allclose(dm, d1, **DIST_TOL)
        if spec is not None:
            runs[post]["classes_equal"] = bool(np.array_equal(cm, c1))
            if not runs[post]["classes_equal"]:
                raise AssertionError(f"N1 ({mc.KERNEL_CHOICE}): the mesh's "
                                     "BGMM classes differ")
    emit({"phase": "N1", "kernel": mc.KERNEL_CHOICE,
          "block": [int(qry[0].shape[0]), int(ref[0].shape[0])],
          "mesh_shape": mesh.shape, "runs": runs,
          "seconds": time.perf_counter() - t0})
    return launches


N2_BLOCK = (1024, 4096)  # queries x references, PRODUCTION geometry


def n2_planes(nq, nr):
    """N2's block: random planes from a seed (queries, references)."""
    rng = np.random.default_rng(SEED + 9)
    planes = random_planes(rng, nq + nr, PRODUCTION)
    lengths = rng.integers(1_800_000, 2_200_000, nq + nr).astype(np.int32)
    freqs = rng.dirichlet(np.ones(4) * 50, nq + nr).astype(np.float32)
    return ((planes[:nq], lengths[:nq], freqs[:nq]),
            (planes[nq:], lengths[nq:], freqs[nq:]))


def n2_block(block, sharded, *args, **kwargs):
    """The count-derived [nq, nr, K] block of N2 (``block`` = (nq, nr)):
    the b-bit corrected Jaccards without the random-match term, an
    elementwise function of the match counts alone, so equal blocks are
    equal counts."""
    (pq, lq, fq), (pr, lr, fr) = n2_planes(*block)
    ss64, bbits = PRODUCTION[:2]
    return sharded(*args, pq, pr, lq, lr, fq, fr, KLIST, ss64, bbits,
                   random_correct=False, jaccard=True, **kwargs)


def n2_worker(rank, port, out, device, block):
    """One of N2's two processes: init_distributed (gloo for the host
    gather), pod_mesh over a virtual (1 x 2) local mesh on ``device``
    (cuda:0; the CPU in the rehearsal), the global mesh 2 x 2, its tiles
    of the block, the gathered block saved by rank 0 and its digest
    printed by both."""
    import hashlib

    import torch

    sys.path.insert(0, REPO)
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.parallel import (init_distributed, is_primary,
                                            pod_mesh, sharded_pairwise_block)

    init_distributed(f"localhost:{port}", 2, rank)
    try:
        device = torch.device(device)
        mesh = pod_mesh(devices=[device, device])
        if mesh.shape != {"q": 2, "r": 2} or len(mesh.tiles()) != 2:
            raise AssertionError(f"rank {rank}: {mesh}")
        t = time.perf_counter()
        got = n2_block(block, sharded_pairwise_block, mesh)
        seconds = time.perf_counter() - t
        if is_primary():
            np.save(out, got)
        print(json.dumps({"rank": rank, "launches": mc.LAUNCHES,
                          "seconds": seconds,
                          "sha256": hashlib.sha256(got.tobytes())
                          .hexdigest()}), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_n2(torch, device, workdir):
    """N2: two worker processes of the port (n2_worker), each with a free
    port's gloo group and a timeout; fails unless both exit 0, both see
    the whole gathered block (one digest) and rank 0's block equals this
    process's single-device block bit for bit. Returns the launches: the
    workers' (from their own counts) and this process's."""
    import hashlib
    import socket

    from poppunk_tpu_torch.ops.distances import pairwise_block

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = os.path.join(workdir, "n2_block.npy")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--n2-worker", str(rank),
         str(port), out, str(device), *map(str, N2_BLOCK)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=N2_TIMEOUT)
            if p.returncode != 0:
                raise AssertionError(f"N2 worker exited {p.returncode}:\n"
                                     f"{stderr[-3000:]}")
            results.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    got = np.load(out)
    want, single_s, single_launches, _ = counted(
        torch, device, lambda: n2_block(N2_BLOCK, pairwise_block,
                                        device=device, use_mesh=False))
    digests = {r["sha256"] for r in results}
    equal = bool(np.array_equal(got, want))
    emit({"phase": "N2", "block": list(N2_BLOCK), "workers": results,
          "single_seconds": single_s, "bit_equal": equal,
          "seconds": time.perf_counter() - t0})
    if len(digests) != 1 or digests != {
            hashlib.sha256(got.tobytes()).hexdigest()}:
        raise AssertionError(f"N2: the ranks saw different blocks: {results}")
    if not equal:
        raise AssertionError("N2: the two-process block's counts differ "
                             "from the single process's")
    return sum(r["launches"] for r in results) + single_launches


def phase_n3(torch, device, mesh, m):
    """N3: run_scale_pipeline(n, mesh=mesh) on both routes against M1 and
    M2 in the same run (the same seed): buffered and sharded, M1's edge
    count, boundary and partition (ARI 1.0 between the label vectors),
    peak device memory net of what was live before it under
    M1_LIMIT_BYTES; streaming and sharded (no bootstrap under a mesh: pass
    1, then the exact counts pass and the fill), M2's edge count and
    partition. Then the QC pass and the fixed-boundary fetch at M1's
    boundary through _mesh_compact_pass on the population's planes, equal
    to the single device's (i, j, flags), the fetch holding M1's edges.
    Returns standard launches per part and the mesh's pairs of each pass
    (for phase O1)."""
    from poppunk_tpu_torch import scale, synth
    from poppunk_tpu_torch.utils import decision_boundary, transform_line

    n = m.n
    on_card = device.type == "cuda"
    launches = {}
    for route, want in (("buffered", m.m1), ("streaming", m.m2)):
        t0 = time.perf_counter()
        base = None
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        log = []
        out, seconds, n_launch, kernel_s = counted(
            torch, device, lambda: scale.run_scale_pipeline(
                n=n, mesh=mesh, streaming=route == "streaming",
                log=log.append))
        peak = torch.cuda.max_memory_allocated() - base if on_card else None
        agree = scale.adjusted_rand_index(want["labels"], out["labels"])
        emit({"phase": f"N3_{route}", "n": n, "route": out["route"],
              "stages": out["timings"],
              "refine_parts": out.get("refine_phase_s"),
              "pipeline_s": out["pipeline_s"], "n_edges": out["n_edges"],
              "n_clusters": out["n_clusters"], "ari": out["ari"],
              "ari_vs_single": agree, "s_opt": out["boundary"]["s_opt"],
              "s_opt_single": want["boundary"]["s_opt"],
              "launches": n_launch, "kernel_s": kernel_s,
              "pairs_per_s": out["pairs_per_s"], "base_device_bytes": base,
              "peak_device_bytes": peak, "log": log,
              "seconds": elapsed(torch, t0)})
        if out["route"] != want["route"]:
            raise AssertionError(f"N3 {route}: the {out['route']} sweep, "
                                 f"not {want['route']}")
        if out["n_edges"] != want["n_edges"] or agree != 1.0:
            raise AssertionError(
                f"N3 {route}: {out['n_edges']} edges (single "
                f"{want['n_edges']}), ARI against the single device {agree}")
        np.testing.assert_allclose(out["boundary"]["s_opt"],
                                   want["boundary"]["s_opt"], rtol=1e-4)
        if on_card and route == "buffered" and peak >= M1_LIMIT_BYTES:
            raise AssertionError(f"N3 peak device memory {peak} (net) >= "
                                 f"{M1_LIMIT_BYTES}")
        launches[f"N3_{route}"] = n_launch

    # the compaction passes on the population's planes at M1's boundary
    t0 = time.perf_counter()
    klist, ss64, bbits, chunk = (13, 16, 19, 22, 25, 28), 156, 14, 512
    pop = synth.synthetic_population_device(
        n, klist, ss64, bbits, n_strains=20, seed=2,
        chunk=max(chunk, min(n, 2048)), device=device)
    b = m.m1["boundary"]
    line = b["line"]
    mean0, mean1 = np.array(line[:2]), np.array(line[2:])
    bx, by = decision_boundary(
        transform_line(b["s_opt"], mean0, mean1),
        (mean1[1] - mean0[1]) / (mean1[0] - mean0[0]))
    scale_b = np.asarray(b["scale"])
    ops = (pop.planes, pop.lengths, pop.freqs, klist, ss64, bbits, chunk, n)
    passes = {
        "qc": lambda **kw: scale.qc_bad_pairs_streaming(
            *ops, 0.95 * scale_b[0], 0.95 * scale_b[1], check_zero=False,
            **kw),
        "fetch": lambda **kw: scale.fetch_within_boundary(
            *ops, scale_b, bx, by, 2, **kw)}
    parts, n_launch, pairs = {}, 0, {}
    for name, run in passes.items():
        one, s1, l1, _ = counted(torch, device, lambda: run(device=device))
        got, sm, lm, _ = counted(torch, device, lambda: run(mesh=mesh))
        pairs[name] = got
        n_launch += l1 + lm
        parts[name] = {"pairs": int(len(got[0])), "single_s": s1,
                       "mesh_s": sm, "single_launches": l1,
                       "mesh_launches": lm}
        for a, w in zip(got, one):
            if not np.array_equal(a, w):
                raise AssertionError(f"N3 {name}: the mesh's pairs differ "
                                     "from the single device's")
    emit({"phase": "N3_compact", "n": n, "boundary": [float(bx), float(by)],
          "passes": parts, "m1_edges": m.m1["n_edges"],
          "seconds": elapsed(torch, t0)})
    if parts["fetch"]["pairs"] != m.m1["n_edges"]:
        raise AssertionError(f"N3: the fetch holds {parts['fetch']['pairs']}"
                             f" pairs at M1's boundary, M1 "
                             f"{m.m1['n_edges']} edges")
    launches["N3_compact"] = n_launch
    return launches, pairs


def phase_n(torch, device, workdir, e, m, mesh):
    """N1 (standard kernel), N2 and N3. Returns standard launches per
    stage and N3's pairs of the QC pass and the fetch."""
    launches = {f"N1_{route}": n for route, n in
                phase_n1(torch, device, e, mesh).items()}
    launches["N2"] = phase_n2(torch, device, workdir)
    n3_launches, pairs = phase_n3(torch, device, mesh, m)
    launches.update(n3_launches)
    return launches, pairs


# run_scale_pipeline's defaults: K 6, sketch 9984, 14 planes
M_GEOMETRY = ((13, 16, 19, 22, 25, 28), 156, 14)


def hold_col_tile_to_plain(torch, cd):
    """Kernel 1's plane-major route at a column shard's own operands, bit
    for bit against the plain version on the same device: the last
    shard's cuts of the first and of a middle chunk's two owned tiles
    (_ColShardedStream._cut), each the tile's rows as _rows assembles them
    from the shards that own them against a column view of the shard's
    resident [K, P, n_loc, Wp] planes. At the middle chunk's low cut the
    epilogue kernel too (hold_tile_epilogue), as the tile computes it
    (scale._tile_dists) and as the kNN computes it again on the transposed
    counts, the column genomes as the queries (scale._merge_knn). These
    launches compare; no path counts them. Returns (kernel 1's
    max_abs_err, the plain version's seconds, the operands' shapes)."""
    from poppunk_tpu_torch import scale
    from poppunk_tpu_torch.ops import match_counts as mc

    lay, c = cd._layout, cd.chunk
    d = len(lay.planes) - 1
    shard = lay.planes[d]
    ln, fr = lay._ops[d]
    ops = (cd._klist, cd._ss64, cd._bbits)
    mid = lay.n // 2 // c // 2 * c  # a middle chunk's first row
    err, plain_s, shapes = 0, 0.0, []
    for s in (0, mid):
        for side, (r0, c0, w) in zip(("low", "mirror"), lay._cut(d, s, c)):
            if not w:
                continue
            q = lay._rows(r0, r0 + c, shard.device)
            k = shard[:, :, c0 - d * lay.n_loc:]
            got = mc.match_counts(q, k, cd._pad_bits, plane_major=True)
            t = time.perf_counter()
            want = mc.match_counts_torch(q, k, cd._pad_bits,
                                         plane_major=True)
            plain_s += elapsed(torch, t)
            err = max(err, max_abs_err(got, want))
            shapes.append([list(q.shape), list(k.shape)])
            if err:
                raise AssertionError(
                    f"the plane-major route disagrees with the plain "
                    f"version at the column cut {side} {s} {shapes[-1]}: "
                    f"{err}")
            if (s, side) == (mid, "low"):
                rows, cols = slice(r0, r0 + c), slice(c0, c0 + w)
                hold_tile_epilogue(
                    torch, f"column cut {shapes[-1]}",
                    lambda: scale._tile_dists(q, k, ln[rows], ln[cols],
                                              fr[rows], fr[cols], *ops,
                                              cd._pad_bits),
                    ln[rows], ln[cols], fr[rows], fr[cols], *ops, got, want)
                got_t = got.transpose(0, 1).contiguous()
                hold_tile_epilogue(
                    torch, f"transposed column cut {shapes[-1]}",
                    lambda: scale._epilogue(got_t, cd._klist, ln[cols],
                                            ln[rows], fr[cols], fr[rows],
                                            cd._ss64, cd._bbits),
                    ln[cols], ln[rows], fr[cols], fr[rows], *ops, got_t,
                    want.transpose(0, 1).contiguous())
                del got_t
            del got, want
    return err, plain_s, shapes


def pair_keys(i, j, n):
    """Sorted int64 keys i * n + j of a pair list: equal sets, equal
    arrays."""
    return np.sort(np.asarray(i, np.int64) * n + np.asarray(j, np.int64))


def phase_o(torch, device, mesh, m, n3_pairs):
    """O1 and O2. Returns standard launches per part, and the worst
    difference of the kernel from its plain version at their column
    tiles."""
    launches, err1 = phase_o1(torch, device, mesh, m, n3_pairs)
    launches2, err2 = phase_o2(torch, device, mesh)
    launches.update(launches2)
    return launches, max(err1, err2)


def phase_o1(torch, device, mesh, m, n3_pairs):
    """O1: the column-sharded streaming tier on phase N's mesh at M's
    population (n 20,480 of M_GEOMETRY, 20 strains, seed 2, drawn on the
    card): StreamingCondensed(mesh=, shard_planes=True) with
    run_scale_pipeline's chunk, kNN 5 and its 100,000-pair subsample
    predeclared, against the same pass on the first device alone (M2's
    single-device route): kNN, column maxima and subsample bit for bit.
    Then the BGMM on that subsample and refine_fit_device over the column
    shards (the per-device fills, the device sparse sweep; max_move backed
    off on saturation, as the pipeline does): M2's edge count and
    partition (ARI 1.0 between the label vectors), s_opt within rtol
    1e-4. Then the QC pass and the fixed-boundary fetch at M1's boundary
    through _compact_pass's column arm: N3's pairs as sets (its QC pairs
    in their order too). The chunk is the CLI's at --chunk 512, M2's.
    Kernel 1 is held to its plain version at the column tile's operands
    (hold_col_tile_to_plain). Returns standard launches per part and
    that difference."""
    from poppunk_tpu_torch import scale, synth
    from poppunk_tpu_torch.models.bgmm import BGMMFit
    from poppunk_tpu_torch.utils import decision_boundary, transform_line

    t0 = time.perf_counter()
    n = m.n
    klist, ss64, bbits = M_GEOMETRY
    subsample, seed = 100_000, 2
    pop = synth.synthetic_population_device(
        n, klist, ss64, bbits, n_strains=20, seed=seed,
        chunk=max(512, min(n, 2048)), device=device)
    ops = (pop.planes, pop.lengths, pop.freqs, klist, ss64, bbits)
    kw = dict(chunk=card_chunk(device, n, 512, len(klist)), knn=5,
              subsample=(subsample, seed))
    col, col_s, col_l, col_k = counted(
        torch, device, lambda: scale.StreamingCondensed(
            *ops, mesh=mesh, shard_planes=True, **kw))
    one, one_s, one_l, one_k = counted(
        torch, device, lambda: scale.StreamingCondensed(*ops, device=device,
                                                        **kw))
    sub = col.subsample_pairs(subsample, seed=seed)
    equal = {
        "knn_col": bool(np.array_equal(col.knn_col, one.knn_col)),
        "knn_dist": bool(np.array_equal(col.knn_dist, one.knn_dist)),
        "max_scale": bool(np.array_equal(col.max_scale(),
                                          one.max_scale())),
        "subsample": bool(np.array_equal(
            sub, one.subsample_pairs(subsample, seed=seed)))}
    del one
    tile_err, plain_s, tile_shapes = hold_col_tile_to_plain(torch, col)
    model = BGMMFit("", max_samples=subsample, device=device)
    model.fit(sub, max_components=2)
    mean0 = model.means[model.within_label]
    mean1 = model.means[model.between_label]
    parts, max_move = {}, 0.25

    def refine():
        nonlocal max_move
        while True:
            try:
                return scale.refine_fit_device(
                    col, model.scale, mean0, mean1, max_move=max_move,
                    score_idx=0, seed=seed, timings_out=parts,
                    est_pairs=sub)
            except scale.SweepSaturated:
                if max_move / 4 < 1e-3:
                    raise
                max_move /= 4

    (_, _, s_opt, sweep), ref_s, ref_l, ref_k = counted(torch, device,
                                                         refine)
    labels, n_edges = scale.edge_components_device(
        sweep[1], scale.offset_threshold(s_opt, sweep[-2], 2, *sweep[-1]))
    agree = scale.adjusted_rand_index(m.m2["labels"], labels)
    del sweep, col

    # the compaction passes at M1's boundary, as N3 runs them
    b = m.m1["boundary"]
    line = b["line"]
    bm0, bm1 = np.array(line[:2]), np.array(line[2:])
    bx, by = decision_boundary(
        transform_line(b["s_opt"], bm0, bm1),
        (bm1[1] - bm0[1]) / (bm1[0] - bm0[0]))
    scale_b = np.asarray(b["scale"])
    cops = (*ops, 512, n)
    passes = {
        "qc": lambda: scale.qc_bad_pairs_streaming(
            *cops, 0.95 * scale_b[0], 0.95 * scale_b[1], check_zero=False,
            mesh=mesh, shard_planes=True),
        "fetch": lambda: scale.fetch_within_boundary(
            *cops, scale_b, bx, by, 2, mesh=mesh, shard_planes=True)}
    compact = {}
    for name, run in passes.items():
        got, sec, n_l, k_s = counted(torch, device, run)
        want = n3_pairs[name]
        same = bool(np.array_equal(pair_keys(got[0], got[1], n),
                                   pair_keys(want[0], want[1], n)))
        if name == "qc":
            same &= all(np.array_equal(a, w) for a, w in zip(got, want))
        compact[name] = {"pairs": int(len(got[0])), "seconds": sec,
                         "launches": n_l, "kernel_s": k_s,
                         "n3_pairs_equal": same}
    emit({"phase": "O1", "n": n, "mesh_shape": mesh.shape,
          "chunk": kw["chunk"], "pass1": {
              "column_s": col_s, "column_launches": col_l,
              "column_kernel_s": col_k, "single_s": one_s,
              "single_launches": one_l, "single_kernel_s": one_k},
          "bit_equal": equal, "plane_major_vs_plain": {
              "max_abs_err": tile_err, "plain_s": plain_s,
              "query_and_shard": tile_shapes}, "refine": {
              "seconds": ref_s, "parts": parts, "launches": ref_l,
              "kernel_s": ref_k, "max_move": max_move},
          "n_edges": n_edges, "m2_edges": m.m2["n_edges"],
          "ari_vs_m2": agree, "s_opt": s_opt,
          "s_opt_m2": m.m2["boundary"]["s_opt"], "compact": compact,
          "seconds": elapsed(torch, t0)})
    if not all(equal.values()):
        raise AssertionError(f"O1: the column shards differ from the single "
                             f"device: {equal}")
    if n_edges != m.m2["n_edges"] or agree != 1.0:
        raise AssertionError(f"O1: {n_edges} edges (M2 {m.m2['n_edges']}), "
                             f"ARI against M2 {agree}")
    np.testing.assert_allclose(s_opt, m.m2["boundary"]["s_opt"], rtol=1e-4)
    if not all(c["n3_pairs_equal"] for c in compact.values()):
        raise AssertionError(f"O1: the compaction passes' pairs are not "
                             f"N3's: {compact}")
    return {"O1_pass1": col_l + one_l, "O1_refine": ref_l,
            "O1_compact": sum(c["launches"] for c in compact.values())}, \
        tile_err


def phase_o2(torch, device, mesh, n=131072, n_strains=128, spot=256):
    """O2: pass 1 alone at n genomes of M_GEOMETRY drawn on the card
    (planted_population_on_card, set-up) on phase N's mesh with
    shard_planes="auto", which must take the column shards (the
    replicated planes pass the reference's 8e9 bytes); the chunk is the
    scale CLI's at its default --chunk 256, kNN 5. Reports the
    pass's seconds, launches, kernel event time, full-row (n^2) and
    computed ((n/2)(n + c), the owned tiles') pairs/s, and
    the net peak device memory (from before the shards are copied, the
    drawn planes excluded) against streaming_hbm_accounting's column
    figure for each shard on this card; fails past it. Then ``spot``
    random genomes' kNN are held bit for bit to a single-device full-row
    recompute from the drawn planes (_tile_dists against all n columns,
    the top-k of its _keys), and kernel 1 to its plain version at the
    last shard's cuts of the owned tiles (hold_col_tile_to_plain).
    Returns standard launches and that difference."""
    from poppunk_tpu_torch import scale

    klist, ss64, bbits = M_GEOMETRY
    t0 = time.perf_counter()
    t = time.perf_counter()
    planes, lengths, freqs, _ = planted_population_on_card(
        torch, device, n, n_strains, SEED + 7, ss64=ss64, bbits=bbits,
        klist=klist)
    make_s = elapsed(torch, t)
    n_dev = mesh.size
    chunk = card_chunk(device, n, 256, len(klist))
    on_card = device.type == "cuda"
    base = None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    cd = scale.StreamingCondensed(planes, lengths, freqs, klist, ss64, bbits,
                                  chunk=chunk, knn=5, defer=True, mesh=mesh,
                                  shard_planes="auto")
    shard_s = elapsed(torch, t)
    if not cd._col:
        raise AssertionError(f"O2: shard_planes='auto' kept the row shards "
                             f"at {n} genomes")
    _, pass_s, launches, kernel_s = counted(torch, device, cd.run_pass1)
    peak = torch.cuda.max_memory_allocated() - base if on_card else None
    acct = scale.streaming_hbm_accounting(n, klist, ss64, bbits, chunk, 5,
                                          n_dev, shard_planes=True)
    here = sum(1 for p in cd.planes if p.device == device)
    limit = here * acct["total"]
    t = time.perf_counter()
    idx = np.sort(np.random.default_rng(SEED + 8).choice(n, spot,
                                                         replace=False))
    rows = torch.as_tensor(idx, device=device)
    d = scale._tile_dists(planes[:, :, rows], planes, lengths[rows], lengths,
                          freqs[rows], freqs, klist, ss64, bbits,
                          cd._pad_bits)
    near = d[..., 0]
    near[torch.arange(spot, device=device), rows] = float("inf")  # self
    top_i, top_d = scale._decode(scale._smallest(scale._keys(near), 5))
    spot_equal = bool(np.array_equal(top_i.cpu().numpy(), cd.knn_col[idx])
                      and np.array_equal(top_d.cpu().numpy(),
                                         cd.knn_dist[idx]))
    spot_s = elapsed(torch, t)
    del d, near
    tile_err, plain_s, tile_shapes = hold_col_tile_to_plain(torch, cd)
    emit({"phase": "O2", "n": n, "mesh_shape": mesh.shape, "chunk": chunk,
          "make_data_seconds": make_s, "shard_copy_seconds": shard_s,
          "pass1_seconds": pass_s, "pass1_launches": launches,
          "pass1_kernel_s": kernel_s, "pass1_rest_s": pass_s - kernel_s,
          "full_row_pairs_per_s": n * n / pass_s,
          "computed_pairs_per_s": n // 2 * (n + chunk) / pass_s,
          "replicated_planes_bytes": scale.streaming_hbm_accounting(
              n, klist, ss64, bbits, chunk, 5, n_dev)["planes"],
          "peak_device_bytes": peak, "accounting_per_device": acct,
          "shards_on_this_card": here, "limit_bytes": limit,
          "spot_genomes": spot, "spot_knn_bit_equal": spot_equal,
          "spot_seconds": spot_s, "plane_major_vs_plain": {
              "max_abs_err": tile_err, "plain_s": plain_s,
              "query_and_shard": tile_shapes},
          "seconds": elapsed(torch, t0)})
    if on_card and peak > limit:
        raise AssertionError(f"O2 peak device memory {peak} (net) exceeds "
                             f"the accounting {limit}")
    if not spot_equal:
        raise AssertionError("O2: the column shards' kNN differ from the "
                             "full-row recompute")
    return {"O2_pass1": launches}, tile_err


def phase_p(torch, device, n_comp=100, m=1000, deg=40, n_sources=100,
            m_pad=1024):
    """P: the batched device Brandes (ops/brandes_device.py) at
    bench.py:1306 bench_brandes_ab's shapes: n_comp components of m
    vertices at mean degree ~deg, padded to m_pad, the same n_sources
    sampled sources in each. exact=True is held to the port's native
    engine (network/incremental.brandes_native, OpenMP graph_core.cpp)
    within rtol 1e-5, atol 1e-5 (tests/test_brandes_device.py) on every
    component; exact=False (TF32 products) is timed and its largest
    relative error printed; the native engine's time over the components
    beside them. Device times by CUDA events (host seconds on the CPU
    rehearsal), second of two calls each, the per-level host sync
    included."""
    import scipy.sparse

    from poppunk_tpu_torch.network.incremental import brandes_native
    from poppunk_tpu_torch.ops.brandes_device import brandes_batched_device

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    adj = random_components(rng, n_comp, m, deg)
    sources = rng.choice(m, size=n_sources, replace=False)
    csr = [scipy.sparse.csr_matrix(a) for a in adj]
    t = time.perf_counter()
    native = np.stack([brandes_native(a, sources) for a in csr])
    native_s = time.perf_counter() - t
    dense = np.zeros((n_comp, m_pad, m_pad), np.float32)
    dense[:, :m, :m] = adj
    A = torch.as_tensor(dense, device=device)
    src = torch.as_tensor(np.tile(sources[None], (n_comp, 1)),
                          dtype=torch.int32, device=device)
    out, ms = {}, {}
    for exact in (True, False):
        brandes_batched_device(A, src, exact=exact)
        if device.type == "cuda":
            ms[exact] = event_ms(lambda: out.__setitem__(
                exact, brandes_batched_device(A, src, exact=exact)), 1)
        else:
            t = time.perf_counter()
            out[exact] = brandes_batched_device(A, src, exact=exact)
            ms[exact] = 1e3 * (time.perf_counter() - t)
    got = {k: v[:, :m].double().cpu().numpy() for k, v in out.items()}
    rel = {k: float((np.abs(v - native) / np.maximum(np.abs(native), 1e-30)
                     ).max()) for k, v in got.items()}
    close = bool(np.allclose(got[True], native, rtol=1e-5, atol=1e-5))
    emit({"phase": "P", "components": n_comp, "vertices": m, "padded": m_pad,
          "mean_degree": float(adj.sum() / (n_comp * m)),
          "sources": n_sources, "exact_ms": ms[True], "tf32_ms": ms[False],
          "native_s": native_s, "exact_max_rel_err": rel[True],
          "tf32_max_rel_err": rel[False], "exact_within_tol": close,
          "seconds": time.perf_counter() - t0})
    if not close:
        raise AssertionError(f"P: exact=True differs from the native engine "
                             f"(largest relative error {rel[True]})")


# --------------------------------------------------------------------------
# Q: the bench's headline
# --------------------------------------------------------------------------

def phase_q(torch, device):
    """Q: the port's bench headline (poppunk_tpu_torch/bench.py, what
    ``python -m poppunk_tpu_torch.bench`` prints first) in this process:
    its record on a line of its own, then its checks: the card, a ceiling
    fraction in (0, 1.05], a 64 x 128 corner of its (core, accessory)
    against the plain match counts and the same epilogue within DIST_TOL,
    and the g++ CPU baseline's counts at 64 x 128 equal to the plain
    version's bit for bit. Returns ({"Q": launches}, None)."""
    from poppunk_tpu_torch import bench
    from poppunk_tpu_torch.ops import match_counts as mc
    from poppunk_tpu_torch.ops.distances import (core_accessory,
                                                 corrected_jaccards)

    t0 = time.perf_counter()
    record, ctx = bench.headline(device)
    print(json.dumps(record), flush=True)
    if record["backend"] != "cuda":
        raise AssertionError(f"Q: the headline ran on {record['backend']}")
    if not 0 < record["ceiling_frac"] <= 1.05:
        raise AssertionError(f"Q: ceiling_frac {record['ceiling_frac']}")
    (pq, lq, fq), (pr, lr, fr) = ctx.qry, ctx.ref
    counts = mc.match_counts_torch(pq[:64], pr[:128], ctx.pad_bits)
    want = core_accessory(corrected_jaccards(
        counts, bench.KLIST, lq[:64], lr[:128], fq[:64], fr[:128],
        bench.SS64, bench.BBITS, True, True), bench.KLIST)
    got = ctx.dists[:64, :128].cpu().numpy()
    np.testing.assert_allclose(got, want.cpu().numpy(), **DIST_TOL)
    record_epilogue_hold("Q corner 64 x 128", float(np.abs(
        got - want.cpu().numpy()).max()))
    _, cpu_counts = bench.cpu_baseline(ctx.planes64, 64, 128)
    if not np.array_equal(cpu_counts, counts.cpu().numpy()):
        raise AssertionError("Q: the CPU baseline's counts differ from the "
                             "plain version's")
    emit({"phase": "Q", "value": record["value"],
          "ceiling_frac": record["ceiling_frac"],
          "vs_baseline": record["vs_baseline"],
          "corner_max_abs_diff": float(np.abs(
              got - want.cpu().numpy()).max()),
          "baseline_counts_equal": True, "launches": record["launches"],
          "seconds": elapsed(torch, t0)})
    return {"Q": record["launches"]}, None


# --------------------------------------------------------------------------

def all_vs_all_routes(torch, device, e):
    """Phase E's all-vs-all (condensed_self_block over its references)
    with pairwise_block's automatic mesh (every card from 65,536 pairs a
    chunk) and with the mesh turned off (``ops/distances._auto_mesh``
    replaced for the call), each twice, in turns; fails unless the rows
    are equal bit for bit."""
    from poppunk_tpu_torch.ops import distances

    ss64, bbits = PRODUCTION[:2]
    args = (e.planes[:e.n_ref], e.lengths[:e.n_ref], e.freqs[:e.n_ref],
            KLIST, ss64, bbits)
    auto = distances._auto_mesh
    seconds, rows = {"auto": [], "one_card": []}, {}
    for route in ("auto", "one_card", "one_card", "auto"):
        distances._auto_mesh = (auto if route == "auto"
                                else lambda device, n_pairs: None)
        try:
            t = time.perf_counter()
            rows[route] = distances.condensed_self_block(*args,
                                                         device=device)
            sync_all(torch)
            seconds[route].append(time.perf_counter() - t)
        finally:
            distances._auto_mesh = auto
    equal = bool(np.array_equal(rows["auto"], rows["one_card"]))
    emit({"phase": "E_all_vs_all_routes", "genomes": int(e.n_ref),
          "cards": torch.cuda.device_count(), "seconds": seconds,
          "bit_equal": equal})
    if not equal:
        raise AssertionError("the all-vs-all rows differ between routes")


def mesh_only(torch, device):
    """``--mesh-only``: phases N and O1 with what they read (phase E's
    population, M1's and M2's pipelines at 20,480 as the single-device
    results), for a run over several cards. Prints each part's launches;
    no kernel line."""
    from poppunk_tpu_torch import scale
    from poppunk_tpu_torch.ops import match_counts as mc

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        _, e = phase_e(torch, device, workdir)
        all_vs_all_routes(torch, device, e)
        n = 20480
        t0 = time.perf_counter()
        m1 = scale.run_scale_pipeline(n=n, device=device, log=lambda m: None)
        m2 = scale.run_scale_pipeline(n=n, streaming=True, device=device,
                                      log=lambda m: None)
        emit({"phase": "M_single", "m1_stages": m1["timings"],
              "m2_stages": m2["timings"], "m1_edges": m1["n_edges"],
              "m2_edges": m2["n_edges"], "seconds": elapsed(torch, t0)})
        m = SimpleNamespace(n=n, m1=m1, m2=m2)
        mesh, kind = card_mesh(device)
        emit({"phase": "N", "mesh": kind, "shape": mesh.shape,
              "devices": [str(dev) for dev in mesh.flat()]})
        mc.LAUNCHES = mc.PACKED_LAUNCHES = 0
        n_launches, n3_pairs = phase_n(torch, device, workdir, e, m, mesh)
        emit({"phase": "N_launches", "kernel": "standard",
              "stages": n_launches})
        mc.KERNEL_CHOICE = "packed"
        emit({"phase": "N_launches", "kernel": "packed",
              "stages": phase_n1(torch, device, e, mesh)})
        mc.KERNEL_CHOICE = "standard"
        mc.LAUNCHES = mc.PACKED_LAUNCHES = 0
        emit({"phase": "O_launches", "kernel": "standard",
              "stages": phase_o1(torch, device, mesh, m, n3_pairs)[0]})


def main():
    import torch

    if sys.argv[1:2] == ["--n2-worker"]:
        rank, port, out, dev, nq, nr = sys.argv[2:8]
        return n2_worker(int(rank), int(port), out, dev, (int(nq), int(nr)))
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke.py: torch.cuda.is_available() is False; "
                         "this script measures the port on a CUDA card\n")
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_h5py_standin import install_h5py

    from poppunk_tpu_torch.ops import distances as dd
    from poppunk_tpu_torch.ops import match_counts as mc

    h5 = install_h5py()

    device = torch.device("cuda", 0)
    smi = phase_a(torch)
    instantiations = phase_b()
    if sys.argv[1:] == ["--mesh-only"]:
        mesh_only(torch, device)
        print(smi, flush=True)
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    kernels = phase_c(torch, device)
    kernels["dist_epilogue"] = phase_c2(torch, device, instantiations)
    l0_err, _ = phase_l0(torch, device)
    kernels["match_counts"]["max_abs_err"] = max(
        kernels["match_counts"]["max_abs_err"], l0_err)

    # each path runs with the launch counts set to 0 just before it; the
    # phase reads its kernel's count just after it (before any spot check
    # of its own, whose comparison launches count in no path). The
    # epilogue's count is read after the path as a whole: its holds at the
    # route's operands restore the counts (uncounted)
    launches = {"match_counts": 0, "match_counts_packed": 0,
                "dist_epilogue": 0}

    def path(name, run, kernel, other):
        mc.LAUNCHES = mc.PACKED_LAUNCHES = dd.EPILOGUE_LAUNCHES = 0
        stages, ctx = run()
        if not isinstance(stages, dict):
            stages = {name: stages}
        if min(stages.values()) < 1:
            raise AssertionError(f"phase {name} stages skipped {kernel}: "
                                 f"{stages}")
        if getattr(mc, other):
            raise AssertionError(f"phase {name} launched the other kernel "
                                 f"({other} = {getattr(mc, other)})")
        if dd.EPILOGUE_LAUNCHES < 1:
            raise AssertionError(f"phase {name} computed distances without "
                                 f"the epilogue kernel")
        launches[kernel] += sum(stages.values())
        launches["dist_epilogue"] += dd.EPILOGUE_LAUNCHES
        emit({"path": name, "dist_epilogue_launches": dd.EPILOGUE_LAUNCHES})
        return ctx

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        std = ("match_counts", "PACKED_LAUNCHES")
        packed = ("match_counts_packed", "LAUNCHES")
        d = path("D", lambda: phase_d(torch, device, workdir,
                                      h5py_version=h5), *std)
        e = path("E", lambda: phase_e(torch, device, workdir), *std)
        mc.KERNEL_CHOICE = "packed"
        path("F", lambda: (phase_f(torch, device, workdir, d), None),
             *packed)
        path("G", lambda: (phase_g(torch, device, workdir, e), None),
             *packed)
        mc.KERNEL_CHOICE = "standard"
        path("H", lambda: (phase_h(torch, device, workdir, d), None), *std)
        path("I", lambda: (phase_i(torch, device, workdir, e), None), *std)
        j = path("J", lambda: phase_j(torch, device, workdir, d, e), *std)
        path("K", lambda: (phase_k(torch, device, workdir, d, e, j.db),
                           None), *std)
        lctx = path("L", lambda: phase_l(torch, device, workdir, d, e),
                    *std)
        path("L4", lambda: phase_l4(torch, device, workdir, d, e, lctx),
             *std)
        del lctx
        m = path("M", lambda: phase_m(torch, device, workdir, d), *std)
        kernels["match_counts"]["max_abs_err"] = max(
            kernels["match_counts"]["max_abs_err"], m.kernel_err)
        mesh, kind = card_mesh(device)
        emit({"phase": "N", "mesh": kind, "shape": mesh.shape,
              "devices": [str(dev) for dev in mesh.flat()]})
        n3_pairs = path("N", lambda: phase_n(torch, device, workdir, e, m,
                                             mesh), *std)
        mc.KERNEL_CHOICE = "packed"
        path("N_packed", lambda: ({
            f"N1_packed_{route}": n for route, n in
            phase_n1(torch, device, e, mesh).items()}, None), *packed)
        mc.KERNEL_CHOICE = "standard"
        o_err = path("O", lambda: phase_o(torch, device, mesh, m,
                                          n3_pairs), *std)
        kernels["match_counts"]["max_abs_err"] = max(
            kernels["match_counts"]["max_abs_err"], o_err)
        del n3_pairs
        path("Q", lambda: phase_q(torch, device), *std)
    phase_p(torch, device)
    # the card's host has jax installed: an import of it or of the JAX
    # package anywhere on the paths above would go unnoticed but for this
    loaded = sorted(m for m in sys.modules if m in ("jax", "poppunk_tpu")
                    or m.startswith(("jax.", "poppunk_tpu.")))
    if loaded:
        raise AssertionError(f"the port loaded {loaded}")
    epilogue = kernels["dist_epilogue"]
    for _, dist_err, jac_err in EPILOGUE_HOLDS:
        epilogue["max_abs_err"] = max(epilogue["max_abs_err"], dist_err)
        epilogue["jaccard_max_abs_err"] = max(
            epilogue["jaccard_max_abs_err"], jac_err)
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"poppunk_tpu_torch/csrc/{name}.cu",
        "replaces": replaces, "launches": launches[name],
        **{key: kernels[name][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "sm_clock_mhz")},
        **({"jaccard_max_abs_err": epilogue["jaccard_max_abs_err"],
            "route_holds": len(EPILOGUE_HOLDS)} if name == "dist_epilogue"
           else {})}
        for name, replaces in (
            ("match_counts", "poppunk_tpu/ops/pallas_jaccard.py:76"),
            ("match_counts_packed",
             "poppunk_tpu/ops/pallas_jaccard.py:229"),
            ("dist_epilogue", "poppunk_tpu/ops/distances.py:192"))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
