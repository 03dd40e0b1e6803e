"""poppunk_tpu_torch_scale — fit a sketch database of any size with bounded
memory.

Counterpart of poppunk_tpu/cli/scale.py (``poppunk_tpu_scale``), with a copy
of its parser. The condensed distance matrix is never built, on the host
or the card: sketches are packed plane-major and stay resident on the
card, and every pass recomputes distances chunk by chunk
(poppunk_tpu_torch/scale.py). Outputs keep the reference's conventions so
the fitted database drops into ``poppunk_tpu_torch_assign``:

  <out>/<out>_fit.pkl / _fit.npz   refine-model artefacts
  <out>/<out>_graph.graph.npz      within-strain network
  <out>/<out>_clusters.csv         strain assignments
  <out>/<out>.dists.pkl            name order (no .npy: the condensed
                                   matrix is deliberately never written)
  <out>/<out>_lineages.csv         (--write-lineages) per-rank lineage
  <out>_lineages/                  assignments + a LineageFit model
                                   directory from the fused kNN

What it runs: a BGMM or DBSCAN start model fit on the pair subsample, the
two-round bootstrap (the refine band's edge fill rides the single distance
pass), the constrained refine (the device sparse sweep for --score-idx 0,
the native host scorer for 1 and 2) or the unconstrained 2-D one
(--unconstrained: one counts pass over the 20 x 20 grid, one fetch of the
scoreable cells' union, the host scorer per grid row), --multi-boundary,
--indiv-refine, --no-local, --write-lineages, --extract-references,
--mandrake (a second streaming pass for the accessory kNN, then the SCE),
--run-qc (sketch QC and one streaming distance-QC pass before the fit) and
--use-model (a refine or threshold boundary applied in one streaming
pass). With more than one card the streaming passes are row-sharded over
every card (parallel.mesh, scale.py's row-sharded mesh) once the
population has at least 4 * cards * chunk genomes, as in the reference;
--single-device turns the mesh off. Every pass asks for
``shard_planes="auto"``: on a mesh whose replicated planes would pass 8e9
bytes a card, and whose genomes divide over its cards, the planes are
split over the genome axis instead (scale.py's column-sharded mesh, each
card computing its cut of every chunk's owned tiles), with the same
results.

The distance passes and the sweeps run on ``cuda:<--deviceid>``, and the
start model too, unless ``POPPUNK_TPU_TORCH_DEVICE=cpu`` asks for the CPU;
``--gpu-dist`` / ``--gpu-model`` keep their stage on the card even then.
"""

import argparse
import os
import shutil
import sys
import time

import numpy as np

from .. import __version__, _device
from ..utils import create_overall_lineage, db_h5_path, store_pickle
from .common import default_dists, file_base, setup_output


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_scale",
        description="Streaming-tier model fit: any population size, "
                    "no O(n^2) memory anywhere, in PyTorch on a CUDA card",
    )
    io_group = parser.add_argument_group("Input/output")
    io_group.add_argument("--ref-db", required=True,
                          help="Prefix of a built sketch database "
                               "(poppunk_tpu --create-db)")
    io_group.add_argument("--output", required=True,
                          help="Prefix for output files")
    io_group.add_argument("--external-clustering",
                          help="File with cluster definitions or other labels")
    io_group.add_argument("--use-model", action="store_true",
                          help="Apply an existing refine/threshold model "
                               "instead of fitting (a single streaming "
                               "pass builds the network)")
    io_group.add_argument("--model-dir",
                          help="Directory containing the model for "
                               "--use-model (default: --ref-db)")

    model_group = parser.add_argument_group("Model fit")
    model_group.add_argument("--fit-model", choices=["bgmm", "dbscan"],
                             default="bgmm",
                             help="Start model for the boundary refinement "
                                  "(the reference's dbscan is also fit on "
                                  "a <=100k-pair subsample regardless of "
                                  "N, PopPUNK/models.py:246-254, so both "
                                  "starts stream at any scale)")
    model_group.add_argument("--model-subsample", type=int, default=100000,
                             help="Maximum pairs in the start-model fit "
                                  "subsample (BGMM or HDBSCAN)")
    model_group.add_argument("--K", type=int, default=2,
                             help="Maximum number of mixture components")
    model_group.add_argument("--D", type=int, default=100,
                             help="Maximum number of clusters in DBSCAN "
                                  "fitting")
    model_group.add_argument("--min-cluster-prop", type=float,
                             default=0.0001,
                             help="Minimum proportion of points in a "
                                  "DBSCAN cluster")
    model_group.add_argument("--pos-shift", type=float, default=0.0,
                             help="Maximum boundary movement past the "
                                  "between-strain mean (reference default)")
    model_group.add_argument("--neg-shift", type=float, default=0.0,
                             help="Maximum boundary movement before the "
                                  "within-strain mean")
    model_group.add_argument("--score-idx", type=int, default=0,
                             choices=[0, 1, 2])
    model_group.add_argument("--indiv-refine",
                             choices=["both", "core", "accessory"],
                             default=None,
                             help="Also refine core-only / accessory-only "
                                  "boundaries (extra streaming sweeps)")
    refine_mode = model_group.add_mutually_exclusive_group()
    refine_mode.add_argument("--unconstrained", action="store_true",
                             help="Optimise the boundary over the full "
                                  "2-D grid instead of the mean0-mean1 "
                                  "line (one extra streaming pass)")
    refine_mode.add_argument("--multi-boundary", type=int, default=0,
                             help="Produce cluster outputs at this many "
                                  "boundary positions from the origin to "
                                  "the optimum")
    model_group.add_argument("--no-local", action="store_true",
                             help="Skip the local boundary refinement "
                                  "step")
    model_group.add_argument("--betweenness-sample", type=int, default=100)
    model_group.add_argument("--summary-sample", type=int, default=None,
                             help="Subsample this many vertices for the "
                                  "network summary")
    model_group.add_argument("--max-sweep-fetch", type=int,
                             default=40_000_000,
                             help="Host-fetch cap: sweep offsets holding "
                                  "more pairs than this are scored worst "
                                  "instead of fetched (the on-device "
                                  "sparse sweep budgets its own larger "
                                  "cap from free HBM)")
    model_group.add_argument("--seed", type=int, default=42)

    lineage_group = parser.add_argument_group("Lineages (fused kNN)")
    lineage_group.add_argument("--write-lineages", action="store_true",
                               help="Write per-rank lineage clusters AND "
                                    "a LineageFit model directory "
                                    "(<output>_lineages) from the kNN "
                                    "fused into the distance pass")
    lineage_group.add_argument("--ranks", default="1,2,3")
    lineage_group.add_argument("--count-unique-distances",
                               action="store_true")
    lineage_group.add_argument("--reciprocal-only", action="store_true")
    lineage_group.add_argument("--use-accessory", action="store_true")

    viz_group = parser.add_argument_group("Embedding")
    viz_group.add_argument("--mandrake", action="store_true",
                           help="SCE embedding from a streamed accessory "
                                "kNN (no square accessory matrix — the "
                                "reference's mandrake needs one)")
    viz_group.add_argument("--perplexity", type=float, default=30.0)
    viz_group.add_argument("--mandrake-iter", type=int, default=100000)

    qc_group = parser.add_argument_group("Quality control")
    qc_group.add_argument("--run-qc", action="store_true",
                          help="Sketch QC + streaming distance QC before "
                               "the fit (no O(n^2) memory)")
    qc_group.add_argument("--qc-keep", action="store_true",
                          help="Report failing samples but keep them")
    qc_group.add_argument("--retain-failures", action="store_true")
    qc_group.add_argument("--strand-preserved", action="store_true",
                          help="The database was built strand-preserved "
                               "(affects the QC random-match refit)")
    qc_group.add_argument("--max-a-dist", type=float, default=None)
    qc_group.add_argument("--max-pi-dist", type=float, default=None)
    qc_group.add_argument("--max-zero-dist", type=float, default=None)
    qc_group.add_argument("--length-sigma", type=int, default=None)
    qc_group.add_argument("--length-range", nargs=2, type=int,
                          default=[None, None])
    qc_group.add_argument("--prop-n", type=float, default=None)
    qc_group.add_argument("--upper-n", type=int, default=None)

    tuning = parser.add_argument_group("Device tuning")
    tuning.add_argument("--chunk", type=int, default=256,
                        help="Folded rows per streaming step (the "
                             "population pads to a chunk multiple; pads "
                             "are exactly masked)")
    tuning.add_argument("--knn", type=int, default=5,
                        help="Neighbours accumulated by the fused kNN")
    tuning.add_argument("--single-device", action="store_true",
                        help="Do not shard the streaming passes over the "
                             "device mesh")
    tuning.add_argument("--extract-references", action="store_true",
                        help="Clique-prune references after clustering "
                             "(host-side; can dominate at 10^5 genomes)")
    tuning.add_argument("--refs-mode", choices=["full", "fast"],
                        default="full",
                        help="Reference extraction mode: 'fast' samples "
                             "one reference per component (the "
                             "reference's fastPrune / --update-db fast, "
                             "network.py:222-261) instead of the exact "
                             "clique recursion")

    other = parser.add_argument_group("Other")
    other.add_argument("--threads", type=int, default=1)
    other.add_argument("--no-plot", action="store_true")
    other.add_argument("--version", action="version",
                       version="%(prog)s " + __version__)

    from .common import add_accel_compat_flags

    add_accel_compat_flags(parser, "gpu-dist", "gpu-model", "gpu-graph",
                           "deviceid")
    return parser.parse_args(arg_list)


# per-step transient budget of the reference's chunk choice (its 16 GB
# device), scaled on a card by its memory (sparse_sweep.device_hbm_total)
_CHUNK_BUDGET = 2.5e9


def _pad_geometry(n_real, chunk, n_devices, use_mesh, n_kmers=6,
                  budget=_CHUNK_BUDGET):
    """(chunk, n_pad, mesh or None) honouring the folded layout's
    divisibility: n_pad/2 must divide by chunk (and by the device count
    when sharded). Pads are zero-sketch genomes masked exactly via n_real.
    ``budget`` bounds a step's transients, ~16 bytes * 2c * n * K across
    the count, correction and fit buffers. The mesh (every card,
    parallel.mesh.get_mesh()) is taken when asked for, with more than one
    device and at least 4 * n_devices * chunk genomes, the reference's
    rule; the population then pads to 2 * chunk * n_devices."""
    c = int(chunk)
    c_budget = max(32, int(budget / (2 * max(n_real, 2) * n_kmers * 16)))
    while c > 32 and c > c_budget:
        c //= 2
    while c > 1 and 2 * c > max(n_real, 2):
        c //= 2
    mesh = None
    if use_mesh and n_devices > 1 and n_real >= 4 * n_devices * c:
        from ..parallel.mesh import get_mesh

        mesh = get_mesh()
        gran = 2 * c * n_devices
    else:
        gran = 2 * c
    n_pad = -(-n_real // gran) * gran
    return c, n_pad, mesh


def _chunk_geometry(n_real, args, klist, device):
    """_pad_geometry at ``device``'s budget (the reference's per-step
    budget scaled by the card's memory, sparse_sweep.device_hbm_total),
    over the default mesh's devices when ``device`` is one of them and
    --single-device is not set."""
    from ..ops.sparse_sweep import HBM_TOTAL, device_hbm_total
    from ..parallel.mesh import visible_devices

    devices = visible_devices()
    return _pad_geometry(
        n_real, args.chunk, len(devices) if device in devices else 1,
        not args.single_device, n_kmers=len(klist),
        budget=_CHUNK_BUDGET * device_hbm_total(device) / HBM_TOTAL)


def main(arg_list=None):
    args = get_options(arg_list)
    if args.unconstrained and args.indiv_refine:
        sys.stderr.write(
            "Unconstrained optimization and indiv-refine incompatible\n")
        sys.exit(1)
    dist_device, model_device = _device.stage_devices(args)

    from ..io.hdf5db import read_db_params, read_sketches
    from ..models.bgmm import BGMMFit
    from ..models.refine import RefineFit
    from ..ops.distances import pack_planes
    from ..scale import StreamingCondensed, refine_fit_device

    ref_db = args.ref_db.rstrip("/")
    output = setup_output(args.output)
    ranks = sorted(int(x) for x in args.ranks.split(","))
    if args.write_lineages and min(ranks) < 1:
        # fail NOW, not after the long fit (the reference validates rank
        # 0 at startup, __main__.py)
        sys.stderr.write("Rank must be at least 1\n")
        sys.exit(1)
    knn = args.knn
    if args.write_lineages:
        # the standard lineage search depth (reference __init__.py
        # SEARCH_DEPTH_FACTOR), so the written LineageFit model matches
        # a from-scratch fit
        from .. import SEARCH_DEPTH_FACTOR

        knn = max(knn, max(int(SEARCH_DEPTH_FACTOR * max(ranks)), 25))

    klist, _, _ = read_db_params(ref_db)
    sketches = read_sketches(ref_db)  # sorted-name order (the reference's
    # readRfile convention, so .dists.pkl matches assign's expectations)
    names = [sk.name for sk in sketches]
    if args.run_qc:
        names, sketches = _run_qc(args, ref_db, output, names, sketches,
                                  klist, dist_device)
    n_real = len(names)
    n_pairs = n_real * (n_real - 1) // 2
    if n_real < 3:
        sys.stderr.write("Need at least 3 samples to fit a model\n")
        sys.exit(1)
    if args.write_lineages and max(ranks) >= n_real:
        sys.stderr.write(
            f"Maximum rank ({max(ranks)}) must be less than the number "
            f"of samples ({n_real})\n")
        sys.exit(1)
    if args.use_model:
        return _use_model(args, ref_db, output, names, sketches, klist,
                          dist_device, model_device)
    sys.stderr.write(
        f"Streaming fit: {n_real} genomes, {n_pairs} pairs, "
        f"k = {list(map(int, klist))}\n")

    chunk, n_pad, mesh = _chunk_geometry(n_real, args, klist, dist_device)
    if mesh is not None:
        sys.stderr.write(
            f"Sharding streaming passes over {mesh.size} devices\n")

    t0 = time.perf_counter()
    planes, lengths, freqs = pack_planes(sketches, klist, plane_major=True,
                                         pad_to=n_pad)
    subsample = min(args.model_subsample, n_pairs)
    # two-round bootstrap (single device, score_idx 0, constrained): fit
    # the start model on directly computed subsample distances first, then
    # fuse the refine band's edge fill into the single streaming pass
    # (scale.plan_sweep_band)
    bootstrap = (mesh is None and args.score_idx == 0
                 and not args.unconstrained
                 and os.environ.get("POPPUNK_TPU_BOOTSTRAP", "1") != "0")
    cd = StreamingCondensed(
        planes, lengths, freqs, klist, sketches[0].sketchsize64,
        sketches[0].bbits, chunk=chunk, knn=knn,
        dist_col=1 if args.use_accessory else 0,
        subsample=(None if bootstrap else (subsample, args.seed)),
        n_real=n_real, defer=bootstrap, device=dist_device, mesh=mesh,
        shard_planes="auto")
    del planes
    if cd._col:
        sys.stderr.write("Column-sharded planes over the mesh "
                         "(replicated residency would crowd HBM)\n")
    if not bootstrap:
        dt = time.perf_counter() - t0
        sys.stderr.write(
            f"Distances: {n_pairs} pairs in {dt:.1f}s "
            f"({n_pairs / max(dt, 1e-9) / 1e6:.1f} Mpairs/s; kNN k={knn} "
            f"fused; no O(n^2) tensor)\n")

    # name-order pickle so downstream tools resolve indices; the condensed
    # .npy is deliberately absent (reference assign stopped requiring it
    # in 2.7.0)
    store_pickle(names, names, True, None, default_dists(output))

    t0 = time.perf_counter()
    sub = cd.subsample_pairs(subsample, seed=args.seed)
    if args.fit_model == "dbscan":
        # reference semantics: dbscan is the default refine initialiser
        # and its fit subsamples to <=100k pairs at ANY population size
        # (PopPUNK/__main__.py:502-633, dbscan.py:54-60)
        from ..models.dbscan import DBSCANFit

        start = DBSCANFit("", max_samples=subsample, seed=args.seed,
                          assign_points=False, device=model_device)
        start.fit(sub, args.D, args.min_cluster_prop)
        mean0 = start.cluster_means[start.within_label]
        mean1 = start.cluster_means[start.between_label]
        sys.stderr.write(
            f"DBSCAN start model ({start.n_clusters} clusters) on "
            f"{start.subsampled_X.shape[0]} subsampled pairs in "
            f"{time.perf_counter() - t0:.1f}s\n")
    else:
        start = BGMMFit("", max_samples=subsample, seed=args.seed,
                        device=model_device)
        start.fit(sub, max_components=args.K)
        mean0 = start.means[start.within_label]
        mean1 = start.means[start.between_label]
        sys.stderr.write(
            f"BGMM start model on {sub.shape[0]} subsampled pairs in "
            f"{time.perf_counter() - t0:.1f}s\n")

    if bootstrap:
        from ..scale import SweepSaturated, plan_sweep_band

        try:
            fill_spec = plan_sweep_band(
                cd, start.scale, mean0, mean1, max_move=args.pos_shift,
                min_move=args.neg_shift,
                max_sweep_fetch=args.max_sweep_fetch, est_pairs=sub)
        except SweepSaturated:
            # refine below will surface the same geometry error with
            # exact counts; run the plain pass so it can
            fill_spec = None
        t0 = time.perf_counter()
        cd.run_pass1(fill_spec)
        dt = time.perf_counter() - t0
        sys.stderr.write(
            f"Distances: {n_pairs} pairs in {dt:.1f}s "
            f"({n_pairs / max(dt, 1e-9) / 1e6:.1f} Mpairs/s; kNN k={knn}"
            f"{' and refine band fill' if fill_spec else ''} fused; "
            f"no O(n^2) tensor)\n")

    t0 = time.perf_counter()
    if args.unconstrained:
        from ..scale import refine_fit_device_2d

        opt_x, opt_y, sweep = refine_fit_device_2d(
            cd, start.scale, mean0, mean1, max_move=args.pos_shift,
            min_move=args.neg_shift, score_idx=args.score_idx,
            betweenness_sample=args.betweenness_sample, seed=args.seed,
            max_sweep_fetch=args.max_sweep_fetch, no_local=args.no_local)
        s_opt = None
    else:
        opt_x, opt_y, s_opt, sweep = refine_fit_device(
            cd, start.scale, mean0, mean1, max_move=args.pos_shift,
            min_move=args.neg_shift, score_idx=args.score_idx,
            betweenness_sample=args.betweenness_sample, seed=args.seed,
            max_sweep_fetch=args.max_sweep_fetch, no_local=args.no_local,
            est_pairs=sub, prefill=cd.pop_prefill())
    sys.stderr.write(
        f"Refined boundary: core {opt_x * start.scale[0]:.6f}, "
        f"accessory {opt_y * start.scale[1]:.6f} "
        f"in {time.perf_counter() - t0:.1f}s\n")

    if args.multi_boundary > 1:
        from ..scale import multi_refine_device

        sys.stderr.write("Creating multiple boundary fits\n")
        multi_refine_device(
            cd, start.scale, mean0, mean1, s_opt, args.multi_boundary,
            output, names, score_idx=args.score_idx,
            betweenness_sample=args.betweenness_sample, seed=args.seed,
            max_sweep_fetch=args.max_sweep_fetch)

    model = RefineFit(output, seed=args.seed, device=model_device)
    model.scale = np.copy(start.scale)
    model.mean0, model.mean1 = mean0, mean1
    model.min_move, model.max_move = args.neg_shift, args.pos_shift
    model.optimal_x, model.optimal_y = opt_x, opt_y
    model.core_boundary, model.accessory_boundary = opt_x, opt_y
    model.fitted = True
    model.indiv_fitted = False
    model.unconstrained = args.unconstrained

    # core-only / accessory-only refits (PopPUNK/models.py:923-948) —
    # the same streaming sweep at slope 0 / 1
    indiv_sweeps = {}
    if args.indiv_refine is not None:
        try:
            for dist_type, slope in (("core", 0), ("accessory", 1)):
                if args.indiv_refine not in ("both", dist_type):
                    continue
                sys.stderr.write(
                    f"Refining {dist_type} distances separately\n")
                ix, iy, i_s, i_sweep = refine_fit_device(
                    cd, start.scale, mean0, mean1, max_move=args.pos_shift,
                    min_move=args.neg_shift, score_idx=args.score_idx,
                    betweenness_sample=args.betweenness_sample,
                    seed=args.seed, max_sweep_fetch=args.max_sweep_fetch,
                    slope=slope, no_local=args.no_local, est_pairs=sub)
                if dist_type == "core":
                    model.core_boundary = ix
                else:
                    model.accessory_boundary = iy
                indiv_sweeps[dist_type] = (i_sweep, i_s, slope)
            model.indiv_fitted = True
        except RuntimeError as e:
            indiv_sweeps = {}
            sys.stderr.write(
                f"{e}\nCould not separately refine core and accessory "
                "boundaries. Using joint 2D refinement only.\n")

    model.save()
    if not args.no_plot:
        try:
            model.plot(sub)
        except Exception as e:  # plotting must never kill the pipeline
            sys.stderr.write(f"Plotting failed: {e}\n")

    clusters = _network_and_clusters(cd, sweep, s_opt, names, output, args,
                                     boundary=(opt_x, opt_y))
    for dist_type, (i_sweep, i_s, slope) in indiv_sweeps.items():
        _network_and_clusters(cd, i_sweep, i_s, names, output, args,
                              suffix="_" + dist_type, slope=slope)

    if args.write_lineages:
        _write_lineages(cd, ranks, names, output, args)

    if args.mandrake:
        # a second pass over cd's resident planes: no second upload
        _mandrake_embedding(args, cd, names, output, model_device)

    if args.extract_references:
        _extract_refs(clusters, names, ref_db, output, args)

    ref_h5 = db_h5_path(ref_db)
    out_h5 = db_h5_path(output)
    if os.path.isfile(ref_h5) and not os.path.exists(out_h5):
        shutil.copy(ref_h5, out_h5)
    sys.stderr.write("Done\n")
    return model


def _use_model(args, ref_db, output, names, sketches, klist, dist_device,
               model_device):
    """--use-model: apply an existing refine/threshold boundary to this
    database with ONE streaming pass (the reference's --use-model
    re-assigns the full host matrix, __main__.py:520-545). Writes the
    same artefacts as a fit: _fit copies, _graph, _clusters.csv,
    .dists.pkl. The model may have been written by either package."""
    from ..models import load_cluster_fit
    from ..network.clusters import print_clusters
    from ..network.graph import Graph, save_network
    from ..network.summary import print_network_summary
    from ..ops.distances import pack_planes
    from ..scale import fetch_within_boundary

    model_dir = (args.model_dir or ref_db).rstrip("/")
    model = load_cluster_fit(file_base(model_dir) + "_fit.pkl",
                             file_base(model_dir) + "_fit.npz",
                             out_prefix=output, device=model_device)
    if model.type != "refine":
        sys.stderr.write(
            "poppunk_tpu_torch_scale --use-model streams refine/threshold "
            f"boundaries; a '{model.type}' model needs the standard "
            "poppunk_tpu_torch --use-model (host distances)\n")
        sys.exit(1)
    if model.threshold:
        slope, bx, by = 0, model.core_boundary, 0.0
    else:
        slope, bx, by = model.slope, model.optimal_x, model.optimal_y
    n = len(names)
    for flag, val in (("--write-lineages", args.write_lineages),
                      ("--mandrake", args.mandrake),
                      ("--extract-references", args.extract_references),
                      ("--indiv-refine", args.indiv_refine)):
        if val:
            sys.stderr.write(
                f"WARNING: {flag} is ignored with --use-model (the "
                "boundary pass skips the kNN/fit stages those need)\n")
    sys.stderr.write(
        f"Applying existing boundary to {n} genomes "
        f"({n * (n - 1) // 2} pairs, one streaming pass)\n")

    t0 = time.perf_counter()
    chunk, n_pad, mesh = _chunk_geometry(n, args, klist, dist_device)
    planes, lengths, freqs = pack_planes(sketches, klist, plane_major=True,
                                         pad_to=n_pad)
    i, j = fetch_within_boundary(
        planes, lengths, freqs, klist, sketches[0].sketchsize64,
        sketches[0].bbits, chunk, n, model.scale, bx, by, slope,
        max_fetch=max(args.max_sweep_fetch, 100_000_000),
        device=dist_device, mesh=mesh, shard_planes="auto")
    sys.stderr.write(
        f"Boundary pass: {len(i)} within-strain pairs in "
        f"{time.perf_counter() - t0:.1f}s\n")

    G = Graph(n, np.stack([i, j], axis=1).astype(np.int64))
    print_network_summary(G, sample_size=args.summary_sample,
                          betweenness_sample=args.betweenness_sample)
    save_network(G, prefix=output, suffix="_graph")
    clustering, _ = print_clusters(
        G, names, out_prefix=file_base(output),
        external_cluster_csv=args.external_clustering, write_unwords=True)
    sys.stderr.write(
        f"Network: {len(i)} edges, "
        f"{len(set(clustering.values()))} clusters\n")

    store_pickle(names, names, True, None, default_dists(output))
    model.save()
    ref_h5 = db_h5_path(ref_db)
    out_h5 = db_h5_path(output)
    if os.path.isfile(ref_h5) and not os.path.exists(out_h5):
        shutil.copy(ref_h5, out_h5)
    sys.stderr.write("Done\n")
    return model


def _mandrake_embedding(args, cd, names, output, device):
    """SCE embedding from one extra streaming pass over ``cd``'s resident
    planes (its column shards on a column-sharded cd) that accumulates the
    ACCESSORY kNN (the reference's mandrake gathers kNN from a dense square
    accessory matrix, mandrake.py:60-67 — an O(n^2) object this path
    never builds); the optimiser on ``device``."""
    from ..embedding import embedding_from_knn, write_mandrake_dot
    from ..scale import StreamingCondensed

    t0 = time.perf_counter()
    k = min(50, cd.n - 1)
    cd2 = StreamingCondensed(cd.planes, cd.lengths, cd.freqs, cd._klist,
                             cd._ss64, cd._bbits, chunk=cd.chunk, knn=k,
                             dist_col=1, n_real=cd.n, mesh=cd._mesh)
    rows, cols, dists = cd2.knn_sparse()
    emb = embedding_from_knn(rows, cols, dists, cd.n, k,
                             args.perplexity, max_iter=args.mandrake_iter,
                             seed=args.seed, device=device)
    path = (file_base(output) + "_perplexity" + str(args.perplexity)
            + "_accessory_mandrake.dot")
    write_mandrake_dot(names, emb, path)
    sys.stderr.write(
        f"Mandrake embedding (accessory kNN k={k}) in "
        f"{time.perf_counter() - t0:.1f}s\n")
    return emb


def _run_qc(args, ref_db, output, names, sketches, klist, device):
    """Sketch QC (host, h5 attributes) + streaming distance QC
    (scale.qc_bad_pairs_streaming on ``device``), replicating
    qc.qc_dist_mat's greedy prune_edges semantics without a host condensed
    matrix. Returns the passing (names, sketches); unless --qc-keep, the
    output database is written pruned and failures go to _qcreport.txt."""
    from ..io.hdf5db import add_random, remove_from_db
    from ..ops.distances import pack_planes
    from ..qc import prune_edges, sketch_qc, write_qc_failure_report
    from ..scale import qc_bad_pairs_streaming
    from .common import qc_dict_from_args

    # unset flags fall through to DEFAULT_QC (the reference qc.py
    # defaults: max_pi 0.1, max_a 0.5, prop_zero 0.05)
    qc_dict = qc_dict_from_args(args)
    n = len(names)
    _, fail_sketch = sketch_qc(ref_db, names, qc_dict)

    sys.stderr.write(
        "Running streaming QC on distances (cutoffs: core "
        f"{qc_dict['max_pi_dist']}, accessory {qc_dict['max_a_dist']}, "
        f"zero proportion {qc_dict['prop_zero']})\n")
    chunk, n_pad, mesh = _chunk_geometry(n, args, klist, device)
    planes, lengths, freqs = pack_planes(sketches, klist,
                                         plane_major=True, pad_to=n_pad)
    i, j, flags = qc_bad_pairs_streaming(
        planes, lengths, freqs, klist, sketches[0].sketchsize64,
        sketches[0].bbits, chunk, n, qc_dict["max_pi_dist"],
        qc_dict["max_a_dist"],
        # prop_zero >= 1 disables the zero rule: skip zero-pair
        # compaction (clonal populations hold O(n_pairs) zero pairs)
        check_zero=qc_dict["prop_zero"] < 1, device=device, mesh=mesh,
        shard_planes="auto")
    long_mask = (flags & 1) > 0
    long_edges = list(zip(i[long_mask].tolist(), j[long_mask].tolist()))
    failed_idx = prune_edges(long_edges, query_start=n)
    fail_dist = {names[x]: ["Failed distance QC (too high)"]
                 for x in failed_idx}
    if qc_dict["prop_zero"] < 1:
        zero_count = round(qc_dict["prop_zero"] * n)
        zero_mask = (flags & 2) > 0
        zero_edges = list(zip(i[zero_mask].tolist(),
                              j[zero_mask].tolist()))
        failed_idx = prune_edges(zero_edges, query_start=n,
                                 failed=failed_idx, min_count=zero_count)
        for x in failed_idx:
            fail_dist.setdefault(names[x], []).append(
                "Failed distance QC (too many zeros)")
    fail_dicts = [fail_sketch, fail_dist]
    failed = set(fail_sketch) | {names[x] for x in failed_idx}
    if not failed:
        sys.stderr.write("All samples passed QC\n")
        return names, sketches

    write_qc_failure_report(sorted(failed), fail_dicts, output)
    if args.retain_failures:
        # before the qc_keep return: the host twin remove_qc_fail writes
        # the retained-failures db regardless of no_remove (qc.py)
        remove_from_db(
            db_h5_path(ref_db),
            os.path.join(output, f"failed.{os.path.basename(output)}.h5"),
            set(names) - failed, full_names=True)
    if args.qc_keep:
        sys.stderr.write(
            f"{len(failed)} samples failed QC (kept; see _qcreport.txt)\n")
        return names, sketches
    tmp = os.path.join(output, f"filtered.{os.path.basename(output)}.h5")
    remove_from_db(db_h5_path(ref_db), tmp, failed, full_names=True)
    os.rename(tmp, db_h5_path(output))
    passed = [x for x in names if x not in failed]
    add_random(output, passed, klist,
               strand_preserved=args.strand_preserved, overwrite=True)
    sys.stderr.write(
        f"{len(failed)} samples failed QC and were removed\n")
    by_name = {sk.name: sk for sk in sketches}
    return passed, [by_name[x] for x in passed]


def _network_and_clusters(cd, sweep, s_opt, names, output, args,
                          suffix="", slope=2, boundary=None):
    """Final network at the refined boundary -> _graph + _clusters.csv
    (suffix "_core"/"_accessory" for the indiv-refine projections,
    reference __main__.py:635-654). Returns (G, clustering dict)."""
    from ..network.clusters import print_clusters
    from ..network.graph import Graph, save_network
    from ..scale import offset_threshold

    if sweep[0] == "sparse2d":
        from ..scale import inside_2d_host

        _, i, j, xs, ys = sweep
        bx, by = boundary
        mask = inside_2d_host(xs, ys, bx, by)
        edges = np.stack([i[mask], j[mask]], axis=1).astype(np.int64)
    elif sweep[0] == "edges":
        # device-resident sweep: fetch only the optimal boundary's edges
        # (the artefact needs them on the host; the sweep itself never
        # left the device)
        _, dev_edges, s_range, line = sweep
        t_final = offset_threshold(float(s_opt), s_range, slope, *line)
        k = int(dev_edges.counts_at(np.array([t_final]))[0])
        ei, ej = dev_edges.fetch_prefix(k)
        edges = np.stack([ei, ej], axis=1).astype(np.int64)
    else:
        kind, i, j, idx, d0, s_range, line = sweep
        assert kind == "sparse"
        t_final = offset_threshold(float(s_opt), s_range, slope, *line)
        mask = d0 <= t_final
        edges = np.stack([i[mask], j[mask]], axis=1).astype(np.int64)
    G = Graph(cd.n, edges)
    if suffix == "":
        from ..network.summary import print_network_summary

        print_network_summary(
            G, sample_size=args.summary_sample,
            betweenness_sample=args.betweenness_sample)
    save_network(G, prefix=output, suffix=suffix + "_graph")
    clustering, _ = print_clusters(
        G, names, out_prefix=file_base(output) + suffix,
        external_cluster_csv=args.external_clustering,
        write_unwords=(suffix == ""))
    n_clusters = len(set(clustering.values()))
    sys.stderr.write(
        f"Network{suffix or ''}: {edges.shape[0]} edges, "
        f"{n_clusters} clusters\n")
    return G, clustering


def _write_lineages(cd, ranks, names, output, args):
    """Lineage tier from the fused kNN: per-rank clusters, the
    _lineages.csv, and a full LineageFit model directory
    (<output>_lineages) usable as an assign --model-dir. The kNN was
    accumulated inside the distance pass, so none of this costs extra
    distance work (models/lineage.py:LineageFit.from_knn)."""
    from ..models.lineage import LineageFit
    from ..network.clusters import print_clusters
    from ..network.graph import Graph

    n = cd.n
    depth = cd.knn_col.shape[1]  # knn after the n-1 cap
    model = LineageFit.from_knn(
        output + "_lineages", ranks, cd.knn_sparse(), n, depth,
        dist_col=1 if args.use_accessory else 0,
        reciprocal_only=args.reciprocal_only,
        count_unique_distances=args.count_unique_distances)
    model.save()

    lineage_clusters = {}
    for rank in ranks:
        edges = np.asarray(model.assign(rank), np.int64).reshape(-1, 2)
        G = Graph(n, edges)
        clustering, _ = print_clusters(
            G, names, out_prefix=file_base(output) + f"_rank{rank}",
            print_csv=False, write_unwords=False)
        lineage_clusters[rank] = {name: clustering[name] for name in names}
        sys.stderr.write(
            f"Rank {rank}: {len(set(clustering.values()))} lineages\n")

    from .main import write_lineage_csv

    overall = create_overall_lineage(ranks, lineage_clusters)
    for path in (file_base(output) + "_lineages.csv",
                 os.path.join(output + "_lineages",
                              os.path.basename(output)
                              + "_lineages_lineages.csv")):
        write_lineage_csv(path, names, ranks, overall)


def _extract_refs(graph_and_clusters, names, ref_db, output, args):
    """Opt-in clique pruning (reference __main__.py:765-789 minus the
    dists pruning — there is no host condensed matrix to prune)."""
    from ..io.hdf5db import remove_from_db
    from ..network.cliques import extract_references
    from ..network.graph import save_network

    G, _ = graph_and_clusters
    _, ref_names, _, G_ref = extract_references(
        G, names, output, threads=args.threads,
        fast_mode=args.refs_mode == "fast",
        rng=np.random.default_rng(args.seed))
    if len(ref_names) < len(names):
        sys.stderr.write(f"Pruned network to {len(ref_names)} references\n")
        save_network(G_ref, prefix=output, suffix=".refs_graph")
        # with --run-qc the pruned output db is the correct source
        # (the original ref_db still contains QC-failed sketches)
        src_db = output if os.path.isfile(db_h5_path(output)) else ref_db
        if os.path.isfile(db_h5_path(src_db)):
            tmp = remove_from_db(src_db, output,
                                 set(names) - set(ref_names))
            os.rename(tmp, file_base(output) + ".refs.h5")
    else:
        sys.stderr.write("All samples kept as references\n")


if __name__ == "__main__":
    main()
