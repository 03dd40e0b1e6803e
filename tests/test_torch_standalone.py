"""The port stands on its own and computes on the card by default.

- No file of poppunk_tpu_torch/ (nor chip_smoke.py) imports the JAX
  package ``poppunk_tpu``: an AST scan of every import.
- The modules the port copied from the JAX package keep the originals'
  definitions: every top-level function, class and constant is the same
  syntax tree, except the ones each copy lists as its own (the citation
  text, the GPU flags' help, the contour plot's likelihood, the Boruvka
  sweep in torch, the unpickler that never imports the JAX package, the
  DBSCAN model's device, NJ and the SCE optimisers in torch, the device
  argument of the visualisation, embedding, tree and web entry points, the
  tools' CLI names and device choice, the scale tier's passes in torch and
  its CLI's devices, the synthetic population's draws in torch, the helper
  scripts' CLI names, the batched Brandes in torch and pack_components'
  size order).
- The port's CLI parsers are copies: on the same argv they give the JAX
  package's namespace (the assign parser adds PopPUNK's --gpu-model).
- ``ops/distances.pack_planes`` packs what the JAX package's packs, in
  both layouts and with either pad.
- A visualise, serve and API run in a fresh interpreter loads neither jax
  nor the JAX package.
- Devices (_device.py): with ``device=None`` an entry point runs on the
  card; without CUDA it raises unless the caller asks for the CPU, by
  ``POPPUNK_TPU_TORCH_DEVICE=cpu`` or by passing ``torch.device("cpu")``.
"""

import ast
import glob
import inspect
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from poppunk_tpu.cli.assign import get_options as jax_assign_options
from poppunk_tpu.cli.main import get_options as jax_main_options
from poppunk_tpu_torch import _device, web
from poppunk_tpu_torch.cli.assign import get_options as torch_assign_options
from poppunk_tpu_torch.cli.assign import main as torch_assign
from poppunk_tpu_torch.cli.main import get_options as torch_main_options
from poppunk_tpu_torch.cli.main import main as torch_main
from poppunk_tpu_torch.models import (BGMMFit, DBSCANFit, GaussianMixture,
                                      RefineFit)
from poppunk_tpu_torch.embedding import generate_embedding
from poppunk_tpu_torch.ops import distances as td
from poppunk_tpu_torch.ops.nj_device import (neighbor_joining_device,
                                             use_device_nj)
from poppunk_tpu_torch.serve import AssignSession
from poppunk_tpu_torch.visualise import generate_visualisations

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "poppunk_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]


def imported_modules(path):
    """Absolute names of the modules a file imports, relative imports
    resolved against its package."""
    package = os.path.dirname(path).replace(os.sep, ".")
    names = []
    for node in ast.walk(ast.parse(open(os.path.join(REPO, path)).read())):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")
                parts = parts[:len(parts) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            names.append(base)
            names += [f"{base}.{alias.name}" for alias in node.names]
    return names


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_file_of_the_port_imports_the_jax_package(path):
    bad = [m for m in imported_modules(path)
           if m == "poppunk_tpu" or m.startswith("poppunk_tpu.")
           or m == "jax" or m.startswith("jax.")]
    assert not bad, f"{path} imports {bad}"


def test_the_scan_covers_the_scripts_and_the_synth():
    for name in ("__main__", "synth", "scripts/__init__", "scripts/iterate",
                 "scripts/batch_mst", "scripts/easy_run"):
        assert os.path.join("poppunk_tpu_torch", name + ".py") in PORT_FILES
    names = imported_modules(os.path.join("poppunk_tpu_torch", "scripts",
                                          "iterate.py"))
    assert "poppunk_tpu_torch.ops.distances.query_db" in names


def test_the_scan_covers_the_parallel_subpackage():
    for name in ("__init__", "mesh", "dists", "distributed"):
        assert os.path.join("poppunk_tpu_torch", "parallel",
                            name + ".py") in PORT_FILES
    names = imported_modules(os.path.join("poppunk_tpu_torch", "parallel",
                                          "dists.py"))
    assert "poppunk_tpu_torch.ops.distances._dist_chunk" in names


def test_the_scan_sees_relative_imports():
    names = imported_modules(os.path.join("poppunk_tpu_torch", "qc.py"))
    assert "poppunk_tpu_torch.network.graph.prune_graph" in names
    assert "poppunk_tpu_torch.utils" in names


# module -> (definitions changed on purpose, definitions not copied); None:
# only the definitions the port has are compared (a partial copy)
COPIES = {
    "utils.py": ((), ()),
    "qc.py": ((), ()),
    "pairs.py": ((), ()),
    "citation.py": (("CITATIONS", "generate_methods"), ()),
    "io/hdf5db.py": ((), ()),
    "sketch/__init__.py": ((), ()),
    "sketch/minhash.py": ((), ()),
    "sketch/nthash.py": ((), ()),
    "sketch/reader.py": ((), ()),
    "sketch/random_match.py": ((), ()),
    "sketch/native.py": ((), ()),
    "ops/boundary.py": ((), ()),
    "ops/sparse_knn.py": ((), ()),
    "ops/hdbscan.py": (("_boruvka_round", "boruvka_mst_device",
                        "mutual_reachability_mst", "HDBSCAN"),
                       ("_BORUVKA_RUN",)),
    "models/lineage.py": ((), ()),
    "models/compat.py": (("_TolerantUnpickler",), None),
    "models/dbscan.py": (("DBSCANFit",), None),
    "cli/common.py": (("_ACCEL_FLAG_DEFS", "add_accel_compat_flags"),
                      ("note_accel_compat_flags",)),
    "plotting.py": (("plot_contours", "outputs_for_microreact", "draw_mst"),
                    None),
    "network/graph.py": (("Graph", "save_network"), None),
    "network/construct.py": ((), ()),
    "network/mst.py": ((), ()),
    "trees.py": (("generate_nj_tree",), ()),
    "ops/nj_device.py": (("_INF", "_nj_joins", "neighbor_joining_device",
                          "use_device_nj"), None),
    "embedding.py": (("_sce_optimize_dense", "_sce_optimize_sampled",
                      "sce_embedding_condensed", "sce_embedding",
                      "_sce_from_knn", "generate_embedding",
                      "embedding_from_knn"), None),
    "web.py": (("assign_sketch_json", "main"), ()),
    "visualise.py": (("generate_visualisations", "_dense_matrices",
                      "query_db_sketches"), ()),
    "cli/visualise.py": (("get_options", "main"), ()),
    "cli/mst.py": (("get_options", "main"), ()),
    "cli/mandrake.py": (("get_options", "main"), ()),
    "cli/info.py": (("get_options", "main"), ()),
    "cli/references.py": (("get_options", "main"), ()),
    "cli/lineages.py": (("get_options", "main", "create_db", "query_db"),
                        ()),
    "scale.py": (("_fold_block", "_pair_corrected_fit",
                  "_pair_block_dists", "StreamingCondensed", "_d0_chunk",
                  "sweep_counts_streaming", "sweep_first_offsets",
                  "sweep_fill_device", "plan_sweep_band",
                  "refine_fit_device", "_inside_2d",
                  "sweep2d_counts_streaming", "sweep2d_fetch_streaming",
                  "qc_bad_pairs_streaming", "fetch_within_boundary",
                  "CondensedDevice", "fill_condensed_device",
                  "edge_components_device",
                  "_unfold_block", "build_d0_square", "matmul_sweep_scores",
                  "components_device", "run_scale_pipeline",
                  "fill_condensed_sharded", "sweep_counts_mesh",
                  "_sweep_fill_mesh", "_mesh_compact_pass",
                  "_ColShardedStream"), None),
    "ops/brandes_device.py": (("_INF", "_brandes_batched",
                               "brandes_batched_device", "pack_components"),
                              None),
    "synth.py": (("_bernoulli_words", "_keep_probs", "_masked_planes",
                  "SyntheticSketches", "synthetic_population_device"),
                 None),
    "__main__.py": ((), ()),
    **{f"scripts/{name}.py": (("get_options",), ()) for name in (
        "rand_index", "silhouette", "extract_components",
        "extract_distances", "add_weights", "distribute_fit", "easy_run",
        "iterate", "batch_mst")},
    "ops/sparse_sweep.py": (("SweepEdges", "sweep_scores_sparse_device",
                             "hbm_feasible", "max_edge_cap"), None),
    "cli/scale.py": (("get_options", "main", "_pad_geometry", "_use_model",
                      "_mandrake_embedding", "_run_qc"), None),
    "parallel/__init__.py": ((), ()),
    "parallel/mesh.py": (("get_mesh",), None),
    "parallel/dists.py": (("_local_block", "_fetch",
                           "sharded_pairwise_block", "sharded_query_dists",
                           "sharded_self_dists"), None),
    "parallel/distributed.py": (("init_distributed", "pod_mesh",
                                 "is_primary"), None),
}


def definitions(path):
    """{name: syntax tree dump} of a module's top-level functions, classes,
    constants and imports (the module docstring aside)."""
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            out[ast.unparse(node.targets[0])] = ast.dump(node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out[ast.unparse(node)] = ast.dump(node)
    return out


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copies_keep_the_originals_definitions(module):
    changed, not_copied = COPIES[module]
    want = definitions(os.path.join(REPO, "poppunk_tpu", module))
    got = definitions(os.path.join(REPO, "poppunk_tpu_torch", module))
    names = ([n for n in want if n in got] if not_copied is None
             else [n for n in want if n not in not_copied])
    assert names
    for name in names:
        if name in changed:
            assert name in got, name
        else:
            assert got.get(name) == want[name], name


MAIN_ARGV = [
    ["--create-db", "--r-files", "r.txt", "--output", "db"],
    ["--create-db", "--r-files", "r.txt", "--output", "db", "--min-k", "15",
     "--max-k", "31", "--k-step", "2", "--sketch-size", "9984",
     "--gpu-dist", "--deviceid", "1", "--threads", "4", "--no-plot",
     "--codon-phased", "--strand-preserved"],
    ["--fit-model", "bgmm", "--ref-db", "db", "--K", "3", "--gpu-model",
     "--model-subsample", "5000", "--for-refine"],
    ["--fit-model", "refine", "--ref-db", "db", "--model-dir", "db",
     "--indiv-refine", "both", "--unconstrained", "--pos-shift", "0.1",
     "--score-idx", "1", "--no-local"],
    ["--fit-model", "refine", "--ref-db", "db", "--multi-boundary", "3",
     "--manual-start", "start.txt"],
    ["--fit-model", "threshold", "--threshold", "0.01", "--ref-db", "db",
     "--gpu-sketch", "--gpu-graph"],
    ["--use-model", "--ref-db", "db", "--model-dir", "m", "--output", "o",
     "--graph-weights", "--external-clustering", "ext.csv"],
    ["--qc-db", "--ref-db", "db", "--length-range", "1000", "2000",
     "--max-a-dist", "0.6", "--qc-keep", "--auto-max-dists", "core"],
    ["--fit-model", "lineage", "--ranks", "1,5", "--reciprocal-only"],
    ["--fit-model", "dbscan", "--ref-db", "db", "--D", "5",
     "--min-cluster-prop", "0.01", "--dbscan-grid-assign", "--for-refine",
     "--gpu-model"],
    ["--fit-model", "lineage", "--ranks", "1,2", "--ref-db", "db",
     "--max-search-depth", "30", "--use-accessory", "--count-unique-distances",
     "--write-lineage-networks", "--lineage-resolution", "0.001"],
    ["--qc-db", "--ref-db", "db", "--output", "qc", "--remove-samples",
     "rm.txt", "--retain-failures", "--max-zero-dist", "0.5"],
]
ASSIGN_ARGV = [
    ["--db", "db", "--query", "q.txt", "--output", "o"],
    ["--db", "db", "--query", "q.txt", "--output", "o", "--serial",
     "--stable", "core", "--threads", "3"],
    ["--db", "db", "--query", "q.txt", "--output", "o", "--update-db",
     "full", "--write-references", "--gpu-dist", "--deviceid", "2"],
    ["--db", "db", "--query", "q.txt", "--output", "o", "--core",
     "--accessory", "--run-qc", "--max-merge", "3", "--length-range", "5",
     "6", "--gpu-sketch", "--gpu-graph"],
    ["--db", "db", "--warmup", "--output", "o", "--model-dir", "m"],
]


# the auxiliary tools' parsers: {tool: [argv, ...]}
TOOL_ARGV = {
    "visualise": [
        ["--ref-db", "db", "--output", "o", "--microreact"],
        ["--ref-db", "db", "--output", "o", "--cytoscape", "--network-file",
         "n.npz", "--tree", "both", "--gpu-dist", "--deviceid", "1",
         "--maxIter", "50", "--perplexity", "5", "--recalculate-distances",
         "--query-db", "q", "--include-files", "f.txt"],
        ["--ref-db", "db", "--output", "o", "--phandango", "--grapetree",
         "--gpu-graph", "--rank-fit", "r.npz", "--mst-distances",
         "euclidean", "--tmp", "t"]],
    "mst": [["--rank-fit", "r.npz", "--output", "o"],
            ["--rank-fit", "r.npz", "--output", "o", "--distance-pkl",
             "d.pkl", "--previous-clustering", "c.csv", "--no-plot",
             "--gpu-graph"]],
    "mandrake": [["--distances", "d", "--output", "o"],
                 ["--distances", "d", "--output", "o", "--use-gpu",
                  "--device-id", "1", "--knn", "5", "--iter", "100"]],
    "info": [["--db", "db"],
             ["--db", "db", "--simple", "--use-gpu", "--network-file", "n"]],
    "references": [["--network", "n", "--distances", "d", "--output", "o"],
                   ["--network", "n", "--distances", "d", "--output", "o",
                    "--ref-db", "db", "--model", "m", "--use-gpu"]],
    "lineages": [["--create-db", "db", "--db-scheme", "s.pkl", "--output",
                  "o"],
                 ["--query-db", "q.txt", "--db-scheme", "s.pkl", "--output",
                  "o", "--gpu-dist", "--deviceid", "2", "--ranks", "1,2",
                  "--use-accessory", "--core", "--gpu-sketch"]],
    "scale": [
        ["--ref-db", "db", "--output", "o"],
        ["--ref-db", "db", "--output", "o", "--fit-model", "dbscan", "--D",
         "5", "--write-lineages", "--ranks", "1,3", "--indiv-refine", "core",
         "--score-idx", "2", "--no-local", "--chunk", "64", "--knn", "7",
         "--single-device", "--gpu-dist", "--deviceid", "1",
         "--extract-references", "--refs-mode", "fast", "--use-accessory"],
        ["--ref-db", "db", "--output", "o", "--unconstrained", "--run-qc",
         "--max-a-dist", "0.4", "--length-range", "1", "2", "--mandrake",
         "--perplexity", "5", "--gpu-model", "--gpu-graph"],
        ["--ref-db", "db", "--output", "o", "--use-model", "--model-dir",
         "m", "--multi-boundary", "4", "--pos-shift", "0.1", "--neg-shift",
         "0.05", "--max-sweep-fetch", "1000", "--summary-sample", "20"]],
}


def cli_module(package, tool):
    return __import__(f"{package}.cli.{tool}", fromlist=["get_options"])


@pytest.mark.parametrize("tool,argv", [(t, a) for t in sorted(TOOL_ARGV)
                                       for a in TOOL_ARGV[t]])
def test_tool_parsers_equal_the_jax_package(tool, argv):
    got = cli_module("poppunk_tpu_torch", tool).get_options(argv)
    assert vars(got) == vars(cli_module("poppunk_tpu", tool).get_options(
        argv))


@pytest.mark.parametrize("argv", MAIN_ARGV)
def test_main_parser_equals_the_jax_package(argv):
    assert vars(torch_main_options(argv)) == vars(jax_main_options(argv))


@pytest.mark.parametrize("argv", ASSIGN_ARGV)
def test_assign_parser_equals_the_jax_package_with_gpu_model(argv):
    got = vars(torch_assign_options(argv))
    assert got.pop("gpu_model") is False
    assert got == vars(jax_assign_options(argv))
    assert torch_assign_options(argv + ["--gpu-model"]).gpu_model is True


@pytest.mark.parametrize("parse,argv", [
    (torch_main_options, ["--fit-model", "bogus", "--ref-db", "db"]),
    (torch_main_options, ["--ref-db", "db"]),
    (torch_assign_options, ["--query", "q.txt", "--output", "o"]),
])
def test_parsers_refuse_what_the_jax_package_refuses(parse, argv, capsys):
    jax_parse = (jax_main_options if parse is torch_main_options
                 else jax_assign_options)
    for fn in (parse, jax_parse):
        with pytest.raises(SystemExit):
            fn(argv)


# ---------------------------------------------------------------------------
# devices

def tiny_planes(n=4, ss64=2, bbits=3, K=2, seed=3):
    rng = np.random.default_rng(seed)
    w32, wp, _ = td.plane_geometry(ss64, bbits)
    planes = np.zeros((n, K, bbits, wp), dtype=np.uint32)
    planes[..., :w32] = rng.integers(0, 2**32, (n, K, bbits, w32),
                                     dtype=np.uint32)
    lengths = rng.integers(50_000, 90_000, n).astype(np.int32)
    freqs = rng.dirichlet([5, 4, 4, 5], n).astype(np.float32)
    return planes, lengths, freqs, (13, 17), ss64, bbits


@pytest.fixture
def no_cuda(monkeypatch):
    """A host without CUDA and without a request for the CPU."""
    monkeypatch.delenv(_device.ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def mixture():
    return (np.array([0.5, 0.5]), np.array([[0.1, 0.1], [0.6, 0.6]]),
            np.stack([np.eye(2) * 0.01] * 2), np.array([1.0, 1.0]))


def synthetic_population():
    from poppunk_tpu_torch.synth import synthetic_population_device

    return synthetic_population_device(8, (13, 17), 1, 3, n_strains=2,
                                       chunk=4).planes.device


def condensed_device():
    from poppunk_tpu_torch.scale import fill_condensed_device

    planes, lengths, freqs, klist, ss64, bbits = tiny_planes()
    return fill_condensed_device(planes.transpose(1, 2, 0, 3), lengths,
                                 freqs, klist, ss64, bbits, knn=2).device


def streaming_condensed():
    from poppunk_tpu_torch.scale import StreamingCondensed

    planes, lengths, freqs, klist, ss64, bbits = tiny_planes()
    return StreamingCondensed(planes.transpose(1, 2, 0, 3), lengths, freqs,
                              klist, ss64, bbits, knn=2).device


def self_block():
    return td.condensed_self_block(*tiny_planes())


def query_block():
    planes, lengths, freqs, klist, ss64, bbits = tiny_planes()
    return td.pairwise_block(planes[:1], planes, lengths[:1], lengths,
                             freqs[:1], freqs, klist, ss64, bbits)


# each returns the device it chose, or the host result of its computation
ENTRY_POINTS = {
    "resolve": lambda tmp: _device.resolve(),
    "planes_to_tensor": lambda tmp: td.planes_to_tensor(
        tiny_planes()[0]).device,
    "condensed_self_block": lambda tmp: self_block(),
    "pairwise_block": lambda tmp: query_block(),
    "BGMMFit": lambda tmp: BGMMFit(str(tmp / "bgmm")).device,
    "DBSCANFit": lambda tmp: DBSCANFit(str(tmp / "dbscan")).device,
    "RefineFit": lambda tmp: RefineFit(str(tmp / "refine")).device,
    "GaussianMixture": lambda tmp: GaussianMixture.from_numpy(
        *mixture()).means.device,
    "StreamingCondensed": lambda tmp: streaming_condensed(),
    "fill_condensed_device": lambda tmp: condensed_device(),
    "synthetic_population_device": lambda tmp: synthetic_population(),
}
CLIS = {
    "create_db_cli": lambda tmp: torch_main([
        "--create-db", "--r-files", str(tmp / "r.txt"), "--output",
        str(tmp / "db")]),
    "assign_cli": lambda tmp: torch_assign([
        "--db", str(tmp / "db"), "--query", str(tmp / "q.txt"), "--output",
        str(tmp / "out")]),
}


def tool_cli(tool, tmp):
    argv = [a if a.startswith("--") else str(tmp / a)
            for a in TOOL_ARGV[tool][0]]
    return cli_module("poppunk_tpu_torch", tool).main(argv)


def api_cli(tmp):
    (tmp / "s.json").write_text("{}")
    return web.main(["--sketch", str(tmp / "s.json"), "--ref-db",
                     str(tmp / "db"), "--output", str(tmp / "out")])


def visualise_library(tmp):
    args = dict.fromkeys(inspect.signature(generate_visualisations)
                         .parameters)
    return generate_visualisations(**{**args, "ref_db": str(tmp / "db"),
                                      "output": str(tmp / "o"),
                                      "microreact": True, "tree": "nj"})


# the entry points of the serving session, the web flow and the tools:
# each must raise before it touches a file
TOOL_ENTRY_POINTS = {
    "AssignSession": lambda tmp: AssignSession(str(tmp / "db")),
    "assign_sketch_json": lambda tmp: web.assign_sketch_json(
        {}, str(tmp / "db"), str(tmp / "out")),
    "api_cli": api_cli,
    "generate_visualisations": visualise_library,
    "generate_embedding": lambda tmp: generate_embedding(
        list("abc"), np.ones((3, 3)), 5, str(tmp), True),
    "neighbor_joining_device": lambda tmp: neighbor_joining_device(
        np.ones((4, 4)), list("abcd")),
    "use_device_nj": lambda tmp: use_device_nj(1024),
    **{f"{tool}_cli": (lambda tmp, tool=tool: tool_cli(tool, tmp))
       for tool in TOOL_ARGV},
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS) + sorted(CLIS)
                         + sorted(TOOL_ENTRY_POINTS))
def test_without_cuda_and_without_a_cpu_request_it_raises(entry, no_cuda,
                                                          tmp_path):
    with pytest.raises(RuntimeError, match=_device.ENV + "=cpu"):
        {**ENTRY_POINTS, **CLIS, **TOOL_ENTRY_POINTS}[entry](tmp_path)
    assert not any(tmp_path.glob("*/*")), "it wrote before it raised"


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_the_environment_asks_for_the_cpu(entry, no_cuda, tmp_path,
                                          monkeypatch):
    monkeypatch.setenv(_device.ENV, "cpu")
    out = ENTRY_POINTS[entry](tmp_path)
    if isinstance(out, torch.device):
        assert out == torch.device("cpu")
    else:
        assert out.shape[-1] == 2 and np.isfinite(out).all()


def test_a_cpu_device_is_a_request_for_the_cpu(no_cuda, tmp_path):
    cpu = torch.device("cpu")
    planes, lengths, freqs, klist, ss64, bbits = tiny_planes()
    got = td.condensed_self_block(planes, lengths, freqs, klist, ss64, bbits,
                                  device=cpu)
    assert got.shape == (6, 2) and np.isfinite(got).all()
    assert BGMMFit(str(tmp_path / "b"), device=cpu).device == cpu
    assert RefineFit(str(tmp_path / "r"), device=cpu).device == cpu
    assert DBSCANFit(str(tmp_path / "d"), device=cpu).device == cpu
    assert td.planes_to_tensor(planes, cpu).device == cpu


def test_cli_stages_follow_the_environment_and_the_flags(no_cuda,
                                                         monkeypatch):
    monkeypatch.setenv(_device.ENV, "cpu")
    args = torch_main_options(["--create-db", "--r-files", "r.txt"])
    assert _device.stage_devices(args) == (torch.device("cpu"),) * 2
    # a --gpu-* flag asks for the card whatever the environment says
    flagged = torch_main_options(["--create-db", "--r-files", "r.txt",
                                  "--gpu-dist"])
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        _device.stage_devices(flagged)


@pytest.mark.parametrize("request_", ["tpu", "cuda"])
def test_an_unknown_device_request_is_refused(request_, monkeypatch):
    # the card needs no request: it is what an unset variable means
    monkeypatch.setenv(_device.ENV, request_)
    with pytest.raises(ValueError, match="expected 'cpu' or unset"):
        _device.resolve()


@pytest.mark.cuda
def test_the_card_is_the_default(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.delenv(_device.ENV, raising=False)
    assert _device.resolve() == torch.device("cuda", 0)
    assert BGMMFit(str(tmp_path / "b")).device == torch.device("cuda", 0)
    assert td.planes_to_tensor(tiny_planes()[0]).device.type == "cuda"


SERVE_VISUALISE_API = """
import json, sys
from poppunk_tpu_torch.cli.main import main
from poppunk_tpu_torch.cli.visualise import main as visualise
from poppunk_tpu_torch.io.hdf5db import read_sketches
from poppunk_tpu_torch.serve import AssignSession
from poppunk_tpu_torch.web import assign_sketch_json, sketch_to_json

rfile, qfile, work = sys.argv[1:]
kargs = ["--min-k", "13", "--max-k", "25", "--k-step", "4",
         "--sketch-size", "2048", "--no-plot"]
main(["--create-db", "--r-files", rfile, "--output", work + "/db"] + kargs)
main(["--fit-model", "bgmm", "--ref-db", work + "/db", "--output",
      work + "/db", "--K", "2", "--no-plot"])
visualise(["--ref-db", work + "/db", "--output", work + "/viz",
           "--microreact", "--tree", "both", "--maxIter", "10000"])
served = AssignSession(work + "/db").assign_files(qfile)
main(["--create-db", "--r-files", qfile, "--output", work + "/q"] + kargs)
api = assign_sketch_json({s.name: sketch_to_json(s)
                          for s in read_sketches(work + "/q")},
                         work + "/db", work + "/api")
print(json.dumps([sorted(served), [q["name"] for q in api["queries"]],
                  sorted(m for m in sys.modules if m in ("jax", "poppunk_tpu")
                         or m.startswith(("jax.", "poppunk_tpu.")))]))
"""


def test_visualise_serve_and_api_load_no_jax(population, population_dir,
                                             tmp_path):
    d, _ = population_dir
    queries = [n for n in population.names if n.endswith("iso0")]
    rfile = population.subset_rfile(
        d, [n for n in population.names if n not in queries],
        "standalone_refs.txt")
    qfile = population.subset_rfile(d, queries, "standalone_q.txt")
    env = {**os.environ, _device.ENV: "cpu", "PYTHONPATH": REPO}
    run = subprocess.run([sys.executable, "-c", SERVE_VISUALISE_API, rfile,
                          qfile, str(tmp_path)], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    served, answered, loaded = json.loads(run.stdout.splitlines()[-1])
    assert served == sorted(queries) and sorted(answered) == sorted(queries)
    assert loaded == []
    assert (tmp_path / "viz" / "viz_core_NJ.nwk").is_file()


def fake_sketches(n=5, ss64=3, bbits=4, klist=(13, 17), seed=8):
    rng = np.random.default_rng(seed)
    return [SimpleNamespace(
        name=f"s{i}", sketchsize64=ss64, bbits=bbits,
        length=int(rng.integers(1000, 9000)),
        base_freq=rng.dirichlet([1, 1, 1, 1]).astype(np.float32),
        usigs={k: rng.integers(0, 2**63, ss64 * bbits, dtype=np.uint64)
               for k in klist}) for i in range(n)]


@pytest.mark.parametrize("kw", [
    {}, dict(plane_major=True), dict(pad_to_even=True),
    dict(plane_major=True, pad_to_even=True), dict(plane_major=True,
                                                   pad_to=12),
    dict(pad_to=8)])
def test_pack_planes_packs_what_the_jax_package_packs(kw):
    from poppunk_tpu.ops.distances import pack_planes as jax_pack

    sketches = fake_sketches()
    for got, want in zip(td.pack_planes(sketches, (13, 17), **kw),
                         jax_pack(sketches, (13, 17), **kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="pad_to"):
        td.pack_planes(sketches, pad_to=3)
