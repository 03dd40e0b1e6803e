"""The port stands on its own and computes on the card by default.

- No file of poppunk_tpu_torch/ (nor chip_smoke.py) imports the JAX
  package ``poppunk_tpu``: an AST scan of every import.
- The modules the port copied from the JAX package keep the originals'
  definitions: every top-level function, class and constant is the same
  syntax tree, except the ones each copy lists as its own (the citation
  text, the GPU flags' help, the contour plot's likelihood, the Boruvka
  sweep in torch, the unpickler that never imports the JAX package, the
  DBSCAN model's device).
- The port's CLI parsers are copies: on the same argv they give the JAX
  package's namespace (the assign parser adds PopPUNK's --gpu-model).
- Devices (_device.py): with ``device=None`` an entry point runs on the
  card; without CUDA it raises unless the caller asks for the CPU, by
  ``POPPUNK_TPU_TORCH_DEVICE=cpu`` or by passing ``torch.device("cpu")``.
"""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from poppunk_tpu.cli.assign import get_options as jax_assign_options
from poppunk_tpu.cli.main import get_options as jax_main_options
from poppunk_tpu_torch import _device
from poppunk_tpu_torch.cli.assign import get_options as torch_assign_options
from poppunk_tpu_torch.cli.assign import main as torch_assign
from poppunk_tpu_torch.cli.main import get_options as torch_main_options
from poppunk_tpu_torch.cli.main import main as torch_main
from poppunk_tpu_torch.models import (BGMMFit, DBSCANFit, GaussianMixture,
                                      RefineFit)
from poppunk_tpu_torch.ops import distances as td

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
    "plotting.py": (("plot_contours",), None),
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
}
CLIS = {
    "create_db_cli": lambda tmp: torch_main([
        "--create-db", "--r-files", str(tmp / "r.txt"), "--output",
        str(tmp / "db")]),
    "assign_cli": lambda tmp: torch_assign([
        "--db", str(tmp / "db"), "--query", str(tmp / "q.txt"), "--output",
        str(tmp / "out")]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS) + sorted(CLIS))
def test_without_cuda_and_without_a_cpu_request_it_raises(entry, no_cuda,
                                                          tmp_path):
    with pytest.raises(RuntimeError, match=_device.ENV + "=cpu"):
        {**ENTRY_POINTS, **CLIS}[entry](tmp_path)


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
