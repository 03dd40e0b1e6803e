"""Whole runs of the typing cell on the CPU at a tiny size: the look for a
card skipped, the rest of a run driven (the database written and opened,
the session warmed, the window's requests, the reference's check). A
sound run comes out correct, on h5py and on the stand-in the card's host
takes in its place; each fault the cell can have, planted in the timed
path underneath or in the fit the session opens, comes out not correct on
its own check; the bfloat16 control comes out not correct; and a run
loads neither JAX nor the JAX package."""

import json
import os
import subprocess
import sys

import pytest
import torch

import numpy as np

from benchmark import control, h5py_standin, run

CELL = "gps-20027-k6-typing.assign-batch"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKS = {"answers_missing", "nn_gap", "label_wrong", "strain_wrong",
          "answer_drift"}


def small_cell():
    """The cell at 160 references and a pool of 48 queries of 12 strains,
    the configuration's K 6, 1,024-bin sketches, requests of 4-24 queries
    against a chunk of 8 (ragged buckets, several dispatches a request).
    At 512 bins and K 3 the fit of some between-strain pairs clamps their
    core distance to 0, so a query's nearest reference can lie outside
    its strain; from these sketches on, none does."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "gps-20027-k6-typing.json")) as f:
        cfg = json.load(f)
    return {"config": {"n_genomes": 160, "n_query_pool": 48,
                       "sketchsize64": 16,
                       "population": {**cfg["population"], "strains": 12},
                       "session": {**cfg["session"], "chunk": 8},
                       "fit": {**cfg["fit"], "model_subsample": 4000,
                               "chunk": 16}},
            "traffic": {"queries": [4, 24]}}


@pytest.fixture
def small(monkeypatch):
    """The small cell on the CPU, on two threads: several test processes
    at torch's default of one thread a core wait on each other's spinning
    threads, and a window then holds a single request."""
    monkeypatch.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield small_cell()
    torch.set_num_threads(threads)


def _run(small, capsys, seed=2 ** 31 + 3):
    code = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                     "1", "--trace", "0"], device=torch.device("cpu"),
                    overrides=small)
    out = capsys.readouterr()
    assert code == 0, out.err
    record = json.loads(out.out.strip().splitlines()[-1])
    tail = out.err.strip().splitlines()[-len(record["checks"]):]
    assert [line.split(":")[0] for line in tail] == \
        [f"check {name}" for name in record["checks"]]
    return record


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 33 + 5])
def test_sound_run_is_correct(seed, small, capsys):
    record = _run(small, capsys, seed)
    assert record["correct"] and record["failed"] == 0
    assert record["attempted"] >= 2
    assert set(record["metrics"]) == {"createdb_pairs_per_s", "setup_s"}
    assert set(record["checks"]) == CHECKS


def _faults(monkeypatch):
    from poppunk_tpu_torch.models import bgmm
    from poppunk_tpu_torch.ops import fused_assign
    from poppunk_tpu_torch.serve import AssignSession

    assign = AssignSession.assign_sketches

    def second_nearest():  # the second-nearest reference chosen
        def second(dists, classes, dist_col, within):
            nn = dists[..., dist_col].argsort(dim=-1, stable=True)[..., 1]
            hit = torch.gather(classes, -1, nn[..., None])[..., 0] == within
            return torch.stack([nn.to(torch.int32), hit.to(torch.int32)], -1)
        monkeypatch.setattr(fused_assign, "_nearest_within", second)

    def within_to_na():  # each request's first within answer made "NA"
        def flipped(self, sketches, with_nearest=False):
            got = assign(self, sketches, with_nearest)
            name = next((k for k, v in got.items() if v[0] != "NA"), None)
            if name is not None:
                got[name] = ("NA", got[name][1])
            return got
        monkeypatch.setattr(AssignSession, "assign_sketches", flipped)

    def request_dropped():  # the second request's answers left out
        calls = []

        def dropped(self, sketches, with_nearest=False):
            calls.append(1)
            got = assign(self, sketches, with_nearest)
            return {} if len(calls) == 2 else got
        monkeypatch.setattr(AssignSession, "assign_sketches", dropped)

    def repeat_changed():  # the first answer given twice, moved the 2nd time
        seen, moved = set(), []

        def changed(self, sketches, with_nearest=False):
            got = assign(self, sketches, with_nearest)
            for name in got:
                if name in seen and not moved:
                    cluster, ref = got[name]
                    other = self.r_names[int(ref == self.r_names[0])]
                    got[name] = (cluster, other)
                    moved.append(name)
            seen.update(got)
            return got
        monkeypatch.setattr(AssignSession, "assign_sketches", changed)

    def within_flipped():  # the fit saves the between component as within
        find = bgmm.find_within_label

        def flipped(means, assignments, rank=0):
            return 1 - find(means, assignments, rank)
        monkeypatch.setattr(bgmm, "find_within_label", flipped)

    return {"second_nearest": (second_nearest, "nn_gap"),
            "within_to_na": (within_to_na, "label_wrong"),
            "request_dropped": (request_dropped, "answers_missing"),
            "repeat_changed": (repeat_changed, "answer_drift"),
            "within_flipped": (within_flipped, "strain_wrong")}


@pytest.mark.parametrize("fault", ["second_nearest", "within_to_na",
                                   "request_dropped", "repeat_changed",
                                   "within_flipped"])
def test_fault_is_not_correct(fault, small, capsys, monkeypatch):
    plant, check = _faults(monkeypatch)[fault]
    plant()
    record = _run(small, capsys)
    assert not record["correct"]
    got = record["checks"][check]
    assert got["value"] > got["limit"]


@pytest.fixture
def standin(monkeypatch):
    """The stand-in in h5py's place, as ``install()`` puts it where h5py
    does not import: the program's sketch database then goes through it."""
    from poppunk_tpu_torch.io import hdf5db

    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py fails
    install = h5py_standin.install

    def forced():
        got = install()
        monkeypatch.setattr(hdf5db, "h5py", sys.modules["h5py"])
        return got
    monkeypatch.setattr(h5py_standin, "install", forced)
    monkeypatch.setattr(h5py_standin, "_READ", {})
    return forced


def test_sound_run_on_the_standin_is_correct(small, standin, capsys):
    record = _run(small, capsys)
    assert record["correct"] and record["failed"] == 0
    assert set(record["checks"]) == CHECKS
    assert len(h5py_standin._READ) == 1  # the session's opens, one read


def _database(tmp_path, n=5):
    """A sketch database of n seeded sketches written by the program, and
    what its readers give back: the sketches, the parameters, the names."""
    from poppunk_tpu_torch.io import hdf5db
    from poppunk_tpu_torch.sketch.minhash import Sketch

    rng = np.random.default_rng(7)
    db = str(tmp_path / "db")
    hdf5db.write_sketches(db, [
        Sketch(name=f"g{i}", usigs={k: rng.integers(0, 2 ** 63, 3 * 14,
                                                    dtype=np.uint64)
                                    for k in (13, 17)},
               sketchsize64=3, bbits=14, length=int(rng.integers(1e6, 2e6)),
               missing_bases=0, base_freq=rng.dirichlet(np.ones(4)))
        for i in rng.permutation(n)])
    got = [(s.name, {k: v.tolist() for k, v in s.usigs.items()},
            s.sketchsize64, s.bbits, s.length, s.base_freq.tolist())
           for s in hdf5db.read_sketches(db)]
    kmers, size, phased = hdf5db.read_db_params(db)
    return got, (kmers.tolist(), size, phased), hdf5db.get_seqs_in_db(
        hdf5db.db_h5_path(db))


def test_standin_database_reads_back_as_h5py(tmp_path, monkeypatch):
    from poppunk_tpu_torch.io import hdf5db

    (tmp_path / "h5py").mkdir()
    want = _database(tmp_path / "h5py")
    (tmp_path / "standin").mkdir()
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        m.setattr(h5py_standin, "_READ", {})
        assert h5py_standin.install() == "stand-in"
        m.setattr(hdf5db, "h5py", sys.modules["h5py"])
        got = _database(tmp_path / "standin")
        again = _database(tmp_path / "standin", n=7)  # rewritten: reread
    assert got == want
    assert len(again[0]) == 7 and again[0] != got[0]


def test_bfloat16_control_is_not_correct(small):
    _, _, c, _, _ = run.load_cell(CELL)
    limits = c["check"]
    got = control.readings(run, CELL, 2 ** 31 + 9, 0, ["bfloat16"],
                           device="cpu", overrides=small)
    assert all(got["program"][k] <= limits[k] for k in limits)
    assert any(got["bfloat16"][k] > limits[k] for k in limits)


RUN_ALONE = """
import json, sys, torch
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.tests.test_bench_assign_batch import CELL, small_cell
code = run.main(["--workload", CELL, "--seed", "5", "--seconds", "0.5",
                 "--trace", "0"], device=torch.device("cpu"),
                overrides=small_cell())
loaded = sorted({{m.split(".")[0] for m in sys.modules}}
                & {{"jax", "jaxlib", "flax", "poppunk_tpu"}})
print(json.dumps([code, loaded]))
"""


def test_a_run_loads_no_jax():
    env = {**os.environ, "POPPUNK_TPU_TORCH_DEVICE": "cpu",
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", RUN_ALONE.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [0, []]
