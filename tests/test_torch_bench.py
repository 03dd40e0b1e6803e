"""The port's bench (poppunk_tpu_torch/bench.py) on the CPU, at small sizes.

- The headline pipeline (match counts, the corrections, the k-mer fit) on
  bench.py's seeded planes equals the JAX package's pipeline as bench.py
  composes it (bench.py:174-179, match_counts_xla on the CPU) within
  rtol 1e-5 / atol 2e-5 (tests/test_torch_distances.py's tolerance); the
  planes themselves are bench.py's draws bit for bit.
- The g++ CPU baseline (native/cpu_baseline.cpp) counts what the plain
  version counts, bit for bit.
- ``bound`` gives the LOP3 bound PERF.md states for the H100 at its
  1980 MHz SM clock.
- Every mode runs at a tiny size with the CPU asked for and emits its
  record, marked ``"backend": "cpu"``; without CUDA and without that
  request the bench raises; ``--capture`` writes only its ``--out``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from poppunk_tpu.ops.distances import (core_accessory as jax_core_accessory,
                                       corrected_jaccards as jax_corrected,
                                       match_counts_xla)
from poppunk_tpu_torch import bench, scale
from poppunk_tpu_torch.ops import match_counts as mc
from poppunk_tpu_torch.ops.distances import plane_geometry, planes_to_tensor

torch.set_num_threads(2)

CPU = torch.device("cpu")
DIST_TOL = dict(rtol=1e-5, atol=2e-5)
RECORD_KEYS = {"metric", "value", "unit", "backend", "device"}


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, as a CPU-only host must."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def headline():
    return bench.headline(CPU, nq=64, nr=128)


def test_the_planes_are_bench_py_draws():
    rng = np.random.default_rng(1)
    _, wp, _ = plane_geometry(bench.SS64, bench.BBITS)
    planes64 = jax_bench._synth_planes_u64(128, rng)
    planes = jax_bench._u64_to_u32_planes(planes64, wp)
    lengths = rng.integers(1_800_000, 2_400_000, 128).astype(np.int32)
    freqs = rng.dirichlet(np.ones(4), 128).astype(np.float32)
    got = bench.random_population(128, 1)
    for a, b in zip(got, (planes64, planes, lengths, freqs)):
        np.testing.assert_array_equal(a, b)
    assert (bench.KLIST, bench.SS64, bench.BBITS) == (
        jax_bench.KLIST, jax_bench.SS64, jax_bench.BBITS)


def test_headline_equals_the_jax_pipeline(headline):
    record, ctx = headline
    _, planes, lengths, freqs = bench.random_population(128, 1)
    _, _, pad_bits = plane_geometry(bench.SS64, bench.BBITS)
    m = match_counts_xla(jnp.asarray(planes[:64]), jnp.asarray(planes),
                         pad_bits)
    j = jax_corrected(m, bench.KLIST, jnp.asarray(lengths[:64]),
                      jnp.asarray(lengths), jnp.asarray(freqs[:64]),
                      jnp.asarray(freqs), bench.SS64, bench.BBITS,
                      random_correct=True, use_rc=True)
    want = np.asarray(jax_core_accessory(j, bench.KLIST))
    np.testing.assert_allclose(ctx.dists.numpy(), want, **DIST_TOL)
    assert record["metric"] == bench.METRIC == (
        "pairwise core/accessory dists/sec/chip "
        "(sketchsize 9984, bbits 14, 6 k-mer lengths)")
    assert record["backend"] == "cpu" and record["device"] == "cpu"
    assert record["unit"] == "pairs/s" and record["value"] > 0
    assert record["vs_baseline"] > 0
    assert record["cpu_baseline"]["threads"] == os.cpu_count()
    assert record["cpu_baseline"]["tile"] == [512, 1024]
    # no clock, no bound and no ceiling on the CPU: device numbers only
    assert record["ceiling_frac"] is None and record["bound_ms"] is None
    assert record["launches"] == 0


def test_cpu_baseline_counts_equal_the_plain_version():
    planes64, planes, _, _ = bench.random_population(128, 1)
    _, _, pad_bits = plane_geometry(bench.SS64, bench.BBITS)
    _, counts = bench.cpu_baseline(planes64, 64, 128, threads=2)
    want = mc.match_counts_torch(planes_to_tensor(planes[:64], CPU),
                                 planes_to_tensor(planes, CPU), pad_bits)
    np.testing.assert_array_equal(counts, want.numpy())


def test_bound_at_the_h100_clock():
    w32 = plane_geometry(bench.SS64, bench.BBITS)[0]
    assert w32 == 312
    ms, by = bench.bound(2048, 4096, 6, 14, w32, 0, 1980, sms=132)
    assert by == "operations"
    assert round(ms, 2) == 13.14


MODE_CASES = {
    "kernel_ab": (dict(nq=32, nr=64), {"kernels", "vs_standard",
                                       "library_ms"}),
    "epilogue": (dict(nq=16, nr=32), {"ms", "nq", "nr", "K"}),
    "serve": (dict(nq=16, nr=64), {"fused_pairs_per_s",
                                   "two_pass_pairs_per_s",
                                   "class_agreement"}),
    "serve_prod": (dict(nq=16, nr=128, n_strains=4),
                   {"batch_s", "attach_agreement", "within_pairs_per_batch"}),
    "scale": (dict(n=128, warm_n=64), {"stage_s", "ari", "route",
                                       "peak_device_bytes", "cpu_baseline"}),
    "colshard": (dict(n=64), {"col_pass1_s", "single_pass1_s",
                              "sweep_edges", "mesh"}),
    "validate": (dict(n=64), {"detail"}),
    "brandes_ab": (dict(n_comp=3, m=60, deg=6, n_sources=10, m_pad=64),
                   {"exact_ms", "tf32_ms", "native_s"}),
    "fill_profile": (dict(n=64), {"detail", "chunk", "steps"}),
    "sketch": (dict(n_fasta=2, n_fastq=2, glen=20_000, coverage=2),
               {"detail", "n_cores"}),
    "refine_corners": (dict(n=2000, n_strains=10, grid=4, within_deg=6,
                            n_between=2000), {"detail", "n_pairs_fetched"}),
}


@pytest.mark.parametrize("mode", sorted(MODE_CASES))
def test_each_mode_emits_its_record_on_the_cpu(mode, monkeypatch):
    kwargs, keys = MODE_CASES[mode]
    if mode == "validate":
        # the host route takes the sparse sweep only past the dense cap
        monkeypatch.setattr(scale, "MATMUL_SWEEP_MAX_N", 0)
    record = bench.MODES[mode](CPU, **kwargs)
    assert RECORD_KEYS | keys <= set(record)
    assert record["backend"] == "cpu" and record["device"] == "cpu"
    json.dumps(record)
    if mode == "validate":
        assert record["value"] == 1.0


def test_the_command_line_runs_a_mode(tmp_path, capsys):
    out = tmp_path / "records.jsonl"
    assert bench.main(["--serve", "--nq", "8", "--nr", "16", "--device",
                       "cpu", "--json-out", str(out)]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    record = json.loads(out.read_text())
    assert json.loads(printed[-1]) == record
    assert (record["nq"], record["nr"], record["backend"]) == (8, 16, "cpu")


def test_without_cuda_or_a_cpu_request_the_bench_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench runs on it")
    monkeypatch.delenv("POPPUNK_TPU_TORCH_DEVICE", raising=False)
    for argv in ([], ["--kernel-ab"], ["--scale", "128"], ["--sketch"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.headline(nq=8, nr=8)


def test_capture_writes_only_its_out_path(tmp_path, monkeypatch):
    calls = []

    def run(argv, timeout, cwd):
        calls.append(argv)
        path = argv[argv.index("--json-out") + 1]
        assert os.path.dirname(path) != str(tmp_path)
        with open(path, "a") as fh:
            fh.write(json.dumps({"metric": "m", "value": len(calls),
                                 "backend": "cpu"}) + "\n")
        return type("Done", (), {"returncode": 0})()

    monkeypatch.setattr(bench.subprocess, "run", run)
    monkeypatch.chdir(tmp_path)
    before = os.stat(os.path.join(bench.ROOT, "BENCH_scale.json")).st_mtime
    out = tmp_path / "capture.json"
    assert bench.main(["--capture", "--only", "headline,serve_4k", "--out",
                       str(out), "--device", "cpu"]) == 0
    assert os.listdir(tmp_path) == ["capture.json"]
    merged = json.loads(out.read_text())
    assert set(merged) == {"meta", "headline", "serve_4k"}
    assert merged["serve_4k"]["rc"] == 0 and merged["serve_4k"]["value"] == 2
    for c in calls:
        assert c[-4:] == ["--device", "cpu", "--json-out", c[-1]]
    assert calls[1][:4] == [calls[1][0], "-m", "poppunk_tpu_torch.bench",
                            "--serve"]
    assert os.stat(os.path.join(bench.ROOT,
                                "BENCH_scale.json")).st_mtime == before
    # the default --out lies under bench_out/, which git ignores
    assert bench.get_options([]).out == os.path.join(
        bench.ROOT, "bench_out", "bench_capture.json")
