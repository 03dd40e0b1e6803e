"""The port's refine path against the JAX package's, on the CPU:
ops/device_sweep.py, network/incremental.py, the device label propagation
of network/components.py, the ``boundary`` post of ops/fused_assign.py,
models/refine.py and the loader of models/base.py.

Tolerances: integer outputs (labels, classes, edge sets, cluster files)
are exact. Sweep scores: atol 1e-6 against the JAX device sweep, whose
float32 score carries ~1e-7 rounding (its docstring, device_sweep.py:22-27),
and against the host sweep, which the port's float64 aggregates meet to
~1e-15. Refined boundaries: exact, because both packages run the same
host search on the same distances and start model.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poppunk_tpu.models.base import load_cluster_fit as jax_load
from poppunk_tpu.models.refine import RefineFit as JaxRefine
from poppunk_tpu.network import components as jcomp
from poppunk_tpu.network import incremental as jinc
from poppunk_tpu.ops import device_sweep as jsweep
from poppunk_tpu.ops import fused_assign as jfa
from poppunk_tpu_torch.models import refine as trefine
from poppunk_tpu_torch.models.base import load_cluster_fit as torch_load
from poppunk_tpu_torch.network import components as tcomp
from poppunk_tpu_torch.network import incremental as tinc
from poppunk_tpu_torch.ops import device_sweep as tsweep
from poppunk_tpu_torch.ops import fused_assign as tfa

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, as a CPU-only host must."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


CPU = torch.device("cpu")


def random_sweep(n, n_offsets, n_edges, seed):
    """Edges i < j, deduplicated, each with the first offset at which it is
    active (tests/test_device_sweep.py's generator)."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n - 1, n_edges)
    j = rng.integers(1, n, n_edges)
    swap = i >= j
    i2 = np.where(swap, j, i)
    j2 = np.where(swap, np.minimum(i + 1, n - 1), j)
    mask = i2 < j2
    i2, j2 = i2[mask], j2[mask]
    idx = np.sort(rng.integers(0, n_offsets, i2.shape[0]))
    _, first = np.unique(i2 * n + j2, return_index=True)
    return i2[first], j2[first], idx[first]


# --------------------------------------------------------------------------
# device sweep and incremental scoring
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sweep_scores_device_matches_jax_and_host(seed):
    n, n_offsets = 50, 12
    i, j, idx = random_sweep(n, n_offsets, 300, seed)
    got = tsweep.sweep_scores_device(n, i, j, idx, n_offsets, CPU)
    np.testing.assert_allclose(
        got, jsweep.sweep_scores_device(n, i, j, idx, n_offsets), atol=1e-6)
    np.testing.assert_allclose(
        got, jinc.grow_network_scores(n, i, j, idx, n_offsets, score_idx=0),
        atol=1e-6)


def test_sweep_scores_device_empty_and_never_active_edges():
    np.testing.assert_array_equal(
        tsweep.sweep_scores_device(10, [], [], [], 5, CPU), np.zeros(5))
    i, j = np.array([0, 1, 0, 2]), np.array([1, 2, 2, 3])
    idx = np.array([0, 1, 7, 9])  # the last two never activate in 4
    np.testing.assert_allclose(
        tsweep.sweep_scores_device(6, i, j, idx, 4, CPU),
        jinc.grow_network_scores(6, i, j, idx, 4, score_idx=0), atol=1e-12)


def test_counts_f32_exact_equals_jax():
    for seed, n in ((0, 50), (1, 3000)):
        i, j, _ = random_sweep(n, 4, 40 * n, seed)
        assert tsweep.counts_f32_exact(i, j, n) == \
            jsweep.counts_f32_exact(i, j, n)
    assert tsweep.counts_f32_exact([], [], 5)


def test_use_device_sweep_gates_on_a_cuda_model_device():
    cuda = torch.device("cuda", 0)  # a device name: no card needed
    assert tsweep.use_device_sweep(100, 0, cuda)
    assert not tsweep.use_device_sweep(100, 0, CPU)
    assert not tsweep.use_device_sweep(100, 0, None)
    assert not tsweep.use_device_sweep(100, 1, cuda)
    assert not tsweep.use_device_sweep(tsweep.DEVICE_SWEEP_MAX_N + 1, 0,
                                       cuda)


@pytest.mark.parametrize("score_idx", [0, 1, 2])
def test_grow_network_scores_equals_jax(score_idx):
    """The native sweep through either package's bindings, and the
    pure-Python IncrementalNetwork behind the port's, give the reference's
    scores (components stay within betweenness_sample, so the sampled
    betweenness is exact in both)."""
    n, n_offsets = 40, 9
    i, j, idx = random_sweep(n, n_offsets, 90, score_idx + 5)
    want = jinc.grow_network_scores(n, i, j, idx, n_offsets, score_idx)
    np.testing.assert_allclose(
        tinc.grow_network_scores(n, i, j, idx, n_offsets, score_idx), want,
        atol=1e-12)
    order = np.argsort(idx, kind="stable")
    net = tinc.IncrementalNetwork(n)
    py = []
    for off in range(n_offsets):
        sel = order[idx[order] == off]
        net.add_edges(i[sel], j[sel])
        py.append(-net.score(score_idx))
    np.testing.assert_allclose(py, want, atol=1e-12)


def test_grow_network_scores_writes_the_same_boundary_clusters(tmp_path):
    """The --multi-boundary branch: per-offset cluster files identical to
    the JAX package's."""
    n, n_offsets = 30, 6
    i, j, idx = random_sweep(n, n_offsets, 40, 11)
    names = [f"s{v}" for v in range(n)]
    outs = {}
    for pkg, mod in (("jax", jinc), ("torch", tinc)):
        prefix = str(tmp_path / pkg / "multi")
        os.makedirs(prefix)
        outs[pkg] = mod.grow_network_scores(
            n, i, j, idx, n_offsets, write_clusters=prefix,
            sample_names=names)
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    jax_files = sorted(os.listdir(tmp_path / "jax" / "multi"))
    assert jax_files and jax_files == \
        sorted(os.listdir(tmp_path / "torch" / "multi"))
    for name in jax_files:
        with open(tmp_path / "jax" / "multi" / name, "rb") as a, \
                open(tmp_path / "torch" / "multi" / name, "rb") as b:
            assert a.read() == b.read(), name


# --------------------------------------------------------------------------
# device components
# --------------------------------------------------------------------------

def random_edges(n, n_edges, seed, p_active=0.8):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, n_edges), rng.integers(0, n, n_edges),
            rng.random(n_edges) < p_active)


@pytest.mark.parametrize("n,n_edges,seed", [(200, 150, 0), (60, 200, 1),
                                            (500, 480, 2)])
def test_connected_components_device_equals_jax_and_native(n, n_edges,
                                                           seed):
    src, dst, mask = random_edges(n, n_edges, seed)
    got = tcomp.connected_components_device(
        n, torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(mask))
    want = np.asarray(jcomp.connected_components_device(
        n, jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
        jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tcomp.count_components_device(got) == \
        int(jcomp.count_components_device(jnp.asarray(want)))
    # the same partition as the native union-find's labels
    labels, sizes = tinc.components_native(n, src[mask], dst[mask])
    first = {}
    for v, lab in enumerate(labels.tolist()):
        first.setdefault(lab, v)
    np.testing.assert_array_equal(got.numpy(),
                                  [first[lab] for lab in labels.tolist()])
    assert tcomp.count_components_device(got) == len(sizes)


def test_label_prop_step_equals_jax():
    src, dst, mask = random_edges(40, 60, 3)
    labels = np.random.default_rng(4).permutation(40).astype(np.int32)
    got = tcomp.label_prop_step(torch.as_tensor(labels),
                                torch.as_tensor(src), torch.as_tensor(dst),
                                torch.as_tensor(mask))
    want = jcomp.label_prop_step(jnp.asarray(labels), jnp.asarray(src),
                                 jnp.asarray(dst), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the boundary post
# --------------------------------------------------------------------------

@pytest.mark.parametrize("slope,x_max,y_max", [(0, 0.31, 0.0),
                                               (1, 0.0, 0.42),
                                               (2, 0.31, 0.42),
                                               (2, 0.0, 0.42)])
def test_boundary_post_equals_jax(slope, x_max, y_max):
    rng = np.random.default_rng(slope + 7)
    dists = rng.random((6, 9, 2)).astype(np.float32) * \
        np.float32([0.05, 0.6])
    scale = np.float32([0.05, 0.6])
    want = jfa._post_boundary(
        jnp.asarray(dists), (jnp.asarray(scale), jnp.float32(x_max),
                             jnp.float32(y_max)), (slope,))
    got = tfa._post_boundary(
        torch.as_tensor(dists), tuple(torch.as_tensor(np.float32(a))
                                      for a in (scale, x_max, y_max)),
        (slope,))
    assert got.dtype == torch.int8 and got.shape == (6, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the refine model
# --------------------------------------------------------------------------

def strain_dists(n_strains=4, per_strain=6, seed=3):
    """Condensed (core, accessory) distances of a population in strains:
    small within, large between, with noise."""
    rng = np.random.default_rng(seed)
    strain = np.repeat(np.arange(n_strains), per_strain)
    n = strain.size
    iu, ju = np.triu_indices(n, 1)
    within = strain[iu] == strain[ju]
    base = np.where(within[:, None], [0.002, 0.04], [0.03, 0.25])
    X = (base * rng.uniform(0.6, 1.4, (iu.size, 2))).astype(np.float32)
    return X, [f"g{v}" for v in range(n)]


class StartModel:
    """A fitted BGMM's interface as RefineFit reads it."""

    type = "bgmm"
    within_label, between_label = 0, 1

    def __init__(self, X):
        self.scale = X.max(axis=0)
        Xs = X / self.scale
        self.means = np.array([np.median(Xs[Xs[:, 0] < 0.3], axis=0),
                               np.median(Xs[Xs[:, 0] >= 0.3], axis=0)])

    def no_scale(self):
        self.scale = np.array([1, 1], dtype=np.float32)


FIT_OPTIONS = {
    "default": {},
    "indiv_both": {"indiv_refine": "both"},
    "unconstrained": {"unconstrained": True},
    "no_local": {"no_local": True},
    "score_idx_1": {"score_idx": 1},
}


@pytest.mark.parametrize("option", sorted(FIT_OPTIONS))
def test_refine_fit_equals_jax(option, tmp_path):
    X, names = strain_dists()
    fits = {}
    for pkg, cls in (("jax", JaxRefine), ("torch", trefine.RefineFit)):
        model = cls(str(tmp_path / pkg / "fit"))
        y = model.fit(X, names, StartModel(X), max_move=0.0, min_move=0.0,
                      **FIT_OPTIONS[option])
        fits[pkg] = (model, np.asarray(y))
    (jm, jy), (tm, ty) = fits["jax"], fits["torch"]
    for attr in ("optimal_x", "optimal_y", "core_boundary",
                 "accessory_boundary", "indiv_fitted"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    np.testing.assert_array_equal(ty, jy)
    assert (ty == -1).sum() > 0 and (ty == 1).sum() > 0
    for slope in (0, 1, 2):
        np.testing.assert_array_equal(tm.assign(X, slope=slope),
                                      jm.assign(X, slope=slope))


def test_multi_boundary_writes_the_same_files(tmp_path):
    X, names = strain_dists(seed=4)
    for pkg, cls in (("jax", JaxRefine), ("torch", trefine.RefineFit)):
        cls(str(tmp_path / pkg / "mb")).fit(
            X, names, StartModel(X), max_move=0.0, min_move=0.0,
            multi_boundary=3)
    files = sorted(f for f in os.listdir(tmp_path / "jax" / "mb")
                   if "_boundary" in f)
    assert files
    assert files == sorted(f for f in os.listdir(tmp_path / "torch" / "mb")
                           if "_boundary" in f)
    for name in files:
        with open(tmp_path / "jax" / "mb" / name, "rb") as a, \
                open(tmp_path / "torch" / "mb" / name, "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("unconstrained", [False, True])
def test_refine_through_the_device_sweep_on_cpu_tensors(unconstrained,
                                                       monkeypatch,
                                                       tmp_path):
    """Routing the global search through sweep_scores_device (the card's
    path, here on CPU tensors) finds the same boundary as the host sweep."""
    X, names = strain_dists(seed=5)
    host = trefine.RefineFit(str(tmp_path / "host"))
    host.fit(X, names, StartModel(X), 0.0, 0.0, unconstrained=unconstrained)
    calls = []
    real = tsweep.sweep_scores_device
    monkeypatch.setattr(trefine, "use_device_sweep",
                        lambda n, score_idx, device: device is not None)
    monkeypatch.setattr(trefine, "sweep_scores_device",
                        lambda *a: calls.append(a[-1]) or real(*a))
    dev = trefine.RefineFit(str(tmp_path / "dev"), device=CPU)
    dev.fit(X, names, StartModel(X), 0.0, 0.0, unconstrained=unconstrained)
    assert calls and set(calls) == {CPU}
    assert (dev.optimal_x, dev.optimal_y) == (host.optimal_x, host.optimal_y)


def test_threshold_equals_jax(tmp_path):
    X, _ = strain_dists()
    yj = JaxRefine(str(tmp_path / "j")).apply_threshold(X, 0.01)
    tm = trefine.RefineFit(str(tmp_path / "t"))
    np.testing.assert_array_equal(tm.apply_threshold(X, 0.01), yj)
    assert tm.threshold and tm.slope == 0


@pytest.mark.parametrize("kind", ["refine", "threshold"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_load_cluster_fit_reads_the_other_package(kind, writer, reader,
                                                  tmp_path):
    X, names = strain_dists()
    cls = {"jax": JaxRefine, "torch": trefine.RefineFit}[writer]
    prefix = str(tmp_path / "db")
    model = cls(prefix)
    if kind == "refine":
        model.fit(X, names, StartModel(X), 0.0, 0.0, indiv_refine="both")
    else:
        model.apply_threshold(X, 0.01)
    model.save()
    load = {"jax": jax_load, "torch": torch_load}[reader]
    base = os.path.join(prefix, "db")
    loaded = load(base + "_fit.pkl", base + "_fit.npz")
    assert loaded.type == "refine"
    assert (loaded.threshold, loaded.slope, loaded.indiv_fitted) == \
        (model.threshold, model.slope, model.indiv_fitted)
    np.testing.assert_array_equal(
        [loaded.optimal_x, loaded.optimal_y, loaded.core_boundary,
         loaded.accessory_boundary],
        [model.optimal_x, model.optimal_y, model.core_boundary,
         model.accessory_boundary])
    np.testing.assert_array_equal(loaded.assign(X), model.assign(X))


@pytest.mark.parametrize("slope", [None, 0, 1, 2])
def test_refine_post_spec_classifies_like_jax(slope, tmp_path):
    """model_post_spec(model, slope) for a refine fit: the fused classes
    equal the JAX package's fused classes and the host assignment."""
    X, names = strain_dists()
    model = trefine.RefineFit(str(tmp_path / "m"))
    model.fit(X, names, StartModel(X), 0.0, 0.0, indiv_refine="both")
    name, static, params = tfa.model_post_spec(model, slope=slope)
    jname, jstatic, jparams = jfa.model_post_spec(model, slope=slope)
    assert (name, static) == (jname, jstatic)
    got = tfa.apply_post(torch.as_tensor(X), (name, static, params))
    want = jfa.apply_post(jnp.asarray(X), (jname, jstatic, jparams))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    host = model.assign(X) if slope is None else model.assign(X, slope=slope)
    np.testing.assert_array_equal(got.numpy(), host)
