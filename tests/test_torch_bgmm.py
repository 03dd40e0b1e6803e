"""The port's BGMM (poppunk_tpu_torch/models/vbgmm.py, models/bgmm.py,
ops/fused_assign.py) against the JAX package, on the CPU.

jax.random and torch.Generator draw different numbers, so the EM step is
held exactly by injecting the same starting responsibilities into both,
and the whole fit is held by its labels.

Tolerances, each with its reason:
- EM parameters: rtol 1e-4 / atol 1e-5. Float32 sums over every point
  (resp.T @ X, the scatter einsum) run in different orders in the two
  frameworks, and a few EM steps compound that.
- log responsibilities: rtol 1e-4 / atol 5e-4. They are O(1) values left
  after terms of up to a few hundred cancel (nu_k * maha / 2 with
  nu_k ~ n / K), so float32 rounding of those terms alone is ~1e-4
  absolute (measured worst case 6.7e-5).
- likelihoods: rtol 1e-5 / atol 1e-5 (one Cholesky solve, float32).
- labels, component choices and fused classes: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poppunk_tpu.models import vbgmm as jv
from poppunk_tpu.models.bgmm import BGMMFit as JaxBGMM
from poppunk_tpu.models.bgmm import log_likelihood_device
from poppunk_tpu.ops import fused_assign as jfa
from poppunk_tpu.ops.distances import query_db as jax_query_db
from poppunk_tpu.sketch.minhash import SketchParams, sketch_sequence
from poppunk_tpu_torch.models import vbgmm as tv
from poppunk_tpu_torch.models.base import load_cluster_fit
from poppunk_tpu_torch.models.bgmm import BGMMFit, GaussianMixture
from poppunk_tpu_torch.ops import fused_assign as tfa

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, as a CPU-only host must."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


EM_TOL = dict(rtol=1e-4, atol=1e-5)
LOGRESP_TOL = dict(rtol=1e-4, atol=5e-4)
LL_TOL = dict(rtol=1e-5, atol=1e-5)


def blobs(seed=0, n=600):
    """Scaled 2-D distance cloud: a tight within-strain blob near the
    origin and a broad between-strain one."""
    rng = np.random.default_rng(seed)
    within = rng.normal([0.05, 0.1], [0.02, 0.03], (n // 5, 2))
    between = rng.normal([0.8, 0.7], [0.08, 0.1], (n - n // 5, 2))
    return np.abs(np.concatenate([within, between])).astype(np.float32)


def jax_prior(X):
    mu = X.mean(0)
    Xc = X - mu
    psi0 = (Xc.T @ Xc) / max(X.shape[0] - 1.0, 1.0)
    return (0.1, jnp.zeros(2, jnp.float32), jnp.float32(2.0),
            jnp.asarray(psi0, jnp.float32))


def torch_prior(X):
    Xc = X - X.mean(0)
    psi0 = (Xc.T @ Xc) / max(X.shape[0] - 1.0, 1.0)
    return (0.1, torch.zeros(2), 2.0, torch.as_tensor(psi0))


def test_em_steps_match_jax_with_injected_responsibilities():
    X = blobs()
    resp = np.random.default_rng(1).dirichlet(np.ones(3), X.shape[0]) \
        .astype(np.float32)
    jr, tr = jnp.asarray(resp), torch.as_tensor(resp)
    jp, tp = jax_prior(X), torch_prior(X)
    Xj, Xt = jnp.asarray(X), torch.as_tensor(X)
    for _ in range(4):
        jparams = jv._estimate_params(Xj, jr, jp)
        tparams = tv._estimate_params(Xt, tr, tp)
        for a, b in zip(tparams, jparams):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **EM_TOL)
        nk, _, beta_k, m_k, nu_k, psi_k = jparams
        jlog = jv._log_resp(Xj, 0.1, nk, beta_k, m_k, nu_k, psi_k)
        tlog = tv._log_resp(Xt, 0.1, *(tparams[i] for i in (0, 2, 3, 4, 5)))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGRESP_TOL)
        jr = jnp.exp(jlog - jax.scipy.special.logsumexp(jlog, axis=1,
                                                        keepdims=True))
        tr = torch.softmax(tlog, dim=1)


def jax_fit_from(X, resp0, max_iter=100, tol=1e-3, gamma0=0.1):
    """The JAX package's EM loop (vbgmm.py:138-169) from given
    responsibilities, one restart."""
    Xj, prior = jnp.asarray(X), jax_prior(X)
    resp, lb, it, delta = jnp.asarray(resp0), -np.inf, 0, np.inf
    while it < max_iter and abs(delta) > tol:
        nk, _, beta_k, m_k, nu_k, psi_k = jv._estimate_params(Xj, resp, prior)
        log_rho = jv._log_resp(Xj, gamma0, nk, beta_k, m_k, nu_k, psi_k)
        log_norm = jax.scipy.special.logsumexp(log_rho, axis=1, keepdims=True)
        resp = jnp.exp(log_rho - log_norm)
        new_lb = float(log_norm.mean())
        delta, lb, it = new_lb - lb, new_lb, it + 1
    nk, _, _, m_k, nu_k, psi_k = jv._estimate_params(Xj, resp, prior)
    return np.asarray(m_k), np.asarray(psi_k / nu_k[:, None, None]), it


def test_fit_vbgmm_injected_start_matches_jax_loop():
    X = blobs(2)
    rng = np.random.default_rng(3)
    resp0 = np.eye(2, dtype=np.float32)[(X[:, 0] > 0.4).astype(int)]
    resp0 = 0.8 * resp0 + 0.2 * rng.dirichlet(np.ones(2), X.shape[0])
    means, covs, _ = jax_fit_from(X, resp0)
    got = tv.fit_vbgmm(None, torch.as_tensor(X), 2, n_init=3,
                       init_resp=resp0)
    np.testing.assert_allclose(got["means"].numpy(), means, **EM_TOL)
    np.testing.assert_allclose(got["covariances"].numpy(), covs, **EM_TOL)
    np.testing.assert_allclose(got["weights"].sum().item(), 1.0, rtol=1e-6)


def test_restarts_freeze_at_their_own_convergence():
    """A batched restart that converged stops updating: its result equals
    the same start fitted alone."""
    X = blobs(4)
    rng = np.random.default_rng(5)
    starts = rng.dirichlet(np.ones(3), (3, X.shape[0])).astype(np.float32)
    batched = tv.fit_vbgmm(None, torch.as_tensor(X), 3, n_init=3,
                           init_resp=starts)
    alone = [tv.fit_vbgmm(None, torch.as_tensor(X), 3, n_init=1,
                          init_resp=s) for s in starts]
    best = int(np.argmax([a["lower_bound"].item() for a in alone]))
    np.testing.assert_allclose(batched["lower_bound"].item(),
                               alone[best]["lower_bound"].item(), rtol=1e-6)
    np.testing.assert_allclose(batched["means"].numpy(),
                               alone[best]["means"].numpy(), rtol=1e-5,
                               atol=1e-6)


def mixture(seed=5, k=3):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(k, 2, 2)) * 0.05
    return (rng.dirichlet(np.ones(k)), rng.uniform(0.05, 0.9, (k, 2)),
            np.einsum("kij,klj->kil", a, a) + 0.01 * np.eye(2),
            np.array([0.7, 0.9]))


def test_likelihood_and_argmax_match_jax():
    params = mixture()
    X = np.random.default_rng(6).uniform(0, 0.9, (500, 2)).astype(np.float32)
    jl, jlpr = log_likelihood_device(
        jnp.asarray(X), *(jnp.asarray(p, jnp.float32) for p in params))
    gm = GaussianMixture.from_numpy(*params)
    tl, tlpr = gm.log_likelihood(torch.as_tensor(X))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LL_TOL)
    np.testing.assert_allclose(tlpr.numpy(), np.asarray(jlpr), **LL_TOL)
    np.testing.assert_array_equal(gm(torch.as_tensor(X)).numpy(),
                                  np.asarray(jnp.argmax(jlpr, axis=1)))


def test_fused_posts_match_jax():
    params = mixture(7)
    rng = np.random.default_rng(8)
    d = rng.uniform(0, 0.9, (6, 40, 2)).astype(np.float32)
    jparams = tuple(jnp.asarray(p, jnp.float32) for p in params)
    tparams = tuple(torch.as_tensor(p, dtype=torch.float32) for p in params)
    np.testing.assert_array_equal(
        tfa.apply_post(torch.as_tensor(d), ("bgmm", (), tparams)).numpy(),
        np.asarray(jfa.apply_post(jnp.asarray(d), ("bgmm", (), jparams))))


@pytest.fixture(scope="module")
def population_dists(population):
    params = SketchParams(klist=(13, 17, 21, 25), sketchsize64=32, bbits=14)
    sketches = [sketch_sequence(name, codes, params)
                for name, codes in zip(population.names, population.genomes)]
    return np.asarray(jax_query_db(sketches, None, [13, 17, 21, 25],
                                   self_mode=True, use_pallas=False))


def test_whole_fit_labels_match_jax(population_dists, tmp_path):
    X = population_dists
    jm = JaxBGMM(str(tmp_path / "jax"))
    jy = jm.fit(X, 2)
    tm = BGMMFit(str(tmp_path / "torch"))
    ty = tm.fit(X, 2)
    np.testing.assert_array_equal(ty, jy)
    assert (tm.within_label, tm.between_label) == \
        (jm.within_label, jm.between_label)
    np.testing.assert_array_equal(tm.scale, jm.scale)


def test_reads_jax_written_fit(population_dists, tmp_path):
    """from_numpy / load_cluster_fit on a _fit.npz + _fit.pkl written by
    the JAX package: same assignments, labels and parameters."""
    X = population_dists
    out = tmp_path / "jaxfit"
    jm = JaxBGMM(str(out))
    jy = jm.fit(X, 2)
    jm.save()
    base = str(out / "jaxfit")
    tm = load_cluster_fit(base + "_fit.pkl", base + "_fit.npz")
    assert (tm.type, tm.within_label, tm.between_label) == \
        ("bgmm", jm.within_label, jm.between_label)
    np.testing.assert_array_equal(tm.means, jm.means)
    np.testing.assert_array_equal(tm.assign(X), jy)
    fit = np.load(base + "_fit.npz")
    gm = GaussianMixture.from_numpy(fit["weights"], fit["means"],
                                    fit["covariances"], fit["scale"])
    np.testing.assert_array_equal(gm(torch.as_tensor(X)).numpy(), jy)
    spec = tfa.model_post_spec(tm)
    assert spec[0] == "bgmm"
    np.testing.assert_array_equal(
        tfa.apply_post(torch.as_tensor(X), spec).numpy(), jy)
    # the same post on a [queries, references, 2] tile, as assign calls it
    tile = X.reshape(7, 15, 2)  # the 105 conftest pairs as 7 x 15
    np.testing.assert_array_equal(
        tfa.apply_post(torch.as_tensor(tile), spec).numpy(),
        jy.reshape(7, 15))


def test_load_rejects_other_model_types(tmp_path):
    """Every PopPUNK model type loads (BGMM, DBSCAN, refine, lineage);
    any other type string is refused, as the JAX package refuses it."""
    import pickle

    pkl = tmp_path / "m_fit.pkl"
    with open(pkl, "wb") as f:
        pickle.dump([None, "kmeans"], f)
    np.savez(tmp_path / "m_fit.npz", scale=np.ones(2))
    with pytest.raises(RuntimeError, match="Undefined model type: kmeans"):
        load_cluster_fit(str(pkl), str(tmp_path / "m_fit.npz"))


@pytest.mark.cuda
def test_likelihood_on_card_at_a_million_rows():
    """The fused classification sees a whole query chunk (512 x n_ref
    rows) at once; torch.linalg.solve_triangular against such a wide
    right-hand side is wrong on CUDA (models/vbgmm.py::mahalanobis).
    float64 on the CPU is the oracle; tolerance LL_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = mixture(9)
    X = np.random.default_rng(10).uniform(0, 0.9, (1 << 20, 2))
    want = GaussianMixture.from_numpy(*params).double().log_likelihood(
        torch.as_tensor(X))[1]
    got = GaussianMixture.from_numpy(*params, device="cuda").log_likelihood(
        torch.as_tensor(X, dtype=torch.float32, device="cuda"))[1]
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **LL_TOL)
