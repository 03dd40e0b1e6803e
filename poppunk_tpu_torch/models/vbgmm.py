"""Variational-Bayes Gaussian mixture in PyTorch.

Counterpart of poppunk_tpu/models/vbgmm.py, itself a re-design of the
reference's sklearn BayesianGaussianMixture fit (PopPUNK/bgmm.py:38-43:
n_init=5, full covariances, Dirichlet-process stick-breaking prior with
weight_concentration_prior=0.1, mean_precision_prior=0.1, mean prior 0).

The ``n_init`` random restarts run together on a leading batch dimension
(the JAX package vmaps them). Each restart stops updating once its
per-sample lower bound moves by at most ``tol`` or it reaches
``max_iter``, exactly as each lane of the reference's vmapped while-loop
freezes at its own convergence. The functions below take any number of
leading batch dimensions. No padding: the reference pads to shape buckets
only to bound jit recompiles.
"""

import math

import torch


def _kmeans_init(generator, X, k, n_init, iters=10):
    """Random-point seeding + Lloyd iterations, hard responsibilities
    [n_init, n, k] (the reference's _kmeans_init, one per restart)."""
    n = X.shape[0]
    u = torch.rand((n_init, k), generator=generator, device=X.device)
    idx = torch.floor(u * n).long().clamp(max=n - 1)
    centers = X[idx]  # [B, k, d]

    def nearest(centers):
        d2 = ((X[None, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
        return torch.nn.functional.one_hot(d2.argmin(dim=-1), k).to(X.dtype)

    for _ in range(iters):
        onehot = nearest(centers)  # [B, n, k]
        counts = onehot.sum(dim=1)  # [B, k]
        sums = onehot.transpose(1, 2) @ X  # [B, k, d]
        centers = torch.where(counts[..., None] > 0,
                              sums / counts.clamp(min=1)[..., None], centers)
    return nearest(centers)


def _estimate_params(X, resp, prior):
    """Gaussian-Wishart posterior parameters from responsibilities
    resp [..., n, K]."""
    beta0, m0, nu0, psi0 = prior
    nk = resp.sum(dim=-2) + 1e-10  # [..., K]
    xbar = (resp.transpose(-1, -2) @ X) / nk[..., None]  # [..., K, d]
    diff = X[..., :, None, :] - xbar[..., None, :, :]  # [..., n, K, d]
    sk = torch.einsum("...nk,...nki,...nkj->...kij", resp, diff, diff) \
        / nk[..., None, None]
    beta_k = beta0 + nk
    m_k = (beta0 * m0 + nk[..., None] * xbar) / beta_k[..., None]
    nu_k = nu0 + nk
    dm = xbar - m0
    psi_k = (psi0 + nk[..., None, None] * sk
             + (beta0 * nk / beta_k)[..., None, None]
             * dm[..., None, :] * dm[..., :, None])
    return nk, xbar, beta_k, m_k, nu_k, psi_k


def inverse_factor(chol):
    """The inverse of each lower Cholesky factor chol [..., K, d, d], by a
    d x d triangular solve against the identity.

    Solving against the [d, n] right-hand side directly, as the JAX package
    does, is wrong on CUDA once n reaches about a million columns:
    torch.linalg.solve_triangular returned residuals near 40 at n = 2^20 on
    an H100 (torch 2.11, CUDA 12.8)."""
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    return torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                         upper=False)


def whitened_norms(linv, diff):
    """Squared Mahalanobis distances [..., n, K] of diff [..., n, K, d]
    under inverse factors linv [..., K, d, d] (``inverse_factor``)."""
    y = torch.einsum("...kij,...nkj->...nki", linv, diff)
    return (y ** 2).sum(-1)


def mahalanobis(chol, diff):
    """Squared Mahalanobis distances [..., n, K] of diff [..., n, K, d]
    under lower Cholesky factors chol [..., K, d, d]: the inverse factor
    formed once per component and applied with einsum."""
    return whitened_norms(inverse_factor(chol), diff)


def _stick_breaking_terms(nk, gamma0):
    """(a, b) of the DP stick-breaking posterior Beta(a, b) per component."""
    tail = torch.flip(torch.cumsum(torch.flip(nk, [-1]), -1), [-1]) - nk
    return 1.0 + nk, gamma0 + tail


def _log_resp(X, gamma0, nk, beta_k, m_k, nu_k, psi_k):
    """Variational E-step: unnormalised log responsibilities [..., n, K]."""
    d = X.shape[-1]
    digamma = torch.special.digamma

    a, b = _stick_breaking_terms(nk, gamma0)
    ln_v = digamma(a) - digamma(a + b)
    ln_1mv = digamma(b) - digamma(a + b)
    ln_pi = ln_v + torch.cat([torch.zeros_like(ln_1mv[..., :1]),
                              torch.cumsum(ln_1mv, -1)[..., :-1]], -1)

    chol = torch.linalg.cholesky(psi_k)  # [..., K, d, d]
    logdet_psi = 2.0 * torch.log(
        torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    i = torch.arange(d, dtype=X.dtype, device=X.device)
    ln_lambda = (digamma((nu_k[..., None] - i) / 2.0).sum(-1)
                 + d * math.log(2.0) - logdet_psi)

    maha = mahalanobis(chol, X[..., :, None, :] - m_k[..., None, :, :])

    return (ln_pi[..., None, :] + 0.5 * ln_lambda[..., None, :]
            - 0.5 * d / beta_k[..., None, :]
            - 0.5 * nu_k[..., None, :] * maha
            - 0.5 * d * math.log(2 * math.pi))


def fit_vbgmm(generator, X, k, gamma0=0.1, beta0=0.1, max_iter=100, tol=1e-3,
              n_init=5, init_resp=None):
    """Fit on X [n, d] (float32, on the fit's device).

    ``init_resp`` ([n, k] or [n_init, n, k]) replaces the k-means starting
    responsibilities, so a test can start this and the JAX fit from the
    same point. Returns a dict of the best restart's weights / means /
    covariances (sklearn's conventions), lower bound, beta and nu."""
    X = X.to(torch.float32)
    n, d = X.shape
    m0 = torch.zeros(d, dtype=X.dtype, device=X.device)
    Xc = X - X.mean(0)
    psi0 = (Xc.T @ Xc) / max(n - 1.0, 1.0)
    prior = (beta0, m0, float(d), psi0)

    if init_resp is None:
        resp = _kmeans_init(generator, X, k, n_init)
    else:
        resp = torch.as_tensor(init_resp, dtype=X.dtype, device=X.device)
        resp = resp.expand(n_init, n, k).clone()

    lb = torch.full((n_init,), -math.inf, device=X.device)
    delta = torch.full((n_init,), math.inf, device=X.device)
    it = torch.zeros(n_init, dtype=torch.int64, device=X.device)
    active = it < max_iter
    while bool(active.any()):
        nk, _, beta_k, m_k, nu_k, psi_k = _estimate_params(X, resp, prior)
        log_rho = _log_resp(X, gamma0, nk, beta_k, m_k, nu_k, psi_k)
        log_norm = torch.logsumexp(log_rho, dim=-1, keepdim=True)
        new_lb = log_norm[..., 0].mean(-1)  # per-sample lower-bound proxy
        resp = torch.where(active[:, None, None],
                           torch.exp(log_rho - log_norm), resp)
        delta = torch.where(active, new_lb - lb, delta)
        lb = torch.where(active, new_lb, lb)
        it = it + active
        active = (it < max_iter) & (delta.abs() > tol)

    nk, _, beta_k, m_k, nu_k, psi_k = _estimate_params(X, resp, prior)
    best = int(torch.argmax(lb))  # first maximum on ties, like jnp.argmax
    a, b = _stick_breaking_terms(nk[best], gamma0)
    tmp = b / (a + b)
    weights = a / (a + b) * torch.cat([torch.ones_like(tmp[:1]),
                                       torch.cumprod(tmp[:-1], 0)])
    return {
        "weights": weights / weights.sum(),
        "means": m_k[best],
        "covariances": psi_k[best] / nu_k[best][:, None, None],
        "lower_bound": lb[best],
        "beta": beta_k[best],
        "nu": nu_k[best],
    }
