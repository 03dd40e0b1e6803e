"""BGMM model: 2-D Bayesian Gaussian mixture fit + assignment in PyTorch.

Counterpart of poppunk_tpu/models/bgmm.py (PopPUNK/models.py:283-464 and
PopPUNK/bgmm.py):
- fit on the subsampled, max-scaled distance cloud with K components
  (VB-GMM, vbgmm.py), on the model's device;
- within-strain component = the used component whose mean is nearest the
  origin; between = the most-assigned component;
- assignment of every pair = argmax of the weighted Gaussian
  log-likelihood (PopPUNK/bgmm.py:100-174);
- artefacts _fit.npz + _fit.pkl, identical in layout to the JAX package's.

The fitted parameters live twice, as the reference keeps them: float64
numpy attributes (the artefact form, written to and read from _fit.npz)
and a ``GaussianMixture`` module whose float32 buffers sit on the device
that assigns.
"""

import math
import pickle
import sys
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .. import _device
from .base import ClusterFit
from .vbgmm import inverse_factor, whitened_norms


class MixtureFactor(NamedTuple):
    """A mixture's parameters with its covariances factored, as the
    likelihood reads them (``factor_mixture``)."""

    weights: torch.Tensor  # [K]
    means: torch.Tensor  # [K, d]
    scale: torch.Tensor  # [d]
    logdet: torch.Tensor  # [K], log-determinants of the covariances
    linv: torch.Tensor  # [K, d, d], inverses of their lower Cholesky factors


def factor_mixture(weights, means, covariances, scale):
    """The mixture with its covariances [K, d, d] factored on their device:
    each lower Cholesky factor's log-determinant and inverse. The factor is
    checked (a covariance that is not positive definite raises), which on a
    card waits for the queued work, so a caller that classifies many tiles
    with one mixture factors it once (ops/fused_assign.post_spec_on)."""
    chol = torch.linalg.cholesky(covariances)  # [K, d, d]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return MixtureFactor(weights, means, scale, logdet, inverse_factor(chol))


def component_log_probs(X, factor):
    """Weighted Gaussian log-likelihood lpr [n, K] of each row of X [n, d]
    under each component of a factored mixture."""
    weights, means, scale, logdet, linv = factor
    X = X / scale
    d = X.shape[1]
    maha = whitened_norms(linv, X[:, None, :] - means[None, :, :])  # [n, K]
    log_prob = -0.5 * (maha + d * math.log(2 * math.pi) + logdet[None, :])
    return log_prob + torch.log(weights)[None, :]


def log_likelihood(X, weights, means, covariances, scale):
    """Weighted Gaussian mixture log-likelihood of X [n, d] (torch twin of
    the reference's log_likelihood_device). Returns (logprob [n],
    lpr [n, K])."""
    lpr = component_log_probs(
        X, factor_mixture(weights, means, covariances, scale))
    return torch.logsumexp(lpr, dim=1), lpr


class GaussianMixture(nn.Module):
    """A fitted mixture's parameters as float32 device buffers."""

    def __init__(self, weights, means, covariances, scale):
        super().__init__()
        self.register_buffer("weights", weights)
        self.register_buffer("means", means)
        self.register_buffer("covariances", covariances)
        self.register_buffer("scale", scale)

    @classmethod
    def from_numpy(cls, weights, means, covariances, scale, device=None):
        """From the ``_fit.npz`` arrays (either package's, or PopPUNK's),
        on ``device`` (None: ``_device.resolve``'s choice)."""
        device = _device.resolve(device)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)

        return cls(t(weights), t(means), t(covariances), t(scale))

    def log_likelihood(self, X):
        return log_likelihood(X, self.weights, self.means, self.covariances,
                              self.scale)

    def forward(self, X):
        """Component argmax per row of X (unscaled distances)."""
        return self.log_likelihood(X)[1].argmax(dim=1)

    def responsibilities(self, X):
        logprob, lpr = self.log_likelihood(X)
        return torch.exp(lpr - logprob[:, None])


def find_within_label(means, assignments, rank=0):
    """Used component with mean nearest the origin (PopPUNK/bgmm.py:71-97)."""
    dists = {}
    norms = np.linalg.norm(np.asarray(means), axis=1)
    for comp, dist in enumerate(norms):
        if np.any(np.asarray(assignments) == comp):
            dists[comp] = dist
    sorted_dists = sorted(dists.items(), key=lambda kv: kv[1])
    return sorted_dists[rank][0]


def find_between_label_bgmm(means, assignments):
    """Most-assigned component (PopPUNK/bgmm.py:48-69)."""
    assignments = np.asarray(assignments)
    counts = [(c, int((assignments == c).sum())) for c in range(len(means))]
    return max(counts, key=lambda kv: kv[1])[0]


class BGMMFit(ClusterFit):
    def __init__(self, out_prefix, max_samples=100000, max_batch_size=100000,
                 assign_points=True, seed=42, device=None):
        ClusterFit.__init__(self, out_prefix, seed=seed)
        self.type = "bgmm"
        self.preprocess = True
        self.max_samples = max_samples
        self.max_batch_size = max_batch_size
        self.assign_points = assign_points
        self.device = _device.resolve(device)
        self.mixture = None

    def _set_params(self, weights, means, covariances, scale):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.means = np.asarray(means, dtype=np.float64)
        self.covariances = np.asarray(covariances, dtype=np.float64)
        self.scale = scale
        self.mixture = GaussianMixture.from_numpy(
            self.weights, self.means, self.covariances, scale, self.device)
        self.fitted = True

    def fit(self, X, max_components):
        from .vbgmm import fit_vbgmm

        ClusterFit.fit(self, X)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed)
        result = fit_vbgmm(
            generator,
            torch.as_tensor(self.subsampled_X, device=self.device),
            k=int(max_components),
        )
        self._set_params(*(result[key].cpu().numpy() for key in
                           ("weights", "means", "covariances")), self.scale)

        if self.assign_points:
            y = self.assign(X, max_batch_size=self.max_batch_size)
        else:
            y = self.assign(self.subsampled_X * self.scale,
                            max_batch_size=self.max_batch_size)
        self.within_label = find_within_label(self.means, y)
        self.between_label = find_between_label_bgmm(self.means, y)
        return y

    def assign(self, X, max_batch_size=100000, values=False, progress=True):
        """Component of every row of X (or responsibilities with
        ``values``), computed in batches on the model's device."""
        if not self.fitted:
            raise RuntimeError("Trying to assign using an unfitted model")
        if progress:
            sys.stderr.write("Assigning distances with BGMM model\n")
        fn = self.mixture.responsibilities if values else self.mixture
        outs = []
        for start in range(0, X.shape[0], max_batch_size):
            chunk = torch.as_tensor(
                np.asarray(X[start:start + max_batch_size]),
                dtype=torch.float32, device=self.device)
            outs.append(fn(chunk).cpu().numpy())
        out = np.concatenate(outs)
        return out if values else out.astype(int)

    def save(self):
        if not self.fitted:
            raise RuntimeError("Trying to save unfitted model")
        np.savez(
            self._artefact("_fit.npz"),
            weights=self.weights,
            means=self.means,
            covariances=self.covariances,
            within=self.within_label,
            between=self.between_label,
            scale=self.scale,
        )
        with open(self._artefact("_fit.pkl"), "wb") as f:
            # the JAX package's layout: raw parameter dict + type string
            pickle.dump([{"weights": self.weights, "means": self.means,
                          "covariances": self.covariances}, self.type], f)

    def load(self, fit_npz, fit_obj):
        self._set_params(fit_npz["weights"], fit_npz["means"],
                         fit_npz["covariances"], fit_npz["scale"])
        self.within_label = int(fit_npz["within"])
        self.between_label = int(fit_npz["between"])

    def plot(self, X, y):
        from ..plotting import plot_contours, plot_results  # matplotlib

        ClusterFit.plot(self, X)
        used = np.unique(y).size
        sys.stderr.write(
            f"Fit summary:\n\tNumber of components used\t{used}\n"
        )
        try:
            plot_results(
                X, y, self.means, self.covariances, self.scale,
                "DPGMM fit", self._artefact("_DPGMM_fit"),
            )
            subsampled_y = self.assign(self.subsampled_X * self.scale,
                                       progress=False) \
                if hasattr(self, "subsampled_X") else y
            plot_contours(self, subsampled_y, "DPGMM assignment boundary",
                          self._artefact("_DPGMM_fit_contours"))
        except Exception as e:  # plotting must never kill a fit
            sys.stderr.write(f"Plotting failed: {e}\n")
