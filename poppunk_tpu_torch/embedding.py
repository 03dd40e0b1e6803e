"""Stochastic cluster embedding (SCE / mandrake) in torch.

Counterpart of poppunk_tpu/embedding.py. The reference shells out to the
external C++/CUDA ``SCE.wtsne`` package (PopPUNK/mandrake.py:67-110): an
asynchronous per-edge SGD over a kNN graph of accessory distances. Here,
as in the JAX package, it is batched: up to DENSE_LIMIT points every epoch
applies the exact t-SNE gradient over the dense [n, n] affinities
(momentum, adaptive gains, early exaggeration); above it, attraction over
all kNN edges at once and repulsion from freshly sampled negatives, with
bounded per-sample forces. Both optimisers run as torch ops on the
resolved device, their randomness drawn from a ``torch.Generator`` seeded
from ``seed`` on that device. maxIter counts single-pair updates for CLI
compatibility and is converted to batched epochs.

The sampled step's scatter-adds are ``index_add_``, whose float order on
CUDA is not fixed: two runs on the card agree to rounding, not bit for bit.

The perplexity calibration and the .dot writer are copies of the JAX
package's host code. Output: a graphviz .dot of node positions named
``<p>_perplexity<P>_accessory_mandrake.dot`` (mandrake.py:62), coordinates
scaled 5x as the reference writes them.
"""

import os
import sys

import numpy as np
import torch

from . import _device


def _perplexity_probabilities(dists, perplexity, n_iter=50):
    """Per-row bandwidth calibration: binary-search beta so the conditional
    distribution over the kNN has the requested perplexity (standard t-SNE
    input calibration). dists: [n, k].

    All rows search together on [n, k] arrays — a per-row Python loop is
    interpreter-bound at the scale tier (65k rows x 50 iterations)."""
    n, k = dists.shape
    target = np.log(max(min(perplexity, k - 1), 1))
    d2 = dists.astype(np.float64) ** 2
    beta = np.ones(n)
    beta_lo = np.zeros(n)
    beta_hi = np.full(n, np.inf)
    p = np.full((n, k), 1.0 / k)
    for _ in range(n_iter):
        raw = np.exp(-d2 * beta[:, None])
        s = raw.sum(axis=1)
        ok = s > 0
        p = np.where(ok[:, None], raw / np.maximum(s, 1e-300)[:, None],
                     1.0 / k)
        h = -(p * np.log(p + 1e-12)).sum(axis=1)
        done = np.abs(h - target) < 1e-4
        if done.all():
            break
        high = h > target  # entropy too high -> raise beta
        beta_lo = np.where(high & ~done, beta, beta_lo)
        beta_hi = np.where(~high & ~done, beta, beta_hi)
        beta = np.where(
            done, beta,
            np.where(high,
                     np.where(np.isinf(beta_hi), beta * 2,
                              (beta + beta_hi) / 2),
                     (beta + beta_lo) / 2))
    return p


# Above this many points (the JAX package's limit) the dense [n, n]
# gradient (exact t-SNE repulsion) gives way to sampled repulsion
# (LargeVis/SCE estimator).
DENSE_LIMIT = 8192


def _sce_optimize_dense(generator, Pmat, n, epochs, eta0=200.0, Y0=None):
    """Exact t-SNE gradient descent with momentum, adaptive gains and early
    exaggeration (sklearn-style schedule), on Pmat's device; each step
    holds the [n, n, 2] pair differences.

    Pmat: dense symmetric affinity tensor [n, n], rows need not be
    normalised (normalised globally here). Y0: the initial embedding
    [n, 2]; None draws it from ``generator`` (normal, scale 1e-4)."""
    device = Pmat.device
    if Y0 is None:
        Y0 = torch.randn((n, 2), generator=generator, device=device) * 1e-4
    P = Pmat / Pmat.sum().clamp(min=1e-12)
    exagg_end = epochs // 4
    Y = Y0.to(device=device, dtype=torch.float32)
    V = torch.zeros_like(Y)
    gains = torch.ones_like(Y)
    for it in range(epochs):
        exagg = 12.0 if it < exagg_end else 1.0
        momentum = 0.5 if it < exagg_end else 0.8

        d = Y[:, None, :] - Y[None, :, :]  # [n, n, 2]
        q = 1.0 / (1.0 + (d ** 2).sum(-1))  # [n, n]
        q.fill_diagonal_(0.0)
        Z = q.sum().clamp(min=1e-12)
        PQ = (exagg * P - q / Z) * q  # [n, n]
        g = 4.0 * (PQ[:, :, None] * d).sum(dim=1)  # dKL/dY

        # adaptive gains (sklearn _gradient_descent)
        same_sign = torch.sign(g) == torch.sign(V)
        gains = torch.where(same_sign, gains * 0.8, gains + 0.2).clamp(
            min=0.01)
        V = momentum * V - eta0 * gains * g
        Y = Y + V
        Y = Y - Y.mean(0)
    return Y


def _sce_optimize_sampled(generator, I, J, P, n, epochs, n_neg=5, eta0=1.0,
                          gamma=1.0, Y0=None, negatives=None):
    """Sampled-repulsion variant for large n: attraction over the kNN
    edge list, repulsion from per-edge negative samples with bounded
    per-sample forces (the LargeVis/UMAP gradient family, batched; the
    JAX package's docstring says why not the t-SNE q^2/Z estimator).
    Every sampled force is clipped to +-4 and each point's displacement
    is averaged over its contribution count. Linear eta decay, as the
    reference wtsne anneals.

    I, J: int64 edge ends, P: per-edge affinity, on one device. Y0: the
    initial embedding (None: normal, scale 1e-2, from ``generator``);
    negatives: int64 [epochs, E, n_neg] (None: drawn from ``generator``
    each epoch)."""
    device = P.device
    if Y0 is None:
        Y0 = torch.randn((n, 2), generator=generator, device=device) * 1e-2
    w = P / P.max().clamp(min=1e-12)  # per-edge weight in (0, 1]
    Y = Y0.to(device=device, dtype=torch.float32)
    # per-point step: the average of its (bounded) kicks, not the sum — a
    # hub with many edges must not take a proportionally huge step
    deg = torch.zeros(n, device=device)
    deg.index_add_(0, I, torch.full_like(w, 1.0 + n_neg))
    deg.index_add_(0, J, torch.ones_like(w))
    step_div = deg.clamp(min=1.0)[:, None]
    for it in range(epochs):
        eta = eta0 * (1.0 - it / epochs)

        # attraction along kNN edges: w * 2q * (y_i - y_j), clipped
        d = Y[I] - Y[J]  # [E, 2]
        d2 = (d ** 2).sum(-1)
        g_att = ((w * 2.0 / (1.0 + d2))[:, None] * d).clamp(-4, 4)
        g = torch.zeros_like(Y)
        g.index_add_(0, I, -g_att)
        g.index_add_(0, J, g_att)

        # repulsion: n_neg fresh negatives per edge, bounded kernel
        neg = (negatives[it] if negatives is not None else torch.randint(
            0, n, (I.shape[0], n_neg), generator=generator, device=device))
        dn = Y[I][:, None, :] - Y[neg]
        dn2 = (dn ** 2).sum(-1)
        rep = gamma * 2.0 / ((0.001 + dn2) * (1.0 + dn2))
        g_rep = ((w[:, None] * rep)[:, :, None] * dn).clamp(-4, 4)
        g.index_add_(0, I, g_rep.sum(dim=1))

        Y = Y + eta * g / step_div
        Y = Y - Y.mean(0)
    return Y


def sce_embedding_condensed(acc_vec, n, perplexity, knn=50,
                            max_iter=10_000_000, seed=42, device=None):
    """2-D SCE embedding straight from a condensed accessory-distance
    vector (no n x n square materialised), on ``device`` (None:
    ``_device.resolve``'s choice)."""
    from .ops.sparse_knn import knn_from_condensed

    knn = min(knn, n - 1)
    I, J, dists = knn_from_condensed(acc_vec, n, knn)
    return _sce_from_knn(I, J, dists, n, knn, perplexity, max_iter, seed,
                         device)


def sce_embedding(acc_mat, perplexity, knn=50, max_iter=10_000_000, seed=42,
                  device=None):
    """2-D SCE embedding of a square accessory-distance matrix, on
    ``device`` (None: ``_device.resolve``'s choice)."""
    from .ops.sparse_knn import get_knn_distances

    n = acc_mat.shape[0]
    knn = min(knn, n - 1)
    I, J, dists = get_knn_distances(acc_mat, knn)
    return _sce_from_knn(I, J, dists, n, knn, perplexity, max_iter, seed,
                         device)


def _sce_from_knn(I, J, dists, n, knn, perplexity, max_iter, seed,
                  device=None):
    device = _device.resolve(device)
    P = _perplexity_probabilities(
        np.asarray(dists).reshape(n, knn), perplexity
    ).reshape(-1)

    # reference maxIter counts single-edge updates; we do all E edges/epoch
    # (floor 1 so a small --iter stays an honest speed/quality knob)
    epochs = int(min(max(max_iter // max(len(I), 1), 1), 1000))
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    if n <= DENSE_LIMIT:
        Pmat = np.zeros((n, n), dtype=np.float32)
        Pmat[np.asarray(I), np.asarray(J)] += P
        Pmat[np.asarray(J), np.asarray(I)] += P  # symmetrise
        Y = _sce_optimize_dense(
            generator, torch.from_numpy(Pmat).to(device), n=n, epochs=epochs)
    else:
        as_index = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=torch.int64, device=device)
        Y = _sce_optimize_sampled(
            generator, as_index(I), as_index(J),
            torch.as_tensor(P, dtype=torch.float32, device=device),
            n=n, epochs=epochs)
    return Y.cpu().numpy()


def generate_embedding(seq_labels, acc_mat, perplexity, out_prefix, overwrite,
                       kNN=50, maxIter=10_000_000, n_threads=1, seed=42,
                       condensed=False, device=None):
    """Write the embedding .dot (generate_embedding, mandrake.py:22-120),
    the optimiser on ``device`` (None: ``_device.resolve``'s choice).

    ``acc_mat`` is a square accessory matrix, or with condensed=True the
    condensed i<j vector (no square ever materialised)."""
    device = _device.resolve(device)
    mandrake_filename = os.path.join(
        out_prefix,
        os.path.basename(out_prefix)
        + "_perplexity" + str(perplexity) + "_accessory_mandrake.dot",
    )
    if os.path.isfile(mandrake_filename) and not overwrite:
        sys.stderr.write(
            "Mandrake analysis already exists; add --overwrite to replace\n"
        )
        return mandrake_filename

    sys.stderr.write("Running SCE embedding\n")
    if condensed:
        embedding = sce_embedding_condensed(
            np.asarray(acc_mat), len(seq_labels), perplexity, knn=kNN,
            max_iter=maxIter, seed=seed, device=device)
    else:
        embedding = sce_embedding(np.asarray(acc_mat), perplexity, knn=kNN,
                                  max_iter=maxIter, seed=seed, device=device)
    write_mandrake_dot(seq_labels, embedding, mandrake_filename)
    return mandrake_filename


def embedding_from_knn(I, J, dists, n, knn, perplexity, max_iter=10_000_000,
                       seed=42, device=None):
    """2-D SCE embedding straight from a kNN triple — the scale tier's
    entry (poppunk_tpu_torch/scale.py accumulates the accessory kNN inside
    the distance pass, so no square accessory matrix ever exists; the
    reference's mandrake needs one, mandrake.py:60-67), the optimiser on
    ``device`` (None: ``_device.resolve``'s choice)."""
    return _sce_from_knn(I, J, dists, n, knn, perplexity, max_iter, seed,
                         device)


def write_mandrake_dot(seq_labels, embedding, mandrake_filename):
    """The reference's .dot output (mandrake.py:112-120)."""
    with open(mandrake_filename, "w") as n_file:
        n_file.write("graph G { ")
        for s, seq_label in enumerate(seq_labels):
            n_file.write(
                f'"{seq_label}"[x="{str(5 * float(embedding[s][0]))}"'
                f',y="{str(5 * float(embedding[s][1]))}"]; '
            )
        n_file.write("}\n")
