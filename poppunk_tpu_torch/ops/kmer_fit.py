"""Per-pair core/accessory distances from per-k Jaccards, in PyTorch.

Counterpart of poppunk_tpu/ops/kmer_fit.py (same model, same closed form):

    log pr(k) = log(1 - a) + k * log(1 - c),  log(1 - a) <= 0, log(1 - c) <= 0

fitted for every pair at once by 2x2 normal equations over the ks with
jaccard > 0; if the unconstrained optimum leaves the box, the best of the
three boundary candidates (b0 = 0, b1 = 0, both 0) by SSE wins; pairs with
fewer than two usable ks are unrelated (core = accessory = 1).

The reference's ``_fit_math`` is written against a numpy/jnp namespace and
cannot take tensors (``.astype``, Python-scalar ``maximum``); this is the
same arithmetic in torch ops, in the same order.
"""

import numpy as np
import torch


def _fit_math(jaccards, klist):
    """jaccards [..., K], klist [K] (same dtype and device) ->
    (core, accessory), each [...]."""
    j = jaccards
    k = klist.to(j.dtype)
    pos = j > 0
    w = pos.to(j.dtype)
    y = torch.log(torch.where(pos, j, 1.0))

    sw = w.sum(dim=-1)
    sk = (w * k).sum(dim=-1)
    skk = (w * k * k).sum(dim=-1)
    sy = (w * y).sum(dim=-1)
    sky = (w * k * y).sum(dim=-1)
    syy = (w * y * y).sum(dim=-1)

    det = sw * skk - sk * sk
    det_ok = det.abs() > 1e-12
    safe_det = torch.where(det_ok, det, 1.0)
    b1_u = (sw * sky - sk * sy) / safe_det
    b0_u = torch.where(sw > 0, (sy - b1_u * sk) / sw.clamp(min=1.0), 0.0)

    def sse(b0, b1):
        return (syy - 2 * b0 * sy - 2 * b1 * sky + b0 * b0 * sw
                + 2 * b0 * b1 * sk + b1 * b1 * skk)

    zero = torch.zeros_like(b0_u)
    cand_b0 = [zero,
               torch.where(sw > 0, (sy / sw.clamp(min=1.0)).clamp(max=0.0),
                           0.0),
               zero]
    cand_b1 = [torch.where(skk > 0,
                           (sky / skk.clamp(min=1e-12)).clamp(max=0.0), 0.0),
               zero,
               zero]
    best_b0, best_b1 = cand_b0[0], cand_b1[0]
    best_sse = sse(best_b0, best_b1)
    for b0c, b1c in zip(cand_b0[1:], cand_b1[1:]):
        s = sse(b0c, b1c)
        take = s < best_sse
        best_b0 = torch.where(take, b0c, best_b0)
        best_b1 = torch.where(take, b1c, best_b1)
        best_sse = torch.where(take, s, best_sse)

    feasible_u = (b0_u <= 0) & (b1_u <= 0) & det_ok
    b0 = torch.where(feasible_u, b0_u, best_b0)
    b1 = torch.where(feasible_u, b1_u, best_b1)

    degenerate = sw < 2
    core = torch.where(degenerate, 1.0, 1.0 - torch.exp(b1))
    acc = torch.where(degenerate, 1.0, 1.0 - torch.exp(b0))
    return core, acc


def fit_kmer_curve_np(jaccards, klist):
    """Float64 oracle on the CPU: numpy [..., K] -> (core, accessory)
    numpy arrays (counterpart of the reference's fit_kmer_curve_np)."""
    core, acc = _fit_math(
        torch.as_tensor(np.asarray(jaccards, dtype=np.float64)),
        torch.as_tensor(np.asarray(klist, dtype=np.float64)))
    return core.numpy(), acc.numpy()
