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


# the unit roundoff of float32
_U32 = 2.0 ** -24


def fit_rounding_bound(jaccards, klist, evaluations=1, dj=None):
    """Per pair, a first-order bound on how far a float32 evaluation of
    _fit_math can land from the exact fit of the same float32 Jaccards:
    numpy [..., K] -> float64 [..., 2] (core, accessory).

    It holds for any order of the six sums and any association of the
    w k y products: logf and expf within 2 ulp, the products, the
    divisions and the 2 x 2 solve rounded once each, a sum of m nonzero
    terms off by (m - 1) u of their magnitudes. The normal equations
    cancel at pairs with few usable k far from k = 0, where the bound
    reaches 1e-4 and more: there the fit is not determined to DIST_TOL in
    float32, by the JAX package or by the port. ``evaluations`` 2 bounds
    the gap between two float32 evaluations; ``dj`` [..., K] adds the
    propagation of a difference between their Jaccards (pairs whose usable
    k differ get no bound: 0)."""
    j = np.asarray(jaccards, np.float64)
    k = np.asarray(klist, np.float64)
    u = evaluations * _U32
    pos = j > 0
    y = np.where(pos, np.log(np.where(pos, j, 1.0)), 0.0)
    m = pos.sum(-1)
    sw, sk, skk = m.astype(np.float64), pos @ k, pos @ (k * k)
    ay = np.abs(y)
    sy, sky = y.sum(-1), y @ k
    # logf (4u), the product (u) and the sum ((m - 1) u) of each term
    dsy = (m + 3) * u * ay.sum(-1)
    dsky = (m + 4) * u * (ay @ k)
    same = True
    if dj is not None:
        dj = np.asarray(dj, np.float64)
        dy = np.where(pos, np.abs(dj) / np.where(pos, j, 1.0), 0.0)
        dsy = dsy + dy.sum(-1)
        dsky = dsky + dy @ k
        same = (pos == (j - dj > 0)).all(-1)
    fit = (sw >= 2) & same
    det = np.where(fit, sw * skk - sk * sk, 1.0)
    sw1, skk1 = np.maximum(sw, 1.0), np.maximum(skk, 1.0)
    n1 = sw * sky - sk * sy
    b1 = n1 / det
    db1 = ((sw * dsky + sk * dsy + u * (np.abs(sw * sky) + np.abs(sk * sy)
                                        + np.abs(n1))) / det
           + 2 * u * np.abs(b1))
    b0 = (sy - b1 * sk) / sw1
    db0 = ((dsy + sk * db1 + u * (np.abs(b1 * sk) + np.abs(sy - b1 * sk)))
           / sw1 + 2 * u * np.abs(b0))
    # the boundary candidates b1 = sky / skk (b0 = 0), b0 = sy / sw (b1 = 0):
    # whichever is taken, its error and its exp are at most the larger
    db1 = np.maximum(db1, dsky / skk1 + 2 * u * np.abs(sky) / skk1)
    db0 = np.maximum(db0, dsy / sw1 + 2 * u * np.abs(sy) / sw1)
    top1 = np.maximum(np.minimum(b1, 0.0), np.minimum(sky / skk1, 0.0))
    top0 = np.maximum(np.minimum(b0, 0.0), np.minimum(sy / sw1, 0.0))
    core = np.exp(top1 + db1) * (db1 + 4 * u) + u
    acc = np.exp(top0 + db0) * (db0 + 4 * u) + u
    return np.where(fit[..., None], np.stack([core, acc], -1), 0.0)
