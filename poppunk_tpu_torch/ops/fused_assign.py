"""Model classification fused into the distance pass.

Counterpart of poppunk_tpu/ops/fused_assign.py for refine / threshold
boundaries, BGMM and DBSCAN models: the query chunk's (core, accessory)
tile is classified on the device it was computed on, so assignment
fetches distances and classes in one pass instead of shipping the
|Q| x |R| matrix to the host and back.

    spec = (name, static, params);  POST_FNS[name](dists, params, static)

A lineage model has no device classifier and gets no spec: ``assign``
keeps the distances and extends the model's kNN on the host, as the
reference does. The ``*_stable`` posts serve ``serve.AssignSession``: per
query, the nearest reference on one distance column (the first minimum on
ties, as ``np.argmin``) and whether that pair is within-strain, int32
``[nq, 2]``, so a request fetches O(queries) integers from the device.
The CLI's ``--stable`` assignment picks each query's nearest reference on
the host, as the reference's does. The ``edges`` post serves the session
in network mode: every pair classified by the model's own post, and per
query only its within-strain pairs leave the device, compacted row by row
(``_post_edges``).

A caller that classifies many tiles with one model places its spec once
(``post_spec_on``), which factors a BGMM's covariances on that device; a
spec of the raw parameters factors them on every call, with the same
numbers.
"""

import numpy as np
import torch


def _boundary_sign(dists, params, slope):
    """int8 sign of each pair's signed distance to a line boundary (torch
    twin of ops/boundary.assign_threshold, reference
    src/boundary.cpp:42-80); within-strain pairs are -1."""
    scale, x_max, y_max = params
    Xs = dists.reshape(-1, 2) / scale
    x0 = Xs[:, 0]
    y0 = Xs[:, 1]
    if slope == 2:
        d = torch.where(
            (x_max == 0) | (y_max == 0),
            torch.sqrt(x0 * x0 + y0 * y0),
            y0 * x_max + x0 * y_max - x_max * y_max,
        )
    elif slope == 0:
        d = x0 - x_max
    elif slope == 1:
        d = y0 - y_max
    else:
        raise ValueError("slope must be 0, 1 or 2")
    return torch.sign(d).to(torch.int8)


def _post_boundary(dists, params, static):
    """Boundary sign per pair, of shape dists.shape[:-1] (reference
    _post_boundary)."""
    (slope,) = static
    return _boundary_sign(dists, params, slope).reshape(dists.shape[:-1])


def _post_bgmm(dists, params, static):
    """Component argmax of the weighted Gaussian log-likelihood, int8 of
    shape dists.shape[:-1] (reference _post_bgmm). ``params`` is the
    mixture factored once (``post_spec_on``) or its raw (weights, means,
    covariances, scale), factored here on every call."""
    from ..models.bgmm import (MixtureFactor, component_log_probs,
                               factor_mixture)

    if not isinstance(params, MixtureFactor):
        params = factor_mixture(*params)
    lpr = component_log_probs(dists.reshape(-1, 2), params)
    return lpr.argmax(dim=1).to(torch.int8).reshape(dists.shape[:-1])


def _dbscan_grid_label(dists, params):
    """Cluster label per pair from the quantised approximate_predict grid
    (DBSCANFit.decision_grid): scale, locate the cell by float32 division
    and truncation, clip, gather (reference _dbscan_grid_label)."""
    grid, x0, dx, y0, dy, scale = params
    res = grid.shape[0]
    Xs = dists.reshape(-1, 2) / scale
    ix = ((Xs[:, 0] - x0) / dx).to(torch.int32).clamp_(0, res - 1)
    iy = ((Xs[:, 1] - y0) / dy).to(torch.int32).clamp_(0, res - 1)
    return grid[ix.long(), iy.long()]


def _post_dbscan(dists, params, static):
    """Predicted HDBSCAN cluster per pair, int16 of shape dists.shape[:-1]
    (reference _post_dbscan: PopPUNK/models.py:192 approximate_predict
    semantics, grid-quantised)."""
    return _dbscan_grid_label(dists, params).reshape(dists.shape[:-1])


def _nearest_within(dists, classes, dist_col, within):
    """int32 [nq, 2] of (nn_index, within_flag): each query's first
    minimum on ``dist_col`` (torch.argmin keeps the first, as jnp.argmin)
    and whether that pair's class equals ``within``."""
    nn = dists[..., dist_col].argmin(dim=-1)
    hit = torch.gather(classes, -1, nn[..., None])[..., 0] == within
    return torch.stack([nn.to(torch.int32), hit.to(torch.int32)], dim=-1)


def _post_boundary_stable(dists, params, static):
    """Fused --stable serving with a boundary: within = the nearest pair's
    sign is -1 (reference _post_boundary_stable)."""
    slope, dist_col = static
    sign = _boundary_sign(dists, params, slope).reshape(dists.shape[:-1])
    return _nearest_within(dists, sign, dist_col, -1)


def _post_bgmm_stable(dists, params, static):
    """Fused --stable serving for BGMM models: within = the nearest pair's
    component argmax is the model's within label (reference
    _post_bgmm_stable)."""
    dist_col, within_label = static
    return _nearest_within(dists, _post_bgmm(dists, params, ()), dist_col,
                           within_label)


def _post_dbscan_stable(dists, params, static):
    """Fused --stable serving for DBSCAN models: within = the nearest
    pair's grid label is the model's within label (reference
    _post_dbscan_stable)."""
    dist_col, within_label = static
    return _nearest_within(dists, _post_dbscan(dists, params, ()), dist_col,
                           within_label)


def _post_edges(dists, params, static):
    """Network-mode serving: every pair classified by the post ``base``
    (static: base, its static, the within label). Returns (int32 [nq, 2]
    of each query's first-minimum core nearest reference and its number
    of within-strain pairs, int32 [nq * nr] whose first sum(counts)
    entries are the references of those pairs, row by row, in order).
    The compaction is a stable partition by one scatter, so nothing waits
    for the device to learn the count."""
    base, base_static, within = static
    hit = POST_FNS[base](dists, params, base_static) == within
    nq, nr = hit.shape
    flat = hit.reshape(-1)
    place = torch.cumsum(flat, 0) - 1  # int64: the hit's place in the list
    k = torch.arange(flat.shape[0], device=flat.device)
    # a miss goes after every hit, in order: total + misses before it
    dest = torch.where(flat, place, place[-1] + k - place)
    cols = torch.empty(flat.shape[0], dtype=torch.int32, device=flat.device)
    cols.scatter_(0, dest, (k % nr).to(torch.int32))
    head = torch.stack([dists[..., 0].argmin(dim=-1).to(torch.int32),
                        hit.sum(dim=-1, dtype=torch.int32)], dim=-1)
    return head, cols


POST_FNS = {
    "boundary": _post_boundary,
    "boundary_stable": _post_boundary_stable,
    "bgmm": _post_bgmm,
    "bgmm_stable": _post_bgmm_stable,
    "dbscan": _post_dbscan,
    "dbscan_stable": _post_dbscan_stable,
    "edges": _post_edges,
}


def _f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def model_post_spec(model, slope=None):
    """(name, static, params) classifying pairs like ``model.assign`` (for
    a refine model, like ``model.assign(X, slope=slope)``), or None if the
    model has no device classifier (lineage). DBSCAN uses the quantised
    decision grid built from the exact host predictor: exact for any pair
    more than half a grid cell from a decision boundary."""
    model_type = getattr(model, "type", None)
    if model_type == "refine":
        if slope is None:
            slope = model.slope
        if slope == 2:
            x_max, y_max = model.optimal_x, model.optimal_y
        elif slope == 0:
            x_max, y_max = model.core_boundary, 0.0
        else:
            x_max, y_max = 0.0, model.accessory_boundary
        return ("boundary", (int(slope),),
                (_f32(model.scale), _f32(x_max), _f32(y_max)))
    if model_type == "bgmm":
        return ("bgmm", (), tuple(_f32(a) for a in (
            model.weights, model.means, model.covariances, model.scale)))
    if model_type == "dbscan" and hasattr(model, "hdb"):
        grid, x0, dx, y0, dy = model.decision_grid()
        return ("dbscan", (), (torch.as_tensor(grid),
                               *(_f32(a) for a in (x0, dx, y0, dy,
                                                   model.scale))))
    return None


def stable_post_spec(model, dist_col):
    """(name, static, params) of the fused --stable serving post (1-NN and
    within check on the device) for refine / threshold, BGMM and DBSCAN
    models; None for a lineage model."""
    base = model_post_spec(model)
    if base is None:
        return None
    name, static, params = base
    if name == "boundary":
        return ("boundary_stable", (static[0], int(dist_col)), params)
    return (name + "_stable", (int(dist_col), int(model.within_label)),
            params)


def edges_post_spec(model, slope=None):
    """(name, static, params) of the network-mode serving post: the
    model's own classifier (``model_post_spec(model, slope)``) with each
    query's within-strain pairs compacted on the device; None for a
    lineage model."""
    base = model_post_spec(model, slope)
    if base is None:
        return None
    name, static, params = base
    return ("edges", (name, static, int(model.within_label)), params)


def _on(params, device):
    """The parameters on ``device``, a factored mixture kept as one."""
    moved = (p.to(device) for p in params)
    return params._make(moved) if hasattr(params, "_make") else tuple(moved)


def post_spec_on(post_spec, device):
    """The spec with its parameters on ``device``, for a caller that
    classifies many tiles there (``apply_post`` then finds them in place).
    A BGMM classifier's covariances are factored here, once: factoring
    checks its result, which on a card waits for the queued work, so a
    post that factored on every tile would hold the host until the tile's
    distances were computed."""
    from ..models.bgmm import factor_mixture

    name, static, params = post_spec
    params = _on(params, device)
    classifier = static[0] if name == "edges" else name
    if classifier.removesuffix("_stable") == "bgmm":
        params = factor_mixture(*params)
    return name, static, params


def apply_post(dists, post_spec):
    """Classify a [..., 2] distance tile; the parameters follow the tile
    to its device."""
    name, static, params = post_spec
    return POST_FNS[name](dists, _on(params, dists.device), static)
