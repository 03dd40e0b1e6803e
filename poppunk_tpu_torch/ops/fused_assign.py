"""Model classification fused into the distance pass (BGMM).

Counterpart of poppunk_tpu/ops/fused_assign.py for BGMM models: the query
chunk's (core, accessory) tile is classified on the device it was computed
on, so serving fetches distances and classes in one pass instead of
shipping the |Q| x |R| matrix to the host and back.

    spec = (name, static, params);  POST_FNS[name](dists, params, static)

Models without a device classifier here (every type but BGMM, until ported)
get no spec, and ``assign`` takes the two-pass route, as the reference
does for lineage models. The reference's ``bgmm_stable`` post serves only
poppunk_tpu/serve.py and is ported with it; ``--stable`` assignment picks
each query's nearest reference on the host, as the reference's does.
"""

import numpy as np
import torch


def _post_bgmm(dists, params, static):
    """Component argmax of the weighted Gaussian log-likelihood, int8 of
    shape dists.shape[:-1] (reference _post_bgmm)."""
    from ..models.bgmm import log_likelihood

    _, lpr = log_likelihood(dists.reshape(-1, 2), *params)
    return lpr.argmax(dim=1).to(torch.int8).reshape(dists.shape[:-1])


POST_FNS = {
    "bgmm": _post_bgmm,
}


def model_post_spec(model):
    """(name, static, params) classifying pairs like ``model.assign``, or
    None if the model has no fused classifier in this package."""
    if getattr(model, "type", None) != "bgmm":
        return None
    params = tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32)
                   for a in (model.weights, model.means, model.covariances,
                             model.scale))
    return ("bgmm", (), params)


def apply_post(dists, post_spec):
    """Classify a [..., 2] distance tile; the parameters follow the tile
    to its device."""
    name, static, params = post_spec
    params = tuple(p.to(dists.device) for p in params)
    return POST_FNS[name](dists, params, static)
