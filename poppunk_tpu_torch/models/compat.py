"""Tolerant loading of ``_fit.pkl`` artefacts.

Copy of poppunk_tpu/models/compat.py (that package loads jax on import).
PopPUNK pickles live library objects into ``_fit.pkl`` (an sklearn
BayesianGaussianMixture for BGMM, an hdbscan.HDBSCAN for DBSCAN,
PopPUNK/models.py:341-354, 613-630); classes that cannot be imported here
are replaced by ``ForeignStub`` subclasses that keep the pickled state, so
published databases still open. Parameters are read from the ``_fit.npz``;
for DBSCAN a working predictor is rebuilt from the foreign object's stored
training data (:func:`rebuild_hdbscan_from_state`).

The one change from the JAX package's copy: a class of the JAX package
itself (a DBSCAN ``_fit.pkl`` that package wrote holds a live
``poppunk_tpu.ops.hdbscan.HDBSCAN``) is never imported. Its HDBSCAN and
CondensedTree load as this package's own classes, any other as a
``ForeignStub``.
"""

import pickle
import sys

import numpy as np

# modules that must import normally (array payloads, containers)
_TRUSTED_ROOTS = {
    "numpy", "scipy", "collections", "builtins", "copyreg", "_codecs",
    "datetime", "functools",
}

# the JAX package's classes that load as this package's counterparts
_JAX_PACKAGE = "poppunk_tpu"
_PORTED_CLASSES = {("poppunk_tpu.ops.hdbscan", "HDBSCAN"),
                   ("poppunk_tpu.ops.hdbscan", "CondensedTree")}


class ForeignStub:
    """Placeholder instance for a pickled class we could not import.

    Accepts any construction protocol pickle uses (REDUCE/NEWOBJ calls
    with arbitrary args, BUILD with dict or (dict, slots) state) and
    exposes whatever instance state the producer stored."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        if args:
            obj.__dict__["__foreign_args__"] = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2:
            d, slots = state
            if d:
                self.__dict__.update(d)
            if slots:
                self.__dict__.update(slots)
        elif isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["__foreign_state__"] = state

    # Some producers pickle via __reduce__ returning (callable, args,
    # state, listitems, dictitems); pickle may append/setitem on the stub.
    def append(self, item):
        self.__dict__.setdefault("__foreign_items__", []).append(item)

    def extend(self, items):
        self.__dict__.setdefault("__foreign_items__", []).extend(items)

    def __setitem__(self, key, value):
        self.__dict__.setdefault("__foreign_mapping__", {})[key] = value

    def __repr__(self):
        return (f"<ForeignStub {getattr(self, '__foreign_module__', '?')}."
                f"{getattr(self, '__foreign_qualname__', '?')}>")


def _foreign_class(module, name):
    return type(name, (ForeignStub,), {
        "__foreign_module__": module,
        "__foreign_qualname__": name,
        "__module__": module,
    })


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".", 1)[0]
        if root in _TRUSTED_ROOTS:
            # a failure here is a real environment bug, not a foreign class
            return super().find_class(module, name)
        if root == _JAX_PACKAGE:
            # never import the JAX package (it loads jax)
            if (module, name) in _PORTED_CLASSES:
                from ..ops import hdbscan

                return getattr(hdbscan, name)
            return _foreign_class(module, name)
        try:
            return super().find_class(module, name)
        except Exception:
            return _foreign_class(module, name)


def tolerant_pickle_load(path_or_file):
    """pickle.load that survives foreign classes (hdbscan, old sklearn,
    PopPUNK internals) by stubbing them; see module docstring."""
    if hasattr(path_or_file, "read"):
        return _TolerantUnpickler(path_or_file).load()
    with open(path_or_file, "rb") as f:
        return _TolerantUnpickler(f).load()


def is_foreign(obj):
    return isinstance(obj, ForeignStub)


def _cluster_lambdas_from_condensed(tree, labels, n_points):
    """Per-final-label (birth_lambda, max_lambda) from an hdbscan
    condensed tree record array (fields parent/child/lambda_val).

    hdbscan's prediction data keeps, per selected cluster, the lambda at
    which the cluster was born and the largest (finite) lambda of any
    member point; the selected cluster node for a label is the lowest
    common ancestor (in the cluster hierarchy) of its member points'
    direct parents."""
    parent = np.asarray(tree["parent"], dtype=np.int64)
    child = np.asarray(tree["child"], dtype=np.int64)
    lam = np.asarray(tree["lambda_val"], dtype=np.float64)

    is_point = child < n_points
    point_parent = {}
    point_lambda = {}
    for p, c, l in zip(parent[is_point], child[is_point], lam[is_point]):
        point_parent[int(c)] = int(p)
        point_lambda[int(c)] = float(l)
    # cluster node -> (its parent cluster, birth lambda)
    cluster_parent = {int(c): (int(p), float(l))
                      for p, c, l in zip(parent[~is_point], child[~is_point],
                                         lam[~is_point])}

    def ancestors(node):
        out = [node]
        while node in cluster_parent:
            node = cluster_parent[node][0]
            out.append(node)
        return out

    birth, max_lam = {}, {}
    for lab in np.unique(labels):
        if lab < 0:
            continue
        members = np.flatnonzero(labels == lab)
        parents = {point_parent.get(int(m)) for m in members
                   if int(m) in point_parent}
        parents.discard(None)
        if not parents:
            birth[int(lab)] = 0.0
            max_lam[int(lab)] = 0.0
            continue
        # LCA: deepest node present in every member-parent's ancestor chain
        chains = [ancestors(p) for p in parents]
        common = set(chains[0])
        for ch in chains[1:]:
            common &= set(ch)
        # chains are ordered leaf->root, so the first common entry of any
        # chain is the deepest common ancestor
        lca = next(node for node in chains[0] if node in common)
        birth[int(lab)] = cluster_parent.get(lca, (None, 0.0))[1]
        finite = [point_lambda[int(m)] for m in members
                  if int(m) in point_lambda
                  and np.isfinite(point_lambda[int(m)])]
        max_lam[int(lab)] = max(finite) if finite else 0.0
    return birth, max_lam


def rebuild_hdbscan_from_state(state):
    """Build a working ops.hdbscan.HDBSCAN predictor from the instance
    state of a pickled (foreign) hdbscan.HDBSCAN.

    Uses ``_raw_data`` + ``labels_`` (+ ``_condensed_tree`` for the
    prediction thresholds when present; zero thresholds — no noise gate —
    otherwise).  Returns None when the state lacks training data."""
    from ..ops.hdbscan import HDBSCAN, core_distances

    X = state.get("_raw_data")
    labels = state.get("labels_")
    if X is None or labels is None:
        return None
    X = np.asarray(X, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.int64)
    if X.ndim != 2 or labels.shape[0] != X.shape[0]:
        return None

    min_cluster_size = state.get("min_cluster_size") or 5
    # hdbscan semantics: min_samples=None means "default to
    # min_cluster_size" (hdbscan_.py); only a truly absent field falls
    # back to 5 (via min_cluster_size's own default)
    min_samples = state.get("min_samples")
    if not min_samples:
        min_samples = min_cluster_size
    model = HDBSCAN(min_samples=int(min_samples),
                    min_cluster_size=int(min_cluster_size))
    model._X = X
    model.labels_ = labels
    model.probabilities_ = np.asarray(
        state.get("probabilities_", np.ones(X.shape[0])), dtype=np.float64)
    model._core, model._tree = core_distances(X, model.min_samples)

    tree = state.get("_condensed_tree")
    if tree is not None and getattr(tree, "dtype", None) is not None \
            and tree.dtype.names and "lambda_val" in tree.dtype.names:
        birth, max_lam = _cluster_lambdas_from_condensed(
            tree, labels, X.shape[0])
    else:
        sys.stderr.write(
            "Foreign DBSCAN fit has no condensed tree; prediction "
            "thresholds disabled (new points always join their nearest "
            "cluster)\n")
        birth = {int(l): 0.0 for l in np.unique(labels) if l >= 0}
        max_lam = dict(birth)
    model._cluster_birth_lambda = birth
    model._cluster_max_lambda = max_lam
    return model
