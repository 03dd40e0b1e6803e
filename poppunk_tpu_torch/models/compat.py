"""Tolerant loading of ``_fit.pkl`` artefacts.

Copy of the unpickler in poppunk_tpu/models/compat.py (that package loads
jax on import). PopPUNK pickles live library objects into ``_fit.pkl``
(an sklearn BayesianGaussianMixture for BGMM, PopPUNK/models.py:341-354);
classes that cannot be imported here are replaced by ``ForeignStub``
subclasses that keep the pickled state, so published databases still
open. Parameters are read from the ``_fit.npz``.
"""

import pickle

# modules that must import normally (array payloads, containers)
_TRUSTED_ROOTS = {
    "numpy", "scipy", "collections", "builtins", "copyreg", "_codecs",
    "datetime", "functools",
}


class ForeignStub:
    """Placeholder instance for a pickled class that could not be
    imported; accepts any construction protocol pickle uses."""

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

    def append(self, item):
        self.__dict__.setdefault("__foreign_items__", []).append(item)

    def extend(self, items):
        self.__dict__.setdefault("__foreign_items__", []).extend(items)

    def __setitem__(self, key, value):
        self.__dict__.setdefault("__foreign_mapping__", {})[key] = value


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".", 1)[0] in _TRUSTED_ROOTS:
            return super().find_class(module, name)
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (ForeignStub,), {
                "__foreign_module__": module,
                "__foreign_qualname__": name,
                "__module__": module,
            })


def tolerant_pickle_load(f):
    """pickle.load from an open binary file, stubbing foreign classes."""
    return _TolerantUnpickler(f).load()
