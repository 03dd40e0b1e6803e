"""A file-backed stand-in for the part of h5py that the program's sketch
database (``poppunk_tpu_torch/io/hdf5db.py``) calls, for hosts without
h5py.

Frozen here from the repository's test scaffolding
(``tests/test_torch_h5py_standin.py``, where it is held to h5py call by
call), cut to what ``write_sketches``, ``read_sketches``,
``read_db_params`` and ``get_seqs_in_db`` use, so that a later change to
the tests cannot change what a cell runs. Groups, datasets and attributes
behave as h5py's do for those calls (members iterate in name order); a
"file" is the pickled tree, not HDF5. Where h5py reads only what an open
file is asked for, the stand-in reads the whole tree; so a file opened
read-only again, unchanged on disk, takes the tree its last read-only
open read (the program opens a database four times to serve it).

``install()`` puts it in ``sys.modules["h5py"]`` where h5py cannot be
imported, before the program loads; where h5py is installed it does
nothing.
"""

import os
import pickle
import sys
import types

import numpy as np


class _Attrs(dict):
    pass


class _Dataset:
    def __init__(self, data):
        self._data = np.array(data)
        self.attrs = _Attrs()

    def __array__(self, dtype=None, copy=None):  # noqa: A002 (numpy's name)
        return np.array(self._data, dtype=dtype)


class _Group:
    def __init__(self):
        self._members = {}
        self.attrs = _Attrs()

    def _walk(self, path, create=False):
        node, parts = self, [p for p in path.split("/") if p]
        for part in parts[:-1]:
            if part not in node._members:
                if not create:
                    raise KeyError(path)
                node._members[part] = _Group()
            node = node._members[part]
        return node, parts[-1]

    def __getitem__(self, path):
        node, name = self._walk(path)
        if name not in node._members:
            raise KeyError(path)
        return node._members[name]

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __delitem__(self, path):
        node, name = self._walk(path)
        del node._members[name]

    def __iter__(self):
        return iter(sorted(self._members))

    def __len__(self):
        return len(self._members)

    def keys(self):
        return sorted(self._members)

    def _put(self, path, obj):
        node, name = self._walk(path, create=True)
        if name in node._members:
            raise ValueError(f"name already exists: {path}")
        node._members[name] = obj
        return obj

    def create_group(self, path):
        return self._put(path, _Group())

    def require_group(self, path):
        return self[path] if path in self else self.create_group(path)

    def create_dataset(self, path, data):
        return self._put(path, _Dataset(data))


# the last tree a read-only open read: {(path, mtime, size): tree}
_READ = {}


class _File(_Group):
    """``File(path, mode)``: r, r+, a, w as in h5py; written back on close
    when opened for writing."""

    def __init__(self, path, mode="r"):
        super().__init__()
        self.filename = os.fspath(path)
        self._writable = mode != "r"
        exists = os.path.isfile(self.filename)
        if mode in ("r", "r+") and not exists:
            raise FileNotFoundError(self.filename)
        if exists and mode in ("r", "r+", "a"):
            self._members, attrs = self._load()
            self.attrs = _Attrs(attrs)

    def _load(self):
        st = os.stat(self.filename)
        key = (self.filename, st.st_mtime_ns, st.st_size)
        if not self._writable and key in _READ:
            return _READ[key]
        with open(self.filename, "rb") as f:
            tree = pickle.load(f)
        if not self._writable:
            _READ.clear()
            _READ[key] = tree
        return tree

    def close(self):
        if self._writable:
            with open(self.filename, "wb") as f:
                pickle.dump((self._members, dict(self.attrs)), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
            self._writable = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def install():
    """h5py's version if it imports; else the stand-in, installed as
    ``sys.modules["h5py"]``, and "stand-in"."""
    try:
        import h5py
    except ImportError:
        mod = types.ModuleType("h5py")
        mod.File = _File
        mod.__version__ = "stand-in"
        sys.modules["h5py"] = mod
        return "stand-in"
    return h5py.__version__
