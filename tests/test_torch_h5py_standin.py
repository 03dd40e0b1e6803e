"""A pickle-backed stand-in for h5py, and its test against h5py.

The sketch database (poppunk_tpu_torch/io/hdf5db.py, a copy of
poppunk_tpu/io/hdf5db.py) is HDF5 through h5py. Hosts
without h5py run the port's CLIs on this stand-in instead: chip_smoke.py
installs it there as ``sys.modules["h5py"]``. These classes behave as
h5py's groups, datasets and attributes do for every call hdf5db makes
(members iterate in name order, as h5py's do); a "file" is the pickled
tree, not HDF5. The test below holds the stand-in to h5py call by call;
test_torch_pipeline.py holds CLI runs on it to byte-identical outputs.
"""

import copy
import os
import pickle
import sys
import types

import numpy as np


class _H5Attrs(dict):
    def create(self, name, data):
        self[name] = data


class _H5Dataset:
    def __init__(self, data, dtype=None):
        self._data = np.array(data, dtype=dtype)
        self.attrs = _H5Attrs()

    @property
    def shape(self):
        return self._data.shape

    @property
    def dtype(self):
        return self._data.dtype

    def __array__(self, dtype=None, copy=None):  # noqa: A002 (numpy's name)
        return np.array(self._data, dtype=dtype)

    def __getitem__(self, index):
        return self._data[index]

    def __len__(self):
        return len(self._data)


class _H5Group:
    def __init__(self):
        self._members = {}
        self.attrs = _H5Attrs()

    def _walk(self, path, create=False):
        node, parts = self, [p for p in path.split("/") if p]
        for part in parts[:-1]:
            if part not in node._members:
                if not create:
                    raise KeyError(path)
                node._members[part] = _H5Group()
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

    def items(self):
        return [(k, self._members[k]) for k in self.keys()]

    def _put(self, path, obj):
        node, name = self._walk(path, create=True)
        if name in node._members:
            raise ValueError(f"name already exists: {path}")
        node._members[name] = obj
        return obj

    def create_group(self, path):
        return self._put(path, _H5Group())

    def require_group(self, path):
        return self[path] if path in self else self.create_group(path)

    def create_dataset(self, path, shape=None, dtype=None, data=None):
        if data is None:
            data = np.zeros(shape, dtype)
        return self._put(path, _H5Dataset(data, dtype))

    def copy(self, source, dest, name=None):
        obj = self[source] if isinstance(source, str) else source
        if isinstance(dest, _H5Group):
            dest._put(name or source.rstrip("/").split("/")[-1],
                      copy.deepcopy(obj))
        else:
            self._put(dest, copy.deepcopy(obj))

    def move(self, source, dest):
        obj = self[source]
        del self[source]
        self._put(dest, obj)


class _H5File(_H5Group):
    """``File(path, mode)``: r, r+, a, w, w- / x as in h5py; written back
    on close when opened for writing."""

    def __init__(self, path, mode="r"):
        super().__init__()
        self.filename = os.fspath(path)
        self._writable = mode != "r"
        exists = os.path.isfile(self.filename)
        if mode in ("w-", "x") and exists:
            raise FileExistsError(self.filename)
        if mode in ("r", "r+") and not exists:
            raise FileNotFoundError(self.filename)
        if exists and mode in ("r", "r+", "a"):
            with open(self.filename, "rb") as f:
                self._members, attrs = pickle.load(f)
            self.attrs = _H5Attrs(attrs)

    def close(self):
        if self._writable:
            with open(self.filename, "wb") as f:
                pickle.dump((self._members, dict(self.attrs)), f)
            self._writable = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def h5py_standin():
    """A module object to install as ``sys.modules["h5py"]``."""
    mod = types.ModuleType("h5py")
    mod.File = _H5File
    mod.string_dtype = lambda encoding="utf-8", length=None: object
    mod.__version__ = "stand-in"
    return mod


def install_h5py():
    """h5py if importable, else the stand-in above; returns which."""
    try:
        import h5py
    except ImportError:
        sys.modules["h5py"] = h5py_standin()
        return "stand-in (h5py not installed)"
    return "h5py " + h5py.__version__


def _exercise(h5, tmp_path):
    """hdf5db's calls, in its order; returns what a reader gets back."""
    import pytest

    tmp_path.mkdir()
    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    with pytest.raises(OSError):
        h5.File(a, "r")
    with h5.File(a, "a") as db:
        grp = db.require_group("sketches")
        grp.attrs["sketch_version"] = "v1"
        for name in ("s2", "s1"):
            s = grp.create_group(name)
            s.attrs["kmers"] = np.array([13, 17], dtype=np.int32)
            s.attrs["base_freq"] = np.array([0.3, 0.2, 0.2, 0.3])
            d = s.create_dataset("13", data=np.arange(4, dtype=np.uint64))
            d.attrs["kmer-size"] = 13
        rnd = db.create_group("random")
        rnd.attrs["k_min"] = 13
        rnd.create_dataset("table_values", data=np.arange(3))
        rnd.create_group("matches").create_dataset("13", data=np.ones(2))
    with h5.File(a, "r+") as db:
        db["sketches"].move("s2", "s2_query")
        assert db.require_group("sketches") is not None
    with pytest.raises(OSError):
        h5.File(a, "w-")
    with h5.File(a, "r") as h1, h5.File(b, "w") as h2:
        h1.copy("random", h2)
        out = h2.create_group("sketches")
        for attr, val in h1["sketches"].attrs.items():
            out.attrs.create(attr, val)
        out.copy(h1["sketches"]["s1"], "s1")
    seen = {}
    for path in (a, b):
        with h5.File(path, "r") as db:
            sk = db["sketches"]
            seen[path] = {
                "samples": list(sk),
                "version": str(sk.attrs.get("sketch_version")),
                "missing": sk.attrs.get("nothing", "default"),
                "kmers": [np.asarray(sk[n].attrs["kmers"]).tolist()
                          for n in sk],
                "freqs": np.asarray(sk["s1"].attrs["base_freq"]).tolist(),
                "usigs": np.asarray(sk["s1"]["13"]).tolist(),
                "kmer_size": int(sk["s1"]["13"].attrs["kmer-size"]),
                "random": [int(db["random"].attrs["k_min"]),
                           np.asarray(db["random/table_values"]).tolist(),
                           np.asarray(db["random"]["matches"]["13"]).tolist()],
                "has": ["random" in db, "sketches/s1" in db, "x" in db],
            }
    return list(seen.values())


def test_standin_reads_back_what_h5py_does(tmp_path):
    import h5py

    want = _exercise(h5py, tmp_path / "h5py")
    got = _exercise(h5py_standin(), tmp_path / "standin")
    assert got == want
