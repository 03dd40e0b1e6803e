"""Host network code, copied from poppunk_tpu/network/gt_format.py (that
package loads jax on import); its imports point at this package.

graph-tool ``.gt`` binary format reader (the JAX package's module also
writes the format; this package only reads it).

The reference saves/loads networks as graph-tool ``.gt`` files by default
(PopPUNK/network.py:1855-1874 write, :120-176 read), so every published
PopPUNK database ships a ``_graph.gt``. This module implements the
published format description (graph-tool docs, "The gt file format")
without graph-tool, so those databases drop straight into this framework.

Layout (all multi-byte ints in the file's declared endianness):

  1. magic  ``⛾ gt`` (6 bytes: ``e2 9b be 20 67 74``)
  2. version (1 byte, currently 1)
  3. endianness (1 byte bool: True = big endian)
  4. comment: uint64 length + bytes
  5. directed (1 byte bool)
  6. N = number of vertices (uint64)
  7. out-adjacency: per vertex, the out-degree as a uint64, then that
     many target indices each encoded with the smallest uint that can
     hold N (1/2/4/8 bytes) — only the index values are compact, the
     degree is full-width (a multigraph's degree can exceed N).
     Undirected graphs store each edge once, in the source vertex's
     list.
  8. property maps: uint64 count, then per map: key type (1 byte —
     0 graph / 1 vertex / 2 edge), name (uint64 len + bytes), value type
     index (1 byte into _VALUE_TYPES), then one value per key element
     (edge values follow adjacency order).

Reading tolerates unknown/unsupported property value types by bailing out
of the property section (the structure is already parsed).
"""

import struct

import numpy as np

MAGIC = b"\xe2\x9b\xbe gt"

_VALUE_TYPES = [
    "bool", "int16_t", "int32_t", "int64_t", "double", "long double",
    "string", "vector<bool>", "vector<int16_t>", "vector<int32_t>",
    "vector<int64_t>", "vector<double>", "vector<long double>",
    "vector<string>", "python::object",
]

_SCALAR_FMT = {
    "bool": "?", "int16_t": "h", "int32_t": "i", "int64_t": "q",
    "double": "d",
}


def _index_dtype(n, big_endian):
    order = ">" if big_endian else "<"
    if n < 2**8:
        return np.dtype(order + "u1")
    if n < 2**16:
        return np.dtype(order + "u2")
    if n < 2**32:
        return np.dtype(order + "u4")
    return np.dtype(order + "u8")


class _Reader:
    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.order = "<"

    def raw(self, n):
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated .gt file")
        self.pos += n
        return out

    def u64(self):
        return struct.unpack(self.order + "Q", self.raw(8))[0]

    def scalar(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(self.order + fmt, self.raw(size))[0]

    def string(self):
        return self.raw(self.u64()).decode("utf-8", errors="replace")

    def array(self, dtype, count):
        nbytes = dtype.itemsize * count
        arr = np.frombuffer(self.raw(nbytes), dtype=dtype)
        return arr


def _read_property_value(r, value_type, count):
    """Read `count` values of the given type; returns a list/array."""
    if value_type in _SCALAR_FMT:
        fmt = _SCALAR_FMT[value_type]
        dtype = np.dtype(r.order + {"?": "?", "h": "i2", "i": "i4",
                                    "q": "i8", "d": "f8"}[fmt])
        return r.array(dtype, count)
    if value_type == "string":
        return [r.string() for _ in range(count)]
    if value_type.startswith("vector<"):
        inner = value_type[len("vector<"):-1]
        out = []
        for _ in range(count):
            k = r.u64()
            out.append(_read_property_value(r, inner, k))
        return out
    raise ValueError(f"unsupported .gt property type {value_type}")


def read_gt(path):
    """Parse a .gt file.

    Returns (n_vertices, edges[int64 E x 2], directed, props) where props
    maps (key_type, name) -> values; property parsing is best-effort (a
    dict possibly missing maps whose value types are unsupported).
    """
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    if r.raw(6) != MAGIC:
        raise ValueError(f"{path} is not a graph-tool .gt file (bad magic)")
    version = r.raw(1)[0]
    if version > 1:
        raise ValueError(f"unsupported .gt version {version}")
    big_endian = bool(r.raw(1)[0])
    r.order = ">" if big_endian else "<"
    r.string()  # comment
    directed = bool(r.raw(1)[0])
    n = r.u64()
    idx_dtype = _index_dtype(n, big_endian)

    srcs, tgts = [], []
    for v in range(n):
        deg = r.u64()
        if deg:
            targets = r.array(idx_dtype, deg).astype(np.int64)
            srcs.append(np.full(deg, v, dtype=np.int64))
            tgts.append(targets)
    if srcs:
        edges = np.stack([np.concatenate(srcs), np.concatenate(tgts)], axis=1)
    else:
        edges = np.zeros((0, 2), dtype=np.int64)

    props = {}
    try:
        n_props = r.u64()
        for _ in range(n_props):
            key_type = r.raw(1)[0]
            name = r.string()
            vt = _VALUE_TYPES[r.raw(1)[0]]
            count = {0: 1, 1: n, 2: edges.shape[0]}[key_type]
            props[(key_type, name)] = _read_property_value(r, vt, count)
    except (ValueError, IndexError, KeyError) as e:
        # A property value type we cannot size (long double /
        # python::object / corrupt payload) makes every LATER map
        # unreachable — byte offsets can't be resynced. The graph
        # structure and all maps parsed so far are intact; say what was
        # dropped instead of silently losing e.g. a later weight map.
        import sys

        sys.stderr.write(
            f"WARNING: {path}: stopped reading .gt property maps ({e}); "
            f"kept {sorted(nm for _, nm in props)}\n")
    return int(n), edges, directed, props
