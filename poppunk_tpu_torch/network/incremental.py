"""ctypes bindings of the shared native graph core (native/graph_core.cpp).

Copied from poppunk_tpu/network/incremental.py (that package loads jax on
import), keeping what this package's path calls: the union-find components
and Brandes betweenness. The library is the repository's own
``native/libgraph_core.so``, built from ``native/graph_core.cpp`` with g++
on first use; both packages load the same file.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgraph_core.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "graph_core.cpp")
_graph_lib = None
_graph_lib_tried = False


def _get_graph_lib():
    """The native graph core (built on first use; None if unavailable)."""
    global _graph_lib, _graph_lib_tried
    if _graph_lib is not None or _graph_lib_tried:
        return _graph_lib
    _graph_lib_tried = True
    try:
        if (not os.path.isfile(_LIB_PATH) or
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)):
            cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                   "-fPIC", "-o", _LIB_PATH, _SRC_PATH]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
            except subprocess.CalledProcessError:
                # toolchains without OpenMP still get the serial build
                cmd.remove("-fopenmp")
                subprocess.run(cmd, check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.brandes_native.restype = None
        lib.brandes_native.argtypes = [
            ctypes.POINTER(ctypes.c_int64), i32p, ctypes.c_int32, i32p,
            ctypes.c_int64, f64p,
        ]
        lib.connected_components_native.restype = ctypes.c_int32
        lib.connected_components_native.argtypes = [
            i32p, i32p, ctypes.c_int64, ctypes.c_int32, i32p,
        ]
        _graph_lib = lib
    except Exception as e:  # noqa: BLE001 — callers fall back to scipy
        sys.stderr.write(f"Native graph core unavailable ({e})\n")
        _graph_lib = None
    return _graph_lib


def components_native(n_vertices, i_vec, j_vec):
    """(labels int32[n], sizes) via the C++ union-find; labels follow the
    scipy first-occurrence convention. None if the lib is unavailable."""
    lib = _get_graph_lib()
    if lib is None:
        return None
    # the C++ union-find indexes parent[] unchecked: validate before the
    # int32 cast, so bad edges raise as on the scipy path
    i_vec = np.asarray(i_vec)
    j_vec = np.asarray(j_vec)
    if len(i_vec) and (min(i_vec.min(), j_vec.min()) < 0
                       or max(i_vec.max(), j_vec.max()) >= n_vertices):
        raise IndexError("edge endpoint out of range "
                         f"[0, {int(n_vertices)})")
    i_vec = np.ascontiguousarray(i_vec, dtype=np.int32)
    j_vec = np.ascontiguousarray(j_vec, dtype=np.int32)
    labels = np.empty(int(n_vertices), dtype=np.int32)
    n_comp = lib.connected_components_native(
        i_vec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        j_vec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(i_vec.shape[0]), ctypes.c_int32(int(n_vertices)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels, np.bincount(labels, minlength=int(n_comp))


def brandes_native(A, sources):
    """Native Brandes betweenness over a CSR adjacency from the given
    sources, or None if the native library is unavailable."""
    lib = _get_graph_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    sources = np.ascontiguousarray(sources, dtype=np.int32)
    out = np.empty(A.shape[0], dtype=np.float64)
    lib.brandes_native(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(int(A.shape[0])),
        sources.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(sources.shape[0]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
