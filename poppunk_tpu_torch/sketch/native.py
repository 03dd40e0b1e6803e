"""ctypes bindings for the native sketching core (native/sketch_core.cpp).

Drop-in replacement for the numpy sketch path: same bit-exact output
(asserted by tests/test_native_sketch.py), ~20-30x faster per core with
OpenMP across k-mer lengths. Falls back to numpy silently if the shared
library cannot be built (no compiler in the environment).

Copied from ``poppunk_tpu/sketch/native.py``, whose counterpart it is: this
package imports nothing of the JAX package.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsketch_core.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "sketch_core.cpp")

_lib = None
_tried = False


def _build():
    subprocess.run(
        ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
         "-o", _LIB_PATH, _SRC_PATH],
        check=True, capture_output=True)


def get_lib():
    """The loaded library, building it on first use; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.isfile(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.sketch_sequence_c.restype = ctypes.c_int
        lib.sketch_sequence_c.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        _lib = lib
    except Exception as e:  # noqa: BLE001 — fall back to numpy
        sys.stderr.write(f"Native sketch core unavailable ({e}); "
                         "using numpy path\n")
        _lib = None
    return _lib


def native_available():
    return get_lib() is not None


def sketch_codes_native(codes, params, threads=None, reads=False):
    """Native twin of minhash.sketch_codes: assembly and read inputs
    (exact / count-min multiplicity filtering, sketch/reader.py
    semantics) and codon-phased spaced seeds.

    ``threads`` bounds the OpenMP span across k-mer lengths; pass 1 when
    the caller already parallelises across genomes (the construct_database
    process pool), or None to span min(n_k, cores) for a single genome.

    Returns (usigs dict k -> uint64 array, densified flag) or None if the
    native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    klist = np.asarray(sorted(int(k) for k in params.klist), dtype=np.int32)
    n_k = len(klist)
    block = params.sketchsize64 * params.bbits
    out = np.empty(n_k * block, dtype=np.uint64)
    if threads is None:
        threads = min(n_k, os.cpu_count() or 1)
    min_count = params.min_count if reads else 0
    rc = lib.sketch_sequence_c(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(codes.shape[0]),
        klist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(n_k), ctypes.c_int(params.sketchsize64),
        ctypes.c_int(params.bbits), ctypes.c_int(1 if params.use_rc else 0),
        ctypes.c_int(int(min_count)),
        ctypes.c_int(1 if params.exact_counter else 0),
        ctypes.c_int(1 if params.codon_phased else 0),
        ctypes.c_int(threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc == -1:
        raise ValueError("Sequence too short to sketch: no k-mers hashed")
    if rc < 0:
        raise RuntimeError(f"native sketcher failed (code {rc})")
    usigs = {int(k): out[i * block:(i + 1) * block].copy()
             for i, k in enumerate(klist)}
    return usigs, bool(rc == 1)
