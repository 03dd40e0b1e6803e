"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/libpoppunk_kernels_<hash>.so csrc/*.cu

The library name carries a hash of the sources and flags, so an edited
kernel is rebuilt and a stale one is never loaded. The build runs at the
first CUDA use in a process; it needs ``nvcc`` (``$CUDA_HOME/bin``, then
``PATH``, then ``/usr/local/cuda/bin``) and raises with nvcc's stderr if
the compiler is missing or refuses the source.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None
build_seconds = None  # wall time of this process's build (None: cached)


def find_nvcc():
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the "
        "CUDA kernels of poppunk_tpu_torch cannot be built")


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def library_path():
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libpoppunk_kernels_{digest.hexdigest()[:16]}.so")


def build():
    """Compile the kernels unless this source hash is built; return the
    library path."""
    global build_seconds
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc()] + NVCC_FLAGS + ["-o", tmp] + _sources()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    build_seconds = time.perf_counter() - t0
    return out


def load():
    """The kernels' ctypes library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.match_counts_launch.restype = ci
        lib.match_counts_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci,
                                            ci, vp]
        _lib = lib
    return _lib
