"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes). The
kernels reach the driver's ``cuTensorMapEncodeTiled`` through
``cudaGetDriverEntryPoint``, so nothing links against libcuda:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   # each
    nvcc -shared -o build/libpoppunk_kernels_<hash>.so *.o

The library name carries a hash of the sources, the headers they include
(``csrc/*.cuh``) and the flags, so an edited kernel or header is rebuilt and
a stale library is never loaded. The build runs at the
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
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-shared"]

_lib = None
build_seconds = None  # wall time of this process's build (None: cached)
# ptxas's per-kernel registers, stack and spills of the library's build,
# kept beside it (<library>.ptxas) and read back when it is cached
ptxas_report = None


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


def _headers():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def library_path():
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + _headers():
        digest.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libpoppunk_kernels_{digest.hexdigest()[:16]}.so")


def _run(cmds):
    """Run nvcc commands all at once; raise with the first failure's
    stderr. Returns their stderr, in order."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errs = [proc.communicate()[1] for proc in procs]
    for cmd, proc, err in zip(cmds, procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{err}")
    return errs


def build():
    """Compile the kernels unless this source hash is built; return the
    library path."""
    global build_seconds, ptxas_report
    out = library_path()
    if os.path.isfile(out):
        if ptxas_report is None and os.path.isfile(out + ".ptxas"):
            with open(out + ".ptxas") as f:
                ptxas_report = f.read()
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objects = [os.path.join(tmp_dir, os.path.basename(src) + ".o")
                   for src in _sources()]
        errs = _run([[nvcc] + NVCC_FLAGS + ["-c", "-o", obj, src]
                     for src, obj in zip(_sources(), objects)])
        tmp = os.path.join(tmp_dir, os.path.basename(out))
        _run([[nvcc] + LINK_FLAGS + ["-o", tmp] + objects])
        ptxas_report = "".join(errs)
        with open(tmp + ".ptxas", "w") as f:
            f.write(ptxas_report)
        os.replace(tmp + ".ptxas", out + ".ptxas")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    build_seconds = time.perf_counter() - t0
    return out


def load():
    """The kernels' ctypes library, built on first use, with its C
    functions' signatures declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.match_counts_launch.restype = ci
        lib.match_counts_launch.argtypes = (
            [vp, vp, vp] + [ci] * 5 + [ll] * 6 + [vp])
        lib.match_counts_packed_launch.restype = ci
        lib.match_counts_packed_launch.argtypes = (
            [vp, vp, vp] + [ci] * 7 + [ll] * 6 + [vp])
        cf = ctypes.c_float
        lib.dist_epilogue_launch.restype = ci
        lib.dist_epilogue_launch.argtypes = (
            [vp] * 6 + [ci] * 3 + [vp] + [cf] * 4 + [ci] * 3 + [vp])
        _lib = lib
    return _lib
