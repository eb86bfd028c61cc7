"""Build the port's CUDA kernels with plain `nvcc` and load them with ctypes.

Each `csrc/*.cu` source compiles into its own shared library with a plain C
interface (no PyTorch headers, no PyTorch JIT extension loader, no ninja);
the `nvcc` calls for all sources start together and run in parallel. The
libraries land in `_build/` inside the package (gitignored), each named by
its source and a hash of that source and the flags, so later runs in the
same checkout reuse them. Nothing here runs at import time: `library()`
builds on first use.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: (source, argtypes, restype); pointers and the stream as c_void_p
    "solver_run": ("solver.cu", [_P] * 24, _I),
    "solver_limits": ("solver.cu", [_P], _I),
    "solver_attributes": ("solver.cu", [_P], _I),
    "raster_run": ("raster.cu", [_P] * 14, _I),
    "raster_run_lists": ("raster.cu", [_P] * 15, _I),
}


class BuildError(RuntimeError):
    pass


def find_nvcc():
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise BuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels can only be built where the CUDA toolkit is installed")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def source_hash(path):
    """Hash of one source and the flags it is built with."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(os.path.basename(path).encode())
    with open(path, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def library_path(source):
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"libgrasp_{stem}_{source_hash(source)}.so")


class KernelLibrary:
    """The loaded shared libraries (one per source) plus what their builds
    reported: `paths` and `logs` by source file name, the wall seconds of
    the parallel build, and whether every library was already built."""

    def __init__(self, paths, reused, seconds, logs):
        self.paths = paths
        self.reused = reused
        self.build_seconds = seconds
        self.logs = logs
        self.libs = {src: ctypes.CDLL(path) for src, path in paths.items()}
        self._fns = {}
        for name, (src, argtypes, restype) in _SIGNATURES.items():
            fn = getattr(self.libs[src], name)
            fn.argtypes = argtypes
            fn.restype = restype
            self._fns[name] = fn

    def __getattr__(self, name):
        fns = self.__dict__.get("_fns", {})
        if name in fns:
            return fns[name]
        raise AttributeError(name)


_lock = threading.Lock()
_loaded: dict = {}


def _build_all(missing):
    """Start one nvcc per source (a path, or a file name under CSRC_DIR),
    all at once; wait for all. Returns each source's compiler output;
    raises if any build failed."""
    nvcc = find_nvcc()
    procs = {}
    for src, path in missing.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, path, cmd)
    logs, failed = {}, []
    for src, (proc, tmp, path, cmd) in procs.items():
        logs[src] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{logs[src]}")
        else:
            os.replace(tmp, path)
    if failed:
        raise BuildError("\n".join(failed))
    return logs


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel libraries. The first
    call in a process hashes the sources; later calls return those
    libraries."""
    if "current" in _loaded:
        return _loaded["current"]
    with _lock:
        if "current" in _loaded:
            return _loaded["current"]
        os.makedirs(BUILD_DIR, exist_ok=True)
        paths = {os.path.basename(src): library_path(src) for src in _sources()}
        missing = {src: path for src, path in paths.items() if not os.path.isfile(path)}
        t0 = time.perf_counter()
        logs = {src: "" for src in paths}
        if missing:
            logs.update(_build_all(missing))
        lib = KernelLibrary(paths, not missing, time.perf_counter() - t0, logs)
        _loaded["current"] = lib
        return lib


def load_source(source, label):
    """Build another tree's copy of one of the port's sources (its file name
    must be one of csrc/'s) with the same flags, into BUILD_DIR as
    libgrasp_<label>_<hash>.so, and load it with the C signatures of its
    file name. For comparing two versions of a kernel in one process."""
    name = os.path.basename(source)
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libgrasp_{label}_{source_hash(source)}.so")
    with _lock:
        if not os.path.isfile(path):
            _build_all({os.path.abspath(source): path})
    lib = ctypes.CDLL(path)
    for fn_name, (src, argtypes, restype) in _SIGNATURES.items():
        if src == name and hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
    return lib


def check_tensor(t, name, shape, dev):
    """Validate a float32 kernel argument before its pointer is passed."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
