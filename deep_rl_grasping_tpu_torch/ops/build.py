"""Build the port's CUDA kernels with plain `nvcc` and load them with ctypes.

All `csrc/*.cu` sources compile in one `nvcc` call into one shared library
with a plain C interface (no PyTorch headers, no PyTorch JIT extension loader,
no ninja). The library lands in `_build/` inside the package (gitignored),
named by a hash of the sources and flags, so later runs in the same
checkout reuse it. Nothing here runs at import time: `library()` builds on
first use.
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
    # name: (argtypes, restype); pointers and the stream as c_void_p
    "solver_run": ([_P] * 24, _I),
    "solver_limits": ([_P], _I),
    "raster_run": ([_P] * 14, _I),
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


def source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, path, reused, seconds, log):
        self.path = path
        self.reused = reused
        self.build_seconds = seconds
        self.build_log = log
        self.lib = ctypes.CDLL(path)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = restype

    def __getattr__(self, name):
        return getattr(self.lib, name)


_lock = threading.Lock()
_loaded: dict = {}


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library. The first
    call in a process hashes the sources; later calls return that library."""
    if "current" in _loaded:
        return _loaded["current"]
    with _lock:
        if "current" in _loaded:
            return _loaded["current"]
        key = source_hash()
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"libgrasp_kernels_{key}.so")
        t0 = time.perf_counter()
        log = ""
        reused = os.path.isfile(path)
        if not reused:
            nvcc = find_nvcc()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise BuildError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            os.replace(tmp, path)
        lib = KernelLibrary(path, reused, time.perf_counter() - t0, log)
        _loaded["current"] = lib
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
