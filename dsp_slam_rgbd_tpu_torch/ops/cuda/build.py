"""Build the package's CUDA kernels at first use and load them with ctypes.

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds).  The library
is named after a hash of the sources and the flags, under `csrc/_build/`
(ignored by git), so a stale library is never loaded.  A failed build or
load raises; nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
ARCH = "arch=compute_90a,code=sm_90a"
FLAGS = ["-gencode", ARCH, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's build
ptxas_log: str = ""                  # nvcc's -Xptxas -v report of that build


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set NVCC or put it on PATH)")


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mlp_sdf_value.argtypes = [p, i, p, i, p, p, p, i, p, p]
    lib.mlp_sdf_value.restype = i
    lib.mlp_sdf_jacobian.argtypes = [p, i, p, i, p, p, p, i, p, p, p]
    lib.mlp_sdf_jacobian.restype = i
    lib.mlp_sdf_error_string.argtypes = [i]
    lib.mlp_sdf_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, built from the sources on first call."""
    global _lib, build_seconds, ptxas_log
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        cu = [s for s in srcs if s.endswith(".cu")]
        out = os.path.join(BUILD_DIR, f"libdsp_kernels_{_digest(srcs)}.so")
        if not os.path.isfile(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *FLAGS, "-Xptxas", "-v", "-o", tmp, *cu]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            ptxas_log = proc.stderr
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            raise KernelBuildError(f"cannot load {out}: {e}") from e
        _declare(lib)
        _lib = lib
        return lib
