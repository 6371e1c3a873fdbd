"""Build the package's CUDA kernels at first use and load them with ctypes.

`nvcc` compiles every `csrc/*.cu` into an object, all sources at once in
parallel processes, and links them into one shared library with a plain C
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
FLAGS = ["-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's build
ptxas_log: str = ""                  # nvcc's -Xptxas -v report of that build
lib_path: str = ""                   # the loaded library


class KernelBuildError(RuntimeError):
    pass


def use_sources(csrc: str) -> None:
    """Build from the kernel sources in `csrc` (another checkout's `csrc/`,
    whose C interface is this one's) instead of this package's.  The
    library's name hashes the sources, so both builds share `_build/`.
    Only before the first `load` of the process."""
    global CSRC
    with _lock:
        if _lib is not None:
            raise RuntimeError("the kernel library is already loaded")
        CSRC = os.path.abspath(csrc)


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
    lib.mlp_sdf_value.argtypes = [i, p, i, p, i, p, p, p, i, p, p, p, p]
    lib.mlp_sdf_value.restype = i
    lib.mlp_sdf_jacobian.argtypes = [i, p, i, p, i, p, p, p, i, p, p, p, p, p, p, p]
    lib.mlp_sdf_jacobian.restype = i
    for pre in ("mlp_sdf", "mlp_sdf256"):
        for name in ("_value_tc_config", "_jacobian_tc_config", "_f32_config"):
            getattr(lib, pre + name).argtypes = [ctypes.POINTER(i)]
            getattr(lib, pre + name).restype = i
        getattr(lib, pre + "_f32_tiling").argtypes = [i, i]
        getattr(lib, pre + "_f32_tiling").restype = i
    lib.mlp_sdf_f32_force_tiling.argtypes = [i]
    lib.mlp_sdf_f32_force_tiling.restype = i
    q = ctypes.c_int64
    for name in ("segment_sum_table_f32", "segment_sum_table_f64"):
        getattr(lib, name).argtypes = [ctypes.POINTER(q), i, p]
        getattr(lib, name).restype = i
    for name in ("segment_offsets_i32", "segment_offsets_i64"):
        getattr(lib, name).argtypes = [p, q, q, p, p]
        getattr(lib, name).restype = i
    for name in ("schur_pcg_solve", "schur_pcg_launch"):
        getattr(lib, name).argtypes = [ctypes.POINTER(q), i, i, p]
        getattr(lib, name).restype = i
    lib.normal_solve_launch.argtypes = [ctypes.POINTER(q), i, ctypes.POINTER(ctypes.c_float), i,
                                        i, p]
    lib.normal_solve_launch.restype = i
    lib.normal_solve_sizes.argtypes = [q, q, ctypes.POINTER(q)]
    lib.normal_solve_sizes.restype = i
    lib.mlp_sdf_error_string.argtypes = [i]
    lib.mlp_sdf_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, built from the sources on first call."""
    global _lib, build_seconds, ptxas_log, lib_path
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        cu = [s for s in srcs if s.endswith(".cu")]
        out = os.path.join(BUILD_DIR, f"libdsp_kernels_{_digest(srcs)}.so")
        if not os.path.isfile(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            nvcc = _nvcc()
            t0 = time.perf_counter()
            objs = [f"{tmp}.{os.path.basename(c)}.o" for c in cu]
            try:
                procs = [subprocess.Popen([nvcc, *FLAGS, "-Xptxas", "-v", "-c", "-o", o, c],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True) for c, o in zip(cu, objs)]
                logs = [p.communicate()[0] for p in procs]
                ptxas_log = "".join(logs)
                for p, log in zip(procs, logs):
                    if p.returncode != 0:
                        raise KernelBuildError(f"nvcc failed ({p.returncode}):\n{log[-4000:]}")
                link = subprocess.run([nvcc, "-gencode", ARCH, "-shared", "-o", tmp, *objs],
                                      capture_output=True, text=True)
            finally:
                for o in objs:
                    if os.path.exists(o):
                        os.remove(o)
            build_seconds = time.perf_counter() - t0
            if link.returncode != 0:
                raise KernelBuildError(f"nvcc link failed ({link.returncode}):\n"
                                       f"{link.stderr[-4000:]}")
            os.replace(tmp, out)
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            raise KernelBuildError(f"cannot load {out}: {e}") from e
        _declare(lib)
        _lib, lib_path = lib, out
        return lib
