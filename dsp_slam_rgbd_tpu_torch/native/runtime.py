"""ctypes bindings for the native host runtime (built on first use).

The port's copy of `dsp_slam_rgbd_tpu/native/runtime.py` over its own
copy of the C++ source, `src/runtime.cc`: the KITTI velodyne reader,
voxel downsampling, box cropping and a double-buffered background file
prefetcher.  `g++ -O3` builds the library at first use into the port's
git-ignored build directory (`csrc/_build/`, beside the CUDA kernels),
named after a hash of the source and the flags, so a stale library is
never loaded.  A failed build raises: nothing falls back to numpy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src", "runtime.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "csrc", "_build")
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_lock = threading.Lock()
_lib = None


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdsruntime-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *FLAGS, SRC, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SRC} failed:\n{proc.stderr}")
    os.replace(tmp, path)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.isfile(path):
            _build(path)
        lib = ctypes.CDLL(path)
        f, lng = ctypes.POINTER(ctypes.c_float), ctypes.c_long
        lib.read_velodyne.restype = lng
        lib.read_velodyne.argtypes = [ctypes.c_char_p, f, lng]
        lib.voxel_downsample.restype = lng
        lib.voxel_downsample.argtypes = [f, lng, ctypes.c_float, f, lng]
        lib.box_crop.restype = lng
        lib.box_crop.argtypes = [f, lng, f, f, f, f, lng]
        lib.prefetcher_create.restype = ctypes.c_void_p
        lib.prefetcher_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), lng]
        lib.prefetcher_get.restype = lng
        lib.prefetcher_get.argtypes = [ctypes.c_void_p, lng, ctypes.POINTER(ctypes.c_ubyte),
                                       lng]
        lib.prefetcher_size.restype = lng
        lib.prefetcher_size.argtypes = [ctypes.c_void_p, lng]
        lib.prefetcher_destroy.restype = None
        lib.prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_velodyne(path: str, max_pts: int = 200000) -> np.ndarray:
    """(N, 3) f32 xyz of a KITTI float32 x, y, z, reflectance .bin file."""
    lib = get_lib()
    out = np.empty((max_pts, 3), np.float32)
    n = lib.read_velodyne(path.encode(), _fp(out), max_pts)
    if n < 0:
        raise IOError(f"cannot read {path}")
    return out[:n].copy()


def voxel_downsample(pts: np.ndarray, voxel: float, max_out: int = 100000) -> np.ndarray:
    """The first point of every occupied voxel."""
    lib = get_lib()
    pts = np.ascontiguousarray(pts, np.float32)
    out = np.empty((max_out, 3), np.float32)
    n = lib.voxel_downsample(_fp(pts), len(pts), voxel, _fp(out), max_out)
    return out[:n].copy()


def box_crop(pts: np.ndarray, R: np.ndarray, t: np.ndarray, half_extent: np.ndarray,
             max_out: int = 100000) -> np.ndarray:
    """Points p with |Rᵀ(p − t)| <= half_extent component-wise."""
    lib = get_lib()
    pts = np.ascontiguousarray(pts, np.float32)
    R = np.ascontiguousarray(R, np.float32)
    t = np.ascontiguousarray(t, np.float32)
    h = np.ascontiguousarray(half_extent, np.float32)
    out = np.empty((max_out, 3), np.float32)
    n = lib.box_crop(_fp(pts), len(pts), _fp(R), _fp(t), _fp(h), _fp(out), max_out)
    return out[:n].copy()


class Prefetcher:
    """Background double-buffered file reader: `get(i)` returns file i's
    bytes and starts reading file i + 1."""

    def __init__(self, paths: list[str]):
        lib = get_lib()
        self._names = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._h = lib.prefetcher_create(self._names, len(paths))
        self._lib = lib
        self.paths = paths

    def get(self, idx: int) -> bytes:
        size = self._lib.prefetcher_size(self._h, idx)
        if size < 0:
            raise IOError(f"cannot read {self.paths[idx]}")
        out = np.empty(size, np.uint8)
        got = self._lib.prefetcher_get(
            self._h, idx, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), size)
        return out[:got].tobytes()

    def close(self):
        if self._h:
            self._lib.prefetcher_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
