"""ctypes bindings for the repository's native host kernels
(``native/pcrcg_native.cpp``): the port's own copy of
``pcrcg_tpu/native/__init__.py``.

Compiled on first use with ``g++ -O3 -fopenmp`` into
``build/pcrcg_tpu_torch/`` under the repository root (git-ignored), named
by a hash of the source.  These are the host counterparts of the
reference's cpp_wrappers: grid subsampling and radius searches for dataset
preprocessing and budget calibration (``data/calibrate.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
_SRC = _REPO / "native" / "pcrcg_native.cpp"
_BUILD_DIR = _REPO / "build" / "pcrcg_tpu_torch"
_lib: Optional[ctypes.CDLL] = None


def _build() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = _BUILD_DIR / f"pcrcg_native_{digest}.so"
    if not so_path.exists():
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", str(_SRC),
               "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except subprocess.CalledProcessError:
            cmd.remove("-fopenmp")  # a toolchain without OpenMP
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    return so_path


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(_build()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        _lib.grid_subsample.argtypes = [f32p, ctypes.c_int, ctypes.c_float, f32p, ctypes.c_int]
        _lib.grid_subsample.restype = ctypes.c_int
        _lib.radius_neighbors.argtypes = [
            f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_float, ctypes.c_int, i32p,
        ]
        _lib.radius_neighbors.restype = ctypes.c_int
        _lib.radius_count.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_float, i32p]
        _lib.radius_count.restype = ctypes.c_int
    return _lib


def grid_subsample(points: np.ndarray, dl: float, cap: Optional[int] = None) -> np.ndarray:
    """Barycenters of the occupied ``dl`` voxels of ``points`` [n, 3]."""
    points = np.ascontiguousarray(points, np.float32)
    cap = cap or points.shape[0]
    out = np.empty((cap, 3), np.float32)
    n_out = lib().grid_subsample(points, points.shape[0], dl, out, cap)
    return out[:n_out]


def radius_neighbors(queries: np.ndarray, supports: np.ndarray, radius: float,
                     k: int) -> np.ndarray:
    """[nq, k] support indices within ``radius`` of each query (padded with
    the support count)."""
    queries = np.ascontiguousarray(queries, np.float32)
    supports = np.ascontiguousarray(supports, np.float32)
    out = np.empty((queries.shape[0], k), np.int32)
    lib().radius_neighbors(queries, queries.shape[0], supports, supports.shape[0], radius, k, out)
    return out


def radius_count(queries: np.ndarray, supports: np.ndarray, radius: float) -> np.ndarray:
    """[nq] count of supports within ``radius`` of each query."""
    queries = np.ascontiguousarray(queries, np.float32)
    supports = np.ascontiguousarray(supports, np.float32)
    out = np.empty(queries.shape[0], np.int32)
    lib().radius_count(queries, queries.shape[0], supports, supports.shape[0], radius, out)
    return out
