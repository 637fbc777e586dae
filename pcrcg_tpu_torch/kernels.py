"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface, loaded through ``ctypes``.  Libraries go to
``build/pcrcg_tpu_torch/`` under the repository root (git-ignored), named
by a hash of the source and the shared headers (``csrc/*.cuh``), so an
edited source is rebuilt and an unchanged one is built once.
``build_all`` starts one ``nvcc`` per source at the same time.  Nothing is
compiled at import: the first launch (or an explicit ``build_all``)
builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "pcrcg_tpu_torch"
SOURCES = ("search_distances", "kpconv_tiled", "kpconv_bwd", "tile_scatter", "kpconv_fused",
           "kpconv_reduce")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}

# CUDA launches per kernel (K1..K8 of the kernel table in PERF.md; both
# entries of K3 count under K3): each wrapper adds one where it launches
# its kernel; plain versions never count.
LAUNCHES: Dict[str, int] = {f"K{i}": 0 for i in range(1, 9)}


def count_launch(kernel_id: str) -> None:
    LAUNCHES[kernel_id] += 1


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_log(name: str) -> str:
    """What ``nvcc`` (with ``-Xptxas -v``) printed for ``name``'s build."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns seconds per source built (0.0 when cached)."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter(), tmp, out,
        )
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def bind(name: str, fn_name: str, signature: str):
    """The C function ``fn_name`` of ``csrc/<name>.cu`` with its argument
    types declared from ``signature``, one letter per argument (p pointer
    or stream, i int, f float); it returns a CUDA error code (int)."""
    fn = getattr(library(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[ch] for ch in signature]
        fn.restype = ctypes.c_int
    return fn


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device,
            shape: Optional[tuple] = None) -> None:
    """Validate a kernel argument: device, dtype, contiguity and shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
