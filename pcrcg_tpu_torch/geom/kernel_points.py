"""KPConv kernel-point dispositions (numpy only).

The port's copy of ``pcrcg_tpu/geom/kernel_points.py::layer_kernel_points``:
the canonical disposition cached in ``dispositions/`` (the same file the
JAX package ships; K=15, center fixed, the layout every shipped config
uses) plus the per-layer random z-rotation, 0.01 jitter and radius scale
(reference kernels/kernel_points.py:433-468).  Both packages therefore
give every layer bit-identical kernel points.  Other dispositions are
optimized by the JAX package (``kernel_dispositions``) and not ported.
"""
from __future__ import annotations

import functools
import os

import numpy as np

_CACHE_DIR = os.path.join(os.path.dirname(__file__), "dispositions")


@functools.lru_cache(maxsize=8)
def kernel_dispositions(
    num_points: int = 15, dimension: int = 3, fixed: str = "center"
) -> np.ndarray:
    """Canonical unit-radius disposition [K, D] from the cached file."""
    path = os.path.join(_CACHE_DIR, f"k_{num_points:03d}_{fixed}_{dimension}d.npy")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no cached kernel disposition {os.path.basename(path)}; the port "
            "ships K=15 (center fixed, 3-D) only"
        )
    return np.load(path)


def layer_kernel_points(
    radius: float,
    num_points: int = 15,
    dimension: int = 3,
    fixed: str = "center",
    seed: int = 0,
) -> np.ndarray:
    """Per-layer kernel points: canonical disposition + random z-rotation +
    0.01 jitter, scaled to ``radius`` (reference kernel_points.py:433-468)."""
    kp = kernel_dispositions(num_points, dimension, fixed).copy()
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 2 * np.pi)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=np.float32)
    kp = kp + rng.normal(scale=0.01, size=kp.shape).astype(np.float32)
    kp = radius * kp
    return (kp @ rot).astype(np.float32)
