"""Frozen plain copy of the port's ``geom/kernel_points.py`` for the benchmark's
reference (it imports nothing of the port).  The original's text follows.

KPConv kernel-point dispositions (numpy only).

The port's copy of ``pcrcg_tpu/geom/kernel_points.py``: kernel points repel
each other (1/d² potential) inside an attractive radial potential with the
center fixed (``_optimize_dispositions``), or settle at the centroids of
their Voronoi cells on the unit ball (``spherical_lloyd``, the reference's
choice past K = 30; reference kernels/kernel_points.py:66-470).  The
canonical layout K = 15 (center fixed, 3-D, the one every shipped config
uses) ships in ``dispositions/``, the same file as the JAX package's; any
other is optimized once and cached under ``build/pcrcg_tpu_torch/
dispositions/`` at the repository root (git-ignored), never in the
package.  Each conv layer takes a randomly z-rotated, jittered and
radius-scaled copy (reference kernel_points.py:433-468), so both packages
give every layer bit-identical kernel points.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_SHIPPED_DIR = Path(__file__).resolve().parent / "dispositions"


def _optimize_dispositions(
    num_points: int,
    dimension: int = 3,
    fixed: str = "center",
    ratio: float = 0.66,
    num_candidates: int = 20,
    seed: int = 0,
) -> np.ndarray:
    """Gradient descent on the repulsion + radial energy; returns the best of
    ``num_candidates`` random restarts, scaled so the mean non-center radius
    is ``ratio`` (in a unit sphere)."""
    rng = np.random.default_rng(seed)

    # Random init inside the ball of radius ~0.7.
    points = rng.uniform(-1.0, 1.0, size=(num_candidates, num_points * 3, dimension))
    keep = []
    for c in range(num_candidates):
        p = points[c]
        p = p[np.sum(p**2, axis=1) < 0.5][:num_points]
        while p.shape[0] < num_points:
            extra = rng.uniform(-1.0, 1.0, size=(num_points * 3, dimension))
            extra = extra[np.sum(extra**2, axis=1) < 0.5]
            p = np.concatenate([p, extra], 0)[:num_points]
        keep.append(p)
    kernels = np.stack(keep)  # [C, K, D]
    if fixed == "center":
        kernels[:, 0, :] = 0.0

    step = 1e-2
    decay = 0.9995
    clip = 0.05
    thresh = 1e-5
    old_norms = np.zeros(kernels.shape[:2])
    final_norms = None
    for _ in range(10000):
        diff = kernels[:, :, None, :] - kernels[:, None, :, :]  # [C,K,K,D]
        d2 = np.sum(diff**2, axis=-1)
        # For point j the energy gradient is Σ_i (p_i - p_j)/d³ (descending it
        # pushes points apart): sum over the *first* point index.
        inter = np.sum(diff / (d2[..., None] ** 1.5 + 1e-6), axis=1)
        grads = inter + 10.0 * kernels
        norms = np.sqrt(np.sum(grads**2, axis=-1))  # [C,K]
        final_norms = norms
        if np.max(np.abs(old_norms[:, 1:] - norms[:, 1:])) < thresh:
            break
        old_norms = norms
        move = np.minimum(step * norms, clip)
        if fixed == "center":
            move[:, 0] = 0.0
        kernels -= move[..., None] * grads / (norms[..., None] + 1e-6)
        step *= decay

    best = int(np.argmin(np.max(final_norms, axis=1)))
    kp = kernels[best]
    radii = np.sqrt(np.sum(kp**2, axis=-1))
    kp *= ratio / np.mean(radii[1:])
    return kp.astype(np.float32)


def spherical_lloyd(
    num_points: int,
    dimension: int = 3,
    fixed: str = "center",
    approx_n: int = 5000,
    max_iter: int = 500,
    momentum: float = 0.9,
    seed: int = 0,
) -> np.ndarray:
    """Kernel disposition by Monte-Carlo Lloyd iteration on the unit ball:
    kernel points converge to the centroids of their Voronoi cells under a
    fresh uniform ball sample each iteration, smoothed by ``momentum``
    (capability of reference kernels/kernel_points.py:66-243, the variant
    the reference auto-selects for K > 30).  Vectorized: per-cell centroids
    via scatter-add instead of a per-cell Python loop."""
    rng = np.random.default_rng(seed)

    # Init uniformly in the outer shell (0.9, 1.0) of the unit ball.
    kp = np.zeros((0, dimension))
    while kp.shape[0] < num_points:
        cand = rng.uniform(-1.0, 1.0, size=(num_points * 4, dimension))
        d2 = np.sum(cand**2, axis=1)
        kp = np.vstack([kp, cand[(d2 < 1.0) & (d2 > 0.81)]])
    kp = kp[:num_points]
    if fixed == "center":
        kp[0] = 0.0
    elif fixed == "verticals":
        kp[:3] = 0.0
        kp[1, -1] = 2.0 / 3.0
        kp[2, -1] = -2.0 / 3.0

    for _ in range(max_iter):
        x = rng.uniform(-1.0, 1.0, size=(approx_n, dimension))
        x = x[np.sum(x**2, axis=1) < 1.0]
        d2 = np.sum((x[:, None, :] - kp[None]) ** 2, axis=-1)  # [n, K]
        cell = np.argmin(d2, axis=1)
        sums = np.zeros_like(kp)
        np.add.at(sums, cell, x)
        counts = np.bincount(cell, minlength=num_points).astype(np.float64)
        centers = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1.0)[:, None], kp)
        kp = kp + (1.0 - momentum) * (centers - kp)
        if fixed == "center":
            kp[0] = 0.0
        elif fixed == "verticals":
            kp[0] = 0.0
            kp[:3, :-1] = 0.0
    return kp.astype(np.float32)


@functools.lru_cache(maxsize=8)
def kernel_dispositions(
    num_points: int = 15, dimension: int = 3, fixed: str = "center", method: str = "auto",
) -> np.ndarray:
    """Canonical unit-radius disposition [K, D]: the shipped file, else the
    cache, else optimized and cached.  ``method``: 'repulsion', 'lloyd' or
    'auto' — repulsion up to K = 30, Lloyd beyond (reference
    kernels/kernel_points.py:396-397)."""
    if method == "auto":
        method = "lloyd" if num_points > 30 else "repulsion"
    suffix = "" if method == "repulsion" else f"_{method}"
    name = f"k_{num_points:03d}_{fixed}_{dimension}d{suffix}.npy"
    if (_SHIPPED_DIR / name).exists():
        return np.load(_SHIPPED_DIR / name)
    if method == "lloyd":
        return spherical_lloyd(num_points, dimension, fixed)
    if method == "repulsion":
        return _optimize_dispositions(num_points, dimension, fixed)
    raise ValueError(f"unknown disposition method {method!r}")


def layer_kernel_points(
    radius: float,
    num_points: int = 15,
    dimension: int = 3,
    fixed: str = "center",
    seed: int = 0,
    method: str = "auto",
) -> np.ndarray:
    """Per-layer kernel points: canonical disposition + random z-rotation +
    0.01 jitter, scaled to ``radius`` (reference kernel_points.py:433-468)."""
    kp = kernel_dispositions(num_points, dimension, fixed, method).copy()
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 2 * np.pi)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=np.float32)
    kp = kp + rng.normal(scale=0.01, size=kp.shape).astype(np.float32)
    kp = radius * kp
    return (kp @ rot).astype(np.float32)
