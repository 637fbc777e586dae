"""The in-repo demo fragment pair (3DMatch kitchen, cloud_bin_21/34), and
synthetic image stacks for the color branch (numpy only).

The repository holds no 3DMatch images.  ``synthetic_images`` (a copy of
``bench.py::synthetic_images``) gives random stacks of the real
pipeline's shapes, in which few points pass the depth test;
``render_views`` (a copy of ``scripts/train_synthetic_register.py``'s)
renders a colored cloud into geometry-consistent views, in which most
points the camera sees pass it.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from pcrcg_tpu_torch.ops.projection import adjust_intrinsic

REPO_ROOT = Path(__file__).resolve().parent.parent


def demo_cloud_pair() -> Tuple[np.ndarray, np.ndarray]:
    """src [25337,3], tgt [14602,3] float32 from ``assets/cloud_bin_{21,34}.npy``
    (reference configs/train/indoor.yaml:83-86 demo section)."""
    assets = REPO_ROOT / "assets"
    return (
        np.load(assets / "cloud_bin_21.npy").astype(np.float32),
        np.load(assets / "cloud_bin_34.npy").astype(np.float32),
    )


# The gt.log entry "21 34" of configs/benchmarks/3DLoMatch/7-scenes-redkitchen
# (lines 1756-1760): it maps fragment 34 into fragment 21's frame.
_GT_34_TO_21 = np.array([[-0.455262791, -0.674319721, 0.581230622, -1.796732970],
                         [0.526546951, 0.322440636, 0.786464376, -0.772399229],
                         [-0.717836782, 0.664233294, 0.208264182, 1.131367600]])


def demo_pair_gt_pose() -> Tuple[np.ndarray, np.ndarray]:
    """The demo pair's ground truth (rot [3,3], trans [3], float64) mapping
    cloud_bin_21 onto cloud_bin_34: the inverse of the gt.log entry."""
    rot = _GT_34_TO_21[:, :3].T
    return rot, -rot @ _GT_34_TO_21[:, 3]


# The 3DMatch camera (640x480) the stacks are rendered for.
_BASE_INTR = np.array(
    [[577.87, 0, 319.5, 0], [0, 577.87, 239.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    np.float64,
)


def synthetic_images(img_num: int, seed: int = 0, height: int = 240, width: int = 320,
                     quantized: bool = False):
    """Random color [2, I, H, W, 3] and depth [2, I, H/2, W/2] stacks in the
    real image pipeline's shapes (``data/images.py``), identity world2cam,
    all-ones valid maps, the intrinsics rescaled to (W/2, H/2).
    ``quantized``: uint8 colors and uint16 millimeter depths."""
    rng = np.random.default_rng(seed)
    h2, w2 = height // 2, width // 2
    colors = rng.uniform(0, 1, (2, img_num, height, width, 3)).astype(np.float32)
    depths = rng.uniform(0.5, 3.0, (2, img_num, h2, w2)).astype(np.float32)
    if quantized:
        colors = (colors * 255.0).astype(np.uint8)
        depths = (depths * 1000.0).astype(np.uint16)
    return {
        "colors": colors,
        "depths": depths,
        "world2cam": np.broadcast_to(np.eye(4, dtype=np.float32), (2, img_num, 4, 4)).copy(),
        "valid_maps": np.ones((2, img_num, h2, w2), np.float32),
        "intrinsics": adjust_intrinsic(_BASE_INTR, (640, 480), (w2, h2)).astype(np.float32),
    }


def procedural_colors(points: np.ndarray, seed: int = 0) -> np.ndarray:
    """A deterministic RGB 'texture' of world position: overlapping regions
    of two clouds get the same colors from any view."""
    r = np.random.default_rng(seed)
    w = r.normal(scale=6.0, size=(3, 3))
    b = r.uniform(0, 2 * np.pi, 3)
    return (0.5 + 0.5 * np.sin(points @ w + b)).astype(np.float32)


def _lookat_world2cam(eye: np.ndarray, center: np.ndarray) -> np.ndarray:
    """OpenCV-style world -> camera [4, 4]: +z forward toward ``center``."""
    f = center - eye
    f = f / np.linalg.norm(f)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(f, up)) > 0.95:
        up = np.array([1.0, 0.0, 0.0])
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    rot = np.stack([r, d, f])  # rows: camera x/y/z in world
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rot
    m[:3, 3] = -rot @ eye
    return m


def render_views(points: np.ndarray, colors: np.ndarray, img_num: int, rng,
                 height: int = 240, width: int = 320):
    """Pinhole renders of the colored cloud (nearest-point splats from
    random directions, 2.2 radii out): color [I, H, W, 3], depth
    [I, H/2, W/2] (meters), valid [I, H/2, W/2], world2cam [I, 4, 4] and
    the intrinsics at (W/2, H/2): the shapes the lift takes, consistent
    with ``ops/projection.py::project_points`` (depth test 0.1 m)."""
    h2, w2 = height // 2, width // 2
    # Everything renders on the half-res grid (the lift's projection
    # resolution); colors upsample 2x to the backbone's input size.
    intr_h = adjust_intrinsic(_BASE_INTR, (640, 480), (w2, h2))
    center = points.mean(0)
    radius = float(np.linalg.norm(points - center, axis=1).max())
    imgs = np.zeros((img_num, height, width, 3), np.float32)
    deps = np.zeros((img_num, h2, w2), np.float32)
    w2c = np.zeros((img_num, 4, 4), np.float32)
    for i in range(img_num):
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        eye = center + direction * (2.2 * radius)
        m = _lookat_world2cam(eye, center)
        w2c[i] = m
        cam = points @ m[:3, :3].T + m[:3, 3]
        z = cam[:, 2]
        front = z > 0.05

        def splat(intr, hh, ww, values, out):
            u = (intr[0, 0] * cam[front, 0] / z[front] + intr[0, 2]).astype(np.int64)
            v = (intr[1, 1] * cam[front, 1] / z[front] + intr[1, 2]).astype(np.int64)
            ok = (u >= 0) & (u < ww) & (v >= 0) & (v < hh)
            order = np.argsort(-z[front][ok])  # nearest written last -> wins
            out[v[ok][order], u[ok][order]] = values[front][ok][order]

        # Colors splat at half res and upsample 2x: point splats at full res
        # leave mostly black images.
        img_h = np.zeros((h2, w2, 3), np.float32)
        splat(intr_h, h2, w2, colors, img_h)
        imgs[i] = np.repeat(np.repeat(img_h, 2, axis=0), 2, axis=1)
        splat(intr_h, h2, w2, z, deps[i])
    valid = (deps > 0).astype(np.float32)
    return imgs, deps, valid, w2c, np.asarray(intr_h, np.float32)


def render_pair_images(src: np.ndarray, tgt: np.ndarray, img_num: int = 2, seed: int = 0,
                       height: int = 240, width: int = 320, pose=None) -> dict:
    """The image dict of one pair (``models/lift.py``): ``render_views`` of
    each cloud, colored by ``procedural_colors`` of the source frame's
    coordinates (``pose`` = (rot, trans) maps source onto target; without
    it each cloud's own coordinates)."""
    rng = np.random.default_rng(seed)
    tgt_in_src = tgt if pose is None else (tgt - pose[1]) @ pose[0]
    views = [render_views(p, procedural_colors(c), img_num, rng, height, width)
             for p, c in ((src, src), (tgt, tgt_in_src))]
    return {
        "colors": np.stack([v[0] for v in views]),
        "depths": np.stack([v[1] for v in views]),
        "world2cam": np.stack([v[3] for v in views]),
        "valid_maps": np.stack([v[2] for v in views]),
        "intrinsics": views[0][4],
    }
