"""The in-repo demo fragment pair (3DMatch kitchen, cloud_bin_21/34), the
vendored benchmark gt folders, synthetic image stacks for the color branch,
and an on-disk split in the 3DMatch layout built from the demo clouds
(``write_indoor_fixture``; numpy, and PIL for its images).

The repository holds no 3DMatch images.  ``synthetic_images`` (a copy of
``bench.py::synthetic_images``) gives random stacks of the real
pipeline's shapes, in which few points pass the depth test;
``render_views`` (a copy of ``scripts/train_synthetic_register.py``'s)
renders a colored cloud into geometry-consistent views, in which most
points the camera sees pass it.
"""
from __future__ import annotations

import pickle
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


def benchmark_gt_root(benchmark: str) -> str:
    """Directory of per-scene gt.{log,info} for ``benchmark`` in
    {"3DMatch", "3DLoMatch"} (vendored under configs/benchmarks)."""
    return str(REPO_ROOT / "configs" / "benchmarks" / benchmark)


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


# The fixture's one scene, and its frames a fragment: the ``img_num`` of
# configs/train/indoor.yaml, which a split must match to load.
FIXTURE_SCENE = "7-scenes-fixture"
FIXTURE_IMG_NUM = 2


def _log_entry(i: int, j: int, n: int, mat: np.ndarray) -> str:
    return f"{i}\t{j}\t{n}\n" + "".join(
        "\t".join(f"{v:.9f}" for v in row) + "\n" for row in mat)


def write_indoor_fixture(root, n_pairs: int, seed: int = 0, images: bool = False,
                         split: str = "train", info_name: str = "",
                         max_points: int = 0) -> dict:
    """A split of ``n_pairs`` fragment pairs in the 3DMatch layout, cut from
    the demo clouds, for tests and smoke runs.  Under ``root``:

    * ``data/<split>/<FIXTURE_SCENE>/cloud_bin_<k>.pth``: torch-saved float32 [n, 3]
      fragments, each in the frame of its first camera, as 3DMatch stores
      them; pair p has target fragment 3p and source fragment 3p + 2 (not
      consecutive, so the benchmark scores it);
    * ``<info_name or split + '_info'>.pkl``: {rot, trans, src, tgt, overlap},
      src -> tgt, paths relative to ``data``;
    * ``gt_<split>/<scene>/gt.log`` and ``gt.info`` (Redwood format; the
      information matrix diagonal: 1 on the translation, the source's mean
      squared radius on the quaternion's vector part);
    * with ``images``: ``<cloud>.info.txt`` beside each fragment,
      ``FIXTURE_IMG_NUM`` frames a fragment,
      ``image/<scene>/seq-<split>/frame-XXXXXX.{color,depth}.png`` (8-bit
      RGB at 240 x 320, 16-bit millimeters at half size, written with PIL: the
      ``assets.py::render_views`` renders of the fragment's crop, colored by
      ``procedural_colors`` of the source cloud's coordinates, so the
      overlap looks the same in both fragments), ``frame-XXXXXX.pose.txt``
      (camera to world, so the dataset's world2cam, I and
      pose2^-1 pose1, matches the renders), ``camera-intrinsics.txt`` and
      SuperGlue-format ``superglue_matches/*_matches.npz`` (a grid of
      matched keypoints covering each image).

    Each pair is two overlapping half-space crops of one demo cloud, each
    subsampled to 0.85 independently (and to ``max_points``, if set).
    Returns the paths: root (the config's ``root``), info, gt, img_path,
    matches."""
    import torch
    from scipy.spatial import cKDTree

    if images:
        from PIL import Image
    scene, img_num = FIXTURE_SCENE, FIXTURE_IMG_NUM
    root = Path(root)
    data, img_root, matches = root / "data", root / "image", root / "superglue_matches"
    frag_dir, gt_dir = data / split / scene, root / f"gt_{split}" / scene
    for d in (frag_dir, gt_dir, img_root / scene / f"seq-{split}", matches):
        d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    clouds = demo_cloud_pair()
    np.savetxt(img_root / scene / "camera-intrinsics.txt", _BASE_INTR[:3, :3])
    infos = {"rot": [], "trans": [], "src": [], "tgt": [], "overlap": []}
    log, info = [], []
    n_frag = 3 * n_pairs
    for p in range(n_pairs):
        cloud = clouds[p % 2]
        normal = rng.normal(size=3)
        normal /= np.linalg.norm(normal)
        d = (cloud - cloud.mean(0)) @ normal
        band = 0.35 * d.std()
        crops = []
        for part in (cloud[d < band], cloud[d > -band]):  # target, source
            keep = int(len(part) * 0.85)
            crops.append(part[rng.permutation(len(part))[: min(keep, max_points or keep)]])
        w2c1 = []
        for k, crop in zip((3 * p, 3 * p + 2), crops):
            cols, deps, _, w2c, _ = render_views(crop, procedural_colors(crop), img_num, rng)
            frag = (crop @ w2c[0, :3, :3].T + w2c[0, :3, 3]).astype(np.float32)
            torch.save(torch.from_numpy(frag), frag_dir / f"cloud_bin_{k}.pth")
            w2c1.append(w2c[0].astype(np.float64))
            if not images:
                continue
            ids = [str(100 * k + 50 * i) for i in range(img_num)]
            (frag_dir / f"cloud_bin_{k}.info.txt").write_text(
                f"{scene} seq-{split} {ids[0]} {ids[-1]}\n")
            for i, fid in enumerate(ids):
                stem = img_root / scene / f"seq-{split}" / f"frame-{fid.zfill(6)}"
                Image.fromarray(np.clip(np.round(cols[i] * 255.0), 0, 255).astype(np.uint8)
                                ).save(f"{stem}.color.png")
                Image.fromarray(np.clip(np.round(deps[i] * 1000.0), 0, 65535).astype(np.uint16)
                                ).save(f"{stem}.depth.png")
                np.savetxt(f"{stem}.pose.txt", np.linalg.inv(w2c[i].astype(np.float64)))
        # src -> tgt: back to the cloud's frame from the source's first
        # camera, then into the target's.
        gt = w2c1[0] @ np.linalg.inv(w2c1[1])
        src_rel = f"{split}/{scene}/cloud_bin_{3 * p + 2}.pth"
        tgt_rel = f"{split}/{scene}/cloud_bin_{3 * p}.pth"
        dist, _ = cKDTree(crops[0]).query(crops[1], k=1)
        infos["rot"].append(gt[:3, :3].astype(np.float32))
        infos["trans"].append(gt[:3, 3:].astype(np.float32))
        infos["src"].append(src_rel)
        infos["tgt"].append(tgt_rel)
        infos["overlap"].append(float((dist < 0.0375).mean()))
        log.append(_log_entry(3 * p, 3 * p + 2, n_frag, gt))
        rho2 = float(((crops[1] - crops[1].mean(0)) ** 2).sum(1).mean())
        info.append(_log_entry(3 * p, 3 * p + 2, n_frag,
                               np.diag([1.0, 1.0, 1.0, rho2, rho2, rho2])))
        if images:
            grid = np.stack(np.meshgrid(np.arange(5, 160, 10), np.arange(5, 120, 10)),
                            -1).reshape(-1, 2).astype(np.float32)
            for i in range(img_num):
                fid_s, fid_t = str(100 * (3 * p + 2) + 50 * i), str(100 * (3 * p) + 50 * i)
                np.savez(matches / (f"{scene}_seq-{split}_frame-{fid_s.zfill(6)}_"
                                    f"{scene}_seq-{split}_frame-{fid_t.zfill(6)}_matches.npz"),
                         keypoints0=grid, keypoints1=grid,
                         matches=np.arange(len(grid)),
                         match_confidence=rng.uniform(0.5, 1.0, len(grid)).astype(np.float32))
    (gt_dir / "gt.log").write_text("".join(log))
    (gt_dir / "gt.info").write_text("".join(info))
    info_path = root / f"{info_name or split + '_info'}.pkl"
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    return {"root": str(data), "info": str(info_path), "gt": str(root / f"gt_{split}"),
            "img_path": str(img_root), "matches": str(matches)}


# The HDL-64E's 64 lasers: the upper block of 32 from +2 to -8.33 deg in
# 1/3 deg steps, the lower block of 32 from -8.83 to -24.33 deg in 1/2 deg
# steps, mounted 1.73 m above the road (KITTI's Velodyne).  A scan keeps
# the returns within 30 m: the coarse budgets of configs/train/kitti.yaml
# (2,048 points at the 1.2 m level, 640 at 2.4 m) hold such a scan under
# the dataset's augmentation (any rotation, scale up to 1.2) with ~25 %
# to spare; with returns out to 120 m the 2.4 m level holds ~740 voxels at
# scale 1.2 before any rotation.
_HDL64_ELEVATIONS = np.deg2rad(np.concatenate([2.0 - np.arange(32) / 3.0,
                                               -8.83 - 0.5 * np.arange(32)]))
_LIDAR_HEIGHT = 1.73
_LIDAR_RANGE = 30.0
# The drive's frames are 3.3 m apart, so the D3Feat rule pairs frames 9.9 m
# apart (its limit is 10 m).
_FRAME_SPACING = 3.3
# Foliage: a ray enters a canopy and returns after an exponential depth.
_FOLIAGE_DEPTH = 0.5


def _street_boxes(rng, x_lo: float, x_hi: float, half_width: float):
    """Axis-aligned boxes along a straight street on the x axis, as (min and
    max corners [n, 2, 3], foliage flags [n]): building facades on both
    sides (8-20 m long, set back 0-2 m, 6-15 m high), parked cars, poles
    and trees (a trunk under a foliage crown) at random places."""
    boxes, foliage = [], []

    def add(lo, hi, leaves=False):
        boxes.append((lo, hi))
        foliage.append(leaves)

    for side in (-1.0, 1.0):
        x = x_lo
        while x < x_hi:
            length = rng.uniform(8.0, 20.0)
            y0 = half_width + rng.uniform(0.0, 2.0)
            y = (y0, y0 + 10.0) if side > 0 else (-y0 - 10.0, -y0)
            add((x, y[0], 0.0), (x + length - rng.uniform(0.0, 3.0), y[1],
                                 rng.uniform(6.0, 15.0)))
            x += length
        x = x_lo + rng.uniform(0.0, 10.0)
        while x < x_hi:  # parked cars
            y = side * (half_width - 1.6)
            add((x, y - 0.9, 0.0), (x + 4.5, y + 0.9, 1.5))
            x += 4.5 + rng.uniform(1.0, 25.0)
        x = x_lo + rng.uniform(0.0, 15.0)
        while x < x_hi:  # poles
            y = side * (half_width - 0.4)
            add((x, y - 0.15, 0.0), (x + 0.3, y + 0.15, rng.uniform(4.0, 8.0)))
            x += rng.uniform(10.0, 30.0)
        x = x_lo + rng.uniform(0.0, 10.0)
        while x < x_hi:  # trees
            y, r = side * (half_width - 0.8), rng.uniform(1.5, 3.0)
            add((x - 0.2, y - 0.2, 0.0), (x + 0.2, y + 0.2, 3.0))
            add((x - r, y - r, 2.0), (x + r, y + r, rng.uniform(5.0, 9.0)), leaves=True)
            x += rng.uniform(5.0, 12.0)
        x = x_lo + rng.uniform(0.0, 5.0)
        while x < x_hi:  # hedges in front of the facades
            y, length = side * (half_width - 0.3), rng.uniform(3.0, 12.0)
            add((x, y - 0.5, 0.0), (x + length, y + 0.5, rng.uniform(0.8, 1.5)), leaves=True)
            x += length + rng.uniform(1.0, 6.0)
    return np.asarray(boxes, np.float64), np.asarray(foliage)


def _cast_rays(origin: np.ndarray, dirs: np.ndarray, boxes, rng) -> np.ndarray:
    """Distance along each unit ray [n, 3] from ``origin`` to its return: the
    nearest of the road plane z = 0 and the boxes (slab test; into a
    foliage box by an exponential depth); inf where nothing returns within
    ``_LIDAR_RANGE``."""
    corners, foliage = boxes
    with np.errstate(divide="ignore", invalid="ignore"):
        t_best = np.where(dirs[:, 2] < 0, -origin[2] / dirs[:, 2], np.inf)
        near = np.abs(corners[:, 0, 0] - origin[0]) < _LIDAR_RANGE + 20.0
        for (lo, hi), leaves in zip(corners[near], foliage[near]):
            t1 = (lo - origin) / dirs
            t2 = (hi - origin) / dirs
            t_in = np.nanmax(np.minimum(t1, t2), axis=1)
            t_out = np.nanmin(np.maximum(t1, t2), axis=1)
            hit = (t_in <= t_out) & (t_in > 0)
            if leaves:
                t_in = np.minimum(t_in + rng.exponential(_FOLIAGE_DEPTH, len(dirs)), t_out)
            t_best = np.where(hit & (t_in < t_best), t_in, t_best)
    return np.where(t_best <= _LIDAR_RANGE, t_best, np.inf)


def write_kitti_fixture(root, n_frames: int, seed: int = 0,
                        points_per_scan: int = 120_000) -> dict:
    """Drive 0 of ``n_frames`` LiDAR scans in the KITTI-odometry layout, for
    tests and smoke runs.  Under ``root``:

    * ``dataset/sequences/00/velodyne/<t:06d>.bin``: float32 [n, 4]
      (x, y, z, reflectance) in the scanner's frame;
    * ``dataset/poses/00.txt``: each frame's camera-0 pose (camera
      to world, 3 x 4 row-major), the scanner's pose composed with the
      inverse of ``data/kitti.py::velo2cam``.

    The scene, drawn from ``seed``, is a straight street along x (road at
    z = 0, facades 6-9 m from the centre line) with buildings, parked cars,
    poles, trees and hedges.  Each scan casts ``points_per_scan`` rays in
    the 64 rings of an HDL-64E 1.73 m above the road and keeps those that
    return within 30 m (2 cm range noise).  The scanner drives 3.3 m a
    frame with a small yaw and sway, so the D3Feat rule (a pair is a frame and the last frame within 10 m of it, once a
    later frame lies beyond 10 m) pairs frames (0, 3), (4, 7), ..., 9.9 m
    apart: 4k + 1 frames give k pairs.  Returns the paths: root (the
    config's ``root``) and ``dataset``."""
    from pcrcg_tpu_torch.data.kitti import velo2cam

    root = Path(root)
    velo_dir = root / "dataset" / "sequences" / "00" / "velodyne"
    pose_dir = root / "dataset" / "poses"
    velo_dir.mkdir(parents=True, exist_ok=True)
    pose_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    half_width = rng.uniform(6.0, 7.0)
    length = _FRAME_SPACING * n_frames
    boxes = _street_boxes(rng, -_LIDAR_RANGE - 20.0, length + _LIDAR_RANGE + 20.0, half_width)
    n_az = max(points_per_scan // len(_HDL64_ELEVATIONS), 1)
    elev, az = np.meshgrid(_HDL64_ELEVATIONS, np.arange(n_az) * (2 * np.pi / n_az),
                           indexing="ij")
    local = np.stack([np.cos(elev) * np.cos(az), np.cos(elev) * np.sin(az), np.sin(elev)],
                     -1).reshape(-1, 3)
    cam2velo = np.linalg.inv(velo2cam())
    poses = []
    for t in range(n_frames):
        yaw = rng.uniform(-0.05, 0.05)
        c, s = np.cos(yaw), np.sin(yaw)
        velo2world = np.eye(4)
        velo2world[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
        velo2world[:3, 3] = (_FRAME_SPACING * t, rng.uniform(-0.3, 0.3), _LIDAR_HEIGHT)
        dist = _cast_rays(velo2world[:3, 3], local @ velo2world[:3, :3].T, boxes, rng)
        hit = np.isfinite(dist)
        dist = dist[hit] + rng.normal(scale=0.02, size=int(hit.sum()))
        pts = local[hit] * dist[:, None]  # in the scanner's frame
        refl = rng.uniform(0.0, 1.0, (len(pts), 1))
        np.concatenate([pts, refl], 1).astype(np.float32).tofile(velo_dir / f"{t:06d}.bin")
        poses.append((velo2world @ cam2velo)[:3].reshape(-1))
    np.savetxt(pose_dir / "00.txt", np.stack(poses))
    return {"root": str(root), "dataset": str(root / "dataset")}


def modelnet_shapes(n_models: int, n_points: int = 2048, seed: int = 0) -> np.ndarray:
    """[n_models, n_points, 3] float32 surface samples of synthetic shapes
    for a ModelNet source, each normalised as ModelNet40's HDF5 shards are:
    centred and scaled into the unit sphere (largest norm 1).  A shape is a
    union of 2-4 primitives (box, cylinder, ellipsoid surfaces) with random
    sizes, offsets and orientations, sampled in proportion to their areas,
    so it has no rotational symmetry."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_models, n_points, 3), np.float32)
    for m in range(n_models):
        parts, areas = [], []
        for _ in range(int(rng.integers(2, 5))):
            kind = int(rng.integers(0, 3))
            size = rng.uniform(0.2, 1.0, 3)
            parts.append((kind, size, rng.uniform(-0.6, 0.6, 3),
                          np.linalg.qr(rng.normal(size=(3, 3)))[0]))
            a, b, c = size
            areas.append(2 * (a * b + b * c + a * c) if kind == 0 else
                         2 * np.pi * a * (a + c) if kind == 1 else
                         4 * np.pi * ((a * b) ** 1.6 + (a * c) ** 1.6 + (b * c) ** 1.6) ** (
                             1 / 1.6) / 3 ** (1 / 1.6))
        counts = rng.multinomial(n_points, np.asarray(areas) / np.sum(areas))
        pts = []
        for (kind, size, offset, rot), n in zip(parts, counts):
            if kind == 0:  # box: a face chosen by area, then a point on it
                u = rng.uniform(-1.0, 1.0, (n, 3))
                face_area = np.array([size[1] * size[2], size[0] * size[2], size[0] * size[1]])
                axis = rng.choice(3, n, p=face_area / face_area.sum())
                u[np.arange(n), axis] = rng.choice([-1.0, 1.0], n)
                p = u * size
            elif kind == 1:  # capped cylinder along z
                theta = rng.uniform(0.0, 2 * np.pi, n)
                on_cap = rng.uniform(0.0, size[0] + size[2], n) < size[0]
                r = np.where(on_cap, size[0] * np.sqrt(rng.uniform(0.0, 1.0, n)), size[0])
                z = np.where(on_cap, rng.choice([-1.0, 1.0], n), rng.uniform(-1.0, 1.0, n))
                p = np.stack([r * np.cos(theta), r * np.sin(theta), z * size[2]], 1)
            else:  # ellipsoid
                v = rng.normal(size=(n, 3))
                p = v / np.linalg.norm(v, axis=1, keepdims=True) * size
            pts.append(p @ rot.T + offset)
        pts = np.concatenate(pts)
        pts -= pts.mean(0)
        out[m] = pts / np.linalg.norm(pts, axis=1).max()
    return out
