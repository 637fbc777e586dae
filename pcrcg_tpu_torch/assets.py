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
