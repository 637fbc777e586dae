"""KITTI-style LiDAR scan pairs from a synthetic street, made from the seed
(a copy of the port's ``assets.py::write_kitti_fixture`` scene and scanner,
with the rays cast by torch on the device):

* a straight street along x (road at z = 0) with building facades, parked
  cars, poles, trees (a trunk under a foliage crown) and hedges;
* an HDL-64E scanner (64 rings, 2 deg to -24.8 deg) 1.73 m above the road,
  driving 3.3 m a frame with a small yaw and sway; each scan casts
  ``rays`` rays and keeps the returns within ``range_m`` (2 cm range
  noise); a ray into a foliage box returns after an exponential depth;
* each scan voxel-downsampled at ``voxel`` m (centroids), as the KITTI
  dataset does before a pair reaches the model;
* pair i is frames (4i, 4i + 3), 9.9 m apart (the D3Feat rule), with the
  ground truth known exactly: no ICP.

Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np
import torch

HDL64_ELEVATIONS = np.deg2rad(np.concatenate([2.0 - np.arange(32) / 3.0,
                                              -8.83 - 0.5 * np.arange(32)]))
LIDAR_HEIGHT = 1.73
FRAME_SPACING = 3.3
FOLIAGE_DEPTH = 0.5


def street_boxes(rng: np.random.Generator, x_lo: float, x_hi: float, half_width: float):
    """Axis-aligned boxes along the street: (corners [n, 2, 3], foliage [n])."""
    boxes, foliage = [], []

    def add(lo, hi, leaves=False):
        boxes.append((lo, hi))
        foliage.append(leaves)

    for side in (-1.0, 1.0):
        x = x_lo
        while x < x_hi:  # facades
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
        while x < x_hi:  # hedges
            y, length = side * (half_width - 0.3), rng.uniform(3.0, 12.0)
            add((x, y - 0.5, 0.0), (x + length, y + 0.5, rng.uniform(0.8, 1.5)), leaves=True)
            x += length + rng.uniform(1.0, 6.0)
    return np.asarray(boxes, np.float64), np.asarray(foliage)


def cast_rays(origin: torch.Tensor, dirs: torch.Tensor, corners: torch.Tensor,
              foliage: torch.Tensor, gen: torch.Generator, range_m: float,
              chunk: int = 8192) -> torch.Tensor:
    """Distance along each unit ray [n, 3] to its return (the road plane or
    the nearest box entered; into foliage by an exponential depth); inf
    where nothing returns within ``range_m``.  float64."""
    out = []
    lo, hi = corners[:, 0], corners[:, 1]  # [m, 3]
    for d in torch.split(dirs, chunk):
        t_best = torch.where(d[:, 2] < 0, -origin[2] / d[:, 2], torch.inf)
        t1 = (lo[None] - origin) / d[:, None]  # [c, m, 3]
        t2 = (hi[None] - origin) / d[:, None]
        t_in = torch.minimum(t1, t2).nan_to_num(nan=-torch.inf).amax(-1)
        t_out = torch.maximum(t1, t2).nan_to_num(nan=torch.inf).amin(-1)
        hit = (t_in <= t_out) & (t_in > 0)
        depth = torch.empty(t_in.shape, device=d.device, dtype=d.dtype).exponential_(
            1.0 / FOLIAGE_DEPTH, generator=gen)
        t_in = torch.where(foliage[None], torch.minimum(t_in + depth, t_out), t_in)
        t_box = torch.where(hit, t_in, torch.inf).amin(-1)
        out.append(torch.minimum(t_best, t_box))
    t = torch.cat(out)
    return torch.where(t <= range_m, t, torch.inf)


def voxel_downsample(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """Centroids of the occupied voxels, ordered by voxel key, float32."""
    ijk = torch.floor(points / voxel).long()
    _, inv, counts = torch.unique(ijk, dim=0, return_inverse=True, return_counts=True)
    sums = torch.zeros(counts.shape[0], 3, device=points.device, dtype=torch.float64)
    sums.index_add_(0, inv, points.double())
    return (sums / counts[:, None]).float()


def make_pool(params: dict, seed: int, device, images: bool = False) -> list:
    """``params['pairs']`` pairs: dicts of src_pcd, tgt_pcd (float32 numpy,
    voxel-downsampled scans in their scanner's frame), rot, trans (float64
    numpy, src -> tgt).  A LiDAR drive has no images."""
    if images:
        raise ValueError("a LiDAR drive has no images: its configuration must be geometry only")
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    range_m = float(params["range_m"])
    n_frames = 4 * params["pairs"]
    half_width = rng.uniform(6.0, 7.0)
    length = FRAME_SPACING * n_frames
    corners, foliage = street_boxes(rng, -range_m - 20.0, length + range_m + 20.0, half_width)
    corners_t = torch.as_tensor(corners, device=device)
    foliage_t = torch.as_tensor(foliage, device=device)
    n_az = max(params["rays"] // len(HDL64_ELEVATIONS), 1)
    elev, az = np.meshgrid(HDL64_ELEVATIONS, np.arange(n_az) * (2 * np.pi / n_az), indexing="ij")
    local = torch.as_tensor(
        np.stack([np.cos(elev) * np.cos(az), np.cos(elev) * np.sin(az), np.sin(elev)],
                 -1).reshape(-1, 3), device=device)
    scans, poses = [], []
    for t in range(n_frames):
        yaw = rng.uniform(-0.05, 0.05)
        c, s = np.cos(yaw), np.sin(yaw)
        pose = np.eye(4)
        pose[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
        pose[:3, 3] = (FRAME_SPACING * t, rng.uniform(-0.3, 0.3), LIDAR_HEIGHT)
        rot = torch.as_tensor(pose[:3, :3], device=device)
        origin = torch.as_tensor(pose[:3, 3], device=device)
        near = (corners_t[:, 0, 0] - origin[0]).abs() < range_m + 20.0
        dist = cast_rays(origin, local @ rot.T, corners_t[near], foliage_t[near], gen, range_m)
        hit = torch.isfinite(dist)
        noise = torch.randn(int(hit.sum()), generator=gen, device=device, dtype=dist.dtype)
        pts = local[hit] * (dist[hit] + 0.02 * noise)[:, None]  # the scanner's frame
        scans.append(voxel_downsample(pts, params["voxel"]))
        poses.append(pose)
    pool = []
    for i in range(params["pairs"]):
        a, b = 4 * i, 4 * i + 3
        rel = np.linalg.inv(poses[b]) @ poses[a]  # scanner a -> scanner b
        pool.append({"src_pcd": scans[a].cpu().numpy(), "tgt_pcd": scans[b].cpu().numpy(),
                     "rot": rel[:3, :3], "trans": rel[:3, 3]})
    return pool
