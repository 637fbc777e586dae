"""KITTI odometry registration dataset (counterpart of
``pcrcg_tpu/data/kitti.py``, host code copied as it is).

Reference datasets/kitti.py:12-230:
* D3Feat pair generation: consecutive frames >= 10 m apart per drive, the
  bad test pair (8, 15, 58) removed (kitti.py:47-85);
* GT pose = the velo2cam-conjugated odometry, refined by point-to-point
  ICP (numpy / scipy in place of Open3D) and cached to
  <root>/icp/<drive>_<t0>_<t1>.npy (kitti.py:106-126);
* voxel downsample at first_subsampling_dl (centroid average, in numpy);
* augmentation of the model-input clouds only: uniform noise, a full-2pi
  zyx rotation of src or tgt (GT left as it is), scale 0.8-1.2, shift
  +-2 m (kitti.py:156-179); the loss takes the pre-augmentation clouds,
  row for row (``raw_src_pcd`` / ``raw_tgt_pcd``: the batch's
  ``raw_points``);
* train pairs with fewer than max_points correspondences are resampled
  (kitti.py:144-145), with the count cached per pair.

Every split reads ``configs/kitti/{split}_kitti.txt`` relative to the
working directory unless ``split_files`` names others.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.data.indoor import euler_zyx_matrix

VELO2CAM_R = np.array(
    [
        [7.533745e-03, -9.999714e-01, -6.166020e-04],
        [1.480249e-02, 7.280733e-04, -9.998902e-01],
        [9.998621e-01, 7.523790e-03, 1.480755e-02],
    ]
)
VELO2CAM_T = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01])


def velo2cam() -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = VELO2CAM_R
    out[:3, 3] = VELO2CAM_T
    return out


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Centroid-average voxel grid downsample (Open3D voxel_down_sample /
    grid_subsampling semantics)."""
    ijk = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(ijk, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(np.float32)


def icp_point_to_point(
    src: np.ndarray,
    tgt: np.ndarray,
    init: np.ndarray,
    max_dist: float = 0.2,
    max_iter: int = 200,
    tol: float = 1e-7,
) -> np.ndarray:
    """Point-to-point ICP (replaces Open3D registration_icp for the KITTI
    GT refinement, kitti.py:116-121).  Returns the 4x4 refinement."""
    from scipy.spatial import cKDTree

    tree = cKDTree(tgt)
    T = np.asarray(init, np.float64).copy()
    prev_err = np.inf
    for _ in range(max_iter):
        moved = src @ T[:3, :3].T + T[:3, 3]
        dist, idx = tree.query(moved, distance_upper_bound=max_dist)
        ok = np.isfinite(dist)
        if ok.sum() < 3:
            break
        a, b = moved[ok], tgt[idx[ok]]
        ca, cb = a.mean(0), b.mean(0)
        cov = (a - ca).T @ (b - cb)
        u, _, vt = np.linalg.svd(cov)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        R = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
        t = cb - R @ ca
        delta = np.eye(4)
        delta[:3, :3] = R
        delta[:3, 3] = t
        T = delta @ T
        err = float(np.mean(dist[ok] ** 2))
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return T


class KITTIDataset:
    MIN_DIST = 10.0  # meters between pair frames
    BAD_TEST_PAIRS = [(8, 15, 58)]

    def __init__(
        self,
        config: Config,
        split: str,
        data_augmentation: Optional[bool] = None,
        split_files: Optional[Dict[str, str]] = None,
    ):
        assert split in ("train", "val", "test")
        self.config = config
        self.split = split
        self.root = os.path.join(config.root, "dataset")
        self.icp_path = os.path.join(config.root, "icp")
        os.makedirs(self.icp_path, exist_ok=True)
        self.voxel_size = config.first_subsampling_dl
        self.matching_voxel = config.overlap_radius
        self.augment = data_augmentation if data_augmentation is not None else split == "train"
        self.rng = np.random.default_rng(config.seed)
        self.files = []
        self._odometry_cache: Dict[str, np.ndarray] = {}
        self._corr_count_cache: Dict[int, int] = {}
        split_files = split_files or {
            s: os.path.join("configs", "kitti", f"{s}_kitti.txt") for s in ("train", "val", "test")
        }
        self._prepare_pairs(split_files[split])

    # --- pair generation (reference kitti.py:47-85) ---
    def _prepare_pairs(self, split_file: str):
        drives = open(split_file).read().split()
        for dirname in drives:
            drive_id = int(dirname)
            fnames = glob.glob(f"{self.root}/sequences/{drive_id:02d}/velodyne/*.bin")
            assert fnames, f"no velodyne data for drive {dirname} under {self.root}"
            inames = sorted(int(os.path.split(f)[-1][:-4]) for f in fnames)
            all_pos = self.video_odometry(drive_id)
            Ts = all_pos[:, :3, 3]
            pdist = np.sqrt(((Ts[None] - Ts[:, None]) ** 2).sum(-1))
            more_than_10 = pdist > self.MIN_DIST
            curr_time = inames[0]
            iname_set = set(inames)
            while curr_time in iname_set:
                nxt = np.where(more_than_10[curr_time][curr_time : curr_time + 100])[0]
                if len(nxt) == 0:
                    curr_time += 1
                    continue
                next_time = int(nxt[0]) + curr_time - 1
                if next_time in iname_set:
                    self.files.append((drive_id, curr_time, next_time))
                    curr_time = next_time + 1
        if self.split == "test":
            for bad in self.BAD_TEST_PAIRS:
                if bad in self.files:
                    self.files.remove(bad)

    def video_odometry(self, drive: int) -> np.ndarray:
        path = f"{self.root}/poses/{drive:02d}.txt"
        if path not in self._odometry_cache:
            raw = np.genfromtxt(path).reshape(-1, 3, 4)
            eye = np.tile(np.array([[0.0, 0, 0, 1]]), (raw.shape[0], 1, 1))
            self._odometry_cache[path] = np.concatenate([raw, eye], axis=1)
        return self._odometry_cache[path]

    def _velodyne(self, drive: int, t: int) -> np.ndarray:
        fname = f"{self.root}/sequences/{drive:02d}/velodyne/{t:06d}.bin"
        return np.fromfile(fname, dtype=np.float32).reshape(-1, 4)[:, :3]

    def _gt_transform(self, drive: int, t0: int, t1: int, xyz0, xyz1) -> np.ndarray:
        """ICP-refined GT, disk-cached (kitti.py:106-126)."""
        key = f"{drive}_{t0}_{t1}"
        fname = os.path.join(self.icp_path, key + ".npy")
        if os.path.exists(fname):
            return np.load(fname)
        pos = self.video_odometry(drive)[[t0, t1]]
        v2c = velo2cam()
        # reference: M = (velo2cam @ pos0.T @ inv(pos1.T) @ inv(velo2cam)).T
        M = (v2c.T @ pos[0].T @ np.linalg.inv(pos[1].T) @ np.linalg.inv(v2c.T)).T
        M2 = icp_point_to_point(xyz0, xyz1, M)
        np.save(fname, M2)
        return M2

    def __len__(self) -> int:
        return len(self.files)

    def _count_correspondences(self, idx, src, tgt, tsfm) -> int:
        if idx in self._corr_count_cache:
            return self._corr_count_cache[idx]
        from scipy.spatial import cKDTree

        moved = src @ tsfm[:3, :3].T + tsfm[:3, 3]
        d, _ = cKDTree(tgt).query(moved, distance_upper_bound=self.matching_voxel)
        count = int(np.isfinite(d).sum())
        self._corr_count_cache[idx] = count
        return count

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.get(idx, self.rng)

    def get(self, idx: int, rng=None) -> Dict[str, np.ndarray]:
        """__getitem__ with an explicit generator (PairLoader worker threads
        each pass their own; augmentation draws never race)."""
        rng = rng if rng is not None else self.rng
        drive, t0, t1 = self.files[idx]
        xyz0 = self._velodyne(drive, t0)
        xyz1 = self._velodyne(drive, t1)
        tsfm = self._gt_transform(drive, t0, t1, xyz0, xyz1)
        rot = tsfm[:3, :3].astype(np.float32)
        trans = tsfm[:3, 3].astype(np.float32)

        src_raw = voxel_downsample(xyz0, self.voxel_size)
        tgt_raw = voxel_downsample(xyz1, self.voxel_size)

        if self.split == "train" and self._count_correspondences(
            idx, src_raw, tgt_raw, tsfm
        ) < self.config.max_points:
            return self.get(int(rng.integers(len(self))), rng)

        src_in, tgt_in = src_raw.copy(), tgt_raw.copy()
        if self.augment:
            src_in += (rng.random(src_in.shape) - 0.5) * self.config.augment_noise
            tgt_in += (rng.random(tgt_in.shape) - 0.5) * self.config.augment_noise
            rot_ab = euler_zyx_matrix(rng.random(3) * 2 * np.pi)
            if rng.random() > 0.5:
                src_in = src_in @ rot_ab.T
            else:
                tgt_in = tgt_in @ rot_ab.T
            scale = self.config.augment_scale_min + (
                self.config.augment_scale_max - self.config.augment_scale_min
            ) * rng.random()
            src_in *= scale
            tgt_in *= scale
            src_in += rng.uniform(-self.config.augment_shift_range, self.config.augment_shift_range, 3)
            tgt_in += rng.uniform(-self.config.augment_shift_range, self.config.augment_shift_range, 3)

        return {
            "src_pcd": src_in.astype(np.float32),
            "tgt_pcd": tgt_in.astype(np.float32),
            "raw_src_pcd": src_raw,
            "raw_tgt_pcd": tgt_raw,
            "rot": rot,
            "trans": trans,
            "item": np.int32(idx),
        }
