"""RPMNet-style point-cloud transform chains (numpy; counterpart of
``pcrcg_tpu/data/transforms.py``, host code copied as it is).

Reference datasets/transforms.py:40-371: SplitSourceRef,
Resampler / FixedResampler, RandomJitter, RandomCrop (plane-based partial
crop), RandomTransformSE3[_euler], RandomRotatorZ, ShufflePoints,
SetDeterministic.  Each transform is a callable over the RPMNet sample
dict {points | points_src / points_ref, transform_gt, ...}; each draws
from its own ``np.random.RandomState``: seeded from the sample's ``idx``
under ``SetDeterministic`` (the test split), else from numpy's global
generator.  Resampling is crop-proportion aware.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np


def uniform_2_sphere(rng: np.random.RandomState) -> np.ndarray:
    phi = rng.uniform(0.0, 2 * np.pi)
    cos_theta = rng.uniform(-1.0, 1.0)
    theta = np.arccos(cos_theta)
    return np.array(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)]
    )


class _Transform:
    """Base: per-sample RNG honoring the 'deterministic' test flag
    (reference transforms.py:66-69,185-188)."""

    def rng_for(self, sample: Dict) -> np.random.RandomState:
        if sample.get("deterministic"):
            return np.random.RandomState(int(sample["idx"]))
        return np.random.RandomState(np.random.randint(0, 2**31 - 1))


class SetDeterministic(_Transform):
    def __call__(self, sample: Dict) -> Dict:
        sample["deterministic"] = True
        return sample


class SplitSourceRef(_Transform):
    def __call__(self, sample: Dict) -> Dict:
        sample["points_raw"] = sample.pop("points")
        sample["points_src"] = sample["points_raw"].copy()
        sample["points_ref"] = sample["points_raw"].copy()
        return sample


class Resampler(_Transform):
    def __init__(self, num: int):
        self.num = num

    @staticmethod
    def _resample(points, k, rng):
        n = points.shape[0]
        if k < n:
            return points[rng.choice(n, k, replace=False)]
        if n == k:
            return points
        idx = np.concatenate([rng.permutation(n), rng.choice(n, k - n, replace=True)])
        return points[idx]

    def __call__(self, sample: Dict) -> Dict:
        rng = self.rng_for(sample)
        if "points" in sample:
            sample["points"] = self._resample(sample["points"], self.num, rng)
            return sample
        crop = sample.get("crop_proportion")
        if crop is None:
            src_size = ref_size = self.num
        elif len(crop) == 1:
            src_size = math.ceil(crop[0] * self.num)
            ref_size = self.num
        else:
            src_size = math.ceil(crop[0] * self.num)
            ref_size = math.ceil(crop[1] * self.num)
        sample["points_src"] = self._resample(sample["points_src"], src_size, rng)
        sample["points_ref"] = self._resample(sample["points_ref"], ref_size, rng)
        return sample


class FixedResampler(Resampler):
    """Deterministic tiling resample (transforms.py:115-124)."""

    @staticmethod
    def _resample(points, k, rng=None):
        multiple, remainder = divmod(k, points.shape[0])
        return np.concatenate([np.tile(points, (multiple, 1)), points[:remainder]], axis=0)

    def __call__(self, sample: Dict) -> Dict:
        if "points" in sample:
            sample["points"] = self._resample(sample["points"], self.num)
        else:
            sample["points_src"] = self._resample(sample["points_src"], self.num)
            sample["points_ref"] = self._resample(sample["points_ref"], self.num)
        return sample


class RandomJitter(_Transform):
    def __init__(self, scale: float = 0.01, clip: float = 0.05):
        self.scale = scale
        self.clip = clip

    def _jitter(self, pts, rng):
        noise = np.clip(
            rng.normal(0.0, self.scale, size=(pts.shape[0], 3)), -self.clip, self.clip
        )
        pts = pts.copy()
        pts[:, :3] += noise
        return pts

    def __call__(self, sample: Dict) -> Dict:
        rng = self.rng_for(sample)
        if "points" in sample:
            sample["points"] = self._jitter(sample["points"], rng)
        else:
            sample["points_src"] = self._jitter(sample["points_src"], rng)
            sample["points_ref"] = self._jitter(sample["points_ref"], rng)
        return sample


class RandomCrop(_Transform):
    """Half-space crop retaining ~p_keep of the points (transforms.py:152-192)."""

    def __init__(self, p_keep: Optional[List[float]] = None):
        self.p_keep = np.asarray(p_keep if p_keep is not None else [0.7, 0.7], np.float32)

    @staticmethod
    def crop(points, p_keep, rng):
        direction = uniform_2_sphere(rng)
        centered = points[:, :3] - points[:, :3].mean(0)
        dist = centered @ direction
        if p_keep == 0.5:
            mask = dist > 0
        else:
            mask = dist > np.percentile(dist, (1.0 - p_keep) * 100)
        return points[mask]

    def __call__(self, sample: Dict) -> Dict:
        sample["crop_proportion"] = self.p_keep
        if np.all(self.p_keep == 1.0):
            return sample
        rng = self.rng_for(sample)
        sample["points_src"] = self.crop(sample["points_src"], self.p_keep[0], rng)
        if len(self.p_keep) > 1:
            sample["points_ref"] = self.crop(sample["points_ref"], self.p_keep[1], rng)
        return sample


def _se3_inverse(g):
    rot, t = g[:3, :3], g[:3, 3]
    return np.concatenate([rot.T, (-rot.T @ t)[:, None]], axis=1).astype(np.float32)


class RandomTransformSE3(_Transform):
    """Random rigid perturbation of the source; transform_gt maps the
    transformed source back onto the reference (transforms.py:195-258)."""

    def __init__(self, rot_mag: float = 180.0, trans_mag: float = 1.0, random_mag: bool = False):
        self.rot_mag = rot_mag
        self.trans_mag = trans_mag
        self.random_mag = random_mag

    def _magnitudes(self, rng):
        if self.random_mag:
            a = rng.random_sample()
            return a * self.rot_mag, a * self.trans_mag
        return self.rot_mag, self.trans_mag

    def generate_transform(self, rng):
        rot_mag, trans_mag = self._magnitudes(rng)
        # Uniform rotation scaled down by rot_mag/180 in axis-angle space.
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        rand_rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        # matrix -> axis-angle, scale, -> matrix
        angle = np.arccos(np.clip((np.trace(rand_rot) - 1) / 2, -1, 1))
        if angle > 1e-8:
            axis = (
                np.array(
                    [
                        rand_rot[2, 1] - rand_rot[1, 2],
                        rand_rot[0, 2] - rand_rot[2, 0],
                        rand_rot[1, 0] - rand_rot[0, 1],
                    ]
                )
                / (2 * np.sin(angle))
            )
        else:
            axis = np.array([1.0, 0, 0])
        angle *= rot_mag / 180.0
        rand_rot = _axis_angle_matrix(axis, angle)
        rand_trans = rng.uniform(-trans_mag, trans_mag, 3)
        return np.concatenate([rand_rot, rand_trans[:, None]], axis=1).astype(np.float32)

    def __call__(self, sample: Dict) -> Dict:
        rng = self.rng_for(sample)
        g = self.generate_transform(rng)
        if "points" in sample:
            pts = sample["points"]
            sample["points"] = np.concatenate(
                [pts[:, :3] @ g[:3, :3].T + g[:3, 3], pts[:, 3:]], axis=1
            ).astype(pts.dtype)
            return sample
        pts = sample["points_src"]
        moved = pts[:, :3] @ g[:3, :3].T + g[:3, 3]
        if pts.shape[1] >= 6:  # rotate normals too
            normals = pts[:, 3:6] @ g[:3, :3].T
            moved = np.concatenate([moved, normals, pts[:, 6:]], axis=1)
        sample["points_src"] = moved.astype(pts.dtype)
        sample["transform_gt"] = _se3_inverse(g)  # src -> ref
        return sample


def _axis_angle_matrix(axis, angle):
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    return np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ]
    )


class RandomTransformSE3_euler(RandomTransformSE3):
    """DCP-style euler-angle rotations (transforms.py:262-301)."""

    def generate_transform(self, rng):
        rot_mag, trans_mag = self._magnitudes(rng)
        ax, ay, az = rng.uniform(size=3) * np.pi * rot_mag / 180.0
        rx = _axis_angle_matrix(np.array([1.0, 0, 0]), ax)
        ry = _axis_angle_matrix(np.array([0, 1.0, 0]), ay)
        rz = _axis_angle_matrix(np.array([0, 0, 1.0]), az)
        r_ab = rx @ ry @ rz
        t_ab = rng.uniform(-trans_mag, trans_mag, 3)
        return np.concatenate([r_ab, t_ab[:, None]], axis=1).astype(np.float32)


class RandomRotatorZ(RandomTransformSE3):
    def __init__(self):
        super().__init__(rot_mag=360.0)

    def generate_transform(self, rng):
        angle = np.deg2rad(rng.random_sample() * self.rot_mag)
        rot = _axis_angle_matrix(np.array([0, 0, 1.0]), angle)
        return np.concatenate([rot, np.zeros((3, 1))], axis=1).astype(np.float32)


class ShufflePoints(_Transform):
    def __call__(self, sample: Dict) -> Dict:
        rng = self.rng_for(sample)
        if "points" in sample:
            sample["points"] = sample["points"][rng.permutation(len(sample["points"]))]
        else:
            sample["points_ref"] = sample["points_ref"][
                rng.permutation(len(sample["points_ref"]))
            ]
            sample["points_src"] = sample["points_src"][
                rng.permutation(len(sample["points_src"]))
            ]
        return sample


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def get_transforms(
    noise_type: str,
    rot_mag: float = 45.0,
    trans_mag: float = 0.5,
    num_points: int = 1024,
    partial_p_keep: Optional[List[float]] = None,
):
    """Train/test transform chains per noise_type ∈ {clean, jitter, crop}
    (reference datasets/modelnet.py:59-130)."""
    partial_p_keep = partial_p_keep if partial_p_keep is not None else [0.7, 0.7]
    if noise_type == "clean":
        train = [Resampler(num_points), SplitSourceRef(),
                 RandomTransformSE3_euler(rot_mag, trans_mag), ShufflePoints()]
        test = [SetDeterministic(), FixedResampler(num_points), SplitSourceRef(),
                RandomTransformSE3_euler(rot_mag, trans_mag), ShufflePoints()]
    elif noise_type == "jitter":
        train = [SplitSourceRef(), RandomTransformSE3_euler(rot_mag, trans_mag),
                 Resampler(num_points), RandomJitter(), ShufflePoints()]
        test = [SetDeterministic(), SplitSourceRef(),
                RandomTransformSE3_euler(rot_mag, trans_mag), Resampler(num_points),
                RandomJitter(), ShufflePoints()]
    elif noise_type == "crop":
        train = [SplitSourceRef(), RandomCrop(partial_p_keep),
                 RandomTransformSE3_euler(rot_mag, trans_mag), Resampler(num_points),
                 RandomJitter(), ShufflePoints()]
        test = [SetDeterministic(), SplitSourceRef(), RandomCrop(partial_p_keep),
                RandomTransformSE3_euler(rot_mag, trans_mag), Resampler(num_points),
                RandomJitter(), ShufflePoints()]
    else:
        raise NotImplementedError(noise_type)
    return Compose(train), Compose(test)
