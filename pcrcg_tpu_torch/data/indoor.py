"""3DMatch / 3DLoMatch indoor dataset (counterpart of
``pcrcg_tpu/data/indoor.py``; numpy, sample for sample the same arrays).

Capability parity with reference datasets/indoor.py:32-210 (geometry path):
* pair-info pickle {rot, trans, src, tgt, overlap} with .pth fragment paths
  relative to ``config.root`` (same pickles as configs/indoor/*.pkl),
* 30k-point random cap (indoor.py:142-147),
* augmentation: a full-2π 'zyx'-Euler rotation applied to EITHER src or tgt
  (p = 0.5) with the GT transform fixed up accordingly, plus uniform
  (rand − 0.5)·0.005 noise (indoor.py:151-168 — noise is uniform, not
  gaussian, despite the comment there),
* input feature = ones column (indoor.py:179-180).

GT correspondences are not computed here (the reference runs a per-pair
Open3D radius search on the CPU, indoor.py:176-177): the loss derives
them on the device from (rot, trans).  The 2D image branch attaches
through ``data/images.py::ImagePairLoader``.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

import torch

from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.data.images import ImagePairLoader


def euler_zyx_matrix(angles: np.ndarray) -> np.ndarray:
    """Intrinsic 'zyx' Euler -> rotation matrix (scipy Rotation.from_euler
    convention used at reference indoor.py:155-156): Rz(a)·Ry(b)·Rx(c)."""
    a, b, c = angles
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cc, sc = np.cos(c), np.sin(c)
    rz = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rx = np.array([[1, 0, 0], [0, cc, -sc], [0, sc, cc]])
    return (rz @ ry @ rx).astype(np.float32)


def load_fragment(path: str) -> np.ndarray:
    """Fragment files are float32 [n,3] arrays: .npy natively, or the
    reference's torch-saved .pth (reference datasets/indoor.py:142)."""
    if path.endswith(".npy") or path.endswith(".npz"):
        arr = np.load(path)
        if hasattr(arr, "files"):  # npz archive: first entry
            arr = arr[arr.files[0]]
        return np.asarray(arr, dtype=np.float32)
    return np.asarray(torch.load(path, weights_only=False), dtype=np.float32)


class IndoorDataset:
    """Yields sample dicts consumable by data.pair.make_pair_batch."""

    MAX_POINTS = 30000  # reference indoor.py:63
    ROT_FACTOR = 1.0  # full 2π augmentation rotations

    def __init__(
        self,
        infos,
        config: Config,
        data_augmentation: bool = True,
        rng: Optional[np.random.Generator] = None,
    ):
        if isinstance(infos, str):
            with open(infos, "rb") as f:
                infos = pickle.load(f)
        self.infos = infos
        self.base_dir = config.root
        self.overlap_radius = config.overlap_radius
        self.augment_noise = config.augment_noise
        self.data_augmentation = data_augmentation
        self.config = config
        self.rng = rng or np.random.default_rng(config.seed)
        self.image_loader = None
        if config.image_feature:
            self.image_loader = ImagePairLoader(
                config.img_path,
                config.superglue_matches_path,
                config.img_num,
                config.window_size,
                quantized=getattr(config, "image_quantized", False),
            )

    def __len__(self) -> int:
        return len(self.infos["rot"])

    def __getitem__(self, item: int) -> Dict[str, np.ndarray]:
        return self.get(item, self.rng)

    def get(self, item: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        """__getitem__ with an explicit generator — the PairLoader worker
        threads each pass their own so augmentation draws never race."""
        rng = rng if rng is not None else self.rng
        rot = np.asarray(self.infos["rot"][item], np.float64)
        trans = np.asarray(self.infos["trans"][item], np.float64).reshape(3, 1)

        src_pcd = load_fragment(os.path.join(self.base_dir, self.infos["src"][item]))
        tgt_pcd = load_fragment(os.path.join(self.base_dir, self.infos["tgt"][item]))

        if src_pcd.shape[0] > self.MAX_POINTS:
            src_pcd = src_pcd[rng.permutation(src_pcd.shape[0])[: self.MAX_POINTS]]
        if tgt_pcd.shape[0] > self.MAX_POINTS:
            tgt_pcd = tgt_pcd[rng.permutation(tgt_pcd.shape[0])[: self.MAX_POINTS]]

        aug_rot = np.eye(3, dtype=np.float32)
        aug_src = False
        if self.data_augmentation:
            euler_ab = rng.random(3) * np.pi * 2 / self.ROT_FACTOR
            rot_ab = euler_zyx_matrix(euler_ab)
            aug_rot = rot_ab
            aug_src = rng.random() > 0.5
            if aug_src:
                src_pcd = src_pcd @ rot_ab.T
                rot = rot @ rot_ab.T
            else:
                tgt_pcd = tgt_pcd @ rot_ab.T
                rot = rot_ab @ rot
                trans = rot_ab @ trans
            src_pcd = src_pcd + (rng.random(src_pcd.shape) - 0.5) * self.augment_noise
            tgt_pcd = tgt_pcd + (rng.random(tgt_pcd.shape) - 0.5) * self.augment_noise

        sample = {
            "src_pcd": src_pcd.astype(np.float32),
            "tgt_pcd": tgt_pcd.astype(np.float32),
            "rot": rot.astype(np.float32),
            "trans": trans.astype(np.float32).reshape(3),
            "overlap": np.float32(self.infos.get("overlap", [0.0] * len(self))[item]),
            # For the image branch: the augmentation must be composed into
            # world2camera (reference indoor.py:569-594).
            "aug_rot": aug_rot,
            "aug_src": np.bool_(aug_src),
            "item": np.int32(item),
        }
        if self.image_loader is not None:
            sample.update(
                self.image_loader.load_pair(
                    self.base_dir,
                    self.infos["src"][item],
                    self.infos["tgt"][item],
                    aug_rot,
                    bool(aug_src),
                    self.data_augmentation,
                )
            )
        return sample


def load_split(config: Config, split: str) -> "IndoorDataset":
    """split ∈ {train, val, 3DMatch, 3DLoMatch} → dataset (reference
    datasets/dataloader.py:436-457 get_datasets for 'indoor')."""
    paths = {
        "train": config.train_info,
        "val": config.val_info,
        "3DMatch": os.path.join(os.path.dirname(config.val_info or "."), "3DMatch.pkl"),
        "3DLoMatch": os.path.join(os.path.dirname(config.val_info or "."), "3DLoMatch.pkl"),
    }
    augment = split == "train"
    return IndoorDataset(paths[split], config, data_augmentation=augment)
