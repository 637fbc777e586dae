"""ModelNet40 HDF5 registration dataset (counterpart of
``pcrcg_tpu/data/modelnet.py``, host code copied as it is).

Reference datasets/modelnet.py:133-241: ``ModelNetHdf`` reads the PointNet
HDF5 shards listed in {train,test}_files.txt, filters categories through
shape_names.txt and the half1 / half2 category files, and runs the RPMNet
transform chain (``data/transforms.py``).  Samples follow the port's
sample-dict contract; the GT transform_gt (src -> ref) becomes rot /
trans, and the clean full cloud rides along as ``points_raw`` (the
batch's ``extras``).  ``h5py`` is imported where the shards are read only.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.data.transforms import get_transforms


class ModelNetHdf:
    def __init__(
        self,
        config: Config,
        root: str,
        subset: str = "train",
        categories: Optional[List[str]] = None,
        transform=None,
    ):
        self.config = config
        self._root = root
        with open(os.path.join(root, "shape_names.txt")) as f:
            self._classes = [l.strip() for l in f]
        cat2idx = {c: i for i, c in enumerate(self._classes)}
        with open(os.path.join(root, f"{subset}_files.txt")) as f:
            files = [
                os.path.join(root, line.strip().replace("data/modelnet40_ply_hdf5_2048/", ""))
                for line in f
            ]
        cat_idx = [cat2idx[c] for c in categories] if categories else None
        self._data, self._labels = self._read_h5(files, cat_idx)
        self._transform = transform

    @staticmethod
    def _read_h5(files, categories):
        import h5py

        all_data, all_labels = [], []
        for fname in files:
            with h5py.File(fname, "r") as f:
                data = np.concatenate(
                    [f["data"][:], f["normal"][:]], axis=-1
                ) if "normal" in f else f["data"][:]
                labels = f["label"][:].flatten().astype(np.int64)
            if categories is not None:
                mask = np.isin(labels, categories)
                data, labels = data[mask], labels[mask]
            all_data.append(data.astype(np.float32))
            all_labels.append(labels)
        return np.concatenate(all_data), np.concatenate(all_labels)

    def __len__(self) -> int:
        return self._data.shape[0]

    def __getitem__(self, item: int):
        sample = {
            "points": self._data[item].copy(),
            "label": self._labels[item],
            "idx": np.int32(item),
        }
        if self._transform:
            sample = self._transform(sample)
        g = sample["transform_gt"]
        return {
            "src_pcd": sample["points_src"][:, :3].astype(np.float32),
            "tgt_pcd": sample["points_ref"][:, :3].astype(np.float32),
            "rot": g[:3, :3].astype(np.float32),
            "trans": g[:3, 3].astype(np.float32),
            "item": np.int32(item),
            "label": np.int32(sample["label"]),
            # Clean full cloud for the modified-chamfer metric (reference
            # lib/tester.py:260,280-286); fixed-size so it batches as-is.
            "points_raw": sample["points_raw"][:, :3].astype(np.float32),
        }


def read_categories(path: str) -> List[str]:
    return sorted(line.rstrip("\n") for line in open(path))


def get_modelnet_datasets(
    cfg: Config,
    noise_type: Optional[str] = None,
    rot_mag: Optional[float] = None,
    trans_mag: Optional[float] = None,
    num_points: Optional[int] = None,
    partial: Optional[List[float]] = None,
    train_categoryfile: Optional[str] = None,
    val_categoryfile: Optional[str] = None,
    test_categoryfile: Optional[str] = None,
):
    """Reference datasets/modelnet.py get_train_datasets/get_test_datasets:
    half1 categories for train/val, half2 for test, partial [0.7,0.7] crops
    (configs/test/modelnet.yaml:61-75).  Every protocol knob defaults to the
    Config's dataset-section fields; keyword arguments override (tests)."""
    noise_type = noise_type if noise_type is not None else cfg.noise_type
    rot_mag = rot_mag if rot_mag is not None else cfg.rot_mag
    trans_mag = trans_mag if trans_mag is not None else cfg.trans_mag
    num_points = num_points if num_points is not None else cfg.num_points
    partial = partial if partial is not None else (
        list(cfg.partial) if cfg.partial is not None else None
    )
    train_categoryfile = (
        train_categoryfile if train_categoryfile is not None else cfg.train_categoryfile
    )
    val_categoryfile = (
        val_categoryfile if val_categoryfile is not None else cfg.val_categoryfile
    )
    test_categoryfile = (
        test_categoryfile if test_categoryfile is not None else cfg.test_categoryfile
    )
    train_t, test_t = get_transforms(noise_type, rot_mag, trans_mag, num_points, partial)
    train_cats = read_categories(train_categoryfile) if train_categoryfile else None
    val_cats = read_categories(val_categoryfile) if val_categoryfile else train_cats
    test_cats = read_categories(test_categoryfile) if test_categoryfile else None
    # mode "val" builds the val split of mode "train"; the JAX package
    # builds the test split there, which its Trainer's val pass cannot find.
    out = {}
    if cfg.mode == "train":
        out["train"] = ModelNetHdf(cfg, cfg.root, "train", train_cats, train_t)
    if cfg.mode in ("train", "val"):
        out["val"] = ModelNetHdf(cfg, cfg.root, "test", val_cats, test_t)
    else:
        out["test"] = ModelNetHdf(cfg, cfg.root, "test", test_cats, test_t)
    return out
