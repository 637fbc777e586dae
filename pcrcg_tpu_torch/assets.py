"""The in-repo demo fragment pair (3DMatch kitchen, cloud_bin_21/34)."""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

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
