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
