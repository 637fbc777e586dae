"""Visualization dumps (headless): colored PLY exports of registration
results (counterpart of ``pcrcg_tpu/utils/visualize.py``; the reference's
datasets/visualize.py draw_registration_result / save_ply).  The pair is
written as one colored PLY — source gold, target blue, the source moved by
an optional transform — viewable in any point-cloud viewer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from pcrcg_tpu_torch.geom.ply import write_ply

SRC_COLOR = (255, 180, 0)
TGT_COLOR = (0, 166, 237)


def save_pair_ply(path: str, src_pcd, tgt_pcd, transform: Optional[np.ndarray] = None) -> str:
    """Write src (moved by the [3, 4] or [4, 4] ``transform`` when given)
    and tgt with distinct colors into one PLY; returns the path.  Takes
    numpy arrays or tensors (any device)."""
    src = _numpy(src_pcd).astype(np.float32)
    tgt = _numpy(tgt_pcd).astype(np.float32)
    if transform is not None:
        t = _numpy(transform)
        src = src @ t[:3, :3].T + t[:3, 3]
    pts = np.concatenate([src, tgt], 0)
    colors = np.concatenate([
        np.tile(np.array(SRC_COLOR, np.uint8), (len(src), 1)),
        np.tile(np.array(TGT_COLOR, np.uint8), (len(tgt), 1)),
    ], 0)
    write_ply(path, [pts, colors], ["x", "y", "z", "red", "green", "blue"])
    return path if path.endswith(".ply") else path + ".ply"


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
