"""Pair containers: the static-shape unit of work (host side, numpy).

Counterpart of ``pcrcg_tpu/data/pair.py``: B registration pairs, each as
two fixed-budget padded clouds on a [B, 2, N0, ...] layout (src = 0,
tgt = 1).  Padding, the random over-budget subsample and the Z-order sort
run on the host in numpy exactly as in the JAX package; the result is
handed over as torch tensors on the requested device.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from pcrcg_tpu_torch.ops.masked import PAD_COORD


@dataclasses.dataclass
class PairBatch:
    points: torch.Tensor  # [B, 2, N0, 3] padded at PAD_COORD
    masks: torch.Tensor  # [B, 2, N0] bool
    features: torch.Tensor  # [B, 2, N0, Cin]
    rot: torch.Tensor  # [B, 3, 3] GT rotation src->tgt
    trans: torch.Tensor  # [B, 3]


def subsample_to_budget(
    n: int, budget: int, rng: Optional[np.random.Generator] = None
) -> Optional[np.ndarray]:
    """``budget`` row indices chosen uniformly at random for an over-budget
    cloud (reference datasets/indoor.py:142-147); None when it fits."""
    if n <= budget:
        return None
    warnings.warn(
        f"cloud with {n} points truncated to budget {budget} by uniform "
        "random subsampling; raise budgets.points[0] to keep all points",
        stacklevel=3,
    )
    rng = rng if rng is not None else np.random.default_rng(0)
    return rng.permutation(n)[:budget]


def pad_cloud(
    points: np.ndarray,
    budget: int,
    rng: Optional[np.random.Generator] = None,
    select: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """[n,3] -> ([budget,3] padded at PAD_COORD, [budget] mask)."""
    if select is None:
        select = subsample_to_budget(points.shape[0], budget, rng)
    if select is not None:
        points = points[select]
    n = min(points.shape[0], budget)
    out = np.full((budget, 3), PAD_COORD, np.float32)
    out[:n] = points[:n]
    mask = np.zeros(budget, bool)
    mask[:n] = True
    return out, mask


def _np_morton_order(points: np.ndarray) -> np.ndarray:
    """Z-order sort permutation on a 1024³ grid over the bounding box."""
    vmin = points.min(0)
    extent = max(float((points.max(0) - vmin).max()), 1e-6)
    ijk = np.clip(((points - vmin) / extent * 1023.0).astype(np.int64), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    code = spread(ijk[:, 0]) | (spread(ijk[:, 1]) << 1) | (spread(ijk[:, 2]) << 2)
    return np.argsort(code, kind="stable")


def make_pair_batch(
    samples: list[dict],
    budget: int,
    in_feats_dim: int = 1,
    features: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
    device="cpu",
) -> PairBatch:
    """samples: dicts with src_pcd [n,3], tgt_pcd [m,3], rot [3,3], trans [3].
    Input feature = ones column on real rows (reference
    datasets/indoor.py:179-180) unless ``features`` [B,2,N,Cin] is given.
    Each cloud's real rows are Z-ordered for search-tile locality."""
    bsz = len(samples)
    pts = np.full((bsz, 2, budget, 3), PAD_COORD, np.float32)
    msk = np.zeros((bsz, 2, budget), bool)
    rot = np.zeros((bsz, 3, 3), np.float32)
    trans = np.zeros((bsz, 3), np.float32)
    for i, s in enumerate(samples):
        src = np.asarray(s["src_pcd"], np.float32)
        tgt = np.asarray(s["tgt_pcd"], np.float32)
        sel_src = subsample_to_budget(src.shape[0], budget, rng)
        sel_tgt = subsample_to_budget(tgt.shape[0], budget, rng)
        pts[i, 0], msk[i, 0] = pad_cloud(src, budget, select=sel_src)
        pts[i, 1], msk[i, 1] = pad_cloud(tgt, budget, select=sel_tgt)
        for c in range(2):
            n = int(msk[i, c].sum())
            if n > 1:
                order = _np_morton_order(pts[i, c, :n])
                pts[i, c, :n] = pts[i, c, :n][order]
        rot[i] = np.asarray(s["rot"], np.float32).reshape(3, 3)
        trans[i] = np.asarray(s["trans"], np.float32).reshape(3)
    if features is None:
        feats = np.where(msk[..., None], 1.0, 0.0).astype(np.float32)
        feats = np.tile(feats, (1, 1, 1, in_feats_dim))
    else:
        feats = np.asarray(features, np.float32)
    dev = torch.device(device)
    return PairBatch(
        points=torch.from_numpy(pts).to(dev),
        masks=torch.from_numpy(msk).to(dev),
        features=torch.from_numpy(feats).to(dev),
        rot=torch.from_numpy(rot).to(dev),
        trans=torch.from_numpy(trans).to(dev),
    )
