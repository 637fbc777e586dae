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
    # Pre-augmentation clouds, same rows and order as ``points``: the loss
    # uses them when the augmentation is not folded into (rot, trans), the
    # KITTI protocol (reference datasets/kitti.py:17-19).  None -> points.
    raw_points: Optional[torch.Tensor] = None
    # Per-sample arrays stacked on the batch axis, e.g. ModelNet's clean
    # full cloud 'points_raw' for the modified chamfer (reference
    # lib/tester.py:280-286).  None when absent.
    extras: Optional[dict] = None

    @property
    def loss_points(self) -> torch.Tensor:
        return self.points if self.raw_points is None else self.raw_points

    def map(self, fn) -> "PairBatch":
        """The batch with ``fn`` applied to every tensor (extras too)."""
        return PairBatch(
            *(fn(t) for t in (self.points, self.masks, self.features, self.rot, self.trans)),
            raw_points=None if self.raw_points is None else fn(self.raw_points),
            extras=None if self.extras is None else {k: fn(v) for k, v in self.extras.items()},
        )


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
    extra_keys: tuple = ("points_raw",),
    device="cpu",
) -> PairBatch:
    """samples: dicts with src_pcd [n,3], tgt_pcd [m,3], rot [3,3], trans [3]
    and, optionally, the pre-augmentation raw_src_pcd / raw_tgt_pcd and the
    per-sample ``extra_keys`` arrays.  Input feature = ones column on real
    rows (reference datasets/indoor.py:179-180) unless ``features``
    [B,2,N,Cin] is given.  Each cloud's real rows are Z-ordered for
    search-tile locality; the raw clouds take the same row selection and
    order, so rows stay aligned."""
    bsz = len(samples)
    pts = np.full((bsz, 2, budget, 3), PAD_COORD, np.float32)
    msk = np.zeros((bsz, 2, budget), bool)
    rot = np.zeros((bsz, 3, 3), np.float32)
    trans = np.zeros((bsz, 3), np.float32)
    has_raw = "raw_src_pcd" in samples[0]
    raw = np.full((bsz, 2, budget, 3), PAD_COORD, np.float32) if has_raw else None
    for i, s in enumerate(samples):
        src = np.asarray(s["src_pcd"], np.float32)
        tgt = np.asarray(s["tgt_pcd"], np.float32)
        sel_src = subsample_to_budget(src.shape[0], budget, rng)
        sel_tgt = subsample_to_budget(tgt.shape[0], budget, rng)
        pts[i, 0], msk[i, 0] = pad_cloud(src, budget, select=sel_src)
        pts[i, 1], msk[i, 1] = pad_cloud(tgt, budget, select=sel_tgt)
        if has_raw:
            raw[i, 0] = pad_cloud(np.asarray(s["raw_src_pcd"], np.float32), budget,
                                  select=sel_src)[0]
            raw[i, 1] = pad_cloud(np.asarray(s["raw_tgt_pcd"], np.float32), budget,
                                  select=sel_tgt)[0]
        for c in range(2):
            n = int(msk[i, c].sum())
            if n > 1:
                order = _np_morton_order(pts[i, c, :n])
                pts[i, c, :n] = pts[i, c, :n][order]
                if has_raw:
                    raw[i, c, :n] = raw[i, c, :n][order]
        rot[i] = np.asarray(s["rot"], np.float32).reshape(3, 3)
        trans[i] = np.asarray(s["trans"], np.float32).reshape(3)
    if features is None:
        feats = np.where(msk[..., None], 1.0, 0.0).astype(np.float32)
        feats = np.tile(feats, (1, 1, 1, in_feats_dim))
    else:
        feats = np.asarray(features, np.float32)
    extras = {k: torch.from_numpy(np.stack([np.asarray(s[k], np.float32) for s in samples]))
              for k in extra_keys if k in samples[0]}
    dev = torch.device(device)
    batch = PairBatch(
        points=torch.from_numpy(pts),
        masks=torch.from_numpy(msk),
        features=torch.from_numpy(feats),
        rot=torch.from_numpy(rot),
        trans=torch.from_numpy(trans),
        raw_points=torch.from_numpy(raw) if has_raw else None,
        extras=extras or None,
    )
    return batch.map(lambda t: t.to(dev))
