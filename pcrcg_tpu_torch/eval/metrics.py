"""Descriptor-quality metrics: inlier ratios (with and without the mutual
check) and feature-match-recall sweeps (counterpart of
``pcrcg_tpu/eval/metrics.py``; reference lib/benchmark_utils.py:226-311,
get_inlier_ratio and mutual_selection), on tensors with pad rows masked.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from pcrcg_tpu_torch.geom import se3
from pcrcg_tpu_torch.ops.masked import pad_gather
from pcrcg_tpu_torch.ops.matching import nearest_feature_neighbor


def inlier_ratio(
    src_pcd, tgt_pcd, src_feats, tgt_feats, rot, trans,
    src_mask, tgt_mask,
    inlier_distance_threshold: float = 0.1,
    chunk: int = 2048,
) -> Dict[str, torch.Tensor]:
    """Inlier ratios with/without the mutual check; pad rows excluded."""
    g = se3.from_rt(rot, trans.reshape(3))
    src_warp = se3.transform(g, src_pcd)

    idx_st = nearest_feature_neighbor(src_feats, tgt_feats, tgt_mask, chunk)
    d_wo = torch.linalg.norm(src_warp - pad_gather(tgt_pcd, idx_st, 0.0), dim=-1)
    n_src = src_mask.sum().float().clamp_min(1.0)
    wo = ((d_wo < inlier_distance_threshold) & src_mask).sum() / n_src

    # Mutual check: src i kept iff argmax_tgt(i)'s argmax_src == i.
    idx_ts = nearest_feature_neighbor(tgt_feats, src_feats, src_mask, chunk)
    arange = torch.arange(src_pcd.shape[0], device=src_pcd.device)
    mutual = (idx_ts[idx_st] == arange) & src_mask
    n_mut = mutual.sum().float().clamp_min(1.0)
    w = ((d_wo < inlier_distance_threshold) & mutual).sum() / n_mut
    return {
        "inlier_ratio_wo_mutual": wo,
        "inlier_ratio_w_mutual": w,
        "distance_wo_mutual": d_wo,
        "mutual_mask": mutual,
    }


def feature_match_recall_sweep(
    distances: torch.Tensor,
    valid: torch.Tensor,
    thresholds: Sequence[float] = (0.05, 0.1, 0.2),
    inlier_ratio_threshold: float = 0.05,
) -> torch.Tensor:
    """Given per-anchor nearest-match distances (one pair), the pair's FMR
    flag at each distance threshold: whether its inlier ratio clears
    ``inlier_ratio_threshold`` (the FMR protocol)."""
    n = valid.sum().float().clamp_min(1.0)
    return torch.stack([((distances < thr) & valid).sum() / n > inlier_ratio_threshold
                        for thr in thresholds])


def mutual_selection(score_mat: torch.Tensor) -> torch.Tensor:
    """Bool matrix: true iff the entry is the maximum along both its row and
    its column (reference benchmark_utils.py:270-295), batched [B, N, M]."""
    if score_mat.dim() == 2:
        score_mat = score_mat[None]
    n, m = score_mat.shape[1], score_mat.shape[2]
    flag_row = torch.nn.functional.one_hot(score_mat.argmax(2), m).bool()  # [B, N, M]
    flag_col = torch.nn.functional.one_hot(score_mat.argmax(1), n).bool().transpose(1, 2)
    return flag_row & flag_col
