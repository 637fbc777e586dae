"""Batched RANSAC for rigid registration (counterpart of
``pcrcg_tpu/registration/ransac.py``).

Open3D ``registration_ransac_based_on_feature_matching`` parity as the
reference calls it (lib/benchmark_utils.py:187-224: 50k iterations,
ransac_n 3, edge-length 0.9 and distance checkers, point-to-point fit),
with every hypothesis drawn up front: exact 3-point fits, vectorized
checkers, and inlier counting as one [N,16] x [16,H] product per chunk of
hypotheses through the rigid-distance expansion

    |R x + t − y|² = |x|² + |y|² + F(x, y) · G(R, t)

then one Horn refit on the best hypothesis's inliers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pcrcg_tpu_torch.ops.matching import nearest_feature_neighbor
from pcrcg_tpu_torch.ops.neighbors import radius_sq
from pcrcg_tpu_torch.registration.procrustes import rigid_transform_3pt, rigid_transform_horn


class RansacResult(NamedTuple):
    transform: torch.Tensor  # [3,4] best rigid transform src->tgt
    fitness: torch.Tensor  # inlier fraction of the correspondence set
    inlier_rmse: torch.Tensor


def feature_correspondences(src_feats, tgt_feats, src_mask, tgt_mask,
                            mutual: bool = False, chunk: int = 2048):
    """Nearest-neighbor matches src -> tgt in feature space: (corr_tgt_idx
    [N] int64, corr_valid [N] bool).  ``mutual`` keeps only cycle-consistent
    matches (reference mutual_selection, lib/benchmark_utils.py:285-311)."""
    idx_st = nearest_feature_neighbor(src_feats, tgt_feats, tgt_mask, chunk)
    valid = src_mask
    if mutual:
        idx_ts = nearest_feature_neighbor(tgt_feats, src_feats, src_mask, chunk)
        back = idx_ts[idx_st]
        valid = valid & (back == torch.arange(src_feats.shape[0], device=back.device))
    return idx_st, valid


def _hyp_features(T: torch.Tensor) -> torch.Tensor:
    """T [H,3,4] -> G [H,16] = [-2 vec(R), 2 Rᵀt, -2 t, |t|²]."""
    rot, t = T[:, :, :3], T[:, :, 3]
    rt_t = torch.einsum("hij,hi->hj", rot, t)
    return torch.cat([-2.0 * rot.reshape(-1, 9), 2.0 * rt_t, -2.0 * t,
                      (t * t).sum(-1, keepdim=True)], dim=-1)


def ransac_pose(
    src_pcd: torch.Tensor,
    tgt_pcd: torch.Tensor,
    corr_tgt_idx: torch.Tensor,
    corr_valid: torch.Tensor,
    distance_threshold: float = 0.05,
    ransac_n: int = 3,
    num_iterations: int = 50000,
    edge_similarity: float = 0.9,
    hypothesis_chunk: int = 512,
    refine: bool = True,
    generator: Optional[torch.Generator] = None,
    picks: Optional[torch.Tensor] = None,
) -> RansacResult:
    """src_pcd [N,3] with correspondences tgt_pcd[corr_tgt_idx] [N,3].

    Hypotheses: ``num_iterations // hypothesis_chunk`` chunks of
    ``hypothesis_chunk``, each drawing ``ransac_n`` rows uniformly among the
    valid correspondences.  The draws come from ``generator`` or are passed
    in as ``picks`` [n_chunks, hypothesis_chunk, ransac_n], integers in
    [0, #valid), to replay another generator's draws."""
    n = src_pcd.shape[0]
    dev = src_pcd.device
    corr_src = src_pcd
    corr_tgt = tgt_pcd[corr_tgt_idx.clamp(max=tgt_pcd.shape[0] - 1)]
    n_valid = corr_valid.sum()
    n_valid_f = n_valid.float().clamp_min(1.0)
    thr2 = radius_sq(distance_threshold)
    n_chunks = max(num_iterations // hypothesis_chunk, 1)

    # Valid rows first (stable), then uniform draws over the first n_valid.
    order = torch.argsort((~corr_valid).to(torch.int8), stable=True)
    if picks is None:
        u = torch.rand((n_chunks * hypothesis_chunk, ransac_n), generator=generator, device=dev)
        picks = (u * n_valid.clamp_min(1)).long().clamp(max=n - 1)
    pick = order[picks.reshape(-1, ransac_n).long().to(dev)]  # [H_all, r]
    s = corr_src[pick]
    t = corr_tgt[pick]

    # Edge-length checker, both directions.
    es = torch.linalg.norm(s[:, :, None] - s[:, None, :], dim=-1)
    et = torch.linalg.norm(t[:, :, None] - t[:, None, :], dim=-1)
    off = ~torch.eye(ransac_n, dtype=torch.bool, device=dev)
    edge_ok = (((es > edge_similarity * et) & (et > edge_similarity * es)) | ~off).all(-1).all(-1)
    T = rigid_transform_3pt(s, t)  # [H_all,3,4]
    # Distance checker on the sampled pairs after the fit.
    moved = torch.einsum("hij,hrj->hri", T[:, :, :3], s) + T[:, None, :, 3]
    dist_ok = (((moved - t) ** 2).sum(-1) <= thr2).all(-1)

    outer = corr_tgt[:, :, None] * corr_src[:, None, :]  # y_i x_j
    feat_n = torch.cat([outer.reshape(n, 9), corr_src, corr_tgt,
                        torch.ones(n, 1, device=dev, dtype=corr_src.dtype)], dim=-1)
    a_n = (corr_src**2).sum(-1) + (corr_tgt**2).sum(-1)
    scores, errs = [], []
    for Tc in torch.split(T, hypothesis_chunk):
        d2 = a_n[:, None] + feat_n @ _hyp_features(Tc).T  # [N, H]
        ok = (d2 <= thr2) & corr_valid[:, None]
        scores.append(ok.float().sum(0))
        if not refine:
            errs.append(torch.where(ok, d2, 0.0).sum(0))
    scores = torch.where(edge_ok & dist_ok, torch.cat(scores), -1.0)
    best = scores.argmax()  # first maximum
    best_T = T[best]
    best_inl = scores[best].clamp_min(0.0)

    if refine:
        def inliers(T_):
            d2_ = (((corr_src @ T_[:, :3].T + T_[:, 3]) - corr_tgt) ** 2).sum(-1)
            return d2_, (d2_ <= thr2) & corr_valid

        _, ok = inliers(best_T)
        w = ok.float()
        refit = rigid_transform_horn(corr_src, corr_tgt, w)
        best_T = torch.where(w.sum() >= 3, refit, best_T)  # < 3 inliers: keep
        d2, ok = inliers(best_T)
        best_inl = ok.float().sum()
        err = torch.where(ok, d2, 0.0).sum()
    else:
        err = torch.cat(errs)[best]

    fitness = best_inl / n_valid_f
    rmse = torch.sqrt(err / best_inl.clamp_min(1.0))
    return RansacResult(best_T, fitness, rmse)


def to_homogeneous(transform: torch.Tensor) -> torch.Tensor:
    """[3, 4] -> [4, 4]."""
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=transform.dtype,
                          device=transform.device)
    return torch.cat([transform, bottom])
