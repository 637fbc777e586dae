"""Training losses: circle loss + weighted-BCE overlap / saliency (+ the
node-overlap BCE and the pose MSE of the optional heads).

Counterpart of ``pcrcg_tpu/losses.py`` (reference lib/loss.py:46-252 and
the trainer's unweighted sum, lib/trainer.py:255-261), with its quirks:

* ``log_scale`` stays at the default 16 (the reference builds
  ``MetricLoss(config)`` positionally, so the config's 24 is dead),
  pos_optimal 0.1, neg_optimal 1.4;
* correspondences are re-filtered at pos_radius − 0.001, then max_points
  of them are sampled uniformly;
* the circle-loss logsumexp runs over ALL real candidate entries — real
  entries with zero weight contribute exp(0) = 1;
* BCE class weights are swapped: positives weighted by the negative
  fraction and vice versa.

Ground truth is computed on the device from the GT pose: overlap by the
tiled min-distance, circle-loss pairs by the tiled radius search (K1 on
the card); with ``budgets.search_impl`` other than ``tiled`` by the dense
``min_dist_sq`` / ``radius_search`` (pcrcg_tpu/losses.py:152-157,
189-195).  The sampling draws one uniform per candidate, from
``uniforms`` when given (parity with the JAX package's draws) or from
``generator``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.geom import se3
from pcrcg_tpu_torch.ops.masked import masked_logsumexp, pad_gather
from pcrcg_tpu_torch.ops.matching import nearest_feature_neighbor
from pcrcg_tpu_torch.ops.neighbors import knn_search, min_dist_sq, radius_search, radius_sq
from pcrcg_tpu_torch.ops.tiled_search import min_dist_sq_tiled, radius_search_tiled


class LossInputs(NamedTuple):
    src_pcd: torch.Tensor  # [N, 3] padded source points
    tgt_pcd: torch.Tensor  # [M, 3]
    src_mask: torch.Tensor  # [N] bool
    tgt_mask: torch.Tensor  # [M]
    rot: torch.Tensor  # [3, 3] GT rotation src -> tgt
    trans: torch.Tensor  # [3] or [3, 1]
    src_feats: torch.Tensor  # [N, C] L2-normalized descriptors
    tgt_feats: torch.Tensor  # [M, C]
    scores_overlap: torch.Tensor  # [N + M] stacked (src then tgt)
    scores_saliency: torch.Tensor  # [N + M]


def weighted_bce(prediction, gt, valid):
    """Class-weighted BCE over valid entries, precision, recall (reference
    loss.py:117-135).  prediction / gt / valid: [K]."""
    v = valid.to(prediction.dtype)
    n = v.sum().clamp_min(1.0)
    # Clamp away exact 0 / 1 before the logs (bounds the backward).
    p = prediction.clamp(1e-7, 1.0 - 1e-7)
    ce = -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))
    w_negative = (gt * v).sum() / n  # the positive fraction, applied to negatives
    w_positive = 1.0 - w_negative
    weights = torch.where(gt >= 0.5, w_positive, w_negative)
    loss = (weights * ce * v).sum() / n

    pred_label = (prediction >= 0.5) & valid
    gt_label = (gt >= 0.5) & valid
    tp = (pred_label & gt_label).sum().float()
    precision = tp / pred_label.sum().float().clamp_min(1.0)
    recall = tp / gt_label.sum().float().clamp_min(1.0)
    return loss, precision, recall


def _sel_mean(x, sel):
    s = sel.to(x.dtype)
    return (x * s).sum() / s.sum().clamp_min(1.0)


def circle_loss_and_recall(coords_dist, feats_dist, pair_valid, cfg: Config,
                           log_scale: float = 16.0, pos_optimal: float = 0.1,
                           neg_optimal: float = 1.4):
    """coords_dist / feats_dist [P, P] over the sampled correspondences,
    pair_valid [P] -> (circle loss, feature-match recall) (reference
    loss.py:71-115)."""
    valid2d = pair_valid[:, None] & pair_valid[None, :]
    # Invalid entries: neither positive nor negative.
    coords_dist = torch.where(valid2d, coords_dist, 0.5 * (cfg.pos_radius + cfg.safe_radius))
    pos_mask = coords_dist < cfg.pos_radius
    neg_mask = coords_dist > cfg.safe_radius

    row_sel = (pos_mask.sum(-1) > 0) & (neg_mask.sum(-1) > 0) & pair_valid
    col_sel = (pos_mask.sum(-2) > 0) & (neg_mask.sum(-2) > 0) & pair_valid

    pos_weight = feats_dist - 1e5 * (~pos_mask).to(feats_dist.dtype)
    pos_weight = (pos_weight - pos_optimal).clamp_min(0.0).detach()
    neg_weight = feats_dist + 1e5 * (~neg_mask).to(feats_dist.dtype)
    neg_weight = (neg_optimal - neg_weight).clamp_min(0.0).detach()

    pos_term = log_scale * (feats_dist - cfg.pos_margin) * pos_weight
    neg_term = log_scale * (cfg.neg_margin - feats_dist) * neg_weight

    def softplus(x):
        return torch.logaddexp(x, torch.zeros_like(x))

    loss_row = softplus(masked_logsumexp(pos_term, valid2d, dim=-1)
                        + masked_logsumexp(neg_term, valid2d, dim=-1)) / log_scale
    loss_col = softplus(masked_logsumexp(pos_term, valid2d, dim=-2)
                        + masked_logsumexp(neg_term, valid2d, dim=-2)) / log_scale
    circle = (_sel_mean(loss_row, row_sel) + _sel_mean(loss_col, col_sel)) / 2.0

    # Feature-match recall (loss.py:104-115): among anchors with a GT
    # positive, the share whose nearest-feature match lies within pos_radius.
    has_pos = pos_mask.sum(-1) > 0
    fd = torch.where(valid2d, feats_dist, torch.finfo(feats_dist.dtype).max)
    sel_dist = coords_dist.gather(1, fd.argmin(-1, keepdim=True))[:, 0]
    n_pred = ((sel_dist < cfg.pos_radius) & has_pos).sum().float()
    n_gt = has_pos.sum().float() + 1e-12
    return circle, n_pred / n_gt


def _node_overlap_gt(points, mask, over, nodes, node_mask, chunk):
    """Super-node overlap GT (reference datasets/dataloader.py:107-198): each
    real point goes to its nearest node; a node's label is the share of its
    points inside the overlap region."""
    nc = nodes.shape[0]
    idx, _ = knn_search(points, nodes, node_mask, 1, chunk)
    idx = torch.where(mask, idx[:, 0].clamp(max=nc - 1), nc)  # pad points -> dropped
    tot = torch.zeros(nc + 1, device=points.device).index_add_(
        0, idx, torch.ones_like(idx, dtype=torch.float32))
    vis = torch.zeros(nc + 1, device=points.device).index_add_(0, idx, over.float())
    return vis[:nc] / tot[:nc].clamp_min(1.0)


def metric_loss(inputs: LossInputs, cfg: Config, uniforms: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                extras: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The reference's stats dict plus ``total`` = the unweighted sum of
    circle + overlap + saliency (+ node_overlap, pose).  ``uniforms`` [N·k]
    (k = budgets.corr_k) are the sampling draws; without them they come
    from ``generator``."""
    n, m = inputs.src_pcd.shape[0], inputs.tgt_pcd.shape[0]
    b = cfg.budgets
    chunk = b.query_chunk
    trans = inputs.trans.reshape(3)
    src_warp = se3.transform(se3.from_rt(inputs.rot, trans), inputs.src_pcd)
    src_warp = torch.where(inputs.src_mask[:, None], src_warp, inputs.src_pcd)
    stats: Dict[str, torch.Tensor] = {}

    with torch.no_grad():
        # Overlap: a counterpart within overlap_radius (tile-pruned minimum,
        # exact wherever it is compared against the small radius).
        r2 = radius_sq(cfg.overlap_radius)
        m_tiles = b.m_tiles_at(0)
        tiled = b.search_impl == "tiled"

        def min_d2(q, s, s_mask):
            if tiled:
                return min_dist_sq_tiled(q, s, s_mask, b.search_tile, m_tiles)
            return min_dist_sq(q, s, s_mask, chunk)

        src_over = (min_d2(src_warp, inputs.tgt_pcd, inputs.tgt_mask) <= r2) & inputs.src_mask
        tgt_over = (min_d2(inputs.tgt_pcd, src_warp, inputs.src_mask) <= r2) & inputs.tgt_mask
        gt_labels = torch.cat([src_over, tgt_over]).float()
        valid = torch.cat([inputs.src_mask, inputs.tgt_mask])

        # Saliency: inside the overlap, is the nearest-feature counterpart
        # within matchability_radius (loss.py:206-224)?
        idx1 = nearest_feature_neighbor(inputs.src_feats, inputs.tgt_feats, tgt_over, chunk)
        d1 = torch.linalg.norm(src_warp - pad_gather(inputs.tgt_pcd, idx1, 0.0), dim=-1)
        idx2 = nearest_feature_neighbor(inputs.tgt_feats, inputs.src_feats, src_over, chunk)
        d2 = torch.linalg.norm(inputs.tgt_pcd - pad_gather(src_warp, idx2, 0.0), dim=-1)
        sal_gt = torch.cat([d1 < cfg.matchability_radius, d2 < cfg.matchability_radius]).float()
        sal_valid = torch.cat([src_over, tgt_over])

        # Circle-loss candidates: the radius search at overlap_radius,
        # re-filtered at pos_radius − 0.001 (loss.py:228-233), then max_points
        # of them drawn uniformly: a stable descending sort of the draws, so
        # ties keep the lower index first as lax.top_k does.
        k = b.corr_k
        if tiled:
            cand = radius_search_tiled(src_warp, inputs.tgt_pcd, inputs.tgt_mask,
                                       cfg.overlap_radius, k, b.search_tile, m_tiles)
        else:
            cand = radius_search(src_warp, inputs.tgt_pcd, inputs.tgt_mask, cfg.overlap_radius,
                                 k, chunk)
        cand_valid = (cand < m) & inputs.src_mask[:, None]
        cand_tgt = cand.clamp(max=m - 1)
        cand_dist = torch.linalg.norm(src_warp[:, None, :] - inputs.tgt_pcd[cand_tgt], dim=-1)
        cand_valid &= cand_dist < (cfg.pos_radius - 0.001)
        if uniforms is None:
            uniforms = torch.rand(n * k, generator=generator, device=src_warp.device)
        score = torch.where(cand_valid.reshape(-1), uniforms, -torch.inf)
        take = torch.sort(score, descending=True, stable=True).indices[:cfg.max_points]
        pair_valid = cand_valid.reshape(-1)[take]
        src_idx = take // k
        tgt_idx = cand_tgt.reshape(-1)[take]
        s_pts, t_pts = src_warp[src_idx], inputs.tgt_pcd[tgt_idx]
        coords_dist = torch.sqrt((
            (s_pts**2).sum(-1)[:, None] + (t_pts**2).sum(-1)[None, :] - 2.0 * (s_pts @ t_pts.T)
        ).clamp_min(1e-12))

    overlap_loss, stats["overlap_precision"], stats["overlap_recall"] = weighted_bce(
        inputs.scores_overlap, gt_labels, valid)
    stats["overlap_loss"] = overlap_loss
    saliency_loss, stats["saliency_precision"], stats["saliency_recall"] = weighted_bce(
        inputs.scores_saliency, sal_gt, sal_valid)
    stats["saliency_loss"] = saliency_loss

    # Descriptors are L2-normalized: d² = 2 − 2·cos, clamped at 1e-12.
    s_f, t_f = inputs.src_feats[src_idx], inputs.tgt_feats[tgt_idx]
    feats_dist = torch.sqrt((2.0 - 2.0 * (s_f @ t_f.T)).clamp_min(1e-12))
    circle, recall = circle_loss_and_recall(coords_dist, feats_dist, pair_valid, cfg)
    stats["circle_loss"] = circle
    stats["recall"] = recall
    total = circle + overlap_loss + saliency_loss

    if extras and "node_overlap_score_pred" in extras:
        nodes, node_masks = extras["nodes"], extras["node_masks"]  # [2, Nc, 3], [2, Nc]
        with torch.no_grad():
            gt_nodes = torch.cat([
                _node_overlap_gt(src_warp, inputs.src_mask, src_over, nodes[0], node_masks[0],
                                 chunk),
                _node_overlap_gt(inputs.tgt_pcd, inputs.tgt_mask, tgt_over, nodes[1],
                                 node_masks[1], chunk),
            ])
        no_loss, stats["node_overlap_precision"], stats["node_overlap_recall"] = weighted_bce(
            extras["node_overlap_score_pred"].reshape(-1), gt_nodes,
            torch.cat([node_masks[0], node_masks[1]]))
        stats["node_overlap_loss"] = no_loss
        total = total + no_loss
    if extras and "quaternion_pred" in extras:
        pose_loss = ((extras["quaternion_pred"] - extras["quaternion_gt"]) ** 2).sum()
        pose_loss = pose_loss + ((extras["trans_pred"] - trans) ** 2).sum()
        stats["pose_loss"] = pose_loss
        total = total + pose_loss

    stats["total"] = total
    return stats

