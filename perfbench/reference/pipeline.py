"""The reference's entry points: one pair's batch, forward pass,
registration and training steps, in plain PyTorch (float32, TF32 off unless
``perfbench.reference.precision(True)`` is in force).

Everything here is worked out from the harness's raw inputs: the pair's
fragments and images, the seeded weights and the injected draws.  The
program's outputs enter only where a stage is judged on them
(``register_from_outputs``), never as a state the reference builds on.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from perfbench.reference.config import Config, config_from_dict
from perfbench.reference.data.pair import make_pair_batch
from perfbench.reference.geom.so3 import quaternion_from_matrix
from perfbench.reference.losses import LossInputs, metric_loss
from perfbench.reference.models.pcrcg import PCRCG
from perfbench.reference.ops.pyramid import build_pyramid_cfg
from perfbench.reference.registration.ransac import feature_correspondences, ransac_pose
from perfbench.reference.registration.sampling import weighted_sample_topk

IMAGE_KEYS = ("colors", "depths", "world2cam", "valid_maps", "intrinsics")


def config_from_sections(sections: Mapping) -> Config:
    """A configuration file's sections (the YAML layout) -> Config."""
    flat: Dict = {}
    for key, value in sections.items():
        if isinstance(value, dict) and key != "budgets":
            flat.update(value)
        else:
            flat[key] = value
    return config_from_dict(flat)


def build_model(cfg: Config, state: Mapping[str, torch.Tensor], device) -> PCRCG:
    """The reference model on ``device`` with ``state`` (the harness's
    seeded weights, keyed as the port's ``PCRCG`` state dict); the kernel
    points are the reference's own."""
    model = PCRCG(cfg).to(device)
    own = model.state_dict()
    missing = [k for k in own if k not in state and not k.endswith("kernel_points")]
    if missing:
        raise KeyError(f"weights missing for {missing[:5]}")
    with torch.no_grad():
        for name, t in own.items():
            if not name.endswith("kernel_points"):
                t.copy_(state[name])
    return model.eval()


def pair_batch(sample: Mapping, cfg: Config, device):
    """One pair's padded, Z-ordered batch (B = 1) from its raw clouds."""
    return make_pair_batch([dict(sample)], cfg.budgets.points[0], in_feats_dim=cfg.in_feats_dim,
                           device=device)


def images_on(images: Optional[Mapping], device):
    return None if images is None else {k: torch.as_tensor(images[k]).to(device)
                                        for k in IMAGE_KEYS}


def forward(model: PCRCG, cfg: Config, points, masks, features, images=None):
    """One pair [2, N, ...] -> (outputs, pyramid, lifted features or None)."""
    pyramid = build_pyramid_cfg(cfg, points, masks)
    lifted = None
    if cfg.image_feature:
        lifted = model.lift(pyramid.points[0], pyramid.masks[0],
                            *(images[k] for k in IMAGE_KEYS))
        features = lifted
    return model.kpfcnn(pyramid, features), pyramid, lifted


def register_from_outputs(cfg: Config, outputs: Mapping, points, masks, uniforms, picks,
                          n_points: int = 5000, distance_threshold: float = 0.05,
                          ransac_n: int = 3, num_iterations: int = 50000,
                          hypothesis_chunk: int = 1024) -> Dict[str, torch.Tensor]:
    """Sampling, matching and RANSAC over one pair's model outputs, with the
    injected draws: uniforms [2, N0] (Gumbel keys), picks
    [chunks, hypothesis_chunk, ransac_n]."""
    scores = outputs["scores_overlap"] * outputs["scores_saliency"]
    src_idx, src_ok = weighted_sample_topk(scores[0], masks[0], n_points, uniform=uniforms[0])
    tgt_idx, tgt_ok = weighted_sample_topk(scores[1], masks[1], n_points, uniform=uniforms[1])
    s_pts, s_feats = points[0][src_idx], outputs["feats_f"][0][src_idx]
    t_pts, t_feats = points[1][tgt_idx], outputs["feats_f"][1][tgt_idx]
    corr, valid = feature_correspondences(s_feats, t_feats, src_ok, tgt_ok)
    res = ransac_pose(s_pts, t_pts, corr, valid, distance_threshold=distance_threshold,
                      ransac_n=ransac_n, num_iterations=num_iterations,
                      hypothesis_chunk=hypothesis_chunk, picks=picks)
    return {"transform": res.transform, "fitness": res.fitness, "inlier_rmse": res.inlier_rmse,
            "corr": corr, "valid": valid}


def pair_loss(model: PCRCG, cfg: Config, points, masks, features, rot, trans, uniforms,
              images=None, raw_points=None) -> Dict[str, torch.Tensor]:
    """The loss stats of one pair, ``total`` differentiable (the loss on
    ``raw_points`` when given, the KITTI protocol)."""
    out, pyramid, _ = forward(model, cfg, points, masks, features, images)
    loss_pts = points if raw_points is None else raw_points
    inputs = LossInputs(
        src_pcd=loss_pts[0], tgt_pcd=loss_pts[1], src_mask=masks[0], tgt_mask=masks[1],
        rot=rot, trans=trans, src_feats=out["feats_f"][0], tgt_feats=out["feats_f"][1],
        scores_overlap=torch.cat([out["scores_overlap"][0], out["scores_overlap"][1]]),
        scores_saliency=torch.cat([out["scores_saliency"][0], out["scores_saliency"][1]]),
    )
    extras = {}
    if cfg.node_overlap:
        extras.update(node_overlap_score_pred=out["node_overlap_score_pred"],
                      nodes=pyramid.points[-1], node_masks=pyramid.masks[-1])
    if cfg.quaternion:
        extras.update(quaternion_pred=out["quaternion_pred"], trans_pred=out["trans_pred"],
                      quaternion_gt=quaternion_from_matrix(rot))
    return metric_loss(inputs, cfg, uniforms=uniforms, extras=extras)


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """SGD with momentum and L2 weight decay (the optax chain of the
    configurations), or Adam."""
    if cfg.optimizer.upper() == "SGD":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    return torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.weight_decay)


def train_step(model: PCRCG, leaves, optimizer, cfg: Config, batch, uniforms, images=None):
    """One step over a batch of pairs: the mean loss's gradients of
    ``leaves`` (the trained parameters), then one update (skipped when a
    gradient is not finite).  Returns (stats, the gradients before the
    update, aligned with ``leaves``)."""
    for p in leaves:
        p.grad = None
    n_pairs = batch.points.shape[0]
    stats_all = []
    with torch.enable_grad():
        for i in range(n_pairs):
            raw = None if batch.raw_points is None else batch.raw_points[i]
            pair_images = None if images is None else {k: v[i] for k, v in images.items()}
            stats = pair_loss(model, cfg, batch.points[i], batch.masks[i], batch.features[i],
                              batch.rot[i], batch.trans[i], uniforms[i], pair_images, raw)
            (stats["total"] / n_pairs).backward()
            stats_all.append({k: v.detach() for k, v in stats.items()})
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone() for p in leaves]
    if bool(torch.stack([torch.isfinite(g).all() for g in grads]).all()):
        for p, g in zip(leaves, grads):
            p.grad = g.clone()
        optimizer.step()
    for p in leaves:
        p.grad = None
    return {k: torch.stack([s[k] for s in stats_all]).mean() for k in stats_all[0]}, grads
