"""Pair -> SE(3) (counterpart of ``pcrcg_tpu/eval/tester.py::register_pair_jit``).

The same sequence as the JAX package: pyramid, KPFCNN forward,
interest-point sampling by overlap x saliency (reference
lib/tester.py:146-164), feature matching, RANSAC.  The GT descriptor
metrics of the JAX version are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from pcrcg_tpu_torch import resolve_device
from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.models.kpfcnn import KPFCNN, refuse_image_feature
from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
from pcrcg_tpu_torch.registration.ransac import feature_correspondences, ransac_pose
from pcrcg_tpu_torch.registration.sampling import weighted_sample_topk


@torch.no_grad()
def register_pair(
    model: KPFCNN,
    cfg: Config,
    points: torch.Tensor,  # [2, N0, 3] padded at PAD_COORD, Z-ordered
    masks: torch.Tensor,  # [2, N0]
    features: torch.Tensor,  # [2, N0, Cin]
    generator: Optional[torch.Generator] = None,
    n_points: int = 5000,
    distance_threshold: float = 0.05,
    ransac_n: int = 3,
    mutual: bool = False,
    num_iterations: int = 50000,
    hypothesis_chunk: int = 1024,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    picks: Optional[torch.Tensor] = None,
    device=None,
):
    """Full pair -> transform on ``device``: CUDA unless the caller names the
    CPU (raises without CUDA otherwise); the inputs move there and the
    model must already live there.  Randomness comes from ``generator`` (on
    that device), or from injected draws: ``uniforms`` (src, tgt) for the
    Gumbel sampling and ``picks`` for RANSAC.  Returns a dict with
    transform [3,4], fitness, inlier_rmse and the model outputs.  Raises on
    an ``image_feature`` config (no color branch yet)."""
    refuse_image_feature(cfg)
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev != dev and not (model_dev.type == dev.type == "cuda" and dev.index is None):
        raise ValueError(f"the model is on {model_dev}, the pair runs on {dev}")
    points, masks, features = (t.to(dev) for t in (points, masks, features))
    if uniforms is not None:
        uniforms = [u.to(dev) for u in uniforms]
    if picks is not None:
        picks = picks.to(dev)
    pyramid = build_pyramid_cfg(cfg, points, masks)
    out = model(pyramid, features)
    scores = out["scores_overlap"] * out["scores_saliency"]
    u_src, u_tgt = uniforms if uniforms is not None else (None, None)
    src_idx, src_ok = weighted_sample_topk(scores[0], masks[0], n_points, generator, u_src)
    tgt_idx, tgt_ok = weighted_sample_topk(scores[1], masks[1], n_points, generator, u_tgt)
    s_pts, s_feats = points[0][src_idx], out["feats_f"][0][src_idx]
    t_pts, t_feats = points[1][tgt_idx], out["feats_f"][1][tgt_idx]
    corr, valid = feature_correspondences(s_feats, t_feats, src_ok, tgt_ok, mutual=mutual)
    res = ransac_pose(
        s_pts, t_pts, corr, valid,
        distance_threshold=distance_threshold, ransac_n=ransac_n,
        num_iterations=num_iterations, hypothesis_chunk=hypothesis_chunk,
        generator=generator, picks=picks,
    )
    return {
        "transform": res.transform,
        "fitness": res.fitness,
        "inlier_rmse": res.inlier_rmse,
        "outputs": out,
    }
