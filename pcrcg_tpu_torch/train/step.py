"""Train / eval / infer steps (counterpart of ``pcrcg_tpu/train/step.py``):
pyramid → model forward (``KPFCNN``, or ``PCRCG`` with its image lift) →
losses, per pair of the batch.

The JAX package compiles the whole step into one program and maps it over
the pairs; here it runs eagerly, pair by pair, and each pair's backward
runs right after its forward (the gradient of the batch mean is the sum
of the pairs' gradients over B), so only one pair's activations live at a
time.  Stats are means over the pairs, ``max_*`` stats maxima.  The
pyramid carries no gradient.  On the default (tiled) KPConv route the
backward reaches K3 / K4 through every encoder KPConv and K5 through every
strided shortcut; with ``kpconv_tiled: false`` it reaches K3's gathered
entry through every KPConv (K6 / K7 forward), and the gathers' own
backward is an ``index_add_``.  ``kpconv_impl: reduce`` serves only.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.data.pair import PairBatch
from pcrcg_tpu_torch.geom.so3 import quaternion_from_matrix
from pcrcg_tpu_torch.losses import LossInputs, metric_loss
from pcrcg_tpu_torch.models.kpconv import resolve_kpconv_impl
from pcrcg_tpu_torch.models.lift import images_to
from pcrcg_tpu_torch.models.pcrcg import refuse_image_feature
from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
from pcrcg_tpu_torch.train.state import TrainState


def forward_pair(model, cfg: Config, points, masks, features, images=None,
                 with_overflow: bool = False):
    """One pair: points [2, N, 3], masks [2, N], features [2, N, Cin] and,
    for a ``PCRCG`` with ``image_feature``, its ``images`` dict
    (``models/lift.py``; numpy or torch leaves) -> (outputs, pyramid),
    plus the per-level voxel-budget overflow [L-1, 2] with
    ``with_overflow``.  An ``image_feature`` config without images
    raises."""
    refuse_image_feature(cfg, images)
    built = build_pyramid_cfg(cfg, points, masks, with_overflow=with_overflow)
    pyramid, overflow = built if with_overflow else (built, None)
    if images is None:
        out = model(pyramid, features)
    else:
        out = model(pyramid, features, images_to(images, points.device))
    return (out, pyramid, overflow) if with_overflow else (out, pyramid)


def loss_from_outputs(cfg: Config, out, pyramid, points, masks, rot, trans,
                      uniforms: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """``metric_loss`` of one pair's model outputs (with the heads' extras)."""
    inputs = LossInputs(
        src_pcd=points[0], tgt_pcd=points[1], src_mask=masks[0], tgt_mask=masks[1],
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
    return metric_loss(inputs, cfg, uniforms=uniforms, generator=generator, extras=extras)


def pair_loss(model, cfg: Config, points, masks, features, rot, trans,
              uniforms: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              images=None) -> Dict[str, torch.Tensor]:
    """The loss stats of one pair, ``total`` differentiable, plus
    ``max_overflow`` (> 0: the grid subsample dropped voxels past a level's
    budget for this pair)."""
    out, pyramid, overflow = forward_pair(model, cfg, points, masks, features, images,
                                          with_overflow=True)
    stats = loss_from_outputs(cfg, out, pyramid, points, masks, rot, trans, uniforms,
                              generator)
    stats["max_overflow"] = overflow.max().clamp_min(0).float()
    return stats


def _pair_images(images, i: int):
    """Pair ``i`` of a batched image dict (every leaf [B, ...]), or None."""
    return None if images is None else {k: v[i] for k, v in images.items()}


def _stats_over_pairs(model, cfg: Config, batch: PairBatch,
                      uniforms: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      backward: bool = False, images=None) -> Dict[str, torch.Tensor]:
    """Stats over the batch's pairs (mean; ``max_*``: max).  ``uniforms``
    [B, N0·corr_k] are each pair's sampling draws; ``images`` carries the
    pair-batch axis on every leaf.  With ``backward`` each pair's total / B
    is back-propagated as soon as it is computed."""
    n_pairs = batch.points.shape[0]
    per_pair = []
    for i in range(n_pairs):
        stats = pair_loss(model, cfg, batch.points[i], batch.masks[i], batch.features[i],
                          batch.rot[i], batch.trans[i],
                          uniforms=None if uniforms is None else uniforms[i],
                          generator=generator, images=_pair_images(images, i))
        if backward:
            (stats["total"] / n_pairs).backward()
        per_pair.append({k: v.detach() for k, v in stats.items()})
    return {
        k: torch.stack([s[k] for s in per_pair]).amax() if k.startswith("max_")
        else torch.stack([s[k] for s in per_pair]).mean()
        for k in per_pair[0]
    }


def train_step(state: TrainState, cfg: Config, batch: PairBatch,
               uniforms: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               images=None) -> Dict[str, torch.Tensor]:
    """Loss, gradients and one optimizer update (skipped when a gradient is
    not finite; ``state.step`` advances either way).  ``images``: the
    batch's image dict, every leaf with the pair-batch axis first.  Returns
    the stats."""
    if resolve_kpconv_impl(cfg.kpconv_impl) == "reduce":
        raise NotImplementedError(
            "kpconv_impl='reduce' serves only: its kernel (K8, pcrcg_tpu/ops/kpconv_pallas.py)"
            " has no backward, and the JAX package defines no VJP for it"
        )
    state.zero_grad()
    with torch.enable_grad():
        stats = _stats_over_pairs(state.model, cfg, batch, uniforms, generator, backward=True,
                                  images=images)
    state.apply_gradients()
    return stats


@torch.no_grad()
def eval_step(state: TrainState, cfg: Config, batch: PairBatch,
              uniforms: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              images=None) -> Dict[str, torch.Tensor]:
    return _stats_over_pairs(state.model, cfg, batch, uniforms, generator, images=images)


@torch.no_grad()
def infer_step(state: TrainState, cfg: Config, batch: PairBatch,
               images=None) -> Dict[str, torch.Tensor]:
    """Forward only: each output stacked over the pairs [B, ...] (the
    descriptor / score dumps of pose estimation)."""
    outs = [forward_pair(state.model, cfg, batch.points[i], batch.masks[i],
                         batch.features[i], _pair_images(images, i))[0]
            for i in range(batch.points.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
