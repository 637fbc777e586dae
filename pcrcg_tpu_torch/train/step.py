"""Train / eval / infer steps (counterpart of ``pcrcg_tpu/train/step.py``):
pyramid → model forward (``KPFCNN``, or ``PCRCG`` with its image lift) →
losses, per pair of the batch.

The JAX package compiles the whole step into one program and maps it over
the pairs; here it runs eagerly, pair by pair, and each pair's backward
runs right after its forward (the gradient of the batch mean is the sum
of the pairs' gradients over B), so only one pair's activations live at a
time.  Stats are means over the pairs, ``max_*`` stats maxima.  The
pyramid carries no gradient.

With a ``mesh`` (``parallel/multihost.py::DataMesh``) the same
``train_step`` / ``eval_step`` run data-parallel
(pcrcg_tpu/train/step.py:148-242): each rank of ``torch.distributed`` runs
the per-pair body on its shard of the global batch, with the draws pair i
of the global batch gets on any rank; then one ``all_reduce`` over one
flat buffer sums the gradients and divides by n_data, and the stats are
reduced too (``max_*``: the maximum over every rank), so every rank
applies the same update and takes the same finite-gradient decision.

On the cloud ('model') axis (``make_mesh(n_data, 2)``; the JAX package's
GSPMD-sharded steps) a rank holds one cloud of each of its pairs
(``parallel/cloud.py``): it builds that cloud's pyramid, runs the model
with the axis, and computes the loss from the gathered outputs and both
clouds' geometry with its data row's draws.  It back-propagates 1 /
n_model of the loss, so the gradient of every parameter, per-cloud
(encoder, bottle, decoder) or repeated on both ranks (GCN, projections,
epsilon, heads), is the SUM over the model axis, and the one
``all_reduce`` takes that sum and the mean over the data axis at once; a
non-finite gradient on any rank reaches every rank through it.  The
other stats, the same on a row's ranks, are averaged over the data axis.

The backward goes through each KPConv's route (``models/kpconv.py::
conv_route``); ``kpconv_impl: reduce`` serves only, and ``train_step``
refuses it.

Traced (``utils/profiling.py``): a ``train_step`` is the unit
``train_step``, its stages ``pyramid``, ``forward`` (the model,
the color model's lift included), ``loss``, ``backward`` (the
``.backward()`` call) and ``optimizer`` (``TrainState.apply_gradients``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.data.pair import PairBatch
from pcrcg_tpu_torch.geom.so3 import quaternion_from_matrix
from pcrcg_tpu_torch.losses import LossInputs, metric_loss
from pcrcg_tpu_torch.models.kpconv import conv_route
from pcrcg_tpu_torch.models.lift import images_to
from pcrcg_tpu_torch.models.pcrcg import refuse_image_feature
from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
from pcrcg_tpu_torch.parallel.cloud import CloudAxis
from pcrcg_tpu_torch.parallel.multihost import DataMesh, host_local_batch_slice
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.utils.packing import pack_pytree
from pcrcg_tpu_torch.utils.profiling import stage, unit_span


def forward_pair(model, cfg: Config, points, masks, features, images=None):
    """One pair: points [2, N, 3], masks [2, N], features [2, N, Cin] and,
    for a ``PCRCG`` with ``image_feature``, its ``images`` dict
    (``models/lift.py``; numpy or torch leaves) -> (outputs, pyramid).  An
    ``image_feature`` config without images raises.  (Training builds the
    pyramid with its overflow and may run one cloud a rank: ``pair_loss``.)"""
    refuse_image_feature(cfg, images)
    pyramid = build_pyramid_cfg(cfg, points, masks)
    return _run_model(model, pyramid, features, images, points.device), pyramid


def _run_model(model, pyramid, features, images, device, cloud: Optional[CloudAxis] = None):
    if images is None:
        return model(pyramid, features, cloud=cloud)
    return model(pyramid, features, images_to(images, device), cloud=cloud)


def loss_from_outputs(cfg: Config, out, pyramid, points, masks, rot, trans,
                      uniforms: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      nodes=None) -> Dict[str, torch.Tensor]:
    """``metric_loss`` of one pair's model outputs (with the heads' extras).
    ``nodes``: both clouds' coarsest points and masks, by default the
    pyramid's."""
    inputs = LossInputs(
        src_pcd=points[0], tgt_pcd=points[1], src_mask=masks[0], tgt_mask=masks[1],
        rot=rot, trans=trans, src_feats=out["feats_f"][0], tgt_feats=out["feats_f"][1],
        scores_overlap=torch.cat([out["scores_overlap"][0], out["scores_overlap"][1]]),
        scores_saliency=torch.cat([out["scores_saliency"][0], out["scores_saliency"][1]]),
    )
    extras = {}
    if cfg.node_overlap:
        nodes = (pyramid.points[-1], pyramid.masks[-1]) if nodes is None else nodes
        extras.update(node_overlap_score_pred=out["node_overlap_score_pred"],
                      nodes=nodes[0], node_masks=nodes[1])
    if cfg.quaternion:
        extras.update(quaternion_pred=out["quaternion_pred"], trans_pred=out["trans_pred"],
                      quaternion_gt=quaternion_from_matrix(rot))
    return metric_loss(inputs, cfg, uniforms=uniforms, generator=generator, extras=extras)


def pair_loss(model, cfg: Config, points, masks, features, rot, trans,
              uniforms: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              images=None, raw_points=None,
              cloud: Optional[CloudAxis] = None) -> Dict[str, torch.Tensor]:
    """The loss stats of one pair, ``total`` differentiable, plus
    ``max_overflow`` (> 0: the grid subsample dropped voxels past a level's
    budget for this pair).  The loss's geometry is ``raw_points`` [2, N, 3]
    when given (the pre-augmentation clouds, row for row with ``points``:
    the KITTI protocol, reference datasets/kitti.py:17-19), else the
    model-input ``points``.  With ``cloud`` the inputs are this rank's
    cloud's [1, ...]: the loss takes both clouds' geometry, gathered, and
    ``max_overflow`` is this cloud's."""
    refuse_image_feature(cfg, images)
    pyramid, overflow = build_pyramid_cfg(cfg, points, masks, with_overflow=True)
    with stage("forward"):
        out = _run_model(model, pyramid, features, images, points.device, cloud)
    with stage("loss"):
        loss_pts = points if raw_points is None else raw_points
        nodes = None
        if cloud is not None:
            loss_pts, masks = cloud.gather(loss_pts), cloud.gather(masks)
            if cfg.node_overlap:
                nodes = (cloud.gather(pyramid.points[-1]), cloud.gather(pyramid.masks[-1]))
        stats = loss_from_outputs(cfg, out, pyramid, loss_pts, masks, rot, trans, uniforms,
                                  generator, nodes)
        stats["max_overflow"] = overflow.max().clamp_min(0).float()
    return stats


def _pair_images(images, i: int):
    """Pair ``i`` of a batched image dict (every leaf [B, ...]), or None."""
    return None if images is None else {k: v[i] for k, v in images.items()}


def _stats_over_pairs(model, cfg: Config, batch: PairBatch,
                      uniforms: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      backward: bool = False, images=None,
                      cloud: Optional[CloudAxis] = None) -> Dict[str, torch.Tensor]:
    """Stats over the batch's pairs (mean; ``max_*``: max).  ``uniforms``
    [B, N0·corr_k] are each pair's sampling draws; ``images`` carries the
    pair-batch axis on every leaf.  With ``backward`` each pair's total / B
    (on the cloud axis total / (B · n_model)) is back-propagated as soon as
    it is computed."""
    n_pairs = batch.points.shape[0]
    share = n_pairs * (1 if cloud is None else cloud.size)
    per_pair = []
    for i in range(n_pairs):
        stats = pair_loss(model, cfg, batch.points[i], batch.masks[i], batch.features[i],
                          batch.rot[i], batch.trans[i],
                          uniforms=None if uniforms is None else uniforms[i],
                          generator=generator, images=_pair_images(images, i),
                          raw_points=None if batch.raw_points is None else batch.raw_points[i],
                          cloud=cloud)
        if backward:
            with stage("backward"):
                (stats["total"] / share).backward()
        per_pair.append({k: v.detach() for k, v in stats.items()})
    return {
        k: torch.stack([s[k] for s in per_pair]).amax() if k.startswith("max_")
        else torch.stack([s[k] for s in per_pair]).mean()
        for k in per_pair[0]
    }


def train_step(state: TrainState, cfg: Config, batch: PairBatch,
               uniforms: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               images=None, mesh: Optional[DataMesh] = None) -> Dict[str, torch.Tensor]:
    """Loss, gradients and one optimizer update (skipped when a gradient is
    not finite; ``state.step`` advances either way).  ``images``: the
    batch's image dict, every leaf with the pair-batch axis first.  Returns
    the stats.  With ``mesh``: ``batch`` (and ``images``) is this rank's
    shard (``parallel/mesh.py::shard_pair_batch``), ``uniforms`` the GLOBAL
    batch's draws (or drawn from ``generator``, one stream on every rank);
    gradients and stats are reduced over the ranks before the finite check
    and the update, and the global stats returned."""
    conv_route(cfg.kpconv_impl, backward=True)
    with unit_span("train_step"):
        if mesh is not None:
            uniforms = _shard_draws(cfg, batch, uniforms, generator, mesh)
        state.zero_grad()
        with torch.enable_grad():
            stats = _stats_over_pairs(state.model, cfg, batch, uniforms, generator,
                                      backward=True, images=images,
                                      cloud=None if mesh is None else mesh.cloud)
        if mesh is not None:
            with torch.no_grad():
                _all_reduce_grads(state.params, mesh.n_data)
                stats = _reduce_stats(stats, mesh)
        with stage("optimizer"):
            state.apply_gradients()
    return stats


def _all_reduce_grads(params, n_data: int) -> None:
    """Reduce every gradient (in place; zeros where a parameter has none)
    over the ranks: one SUM over one flat buffer per dtype, in a fixed
    layout, divided by ``n_data`` (the mean over the data axis of the sum
    over the model axis)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    pack, unpack = pack_pytree(grads)
    packed = pack(grads)
    for flat in packed.values():
        dist.all_reduce(flat)
        flat.div_(n_data)
    for t, r in zip(grads, unpack(packed)):
        t.copy_(r)


def _reduce_stats(stats: Dict[str, torch.Tensor], mesh: DataMesh) -> Dict[str, torch.Tensor]:
    """The ranks' stats combined: means averaged over the data axis,
    ``max_*`` maxima over every rank."""
    keys = sorted(stats)
    means = [k for k in keys if not k.startswith("max_")]
    maxes = [k for k in keys if k.startswith("max_")]
    out = {}
    for names, op, group in ((means, dist.ReduceOp.SUM, mesh.data_group),
                             (maxes, dist.ReduceOp.MAX, None)):
        if not names:
            continue
        buf = torch.stack([stats[k].float() for k in names])
        dist.all_reduce(buf, op=op, group=group)
        if op == dist.ReduceOp.SUM:
            buf = buf / mesh.n_data
        out.update(zip(names, buf.unbind()))
    return out


def _shard_draws(cfg: Config, batch: PairBatch, uniforms: Optional[torch.Tensor],
                 generator: Optional[torch.Generator], mesh: DataMesh) -> Optional[torch.Tensor]:
    """This rank's rows of the global batch's sampling draws [B, N0·corr_k]:
    ``uniforms`` holds the global batch's draws; else every rank draws them
    all from ``generator`` (one shared stream) and keeps its rows (by data
    row: a row's cloud ranks take the same draws)."""
    n_pairs = batch.points.shape[0] * mesh.n_data
    if uniforms is None:
        if generator is None:
            return None
        n_draws = batch.points.shape[2] * cfg.budgets.corr_k
        uniforms = torch.rand(n_pairs, n_draws, generator=generator, device=generator.device)
    if uniforms.shape[0] != n_pairs:
        raise ValueError(f"uniforms hold {uniforms.shape[0]} pairs' draws; the global "
                         f"batch has {n_pairs}")
    return uniforms[host_local_batch_slice(n_pairs, mesh)].to(batch.points.device)


@torch.no_grad()
def eval_step(state: TrainState, cfg: Config, batch: PairBatch,
              uniforms: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              images=None, mesh: Optional[DataMesh] = None) -> Dict[str, torch.Tensor]:
    """The loss stats, no update; with ``mesh`` as ``train_step``'s: this
    rank's shard, the global draws, the global stats."""
    if mesh is None:
        return _stats_over_pairs(state.model, cfg, batch, uniforms, generator, images=images)
    draws = _shard_draws(cfg, batch, uniforms, generator, mesh)
    stats = _stats_over_pairs(state.model, cfg, batch, draws, generator, images=images,
                              cloud=mesh.cloud)
    return _reduce_stats(stats, mesh)


@torch.no_grad()
def infer_step(state: TrainState, cfg: Config, batch: PairBatch,
               images=None) -> Dict[str, torch.Tensor]:
    """Forward only: each output stacked over the pairs [B, ...] (the
    descriptor / score dumps of pose estimation)."""
    outs = [forward_pair(state.model, cfg, batch.points[i], batch.masks[i],
                         batch.features[i], _pair_images(images, i))[0]
            for i in range(batch.points.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
