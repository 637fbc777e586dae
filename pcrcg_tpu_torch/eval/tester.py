"""Test-time pipelines (counterpart of ``pcrcg_tpu/eval/tester.py``).

* ``register_pair``: pair -> SE(3) in the JAX package's sequence: pyramid,
  model forward (KPFCNN, or PCRCG with its image lift), interest-point
  sampling by overlap x saliency (reference lib/tester.py:146-164),
  feature matching, RANSAC; with the GT pose, the descriptor metrics of
  reference lib/benchmark_utils.py:226-311 over the sampled points.
* ``IndoorTester``: every pair of a 3DMatch / 3DLoMatch split through
  ``register_pair``, a per-scene est.log, and the registration-recall
  protocol (``eval/benchmark_3dmatch.py``).
* ``dump_descriptors``: the reference's per-pair dump for offline RANSAC.

Pair keys: the 3DMatch pkl pair (src = cloud_bin_j -> tgt = cloud_bin_i)
is gt.log entry (i, j) with the same src -> tgt matrix.
"""
from __future__ import annotations

import os
import re
from collections import defaultdict, deque
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pcrcg_tpu_torch import resolve_device
from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.data.loader import to_device
from pcrcg_tpu_torch.eval.benchmark_3dmatch import benchmark, write_trajectory
from pcrcg_tpu_torch.eval.metrics import feature_match_recall_sweep, inlier_ratio
from pcrcg_tpu_torch.models.pcrcg import refuse_image_feature
from pcrcg_tpu_torch.registration.ransac import (
    feature_correspondences,
    ransac_pose,
    to_homogeneous,
)
from pcrcg_tpu_torch.registration.sampling import weighted_sample_topk
from pcrcg_tpu_torch.train.step import forward_pair


@torch.no_grad()
def register_pair(
    model,
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
    images=None,
    device=None,
    rot: Optional[torch.Tensor] = None,
    trans: Optional[torch.Tensor] = None,
):
    """Full pair -> transform on ``device``: CUDA unless the caller names the
    CPU (raises without CUDA otherwise); the inputs move there and the
    model must already live there.  Randomness comes from ``generator`` (on
    that device), or from injected draws: ``uniforms`` (src, tgt) for the
    Gumbel sampling and ``picks`` for RANSAC.  ``model`` is a ``KPFCNN``,
    or a ``PCRCG`` that takes ``images`` (``models/lift.py``; numpy or
    torch leaves); an ``image_feature`` config without images raises.
    Returns a dict with transform [3,4], fitness, inlier_rmse and the
    model outputs; with the GT ``rot`` / ``trans`` also the inlier ratios
    without / with the mutual check at 0.1 m over the sampled points and
    the pair's FMR flags [3] at 0.05 / 0.1 / 0.2 m."""
    refuse_image_feature(cfg, images)
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev != dev and not (model_dev.type == dev.type == "cuda" and dev.index is None):
        raise ValueError(f"the model is on {model_dev}, the pair runs on {dev}")
    points, masks, features = (t.to(dev) for t in (points, masks, features))
    if uniforms is not None:
        uniforms = [u.to(dev) for u in uniforms]
    if picks is not None:
        picks = picks.to(dev)
    out = forward_pair(model, cfg, points, masks, features, images)[0]
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
    result = {
        "transform": res.transform,
        "fitness": res.fitness,
        "inlier_rmse": res.inlier_rmse,
        "outputs": out,
    }
    if rot is not None and trans is not None:
        ir = inlier_ratio(s_pts, t_pts, s_feats, t_feats, rot.to(dev), trans.to(dev),
                          src_ok, tgt_ok, inlier_distance_threshold=0.1)
        result["inlier_ratio_wo_mutual"] = ir["inlier_ratio_wo_mutual"]
        result["inlier_ratio_w_mutual"] = ir["inlier_ratio_w_mutual"]
        # A pair "recalls" when its inlier ratio clears 0.05 (reference
        # benchmark_utils.py:226-265), at three distance thresholds.
        result["fmr_flags"] = feature_match_recall_sweep(
            ir["distance_wo_mutual"], src_ok, thresholds=(0.05, 0.1, 0.2))
    return result


def fragment_id(path: str) -> int:
    m = re.search(r"cloud_bin_(\d+)", path)
    return int(m.group(1))


def scene_of(path: str) -> str:
    return path.split("/")[-2]


class IndoorTester:
    """3DMatch / 3DLoMatch evaluation: estimates every pair's transform and
    scores the registration-recall protocol against the gt files of
    ``gt_folder`` (one folder per scene with gt.log / gt.info).  Runs on
    ``device``: CUDA unless the caller names the CPU; the model must live
    there."""

    def __init__(self, cfg: Config, model, gt_folder: str, device=None):
        self.cfg = cfg
        self.model = model
        self.gt_folder = gt_folder
        self.device = resolve_device(device)

    def run(self, dataset, loader, n_points: int = 5000, mutual: bool = False,
            est_folder: Optional[str] = None, generator: Optional[torch.Generator] = None,
            num_iterations: int = 50000, hypothesis_chunk: int = 1024) -> Dict:
        est_folder = est_folder or os.path.join(self.cfg.exp_dir, "est_traj")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        per_scene_pairs = defaultdict(list)
        per_scene_tsfm = defaultdict(list)
        infos = dataset.infos
        idx = 0
        # Results stay on the device; pair i - 2's are copied to the host
        # while pair i computes, so the host does not wait on every pair.
        depth = 2
        inflight: deque = deque()
        ir_wo, ir_w, fmr_flags = [], [], []

        def realize(item):
            scene, ij, res = item
            per_scene_pairs[scene].append(ij)
            per_scene_tsfm[scene].append(to_homogeneous(res["transform"]).cpu().numpy())
            ir_wo.append(float(res["inlier_ratio_wo_mutual"]))
            ir_w.append(float(res["inlier_ratio_w_mutual"]))
            fmr_flags.append(res["fmr_flags"].cpu().numpy())

        for batch, images in loader:
            batch, images = to_device(batch, images, self.device)
            for b in range(batch.points.shape[0]):
                im = None if images is None else {k: v[b] for k, v in images.items()}
                res = register_pair(
                    self.model, self.cfg, batch.points[b], batch.masks[b],
                    batch.features[b], generator, n_points=n_points, mutual=mutual,
                    num_iterations=num_iterations, hypothesis_chunk=hypothesis_chunk,
                    images=im, device=self.device, rot=batch.rot[b], trans=batch.trans[b],
                )
                res = {k: res[k] for k in ("transform", "inlier_ratio_wo_mutual",
                                           "inlier_ratio_w_mutual", "fmr_flags")}
                scene = scene_of(infos["src"][idx])
                ij = (fragment_id(infos["tgt"][idx]), fragment_id(infos["src"][idx]))
                inflight.append((scene, ij, res))
                if len(inflight) > depth:
                    realize(inflight.popleft())
                idx += 1
        while inflight:
            realize(inflight.popleft())
        # Protocol completeness: every split pair must be scored; a loader
        # that dropped the tail would under-report recall.
        n_expected = len(infos["src"])
        if idx != n_expected:
            raise RuntimeError(
                f"IndoorTester scored {idx}/{n_expected} pairs — the loader "
                "dropped part of the split (construct the eval PairLoader "
                "with drop_last=False / batch_size dividing the split)"
            )
        for scene in per_scene_pairs:
            n_frag = max(max(i, j) for i, j in per_scene_pairs[scene]) + 1
            write_trajectory(
                os.path.join(est_folder, scene, "est.log"),
                np.asarray(per_scene_pairs[scene]),
                np.stack(per_scene_tsfm[scene]),
                n_frag,
            )
        result = benchmark(est_folder, self.gt_folder)
        # Descriptor-quality headline numbers: mean inlier ratios and the
        # feature-match recall at 0.05 / 0.1 / 0.2 m.
        fmr = np.mean(np.stack(fmr_flags), axis=0) if fmr_flags else np.zeros(3)
        desc = {
            "inlier_ratio_wo_mutual": float(np.mean(ir_wo)) if ir_wo else 0.0,
            "inlier_ratio_w_mutual": float(np.mean(ir_w)) if ir_w else 0.0,
            "fmr_005": float(fmr[0]),
            "fmr_01": float(fmr[1]),
            "fmr_02": float(fmr[2]),
        }
        print(result.summary(), flush=True)
        print(
            "Inlier ratio (wo/w mutual): "
            f"{desc['inlier_ratio_wo_mutual']:.4f} / {desc['inlier_ratio_w_mutual']:.4f}  "
            f"FMR@(0.05/0.1/0.2 m): {desc['fmr_005']:.4f} / {desc['fmr_01']:.4f} / "
            f"{desc['fmr_02']:.4f}",
            flush=True,
        )
        return {"benchmark": result, "est_folder": est_folder, "n_pairs": idx, **desc}


@torch.no_grad()
def dump_descriptors(cfg: Config, model, batch, images, out_dir: str, idx: int):
    """The reference's per-pair dump for offline RANSAC (tester.py:92-102):
    ``<out_dir>/<idx>.npz`` with the first pair's points, masks, feats,
    overlaps, saliency, rot and trans.  The model runs where the batch is."""
    os.makedirs(out_dir, exist_ok=True)
    im = None if images is None else {k: v[0] for k, v in images.items()}
    out = forward_pair(model, cfg, batch.points[0], batch.masks[0], batch.features[0], im)[0]
    np.savez(
        os.path.join(out_dir, f"{idx}.npz"),
        points=batch.points[0].cpu().numpy(),
        masks=batch.masks[0].cpu().numpy(),
        feats=out["feats_f"].cpu().numpy(),
        overlaps=out["scores_overlap"].cpu().numpy(),
        saliency=out["scores_saliency"].cpu().numpy(),
        rot=batch.rot[0].cpu().numpy(),
        trans=batch.trans[0].cpu().numpy(),
    )
