"""ModelNet registration metrics, DCP / RPMNet protocol (counterpart of
``pcrcg_tpu/eval/modelnet_metrics.py``; the metrics are its numpy code
copied as it is).

Reference lib/tester.py:248-340: per pair the euler-angle r_mse / r_mae,
the translation t_mse / t_mae, the isotropic rotation / translation errors
(err_r_deg, err_t) and the modified chamfer distance, aggregated by
``summarize_metrics`` (rmse / mean); and the ``ModelnetTester`` flow
(tester.py:343-437: top-450 sampling, RANSAC n = 3 at 0.02).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pcrcg_tpu_torch import resolve_device
from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.data.loader import to_device
from pcrcg_tpu_torch.eval.tester import register_pair


def dcm2euler_xyz(mats: np.ndarray) -> np.ndarray:
    """Rotation matrices [N,3,3] -> intrinsic-xyz euler angles in degrees
    (scipy Rotation.as_euler('xyz') convention used at tester.py:264-265)."""
    out = np.zeros((mats.shape[0], 3))
    for i, m in enumerate(mats):
        sy = -m[2, 0]
        sy = np.clip(sy, -1.0, 1.0)
        y = np.arcsin(sy)
        if abs(sy) < 1.0 - 1e-9:
            x = np.arctan2(m[2, 1], m[2, 2])
            z = np.arctan2(m[1, 0], m[0, 0])
        else:  # gimbal lock
            x = np.arctan2(-m[1, 2], m[1, 1])
            z = 0.0
        out[i] = [x, y, z]
    return np.degrees(out)


def _transform(g: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ g[..., :3, :3].swapaxes(-1, -2) + g[..., None, :3, 3]


def _inverse(g: np.ndarray) -> np.ndarray:
    rot = g[..., :3, :3]
    t = g[..., :3, 3]
    inv_rot = rot.swapaxes(-1, -2)
    inv_t = -np.einsum("...ij,...j->...i", inv_rot, t)
    return np.concatenate([inv_rot, inv_t[..., None]], axis=-1)


def _concat(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    rot = a[..., :3, :3] @ b[..., :3, :3]
    t = np.einsum("...ij,...j->...i", a[..., :3, :3], b[..., :3, 3]) + a[..., :3, 3]
    return np.concatenate([rot, t[..., None]], axis=-1)


def compute_metrics(
    points_src: np.ndarray,  # [B,N,3] (transformed source fed to the model)
    points_ref: np.ndarray,  # [B,M,3]
    points_raw: np.ndarray,  # [B,R,3] clean full cloud
    gt_transforms: np.ndarray,  # [B,3,4] src->ref
    pred_transforms: np.ndarray,  # [B,3,4]
) -> Dict[str, np.ndarray]:
    r_gt = dcm2euler_xyz(gt_transforms[:, :3, :3])
    r_pred = dcm2euler_xyz(pred_transforms[:, :3, :3])
    t_gt = gt_transforms[:, :3, 3]
    t_pred = pred_transforms[:, :3, 3]
    r_mse = np.mean((r_gt - r_pred) ** 2, axis=1)
    r_mae = np.mean(np.abs(r_gt - r_pred), axis=1)
    t_mse = np.mean((t_gt - t_pred) ** 2, axis=1)
    t_mae = np.mean(np.abs(t_gt - t_pred), axis=1)

    concatenated = _concat(_inverse(gt_transforms), pred_transforms)
    rot_trace = np.trace(concatenated[:, :3, :3], axis1=1, axis2=2)
    err_r_deg = np.degrees(np.arccos(np.clip(0.5 * (rot_trace - 1), -1.0, 1.0)))
    err_t = np.linalg.norm(concatenated[:, :3, 3], axis=-1)

    # Modified Chamfer (tester.py:280-286)
    src_transformed = _transform(pred_transforms, points_src)
    src_clean = _transform(_concat(pred_transforms, _inverse(gt_transforms)), points_raw)

    def min_sq(a, b):  # [B,N,3],[B,M,3] -> [B,N]
        d = np.sum((a[:, :, None, :] - b[:, None, :, :]) ** 2, axis=-1)
        return d.min(-1)

    chamfer = min_sq(src_transformed, points_raw).mean(1) + min_sq(points_ref, src_clean).mean(1)
    return {
        "r_mse": r_mse,
        "r_mae": r_mae,
        "t_mse": t_mse,
        "t_mae": t_mae,
        "err_r_deg": err_r_deg,
        "err_t": err_t,
        "chamfer_dist": chamfer,
    }


def summarize_metrics(metrics: Dict[str, np.ndarray]) -> Dict[str, float]:
    out = {}
    for k, v in metrics.items():
        if k.endswith("mse"):
            out[k[:-3] + "rmse"] = float(np.sqrt(np.mean(v)))
        elif k.startswith("err"):
            out[k + "_mean"] = float(np.mean(v))
            out[k + "_rmse"] = float(np.sqrt(np.mean(v**2)))
        else:
            out[k] = float(np.mean(v))
    return out


class ModelnetTester:
    """Estimates each pair's transform with ``register_pair`` (top-450
    sampling, RANSAC n = 3 at 0.02; reference tester.py:389-407) and
    reports the DCP / RPMNet metric summary.  Runs on ``device``: CUDA
    unless the caller names the CPU; the model must live there."""

    def __init__(self, cfg: Config, model, device=None):
        self.cfg = cfg
        self.model = model
        self.device = resolve_device(device)

    def run(self, loader, n_points: int = 450, generator: Optional[torch.Generator] = None,
            num_iterations: int = 50000, hypothesis_chunk: int = 1024) -> Dict[str, float]:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        preds, gts, srcs, refs, raws = [], [], [], [], []
        for batch, images in loader:
            # The clean full cloud threaded through the batch (reference
            # tester.py:260 'points_raw'): the model-input ref cloud is not
            # the protocol's cloud for the modified chamfer.
            if batch.extras is None or "points_raw" not in batch.extras:
                raise KeyError(
                    "ModelNet chamfer needs batch.extras['points_raw'] — "
                    "ensure the dataset emits it (data/modelnet.py)"
                )
            host = batch.map(torch.Tensor.cpu)
            batch, images = to_device(batch, images, self.device)
            for b in range(batch.points.shape[0]):
                res = register_pair(
                    self.model, self.cfg, batch.points[b], batch.masks[b], batch.features[b],
                    generator, n_points=n_points, distance_threshold=0.02, ransac_n=3,
                    num_iterations=num_iterations, hypothesis_chunk=hypothesis_chunk,
                    device=self.device,
                )
                preds.append(res["transform"].cpu().numpy())
                gts.append(np.concatenate([host.rot[b].numpy(), host.trans[b].numpy()[:, None]],
                                          1))
                m0, m1 = host.masks[b].numpy()
                srcs.append(host.points[b][0].numpy()[m0])
                refs.append(host.points[b][1].numpy()[m1])
                raws.append(host.extras["points_raw"][b].numpy())
        n = min(len(p) for p in srcs)
        m = min(len(p) for p in refs)
        metrics = compute_metrics(
            np.stack([p[:n] for p in srcs]),
            np.stack([p[:m] for p in refs]),
            np.stack(raws),  # fixed-size clean clouds, no crop needed
            np.stack(gts),
            np.stack(preds),
        )
        summary = summarize_metrics(metrics)
        summary["n_pairs"] = len(preds)
        print(summary, flush=True)
        return summary
