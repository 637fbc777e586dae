"""Budget calibration: choose static per-level point budgets and neighbor
caps from data (counterpart of ``pcrcg_tpu/data/calibrate.py``, over the
port's ``native.py``).

Capability parity with the reference's ``calibrate_neighbors``
(datasets/dataloader.py:402-434): it histograms per-level neighborhood
sizes over sample batches and keeps the 80th-percentile cap
(keep_ratio=0.8, samples_threshold=2000), over the conv neighbor lists of
the collation, which searches a deformable level at the widened radius
r·deform_radius/conv_radius (datasets/dataloader.py:266-299).  Here the
same statistic — plus per-level voxel-occupancy maxima for the point
budgets — is computed once offline with the native host kernels, and the
result is written into the config's ``tpu.budgets`` section instead of
being recomputed every run.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from pcrcg_tpu_torch import native
from pcrcg_tpu_torch.config import Budgets, Config


def _round_up(n: int, multiple: int = 128) -> int:
    return int(-(-n // multiple) * multiple)


def calibrate_budgets(
    dataset,
    config: Config,
    num_samples: int = 100,
    keep_ratio: float = 0.8,
    headroom: float = 1.05,
    samples_threshold: int = 2000,
) -> Budgets:
    """Runs the pyramid schedule (radius doubling, dl = 2r/conv_radius —
    dataloader.py:239,286,357) on ``num_samples`` samples with the native
    kernels and returns calibrated Budgets.  A level whose conv search
    ``config.deform_level_flags()`` widens is counted at the widened
    radius, as the collation lists it."""
    num_levels = len(config.budgets.points)
    deform_conv = config.deform_level_flags()[0]
    deform_scale = config.deform_radius / config.conv_radius
    max_pts = [0] * num_levels
    counts_hist: List[List[int]] = [[] for _ in range(num_levels)]

    n_seen = 0
    for idx in range(min(num_samples, len(dataset))):
        sample = dataset[idx]
        for cloud_key in ("src_pcd", "tgt_pcd"):
            pts = np.asarray(sample[cloud_key], np.float32)
            r = config.first_subsampling_dl * config.conv_radius
            level_pts = pts
            for lvl in range(num_levels):
                max_pts[lvl] = max(max_pts[lvl], level_pts.shape[0])
                if len(counts_hist[lvl]) < samples_threshold:
                    r_conv = r * deform_scale if deform_conv[lvl] else r
                    counts = native.radius_count(level_pts, level_pts, r_conv)
                    counts_hist[lvl].extend(counts.tolist())
                if lvl + 1 < num_levels:
                    dl = 2.0 * r / config.conv_radius
                    level_pts = native.grid_subsample(level_pts, dl)
                r *= 2.0
        n_seen += 1
        if all(len(h) >= samples_threshold for h in counts_hist) and n_seen >= 10:
            break

    neighbor_caps = tuple(
        int(np.quantile(np.asarray(h), keep_ratio)) if h else config.budgets.neighbors[i]
        for i, h in enumerate(counts_hist)
    )
    point_budgets = tuple(_round_up(int(m * headroom)) for m in max_pts)
    return Budgets(
        points=point_budgets,
        neighbors=tuple(max(c, 8) for c in neighbor_caps),
        corr_k=config.budgets.corr_k,
        query_chunk=config.budgets.query_chunk,
    )


def occupancy_report(dataset, config: Config, num_samples: int = 20) -> Dict[str, list]:
    """Per-level real-point occupancy vs the configured budgets — a quick
    check that budgets neither truncate nor waste."""
    num_levels = len(config.budgets.points)
    occ: List[List[int]] = [[] for _ in range(num_levels)]
    for idx in range(min(num_samples, len(dataset))):
        sample = dataset[idx]
        for cloud_key in ("src_pcd", "tgt_pcd"):
            pts = np.asarray(sample[cloud_key], np.float32)
            r = config.first_subsampling_dl * config.conv_radius
            level_pts = pts
            for lvl in range(num_levels):
                occ[lvl].append(level_pts.shape[0])
                if lvl + 1 < num_levels:
                    level_pts = native.grid_subsample(level_pts, 2.0 * r / config.conv_radius)
                r *= 2.0
    return {
        "max": [max(o) for o in occ],
        "mean": [float(np.mean(o)) for o in occ],
        "budget": list(config.budgets.points),
        "truncating": [max(o) > b for o, b in zip(occ, config.budgets.points)],
    }
