"""3DMatch / 3DLoMatch registration-recall protocol (offline, numpy): a
copy of ``pcrcg_tpu/eval/benchmark_3dmatch.py``.

Capability parity with reference lib/benchmark.py:60-337: gt.log/gt.info
trajectory parsing (Redwood format), covariance-weighted transformation
error p = erᵀ·info·er / info[0,0] with er = [Δt, Δq_xyz], success at
p ≤ 0.2², non-consecutive pairs only (|i−j| > 1), per-scene
precision/recall + RRE/RTE statistics and pair-count-weighted means.
The reference gt files (configs/benchmarks/{3DMatch,3DLoMatch}) are read
verbatim.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

SHORT_NAMES = [
    "Kitchen", "Home 1", "Home 2", "Hotel 1", "Hotel 2", "Hotel 3", "Study", "MIT Lab",
]

# Canonical 3DMatch/3DLoMatch benchmark scene directories -> display names
# (reference lib/benchmark.py:280 walks the gt folder; the 8-scene short
# names are the paper's table labels).  Non-canonical gt folders keep
# their directory name so per_scene keys always identify the right scene.
CANONICAL_NAMES = {
    "7-scenes-redkitchen": "Kitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1": "Home 1",
    "sun3d-home_md-home_md_scan9_2012_sep_30": "Home 2",
    "sun3d-hotel_uc-scan3": "Hotel 1",
    "sun3d-hotel_umd-maryland_hotel1": "Hotel 2",
    "sun3d-hotel_umd-maryland_hotel3": "Hotel 3",
    "sun3d-mit_76_studyroom-76-1studyroom2": "Study",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika": "MIT Lab",
}


def mat2quat(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w,x,y,z); branch-free accumulation
    (same convention as nibabel.quaternions.mat2quat used at
    reference lib/benchmark.py:52-74)."""
    m = np.asarray(r, dtype=np.float64)
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def transformation_error(trans: np.ndarray, info: np.ndarray) -> float:
    """Covariance-weighted squared error (reference benchmark.py:52-74)."""
    t = trans[:3, 3]
    q = mat2quat(trans[:3, :3])
    er = np.concatenate([t, q[1:]], axis=0)
    return float(er.reshape(1, 6) @ info @ er.reshape(6, 1) / info[0, 0])


def read_trajectory(filename: str, dim: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Redwood .log: per pair a '<i>\\t<j>\\t<n>' header + dim rows of the
    4×4 matrix (reference benchmark.py:76-110)."""
    with open(filename) as f:
        lines = [ln for ln in f.readlines() if ln.strip()]
    keys, traj = [], []
    for i in range(0, len(lines), dim + 1):
        keys.append([tok.strip() for tok in lines[i].replace("\t", " ").split()[:3]])
        for row in lines[i + 1 : i + 1 + dim]:
            traj.append([float(v) for v in row.replace("\t", " ").split()[:dim]])
    return np.asarray(keys), np.asarray(traj, dtype=np.float64).reshape(-1, dim, dim)


def read_trajectory_info(filename: str, dim: int = 6) -> Tuple[int, np.ndarray]:
    """Redwood .info: per pair a header + 6 rows of the 6×6 information
    matrix (reference benchmark.py:113-144)."""
    with open(filename) as f:
        contents = [ln for ln in f.readlines() if ln.strip()]
    n_pairs = len(contents) // 7
    assert len(contents) == 7 * n_pairs, filename
    infos, n_frame = [], 0
    for i in range(n_pairs):
        n_frame = int(contents[i * 7].strip().split()[2])
        rows = [np.fromstring(contents[i * 7 + 1 + r], sep="\t") for r in range(6)]
        infos.append(np.stack(rows))
    return n_frame, np.asarray(infos, dtype=np.float64).reshape(-1, dim, dim)


def write_trajectory(filename: str, pairs: np.ndarray, transforms: np.ndarray, n_fragments: int):
    """Write est.log in Redwood format (reference benchmark_utils.py:57-73)."""
    os.makedirs(os.path.dirname(filename), exist_ok=True)
    with open(filename, "w") as f:
        for (i, j), T in zip(pairs, transforms):
            f.write(f"{int(i)}\t{int(j)}\t{n_fragments}\n")
            for row in np.asarray(T).reshape(4, 4):
                f.write("\t".join(f"{v:.8f}" for v in row) + "\n")


def rotation_error_deg(r_est: np.ndarray, r_gt: np.ndarray) -> np.ndarray:
    tr = np.einsum("nij,nij->n", r_est, r_gt)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def evaluate_registration(
    num_fragment, result, result_pairs, gt_pairs, gt, gt_info, err2: float = 0.2
):
    """Per-scene precision/recall with flags (reference benchmark.py:213-269).
    flags: 0 correct, 1 wrong, 2 not-in-gt (consecutive or >30%-overlap
    filtered)."""
    err2 = err2**2
    gt_mask = np.zeros((num_fragment, num_fragment), dtype=np.int64)
    for idx in range(gt_pairs.shape[0]):
        i, j = int(gt_pairs[idx, 0]), int(gt_pairs[idx, 1])
        if j - i > 1:
            gt_mask[i, j] = idx
    n_gt = int(np.sum(gt_mask > 0))

    good, n_res, flags = 0, 0, []
    for idx in range(result_pairs.shape[0]):
        i, j = int(result_pairs[idx, 0]), int(result_pairs[idx, 1])
        if gt_mask[i, j] > 0:
            n_res += 1
            gt_idx = gt_mask[i, j]
            p = transformation_error(np.linalg.inv(gt[gt_idx]) @ result[idx], gt_info[gt_idx])
            if p <= err2:
                good += 1
                flags.append(0)
            else:
                flags.append(1)
        else:
            flags.append(2)
    precision = good / n_res if n_res else 0.0
    recall = good / n_gt if n_gt else 0.0
    return precision, recall, flags


@dataclass
class BenchmarkResult:
    per_scene: Dict[str, Dict[str, float]] = field(default_factory=dict)
    mean_precision: float = 0.0
    mean_recall: float = 0.0
    weighted_precision: float = 0.0
    weighted_recall: float = 0.0
    mean_median_rre: float = 0.0
    mean_median_rte: float = 0.0

    def summary(self) -> str:
        lines = ["Scene | prec. | rec. | med RRE | med RTE | pairs"]
        for name, s in self.per_scene.items():
            lines.append(
                f"{name} | {s['precision']:.3f} | {s['recall']:.3f} | "
                f"{s['median_rre']:.3f} | {s['median_rte']:.3f} | {int(s['n_valid'])}"
            )
        lines.append(f"Weighted recall: {self.weighted_recall:.4f}")
        lines.append(f"Mean recall: {self.mean_recall:.4f}")
        lines.append(f"Mean median RRE: {self.mean_median_rre:.3f}")
        lines.append(f"Mean median RTE: {self.mean_median_rte:.3f}")
        return "\n".join(lines)


def get_scene_split(gt_folder: str):
    """Per-scene [start, end) pair-index ranges over the concatenated split
    (reference benchmark_utils.py:299-311)."""
    split, count = [], 0
    for scene in sorted(os.listdir(gt_folder)):
        pairs, _ = read_trajectory(os.path.join(gt_folder, scene, "gt.log"))
        split.append([count, count + len(pairs)])
        count += len(pairs)
    return split


def benchmark(est_folder: str, gt_folder: str) -> BenchmarkResult:
    """Aggregate over all scenes (reference benchmark.py:271-337): per-scene
    est.log under <est_folder>/<scene>/est.log vs gt under
    <gt_folder>/<scene>/gt.{log,info}."""
    scenes = sorted(os.listdir(gt_folder))
    out = BenchmarkResult()
    precisions, recalls, n_valids = [], [], []
    med_rre, med_rte = [], []

    for scene in scenes:
        gt_pairs, gt_traj = read_trajectory(os.path.join(gt_folder, scene, "gt.log"))
        n_valid = sum(abs(int(p[0]) - int(p[1])) > 1 for p in gt_pairs)
        n_fragments, gt_cov = read_trajectory_info(os.path.join(gt_folder, scene, "gt.info"))
        est_pairs, est_traj = read_trajectory(os.path.join(est_folder, scene, "est.log"))

        prec, rec, flags = evaluate_registration(
            n_fragments, est_traj, est_pairs, gt_pairs, gt_traj, gt_cov
        )
        # RRE/RTE over correctly-registered pairs only.
        gt_by_pair = {(int(p[0]), int(p[1])): k for k, p in enumerate(gt_pairs)}
        sel = [k for k, fl in enumerate(flags) if fl == 0]
        rre = rte = np.array([np.nan])
        if sel:
            gt_sel = np.stack(
                [gt_traj[gt_by_pair[(int(est_pairs[k][0]), int(est_pairs[k][1]))]] for k in sel]
            )
            est_sel = est_traj[sel]
            rre = rotation_error_deg(est_sel[:, :3, :3], gt_sel[:, :3, :3])
            rte = np.linalg.norm(est_sel[:, :3, 3] - gt_sel[:, :3, 3], axis=-1)

        name = CANONICAL_NAMES.get(scene, scene)
        out.per_scene[name] = dict(
            precision=prec,
            recall=rec,
            median_rre=float(np.median(rre)),
            median_rte=float(np.median(rte)),
            n_valid=n_valid,
        )
        precisions.append(prec)
        recalls.append(rec)
        n_valids.append(n_valid)
        med_rre.append(float(np.median(rre)))
        med_rte.append(float(np.median(rte)))

    w = np.asarray(n_valids, dtype=np.float64)
    out.mean_precision = float(np.mean(precisions))
    out.mean_recall = float(np.mean(recalls))
    out.weighted_precision = float(np.sum(w * np.asarray(precisions)) / np.sum(w))
    out.weighted_recall = float(np.sum(w * np.asarray(recalls)) / np.sum(w))
    out.mean_median_rre = float(np.nanmean(med_rre))
    out.mean_median_rte = float(np.nanmean(med_rte))
    return out
