"""Accuracy evidence: train KPFCNN (or the color PCRCG) from scratch until
RANSAC recovers ground-truth transforms within the 3DMatch protocol
threshold.  The counterpart of ``scripts/train_synthetic_register.py``.

    python -m pcrcg_tpu_torch.accuracy [--steps 3000] [--eval-every 250]
        [--budget 26624] [--lr 0.005] [--optimizer SGD|Adam] [--images]
        [--out perf_runs/torch_accuracy_evidence.jsonl] [--device cuda|cpu]

Pairs are synthesized from the in-repo assets clouds (cloud_bin_21/34, real
indoor scan geometry): two overlapping half-space crops per sample, the
target crop moved by a random SE(3), plus the reference's augmentation
noise (datasets/indoor.py:151-168).  Success mirrors the benchmark oracle
(lib/benchmark.py:213-243): RMSE of the estimated against the GT transform
over the source points <= 0.2 m.  The held-out pairs and the pair pool
come from the same numpy seeds as the JAX script's (``12345 + 1000·i``;
``777000 + seed·10000 + i``), so both see the same pairs; the weights and
the loss's draws come from torch generators.

Writes a JSONL trajectory (events ``start`` / ``eval`` / ``train`` /
``final``, the JAX script's schema) to ``--out`` and prints it.  The
script's ``--search-exact`` and ``--recall-target`` are not here: the
port's tiled search is always exact, with no approximate top-k ladder to
select.  ``--save-params`` / ``--init-params`` hold a ``torch.save`` of
the model's state dict.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from pcrcg_tpu_torch import resolve_device
from pcrcg_tpu_torch.assets import demo_cloud_pair, procedural_colors, render_views
from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.eval.tester import register_pair
from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
from pcrcg_tpu_torch.models.pcrcg import init_pcrcg
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import train_step


def random_rotation(rng, max_deg: float = 45.0) -> np.ndarray:
    """Random-axis rotation with angle uniform in [0, max_deg]."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(rng.uniform(0.0, max_deg))
    kx, ky, kz = axis
    k_mat = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    rot = np.eye(3) + np.sin(angle) * k_mat + (1 - np.cos(angle)) * (k_mat @ k_mat)
    return rot.astype(np.float32)


def make_synthetic_pair(cloud: np.ndarray, rng, noise: float = 0.005,
                        max_rot_deg: float = 45.0, resample_frac: float = 1.0):
    """Two overlapping half-space crops of ``cloud``; the tgt crop is moved
    by a random SE(3).  GT satisfies rot @ src + trans = tgt.

    ``resample_frac < 1`` subsamples each crop independently, so overlap
    points are no longer 1:1 identical (two scans of one surface).
    Returns (src, tgt, rot, trans, src0, tgt0): src0 / tgt0 are the crops
    in the original cloud frame, where procedural colors agree."""
    center = cloud.mean(0)
    normal = rng.normal(size=3)
    normal /= np.linalg.norm(normal)
    d = (cloud - center) @ normal
    band = 0.35 * d.std()
    src = cloud[d > -band]
    tgt0 = cloud[d < band]
    if resample_frac < 1.0:
        ks = max(int(len(src) * resample_frac), 1)
        kt = max(int(len(tgt0) * resample_frac), 1)
        src = src[rng.permutation(len(src))[:ks]]
        tgt0 = tgt0[rng.permutation(len(tgt0))[:kt]]
    rot = random_rotation(rng, max_rot_deg)
    trans = rng.uniform(-1.0, 1.0, 3).astype(np.float32)
    src0 = src
    tgt = tgt0 @ rot.T + trans
    src = src + rng.normal(scale=noise, size=src.shape)
    tgt = tgt + rng.normal(scale=noise, size=tgt.shape)
    return (src.astype(np.float32), tgt.astype(np.float32), rot, trans,
            src0.astype(np.float32), tgt0.astype(np.float32))


def synthetic_sample(clouds, rng, max_rot_deg: float = 45.0, resample_frac: float = 1.0):
    """One of ``clouds`` drawn by ``rng``, then ``make_synthetic_pair`` of it."""
    cloud = clouds[int(rng.integers(0, len(clouds)))]
    return make_synthetic_pair(cloud, rng, max_rot_deg=max_rot_deg,
                               resample_frac=resample_frac)


def protocol_rmse(t_est: np.ndarray, rot: np.ndarray, trans: np.ndarray,
                  src: np.ndarray) -> float:
    """RMSE between the estimated and GT transforms applied to the source
    points: the quantity the 3DMatch recall criterion thresholds at 0.2 m."""
    gt = src @ rot.T + trans
    est = src @ t_est[:3, :3].T + t_est[:3, 3]
    return float(np.sqrt(np.mean(np.sum((gt - est) ** 2, axis=1))))


def eval_overlaps(pairs, radius: float = 0.0375):
    """Per pair, the share of source points with a GT counterpart within
    ``radius`` (the reference's overlap_radius), rounded to 4 places."""
    from scipy.spatial import cKDTree

    out = []
    for src, tgt, rot, trans in pairs:
        d, _ = cKDTree((tgt - trans) @ rot).query(src, k=1)
        out.append(round(float((d < radius).mean()), 4))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--budget", type=int, default=26624)
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--optimizer", default="SGD", choices=["SGD", "Adam"])
    ap.add_argument("--out", default="perf_runs/torch_accuracy_evidence.jsonl")
    ap.add_argument("--n-eval", type=int, default=4)
    ap.add_argument("--n-points", type=int, default=5000)
    ap.add_argument("--max-rot-deg", type=float, default=45.0,
                    help="180 = full SO(3) relative poses")
    ap.add_argument("--resample-frac", type=float, default=1.0,
                    help="independently subsample each crop to this fraction")
    ap.add_argument("--seed", type=int, default=7, help="training-stream seed")
    ap.add_argument("--rot-curriculum", type=int, default=0, metavar="STEPS",
                    help="ramp the training rotation cap linearly from 30 degrees to "
                         "--max-rot-deg over this many steps (0 = off); held-out pairs "
                         "always use the full cap")
    ap.add_argument("--saliency-after", type=int, default=10**9,
                    help="enable the saliency loss after this step")
    ap.add_argument("--images", action="store_true",
                    help="train the color + geometry PCRCG on img_num renders per cloud")
    ap.add_argument("--img-size", type=int, nargs=2, default=(240, 320), metavar=("H", "W"))
    ap.add_argument("--decay-epochs", type=int, default=150,
                    help="spread this many x0.95 lr decays over the run")
    ap.add_argument("--save-params", default="",
                    help="torch.save the final model state dict to this file")
    ap.add_argument("--init-params", default="",
                    help="initialize the model from a --save-params file")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training: evaluate the held-out pairs once, emit a final event")
    ap.add_argument("--pair-pool", type=int, default=0,
                    help="pre-generate this many training samples and draw from them "
                         "(0 = a fresh sample per step)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, base: Optional[Config] = None) -> dict:
    """Run the evidence loop; returns the final eval record.  ``base`` is
    the Config the run's budgets and optimizer are laid over (default
    ``Config()``: the indoor widths)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    base = Config() if base is None else base
    b = args.budget
    budgets = dataclasses.replace(
        base.budgets, points=(b, b // 3 + 64, b // 10 + 64, b // 32 + 64))
    cfg = base.replace(budgets=budgets, lr=args.lr, w_saliency_loss=0.0,
                       optimizer=args.optimizer)
    if args.images:
        cfg = cfg.replace(image_feature=True, in_feats_dim=base.backbone2d_channels + 1)
    cfg_sal = cfg.replace(w_saliency_loss=1.0)
    clouds = list(demo_cloud_pair())
    rng = np.random.default_rng(args.seed)
    ih, iw = args.img_size

    def sample_batch(r, rot_cap=None):
        src, tgt, rot, trans, src0, tgt0 = synthetic_sample(
            clouds, r, rot_cap if rot_cap is not None else args.max_rot_deg, args.resample_frac)
        batch = make_pair_batch([dict(src_pcd=src, tgt_pcd=tgt, rot=rot, trans=trans)],
                                cfg.budgets.points[0], device=device)
        images = None
        if args.images:
            stacks = [render_views(pts, procedural_colors(orig), cfg.img_num, r,
                                   height=ih, width=iw)
                      for pts, orig in ((src, src0), (tgt, tgt0))]
            images = {
                "colors": np.stack([s[0] for s in stacks]),
                "depths": np.stack([s[1] for s in stacks]),
                "valid_maps": np.stack([s[2] for s in stacks]),
                "world2cam": np.stack([s[3] for s in stacks]),
                "intrinsics": stacks[0][4],
            }
            images = {k: torch.from_numpy(v).to(device) for k, v in images.items()}
        return batch, images, (src, tgt, rot, trans)

    # One generator per held-out pair, so --images (which draws more for
    # its renders) sees the same pair geometry.
    eval_pairs = [sample_batch(np.random.default_rng(12345 + 1000 * i))
                  for i in range(args.n_eval)]
    eval_overlap = eval_overlaps([p[2] for p in eval_pairs])

    if args.images:
        model = init_pcrcg(cfg, seed=cfg.seed, device=device)
    else:
        model = init_kpfcnn(cfg, seed=cfg.seed, device=device)
    if args.init_params:
        model.load_state_dict(torch.load(args.init_params, map_location=device,
                                         weights_only=True))
    # The reference's 150 per-epoch decays spread over this run.
    state = TrainState(cfg, model,
                       steps_per_epoch=max(1, args.steps // args.decay_epochs))

    def evaluate(step):
        rmses, fits = [], []
        for i, (batch, images, (src, tgt, rot, trans)) in enumerate(eval_pairs):
            gen = torch.Generator(device=device).manual_seed(1000 + i)
            res = register_pair(model, cfg, batch.points[0], batch.masks[0],
                                batch.features[0], gen, n_points=args.n_points,
                                images=images, device=device)
            t_est = res["transform"].double().cpu().numpy()
            rmses.append(protocol_rmse(t_est, rot, trans, src))
            fits.append(float(res["fitness"]))
        recall = float(np.mean([r <= 0.2 for r in rmses]))
        # 3DMatch counts >0.3-overlap pairs only (0.1-0.3 is 3DLoMatch).
        hi = [r for r, o in zip(rmses, eval_overlap) if o > 0.3]
        rec = dict(step=step, rmse=[round(r, 4) for r in rmses],
                   fitness=[round(f, 4) for f in fits], recall=recall)
        if hi:
            rec["recall_3dmatch"] = float(np.mean([r <= 0.2 for r in hi]))
        return rec

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    log = open(args.out, "a")

    def emit(rec):
        rec["t"] = round(time.time(), 1)
        log.write(json.dumps(rec) + "\n")
        log.flush()
        print(json.dumps(rec), flush=True)

    t_run = time.perf_counter()
    emit(dict(
        event="start", steps=args.steps, budget=args.budget, lr=args.lr,
        max_rot_deg=args.max_rot_deg, n_eval=args.n_eval,
        resample_frac=args.resample_frac, images=bool(args.images),
        optimizer=args.optimizer, pair_pool=args.pair_pool, seed=args.seed,
        eval_overlap=eval_overlap, device=str(device),
        device_name=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    ))
    if args.eval_only:
        final = evaluate(0)
        emit(dict(event="final", **final, wall_s=round(time.perf_counter() - t_run, 1)))
        log.close()
        return final

    emit(dict(event="eval", **evaluate(0)))

    def train_rot_cap(step):
        if not args.rot_curriculum:
            return args.max_rot_deg
        frac = min(1.0, step / args.rot_curriculum)
        return 30.0 + (args.max_rot_deg - 30.0) * frac

    pool = None
    if args.pair_pool:
        # With a curriculum the pool is in ascending difficulty and training
        # draws from the prefix allowed at the current step.  One generator
        # per entry, as for the held-out pairs.
        if args.rot_curriculum:
            caps = [30.0 + (args.max_rot_deg - 30.0) * i / max(args.pair_pool - 1, 1)
                    for i in range(args.pair_pool)]
        else:
            caps = [None] * args.pair_pool
        pool = [sample_batch(np.random.default_rng(777_000 + args.seed * 10_000 + i), cap)
                for i, cap in enumerate(caps)]

    gen = torch.Generator(device=device).manual_seed(999)
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        if pool is not None:
            if args.rot_curriculum:
                frac = min(1.0, step / args.rot_curriculum)
                hi = max(8, int(len(pool) * frac))
                batch, images, _ = pool[int(rng.integers(0, min(hi, len(pool))))]
            else:
                batch, images, _ = pool[int(rng.integers(0, len(pool)))]
        else:
            batch, images, _ = sample_batch(rng, train_rot_cap(step))
        step_cfg = cfg_sal if step >= args.saliency_after else cfg
        stats = train_step(state, step_cfg, batch, generator=gen,
                           images=None if images is None else {k: v[None]
                                                               for k, v in images.items()})
        if step % 50 == 0:
            emit(dict(
                event="train", step=step,
                total=round(float(stats["total"]), 4),
                circle=round(float(stats.get("circle_loss", float("nan"))), 4),
                recall=round(float(stats.get("recall", float("nan"))), 4),
                sec_per_step=round((time.perf_counter() - t0) / step, 3),
            ))
        if step % args.eval_every == 0:
            emit(dict(event="eval", **evaluate(step)))

    final = evaluate(args.steps)
    emit(dict(event="final", **final, wall_s=round(time.perf_counter() - t_run, 1)))
    log.close()
    if args.save_params:
        os.makedirs(os.path.dirname(os.path.abspath(args.save_params)), exist_ok=True)
        torch.save(model.state_dict(), args.save_params)
    ok = final["recall"] == 1.0
    print(f"ACCURACY EVIDENCE {'PASS' if ok else 'PARTIAL'}: "
          f"registration recall {final['recall']:.2f} at protocol RMSE<=0.2", flush=True)
    return final


if __name__ == "__main__":
    main()
