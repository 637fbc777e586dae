"""Demo: register the in-repo fragment pair end to end.

    python -m pcrcg_tpu_torch.demo [--config configs/test/indoor.yaml]
        [--n_points 5000] [--seed 0] [--device cuda|cpu] [--scale 1.0]

Runs on CUDA unless ``--device cpu`` is given (and refuses to run without
CUDA otherwise).  The weights are seeded random: no trained KPFCNN
checkpoint is in the repository, so the transform shows the path runs, not
registration accuracy.  ``--scale 0.1`` shrinks the point and RANSAC
budgets for a quick CPU run.  Prints the transform, RANSAC fitness/rmse
and the time of a first and a second call.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pcrcg_tpu_torch import resolve_device
from pcrcg_tpu_torch.assets import demo_cloud_pair
from pcrcg_tpu_torch.config import Budgets, Config, load_config
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.eval.tester import register_pair
from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="")
    parser.add_argument("--n_points", type=int, default=5000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="shrink the point/RANSAC budgets (e.g. 0.1 for a CPU run)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args.config) if args.config else Config()
    # The demo pair has no image stack: the geometry-only path.
    cfg = cfg.replace(image_feature=False, in_feats_dim=1)
    n_points, iters = args.n_points, 50000
    if args.scale != 1.0:
        b = cfg.budgets
        cfg = cfg.replace(budgets=Budgets(
            points=tuple(max(128, int(p * args.scale)) // 64 * 64 for p in b.points),
            neighbors=b.neighbors, corr_k=b.corr_k, query_chunk=min(b.query_chunk, 256),
        ))
        n_points = min(n_points, cfg.budgets.points[0] // 2)
        iters = max(256, int(iters * args.scale))

    src, tgt = demo_cloud_pair()
    print(f"src {src.shape} tgt {tgt.shape} on {device}", flush=True)
    batch = make_pair_batch(
        [dict(src_pcd=src, tgt_pcd=tgt, rot=np.eye(3), trans=np.zeros(3))],
        cfg.budgets.points[0], device=device,
    )
    model = init_kpfcnn(cfg, seed=args.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    kw = dict(n_points=n_points, num_iterations=iters,
              hypothesis_chunk=min(1024, iters), generator=gen)
    for label in ("first call", "second call"):
        t0 = time.perf_counter()
        res = register_pair(model, cfg, batch.points[0], batch.masks[0],
                            batch.features[0], device=device, **kw)
        _sync(device)
        print(f"{label}: {time.perf_counter() - t0:.3f}s", flush=True)
    print("estimated transform (src -> tgt):")
    print(res["transform"].cpu().numpy())
    print(f"fitness {float(res['fitness']):.4f}  inlier_rmse {float(res['inlier_rmse']):.4f}")


if __name__ == "__main__":
    main()
