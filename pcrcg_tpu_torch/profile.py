"""Where the time of one pair goes on the card.

    python -m pcrcg_tpu_torch.profile [--pairs 5] [--out profile.json]

Registers the in-repo assets pair at the default ``Config()`` (full width,
seeded random weights) and reports, per pair:

* host-clock time of each stage, each ending in ``torch.cuda.synchronize()``
  (pyramid, KPFCNN forward, sampling + matching, RANSAC) — the syncs add
  their own stalls, so the stages sum to more than an unsynchronized pair;
* the unsynchronized pair time;
* device time by kernel name from ``torch.profiler`` over the same pairs,
  and the device's busy share of the profiled wall time.

Needs CUDA.  Prints a JSON object and writes it to ``--out`` if given.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from pcrcg_tpu_torch import kernels, resolve_device
from pcrcg_tpu_torch.assets import demo_cloud_pair
from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.eval.tester import register_pair
from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
from pcrcg_tpu_torch.registration.ransac import feature_correspondences, ransac_pose
from pcrcg_tpu_torch.registration.sampling import weighted_sample_topk


def _stages(model, cfg, points, masks, features, gen):
    """One pair with a sync after each stage: seconds per stage."""
    out = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = now - t
        t = now

    pyramid = build_pyramid_cfg(cfg, points, masks)
    mark("pyramid")
    res = model(pyramid, features)
    mark("kpfcnn")
    scores = res["scores_overlap"] * res["scores_saliency"]
    si, so = weighted_sample_topk(scores[0], masks[0], 5000, gen)
    ti, to = weighted_sample_topk(scores[1], masks[1], 5000, gen)
    corr, valid = feature_correspondences(res["feats_f"][0][si], res["feats_f"][1][ti], so, to)
    mark("sample_match")
    ransac_pose(points[0][si], points[1][ti], corr, valid, num_iterations=50000,
                hypothesis_chunk=1024, generator=gen)
    mark("ransac")
    return out


@torch.no_grad()
def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pairs", type=int, default=5)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    kernels.build_all()

    cfg = Config()
    src, tgt = demo_cloud_pair()
    batch = make_pair_batch([dict(src_pcd=src, tgt_pcd=tgt, rot=np.eye(3), trans=np.zeros(3))],
                            cfg.budgets.points[0], device=device)
    model = init_kpfcnn(cfg, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    inputs = (batch.points[0], batch.masks[0], batch.features[0])
    register_pair(model, cfg, *inputs, gen)  # warm-up
    torch.cuda.synchronize()

    stage_sums = {}
    for _ in range(args.pairs):
        for k, v in _stages(model, cfg, *inputs, gen).items():
            stage_sums[k] = stage_sums.get(k, 0.0) + v
    t0 = time.perf_counter()
    for _ in range(args.pairs):
        register_pair(model, cfg, *inputs, gen)
    torch.cuda.synchronize()
    pair_ms = (time.perf_counter() - t0) / args.pairs * 1e3

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.pairs):
            register_pair(model, cfg, *inputs, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.device_time_total
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    result = {
        "card": card,
        "pairs": args.pairs,
        "pair_ms": pair_ms,
        "stage_ms_synced": {k: v / args.pairs * 1e3 for k, v in stage_sums.items()},
        "profiled_wall_ms_per_pair": wall_us / args.pairs / 1e3,
        "device_busy_ms_per_pair": busy_us / args.pairs / 1e3,
        "device_busy_share": busy_us / wall_us,
        "top_kernels_ms_per_pair": [(name[:120], us / args.pairs / 1e3) for name, us in top],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
