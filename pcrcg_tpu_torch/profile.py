"""Where the time of one pair, or of one training step, goes on the card.

    python -m pcrcg_tpu_torch.profile [--pairs 5] [--out profile.json]
    python -m pcrcg_tpu_torch.profile --train [--pairs 3] [--out train.json]

Drives the in-repo assets pair at the default ``Config()`` (full width,
seeded random weights) and reports, per pair (per step with ``--train``):

* host-clock time of each stage, each ending in ``torch.cuda.synchronize()``
  — serving: pyramid, KPFCNN forward, sampling + matching, RANSAC;
  ``--train`` (``train_step``'s stages, batch 1, the pair under its
  ground-truth pose): pyramid, forward, loss, backward, optimizer.  The
  syncs add their own stalls, so the stages sum to more than an
  unsynchronized pair or step;
* the unsynchronized pair (step) time;
* device time by kernel name from ``torch.profiler`` over the same pairs
  (steps), and the device's busy share of the profiled wall time.

Needs CUDA.  Prints a JSON object and writes it to ``--out`` if given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from pcrcg_tpu_torch import kernels, resolve_device
from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose
from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.eval.tester import register_pair
from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
from pcrcg_tpu_torch.registration.ransac import feature_correspondences, ransac_pose
from pcrcg_tpu_torch.registration.sampling import weighted_sample_topk
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import loss_from_outputs, train_step


class _Marks:
    """Host seconds between ``mark`` calls, each after a device sync."""

    def __init__(self):
        self.seconds = {}
        self.t = time.perf_counter()

    def mark(self, name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        self.t = now


def _serving_stages(model, cfg, points, masks, features, gen, marks):
    pyramid = build_pyramid_cfg(cfg, points, masks)
    marks.mark("pyramid")
    res = model(pyramid, features)
    marks.mark("kpfcnn")
    scores = res["scores_overlap"] * res["scores_saliency"]
    si, so = weighted_sample_topk(scores[0], masks[0], 5000, gen)
    ti, to = weighted_sample_topk(scores[1], masks[1], 5000, gen)
    corr, valid = feature_correspondences(res["feats_f"][0][si], res["feats_f"][1][ti], so, to)
    marks.mark("sample_match")
    ransac_pose(points[0][si], points[1][ti], corr, valid, num_iterations=50000,
                hypothesis_chunk=1024, generator=gen)
    marks.mark("ransac")


def _train_stages(state, cfg, batch, gen, marks):
    """``train_step``'s work for batch 1, split at its stages."""
    points, masks, features = batch.points[0], batch.masks[0], batch.features[0]
    state.zero_grad()
    with torch.enable_grad():
        pyramid = build_pyramid_cfg(cfg, points, masks)
        marks.mark("pyramid")
        out = state.model(pyramid, features)
        marks.mark("forward")
        stats = loss_from_outputs(cfg, out, pyramid, points, masks, batch.rot[0],
                                  batch.trans[0], generator=gen)
        marks.mark("loss")
        stats["total"].backward()
        marks.mark("backward")
    state.apply_gradients()
    marks.mark("optimizer")


def _device_profile(run, count):
    """Device time by kernel over ``count`` calls of ``run``, per call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.device_time_total
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]
    return {
        "profiled_wall_ms": wall_us / count / 1e3,
        "device_busy_ms": busy_us / count / 1e3,
        "device_busy_share": busy_us / wall_us,
        "top_kernels_ms": [(name[:120], us / count / 1e3) for name, us in top],
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pairs", type=int, default=5, help="pairs (steps) per measurement")
    parser.add_argument("--train", action="store_true", help="profile train_step instead")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    kernels.build_all()
    torch.set_grad_enabled(False)

    cfg = Config()
    src, tgt = demo_cloud_pair()
    rot, trans = demo_pair_gt_pose()
    sample = dict(src_pcd=src, tgt_pcd=tgt, rot=rot, trans=trans)
    batch = make_pair_batch([sample], cfg.budgets.points[0], device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    if args.train:
        state = TrainState(cfg, init_kpfcnn(cfg, seed=0, device=device))

        def run():
            train_step(state, cfg, batch, generator=gen)

        def stages(marks):
            _train_stages(state, cfg, batch, gen, marks)
    else:
        model = init_kpfcnn(cfg, seed=0, device=device)
        inputs = (batch.points[0], batch.masks[0], batch.features[0])

        def run():
            register_pair(model, cfg, *inputs, gen)

        def stages(marks):
            _serving_stages(model, cfg, *inputs, gen, marks)

    run()  # warm-up
    torch.cuda.synchronize()
    marks = _Marks()
    for _ in range(args.pairs):
        stages(marks)
    t0 = time.perf_counter()
    for _ in range(args.pairs):
        run()
    torch.cuda.synchronize()
    unit_ms = (time.perf_counter() - t0) / args.pairs * 1e3
    torch.cuda.reset_peak_memory_stats()
    prof = _device_profile(run, args.pairs)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    unit = "step" if args.train else "pair"
    result = {
        "card": card,
        "what": "train_step (batch 1)" if args.train else "register_pair",
        f"{unit}s": args.pairs,
        f"{unit}_ms": unit_ms,
        "stage_ms_synced": {k: v / args.pairs * 1e3 for k, v in marks.seconds.items()},
        **{f"{k}_per_{unit}" if k != "device_busy_share" else k: v for k, v in prof.items()},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
