"""Where the time of one pair, or of one training step, goes on the card.

    python -m pcrcg_tpu_torch.profile [--pairs 5] [--route untiled] [--out profile.json]
    python -m pcrcg_tpu_torch.profile --train [--pairs 3] [--out train.json]
    python -m pcrcg_tpu_torch.profile --images [--train] [--out images.json]

Drives the in-repo assets pair at the default ``Config()`` (full width,
seeded random weights) on the KPConv route ``--route`` names (``tiled``,
the default; ``untiled``: ``kpconv_tiled: false``; ``reduce``:
``kpconv_impl: reduce``, serving only); with ``--images``, the color model
of ``configs/train/indoor.yaml`` (``PCRCG``: ResNet-50 UNet, 2 images a
cloud, in_feats_dim 129, the same widths and budgets) on 240×320 renders
of the pair (``assets.py::render_pair_images``).  It reports, per pair
(per step with ``--train``):

* host-clock time of each stage, each ending in ``torch.cuda.synchronize()``
  — serving: pyramid, [backbone + lift,] KPFCNN forward, sampling +
  matching, RANSAC; ``--train`` (``train_step``'s stages, batch 1, the pair
  under its ground-truth pose): pyramid, [backbone + lift,] forward, loss,
  backward, optimizer.  The syncs add their own stalls, so the stages sum
  to more than an unsynchronized pair or step;
* the unsynchronized pair (step) time;
* device time by kernel name from ``torch.profiler`` over the same pairs
  (steps), and the device's busy share of the profiled wall time;
* with ``--images``, the device time of the backbone + lift alone (a
  profile of that call by itself) and its share of the pair's (step's).

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
from pcrcg_tpu_torch.assets import (
    REPO_ROOT,
    demo_cloud_pair,
    demo_pair_gt_pose,
    render_pair_images,
)
from pcrcg_tpu_torch.config import Config, load_config
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.eval.tester import register_pair
from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
from pcrcg_tpu_torch.models.lift import IMAGE_KEYS, images_to
from pcrcg_tpu_torch.models.pcrcg import init_pcrcg
from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
from pcrcg_tpu_torch.registration.ransac import feature_correspondences, ransac_pose
from pcrcg_tpu_torch.registration.sampling import weighted_sample_topk
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import loss_from_outputs, train_step


# The KPConv routes (the Config fields that select them).
ROUTES = {"tiled": {}, "untiled": dict(kpconv_tiled=False), "reduce": dict(kpconv_impl="reduce")}
IMAGE_CONFIG = REPO_ROOT / "configs" / "train" / "indoor.yaml"


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


def _lift(model, pyramid, images):
    """The color model's backbone + lift: its point features."""
    return model.lift(pyramid.points[0], pyramid.masks[0], *(images[k] for k in IMAGE_KEYS))


def _serving_stages(model, cfg, points, masks, features, images, gen, marks):
    pyramid = build_pyramid_cfg(cfg, points, masks)
    marks.mark("pyramid")
    if images is None:
        res = model(pyramid, features)
    else:
        feats = _lift(model, pyramid, images)
        marks.mark("backbone_lift")
        res = model.kpfcnn(pyramid, feats)
    marks.mark("kpfcnn")
    scores = res["scores_overlap"] * res["scores_saliency"]
    si, so = weighted_sample_topk(scores[0], masks[0], 5000, gen)
    ti, to = weighted_sample_topk(scores[1], masks[1], 5000, gen)
    corr, valid = feature_correspondences(res["feats_f"][0][si], res["feats_f"][1][ti], so, to)
    marks.mark("sample_match")
    ransac_pose(points[0][si], points[1][ti], corr, valid, num_iterations=50000,
                hypothesis_chunk=1024, generator=gen)
    marks.mark("ransac")


def _train_stages(state, cfg, batch, images, gen, marks):
    """``train_step``'s work for batch 1, split at its stages."""
    points, masks, features = batch.points[0], batch.masks[0], batch.features[0]
    state.zero_grad()
    with torch.enable_grad():
        pyramid = build_pyramid_cfg(cfg, points, masks)
        marks.mark("pyramid")
        if images is None:
            out = state.model(pyramid, features)
        else:
            feats = _lift(state.model, pyramid, images)
            marks.mark("backbone_lift")
            out = state.model.kpfcnn(pyramid, feats)
        marks.mark("forward")
        stats = loss_from_outputs(cfg, out, pyramid, points, masks, batch.rot[0],
                                  batch.trans[0], generator=gen)
        marks.mark("loss")
        stats["total"].backward()
        marks.mark("backward")
    state.apply_gradients()
    marks.mark("optimizer")


def _device_profile(run, count):
    """Device time by kernel over ``count`` calls of ``run``, per call, and
    the host's kernel launches and stream syncs (count and host ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = {}
    api = {"cudaLaunchKernel": [0, 0.0], "cudaStreamSynchronize": [0, 0.0]}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.device_time_total
        elif ev.name in api:
            api[ev.name][0] += 1
            api[ev.name][1] += ev.cpu_time_total
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]
    return {
        "profiled_wall_ms": wall_us / count / 1e3,
        "device_busy_ms": busy_us / count / 1e3,
        "device_busy_share": busy_us / wall_us,
        "launches": api["cudaLaunchKernel"][0] / count,
        "launch_host_ms": api["cudaLaunchKernel"][1] / count / 1e3,
        "syncs": api["cudaStreamSynchronize"][0] / count,
        "sync_wait_ms": api["cudaStreamSynchronize"][1] / count / 1e3,
        "top_kernels_ms": [(name[:120], us / count / 1e3) for name, us in top],
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pairs", type=int, default=5, help="pairs (steps) per measurement")
    parser.add_argument("--train", action="store_true", help="profile train_step instead")
    parser.add_argument("--route", choices=sorted(ROUTES), default="tiled",
                        help="the KPConv route")
    parser.add_argument("--images", action="store_true",
                        help=f"the color model of {IMAGE_CONFIG.relative_to(REPO_ROOT)}")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    kernels.build_all()
    torch.set_grad_enabled(False)

    cfg = (load_config(str(IMAGE_CONFIG)) if args.images else Config()).replace(
        **ROUTES[args.route])
    src, tgt = demo_cloud_pair()
    rot, trans = demo_pair_gt_pose()
    sample = dict(src_pcd=src, tgt_pcd=tgt, rot=rot, trans=trans)
    batch = make_pair_batch([sample], cfg.budgets.points[0], in_feats_dim=cfg.in_feats_dim,
                            device=device)
    images = None
    if args.images:
        images = images_to(render_pair_images(src, tgt, cfg.img_num, pose=(rot, trans)), device)
    batched = None if images is None else {k: v[None] for k, v in images.items()}
    init = init_pcrcg if args.images else init_kpfcnn
    gen = torch.Generator(device=device).manual_seed(0)
    if args.train:
        state = TrainState(cfg, init(cfg, seed=0, device=device))
        model = state.model

        def run():
            train_step(state, cfg, batch, generator=gen, images=batched)

        def stages(marks):
            _train_stages(state, cfg, batch, images, gen, marks)
    else:
        model = init(cfg, seed=0, device=device)
        inputs = (batch.points[0], batch.masks[0], batch.features[0])

        def run():
            register_pair(model, cfg, *inputs, gen, images=images)

        def stages(marks):
            _serving_stages(model, cfg, *inputs, images, gen, marks)

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
    lift = {}
    if images is not None:
        pyramid = build_pyramid_cfg(cfg, batch.points[0], batch.masks[0])
        alone = _device_profile(lambda: _lift(model, pyramid, images), args.pairs)
        lift = {"backbone_lift_device_busy_ms": alone["device_busy_ms"],
                "backbone_lift_share": alone["device_busy_ms"] / prof["device_busy_ms"],
                "backbone_lift_top_kernels_ms": alone["top_kernels_ms"][:10]}

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    unit = "step" if args.train else "pair"
    result = {
        "card": card,
        "what": "train_step (batch 1)" if args.train else "register_pair",
        "model": f"PCRCG ({IMAGE_CONFIG.name}, ResNet-{cfg.backbone2d_depth} UNet, "
                 f"{cfg.img_num} images a cloud)" if args.images else "KPFCNN (Config())",
        "route": args.route,
        f"{unit}s": args.pairs,
        f"{unit}_ms": unit_ms,
        "stage_ms_synced": {k: v / args.pairs * 1e3 for k, v in marks.seconds.items()},
        **{f"{k}_per_{unit}" if k != "device_busy_share" else k: v for k, v in prof.items()},
        **lift,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
