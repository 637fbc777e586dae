"""Where the time of one pair, or of one training step, goes on the card.

    python -m pcrcg_tpu_torch.profile [--pairs 5] [--route untiled|reduce|deformable|dense]
        [--out profile.json]
    python -m pcrcg_tpu_torch.profile --train [--pairs 3] [--out train.json]
    python -m pcrcg_tpu_torch.profile --images [--train] [--out images.json]

Drives the in-repo assets pair at the default ``Config()`` (full width,
seeded random weights) on the KPConv route ``--route`` names (``tiled``,
the default; ``untiled``: ``kpconv_tiled: false``; ``reduce``:
``kpconv_impl: reduce``, serving only; ``deformable``: ``deformable`` and
``modulated`` on; ``dense``: ``search_impl: dense``); with ``--images``, the color model
of ``configs/train/indoor.yaml`` (``PCRCG``: ResNet-50 UNet, 2 images a
cloud, in_feats_dim 129, the same widths and budgets) on 240×320 renders
of the pair (``assets.py::render_pair_images``).  It reports, per pair
(per step with ``--train``; ``train_step``, batch 1, the pair under its
ground-truth pose):

* the unsynchronized pair (step) time;
* from ``torch.profiler`` over the same pairs (steps): the device's busy
  time and its share of the profiled wall time, its kernels (whatever API
  launched them), device time by kernel name, and, for each ``pcrcg::``
  span of the entry (``utils/profiling.py``: serving
  ``pyramid``, [``backbone_lift``,] ``kpfcnn``, ``registration`` and their
  parts; ``--train``: ``pyramid``, ``forward``, ``loss``, ``backward``,
  ``optimizer``), its device ms, idle ms and kernels;
* the pyramid's counters over the profiled pairs (steps): real points,
  budget rows and dropped voxels by level, and with deformable blocks
  the ``deform.*`` neighbor counters by query level
  (``utils/profiling.py``).

Needs CUDA.  Prints a JSON object and writes it to ``--out`` if given.
"""
from __future__ import annotations

import argparse
import dataclasses
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
from pcrcg_tpu_torch.models.lift import images_to
from pcrcg_tpu_torch.models.pcrcg import init_pcrcg
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import train_step
from pcrcg_tpu_torch.utils import profiling


# The KPConv routes and model variants (the Config fields that select them).
ROUTES = {
    "tiled": lambda c: c,
    "untiled": lambda c: c.replace(kpconv_tiled=False),
    "reduce": lambda c: c.replace(kpconv_impl="reduce"),
    "deformable": lambda c: c.replace(deformable=True, modulated=True),
    "dense": lambda c: c.replace(budgets=dataclasses.replace(c.budgets, search_impl="dense")),
}
IMAGE_CONFIG = REPO_ROOT / "configs" / "train" / "indoor.yaml"


def _device_profile(run, count):
    """Over ``count`` calls of ``run`` under ``torch.profiler``, per call:
    the profiled wall ms, the device's busy ms (its operations' intervals
    merged) and share of that wall, its kernels (any launch API; copies and
    fills are not kernels), the host ms in kernel-launch calls, the stream
    syncs and their host ms, the top kernels by device ms, each
    ``pcrcg::`` span's device ms, idle ms and kernels (``stages``), and
    the pyramid's and the deformable convs' counters summed over the
    calls (``counters``)."""
    from torch.profiler import ProfilerActivity, profile

    profiling.clear_recorded()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    ops = profiling.device_operations(events)
    busy_us = sum(e - s for s, e in profiling.union((s, e) for s, e, _, _ in ops))
    by_kernel = {}
    for s, e, name, _ in ops:
        by_kernel[name] = by_kernel.get(name, 0.0) + e - s
    launch, sync = [0, 0.0], [0, 0.0]
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        host = launch if "LaunchKernel" in ev.name else (
            sync if ev.name == "cudaStreamSynchronize" else None)
        if host is not None:
            host[0] += 1
            host[1] += ev.cpu_time_total
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]
    return {
        "profiled_wall_ms": wall_us / count / 1e3,
        "device_busy_ms": busy_us / count / 1e3,
        "device_busy_share": busy_us / wall_us,
        "launches": sum(not profiling.is_copy(name) for _, _, name, _ in ops) / count,
        "launch_host_ms": launch[1] / count / 1e3,
        "syncs": sync[0] / count,
        "sync_wait_ms": sync[1] / count / 1e3,
        "top_kernels_ms": [(name[:120], us / count / 1e3) for name, us in top],
        "stages": profiling.stage_table(events, count),
        "counters": {k: v for k, v in profiling.counters(reset=True).items()
                     if k.startswith(("pyramid.", "deform."))},
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

    cfg = ROUTES[args.route](load_config(str(IMAGE_CONFIG)) if args.images else Config())
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

        def run():
            train_step(state, cfg, batch, generator=gen, images=batched)

    else:
        model = init(cfg, seed=0, device=device)
        inputs = (batch.points[0], batch.masks[0], batch.features[0])

        def run():
            register_pair(model, cfg, *inputs, gen, images=images)

    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.pairs):
        run()
    torch.cuda.synchronize()
    unit_ms = (time.perf_counter() - t0) / args.pairs * 1e3
    torch.cuda.reset_peak_memory_stats()
    prof = _device_profile(run, args.pairs)
    stages = prof.pop("stages")
    counted = prof.pop("counters")

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
        **{f"{k}_per_{unit}" if k != "device_busy_share" else k: v for k, v in prof.items()},
        f"stages_per_{unit}": stages,
        "counters": counted,  # summed over the profiled pairs (steps)
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
