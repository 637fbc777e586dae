"""Entry point for training and evaluation (counterpart of
``pcrcg_tpu/main.py``; reference main.py:17-108):

    python -m pcrcg_tpu_torch.main --config <yaml> [--device cuda|cpu]

Loads the (reference-compatible) YAML config, builds the datasets, the
model and the optimizer, and dispatches on ``mode``: ``train`` (epochs of
train + val with checkpoints), ``val`` (one pass over the val split) or
``test``, by ``dataset``: indoor (``IndoorTester`` over the ``benchmark``
split, scored against its gt files), kitti (``KITTITester``) or modelnet
(``ModelnetTester``).  Runs on CUDA unless ``--device cpu`` is given.
KITTI reads its split lists from ``configs/kitti/{train,val,test}_kitti.txt``
relative to the working directory, as the JAX package does.

Data parallelism: ``multihost.initialize()`` runs first, as in
pcrcg_tpu/main.py:50-53, and joins the group that a launcher describes
(torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``, or the JAX
package's ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``).
With ``data_parallel: N > 1`` and no launcher, ``main`` starts the N ranks
itself (``parallel/launch.py``, one process a card with NCCL, or gloo with
``--device cpu``; the ranks meet through a ``file://`` rendezvous under
``exp_dir``), so the command stays the same; it then returns None, and rank
0 logs and writes the checkpoints under ``exp_dir``.  As in the JAX
package, ``data_parallel`` above the number of cards raises.
"""
from __future__ import annotations

import argparse
import os
import sys
import uuid

import torch

from pcrcg_tpu_torch.assets import benchmark_gt_root
from pcrcg_tpu_torch.config import Config, load_config
from pcrcg_tpu_torch.data.indoor import IndoorDataset, load_split
from pcrcg_tpu_torch.data.kitti import KITTIDataset
from pcrcg_tpu_torch.data.loader import PairLoader
from pcrcg_tpu_torch.data.modelnet import get_modelnet_datasets
from pcrcg_tpu_torch.eval.modelnet_metrics import ModelnetTester
from pcrcg_tpu_torch.eval.tester import IndoorTester, KITTITester
from pcrcg_tpu_torch.parallel import launch, multihost
from pcrcg_tpu_torch.train.trainer import Trainer

_LAUNCHER_ENV = ("WORLD_SIZE", "NUM_PROCESSES", "COORDINATOR_ADDRESS")


def build_datasets(cfg: Config):
    if cfg.dataset == "indoor":
        if cfg.mode == "train":
            return {"train": load_split(cfg, "train"), "val": load_split(cfg, "val")}
        if cfg.mode == "val":
            return {"val": load_split(cfg, "val")}
        return {"test": IndoorDataset(
            os.path.join(os.path.dirname(cfg.val_info or "configs/indoor"),
                         f"{cfg.benchmark}.pkl"),
            cfg,
            data_augmentation=False,
        )}
    if cfg.dataset == "kitti":
        phases = {"train": ("train", "val"), "val": ("val",), "test": ("test",)}[cfg.mode]
        return {p: KITTIDataset(cfg, p) for p in phases}
    if cfg.dataset == "modelnet":
        return get_modelnet_datasets(cfg)
    raise ValueError(f"Unknown dataset: {cfg.dataset}")


def _spawn_ranks(cfg: Config, argv, device: str) -> None:
    """Run ``main(argv)`` on ``cfg.data_parallel`` ranks of this host,
    which meet through a fresh ``file://`` rendezvous under ``exp_dir``."""
    if device != "cpu" and torch.cuda.device_count() < cfg.data_parallel:
        raise ValueError(f"data_parallel={cfg.data_parallel} but {torch.cuda.device_count()} "
                         "card(s): NCCL takes one rank a card")
    os.makedirs(cfg.exp_dir, exist_ok=True)
    store = os.path.abspath(os.path.join(cfg.exp_dir, f".rendezvous-{uuid.uuid4().hex}"))
    try:
        launch.spawn(main, cfg.data_parallel, f"file://{store}", args=(argv,), device=device)
    finally:
        if os.path.exists(store):
            os.remove(store)


def main(argv=None):
    """Run the config's mode; returns the ``Trainer`` (train / val) or the
    tester's result dict (test), or None where it started the ranks of a
    data-parallel run."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", default="cuda")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    # Joins a launcher's process group; a no-op in a single process.
    multihost.initialize(device=args.device)
    cfg = load_config(args.config)
    if cfg.mode not in ("train", "val", "test"):
        raise ValueError(f"Unknown mode: {cfg.mode}")
    if cfg.data_parallel > 1 and not any(os.environ.get(k) for k in _LAUNCHER_ENV):
        _spawn_ranks(cfg, argv, args.device)
        return None
    datasets = build_datasets(cfg)
    trainer = Trainer(cfg, datasets, device=args.device)
    if cfg.mode == "train":
        trainer.train()
        return trainer
    if cfg.mode == "val":
        trainer.eval()
        return trainer
    if cfg.dataset == "kitti":
        return KITTITester(cfg, trainer.model, device=trainer.device).run(
            trainer.loaders["test"])
    if cfg.dataset == "modelnet":
        return ModelnetTester(cfg, trainer.model, device=trainer.device).run(
            trainer.loaders["test"])
    tester = IndoorTester(cfg, trainer.model, benchmark_gt_root(cfg.benchmark),
                          device=trainer.device)
    ds = datasets["test"]
    loader = PairLoader(ds, cfg.budgets.points[0], batch_size=1,
                        num_threads=cfg.num_workers, drop_last=False,
                        pin_memory=trainer.device.type == "cuda")
    return tester.run(ds, loader, n_points=cfg.n_points)


if __name__ == "__main__":
    main()
