"""Entry point for training and evaluation (counterpart of
``pcrcg_tpu/main.py``; reference main.py:17-108):

    python -m pcrcg_tpu_torch.main --config <yaml> [--device cuda|cpu]

Loads the (reference-compatible) YAML config, builds the datasets, the
model and the optimizer, and dispatches on ``mode``: ``train`` (epochs of
train + val with checkpoints), ``val`` (one pass over the val split) or
``test`` (``IndoorTester`` over the ``benchmark`` split, scored against
its gt files).  Runs on CUDA unless ``--device cpu`` is given.  The indoor
(3DMatch / 3DLoMatch) dataset only: KITTI and ModelNet are ROADMAP item 5.
"""
from __future__ import annotations

import argparse
import os

from pcrcg_tpu_torch.assets import benchmark_gt_root
from pcrcg_tpu_torch.config import Config, load_config
from pcrcg_tpu_torch.data.indoor import IndoorDataset, load_split
from pcrcg_tpu_torch.data.loader import PairLoader
from pcrcg_tpu_torch.eval.tester import IndoorTester
from pcrcg_tpu_torch.train.trainer import Trainer


def build_datasets(cfg: Config):
    if cfg.dataset in ("kitti", "modelnet"):
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} is not ported yet (ROADMAP item 5: the KITTI and "
            "ModelNet datasets and their testers)")
    if cfg.dataset != "indoor":
        raise ValueError(f"Unknown dataset: {cfg.dataset}")
    if cfg.mode == "train":
        return {"train": load_split(cfg, "train"), "val": load_split(cfg, "val")}
    if cfg.mode == "val":
        return {"val": load_split(cfg, "val")}
    return {"test": IndoorDataset(
        os.path.join(os.path.dirname(cfg.val_info or "configs/indoor"), f"{cfg.benchmark}.pkl"),
        cfg,
        data_augmentation=False,
    )}


def main(argv=None):
    """Run the config's mode; returns the ``Trainer`` (train / val) or the
    tester's result dict (test)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    if cfg.mode not in ("train", "val", "test"):
        raise ValueError(f"Unknown mode: {cfg.mode}")
    datasets = build_datasets(cfg)
    trainer = Trainer(cfg, datasets, device=args.device)
    if cfg.mode == "train":
        trainer.train()
        return trainer
    if cfg.mode == "val":
        trainer.eval()
        return trainer
    tester = IndoorTester(cfg, trainer.model, benchmark_gt_root(cfg.benchmark),
                          device=trainer.device)
    ds = datasets["test"]
    loader = PairLoader(ds, cfg.budgets.points[0], batch_size=1,
                        num_threads=cfg.num_workers, drop_last=False,
                        pin_memory=trainer.device.type == "cuda")
    return tester.run(ds, loader, n_points=cfg.n_points)


if __name__ == "__main__":
    main()
