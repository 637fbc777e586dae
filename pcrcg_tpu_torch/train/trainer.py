"""Training and evaluation orchestration (counterpart of
``pcrcg_tpu/train/trainer.py``; reference lib/trainer.py:31-431).

An epoch loop over a prefetching loader, stats meters, verbose_freq scalar
logging, per-epoch snapshots plus best-loss / best-recall snapshots,
resume from ``config.pretrain`` (a reference ``.pth`` / ``.pt`` / ``.tar``
loads into the model; any other path is one of this package's
checkpoints), and the 2D backbone's weights per ``init_mode``
(trainer.py:49-70).

Steps run eagerly (``train/step.py``); a step whose gradients are not
finite changes nothing (``train/state.py``).  The loss's draws come from
one ``torch.Generator`` on the device, seeded from ``cfg.seed`` and saved
in every checkpoint.

Data parallelism (the mesh branch of pcrcg_tpu/train/trainer.py:130-181):
in a ``torch.distributed`` run (``parallel/multihost.py``; ``main.py``
starts the ranks for ``data_parallel: N``, or torchrun does) every rank
builds the same model, loads its slice of each global batch of
``batch_size`` pairs under one shared shuffle, and steps with
``train_step_dp`` / ``eval_step_dp``; parameters and optimizer state are
broadcast from rank 0 after the model is built, a ``.pth`` imported or a
checkpoint restored.  Rank 0 alone logs, prints and writes checkpoints;
the ranks meet at a barrier after each write.  ``data_parallel`` beyond
the ranks at hand, or a ``batch_size`` that does not split over them,
raises.  The KPConv route stays as configured (tiled by default), as in
the JAX Trainer, which leaves it on for pure data parallelism.
"""
from __future__ import annotations

import os
import shutil
from collections import defaultdict, deque
from typing import Dict

import torch
import torch.distributed as dist

from pcrcg_tpu_torch import resolve_device
from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.data.calibrate import occupancy_report
from pcrcg_tpu_torch.data.loader import PairLoader, to_device
from pcrcg_tpu_torch.models.pcrcg import PCRCG, init_pcrcg
from pcrcg_tpu_torch.models.weights import load_backbone2d, load_kpfcnn
from pcrcg_tpu_torch.parallel.mesh import make_mesh, replicate
from pcrcg_tpu_torch.train.checkpoints import CheckpointManager
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import (
    eval_step, eval_step_dp, infer_step, train_step, train_step_dp,
)
from pcrcg_tpu_torch.utils.logging import Logger
from pcrcg_tpu_torch.utils.timer import RunningStat, Stopwatch

_REFERENCE_SUFFIXES = (".pth", ".pt", ".tar")


def init_model(cfg: Config, device=None) -> PCRCG:
    """``PCRCG`` with seeded random weights (``cfg.seed``) on ``device``,
    the 2D backbone loaded per ``init_mode`` when a checkpoint path is
    configured for it (reference trainer.py:49-70)."""
    model = init_pcrcg(cfg, seed=cfg.seed, device=device)
    if cfg.image_feature and cfg.init_mode != "random" and cfg.pretrain_2d_path():
        load_backbone2d(cfg.pretrain_2d_path(), model.lift.backbone2d)
    return model


class _NullLogger:
    """The logger of a rank other than 0: writes nothing."""

    def write(self, message: str):
        pass

    def scalars(self, tag_prefix, values, step):
        pass

    def dump_config(self, config):
        pass


class Trainer:
    def __init__(self, cfg: Config, datasets: Dict[str, object], device=None):
        self.cfg = cfg
        # The data-parallel mesh: every rank of a torch.distributed run.
        self.mesh = make_mesh(device=device) if dist.is_initialized() else None
        n_shards = 1 if self.mesh is None else self.mesh.world_size
        if cfg.data_parallel > n_shards:
            raise ValueError(
                f"data_parallel={cfg.data_parallel} but only {n_shards} rank(s): start one "
                "process a device (python -m pcrcg_tpu_torch.main does, or torchrun)")
        if cfg.batch_size % n_shards != 0:
            raise ValueError(f"batch_size={cfg.batch_size} must be a multiple of the "
                             f"data-parallel shard count {n_shards}")
        self.is_main = self.mesh is None or self.mesh.is_main
        self.device = resolve_device(device if self.mesh is None else self.mesh.device)
        self.logger = Logger(cfg.exp_dir) if self.is_main else _NullLogger()
        self.logger.dump_config(cfg)
        if self.is_main:
            self._backup_source(cfg.exp_dir)

        def make_loader(phase, ds):
            # Eval phases score every pair (reference lib/benchmark.py:
            # 271-337); train drops the ragged tail.  A ragged eval split
            # falls back to one pair a rank.
            bsz = cfg.batch_size
            if phase != "train" and len(ds) % bsz != 0:
                self.logger.write(
                    f"{phase} split ({len(ds)} pairs) not divisible by "
                    f"batch_size={bsz}; eval loader falls back to "
                    f"batch_size={n_shards} for completeness\n"
                )
                bsz = n_shards
            return PairLoader(
                ds, cfg.budgets.points[0], batch_size=bsz, shuffle=phase == "train",
                num_threads=cfg.num_workers, seed=cfg.seed, drop_last=phase == "train",
                pin_memory=self.device.type == "cuda",
                mesh=self.mesh,
            )

        self.loaders = {phase: make_loader(phase, ds) for phase, ds in datasets.items()}
        if self.is_main:
            self._check_budgets(datasets)
        self.model = init_model(cfg, self.device)
        steps = max(len(self.loaders.get("train", [])), 1)
        self.state = TrainState(cfg, self.model, steps_per_epoch=steps)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.ckpt = CheckpointManager(os.path.join(cfg.exp_dir, "checkpoints"))
        self.start_epoch = 0
        self.pretrain_report = None
        if cfg.pretrain and cfg.pretrain.endswith(_REFERENCE_SUFFIXES):
            # A reference-format torch checkpoint (lib/trainer.py:163-184
            # _load_pretrain): trained weights and the checkpoint's kernel
            # dispositions into the KPFCNN.
            report = self.pretrain_report = load_kpfcnn(cfg.pretrain, self.model.kpfcnn)
            self.logger.write(
                f"imported torch pretrain from {cfg.pretrain}: {report['loaded']} "
                f"tensors ({len(report['errors'])} unmatched)\n"
            )
        elif cfg.pretrain:
            _, meta = self.ckpt.restore(self.state, path=cfg.pretrain, generator=self.generator)
            self.start_epoch = int(meta["epoch"]) + 1
            # The loaders continue their order and draws where the saved
            # run left them.
            for loader in self.loaders.values():
                loader.set_epoch(self.start_epoch)
            self.logger.write(f"restored pretrain from {cfg.pretrain} @epoch {meta['epoch']}\n")
        if self.mesh is not None:
            replicate(self.state, self.mesh)
            dist.barrier()

    def _check_budgets(self, datasets, num_samples: int = 4):
        """Log (and print) when the static point budgets drop points: a
        level-0 truncation loses signal, and a voxel-budget overflow at a
        coarser level drops voxels.  Runs a few training clouds through the
        native host pyramid (``data/calibrate.py::occupancy_report``)."""
        ds = datasets.get("train") or next(iter(datasets.values()), None)
        if ds is None or len(ds) == 0:
            return
        try:
            report = occupancy_report(ds, self.cfg, num_samples=num_samples)
        except Exception as e:  # no host toolchain, an odd dataset, ...
            self.logger.write(f"budget occupancy check skipped: {e}\n")
            return
        self.logger.write(f"budget occupancy: {report}\n")
        if any(report["truncating"]):
            msg = (
                "WARNING: static point budgets TRUNCATE at levels "
                f"{[i for i, t in enumerate(report['truncating']) if t]} "
                f"(max occupancy {report['max']} vs budgets {report['budget']}); "
                "raise tpu.budgets.points or recalibrate them (data/calibrate.py)"
            )
            self.logger.write(msg + "\n")
            print(msg, flush=True)

    def _check_overflow(self, stats: dict, phase: str, epoch: int, c_iter: int):
        """Per-step voxel-budget overflow action (cfg.overflow_action):
        stats['max_overflow'] > 0 means the pyramid dropped voxels past a
        level budget this step."""
        ov = stats.get("max_overflow", 0.0)
        if ov <= 0 or self.cfg.overflow_action == "none":
            return
        msg = (
            f"{phase} Epoch {epoch} iter {c_iter}: voxel-budget OVERFLOW "
            f"(max_overflow={ov:.0f} voxels dropped past a level budget); "
            "raise tpu.budgets.points or recalibrate them (data/calibrate.py)"
        )
        if self.cfg.overflow_action == "error":
            raise RuntimeError(msg)
        self.logger.write(msg + "\n")
        print(msg, flush=True)

    @staticmethod
    def _backup_source(exp_dir: str):
        """Copy the package source into the snapshot dir (reference
        main.py:46-51 reproducibility convention)."""
        src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        dst = os.path.join(exp_dir, "source_backup", "pcrcg_tpu_torch")
        if not os.path.exists(dst):
            shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))

    def _meter(self, meters, stats, phase: str, epoch: int, c_iter: int):
        keys = list(stats)
        values = torch.stack([stats[k].float() for k in keys]).tolist()  # one copy
        stats = dict(zip(keys, values))
        for k, v in stats.items():
            meters[k].update(v)
        self._check_overflow(stats, phase, epoch, c_iter)

    def run_epoch(self, epoch: int, phase: str) -> Dict[str, RunningStat]:
        assert phase in ("train", "val", "test")
        meters: Dict[str, RunningStat] = defaultdict(RunningStat)
        loader = self.loaders[phase]
        num_iter = len(loader)
        timer = Stopwatch()
        inflight: deque = deque()
        if self.mesh is None:
            step = train_step if phase == "train" else eval_step
        else:
            step = train_step_dp if phase == "train" else eval_step_dp
        for c_iter, (batch, images) in enumerate(loader):
            timer.tic()
            batch, images = to_device(batch, images, self.device)
            stats = step(self.state, self.cfg, batch, generator=self.generator, images=images)
            # Pipelined metering, as in the JAX Trainer: step i - 2's stats
            # are read once step i is enqueued.  The eager step's own
            # finite-gradient check (train/state.py) has already waited for
            # step i's backward, so this read adds no wait of its own.
            inflight.append(stats)
            if len(inflight) > 2:
                self._meter(meters, inflight.popleft(), phase, epoch, c_iter)
            timer.toc()
            bsz = batch.points.shape[0] * (1 if self.mesh is None else self.mesh.world_size)
            meters["pairs_per_sec"].update(bsz / max(timer.elapsed, 1e-9))
            if (c_iter + 1) % self.cfg.verbose_freq == 0 and self.cfg.verbose and self.is_main:
                self.logger.scalars(phase, {k: m.mean for k, m in meters.items()},
                                    num_iter * epoch + c_iter)
                msg = f"{phase} Epoch: {epoch} [{c_iter+1:4d}/{num_iter}] " + " ".join(
                    f"{k}: {m.mean:.3f}" for k, m in meters.items()
                )
                self.logger.write(msg + "\n")
                print(msg, flush=True)
        while inflight:  # drain the pipelined tail
            self._meter(meters, inflight.popleft(), phase, epoch, num_iter - 1)
        summary = f"{phase} Epoch {epoch}: " + " ".join(
            f"{k}: {m.mean:.3f}" for k, m in meters.items()
        )
        self.logger.write(summary + "\n")
        if self.is_main:
            print(summary, flush=True)
        return meters

    def train(self):
        for epoch in range(self.start_epoch, self.cfg.max_epoch):
            self.run_epoch(epoch, "train")
            meters = self.run_epoch(epoch, "val")
            if self.is_main:
                self.ckpt.maybe_save_best(self.state, epoch, meters["circle_loss"].mean,
                                          meters["recall"].mean, self.generator)
                if (epoch + 1) % self.cfg.snapshot_freq == 0:
                    self.ckpt.save(self.state, epoch, self.generator)
            if self.mesh is not None:
                dist.barrier()  # the checkpoints are written before any rank goes on
        if self.is_main:
            print("Training finish!", flush=True)

    def eval(self):
        return self.run_epoch(0, "val")

    def infer(self, batch, images=None):
        batch, images = to_device(batch, images, self.device)
        return infer_step(self.state, self.cfg, batch, images)
