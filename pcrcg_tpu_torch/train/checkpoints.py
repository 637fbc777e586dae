"""Checkpoint save and restore (counterpart of
``pcrcg_tpu/train/checkpoints.py``, ``torch.save`` in place of orbax).

The reference's snapshot flow (lib/trainer.py:129-184): per-epoch
snapshots (the newest ``max_to_keep`` kept, RPMNet's manager,
common/torch.py:34+) plus ``best_loss`` / ``best_recall`` aliases, each
restoring the model, the optimizer, the step counters, the loss's
generator, the epoch and the best metrics.  Files are
``<dir>/epoch_<n>.ckpt``, ``<dir>/best_loss.ckpt`` and
``<dir>/best_recall.ckpt``, each written to a temporary file and renamed
into place.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

from pcrcg_tpu_torch.train.state import TrainState

_EPOCH_FILE = re.compile(r"^epoch_(\d+)\.ckpt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_loss = float("inf")
        self.best_recall = 0.0

    def _write(self, path: str, state: TrainState, epoch: int,
               generator: Optional[torch.Generator]) -> None:
        payload = {
            "state": state.state_dict(),
            "generator": None if generator is None else generator.get_state(),
            "meta": {"epoch": epoch, "best_loss": self.best_loss,
                     "best_recall": self.best_recall},
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def epoch_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.ckpt")

    def alias_path(self, tag: str) -> str:
        return os.path.join(self.directory, f"{tag}.ckpt")

    def save(self, state: TrainState, epoch: int,
             generator: Optional[torch.Generator] = None) -> None:
        self._write(self.epoch_path(epoch), state, epoch, generator)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.epoch_path(old))

    def maybe_save_best(self, state: TrainState, epoch: int, circle_loss: float,
                        recall: float, generator: Optional[torch.Generator] = None):
        """Track best-loss / best-recall (reference trainer.py:404-415)."""
        improved = []
        if circle_loss < self.best_loss:
            self.best_loss = circle_loss
            improved.append("best_loss")
        if recall > self.best_recall:
            self.best_recall = recall
            improved.append("best_recall")
        for tag in improved:
            self._write(self.alias_path(tag), state, epoch, generator)
        return improved

    def restore(self, state: TrainState, step: Optional[int] = None,
                path: Optional[str] = None, generator: Optional[torch.Generator] = None):
        """Load epoch ``step`` (default: the latest), or the file ``path``
        (an alias or any checkpoint, as ``config.pretrain``), into ``state``
        and ``generator`` in place, tensors onto the model's device.
        Returns (state, meta): meta holds epoch, best_loss and best_recall."""
        if path is None:
            step = self.latest_step() if step is None else step
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
            path = self.epoch_path(step)
        device = next(state.model.parameters()).device
        payload = torch.load(path, map_location=device, weights_only=True)
        state.load_state_dict(payload["state"])
        if generator is not None and payload["generator"] is not None:
            generator.set_state(payload["generator"].cpu())
        meta = payload["meta"]
        self.best_loss = float(meta["best_loss"])
        self.best_recall = float(meta["best_recall"])
        return state, meta

    def all_steps(self):
        """Saved epochs, ascending."""
        return sorted(int(m.group(1)) for m in map(_EPOCH_FILE.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None
