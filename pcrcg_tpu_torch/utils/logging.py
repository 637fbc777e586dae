"""Experiment logging: append-mode text log + JSONL scalar stream (+
tensorboardX when importable).  Counterpart of
``pcrcg_tpu/utils/logging.py``: the reference's file Logger
(lib/utils.py:20-30), per-key scalars every verbose_freq iterations
(lib/trainer.py:98,378-388), the resolved-config dump (main.py:35-39).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict


class Logger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._f = open(os.path.join(log_dir, "log"), "a")
        self._scalars = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:  # optional tensorboard (the reference uses tensorboardX)
            from tensorboardX import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def write(self, message: str):
        self._f.write(message)
        self._f.flush()

    def scalars(self, tag_prefix: str, values: Dict[str, float], step: int):
        rec = {"step": step, "time": time.time(), "prefix": tag_prefix}
        rec.update({k: float(v) for k, v in values.items()})
        self._scalars.write(json.dumps(rec) + "\n")
        self._scalars.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f"{tag_prefix}/{k}", float(v), step)

    def dump_config(self, config):
        with open(os.path.join(self.log_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=2, default=str)

    def close(self):
        self._f.close()
        self._scalars.close()
        if self._tb is not None:
            self._tb.close()
