"""Train state and optimizer (counterpart of ``pcrcg_tpu/train/state.py``).

The JAX package's optax chain, step for step (reference main.py:59-78,
lib/trainer.py:361-367):

* ``add_decayed_weights(wd)`` then SGD (momentum 0.98) or Adam: that is
  ``torch.optim.SGD`` / ``Adam`` with ``weight_decay`` — L2 added to the
  gradient, not AdamW's decoupled decay;
* a staircase schedule ``lr · γ^⌊count / (steps_per_epoch · scheduler_freq)⌋``
  where ``count`` is the number of updates applied so far;
* ``iter_size > 1`` (``optax.MultiSteps``): the running mean of k
  gradients, applied on every k-th step;
* ``apply_if_finite``: a step whose gradients are not all finite changes
  nothing — parameters, momentum, accumulator and schedule count stay —
  but ``step`` still advances.

Every trainable parameter takes part in every update (a missing gradient
counts as zero), since optax decays and moves the momentum of every leaf.
A parameter that does not require a gradient takes no part: the frozen 2D
backbone of ``PCRCG`` gets no decay and no momentum, as the JAX package's
``trainable_labels`` (pcrcg_tpu/train/state.py:48-63) freezes
``backbone2d``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.utils.profiling import span


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """SGD(momentum) or Adam with L2 weight decay, at the schedule's first lr."""
    if cfg.optimizer.upper() == "SGD":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    if cfg.optimizer.upper() == "ADAM":
        return torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.weight_decay)
    raise ValueError(f"Unknown optimizer: {cfg.optimizer}")


class TrainState:
    """A model, its optimizer and the step counters of the optax chain."""

    def __init__(self, cfg: Config, model: nn.Module, steps_per_epoch: int = 1):
        self.model = model
        self.params: List[nn.Parameter] = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(cfg, self.params)
        self.lr = cfg.lr
        self.gamma = cfg.scheduler_gamma
        self.transition_steps = max(steps_per_epoch * cfg.scheduler_freq, 1)
        self.iter_size = cfg.iter_size
        self.step = 0  # apply_gradients calls, skipped ones included
        self.count = 0  # updates applied (the schedule's count)
        self.mini_step = 0  # gradients accumulated towards the next update
        self._acc: Optional[List[torch.Tensor]] = None

    def learning_rate(self) -> float:
        return self.lr * self.gamma ** (self.count // self.transition_steps)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def apply_gradients(self) -> bool:
        """Apply the parameters' ``.grad`` (None = zero) as one optax
        update; returns whether the parameters moved.  Clears the grads."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        self.step += 1
        # Read on the host: a training step's one sync on the card.  The
        # host, dispatching the eager step, reaches it behind the device, so
        # it waits next to nothing (PERF.md §5).
        with span("optimizer.finite_gate"):
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
        if not finite:
            self.zero_grad()
            return False
        if self.iter_size > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            # optax.MultiSteps' running mean: acc + (g − acc) / (n + 1).
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.iter_size:
                self.zero_grad()
                return False
            grads = [a.clone() for a in self._acc]
            for a in self._acc:
                a.zero_()
            self.mini_step = 0
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.optimizer.param_groups:
            group["lr"] = self.learning_rate()
        self.optimizer.step()
        self.count += 1
        self.zero_grad()
        return True

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run needs to continue exactly: the model's
        state dict (parameters and buffers), the optimizer's, the counters
        and the gradient accumulator of ``iter_size > 1``."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "count": self.count, "mini_step": self.mini_step,
                "acc": self._acc}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step, self.count, self.mini_step = sd["step"], sd["count"], sd["mini_step"]
        dev = self.params[0].device if self.params else None
        self._acc = None if sd["acc"] is None else [a.to(dev) for a in sd["acc"]]
