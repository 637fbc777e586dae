"""Closed-loop windows, one unit of work a call, that modes drive
(``modes/register.py``, ``modes/train.py``):

* ``register_window``: per pair, ``make_pair_batch`` on the raw clouds, then
  ``register_pair``, ended when the transform is on the host.  Latency is
  taken from the ``make_pair_batch`` call to the transform on the host;
  ``pairs_per_s`` is the pairs completed over the whole window.
* ``train_window``: ``train_step`` over batches made before the window; the
  window ends with a device synchronise, and ``steps_per_s`` is the steps
  over the whole window.

Each window cycles through the cell's pool of pairs with their pre-drawn
draws.  ``Capture`` keeps, for the check after the window, one answer of
each pool pair (an occurrence drawn from the seed) and what the model saw
on the way (the pyramid, the lifted features), by reference only.
"""
from __future__ import annotations

import statistics
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch


class Capture:
    """Forward hooks that keep a reference to the pyramid the KPFCNN takes
    and to the image lift's output, while ``armed``."""

    def __init__(self, kpfcnn: torch.nn.Module, lift: Optional[torch.nn.Module]):
        self.armed = False
        self.pyramid = None
        self.lifted = None
        self.handles = [kpfcnn.register_forward_pre_hook(self._pre_kpfcnn)]
        if lift is not None:
            self.handles.append(lift.register_forward_hook(self._post_lift))

    def _pre_kpfcnn(self, module, args):
        if self.armed:
            self.pyramid = args[0]

    def _post_lift(self, module, args, out):
        if self.armed:
            self.lifted = out

    def take(self) -> dict:
        got = {"pyramid": self.pyramid, "lifted": self.lifted}
        self.pyramid = self.lifted = None
        return got

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def register_window(run_pair: Callable[[int], dict], n_pool: int, seconds: float,
                    keep_at: List[int], capture: Capture, sync: Callable[[], None]) -> dict:
    """Pairs back to back until ``seconds`` have passed (and each pool pair
    has been answered once).  ``run_pair(i)``
    registers pool pair i and returns its result with the transform on the
    host.  ``keep_at[i]``: the occurrence of pair i whose answer is kept
    (an earlier one stands in when the window ends first)."""
    latencies, kept, failed = [], {}, 0
    seen = [0] * n_pool
    k = 0
    t_start = time.perf_counter()
    while True:
        i = k % n_pool
        capture.armed = seen[i] <= keep_at[i]
        t0 = time.perf_counter()
        try:
            res = run_pair(i)
        except Exception:  # a pair that fails never answers; the window goes on
            failed += 1
            res = None
            traceback.print_exc()
        t1 = time.perf_counter()
        if res is not None:
            latencies.append(t1 - t0)
            if capture.armed:
                kept[i] = {**capture.take(), "result": res}
        seen[i] += 1
        k += 1
        if t1 - t_start >= seconds and k >= n_pool:  # every pool pair answered once
            break
    capture.armed = False
    sync()
    elapsed = t1 - t_start
    return {"attempted": k, "failed": failed, "elapsed_s": elapsed, "latencies_s": latencies,
            "kept": kept, "pairs_per_s": len(latencies) / elapsed,
            "pair_ms_p95": p95(latencies) * 1e3 if latencies else None}


def train_window(run_step: Callable[[int], Dict], n_pool: int, start: int, seconds: float,
                 sync: Callable[[], None]) -> dict:
    """Steps back to back, pool pairs from ``start`` on, until ``seconds``
    have passed; then a synchronise ends the window."""
    k, failed = 0, 0
    t_start = time.perf_counter()
    while True:
        try:
            run_step((start + k) % n_pool)
        except Exception:  # a failed step counts; the window goes on
            failed += 1
            traceback.print_exc()
        k += 1
        if time.perf_counter() - t_start >= seconds:
            break
    sync()
    elapsed = time.perf_counter() - t_start
    return {"attempted": k, "failed": failed, "elapsed_s": elapsed,
            "steps_per_s": (k - failed) / elapsed}


def p95(values: List[float]) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100)[94]
