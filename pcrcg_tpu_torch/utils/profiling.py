"""Profiling helpers (counterpart of ``pcrcg_tpu/utils/profiling.py``):
``trace(dir)`` records a ``torch.profiler`` trace of its block as a Chrome
trace (chrome://tracing, Perfetto), ``device_memory_report()`` summarizes
the CUDA caching allocator per device and ``live_buffers_by_shape()``
aggregates the live CUDA tensors by dtype and shape (leak hunting).
"""
from __future__ import annotations

import contextlib
import gc
import os
import warnings
from collections import defaultdict

import torch

_MB = 2.0**20


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile the block (CPU ops, and CUDA kernels when a card is present)
    and write ``<log_dir>/<name>``; yields the path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(log_dir, name)
    with profile(activities=activities, record_shapes=True) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def device_memory_report() -> dict:
    """Allocated, peak and reserved MB per CUDA device (empty without one)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_mb": round(stats.get("allocated_bytes.all.current", 0) / _MB, 1),
            "peak_bytes_in_use_mb": round(stats.get("allocated_bytes.all.peak", 0) / _MB, 1),
            "bytes_reserved_mb": round(stats.get("reserved_bytes.all.current", 0) / _MB, 1),
            "bytes_limit_mb": round(torch.cuda.get_device_properties(i).total_memory / _MB, 1),
        }
    return out


def live_buffers_by_shape(device_type: str = "cuda") -> dict:
    """Live tensors on ``device_type`` that the garbage collector can see,
    by "dtype shape": count and MB, the largest first."""
    agg = defaultdict(lambda: [0, 0.0])
    with warnings.catch_warnings():  # the scan touches deprecated module attributes
        warnings.simplefilter("ignore", FutureWarning)
        tensors = [obj for obj in gc.get_objects() if torch.is_tensor(obj)]
    for obj in tensors:
        if obj.device.type != device_type:
            continue
        key = f"{str(obj.dtype).replace('torch.', '')} {tuple(obj.shape)}"
        agg[key][0] += 1
        agg[key][1] += obj.numel() * obj.element_size() / _MB
    return {k: {"count": c, "mb": round(m, 2)}
            for k, (c, m) in sorted(agg.items(), key=lambda kv: -kv[1][1])}
