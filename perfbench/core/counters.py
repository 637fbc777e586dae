"""The program's counters, read after a traced window.

The port keeps one counter registry (``pcrcg_tpu_torch/utils/profiling.py``):
host groups, always counted, and device-valued counters recorded only while
a profiler records (in a run, only inside ``core/trace.py::profile_units``).
``program_counters`` reads them and drops the device-valued ones, so a later
traced window reads its own; ``real_rows_share`` is the share of the
pyramid's rows, over the levels, that hold real points.
"""
from __future__ import annotations

from typing import Optional


def program_counters() -> Optional[dict]:
    """The program's counters (``profiling.counters(reset=True)``: the
    host groups are read and left as they are); None where the program
    keeps no such registry."""
    try:
        from pcrcg_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return None if read is None else read(reset=True)


def real_rows_share(counters: Optional[dict]) -> Optional[float]:
    """Real points over the rows the levels hold (both clouds, summed over
    the levels), in %; None without the counters."""
    if not counters or not counters.get("pyramid.budget_rows"):
        return None
    return 100.0 * sum(counters["pyramid.real_points"]) / sum(counters["pyramid.budget_rows"])
