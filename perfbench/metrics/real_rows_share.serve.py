"""The share of the pyramid's rows that hold real points, in %: the
program's counters ``pyramid.real_points`` over ``pyramid.budget_rows``,
both clouds, summed over the levels (pcrcg_tpu_torch/utils/profiling.py,
recorded while the traced window's profiler records).  KPConv and the
searches run on every row of a level's budget; the rest are padding."""
from perfbench.core import counters


def read(t):
    if t["unit"] != "pair":
        return None
    return counters.real_rows_share(counters.program_counters())
