"""The share of the deformable convs' rows that hold a real neighbor, in %:
the program's counters ``deform.real_neighbors`` (non-shadow entries of
the neighbor lists) over ``deform.cap_rows`` (Nq·H, the rows the dense
deformed conv computes over), summed over the query levels
(pcrcg_tpu_torch/models/kpconv.py, recorded while the traced window's
profiler records).  Read without a reset; a program without the counters
reports nothing."""


def read(t):
    if t["unit"] != "step":
        return None
    try:
        from pcrcg_tpu_torch.utils import profiling
    except ImportError:
        return None
    c = profiling.counters()
    rows = sum(c.get("deform.cap_rows") or [])
    if not rows:
        return None
    return 100.0 * sum(c.get("deform.real_neighbors") or []) / rows
