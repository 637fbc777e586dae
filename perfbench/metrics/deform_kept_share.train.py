"""The share of the deformable convs' real neighbor entries that they keep,
in %: the program's counters ``deform.kept_neighbors`` (entries within
KP_extent of some deformed kernel point) over ``deform.real_neighbors``
(non-shadow entries), summed over the query levels
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
    real = sum(c.get("deform.real_neighbors") or [])
    if not real:
        return None
    return 100.0 * sum(c.get("deform.kept_neighbors") or []) / real
