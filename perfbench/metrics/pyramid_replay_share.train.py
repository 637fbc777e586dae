"""The share of the pyramid's calls on the card that replayed its CUDA
graph, in %: the program's host group ``pyramid_graph``
(pcrcg_tpu_torch/ops/pyramid.py::graphed_pyramid), replays over replays,
captures and eager calls, counted over the whole run (set-up, window and
traced steps).  A program without the group reports nothing."""


def read(t):
    if t["unit"] != "step":
        return None
    try:
        from pcrcg_tpu_torch.utils import profiling
    except ImportError:
        return None
    calls = profiling.counters().get("pyramid_graph")
    if not calls or not sum(calls.values()):
        return None
    return 100.0 * calls["replays"] / sum(calls.values())
