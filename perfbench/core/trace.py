"""The traced window of a ``--trace 1`` run.

``profile_units`` runs units of work, unsynchronized as in the timed
window, under ``torch.profiler`` and reduces the trace to:

* the device's busy time (the union of every device operation's interval)
  against the traced wall, and the device operations that took most time;
* the longest idle stretches by what the host was doing (the innermost
  host operation of the main thread covering each gap's middle), summed
  by name;
* device kernels per unit (every launch the profiler sees, whatever API
  made it; copies and fills are not kernels);
* the device time of the KPConv modules: the kernels under a profiler
  range that forward hooks open and close around each KPConv module call,
  and, for training, the kernels under the backward of every autograd node
  those calls created (matched by the nodes' sequence numbers).  No kernel
  name enters the attribution.

``staged_units`` runs the same units through the same entry again, with
``StageMarks`` at the boundaries of its layers (forward hooks on the
layers' modules, and wrappers around the functions the entry calls), each
boundary a device sync: host ms a layer a unit.
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

KPCONV_RANGE = "perfbench::kpconv"
WINDOW_RANGE = "perfbench::window"
BACKWARD_PREFIX = "autograd::engine::evaluate_function: "


class KPConvHooks:
    """Forward pre / post hooks on the KPConv modules: a profiler range
    around each call, and per call what the work counts need (references to
    the inputs, read after the traced window)."""

    def __init__(self, modules):
        self.calls: List[dict] = []
        self.stack = []
        self.handles = []
        for m in modules:
            self.handles.append(m.register_forward_pre_hook(self._pre))
            self.handles.append(m.register_forward_hook(self._post))

    def _pre(self, module, args):
        q_pts, s_pts, neighb_inds, x = args[:4]
        self.calls.append({"q_pts": q_pts, "s_pts": s_pts, "neighb_inds": neighb_inds,
                           "c_in": x.shape[-1], "c_out": module.weights.shape[-1],
                           "k": module.weights.shape[0], "input_grad": x.requires_grad})
        rf = torch.profiler.record_function(KPCONV_RANGE)
        rf.__enter__()
        self.stack.append(rf)

    def _post(self, module, args, out):
        self.stack.pop().__exit__(None, None, None)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _is_annotation(ev) -> bool:
    """A profiler range drawn on the device's timeline (not an operation)."""
    return bool(getattr(ev, "is_user_annotation", False)) or ev.name.startswith("perfbench::")


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _descendants(ev):
    out, todo = [], list(ev.cpu_children)
    while todo:
        e = todo.pop()
        out.append(e)
        todo.extend(e.cpu_children)
    return out


def reduce_trace(events, n_units: int) -> dict:
    """Everything the per-layer metrics and the breakdown read, from a
    profile's ``events()``."""
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and not _is_annotation(e)]
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    window = [e for e in cpu if e.name == WINDOW_RANGE]
    w0 = min(e.time_range.start for e in window)
    w1 = max(e.time_range.end for e in window)
    main_thread = window[0].thread
    intervals = [(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev
                 if e.time_range.end > w0 and e.time_range.start < w1]
    busy = _union([iv for iv in intervals if iv[1] > iv[0]])
    busy_us = sum(e - s for s, e in busy)
    by_name = defaultdict(float)
    n_kernels = 0
    for e in dev:
        by_name[e.name] += e.time_range.end - e.time_range.start
        n_kernels += not _is_copy(e.name)

    # Idle gaps, named by the innermost main-thread host op covering them.
    host = sorted((e.time_range.start, e.time_range.end, _depth(e), e.name) for e in cpu
                  if e.thread == main_thread and e.name != WINDOW_RANGE)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle_by = defaultdict(float)
    active, j = [], 0
    for gs, ge in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (gs + ge) / 2
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(active, (host[j][1], -host[j][2], host[j][3]))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = max(active, key=lambda a: -a[1])[2] if active else "(host idle)"
        idle_by[name] += ge - gs

    # KPConv device time: forward ranges, and the backward of their nodes.
    ranges = [e for e in cpu if e.name == KPCONV_RANGE]
    fwd_us = sum(e.device_time_total for e in ranges)
    seqs = set()
    for r in ranges:
        for d in _descendants(r):
            if d.sequence_nr is not None and d.sequence_nr >= 0:
                seqs.add(d.sequence_nr)
    bwd_us = sum(e.device_time_total for e in cpu
                 if e.name.startswith(BACKWARD_PREFIX) and e.sequence_nr in seqs)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "units": n_units,
        "kernels_per_unit": n_kernels / n_units,
        "device_ops": [[name[:160], us * 1e-6] for name, us in top],
        "idle_gaps": [[name[:160], us * 1e-6] for name, us in idle],
        "kpconv_fwd_s": fwd_us * 1e-6,
        "kpconv_bwd_s": bwd_us * 1e-6,
    }


def _depth(ev) -> int:
    d, p = 0, ev.cpu_parent
    while p is not None:
        d, p = d + 1, p.cpu_parent
    return d


def profile_units(run_unit: Callable[[int], None], units: List[int],
                  sync: Callable[[], None]) -> dict:
    """Profile ``run_unit(i)`` for each i of ``units`` as one traced window
    (ended by a sync inside it)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW_RANGE):
            for i in units:
                run_unit(i)
            sync()
    return reduce_trace(prof.events(), len(units))


class StageMarks:
    """Synced host-clock boundaries between the layers of the program's own
    entry, as it runs: ``mark(name)`` syncs the device and ends the stage
    ``name`` that began at the previous mark (or at ``start``).  Marks come
    from forward hooks (``after_forward``) and from wrappers around a
    function or method of an object (``around``); ``remove`` undoes them.
    What the program no longer has is not marked, and ``staged_units``
    then reports nothing."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.seen: List[tuple] = []
        self.t = None
        self.undo: List[Callable[[], None]] = []
        self.missing = False

    def start(self) -> None:
        self.sync()
        self.seen = []
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.t is None:
            return
        self.sync()
        now = time.perf_counter()
        self.seen.append((name, now - self.t))
        self.t = now

    def after_forward(self, module, name: str) -> None:
        """A mark ``name`` when ``module``'s forward returns."""
        if module is None:
            self.missing = True
            return
        handle = module.register_forward_hook(lambda *_: self.mark(name))
        self.undo.append(handle.remove)

    def around(self, owner, attr: str, before: str = "", after: str = "") -> None:
        """Marks ``before`` / ``after`` a call of ``owner.attr`` (a module's
        function, or an object's method), while the marks are in place."""
        fn = getattr(owner, attr, None)
        if fn is None:
            self.missing = True
            return

        def wrapped(*args, **kwargs):
            if before:
                self.mark(before)
            out = fn(*args, **kwargs)
            if after:
                self.mark(after)
            return out

        own = attr in vars(owner)
        setattr(owner, attr, wrapped)
        self.undo.append(lambda: setattr(owner, attr, fn) if own else delattr(owner, attr))

    def remove(self) -> None:
        for undo in reversed(self.undo):
            undo()
        self.undo = []
        self.t = None


def staged_units(run_unit: Callable[[int], None], units: List[int], marks: StageMarks,
                 stages: List[str]) -> Dict[str, float]:
    """Mean host ms of each of ``stages`` over ``units``: ``run_unit(i)``
    with ``marks`` in place, the last stage ended when the unit returns.
    Empty when a unit's marks do not come as ``stages`` (the entry no
    longer runs through a marked layer)."""
    sums = defaultdict(float)
    if marks.missing:
        return {}
    for i in units:
        marks.start()
        run_unit(i)
        marks.mark(stages[-1])
        if [name for name, _ in marks.seen] != list(stages):
            return {}
        for name, seconds in marks.seen:
            sums[name] += seconds
    return {k: v / len(units) * 1e3 for k, v in sums.items()}
