"""Profiling helpers (counterpart of ``pcrcg_tpu/utils/profiling.py``):
``trace(dir)`` records a ``torch.profiler`` trace of its block as a Chrome
trace (chrome://tracing, Perfetto), ``device_memory_report()`` summarizes
the CUDA caching allocator per device and ``live_buffers_by_shape()``
aggregates the live CUDA tensors by dtype and shape (leak hunting).

The port's own tracing lives here too:

* **Spans.**  ``span(name)`` is a ``pcrcg::<name>`` profiler range around
  its block while a ``torch.profiler`` profile records, and nothing
  otherwise: a profiler that records is the one switch.  The ranges land
  on the profiler's timeline beside CUPTI's kernels and copies, on one
  clock.  One unit of work (``register_pair``, ``train_step``) is a root
  ``unit_span``; its stages (``stage(name)``: ``pyramid``, ``kpfcnn``,
  ``registration``, ``forward``, ``loss``, ``backward``, ``optimizer``, ...)
  carry the unit's sequence number as their argument (a concrete input of
  the range where the profiler records shapes), and a stage's parts are
  child spans named ``<stage>.<part>``.  ``stage_table`` reduces a
  profile's events to device ms, idle ms and kernels per span name.
* **Counters.**  One registry: host groups (``counter_group``: the kernel
  launches of ``kernels.LAUNCHES``, the cloud axis's ``EXCHANGES``, the
  pyramid's CUDA-graph calls ``pyramid.GRAPH_CALLS``), always counted, and device-valued counters (``record``), kept only while
  a profiler records, as references to tensors the program computes
  anyway and summed only when ``counters()`` reads them (or when
  ``trace()`` ends): no kernel and no sync inside a traced unit.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import os
import threading
import warnings
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

import torch

_MB = 2.0**20
PREFIX = "pcrcg::"

# Whether a profile records: one flag read.  A span gated on it costs
# ~0.5 us an enter and exit with no profiler running, an ungated
# record_function ~9 us (the H100 machine's host; PERF.md §5).
recording = torch._C._autograd._profiler_enabled
# The record_function entry that takes an argument (the unit number).
_enter = torch._C._autograd._record_function_with_args_enter
_exit = torch._C._autograd._record_function_with_args_exit


class span:
    """``pcrcg::<name>`` around the block while a profiler records, with
    ``unit`` as its argument when given; otherwise nothing."""

    __slots__ = ("name", "unit", "_handle")

    def __init__(self, name: str, unit: Optional[int] = None):
        self.name = name
        self.unit = unit
        self._handle = None

    def __enter__(self):
        if recording():
            args = () if self.unit is None else (self.unit,)
            self._handle = _enter(PREFIX + self.name, *args)
        return self

    def __exit__(self, *exc):
        if self._handle is not None:
            _exit(self._handle)
            self._handle = None
        return False


class _Units(threading.local):
    """Unit sequence numbers: ``next`` (a class attribute, shared by every
    thread) is the number the next root takes, ``current`` the open root's
    on this thread (None outside one)."""

    next = 0
    current: Optional[int] = None


_UNITS = _Units()


def stage(name: str) -> span:
    """A stage span: it carries the open unit's number or, outside a unit
    on the main thread (``batch``, made before ``register_pair``), the next
    unit's.  On another thread outside a unit (a loader's worker that
    prefetches batches) it carries none: which unit will take its work is
    not known there."""
    unit = _UNITS.current
    if unit is None and threading.current_thread() is threading.main_thread():
        unit = _Units.next
    return span(name, unit)


class unit_span(span):
    """The root span of one unit of work: it takes the next unit number,
    which the stages inside it carry."""

    __slots__ = ()

    def __init__(self, name: str):
        super().__init__(name, _Units.next)

    def __enter__(self):
        _UNITS.current = self.unit
        _Units.next = self.unit + 1
        return super().__enter__()

    def __exit__(self, *exc):
        _UNITS.current = None
        return super().__exit__(*exc)


# ---- Counters ---------------------------------------------------------------

_GROUPS: Dict[str, Dict[str, int]] = {}
_RECORDED: Dict[str, Dict[int, list]] = defaultdict(lambda: defaultdict(list))


def counter_group(name: str, keys: Iterable[str]) -> Dict[str, int]:
    """A group of host counters (plain ints, always counted), registered
    under ``name``; returns the dict the counting code increments."""
    group = {k: 0 for k in keys}
    _GROUPS[name] = group
    return group


def record(name: str, index: int, value) -> None:
    """Add ``value`` to the device-valued counter ``name[index]`` while a
    profiler records (dropped otherwise).  A tensor counts the sum of its
    entries above zero, an int itself; tensors are kept by reference and
    summed when ``counters()`` reads them."""
    if recording():
        _RECORDED[name][index].append(value)


def _total(values: list) -> int:
    ints = sum(v for v in values if isinstance(v, int))
    tensors = [v for v in values if torch.is_tensor(v)]
    if tensors:
        ints += int(torch.stack([t.long().clamp_min(0).sum() for t in tensors]).sum())
    return ints


def clear_recorded() -> None:
    """Drop the device-valued counters (the host groups stay)."""
    _RECORDED.clear()


def _settle() -> None:
    """Replace each device-valued counter's tensors by their sum (one
    sync), so the profile that recorded them holds no tensor."""
    for by_index in _RECORDED.values():
        for i, values in by_index.items():
            by_index[i] = [_total(values)]


def counters(reset: bool = False) -> dict:
    """Every counter as a plain dict: each host group by name
    (``launches``, ``exchanges``, ``pyramid_graph``), each device-valued
    counter as a list by index (``pyramid.real_points``,
    ``pyramid.budget_rows``: by level; ``pyramid.dropped_voxels``: by the
    level subsampled from).  ``reset`` drops the device-valued counters
    after the read; the host groups are zeroed by their owners
    (``kernels.reset_launches``, ``cloud.reset_exchanges``; the pyramid's
    graph calls count for the life of the process)."""
    out = {name: dict(group) for name, group in _GROUPS.items()}
    for name, by_index in _RECORDED.items():
        out[name] = [_total(by_index.get(i, [])) for i in range(max(by_index) + 1)]
    if reset:
        clear_recorded()
    return out


# ---- Reading a profile ------------------------------------------------------

def is_copy(name: str) -> bool:
    """A device copy or fill (not a kernel)."""
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def device_operations(events) -> List[tuple]:
    """The device's kernels, copies and fills in a profile's ``events()``,
    each (start us, end us, name, host start of the runtime call that
    launched it, or None): a runtime call (``cuda*`` / ``cu*``, on any host
    thread) and its device operation share the event id.  The device side
    of a profiler range (a user annotation) is not an operation; a kernel
    of the port's own (``pcrcg::...(...)``) is."""
    launches = {e.id: e.time_range.start for e in events
                if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cu")}
    return [(e.time_range.start, e.time_range.end, e.name, launches.get(e.id))
            for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def union(intervals) -> List[List[float]]:
    """Merged [start, end] intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _inside(t: Optional[float], merged, starts) -> bool:
    """Whether ``t`` lies in one of the merged intervals (``starts``: their
    starts)."""
    if t is None:
        return False
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and t <= merged[k][1]


def stage_table(events, units: int = 1) -> Dict[str, Dict[str, float]]:
    """Per ``pcrcg::`` span name in a profile's ``events()``, a unit's
    ``device_ms`` (the busy time, intervals merged, of the device
    operations whose runtime call started inside one of the name's spans,
    on any host thread: the backward's launches from autograd's thread
    count for ``backward``), ``idle_ms`` (the device's idle time inside the
    spans' host intervals) and ``kernels`` (copies and fills left out)."""
    ops = device_operations(events)
    busy = union((s, e) for s, e, _, _ in ops)
    by_name = defaultdict(list)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(PREFIX):
            by_name[e.name[len(PREFIX):]].append((e.time_range.start, e.time_range.end))
    table = {}
    for name, intervals in by_name.items():
        host = union(intervals)
        starts = [s for s, _ in host]
        mine = [(s, e, n) for s, e, n, t in ops if _inside(t, host, starts)]
        dev = sum(e - s for s, e in union((s, e) for s, e, _ in mine))
        idle = sum(e - s for s, e in host) - _overlap(host, busy)
        table[name] = {"device_ms": dev / units / 1e3, "idle_ms": idle / units / 1e3,
                       "kernels": sum(not is_copy(n) for _, _, n in mine) / units}
    return table


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile the block (CPU ops, and CUDA kernels when a card is present)
    and write ``<log_dir>/<name>``; yields the path.  ``counters()`` then
    reads the device-valued counters of this block alone."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(log_dir, name)
    clear_recorded()
    with profile(activities=activities, record_shapes=True) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    _settle()
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
