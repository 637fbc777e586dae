"""``core/trace.py::reduce_trace``'s keys with the program's ``pcrcg::``
ranges in a synthetic event list and without them, and the program's
counters in a traced run (``core/counters.py``).  The per-span device and
idle time is the program's own rule (``utils/profiling.py::stage_table``,
tested in ``tests/test_torch_tracing.py``)."""
from types import SimpleNamespace

import torch

from perfbench.core import counters, trace
from perfbench.tests.tiny import make_tree, run_cell

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, thread=1, id_=0, parent=None, annotation=None):
    e = SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                        device_type=device, thread=thread, id=id_, cpu_parent=parent,
                        cpu_children=[], sequence_nr=-1, device_time_total=0.0,
                        is_user_annotation=(name.startswith(("pcrcg::", "perfbench::"))
                                            if annotation is None else annotation))
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def unit_events():
    """One unit in a window [0, 1000]: the batch, then the root with the
    stages pyramid (a child search, an idle gap with no host op) and
    backward (its kernel launched from autograd's thread 2), and a kernel
    launched after the root, inside no stage, and an idle gap outside
    every span.  The pyramid's kernel is one of the port's own, whose name
    begins as the ranges' do, and is no range."""
    w = ev("perfbench::window", 0, 1000)
    batch = ev("pcrcg::batch", 0, 100, parent=w)
    root = ev("pcrcg::register_pair", 100, 800, parent=w)
    pyr = ev("pcrcg::pyramid", 100, 400, parent=root)
    search = ev("pcrcg::pyramid.search", 150, 300, parent=pyr)
    bwd = ev("pcrcg::backward", 400, 800, parent=root)
    copy_op = ev("aten::copy_", 10, 90, parent=batch)
    op = ev("aten::mm", 160, 200, parent=search)
    tail = ev("aten::add", 850, 860, parent=w)
    return [
        w, batch, root, pyr, search, bwd, copy_op, op, tail,
        ev("cudaMemcpyAsync", 20, 30, id_=5, parent=copy_op),
        ev("Memcpy HtoD (Pageable -> Device)", 30, 90, device=CUDA, id_=5),
        ev("cudaLaunchKernel", 170, 180, id_=7, parent=op),
        ev("pcrcg::search_kernel(float const*)", 180, 300, device=CUDA, id_=7,
           annotation=False),
        ev("pcrcg::pyramid", 180, 300, device=CUDA),  # the range's device side
        ev("cudaLaunchKernel", 450, 460, thread=2, id_=9),
        ev("kernel_b", 460, 700, device=CUDA, id_=9),
        ev("cudaLaunchKernel", 852, 858, id_=11, parent=tail),
        ev("kernel_c", 858, 900, device=CUDA, id_=11),
    ]


def is_program_range(e):
    """A program span's event: its host range, or its device side."""
    return e.name.startswith("pcrcg::") and (e.device_type == CPU or e.is_user_annotation)


def test_reduce_trace_keys_do_not_move_with_the_spans():
    events = unit_events()
    plain = [e for e in events if not is_program_range(e)]
    assert len(plain) == len(events) - 6  # the port's kernel stays
    with_spans, without = trace.reduce_trace(events, 1), trace.reduce_trace(plain, 1)
    assert {k: v for k, v in with_spans.items() if k != "idle_gaps"} == \
        {k: v for k, v in without.items() if k != "idle_gaps"}
    # The idle gaps with no host op now carry the stage's name.
    assert dict(with_spans["idle_gaps"])["pcrcg::backward"] > 0
    assert "pcrcg::backward" not in dict(without["idle_gaps"])


def test_real_rows_share():
    read = {"pyramid.real_points": [30, 10], "pyramid.budget_rows": [60, 20]}
    assert counters.real_rows_share(read) == 50.0
    assert counters.real_rows_share(None) is None
    assert counters.real_rows_share({"launches": {}}) is None


def test_a_traced_run_reports_the_rows_share(tmp_path, capsys):
    """The share is read, the device-valued counters dropped with it, and
    the program's host groups (its kernel launches) left as they are."""
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch.utils import profiling

    root = make_tree(tmp_path)
    kernels.reset_launches()
    kernels.count_launch("K2")
    metrics = run_cell(root, "tg.register", capsys, trace=1)["metrics"]
    assert 0.0 < metrics["real_rows_share.serve"]["value"] <= 100.0
    after = profiling.counters()
    assert not [k for k in after if k.startswith("pyramid.")]
    assert after["launches"]["K2"] >= 1
