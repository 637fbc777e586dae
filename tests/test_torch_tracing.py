"""The port's tracing (``pcrcg_tpu_torch/utils/profiling.py``) on the CPU:
the ``pcrcg::`` spans of ``register_pair`` and ``train_step`` under
``torch.profiler``, nothing recorded without a profiler, outputs that do
not depend on tracing, the pyramid's counters, the counter registry's host
groups, the Chrome trace of ``trace(dir)`` and ``stage_table``'s rule on a
synthetic event list.  ``tiny_test_config`` sizes: a few seconds in all."""
from __future__ import annotations

import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pcrcg_tpu_torch import kernels
from pcrcg_tpu_torch.config import Budgets, tiny_test_config
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.eval.tester import register_pair
from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
from pcrcg_tpu_torch.parallel import cloud
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import train_step
from pcrcg_tpu_torch.utils import profiling

REGISTER_STAGES = ["pyramid", "kpfcnn", "registration"]
TRAIN_STAGES = ["pyramid", "forward", "loss", "backward", "optimizer"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sample():
    """The demo pair cut to 250 points a cloud (under the tiny budget)."""
    from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose

    src, tgt = demo_cloud_pair()
    rng = np.random.default_rng(0)
    rot, trans = demo_pair_gt_pose()
    return dict(src_pcd=src[rng.choice(len(src), 250, replace=False)],
                tgt_pcd=tgt[rng.choice(len(tgt), 250, replace=False)], rot=rot, trans=trans)


@pytest.fixture(scope="module")
def cfg():
    return tiny_test_config(budgets=Budgets(points=(256, 192, 192, 96),
                                            neighbors=(16, 16, 16, 16), corr_k=8,
                                            query_chunk=64, search_tile=32,
                                            search_m_tiles=4))


def _register(model, cfg, sample):
    batch = make_pair_batch([sample], cfg.budgets.points[0])
    return register_pair(model, cfg, batch.points[0], batch.masks[0], batch.features[0],
                         torch.Generator().manual_seed(0), n_points=32, num_iterations=64,
                         hypothesis_chunk=64, device="cpu")


def _step(cfg, sample):
    """One train_step from the seeded weights: its stats and the updated
    parameters."""
    state = TrainState(cfg, init_kpfcnn(cfg, seed=0, device="cpu"))
    batch = make_pair_batch([sample], cfg.budgets.points[0])
    stats = train_step(state, cfg, batch, generator=torch.Generator().manual_seed(0))
    return stats, [p.detach().clone() for p in state.params]


def _profiled(fn):
    """``fn()`` under the profiler (CPU, shapes recorded) -> its result and
    the ``pcrcg::`` ranges: name (prefix off), start, end, thread, the unit
    number (a concrete input) or None, and the innermost enclosing range."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    spans = sorted((SimpleNamespace(name=e.name()[len(profiling.PREFIX):], start=e.start_ns(),
                                    end=e.end_ns(), thread=e.start_thread_id(),
                                    unit=(e.concrete_inputs() or [None])[0])
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(profiling.PREFIX)
                    and e.device_type() == torch.autograd.DeviceType.CPU),
                   key=lambda e: (e.start, -e.end))
    for i, e in enumerate(spans):
        outer = [o for o in spans[:i] if o.thread == e.thread and o.end >= e.end]
        e.parent = outer[-1] if outer else None
    return out, spans


@pytest.fixture(scope="module")
def registered(cfg, sample):
    """register_pair untraced, then twice in one profile."""
    model = init_kpfcnn(cfg, seed=0, device="cpu")
    plain = _register(model, cfg, sample)
    traced, spans = _profiled(lambda: [_register(model, cfg, sample) for _ in range(2)])
    return plain, traced[0], spans


@pytest.fixture(scope="module")
def stepped(cfg, sample):
    """train_step untraced, then traced, each from the same weights."""
    return _step(cfg, sample), *_profiled(lambda: _step(cfg, sample))


def test_register_pair_spans(registered):
    _, _, spans = registered
    roots = [e for e in spans if e.name == "register_pair"]
    batches = [e for e in spans if e.name == "batch"]
    assert len(roots) == len(batches) == 2
    assert roots[1].unit == roots[0].unit + 1
    for root, batch in zip(roots, batches):
        stages = [e for e in spans if e.parent is root]
        assert [e.name for e in stages] == REGISTER_STAGES
        assert batch.parent is None and batch.end <= root.start
        assert {e.unit for e in stages + [batch]} == {root.unit}
        parts = {e.name for e in spans if e.parent in stages}
        assert parts == {"pyramid.subsample", "pyramid.search", "kpfcnn.encoder",
                         "kpfcnn.gcn", "kpfcnn.decoder", "registration.sampling",
                         "registration.matching", "registration.ransac"}
    assert all(e.unit is None for e in spans if "." in e.name)


def test_train_step_spans(stepped):
    _, _, spans = stepped
    roots = [e for e in spans if e.name == "train_step"]
    assert len(roots) == 1
    stages = [e for e in spans if e.parent is roots[0]]
    assert [e.name for e in stages] == TRAIN_STAGES
    assert {e.unit for e in stages} == {roots[0].unit}
    under = {e.name: e.parent.name for e in spans if e.parent is not None}
    assert under["kpfcnn"] == "forward" and under["kpfcnn.gcn"] == "kpfcnn"
    assert under["optimizer.finite_gate"] == "optimizer"


def test_nothing_recorded_without_a_profiler(cfg, sample):
    profiling.counters(reset=True)
    model = init_kpfcnn(cfg, seed=0, device="cpu")
    with profiling.span("x", unit=3) as s:
        assert s._handle is None
    _register(model, cfg, sample)
    assert not [k for k in profiling.counters() if k.startswith("pyramid.")]


def test_outputs_do_not_depend_on_tracing(registered, stepped):
    plain, traced, _ = registered
    assert torch.equal(plain["transform"], traced["transform"])
    for k, v in plain["outputs"].items():
        assert torch.equal(v, traced["outputs"][k]), k
    (stats0, params0), (stats1, params1), _ = stepped
    assert all(torch.equal(stats0[k], stats1[k]) for k in stats0)
    assert all(torch.equal(a, b) for a, b in zip(params0, params1))


def test_pyramid_counters(cfg, sample):
    """real_points are the masks' sums, budget_rows their sizes and
    dropped_voxels the overflow's positive part, level for level (level 1's
    budget cut to 64 points, so voxels drop)."""
    tight = cfg.replace(budgets=Budgets(points=(256, 64, 64, 32), neighbors=(16, 16, 16, 16),
                                        corr_k=8, query_chunk=64))
    batch = make_pair_batch([sample], tight.budgets.points[0])
    profiling.counters(reset=True)
    with profile(activities=[ProfilerActivity.CPU]):
        pyr, overflow = build_pyramid_cfg(tight, batch.points[0], batch.masks[0],
                                          with_overflow=True)
    got = profiling.counters(reset=True)
    assert got["pyramid.real_points"] == [int(m.sum()) for m in pyr.masks]
    assert got["pyramid.budget_rows"] == [m.numel() for m in pyr.masks]
    assert got["pyramid.dropped_voxels"] == [int(o.clamp_min(0).sum()) for o in overflow]
    assert got["pyramid.dropped_voxels"][0] > 0
    assert not [k for k in profiling.counters() if k.startswith("pyramid.")]


def test_host_groups_read_through_the_registry():
    kernels.reset_launches()
    cloud.reset_exchanges()
    kernels.count_launch("K2")
    kernels.count_launch("K2")
    cloud.EXCHANGES["gather"] += 1
    got = profiling.counters()
    assert got["launches"] == dict(kernels.LAUNCHES) and got["launches"]["K2"] == 2
    assert got["exchanges"] == dict(cloud.EXCHANGES) == {"psum": 0, "gather": 1}
    # A reset drops the device-valued counters alone: the host groups'
    # owners zero them.
    profiling.counters(reset=True)
    assert kernels.LAUNCHES["K2"] == 2 and cloud.EXCHANGES["gather"] == 1
    kernels.reset_launches()
    cloud.reset_exchanges()
    assert profiling.counters()["launches"]["K2"] == 0


def test_trace_writes_the_spans(cfg, sample, tmp_path):
    """The Chrome trace holds the ranges; ``counters()`` then reads this
    block's pyramid alone (an earlier profile's record is dropped), from
    sums that hold no tensor."""
    model = init_kpfcnn(cfg, seed=0, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.record("pyramid.real_points", 0, 10**6)
    with profiling.trace(str(tmp_path)) as path:
        _register(model, cfg, sample)
    held = [v for by_level in profiling._RECORDED.values() for values in by_level.values()
            for v in values]
    assert held and not any(torch.is_tensor(v) for v in held)
    assert 0 < profiling.counters(reset=True)["pyramid.real_points"][0] <= 2 * 256
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"pcrcg::batch", "pcrcg::register_pair", "pcrcg::pyramid", "pcrcg::kpfcnn",
            "pcrcg::registration", "pcrcg::registration.ransac"} <= names
    root = next(e for e in events if e.get("name") == "pcrcg::register_pair")
    assert root["args"]["Concrete Inputs"][0].isdigit()


def test_stage_numbers_by_thread():
    """Inside a unit a stage carries its number; outside one, on the main
    thread, the next unit's; on another thread (a loader's worker) none."""
    seen = {}

    def worker():
        seen["worker"] = profiling.stage("batch").unit

    with profiling.unit_span("register_pair") as root:
        seen["inside"] = profiling.stage("pyramid").unit
        thread = threading.Thread(target=worker)
        thread.start()
        thread.join()
    assert seen == {"inside": root.unit, "worker": None}
    assert profiling.stage("batch").unit == root.unit + 1


def _ev(name, start, end, device="cpu", thread=1, id_=0, annotation=False):
    dev = torch.autograd.DeviceType.CUDA if device == "cuda" else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=dev, thread=thread, id=id_,
                           is_user_annotation=annotation)


def test_stage_table_rule():
    """A kernel counts for the span its runtime call started in, whatever
    thread made the call; idle is the device's idle time inside the span;
    the device side of a range is no operation; a copy is no kernel."""
    events = [
        _ev("pcrcg::pyramid", 0, 100),
        _ev("cudaLaunchKernel", 10, 12, id_=7),
        _ev("pcrcg::k_a(float const*)", 20, 50, device="cuda", id_=7),  # the port's kernel
        _ev("pcrcg::pyramid", 20, 90, device="cuda", annotation=True),
        _ev("pcrcg::backward", 100, 200),
        _ev("cudaLaunchKernel", 120, 121, thread=2, id_=9),  # autograd's thread
        _ev("k_b", 150, 190, device="cuda", id_=9),
        _ev("cudaMemcpyAsync", 195, 196, id_=11),
        _ev("Memcpy HtoD", 196, 198, device="cuda", id_=11),
        _ev("cudaLaunchKernel", 210, 211, id_=13),  # outside every span
        _ev("k_c", 212, 230, device="cuda", id_=13),
    ]
    table = profiling.stage_table(events, units=2)
    assert table["pyramid"] == {"device_ms": 30 / 2e3, "idle_ms": 70 / 2e3, "kernels": 0.5}
    # backward: k_b (40) and the copy (2) busy; idle 100 - 40 - 2.
    assert table["backward"] == {"device_ms": 42 / 2e3, "idle_ms": 58 / 2e3, "kernels": 0.5}
