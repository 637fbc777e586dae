"""The pyramid as one CUDA graph a key (``ops/pyramid.py::graphed_pyramid``).

On the CPU: the graph key changes with each knob it lists, a CPU call never
captures and leaves the ``pyramid_graph`` counters at zero, and the eager
build is bit for bit the frozen plain copy of the benchmark's reference
(``perfbench/reference/ops/pyramid.py``) at the parity tests' budgets.

Marked ``cuda`` (skip without a card): a replay is bit for bit the eager
build on the tiled route with and without overflow, the dense route,
deformable radii and one cloud a call; a returned pyramid survives the next
replay; K1's launches and the pyramid's counters after N replays are those
of N eager calls; under a profiler the stage ``pyramid`` keeps its device
ms; a call inside a capture and a key whose capture fails run eagerly.
The module imports no JAX, so on a machine with a card:

    python -m pytest tests/test_torch_pyramid_graph.py --noconftest -o addopts="" -q
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pcrcg_tpu_torch.ops.pyramid as pyramid_mod
from pcrcg_tpu_torch import kernels
from pcrcg_tpu_torch.assets import demo_cloud_pair
from pcrcg_tpu_torch.config import Budgets, tiny_test_config
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.ops.pyramid import build_pyramid, build_pyramid_cfg, graph_key
from pcrcg_tpu_torch.utils import profiling

# The parity tests' budgets (tests/test_torch_pyramid.py): levels 0-2 take
# the pruned route and level 3 the dense fallback.
_BUDGETS = dict(points=(256, 192, 192, 96), neighbors=(16, 16, 16, 16), corr_k=8,
                query_chunk=64, search_tile=32, search_m_tiles=4)
_ZERO = {"captures": 0, "replays": 0, "eager": 0}


def _cfg(**kw):
    return tiny_test_config(budgets=Budgets(**_BUDGETS), **kw)


def _crop(p, n, at):
    """The n nearest points to the point at quantile ``at`` of the cloud's
    distance to its median: a dense patch that fits the tiny budgets."""
    d = ((p - np.median(p, 0)) ** 2).sum(1)
    centre = p[np.argsort(d, kind="stable")[int(at * (len(p) - 1))]]
    return p[np.argsort(((p - centre) ** 2).sum(1), kind="stable")[:n]]


def _inputs(at=0.0, n_src=256, n_tgt=240, device="cpu"):
    src, tgt = demo_cloud_pair()
    batch = make_pair_batch([dict(src_pcd=_crop(src, n_src, at), tgt_pcd=_crop(tgt, n_tgt, at),
                                  rot=np.eye(3), trans=np.zeros(3))],
                            _BUDGETS["points"][0], device=device)
    return batch.points[0], batch.masks[0]


def _knobs(cfg):
    conv, pool = cfg.deform_level_flags()
    if not any(conv) and not any(pool):
        conv = pool = None
    return dict(budgets=cfg.budgets, first_subsampling_dl=cfg.first_subsampling_dl,
                conv_radius=cfg.conv_radius, deform_conv=conv, deform_pool=pool,
                deform_scale=cfg.deform_radius / cfg.conv_radius)


def _leaves(pyramid, overflow=None):
    out = pyramid_mod._leaves(pyramid)
    return out if overflow is None else out + [overflow]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.equal(g, w), i


# ---- CPU ---------------------------------------------------------------------

_KEY_BASE = dict(budgets=Budgets(**_BUDGETS), first_subsampling_dl=0.025, conv_radius=2.5,
                 with_overflow=False, deform_conv=None, deform_pool=None, deform_scale=2.0)
_KEY_CHANGES = {
    "device": dict(points=torch.zeros(2, 256, 3, device="meta"),
                   mask=torch.zeros(2, 256, dtype=torch.bool, device="meta")),
    "points_shape": dict(points=torch.zeros(1, 256, 3)),
    "points_dtype": dict(points=torch.zeros(2, 256, 3, dtype=torch.float64)),
    "mask_shape": dict(mask=torch.zeros(1, 256, dtype=torch.bool)),
    "mask_dtype": dict(mask=torch.zeros(2, 256, dtype=torch.uint8)),
    "budgets": dict(budgets=Budgets(**{**_BUDGETS, "search_m_tiles": 6})),
    "budgets_route": dict(budgets=Budgets(**{**_BUDGETS, "search_impl": "dense"})),
    "first_subsampling_dl": dict(first_subsampling_dl=0.05),
    "conv_radius": dict(conv_radius=2.0),
    "with_overflow": dict(with_overflow=True),
    "deform_conv": dict(deform_conv=(True, False, False, False)),
    "deform_pool": dict(deform_pool=(False, True, False)),
    "deform_scale": dict(deform_scale=2.4),
}


@pytest.mark.parametrize("knob", sorted(_KEY_CHANGES))
def test_graph_key_changes_with_each_knob(knob):
    base = dict(points=torch.zeros(2, 256, 3), mask=torch.zeros(2, 256, dtype=torch.bool),
                **_KEY_BASE)
    key = graph_key(**base)
    assert graph_key(**base) == key and hash(graph_key(**base)) == hash(key)
    assert graph_key(**{**base, **_KEY_CHANGES[knob]}) != key


def test_a_cpu_call_never_captures():
    points, mask = _inputs()
    before = profiling.counters()["pyramid_graph"]
    pyr, overflow = build_pyramid_cfg(_cfg(), points, mask, with_overflow=True)
    assert before == profiling.counters()["pyramid_graph"] == _ZERO
    assert not pyramid_mod._GRAPHS and not pyramid_mod._FAILED
    assert pyr.points[0] is points and pyr.masks[0] is mask and overflow.shape == (3, 2)


@pytest.mark.parametrize("route", ["tiled", "dense"])
def test_eager_build_matches_the_frozen_reference(route):
    """The eager build (the CPU path, which the parity tests hold to the
    JAX package) is bit for bit the reference's frozen plain copy of the
    pyramid as it was before the graph, and records the same counters from
    its outputs."""
    from perfbench.reference.config import Budgets as RefBudgets
    from perfbench.reference.ops.pyramid import build_pyramid as ref_build_pyramid

    cfg = _cfg().replace(budgets=Budgets(**{**_BUDGETS, "search_impl": route}))
    points, mask = _inputs()
    knobs = _knobs(cfg)
    ref_budgets = RefBudgets(**dataclasses.asdict(cfg.budgets))
    want = ref_build_pyramid(points, mask, ref_budgets, knobs["first_subsampling_dl"],
                             knobs["conv_radius"], with_overflow=True)
    profiling.counters(reset=True)
    with profile(activities=[ProfilerActivity.CPU]):
        got = build_pyramid(points, mask, with_overflow=True, **knobs)
    counted = profiling.counters(reset=True)
    _assert_equal(_leaves(*got), _leaves(*want))
    assert counted["pyramid.real_points"] == [int(m.sum()) for m in got[0].masks]
    assert counted["pyramid.budget_rows"] == [m.numel() for m in got[0].masks]
    assert counted["pyramid.dropped_voxels"] == [int(o.clamp_min(0).sum()) for o in got[1]]


# ---- On the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and K1 have no CPU mode)")
    kernels.build_all(["search_distances"])
    pyramid_mod.clear_graphs()
    yield torch.device("cuda")
    pyramid_mod.clear_graphs()


def _calls():
    return dict(profiling.counters()["pyramid_graph"])


def _delta(before):
    now = _calls()
    return {k: now[k] - before[k] for k in now}


# case: (Config overrides, search route, with_overflow, one cloud a call)
_CASES = {
    "tiled": ({}, "tiled", False, False),
    "tiled_overflow": ({}, "tiled", True, False),
    "dense": ({}, "dense", True, False),
    "deformable": (dict(deformable=True, modulated=True), "tiled", True, False),
    "one_cloud": ({}, "tiled", True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_CASES))
def test_replay_is_the_eager_build_bit_for_bit(cuda, case):
    overrides, route, with_overflow, one_cloud = _CASES[case]
    cfg = _cfg(**overrides).replace(budgets=Budgets(**{**_BUDGETS, "search_impl": route}))
    before = _calls()
    for at in (0.0, 0.5, 0.9):  # the first call captures, the others replay
        points, mask = _inputs(at, device=cuda)
        if one_cloud:
            points, mask = points[1:], mask[1:]
        want = build_pyramid(points, mask, with_overflow=True, **_knobs(cfg))
        got = build_pyramid_cfg(cfg, points, mask, with_overflow=with_overflow)
        if not with_overflow:
            got = (got, want[1])
        _assert_equal(_leaves(*got), _leaves(*want))
        assert got[0].points[0] is points and got[0].masks[0] is mask
    assert _delta(before) == {"captures": 1, "replays": 2, "eager": 0}


@pytest.mark.cuda
def test_a_returned_pyramid_survives_the_next_replay(cuda):
    cfg = _cfg()
    points, mask = _inputs(0.0, device=cuda)
    first = build_pyramid_cfg(cfg, points, mask, with_overflow=True)
    kept = [t.clone() for t in _leaves(*first)]
    other_points, other_mask = _inputs(0.7, device=cuda)
    build_pyramid_cfg(cfg, other_points, other_mask, with_overflow=True)
    build_pyramid_cfg(cfg, other_points, other_mask, with_overflow=True)
    torch.cuda.synchronize()
    _assert_equal(_leaves(*first), kept)


@pytest.mark.cuda
def test_replays_count_as_eager_calls(cuda):
    """K1's launches and the pyramid's counters after N calls are those of
    N eager calls, the capturing call included."""
    cfg, n = _cfg(), 3
    points, mask = _inputs(0.2, device=cuda)
    knobs = _knobs(cfg)

    def counted(run):
        kernels.reset_launches()
        profiling.counters(reset=True)
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(n):
                run()
        torch.cuda.synchronize()
        return dict(kernels.LAUNCHES), profiling.counters(reset=True)

    eager = counted(lambda: build_pyramid(points, mask, with_overflow=True, **knobs))
    first = counted(lambda: build_pyramid_cfg(cfg, points, mask, with_overflow=True))
    replayed = counted(lambda: build_pyramid_cfg(cfg, points, mask, with_overflow=True))
    assert eager[0]["K1"] > 0
    for got in (first, replayed):
        assert got[0] == eager[0]
        for name in ("pyramid.real_points", "pyramid.budget_rows", "pyramid.dropped_voxels"):
            assert got[1][name] == eager[1][name], name


@pytest.mark.cuda
def test_the_stage_keeps_its_device_ms_under_a_profiler(cuda):
    cfg = _cfg()
    points, mask = _inputs(0.3, device=cuda)
    build_pyramid_cfg(cfg, points, mask)  # captures outside the profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            build_pyramid_cfg(cfg, points, mask)
        torch.cuda.synchronize()
    table = profiling.stage_table(prof.events(), units=2)
    assert table["pyramid"]["device_ms"] > 0 and table["pyramid"]["kernels"] > 0
    assert "pyramid.search" not in table and "pyramid.subsample" not in table


@pytest.mark.cuda
def test_a_call_inside_a_capture_runs_eagerly(cuda):
    cfg = _cfg()
    points, mask = _inputs(0.4, device=cuda)
    knobs = _knobs(cfg)
    build_pyramid(points, mask, **knobs)  # K1 loaded before the capture
    before = _calls()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = build_pyramid_cfg(cfg, points, mask, with_overflow=True)
    graph.replay()
    _assert_equal(_leaves(*got), _leaves(*build_pyramid(points, mask, with_overflow=True,
                                                        **knobs)))
    assert _delta(before) == {"captures": 0, "replays": 0, "eager": 1}
    assert not pyramid_mod._GRAPHS


@pytest.mark.cuda
def test_a_failed_capture_runs_eagerly_and_is_logged_once(cuda, monkeypatch, caplog):
    """A sync inside the build refuses the capture: the key then runs
    eagerly, with one warning, every call counted ``eager``."""
    real = pyramid_mod._subsample

    def syncing(points, mask, *a):
        out = real(points, mask, *a)
        int(out[2].sum())  # a read back to the host: not capturable
        return out

    monkeypatch.setattr(pyramid_mod, "_subsample", syncing)
    cfg = _cfg()
    points, mask = _inputs(0.6, device=cuda)
    want = build_pyramid(points, mask, with_overflow=True, **_knobs(cfg))
    before = _calls()
    with caplog.at_level("WARNING", logger=pyramid_mod.__name__):
        for _ in range(2):
            got = build_pyramid_cfg(cfg, points, mask, with_overflow=True)
            _assert_equal(_leaves(*got), _leaves(*want))
    assert _delta(before) == {"captures": 0, "replays": 0, "eager": 2}
    assert len([r for r in caplog.records if "capture failed" in r.getMessage()]) == 1
