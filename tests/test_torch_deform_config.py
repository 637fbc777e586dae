"""The deformable KITTI configuration (``perfbench/configs/
pcrcg_kitti_deform.json``: kitti.yaml with KPConv's deformable layout, the
last five encoder blocks deformable) on the CPU, at tiny widths.

* The layout's ``deform_level_flags()`` are the same in the port's and the
  frozen reference's ``Config``, and widen the conv searches of levels 2-3
  and the pool search into level 3.
* The port against the reference (``perfbench/reference/``, its
  deformable conv in ``models/deform.py``) with the harness's seeded
  weights, each on its own pyramid of a small LiDAR pair: descriptors and
  scores within 1e-5 of the largest reference entry; the loss stats at
  rtol 1e-4 and one ``train_step``'s gradients at
  ``tests/test_torch_train.py``'s rule (‖Δg‖ ≤ 1e-3·‖g‖ + 1e-6·max_p ‖g_p‖),
  on a pair whose gradients that rule can hold (see ``tiny``).
* The reference's ``kpconv_deformable`` against a direct loop over the
  queries, neighbors and kernel points, written from KPConv's equations.
* The ``deform.*`` counters on a hand-built case, and the ``deform.offset``
  / ``deform.conv`` spans under the encoder's, under a CPU profiler.
* ``calibrate_budgets`` counts a deformable level at the widened radius and
  leaves the rigid levels as they were.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch import native
from pcrcg_tpu_torch.data.calibrate import calibrate_budgets
from pcrcg_tpu_torch.models.kpconv import kpconv_deformable
from pcrcg_tpu_torch.ops.masked import PAD_COORD
from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
from pcrcg_tpu_torch.utils import profiling
from perfbench.core import files, program, weights
from perfbench.reference import pipeline
from perfbench.reference.models import deform
from perfbench.tests.tiny import GEOMETRY, TRAFFIC

ROOT = Path(__file__).resolve().parent.parent
SECTIONS = json.loads((ROOT / "perfbench" / "configs" / "pcrcg_kitti_deform.json").read_text())
ARCH = SECTIONS["model"]["architecture"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_sections():
    s = json.loads(json.dumps(GEOMETRY))
    s["model"]["architecture"] = ARCH
    return s


def test_layout_flags_agree():
    port = program.port_config(SECTIONS)
    ref = pipeline.config_from_sections(SECTIONS)
    flags = ((False, False, True, True), (False, False, True))
    assert port.deform_level_flags() == ref.deform_level_flags() == flags
    assert port.architecture == ref.architecture == ARCH
    assert port.budgets.neighbors == ref.budgets.neighbors
    kitti = json.loads((ROOT / "perfbench" / "configs" / "pcrcg_kitti.json").read_text())
    for key in ("first_feats_dim", "gnn_feats_dim", "final_feats_dim", "num_kernel_points",
                "KP_extent", "conv_radius", "deform_radius", "modulated"):
        assert SECTIONS["model"][key] == kitti["model"][key], key


def _reference_grads(rcfg, state, sample, uniforms):
    """The reference's first gradients on one pair: (names, gradients, stats)."""
    dev = torch.device("cpu")
    ref = deform.build_model(rcfg, state, dev)
    leaves = [p for p in ref.parameters() if p.requires_grad]
    names = [n for n, p in ref.named_parameters() if p.requires_grad]
    stats, grads = pipeline.train_step(ref, leaves, torch.optim.SGD(leaves, lr=0.0), rcfg,
                                       pipeline.pair_batch(sample, rcfg, dev), uniforms)
    return names, grads, stats


def _gradient_gap(got, want) -> float:
    """The worst leaf's ‖Δg‖ over its bound 1e-3·‖g‖ + 1e-6·max_p ‖g_p‖."""
    floor = 1e-6 * max(float(g.norm()) for g in want)
    return max(float((g - w).norm()) / (1e-3 * float(w.norm()) + floor)
               for g, w in zip(got, want))


# A denser drive than the harness tests' tiny one: its pair's gradients are
# well conditioned (see ``tiny``).
LIDAR = dict(TRAFFIC["tiny_lidar"], pairs=1, rays=12000, voxel=0.75)


@pytest.fixture(scope="module")
def tiny():
    """The tiny deformable configuration on both sides, the harness's seeded
    weights and one small LiDAR pair with its circle-loss draws.  The pair
    is one whose reference gradients move by well under the gradient rule's
    bound when the weights move by one rounding unit (0.1 of it here).  The
    tiny drive of ``perfbench/tests/tiny.py`` has none: there one rounding
    unit moves them by 0.01 to 7.6 times the bound, pair by pair and
    perturbation by perturbation, so no implementation could be held to
    the rule on it."""
    sections = _tiny_sections()
    dev = torch.device("cpu")
    cfg = program.port_config(sections)
    rcfg = pipeline.config_from_sections(sections)
    state = weights.seeded_state(program.model_shapes(cfg), 11, dev)
    (sample,) = files.make_pool(LIDAR, 12, dev, images=False)
    uniforms = program.draws(cfg, sample, torch.Generator().manual_seed(13), dev, True)["uniforms"]
    names, grads, stats = _reference_grads(rcfg, state, sample, uniforms)
    gen = torch.Generator().manual_seed(14)
    nudged = {k: v * (1 + 2.0**-23 * torch.randn(v.shape, generator=gen)) for k, v in state.items()}
    assert _gradient_gap(_reference_grads(rcfg, nudged, sample, uniforms)[1], grads) < 0.25
    return cfg, rcfg, state, sample, uniforms, (names, grads, stats)


def _close(got, want, tol):
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_forward_matches_the_reference(tiny):
    cfg, rcfg, state, sample, _, _ = tiny
    dev = torch.device("cpu")
    model = program.build_model(cfg, state, dev)
    batch = program.make_batch(sample, cfg, dev)
    points, masks, feats = batch.points[0], batch.masks[0], batch.features[0]
    with torch.no_grad():
        out = model(build_pyramid_cfg(cfg, points, masks), feats)
        ref = deform.build_model(rcfg, state, dev)
        rb = pipeline.pair_batch(sample, rcfg, dev)
        want, _, _ = pipeline.forward(ref, rcfg, rb.points[0], rb.masks[0], rb.features[0])
    m = masks
    for key in ("feats_f", "scores_overlap", "scores_saliency"):
        assert _close(out[key][m], want[key][m], 1e-5), key


def test_loss_and_gradients_match_the_reference(tiny):
    cfg, rcfg, state, sample, uniforms, (rnames, ref_grads, ref_stats) = tiny
    dev = torch.device("cpu")
    model = program.build_model(cfg, state, dev)
    ts = program.train_state(cfg, model, 1000)
    names = {id(p): weights.canonical(n, False) for n, p in model.named_parameters()}
    grads = {}
    for p in ts.params:
        p.register_hook(lambda g, n=names[id(p)]: grads.__setitem__(n, g.clone()))
    stats = program.train_step(ts, cfg, program.make_batch(sample, cfg, dev), uniforms, None)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    assert sum("offset_conv" in n for n in rnames) == 5
    got = [grads.get(n, torch.zeros_like(w)) for n, w in zip(rnames, ref_grads)]
    assert _gradient_gap(got, ref_grads) <= 1.0


def _loop_deformable(q, s, inds, x, kp, w, extent, offsets):
    """KPConv's deformable conv, one query, neighbor and kernel point at a
    time (float64): linear influence max(0, 1 - |y - (q + k + Δk)| / σ),
    neighbors farther than σ from every deformed point dropped, the sum
    over neighbors and kernel points of influence · x W, over the count of
    the kept neighbors whose features sum above zero."""
    q, s, x, kp, w, offsets = (np.asarray(t, np.float64) for t in (q, s, x, kp, w, offsets))
    out = np.zeros((len(q), w.shape[2]))
    for n in range(len(q)):
        count = 0
        for h in inds[n]:
            if h >= len(s):
                continue
            y = s[h] - q[n]
            d = [np.linalg.norm(y - (kp[k] + offsets[n, k])) for k in range(len(kp))]
            if min(d) ** 2 >= extent**2:
                continue
            count += x[h].sum() > 0
            for k in range(len(kp)):
                out[n] += max(0.0, 1.0 - d[k] / extent) * (x[h] @ w[k])
        out[n] /= max(count, 1)
    return out


def test_reference_deformable_conv_against_a_loop():
    rng = np.random.default_rng(3)
    nq, ns, h, c, d, k, extent = 12, 20, 6, 4, 3, 5, 0.3
    s = rng.uniform(0, 1, (ns, 3)).astype(np.float32)
    q = s[:nq] + rng.normal(0, 0.05, (nq, 3)).astype(np.float32)
    inds = rng.integers(0, ns + 1, (nq, h))
    x = rng.normal(size=(ns, c)).astype(np.float32)
    kp = (rng.normal(0, 0.15, (k, 3))).astype(np.float32)
    w = rng.normal(size=(k, c, d)).astype(np.float32)
    offsets = rng.normal(0, 0.15, (nq, k, 3)).astype(np.float32)
    got = deform.kpconv_deformable(*(torch.from_numpy(t) for t in (q, s, inds, x, kp, w)),
                                   extent, torch.from_numpy(offsets))
    want = _loop_deformable(q, s, inds, x, kp, w, extent, offsets)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_deform_counters_on_a_hand_built_case():
    s = torch.tensor([[0.0, 0, 0], [0.5, 0, 0], [3.0, 0, 0]])
    q = torch.tensor([[0.0, 0, 0], [3.0, 0, 0], [PAD_COORD] * 3])  # the last: a pad query
    inds = torch.tensor([[0, 1, 2], [2, 3, 3], [3, 3, 3]])  # 3: the shadow
    x = torch.ones(3, 2)
    kp = torch.zeros(1, 3)
    w = torch.ones(1, 2, 1)
    # Query 0's kernel point moves to -0.8 along x: 0 stays within 1.0,
    # 0.5 (1.3 away) and 3.0 leave; query 1 keeps its one real neighbor;
    # the pad query's shadows lie on it, in range, and are not neighbors.
    offsets = torch.tensor([[[-0.8, 0, 0]], [[0.0, 0, 0]], [[0.0, 0, 0]]])
    profiling.counters(reset=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = kpconv_deformable(q, s, inds, x, kp, w, 1.0, offsets, level=2)
    got = profiling.counters(reset=True)
    assert got["deform.real_neighbors"] == [0, 0, 4]
    assert got["deform.kept_neighbors"] == [0, 0, 2]
    assert got["deform.cap_rows"] == [0, 0, 9]
    torch.testing.assert_close(out, torch.tensor([[2 * 0.2], [2 * 1.0], [0.0]]))
    kpconv_deformable(q, s, inds, x, kp, w, 1.0, offsets, level=2)  # no profiler
    assert not [k for k in profiling.counters() if k.startswith("deform.")]


def test_deform_spans_nest_under_the_encoder(tiny):
    cfg, _, state, sample, _, _ = tiny
    dev = torch.device("cpu")
    model = program.build_model(cfg, state, dev)
    batch = program.make_batch(sample, cfg, dev)
    pyramid = build_pyramid_cfg(cfg, batch.points[0], batch.masks[0])
    profiling.counters(reset=True)
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(pyramid, batch.features[0])
    spans = {}
    for e in prof.events():
        if e.name.startswith(profiling.PREFIX):
            spans.setdefault(e.name[len(profiling.PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    (enc,) = spans["kpfcnn.encoder"]
    for name in ("deform.offset", "deform.conv"):
        assert len(spans[name]) == 5, name  # the five deformable blocks
        assert all(enc[0] <= a and b <= enc[1] for a, b in spans[name]), name
    got = profiling.counters(reset=True)
    # Queries at level 2 (two convs) and level 3 (the strided conv, two more).
    assert [i for i, v in enumerate(got["deform.cap_rows"]) if v] == [2, 3]
    for level in (2, 3):
        assert 0 < got["deform.kept_neighbors"][level] <= got["deform.real_neighbors"][level]
        assert got["deform.real_neighbors"][level] <= got["deform.cap_rows"][level]


def test_calibration_counts_deformable_levels_at_the_widened_radius():
    rng = np.random.default_rng(5)
    clouds = [np.concatenate([rng.uniform(0, 2, (n, 2)), rng.uniform(0, 0.2, (n, 1))],
                             1).astype(np.float32) for n in (3000, 2500)]
    data = [{"src_pcd": clouds[0], "tgt_pcd": clouds[1]}]
    deformable = tcfg.tiny_test_config(architecture_list=tuple(ARCH))
    rigid = tcfg.tiny_test_config(architecture_list=tuple(
        b.replace("_deformable", "") for b in ARCH))
    got = calibrate_budgets(data, deformable, num_samples=1).neighbors
    plain = calibrate_budgets(data, rigid, num_samples=1).neighbors
    assert got[:2] == plain[:2]
    # Counted directly: level ℓ's points (grid subsampled at dl = 2r/conv_radius)
    # within r_ℓ·deform_radius/conv_radius of each other, both clouds.
    scale = deformable.deform_radius / deformable.conv_radius
    r = deformable.first_subsampling_dl * deformable.conv_radius
    counts = {2: [], 3: []}
    for pts in clouds:
        lvl_r, level_pts = r, pts
        for level in range(4):
            if level in counts:
                tree = cKDTree(level_pts)
                counts[level] += tree.query_ball_point(level_pts, lvl_r * scale,
                                                       return_length=True).tolist()
            level_pts = native.grid_subsample(level_pts, 2.0 * lvl_r / deformable.conv_radius)
            lvl_r *= 2.0
    for level in (2, 3):
        assert got[level] == max(int(np.quantile(counts[level], 0.8)), 8), level
        assert got[level] > plain[level], level
