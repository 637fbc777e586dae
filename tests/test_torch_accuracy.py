"""The port's accuracy-evidence loop (``pcrcg_tpu_torch/accuracy.py``)
against ``scripts/train_synthetic_register.py``: the copied helpers give
the script's pairs on the same numpy seeds (the 16 held-out pairs' overlap
equal to the JAX runs' committed ``eval_overlap``), a few tiny training
steps lower the loss, a tiny run writes the JSONL schema, and the
committed H100 trajectories clear the gate: a median held-out recall over
the evals from step 1000 on of at least the JAX run's median less two of
its 16-pair eval quanta (geometry: 0.75 - 0.125; ``--images``: 0.375 -
0.125), at least two quanta above the run's own untrained step-0 recall
(an untrained model's evals all equal its step 0), and a mean circle loss
over the last third within 0.1 of the JAX run's (a model stuck at the
first third's level fails).
"""
import json
import os
import statistics
import sys

import numpy as np
import pytest
import torch

from pcrcg_tpu_torch import accuracy
from pcrcg_tpu_torch.assets import demo_cloud_pair
from pcrcg_tpu_torch.config import Budgets, tiny_test_config
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_synthetic_register as script  # noqa: E402

# Each H100 run with a JAX run's flags -> (that JAX run, the median floor).
# Geometry: the first run, a second seed, and the first seed again; the
# color model: two seeds.
JAX_GEOM = os.path.join(REPO, "perf_runs", "accuracy_evidence_45h_geom.jsonl")
JAX_IMAGES = os.path.join(REPO, "perf_runs", "accuracy_evidence_45h_images.jsonl")
TORCH_RUNS = {
    "torch_accuracy_evidence_45h_geom.jsonl": (JAX_GEOM, 0.625),
    "torch_accuracy_evidence_45h_geom_seed8.jsonl": (JAX_GEOM, 0.625),
    "torch_accuracy_evidence_45h_geom_rerun.jsonl": (JAX_GEOM, 0.625),
    "torch_accuracy_evidence_45h_images.jsonl": (JAX_IMAGES, 0.25),
    "torch_accuracy_evidence_45h_images_seed8.jsonl": (JAX_IMAGES, 0.25),
}
# A JAX run with the same flags whose start line records eval_overlap.
JAX_OVERLAP_RUN = os.path.join(REPO, "perf_runs", "accuracy_evidence_45h_geom_long.jsonl")


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_helpers_match_the_script():
    cloud = demo_cloud_pair()[1]
    for seed in range(4):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        assert np.array_equal(accuracy.random_rotation(a, 30.0), script.random_rotation(b, 30.0))
        got = accuracy.make_synthetic_pair(cloud, a, max_rot_deg=45.0, resample_frac=0.85)
        want = script.make_synthetic_pair(cloud, b, max_rot_deg=45.0, resample_frac=0.85)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        t = np.eye(4, dtype=np.float32)
        t[:3, :3] = accuracy.random_rotation(a, 10.0)
        assert accuracy.protocol_rmse(t, got[2], got[3], got[0]) == script.protocol_rmse(
            t, got[2], got[3], got[0])


def test_held_out_pairs_match_the_jax_runs():
    """The 16 held-out pairs of ``--max-rot-deg 45 --resample-frac 0.85``
    from their per-pair seeds: each equal to the script's on the same seed,
    and their overlap equal to the committed JAX runs' ``eval_overlap``."""
    clouds = list(demo_cloud_pair())
    pairs = []
    for i in range(16):
        a, b = np.random.default_rng(12345 + 1000 * i), np.random.default_rng(12345 + 1000 * i)
        got = accuracy.synthetic_sample(clouds, a, 45.0, 0.85)
        want = script.make_synthetic_pair(clouds[int(b.integers(0, 2))], b, max_rot_deg=45.0,
                                          resample_frac=0.85)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        pairs.append(got[:4])
    start = _events(JAX_OVERLAP_RUN)[0]
    assert (start["n_eval"], start["max_rot_deg"], start["resample_frac"]) == (16, 45.0, 0.85)
    assert accuracy.eval_overlaps(pairs) == start["eval_overlap"]


def test_a_few_tiny_steps_lower_the_loss():
    """Eight Adam steps on one synthetic pair (tiny widths, the loss's draws
    from one seed every step): the last total is over 0.05 below the first."""
    torch.manual_seed(0)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = tiny_test_config(optimizer="Adam", lr=1e-3, budgets=Budgets(
            points=(512, 448, 256, 128), neighbors=(16,) * 4, corr_k=8, query_chunk=64,
            search_tile=32, search_m_tiles=4))
        src, tgt, rot, trans, _, _ = accuracy.make_synthetic_pair(
            demo_cloud_pair()[1][::40], np.random.default_rng(3), max_rot_deg=30.0)
        batch = make_pair_batch([dict(src_pcd=src, tgt_pcd=tgt, rot=rot, trans=trans)], 512)
        state = TrainState(cfg, init_kpfcnn(cfg, seed=1, device="cpu"))
        totals = [float(train_step(state, cfg, batch,
                                   generator=torch.Generator().manual_seed(0))["total"])
                  for _ in range(8)]
    finally:
        torch.set_num_threads(n_threads)
    assert all(np.isfinite(totals))
    assert totals[-1] < totals[0] - 0.05, totals


def test_tiny_run_writes_the_schema(tmp_path):
    out = tmp_path / "run.jsonl"
    base = tiny_test_config(budgets=Budgets(points=(512, 448, 256, 128), neighbors=(16,) * 4,
                                            corr_k=8, query_chunk=64, search_tile=32,
                                            search_m_tiles=4))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        final = accuracy.main(["--steps", "2", "--eval-every", "1", "--n-eval", "1",
                               "--n-points", "64", "--budget", "1024", "--pair-pool", "2",
                               "--device", "cpu", "--out", str(out),
                               "--save-params", str(tmp_path / "w.pt")], base=base)
    finally:
        torch.set_num_threads(n_threads)
    events = _events(out)
    assert [e["event"] for e in events] == ["start", "eval", "eval", "eval", "final"]
    assert [e["step"] for e in events[1:]] == [0, 1, 2, 2]
    assert len(events[0]["eval_overlap"]) == 1 and events[0]["pair_pool"] == 2
    assert final["recall"] == events[-1]["recall"] and 0.0 <= final["recall"] <= 1.0
    assert all(np.isfinite(e["rmse"]).all() for e in events[1:])
    state = torch.load(tmp_path / "w.pt", weights_only=True)
    assert "epsilon" in state


def _late_circle(events):
    """Mean circle loss of the train events over the run's last third."""
    steps = events[0]["steps"]
    return statistics.mean(e["circle"] for e in events
                           if e["event"] == "train" and e["step"] > 2 * steps // 3)


@pytest.mark.parametrize("name", sorted(TORCH_RUNS))
def test_committed_h100_trajectory_clears_the_gate(name):
    jax_run, floor = TORCH_RUNS[name]
    events = _events(os.path.join(REPO, "perf_runs", name))
    jax_events = _events(jax_run)
    start, jax_start = events[0], jax_events[0]
    for k in ("steps", "budget", "lr", "optimizer", "n_eval", "max_rot_deg", "resample_frac",
              "pair_pool", "images"):
        assert start[k] == jax_start[k], k
    assert start["device_name"].startswith("NVIDIA H100")
    # The held-out pairs do not depend on the seed.
    assert start["eval_overlap"] == _events(JAX_OVERLAP_RUN)[0]["eval_overlap"]
    assert events[-1]["event"] == "final" and events[-1]["step"] == start["steps"]
    evals = [e for e in events if e["event"] == "eval"]
    assert [e["step"] for e in evals] == list(range(0, 3001, 250))
    assert all(len(e["rmse"]) == 16 for e in evals)
    late = statistics.median(e["recall"] for e in evals if e["step"] >= 1000)
    late_jax = statistics.median(e["recall"] for e in jax_events
                                 if e["event"] == "eval" and e["step"] >= 1000)
    assert floor == late_jax - 2 / 16
    assert late >= floor, late
    assert late >= evals[0]["recall"] + 2 / 16, (late, evals[0]["recall"])
    train = [e for e in events if e["event"] == "train"]
    assert len(train) == 60 and all(np.isfinite([e["total"], e["circle"]]).all() for e in train)
    assert _late_circle(events) <= _late_circle(jax_events) + 0.1, (
        _late_circle(events), _late_circle(jax_events))


@pytest.mark.parametrize("flag", ["--search-exact", "--recall-target"])
def test_dropped_flags_are_refused(flag):
    """The port's search is always exact: the script's approximate-search
    flags are not accepted."""
    with pytest.raises(SystemExit):
        accuracy.parse_args([flag])
