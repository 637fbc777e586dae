"""The port's 3DMatch protocol (``eval/benchmark_3dmatch.py``, numpy) and
descriptor metrics (``eval/metrics.py``, torch) against the JAX package.

The protocol is a copy, so it is held bit for bit: the trajectory files'
parse and write, the quaternion and transformation error, and the whole
benchmark over the vendored 3DMatch gt folder with estimates perturbed from
a numpy seed (some within the 0.2 m criterion, some outside, some pairs
missing).  The metrics run the same inputs (numpy seeds, padded rows
masked out) through both packages: ratios within 1e-6, flags and the
mutual masks equal.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from pcrcg_tpu.eval import benchmark_3dmatch as jbench
from pcrcg_tpu.eval import metrics as jmetrics
from pcrcg_tpu_torch.assets import benchmark_gt_root
from pcrcg_tpu_torch.eval import benchmark_3dmatch as tbench
from pcrcg_tpu_torch.eval import metrics as tmetrics

GT_ROOT = benchmark_gt_root("3DMatch")


def _same(a, b):
    """Equal, with NaN equal to NaN (floats, arrays, dicts, lists)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    return a == b


def _perturbed(traj, rng):
    """Each transform moved by a random rotation of up to ~6 degrees and a
    translation of up to ~0.4 m: some pairs pass the criterion, some fail."""
    out = traj.copy()
    for t in out:
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(0, 0.1)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        r = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)
        t[:3, :3] = r @ t[:3, :3]
        t[:3, 3] += rng.uniform(-0.25, 0.25, 3)
    return out


def test_scalar_helpers_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                      [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                      [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
        assert np.array_equal(tbench.mat2quat(r), jbench.mat2quat(r))
        t = np.eye(4)
        t[:3, :3], t[:3, 3] = r, rng.normal(size=3)
        info = np.diag(rng.uniform(0.5, 2.0, 6))
        assert tbench.transformation_error(t, info) == jbench.transformation_error(t, info)
    r_est, r_gt = rng.normal(size=(2, 8, 3, 3))
    assert np.array_equal(tbench.rotation_error_deg(r_est, r_gt),
                          jbench.rotation_error_deg(r_est, r_gt))
    assert tbench.get_scene_split(GT_ROOT) == jbench.get_scene_split(GT_ROOT)


def test_trajectory_round_trip_matches_jax(tmp_path):
    scene = sorted(os.listdir(GT_ROOT))[0]
    for read in ("read_trajectory", "read_trajectory_info"):
        name = "gt.log" if read == "read_trajectory" else "gt.info"
        got = getattr(tbench, read)(os.path.join(GT_ROOT, scene, name))
        want = getattr(jbench, read)(os.path.join(GT_ROOT, scene, name))
        assert _same(list(got), list(want))
    pairs, traj = tbench.read_trajectory(os.path.join(GT_ROOT, scene, "gt.log"))
    traj = _perturbed(traj, np.random.default_rng(1))
    tbench.write_trajectory(str(tmp_path / "t" / "est.log"), pairs[:, :2].astype(int), traj, 60)
    jbench.write_trajectory(str(tmp_path / "j" / "est.log"), pairs[:, :2].astype(int), traj, 60)
    assert (tmp_path / "t" / "est.log").read_bytes() == (tmp_path / "j" / "est.log").read_bytes()
    keys, back = tbench.read_trajectory(str(tmp_path / "t" / "est.log"))
    assert np.array_equal(keys[:, :2].astype(int), pairs[:, :2].astype(int))
    np.testing.assert_allclose(back, traj, atol=5e-9)


def test_full_benchmark_matches_jax(tmp_path):
    """Every scene of the vendored 3DMatch split, perturbed estimates, one
    scene with a tenth of its pairs left out: every field of the result
    equal to the JAX module's."""
    rng = np.random.default_rng(2)
    for s, scene in enumerate(sorted(os.listdir(GT_ROOT))):
        pairs, traj = jbench.read_trajectory(os.path.join(GT_ROOT, scene, "gt.log"))
        n_frag, _ = jbench.read_trajectory_info(os.path.join(GT_ROOT, scene, "gt.info"))
        keep = np.arange(len(pairs)) if s else np.arange(len(pairs))[len(pairs) // 10:]
        jbench.write_trajectory(str(tmp_path / scene / "est.log"),
                                pairs[keep, :2].astype(int), _perturbed(traj[keep], rng), n_frag)
    got = tbench.benchmark(str(tmp_path), GT_ROOT)
    want = jbench.benchmark(str(tmp_path), GT_ROOT)
    assert _same(dataclasses.asdict(got), dataclasses.asdict(want))
    assert got.summary() == want.summary()
    assert 0.0 < got.weighted_recall < 1.0  # the perturbation lands on both sides


def _metric_inputs(seed, n=96, m=80, c=16, n_pad=13, m_pad=7):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    tgt[: m // 2] = src[: m // 2] + rng.normal(scale=0.02, size=(m // 2, 3))
    a = rng.normal(size=(3, 3))
    rot = np.linalg.qr(a)[0]
    rot = (rot * np.sign(np.linalg.det(rot))).astype(np.float32)
    trans = rng.normal(size=3).astype(np.float32)
    tgt = (tgt @ rot.T + trans).astype(np.float32)
    sf = rng.normal(size=(n, c)).astype(np.float32)
    tf = rng.normal(size=(m, c)).astype(np.float32)
    tf[: m // 2] = sf[: m // 2] + rng.normal(scale=0.3, size=(m // 2, c))
    sm = np.ones(n, bool)
    sm[n - n_pad:] = False
    tm = np.ones(m, bool)
    tm[m - m_pad:] = False
    src[~sm], tgt[~tm] = 1e6, 1e6
    return src, tgt, sf, tf, rot, trans, sm, tm


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inlier_ratio_and_fmr_match_jax(seed):
    """Ratios within 1e-6 (both count the same booleans), distances within
    1e-5 m on the real rows, the mutual mask and the FMR flags equal."""
    args = _metric_inputs(seed)
    want = jmetrics.inlier_ratio(*args, inlier_distance_threshold=0.1, chunk=32)
    got = tmetrics.inlier_ratio(*(torch.from_numpy(a) for a in args),
                                inlier_distance_threshold=0.1, chunk=32)
    for k in ("inlier_ratio_wo_mutual", "inlier_ratio_w_mutual"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, k
    sm = args[6]
    np.testing.assert_allclose(got["distance_wo_mutual"].numpy()[sm],
                               np.asarray(want["distance_wo_mutual"])[sm], atol=1e-5)
    assert np.array_equal(got["mutual_mask"].numpy(), np.asarray(want["mutual_mask"]))
    assert 0.0 < float(got["inlier_ratio_wo_mutual"]) < 1.0
    d = want["distance_wo_mutual"]
    flags = tmetrics.feature_match_recall_sweep(torch.from_numpy(np.asarray(d)),
                                                torch.from_numpy(sm), thresholds=(0.01, 0.1, 3.0),
                                                inlier_ratio_threshold=0.3)
    jflags = jmetrics.feature_match_recall_sweep(d, sm, thresholds=(0.01, 0.1, 3.0),
                                                 inlier_ratio_threshold=0.3)
    assert np.array_equal(flags.numpy(), np.asarray(jflags))


def test_mutual_selection_matches_jax():
    rng = np.random.default_rng(3)
    scores = rng.normal(size=(2, 12, 9)).astype(np.float32)
    scores[0, 3, :] = scores[0, 3, 0]  # a tied row: the first maximum wins in both
    got = tmetrics.mutual_selection(torch.from_numpy(scores)).numpy()
    assert np.array_equal(got, np.asarray(jmetrics.mutual_selection(scores)))
    assert np.array_equal(tmetrics.mutual_selection(torch.from_numpy(scores[1])).numpy(),
                          np.asarray(jmetrics.mutual_selection(scores[1])))
