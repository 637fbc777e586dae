"""The port's KITTI path against the JAX package's, on the CPU, on a drive
that ``assets.py::write_kitti_fixture`` writes (9 frames of 12,000 rays in
the KITTI-odometry layout: pairs (0, 3) and (4, 7), 9.9 m apart).

Compared with the JAX package on the same inputs:
* ``velo2cam``, ``voxel_downsample`` (equal), ``icp_point_to_point``
  (within 1e-6: the same numpy / scipy code);
* ``KITTIDataset``: the pairs of each split (equal), the ICP-refined GT
  (within 1e-6; each package computes its own, on its own copy of the
  fixture), the test samples and the augmented train samples under the
  same generator (clouds equal);
* ``make_pair_batch`` with the raw clouds: ``raw_points`` row for row with
  ``points`` under the same subsample and Z-order, and ``extras`` (equal);
* ``pair_loss`` with ``raw_points`` at configs/train/kitti.yaml's radii,
  tiny widths, the same weights and the loss's draws from the same key:
  loss terms rtol 1e-4 and gradients ||dg|| <= 1e-3 ||g|| + 1e-6 max ||g||
  (the tolerances of ``tests/test_torch_train.py``); the JAX pyramid is
  compiled on its own, as there;
* ``KITTITester``'s scoring on the same estimated and GT transforms
  (within 1e-6), and ``main.build_datasets`` (the same splits).
The port's ``KITTITester`` and ``main`` (train, val, test) also run end to
end on the CPU.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from pcrcg_tpu import config as jcfg
from pcrcg_tpu import main as jmain
from pcrcg_tpu.data import kitti as jk
from pcrcg_tpu.data.pair import make_pair_batch as j_make_pair_batch
from pcrcg_tpu.eval import tester as jtester
from pcrcg_tpu.models.kpfcnn import KPFCNN as JKPFCNN
from pcrcg_tpu.ops.pyramid import build_pyramid_cfg as j_build_pyramid_cfg
from pcrcg_tpu.train import step as jstep
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch import main as tmain
from pcrcg_tpu_torch.assets import write_kitti_fixture
from pcrcg_tpu_torch.data import kitti as tk
from pcrcg_tpu_torch.data.loader import PairLoader
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.eval import tester as ttester
from pcrcg_tpu_torch.models.kpfcnn import KPFCNN, init_kpfcnn
from pcrcg_tpu_torch.models.weights import state_dict_from_jax
from pcrcg_tpu_torch.train.step import pair_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI_YAML = os.path.join(REPO, "configs", "train", "kitti.yaml")
BUDGETS = dict(points=(384, 256, 128, 64), neighbors=(16,) * 4, corr_k=8, query_chunk=64,
               search_tile=32, search_m_tiles=4)
WIDTHS = dict(first_feats_dim=32, gnn_feats_dim=32, final_feats_dim=8)
SPLITS = ("train", "val", "test")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """The fixture twice (each package computes and caches its own ICP GT)
    and a split list naming its drive for every split."""
    base = tmp_path_factory.mktemp("kitti")
    write_kitti_fixture(base / "port", 9, seed=3, points_per_scan=12_000)
    shutil.copytree(base / "port", base / "jax")
    lists = base / "configs" / "kitti"
    lists.mkdir(parents=True)
    for s in SPLITS:
        (lists / f"{s}_kitti.txt").write_text("0\n")
    return base, {s: str(lists / f"{s}_kitti.txt") for s in SPLITS}


def _configs(base, **kw):
    common = dict(dataset="kitti", first_subsampling_dl=0.3, overlap_radius=0.45, max_points=64,
                  augment_noise=0.01, **kw)
    return (tcfg.tiny_test_config(root=str(base / "port"), **common),
            jcfg.tiny_test_config(root=str(base / "jax"), **common))


@pytest.fixture(scope="module")
def datasets(drive):
    base, split_files = drive
    tc, jc = _configs(base)
    return {s: (tk.KITTIDataset(tc, s, split_files=split_files),
                jk.KITTIDataset(jc, s, split_files=split_files)) for s in SPLITS}


def test_helpers_match_jax(drive):
    base, _ = drive
    np.testing.assert_array_equal(tk.velo2cam(), jk.velo2cam())
    scan = np.fromfile(base / "port" / "dataset" / "sequences" / "00" / "velodyne" /
                       "000000.bin", np.float32).reshape(-1, 4)[:, :3]
    for voxel in (0.3, 0.6):
        np.testing.assert_array_equal(tk.voxel_downsample(scan, voxel),
                                      jk.voxel_downsample(scan, voxel))
    init = np.eye(4)
    init[:3, 3] = (0.2, -0.1, 0.05)
    src = tk.voxel_downsample(scan, 0.3).astype(np.float64)
    got = tk.icp_point_to_point(src, src + (0.1, 0.05, 0.0), init, max_dist=0.5)
    want = jk.icp_point_to_point(src, src + (0.1, 0.05, 0.0), init, max_dist=0.5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:3, 3], (0.1, 0.05, 0.0), atol=1e-3)


def test_pairs_match_jax(datasets):
    for s, (port, ref) in datasets.items():
        assert port.files == ref.files == [(0, 0, 3), (0, 4, 7)], s


def test_test_samples_and_icp_gt_match_jax(datasets, drive):
    """Test samples: the ICP GT within 1e-6 and cached under <root>/icp; the
    un-augmented clouds equal, model input = raw."""
    base, _ = drive
    port, ref = datasets["test"]
    for i in range(len(port)):
        got, want = port.get(i), ref.get(i)
        assert sorted(got) == sorted(want)
        for k in ("rot", "trans"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        for k in ("src_pcd", "tgt_pcd", "raw_src_pcd", "raw_tgt_pcd"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["src_pcd"], got["raw_src_pcd"])
        _, t0, t1 = port.files[i]
        assert (base / "port" / "icp" / f"0_{t0}_{t1}.npy").exists()
        # The ICP refinement stays by the scanner's true motion (the poses):
        # within 0.5 deg and 0.2 m on these sparse 12,000-ray scans (0.013
        # deg and 2 mm at 120,000 rays).
        pos = port.video_odometry(0)[[t0, t1]]
        v2c = tk.velo2cam()
        motion = np.linalg.inv(v2c) @ np.linalg.inv(pos[1]) @ pos[0] @ v2c
        cos = (np.trace(got["rot"].T @ motion[:3, :3]) - 1) / 2
        assert np.degrees(np.arccos(min(cos, 1.0))) < 0.5
        assert np.linalg.norm(got["trans"] - motion[:3, 3]) < 0.2


def test_augmented_train_samples_match_jax(datasets):
    """Train samples under the same generator: the model-input clouds moved
    by the augmentation, the raw clouds and the GT not."""
    port, ref = datasets["train"]
    for i in range(len(port)):
        got = port.get(i, np.random.default_rng(20 + i))
        want = ref.get(i, np.random.default_rng(20 + i))
        for k in ("src_pcd", "tgt_pcd", "raw_src_pcd", "raw_tgt_pcd", "item"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("rot", "trans"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        assert got["src_pcd"].shape == got["raw_src_pcd"].shape
        assert not np.allclose(got["src_pcd"], got["raw_src_pcd"], atol=0.5)


def _train_samples(datasets):
    port, _ = datasets["train"]
    return [port.get(i, np.random.default_rng(20 + i)) for i in range(len(port))]


def test_make_pair_batch_raw_points_and_extras_match_jax(datasets):
    samples = _train_samples(datasets)
    for s in samples:
        s["points_raw"] = s["raw_src_pcd"][:100]
    budget = min(min(len(s["src_pcd"]), len(s["tgt_pcd"])) for s in samples) - 50
    with pytest.warns(UserWarning, match="truncated to budget"):
        got = make_pair_batch(samples, budget, rng=np.random.default_rng(4))
    with pytest.warns(UserWarning, match="truncated to budget"):
        want = j_make_pair_batch(samples, budget, rng=np.random.default_rng(4))
    for k in ("points", "masks", "features", "rot", "trans", "raw_points"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert sorted(got.extras) == sorted(want.extras) == ["points_raw"]
    np.testing.assert_array_equal(got.extras["points_raw"].numpy(),
                                  np.asarray(want.extras["points_raw"]))
    assert got.loss_points is got.raw_points
    plain = make_pair_batch([{k: s[k] for k in ("src_pcd", "tgt_pcd", "rot", "trans")}
                             for s in samples], budget, rng=np.random.default_rng(4))
    assert plain.raw_points is None and plain.extras is None and plain.loss_points is plain.points


def test_raw_rows_follow_the_model_input_rows():
    """A source moved by a known rigid map: after the budget's subsample and
    the Z-order, each row of ``points`` is its ``raw_points`` row moved."""
    rng = np.random.default_rng(0)
    raw = rng.uniform(-20, 20, (700, 3)).astype(np.float32)
    c, s = np.cos(1.1), np.sin(1.1)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    moved = raw @ rot.T + (3.0, -2.0, 0.5)
    sample = dict(src_pcd=moved, tgt_pcd=moved[:600], raw_src_pcd=raw, raw_tgt_pcd=raw[:600],
                  rot=np.eye(3), trans=np.zeros(3))
    with pytest.warns(UserWarning, match="truncated to budget"):
        batch = make_pair_batch([sample], 512, rng=np.random.default_rng(1))
    m = batch.masks[0].numpy()
    pts, raw_b = batch.points[0].numpy(), batch.raw_points[0].numpy()
    for c in range(2):
        np.testing.assert_allclose(pts[c][m[c]], raw_b[c][m[c]] @ rot.T + (3.0, -2.0, 0.5),
                                   atol=1e-4)
    assert not np.array_equal(pts[0][m[0]], moved[:m[0].sum()])  # rows were reordered


def _crop_pair(sample, n):
    """The n raw points of each cloud nearest to the midpoint between the two
    scanners, and the same rows of the augmented clouds."""
    rot, trans = sample["rot"].astype(np.float64), sample["trans"].astype(np.float64)
    c_src = -0.5 * rot.T @ trans
    c_tgt = rot @ c_src + trans
    out = dict(rot=sample["rot"], trans=sample["trans"])
    for cloud, c in (("src", c_src), ("tgt", c_tgt)):
        raw = sample[f"raw_{cloud}_pcd"]
        rows = np.argsort(((raw - c) ** 2).sum(1), kind="stable")[:n]
        out[f"{cloud}_pcd"] = sample[f"{cloud}_pcd"][rows]
        out[f"raw_{cloud}_pcd"] = raw[rows]
    return out


@pytest.fixture(scope="module")
def loss_reference(datasets):
    """The JAX ``pair_loss`` with ``raw_points`` (jit of value_and_grad; its
    pyramid compiled on its own and handed in) on a crop of an augmented
    train pair, under configs/train/kitti.yaml with tiny widths."""
    sample = _crop_pair(_train_samples(datasets)[0], BUDGETS["points"][0])
    jc = jcfg.load_config(KITTI_YAML).replace(budgets=jcfg.Budgets(**BUDGETS), **WIDTHS)
    batch = j_make_pair_batch([sample], jc.budgets.points[0])
    points, masks, feats = batch.points[0], batch.masks[0], batch.features[0]
    pyramid = jax.jit(lambda p, m: j_build_pyramid_cfg(jc, p, m, with_overflow=True))(
        points, masks)
    model = JKPFCNN(jc)
    variables = jax.jit(model.init)(jax.random.key(3), pyramid[0], feats)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    key = jax.random.key(17)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_pyramid_cfg",
                   lambda cfg, p, m, with_overflow=False: pyramid if with_overflow
                   else pyramid[0])

        def loss_fn(params):
            stats = jstep.pair_loss(model, dict(variables, params=params), jc, key, points,
                                    masks, feats, batch.rot[0], batch.trans[0],
                                    raw_points=batch.raw_points[0])
            return stats["total"], stats

        (_, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
    uniforms = torch.from_numpy(np.array(jax.random.uniform(
        key, (jc.budgets.points[0] * jc.budgets.corr_k,))))
    return sample, variables, uniforms, ({k: float(v) for k, v in stats.items()},
                                         state_dict_from_jax({"params": jax.tree_util.tree_map(
                                             np.asarray, grads)}))


def test_pair_loss_on_raw_points_matches_jax(loss_reference):
    sample, variables, uniforms, (want_stats, want_grads) = loss_reference
    tc = tcfg.load_config(KITTI_YAML).replace(budgets=tcfg.Budgets(**BUDGETS), **WIDTHS)
    model = KPFCNN(tc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    batch = make_pair_batch([sample], tc.budgets.points[0])
    assert not torch.allclose(batch.raw_points, batch.points)
    args = (model, tc, batch.points[0], batch.masks[0], batch.features[0], batch.rot[0],
            batch.trans[0])
    with torch.enable_grad():
        stats = pair_loss(*args, uniforms=uniforms, raw_points=batch.raw_points[0])
        stats["total"].backward()
    assert want_stats["circle_loss"] > 0, "the crop has no circle-loss pairs"
    assert set(stats) == set(want_stats)
    for k, v in want_stats.items():
        np.testing.assert_allclose(float(stats[k]), v, rtol=1e-4, atol=1e-7, err_msg=k)
    # The loss on the model-input clouds is another loss: raw_points is used.
    with torch.no_grad():
        other = pair_loss(*args, uniforms=uniforms)
    assert abs(float(other["total"]) - want_stats["total"]) > 1e-3
    grads = {n: p.grad.double() for n, p in model.named_parameters()}
    floor = 1e-6 * max(float(g.norm()) for g in want_grads.values())
    for n, g in want_grads.items():
        assert float((grads[n] - g.double()).norm()) <= 1e-3 * float(g.norm()) + floor, n


def test_stats_over_pairs_pass_raw_points(loss_reference, monkeypatch):
    """``train_step`` / ``eval_step`` hand each pair its ``raw_points`` row."""
    import pcrcg_tpu_torch.train.step as tstep

    sample, variables, uniforms, (want_stats, _) = loss_reference
    tc = tcfg.load_config(KITTI_YAML).replace(budgets=tcfg.Budgets(**BUDGETS), **WIDTHS)
    model = KPFCNN(tc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    from pcrcg_tpu_torch.train.state import TrainState

    state = TrainState(tc, model)
    batch = make_pair_batch([sample], tc.budgets.points[0])
    stats = tstep.eval_step(state, tc, batch, uniforms=uniforms[None])
    np.testing.assert_allclose(float(stats["total"]), want_stats["total"], rtol=1e-4)
    seen = []
    real = tstep.pair_loss
    monkeypatch.setattr(tstep, "pair_loss", lambda *a, **kw: seen.append(kw["raw_points"])
                        or real(*a, **kw))
    tstep.train_step(state, tc, batch, uniforms=uniforms[None])
    assert len(seen) == 1 and torch.equal(seen[0], batch.raw_points[0])


def _scoring_inputs():
    """Estimated and GT transforms of 6 pairs: some within 5 deg / 2 m of
    the GT, some not."""
    rng = np.random.default_rng(9)
    from pcrcg_tpu_torch.data.indoor import euler_zyx_matrix

    gts, ests = [], []
    for i in range(6):
        rot = euler_zyx_matrix(rng.uniform(-0.3, 0.3, 3))
        trans = rng.uniform(-10, 10, 3).astype(np.float32)
        err = euler_zyx_matrix(np.radians(rng.uniform(-1, 1, 3) * (2.0 if i % 2 else 9.0)))
        est = np.concatenate([err @ rot, (trans + rng.uniform(-1.5, 1.5, 3))[:, None]], 1)
        gts.append((rot, trans))
        ests.append(est.astype(np.float32))
    return gts, ests


def test_kitti_scoring_matches_jax(monkeypatch):
    """Both testers' scoring on the same estimates (``register_pair`` of each
    package replaced by the estimates)."""
    gts, ests = _scoring_inputs()
    samples = [dict(src_pcd=np.zeros((8, 3)), tgt_pcd=np.zeros((8, 3)), rot=r, trans=t)
               for r, t in gts]
    j_batches = [(j_make_pair_batch([s], 8), None) for s in samples]
    t_batches = [(make_pair_batch([s], 8), None) for s in samples]
    j_iter, t_iter = iter(ests), iter(ests)
    monkeypatch.setattr(jtester, "register_pair_jit",
                        lambda *a, **kw: {"transform": jax.numpy.asarray(next(j_iter))})
    monkeypatch.setattr(ttester, "register_pair",
                        lambda *a, **kw: {"transform": torch.from_numpy(next(t_iter))})
    want = jtester.KITTITester(jcfg.tiny_test_config(), None, None).run(j_batches)
    got = ttester.KITTITester(tcfg.tiny_test_config(), None, device="cpu").run(t_batches)
    assert 0.0 < want["registration_recall"] < 1.0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
    assert got["n_pairs"] == 6 and got["rre"].shape == got["rte"].shape == (6,)


def test_kitti_tester_end_to_end_on_cpu(datasets):
    """Every test pair registered by a seeded model, RRE and RTE finite, the
    scores in range; a loader that drops the split raises."""
    port, _ = datasets["test"]
    cfg = tcfg.load_config(KITTI_YAML).replace(budgets=tcfg.Budgets(**BUDGETS), **WIDTHS,
                                              root=port.config.root)
    model = init_kpfcnn(cfg, seed=0, device="cpu")
    tester = ttester.KITTITester(cfg, model, device="cpu")
    loader = PairLoader(port, cfg.budgets.points[0], batch_size=1, num_threads=1,
                        drop_last=False)
    with pytest.warns(UserWarning, match="truncated to budget"):
        res = tester.run(loader, n_points=128, num_iterations=1024, hypothesis_chunk=256)
    assert res["n_pairs"] == len(port) == 2
    assert np.isfinite(res["rre"]).all() and np.isfinite(res["rte"]).all()
    assert 0.0 <= res["registration_recall"] <= 1.0
    short = PairLoader(port, cfg.budgets.points[0], batch_size=3, num_threads=1)
    with pytest.raises(RuntimeError, match="scored 0/2 pairs"):
        tester.run(short, n_points=128, num_iterations=1024, hypothesis_chunk=256)


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_build_datasets_matches_jax(drive, mode, monkeypatch):
    base, _ = drive
    monkeypatch.chdir(base)
    tc, jc = _configs(base, mode=mode)
    got, want = tmain.build_datasets(tc), jmain.build_datasets(jc)
    assert sorted(got) == sorted(want)
    for phase in want:
        assert isinstance(got[phase], tk.KITTIDataset)
        assert got[phase].split == want[phase].split == phase
        assert got[phase].files == want[phase].files
        assert got[phase].augment == want[phase].augment == (phase == "train")


def _write_yaml(path, **model):
    with open(KITTI_YAML) as f:
        raw = yaml.safe_load(f)
    raw["model"].update(WIDTHS, **model)
    raw["misc"].update(verbose_freq=1)
    raw["optimiser"].update(max_epoch=1, lr=0.001)
    raw["loss"]["max_points"] = 64
    raw["dataset"]["num_workers"] = 2
    raw["tpu"]["budgets"] = {k: list(v) if isinstance(v, tuple) else v
                             for k, v in BUDGETS.items()}
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


@pytest.fixture(scope="module")
def main_runs(drive, tmp_path_factory):
    """``main`` under configs/train/kitti.yaml (tiny widths and budgets, 1
    epoch) in train, val and test mode, from the fixture's directory."""
    base, _ = drive
    out = tmp_path_factory.mktemp("kitti_main")
    cwd = os.getcwd()
    os.chdir(base)
    try:
        runs = {}
        for mode in ("train", "val", "test"):
            path = _write_yaml(out / f"{mode}.yaml", mode=mode, root=str(base / "port"))
            with open(path) as f:
                raw = yaml.safe_load(f)
            raw["misc"]["exp_dir"] = str(out / mode)
            with open(path, "w") as f:
                yaml.safe_dump(raw, f)
            with pytest.warns(UserWarning, match="truncated to budget"):
                runs[mode] = tmain.main(["--config", path, "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return runs


def test_main_trains_validates_and_tests_on_cpu(main_runs):
    trained = main_runs["train"]
    assert trained.state.step == len(trained.loaders["train"]) == 2
    with open(os.path.join(trained.cfg.exp_dir, "log")) as f:
        summaries = [line for line in f if line.startswith(("train Epoch 0:", "val Epoch 0:"))]
    assert len(summaries) == 2
    for line in summaries:
        words = line.split()
        stats = {k.rstrip(":"): v for k, v in zip(words[3::2], words[4::2])}
        assert np.isfinite(float(stats["total"])) and np.isfinite(float(stats["circle_loss"]))
    assert np.isfinite(trained.ckpt.best_loss)
    batch, _ = next(iter(trained.loaders["train"]))
    assert batch.raw_points is not None
    assert not torch.allclose(batch.raw_points, batch.points)
    assert os.path.exists(os.path.join(trained.cfg.exp_dir, "checkpoints", "epoch_0.ckpt"))
    assert sorted(main_runs["val"].loaders) == ["val"]
    res = main_runs["test"]
    assert res["n_pairs"] == 2
    assert np.isfinite(res["rre"]).all() and 0.0 <= res["registration_recall"] <= 1.0


def test_main_without_cuda_raises(drive, tmp_path, monkeypatch):
    """Without ``--device cpu`` the entry point runs on CUDA, and raises
    where there is none (no quiet fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    base, _ = drive
    monkeypatch.chdir(base)
    path = _write_yaml(tmp_path / "k.yaml", mode="test", root=str(base / "port"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--config", path])
