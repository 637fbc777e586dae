"""The port's training and evaluation entry points on the CPU at a tiny
size: ``main.py`` in train, val and test mode on a split that
``assets.py::write_indoor_fixture`` writes (fragments capped at 400
points, tiny widths), the ``Trainer``'s checkpoints and resume, its
guards, a reference-format ``.pth`` pretrain, the tester's completeness
guard, and ``register_pair``'s GT metrics against the JAX package's
``eval/metrics.py`` on the same sampled points (ratios within 1e-6).

The JAX ``Trainer`` and ``IndoorTester`` are not run here (minutes on
this CPU); the JAX side is its numpy-level export and metric functions.
"""
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from pcrcg_tpu import config as jcfg
from pcrcg_tpu.data.pair import make_pair_batch as j_make_pair_batch
from pcrcg_tpu.eval import metrics as jmetrics
from pcrcg_tpu.models.kpfcnn import KPFCNN as JKPFCNN
from pcrcg_tpu.models.torch_import import export_kpfcnn_state_dict
from pcrcg_tpu.ops.pyramid import build_pyramid_cfg as j_build_pyramid_cfg
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch import main as tmain
from pcrcg_tpu_torch.assets import (
    demo_cloud_pair, demo_pair_gt_pose, write_indoor_fixture, write_kitti_fixture,
)
from pcrcg_tpu_torch.config import load_config
from pcrcg_tpu_torch.data.indoor import IndoorDataset, load_split
from pcrcg_tpu_torch.data.kitti import KITTIDataset
from pcrcg_tpu_torch.data.loader import PairLoader
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.eval.tester import IndoorTester, dump_descriptors, register_pair
from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
from pcrcg_tpu_torch.registration.sampling import weighted_sample_topk
from pcrcg_tpu_torch.train.checkpoints import CheckpointManager
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import forward_pair
from pcrcg_tpu_torch.train.trainer import Trainer

BUDGETS = dict(points=[448, 448, 320, 192], neighbors=[16] * 4, corr_k=8, query_chunk=64,
               search_tile=32, search_m_tiles=4)
WIDTHS = dict(first_feats_dim=32, gnn_feats_dim=32, final_feats_dim=8)


@pytest.fixture(scope="module", autouse=True)
def few_threads_deterministic():
    """Two torch threads (the suite runs several workers on one machine) and
    torch's deterministic algorithms: the CPU's accumulating ``index_put_``
    (the backward of ``x[idx]``) otherwise sums in thread order, so two
    identical steps differ in the last bits and an exact resume cannot be
    told from a wrong one."""
    n, det = torch.get_num_threads(), torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(2)
    torch.use_deterministic_algorithms(True)
    yield
    torch.set_num_threads(n)
    torch.use_deterministic_algorithms(det)


def _write_yaml(path, **model):
    with open(path, "w") as f:
        yaml.safe_dump({"model": model, "tpu": {"budgets": BUDGETS}}, f)
    return str(path)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Train (2 pairs), val (1) and 3DMatch test (2) splits, and the YAML
    of a 2-epoch run over them."""
    root = tmp_path_factory.mktemp("indoor")
    tr = write_indoor_fixture(root, 2, seed=1, split="train", max_points=400)
    va = write_indoor_fixture(root, 1, seed=2, split="val", max_points=400)
    te = write_indoor_fixture(root, 2, seed=3, split="test", info_name="3DMatch",
                              max_points=400)
    model = dict(root=tr["root"], train_info=tr["info"], val_info=va["info"],
                 exp_dir=str(root / "exp"), max_epoch=2, num_workers=2, verbose_freq=1,
                 n_points=64, benchmark="3DMatch", optimizer="Adam", lr=1e-3, **WIDTHS)
    return root, model, te


@pytest.fixture(scope="module")
def trained(split):
    """``main`` in train mode: 2 epochs of 2 steps, then 1 val pair each."""
    root, model, _ = split
    return tmain.main(["--config", _write_yaml(root / "train.yaml", **model),
                       "--device", "cpu"])


def _params(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_main_train_writes_checkpoints_and_logs(trained):
    exp = trained.cfg.exp_dir
    for name in ("log", "config.json", "scalars.jsonl", os.path.join("source_backup",
                                                                     "pcrcg_tpu_torch")):
        assert os.path.exists(os.path.join(exp, name)), name
    files = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    assert {"epoch_0.ckpt", "epoch_1.ckpt", "best_loss.ckpt", "best_recall.ckpt"} <= set(files)
    assert trained.ckpt.latest_step() == 1
    assert trained.state.step == 4 and trained.state.count == 4
    assert np.isfinite(trained.ckpt.best_loss)
    batch, images = next(iter(trained.loaders["val"]))
    out = trained.infer(batch, images)
    assert tuple(out["feats_f"].shape) == (1, 2, BUDGETS["points"][0], WIDTHS["final_feats_dim"])


def test_resume_continues_the_run_exactly(split, trained, tmp_path):
    """Restoring epoch 0 and training epoch 1 gives the uninterrupted run's
    parameters, optimizer state, counters and generator, bit for bit."""
    _, model, _ = split
    cfg = load_config(_write_yaml(tmp_path / "resume.yaml", **{
        **model, "exp_dir": str(tmp_path / "exp"),
        "pretrain": os.path.join(trained.cfg.exp_dir, "checkpoints", "epoch_0.ckpt")}))
    datasets = tmain.build_datasets(cfg)
    resumed = Trainer(cfg, datasets, device="cpu")
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    resumed.train()
    want, got = _params(trained), _params(resumed)
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)
    assert (resumed.state.step, resumed.state.count) == (trained.state.step, trained.state.count)
    assert torch.equal(resumed.generator.get_state(), trained.generator.get_state())
    opt_w, opt_g = trained.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    for i, s in opt_w["state"].items():
        assert all(torch.equal(s[k], opt_g["state"][i][k]) for k in s)


def test_checkpoint_aliases_and_max_to_keep(tmp_path):
    cfg = tcfg.tiny_test_config(optimizer="Adam")
    state = TrainState(cfg, torch.nn.Linear(3, 2))
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=5)
    history = [(2.0, 0.1), (1.5, 0.05), (1.7, 0.3), (1.2, 0.2), (1.3, 0.4), (1.4, 0.1),
               (1.1, 0.1)]
    improved = []
    for epoch, (loss, recall) in enumerate(history):
        with torch.no_grad():
            state.model.weight.fill_(float(epoch))
        improved.append(ckpt.maybe_save_best(state, epoch, loss, recall))
        ckpt.save(state, epoch)
    assert improved == [["best_loss", "best_recall"], ["best_loss"], ["best_recall"],
                        ["best_loss"], ["best_recall"], [], ["best_loss"]]
    assert ckpt.all_steps() == [2, 3, 4, 5, 6]
    for tag, epoch in (("best_loss", 6), ("best_recall", 4)):
        fresh = TrainState(cfg, torch.nn.Linear(3, 2))
        _, meta = CheckpointManager(str(tmp_path)).restore(fresh, path=ckpt.alias_path(tag))
        assert meta["epoch"] == epoch
        assert float(fresh.model.weight[0, 0]) == float(epoch)
    fresh = TrainState(cfg, torch.nn.Linear(3, 2))
    other = CheckpointManager(str(tmp_path))
    _, meta = other.restore(fresh)
    assert meta == {"epoch": 6, "best_loss": 1.1, "best_recall": 0.4}
    assert (other.best_loss, other.best_recall) == (1.1, 0.4)


def test_main_val_and_test_modes(split, trained, tmp_path, monkeypatch):
    """val: one pass over the val split from the best-loss checkpoint; test:
    every pair of the 3DMatch test split registered, est.log written and
    scored against the split's gt, every score in [0, 1]."""
    _, model, te = split
    best = os.path.join(trained.cfg.exp_dir, "checkpoints", "best_loss.ckpt")
    common = {**model, "pretrain": best}
    val = tmain.main(["--config", _write_yaml(tmp_path / "val.yaml", **{
        **common, "mode": "val", "exp_dir": str(tmp_path / "val")}), "--device", "cpu"])
    assert val.start_epoch == torch.load(best, weights_only=True)["meta"]["epoch"] + 1
    monkeypatch.setattr(tmain, "benchmark_gt_root", lambda benchmark: te["gt"])
    res = tmain.main(["--config", _write_yaml(tmp_path / "test.yaml", **{
        **common, "mode": "test", "exp_dir": str(tmp_path / "test")}), "--device", "cpu"])
    assert res["n_pairs"] == 2
    est = os.path.join(res["est_folder"], "7-scenes-fixture", "est.log")
    from pcrcg_tpu_torch.eval.benchmark_3dmatch import read_trajectory

    keys, traj = read_trajectory(est)
    assert keys[:, :2].astype(int).tolist() == [[0, 2], [3, 5]]
    assert np.isfinite(traj).all()
    for k in ("inlier_ratio_wo_mutual", "inlier_ratio_w_mutual", "fmr_005", "fmr_01", "fmr_02"):
        assert 0.0 <= res[k] <= 1.0, k
    assert 0.0 <= res["benchmark"].weighted_recall <= 1.0


def test_dump_descriptors_writes_the_first_pair(trained, tmp_path):
    batch, _ = next(iter(trained.loaders["val"]))
    dump_descriptors(trained.cfg, trained.model, batch, None, str(tmp_path), 7)
    with np.load(tmp_path / "7.npz") as f:
        n0 = BUDGETS["points"][0]
        shapes = {k: f[k].shape for k in f.files}
        assert np.array_equal(f["points"], batch.points[0].numpy())
    assert shapes == {"points": (2, n0, 3), "masks": (2, n0),
                      "feats": (2, n0, WIDTHS["final_feats_dim"]), "overlaps": (2, n0),
                      "saliency": (2, n0), "rot": (3, 3), "trans": (3,)}


def test_tester_refuses_an_incomplete_split(split):
    _, model, te = split
    cfg = tcfg.tiny_test_config(root=te["root"], **WIDTHS)
    ds = IndoorDataset(te["info"], cfg, data_augmentation=False)
    tester = IndoorTester(cfg, init_kpfcnn(cfg, device="cpu"), te["gt"], device="cpu")
    loader = PairLoader(ds, 448, batch_size=3, num_threads=1)  # drops both pairs
    with pytest.raises(RuntimeError, match="scored 0/2 pairs"):
        tester.run(ds, loader, n_points=32)


def test_trainer_guards(split, tmp_path, monkeypatch):
    """data_parallel beyond the ranks at hand raises (here one process, no
    process group: ``main.py`` or torchrun starts the ranks); overflow_action
    'error' raises at the first step whose pyramid drops voxels (level
    budgets far below occupancy); the KITTI datasets build (split lists
    under configs/kitti of the working directory)."""
    _, model, _ = split
    cfg = load_config(_write_yaml(tmp_path / "g.yaml", **{**model,
                                                          "exp_dir": str(tmp_path / "g")}))
    datasets = {"val": load_split(cfg, "val")}
    with pytest.raises(ValueError, match=r"data_parallel=2 but only 1 rank"):
        Trainer(cfg.replace(data_parallel=2), datasets, device="cpu")
    small = tcfg.Budgets(points=(448, 64, 64, 64), neighbors=(16,) * 4, corr_k=8,
                         query_chunk=64, search_tile=32, search_m_tiles=4)
    trainer = Trainer(cfg.replace(budgets=small, overflow_action="error"), datasets,
                      device="cpu")
    with pytest.raises(RuntimeError, match="OVERFLOW"):
        trainer.eval()
    kitti = write_kitti_fixture(tmp_path / "kitti", 9, seed=0, points_per_scan=4000)
    (tmp_path / "configs" / "kitti").mkdir(parents=True)
    for s in ("train", "val", "test"):
        (tmp_path / "configs" / "kitti" / f"{s}_kitti.txt").write_text("0\n")
    monkeypatch.chdir(tmp_path)
    datasets = tmain.build_datasets(cfg.replace(dataset="kitti", root=kitti["root"],
                                                first_subsampling_dl=0.3))
    assert sorted(datasets) == ["train", "val"]
    assert all(isinstance(d, KITTIDataset) and d.files == [(0, 0, 3), (0, 4, 7)]
               for d in datasets.values())


def test_reference_pretrain_loads_with_counts(split, tmp_path):
    """A reference-format ``.pth`` (``export_kpfcnn_state_dict`` of JAX
    KPFCNN variables, under 'state_dict') loads into the Trainer's model:
    every tensor counted, none unmatched, values equal."""
    _, model, _ = split
    jc = jcfg.tiny_test_config(**WIDTHS, budgets=jcfg.Budgets(
        points=(256, 192, 192, 96), neighbors=(16,) * 4, corr_k=8, query_chunk=64,
        search_tile=32, search_m_tiles=4))
    src, tgt = demo_cloud_pair()
    b = j_make_pair_batch([dict(src_pcd=src[:256], tgt_pcd=tgt[:256], rot=np.eye(3),
                                trans=np.zeros(3))], 256)
    pyr = jax.jit(lambda p, m: j_build_pyramid_cfg(jc, p, m))(b.points[0], b.masks[0])
    variables = jax.jit(JKPFCNN(jc).init)(jax.random.key(5), pyr, b.features[0])
    exported = export_kpfcnn_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    path = tmp_path / "reference.pth"
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in exported.items()}}, path)
    cfg = load_config(_write_yaml(tmp_path / "p.yaml", **{
        **model, "exp_dir": str(tmp_path / "p"), "pretrain": str(path)}))
    trainer = Trainer(cfg, {"val": load_split(cfg, "val")}, device="cpu")
    report = trainer.pretrain_report
    assert report["loaded"] == len(exported) and not report["errors"], report["errors"]
    assert trainer.start_epoch == 0
    with open(os.path.join(cfg.exp_dir, "log")) as f:
        assert f"{len(exported)} tensors (0 unmatched)" in f.read()
    own = trainer.model.kpfcnn.state_dict()
    for k, v in exported.items():
        np.testing.assert_array_equal(own[k].numpy(), v, err_msg=k)


def test_register_pair_gt_metrics_match_jax():
    """``register_pair(..., rot, trans)``'s inlier ratios and FMR flags
    against ``pcrcg_tpu/eval/metrics.py`` on the points it sampled (the
    sampling replayed from the same uniforms)."""
    cfg = tcfg.tiny_test_config(**WIDTHS, budgets=tcfg.Budgets(
        points=(256, 192, 192, 96), neighbors=(16,) * 4, corr_k=8, query_chunk=64,
        search_tile=32, search_m_tiles=4))
    src, tgt = demo_cloud_pair()
    rot, trans = demo_pair_gt_pose()
    d = ((src - np.median(src, 0)) ** 2).sum(1)
    crop = src[np.argsort(d, kind="stable")[:240]]
    moved = (crop @ rot.T + trans + np.random.default_rng(0).normal(scale=0.005,
                                                                     size=crop.shape))
    batch = make_pair_batch([dict(src_pcd=crop, tgt_pcd=moved, rot=rot, trans=trans)], 256)
    model = init_kpfcnn(cfg, seed=4, device="cpu")
    g = torch.Generator().manual_seed(7)
    uniforms = [torch.rand(256, generator=g) * (1 - 1e-20) + 1e-20 for _ in range(2)]
    n = 96
    res = register_pair(model, cfg, batch.points[0], batch.masks[0], batch.features[0], g,
                        n_points=n, num_iterations=256, hypothesis_chunk=128,
                        uniforms=uniforms, device="cpu", rot=batch.rot[0], trans=batch.trans[0])
    out = forward_pair(model, cfg, batch.points[0], batch.masks[0], batch.features[0])[0]
    scores = (out["scores_overlap"] * out["scores_saliency"]).detach()
    sampled = []
    for c in range(2):
        idx, ok = weighted_sample_topk(scores[c], batch.masks[0][c], n, uniform=uniforms[c])
        sampled.append((batch.points[0][c][idx].numpy(),
                        out["feats_f"][c][idx].detach().numpy(), ok.numpy()))
    (sp, sf, so), (tp, tf, to) = sampled
    want = jmetrics.inlier_ratio(sp, tp, sf, tf, batch.rot[0].numpy(), batch.trans[0].numpy(),
                                 so, to, inlier_distance_threshold=0.1)
    for k in ("inlier_ratio_wo_mutual", "inlier_ratio_w_mutual"):
        assert abs(float(res[k]) - float(want[k])) <= 1e-6, k
    flags = jmetrics.feature_match_recall_sweep(want["distance_wo_mutual"], so,
                                                thresholds=(0.05, 0.1, 0.2))
    assert np.array_equal(res["fmr_flags"].numpy(), np.asarray(flags))
    assert float(res["inlier_ratio_wo_mutual"]) > 0.0
