"""The port's ModelNet path against the JAX package's, on the CPU, on
HDF5 shards written from ``assets.py::modelnet_shapes`` (h5py is present
here; the module skips where it is not, as ``test_modelnet_e2e.py`` does).

Compared with the JAX package on the same inputs:
* ``ModelNetHdf`` / ``get_modelnet_datasets`` (configs/train/modelnet.yaml's
  protocol: half1 categories for train / val, half2 for test, crops of
  0.7): the splits, and every sample with ``points_raw`` under the same
  numpy seed (equal, bit for bit);
* ``make_pair_batch``'s ``extras`` (equal);
* the 3-level ModelNet ``KPFCNN`` (two strided blocks, two ``resnetb``
  blocks a level; decoder nearest_upsample, unary, unary, nearest_upsample,
  unary, last_unary) with the JAX weights carried across by
  ``state_dict_from_jax`` and loaded with ``strict=True``: outputs rtol and
  atol 1e-4 (the tolerance of ``tests/test_torch_model.py``);
* ``dcm2euler_xyz``, ``compute_metrics``, ``summarize_metrics`` and the
  testers' scoring on the same estimated and GT transforms (within 1e-6).
The port's ``ModelnetTester`` and ``main`` (train, val, test) also run end
to end on the CPU.
"""
import os

import jax
import numpy as np
import pytest
import torch
import yaml

h5py = pytest.importorskip("h5py")

from pcrcg_tpu import config as jcfg  # noqa: E402
from pcrcg_tpu import main as jmain  # noqa: E402
from pcrcg_tpu.data import modelnet as jm  # noqa: E402
from pcrcg_tpu.data.pair import make_pair_batch as j_make_pair_batch  # noqa: E402
from pcrcg_tpu.eval import modelnet_metrics as jmm  # noqa: E402
from pcrcg_tpu.models.kpfcnn import KPFCNN as JKPFCNN  # noqa: E402
from pcrcg_tpu.models.torch_import import export_kpfcnn_state_dict  # noqa: E402
from pcrcg_tpu.ops.pyramid import build_pyramid_cfg as j_build_pyramid_cfg  # noqa: E402
from pcrcg_tpu_torch import config as tcfg  # noqa: E402
from pcrcg_tpu_torch import main as tmain  # noqa: E402
from pcrcg_tpu_torch.assets import modelnet_shapes  # noqa: E402
from pcrcg_tpu_torch.data import modelnet as tm  # noqa: E402
from pcrcg_tpu_torch.data.loader import PairLoader  # noqa: E402
from pcrcg_tpu_torch.data.pair import make_pair_batch  # noqa: E402
from pcrcg_tpu_torch.eval import modelnet_metrics as tmm  # noqa: E402
from pcrcg_tpu_torch.models.kpfcnn import KPFCNN, init_kpfcnn  # noqa: E402
from pcrcg_tpu_torch.models.weights import state_dict_from_jax  # noqa: E402
from test_torch_model import pyramid_to_torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELNET_YAML = os.path.join(REPO, "configs", "train", "modelnet.yaml")
CATEGORIES = os.path.join(REPO, "configs", "modelnet")
BUDGETS = dict(points=(256, 192, 96), neighbors=(16,) * 3, corr_k=8, query_chunk=64,
               search_tile=32, search_m_tiles=4)
WIDTHS = dict(first_feats_dim=32, gnn_feats_dim=32, final_feats_dim=8)
NUM_POINTS = 256
# Train shard: 4 models of half1 categories; test shard: 2 of half1 (the
# val split), 3 of half2 (the test split).
TRAIN_NAMES = ["airplane", "bed", "chair", "bench"]
TEST_NAMES = ["airplane", "bed", "laptop", "monitor", "sofa"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_shards(root):
    """ModelNet40's layout: shape_names.txt, {train,test}_files.txt and one
    HDF5 shard each (data [n, 2048, 3], label [n, 1])."""
    root.mkdir(parents=True, exist_ok=True)
    all_cats = [c.strip() for c in open(os.path.join(CATEGORIES, "modelnet40_all.txt"))]
    (root / "shape_names.txt").write_text("\n".join(all_cats) + "\n")
    for seed, (subset, names) in enumerate((("train", TRAIN_NAMES), ("test", TEST_NAMES))):
        with h5py.File(root / f"ply_data_{subset}0.h5", "w") as f:
            f.create_dataset("data", data=modelnet_shapes(len(names), 2048, seed=seed))
            f.create_dataset("label", data=np.array([[all_cats.index(n)] for n in names]))
        (root / f"{subset}_files.txt").write_text(
            f"data/modelnet40_ply_hdf5_2048/ply_data_{subset}0.h5\n")
    return str(root)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_shards(tmp_path_factory.mktemp("modelnet") / "mn")


def _overrides(root, **kw):
    return dict(root=root, num_points=NUM_POINTS, **WIDTHS,
                train_categoryfile=os.path.join(CATEGORIES, "modelnet40_half1.txt"),
                val_categoryfile=os.path.join(CATEGORIES, "modelnet40_half1.txt"),
                test_categoryfile=os.path.join(CATEGORIES, "modelnet40_half2.txt"), **kw)


def _configs(root, **kw):
    return (tcfg.load_config(MODELNET_YAML).replace(budgets=tcfg.Budgets(**BUDGETS),
                                                    **_overrides(root, **kw)),
            jcfg.load_config(MODELNET_YAML).replace(budgets=jcfg.Budgets(**BUDGETS),
                                                    **_overrides(root, **kw)))


def _sample(ds, i, seed):
    np.random.seed(seed)  # the train chain draws its per-sample seeds here
    return ds[i]


def _assert_same_sample(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_datasets_and_samples_match_jax(root, mode):
    tc, jc = _configs(root, mode=mode)
    got, want = tm.get_modelnet_datasets(tc), jm.get_modelnet_datasets(jc)
    assert sorted(got) == sorted(want)
    for phase, ds in want.items():
        assert len(got[phase]) == len(ds) == {"train": 4, "val": 2, "test": 3}[phase]
        np.testing.assert_array_equal(got[phase]._labels, ds._labels)
        for i in range(len(ds)):
            s = _sample(got[phase], i, 30 + i)
            _assert_same_sample(s, _sample(ds, i, 30 + i))
            assert s["points_raw"].shape == (2048, 3)
            assert s["src_pcd"].shape == s["tgt_pcd"].shape == (int(np.ceil(0.7 * NUM_POINTS)),
                                                               3)


def test_val_mode_builds_the_val_split(root):
    """Mode "val" gives the val split of mode "train" (the JAX package's
    ``get_modelnet_datasets`` gives its test split there, which its
    Trainer's val pass does not find)."""
    tc, jc = _configs(root, mode="val")
    got = tm.get_modelnet_datasets(tc)
    assert sorted(got) == ["val"]
    assert sorted(jm.get_modelnet_datasets(jc)) == ["test"]
    want = jm.get_modelnet_datasets(jc.replace(mode="train"))["val"]
    assert len(got["val"]) == len(want)
    _assert_same_sample(_sample(got["val"], 1, 3), _sample(want, 1, 3))


def test_read_categories_and_h5_reader_match_jax(root):
    path = os.path.join(CATEGORIES, "modelnet40_half2.txt")
    assert tm.read_categories(path) == jm.read_categories(path)
    files = [os.path.join(root, "ply_data_test0.h5")]
    for cats in (None, [2, 22]):
        got, want = tm.ModelNetHdf._read_h5(files, cats), jm.ModelNetHdf._read_h5(files, cats)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_make_pair_batch_extras_match_jax(root):
    tc, jc = _configs(root, mode="train")
    ds = tm.get_modelnet_datasets(tc)["train"]
    samples = [_sample(ds, i, 50 + i) for i in range(2)]
    got = make_pair_batch(samples, BUDGETS["points"][0])
    want = j_make_pair_batch(samples, BUDGETS["points"][0])
    assert got.raw_points is None and want.raw_points is None
    assert sorted(got.extras) == sorted(want.extras) == ["points_raw"]
    np.testing.assert_array_equal(got.extras["points_raw"].numpy(),
                                  np.asarray(want.extras["points_raw"]))
    for k in ("points", "masks", "features", "rot", "trans"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))


@pytest.fixture(scope="module")
def jax_model(root):
    tc, jc = _configs(root, mode="test")
    sample = _sample(tm.get_modelnet_datasets(tc)["test"], 0, 0)
    batch = j_make_pair_batch([sample], jc.budgets.points[0])
    pyr = jax.jit(lambda p, m: j_build_pyramid_cfg(jc, p, m))(batch.points[0], batch.masks[0])
    model = JKPFCNN(jc)
    variables = jax.jit(model.init)(jax.random.key(5), pyr, batch.features[0])
    want = jax.jit(model.apply)(variables, pyr, batch.features[0])
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return tc, variables, pyr, batch, {k: np.asarray(v) for k, v in want.items()}


def test_modelnet_topology_weights_load_strict(jax_model):
    tc, variables, pyr, *_ = jax_model
    assert len(pyr.points) == 3
    got, want = state_dict_from_jax(variables), export_kpfcnn_state_dict(variables)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    port = KPFCNN(tc)
    port.load_state_dict(got, strict=True)
    assert sum(n.endswith("KPConv.weights") for n in got) == 9
    decoder = [type(b).__name__ for b in port.decoder_blocks]
    assert len(decoder) == 6, decoder
    fresh = init_kpfcnn(tc, seed=0, device="cpu")
    for name, buf in fresh.named_buffers():
        np.testing.assert_array_equal(buf.numpy(), port.get_buffer(name).numpy(), err_msg=name)


def test_modelnet_kpfcnn_forward_matches_jax(jax_model):
    tc, variables, pyr, batch, want = jax_model
    port = KPFCNN(tc).eval()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port(pyramid_to_torch(pyr), torch.from_numpy(np.array(batch.features[0])))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    assert np.isfinite(got["feats_f"].numpy()).all()


def _transforms(rng, n):
    from pcrcg_tpu_torch.data.indoor import euler_zyx_matrix

    return np.stack([np.concatenate([euler_zyx_matrix(rng.uniform(-np.pi, np.pi, 3)),
                                     rng.uniform(-0.5, 0.5, (3, 1))], 1) for _ in range(n)])


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    gt = _transforms(rng, 5)
    pred = gt + rng.normal(scale=0.02, size=gt.shape)
    pred[:, :, :3] = np.stack([np.linalg.svd(r)[0] @ np.linalg.svd(r)[2] for r in
                               pred[:, :, :3]])
    raw = rng.uniform(-1, 1, (5, 300, 3))
    src, ref = raw[:, :180], raw[:, 120:]
    np.testing.assert_allclose(tmm.dcm2euler_xyz(gt[:, :, :3]), jmm.dcm2euler_xyz(gt[:, :, :3]),
                               rtol=0, atol=1e-6)
    got = tmm.compute_metrics(src, ref, raw, gt, pred)
    want = jmm.compute_metrics(src, ref, raw, gt, pred)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    got_s, want_s = tmm.summarize_metrics(got), jmm.summarize_metrics(want)
    assert sorted(got_s) == sorted(want_s)
    for k in want_s:
        assert abs(got_s[k] - want_s[k]) <= 1e-6, k


def test_tester_scoring_matches_jax(root, monkeypatch):
    """Both testers' summaries on the same batches and estimates
    (``register_pair`` of each package replaced by the estimates)."""
    import pcrcg_tpu.eval.tester as jtester

    tc, jc = _configs(root, mode="test")
    ds = tm.get_modelnet_datasets(tc)["test"]
    samples = [_sample(ds, i, 70 + i) for i in range(len(ds))]
    rng = np.random.default_rng(1)
    ests = [np.concatenate([s["rot"], s["trans"][:, None]], 1)
            + rng.normal(scale=0.01, size=(3, 4)).astype(np.float32) for s in samples]
    j_iter, t_iter = iter(ests), iter(ests)
    monkeypatch.setattr(jtester, "register_pair_jit",
                        lambda *a, **kw: {"transform": jax.numpy.asarray(next(j_iter))})
    monkeypatch.setattr(tmm, "register_pair",
                        lambda *a, **kw: {"transform": torch.from_numpy(next(t_iter))})
    want = jmm.ModelnetTester(jc, None, None).run(
        [(j_make_pair_batch([s], BUDGETS["points"][0]), None) for s in samples])
    got = tmm.ModelnetTester(tc, None, device="cpu").run(
        [(make_pair_batch([s], BUDGETS["points"][0]), None) for s in samples])
    assert got.pop("n_pairs") == len(samples)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6, k


def test_modelnet_tester_end_to_end_on_cpu(root):
    """Every test pair registered by a seeded model, every key finite, the
    chamfer from ``extras['points_raw']``; a batch without it raises."""
    tc, _ = _configs(root, mode="test")
    ds = tm.get_modelnet_datasets(tc)["test"]
    model = init_kpfcnn(tc, seed=0, device="cpu")
    tester = tmm.ModelnetTester(tc, model, device="cpu")
    loader = PairLoader(ds, BUDGETS["points"][0], batch_size=1, num_threads=1, drop_last=False)
    summary = tester.run(loader, n_points=64, num_iterations=1024, hypothesis_chunk=256)
    assert summary.pop("n_pairs") == len(ds) == 3
    assert sorted(summary) == ["chamfer_dist", "err_r_deg_mean", "err_r_deg_rmse",
                               "err_t_mean", "err_t_rmse", "r_mae", "r_rmse", "t_mae", "t_rmse"]
    assert all(np.isfinite(v) for v in summary.values())
    plain = [(make_pair_batch([{k: v for k, v in ds[0].items() if k != "points_raw"}],
                              BUDGETS["points"][0]), None)]
    with pytest.raises(KeyError, match="points_raw"):
        tester.run(plain)


def _write_yaml(path, root, **misc):
    with open(MODELNET_YAML) as f:
        raw = yaml.safe_load(f)
    raw["model"].update(WIDTHS, root=root)
    raw["misc"].update(verbose_freq=1, **misc)
    raw["optimiser"].update(max_epoch=1)
    raw["dataset"].update(num_workers=2, num_points=NUM_POINTS,
                          **{f"{s}_categoryfile": os.path.join(
                              CATEGORIES, f"modelnet40_half{2 if s == 'test' else 1}.txt")
                             for s in ("train", "val", "test")})
    raw["tpu"]["budgets"] = {k: list(v) if isinstance(v, tuple) else v
                             for k, v in BUDGETS.items()}
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


@pytest.fixture(scope="module")
def main_runs(root, tmp_path_factory):
    """``main`` under configs/train/modelnet.yaml (tiny widths and budgets,
    256 points, 1 epoch) in train, val and test mode."""
    out = tmp_path_factory.mktemp("modelnet_main")
    return {mode: tmain.main(["--config", _write_yaml(out / f"{mode}.yaml", root, mode=mode,
                                                      exp_dir=str(out / mode)),
                              "--device", "cpu"])
            for mode in ("train", "val", "test")}


def test_main_trains_validates_and_tests_on_cpu(main_runs):
    trained = main_runs["train"]
    assert trained.state.step == len(trained.loaders["train"]) == 4
    assert trained.cfg.architecture.count("resnetb_strided") == 2
    with open(os.path.join(trained.cfg.exp_dir, "log")) as f:
        summaries = [line for line in f if line.startswith(("train Epoch 0:", "val Epoch 0:"))]
    assert len(summaries) == 2
    for line in summaries:
        words = line.split()
        stats = {k.rstrip(":"): v for k, v in zip(words[3::2], words[4::2])}
        assert np.isfinite(float(stats["total"])) and np.isfinite(float(stats["circle_loss"]))
    batch, _ = next(iter(trained.loaders["train"]))
    assert batch.extras["points_raw"].shape == (1, 2048, 3) and batch.raw_points is None
    assert sorted(main_runs["val"].loaders) == ["val"]
    summary = main_runs["test"]
    assert summary["n_pairs"] == 3 and all(np.isfinite(v) for v in summary.values())


@pytest.mark.parametrize("mode", ["train", "test"])
def test_build_datasets_matches_jax(root, mode):
    tc, jc = _configs(root, mode=mode)
    got, want = tmain.build_datasets(tc), jmain.build_datasets(jc)
    assert sorted(got) == sorted(want)
    for phase, ds in want.items():
        assert isinstance(got[phase], tm.ModelNetHdf) and len(got[phase]) == len(ds)
        np.testing.assert_array_equal(got[phase]._labels, ds._labels)


def test_main_without_cuda_raises(root, tmp_path):
    """Without ``--device cpu`` the entry point runs on CUDA, and raises
    where there is none (no quiet fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    path = _write_yaml(tmp_path / "m.yaml", root, mode="test", exp_dir=str(tmp_path / "x"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--config", path])
