"""The port's host data path against the JAX package, bit for bit:
``data/indoor.py::IndoorDataset`` (the 30k cap, augmentation, the image
pair), ``data/loader.py::PairLoader`` (shuffle, per-batch generators, the
random level-0 truncation, the batched image stack) and
``data/calibrate.py`` (over the port's ``native.py``), all on a split that
``assets.py::write_indoor_fixture`` writes from the demo clouds.  Also the
fixture itself: its ground truth aligns the fragments and its images are
consistent with the world2cam the dataset builds.
"""
import dataclasses

import numpy as np
import pytest
from scipy.spatial import cKDTree

from pcrcg_tpu import config as jcfg
from pcrcg_tpu.data import calibrate as jcal
from pcrcg_tpu.data.indoor import IndoorDataset as JIndoorDataset
from pcrcg_tpu.data.loader import PairLoader as JPairLoader
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch.assets import write_indoor_fixture
from pcrcg_tpu_torch.data import calibrate as tcal
from pcrcg_tpu_torch.data.indoor import IndoorDataset
from pcrcg_tpu_torch.data.loader import PairLoader

N_PAIRS = 4


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return write_indoor_fixture(tmp_path_factory.mktemp("indoor"), N_PAIRS, seed=1, images=True)


def _configs(fx, images):
    kw = dict(root=fx["root"])
    if images:
        kw.update(image_feature=True, in_feats_dim=129, img_path=fx["img_path"],
                  superglue_matches_path=fx["matches"])
    return tcfg.tiny_test_config(**kw), jcfg.tiny_test_config(**kw)


def _datasets(fx, images, augment, max_points=None):
    tc, jc = _configs(fx, images)
    pair = IndoorDataset(fx["info"], tc, augment), JIndoorDataset(fx["info"], jc, augment)
    if max_points is not None:
        for ds in pair:
            ds.MAX_POINTS = max_points
    return pair


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in got:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and np.array_equal(g, w), k


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("images", [False, True])
def test_indoor_dataset_matches_jax(fixture, augment, images):
    """Every sample array equal, the cap at 5,000 points drawing from the
    generator first, then the augmentation's draws."""
    ds, jds = _datasets(fixture, images, augment, max_points=5000)
    assert len(ds) == len(jds) == N_PAIRS
    for item in range(N_PAIRS):
        for seed in (0, 1):
            _assert_same(ds.get(item, np.random.default_rng(seed)),
                         jds.get(item, np.random.default_rng(seed)))


def _batches(loader, epochs=2):
    out = []
    for _ in range(epochs):
        for batch, images in loader:
            arrays = [np.asarray(getattr(batch, f)) for f in
                      ("points", "masks", "features", "rot", "trans")]
            if images is not None:
                arrays += [np.asarray(images[k]) for k in sorted(images)]
            out.append(arrays)
    return out


@pytest.mark.parametrize("threads", [1, 4])
def test_pair_loader_matches_jax(fixture, threads):
    """Two shuffled epochs of augmented image batches (batch 2; level-0
    budget 4,096, below every fragment, so the random truncation draws from
    each batch's generator): equal to the JAX loader's with one thread."""
    ds, jds = _datasets(fixture, images=True, augment=True)
    got = _batches(PairLoader(ds, 4096, batch_size=2, shuffle=True, num_threads=threads,
                              seed=3))
    want = _batches(JPairLoader(jds, 4096, batch_size=2, shuffle=True, num_threads=1, seed=3))
    assert len(got) == len(want) == 2 * (N_PAIRS // 2)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 10
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_pair_loader_set_epoch_continues_the_order(fixture):
    """A loader moved to epoch 1 yields what a fresh loader's second epoch
    yields (a resumed run's data)."""
    ds, _ = _datasets(fixture, images=False, augment=True)
    loader = PairLoader(ds, 4096, batch_size=1, shuffle=True, num_threads=2, seed=5)
    second = _batches(loader, epochs=2)[N_PAIRS:]
    resumed = PairLoader(ds, 4096, batch_size=1, shuffle=True, num_threads=2, seed=5)
    resumed.set_epoch(1)
    for g, w in zip(_batches(resumed, epochs=1), second):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))


def test_pair_loader_ragged_guard(fixture):
    ds, jds = _datasets(fixture, images=False, augment=False)
    for cls, d in ((PairLoader, ds), (JPairLoader, jds)):
        with pytest.raises(ValueError, match="drop_last"):
            cls(d, 4096, batch_size=3, drop_last=False)
    loader = PairLoader(ds, 32768, batch_size=2, num_threads=2, drop_last=False)
    assert len(_batches(loader, epochs=1)) == N_PAIRS // 2


def test_occupancy_and_calibration_match_jax(fixture):
    ds, jds = _datasets(fixture, images=False, augment=False)
    tc, jc = _configs(fixture, images=False)
    assert tcal.occupancy_report(ds, tc, num_samples=3) == jcal.occupancy_report(jds, jc,
                                                                                num_samples=3)
    got = tcal.calibrate_budgets(ds, tc, num_samples=2)
    want = jcal.calibrate_budgets(jds, jc, num_samples=2)
    for f in ("points", "neighbors", "corr_k", "query_chunk"):
        assert getattr(got, f) == getattr(want, f), f
    assert dataclasses.is_dataclass(got)


def _depth_share(points, w2c, depth, intr):
    """Share of the points that land in the image whose depth they meet
    within 0.1 m."""
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    cam = cam[cam[:, 2] > 0.05]
    u = np.floor(intr[0, 0] * cam[:, 0] / cam[:, 2] + intr[0, 2]).astype(int)
    v = np.floor(intr[1, 1] * cam[:, 1] / cam[:, 2] + intr[1, 2]).astype(int)
    inside = (u >= 0) & (u < depth.shape[1]) & (v >= 0) & (v < depth.shape[0])
    return (np.abs(depth[v[inside], u[inside]] - cam[inside, 2]) < 0.1).mean()


def test_fixture_geometry_and_images_are_consistent(fixture):
    """The GT pose maps each source fragment onto its target (over a tenth
    of the source within 3.75 cm after it, the pickle's overlap), and the
    dataset's world2cam (I, then pose2^-1 pose1) projects each fragment
    onto its own renders: over a quarter of the points meet the depth
    within 0.1 m (the rest are occluded from that view), over three times
    the share under the other image's world2cam."""
    ds, _ = _datasets(fixture, images=True, augment=False)
    for item in range(N_PAIRS):
        s = ds.get(item, np.random.default_rng(0))
        warped = s["src_pcd"] @ s["rot"].T + s["trans"]
        dist, _ = cKDTree(s["tgt_pcd"]).query(warped)
        assert (dist < 0.0375).mean() > 0.1
        assert abs((dist < 0.0375).mean() - ds.infos["overlap"][item]) < 0.02
        intr = s["intrinsics"].astype(np.float64)
        for c, key in enumerate(("src_pcd", "tgt_pcd")):
            w2c = s["world2cam"][c].astype(np.float64)
            for i in range(2):
                right = _depth_share(s[key], w2c[i], s["depths"][c, i], intr)
                wrong = _depth_share(s[key], w2c[1 - i], s["depths"][c, i], intr)
                assert right > 0.25 and right > 3 * wrong, (item, c, i, right, wrong)
            assert s["valid_maps"][c].mean() > 0.5
