"""The traffic generators depend on the seed alone."""
import numpy as np
import torch

from perfbench.core import files
from perfbench.tests.tiny import TRAFFIC


def _pool(kind, seed):
    torch.set_num_threads(2)
    params = TRAFFIC["tiny_frag" if kind == "frag" else "tiny_lidar"]
    return files.make_pool(params, seed, "cpu", images=kind == "frag")


def _same(a, b):
    for x, y in zip(a, b):
        for k in ("src_pcd", "tgt_pcd", "rot", "trans"):
            if not np.array_equal(x[k], y[k]):
                return False
        for k, v in x.get("images", {}).items():
            if not torch.equal(v, y["images"][k]):
                return False
    return True


def test_fragment_pairs_repeat_per_seed_and_differ_across_seeds():
    a, b, c = _pool("frag", 2**31 + 5), _pool("frag", 2**31 + 5), _pool("frag", 11)
    assert _same(a, b) and not _same(a, c)
    for s in a:  # a rotation: the gt.log entry (orthonormal to ~3e-4) and a random one
        assert np.allclose(s["rot"] @ s["rot"].T, np.eye(3), atol=1e-3)
        assert s["images"]["colors"].shape == (2, 2, 64, 80, 3)
        assert s["images"]["depths"].shape == (2, 2, 32, 40)


def test_fragment_crops_keep_the_same_sizes_on_every_seed():
    sizes = lambda pool: sorted(len(s["src_pcd"]) for s in pool)  # noqa: E731
    params = dict(TRAFFIC["tiny_frag"], max_points=None)
    a = files.make_pool(params, 1, "cpu", images=False)
    b = files.make_pool(params, 2, "cpu", images=False)
    assert sizes(a) == sizes(b)


def test_lidar_pairs_repeat_per_seed_and_differ_across_seeds():
    a, b, c = _pool("lidar", 2**31 + 5), _pool("lidar", 2**31 + 5), _pool("lidar", 11)
    assert _same(a, b) and not _same(a, c)
    for s in a:
        assert len(s["src_pcd"]) > 100
        # 9.9 m apart along the street.
        assert 9.0 < np.linalg.norm(s["trans"]) < 11.0
