"""The port's RPMNet transform chain (``pcrcg_tpu_torch/data/transforms.py``)
against the JAX package's (``pcrcg_tpu/data/transforms.py``): every
transform on the same sample dict, with numpy's global generator seeded
the same before each call (the non-deterministic transforms draw their
per-sample ``RandomState`` seed from it) or the sample marked
deterministic (the test split: the seed is the sample's ``idx``), and
every chain of ``get_transforms``.  Tolerance: none, every array equal
bit for bit (the same numpy code on the same draws).
"""
import numpy as np
import pytest

from pcrcg_tpu.data import transforms as jt
from pcrcg_tpu_torch.data import transforms as tt


def _sample(seed, n=300, width=6, deterministic=False):
    rng = np.random.default_rng(seed)
    s = {"points": rng.normal(size=(n, width)).astype(np.float32), "idx": np.int32(seed)}
    if deterministic:
        s["deterministic"] = True
    return s


def _split(s):
    """A sample as SplitSourceRef leaves it, with a 2-entry crop proportion."""
    s["points_raw"] = s.pop("points")
    s["points_src"] = s["points_raw"][:200].copy()
    s["points_ref"] = s["points_raw"][100:].copy()
    return s


def _run(module, name, args, sample, global_seed):
    np.random.seed(global_seed)
    return getattr(module, name)(*args)(sample)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


# (transform, constructor arguments, sample kind): "points" = a whole cloud,
# "split" = points_src / points_ref.
CASES = [
    ("SetDeterministic", (), "points"),
    ("SplitSourceRef", (), "points"),
    ("Resampler", (128,), "points"),
    ("Resampler", (512,), "points"),
    ("Resampler", (128,), "split"),
    ("FixedResampler", (700,), "points"),
    ("FixedResampler", (90,), "split"),
    ("RandomJitter", (), "points"),
    ("RandomJitter", (0.02, 0.03), "split"),
    ("RandomCrop", ([0.7, 0.7],), "split"),
    ("RandomCrop", ([0.5],), "split"),
    ("RandomCrop", ([1.0, 1.0],), "split"),
    ("RandomTransformSE3", (), "points"),
    ("RandomTransformSE3", (45.0, 0.5, True), "split"),
    ("RandomTransformSE3_euler", (45.0, 0.5), "split"),
    ("RandomTransformSE3_euler", (180.0, 1.0, True), "points"),
    ("RandomRotatorZ", (), "split"),
    ("ShufflePoints", (), "points"),
    ("ShufflePoints", (), "split"),
]


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("name,args,kind", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_transform_matches_jax(name, args, kind, deterministic):
    def sample():
        s = _sample(11, deterministic=deterministic)
        if kind == "split":
            s = _split(s)
            if name == "Resampler":
                s["crop_proportion"] = np.asarray([0.7, 0.6], np.float32)
        return s

    got = _run(tt, name, args, sample(), 5)
    want = _run(jt, name, args, sample(), 5)
    _assert_same(got, want)


def test_uniform_2_sphere_and_helpers_match_jax():
    for seed in range(5):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(tt.uniform_2_sphere(a), jt.uniform_2_sphere(b))
    axis, angle = np.array([0.3, -0.4, 0.8]), 0.7
    np.testing.assert_array_equal(tt._axis_angle_matrix(axis, angle),
                                  jt._axis_angle_matrix(axis, angle))
    g = jt.RandomTransformSE3().generate_transform(np.random.RandomState(3))
    np.testing.assert_array_equal(tt._se3_inverse(g), jt._se3_inverse(g))


@pytest.mark.parametrize("noise_type", ["clean", "jitter", "crop"])
@pytest.mark.parametrize("phase", ["train", "test"])
@pytest.mark.parametrize("width", [3, 6])
def test_get_transforms_chain_matches_jax(noise_type, phase, width):
    """Each chain of ``get_transforms`` (ModelNet's protocol: 45 deg, 0.5,
    crops of 0.7) on three samples, with and without normals."""
    pick = 0 if phase == "train" else 1
    got_chain = tt.get_transforms(noise_type, 45.0, 0.5, 256, [0.7, 0.7])[pick]
    want_chain = jt.get_transforms(noise_type, 45.0, 0.5, 256, [0.7, 0.7])[pick]
    assert [type(t).__name__ for t in got_chain.transforms] == [
        type(t).__name__ for t in want_chain.transforms]
    for seed in range(3):
        np.random.seed(100 + seed)
        got = got_chain(_sample(seed, n=512, width=width))
        np.random.seed(100 + seed)
        want = want_chain(_sample(seed, n=512, width=width))
        _assert_same(got, want)
        assert "transform_gt" in got and got["points_src"].shape[1] == width


def test_unknown_noise_type_raises():
    with pytest.raises(NotImplementedError):
        tt.get_transforms("outliers")
