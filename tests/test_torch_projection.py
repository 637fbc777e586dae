"""The port's camera projection against the JAX package's
(``pcrcg_tpu/ops/projection.py``), compiled, on the same inputs.

Inputs: numpy seeds.  Besides points in front of the camera, each scene
holds points behind it, at z = 0 (on and off the optical axis), far
outside the frustum (projections past the int32 range), with u or v in
(−1, 0) (trunc lands them on pixel 0), NaN coordinates and masked-out
points.  Equal: valid on every point, and pix on the in-bounds points.
A finite point out of bounds is outside the image in both packages; a NaN
one is too in the port, where the JAX package's cast makes its pixel
(0, 0) (its valid is False in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrcg_tpu.ops import projection as jproj
from pcrcg_tpu_torch.ops import projection as tproj


def _scene(seed, n=400, h=30, w=40):
    rng = np.random.default_rng(seed)
    intr = np.eye(4)
    intr[0, 0] = intr[1, 1] = 20.0
    intr[0, 2], intr[1, 2] = w / 2, h / 2
    w2c = np.eye(4)
    q, r = np.linalg.qr(rng.normal(scale=0.05, size=(3, 3)) + np.eye(3))
    w2c[:3, :3] = q * np.sign(np.diag(r))
    w2c[:3, 3] = rng.normal(scale=0.05, size=3)
    # Camera-frame points, mapped to the world below.
    cam = rng.uniform(-1, 1, size=(n, 3))
    cam[:, 2] += 3.0
    k = n // 10
    cam[:k, 2] = -rng.uniform(0.01, 3.0, k)  # behind the camera
    cam[k:2 * k, 2] = 0.0  # on the camera plane
    cam[2 * k, :] = 0.0  # the camera center
    cam[2 * k + 1:3 * k, :2] *= 1e9  # far outside the frustum
    # Just left of and above the image: u and v in (-1, 0), pixel (0, 0).
    z = 2.9 + rng.uniform(-0.05, 0.05, k)
    cam[3 * k:4 * k] = np.stack([(-0.5 - w / 2) * z / 20.0, (-0.3 - h / 2) * z / 20.0, z], 1)
    depth = np.full((h, w), 3.0) + rng.normal(scale=0.5, size=(h, w))
    depth[0, 0] = 2.9
    depth[1, 1] = -0.0
    depth[2, 2] = 0.0
    # The camera depth of half the front points (within 0.05 m) at their
    # pixel, so many pass the consistency test.
    front = np.arange(4 * k + 1, n, 2)
    img = cam[front] @ intr[:3, :3].T
    u, v = (img[:, :2] / img[:, 2:]).astype(int).T
    ok = (u >= 1) & (u < w) & (v >= 1) & (v < h)
    depth[v[ok], u[ok]] = img[ok, 2] + rng.uniform(-0.05, 0.05, ok.sum())
    pts = (cam - w2c[:3, 3]) @ w2c[:3, :3]
    pts[4 * k, 0] = np.nan
    mask = rng.uniform(size=n) > 0.1
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(pts), f32(depth), f32(w2c), f32(intr), mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_project_points_matches_jax(seed):
    pts, depth, w2c, intr, mask = _scene(seed)
    want_pix, want_valid = jax.jit(jproj.project_points)(pts, depth, w2c, intr, mask)
    want_pix, want_valid = np.asarray(want_pix), np.asarray(want_valid)
    got_pix, got_valid = tproj.project_points(*(torch.from_numpy(a) for a in
                                                (pts, depth, w2c, intr, mask)))
    got_pix, got_valid = got_pix.numpy(), got_valid.numpy()
    h, w = depth.shape

    def inside(p):
        return (p[:, 0] >= 0) & (p[:, 0] < w) & (p[:, 1] >= 0) & (p[:, 1] < h)

    finite = np.isfinite(pts).all(1)
    np.testing.assert_array_equal(got_valid, want_valid)
    np.testing.assert_array_equal(inside(got_pix)[finite], inside(want_pix)[finite])
    assert not inside(got_pix)[~finite].any() and inside(want_pix)[~finite].all()
    seen = inside(want_pix) & finite
    np.testing.assert_array_equal(got_pix[seen], want_pix[seen])
    assert got_valid.sum() > 50 and (~seen).sum() > 80
    assert got_valid[3 * (len(pts) // 10):4 * (len(pts) // 10)].any()  # trunc to pixel 0


def test_project_points_batched_equals_per_image():
    """The lift projects [2, I] images at once: the same as one at a time."""
    scenes = [_scene(s) for s in range(4)]
    pts = np.stack([s[0] for s in scenes[:2]])  # [2, N, 3]
    depth = np.stack([s[1] for s in scenes]).reshape(2, 2, 30, 40)
    w2c = np.stack([s[2] for s in scenes]).reshape(2, 2, 4, 4)
    mask = np.stack([s[4] for s in scenes[:2]])
    intr = scenes[0][3]
    t = torch.from_numpy
    pix, valid = tproj.project_points(t(pts)[:, None], t(depth), t(w2c), t(intr),
                                      t(mask)[:, None])
    for c in range(2):
        for i in range(2):
            p1, v1 = tproj.project_points(t(pts[c]), t(depth[c, i]), t(w2c[c, i]), t(intr),
                                          t(mask[c]))
            assert torch.equal(pix[c, i], p1) and torch.equal(valid[c, i], v1)


def test_gather_pixel_features_matches_jax(rng):
    fmap = rng.normal(size=(5, 7, 3)).astype(np.float32)
    pix = np.array([[2, 1], [6, 4], [0, 0], [-1, 9], [7, 5]], np.int32)
    valid = np.array([True, True, False, False, True])
    want = np.asarray(jproj.gather_pixel_features(jnp.asarray(fmap), jnp.asarray(pix),
                                                  jnp.asarray(valid)))
    got = tproj.gather_pixel_features(torch.from_numpy(fmap), torch.from_numpy(pix),
                                      torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("to_dim", [(160, 120), (320, 240), (640, 480), (100, 100), (200, 50)])
def test_adjust_intrinsic_matches_jax(to_dim):
    intr = np.array([[585.0, 0, 320], [0, 585.0, 240], [0, 0, 1]])
    np.testing.assert_array_equal(tproj.adjust_intrinsic(intr, (640, 480), to_dim),
                                  jproj.adjust_intrinsic(intr, (640, 480), to_dim))


def test_unproject_matches_jax(rng):
    depth = rng.uniform(0.5, 3.0, size=(12, 16))
    depth[rng.uniform(size=depth.shape) < 0.3] = 0.0
    intr = np.array([[20.0, 0, 8.0, 0.01], [0, 21.0, 6.0, -0.02], [0, 0, 1, 0], [0, 0, 0, 1]])
    pose = np.eye(4)
    pose[:3, 3] = [0.1, -0.2, 0.3]
    got = tproj.unproject(depth, intr, pose)
    np.testing.assert_array_equal(got, jproj.unproject(depth, intr, pose))
    assert got.shape == (int((depth > 0).sum()), 3)


def test_negative_zero_depth_is_read_as_zero():
    """A −0.0 depth: the JAX package's one-hot lookup reads +0.0, the
    port's gather −0.0; the consistency test gives the same valid bits.
    The last point sits 5 cm behind the camera: both packages take it, as
    |z − depth| < thresh holds for it on a zero-depth pixel."""
    h, w = 8, 10
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = 20.0
    intr[0, 2], intr[1, 2] = w / 2, h / 2
    depth = np.full((h, w), 2.0, np.float32)
    depth[1, 1], depth[2, 2] = -0.0, 0.0
    z = np.array([0.05, 0.2, 0.05, 0.2, -0.05], np.float32)
    px = np.array([1, 1, 2, 2, 1], np.float32)
    pts = np.stack([(px + 0.5 - w / 2) * z / 20.0, (px + 0.5 - h / 2) * z / 20.0, z], 1)
    args = (pts.astype(np.float32), depth, np.eye(4, dtype=np.float32), intr,
            np.ones(5, bool))
    want_pix, want_valid = jax.jit(jproj.project_points)(*args)
    got_pix, got_valid = tproj.project_points(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_valid.numpy(), [True, False, True, False, True])
    np.testing.assert_array_equal(got_pix.numpy(), np.asarray(want_pix))
