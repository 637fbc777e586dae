"""The port's interest-point sampling, matching and RANSAC against the JAX
package with the JAX draws injected, and the whole pair -> SE(3) path
(``register_pair`` vs ``register_pair_jit``) on the tiny config."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrcg_tpu import config as jcfg
from pcrcg_tpu.assets import demo_cloud_pair
from pcrcg_tpu.data.pair import make_pair_batch
from pcrcg_tpu.eval.tester import register_pair_jit
from pcrcg_tpu.models.kpfcnn import KPFCNN as JKPFCNN
from pcrcg_tpu.ops.pyramid import build_pyramid_cfg as j_build_pyramid_cfg
from pcrcg_tpu.registration import procrustes as jproc
from pcrcg_tpu.registration.ransac import feature_correspondences as j_corr
from pcrcg_tpu.registration.ransac import ransac_pose as j_ransac
from pcrcg_tpu.registration.sampling import weighted_sample_topk as j_sample
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch.eval.tester import register_pair
from pcrcg_tpu_torch.models.kpfcnn import KPFCNN
from pcrcg_tpu_torch.models.weights import state_dict_from_jax
from pcrcg_tpu_torch.registration import procrustes as tproc
from pcrcg_tpu_torch.registration.ransac import feature_correspondences, ransac_pose
from pcrcg_tpu_torch.registration.sampling import weighted_sample_topk

T = torch.from_numpy


def jax_uniform(key, shape):
    """The Gumbel uniforms ``pcrcg_tpu/registration/sampling.py:27`` draws."""
    return np.asarray(jax.random.uniform(key, shape, minval=1e-20, maxval=1.0))


def jax_picks(key, n_valid, num_iterations, chunk, ransac_n=3):
    """The hypothesis draws ``pcrcg_tpu/registration/ransac.py:123-126,151-152``
    makes, before its valid-first reordering."""
    n_chunks = max(num_iterations // chunk, 1)
    keys = jax.random.split(key, n_chunks)
    return np.stack([
        np.asarray(jax.random.randint(k, (chunk, ransac_n), 0, max(int(n_valid), 1)))
        for k in keys
    ])


def test_procrustes_fits_match():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5, 7, 3)).astype(np.float32)
    b = (a @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.3).astype(np.float32)
    b += rng.normal(scale=0.01, size=b.shape).astype(np.float32)
    w = rng.uniform(size=(5, 7)).astype(np.float32)
    for tf, jf, args in (
        (tproc.rigid_transform, jproc.rigid_transform, (a, b, w)),
        (tproc.rigid_transform_horn, jproc.rigid_transform_horn, (a, b, w)),
        (tproc.rigid_transform_3pt, jproc.rigid_transform_3pt, (a, b)),
    ):
        got = tf(*(T(x) for x in args)).numpy()
        want = np.asarray(jf(*(jnp.asarray(x) for x in args)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=tf.__name__)


def test_registration_with_injected_draws():
    """Same scores, features and draws: sampled indices and correspondences
    equal, RANSAC transform within 1e-4, fitness equal."""
    rng = np.random.default_rng(1)
    n, n_points = 400, 150
    pts = rng.uniform(0, 2, size=(2, n, 3)).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    rot *= np.sign(np.linalg.det(rot))
    pts[1] = pts[0] @ rot.T + np.float32(0.2)
    pts[1] += rng.normal(scale=0.005, size=(n, 3)).astype(np.float32)
    masks = np.ones((2, n), bool)
    masks[1, -30:] = False
    scores = rng.uniform(size=(2, n)).astype(np.float32)
    feats = rng.normal(size=(2, n, 8)).astype(np.float32)
    feats[1] = feats[0] + rng.normal(scale=0.1, size=(n, 8)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)

    k1, k2, k3 = jax.random.split(jax.random.key(5), 3)
    sel = []
    for c, k in enumerate((k1, k2)):
        w_idx, w_ok = j_sample(k, jnp.asarray(scores[c]), jnp.asarray(masks[c]), n_points)
        g_idx, g_ok = weighted_sample_topk(T(scores[c]), T(masks[c]), n_points,
                                           uniform=T(jax_uniform(k, (n,))))
        np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
        np.testing.assert_array_equal(g_ok.numpy(), np.asarray(w_ok))
        sel.append((np.asarray(w_idx), np.asarray(w_ok)))
    (si, so), (ti, to) = sel
    s_pts, t_pts = pts[0][si], pts[1][ti]
    s_f, t_f = feats[0][si], feats[1][ti]
    for mutual in (False, True):
        w_corr, w_valid = j_corr(jnp.asarray(s_f), jnp.asarray(t_f), jnp.asarray(so),
                                 jnp.asarray(to), mutual=mutual)
        g_corr, g_valid = feature_correspondences(T(s_f), T(t_f), T(so), T(to), mutual=mutual)
        np.testing.assert_array_equal(g_corr.numpy(), np.asarray(w_corr))
        np.testing.assert_array_equal(g_valid.numpy(), np.asarray(w_valid))
    corr, valid = np.asarray(w_corr), np.asarray(w_valid)
    iters, chunk = 2048, 256
    want = j_ransac(k3, jnp.asarray(s_pts), jnp.asarray(t_pts), jnp.asarray(corr),
                    jnp.asarray(valid), num_iterations=iters, hypothesis_chunk=chunk)
    got = ransac_pose(T(s_pts), T(t_pts), T(corr), T(valid), num_iterations=iters,
                      hypothesis_chunk=chunk,
                      picks=T(jax_picks(k3, valid.sum(), iters, chunk)))
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform),
                               rtol=1e-4, atol=1e-4)
    assert float(got.fitness) == float(want.fitness)
    assert float(want.fitness) > 0.1  # a real registration, not a degenerate one


def _crop(p, n):
    d = ((p - np.median(p, 0)) ** 2).sum(1)
    return p[np.argsort(d, kind="stable")[:n]]


def test_register_pair_matches_jax_end_to_end(capsys):
    """register_pair against register_pair_jit on the tiny config with the
    same weights and the JAX draws injected: the transforms satisfy the
    3DMatch RMSE <= 0.2 m criterion on the source cloud."""
    budgets = dict(points=(256, 192, 192, 96), neighbors=(16, 16, 16, 16), corr_k=8,
                   query_chunk=64, search_tile=32, search_m_tiles=4)
    jc = jcfg.tiny_test_config(budgets=jcfg.Budgets(**budgets))
    tc = tcfg.tiny_test_config(budgets=tcfg.Budgets(**budgets))
    src, tgt = demo_cloud_pair()
    batch = make_pair_batch(
        [dict(src_pcd=_crop(src, 256), tgt_pcd=_crop(tgt, 240), rot=np.eye(3),
              trans=np.zeros(3))], 256,
    )
    pts, msk, fts = batch.points[0], batch.masks[0], batch.features[0]
    model = JKPFCNN(jc)
    pyr = jax.jit(lambda p, m: j_build_pyramid_cfg(jc, p, m))(pts, msk)
    variables = jax.jit(model.init)(jax.random.key(11), pyr, fts)
    n_points, iters, chunk = 128, 2048, 256
    key = jax.random.key(4)
    want = register_pair_jit(model, jc, variables, pts, msk, fts, key, None,
                             n_points=n_points, num_iterations=iters, hypothesis_chunk=chunk)

    k1, k2, k3 = jax.random.split(key, 3)
    n_valid = min(int(np.asarray(msk[0]).sum()), n_points)
    port = KPFCNN(tc).eval()
    port.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    got = register_pair(
        port, tc, T(np.array(pts)), T(np.array(msk)), T(np.array(fts)),
        n_points=n_points, num_iterations=iters, hypothesis_chunk=chunk,
        uniforms=(T(jax_uniform(k1, (256,))), T(jax_uniform(k2, (256,)))),
        picks=T(jax_picks(k3, n_valid, iters, chunk)), device="cpu",
    )
    src_pts = np.asarray(pts[0])[np.asarray(msk[0])].astype(np.float64)
    tj, tt = np.asarray(want["transform"], np.float64), got["transform"].numpy().astype(np.float64)
    move = lambda t: src_pts @ t[:, :3].T + t[:, 3]  # noqa: E731
    rmse = float(np.sqrt(np.mean(np.sum((move(tj) - move(tt)) ** 2, -1))))
    fj = np.asarray(want["outputs"]["feats_f"])
    ft = got["outputs"]["feats_f"].numpy()
    cos = np.sum(fj * ft, -1)[np.asarray(msk)]
    with capsys.disabled():
        print(f"\nregister_pair vs register_pair_jit: transform RMSE {rmse:.3e} m, "
              f"descriptor cosine min {cos.min():.7f} mean {cos.mean():.7f}, "
              f"fitness {float(got['fitness']):.4f} vs {float(want['fitness']):.4f}")
    assert rmse <= 0.2
    assert cos.min() > 0.999
