"""The port's KPFCNN against the JAX KPFCNN on the same pyramid and the same
weights (carried across by ``state_dict_from_jax``), tiny config, a crop
of the in-repo assets pair.  The port runs each of its KPConv routes
(``ROUTES``); the JAX model on the CPU takes its dense route whatever the
config says, so one JAX reference serves them all."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrcg_tpu import config as jcfg
from pcrcg_tpu.assets import demo_cloud_pair
from pcrcg_tpu.data.pair import make_pair_batch
from pcrcg_tpu.models.kpfcnn import KPFCNN as JKPFCNN
from pcrcg_tpu.models.torch_import import export_kpfcnn_state_dict
from pcrcg_tpu.ops.pyramid import build_pyramid_cfg as j_build_pyramid_cfg
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch.models.kpfcnn import KPFCNN, init_kpfcnn, plan_architecture
from pcrcg_tpu_torch.models.weights import state_dict_from_jax
from pcrcg_tpu_torch.ops.pyramid import Pyramid

_BUDGETS = dict(points=(256, 192, 192, 96), neighbors=(16, 16, 16, 16), corr_k=8,
                query_chunk=64, search_tile=32, search_m_tiles=4)
_HEADS = dict(node_overlap=True, quaternion=True)
# The port's KPConv routes: candidate tiles (K2), gathered features (K6 /
# K7), influence + reduce (K8), dense.
ROUTES = {
    "tiled": {},
    "untiled": dict(kpconv_tiled=False),
    "reduce": dict(kpconv_impl="reduce"),
    "xla": dict(kpconv_impl="xla"),
}


def _crop(p, n):
    d = ((p - np.median(p, 0)) ** 2).sum(1)
    return p[np.argsort(d, kind="stable")[:n]]


def pyramid_to_torch(p) -> Pyramid:
    """A JAX Pyramid as the port's Pyramid (int64 indices, int32 metadata)."""
    f = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    i64 = lambda a: f(a).long()  # noqa: E731
    meta = lambda m: (f(m[0]).int(), f(m[1]).int())  # noqa: E731
    return Pyramid(
        points=tuple(f(a) for a in p.points),
        masks=tuple(f(a) for a in p.masks),
        neighbors=tuple(i64(a) for a in p.neighbors),
        pools=tuple(i64(a) for a in p.pools),
        upsamples=tuple(i64(a) for a in p.upsamples),
        conv_local=tuple(meta(m) for m in p.conv_local),
        pool_local=tuple(meta(m) for m in p.pool_local),
    )


@pytest.fixture(scope="module")
def models():
    src, tgt = demo_cloud_pair()
    batch = make_pair_batch(
        [dict(src_pcd=_crop(src, 256), tgt_pcd=_crop(tgt, 240), rot=np.eye(3),
              trans=np.zeros(3))], 256,
    )
    jc = jcfg.tiny_test_config(budgets=jcfg.Budgets(**_BUDGETS), **_HEADS)
    pyr = jax.jit(lambda p, m: j_build_pyramid_cfg(jc, p, m))(batch.points[0], batch.masks[0])
    model = JKPFCNN(jc)
    variables = jax.jit(model.init)(jax.random.key(3), pyr, batch.features[0])
    want = jax.jit(model.apply)(variables, pyr, batch.features[0])
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return jc, variables, pyr, batch, {k: np.asarray(v) for k, v in want.items()}


def test_state_dict_from_jax_matches_export(models):
    _, variables, *_ = models
    got = state_dict_from_jax(variables)
    want = export_kpfcnn_state_dict(variables)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_state_dict_loads_strict(models, route):
    _, variables, *_ = models
    tc = tcfg.tiny_test_config(budgets=tcfg.Budgets(**_BUDGETS), **_HEADS, **ROUTES[route])
    port = KPFCNN(tc)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    # A fresh seeded model carries the same kernel points as the JAX init.
    fresh = init_kpfcnn(tc, seed=0, device="cpu")
    for name, buf in fresh.named_buffers():
        np.testing.assert_array_equal(buf.numpy(), port.get_buffer(name).numpy(), err_msg=name)


def test_plan_matches():
    from pcrcg_tpu.models.kpfcnn import plan_architecture as j_plan

    for cfg_t, cfg_j in ((tcfg.Config(), jcfg.Config()),
                         (tcfg.tiny_test_config(), jcfg.tiny_test_config())):
        assert plan_architecture(cfg_t).__repr__() == j_plan(cfg_j).__repr__()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_kpfcnn_forward_matches_jax(models, route):
    _, variables, pyr, batch, want = models
    tc = tcfg.tiny_test_config(budgets=tcfg.Budgets(**_BUDGETS), **_HEADS, **ROUTES[route])
    port = KPFCNN(tc).eval()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port(pyramid_to_torch(pyr), torch.from_numpy(np.array(batch.features[0])))
    assert set(got) == set(want)
    for key in ("feats_f", "scores_overlap", "scores_saliency", "node_overlap_score_pred",
                "quaternion_pred", "trans_pred"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    assert np.all(np.isfinite(got["feats_f"].numpy()))
