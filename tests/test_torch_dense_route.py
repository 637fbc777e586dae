"""The port's dense search route (``search_impl: dense``) against the JAX
package on the CPU, at the tiny config on the training crop of the in-repo
assets pair (``tests/test_torch_train.py``).

The route is the reference's (pcrcg_tpu/ops/pyramid.py:152-167): raster-order
subsampling, the dense radius search for conv, pool and k = 1 upsample, no
tile-local metadata, so ``KPFCNN`` takes the untiled KPConv route; the loss's
overlap and correspondence searches are dense too
(pcrcg_tpu/losses.py:152-157, 189-195).

* The pyramid against the compiled JAX one: masks, overflow and every index
  equal, points within 1e-6 (voxel barycenters summed in the same order).
* ``KPFCNN`` on each package's own dense pyramid, JAX weights carried
  across: outputs within 1e-4 of the largest entry.
* One pair's loss and gradients against the JAX package's compiled
  value-and-grad (compiled once): stats rtol 1e-4, each gradient
  ‖Δg‖ ≤ 1e-3·‖g‖ + 1e-6·max_p ‖g_p‖, the tolerances of
  ``tests/test_torch_train.py``.
"""
import jax
import numpy as np
import pytest
import torch

from pcrcg_tpu import config as jcfg
from pcrcg_tpu.data.pair import make_pair_batch as j_make_pair_batch
from pcrcg_tpu.models.kpfcnn import KPFCNN as JKPFCNN
from pcrcg_tpu.ops.pyramid import build_pyramid_cfg as j_build_pyramid_cfg
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.models.kpfcnn import KPFCNN
from pcrcg_tpu_torch.models.weights import state_dict_from_jax
from pcrcg_tpu_torch.ops import kpconv_fused, kpconv_tiled
from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import pair_loss

from test_torch_train import BUDGETS, HEADS, jax_value_and_grad, overlap_crop, pair_uniforms

DENSE = dict(BUDGETS, search_impl="dense")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    jc = jcfg.tiny_test_config(budgets=jcfg.Budgets(**DENSE), **HEADS)
    batch = j_make_pair_batch([overlap_crop()], jc.budgets.points[0])
    pyr, overflow = jax.jit(lambda p, m: j_build_pyramid_cfg(jc, p, m, with_overflow=True))(
        batch.points[0], batch.masks[0])
    model = JKPFCNN(jc)
    variables = jax.jit(model.init)(jax.random.key(3), pyr, batch.features[0])
    vg = jax_value_and_grad(jc, batch, (pyr, overflow), model, variables, with_outputs=True)
    key = jax.random.key(11)
    (_, (stats, out)), grads = vg(variables["params"], key)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return dict(
        pyramid=jax.tree_util.tree_map(np.asarray, pyr), overflow=np.asarray(overflow),
        variables=variables, out={k: np.asarray(v) for k, v in out.items()},
        stats={k: float(v) for k, v in stats.items()},
        grads=state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)}),
        uniforms=pair_uniforms(key, 1, jc.budgets.points[0], jc.budgets.corr_k),
    )


def port_setup(variables):
    tc = tcfg.tiny_test_config(budgets=tcfg.Budgets(**DENSE), **HEADS)
    model = KPFCNN(tc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    batch = make_pair_batch([overlap_crop()], tc.budgets.points[0])
    return tc, TrainState(tc, model), batch


def test_dense_pyramid_matches_jax(reference):
    want = reference["pyramid"]
    tc, _, batch = port_setup(reference["variables"])
    got, overflow = build_pyramid_cfg(tc, batch.points[0], batch.masks[0], with_overflow=True)
    np.testing.assert_array_equal(overflow.numpy(), reference["overflow"])
    assert got.conv_local == () and got.pool_local == ()
    for lvl in range(len(want.points)):
        np.testing.assert_array_equal(got.masks[lvl].numpy(), want.masks[lvl])
        np.testing.assert_allclose(got.points[lvl].numpy(), want.points[lvl], rtol=0, atol=1e-6)
    for name in ("neighbors", "pools", "upsamples"):
        for lvl, (g, w) in enumerate(zip(getattr(got, name), getattr(want, name))):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{name}[{lvl}]")


def test_dense_route_takes_the_untiled_kpconvs(reference, monkeypatch):
    """No candidate-tile call; the gathered-feature entries (K6 / K7's
    plain versions here) carry every conv."""
    calls = {"tiled": 0, "fused": 0, "merged": 0}

    def count(key, real):
        def fn(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        return fn

    import pcrcg_tpu_torch.models.kpconv as kpconv_mod
    monkeypatch.setattr(kpconv_mod, "kpconv_tiled_ad", count("tiled", kpconv_tiled.kpconv_tiled_ad))
    monkeypatch.setattr(kpconv_fused, "kpconv_fused_ad",
                        count("fused", kpconv_fused.kpconv_fused_ad))
    monkeypatch.setattr(kpconv_fused, "kpconv_fused_merged_ad",
                        count("merged", kpconv_fused.kpconv_fused_merged_ad))
    tc, state, batch = port_setup(reference["variables"])
    with torch.no_grad():
        state.model(build_pyramid_cfg(tc, batch.points[0], batch.masks[0]), batch.features[0])
    assert calls == {"tiled": 0, "fused": 8, "merged": 3}


def test_dense_forward_matches_jax(reference):
    tc, state, batch = port_setup(reference["variables"])
    with torch.no_grad():
        got = state.model(build_pyramid_cfg(tc, batch.points[0], batch.masks[0]),
                          batch.features[0])
    assert set(got) == set(reference["out"])
    for k, v in reference["out"].items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-4 * np.abs(v).max(),
                                   err_msg=k)


def test_dense_pair_loss_and_gradients_match_jax(reference):
    want, want_grads = reference["stats"], reference["grads"]
    tc, state, batch = port_setup(reference["variables"])
    stats = pair_loss(state.model, tc, batch.points[0], batch.masks[0], batch.features[0],
                      batch.rot[0], batch.trans[0], uniforms=reference["uniforms"][0])
    stats["total"].backward()
    assert set(stats) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(stats[k].detach()), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert want["circle_loss"] > 0 and want["recall"] > 0
    floor = 1e-6 * max(float(g.norm()) for g in want_grads.values())
    for name, p in state.model.named_parameters():
        g, w = p.grad.double(), want_grads[name].double().reshape(p.shape)
        assert float((g - w).norm()) <= 1e-3 * float(w.norm()) + floor, name
