"""The port's training slice against the JAX package on the CPU: one pair
of the tiny config on an overlapping crop of the in-repo assets pair
(cloud_bin_21 → cloud_bin_34 under its 3DLoMatch ground-truth pose), the
node-overlap and pose heads on, JAX weights carried across by
``state_dict_from_jax``, the circle-loss draws injected from the JAX key.

Reference: compiled JAX (``jax.jit``) of the JAX package's ``pair_loss``
— ``model.apply`` then ``metric_loss`` — and its ``jax.value_and_grad``,
followed by ``TrainState.apply_gradients`` (together what its
``train_step`` runs).  The pyramid carries no gradient and is compiled on
its own: the port reproduces the rounding of the stand-alone compiled
pyramid index for index, while inside one larger program XLA fuses the
search distances another way and near-tied neighbors come out in
another order (on this crop 168 level-0 entries, 3 of them changing a
row's neighbor set).  Tolerances: loss stats rtol 1e-4 (fp32 sums in
another order through ~20 layers); each parameter's gradient
‖Δg‖ ≤ 1e-3·‖g‖ + 1e-6·max_p ‖g_p‖ (the backward sums over H neighbors and
scatters in another order, and the JAX CPU route takes the dense
``kpconv`` path while the port runs the candidate-tile kernels' plain
versions; the absolute floor covers the biases whose gradient is zero in
exact arithmetic — ahead of an instance norm or a softmax — and is
rounding noise of ~1e-9 in both).  Worst measured: stats 1.8e-7
relative, gradients 1.1e-4 relative norm (``epsilon``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrcg_tpu import config as jcfg
from pcrcg_tpu.data.pair import make_pair_batch as j_make_pair_batch
from pcrcg_tpu.models.kpfcnn import KPFCNN as JKPFCNN
from pcrcg_tpu.ops.pyramid import build_pyramid_cfg as j_build_pyramid_cfg
from pcrcg_tpu.geom import so3 as j_so3
from pcrcg_tpu.losses import LossInputs as JLossInputs
from pcrcg_tpu.losses import metric_loss as j_metric_loss
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.models.kpfcnn import KPFCNN
from pcrcg_tpu_torch.models.weights import state_dict_from_jax
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import eval_step, infer_step, pair_loss, train_step

BUDGETS = dict(points=(256, 192, 192, 96), neighbors=(16, 16, 16, 16), corr_k=8,
               query_chunk=64, search_tile=32, search_m_tiles=4)
HEADS = dict(node_overlap=True, quaternion=True)
# cloud_bin_21 -> cloud_bin_34 under the 3DLoMatch ground truth.
_ROT, _TRANS = demo_pair_gt_pose()
ROT, TRANS = _ROT.astype(np.float32), _TRANS.astype(np.float32)

def overlap_crop(n_src=256, n_tgt=240, at=0.5):
    """The n nearest points of each cloud around one point of their overlap
    (the overlapping source point at quantile ``at`` of their order)."""
    from scipy.spatial import cKDTree

    src, tgt = demo_cloud_pair()
    dist, _ = cKDTree(tgt).query(src @ ROT.T + TRANS)
    overlap = np.flatnonzero(dist < 0.0375)
    center = src[overlap[int(len(overlap) * at)]]

    def near(p, c, n):
        return p[np.argsort(((p - c) ** 2).sum(1), kind="stable")[:n]]

    return dict(src_pcd=near(src, center, n_src),
                tgt_pcd=near(tgt, center @ ROT.T + TRANS, n_tgt), rot=ROT, trans=TRANS)


def jax_setup(at=0.5, **cfg_overrides):
    """JAX config, batch (``overlap_crop(at=at)``), pyramid + overflow,
    model and variables (numpy)."""
    jc = jcfg.tiny_test_config(budgets=jcfg.Budgets(**BUDGETS), **{**HEADS, **cfg_overrides})
    batch = j_make_pair_batch([overlap_crop(at=at)], jc.budgets.points[0])
    pyr, overflow = jax.jit(lambda p, m: j_build_pyramid_cfg(jc, p, m, with_overflow=True))(
        batch.points[0], batch.masks[0])
    model = JKPFCNN(jc)
    variables = jax.jit(model.init)(jax.random.key(3), pyr, batch.features[0])
    return jc, batch, (pyr, overflow), model, jax.tree_util.tree_map(np.asarray, variables)


def jax_value_and_grad(jc, batch, pyramid, model, variables, with_outputs=False):
    """jit(value_and_grad) of the JAX ``pair_loss`` on a given pyramid (one
    pair; its key is the first of ``split(key, 1)``, as the JAX step draws).
    ``with_outputs``: the aux is (stats, the model's outputs)."""
    pyr, overflow = pyramid
    points, masks = batch.points[0], batch.masks[0]

    def loss_fn(params, key):
        out = model.apply(dict(variables, params=params), pyr, batch.features[0])
        inputs = JLossInputs(
            src_pcd=points[0], tgt_pcd=points[1], src_mask=masks[0], tgt_mask=masks[1],
            rot=batch.rot[0], trans=batch.trans[0], src_feats=out["feats_f"][0],
            tgt_feats=out["feats_f"][1],
            scores_overlap=jnp.concatenate([out["scores_overlap"][0], out["scores_overlap"][1]]),
            scores_saliency=jnp.concatenate([out["scores_saliency"][0],
                                             out["scores_saliency"][1]]),
        )
        extras = {}
        if jc.node_overlap:
            extras.update(node_overlap_score_pred=out["node_overlap_score_pred"],
                          nodes=pyr.points[-1], node_masks=pyr.masks[-1])
        if jc.quaternion:
            extras.update(quaternion_pred=out["quaternion_pred"], trans_pred=out["trans_pred"],
                          quaternion_gt=j_so3.quaternion_from_matrix(batch.rot[0]))
        stats = j_metric_loss(inputs, jc, jax.random.split(key, 1)[0], extras)
        stats["max_overflow"] = jnp.maximum(jnp.max(overflow), 0).astype(jnp.float32)
        return stats["total"], ((stats, out) if with_outputs else stats)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def port_setup(variables, steps_per_epoch=1, at=0.5, **cfg_overrides):
    tc = tcfg.tiny_test_config(budgets=tcfg.Budgets(**BUDGETS), **{**HEADS, **cfg_overrides})
    model = KPFCNN(tc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    batch = make_pair_batch([overlap_crop(at=at)], tc.budgets.points[0])
    return tc, TrainState(tc, model, steps_per_epoch), batch


def pair_uniforms(key, batch_size, n, k):
    """The draws the JAX step makes: one key per pair, n·k uniforms each."""
    keys = jax.random.split(key, batch_size)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(kk, (n * k,)))
                                      for kk in keys]))


@pytest.fixture(scope="module")
def reference():
    jc, batch, pyramid, model, variables = jax_setup()
    vg = jax_value_and_grad(jc, batch, pyramid, model, variables)
    key = jax.random.key(11)
    (_, stats), grads = vg(variables["params"], key)
    uniforms = pair_uniforms(key, 1, jc.budgets.points[0], jc.budgets.corr_k)
    return (variables, uniforms, {k: float(v) for k, v in stats.items()},
            state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)}))


def test_crop_overlaps():
    s = overlap_crop()
    warped = s["src_pcd"] @ ROT.T + TRANS
    d2 = ((warped[:, None, :] - s["tgt_pcd"][None]) ** 2).sum(-1).min(1)
    assert (d2 < 0.0375**2).mean() > 0.3


@pytest.mark.parametrize("route", [{}, dict(kpconv_tiled=False)], ids=["tiled", "untiled"])
def test_pair_loss_and_gradients_match_jax(reference, route):
    """On the tiled route (K2 forward, K3 / K4 / K5 backward) and the
    untiled one (K6 / K7 forward, K3's gathered entry backward)."""
    variables, uniforms, want, want_grads = reference
    tc, state, batch = port_setup(variables, **route)
    stats = pair_loss(state.model, tc, batch.points[0], batch.masks[0], batch.features[0],
                      batch.rot[0], batch.trans[0], uniforms=uniforms[0])
    stats["total"].backward()
    assert set(stats) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(stats[k].detach()), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert want["circle_loss"] > 0 and want["recall"] > 0  # the crop has positives
    floor = 1e-6 * max(float(g.norm()) for g in want_grads.values())
    for name, p in state.model.named_parameters():
        g, w = p.grad.double(), want_grads[name].double()
        assert float((g - w).norm()) <= 1e-3 * float(w.norm()) + floor, name
    n_kpconv = sum(1 for n, _ in state.model.named_parameters() if n.endswith("KPConv.weights"))
    assert n_kpconv == 11


def test_eval_and_infer_steps(reference):
    variables, uniforms, want, _ = reference
    tc, state, batch = port_setup(variables)
    stats = eval_step(state, tc, batch, uniforms=uniforms)
    for k, v in want.items():
        np.testing.assert_allclose(float(stats[k]), v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert all(p.grad is None for p in state.model.parameters())
    out = infer_step(state, tc, batch)
    assert out["feats_f"].shape == (1, 2, tc.budgets.points[0], tc.final_feats_dim)
    assert out["quaternion_pred"].shape == (1, 4)
    assert torch.isfinite(out["feats_f"]).all()


def test_nan_gate_skips_the_update(reference):
    """A poisoned GT rotation makes the pose loss NaN: the update is
    skipped — parameters and momentum unchanged — and the step advances."""
    variables, uniforms, _, _ = reference
    tc, state, batch = port_setup(variables)
    train_step(state, tc, batch, uniforms=uniforms)
    before = [p.detach().clone() for p in state.params]
    momentum = [state.optimizer.state[p]["momentum_buffer"].clone() for p in state.params]
    bad = dataclasses.replace(batch, rot=batch.rot * torch.nan)
    stats = train_step(state, tc, bad, uniforms=uniforms)
    assert not np.isfinite(float(stats["total"]))
    assert (state.step, state.count) == (2, 1)
    for p, b, m in zip(state.params, before, momentum):
        assert torch.equal(p.detach(), b)
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"], m)


def test_max_overflow_surfaces_a_budget_drop(reference):
    variables, uniforms, want, _ = reference
    assert want["max_overflow"] == 0.0
    tc, state, batch = port_setup(variables)
    tight = tc.replace(budgets=dataclasses.replace(tc.budgets, points=(256, 32, 32, 32)))
    stats = eval_step(state, tight, batch, uniforms=uniforms)
    assert float(stats["max_overflow"]) > 0.0
    assert np.isfinite(float(stats["total"]))


def test_reduce_route_serves_only(reference):
    """``kpconv_impl: reduce`` (K8) has no backward — the JAX package
    defines no VJP for it — so ``train_step`` refuses it, while
    ``eval_step`` serves on it."""
    variables, uniforms, want, _ = reference
    tc, state, batch = port_setup(variables, kpconv_impl="reduce")
    with pytest.raises(NotImplementedError, match="reduce"):
        train_step(state, tc, batch, uniforms=uniforms)
    stats = eval_step(state, tc, batch, uniforms=uniforms)
    np.testing.assert_allclose(float(stats["total"]), want["total"], rtol=1e-4, atol=1e-6)
