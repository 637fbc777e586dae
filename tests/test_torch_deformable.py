"""The port's deformable and modulated KPConv against the JAX package on the
CPU.

``kpconv_deformable`` against the JAX function on seeded random inputs,
every influence and aggregation, with and without modulations: outputs
within 1e-5 of the largest entry (one fp32 reduce over H in another order),
and the gradients of a seeded projection of the output with respect to the
features, the weights, the offsets and the modulations within 1e-4 of
their largest entry.

``KPFCNN`` with ``deformable=True`` (and ``modulated=True``) at the tiny
config on a crop of the in-repo assets pair (around the overlap point at
quantile ``CROP``), JAX weights carried across by
``state_dict_from_jax`` (``offset_conv`` and ``offset_bias`` included),
on the port's tiled route (deformable blocks off the candidate tiles, the
offset sub-convs on K6's plain version) and its untiled one: outputs within
1e-4 of the largest entry; and one pair's loss and gradients against the
JAX package's compiled value-and-grad (compiled once, at the tiny config),
at ``tests/test_torch_train.py``'s tolerances (stats rtol 1e-4; each
gradient ‖Δg‖ ≤ 1e-3·‖g‖ + 1e-6·max_p ‖g_p‖), the gradients from the port
in float32 and in float64 (see the test for the crop).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrcg_tpu import config as jcfg
from pcrcg_tpu.models.kpconv import kpconv_deformable as j_kpconv_deformable
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch.models.kpconv import kpconv_deformable
from pcrcg_tpu_torch.models.kpfcnn import KPFCNN, init_kpfcnn
from pcrcg_tpu_torch.models.weights import state_dict_from_jax
from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
from pcrcg_tpu_torch.train.step import loss_from_outputs, pair_loss

from test_torch_train import jax_setup, jax_value_and_grad, pair_uniforms, port_setup

DEFORM = dict(deformable=True, modulated=True)
# A crop whose gradients are well conditioned (see
# test_pair_loss_and_gradients_match_jax).
CROP = 0.6


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _conv_inputs(seed, nq=40, ns=48, h=12, c=6, d=5, k=15, extent=0.06):
    rng = np.random.default_rng(seed)
    s_pts = rng.uniform(0, 0.2, (ns, 3)).astype(np.float32)
    q_pts = s_pts[:nq] + rng.normal(0, 0.005, (nq, 3)).astype(np.float32)
    inds = rng.integers(0, ns + 1, (nq, h))  # ns: a shadow neighbor
    inds[:, 0] = np.arange(nq)
    x = rng.normal(size=(ns, c)).astype(np.float32)
    x[rng.uniform(size=ns) < 0.2] = 0.0  # rows whose feature sum is not positive
    kp = (rng.normal(0, 0.5, (k, 3)) * extent).astype(np.float32)
    kp[0] = 0.0
    w = rng.normal(0, 0.3, (k, c, d)).astype(np.float32)
    offsets = rng.normal(0, 0.5 * extent, (nq, k, 3)).astype(np.float32)
    mods = rng.uniform(0, 2, (nq, k)).astype(np.float32)
    proj = rng.normal(size=(nq, d)).astype(np.float32)
    return q_pts, s_pts, inds, x, kp, w, extent, offsets, mods, proj


@pytest.mark.parametrize("modulated", [False, True], ids=["plain", "modulated"])
@pytest.mark.parametrize("aggregation", ["sum", "closest"])
@pytest.mark.parametrize("influence", ["linear", "gaussian", "constant"])
def test_kpconv_deformable_matches_jax(influence, aggregation, modulated):
    q, s, inds, x, kp, w, extent, off, mods, proj = _conv_inputs(7)
    args = (x, w, off, mods) if modulated else (x, w, off)

    def j_fn(x_, w_, off_, mods_=None):
        out = j_kpconv_deformable(q, s, jnp.asarray(inds, jnp.int32), x_, kp, w_, extent,
                                  off_, mods_, influence, aggregation)
        return out, jnp.sum(out * proj)

    want = j_fn(*args)[0]
    j_grads = jax.grad(lambda *a: j_fn(*a)[1], argnums=tuple(range(len(args))))(*args)
    t = [torch.tensor(a, requires_grad=True) for a in args]
    got = kpconv_deformable(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(inds),
                            t[0], torch.from_numpy(kp), t[1], extent, t[2],
                            t[3] if modulated else None, influence, aggregation)
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    (got * torch.from_numpy(proj)).sum().backward()
    for name, g, jg in zip(("x", "weights", "offsets", "modulations"), t, j_grads):
        jg = np.asarray(jg)
        # Constant influence: the offsets reach the output only through the
        # (not differentiable) in-range mask, so they get no gradient.
        got_g = np.zeros_like(jg) if g.grad is None else g.grad.numpy()
        np.testing.assert_allclose(got_g, jg, rtol=0,
                                   atol=1e-4 * max(np.abs(jg).max(), 1e-12), err_msg=name)


def test_pruned_neighbors_leave_the_count():
    """A neighbor beyond KP_extent of every deformed kernel point neither
    contributes nor counts (the reference re-pads it as a shadow)."""
    q = torch.zeros(1, 3)
    s = torch.tensor([[0.01, 0, 0], [1.0, 0, 0]])
    kp = torch.zeros(1, 3)
    w = torch.ones(1, 1, 1)
    x = torch.ones(2, 1)
    out = kpconv_deformable(q, s, torch.tensor([[0, 1]]), x, kp, w, 0.05,
                            torch.zeros(1, 1, 3))
    torch.testing.assert_close(out, torch.tensor([[0.8]]))  # (1 - 0.01/0.05) / 1 neighbor


def test_offset_conv_layout():
    """The offset sub-conv: its own disposition (seed + 7919), width 3K or
    4K, zero bias, under the reference's names."""
    model = init_kpfcnn(tcfg.tiny_test_config(**DEFORM), seed=0, device="cpu")
    conv = model.encoder_blocks[1].KPConv
    assert conv.deformable and conv.modulated
    assert tuple(conv.offset_conv.weights.shape) == (15, 8, 60)
    assert not torch.equal(conv.offset_conv.kernel_points, conv.kernel_points)
    assert torch.equal(conv.offset_bias, torch.zeros(60))
    names = set(model.state_dict())
    assert {"encoder_blocks.1.KPConv.offset_conv.weights",
            "encoder_blocks.1.KPConv.offset_conv.kernel_points",
            "encoder_blocks.1.KPConv.offset_bias"} <= names
    assert not model.encoder_blocks[0].KPConv.deformable  # the simple block stays rigid
    plain = init_kpfcnn(tcfg.tiny_test_config(deformable=True), seed=0, device="cpu")
    assert tuple(plain.encoder_blocks[1].KPConv.offset_conv.weights.shape) == (15, 8, 45)


@pytest.fixture(scope="module")
def reference():
    """The JAX deformable, modulated model on the training crop: its
    forward outputs, and the loss and gradients of one pair (one compile
    of each)."""
    jc, batch, pyramid, model, variables = jax_setup(at=CROP, **DEFORM)
    vg = jax_value_and_grad(jc, batch, pyramid, model, variables, with_outputs=True)
    key = jax.random.key(11)
    (_, (stats, out)), grads = vg(variables["params"], key)
    uniforms = pair_uniforms(key, 1, jc.budgets.points[0], jc.budgets.corr_k)
    return (variables, uniforms, {k: np.asarray(v) for k, v in out.items()},
            {k: float(v) for k, v in stats.items()},
            state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)}))


def test_deformable_config_widens_the_searches():
    conv, pool = tcfg.tiny_test_config(**DEFORM).deform_level_flags()
    assert any(conv) and any(pool)
    assert (conv, pool) == jcfg.tiny_test_config(**DEFORM).deform_level_flags()


@pytest.mark.parametrize("route", [{}, dict(kpconv_tiled=False)], ids=["tiled", "untiled"])
def test_kpfcnn_forward_matches_jax(reference, route):
    variables, _, want, _, _ = reference
    tc, state, batch = port_setup(variables, at=CROP, **DEFORM, **route)
    with torch.no_grad():
        pyr = build_pyramid_cfg(tc, batch.points[0], batch.masks[0])
        got = state.model(pyr, batch.features[0])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-4 * np.abs(v).max(),
                                   err_msg=k)


def _port_pair_loss(variables, uniforms, dtype, **route):
    """The port's loss stats of the crop with its model in ``dtype`` (the
    pyramid is built in fp32, as always), after backward."""
    tc, state, batch = port_setup(variables, at=CROP, **DEFORM, **route)
    model = state.model.to(dtype)
    pyr = build_pyramid_cfg(tc, batch.points[0], batch.masks[0])
    pyr = dataclasses.replace(pyr, points=tuple(p.to(dtype) for p in pyr.points))
    out = model(pyr, batch.features[0].to(dtype))
    stats = loss_from_outputs(tc, out, pyr, batch.points[0].to(dtype), batch.masks[0],
                              batch.rot[0].to(dtype), batch.trans[0].to(dtype),
                              uniforms=uniforms[0].to(dtype))
    stats["total"].backward()
    return model, stats


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("route", [{}, dict(kpconv_tiled=False)], ids=["tiled", "untiled"])
def test_pair_loss_and_gradients_match_jax(reference, route, dtype):
    """Loss stats in fp32; the gradients with the port's model in ``dtype``.
    The crop is one whose gradients are well conditioned: on the training
    crop of ``tests/test_torch_train.py`` (quantile 0.5) a relative change
    of 1e-6 in block 0's output flips a discrete choice downstream and
    moves every gradient upstream of the GCN's cross layer by 0.4-0.7 %
    with the heads on, by 4 % with them off (the rigid model as much as the
    deformable one), and the port's fp32 rounding crosses it where the JAX
    package's does not, while the port in float64 lies within 3e-5 of the
    JAX package there.  At quantile ``CROP`` the port's fp32 gradients lie
    within 0.04 of the rule's bound of its float64 ones, which the test
    checks first."""
    variables, uniforms, _, want, want_grads = reference
    tc, state, batch = port_setup(variables, at=CROP, **DEFORM, **route)
    assert isinstance(state.model, KPFCNN)
    with torch.no_grad():
        stats = pair_loss(state.model, tc, batch.points[0], batch.masks[0], batch.features[0],
                          batch.rot[0], batch.trans[0], uniforms=uniforms[0])
    assert set(stats) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(stats[k]), v, rtol=1e-4, atol=1e-6, err_msg=k)
    model, _ = _port_pair_loss(variables, uniforms, dtype, **route)
    params = dict(model.named_parameters())
    assert set(want_grads) == set(params)

    def within(grads, ref, share):
        floor = 1e-6 * max(float(g.norm()) for g in ref.values())
        for name, p in params.items():
            g, w = grads[name].double(), ref[name].double().reshape(p.shape)
            assert float((g - w).norm()) <= share * (1e-3 * float(w.norm()) + floor), name

    if dtype == torch.float32:  # the crop is well conditioned
        wide, _ = _port_pair_loss(variables, uniforms, torch.float64, **route)
        within({n: p.grad for n, p in params.items()},
               {n: p.grad for n, p in wide.named_parameters()}, 0.1)
    within({n: p.grad for n, p in params.items()}, want_grads, 1.0)
    offsets = [n for n in params if n.endswith("offset_conv.weights")]
    assert len(offsets) == 10  # every resnetb block is deformable
    assert all(float(params[n].grad.abs().max()) > 0 for n in offsets)
