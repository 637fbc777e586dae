"""The KPConv training backward of the port against the JAX package, on the
CPU: the plain versions of K3 (``kpconv_bwd_plain``), K4
(``scatter_ds_feats_plain``) and K5 (``maxpool_bwd_plain``), the CPU
branch of ``kpconv_tiled_bwd`` (on the card one launch, K3 with K4's
scatter folded in), and the autograd of ``kpconv_tiled_ad`` /
``max_pool_tiled`` that runs them.

References: the Pallas kernels in interpret mode (``kpconv_fused_bwd``,
``_scatter_ds_feats``, ``max_pool_tiled``'s VJP, ``jax.grad`` of
``kpconv_tiled_ad``), held at rtol 2e-4 / atol 2e-4·scale, the tolerance of
the K2 test (the TPU kernels carry features as bf16 hi/lo limbs, exact to
~2⁻¹⁶ relative); and float64 torch autograd of ``kpconv_tiled_plain``,
held at rtol 1e-5 / atol 1e-5·scale (fp32 sums over H ≤ 9 neighbors and
K·C ≤ 3000 products).  Worst differences measured on these inputs, as
max |Δ| / max(max |reference|, 1): K3 7.6e-7 and K4 1.2e-5 against
Pallas, the autograd 1.4e-5 against JAX and 5.8e-7 against float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrcg_tpu.ops.kpconv_fused import kpconv_fused_bwd as j_kpconv_fused_bwd
from pcrcg_tpu.ops.kpconv_tiled import _scatter_ds_feats as j_scatter_ds_feats
from pcrcg_tpu.ops.kpconv_tiled import kpconv_tiled_ad as j_kpconv_tiled_ad
from pcrcg_tpu.ops.kpconv_tiled import max_pool_tiled as j_max_pool_tiled
from pcrcg_tpu.ops.subsample import morton_sort
from pcrcg_tpu.ops.tiled_search import radius_search_tiled
from pcrcg_tpu_torch.ops.kpconv_common import neighbor_rel
from pcrcg_tpu_torch.ops.kpconv_fused import kpconv_bwd_plain
from pcrcg_tpu_torch.ops.kpconv_tiled import (
    kpconv_tiled_ad,
    kpconv_tiled_bwd,
    kpconv_tiled_plain,
    max_pool_tiled,
    scatter_ds_feats_plain,
)

T = torch.from_numpy
J = jnp.asarray
TILE = 32
EXTENT = 0.24
CASES = [  # the cases of tests/test_torch_kpconv.py
    ("linear", "sum", 12, 16),
    ("gaussian", "sum", 12, 16),
    ("constant", "sum", 12, 16),
    ("linear", "closest", 12, 16),
    ("linear", "sum", 1, 32),
    ("linear", "sum", 200, 40),
]


def _setup(seed, nq=200, ns=600, c=12, d=16, k=15, h=9, radius=0.33, m_tiles=6, scale=3.0):
    """A 3 m-scale Z-ordered cloud, queries drawn from it, the JAX tiled
    search's global and tile-local neighbors, and a cotangent g [Nq, D]."""
    rng = np.random.default_rng(seed)
    sup = rng.uniform(0, scale, size=(ns, 3)).astype(np.float32)
    sup_j, mask_j, _ = morton_sort(J(sup), jnp.ones(ns, bool))
    sup = np.asarray(sup_j)
    q = sup[rng.permutation(ns)[:nq]]
    gidx, lidx, tiles = radius_search_tiled(
        J(q), sup_j, mask_j, radius, h, tile=TILE, m_tiles=m_tiles, return_local=True,
    )
    feats = rng.normal(size=(ns, c)).astype(np.float32)
    feats[::4] = np.abs(feats[::4])
    return dict(
        q=q, sup=sup, feats=feats, gidx=np.asarray(gidx), lidx=np.asarray(lidx),
        tiles=np.asarray(tiles), kp=rng.normal(scale=0.12, size=(k, 3)).astype(np.float32),
        w=rng.normal(size=(k, c, d)).astype(np.float32),
        g=rng.normal(size=(nq, d)).astype(np.float32),
    )


def _close(got, want, rtol=2e-4, scale_rtol=2e-4, what=""):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale_rtol * scale, err_msg=what)


def _geom(s):
    return T(s["q"]), T(s["sup"]), T(s["lidx"]), T(s["tiles"]), T(s["kp"])


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
def test_k3_plain_matches_pallas(influence, aggregation, c, d):
    s = _setup(0, c=c, d=d)
    q, sup, lidx, tiles, kp = _geom(s)
    _, _, weighted = kpconv_tiled_plain(q, sup, T(s["feats"]), lidx, tiles, kp, T(s["w"]),
                                        EXTENT, influence, aggregation, TILE,
                                        keep_weighted=True)
    dw, dnx = kpconv_bwd_plain(q, sup, lidx, tiles, kp, T(s["w"]), T(s["g"]), weighted,
                               EXTENT, influence, aggregation, TILE)
    rel, row, vf = neighbor_rel(q, sup, lidx, tiles, TILE)
    nx_t = (T(s["feats"])[row] * vf).permute(1, 2, 0).numpy()  # [H, C, Nq]
    want_dnx_t, want_dw = j_kpconv_fused_bwd(
        J(rel.numpy()), J(nx_t), J(s["g"]), J(s["kp"]), J(s["w"]), EXTENT, influence,
        aggregation, interpret=True,
    )
    _close(dw.numpy(), np.asarray(want_dw), what="dW")
    _close(dnx.permute(1, 2, 0).numpy(), np.asarray(want_dnx_t), what="dnx")


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
def test_k4_plain_matches_pallas(influence, aggregation, c, d):
    s = _setup(1, c=c, d=d)
    nq, h = s["g"].shape[0], s["lidx"].shape[1]
    dnx = np.random.default_rng(2).normal(size=(nq, h, c)).astype(np.float32)
    got = scatter_ds_feats_plain(T(dnx), T(s["lidx"]), T(s["tiles"]), s["sup"].shape[0], TILE)
    c8 = max(8, -(-c // 8) * 8) if c <= 160 else -(-c // 128) * 128
    dnx_t = np.zeros((h, c8, s["lidx"].shape[0]), np.float32)
    dnx_t[:, :c, :nq] = dnx.transpose(1, 2, 0)
    want = j_scatter_ds_feats(J(dnx_t), J(s["lidx"]), J(s["tiles"]), s["sup"].shape[0], c,
                              TILE, interpret=True)
    _close(got.numpy(), np.asarray(want), what="ds_feats")


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
def test_k3_k4_wrapper_cpu_branch_matches_jax_vjp(influence, aggregation, c, d):
    """``kpconv_tiled_bwd`` on CPU tensors runs plain K3 then plain K4; its
    (dW, ds) equal the VJP of JAX's ``kpconv_tiled_ad`` (Pallas in
    interpret mode) under the cotangent g, at the file's Pallas tolerance.
    Without ``need_ds`` it returns the same dW and no ds."""
    s = _setup(7, c=c, d=d)
    q, sup, lidx, tiles, kp = _geom(s)
    w = T(s["w"])
    _, _, weighted = kpconv_tiled_plain(q, sup, T(s["feats"]), lidx, tiles, kp, w, EXTENT,
                                        influence, aggregation, TILE, keep_weighted=True)
    args = (q, sup, lidx, tiles, kp, w, T(s["g"]), weighted, EXTENT, influence, aggregation,
            TILE)
    dw, ds = kpconv_tiled_bwd(*args)

    def conv(f_, w_):
        return j_kpconv_tiled_ad(
            J(s["q"]), J(s["sup"]), f_, J(s["lidx"]), J(s["tiles"]), J(s["gidx"]),
            J(s["kp"]), w_, EXTENT, influence, aggregation, interpret=True, tile=TILE,
            feat_limbs=2,
        )[0]

    _, vjp = jax.vjp(conv, J(s["feats"]), J(s["w"]))
    want_ds, want_dw = vjp(J(s["g"]))
    _close(ds.numpy(), np.asarray(want_ds), what="ds_feats vs JAX VJP")
    _close(dw.numpy(), np.asarray(want_dw), what="dW vs JAX VJP")
    dw_only, no_ds = kpconv_tiled_bwd(*args, need_ds=False)
    assert no_ds is None and torch.equal(dw_only, dw)


def _port_grads(s, influence, aggregation, dtype=torch.float32, plain=False):
    """d Σ(out·g)/d(feats, W) through the port's autograd (``plain``: torch
    autograd of the plain forward instead of the custom backward)."""
    q, sup, lidx, tiles, kp = (t.to(dtype) if t.is_floating_point() else t for t in _geom(s))
    feats = T(s["feats"]).to(dtype).requires_grad_(True)
    w = T(s["w"]).to(dtype).requires_grad_(True)
    fn = kpconv_tiled_plain if plain else kpconv_tiled_ad
    out, _ = fn(q, sup, feats, lidx, tiles, kp, w, EXTENT, influence, aggregation, tile=TILE)
    (out * T(s["g"]).to(dtype)).sum().backward()
    return feats.grad.double().numpy(), w.grad.double().numpy()


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
def test_kpconv_tiled_ad_grads_match_jax_and_float64(influence, aggregation, c, d):
    s = _setup(3, c=c, d=d)
    got_f, got_w = _port_grads(s, influence, aggregation)

    def loss(f_, w_):
        out, _ = j_kpconv_tiled_ad(
            J(s["q"]), J(s["sup"]), f_, J(s["lidx"]), J(s["tiles"]), J(s["gidx"]),
            J(s["kp"]), w_, EXTENT, influence, aggregation, interpret=True, tile=TILE,
            feat_limbs=2,
        )
        return jnp.sum(out * J(s["g"]))

    want_f, want_w = jax.grad(loss, argnums=(0, 1))(J(s["feats"]), J(s["w"]))
    _close(got_f, np.asarray(want_f), what="d feats vs JAX")
    _close(got_w, np.asarray(want_w), what="d W vs JAX")
    ref_f, ref_w = _port_grads(s, influence, aggregation, torch.float64, plain=True)
    _close(got_f, ref_f, rtol=1e-5, scale_rtol=1e-5, what="d feats vs float64")
    _close(got_w, ref_w, rtol=1e-5, scale_rtol=1e-5, what="d W vs float64")


def test_kpconv_tiled_ad_weights_only():
    """A conv whose input needs no gradient (block 0's ones column) gets dW
    alone, equal to the full backward's."""
    s = _setup(4, c=1, d=32)
    q, sup, lidx, tiles, kp = _geom(s)
    w = T(s["w"]).requires_grad_(True)
    out, _ = kpconv_tiled_ad(q, sup, torch.ones(sup.shape[0], 1), lidx, tiles, kp, w, EXTENT,
                             tile=TILE)
    (out * T(s["g"])).sum().backward()
    _, want_w = _port_grads(dict(s, feats=np.ones_like(s["feats"])), "linear", "sum")
    _close(w.grad.double().numpy(), want_w, rtol=1e-6, scale_rtol=1e-6)
    with torch.no_grad():
        out_ng, _ = kpconv_tiled_ad(q, sup, torch.ones(sup.shape[0], 1), lidx, tiles, kp, w,
                                    EXTENT, tile=TILE)
    assert out_ng.grad_fn is None
    np.testing.assert_array_equal(out_ng.numpy(), out.detach().numpy())


def test_k5_max_pool_first_maximum_matches_pallas():
    """max_pool_tiled forward and backward against the Pallas VJP, with a
    tie built on purpose: two neighbors of one query carry the same row, so
    only first-maximum routing (not an even split) matches."""
    s = _setup(5, c=24, d=8)
    gidx, ns = s["gidx"], s["sup"].shape[0]
    qi = int(np.argmax((gidx < ns).sum(1) >= 2))
    a, b = (int(r) for r in gidx[qi][:2])
    feats = s["feats"].copy()
    feats[a] = feats[b] = 10.0 + np.arange(feats.shape[1], dtype=np.float32)
    g = np.random.default_rng(6).normal(size=(gidx.shape[0], feats.shape[1])).astype(np.float32)

    x = T(feats).requires_grad_(True)
    out = max_pool_tiled(x, T(gidx).long())
    (out * T(g)).sum().backward()

    def loss(f_):
        return jnp.sum(j_max_pool_tiled(f_, J(gidx), J(s["lidx"]), J(s["tiles"]), tile=TILE,
                                        interpret=True) * J(g))

    want_out = j_max_pool_tiled(J(feats), J(gidx), J(s["lidx"]), J(s["tiles"]), tile=TILE,
                                interpret=True)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want_out))
    want = np.asarray(jax.grad(loss)(J(feats)))
    _close(x.grad.numpy(), want, what="max-pool gradient")
    # The tied row listed first takes the query's whole gradient.
    assert np.all(want[a] != 0.0)
    # An even split between tied maxima (torch amax's rule) disagrees.
    x2 = T(feats).requires_grad_(True)
    from pcrcg_tpu_torch.ops.masked import pad_gather

    (pad_gather(x2, T(gidx).long(), 0.0).amax(1) * T(g)).sum().backward()
    assert not np.allclose(x2.grad.numpy(), want, rtol=2e-4, atol=2e-4)
