"""The port's losses and optimizer against the JAX package, on the CPU.

* ``weighted_bce``, ``circle_loss_and_recall`` and ``metric_loss`` (node
  overlap and pose extras on) on random scores / descriptors and the
  overlapping crop of the assets pair under its ground-truth pose, the
  circle-loss draws taken from the JAX key (``jax.random.uniform(key,
  (n·k,))``).  Values and gradients (to the descriptors, the scores and the
  heads' predictions) against compiled JAX: rtol 1e-5 / atol 1e-6 for the
  values (the same fp32 formulas; logsumexp and means sum in another
  order), rtol 1e-4 / atol 1e-6·max|g| for the gradients (products of
  those sums).  Worst measured: values 1.5e-7 relative, gradients 3.8e-7
  of the largest entry.
* ``TrainState`` against the optax chain of ``pcrcg_tpu/train/state.py``
  (SGD with momentum and Adam, L2 decay, a staircase decay that fires
  twice, ``iter_size`` 1 and 2, a non-finite gradient on the third step)
  on random arrays: parameters after every step at rtol 1e-5 / atol
  2e-5·lr·(updates applied so far).  The same formulas in fp32, except
  that optax forms Adam's bias corrections 1 − βᵗ in fp32, where 0.999
  rounds to 0.99900001, and torch in float64: that moves each early Adam
  update (~lr per entry) by ~6e-6 of itself, and the differences add up
  over the updates.  Worst measured: 1.2e-6 absolute (Adam, after 6
  updates at lr ≤ 0.05).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pcrcg_tpu import config as jcfg
from pcrcg_tpu import losses as jl
from pcrcg_tpu.geom import so3 as j_so3
from pcrcg_tpu.train.state import create_train_state as j_create_train_state
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch import losses as tl
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.geom.so3 import quaternion_from_matrix
from pcrcg_tpu_torch.train.state import TrainState
from test_torch_train import BUDGETS, overlap_crop

T = torch.from_numpy
J = jnp.asarray
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)


def _grad_close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_bce_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    pred = rng.uniform(0.01, 0.99, n).astype(np.float32)
    pred[:5] = [0.0, 1.0, 0.0, 1.0, 0.5]  # clipped ends and the label threshold
    gt = (rng.uniform(size=n) < 0.3).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8

    p = T(pred).requires_grad_(True)
    got = tl.weighted_bce(p, T(gt), T(valid))
    got[0].backward()
    want = jax.jit(jl.weighted_bce)(J(pred), J(gt), J(valid))
    for g, w, name in zip(got, want, ("loss", "precision", "recall")):
        np.testing.assert_allclose(float(g.detach()), float(w), **VALUE_TOL, err_msg=name)
    want_grad = jax.grad(lambda x: jl.weighted_bce(x, J(gt), J(valid))[0])(J(pred))
    _grad_close(p.grad.numpy(), want_grad, "d loss / d prediction")


@pytest.mark.parametrize("seed", [0, 1])
def test_circle_loss_and_recall_matches_jax(seed):
    cfg_j, cfg_t = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    rng = np.random.default_rng(seed)
    p = 96
    coords = rng.uniform(0.0, 0.2, (p, p)).astype(np.float32)
    feats = rng.uniform(0.05, 1.9, (p, p)).astype(np.float32)
    pair_valid = rng.uniform(size=p) < 0.85

    f = T(feats).requires_grad_(True)
    circle, recall = tl.circle_loss_and_recall(T(coords), f, T(pair_valid), cfg_t)
    circle.backward()

    def fn(fd):
        return jl.circle_loss_and_recall(J(coords), fd, J(pair_valid), cfg_j)

    want_circle, want_recall = jax.jit(fn)(J(feats))
    assert float(want_circle) > 0.0
    np.testing.assert_allclose(float(circle.detach()), float(want_circle), **VALUE_TOL)
    np.testing.assert_allclose(float(recall), float(want_recall), **VALUE_TOL)
    _grad_close(f.grad.numpy(), jax.grad(lambda fd: fn(fd)[0])(J(feats)), "d circle / d feats")


def _loss_case(seed=0):
    """Padded crop of the assets pair under its GT pose, random unit
    descriptors, scores and head predictions, nodes with a ragged mask."""
    cfg = tcfg.tiny_test_config(budgets=tcfg.Budgets(**BUDGETS))
    batch = make_pair_batch([overlap_crop()], cfg.budgets.points[0])
    pts, msk = batch.points[0].numpy(), batch.masks[0].numpy()
    n = pts.shape[1]
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2, n, 8)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    nc = 24
    nodes = np.stack([pts[i][np.flatnonzero(msk[i])[::7][:nc]] for i in range(2)])
    node_masks = np.ones((2, nc), bool)
    node_masks[1, -3:] = False
    return dict(
        src_pcd=pts[0], tgt_pcd=pts[1], src_mask=msk[0], tgt_mask=msk[1],
        rot=batch.rot[0].numpy(), trans=batch.trans[0].numpy(),
        src_feats=feats[0], tgt_feats=feats[1],
        scores_overlap=rng.uniform(0.02, 0.98, 2 * n).astype(np.float32),
        scores_saliency=rng.uniform(0.02, 0.98, 2 * n).astype(np.float32),
        node_overlap_score_pred=rng.uniform(0.02, 0.98, (2, nc)).astype(np.float32),
        nodes=nodes, node_masks=node_masks,
        quaternion_pred=rng.normal(size=4).astype(np.float32),
        trans_pred=rng.normal(size=3).astype(np.float32),
    )


_INPUTS = ("src_pcd", "tgt_pcd", "src_mask", "tgt_mask", "rot", "trans", "src_feats",
           "tgt_feats", "scores_overlap", "scores_saliency")
_DIFF = ("src_feats", "tgt_feats", "scores_overlap", "scores_saliency",
         "node_overlap_score_pred", "quaternion_pred", "trans_pred")


def test_metric_loss_with_extras_matches_jax():
    case = _loss_case()
    cfg_t = tcfg.tiny_test_config(budgets=tcfg.Budgets(**BUDGETS))
    cfg_j = jcfg.tiny_test_config(budgets=jcfg.Budgets(**BUDGETS))
    n, k = case["src_pcd"].shape[0], cfg_t.budgets.corr_k
    key = jax.random.key(5)

    def j_loss(diff):
        arrays = {name: J(v) for name, v in case.items()}
        arrays.update(diff)
        inputs = jl.LossInputs(**{name: arrays[name] for name in _INPUTS})
        extras = {name: arrays[name] for name in ("node_overlap_score_pred", "nodes",
                                                   "node_masks", "quaternion_pred",
                                                   "trans_pred")}
        extras["quaternion_gt"] = j_so3.quaternion_from_matrix(arrays["rot"])
        stats = jl.metric_loss(inputs, cfg_j, key, extras)
        return stats["total"], stats

    diff_j = {name: J(case[name]) for name in _DIFF}
    (_, want), want_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(diff_j)

    t = {name: T(np.asarray(v)) for name, v in case.items()}
    for name in _DIFF:
        t[name].requires_grad_(True)
    extras = {name: t[name] for name in ("node_overlap_score_pred", "nodes", "node_masks",
                                         "quaternion_pred", "trans_pred")}
    extras["quaternion_gt"] = quaternion_from_matrix(t["rot"])
    uniforms = T(np.array(jax.random.uniform(key, (n * k,))))
    got = tl.metric_loss(tl.LossInputs(**{name: t[name] for name in _INPUTS}), cfg_t,
                         uniforms=uniforms, extras=extras)
    got["total"].backward()

    assert set(got) == set(want)
    assert float(want["circle_loss"]) > 0 and float(want["recall"]) > 0
    assert 0 < float(want["node_overlap_loss"])
    for name, w in want.items():
        np.testing.assert_allclose(float(got[name].detach()), float(w), **VALUE_TOL,
                                   err_msg=name)
    for name in _DIFF:
        _grad_close(t[name].grad.numpy(), want_grads[name], f"d total / d {name}")


class _Params(nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.p = nn.ParameterDict({k: nn.Parameter(T(v.copy())) for k, v in arrays.items()})


@pytest.mark.parametrize("optimizer,iter_size", [("SGD", 1), ("ADAM", 1), ("SGD", 2),
                                                 ("ADAM", 2)])
def test_train_state_matches_optax(optimizer, iter_size):
    """Seven steps; the third gradient holds a NaN.  steps_per_epoch 2 and
    γ 0.5: the learning rate halves after every second applied update."""
    over = dict(optimizer=optimizer, lr=0.05, weight_decay=1e-2, momentum=0.9,
                scheduler_gamma=0.5, iter_size=iter_size)
    rng = np.random.default_rng(7)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    j_state = j_create_train_state(jcfg.tiny_test_config(**over), {"params": params},
                                   steps_per_epoch=2)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    module = _Params(params)
    state = TrainState(tcfg.tiny_test_config(**over), module, steps_per_epoch=2)
    lrs = []
    for step in range(7):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        if step == 2:
            grads["b"][1] = np.nan
        before = [p.detach().clone() for p in state.params]
        opt_before = [{k: v.clone() for k, v in state.optimizer.state[p].items()}
                      for p in state.params]
        for name, p in module.p.items():
            p.grad = T(grads[name])
        lrs.append(state.learning_rate())
        applied = state.apply_gradients()
        j_state = apply(j_state, {k: J(v) for k, v in grads.items()})
        assert state.step == int(j_state.step) == step + 1
        for name, p in module.p.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_state.params[name]),
                                       rtol=1e-5, atol=2e-5 * over["lr"] * max(state.count, 1),
                                       err_msg=f"step {step} {name}")
        if step == 2:  # the NaN step: nothing moved, the step advanced
            assert not applied
            for p, b, o in zip(state.params, before, opt_before):
                assert torch.equal(p.detach(), b)
                st = state.optimizer.state[p]
                assert st.keys() == o.keys() and all(torch.equal(st[k], o[k]) for k in o)
    updates = 6 // iter_size  # finite steps, every iter_size-th one applies
    assert state.count == updates
    assert lrs[-1] == 0.05 * 0.5 ** ((updates - 1) // 2)  # the decay fired
