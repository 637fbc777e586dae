"""Two training steps of the port against two of the JAX package, on the
CPU: the slice of ``tests/test_torch_train.py`` (tiny config, overlapping
assets crop, both heads, JAX weights), SGD with ``steps_per_epoch=1`` so
that the staircase decay fires on the second step.

Reference: the JAX step — ``jax.value_and_grad`` of ``pair_loss`` and
``TrainState.apply_gradients`` (optax), both compiled — with the same
per-step keys; the port gets those keys' draws.  Tolerance on each
parameter's total update Δp = p₂ − p₀: ‖Δp_port − Δp_JAX‖ ≤
1e-3·‖Δp_JAX‖ + 1e-6·max ‖Δp_JAX‖ (the gradient tolerance of
``test_torch_train.py``, carried through two linear momentum updates).
Worst measured: 1.4e-3 relative on the attention projections of GCN layer
1, whose updates (norm 2.3e-5) are 2.4e-6 of the largest (9.4, the pose
head's); in absolute terms 3.4e-9 of the largest update.
"""
import jax
import numpy as np
import pytest

from pcrcg_tpu.train.state import create_train_state as j_create_train_state
from pcrcg_tpu_torch.models.weights import state_dict_from_jax
from pcrcg_tpu_torch.train.step import train_step
from test_torch_train import jax_setup, jax_value_and_grad, pair_uniforms, port_setup


@pytest.fixture(scope="module")
def two_steps():
    jc, batch, pyramid, model, variables = jax_setup()
    vg = jax_value_and_grad(jc, batch, pyramid, model, variables)
    state = j_create_train_state(jc, variables, steps_per_epoch=1)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    keys = [jax.random.key(21), jax.random.key(22)]
    stats = []
    for key in keys:
        (_, st), grads = vg(state.params, key)
        state = apply(state, grads)
        stats.append({k: float(v) for k, v in st.items()})
    final = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, state.params)})
    uniforms = [pair_uniforms(k, 1, jc.budgets.points[0], jc.budgets.corr_k) for k in keys]
    return variables, uniforms, stats, final, int(state.step)


def test_two_sgd_steps_match_jax(two_steps):
    variables, uniforms, want_stats, want_params, want_step = two_steps
    tc, state, batch = port_setup(variables, steps_per_epoch=1)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    lrs = []
    for u, want in zip(uniforms, want_stats):
        lrs.append(state.learning_rate())
        stats = train_step(state, tc, batch, uniforms=u)
        np.testing.assert_allclose(float(stats["total"]), want["total"], rtol=1e-4)
    assert lrs == [tc.lr, tc.lr * tc.scheduler_gamma]  # the decay fired
    assert state.step == want_step == 2
    deltas = {n: (p.detach() - start[n]).double() for n, p in state.model.named_parameters()}
    want = {n: (want_params[n] - start[n]).double() for n in deltas}
    floor = 1e-6 * max(float(d.norm()) for d in want.values())
    for n, d in deltas.items():
        assert float((d - want[n]).norm()) <= 1e-3 * float(want[n].norm()) + floor, n
    assert all(float(d.norm()) > 0 for n, d in deltas.items() if n.endswith("KPConv.weights"))
