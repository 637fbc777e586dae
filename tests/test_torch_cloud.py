"""The port's cloud ('model') mesh axis: each cloud of a pair on its own
rank (gloo, CPU ranks spawned by ``parallel/launch.py::dp_steps`` with a
``file://`` rendezvous under ``tmp_path``), at the tiny config with the
node-overlap and pose heads on (the model of ``tests/test_torch_train.py``)
on the two pairs of ``tests/test_torch_parallel.py::_samples`` (the
training crop, and a subsample of the assets pair whose source cloud
overflows its coarse budgets by more than its target).

* ``train_step`` on the ``(1, 2)`` and ``(2, 2)`` meshes equals the
  port's single-process ``train_step`` on the same weights and draws:
  loss terms rtol 1e-4, every parameter after the step rtol 5e-4 /
  atol 5e-5, checked group by group (encoder, GCN, decoder, heads) so
  that a gradient counted twice shows; every rank's parameters and stats
  are bit-identical.
* ``eval_step`` on both meshes equals the JAX package's ``eval_step``
  over a cloud-sharded batch on ``make_mesh(1, n_model=2)`` of its
  8-device virtual CPU mesh, with the JAX weights carried across and the
  JAX draws: every stat rtol 1e-4.
* The cross-rank ``NormBlock`` equals the joint single-process norm to
  1e-6, output and input gradient; a per-cloud norm does not.
* ``max_overflow`` is the maximum over both clouds, and a NaN gradient of
  a parameter that both ranks compute (the GCN's), made on one model rank
  only, skips the update on both.
* The color model (a depth-18 backbone, 64×80 renders) on the ``(1, 2)``
  mesh equals its single-process step.
* In one process: one cloud's pyramid is the pair's pyramid's half, index
  for index, and the mesh keeps a rank's rows and cloud.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from pcrcg_tpu import config as jcfg
from pcrcg_tpu.data.pair import make_pair_batch as j_make_pair_batch
from pcrcg_tpu.models.kpfcnn import KPFCNN as JKPFCNN
from pcrcg_tpu.ops.pyramid import build_pyramid_cfg as j_build_pyramid_cfg
from pcrcg_tpu.parallel.mesh import make_mesh as j_make_mesh
from pcrcg_tpu.parallel.mesh import replicate as j_replicate
from pcrcg_tpu.parallel.mesh import shard_pair_batch as j_shard_pair_batch
from pcrcg_tpu.train.state import create_train_state as j_create_train_state
from pcrcg_tpu.train.step import eval_step as j_eval_step
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch.assets import render_pair_images
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.models.blocks import NormBlock
from pcrcg_tpu_torch.models.kpfcnn import KPFCNN
from pcrcg_tpu_torch.models.pcrcg import init_pcrcg
from pcrcg_tpu_torch.models.weights import state_dict_from_jax
from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
from pcrcg_tpu_torch.parallel import launch, multihost
from pcrcg_tpu_torch.parallel.cloud import CloudAxis
from pcrcg_tpu_torch.parallel.mesh import shard_images, shard_pair_batch
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import train_step

from test_torch_parallel import _samples
from test_torch_train import BUDGETS, HEADS, overlap_crop, pair_uniforms

MESHES = {"1x2": 2, "2x2": 4}  # (n_data x n_model): the world size
GROUPS = ("encoder_blocks.", "gnn.", "decoder_blocks.")  # the rest: the heads


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spawn(tmp, name, payload, world):
    torch.save(payload, tmp / f"{name}.pt")
    launch.spawn(launch.dp_steps, world, args=(str(tmp / f"{name}.pt"), str(tmp / name)),
                 init_method=f"file://{tmp / (name + '.rendezvous')}", device="cpu",
                 timeout=600)
    return [torch.load(tmp / f"{name}.rank{r}", weights_only=False) for r in range(world)]


def _probe():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 40, 6)).astype(np.float32)) * 3.0 + 1.0
    mask = torch.arange(40)[None] < torch.tensor([[31], [22]])
    w = torch.from_numpy(rng.normal(size=(2, 40, 6)).astype(np.float32))
    return dict(x=x, mask=mask, w=w)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cloud")
    jc = jcfg.tiny_test_config(budgets=jcfg.Budgets(**BUDGETS), **HEADS)
    tc = tcfg.tiny_test_config(budgets=tcfg.Budgets(**BUDGETS), **HEADS)
    jbatch = j_make_pair_batch(_samples(), jc.budgets.points[0])
    pyr = jax.jit(lambda p, m: j_build_pyramid_cfg(jc, p, m))(jbatch.points[0], jbatch.masks[0])
    model = JKPFCNN(jc)
    variables = jax.jit(model.init)(jax.random.key(3), pyr, jbatch.features[0])
    mesh = j_make_mesh(1, n_model=2, devices=jax.devices()[:2])
    key = jax.random.key(2)
    jev = j_eval_step(model, jc, j_replicate(j_create_train_state(jc, variables), mesh),
                      j_shard_pair_batch(jbatch, mesh), key)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    n_draws = (2, tc.budgets.points[0] * tc.budgets.corr_k)
    payload = dict(cfg=tc, state_dict=state_dict_from_jax(variables),
                   batch=make_pair_batch(_samples(), tc.budgets.points[0]),
                   uniforms=[torch.rand(n_draws, generator=torch.Generator().manual_seed(0))],
                   eval_uniforms=pair_uniforms(key, 2, tc.budgets.points[0], tc.budgets.corr_k),
                   n_model=2)
    outs = {name: _spawn(tmp, name, dict(payload, norm_probe=_probe() if name == "1x2" else None),
                         world)
            for name, world in MESHES.items()}
    return dict(tc=tc, payload=payload, outs=outs, tmp=tmp,
                jax_eval={k: float(v) for k, v in jev.items()})


@pytest.fixture(scope="module")
def single(run):
    """The port's single-process ``train_step`` on the same batch, weights
    and draws: its stats and its parameters after the step."""
    model = KPFCNN(run["tc"])
    model.load_state_dict(run["payload"]["state_dict"])
    stats = train_step(TrainState(run["tc"], model), run["tc"], run["payload"]["batch"],
                       uniforms=run["payload"]["uniforms"][0])
    return {k: float(v) for k, v in stats.items()}, model.state_dict()


def _group(name):
    name = name.removeprefix("kpfcnn.")
    return next((g for g in GROUPS if name.startswith(g)), "heads")


def _assert_step_matches(outs, want_stats, want_params, before):
    """Every rank's stats and parameters bit-identical; rank 0's equal to
    the single-process step's; each parameter group moved."""
    assert all(o["n_model"] == 2 and o["backend"] == "gloo" for o in outs)
    assert min(outs[0]["exchanges"].values()) > 0
    for o in outs[1:]:
        assert o["exchanges"] == outs[0]["exchanges"]
        assert o["stats"] == outs[0]["stats"]
        for name, p in outs[0]["params"].items():
            assert torch.equal(o["params"][name], p), name
    got = outs[0]["stats"][0]
    assert set(got) == set(want_stats)
    for k, v in want_stats.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    moved = {}
    for name, p in want_params.items():
        np.testing.assert_allclose(outs[0]["params"][name].numpy(), p.numpy(), rtol=5e-4,
                                   atol=5e-5, err_msg=name)
        if name in before and not torch.equal(p, before[name].reshape(p.shape)):
            moved[_group(name)] = moved.get(_group(name), 0) + 1
    assert set(moved) == set(GROUPS) | {"heads"}, moved


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cloud_train_step_matches_the_single_process_step(run, single, mesh):
    outs = run["outs"][mesh]
    assert [o["rank"] for o in outs] == list(range(MESHES[mesh]))
    _assert_step_matches(outs, *single, run["payload"]["state_dict"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cloud_eval_step_matches_jax(run, mesh):
    want = run["jax_eval"]
    for out in run["outs"][mesh]:
        got = out["eval"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_norm_block_across_ranks_matches_the_joint_norm(run):
    probe = _probe()
    x = probe["x"].clone().requires_grad_(True)
    joint = NormBlock()(x, probe["mask"])
    (joint * probe["w"]).sum().backward()
    got_y = torch.cat([o["norm_probe"][0] for o in run["outs"]["1x2"]])
    got_dx = torch.cat([o["norm_probe"][1] for o in run["outs"]["1x2"]])
    np.testing.assert_allclose(got_y.numpy(), joint.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_dx.numpy(), x.grad.numpy(), rtol=1e-6, atol=1e-6)
    # Each cloud normalized alone is a different function.
    alone = torch.cat([NormBlock()(probe["x"][c:c + 1], probe["mask"][c:c + 1])
                       for c in range(2)])
    assert float((alone - joint.detach()).abs().max()) > 1e-2


def test_max_overflow_is_the_maximum_over_both_clouds(run):
    """Pair 1's source cloud overflows more than its target: every rank,
    the target's included, reports the source's overflow."""
    tc, batch = run["tc"], run["payload"]["batch"]
    per_cloud = [float(build_pyramid_cfg(tc, batch.points[1][c:c + 1], batch.masks[1][c:c + 1],
                                         with_overflow=True)[1].max()) for c in range(2)]
    assert per_cloud[0] > per_cloud[1] > 0
    for outs in run["outs"].values():
        for o in outs:
            assert o["eval"]["max_overflow"] == per_cloud[0]
            assert o["stats"][0]["max_overflow"] == per_cloud[0]


def test_finite_gate_agrees_across_model_ranks(run):
    """Rank 1 alone makes the GCN's first weight's gradient NaN (a weight
    both ranks compute, whose gradient no rank could see as partial): the
    loss stays finite, and both ranks skip the update."""
    name = "gnn.layers.0.conv1.weight"
    payload = dict(run["payload"], nan_grad=(1, name))
    payload.pop("eval_uniforms")
    outs = _spawn(run["tmp"], "nan", payload, 2)
    for out in outs:
        assert np.isfinite(out["stats"][0]["total"])
        for k, p in out["params"].items():
            assert torch.equal(p, payload["state_dict"][k].reshape(p.shape)), k


def test_color_model_on_the_cloud_axis(tmp_path):
    """``PCRCG`` (depth-18 backbone, 64×80 renders of the training crop):
    each rank lifts its own cloud's images; the step equals the
    single-process step as above, and the frozen backbone stays as it
    was on every rank."""
    cfg = tcfg.tiny_test_config(budgets=tcfg.Budgets(**BUDGETS), **HEADS, image_feature=True,
                                in_feats_dim=129, backbone2d_depth=18)
    sample = overlap_crop()
    batch = make_pair_batch([sample], cfg.budgets.points[0], in_feats_dim=129)
    images = render_pair_images(sample["src_pcd"], sample["tgt_pcd"], cfg.img_num, height=64,
                                width=80, pose=(sample["rot"], sample["trans"]))
    images = {k: torch.as_tensor(v)[None] for k, v in images.items()}
    uniforms = torch.rand(1, cfg.budgets.points[0] * cfg.budgets.corr_k,
                          generator=torch.Generator().manual_seed(1))
    model = init_pcrcg(cfg, seed=2, device="cpu")
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    stats = train_step(TrainState(cfg, model), cfg, batch, uniforms=uniforms, images=images)
    outs = _spawn(tmp_path, "color", dict(cfg=cfg, state_dict=state_dict, batch=batch,
                                          uniforms=[uniforms], images=images, n_model=2), 2)
    params = model.state_dict()
    frozen = [k for k in params if k.startswith("lift.")]
    assert frozen and all(torch.equal(outs[0]["params"][k], state_dict[k]) for k in frozen)
    _assert_step_matches(outs, {k: float(v) for k, v in stats.items()},
                         {k: v for k, v in params.items() if k not in frozen}, state_dict)


def test_one_cloud_pyramid_is_half_the_pair_pyramid():
    """The pyramid of one cloud (B = 1: every tiled search, K1 on the card,
    over one cloud) equals the pair's pyramid's half, index for index, for
    both pairs (pair 1 drops voxels)."""
    tc = tcfg.tiny_test_config(budgets=tcfg.Budgets(**BUDGETS), **HEADS)
    batch = make_pair_batch(_samples(), tc.budgets.points[0])
    for i in range(2):
        pair, overflow = build_pyramid_cfg(tc, batch.points[i], batch.masks[i], with_overflow=True)
        for c in range(2):
            one, ov = build_pyramid_cfg(tc, batch.points[i][c:c + 1], batch.masks[i][c:c + 1],
                                        with_overflow=True)
            assert torch.equal(ov, overflow[:, c:c + 1])
            for field in dataclasses.fields(pair):
                for lvl, (a, b) in enumerate(zip(getattr(pair, field.name),
                                                 getattr(one, field.name))):
                    for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
                        assert torch.equal(x[c:c + 1], y), (field.name, lvl, c)


def test_cloud_mesh_shards_in_one_process():
    """Rank 3 of a 2 x 2 mesh: data row 1 (the second pair), cloud 1 of
    every leaf whose axis 1 is the pair's clouds; images keep their cloud,
    a shared intrinsics replicates."""
    mesh = multihost.DataMesh(4, 3, torch.device("cpu"), cloud=CloudAxis(1, 2, None))
    assert (mesh.n_model, mesh.n_data, mesh.data_rank) == (2, 2, 1)
    assert multihost.host_local_batch_slice(4, mesh) == slice(2, 4)
    with pytest.raises(ValueError):
        multihost.host_local_batch_slice(3, mesh)
    batch = make_pair_batch(_samples(), 256)
    shard = shard_pair_batch(batch, mesh)
    assert torch.equal(shard.points, batch.points[1:, 1:])
    assert torch.equal(shard.features, batch.features[1:, 1:])
    assert torch.equal(shard.rot, batch.rot[1:]) and torch.equal(shard.trans, batch.trans[1:])
    images = {"colors": torch.arange(2 * 2 * 3).reshape(2, 2, 3), "intrinsics": torch.eye(4)}
    sharded = shard_images(images, mesh, 2)
    assert torch.equal(sharded["colors"], images["colors"][1:, 1:])
    assert torch.equal(sharded["intrinsics"], torch.eye(4))
    assert multihost.global_pair_batch(shard, mesh, 2).points.shape[:2] == (1, 1)
