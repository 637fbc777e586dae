"""The port's data parallelism on ``torch.distributed`` (gloo, CPU ranks
spawned by ``parallel/launch.py``), at the tiny config with the
node-overlap and pose heads on (the model of ``tests/test_torch_train.py``)
on two pairs: the
training crop of ``tests/test_torch_train.py`` and a 256-point subsample of
the whole assets pair, whose coarse levels overflow their budgets (so the
batch's ``max_overflow`` is one pair's, not the mean).

* ``train_step_dp`` over 2 ranks, a pair each, equals the port's
  single-process ``train_step`` on the 2-pair batch with the same weights
  and draws: loss rtol 1e-4, parameters after the step rtol 5e-4 /
  atol 5e-5 (the tolerances of ``tests/test_parallel.py``); the ranks'
  stats and parameters are bit-identical to each other.
* ``eval_step_dp`` over the 2 ranks equals the JAX package's
  ``eval_step_dp`` on a 2-device slice of its 8-device virtual mesh, with
  the JAX weights carried across and the JAX draws: every stat rtol 1e-4.
* ``max_*`` stats take the maximum over the ranks; a non-finite gradient on
  one rank skips the update on both.
* ``make_mesh`` in one process refuses ``n_model=2`` (two ranks needed;
  the cloud axis itself: ``tests/test_torch_cloud.py``) and ``n_model=3``;
  ``main.py`` with ``data_parallel: 2``
  starts its two ranks, trains two steps of a fixture split, writes the
  checkpoints from rank 0 alone, and resumes from one; on the card it
  refuses more ranks than cards before starting any.
"""
import dataclasses
import os

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
from pcrcg_tpu.train.step import eval_step_dp as j_eval_step_dp
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch import main as tmain
from pcrcg_tpu_torch.assets import demo_cloud_pair, write_indoor_fixture
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.models.kpfcnn import KPFCNN
from pcrcg_tpu_torch.models.weights import state_dict_from_jax
from pcrcg_tpu_torch.parallel import launch, multihost
from pcrcg_tpu_torch.parallel.mesh import make_mesh, shard_images, shard_pair_batch
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import eval_step, train_step

from test_torch_train import BUDGETS, HEADS, ROT, TRANS, overlap_crop, pair_uniforms
from test_torch_trainer import WIDTHS
from test_torch_trainer import _write_yaml as _yaml


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _samples():
    src, tgt = demo_cloud_pair()
    rng = np.random.default_rng(5)
    wide = dict(src_pcd=src[rng.permutation(len(src))[:256]],
                tgt_pcd=tgt[rng.permutation(len(tgt))[:256]], rot=ROT, trans=TRANS)
    return [overlap_crop(), wide]


def _spawn(tmp, name, payload):
    torch.save(payload, tmp / f"{name}.pt")
    launch.spawn(launch.dp_steps, 2, args=(str(tmp / f"{name}.pt"), str(tmp / name)),
                 init_method=f"file://{tmp / (name + '.rendezvous')}", device="cpu",
                 timeout=600)
    return [torch.load(tmp / f"{name}.rank{r}", weights_only=False) for r in (0, 1)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    jc = jcfg.tiny_test_config(budgets=jcfg.Budgets(**BUDGETS), **HEADS)
    tc = tcfg.tiny_test_config(budgets=tcfg.Budgets(**BUDGETS), **HEADS)
    jbatch = j_make_pair_batch(_samples(), jc.budgets.points[0])
    pyr = jax.jit(lambda p, m: j_build_pyramid_cfg(jc, p, m))(jbatch.points[0], jbatch.masks[0])
    model = JKPFCNN(jc)
    variables = jax.jit(model.init)(jax.random.key(3), pyr, jbatch.features[0])
    jstate = j_create_train_state(jc, variables)
    mesh = j_make_mesh(2, devices=jax.devices()[:2])
    key = jax.random.key(2)
    jev = j_eval_step_dp(model, jc, j_replicate(jstate, mesh), j_shard_pair_batch(jbatch, mesh),
                         key, mesh)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    n_draws = (2, tc.budgets.points[0] * tc.budgets.corr_k)
    g = torch.Generator().manual_seed(0)
    payload = dict(cfg=tc, state_dict=state_dict_from_jax(variables),
                   batch=make_pair_batch(_samples(), tc.budgets.points[0]),
                   uniforms=[torch.rand(n_draws, generator=g) for _ in range(2)],
                   eval_uniforms=pair_uniforms(key, 2, tc.budgets.points[0], tc.budgets.corr_k))
    outs = _spawn(tmp, "dp", payload)
    return dict(tc=tc, payload=payload, outs=outs, jax_eval={k: float(v) for k, v in jev.items()},
                tmp=tmp)


def _single(run):
    tc, payload = run["tc"], run["payload"]
    model = KPFCNN(tc)
    model.load_state_dict(payload["state_dict"])
    return TrainState(tc, model)


def test_train_step_dp_matches_the_single_process_step(run):
    state = _single(run)
    want = train_step(state, run["tc"], run["payload"]["batch"],
                      uniforms=run["payload"]["uniforms"][0])
    got0, got1 = run["outs"]
    assert got0["backend"] == "gloo" and (got0["rank"], got1["rank"]) == (0, 1)
    assert got0["stats"] == got1["stats"]
    for k, v in want.items():
        np.testing.assert_allclose(got0["stats"][0][k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    for name, p in state.model.state_dict().items():
        assert torch.equal(got0["params"][name], got1["params"][name]), name
        np.testing.assert_allclose(got0["params"][name].numpy(), p.numpy(), rtol=5e-4,
                                   atol=5e-5, err_msg=name)
    moved = [n for n, p in state.model.named_parameters()
             if not torch.equal(p.detach(), run["payload"]["state_dict"][n].reshape(p.shape))]
    assert len(moved) > 10
    assert all(np.isfinite(s["total"]) for s in got0["stats"])
    assert len(got0["stats"]) == 2


def test_eval_step_dp_matches_jax(run):
    want = run["jax_eval"]
    got = run["outs"][0]["eval"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_max_stats_take_the_maximum(run):
    """Pair 1 overflows its coarse budgets, pair 0 does not: the global
    ``max_overflow`` is pair 1's (rank 1's), not the mean of the ranks'."""
    tc, payload = run["tc"], run["payload"]
    state = _single(run)
    per_pair = [float(eval_step(state, tc, payload["batch"].map(lambda t, i=i: t[i:i + 1]),
                                uniforms=payload["eval_uniforms"][i:i + 1])["max_overflow"])
                for i in range(2)]
    assert per_pair[0] == 0.0 and per_pair[1] > 0.0
    assert run["outs"][0]["eval"]["max_overflow"] == per_pair[1]
    assert run["outs"][0]["stats"][0]["max_overflow"] == per_pair[1]


def test_finite_gate_agrees_across_ranks(run):
    """A NaN rotation on rank 1's pair makes only its local gradients NaN;
    after the reduction both ranks skip the update."""
    payload = dict(run["payload"], uniforms=run["payload"]["uniforms"][:1])
    batch = payload["batch"]
    rot = batch.rot.clone()
    rot[1] = torch.nan
    payload["batch"] = dataclasses.replace(batch, rot=rot)
    payload.pop("eval_uniforms")
    outs = _spawn(run["tmp"], "nan", payload)
    for out in outs:
        assert not np.isfinite(out["stats"][0]["total"])
        for name, p in out["params"].items():
            assert torch.equal(p, payload["state_dict"][name].reshape(p.shape)), name


def test_mesh_and_shards_in_one_process():
    with pytest.raises(ValueError, match="1 rank"):
        make_mesh(n_model=2, device="cpu")
    with pytest.raises(ValueError, match="n_model=3"):
        make_mesh(n_model=3, device="cpu")
    mesh = make_mesh(device="cpu")
    assert mesh.world_size == 1 and mesh.rank == 0 and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match="1 rank"):
        make_mesh(n_data=2, device="cpu")
    assert multihost.initialize() is None  # no coordinator, one process
    assert multihost.host_local_batch_slice(4) == slice(0, 4)
    two = multihost.DataMesh(2, 1, torch.device("cpu"))
    assert multihost.host_local_batch_slice(4, two) == slice(2, 4)
    with pytest.raises(ValueError):
        multihost.host_local_batch_slice(3, two)
    batch = make_pair_batch(_samples(), 256)
    shard = shard_pair_batch(batch, two)
    assert torch.equal(shard.points, batch.points[1:]) and shard.rot.shape[0] == 1
    images = {"colors": torch.zeros(2, 3), "intrinsics": torch.eye(4)}
    sharded = shard_images(images, two, 2)
    assert sharded["colors"].shape == (1, 3) and sharded["intrinsics"].shape == (4, 4)
    placed = multihost.global_pair_batch(shard, two, 2)
    assert placed.points.shape[0] == 1


def test_main_data_parallel_trains_checkpoints_and_resumes(tmp_path):
    tr = write_indoor_fixture(tmp_path, 2, seed=1, split="train", max_points=400)
    va = write_indoor_fixture(tmp_path, 2, seed=2, split="val", max_points=400)
    model = dict(root=tr["root"], train_info=tr["info"], val_info=va["info"],
                 exp_dir=str(tmp_path / "exp"), max_epoch=2, num_workers=1, verbose_freq=1,
                 batch_size=2, data_parallel=2, optimizer="Adam", lr=1e-3, **WIDTHS)
    assert tmain.main(["--config", _yaml(tmp_path / "dp.yaml", **model),
                       "--device", "cpu"]) is None
    ckpt = tmp_path / "exp" / "checkpoints"
    assert {"epoch_0.ckpt", "epoch_1.ckpt", "best_loss.ckpt"} <= set(os.listdir(ckpt))
    saved = torch.load(ckpt / "epoch_1.ckpt", weights_only=False)
    # One global batch of 2 pairs an epoch.
    assert (saved["state"]["step"], saved["state"]["count"]) == (2, 2)
    log = (tmp_path / "exp" / "log").read_text()
    assert log.count("train Epoch 1:") == 1  # rank 0 alone logs
    resumed = dict(model, exp_dir=str(tmp_path / "resumed"), pretrain=str(ckpt / "epoch_0.ckpt"))
    assert tmain.main(["--config", _yaml(tmp_path / "resume.yaml", **resumed),
                       "--device", "cpu"]) is None
    log = (tmp_path / "resumed" / "log").read_text()
    assert "restored pretrain from" in log and "@epoch 0" in log
    again = torch.load(tmp_path / "resumed" / "checkpoints" / "epoch_1.ckpt", weights_only=False)
    assert (again["state"]["step"], again["state"]["count"]) == (2, 2)
    assert not (tmp_path / "resumed" / "checkpoints" / "epoch_0.ckpt").exists()


def test_main_refuses_more_ranks_than_cards(tmp_path, monkeypatch):
    """NCCL takes one rank a card: ``data_parallel`` above the card count
    raises before any rank starts, as the JAX Trainer's mesh check does."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    path = _yaml(tmp_path / "dp.yaml", exp_dir=str(tmp_path / "exp"), batch_size=2,
                 data_parallel=2, **WIDTHS)
    with pytest.raises(ValueError, match="data_parallel=2 but 1 card"):
        tmain.main(["--config", path])
    assert not (tmp_path / "exp").exists()
