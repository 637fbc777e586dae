"""The port's 2D backbone (``pcrcg_tpu_torch/models/resunet.py``) against
the JAX package's ``ResUNet.apply``, compiled, with the JAX-initialized
weights carried across (``resunet_state_dict_from_jax``), and the torch
checkpoint import against ``pcrcg_tpu/models/torch_import.py`` on the same
state dicts.

Inputs: uniform RGB from numpy seeds at 64×80, where stage 4's maps are
2×3.  At 32×40 they are 1×2, and a per-image BN over two pixels makes the
network ill-conditioned: there the JAX package's compiled and eager runs of
one depth-50 model differ by 0.15 of the largest output, and no tolerance
would hold.  At 64×80 that gap is 3.8e-6 (depth 18) and 6.8e-5 (depth 50).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pcrcg_tpu.models import resunet as jres
from pcrcg_tpu.models.torch_import import import_torch_resunet
from pcrcg_tpu.models.torch_import import load_backbone2d as j_load_backbone2d
from pcrcg_tpu_torch.models import resunet as tres
from pcrcg_tpu_torch.models.weights import (
    import_backbone2d_state_dict,
    load_backbone2d,
    resunet_state_dict_from_jax,
)

H, W = 64, 80
# Largest |port - JAX| over the largest |JAX| output entry (fp32).  Measured
# on this CPU: 8.7e-6 (depth 18), 1.2e-4 (depth 50).
TOL = {18: 1e-4, 50: 1e-3}
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_model(depth, dtype=None):
    """(flax module, numpy variables, input, compiled output), per depth:
    one compiled ``init_with_output`` (the forward of ``apply`` on the
    weights it draws; train-mode BN reads no stored statistics)."""
    key = (depth, dtype)
    if key not in _CACHE:
        x = np.random.default_rng(depth).uniform(size=(2, H, W, 3)).astype(np.float32)
        model = jres.ResUNet(16, depth, dtype=dtype)
        out, variables = jax.jit(model.init_with_output)(jax.random.key(depth), x)
        _CACHE[key] = (model, jax.tree_util.tree_map(np.asarray, variables), x, np.asarray(out))
    return _CACHE[key]


def _port(variables, depth, dtype=None):
    model = tres.ResUNet(16, depth, dtype=dtype)
    model.load_state_dict(resunet_state_dict_from_jax(variables["params"],
                                                      variables["batch_stats"]), strict=True)
    return model


@pytest.mark.parametrize("depth", [18, 50])
def test_resunet_matches_jax(depth):
    _, variables, x, want = _jax_model(depth)
    with torch.no_grad():
        got = _port(variables, depth)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, H // 2, W // 2, 16) and got.dtype == np.float32
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL[depth], err


def test_resunet_bfloat16_matches_jax():
    """``dtype=bfloat16``: bf16 convolutions, fp32 BN statistics, fp32
    output, as the JAX package's.  bf16-grade tolerance: 0.15 of the
    largest entry (measured 0.072; the JAX package's own bf16 run is 0.052
    from its fp32 run)."""
    _, variables, x, want = _jax_model(18, jnp.bfloat16)
    with torch.no_grad():
        port = _port(variables, 18, torch.bfloat16)
        got = port(torch.from_numpy(x)).numpy()
        fp32 = _port(variables, 18)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 0.15 * np.abs(want).max()
    assert np.abs(got - fp32).max() > 1e-3 * np.abs(fp32).max()  # it did run in bf16


def test_train_mode_bn_normalizes_each_image_alone():
    """Per-image (H, W) statistics, biased variance, buffers never read or
    written; ``nn.BatchNorm2d`` in train mode pools the images instead."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 8, 5, 7)).astype(np.float32)) * 3 + 1
    bn = tres.TrainModeBN(8)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 2.0)
        bn.bias.uniform_(-1.0, 1.0)
        bn.running_mean.fill_(7.0)
        bn.running_var.fill_(9.0)
        got = bn(x)
        alone = torch.cat([bn(x[i:i + 1]) for i in range(3)])
        want = torch.cat([F.batch_norm(x[i:i + 1], None, None, bn.weight, bn.bias, True,
                                       0.0, 1e-5) for i in range(3)])
        pooled = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, 1e-5)
    assert torch.equal(got, alone)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float((got - pooled).abs().max()) > 0.1
    assert bool((bn.running_mean == 7.0).all() and (bn.running_var == 9.0).all())
    bn.running = True
    with torch.no_grad():
        torch.testing.assert_close(bn(x), F.batch_norm(x, bn.running_mean, bn.running_var,
                                                       bn.weight, bn.bias, False, 0.0, 1e-5))


def test_bilinear_resize_matches_jax_and_interpolate():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 5, 7)).astype(np.float32)
    got = tres.bilinear_resize(torch.from_numpy(x), (9, 13))
    want = np.asarray(jres.bilinear_resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (9, 13)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, F.interpolate(torch.from_numpy(x), (9, 13), mode="bilinear",
                                                  align_corners=True), rtol=1e-5, atol=1e-5)
    ramp = torch.linspace(0, 1, 5).reshape(1, 5, 1)
    torch.testing.assert_close(tres.bilinear_resize(ramp, (9, 1))[0, :, 0],
                               torch.linspace(0, 1, 9), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tres.align_corners_matrix(4, 7).numpy(),
                                  np.asarray(jres.align_corners_matrix(4, 7)))


# ---------------------------------------------------- torch checkpoint import
# The cases of tests/test_resunet.py, each run through both packages'
# importers from the same initial weights: the port's merged weights must
# equal the JAX package's, and the reports their counts.


def _both_import(state):
    _, variables, *_ = _jax_model(18)
    sub = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    merged, j_report = import_torch_resunet(state, sub)
    port = _port(variables, 18)
    report = import_backbone2d_state_dict(state, port)
    want = resunet_state_dict_from_jax(merged["params"], merged["batch_stats"])
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    assert (report["loaded"], report["skipped"]) == (j_report["loaded"], j_report["skipped"])
    return port, report


def test_import_torchvision_layout():
    rng = np.random.default_rng(0)
    conv1 = rng.normal(size=(64, 3, 7, 7)).astype(np.float32)
    state = {
        "conv1.weight": conv1,
        "bn1.weight": np.full(64, 2.0, np.float32),
        "bn1.bias": np.full(64, 0.5, np.float32),
        "bn1.running_mean": np.full(64, 0.1, np.float32),
        "bn1.running_var": np.full(64, 0.9, np.float32),
        "bn1.num_batches_tracked": np.int64(7),
        "fc.weight": rng.normal(size=(10, 512)).astype(np.float32),
        "layer1.0.conv1.weight": rng.normal(size=(64, 64, 3, 3)).astype(np.float32),
        "layer2.0.downsample.0.weight": rng.normal(size=(128, 64, 1, 1)).astype(np.float32),
        "encoder.layer2.0.downsample.1.running_var": np.full(128, 0.7, np.float32),
        "decoder.up1.conv1_2.weight": rng.normal(size=(256, 256, 3, 3)).astype(np.float32),
        "decoder.conv0.bias": np.full(16, 0.25, np.float32),
    }
    port, report = _both_import(state)
    np.testing.assert_array_equal(port.conv1.weight.detach().numpy(), conv1)
    assert float(port.bn1.running_var[0]) == pytest.approx(0.9)
    assert float(port.layer2[0].downsample[1].running_var[0]) == pytest.approx(0.7)
    assert report["loaded"] == 10


def test_import_pri3d_layout(tmp_path):
    """pri3d checkpoints nest under state['model'] with 'backbone.'-prefixed
    keys and heads that must be skipped (reference lib/trainer.py:114-127)."""
    _, variables, *_ = _jax_model(18)
    rng = np.random.default_rng(1)
    conv1 = rng.normal(size=(64, 3, 7, 7)).astype(np.float32)
    ckpt = {
        "model": {
            "backbone.conv1.weight": torch.from_numpy(conv1),
            "backbone.bn1.weight": torch.full((64,), 3.0),
            "backbone.bn1.running_mean": torch.full((64,), 0.25),
            "depth_head.conv.weight": torch.zeros(1, 64, 3, 3),
            "sem_head.weight": torch.zeros(20, 64),
        },
        "epoch": 3,
    }
    path = tmp_path / "pri3d.pth"
    torch.save(ckpt, path)
    sub = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    merged, j_report = j_load_backbone2d(str(path), sub)
    port = _port(variables, 18)
    report = load_backbone2d(str(path), port)
    want = resunet_state_dict_from_jax(merged["params"], merged["batch_stats"])
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    assert report["loaded"] == j_report["loaded"] == 3
    assert any("depth_head" in k for k in report["skipped_keys"])


def test_import_moco_layout():
    """MoCo v2: 'module.encoder_q.' keys load; the momentum encoder_k, the
    MLP head and the queue are skipped."""
    rng = np.random.default_rng(2)
    conv1 = rng.normal(size=(64, 3, 7, 7)).astype(np.float32)
    state = {
        "module.encoder_q.conv1.weight": conv1,
        "module.encoder_q.bn1.weight": np.full(64, 1.5, np.float32),
        "module.encoder_q.fc.0.weight": rng.normal(size=(2048, 512)).astype(np.float32),
        "module.encoder_k.conv1.weight": rng.normal(size=(64, 3, 7, 7)).astype(np.float32),
        "queue": np.zeros((128, 65536), np.float32),
        "queue_ptr": np.zeros(1, np.int64),
    }
    port, report = _both_import(state)
    np.testing.assert_array_equal(port.conv1.weight.detach().numpy(), conv1)
    assert report["loaded"] == 2
    assert any("encoder_k" in k for k in report["skipped_keys"])


def test_import_shape_mismatch_is_skipped():
    _, variables, *_ = _jax_model(18)
    before = _port(variables, 18).conv1.weight.detach().clone()
    port, report = _both_import({"conv1.weight": np.zeros((64, 4, 7, 7), np.float32)})
    assert torch.equal(port.conv1.weight.detach(), before)
    assert report["loaded"] == 0 and report["skipped"] == 1
