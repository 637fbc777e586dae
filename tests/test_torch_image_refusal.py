"""The port refuses a config with the color branch on (``image_feature``),
as the JAX package's model does without image inputs.

The port has no image lift yet.  Before the refusal, ``forward_pair``,
``register_pair`` and the train / eval / infer steps ran a geometry-only
KPFCNN over the ones columns of such a config without complaint, where
the reference's ``PCRCG`` asserts "image_feature=True needs image inputs"
(pcrcg_tpu/models/pcrcg.py:34-35).  Input: ``tiny_test_config(
image_feature=True, in_feats_dim=129)`` (the two values that
``configs/train/indoor.yaml`` ships) and one random 256-point pair (numpy
seed 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcrcg_tpu.config import tiny_test_config as j_tiny_test_config
from pcrcg_tpu.models.pcrcg import PCRCG
from pcrcg_tpu_torch.config import tiny_test_config
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.eval.tester import register_pair
from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import eval_step, forward_pair, infer_step, train_step

IMAGE_CFG = dict(image_feature=True, in_feats_dim=129)


@pytest.fixture(scope="module")
def image_setup():
    cfg = tiny_test_config(**IMAGE_CFG)
    rng = np.random.default_rng(0)
    sample = dict(src_pcd=rng.normal(size=(256, 3)), tgt_pcd=rng.normal(size=(256, 3)),
                  rot=np.eye(3), trans=np.zeros(3))
    batch = make_pair_batch([sample], cfg.budgets.points[0], in_feats_dim=129)
    return cfg, batch, init_kpfcnn(cfg, seed=0, device="cpu")


def test_reference_refuses_an_image_config_without_images():
    cfg = j_tiny_test_config(**IMAGE_CFG)
    with pytest.raises(AssertionError, match="needs image inputs"):
        PCRCG(cfg).init(jax.random.key(0), None, jnp.ones((2, 256, 129), jnp.float32))


@pytest.mark.parametrize("entry", ["forward_pair", "register_pair", "train_step", "eval_step",
                                   "infer_step"])
def test_port_refuses_an_image_config(image_setup, entry):
    cfg, batch, model = image_setup
    calls = {
        "forward_pair": lambda: forward_pair(model, cfg, batch.points[0], batch.masks[0],
                                             batch.features[0]),
        "register_pair": lambda: register_pair(model, cfg, batch.points[0], batch.masks[0],
                                               batch.features[0], device="cpu"),
        "train_step": lambda: train_step(TrainState(cfg, model), cfg, batch),
        "eval_step": lambda: eval_step(TrainState(cfg, model), cfg, batch),
        "infer_step": lambda: infer_step(TrainState(cfg, model), cfg, batch),
    }
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(NotImplementedError, match="color branch"):
        calls[entry]()
    # Refused before any work: no parameter moved.
    assert all(bool((p.detach() == before[n]).all()) for n, p in model.named_parameters())
