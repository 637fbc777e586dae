"""An image config (``image_feature``) without images raises at each of the
port's five entry points, as the JAX package's model does
(pcrcg_tpu/models/pcrcg.py:34-35: "image_feature=True needs image
inputs"), before any work and with no parameter moved; with images, each
entry point runs the color model (``PCRCG``) and gives finite results.

Without the check, ``forward_pair``, ``register_pair`` and the train /
eval / infer steps would run a geometry-only KPFCNN over ones columns.
Input: ``tiny_test_config(image_feature=True, in_feats_dim=129)`` (the two
values that ``configs/train/indoor.yaml`` ships) with a depth-18 backbone,
one random 256-point pair (numpy seed 0) and ``synthetic_images`` at
64×80.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrcg_tpu.config import tiny_test_config as j_tiny_test_config
from pcrcg_tpu.models.pcrcg import PCRCG as JPCRCG
from pcrcg_tpu_torch.assets import synthetic_images
from pcrcg_tpu_torch.config import tiny_test_config
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.eval.tester import register_pair
from pcrcg_tpu_torch.models.pcrcg import init_pcrcg
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import eval_step, forward_pair, infer_step, train_step

IMAGE_CFG = dict(image_feature=True, in_feats_dim=129)
ENTRIES = ["forward_pair", "register_pair", "train_step", "eval_step", "infer_step"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def image_setup():
    cfg = tiny_test_config(**IMAGE_CFG, backbone2d_depth=18)
    rng = np.random.default_rng(0)
    sample = dict(src_pcd=rng.normal(size=(256, 3)), tgt_pcd=rng.normal(size=(256, 3)),
                  rot=np.eye(3), trans=np.zeros(3))
    batch = make_pair_batch([sample], cfg.budgets.points[0], in_feats_dim=129)
    images = synthetic_images(cfg.img_num, height=64, width=80)
    return cfg, batch, init_pcrcg(cfg, seed=0, device="cpu"), images


def _call(entry, cfg, batch, model, images):
    """``entry`` on the pair; ``images`` is one pair's dict or None (the
    steps take it with the pair-batch axis first)."""
    batched = None if images is None else {k: v[None] for k, v in images.items()}
    gen = torch.Generator().manual_seed(0)
    if entry == "forward_pair":
        with torch.no_grad():
            return forward_pair(model, cfg, batch.points[0], batch.masks[0], batch.features[0],
                                images)[0]
    if entry == "register_pair":
        return register_pair(model, cfg, batch.points[0], batch.masks[0], batch.features[0],
                             gen, n_points=64, num_iterations=256, hypothesis_chunk=128,
                             images=images, device="cpu")
    step = {"train_step": train_step, "eval_step": eval_step}.get(entry)
    if step is not None:
        return step(TrainState(cfg, model), cfg, batch, generator=gen, images=batched)
    return infer_step(TrainState(cfg, model), cfg, batch, images=batched)


def test_reference_refuses_an_image_config_without_images():
    cfg = j_tiny_test_config(**IMAGE_CFG)
    with pytest.raises(AssertionError, match="needs image inputs"):
        JPCRCG(cfg).init(jax.random.key(0), None, jnp.ones((2, 256, 129), jnp.float32))


@pytest.mark.parametrize("entry", ENTRIES)
def test_port_refuses_an_image_config(image_setup, entry):
    cfg, batch, model, _ = image_setup
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="needs image inputs"):
        _call(entry, cfg, batch, model, None)
    # Refused before any work: no parameter moved.
    assert all(bool((p.detach() == before[n]).all()) for n, p in model.named_parameters())


@pytest.mark.parametrize("entry", ENTRIES)
def test_port_runs_an_image_config_with_images(image_setup, entry):
    cfg, batch, model, images = image_setup
    out = _call(entry, cfg, batch, model, images)
    values = [out["transform"]] if entry == "register_pair" else list(out.values())
    assert all(bool(torch.isfinite(v).all()) for v in values)
    if entry in ("forward_pair", "infer_step"):
        assert out["feats_f"].shape[-1] == cfg.final_feats_dim
