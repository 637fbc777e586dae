"""The PyTorch port's host side against the JAX package: config, kernel
points, pair padding, and the rule that the port imports no JAX."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from pcrcg_tpu import config as jcfg
from pcrcg_tpu.data.pair import make_pair_batch as j_make_pair_batch
from pcrcg_tpu.geom.kernel_points import layer_kernel_points as j_layer_kernel_points
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch import resolve_device
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.geom.kernel_points import layer_kernel_points

REPO = Path(__file__).resolve().parent.parent


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _as_plain(cfg):
    out = _fields(cfg)
    out["budgets"] = _fields(cfg.budgets)
    return out


def test_config_matches_field_for_field():
    assert [f.name for f in dataclasses.fields(tcfg.Config)] == [
        f.name for f in dataclasses.fields(jcfg.Config)
    ]
    assert [f.name for f in dataclasses.fields(tcfg.Budgets)] == [
        f.name for f in dataclasses.fields(jcfg.Budgets)
    ]
    assert _as_plain(tcfg.Config()) == _as_plain(jcfg.Config())
    assert _as_plain(tcfg.tiny_test_config()) == _as_plain(jcfg.tiny_test_config())
    assert tcfg.ARCHITECTURES == jcfg.ARCHITECTURES
    assert tcfg.Config().deform_level_flags() == jcfg.Config().deform_level_flags()


@pytest.mark.parametrize("path", ["configs/test/indoor.yaml", "configs/train/indoor.yaml"])
def test_load_config_matches(path):
    t = tcfg.load_config(str(REPO / path))
    j = jcfg.load_config(str(REPO / path))
    assert _as_plain(t) == _as_plain(j)
    assert t.architecture == j.architecture


@pytest.mark.parametrize("seed,radius", [(0, 0.0625), (3, 0.25), (10, 0.5)])
def test_kernel_points_identical(seed, radius):
    np.testing.assert_array_equal(
        layer_kernel_points(radius, 15, seed=seed),
        j_layer_kernel_points(radius, 15, seed=seed),
    )


def test_make_pair_batch_identical():
    rng = np.random.default_rng(0)
    samples = [
        dict(src_pcd=rng.uniform(0, 3, (300, 3)), tgt_pcd=rng.uniform(0, 3, (150, 3)),
             rot=np.eye(3), trans=np.arange(3.0)),
        dict(src_pcd=rng.uniform(0, 3, (90, 3)), tgt_pcd=rng.uniform(0, 3, (256, 3)),
             rot=np.eye(3)[::-1], trans=np.ones(3)),
    ]
    with pytest.warns(UserWarning):
        got = make_pair_batch(samples, 256, in_feats_dim=2, rng=np.random.default_rng(7))
    with pytest.warns(UserWarning):
        want = j_make_pair_batch(samples, 256, in_feats_dim=2, rng=np.random.default_rng(7))
    for name in ("points", "masks", "features", "rot", "trans"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


def test_cuda_default_raises_without_cuda(monkeypatch):
    """Entry points default to CUDA and refuse to fall back to the CPU."""
    from pcrcg_tpu_torch.demo import main as demo_main
    from pcrcg_tpu_torch.eval.tester import register_pair
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    cfg = tcfg.tiny_test_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_kpfcnn(cfg)
    model = init_kpfcnn(cfg, device="cpu")
    pts = torch.zeros(2, 256, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        register_pair(model, cfg, pts, torch.ones(2, 256, dtype=torch.bool), pts[..., :1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo_main([])


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pcrcg_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "pcrcg_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        f"{p.relative_to(REPO)}: {name}"
        for p in files
        for name in _imports(p)
        if name.split(".")[0] in _FORBIDDEN
    ]
    assert not bad, bad
