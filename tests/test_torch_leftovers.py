"""The port's last host modules against the JAX package on the CPU: the
kernel-point optimizers (bit for bit, called directly at a small K — the
JAX ``kernel_dispositions`` would cache an uncached K into its own package),
the disposition cache, PLY IO (the bytes written equal the JAX package's),
``save_pair_ply``, ``blocks.global_average`` (within 1e-6), the flat-buffer
packing (an exact round trip) and the profiling helpers."""
import json

import numpy as np
import pytest
import torch

from pcrcg_tpu.geom import kernel_points as j_kp
from pcrcg_tpu.geom.ply import write_ply as j_write_ply
from pcrcg_tpu.models.blocks import global_average as j_global_average
from pcrcg_tpu.utils.visualize import save_pair_ply as j_save_pair_ply
from pcrcg_tpu_torch.geom import kernel_points as kp
from pcrcg_tpu_torch.geom.ply import read_ply, write_ply
from pcrcg_tpu_torch.models.blocks import global_average
from pcrcg_tpu_torch.utils import profiling
from pcrcg_tpu_torch.utils.packing import pack_pytree
from pcrcg_tpu_torch.utils.visualize import save_pair_ply


@pytest.mark.parametrize("fixed", ["center", "none"])
def test_optimize_dispositions_is_the_jax_one(fixed):
    want = j_kp._optimize_dispositions(6, 3, fixed, num_candidates=3, seed=4)
    got = kp._optimize_dispositions(6, 3, fixed, num_candidates=3, seed=4)
    assert got.dtype == np.float32 and got.shape == (6, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fixed", ["center", "verticals", "none"])
def test_spherical_lloyd_is_the_jax_one(fixed):
    want = j_kp.spherical_lloyd(9, 3, fixed, approx_n=400, max_iter=15, seed=2)
    got = kp.spherical_lloyd(9, 3, fixed, approx_n=400, max_iter=15, seed=2)
    np.testing.assert_array_equal(got, want)


def test_shipped_disposition_and_layer_points():
    np.testing.assert_array_equal(kp.kernel_dispositions(15, 3, "center"),
                                  j_kp.kernel_dispositions(15, 3, "center"))
    np.testing.assert_array_equal(kp.layer_kernel_points(0.125, 15, seed=7919),
                                  j_kp.layer_kernel_points(0.125, 15, seed=7919))


def test_uncached_disposition_is_optimized_once_into_the_cache(tmp_path, monkeypatch):
    """An uncached K is optimized (repulsion up to K = 30, Lloyd beyond) and
    cached in the git-ignored directory, never the package; the next call
    reads the file."""
    calls = []

    def fake(name):
        def fn(num_points, dimension, fixed):
            calls.append((name, num_points))
            return np.full((num_points, dimension), len(calls), np.float32)
        return fn

    monkeypatch.setattr(kp, "CACHE_DIR", tmp_path / "dispositions")
    monkeypatch.setattr(kp, "_optimize_dispositions", fake("repulsion"))
    monkeypatch.setattr(kp, "spherical_lloyd", fake("lloyd"))
    kp.kernel_dispositions.cache_clear()
    try:
        a = kp.kernel_dispositions(7, 3, "center")
        b = kp.kernel_dispositions(31, 3, "center")
        kp.kernel_dispositions.cache_clear()
        np.testing.assert_array_equal(kp.kernel_dispositions(7, 3, "center"), a)
    finally:
        kp.kernel_dispositions.cache_clear()
    assert calls == [("repulsion", 7), ("lloyd", 31)]
    assert b.shape == (31, 3)
    assert sorted(p.name for p in (tmp_path / "dispositions").iterdir()) == [
        "k_007_center_3d.npy", "k_031_center_3d_lloyd.npy"]
    assert str(kp.CACHE_DIR).startswith(str(tmp_path))
    assert "pcrcg_tpu_torch/geom" not in str(kp.CACHE_DIR)


def test_ply_round_trip_and_bytes(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    colors = rng.uniform(0, 255, size=(100, 3)).astype(np.uint8)
    labels = rng.integers(0, 9, size=100)  # int64 is written as int
    names = ["x", "y", "z", "red", "green", "blue", "label"]
    assert write_ply(str(tmp_path / "port"), [pts, colors, labels], names)
    assert j_write_ply(str(tmp_path / "jax.ply"), [pts, colors, labels], names)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    data = read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(np.stack([data["x"], data["y"], data["z"]], 1), pts)
    np.testing.assert_array_equal(data["red"], colors[:, 0])
    np.testing.assert_array_equal(data["label"], labels)
    ascii_path = tmp_path / "a.ply"
    ascii_path.write_text("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
                          "property float y\nend_header\n1 2\n3 4\n")
    a = read_ply(str(ascii_path))
    np.testing.assert_array_equal(a["x"], [1, 3])
    np.testing.assert_array_equal(a["y"], [2, 4])


def test_save_pair_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    src = rng.normal(size=(20, 3)).astype(np.float32)
    tgt = rng.normal(size=(15, 3)).astype(np.float32)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [0.5, -1.0, 2.0]
    path = save_pair_ply(str(tmp_path / "pair"), torch.from_numpy(src), tgt, torch.from_numpy(t))
    j_path = j_save_pair_ply(str(tmp_path / "jax"), src, tgt, t)
    assert path.endswith("pair.ply")
    assert (tmp_path / "pair.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    data = read_ply(j_path)
    np.testing.assert_allclose(data["x"][:20], src[:, 0] + 0.5)
    assert list(data["red"][[0, 20]]) == [255, 0]


def test_global_average_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 30, 5)).astype(np.float32)
    mask = rng.uniform(size=(2, 30)) < 0.6
    mask[1] = False  # an empty cloud averages to zero
    got = global_average(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_global_average(x, mask)), rtol=0,
                               atol=1e-6)
    assert float(got[1].abs().max()) == 0.0


def test_pack_round_trip():
    g = torch.Generator().manual_seed(0)
    tree = {"a": {"w": torch.randn(3, 5, generator=g), "b": torch.randn(5, generator=g)},
            "idx": torch.randint(0, 10, (4, 2), generator=g, dtype=torch.int32),
            "scalar": torch.tensor(2.5), "flag": [torch.tensor([True, False])]}
    pack, unpack = pack_pytree(tree)
    packed = pack(tree)
    assert sorted(packed) == ["bool", "float32", "int32"]
    assert all(v.dim() == 1 for v in packed.values())
    assert packed["float32"].numel() == 15 + 5 + 1
    out = unpack(packed)
    assert isinstance(out["flag"], list)
    for a, b in ((tree["a"]["w"], out["a"]["w"]), (tree["a"]["b"], out["a"]["b"]),
                 (tree["idx"], out["idx"]), (tree["scalar"], out["scalar"]),
                 (tree["flag"][0], out["flag"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):
        pack({**tree, "scalar": torch.tensor([2.5])})
    with pytest.raises(ValueError):
        pack({"a": tree["a"]})


def test_pack_a_modules_parameters():
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    params = [p.detach() for p in model.parameters()]
    pack, unpack = pack_pytree(params)
    flat = pack(params)["float32"]
    assert flat.numel() == sum(p.numel() for p in params)
    for a, b in zip(params, unpack({"float32": flat.clone()})):
        assert torch.equal(a, b)


def test_profiling_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as path:
        torch.randn(64, 64) @ torch.randn(64, 64)
    events = json.loads(open(path).read())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    if not torch.cuda.is_available():
        assert profiling.device_memory_report() == {}
    keep = torch.zeros(123, 7, dtype=torch.float64)  # noqa: F841 - kept alive for the scan
    live = profiling.live_buffers_by_shape("cpu")
    assert live["float64 (123, 7)"]["count"] >= 1
    assert live["float64 (123, 7)"]["mb"] == round(123 * 7 * 8 / 2**20, 2)
