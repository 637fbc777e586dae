"""The color branch of the port against the JAX package: the image lift,
``PCRCG`` through ``forward_pair``, the quantized inputs and their exact
dequantization, the frozen backbone in ``train_step``, the host image
pipeline (``data/images.py``) and the synthetic image stacks.

Weights: the JAX ``PCRCG`` ``init`` (compiled, once per module), carried
across by ``pcrcg_state_dict_from_jax``.  Inputs: numpy
seeds; the point pair is a crop of the in-repo assets pair, its images
``render_pair_images`` at 64×80 (the ResUNet tests say why not smaller).
The config is ``tiny_test_config(image_feature=True, in_feats_dim=129)``
with a depth-18 backbone; the JAX side sets ``tiled_feat_limbs=2``, though
on the CPU its KPConv takes the dense route, which has no bf16 limbs.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pcrcg_tpu import config as jcfg
from pcrcg_tpu.assets import demo_cloud_pair
from pcrcg_tpu.models.lift import ImageLift as JImageLift
from pcrcg_tpu.models.pcrcg import PCRCG as JPCRCG
from pcrcg_tpu_torch import assets as tassets
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch.data import images as timages
from pcrcg_tpu_torch.data.pair import make_pair_batch
from pcrcg_tpu_torch.models.lift import IMAGE_KEYS, ImageLift, _exact_div
from pcrcg_tpu_torch.models.pcrcg import PCRCG, init_pcrcg
from pcrcg_tpu_torch.models.weights import pcrcg_state_dict_from_jax
from pcrcg_tpu_torch.train.state import TrainState
from pcrcg_tpu_torch.train.step import forward_pair, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUDGETS = dict(points=(256, 192, 192, 96), neighbors=(16, 16, 16, 16), corr_k=8,
                query_chunk=64, search_tile=32, search_m_tiles=4)
IMAGE_CFG = dict(image_feature=True, in_feats_dim=129, backbone2d_depth=18)
HEIGHT, WIDTH = 64, 80


def _crop(p, n):
    d = ((p - np.median(p, 0)) ** 2).sum(1)
    return p[np.argsort(d, kind="stable")[:n]]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def whole():
    """JAX PCRCG variables, its outputs and its lift's, from one compiled
    ``init_with_output`` on the pyramid that the JAX ``forward_pair`` builds
    (``forward_pair`` = ``build_pyramid_cfg``, then the model's forward)."""
    from pcrcg_tpu.data.pair import make_pair_batch as j_make_pair_batch
    from pcrcg_tpu.ops.pyramid import build_pyramid_cfg

    src, tgt = demo_cloud_pair()
    sample = dict(src_pcd=_crop(src, 256), tgt_pcd=_crop(tgt, 240), rot=np.eye(3),
                  trans=np.zeros(3))
    images = tassets.render_pair_images(sample["src_pcd"], sample["tgt_pcd"], 2, seed=1,
                                        height=HEIGHT, width=WIDTH)
    jc = jcfg.tiny_test_config(budgets=jcfg.Budgets(**_BUDGETS), tiled_feat_limbs=2,
                               **IMAGE_CFG)
    jb = j_make_pair_batch([sample], 256, in_feats_dim=129)
    pyr = jax.jit(lambda p, m: build_pyramid_cfg(jc, p, m))(jb.points[0], jb.masks[0])
    model = JPCRCG(jc)
    init = jax.jit(lambda key, p, f, i: model.init_with_output(
        key, p, f, i, capture_intermediates=lambda mdl, _: isinstance(mdl, JImageLift),
        mutable=True))
    want, variables = init(jax.random.key(0), pyr, jb.features[0], images)
    want_lift = variables["intermediates"]["lift"]["__call__"][0]
    lift_args = (pyr.points[0], pyr.masks[0], *(images[k] for k in IMAGE_KEYS))
    tc = tcfg.tiny_test_config(budgets=tcfg.Budgets(**_BUDGETS), **IMAGE_CFG)
    port = PCRCG(tc).eval()
    port.load_state_dict(pcrcg_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                          variables)),
                         strict=True)
    return dict(cfg=tc, port=port, sample=sample, images=images,
                want={k: np.asarray(v) for k, v in want.items()},
                lift_args=[np.asarray(a) for a in lift_args], want_lift=np.asarray(want_lift))


def test_pcrcg_variables_load_strict_and_freeze_the_backbone(whole):
    port = whole["port"]
    names = [n for n, _ in port.named_parameters()]
    assert any(n.startswith("lift.backbone2d.") for n in names)
    for n, p in port.named_parameters():
        assert p.requires_grad == (not n.startswith("lift.backbone2d.")), n
    assert all(n.startswith("lift.backbone2d.") for n, _ in port.named_buffers()
               if n.endswith(("running_mean", "running_var")))


def test_image_lift_matches_jax(whole):
    """The lifted [2, N, 129] features: relative 1e-4 of the largest entry
    (the backbone's fp32 sums in another order)."""
    got = whole["port"].lift(*(torch.from_numpy(a) for a in whole["lift_args"])).numpy()
    want = whole["want_lift"]
    masks = whole["lift_args"][1]
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    lifted = (want[..., :-1] != 1).any(-1) & masks
    assert lifted.sum() > 0.3 * masks.sum()  # the renders are geometry-consistent
    np.testing.assert_array_equal(got[~masks], 0.0)
    np.testing.assert_array_equal(got[masks][:, -1], 1.0)


def test_forward_pair_with_images_matches_jax(whole):
    """PCRCG through ``forward_pair``: descriptors and scores within 1e-4
    (as the geometry-only model's test, tests/test_torch_model.py)."""
    s = whole["sample"]
    batch = make_pair_batch([s], 256, in_feats_dim=129)
    with torch.no_grad():
        got, _ = forward_pair(whole["port"], whole["cfg"], batch.points[0], batch.masks[0],
                              batch.features[0], whole["images"])
    assert set(got) == set(whole["want"])
    for key, want in whole["want"].items():
        np.testing.assert_allclose(got[key].numpy(), want, rtol=1e-4, atol=1e-4, err_msg=key)


def _lift_inputs(rng, n=64, h=32, w=40, quantized=False):
    """Points in front of an identity camera, each on its own pixel (a
    shuffled grid, half a pixel off the pixel edges); image 1's depth
    matches the first half of them only, image 2's all; 4 points sit
    behind the camera and the last 4 rows are pads."""
    f, z = 16.0, 2.0
    grid = np.stack(np.meshgrid(np.arange(8) * 4 + 4, np.arange(8) * 3 + 4), -1).reshape(-1, 2)
    pix = np.stack([grid[rng.permutation(n)] for _ in range(2)])  # [2, n, (u, v)]
    pts = np.zeros((2, n, 3), np.float32)
    pts[..., 0] = (pix[..., 0] + 0.5 - w / 2) * z / f
    pts[..., 1] = (pix[..., 1] + 0.5 - h / 2) * z / f
    pts[..., 2] = z
    pts[:, n // 2:n // 2 + 4, 2] = -1.0  # behind the camera: no image sees them
    masks = np.ones((2, n), bool)
    masks[:, -4:] = False
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = f
    intr[0, 2], intr[1, 2] = w / 2, h / 2
    depths_mm = np.full((2, 2, h, w), 2000, np.uint16)
    for c in range(2):  # image 1 far away where the second half lands
        depths_mm[c, 0, pix[c, n // 2:, 1], pix[c, n // 2:, 0]] = 9000
    colors_u8 = rng.integers(0, 256, (2, 2, 2 * h, 2 * w, 3), dtype=np.uint8)
    w2c = np.tile(np.eye(4, dtype=np.float32), (2, 2, 1, 1))
    vmaps = rng.uniform(0.5, 1.0, (2, 2, h, w)).astype(np.float32)
    if quantized:
        return pts, masks, colors_u8, depths_mm, w2c, vmaps, intr
    return (pts, masks, colors_u8.astype(np.float32) / np.float32(255.0),
            depths_mm.astype(np.float32) / np.float32(1000.0), w2c, vmaps, intr)


@pytest.fixture(scope="module")
def lift_pair():
    lift = ImageLift(8, 18)
    lift.backbone2d.reset_parameters(torch.Generator().manual_seed(1))
    return lift, _lift_inputs(np.random.default_rng(7))


def test_image_lift_priority_ones_and_detach(lift_pair):
    """First valid image wins, unseen points keep the ones row, pads are 0,
    no gradient reaches the backbone (the JAX package's rules; its numbers
    are held by ``test_image_lift_matches_jax``)."""
    port, args = lift_pair
    n = args[0].shape[1]
    with torch.enable_grad():
        got = port(*(torch.from_numpy(a) for a in args))
    assert not got.requires_grad
    got = got.numpy()
    ones = np.ones(9, np.float32)
    for c in range(2):
        unseen = np.arange(n // 2, n // 2 + 4)
        np.testing.assert_array_equal(got[c, unseen], np.broadcast_to(ones, (4, 9)))
        np.testing.assert_array_equal(got[c, -4:], 0.0)
        assert not (got[c, :n // 2, :-1] == 1).all(-1).any()  # lifted
    # The two halves take different images: recompute with image 2 alone.
    pts, masks, colors, depths, w2c, vmaps, intr = args
    only2 = port(*(torch.from_numpy(a) for a in (pts, masks, colors[:, 1:], depths[:, 1:],
                                                  w2c[:, 1:], vmaps[:, 1:], intr))).numpy()
    seen2 = np.arange(n // 2 + 4, n - 4)
    # The backbone sees a batch of 2 images instead of 4: another summation
    # order, so 1e-6 of the largest entry rather than bit for bit.
    scale = np.abs(got).max()
    assert np.abs(got[:, seen2] - only2[:, seen2]).max() <= 1e-6 * scale
    assert np.abs(got[:, :n // 2] - only2[:, :n // 2]).max() > 0.1 * scale


def test_quantized_lift_equals_the_float_lift(lift_pair):
    """uint8 colors and uint16 millimeter depths give bit for bit the lift of
    the host's float32 division (the JAX package's own test holds its
    quantized path to its float path the same way)."""
    port, args = lift_pair
    q = _lift_inputs(np.random.default_rng(7), quantized=True)
    got_q = port(*(torch.from_numpy(a) for a in q)).numpy()
    got_f = port(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(got_q, got_f)


@pytest.mark.parametrize("dtype,denom", [(np.uint8, 255.0), (np.uint16, 1000.0)])
def test_exact_div_equals_numpy_exhaustively(dtype, denom):
    x = np.arange(np.iinfo(dtype).max + 1, dtype=dtype)
    want = x.astype(np.float32) / np.float32(denom)
    got = _exact_div(torch.from_numpy(x), denom).numpy()
    np.testing.assert_array_equal(got, want)


def test_image_train_step_leaves_the_backbone_bit_identical():
    """One image ``train_step`` with a weight decay of 0.1 (each decayed
    weight would move by lr·wd·p, far above its fp32 spacing): every
    backbone2d tensor, buffers included, is bit-identical; every KPConv
    weight moves (tests/test_train.py's check, on the port)."""
    cfg = tcfg.tiny_test_config(**IMAGE_CFG, lr=0.01, weight_decay=0.1)
    rng = np.random.default_rng(11)
    base = rng.uniform(0, 0.5, size=(160, 3)).astype(np.float32)
    sample = dict(src_pcd=base, tgt_pcd=base[20:150] + rng.normal(scale=0.002, size=(130, 3)),
                  rot=np.eye(3), trans=np.zeros(3))
    batch = make_pair_batch([sample], cfg.budgets.points[0], in_feats_dim=129)
    images = tassets.synthetic_images(cfg.img_num, height=HEIGHT, width=WIDTH)
    images = {k: v[None] for k, v in images.items()}
    state = TrainState(cfg, init_pcrcg(cfg, seed=0, device="cpu"))
    frozen = {k: v.clone() for k, v in state.model.state_dict().items()
              if k.startswith("lift.backbone2d.")}
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    stats = train_step(state, cfg, batch, generator=torch.Generator().manual_seed(0),
                       images=images)
    assert np.isfinite(float(stats["total"]))
    after = state.model.state_dict()
    for k, v in frozen.items():
        assert torch.equal(after[k], v), k
    moved = [n for n, p in state.model.named_parameters() if not torch.equal(p, before[n])]
    assert all(n in moved for n in before if n.endswith("KPConv.weights"))
    assert not any(n.startswith("lift.") for n in moved)
    assert all(not n.startswith("lift.") for n, p in state.model.named_parameters()
               if p in state.optimizer.state)


# ------------------------------------------------------ synthetic image stacks


@pytest.mark.parametrize("quantized", [False, True])
def test_synthetic_images_equal_bench(quantized):
    sys.path.insert(0, REPO)
    from bench import synthetic_images

    got = tassets.synthetic_images(2, seed=3, height=48, width=64, quantized=quantized)
    want = synthetic_images(2, seed=3, height=48, width=64, quantized=quantized)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_render_views_equal_the_accuracy_script():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from train_synthetic_register import procedural_colors, render_views

    pts = _crop(demo_cloud_pair()[0], 3000)
    np.testing.assert_array_equal(tassets.procedural_colors(pts), procedural_colors(pts))
    got = tassets.render_views(pts, procedural_colors(pts), 2, np.random.default_rng(4), 48, 64)
    want = render_views(pts, procedural_colors(pts), 2, np.random.default_rng(4), 48, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_the_port_imports_without_pil():
    """Nothing on the card's path needs PIL: every module of the package
    imports with PIL made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['PIL'] = None\n"
        "import pcrcg_tpu_torch\n"
        "for m in pkgutil.walk_packages(pcrcg_tpu_torch.__path__, 'pcrcg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules and 'pcrcg_tpu' not in sys.modules\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


# ---------------------------------------------------- host image pipeline
# The cases of tests/test_images.py on the port's copy, and its output
# equal to the JAX package's on the same on-disk fixture.

FX, FY, CX, CY = 585.0, 585.0, 320.0, 240.0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 3DMatch-layout tree: two fragments of one scene with info.txt,
    poses, intrinsics, color and depth PNGs and SuperGlue npzs."""
    from PIL import Image

    base = tmp_path_factory.mktemp("threedmatch")
    root, img_root, matches_root = base / "data", base / "images", base / "matches"
    scene_dir = root / "test" / "scene1"
    scene_dir.mkdir(parents=True)
    matches_root.mkdir()
    rng = np.random.default_rng(0)
    src = np.stack([rng.uniform(-0.5, 0.5, 150), rng.uniform(-0.35, 0.35, 150),
                    np.full(150, 1.5)], 1).astype(np.float32)
    torch.save(torch.from_numpy(src), scene_dir / "cloud_bin_0.pth")
    torch.save(torch.from_numpy(src[:140]), scene_dir / "cloud_bin_1.pth")
    (scene_dir / "cloud_bin_0.info.txt").write_text("scene1 seq-01 5 23\n")
    (scene_dir / "cloud_bin_1.info.txt").write_text("scene1 seq-01 7 30\n")
    seq_dir = img_root / "scene1" / "seq-01"
    seq_dir.mkdir(parents=True)
    intr = np.eye(3)
    intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2] = FX, FY, CX, CY
    np.savetxt(img_root / "scene1" / "camera-intrinsics.txt", intr)
    shift = lambda x, y: np.block([[np.eye(3), np.array([[x], [y], [0.0]])],  # noqa: E731
                                   [np.zeros((1, 3)), 1.0]])
    poses = {5: np.eye(4), 23: shift(0.1, 0.0), 7: np.eye(4), 30: shift(0.0, 0.2),
             14: np.eye(4), 18: np.eye(4)}
    for fid, pose in poses.items():
        stem = seq_dir / f"frame-{fid:06d}"
        r = np.random.default_rng(fid)
        Image.fromarray(r.integers(0, 255, size=(480, 640, 3), dtype=np.uint8)).save(
            f"{stem}.color.png")
        Image.fromarray(np.full((480, 640), 1500 + fid, np.uint16)).save(f"{stem}.depth.png")
        np.savetxt(f"{stem}.pose.txt", pose)
    kp = np.array([[40.5, 30.2], [100.0, 80.0], [37.0, 28.0]])
    for sf, tf in [(5, 7), (23, 30), (14, 18)]:
        path = timages.match_npz_path(str(matches_root), "scene1", "seq-01", str(sf),
                                      "scene1", "seq-01", str(tf))
        np.savez(path, keypoints0=kp, keypoints1=kp, matches=np.array([0, 1, 2]),
                 match_confidence=np.array([0.9, 0.4, 0.7]))
    return dict(root=str(root), img_root=str(img_root), matches_root=str(matches_root),
                poses=poses, src=src)


def test_fragment_ids_and_frame_selection(tree):
    assert timages.fragment_frame_ids(tree["root"], "test/scene1/cloud_bin_0.pth") == (
        "scene1", "seq-01", "5", "23")
    ids = ("scene1", "seq-01", "5", "23")
    for img_num, expect in [(1, ["5"]), (2, ["5", "23"]), (3, ["5", "14", "23"])]:
        loader = timages.ImagePairLoader(tree["img_root"], tree["matches_root"], img_num)
        assert loader.frame_ids(ids) == expect


def test_color_depth_decode_and_intrinsics(tree):
    stem = os.path.join(tree["img_root"], "scene1", "seq-01", "frame-000005")
    color = timages.load_color(stem + ".color.png")
    assert color.shape == (240, 320, 3) and color.dtype == np.float32
    assert 0.0 <= color.min() and color.max() <= 1.0 and color.std() > 0.05
    np.testing.assert_allclose(timages.load_depth(stem + ".depth.png"), 1.505)
    assert timages.load_color(stem + ".color.png", quantized=True).dtype == np.uint8
    assert timages.load_depth(stem + ".depth.png", quantized=True).dtype == np.uint16
    intr = timages.projection_intrinsics(tree["img_root"], "scene1")
    np.testing.assert_allclose(intr[0, 0], FX * 160 / 640)
    np.testing.assert_allclose(intr[1, 2], CY * (120 - 1) / (480 - 1))


def test_splat_valid_maps_equal_jax():
    from pcrcg_tpu.data.images import splat_valid_maps

    npz = {
        "keypoints0": np.array([[40.5, 30.2], [43.0, 31.0], [2.0, 3.0]]),
        "keypoints1": np.array([[80.0, 60.0], [90.0, 70.0], [5.0, 5.0], [150.0, 100.0]]),
        "matches": np.array([0, 3, -1]),
        "match_confidence": np.array([0.9, 0.4, 0.8]),
    }
    m0, m1 = timages.splat_valid_maps(npz, window_size=5)
    w0, w1 = splat_valid_maps(npz, window_size=5)
    np.testing.assert_array_equal(m0, w0)
    np.testing.assert_array_equal(m1, w1)
    assert m0[30, 36] == pytest.approx(0.9) and m0[30, 40] == pytest.approx(0.4)
    assert m0[3, 2] == 0.0 and m1[5, 5] == 0.0


@pytest.mark.parametrize("img_num,quantized", [(1, False), (2, True), (3, False)])
def test_load_pair_equals_jax(tree, img_num, quantized):
    """The whole host pipeline (decode, w2c composition with the
    augmentation folded in, valid maps, intrinsics) equal to the JAX
    package's on the same tree."""
    from pcrcg_tpu.data.images import ImagePairLoader
    from pcrcg_tpu.data.indoor import euler_zyx_matrix

    aug_rot = euler_zyx_matrix(np.random.default_rng(3).random(3) * 2 * np.pi)
    args = (tree["root"], "test/scene1/cloud_bin_0.pth", "test/scene1/cloud_bin_1.pth",
            aug_rot, True, True)
    got = timages.ImagePairLoader(tree["img_root"], tree["matches_root"], img_num,
                                  quantized=quantized).load_pair(*args)
    want = ImagePairLoader(tree["img_root"], tree["matches_root"], img_num,
                           quantized=quantized).load_pair(*args)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["colors"].shape == (2, img_num, 240, 320, 3)
    expect = np.eye(4)
    expect[:3, :3] = np.linalg.inv(aug_rot)
    np.testing.assert_allclose(got["world2cam"][0, 0], expect, atol=1e-6)


def test_projection_consistency_under_augmentation(tree):
    """Projecting the augmented cloud with the composed w2c hits the pixels
    of the raw cloud under the identity."""
    from pcrcg_tpu.data.indoor import euler_zyx_matrix
    from pcrcg_tpu_torch.ops.projection import project_points

    aug_rot = euler_zyx_matrix(np.random.default_rng(5).random(3) * 2 * np.pi)
    out = timages.ImagePairLoader(tree["img_root"], tree["matches_root"], 1).load_pair(
        tree["root"], "test/scene1/cloud_bin_0.pth", "test/scene1/cloud_bin_1.pth",
        aug_rot, aug_src=True, augmented=True)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    src = tree["src"]
    mask = torch.ones(len(src), dtype=torch.bool)
    depth, intr = t(out["depths"][0, 0]), t(out["intrinsics"])
    pix_a, ok_a = project_points(t(src @ aug_rot.T), depth, t(out["world2cam"][0, 0]), intr,
                                 mask)
    pix_r, ok_r = project_points(t(src), depth, t(np.eye(4)), intr, mask)
    assert torch.equal(ok_a, ok_r) and int(ok_r.sum()) > 100
    assert torch.equal(pix_a[ok_a], pix_r[ok_r])
