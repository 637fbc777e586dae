"""Host-side image pipeline for the 2D color branch (counterpart of
``pcrcg_tpu/data/images.py``; numpy).  PIL is imported inside the two
decoders only, so nothing else needs it.

Capability parity with the image paths of reference datasets/indoor.py:
* per-fragment ``<cloud>.info.txt`` → (full_scene_id, seq_id, frame id1,
  frame id2) — the first/last frames the fragment was fused from
  (indoor.py:94-116);
* color PNGs nearest-resized to 240×320 in [0,1]; 16-bit depth PNGs
  nearest-resized to 120×160 in meters (/1000) (indoor.py:66-78);
* camera-intrinsics.txt (640×480) rescaled to the 160×120 projection grid
  (indoor.py:548-556, visualize.py:244-275);
* world2camera: fragment frame == camera frame of its FIRST image, so
  w2c₁ = inv(aug_rot) (augmented cloud) or I, and
  w2c₂ = pose₂⁻¹ · pose₁ · w2c₁ (indoor.py:569-597);
* SuperGlue dumps ``{scene}_{seq}_frame-XXXXXX_{...}_matches.npz`` with
  keypoints0/1, matches, match_confidence; confidence maps splat w-sized
  boxes at matched keypoints on a (160,120) [x,y] grid (indoor.py:505-547),
  stored here transposed to [h=120, w=160] ready for feature-map gating.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from pcrcg_tpu_torch.ops.projection import adjust_intrinsic

COLOR_SIZE = (240, 320)  # (h, w)
DEPTH_SIZE = (120, 160)
INTRINSIC_IMAGE_DIM = (640, 480)  # (w, h)
PROJECTION_DIM = (160, 120)


def load_color(path: str, quantized: bool = False) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    img = img.resize((COLOR_SIZE[1], COLOR_SIZE[0]), Image.NEAREST)
    if quantized:
        # Native 8-bit: ImageLift divides by 255 on the device (exactly),
        # and the host -> device payload shrinks 4x.
        return np.asarray(img, np.uint8)  # [h,w,3]
    return np.asarray(img, np.float32) / 255.0  # [h,w,3] in [0,1]


def load_depth(path: str, quantized: bool = False) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    img = img.resize((DEPTH_SIZE[1], DEPTH_SIZE[0]), Image.NEAREST)
    if quantized:
        # Native millimeter uint16 (reference indoor.py divides by 1000);
        # ImageLift converts to meters on the device, bit-exact.
        return np.asarray(img, np.uint16)
    return np.asarray(img, np.float32) / 1000.0  # meters


def fragment_frame_ids(base_dir: str, fragment_rel_path: str):
    """'<phase>/<scene>/<cloud>.pth' -> (full_scene_id, seq_id, id1, id2)
    from the sibling .info.txt (reference indoor.py:94-116)."""
    phase, scene_id, cloud = fragment_rel_path.split("/")
    info_path = os.path.join(base_dir, phase, scene_id, cloud[:-4] + ".info.txt")
    with open(info_path) as f:
        full_scene_id, seq_id, id1, id2 = f.readline().split()
    return full_scene_id, seq_id, id1, id2


def frame_paths(img_root: str, scene: str, seq: str, frame_id: str):
    stem = os.path.join(img_root, scene, seq, "frame-" + frame_id.zfill(6))
    return stem + ".color.png", stem + ".depth.png", stem + ".pose.txt"


def match_npz_path(matches_root: str, scene0, seq0, id0, scene1, seq1, id1) -> str:
    stem0 = f"{scene0}_{seq0}_frame-{id0.zfill(6)}"
    stem1 = f"{scene1}_{seq1}_frame-{id1.zfill(6)}"
    return os.path.join(matches_root, f"{stem0}_{stem1}_matches.npz")


def splat_valid_maps(npz, window_size: int):
    """SuperGlue npz -> (map0, map1), each [120,160] float32 (transposed
    from the reference's (160,120) [x,y] layout for direct fmap gating)."""
    grid_w, grid_h = PROJECTION_DIM
    map0 = np.zeros((grid_w, grid_h), np.float32)
    map1 = np.zeros((grid_w, grid_h), np.float32)
    matches = npz["matches"]
    valid = matches > -1
    k0 = npz["keypoints0"][valid]
    k1 = npz["keypoints1"][matches[valid]]
    conf = npz["match_confidence"][valid]
    w = window_size
    for (x0, y0), (x1, y1), c in zip(k0, k1, conf):
        map0[max(int(x0) - w, 0) : int(x0) + w, max(int(y0) - w, 0) : int(y0) + w] = c
        map1[max(int(x1) - w, 0) : int(x1) + w, max(int(y1) - w, 0) : int(y1) + w] = c
    return map0.T.copy(), map1.T.copy()


def projection_intrinsics(img_root: str, scene: str) -> np.ndarray:
    intr = np.loadtxt(os.path.join(img_root, scene, "camera-intrinsics.txt"))
    intr = adjust_intrinsic(intr, INTRINSIC_IMAGE_DIM, PROJECTION_DIM)
    if intr.shape[0] == 3:
        out = np.eye(4)
        out[:3, :3] = intr
        intr = out
    return intr.astype(np.float32)


class ImagePairLoader:
    """Loads the per-pair image stacks consumed by ``models/lift.py::ImageLift``."""

    def __init__(self, img_root: str, matches_root: str, img_num: int = 2,
                 window_size: int = 5, quantized: bool = False):
        assert img_num in (1, 2, 3)
        self.img_root = img_root
        self.matches_root = matches_root
        self.img_num = img_num
        self.window_size = window_size
        # quantized: uint8 colors / uint16 mm depths (ImageLift converts
        # on the device), 4x smaller host -> device payloads.
        self.quantized = quantized

    def frame_ids(self, ids) -> list:
        """Select img_num frame ids out of (id1, id2) — 1: first; 2: both;
        3: first, middle, last (the reference's img_num=3 adds the midpoint
        frame, indoor.py:193-206)."""
        _, _, id1, id2 = ids
        if self.img_num == 1:
            return [id1]
        if self.img_num == 2:
            return [id1, id2]
        mid = str((int(id1) + int(id2)) // 2)
        return [id1, mid, id2]

    def load_cloud_stack(self, ids, aug_rot: np.ndarray, augment_this_cloud: bool) -> Dict:
        scene, seq, *_ = ids
        frames = self.frame_ids(ids)
        colors, depths, poses = [], [], []
        for fid in frames:
            cpath, dpath, ppath = frame_paths(self.img_root, scene, seq, fid)
            colors.append(load_color(cpath, self.quantized))
            depths.append(load_depth(dpath, self.quantized))
            poses.append(np.loadtxt(ppath).astype(np.float64))
        w2c1 = np.eye(4)
        if augment_this_cloud:
            w2c1[:3, :3] = np.linalg.inv(aug_rot)
        world2cam = [w2c1]
        for pose in poses[1:]:
            world2cam.append(np.linalg.inv(pose) @ poses[0] @ w2c1)
        return {
            "colors": np.stack(colors),  # [I,240,320,3]
            "depths": np.stack(depths),  # [I,120,160]
            "world2cam": np.stack(world2cam).astype(np.float32),  # [I,4,4]
            "frames": frames,
            "scene": scene,
            "seq": seq,
        }

    def load_valid_maps(self, src_ids, tgt_ids, src_frames, tgt_frames):
        """Per image index i, the (src, tgt) confidence maps from the
        SuperGlue dump of (src frame i, tgt frame i)."""
        src_maps, tgt_maps = [], []
        for sf, tf in zip(src_frames, tgt_frames):
            path = match_npz_path(
                self.matches_root, src_ids[0], src_ids[1], sf, tgt_ids[0], tgt_ids[1], tf
            )
            npz = np.load(path)
            m0, m1 = splat_valid_maps(npz, self.window_size)
            src_maps.append(m0)
            tgt_maps.append(m1)
        return np.stack(src_maps), np.stack(tgt_maps)  # [I,120,160] each

    def load_pair(self, base_dir, src_rel, tgt_rel, aug_rot, aug_src: bool, augmented: bool):
        src_ids = fragment_frame_ids(base_dir, src_rel)
        tgt_ids = fragment_frame_ids(base_dir, tgt_rel)
        src_stack = self.load_cloud_stack(src_ids, aug_rot, augmented and aug_src)
        tgt_stack = self.load_cloud_stack(tgt_ids, aug_rot, augmented and not aug_src)
        src_maps, tgt_maps = self.load_valid_maps(
            src_ids, tgt_ids, src_stack["frames"], tgt_stack["frames"]
        )
        intrinsics = projection_intrinsics(self.img_root, src_ids[0])
        return {
            "colors": np.stack([src_stack["colors"], tgt_stack["colors"]]),
            "depths": np.stack([src_stack["depths"], tgt_stack["depths"]]),
            "world2cam": np.stack([src_stack["world2cam"], tgt_stack["world2cam"]]),
            "valid_maps": np.stack([src_maps, tgt_maps]),
            "intrinsics": intrinsics,
        }
