"""Typed configuration with the reference's YAML key surface.

The port's own copy of ``pcrcg_tpu/config.py`` (field for field, so every
config and YAML file loads unchanged in both packages).  The comments below
describe the JAX package's TPU measurements.

The port reads the KPConv route from ``kpconv_impl``, ``kpconv_tiled`` and
``budgets.search_impl``, as the JAX package does
(``models/kpconv.py::conv_route``).

It ignores ``search_kernel``, ``tiled_feat_limbs``,
``search_recall_target`` and ``compute_dtype``: its search distances (K1)
run on every route (they carry no vmap constraint, the reason the JAX
package's mesh training turns its TPU kernel off), its kernels compute in
fp32 (no bf16 limbs or compute dtype), and its top-k is exact.

The reference flattens YAML sections {misc, model, overlap_attention_module,
loss, optimiser, dataset, demo} into one namespace (reference
lib/utils.py:46-65) with silently-colliding keys.  We keep the same YAML
surface (same key names, same sections accepted) but parse into a typed
dataclass and reject unknown keys, plus a new ``tpu`` section for the
static-shape budgets that replace the reference's ragged stacks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import yaml

# Architecture registry: per-dataset block-name lists (reference configs/models.py).
ARCHITECTURES: Dict[str, List[str]] = {
    "indoor": [
        "simple",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
        "nearest_upsample",
        "unary",
        "nearest_upsample",
        "unary",
        "nearest_upsample",
        "last_unary",
    ],
    "modelnet": [
        "simple",
        "resnetb",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
        "nearest_upsample",
        "unary",
        "unary",
        "nearest_upsample",
        "unary",
        "last_unary",
    ],
}
# KITTI shares the indoor topology (reference configs/models.py:22-39).
ARCHITECTURES["kitti"] = list(ARCHITECTURES["indoor"])


@dataclass(frozen=True)
class Budgets:
    """Static per-level shape budgets (per cloud) — TPU-native replacement for
    the reference's ragged stacks + calibrate_neighbors truncation
    (reference datasets/dataloader.py:402-434)."""

    # Max points per cloud at each pyramid level.
    points: Tuple[int, ...] = (26624, 9216, 2560, 768)
    # Neighbor caps per level (conv, pool and upsample searches share the cap,
    # matching reference dataloader.py:273,298,301 which pass the same limit).
    neighbors: Tuple[int, ...] = (40, 40, 40, 40)
    # Cap on ground-truth correspondence candidates per source point.
    corr_k: int = 16
    # Query chunk for the tiled radius search (memory/latency tradeoff).
    # On-chip A/B (perf_runs/session_r2b): 2048 benched 9.81/9.68 pairs/s
    # vs 1024's 9.435 same-session — fewer, larger search dispatches.
    query_chunk: int = 2048
    # Neighbor-search pruning: 'tiled' prunes support candidates to the
    # m_tiles Z-order tiles nearest each query chunk (ops/tiled_search.py);
    # 'dense' always scans every support.  'tiled' falls back to dense
    # whenever the cloud is too small to prune.
    search_impl: str = "tiled"
    search_tile: int = 128
    # Candidate-tile budget: both the tiled search's distance matmuls and
    # the candidate-DMA KPConv's one-hot materialization scale linearly in
    # m_tiles.  On-chip A/B (scripts/ab_m_tiles.py, assets pair, recall vs
    # the exact search): 24 -> 0.981/0.985/1.0/1.0 per level at 7.48
    # pairs/s; 16 -> 0.978/0.988 at 7.74; 12 -> 0.962/0.978/0.994/1.0 at
    # 8.49 pairs/s.  12 stays above the 0.95 recall floor validated by the
    # round-1 approx-top-k A/B and re-validated end-task by the accuracy-
    # evidence run at this setting (perf_runs/accuracy_evidence_m12.jsonl).
    # An int applies to every level; a per-level tuple lets the coarser
    # levels run leaner (their m=12 recall was already 0.994/1.0, and both
    # the search and the candidate-DMA conv cost scale in m).
    search_m_tiles: int | Tuple[int, ...] = 12
    # Exact per-row top-k inside the tiled search (affordable on the pruned
    # ~3k-candidate sets) instead of approx_min_k at recall 0.95.
    search_exact: bool = False
    # approx_min_k recall target for the within-candidates top-k.  The
    # round-5 HEAD trace showed ~28 of 40.5 ms pyramid device time in
    # approx_top_k sort machinery: at 0.95 the bucket reduction only
    # halves the 1536-wide candidate rows, so XLA still sorts [N, 768]
    # per search.  The reduction size is a discrete ladder: everything in
    # (0.9, 0.95] compiles identically; 0.9 steps the sorted width down
    # and cut e2e 112.4 -> 86.7 ms on the round-5 chip A/B
    # (perf_runs/session_r5b/ab_mtiles.log) at per-level neighbor recall
    # 0.9495/0.9626/0.9789/1.0 vs exact (0.95 gave 0.9598 at L0; 0.85/0.8
    # are worse on BOTH axes).  The binding accuracy gate is end-task:
    # the same-weights approx-vs-exact 32-pair eval
    # (tests/test_accuracy_evidence.py::
    # test_approx_search_stack_matches_exact_end_to_end, delta <= 2/32),
    # re-run under any default change.  Round-5 ladder (session_r5b):
    # 0.9 alone scored 0.65625 vs exact 0.75 (3/32, rejected) — but the
    # flip was the k=1 UPSAMPLE searches riding the same approx machinery
    # (at k=1 approx misses the true nearest on ~(1-recall) of rows);
    # with k=1 forced exact (ops/neighbors._smallest_k — an argmax, no
    # sort), 0.9 scores 0.7500 == exact, a 0/32 delta, while cutting e2e
    # 112.4 -> 86.7 ms.  Per-level tuple accepted like search_m_tiles.
    search_recall_target: float | Tuple[float, ...] = 0.9

    def recall_target_at(self, level: int) -> float:
        """approx top-k recall target for level ``level`` (clamped like
        m_tiles_at when the tuple is shorter than num_levels)."""
        rt = self.search_recall_target
        if isinstance(rt, (int, float)):
            return float(rt)
        return float(rt[min(level, len(rt) - 1)])
    # Candidate-DMA distance kernel for the tiled search on TPU
    # (ops/search_kernel.py): one Pallas dispatch for both clouds, zero
    # candidate row gathers.  Auto-disabled off-TPU and on the GSPMD-vmap
    # training path (scalar-prefetch grids don't vmap, like kpconv_tiled).
    search_kernel: bool = True

    @property
    def num_levels(self) -> int:
        return len(self.points)

    def m_tiles_at(self, level: int) -> int:
        """Candidate-tile budget for pyramid level ``level`` (clamped to the
        last entry when a per-level tuple is shorter than num_levels)."""
        m = self.search_m_tiles
        if isinstance(m, int):
            return m
        return m[min(level, len(m) - 1)]


@dataclass(frozen=True)
class Config:
    # --- misc (reference configs/train/indoor.yaml) ---
    exp_dir: str = "snapshot/indoor"
    mode: str = "train"
    verbose: bool = True
    verbose_freq: int = 100
    snapshot_freq: int = 1
    pretrain: str = ""

    # --- model ---
    dataset: str = "indoor"
    benchmark: str = "3DMatch"
    num_layers: int = 4
    in_points_dim: int = 3
    first_feats_dim: int = 256
    gnn_feats_dim: int = 512
    final_feats_dim: int = 32
    first_subsampling_dl: float = 0.025
    in_feats_dim: int = 1  # 129 with the 2D branch (128 image channels + 1)
    conv_radius: float = 2.5
    deform_radius: float = 5.0
    num_kernel_points: int = 15
    KP_extent: float = 2.0
    KP_influence: str = "linear"
    aggregation_mode: str = "sum"
    fixed_kernel_points: str = "center"
    use_batch_norm: bool = True
    batch_norm_momentum: float = 0.02
    deformable: bool = False
    modulated: bool = False
    image_feature: bool = False
    img_num: int = 2
    init_mode: str = "pri3d"
    # torch checkpoint paths for the 2D backbone (reference trainer.py:49-70)
    pri3d_pth_path: str = ""
    tdmatch_pth_path: str = ""
    image_net_pth_path: str = ""
    window_size: int = 5
    # Ship uint8 colors / uint16 mm depths to the device (ImageLift
    # converts on-chip) — ~4x smaller per-pair image payloads, important
    # on tunneled/remote runtimes where arg staging is on the step path.
    image_quantized: bool = False
    overlap_threshold: float = 0.5
    node_overlap: bool = False
    quaternion: bool = False

    # --- overlap_attention_module ---
    dgcnn_k: int = 10
    num_head: int = 4
    nets: Tuple[str, ...] = ("self", "cross", "self")

    # --- loss ---
    pos_margin: float = 0.1
    neg_margin: float = 1.4
    log_scale: float = 24.0
    pos_radius: float = 0.0375
    safe_radius: float = 0.1
    overlap_radius: float = 0.0375
    matchability_radius: float = 0.05
    w_circle_loss: float = 1.0
    w_overlap_loss: float = 1.0
    w_saliency_loss: float = 0.0
    max_points: int = 256

    # --- optimiser ---
    optimizer: str = "SGD"
    max_epoch: int = 150
    lr: float = 0.005
    weight_decay: float = 1e-6
    momentum: float = 0.98
    scheduler: str = "ExpLR"
    scheduler_gamma: float = 0.95
    scheduler_freq: int = 1
    iter_size: int = 1

    # --- dataset ---
    batch_size: int = 1
    num_workers: int = 4
    augment_noise: float = 0.005
    # KITTI augmentation (reference datasets/kitti.py:156-179)
    augment_shift_range: float = 2.0
    augment_scale_min: float = 0.8
    augment_scale_max: float = 1.2
    root: str = ""
    # ModelNet protocol (reference configs/test/modelnet.yaml:61-75 +
    # datasets/modelnet.py:15-57): RPMNet transform-chain parameters and the
    # half1/half2 category-split files (shipped in configs/modelnet/).
    train_categoryfile: str = ""
    val_categoryfile: str = ""
    test_categoryfile: str = ""
    noise_type: str = "crop"
    rot_mag: float = 45.0
    trans_mag: float = 0.5
    num_points: int = 1024
    partial: Optional[Tuple[float, float]] = None
    img_path: str = ""
    superglue_matches_path: str = ""
    train_info: str = ""
    val_info: str = ""

    # --- demo ---
    src_pcd: str = ""
    tgt_pcd: str = ""
    n_points: int = 1000

    # --- tpu (new) ---
    budgets: Budgets = field(default_factory=Budgets)
    # Pairs sharded over the mesh 'data' axis (Trainer builds the mesh,
    # replicates state and shards batches when > 1; batch_size must be a
    # multiple of it).
    data_parallel: int = 1
    compute_dtype: str = "float32"
    # 2D-backbone conv-stack dtype (params and BN statistics stay f32;
    # ResUNet returns f32 maps).  bfloat16 measured SLOWER on chip (5.00
    # vs 5.25 pairs/s, PERF.md): Mosaic already runs f32 convs as one
    # bf16 MXU pass, so explicit bf16 only adds conversions.
    image_compute_dtype: str = "float32"
    # 2D backbone topology (reference Res50UNet, lib/trainer.py:51-69 —
    # depth 50, 128-channel output; 18 selects the Res18UNet variant,
    # models/resnet.py:93-230).  Smaller settings exist for CI-scale
    # flagship coverage (the multi-chip dryrun runs depth 18 at 32
    # channels so the full color path compiles inside a CPU
    # time budget); in_feats_dim must equal backbone2d_channels + 1.
    backbone2d_depth: int = 50
    backbone2d_channels: int = 128
    # KPConv compute path: 'auto' (fused Pallas kernel on TPU, XLA elsewhere),
    # 'xla', 'reduce' (Pallas influence+reduce), 'fused' (Pallas
    # influence+reduce+matmul, ops/kpconv_fused.py).
    kpconv_impl: str = "auto"
    # Candidate-DMA KPConv kernel (ops/kpconv_tiled.py) on the fused TPU
    # path.  Pallas scalar-prefetch grids cannot be vmap-batched, so
    # mesh-sharded (GSPMD dp x model) training disables it and keeps the
    # merged-gather kernels; single-device runs keep it on.
    kpconv_tiled: bool = True
    # bf16 limbs for the FEATURE rows of the candidate-DMA kernel's one-hot
    # E matmul (coords always 3-limb ~f32-exact).  1 = single limb (~2^-9
    # relative — the same error grade as the Mosaic one-bf16-pass f32 W
    # contraction that follows) with ~40% fewer E-matmul MACs, the
    # forward's dominant cost; on-chip A/B (scripts/ab_feat_limbs.py,
    # session_r3b): 9.56 vs 8.27 pairs/s, descriptor cosine 0.99998 /
    # p1 0.99994 vs the 2-limb kernel.  2 = hi/lo (~2^-16, parity grade).
    tiled_feat_limbs: int = 1
    # What the Trainer does when a step's pyramid reports voxel-budget
    # overflow (stats['max_overflow'] > 0 — points silently dropped):
    # 'warn' logs each occurrence, 'error' raises, 'none' only keeps the
    # stat in the meters.  The C++ reference capped per-sample exactly
    # (grid_subsampling.cpp max_p); with static budgets an overflow means
    # the budgets need recalibration (scripts/calibrate_budgets.py).
    overflow_action: str = "warn"
    seed: int = 42
    # Explicit architecture block-name list (reference configs/models.py
    # lists, including *_deformable variants); None -> the per-dataset
    # registry.  YAML key: 'architecture'.
    architecture_list: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        # ``deformable: True`` swaps every resnetb encoder block for its
        # deformable variant (reference block names, models/blocks.py:
        # 410-418; the reference itself selects deformable per-block via
        # architecture names in configs/models.py — this key is this
        # rebuild's shorthand for "make them all deformable").  An explicit
        # ``architecture`` list wins.
        if self.deformable and self.architecture_list is None:
            arch = tuple(
                b.replace("resnetb", "resnetb_deformable")
                if b in ("resnetb", "resnetb_strided")
                else b
                for b in ARCHITECTURES[self.dataset]
            )
            object.__setattr__(self, "architecture_list", arch)
        if self.modulated and not any("deform" in b for b in self.architecture):
            raise ValueError(
                "modulated: True requires deformable blocks (set "
                "deformable: True or list *_deformable blocks in "
                "'architecture')"
            )

    @property
    def architecture(self) -> List[str]:
        if self.architecture_list is not None:
            return list(self.architecture_list)
        return ARCHITECTURES[self.dataset]

    def deform_level_flags(self) -> Tuple[Tuple[bool, ...], Tuple[bool, ...]]:
        """Per-level deformable search-radius flags, replicating the
        reference collation (datasets/dataloader.py:266-299): conv searches
        at level ℓ widen to r·deform_radius/conv_radius when any non-last
        block of the layer is deformable; the pool search widens when the
        strided block itself is.  Returns (conv_flags[num_levels],
        pool_flags[num_levels-1])."""
        conv_flags: List[bool] = []
        pool_flags: List[bool] = []
        layer_blocks: List[str] = []
        for block in self.architecture:
            if "upsample" in block or "global" in block:
                break
            if "strided" in block or "pool" in block:
                # conv check runs over the layer's NON-strided blocks minus
                # the last one — the reference's own [:-1] quirk.
                conv_flags.append(
                    any("deformable" in b for b in layer_blocks[:-1])
                )
                pool_flags.append("deformable" in block)
                layer_blocks = []
            else:
                layer_blocks.append(block)
        # Trailing non-strided blocks form the last level.
        conv_flags.append(any("deformable" in b for b in layer_blocks[:-1])
                          if layer_blocks else False)
        return tuple(conv_flags), tuple(pool_flags)

    def pretrain_2d_path(self) -> str:
        """2D-backbone checkpoint per init_mode (reference trainer.py:49-70)."""
        return {
            "pri3d": self.pri3d_pth_path,
            "3dmatch": self.tdmatch_pth_path,
            "image_net": self.image_net_pth_path,
        }.get(self.init_mode, "")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)}
# Reference keys that carry no meaning in the TPU rebuild (paths to torch
# checkpoints, gpu pinning, ...). Accepted and ignored for YAML compatibility.
_IGNORED_KEYS = {
    "gpu_mode",
    "num_gpus",
    "dir",
    "debug",
    # 'modelnet_hdf' is the only dataset_type the reference implements
    # (datasets/modelnet.py:29-35) — accepted, dispatch is by 'dataset'.
    "dataset_type",
}


def load_config(path: str) -> Config:
    """YAML → Config.  Accepts the reference's sectioned YAML files verbatim
    (sections are flattened, mirroring reference lib/utils.py:46-65) as well
    as flat dicts; unknown keys raise instead of silently merging."""
    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    flat: Dict[str, Any] = {}
    for key, value in raw.items():
        if isinstance(value, dict):
            flat.update(value)
        else:
            flat[key] = value
    return config_from_dict(flat)


def config_from_dict(flat: Dict[str, Any]) -> Config:
    kwargs: Dict[str, Any] = {}
    for key, value in flat.items():
        if key in _IGNORED_KEYS:
            continue
        if key == "nets":
            value = tuple(value)
        elif key == "partial" and value is not None:
            value = tuple(value)
        elif key == "architecture":
            key, value = "architecture_list", tuple(value)
        elif key == "budgets" and isinstance(value, dict):
            defaults = Budgets()
            value = Budgets(
                points=tuple(value.get("points", defaults.points)),
                neighbors=tuple(value.get("neighbors", defaults.neighbors)),
                corr_k=value.get("corr_k", defaults.corr_k),
                query_chunk=value.get("query_chunk", defaults.query_chunk),
                search_impl=value.get("search_impl", defaults.search_impl),
                search_tile=value.get("search_tile", defaults.search_tile),
                search_m_tiles=(
                    tuple(value["search_m_tiles"])
                    if isinstance(value.get("search_m_tiles"), (list, tuple))
                    else value.get("search_m_tiles", defaults.search_m_tiles)
                ),
                search_exact=value.get("search_exact", defaults.search_exact),
                search_kernel=value.get("search_kernel", defaults.search_kernel),
            )
        if key not in _FIELD_NAMES:
            raise KeyError(f"Unknown config key: {key!r}")
        kwargs[key] = value
    return Config(**kwargs)


def tiny_test_config(**overrides) -> Config:
    """A small config for unit tests: same topology, tiny budgets."""
    budgets = Budgets(points=(256, 192, 192, 96), neighbors=(16, 16, 16, 16), corr_k=8, query_chunk=64)
    cfg = Config(budgets=budgets, first_feats_dim=32, gnn_feats_dim=32, final_feats_dim=8)
    return cfg.replace(**overrides)
