"""KPFCNN: KPConv encoder–decoder with the overlap-attention bottleneck.

Counterpart of ``pcrcg_tpu/models/kpfcnn.py`` (reference
models/architectures.py:35-610): joint encoder over the (src, tgt) cloud
axis, bottleneck projection + GCN, cross-cloud saliency by temperature
softmax, nearest-upsample decoder fed [overlap score, saliency, gnn
feats], L2-normalized descriptors and sigmoid scores with the NaN scrub.

Each KPConv's route comes from the config, as in the JAX package, and is
picked by ``models/kpconv.py::conv_route`` (the table is in ``KPConv``'s
docstring); ``*_deformable`` blocks (``deformable: True``, with
``modulated``) run the deformable KPConv.  Each level's rel is computed
once, without gradient, for the convs whose route reads it.

On the cloud ('model') mesh axis (``forward(..., cloud=)``,
``parallel/cloud.py``) a rank holds one cloud: the pyramid and
``features`` are its own (B = 1), the norms sum their statistics with the
other rank, the bottleneck runs on both clouds from gathered features, the
decoder on its own cloud, and the outputs come back gathered: the same
[2, ...] outputs as in one process.

Parameter names follow the reference torch key layout (the one
``pcrcg_tpu/models/torch_import.py::_kpfcnn_key_map`` reads) on every
route, so ``models/weights.py::state_dict_from_jax`` output loads with
``strict=True``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from pcrcg_tpu_torch import resolve_device
from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.models.blocks import (
    LastUnaryBlock,
    ResnetBottleneckBlock,
    SimpleBlock,
    UnaryBlock,
    Upsample,
    init_dense,
)
from pcrcg_tpu_torch.models.gcn import GCN, Conv1x1
from pcrcg_tpu_torch.models.kpconv import KPConv
from pcrcg_tpu_torch.ops.masked import PAD_COORD, masked_softmax, pad_gather
from pcrcg_tpu_torch.ops.pyramid import Pyramid
from pcrcg_tpu_torch.parallel.cloud import CloudAxis
from pcrcg_tpu_torch.utils.profiling import span, stage


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    kind: str  # 'simple' | 'resnetb' | 'unary' | 'last_unary' | 'upsample'
    in_dim: int
    out_dim: int
    layer: int  # pyramid level of the block's supports
    radius: float
    strided: bool
    kp_seed: int
    deformable: bool = False


@dataclasses.dataclass(frozen=True)
class ArchitecturePlan:
    encoder: Tuple[BlockPlan, ...]
    decoder: Tuple[BlockPlan, ...]
    encoder_skips: Tuple[int, ...]  # encoder block indices whose INPUT is saved
    decoder_concats: Tuple[int, ...]  # decoder block indices that pop a skip
    bottleneck_dim: int


def plan_architecture(config: Config) -> ArchitecturePlan:
    """Static replication of the reference's constructor bookkeeping
    (architectures.py:62-151)."""
    r = config.first_subsampling_dl * config.conv_radius
    in_dim = config.in_feats_dim
    out_dim = config.first_feats_dim
    layer = 0
    kp_seed = 0

    encoder: List[BlockPlan] = []
    encoder_skips: List[int] = []
    skip_dims: List[int] = []
    arch = config.architecture
    start_i = 0
    for block_i, block in enumerate(arch):
        if any(t in block for t in ("pool", "strided", "upsample", "global")):
            encoder_skips.append(block_i)
            skip_dims.append(in_dim)
        if "upsample" in block:
            start_i = block_i
            break
        strided = "strided" in block
        kind = "simple" if "simple" in block else "resnetb"
        encoder.append(
            BlockPlan(kind, in_dim, out_dim, layer, r, strided, kp_seed,
                      deformable="deform" in block)
        )
        kp_seed += 1
        in_dim = out_dim // 2 if "simple" in block else out_dim
        if strided or "pool" in block:
            layer += 1
            r *= 2
            out_dim *= 2

    bottleneck_dim = in_dim
    decoder: List[BlockPlan] = []
    decoder_concats: List[int] = []
    out_dim = config.gnn_feats_dim + 2
    in_dim = out_dim
    for block_i, block in enumerate(arch[start_i:]):
        if block_i > 0 and "upsample" in arch[start_i + block_i - 1]:
            in_dim += skip_dims[layer]
            decoder_concats.append(block_i)
        if block == "unary":
            decoder.append(BlockPlan("unary", in_dim, out_dim, layer, r, False, 0))
        elif block == "last_unary":
            decoder.append(
                BlockPlan("last_unary", in_dim, config.final_feats_dim + 2, layer, r, False, 0)
            )
        elif "upsample" in block:
            decoder.append(BlockPlan("upsample", in_dim, out_dim, layer, r, False, 0))
        else:
            raise ValueError(f"Unsupported decoder block: {block}")
        in_dim = out_dim
        if "upsample" in block:
            layer -= 1
            r *= 0.5
            out_dim = out_dim // 2

    return ArchitecturePlan(
        tuple(encoder), tuple(decoder), tuple(encoder_skips), tuple(decoder_concats), bottleneck_dim
    )


def masked_l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-24) -> torch.Tensor:
    """x / |x| with all-zero (pad) rows mapped to zero."""
    return x * torch.rsqrt((x * x).sum(dim, keepdim=True) + eps)


class KPFCNN(nn.Module):
    """Forward over one pair: ``pyramid`` (ops/pyramid.py) and ``features``
    [2, N0, in_feats_dim] -> dict with feats_f [2, N0, final_feats_dim]
    (L2-normalized), scores_overlap [2, N0], scores_saliency [2, N0] (and the
    node-overlap / quaternion heads when configured).  With ``cloud`` the
    pyramid and features are this rank's cloud alone [1, ...], and the
    outputs are the same both clouds' [2, ...]."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.plan = plan_architecture(cfg)
        config_kp = dict(
            num_kernel_points=cfg.num_kernel_points,
            influence=cfg.KP_influence,
            aggregation=cfg.aggregation_mode,
            fixed=cfg.fixed_kernel_points,
            tile=cfg.budgets.search_tile,
            impl=cfg.kpconv_impl,
            tiled=cfg.kpconv_tiled,
        )
        extent_ratio = cfg.KP_extent / cfg.conv_radius
        enc = []
        for block_i, bp in enumerate(self.plan.encoder):
            common = dict(radius=bp.radius, kp_extent=bp.radius * extent_ratio,
                          config_kp=config_kp, kp_seed=bp.kp_seed, deformable=bp.deformable,
                          modulated=cfg.modulated)
            if bp.kind == "simple":
                # Block 0 over the ones-column input reads validity bits.
                ones = block_i == 0 and cfg.in_feats_dim == 1 and not cfg.image_feature
                enc.append(SimpleBlock(bp.in_dim, bp.out_dim, ones_features=ones, **common))
            else:
                enc.append(ResnetBottleneckBlock(bp.in_dim, bp.out_dim,
                                                 strided=bp.strided, **common))
            enc[-1].KPConv.level = bp.layer + int(bp.strided)
        self.encoder_blocks = nn.ModuleList(enc)

        gnn_dim = cfg.gnn_feats_dim
        self.bottle = Conv1x1(self.plan.bottleneck_dim, gnn_dim)
        self.gnn = GCN(cfg.num_head, gnn_dim, cfg.dgcnn_k, cfg.nets, cfg.budgets.query_chunk)
        self.proj_gnn = Conv1x1(gnn_dim, gnn_dim)
        self.proj_score = Conv1x1(gnn_dim, 1)
        self.epsilon = nn.Parameter(torch.tensor(-5.0))

        dec = []
        for bp in self.plan.decoder:
            if bp.kind == "upsample":
                dec.append(Upsample())
            elif bp.kind == "unary":
                dec.append(UnaryBlock(bp.in_dim, bp.out_dim))
            else:
                dec.append(LastUnaryBlock(bp.in_dim, bp.out_dim))
        self.decoder_blocks = nn.ModuleList(dec)

        if cfg.node_overlap:
            self.node_overlap_predict = Conv1x1(gnn_dim, 1)
        if cfg.quaternion:
            widths = (cfg.final_feats_dim, 64, 128, 256, 512, 1024)
            layers = []
            for i in range(5):
                layers += [nn.Linear(widths[i], widths[i + 1]), nn.ReLU()]
            self.folding1 = nn.Sequential(*layers)
            self.linear1 = nn.Linear(1024, 4)
            self.linear2 = nn.Linear(1024, 3)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights: KPConv kaiming-uniform, every linear / 1x1
        conv torch's default U(±1/√fan_in) with zero bias, epsilon −5."""
        for m in self.modules():
            if isinstance(m, KPConv):
                m.reset_parameters(generator)
            elif isinstance(m, (nn.Linear, Conv1x1)):
                init_dense(m, generator)
        with torch.no_grad():
            self.epsilon.fill_(-5.0)

    def _shared_rel(self, pyramid: Pyramid, tiled_pyramid: bool):
        """The per-level rel [B, Nq, H, 3] (neighbor minus query, shadows at
        PAD_COORD), without gradient, as pcrcg_tpu/models/kpfcnn.py:191-208:
        conv_rel for the non-strided convs of a level where the level's
        first one reads it, pool_rel for the strided ones that read it
        (``ConvRoute.shared_rel``)."""

        def rel_coords(q_pts, s_pts, neighb):
            return torch.stack([pad_gather(s_pts[b], neighb[b], PAD_COORD) - q_pts[b][:, None]
                                for b in range(q_pts.shape[0])])

        conv_rel, pool_rel = {}, {}
        with torch.no_grad():
            for bp, block in zip(self.plan.encoder, self.encoder_blocks):
                lvl = bp.layer
                reads = block.KPConv.route(bp.strided, tiled_pyramid).shared_rel
                if bp.strided and reads and lvl not in pool_rel:
                    pool_rel[lvl] = rel_coords(pyramid.points[lvl + 1], pyramid.points[lvl],
                                               pyramid.pools[lvl])
                if not bp.strided and lvl not in conv_rel:
                    conv_rel[lvl] = rel_coords(
                        pyramid.points[lvl], pyramid.points[lvl], pyramid.neighbors[lvl]
                    ) if reads else None
        return conv_rel, pool_rel

    def encode(self, pyramid: Pyramid, features: torch.Tensor, psum=None):
        """The joint encoder over the pyramid's clouds (with ``psum``, the
        cloud axis's: this rank's cloud, its norms summed over the axis) ->
        (bottleneck features [B, Nc, C], the decoder's skips).  A block gets
        its level's lists, shared rel and tile metadata (if any)."""
        plan = self.plan
        tiled_pyramid = bool(pyramid.conv_local)
        conv_rel, pool_rel = self._shared_rel(pyramid, tiled_pyramid)
        x = features
        skip_x = []
        for block_i, (bp, block) in enumerate(zip(plan.encoder, self.encoder_blocks)):
            if block_i in plan.encoder_skips:
                skip_x.append(x)
            lvl = bp.layer
            if bp.strided:
                q_pts, q_mask = pyramid.points[lvl + 1], pyramid.masks[lvl + 1]
                neighb, rel = pyramid.pools[lvl], pool_rel.get(lvl)
                tmeta = pyramid.pool_local[lvl] if tiled_pyramid else None
            else:
                q_pts, q_mask = pyramid.points[lvl], pyramid.masks[lvl]
                neighb, rel = pyramid.neighbors[lvl], conv_rel.get(lvl)
                tmeta = pyramid.conv_local[lvl] if tiled_pyramid else None
            x = block(x, q_pts, pyramid.points[lvl], neighb, q_mask, pyramid.masks[lvl],
                      rel, tmeta, psum=psum)
        return x, skip_x

    def forward(self, pyramid: Pyramid, features: torch.Tensor,
                cloud: Optional[CloudAxis] = None):
        """Traced as the stage ``kpfcnn``, its parts ``kpfcnn.encoder``,
        ``kpfcnn.gcn`` (bottleneck, GNN, saliency) and ``kpfcnn.decoder``
        (with the heads)."""
        psum = None if cloud is None else cloud.psum
        with stage("kpfcnn"):
            # 1. joint encoder
            with span("kpfcnn.encoder"):
                x, skip_x = self.encode(pyramid, features, psum)
            with span("kpfcnn.gcn"):
                x, feats_c = self._bottleneck(pyramid, x, cloud)
            with span("kpfcnn.decoder"):
                return self._decode(pyramid, x, feats_c, skip_x, cloud)

    def _bottleneck(self, pyramid: Pyramid, x: torch.Tensor, cloud: Optional[CloudAxis]):
        """Steps 2-3: the bottleneck features -> (the decoder's input, the
        GNN features)."""
        # 2. bottleneck projection + GNN between the clouds
        mask_c = pyramid.masks[-1]
        pts_c = pyramid.points[-1]
        feats_c = self.bottle(x)
        if cloud is not None:  # every rank of the axis runs it on both clouds
            mask_c, pts_c = cloud.gather(mask_c), cloud.gather(pts_c)
            feats_c = cloud.gather(feats_c)
        src_c, tgt_c = self.gnn(pts_c[0], pts_c[1], feats_c[0], feats_c[1],
                                mask_c[0], mask_c[1])
        feats_c = self.proj_gnn(torch.stack([src_c, tgt_c]))
        scores_c_raw = self.proj_score(feats_c)  # [2, Nc, 1]
        feats_gnn_norm = masked_l2_normalize(feats_c)

        # 3. cross-cloud saliency via temperature softmax (reference :557-564)
        temperature = torch.exp(self.epsilon) + 0.03
        inner = feats_gnn_norm[0] @ feats_gnn_norm[1].T  # [Ns, Nt]
        s1 = masked_softmax(inner / temperature, mask_c[1][None, :], dim=1) @ scores_c_raw[1]
        s2 = masked_softmax(inner.T / temperature, mask_c[0][None, :], dim=1) @ scores_c_raw[0]
        scores_saliency_c = torch.stack([s1, s2])

        return torch.cat([scores_c_raw, scores_saliency_c, feats_c], dim=-1), feats_c

    def _decode(self, pyramid: Pyramid, x: torch.Tensor, feats_c: torch.Tensor, skip_x,
                cloud: Optional[CloudAxis]):
        """Step 4 and the heads: the outputs."""
        cfg = self.cfg
        plan = self.plan
        psum = None if cloud is None else cloud.psum
        # 4. decoder over [raw score, saliency, gnn feats] (reference :565)
        if cloud is not None:  # the decoder runs on this rank's cloud
            x = cloud.own(x)
        for block_i, (bp, block) in enumerate(zip(plan.decoder, self.decoder_blocks)):
            if block_i in plan.decoder_concats:
                x = torch.cat([x, skip_x.pop()], dim=-1)
            if bp.kind == "upsample":
                x = block(x, pyramid.upsamples[bp.layer - 1])
            else:
                x = block(x, pyramid.masks[bp.layer], psum)
        mask_0 = pyramid.masks[0]
        if cloud is not None:
            x, mask_0 = cloud.gather(x), cloud.gather(mask_0)

        d = cfg.final_feats_dim
        scrub = lambda s: torch.nan_to_num(s, nan=0.0, posinf=0.0, neginf=0.0)  # noqa: E731
        res = {
            "feats_f": masked_l2_normalize(x[..., :d]),
            "scores_overlap": scrub(torch.sigmoid(x[..., d]).clamp(0.0, 1.0)),
            "scores_saliency": scrub(torch.sigmoid(x[..., d + 1]).clamp(0.0, 1.0)),
        }
        if cfg.node_overlap:
            node = self.node_overlap_predict(feats_c)[..., 0]
            res["node_overlap_score_pred"] = torch.sigmoid(node).clamp(0.0, 1.0)
        if cfg.quaternion:
            t = self.folding1(res["feats_f"])
            quat = masked_l2_normalize(self.linear1(t))
            trans = self.linear2(t)
            w = torch.cat([mask_0[0], mask_0[1]]).to(quat.dtype)[:, None]
            denom = w.sum().clamp_min(1.0)
            res["quaternion_pred"] = (quat.reshape(-1, 4) * w).sum(0) / denom
            res["trans_pred"] = (trans.reshape(-1, 3) * w).sum(0) / denom
        return res


def init_kpfcnn(cfg: Config, seed: int = 0, device=None) -> KPFCNN:
    """A KPFCNN with seeded random weights (drawn on the CPU, so every
    device gets the same ones) on ``device``: CUDA unless the caller names
    the CPU.  In eval mode."""
    model = KPFCNN(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device)).eval()
