"""2D backbone: ResNet-50/18 encoder + UNet decoder (counterpart of
``pcrcg_tpu/models/resunet.py``; reference models/resnet.py:93-230 and
models/resunet.py:12-215).

Input ``[..., H, W, 3]`` RGB in [0, 1] (the reference feeds it without
ImageNet normalization), output ``[..., H/2, W/2, output_channel]`` fp32,
the JAX package's NHWC boundary; NCHW inside.  Parameter and buffer names
follow the reference torch key layout (``conv1``, ``bn1``,
``layer{i}.{j}.conv{k}`` / ``bn{k}``, ``layer{i}.{j}.downsample.{0,1}``,
``decoder.up{i}.{conv1,bn1,conv1_2,bn1_2,conv2,bn2}``, ``decoder.conv0``),
so a reference ``.pth`` loads by name (``models/weights.py``).

The convolutions and the resize's products run in IEEE fp32 on the card
(cuDNN and cuBLAS would take TF32 by default), scoped to this module's
forward; ``dtype=torch.bfloat16`` runs them in bf16 with fp32 BN
statistics and an fp32 output, as the JAX package's ``dtype`` does.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

# Standard ImageNet statistics, for checkpoints that expect normalized
# inputs (the reference's default path feeds raw 0..1 RGB).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@contextlib.contextmanager
def ieee_fp32():
    """cuDNN convolutions and cuBLAS products without TF32 inside the block;
    the process's settings are restored after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class Conv(nn.Conv2d):
    """Conv with torch-style symmetric padding (k//2 each side), computed
    in ``dtype`` (None: the input's)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, k, stride, padding=k // 2, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding)


class TrainModeBN(nn.Module):
    """BatchNorm as the reference runs it: backbone2d never leaves torch
    train mode and sees one image per call (reference
    architectures.py:278-281), so each image is normalized by its own
    per-channel (H, W) statistics, biased variance, eps 1e-5, and the
    stored running statistics are never read or updated.  They stay as
    buffers so that checkpoints load; ``running=True`` normalizes with them
    instead (classic inference-mode BN).  ``nn.BatchNorm2d`` would pool the
    statistics of every image of a call (train mode) or read the buffers
    (eval mode).  Statistics in fp32; the output in the input's dtype."""

    def __init__(self, c: int, running: bool = False, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.running = running
        self.eps = eps

    def forward(self, x):  # [B, C, H, W]
        xf = x.float()
        if self.running:
            mean, var = self.running_mean[:, None, None], self.running_var[:, None, None]
        else:
            mean = xf.mean((-2, -1), keepdim=True)
            var = (xf - mean).square().mean((-2, -1), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def align_corners_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """[n_out, n_in] linear-interpolation matrix with align_corners=True
    (out[i] samples the input at i·(n_in−1)/(n_out−1))."""
    if n_in == 1:
        return torch.ones(n_out, 1)
    pos = np.arange(n_out) * (n_in - 1) / max(n_out - 1, 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = pos - lo
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo] += 1.0 - frac
    m[np.arange(n_out), hi] += frac
    return torch.from_numpy(m)


@functools.lru_cache(maxsize=None)
def _device_matrix(n_in: int, n_out: int, device: torch.device, dtype) -> torch.Tensor:
    """``align_corners_matrix`` on ``device``, copied there once: a copy from
    host memory blocks the host until the device has caught up."""
    return align_corners_matrix(n_in, n_out).to(device, dtype)


def bilinear_resize(x: torch.Tensor, size) -> torch.Tensor:
    """x [..., H, W] -> [..., h, w], align_corners=True, as two separable
    interpolation products (over H, then over W) in the JAX package's
    order; ``F.interpolate`` computes the same function rounded otherwise."""
    h, w = size
    mh = _device_matrix(x.shape[-2], h, x.device, x.dtype)  # [h, H]
    mw = _device_matrix(x.shape[-1], w, x.device, x.dtype)  # [w, W]
    return (mh @ x) @ mw.T


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool, running: bool,
                 dtype):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, dtype=dtype)
        self.bn1 = TrainModeBN(planes, running)
        self.conv2 = Conv(planes, planes, 3, dtype=dtype)
        self.bn2 = TrainModeBN(planes, running)
        self.downsample = (nn.Sequential(Conv(cin, planes, 1, stride, dtype=dtype),
                                         TrainModeBN(planes, running)) if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (the stride) → 1×1 ×4."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool, running: bool,
                 dtype):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv(cin, planes, 1, dtype=dtype)
        self.bn1 = TrainModeBN(planes, running)
        self.conv2 = Conv(planes, planes, 3, stride, dtype=dtype)
        self.bn2 = TrainModeBN(planes, running)
        self.conv3 = Conv(planes, out, 1, dtype=dtype)
        self.bn3 = TrainModeBN(out, running)
        self.downsample = (nn.Sequential(Conv(cin, out, 1, stride, dtype=dtype),
                                         TrainModeBN(out, running)) if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class UpProjection(nn.Module):
    """Bilinear resize, then two conv branches added (reference
    resunet.py:42-67)."""

    def __init__(self, cin: int, cout: int, running: bool, dtype):
        super().__init__()
        self.conv1 = Conv(cin, cout, 5, dtype=dtype)
        self.bn1 = TrainModeBN(cout, running)
        self.conv1_2 = Conv(cout, cout, 3, dtype=dtype)
        self.bn1_2 = TrainModeBN(cout, running)
        self.conv2 = Conv(cin, cout, 5, dtype=dtype)
        self.bn2 = TrainModeBN(cout, running)

    def forward(self, x, size):
        x = bilinear_resize(x, size)
        b1 = F.relu(self.bn1(self.conv1(x)))
        b1 = self.bn1_2(self.conv1_2(b1))
        b2 = self.bn2(self.conv2(x))
        return F.relu(b1 + b2)


class Decoder(nn.Module):
    """The decoder's modules under the reference keys (``decoder.up{i}``,
    ``decoder.conv0``); ``ResUNet.forward`` runs them with the skips."""

    def __init__(self, top: int, output_channel: int, running: bool, dtype):
        super().__init__()
        self.up1 = UpProjection(top, top // 2, running, dtype)
        self.up2 = UpProjection(top // 2, top // 4, running, dtype)
        self.up3 = UpProjection(top // 4, top // 8, running, dtype)
        self.up4 = UpProjection(top // 8, top // 16, running, dtype)
        self.conv0 = Conv(top // 16, output_channel, 1, bias=True, dtype=dtype)


class ResUNet(nn.Module):
    """Res50UNet / Res18UNet (reference resunet.py:69-217): conv 7×7/2,
    max-pool /2, four ResNet stages, four UpProjections with skip
    additions, a 1×1 head.  ``bn_running_average`` selects inference-mode
    BN; ``dtype`` (None or torch.bfloat16) is the convolutions' dtype."""

    def __init__(self, output_channel: int = 128, depth: int = 50,
                 bn_running_average: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if depth == 50:
            layers: Sequence[int] = (3, 4, 6, 3)
            block = Bottleneck
        elif depth == 18:
            layers, block = (2, 2, 2, 2), BasicBlock
        else:
            raise ValueError(f"Unsupported ResNet depth: {depth}")
        running = bn_running_average
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, 2, dtype=dtype)
        self.bn1 = TrainModeBN(64, running)
        cin = 64
        for stage, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or cin != planes * block.expansion)
                blocks.append(block(cin, planes, s, ds, running, dtype))
                cin = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.decoder = Decoder(cin, output_channel, running, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights: He-normal convolutions (fan in, as the JAX
        package's ``he_normal``, untruncated), BN scale 1 and bias 0,
        running statistics 0 / 1, the head's bias 0."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, TrainModeBN):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
        dt = self.dtype or x.dtype
        x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2).to(dt)
        with ieee_fp32():
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.max_pool2d(x, 3, 2, padding=1)
            skips = []
            for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
                x = stage(x)
                skips.append(x)
            b1, b2, b3, b4 = skips
            dec = self.decoder
            d = dec.up1(b4, b3.shape[-2:]) + b3
            d = dec.up2(d, b2.shape[-2:]) + b2
            d = dec.up3(d, b1.shape[-2:]) + b1
            d = dec.up4(d, (b1.shape[-2] * 2, b1.shape[-1] * 2))
            d = dec.conv0(d)
        return d.float().permute(0, 2, 3, 1).reshape(*lead, *d.shape[-2:], d.shape[1])
