"""Inference-time BatchNorm folding for the ResNet encoder, the counterpart
of ``scenedepthestimation_tpu/models/folded.py``.

At inference BN is an affine map with frozen statistics,

    bn(y) = y * s + (beta - mu * s),   s = gamma / sqrt(var + eps),

so every conv -> bn pair folds into one conv with kernel * s and bias
beta - mu * s. :func:`fold_encoder_bn` folds in fp32, whatever the compute
dtype; :class:`FoldedEncoder` runs the folded convs (``F.conv2d`` with
bias, cuDNN on the card, channels-last in the predictor) and returns the
same five NHWC features as ``models/resnet.ResNetEncoder``. The predictor
folds when ``cfg.mono.fold_bn`` is set, before it casts the model to the
compute dtype, as the JAX program folds at build time.

Each BasicBlock's stride-1 "conv + bias (+ residual) + ReLU" goes through
the module-level :func:`conv3x3_bias_relu`, the contract of the Winograd
kernel (``ops/winograd.py``); nothing routes it there by default, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from scenedepthestimation_tpu_torch.models.resnet import (
    BN_EPS,
    BOTTLENECK_DEPTHS,
    RESNET_SPECS,
    ResNetEncoder,
)

Folded = Dict[str, torch.Tensor]


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> Folded:
    scale = bn.weight.detach().float() / torch.sqrt(bn.running_var.float() + BN_EPS)
    return {
        "weight": conv.weight.detach().float() * scale[:, None, None, None],
        "bias": bn.bias.detach().float() - bn.running_mean.float() * scale,
    }


def fold_encoder_bn(encoder: ResNetEncoder) -> dict:
    """The encoder's conv -> BN pairs folded in fp32: ``{"conv1": {weight,
    bias}, "layer{s}_{b}": {"conv1", "conv2"[, "conv3"][, "downsample"]}}``,
    the JAX package's tree with PyTorch's (Co, C, kh, kw) kernels."""
    folded = {"conv1": _fold(encoder.conv1, encoder.bn1)}
    for s, n_blocks in enumerate(RESNET_SPECS[encoder.num_layers]):
        for b in range(n_blocks):
            blk = getattr(encoder, f"layer{s + 1}")[b]
            out = {"conv1": _fold(blk.conv1, blk.bn1), "conv2": _fold(blk.conv2, blk.bn2)}
            if hasattr(blk, "conv3"):
                out["conv3"] = _fold(blk.conv3, blk.bn3)
            if blk.downsample is not None:
                out["downsample"] = _fold(blk.downsample[0], blk.downsample[1])
            folded[f"layer{s + 1}_{b}"] = out
    return folded


def conv3x3_bias_relu(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``relu(conv3x3(x, weight) + bias (+ residual))``, stride 1, zero
    padding 1, on (B, C, H, W) tensors."""
    y = F.conv2d(x, weight, bias, 1, 1)
    if residual is not None:
        y += residual
    return F.relu_(y)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2)


def _load(conv: nn.Conv2d, t: Folded) -> None:
    with torch.no_grad():
        conv.weight.copy_(t["weight"])
        conv.bias.copy_(t["bias"])


class FoldedBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(cin, cout, 3, stride)
        self.conv2 = _conv(cout, cout, 3)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Conv2d(cin, cout, 1, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            y = conv3x3_bias_relu(x, self.conv1.weight, self.conv1.bias)
        else:
            y = F.relu_(self.conv1(x))
        identity = x if self.downsample is None else self.downsample(x)
        return conv3x3_bias_relu(y, self.conv2.weight, self.conv2.bias, identity)


class FoldedBottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, width, 1)
        self.conv2 = _conv(width, width, 3, stride)
        self.conv3 = _conv(width, 4 * width, 1)
        self.downsample = None
        if stride != 1 or cin != 4 * width:
            self.downsample = nn.Conv2d(cin, 4 * width, 1, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu_(self.conv1(x))
        y = F.relu_(self.conv2(y))
        y = self.conv3(y)
        identity = x if self.downsample is None else self.downsample(x)
        y += identity
        return F.relu_(y)


class FoldedEncoder(nn.Module):
    """The BN-folded ResNet-18/34/50 encoder: (B, H, W, 3) -> the same
    five NHWC features at strides /2 .. /32 as ``ResNetEncoder``."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        if num_layers not in RESNET_SPECS:
            raise ValueError(f"unsupported depth {num_layers}")
        self.num_layers = num_layers
        bottleneck = num_layers in BOTTLENECK_DEPTHS
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for i, (c, n) in enumerate(zip((64, 128, 256, 512), RESNET_SPECS[num_layers])):
            blocks = []
            for b in range(n):
                stride = 2 if (b == 0 and i > 0) else 1
                if bottleneck:
                    blocks.append(FoldedBottleneck(cin, c, stride))
                    cin = 4 * c
                else:
                    blocks.append(FoldedBasicBlock(cin, c, stride))
                    cin = c
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    @classmethod
    def from_encoder(cls, encoder: ResNetEncoder) -> "FoldedEncoder":
        """The folded twin of ``encoder``: fp32 weights on its device."""
        folded = fold_encoder_bn(encoder)
        out = cls(encoder.num_layers)
        _load(out.conv1, folded["conv1"])
        for s, n_blocks in enumerate(RESNET_SPECS[encoder.num_layers]):
            for b in range(n_blocks):
                blk, f = getattr(out, f"layer{s + 1}")[b], folded[f"layer{s + 1}_{b}"]
                for name, t in f.items():
                    _load(getattr(blk, name), t)
        return out.to(encoder.conv1.weight.device)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) -> [(B, H/2^k, W/2^k, C_k) for k = 1..5]."""
        y = F.relu_(self.conv1(x.permute(0, 3, 1, 2)))
        feats = [y]
        y = self.maxpool(y)
        for i in range(1, 5):
            y = getattr(self, f"layer{i}")(y)
            feats.append(y)
        return [f.permute(0, 2, 3, 1).contiguous() for f in feats]
