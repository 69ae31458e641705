"""Stereo disparity network, the counterpart of
``scenedepthestimation_tpu/models/stereo.py``.

* Siamese feature tower, stride 4, over the pair folded into the batch
  (``(B, 2, ...) -> (2B, ...)`` interleaved, as the JAX model does).
* 1-D correlation cost volume in the features' dtype (``ops/correlation``:
  the correlation kernel for fp32 features, the banded-Gram kernel for
  bf16).
* Cost aggregation: a 2-D conv U-Net over cost ++ left features, whose
  three skip joins go through the upsample_concat kernel.
* Soft-argmin readout in fp32 x ``feat_stride`` (the soft_argmin kernel),
  the optional residual refinement, and the x4 bilinear upsample.

The convs are ``nn.Conv2d`` with explicit padding k // 2 on both sides,
as the Flax convs pad, and run in cuDNN on channels-last memory: the
public functions take and return NHWC, and the NCHW tensors in between
are views of it. Module names follow the Flax names
(``tower.down1.conv``, ``aggregation.cost_head``, ``refinement.residual``),
so ``utils/weights.from_jax_variables`` maps one onto the other.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from scenedepthestimation_tpu_torch.configs import StereoConfig
from scenedepthestimation_tpu_torch.models.monodepth import init_parameters as _init_convs
from scenedepthestimation_tpu_torch.ops.correlation import correlation1d
from scenedepthestimation_tpu_torch.ops.soft_argmin import soft_argmin
from scenedepthestimation_tpu_torch.ops.upsample import upsample4x_bilinear, upsample_concat


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()  # no copy on channels-last memory


def _join(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """nearest 2x of x ++ skip on channels, NCHW views in and out."""
    return _nchw(upsample_concat(_nhwc(x), _nhwc(skip), mode="nearest"))


class ConvRelu(nn.Module):
    """k x k conv (zero pad k // 2, stride s) + ReLU on an NCHW view."""

    def __init__(self, cin: int, cout: int, stride: int = 1, kernel: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x))


class FeatureTower(nn.Module):
    """Shared-weight feature extractor, /4: (N, H, W, 3) -> (N, H/4, W/4, C)."""

    def __init__(self, channels: int = 64):
        super().__init__()
        self.down1 = ConvRelu(3, 32, stride=2, kernel=5)
        self.down2 = ConvRelu(32, channels, stride=2, kernel=5)
        self.refine1 = ConvRelu(channels, channels)
        self.refine2 = ConvRelu(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.down2(self.down1(_nchw(x)))
        return _nhwc(self.refine2(self.refine1(y)))


class CostAggregation(nn.Module):
    """2-D conv U-Net over (cost ++ left features) (B, h, w, cin) -> refined
    matching cost (B, h, w, D). The grid must divide by 8.

    ``aux_heads`` holds the intermediate-scale cost heads of a refine
    network (``cost_head_s1``, ``cost_head_s2``) so its weights load; they
    serve training only, and inference never evaluates them.
    """

    def __init__(
        self,
        cin: int,
        out_disp: int,
        channels: tuple = (64, 96, 128, 160),
        aux_heads: bool = False,
    ):
        super().__init__()
        c0, c1, c2, c3 = channels
        self.enc0 = ConvRelu(cin, c0)
        self.enc1 = ConvRelu(c0, c1, stride=2)
        self.enc1b = ConvRelu(c1, c1)
        self.enc2 = ConvRelu(c1, c2, stride=2)
        self.enc2b = ConvRelu(c2, c2)
        self.enc3 = ConvRelu(c2, c3, stride=2)
        self.enc3b = ConvRelu(c3, c3)
        self.dec2 = ConvRelu(c3 + c2, c2)
        self.dec1 = ConvRelu(c2 + c1, c1)
        self.dec0 = ConvRelu(c1 + c0, c0)
        self.cost_head = nn.Conv2d(c0, out_disp, 3, padding=1)
        if aux_heads:
            self.cost_head_s1 = nn.Conv2d(c1, out_disp, 3, padding=1)
            self.cost_head_s2 = nn.Conv2d(c2, out_disp, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e0 = self.enc0(_nchw(x))
        e1 = self.enc1b(self.enc1(e0))
        e2 = self.enc2b(self.enc2(e1))
        e3 = self.enc3b(self.enc3(e2))
        d2 = self.dec2(_join(e3, e2))
        d1 = self.dec1(_join(d2, e1))
        d0 = self.dec0(_join(d1, e0))
        return _nhwc(self.cost_head(d0))


class Refinement(nn.Module):
    """Residual disparity refinement from the left features and the
    soft-argmin disparity; the residual conv starts at zero, so an
    untrained refinement is the identity."""

    def __init__(self, feat_channels: int, max_disp: float, channels: int = 32):
        super().__init__()
        self.max_disp = max_disp
        self.conv1 = ConvRelu(feat_channels + 1, channels)
        self.conv2 = ConvRelu(channels, channels)
        self.residual = nn.Conv2d(channels, 1, 3, padding=1)

    def forward(self, f_l: torch.Tensor, disp_q: torch.Tensor) -> torch.Tensor:
        x = torch.cat([f_l, (disp_q / self.max_disp).to(f_l.dtype)[..., None]], dim=-1)
        r = self.residual(self.conv2(self.conv1(_nchw(x))))
        return disp_q + r[:, 0].float() * self.max_disp


def split_pair(feats: torch.Tensor):
    """(2B, ...) interleaved left/right stack -> (B, ...) x2, views of it
    (batch stride twice the stack's): the correlation kernels read them in
    place, and the aggregation's concat reads the left one as it is."""
    pair = feats.view(feats.shape[0] // 2, 2, *feats.shape[1:])
    return pair[:, 0], pair[:, 1]


class StereoNet(nn.Module):
    """left, right (B, H, W, 3) normalized -> full-res disparity (B, H, W)
    in px. With ``cfg.refine`` the readout passes through
    :class:`Refinement`."""

    def __init__(self, cfg: StereoConfig = StereoConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.corr_disp
        self.tower = FeatureTower(cfg.feat_channels)
        self.aggregation = CostAggregation(
            d + cfg.feat_channels, d, cfg.agg_channels, aux_heads=cfg.refine
        )
        if cfg.refine:
            self.refinement = Refinement(cfg.feat_channels, float(d * cfg.feat_stride))

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        b, h, w, c = left.shape
        pair = torch.stack([left, right], dim=1).reshape(2 * b, h, w, c)
        return self.forward_pair(pair)

    def forward_pair(self, pair: torch.Tensor) -> torch.Tensor:
        """The interleaved (2B, H, W, 3) stack -> disparity (B, H, W) px."""
        cfg = self.cfg
        f_l, f_r = split_pair(self.tower(pair))
        cost = correlation1d(f_l, f_r, cfg.corr_disp)  # (B, H/4, W/4, D)
        refined = self.aggregation(torch.cat([cost, f_l], dim=-1))
        # The readout runs in fp32 whatever the compute dtype, as in JAX.
        disp_q = soft_argmin(
            refined.float(), cfg.softargmin_temperature, scale=float(cfg.feat_stride)
        )
        if cfg.refine:
            disp_q = self.refinement(f_l, disp_q)
        return upsample4x_bilinear(disp_q[..., None])[..., 0]


@torch.no_grad()
def init_parameters(model: StereoNet, generator: torch.Generator) -> None:
    """Seeded random init, the JAX package's scheme: conv weights
    N(0, 1/fan_in), biases 0, and the refinement's residual conv all zero."""
    _init_convs(model, generator)
    if model.cfg.refine:
        model.refinement.residual.weight.zero_()
