"""U-Net depth decoder with sigmoid disparity heads, the counterpart of
``scenedepthestimation_tpu/models/unet_decoder.py``.

Per level: ``conv3x3(reflect)+ELU -> nearest 2x -> concat skip ->
conv3x3(reflect)+ELU``, with a ``conv3x3(reflect) -> sigmoid`` head in fp32
at each requested scale. Every conv, the heads included, is the conv3x3
kernel (``ops/cuda/conv_block.py``); every skip join is the
upsample_concat kernel. This is the JAX package's plain decoder with its
fused Pallas conv switched on; the collapsed and packed TPU relayouts of
it are exact rewrites and are not ported. Layout: NHWC.

With ``ops.fused_tail.set_use_fused_tail(True or "v2")`` and a nearest
upsample, level 0's ``upconv_0_0`` -> 2x -> ``upconv_0_1`` is one launch of
the fused_tail kernel. The JAX collapsed decoder engages its fused tail
only where ``_pick_th`` finds a row tiling; the port's kernel takes every
half-res h, w >= 2, and both routes compute the same output.

``border_mode="fast"`` is the JAX collapsed decoder's fast-border serving
mode (``scenedepthestimation_tpu/ops/collapsed.py``, ``border_mode``):
every ConvBlock and, without the fused tail, the head take a zero border.
The fused tail takes no border argument there and stays reflect, and the
head behind it reads the reflect border, so with the fused tail on level
0 and the head are as in ``"exact"``. The JAX package runs the fused tail
only where its row tiling exists (:func:`fused_tail.jax_tiles_rows`); in
fast mode, where level 0's border depends on it, the port follows it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from scenedepthestimation_tpu_torch.ops import fused_tail
from scenedepthestimation_tpu_torch.ops.cuda import conv_block
from scenedepthestimation_tpu_torch.ops.upsample import upsample2x, upsample_concat


class Conv3x3(nn.Module):
    """Border-padded 3x3 conv + activation through the conv3x3 kernel.

    Holds ``weight`` (Cout, Cin, 3, 3) and ``bias`` (Cout), the parameters
    of an ``nn.Conv2d(cin, cout, 3)``. ``out_dtype`` pins the output dtype
    (the heads emit fp32); by default it is the input's. For the kernel's
    bf16 tensor-core path it keeps the weight's slab (:meth:`slab`).
    """

    def __init__(
        self,
        cin: int,
        cout: int,
        activation: str = "elu",
        out_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.activation = activation
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(9 * cin))
        self._slab: Optional[torch.Tensor] = None
        self._slab_of: Optional[tuple] = None

    def slab(self) -> torch.Tensor:
        """``conv_block.arrange_slab`` of the weight, made once and kept;
        made again when the weight's storage or ``_version`` changes (an
        inference tensor has no version counter: its storage alone). The
        kept detached view holds the old storage, so a new one cannot take
        its address."""
        w = self.weight
        version = None if w.is_inference() else w._version
        if self._slab_of is None or (
            self._slab_of[0].data_ptr(), self._slab_of[1]
        ) != (w.data_ptr(), version):
            self._slab = conv_block.arrange_slab(w.detach())
            self._slab_of = (w.detach(), version)
        return self._slab

    def forward(self, x: torch.Tensor, border: str = "reflect") -> torch.Tensor:
        slab = self.slab() if conv_block.uses_slab(x, self.weight.shape[0]) else None
        return conv_block.conv3x3(
            x, self.weight, self.bias, activation=self.activation,
            border=border, out_dtype=self.out_dtype, slab=slab,
        )


class ConvBlock(nn.Module):
    """3x3 conv with a border (reflection by default) followed by ELU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3x3(cin, cout, activation="elu")

    def forward(self, x: torch.Tensor, border: str = "reflect") -> torch.Tensor:
        return self.conv(x, border)


class DispHead(nn.Module):
    """3x3 conv (reflect pad by default) -> sigmoid disparity in [0, 1], in fp32."""

    def __init__(self, cin: int):
        super().__init__()
        self.conv = Conv3x3(cin, 1, activation="sigmoid", out_dtype=torch.float32)

    def forward(self, x: torch.Tensor, border: str = "reflect") -> torch.Tensor:
        return self.conv(x, border)


class DepthDecoder(nn.Module):
    """Top-down decoder over the 5-level encoder pyramid.

    Holds a head for each scale in ``scales``; ``forward`` computes the
    heads it is asked for and returns ``{scale: (B, H/2^s, W/2^s, 1)}``.
    ``border_mode`` is ``"exact"`` (reflect borders) or ``"fast"`` (see the
    module docstring); ``Predictor`` sets it.
    """

    def __init__(
        self,
        num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
        dec_channels: Tuple[int, ...] = (16, 32, 64, 128, 256),
        scales: Tuple[int, ...] = (0, 1, 2, 3),
        upsample_mode: str = "nearest",
    ):
        super().__init__()
        self.scales = tuple(scales)
        self.upsample_mode = upsample_mode
        self.border_mode = "exact"
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else dec_channels[i + 1]
            setattr(self, f"upconv_{i}_0", ConvBlock(cin, dec_channels[i]))
            cin = dec_channels[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            setattr(self, f"upconv_{i}_1", ConvBlock(cin, dec_channels[i]))
        for s in self.scales:
            setattr(self, f"dispconv_{s}", DispHead(dec_channels[s]))

    def forward(
        self,
        features: Sequence[torch.Tensor],
        scales: Optional[Sequence[int]] = None,
    ) -> Dict[int, torch.Tensor]:
        if self.border_mode not in ("exact", "fast"):
            raise ValueError(f"border_mode must be 'exact' or 'fast', not {self.border_mode!r}")
        scales = self.scales if scales is None else tuple(scales)
        fast = self.border_mode == "fast"
        border = "zero" if fast else "reflect"
        outputs: Dict[int, torch.Tensor] = {}
        x = features[-1]
        for i in range(4, -1, -1):
            head_border = border
            if (
                i == 0
                and self.upsample_mode == "nearest"
                and fused_tail.enabled()
                and (not fast or fused_tail.jax_tiles_rows(x.shape[1] // 2))
            ):
                u00, u01 = self.upconv_0_0.conv, self.upconv_0_1.conv
                x = fused_tail.fused_tail(x, u00.weight, u00.bias, u01.weight, u01.bias)
                head_border = "reflect"
            else:
                x = getattr(self, f"upconv_{i}_0")(x, border)
                if i > 0:
                    x = upsample_concat(x, features[i - 1], mode=self.upsample_mode)
                else:
                    x = upsample2x(x, mode=self.upsample_mode)
                x = getattr(self, f"upconv_{i}_1")(x, border)
            if i in scales:
                outputs[i] = getattr(self, f"dispconv_{i}")(x, head_border)
        return outputs
