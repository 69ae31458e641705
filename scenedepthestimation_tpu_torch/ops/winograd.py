"""Winograd F(2x2, 3x3) conv in phase space, the counterpart of
``scenedepthestimation_tpu/ops/pallas/winograd.py`` with its public names.

A zero-padded 3x3 stride-1 conv of an NHWC image with even H and W, taken
on its four even/odd phase arrays ``x[:, a::2, b::2, :]``: 16 products of
(tiles x C) by (C x Co) per 2x2 output block instead of the direct conv's
36, with the BN-folded bias, an optional residual (the BasicBlock
shortcut) and an optional ReLU fused. The kernel is
``ops/cuda/winograd.winograd_conv3x3_phases`` (``csrc/winograd.cu`` on
CUDA tensors, its plain version on CPU tensors).

The kernel reads the weights as U, (16, C, Co) in the phases' dtype.
:func:`kept_u_slab` makes it once per weight and keeps it until the weight
changes; pass it as ``winograd_conv3x3(..., u_slab=...)``. Without one the
call transforms the weight itself.

As in the JAX package, nothing routes the model through it by default: the
folded encoder (``models/folded.py``) runs its convs in cuDNN.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from scenedepthestimation_tpu_torch.ops.cuda import winograd as _kernel
from scenedepthestimation_tpu_torch.ops.cuda.winograd import (
    winograd_conv3x3_phases,
    winograd_conv3x3_phases_plain,
)

__all__ = [
    "conv3x3_reference",
    "kept_u_slab",
    "phases_to_space",
    "space_to_phases",
    "transform_weights",
    "winograd_conv3x3",
    "winograd_conv3x3_phases",
    "winograd_conv3x3_phases_plain",
]

# Winograd F(2x2, 3x3) weight transform (exact rationals).
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))


def transform_weights(weight: torch.Tensor) -> torch.Tensor:
    """(Co, C, 3, 3) conv kernel -> (16, C, Co) fp32 Winograd weights,
    ``U[4i + j] = sum_ab G[i, a] G[j, b] g[a, b]``.

    The weight is in PyTorch's (Co, C, 3, 3) layout; the JAX function takes
    HWIO (3, 3, C, Co), the same kernel transposed.
    """
    if weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"weight must be (Co, C, 3, 3), got {tuple(weight.shape)}")
    g = torch.tensor(_G, dtype=torch.float32, device=weight.device)
    u = torch.einsum("ia,jb,ocab->ijco", g, g, weight.float())
    return u.reshape((16,) + tuple(u.shape[2:]))


# weight -> (a detached view of the weight U was made from, its _version, U).
_KEPT: WeakIdKeyDictionary = WeakIdKeyDictionary()


def kept_u_slab(weight: torch.Tensor) -> torch.Tensor:
    """``transform_weights(weight)`` in the weight's dtype, contiguous: the
    U the kernel reads when the phases share that dtype. Made once per
    weight and kept; made again when the weight's storage or ``_version``
    changes (an inference tensor has no version counter: its storage
    alone). The kept detached view holds the old storage, so a new one
    cannot take its address."""
    version = None if weight.is_inference() else weight._version
    kept = _KEPT.get(weight)
    if kept is None or (kept[0].data_ptr(), kept[1]) != (weight.data_ptr(), version):
        w = weight.detach()
        kept = (w, version, transform_weights(w).to(w.dtype).contiguous())
        _KEPT[weight] = kept
    return kept[2]


def space_to_phases(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(B, H, W, C) with even H, W -> 4 phase views (B, H/2, W/2, C): p00
    p01 p10 p11. Odd H or W raises (its phases would differ in size)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"the phase split needs even H and W, got {tuple(x.shape)}")
    return (x[:, 0::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 0::2], x[:, 1::2, 1::2])


def phases_to_space(phases: Sequence[torch.Tensor]) -> torch.Tensor:
    """Inverse of :func:`space_to_phases` (one interleave)."""
    p00, p01, p10, p11 = phases
    b, hp, wp, c = p00.shape
    rows0 = torch.stack([p00, p01], dim=3).reshape(b, hp, 2 * wp, c)
    rows1 = torch.stack([p10, p11], dim=3).reshape(b, hp, 2 * wp, c)
    return torch.stack([rows0, rows1], dim=2).reshape(b, 2 * hp, 2 * wp, c)


def winograd_conv3x3(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    relu: bool = True,
    u_slab: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NHWC wrapper: x (B, H, W, C), weight (Co, C, 3, 3) -> (B, H, W, Co)
    of ``relu(conv3x3(x) + bias + residual)`` through the kernel.

    The phases are views of x and of the output, which the kernel writes
    in place, so neither a split nor an interleave moves data. ``u_slab``
    (:func:`kept_u_slab` of the weight) is read in place of the weight.
    """
    co = weight.shape[0]
    if bias is None:
        bias = torch.zeros((co,), dtype=torch.float32, device=x.device)
    y = torch.empty(tuple(x.shape[:3]) + (co,), dtype=x.dtype, device=x.device)
    _kernel.winograd_conv3x3_phases(
        space_to_phases(x),
        transform_weights(weight) if u_slab is None else u_slab,
        bias,
        residual_phases=None if residual is None else space_to_phases(residual),
        relu=relu,
        out=space_to_phases(y),
    )
    return y


def conv3x3_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    relu: bool = True,
) -> torch.Tensor:
    """Direct-conv oracle, NHWC: stride 1, zero pad 1 (+ bias, + residual,
    ReLU), in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if residual is not None:
        y = y + residual
    if relu:
        y = torch.relu(y)
    return y
