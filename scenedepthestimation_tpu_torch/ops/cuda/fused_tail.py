"""fused_tail: the mono decoder's level-0 tail in one launch (NHWC).

``ELU(conv3x3(y1, w00) + b00)`` -> nearest 2x -> ``ELU(conv3x3(., w01) +
b01)``, both convs reflect-bordered, the intermediate rounded to the input's
dtype between them.

Kernel 3 of the port, ``csrc/fused_tail.cu``: the counterpart of the TPU
kernels ``scenedepthestimation_tpu/ops/pallas/fused_tail.py::
fused_tail_pallas`` and ``fused_tail_v2.py::fused_tail_pallas_v2``, which
compute the same function on packed TPU layouts. :func:`fused_tail`
launches it for a CUDA tensor and takes :func:`fused_tail_plain` for a CPU
tensor; there is no other route. Weights are in PyTorch's (Cout, Cin, 3, 3)
layout, unpacked; the bf16 kernel reads both from one slab in the order
its products read (:func:`arrange_tail_weights`), which the mono decoder
makes once and keeps (``models/unet_decoder.DepthDecoder.tail_slab``); a
call without one arranges it first.
"""

from __future__ import annotations

from typing import Optional

import torch

from scenedepthestimation_tpu_torch.ops.cuda import _build
from scenedepthestimation_tpu_torch.ops.cuda.conv_block import conv3x3_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory one block may use on sm_90 (H100, H200), the kernel's target.
_SMEM_LIMIT = 232448


def _check(y1, w00, b00, w01, b01) -> None:
    if y1.dim() != 4:
        raise ValueError(f"y1 must be (B, h, w, C1), got {tuple(y1.shape)}")
    c1 = y1.shape[-1]
    if w00.dim() != 4 or tuple(w00.shape[1:]) != (c1, 3, 3):
        raise ValueError(f"w00 must be (C0, {c1}, 3, 3), got {tuple(w00.shape)}")
    c0 = w00.shape[0]
    if w01.dim() != 4 or tuple(w01.shape[1:]) != (c0, 3, 3):
        raise ValueError(f"w01 must be (C0o, {c0}, 3, 3), got {tuple(w01.shape)}")
    if b00.shape != (c0,) or b01.shape != (w01.shape[0],):
        raise ValueError(
            f"biases must be ({c0},) and ({w01.shape[0]},), got "
            f"{tuple(b00.shape)} and {tuple(b01.shape)}"
        )
    if y1.shape[1] < 2 or y1.shape[2] < 2:
        raise ValueError(f"reflect border needs h, w >= 2, got {tuple(y1.shape)}")


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def tail_slab_shape(c1: int, c0: int, c0o: int) -> tuple:
    """Elements of the weight slab, as a 1-D shape: W00 as (9, C0, C1) and
    W01 as (9, C0o, C0), each channel count rounded up to 16."""
    return (9 * _pad16(c0) * _pad16(c1) + 9 * _pad16(c0o) * _pad16(c0),)


def arrange_tail_weights_plain(w00: torch.Tensor, w01: torch.Tensor) -> torch.Tensor:
    """(C0, C1, 3, 3) and (C0o, C0, 3, 3) -> the slab, in their dtype: for
    each weight, per tap ``t = ky * 3 + kx`` the (N, K) matrix ``m[t, n, k]
    = w[n, k, ky, kx]`` (rows n of contiguous input channels k: the B
    fragments of the products, row by row), zero past the channels; W00's
    then W01's, flattened. Shape :func:`tail_slab_shape`."""
    parts = []
    for w in (w00, w01):
        n, k = w.shape[:2]
        m = w.new_zeros((9, _pad16(n), _pad16(k)))
        m[:, :n, :k] = w.permute(2, 3, 0, 1).reshape(9, n, k)
        parts.append(m.reshape(-1))
    return torch.cat(parts)


def arrange_tail_weights(w00: torch.Tensor, w01: torch.Tensor) -> torch.Tensor:
    """The slab of contiguous bf16 CUDA weights in one launch of the arrange
    kernel; :func:`arrange_tail_weights_plain` for CPU weights."""
    if w00.device.type == "cpu":
        return arrange_tail_weights_plain(w00, w01)
    for t in (w00, w01):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.dim() != 4:
            raise TypeError("the slab is made from contiguous bf16 (Cout, Cin, 3, 3) weights")
    c0, c1 = w00.shape[:2]
    c0o = w01.shape[0]
    slab = torch.empty(tail_slab_shape(c1, c0, c0o), dtype=torch.bfloat16, device=w00.device)
    err = _build.lib().sde_fused_tail_arrange(
        w00.data_ptr(), w01.data_ptr(), slab.data_ptr(), c1, c0, c0o, w00.device.index,
        _build.stream_of(w00),
    )
    _build.check(err, "fused_tail weights")
    _build.LAUNCHES["fused_tail_weights"] += 1
    return slab


def fused_tail_plain(
    y1: torch.Tensor,
    w00: torch.Tensor,
    b00: torch.Tensor,
    w01: torch.Tensor,
    b01: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: y1 (B, h, w, C1) -> y0 (B, 2h, 2w, C0o).

    The unfused chain: conv3x3 (reflect, ELU) rounded to y1's dtype,
    nearest 2x, conv3x3 (reflect, ELU) rounded to y1's dtype; each conv
    sums in fp32.
    """
    _check(y1, w00, b00, w01, b01)
    z = conv3x3_plain(y1, w00, b00, "elu", "reflect")
    z = z.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return conv3x3_plain(z, w01, b01, "elu", "reflect")


def fused_tail(
    y1: torch.Tensor,
    w00: torch.Tensor,
    b00: torch.Tensor,
    w01: torch.Tensor,
    b01: torch.Tensor,
    wslab: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused_tail kernel on a CUDA tensor, its plain version on a CPU one.

    Same contract as :func:`fused_tail_plain`. On CUDA every tensor must be
    contiguous, on y1's device and of y1's dtype (float32: the CUDA-core
    kernel; bfloat16: the tensor-core kernel), and the block's tiles must
    fit the card's shared memory (fp32: C0 up to 143; bf16, which stages
    both weights whole and a 16 x 32 z tile, or 8 x 32 where that does not
    fit: C1 up to 160 at C0 = C0o = 16, fewer for wider C0; the default
    decoder's 32 -> 16 -> 16 takes 151 KB); anything else raises. The bf16
    kernel reads ``wslab`` (:func:`arrange_tail_weights`); without it, the
    call arranges one first (one more launch). The fp32 kernel reads the
    weights and takes no slab; the plain version reads the weights, so a
    CPU call does not read ``wslab``.
    """
    if y1.device.type == "cpu":
        return fused_tail_plain(y1, w00, b00, w01, b01)
    if y1.device.type != "cuda":
        raise ValueError(f"fused_tail runs on cpu or cuda, not {y1.device}")
    _check(y1, w00, b00, w01, b01)
    if y1.dtype not in _DTYPES:
        raise TypeError(f"fused_tail kernel takes float32 or bfloat16, not {y1.dtype}")
    named = (("y1", y1), ("w00", w00), ("b00", b00), ("w01", w01), ("b01", b01))
    for name, t in named[1:]:
        if t.device != y1.device or t.dtype != y1.dtype:
            raise TypeError(
                f"{name} must be {y1.dtype} on {y1.device}, got {t.dtype} on {t.device}"
            )
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"fused_tail kernel needs a contiguous {name}")
    b, h, w, c1 = y1.shape
    c0, c0o = w00.shape[0], w01.shape[0]
    lib = _build.lib()
    smem = lib.sde_fused_tail_smem(c1, c0, c0o, _DTYPES[y1.dtype])
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"fused_tail kernel: C1={c1}, C0={c0}, C0o={c0o} in {y1.dtype} need "
            f"{smem} bytes of shared memory a block, the card has {_SMEM_LIMIT}"
        )
    y0 = torch.empty((b, 2 * h, 2 * w, c0o), dtype=y1.dtype, device=y1.device)
    if y0.numel() == 0:
        return y0
    if y1.dtype == torch.float32:
        if wslab is not None:
            raise TypeError("the fp32 fused_tail kernel reads the weights, not a slab")
    else:
        if wslab is None:
            wslab = arrange_tail_weights(w00, w01)
        if (tuple(wslab.shape) != tail_slab_shape(c1, c0, c0o) or wslab.dtype != torch.bfloat16
                or wslab.device != y1.device or not wslab.is_contiguous() or wslab.data_ptr() % 16):
            raise ValueError(
                f"wslab must be a contiguous, 16-byte aligned bf16 {tail_slab_shape(c1, c0, c0o)} "
                f"on {y1.device}, got {wslab.dtype} {tuple(wslab.shape)} on {wslab.device}"
            )
    err = lib.sde_fused_tail(
        y1.data_ptr(), w00.data_ptr(), b00.data_ptr(), w01.data_ptr(),
        b01.data_ptr(), None if wslab is None else wslab.data_ptr(), y0.data_ptr(),
        b, h, w, c1, c0, c0o,
        _DTYPES[y1.dtype], y1.device.index, _build.stream_of(y1),
    )
    _build.check(err, "fused_tail")
    _build.LAUNCHES["fused_tail"] += 1
    return y0
