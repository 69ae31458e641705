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
layout, unpacked.
"""

from __future__ import annotations

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
) -> torch.Tensor:
    """The fused_tail kernel on a CUDA tensor, its plain version on a CPU one.

    Same contract as :func:`fused_tail_plain`. On CUDA every tensor must be
    contiguous, on y1's device and of y1's dtype (float32: the CUDA-core
    kernel; bfloat16: the tensor-core kernel), and the block's tiles must
    fit the card's shared memory (fp32: C0 up to 143; bf16, which stages
    both weights whole: C1 up to 160 at C0 = C0o = 16, fewer for wider C0;
    the default decoder's 32 -> 16 -> 16 takes 69 KB); anything else
    raises.
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
    err = lib.sde_fused_tail(
        y1.data_ptr(), w00.data_ptr(), b00.data_ptr(), w01.data_ptr(),
        b01.data_ptr(), y0.data_ptr(), b, h, w, c1, c0, c0o,
        _DTYPES[y1.dtype], y1.device.index, _build.stream_of(y1),
    )
    _build.check(err, "fused_tail")
    _build.LAUNCHES["fused_tail"] += 1
    return y0
