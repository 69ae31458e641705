"""upsample_concat: nearest 2x of x, concatenated with skip on channels (NHWC).

Kernel 2 of the port, ``csrc/upsample_concat.cu``: the counterpart of the
TPU kernel ``scenedepthestimation_tpu/ops/pallas/upsample_concat.py::
upsample_concat_pallas``. :func:`upsample_concat` launches it for a CUDA
tensor and takes :func:`upsample_concat_plain` for a CPU tensor. Every
integer of a launch (the unit of the copy, the widths in units, the row
segments, the grid and the divisors' constants) comes from
:func:`upsample_concat_plan`, which the CPU tests replay.

The backward is the kernel ``sde_upsample_concat_bwd`` in the same source
(:func:`upsample_concat_backward`, fp32 or bf16), registered as the op's
autograd formula: dx sums g's 2x2 blocks over x's channels in fp32 in one
fixed order and rounds once to g's dtype, and dskip is g's last channels.
It replaces what XLA derives for the JAX package's
``scenedepthestimation_tpu/ops/upsample.py::upsample_concat``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from scenedepthestimation_tpu_torch.ops.cuda import _build

# The backward kernel's instantiations: dtype code and launch count name.
_BWD = {torch.float32: (0, "upsample_concat_bwd"),
        torch.bfloat16: (1, "upsample_concat_bwd_bf16")}


def _check(x: torch.Tensor, skip: torch.Tensor) -> None:
    if x.dim() != 4 or skip.dim() != 4:
        raise ValueError(f"x and skip must be NHWC, got {tuple(x.shape)}, {tuple(skip.shape)}")
    b, h, w, _ = x.shape
    if tuple(skip.shape[:3]) != (b, 2 * h, 2 * w):
        raise ValueError(
            f"skip {tuple(skip.shape)} does not match 2x of {tuple(x.shape)}"
        )
    if skip.dtype != x.dtype:
        raise TypeError(f"skip is {skip.dtype}, x is {x.dtype}")


def upsample_concat_plain(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x (B, H, W, C1), skip (B, 2H, 2W, C2) ->
    (B, 2H, 2W, C1 + C2), nearest 2x of x first."""
    _check(x, skip)
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return torch.cat([up, skip], dim=-1)


# The forward kernel's compile-time threads a block and loads in flight a
# thread (kUpThreads, kUnroll in csrc/upsample_concat.cu; the C entry
# refuses other values).
THREADS = 256
UNROLL = 2
# A row segment holds about one pass of its block's threads: ITEMS output
# units, or one pixel where a pixel holds more.
ITEMS = THREADS * UNROLL
GRID_Y_MAX = 65535
# Every in-segment index and offset of the kernel is 32-bit: 4 * wb * (v1 +
# v2) stays below this.
SEGMENT_LIMIT = 2**31
# A segment's x is staged in shared memory up to this many bytes (always,
# but for a pixel of x wider than it).
STAGE_LIMIT = 16 * 1024


class UpcatPlan(NamedTuple):
    """A launch of the forward kernel: the unit of the copy in bytes, x's
    and skip's widths ``v1``, ``v2`` in units, ``rows`` = B * H input rows of
    ``w`` pixels cut into ``nseg`` segments of ``wb`` pixels (the last one
    shorter), the grid (nseg, grid_y) of ``threads``-thread blocks that
    walk rows y, y + grid_y, ..., each thread with ``unroll`` loads in
    flight, (mul, shift) of the division by v1 + v2, and the bytes of
    shared memory that stage a segment of x (0: x read where needed)."""

    unit: int
    v1: int
    v2: int
    rows: int
    w: int
    wb: int
    nseg: int
    grid_y: int
    threads: int
    unroll: int
    mul: int
    shift: int
    staged: int


def fast_divisor(d: int) -> Tuple[int, int]:
    """(m, l) with which the kernel divides a 32-bit n by d >= 1:
    l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1, and n // d =
    (t + ((n - t) >> min(l, 1))) >> max(l - 1, 0) for t = (n * m) >> 32
    (Granlund and Montgomery). d = 0 (an empty width, never divided by)
    gives (1, 0)."""
    if d <= 1:
        return 1, 0
    shift = (d - 1).bit_length()
    return (((1 << 32) * ((1 << shift) - d)) // d) + 1, shift


def upsample_concat_plan(b: int, h: int, w: int, c1: int, c2: int, esize: int,
                         align: int = 16) -> UpcatPlan:
    """The forward kernel's launch for x (b, h, w, c1) and skip (b, 2h, 2w,
    c2) of ``esize``-byte elements whose three data pointers are all
    aligned to ``align`` bytes (a power of two): the unit is the widest of
    16, 8, 4 and 2 bytes, and no narrower than an element, that divides
    both channel widths in bytes and ``align``; a segment holds about
    ITEMS output units. Raises on an empty output, a pointer off its
    element's alignment, or a pixel too wide for 32-bit in-segment
    offsets."""
    if min(b, h, w) <= 0 or c1 < 0 or c2 < 0 or c1 + c2 == 0:
        raise ValueError(f"upsample_concat_plan takes a non-empty output, not {(b, h, w, c1, c2)}")
    if esize not in (2, 4) or align % esize:
        raise ValueError(f"{esize}-byte elements at a {align}-byte alignment")
    unit = 16
    while unit > esize and ((c1 * esize) % unit or (c2 * esize) % unit or align % unit):
        unit //= 2
    v1, v2 = c1 * esize // unit, c2 * esize // unit
    vt, rows = v1 + v2, b * h
    wb = min(max(ITEMS // (4 * vt), 1), w)
    nseg = -(-w // wb)
    wb = -(-w // nseg)
    if 4 * wb * vt >= SEGMENT_LIMIT:
        raise ValueError(f"a pixel of {c1} + {c2} channels is too wide for upsample_concat")
    staged = wb * v1 * unit
    mul, shift = fast_divisor(vt)
    return UpcatPlan(unit, v1, v2, rows, w, wb, nseg, min(rows, GRID_Y_MAX), THREADS, UNROLL,
                     mul, shift, staged if staged <= STAGE_LIMIT else 0)


def _alignment(a: int, b: int = 0, c: int = 0) -> int:
    """The largest power of two up to 16 that divides the pointers a, b
    and c."""
    bits = a | b | c | 16
    return bits & -bits


@functools.lru_cache(maxsize=256)
def _plan_array(b: int, h: int, w: int, c1: int, c2: int, esize: int, low: int) -> ctypes.Array:
    """upsample_concat_plan's fields, as the C entry reads them, for
    pointers whose low four bits OR to ``low``: the launch's one lookup on
    the host."""
    plan = upsample_concat_plan(b, h, w, c1, c2, esize, _alignment(low))
    return (ctypes.c_longlong * len(plan))(*plan)


def _upsample_concat(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """The body of :func:`upsample_concat`, and the implementation of its op."""
    if not x.is_cuda:  # is_cuda costs the host less than device.type on every launch
        if x.device.type == "cpu":
            return upsample_concat_plain(x, skip)
        raise ValueError(f"upsample_concat runs on cpu or cuda, not {x.device}")
    _check(x, skip)
    if skip.device != x.device:
        raise ValueError(f"skip is on {skip.device}, x on {x.device}")
    if not (x.is_contiguous() and skip.is_contiguous()):
        raise ValueError("upsample_concat kernel needs contiguous inputs")
    esize = x.element_size()
    if esize not in (2, 4):
        raise TypeError(f"upsample_concat kernel takes 2- or 4-byte elements, not {x.dtype}")
    b, h, w, c1 = x.shape
    c2 = skip.shape[-1]
    out = torch.empty((b, 2 * h, 2 * w, c1 + c2), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    p0, p1, p2 = x.data_ptr(), skip.data_ptr(), out.data_ptr()
    err = _build.lib().sde_upsample_concat(
        p0, p1, p2, _plan_array(b, h, w, c1, c2, esize, (p0 | p1 | p2) & 15),
        x.get_device(), _build.stream_of(x),
    )
    _build.check(err, "upsample_concat")
    _build.LAUNCHES["upsample_concat"] += 1
    return out


def _upsample_concat_fake(x, skip):
    b, h, w, c1 = x.shape
    return x.new_empty((b, 2 * h, 2 * w, c1 + skip.shape[-1]))


upsample_concat_op = _build.register_op(
    "upsample_concat",
    "(Tensor x, Tensor skip) -> Tensor",
    _upsample_concat, _upsample_concat_fake,
)


def upsample_concat_backward_plain(
    grad: torch.Tensor, c1: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: (dx, dskip) for the gradient
    ``grad`` (B, 2H, 2W, c1 + C2) of the output, dx the sum of each 2x2
    block of the first c1 channels in the kernel's order, (0, 0) + (0, 1)
    + (1, 0) + (1, 1), in fp32 and rounded once to grad's dtype."""
    g = grad[..., :c1].float()
    dx = g[:, 0::2, 0::2] + g[:, 0::2, 1::2] + g[:, 1::2, 0::2] + g[:, 1::2, 1::2]
    return dx.to(grad.dtype).contiguous(), grad[..., c1:].contiguous()


def upsample_concat_backward(
    grad: torch.Tensor, c1: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dskip) for the gradient ``grad`` of :func:`upsample_concat`'s
    output, x having ``c1`` channels: the backward kernel on CUDA (fp32 or
    bf16; ``grad`` made contiguous first, a copy only when it is not), the
    plain version on the CPU."""
    if grad.device.type == "cpu":
        return upsample_concat_backward_plain(grad, c1)
    if grad.dtype not in _BWD:
        raise TypeError(
            f"upsample_concat's backward kernel takes float32 or bfloat16, not {grad.dtype}")
    code, name = _BWD[grad.dtype]
    b, h2, w2, ct = grad.shape
    if h2 % 2 or w2 % 2 or not 0 < c1 < ct:
        raise ValueError(f"grad {tuple(grad.shape)} is no upsample_concat output of {c1} + C2")
    grad = grad.contiguous()
    h, w = h2 // 2, w2 // 2
    dx = torch.empty((b, h, w, c1), dtype=grad.dtype, device=grad.device)
    dskip = torch.empty((b, h2, w2, ct - c1), dtype=grad.dtype, device=grad.device)
    if grad.numel() == 0:
        return dx, dskip
    err = _build.lib().sde_upsample_concat_bwd(
        grad.data_ptr(), dx.data_ptr(), dskip.data_ptr(), b, h, w, c1, ct - c1, code,
        grad.device.index, _build.stream_of(grad),
    )
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return dx, dskip


def _setup_context(ctx, inputs, output):
    ctx.c1 = inputs[0].shape[-1]


def _backward(ctx, grad):
    return upsample_concat_backward(grad, ctx.c1)


upsample_concat_op.register_autograd(_backward, setup_context=_setup_context)


def upsample_concat(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """The upsample_concat kernel on a CUDA tensor, its plain version on a
    CPU one. On CUDA both inputs must be contiguous, of one dtype with a
    2- or 4-byte element; anything else raises. A call that autograd
    records goes through the op, whose backward is
    :func:`upsample_concat_backward`."""
    if _build.tracing or _build.needs_grad(x, skip):
        return upsample_concat_op(x, skip)
    return _upsample_concat(x, skip)
