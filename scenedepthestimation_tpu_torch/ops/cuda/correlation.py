"""correlation: the 1-D stereo cost volume (NHWC, disparity minor).

``cost[b, h, w, d] = (1/C) * sum_c FL[b, h, w, c] * FR[b, h, w - d, c]``
for d in [0, D), zero where ``w - d < 0``.

Kernel 6 of the port, ``csrc/correlation.cu``: the counterpart of the TPU
kernel ``scenedepthestimation_tpu/ops/pallas/correlation.py::
_correlation_pallas_impl``. :func:`correlation` launches it for a CUDA
tensor and takes :func:`correlation_plain` for a CPU tensor. Both sum in
fp32 and return the input's dtype, as the TPU kernel does. Both take the
halves of the stereo tower's interleaved (2B, H, W, C) output as they
are: views with contiguous (W, C) rows and a batch stride of 2*H*W*C.

The backward is ``csrc/correlation_bwd.cu`` (:func:`correlation_backward`,
fp32; its blocking :func:`backward_plan`): the counterpart of the JAX
package's analytic VJP ``scenedepthestimation_tpu/ops/correlation.py::
_corr_bwd``, registered as the op's autograd formula.
:func:`correlation_backward_plain` is that VJP written in PyTorch, in its
order of sums; the banded Gram's bf16 backward
(``correlation_gram.correlation_gram_backward``) shares it as its plain
version.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from scenedepthestimation_tpu_torch.ops.cuda import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's blocking (csrc/correlation.cu): a block a W segment of
# W_SEGMENT columns and a D tile (at most MAX_D_TILE, a multiple of DISPS);
# a thread a PIXELS x DISPS register tile; CHUNK channels a stage, STAGES
# stages in flight.
W_SEGMENT = 64
PIXELS = 4
DISPS = 8
CHUNK = 32
STAGES = 2
MAX_D_TILE = 64


def d_cover(d: int, multiple: int) -> Tuple[int, int]:
    """(D tile, D tiles) covering ``d`` disparities: the fewest tiles of at
    most MAX_D_TILE, each ceil(d / tiles) rounded up to ``multiple``."""
    tiles = -(-d // MAX_D_TILE)
    per_tile = -(-d // tiles)
    td = -(-per_tile // multiple) * multiple
    return td, -(-d // td)


def tile_plan(w: int, c: int, d: int) -> dict:
    """The correlation kernel's blocking for a (W, C) row and D disparities:
    the W segments, the register tile, the D cover (tile, tiles; D = 48 is
    one tile of six 8-disparity groups, no idle lane), the threads a block,
    the right-view window a block stages, and the channel chunks."""
    td, nd = d_cover(d, DISPS)
    return {
        "w_segment": W_SEGMENT,
        "w_segments": -(-w // W_SEGMENT),
        "register_tile": (PIXELS, DISPS),
        "d_tile": td,
        "d_tiles": nd,
        "threads": (W_SEGMENT // PIXELS) * (td // DISPS),
        "window": W_SEGMENT + td - 1,
        "chunk": CHUNK,
        "chunks": -(-c // CHUNK),
        "stages": STAGES,
    }


# The backward kernel's blocking (csrc/correlation_bwd.cu): units of a row's
# W segment of BWD_SEGMENT columns with both outputs, walked by persistent
# blocks (one an SM) with the next unit's staging in flight; a thread a
# BWD_PIXELS x 4 register tile of one output, sliding along d; BWD_CHUNK
# channels a chunk; D in chunks of at most BWD_MAX_D, each a multiple of 8.
BWD_SEGMENT = 64
BWD_PIXELS = 8
BWD_CHUNK = 64
BWD_MAX_D = 48


def backward_plan(w: int, c: int, d: int) -> dict:
    """The fp32 backward kernel's blocking for a (W, C) row and D
    disparities: the W segments, the register tile, the D chunk (the fewest
    chunks of at most BWD_MAX_D, each rounded up to a multiple of 8: tile,
    tiles; D = 48 is one chunk of 48), the threads a block (half for each
    output), the columns of each view's window and the rows of g a block
    stages, the channel chunks and the shared memory a block takes, in
    bytes (two stages of the windows, g's rows and, with more than one D
    chunk, d_fl's own rows of g)."""
    tiles = -(-d // BWD_MAX_D)
    dt = -(-(-(-d // tiles)) // 8) * 8
    nd = -(-d // dt)
    window = BWD_SEGMENT + dt - 1
    stage = 2 * window * BWD_CHUNK + window * dt + (BWD_SEGMENT * dt if nd > 1 else 0)
    return {
        "w_segment": BWD_SEGMENT,
        "w_segments": -(-w // BWD_SEGMENT),
        "register_tile": (BWD_PIXELS, 4),
        "d_tile": dt,
        "d_tiles": nd,
        "threads": 2 * (BWD_SEGMENT // BWD_PIXELS) * (BWD_CHUNK // 4),
        "window": window,
        "chunk": BWD_CHUNK,
        "chunks": -(-c // BWD_CHUNK),
        "shared_bytes": 4 * 2 * stage,
    }


def batch_stride(t: torch.Tensor, name: str) -> int:
    """The batch stride, in elements, of a (B, H, W, C) view that the
    correlation kernels read row by row: C stride 1, W stride C, H stride
    W*C (the stride of an axis of size 1 does not matter). Raises for any
    other layout."""
    b, h, w, c = t.shape
    _, sh, sw, sc = t.stride()
    if (c > 1 and sc != 1) or (w > 1 and sw != c) or (h > 1 and sh != w * c):
        raise ValueError(
            f"{name} kernel reads (W, C) rows with C stride 1, W stride C and H "
            f"stride W*C; got strides {t.stride()} for shape {tuple(t.shape)}"
        )
    return t.stride(0) if b > 1 else h * w * c


def _check(f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int) -> None:
    if f_left.dim() != 4:
        raise ValueError(f"features must be (B, H, W, C), got {tuple(f_left.shape)}")
    if f_left.shape != f_right.shape:
        raise ValueError(
            f"shape mismatch {tuple(f_left.shape)} vs {tuple(f_right.shape)}"
        )
    if f_left.dtype != f_right.dtype:
        raise TypeError(f"f_left is {f_left.dtype}, f_right is {f_right.dtype}")
    if f_left.shape[-1] < 1:
        raise ValueError("features need at least one channel")
    if max_disp < 1:
        raise ValueError(f"max_disp must be >= 1, got {max_disp}")


def correlation_plain(
    f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Plain PyTorch version: shift-and-reduce over a left-padded F_R,
    (B, H, W, C) x2 -> (B, H, W, max_disp)."""
    _check(f_left, f_right, max_disp)
    w, c = f_left.shape[2], f_left.shape[3]
    fl = f_left.float()
    fr = F.pad(f_right.float(), (0, 0, max_disp - 1, 0))  # zeros left of W
    inv_c = 1.0 / c
    slices = []
    for d in range(max_disp):
        start = max_disp - 1 - d
        slices.append((fl * fr[:, :, start : start + w]).sum(-1) * inv_c)
    return torch.stack(slices, dim=-1).to(f_left.dtype)


def _correlation(
    f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """The body of :func:`correlation`, and the implementation of its op."""
    if f_left.device.type == "cpu":
        return correlation_plain(f_left, f_right, max_disp)
    if f_left.device.type != "cuda":
        raise ValueError(f"correlation runs on cpu or cuda, not {f_left.device}")
    _check(f_left, f_right, max_disp)
    if f_right.device != f_left.device:
        raise ValueError(f"f_right is on {f_right.device}, f_left on {f_left.device}")
    if f_left.dtype not in _DTYPES:
        raise TypeError(f"correlation kernel takes float32 or bfloat16, not {f_left.dtype}")
    sbl = batch_stride(f_left, "correlation")
    sbr = batch_stride(f_right, "correlation")
    b, h, w, c = f_left.shape
    out = torch.empty((b, h, w, max_disp), dtype=f_left.dtype, device=f_left.device)
    if out.numel() == 0:
        return out
    err = _build.lib().sde_correlation(
        f_left.data_ptr(), sbl, f_right.data_ptr(), sbr, out.data_ptr(),
        b, h, w, c, max_disp, d_cover(max_disp, DISPS)[0], _DTYPES[f_left.dtype],
        f_left.device.index, _build.stream_of(f_left),
    )
    _build.check(err, "correlation")
    _build.LAUNCHES["correlation"] += 1
    return out


def _correlation_fake(f_left, f_right, max_disp):
    return f_left.new_empty(tuple(f_left.shape[:3]) + (max_disp,))


correlation_op = _build.register_op(
    "correlation",
    "(Tensor f_left, Tensor f_right, int max_disp) -> Tensor",
    _correlation, _correlation_fake,
)


def correlation_backward_plain(
    grad: torch.Tensor, f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, the JAX ``_corr_bwd`` term for
    term: ``d_fl[w] = 1/C sum_d g[w, d] fr[w - d]`` and ``d_fr[w] = 1/C
    sum_d g[w + d, d] fl[w + d]``, summed over d in ascending order in
    fp32, out-of-frame terms zero; each in its input's dtype."""
    w, c = f_left.shape[2], f_left.shape[3]
    g, fl, fr = grad.float(), f_left.float(), f_right.float()
    fr_pad = F.pad(fr, (0, 0, max_disp - 1, 0))
    d_fl = torch.zeros_like(fl)
    d_fr = torch.zeros_like(fr)
    for d in range(max_disp):
        start = max_disp - 1 - d
        g_d = g[..., d : d + 1]
        d_fl = d_fl + g_d * fr_pad[:, :, start : start + w]
        shifted = F.pad(g_d * fl, (0, 0, 0, d))[:, :, d:]  # g_d fl moved left by d
        d_fr = d_fr + shifted
    inv_c = 1.0 / c
    return (d_fl * inv_c).to(f_left.dtype), (d_fr * inv_c).to(f_right.dtype)


def backward_operands(
    grad: torch.Tensor, f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int, name: str
) -> tuple:
    """What a backward kernel of the cost volume reads and writes, checked:
    (g, its batch, row and column strides, fl's and fr's batch strides,
    d_fl, d_fr). ``grad`` is read through its strides with a D stride of 1
    (the slice the aggregation's concat hands back is not copied; another
    layout is), the features as :func:`correlation` reads them; d_fl and
    d_fr are new (B, H, W, C) tensors of the features' dtype."""
    _check(f_left, f_right, max_disp)
    b, h, w, c = f_left.shape
    if tuple(grad.shape) != (b, h, w, max_disp) or grad.device != f_left.device:
        raise ValueError(
            f"grad must be ({b}, {h}, {w}, {max_disp}) on {f_left.device}, got "
            f"{tuple(grad.shape)} on {grad.device}"
        )
    if f_right.device != f_left.device:
        raise ValueError(f"f_right is on {f_right.device}, f_left on {f_left.device}")
    sbl = batch_stride(f_left, name)
    sbr = batch_stride(f_right, name)
    if max_disp > 1 and grad.stride(-1) != 1:
        grad = grad.contiguous()
    d_fl = torch.empty((b, h, w, c), dtype=f_left.dtype, device=f_left.device)
    return grad, tuple(grad.stride()[:3]), sbl, sbr, d_fl, torch.empty_like(d_fl)


def launch_backward(
    grad: torch.Tensor, f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_fl, d_fr) from the fp32 backward kernel on CUDA tensors
    (:func:`backward_operands`); counts one ``correlation_bwd`` launch.
    Raises for any dtype but float32."""
    if f_left.dtype != torch.float32 or grad.dtype != torch.float32:
        raise TypeError(
            f"correlation's backward kernel takes float32, not {f_left.dtype} features and a "
            f"{grad.dtype} gradient"
        )
    grad, (sgb, sgh, sgw), sbl, sbr, d_fl, d_fr = backward_operands(
        grad, f_left, f_right, max_disp, "correlation_bwd")
    if d_fl.numel() == 0:
        return d_fl, d_fr
    b, h, w, c = f_left.shape
    err = _build.lib().sde_correlation_bwd(
        grad.data_ptr(), sgb, sgh, sgw, f_left.data_ptr(), sbl, f_right.data_ptr(), sbr,
        d_fl.data_ptr(), d_fr.data_ptr(), b, h, w, c, max_disp,
        f_left.device.index, _build.stream_of(f_left),
    )
    _build.check(err, "correlation_bwd")
    _build.LAUNCHES["correlation_bwd"] += 1
    return d_fl, d_fr


def correlation_backward(
    grad: torch.Tensor, f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_fl, d_fr) for the gradient ``grad`` (B, H, W, max_disp) of the
    cost volume: the backward kernel on CUDA (fp32, :func:`launch_backward`),
    the plain version on the CPU."""
    if f_left.device.type == "cpu":
        return correlation_backward_plain(grad, f_left, f_right, max_disp)
    return launch_backward(grad, f_left, f_right, max_disp)


def _setup_context(ctx, inputs, output):
    f_left, f_right, max_disp = inputs
    ctx.save_for_backward(f_left, f_right)
    ctx.max_disp = max_disp


def _backward(ctx, grad):
    f_left, f_right = ctx.saved_tensors
    d_fl, d_fr = correlation_backward(grad, f_left, f_right, ctx.max_disp)
    return d_fl, d_fr, None


correlation_op.register_autograd(_backward, setup_context=_setup_context)


def correlation(
    f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """The correlation kernel on a CUDA tensor, its plain version on a CPU
    one. On CUDA both inputs must be on one device, of one dtype (float32
    or bfloat16), with rows :func:`batch_stride` reads; anything else
    raises. A call that autograd records goes through the op, whose
    backward is :func:`correlation_backward`."""
    if _build.tracing or _build.needs_grad(f_left, f_right):
        return correlation_op(f_left, f_right, max_disp)
    return _correlation(f_left, f_right, max_disp)
