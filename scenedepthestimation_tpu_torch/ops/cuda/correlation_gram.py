"""correlation_gram: the 1-D stereo cost volume of bf16 features as a banded
Gram on the tensor cores.

``cost[b, h, w, d] = (1/C) * sum_c FL[b, h, w, c] * FR[b, h, w - d, c]``
for d in [0, D), zero where ``w - d < 0``; bf16 products, fp32 sums, the
input's dtype out.

Kernels 7 and 8 of the port, ``csrc/correlation_gram.cu``: the
counterpart of the TPU kernels ``scenedepthestimation_tpu/ops/pallas/
correlation_v2.py::correlation_pallas_v2`` and ``correlation_v3.py::
correlation_pallas_v3``, and of the XLA form the JAX package serves bf16
with, ``ops/correlation.py::_correlation_gram``. :func:`correlation_gram`
launches the kernel for a CUDA tensor and takes
:func:`correlation_gram_plain` for a CPU tensor. Both take the halves of
the stereo tower's interleaved (2B, H, W, C) output as they are: views
with contiguous (W, C) rows and a batch stride of 2*H*W*C.

The backward (:func:`correlation_gram_backward`, registered as the op's
autograd formula) is ``csrc/correlation_gram_bwd.cu``, kernel 7b of the
port: it replaces what XLA derives for ``_correlation_gram`` in the JAX
train steps (the transposed banded ``dot_general``). Both outputs are
``1/C sum_d`` over bf16 products with fp32 sums, rounded to bf16 once;
the kernel runs them as transposed banded Grams on the tensor cores
(blocking: :func:`backward_plan`), and
:func:`correlation_gram_backward_plain` computes the same in PyTorch.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from scenedepthestimation_tpu_torch.ops.cuda import _build
from scenedepthestimation_tpu_torch.ops.cuda.correlation import (
    MAX_D_TILE,
    _check,
    backward_operands,
    batch_stride,
    correlation_backward_plain,
    d_cover,
)

# W tile of the plain version's Gram, as the JAX package's _GRAM_T.
GRAM_T = 64

# The kernel's blocking (csrc/correlation_gram.cu): units of a W_TILE-wide
# W tile and a D tile (all of D up to MAX_D_TILE, else tiles of a multiple
# of 8); a warp an m16 row tile of the W tile against the n8 tiles of its
# band; K_CHUNK channels a stage, STAGES stages in the ring.
W_TILE = 96
K_CHUNK = 64
STAGES = 3


def tile_plan(w: int, c: int, d: int) -> dict:
    """The banded-Gram kernel's blocking for a (W, C) row and D
    disparities: the W tiles, the D cover (tile, tiles), the right-view
    window a unit stages (the W_TILE + TD - 1 columns its band reads), the
    n8 tiles a warp runs over it (covering 16 + TD - 1 window columns,
    rounded up to a pair for ldmatrix), whether a unit's output is one
    contiguous run (all of D in one tile), and the channel chunks and
    stages."""
    td, nd = (d, 1) if d <= MAX_D_TILE else d_cover(d, 8)
    n8 = -(-(td + 15) // 8)
    return {
        "w_tile": W_TILE,
        "w_tiles": -(-w // W_TILE),
        "d_tile": td,
        "d_tiles": nd,
        "window": W_TILE + td - 1,
        "n8_tiles": n8 + n8 % 2,
        "flat_out": nd == 1,
        "k_chunk": K_CHUNK,
        "k_chunks": -(-c // K_CHUNK),
        "stages": STAGES,
    }


# The backward kernel's blocking (csrc/correlation_gram_bwd.cu): units of a
# row's BWD_W_TILE-wide W tile with both outputs, walked by persistent
# blocks of BWD_WARPS warps; warp i < BWD_WARPS / 2 runs d_fl's m16 row
# tile i, the others d_fr's, over the k16 slices its band touches and the
# 8 n8 tiles of a K_CHUNK-channel chunk; D in chunks of at most BWD_MAX_D,
# each a multiple of 8; g's staged rows BWD_G_PITCH values wide (the
# chunk's disparities at column 16, zeros around them, which the band
# gathers read); a warp's output tile 16 rows of BWD_OUT_PITCH values;
# BWD_STAGES ring stages. An SM's SMEM_PER_SM bytes hold as many blocks as
# fit with SMEM_RESERVED bytes each beside their own (two at D <= 48).
BWD_W_TILE = 64
BWD_WARPS = 2 * BWD_W_TILE // 16
BWD_MAX_D = 48
BWD_G_PITCH = 88
BWD_OUT_PITCH = 72
BWD_STAGES = 2
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024


def backward_plan(w: int, c: int, d: int) -> dict:
    """The backward kernel's blocking for a (W, C) row and D disparities:
    the W tiles; the D chunk (the fewest chunks of at most BWD_MAX_D, each
    ceil(d / chunks) rounded up to a multiple of 8: tile, tiles); the band's
    width (min(D, D tile)) and the k16 slices a warp's row tile runs over
    it, ``slices`` = ceil((15 + band) / 16) (a 16-row tile's band spans 16 +
    band - 1 window columns); the window rows each view stages (``window``
    = BWD_W_TILE + 16 (slices - 1)); whether d_fl has g rows of its own (D
    chunks) and the g rows a step stages (the window's, plus BWD_W_TILE);
    the channel chunks; the ring's stages, the shared memory a block takes,
    in bytes (the stages and the warps' output tiles), and the blocks that
    an SM's shared memory holds (registers allow two)."""
    tiles = -(-d // BWD_MAX_D)
    dt = -(-(-(-d // tiles)) // 8) * 8
    nd = -(-d // dt)
    band = min(dt, d)
    slices = -(-(15 + band) // 16)
    window = BWD_W_TILE + 16 * (slices - 1)
    own_fl = nd > 1
    g_rows = window + (BWD_W_TILE if own_fl else 0)
    stage = 2 * window * K_CHUNK + g_rows * BWD_G_PITCH
    shared = 2 * (BWD_STAGES * stage + BWD_WARPS * 16 * BWD_OUT_PITCH)
    return {
        "w_tile": BWD_W_TILE,
        "w_tiles": -(-w // BWD_W_TILE),
        "d_tile": dt,
        "d_tiles": nd,
        "band": band,
        "slices": slices,
        "window": window,
        "own_fl_rows": own_fl,
        "g_rows": g_rows,
        "k_chunk": K_CHUNK,
        "k_chunks": -(-c // K_CHUNK),
        "warps": BWD_WARPS,
        "stages": BWD_STAGES,
        "shared_bytes": shared,
        "smem_blocks_per_sm": SMEM_PER_SM // (shared + SMEM_RESERVED),
    }


def correlation_gram_plain(
    f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Plain PyTorch version, the JAX package's tiled banded Gram: W cut
    into T-wide tiles, each tile's fp32 Gram against its reversed
    (T+D-1)-wide right window, the band read as a strided slice.
    (B, H, W, C) x2 -> (B, H, W, max_disp) in the input's dtype."""
    _check(f_left, f_right, max_disp)
    b, h, w, c = f_left.shape
    d, t, bh = max_disp, GRAM_T, b * h
    nt = -(-w // t)
    wt = nt * t
    tw = t + d - 1
    # Right-pad FL's W to the tile grid (zero rows, sliced off at the end).
    fl = F.pad(f_left.reshape(bh, w, c).float(), (0, 0, 0, wt - w))
    # FRpad[p] = F_R[p - (D-1)], right-padded so every window is in range.
    fr = F.pad(f_right.reshape(bh, w, c).float(), (0, 0, d - 1, wt - w))
    # frw[:, t0, :, j] = FRpad[t0*T + (Tw-1-j)]: (BH, nt, C, Tw).
    frw = fr.unfold(1, tw, t).flip(-1)
    # G[u, j] = sum_c FL[t0*T + u, c] * FRpad[t0*T + Tw-1-j, c]: (BH, nt, T, Tw).
    g = torch.matmul(fl.reshape(bh, nt, t, c), frw)
    # cost[x, d'] = G[u, (T-1) - u + d'], flat index (T-1) + u*(Tw-1) + d'.
    band = g.reshape(bh, nt, t * tw)[..., t - 1 : t - 1 + t * (tw - 1)]
    band = band.reshape(bh, nt, t, tw - 1)[..., :d]
    cost = (band * (1.0 / c)).to(f_left.dtype)
    return cost.reshape(bh, wt, d)[:, :w].reshape(b, h, w, d)


def _correlation_gram(
    f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """The body of :func:`correlation_gram`, and the implementation of its op."""
    if f_left.device.type == "cpu":
        return correlation_gram_plain(f_left, f_right, max_disp)
    if f_left.device.type != "cuda":
        raise ValueError(f"correlation_gram runs on cpu or cuda, not {f_left.device}")
    _check(f_left, f_right, max_disp)
    if f_right.device != f_left.device:
        raise ValueError(f"f_right is on {f_right.device}, f_left on {f_left.device}")
    if f_left.dtype != torch.bfloat16:
        raise TypeError(f"correlation_gram kernel takes bfloat16, not {f_left.dtype}")
    sbl = batch_stride(f_left, "correlation_gram")
    sbr = batch_stride(f_right, "correlation_gram")
    b, h, w, c = f_left.shape
    out = torch.empty((b, h, w, max_disp), dtype=f_left.dtype, device=f_left.device)
    if out.numel() == 0:
        return out
    td = tile_plan(w, c, max_disp)["d_tile"]
    err = _build.lib().sde_correlation_gram(
        f_left.data_ptr(), sbl, f_right.data_ptr(), sbr, out.data_ptr(),
        b, h, w, c, max_disp, td, f_left.device.index, _build.stream_of(f_left),
    )
    _build.check(err, "correlation_gram")
    _build.LAUNCHES["correlation_gram"] += 1
    return out


def _correlation_gram_fake(f_left, f_right, max_disp):
    return f_left.new_empty(tuple(f_left.shape[:3]) + (max_disp,))


correlation_gram_op = _build.register_op(
    "correlation_gram",
    "(Tensor f_left, Tensor f_right, int max_disp) -> Tensor",
    _correlation_gram, _correlation_gram_fake,
)


def correlation_gram_backward_plain(
    grad: torch.Tensor, f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: ``d_fl[w] = 1/C sum_d g[w, d]
    fr[w - d]`` and ``d_fr[w] = 1/C sum_d g[w + d, d] fl[w + d]`` over the
    inputs widened to fp32, d ascending, the 1/C last, each output rounded
    once to the features' dtype (``correlation_backward_plain``'s sums)."""
    return correlation_backward_plain(grad, f_left, f_right, max_disp)


def correlation_gram_backward(
    grad: torch.Tensor, f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_fl, d_fr) for the gradient ``grad`` (B, H, W, max_disp) of the
    cost volume: the backward kernel in bf16 on CUDA (``grad`` read through
    its strides, so the slice the aggregation's concat hands back is not
    copied; the features as :func:`correlation_gram` reads them), the plain
    version on the CPU."""
    if f_left.device.type == "cpu":
        return correlation_gram_backward_plain(grad, f_left, f_right, max_disp)
    if f_left.dtype != torch.bfloat16 or grad.dtype != torch.bfloat16:
        raise TypeError(
            f"correlation_gram's backward kernel takes bfloat16, not {f_left.dtype} features "
            f"and a {grad.dtype} gradient"
        )
    grad, (sgb, sgh, sgw), sbl, sbr, d_fl, d_fr = backward_operands(
        grad, f_left, f_right, max_disp, "correlation_gram_bwd")
    if d_fl.numel() == 0:
        return d_fl, d_fr
    b, h, w, c = f_left.shape
    err = _build.lib().sde_correlation_gram_bwd(
        grad.data_ptr(), sgb, sgh, sgw, f_left.data_ptr(), sbl, f_right.data_ptr(), sbr,
        d_fl.data_ptr(), d_fr.data_ptr(), b, h, w, c, max_disp,
        f_left.device.index, _build.stream_of(f_left),
    )
    _build.check(err, "correlation_gram_bwd")
    _build.LAUNCHES["correlation_gram_bwd"] += 1
    return d_fl, d_fr


def _setup_context(ctx, inputs, output):
    f_left, f_right, max_disp = inputs
    ctx.save_for_backward(f_left, f_right)
    ctx.max_disp = max_disp


def _backward(ctx, grad):
    f_left, f_right = ctx.saved_tensors
    d_fl, d_fr = correlation_gram_backward(grad, f_left, f_right, ctx.max_disp)
    return d_fl, d_fr, None


correlation_gram_op.register_autograd(_backward, setup_context=_setup_context)


def correlation_gram(
    f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """The banded-Gram kernel on a CUDA tensor, its plain version on a CPU
    one. On CUDA both inputs must be bfloat16 on one device, with rows
    ``correlation.batch_stride`` reads; anything else raises (float32
    features take the correlation kernel). A call that autograd records
    goes through the op, whose backward is :func:`correlation_gram_backward`."""
    if _build.tracing or _build.needs_grad(f_left, f_right):
        return correlation_gram_op(f_left, f_right, max_disp)
    return _correlation_gram(f_left, f_right, max_disp)
