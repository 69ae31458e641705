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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scenedepthestimation_tpu_torch.ops.cuda import _build
from scenedepthestimation_tpu_torch.ops.cuda.correlation import (
    MAX_D_TILE,
    _check,
    batch_stride,
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


def correlation_gram(
    f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """The banded-Gram kernel on a CUDA tensor, its plain version on a CPU
    one. On CUDA both inputs must be bfloat16 on one device, with rows
    ``correlation.batch_stride`` reads; anything else raises (float32
    features take the correlation kernel)."""
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
