"""conv3x3's bf16 backward and BatchNorm in bf16, the ops of the port's bf16
mono training, against a float64 oracle, ``jax.vjp`` of the JAX conv in bf16
and Flax's ``nn.BatchNorm(dtype=bf16)``, on inputs made with numpy from a
seed; and numpy emulations of the bf16 kernels' schedules, read at their
lanes' and descriptors' offsets: the mma.sync and wgmma dW kernels, the
wgmma dx interior and its tilings, the slab of w' that both dx kernels
read, the tensor-core fold and its two roundings.

The port's wrappers take their plain versions here: every tensor lies on the
CPU. chip_smoke.py (phase 23) holds the CUDA kernels to those plain versions
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from torch_threads import two_threads  # noqa: F401 (autouse)

from scenedepthestimation_tpu.ops.pallas.conv_block import conv3x3_xla
from scenedepthestimation_tpu_torch.models import resnet
from scenedepthestimation_tpu_torch.ops.cuda import conv_block
from test_torch_mono_train_ops import _OnCard, _src_index

BF16 = torch.bfloat16


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (nearest even), held in float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16).float().numpy()


def _spacing(v: float) -> float:
    """The bf16 spacing at magnitude v: 2^(e - 7) for v in [2^e, 2^(e + 1))."""
    return 2.0 ** (np.floor(np.log2(v)) - 7) if v > 0 else 0.0


def _inputs(seed, b, h, w, cin, cout, act, border):
    """bf16 (g, out, x, w, b) of a conv3x3: the port's forward output (fp32
    for the sigmoid head, as the DispHead emits it) and a gradient of its
    dtype."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, h, w, cin)).astype(np.float32)).to(BF16)
    wt = torch.from_numpy((rng.normal(size=(cout, cin, 3, 3)) / np.sqrt(9 * cin))
                          .astype(np.float32)).to(BF16)
    bias = torch.from_numpy((0.1 * rng.normal(size=(cout,))).astype(np.float32)).to(BF16)
    od = torch.float32 if act == "sigmoid" else BF16
    out = conv_block.conv3x3_plain(x, wt, bias, act, border, out_dtype=od)
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32)).to(od)
    return g, out, x, wt, bias


def _fold_lines(h, w, border) -> np.ndarray:
    """(H, W) mask of the pixels the border's gradient folds onto."""
    mask = np.zeros((h, w), bool)
    if border != "zero":
        for r in {_src_index(-1, h, border), _src_index(h, h, border)}:
            mask[r] = True
        for c in {_src_index(-1, w, border), _src_index(w, w, border)}:
            mask[:, c] = True
    return mask


# (B, H, W, Cin, Cout, activation, border): the bench decoder's kinds (ELU,
# the sigmoid heads' Cout = 1) at Cin and Cout off 16, W off 16, H = 1, 1-
# and 2-pixel axes, under the reflect, edge and zero borders.
BF16_CASES = [
    (2, 6, 10, 5, 7, "elu", "reflect"),
    (1, 5, 19, 24, 3, "elu", "edge"),
    (2, 4, 7, 16, 10, "elu", "zero"),
    (2, 6, 12, 16, 1, "sigmoid", "reflect"),
    (1, 1, 18, 4, 5, "elu", "reflect"),
    (1, 2, 5, 3, 33, "elu", "reflect"),
    (1, 5, 1, 40, 2, "elu", "edge"),
    (2, 2, 2, 3, 1, "sigmoid", "zero"),
    (1, 7, 17, 96, 32, "elu", "reflect"),
    (1, 3, 9, 9, 6, "none", "edge"),
]


@pytest.mark.parametrize("case", BF16_CASES, ids=lambda c: "-".join(map(str, c)))
def test_conv3x3_bf16_backward_within_a_spacing_of_float64(case):
    """conv3x3_backward_plain on bf16 inputs (what the CPU path's op backward
    runs, and what the card's kernels are held to) returns bf16 dx, dW and db
    within one bf16 spacing of each output's largest magnitude of a float64
    run of the same backward on the same bf16 values (dx on the fold lines
    within two: it is rounded twice); autograd through the op gives the same
    bits."""
    g, out, x, wt, bias = _inputs(BF16_CASES.index(case), *case)
    act, border = case[5], case[6]
    got = conv_block.conv3x3_backward_plain(g, out, x, wt, act, border)
    ref = conv_block.conv3x3_backward_plain(g.double(), out.double(), x.double(), wt.double(),
                                            act, border)
    xl, wl, bl = (t.clone().requires_grad_() for t in (x, wt, bias))
    y = conv_block.conv3x3(xl, wl, bl, act, border, out_dtype=out.dtype)
    via = torch.autograd.grad(y, (xl, wl, bl), g)
    fold = _fold_lines(case[1], case[2], border)[None, :, :, None]
    for name, a, r, v in zip(("dx", "dw", "db"), got, ref, via):
        assert a.dtype == BF16 and a.shape == r.shape, name
        assert torch.equal(a, v), name
        r = r.numpy()
        tol = _spacing(np.abs(r).max()) * (np.where(fold, 2.0, 1.0) if name == "dx" else 1.0)
        assert (np.abs(_np(a) - r) <= tol).all(), (name, np.abs(_np(a) - r).max(), tol)


def _jax_conv_bf16(x, k, b, act, border):
    """The JAX bf16 decoder conv: conv3x3_xla (the ConvBlock's, reflect; the
    same conv on an edge or zero pad otherwise), the conv rounded to bf16,
    the bias added and the ELU taken in bf16; the head as the bf16 DispHead
    computes it, the conv in bf16 and the sigmoid in fp32."""
    if border == "reflect":
        y = conv3x3_xla(x, k, b, "elu" if act == "elu" else "none")
    else:
        mode = "edge" if border == "edge" else "constant"
        xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode=mode)
        y = jax.lax.conv_general_dilated(xp, k, (1, 1), "VALID",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
        if act == "elu":
            y = jax.nn.elu(y)
    return jax.nn.sigmoid(y.astype(jnp.float32)) if act == "sigmoid" else y


@pytest.mark.parametrize("case", [c for c in BF16_CASES if c[1] > 1 and c[2] > 1],
                         ids=lambda c: "-".join(map(str, c)))
def test_conv3x3_bf16_backward_against_jax_vjp(case):
    """The port's bf16 backward against jax.vjp of the JAX bf16 conv, each
    package differentiating its own bf16 forward at the same bf16 x, weight,
    bias and gradient: each of dx, dW and db lies within JAX's own distance
    from the float64 run plus one bf16 spacing (of the float64 output's
    largest magnitude) of JAX's. JAX rounds the conv, the bias and the ELU
    to bf16 in its forward, differentiates at its bf16 pre-activation and
    sums its bias gradient in bf16. Measured over these cases, in spacings:
    port - JAX at most 1.0 (dx), 1.0 (dW), 3.0 (db); JAX - float64 at most
    0.77, 0.65, 2.77; port - float64 at most 0.77, 0.67, 0.60."""
    g, out, x, wt, bias = _inputs(BF16_CASES.index(case) + 50, *case)
    act, border = case[5], case[6]
    jx, jk, jb = (jnp.asarray(_np(t), jnp.bfloat16) for t in (x, wt.permute(2, 3, 1, 0), bias))
    jout, vjp = jax.vjp(lambda a, kk, bb: _jax_conv_bf16(a, kk, bb, act, border), jx, jk, jb)
    want = [np.asarray(v, np.float32) for v in vjp(jnp.asarray(_np(g), jout.dtype))]
    want[1] = want[1].transpose(3, 2, 0, 1)
    got = conv_block.conv3x3_backward_plain(g, out, x, wt, act, border)
    ref = conv_block.conv3x3_backward_plain(g.double(), out.double(), x.double(), wt.double(),
                                            act, border)
    for name, a, w, r in zip(("dx", "dw", "db"), got, want, ref):
        r = r.numpy()
        sp = _spacing(np.abs(r).max())
        assert np.abs(_np(a) - w).max() <= np.abs(w - r).max() + sp, name


# ---------------------------------------------------------------------------
# The tensor-core dW kernel's schedule (conv3x3_dw_tc_kernel)
# ---------------------------------------------------------------------------

LANES = np.arange(32)
G_, Q_ = LANES >> 2, LANES & 3
TH, TW = 8, 16


def _tc_cfg(cin, cout):
    """csrc/conv3x3_bwd.cu's with_dw_tc_cfg (Cout 2-16): (WMT, WM, WN, WK)."""
    wn = 2 if cin <= 16 else 4
    return 1, 1, wn, 8 // wn


def _ldsm_trans(smem, addrs, nmat):
    """ldmatrix.x{nmat}.trans: matrix j's 8 rows at the element offsets of
    lanes 8j .. 8j + 7; lane (g, q) gets rows 2q and 2q + 1 of column g.
    -> (32 lanes, nmat, 2)."""
    out = np.zeros((32, nmat, 2), np.float32)
    for j in range(nmat):
        rows = smem[addrs[8 * j:8 * j + 8, None] + np.arange(8)]
        out[:, j, 0], out[:, j, 1] = rows[2 * Q_, G_], rows[2 * Q_ + 1, G_]
    return out


def _mma(c, a, b):
    """mma.m16n8k16 (bf16 in, fp32 sums) on fragments: c (32, 4) += A @ B,
    with A from a (32, 4, 2) and B from b (32, 2, 2) by the fragment
    layouts."""
    A, B = np.zeros((16, 16), np.float32), np.zeros((16, 8), np.float32)
    for r, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        A[G_ + dm, 2 * Q_ + dk], A[G_ + dm, 2 * Q_ + dk + 1] = a[:, r, 0], a[:, r, 1]
    for r in range(2):
        B[2 * Q_ + 8 * r, G_], B[2 * Q_ + 8 * r + 1, G_] = b[:, r, 0], b[:, r, 1]
    d = A @ B
    c[:, 0] += d[G_, 2 * Q_]
    c[:, 1] += d[G_, 2 * Q_ + 1]
    c[:, 2] += d[G_ + 8, 2 * Q_]
    c[:, 3] += d[G_ + 8, 2 * Q_ + 1]


def _dw_tc_emulation(dpre, x, border, slices):
    """conv3x3_dw_tc_kernel + conv3x3_dw_reduce_kernel in numpy: per block a
    BM x BN tile of (co, ci); strips of 8 x 16 output pixels, each staged
    once (the dpre tile and the 10 x 18 halo with the border from indices,
    zero past the image, Cout and Cin) at the kernel's pitches; each warp
    reads its A fragments (ldmatrix.x4.trans at its lanes' offsets) once a
    strip row and the B fragments of two taps a time from the halo shifted
    by the tap, db against a B of ones; the row groups' sums meet in group
    order, the slices' in the reduce's order (eight groups of slices, then
    the groups), one rounding to bf16. -> (dW, db) fp32 sums and bf16."""
    b, h, w, cout = dpre.shape
    cin = x.shape[-1]
    wmt, wm, wn, wk = _tc_cfg(cin, cout)
    bm, bn = 16 * wmt * wm, 8 * wn
    dp, xp = bm + 8, bn + 8
    n_dpre = TH * TW * dp
    sh, sw = -(-h // TH), -(-w // TW)
    strips = b * sh * sw
    per = -(-strips // slices)
    n_cols = 9 * cin + 1
    ws = []
    ones = np.ones((32, 2, 2), np.float32)
    for s_lo in range(0, strips, per):
        part = np.zeros((cout, n_cols), np.float32)
        for co0 in range(0, cout, bm):
            for ci0 in range(0, cin, bn):
                acc = {(a, bb, c): [np.zeros((32, 4), np.float32) for _ in range(9 * wmt)]
                       for a in range(wm) for bb in range(wn) for c in range(wk)}
                dacc = {k: [np.zeros((32, 4), np.float32) for _ in range(wmt)] for k in acc}
                for s in range(s_lo, min(strips, s_lo + per)):
                    bb_, rest = divmod(s, sh * sw)
                    oy0, ox0 = (rest // sw) * TH, (rest % sw) * TW
                    smem = np.zeros(n_dpre + (TH + 2) * (TW + 2) * xp, np.float32)
                    for p in range(TH * TW):
                        oy, ox = oy0 + p // TW, ox0 + p % TW
                        if oy < h and ox < w:
                            v = dpre[bb_, oy, ox, co0:co0 + bm]
                            smem[p * dp:p * dp + len(v)] = v
                    for pos in range((TH + 2) * (TW + 2)):
                        hs = _src_index(oy0 - 1 + pos // (TW + 2), h, border)
                        wsrc = _src_index(ox0 - 1 + pos % (TW + 2), w, border)
                        if hs >= 0 and wsrc >= 0:
                            v = x[bb_, hs, wsrc, ci0:ci0 + bn]
                            smem[n_dpre + pos * xp:n_dpre + pos * xp + len(v)] = v
                    for (wm_, wn_, wk_), a_acc in acc.items():
                        for rr in range(wk_, TH, wk):
                            if oy0 + rr >= h:
                                break
                            a_pix = (LANES & 7) + ((LANES >> 4) & 1) * 8
                            a_col = wm_ * wmt * 16 + ((LANES >> 3) & 1) * 8
                            af = [_ldsm_trans(smem, (rr * TW + a_pix) * dp + a_col + i * 16, 4)
                                  for i in range(wmt)]
                            for t in range(0, 8, 2):
                                tap = t + (LANES >> 4)
                                addr = n_dpre + ((rr + tap // 3) * (TW + 2) + (LANES & 15)
                                                 + tap % 3) * xp + wn_ * 8
                                bf = _ldsm_trans(smem, addr, 4)
                                for i in range(wmt):
                                    _mma(a_acc[t * wmt + i], af[i], bf[:, 0:2])
                                    _mma(a_acc[(t + 1) * wmt + i], af[i], bf[:, 2:4])
                            addr = n_dpre + ((rr + 2) * (TW + 2) + (LANES & 15) + 2) * xp + wn_ * 8
                            bl = _ldsm_trans(smem, addr, 2)
                            for i in range(wmt):
                                _mma(a_acc[8 * wmt + i], af[i], bl)
                            if wn_ == 0:
                                for i in range(wmt):
                                    _mma(dacc[(wm_, wn_, wk_)][i], af[i], ones)
                red = np.zeros((bm, bn, 9), np.float32)
                dred = np.zeros(bm, np.float32)
                for group in range(wk):
                    for (wm_, wn_, wk_), a_acc in acc.items():
                        if wk_ != group:
                            continue
                        for i in range(wmt):
                            for hh in range(2):
                                m = wm_ * wmt * 16 + i * 16 + G_ + 8 * hh
                                for e in range(2):
                                    n = wn_ * 8 + 2 * Q_ + e
                                    for t in range(9):
                                        red[m, n, t] += a_acc[t * wmt + i][:, 2 * hh + e]
                                if wn_ == 0:
                                    sel = Q_ == 0
                                    dred[m[sel]] += dacc[(wm_, wn_, wk_)][i][sel, 2 * hh]
                for m in range(min(bm, cout - co0)):
                    nn_ = min(bn, cin - ci0)
                    part[co0 + m, ci0 * 9:(ci0 + nn_) * 9] = red[m, :nn_].reshape(-1)
                    if ci0 == 0:
                        part[co0 + m, 9 * cin] = dred[m]
        ws.append(part)
    groups = [np.zeros_like(ws[0]) for _ in range(8)]
    for sl, part in enumerate(ws):
        groups[sl % 8] += part
    total = groups[0].copy()
    for q in groups[1:]:
        total += q
    dw = total[:, :9 * cin].reshape(cout, cin, 3, 3)
    return dw, total[:, 9 * cin], _bf16(dw), _bf16(total[:, 9 * cin])


@pytest.mark.parametrize("case", [
    (1, 9, 20, 20, 12, "reflect", 2), (2, 5, 7, 16, 16, "edge", 3),
    (1, 8, 16, 33, 2, "reflect", 1), (1, 3, 18, 8, 9, "zero", 2),
    (2, 1, 5, 40, 5, "reflect", 9)], ids=lambda c: "-".join(map(str, c)))
def test_dw_tc_schedule_matches_the_definition(case):
    """The mma.sync dW kernel's schedule (Cout 2-16, where dw_route sends
    it), emulated in numpy at its lanes' fragment offsets (both of
    with_dw_tc_cfg's input tile widths, Cout off 8 and 16, ragged strips,
    slices beyond eight), sums to the definition (conv3x3_dw_plain's fp32
    autograd, on the same bf16 values) within 1e-5 x max|ref|, and its one
    rounding to bf16 lies within one spacing of the plain version's bf16 dW
    and db."""
    b, h, w, cin, cout, border, slices = case
    assert conv_block.dw_route(cin, cout, BF16) == 1
    rng = np.random.default_rng(h * w + cin)
    dpre = _bf16(rng.normal(size=(b, h, w, cout)))
    x = _bf16(rng.normal(size=(b, h, w, cin)))
    td, tx = torch.from_numpy(dpre), torch.from_numpy(x)
    ref32 = [_np(t) for t in conv_block.conv3x3_dw_plain(td, tx, border)]
    ref16 = [_np(t) for t in conv_block.conv3x3_dw_plain(td.to(BF16), tx.to(BF16), border)]
    dw, db, dw16, db16 = _dw_tc_emulation(dpre, x, border, slices)
    for got, r32, got16, r16 in ((dw, ref32[0], dw16, ref16[0]), (db, ref32[1], db16, ref16[1])):
        scale = np.abs(r32).max()
        np.testing.assert_allclose(got, r32, rtol=0, atol=1e-5 * scale)
        assert np.abs(got16 - r16).max() <= _spacing(np.abs(r16).max())


# ---------------------------------------------------------------------------
# The wgmma kernels' schedules: dW (conv3x3_dw_wgmma_kernel) and dx's
# interior (conv3x3_dx_wgmma_kernel)
# ---------------------------------------------------------------------------


def _a_tile(a):
    """The 16 x 16 A operand a warp holds in the mma.m16n8k16 (and wgmma)
    fragment layout: a (32 lanes, 4 registers, 2 values)."""
    A = np.zeros((16, 16), np.float32)
    for r, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        A[G_ + dm, 2 * Q_ + dk], A[G_ + dm, 2 * Q_ + dk + 1] = a[:, r, 0], a[:, r, 1]
    return A


def _ldsm(smem, addrs, nmat):
    """ldmatrix.x{nmat} (not transposed): matrix j's 8 rows at the element
    offsets of lanes 8j .. 8j + 7; lane (g, q) gets elements 2q and 2q + 1
    of row g. -> (32 lanes, nmat, 2)."""
    out = np.zeros((32, nmat, 2), np.float32)
    for j in range(nmat):
        rows = smem[addrs[8 * j:8 * j + 8, None] + np.arange(8)]
        out[:, j, 0], out[:, j, 1] = rows[G_, 2 * Q_], rows[G_, 2 * Q_ + 1]
    return out


def _desc_read(smem, start, lbo, sbo, n, mn_major):
    """The 16 x n B operand wgmma reads through a no-swizzle descriptor
    (offsets in elements): 8 x 8 core matrices of 8 contiguous rows of 8
    elements; K-major, a row is 8 k of one n, MN-major 8 n of one k; lbo
    apart in K, sbo apart in N."""
    k = np.arange(16)[:, None]
    c = np.arange(n)[None, :]
    core = start + (k // 8) * lbo + (c // 8) * sbo
    return smem[core + ((k % 8) * 8 + c % 8 if mn_major else (c % 8) * 8 + k % 8)]


def _desc_read_a(smem, start, lbo, sbo, mn_major):
    """The 64 x 16 A operand wgmma reads through a no-swizzle descriptor
    (offsets in elements): K-major, a core matrix row is 8 k of one m;
    MN-major, 8 m of one k; lbo apart in K, sbo apart in M."""
    m = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    core = start + (k // 8) * lbo + (m // 8) * sbo
    return smem[core + ((k % 8) * 8 + m % 8 if mn_major else (m % 8) * 8 + k % 8)]


# csrc/conv3x3_bwd.cu's wgmma dW layout: 8 x 16 strips; the halo's pixels a
# channel group (one past a multiple of 8); the dpre tile's pixel pitch.
WG_NPOS = 10 * 18
WG_NP = -(-WG_NPOS // 8) * 8 + 1
WG_DP = 64 + 8


def _dw_wgmma_emulation(dpre, x, border, slices):
    """conv3x3_dw_wgmma_kernel + conv3x3_dw_reduce_kernel in numpy: a block
    per 64 output x BN input channels (16, 32, 48 or 64 by Cin) for the 9
    taps;
    strips of 8 x 16 output pixels in slices, each staged once at the
    kernel's offsets, the dpre tile pixel-major at a pitch of WG_DP and the
    halo (border from indices, zero past the image, Cout and Cin) as
    [channels / 8][pixel][8] (WG_NP pixels a group); per strip row (those
    past H, whose dpre is zero, left out) the four warps' A fragments by
    ldmatrix.x4.trans at their lanes' offsets, and warpgroup wg's three taps
    (wg, kx) as m64nBNk16 with B read through the MN-major descriptor from
    halo pixel (rr + wg, kx); db as A against ones (written from the first
    Cin tile);
    slices summed in the reduce's order, one rounding. -> (dW, db) fp32
    sums and bf16."""
    b, h, w, cout = dpre.shape
    cin = x.shape[-1]
    bn = (16 if cin <= 16 else 32 if cin <= 32 else 48 if cin % 64 and cin % 48 == 0
          else 32 if cin % 64 and cin % 32 == 0 else 64)
    n_dpre = TH * TW * WG_DP
    sh, sw = -(-h // TH), -(-w // TW)
    strips = b * sh * sw
    per = -(-strips // slices)
    n_cols = 9 * cin + 1
    ws = []
    for s_lo in range(0, strips, per):
        part = np.zeros((cout, n_cols), np.float32)
        for co0 in range(0, cout, 64):
            for ci0 in range(0, cin, bn):
                acc = np.zeros((9, 64, bn), np.float32)
                dacc = np.zeros(64, np.float32)
                for s in range(s_lo, min(strips, s_lo + per)):
                    bb_, rest = divmod(s, sh * sw)
                    oy0, ox0 = (rest // sw) * TH, (rest % sw) * TW
                    smem = np.zeros(n_dpre + bn // 8 * WG_NP * 8, np.float32)
                    for p in range(TH * TW):
                        oy, ox = oy0 + p // TW, ox0 + p % TW
                        if oy < h and ox < w:
                            v = dpre[bb_, oy, ox, co0:co0 + 64]
                            smem[p * WG_DP:p * WG_DP + len(v)] = v
                    for pos in range(WG_NPOS):
                        hs = _src_index(oy0 - 1 + pos // 18, h, border)
                        wsrc = _src_index(ox0 - 1 + pos % 18, w, border)
                        if hs >= 0 and wsrc >= 0:
                            for n, v in enumerate(x[bb_, hs, wsrc, ci0:ci0 + bn]):
                                smem[n_dpre + ((n // 8) * WG_NP + pos) * 8 + n % 8] = v
                    for rr in range(min(TH, h - oy0)):
                        a = np.zeros((64, 16), np.float32)
                        for wq in range(4):
                            addrs = ((rr * TW + (LANES & 7) + ((LANES >> 4) & 1) * 8) * WG_DP
                                     + wq * 16 + ((LANES >> 3) & 1) * 8)
                            a[wq * 16:wq * 16 + 16] = _a_tile(_ldsm_trans(smem, addrs, 4))
                        for wg in range(3):
                            for kx in range(3):
                                bt = _desc_read(smem, n_dpre + ((rr + wg) * 18 + kx) * 8, 64,
                                                WG_NP * 8, bn, True)
                                acc[wg * 3 + kx] += a @ bt
                        if ci0 == 0:
                            dacc += a @ np.ones(16, np.float32)
                m_n, n_n = min(64, cout - co0), min(bn, cin - ci0)
                part[co0:co0 + m_n, ci0 * 9:(ci0 + n_n) * 9] = \
                    acc[:, :m_n, :n_n].transpose(1, 2, 0).reshape(m_n, -1)
                if ci0 == 0:
                    part[co0:co0 + m_n, 9 * cin] = dacc[:m_n]
        ws.append(part)
    groups = [np.zeros_like(ws[0]) for _ in range(8)]
    for sl, part in enumerate(ws):
        groups[sl % 8] += part
    total = groups[0].copy()
    for q in groups[1:]:
        total += q
    dw = total[:, :9 * cin].reshape(cout, cin, 3, 3)
    return dw, total[:, 9 * cin], _bf16(dw), _bf16(total[:, 9 * cin])


@pytest.mark.parametrize("case", [
    (1, 9, 20, 20, 24, "reflect", 2), (2, 5, 7, 16, 40, "edge", 3),
    (1, 3, 18, 8, 17, "zero", 2), (1, 8, 16, 96, 64, "reflect", 1),
    (2, 1, 5, 40, 72, "reflect", 9), (1, 10, 33, 64, 20, "edge", 4),
    (1, 4, 6, 5, 96, "reflect", 1), (1, 6, 9, 72, 33, "zero", 3)],
    ids=lambda c: "-".join(map(str, c)))
def test_dw_wgmma_schedule_matches_the_definition(case):
    """The wgmma dW kernel's schedule, emulated in numpy at its lanes' and
    descriptors' offsets (each of its input tile widths 16, 32, 48 and 64, Cout
    off 64 and above it, Cin and Cout off 8 and 16, ragged strips, H below a
    strip, slices beyond eight), sums to the definition (conv3x3_dw_plain's
    fp32 autograd on the same bf16 values) within 1e-5 x max|ref|, and its
    one rounding to bf16 lies within one spacing of the plain version's bf16
    dW and db."""
    b, h, w, cin, cout, border, slices = case
    assert conv_block.dw_route(cin, cout, BF16) == 2
    rng = np.random.default_rng(h * w + cin + 1)
    dpre = _bf16(rng.normal(size=(b, h, w, cout)))
    x = _bf16(rng.normal(size=(b, h, w, cin)))
    td, tx = torch.from_numpy(dpre), torch.from_numpy(x)
    ref32 = [_np(t) for t in conv_block.conv3x3_dw_plain(td, tx, border)]
    ref16 = [_np(t) for t in conv_block.conv3x3_dw_plain(td.to(BF16), tx.to(BF16), border)]
    dw, db, dw16, db16 = _dw_wgmma_emulation(dpre, x, border, slices)
    for got, r32, got16, r16 in ((dw, ref32[0], dw16, ref16[0]), (db, ref32[1], db16, ref16[1])):
        scale = np.abs(r32).max()
        np.testing.assert_allclose(got, r32, rtol=0, atol=1e-5 * scale)
        assert np.abs(got16 - r16).max() <= _spacing(np.abs(r16).max())


@pytest.mark.parametrize("cin,cout,want", [
    (512, 256, 2), (96, 32, 2), (64, 17, 2), (32, 16, 1), (16, 16, 1), (128, 1, 3),
    (16, 1, 3), (5, 3, 1)])
def test_dw_route_takes_wgmma_above_16_output_channels(cin, cout, want):
    """bf16 dW runs on the wgmma kernel where Cout > 16, on the heads'
    CUDA-core kernel at Cout = 1 and on the mma.sync kernel between; fp32 on
    the CUDA-core kernel."""
    assert conv_block.dw_route(cin, cout, BF16) == want
    assert conv_block.dw_route(cin, cout, torch.float32) == 0
    assert conv_block.DW_KERNELS[want] == {1: "conv3x3_dw_bf16_mma", 2: "conv3x3_dw_bf16",
                                           3: "conv3x3_dw_bf16_head"}[want]


def _dw_head_emulation(dpre, x, border, slices):
    """conv3x3_dw_head_kernel + conv3x3_dw_reduce_kernel in numpy: a block
    per C input channels (16, 32, 64 by Cin, else 128) with strips of 8 x TW
    output pixels (TW 64, 32, 16, 16) in slices; per strip the dpre tile
    (zero past the image) and the halo (border from indices, zero past the
    image under the zero border and past Cin) staged once; a thread a
    channel pair of a pixel lane, lane l walking rows and columns of its
    share (C 16 and 32: 8 rows of 64 / 4 and 32 / 2 columns; C 64: one row
    of 16; C 128: two rows of 16) with the 3 x 3 window slid a column a
    pixel, 18 fp32 FMAs a pixel in column order; the lanes' sums added in
    lane order, the slices in the reduce's. -> (dW, db) fp32 and bf16."""
    b, h, w, _ = dpre.shape
    cin = x.shape[-1]
    c_t, tw = (16, 64) if cin <= 16 else (32, 32) if cin <= 32 else (64, 16) if cin <= 64 \
        else (128, 16)
    lanes = 256 // (c_t // 2)
    rpl, segs = (1, lanes // 8) if lanes >= 8 else (8 // lanes, 1)
    seg = tw // segs
    sh, sw = -(-h // 8), -(-w // tw)
    strips = b * sh * sw
    per = -(-strips // slices)
    ws = []
    for s_lo in range(0, strips, per):
        part = np.zeros(9 * cin + 1, np.float32)
        for ci0 in range(0, cin, c_t):
            acc = np.zeros((lanes, c_t, 9), np.float32)
            dsum = np.zeros(lanes, np.float32)
            for s in range(s_lo, min(strips, s_lo + per)):
                bb, rest = divmod(s, sh * sw)
                oy0, ox0 = (rest // sw) * 8, (rest % sw) * tw
                halo = np.zeros((10, tw + 2, c_t), np.float32)
                for r in range(10):
                    for c in range(tw + 2):
                        hs = _src_index(oy0 - 1 + r, h, border)
                        ws_ = _src_index(ox0 - 1 + c, w, border)
                        if hs >= 0 and ws_ >= 0:
                            v = x[bb, hs, ws_, ci0:ci0 + c_t]
                            halo[r, c, :len(v)] = v
                dp = np.zeros((8, tw), np.float32)
                ys, xs = min(8, h - oy0), min(tw, w - ox0)
                dp[:ys, :xs] = dpre[bb, oy0:oy0 + ys, ox0:ox0 + xs, 0]
                for lane in range(lanes):
                    row0 = (lane % min(lanes, 8)) * rpl
                    col0 = (lane // 8 if lanes >= 8 else 0) * seg
                    for r in range(row0, row0 + rpl):
                        for c in range(col0, col0 + seg):
                            d = dp[r, c]
                            dsum[lane] += d
                            win = halo[r:r + 3, c:c + 3]  # (ky, kx, channel)
                            acc[lane] += d * win.transpose(2, 0, 1).reshape(c_t, 9)
            tot = acc[0].copy()
            d0 = dsum[0]
            for lane in range(1, lanes):
                tot += acc[lane]
                d0 += dsum[lane]
            n_n = min(c_t, cin - ci0)
            part[ci0 * 9:(ci0 + n_n) * 9] = tot[:n_n].reshape(-1)
            if ci0 == 0:
                part[9 * cin] = d0
        ws.append(part)
    groups = [np.zeros_like(ws[0]) for _ in range(8)]
    for sl, part in enumerate(ws):
        groups[sl % 8] += part
    total = groups[0].copy()
    for q in groups[1:]:
        total += q
    dw = total[:9 * cin].reshape(1, cin, 3, 3)
    return dw, total[9 * cin:], _bf16(dw), _bf16(total[9 * cin:])


@pytest.mark.parametrize("case", [
    (1, 9, 70, 16, "reflect", 2), (2, 5, 33, 32, "edge", 3), (1, 11, 17, 64, "zero", 1),
    (1, 6, 20, 128, "reflect", 2), (1, 3, 9, 136, "edge", 1), (2, 1, 5, 12, "reflect", 9),
    (1, 8, 16, 5, "zero", 1)], ids=lambda c: "-".join(map(str, c)))
def test_dw_head_schedule_matches_the_definition(case):
    """The heads' dW kernel's schedule (Cout = 1), emulated in numpy (each of
    its channel tiles 16, 32, 64 and 128 and a second tile past 128, Cin
    off 8, ragged strips, H = 1, slices beyond eight), sums to the
    definition (conv3x3_dw_plain's fp32 autograd on the same bf16 values)
    within 1e-5 x max|ref|, and its one rounding to bf16 lies within one
    spacing of the plain version's bf16 dW and db."""
    b, h, w, cin, border, slices = case
    assert conv_block.dw_route(cin, 1, BF16) == 3
    rng = np.random.default_rng(h * w + cin + 7)
    dpre = _bf16(rng.normal(size=(b, h, w, 1)))
    x = _bf16(rng.normal(size=(b, h, w, cin)))
    td, tx = torch.from_numpy(dpre), torch.from_numpy(x)
    ref32 = [_np(t) for t in conv_block.conv3x3_dw_plain(td, tx, border)]
    ref16 = [_np(t) for t in conv_block.conv3x3_dw_plain(td.to(BF16), tx.to(BF16), border)]
    dw, db, dw16, db16 = _dw_head_emulation(dpre, x, border, slices)
    for got, r32, got16, r16 in ((dw, ref32[0], dw16, ref16[0]), (db, ref32[1], db16, ref16[1])):
        scale = np.abs(r32).max()
        np.testing.assert_allclose(got, r32, rtol=0, atol=1e-5 * scale)
        assert np.abs(got16 - r16).max() <= _spacing(np.abs(r16).max())


def _dx_wgmma_emulation(dpre, wt, sms):
    """conv3x3_dx_wgmma_kernel in numpy on a grid of ``sms`` SMs' worth: the
    plan's N tile (dx_plan), block i on N tile i % ntiles walking the pixel
    tiles i / ntiles, + per_n, ...; a pixel tile of 8 x 16 (w' resident: two
    warpgroups, two blocks an SM) or 16 x 16 (streamed: four, one) in KC
    steps of 16 dpre channels, each staging the halo (zero outside the image
    and past Cout) as [2 groups][dx_halo_pixels][8] and the step's
    w' tiles from the slab (zero past its column groups; resident or
    streamed, the same values); warpgroup wg's 8 x 8 quadrant, per tap, as
    m64nTNk16 with A read through the K-major descriptor from halo pixel
    (quadrant origin + tap) (leading offset a channel group, stride offset
    a halo row) and B through the K-major descriptor of the tap's w' tile
    (leading offset 64 elements, stride 128); D row m is the quadrant's
    pixel (m // 8, m % 8); the fp32 sums rounded once and written inside the
    image and below Cin. -> (fp32 sums, bf16 dx, how many times each element
    was written)."""
    b, h, w, cout = dpre.shape
    cin = wt.shape[1]
    tn, res, _ = conv_block.dx_plan(cin, cout)
    wgs = 2 if res else 4
    th, tw = conv_block.DX_TILES[wgs]
    npx = conv_block.dx_halo_pixels(wgs)
    kc, nb = -(-cout // 16), -(-cin // 8)
    slab = _np(conv_block.arrange_dx_slab_bf16_plain(torch.from_numpy(wt).to(BF16))).reshape(-1)
    tiles_h, tiles_w = -(-h // th), -(-w // tw)
    mtiles = b * tiles_h * tiles_w
    ntiles = -(-cin // tn)
    per_n = max(1, min(mtiles, sms * (4 // wgs) // ntiles))
    sums = np.zeros((b, h, w, cin), np.float32)
    out = np.zeros((b, h, w, cin), np.float32)
    written = np.zeros((b, h, w, cin), int)
    for blk in range(ntiles * per_n):
        nt, first = blk % ntiles, blk // ntiles
        n0 = nt * tn
        for m in range(first, mtiles, per_n):
            bb, t = divmod(m, tiles_h * tiles_w)
            h0, w0 = (t // tiles_w) * th, (t % tiles_w) * tw
            acc = np.zeros((wgs, 64, tn), np.float32)
            for c in range(kc):
                hs = np.zeros(2 * npx * 8, np.float32)
                for pos in range((th + 2) * (tw + 2)):
                    y, xx = h0 - 1 + pos // (tw + 2), w0 - 1 + pos % (tw + 2)
                    if 0 <= y < h and 0 <= xx < w:
                        for cc, v in enumerate(dpre[bb, y, xx, c * 16:min(cout, c * 16 + 16)]):
                            hs[((cc // 8) * npx + pos) * 8 + cc % 8] = v
                bs = np.zeros(9 * tn * 16, np.float32)
                for tap in range(9):
                    for v in range(tn * 2):
                        if n0 // 8 + v // 16 < nb:
                            src = ((tap * kc + c) * nb + n0 // 8) * 128 + v * 8
                            bs[tap * tn * 16 + v * 8:tap * tn * 16 + v * 8 + 8] = slab[src:src + 8]
                for wg in range(wgs):
                    qr, qc = (wg // 2) * 8, (wg % 2) * 8
                    for tap in range(9):
                        ky, kx = divmod(tap, 3)
                        a = _desc_read_a(hs, ((qr + ky) * (tw + 2) + qc + kx) * 8, npx * 8,
                                         (tw + 2) * 8, False)
                        acc[wg] += a @ _desc_read(bs, tap * tn * 16, 64, 128, tn, False)
            n_n = min(tn, cin - n0)
            for wg in range(wgs):
                qr, qc = (wg // 2) * 8, (wg % 2) * 8
                for mm in range(64):
                    y, xx = h0 + qr + mm // 8, w0 + qc + mm % 8
                    if y < h and xx < w and n_n > 0:
                        sums[bb, y, xx, n0:n0 + n_n] = acc[wg, mm, :n_n]
                        out[bb, y, xx, n0:n0 + n_n] = _bf16(acc[wg, mm, :n_n])
                        written[bb, y, xx, n0:n0 + n_n] += 1
    return sums, out, written


@pytest.mark.parametrize("case", [
    ((1, 5, 19, 7), 5, 3), ((2, 17, 9, 3), 24, 7), ((1, 6, 21, 20), 40, 2),
    ((1, 4, 18, 32), 96, 5), ((1, 3, 17, 64), 128, 3), ((1, 2, 5, 128), 136, 4),
    ((1, 3, 4, 300), 64, 2), ((2, 16, 16, 16), 16, 1), ((1, 2, 3, 256), 136, 2),
    ((1, 2, 2, 800), 64, 1)],
    ids=lambda c: "-".join(map(str, (*c[0], c[1], c[2]))))
def test_dx_wgmma_schedule_matches_the_definition(case):
    """The dx interior kernel's schedule, emulated in numpy at its
    descriptors' offsets (each plan: w' resident at N tiles of 16, 32, 64
    and 128 and halved from 128, streamed at 64 and 128; Cin and Cout off
    8 and 16, ragged tiles, H and W below a tile, grids with several pixel
    tiles a block), writes every element of dx once, sums to the zero-
    bordered conv of dpre with w' (float64, on the same bf16 values) within
    1e-5 x max|ref|, and rounds once: within one spacing of the plain
    version's bf16 interior."""
    (b, h, w, cout), cin, sms = case
    rng = np.random.default_rng(h * w + cin + cout)
    dpre = _bf16(rng.normal(size=(b, h, w, cout)))
    wt = _bf16(rng.normal(size=(cout, cin, 3, 3)) / np.sqrt(9 * cout))
    sums, got, written = _dx_wgmma_emulation(dpre, wt, sms)
    assert (written == 1).all()
    ref = _np(conv_block.conv3x3_dx_plain(torch.from_numpy(dpre).double(),
                                          torch.from_numpy(wt).double(), "zero"))
    np.testing.assert_allclose(sums, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    plain = _np(conv_block.conv3x3_dx_plain(torch.from_numpy(dpre).to(BF16),
                                            torch.from_numpy(wt).to(BF16), "zero"))
    assert np.abs(got - plain).max() <= _spacing(np.abs(plain).max())


@pytest.mark.parametrize("cin,cout,want", [
    (512, 256, (128, False)), (256, 128, (128, False)), (128, 64, (64, True)),
    (64, 32, (64, True)), (96, 32, (128, True)), (32, 16, (32, True)), (16, 16, (16, True)),
    (136, 128, (128, False)), (136, 256, (128, False)), (64, 300, (64, False)),
    (64, 800, (64, False)), (5, 3, (16, True)), (24, 300, (16, True)), (24, 600, (64, False)),
    (40, 20, (64, True))])
def test_dx_plan_keeps_w_prime_resident_where_it_fits(cin, cout, want):
    """dx_plan: the bench preset's levels of 128 channels and less hold w'
    for the whole of K in shared memory beside the pipeline of two blocks an
    SM (halved to 64 channels a tile at 128 -> 64); the wider levels stream
    it at N tiles of 128, one block an SM; a block never asks for more than
    its share of the H100's 228 KB."""
    tn, res, smem = conv_block.dx_plan(cin, cout)
    assert (tn, res) == want
    assert smem <= (115712 if res else 232448)


# ---------------------------------------------------------------------------
# dx: the slab of w' in wgmma's order, and the fold's two roundings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout", [(3, 4), (16, 16), (96, 32), (9, 20), (40, 1)])
def test_dx_bf16_slab_read_back_per_tap_gives_the_flipped_weight(cin, cout):
    """The bf16 dx slab (the tensor-core forward's core-matrix order of w',
    which the interior's wgmma and the fold's mma.sync both read), read back
    as a K x N matrix per tap (K = the forward's Cout, N its Cin), is
    w'[:, :, ky, kx] transposed, zero past Cout (to a multiple of 16) and
    Cin (to a multiple of 8)."""
    rng = np.random.default_rng(cin * 7 + cout)
    wt = torch.from_numpy(rng.normal(size=(cout, cin, 3, 3)).astype(np.float32)).to(BF16)
    tc = conv_block.arrange_dx_slab_bf16_plain(wt)
    kp, np_ = -(-cout // 16) * 16, -(-cin // 8) * 8
    assert tc.dtype == BF16 and tuple(tc.shape) == (9, kp, np_)
    # (tap, kc, nb, kb, n8, k8) -> (tap, K, N)
    m = tc.reshape(9, kp // 16, np_ // 8, 2, 8, 8).permute(0, 1, 3, 5, 2, 4).reshape(9, kp, np_)
    wp = conv_block.flip_weight(wt)
    for t in range(9):
        assert torch.equal(m[t, :cout, :cin], wp[:, :, t // 3, t % 3].T)
    assert not m[:, cout:].any() and not m[:, :, cin:].any()


def _fold_tc_emulation(dpre, slab, cin, border, tile=64):
    """conv3x3_dx_fold_tc_kernel's schedule in numpy: the destinations in
    segments that each start a tile of 64 (as the CUDA-core fold's), four
    warps of 16 pixels by 64 channels a block; per tap of the tile's mask,
    per term slot the segment's kind carries (a row: the border row's term,
    a column: the border column's, a corner: all three), per 16 dpre
    channels, the A fragment gathered at each lane's rows and channels (the
    term's bf16 dpre value, zero where the term does not exist) and the B
    fragments of each n8 tile read from the tensor-core slab's tap 8 - t at
    the lanes' offsets; mma.m16n8k16 sums in fp32."""
    b, h, w, cout = dpre.shape
    kc_n, nb_n = -(-cout // 16), -(-cin // 8)
    slab = slab.reshape(-1)
    top, bot = _src_index(-1, h, border), _src_index(h, h, border)
    left, right = _src_index(-1, w, border), _src_index(w, w, border)
    rows, cols = sorted({top, bot}), sorted({left, right})
    segments = ([(0, [(bb, y, x) for bb in range(b) for x in range(w) if x not in cols])
                 for y in rows]
                + [(1, [(bb, y, x) for bb in range(b) for y in range(h) if y not in rows])
                   for x in cols]
                + [(2, [(bb, y, x) for bb in range(b)]) for y in rows for x in cols])

    def terms(y, x, t):
        """fold_terms: (inside row, border column), (border row, inside
        column), (border row, border column), None where missing."""
        ky, kx = divmod(t, 3)
        ri, ci = y + 1 - ky, x + 1 - kx
        vi, wi = 0 <= ri < h, 0 <= ci < w
        ve = (ky == 0 and y == top) or (ky == 2 and y == bot)
        we = (kx == 0 and x == left) or (kx == 2 and x == right)
        re_, ce = (0 if ky == 0 else h - 1), (0 if kx == 0 else w - 1)
        return [(ri, ce) if vi and we else None, (re_, ci) if ve and wi else None,
                (re_, ce) if ve and we else None]

    dpre_p = np.zeros((b, h, w, kc_n * 16), np.float32)
    dpre_p[..., :cout] = dpre
    fold = np.zeros((b, h, w, cin), np.float32)
    for kind, dests in segments:
        slots = {0: [1], 1: [0], 2: [0, 1, 2]}[kind]
        for t0 in range(0, len(dests), tile):
            px = dests[t0:t0 + tile] + [None] * (tile - len(dests[t0:t0 + tile]))
            mask = [t for t in range(9)
                    if any(p is not None and any(terms(p[1], p[2], t)) for p in px)]
            for n0 in range(0, cin, 64):
                acc = np.zeros((tile, 64), np.float32)
                for t in mask:
                    for sl in slots:
                        a_rows = np.zeros((tile, kc_n * 16), np.float32)
                        for i, p in enumerate(px):
                            if p is not None and terms(p[1], p[2], t)[sl] is not None:
                                r, c = terms(p[1], p[2], t)[sl]
                                a_rows[i] = dpre_p[p[0], r, c]
                        for kc in range(kc_n):
                            for warp in range(tile // 16):
                                fr = np.zeros((32, 4, 2), np.float32)
                                for r, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                                    rows_ = warp * 16 + G_ + dm
                                    co = kc * 16 + 2 * Q_ + dk
                                    fr[:, r, 0] = a_rows[rows_, co]
                                    fr[:, r, 1] = a_rows[rows_, co + 1]
                                a = _a_tile(fr)
                                for j in range(8):
                                    nb = n0 // 8 + j
                                    if nb >= nb_n:
                                        continue
                                    at = (((8 - t) * kc_n + kc) * nb_n + nb) * 128 + G_ * 8 + 2 * Q_
                                    bt = np.zeros((16, 8), np.float32)
                                    for r in range(2):
                                        bt[2 * Q_ + 8 * r, G_] = slab[at + 64 * r]
                                        bt[2 * Q_ + 8 * r + 1, G_] = slab[at + 64 * r + 1]
                                    acc[warp * 16:warp * 16 + 16, j * 8:j * 8 + 8] += a @ bt
                for i, p in enumerate(px):
                    if p is not None:
                        n_n = min(64, cin - n0)
                        fold[p[0], p[1], p[2], n0:n0 + n_n] += acc[i, :n_n]
    return fold


@pytest.mark.parametrize("case", [
    ((3, 1, 1, 5), 6, "reflect"), ((2, 2, 9, 20), 70, "edge"), ((1, 12, 36, 16), 8, "reflect"),
    ((2, 7, 40, 3), 5, "edge"), ((1, 33, 2, 17), 12, "reflect"), ((2, 6, 20, 1), 16, "reflect")],
    ids=lambda c: "-".join(map(str, (*c[0], c[1], c[2]))))
def test_fold_tc_schedule_matches_the_plain_fold(case):
    """The tensor-core fold's schedule, emulated in numpy on the tensor-core
    slab of w' (1- and 2-pixel axes, segments longer than a tile, Cin above
    one N tile and off 8, Cout off 16 and the heads' Cout = 1), adds what
    conv3x3_dx_fold_plain says the border adds, on the same bf16 values,
    within 1e-5 x max|ref|: every destination once, every extra term once, no
    interior term."""
    (b, h, w, cout), cin, border = case
    rng = np.random.default_rng(h * 100 + w + cin)
    dpre = torch.from_numpy(rng.normal(size=(b, h, w, cout)).astype(np.float32)).to(BF16)
    wt = torch.from_numpy((0.2 * rng.normal(size=(cout, cin, 3, 3))).astype(np.float32)).to(BF16)
    ref = _np(conv_block.conv3x3_dx_fold_plain(dpre.double(), wt.double(), border))
    tc_slab = conv_block.arrange_dx_slab_bf16_plain(wt)
    got = _fold_tc_emulation(_np(dpre), _np(tc_slab), cin, border)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("hw", [(1, 5), (3, 2), (5, 7), (6, 20)], ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("border", ["reflect", "edge"])
def test_bf16_fold_rounds_the_interior_then_the_sum(border, hw):
    """The bf16 dx as the kernels form it, emulated: the interior's fp32 sum
    rounded to bf16, then the tensor-core fold's fp32 sum (its schedule on
    the tensor-core slab of w', each extra dpre term a K entry of its own)
    added to it in fp32 and rounded again, on the fold lines alone. Off the
    fold lines it equals conv3x3_dx_plain's bf16 dx bit for bit; on them it
    lies within one spacing of each element (two fp32 sums in two orders,
    each rounded once)."""
    h, w = hw
    rng = np.random.default_rng(h * 31 + w)
    dpre = torch.from_numpy(rng.normal(size=(2, h, w, 12)).astype(np.float32)).to(BF16)
    wt = torch.from_numpy((0.2 * rng.normal(size=(12, 6, 3, 3))).astype(np.float32)).to(BF16)
    ref = _np(conv_block.conv3x3_dx_plain(dpre, wt, border))
    interior = conv_block.conv3x3_dx_plain(dpre, wt, "zero")
    tc_slab = conv_block.arrange_dx_slab_bf16_plain(wt)
    fold = _fold_tc_emulation(_np(dpre), _np(tc_slab), 6, border)
    lines = _fold_lines(h, w, border)[None, :, :, None] & np.ones(ref.shape, bool)
    got = np.where(lines, _bf16(_np(interior) + fold), _np(interior))
    assert np.array_equal(got[~lines], ref[~lines])
    sp = np.array([_spacing(v) for v in np.abs(ref[lines])])
    assert (np.abs(got[lines] - ref[lines]) <= np.maximum(sp, 2.0 ** -133)).all()


def test_conv3x3_bf16_backward_routes_on_the_card():
    """On the card the backward takes bf16 x and weight with bf16 grad and
    out, or with fp32 ones (the heads): both reach the dpre kernel's launch
    (which fails here for want of the card and its compiler, not on a
    dtype); every other mix raises TypeError, and no route runs the plain
    version."""
    def card(dtype, shape):
        return torch.ones(shape, dtype=dtype).as_subclass(_OnCard)

    x, w = card(BF16, (1, 4, 4, 4)), card(BF16, (2, 4, 3, 3))
    for gdt in (BF16, torch.float32):
        g = card(gdt, (1, 4, 4, 2))
        with pytest.raises(Exception) as launched:
            conv_block.conv3x3_backward(g, g, x, w)
        assert not isinstance(launched.value, TypeError), launched.value
    x32, w32, g32 = card(torch.float32, (1, 4, 4, 4)), card(torch.float32, (2, 4, 3, 3)), \
        card(torch.float32, (1, 4, 4, 2))
    g16 = card(BF16, (1, 4, 4, 2))
    for args in ((g16, g16, x32, w32), (g32, g32, x, w32), (g16, g32, x, w),
                 (card(torch.float16, (1, 4, 4, 2)),) * 2 + (x, w)):
        with pytest.raises(TypeError, match="float32 throughout, or bfloat16"):
            conv_block.conv3x3_backward(*args)


# ---------------------------------------------------------------------------
# BatchNorm in bf16: Flax's nn.BatchNorm(dtype=bf16)
# ---------------------------------------------------------------------------


def _bn_pair(rng, c):
    bn = resnet.BatchNorm2d(c, eps=resnet.BN_EPS)
    scale = (rng.normal(size=c) + 1.0).astype(np.float32)
    shift = (0.1 * rng.normal(size=c)).astype(np.float32)
    mean0 = (0.2 * rng.normal(size=c)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, shift), (bn.running_mean, mean0),
                     (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)}
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}
    return bn, params, stats


def _close_bf16(got, want):
    """bf16 values within one spacing of each element (the fp32 formula in
    two programs, rounded once)."""
    got, want = _np(got) if torch.is_tensor(got) else got, np.asarray(want, np.float32)
    sp = np.array([_spacing(v) for v in np.abs(want).ravel()]).reshape(want.shape)
    assert (np.abs(got - want) <= np.maximum(sp, 2.0 ** -133)).all(), np.abs(got - want).max()


def test_batchnorm_bf16_train_mode_matches_flax_over_three_updates():
    """BatchNorm2d on bf16 activations with fp32 parameters, against Flax's
    nn.BatchNorm(use_running_average=False, dtype=bf16) over three batches:
    the bf16 output within one spacing of each element (measured: equal),
    the bf16 input gradient within one spacing of its largest magnitude
    (measured 1.0; both 0.4-0.9 of a spacing from a float64 run: the
    gradient cancels, so its small elements carry their spacing of the
    largest), the fp32 gradients of scale and shift rtol 1e-5 (+ atol 1e-6
    x max), the fp32 running mean and variance after each update rtol
    1e-5."""
    rng = np.random.default_rng(0)
    c = 6
    bn, params, stats = _bn_pair(rng, c)
    bn.train()
    fbn = nn.BatchNorm(use_running_average=False, epsilon=resnet.BN_EPS, dtype=jnp.bfloat16)
    for _ in range(3):
        x = _bf16(2.0 * rng.normal(size=(4, 5, 7, c)) + 0.5)  # NHWC
        g = _bf16(rng.normal(size=x.shape))

        def f(p, xx):
            y, mut = fbn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * g), (y, mut)

        (_, (y, mut)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x, jnp.bfloat16))
        stats = mut["batch_stats"]
        assert y.dtype == jnp.bfloat16 and stats["mean"].dtype == jnp.float32
        tx = torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2).requires_grad_()
        out = bn(tx)
        assert out.dtype == BF16 and bn.running_mean.dtype == torch.float32
        out.backward(torch.from_numpy(g).to(BF16).permute(0, 3, 1, 2))
        _close_bf16(out.permute(0, 2, 3, 1), y)
        assert tx.grad.dtype == BF16
        gx = np.asarray(gx, np.float32)
        assert np.abs(_np(tx.grad.permute(0, 2, 3, 1)) - gx).max() <= _spacing(np.abs(gx).max())
        for got, want in ((bn.weight.grad, gp["scale"]), (bn.bias.grad, gp["bias"])):
            want = np.asarray(want)
            np.testing.assert_allclose(_np(got), want, rtol=1e-5,
                                       atol=1e-6 * float(np.abs(want).max()))
        bn.zero_grad()
        np.testing.assert_allclose(_np(bn.running_mean), np.asarray(stats["mean"]), rtol=1e-5)
        np.testing.assert_allclose(_np(bn.running_var), np.asarray(stats["var"]), rtol=1e-5)


def test_batchnorm_bf16_eval_mode_matches_flax(monkeypatch):
    """In eval mode a bf16 input with fp32 running statistics and parameters
    (the trained model validated in its compute dtype) is normalised by
    Flax's formula in fp32 and returned in bf16, within one spacing of
    nn.BatchNorm(use_running_average=True, dtype=bf16), without reaching
    F.batch_norm (whose CPU kernel takes no mixed dtypes by this route); an
    fp32 input, and the Predictor's all-bf16 module, keep PyTorch's own
    eval path."""
    rng = np.random.default_rng(1)
    c = 5
    bn, params, stats = _bn_pair(rng, c)
    bn.eval()
    x = _bf16(1.5 * rng.normal(size=(3, 4, 6, c)))
    y = nn.BatchNorm(use_running_average=True, epsilon=resnet.BN_EPS, dtype=jnp.bfloat16).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x, jnp.bfloat16))
    calls = []
    real = torch.nn.functional.batch_norm
    monkeypatch.setattr(torch.nn.functional, "batch_norm",
                        lambda *a, **k: calls.append(a[0].dtype) or real(*a, **k))
    with torch.no_grad():
        out = bn(torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2))
        assert out.dtype == BF16 and not calls
        _close_bf16(out.permute(0, 2, 3, 1), y)
        bn(torch.from_numpy(x).permute(0, 3, 1, 2))
        bn.to(BF16)(torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2))
    assert calls == [torch.float32, BF16]
