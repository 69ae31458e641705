"""bf16 stereo training's kernels and layers in the PyTorch port against the
JAX package on the CPU, inputs made with numpy from a seed: the banded
Gram's backward (``correlation_gram_backward``, kernel 7b), upsample_concat's
bf16 backward (kernel 2c) and the stereo convs under Flax's dtype rule
(``models/stereo.Conv2d``).

Tolerances are bf16 spacings: the spacing of a value v is the distance
between the bf16 numbers around |v|, 2^(floor(log2 |v|) - 7). The port's
wrappers take their plain versions here (every tensor lies on the CPU);
chip_smoke.py (phase 22) holds the CUDA kernels to those plain versions on
the card.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from scenedepthestimation_tpu.models import stereo as jax_stereo
from scenedepthestimation_tpu.ops.correlation import _correlation_gram
from scenedepthestimation_tpu_torch.models import stereo as port_stereo
from scenedepthestimation_tpu_torch.ops.cuda import correlation_gram as gram_kernel
from scenedepthestimation_tpu_torch.ops.cuda import upsample_concat as upcat_kernel
from torch_threads import two_threads  # noqa: F401 (autouse)

jax_up = importlib.import_module("scenedepthestimation_tpu.ops.upsample")
BF16 = torch.bfloat16


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (kept as float32: every one exact)."""
    return torch.tensor(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _normal(rng, shape, scale=1.0) -> np.ndarray:
    return _bf16(rng.normal(size=shape) * scale)


def spacing(v) -> np.ndarray:
    """The bf16 spacing at |v| (elementwise; 2^-133 at 0)."""
    m = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _t(a: np.ndarray, grad=False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)).to(BF16)
    return t.requires_grad_() if grad else t


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# correlation_gram's backward (kernel 7b)
# ---------------------------------------------------------------------------


def _gram_problem(shape):
    """(fl, fr, g) of bf16 values for a (B, H, W, C, D) case, g the slice
    [..., :D] of a (D + C)-wide gradient, as the concat hands it back."""
    b, h, w, c, d = shape
    rng = np.random.default_rng(sum(shape) + 16)
    fl, fr = _normal(rng, (b, h, w, c)), _normal(rng, (b, h, w, c))
    return fl, fr, _normal(rng, (b, h, w, d + c), 0.1)[..., :d]


def _oracle(fl, fr, g):
    """d_fl[w] = 1/C sum_d g[w, d] fr[w - d], d_fr[w] = 1/C sum_d g[w + d, d]
    fl[w + d], in float64."""
    fl, fr, g = (x.astype(np.float64) for x in (fl, fr, g))
    w, c, d = fl.shape[2], fl.shape[3], g.shape[-1]
    d_fl, d_fr = np.zeros_like(fl), np.zeros_like(fr)
    for k in range(min(d, w)):
        d_fl[:, :, k:] += g[:, :, k:, k : k + 1] * fr[:, :, : w - k]
        d_fr[:, :, : w - k] += g[:, :, k:, k : k + 1] * fl[:, :, k:]
    return d_fl / c, d_fr / c


def _port_grads(fl, fr, g):
    """(d_fl, d_fr) through correlation_gram's op and its registered
    backward, checked equal to correlation_gram_backward called alone."""
    tl, tr = _t(fl, True), _t(fr, True)
    cost = gram_kernel.correlation_gram(tl, tr, g.shape[-1])
    assert cost.dtype == BF16 and cost.grad_fn is not None
    gt = _t(np.concatenate([g, np.zeros(g.shape[:3] + fl.shape[-1:], np.float32)], -1))
    gt = gt[..., : g.shape[-1]]  # the concat's strided slice
    cost.backward(gt)
    direct = gram_kernel.correlation_gram_backward(gt, _t(fl), _t(fr), g.shape[-1])
    for a, b in zip((tl.grad, tr.grad), direct):
        assert a.dtype == BF16 and torch.equal(a, b)
    return _np(tl.grad), _np(tr.grad)


def _spacings(got, want) -> float:
    """max |got - want| in bf16 spacings of max |want|."""
    return float(np.abs(got - want).max() / spacing(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _jax_gram_vjp(shape):
    """jax.vjp of the JAX model's bf16 cost, _correlation_gram cast to bf16
    (what its aggregation concatenates), at the case's inputs."""
    fl, fr, g = _gram_problem(shape)
    d = shape[-1]
    bf = jnp.bfloat16
    _, vjp = jax.vjp(lambda a, b: _correlation_gram(a, b, d).astype(bf),
                     jnp.asarray(fl, bf), jnp.asarray(fr, bf))
    out = jax.jit(vjp)(jnp.asarray(np.ascontiguousarray(g), bf))
    return tuple(np.asarray(v, np.float32) for v in out)


def _window(view, cols, c0, kc):
    """Rows ``cols`` of one (W, C) row's view, channels [c0, c0 + kc), zero
    outside [0, W) and past C: a staged window."""
    w, c = view.shape
    out = np.zeros((len(cols), kc), np.float32)
    ok = (cols >= 0) & (cols < w)
    out[ok, : min(kc, c - c0)] = view[cols[ok], c0 : c0 + kc]
    return out


def _g_rows(grow, rows, d0, dt, d, pitch, col0):
    """g's rows ``rows`` of one (W, D) row, disparities [d0, d0 + dt) at
    columns [col0, col0 + dt) of ``pitch``-wide rows, zero elsewhere and at
    or past W and D: the staged rows G."""
    w = grow.shape[0]
    out = np.zeros((len(rows), pitch), np.float32)
    ks = d0 + np.arange(dt)
    out[np.ix_(rows < w, col0 + np.arange(dt)[ks < d])] = grow[np.ix_(rows[rows < w], ks[ks < d])]
    return out


def _band_fragments(gs, right, aoff, ks, pitch):
    """The A fragment of k16 slice ``ks`` as csrc/correlation_gram_bwd.cu's
    lanes gather it from the staged rows G (``gs``, flat), as a 16 x 16
    array: lane (g, q) holds a0 = A[g][2q, 2q + 1], a1 = A[g + 8][..], a2 =
    A[g][2q + 8, ..], a3 = A[g + 8][2q + 8, ..]. ``aoff`` is the lane's
    offset: d_fr's a0 pair is (gs[p], gs[p + pitch + 1]), a diagonal; d_fl's
    the two values from the funnel shift of the 32-bit words at the even
    offset ``aoff[0]`` and after, by ``aoff[1]`` halves."""
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    a = np.zeros((16, 16), np.float32)
    # (register: row offset m, column offset k) within the tile
    regs = ((0, 0), (8, 0), (0, 8), (8, 8))
    for (dm, dk) in regs:
        if right:
            p = aoff[lane] + ks * (16 * pitch + 16) + dk * pitch + dm + dk
            lo, hi = gs[p], gs[p + pitch + 1]
        else:
            base, sh = aoff[0][lane], aoff[1][lane]
            e = base + 16 * ks + dm * pitch + dm + dk + sh  # the funnel's first half
            lo, hi = gs[e], gs[e + 1]
        a[g + dm, 2 * q + dk] = lo
        a[g + dm, 2 * q + dk + 1] = hi
    return a


def _gram_bwd_emulation(g, fl, fr, d):
    """csrc/correlation_gram_bwd.cu's schedule in numpy (backward_plan's
    blocking): per (row, W tile w0, channel chunk c0, D chunk d0) the
    reversed fr window WR[c] = fr[w0 - d0 + T-1 - c], fl's WL[r] = fl[w0 +
    d0 + r] and g's rows G[r] = g[w0 + d0 + r] staged with zeros outside
    the frame and past C and D, G's at column 16 of BWD_G_PITCH-wide rows of
    zeros (and d_fl's own rows g[w0 + r] after them past D chunk 0). Each
    warp's band fragments are gathered from G by the kernel's lane offsets
    (_band_fragments) and checked equal, slice by slice, to the band from
    the definition, M[x, y] = g[x, x - y] (0 <= x - y - d0 < DT, x - y < D,
    x < W) at d_fl's A[m][k] = M[w0 + 16 i + m, w0 - d0 + T-1 - (kbase +
    k)] and d_fr's A[m][k] = M[w0 + d0 + kbase + k, w0 + T-1 - 16 i - m]
    (kbase = T - 16 - 16 i); and each warp's k16 slices are checked to cover
    every nonzero of its tile's band. Then the products of each slice (A
    against the window's rows kbase + 16 s ..) are summed in fp32 and added
    to the fp32 sums slice by slice, D chunks in order. Returns (d_fl, d_fr)
    as fp32 values times fp32 1/C, before the one rounding."""
    b_, h_, w_, c_ = fl.shape
    plan = gram_kernel.backward_plan(w_, c_, d)
    t, dt, nd, s_, r_ = (plan[k] for k in ("w_tile", "d_tile", "d_tiles", "slices", "window"))
    kc, own = plan["k_chunk"], plan["own_fl_rows"]
    assert plan["g_rows"] == r_ + (t if own else 0) and plan["warps"] == 2 * (t // 16)
    assert r_ == t + 16 * (s_ - 1) and 16 * s_ >= 15 + plan["band"]
    pitch, col0 = gram_kernel.BWD_G_PITCH, 16
    assert col0 + 16 * s_ + 2 <= pitch  # the gathers stay inside a row
    inv_c = np.float32(1) / np.float32(c_)
    d_fl = np.full(fl.shape, np.nan, np.float32)
    d_fr = np.full(fr.shape, np.nan, np.float32)
    lane = np.arange(32)
    gl, ql = lane >> 2, lane & 3
    ext = np.arange(-64, r_ + 64)  # window rows past the staged ones

    def band(xs, ys, d0):
        """M[x, y] from the definition at rows xs, columns ys: the D chunk's
        disparities x - y in [d0, d0 + DT) only."""
        x = xs[:, None]
        k = x - ys[None, :]
        ok = (k >= d0) & (k < min(d0 + dt, d)) & (x < w_) & (x >= 0)
        return np.where(ok, grow[np.clip(x, 0, w_ - 1), np.clip(k, 0, d - 1)], 0.0)

    for bi in range(b_):
        for hi in range(h_):
            grow = g[bi, hi]
            for w0 in range(0, w_, t):
                n = min(t, w_ - w0)
                for c0 in range(0, c_, kc):
                    acc = {False: np.zeros((t, kc), np.float32),
                           True: np.zeros((t, kc), np.float32)}
                    for d0 in range(0, nd * dt, dt):
                        win = {False: _window(fr[bi, hi], w0 - d0 + t - 1 - np.arange(r_), c0, kc),
                               True: _window(fl[bi, hi], w0 + d0 + np.arange(r_), c0, kc)}
                        rows = [_g_rows(grow, w0 + d0 + np.arange(r_), d0, dt, d, pitch, col0)]
                        if own:
                            rows.append(_g_rows(grow, w0 + np.arange(t), d0, dt, d, pitch, col0))
                        # slack past the last row: the gathers stay inside it
                        gs = np.concatenate(rows + [np.zeros((1, pitch), np.float32)]).ravel()
                        for i in range(t // 16):
                            kbase = t - 16 - 16 * i
                            tile = np.arange(16 * i, 16 * i + 16)
                            col = col0 + gl + 2 * ql - 15
                            offs = {
                                True: (kbase + 2 * ql) * pitch + col,
                                False: (((r_ if own else 0) + 16 * i + gl) * pitch + (col & ~1),
                                        col & 1),
                            }
                            ks_rows = np.arange(kbase, kbase + 16 * s_)
                            a_fl = band(w0 + tile, w0 - d0 + t - 1 - ext, d0)
                            a_fr = band(w0 + d0 + ext, w0 + t - 1 - tile, d0)
                            assert not a_fl[:, ~np.isin(ext, ks_rows)].any()
                            assert not a_fr[~np.isin(ext, ks_rows), :].any()
                            for right in (False, True):
                                for sl in range(s_):
                                    k = kbase + 16 * sl + np.arange(16)
                                    a = _band_fragments(gs, right, offs[right], sl, pitch)
                                    want = (band(w0 + d0 + k, w0 + t - 1 - tile, d0).T if right
                                            else band(w0 + tile, w0 - d0 + t - 1 - k, d0))
                                    np.testing.assert_array_equal(a, want)
                                    acc[right][16 * i : 16 * i + 16] += a @ win[right][k]
                    cw = min(kc, c_ - c0)
                    d_fl[bi, hi, w0 : w0 + n, c0 : c0 + cw] = acc[False][:n, :cw] * inv_c
                    # d_fr's tile row m is pixel T-1-m.
                    d_fr[bi, hi, w0 : w0 + n, c0 : c0 + cw] = acc[True][::-1][:n, :cw] * inv_c
    return d_fl, d_fr


def _within_a_spacing(got, want) -> bool:
    """Every element of got within one bf16 spacing of want's + 1e-6, the
    card's allowance for the kernel against its plain version."""
    return bool((np.abs(got - want) <= spacing(want) + 1e-6).all())


GRAM_CS = (5, 64, 128)
GRAM_DS = (1, 7, 24, 48, 100)
# The JAX vjp against the port's plain backward, in bf16 spacings of each
# output's largest magnitude: twice the measured 1.0 (0 to 1.0 over the 15
# cases). The JAX transpose rounds the scaled gradient to bf16 before its
# products and keeps its dot_general's output in bf16, and for d_fr sums up
# to two windows' terms in bf16 (the transpose of its stacked, overlapping
# windows); the port sums in fp32 and rounds once.
JAX_GRAM_SPACINGS = 2.0


@pytest.mark.parametrize("d", GRAM_DS)
@pytest.mark.parametrize("c", GRAM_CS)
def test_correlation_gram_backward_matches_oracle_and_jax(c, d):
    """At W = 70 (off the 64-column tile; D = 100 > W), the port's backward
    (the op's autograd, the plain version on the CPU) against a float64
    oracle within one bf16 spacing of each output's largest magnitude,
    against jax.vjp of the JAX bf16 cost within JAX_GRAM_SPACINGS of it,
    and the kernel's schedule emulated in numpy (the sheared band on the
    tensor cores' k16 slices, fp32 sums), rounded once to bf16, within one
    spacing + 1e-6 of it element by element."""
    shape = (1, 2, 70, c, d)
    fl, fr, g = _gram_problem(shape)
    got = _port_grads(fl, fr, g)
    for p, o in zip(got, _oracle(fl, fr, g)):
        assert _spacings(p, o) <= 1.0
    for p, j in zip(got, _jax_gram_vjp(shape)):
        assert _spacings(p, j) <= JAX_GRAM_SPACINGS
    for p, e in zip(got, _gram_bwd_emulation(g, fl, fr, d)):
        assert _within_a_spacing(_bf16(e), p)


@pytest.mark.parametrize("d", GRAM_DS)
@pytest.mark.parametrize("c", GRAM_CS)
@pytest.mark.parametrize("w", (63, 64, 65, 96, 97, 130, 288))
def test_correlation_gram_backward_schedule(w, c, d):
    """The tensor-core kernel's schedule at W on and off its 64-column tile
    (one to five tiles), C = 5 (one part-filled channel chunk), 64
    and 128 (two chunks), D = 1 and 7 (one or two k16 slices), 24, 48 and
    100 (three D chunks of 40, d_fl with rows of its own): the band's
    fragments gathered as the kernel's lanes gather them equal the band from
    the definition, each warp's k16 slices cover its band, and the
    slice-by-slice fp32 sums,
    rounded once to bf16, lie within one spacing + 1e-6 of the float64
    oracle and of correlation_gram_backward_plain, element by element."""
    fl, fr, g = _gram_problem((1, 1, w, c, d))
    emu = _gram_bwd_emulation(g, fl, fr, d)
    plain = gram_kernel.correlation_gram_backward_plain(_t(g), _t(fl), _t(fr), d)
    for e, p, o in zip(emu, plain, _oracle(fl, fr, g)):
        assert p.dtype == BF16
        assert _within_a_spacing(_bf16(e), _np(p))
        assert _within_a_spacing(_bf16(e), o)


@pytest.mark.parametrize("d,want", [
    (1, (8, 1, 1, 64)), (7, (8, 1, 2, 80)), (12, (16, 1, 2, 80)), (24, (24, 1, 3, 96)),
    (48, (48, 1, 4, 112)), (100, (40, 3, 4, 112)),
], ids=lambda v: str(v))
def test_gram_backward_plan(d, want):
    """(D chunk, D chunks, k16 slices, window rows) at W = 288 (five
    64-wide tiles): D = 48, config 5's, is one chunk whose 16-row tiles read
    63 window columns in four slices, a block in 115,200 bytes, two to an
    SM; D = 100 takes three chunks of 40 with d_fl's g rows apart."""
    plan = gram_kernel.backward_plan(288, 64, d)
    got = tuple(plan[k] for k in ("d_tile", "d_tiles", "slices", "window"))
    assert got == want
    assert plan["w_tiles"] == 5 and plan["k_chunks"] == 1 and plan["stages"] == 2
    assert plan["own_fl_rows"] == (plan["d_tiles"] > 1)
    if d == 48:
        assert plan["shared_bytes"] == 115200 and plan["smem_blocks_per_sm"] == 2


def test_gram_backward_plan_fits_every_d():
    """For every D up to 400 and C in (5, 64, 128, 200): the D chunks cover
    D with a chunk a multiple of 8 and at most BWD_MAX_D, the slices cover
    a 16-row tile's band (16 S >= 15 + band), the gathers stay inside a
    staged row of g (16 + 16 S + 2 <= BWD_G_PITCH), and an SM's shared
    memory holds a block (two wherever D fits one chunk)."""
    for c in (5, 64, 128, 200):
        for d in range(1, 401):
            plan = gram_kernel.backward_plan(130, c, d)
            dt, nd = plan["d_tile"], plan["d_tiles"]
            assert dt % 8 == 0 and dt <= gram_kernel.BWD_MAX_D and (nd - 1) * dt < d <= nd * dt
            assert 16 * plan["slices"] >= 15 + plan["band"] and plan["band"] == min(d, dt)
            assert 16 + 16 * plan["slices"] + 2 <= gram_kernel.BWD_G_PITCH
            assert plan["smem_blocks_per_sm"] >= (2 if nd == 1 else 1)
            assert plan["k_chunks"] == -(-c // 64)


# ---------------------------------------------------------------------------
# upsample_concat's bf16 backward (kernel 2c)
# ---------------------------------------------------------------------------

# (B, H, W, C1, C2): config 5's three joins' widths (x 160 + skip 128, 128 +
# 96, 96 + 64) at small grids, and widths off 16 bytes (single elements).
UPCAT_CASES = [(1, 3, 4, 160, 128), (1, 3, 4, 128, 96), (2, 3, 5, 96, 64), (2, 3, 5, 5, 3)]


@pytest.mark.parametrize("shape", UPCAT_CASES, ids=lambda s: "x".join(map(str, s)))
def test_upsample_concat_bf16_backward_matches_jax_vjp(shape):
    """(dx, dskip) through the op's registered backward in bf16 against
    jax.vjp of the JAX upsample_concat in bf16: dskip equal bit for bit, dx
    within one bf16 spacing of its largest magnitude (measured 0.5-1.0).
    dx is the 2x2 block summed in fp32 in the kernel's order, ((g00 + g01)
    + g10) + g11, rounded once to bf16, bit for bit; XLA's sums the same
    order rounding each partial sum to bf16, bit for bit, which is all that
    parts them."""
    b, h, w, c1, c2 = shape
    rng = np.random.default_rng(sum(shape))
    x, skip = _normal(rng, (b, h, w, c1)), _normal(rng, (b, 2 * h, 2 * w, c2))
    g = _normal(rng, (b, 2 * h, 2 * w, c1 + c2))
    tx, ts = _t(x, True), _t(skip, True)
    out = upcat_kernel.upsample_concat(tx, ts)
    assert out.dtype == BF16 and out.grad_fn is not None
    out.backward(_t(g))
    assert tx.grad.dtype == ts.grad.dtype == BF16
    bf = jnp.bfloat16
    _, vjp = jax.vjp(jax_up.upsample_concat, jnp.asarray(x, bf), jnp.asarray(skip, bf))
    want_x, want_s = (np.asarray(v, np.float32) for v in vjp(jnp.asarray(g, bf)))
    np.testing.assert_array_equal(_np(ts.grad), want_s)
    assert _spacings(_np(tx.grad), want_x) <= 1.0
    q = [g[:, i::2, j::2, :c1] for i in (0, 1) for j in (0, 1)]
    np.testing.assert_array_equal(_np(tx.grad), _bf16(((q[0] + q[1]) + q[2]) + q[3]))
    np.testing.assert_array_equal(want_x, _bf16(_bf16(_bf16(q[0] + q[1]) + q[2]) + q[3]))


def test_upsample_concat_fp32_backward_keeps_its_bits():
    """The fp32 plain backward is unchanged by the bf16 one: the sum in
    g's own dtype, no cast."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=(2, 6, 8, 12)).astype(np.float32))
    dx, dskip = upcat_kernel.upsample_concat_backward_plain(g, 5)
    q = g[..., :5]
    want = q[:, 0::2, 0::2] + q[:, 0::2, 1::2] + q[:, 1::2, 0::2] + q[:, 1::2, 1::2]
    assert dx.dtype == torch.float32 and torch.equal(dx, want)
    assert torch.equal(dskip, g[..., 5:])


# ---------------------------------------------------------------------------
# Flax's dtype rule, layer by layer
# ---------------------------------------------------------------------------


class _FlaxConv(nn.Module):
    """The JAX model's plain convs (cost heads, the refinement's residual):
    a k x k nn.Conv computing in ``dtype``."""

    features: int
    dtype: jnp.dtype

    @nn.compact
    def __call__(self, x):
        return nn.Conv(self.features, (3, 3), padding=((1, 1), (1, 1)), dtype=self.dtype,
                       name="conv")(x)


# (name, cin, cout, stride, kernel, relu): the tower's first conv (5x5 /2),
# an aggregation ConvRelu, a cost head and the refinement's residual.
LAYERS = [("down1", 3, 8, 2, 5, True), ("enc1", 12, 16, 2, 3, True),
          ("cost_head", 16, 8, 1, 3, False), ("residual", 8, 1, 1, 3, False)]
# The port's bf16 output against Flax's, in spacings of its largest
# magnitude: twice the measured 1.0 (all four layers). On the CPU PyTorch's
# bf16 conv (oneDNN) adds the bias in fp32 before its one rounding, where
# Flax rounds the conv to bf16 and then adds the bias in bf16 (cuDNN's
# route in PyTorch adds the bias apart, as Flax: chip_smoke.py phase 22
# measures it).
LAYER_OUT_SPACINGS = 2.0
# The bias gradient against Flax's: twice the measured 3.5 spacings of its
# largest magnitude (XLA rounds the pixels' partial sums to bf16; the
# port's is within one spacing of a float64 sum).
LAYER_BIAS_GRAD_SPACINGS = 7.0


def _layer(layer):
    """The layer's Flax module and the port's, with the same random fp32
    parameters (a nonzero bias), and a bf16 input."""
    name, cin, cout, stride, k, relu = layer
    rng = np.random.default_rng(len(name) * cin)
    x = _normal(rng, (2, 12, 16, cin))
    kernel = rng.normal(0, 1 / np.sqrt(k * k * cin), (k, k, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.3, (cout,)).astype(np.float32)
    bf = jnp.bfloat16
    if relu:
        fmod = jax_stereo.ConvRelu(cout, stride=stride, kernel=k, dtype=bf)
        pmod = port_stereo.ConvRelu(cin, cout, stride=stride, kernel=k)
    else:
        fmod = _FlaxConv(cout, dtype=bf)
        pmod = torch.nn.Sequential()
        pmod.conv = port_stereo.Conv2d(cin, cout, 3, padding=1)
    params = {"conv": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    with torch.no_grad():
        pmod.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        pmod.conv.bias.copy_(torch.from_numpy(bias))
    return rng, x, fmod, params, pmod


@pytest.mark.parametrize("layer", LAYERS, ids=[x[0] for x in LAYERS])
def test_stereo_convs_follow_flax_dtype_rule(layer):
    """A layer with fp32 parameters on a bf16 input, the port's against
    Flax's with dtype=bfloat16 on the same parameters. Forward: Flax's
    output is the conv rounded to bf16 plus the bias in bf16, bit for bit;
    the port's is PyTorch's bf16 conv with the bias cast to bf16, bit for
    bit, and lies within LAYER_OUT_SPACINGS of Flax's. Backward: the
    input's gradient is bf16, the parameters' fp32 holding bf16 values (fp32
    casts of bf16 gradients, as Flax's); the input's and the weight's
    gradients within one spacing of Flax's (measured 0), the bias's within
    LAYER_BIAS_GRAD_SPACINGS of Flax's and one spacing of a float64 sum."""
    _, _, _, stride, k, relu = layer
    rng, x, fmod, params, pmod = _layer(layer)
    bf = jnp.bfloat16
    want, vjp = jax.vjp(lambda p, a: fmod.apply({"params": p}, a), params, jnp.asarray(x, bf))
    assert want.dtype == bf
    want = np.asarray(want, np.float32)
    g = _normal(rng, want.shape, 0.1)
    wp, wx = vjp(jnp.asarray(g, bf))

    tx = _t(x, True)
    out = pmod(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.dtype == BF16 and pmod.conv.weight.dtype == torch.float32
    out.backward(_t(g))
    got = _np(out)
    with torch.no_grad():
        w16, b16 = pmod.conv.weight.to(BF16), pmod.conv.bias.to(BF16)
        conv = torch.nn.functional.conv2d(_t(x).permute(0, 3, 1, 2), w16, None, stride, k // 2)
        act = torch.relu if relu else (lambda t: t)
        fused = act(torch.nn.functional.conv2d(_t(x).permute(0, 3, 1, 2), w16, b16, stride,
                                               k // 2))
        apart = act(conv + b16[:, None, None])
    np.testing.assert_array_equal(got, _np(fused.permute(0, 2, 3, 1)))
    np.testing.assert_array_equal(want, _np(apart.permute(0, 2, 3, 1)))
    assert _spacings(got, want) <= LAYER_OUT_SPACINGS
    assert tx.grad.dtype == BF16
    assert _spacings(_np(tx.grad), np.asarray(wx, np.float32)) <= 1.0
    gw = pmod.conv.weight.grad.permute(2, 3, 1, 0).numpy()
    gb = pmod.conv.bias.grad.numpy()
    for p_, w_ in ((gw, wp["conv"]["kernel"]), (gb, wp["conv"]["bias"])):
        w_ = np.asarray(w_)
        assert p_.dtype == w_.dtype == np.float32
        np.testing.assert_array_equal(p_, _bf16(p_))  # fp32 casts of bf16
        np.testing.assert_array_equal(w_, _bf16(w_))
    assert _spacings(gw, np.asarray(wp["conv"]["kernel"])) <= 1.0
    assert _spacings(gb, np.asarray(wp["conv"]["bias"])) <= LAYER_BIAS_GRAD_SPACINGS
    mask = (got > 0) if relu else np.ones_like(got, bool)
    assert _spacings(gb, (g.astype(np.float64) * mask).sum((0, 1, 2))) <= 1.0


def test_conv2d_with_its_own_dtype_is_nn_conv2d():
    """Where weight and bias already have the input's dtype (fp32 training,
    the Predictor's bf16 model), Conv2d is nn.Conv2d's call bit for bit."""
    rng = np.random.default_rng(5)
    for dtype in (torch.float32, BF16):
        conv = port_stereo.Conv2d(6, 4, 3, padding=1).to(dtype)
        x = torch.from_numpy(rng.normal(size=(2, 6, 7, 9)).astype(np.float32)).to(dtype)
        assert torch.equal(conv(x), torch.nn.Conv2d.forward(conv, x))
