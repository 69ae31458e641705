"""The stereo training ops of the PyTorch port (scenedepthestimation_tpu_torch)
against their JAX counterparts on the same inputs, made with numpy from a
seed: the three kernels' backward passes (held to ``jax.vjp`` of the JAX
functions), the warp, the stereo losses (values and gradients) and the
stereo augmentation (the transforms given JAX's own draws, the port's
draws held to their ranges).

The port's wrappers take their plain versions here: every tensor lies on
the CPU. The CUDA backward kernels are held to those plain versions on the
card by chip_smoke.py (phase 20).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedepthestimation_tpu import losses as jax_losses
from scenedepthestimation_tpu.ops import augment as jax_aug
from scenedepthestimation_tpu.ops.correlation import _correlation_jnp, _correlation_pallas_op
from scenedepthestimation_tpu_torch import losses
from scenedepthestimation_tpu_torch.models.stereo import split_pair
from scenedepthestimation_tpu_torch.ops import augment, warp
from scenedepthestimation_tpu_torch.ops import soft_argmin as port_sa
from scenedepthestimation_tpu_torch.ops import winograd as wino_ops
from scenedepthestimation_tpu_torch.ops.cuda import _build
from scenedepthestimation_tpu_torch.ops.cuda import correlation as corr_kernel
from scenedepthestimation_tpu_torch.ops.cuda import fused_tail as ft_kernel
from scenedepthestimation_tpu_torch.ops.cuda import soft_argmin as sa_kernel
from scenedepthestimation_tpu_torch.ops.cuda import upsample_concat as upcat_kernel
from scenedepthestimation_tpu_torch.ops.cuda import winograd as wino_kernel

# The modules, not the functions of the same name that ops/__init__ exports.
jax_sa = importlib.import_module("scenedepthestimation_tpu.ops.soft_argmin")
jax_up = importlib.import_module("scenedepthestimation_tpu.ops.upsample")
jax_warp = importlib.import_module("scenedepthestimation_tpu.ops.warp")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _leaf(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy()).requires_grad_()


# ---------------------------------------------------------------------------
# The three backward passes
# ---------------------------------------------------------------------------

# (B, H, W, C, D): the forward tests' shapes: D > W, C off 16, D = 1.
CORR_CASES = [(2, 4, 32, 16, 8), (1, 3, 16, 8, 4), (1, 2, 8, 16, 12), (2, 1, 5, 3, 1)]


@pytest.mark.parametrize("shape", CORR_CASES, ids=lambda s: "x".join(map(str, s)))
def test_correlation_backward_matches_jax_vjp(shape):
    """The gradients of correlation, through the op's registered backward,
    on the tower's interleaved views with the concat's strided gradient,
    vs jax.vjp of the TPU kernel's op (interpret mode, whose VJP is the
    analytic _corr_bwd) and of the jnp oracle; atol 1e-6 (measured 2.4e-7
    against autodiff of the oracle, 0 against _corr_bwd)."""
    b, h, w, c, d = shape
    rng = np.random.default_rng(sum(shape))
    fl, fr = _normal(rng, (b, h, w, c)), _normal(rng, (b, h, w, c))
    g_wide = _normal(rng, (b, h, w, d + c))
    pair = torch.from_numpy(np.stack([fl, fr], axis=1).reshape(2 * b, h, w, c)).requires_grad_()
    f_l, f_r = split_pair(pair)
    out = corr_kernel.correlation(f_l, f_r, d)
    assert out.grad_fn is not None
    g = torch.from_numpy(g_wide)[..., :d]  # W stride d + c, as the concat hands it back
    out.backward(g)
    got = _np(pair.grad).reshape(b, 2, h, w, c)
    # The plain backward on the same strided gradient, called directly.
    direct = corr_kernel.correlation_backward(g, f_l.detach(), f_r.detach(), d)
    for fn in (lambda x, y: _correlation_pallas_op(x, y, d),
               lambda x, y: _correlation_jnp(x, y, d)):
        _, vjp = jax.vjp(fn, jnp.asarray(fl), jnp.asarray(fr))
        want_l, want_r = (np.asarray(v) for v in vjp(jnp.asarray(g_wide[..., :d])))
        np.testing.assert_allclose(got[:, 0], want_l, atol=1e-6)
        np.testing.assert_allclose(got[:, 1], want_r, atol=1e-6)
        np.testing.assert_allclose(_np(direct[0]), want_l, atol=1e-6)
        np.testing.assert_allclose(_np(direct[1]), want_r, atol=1e-6)


@pytest.mark.parametrize("spread", [1.0, 1e3], ids=["unit", "spread1e3"])
@pytest.mark.parametrize("d", [1, 7, 48])
@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_soft_argmin_backward_matches_jax_vjp(d, spread, temperature):
    """dcost of the readout x4 (the feature stride) through the op's
    registered backward vs jax.vjp of the JAX soft_argmin (its default XLA
    path, as the JAX train steps run it) x4; atol 3e-6 x max|dcost|, about
    twice the measured 1.4e-6 x max|dcost| (dcost grows with the scale,
    the cotangent and D, and the two formulas round apart), and at least
    3e-6 (costs spread over 1e3 give dcost of 1e-29)."""
    scale = 4.0
    rng = np.random.default_rng(d + int(spread))
    cost = _normal(rng, (2, 3, 5, d), spread)
    g = _normal(rng, (2, 3, 5))
    t = _leaf(cost)
    out = port_sa.soft_argmin(t, temperature, scale=scale)
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda c: jax_sa.soft_argmin(c, temperature=temperature) * scale,
                     jnp.asarray(cost))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    np.testing.assert_allclose(_np(t.grad), want, atol=3e-6 * max(np.abs(want).max(), 1.0))


def test_soft_argmin_backward_plain_is_autograd_of_the_plain_forward():
    """The explicit formula against autograd of the plain forward; atol
    3e-6 x max|dcost| (measured 1e-6 x), as against JAX."""
    rng = np.random.default_rng(3)
    cost, g = _normal(rng, (4, 6, 48), 3.0), _normal(rng, (4, 6))
    t = _leaf(cost)
    sa_kernel.soft_argmin_plain(t, 4.0).backward(torch.from_numpy(g))
    got = sa_kernel.soft_argmin_backward_plain(torch.from_numpy(g), torch.from_numpy(cost), 4.0)
    np.testing.assert_allclose(_np(got), _np(t.grad), atol=3e-6 * np.abs(_np(t.grad)).max())
    with pytest.raises(NotImplementedError):
        sa_kernel.soft_argmin_backward(torch.from_numpy(g), torch.from_numpy(cost), 4.0, "depth")


# ---------------------------------------------------------------------------
# The CUDA backward kernels' schedules, emulated in numpy
# ---------------------------------------------------------------------------


def _corr_bwd_emulation(g, fl, fr, d):
    """csrc/correlation_bwd.cu's schedule in numpy, fp32: a unit a row's W
    segment, per 64-channel chunk and D chunk (backward_plan) the views'
    zero-filled windows and g's rows staged (d_fl's rows of g are the first
    64 in D chunk 0), each thread's
    ring of 8 columns taking the one that enters at every step, g read as
    4-step vectors (a row a pixel for d_fl, the 11 rows the diagonals cross
    for d_fr), all of a unit's threads at once, d ascending across chunks,
    the 1/C last; fp32 sums. The kernel's FMAs round once where this rounds
    twice."""
    b_, h_, w_, c_ = fl.shape
    plan = corr_kernel.backward_plan(w_, c_, d)
    seg, px, dt, nd, kc = (plan["w_segment"], plan["register_tile"][0], plan["d_tile"],
                           plan["d_tiles"], plan["chunk"])
    ncols = plan["window"]
    assert plan["threads"] == 2 * (seg // px) * (kc // 4)
    pg = np.arange(seg // px)
    d_fl = np.full(fl.shape, np.nan, np.float32)
    d_fr = np.full(fr.shape, np.nan, np.float32)

    def window(view, col0, c0):
        out = np.zeros((ncols, kc), np.float32)
        cols = col0 + np.arange(ncols)
        ok = (cols >= 0) & (cols < w_)
        out[ok, : min(kc, c_ - c0)] = view[cols[ok], c0 : c0 + kc]
        return out

    def g_rows(grow, r0, nrows, d0):
        out = np.zeros((nrows, dt), np.float32)
        rows, ks = r0 + np.arange(nrows), d0 + np.arange(dt)
        out[np.ix_(rows < w_, ks < d)] = grow[np.ix_(rows[rows < w_], ks[ks < d])]
        return out

    for bi in range(b_):
        for hi in range(h_):
            for w0 in range(0, w_, seg):
                for c0 in range(0, c_, kc):
                    acc = {False: np.zeros((len(pg), px, kc), np.float32),
                           True: np.zeros((len(pg), px, kc), np.float32)}
                    for d0 in range(0, nd * dt, dt):
                        graw = g_rows(g[bi, hi], w0 + d0, ncols, d0)
                        rows = {False: graw[:seg] if d0 == 0 else g_rows(g[bi, hi], w0, seg, d0),
                                True: graw}
                        win = {False: window(fr[bi, hi], w0 - d0 - dt + 1, c0),
                               True: window(fl[bi, hi], w0 + d0, c0)}
                        for right in (False, True):
                            jb = px * pg + (0 if right else dt - 1)
                            ring = np.zeros((len(pg), px, kc), np.float32)
                            for i in range(px):
                                if i != (px - 1 if right else 0):
                                    ring[:, i] = win[right][jb + i]
                            for k in range(dt):
                                s = k % 8
                                if s % 4 == 0:  # (pixel group, vector j, 4 steps)
                                    nv = px + 3 if right else px
                                    r = (px * pg)[:, None] + (k if right else 0) + np.arange(nv)
                                    gv = rows[right][r][:, :, k : k + 4]
                                if right:
                                    ring[:, (px - 1 + s) % px] = win[right][jb + px - 1 + k]
                                else:
                                    ring[:, (px - s) % px] = win[right][jb - k]
                                vec = np.arange(px) + (s % 4 if right else 0)
                                gk = gv[:, vec, s % 4]
                                slots = [(i + s) % px if right else (i - s) % px
                                         for i in range(px)]
                                acc[right] += gk[:, :, None] * ring[:, slots]
                    inv_c = np.float32(1) / np.float32(c_)
                    n = min(seg, w_ - w0)
                    for right, out in ((False, d_fl), (True, d_fr)):
                        tile = acc[right].reshape(seg, kc)[:n, : min(kc, c_ - c0)]
                        out[bi, hi, w0 : w0 + n, c0 : c0 + kc] = tile * inv_c
    return d_fl, d_fr


def _corr_problem(shape):
    """(fl, fr, g) for a (B, H, W, C, D) case, g the slice [..., :D] of a
    (D + C)-wide gradient, as the concat hands it back."""
    b, h, w, c, d = shape
    rng = np.random.default_rng(sum(shape) + 7)
    fl, fr = _normal(rng, (b, h, w, c)), _normal(rng, (b, h, w, c))
    return fl, fr, _normal(rng, (b, h, w, d + c))[..., :d]


def _jax_corr_vjp(fl, fr, g):
    d = g.shape[-1]
    _, vjp = jax.vjp(lambda x, y: _correlation_pallas_op(x, y, d), jnp.asarray(fl),
                     jnp.asarray(fr))
    return tuple(np.asarray(v) for v in jax.jit(vjp)(jnp.asarray(np.ascontiguousarray(g))))


# W at the kernel's 64-column segment edges and past two segments, with D
# = 48 (one D chunk) and D = 100 (two; D > W at W <= 65), C = 5.
SCHEDULE_WIDTHS = (63, 64, 65, 130)
SCHEDULE_DS = (48, 100)
CORR_SCHEDULE_CASES = CORR_CASES + [(1, 1, w, 5, d) for d in SCHEDULE_DS for w in SCHEDULE_WIDTHS]


@functools.lru_cache(maxsize=None)
def _jax_corr_vjp_widths(d):
    """jax.vjp of the TPU kernel's op (interpret mode) for the cases
    (1, 1, W, 5, d), W in SCHEDULE_WIDTHS, in one call: each case's
    features and gradient zero-padded to the widest W as one batch entry.
    Columns past W add only zero terms, so each entry's first W columns are
    that case's gradients (one interpret-mode forward and one compile for
    the four, where each costs 2-5 s on the CPU)."""
    wmax = max(SCHEDULE_WIDTHS)
    fl = np.zeros((len(SCHEDULE_WIDTHS), 1, wmax, 5), np.float32)
    fr, g = np.zeros_like(fl), np.zeros((len(SCHEDULE_WIDTHS), 1, wmax, d), np.float32)
    for i, w in enumerate(SCHEDULE_WIDTHS):
        fl[i, :, :w], fr[i, :, :w], g[i, :, :w] = _corr_problem((1, 1, w, 5, d))
    want_l, want_r = _jax_corr_vjp(fl, fr, g)
    return {w: (want_l[i : i + 1, :, :w], want_r[i : i + 1, :, :w])
            for i, w in enumerate(SCHEDULE_WIDTHS)}


@pytest.mark.parametrize("shape", CORR_SCHEDULE_CASES, ids=lambda s: "x".join(map(str, s)))
def test_correlation_backward_schedule_matches_plain_and_jax(shape):
    """The backward kernel's schedule (segments, halos, D chunks, sliding
    register rings, g's row vectors, d ascending), emulated in numpy on the
    concat's strided gradient, equals correlation_backward_plain and
    jax.vjp of the TPU kernel's op (interpret mode) within atol 1e-6."""
    b, h, w, c, d = shape
    fl, fr, g = _corr_problem(shape)
    got = _corr_bwd_emulation(g, fl, fr, d)
    plain = corr_kernel.correlation_backward_plain(
        torch.from_numpy(g), torch.from_numpy(fl), torch.from_numpy(fr), d)
    if shape in CORR_CASES:
        want = _jax_corr_vjp(fl, fr, g)
    else:
        want = _jax_corr_vjp_widths(d)[w]
    for e, p_, j in zip(got, plain, want):
        np.testing.assert_allclose(e, _np(p_), rtol=0, atol=1e-6)
        np.testing.assert_allclose(e, j, rtol=0, atol=1e-6)


def _butterfly(v, op):
    """The kernels' xor-shuffle reduction over the last axis (lanes), in
    its order: lane j combines with lane j ^ o for o = K/2 .. 1."""
    o = v.shape[-1] // 2
    while o:
        v = op(v, v[..., np.arange(v.shape[-1]) ^ o])
        o //= 2
    return v[..., 0]


def _sa_bwd_emulation(g, cost, scale):
    """csrc/soft_argmin.cu's backward in numpy, fp32: with lane_plan's (K
    lanes, NV vectors), lane j of a pixel's group holds the row's 4-value
    vectors j, j + K, ...; its max, its exps (kept) and its two sums in the
    kernel's order, each reduced over the group by the xor butterfly; then
    -g scale / den * ex_k * (k - num / den). Rows without a plan take the
    looped path: lane l of a warp holds d = l, l + 32, ...."""
    d = cost.shape[-1]
    x = cost.reshape(-1, d).astype(np.float32)
    n = x.shape[0]
    plan = sa_kernel.lane_plan(d, torch.float32)
    if plan is None:
        lanes, ks = 32, [np.arange(lane, d, 32) for lane in range(32)]
    else:
        lanes, nv = plan
        ks = [np.concatenate([np.arange(4 * v, 4 * v + 4) for v in range(j, d // 4, lanes)][:nv]
                             or [np.arange(0)]) for j in range(lanes)]
    m = np.full((n, lanes), -np.inf, np.float32)
    den, num = np.zeros((n, lanes), np.float32), np.zeros((n, lanes), np.float32)
    for j, kj in enumerate(ks):
        for k in kj:
            m[:, j] = np.maximum(m[:, j], -x[:, k])
    m = _butterfly(m, np.maximum)
    ex = np.zeros_like(x)
    for j, kj in enumerate(ks):
        for k in kj:
            ex[:, k] = np.exp(-x[:, k] - m)
            den[:, j] += ex[:, k]
            num[:, j] += ex[:, k] * np.float32(k)
    den, num = _butterfly(den, np.add), _butterfly(num, np.add)
    mean = num / den
    gs = -g.reshape(-1).astype(np.float32) * np.float32(scale) / den
    out = (gs[:, None] * ex) * (np.arange(d, dtype=np.float32)[None, :] - mean[:, None])
    return out.reshape(cost.shape)


@pytest.mark.parametrize("d", [1, 7, 12, 24, 48, 200])
def test_soft_argmin_backward_lane_schedule_matches_plain_and_jax(d):
    """The backward kernel's lane-group schedule (lanes and vectors from
    lane_plan; D = 1 and 7 the looped path), emulated in numpy, equals
    soft_argmin_backward_plain and jax.vjp of the JAX readout x4 within
    atol 3e-6 x max|dcost|, as the readout's backward test holds them."""
    scale = 4.0
    rng = np.random.default_rng(d + 11)
    cost, g = _normal(rng, (2, 3, 5, d), 2.0), _normal(rng, (2, 3, 5))
    got = _sa_bwd_emulation(g, cost, scale)
    plain = _np(sa_kernel.soft_argmin_backward_plain(torch.from_numpy(g), torch.from_numpy(cost),
                                                     scale))
    want = np.asarray(jax.jit(lambda c, g_: jax.vjp(
        lambda c_: jax_sa.soft_argmin(c_) * scale, c)[1](g_)[0])(jnp.asarray(cost), jnp.asarray(g)))
    atol = 3e-6 * max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, plain, rtol=0, atol=atol)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# x (B, H, W, C1), skip channels C2: config 4's three joins' channel plans at
# small grids, odd widths.
UPCAT_CASES = [(2, 2, 4, 160, 128), (1, 4, 8, 128, 96), (2, 8, 3, 96, 64), (1, 3, 5, 5, 3)]


@pytest.mark.parametrize("shape", UPCAT_CASES, ids=lambda s: "x".join(map(str, s)))
def test_upsample_concat_backward_matches_jax_vjp_exactly(shape):
    """(dx, dskip) through the op's registered backward vs jax.vjp of the
    JAX upsample_concat (a broadcast and a concatenate). dskip is equal bit
    for bit. dx sums each 2x2 block as ((g00 + g01) + g10) + g11, the
    kernel's order; XLA's CPU reduction adds in that order at C1 = 160, 96
    and 5 (equal bit for bit) and pairs the terms at C1 = 128, (g00 + g01)
    + (g10 + g11): there within atol 1e-6 (measured 4.8e-7, one rounding)."""
    b, h, w, c1, c2 = shape
    rng = np.random.default_rng(sum(shape))
    x, skip = _normal(rng, (b, h, w, c1)), _normal(rng, (b, 2 * h, 2 * w, c2))
    g = _normal(rng, (b, 2 * h, 2 * w, c1 + c2))
    tx, ts = _leaf(x), _leaf(skip)
    out = upcat_kernel.upsample_concat(tx, ts)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jax_up.upsample_concat, jnp.asarray(x), jnp.asarray(skip))
    want_x, want_s = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    np.testing.assert_allclose(_np(tx.grad), want_x, rtol=0, atol=1e-6 if c1 == 128 else 0.0)
    np.testing.assert_array_equal(_np(ts.grad), want_s)


def test_wrappers_take_the_op_only_when_autograd_records():
    """Without grad mode the wrappers call their bodies directly (no graph);
    with an input that needs a gradient they go through the op; a kernel
    without a backward refuses such a call on the card (checked here on
    the guard itself)."""
    x = torch.ones(1, 2, 2, 4, requires_grad=True)
    skip = torch.ones(1, 4, 4, 4)
    with torch.no_grad():
        assert upcat_kernel.upsample_concat(x, skip).grad_fn is None
    assert upcat_kernel.upsample_concat(x, skip).grad_fn is not None
    assert not _build.needs_grad(skip)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _build.no_backward("conv3x3", "ROADMAP.md Queue 2", x)
    with torch.no_grad():
        _build.no_backward("conv3x3", "ROADMAP.md Queue 2", x)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes a wrapper past its
    CPU branch to the card's guard, which raises before anything launches."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _card(shape, grad=False):
    t = torch.ones(shape).as_subclass(_OnCard)
    return t.requires_grad_() if grad else t


def _no_backward_calls(trainable):
    """Each kernel without a backward, called with frozen activations and
    the parameters ``trainable`` names needing a gradient. (conv3x3 has its
    backward kernels since the mono training slice:
    tests/test_torch_mono_train_ops.py.)"""
    w, b = _card((4, 4, 3, 3), "w" in trainable), _card((4,), "b" in trainable)
    phases = [_card((1, 2, 2, 4)) for _ in range(4)]
    u = _card((16, 4, 4), "w" in trainable)
    return {
        "fused_tail": lambda: ft_kernel.fused_tail(_card((1, 4, 4, 4)), w, b, w, b),
        "winograd": lambda: wino_kernel.winograd_conv3x3_phases(phases, u, b),
    }


@pytest.mark.parametrize("trainable", ["w", "b"])
@pytest.mark.parametrize("kernel", ["fused_tail", "winograd"])
def test_kernels_without_a_backward_refuse_trainable_weights_on_the_card(kernel, trainable):
    """A frozen input with a trainable weight or bias (a decoder trained over
    a frozen encoder) raises on the card instead of launching and cutting
    the weights' gradient; the same call in no_grad mode passes the guard
    (and then fails here only for want of the card)."""
    call = _no_backward_calls(trainable)[kernel]
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        call()
    with torch.no_grad(), pytest.raises(Exception) as passed:
        call()
    assert not isinstance(passed.value, NotImplementedError)


def test_winograd_slab_gives_way_to_a_weight_that_needs_a_gradient(monkeypatch):
    """kept_u_slab is a detached copy of the weight's transform: with a
    weight that needs a gradient the wrapper hands the kernel the weight's
    own transform, which carries the gradient (and which the kernel's guard
    on the card refuses); in no_grad mode it hands over the slab."""
    seen = []
    monkeypatch.setattr(wino_kernel, "winograd_conv3x3_phases",
                        lambda phases, u, bias, **kw: seen.append(u))
    x = torch.ones(1, 4, 6, 3)
    w = torch.ones(5, 3, 3, 3, requires_grad=True)
    slab = wino_ops.kept_u_slab(w)
    wino_ops.winograd_conv3x3(x, w, u_slab=slab)
    with torch.no_grad():
        wino_ops.winograd_conv3x3(x, w, u_slab=slab)
    assert seen[0].requires_grad and seen[0] is not slab
    assert seen[1] is slab and not slab.requires_grad


# ---------------------------------------------------------------------------
# Warp and losses
# ---------------------------------------------------------------------------


def _disp_with_ties(rng, b, h, w):
    """Disparities with exact ties of the warp's clip: 0 at x = 0 (src 0)
    and x - (W - 1) where x - disp lands on the last column, plus random
    values, some out of frame."""
    disp = rng.uniform(-2.0, 6.0, (b, h, w)).astype(np.float32)
    disp[:, :, 0] = 0.0
    disp[:, 0, :] = np.arange(w, dtype=np.float32) - (w - 1)
    return disp


def test_warp_matches_jax_at_the_clip_ties():
    """warp_horizontal (gather form) and valid_mask_horizontal vs the JAX
    functions: values and the gradient into disp; rtol 1e-5 + atol 1e-6.
    The disparities hit both clip bounds exactly, where JAX splits the
    cotangent in half and torch.clamp would not."""
    rng = np.random.default_rng(0)
    b, h, w = 2, 4, 10
    img, disp = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32), _disp_with_ties(rng, b, h, w)
    g = _normal(rng, (b, h, w, 3))
    t = _leaf(disp)
    out = warp.warp_horizontal(torch.from_numpy(img), t)
    out.backward(torch.from_numpy(g))
    want, vjp = jax.vjp(lambda d: jax_warp._warp_gather(jnp.asarray(img), d), jnp.asarray(disp))
    (want_g,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(t.grad), np.asarray(want_g), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        _np(warp.valid_mask_horizontal(torch.from_numpy(disp), w)),
        np.asarray(jax_warp.valid_mask_horizontal(jnp.asarray(disp), w)))
    # The ties are hit: torch.clamp's gradient differs there.
    src = np.arange(w, dtype=np.float32) - disp
    assert (src == 0).any() and (src == w - 1).any()
    t2 = _leaf(disp)
    x = torch.arange(w, dtype=torch.float32)
    clamped = torch.clamp(x - t2, 0.0, w - 1.0)
    clamped.sum().backward()
    jaxlike = _leaf(disp)
    warp.clip_jax(x - jaxlike, 0.0, w - 1.0).sum().backward()
    assert not torch.equal(t2.grad, jaxlike.grad)


def _flat_pair(rng, b, h, w):
    """Two frames with identical flat patches (SSIM's clip tie, L1's abs
    tie) on random texture elsewhere."""
    x = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    x[:, 1:6, 2:8] = 0.4
    y[:, 1:6, 2:8] = 0.4
    return x, y


def _check_value_and_grad(port_fn, jax_fn, args, wrt, g=None, rtol=1e-5, atol=1e-7,
                          grad_atol=0.0):
    """port_fn(*torch args) and jax_fn(*jnp args): values and the gradient
    into argument ``wrt`` under cotangent ``g`` (1 for a scalar); the
    gradient also within ``grad_atol`` x its largest magnitude."""
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    targs[wrt] = _leaf(args[wrt])
    out = port_fn(*targs)
    gt = torch.ones(()) if g is None else torch.from_numpy(g)
    out.backward(gt)
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]

    def f(v):
        return jax_fn(*jargs[:wrt], v, *jargs[wrt + 1:])

    want, vjp = jax.vjp(f, jargs[wrt])
    (want_g,) = vjp(jnp.ones(()) if g is None else jnp.asarray(g))
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=rtol, atol=atol)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(_np(targs[wrt].grad), want_g, rtol=rtol,
                               atol=max(atol, grad_atol * np.abs(want_g).max()))
    return out


def test_ssim_and_photometric_error_match_jax_with_flat_patches():
    """ssim and photometric_error vs the JAX functions on frames with
    identical flat patches: values and gradients into the prediction;
    rtol 1e-5 + atol 1e-7, the gradients also within 1e-5 x their largest
    magnitude (measured 4.3e-6 x: inside the flat patches SSIM sits at its
    maximum, so its gradient there is rounding noise of the variance
    terms). The patches give SSIM exactly 0 (the clip's lower bound) and L1
    differences of exactly 0."""
    rng = np.random.default_rng(1)
    x, y = _flat_pair(rng, 2, 8, 12)
    g = _normal(rng, (2, 6, 10, 3))
    out = _check_value_and_grad(losses.ssim, jax_losses.ssim, [x, y], 0, g, grad_atol=1e-5)
    assert (_np(out) == 0).any()
    _check_value_and_grad(losses.photometric_error, jax_losses.photometric_error, [x, y], 0,
                          g[..., 0], grad_atol=1e-5)


def test_edge_aware_smoothness_and_smooth_l1_match_jax():
    """edge_aware_smoothness on a disparity with flat runs (|d| ties at 0)
    and smooth_l1 across |diff| = beta; values and gradients, rtol 1e-5."""
    rng = np.random.default_rng(2)
    disp = rng.uniform(0.5, 2.0, (2, 8, 12, 1)).astype(np.float32)
    disp[:, 2:5, 3:9] = 1.0
    img = rng.uniform(0, 1, (2, 8, 12, 3)).astype(np.float32)
    _check_value_and_grad(losses.edge_aware_smoothness, jax_losses.edge_aware_smoothness,
                          [disp, img], 0)
    pred = rng.uniform(-3, 3, (2, 5, 7)).astype(np.float32)
    target = pred + rng.choice([0.0, 0.5, 1.0, 2.0], pred.shape).astype(np.float32)
    _check_value_and_grad(losses.smooth_l1, jax_losses.smooth_l1, [pred, target], 0,
                          _normal(rng, pred.shape))


def test_stereo_losses_match_jax():
    """stereo_supervised_loss, disparity_classification_loss (temperature
    0.7, stride 4, GT past D) and stereo_selfsup_loss (disparities with the
    warp's clip ties, frames with flat patches) vs the JAX losses: values
    and gradients into the prediction; rtol 1e-5."""
    rng = np.random.default_rng(4)
    b, h, w = 2, 16, 24
    pred = rng.uniform(0, 30, (b, h, w)).astype(np.float32)
    gt = rng.uniform(0, 40, (b, h, w)).astype(np.float32)
    valid = gt > 5.0
    _check_value_and_grad(losses.stereo_supervised_loss, jax_losses.stereo_supervised_loss,
                          [pred, gt, valid], 0)
    cost = _normal(rng, (b, h // 4, w // 4, 8), 2.0)
    _check_value_and_grad(
        lambda c, g_, v: losses.disparity_classification_loss(c, g_, v, 4, 0.7),
        lambda c, g_, v: jax_losses.disparity_classification_loss(c, g_, v, 4, 0.7),
        [cost, gt, valid], 0)
    left, right = _flat_pair(rng, b, h, w)
    disp = _disp_with_ties(rng, b, h, w)
    _check_value_and_grad(losses.stereo_selfsup_loss, jax_losses.stereo_selfsup_loss,
                          [disp, left, right], 0)


def test_selfsup_loss_does_not_reach_the_warped_view():
    """The warped right view is data: no gradient reaches it."""
    rng = np.random.default_rng(5)
    left, right = _flat_pair(rng, 1, 8, 12)
    r = _leaf(right)
    d = _leaf(rng.uniform(0, 3, (1, 8, 12)).astype(np.float32))
    losses.stereo_selfsup_loss(d, torch.from_numpy(left), r).backward()
    assert r.grad is None and d.grad is not None


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------


def _jax_draws(key, b, h, w, crop_hw):
    """The draws jax augment_stereo makes from ``key``, read with its own
    calls, as the port's draw dict."""
    kf, kc, kj, kp = jax.random.split(key, 4)
    draws = {"flip": np.asarray(jax.random.bernoulli(kf, 0.5, (b,)))}
    if crop_hw is not None and tuple(crop_hw) != (h, w):
        ky, kx = jax.random.split(kc)
        draws["y0"] = np.asarray(jax.random.randint(ky, (b,), 0, h - crop_hw[0] + 1))
        draws["x0"] = np.asarray(jax.random.randint(kx, (b,), 0, w - crop_hw[1] + 1))
    else:
        draws["y0"] = draws["x0"] = np.zeros(b, np.int64)
    f = jax_aug._jitter_factors(kj, b, jnp.float32, 0.2, 0.2, 0.2, 0.05)
    draws.update({k: np.asarray(v) for k, v in f.items()})
    draws["jitter"] = np.asarray(jax.random.bernoulli(kp, 1.0, (b,)))
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _stereo_batch(rng, b, h, w, gt):
    batch = {"left": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
             "right": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)}
    if gt in ("left", "both"):
        batch["gt_disp"] = rng.uniform(0, 30, (b, h, w)).astype(np.float32)
        batch["valid"] = batch["gt_disp"] > 3
    if gt == "both":
        batch["gt_disp_right"] = rng.uniform(0, 30, (b, h, w)).astype(np.float32)
        batch["valid_right"] = batch["gt_disp_right"] > 3
    return batch


@pytest.mark.parametrize("gt", ["none", "left", "both"])
@pytest.mark.parametrize("crop", [None, (8, 12)], ids=["nocrop", "crop"])
def test_augment_transform_matches_jax_given_its_draws(gt, crop):
    """augment_stereo, given the draws jax augment_stereo makes from its
    key, vs the JAX function: the flip (with the view swap and the
    right-view GT), the crop and the clean views exactly; the jittered
    views within atol 3e-7 (the per-view mean is summed in another order;
    measured at most 1.8e-7). Seed 7 flips some samples and not others."""
    rng = np.random.default_rng(6)
    b, h, w = 4, 10, 16
    batch = _stereo_batch(rng, b, h, w, gt)
    key = jax.random.PRNGKey(7)
    want = jax_aug.augment_stereo(key, {k: jnp.asarray(v) for k, v in batch.items()},
                                  crop_hw=crop)
    draws = _jax_draws(key, b, h, w, crop)
    assert 0 < int(draws["flip"].sum()) < b
    got = augment.augment_stereo({k: torch.from_numpy(v) for k, v in batch.items()}, draws,
                                 crop_hw=crop)
    assert set(got) == set(want)
    for k in want:
        tol = 3e-7 if k in ("left", "right") else 0.0
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=tol, rtol=0)


def test_port_draws_hold_their_ranges_and_the_pair():
    """The port's draws: flags and offsets in range, the jitter factors in
    [1 - 0.2, 1 + 0.2) and hue in [-0.05, 0.05); a flip swaps and mirrors
    the views; one crop offset applies to every tensor of a sample; a
    left-only GT batch never flips."""
    gen = torch.Generator().manual_seed(11)
    b, h, w, crop = 8, 10, 16, (6, 9)
    d = augment.draw_stereo(gen, b, (h, w), crop_hw=crop)
    assert d["flip"].dtype == torch.bool and 0 < int(d["flip"].sum()) < b
    assert ((0 <= d["y0"]) & (d["y0"] <= h - crop[0])).all()
    assert ((0 <= d["x0"]) & (d["x0"] <= w - crop[1])).all()
    for k in ("brightness", "contrast", "saturation"):
        assert d[k].shape == (b, 1, 1, 1) and ((d[k] >= 0.8) & (d[k] < 1.2)).all()
    assert ((d["hue"] >= -0.05) & (d["hue"] < 0.05)).all() and bool(d["jitter"].all())
    rng = np.random.default_rng(8)
    batch = {k: torch.from_numpy(v) for k, v in _stereo_batch(rng, b, h, w, "none").items()}
    out = augment.augment_stereo(batch, d, crop_hw=crop)
    for i in range(b):
        y, x = int(d["y0"][i]), int(d["x0"][i])
        src_l, src_r = batch["left"][i], batch["right"][i]
        if d["flip"][i]:
            src_l, src_r = src_r.flip(1), src_l.flip(1)
        assert torch.equal(out["left_clean"][i], src_l[y:y + crop[0], x:x + crop[1]])
        assert torch.equal(out["right_clean"][i], src_r[y:y + crop[0], x:x + crop[1]])
    gt_batch = {k: torch.from_numpy(v) for k, v in _stereo_batch(rng, b, h, w, "left").items()}
    out = augment.augment_stereo(gt_batch, d, crop_hw=crop)  # flips drawn, none applied
    for i in range(b):
        y, x = int(d["y0"][i]), int(d["x0"][i])
        window = (slice(y, y + crop[0]), slice(x, x + crop[1]))
        assert torch.equal(out["left_clean"][i], gt_batch["left"][i][window])
        assert torch.equal(out["gt_disp"][i], gt_batch["gt_disp"][i][window])
        assert torch.equal(out["valid"][i], gt_batch["valid"][i][window])
    assert not augment.draw_stereo(gen, b, (h, w), can_flip=False)["flip"].any()
