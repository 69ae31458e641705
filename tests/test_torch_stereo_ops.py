"""Stereo ops of the PyTorch port (scenedepthestimation_tpu_torch) against
their JAX counterparts on the same inputs, made with numpy from a seed.

The Pallas kernels run as tests/test_pallas.py runs them on the CPU:
``interpret=True``. The port's kernel wrappers take their plain PyTorch
versions here, because every tensor lies on the CPU; the CUDA kernels
themselves are checked on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedepthestimation_tpu.ops import upsample as jax_up
from scenedepthestimation_tpu.ops.correlation import _correlation_gram, _correlation_jnp
from scenedepthestimation_tpu.ops.pallas.correlation import correlation_pallas
from scenedepthestimation_tpu.ops.pallas.correlation_v2 import correlation_pallas_v2
from scenedepthestimation_tpu.ops.pallas.correlation_v3 import correlation_pallas_v3
from scenedepthestimation_tpu.ops.pallas.soft_argmin import soft_argmin_pallas
from scenedepthestimation_tpu.ops.soft_argmin import _soft_argmin_jnp
from scenedepthestimation_tpu_torch.ops import correlation as port_corr
from scenedepthestimation_tpu_torch.ops import soft_argmin as port_sa
from scenedepthestimation_tpu_torch.models import stereo as port_stereo
from scenedepthestimation_tpu_torch.ops import upsample as port_up
from scenedepthestimation_tpu_torch.ops.cuda import _build
from scenedepthestimation_tpu_torch.ops.cuda import correlation as corr_kernel
from scenedepthestimation_tpu_torch.ops.cuda import correlation_gram as gram_kernel
from scenedepthestimation_tpu_torch.ops.cuda import soft_argmin as sa_kernel


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# (B, H, W, C, D): the Pallas test's shape; odd B*H; D > W; C off 16; D = 1.
CORR_CASES = [
    (2, 4, 32, 16, 8),
    (1, 3, 16, 8, 4),
    (1, 2, 8, 16, 12),
    (2, 3, 37, 12, 12),
    (1, 1, 5, 3, 1),
]


@pytest.mark.parametrize("shape", CORR_CASES, ids=lambda s: "x".join(map(str, s)))
def test_correlation1d_matches_pallas_kernel_and_oracle(shape):
    """correlation1d on the CPU (the plain shift-and-reduce) vs the TPU
    kernel in interpret mode and the JAX oracle; atol 1e-6 (sums of C
    products in another order)."""
    b, h, w, c, d = shape
    rng = np.random.default_rng(sum(shape))
    fl, fr = _normal(rng, (b, h, w, c)), _normal(rng, (b, h, w, c))
    got = _np(port_corr.correlation1d(torch.from_numpy(fl), torch.from_numpy(fr), d))
    assert got.shape == (b, h, w, d) and got.dtype == np.float32
    for want in (
        correlation_pallas(jnp.asarray(fl), jnp.asarray(fr), d, interpret=True),
        _correlation_jnp(jnp.asarray(fl), jnp.asarray(fr), d),
    ):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    # Out-of-frame right samples contribute exactly zero.
    for k in range(min(d, w)):
        assert not got[:, :, :k, k].any()


def test_correlation_bf16_rounds_once_like_the_tpu_kernel():
    """bf16 in, fp32 sums, bf16 out: within one bf16 rounding (2^-8
    relative) of the TPU kernel in interpret mode."""
    rng = np.random.default_rng(1)
    fl, fr = _normal(rng, (1, 4, 16, 8)), _normal(rng, (1, 4, 16, 8))
    tl = torch.from_numpy(fl).to(torch.bfloat16)
    tr = torch.from_numpy(fr).to(torch.bfloat16)
    got = corr_kernel.correlation(tl, tr, 4)
    assert got.dtype == torch.bfloat16
    want = correlation_pallas(
        jnp.asarray(_np(tl.float()), jnp.bfloat16),
        jnp.asarray(_np(tr.float()), jnp.bfloat16),
        4,
        interpret=True,
    )
    np.testing.assert_allclose(
        _np(got.float()), np.asarray(want.astype(jnp.float32)), rtol=2**-8, atol=1e-6
    )


def test_correlation_wrapper_takes_plain_on_cpu_and_counts_nothing():
    rng = np.random.default_rng(2)
    fl = torch.from_numpy(_normal(rng, (1, 2, 9, 5)))
    fr = torch.from_numpy(_normal(rng, (1, 2, 9, 5)))
    _build.LAUNCHES.clear()
    assert torch.equal(
        corr_kernel.correlation(fl, fr, 3), corr_kernel.correlation_plain(fl, fr, 3)
    )
    assert not _build.LAUNCHES


def test_correlation_rejects_bad_input():
    x = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        corr_kernel.correlation(x, torch.zeros(1, 2, 8, 5), 3)
    with pytest.raises(TypeError, match="f_right is"):
        corr_kernel.correlation(x, x.double(), 3)
    with pytest.raises(ValueError, match="max_disp"):
        corr_kernel.correlation(x, x, 0)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        corr_kernel.correlation(x.to("meta"), x.to("meta"), 3)
    # bf16 features no longer raise: they take the banded-Gram correlation,
    # whose wrapper rejects the same bad input.
    got = port_corr.correlation1d(x.bfloat16(), x.bfloat16(), 3)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, 2, 8, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        gram_kernel.correlation_gram(x.bfloat16(), torch.zeros(1, 2, 8, 5).bfloat16(), 3)
    with pytest.raises(ValueError, match="max_disp"):
        gram_kernel.correlation_gram(x.bfloat16(), x.bfloat16(), 0)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        gram_kernel.correlation_gram(x.bfloat16().to("meta"), x.bfloat16().to("meta"), 3)


# (B, H, W, C, D) straddling the T = 64 tile: w < T, w % T != 0, w % T == 0,
# config 5's W = 288 at D = 48 and D = 24, D > W, C = 24 (not a multiple of
# 16), C = 128 (the _c128 preset), odd B*H.
GRAM_CASES = [
    (2, 4, 32, 16, 8),
    (1, 3, 130, 16, 12),
    (2, 2, 128, 64, 16),
    (1, 2, 288, 64, 48),
    (1, 2, 288, 64, 24),
    (1, 2, 8, 16, 12),
    (2, 3, 37, 24, 12),
    (1, 1, 40, 128, 48),
]


def _bf16_spacing(x: np.ndarray) -> np.ndarray:
    """The gap between neighbouring bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-120)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("shape", GRAM_CASES, ids=lambda s: "x".join(map(str, s)))
def test_correlation_gram_plain_matches_jax_gram_and_pallas(shape):
    """The plain banded Gram on bf16 features vs the JAX package's
    _correlation_gram and the TPU kernels 8 (v3) and 7 (v2) in interpret
    mode. Each side rounds an fp32 sum, taken in its own order, to bf16
    once, so two results may sit one bf16 spacing apart (between 2^-8 and
    2^-7 of |want|, where 2^-8 x |want| bounds one rounding against the
    exact value). For C not a power of two _correlation_gram
    rounds the raw Gram and then scales by the inexact 1/C: two spacings.
    atol 1e-6 for sums that cancel to near zero."""
    b, h, w, c, d = shape
    rng = np.random.default_rng(sum(shape))
    fl = _np(torch.from_numpy(_normal(rng, (b, h, w, c))).bfloat16().float())
    fr = _np(torch.from_numpy(_normal(rng, (b, h, w, c))).bfloat16().float())
    got = gram_kernel.correlation_gram_plain(
        torch.from_numpy(fl).bfloat16(), torch.from_numpy(fr).bfloat16(), d
    )
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, w, d)
    got = _np(got.float())
    jl, jr = jnp.asarray(fl, jnp.bfloat16), jnp.asarray(fr, jnp.bfloat16)
    spacings = 1 if c & (c - 1) == 0 else 2
    for name, want in (
        ("_correlation_gram", _correlation_gram(jl, jr, d)),
        ("v3", correlation_pallas_v3(jl, jr, d, interpret=True)),
        ("v2", correlation_pallas_v2(jl, jr, d, interpret=True)),
    ):
        want = np.asarray(want.astype(jnp.float32))
        bound = spacings * _bf16_spacing(want) + 1e-6
        assert (np.abs(got - want) <= bound).all(), (name, np.abs(got - want).max())
        spacings = 1  # the Pallas kernels scale the fp32 sum before rounding
    # Out-of-frame right samples contribute exactly zero.
    for k in range(min(d, w)):
        assert not got[:, :, :k, k].any()


@pytest.mark.parametrize("shape", GRAM_CASES, ids=lambda s: "x".join(map(str, s)))
def test_correlation_gram_plain_fp32_matches_oracle(shape):
    """In fp32 the band indexing is exact: the plain banded Gram vs the JAX
    oracle at atol 1e-5 (the JAX Gram test's own bound; sums of C products
    in another order)."""
    b, h, w, c, d = shape
    rng = np.random.default_rng(sum(shape) + 1)
    fl, fr = _normal(rng, (b, h, w, c)), _normal(rng, (b, h, w, c))
    got = gram_kernel.correlation_gram_plain(torch.from_numpy(fl), torch.from_numpy(fr), d)
    assert got.dtype == torch.float32
    want = _correlation_jnp(jnp.asarray(fl), jnp.asarray(fr), d)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_correlation1d_dispatches_on_dtype(monkeypatch):
    """bf16 features take the banded Gram and fp32 the correlation kernel,
    each its plain version on the CPU, and no kernel is launched."""
    calls = []
    for mod, name in ((gram_kernel, "correlation_gram_plain"), (corr_kernel, "correlation_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _real=real, _name=name: calls.append(_name) or _real(*a)
        )
    rng = np.random.default_rng(5)
    fl = torch.from_numpy(_normal(rng, (1, 2, 40, 8)))
    fr = torch.from_numpy(_normal(rng, (1, 2, 40, 8)))
    _build.LAUNCHES.clear()
    got16 = port_corr.correlation1d(fl.bfloat16(), fr.bfloat16(), 8)
    got32 = port_corr.correlation1d(fl, fr, 8)
    assert calls == ["correlation_gram_plain", "correlation_plain"]
    assert got16.dtype == torch.bfloat16 and got32.dtype == torch.float32
    assert torch.equal(got16, gram_kernel.correlation_gram(fl.bfloat16(), fr.bfloat16(), 8))
    assert not _build.LAUNCHES


def _staged(rows: np.ndarray, col0: int, ncols: int, cpad: int) -> np.ndarray:
    """A kernel's shared-memory window: columns [col0, col0 + ncols) of one
    row's (W, C) features, channels padded to ``cpad``, zeros outside
    [0, W) and past C."""
    w, c = rows.shape
    out = np.zeros((ncols, cpad), np.float32)
    lo, hi = max(col0, 0), min(col0 + ncols, w)
    if hi > lo:
        out[lo - col0 : hi - col0, :c] = rows[lo:hi]
    return out


def _bf16_round(x: np.ndarray) -> np.ndarray:
    return _np(torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float())


def _gram_blocking(fl: np.ndarray, fr: np.ndarray, d: int, round_bf16: bool) -> np.ndarray:
    """csrc/correlation_gram.cu's blocking in numpy: per (row, W tile, D
    tile) unit the staged left tile and right window (zeros outside
    [0, W)), each warp's m16 rows against only the n8 tiles of its band,
    summed over the K chunks in fp32, the band read out, scaled by 1/C
    and rounded once; every output value written exactly once."""
    b, h, w, c = fl.shape
    plan = gram_kernel.tile_plan(w, c, d)
    t, td, kc = plan["w_tile"], plan["d_tile"], plan["k_chunk"]
    cpad = plan["k_chunks"] * kc
    inv_c = np.float32(1) / np.float32(c)
    out = np.zeros((b, h, w, d), np.float32)
    written = np.zeros((b, h, w, d), np.int64)
    for bi in range(b):
        for hi in range(h):
            for wt in range(plan["w_tiles"]):
                x0 = wt * t
                for dt in range(plan["d_tiles"]):
                    d0 = dt * td
                    tdl = min(td, d - d0)
                    left = _staged(fl[bi, hi], x0, t, cpad)
                    win = _staged(fr[bi, hi], x0 - d0 - (td - 1), plan["window"], cpad)
                    for i in range(t // 16):
                        u = np.arange(16)[:, None]
                        dl = np.arange(tdl)[None, :]
                        j = 16 * i + u + td - 1 - dl  # window column of (u, dl)
                        cols = np.arange(16 * i, min(16 * i + 8 * plan["n8_tiles"], plan["window"]))
                        assert j.min() >= cols[0] and j.max() <= cols[-1]
                        g = np.zeros((16, len(cols)), np.float32)
                        for k0 in range(0, cpad, kc):
                            g += left[16 * i : 16 * i + 16, k0 : k0 + kc] @ win[cols, k0 : k0 + kc].T
                        band = g[u, j - cols[0]] * inv_c
                        x = x0 + 16 * i + np.arange(16)
                        keep = x < w
                        out[bi, hi, x[keep], d0 : d0 + tdl] = band[keep]
                        written[bi, hi, x[keep], d0 : d0 + tdl] += 1
    assert (written == 1).all()
    return _bf16_round(out) if round_bf16 else out


def _corr_blocking(fl: np.ndarray, fr: np.ndarray, d: int) -> np.ndarray:
    """csrc/correlation.cu's blocking in numpy: per (row, W segment, D
    tile) block the staged left segment and right window (zeros outside
    [0, W)), each thread (p, q) its PIXELS x DISPS register tile from its
    PIXELS left columns and the PIXELS + DISPS - 1 right columns it
    shears over, summed over the channel chunks in fp32, scaled by 1/C;
    every output value written exactly once."""
    b, h, w, c = fl.shape
    plan = corr_kernel.tile_plan(w, c, d)
    tw, td = plan["w_segment"], plan["d_tile"]
    px, dx = plan["register_tile"]
    kc = plan["chunk"]
    cpad = plan["chunks"] * kc
    npg, nq = tw // px, td // dx
    assert plan["threads"] == npg * nq and plan["threads"] <= 128
    p = np.arange(npg)[:, None, None, None]
    q = np.arange(nq)[None, :, None, None]
    i = np.arange(px)[None, None, :, None]
    j = np.arange(dx)[None, None, None, :]
    jb = px * p - dx * q + td - dx  # the thread's first right column
    rcol = jb + (i - j + dx - 1)  # right column of (pixel i, disparity j)
    assert rcol.min() >= 0 and rcol.max() < plan["window"]
    lcol = (px * p + i) + 0 * j
    inv_c = np.float32(1) / np.float32(c)
    out = np.zeros((b, h, w, d), np.float32)
    written = np.zeros((b, h, w, d), np.int64)
    for bi in range(b):
        for hi in range(h):
            for seg in range(plan["w_segments"]):
                w0 = seg * tw
                for dt in range(plan["d_tiles"]):
                    d0 = dt * td
                    left = _staged(fl[bi, hi], w0, tw, cpad)
                    right = _staged(fr[bi, hi], w0 - d0 - (td - 1), plan["window"], cpad)
                    acc = np.zeros(np.broadcast(lcol, rcol).shape, np.float32)
                    for k0 in range(0, cpad, kc):
                        acc += (left[lcol, k0 : k0 + kc] * right[rcol, k0 : k0 + kc]).sum(-1)
                    x = np.broadcast_to(w0 + px * p + i, acc.shape)
                    dd = np.broadcast_to(d0 + dx * q + j, acc.shape)
                    keep = (x < w) & (dd < d)
                    out[bi, hi, x[keep], dd[keep]] = acc[keep] * inv_c
                    written[bi, hi, x[keep], dd[keep]] += 1
    assert (written == 1).all()
    return out


# (B, H, W, C, D) for the kernels' blocking: W = 8, 37, 70, 130 and 288 (below
# one tile, ragged, three whole 96-wide tiles); D = 1, 12, 24, 48, 64, 70 and
# 100 (70 and 100: two D tiles), D > W; C = 5, 16, 24, 64 and 128; odd B*H.
BLOCKING_CASES = [
    (1, 3, 8, 16, 12),
    (1, 3, 37, 5, 70),
    (2, 1, 70, 24, 24),
    (1, 1, 130, 64, 100),
    (1, 1, 288, 64, 48),
    (1, 1, 288, 128, 1),
    (1, 3, 37, 16, 64),
    (3, 1, 70, 128, 48),
]


@pytest.mark.parametrize("shape", BLOCKING_CASES, ids=lambda s: "x".join(map(str, s)))
def test_correlation_gram_blocking_matches_plain_and_pallas(shape):
    """The Gram kernel's blocking (numpy model) on bf16 features vs the
    plain version, _correlation_gram and the TPU kernels 8 (v3) and 7 (v2)
    in interpret mode, each within one bf16 spacing + 1e-6 (two against
    _correlation_gram where C is not a power of two, as in the plain
    version's test); in fp32, without the rounding, vs the JAX oracle at
    atol 1e-5."""
    b, h, w, c, d = shape
    rng = np.random.default_rng(sum(shape) + 7)
    fl = _bf16_round(_normal(rng, (b, h, w, c)))
    fr = _bf16_round(_normal(rng, (b, h, w, c)))
    got = _gram_blocking(fl, fr, d, round_bf16=True)
    plain = gram_kernel.correlation_gram_plain(
        torch.from_numpy(fl).bfloat16(), torch.from_numpy(fr).bfloat16(), d
    )
    jl, jr = jnp.asarray(fl, jnp.bfloat16), jnp.asarray(fr, jnp.bfloat16)
    spacings = 1 if c & (c - 1) == 0 else 2
    for name, want, n in (
        ("plain", _np(plain.float()), 1),
        ("_correlation_gram", _correlation_gram(jl, jr, d), spacings),
        ("v3", correlation_pallas_v3(jl, jr, d, interpret=True), 1),
        ("v2", correlation_pallas_v2(jl, jr, d, interpret=True), 1),
    ):
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        bound = n * _bf16_spacing(want) + 1e-6
        assert (np.abs(got - want) <= bound).all(), (name, np.abs(got - want).max())
    got32 = _gram_blocking(fl, fr, d, round_bf16=False)
    oracle = _correlation_jnp(jnp.asarray(fl), jnp.asarray(fr), d)
    np.testing.assert_allclose(got32, np.asarray(oracle), atol=1e-5)


@pytest.mark.parametrize("shape", BLOCKING_CASES, ids=lambda s: "x".join(map(str, s)))
def test_correlation_blocking_matches_plain_and_pallas(shape):
    """The fp32 correlation kernel's blocking (numpy model: segments,
    register tiles, D cover) vs its plain version and the TPU kernel in
    interpret mode, atol 1e-6 as the correlation1d test."""
    b, h, w, c, d = shape
    rng = np.random.default_rng(sum(shape) + 8)
    fl, fr = _normal(rng, (b, h, w, c)), _normal(rng, (b, h, w, c))
    got = _corr_blocking(fl, fr, d)
    plain = corr_kernel.correlation_plain(torch.from_numpy(fl), torch.from_numpy(fr), d)
    np.testing.assert_allclose(got, _np(plain), atol=1e-6)
    want = correlation_pallas(jnp.asarray(fl), jnp.asarray(fr), d, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


@pytest.mark.parametrize(
    "w,c,d,want",
    [
        (288, 64, 48, dict(w_tiles=3, d_tile=48, d_tiles=1, window=143, n8_tiles=8, flat_out=True,
                           k_chunks=1)),
        (288, 128, 48, dict(w_tiles=3, d_tile=48, d_tiles=1, window=143, n8_tiles=8, k_chunks=2)),
        (288, 64, 24, dict(w_tiles=3, d_tile=24, d_tiles=1, window=119, n8_tiles=6)),
        (37, 5, 1, dict(w_tiles=1, d_tile=1, d_tiles=1, window=96, n8_tiles=2, k_chunks=1)),
        (130, 16, 100, dict(w_tiles=2, d_tile=56, d_tiles=2, window=151, n8_tiles=10,
                            flat_out=False)),
        (8, 16, 70, dict(w_tiles=1, d_tile=40, d_tiles=2, n8_tiles=8, flat_out=False)),
    ],
    ids=["config5", "c128", "d96", "d1", "d100", "d70"],
)
def test_correlation_gram_tile_plan(w, c, d, want):
    """The Gram kernel's plan: 96-wide W tiles (three whole ones at the
    bf16 presets' W = 288), all of D <= 64 in one unit whose output is one
    contiguous run, D > 64 in tiles of a multiple of 8, a window of the
    96 + TD - 1 columns the band reads, n8 tiles (a pair for ldmatrix)
    covering 16 + TD - 1 columns, 64-channel chunks, 3 stages."""
    plan = gram_kernel.tile_plan(w, c, d)
    assert {k: plan[k] for k in want} == want
    assert plan["stages"] == 3 and plan["d_tile"] * plan["d_tiles"] >= d
    assert 8 * plan["n8_tiles"] >= 16 + plan["d_tile"] - 1


@pytest.mark.parametrize(
    "w,c,d,want",
    [
        (128, 64, 48, dict(w_segments=2, d_tile=48, d_tiles=1, threads=96, window=111, chunks=2)),
        (288, 128, 48, dict(w_segments=5, d_tile=48, threads=96, chunks=4)),
        (37, 24, 12, dict(w_segments=1, d_tile=16, d_tiles=1, threads=32)),
        (37, 16, 1, dict(d_tile=8, d_tiles=1, threads=16)),
        (130, 16, 100, dict(w_segments=3, d_tile=56, d_tiles=2, threads=112)),
        (70, 64, 64, dict(d_tile=64, d_tiles=1, threads=128, window=127)),
    ],
    ids=["config4", "c128", "d12", "d1", "d100", "d64"],
)
def test_correlation_tile_plan(w, c, d, want):
    """The fp32 kernel's plan: 64-column W segments (config 4's 256 rows
    give 512 blocks, about 4 an SM of an H100), a 4 x 8 register tile, D
    in one tile of whole 8-disparity groups up to 64 (D = 48: six groups,
    no idle lane), the window of 64 + TD - 1 columns staged once for all
    of the tile's D, 32-channel chunks in 2 stages."""
    plan = corr_kernel.tile_plan(w, c, d)
    assert {k: plan[k] for k in want} == want
    assert plan["register_tile"] == (4, 8) and plan["stages"] == 2
    assert plan["d_tile"] % 8 == 0 and plan["d_tile"] * plan["d_tiles"] >= d


def test_split_pair_returns_views():
    """split_pair hands out views of the tower's interleaved output, which
    the kernels read in place: the batch stride doubles, the rows stay
    contiguous, and batch_stride accepts them and refuses other layouts."""
    b, h, w, c = 3, 4, 10, 8
    feats = torch.from_numpy(_normal(np.random.default_rng(9), (2 * b, h, w, c)))
    f_l, f_r = port_stereo.split_pair(feats)
    assert f_l.data_ptr() == feats.data_ptr()
    assert f_r.data_ptr() == feats.data_ptr() + h * w * c * feats.element_size()
    assert f_l.stride() == f_r.stride() == (2 * h * w * c, w * c, c, 1)
    assert torch.equal(f_l, feats[0::2]) and torch.equal(f_r, feats[1::2])
    assert corr_kernel.batch_stride(f_l, "correlation") == 2 * h * w * c
    assert corr_kernel.batch_stride(f_l[:1], "correlation") == h * w * c
    for bad in (f_l.transpose(2, 3), f_l[:, :, :5], f_l[..., :4]):
        with pytest.raises(ValueError, match="reads \\(W, C\\) rows"):
            corr_kernel.batch_stride(bad, "correlation")


@pytest.mark.parametrize(
    "fn,dtype",
    [
        (corr_kernel.correlation, torch.float32),
        (corr_kernel.correlation, torch.bfloat16),
        (gram_kernel.correlation_gram, torch.bfloat16),
    ],
    ids=["correlation-fp32", "correlation-bf16", "correlation_gram"],
)
def test_correlation_wrappers_read_interleaved_views_exactly(fn, dtype):
    """On the CPU each wrapper gives the interleaved views of the tower's
    output exactly the answer it gives their contiguous copies, and
    launches nothing."""
    feats = torch.from_numpy(_normal(np.random.default_rng(10), (6, 3, 37, 24))).to(dtype)
    f_l, f_r = port_stereo.split_pair(feats)
    assert not f_l.is_contiguous()
    _build.LAUNCHES.clear()
    got = fn(f_l, f_r, 12)
    assert torch.equal(got, fn(f_l.contiguous(), f_r.contiguous(), 12))
    assert got.dtype == dtype and tuple(got.shape) == (3, 3, 37, 12)
    assert not _build.LAUNCHES


# (shape, temperature, scale, epilogue)
SA_CASES = [
    ((2, 4, 16, 24), 1.0, 1.0, "none"),
    ((1, 3, 7, 48), 1.0, 4.0, "none"),
    ((1, 2, 9, 12), 0.5, 4.0, "none"),
    ((1, 2, 8, 16), 1.0, 4.0, "depth"),
    ((2, 1, 5, 1), 1.0, 4.0, "none"),
]


@pytest.mark.parametrize(
    "shape,temperature,scale,epilogue",
    SA_CASES,
    ids=["d24", "d48-scale4", "d12-t0.5", "depth-epilogue", "d1"],
)
def test_soft_argmin_matches_pallas_kernel(shape, temperature, scale, epilogue):
    """The port's soft-argmin on the CPU vs the TPU kernel in interpret
    mode on the pre-divided cost (the JAX kernel path's temperature); the
    disparity at atol 1e-5 in disparity-index units (before the exact x4
    scale, so 4e-5 after it), the depth epilogue at rtol 1e-5."""
    rng = np.random.default_rng(len(shape) + shape[-1])
    cost = _normal(rng, shape, 2.0)
    fb = 721.5377 * 0.54
    want = np.asarray(
        soft_argmin_pallas(
            jnp.asarray(cost) / jnp.float32(temperature),
            scale=scale, epilogue=epilogue, fb=fb, interpret=True,
        )
    )
    if epilogue == "depth":
        got = sa_kernel.soft_argmin(
            torch.from_numpy(cost), scale=scale, epilogue="depth", fb=fb
        )
        np.testing.assert_allclose(_np(got), want, rtol=1e-5)
    else:
        got = port_sa.soft_argmin(torch.from_numpy(cost), temperature, scale=scale)
        np.testing.assert_allclose(_np(got), want, atol=1e-5 * scale)
        # ... and the JAX oracle, which divides inside the softmax.
        oracle = np.asarray(_soft_argmin_jnp(jnp.asarray(cost), temperature)) * scale
        np.testing.assert_allclose(_np(got), oracle, atol=1e-5 * scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:-1]


def _soft_argmin_lanes(cost, scale, epilogue, fb, lanes, vecs, per_vec):
    """The kernel's lane-group reduction in plain PyTorch. Lane j of a
    pixel's ``lanes`` holds the row's vectors j, j + lanes, ... (``vecs``
    of them, ``per_vec`` values each; past D nothing). Each lane takes the
    max of its values, the group the max of the lanes'; each lane sums exp
    and d * exp over its values in order, and the group merges the lanes'
    sums by xor butterflies (offsets lanes / 2 .. 1) as its first lane,
    which writes, sees them."""
    d = cost.shape[-1]
    c = cost.float().reshape(-1, d)
    slots = lanes * vecs * per_vec
    vals = torch.full((c.shape[0], slots), float("inf"))  # exp(-inf) = 0, never the max
    vals[:, :d] = c
    vals = vals.reshape(-1, vecs, lanes, per_vec)  # vector i * lanes + j
    idx = torch.arange(slots, dtype=torch.float32).reshape(vecs, lanes, per_vec)
    m = (-vals).amax(dim=(1, 3)).amax(dim=1)[:, None, None, None]
    ex = torch.exp(-vals - m)
    den = torch.zeros(c.shape[0], lanes)
    num = torch.zeros(c.shape[0], lanes)
    for i in range(vecs):
        for e in range(per_vec):
            den = den + ex[:, i, :, e]
            num = num + ex[:, i, :, e] * idx[i, :, e]
    o = lanes // 2
    while o:
        partner = torch.arange(lanes) ^ o
        den, num = den + den[:, partner], num + num[:, partner]
        o //= 2
    disp = num[:, 0] / den[:, 0] * scale
    if epilogue == "depth":
        disp = fb / torch.clamp(disp, min=1e-6)
    return disp.reshape(cost.shape[:-1])


# (D, cost dtype, epilogue, cost spread): D = 1 and 7 and the bf16 D = 7 take
# the looped path (a warp a pixel); D = 12, 24, 48 and 200 the lane groups
# (1, 2, 4 and 16 lanes in fp32); a spread of 1e3 underflows exp without
# the max subtracted.
SA_LANE_CASES = [
    (1, torch.float32, "none", 2.0),
    (7, torch.float32, "none", 2.0),
    (12, torch.float32, "none", 2.0),
    (24, torch.float32, "none", 2.0),
    (48, torch.float32, "none", 2.0),
    (200, torch.float32, "none", 2.0),
    (7, torch.bfloat16, "none", 2.0),
    (48, torch.bfloat16, "none", 2.0),
    (48, torch.float32, "depth", 2.0),
    (48, torch.float32, "none", 1e3),
    (200, torch.float32, "none", 1e3),
]


@pytest.mark.parametrize(
    "d,dtype,epilogue,spread",
    SA_LANE_CASES,
    ids=["d1", "d7", "d12", "d24", "d48", "d200", "bf16-d7", "bf16-d48", "depth", "spread-d48",
         "spread-d200"],
)
def test_soft_argmin_lane_groups_match_pallas_kernel(d, dtype, epilogue, spread):
    """The kernel's schedule (lane_plan's lanes a pixel, or the looped
    path's 32 lanes of one value a vector) modelled in plain PyTorch, vs
    the TPU kernel in interpret mode on the same (bf16-rounded) cost:
    atol 1e-5 x scale + rtol 1e-5 in disparity, rtol 1e-5 in depth."""
    rng = np.random.default_rng(d)
    cost = torch.from_numpy(_normal(rng, (2, 3, 5, d), spread)).to(dtype)
    scale, fb = 4.0, 721.5377 * 0.54
    plan = sa_kernel.lane_plan(d, dtype)
    if plan is None:
        lanes, vecs, per_vec = 32, -(-d // 32), 1
    else:
        (lanes, vecs), per_vec = plan, 16 // cost.element_size()
    assert (plan is None) == (d in (1, 7))
    got = _soft_argmin_lanes(cost, scale, epilogue, fb, lanes, vecs, per_vec)
    jcost = jnp.asarray(_np(cost.float()))
    if dtype == torch.bfloat16:
        jcost = jcost.astype(jnp.bfloat16)
    want = np.asarray(soft_argmin_pallas(jcost, scale=scale, epilogue=epilogue, fb=fb,
                                         interpret=True))
    atol = 0.0 if epilogue == "depth" else 1e-5 * scale
    np.testing.assert_allclose(_np(got), want, atol=atol, rtol=1e-5)


def test_soft_argmin_wrapper_upcasts_bf16_and_counts_nothing():
    rng = np.random.default_rng(3)
    cost = torch.from_numpy(_normal(rng, (1, 2, 3, 10))).bfloat16()
    _build.LAUNCHES.clear()
    got = sa_kernel.soft_argmin(cost, scale=2.0)
    assert got.dtype == torch.float32
    assert torch.equal(got, sa_kernel.soft_argmin_plain(cost.float(), scale=2.0))
    assert not _build.LAUNCHES
    with pytest.raises(ValueError, match="unknown epilogue"):
        sa_kernel.soft_argmin(cost, epilogue="inverse")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        sa_kernel.soft_argmin(cost.to("meta"))


@pytest.mark.parametrize("shape", [(2, 4, 8, 1), (1, 5, 3, 2)])
def test_upsample4x_bilinear_matches_packed(shape):
    """Two 2x half-pixel bilinear passes vs the JAX parity-plane form
    (pinned equal to the same composition) and the composition itself;
    atol 1e-6 on unit-normal values."""
    x = _normal(np.random.default_rng(4), shape)
    got = _np(port_up.upsample4x_bilinear(torch.from_numpy(x)))
    b, h, w, c = shape
    assert got.shape == (b, 4 * h, 4 * w, c)
    np.testing.assert_allclose(
        got, np.asarray(jax_up.upsample4x_bilinear_packed(jnp.asarray(x))), atol=1e-6
    )
    twice = jax_up.upsample2x(jax_up.upsample2x(jnp.asarray(x), "bilinear"), "bilinear")
    np.testing.assert_allclose(got, np.asarray(twice), atol=1e-6)
