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
