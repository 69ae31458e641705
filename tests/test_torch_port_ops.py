"""Ops of the PyTorch port (scenedepthestimation_tpu_torch) against their
JAX counterparts on the same inputs, made with numpy from a seed.

The Pallas kernels run as tests/test_pallas.py runs them on the CPU:
``interpret=True``. The port's kernel wrappers take their plain PyTorch
versions here, because every tensor lies on the CPU; the CUDA kernels
themselves are checked on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedepthestimation_tpu.configs import PreprocessConfig as JaxPreprocessConfig
from scenedepthestimation_tpu.ops.disp_to_depth import (
    depth_from_disparity as jax_depth_from_disparity,
    disp_to_depth as jax_disp_to_depth,
)
from scenedepthestimation_tpu.ops import preprocess as jax_pre
from scenedepthestimation_tpu.ops import upsample as jax_up
from scenedepthestimation_tpu.ops.pallas.conv_block import conv3x3_elu_pallas
from scenedepthestimation_tpu.ops.pallas.upsample_concat import upsample_concat_pallas
from scenedepthestimation_tpu_torch.configs import PreprocessConfig
from scenedepthestimation_tpu_torch.data import io as port_io
from scenedepthestimation_tpu_torch.ops import disp_to_depth as port_d2d
from scenedepthestimation_tpu_torch.ops import fused_tail
from scenedepthestimation_tpu_torch.ops import preprocess as port_pre
from scenedepthestimation_tpu_torch.ops import upsample as port_up
from scenedepthestimation_tpu_torch.ops.cuda import _build, conv_block, upsample_concat


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@pytest.mark.parametrize(
    "src_hw,antialias",
    [((100, 300), True), ((50, 150), True), ((81, 230), False)],
    ids=["down-aa", "up-aa", "down-noaa"],
)
def test_preprocess_matches_jax(src_hw, antialias):
    """Non-integer resize ratios to the 64x192 net size; atol 2e-6 (the
    two resamplers sum their taps in another order). Some ratios differ
    more: 250 -> 192 px by up to 8e-6 before normalization, where the two
    libraries cut the antialias filter's support at another tap; the
    slice's 375x1242 -> 192x640 differs by 5e-7."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(2, *src_hw, 3), dtype=np.uint8)
    want = jax_pre.preprocess(
        jnp.asarray(img), (64, 192), JaxPreprocessConfig(antialias=antialias)
    )
    got = port_pre.preprocess(
        torch.from_numpy(img), (64, 192), PreprocessConfig(antialias=antialias)
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 64, 192, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-6)


def test_preprocess_same_size_skips_resize_and_casts_last():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(1, 64, 192, 3), dtype=np.uint8)
    want = jax_pre.preprocess(jnp.asarray(img), (64, 192), compute_dtype=jnp.bfloat16)
    got = port_pre.preprocess(torch.from_numpy(img), (64, 192), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(got.float()), np.asarray(want.astype(jnp.float32))
    )


def test_resize_back_without_antialias_matches_jax():
    """The disparity resize to source size (no antialias); atol 2e-6."""
    rng = np.random.default_rng(2)
    disp = rng.uniform(0, 1, size=(2, 64, 192, 1)).astype(np.float32)
    want = jax_pre.resize_bilinear(jnp.asarray(disp), (50, 150), antialias=False)
    got = port_pre.resize_bilinear(torch.from_numpy(disp), (50, 150), antialias=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("border", ["reflect", "edge"])
@pytest.mark.parametrize("activation", ["elu", "sigmoid", "none"])
def test_conv3x3_plain_matches_pallas_kernel(activation, border):
    """conv3x3_plain vs the TPU kernel in interpret mode; atol 5e-6, as
    tests/test_pallas.py holds the kernel to its XLA oracle. The sigmoid is
    held to the kernel, which applies it (conv3x3_xla does not)."""
    rng = np.random.default_rng(10)
    for b, h, w, cin, cout in [(2, 16, 24, 8, 12), (1, 8, 10, 3, 5)]:
        x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
        k = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
        bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
        want = conv3x3_elu_pallas(
            jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
            activation=activation, border=border, interpret=True,
        )
        got = conv_block.conv3x3_plain(
            torch.from_numpy(x),
            torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))),
            torch.from_numpy(bias),
            activation=activation,
            border=border,
        )
        np.testing.assert_allclose(
            _np(got), np.asarray(want), atol=5e-6, err_msg=f"{(b, h, w, cin, cout)}"
        )


def test_conv3x3_wrapper_takes_plain_on_cpu_and_counts_nothing():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(1, 6, 7, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 4, 3, 3)).astype(np.float32))
    b = torch.zeros(3)
    _build.LAUNCHES.clear()
    got = conv_block.conv3x3(x, w, b, activation="sigmoid", out_dtype=torch.float32)
    want = conv_block.conv3x3_plain(x, w, b, activation="sigmoid", out_dtype=torch.float32)
    assert torch.equal(got, want)
    assert not _build.LAUNCHES


def test_conv3x3_rejects_bad_input():
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="weight must be"):
        conv_block.conv3x3(x, torch.zeros(2, 4, 3, 3), torch.zeros(2))
    with pytest.raises(ValueError, match="needs H, W >= 1"):
        conv_block.conv3x3(torch.zeros(1, 0, 4, 3), torch.zeros(2, 3, 3, 3), torch.zeros(2))
    with pytest.raises(ValueError, match="unknown activation"):
        conv_block.conv3x3(x, torch.zeros(2, 3, 3, 3), torch.zeros(2), activation="gelu")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        conv_block.conv3x3(x.to("meta"), torch.zeros(2, 3, 3, 3), torch.zeros(2))


def test_upsample_concat_plain_matches_pallas_kernel_exactly():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 8, 16)).astype(np.float32)
    skip = rng.normal(size=(2, 8, 16, 12)).astype(np.float32)
    want = upsample_concat_pallas(jnp.asarray(x), jnp.asarray(skip), interpret=True)
    got = upsample_concat.upsample_concat_plain(torch.from_numpy(x), torch.from_numpy(skip))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    _build.LAUNCHES.clear()
    got = upsample_concat.upsample_concat(torch.from_numpy(x), torch.from_numpy(skip))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert not _build.LAUNCHES


def test_upsample_concat_shape_guard():
    with pytest.raises(ValueError, match="does not match"):
        upsample_concat.upsample_concat(torch.zeros(1, 4, 8, 3), torch.zeros(1, 9, 16, 3))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_upsample_ops_match_jax(mode):
    """upsample2x and upsample_concat with an oversized skip (cropped
    first); nearest is exact, bilinear atol 1e-6."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    skip = rng.normal(size=(2, 11, 15, 4)).astype(np.float32)
    atol = 0 if mode == "nearest" else 1e-6
    np.testing.assert_allclose(
        _np(port_up.upsample2x(torch.from_numpy(x), mode)),
        np.asarray(jax_up.upsample2x(jnp.asarray(x), mode)),
        atol=atol,
    )
    np.testing.assert_allclose(
        _np(port_up.upsample_concat(torch.from_numpy(x), torch.from_numpy(skip), mode)),
        np.asarray(jax_up.upsample_concat(jnp.asarray(x), jnp.asarray(skip), mode)),
        atol=atol,
    )


def test_disp_to_depth_matches_jax():
    rng = np.random.default_rng(7)
    disp = rng.uniform(0, 1, size=(2, 8, 9)).astype(np.float32)
    want = jax_disp_to_depth(jnp.asarray(disp), 0.1, 100.0)
    got = port_d2d.disp_to_depth(torch.from_numpy(disp), 0.1, 100.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6)
    px = rng.uniform(0, 50, size=(2, 8, 9)).astype(np.float32)
    np.testing.assert_allclose(
        _np(port_d2d.depth_from_disparity(torch.from_numpy(px), 721.5, 0.54)),
        np.asarray(jax_depth_from_disparity(jnp.asarray(px), 721.5, 0.54)),
        rtol=1e-6,
    )


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_load_image_matches_jax(mode, tmp_path):
    """RGB uint8 from RGB, RGBA and gray PNGs, as the JAX load_image gives
    it; and the same pixels from the encoded bytes (inline requests)."""
    from PIL import Image

    from scenedepthestimation_tpu.data import io as jax_io

    rng = np.random.default_rng(8)
    ch = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    arr = rng.integers(0, 256, size=(37, 53, ch), dtype=np.uint8)
    path = tmp_path / "f.png"
    Image.fromarray(arr.squeeze(-1) if ch == 1 else arr, mode=mode).save(path)
    got = port_io.load_image(str(path))
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, jax_io.load_image(str(path)))
    np.testing.assert_array_equal(port_io.decode_image(path.read_bytes()), got)


def _tail_inputs(rng, b, h, w, c1, c0, c0o):
    y1 = rng.normal(size=(b, h, w, c1)).astype(np.float32)
    k00 = (rng.normal(size=(3, 3, c1, c0)) * 0.2).astype(np.float32)
    b00 = rng.normal(size=(c0,)).astype(np.float32)
    k01 = (rng.normal(size=(3, 3, c0, c0o)) * 0.2).astype(np.float32)
    b01 = rng.normal(size=(c0o,)).astype(np.float32)
    return y1, k00, b00, k01, b01


def _torch_tail_args(y1, k00, b00, k01, b01, dtype=torch.float32):
    """Numpy NHWC/HWIO inputs -> the port's (y1, w00, b00, w01, b01)."""
    def oihw(k):
        return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).to(dtype)

    return (torch.from_numpy(y1).to(dtype), oihw(k00), torch.from_numpy(b00).to(dtype),
            oihw(k01), torch.from_numpy(b01).to(dtype))


@pytest.mark.parametrize(
    "h4,w4,dtype",
    [(8, 16, "float32"), (12, 8, "float32"), (8, 16, "bfloat16")],
)
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_fused_tail_plain_matches_pallas_kernels(version, h4, w4, dtype):
    """fused_tail_plain vs TPU kernels 3 (fused_tail_pallas) and 4
    (fused_tail_pallas_v2) in interpret mode, fed the packed operands as
    tests/test_fused_tail.py builds them, their double-packed output
    unpacked with two depth_to_space. fp32: atol 1e-5, the JAX package's
    own tolerance; bf16: atol one bf16 spacing at the output's largest
    magnitude (both round z and y0 from fp32 sums taken in other orders,
    and a flipped rounding of z moves the outputs near zero by as much as
    those far from it)."""
    from scenedepthestimation_tpu.ops import collapsed, packed
    from scenedepthestimation_tpu.ops.pallas.fused_tail import fused_tail_pallas
    from scenedepthestimation_tpu.ops.pallas.fused_tail_v2 import fused_tail_pallas_v2

    kernel = {"v1": fused_tail_pallas, "v2": fused_tail_pallas_v2}[version]
    c1, c0 = 12, 4
    y1, k00, b00, k01, b01 = _tail_inputs(np.random.default_rng(0), 2, 2 * h4, 2 * w4, c1, c0, c0)
    jdt = jnp.dtype(dtype)
    k00j, k01j = jnp.asarray(k00).astype(jdt), jnp.asarray(k01).astype(jdt)
    y0pp = kernel(
        packed.space_to_depth(jnp.asarray(y1).astype(jdt)),
        packed.pack_conv3x3_kernel(k00j),
        jnp.tile(jnp.asarray(b00).astype(jdt), 4),
        packed.pack_conv3x3_kernel(collapsed.collapse_upsample_conv_kernel(k01j)),
        jnp.tile(jnp.asarray(b01).astype(jdt), 16),
        interpret=True,
    )
    want = np.asarray(packed.depth_to_space(packed.depth_to_space(y0pp)).astype(jnp.float32))
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = fused_tail.fused_tail_plain(*_torch_tail_args(y1, k00, b00, k01, b01, tdt))
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (2, 4 * h4, 4 * w4, c0)
    got = _np(got.float())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        spacing = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, atol=spacing, rtol=0)


@pytest.mark.parametrize(
    "shape", [(2, 5, 7, 3, 5, 6), (1, 2, 3, 12, 5, 7), (1, 2, 2, 8, 4, 4)],
    ids=["odd-w", "h2-odd-w", "h2-w2"],
)
def test_fused_tail_plain_equals_unfused_chain(shape):
    """The plain version is the decoder's unfused level 0 exactly in fp32:
    conv3x3 -> upsample2x -> conv3x3, at h = 2, w = 2 and odd w (the
    reflect border's smallest cases); and the CPU wrapper takes it and
    launches nothing."""
    b, h, w, c1, c0, c0o = shape
    args = _torch_tail_args(*_tail_inputs(np.random.default_rng(1), *shape))
    y1, w00, b00, w01, b01 = args
    want = conv_block.conv3x3(port_up.upsample2x(conv_block.conv3x3(y1, w00, b00)), w01, b01)
    _build.LAUNCHES.clear()
    got = fused_tail.fused_tail(*args)
    assert not _build.LAUNCHES
    assert tuple(got.shape) == (b, 2 * h, 2 * w, c0o)
    assert torch.equal(got, want)
    assert torch.equal(fused_tail.fused_tail_plain(*args), want)


def test_fused_tail_rejects_bad_input_and_flags():
    args = _torch_tail_args(*_tail_inputs(np.random.default_rng(2), 1, 4, 4, 3, 2, 2))
    with pytest.raises(ValueError, match="w00 must be"):
        fused_tail.fused_tail(args[0], args[3], *args[2:])
    with pytest.raises(ValueError, match="h, w >= 2"):
        fused_tail.fused_tail(args[0][:, :1], *args[1:])
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        fused_tail.fused_tail(args[0].to("meta"), *args[1:])
    with pytest.raises(ValueError, match="flag must be"):
        fused_tail.set_use_fused_tail("v3")
    assert not fused_tail.enabled()  # off by default, as in the JAX package


def _wino_data(b, h, w, c, co, seed):
    """x, the kernel in the JAX layout (3, 3, C, Co), bias and residual, as
    tests/test_winograd.py makes them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    g = (rng.normal(size=(3, 3, c, co)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    res = rng.normal(size=(b, h, w, co)).astype(np.float32)
    return x, g, bias, res


def _oihw(g: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(g).permute(3, 2, 0, 1).contiguous()


def test_winograd_transform_weights_matches_jax():
    """U of the port's (Co, C, 3, 3) kernel vs the JAX function's of the
    same kernel as HWIO; atol 1e-7 (sums of three fp32 terms)."""
    from scenedepthestimation_tpu.ops.pallas import winograd as jax_wino
    from scenedepthestimation_tpu_torch.ops import winograd

    _, g, _, _ = _wino_data(1, 2, 2, 5, 7, 0)
    got = winograd.transform_weights(_oihw(g))
    want = np.asarray(jax_wino.transform_weights(jnp.asarray(g)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 5, 7)
    np.testing.assert_allclose(_np(got), want, atol=1e-7, rtol=0)


# (B, H, W, C, Co, th): tests/test_winograd.py's shape; its multi-block
# case (th=4: four row blocks, both halo directions and the first/last
# masking in the TPU kernel); C and Co off every tile width.
_WINO_SHAPES = {"base": (1, 8, 16, 8, 8, None), "th4": (2, 32, 12, 4, 8, 4), "ragged": (2, 6, 10, 5, 7, None)}


@pytest.mark.parametrize(
    "shape,relu,use_res",
    [("base", relu, res) for relu in (False, True) for res in (False, True)]
    + [("th4", True, False), ("ragged", True, True)],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_winograd_plain_matches_pallas_kernel(shape, relu, use_res, dtype):
    """winograd_conv3x3_phases_plain vs the TPU kernel in interpret mode on
    the same phases. fp32: atol 1e-5, the JAX package's own tolerance
    (measured 9.5e-7). bf16: one bf16 spacing of each element (measured 0:
    both take the input transform in bf16 with the same two roundings and
    the products in fp32; two fp32 sums taken in other orders may round to
    neighbouring bf16 values)."""
    from scenedepthestimation_tpu.ops.pallas import winograd as jax_wino
    from scenedepthestimation_tpu_torch.ops import winograd

    b, h, w, c, co, th = _WINO_SHAPES[shape]
    x, g, bias, res = _wino_data(b, h, w, c, co, seed=len(shape))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_wino.winograd_conv3x3_phases(
        jax_wino.space_to_phases(jnp.asarray(x).astype(jdt)),
        jax_wino.transform_weights(jnp.asarray(g)),
        jnp.asarray(bias),
        residual_phases=jax_wino.space_to_phases(jnp.asarray(res).astype(jdt)) if use_res else None,
        relu=relu, interpret=True, th=th,
    )
    _build.LAUNCHES.clear()
    got = winograd.winograd_conv3x3_phases(
        winograd.space_to_phases(torch.from_numpy(x).to(tdt)),
        winograd.transform_weights(_oihw(g)),
        torch.from_numpy(bias),
        residual_phases=winograd.space_to_phases(torch.from_numpy(res).to(tdt)) if use_res else None,
        relu=relu,
    )
    assert not _build.LAUNCHES  # CPU tensors take the plain version
    assert len(got) == 4
    for gp, wp in zip(got, want):
        assert gp.dtype == tdt and tuple(gp.shape) == (b, h // 2, w // 2, co)
        wp = np.asarray(wp.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(_np(gp), wp, atol=1e-5, rtol=0)
        else:
            spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wp), 2.0 ** -120))) - 7)
            assert (np.abs(_np(gp.float()) - wp) <= spacing).all()


@pytest.mark.parametrize("use_res", [False, True])
def test_winograd_conv3x3_matches_direct_conv(use_res):
    """The NHWC wrapper (phases as views, the output written in place) vs
    the port's and the JAX package's direct-conv oracles, zero padding, fp32;
    atol 1e-5 (tests/test_winograd.py's)."""
    from scenedepthestimation_tpu.ops.pallas import winograd as jax_wino
    from scenedepthestimation_tpu_torch.ops import winograd

    x, g, bias, res = _wino_data(2, 6, 10, 5, 7, seed=3)
    r = res if use_res else None
    got = winograd.winograd_conv3x3(
        torch.from_numpy(x), _oihw(g), torch.from_numpy(bias),
        residual=None if r is None else torch.from_numpy(r),
    )
    ref = winograd.conv3x3_reference(
        torch.from_numpy(x), _oihw(g), torch.from_numpy(bias),
        residual=None if r is None else torch.from_numpy(r),
    )
    want = np.asarray(jax_wino.conv3x3_reference(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(bias),
        residual=None if r is None else jnp.asarray(r),
    ))
    assert got.is_contiguous() and tuple(got.shape) == (2, 6, 10, 7)
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(ref), want, atol=1e-5, rtol=0)


def test_winograd_phases_round_trip_and_odd_sizes_raise():
    from scenedepthestimation_tpu_torch.ops import winograd

    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 6, 10, 3)).astype(np.float32))
    phases = winograd.space_to_phases(x)
    assert [tuple(p.shape) for p in phases] == [(2, 3, 5, 3)] * 4
    assert torch.equal(phases[2], x[:, 1::2, 0::2])
    assert torch.equal(winograd.phases_to_space(phases), x)
    for shape in ((1, 5, 6, 3), (1, 6, 7, 3)):
        with pytest.raises(ValueError, match="even H and W"):
            winograd.space_to_phases(torch.zeros(shape))
        with pytest.raises(ValueError, match="even H and W"):
            winograd.winograd_conv3x3(torch.zeros(shape), torch.zeros(4, 3, 3, 3))


def test_winograd_rejects_bad_input():
    from scenedepthestimation_tpu_torch.ops import winograd

    phases = winograd.space_to_phases(torch.zeros(1, 4, 4, 3))
    u = torch.zeros(16, 3, 5)
    with pytest.raises(ValueError, match="u must be"):
        winograd.winograd_conv3x3_phases(phases, torch.zeros(16, 4, 5), torch.zeros(5))
    with pytest.raises(ValueError, match="bias must be"):
        winograd.winograd_conv3x3_phases(phases, u, torch.zeros(4))
    with pytest.raises(ValueError, match="residual_phases must be"):
        winograd.winograd_conv3x3_phases(phases, u, torch.zeros(5), residual_phases=phases)
    with pytest.raises(ValueError, match="expected 4 phases"):
        winograd.winograd_conv3x3_phases(phases[:3], u, torch.zeros(5))
    with pytest.raises(ValueError, match="weight must be"):
        winograd.transform_weights(torch.zeros(5, 3, 1, 1))


def _jax_conv(x, k, bias, activation, border):
    """The JAX package's forms of the bordered conv: conv3x3_xla for reflect
    (jnp.pad repeats a lone pixel), jnp.pad(mode="edge") for edge, and the
    collapsed decoder's fast-border _conv3x3_zero for zero; bias and the
    activation after, in fp32."""
    import jax
    from jax import lax

    from scenedepthestimation_tpu.ops.collapsed import _conv3x3_zero
    from scenedepthestimation_tpu.ops.pallas.conv_block import conv3x3_xla

    x, k, bias = jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias)
    if border == "reflect":
        y = conv3x3_xla(x, k, bias, "none")
    elif border == "edge":
        xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
        y = lax.conv_general_dilated(
            xp, k, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")
        ) + bias
    else:
        y = _conv3x3_zero(x, k) + bias
    act = {"elu": jax.nn.elu, "relu": jax.nn.relu, "sigmoid": jax.nn.sigmoid}
    return np.asarray(act[activation](y) if activation in act else y)


def _conv_inputs(rng, b, h, w, cin, cout):
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return x, k, bias


def _port_conv(x, k, bias, activation, border):
    return _np(conv_block.conv3x3_plain(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))),
        torch.from_numpy(bias), activation=activation, border=border,
    ))


@pytest.mark.parametrize("activation", ["elu", "relu", "sigmoid", "none"])
def test_conv3x3_plain_zero_border_matches_jax(activation):
    """border="zero" vs the JAX fast-border conv (_conv3x3_zero of
    ops/collapsed.py, the form every decoder conv takes under
    mono.fast_borders) plus bias and activation; fp32 atol 5e-6."""
    rng = np.random.default_rng(12)
    for shape in [(2, 16, 24, 8, 12), (1, 5, 7, 3, 5)]:
        x, k, bias = _conv_inputs(rng, *shape)
        np.testing.assert_allclose(
            _port_conv(x, k, bias, activation, "zero"), _jax_conv(x, k, bias, activation, "zero"),
            atol=5e-6, err_msg=f"{shape}",
        )


@pytest.mark.parametrize("border", ["reflect", "edge"])
@pytest.mark.parametrize("hw", [(1, 7), (6, 1), (1, 1)], ids=["h1", "w1", "h1w1"])
def test_conv3x3_plain_one_pixel_axes_match_jax(hw, border):
    """A 1-pixel axis (the level-4 features of a 32x64 network are 1x2):
    reflect repeats the pixel as jnp.pad(mode="reflect") does in
    conv3x3_xla, edge as jnp.pad(mode="edge"); fp32 atol 5e-6."""
    rng = np.random.default_rng(13)
    x, k, bias = _conv_inputs(rng, 2, *hw, 5, 6)
    np.testing.assert_allclose(
        _port_conv(x, k, bias, "elu", border), _jax_conv(x, k, bias, "elu", border), atol=5e-6
    )


@pytest.mark.parametrize("cin,cout", [(3, 5), (20, 12), (16, 8), (33, 17)])
def test_slab_layout_feeds_a_plain_implicit_gemm(cin, cout):
    """The tensor-core path's weight slab: (9, Cin rounded up to 16, Cout
    rounded up to 8) elements, per tap and chunk of 16 input channels in
    8 x 8 core matrices (8 output channels n, each 8 contiguous input
    channels k), zero outside the weight. Read back as a K x N matrix per
    tap, a plain implicit GEMM over it (unfold the zero-padded input tap by
    tap, channels padded like the slab, one matmul) equals F.conv2d; fp32
    atol 1e-5."""
    import torch.nn.functional as F

    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(2, 6, 9, cin)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(cout, cin, 3, 3)) * 0.1).astype(np.float32))
    packed = conv_block.arrange_slab(w)  # a CPU weight: the plain arrangement
    _, cin_pad, cout_pad = packed.shape
    assert tuple(packed.shape) == conv_block.slab_shape(cin, cout) == (
        9, -(-cin // 16) * 16, -(-cout // 8) * 8)
    # (tap, kc, nb, kb, n8, k8) -> (tap, kc, kb, k8, nb, n8) = (tap, k, n)
    slab = packed.reshape(9, cin_pad // 16, cout_pad // 8, 2, 8, 8).permute(0, 1, 3, 5, 2, 4)
    slab = slab.reshape(9, cin_pad, cout_pad)
    assert not slab[:, cin:].any() and not slab[:, :, cout:].any()
    # The first core matrix: output channels 0-7, each with input channels 0-7.
    np.testing.assert_array_equal(
        _np(packed.reshape(-1)[:64].reshape(8, 8))[: min(cout, 8), : min(cin, 8)],
        _np(w[:8, :8, 0, 0]),
    )
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
    b, h, wd = x.shape[0], x.shape[1], x.shape[2]
    cols = F.unfold(xp, 3).reshape(b, cin, 9, h * wd).permute(0, 3, 2, 1)  # (B, HW, tap, Cin)
    cols = F.pad(cols, (0, cin_pad - cin)).reshape(b, h * wd, 9 * cin_pad)
    got = (cols @ slab.reshape(9 * cin_pad, cout_pad))[..., :cout]
    want = F.conv2d(xp, w).permute(0, 2, 3, 1).reshape(b, h * wd, cout)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_conv3x3_module_keeps_its_slab_until_the_weight_changes():
    """Conv3x3.slab() arranges once and returns the kept slab; an in-place
    change of the weight (its _version) or a new storage (a dtype cast)
    makes it arrange again."""
    from scenedepthestimation_tpu_torch.models.unet_decoder import Conv3x3

    m = Conv3x3(5, 7)
    first = m.slab()
    assert m.slab() is first
    torch.testing.assert_close(first, conv_block.arrange_slab_plain(m.weight.detach()))
    with torch.no_grad():
        m.weight.add_(1.0)
    second = m.slab()
    assert second is not first
    torch.testing.assert_close(second, conv_block.arrange_slab_plain(m.weight.detach()))
    m.to(torch.bfloat16)
    third = m.slab()
    assert third.dtype == torch.bfloat16 and m.slab() is third
