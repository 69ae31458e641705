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
from torch_threads import two_threads  # noqa: F401 (autouse)


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
    """The tensor-core path's bf16 weight slab: (9, Cin rounded up to 16, Cout
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
    w = w.bfloat16().float()  # values the bf16 slab holds exactly
    packed = conv_block.arrange_slab(w.bfloat16()).float()  # a CPU weight: the plain arrangement
    _, cin_pad, cout_pad = packed.shape
    assert tuple(packed.shape) == conv_block.slab_shape(cin, cout, torch.bfloat16) == (
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


@pytest.mark.parametrize("cin,cout", [(3, 5), (7, 6), (13, 2), (21, 10), (33, 17)])
def test_f32_slab_layout_feeds_a_numpy_implicit_gemm(cin, cout):
    """The fp32 kernel's weight slab: (9, Cin rounded up to 8, Cout rounded
    up to 4), K-major (row tap * cin_pad + k holds output channels n), zero
    outside the weight. A numpy implicit GEMM over it (the reflect-padded
    input unfolded tap by tap, channels padded like the slab, one matmul,
    then bias and ELU) equals conv3x3_plain and the TPU kernel in interpret
    mode, at Cin and Cout off 4, 8 and 16; fp32 atol 1e-5."""
    rng = np.random.default_rng(15)
    b, h, w = 2, 8, 9  # the TPU kernel tiles H in rows of 2 to 16
    x, k, bias = _conv_inputs(rng, b, h, w, cin, cout)
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    slab = _np(conv_block.arrange_slab(wt))  # a CPU weight: the plain arrangement
    _, cin_pad, cout_pad = slab.shape
    assert slab.shape == conv_block.slab_shape(cin, cout, torch.float32) == (
        9, -(-cin // 8) * 8, -(-cout // 4) * 4)
    assert not slab[:, cin:].any() and not slab[:, :, cout:].any()
    np.testing.assert_array_equal(slab[1, :cin, :cout], k[0, 1])  # tap (0, 1): (Cin, Cout)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    cols = np.stack([xp[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)], axis=3)
    cols = np.pad(cols, ((0, 0),) * 4 + ((0, cin_pad - cin),)).reshape(b * h * w, 9 * cin_pad)
    pre = (cols @ slab.reshape(9 * cin_pad, cout_pad))[:, :cout] + bias
    got = np.where(pre > 0, pre, np.expm1(np.minimum(pre, 0))).reshape(b, h, w, cout)
    np.testing.assert_allclose(got, _port_conv(x, k, bias, "elu", "reflect"), atol=1e-5)
    want = conv3x3_elu_pallas(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                              activation="elu", border="reflect", interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def _conv3x3_split(x, weight, bias, splits):
    """The fp32 kernel's split schedule in plain PyTorch: each of the
    ``splits`` slices of whole 8-channel chunks (ceil(chunks / splits)
    chunks each, the last one short) sums its input channels, the slice
    sums are added in slice order 0 .. S-1, then bias and ELU."""
    cin = x.shape[-1]
    chunks = -(-cin // 8)
    per = -(-chunks // splits) * 8
    assert -(-chunks // (per // 8)) == splits, "as many slices as asked"
    total = None
    for lo in range(0, cin, per):
        part = conv_block.conv3x3_plain(x[..., lo:lo + per].contiguous(),
                                        weight[:, lo:lo + per].contiguous(),
                                        torch.zeros_like(bias), "none", "reflect")
        total = part if total is None else total + part
    return torch.nn.functional.elu(total + bias)


@pytest.mark.parametrize("cin,splits", [(512, 22), (40, 3), (21, 2), (17, 3)])
def test_split_schedule_adds_slices_in_order(cin, splits):
    """The split schedule (slices of whole chunks added in slice order, then
    bias and activation) equals the unsplit conv within fp32 atol 1e-5 and
    gives the same bits on every run."""
    rng = np.random.default_rng(16)
    x, k, bias = _conv_inputs(rng, 1, 6, 10, cin, 7)
    x, bias = torch.from_numpy(x), torch.from_numpy(bias)
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = _conv3x3_split(x, wt, bias, splits)
    torch.testing.assert_close(got, conv_block.conv3x3_plain(x, wt, bias), atol=1e-5, rtol=0)
    assert torch.equal(got, _conv3x3_split(x, wt, bias, splits))


def test_conv3x3_module_keeps_its_slab_until_the_weight_changes():
    """Conv3x3.slab() arranges once and returns the kept slab; an in-place
    change of the weight (its _version) or a new storage (a dtype cast)
    makes it arrange again."""
    from scenedepthestimation_tpu_torch.models.unet_decoder import Conv3x3

    m = Conv3x3(5, 7)
    first = m.slab()
    assert m.slab() is first
    # An fp32 weight keeps the fp32 kernel's K-major slab.
    assert tuple(first.shape) == conv_block.slab_shape(5, 7, torch.float32)
    torch.testing.assert_close(first, conv_block.arrange_slab_plain(m.weight.detach()))
    with torch.no_grad():
        m.weight.add_(1.0)
    second = m.slab()
    assert second is not first
    torch.testing.assert_close(second, conv_block.arrange_slab_plain(m.weight.detach()))
    m.to(torch.bfloat16)
    third = m.slab()
    assert third.dtype == torch.bfloat16 and m.slab() is third
    assert tuple(third.shape) == conv_block.slab_shape(5, 7, torch.bfloat16)


def test_depth_decoder_keeps_its_tail_slab_until_the_weights_change():
    """DepthDecoder.tail_slab() arranges level 0's two weights once and
    returns the kept slab; an in-place change of either weight or a dtype
    cast makes it arrange again. On the CPU, the fused tail's forward does
    not make one (the plain version reads the weights)."""
    from scenedepthestimation_tpu_torch.models.unet_decoder import DepthDecoder

    dec = DepthDecoder(num_ch_enc=(8, 8, 8, 8, 8), dec_channels=(4, 4, 4, 4, 4)).eval()
    u00, u01 = dec.upconv_0_0.conv.weight, dec.upconv_0_1.conv.weight
    first = dec.tail_slab()
    assert dec.tail_slab() is first
    assert torch.equal(first, fused_tail.arrange_tail_weights_plain(u00.detach(), u01.detach()))
    with torch.no_grad():
        u01.add_(1.0)
    second = dec.tail_slab()
    assert second is not first and dec.tail_slab() is second
    assert torch.equal(second, fused_tail.arrange_tail_weights_plain(u00.detach(), u01.detach()))
    dec.to(torch.bfloat16)
    third = dec.tail_slab()
    assert third is not second and third.dtype == torch.bfloat16 and dec.tail_slab() is third
    fresh = DepthDecoder(num_ch_enc=(8, 8, 8, 8, 8), dec_channels=(4, 4, 4, 4, 4)).eval()
    feats = [torch.randn(1, 32 >> i, 64 >> i, 8) for i in range(1, 6)]
    fused_tail.set_use_fused_tail(True)
    try:
        with torch.no_grad():
            fresh(feats)
    finally:
        fused_tail.set_use_fused_tail(None)
    assert fresh._kept_tail is None


@pytest.mark.parametrize("c,co", [(5, 7), (3, 40), (20, 12), (33, 17), (16, 300)])
def test_u_slab_layout_feeds_a_plain_implicit_gemm(c, co):
    """The U the winograd kernel reads (kept_u_slab): (16, C, Co), contiguous,
    in the weight's dtype. Read back per product k = 4i + j as a C x Co
    matrix, it feeds a plain Winograd implicit GEMM written here in numpy
    (V = B^T d B of each 4 x 4 window, M_k = V_k U_k, Y = A^T M A) to the
    direct conv and to the plain version; fp32 atol 1e-5."""
    from scenedepthestimation_tpu_torch.ops import winograd

    x, g, bias, res = _wino_data(2, 6, 10, c, co, seed=c + co)
    slab = winograd.kept_u_slab(_oihw(g))
    assert tuple(slab.shape) == (16, c, co) and slab.is_contiguous() and slab.dtype == torch.float32
    u = _np(slab).astype(np.float64)
    bt = np.array([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]], np.float64)
    at = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float64)
    b, h, w, _ = x.shape
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    d = np.stack([np.stack([xp[:, r:r + h:2, s:s + w:2] for s in range(4)]) for r in range(4)])
    v = np.einsum("ia,jb,ab...->ij...", bt, bt, d)  # (4, 4, B, H/2, W/2, C)
    m = np.stack([np.stack([v[i, j] @ u[4 * i + j] for j in range(4)]) for i in range(4)])
    y = np.einsum("pi,qj,ij...->pq...", at, at, m)  # (2, 2, B, H/2, W/2, Co)
    got = np.empty((b, h, w, co))
    for p_ in range(2):
        for q_ in range(2):
            got[:, p_::2, q_::2] = y[p_, q_]
    got = np.maximum(got + bias + res, 0.0)
    direct = winograd.conv3x3_reference(torch.from_numpy(x), _oihw(g), torch.from_numpy(bias),
                                        torch.from_numpy(res))
    np.testing.assert_allclose(got, _np(direct), atol=1e-5, rtol=0)
    plain = winograd.winograd_conv3x3(torch.from_numpy(x), _oihw(g), torch.from_numpy(bias),
                                      torch.from_numpy(res), u_slab=slab)
    np.testing.assert_allclose(got, _np(plain), atol=1e-5, rtol=0)


def test_kept_u_slab_arranges_once_until_the_weight_changes(monkeypatch):
    """kept_u_slab() transforms a weight once and returns the kept U; an
    in-place change of the weight (its _version) or a new storage (a dtype
    cast of its module) makes it transform again, into the new dtype."""
    from scenedepthestimation_tpu_torch.ops import winograd

    transformed = []
    transform = winograd.transform_weights

    def counting(w):
        transformed.append(tuple(w.shape))
        return transform(w)

    monkeypatch.setattr(winograd, "transform_weights", counting)
    conv = torch.nn.Conv2d(5, 7, 3, padding=1)
    first = winograd.kept_u_slab(conv.weight)
    assert winograd.kept_u_slab(conv.weight) is first and transformed == [(7, 5, 3, 3)]
    torch.testing.assert_close(first, transform(conv.weight.detach()))
    with torch.no_grad():
        conv.weight.add_(1.0)
    second = winograd.kept_u_slab(conv.weight)
    assert second is not first and len(transformed) == 2
    torch.testing.assert_close(second, transform(conv.weight.detach()))
    conv.to(torch.bfloat16)
    third = winograd.kept_u_slab(conv.weight)
    assert third is not second and len(transformed) == 3 and winograd.kept_u_slab(conv.weight) is third
    assert third.dtype == torch.bfloat16
    torch.testing.assert_close(third, transform(conv.weight.detach()).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_res", [False, True])
def test_winograd_conv3x3_with_u_slab_matches_jax(dtype, use_res):
    """winograd_conv3x3(..., u_slab=kept_u_slab(w)) equals the call without
    it, and the JAX winograd_conv3x3 (its kernel in interpret mode) on the
    same input: fp32 atol 1e-5; bf16 one bf16 spacing of each element."""
    from scenedepthestimation_tpu.ops.pallas import winograd as jax_wino
    from scenedepthestimation_tpu_torch.ops import winograd

    x, g, bias, res = _wino_data(2, 6, 10, 5, 7, seed=11)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    w = _oihw(g)
    r = torch.from_numpy(res).to(tdt) if use_res else None
    got = winograd.winograd_conv3x3(torch.from_numpy(x).to(tdt), w, torch.from_numpy(bias), r,
                                    u_slab=winograd.kept_u_slab(w))
    plain = winograd.winograd_conv3x3(torch.from_numpy(x).to(tdt), w, torch.from_numpy(bias), r)
    assert got.dtype == tdt and torch.equal(got, plain)
    want = np.asarray(jax_wino.winograd_conv3x3(
        jnp.asarray(x).astype(jdt), jnp.asarray(g), jnp.asarray(bias),
        residual=jnp.asarray(res).astype(jdt) if use_res else None, interpret=True,
    ).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=0)
    else:
        spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -120))) - 7)
        assert (np.abs(_np(got.float()) - want) <= spacing).all()


@pytest.mark.parametrize("c1,c0,c0o", [(12, 5, 6), (32, 16, 16), (40, 17, 19)])
def test_tail_slab_layout_feeds_the_plain_tail(c1, c0, c0o):
    """The bf16 fused tail's weight slab: W00 as (9, C0, C1) then W01 as
    (9, C0o, C0), channel counts rounded up to 16, rows n of contiguous
    input channels k (the B fragments' rows), zero outside the weights.
    Read back per tap as an (N, K) matrix, it runs fused_tail_plain to the
    same output as the weights themselves (exactly, fp32)."""
    y1, k00, b00, k01, b01 = _tail_inputs(np.random.default_rng(c1), 2, 4, 5, c1, c0, c0o)
    args = _torch_tail_args(y1, k00, b00, k01, b01)
    w00, w01 = args[1], args[3]
    slab = fused_tail.arrange_tail_weights_plain(w00, w01)
    p1, p0, p0o = (-(-n // 16) * 16 for n in (c1, c0, c0o))
    assert tuple(slab.shape) == (9 * p0 * p1 + 9 * p0o * p0,)
    m00 = slab[: 9 * p0 * p1].reshape(9, p0, p1)
    m01 = slab[9 * p0 * p1:].reshape(9, p0o, p0)
    assert not m00[:, c0:].any() and not m00[:, :, c1:].any()
    assert not m01[:, c0o:].any() and not m01[:, :, c0:].any()
    for tap in range(9):
        torch.testing.assert_close(m00[tap, :c0, :c1], w00[:, :, tap // 3, tap % 3], rtol=0, atol=0)
        torch.testing.assert_close(m01[tap, :c0o, :c0], w01[:, :, tap // 3, tap % 3], rtol=0, atol=0)
    read00 = m00[:, :c0, :c1].reshape(3, 3, c0, c1).permute(2, 3, 0, 1)
    read01 = m01[:, :c0o, :c0].reshape(3, 3, c0o, c0).permute(2, 3, 0, 1)
    want = fused_tail.fused_tail_plain(*args)
    assert torch.equal(fused_tail.fused_tail_plain(args[0], read00, args[2], read01, args[4]), want)


# ---------------------------------------------------------------------------
# The upsample_concat kernel's launch plan, replayed in numpy: the index
# arithmetic of csrc/upsample_concat.cu's upsample_concat_kernel (64-bit row
# bases, 32-bit in-segment offsets, the multiply-high divisions), from
# upsample_concat_plan's numbers.
# ---------------------------------------------------------------------------

_U64 = np.uint64


def _fastdiv(n, mul: int, shift: int):
    """The kernel's FastDiv on uint64 arrays of 32-bit values."""
    t = (n * _U64(mul)) >> _U64(32)
    return (t + ((n - t) >> _U64(min(shift, 1)))) >> _U64(max(shift - 1, 0))


def _indices(plan, n: int, step: int) -> np.ndarray:
    """The indices below n that a block's threads take, as uint64: j0 =
    tid, tid + step, ... while j0 < n, and j0 + k * threads for k below
    step / threads while below n."""
    t = plan.threads
    j0 = np.arange(t)[None, :] + np.arange(0, max(n, 1), step)[:, None]
    j = (j0[..., None] + t * np.arange(step // t)).astype(np.int64)
    return j[(j0[..., None] < n) & (j < n)].astype(_U64)


def _segment_moves(plan, s: int):
    """The moves of segment s of any row, as the block's threads make them
    with 32-bit in-segment arithmetic (each value checked to stay below
    2^31): the x units the staging loop loads, and for each output unit of
    the segment its offset from the row base (``at``), whether it lies in
    output row 2r + 1, and its source: an x offset from the row base, or a
    skip offset (-1 where the other applies)."""
    w0 = s * plan.wb
    wn = min(plan.wb, plan.w - w0)
    vt = plan.v1 + plan.v2
    nx, row = wn * plan.v1, 2 * wn * vt
    assert 2 * row < 2**31
    staged = _indices(plan, nx, plan.threads) if plan.staged else np.zeros(0, _U64)
    i = _indices(plan, 2 * row, plan.unroll * plan.threads)
    odd = i >= row
    at = np.where(odd, i - _U64(row), i)
    p = _fastdiv(at, plan.mul, plan.shift)
    c = at - p * _U64(vt)
    from_x = c < plan.v1
    xj = np.where(from_x, (p >> _U64(1)) * _U64(plan.v1) + c, 0)
    sk = p * _U64(plan.v2) + np.where(from_x, _U64(0), c - _U64(plan.v1))
    for a in (i, at, p * _U64(vt), xj, sk):
        assert a.size == 0 or int(a.max()) < 2**31
    xj, sk = (np.where(m, v.astype(np.int64), -1) for m, v in ((from_x, xj), (~from_x, sk)))
    return w0, staged.astype(np.int64), at.astype(np.int64), odd, xj, sk


def _row_bases(plan, rows, w0: int, dtype=np.int64):
    """The block's row bases in ``dtype``: x's row r from pixel w0, skip's and
    the output's rows 2r and 2r + 1 from pixel 2 * w0 (units)."""
    r = np.asarray(rows, dtype)
    big_w, v1, v2 = dtype(plan.w), dtype(plan.v1), dtype(plan.v2)
    vt = dtype(plan.v1 + plan.v2)
    pix = dtype(2) * (dtype(2) * r * big_w + dtype(w0))
    xr = (r * big_w + dtype(w0)) * v1
    s0, o0 = pix * v2, pix * vt
    return xr, s0, s0 + dtype(2) * big_w * v2, o0, o0 + dtype(2) * big_w * vt


def _block_rows(plan) -> np.ndarray:
    """The rows in the order the blocks of one grid column walk them: block y
    takes y, y + grid_y, ..."""
    r = np.arange(plan.grid_y)[:, None] + plan.grid_y * np.arange(-(-plan.rows // plan.grid_y))
    return r[r < plan.rows]


def _emulated_moves(plan, rows=None):
    """(destination, source, x loads from device memory) of the launch: the
    output unit index of every store, its source as an index into x's units
    or as len(x's units) + an index into skip's units, and the x unit
    index of every load of x from device memory (the staging loop's, or
    the output loop's where the plan stages nothing)."""
    rows = _block_rows(plan) if rows is None else np.asarray(rows)
    nx_units = plan.rows * plan.w * plan.v1
    dsts, srcs, x_loads = [], [], []
    for s in range(plan.nseg):
        w0, staged, at, odd, xj, sk = _segment_moves(plan, s)
        xr, s0, s1, o0, o1 = (b[:, None] for b in _row_bases(plan, rows, w0))
        dsts.append(np.where(odd, o1, o0) + at)
        srcs.append(np.where(xj >= 0, xr + xj, nx_units + np.where(odd, s1, s0) + sk))
        x_loads.append(xr + (staged if plan.staged else xj[xj >= 0]))
    return tuple(np.concatenate([a.ravel() for a in arrays]) for arrays in (dsts, srcs, x_loads))


def _upcat_data(rng, b, h, w, c1, c2, dtype):
    """x and skip as torch tensors of ``dtype`` from normal numpy draws."""
    x = torch.from_numpy(rng.normal(size=(b, h, w, c1)).astype(np.float32)).to(dtype)
    skip = torch.from_numpy(rng.normal(size=(b, 2 * h, 2 * w, c2)).astype(np.float32)).to(dtype)
    return x, skip


def _as_units(t: torch.Tensor, unit: int) -> np.ndarray:
    """A tensor's bytes as rows of ``unit`` bytes."""
    return t.contiguous().view(torch.uint8).numpy().reshape(-1, unit)


# (b, h, w, c1, c2): the mono decoder's four joins and the stereo
# aggregation's three, at small spatial sizes.
_DECODER_JOINS = [(2, 3, 5, 256, 256), (2, 3, 5, 128, 128), (2, 3, 5, 64, 64), (2, 3, 5, 32, 64)]
_STEREO_JOINS = [(2, 3, 5, 160, 128), (2, 3, 5, 128, 96), (2, 3, 5, 96, 64)]
# (b, h, w, c1, c2, align): widths off 16 bytes (units of 8, 4 or one
# element), pointers off 16-byte alignment ("element": a storage offset of
# one element; 4 and 8 bytes), C1 != C2 at odd W, B*H above the grid's
# 65,535 rows, a pixel wider than one pass of a block.
_UPCAT_EDGES = [(2, 3, 5, 3, 5, 16), (1, 4, 6, 8, 4, 16), (2, 5, 3, 16, 24, 16),
                (2, 3, 7, 6, 10, 16), (2, 3, 5, 64, 64, "element"), (2, 3, 5, 64, 64, 4),
                (2, 3, 5, 64, 64, 8), (3, 4, 9, 24, 40, 16), (1100, 64, 2, 8, 8, 16),
                (2, 3, 5, 640, 512, 16)]
_UPCAT_CASES = ([(*s, 16) for s in _DECODER_JOINS + _STEREO_JOINS] + _UPCAT_EDGES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,w,c1,c2,align", _UPCAT_CASES)
def test_upsample_concat_plan_replay_writes_the_plain_output(b, h, w, c1, c2, align, dtype):
    """The launch that upsample_concat_plan gives, replayed in numpy, moves
    every output unit exactly once, from the x or skip unit that
    upsample_concat_plain puts there: the outputs are equal bit for bit."""
    esize = torch.empty(0, dtype=dtype).element_size()
    align = esize if align == "element" else align
    plan = upsample_concat.upsample_concat_plan(b, h, w, c1, c2, esize, align)
    assert plan.unit <= align and plan.unit >= esize
    assert (c1 * esize) % plan.unit == 0 and (c2 * esize) % plan.unit == 0
    assert plan.grid_y == min(b * h, 65535) and (plan.nseg - 1) * plan.wb < w <= plan.nseg * plan.wb
    x, skip = _upcat_data(np.random.default_rng(b * h + w + c1), b, h, w, c1, c2, dtype)
    want = _as_units(upsample_concat.upsample_concat_plain(x, skip), plan.unit)
    dst, src, x_loads = _emulated_moves(plan)
    assert np.array_equal(np.bincount(dst, minlength=len(want)), np.ones(len(want), np.int64))
    # Each x unit is read from device memory once (staged), each skip unit once.
    n_x = b * h * w * c1 * esize // plan.unit
    assert plan.staged == plan.wb * plan.v1 * plan.unit
    np.testing.assert_array_equal(np.bincount(x_loads, minlength=n_x), np.ones(n_x, np.int64))
    n_skip = np.bincount(src[src >= n_x] - n_x, minlength=len(want) - 4 * n_x)
    np.testing.assert_array_equal(n_skip, np.ones(len(want) - 4 * n_x, np.int64))
    got = np.empty_like(want)
    got[dst] = np.concatenate([_as_units(x, plan.unit), _as_units(skip, plan.unit)])[src]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,h,w,c1,c2", [(2, 3, 5, 32, 64), (2, 3, 5, 160, 128),
                                         (2, 3, 7, 6, 10), (1, 4, 6, 8, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_upsample_concat_plan_replay_matches_the_pallas_kernel(b, h, w, c1, c2, dtype):
    """At small cases the replayed launch also equals the JAX package's
    upsample_concat_pallas (interpret mode) bit for bit."""
    esize = torch.empty(0, dtype=dtype).element_size()
    plan = upsample_concat.upsample_concat_plan(b, h, w, c1, c2, esize)
    x, skip = _upcat_data(np.random.default_rng(c1 + c2), b, h, w, c1, c2, dtype)
    dst, src, _ = _emulated_moves(plan)
    out = np.empty((b * 4 * h * w * (c1 + c2) * esize // plan.unit, plan.unit), np.uint8)
    out[dst] = np.concatenate([_as_units(x, plan.unit), _as_units(skip, plan.unit)])[src]
    jx, js = (jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32) for t in (x, skip))
    want = np.asarray(upsample_concat_pallas(jx, js, interpret=True))
    np.testing.assert_array_equal(out.reshape(-1).view(want.dtype), want.reshape(-1))


def test_upsample_concat_plan_row_bases_are_64_bit():
    """A bf16 output of 2^31 elements and more on the one-element unit (a
    pointer off 4 bytes): the last rows' bases lie beyond 2^31 units, where
    32-bit bases wrap, while every in-segment offset stays below 2^31. The
    moves of the first and the last row of every segment land where the
    output's layout puts each element, from the element it names."""
    b, h, w, c1, c2 = 208, 96, 288, 32, 64
    plan = upsample_concat.upsample_concat_plan(b, h, w, c1, c2, 2, align=2)
    ct, n_out = c1 + c2, b * 4 * h * w * (c1 + c2)
    assert plan.unit == 2 and n_out > 2**31
    rows = [0, plan.rows - 1]
    bases64 = np.stack(_row_bases(plan, rows, (plan.nseg - 1) * plan.wb))
    with np.errstate(over="ignore"):
        bases32 = np.stack(_row_bases(plan, rows, (plan.nseg - 1) * plan.wb, np.int32))
    assert bases64.max() >= 2**31 and not np.array_equal(bases32.astype(np.int64), bases64)
    dst, src, _ = _emulated_moves(plan, rows)
    assert dst.max() < n_out and len(np.unique(dst)) == len(dst) == 2 * 4 * w * ct
    pix, c = np.divmod(dst, ct)
    row2, ow = np.divmod(pix, 2 * w)  # output row b * 2H + oh
    assert set(row2 // 2) == set(rows)
    nx_units = plan.rows * w * c1
    want = np.where(c < c1, ((row2 // 2) * w + ow // 2) * c1 + c,
                    nx_units + pix * c2 + (c - c1))
    np.testing.assert_array_equal(src, want)


@pytest.mark.parametrize("divisors", [range(1, 65), range(65, 130),
                                      [160, 192, 255, 320, 1000, 4095, 65537, 2**20 + 7,
                                       2**30 + 3, 2**31 - 1]], ids=["1-64", "65-129", "wide"])
def test_upsample_concat_fast_divisor_is_exact(divisors):
    """The kernel's multiply-high division by each d equals n // d over every
    32-bit n tried: the ends of the range, the neighbours of multiples of d
    and random draws."""
    for d in divisors:
        mul, shift = upsample_concat.fast_divisor(d)
        assert 0 < mul < 2**32 and 0 <= shift <= 31, d
        rng = np.random.default_rng(d)
        mults = rng.integers(0, (2**32 - 1) // d + 1, size=2000, dtype=np.uint64) * _U64(d)
        n = np.concatenate([mults, mults - _U64(1), mults + _U64(1),
                            rng.integers(0, 2**32, size=2000, dtype=np.uint64),
                            np.array([0, 1, d - 1, d, 2**31 - 1, 2**31, 2**32 - 1], np.uint64)])
        n = n[n < _U64(2**32)]
        np.testing.assert_array_equal(_fastdiv(n, mul, shift), n // _U64(d), err_msg=f"d = {d}")


def test_upsample_concat_plan_refuses_what_the_kernel_cannot_take():
    """An empty output, an element off its own alignment, a pixel too wide
    for 32-bit in-segment offsets."""
    plan = upsample_concat.upsample_concat_plan
    with pytest.raises(ValueError, match="non-empty"):
        plan(1, 0, 4, 8, 8, 2)
    with pytest.raises(ValueError, match="alignment"):
        plan(1, 2, 4, 8, 8, 4, align=2)
    with pytest.raises(ValueError, match="too wide"):
        plan(1, 1, 1, 2**28, 2**28, 2, align=2)
    assert plan(1, 1, 1, 2**27, 2**27, 4).unit == 16


@pytest.mark.parametrize("low,align", [(0, 16), (8, 8), (4, 4), (12, 4), (2, 2), (6, 2)])
def test_upsample_concat_plan_array_takes_the_pointers_alignment(low, align):
    """The launch argument that the wrapper caches holds upsample_concat_plan's
    fields at the alignment that the pointers' low four bits OR to."""
    got = upsample_concat._plan_array(2, 3, 5, 32, 64, 2, low)
    assert list(got) == list(upsample_concat.upsample_concat_plan(2, 3, 5, 32, 64, 2, align))


def test_upsample_concat_plan_reads_a_wide_x_where_needed():
    """A pixel of x wider than the staging limit is not staged; the replayed
    launch still writes the plain output, reading each x unit four times."""
    b, h, w, c1, c2 = 1, 2, 3, 4608, 8
    plan = upsample_concat.upsample_concat_plan(b, h, w, c1, c2, 4)
    assert plan.staged == 0 and plan.wb == 1 and c1 * 4 > upsample_concat.STAGE_LIMIT
    x, skip = _upcat_data(np.random.default_rng(0), b, h, w, c1, c2, torch.float32)
    want = _as_units(upsample_concat.upsample_concat_plain(x, skip), plan.unit)
    dst, src, x_loads = _emulated_moves(plan)
    assert np.array_equal(np.bincount(dst, minlength=len(want)), np.ones(len(want), np.int64))
    assert np.array_equal(np.bincount(x_loads), np.full(b * h * w * c1 // 4, 4))
    got = np.empty_like(want)
    got[dst] = np.concatenate([_as_units(x, plan.unit), _as_units(skip, plan.unit)])[src]
    np.testing.assert_array_equal(got, want)
