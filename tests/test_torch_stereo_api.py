"""The stereo slice of the PyTorch port (scenedepthestimation_tpu_torch) end
to end against the JAX package: predict_stereo on the same weights and
pairs (the JAX side runs build_stereo_program, which takes its packed
aggregation at this size), weights through the JAX ``.pth`` export, the
refine auto-enable, and stereo requests through the server; in fp32 and
in bf16, where both packages take the banded-Gram correlation.
"""

import base64
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from scenedepthestimation_tpu import api as jax_api
from scenedepthestimation_tpu import configs as jax_configs
from scenedepthestimation_tpu.utils import torch_export
from scenedepthestimation_tpu_torch import api, configs
from scenedepthestimation_tpu_torch.models.stereo import StereoNet
from scenedepthestimation_tpu_torch.ops.cuda import _build
from scenedepthestimation_tpu_torch.serve import serve_requests
from scenedepthestimation_tpu_torch.utils import weights

NET_HW = (64, 128)  # feature grid 16x32: the JAX program takes its packed path
SRC_HW = (50, 150)  # not the net size: both resizes and the width rescale run
SMALL = dict(
    height=NET_HW[0], width=NET_HW[1], max_disp=32, feat_channels=16,
    agg_channels=(8, 12, 16, 20),
)


def _small(cfg_module, refine=False):
    cfg = cfg_module.get("stereo_256x512_b4")
    return dataclasses.replace(
        cfg, stereo=dataclasses.replace(cfg.stereo, refine=refine, **SMALL)
    )


def _numpy_variables(pred):
    return jax.tree_util.tree_map(np.array, dict(pred.variables))


@pytest.fixture(scope="module")
def jax_predictor():
    pred = jax_api.load_weights(None, _small(jax_configs), seed=0)
    return pred, _numpy_variables(pred)


@pytest.fixture(scope="module")
def pairs():
    """Two uint8 pairs whose right view is the left shifted by 4 px plus
    noise, so that the cost volume is not flat."""
    rng = np.random.default_rng(0)
    left = rng.integers(0, 256, (2, *SRC_HW, 3), dtype=np.uint8)
    noise = rng.integers(-8, 9, left.shape)
    right = np.clip(np.roll(left, -4, axis=2).astype(np.int64) + noise, 0, 255)
    return left, right.astype(np.uint8)


def _assert_matches(got, want):
    """Disparity atol 1e-4 px + rtol 1e-5; depth rtol 1e-5."""
    for k in ("disp", "depth"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
    np.testing.assert_allclose(got["disp"], want["disp"], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-5)


def _port_predictor(variables, cfg, route, tmp_path):
    """The port's CPU predictor on the JAX weights, carried over by
    from_jax_variables or by the JAX export_torch_dir -> load_torch_dir."""
    if route == "jax_variables":
        model = StereoNet(cfg.stereo)
        weights.load_state(model, weights.from_jax_variables(variables))
        return api.Predictor(cfg, model, "cpu")
    assert set(torch_export.export_torch_dir(variables, str(tmp_path))) == {"stereo"}
    return api.load_weights(str(tmp_path), cfg, device="cpu")


@pytest.mark.parametrize("route", ["jax_variables", "torch_dir"])
def test_predict_stereo_matches_jax(jax_predictor, pairs, route, tmp_path):
    """predict_stereo of the port vs the JAX package's on the same weights,
    carried over by from_jax_variables or by the JAX export_torch_dir ->
    the port's load_torch_dir."""
    jpred, variables = jax_predictor
    pred = _port_predictor(variables, _small(configs), route, tmp_path)
    left, right = pairs
    _build.LAUNCHES.clear()
    got = api.predict_stereo(pred, left, right)
    assert not _build.LAUNCHES  # CPU tensors take the plain versions
    assert got["disp"].shape == (2, *SRC_HW)
    _assert_matches(got, jax_api.predict_stereo(jpred, left, right))
    one = api.predict_stereo(pred, left[1], right[1])
    assert one["disp"].shape == SRC_HW
    # The CPU convs pick their summation order by batch size.
    np.testing.assert_allclose(one["disp"], got["disp"][1], atol=1e-5, rtol=1e-6)


def test_refine_checkpoint_switches_refine_on(pairs, tmp_path):
    """Weights with a refinement stage, loaded under a refine=False preset,
    switch refine on (as the JAX load_weights does) and then agree with the
    JAX refine program; the residual conv is randomised first."""
    jpred = jax_api.load_weights(None, _small(jax_configs, refine=True), seed=1)
    variables = _numpy_variables(jpred)
    res = variables["params"]["refinement"]["residual"]
    res["kernel"] = np.random.default_rng(5).normal(0, 0.05, res["kernel"].shape).astype(np.float32)
    jpred = jax_api.Predictor(jpred.cfg, jax.tree_util.tree_map(jax.numpy.asarray, variables))
    torch_export.export_torch_dir(variables, str(tmp_path))
    pred = api.load_weights(str(tmp_path), _small(configs), device="cpu")
    assert pred.cfg.stereo.refine is True
    left, right = pairs
    _assert_matches(
        api.predict_stereo(pred, left, right), jax_api.predict_stereo(jpred, left, right)
    )


def test_seeded_stereo_weights_and_pair_checks():
    cfg = _small(configs)
    a = api.load_weights(None, cfg, seed=5, device="cpu").model.state_dict()
    b = api.load_weights(None, cfg, seed=5, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    pred = api.load_weights(None, cfg, seed=5, device="cpu")
    left = np.zeros((*SRC_HW, 3), np.uint8)
    with pytest.raises(ValueError, match="left/right shapes must match"):
        api.predict_stereo(pred, left, np.zeros((SRC_HW[0], SRC_HW[1] + 2, 3), np.uint8))
    with pytest.raises(ValueError, match="expected"):
        api.predict_stereo(pred, left[..., 0], left[..., 0])


BF16_PRESETS = (
    "stereo_kitti2015_b16_bf16_v5e8",
    "stereo_kitti2015_b16_bf16_v5e8_c128",
    "stereo_kitti2015_latency_d96",
)


def _reduced(cfg_module, name):
    """A bf16 preset at its published widths, cut to a 64x128 input."""
    cfg = cfg_module.get(name)
    return dataclasses.replace(
        cfg, stereo=dataclasses.replace(cfg.stereo, height=NET_HW[0], width=NET_HW[1])
    )


def test_bf16_stereo_is_not_ported(pairs):
    """bf16 stereo is ported now: the three bf16 presets load (no longer
    raise), keep their widths and dtype, and predict_stereo returns finite
    disparity and depth of the source shape at a reduced input size."""
    left, right = pairs
    for name in BF16_PRESETS:
        pred = api.load_weights(None, name, device="cpu")
        assert pred.dtype == torch.bfloat16 and pred.cfg.name == name
        cin = pred.cfg.stereo.corr_disp + pred.cfg.stereo.feat_channels
        assert pred.model.aggregation.enc0.conv.in_channels == cin
        assert pred.model.tower.refine2.conv.weight.dtype == torch.bfloat16
        out = api.predict_stereo(api.load_weights(None, _reduced(configs, name), device="cpu"), left, right)
        for k in ("disp", "depth"):
            assert out[k].shape == (2, *SRC_HW) and out[k].dtype == np.float32, (name, k)
            assert np.isfinite(out[k]).all(), (name, k)


@pytest.mark.parametrize(
    "name,route",
    [
        ("stereo_kitti2015_b16_bf16_v5e8", "jax_variables"),
        ("stereo_kitti2015_b16_bf16_v5e8_c128", "torch_dir"),
        ("stereo_kitti2015_latency_d96", "torch_dir"),
    ],
    ids=["config5", "c128", "d96"],
)
def test_predict_stereo_bf16_matches_jax(pairs, name, route, tmp_path):
    """bf16 predict_stereo of the port vs the JAX package's bf16 program on
    the same weights, at each preset's widths (C = 64 or 128, D = 48 or 24)
    on a 64x128 input; the weights go over by from_jax_variables or by the
    JAX export_torch_dir -> the port's load_torch_dir. Disparity atol 6e-3
    px, depth rtol 1.2e-4: about twice the errors measured here (3.0e-3 px,
    5.6e-5), which come from bf16 convs rounded at other places by XLA-CPU
    and oneDNN; the random-weight readout is nearly uniform over D."""
    jpred = jax_api.load_weights(None, _reduced(jax_configs, name), seed=0)
    pred = _port_predictor(_numpy_variables(jpred), _reduced(configs, name), route, tmp_path)
    assert pred.dtype == torch.bfloat16
    left, right = pairs
    _build.LAUNCHES.clear()
    got = api.predict_stereo(pred, left, right)
    assert not _build.LAUNCHES
    want = jax_api.predict_stereo(jpred, left, right)
    for k in ("disp", "depth"):
        assert got[k].shape == want[k].shape == (2, *SRC_HW) and got[k].dtype == np.float32
    np.testing.assert_allclose(got["disp"], want["disp"], atol=6e-3)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1.2e-4)


def _abs_rel(depth, ref):
    return float(np.mean(np.abs(depth - ref) / ref))


@pytest.mark.parametrize("peaked", [False, True], ids=["seeded", "peaked"])
def test_bf16_depth_abs_rel_vs_fp32_within_jax_budget(pairs, peaked):
    """Depth abs-rel of bf16 against fp32 on the same weights, for the port
    and for the JAX package: the port's must be at most max(2 x the JAX
    package's own figure, 1e-3), the budget of BASELINE.json. 'peaked'
    multiplies the cost head's kernel and bias by 20 before loading into
    both, so that the soft-argmin is peaked instead of nearly uniform.
    Measured here: seeded 3.4e-5 (JAX) vs 3.4e-5 (port), peaked 6.1e-4
    vs 5.8e-4."""
    variables = _numpy_variables(jax_api.load_weights(None, _small(jax_configs), seed=0))
    if peaked:
        head = variables["params"]["aggregation"]["cost_head"]
        head["kernel"], head["bias"] = head["kernel"] * 20, head["bias"] * 20
    jax_vars = jax.tree_util.tree_map(jax.numpy.asarray, variables)
    state = weights.from_jax_variables(variables)
    left, right = pairs
    depth = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(_small(jax_configs), dtype=dtype)
        depth["jax", dtype] = jax_api.predict_stereo(
            jax_api.Predictor(jcfg, jax_vars), left, right)["depth"]
        cfg = dataclasses.replace(_small(configs), dtype=dtype)
        model = StereoNet(cfg.stereo)
        weights.load_state(model, state)
        depth["port", dtype] = api.predict_stereo(api.Predictor(cfg, model, "cpu"), left, right)["depth"]
    jax_rel = _abs_rel(depth["jax", "bfloat16"], depth["jax", "float32"])
    port_rel = _abs_rel(depth["port", "bfloat16"], depth["port", "float32"])
    assert 0 < port_rel <= max(2 * jax_rel, 1e-3), (port_rel, jax_rel)


def _write_pngs(tmp_path, pairs):
    left, right = pairs
    paths = []
    for i in range(2):
        lp, rp = str(tmp_path / f"l{i}.png"), str(tmp_path / f"r{i}.png")
        Image.fromarray(left[i]).save(lp)
        Image.fromarray(right[i]).save(rp)
        paths.append((lp, rp))
    return paths


def test_serve_stereo_requests_in_order(pairs, tmp_path):
    """Pairs by path and inline base64 come back in order and equal
    predict_stereo; a pair of two shapes and a missing view become
    in-order error responses."""
    pred = api.load_weights(None, _small(configs), seed=0, device="cpu")
    (l0, r0), (l1, r1) = _write_pngs(tmp_path, pairs)
    odd = str(tmp_path / "odd.png")
    Image.fromarray(np.zeros((SRC_HW[0], SRC_HW[1] - 1, 3), np.uint8)).save(odd)
    with open(l1, "rb") as f:
        l1_b64 = base64.b64encode(f.read()).decode()
    with open(r1, "rb") as f:
        r1_b64 = base64.b64encode(f.read()).decode()
    reqs = [
        {"id": 0, "left": l0, "right": r0},
        {"id": "bad_pair", "left": l0, "right": odd},
        {"id": 1, "left_b64": l1_b64, "right_b64": r1_b64},
        {"id": "no_right", "left": l0},
    ]
    out_dir = str(tmp_path / "out")
    resps = list(serve_requests(pred, reqs, out_dir, depth=2, artifacts="depth,disp,png"))
    assert [r["id"] for r in resps] == [0, "bad_pair", 1, "no_right"]
    assert "shape mismatch" in resps[1]["error"]
    assert "'right'" in resps[3]["error"]
    left, right = pairs
    for r, i, stem in ((resps[0], 0, "l0"), (resps[2], 1, "1")):
        assert "error" not in r and r["shape"] == list(SRC_HW)
        want = api.predict_stereo(pred, left[i], right[i])
        np.testing.assert_array_equal(np.load(r["output"]), want["depth"])
        np.testing.assert_array_equal(
            np.load(os.path.join(out_dir, stem + "_disp.npy")), want["disp"]
        )
        assert os.path.exists(os.path.join(out_dir, stem + "_disp.png"))


def test_serve_bf16_stereo_request(pairs, tmp_path):
    """A bf16 stereo request goes through serve_requests and comes back
    equal to predict_stereo of the same predictor."""
    cfg = dataclasses.replace(_small(configs), dtype="bfloat16")
    pred = api.load_weights(None, cfg, seed=0, device="cpu")
    assert pred.dtype == torch.bfloat16
    (l0, r0), _ = _write_pngs(tmp_path, pairs)
    out_dir = str(tmp_path / "out")
    (resp,) = serve_requests(pred, [{"id": 7, "left": l0, "right": r0}], out_dir, artifacts="depth,disp")
    assert "error" not in resp and resp["id"] == 7 and resp["shape"] == list(SRC_HW)
    left, right = pairs
    want = api.predict_stereo(pred, left[0], right[0])
    np.testing.assert_array_equal(np.load(resp["output"]), want["depth"])
    np.testing.assert_array_equal(np.load(os.path.join(out_dir, "l0_disp.npy")), want["disp"])
