"""The mono slice of the PyTorch port (scenedepthestimation_tpu_torch) end
to end against the JAX package: presets, predict_mono on the same weights
and frames, the server, and the port's package rules (no JAX import, no
fallback from CUDA to the CPU, no kernel launch on the CPU).
"""

import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from scenedepthestimation_tpu import api as jax_api
from scenedepthestimation_tpu import configs as jax_configs
from scenedepthestimation_tpu.utils import torch_export
from scenedepthestimation_tpu_torch import api, configs
from scenedepthestimation_tpu_torch.data import io as port_io
from scenedepthestimation_tpu_torch.models.monodepth import MonoDepthNet
from scenedepthestimation_tpu_torch.ops.cuda import _build
from scenedepthestimation_tpu_torch.serve import serve_requests, serve_stdio
from scenedepthestimation_tpu_torch.utils import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET_HW = (64, 192)
SRC_HW = (50, 150)  # not a multiple of the net size: both resizes run


def _small(cfg_module):
    cfg = cfg_module.get("mono_kitti_192x640_fp32")
    return dataclasses.replace(
        cfg, mono=dataclasses.replace(cfg.mono, height=NET_HW[0], width=NET_HW[1])
    )


def test_presets_equal_jax_presets():
    assert sorted(configs.PRESETS) == sorted(jax_configs.PRESETS)
    for name, jcfg in jax_configs.PRESETS.items():
        assert dataclasses.asdict(configs.get(name)) == dataclasses.asdict(jcfg), name
        assert configs.get(name).height == jcfg.height
        assert configs.get(name).width == jcfg.width
    assert configs.StereoConfig().corr_disp == jax_configs.StereoConfig().corr_disp
    assert configs.PreprocessConfig.imagenet() == configs.PreprocessConfig(
        *dataclasses.astuple(jax_configs.PreprocessConfig.imagenet())
    )


def _random_bn(variables, rng):
    """Random BatchNorm statistics, so a mix-up of mean and var shows."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        if "mean" in node and "var" in node:
            return dict(
                node,
                mean=rng.normal(0, 0.05, node["mean"].shape).astype(np.float32),
                var=rng.uniform(0.9, 1.1, node["var"].shape).astype(np.float32),
            )
        return {k: walk(v) for k, v in node.items()}

    return dict(variables, batch_stats=walk(variables["batch_stats"]))


@pytest.fixture(scope="module")
def jax_predictor():
    pred = jax_api.load_weights(None, _small(jax_configs), seed=0)
    variables = jax.tree_util.tree_map(np.array, dict(pred.variables))
    variables = _random_bn(variables, np.random.default_rng(3))
    pred.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    return pred, variables


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (2, *SRC_HW, 3), dtype=np.uint8)


def _port_predictor(variables, route, tmp_path):
    cfg = _small(configs)
    if route == "jax_variables":
        model = MonoDepthNet(cfg.mono)
        weights.load_state(model, weights.from_jax_variables(variables))
        return api.Predictor(cfg, model, "cpu")
    torch_export.export_torch_dir(variables, str(tmp_path), *NET_HW)
    return api.load_weights(str(tmp_path), cfg, device="cpu")


@pytest.mark.parametrize("post_process", [False, True], ids=["plain", "flip_tta"])
@pytest.mark.parametrize("route", ["jax_variables", "torch_dir"])
def test_predict_mono_matches_jax(jax_predictor, frames, route, post_process, tmp_path):
    """predict_mono of the port vs api.predict_mono on the same weights.

    'disp' is the scaled disparity 1/max_depth + (1/min_depth -
    1/max_depth) * sigmoid, 9.99x the network's sigmoid output here: it is
    held at atol 2e-6 in sigmoid units (the tests/test_parity.py tolerance
    of the heads) and at rtol 1e-5 itself; depth at rtol 1e-5.
    """
    jpred, variables = jax_predictor
    want = jax_api.predict_mono(jpred, frames, post_process=post_process)
    got = api.predict_mono(
        _port_predictor(variables, route, tmp_path), frames, post_process=post_process
    )
    mono = jpred.cfg.mono
    lo, hi = 1.0 / mono.max_depth, 1.0 / mono.min_depth
    for k in ("disp", "depth"):
        assert got[k].shape == (2, *SRC_HW) and got[k].dtype == np.float32
    np.testing.assert_allclose(
        (got["disp"] - lo) / (hi - lo), (want["disp"] - lo) / (hi - lo), atol=2e-6
    )
    np.testing.assert_allclose(got["disp"], want["disp"], rtol=1e-5)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-5)


def test_predict_mono_unbatched_and_counts_no_launch(jax_predictor, frames):
    pred = _port_predictor(jax_predictor[1], "jax_variables", None)
    _build.LAUNCHES.clear()
    one = api.predict_mono(pred, frames[0])
    both = api.predict_mono(pred, frames)
    assert one["depth"].shape == SRC_HW
    # The CPU convs pick their summation order by batch size: rtol 1e-6.
    np.testing.assert_allclose(one["depth"], both["depth"][0], rtol=1e-6)
    assert not _build.LAUNCHES  # CPU tensors take the plain versions


def test_load_weights_seeded_and_no_cuda_fallback(monkeypatch):
    cfg = _small(configs)
    a = api.load_weights(None, cfg, seed=5, device="cpu").model.state_dict()
    b = api.load_weights(None, cfg, seed=5, device="cpu").model.state_dict()
    c = api.load_weights(None, cfg, seed=6, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.conv1.weight"], c["encoder.conv1.weight"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.load_weights(None, cfg, device="cuda")


def test_stereo_is_not_ported():
    """Stereo is ported in fp32 and now in bf16 (its banded-Gram
    correlation): config 5's preset loads as a bf16 stereo predictor, and
    on CUDA it raises without a card rather than fall back."""
    assert api.load_weights(None, "stereo_256x512_b4", device="cpu").cfg.pipeline == "stereo"
    pred = api.load_weights(None, "stereo_kitti2015_b16_bf16_v5e8", device="cpu")
    assert pred.cfg.pipeline == "stereo" and pred.dtype == torch.bfloat16
    assert pred.cfg.stereo.feat_channels == 64 and pred.cfg.stereo.corr_disp == 48
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            api.load_weights(None, "stereo_kitti2015_b16_bf16_v5e8", device="cuda")


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import scenedepthestimation_tpu_torch\n"
        "import scenedepthestimation_tpu_torch.serve\n"
        "import scenedepthestimation_tpu_torch.ops.cuda.conv_block\n"
        "import scenedepthestimation_tpu_torch.ops.cuda.upsample_concat\n"
        "import scenedepthestimation_tpu_torch.ops.cuda.correlation\n"
        "import scenedepthestimation_tpu_torch.ops.cuda.correlation_gram\n"
        "import scenedepthestimation_tpu_torch.ops.cuda.soft_argmin\n"
        "import scenedepthestimation_tpu_torch.ops.cuda.fused_tail\n"
        "import scenedepthestimation_tpu_torch.ops.fused_tail\n"
        "import scenedepthestimation_tpu_torch.ops.cuda.winograd\n"
        "import scenedepthestimation_tpu_torch.ops.winograd\n"
        "import scenedepthestimation_tpu_torch.models.folded\n"
        "import scenedepthestimation_tpu_torch.benchmark\n"
        "import scenedepthestimation_tpu_torch.models.stereo\n"
        "import scenedepthestimation_tpu_torch.utils.weights\n"
        "import scenedepthestimation_tpu_torch.utils.colormap\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'scenedepthestimation_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.fixture(scope="module")
def port_predictor():
    return api.load_weights(None, _small(configs), seed=0, device="cpu")


def _write_frames(tmp_path, n):
    rng = np.random.default_rng(1)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"f{i}.png")
        Image.fromarray(rng.integers(0, 256, (*SRC_HW, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def test_serve_requests_in_order(port_predictor, tmp_path):
    paths = _write_frames(tmp_path, 2)
    reqs = [
        {"id": 0, "image": paths[0]},
        {"id": "bad", "image": str(tmp_path / "missing.png")},
        {"id": 1, "image": paths[1]},
    ]
    out_dir = str(tmp_path / "out")
    resps = list(serve_requests(port_predictor, reqs, out_dir, depth=3, artifacts="depth,disp,png"))
    assert [r["id"] for r in resps] == [0, "bad", 1]
    assert "error" in resps[1]
    for r, p in zip((resps[0], resps[2]), paths):
        assert r["shape"] == list(SRC_HW)
        want = api.predict_mono(port_predictor, port_io.load_image(p))
        np.testing.assert_array_equal(np.load(r["output"]), want["depth"])
        stem = os.path.splitext(os.path.basename(p))[0]
        assert os.path.exists(os.path.join(out_dir, stem + "_disp.npy"))
        png = port_io.load_image(os.path.join(out_dir, stem + "_disp.png"))
        assert png.shape == (*SRC_HW, 3)


def test_serve_stdio_protocol(port_predictor, tmp_path):
    (path,) = _write_frames(tmp_path, 1)
    stdin = io.StringIO(json.dumps({"id": 7, "image": path}) + "\n{not json\n")
    stdout = io.StringIO()
    n = serve_stdio(port_predictor, str(tmp_path / "o"), stdin=stdin, stdout=stdout)
    lines = [json.loads(x) for x in stdout.getvalue().splitlines()]
    assert n == 2 and lines[0]["ready"] is True
    assert lines[1]["id"] == 7 and lines[1]["shape"] == list(SRC_HW)
    assert lines[2]["id"] is None and "malformed JSON" in lines[2]["error"]


TAIL_HW = (64, 128)  # net size = frame size: the JAX fast-tail branch
LO, HI = 1.0 / 100.0, 1.0 / 0.1  # the presets' scaled-disparity range


def _tail_cfg(cfg_module, dtype):
    cfg = cfg_module.get("mono_kitti_384x1152_bench")
    return dataclasses.replace(
        cfg, dtype=dtype,
        mono=dataclasses.replace(cfg.mono, height=TAIL_HW[0], width=TAIL_HW[1]),
    )


def _port_tail_predict(cfg, state, frames):
    from scenedepthestimation_tpu_torch.ops import fused_tail

    model = MonoDepthNet(cfg.mono)
    weights.load_state(model, state)
    fused_tail.set_use_fused_tail("v2")
    try:
        return api.predict_mono(api.Predictor(cfg, model, "cpu"), frames)
    finally:
        fused_tail.set_use_fused_tail(None)


def _abs_rel(depth, ref):
    return float(np.mean(np.abs(depth - ref) / ref))


@pytest.fixture(scope="module")
def tail_runs(jax_predictor):
    """predict_mono of the JAX package (build_mono_program with the "v2"
    fused tail, kernel 4 in interpret mode) and of the port (fused tail on)
    in fp32 and bf16, on the same seeded weights with random BatchNorm
    statistics and the same b2 uint8 frames at the net size."""
    from scenedepthestimation_tpu.ops import collapsed

    variables = jax_predictor[1]
    frames = np.random.default_rng(4).integers(0, 256, (2, *TAIL_HW, 3), dtype=np.uint8)
    state = weights.from_jax_variables(variables)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jpred = jax_api.Predictor(_tail_cfg(jax_configs, dtype), jax.tree_util.tree_map(jnp.asarray, variables))
        collapsed.set_use_fused_tail("v2")
        try:
            out["jax", dtype] = jax_api.predict_mono(jpred, frames)
        finally:
            collapsed.set_use_fused_tail(None)
        out["port", dtype] = _port_tail_predict(_tail_cfg(configs, dtype), state, frames)
    return out


def test_predict_mono_fused_tail_matches_jax_fp32(tail_runs):
    """fp32: disparity atol 1e-5 in sigmoid units, depth rtol 1e-4."""
    got, want = tail_runs["port", "float32"], tail_runs["jax", "float32"]
    for k in ("disp", "depth"):
        assert got[k].shape == (2, *TAIL_HW) and got[k].dtype == np.float32
    np.testing.assert_allclose((got["disp"] - LO) / (HI - LO), (want["disp"] - LO) / (HI - LO), atol=1e-5)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-4)


def test_predict_mono_fused_tail_matches_jax_bf16(tail_runs):
    """bf16, about twice the measured differences (3.36e-3 in sigmoid units
    at most, depth abs-rel 1.89e-3): the two programs round bf16 at other
    places (XLA-CPU and oneDNN convs; the JAX decoder rounds each conv
    output, adds the bias in bf16 and rounds the head's logits, the port
    rounds once after bias and activation). Against fp32 on the same
    weights the port stays within max(2 x the JAX package's own figure,
    1e-3), the budget of BASELINE.json: random LeCun-init weights put both
    packages above 1e-3 here (JAX 1.76e-3, the port 1.89e-3), which the
    reference's own weights do not (8.9e-5 in
    test_bf16_depth_abs_rel_on_reference_weights)."""
    got, want = tail_runs["port", "bfloat16"], tail_runs["jax", "bfloat16"]
    s_err = np.abs(got["disp"] - want["disp"]).max() / (HI - LO)
    assert s_err <= 7e-3, s_err
    assert _abs_rel(got["depth"], want["depth"]) <= 4e-3
    jax_rel = _abs_rel(want["depth"], tail_runs["jax", "float32"]["depth"])
    port_rel = _abs_rel(got["depth"], tail_runs["port", "float32"]["depth"])
    assert 0 < port_rel <= max(2 * jax_rel, 1e-3), (port_rel, jax_rel)


def test_bf16_depth_abs_rel_on_reference_weights():
    """bf16 against fp32 on the reference's seed-0 weights (tools/torch_ref,
    the weights parity_abs_rel uses), fused tail on: depth abs-rel <= 1e-3,
    the budget of BASELINE.json."""
    from scenedepthestimation_tpu_torch import benchmark

    torch.manual_seed(0)
    state = benchmark._torch_ref().MonoDepthNet().state_dict()
    state = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    frames = np.random.default_rng(5).integers(0, 256, (2, *TAIL_HW, 3), dtype=np.uint8)
    depth = {dt: _port_tail_predict(_tail_cfg(configs, dt), state, frames)["depth"]
             for dt in ("float32", "bfloat16")}
    rel = _abs_rel(depth["bfloat16"], depth["float32"])
    assert 0 < rel <= 1e-3, rel


def test_predict_batch_equals_mono_forward_per_batch(port_predictor):
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, 256, (b, *SRC_HW, 3), dtype=np.uint8) for b in (2, 1)]
    outs = api.predict_batch(port_predictor, iter(batches))
    assert len(outs) == 2
    for out, frames in zip(outs, batches):
        want = port_predictor.mono_forward(torch.from_numpy(frames))
        assert sorted(out) == ["depth", "disp"]
        for k in ("disp", "depth"):
            assert isinstance(out[k], np.ndarray) and out[k].shape == (len(frames), *SRC_HW)
            np.testing.assert_array_equal(out[k], want[k].numpy())
    with pytest.raises(NotImplementedError, match="mesh"):
        api.predict_batch(port_predictor, batches, mesh=object())


@pytest.mark.parametrize(
    "config,section,dtype,extra",
    [
        ("mono_kitti_384x1152_bench", "mono", "bfloat16", {}),
        ("stereo_256x512_b4", "stereo", "float32", {}),
        ("mono_kitti_384x1152_bench", "mono", "bfloat16", {"mono.fast_borders": True}),
    ],
    ids=["mono_bench", "stereo", "mono_bench_fast_borders"],
)
def test_run_bench_on_cpu_returns_jax_keys(config, section, dtype, extra):
    """run_bench at 64x128, b2, one iteration on the CPU: the keys of the
    JAX package's run_bench (scenedepthestimation_tpu/benchmark.py:194-205)
    and a finite checksum; the mono bench with the fused tail on, and once
    with the mono.fast_borders override the JAX run_bench also takes."""
    from scenedepthestimation_tpu_torch import benchmark
    from scenedepthestimation_tpu_torch.ops import fused_tail

    fused_tail.set_use_fused_tail(True)
    try:
        r = benchmark.run_bench(
            config, batch_size=2, iters=1, warmup=1, device="cpu",
            overrides={f"{section}.height": TAIL_HW[0], f"{section}.width": TAIL_HW[1], **extra},
        )
    finally:
        fused_tail.set_use_fused_tail(None)
    assert sorted(r) == sorted([
        "metric", "value", "unit", "vs_baseline", "batch_size", "dtype", "iters",
        "device", "reference_cpu_fps", "checksum",
    ])
    assert r["metric"] == f"{section}_frames_per_sec_per_chip_64x128"
    assert (r["batch_size"], r["dtype"], r["iters"], r["device"]) == (2, dtype, 1, "cpu")
    assert np.isfinite(r["checksum"]) and r["checksum"] > 0 and r["value"] > 0


def test_parity_abs_rel_fp32_on_cpu():
    from scenedepthestimation_tpu_torch import benchmark

    rel = benchmark.parity_abs_rel("float32", device="cpu")
    assert 0 <= rel < 1e-5, rel


def _fold_cfg(cfg_module, dtype, **mono):
    """The bench preset at 64x128 with fold_bn on (and more mono fields)."""
    cfg = cfg_module.get("mono_kitti_384x1152_bench")
    mono = dataclasses.replace(
        cfg.mono, **{"height": TAIL_HW[0], "width": TAIL_HW[1], "fold_bn": True, **mono}
    )
    return dataclasses.replace(cfg, dtype=dtype, mono=mono)


def _strong_bn_variables(variables, seed):
    """Every BatchNorm's scale U(0.5, 1.5), shift N(0, 0.3), mean N(0, 0.5)
    and var U(0.2, 2) (tests/test_folded.py's draws): a fold that mixes
    them up moves the depth."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        if "mean" in out and "var" in out:
            out["mean"] = rng.normal(0, 0.5, out["mean"].shape).astype(np.float32)
            out["var"] = rng.uniform(0.2, 2.0, out["var"].shape).astype(np.float32)
        if "scale" in out and "bias" in out:
            out["scale"] = rng.uniform(0.5, 1.5, out["scale"].shape).astype(np.float32)
            out["bias"] = rng.normal(0, 0.3, out["bias"].shape).astype(np.float32)
        return out

    return {"params": walk(variables["params"]), "batch_stats": walk(variables["batch_stats"])}


@pytest.fixture(scope="module")
def fold_runs():
    """predict_mono with fold_bn on, JAX (build_mono_program folds and runs
    folded_encoder_apply) and the port, on the same seeded weights with
    random BatchNorm terms and the same b2 uint8 frames at the net size:
    fp32, bf16, and fp32 with s2d_stem; the port's predictor and the JAX
    unfolded fp32 run beside them."""
    jpred = jax_api.load_weights(None, _fold_cfg(jax_configs, "float32"), seed=0)
    variables = _strong_bn_variables(jax.tree_util.tree_map(np.array, dict(jpred.variables)), 3)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    state = weights.from_jax_variables(variables)
    frames = np.random.default_rng(7).integers(0, 256, (2, *TAIL_HW, 3), dtype=np.uint8)
    out = {}
    for key, dtype, mono in (
        ("fp32", "float32", {}), ("bf16", "bfloat16", {}), ("s2d", "float32", {"s2d_stem": True}),
        ("unfolded", "float32", {"fold_bn": False}),
    ):
        out["jax", key] = jax_api.predict_mono(
            jax_api.Predictor(_fold_cfg(jax_configs, dtype, **mono), jvars), frames
        )
        model = MonoDepthNet(_fold_cfg(configs, dtype).mono)
        weights.load_state(model, state)
        out["predictor", key] = api.Predictor(_fold_cfg(configs, dtype, **mono), model, "cpu")
        out["port", key] = api.predict_mono(out["predictor", key], frames)
    return out


@pytest.mark.parametrize("key", ["fp32", "s2d"])
def test_predict_mono_fold_bn_matches_jax_fp32(fold_runs, key):
    """fold_bn on, fp32: disparity atol 2e-6 in sigmoid units and depth rtol
    1e-5 against the JAX program (measured 5.0e-7 and 1.7e-6). With
    s2d_stem the JAX program runs its space-to-depth stem, an exact relayout,
    and the port its plain stem: the same tolerances (measured 6.0e-7,
    1.9e-6). The port's encoder is the folded one; the unfolded run differs."""
    from scenedepthestimation_tpu_torch.models.folded import FoldedEncoder

    got, want = fold_runs["port", key], fold_runs["jax", key]
    for k in ("disp", "depth"):
        assert got[k].shape == (2, *TAIL_HW) and got[k].dtype == np.float32
    np.testing.assert_allclose((got["disp"] - LO) / (HI - LO), (want["disp"] - LO) / (HI - LO), atol=2e-6)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-5)
    assert isinstance(fold_runs["predictor", key].model.encoder, FoldedEncoder)
    assert not isinstance(fold_runs["predictor", "unfolded"].model.encoder, FoldedEncoder)
    assert not np.array_equal(got["depth"], fold_runs["port", "unfolded"]["depth"])


def test_predict_mono_fold_bn_matches_jax_bf16(fold_runs):
    """fold_bn on, bf16, about twice the measured differences (3.58e-3 in
    sigmoid units, depth abs-rel 2.42e-3): both fold in fp32 and cast the
    folded kernels and biases to bf16, but XLA-CPU and oneDNN round the bf16
    convs at other places and the JAX collapsed decoder rounds each conv
    output, its bias add and its ELU in bf16 (ROADMAP Queue 3). Against its
    own fp32 run the port stays within max(2 x the JAX package's own figure,
    1e-3) (measured: the port 1.70e-3, JAX 2.29e-3)."""
    got, want = fold_runs["port", "bf16"], fold_runs["jax", "bf16"]
    s_err = np.abs(got["disp"] - want["disp"]).max() / (HI - LO)
    assert s_err <= 7e-3, s_err
    assert _abs_rel(got["depth"], want["depth"]) <= 5e-3
    jax_rel = _abs_rel(want["depth"], fold_runs["jax", "fp32"]["depth"])
    port_rel = _abs_rel(got["depth"], fold_runs["port", "fp32"]["depth"])
    assert fold_runs["predictor", "bf16"].model.encoder.conv1.weight.dtype == torch.bfloat16
    assert 0 < port_rel <= max(2 * jax_rel, 1e-3), (port_rel, jax_rel)


def _fast_cfg(cfg_module, dtype, **mono):
    """The bench preset at 64x128 with fast_borders on (and more mono fields)."""
    cfg = cfg_module.get("mono_kitti_384x1152_bench")
    mono = dataclasses.replace(
        cfg.mono, **{"height": TAIL_HW[0], "width": TAIL_HW[1], "fast_borders": True, **mono}
    )
    return dataclasses.replace(cfg, dtype=dtype, mono=mono)


FAST_CASES = {  # key: (dtype, fused tail flag, more mono fields)
    "off_fp32": ("float32", None, {}),
    "off_bf16": ("bfloat16", None, {}),
    "v2_fp32": ("float32", "v2", {}),
    "v2_bf16": ("bfloat16", "v2", {}),
    # Without the packed decoder the JAX program does not take use_packed,
    # so fast borders do nothing there: the reflect decoder runs.
    "unpacked_fp32": ("float32", None, {"packed_decoder": False}),
}


@pytest.fixture(scope="module")
def fast_runs(jax_predictor):
    """predict_mono with mono.fast_borders on, JAX (build_mono_program: the
    collapsed decoder with border_mode="fast", the v2 fused tail in
    interpret mode) and the port, on the same seeded weights with random
    BatchNorm statistics and the same b2 uint8 frames at the net size; and
    the port with fast_borders off beside each."""
    from scenedepthestimation_tpu.ops import collapsed
    from scenedepthestimation_tpu_torch.ops import fused_tail

    variables = jax_predictor[1]
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    state = weights.from_jax_variables(variables)
    frames = np.random.default_rng(8).integers(0, 256, (2, *TAIL_HW, 3), dtype=np.uint8)
    out = {}
    for key, (dtype, flag, mono) in FAST_CASES.items():
        collapsed.set_use_fused_tail(flag)
        try:
            out["jax", key] = jax_api.predict_mono(
                jax_api.Predictor(_fast_cfg(jax_configs, dtype, **mono), jvars), frames
            )
        finally:
            collapsed.set_use_fused_tail(None)
        fused_tail.set_use_fused_tail(flag)
        try:
            for fast in (True, False):
                cfg = _fast_cfg(configs, dtype, fast_borders=fast, **mono)
                model = MonoDepthNet(cfg.mono)
                weights.load_state(model, state)
                pred = api.Predictor(cfg, model, "cpu")
                out["port" if fast else "exact", key] = api.predict_mono(pred, frames)
                if fast:
                    out["border_mode", key] = pred.model.decoder.border_mode
        finally:
            fused_tail.set_use_fused_tail(None)
    return out


@pytest.mark.parametrize("key", ["off_fp32", "v2_fp32", "unpacked_fp32"])
def test_predict_mono_fast_borders_matches_jax_fp32(fast_runs, key):
    """fast_borders, fp32, against the JAX program: disparity atol 2e-6 in
    sigmoid units, depth rtol 1e-5. With the fused tail off every decoder
    conv and the head take a zero border; with it on ("v2") level 0 stays
    the reflect fused kernel and the head reflect, as in the JAX collapsed
    decoder. Where the JAX program does not take its collapsed decoder
    (no packed decoder) the port runs the reflect decoder: the fast_borders
    run equals the one without it. Measured: 4.3e-7 to 4.5e-7 in sigmoid
    units, depth 1.4e-6 to 1.7e-6 relative."""
    got, want = fast_runs["port", key], fast_runs["jax", key]
    for k in ("disp", "depth"):
        assert got[k].shape == (2, *TAIL_HW) and got[k].dtype == np.float32
    np.testing.assert_allclose((got["disp"] - LO) / (HI - LO), (want["disp"] - LO) / (HI - LO), atol=2e-6)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-5)
    exact = fast_runs["exact", key]
    if key == "unpacked_fp32":
        assert fast_runs["border_mode", key] == "exact"
        np.testing.assert_array_equal(got["depth"], exact["depth"])
    else:
        assert fast_runs["border_mode", key] == "fast"
        assert not np.allclose(got["depth"], exact["depth"], rtol=1e-3)


@pytest.mark.parametrize("key", ["off_bf16", "v2_bf16"])
def test_predict_mono_fast_borders_matches_jax_bf16(fast_runs, key):
    """fast_borders, bf16, against the JAX program: the limits the fused-tail
    and fold_bn bf16 tests above hold (disparity 7e-3 in sigmoid units,
    depth abs-rel 5e-3); the two programs round bf16 at other places. Measured:
    3.17e-3 and 3.00e-3 in sigmoid units, depth abs-rel 1.72e-3 and
    1.75e-3 (fused tail off and "v2")."""
    got, want = fast_runs["port", key], fast_runs["jax", key]
    s_err = np.abs(got["disp"] - want["disp"]).max() / (HI - LO)
    assert s_err <= 7e-3, s_err
    assert _abs_rel(got["depth"], want["depth"]) <= 5e-3


def test_predict_mono_one_pixel_level_matches_jax(jax_predictor):
    """A 32x64 network, whose level-4 features are 1x2 (a 1-pixel axis under
    the reflect border), against the JAX program on the same weights, b2
    40x70 frames resized to the net size: disparity atol 2e-6 in sigmoid
    units, depth rtol 1e-5."""
    variables = jax_predictor[1]
    jcfg, cfg = (
        dataclasses.replace(m.get("mono_kitti_192x640_fp32"),
                            mono=dataclasses.replace(m.get("mono_kitti_192x640_fp32").mono,
                                                     height=32, width=64))
        for m in (jax_configs, configs)
    )
    frames = np.random.default_rng(9).integers(0, 256, (2, 40, 70, 3), dtype=np.uint8)
    want = jax_api.predict_mono(jax_api.Predictor(jcfg, jax.tree_util.tree_map(jnp.asarray, variables)), frames)
    model = MonoDepthNet(cfg.mono)
    weights.load_state(model, weights.from_jax_variables(variables))
    got = api.predict_mono(api.Predictor(cfg, model, "cpu"), frames)
    assert got["depth"].shape == (2, 40, 70)
    np.testing.assert_allclose((got["disp"] - LO) / (HI - LO), (want["disp"] - LO) / (HI - LO), atol=2e-6)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-5)


def test_load_weights_single_pth_file(tmp_path, frames):
    """One .pth state-dict file (the seed-0 tools/torch_ref state_dict, as
    parity_abs_rel builds it): the port's load_weights gives the same depth
    as the family's directory form of the same weights (encoder.pth +
    depth.pth), and the JAX load_weights of the same file agrees at the fp32
    tolerances (disparity atol 2e-6 in sigmoid units, depth rtol 1e-5)."""
    from scenedepthestimation_tpu_torch import benchmark

    torch.manual_seed(0)
    state = benchmark._torch_ref().MonoDepthNet().state_dict()
    state = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    torch.save(state, tmp_path / "model.pth")
    (tmp_path / "family").mkdir()
    for name, prefix in (("encoder.pth", "encoder."), ("depth.pth", "decoder.")):
        torch.save({k: v for k, v in state.items() if k.startswith(prefix)}, tmp_path / "family" / name)
    cfg = _small(configs)
    got = api.predict_mono(api.load_weights(str(tmp_path / "model.pth"), cfg, device="cpu"), frames)
    via_dir = api.predict_mono(api.load_weights(str(tmp_path / "family"), cfg, device="cpu"), frames)
    for k in ("disp", "depth"):
        np.testing.assert_array_equal(got[k], via_dir[k])
    want = jax_api.predict_mono(jax_api.load_weights(str(tmp_path / "model.pth"), _small(jax_configs)), frames)
    np.testing.assert_allclose((got["disp"] - LO) / (HI - LO), (want["disp"] - LO) / (HI - LO), atol=2e-6)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-5)


def test_load_weights_rejects_orbax_and_unknown_paths(tmp_path):
    """A directory without a .pth file is the JAX package's Orbax form: the
    message names the conversion to .pth files. Any other path raises as
    the JAX package's 'unrecognized checkpoint path'."""
    orbax = tmp_path / "ckpt"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="scenedepth export --weights .* --torch OUT"):
        api.load_weights(str(orbax), _small(configs), device="cpu")
    with pytest.raises(ValueError, match="unrecognized checkpoint path"):
        api.load_weights(str(tmp_path / "weights.npz"), _small(configs), device="cpu")


def test_parity_abs_rel_fold_bn_fp32_on_cpu():
    """parity_abs_rel with the folded encoder: the reference's seed-0 BN terms
    fold exactly enough for fp32 to stay below 1e-5."""
    from scenedepthestimation_tpu_torch import benchmark

    rel = benchmark.parity_abs_rel("float32", overrides={"mono.fold_bn": True}, device="cpu")
    assert 0 <= rel < 1e-5, rel
