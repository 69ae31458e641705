"""Modules of the PyTorch port (scenedepthestimation_tpu_torch) against the
JAX modules on the same weights and inputs, made with numpy from a seed.

Weights cross over through the port's ``from_jax_variables`` (and, in one
test, through the JAX package's ``.pth`` export and the port's
``load_torch_dir``). BatchNorm statistics and affine terms are randomized
first, so a mix-up of scale/bias/mean/var cannot pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedepthestimation_tpu.models.unet_decoder as jax_dec
import scenedepthestimation_tpu.ops.pallas.conv_block as jax_cb
from scenedepthestimation_tpu.configs import MonoConfig as JaxMonoConfig
from scenedepthestimation_tpu.models.monodepth import MonoDepthNet as JaxMonoDepthNet
from scenedepthestimation_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from scenedepthestimation_tpu.utils import torch_export, torch_import
from scenedepthestimation_tpu_torch.configs import MonoConfig
from scenedepthestimation_tpu_torch.models.monodepth import MonoDepthNet
from scenedepthestimation_tpu_torch.models.resnet import ResNetEncoder
from scenedepthestimation_tpu_torch.models.unet_decoder import DepthDecoder
from scenedepthestimation_tpu_torch.utils import weights


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.array, dict(tree))  # writable copies


def randomize_bn(variables, seed):
    """Random BatchNorm scale/bias/mean/var in a Flax variable tree."""
    rng = np.random.default_rng(seed)

    def walk(node, leaf_fn):
        return {
            k: walk(v, leaf_fn) if isinstance(v, dict) else leaf_fn(k, v)
            for k, v in node.items()
        }

    draw = {
        "scale": lambda v: rng.uniform(0.95, 1.05, v.shape),
        "mean": lambda v: rng.normal(0.0, 0.05, v.shape),
        "var": lambda v: rng.uniform(0.95, 1.05, v.shape),
    }

    def leaf(k, v):
        if k in draw:
            return draw[k](v).astype(np.float32)
        return np.asarray(v)

    out = dict(variables)
    out["params"] = walk(dict(variables["params"]), leaf)
    out["batch_stats"] = walk(dict(variables["batch_stats"]), leaf)
    # BN biases: only those beside a BN scale (conv biases stay as they are).
    def bn_bias(node):
        if not isinstance(node, dict):
            return node
        if "scale" in node and "bias" in node:
            node = dict(node, bias=rng.normal(0.0, 0.05, node["bias"].shape).astype(np.float32))
        return {k: bn_bias(v) for k, v in node.items()}

    out["params"] = bn_bias(out["params"])
    return out


def test_resnet18_features_match_jax():
    """All 5 pyramid levels; atol 2e-6, rtol 1e-5, the tolerances
    tests/test_parity.py holds the JAX encoder to torch at. As there, the
    weights start from torch's default init (smaller than Flax's LeCun
    init, so the fp32 reassociation error stays under atol), with random
    BatchNorm terms, and cross to Flax through the JAX package's importer;
    from_jax_variables must bring them back bit for bit."""
    torch.manual_seed(1)
    tenc = ResNetEncoder(num_layers=18).eval()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in tenc.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo, hi in ((m.weight, 0.8, 1.2), (m.running_var, 0.8, 1.2)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, t.shape).astype(np.float32)))
                for t in (m.bias, m.running_mean):
                    t.copy_(torch.from_numpy(rng.normal(0, 0.1, t.shape).astype(np.float32)))
    variables = torch_import.convert_state_dict(tenc.state_dict())
    back = weights.from_jax_variables(variables)
    for k, v in tenc.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k

    x = np.random.default_rng(4).normal(size=(2, 64, 96, 3)).astype(np.float32)
    want = JaxResNetEncoder(num_layers=18).apply(variables, jnp.asarray(x))
    port = ResNetEncoder(num_layers=18).eval()
    weights.load_state(port, back)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), atol=2e-6, rtol=1e-5, err_msg=f"level {lvl}"
        )


def test_resnet18_channels_last_matches_contiguous():
    """The predictor runs the encoder in channels_last; same numbers."""
    torch.manual_seed(0)
    enc = ResNetEncoder(18).eval()
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        a = enc(x)
        enc.to(memory_format=torch.channels_last)
        b = enc(x)
    for fa, fb in zip(a, b):
        assert fb.is_contiguous()
        np.testing.assert_allclose(fa.numpy(), fb.numpy(), atol=1e-6)


def _features(rng, b, h, w, chans):
    return [
        rng.normal(size=(b, h >> (k + 1), w >> (k + 1), c)).astype(np.float32)
        for k, c in enumerate(chans)
    ]


def test_decoder_matches_jax_with_fused_pallas_conv():
    """Disparities at all 4 scales vs the JAX DepthDecoder with its fused
    Pallas conv switched on (interpret mode, as tests/test_pallas.py runs
    it), at narrow widths; atol 2e-6."""
    enc_ch, dec_ch = (8, 8, 16, 16, 32), (4, 8, 8, 16, 16)
    feats = _features(np.random.default_rng(6), 2, 64, 128, enc_ch)
    jdec = jax_dec.DepthDecoder(dec_channels=dec_ch)
    orig = jax_cb.conv3x3_elu_pallas
    jax_cb.conv3x3_elu_pallas = lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
    jax_dec.set_use_fused_conv(True)
    try:
        jfeats = [jnp.asarray(f) for f in feats]
        params = _numpy_tree(jdec.init(jax.random.PRNGKey(2), jfeats))
        # Non-zero biases, so a dropped or misplaced bias cannot pass.
        rng = np.random.default_rng(7)
        params = jax.tree_util.tree_map(
            lambda v: v + rng.normal(0, 0.05, v.shape).astype(np.float32) if v.ndim == 1 else v,
            params,
        )
        want = jdec.apply(params, jfeats)
    finally:
        jax_dec.set_use_fused_conv(None)
        jax_cb.conv3x3_elu_pallas = orig

    tdec = DepthDecoder(num_ch_enc=enc_ch, dec_channels=dec_ch).eval()
    weights.load_state(tdec, weights.from_jax_variables(params))
    with torch.no_grad():
        got = tdec([torch.from_numpy(f) for f in feats])
        only0 = tdec([torch.from_numpy(f) for f in feats], scales=(0,))
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    assert sorted(only0) == [0]
    for s in want:
        assert got[s].dtype == torch.float32
        np.testing.assert_allclose(
            got[s].numpy(), np.asarray(want[s]), atol=2e-6, err_msg=f"scale {s}"
        )
    np.testing.assert_array_equal(only0[0].numpy(), got[0].numpy())


def _mono_variables(h, w, seed):
    jnet = JaxMonoDepthNet(cfg=JaxMonoConfig(height=h, width=w))
    v = _numpy_tree(jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3))))
    return jnet, randomize_bn(v, seed)


def test_monodepth_net_matches_jax():
    """The whole network, every scale, at full widths; atol 2e-6, rtol
    1e-5 (the JAX decoder here runs its XLA convs, equal to the Pallas
    kernel to 5e-6 per tests/test_pallas.py)."""
    jnet, variables = _mono_variables(64, 128, 3)
    x = np.random.default_rng(8).normal(size=(1, 64, 128, 3)).astype(np.float32)
    want = jnet.apply(variables, jnp.asarray(x))
    tnet = MonoDepthNet(MonoConfig(height=64, width=128)).eval()
    weights.load_state(tnet, weights.from_jax_variables(variables))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    for s in (0, 1, 2, 3):
        np.testing.assert_allclose(
            got[s].numpy(), np.asarray(want[s]), atol=2e-6, rtol=1e-5, err_msg=f"scale {s}"
        )


def test_load_torch_dir_equals_from_jax_variables(tmp_path):
    """The family's .pth layout written by the JAX exporter loads into the
    same state as the direct conversion, bit for bit."""
    _, variables = _mono_variables(32, 64, 4)
    torch_export.export_torch_dir(variables, str(tmp_path), height=32, width=64)
    direct = weights.from_jax_variables(variables)
    via_pth = weights.load_torch_dir(str(tmp_path))
    assert sorted(direct) == sorted(via_pth)
    for k in direct:
        assert torch.equal(direct[k], via_pth[k]), k
    net = MonoDepthNet(MonoConfig(height=32, width=64))
    weights.load_state(net, via_pth)  # every parameter and buffer covered


def test_load_state_rejects_mismatch(tmp_path):
    net = MonoDepthNet(MonoConfig(height=32, width=64))
    state = {k: v for k, v in net.state_dict().items() if "dispconv_3" not in k}
    with pytest.raises(ValueError, match="missing"):
        weights.load_state(net, state)
    with pytest.raises(FileNotFoundError, match="encoder.pth"):
        weights.load_torch_dir(str(tmp_path))


def test_decoder_fused_tail_matches_jax_collapsed_v2():
    """DepthDecoder with the fused tail on vs the JAX collapsed decoder with
    set_use_fused_tail("v2") (kernel 4 in interpret mode) on the same
    features at 64x128 and full widths: scale-0 disparity atol 1e-5, the
    JAX package's fused-tail tolerance. With the switch off the port's
    decoder gives the same numbers exactly (both take the plain versions
    on the CPU)."""
    from scenedepthestimation_tpu.ops import collapsed
    from scenedepthestimation_tpu_torch.ops import fused_tail

    enc_ch = (64, 64, 128, 256, 512)
    feats = _features(np.random.default_rng(9), 2, 64, 128, enc_ch)
    jfeats = [jnp.asarray(f) for f in feats]
    jdec = jax_dec.DepthDecoder()
    params = _numpy_tree(jdec.init(jax.random.PRNGKey(4), jfeats))
    rng = np.random.default_rng(10)
    params = jax.tree_util.tree_map(
        lambda v: v + rng.normal(0, 0.05, v.shape).astype(np.float32) if v.ndim == 1 else v,
        params,
    )
    collapsed.set_use_fused_tail("v2")
    try:
        want = np.asarray(collapsed.collapsed_mono_decoder(params["params"], jfeats))
    finally:
        collapsed.set_use_fused_tail(None)

    tdec = DepthDecoder(num_ch_enc=enc_ch).eval()
    weights.load_state(tdec, weights.from_jax_variables(params))
    tfeats = [torch.from_numpy(f) for f in feats]
    fused_tail.set_use_fused_tail("v2")
    try:
        with torch.no_grad():
            got = tdec(tfeats, scales=(0,))[0]
    finally:
        fused_tail.set_use_fused_tail(None)
    with torch.no_grad():
        unfused = tdec(tfeats, scales=(0,))[0]
    assert got.shape == want.shape == (2, 64, 128, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert torch.equal(got, unfused)


def _folded_setup(num_layers, seed=0, hw=(64, 96)):
    """The port's encoder from torch's default init (seeded) with its
    BatchNorm terms randomized as tests/test_folded.py randomizes them
    (scale U(0.5, 1.5), shift N(0, 0.3), mean N(0, 0.5), var U(0.2, 2)), far
    from the init's identity, so a fold that mixes them up cannot pass; the
    same weights as Flax variables through the JAX package's importer, and a
    (2, H, W, 3) input. As in test_resnet18_features_match_jax, torch's init
    is smaller than Flax's LeCun init, which keeps the fp32 reassociation
    error of two conv libraries under the absolute tolerance."""
    torch.manual_seed(seed)
    enc = ResNetEncoder(num_layers).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, draw in (
                    (m.weight, lambda s: rng.uniform(0.5, 1.5, s)),
                    (m.bias, lambda s: rng.normal(0.0, 0.3, s)),
                    (m.running_mean, lambda s: rng.normal(0.0, 0.5, s)),
                    (m.running_var, lambda s: rng.uniform(0.2, 2.0, s)),
                ):
                    t.copy_(torch.from_numpy(draw(t.shape).astype(np.float32)))
    variables = torch_import.convert_state_dict(enc.state_dict())
    x = np.random.default_rng(seed + 11).normal(size=(2, *hw, 3)).astype(np.float32)
    return variables, enc, x


@pytest.mark.parametrize("num_layers", [18, 50])
def test_fold_encoder_bn_matches_jax(num_layers):
    """fold_encoder_bn of the port's encoder vs the JAX package's on the same
    carried-across weights, every conv (kernels HWIO -> OIHW): atol 1e-6."""
    from scenedepthestimation_tpu.models.folded import fold_encoder_bn as jax_fold
    from scenedepthestimation_tpu_torch.models import folded

    variables, enc, _ = _folded_setup(num_layers)
    want = jax_fold(variables["params"], variables["batch_stats"], num_layers)
    got = folded.fold_encoder_bn(enc)
    assert sorted(got) == sorted(want)
    for name, node in want.items():
        leaves = {name: node} if "kernel" in node else {f"{name}/{k}": v for k, v in node.items()}
        part = got[name]
        for key, t in leaves.items():
            p = part if "kernel" in node else part[key.split("/")[1]]
            assert p["weight"].dtype == torch.float32, key
            np.testing.assert_allclose(
                p["weight"].permute(2, 3, 1, 0).numpy(), np.asarray(t["kernel"]), atol=1e-6, rtol=0, err_msg=key
            )
            np.testing.assert_allclose(p["bias"].numpy(), np.asarray(t["bias"]), atol=1e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("num_layers", [18, 50])
def test_folded_encoder_matches_jax_folded_apply(num_layers):
    """FoldedEncoder vs folded_encoder_apply (fp32, XLA convs) at 64x96:
    every level atol 2e-5, rtol 1e-5 (tests/test_folded.py's tolerance)."""
    from scenedepthestimation_tpu.models.folded import fold_encoder_bn as jax_fold
    from scenedepthestimation_tpu.models.folded import folded_encoder_apply
    from scenedepthestimation_tpu_torch.models import folded

    variables, enc, x = _folded_setup(num_layers, seed=1)
    want = folded_encoder_apply(
        jax_fold(variables["params"], variables["batch_stats"], num_layers), jnp.asarray(x), num_layers
    )
    fenc = folded.FoldedEncoder.from_encoder(enc).eval()
    with torch.no_grad():
        got = fenc(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.is_contiguous() and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-5, err_msg=f"level {lvl}")


def test_folded_encoder_on_winograd_equals_cudnn_path(monkeypatch):
    """The folded ResNet-18 with its 13 stride-1 BasicBlock convs swapped onto
    ops.winograd.winograd_conv3x3 (its plain version on the CPU), the swap
    chip_smoke.py makes on the card, vs the F.conv2d path: fp32 atol 1e-5."""
    from scenedepthestimation_tpu_torch.models import folded
    from scenedepthestimation_tpu_torch.ops import winograd

    variables, enc, x = _folded_setup(18, seed=2, hw=(64, 128))  # even at /32
    fenc = folded.FoldedEncoder.from_encoder(enc).eval()
    with torch.no_grad():
        want = fenc(torch.from_numpy(x))
    calls = []

    def on_winograd(x, weight, bias, residual=None):
        calls.append(residual is not None)
        nhwc = (lambda t: None if t is None else t.permute(0, 2, 3, 1))
        return winograd.winograd_conv3x3(nhwc(x), weight, bias, nhwc(residual)).permute(0, 3, 1, 2)

    monkeypatch.setattr(folded, "conv3x3_bias_relu", on_winograd)
    with torch.no_grad():
        got = fenc(torch.from_numpy(x))
    assert len(calls) == 13 and sum(calls) == 8  # every block's conv2 adds its shortcut
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0, err_msg=f"level {lvl}")


def test_folded_encoder_on_winograd_keeps_each_u_slab(monkeypatch):
    """The folded ResNet-18 on winograd_conv3x3 with each weight's kept U
    (kept_u_slab), as chip_smoke.py routes it on the card:
    equal to the F.conv2d path (fp32 atol 1e-5) in both of two forwards,
    the 13 weights transformed in the first forward and none in the second."""
    from scenedepthestimation_tpu_torch.models import folded
    from scenedepthestimation_tpu_torch.ops import winograd

    variables, enc, x = _folded_setup(18, seed=3, hw=(64, 128))  # even at /32
    fenc = folded.FoldedEncoder.from_encoder(enc).eval()
    with torch.no_grad():
        want = fenc(torch.from_numpy(x))
    transformed = []
    transform = winograd.transform_weights

    def counting(w):
        transformed.append(tuple(w.shape))
        return transform(w)

    def on_winograd(x, weight, bias, residual=None):
        nhwc = (lambda t: None if t is None else t.permute(0, 2, 3, 1))
        return winograd.winograd_conv3x3(nhwc(x), weight, bias, nhwc(residual),
                                         u_slab=winograd.kept_u_slab(weight)).permute(0, 3, 1, 2)

    monkeypatch.setattr(winograd, "transform_weights", counting)
    monkeypatch.setattr(folded, "conv3x3_bias_relu", on_winograd)
    for forward in range(2):
        with torch.no_grad():
            got = fenc(torch.from_numpy(x))
        assert len(transformed) == 13, f"forward {forward}: {len(transformed)} transforms"
        for lvl, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0, err_msg=f"level {lvl}")
