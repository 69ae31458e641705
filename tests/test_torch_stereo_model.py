"""The stereo network of the PyTorch port (scenedepthestimation_tpu_torch)
against the JAX StereoNet on the same weights and inputs, made with numpy
from a seed, at small widths (feature 16, aggregation (8, 12, 16, 20),
max_disp 32 so D = 8).

Weights cross over through the port's ``from_jax_variables``. The JAX side
runs twice: with its defaults (the XLA correlation oracle and soft-argmin)
and with both Pallas kernels switched on, in interpret mode on the CPU.
In bf16 both packages send the features through the banded-Gram
correlation (the port's plain version here, XLA's on the JAX side).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedepthestimation_tpu.ops.pallas.soft_argmin as jax_sa_kernel
from scenedepthestimation_tpu.api import split_pair as jax_split_pair
from scenedepthestimation_tpu.api import stereo_packed_pair_forward
from scenedepthestimation_tpu.configs import StereoConfig as JaxStereoConfig
from scenedepthestimation_tpu.models.stereo import FeatureTower as JaxFeatureTower
from scenedepthestimation_tpu.models.stereo import StereoNet as JaxStereoNet
from scenedepthestimation_tpu_torch.configs import StereoConfig
from scenedepthestimation_tpu_torch.models.stereo import StereoNet, init_parameters, split_pair
from scenedepthestimation_tpu_torch.ops.correlation import correlation1d
from scenedepthestimation_tpu_torch.utils import weights

# The modules, not the functions of the same name that ops/__init__ exports.
jax_corr = importlib.import_module("scenedepthestimation_tpu.ops.correlation")
jax_sa = importlib.import_module("scenedepthestimation_tpu.ops.soft_argmin")

SMALL = dict(max_disp=32, feat_channels=16, agg_channels=(8, 12, 16, 20))


def _cfgs(hw, refine):
    kw = dict(SMALL, height=hw[0], width=hw[1], refine=refine)
    return JaxStereoConfig(**kw), StereoConfig(**kw)


def _jax_variables(jcfg, seed=0):
    """Flax init as numpy; with refine, the zero-initialised residual conv
    is randomised so that the refinement changes the output."""
    z = jnp.zeros((1, jcfg.height, jcfg.width, 3), jnp.float32)
    v = JaxStereoNet(cfg=jcfg).init(jax.random.PRNGKey(seed), z, z)
    v = jax.tree_util.tree_map(np.array, dict(v))
    if jcfg.refine:
        rng = np.random.default_rng(seed + 100)
        res = v["params"]["refinement"]["residual"]
        res["kernel"] = rng.normal(0, 0.05, res["kernel"].shape).astype(np.float32)
        res["bias"] = rng.normal(0, 0.05, res["bias"].shape).astype(np.float32)
    return v


def _pair(hw, seed=1):
    """A left view and a right view that is the left shifted by 3 px plus
    noise, so that the cost volume has a peak."""
    rng = np.random.default_rng(seed)
    left = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    right = np.roll(left, -3, axis=2) + rng.normal(0, 0.1, left.shape).astype(np.float32)
    return left, right.astype(np.float32)


def _port(pcfg, variables):
    model = StereoNet(pcfg).eval()
    weights.load_state(model, weights.from_jax_variables(variables))
    return model.to(memory_format=torch.channels_last)


def _jax_forward(path, jcfg, variables, left, right):
    if path == "module":
        return JaxStereoNet(cfg=jcfg).apply(variables, jnp.asarray(left), jnp.asarray(right))
    b = left.shape[0]
    pair = np.stack([left, right], axis=1).reshape(2 * b, *left.shape[1:])
    return stereo_packed_pair_forward(
        variables["params"], jnp.asarray(pair), jcfg, jnp.float32
    )


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("refine", [False, True], ids=["plain", "refine"])
@pytest.mark.parametrize(
    "path,hw", [("packed", (64, 128)), ("module", (32, 96))], ids=["packed", "module"]
)
def test_stereo_net_matches_jax(path, hw, refine, pallas, monkeypatch):
    """Full-res disparity of the port's StereoNet vs the JAX package's:
    the packed/collapsed inference forward that build_stereo_program takes
    at 64x128 (grid 16x32), and the module forward StereoNet.apply at
    32x96 (grid 8x24). Tolerance atol 1e-4 px + rtol 1e-5."""
    jcfg, pcfg = _cfgs(hw, refine)
    variables = _jax_variables(jcfg)
    left, right = _pair(hw)
    with torch.no_grad():
        got = _port(pcfg, variables)(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    assert got.shape == (2, *hw) and got.dtype == np.float32
    saved = (jax_corr._USE_PALLAS, jax_sa._USE_PALLAS)
    calls = []
    if pallas:
        interp = jax_sa_kernel.soft_argmin_pallas

        def soft_argmin_interpret(c, **kw):
            calls.append(c.shape)
            return interp(c, **{**kw, "interpret": True})

        monkeypatch.setattr(jax_sa_kernel, "soft_argmin_pallas", soft_argmin_interpret)
        jax_corr.set_use_pallas(True)  # interprets off a TPU
        jax_sa.set_use_pallas(True)
    try:
        want = np.asarray(_jax_forward(path, jcfg, variables, left, right))
    finally:
        jax_corr.set_use_pallas(saved[0])
        jax_sa.set_use_pallas(saved[1])
    assert len(calls) == int(pallas)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


# bf16 port vs bf16 JAX on the same weights: atol at about twice the
# largest error measured at these sizes. The tower's and the aggregation's
# bf16 convs round at other places in XLA-CPU than in oneDNN (the JAX
# packed aggregation also splits each decoder conv in two bf16 convs), so
# the inputs of each compared stage already differ by bf16 roundings.
# Measured: cost volume 2.4e-4 (of max 0.095), refined cost logits 2.0e-3
# (of max 0.32), disparity 2.6e-3 px without refinement and 2.5e-2 px with
# it (its residual conv is bf16, scaled by max_disp = 32).
BF16_ATOL = {"cost": 5e-4, "refined": 4e-3, "disp": 6e-3, "disp_refine": 5e-2}


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, as float32 numpy: the same input for both sides."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _port_bf16_stages(model, pair, max_disp):
    """forward_pair of the port's bf16 net, and its stages step by step:
    the cost volume, the refined cost logits and the disparity."""
    with torch.no_grad():
        f_l, f_r = split_pair(model.tower(pair))
        cost = correlation1d(f_l, f_r, max_disp)
        refined = model.aggregation(torch.cat([cost, f_l], dim=-1))
        disp = model.forward_pair(pair)
    assert cost.dtype == refined.dtype == torch.bfloat16 and disp.dtype == torch.float32
    return {"cost": cost.float().numpy(), "refined": refined.float().numpy(), "disp": disp.numpy()}


def _jax_bf16_stages(path, jcfg, variables, pair):
    bf16 = jnp.bfloat16
    jpair = jnp.asarray(pair, bf16)
    feats = JaxFeatureTower(channels=jcfg.feat_channels, dtype=bf16).apply(
        {"params": variables["params"]["tower"]}, jpair
    )
    f_l, f_r = jax_split_pair(feats)
    cost = jax_corr.correlation1d(f_l, f_r, jcfg.corr_disp).astype(bf16)
    if path == "packed":
        disp, refined = stereo_packed_pair_forward(
            variables["params"], jpair, jcfg, bf16, return_cost=True
        )
    else:
        disp, refined = JaxStereoNet(cfg=jcfg, dtype=bf16).apply(
            variables, jpair[0::2], jpair[1::2], return_cost=True
        )
    return {k: np.asarray(v.astype(jnp.float32))
            for k, v in (("cost", cost), ("refined", refined), ("disp", disp))}


@pytest.mark.parametrize("refine", [False, True], ids=["plain", "refine"])
@pytest.mark.parametrize(
    "path,hw", [("packed", (64, 128)), ("module", (32, 96))], ids=["packed", "module"]
)
def test_stereo_net_bf16_matches_jax_bf16(path, hw, refine):
    """The port's StereoNet in bf16 vs the JAX StereoNet in bf16 on the same
    weights and the same bf16 pair: the packed forward at 64x128 and the
    module forward at 32x96, with and without refinement; cost volume,
    refined cost logits and disparity within BF16_ATOL."""
    jcfg, pcfg = _cfgs(hw, refine)
    variables = _jax_variables(jcfg)
    left, right = _pair(hw)
    pair = _bf16(np.stack([left, right], axis=1).reshape(2 * left.shape[0], *hw, 3))
    model = _port(pcfg, variables).to(torch.bfloat16)
    got = _port_bf16_stages(model, torch.from_numpy(pair).bfloat16(), pcfg.corr_disp)
    want = _jax_bf16_stages(path, jcfg, variables, pair)
    assert got["disp"].shape == (2, *hw)
    for k in ("cost", "refined", "disp"):
        assert got[k].shape == want[k].shape, k
        atol = BF16_ATOL["disp_refine" if k == "disp" and refine else k]
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


@pytest.mark.parametrize("refine", [False, True], ids=["plain", "refine"])
def test_module_names_match_the_flax_tree(refine):
    """Every Flax leaf has its parameter in the port and the other way
    round, aux cost heads included; kernels arrive as OIHW."""
    jcfg, pcfg = _cfgs((32, 64), refine)
    state = weights.from_jax_variables(_jax_variables(jcfg))
    model_state = StereoNet(pcfg).state_dict()
    assert set(state) == set(model_state)
    assert ("aggregation.cost_head_s1.weight" in state) is refine
    for k, v in state.items():
        assert tuple(v.shape) == tuple(model_state[k].shape), k
    assert tuple(state["tower.down1.conv.weight"].shape) == (32, 3, 5, 5)


@pytest.mark.parametrize(
    "widths", [dict(feat_channels=128), dict(max_disp=96)], ids=["c128", "d96"]
)
def test_flax_tree_loads_at_bf16_preset_widths(widths):
    """The Flax tree of the _c128 preset (C = 128) and of latency_d96 (D =
    24), at their published aggregation widths, maps onto the port's
    StereoNet through from_jax_variables: the same names, the same shapes,
    and load_state takes it."""
    kw = dict(height=32, width=64, **widths)
    jcfg, pcfg = JaxStereoConfig(**kw), StereoConfig(**kw)
    state = weights.from_jax_variables(_jax_variables(jcfg))
    model = StereoNet(pcfg)
    model_state = model.state_dict()
    assert set(state) == set(model_state)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(model_state[k].shape), k
    weights.load_state(model, state)
    cin = pcfg.corr_disp + pcfg.feat_channels
    assert tuple(state["aggregation.enc0.conv.weight"].shape) == (64, cin, 3, 3)


def test_init_parameters_seeded_with_identity_refinement():
    """Seeded init is reproducible, the residual conv starts at zero, and a
    refine net at init returns the same disparity as the net without it."""
    _, pcfg = _cfgs((32, 64), True)
    a, b = StereoNet(pcfg).eval(), StereoNet(pcfg).eval()
    init_parameters(a, torch.Generator().manual_seed(3))
    init_parameters(b, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not a.refinement.residual.weight.any()
    plain = StereoNet(dataclasses.replace(pcfg, refine=False)).eval()
    plain.load_state_dict(
        {k: v for k, v in a.state_dict().items()
         if not k.startswith(("refinement.", "aggregation.cost_head_s"))}
    )
    left, right = (torch.from_numpy(x) for x in _pair((32, 64)))
    with torch.no_grad():
        assert torch.equal(a(left, right), plain(left, right))
